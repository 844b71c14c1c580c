"""The Transformer for NMT (Vaswani et al. 2017; Sockeye's
transformer-big) as Gluon blocks.

The PyTorch port of ``mxnet_tpu/models/transformer.py``: encoder and
decoder stacks with sinusoidal positions, the encoder-decoder with an
optional tied source / target embedding, greedy decoding, the beam
search (:mod:`.decoding`: one CUDA graph a decode step on the card) and
its readable host-side oracle, and the label-smoothed loss.  Every mask
is made on the device of the arrays it masks (``nd.arange`` there), so
a hybridized forward captured as a CUDA graph holds no host-to-device
copy.
"""
from __future__ import annotations

import math

import numpy as np

from .. import ndarray as nd
from ..gluon import nn
from ..gluon.block import HybridBlock
from .transformer_blocks import (TransformerDecoderCell,
                                 TransformerEncoderCell, _sinusoid_table)

__all__ = ["TransformerEncoder", "TransformerDecoder", "Transformer",
           "transformer_big", "transformer_base", "SmoothedSoftmaxCELoss"]

NEG_INF = -1e9


class TransformerEncoder(HybridBlock):
    def __init__(self, units=512, hidden_size=2048, num_layers=6,
                 num_heads=8, dropout=0.1, max_length=1024, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
            self.pos_embed = self.params.get_constant(
                "pos_embed", _sinusoid_table(max_length, units))
            self.dropout_layer = nn.Dropout(dropout)
            self.cells = nn.HybridSequential()
            for _ in range(num_layers):
                self.cells.add(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout,
                    activation="relu"))

    def hybrid_forward(self, F, x, mask=None, pos_embed=None):
        L = x.shape[0]                                          # (L, B, C)
        x = x * math.sqrt(self._units)
        x = x + pos_embed.slice_axis(axis=0, begin=0, end=L).expand_dims(1)
        x = self.dropout_layer(x)
        for cell in self.cells:
            x = cell(x, mask)
        return x


class TransformerDecoder(HybridBlock):
    def __init__(self, units=512, hidden_size=2048, num_layers=6,
                 num_heads=8, dropout=0.1, max_length=1024, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
            self.pos_embed = self.params.get_constant(
                "pos_embed", _sinusoid_table(max_length, units))
            self.dropout_layer = nn.Dropout(dropout)
            self.cells = nn.HybridSequential()
            for _ in range(num_layers):
                self.cells.add(TransformerDecoderCell(
                    units, hidden_size, num_heads, dropout,
                    activation="relu"))

    def hybrid_forward(self, F, x, mem, self_mask=None, mem_mask=None,
                       pos_embed=None):
        L = x.shape[0]
        x = x * math.sqrt(self._units)
        x = x + pos_embed.slice_axis(axis=0, begin=0, end=L).expand_dims(1)
        x = self.dropout_layer(x)
        for cell in self.cells:
            x = cell(x, mem, self_mask, mem_mask)
        return x


class Transformer(HybridBlock):
    """Encoder-decoder, optionally with one embedding for source and
    target (``tie_weights=True`` with equal vocabularies: one Parameter,
    one summed gradient).

    Call: ``model(src (B, Ls), tgt (B, Lt), src_valid, tgt_valid)`` ->
    logits (B, Lt, V_tgt)."""

    def __init__(self, src_vocab_size, tgt_vocab_size=None, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8, dropout=0.1,
                 max_length=1024, tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        tgt_vocab_size = tgt_vocab_size or src_vocab_size
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
            self.src_embed = nn.Embedding(src_vocab_size, units)
            if tie_weights and tgt_vocab_size == src_vocab_size:
                self.tgt_embed = self.src_embed
            else:
                self.tgt_embed = nn.Embedding(tgt_vocab_size, units)
            self.encoder = TransformerEncoder(units, hidden_size,
                                              num_layers, num_heads,
                                              dropout, max_length)
            self.decoder = TransformerDecoder(units, hidden_size,
                                              num_layers, num_heads,
                                              dropout, max_length)
            self.proj = nn.Dense(tgt_vocab_size, in_units=units,
                                 flatten=False)

    # ---------------------------------------------------------------- masks
    def _pad_mask(self, F, valid_length, L_q, L_k):
        """Additive (B*H, L_q, L_k) padding mask from (B,) lengths."""
        steps = nd.arange(L_k, ctx=valid_length.context)
        ok = F.broadcast_lesser(steps.reshape((1, L_k)),
                                valid_length.reshape((-1, 1))
                                .astype("float32"))
        mask = (1.0 - ok) * NEG_INF                             # (B, L_k)
        mask = mask.reshape((-1, 1, 1, L_k)).broadcast_to(
            (mask.shape[0], self._num_heads, L_q, L_k))
        return mask.reshape((-1, L_q, L_k))

    def _causal_mask(self, F, L, ref):
        """(L, L): NEG_INF above the diagonal, 0 on and below it."""
        steps = nd.arange(L, ctx=ref.context)
        later = F.broadcast_greater(steps.reshape((1, L)),
                                    steps.reshape((L, 1)))
        return later * NEG_INF

    def encode(self, src, src_valid=None):
        F = nd
        x = self.src_embed(src).swapaxes(0, 1)
        mask = None
        if src_valid is not None:
            mask = self._pad_mask(F, src_valid, src.shape[1], src.shape[1])
        return self.encoder(x, mask)

    def decode_logits(self, mem, tgt, src_valid=None):
        F = nd
        Lt = tgt.shape[1]
        y = self.tgt_embed(tgt).swapaxes(0, 1)
        self_mask = self._causal_mask(F, Lt, tgt)
        mem_mask = None
        if src_valid is not None:
            mem_mask = self._pad_mask(F, src_valid, Lt, mem.shape[0])
        out = self.decoder(y, mem, self_mask, mem_mask)
        return self.proj(out.swapaxes(0, 1))

    def hybrid_forward(self, F, src, tgt, src_valid=None, tgt_valid=None):
        mem = self.encode(src, src_valid)
        return self.decode_logits(mem, tgt, src_valid)

    # ------------------------------------------------------------- decoding
    def greedy_decode(self, src, src_valid=None, bos=2, eos=3,
                      max_decode_len=32):
        """Greedy autoregressive decode; returns (B, <= max_len + 1)
        ids."""
        B = src.shape[0]
        mem = self.encode(src, src_valid)
        tgt = nd.full((B, 1), bos, ctx=src.context, dtype="int32")
        finished = np.zeros((B,), dtype=bool)
        for _ in range(max_decode_len):
            logits = self.decode_logits(mem, tgt, src_valid)
            nxt = logits.slice_axis(axis=1, begin=-1, end=None) \
                .squeeze(axis=1).argmax(axis=-1).astype("int32")
            finished |= (nxt.asnumpy() == eos)
            tgt = nd.op.concat(tgt, nxt.reshape((B, 1)), dim=1)
            if finished.all():
                break
        return tgt

    def beam_search(self, src, src_valid=None, bos=2, eos=3, beam_size=4,
                    max_decode_len=32, alpha=0.6):
        """Length-normalized beam search over the batch
        (:class:`~.decoding.TransformerBeamDecoder`: one CUDA graph a
        decode step on the card).  Returns (B, max_decode_len + 1) ids."""
        from .decoding import TransformerBeamDecoder
        dec = getattr(self, "_beam_decoder", None)
        if dec is None:
            dec = self._beam_decoder = TransformerBeamDecoder(self)
        return dec(src, src_valid, bos=bos, eos=eos, beam_size=beam_size,
                   max_decode_len=max_decode_len, alpha=alpha)

    def beam_search_host(self, src, src_valid=None, bos=2, eos=3,
                         beam_size=4, max_decode_len=32, alpha=0.6):
        """Host-side beam search, one sentence at a time: the readable
        oracle :meth:`beam_search` is tested against."""
        B = src.shape[0]
        if B != 1:
            return nd.op.concat(*[
                self.beam_search_host(
                    src.slice_axis(axis=0, begin=i, end=i + 1),
                    None if src_valid is None else
                    src_valid.slice_axis(axis=0, begin=i, end=i + 1),
                    bos, eos, beam_size, max_decode_len, alpha)
                for i in range(B)], dim=0)
        mem = self.encode(src, src_valid)                       # (Ls, 1, C)
        beams = [([bos], 0.0, False)]

        def lp(s):
            return ((5 + len(s)) / 6.0) ** alpha

        for _ in range(max_decode_len):
            if all(done for _, _, done in beams):
                break
            candidates = []
            for seq, score, done in beams:
                if done:
                    candidates.append((seq, score, True))
                    continue
                tgt = nd.array(np.array([seq], dtype=np.int32),
                               ctx=src.context, dtype="int32")
                logits = self.decode_logits(mem, tgt, src_valid)
                logp = nd.op.log_softmax(
                    logits.slice_axis(axis=1, begin=-1, end=None)
                    .squeeze(axis=1), axis=-1).asnumpy()[0]
                for t in np.argsort(-logp)[:beam_size]:
                    candidates.append((seq + [int(t)],
                                       score + float(logp[t]),
                                       int(t) == eos))
            candidates.sort(key=lambda c: -(c[1] / lp(c[0])))
            beams = candidates[:beam_size]
        best = max(beams, key=lambda c: c[1] / lp(c[0]))
        return nd.array(np.array([best[0]], dtype=np.int32),
                        ctx=src.context, dtype="int32")


class SmoothedSoftmaxCELoss(HybridBlock):
    """Label-smoothed cross entropy, averaged over each sequence's valid
    steps."""

    def __init__(self, smoothing=0.1, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self._eps = smoothing
        self._axis = axis

    def hybrid_forward(self, F, pred, label, valid_length=None):
        logp = F.log_softmax(pred, axis=self._axis)
        nll = -F.pick(logp, label, axis=self._axis, keepdims=False)
        smooth = -logp.mean(axis=self._axis)
        loss = (1 - self._eps) * nll + self._eps * smooth
        if valid_length is not None:
            L = loss.shape[1]
            steps = nd.arange(L, ctx=pred.context)
            mask = F.broadcast_lesser(
                steps.reshape((1, L)),
                valid_length.reshape((-1, 1)).astype("float32"))
            loss = loss * mask
            return loss.sum(axis=1) / valid_length.astype("float32")
        return loss.mean(axis=1)


def transformer_base(src_vocab_size, tgt_vocab_size=None, **kw):
    cfg = dict(units=512, hidden_size=2048, num_layers=6, num_heads=8)
    cfg.update(kw)
    return Transformer(src_vocab_size, tgt_vocab_size, **cfg)


def transformer_big(src_vocab_size, tgt_vocab_size=None, **kw):
    """Transformer-big (WMT14 En-De): units 1024, hidden 4096, 6 + 6
    layers, 16 heads."""
    cfg = dict(units=1024, hidden_size=4096, num_layers=6, num_heads=16)
    cfg.update(kw)
    return Transformer(src_vocab_size, tgt_vocab_size, **cfg)
