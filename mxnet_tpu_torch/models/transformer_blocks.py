"""Transformer blocks: the encoder cell and its parts, the decoder-only
LM, and the LM's paged decode-mode forwards.

The PyTorch port of ``mxnet_tpu/models/transformer_blocks.py``:

- :class:`PositionwiseFFN`, :class:`MultiHeadSelfAttention` and
  :class:`TransformerEncoderCell` — the encoder blocks BERT and the LM
  are built from, as ``nn.Module``\\ s with the JAX blocks' submodule
  names (``qkv``, ``out_proj``, ``attn_norm``, ``ffn.ffn_1``, ...).  They
  keep the JAX (L, B, C) time-major layout at ``forward`` and the
  interleaved per-head ``[q|k|v]`` projection.  ``use_flash=True``
  routes self-attention to :mod:`mxnet_tpu_torch.ops.flash_attention`
  (kernels B1-B3 on CUDA tensors); the dense path is plain torch
  matmuls + softmax with an additive mask, as the JAX package computes
  it outside any kernel.
- :class:`TransformerDecoderLM` — a GPT-layout causal LM whose cells are
  ``TransformerEncoderCell(pre_norm=True)``, as in the JAX package.  Its
  ``forward(tokens (B, L)) -> logits (B, L, V)`` is the dense causal
  full forward: the plain reference the paged path is held to.
- :func:`paged_lm_params` snapshots the LM into the flat parameter dict
  the paged forwards consume; :func:`load_paged_params` builds the same
  dict from the numpy image of the JAX package's ``paged_lm_params(lm)``.
- :func:`paged_prefill` / :func:`paged_decode_step` /
  :func:`paged_verify` / :func:`paged_verify_batch` — the serving
  decode-mode forwards over the paged KV pool.  Decode and verify
  attention go through :mod:`mxnet_tpu_torch.ops.paged_attention`
  (the CUDA kernels on CUDA tensors); prefill attention is plain torch
  matmul + softmax, as the JAX package computes it outside any kernel.

Blocks built on ``device="meta"`` stay unmaterialised (a parent model
materialises and draws them once); on any other device a block draws
its weights from ``generator`` (a CPU ``torch.Generator``, seed 0 when
omitted) by the JAX package's ``initialize()`` rule (:func:`init_params`).
``gluon_names()`` maps each block's parameters to the names of the JAX
block's ``collect_params()`` below the block's own prefix, which is how
weights are carried across between the two packages.

The paged forwards write the K/V pools IN PLACE (the JAX versions
returned new arrays) and return ``(logits, k_pages, v_pages)`` with the
same, updated pool tensors, so callers keep the JAX calling convention.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from ..ops.flash_attention import (_merge_heads, _split_qkv, flash_selfatt,
                                   flash_selfatt_nomask)
from ..ops.paged_attention import ragged_paged_attention, ragged_paged_verify

__all__ = ["PositionwiseFFN", "MultiHeadSelfAttention",
           "TransformerEncoderCell", "TransformerDecoderLM", "NEG_INF",
           "init_params", "load_gluon_params", "load_paged_params",
           "paged_lm_params", "paged_prefill", "paged_decode_step",
           "paged_verify", "paged_verify_batch"]


def _sinusoid_table(max_len, units):
    """Shared sinusoidal position table (the JAX package's formula)."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(units)[None, :]
    angle = pos / np.power(10000, (2 * (dim // 2)) / units)
    table = np.zeros((max_len, units), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


NEG_INF = -1e9
_META = torch.device("meta")


# ---------------------------------------------------------------------------
# weights: the JAX package's initialize() rule and its parameter names
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_params(module, generator=None, normal=()):
    """Draw every parameter of ``module`` as the JAX package's
    ``initialize()`` does with its default initializer: names ending in
    ``gamma`` -> 1, in ``beta`` or ``bias`` -> 0, in one of ``normal``
    (the parameters declared ``init="normal"``) -> N(0, 0.01), every
    other weight -> U(-0.07, 0.07).  Values are drawn on the CPU from
    ``generator`` (seed 0 when omitted), in ``named_parameters`` order."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    normal = tuple(normal)
    for name, p in module.named_parameters():
        if name.endswith("gamma"):
            val = torch.ones(p.shape)
        elif name.endswith(("beta", "bias")):
            val = torch.zeros(p.shape)
        elif normal and name.endswith(normal):
            val = torch.empty(p.shape).normal_(0.0, 0.01,
                                               generator=generator)
        else:
            val = torch.empty(p.shape).uniform_(-0.07, 0.07,
                                                generator=generator)
        p.copy_(val)


def _materialize(module, device, generator, normal=()):
    """Allocate a module built on the meta device on ``device`` and draw
    its weights (:func:`init_params`); a no-op for ``device="meta"``."""
    device = torch.device(device)
    if device.type == "meta":
        return module
    module.to_empty(device=device)
    init_params(module, generator, normal)
    return module


def _dense_names(prefix, layer):
    return {f"{prefix}weight": layer.weight, f"{prefix}bias": layer.bias}


def _scoped(prefix, names):
    return {prefix + k: v for k, v in names.items()}


@torch.no_grad()
def load_gluon_params(names, np_params, who):
    """Copy ``{gluon name: np.ndarray}`` into the tensors of ``names``
    (a block's :meth:`gluon_names`).  Raises :class:`MXNetError` on a
    missing or unknown name or a wrong shape."""
    missing = sorted(set(names) - set(np_params))
    extra = sorted(set(np_params) - set(names))
    if missing or extra:
        raise MXNetError(f"{who}.load_numpy_params: missing {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}, unknown "
                         f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
    for name, p in names.items():
        a = np.asarray(np_params[name])
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"{who}.load_numpy_params: {name!r} has shape "
                             f"{tuple(a.shape)}, want {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, np.float32)).to(p.dtype))


# ---------------------------------------------------------------------------
# encoder blocks
# ---------------------------------------------------------------------------
class _LayerNorm(nn.Module):
    """LayerNorm over the last axis with the Gluon parameter names
    ``gamma`` / ``beta``."""

    def __init__(self, units, eps, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(units, device=device))
        self.beta = nn.Parameter(torch.empty(units, device=device))
        self.eps = eps

    def forward(self, x):
        return _f_ln(x, self.gamma, self.beta, self.eps)

    def gluon_names(self):
        return {"gamma": self.gamma, "beta": self.beta}


_ACTIVATIONS = ("relu", "gelu", "gelu_erf", "gelu_tanh")


def _f_act(x, activation):
    if activation == "relu":
        return F.relu(x)
    if activation in ("gelu", "gelu_erf"):
        return F.gelu(x, approximate="none")
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise MXNetError(f"unsupported activation {activation!r}; known: "
                     f"{_ACTIVATIONS}")


class PositionwiseFFN(nn.Module):
    """FFN(x) = W2 act(W1 x) with residual + LayerNorm (post-norm, the
    BERT layout) or LayerNorm first (``pre_norm=True``).  ``gelu`` is
    the erf GELU, ``gelu_tanh`` its tanh approximation."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 layer_norm_eps=1e-5, pre_norm=False, device="cuda",
                 generator=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise MXNetError(f"unsupported activation {activation!r}; "
                             f"known: {_ACTIVATIONS}")
        self._pre_norm = pre_norm
        self._activation = activation
        self._tp = None                 # set while bound to a tp group
        self.ffn_1 = nn.Linear(units, hidden_size, device=_META)
        self.ffn_2 = nn.Linear(hidden_size, units, device=_META)
        self.layer_norm = _LayerNorm(units, layer_norm_eps, _META)
        self.dropout_layer = nn.Dropout(dropout)
        _materialize(self, device, generator)

    def bind_tensor_parallel(self, tp):
        """The tensor-parallel layout of this block under ``tp`` (a
        ``parallel.sharding.TensorParallel``): ``(tp, the parameters it
        runs split)`` when ``ffn_1`` is column- and ``ffn_2``
        row-parallel, ``(None, [])`` when both are replicated; any other
        placement raises."""
        col = tp.column(self.ffn_1.weight, self.ffn_1.bias)
        row = tp.row(self.ffn_2.weight, self.ffn_2.bias)
        if col != row:
            raise MXNetError("PositionwiseFFN: tensor parallelism needs "
                             "ffn_1 column-parallel and ffn_2 row-parallel "
                             "together")
        if not col:
            return None, []
        return tp, [self.ffn_1.weight, self.ffn_1.bias, self.ffn_2.weight]

    def forward(self, x):
        residual = x
        if self._pre_norm:
            x = self.layer_norm(x)
        tp = self._tp
        if tp is None:
            out = self.ffn_2(_f_act(self.ffn_1(x), self._activation))
        else:
            # ffn_1 holds this rank's hidden units, ffn_2 the matching
            # input columns: the partial products sum over the tp group
            h = _f_act(self.ffn_1(tp.copy(x)), self._activation)
            out = tp.reduce(F.linear(h, self.ffn_2.weight)) \
                + self.ffn_2.bias
        out = self.dropout_layer(out) + residual
        if not self._pre_norm:
            out = self.layer_norm(out)
        return out

    def gluon_names(self):
        return {**_dense_names("ffn_1_", self.ffn_1),
                **_dense_names("ffn_2_", self.ffn_2),
                **_scoped("layernorm0_", self.layer_norm.gluon_names())}


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over (L, B, C) through an interleaved per-head
    ``[q|k|v]`` projection.

    ``use_flash=True`` routes the qk -> softmax -> valatt chain to flash
    attention whenever the mask is expressible as key valid-lengths (+
    optional causal / sliding window), i.e. ``mask is None``; the flash
    path applies dropout to the attention OUTPUT (the score matrix never
    materialises).  The dense path adds an explicit additive ``mask``
    (broadcastable to (B*H, L, L)) to the scores and applies dropout to
    the probabilities."""

    def __init__(self, units, num_heads, dropout=0.0, use_flash=False,
                 causal=False, window=None, device="cuda", generator=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        if causal and not use_flash:
            raise MXNetError(
                "causal=True requires use_flash=True; on the dense path "
                "pass an explicit additive causal mask instead")
        if window is not None:
            if not (use_flash and causal):
                raise MXNetError(
                    "window (sliding-window attention) requires "
                    "use_flash=True and causal=True")
            if int(window) < 1:
                raise MXNetError(f"window must be >= 1, got {window}")
        self._units = units
        self._heads = num_heads
        self._use_flash = use_flash
        self._causal = causal
        self._window = -1 if window is None else int(window)
        self._tp = None                 # set while bound to a tp group
        self.qkv = nn.Linear(units, 3 * units, device=_META)
        self.out_proj = nn.Linear(units, units, device=_META)
        self.dropout_layer = nn.Dropout(dropout)
        _materialize(self, device, generator)

    def bind_tensor_parallel(self, tp):
        """The tensor-parallel layout of this block under ``tp`` (a
        ``parallel.sharding.TensorParallel``): ``(tp, the parameters it
        runs split)`` when ``qkv`` is column- and ``out_proj``
        row-parallel — the interleaved ``[q|k|v]`` rows give each rank
        ``heads / tp.size`` whole heads — ``(None, [])`` when both are
        replicated; any other placement raises."""
        col = tp.column(self.qkv.weight, self.qkv.bias)
        row = tp.row(self.out_proj.weight, self.out_proj.bias)
        if col != row:
            raise MXNetError("MultiHeadSelfAttention: tensor parallelism "
                             "needs qkv column-parallel and out_proj "
                             "row-parallel together")
        if col and self._heads % tp.size:
            raise MXNetError(f"MultiHeadSelfAttention: {self._heads} heads "
                             f"do not split over tp={tp.size}")
        if not col:
            return None, []
        return tp, [self.qkv.weight, self.qkv.bias, self.out_proj.weight]

    def _project_out(self, out):
        tp = self._tp
        if tp is None:
            return self.out_proj(out)
        return tp.reduce(F.linear(out, self.out_proj.weight)) \
            + self.out_proj.bias

    def forward(self, x, mask=None, valid_length=None):
        # x: (L, B, C); qkv: (L, B, 3C) interleaved per head [q|k|v]; a
        # tp rank holds heads / tp of them, whole
        tp = self._tp
        heads = self._heads if tp is None else self._heads // tp.size
        qkv = self.qkv(x if tp is None else tp.copy(x))
        if self._use_flash and mask is None:
            if valid_length is None:
                out = flash_selfatt_nomask(qkv, heads=heads,
                                           causal=self._causal,
                                           window=self._window)
            else:
                out = flash_selfatt(qkv, valid_length, heads=heads,
                                    causal=self._causal,
                                    window=self._window)
            return self._project_out(self.dropout_layer(out))
        if self._window > 0:
            raise MXNetError(
                "window (sliding-window attention) is only honored on "
                "the flash path (mask=None); passing an explicit mask "
                "would silently drop the window — fold the window into "
                "the mask instead")
        if valid_length is not None:
            raise MXNetError(
                "valid_length is only consumed by the flash path "
                "(use_flash=True, mask=None); the dense path needs an "
                "explicit additive mask — it would otherwise be silently "
                "ignored")
        L, B, _ = qkv.shape
        q, k, v = _split_qkv(qkv, heads)                    # (B*H, L, D)
        scores = torch.bmm(q * (1.0 / math.sqrt(q.shape[-1])),
                           k.transpose(1, 2))               # (B*H, L, L)
        if mask is not None:
            if tp is not None and mask.dim() == 3 \
                    and mask.shape[0] == B * self._heads:
                # a (B*H, L, L) mask: this rank's heads of each row
                mask = mask.reshape(B, self._heads, *mask.shape[1:]) \
                    .narrow(1, tp.rank * heads, heads) \
                    .reshape(B * heads, *mask.shape[1:])
            scores = scores + mask
        att = self.dropout_layer(torch.softmax(scores, dim=-1))
        out = torch.bmm(att.to(v.dtype), v)
        return self._project_out(_merge_heads(out, L, B, heads))

    def gluon_names(self):
        return {**_dense_names("qkv_", self.qkv),
                **_dense_names("out_proj_", self.out_proj)}


class TransformerEncoderCell(nn.Module):
    """Transformer encoder layer: post-norm (the BERT layout) or
    pre-norm (``pre_norm=True``, the GPT layout of the LM)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="gelu", layer_norm_eps=1e-5, pre_norm=False,
                 use_flash=False, device="cuda", generator=None):
        super().__init__()
        self._pre_norm = pre_norm
        self.attention = MultiHeadSelfAttention(units, num_heads, dropout,
                                                use_flash=use_flash,
                                                device=_META)
        self.attn_norm = _LayerNorm(units, layer_norm_eps, _META)
        self.dropout_layer = nn.Dropout(dropout)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, activation,
                                   layer_norm_eps, pre_norm, device=_META)
        _materialize(self, device, generator)

    def forward(self, x, mask=None, valid_length=None):
        residual = x
        h = self.attn_norm(x) if self._pre_norm else x
        h = self.attention(h, mask, valid_length)
        h = self.dropout_layer(h) + residual
        if not self._pre_norm:
            h = self.attn_norm(h)
        return self.ffn(h)

    def gluon_names(self):
        return {**_scoped("multiheadselfattention0_",
                          self.attention.gluon_names()),
                **_scoped("layernorm0_", self.attn_norm.gluon_names()),
                **_scoped("positionwiseffn0_", self.ffn.gluon_names())}


# ---------------------------------------------------------------------------
# decoder-only LM
# ---------------------------------------------------------------------------
class TransformerDecoderLM(nn.Module):
    """Decoder-only causal LM (GPT layout): embedding + sinusoid
    positions, pre-norm :class:`TransformerEncoderCell` layers, final
    LayerNorm, untied vocab projection with bias.

    Two forwards share the SAME parameters:

    - :meth:`forward` — ``lm(tokens (B, L)) -> logits (B, L, V)``, dense
      attention with an additive causal mask (the reference);
    - the serving decode-mode forwards :func:`paged_prefill` /
      :func:`paged_decode_step` / :func:`paged_verify` over the paged KV
      pool, fed by :func:`paged_lm_params`.

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``;
    seed 0 when omitted): N(0, 0.02) matrices and embedding, zero
    biases, unit LayerNorm gains.
    """

    def __init__(self, vocab_size, units=64, hidden_size=128,
                 num_layers=2, num_heads=2, max_length=128, dropout=0.0,
                 activation="relu", layer_norm_eps=1e-5, device="cuda",
                 generator=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self.vocab_size = int(vocab_size)
        self.units = int(units)
        self.num_heads = int(num_heads)
        self.num_layers = int(num_layers)
        self.head_dim = self.units // self.num_heads
        self.max_context = int(max_length)
        self._activation = activation
        self._eps = layer_norm_eps
        self.embed = nn.Embedding(vocab_size, units, device=_META)
        self.dropout_layer = nn.Dropout(dropout)
        self.cells = nn.ModuleList(
            TransformerEncoderCell(units, hidden_size, num_heads, dropout,
                                   activation=activation,
                                   layer_norm_eps=layer_norm_eps,
                                   pre_norm=True, device=_META)
            for _ in range(num_layers))
        self.final_norm = _LayerNorm(units, layer_norm_eps, _META)
        self.proj = nn.Linear(units, vocab_size, device=_META)
        self.to_empty(device=device)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(_sinusoid_table(max_length, units)).to(device))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator=None):
        """Redraw every parameter from ``generator`` (CPU)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith("gamma"):
                val = torch.ones(p.shape)
            elif name.endswith(("beta", "bias")):
                val = torch.zeros(p.shape)
            else:
                val = torch.empty(p.shape).normal_(0.0, 0.02,
                                                   generator=generator)
            p.copy_(val)

    def forward(self, tokens):
        # tokens: (B, L) int ids -> logits (B, L, V)
        L = tokens.shape[1]
        x = self.embed(tokens.long()) * math.sqrt(self.units)
        x = x.transpose(0, 1) + self.pos_embed[:L, None]      # (L, B, C)
        x = self.dropout_layer(x)
        steps = torch.arange(L, device=x.device)
        mask = (steps[None, :] > steps[:, None]).to(x.dtype) * NEG_INF
        for cell in self.cells:
            x = cell(x, mask)
        return self.proj(self.final_norm(x)).transpose(0, 1)

    @torch.no_grad()
    def load_numpy_params(self, np_params):
        """Copy the numpy image of the JAX package's
        ``paged_lm_params(lm)`` dict into this module's parameters."""
        def put(p, a):
            a = torch.from_numpy(np.array(a, np.float32))
            if tuple(a.shape) != tuple(p.shape):
                raise MXNetError(f"load_numpy_params: shape {tuple(a.shape)}"
                                 f" does not match {tuple(p.shape)}")
            p.copy_(a)

        if len(np_params["cells"]) != self.num_layers:
            raise MXNetError(
                f"load_numpy_params: {len(np_params['cells'])} cells for a "
                f"{self.num_layers}-layer model")
        put(self.embed.weight, np_params["embed"])
        put(self.pos_embed, np_params["pos"])
        put(self.final_norm.gamma, np_params["fn_g"])
        put(self.final_norm.beta, np_params["fn_b"])
        put(self.proj.weight, np_params["proj_w"])
        put(self.proj.bias, np_params["proj_b"])
        for cell, cp in zip(self.cells, np_params["cells"]):
            att, ffn = cell.attention, cell.ffn
            for p, key in ((cell.attn_norm.gamma, "n1_g"),
                           (cell.attn_norm.beta, "n1_b"),
                           (att.qkv.weight, "qkv_w"), (att.qkv.bias, "qkv_b"),
                           (att.out_proj.weight, "o_w"),
                           (att.out_proj.bias, "o_b"),
                           (ffn.layer_norm.gamma, "n2_g"),
                           (ffn.layer_norm.beta, "n2_b"),
                           (ffn.ffn_1.weight, "f1_w"), (ffn.ffn_1.bias, "f1_b"),
                           (ffn.ffn_2.weight, "f2_w"),
                           (ffn.ffn_2.bias, "f2_b")):
                put(p, cp[key])
        return self


def paged_lm_params(lm, device=None):
    """The flat parameter dict the paged forwards consume, from a
    :class:`TransformerDecoderLM` (float32, on ``device`` or the
    module's own).  The tensors share storage with the module where no
    cast or move is needed: re-snapshot after changing the weights."""
    def g(t):
        return t.detach().to(device=device, dtype=torch.float32)

    cells = []
    for cell in lm.cells:
        att, ffn = cell.attention, cell.ffn
        cells.append(dict(
            n1_g=g(cell.attn_norm.gamma), n1_b=g(cell.attn_norm.beta),
            qkv_w=g(att.qkv.weight), qkv_b=g(att.qkv.bias),
            o_w=g(att.out_proj.weight), o_b=g(att.out_proj.bias),
            n2_g=g(ffn.layer_norm.gamma), n2_b=g(ffn.layer_norm.beta),
            f1_w=g(ffn.ffn_1.weight), f1_b=g(ffn.ffn_1.bias),
            f2_w=g(ffn.ffn_2.weight), f2_b=g(ffn.ffn_2.bias),
        ))
    return {
        "embed": g(lm.embed.weight), "pos": g(lm.pos_embed),
        "fn_g": g(lm.final_norm.gamma), "fn_b": g(lm.final_norm.beta),
        "proj_w": g(lm.proj.weight), "proj_b": g(lm.proj.bias),
        "cells": cells,
    }


def load_paged_params(np_params, device="cuda"):
    """The port's parameter dict from the numpy image of the JAX
    package's ``paged_lm_params(lm)`` (same keys, float32 tensors on
    ``device``)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    out = {k: t(v) for k, v in np_params.items() if k != "cells"}
    out["cells"] = [{k: t(v) for k, v in cp.items()}
                    for cp in np_params["cells"]]
    return out


def _f_ln(x, gamma, beta, eps=1e-5):
    return F.layer_norm(x, gamma.shape, gamma, beta, eps)


def _f_ffn(x, cp, activation):
    h = _f_act(x @ cp["f1_w"].T + cp["f1_b"], activation)
    return h @ cp["f2_w"].T + cp["f2_b"]


def _scalar(v):
    """A python int from a python/numpy scalar; a 0-d tensor from a
    0-d/1-element tensor, left on its device and never read back to the
    host, so a forward over it can be captured in a CUDA graph (the
    JAX package traces these scalars, one program for every value)."""
    return v.reshape(()) if isinstance(v, torch.Tensor) else int(v)


def _row(x, i):
    """``x[i]`` for an int ``i``; for a 0-d tensor ``i`` the row is
    gathered on ``x``'s device (no read back)."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1).to(x.device, torch.long))[0]
    return x[i]


def _vec1(v, device):
    """``v`` (an int or a 0-d tensor from :func:`_scalar`) as a (1,)
    int32 tensor on ``device``; a tensor already there is a view."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(device, torch.int32)
    return torch.tensor([v], dtype=torch.int32, device=device)


def paged_prefill(params, tokens, length, block_table, k_pages, v_pages,
                  *, num_heads, page_size, activation="relu",
                  layer_norm_eps=1e-5):
    """Prefill ONE sequence and write its K/V into cache pages.

    ``tokens``: (1, L_bucket) int, padded past ``length`` (an int or a
    0-d / 1-element int tensor on the pools' device);
    ``block_table``: (pages_per_seq,) int physical pages (null page 0
    in unused slots); ``k_pages``/``v_pages``: the full
    (layers, pool_pages, page_size, heads, head_dim) pools, written in
    place.  Attention over the fresh prompt is plain causal+padding-
    masked softmax; K/V of positions past ``length`` are routed to the
    null page.  Returns ``(last-token logits (V,), k_pages, v_pages)``.
    """
    H = num_heads
    L = tokens.shape[1]
    C = params["embed"].shape[1]
    D = C // H
    length = _scalar(length)
    dev = k_pages.device
    x = params["embed"][tokens[0].long()] * math.sqrt(C) \
        + params["pos"][:L]                                  # (L, C)
    pos_idx = torch.arange(L, device=dev)
    valid = pos_idx < length                                 # (L,)
    page_idx = torch.where(valid, block_table.long()[pos_idx // page_size],
                           0)
    slot_idx = pos_idx % page_size
    # causal + padding: key j visible to query i iff j <= i and j valid
    mask = (pos_idx[None, :] <= pos_idx[:, None]) & valid[None, :]
    for li, cp in enumerate(params["cells"]):
        h = _f_ln(x, cp["n1_g"], cp["n1_b"], layer_norm_eps)
        qkv = (h @ cp["qkv_w"].T + cp["qkv_b"]).reshape(L, H, 3, D)
        q, k, v = qkv.unbind(2)
        k_pages[li, page_idx, slot_idx] = k.to(k_pages.dtype)
        v_pages[li, page_idx, slot_idx] = v.to(v_pages.dtype)
        s = torch.einsum("ihd,jhd->hij", q, k) / math.sqrt(D)
        s = torch.where(mask[None], s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        o = torch.einsum("hij,jhd->ihd", p, v).reshape(L, C)
        x = x + (o @ cp["o_w"].T + cp["o_b"])
        x = x + _f_ffn(_f_ln(x, cp["n2_g"], cp["n2_b"], layer_norm_eps),
                       cp, activation)
    x_last = _f_ln(_row(x, length - 1), params["fn_g"], params["fn_b"],
                   layer_norm_eps)
    return (x_last @ params["proj_w"].T + params["proj_b"],
            k_pages, v_pages)


def paged_decode_step(params, tokens, positions, block_tables, k_pages,
                      v_pages, *, num_heads, page_size, activation="relu",
                      layer_norm_eps=1e-5):
    """One decode step for the whole (fixed-size) decode batch.

    ``tokens``: (B,) int current token per slot; ``positions``: (B,)
    int write position (== context length so far); ``block_tables``:
    (B, pages_per_seq) int.  Inactive slots carry token 0, position 0
    and an all-null block table — their K/V writes land in the null page
    and their logits are garbage the engine never reads.  Each layer
    writes the new token's K/V through the block table (in place), then
    attends over the ragged paged context with
    :func:`~mxnet_tpu_torch.ops.paged_attention.ragged_paged_attention`.
    Returns ``(logits (B, V), k_pages, v_pages)``.
    """
    H = num_heads
    B = tokens.shape[0]
    C = params["embed"].shape[1]
    D = C // H
    pos = positions.long()
    x = params["embed"][tokens.long()] * math.sqrt(C) \
        + params["pos"][pos]                                 # (B, C)
    page = block_tables.long().gather(1, (pos // page_size)[:, None])[:, 0]
    slot = pos % page_size
    ctx = (pos + 1).to(torch.int32)                          # incl. new tok
    for li, cp in enumerate(params["cells"]):
        h = _f_ln(x, cp["n1_g"], cp["n1_b"], layer_norm_eps)
        qkv = (h @ cp["qkv_w"].T + cp["qkv_b"]).reshape(B, H, 3, D)
        q, k, v = qkv.unbind(2)
        k_pages[li, page, slot] = k.to(k_pages.dtype)
        v_pages[li, page, slot] = v.to(v_pages.dtype)
        o = ragged_paged_attention(q.contiguous(), k_pages[li], v_pages[li],
                                   block_tables, ctx)
        x = x + (o.reshape(B, C) @ cp["o_w"].T + cp["o_b"])
        x = x + _f_ffn(_f_ln(x, cp["n2_g"], cp["n2_b"], layer_norm_eps),
                       cp, activation)
    x = _f_ln(x, params["fn_g"], params["fn_b"], layer_norm_eps)
    return x @ params["proj_w"].T + params["proj_b"], k_pages, v_pages


def paged_verify(params, tokens, start, length, block_table, k_pages,
                 v_pages, *, num_heads, page_size, activation="relu",
                 layer_norm_eps=1e-5):
    """Multi-token window forward over a paged context: the verification
    shape of speculative decoding and the tail prefill of a prefix-cache
    hit (docs/serving.md §9).

    ``tokens``: (1, W_bucket) int window, padded past ``length``;
    ``start``: global position of ``tokens[0, 0]`` (K/V of positions
    ``< start`` already sit in cache pages); ``start`` and ``length``
    are ints or 0-d / 1-element int tensors on the pools' device;
    ``block_table``:
    (pages_per_seq,) int.  Writes K/V for the ``length`` valid window
    positions through the block table (padded positions route to the
    null page) and attends each window token causally over the FULL
    paged context up to itself with
    :func:`~mxnet_tpu_torch.ops.paged_attention.ragged_paged_verify`.
    Returns ``(logits (W_bucket, V), k_pages, v_pages)``; rows past
    ``length`` must not be read.
    """
    H = num_heads
    W = tokens.shape[1]
    C = params["embed"].shape[1]
    D = C // H
    P = block_table.shape[0]
    start, length = _scalar(start), _scalar(length)
    dev = k_pages.device
    offs = torch.arange(W, device=dev)
    pos = start + offs
    valid = offs < length                                    # (W,)
    max_pos = params["pos"].shape[0]
    x = params["embed"][tokens[0].long()] * math.sqrt(C) \
        + params["pos"][pos.clamp(max=max_pos - 1)]          # (W, C)
    page_idx = torch.where(
        valid, block_table.long()[(pos // page_size).clamp(max=P - 1)], 0)
    slot_idx = pos % page_size
    starts, lengths = _vec1(start, dev), _vec1(length, dev)
    for li, cp in enumerate(params["cells"]):
        h = _f_ln(x, cp["n1_g"], cp["n1_b"], layer_norm_eps)
        qkv = (h @ cp["qkv_w"].T + cp["qkv_b"]).reshape(W, H, 3, D)
        q, k, v = qkv.unbind(2)
        k_pages[li, page_idx, slot_idx] = k.to(k_pages.dtype)
        v_pages[li, page_idx, slot_idx] = v.to(v_pages.dtype)
        o = ragged_paged_verify(q[None].contiguous(), k_pages[li],
                                v_pages[li], block_table[None], starts,
                                lengths)[0]
        x = x + (o.reshape(W, C) @ cp["o_w"].T + cp["o_b"])
        x = x + _f_ffn(_f_ln(x, cp["n2_g"], cp["n2_b"], layer_norm_eps),
                       cp, activation)
    x = _f_ln(x, params["fn_g"], params["fn_b"], layer_norm_eps)
    return x @ params["proj_w"].T + params["proj_b"], k_pages, v_pages


def paged_verify_batch(params, tokens, starts, lengths, block_tables,
                       k_pages, v_pages, *, num_heads, page_size,
                       activation="relu", layer_norm_eps=1e-5):
    """Batched :func:`paged_verify`: every running sequence's window in
    one call (docs/serving.md §9).

    ``tokens``: (B, W) int windows; ``starts``/``lengths``: (B,) int
    per-slot window origin and valid width (0 = inactive slot: null
    writes, zero rows); ``block_tables``: (B, pages_per_seq).  Returns
    ``(logits (B, W, V), k_pages, v_pages)``; rows past a slot's
    ``lengths`` are garbage the engine never reads.
    """
    H = num_heads
    B, W = tokens.shape
    C = params["embed"].shape[1]
    D = C // H
    P = block_tables.shape[1]
    dev = k_pages.device
    offs = torch.arange(W, device=dev)[None, :]
    pos = starts.long()[:, None] + offs                      # (B, W)
    valid = offs < lengths.long()[:, None]                   # (B, W)
    max_pos = params["pos"].shape[0]
    x = params["embed"][tokens.long()] * math.sqrt(C) \
        + params["pos"][pos.clamp(max=max_pos - 1)]          # (B, W, C)
    page_idx = torch.where(
        valid,
        block_tables.long().gather(1, (pos // page_size).clamp(max=P - 1)),
        0)                                                   # (B, W)
    slot_idx = pos % page_size
    for li, cp in enumerate(params["cells"]):
        h = _f_ln(x, cp["n1_g"], cp["n1_b"], layer_norm_eps)
        qkv = (h @ cp["qkv_w"].T + cp["qkv_b"]).reshape(B, W, H, 3, D)
        q, k, v = qkv.unbind(3)
        k_pages[li, page_idx, slot_idx] = k.to(k_pages.dtype)
        v_pages[li, page_idx, slot_idx] = v.to(v_pages.dtype)
        o = ragged_paged_verify(q.contiguous(), k_pages[li], v_pages[li],
                                block_tables, starts, lengths)
        x = x + (o.reshape(B, W, C) @ cp["o_w"].T + cp["o_b"])
        x = x + _f_ffn(_f_ln(x, cp["n2_g"], cp["n2_b"], layer_norm_eps),
                       cp, activation)
    x = _f_ln(x, params["fn_g"], params["fn_b"], layer_norm_eps)
    return x @ params["proj_w"].T + params["proj_b"], k_pages, v_pages
