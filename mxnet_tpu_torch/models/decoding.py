"""Batched beam search for the Transformer: one CUDA graph a decode step.

The PyTorch port of ``mxnet_tpu/models/decoding.py``.  The JAX package
runs the whole search as one jitted ``lax.while_loop`` with an early
exit; a CUDA graph cannot branch on data, so here the search is a host
loop over one captured decode step:

- every piece of the step's state lives in static device buffers of the
  signature's program, keyed by the reference's ``(B, K, Ls, max_len,
  bos, eos, alpha)``: the position ``t`` (a 0-d device tensor), the
  tokens (B, K, max_len + 1), scores, finished flags and lengths, the
  per-layer self-attention caches (B*K, H, max_len, D) and the cross
  K/V (B*K, H, Ls, D).  The caches are float32, whatever the model's
  dtype.
- the step writes the new K/V at ``t`` with a device index
  (``index_copy_``), reads ``pos[t]`` with ``index_select``, takes the
  top K of each sentence's K*V candidates with a stable descending sort
  (``lax.top_k``'s order: the lower index first among equal scores),
  gathers the tokens, flags and caches by parent beam and increments
  ``t``.  The encoder and the cross K/V run once per search, eagerly,
  before the loop.
- the host replays the step and reads ``finished.all()`` every
  ``CHECK_EVERY`` (4) steps: one host sync per 4 tokens, and never more
  than ``max_len`` steps.  A step after every beam has finished changes
  nothing: finished beams propose only EOS at zero cost and the
  positions past EOS already hold EOS, so the result is the reference's
  early exit.
- the step reads the model's parameters by address: each parameter
  array is bound to a home tensor (``NDArray._bind``) at every search,
  so a value replaced since (``load_parameters``, ``set_data``) is
  copied into the home and a ``trainer.step`` is seen without a new
  program.  :meth:`TransformerBeamDecoder.refresh` binds them at once.

On the card a signature's first search runs step 0 eagerly on the
program's stream, then captures the step as a CUDA graph in a memory
pool of its own and replays it from step 1 on.  A failed capture or
replay raises :class:`~mxnet_tpu_torch.base.KernelError`, on that call
and on every later call of the signature; ``graphs=False`` (the
caller's choice) runs the same step eagerly on the card.  On the CPU
the step runs eagerly.  Beam ranking uses the raw summed log-probs
during the search and GNMT's length normalization ``((5 + len) / 6) **
alpha`` for the final pick, as in the reference.
"""
from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F

from .. import autograd
from .. import ndarray as nd
from ..base import KernelError, MXNetError
from ..engine import _CAPTURE_LOCK

__all__ = ["TransformerBeamDecoder", "CHECK_EVERY"]

NEG_INF = -1e9
# steps between two host reads of ``finished.all()``
CHECK_EVERY = 4
# the decoder cell's parameters, by the key the step reads them under
_CELL_PARAMS = (
    ("qkv_w", "self_attention.qkv.weight"),
    ("qkv_b", "self_attention.qkv.bias"),
    ("so_w", "self_attention.out_proj.weight"),
    ("so_b", "self_attention.out_proj.bias"),
    ("sn_g", "self_norm.gamma"), ("sn_b", "self_norm.beta"),
    ("q_w", "cross_attention.q_proj.weight"),
    ("q_b", "cross_attention.q_proj.bias"),
    ("kv_w", "cross_attention.kv_proj.weight"),
    ("kv_b", "cross_attention.kv_proj.bias"),
    ("co_w", "cross_attention.out_proj.weight"),
    ("co_b", "cross_attention.out_proj.bias"),
    ("cn_g", "cross_norm.gamma"), ("cn_b", "cross_norm.beta"),
    ("f1_w", "ffn.ffn_1.weight"), ("f1_b", "ffn.ffn_1.bias"),
    ("f2_w", "ffn.ffn_2.weight"), ("f2_b", "ffn.ffn_2.bias"),
    ("fn_g", "ffn.layer_norm.gamma"), ("fn_b", "ffn.layer_norm.beta"),
)


def _attr(block, path):
    for part in path.split("."):
        block = getattr(block, part)
    return block


def _ln(x, g, b, eps=1e-5):
    return F.layer_norm(x, g.shape, g, b, eps)


class _Program:
    """One signature's static state, its step, and on the card the step's
    CUDA graph (module docstring)."""

    def __init__(self, key, heads, units, n_layers, vocab, device, graphs):
        B, K, Ls, T, _bos, eos, _alpha = key
        self.key = key
        self.device = device
        H, D = heads, units // heads
        BK = B * K
        f32 = dict(dtype=torch.float32, device=device)
        self.t = torch.zeros((), dtype=torch.long, device=device)
        self.tokens = torch.empty((B, K, T + 1), dtype=torch.long,
                                  device=device)
        self.scores = torch.empty((B, K), **f32)
        self.finished = torch.empty((B, K), dtype=torch.bool, device=device)
        self.lens = torch.empty((B, K), dtype=torch.long, device=device)
        self.ck = [torch.zeros((BK, H, T, D), **f32) for _ in range(n_layers)]
        self.cv = [torch.zeros((BK, H, T, D), **f32) for _ in range(n_layers)]
        self.mem_k = [torch.zeros((BK, H, Ls, D), **f32)
                      for _ in range(n_layers)]
        self.mem_v = [torch.zeros((BK, H, Ls, D), **f32)
                      for _ in range(n_layers)]
        self.mem_mask = torch.zeros((BK, 1, Ls), **f32)
        self.eos_only = torch.full((vocab,), NEG_INF, **f32)
        self.eos_only[eos] = 0.0
        self.steps = torch.arange(T, device=device)
        self.batch_ix = torch.arange(B, device=device)[:, None]
        self.use_graph = graphs and device.type == "cuda"
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.graph = None
        self.error = None
        self.capture_s = None
        self.pool = None
        self.replays = 0

    # ------------------------------------------------------------ search
    def reset(self, p, mem, src_valid):
        """The search's first state, and the cross K/V of ``mem`` (Ls, B,
        C) for every layer (outside the step)."""
        B, K, Ls, T, bos, eos, _alpha = self.key
        H = self.ck[0].shape[1]
        D = self.ck[0].shape[3]
        self.t.zero_()
        self.tokens.fill_(eos)
        self.tokens[:, :, 0] = bos
        # only beam 0 is live at t = 0 (equal beams would repeat)
        self.scores.fill_(NEG_INF)
        self.scores[:, 0] = 0.0
        self.finished.zero_()
        self.lens.fill_(T)
        for c in self.ck + self.cv:
            c.zero_()
        for li, cp in enumerate(p["cells"]):
            kv = F.linear(mem, cp["kv_w"], cp["kv_b"]).view(Ls, B, H, 2, D)
            self.mem_k[li].copy_(kv[:, :, :, 0].permute(1, 2, 0, 3)
                                 .repeat_interleave(K, dim=0))
            self.mem_v[li].copy_(kv[:, :, :, 1].permute(1, 2, 0, 3)
                                 .repeat_interleave(K, dim=0))
        ok = torch.arange(Ls, device=mem.device)[None, :] < src_valid[:, None]
        self.mem_mask.copy_(torch.where(ok.repeat_interleave(K, dim=0), 0.0,
                                        NEG_INF)[:, None, :])

    def step(self, p):
        """One decode step over the static state, in place."""
        B, K, _Ls, T, _bos, eos, _alpha = self.key
        BK = B * K
        H, D = self.ck[0].shape[1], self.ck[0].shape[3]
        C = H * D
        t = self.t
        t1 = t.view(1)
        cur = self.tokens.index_select(2, t1).view(BK)
        x = p["tgt_embed"].index_select(0, cur) * math.sqrt(C) \
            + p["pos"].index_select(0, t1)                      # (BK, C)
        pos_ok = self.steps <= t                                # (T,)
        for li, cp in enumerate(p["cells"]):
            # masked self-attention over the cache (per head [q|k|v])
            qkv = F.linear(x, cp["qkv_w"], cp["qkv_b"]).view(BK, H, 3, D)
            q, k, v = qkv.unbind(2)
            ck, cv = self.ck[li], self.cv[li]
            ck.index_copy_(2, t1, k.unsqueeze(2))
            cv.index_copy_(2, t1, v.unsqueeze(2))
            s = torch.einsum("bhd,bhtd->bht", q / math.sqrt(D), ck)
            att = torch.softmax(torch.where(pos_ok, s, NEG_INF), dim=-1)
            o = torch.einsum("bht,bhtd->bhd", att, cv).reshape(BK, C)
            h = _ln(x + F.linear(o, cp["so_w"], cp["so_b"]),
                    cp["sn_g"], cp["sn_b"])
            # cross-attention over the encoder's memory
            cq = F.linear(h, cp["q_w"], cp["q_b"]).view(BK, H, D)
            cs = torch.einsum("bhd,bhsd->bhs", cq / math.sqrt(D),
                              self.mem_k[li]) + self.mem_mask
            catt = torch.softmax(cs, dim=-1)
            co = torch.einsum("bhs,bhsd->bhd", catt,
                              self.mem_v[li]).reshape(BK, C)
            c = _ln(h + F.linear(co, cp["co_w"], cp["co_b"]),
                    cp["cn_g"], cp["cn_b"])
            # post-norm relu FFN
            f = F.linear(F.relu(F.linear(c, cp["f1_w"], cp["f1_b"])),
                         cp["f2_w"], cp["f2_b"])
            x = _ln(c + f, cp["fn_g"], cp["fn_b"])
        logits = F.linear(x, p["proj_w"], p["proj_b"])
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.view(B, K, V), dim=-1)
        # finished beams propose only EOS, at zero cost
        logp = torch.where(self.finished[:, :, None], self.eos_only, logp)
        total = (self.scores[:, :, None] + logp).view(B, K * V)
        vals, idx = torch.sort(total, dim=1, descending=True, stable=True)
        top, idx = vals[:, :K], idx[:, :K]
        parent = idx // V
        tok = idx % V
        tokens = self.tokens.gather(
            1, parent[:, :, None].expand(B, K, T + 1))
        tokens.index_copy_(2, t1 + 1, tok[:, :, None])
        self.tokens.copy_(tokens)
        fin_p = self.finished.gather(1, parent)
        lens_p = self.lens.gather(1, parent)
        is_eos = tok == eos
        self.lens.copy_(torch.where(fin_p.logical_not() & is_eos, t + 1,
                                    lens_p))
        self.finished.copy_(fin_p | is_eos)
        self.scores.copy_(top)
        flat_parent = (self.batch_ix * K + parent).view(BK)
        for c in self.ck + self.cv:
            c.copy_(c.index_select(0, flat_parent))
        t.add_(1)

    def result(self):
        """The best beam of each sentence: (ids (B, max_len + 1) int32,
        lengths (B,))."""
        B, _K, _Ls, _T, _bos, _eos, alpha = self.key
        lens = torch.where(self.finished, self.lens, self.t)    # ran off end
        lp = ((5.0 + lens.to(torch.float32)) / 6.0) ** alpha
        best = torch.argmax(self.scores / lp, dim=1)
        rows = torch.arange(B, device=self.device)
        return self.tokens[rows, best].to(torch.int32), lens[rows, best]

    # ------------------------------------------------------------- graphs
    def _capture(self, p):
        graph = torch.cuda.CUDAGraph()
        # the step's temporaries live in a memory pool of the graph's own
        pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, torch.cuda.graph(
                graph, pool=pool, stream=self.stream,
                capture_error_mode="thread_local"):
            self.step(p)
        self.capture_s = time.perf_counter() - t0
        self.pool = pool
        self.graph = graph

    def advance(self, p, counts):
        """One step: eager (the CPU, ``graphs=False``, or a signature's
        very first step, after which the step is captured) or a replay."""
        if not self.use_graph or self.graph is None:
            self.step(p)
            counts["eager_steps"] += 1
            if self.use_graph:
                try:
                    self._capture(p)
                except Exception as e:
                    self.error = KernelError(
                        f"TransformerBeamDecoder: capture of the decode "
                        f"step {self.key} as a CUDA graph failed: {e}")
                    raise self.error from e
            return
        try:
            self.graph.replay()
        except Exception as e:
            self.error = KernelError(
                f"TransformerBeamDecoder: replay of the decode step "
                f"{self.key} failed: {e}")
            raise self.error from e
        self.replays += 1
        counts["replays"] += 1

    def search(self, p, mem, src_valid):
        if self.error is not None:
            raise KernelError(str(self.error))
        T = self.key[3]
        counts = {"steps": 0, "replays": 0, "eager_steps": 0, "syncs": 0}
        self.reset(p, mem, src_valid)
        while counts["steps"] < T:
            self.advance(p, counts)
            counts["steps"] += 1
            n = counts["steps"]
            if n % CHECK_EVERY == 0 and n < T:
                counts["syncs"] += 1
                if bool(self.finished.all()):
                    break
        ids, lens = self.result()
        counts["syncs"] += 1            # the caller's read of the ids
        return ids, lens, counts


class TransformerBeamDecoder:
    """Batched beam search over a ``models.Transformer`` (module
    docstring).  ``graphs=False`` runs the step eagerly on the card."""

    def __init__(self, model, graphs=True):
        self.model = model
        self.graphs = graphs
        self._progs = {}
        self._casts = {}
        self.last = None
        self.refresh()

    def _params(self):
        """The tensors the step reads, float32: each parameter's bound
        home, or a float32 copy of it refreshed at every search."""
        m = self.model
        casts = self._casts

        def g(param):
            home, _copied = param.data()._bind()
            if home.dtype == torch.float32:
                return home
            buf = casts.get(param.name)
            if buf is None:
                buf = casts[param.name] = torch.empty_like(
                    home, dtype=torch.float32)
            buf.copy_(home)
            return buf

        cells = [{key: g(_attr(cell, path)) for key, path in _CELL_PARAMS}
                 for cell in m.decoder.cells]
        return {"tgt_embed": g(m.tgt_embed.weight),
                "pos": g(m.decoder.pos_embed),
                "proj_w": g(m.proj.weight), "proj_b": g(m.proj.bias),
                "cells": cells}

    def refresh(self):
        """Bind the parameters now (after ``load_parameters``): a value
        that replaced a parameter's tensor is copied into the tensor the
        programs read.  Programs survive."""
        with torch.no_grad():
            self.params = self._params()

    def __call__(self, src, src_valid=None, bos=2, eos=3, beam_size=4,
                 max_decode_len=32, alpha=0.6):
        """Beam-search decode.  Returns (B, max_decode_len + 1) int32 ids
        (BOS first; positions past EOS hold EOS)."""
        m = self.model
        n_pos = int(m.decoder.pos_embed.shape[0])
        if int(max_decode_len) > n_pos:
            raise MXNetError(
                f"max_decode_len={max_decode_len} exceeds the model's "
                f"positional table ({n_pos} positions); rebuild the model "
                f"with max_length >= {int(max_decode_len)} or decode "
                f"shorter sequences")
        B, Ls = src.shape
        key = (B, int(beam_size), Ls, int(max_decode_len), int(bos),
               int(eos), float(alpha))
        prog = self._progs.get(key)
        if prog is not None and prog.error is not None:
            raise KernelError(str(prog.error))
        with autograd.pause(train_mode=False):
            mem = m.encode(src, src_valid)                      # (Ls, B, C)
        dev = mem._data.device
        sv = (src_valid._data.to(device=dev, dtype=torch.long)
              if src_valid is not None
              else torch.full((B,), Ls, dtype=torch.long, device=dev))
        with torch.no_grad():
            self.params = p = self._params()
            if prog is None:
                prog = self._progs[key] = _Program(
                    key, m._num_heads, m._units, len(p["cells"]),
                    p["proj_b"].shape[0], dev, self.graphs)
            memf = mem._data.detach().to(torch.float32)
            if prog.stream is None:
                ids, _lens, counts = prog.search(p, memf, sv)
            else:
                caller = torch.cuda.current_stream(dev)
                prog.stream.wait_stream(caller)
                with torch.cuda.stream(prog.stream):
                    ids, _lens, counts = prog.search(p, memf, sv)
                caller.wait_stream(prog.stream)
                ids.record_stream(caller)
        self.last = counts
        return nd.NDArray._wrap(ids, mem.context)
