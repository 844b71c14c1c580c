"""Decoder-only transformer LM and its paged decode-mode forwards.

The PyTorch port of the decoder half of
``mxnet_tpu/models/transformer_blocks.py``:

- :class:`TransformerDecoderLM` — a GPT-layout causal LM as an
  ``nn.Module`` with the JAX block's submodule and parameter names
  (``embed``, ``cells[i].attention.qkv``, ``cells[i].attn_norm.gamma``,
  ``cells[i].ffn.ffn_1``, ``final_norm``, ``proj``, ...).  Its
  ``forward(tokens (B, L)) -> logits (B, L, V)`` is the dense causal
  full forward: the plain reference the paged path is held to.
- :func:`paged_lm_params` snapshots the module into the flat parameter
  dict the paged forwards consume; :func:`load_paged_params` builds the
  same dict from the numpy image of the JAX package's
  ``paged_lm_params(lm)``, so both packages compute on one set of
  weights.
- :func:`paged_prefill` / :func:`paged_decode_step` /
  :func:`paged_verify` / :func:`paged_verify_batch` — the serving
  decode-mode forwards over the paged KV pool.  Decode and verify
  attention go through :mod:`mxnet_tpu_torch.ops.paged_attention`
  (the CUDA kernels on CUDA tensors); prefill attention is plain torch
  matmul + softmax, as the JAX package computes it outside any kernel.

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
from ..ops.paged_attention import ragged_paged_attention, ragged_paged_verify

__all__ = ["TransformerDecoderLM", "NEG_INF", "load_paged_params",
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


# ---------------------------------------------------------------------------
# modules (names mirror the Gluon blocks of the JAX package)
# ---------------------------------------------------------------------------
class _LayerNorm(nn.Module):
    """LayerNorm with the Gluon parameter names ``gamma`` / ``beta``."""

    def __init__(self, units, eps, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(units, device=device))
        self.beta = nn.Parameter(torch.empty(units, device=device))
        self.eps = eps

    def forward(self, x):
        return _f_ln(x, self.gamma, self.beta, self.eps)


class _SelfAttention(nn.Module):
    """Dense multi-head self-attention over an interleaved per-head
    [q|k|v] projection (the layout of the JAX package's
    ``MultiHeadSelfAttention``)."""

    def __init__(self, units, num_heads, dropout, device):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(units, 3 * units, device=device)
        self.out_proj = nn.Linear(units, units, device=device)
        self.dropout_layer = nn.Dropout(dropout)

    def forward(self, x, mask):
        B, L, C = x.shape
        H = self.num_heads
        D = C // H
        q, k, v = self.qkv(x).reshape(B, L, H, 3, D).unbind(3)
        s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(D) + mask
        att = self.dropout_layer(torch.softmax(s, dim=-1))
        o = torch.einsum("bhlm,bmhd->blhd", att, v).reshape(B, L, C)
        return self.out_proj(o)


class _PositionwiseFFN(nn.Module):
    """Pre-norm FFN block: x + W2 act(W1 LN(x))."""

    def __init__(self, units, hidden_size, dropout, activation, eps,
                 device):
        super().__init__()
        self.ffn_1 = nn.Linear(units, hidden_size, device=device)
        self.ffn_2 = nn.Linear(hidden_size, units, device=device)
        self.layer_norm = _LayerNorm(units, eps, device)
        self.dropout_layer = nn.Dropout(dropout)
        self.activation = activation

    def forward(self, x):
        h = _f_act(self.ffn_1(self.layer_norm(x)), self.activation)
        return x + self.dropout_layer(self.ffn_2(h))


class _PreNormCell(nn.Module):
    """Pre-norm self-attention cell (the JAX package's
    ``TransformerEncoderCell(pre_norm=True)``)."""

    def __init__(self, units, hidden_size, num_heads, dropout, activation,
                 eps, device):
        super().__init__()
        self.attention = _SelfAttention(units, num_heads, dropout, device)
        self.attn_norm = _LayerNorm(units, eps, device)
        self.dropout_layer = nn.Dropout(dropout)
        self.ffn = _PositionwiseFFN(units, hidden_size, dropout,
                                    activation, eps, device)

    def forward(self, x, mask):
        h = self.attention(self.attn_norm(x), mask)
        return self.ffn(x + self.dropout_layer(h))


class TransformerDecoderLM(nn.Module):
    """Decoder-only causal LM (GPT layout): embedding + sinusoid
    positions, pre-norm self-attention cells, final LayerNorm, untied
    vocab projection with bias.

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
        _f_act(torch.zeros(1), activation)          # reject unknown names
        self.vocab_size = int(vocab_size)
        self.units = int(units)
        self.num_heads = int(num_heads)
        self.num_layers = int(num_layers)
        self.head_dim = self.units // self.num_heads
        self.max_context = int(max_length)
        self._activation = activation
        self._eps = layer_norm_eps
        meta = torch.device("meta")
        self.embed = nn.Embedding(vocab_size, units, device=meta)
        self.dropout_layer = nn.Dropout(dropout)
        self.cells = nn.ModuleList(
            _PreNormCell(units, hidden_size, num_heads, dropout,
                         activation, layer_norm_eps, meta)
            for _ in range(num_layers))
        self.final_norm = _LayerNorm(units, layer_norm_eps, meta)
        self.proj = nn.Linear(units, vocab_size, device=meta)
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
        x = self.embed(tokens.long()) * math.sqrt(self.units) \
            + self.pos_embed[:L]
        x = self.dropout_layer(x)
        steps = torch.arange(L, device=x.device)
        mask = (steps[None, :] > steps[:, None]).to(x.dtype) * NEG_INF
        for cell in self.cells:
            x = cell(x, mask)
        return self.proj(self.final_norm(x))

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
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * gamma + beta


def _f_act(x, activation):
    if activation == "relu":
        return F.relu(x)
    if activation in ("gelu", "gelu_erf"):
        return F.gelu(x, approximate="none")
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise MXNetError(f"paged decode forward: unsupported activation "
                     f"{activation!r}")


def _f_ffn(x, cp, activation):
    h = _f_act(x @ cp["f1_w"].T + cp["f1_b"], activation)
    return h @ cp["f2_w"].T + cp["f2_b"]


def _scalar(v):
    """A host int from a python/numpy scalar or a 0-d/1-element tensor."""
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def paged_prefill(params, tokens, length, block_table, k_pages, v_pages,
                  *, num_heads, page_size, activation="relu",
                  layer_norm_eps=1e-5):
    """Prefill ONE sequence and write its K/V into cache pages.

    ``tokens``: (1, L_bucket) int, padded past ``length`` (a scalar);
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
    x_last = _f_ln(x[length - 1], params["fn_g"], params["fn_b"],
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
    ``start``: scalar global position of ``tokens[0, 0]`` (K/V of
    positions ``< start`` already sit in cache pages); ``block_table``:
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
    starts = torch.tensor([start], dtype=torch.int32, device=dev)
    lengths = torch.tensor([length], dtype=torch.int32, device=dev)
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
