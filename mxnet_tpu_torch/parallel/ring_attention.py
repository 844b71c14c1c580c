"""Ring attention: sequence (context) parallelism over the ``sp`` group.

The PyTorch port of ``mxnet_tpu.parallel.ring_attention``.  The
sequence is sharded over the ranks of a mesh axis: each rank holds one
block of queries, keys and values, and the K/V blocks (with their
global positions) rotate one hop around the ring per step while the
softmax accumulates online (flash-attention style), so memory is
O(L_local).  The JAX version is plain ``jnp`` (no Pallas), so a plain
PyTorch body is the faithful port.

The JAX package differentiates through ``ppermute``; here a
``torch.autograd.Function`` runs the backward ring in reverse: the K/V
blocks travel the other way round, each carrying its dK / dV
accumulators, which arrive back at their owner after the last hop.

A hop goes through :func:`.dist.exchange`: device to device over NCCL,
through pinned host memory for CUDA tensors over gloo
(:func:`.dist.transport` names which).
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from ..base import MXNetError
from . import dist as _dist

__all__ = ["ring_attention", "ring_self_attention"]

_NEG = -1e30


def _positions(rank, n_local, device):
    return torch.arange(rank * n_local, (rank + 1) * n_local,
                        device=device, dtype=torch.int64)


def _needed(window, r, src, n_q, n_k):
    """Whether a hop computes: always without a window; with one,
    whether any (q, k) of query block ``r`` and key block ``src`` lies
    in the band ``q - window < k <= q`` (blocks are contiguous
    ranges, so host ints decide it)."""
    if window is None:
        return True
    q0, q1 = r * n_q, (r + 1) * n_q - 1
    k0, k1 = src * n_k, (src + 1) * n_k - 1
    return k0 <= q1 and k1 > q0 - window


def _scores(q, k, q_pos, k_pos, scale, causal, window):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        dead = k_pos[None, :] > q_pos[:, None]
        if window is not None:
            dead = dead | (k_pos[None, :] <= q_pos[:, None] - window)
        s = s.masked_fill(dead[None, None], _NEG)
    return s


def _rotate(tensors, group, step):
    """Send every tensor to ring neighbour ``rank + step`` and receive
    the same shapes from ``rank - step``; returns the received ones."""
    n = tdist.get_world_size(group)
    if n == 1:
        return list(tensors)
    r = tdist.get_group_rank(group, tdist.get_rank())
    dst, src = (r + step) % n, (r - step) % n
    got = [torch.empty_like(t) for t in tensors]
    _dist.exchange([(t, dst) for t in tensors], [(g, src) for g in got],
                   group)
    return got


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, window):
        n = tdist.get_world_size(group)
        r = tdist.get_group_rank(group, tdist.get_rank())
        B, H, Lq, D = q.shape
        q_pos = _positions(r, Lq, q.device)
        m = torch.full((B, H, Lq), float("-inf"), device=q.device)
        l = torch.zeros((B, H, Lq), device=q.device)
        acc = torch.zeros((B, H, Lq, D), device=q.device)
        kb, vb, src = k, v, r
        for hop in range(n):
            k_pos = _positions(src, kb.shape[2], q.device)
            if _needed(window, r, src, Lq, kb.shape[2]):
                s = _scores(q, kb, q_pos, k_pos, scale, causal, window)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bhqk,bhkd->bhqd", p, vb.float())
                m = m_new
            if hop + 1 < n:
                kb, vb = _rotate([kb, vb], group, 1)
                src = (src - 1) % n
        out = acc / torch.clamp(l[..., None], min=1e-30)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.window = \
            group, causal, scale, window
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale, window = \
            ctx.group, ctx.causal, ctx.scale, ctx.window
        n = tdist.get_world_size(group)
        r = tdist.get_group_rank(group, tdist.get_rank())
        Lq = q.shape[2]
        q_pos = _positions(r, Lq, q.device)
        do = dout.float()
        delta = (do * out).sum(-1)                          # (B, H, Lq)
        dq = torch.zeros(q.shape, device=q.device)
        # the reverse ring: the K/V blocks go round the other way, each
        # with its dK / dV, and arrive home after the n-th hop
        kb, vb = _rotate([k, v], group, -1)
        src = (r + 1) % n
        dkb = torch.zeros(k.shape, device=k.device)
        dvb = torch.zeros(v.shape, device=v.device)
        for hop in range(n):
            k_pos = _positions(src, kb.shape[2], q.device)
            if _needed(window, r, src, Lq, kb.shape[2]):
                s = _scores(q, kb, q_pos, k_pos, scale, causal, window)
                p = torch.exp(s - lse[..., None])
                dvb = dvb + torch.einsum("bhqk,bhqd->bhkd", p, do)
                dp = torch.einsum("bhqd,bhkd->bhqk", do, vb.float())
                ds = p * (dp - delta[..., None]) * scale
                dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb.float())
                dkb = dkb + torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
            if hop + 1 < n:
                kb, vb, dkb, dvb = _rotate([kb, vb, dkb, dvb], group, -1)
                src = (src + 1) % n
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype),
                None, None, None, None)


def _check(causal, window):
    if window is not None:
        if not causal:
            raise MXNetError("ring_attention: window= requires "
                             "causal=True (sliding-window attention is "
                             "causal)")
        if int(window) < 1:
            raise MXNetError("ring_attention: window must be >= 1")


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False,
                   window=None):
    """Attention over a sequence sharded on ``axis_name``: q / k / v are
    this rank's blocks (B, H, L / n, D) of the global (B, H, L, D), rank
    ``i`` of the axis holding positions ``[i * L / n, (i + 1) * L / n)``.
    Returns this rank's (B, H, L / n, D) block of the output.

    ``window``: causal sliding-window width (key positions in
    ``(q - window, q]``); requires ``causal=True``.  Out-of-band hops
    skip their attention compute (the rotation still runs).  Every rank
    of the axis calls it (a collective)."""
    _check(causal, window)
    group = mesh.group(axis_name)
    if group is None:
        raise MXNetError("ring_attention: the mesh has no process group; "
                         "call parallel.dist.initialize and make_mesh "
                         "over it")
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return _RingAttention.apply(q, k, v, group, bool(causal), scale,
                                None if window is None else int(window))


def ring_self_attention(x, w_qkv, w_out, num_heads, mesh, axis_name="sp",
                        causal=True, window=None):
    """x (B, L / n, C) — this rank's block of a sequence-sharded input —
    -> the same block of the output; the projections are pointwise over
    the sequence and run locally (``[q | k | v]`` stacked, as the JAX
    version lays them)."""
    B, Lloc, C = x.shape
    D = C // num_heads
    qkv = torch.einsum("blc,oc->blo", x, w_qkv).reshape(
        B, Lloc, 3, num_heads, D)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = ring_attention(q, k, v, mesh, axis_name, causal, window=window)
    out = out.transpose(1, 2).reshape(B, Lloc, C)
    return torch.einsum("blc,oc->blo", out, w_out)
