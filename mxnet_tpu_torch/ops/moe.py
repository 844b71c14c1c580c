"""Mixture-of-Experts operators of the PyTorch port (GShard / Switch
top-1 routing over a fixed expert capacity).

The counterpart of ``mxnet_tpu.ops.moe``: routing is dense one-hot
products over a capacity ``C`` (never ragged gathers), so the layer is a
few batched matmuls.  ``moe_ffn``'s ``"gelu"`` is the tanh
approximation, ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register

__all__ = ["moe_top1_dispatch", "moe_ffn"]


def _route(gates, dp=None):
    """Top-1 routing of gates (S, E): the one-hot choice (S, E), each
    token's place in its chosen expert's queue (S, E; -1 elsewhere), and
    the Switch load-balancing loss E * sum_e(frac_tokens_e * mean_gate_e).

    Under ``dp`` (an axis with ``size``, ``rank``, ``gather`` and ``sum``,
    ``parallel.sharding.TensorParallel``) the tokens are this rank's
    share of the batch and the routing is the whole batch's: the places
    are offset by the per-expert counts of the ``dp`` ranks before this
    one, and the loss takes its two means over every token (the gate sums
    all-reduced differentiably)."""
    S, E = gates.shape
    onehot = F.one_hot(torch.argmax(gates, dim=-1), E).to(gates.dtype)
    counts, gate_sum, offset, n = onehot.sum(dim=0), gates.sum(dim=0), 0.0, S
    if dp is not None:
        every = dp.gather(counts[None], dim=0)                 # (dp, E)
        offset = every[:dp.rank].sum(dim=0)[None, :]
        counts = every.sum(dim=0)
        gate_sum = dp.sum(gate_sum)
        n = S * dp.size
    pos = (torch.cumsum(onehot, dim=0) + offset) * onehot - 1.0
    aux = E * torch.sum((counts / n) * (gate_sum / n))
    return onehot, pos, aux


def _dispatch(onehot, pos, gates, capacity):
    """combine (S, E, C) and dispatch (S, E, C) of :func:`_route`'s
    choice over the experts whose columns are given; tokens past
    ``capacity`` are dropped."""
    keep = (pos >= 0) & (pos < capacity)
    pos_cap = torch.clamp(pos, 0, capacity - 1).to(torch.int64)
    dispatch = F.one_hot(pos_cap, capacity).to(gates.dtype) \
        * keep.to(gates.dtype)[..., None]
    gate_val = torch.sum(gates * onehot, dim=-1, keepdim=True)
    return dispatch * gate_val[..., None], dispatch


@register("_contrib_moe_top1_dispatch", num_outputs=3,
          aliases=["moe_top1_dispatch"])
def moe_top1_dispatch(gate_logits, *, capacity: int = 0,
                      capacity_factor: float = 1.25):
    """Top-1 router over gate_logits (S, E): (combine (S, E, C), dispatch
    (S, E, C), aux_loss ()); C = ``capacity``, else
    max(1, int(capacity_factor * S / E)).  Tokens past an expert's
    capacity are dropped (zero combine weights)."""
    S, E = gate_logits.shape
    cap = int(capacity) if capacity else max(1, int(capacity_factor * S / E))
    gates = torch.softmax(gate_logits.to(torch.float32), dim=-1)
    onehot, pos, aux = _route(gates)
    combine, dispatch = _dispatch(onehot, pos, gates, cap)
    return (combine.to(gate_logits.dtype), dispatch.to(gate_logits.dtype),
            aux)


@register("_contrib_moe_ffn", num_inputs=6, num_outputs=2,
          aliases=["moe_ffn"])
def moe_ffn(x, wg, w1, b1, w2, b2, *, capacity_factor: float = 1.25,
            activation: str = "gelu"):
    """Route, run the expert MLPs, combine.  x (B, L, C) or (S, C); wg
    (C, E); w1 (E, C, H); b1 (E, H); w2 (E, H, C); b2 (E, C).  Returns
    (out with x's shape, aux_loss ())."""
    return moe_ffn_sharded(x, wg, w1, b1, w2, b2,
                           capacity_factor=capacity_factor,
                           activation=activation)


def moe_ffn_sharded(x, wg, w1, b1, w2, b2, *, capacity_factor=1.25,
                    activation="gelu", dp=None, ep=None, tp=None):
    """:func:`moe_ffn` over this rank's tokens and experts; with ``dp``,
    ``ep`` and ``tp`` all None it is ``moe_ffn``.

    Each axis is a ``parallel.sharding.TensorParallel`` or None (not
    split).  ``dp`` splits the tokens (:func:`_route` routes them as the
    whole batch); ``ep`` holds ``w1`` (E/ep, C, H), ``b1``, ``w2``,
    ``b2`` as this rank's experts and ``tp`` their hidden units (H/tp).
    The tokens entering the experts take Megatron's ``f`` over ``ep`` and
    ``tp`` (identity forward, all-reduce backward), as do the gates
    entering the combine over ``ep``; the expert outputs are summed over
    ``tp`` before ``b2`` and the combined outputs over ``ep`` (``g``).
    The gates that feed the aux loss skip ``f``: every rank computes
    that gradient whole."""
    if activation not in ("relu", "gelu"):
        raise MXNetError(
            f"moe_ffn: unsupported activation {activation!r} "
            f"(supported: 'relu', 'gelu')")
    C = x.shape[-1]
    xs = x.reshape(-1, C)
    S, e_loc = xs.shape[0], w1.shape[0]
    E = e_loc * (1 if ep is None else ep.size)
    S_global = S * (1 if dp is None else dp.size)
    cap = max(1, int(capacity_factor * S_global / E))
    gates = torch.softmax(xs.to(torch.float32) @ wg.to(torch.float32),
                          dim=-1)
    onehot, pos, aux = _route(gates, dp)
    gv = gates
    if ep is not None:
        local = slice(ep.rank * e_loc, (ep.rank + 1) * e_loc)
        onehot, pos, gv = onehot[:, local], pos[:, local], \
            ep.copy(gates)[:, local]
    combine, dispatch = _dispatch(onehot, pos, gv, cap)
    combine, dispatch = combine.to(xs.dtype), dispatch.to(xs.dtype)
    for axis in (ep, tp):
        if axis is not None:
            xs = axis.copy(xs)
    expert_in = torch.einsum("sec,sm->ecm", dispatch, xs)
    h = torch.einsum("ecm,emh->ech", expert_in, w1) + b1[:, None, :]
    h = torch.relu(h) if activation == "relu" \
        else F.gelu(h, approximate="tanh")
    expert_out = torch.einsum("ech,ehm->ecm", h, w2)
    if tp is not None:
        expert_out = tp.reduce(expert_out)
    expert_out = expert_out + b2[:, None, :]
    out = torch.einsum("sec,ecm->sm", combine, expert_out)
    if ep is not None:
        out = ep.reduce(out)
    return out.reshape(x.shape), aux
