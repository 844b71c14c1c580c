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


def _top1_tensors(gates, capacity):
    """gates (S, E) -> combine (S, E, C), dispatch (S, E, C), and the
    Switch load-balancing loss E * sum_e(frac_tokens_e * mean_gate_e)."""
    _S, E = gates.shape
    onehot = F.one_hot(torch.argmax(gates, dim=-1), E).to(gates.dtype)
    # each token's position in its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    keep = (pos >= 0) & (pos < capacity)
    pos_cap = torch.clamp(pos, 0, capacity - 1).to(torch.int64)
    dispatch = F.one_hot(pos_cap, capacity).to(gates.dtype) \
        * keep.to(gates.dtype)[..., None]
    gate_val = torch.sum(gates * onehot, dim=-1, keepdim=True)
    combine = dispatch * gate_val[..., None]
    aux = E * torch.sum(onehot.mean(dim=0) * gates.mean(dim=0))
    return combine, dispatch, aux


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
    combine, dispatch, aux = _top1_tensors(gates, cap)
    return (combine.to(gate_logits.dtype), dispatch.to(gate_logits.dtype),
            aux)


@register("_contrib_moe_ffn", num_inputs=6, num_outputs=2,
          aliases=["moe_ffn"])
def moe_ffn(x, wg, w1, b1, w2, b2, *, capacity_factor: float = 1.25,
            activation: str = "gelu"):
    """Route, run the expert MLPs, combine.  x (B, L, C) or (S, C); wg
    (C, E); w1 (E, C, H); b1 (E, H); w2 (E, H, C); b2 (E, C).  Returns
    (out with x's shape, aux_loss ())."""
    if activation not in ("relu", "gelu"):
        raise MXNetError(
            f"moe_ffn: unsupported activation {activation!r} "
            f"(supported: 'relu', 'gelu')")
    C = x.shape[-1]
    xs = x.reshape(-1, C)
    S, E = xs.shape[0], w1.shape[0]
    cap = max(1, int(capacity_factor * S / E))
    gates = torch.softmax(xs.to(torch.float32) @ wg.to(torch.float32),
                          dim=-1)
    combine, dispatch, aux = _top1_tensors(gates, cap)
    combine, dispatch = combine.to(xs.dtype), dispatch.to(xs.dtype)
    expert_in = torch.einsum("sec,sm->ecm", dispatch, xs)
    h = torch.einsum("ecm,emh->ech", expert_in, w1) + b1[:, None, :]
    h = torch.relu(h) if activation == "relu" \
        else F.gelu(h, approximate="tanh")
    expert_out = torch.einsum("ech,ehm->ecm", h, w2) + b2[:, None, :]
    out = torch.einsum("sec,ecm->sm", combine, expert_out)
    return out.reshape(x.shape), aux
