"""Optimizers over dicts of tensors for the port's trainer.

The arithmetic of ``mxnet_tpu.parallel.optim`` (SGD with momentum,
AdamW, LAMB), over ``{name: tensor}`` dicts.  The JAX versions are pure
and return new trees; these update ``params`` and ``state`` IN PLACE
under ``torch.no_grad()`` (no second copy of the weights) and return
them, so callers keep the JAX calling convention.  State tensors take
the parameter's dtype, as ``zeros_like`` gives.  The AdamW/LAMB step
count is a 0-d int32 tensor on the parameters' device, as the JAX
state's ``jnp.int32`` array is, advanced in place; the bias corrections
are 0-d fp32 tensors computed from it on the device, as JAX computes
them (a bf16 update divides by them rounded to bf16).  No value of the update is a host number that changes from step
to step (``lr``, the betas, ``eps`` and ``wd`` are constants), so the
update can be captured into a CUDA graph and replayed.  Each elementwise
step runs over all tensors at once (``torch._foreach_*``, a few launches
per step rather than a few per tensor), with the JAX expressions' order
of operations.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_init", "sgd_update", "adamw_init", "adamw_update",
           "lamb_init", "lamb_update"]


# ------------------------------------------------------------------- SGD
def sgd_init(params):
    return {"mom": {n: torch.zeros_like(p) for n, p in params.items()}}


def _lists(params, grads, *trees):
    names = list(params)
    return ([params[n] for n in names], [grads[n] for n in names],
            *([tree[n] for n in names] for tree in trees))


@torch.no_grad()
def sgd_update(params, grads, state, lr=0.01, momentum=0.9, wd=0.0):
    """mom = momentum * mom - lr * (g + wd * w); w += mom (in place)."""
    ws, gs, ms = _lists(params, grads, state["mom"])
    step = torch._foreach_add(gs, torch._foreach_mul(ws, wd))
    torch._foreach_mul_(step, lr)
    torch._foreach_mul_(ms, momentum)
    torch._foreach_sub_(ms, step)
    torch._foreach_add_(ws, ms)
    return params, state


# ----------------------------------------------------------------- AdamW
def adamw_init(params):
    device = next(iter(params.values())).device if params else None
    return {"mean": {n: torch.zeros_like(p) for n, p in params.items()},
            "var": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _bias_correction(beta, step):
    """1 - beta ** step as a 0-d fp32 tensor on the step's device, as
    JAX computes it (``1.0 - beta ** step.astype(jnp.float32)``)."""
    return 1.0 - torch.pow(beta, step.float())


def _adam_direction(params, grads, state, beta1, beta2, eps, wd):
    """Advance the step count and both moments in place; returns the
    weights and the direction u = (m / c1) / (sqrt(v / c2) + eps) + wd * w
    per tensor, with c1, c2 the bias corrections."""
    ws, gs, ms, vs = _lists(params, grads, state["mean"], state["var"])
    step = state["step"]
    step.add_(1)
    c1, c2 = _bias_correction(beta1, step), _bias_correction(beta2, step)
    torch._foreach_mul_(ms, beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - beta1))
    torch._foreach_mul_(vs, beta2)
    sq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_add_(vs, sq)
    # a list divided by a 0-d tensor is one launch only where the two
    # share a dtype (else one launch a tensor), so a bf16 list divides by
    # c1 and c2 rounded to bf16: a relative error of at most 2^-9, the
    # size of the rounding of every bf16 result of the division.  JAX
    # promotes the direction to fp32 here; the port's bf16 step stays
    # within 2^-6 of JAX's (tests/test_torch_train_graphs.py)
    dt = ms[0].dtype if ms else c1.dtype
    den = torch._foreach_div(vs, c2.to(dt))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(ms, c1.to(dt))
    torch._foreach_div_(u, den)
    torch._foreach_add_(u, torch._foreach_mul(ws, wd))
    return ws, u


@torch.no_grad()
def adamw_update(params, grads, state, lr=1e-3, beta1=0.9, beta2=0.999,
                 eps=1e-8, wd=0.01):
    """w -= lr * ((m / c1) / (sqrt(v / c2) + eps) + wd * w) (in place)."""
    ws, u = _adam_direction(params, grads, state, beta1, beta2, eps, wd)
    torch._foreach_mul_(u, lr)
    torch._foreach_sub_(ws, u)
    return params, state


# ------------------------------------------------------------------ LAMB
def lamb_init(params):
    return adamw_init(params)


@torch.no_grad()
def lamb_update(params, grads, state, lr=1e-3, beta1=0.9, beta2=0.999,
                eps=1e-6, wd=0.01):
    """The AdamW direction u scaled per tensor by the trust ratio
    ||w|| / ||u|| (1 where either norm is 0): w -= lr * ratio * u (in
    place)."""
    ws, us = _adam_direction(params, grads, state, beta1, beta2, eps, wd)
    for w, u in zip(ws, us):
        r1 = torch.linalg.vector_norm(w)
        r2 = torch.linalg.vector_norm(u)
        ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                            torch.ones_like(r1))
        w.sub_(lr * ratio * u)
    return params, state
