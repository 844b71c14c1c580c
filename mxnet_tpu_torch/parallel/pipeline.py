"""Pipeline parallelism: the GPipe microbatch schedule over a ``pp``
group.

The PyTorch port of ``mxnet_tpu.parallel.pipeline``.  Stage ``p`` of
the pipeline runs on rank ``p`` of the ``pp`` group; microbatches flow
stage to stage by point-to-point hops (:func:`.dist.exchange`).  The
schedule is GPipe's fill-drain: ``T = n_micro + n_stages - 1`` ticks,
stage ``p`` processing microbatch ``t - p`` at tick ``t``.  The
backward pass (a ``torch.autograd.Function``; the JAX version gets it
by differentiating ``scan`` + ``ppermute``) runs the schedule in
reverse: the last stage takes the output gradient, each stage sends its
input gradient to the stage before, and the parameter gradients of
every stage are summed over the group, so every rank holds the full
gradient of the stacked parameters, as the JAX global array is.

Uniform-stage contract: every stage maps activations of one fixed
(shape, dtype) to the same (shape, dtype) — the hand-off buffer between
neighbours has one static shape.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist
from torch.utils import _pytree as pytree

from ..base import MXNetError
from . import dist as _dist
from .mesh import Mesh, _check_device
from .sharding import all_reduce_, broadcast_

__all__ = ["pipeline_apply", "make_pipeline_mesh"]


def make_pipeline_mesh(n_stages, devices=None, device="cuda"):
    """A 1-D mesh whose single axis is the pipeline (``pp``), over the
    first ``n_stages`` ranks of the process group (every rank calls it;
    a rank past them gets a mesh it is not a member of: its
    ``coords["pp"]`` is -1)."""
    n_stages = int(n_stages)
    if devices is not None:
        have = len(devices)
    else:
        have = tdist.get_world_size() if tdist.is_initialized() else 1
    if have < n_stages:
        raise MXNetError(f"pipeline of {n_stages} stages needs "
                         f"{n_stages} devices, have {have}")
    dev = _dist.device() or _check_device(devices[0] if devices
                                          else device)
    mesh = Mesh(dev, {"pp": n_stages}, axis_names=("pp",))
    if tdist.is_initialized():
        group = tdist.new_group(list(range(n_stages)))
        rank = tdist.get_rank()
        mesh.groups = {"pp": group}
        mesh.coords = {"pp": rank if rank < n_stages else -1}
        mesh.backend = tdist.get_backend()
    return mesh


def _hop(t, group, send_to=None, recv_from=None, like=None):
    """One blocking hand-off: send ``t`` to ``send_to`` and/or receive a
    tensor shaped ``like`` from ``recv_from`` (group ranks)."""
    got = None if recv_from is None else torch.empty_like(like)
    _dist.exchange([] if send_to is None else [(t, send_to)],
                   [] if recv_from is None else [(got, recv_from)], group)
    return got


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stage_fn, treedef, group, n_stages, xs, *leaves):
        p = tdist.get_group_rank(group, tdist.get_rank())
        n_micro = xs.shape[0]
        T = n_micro + n_stages - 1
        local = [leaf.detach()[p].requires_grad_(leaf.requires_grad)
                 for leaf in leaves]
        params = pytree.tree_unflatten(local, treedef)
        saved = {}                      # microbatch -> (input leaf, output)
        outs = torch.zeros_like(xs)
        for t in range(T):
            m = t - p
            if not 0 <= m < n_micro:
                continue
            if p == 0:
                x = xs[m].detach()
            else:
                x = _hop(None, group, recv_from=p - 1, like=xs[0])
            x = x.requires_grad_(p > 0 or xs.requires_grad)
            with torch.enable_grad():
                y = stage_fn(params, x)
            if tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype:
                raise MXNetError(
                    f"pipeline_apply: stage {p} maps {tuple(x.shape)} "
                    f"{x.dtype} to {tuple(y.shape)} {y.dtype}; every stage "
                    f"must keep the shape and dtype (uniform-stage "
                    f"contract)")
            saved[m] = (x, y)
            if p < n_stages - 1:
                _hop(y.detach(), group, send_to=p + 1)
            else:
                outs[m] = y.detach()
        # only the last stage holds the outputs: give them to every rank
        broadcast_(outs, n_stages - 1, group)
        ctx.saved, ctx.local, ctx.group = saved, local, group
        ctx.n_stages, ctx.p, ctx.n_micro = n_stages, p, n_micro
        ctx.xs_grad = xs.requires_grad
        ctx.shapes = [leaf.shape for leaf in leaves]
        return outs

    @staticmethod
    def backward(ctx, douts):
        group, p, n_stages = ctx.group, ctx.p, ctx.n_stages
        n_micro = ctx.n_micro
        T = n_micro + n_stages - 1
        grads = [torch.zeros_like(t) for t in ctx.local]
        dxs = torch.zeros_like(douts)
        # the reverse schedule: stage p handles microbatch t - p at
        # reverse tick t, the last stage first
        for t in reversed(range(T)):
            m = t - p
            if not 0 <= m < n_micro:
                continue
            x, y = ctx.saved.pop(m)
            if p == n_stages - 1:
                dy = douts[m]
            else:
                dy = _hop(None, group, recv_from=p + 1, like=douts[0])
            wrt = [t_ for t_ in ctx.local if t_.requires_grad]
            need_x = x.requires_grad
            got = torch.autograd.grad(
                y, ([x] if need_x else []) + wrt, dy, allow_unused=True)
            dx = got[0] if need_x else None
            for i, g in zip([i for i, t_ in enumerate(ctx.local)
                             if t_.requires_grad], got[int(need_x):]):
                if g is not None:
                    grads[i] += g
            if p > 0:
                _hop(dx, group, send_to=p - 1)
            elif dx is not None:
                dxs[m] = dx
        # each stage's gradient lands in its own row of the stacked
        # parameters; the group sum gives every rank the full gradient
        full = []
        for g, shape in zip(grads, ctx.shapes):
            buf = torch.zeros(shape, dtype=g.dtype, device=g.device)
            buf[p] = g
            full.append(all_reduce_(buf, group))
        if ctx.xs_grad:
            broadcast_(dxs, 0, group)
        return (None, None, None, None,
                dxs if ctx.xs_grad else None, *full)


def pipeline_apply(stage_fn, stage_params, micro_inputs, mesh,
                   axis: str = "pp"):
    """Run ``micro_inputs`` through the stage pipeline.

    ``stage_fn(params, x) -> y`` with ``y``'s shape and dtype ``x``'s
    (uniform-stage contract).  ``stage_params``: a pytree whose leaves
    have a leading stage dimension of size ``mesh.shape[axis]``; every
    rank passes the same values and stage ``p`` uses row ``p``.
    ``micro_inputs``: (n_micro, micro_batch, ...), the same on every
    rank.  Returns the last stage's (n_micro, micro_batch, ...) outputs
    on every rank of the group; gradients flow to ``stage_params`` (the
    full stacked gradient on every rank) and ``micro_inputs``.  Every
    rank of the pipeline mesh calls it (a collective)."""
    group = mesh.group(axis)
    n_stages = mesh.shape[axis]
    if group is None:
        if n_stages != 1:
            raise MXNetError("pipeline_apply: the mesh has no process "
                             "group; call parallel.dist.initialize first")
    elif mesh.coords[axis] < 0:
        raise MXNetError("pipeline_apply: this rank is not a stage of "
                         "the pipeline mesh")
    leaves, treedef = pytree.tree_flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != n_stages:
            raise MXNetError(f"pipeline_apply: a stage parameter has "
                             f"leading dim {leaf.shape[0]}, want "
                             f"{n_stages} (one row per stage)")
    if group is None:
        params = pytree.tree_unflatten([leaf[0] for leaf in leaves],
                                       treedef)
        return torch.stack([stage_fn(params, x) for x in micro_inputs])
    return _Pipeline.apply(stage_fn, treedef, group, n_stages,
                           micro_inputs, *leaves)
