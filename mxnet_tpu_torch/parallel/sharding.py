"""Sharding rules (parameter-name regex -> PartitionSpec), this rank's
shards of a parameter dict, and the Megatron collectives of tensor
parallelism.

The PyTorch port of ``mxnet_tpu.parallel.sharding``.  The JAX package
hands PartitionSpecs to GSPMD, which inserts the collectives; the port
holds each parameter as a plain local tensor (this rank's block of the
full array, :func:`partition_params`) and the model layers bound to a
tp group call the collectives themselves (:class:`TensorParallel`):

- column-parallel layers (``qkv``, ``ffn_1``; a vocab-split decoder)
  take their input through ``copy`` — identity forward, all-reduce of
  the input gradient backward;
- row-parallel layers (``out_proj``, ``ffn_2``) finish with ``reduce``
  — all-reduce forward, identity backward — and add their (replicated)
  bias after it;
- a layer split on its output units whose consumer needs the full width
  (a units-split embedding, a vocab-split decoder) ends in ``gather`` —
  all-gather forward, this rank's slice of the gradient backward.

Rules match the Gluon parameter names (``gluon_names()`` of the port's
models), the names the JAX rules see.  On BERT that shards the
attention and FFN weights only: its embeddings are named
``embedding<N>_weight`` and its decoder ``dense1_*``, which the
``word_embed`` / ``mlm_decoder`` rules do not match (in the JAX package
either), so they stay replicated.

Over gloo a CUDA tensor's collective is staged through host memory
(and a 16-bit float widened to float32 for the wire); over NCCL it runs
on the card.  The choice is the group's backend, nothing else.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.distributed as tdist

from ..base import MXNetError

__all__ = ["PartitionSpec", "P", "ShardingRules", "MEGATRON_RULES",
           "partition_params", "local_shard", "gather_params",
           "all_reduce_", "all_reduce_sum", "broadcast_", "all_gather",
           "TensorParallel"]


class PartitionSpec(tuple):
    """``P("tp", None)``: one mesh axis name (or None) per dimension, as
    ``jax.sharding.PartitionSpec``; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class ShardingRules:
    """Ordered (regex, PartitionSpec) table; first match wins."""

    def __init__(self, rules, default=P()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]
        self._default = default

    def spec_for(self, name, shape=None):
        for prog, spec in self._rules:
            if prog.search(name):
                return spec
        return self._default

    def safe_spec(self, mesh, name, shape):
        """The spec of ``name`` degraded to what ``mesh`` can hold: an
        axis the mesh lacks, or one whose size does not divide the
        dimension, leaves that dimension replicated."""
        spec = self.spec_for(name, shape)
        out = []
        for i, axis in enumerate(spec):
            if axis is None or i >= len(shape):
                out.append(None)
                continue
            size = mesh.shape.get(axis, 0) if isinstance(axis, str) else 1
            out.append(axis if size and shape[i] % size == 0 else None)
        return P(*out)

    def placements(self, mesh, shapes):
        """``{name: PartitionSpec}`` for ``{name: shape}``."""
        return {n: self.safe_spec(mesh, n, tuple(s))
                for n, s in shapes.items()}


# Megatron-style tensor parallelism for the in-tree transformer layers.
# Dense weights are (out_units, in_units): column-parallel shards dim 0,
# row-parallel shards dim 1.
MEGATRON_RULES = ShardingRules([
    (r"qkv_weight$", P("tp", None)),
    (r"qkv_bias$", P("tp")),
    (r"(q|kv)_proj_weight$", P("tp", None)),
    (r"(q|kv)_proj_bias$", P("tp")),
    (r"out_proj_weight$", P(None, "tp")),
    (r"ffn_1_weight$", P("tp", None)),
    (r"ffn_1_bias$", P("tp")),
    (r"ffn_2_weight$", P(None, "tp")),
    (r"(word_embed|tgt_embed|src_embed).*weight$", P(None, "tp")),
    (r"mlm_decoder_weight$", P("tp", None)),
    (r"mlm_decoder_bias$", P("tp")),
    # MoE experts: dim 0 is the expert dim, sharded over the ep axis;
    # the hidden dim additionally takes tp (GShard layout)
    (r"expert_w1$", P("ep", None, "tp")),
    (r"expert_b1$", P("ep", "tp")),
    (r"expert_w2$", P("ep", "tp", None)),
    (r"expert_b2$", P("ep", None)),
], default=P())


def _shape(a):
    return tuple(a.shape)


def local_shard(full, spec, mesh):
    """This rank's block of the full array ``full`` under ``spec``: each
    sharded dimension cut into ``mesh.shape[axis]`` equal parts, part
    ``mesh.coords[axis]`` kept (a contiguous copy)."""
    t = full if isinstance(full, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(full))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if n == 1:
            continue
        part = t.shape[dim] // n
        t = t.narrow(dim, mesh.coords[axis] * part, part)
    return t.contiguous()


def partition_params(params, mesh, rules=MEGATRON_RULES):
    """Full parameters ``{name: numpy array or tensor}`` -> (this rank's
    local shards ``{name: tensor}``, placements ``{name:
    PartitionSpec}``).  ``name`` is what the rules match (Gluon
    names)."""
    placements = rules.placements(mesh, {n: _shape(a)
                                         for n, a in params.items()})
    return ({n: local_shard(a, placements[n], mesh)
             for n, a in params.items()}, placements)


# ------------------------------------------------------------ collectives
def _wire(t, group):
    """(buffer the collective runs on, whether it is a staged copy): the
    tensor itself over NCCL or for a CPU float32/int tensor over gloo; a
    host copy (16-bit floats widened to float32) otherwise."""
    if tdist.get_backend(group) == "nccl":
        return t, False
    dtype = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype
    if t.device.type == "cpu" and dtype == t.dtype and t.is_contiguous():
        return t, False
    return t.to("cpu", dtype).contiguous(), True


def all_reduce_(t, group):
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    buf, staged = _wire(t, group)
    tdist.all_reduce(buf, group=group)
    if staged:
        t.copy_(buf)
    return t


def broadcast_(t, src, group):
    """Overwrite ``t`` with group rank ``src``'s ``t``; returns ``t``."""
    buf, staged = _wire(t, group)
    tdist.broadcast(buf, src=tdist.get_global_rank(group, src),
                    group=group)
    if staged:
        t.copy_(buf)
    return t


def all_gather(t, group, dim=0):
    """Concatenate every rank's ``t`` along ``dim`` in group-rank
    order."""
    n = tdist.get_world_size(group)
    buf, staged = _wire(t.contiguous(), group)
    parts = [torch.empty_like(buf) for _ in range(n)]
    tdist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device, t.dtype) if staged else out


def gather_params(local, placements, mesh):
    """The full arrays of ``local`` shards (a collective: every rank of
    the mesh calls it): each sharded dimension all-gathered over its
    axis's group."""
    out = {}
    for name, t in local.items():
        t = t.detach()
        for dim, axis in enumerate(placements[name]):
            if axis is not None and mesh.shape[axis] > 1:
                t = all_gather(t, mesh.group(axis), dim)
        out[name] = t
    return out


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward (Megatron's
    ``f``)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce forward and all-reduce of the gradient backward: the
    sum over the group of a value every rank then uses alike (the
    derivative of a sum that each rank's loss reads)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x, group):
    """``x`` summed over ``group``, differentiable (:class:`_AllReduceSum`)."""
    return _AllReduceSum.apply(x, group)


class _GatherFromTP(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.part = tp, dim, x.shape[dim]
        return all_gather(x, tp.group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.part,
                           ctx.part).contiguous(), None, None


class TensorParallel:
    """A tp group as the model layers see it: ``size``, this rank's
    ``rank`` in it, and the four collectives.  ``spec_of(param)`` is the
    placement of a (full) parameter of the bound block; ``mesh``, when
    given, is the whole mesh (the groups of its other axes: an
    expert-parallel layer's ``ep`` and ``dp``)."""

    def __init__(self, group, size, rank, spec_of, mesh=None):
        self.group, self.size, self.rank = group, int(size), int(rank)
        self.spec_of = spec_of
        self.mesh = mesh

    def with_spec_of(self, spec_of):
        """The same group over another ``spec_of``."""
        return TensorParallel(self.group, self.size, self.rank, spec_of,
                              self.mesh)

    def copy(self, x):
        return _CopyToTP.apply(x, self)

    def reduce(self, x):
        return _ReduceFromTP.apply(x, self)

    def gather(self, x, dim=-1):
        return _GatherFromTP.apply(x, self, dim % x.dim())

    def sum(self, x):
        return all_reduce_sum(x, self.group)

    def _specs(self, weight, bias):
        return (tuple(self.spec_of(weight)),
                None if bias is None else tuple(self.spec_of(bias)))

    def column(self, weight, bias):
        """Whether a dense layer is column-parallel (weight and bias split
        on the output units); raises on a placement the layers cannot
        run."""
        w, b = self._specs(weight, bias)
        col = w[:1] == ("tp",)
        bad = any(a is not None for a in w[1:]) or (
            b is not None and ((b[:1] == ("tp",)) != col
                               or any(a is not None for a in b[1:])))
        if bad:
            raise MXNetError(f"tensor parallelism: dense placement weight "
                             f"{w}, bias {b} is neither column-parallel "
                             f"nor replicated")
        return col

    def row(self, weight, bias):
        """Whether a dense layer is row-parallel (weight split on the
        input units, bias replicated); raises on a placement the layers
        cannot run."""
        w, b = self._specs(weight, bias)
        row = w[1:2] == ("tp",)
        bad = any(a is not None for a in w[:1] + w[2:]) or (
            b is not None and any(a is not None for a in b))
        if bad:
            raise MXNetError(f"tensor parallelism: dense placement weight "
                             f"{w}, bias {b} is neither row-parallel nor "
                             f"replicated")
        return row
