"""``mx.nd.random`` of the PyTorch port: samplers returning NDArrays.

Draws come from the default generator of the context's device, which
``mx.random.seed`` seeds; they cannot equal the JAX package's draws.
"""
from __future__ import annotations

import torch

from ..context import current_context
from .ndarray import NDArray, to_torch_dtype

__all__ = ["uniform", "normal", "randint", "randn"]


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _empty(shape, dtype, ctx):
    ctx = ctx or current_context()
    return ctx, torch.empty(_shape(shape), dtype=to_torch_dtype(dtype),
                            device=ctx.torch_device())


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    ctx, t = _empty(shape, dtype, ctx)
    return NDArray._wrap(t.uniform_(float(low), float(high)), ctx)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    ctx, t = _empty(shape, dtype, ctx)
    return NDArray._wrap(t.normal_(float(loc), float(scale)), ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    ctx, t = _empty(shape, dtype, ctx)
    return NDArray._wrap(t.random_(int(low), int(high)), ctx)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape, dtype, ctx)
