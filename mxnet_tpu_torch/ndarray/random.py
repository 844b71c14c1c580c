"""``mx.nd.random`` of the PyTorch port: samplers returning NDArrays.

Draws come from the default generator of the context's device, which
``mx.random.seed`` seeds; they cannot equal the JAX package's draws.
``gamma``, ``exponential``, ``poisson``, ``negative_binomial``,
``multinomial`` and ``shuffle`` run the registered sampling ops
(``mxnet_tpu_torch.random``).
"""
from __future__ import annotations

import torch

from ..context import current_context
from .ndarray import NDArray, to_torch_dtype

__all__ = ["uniform", "normal", "randint", "randn", "gamma", "exponential",
           "poisson", "negative_binomial", "multinomial", "shuffle"]


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


def _sample(name, inputs, ctx, out, **kwargs):
    from ..ops import registry
    if not inputs:
        kwargs["ctx"] = ctx or current_context()
    return registry.invoke(registry.get_op(name), inputs, kwargs, out=out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    return _sample("_random_gamma", [], ctx, out, alpha=float(alpha),
                   beta=float(beta), shape=shape, dtype=dtype)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    """Exponential draws of mean ``scale`` (rate 1/scale)."""
    return _sample("_random_exponential", [], ctx, out,
                   lam=1.0 / float(scale), shape=shape, dtype=dtype)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _sample("_random_poisson", [], ctx, out, lam=float(lam),
                   shape=shape, dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None):
    return _sample("_random_negative_binomial", [], ctx, out, k=int(k),
                   p=float(p), shape=shape, dtype=dtype)


def multinomial(data, shape=None, get_prob=False, dtype="int32", out=None):
    """Category draws from the probability rows of ``data``."""
    return _sample("_sample_multinomial", [data], None, out, shape=shape,
                   get_prob=get_prob, dtype=dtype)


def shuffle(data, out=None):
    """The rows of ``data`` in a random order."""
    return _sample("_shuffle", [data], None, out)
