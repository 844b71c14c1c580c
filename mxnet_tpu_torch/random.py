"""The eager RNG stream of the PyTorch port: seed it, draw from it, and
snapshot or restore it for a checkpoint, and the sampling ops.

The counterpart of ``mxnet_tpu.random``'s eager half (``seed``,
``get_state``, ``set_state``, ``uniform``, ``normal``).  The JAX package
keeps one threefry key; the port's stream is torch's default generators,
one a device: the CPU generator and each CUDA device's.  ``mx.init``'s
initializers, ``mx.nd.random`` and the Dropout op draw from the
generator of their array's device.  Dropout in a captured
training step draws from the CUDA default generator too: the graph
registered that generator at capture and reads its seed and offset at
every replay, so restoring the generator with :func:`set_state` makes a
resumed replay draw the masks of the run that was saved.

The sampling ops (``_random_*``, ``_sample_*``, ``_shuffle``,
``sample_uniform`` / ``sample_normal``) are registered here, under the
JAX package's names and with ``mutates_rng``.  They draw from the
default generator of their output's device, so :func:`seed`,
:func:`get_state` and :func:`set_state` cover them, and a sampler
inside a captured CUDA graph draws anew at every replay.  Each builds
on draws that a graph can capture (``uniform_``, ``normal_``, gamma
and Poisson draws): ``_sample_multinomial`` is a uniform draw searched
in the rows' cumulative sums, not ``torch.multinomial`` (which waits
for the host on CUDA), and ``_shuffle`` sorts uniform keys.  Threefry
and Philox streams differ, so the port's draws match the JAX
package's in distribution, not value for value.
"""
from __future__ import annotations

import math

import torch

from .ops.registry import register
from .ops.tensor import _dtype, device_for

__all__ = ["seed", "get_state", "set_state", "uniform", "normal", "randint",
           "randn"]


def seed(seed_state: int):
    """Reseed torch's CPU generator and every CUDA device's default
    generator (the counterpart of ``mx.random.seed``)."""
    torch.manual_seed(int(seed_state))


def get_state():
    """A snapshot of the eager stream as plain host data
    (JSON-serialisable), for checkpoint and resume: ``{"cpu": [...]}``
    with ``torch.get_rng_state()`` as a list of ints, and ``"cuda"``
    with ``torch.cuda.get_rng_state(i)`` of every device where CUDA is
    initialised.  Restoring it with :func:`set_state` makes the draws
    that follow equal to those of a run that was not interrupted."""
    state = {"cpu": torch.get_rng_state().tolist()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = [torch.cuda.get_rng_state(i).tolist()
                         for i in range(torch.cuda.device_count())]
    return state


def set_state(state):
    """Restore a :func:`get_state` snapshot (the checkpoint-resume half
    of the bit-exact contract)."""
    torch.set_rng_state(torch.tensor(state["cpu"], dtype=torch.uint8))
    for i, dev_state in enumerate(state.get("cuda") or ()):
        torch.cuda.set_rng_state(
            torch.tensor(dev_state, dtype=torch.uint8), device=i)


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def uniform(low=0.0, high=1.0, shape=None, dtype=torch.float32,
            device="cuda"):
    """Samples of U[low, high) from the default generator of
    ``device``."""
    return torch.empty(_shape(shape), dtype=dtype, device=device).uniform_(
        float(low), float(high))


def normal(loc=0.0, scale=1.0, shape=None, dtype=torch.float32,
           device="cuda"):
    """Samples of N(loc, scale^2) from the default generator of
    ``device``."""
    return torch.empty(_shape(shape), dtype=dtype, device=device).normal_(
        float(loc), float(scale))


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    """An NDArray of integers drawn uniformly from [low, high):
    ``mx.nd.random.randint``."""
    from .ndarray import random as nd_random
    return nd_random.randint(low, high, shape, dtype, ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    """An NDArray of normal draws of ``shape``: ``mx.nd.random.randn``."""
    from .ndarray import random as nd_random
    return nd_random.randn(*shape, loc=loc, scale=scale, dtype=dtype,
                           ctx=ctx)


# ---------------------------------------------------------------------------
# sampling ops
# ---------------------------------------------------------------------------
def _draw(shape, dtype, ctx):
    return torch.empty(_shape(shape), dtype=_dtype(dtype),
                       device=device_for(ctx))


@register("_random_uniform", num_inputs=0, differentiable=False,
          mutates_rng=True, aliases=["random_uniform"])
def _random_uniform(*, low: float = 0.0, high: float = 1.0, shape=None,
                    dtype: str = "float32", ctx: str = ""):
    return _draw(shape, dtype, ctx).uniform_(float(low), float(high))


@register("_random_normal", num_inputs=0, differentiable=False,
          mutates_rng=True, aliases=["random_normal"])
def _random_normal(*, loc: float = 0.0, scale: float = 1.0, shape=None,
                   dtype: str = "float32", ctx: str = ""):
    return _draw(shape, dtype, ctx).normal_(float(loc), float(scale))


def _gamma(alpha, shape, dtype, device):
    return torch._standard_gamma(torch.full(
        _shape(shape), float(alpha), dtype=dtype, device=device))


@register("_random_gamma", num_inputs=0, differentiable=False,
          mutates_rng=True, aliases=["random_gamma"])
def _random_gamma(*, alpha: float = 1.0, beta: float = 1.0, shape=None,
                  dtype: str = "float32", ctx: str = ""):
    return beta * _gamma(alpha, shape, _dtype(dtype), device_for(ctx))


@register("_random_exponential", num_inputs=0, differentiable=False,
          mutates_rng=True, aliases=["random_exponential"])
def _random_exponential(*, lam: float = 1.0, shape=None,
                        dtype: str = "float32", ctx: str = ""):
    return _draw(shape, dtype, ctx).exponential_(float(lam))


@register("_random_poisson", num_inputs=0, differentiable=False,
          mutates_rng=True, aliases=["random_poisson"])
def _random_poisson(*, lam: float = 1.0, shape=None, dtype: str = "float32",
                    ctx: str = ""):
    rate = torch.full(_shape(shape), float(lam), dtype=torch.float32,
                      device=device_for(ctx))
    return torch.poisson(rate).to(_dtype(dtype))


@register("_random_randint", num_inputs=0, differentiable=False,
          mutates_rng=True, aliases=["random_randint"])
def _random_randint(*, low: int = 0, high: int = 1, shape=None,
                    dtype: str = "int32", ctx: str = ""):
    return _draw(shape, dtype, ctx).random_(int(low), int(high))


@register("_random_negative_binomial", num_inputs=0, differentiable=False,
          mutates_rng=True, aliases=["random_negative_binomial"])
def _random_negative_binomial(*, k: int = 1, p: float = 1.0, shape=None,
                              dtype: str = "float32", ctx: str = ""):
    """Failures before the ``k``-th success: a Poisson draw whose rate
    is Gamma(k) (1 - p) / p."""
    lam = _gamma(k, shape, torch.float32, device_for(ctx)) * (1 - p) / p
    return torch.poisson(lam).to(_dtype(dtype))


@register("_sample_multinomial", differentiable=False, mutates_rng=True,
          aliases=["sample_multinomial"])
def _sample_multinomial(data, *, shape=None, get_prob: bool = False,
                        dtype: str = "int32"):
    """A category index from each probability row of ``data`` (..., K),
    ``shape`` draws a row: out (..., *shape).  A uniform draw searched in
    the row's normalised cumulative sum (no host wait, capturable).
    ``get_prob`` is ignored, as by the JAX op."""
    extra = _shape(shape)
    n = math.prod(extra) if extra else 1
    lead = tuple(data.shape[:-1])
    cdf = torch.cumsum(torch.clamp(data.to(torch.float32), min=1e-30),
                       dim=-1)
    cdf = cdf / cdf[..., -1:]
    u = torch.rand(lead + (n,), device=data.device)
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    idx = torch.clamp(idx, max=data.shape[-1] - 1)
    return idx.reshape(lead + extra).to(_dtype(dtype))


@register("_shuffle", differentiable=False, mutates_rng=True,
          aliases=["shuffle"])
def _shuffle(data):
    """A random permutation of the rows (axis 0): sorted uniform keys."""
    keys = torch.rand(data.shape[0], device=data.device)
    return data[torch.argsort(keys)]


@register("_sample_unique_zipfian", num_inputs=0, differentiable=False,
          mutates_rng=True)
def _sample_unique_zipfian(*, range_max: int = 1, shape=None):
    """``int(range_max ** u) - 1`` for uniform u, clipped to
    [0, range_max): the JAX package's formula, which does not make the
    samples unique."""
    u = torch.rand(_shape(shape), device=device_for(""))
    out = torch.exp(u * math.log(float(range_max))).to(torch.int32) - 1
    return torch.clamp(out, 0, range_max - 1)


@register("sample_uniform", num_inputs=2, differentiable=False,
          mutates_rng=True)
def sample_uniform(low, high, *, shape=None, dtype: str = "float32"):
    """``shape`` draws of U[low, high) for each element of ``low`` /
    ``high``: out low.shape + shape."""
    s = _shape(shape)
    u = torch.rand(tuple(low.shape) + s, dtype=_dtype(dtype),
                   device=low.device)
    tail = (1,) * len(s)
    return low.reshape(tuple(low.shape) + tail) + u * (high - low).reshape(
        tuple(low.shape) + tail)


@register("sample_normal", num_inputs=2, differentiable=False,
          mutates_rng=True)
def sample_normal(mu, sigma, *, shape=None, dtype: str = "float32"):
    """``shape`` draws of N(mu, sigma^2) for each element: out mu.shape +
    shape."""
    s = _shape(shape)
    z = torch.randn(tuple(mu.shape) + s, dtype=_dtype(dtype),
                    device=mu.device)
    tail = (1,) * len(s)
    return mu.reshape(tuple(mu.shape) + tail) + z * sigma.reshape(
        tuple(sigma.shape) + tail)
