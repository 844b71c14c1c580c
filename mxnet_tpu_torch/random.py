"""The eager RNG stream of the PyTorch port: seed it, draw from it, and
snapshot or restore it for a checkpoint.

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
"""
from __future__ import annotations

import torch

__all__ = ["seed", "get_state", "set_state", "uniform", "normal"]


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
