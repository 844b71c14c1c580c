"""Device contexts of the PyTorch port: ``Context``, ``cpu()``, ``gpu()``
and the ``with ctx:`` scope.

The counterpart of ``mxnet_tpu.context``.  A context names a
``torch.device``: ``cpu(i)`` is the host (every ``i`` is a context of
its own, backed by torch's one CPU device, so per-context copies are
separate tensors), ``gpu(i)`` is CUDA card ``i``.

The default context is the card: :func:`current_context` is ``gpu(0)``
unless a ``with mx.cpu(0):`` scope says otherwise, and there is no
fallback.  A ``gpu(i)`` that the machine lacks raises
:class:`~mxnet_tpu_torch.base.MXNetError` when an array is placed there.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "gpu_memory_info", "context_of"]


class Context:
    """A device context (reference: ``python/mxnet/context.py``)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise MXNetError(f"unknown device type {device_type!r}")
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def torch_device(self) -> torch.device:
        """The ``torch.device`` behind this context; a card the machine
        lacks raises."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if self.device_id >= n:
            raise MXNetError(
                f"context {self} has no device: this machine has {n} CUDA "
                f"card(s); ask for the host with ctx=mx.cpu(0) or "
                f"`with mx.cpu(0):`")
        return torch.device("cuda", self.device_id)

    def empty_cache(self):
        """Release the card's cached memory (reference:
        Context.empty_cache)."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.torch_device()):
                torch.cuda.empty_cache()

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx
        return False


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id: int = 0):
    """(free, total) bytes of card ``device_id``."""
    return torch.cuda.mem_get_info(gpu(device_id).torch_device())


def current_context() -> Context:
    """The scope's context, else ``gpu(0)``: the card, with no fallback
    to the host."""
    ctx = getattr(Context._default_ctx, "value", None)
    return gpu(0) if ctx is None else ctx


def context_of(device: torch.device) -> Context:
    """The context of a tensor's device (the CPU is ``cpu(0)``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return gpu(device.index if device.index is not None
                   else torch.cuda.current_device())
    return cpu(0)
