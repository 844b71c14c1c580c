"""Gluon utilities of the PyTorch port (reference:
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load`` and
``clip_global_norm``, and ``check_sha1``.  ``download`` gets no
counterpart: the port runs without a network."""
from __future__ import annotations

import hashlib
import warnings
import weakref
from collections import OrderedDict

import torch

from ..base import KernelError, MXNetError
from .. import autograd
from .. import ndarray as nd
from ..ndarray import NDArray
from ..ndarray.ndarray import count_write

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "clip_programs", "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split along the batch axis into ``num_slice`` chunks."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot evenly split batch of {size} into {num_slice} slices "
            f"(set even_split=False to allow uneven)")
    step = size // num_slice
    return [data.slice_axis(axis=batch_axis, begin=i * step,
                            end=(i + 1) * step if i < num_slice - 1
                            else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and place one slice on each context (the
    data-parallel primitive)."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


class _ClipProgram:
    """``clip_global_norm`` for one list of (shape, dtype) on its
    devices: the threshold in a 0-d buffer, and the norm, the scale and the
    rescale of the arrays' own tensors in place as one function.  On the
    card it runs eagerly on the program's stream the first time it meets
    a list of tensors and is captured over them as a CUDA graph (in its
    own pool, which keeps the norm and the scale); later calls over the
    same tensors, such as a Trainer's ``.grad`` buffers, replay it.  A
    call over other tensors of the same shapes captures it again over
    those.  On the CPU, and over arrays on more than one device, it runs
    eagerly."""

    def __init__(self, devices):
        from .cached_op import _graph_backend
        self.max_norm = torch.zeros((), dtype=torch.float32,
                                    device=devices[0])
        self.graphs = _graph_backend(devices[0]) if len(devices) == 1 \
            else None
        self.pool = self.graphs.pool() if self.graphs is not None else None
        self.graph = self.total = None
        self.over = ()                  # weakrefs of the captured tensors
        self.failed = None
        self.captures = self.replays = 0

    def _body(self, tensors):
        dev = self.max_norm.device
        # one read of each array, no temporary of its size
        total = torch.sqrt(sum(torch.square(torch.linalg.vector_norm(
            x, dtype=torch.float32)).to(dev) for x in tensors))
        # a non-finite norm leaves the arrays as they are
        scale = torch.where(torch.isfinite(total) & (total > self.max_norm),
                            self.max_norm / (total + 1e-8),
                            torch.ones_like(total))
        for x in tensors:
            x.mul_(scale.to(device=x.device, dtype=x.dtype))
        return total

    def _captured_over(self, tensors):
        return len(self.over) == len(tensors) and all(
            r() is t for r, t in zip(self.over, tensors))

    def __call__(self, tensors, max_norm):
        """Rescale ``tensors`` in place; returns the norm."""
        with torch.no_grad():
            mine = tensors
            tensors = [t.detach() for t in tensors]
            if self.graphs is None:
                self.max_norm.fill_(float(max_norm))
                return self._body(tensors)
            if self.failed is not None:
                raise KernelError(
                    f"clip_global_norm: the CUDA graph of these shapes "
                    f"failed earlier: {self.failed}")
            with self.graphs.on_stream() as caller:
                self.max_norm.fill_(float(max_norm))
                if self._captured_over(mine):
                    try:
                        self.graph.replay()
                    except Exception as e:
                        raise KernelError(
                            f"clip_global_norm: replay of the CUDA graph "
                            f"failed: {e}") from e
                    self.replays += 1
                    total = self.total.clone()
                else:
                    total = self._body(tensors)
                    self._capture(tensors, mine)
            total.record_stream(caller)
            return total

    def _capture(self, tensors, mine):
        """Capture the function over ``tensors`` (``mine`` detached; the
        capture runs nothing)."""
        self.graph = self.total = None
        self.over = ()
        try:
            self.graph, (self.total,) = self.graphs.capture(
                lambda: [self._body(tensors)], self.pool)
        except Exception as e:
            self.failed = e
            raise KernelError(
                f"clip_global_norm: capture of the CUDA graph failed: "
                f"{e}") from e
        self.over = tuple(weakref.ref(t) for t in mine)
        self.captures += 1


# (shapes, dtypes, devices) -> _ClipProgram, the least recently used first
_CLIP_PROGRAMS = OrderedDict()
CLIP_PROGRAMS_KEPT = 8


def clip_programs():
    """The programs ``clip_global_norm`` holds, their captures and
    replays."""
    progs = list(_CLIP_PROGRAMS.values())
    return dict(programs=len(progs),
                captures=sum(p.captures for p in progs),
                replays=sum(p.replays for p in progs))


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so that their global L2 norm is at
    most ``max_norm``; a non-finite norm leaves them as they are.
    Returns the norm: a float with ``check_isfinite`` (one host sync),
    else an NDArray.

    One program per (shapes, dtypes, devices) of ``arrays``
    (:class:`_ClipProgram`, at most ``CLIP_PROGRAMS_KEPT`` kept): one
    CUDA graph on one card, replayed while the arrays keep their
    tensors.  ``max_norm`` goes in a device buffer, so a clipping
    schedule with a new threshold every step reuses the program, as the
    JAX package traces it for the same reason."""
    if not arrays:
        raise MXNetError("clip_global_norm: empty array list")
    for a in arrays:
        # a deferred backward that writes the array, and a lazy forward
        # that reads it, run first
        autograd.flush_if_pending_grad(a)
        a._before_write()
    tensors = [a._data for a in arrays]
    devices = tuple(dict.fromkeys(t.device for t in tensors))
    key = (tuple((tuple(t.shape), t.dtype) for t in tensors), devices)
    prog = _CLIP_PROGRAMS.get(key)
    if prog is None:
        prog = _CLIP_PROGRAMS[key] = _ClipProgram(devices)
        while len(_CLIP_PROGRAMS) > CLIP_PROGRAMS_KEPT:
            _CLIP_PROGRAMS.popitem(last=False)
    else:
        _CLIP_PROGRAMS.move_to_end(key)
    total = prog(tensors, max_norm)
    for a in arrays:
        if a._home is not None and a._t is a._home:
            count_write(a._home)
    if check_isfinite:
        t = float(total)
        if not t < float("inf"):
            warnings.warn("nan or inf found in gradients during "
                          "clip_global_norm")
        return t
    return NDArray._wrap(total, arrays[0].context)


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash
