"""``mx.nd`` of the PyTorch port: NDArray, the op functions generated
from the registry, creation, and save / load.

The counterpart of ``mxnet_tpu.ndarray``.  Arrays from host data land on
``ctx`` or the current context (the card by default).  ``save`` /
``load`` read and write the JAX package's npz format (a
``__mx_format__`` entry of ``"dict"`` or ``"list"``), so weights carry
across the two packages.
"""
from __future__ import annotations

import sys
import types

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ops import registry as _reg
from .. import random as _random_ops  # noqa: F401  the sampling ops
from ..ops import contrib as _contrib_ops  # noqa: F401
from ..ops import detection as _detection_ops  # noqa: F401
from ..ops import linalg as _linalg_ops  # noqa: F401
from ..ops import moe as _moe_ops  # noqa: F401
from ..ops import nn as _nn_ops  # noqa: F401  registers the nn ops
from ..ops import optimizer_ops as _opt_ops  # noqa: F401
from ..ops import quantization as _quant_ops  # noqa: F401
from ..ops import tensor as _tensor_ops  # noqa: F401
from .ndarray import NDArray, dtype_name, to_torch_dtype

op = types.ModuleType(__name__ + ".op")
op.__doc__ = "Operator functions, one per registered op."
for _name in _reg.list_ops():
    setattr(op, _name, _reg.make_frontend(_reg.get_op(_name)))
sys.modules[op.__name__] = op


def invoke_by_name(name, inputs, kwargs, out=None):
    return _reg.invoke(_reg.get_op(name), inputs, kwargs, out=out)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _device(ctx):
    ctx = ctx or current_context()
    return ctx, ctx.torch_device()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx: Context = None, dtype=None) -> NDArray:
    """An array from host data (a Python list defaults to float32, as in
    the reference) or a copy of another array."""
    if isinstance(source_array, NDArray):
        return NDArray(source_array._data.detach().clone(),
                       ctx=ctx or source_array.context, dtype=dtype)
    if isinstance(source_array, torch.Tensor):
        return NDArray(source_array.detach().clone(), ctx=ctx, dtype=dtype)
    if not isinstance(source_array, _np.ndarray):
        src = _np.asarray(source_array)
        if dtype is None and src.dtype in (_np.float64, _np.int64,
                                           _np.int32):
            dtype = "float32"
        source_array = src
    return NDArray(source_array, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    ctx, dev = _device(ctx)
    return NDArray._wrap(torch.zeros(_shape(shape), dtype=to_torch_dtype(
        dtype), device=dev), ctx)


empty = zeros


def ones(shape, ctx=None, dtype="float32", **kwargs):
    ctx, dev = _device(ctx)
    return NDArray._wrap(torch.ones(_shape(shape), dtype=to_torch_dtype(
        dtype), device=dev), ctx)


def full(shape, val, ctx=None, dtype="float32", out=None):
    ctx, dev = _device(ctx)
    return NDArray._wrap(torch.full(_shape(shape), val, dtype=to_torch_dtype(
        dtype), device=dev), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    ctx, dev = _device(ctx)
    out = torch.arange(start, stop, step, dtype=torch.float64,
                       device=dev).to(to_torch_dtype(dtype))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return NDArray._wrap(out, ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    ctx, dev = _device(ctx)
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float64,
                             device=dev)
    else:
        step = (stop - start) / num
        out = start + step * torch.arange(num, dtype=torch.float64,
                                          device=dev)
    return NDArray._wrap(out.to(to_torch_dtype(dtype)), ctx)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    """An (N, M or N) array with ones on the ``k``-th diagonal."""
    ctx, dev = _device(ctx)
    cols = M if M else N
    rows = torch.arange(N, device=dev)[:, None]
    out = (torch.arange(cols, device=dev)[None, :] - rows) == k
    return NDArray._wrap(out.to(to_torch_dtype(dtype)), ctx)


def moveaxis(arr, source, destination):
    return NDArray._wrap(torch.movedim(arr._data, source, destination),
                         arr.context)


def stack_arrays(arrays, axis=0):
    return op.stack(*arrays, axis=axis)


def from_numpy(arr, zero_copy=True):
    """A host array as an NDArray on the current context (copied to the
    device; ``zero_copy`` is a hint, as in the JAX package)."""
    return array(arr)


def from_dlpack(ext):
    """An NDArray over a DLPack tensor or capsule (an object with
    ``__dlpack__``, or a capsule), sharing its memory."""
    return NDArray._wrap(torch.from_dlpack(ext))


def zeros_like(arr, **kw):
    return NDArray._wrap(torch.zeros_like(arr._data.detach()), arr.context)


def ones_like(arr, **kw):
    return NDArray._wrap(torch.ones_like(arr._data.detach()), arr.context)


def concatenate(arrays, axis=0, always_copy=True):
    return op.concat(*arrays, dim=axis)


def add_n(*arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


ElementWiseSum = add_n


def waitall():
    """Run a deferred backward and every lazy forward (as the JAX
    package's engine sweep materializes its deferred outputs), then
    block until every queued computation has finished."""
    from .. import autograd
    from ..gluon import cached_op
    autograd.flush_pending()
    cached_op.run_lazy()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# save / load: the JAX package's npz container
# ---------------------------------------------------------------------------
def _host(v):
    return v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v)


def save(fname, data):
    """Save an array, a list or a dict of arrays (reference:
    ``mx.nd.save``) as the JAX package's npz."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        arrays = {k: _host(v) for k, v in data.items()}
        with open(fname, "wb") as f:
            _np.savez(f, __mx_format__="dict", **arrays)
    elif isinstance(data, (list, tuple)):
        arrays = {f"__arr_{i}": _host(v) for i, v in enumerate(data)}
        with open(fname, "wb") as f:
            _np.savez(f, __mx_format__="list", **arrays)
    else:
        raise MXNetError("save: data must be NDArray, list or dict")


def load(fname, ctx=None):
    """Load what :func:`save` (or the JAX package's ``nd.save``) wrote:
    a dict or a list of arrays on ``ctx`` (the current context).  A
    legacy upstream ``.params`` container is read by ``compat``."""
    from ..compat import is_dmlc_params, load_params_dmlc
    if is_dmlc_params(fname):
        return load_params_dmlc(fname, ctx=ctx)
    with _np.load(fname, allow_pickle=False) as z:
        fmt = str(z["__mx_format__"]) if "__mx_format__" in z else "dict"
        if fmt == "list":
            n = len([k for k in z.files if k.startswith("__arr_")])
            return [NDArray(z[f"__arr_{i}"], ctx=ctx) for i in range(n)]
        return {k: NDArray(z[k], ctx=ctx) for k in z.files
                if k != "__mx_format__"}


from . import random  # noqa: E402  mx.nd.random
from . import sparse  # noqa: E402  mx.nd.sparse
from .sparse import CSRNDArray, RowSparseNDArray  # noqa: E402

for _name in _reg.list_ops():
    if _name not in globals():
        globals()[_name] = getattr(op, _name)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "arange", "empty",
           "zeros_like", "ones_like", "concatenate", "add_n", "save",
           "load", "waitall", "op", "random", "sparse", "CSRNDArray",
           "RowSparseNDArray", "dtype_name", "linspace", "eye", "moveaxis",
           "stack_arrays", "from_numpy", "from_dlpack"]
