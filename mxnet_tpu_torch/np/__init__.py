"""``mx.np``: the NumPy-compatible array namespace.

The counterpart of ``mxnet_tpu.np`` (reference: ``python/mxnet/numpy/``):
NumPy-semantics functions over the port's ``NDArray``, written in torch,
with the JAX package's results: its shapes, its broadcasting, and its
dtypes, which are NumPy's with 64-bit types narrowed to 32 bits (the JAX
package runs with x64 off: a Python int becomes int32, a float float32,
a ``float64`` request float32).  Every function of the JAX package's
list that its ``jax.numpy`` provides is here under the same name, with
``random``, ``linalg`` and ``fft``.

Arrays lie on the context of their NDArray inputs, or on the current
context (``mx.gpu(0)`` unless asked otherwise) when there is none.
Under ``autograd.record()`` a call with NDArray inputs goes through the
op dispatcher (``ops.registry.invoke``) as one op, so it is recorded on
the tape like an ``mx.nd`` op; the metadata functions (``shape``,
``result_type``, ...) never are.  A failure raises ``MXNetError``.

``np.random`` draws from torch's default generator of the current
context's device (``mx.random.seed`` seeds it): the same distributions
as the JAX package's threefry draws, not the same values.
"""
from __future__ import annotations

import builtins as _builtins
import collections as _collections
import math as _math
import sys as _sys
import types as _types

import numpy as _onp
import torch as _torch

from ..base import MXNetError
from ..ndarray import NDArray

ndarray = NDArray   # mx.np.ndarray is the same runtime array type

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
bfloat16 = "bfloat16"
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None
dtype = _onp.dtype

_T = _torch.Tensor

# ---------------------------------------------------------------- dtypes
# 64-bit types narrow to 32 bits (the JAX package's x64-off results)
_NARROW = {_torch.float64: _torch.float32, _torch.int64: _torch.int32,
           _torch.complex128: _torch.complex64}
_BY_NAME = {"float16": _torch.float16, "float32": _torch.float32,
            "float64": _torch.float32, "bfloat16": _torch.bfloat16,
            "int8": _torch.int8, "int16": _torch.int16,
            "int32": _torch.int32, "int64": _torch.int32,
            "uint8": _torch.uint8, "bool": _torch.bool,
            "complex64": _torch.complex64, "complex128": _torch.complex64}


def _tdtype(dt):
    """A requested dtype (numpy, torch, name, Python type) as a torch
    dtype with 64-bit types narrowed; None stays None."""
    if dt is None:
        return None
    if isinstance(dt, _torch.dtype):
        return _NARROW.get(dt, dt)
    if dt is float:
        return _torch.float32
    if dt is int:
        return _torch.int32
    if dt is bool:
        return _torch.bool
    if dt is complex:
        return _torch.complex64
    name = str(dt) if isinstance(dt, str) else _onp.dtype(dt).name
    if name not in _BY_NAME:
        raise MXNetError(f"np: unsupported dtype {dt!r}")
    return _BY_NAME[name]


def _narrow(t):
    if isinstance(t, _T) and t.dtype in _NARROW:
        return t.to(_NARROW[t.dtype])
    return t


def _np_dtype(td):
    """A torch dtype as the numpy dtype the JAX package reports."""
    from ..ndarray.ndarray import dtype_name
    name = dtype_name(td)
    return name if name == "bfloat16" else _onp.dtype(name)


# ------------------------------------------------------- arrays in and out
def _device():
    from ..context import current_context
    return current_context().torch_device()


def _as_t(x, device=None, dtype=None):
    """An argument as a tensor: an NDArray's own, else host data made on
    ``device`` with the JAX package's default dtypes."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, _T):
        t = x
    else:
        a = _onp.asarray(x)
        if a.dtype == object:
            raise MXNetError(f"np: cannot make an array of {type(x)}")
        t = _torch.from_numpy(_onp.array(a, copy=True))
        t = _narrow(t).to(device if device is not None else _device())
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t


def _like_dev(*xs):
    for x in xs:
        if isinstance(x, _T):
            return x.device
    return _device()


def _scalar_or_t(x, like):
    """A Python number stays a number (a weak type, as in JAX); anything
    else becomes a tensor on ``like``'s device."""
    if isinstance(x, (bool, int, float, complex)) and not isinstance(
            x, _onp.generic):
        return x
    return _as_t(x, like.device if isinstance(like, _T) else _device())


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)) and _builtins.any(
            isinstance(v, NDArray) for v in x):
        return type(x)(_unwrap(v) for v in x)
    return x


_Eigh = _collections.namedtuple("EighResult", ["eigenvalues",
                                               "eigenvectors"])
_Eig = _collections.namedtuple("EigResult", ["eigenvalues", "eigenvectors"])
_QR = _collections.namedtuple("QRResult", ["Q", "R"])
_SVD = _collections.namedtuple("SVDResult", ["U", "S", "Vh"])
_Slogdet = _collections.namedtuple("SlogdetResult", ["sign", "logabsdet"])


def _rebuild_seq(typ, items):
    if hasattr(typ, "_fields"):
        return typ._make(items)
    return typ(items)


def _wrap_out(out, ctx):
    if isinstance(out, (list, tuple)):
        return _rebuild_seq(type(out), [_wrap_out(o, ctx) for o in out])
    if isinstance(out, _T):
        from ..context import context_of
        return NDArray._wrap(_narrow(out), ctx or context_of(out.device))
    return out


# metadata / introspection functions: Python values, never taped
_NO_TAPE = frozenset({
    "shape", "ndim", "size", "result_type", "promote_types", "can_cast",
    "may_share_memory", "shares_memory", "isscalar", "iscomplexobj",
    "isrealobj",
})


class _Slot:
    """An NDArray leaf's place in a call's (args, kwargs) template."""
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _invoke_recorded(fn, name, args, kwargs):
    """One np call through the op dispatcher, so that the tape records
    it as one op."""
    from ..ops.registry import OpDef, invoke

    leaves = []

    def scan(x):
        if isinstance(x, NDArray):
            leaves.append(x)
            return _Slot(len(leaves) - 1)
        if isinstance(x, (list, tuple)):
            return type(x)(scan(v) for v in x)
        return x

    t_args = tuple(scan(a) for a in args)
    t_kwargs = {k: scan(v) for k, v in kwargs.items()}
    if not leaves:
        return None
    meta = {}

    def body(*tensors):
        def fill(x):
            if isinstance(x, _Slot):
                return tensors[x.i]
            if isinstance(x, (list, tuple)):
                return type(x)(fill(v) for v in x)
            return x

        out = fn(*[fill(a) for a in t_args],
                 **{k: fill(v) for k, v in t_kwargs.items()})
        if isinstance(out, (list, tuple)):
            meta["n"], meta["type"] = len(out), type(out)
            return tuple(_narrow(o) for o in out)
        meta["n"], meta["type"] = 1, None
        return _narrow(out)

    opdef = OpDef(f"np.{name}", body, len(leaves), lambda kw: meta["n"],
                  True)
    outs = invoke(opdef, leaves, {})
    if meta["type"] is not None:
        outs = outs if isinstance(outs, list) else [outs]
        return _rebuild_seq(meta["type"], outs)
    return outs


def _context(args, kwargs):
    for x in list(args) + list(kwargs.values()):
        if isinstance(x, NDArray):
            return x.context
        if isinstance(x, (list, tuple)):
            for v in x:
                if isinstance(v, NDArray):
                    return v.context
    return None


def _make(fn, name):
    taped = name not in _NO_TAPE

    def f(*args, **kwargs):
        if taped:
            from .. import autograd
            if autograd.is_recording():
                try:
                    out = _invoke_recorded(fn, name, args, kwargs)
                except MXNetError:
                    raise
                except Exception as exc:
                    raise MXNetError(f"np.{name}: {exc}") from exc
                if out is not None:
                    return out
        ctx = _context(args, kwargs)
        try:
            out = fn(*tuple(_unwrap(a) for a in args),
                     **{k: _unwrap(v) for k, v in kwargs.items()})
        except MXNetError:
            raise
        except Exception as exc:
            raise MXNetError(f"np.{name}: {exc}") from exc
        return _wrap_out(out, ctx)

    f.__name__ = name
    f.__qualname__ = name
    f.__doc__ = (f"NumPy-semantics ``{name}`` with the JAX package's "
                 f"dtypes (see numpy's docs).  Recorded on the autograd "
                 f"tape under record().")
    return f


# ------------------------------------------------------------------ helpers
def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % ndim if ndim else a for a in axis)


def _prom(*xs):
    """The promoted dtype of tensors and Python scalars (torch's rules,
    which match the JAX package's for these types), narrowed."""
    ts = [x for x in xs if isinstance(x, _T)]
    out = ts[0].dtype if ts else _torch.float32
    for x in xs:
        out = _torch.result_type(x, _torch.empty((), dtype=out)) \
            if not isinstance(x, _T) else _torch.promote_types(out, x.dtype)
    return _NARROW.get(out, out)


def _binary(op, float_out=False):
    def impl(x1, x2, *args, **kwargs):
        a = _scalar_or_t(x1, x2 if isinstance(x2, _T) else None)
        b = _scalar_or_t(x2, a if isinstance(a, _T) else None)
        if not isinstance(a, _T) and not isinstance(b, _T):
            a = _as_t(a)
        # a Python number is weakly typed: the tensor's dtype unless the
        # number's kind is higher (int tensor + float number: float32)
        if not isinstance(a, _T):
            a = _torch.tensor(a, dtype=_prom(b, a), device=b.device)
        if not isinstance(b, _T):
            b = _torch.tensor(b, dtype=_prom(a, b), device=a.device)
        out = op(a, b)
        if float_out and not out.is_floating_point() \
                and not out.is_complex():
            out = out.to(_torch.float32)
        return out
    return impl


def _unary(op, float_out=False, int_identity=False):
    def impl(x, *args, **kwargs):
        t = _as_t(x)
        if int_identity and not (t.is_floating_point() or t.is_complex()):
            return t.clone()
        if float_out and not (t.is_floating_point() or t.is_complex()):
            t = t.to(_torch.float32)
        return op(t)
    return impl


def _floatify(t):
    if t.is_floating_point() or t.is_complex():
        return t
    return t.to(_torch.float32)


def _acc(t):
    """The accumulator of an integer / bool sum or product: int32, as the
    JAX package's."""
    if t.dtype == _torch.bool or (not t.is_floating_point()
                                  and not t.is_complex()
                                  and t.element_size() < 4):
        return t.to(_torch.int32)
    return t


def _reduce(op, float_in=False, acc=False, empty=None):
    def impl(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
        t = _as_t(a)
        if float_in:
            t = _floatify(t)
        if acc:
            t = _acc(t)
        if dtype is not None:
            t = t.to(_tdtype(dtype))
        if t.dim() == 0:
            r = op(t.reshape(1), (0,), False)
            return r.reshape(()) if not keepdims else r.reshape(())
        dims = _axes(axis, t.dim())
        r = op(t, dims, keepdims)
        return r
    return impl


def _sum(t, dims, keep):
    return _torch.sum(t, dim=dims, keepdim=keep)


def _prod(t, dims, keep):
    for d in sorted(dims, reverse=True):
        t = _torch.prod(t, dim=d, keepdim=keep)
    return t


def _mean(t, dims, keep):
    return _torch.mean(t, dim=dims, keepdim=keep)


def _amax(t, dims, keep):
    return _torch.amax(t, dim=dims, keepdim=keep)


def _amin(t, dims, keep):
    return _torch.amin(t, dim=dims, keepdim=keep)


def _var_impl(nan=False, std=False):
    def impl(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
             **kw):
        t = _floatify(_as_t(a))
        if dtype is not None:
            t = t.to(_tdtype(dtype))
        dims = _axes(axis, t.dim())
        if nan:
            m = _torch.nanmean(t, dim=dims, keepdim=True)
            d = (t - m).abs() ** 2
            n = (~_torch.isnan(t)).sum(dim=dims, keepdim=keepdims)
            s = _torch.nansum(d, dim=dims, keepdim=keepdims)
            r = s / (n - ddof).clamp(min=0)
        else:
            r = _torch.var(t, dim=dims, correction=ddof, keepdim=keepdims)
        return r.sqrt() if std else r
    return impl


def _nan_fill(fn, fill):
    def op(t, dims, keep):
        if t.is_floating_point():
            t = _torch.where(_torch.isnan(t), _torch.full_like(t, fill), t)
        return fn(t, dims, keep)
    return op


def _nanminmax(fn, fill):
    def impl(a, axis=None, out=None, keepdims=False, **kw):
        t = _as_t(a)
        dims = _axes(axis, t.dim())
        if not t.is_floating_point():
            return fn(t, dims, keepdims)
        isn = _torch.isnan(t)
        r = fn(_torch.where(isn, _torch.full_like(t, fill), t), dims,
               keepdims)
        alln = isn.all(dim=dims, keepdim=keepdims) if dims else isn
        return _torch.where(alln, _torch.full_like(r, float("nan")), r)
    return impl


def _arg(fn, nan_fill=None):
    def impl(a, axis=None, out=None, keepdims=False, **kw):
        t = _as_t(a)
        if nan_fill is not None and t.is_floating_point():
            t = _torch.where(_torch.isnan(t),
                             _torch.full_like(t, nan_fill), t)
        if t.dtype == _torch.bool:
            t = t.to(_torch.int32)
        if axis is None:
            r = fn(t.reshape(-1), 0)
            if keepdims:
                r = r.reshape((1,) * t.dim())
            return r.to(_torch.int32)
        r = fn(t, axis)
        if keepdims:
            r = r.unsqueeze(axis)
        return r.to(_torch.int32)
    return impl


# --------------------------------------------------------------- creation
def _array(object, dtype=None, copy=True, order=None, ndmin=0, **kw):
    if isinstance(object, (list, tuple)) and _builtins.any(
            isinstance(v, _T) for v in object):
        t = _torch.stack([_as_t(v) for v in object])
    else:
        t = _as_t(object)
        if isinstance(object, _T):
            t = t.clone()
    t = _narrow(t)
    if dtype is not None:
        t = t.to(_tdtype(dtype))
    while t.dim() < ndmin:
        t = t.unsqueeze(0)
    return t


def _asarray(a, dtype=None, order=None, **kw):
    t = _narrow(_as_t(a))
    return t.to(_tdtype(dtype)) if dtype is not None else t


def _shape_of(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _zeros(shape, dtype=None, **kw):
    return _torch.zeros(_shape_of(shape),
                        dtype=_tdtype(dtype) or _torch.float32,
                        device=_device())


def _ones(shape, dtype=None, **kw):
    return _torch.ones(_shape_of(shape),
                       dtype=_tdtype(dtype) or _torch.float32,
                       device=_device())


def _fill_dtype(fill_value):
    if isinstance(fill_value, _T):
        return _NARROW.get(fill_value.dtype, fill_value.dtype)
    if isinstance(fill_value, bool):
        return _torch.bool
    if isinstance(fill_value, int):
        return _torch.int32
    if isinstance(fill_value, complex):
        return _torch.complex64
    if isinstance(fill_value, float):
        return _torch.float32
    return _narrow(_as_t(fill_value)).dtype


def _full(shape, fill_value, dtype=None, **kw):
    dt = _tdtype(dtype) or _fill_dtype(fill_value)
    v = _as_t(fill_value, _device(), dt) if not isinstance(
        fill_value, (bool, int, float, complex)) else \
        _torch.tensor(fill_value, dtype=dt, device=_device())
    return v.expand(_shape_of(shape)).clone()


def _zeros_like(a, dtype=None, shape=None, **kw):
    t = _as_t(a)
    return _torch.zeros(_shape_of(shape) if shape is not None else t.shape,
                        dtype=_tdtype(dtype) or t.dtype, device=t.device)


def _ones_like(a, dtype=None, shape=None, **kw):
    t = _as_t(a)
    return _torch.ones(_shape_of(shape) if shape is not None else t.shape,
                       dtype=_tdtype(dtype) or t.dtype, device=t.device)


def _full_like(a, fill_value, dtype=None, shape=None, **kw):
    t = _as_t(a)
    dt = _tdtype(dtype) or t.dtype
    v = _torch.as_tensor(_unwrap(fill_value), device=t.device).to(dt)
    return v.expand(_shape_of(shape) if shape is not None
                    else t.shape).clone()


def _arange(start, stop=None, step=None, dtype=None, **kw):
    if stop is None:
        start, stop = 0, start
    step = 1 if step is None else step
    vals = [start, stop, step]
    dt = _tdtype(dtype)
    if dt is None:
        dt = _torch.float32 if _builtins.any(
            isinstance(v, float) or isinstance(v, _onp.floating)
            for v in vals) else _torch.int32
    if dt.is_floating_point:
        n = _builtins.max(0, int(_math.ceil((stop - start) / step)))
        return (_torch.arange(n, device=_device(), dtype=_torch.float64)
                * step + start).to(dt)
    return _torch.arange(start, stop, step, device=_device(),
                         dtype=_torch.int64).to(dt)


def _linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
              axis=0, **kw):
    s = _as_t(start, dtype=_torch.float64).to(_torch.float64)
    t = _as_t(stop, s.device, _torch.float64).to(_torch.float64)
    div = (num - 1) if endpoint else num
    step = (t - s) / div if div > 0 else _torch.zeros_like(s) * float("nan")
    i = _torch.arange(num, device=s.device, dtype=_torch.float64)
    shape = (num,) + (1,) * s.dim()
    out = s + i.reshape(shape) * step
    if endpoint and num > 1:
        out[-1] = t
    out = _torch.movedim(out, 0, axis) if s.dim() else out
    out = out.to(_tdtype(dtype) or _torch.float32)
    if retstep:
        return out, step.to(_torch.float32)
    return out


def _logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
              axis=0):
    y = _linspace(start, stop, num, endpoint, axis=axis).to(_torch.float64)
    return (base ** y).to(_tdtype(dtype) or _torch.float32)


def _eye(N, M=None, k=0, dtype=None, **kw):
    M = N if M is None else M
    i = _torch.arange(N, device=_device()).reshape(-1, 1)
    j = _torch.arange(M, device=_device()).reshape(1, -1)
    return (j - i == k).to(_tdtype(dtype) or _torch.float32)


def _identity(n, dtype=None):
    return _eye(n, dtype=dtype)


def _tri(N, M=None, k=0, dtype=None):
    M = N if M is None else M
    i = _torch.arange(N, device=_device()).reshape(-1, 1)
    j = _torch.arange(M, device=_device()).reshape(1, -1)
    return (j <= i + k).to(_tdtype(dtype) or _torch.float32)


def _tril(m, k=0):
    return _torch.tril(_as_t(m), k)


def _triu(m, k=0):
    return _torch.triu(_as_t(m), k)


def _diag(v, k=0):
    return _torch.diag(_as_t(v), k)


def _diagflat(v, k=0):
    return _torch.diagflat(_as_t(v), k)


def _meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    ts = [_as_t(x).reshape(-1) for x in xi]
    grids = list(_torch.meshgrid(*ts, indexing=indexing))
    if sparse:
        out = []
        for i, t in enumerate(ts):
            shape = [1] * len(ts)
            j = i
            if indexing == "xy" and len(ts) > 1 and i < 2:
                j = 1 - i
            shape[j] = t.numel()
            out.append(t.reshape(shape))
        return out
    return [g.clone() for g in grids]


def _indices(dimensions, dtype=None, sparse=False):
    dims = _shape_of(dimensions)
    dt = _tdtype(dtype) or _torch.int32
    rs = [_torch.arange(d, device=_device()).to(dt) for d in dims]
    if sparse:
        return tuple(r.reshape([-1 if j == i else 1
                                for j in range(len(dims))])
                     for i, r in enumerate(rs))
    if not dims:
        return _torch.zeros((0,), dtype=dt, device=_device())
    return _torch.stack(list(_torch.meshgrid(*rs, indexing="ij")))


def _fromfunction(function, shape, *, dtype=float, **kwargs):
    return function(*_indices(shape, dtype=dtype), **kwargs)


# ----------------------------------------------------------- manipulation
def _reshape(a, shape=None, order="C", *, newshape=None, **kw):
    shape = newshape if shape is None else shape
    return _as_t(a).reshape(_shape_of(shape)
                            if not isinstance(shape, int) else (shape,))


def _ravel(a, order="C"):
    return _as_t(a).reshape(-1)


def _transpose(a, axes=None):
    t = _as_t(a)
    if axes is None:
        return t.permute(*reversed(range(t.dim())))
    return t.permute(*[x % t.dim() for x in axes])


def _swapaxes(a, axis1, axis2):
    return _as_t(a).transpose(axis1, axis2)


def _moveaxis(a, source, destination):
    return _torch.movedim(_as_t(a), source, destination)


def _rollaxis(a, axis, start=0):
    t = _as_t(a)
    n = t.dim()
    axis %= n
    if start < 0:
        start += n
    if axis < start:
        start -= 1
    if axis == start:
        return t
    return _torch.movedim(t, axis, start)


def _expand_dims(a, axis):
    t = _as_t(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    out_nd = t.dim() + len(axes)
    norm = sorted(x % out_nd for x in axes)
    if len(set(norm)) != len(norm):
        raise MXNetError("expand_dims: repeated axis")
    for ax in norm:
        t = t.unsqueeze(ax)
    return t


def _squeeze(a, axis=None):
    t = _as_t(a)
    if axis is None:
        return t.reshape([s for s in t.shape if s != 1])
    axes = _axes(axis, t.dim())
    for ax in axes:
        if t.shape[ax] != 1:
            raise MXNetError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one, got "
                             f"shape={tuple(t.shape)} and "
                             f"dimensions={axes}")
    return t.reshape([s for i, s in enumerate(t.shape) if i not in axes])


def _tensors(arrays):
    ts = [_as_t(a) for a in arrays]
    dev = ts[0].device if ts else _device()
    dt = _prom(*ts) if ts else _torch.float32
    return [t.to(dev, dt) for t in ts]


def _concatenate(arrays, axis=0, dtype=None, **kw):
    ts = _tensors(arrays)
    if axis is None:
        ts = [t.reshape(-1) for t in ts]
        axis = 0
    out = _torch.cat(ts, dim=axis)
    return out.to(_tdtype(dtype)) if dtype is not None else out


def _stack(arrays, axis=0, out=None, dtype=None):
    out = _torch.stack(_tensors(arrays), dim=axis)
    return out.to(_tdtype(dtype)) if dtype is not None else out


def _vstack(tup, dtype=None):
    return _concatenate([_torch.atleast_2d(t) for t in _tensors(tup)], 0,
                        dtype)


def _hstack(tup, dtype=None):
    ts = [_torch.atleast_1d(t) for t in _tensors(tup)]
    return _concatenate(ts, 0 if ts[0].dim() == 1 else 1, dtype)


def _dstack(tup, dtype=None):
    return _concatenate([_torch.atleast_3d(t) for t in _tensors(tup)], 2,
                        dtype)


def _column_stack(tup):
    ts = [t.reshape(-1, 1) if t.dim() < 2 else t for t in _tensors(tup)]
    return _torch.cat(ts, dim=1)


def _split(ary, indices_or_sections, axis=0):
    t = _as_t(ary)
    if isinstance(indices_or_sections, int):
        if t.shape[axis] % indices_or_sections:
            raise MXNetError("array split does not result in an equal "
                             "division")
    return _array_split(t, indices_or_sections, axis)


def _array_split(ary, indices_or_sections, axis=0):
    t = _as_t(ary)
    if not isinstance(indices_or_sections, int):
        indices_or_sections = [int(i) for i in _onp.asarray(
            _unwrap(indices_or_sections).cpu() if isinstance(
                indices_or_sections, _T) else indices_or_sections)]
    return [p.clone() for p in _torch.tensor_split(t, indices_or_sections,
                                                   dim=axis)]


def _hsplit(ary, indices_or_sections):
    t = _as_t(ary)
    return _split(t, indices_or_sections, 0 if t.dim() == 1 else 1)


def _vsplit(ary, indices_or_sections):
    return _split(ary, indices_or_sections, 0)


def _dsplit(ary, indices_or_sections):
    return _split(ary, indices_or_sections, 2)


def _tile(A, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return _torch.tile(_as_t(A), reps)


def _repeat(a, repeats, axis=None, **kw):
    t = _as_t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    if not isinstance(repeats, int):
        repeats = _as_t(repeats, t.device).to(_torch.int64)
    return _torch.repeat_interleave(t, repeats, dim=axis)


def _flip(m, axis=None):
    t = _as_t(m)
    return _torch.flip(t, _axes(axis, t.dim()))


def _fliplr(m):
    return _torch.flip(_as_t(m), (1,))


def _flipud(m):
    return _torch.flip(_as_t(m), (0,))


def _roll(a, shift, axis=None):
    t = _as_t(a)
    if axis is None:
        return _torch.roll(t.reshape(-1), shift).reshape(t.shape)
    return _torch.roll(t, shift, axis)


def _rot90(m, k=1, axes=(0, 1)):
    return _torch.rot90(_as_t(m), k, list(axes))


def _broadcast_to(array, shape):
    return _as_t(array).expand(_shape_of(shape)).clone()


def _broadcast_arrays(*args):
    return [t.clone() for t in _torch.broadcast_tensors(
        *[_as_t(a) for a in args])]


def _atleast(fn):
    def impl(*arys):
        out = [fn(_as_t(a)) for a in arys]
        return out[0] if len(out) == 1 else out
    return impl


def _host_ints(x):
    if isinstance(x, _T):
        return _onp.asarray(x.cpu().numpy(), dtype=_onp.int64)
    return _onp.asarray(x, dtype=_onp.int64)


def _insert(arr, obj, values, axis=None):
    t = _as_t(arr)
    if axis is None:
        t, axis = t.reshape(-1), 0
    axis %= t.dim()
    n = t.shape[axis]
    vals = _as_t(values, t.device, t.dtype)
    idx = _host_ints(obj) if not isinstance(obj, slice) else \
        _onp.arange(n)[obj]
    if idx.ndim == 0:
        i = int(idx) + (n if idx < 0 else 0)
        while vals.dim() < t.dim():
            vals = vals.unsqueeze(0)
        vals = _torch.movedim(vals, 0, axis)
        shape = list(t.shape)
        shape[axis] = vals.shape[axis]
        vals = vals.expand(shape)
        return _torch.cat([t.narrow(axis, 0, i), vals,
                           t.narrow(axis, i, n - i)], dim=axis)
    idx = _onp.where(idx < 0, idx + n, idx)
    order = _onp.argsort(idx, kind="mergesort")
    pos = idx.copy()
    pos[order] += _onp.arange(len(idx))
    total = n + len(idx)
    keep = _onp.ones(total, bool)
    keep[pos] = False
    shape = list(t.shape)
    shape[axis] = len(idx)
    new_shape = list(t.shape)
    new_shape[axis] = total
    out = _torch.empty(new_shape, dtype=t.dtype, device=t.device)
    dev = t.device
    out.index_copy_(axis, _torch.as_tensor(_onp.nonzero(keep)[0],
                                           device=dev), t)
    out.index_copy_(axis, _torch.as_tensor(pos, device=dev),
                    _torch.broadcast_to(vals, shape).clone())
    return out


def _delete(arr, obj, axis=None):
    t = _as_t(arr)
    if axis is None:
        t, axis = t.reshape(-1), 0
    n = t.shape[axis]
    keep = _onp.ones(n, bool)
    if isinstance(obj, slice):
        keep[obj] = False
    else:
        idx = _host_ints(obj)
        keep[idx] = False
    return t.index_select(axis, _torch.as_tensor(_onp.nonzero(keep)[0],
                                                 device=t.device))


def _append(arr, values, axis=None):
    a, v = _tensors([arr, values])
    if axis is None:
        return _torch.cat([a.reshape(-1), v.reshape(-1)])
    return _torch.cat([a, v], dim=axis)


def _pad_index(n, before, after, mode, device):
    i = _torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode in ("reflect", "symmetric"):
        period = 2 * n - 2 if mode == "reflect" else 2 * n
        if period <= 0:
            return i.clamp(0, n - 1)
        j = i % period
        if mode == "reflect":
            return _torch.where(j < n, j, period - j)
        return _torch.where(j < n, j, period - 1 - j)
    raise MXNetError(f"np.pad: mode {mode!r} is not supported")


def _pad(array, pad_width, mode="constant", **kwargs):
    t = _as_t(array)
    pw = _onp.broadcast_to(_onp.asarray(_unwrap(pad_width), _onp.int64)
                           if not isinstance(pad_width, _T)
                           else pad_width.cpu().numpy(), (t.dim(), 2))
    if mode == "constant":
        cv = kwargs.get("constant_values", 0)
        cv = _onp.broadcast_to(_onp.asarray(cv, _onp.float64), (t.dim(), 2))
        out = t
        for ax in range(t.dim()):
            b, a = int(pw[ax, 0]), int(pw[ax, 1])
            shp = list(out.shape)
            parts = []
            if b:
                shp[ax] = b
                parts.append(_torch.full(shp, float(cv[ax, 0]),
                                         dtype=t.dtype, device=t.device))
            parts.append(out)
            if a:
                shp[ax] = a
                parts.append(_torch.full(shp, float(cv[ax, 1]),
                                         dtype=t.dtype, device=t.device))
            out = _torch.cat(parts, dim=ax)
        return out
    out = t
    for ax in range(t.dim()):
        idx = _pad_index(out.shape[ax], int(pw[ax, 0]), int(pw[ax, 1]),
                         mode, t.device)
        out = out.index_select(ax, idx)
    return out


def _trim_zeros(filt, trim="fb", **kw):
    t = _as_t(filt)
    nz = _torch.nonzero(t).reshape(-1).cpu().numpy()
    if nz.size == 0:
        return t[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else t.shape[0]
    return t[lo:hi]


def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, *, equal_nan=True, size=None,
            fill_value=None, **kw):
    t = _as_t(ar)
    if axis is None:
        t = t.reshape(-1)
        dim = 0
    else:
        dim = axis % t.dim()
    vals, inv, counts = _torch.unique(t, sorted=True, return_inverse=True,
                                      return_counts=True,
                                      dim=None if axis is None else dim)
    out = [vals]
    if return_index:
        n = t.shape[dim]
        pos = _torch.arange(n, device=t.device)
        first = _torch.full((vals.shape[dim],), n, dtype=pos.dtype,
                            device=t.device)
        first = first.scatter_reduce(0, inv.reshape(-1), pos, "amin")
        out.append(first.to(_torch.int32))
    if return_inverse:
        inv = inv.to(_torch.int32)
        if axis is None and _as_t(ar).dim() > 1:
            inv = inv.reshape(_as_t(ar).shape)
        out.append(inv)
    if return_counts:
        out.append(counts.to(_torch.int32))
    return out[0] if len(out) == 1 else tuple(out)


# ------------------------------------------------------------------- math
def _clip(a, a_min=None, a_max=None, out=None, *, min=None, max=None, **kw):
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    t = _as_t(a)
    lo = _as_t(lo, t.device) if isinstance(lo, (_T, list, tuple,
                                                 _onp.ndarray)) else lo
    hi = _as_t(hi, t.device) if isinstance(hi, (_T, list, tuple,
                                                 _onp.ndarray)) else hi
    if lo is not None:
        t = _torch.maximum(t, lo if isinstance(lo, _T)
                           else _torch.tensor(lo, dtype=t.dtype,
                                              device=t.device))
    if hi is not None:
        t = _torch.minimum(t, hi if isinstance(hi, _T)
                           else _torch.tensor(hi, dtype=t.dtype,
                                              device=t.device))
    return t


def _round(a, decimals=0, out=None):
    t = _as_t(a)
    if not t.is_floating_point():
        return t.clone()
    return _torch.round(t, decimals=decimals)


def _divmod(x1, x2):
    fd = _binary(lambda u, v: _torch.div(u, v, rounding_mode="floor"))(
        x1, x2)
    md = _binary(_torch.remainder)(x1, x2)
    return fd, md


def _floor_divide(x1, x2):
    return _binary(lambda u, v: _torch.div(u, v, rounding_mode="floor"))(
        x1, x2)


def _power(x1, x2):
    return _binary(_torch.pow)(x1, x2)


def _float_power(x1, x2):
    return _binary(lambda u, v: _torch.pow(
        u.to(_torch.float32) if isinstance(u, _T) else float(u),
        v.to(_torch.float32) if isinstance(v, _T) else float(v)))(x1, x2)


def _cbrt(x):
    t = _floatify(_as_t(x))
    return _torch.sign(t) * _torch.abs(t) ** (1.0 / 3.0)


def _heaviside(x1, x2):
    a = _as_t(x1)
    b = _as_t(x2, a.device)
    dt = _prom(a, b)
    return _torch.heaviside(a.to(dt), b.to(dt))


def _imag(val):
    t = _as_t(val)
    return t.imag if t.is_complex() else _torch.zeros_like(t)


def _real(val):
    t = _as_t(val)
    return t.real if t.is_complex() else t.clone()


def _angle(z, deg=False):
    t = _floatify(_as_t(z))
    r = _torch.angle(t)
    return r * (180.0 / _math.pi) if deg else r


def _frexp(x):
    t = _floatify(_as_t(x))
    m, e = _torch.frexp(t)
    return m, e.to(_torch.int32)


def _ldexp(x1, x2):
    a = _floatify(_as_t(x1))
    return a * (2.0 ** _as_t(x2, a.device).to(a.dtype))


def _interp(x, xp, fp, left=None, right=None, period=None):
    xv = _floatify(_as_t(x))
    xp_t = _floatify(_as_t(xp, xv.device))
    fp_t = _floatify(_as_t(fp, xv.device))
    i = _torch.searchsorted(xp_t, xv, right=True).clamp(1, len(xp_t) - 1)
    x0, x1 = xp_t[i - 1], xp_t[i]
    y0, y1 = fp_t[i - 1], fp_t[i]
    dx = x1 - x0
    w = _torch.where(dx == 0, _torch.zeros_like(dx), (xv - x0) / dx)
    out = y0 + w * (y1 - y0)
    lv = fp_t[0] if left is None else _torch.tensor(left,
                                                    dtype=out.dtype)
    rv = fp_t[-1] if right is None else _torch.tensor(right,
                                                      dtype=out.dtype)
    out = _torch.where(xv < xp_t[0], lv.to(out.device), out)
    out = _torch.where(xv > xp_t[-1], rv.to(out.device), out)
    return out


def _conv1d_full(a, v):
    n, m = a.numel(), v.numel()
    dt = _prom(a, v)
    if not dt.is_floating_point:
        dt_run = _torch.float64
    else:
        dt_run = dt
    x = a.to(dt_run).reshape(1, 1, -1)
    w = _torch.flip(v.to(dt_run), (0,)).reshape(1, 1, -1)
    out = _torch.nn.functional.conv1d(x, w, padding=m - 1).reshape(-1)
    return out.to(dt), n, m


def _convolve(a, v, mode="full", **kw):
    a, v = _as_t(a), _as_t(v)
    if a.numel() < v.numel():
        a, v = v, a
    full, n, m = _conv1d_full(a, v)
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    return full[m - 1:n]


def _correlate(a, v, mode="valid", **kw):
    a, v = _as_t(a), _as_t(v)
    vv = _torch.flip(v.conj() if v.is_complex() else v, (0,))
    if a.numel() < v.numel():
        out = _convolve(vv, a, mode)
        return _torch.flip(out, (0,))
    return _convolve(a, vv, mode)


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    x, y = _tensors([a, b])
    if axis is not None:
        axisa = axisb = axisc = axis
    x, y = _torch.movedim(x, axisa, -1), _torch.movedim(y, axisb, -1)
    if x.shape[-1] == 2:
        x = _torch.cat([x, _torch.zeros_like(x[..., :1])], -1)
    if y.shape[-1] == 2:
        y = _torch.cat([y, _torch.zeros_like(y[..., :1])], -1)
    x, y = _torch.broadcast_tensors(x, y)
    out = _torch.linalg.cross(x, y, dim=-1)
    if _as_t(a).shape[axisa] == 2 and _as_t(b).shape[axisb] == 2:
        return out[..., 2]
    return _torch.movedim(out, -1, axisc)


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    t = _floatify(_as_t(y))
    if x is None:
        return _torch.trapezoid(t, dx=dx, dim=axis)
    return _torch.trapezoid(t, _floatify(_as_t(x, t.device)), dim=axis)


def _ediff1d(ary, to_end=None, to_begin=None):
    t = _as_t(ary).reshape(-1)
    parts = []
    if to_begin is not None:
        parts.append(_as_t(to_begin, t.device, t.dtype).reshape(-1))
    parts.append(t[1:] - t[:-1])
    if to_end is not None:
        parts.append(_as_t(to_end, t.device, t.dtype).reshape(-1))
    return _torch.cat(parts)


def _gradient(f, *varargs, axis=None, edge_order=None):
    t = _floatify(_as_t(f))
    axes = _axes(axis, t.dim())
    spacing = [float(v) for v in varargs] if varargs else 1.0
    if isinstance(spacing, list) and len(spacing) == 1:
        spacing = spacing[0]
    out = _torch.gradient(t, spacing=spacing, dim=list(axes),
                          edge_order=edge_order or 1)
    out = list(out)
    return out[0] if len(out) == 1 else out


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    t = _as_t(a)
    pre = _as_t(prepend, t.device, t.dtype) if prepend is not None else None
    app = _as_t(append, t.device, t.dtype) if append is not None else None
    if pre is not None and pre.dim() == 0:
        shp = list(t.shape)
        shp[axis] = 1
        pre = pre.expand(shp)
    if app is not None and app.dim() == 0:
        shp = list(t.shape)
        shp[axis] = 1
        app = app.expand(shp)
    if t.dtype == _torch.bool:
        parts = [p for p in (pre, t, app) if p is not None]
        x = _torch.cat(parts, dim=axis) if len(parts) > 1 else t
        for _ in range(n):
            x = x.narrow(axis, 1, x.shape[axis] - 1) != \
                x.narrow(axis, 0, x.shape[axis] - 1)
        return x
    return _torch.diff(t, n=n, dim=axis, prepend=pre, append=app)


def _cum(fn, nan_fill=None):
    def impl(a, axis=None, dtype=None, out=None, **kw):
        t = _acc(_as_t(a))
        if nan_fill is not None and t.is_floating_point():
            t = _torch.where(_torch.isnan(t), _torch.full_like(t, nan_fill),
                             t)
        if dtype is not None:
            t = t.to(_tdtype(dtype))
        if axis is None:
            t, axis = t.reshape(-1), 0
        return fn(t, dim=axis).to(t.dtype)
    return impl


def _median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile(a, 0.5, axis=axis, keepdims=keepdims)


def _quantile(a, q, axis=None, out=None, overwrite_input=False,
              method="linear", keepdims=False, **kw):
    t = _floatify(_as_t(a))
    qt = _as_t(q, t.device, t.dtype)
    if axis is None:
        r = _torch.quantile(t.reshape(-1), qt, dim=0, keepdim=False,
                            interpolation=method)
        if keepdims:
            r = r.reshape(qt.shape + (1,) * t.dim())
        return r
    if isinstance(axis, (tuple, list)):
        axes = _axes(axis, t.dim())
        rest = [d for d in range(t.dim()) if d not in axes]
        tt = t.permute(*rest, *axes).reshape(
            [t.shape[d] for d in rest] + [-1])
        r = _torch.quantile(tt, qt, dim=-1, keepdim=False,
                            interpolation=method)
        if keepdims:
            shp = list(r.shape)
            for ax in sorted(axes):
                shp.insert(ax + (qt.dim()), 1)
            r = r.reshape(shp)
        return r
    return _torch.quantile(t, qt, dim=axis, keepdim=keepdims,
                           interpolation=method)


def _percentile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, **kw):
    qt = _as_t(q)
    return _quantile(a, _floatify(qt) / 100.0, axis=axis, method=method,
                     keepdims=keepdims)


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    t = _floatify(_as_t(a))
    dims = _axes(axis, t.dim())
    if weights is None:
        avg = _torch.mean(t, dim=dims, keepdim=keepdims)
        cnt = _torch.full_like(avg, float(t.numel() / _builtins.max(avg.numel(), 1)))
    else:
        w = _floatify(_as_t(weights, t.device))
        if w.dim() == 1 and t.dim() > 1 and axis is not None:
            shp = [1] * t.dim()
            shp[dims[0]] = -1
            w = w.reshape(shp)
        w = _torch.broadcast_to(w, t.shape)
        cnt = _torch.sum(w, dim=dims, keepdim=keepdims)
        avg = _torch.sum(t * w, dim=dims, keepdim=keepdims) / cnt
    if returned:
        return avg, cnt
    return avg


def _count_nonzero(a, axis=None, keepdims=False):
    t = _as_t(a) != 0
    return _torch.sum(t, dim=_axes(axis, t.dim()),
                      keepdim=keepdims).to(_torch.int32)


def _anyall(fn):
    def impl(a, axis=None, out=None, keepdims=False, **kw):
        t = _as_t(a).to(_torch.bool)
        if t.dim() == 0:
            return t.clone()
        r = t
        for d in sorted(_axes(axis, t.dim()), reverse=True):
            r = fn(r, dim=d, keepdim=keepdims)
        return r
    return impl


def _ptp(a, axis=None, out=None, keepdims=False):
    t = _as_t(a)
    dims = _axes(axis, t.dim())
    return _torch.amax(t, dims, keepdims) - _torch.amin(t, dims, keepdims)


# ---------------------------------------------------- sorting / searching
def _sort(a, axis=-1, kind=None, order=None, *, stable=True,
          descending=False):
    t = _as_t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    return _torch.sort(t, dim=axis, stable=True, descending=descending)[0]


def _argsort(a, axis=-1, kind=None, order=None, *, stable=True,
             descending=False):
    t = _as_t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    return _torch.sort(t, dim=axis, stable=True,
                       descending=descending)[1].to(_torch.int32)


def _partition(a, kth, axis=-1):
    t = _torch.movedim(_as_t(a), axis, -1)
    n = t.shape[-1]
    kth %= n
    low = _torch.topk(t, kth + 1, dim=-1, largest=False, sorted=True)[0]
    high = _torch.topk(t, n - kth - 1, dim=-1, largest=True,
                       sorted=True)[0]
    return _torch.movedim(_torch.cat([low, high], -1), -1, axis)


def _argpartition(a, kth, axis=-1):
    t = _torch.movedim(_as_t(a), axis, -1)
    n = t.shape[-1]
    kth %= n
    low = _torch.topk(t, kth + 1, dim=-1, largest=False, sorted=True)[1]
    # the other indices in ascending order (the JAX package's proxy)
    proxy = _torch.ones(t.shape, device=t.device).scatter(-1, low, 0.0)
    high = _torch.sort(proxy, dim=-1, descending=True,
                       stable=True)[1][..., :n - kth - 1]
    out = _torch.cat([low, high], -1).to(_torch.int32)
    return _torch.movedim(out, -1, axis)


def _searchsorted(a, v, side="left", sorter=None, **kw):
    t = _as_t(a)
    if sorter is not None:
        t = t[_as_t(sorter, t.device).to(_torch.int64)]
    vv = _as_t(v, t.device)
    dt = _prom(t, vv)
    out = _torch.searchsorted(t.to(dt), vv.to(dt).reshape(-1)
                              if vv.dim() else vv.to(dt).reshape(1),
                              right=side == "right")
    return out.reshape(vv.shape).to(_torch.int32)


def _nonzero(a, **kw):
    t = _as_t(a)
    if t.dim() == 0:
        t = t.reshape(1)
    return tuple(i.to(_torch.int32) for i in _torch.nonzero(t,
                                                            as_tuple=True))


def _flatnonzero(a, **kw):
    return _torch.nonzero(_as_t(a).reshape(-1)).reshape(-1).to(_torch.int32)


def _argwhere(a, **kw):
    t = _as_t(a)
    if t.dim() == 0:
        return _torch.nonzero(t.reshape(1))[:, :0].to(_torch.int32)
    return _torch.nonzero(t).to(_torch.int32)


def _where(condition, x=None, y=None, **kw):
    c = _as_t(condition)
    if x is None and y is None:
        return _nonzero(c)
    a = _scalar_or_t(x, c)
    b = _scalar_or_t(y, c)
    dt = _prom(a, b) if (isinstance(a, _T) or isinstance(b, _T)) else \
        _prom(_as_t(a), _as_t(b))
    a = a.to(dt) if isinstance(a, _T) else _torch.tensor(a, dtype=dt,
                                                         device=c.device)
    b = b.to(dt) if isinstance(b, _T) else _torch.tensor(b, dtype=dt,
                                                         device=c.device)
    return _torch.where(c.to(_torch.bool), a, b)


def _extract(condition, arr, **kw):
    t = _as_t(arr).reshape(-1)
    c = _as_t(condition, t.device).reshape(-1) != 0
    return t[c[:t.numel()]]


def _fill_of(dt):
    if dt.is_floating_point or dt.is_complex:
        return float("nan")
    if dt == _torch.bool:
        return True
    return _torch.iinfo(dt).min


def _take(a, indices, axis=None, out=None, mode=None, **kw):
    t = _as_t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    axis %= t.dim()
    n = t.shape[axis]
    idx = _as_t(indices, t.device).to(_torch.int64)
    if mode == "clip":
        safe, bad = idx.clamp(0, n - 1), None
    elif mode == "wrap":
        safe, bad = idx % n, None
    else:
        bad = (idx < -n) | (idx >= n)
        safe = _torch.where(idx < 0, idx + n, idx).clamp(0, _builtins.max(n - 1, 0))
    flat = t.index_select(axis, safe.reshape(-1))
    shape = list(t.shape[:axis]) + list(idx.shape) + list(t.shape[axis + 1:])
    out = flat.reshape(shape)
    if bad is not None and bool(bad.any()):
        m = bad.reshape([1] * axis + list(idx.shape)
                        + [1] * (t.dim() - axis - 1))
        out = _torch.where(m, _torch.full_like(out, _fill_of(t.dtype)), out)
    return out


def _take_along_axis(arr, indices, axis, mode=None, **kw):
    t = _as_t(arr)
    idx = _as_t(indices, t.device).to(_torch.int64)
    if axis is None:
        t, axis = t.reshape(-1), 0
        idx = idx.reshape(-1)
    n = t.shape[axis]
    idx = _torch.where(idx < 0, idx + n, idx)
    return _torch.take_along_dim(t, idx, dim=axis)


def _choose(a, choices, out=None, mode="raise"):
    idx = _as_t(a).to(_torch.int64)
    cs = _tensors(choices)
    n = len(cs)
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = idx % n
    stacked = _torch.stack(_torch.broadcast_tensors(idx, *cs)[1:])
    idx = _torch.broadcast_to(idx, stacked.shape[1:])
    return _torch.gather(stacked, 0, idx.unsqueeze(0))[0]


def _compress(condition, a, axis=None, out=None, **kw):
    t = _as_t(a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    c = _as_t(condition, t.device).reshape(-1).to(_torch.bool)
    keep = _torch.nonzero(c[:t.shape[axis]]).reshape(-1)
    return t.index_select(axis, keep)


def _select(condlist, choicelist, default=0):
    conds = [_as_t(c).to(_torch.bool) for c in condlist]
    chs = _tensors(list(choicelist))
    dt = chs[0].dtype
    out = _torch.as_tensor(_unwrap(default), device=chs[0].device).to(dt)
    for c, ch in zip(reversed(conds), reversed(chs)):
        out = _torch.where(c, ch, out)
    return out


def _digitize(x, bins, right=False, **kw):
    xv = _as_t(x)
    b = _as_t(bins, xv.device)
    dt = _prom(xv, b)
    xv, b = xv.to(dt), b.to(dt)
    if b.numel() > 1 and bool(b[-1] < b[0]):
        r = _torch.searchsorted(_torch.flip(b, (0,)), xv,
                                right=not right)
        return (b.numel() - r).to(_torch.int32)
    return _torch.searchsorted(b, xv, right=not right).to(_torch.int32)


# ------------------------------------------------------ logic / comparison
def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _tensors([a, b])
    if not (x.is_floating_point() or x.is_complex()):
        return x == y
    return _torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def _allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _isclose(a, b, rtol, atol, equal_nan).all()


def _array_equal(a1, a2, equal_nan=False):
    x, y = _as_t(a1), _as_t(a2)
    if tuple(x.shape) != tuple(y.shape):
        return _torch.tensor(False, device=x.device)
    eq = x == y.to(x.device)
    if equal_nan and x.is_floating_point():
        eq = eq | (_torch.isnan(x) & _torch.isnan(y.to(x.device)))
    return eq.all()


def _array_equiv(a1, a2):
    x, y = _as_t(a1), _as_t(a2)
    try:
        x, y = _torch.broadcast_tensors(x, y.to(x.device))
    except RuntimeError:
        return _torch.tensor(False, device=x.device)
    return (x == y).all()


def _isneginf(x, out=None):
    t = _as_t(x)
    return _torch.isneginf(t) if t.is_floating_point() \
        else _torch.zeros_like(t, dtype=_torch.bool)


def _isposinf(x, out=None):
    t = _as_t(x)
    return _torch.isposinf(t) if t.is_floating_point() \
        else _torch.zeros_like(t, dtype=_torch.bool)


# ---------------------------------------------------------- linear algebra
def _mm_dtype(*ts):
    """Integer products run in float64 (exact for these sizes) on the
    card, where torch has no integer matmul."""
    dt = _prom(*ts)
    run = _torch.float64 if not (dt.is_floating_point or dt.is_complex) \
        else dt
    return dt, run


def _dot(a, b, **kw):
    x, y = _as_t(a), _as_t(b)
    dt, run = _mm_dtype(x, y)
    x, y = x.to(y.device if x.dim() == 0 else x.device, run), y.to(
        x.device, run)
    if x.dim() == 0 or y.dim() == 0:
        return (x * y).to(dt)
    if y.dim() == 1:
        return _torch.tensordot(x, y, dims=([x.dim() - 1], [0])).to(dt)
    return _torch.tensordot(x, y, dims=([x.dim() - 1], [y.dim() - 2])).to(dt)


def _vdot(a, b, **kw):
    x, y = _as_t(a).reshape(-1), _as_t(b).reshape(-1)
    dt, run = _mm_dtype(x, y)
    x, y = x.to(run), y.to(x.device, run)
    if x.is_complex():
        x = x.conj()
    return _torch.sum(x * y).to(dt)


def _inner(a, b, **kw):
    x, y = _as_t(a), _as_t(b)
    dt, run = _mm_dtype(x, y)
    x, y = x.to(run), y.to(x.device, run)
    if x.dim() == 0 or y.dim() == 0:
        return (x * y).to(dt)
    return _torch.tensordot(x, y, dims=([-1], [-1])).to(dt)


def _outer(a, b, out=None):
    x, y = _as_t(a).reshape(-1), _as_t(b).reshape(-1)
    dt = _prom(x, y)
    return (x.to(dt).reshape(-1, 1) * y.to(x.device, dt).reshape(1, -1))


def _matmul(a, b, **kw):
    x, y = _as_t(a), _as_t(b)
    dt, run = _mm_dtype(x, y)
    return _torch.matmul(x.to(run), y.to(x.device, run)).to(dt)


def _tensordot(a, b, axes=2, **kw):
    x, y = _as_t(a), _as_t(b)
    dt, run = _mm_dtype(x, y)
    if not isinstance(axes, int):
        axes = [list(ax) if isinstance(ax, (list, tuple)) else [ax]
                for ax in axes]
    return _torch.tensordot(x.to(run), y.to(x.device, run),
                            dims=axes).to(dt)


def _einsum(subscripts, *operands, out=None, optimize=None,
            precision=None, preferred_element_type=None, **kw):
    ts = [_as_t(o) for o in operands]
    dt, run = _mm_dtype(*ts)
    return _torch.einsum(subscripts, *[t.to(ts[0].device, run)
                                       for t in ts]).to(dt)


def _kron(a, b):
    x, y = _tensors([a, b])
    return _torch.kron(x, y)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    t = _acc(_as_t(a))
    d = _torch.diagonal(t, offset=offset, dim1=axis1, dim2=axis2)
    r = d.sum(-1)
    return r.to(_tdtype(dtype)) if dtype is not None else r


# -------------------------------------------------------------- statistics
def _edges(t, bins, range_, weights=None):
    if isinstance(bins, (int, _onp.integer)):
        if range_ is None:
            lo = t.min() if t.numel() else _torch.tensor(0.0)
            hi = t.max() if t.numel() else _torch.tensor(1.0)
        else:
            lo = _torch.tensor(float(range_[0]))
            hi = _torch.tensor(float(range_[1]))
        lo, hi = lo.to(_torch.float32), hi.to(_torch.float32)
        lo, hi = _torch.where(lo == hi, lo - 0.5, lo), \
            _torch.where(lo == hi, hi + 0.5, hi)
        return _linspace(lo.to(t.device), hi.to(t.device), int(bins) + 1)
    return _floatify(_as_t(bins, t.device))


def _bin_counts(t, edges, weights):
    n = edges.numel() - 1
    idx = _torch.searchsorted(edges, t.contiguous(), right=True) - 1
    idx = _torch.where(t == edges[-1], _torch.full_like(idx, n - 1), idx)
    ok = (idx >= 0) & (idx < n)
    w = _torch.ones_like(t) if weights is None else weights
    w = _torch.where(ok, w, _torch.zeros_like(w))
    out = _torch.zeros(n, dtype=w.dtype, device=t.device)
    return out.index_add_(0, idx.clamp(0, _builtins.max(n - 1, 0)), w)


def _histogram(a, bins=10, range=None, weights=None, density=None):
    t = _floatify(_as_t(a)).reshape(-1)
    edges = _edges(t, bins, range).to(t.dtype)
    w = None if weights is None else _floatify(
        _as_t(weights, t.device)).reshape(-1)
    counts = _bin_counts(t, edges, w)
    if density:
        db = edges[1:] - edges[:-1]
        counts = counts / db / counts.sum()
    return counts, edges


def _histogram_bin_edges(a, bins=10, range=None, weights=None):
    t = _floatify(_as_t(a)).reshape(-1)
    return _edges(t, bins, range).to(t.dtype)


def _histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    xt = _floatify(_as_t(x)).reshape(-1)
    yt = _floatify(_as_t(y, xt.device)).reshape(-1)
    if isinstance(bins, (int, _onp.integer)):
        bx = by = bins
    else:
        bx, by = bins
    rx, ry = (None, None) if range is None else range
    ex = _edges(xt, bx, rx).to(xt.dtype)
    ey = _edges(yt, by, ry).to(yt.dtype)
    nx, ny = ex.numel() - 1, ey.numel() - 1
    ix = _torch.searchsorted(ex, xt, right=True) - 1
    iy = _torch.searchsorted(ey, yt, right=True) - 1
    ix = _torch.where(xt == ex[-1], _torch.full_like(ix, nx - 1), ix)
    iy = _torch.where(yt == ey[-1], _torch.full_like(iy, ny - 1), iy)
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    # counts are int32 without weights, as the JAX package's
    w = _torch.ones_like(xt, dtype=_torch.int32) if weights is None \
        else _floatify(_as_t(weights, xt.device)).reshape(-1)
    w = _torch.where(ok, w, _torch.zeros_like(w))
    flat = (ix.clamp(0, nx - 1) * ny + iy.clamp(0, ny - 1))
    h = _torch.zeros(nx * ny, dtype=w.dtype, device=xt.device)
    h = h.index_add_(0, flat, w).reshape(nx, ny)
    if density:
        area = (ex[1:] - ex[:-1]).reshape(-1, 1) * (ey[1:] - ey[:-1])
        h = h / area / h.sum().to(area.dtype)
    return h, ex, ey


def _bincount(x, weights=None, minlength=0, *, length=None):
    t = _as_t(x).reshape(-1).to(_torch.int64)
    n = length if length is not None else _builtins.max(
        int(minlength), int(t.max()) + 1 if t.numel() else 0)
    w = None if weights is None else _as_t(weights, t.device).reshape(-1)
    ok = (t >= 0) & (t < n)
    idx = t.clamp(0, _builtins.max(n - 1, 0))
    if w is None:
        src = ok.to(_torch.int32)
        out = _torch.zeros(n, dtype=_torch.int32, device=t.device)
    else:
        src = _torch.where(ok, w, _torch.zeros_like(w))
        out = _torch.zeros(n, dtype=_NARROW.get(w.dtype, w.dtype),
                           device=t.device)
        src = src.to(out.dtype)
    return out.index_add_(0, idx, src)


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None, **kw):
    t = _floatify(_as_t(m))
    if t.dim() == 1:
        t = t.reshape(1, -1)
    if not rowvar and t.dim() == 2:
        t = t.t()
    if y is not None:
        yt = _floatify(_as_t(y, t.device))
        if yt.dim() == 1:
            yt = yt.reshape(1, -1)
        if not rowvar:
            yt = yt.t()
        t = _torch.cat([t, yt], 0)
    if ddof is None:
        ddof = 0 if bias else 1
    fw = None if fweights is None else _as_t(fweights, t.device)
    aw = None if aweights is None else _floatify(_as_t(aweights, t.device))
    out = _torch.cov(t, correction=ddof, fweights=fw, aweights=aw)
    return out


def _corrcoef(x, y=None, rowvar=True, **kw):
    c = _cov(x, y, rowvar)
    if c.dim() == 0:
        return c / c
    d = _torch.sqrt(_torch.diagonal(c))
    c = c / d.reshape(-1, 1) / d.reshape(1, -1)
    return c.clamp(-1, 1)


# -------------------------------------------------------------------- sets
def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False,
                 **kw):
    a, b = _tensors([ar1, ar2])
    ua = _torch.unique(a.reshape(-1))
    ub = _torch.unique(b.reshape(-1))
    vals = ua[_torch.isin(ua, ub)]
    if not return_indices:
        return vals
    fa = a.reshape(-1)
    fb = b.reshape(-1)
    ia = _torch.stack([_torch.nonzero(fa == v)[0, 0] for v in vals]) \
        if vals.numel() else _torch.zeros(0, dtype=_torch.int64)
    ib = _torch.stack([_torch.nonzero(fb == v)[0, 0] for v in vals]) \
        if vals.numel() else _torch.zeros(0, dtype=_torch.int64)
    return vals, ia.to(_torch.int32), ib.to(_torch.int32)


def _union1d(ar1, ar2, **kw):
    a, b = _tensors([ar1, ar2])
    return _torch.unique(_torch.cat([a.reshape(-1), b.reshape(-1)]))


def _setdiff1d(ar1, ar2, assume_unique=False, **kw):
    a, b = _tensors([ar1, ar2])
    ua = _torch.unique(a.reshape(-1)) if not assume_unique \
        else a.reshape(-1)
    return ua[~_torch.isin(ua, b.reshape(-1))]


def _setxor1d(ar1, ar2, assume_unique=False, **kw):
    a, b = _tensors([ar1, ar2])
    ua, ub = _torch.unique(a.reshape(-1)), _torch.unique(b.reshape(-1))
    both = _torch.cat([ua[~_torch.isin(ua, ub)], ub[~_torch.isin(ub, ua)]])
    return _torch.sort(both)[0]


def _isin(element, test_elements, assume_unique=False, invert=False,
          **kw):
    a = _as_t(element)
    b = _as_t(test_elements, a.device)
    dt = _prom(a, b)
    return _torch.isin(a.to(dt), b.to(dt), invert=invert)


# -------------------------------------------------------------------- misc
def _np_shape(a):
    if isinstance(a, _T):
        return tuple(a.shape)
    return tuple(_onp.shape(a))


def _np_ndim(a):
    return a.dim() if isinstance(a, _T) else _onp.ndim(a)


def _np_size(a, axis=None):
    if isinstance(a, _T):
        return a.numel() if axis is None else a.shape[axis]
    return _onp.size(a, axis)


def _copy(a, order=None, **kw):
    return _as_t(a).clone()


def _dtype_arg(x):
    if isinstance(x, _T):
        return _np_dtype(_NARROW.get(x.dtype, x.dtype))
    if isinstance(x, bool):
        return _onp.dtype(bool)
    if isinstance(x, int):
        return _onp.dtype("int32")
    if isinstance(x, float):
        return _onp.dtype("float32")
    if isinstance(x, complex):
        return _onp.dtype("complex64")
    return _np_dtype(_tdtype(x))


def _result_type(*arrays_and_dtypes):
    tds = []
    for x in arrays_and_dtypes:
        if isinstance(x, _T):
            tds.append(_torch.empty((), dtype=_NARROW.get(x.dtype, x.dtype)))
        elif isinstance(x, (bool, int, float, complex)):
            tds.append(x)
        else:
            tds.append(_torch.empty((), dtype=_tdtype(x)))
    return _np_dtype(_prom(*tds)) if tds else _onp.dtype("float32")


def _promote_types(type1, type2):
    return _np_dtype(_NARROW.get(
        _torch.promote_types(_tdtype(type1), _tdtype(type2)),
        _torch.promote_types(_tdtype(type1), _tdtype(type2))))


def _can_cast(from_, to, casting="safe"):
    src = from_.dtype if isinstance(from_, _T) else _tdtype(from_)
    return _onp.can_cast(_onp.dtype(str(_np_dtype(src))),
                         _onp.dtype(str(_np_dtype(_tdtype(to)))),
                         casting=casting)


def _iscomplexobj(x):
    if isinstance(x, _T):
        return x.is_complex()
    return _onp.iscomplexobj(x)


def _isrealobj(x):
    return not _iscomplexobj(x)


def _isscalar(element):
    if isinstance(element, _T):
        return element.dim() == 0
    return _onp.isscalar(element)


def _vander(x, N=None, increasing=False):
    t = _as_t(x)
    return _torch.vander(t, N=N, increasing=increasing)


def _unravel_index(indices, shape):
    t = _as_t(indices).to(_torch.int64)
    out = []
    for d in reversed(_shape_of(shape)):
        out.append(t % d)
        t = t // d
    return tuple(o.to(_torch.int32) for o in reversed(out))


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_as_t(m).to(_torch.int64) for m in multi_index]
    out = _torch.zeros_like(idx[0])
    for i, d in zip(idx, _shape_of(dims)):
        if mode == "clip":
            i = i.clamp(0, d - 1)
        elif mode == "wrap":
            i = i % d
        out = out * d + i
    return out.to(_torch.int32)


def _tri_indices(upper):
    def impl(n, k=0, m=None):
        m = n if m is None else m
        i = _torch.arange(n, device=_device()).reshape(-1, 1)
        j = _torch.arange(m, device=_device()).reshape(1, -1)
        mask = (j - i >= k) if upper else (j - i <= k)
        r, c = _torch.nonzero(mask, as_tuple=True)
        return r.to(_torch.int32), c.to(_torch.int32)
    return impl


def _diag_indices(n, ndim=2):
    i = _torch.arange(n, device=_device(), dtype=_torch.int32)
    return tuple(i for _ in range(ndim))


_IMPLS = {
    # creation
    "array": _array, "asarray": _asarray, "zeros": _zeros, "ones": _ones,
    "full": _full, "empty": _zeros, "zeros_like": _zeros_like,
    "ones_like": _ones_like, "full_like": _full_like,
    "empty_like": _zeros_like, "arange": _arange, "linspace": _linspace,
    "logspace": _logspace, "eye": _eye, "identity": _identity, "tri": _tri,
    "tril": _tril, "triu": _triu, "diag": _diag, "diagflat": _diagflat,
    "meshgrid": _meshgrid, "indices": _indices,
    "fromfunction": _fromfunction,
    # manipulation
    "reshape": _reshape, "ravel": _ravel, "transpose": _transpose,
    "swapaxes": _swapaxes, "moveaxis": _moveaxis, "rollaxis": _rollaxis,
    "expand_dims": _expand_dims, "squeeze": _squeeze,
    "concatenate": _concatenate, "stack": _stack, "vstack": _vstack,
    "hstack": _hstack, "dstack": _dstack, "column_stack": _column_stack,
    "split": _split, "array_split": _array_split, "hsplit": _hsplit,
    "vsplit": _vsplit, "dsplit": _dsplit, "tile": _tile, "repeat": _repeat,
    "flip": _flip, "fliplr": _fliplr, "flipud": _flipud, "roll": _roll,
    "rot90": _rot90, "broadcast_to": _broadcast_to,
    "broadcast_arrays": _broadcast_arrays,
    "atleast_1d": _atleast(_torch.atleast_1d),
    "atleast_2d": _atleast(_torch.atleast_2d),
    "atleast_3d": _atleast(_torch.atleast_3d),
    "insert": _insert, "delete": _delete, "append": _append, "pad": _pad,
    "trim_zeros": _trim_zeros, "unique": _unique,
    # math
    "add": _binary(_torch.add), "subtract": _binary(_torch.sub),
    "multiply": _binary(_torch.mul),
    "divide": _binary(_torch.true_divide, True),
    "true_divide": _binary(_torch.true_divide, True),
    "floor_divide": _floor_divide, "power": _power,
    "float_power": _float_power, "mod": _binary(_torch.remainder),
    "remainder": _binary(_torch.remainder), "fmod": _binary(_torch.fmod),
    "divmod": _divmod, "negative": _unary(_torch.neg),
    "positive": _unary(lambda t: t.clone()),
    "reciprocal": _unary(_torch.reciprocal),
    "abs": _unary(_torch.abs), "absolute": _unary(_torch.abs),
    "fabs": _unary(_torch.abs, float_out=True),
    "sign": _unary(_torch.sign),
    "rint": _unary(_torch.round, int_identity=True),
    "exp": _unary(_torch.exp, True), "exp2": _unary(_torch.exp2, True),
    "expm1": _unary(_torch.expm1, True), "log": _unary(_torch.log, True),
    "log2": _unary(_torch.log2, True), "log10": _unary(_torch.log10, True),
    "log1p": _unary(_torch.log1p, True), "sqrt": _unary(_torch.sqrt, True),
    "cbrt": _cbrt, "square": _unary(_torch.square),
    "sin": _unary(_torch.sin, True), "cos": _unary(_torch.cos, True),
    "tan": _unary(_torch.tan, True), "arcsin": _unary(_torch.asin, True),
    "arccos": _unary(_torch.acos, True), "arctan": _unary(_torch.atan, True),
    "arctan2": _binary(_torch.atan2, True),
    "sinh": _unary(_torch.sinh, True), "cosh": _unary(_torch.cosh, True),
    "tanh": _unary(_torch.tanh, True), "arcsinh": _unary(_torch.asinh, True),
    "arccosh": _unary(_torch.acosh, True),
    "arctanh": _unary(_torch.atanh, True),
    "hypot": _binary(lambda a, b: _torch.hypot(
        _floatify(a) if isinstance(a, _T) else a,
        _floatify(b) if isinstance(b, _T) else b), True),
    "degrees": _unary(_torch.rad2deg, True),
    "radians": _unary(_torch.deg2rad, True),
    "deg2rad": _unary(_torch.deg2rad, True),
    "rad2deg": _unary(_torch.rad2deg, True),
    "floor": _unary(_torch.floor, int_identity=True),
    "ceil": _unary(_torch.ceil, int_identity=True),
    "trunc": _unary(_torch.trunc, int_identity=True),
    "round": _round, "around": _round, "clip": _clip,
    "maximum": _binary(_torch.maximum), "minimum": _binary(_torch.minimum),
    "fmax": _binary(_torch.fmax), "fmin": _binary(_torch.fmin),
    "nan_to_num": lambda x, copy=True, nan=0.0, posinf=None, neginf=None:
        _torch.nan_to_num(_as_t(x), nan=nan, posinf=posinf, neginf=neginf)
        if _as_t(x).is_floating_point() else _as_t(x).clone(),
    "real": _real, "imag": _imag, "conj": _unary(_torch.conj_physical),
    "conjugate": _unary(_torch.conj_physical), "angle": _angle,
    "i0": _unary(_torch.special.i0, True),
    "sinc": _unary(_torch.sinc, True), "gcd": _binary(_torch.gcd),
    "lcm": _binary(_torch.lcm), "heaviside": _heaviside,
    "copysign": _binary(lambda a, b: _torch.copysign(
        _floatify(a) if isinstance(a, _T) else float(a),
        _floatify(b) if isinstance(b, _T) else b), True),
    "frexp": _frexp, "ldexp": _ldexp, "interp": _interp,
    "convolve": _convolve, "correlate": _correlate, "cross": _cross,
    "trapezoid": _trapezoid, "ediff1d": _ediff1d, "gradient": _gradient,
    "diff": _diff, "cumsum": _cum(_torch.cumsum),
    "cumprod": _cum(_torch.cumprod),
    "nancumsum": _cum(_torch.cumsum, 0.0),
    "nancumprod": _cum(_torch.cumprod, 1.0),
    # reductions
    "sum": _reduce(_sum, acc=True), "prod": _reduce(_prod, acc=True),
    "mean": _reduce(_mean, float_in=True), "std": _var_impl(std=True),
    "var": _var_impl(), "min": _reduce(_amin), "max": _reduce(_amax),
    "amin": _reduce(_amin), "amax": _reduce(_amax),
    "nansum": _reduce(_nan_fill(_sum, 0.0), acc=True),
    "nanprod": _reduce(_nan_fill(_prod, 1.0), acc=True),
    "nanmean": _reduce(lambda t, d, k: _torch.nanmean(t, dim=d, keepdim=k),
                       float_in=True),
    "nanstd": _var_impl(nan=True, std=True), "nanvar": _var_impl(nan=True),
    "nanmin": _nanminmax(_amin, float("inf")),
    "nanmax": _nanminmax(_amax, float("-inf")),
    "argmin": _arg(_torch.argmin), "argmax": _arg(_torch.argmax),
    "nanargmin": _arg(_torch.argmin, float("inf")),
    "nanargmax": _arg(_torch.argmax, float("-inf")),
    "ptp": _ptp, "median": _median, "average": _average,
    "percentile": _percentile, "quantile": _quantile,
    "count_nonzero": _count_nonzero, "any": _anyall(_torch.any),
    "all": _anyall(_torch.all),
    # sorting / searching
    "sort": _sort, "argsort": _argsort, "partition": _partition,
    "argpartition": _argpartition, "searchsorted": _searchsorted,
    "nonzero": _nonzero, "flatnonzero": _flatnonzero,
    "argwhere": _argwhere, "where": _where, "extract": _extract,
    "take": _take, "take_along_axis": _take_along_axis, "choose": _choose,
    "compress": _compress, "select": _select, "digitize": _digitize,
    # logic / comparison
    "equal": _binary(_torch.eq), "not_equal": _binary(_torch.ne),
    "greater": _binary(_torch.gt), "greater_equal": _binary(_torch.ge),
    "less": _binary(_torch.lt), "less_equal": _binary(_torch.le),
    "logical_and": _binary(_torch.logical_and),
    "logical_or": _binary(_torch.logical_or),
    "logical_xor": _binary(_torch.logical_xor),
    "logical_not": _unary(_torch.logical_not),
    "isfinite": _unary(_torch.isfinite), "isinf": _unary(_torch.isinf),
    "isnan": _unary(_torch.isnan), "isneginf": _isneginf,
    "isposinf": _isposinf, "isclose": _isclose, "allclose": _allclose,
    "array_equal": _array_equal, "array_equiv": _array_equiv,
    "signbit": _unary(_torch.signbit),
    # linear algebra
    "dot": _dot, "vdot": _vdot, "inner": _inner, "outer": _outer,
    "matmul": _matmul, "tensordot": _tensordot, "einsum": _einsum,
    "kron": _kron, "trace": _trace,
    # bit ops
    "bitwise_and": _binary(_torch.bitwise_and),
    "bitwise_or": _binary(_torch.bitwise_or),
    "bitwise_xor": _binary(_torch.bitwise_xor),
    "invert": _unary(_torch.bitwise_not),
    "left_shift": _binary(_torch.bitwise_left_shift),
    "right_shift": _binary(_torch.bitwise_right_shift),
    # statistics
    "histogram": _histogram, "histogram2d": _histogram2d,
    "histogram_bin_edges": _histogram_bin_edges, "bincount": _bincount,
    "cov": _cov, "corrcoef": _corrcoef,
    # sets
    "intersect1d": _intersect1d, "union1d": _union1d,
    "setdiff1d": _setdiff1d, "setxor1d": _setxor1d, "isin": _isin,
    # misc
    "shape": _np_shape, "ndim": _np_ndim, "size": _np_size, "copy": _copy,
    "result_type": _result_type, "promote_types": _promote_types,
    "can_cast": _can_cast, "iscomplexobj": _iscomplexobj,
    "isrealobj": _isrealobj, "isscalar": _isscalar, "vander": _vander,
    "unravel_index": _unravel_index,
    "ravel_multi_index": _ravel_multi_index,
    "tril_indices": _tri_indices(False), "triu_indices": _tri_indices(True),
    "diag_indices": _diag_indices,
}

_g = globals()
for _name, _fn in _IMPLS.items():
    _g[_name] = _make(_fn, _name)


# ---------------------------------------------------------------------------
# np.random / np.linalg / np.fft submodules
# ---------------------------------------------------------------------------
def _norm_size(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


def _make_random():
    mod = _types.ModuleType(__name__ + ".random")
    mod.__doc__ = ("NumPy-style sampling from torch's default generator of "
                   "the current context's device (mx.random.seed seeds "
                   "it; reference: mxnet/numpy/random.py)")

    def _wrap(t):
        return _wrap_out(t, None)

    def _f(dtype):
        return _tdtype(dtype) or _torch.float32

    def uniform(low=0.0, high=1.0, size=None, dtype=None):
        t = _torch.empty(_norm_size(size), dtype=_f(dtype),
                         device=_device())
        return _wrap(t.uniform_(float(low), float(high)))

    def normal(loc=0.0, scale=1.0, size=None, dtype=None):
        t = _torch.empty(_norm_size(size), dtype=_f(dtype),
                         device=_device())
        return _wrap(t.normal_() * scale + loc)

    def randn(*shape):
        return normal(size=shape or ())

    def rand(*shape):
        return uniform(size=shape or ())

    def randint(low, high=None, size=None, dtype="int32"):
        if high is None:
            low, high = 0, low
        t = _torch.randint(int(low), int(high), _norm_size(size),
                           device=_device(), dtype=_torch.int64)
        return _wrap(t.to(_tdtype(dtype)))

    def choice(a, size=None, replace=True, p=None):
        shape = _norm_size(size)
        a_t = _torch.arange(a, device=_device(), dtype=_torch.int32) \
            if isinstance(a, int) else _as_t(_unwrap(a))
        n = a_t.shape[0]
        k = int(_onp.prod(shape)) if shape else 1
        if p is None and replace:
            idx = _torch.randint(0, n, (k,), device=a_t.device)
        else:
            w = _torch.ones(n, device=a_t.device) if p is None \
                else _floatify(_as_t(_unwrap(p), a_t.device))
            idx = _torch.multinomial(w, k, replacement=replace)
        return _wrap(a_t[idx].reshape(shape + tuple(a_t.shape[1:])))

    def permutation(x):
        if isinstance(x, int):
            return _wrap(_torch.randperm(x, device=_device()).to(
                _torch.int32))
        t = _as_t(_unwrap(x))
        return _wrap(t[_torch.randperm(t.shape[0], device=t.device)])

    def shuffle(x):
        if not isinstance(x, NDArray):
            raise MXNetError("np.random.shuffle expects an ndarray")
        t = x._data
        x._set_data(t[_torch.randperm(t.shape[0], device=t.device)])

    def seed(s):
        from .. import random as _mxrand
        _mxrand.seed(s)

    def exponential(scale=1.0, size=None):
        t = _torch.empty(_norm_size(size), device=_device())
        return _wrap(t.exponential_() * scale)

    def gamma(shape_param, scale=1.0, size=None):
        shp = _norm_size(size)
        conc = _torch.full(shp, float(shape_param), device=_device())
        return _wrap(_torch._standard_gamma(conc) * scale)

    def beta(a, b, size=None):
        shp = _norm_size(size)
        ga = _torch._standard_gamma(_torch.full(shp, float(a),
                                                device=_device()))
        gb = _torch._standard_gamma(_torch.full(shp, float(b),
                                                device=_device()))
        return _wrap(ga / (ga + gb))

    def binomial(n, p, size=None):
        shp = _norm_size(size)
        cnt = _torch.full(shp, float(n), device=_device())
        prob = _torch.full(shp, float(p), device=_device())
        return _wrap(_torch.binomial(cnt, prob))

    def multinomial(n, pvals, size=None):
        pv = _floatify(_as_t(_unwrap(pvals)))
        shp = _norm_size(size)
        rows = int(_onp.prod(shp)) if shp else 1
        draws = _torch.multinomial(pv.expand(rows, -1), n, replacement=True)
        counts = _torch.zeros(rows, pv.numel(), dtype=_torch.int32,
                              device=pv.device)
        counts.scatter_add_(1, draws, _torch.ones_like(draws,
                                                       dtype=_torch.int32))
        return _wrap(counts.reshape(shp + (pv.numel(),)))

    for fn in (uniform, normal, randn, rand, randint, choice, permutation,
               shuffle, seed, exponential, gamma, beta, binomial,
               multinomial):
        fn.__module__ = mod.__name__
        setattr(mod, fn.__name__, fn)
    return mod


def _lstsq(a, b, rcond=None, **kw):
    x, y = _floatify(_as_t(a)), _floatify(_as_t(b))
    sol = _torch.linalg.lstsq(x.cpu() if x.is_cuda else x,
                              y.cpu() if y.is_cuda else y,
                              driver="gelsd").solution.to(x.device)
    res = y - x @ sol
    resid = (res.abs() ** 2).sum(0) if x.shape[0] > x.shape[1] else \
        _torch.zeros((0,), device=x.device)
    rank = _torch.linalg.matrix_rank(x).to(_torch.int32)
    sv = _torch.linalg.svdvals(x)
    return sol, resid, rank, sv


def _linalg_norm(x, ord=None, axis=None, keepdims=False):
    t = _floatify(_as_t(x))
    if axis is None and ord is None:
        return _torch.linalg.vector_norm(t.reshape(-1), keepdim=False) \
            if not keepdims else _torch.linalg.vector_norm(
                t, dim=tuple(range(t.dim())), keepdim=True)
    if isinstance(axis, int) or (axis is None and t.dim() == 1):
        return _torch.linalg.vector_norm(
            t, ord=2 if ord is None else ord,
            dim=axis if axis is not None else 0, keepdim=keepdims)
    dims = tuple(axis) if axis is not None else (-2, -1)
    return _torch.linalg.matrix_norm(t, ord="fro" if ord is None else ord,
                                     dim=dims, keepdim=keepdims)


_LINALG = {
    "norm": _linalg_norm,
    "inv": lambda a: _torch.linalg.inv(_floatify(_as_t(a))),
    "pinv": lambda a, rcond=None, hermitian=False, **kw:
        _torch.linalg.pinv(_floatify(_as_t(a)), hermitian=hermitian),
    "det": lambda a: _torch.linalg.det(_floatify(_as_t(a))),
    "slogdet": lambda a, **kw: _Slogdet(*_torch.linalg.slogdet(
        _floatify(_as_t(a)))),
    "cholesky": lambda a, **kw: _torch.linalg.cholesky(_floatify(_as_t(a))),
    "qr": lambda a, mode="reduced": (
        _torch.linalg.qr(_floatify(_as_t(a)), mode="r").R
        if mode == "r" else _QR(*_torch.linalg.qr(_floatify(_as_t(a)),
                                                  mode=mode))),
    "svd": lambda a, full_matrices=True, compute_uv=True, **kw: (
        _SVD(*_torch.linalg.svd(_floatify(_as_t(a)),
                                full_matrices=full_matrices))
        if compute_uv else _torch.linalg.svdvals(_floatify(_as_t(a)))),
    "eig": lambda a: _Eig(*_torch.linalg.eig(_floatify(_as_t(a)))),
    "eigh": lambda a, UPLO=None, **kw: _Eigh(*_torch.linalg.eigh(
        _floatify(_as_t(a)), UPLO=UPLO or "L")),
    "eigvals": lambda a: _torch.linalg.eigvals(_floatify(_as_t(a))),
    "eigvalsh": lambda a, UPLO="L": _torch.linalg.eigvalsh(
        _floatify(_as_t(a)), UPLO=UPLO),
    "solve": lambda a, b: _torch.linalg.solve(
        _floatify(_as_t(a)), _floatify(_as_t(b))),
    "lstsq": _lstsq,
    "matrix_rank": lambda M, rtol=None, **kw: _torch.linalg.matrix_rank(
        _floatify(_as_t(M)), rtol=rtol).to(_torch.int32),
    "matrix_power": lambda a, n: _torch.linalg.matrix_power(_as_t(a), n),
    "tensorsolve": lambda a, b, axes=None: _torch.linalg.tensorsolve(
        _floatify(_as_t(a)), _floatify(_as_t(b)), dims=axes),
    "tensorinv": lambda a, ind=2: _torch.linalg.tensorinv(
        _floatify(_as_t(a)), ind=ind),
    "multi_dot": lambda arrays, **kw: _torch.linalg.multi_dot(
        _tensors(arrays)),
}


def _fft_fn(name):
    fn = getattr(_torch.fft, name)

    def impl(a, *args, **kwargs):
        if "axis" in kwargs:
            kwargs["dim"] = kwargs.pop("axis")
        if "axes" in kwargs:
            kwargs["dim"] = kwargs.pop("axes")
        t = _as_t(a)
        if name not in ("fftshift", "ifftshift"):
            t = _floatify(t)
        return fn(t, *args, **kwargs)
    return impl


def _fftfreq(name):
    fn = getattr(_torch.fft, name)

    def impl(n, d=1.0, **kw):
        return fn(n, d=d, device=_device())
    return impl


def _submodule(sub, impls, doc):
    mod = _types.ModuleType(__name__ + "." + sub)
    mod.__doc__ = doc
    for name, fn in impls.items():
        f = _make(fn, f"{sub}.{name}")
        f.__name__ = name
        f.__module__ = mod.__name__
        setattr(mod, name, f)
    return mod


random = _make_random()
linalg = _submodule("linalg", _LINALG,
                    "numpy.linalg semantics over torch.linalg.")
fft = _submodule("fft", dict(
    {n: _fft_fn(n) for n in ("fft", "ifft", "fft2", "ifft2", "fftn",
                             "ifftn", "rfft", "irfft", "rfft2", "irfft2",
                             "rfftn", "irfftn", "fftshift", "ifftshift")},
    fftfreq=_fftfreq("fftfreq"), rfftfreq=_fftfreq("rfftfreq")),
    "numpy.fft semantics over torch.fft.")
_sys.modules[random.__name__] = random
_sys.modules[linalg.__name__] = linalg
_sys.modules[fft.__name__] = fft
