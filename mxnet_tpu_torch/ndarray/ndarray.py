"""NDArray of the PyTorch port: one ``torch.Tensor`` and its context.

The counterpart of ``mxnet_tpu.ndarray.ndarray``.  The tensor is the
value; torch runs it asynchronously on the card, so ``wait_to_read`` is
a stream synchronisation.  Arithmetic and the shape methods go through
the op registry (``ops.registry.invoke``), so they record under
``autograd.record()``.

``attach_grad`` makes the tensor a leaf that requires grad and gives
the array a ``grad`` buffer of its own; ``autograd.backward`` writes
it by the array's ``grad_req``.  A value written into an attached array
(``_set_data``, ``copyto``) stays such a leaf.

A CUDA graph reads and writes tensors by address, so an array that a
graph uses is *bound* (:meth:`NDArray._bind`): its value lives in one
tensor, its home.  Code that replaces the value (``_set_data``) is
caught at the graph's next call, which copies the new value home and
points the array at its home again.  Each such copy, each in-place
update of a home by ``Trainer``'s fused tiers and each ``__setitem__``
of a bound array is counted on the home (:func:`count_write`): a
recorded replay's backward, which reads the homes as they are, refuses
to run after one (``gluon.cached_op``).  Before a bound array is
written (``__setitem__``, ``_set_data``), a lazy forward that reads its
home, and a deferred backward over a replay that reads it, run
(``gluon.cached_op.before_write``): they see the value their call was
recorded with, as the JAX package's snapshot does.

While a backward is deferred (``autograd.backward``), reading one of
the gradient buffers it will write (``grad``, ``asnumpy``,
``wait_to_read``, or use as an op input) runs it first.

An array can be *lazy*: the output of a recorded call of a hybridized
block whose forward has not run yet (``gluon.cached_op``; the
reference's ``NDArray._deferred``).  ``shape``, ``dtype``, ``size``,
``ndim`` and ``context`` answer from the recorded shape (a tensor on
the ``meta`` device stands in for the value); every other read goes
through ``_data``, a property that runs the forward first, so no read
site can see the stand-in: ``asnumpy``, ``asscalar``, ``wait_to_read``,
use as an op input, indexing, ``copyto``, ``as_in_context``,
arithmetic.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, context_of, current_context

__all__ = ["NDArray", "to_torch_dtype", "dtype_name"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_NP_OF_TORCH = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
}


def to_torch_dtype(dtype):
    """A torch dtype from a name, a numpy dtype or a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _TORCH_DTYPES[name]


def dtype_name(dtype) -> str:
    """The reference's name of a dtype (``"float32"``, ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _host_tensor(source, dtype):
    """A CPU tensor copied from host data; 64-bit host data narrows to
    32 bits unless ``dtype`` says otherwise, as in the JAX package."""
    arr = np.array(source, copy=True)
    if dtype is None:
        dtype = {np.dtype(np.float64): torch.float32,
                 np.dtype(np.int64): torch.int32}.get(arr.dtype)
    return torch.from_numpy(arr).to(dtype) if dtype is not None \
        else torch.from_numpy(arr)


def count_write(home):
    """Count an in-place write of a bound tensor (module docstring)."""
    home._mx_writes = getattr(home, "_mx_writes", 0) + 1


def home_writes(homes):
    """The in-place writes counted on ``homes`` so far."""
    return sum(getattr(h, "_mx_writes", 0) for h in homes)


class NDArray:
    """A tensor on a context (see the module docstring)."""

    __slots__ = ("_t", "_lazy", "_ctx", "_grad", "_grad_req", "_home",
                 "__weakref__")

    __array_priority__ = 1000.0

    def __init__(self, data, ctx: Context = None, dtype=None):
        dtype = to_torch_dtype(dtype)
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _host_tensor(data, dtype)
            ctx = ctx or current_context()
        elif dtype is not None and data.dtype != dtype:
            data = data.to(dtype)
        if ctx is not None:
            dev = ctx.torch_device()
            if data.device != dev:
                data = data.to(dev)
        else:
            ctx = context_of(data.device)
        self._data = data
        self._ctx = ctx
        self._grad = None
        self._grad_req = "null"
        self._home = None

    @classmethod
    def _wrap(cls, tensor, ctx=None):
        """An array over ``tensor`` as it is, on ``ctx`` (or the
        tensor's device's context)."""
        obj = cls.__new__(cls)
        obj._t = tensor
        obj._lazy = None
        obj._ctx = ctx if ctx is not None else context_of(tensor.device)
        obj._grad = None
        obj._grad_req = "null"
        obj._home = None
        return obj

    @classmethod
    def _deferred(cls, shape, dtype, ctx, lazy):
        """A lazy array of ``shape`` and ``dtype`` on ``ctx`` whose value
        ``lazy.materialize()`` fills (module docstring)."""
        obj = cls._wrap(torch.empty(shape, dtype=dtype, device="meta"), ctx)
        obj._lazy = lazy
        return obj

    # ------------------------------------------------------------------ data
    @property
    def _data(self) -> torch.Tensor:
        """The tensor; a lazy array's forward runs first."""
        if self._lazy is not None:
            self._lazy.materialize()
        return self._t

    @_data.setter
    def _data(self, tensor):
        self._t = tensor
        self._lazy = None

    def _before_write(self):
        """A bound array is about to be written: a lazy forward or a
        deferred backward that reads its home runs first (module
        docstring)."""
        if self._home is not None:
            from ..gluon.cached_op import before_write
            before_write(self._home)

    def _lazy_materialize(self):
        """Run a lazy array's forward (a no-op for any other array)."""
        if self._lazy is not None:
            self._lazy.materialize()

    @property
    def data_torch(self) -> torch.Tensor:
        """The tensor behind the array."""
        return self._data

    def _set_data(self, new):
        """Replace the value; an attached array's tensor stays a leaf that
        requires grad."""
        if isinstance(new, NDArray):
            new = new._data
        self._before_write()
        if self._grad is not None and self._grad_req != "null":
            new = new.detach().requires_grad_(True)
            new._mx_owner = weakref.ref(self)
        self._data = new

    def _bind(self, home=None):
        """Keep the value in ``home`` (default: the array's home, else its
        current tensor, which becomes the home) and return ``(home,
        copied)``: a value that was replaced since is copied into the
        home and the array points at the home again."""
        if home is None:
            home = self._home if self._home is not None else self._data
        self._home = home
        new = self._data
        if new is home:
            return home, False
        if new.shape != home.shape or new.dtype != home.dtype \
                or new.device != home.device:
            raise MXNetError(
                f"bound array changed from {tuple(home.shape)} "
                f"{home.dtype} on {home.device} to {tuple(new.shape)} "
                f"{new.dtype} on {new.device}")
        with torch.no_grad():
            home.copy_(new)
        count_write(home)
        if home.requires_grad != new.requires_grad:
            home.requires_grad_(new.requires_grad)
        owner = getattr(new, "_mx_owner", None)
        if owner is not None:
            home._mx_owner = owner
        self._data = home
        return home, True

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        """A numpy dtype (``torch.bfloat16`` for bfloat16, which numpy
        lacks)."""
        np_dt = _NP_OF_TORCH.get(self._t.dtype)
        return np.dtype(np_dt) if np_dt is not None else self._t.dtype

    @property
    def size(self):
        return int(self._t.numel())

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def T(self):
        return self.transpose()

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        if self._grad is not None:
            from .. import autograd
            autograd.flush_pending()
        return self._grad

    # ---------------------------------------------------------------- engine
    def wait_to_read(self):
        """Block until the value is computed (reference:
        ``NDArray::WaitToRead``)."""
        from .. import autograd
        autograd.flush_if_pending_grad(self)
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    # --------------------------------------------------------------- convert
    def to_dlpack_for_read(self):
        """A DLPack capsule over the array's memory (no copy)."""
        self.wait_to_read()
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    to_dlpack_for_write = to_dlpack_for_read

    def __dlpack__(self, *args, **kwargs):
        return self._data.detach().__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def asnumpy(self) -> np.ndarray:
        from .. import autograd
        autograd.flush_if_pending_grad(self)
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        dt = to_torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return self._op("cast", dtype=dtype_name(dt))

    # ------------------------------------------------------------- placement
    def as_in_context(self, ctx: Context) -> "NDArray":
        """This array on ``ctx``: itself when it is already there, else a
        copy (two CPU contexts never share a tensor)."""
        from ..autograd import is_recording
        if ctx == self.context:
            return self
        with torch.set_grad_enabled(is_recording()):
            return NDArray._wrap(
                self._data.to(ctx.torch_device(), copy=True), ctx)

    as_in_ctx = as_in_context

    def copyto(self, other):
        """Copy into another array (writes it) or onto a context."""
        if isinstance(other, Context):
            return NDArray._wrap(
                self._data.detach().to(other.torch_device(), copy=True),
                other)
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        raise MXNetError(f"copyto: unsupported target {type(other)}")

    def copy(self) -> "NDArray":
        return NDArray._wrap(self._data.detach().clone(), self._ctx)

    def detach(self) -> "NDArray":
        return NDArray._wrap(self._data.detach(), self._ctx)

    # -------------------------------------------------------------- autograd
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make this array a variable: a leaf of the tape with a ``grad``
        buffer written by ``grad_req`` (``'write'``, ``'add'`` or
        ``'null'``).  ``stype`` is accepted and the buffer stays dense,
        as in the JAX package: a row-sparse gradient is compressed where
        it is consumed (``gluon.Trainer``)."""
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        self._grad_req = grad_req
        with torch.no_grad():
            self._grad = NDArray._wrap(torch.zeros_like(self._data),
                                       self._ctx)
        self._set_data(self._data)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def zero_grad(self):
        if self._grad is not None:
            from .. import autograd
            autograd.flush_pending()
            with torch.no_grad():
                self._grad._data.zero_()

    # ------------------------------------------------------- op dispatch
    def _op(self, name, *args, **kwargs):
        from . import op as _opmod
        return getattr(_opmod, name)(self, *args, **kwargs)

    def _binary(self, opname, scalar_opname, other, reverse=False):
        from . import op as _opmod
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return getattr(_opmod, opname)(a, b)
        if isinstance(other, (int, float, bool, np.number)):
            return getattr(_opmod, scalar_opname)(self, scalar=float(other))
        if isinstance(other, (np.ndarray, list, tuple)):
            other = NDArray(np.asarray(other), ctx=self._ctx)
            a, b = (other, self) if reverse else (self, other)
            return getattr(_opmod, opname)(a, b)
        return NotImplemented

    def __add__(self, o):
        return self._binary("broadcast_add", "_plus_scalar", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary("broadcast_sub", "_minus_scalar", o)

    def __rsub__(self, o):
        if isinstance(o, (int, float, np.number)):
            return self._op("_rminus_scalar", scalar=float(o))
        return self._binary("broadcast_sub", "_minus_scalar", o, reverse=True)

    def __mul__(self, o):
        return self._binary("broadcast_mul", "_mul_scalar", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary("broadcast_div", "_div_scalar", o)

    def __rtruediv__(self, o):
        if isinstance(o, (int, float, np.number)):
            return self._op("_rdiv_scalar", scalar=float(o))
        return self._binary("broadcast_div", "_div_scalar", o, reverse=True)

    def __mod__(self, o):
        return self._binary("broadcast_mod", "_mod_scalar", o)

    def __rmod__(self, o):
        if isinstance(o, (int, float, np.number)):
            return self._op("_rmod_scalar", scalar=float(o))
        return self._binary("broadcast_mod", "_mod_scalar", o, reverse=True)

    def __pow__(self, o):
        return self._binary("broadcast_power", "_power_scalar", o)

    def __rpow__(self, o):
        if isinstance(o, (int, float, np.number)):
            return self._op("_rpower_scalar", scalar=float(o))
        return NotImplemented

    def __neg__(self):
        return self._op("negative")

    def __abs__(self):
        return self._op("abs")

    def __matmul__(self, o):
        return self._op("dot", o)

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary("broadcast_equal", "_equal_scalar", o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary("broadcast_not_equal", "_not_equal_scalar", o)

    def __gt__(self, o):
        return self._binary("broadcast_greater", "_greater_scalar", o)

    def __ge__(self, o):
        return self._binary("broadcast_greater_equal",
                            "_greater_equal_scalar", o)

    def __lt__(self, o):
        return self._binary("broadcast_lesser", "_lesser_scalar", o)

    def __le__(self, o):
        return self._binary("broadcast_lesser_equal",
                            "_lesser_equal_scalar", o)

    def __hash__(self):
        return id(self)

    def _inplace(self, res):
        self._set_data(res._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    # -------------------------------------------------------------- indexing
    @staticmethod
    def _index(key):
        if isinstance(key, NDArray):
            t = key._data
            return t.long() if t.is_floating_point() else t
        if isinstance(key, tuple):
            return tuple(NDArray._index(k) for k in key)
        return key

    def __getitem__(self, key):
        from ..ops.registry import OpDef, invoke
        key = self._index(key)
        return invoke(OpDef("getitem", lambda x: x[key], 1, 1, True),
                      [self], {})

    def __setitem__(self, key, value):
        key = self._index(key)
        if isinstance(value, NDArray):
            value = value._data
        self._before_write()
        with torch.no_grad():
            if isinstance(key, slice) and key == slice(None) \
                    and not isinstance(value, torch.Tensor):
                self._data.fill_(value)
            else:
                self._data[key] = torch.as_tensor(
                    value, dtype=self._data.dtype, device=self._data.device)
        if self._home is not None and self._t is self._home:
            count_write(self._home)

    # ------------------------------------------------------------ repr
    def __repr__(self):
        body = np.array2string(self.asnumpy(), separator=" ", prefix="")
        return f"\n{body}\n<NDArray {'x'.join(map(str, self.shape))} " \
               f"@{self.context}>"

    # --------------------------------------------------------- method sugar
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._op("reshape", shape=shape, **kwargs)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._op("transpose", axes=axes)

    def flatten(self):
        return self._op("flatten")

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._op("squeeze", axis=axis)

    def sum(self, axis=None, keepdims=False):
        return self._op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._op("mean", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._op("prod", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op("argmin", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def abs(self):
        return self._op("abs")

    def sqrt(self):
        return self._op("sqrt")

    def square(self):
        return self._op("square")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def relu(self):
        return self._op("relu")

    def sigmoid(self):
        return self._op("sigmoid")

    def tanh(self):
        return self._op("tanh")

    def clip(self, a_min=None, a_max=None):
        return self._op("clip", a_min=a_min, a_max=a_max)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", indices, axis=axis, mode=mode)

    def one_hot(self, depth, **kw):
        return self._op("one_hot", depth=depth, **kw)

    def tile(self, reps):
        return self._op("tile", reps=reps)

    def repeat(self, repeats, axis=None):
        return self._op("repeat", repeats=repeats, axis=axis)

    def flip(self, axis):
        return self._op("flip", axis=axis)

    def swapaxes(self, dim1, dim2):
        return self._op("swapaxes", dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op("split", num_outputs=num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis)

    def broadcast_to(self, shape):
        return self._op("broadcast_to", shape=shape)

    def broadcast_like(self, other):
        return self._op("broadcast_like", other)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._op("topk", axis=axis, k=k, ret_typ=ret_typ,
                        is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return self._op("sort", axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return self._op("argsort", axis=axis, is_ascend=is_ascend)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return self._op("dot", other, transpose_a=transpose_a,
                        transpose_b=transpose_b)

    def pad(self, mode="constant", pad_width=(), constant_value=0.0):
        return self._op("pad", mode=mode, pad_width=pad_width,
                        constant_value=constant_value)

    def tostype(self, stype):
        """Convert the storage type (reference: ``NDArray.tostype``);
        ``'csr'`` and ``'row_sparse'`` live in ``ndarray/sparse.py``."""
        if stype == "default":
            return self
        from . import sparse
        return sparse.tostype(self, stype)
