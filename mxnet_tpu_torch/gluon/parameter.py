"""Parameter, Constant and ParameterDict of the PyTorch port (reference:
``python/mxnet/gluon/parameter.py``).

The counterpart of ``mxnet_tpu.gluon.parameter``: a parameter keeps one
NDArray per context (separate tensors, also for two CPU contexts) and
one grad buffer per context, with deferred initialisation until the
first forward knows the shape.

Weights carry across from the JAX package: ``ParameterDict.load`` reads
its npz, and :meth:`ParameterDict.load_dict` takes a dict of numpy
arrays.  Gluon prefixes count blocks per process (``dense0_``,
``dense1_``, ...), so a twin built after other blocks has other names:
the loaders match exact names first, then names with the block counters
normalised, then by order.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, cpu, current_context
from .. import autograd
from .. import initializer as init_mod
from .. import ndarray as nd
from ..ndarray import NDArray, to_torch_dtype

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter's value was asked for before its shape is known."""


def _shape_is_known(shape) -> bool:
    return shape is not None and all(s is not None and s > 0 for s in shape)


class Parameter:
    """A weight, bias or state tensor of a Block."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._stype = stype
        self._grad_stype = grad_stype
        self._data: "OrderedDict[Context, NDArray]" = OrderedDict()
        self._grad: "OrderedDict[Context, NDArray]" = OrderedDict()
        self._deferred_init = None   # (init, ctx_list, default_init)
        self._var = None

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = OrderedDict()
            for arr in self._data.values():
                arr._grad = None
                arr._grad_req = "null"
                arr._data = arr._data.detach()
        elif self._data:
            self._init_grad()

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Make the parameter's value on ``ctx`` (a list is fine); with
        an unknown shape, wait for the first forward."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if not _shape_is_known(self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, list(ctx), default_init)
                return
            raise MXNetError(
                f"cannot initialize Parameter {self.name!r}: shape "
                f"{self.shape} unknown and allow_deferred_init=False")
        self._finish_init(init, list(ctx), default_init)

    def _finish_init(self, initializer, ctx_list, default_init):
        initializer = init_mod.create(initializer or self.init
                                      or default_init)
        data = nd.zeros(self.shape, dtype=self.dtype, ctx=ctx_list[0])
        initializer(init_mod.InitDesc(self.name), data)
        self._data = OrderedDict(
            (c, data if i == 0 else data.copyto(c))
            for i, c in enumerate(ctx_list))
        self._deferred_init = None
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = OrderedDict()
        for c, arr in self._data.items():
            arr.attach_grad(self._grad_req)
            self._grad[c] = arr.grad

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not _shape_is_known(self.shape):
            raise DeferredInitializationError(
                f"Parameter {self.name!r} shape still unknown: {self.shape}")
        initializer, ctx_list, default_init = self._deferred_init
        self._finish_init(initializer, ctx_list, default_init)

    def _check_initialized(self, ctx=None):
        if self._data:
            if ctx is not None and ctx not in self._data:
                raise MXNetError(
                    f"Parameter {self.name!r} not initialized on {ctx}; "
                    f"it lives on {list(self._data)}")
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name!r} has deferred initialization "
                f"pending shape inference")
        raise MXNetError(f"Parameter {self.name!r} has not been "
                         f"initialized. Call .initialize() first")

    def data(self, ctx=None) -> NDArray:
        self._check_initialized(ctx)
        if ctx is None:
            return next(iter(self._data.values()))
        return self._data[ctx]

    def list_data(self) -> List[NDArray]:
        self._check_initialized()
        return list(self._data.values())

    def grad(self, ctx=None) -> NDArray:
        if self._grad_req == "null":
            raise MXNetError(f"Parameter {self.name!r} has grad_req='null'")
        self._check_initialized(ctx)
        autograd.flush_pending()
        if ctx is None:
            return next(iter(self._grad.values()))
        return self._grad[ctx]

    def list_grad(self) -> List[NDArray]:
        self._check_initialized()
        autograd.flush_pending()
        return list(self._grad.values())

    def list_ctx(self) -> List[Context]:
        if not self._data:
            if self._deferred_init is not None:
                return list(self._deferred_init[1])
            raise MXNetError(f"Parameter {self.name!r} not initialized")
        return list(self._data)

    def set_data(self, data):
        """Set the value on every context (a copy on each); a lazy
        forward that reads the old value runs first."""
        from .cached_op import run_lazy
        run_lazy()
        if not _shape_is_known(self.shape):
            self.shape = tuple(data.shape)
        if self._deferred_init is not None:
            self._finish_deferred_init()
        self._check_initialized()
        src = data._data.detach() if isinstance(data, NDArray) \
            else torch.from_numpy(np.array(data, copy=True))
        if tuple(src.shape) != tuple(self.shape):
            raise MXNetError(
                f"set_data: shape mismatch for {self.name}: "
                f"{tuple(src.shape)} vs {self.shape}")
        for arr in self._data.values():
            arr._set_data(src.to(device=arr._data.device,
                                 dtype=arr._data.dtype, copy=True))

    def zero_grad(self):
        autograd.flush_pending()
        with torch.no_grad():
            for g in self._grad.values():
                g._data.zero_()

    def reset_ctx(self, ctx):
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data:
            cur = self.data()
            self._data = OrderedDict((c, cur.copyto(c)) for c in ctx)
            if self._grad_req != "null":
                self._init_grad()
        elif self._deferred_init is not None:
            i, _, d = self._deferred_init
            self._deferred_init = (i, list(ctx), d)

    def cast(self, dtype):
        self.dtype = dtype
        if not self._data:
            return
        dt = to_torch_dtype(dtype)
        self._data = OrderedDict(
            (c, NDArray._wrap(a._data.detach().to(dt), c))
            for c, a in self._data.items())
        if self._grad_req != "null":
            self._init_grad()

    def var(self):
        """The parameter's Symbol variable (reference: Parameter.var)."""
        if self._var is None:
            from .. import symbol as sym_mod
            self._var = sym_mod.var(self.name, shape=self.shape,
                                    dtype=self.dtype)
        return self._var

    def _reduce(self) -> NDArray:
        return self.data()


class Constant(Parameter):
    """A non-differentiable constant parameter."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value)
        self.value = value

        class _CInit(init_mod.Initializer):
            def _init_weight(self, _name, arr):
                value.copyto(arr)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit(),
                         differentiable=False)


_COUNTER = re.compile(r"([A-Za-z_]+?)\d+_")


def _normalise(name):
    """``name`` with each block counter replaced (``dense3_weight`` and
    ``dense0_weight`` both give ``dense#_weight``)."""
    return _COUNTER.sub(r"\1#_", name)


def match_names(ours, theirs):
    """Map each name in ``ours`` to one in ``theirs``: the same name, else
    the same name with block counters normalised, else the same position
    (when both lists are as long); names that match nothing are left
    out."""
    theirs = list(theirs)
    out = {n: n for n in ours if n in theirs}
    rest = [n for n in ours if n not in out]
    if not rest:
        return out
    by_norm = {}
    for n in theirs:
        by_norm.setdefault(_normalise(n), []).append(n)
    for n in rest:
        cands = by_norm.get(_normalise(n), [])
        if len(cands) == 1:
            out[n] = cands[0]
    if len(out) < len(ours) and len(ours) == len(theirs):
        return dict(zip(ours, theirs))
    return out


class ParameterDict:
    """Ordered dict of Parameters with a shared prefix."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, name) -> Parameter:
        return self._params[name]

    def __repr__(self):
        body = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict {self._prefix!r} (\n{body}\n)"

    def get(self, name, **kwargs) -> Parameter:
        """Get or create ``prefix + name``."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        else:
            shape = kwargs.get("shape")
            if shape is not None and param.shape is not None:
                if _shape_is_known(param.shape):
                    if (_shape_is_known(shape)
                            and tuple(shape) != tuple(param.shape)):
                        raise MXNetError(
                            f"ParameterDict.get({name!r}): requested shape "
                            f"{tuple(shape)} conflicts with existing shape "
                            f"{tuple(param.shape)} of shared parameter "
                            f"{full!r}")
                else:
                    param.shape = tuple(shape)
        return param

    def get_constant(self, name, value=None) -> Constant:
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise MXNetError(f"no constant {full!r} and no value given")
            param = Constant(full, value)
            self._params[full] = param
        return param

    def _get_impl(self, full_name):
        if full_name in self._params:
            return self._params[full_name]
        if self._shared is not None and full_name in self._shared:
            self._params[full_name] = self._shared[full_name]
            return self._params[full_name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k!r}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for p in self._params.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        arrays = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arrays[name] = p._reduce()
        nd.save(filename, arrays)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load an npz written by :meth:`save` or by the JAX package."""
        loaded = nd.load(filename, ctx=cpu(0))
        self.load_dict({restore_prefix + k: v.asnumpy()
                        for k, v in loaded.items()}, ctx=ctx,
                       allow_missing=allow_missing,
                       ignore_extra=ignore_extra, source=filename)

    def load_dict(self, arrays, ctx=None, allow_missing=False,
                  ignore_extra=False, source="dict"):
        """Set the parameters from ``{name: numpy array}``, names matched
        by :func:`match_names`."""
        mapping = match_names(list(self._params), list(arrays))
        if not allow_missing:
            missing = [n for n in self._params if n not in mapping]
            if missing:
                raise MXNetError(f"Parameter {missing[0]!r} missing in "
                                 f"{source!r}")
        if not ignore_extra:
            used = set(mapping.values())
            extra = [n for n in arrays if n not in used]
            if extra:
                raise MXNetError(
                    f"Parameter {extra[0]!r} in {source!r} is not in this "
                    f"dict (use ignore_extra=True to skip)")
        for name, src in mapping.items():
            _load_one(self._params[name], np.asarray(arrays[src]), ctx)


def _load_one(p, value, ctx):
    if not _shape_is_known(p.shape):
        p.shape = tuple(value.shape)
    if not p._data and p._deferred_init is None:
        p.initialize(ctx=ctx or [current_context()])
    elif p._deferred_init is not None:
        p._finish_deferred_init()
    p.set_data(value)
