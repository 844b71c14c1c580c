"""Operator registry and imperative dispatch of the PyTorch port.

The counterpart of ``mxnet_tpu.ops.registry``: an op is a plain function
on tensors (data inputs positional, parameters keyword-only), registered
under the reference's name and aliases; ``ndarray`` generates one
frontend per op from this registry.

:func:`invoke` unwraps the NDArray inputs, runs the function under
``torch.set_grad_enabled(autograd.is_recording())`` (so torch records
exactly what runs inside ``record()``) and wraps the outputs on the
first input's context.  The registry adds no dispatch of its own: a
kernel frontend (``_contrib_flash_selfatt``,
``_contrib_ragged_paged_attention``) calls its wrapper, whose device
rule and ``.launches`` counter hold as they are.  An input that is a
gradient buffer of a deferred backward runs that backward first
(``autograd.flush_if_pending_grad``).  Called with a Symbol first (or a
list whose first item is one), a frontend or :func:`invoke` builds a
graph node instead (``symbol.invoke_symbolic``).
"""
from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Dict, List, Sequence

import torch

from .. import runtime_metrics as _rm
from ..base import MXNetError, Registry
from . import shape_rules

__all__ = ["OpDef", "OP_REGISTRY", "register", "get_op", "list_ops",
           "invoke", "alias", "make_frontend"]

# the op table, as the JAX package's ``Registry("op")``
OP_REGISTRY = Registry("op")
_OPS: Dict[str, "OpDef"] = OP_REGISTRY._entries


class OpDef:
    """A registered operator: ``fn`` over tensors, its arity, whether
    autograd records it (``differentiable=False`` cuts the tape, as for
    integer and comparison ops), and its shape rule (``shape_rules``)."""

    __slots__ = ("name", "fn", "num_inputs", "num_outputs",
                 "differentiable", "mutates_rng", "params", "open_schema",
                 "aliases", "aux_update", "shape_rule")

    def __init__(self, name: str, fn: Callable, num_inputs, num_outputs,
                 differentiable: bool, schema: bool = False,
                 mutates_rng: bool = False):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.mutates_rng = mutates_rng
        # a stateful op's hook for graph executors: called as
        # aux_update(args, kwargs) in a training interpretation; returns
        # None (not applicable) or (outputs, {input_slot: new_value}), the
        # new values of the auxiliary states the op moves (BatchNorm's
        # moving statistics), which the executor writes in place
        self.aux_update = None
        self.aliases: List[str] = []
        self.params: Dict[str, inspect.Parameter] = {}
        self.open_schema = True
        if schema:
            sig = inspect.signature(fn)
            self.params = {k: p for k, p in sig.parameters.items()
                           if p.kind == inspect.Parameter.KEYWORD_ONLY}
            self.open_schema = any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values())
        # the declarative inference rule of this name, if it has one
        self.shape_rule = shape_rules.rule_for(name)

    def infer_signature(self, input_sigs, kwargs=None):
        """The output signature without running the op: ``input_sigs`` is
        a list of ``(shape, dtype)`` pairs (dims ints, ``shape_rules.Dim``
        symbols or None for unknown; dtype a name or None).  Returns
        ``(shape, dtype)``, possibly partly unknown, or None when the op
        has no rule; raises :class:`MXNetError` on a provably infeasible
        signature."""
        if self.shape_rule is None:
            return None
        shapes, dtypes = [], []
        for shape, dtype in input_sigs:
            if shape is None:
                shapes.append(None)
            else:
                shapes.append(tuple(
                    shape_rules.lit(d) if isinstance(d, int)
                    else d for d in shape))
            dtypes.append(dtype)
        try:
            return self.shape_rule(shapes, dtypes, dict(kwargs or ()))
        except shape_rules.ShapeError as e:
            raise MXNetError(
                f"operator {self.name}: infeasible signature: {e}") from e

    def n_outputs(self, kwargs) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(kwargs)
        return self.num_outputs

    def validate_kwargs(self, kwargs: Dict[str, Any]):
        if self.open_schema:
            return
        for k in kwargs:
            if k not in self.params:
                raise MXNetError(
                    f"operator {self.name}: unknown argument {k!r}; "
                    f"schema: {sorted(self.params)}")

    def __repr__(self):
        return f"OpDef({self.name})"


def register(name: str, num_inputs=1, num_outputs=1, differentiable=True,
             mutates_rng=False, aliases: Sequence[str] = ()):
    """Decorator: register a tensor function as an operator.
    ``mutates_rng`` marks a sampler: it draws from the default generator
    of its output's device each time it runs (a CUDA graph replays it
    with a fresh draw)."""

    def _decorator(fn):
        opdef = OpDef(name, fn, num_inputs, num_outputs, differentiable,
                      schema=True, mutates_rng=mutates_rng)
        _OPS[name] = opdef
        for a in aliases:
            opdef.aliases.append(a)
            _OPS[a] = opdef
        return fn

    return _decorator


def alias(existing: str, new: str):
    opdef = _OPS[existing]
    opdef.aliases.append(new)
    _OPS[new] = opdef


def get_op(name: str) -> OpDef:
    if name not in _OPS:
        raise MXNetError(f"no operator named {name!r}")
    return _OPS[name]


def list_ops() -> List[str]:
    return sorted(_OPS)


def _mark_leaves(tensors):
    """Recording: floating-point leaf inputs start requiring grad, so the
    tape reaches them (``autograd.grad`` with respect to an array that
    had no ``attach_grad``)."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.grad_fn is None \
                and not t.requires_grad and t.is_floating_point():
            t.requires_grad_(True)


def _symbolic(args) -> bool:
    """The first argument, or the first of a list argument, is a Symbol:
    the call builds a graph node."""
    if not args:
        return False
    first = args[0]
    if isinstance(first, (list, tuple)) and first:
        first = first[0]
    if type(first).__name__ != "Symbol":
        return False
    from ..symbol.symbol import Symbol
    return isinstance(first, Symbol)


def invoke(opdef: OpDef, inputs, kwargs: Dict[str, Any], out=None):
    """Run an op over NDArray inputs; returns NDArray(s).  Over Symbols
    it returns the graph node's Symbol (``symbol.invoke_symbolic``)."""
    if _symbolic(inputs):
        from ..symbol.symbol import invoke_symbolic
        return invoke_symbolic(opdef, inputs, kwargs)
    from ..autograd import flush_if_pending_grad, is_recording
    from ..context import context_of
    from ..ndarray import NDArray
    raw, ctx = [], None
    for a in inputs:
        if isinstance(a, NDArray):
            flush_if_pending_grad(a)
            raw.append(a._data)
            ctx = ctx or a._ctx
        else:
            raw.append(a)
    if kwargs:
        opdef.validate_kwargs(kwargs)
    record = is_recording() and opdef.differentiable
    if record:
        _mark_leaves(raw)
    # the metrics plane costs one load and a branch while it is off
    t0 = time.perf_counter() if _rm._ENABLED else None
    try:
        with torch.set_grad_enabled(record):
            result = opdef.fn(*raw, **kwargs)
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(f"operator {opdef.name} failed: {e}") from e
    if t0 is not None:
        _rm.record_op_invoke(opdef.name, time.perf_counter() - t0)
    nout = opdef.n_outputs(kwargs)
    outs_raw = (result,) if nout == 1 and not isinstance(
        result, (tuple, list)) else tuple(result)
    # an op without array inputs (a fill, a sampler) made its outputs on
    # the device its ``ctx`` argument or the current context names
    outs = [NDArray._wrap(o, ctx or context_of(o.device)) for o in outs_raw]
    if out is not None:
        out_list = [out] if isinstance(out, NDArray) else list(out)
        for dst, src in zip(out_list, outs):
            dst._set_data(src._data)
        return out
    return outs[0] if nout == 1 else outs


def make_frontend(opdef: OpDef) -> Callable:
    """The user-facing function of an op (``nd.<name>``)."""

    def frontend(*args, out=None, **kwargs):
        if opdef.num_inputs is None and args and isinstance(
                args[0], (list, tuple)):
            args = tuple(args[0]) + tuple(args[1:])
        return invoke(opdef, args, kwargs, out=out)

    frontend.__name__ = opdef.name
    frontend.__qualname__ = opdef.name
    frontend.__doc__ = inspect.getdoc(opdef.fn) or f"Operator {opdef.name}."
    return frontend
