"""Symbol: the deferred computation graph (reference:
``python/mxnet/symbol/symbol.py`` over nnvm Graph / Node).

The counterpart of ``mxnet_tpu.symbol.symbol``: a light Python DAG whose
nodes name registry ops.  Executing it is interpreting the DAG over the
port's registry on tensors (:meth:`Symbol._interpret`); the executor
(``executor.py``) runs that interpretation on static buffers, inside
CUDA graphs on the card.  ``tojson`` / ``load_json`` write and read the
JAX package's JSON byte for byte: ``"op"`` is the canonical op name,
``attrs`` the JSON-encoded keyword arguments, ``user_attrs`` the
``AttrScope`` attributes, ``"mxnet_tpu_version": 1``.
"""
from __future__ import annotations

import contextlib
import json
from typing import Dict, List, Optional, Sequence

import torch

from ..base import MXNetError

__all__ = ["Symbol", "var", "Variable", "Group", "invoke_symbolic", "load",
           "load_json", "zeros", "ones"]


class _SymNode:
    """Graph node: an op application or a variable (op is None)."""

    __slots__ = ("op", "inputs", "kwargs", "name", "num_outputs", "attrs")
    _counter = [0]

    def __init__(self, op, inputs, kwargs, name=None, num_outputs=1):
        self.op = op                    # OpDef or None (variable)
        self.inputs = inputs            # list of (node, out_index)
        self.kwargs = kwargs or {}
        if name is None:
            base = op.name.lower().lstrip("_") if op else "var"
            name = f"{base}{_SymNode._counter[0]}"
            _SymNode._counter[0] += 1
        self.name = name
        self.num_outputs = num_outputs
        self.attrs: Dict[str, str] = {}

    @property
    def is_variable(self):
        return self.op is None


class Symbol:
    """One or more outputs of graph nodes (reference: mxnet Symbol)."""

    def __init__(self, outputs):
        # outputs: list of (node, out_index)
        self._outputs = list(outputs)

    # -- construction ------------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    def attr(self, key):
        return self._outputs[0][0].attrs.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0].attrs.update(
            {k: str(v) for k, v in kwargs.items()})

    # -- graph walking -----------------------------------------------------
    def _topo(self) -> List[_SymNode]:
        order, seen = [], set()
        stack = [n for n, _ in self._outputs]
        while stack:
            node = stack[-1]
            if id(node) in seen:
                stack.pop()
                continue
            unvisited = [n for n, _ in node.inputs if id(n) not in seen]
            if unvisited:
                stack.extend(unvisited)
            else:
                seen.add(id(node))
                order.append(node)
                stack.pop()
        return order

    def list_arguments(self) -> List[str]:
        """Variable names in topological order, auxiliary states apart."""
        return [n.name for n in self._topo()
                if n.is_variable and not n.attrs.get("__aux__")]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._topo()
                if n.is_variable and n.attrs.get("__aux__")]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self) -> List[str]:
        return [f"{n.name}_output{i}" if n.num_outputs > 1
                else f"{n.name}_output" for n, i in self._outputs]

    def get_internals(self) -> "Symbol":
        outs = []
        for n in self._topo():
            for i in range(n.num_outputs):
                outs.append((n, i))
        return Symbol(outs)

    # -- composition -------------------------------------------------------
    def __call__(self, **kwargs):
        """Compose: substitute variables by other symbols; returns a new
        graph."""
        mapping = {}
        for name, sym in kwargs.items():
            if not isinstance(sym, Symbol):
                raise MXNetError("compose expects Symbols")
            mapping[name] = sym._outputs[0]
        memo = {}

        def clone(node):
            if id(node) in memo:
                return memo[id(node)]
            if node.is_variable and node.name in mapping:
                new = mapping[node.name][0]
            elif node.is_variable:
                new = node
            else:
                new_inputs = [(clone(n), i) for n, i in node.inputs]
                new = _SymNode(node.op, new_inputs, node.kwargs, node.name,
                               node.num_outputs)
                new.attrs = dict(node.attrs)
            memo[id(node)] = new
            return new

        return Symbol([(clone(n), i) for n, i in self._outputs])

    # -- evaluation ----------------------------------------------------------
    def _interpret(self, feed: Dict[str, torch.Tensor], train: bool = False,
                   aux_updates: Optional[Dict[str, torch.Tensor]] = None):
        """Evaluate the graph over tensors ``feed`` (variable name ->
        tensor); returns the output tensors.

        ``train=True`` runs under ``autograd.train_mode()``, so Dropout and
        BatchNorm take their training branch.  An op records on torch's
        tape when grad mode is on and the op is differentiable, as
        ``ops.registry.invoke`` runs it.  ``aux_updates``: when given
        (and training), the new values of the auxiliary states that a
        stateful op moves (BatchNorm's moving statistics, the op's
        ``aux_update`` hook) go into it by the state variable's name; the
        caller writes them.
        """
        from .. import autograd
        scope = autograd.train_mode() if train else contextlib.nullcontext()
        grad = torch.is_grad_enabled()
        values: Dict[int, tuple] = {}
        with scope:
            for node in self._topo():
                if node.is_variable:
                    if node.name not in feed:
                        raise MXNetError(f"missing argument {node.name!r}")
                    values[id(node)] = (feed[node.name],)
                    continue
                args = [values[id(n)][i] for n, i in node.inputs]
                op = node.op
                with torch.set_grad_enabled(grad and op.differentiable):
                    if (aux_updates is not None and train
                            and op.aux_update is not None):
                        res = op.aux_update(args, node.kwargs)
                        if res is not None:
                            outs, slot_updates = res
                            for slot, val in slot_updates.items():
                                src, _ = node.inputs[slot]
                                if src.is_variable:
                                    aux_updates[src.name] = val
                            values[id(node)] = tuple(outs)
                            continue
                    try:
                        out = op.fn(*args, **node.kwargs)
                    except MXNetError:
                        raise
                    except Exception as e:
                        raise MXNetError(
                            f"operator {op.name} (node {node.name!r}) "
                            f"failed: {e}") from e
                values[id(node)] = tuple(out) \
                    if isinstance(out, (tuple, list)) else (out,)
        return [values[id(n)][i] for n, i in self._outputs]

    def infer_shape(self, **kwargs):
        """Full shape inference (the nnvm InferShape pass): parameter
        shapes are deduced backward from the data shapes and the ops'
        arguments (``symbol/infer.py``).  Raises when the graph cannot be
        resolved; ``infer_shape_partial`` leaves None holes instead."""
        arg_shapes, out_shapes, aux_shapes = self.infer_shape_partial(
            **kwargs)
        unresolved = [n for n, s in
                      zip(self.list_arguments() +
                          self.list_auxiliary_states(),
                          list(arg_shapes) + list(aux_shapes)) if s is None]
        if unresolved or any(s is None for s in out_shapes):
            raise MXNetError(
                f"infer_shape: could not resolve shapes for {unresolved}; "
                f"provide them explicitly")
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, **kwargs):
        """Best-effort inference; unknown entries are None."""
        from .infer import infer_shape_graph
        known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
        var_shapes, out_shapes = infer_shape_graph(self, known)
        args = self.list_arguments()
        aux = self.list_auxiliary_states()
        return ([var_shapes.get(n) for n in args], out_shapes,
                [var_shapes.get(n) for n in aux])

    def infer_type(self, **kwargs):
        """Dtype propagation (the nnvm InferType pass); unknown variables
        default to float32."""
        from .infer import infer_type_graph
        var_types, out_types = infer_type_graph(self, dict(kwargs))
        args = self.list_arguments()
        aux = self.list_auxiliary_states()
        return ([var_types.get(n) for n in args], out_types,
                [var_types.get(n) for n in aux])

    def eval(self, ctx=None, **kwargs):
        """Evaluate on NDArrays (no tape); returns a list of NDArrays."""
        from ..ndarray import NDArray
        feed = {k: v._data for k, v in kwargs.items()}
        with torch.no_grad():
            outs = self._interpret(feed)
        return [NDArray._wrap(o, ctx) for o in outs]

    # bind / simple_bind: the executor, imported here (a cycle otherwise)
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, **kwargs):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx, grad_req="write", type_dict=None, **shapes):
        from ..executor import Executor
        from .. import ndarray as nd
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        args = {n: nd.zeros(s, ctx=ctx) for n, s in
                zip(self.list_arguments(), arg_shapes)}
        aux = {n: nd.zeros(s, ctx=ctx) for n, s in
               zip(self.list_auxiliary_states(), aux_shapes)}
        args_grad = None
        if grad_req != "null":
            args_grad = {n: nd.zeros(s, ctx=ctx) for n, s in
                         zip(self.list_arguments(), arg_shapes)}
        return Executor(self, ctx, args, args_grad, grad_req, aux)

    # -- serialization ------------------------------------------------------
    def optimize_for(self, backend, **kwargs):
        """Apply a registered subgraph-backend pass and return the
        rewritten Symbol (reference: Symbol.optimize_for over the
        ``SubgraphProperty`` registry, ``subgraph.py``)."""
        from ..subgraph import optimize_symbol
        return optimize_symbol(self, backend, **kwargs)

    def tojson(self) -> str:
        """nnvm-style JSON, the JAX package's layout."""
        nodes = self._topo()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jn = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "attrs": {k: json.dumps(v) if not isinstance(v, str) else v
                          for k, v in n.kwargs.items()},
                "inputs": [[idx[id(src)], i, 0] for src, i in n.inputs],
            }
            if n.attrs:
                jn["user_attrs"] = dict(n.attrs)
            jnodes.append(jn)
        heads = [[idx[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- sugar --------------------------------------------------------------
    def __add__(self, other):
        return _sym_binary("broadcast_add", "_plus_scalar", self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return _sym_binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _sym_scalar("_rminus_scalar", self, other)

    def __mul__(self, other):
        return _sym_binary("broadcast_mul", "_mul_scalar", self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sym_binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _sym_scalar("_rdiv_scalar", self, other)

    def __pow__(self, other):
        return _sym_binary("broadcast_power", "_power_scalar", self, other)

    def __neg__(self):
        from ..ops.registry import get_op
        return invoke_symbolic(get_op("negative"), (self,), {})

    def __repr__(self):
        name = self.name or "grouped"
        return f"<Symbol {name}>"


def _sym_binary(opname, scalar_opname, lhs, rhs):
    from ..ops.registry import get_op
    if isinstance(rhs, Symbol):
        return invoke_symbolic(get_op(opname), (lhs, rhs), {})
    return invoke_symbolic(get_op(scalar_opname), (lhs,),
                           {"scalar": float(rhs)})


def _sym_scalar(opname, data, scalar):
    from ..ops.registry import get_op
    return invoke_symbolic(get_op(opname), (data,), {"scalar": float(scalar)})


def invoke_symbolic(opdef, args, kwargs) -> Symbol:
    """A graph node for an op call over Symbols (the symbolic half of the
    registry's frontends)."""
    kwargs = dict(kwargs)
    name = kwargs.pop("name", None)
    flat = []
    for a in args:
        if isinstance(a, (list, tuple)):
            flat.extend(a)
        else:
            flat.append(a)
    inputs = []
    for a in flat:
        if isinstance(a, Symbol):
            if len(a._outputs) != 1:
                raise MXNetError("cannot use a grouped symbol as op input")
            inputs.append(a._outputs[0])
        else:
            raise MXNetError(
                f"symbolic op {opdef.name}: all inputs must be Symbols, "
                f"got {type(a)}")
    nout = opdef.n_outputs(kwargs)
    node = _SymNode(opdef, inputs, kwargs, name, nout)
    from ..attribute import current_attrs
    scope = current_attrs()
    if scope:
        node.attrs.update(scope)
    return Symbol([(node, i) for i in range(nout)])


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs) -> Symbol:
    """A variable symbol (reference: mx.sym.var / Variable)."""
    node = _SymNode(None, [], {}, name)
    from ..attribute import current_attrs
    node.attrs.update(current_attrs())
    if attr:
        node.attrs.update({k: str(v) for k, v in attr.items()})
    if shape is not None:
        node.attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        node.attrs["__dtype__"] = str(dtype)
    return Symbol([(node, 0)])


Variable = var


def zeros(shape, dtype="float32", **kwargs):
    from ..ops.registry import get_op
    return invoke_symbolic(get_op("_zeros"),
                           (), {"shape": tuple(shape), "dtype": dtype})


def ones(shape, dtype="float32", **kwargs):
    from ..ops.registry import get_op
    return invoke_symbolic(get_op("_ones"),
                           (), {"shape": tuple(shape), "dtype": dtype})


def Group(symbols: Sequence[Symbol]) -> Symbol:
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load_json(json_str: str) -> Symbol:
    """Rebuild a Symbol from its JSON (this package's or the JAX
    package's)."""
    from ..ops.registry import get_op
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        if jn["op"] == "null":
            node = _SymNode(None, [], {}, jn["name"])
        else:
            opdef = get_op(jn["op"])
            kwargs = {}
            for k, v in jn.get("attrs", {}).items():
                try:
                    kwargs[k] = json.loads(v)
                except (json.JSONDecodeError, TypeError):
                    kwargs[k] = v
            inputs = [(nodes[i], oi) for i, oi, _ in jn["inputs"]]
            node = _SymNode(opdef, inputs, kwargs, jn["name"],
                            opdef.n_outputs(kwargs))
        if jn.get("user_attrs"):
            node.attrs.update(jn["user_attrs"])
        nodes.append(node)
    heads = [(nodes[i], oi) for i, oi, _ in data["heads"]]
    return Symbol(heads)


def load(fname) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())
