"""Graph shape and dtype inference (the nnvm InferShape / InferType
passes).

The counterpart of ``mxnet_tpu.symbol.infer``:

- *forward* inference (inputs known -> output shapes) runs the op's own
  function on meta tensors, so an op's body is its shape function and
  the two cannot disagree.  An op that reads its input's values on the
  host, or whose output shape depends on them, fails there, and the
  failure names the node;
- *backward* inference (a layer's parameter shapes from its data shape
  and its arguments) is the small per-op table :data:`PARAM_INFER`, for
  the layer ops whose parameters Module and ``simple_bind`` make.
"""
from __future__ import annotations

import ast
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["PARAM_INFER", "infer_shape_graph", "infer_type_graph"]

# handler(in_shapes: List[Optional[tuple]], kwargs) fills the entries of
# in_shapes it can deduce.  Slot order = the op's positional order.
PARAM_INFER = {}


def _infer_for(*names):
    def deco(fn):
        for n in names:
            PARAM_INFER[n] = fn
        return fn
    return deco


@_infer_for("FullyConnected")
def _fc(shapes, kw):
    data = shapes[0]
    nh = int(kw.get("num_hidden", 0))
    if data is not None and nh:
        k = int(np.prod(data[1:])) if kw.get("flatten", True) and \
            len(data) > 2 else data[-1]
        if shapes[1] is None:
            shapes[1] = (nh, int(k))
        if len(shapes) > 2 and shapes[2] is None:
            shapes[2] = (nh,)


@_infer_for("Convolution")
def _conv(shapes, kw):
    data = shapes[0]
    nf = int(kw.get("num_filter", 0))
    kernel = tuple(kw.get("kernel", ()))
    groups = int(kw.get("num_group", 1))
    if data is not None and nf and kernel:
        if shapes[1] is None:
            shapes[1] = (nf, data[1] // groups) + kernel
        if len(shapes) > 2 and shapes[2] is None:
            shapes[2] = (nf,)


@_infer_for("Deconvolution")
def _deconv(shapes, kw):
    data = shapes[0]
    nf = int(kw.get("num_filter", 0))
    kernel = tuple(kw.get("kernel", ()))
    groups = int(kw.get("num_group", 1))
    if data is not None and nf and kernel:
        if shapes[1] is None:
            shapes[1] = (data[1], nf // groups) + kernel
        if len(shapes) > 2 and shapes[2] is None:
            shapes[2] = (nf,)


@_infer_for("BatchNorm", "batch_norm")
def _bn(shapes, kw):
    data = shapes[0]
    if data is not None:
        c = (data[int(kw.get("axis", 1))],)
        for i in range(1, 5):
            if shapes[i] is None:
                shapes[i] = c


@_infer_for("LayerNorm", "layer_norm")
def _ln(shapes, kw):
    data = shapes[0]
    if data is not None:
        c = (data[int(kw.get("axis", -1))],)
        for i in (1, 2):
            if shapes[i] is None:
                shapes[i] = c


@_infer_for("InstanceNorm", "GroupNorm")
def _in(shapes, kw):
    data = shapes[0]
    if data is not None:
        c = (data[1],)
        for i in (1, 2):
            if shapes[i] is None:
                shapes[i] = c


@_infer_for("Embedding")
def _embed(shapes, kw):
    if shapes[1] is None and kw.get("input_dim") and kw.get("output_dim"):
        shapes[1] = (int(kw["input_dim"]), int(kw["output_dim"]))


def _eval_op_shapes(node, ins):
    """Forward inference: the op's own function on meta tensors."""
    with torch.no_grad(), torch.device("meta"):
        out = node.op.fn(*ins, **node.kwargs)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _declared_shape(node):
    """``var(shape=)``'s shape when every dim is known."""
    text = node.attrs.get("__shape__")
    if not text:
        return None
    try:
        declared = ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return None
    if all(isinstance(s, int) and s > 0 for s in declared):
        return tuple(declared)
    return None


def infer_shape_graph(symbol, known: Dict[str, tuple], dtypes=None):
    """Run inference over the whole graph.

    Returns (var_shapes: dict name -> shape or None,
             out_shapes: list of shape or None).
    """
    from ..ndarray.ndarray import to_torch_dtype
    dtypes = dtypes or {}
    vals: Dict[int, tuple] = {}         # node -> tuple of meta tensor / None
    var_shapes: Dict[str, Optional[tuple]] = {}

    def meta(shape, name):
        dt = to_torch_dtype(dtypes.get(name, "float32"))
        return torch.empty(tuple(int(s) for s in shape), dtype=dt,
                           device="meta")

    for node in symbol._topo():
        if node.is_variable:
            shape = known.get(node.name)
            if shape is None:
                shape = _declared_shape(node)
            var_shapes[node.name] = tuple(shape) if shape is not None \
                else None
            vals[id(node)] = (meta(shape, node.name),) \
                if shape is not None else (None,)
            continue
        in_entries = [vals[id(n)][i] for n, i in node.inputs]
        in_shapes = [None if e is None else tuple(e.shape)
                     for e in in_entries]
        if any(s is None for s in in_shapes):
            handler = PARAM_INFER.get(node.op.name)
            if handler is not None:
                handler(in_shapes, node.kwargs)
                # deduced shapes go back onto unknown *variable* inputs
                for (src, _oi), old, new in zip(node.inputs, in_entries,
                                                in_shapes):
                    if old is None and new is not None and src.is_variable:
                        var_shapes[src.name] = tuple(new)
                        vals[id(src)] = (meta(new, src.name),)
        in_entries = [vals[id(n)][i] for n, i in node.inputs]
        if any(e is None for e in in_entries):
            vals[id(node)] = (None,) * node.num_outputs
            continue
        try:
            outs = _eval_op_shapes(node, in_entries)
        except Exception as e:
            raise MXNetError(
                f"infer_shape: op {node.op.name!r} (node {node.name!r}) "
                f"failed on input shapes "
                f"{[tuple(x.shape) for x in in_entries]}: {e}") from e
        vals[id(node)] = outs

    out_shapes = []
    for n, i in symbol._outputs:
        e = vals[id(n)][i]
        out_shapes.append(None if e is None else tuple(e.shape))
    return var_shapes, out_shapes


# --------------------------------------------------------------------- dtype
# the ops whose output dtype is not the inputs' promoted type
_DTYPE_RULES = {
    "Cast": lambda kw, ins: np.dtype(kw.get("dtype", "float32")),
    "cast": lambda kw, ins: np.dtype(kw.get("dtype", "float32")),
    "amp_cast": lambda kw, ins: np.dtype(kw.get("dtype", "float32")),
    "Embedding": lambda kw, ins: ins[1],      # weight dtype
    "one_hot": lambda kw, ins: np.dtype(kw.get("dtype", "float32")),
    "argmax": lambda kw, ins: np.dtype("float32"),   # reference semantics
    "argmin": lambda kw, ins: np.dtype("float32"),
    "topk": lambda kw, ins: np.dtype(kw.get("dtype", "float32")),
}


def infer_type_graph(symbol, known: Dict[str, object]):
    """Propagate dtypes forward (the FInferType pass).

    Unknown variables default to float32; op outputs follow numpy
    promotion unless :data:`_DTYPE_RULES` says otherwise.
    """
    vals: Dict[int, tuple] = {}
    var_types: Dict[str, object] = {}
    for node in symbol._topo():
        if node.is_variable:
            dt = known.get(node.name)
            if dt is None and node.attrs.get("__dtype__"):
                try:
                    dt = np.dtype(node.attrs["__dtype__"])
                except TypeError:
                    dt = None
            dt = np.dtype(dt) if dt is not None else np.dtype("float32")
            var_types[node.name] = dt
            vals[id(node)] = (dt,) * max(1, node.num_outputs)
            continue
        ins = [vals[id(n)][i] for n, i in node.inputs]
        rule = _DTYPE_RULES.get(node.op.name)
        if rule is not None:
            dt = rule(node.kwargs, ins)
        elif "dtype" in node.kwargs:
            dt = np.dtype(node.kwargs["dtype"])
        elif ins:
            dt = np.result_type(*ins)
        else:
            dt = np.dtype("float32")
        vals[id(node)] = (dt,) * node.num_outputs
    out_types = [vals[id(n)][i] for n, i in symbol._outputs]
    return var_types, out_types
