"""Subgraph backends: registered graph-rewrite passes and ``optimize_for``.

The counterpart of ``mxnet_tpu.subgraph`` (reference: the subgraph API
of ``src/operator/subgraph/``, ``SubgraphProperty`` and its frontends
``Symbol.optimize_for(backend)`` / ``HybridBlock.optimize_for``).  A
pass rewrites the port's Python ``Symbol`` DAG (``_SymNode``); the
built-in ``"inference"`` pass strips train-only ops (``Dropout``,
``identity``, ``BlockGrad``, ``stop_gradient``) for deployment.  The
rewritten graph runs as any Symbol does: interpreted over the registry,
or inside a ``SymbolBlock``'s CachedOp graphs once hybridized, with the
kernels its ops reach (B1 through ``_contrib_flash_selfatt``).
"""
from __future__ import annotations

from typing import Callable, Dict

from .base import MXNetError

__all__ = ["SubgraphProperty", "register_backend", "get_backend",
           "list_backends", "optimize_symbol", "rewrite_nodes"]

_BACKENDS: Dict[str, "SubgraphProperty"] = {}


class SubgraphProperty:
    """One graph-rewrite backend (reference: SubgraphProperty).

    Subclass and override :meth:`apply`, then register::

        @register_backend("my_backend")
        class MyProp(SubgraphProperty):
            def apply(self, sym, **kwargs):
                return rewrite_nodes(sym, my_node_fn)
    """

    name: str = ""

    def apply(self, sym, **kwargs):
        """Return the rewritten Symbol (must not mutate ``sym``)."""
        raise NotImplementedError


def register_backend(name: str):
    """Register a SubgraphProperty class or factory under ``name``."""

    def deco(cls):
        prop = cls() if isinstance(cls, type) else cls
        if not isinstance(prop, SubgraphProperty):
            raise MXNetError("register_backend expects a SubgraphProperty")
        prop.name = name
        _BACKENDS[name] = prop
        return cls

    return deco


def get_backend(name: str) -> SubgraphProperty:
    if name not in _BACKENDS:
        raise MXNetError(
            f"unknown subgraph backend {name!r} "
            f"(registered: {sorted(_BACKENDS)})")
    return _BACKENDS[name]


def list_backends():
    return sorted(_BACKENDS)


def optimize_symbol(sym, backend: str, **kwargs):
    """Apply a registered backend pass to ``sym`` (Symbol.optimize_for)."""
    return get_backend(backend).apply(sym, **kwargs)


# --------------------------------------------------------------------------
# Rewrite helper
# --------------------------------------------------------------------------

def rewrite_nodes(sym, node_fn: Callable):
    """Rebuild the DAG applying ``node_fn`` to every op node.

    ``node_fn(node, new_inputs) -> None | (node_ref, out_idx) | _SymNode``
      * ``None``: keep the node (with rewritten inputs)
      * ``(ref, idx)``: REPLACE the node's output 0 by that existing
        entry (e.g. skip an identity by returning its input entry)
      * a new ``_SymNode``: substitute it

    Only single-output replacements are supported for elision; nodes with
    ``num_outputs > 1`` are always kept (rewritten inputs only).
    """
    from .symbol.symbol import Symbol, _SymNode

    memo = {}
    for node in sym._topo():                   # producers first, iterative
        if node.is_variable:
            memo[id(node)] = {0: (node, 0)}
            continue
        new_inputs = [memo[id(n)][i] for n, i in node.inputs]
        result = node_fn(node, new_inputs) if node.num_outputs == 1 \
            else None
        if result is None:
            new = _SymNode(node.op, new_inputs, node.kwargs, node.name,
                           node.num_outputs)
            new.attrs = dict(node.attrs)
            entry_map = {i: (new, i) for i in range(node.num_outputs)}
        elif isinstance(result, tuple):
            entry_map = {0: result}
        else:
            entry_map = {i: (result, i) for i in range(result.num_outputs)}
        memo[id(node)] = entry_map

    return Symbol([memo[id(n)][i] for n, i in sym._outputs])


# --------------------------------------------------------------------------
# Built-in backends
# --------------------------------------------------------------------------

@register_backend("inference")
class _InferencePass(SubgraphProperty):
    """Strip train-only ops for deployment graphs: Dropout becomes a
    pass-through, ``identity`` / ``BlockGrad`` / ``stop_gradient``
    disappear (reference: the quantization / TensorRT properties do the
    same strip before handing subgraphs to the backend)."""

    _DROP = {"Dropout", "identity", "BlockGrad", "stop_gradient"}

    def apply(self, sym, **kwargs):
        def node_fn(node, new_inputs):
            opname = node.op.name if node.op is not None else ""
            if opname in self._DROP and len(new_inputs) == 1:
                return new_inputs[0]
            return None

        return rewrite_nodes(sym, node_fn)
