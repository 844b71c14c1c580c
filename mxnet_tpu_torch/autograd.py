"""Autograd of the PyTorch port: ``record`` / ``pause`` scopes,
``backward``, ``grad`` (with ``create_graph``), ``mark_variables`` and
custom ``Function``.

The counterpart of ``mxnet_tpu.autograd``.  torch's autograd is the
tape: an op runs under ``torch.set_grad_enabled(is_recording())``, so
only what runs inside ``record()`` is recorded.  While recording, an
op marks its floating-point leaf inputs as requiring grad, so that
:func:`grad` can differentiate with respect to an array that had no
``attach_grad()`` (as the reference's tape records every op).

MXNet's ``grad_req`` is kept on top of torch's accumulation: a
backward computes the gradients of the attached arrays it reaches with
``torch.autograd.grad`` (nothing accumulates in ``tensor.grad``) and
then writes them (``'write'``), adds them (``'add'``) or skips them
(``'null'``).  An array used several times in one backward gets the sum
of its partials, as in the reference.

A backward whose heads are the outputs of one recorded replay of a
hybridized block (``gluon.cached_op``) is deferred, when every input of
that replay is a leaf, the head gradients are the default and
``MXNET_FUSED_HYBRID_STEP`` is not ``"0"``: ``Trainer.step`` then runs
it together with the update as one CUDA graph (:func:`peek_pending`,
:func:`clear_pending`).  A backward over the lazy outputs of such a
call, whose forward has not run (``gluon.cached_op``), is deferred the
same way without running the forward: ``Trainer.step`` then runs
forward, backward and update as one graph.  Running a deferred backward
runs its lazy forward first.  Anything that could see the gradients first
runs it (:func:`flush_pending`): the next backward or ``grad``, a new
``record()``, ``waitall``, and reading or consuming one of the gradient
buffers it writes.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError, get_env

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "Function", "mark_variables", "get_symbol"]


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.pending = None             # the deferred backward, or None


_STATE = _AGState()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    old, _STATE.recording = _STATE.recording, bool(flag)
    return old


def set_training(flag: bool) -> bool:
    old, _STATE.training = _STATE.training, bool(flag)
    return old


class _RecordScope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training
        self._old = None

    def __enter__(self):
        if self._rec:
            flush_pending()
        self._old = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._old
        return False


def record(train_mode: bool = True) -> _RecordScope:
    """``with autograd.record():`` — record the ops that run inside."""
    return _RecordScope(True, train_mode)


def pause(train_mode: bool = False) -> _RecordScope:
    """``with autograd.pause():`` — stop recording inside ``record()``."""
    return _RecordScope(False, train_mode)


def train_mode() -> _RecordScope:
    return _RecordScope(None, True)


def predict_mode() -> _RecordScope:
    return _RecordScope(None, False)


# ---------------------------------------------------------------------------
# the tape: torch's graph, walked from the heads to the leaves
# ---------------------------------------------------------------------------
def _as_list(x):
    from .ndarray import NDArray
    if x is None:
        return None
    return [x] if isinstance(x, NDArray) else list(x)


def _graph_nodes(tensors):
    """Every node of torch's graph reachable from ``tensors``."""
    seen, stack, out = set(), [t.grad_fn for t in tensors
                               if t.grad_fn is not None], []
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        out.append(fn)
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return out


def _attached_leaves(nodes):
    """The arrays with an attached grad whose tensors are leaves of the
    graph of ``nodes`` (:func:`_graph_nodes`), in a stable order."""
    found, seen = [], set()
    for fn in nodes:
        var = getattr(fn, "variable", None)
        if var is None:
            continue
        ref = getattr(var, "_mx_owner", None)
        arr = ref() if ref is not None else None
        if arr is None or arr._data is not var or id(arr) in seen \
                or arr._grad is None or arr._grad_req == "null":
            continue
        seen.add(id(arr))
        found.append(arr)
    return found


def _head_grad(h, hg):
    if hg is None:
        return torch.ones_like(h._data)
    return hg._data.to(device=h._data.device, dtype=h._data.dtype)


def _run_grad(roots, inputs, cots, retain_graph, create_graph):
    """``torch.autograd.grad``; a graph freed by an earlier backward
    raises :class:`MXNetError` naming ``retain_graph``."""
    try:
        return torch.autograd.grad(roots, inputs, cots,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "modified by an inplace operation" in str(e):
            raise MXNetError(
                "backward through a graph whose saved arrays were written "
                "in place since its forward (Trainer.step's fused update "
                "writes the weights in place): run the backward before "
                "the step") from e
        if "second time" not in str(e):
            raise
        raise MXNetError(
            "backward through a graph that an earlier backward freed: "
            "pass retain_graph=True to the first backward") from e


def _store_grad(arr, g):
    """Write (``'write'``) or add (``'add'``) ``g`` into ``arr.grad``, in
    place where the buffer's shape allows (a graph reads it by
    address)."""
    dst = arr._grad
    g = g.to(dst._data.dtype)
    if g.shape != dst._data.shape:
        new = dst._data + g if arr._grad_req == "add" else g
        dst._set_data(new)
    elif arr._grad_req == "add":
        dst._data.add_(g)
    else:
        dst._data.copy_(g)


def _release_replays(nodes):
    """After a backward that kept no graph: the replays among ``nodes``
    have used their saved tensors (``gluon.cached_op``)."""
    for fn in nodes:
        claim = getattr(fn, "_mx_claim", None)
        if claim is not None:
            claim.release()


# ---------------------------------------------------------------------------
# the deferred backward
# ---------------------------------------------------------------------------
def peek_pending():
    """The deferred backward (a dict: ``claim``, ``heads``, ``head_idx``,
    ``grad_ids``, and ``lazy``: the lazy forward of its heads, or None
    when they were computed), or None."""
    return _STATE.pending


def flush_pending():
    """Run the deferred backward now, if there is one."""
    p = _STATE.pending
    if p is None:
        return
    _STATE.pending = None
    _backward_now(p["heads"], [None] * len(p["heads"]), False)


def flush_if_pending_grad(arr):
    """Run the deferred backward if ``arr`` is one of the gradient
    buffers it writes (an alias of ``p.grad()`` held across steps must
    not read the step before's gradients)."""
    p = _STATE.pending
    if p is not None and id(arr) in p["grad_ids"]:
        flush_pending()


def clear_pending():
    """Drop the deferred backward without running it: the caller ran it
    in its own graph."""
    p = _STATE.pending
    _STATE.pending = None
    if p is not None:
        p["claim"].release()


def _deferrable(heads, head_grads, retain_graph):
    """The pending record if this backward may wait for ``Trainer.step``
    (module docstring), else None."""
    if retain_graph or any(hg is not None for hg in head_grads) \
            or get_env("MXNET_FUSED_HYBRID_STEP", "1") == "0":
        return None
    # a lazy head's forward has not run: reading its _data would run it
    lazy = heads[0]._lazy
    if lazy is not None:
        claim = lazy.claim
        if claim is None or any(h._lazy is not lazy for h in heads):
            return None
        head_idx = tuple(sorted({lazy.index(h) for h in heads}))
    else:
        node = heads[0]._data.grad_fn
        claim = getattr(node, "_mx_claim", None)
        if claim is None or any(h._data.grad_fn is not node for h in heads):
            return None
        head_idx = tuple(sorted({h._data.output_nr for h in heads}))
    if claim.released or not claim.current() or not claim.leaf_inputs:
        return None
    grad_ids = set()
    for a in claim.arrays:
        if a._grad is None or a._grad_req == "null":
            continue
        if a._grad_req != "write":
            return None
        grad_ids.add(id(a._grad))
    return {"claim": claim, "heads": list(heads), "head_idx": head_idx,
            "grad_ids": grad_ids, "lazy": lazy}


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):
    """Gradients of ``heads`` with respect to every ``attach_grad()``-ed
    array they reach, written into ``arr.grad`` by its ``grad_req``
    (reference: ``MXAutogradBackwardEx``).  ``train_mode`` is accepted
    for the reference's signature: torch's backward does not run the
    forward again.  A backward over one hybridized replay may be
    deferred (module docstring)."""
    flush_pending()
    heads = _as_list(heads)
    head_grads = _as_list(head_grads) or [None] * len(heads)
    pending = _deferrable(heads, head_grads, retain_graph)
    if pending is not None:
        _STATE.pending = pending
        return
    _backward_now(heads, head_grads, retain_graph)


def _backward_now(heads, head_grads, retain_graph):
    roots, cots, leaf_parts = [], [], []
    for h, hg in zip(heads, head_grads):
        if h._data.grad_fn is None:
            if h._grad is None or h._grad_req == "null":
                raise MXNetError(
                    "cannot differentiate a head that was not computed "
                    "inside autograd.record()")
            # a head that IS a variable: d head / d head = ones
            leaf_parts.append((h, _head_grad(h, hg)))
            continue
        roots.append(h._data)
        cots.append(_head_grad(h, hg))
    nodes = _graph_nodes(roots) if roots else []
    targets = _attached_leaves(nodes)
    sums = {}
    if targets:
        grads = _run_grad(roots, [a._data for a in targets], cots,
                          retain_graph, False)
        for arr, g in zip(targets, grads):
            if g is not None:
                sums[id(arr)] = (arr, g)
    if not retain_graph:
        _release_replays(nodes)
    for arr, g in leaf_parts:
        prev = sums.get(id(arr))
        sums[id(arr)] = (arr, g if prev is None else prev[1] + g)
    with torch.no_grad():
        for arr, g in sums.values():
            _store_grad(arr, g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    as new arrays; no ``.grad`` buffer is touched (reference:
    ``autograd.grad``).  ``create_graph=True`` records the gradient
    computation, so its results can be differentiated again, and keeps
    the graph (as ``retain_graph=True``)."""
    from .ndarray import NDArray
    flush_pending()
    single = isinstance(variables, NDArray)
    variables = _as_list(variables)
    heads = _as_list(heads)
    head_grads = _as_list(head_grads) or [None] * len(heads)
    if create_graph:
        for v in variables:
            if v._data.grad_fn is not None:
                raise MXNetError(
                    "grad(create_graph=True): variables must be leaf "
                    "arrays (this one was computed inside record(); "
                    "differentiate with respect to its leaf inputs)")
        for hg in head_grads:
            if hg is not None and hg._data.grad_fn is not None:
                raise MXNetError(
                    "grad(create_graph=True): head_grads recorded on the "
                    "tape would become constants of the gradient and "
                    "drop their own gradient paths; pass detached "
                    "head_grads")
        for fn in _graph_nodes([h._data for h in heads]):
            if type(fn).__name__ == _CUSTOM_NODE:
                raise MXNetError(
                    "grad(create_graph=True): the tape holds a custom "
                    "autograd.Function, whose host-side backward cannot "
                    "be differentiated again")
            if getattr(fn, "_mx_claim", None) is not None:
                raise MXNetError(
                    "grad(create_graph=True): the tape holds a replay of "
                    "a hybridized block, whose captured backward cannot "
                    "be differentiated again; hybridize(False) first")
    uniq, slot = [], []
    for v in variables:
        for i, u in enumerate(uniq):
            if u._data is v._data:
                slot.append(i)
                break
        else:
            slot.append(len(uniq))
            uniq.append(v)
    roots, cots, direct = [], [], {}
    for h, hg in zip(heads, head_grads):
        hit = next((i for i, u in enumerate(uniq) if u._data is h._data),
                   None)
        if hit is not None and h._data.grad_fn is None:
            g = _head_grad(h, hg)
            direct[hit] = g if hit not in direct else direct[hit] + g
            continue
        if h._data.grad_fn is None:
            raise MXNetError(
                "cannot differentiate a head that was not computed inside "
                "autograd.record()")
        roots.append(h._data)
        cots.append(_head_grad(h, hg))
    outs = [None] * len(uniq)
    want = [i for i, u in enumerate(uniq) if u._data.requires_grad]
    if roots and want:
        keep = bool(retain_graph) or create_graph
        grads = _run_grad(roots, [uniq[i]._data for i in want], cots,
                          keep, create_graph)
        for i, g in zip(want, grads):
            outs[i] = g
        if not keep:
            _release_replays(_graph_nodes(roots))
    for i, g in direct.items():
        outs[i] = g if outs[i] is None else outs[i] + g
    res = []
    for u, g in zip(uniq, outs):
        if g is None:
            g = torch.zeros_like(u._data)
        elif not create_graph:
            g = g.detach()
        res.append(NDArray._wrap(g, u.context))
    results = [res[s] for s in slot]
    return results[0] if single else results


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach explicit grad buffers (reference:
    ``autograd.mark_variables``)."""
    from .ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(req)
        v._grad = g


# ---------------------------------------------------------------------------
# custom functions
# ---------------------------------------------------------------------------
class _CustomNode(torch.autograd.Function):
    """Runs a :class:`Function`'s NDArray ``forward`` / ``backward``
    inside one torch graph node."""

    @staticmethod
    def forward(ctx, func, in_ctxs, *tensors):
        from .ndarray import NDArray
        ctx.func = func
        ctx.in_ctxs = in_ctxs
        with pause():
            outputs = func.forward(*[NDArray._wrap(t.detach(), c)
                                     for t, c in zip(tensors, in_ctxs)])
        single = not isinstance(outputs, (list, tuple))
        func._single = single
        outs = [outputs] if single else list(outputs)
        ctx.out_ctxs = func._out_ctxs = [o.context for o in outs]
        return tuple(o._data.detach().clone() for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray import NDArray
        with pause():
            igrads = ctx.func.backward(*[
                NDArray._wrap(g, c) for g, c in zip(out_grads,
                                                    ctx.out_ctxs)])
        if not isinstance(igrads, (list, tuple)):
            igrads = [igrads]
        return (None, None) + tuple(
            None if g is None else g._data for g in igrads)


_CUSTOM_NODE = "_CustomNodeBackward"


class Function:
    """Custom differentiable function (reference: ``mx.autograd.Function``):
    subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        tensors = []
        for a in inputs:
            t = a._data
            if t.grad_fn is None and not t.requires_grad \
                    and t.is_floating_point():
                t.requires_grad_(True)
            tensors.append(t)
        with torch.enable_grad():
            outs = _CustomNode.apply(self, [a.context for a in inputs],
                                     *tensors)
        res = [NDArray._wrap(t, c) for t, c in zip(outs, self._out_ctxs)]
        return res[0] if self._single else res


def get_symbol(x):
    """Reference: ``autograd.get_symbol``.  The tape is not exported as a
    Symbol: trace a HybridBlock with ``mx.sym`` inputs instead."""
    raise MXNetError("get_symbol: use HybridBlock tracing / mx.sym instead "
                     "(tape-to-symbol export is not supported)")
