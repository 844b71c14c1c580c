"""From the imperative Gluon API to a function of tensors, and a Gluon
block as the ``nn.Module`` that ``ShardedTrainer`` trains.

The counterpart of ``mxnet_tpu.parallel.functional``.
``functionalize(block, *example_inputs)`` returns ``(apply_fn,
params)``: ``apply_fn(params, *inputs) -> (outputs, aux)`` runs the
block's forward (its children's plain forwards, as a CachedOp runs them)
with every parameter read from ``params`` (``{Gluon name: tensor}``,
on the inputs' device) instead of the block's own arrays, and torch
records the products, so
``torch.autograd`` differentiates the outputs with respect to the
tensors given (under ``torch.no_grad()``, an export's trace, nothing
records).  The forward's in-place writes of states without a
gradient (BatchNorm's running statistics) land in the tensors given,
which ``aux`` returns by name.

:class:`GluonModule` holds a block's parameters as ``nn.Parameter``
(``grad_req`` not ``"null"``) and buffers (the rest) under their Gluon
names (so the rules match those), sharing storage with the block's
arrays, and runs ``apply_fn`` as its forward:
``torch.func.functional_call`` then swaps in a trainer's tensors, and a
layer with
``bind_tensor_parallel`` (``gluon.contrib.MoEFFN``) is bound through
the module's own ``bind_tensor_parallel``.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from ..base import MXNetError

__all__ = ["functionalize", "GluonModule"]


@contextlib.contextmanager
def _reading(params, tensors):
    """Each parameter holds its tensor alone, on the tensor's device's
    context, for the block (its own arrays back afterwards)."""
    from ..context import context_of
    from ..ndarray import NDArray
    saved = [p._data for p in params]
    for p, t in zip(params, tensors):
        ctx = context_of(t.device)
        p._data = OrderedDict([(ctx, NDArray._wrap(t, ctx))])
    try:
        yield
    finally:
        for p, data in zip(params, saved):
            p._data = data


def _as_input(t):
    """A tensor without a gradient goes in as a fresh view over its
    storage: a recorded op may mark its input as requiring a gradient,
    which must not stick to the caller's (static) tensor; an in-place
    write through the view still lands in it."""
    return t if t.requires_grad else t.detach()


def functionalize(block, *example_inputs, train_mode=True):
    """Returns ``(apply_fn, init_params)`` (module docstring).

    ``apply_fn(params: dict[str, Tensor], *inputs: Tensor) ->
    (outputs, aux)``: ``outputs`` one tensor, or the tuple of the
    block's outputs flattened; ``aux`` the tensors of the parameters
    without a gradient, by name, after the forward.  ``init_params``:
    ``{name: tensor}`` of the block's current values (the block's own
    tensors, not copies)."""
    from .. import autograd
    from ..gluon.block import _resolve_shapes
    from ..gluon.cached_op import _IN_PROGRAM, _TRACING, _flatten, recording
    from ..ndarray import NDArray
    _resolve_shapes(block, example_inputs, train_mode)
    params = OrderedDict(block.collect_params().items())
    names = list(params)
    aux_names = [n for n in names if params[n].grad_req == "null"]

    def apply_fn(param_tensors, *input_tensors):
        missing = [n for n in names if n not in param_tensors]
        if missing:
            raise MXNetError(f"functionalize: no tensor for parameter "
                             f"{missing[0]!r}")
        tensors = [_as_input(param_tensors[n]) for n in names]
        xs = [NDArray._wrap(_as_input(t)) for t in input_tensors]
        mode = recording(train_mode) if torch.is_grad_enabled() \
            else autograd.pause(train_mode=train_mode)
        tok, in_prog = _TRACING.set(True), _IN_PROGRAM.set(True)
        try:
            with _reading(list(params.values()), tensors), mode:
                out = block.forward(*xs)
        finally:
            _IN_PROGRAM.reset(in_prog)
            _TRACING.reset(tok)
        flat, tree = _flatten(out)
        outs = tuple(a._data for a in flat)
        aux = {n: param_tensors[n] for n in aux_names}
        return (outs[0] if tree is None else outs), aux

    init_params = {n: params[n].list_data()[0]._data for n in names}
    return apply_fn, init_params


class GluonModule(torch.nn.Module):
    """A Gluon block as an ``nn.Module`` (module docstring)."""

    def __init__(self, block, *example_inputs, train_mode=True):
        super().__init__()
        apply_fn, init = functionalize(block, *example_inputs,
                                       train_mode=train_mode)
        object.__setattr__(self, "gluon_block", block)
        self._apply_fn = apply_fn
        self._names = list(init)
        self._tp = None
        params = block.collect_params()
        for name, t in init.items():
            if not name.isidentifier():
                raise MXNetError(f"GluonModule: parameter name {name!r} is "
                                 f"not an identifier")
            if params[name].grad_req != "null":
                self.register_parameter(
                    name, torch.nn.Parameter(t.detach(), requires_grad=True))
            else:
                self.register_buffer(name, t.detach())
        self._by_param = {id(params[n]): n for n in self._names}

    def _tensor(self, name):
        return self._parameters[name] if name in self._parameters \
            else self._buffers[name]

    def forward(self, *inputs):
        bound = self._tp or ()
        for blk, binding in bound:
            blk._tp = binding
        try:
            outs, _aux = self._apply_fn(
                {n: self._tensor(n) for n in self._names}, *inputs)
        finally:
            for blk, _ in bound:
                blk._tp = None
        return outs

    def _blocks(self):
        todo = [self.gluon_block]
        while todo:
            blk = todo.pop(0)
            yield blk
            todo.extend(blk._children.values())

    def bind_tensor_parallel(self, tp):
        """Every layer of the block with ``bind_tensor_parallel``, bound
        on ``tp``'s mesh: ``([(layer, binding)], the tensors they run
        split)``, or ``(None, [])`` when none is bound."""
        view = tp.with_spec_of(
            lambda p: tp.spec_of(self._tensor(self._by_param[id(p)])))
        bound, split = [], []
        for blk in self._blocks():
            bind = getattr(blk, "bind_tensor_parallel", None)
            if bind is None:
                continue
            binding, params = bind(view)
            if binding is not None:
                bound.append((blk, binding))
                split += [self._tensor(self._by_param[id(p)])
                          for p in params]
        return (bound or None), split
