"""FusedTrainStep of the PyTorch port: a block's forward, backward and
its Trainer's optimizer update as ONE CUDA graph per signature (the
counterpart of ``mxnet_tpu.gluon.contrib.fused``, whose step is one
donated XLA program).

The classic Gluon recipe

    with autograd.record():
        loss = block(*inputs)
    loss.backward()
    trainer.step(batch_size)

makes three calls from the host; ``FusedTrainStep`` makes one, while the
weights keep living in the Block's ``Parameter`` objects, so
``save_parameters``, ``set_learning_rate`` and ``export`` keep working:

    step = FusedTrainStep(loss_block, trainer)
    for batch in loader:
        loss = step(*batch)                    # one graph launch

It is built on the Trainer's fused tier (``gluon.trainer._FusedUpdate``)
and the CachedOp's programs (``gluon.cached_op``): each signature (the
inputs' shapes and dtypes, the parameters', the optimizer's fused key
and its states') has a program of the block's forward over static input
buffers, reading each parameter through its bound home (an alias of it
on the card), and one ``_FusedUpdate`` whose backward runs that forward
and differentiates the loss, summed, with respect to the trainable
parameters; the update then writes weights and states in place.  On the
card the signature's first call runs eagerly on the program's stream (a
real step) and is then captured with the kernels of B1-B3 inside; every
later call stages the inputs and replays.  On the CPU the same path runs
without graphs.

Contract (the reference's):

- the loss (any shape) is summed for the backward seed, as
  ``loss.backward()``'s ones;
- the parameters' ``.grad`` buffers are NOT written (the gradients live
  in the program's own buffers); ``grad_req='add'`` raises, and so do a
  row-sparse ``grad_stype``, an optimizer without a fused kernel, a
  kvstore, and a trainable parameter the given trainer does not manage;
- do not wrap calls in ``autograd.record()``: the step records its own
  forward;
- update counts, learning rates and weight decays advance as
  ``Trainer._fused_update`` advances them, and roll back when a step
  fails before its update ran; BatchNorm's running statistics are
  written by the forward.

Failures, and which rule each one takes (the reference donates the
weight and state buffers: a failure after dispatch consumes them):

- before the launch (staging the inputs, the step-varying scalars, the
  program's set-up): nothing was written; the error propagates as it
  is, the counts roll back, and the instance is not poisoned;
- the capture after a signature's first (eager) step: that step's
  update was applied; the capture's ``KernelError`` propagates, and
  every later call of the signature raises ``KernelError`` (the
  standing rule for a failed capture), until :meth:`reset`;
- after the launch (the eager first step or a replay failed, having
  begun to write the weights and states in place — the port's
  "donated"): the counts roll back and the instance is poisoned: this
  call and every later one raise ``KernelError`` with the reference's
  "reload, then ``.reset()``" guidance.  :meth:`reset` after reloading
  drops the optimizer states the failed launch was writing (unless the
  user restored them: ``trainer.load_states`` makes new ones) and the
  signatures whose graph failed, which are captured anew.

Nothing ever takes the three-call path in place of a failed capture.
"""
from __future__ import annotations

import torch

from ...base import KernelError, MXNetError
from ...ndarray import NDArray, dtype_name

__all__ = ["FusedTrainStep"]


class _Entry:
    """One signature: the block's program and static inputs (``prog``,
    ``inst``), the gradient buffers, and the ``_FusedUpdate``
    (``update``)."""

    def __init__(self, cop, prog, inst, grads, update):
        self.cop, self.prog, self.inst = cop, prog, inst
        self.grads = grads
        self.update = update


class FusedTrainStep:
    """``block``'s loss forward + backward + ``trainer``'s optimizer as
    one CUDA graph per signature (module docstring).

    ``block`` must return the loss (any shape; it is summed for the
    backward seed, exactly like ``loss.backward()``'s default ones
    cotangent).  ``trainer`` must be single-context with a fused-capable
    optimizer and no kvstore.
    """

    def __init__(self, block, trainer):
        self._block = block
        self._trainer = trainer
        self._cache = {}
        self._poisoned = None
        self._consumed = {}             # trainer index -> state written
        o = trainer._optimizer
        if not getattr(o, "fused", False):
            raise MXNetError(
                f"FusedTrainStep: optimizer {type(o).__name__} has no "
                f"fused kernel")
        if not trainer._kv_initialized:
            trainer._init_kvstore()
        if trainer._kvstore is not None or trainer._update_on_kvstore:
            raise MXNetError(
                "FusedTrainStep is single-context; use "
                "parallel.ShardedTrainer (or kvstore-backed Trainer.step) "
                "for multi-device training")
        for p in trainer._params:
            if p.grad_req == "add":
                raise MXNetError(
                    "FusedTrainStep cannot honor grad_req='add' "
                    "(gradients never materialize); use the "
                    "record/backward/step recipe for accumulation")
            if getattr(p, "_grad_stype", "default") != "default":
                raise MXNetError(
                    f"FusedTrainStep computes dense gradients; parameter "
                    f"{p.name!r} requests grad_stype="
                    f"{p._grad_stype!r} lazy sparse updates — use the "
                    f"record/backward/step recipe")

    def reset(self):
        """Clear the poisoned flag after parameters (and optimizer state)
        have been reloaded following a failed step (module docstring).

        Optimizer states the user restored (``trainer.load_states``) are
        kept; only states the failed launch was writing are dropped
        (they are made anew on the next step), and so are the signatures
        whose graph failed."""
        self._poisoned = None
        upd = self._trainer._updater
        for i, state in self._consumed.items():
            if upd.states.get(i) is state:
                del upd.states[i]
        self._consumed = {}
        for sig, entry in list(self._cache.items()):
            if entry.update.failed is not None or entry.update.launched \
                    and not entry.update.applied:
                del self._cache[sig]
            else:
                entry.update.counts = None      # t re-read from the counts

    # ---------------------------------------------------------------- build
    def _items(self, params):
        """The block's trainable parameters ``[(trainer index, slot)]`` in
        the trainer's order; a trainable one the trainer does not manage
        raises."""
        t_index = {id(p): i for i, p in enumerate(self._trainer._params)}
        items = []
        for slot, (name, p) in enumerate(params):
            if p.grad_req == "null":
                continue
            if id(p) not in t_index:
                # a second Trainer managing this param would read .grad
                # buffers this step never writes: refuse loudly
                raise MXNetError(
                    f"FusedTrainStep: parameter {name!r} has "
                    f"grad_req={p.grad_req!r} but is not managed by the "
                    f"given trainer; multi-trainer setups need the "
                    f"record/backward/step recipe (or grad_req='null' "
                    f"to freeze it)")
            items.append((t_index[id(p)], slot))
        if not items:
            raise MXNetError("FusedTrainStep: no trainable parameters")
        return sorted(items)

    def _build(self, inputs, arrays, items):
        from .. import cached_op as _co
        from ..trainer import _FusedUpdate
        trainer = self._trainer
        cop = _co.CachedOp(self._block)
        homes = [cop._bind(a) for a in arrays]
        sig = (tuple((tuple(x.shape), dtype_name(x._data.dtype), False)
                     for x in inputs), None, True)
        prog = cop._build(sig, inputs, arrays, homes)
        tensors = [x._data for x in inputs]
        if prog.graphs is None:
            inst = _co._Instance(prog, True)
            inst.stage(tensors)
        else:
            with prog.graphs.on_stream():
                inst = _co._Instance(prog, True)
                inst.stage(tensors)
        n_in = prog.n_in
        p_slots = [n_in + slot for _i, slot in items]
        if any(k not in prog.grad_pos for k in p_slots):
            raise MXNetError("FusedTrainStep: a trainable parameter has no "
                             "gradient buffer (initialize the block first)")

        def forward_backward():
            with _co.recording(True):
                loss = inst.run()[0]
                grads = torch.autograd.grad(
                    [loss], inst.leaves(), [torch.ones_like(loss)],
                    allow_unused=True)
            at = dict(zip(prog.grad_pos, grads))
            return [at[k] for k in p_slots], [], [loss.detach()]

        weights = [arrays[slot] for _i, slot in items]
        grads = [NDArray._wrap(torch.zeros_like(w._data), w.context)
                 for w in weights]
        update = _FusedUpdate(trainer._optimizer, [i for i, _s in items],
                              prog.device, prog.graphs, inst.pool,
                              forward_backward)
        return _Entry(cop, prog, inst, grads, update)

    # ----------------------------------------------------------------- call
    def _poison_error(self):
        e = self._poisoned
        return KernelError(
            "FusedTrainStep: a previous donated step failed after "
            "dispatch; the block's weight and optimizer-state buffers "
            "were written in place by the failed launch and cannot be "
            "trusted.  Reload parameters (load_parameters / "
            "initialize(force_reinit=True)), then call .reset() on this "
            "FusedTrainStep (or construct a new one) before training "
            f"again.  Original failure: {e!r}")

    def __call__(self, *inputs, batch_size=None):
        from ... import autograd
        from .. import cached_op as _co
        from ..block import _resolve_shapes
        from ..trainer import _advance, _fused_rollback

        if self._poisoned is not None:
            raise self._poison_error() from self._poisoned
        trainer = self._trainer
        o = trainer._optimizer
        upd = trainer._updater
        if batch_size is None:
            batch_size = inputs[0].shape[0]
        o.rescale_grad = trainer._scale / batch_size

        _resolve_shapes(self._block, inputs, train_mode=False)
        params = list(self._block.collect_params().items())
        ctx = inputs[0].context
        arrays = [p.data(ctx) for _n, p in params]
        items = self._items(params)
        idx = [i for i, _s in items]
        for i, slot in items:
            if i not in upd.states:
                upd.states[i] = o.create_state_multi_precision(
                    i, arrays[slot])
        states = [upd.states[i] for i in idx]
        weights = [arrays[slot] for _i, slot in items]
        sig = (tuple((tuple(x.shape), dtype_name(x._data.dtype))
                     for x in inputs),
               tuple((n, tuple(a.shape), dtype_name(a._data.dtype))
                     for (n, _p), a in zip(params, arrays)),
               trainer._fused_key(idx, weights, states),
               inputs[0]._data.device)
        # every lazy forward and deferred backward reads the weights this
        # step writes: they run first
        _co.run_lazy()
        autograd.flush_pending()
        entry = self._cache.get(sig)
        if entry is None:
            entry = self._cache[sig] = self._build(inputs, arrays, items)
        prog, inst, step = entry.prog, entry.inst, entry.update
        for a, home in zip(arrays, prog.homes):
            entry.cop._bind(a, home)
        prog.arrays = arrays
        before = _advance(o, idx)
        try:
            tensors = [x._data for x in inputs]
            if prog.graphs is None:
                inst.stage(tensors)
            else:
                with prog.graphs.on_stream():
                    inst.stage(tensors)
            step(weights, entry.grads, [], states)
        except BaseException as e:
            if not step.applied:
                _fused_rollback(o, idx, before)
                step.counts = None
            if not step.launched or step.applied:
                raise
            self._poisoned = e
            self._consumed = dict(zip(idx, states))
            if isinstance(e, Exception):
                raise KernelError(
                    "FusedTrainStep failed after dispatch; weight and "
                    "optimizer-state buffers were donated to the failed "
                    "launch (written in place) and may be partly updated. "
                    " Reload parameters, then call .reset() (or construct "
                    f"a new FusedTrainStep).  Cause: {e!r}") from e
            raise       # KeyboardInterrupt/SystemExit propagate as they are
        return NDArray._wrap(step.outs[0], ctx)
