"""Trainer of the PyTorch port: optimizer and kvstore orchestration
(reference: ``python/mxnet/gluon/trainer.py``).

The counterpart of ``mxnet_tpu.gluon.trainer``: a step sums the
per-context gradients through the kvstore (``pushpull``), rescales by
``1 / batch_size`` and updates every context copy with its own
:class:`~mxnet_tpu_torch.optimizer.Updater`, all of them driving one
optimizer (per-device update counts keep bias corrections from
advancing twice).

A parameter with ``grad_stype="row_sparse"`` (``nn.Embedding(...,
sparse_grad=True)``, ``contrib.nn.SparseEmbedding``) has its gradient
compressed to its non-zero rows before its update
(``tostype("row_sparse")``: one host read of the row mask, so one
device synchronisation a step on the card), and SGD's and Adam's
``lazy_update`` then move only those rows and their states, as in the
JAX package.

The fused tiers, for a fused optimizer (SGD, Adam, AdamW) on one
context with ``grad_req='write'`` and default storage
(:meth:`Trainer._fused_eligible`; any other step, a Trainer holding a
row-sparse parameter's included, takes the per-parameter path,
eagerly):

- ``_fused_update``: every parameter's update as one
  :class:`_FusedUpdate`, one CUDA graph per key (the optimizer's type,
  ``_fused_key()``, the updated parameters' indices and each one's
  shape, dtype and state), on the trainer's own stream and memory pool;
- ``_try_fused_hybrid_step``: when the last ``backward`` was deferred
  (its heads are the outputs of one recorded replay of a hybridized
  block, ``autograd.backward``), that backward and the update are one
  :class:`_FusedUpdate` of the replay's instance, per (Trainer,
  signature, optimizer key), captured in the instance's pool: it
  writes the ``.grad`` buffers of the parameters and of the replay's
  other attached inputs, then updates in place;
- the full step (:meth:`Trainer._full_fused_step`): when those heads
  are lazy (the forward of the recorded call has not run,
  ``gluon.cached_op``), forward, backward and update are one
  :class:`_FusedUpdate` of the instance, per (Trainer, signature,
  optimizer key), its key starting with ``"full"``
  (``Trainer._fused_step_progs``): the forward over the inputs staged at
  record time, the backward from ones over the heads, then the
  update.  After it the lazy outputs get copies of the graph's outputs.
  Every other lazy forward runs first (``cached_op.run_lazy``), since
  the step writes the weights they read.

All three write the weights, states and fp32 masters in place, since the
forward graphs read them by address, and bind every array they touch
(``NDArray._bind``).  The step-varying values (t, lr, wd, rescale) are
device tensors, rewritten only when their host values change, and t
advances on the device, so a learning-rate schedule never captures
again.  Each update of a weight is counted on it
(``ndarray.count_write``), and a replayed update also advances the
weight's autograd version, so a backward saved before the step refuses
to run (``gluon.cached_op``).  The first call of an entry runs eagerly
on its stream (a real update), the capture follows, later calls
replay.  Update counts
advance as the per-parameter path's do; a call that fails before its
update ran raises :class:`~mxnet_tpu_torch.base.KernelError` with the
counts rolled back (``_fused_rollback``), and an entry whose capture
failed raises on every later step (a full step's lazy outputs then
raise when read).  On the CPU the same entries run eagerly, without
graphs.

With ``MXNET_RUNTIME_METRICS`` and ``MXNET_RUNTIME_METRICS_GRAD_NORM``
on, every step publishes the global L2 norm of the gradients in the
``trainer.grad_norm`` gauge, read from the ``.grad`` buffers after the
step's graphs ran (one host sync).

A ``dist*`` kvstore is created at one context too (upstream MXNet's
rule; the JAX Trainer creates none there, so its workers never
average), and after ``init`` every context pulls the store's value, so
all ranks start from rank 0's weights and stay equal.  With initialised
parameters that happens when the Trainer is made, before the first
forward; parameters still waiting for their shape sync at the first
step.
"""
from __future__ import annotations

import time
import weakref

import torch

from ..base import KernelError, MXNetError
from .. import autograd
from .. import optimizer as opt
from .. import runtime_metrics as _rm
from ..ndarray import dtype_name
from ..ndarray.ndarray import count_write
from . import cached_op as _cached_op
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _flat_state(state):
    """An optimizer state's arrays in order (None left out)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat_state(s)]
    return [state]


def _state_sig(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_state_sig(s) for s in state)
    return (tuple(state.shape), dtype_name(state._data.dtype))


def _raw_state(state, tensors):
    """``state``'s structure over the next tensors of ``tensors``."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_raw_state(s, tensors) for s in state)
    return next(tensors)


def _fused_rollback(o, idx, before):
    """Undo the update counts of a fused call whose update did not run:
    the per-index counts and ``num_update`` (``before`` from
    :func:`_advance`)."""
    counts, num_update = before
    for i in idx:
        if counts[i] is None:
            o._index_update_count.pop(i, None)
        else:
            o._index_update_count[i] = counts[i]
    o.num_update = num_update


def _advance(o, idx):
    """Advance the update counts as the per-parameter path does; returns
    what :func:`_fused_rollback` restores."""
    before = ({i: o._index_update_count.get(i) for i in idx}, o.num_update)
    for i in idx:
        o._update_count(i)
    return before


class _FusedUpdate:
    """One fused update of a :class:`Trainer` (module docstring): every
    parameter's ``_fused_one``, written in place into the bound weights
    and states, with t, lr, wd and rescale in device tensors.  With
    ``backward`` (a function returning the gradients of the parameters
    and of the other attached inputs) the gradients come from a backward
    over a replay's saved tensors and are written into the ``.grad``
    buffers first.  ``graphs`` / ``pool``: where it captures (None on the
    CPU: it runs eagerly)."""

    def __init__(self, o, idx, device, graphs, pool, backward=None):
        # backward() returns the parameters' gradients, the other
        # inputs' and the outputs of a forward it ran (or None)
        self.opt = o
        self.idx = list(idx)
        n = len(self.idx)
        f32 = dict(dtype=torch.float32, device=device)
        self.ts = torch.zeros(n, **f32)
        self.lrs = torch.zeros(n, **f32)
        self.wds = torch.zeros(n, **f32)
        self.rescale = torch.zeros((), **f32)
        self.counts = self.hyper = None
        self.graphs, self.pool = graphs, pool
        self.backward = backward
        self.bound = None               # weights, grads, others, states
        self.layout = None
        self.graph = None
        self.static = None              # the graph's outputs
        self.outs = None                # the last call's outputs
        self.warm = False
        self.failed = None
        self.launched = False           # the last call began its update
        self.applied = False            # the last call's update ran
        self.copies = 0
        self.replays = 0
        self.capture_s = 0.0

    def _bind(self, arrays):
        if self.bound is None:
            self.bound = [a._bind()[0] for a in arrays]
            return
        for a, home in zip(arrays, self.bound):
            self.copies += a._bind(home)[1]

    def _written(self, replayed):
        """Count the update's in-place write of every weight; a replay
        also advances the weights' autograd versions, which a graph does
        not, so that a backward saved before it refuses to run."""
        for w in self.bound[:len(self.idx)]:
            count_write(w)
            if replayed:
                torch.autograd.graph.increment_version(w)

    def _refresh(self):
        o = self.opt
        counts = [o._index_update_count[i] for i in self.idx]
        if self.counts != counts:
            self.ts.copy_(torch.tensor(counts, dtype=torch.float32))
        self.counts = [c + 1 for c in counts]
        hyper = (tuple(float(o._get_lr(i)) for i in self.idx),
                 tuple(float(o._get_wd(i)) for i in self.idx),
                 float(o.rescale_grad))
        if self.hyper != hyper:
            self.lrs.copy_(torch.tensor(hyper[0], dtype=torch.float32))
            self.wds.copy_(torch.tensor(hyper[1], dtype=torch.float32))
            self.rescale.fill_(hyper[2])
            self.hyper = hyper

    def _body(self):
        n, (n_other, states) = len(self.idx), self.layout
        weights, grads = self.bound[:n], self.bound[n:2 * n]
        others = self.bound[2 * n:2 * n + n_other]
        flat = iter(self.bound[2 * n + n_other:])
        raw = [_raw_state(s, flat) for s in states]
        outs = None
        if self.backward is not None:
            p_grads, o_grads, outs = self.backward()
            with torch.no_grad():
                for buf, g in zip(grads + others, p_grads + o_grads):
                    if g is None:
                        buf.zero_()
                    else:
                        buf.copy_(g)
        with torch.no_grad():
            for k, (w, g, s) in enumerate(zip(weights, grads, raw)):
                new_w, new_s = self.opt._fused_one(
                    w, g, s, self.ts[k], self.lrs[k], self.wds[k],
                    self.rescale)
                w.copy_(new_w)
                for dst, src in zip(_flat_state(s), _flat_state(new_s)):
                    dst.copy_(src)
            self.ts.add_(1.0)
        return outs

    def _capture(self):
        t0 = time.perf_counter()
        try:
            self.graph, self.static = self.graphs.capture(self._body,
                                                          self.pool)
        except Exception as e:
            self.failed = e
            raise KernelError(
                f"Trainer: capture of the fused "
                f"{'backward + update' if self.backward else 'update'} "
                f"as a CUDA graph failed: {e}") from e
        self.capture_s = time.perf_counter() - t0

    def __call__(self, weights, grads, others, states):
        """Update (after the backward, with ``backward``) in place."""
        self.applied = self.launched = False
        if self.failed is not None:
            raise KernelError(
                f"Trainer: the fused update's CUDA graph for this key "
                f"failed to capture earlier: {self.failed}")
        if self.layout is None:
            self.layout = (len(others), states)
        self._bind(list(weights) + list(grads) + list(others)
                   + [a for s in states for a in _flat_state(s)])
        self.outs = None
        if self.graphs is None:
            self._refresh()
            self.launched = True
            self.outs = self._body()
            self.applied = True
            self._written(False)
            return
        with self.graphs.on_stream() as caller:
            self._refresh()
            if not self.warm:
                self.launched = True
                self.outs = self._body()
                self.applied = self.warm = True
                self._written(False)
                self._keep(caller)
                self._capture()
                return
            self.launched = True
            try:
                self.graph.replay()
            except Exception as e:
                raise KernelError(
                    f"Trainer: replay of the fused update's CUDA graph "
                    f"failed: {e}") from e
            self.applied = True
            self.replays += 1
            self._written(True)
            if self.static is not None:
                self.outs = [o.detach().clone() for o in self.static]
                self._keep(caller)

    def _keep(self, caller):
        """The outputs outlive the graph's stream: the caller's now."""
        for o in self.outs or ():
            o.record_stream(caller)


def _is_dist(kvstore) -> bool:
    name = kvstore if isinstance(kvstore, str) \
        else getattr(kvstore, "type", "")
    return "dist" in str(name).lower()


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    ``gluon.Trainer``)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a dict or list of Parameters")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
        self._compression_params = compression_params
        self._scale = 1.0
        self._init_optimizer(optimizer, optimizer_params or {})
        self._kvstore = None
        self._kv_initialized = False
        self._kvstore_arg = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._fused_progs = {}          # key -> _FusedUpdate
        self._fused_insts = weakref.WeakSet()   # instances with entries
        self._graphs = {}               # device -> (graph backend, pool)
        if _is_dist(kvstore) and all(p._data for p in self._params):
            # every rank takes rank 0's weights before its first forward
            self._init_kvstore()

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError(
                    "optimizer_params must be empty when optimizer is an "
                    "Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        # one Updater per device copy, all driving the same optimizer
        self._updater = opt.get_updater(self._optimizer)
        self._dev_updaters = {0: self._updater}

    def _num_ctx(self):
        for p in self._params:
            if p.grad_req != "null":
                return len(p.list_ctx())
        return 1

    def _init_kvstore(self):
        arg = self._kvstore_arg
        if arg is None or (self._num_ctx() == 1 and not _is_dist(arg)):
            # one context and no workers to average with: the grads are
            # already the full-batch grads
            self._kvstore = None
            if self._update_on_kvstore:
                raise MXNetError("update_on_kvstore=True requires a kvstore")
            self._update_on_kvstore = False
            self._kv_initialized = True
            return
        from .. import kvstore as kvs
        store = kvs.create(arg) if isinstance(arg, str) else arg
        if self._compression_params is not None:
            store.set_gradient_compression(self._compression_params)
        update_on_kvstore = bool(self._update_on_kvstore)
        if update_on_kvstore and not store.is_capable(
                kvs.KVStoreBase.OPTIMIZER):
            raise MXNetError(
                f"kvstore type {store.type!r} cannot run the optimizer "
                f"(update_on_kvstore)")
        self._update_on_kvstore = update_on_kvstore
        for i, p in enumerate(self._params):
            if p.grad_req != "null":
                store.init(str(i), p.data())
                if _is_dist(store.type):
                    # rank 0's value won the init: every context starts
                    # from it
                    store.pull(str(i), out=p.list_data())
        if update_on_kvstore:
            store.set_optimizer(self._optimizer)
        self._kvstore = store
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Sum the gradients across contexts (and workers), rescale by
        ``1 / batch_size``, update (reference: ``Trainer.step``).  With
        runtime metrics on, the step's wall time, synchronised with the
        card, goes to ``trainer.step.seconds``, and with
        ``MXNET_RUNTIME_METRICS_GRAD_NORM`` on the gradients' global norm
        to ``trainer.grad_norm``."""
        if not _rm._ENABLED:
            self._step_impl(batch_size)
            return
        t0 = time.perf_counter()
        try:
            self._step_impl(batch_size)
        finally:
            self._sync()
            _rm.TRAINER_STEP_SECONDS.observe(time.perf_counter() - t0)
        if _rm.grad_norm_enabled():
            _rm.publish_grad_norm(p.list_grad()[0] for p in self._params
                                  if p.grad_req != "null")

    def _sync(self):
        import torch
        for p in self._params:
            for d in (p.list_data() if p._data else ()):
                if d._data.device.type == "cuda":
                    torch.cuda.synchronize(d._data.device)
                    return

    def _step_impl(self, batch_size):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        pending = autograd.peek_pending()
        _cached_op.run_lazy(exclude=pending and pending["lazy"])
        if self._kvstore is None and self._try_fused_hybrid_step():
            return
        autograd.flush_pending()
        self._allreduce_grads()
        self._update()

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() is meaningless with "
                             "update_on_kvstore=True")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        keys, grads = [], []
        for i, p in enumerate(self._params):
            if p.grad_req != "null":
                keys.append(str(i))
                grads.append(p.list_grad())
        if not keys:
            return
        if self._update_on_kvstore:
            # the store runs the optimizer on its copy; _update pulls
            self._kvstore.push(keys, grads)
        else:
            # one batched call, so the 'xla' tier can fuse keys
            self._kvstore.pushpull(keys, grads, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError(
                "update() cannot be called when update_on_kvstore=True; "
                "use step()")
        self._optimizer.rescale_grad = self._scale / batch_size
        _cached_op.run_lazy()
        self._update()

    def _update(self):
        autograd.flush_pending()        # update() reads the .grad buffers
        if self._update_on_kvstore:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.pull(str(i), out=p.list_data())
            return
        if self._fused_update():
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            sparse_grad = p._grad_stype == "row_sparse"
            for j, (w, g) in enumerate(zip(p.list_data(), p.list_grad())):
                if j not in self._dev_updaters:
                    self._dev_updaters[j] = opt.get_updater(self._optimizer)
                self._optimizer._set_current_context(j)
                if sparse_grad:
                    # the stored rows only (one host read of the row
                    # mask): a lazy optimizer then touches just the rows
                    # this batch used
                    g = g.tostype("row_sparse")
                self._dev_updaters[j](i, g, w)
        self._optimizer._set_current_context(0)

    # ------------------------------------------------------- fused tiers
    def _fused_eligible(self):
        """A fused optimizer, one context, default storage and
        ``grad_req='write'`` (module docstring)."""
        if not getattr(self._optimizer, "fused", False) \
                or self._num_ctx() > 1:
            return False
        return all(p._grad_stype == "default" and p.grad_req == "write"
                   for p in self._params if p.grad_req != "null")

    def _fused_items(self):
        """The updated parameters ``[(index, param)]``, their states made."""
        items = [(i, p) for i, p in enumerate(self._params)
                 if p.grad_req != "null"]
        upd = self._updater
        for i, p in items:
            if i not in upd.states:
                upd.states[i] = \
                    self._optimizer.create_state_multi_precision(i, p.data())
            elif not upd.states_synced.get(i, True):
                # restored by load_states: onto the weight's device first
                upd.states[i] = opt.optimizer._on_ctx(upd.states[i],
                                                      p.data().context)
                upd.states_synced[i] = True
        return items

    def _fused_key(self, idx, weights, states):
        """An entry's key: the optimizer's type and ``_fused_key()``, the
        updated parameters' indices, and each one's shape, dtype and
        state (the entry binds those parameters' arrays)."""
        o = self._optimizer
        return (type(o), o._fused_key(), tuple(idx),
                tuple((tuple(w.shape), dtype_name(w._data.dtype),
                       _state_sig(s)) for w, s in zip(weights, states)))

    def _run_fused(self, entry, items, weights, grads, others):
        o = self._optimizer
        idx = [i for i, _p in items]
        states = [self._updater.states[i] for i in idx]
        before = _advance(o, idx)
        try:
            entry(weights, grads, others, states)
        except Exception:
            if not entry.applied:
                _fused_rollback(o, idx, before)
                entry.counts = None
            raise

    def _fused_update(self):
        """Every parameter's update as one :class:`_FusedUpdate` (module
        docstring); False when the step is not eligible."""
        if not self._fused_eligible():
            return False
        items = self._fused_items()
        if not items:
            return True
        idx = [i for i, _p in items]
        weights = [p.data() for _i, p in items]
        grads = [w._grad for w in weights]
        key = self._fused_key(idx, weights,
                              [self._updater.states[i] for i in idx])
        entry = self._fused_progs.get(key)
        if entry is None:
            device = weights[0]._data.device
            if device not in self._graphs:
                graphs = _cached_op._graph_backend(device)
                self._graphs[device] = (
                    graphs, graphs.pool() if graphs is not None else None)
            entry = self._fused_progs[key] = _FusedUpdate(
                self._optimizer, idx, device, *self._graphs[device])
        self._run_fused(entry, items, weights, grads, [])
        return True

    def _try_fused_hybrid_step(self):
        """Run a deferred backward and the update as one
        :class:`_FusedUpdate` of the replay's instance, with the forward
        too when its heads are lazy (module docstring); False when there
        is none or the step is not eligible (the backward, and a lazy
        forward before it, then run on their own first)."""
        pending = autograd.peek_pending()
        if pending is None or not self._fused_eligible():
            return False
        claim = pending["claim"]
        inst, arrays = claim.inst, claim.arrays
        prog = inst.prog
        items = [(i, p) for i, p in enumerate(self._params)
                 if p.grad_req != "null"]
        slot = {id(a): k for k, a in enumerate(arrays)}
        p_slots = [slot.get(id(p.data())) for _i, p in items]
        if not items or any(k is None or k not in prog.grad_pos
                            for k in p_slots):
            return False
        if not claim.current():
            # a weight changed since the forward: the backward runs on
            # its own first (and refuses to if it would see the change)
            return False
        items = self._fused_items()
        idx = [i for i, _p in items]
        o_slots = [k for k in prog.grad_pos if k not in p_slots
                   and arrays[k]._grad is not None
                   and arrays[k]._grad_req != "null"]
        weights = [arrays[k] for k in p_slots]
        states = [self._updater.states[i] for i in idx]
        head_idx = pending["head_idx"]
        lazy = pending["lazy"]
        full = lazy is not None and lazy.claim is not None
        key = (self._fused_key(idx, weights, states), head_idx,
               tuple(p_slots), tuple(o_slots))
        if full:
            key = ("full",) + key
        # this Trainer's entries: another Trainer over the same block
        # drives its own optimizer, counts and states
        entries = inst.fused.setdefault(self, {})
        self._fused_insts.add(inst)
        entry = entries.get(key)
        if entry is None:
            make = self._full_fused_step if full else self._fused_backward
            entry = entries[key] = _FusedUpdate(
                self._optimizer, idx, prog.device, prog.graphs, inst.pool,
                make(inst, head_idx, p_slots, o_slots))
        if full:
            lazy.start()
        try:
            self._run_fused(entry, items, weights,
                            [w._grad for w in weights],
                            [arrays[k]._grad for k in o_slots])
        except Exception as e:
            if full:
                if entry.applied and entry.outs is not None:
                    lazy.fill(entry.outs)
                else:
                    lazy.fail(e)
            raise
        finally:
            autograd.clear_pending()
        if full:
            lazy.fill(entry.outs)
        return True

    @staticmethod
    def _fused_backward(inst, head_idx, p_slots, o_slots):
        """The backward of a replay over its saved tensors, from ones over
        the heads: the gradients of the parameters and other inputs."""
        ones = [torch.ones_like(inst.outs[i]) for i in head_idx]
        prog = inst.prog

        def backward():
            grads = inst.gradients([inst.outs[i] for i in head_idx], ones)
            at = dict(zip(prog.grad_pos, grads))
            return [at[k] for k in p_slots], [at[k] for k in o_slots], None
        return backward

    @staticmethod
    def _full_fused_step(inst, head_idx, p_slots, o_slots):
        """The full step's forward over the instance's staged
        inputs in the recorded call's mode, then the backward from ones
        over the heads; the gradients and the forward's outputs."""
        prog = inst.prog
        ones = [torch.ones(prog.out_specs[i][0], dtype=prog.out_specs[i][1],
                           device=prog.device) for i in head_idx]

        def forward_backward():
            with _cached_op.recording(prog.sig[2]):
                outs = inst.run()
                grads = torch.autograd.grad(
                    [outs[i] for i in head_idx], inst.leaves(), ones,
                    allow_unused=True)
            at = dict(zip(prog.grad_pos, grads))
            return ([at[k] for k in p_slots], [at[k] for k in o_slots],
                    [o.detach() for o in outs])
        return forward_backward

    @property
    def _fused_step_progs(self):
        """This Trainer's entries of hybridized instances, by key (a full
        step's key starts with ``"full"``)."""
        return {key: entry for inst in list(self._fused_insts)
                for key, entry in inst.fused.get(self, {}).items()}

    def fused_stats(self):
        """The fused entries: ``(update_programs, binding_copies,
        replays, capture_s)``."""
        entries = list(self._fused_progs.values())
        return dict(update_programs=len(entries),
                    binding_copies=sum(e.copies for e in entries),
                    replays=sum(e.replays for e in entries),
                    capture_s=sum(e.capture_s for e in entries))

    def save_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Restore :meth:`save_states` into every device's updater, the
        ones not made yet included."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            payload = f.read()
        for j in range(self._num_ctx()):
            if j not in self._dev_updaters:
                self._dev_updaters[j] = opt.get_updater(self._optimizer)
        ctxs = self._params[0].list_ctx() if self._params else []
        for j, updater in self._dev_updaters.items():
            updater.set_states(payload,
                               ctx=ctxs[j] if j < len(ctxs) else None)
            updater.optimizer = self._optimizer
