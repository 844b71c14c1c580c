"""Trainer of the PyTorch port: optimizer and kvstore orchestration
(reference: ``python/mxnet/gluon/trainer.py``).

The counterpart of ``mxnet_tpu.gluon.trainer`` without its fused tiers:
a step sums the per-context gradients through the kvstore
(``pushpull``), rescales by ``1 / batch_size`` and updates every context
copy with its own :class:`~mxnet_tpu_torch.optimizer.Updater`, all of
them driving one optimizer (per-device update counts keep bias
corrections from advancing twice).

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

from ..base import MXNetError
from .. import optimizer as opt
from .. import runtime_metrics as _rm
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


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
        card, goes to ``trainer.step.seconds``."""
        if not _rm._ENABLED:
            self._step_impl(batch_size)
            return
        t0 = time.perf_counter()
        try:
            self._step_impl(batch_size)
        finally:
            self._sync()
            _rm.TRAINER_STEP_SECONDS.observe(time.perf_counter() - t0)

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
        self._update()

    def _update(self):
        if self._update_on_kvstore:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.pull(str(i), out=p.list_data())
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            for j, (w, g) in enumerate(zip(p.list_data(), p.list_grad())):
                if j not in self._dev_updaters:
                    self._dev_updaters[j] = opt.get_updater(self._optimizer)
                self._optimizer._set_current_context(j)
                self._dev_updaters[j](i, g, w)
        self._optimizer._set_current_context(0)

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
