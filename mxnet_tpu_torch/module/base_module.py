"""BaseModule: the fit / score / predict loop (reference:
``python/mxnet/module/base_module.py``).

The counterpart of ``mxnet_tpu.module.base_module``: epochs -> batches ->
``forward_backward`` / ``update`` -> ``update_metric`` -> callbacks; a
batch's work is the executor's forward and backward programs (CUDA
graphs on the card) and the optimizer's per-parameter update.
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError
from .. import metric as metric_mod
from .. import ndarray as nd
from .. import runtime_metrics as _rm
from .. import tracing as _tr

__all__ = ["BaseModule"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_metric(m):
    if isinstance(m, metric_mod.EvalMetric):
        return m
    return metric_mod.create(m)


class BaseModule:
    """Abstract module: subclasses implement bind / init_params /
    forward / backward / update / get_outputs / update_metric."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- abstract ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # -- the shared loop ------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The reference's training loop (BaseModule.fit)."""
        if num_epoch is None:
            raise MXNetError("fit: num_epoch must be given")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        init_kwargs = dict(arg_params=arg_params, aux_params=aux_params,
                           allow_missing=allow_missing,
                           force_init=force_init)
        if initializer is not None:
            # None = the module's default initializer; an explicit
            # init_params(initializer=None) keeps the current values
            init_kwargs["initializer"] = initializer
        self.init_params(**init_kwargs)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        eval_metric = _as_metric(eval_metric)
        validation_metric = (_as_metric(validation_metric)
                             if validation_metric else eval_metric)
        if monitor is not None:
            monitor.install(self)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                t_step = time.perf_counter() if _rm._ENABLED else None
                self.forward_backward(data_batch)
                self.update()
                if t_step is not None:
                    ctx = _tr.current_context()
                    _rm.TRAINER_STEP_SECONDS.observe(
                        time.perf_counter() - t_step,
                        exemplar=ctx.trace_id if ctx is not None
                        else None)
                if monitor is not None:
                    monitor.toc_print()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    param = _BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
            names, vals = eval_metric.get()
            for name, val in zip(_as_list(names), _as_list(vals)):
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
            train_data.reset()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0):
        """The metric over ``eval_data`` (BaseModule.score)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("score: module must be binded and initialized")
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = _BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        if score_end_callback is not None:
            param = _BatchEndParam(epoch=epoch, nbatch=nbatch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        names, vals = eval_metric.get()
        return list(zip(_as_list(names), _as_list(vals)))

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        """The outputs over ``eval_data``, concatenated, the last batch's
        padding rows dropped (BaseModule.predict)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("predict: module must be binded and initialized")
        if reset:
            eval_data.reset()
        out_batches = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            outs = self.get_outputs()
            if eval_batch.pad:
                keep = eval_batch.data[0].shape[0] - eval_batch.pad
                outs = [o[0:keep] for o in outs]
            out_batches.append(outs)
        if not merge_batches:
            return out_batches
        num_outputs = len(out_batches[0]) if out_batches else 0
        merged = [nd.concat(*[b[i] for b in out_batches], dim=0)
                  for i in range(num_outputs)]
        return merged[0] if num_outputs == 1 else merged

    @property
    def symbol(self):
        return self._symbol


class _BatchEndParam:
    __slots__ = ("epoch", "nbatch", "eval_metric", "locals")

    def __init__(self, epoch, nbatch, eval_metric, locals):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals
