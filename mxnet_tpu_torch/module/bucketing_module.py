"""BucketingModule: a bounded set of programs for variable-length input
(reference: ``python/mxnet/module/bucketing_module.py``).

The counterpart of ``mxnet_tpu.module.bucketing_module``: one Module (one
Executor, its CUDA graphs on the card) per bucket key, every parameter
one array object shared across the buckets, one optimizer and updater
for all of them.  ``bucket_keys`` fixed at construction caps the
buckets; ``num_compiles`` is the sum of the buckets' programs.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """reference: mx.mod.BucketingModule(sym_gen, default_bucket_key).

    sym_gen(bucket_key) -> (symbol, data_names, label_names)
    """

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, bucket_keys=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule: default_bucket_key required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        # with bucket_keys given, only those keys may ever be bound (a
        # hard cap on the programs)
        self._allowed_keys = set(bucket_keys) | {default_bucket_key} \
            if bucket_keys is not None else None
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    # ---------------------------------------------------------------- state
    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def active_buckets(self):
        return sorted(self._buckets)

    @property
    def num_compiles(self):
        """The programs of every bucket's executor."""
        return sum(m.num_compiles for m in self._buckets.values())

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    # ----------------------------------------------------------------- bind
    def _gen_module(self, bucket_key):
        if self._allowed_keys is not None and \
                bucket_key not in self._allowed_keys:
            raise MXNetError(
                f"bucket key {bucket_key!r} not in the registered bucket "
                f"set {sorted(self._allowed_keys)}; refusing an unbounded "
                f"set of programs")
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        # a rebind drops every bucket's executor (they would share the old
        # default module's arrays); the trained values survive as in
        # Module.bind
        preserved = None
        if self.binded and self.params_initialized:
            preserved = self.get_params()
        self._buckets = {}
        self.params_initialized = False
        self._bind_args = dict(for_training=for_training,
                               inputs_need_grad=inputs_need_grad,
                               grad_req=grad_req)
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, **self._bind_args)
        self._buckets[self._default_bucket_key] = module
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        if preserved is not None:
            module._restore_preserved(preserved)
            self.params_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Bind (or reuse) the executor for bucket_key, sharing parameters
        with the default bucket's module (reference: switch_bucket)."""
        if not self.binded:
            raise MXNetError("switch_bucket: call bind first")
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        shared_module=self._buckets[self._default_bucket_key],
                        **self._bind_args)
            if self.optimizer_initialized:
                module._optimizer = self._curr_module._optimizer
                module._updater = self._curr_module._updater
                module.optimizer_initialized = True
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # ------------------------------------------------------------- delegate
    def init_params(self, *args, **kwargs):
        self._curr_module.init_params(*args, **kwargs)
        self.params_initialized = True
        for m in self._buckets.values():
            m.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        self._curr_module.init_optimizer(*args, **kwargs)
        self.optimizer_initialized = True
        # one optimizer and updater for every bucket: the shared
        # parameters see one stream of states and update counts
        for m in self._buckets.values():
            m._optimizer = self._curr_module._optimizer
            m._updater = self._curr_module._updater
            m.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._curr_bucket_key
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._buckets[self._default_bucket_key].set_params(
            arg_params, aux_params, **kwargs)
        self.params_initialized = True

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
