"""ShardedTrainer on one card: forward, backward and the optimizer update
of a block, step by step.

The PyTorch port of ``mxnet_tpu.parallel.ShardedTrainer`` at dp = 1.
The trainer holds its own copy of the block's parameters (cast to
``dtype`` where floating, as the JAX ``_own`` does), runs the block
through ``torch.func.functional_call`` — the counterpart of
``functionalize`` — and updates the trainable ones (``requires_grad``)
in place with the optimizers of :mod:`.optim`.  ``write_back()`` copies
the trained values, buffers included, into the block.

Not in this slice: ``compression``, ``rules``, ``step_timeout_ms`` and
``slow_step_factor`` (and the ``StepWatchdog`` behind the last two) come
with the multi-GPU and supervisor items of ROADMAP.md; passing them is a
``TypeError``.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import functional_call

from .. import faults as _faults
from .. import perf_account as _pa
from .. import runtime_metrics as _rm
from ..base import MXNetError
from . import optim as _optim

__all__ = ["ShardedTrainer"]

_OPTIMS = {
    "sgd": (_optim.sgd_init, _optim.sgd_update),
    "adamw": (_optim.adamw_init, _optim.adamw_update),
    "lamb": (_optim.lamb_init, _optim.lamb_update),
}


class ShardedTrainer:
    """A training step for an ``nn.Module`` on a one-card :class:`Mesh`.

    ``loss_fn(outputs, *labels) -> scalar`` is written in torch over raw
    tensors.  ``step(*batch)`` takes the block's ``n_inputs =
    len(example_inputs)`` inputs followed by ``n_labels`` labels (numpy
    arrays or tensors), moves them to the mesh's device, and returns the
    loss tensor of that step (before the update).  ``example_inputs``
    only sets how many inputs the block takes: the port traces nothing.
    """

    def __init__(self, block, loss_fn, mesh, optimizer="adamw",
                 optimizer_params=None, example_inputs=(), n_labels=1,
                 dtype=None):
        if optimizer not in _OPTIMS:
            raise MXNetError(f"unknown optimizer {optimizer!r}; "
                             f"known: {sorted(_OPTIMS)}")
        self.mesh = mesh
        self.device = mesh.device
        self.block = block
        self.loss_fn = loss_fn
        # step-time attribution / MFU / bottleneck verdict — inert (one
        # attribute load + branch in step()) until MXNET_TRACE or
        # MXNET_RUNTIME_METRICS turns it on
        self.perf = _pa.StepAttribution()
        self._flops_noted = False
        opt_init, self._opt_update = _OPTIMS[optimizer]
        opt_kw = dict(optimizer_params or {})
        if "learning_rate" in opt_kw:
            opt_kw["lr"] = opt_kw.pop("learning_rate")
        if "weight_decay" in opt_kw:            # Gluon naming -> optim's
            opt_kw["wd"] = opt_kw.pop("weight_decay")
        self._opt_kw = opt_kw

        def own(t):
            t = t.detach()
            if dtype is not None and t.is_floating_point():
                return t.to(self.device, dtype, copy=True)
            return t.to(self.device, copy=True)

        self.trainable = frozenset(n for n, p in block.named_parameters()
                                   if p.requires_grad)
        self.params = {n: own(p).requires_grad_(n in self.trainable)
                       for n, p in block.named_parameters()}
        self.buffers = {n: own(b) for n, b in block.named_buffers()}
        self._train_params = {n: p for n, p in self.params.items()
                              if n in self.trainable}
        self.opt_state = opt_init(self._train_params)
        self._n_inputs = len(example_inputs)
        self._n_labels = int(n_labels)

    # ------------------------------------------------------------ steps
    def _to_device(self, batch):
        out = []
        for b in batch:
            if isinstance(b, np.ndarray):
                b = torch.from_numpy(b)
            elif not isinstance(b, torch.Tensor):
                b = torch.as_tensor(b)
            out.append(b.to(self.device, non_blocking=True))
        return tuple(out)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward_backward(self, batch):
        """Loss and gradients of the trainable parameters; the block
        runs in train mode (dropout on) and is left as it was."""
        _faults.inject("train.step")
        if len(batch) != self._n_inputs + self._n_labels:
            raise MXNetError(
                f"ShardedTrainer.step: expected {self._n_inputs} inputs + "
                f"{self._n_labels} labels, got {len(batch)} arrays")
        inputs = batch[:self._n_inputs]
        labels = batch[self._n_inputs:]
        was_training = self.block.training
        self.block.train(True)
        try:
            out = functional_call(self.block, (self.params, self.buffers),
                                  inputs)
            loss = self.loss_fn(out, *labels)
        finally:
            self.block.train(was_training)
        names = list(self._train_params)
        grads = torch.autograd.grad(
            loss, [self._train_params[n] for n in names], allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        return loss.detach(), {
            n: torch.zeros_like(self._train_params[n]) if g is None else g
            for n, g in zip(names, grads)}

    def _update(self, grads):
        self._opt_update(self._train_params, grads, self.opt_state,
                         **self._opt_kw)

    def step(self, *batch):
        """One training step; returns the loss tensor of this step.

        ``faults.inject("train.step")`` is the chaos hook of the whole
        step.  With tracing or runtime metrics on, the step runs
        attributed (:meth:`_step_attributed`): each phase is timed into
        a ``train.*`` span and closed by a device synchronisation."""
        if self.perf.active:
            return self._step_attributed(batch)
        loss, grads = self._forward_backward(self._to_device(batch))
        self._update(grads)
        return loss

    def _step_attributed(self, batch):
        """The observed variant of :meth:`step`: ``train.h2d``,
        ``train.compute`` (forward + backward) and ``train.optimizer``
        tile the ``train.step`` span, each ending in a device
        synchronisation; ``train.collective`` is a zero-length marker
        (one card)."""
        if not self._flops_noted and _rm._ENABLED:
            self._flops_noted = True
            self.perf.note_flops(_pa.step_flops(self, batch))
        h = self.perf.step_start()
        with h:
            t0 = time.perf_counter()
            dev_batch = self._to_device(batch)
            self._sync()
            t1 = time.perf_counter()
            h.record("h2d", t0, t1)
            loss, grads = self._forward_backward(dev_batch)
            self._sync()
            t2 = time.perf_counter()
            h.record("compute", t1, t2)
            h.mark("collective", devices=1)
            self._update(grads)
            self._sync()
            h.record("optimizer", t2, time.perf_counter())
        return loss

    def write_back(self):
        """Copy the trained parameters, and the buffers the steps
        updated (BatchNorm running statistics), back into the block (in
        the block's own dtypes)."""
        with torch.no_grad():
            for n, p in self.block.named_parameters():
                p.copy_(self.params[n])
            for n, b in self.block.named_buffers():
                b.copy_(self.buffers[n])
