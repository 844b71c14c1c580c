"""Per-batch tensor monitor (reference: ``python/mxnet/monitor.py``).

The counterpart of ``mxnet_tpu.monitor``: ``Monitor(interval, stat_func,
pattern, sort)`` with ``tic`` / ``toc`` / ``toc_print`` over the three
frontends:

- **Gluon**: ``install(block)`` registers a forward hook on every
  sub-block, so activations are statted as they are produced;
- **Module**: ``install(module)`` (or ``Module.fit(monitor=...)``) stats
  the bound executor's arguments, gradients and outputs at ``toc``;
- **Executor**: ``install(executor)`` stats ``arg_dict`` / ``grad_dict``
  / ``outputs`` at ``toc``.

A stat reads its array on the host (the default ``||x||_2 /
sqrt(x.size)``), so a monitored batch synchronises with the card.  Two
kinds of output are not read where the hook sees them:

- a tensor of a hybridized block's program (``cached_op.in_program()``:
  the CachedOp runs the block's forward on its static buffers, on the
  card inside a CUDA-graph capture, where a host read would break the
  capture).  The hooks skip them, as the JAX package's skip its
  tracers: on a hybridized block only the outermost output and the
  parameters are statted, and the plain pass that resolves deferred
  shapes is statted like an eager call;
- a lazy output (a recorded call of a hybridized block whose forward
  runs inside ``Trainer.step``'s graph): its stat is taken at ``toc``,
  in its place in the queue, so that monitoring adds no graph launch to
  a step that calls ``toc`` after ``trainer.step``.

Usage::

    mon = mx.monitor.Monitor(interval=10, pattern=".*weight.*")
    mon.install(net)
    for batch in loader:
        mon.tic()
        ...forward/backward/step...
        mon.toc_print()
"""
from __future__ import annotations

import logging
import math
import re

import numpy as np

from .base import MXNetError

__all__ = ["Monitor"]

_LOG = logging.getLogger("mxnet_tpu_torch")


def _to_numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _in_program() -> bool:
    """A hybridized block's program is running its forward (module
    docstring): its tensors are not read."""
    from .gluon.cached_op import in_program
    return in_program()


def default_stat(arr) -> float:
    """``||x||_2 / sqrt(x.size)`` (the reference's default stat_func):
    scale-invariant enough to compare across layers, and NaN-propagating
    so that a poisoned tensor shows at once."""
    a = _to_numpy(arr)
    if a.size == 0:
        return 0.0
    return float(np.linalg.norm(a.astype(np.float64)) / math.sqrt(a.size))


class _Later:
    """A queued stat of a lazy output, taken at ``toc``."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr


class Monitor:
    """reference: mx.monitor.Monitor(interval, stat_func, pattern, sort)."""

    def __init__(self, interval=1, stat_func=None, pattern=".*",
                 sort=False, monitor_all=False):
        if interval < 1:
            raise MXNetError("Monitor: interval must be >= 1")
        self.interval = int(interval)
        self.stat_func = stat_func or default_stat
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self.activated = False
        self.step = 0
        self.queue = []             # (step, name, stat)
        self._blocks = []
        self._modules = []
        self._executors = []
        self._hooked = []           # (block, hook) pairs for uninstall()

    # ------------------------------------------------------------- install
    def install(self, target):
        """Attach to a Gluon ``Block``, a ``Module`` or an ``Executor``.
        Several targets may be monitored; installing the same target
        again does nothing (``Module.fit`` installs on every call)."""
        from .gluon.block import Block
        if isinstance(target, Block):
            self._install_block(target)
        elif hasattr(target, "arg_dict") and hasattr(target, "outputs"):
            if not any(target is e for e in self._executors):
                self._executors.append(target)
        elif hasattr(target, "bind") and hasattr(target, "get_outputs"):
            if not any(target is m for m in self._modules):
                self._modules.append(target)
        else:
            raise MXNetError(
                f"Monitor.install: cannot monitor {type(target).__name__} "
                f"(expected Gluon Block, Module, or Executor)")
        return self

    def _install_block(self, root):
        if any(root is b for b in self._blocks):
            return                  # already hooked: never twice
        self._blocks.append(root)
        monitor = self

        def _hook(block, _inputs, outputs):
            if not monitor.activated:
                return
            outs = outputs if isinstance(outputs, (list, tuple)) \
                else (outputs,)
            for i, o in enumerate(outs):
                name = f"{block.name}_output{i}" if len(outs) > 1 \
                    else f"{block.name}_output"
                monitor._stat_one(name, o)

        for blk in root._iter_blocks():
            blk.register_forward_hook(_hook)
            self._hooked.append((blk, _hook))

    def uninstall(self):
        """Remove every forward hook this monitor registered and forget
        the monitored targets."""
        for blk, hook in self._hooked:
            try:
                blk._forward_hooks.remove(hook)
            except ValueError:
                pass
        self._hooked = []
        self._blocks = []
        self._modules = []
        self._executors = []
        return self

    # ------------------------------------------------------------ stepping
    def tic(self):
        """Activate collection if this batch hits the interval; call
        before the forward pass."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the monitoring scope: stat the installed targets' weights
        and gradients (and the lazy outputs queued), deactivate, and
        return ``[(step, name, stat), ...]``."""
        if not self.activated:
            return []
        for blk in self._blocks:
            self._stat_params(blk.collect_params().items())
        for mod in self._modules:
            exe = getattr(mod, "_exec", None)
            if exe is not None:
                self._stat_executor(exe)
        for exe in self._executors:
            self._stat_executor(exe)
        self.activated = False
        queue = [(step, name, self._stat(v.arr) if isinstance(v, _Later)
                  else v) for step, name, v in self.queue]
        res = sorted(queue, key=lambda kv: kv[1]) if self.sort \
            else queue
        self.queue = []
        return res

    def toc_print(self):
        """``toc()``, then one log line per stat."""
        res = self.toc()
        for step, name, value in res:
            _LOG.info("Batch: %7d %30s %s", step, name, value)
        return res

    # ------------------------------------------------------------ internals
    def _stat(self, arr):
        try:
            return self.stat_func(arr)
        except Exception as e:      # noqa: BLE001 — a failed read
            return f"<error: {e}>"

    def _stat_one(self, name, arr):
        if not self.re_prog.match(name) or _in_program():
            return
        if getattr(arr, "_lazy", None) is not None:
            self.queue.append((self.step, name, _Later(arr)))
            return
        self.queue.append((self.step, name, self._stat(arr)))

    def _stat_params(self, items):
        for name, p in items:
            try:
                data = p.data()
            except Exception:       # noqa: BLE001 — uninitialized
                continue
            self._stat_one(name, data)
            if p.grad_req != "null":
                try:
                    grad = p.grad()
                except Exception:   # noqa: BLE001 — no grad attached
                    continue
                self._stat_one(name + "_grad", grad)

    def _stat_executor(self, exe):
        for name, arr in exe.arg_dict.items():
            self._stat_one(name, arr)
        for name, arr in exe.grad_dict.items():
            self._stat_one(name + "_grad", arr)
        if self.monitor_all:
            for name, arr in getattr(exe, "aux_dict", {}).items():
                self._stat_one(name, arr)
        for i, out in enumerate(getattr(exe, "outputs", []) or []):
            self._stat_one(f"output{i}", out)
