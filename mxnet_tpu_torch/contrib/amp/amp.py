"""Automatic Mixed Precision.

The counterpart of ``mxnet_tpu.contrib.amp.amp`` (reference:
``python/mxnet/contrib/amp/amp.py``).  ``init()`` wraps the generated op
frontends of ``nd``, ``nd.op``, ``sym`` and ``sym.op``: the matrix-product
ops (``lists.TARGET_DTYPE_OPS``) cast their float inputs to the target
dtype, the numerically sensitive ones (``lists.FP32_OPS``) to float32,
and the multi-input elementwise ones (``lists.WIDEST_TYPE_CASTS``) to
their widest input dtype.  A Gluon block calls these frontends through
``F``, so eager calls, hybridized programs captured after ``init`` and
Symbols built after it all see the casts (``amp_cast`` nodes); a
program captured before ``init`` keeps its float32 graph.  The patching
is process-wide until ``_deinit()``.

Under bfloat16 the flash layers of the models take bf16 q / k / v from
their bf16 projections, so B1–B3 run their bf16 kernels; parameters and
gradients stay float32 (the casts sit inside the forward).  The port's
B1–B3 take float32 and bfloat16 only: under float16 a flash layer on the
card raises ``KernelError``.

``init_trainer(trainer)`` replaces ``trainer.step`` by a step that reads
the gradients' overflow flag on the host (``LossScaler.has_overflow``:
one ``all_finite`` and one host read a step) before the update: an
overflow skips the update and halves the scale.  Reading the gradients
runs a deferred backward first, so an AMP step is the forward (or its
graph), the backward (its graph), the host read, then the update (the
Trainer's update graph); the loss scale reaches that graph as
``rescale``, a device scalar the Trainer refreshes when it changes.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict

import torch

from ...base import MXNetError
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "list_lp16_ops", "list_fp32_ops"]

_LOG = logging.getLogger("mxnet_tpu_torch")
_amp_state: Dict = {"initialized": False, "target_dtype": None,
                    "originals": {}}


def list_lp16_ops(target_dtype="bfloat16"):
    return list(lists.TARGET_DTYPE_OPS)


def list_fp32_ops(target_dtype="bfloat16"):
    return list(lists.FP32_OPS)


def _dtype(a):
    from ...ndarray.ndarray import dtype_name
    return dtype_name(a._data.dtype)


def _wrap_cast(fn, dtype, float_only=True):
    """Wrap a frontend: cast array inputs to ``dtype`` before dispatch."""
    from ...ndarray import NDArray
    from ...symbol import Symbol
    from ... import ndarray as nd_mod

    def _cast(a):
        if isinstance(a, NDArray):
            if not float_only or torch.is_floating_point(a._data):
                if _dtype(a) != dtype:
                    return nd_mod.amp_cast(a, dtype=dtype)
            return a
        if isinstance(a, Symbol):
            from ...ops.registry import get_op
            from ...symbol.symbol import invoke_symbolic
            return invoke_symbolic(get_op("amp_cast"), (a,),
                                   {"dtype": dtype})
        if isinstance(a, (list, tuple)):
            return type(a)(_cast(x) for x in a)
        return a

    def wrapped(*args, **kwargs):
        return fn(*tuple(_cast(a) for a in args), **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "amp_wrapped")
    wrapped.__doc__ = fn.__doc__
    wrapped._amp_original = fn
    return wrapped


def _wrap_widest(fn):
    """Wrap a multi-input frontend: unify input dtypes to the widest."""
    from ...ndarray import NDArray
    from ... import ndarray as nd_mod
    from ...ndarray.ndarray import dtype_name

    def wrapped(*args, **kwargs):
        arrs = [a for a in args if isinstance(a, NDArray)]
        if len(arrs) > 1:
            widest = arrs[0]._data.dtype
            for a in arrs[1:]:
                widest = torch.promote_types(widest, a._data.dtype)
            widest = dtype_name(widest)
            args = tuple(nd_mod.amp_cast(a, dtype=widest)
                         if isinstance(a, NDArray) and _dtype(a) != widest
                         else a for a in args)
        return fn(*args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "amp_wrapped")
    wrapped._amp_original = fn
    return wrapped


def _patch_targets():
    """The namespaces holding generated frontends."""
    from ... import ndarray as nd_mod
    from ... import symbol as sym_mod
    return [nd_mod, nd_mod.op, sym_mod, sym_mod.op]


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP by patching the op namespaces (reference: amp.init).

    target_dtype: 'bfloat16' (the default) or 'float16'.
    target_precision_ops / fp32_ops: override the default lists.
    """
    if _amp_state["initialized"]:
        if _amp_state["target_dtype"] != target_dtype:
            raise MXNetError(
                f"amp.init already called with "
                f"{_amp_state['target_dtype']!r}")
        return
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError("target_dtype must be bfloat16 or float16")
    lp_ops = list(target_precision_ops if target_precision_ops is not None
                  else lists.TARGET_DTYPE_OPS)
    f32_ops = list(fp32_ops if fp32_ops is not None else lists.FP32_OPS)
    if conditional_fp32_ops:
        f32_ops += [name for name, _, _ in conditional_fp32_ops]
    overlap = set(lp_ops) & set(f32_ops)
    if overlap:
        raise MXNetError(f"ops in both lists: {sorted(overlap)}")

    targets = _patch_targets()
    originals = {}
    for names, wrapper in ((lp_ops, lambda f: _wrap_cast(f, target_dtype)),
                           (f32_ops, lambda f: _wrap_cast(f, "float32")),
                           (lists.WIDEST_TYPE_CASTS,
                            lambda f: _wrap_widest(f))):
        for opname in names:
            for mod in targets:
                fn = getattr(mod, opname, None)
                if fn is None or hasattr(fn, "_amp_original"):
                    continue
                originals[(id(mod), opname)] = (mod, opname, fn)
                setattr(mod, opname, wrapper(fn))
    _amp_state.update(initialized=True, target_dtype=target_dtype,
                      originals=originals)
    _LOG.info("AMP initialized (target dtype %s)", target_dtype)


def _deinit():
    """Undo init() (a test hook; the reference has no public one)."""
    for mod, opname, fn in _amp_state["originals"].values():
        setattr(mod, opname, fn)
    _amp_state.update(initialized=False, target_dtype=None, originals={})


def init_trainer(trainer):
    """Attach a dynamic LossScaler and an overflow-skipping step to a
    Gluon Trainer (reference: amp.init_trainer; module docstring)."""
    from ...gluon.trainer import Trainer
    if not isinstance(trainer, Trainer):
        raise MXNetError("init_trainer expects a gluon Trainer")
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return trainer
    scaler = LossScaler()
    trainer._amp_loss_scaler = scaler
    trainer._amp_original_step = trainer.step

    def amp_step(batch_size, ignore_stale_grad=False):
        if scaler.has_overflow(trainer._params):
            scaler.update_scale(True)
            _LOG.warning("AMP: gradient overflow, skipping step "
                         "(loss scale -> %g)", scaler.loss_scale)
            trainer._scale = 1.0
            return
        trainer._amp_original_step(batch_size, ignore_stale_grad)
        scaler.update_scale(False)
        trainer._scale = 1.0

    trainer.step = amp_step
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as l: l.backward()``:
    multiplies the loss by the current scale and makes the next
    ``trainer.step`` divide the gradients back (``Trainer._scale``)."""
    from ... import autograd
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    trainer._scale = 1.0 / scaler.loss_scale
    # scale inside a record scope, so that the multiply is on the tape
    # when scale_loss is entered outside `with autograd.record()`
    with autograd.record():
        if isinstance(loss, (list, tuple)):
            scaled = [l * scaler.loss_scale for l in loss]
        else:
            scaled = loss * scaler.loss_scale
    yield scaled


def unscale(trainer):
    """Divide the gradients by the loss scale in place (reference:
    amp.unscale), for gradient clipping between backward and step."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad_req == "null":
            continue
        for g in p.list_grad():
            g._set_data(g._data * inv)
    trainer._scale = 1.0


def convert_hybrid_block(block, target_dtype="bfloat16"):
    """Cast a HybridBlock's parameters to the target dtype for pure
    low-precision inference (reference: amp.convert_hybrid_block).  For
    training, use ``amp.init()`` and multi-precision optimizers."""
    block.cast(target_dtype)
    return block
