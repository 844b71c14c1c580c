"""Optimizers of the PyTorch port (reference:
``python/mxnet/optimizer/optimizer.py``).

The counterpart of ``mxnet_tpu.optimizer.optimizer``: each optimizer
runs its update through the ops of ``ops/optimizer_ops.py`` on one
parameter at a time and writes the new weight and states back.  One
optimizer drives the updaters of several device copies; per-device
update counts keep Adam-style bias corrections from advancing twice
(``_set_current_context``).  SGD and Adam take a row-sparse gradient
lazily (``lazy_update``, the default): only its stored rows, and their
momentum or moments, move; every other row keeps its bits, as in the
JAX package.

SGD, Adam and AdamW also have a fused form (``fused = True``):
``_fused_one`` is one parameter's update on tensors, from the same
``optimizer_ops`` functions, with the step-varying values (t, lr, wd,
rescale) as 0-d device tensors, so that ``gluon.Trainer`` can run every
parameter's update as one CUDA graph (``_fused_key`` holds what that
graph bakes in).
"""
from __future__ import annotations

import math
import pickle

import torch

from ..base import MXNetError
from .. import ndarray as nd
from ..ndarray import NDArray, dtype_name
from ..ops import optimizer_ops as oo

_REG = {}


def register(klass):
    _REG[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    klass = _REG.get(name.lower())
    if klass is None:
        raise MXNetError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(_REG)}")
    return klass(**kwargs)


def _low_precision(weight):
    return dtype_name(weight._data.dtype) in ("float16", "bfloat16")


class Optimizer:
    """Base optimizer: ``create_state(index, weight)`` and
    ``update(index, weight, grad, state)``."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self._all_index_update_counts = {0: self._index_update_count}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is "
                             "active")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _set_current_context(self, device_id):
        """Switch to ``device_id``'s update-count table."""
        if device_id not in self._all_index_update_counts:
            self._all_index_update_counts[device_id] = {}
        self._index_update_count = self._all_index_update_counts[device_id]

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _low_precision(weight):
            w32 = weight.astype("float32")
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    # the fused tier (module docstring)
    fused = False

    def _fused_key(self):
        """The hyperparameters a fused update bakes in."""
        return (self.clip_gradient, self.multi_precision)

    def _fused_one(self, w, g, state, t, lr, wd, rescale):
        """One parameter's update on tensors: ``(new_w, new_state)``,
        ``state`` shaped as ``create_state_multi_precision``'s with
        tensors in place of arrays."""
        raise NotImplementedError

    def _is_mp_state(self, weight, state):
        return (self.multi_precision and _low_precision(weight)
                and isinstance(state, tuple) and len(state) == 2
                and isinstance(state[0], NDArray)
                and state[0].shape == weight.shape)

    def update_multi_precision(self, index, weight, grad, state):
        """fp16 / bf16 weights: update the float32 master copy with the
        inner state, then cast back."""
        if self._is_mp_state(weight, state):
            w32, base_state = state
            self.update(index, w32, grad.astype("float32"), base_state)
            weight._set_data(w32._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("param_dict", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.param_dict = {}


def _apply(opname, arrays, **kwargs):
    """Run an update op; returns its new weight (and states)."""
    return nd.invoke_by_name(opname, arrays, kwargs)


def _zeros_like(weight):
    return nd.zeros(weight.shape, ctx=weight.context,
                    dtype=dtype_name(weight._data.dtype))


def _write(pairs):
    for dst, src in pairs:
        dst._set_data(src._data)


def _clip(opt):
    return opt.clip_gradient or -1.0


def _rsp_rows(grad):
    """``(row indices, row values)`` of a row-sparse gradient, else
    None.  ``Trainer``'s compression takes the indices from ``nonzero``
    of a row mask: unique, so the write-back below is deterministic."""
    from ..ndarray.sparse import RowSparseNDArray
    if isinstance(grad, RowSparseNDArray):
        return (grad._components["indices"].to(torch.int64),
                grad._components["data"])
    return None


def _lazy_rows(opt, index, weight, rows):
    """The stored rows' indices, their weights and their prepared
    gradient (rescaled, clipped, plus weight decay)."""
    idx, gvals = rows
    w = weight._data.detach()
    wr = w.index_select(0, idx)
    g = oo._prep_grad(gvals.to(w.dtype), opt.rescale_grad,
                      opt.clip_gradient, opt._get_wd(index), wr)
    return idx, wr, g


def _write_rows(arr, idx, rows):
    """``arr`` with the rows ``idx`` replaced by ``rows``; every other
    row keeps its bits."""
    out = arr._data.detach().clone()
    out.index_copy_(0, idx, rows.to(out.dtype))
    arr._set_data(out)


@register
class SGD(Optimizer):
    """SGD with momentum (``sgd_update`` / ``sgd_mom_update``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        rows = _rsp_rows(grad) if not isinstance(state, tuple) else None
        if rows is not None and self.lazy_update:
            # lazy row-sparse update (reference: sgd_update's
            # kRowSparseStorage path): only the stored rows move, and
            # only their momentum advances
            lr = self._get_lr(index)
            with torch.no_grad():
                idx, wr, g = _lazy_rows(self, index, weight, rows)
                if state is None:
                    new_rows = wr - lr * g
                else:
                    mr = self.momentum * state._data.index_select(0, idx) \
                        - lr * g
                    _write_rows(state, idx, mr)
                    new_rows = wr + mr
                _write_rows(weight, idx, new_rows)
            return
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad, clip_gradient=_clip(self))
        if isinstance(state, tuple):  # multi-precision
            w32, mom = state
            if mom is None:
                new_w, new_w32 = _apply("mp_sgd_update",
                                        [weight, grad, w32], **kw)
                _write([(weight, new_w), (w32, new_w32)])
            else:
                new_w, new_m, new_w32 = _apply(
                    "mp_sgd_mom_update", [weight, grad, mom, w32],
                    momentum=self.momentum, **kw)
                _write([(weight, new_w), (mom, new_m), (w32, new_w32)])
            return
        if state is None:
            _write([(weight, _apply("sgd_update", [weight, grad], **kw))])
        else:
            new_w, new_m = _apply("sgd_mom_update", [weight, grad, state],
                                  momentum=self.momentum, **kw)
            _write([(weight, new_w), (state, new_m)])

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    fused = True

    def _fused_key(self):
        return super()._fused_key() + (self.momentum,)

    def _fused_one(self, w, g, state, t, lr, wd, rescale):
        kw = dict(lr=lr, wd=wd, rescale_grad=rescale,
                  clip_gradient=_clip(self))
        if isinstance(state, tuple):    # multi-precision (w32, mom)
            w32, mom = state
            if mom is None:
                new_w, new_w32 = oo.mp_sgd_update(w, g, w32, **kw)
                return new_w, (new_w32, None)
            new_w, new_m, new_w32 = oo.mp_sgd_mom_update(
                w, g, mom, w32, momentum=self.momentum, **kw)
            return new_w, (new_w32, new_m)
        if state is None:
            return oo.sgd_update(w, g, **kw), None
        return oo.sgd_mom_update(w, g, state, momentum=self.momentum, **kw)


def _mp_split(w, g, state):
    """Adam-style state: the weight, gradient and moments the update runs
    on (the fp32 master and a float32 gradient under multi-precision),
    and whether it is multi-precision."""
    if isinstance(state, tuple) and len(state) == 2 \
            and isinstance(state[1], tuple):
        w32, (m, v) = state
        return w32, g.to(torch.float32), m, v, True
    m, v = state
    return w, g, m, v, False


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (``nag_mom_update``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_m = _apply(
            "nag_mom_update", [weight, grad, state],
            lr=self._get_lr(index), wd=self._get_wd(index),
            momentum=self.momentum, rescale_grad=self.rescale_grad,
            clip_gradient=_clip(self))
        _write([(weight, new_w), (state, new_m)])


class _Moments(Optimizer):
    """Optimizers whose state is two moments of the weight's shape."""

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))


@register
class Adam(_Moments):
    """Adam (``adam_update``), bias-corrected through the step size."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr *= math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)
        mean, var = state
        rows = _rsp_rows(grad) if isinstance(mean, NDArray) else None
        if rows is not None and self.lazy_update:
            # lazy Adam (reference: adam_update's kRowSparseStorage
            # path): only the stored rows advance their moments
            with torch.no_grad():
                idx, wr, g = _lazy_rows(self, index, weight, rows)
                mr = self.beta1 * mean._data.index_select(0, idx) \
                    + (1 - self.beta1) * g
                vr = self.beta2 * var._data.index_select(0, idx) \
                    + (1 - self.beta2) * g * g
                _write_rows(mean, idx, mr)
                _write_rows(var, idx, vr)
                _write_rows(weight, idx,
                            wr - lr * mr / (torch.sqrt(vr) + self.epsilon))
            return
        new_w, new_m, new_v = _apply(
            "adam_update", [weight, grad, mean, var],
            lr=lr, beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
            wd=self._get_wd(index), rescale_grad=self.rescale_grad,
            clip_gradient=_clip(self))
        _write([(weight, new_w), (mean, new_m), (var, new_v)])

    fused = True

    def _fused_key(self):
        return super()._fused_key() + (self.beta1, self.beta2,
                                       self.epsilon)

    def _fused_one(self, w, g, state, t, lr, wd, rescale):
        weff, geff, m, v, mp = _mp_split(w, g, state)
        lr_t = lr * torch.sqrt(1.0 - self.beta2 ** t) \
            / (1.0 - self.beta1 ** t)
        new_w, new_m, new_v = oo.adam_update(
            weff, geff, m, v, lr=lr_t, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, wd=wd, rescale_grad=rescale,
            clip_gradient=_clip(self))
        if mp:
            return new_w.to(w.dtype), (new_w, (new_m, new_v))
        return new_w, (new_m, new_v)


@register
class AdamW(_Moments):
    """AdamW: decoupled weight decay (``adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        # bias correction on the gradient term only; the decay is
        # scaled by lr alone
        corr = math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)
        mean, var = state
        rescale = nd.full((1,), self.rescale_grad, ctx=weight.context)
        new_w, new_m, new_v = _apply(
            "adamw_update", [weight, grad, mean, var, rescale],
            lr=corr, eta=lr, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, wd=self._get_wd(index),
            clip_gradient=_clip(self))
        _write([(weight, new_w), (mean, new_m), (var, new_v)])

    fused = True

    def _fused_key(self):
        return super()._fused_key() + (self.beta1, self.beta2,
                                       self.epsilon)

    def _fused_one(self, w, g, state, t, lr, wd, rescale):
        weff, geff, m, v, mp = _mp_split(w, g, state)
        corr = torch.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        new_w, new_m, new_v = oo.adamw_update(
            weff, geff, m, v, rescale, lr=corr, eta=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            clip_gradient=_clip(self))
        if mp:
            return new_w.to(w.dtype), (new_w, (new_m, new_v))
        return new_w, (new_m, new_v)


@register
class LAMB(_Moments):
    """LAMB (``lamb_update_phase1`` / ``_phase2``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        g = _apply("lamb_update_phase1", [weight, grad, mean, var],
                   beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                   t=t, bias_correction=self.bias_correction,
                   wd=self._get_wd(index), rescale_grad=self.rescale_grad,
                   clip_gradient=_clip(self))
        new_m, new_v = _apply("lamb_update_states",
                              [weight, grad, mean, var],
                              beta1=self.beta1, beta2=self.beta2,
                              rescale_grad=self.rescale_grad)
        new_w = _apply("lamb_update_phase2", [weight, g, weight.norm(),
                                              g.norm()],
                       lr=self._get_lr(index),
                       lower_bound=self.lower_bound or -1.0,
                       upper_bound=self.upper_bound or -1.0)
        _write([(weight, new_w), (mean, new_m), (var, new_v)])


@register
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_update`` / ``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_like(weight) for _ in range(n))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  gamma1=self.gamma1, epsilon=self.epsilon,
                  rescale_grad=self.rescale_grad, clip_gradient=_clip(self))
        if self.centered:
            outs = _apply("rmspropalex_update", [weight, grad, *state],
                          gamma2=self.gamma2,
                          clip_weights=self.clip_weights or -1.0, **kw)
        else:
            outs = _apply("rmsprop_update", [weight, grad, *state], **kw)
        _write(zip((weight,) + tuple(state), outs))


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.op.clip(grad, a_min=-self.clip_gradient,
                              a_max=self.clip_gradient)
        hist = state + grad * grad
        state._set_data(hist._data)
        up = grad / (hist.sqrt() + self.float_stable_eps) + wd * weight
        weight._set_data((weight - lr * up)._data)


@register
class AdaDelta(_Moments):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.op.clip(grad, a_min=-self.clip_gradient,
                              a_max=self.clip_gradient)
        acc_g, acc_delta = state
        new_acc_g = self.rho * acc_g + (1. - self.rho) * grad * grad
        delta = ((acc_delta + self.epsilon).sqrt()
                 / (new_acc_g + self.epsilon).sqrt()) * grad
        new_acc_delta = self.rho * acc_delta + (1. - self.rho) * delta * delta
        acc_g._set_data(new_acc_g._data)
        acc_delta._set_data(new_acc_delta._data)
        weight._set_data((weight - delta - wd * weight)._data)


@register
class Ftrl(_Moments):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        new_w, new_z, new_n = _apply(
            "ftrl_update", [weight, grad, z, n],
            lr=self._get_lr(index), lamda1=self.lamda1, beta=self.beta,
            wd=self._get_wd(index), rescale_grad=self.rescale_grad,
            clip_gradient=_clip(self))
        _write([(weight, new_w), (z, new_z), (n, new_n)])


@register
class SignSGD(Optimizer):
    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _write([(weight, _apply(
            "signsgd_update", [weight, grad], lr=self._get_lr(index),
            wd=self._get_wd(index), rescale_grad=self.rescale_grad,
            clip_gradient=_clip(self)))])


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_m = _apply(
            "signum_update", [weight, grad, state],
            lr=self._get_lr(index), momentum=self.momentum,
            wd=self._get_wd(index), wd_lh=self.wd_lh,
            rescale_grad=self.rescale_grad, clip_gradient=_clip(self))
        _write([(weight, new_w), (state, new_m)])


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling on momentum SGD."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w_norm = float(weight.norm().asscalar())
        g_norm = float((grad * self.rescale_grad).norm().asscalar())
        if w_norm > 0 and g_norm > 0:
            lr *= self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self))
        if state is None:
            _write([(weight, _apply("sgd_update", [weight, grad], **kw))])
        else:
            new_w, new_m = _apply("sgd_mom_update", [weight, grad, state],
                                  momentum=self.momentum, **kw)
            _write([(weight, new_w), (state, new_m)])


@register
class Test(Optimizer):
    """Trivial optimizer of the unit tests: ``w -= rescale_grad * g``."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context)

    def update(self, index, weight, grad, state):
        weight._set_data((weight - self.rescale_grad * grad)._data)


def _on_ctx(state, ctx):
    """``state`` (an array, a tuple of them or None) on ``ctx``."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_on_ctx(s, ctx) for s in state)
    return state if state.context == ctx else state.as_in_context(ctx)


class Updater:
    """Per-key optimizer states (reference: ``get_updater``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        elif not self.states_synced.get(index, True):
            self.states[index] = _on_ctx(self.states[index], weight.context)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        payload = {k: _states_to_np(v) for k, v in self.states.items()}
        return pickle.dumps((payload, self.optimizer)
                            if dump_optimizer else payload)

    def set_states(self, states, ctx=None):
        """Restore :meth:`get_states`; the states land on ``ctx`` (the
        current context) and move to each weight's context at its next
        update."""
        data = pickle.loads(states)
        if isinstance(data, tuple):
            payload, self.optimizer = data
        else:
            payload = data
        self.states = {k: _states_from_np(v, ctx)
                       for k, v in payload.items()}
        self.states_synced = {k: False for k in self.states}


def _states_to_np(state):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_states_to_np(s) for s in state)
    return state.asnumpy()


def _states_from_np(state, ctx=None):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_states_from_np(s, ctx) for s in state)
    return nd.array(state, ctx=ctx, dtype=state.dtype)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
