"""Optimizer update operators of the PyTorch port.

The counterpart of ``mxnet_tpu.ops.optimizer_ops``: each update is a
plain tensor function returning the new weight and the new states
(``mxnet_tpu_torch.optimizer`` writes them back).  The JAX updates are
XLA ops, not Pallas kernels, so the port has no kernel here.
"""
from __future__ import annotations

import torch

from .registry import register


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        return torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _prep_grad(grad, rescale_grad, clip_gradient, wd, weight):
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


@register("sgd_update", num_inputs=2)
def sgd_update(weight, grad, *, lr: float = 0.01, wd: float = 0.0,
               rescale_grad: float = 1.0, clip_gradient: float = -1.0,
               lazy_update: bool = True):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * g


@register("sgd_mom_update", num_inputs=3, num_outputs=2)
def sgd_mom_update(weight, grad, mom, *, lr: float = 0.01,
                   momentum: float = 0.0, wd: float = 0.0,
                   rescale_grad: float = 1.0, clip_gradient: float = -1.0,
                   lazy_update: bool = True):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = momentum * mom - lr * g
    return weight + mom_new, mom_new


@register("nag_mom_update", num_inputs=3, num_outputs=2)
def nag_mom_update(weight, grad, mom, *, lr: float = 0.01,
                   momentum: float = 0.0, wd: float = 0.0,
                   rescale_grad: float = 1.0, clip_gradient: float = -1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = momentum * mom + g
    return weight - lr * (g + momentum * mom_new), mom_new


@register("mp_sgd_update", num_inputs=3, num_outputs=2)
def mp_sgd_update(weight, grad, weight32, *, lr: float = 0.01,
                  wd: float = 0.0, rescale_grad: float = 1.0,
                  clip_gradient: float = -1.0, lazy_update: bool = True):
    g = _prep_grad(grad.to(torch.float32), rescale_grad, clip_gradient, wd,
                   weight32)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_inputs=4, num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr: float = 0.01,
                      momentum: float = 0.0, wd: float = 0.0,
                      rescale_grad: float = 1.0, clip_gradient: float = -1.0,
                      lazy_update: bool = True):
    g = _prep_grad(grad.to(torch.float32), rescale_grad, clip_gradient, wd,
                   weight32)
    mom_new = momentum * mom - lr * g
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


@register("adam_update", num_inputs=4, num_outputs=3)
def adam_update(weight, grad, mean, var, *, lr: float = 0.001,
                beta1: float = 0.9, beta2: float = 0.999,
                epsilon: float = 1e-8, wd: float = 0.0,
                rescale_grad: float = 1.0, clip_gradient: float = -1.0,
                lazy_update: bool = True):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - lr * mean_new / (torch.sqrt(var_new) + epsilon),
            mean_new, var_new)


@register("adamw_update", num_inputs=5, num_outputs=3,
          aliases=["_adamw_update", "_contrib_adamw_update"])
def adamw_update(weight, grad, mean, var, rescale_grad_arr, *,
                 lr: float = 0.001, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, wd: float = 0.0, eta: float = 1.0,
                 clip_gradient: float = -1.0):
    """AdamW: decoupled weight decay."""
    g = _clip(grad * rescale_grad_arr, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - eta * (lr * mean_new / (torch.sqrt(var_new) + epsilon)
                        + wd * weight)
    return w, mean_new, var_new


@register("lamb_update_phase1", num_inputs=4)
def lamb_update_phase1(weight, grad, mean, var, *, beta1: float = 0.9,
                       beta2: float = 0.999, epsilon: float = 1e-6,
                       t: int = 1, bias_correction: bool = True,
                       wd: float = 0.0, rescale_grad: float = 1.0,
                       clip_gradient: float = -1.0):
    """LAMB phase 1: the update direction."""
    g = _clip(grad * rescale_grad, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mean_new = mean_new / (1.0 - beta1 ** t)
        var_new = var_new / (1.0 - beta2 ** t)
    return mean_new / (torch.sqrt(var_new) + epsilon) + wd * weight


@register("lamb_update_states", num_inputs=4, num_outputs=2)
def lamb_update_states(weight, grad, mean, var, *, beta1: float = 0.9,
                       beta2: float = 0.999, rescale_grad: float = 1.0,
                       clip_gradient: float = -1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return (beta1 * mean + (1 - beta1) * g,
            beta2 * var + (1 - beta2) * torch.square(g))


@register("lamb_update_phase2", num_inputs=4)
def lamb_update_phase2(weight, g, r1, r2, *, lr: float = 0.01,
                       lower_bound: float = -1.0, upper_bound: float = -1.0):
    """LAMB phase 2: the trust-ratio scaled step."""
    r1c = r1
    if lower_bound is not None and lower_bound > 0:
        r1c = torch.clamp(r1c, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1c = torch.clamp(r1c, max=upper_bound)
    ratio = torch.where((r1c > 0) & (r2 > 0), r1c / r2,
                        torch.ones_like(r1c))
    return weight - lr * ratio * g


@register("ftrl_update", num_inputs=4, num_outputs=3)
def ftrl_update(weight, grad, z, n, *, lr: float = 0.1, lamda1: float = 0.01,
                beta: float = 1.0, wd: float = 0.0, rescale_grad: float = 1.0,
                clip_gradient: float = -1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    n_new = n + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) > lamda1,
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd),
        torch.zeros_like(weight))
    return w, z_new, n_new


@register("rmsprop_update", num_inputs=3, num_outputs=2)
def rmsprop_update(weight, grad, n, *, lr: float = 0.001,
                   gamma1: float = 0.95, epsilon: float = 1e-8,
                   wd: float = 0.0, rescale_grad: float = 1.0,
                   clip_gradient: float = -1.0, clip_weights: float = -1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    return _clip(w, clip_weights), n_new


@register("rmspropalex_update", num_inputs=5, num_outputs=4)
def rmspropalex_update(weight, grad, n, g_acc, delta, *, lr: float = 0.001,
                       gamma1: float = 0.95, gamma2: float = 0.9,
                       epsilon: float = 1e-8, wd: float = 0.0,
                       rescale_grad: float = 1.0, clip_gradient: float = -1.0,
                       clip_weights: float = -1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
    g_new = gamma1 * g_acc + (1 - gamma1) * g
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        torch.clamp(n_new - torch.square(g_new), min=0.0) + epsilon)
    return _clip(weight + delta_new, clip_weights), n_new, g_new, delta_new


@register("signsgd_update", num_inputs=2)
def signsgd_update(weight, grad, *, lr: float = 0.01, wd: float = 0.0,
                   rescale_grad: float = 1.0, clip_gradient: float = -1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * torch.sign(g)


@register("signum_update", num_inputs=3, num_outputs=2)
def signum_update(weight, grad, mom, *, lr: float = 0.01,
                  momentum: float = 0.0, wd: float = 0.0,
                  rescale_grad: float = 1.0, clip_gradient: float = -1.0,
                  wd_lh: float = 0.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = momentum * mom - (1 - momentum) * g
    return (1 - lr * wd_lh) * weight + lr * torch.sign(mom_new), mom_new


@register("_contrib_multi_lars", num_inputs=4, aliases=["multi_lars"])
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, *, eta: float = 0.001,
               eps: float = 1e-8, rescale_grad: float = 1.0):
    """LARS learning rates over stacked squared norms: lr * eta |w| /
    (|g| + wd |w| + eps) where both norms are positive, else lr."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wds * w_norm + eps),
                        torch.ones_like(w_norm))
    return lrs * trust
