"""Neural-network operators of the PyTorch port, and the registry
frontends of its attention kernels.

The counterpart of the part of ``mxnet_tpu.ops.nn`` (and of the
registry frontends in ``mxnet_tpu/ops/pallas_kernels.py`` and
``ops/contrib.py``) that the Gluon layers and losses call.  Layouts are
the reference's (NC*, weight (O, I/g, *k)).  Dropout and BatchNorm read
``autograd.is_training()`` when they are called, as the JAX ops do.

The kernel frontends call the port's wrappers:
``_contrib_flash_selfatt`` / ``_contrib_flash_selfatt_nomask`` run
``ops.flash_attention.flash_selfatt`` (B1 forward; B2 and B3 in its
backward), ``_contrib_ragged_paged_attention`` runs
``ops.paged_attention.ragged_paged_attention`` (B4).  A CUDA tensor
launches the kernel or raises ``KernelError``; a CPU tensor takes the
kernel's plain version.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import autograd
from .registry import register


def _act(data, act_type):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise ValueError(f"unknown act_type {act_type!r}")


@register("Activation", aliases=["activation"])
def Activation(data, *, act_type: str = "relu"):
    return _act(data, act_type)


def _leaky_nin(kwargs):
    return 2 if kwargs.get("act_type", "leaky") == "prelu" else 1


@register("LeakyReLU", num_inputs=_leaky_nin)
def LeakyReLU(data, gamma=None, *, act_type: str = "leaky",
              slope: float = 0.25, lower_bound: float = 0.125,
              upper_bound: float = 0.334):
    """Leaky-family activations: leaky, prelu, elu, selu, gelu, rrelu."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 and data.dim() > 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data,
                                   alpha * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        return torch.where(data >= 0, data,
                           data * (lower_bound + upper_bound) / 2)
    raise ValueError(f"unknown act_type {act_type!r}")


@register("_contrib_gelu_erf", aliases=["gelu"])
def gelu_erf(data):
    return F.gelu(data)


@register("_contrib_gelu_tanh", aliases=["gelu_tanh"])
def gelu_tanh(data):
    return F.gelu(data, approximate="tanh")


@register("softmax")
def softmax(data, *, axis: int = -1, temperature=None, dtype=None,
            use_length: bool = False):
    x = data / temperature if temperature else data
    out = torch.softmax(x, dim=axis)
    return out.to(_dtype(dtype)) if dtype else out


@register("log_softmax")
def log_softmax(data, *, axis: int = -1, temperature=None, dtype=None):
    x = data / temperature if temperature else data
    out = torch.log_softmax(x, dim=axis)
    return out.to(_dtype(dtype)) if dtype else out


def _dtype(name):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(name)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax whose backward is ``softmax - onehot(label)``, whatever
    the incoming cotangent (the reference's loss-layer semantics)."""

    @staticmethod
    def forward(ctx, data, label):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, grad):
        out, label = ctx.saved_tensors
        oh = F.one_hot(label.to(torch.int64).reshape(out.shape[:-1]),
                       out.shape[-1]).to(out.dtype)
        return out - oh, None


@register("SoftmaxOutput", num_inputs=2, aliases=["Softmax"])
def SoftmaxOutput(data, label, *, grad_scale: float = 1.0,
                  ignore_label: float = -1.0, multi_output: bool = False,
                  use_ignore: bool = False, preserve_shape: bool = False,
                  normalization: str = "null", out_grad: bool = False,
                  smooth_alpha: float = 0.0):
    if multi_output:
        x = torch.movedim(data, 1, -1)
        out = _SoftmaxOutput.apply(x, label.reshape(x.shape[:-1]))
        return torch.movedim(out, -1, 1)
    return _SoftmaxOutput.apply(data, label)


@register("softmax_cross_entropy", num_inputs=2)
def softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1, label.to(torch.int64).unsqueeze(-1)).sum()


@register("FullyConnected",
          num_inputs=lambda kw: 2 if kw.get("no_bias") else 3)
def FullyConnected(data, weight, bias=None, *, num_hidden: int = 0,
                   no_bias: bool = False, flatten: bool = True):
    """y = x W^T + b; weight (num_hidden, input_dim)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return F.linear(x, weight, bias)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Convolution",
          num_inputs=lambda kw: 2 if kw.get("no_bias") else 3)
def Convolution(data, weight, bias=None, *, kernel=(), stride=(), dilate=(),
                pad=(), num_filter: int = 0, num_group: int = 1,
                no_bias: bool = False, layout=None, cudnn_off: bool = False,
                cudnn_tune=None, workspace: int = 1024):
    """N-d convolution, NC* layout, weight (O, I/g, *k)."""
    k = len(kernel)
    return _CONV[k](data, weight, bias, stride=tuple(stride) or 1,
                    padding=tuple(pad) or 0, dilation=tuple(dilate) or 1,
                    groups=num_group)


@register("Deconvolution",
          num_inputs=lambda kw: 2 if kw.get("no_bias", True) else 3)
def Deconvolution(data, weight, bias=None, *, kernel=(), stride=(),
                  dilate=(), pad=(), adj=(), num_filter: int = 0,
                  num_group: int = 1, no_bias: bool = True, target_shape=(),
                  layout=None, cudnn_off: bool = False, cudnn_tune=None,
                  workspace: int = 512):
    """Transposed convolution; weight (I, O/g, *k)."""
    k = len(kernel)
    return _DECONV[k](data, weight, bias, stride=tuple(stride) or 1,
                      padding=tuple(pad) or 0,
                      output_padding=tuple(adj) or 0, groups=num_group,
                      dilation=tuple(dilate) or 1)


@register("Pooling", aliases=["pooling"])
def Pooling(data, *, kernel=(), pool_type: str = "max", stride=(), pad=(),
            global_pool: bool = False, cudnn_off: bool = False,
            pooling_convention: str = "valid", count_include_pad: bool = True,
            layout=None):
    """Max / avg / sum pooling, NC* layout."""
    nsp = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, dim=axes, keepdim=True)
        if pool_type in ("avg", "lp"):
            return data.mean(dim=axes, keepdim=True)
        return data.sum(dim=axes, keepdim=True)
    k = tuple(kernel)
    stride = tuple(stride) or (1,) * nsp
    pad = tuple(pad) or (0,) * nsp
    ceil = pooling_convention == "full"
    if pool_type == "max":
        fn = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nsp]
        return fn(data, k, stride, pad, ceil_mode=ceil)
    fn = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[nsp]
    out = fn(data, k, stride, pad, ceil_mode=ceil,
             count_include_pad=count_include_pad)
    if pool_type == "sum":
        out = out * float(math.prod(k))
    return out


def _bn_nout(kwargs):
    return 3 if kwargs.get("output_mean_var") else 1


@register("BatchNorm", num_inputs=5, num_outputs=_bn_nout,
          aliases=["batch_norm"])
def BatchNorm(data, gamma, beta, moving_mean, moving_var, *,
              eps: float = 1e-3, momentum: float = 0.9,
              fix_gamma: bool = True, use_global_stats: bool = False,
              output_mean_var: bool = False, axis: int = 1,
              cudnn_off: bool = False):
    """Batch normalisation: batch statistics (in float32) when training,
    the moving statistics otherwise."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    if autograd.is_training() and not use_global_stats:
        red = tuple(i for i in range(data.dim()) if i != axis)
        data32 = data.to(torch.float32)
        mean = data32.mean(dim=red)
        var = data32.var(dim=red, unbiased=False)
    else:
        mean, var = moving_mean, moving_var
    inv_std = torch.rsqrt(var + eps)
    out = (data - mean.to(data.dtype).reshape(shape)) \
        * inv_std.to(data.dtype).reshape(shape) \
        * gamma.reshape(shape) + beta.reshape(shape)
    if output_mean_var:
        return out, mean, inv_std
    return out


@register("LayerNorm", num_inputs=3, num_outputs=_bn_nout,
          aliases=["layer_norm"])
def LayerNorm(data, gamma, beta, *, axis: int = -1, eps: float = 1e-5,
              output_mean_var: bool = False):
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    inv_std = torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = (data - mean) * inv_std * gamma.reshape(shape) \
        + beta.reshape(shape)
    if output_mean_var:
        return out, mean.squeeze(axis), inv_std.squeeze(axis)
    return out


@register("InstanceNorm", num_inputs=3)
def InstanceNorm(data, gamma, beta, *, eps: float = 1e-3):
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("GroupNorm", num_inputs=3)
def GroupNorm(data, gamma, beta, *, num_groups: int = 1, eps: float = 1e-5):
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + tuple(data.shape[2:]))
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = x.var(dim=red, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register("Dropout")
def Dropout(data, *, p: float = 0.5, mode: str = "training", axes=(),
            cudnn_off: bool = False):
    """Dropout, scaled by 1/(1-p), drawn from the default generator of
    the data's device; the identity outside training unless
    ``mode='always'``."""
    if (not autograd.is_training() and mode != "always") or p <= 0:
        return data
    shape = tuple(1 if i in tuple(axes) else s
                  for i, s in enumerate(data.shape)) if axes \
        else tuple(data.shape)
    keep = torch.rand(shape, device=data.device) < (1.0 - p)
    return torch.where(keep, data / (1.0 - p),
                       torch.zeros((), dtype=data.dtype,
                                   device=data.device)).to(data.dtype)


@register("Embedding", num_inputs=2)
def Embedding(data, weight, *, input_dim: int = 0, output_dim: int = 0,
              dtype: str = "float32", sparse_grad: bool = False):
    idx = torch.clamp(data.to(torch.int64), 0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


def _ctc_single(logprobs, label, t_len, l_len):
    """-log p(label | logprobs) for one sequence: logprobs (T, C) with
    blank at channel 0, label (L,) of 1..C-1."""
    T = logprobs.shape[0]
    L = label.shape[0]
    S = 2 * L + 1
    neg_inf = torch.tensor(-1e30, dtype=logprobs.dtype,
                           device=logprobs.device)
    z = torch.zeros(S, dtype=torch.int64, device=logprobs.device)
    z[1::2] = label
    s_idx = torch.arange(S, device=logprobs.device)
    z_prev2 = torch.cat([z.new_zeros(2), z[:-2]])
    can_skip = (s_idx % 2 == 1) & (z != z_prev2)
    alpha = torch.full((S,), -1e30, dtype=logprobs.dtype,
                       device=logprobs.device)
    alpha = torch.cat([logprobs[0, 0:1],
                       (logprobs[0, z[1]] if l_len > 0 else neg_inf)
                       .reshape(1), alpha[2:]])
    for t in range(1, min(int(t_len), T)):
        a1 = torch.cat([neg_inf.reshape(1), alpha[:-1]])
        a2 = torch.cat([neg_inf.expand(2), alpha[:-2]])
        a2 = torch.where(can_skip, a2, neg_inf)
        alpha = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) \
            + logprobs[t, z]
    end1 = alpha[2 * l_len]
    end2 = alpha[2 * l_len - 1] if l_len > 0 else neg_inf
    return -torch.logaddexp(end1, end2)


@register("CTCLoss", num_inputs=4, aliases=["ctc_loss", "_contrib_CTCLoss",
                                            "_contrib_ctc_loss"])
def CTCLoss(data, label, data_lengths=None, label_lengths=None, *,
            use_data_lengths: bool = False, use_label_lengths: bool = False,
            blank_label: str = "first"):
    """CTC loss: data (T, N, C) activations, label (N, L) padded with 0
    (blank at channel 0, ``blank_label='first'``)."""
    T, N, _C = data.shape
    logprobs = torch.log_softmax(data, dim=-1)
    label = label.to(torch.int64)
    if blank_label == "last":
        logprobs = torch.cat([logprobs[..., -1:], logprobs[..., :-1]],
                             dim=-1)
        label = label + 1
    t_lens = data_lengths.to(torch.int64).tolist() \
        if data_lengths is not None and use_data_lengths else [T] * N
    l_lens = label_lengths.to(torch.int64).tolist() \
        if label_lengths is not None and use_label_lengths \
        else (label > 0).sum(dim=1).tolist()
    return torch.stack([
        _ctc_single(logprobs[:, n], label[n], t_lens[n], int(l_lens[n]))
        for n in range(N)]).to(data.dtype)


# ---------------------------------------------------------------------------
# kernel frontends (layout of the interleaved MHA ops: qkv (L, B, H*3*D)
# -> out (L, B, H*D))
# ---------------------------------------------------------------------------
@register("_contrib_flash_selfatt", num_inputs=2, aliases=["flash_selfatt"])
def flash_selfatt(queries_keys_values, valid_length, *, heads: int = 1,
                  causal: bool = False, window: int = -1):
    """Flash self-attention (B1 forward, B2/B3 backward) over the
    interleaved layout; ``valid_length``: (B,) valid key lengths."""
    from .flash_attention import flash_selfatt as _kernel
    return _kernel(queries_keys_values, valid_length, heads=heads,
                   causal=causal, window=window)


@register("_contrib_flash_selfatt_nomask", num_inputs=1,
          aliases=["flash_selfatt_nomask"])
def flash_selfatt_nomask(queries_keys_values, *, heads: int = 1,
                         causal: bool = False, window: int = -1):
    """:func:`flash_selfatt` without a padding mask."""
    from .flash_attention import flash_selfatt_nomask as _kernel
    return _kernel(queries_keys_values, heads=heads, causal=causal,
                   window=window)


@register("_contrib_ragged_paged_attention", num_inputs=5,
          differentiable=False, aliases=["ragged_paged_attention_op"])
def ragged_paged_attention_op(q, k_pages, v_pages, block_tables,
                              context_lens):
    """Decode attention over a paged KV pool (B4); block tables and
    context lengths of any numeric dtype are cast to int32."""
    from .paged_attention import ragged_paged_attention
    return ragged_paged_attention(q, k_pages, v_pages,
                                  block_tables.to(torch.int32),
                                  context_lens.to(torch.int32))
