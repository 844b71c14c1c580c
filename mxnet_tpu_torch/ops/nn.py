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
from .contrib import resize_linear
from .registry import get_op, register
from .tensor import linspace


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


def _batchnorm_aux_update(args, kwargs):
    """``OpDef.aux_update`` of BatchNorm: in a training interpretation
    the executor writes the moving statistics moved toward the batch's
    (the reference's batch_norm.cc moves them inside Forward)."""
    if kwargs.get("use_global_stats") or kwargs.get("output_mean_var"):
        return None
    out, mean, inv_std = BatchNorm(*args,
                                   **dict(kwargs, output_mean_var=True))
    eps = float(kwargs.get("eps", 1e-3))
    mom = float(kwargs.get("momentum", 0.9))
    with torch.no_grad():
        var = 1.0 / (inv_std * inv_std) - eps
        return (out,), {
            3: mom * args[3] + (1.0 - mom) * mean.to(args[3].dtype),
            4: mom * args[4] + (1.0 - mom) * var.to(args[4].dtype),
        }


get_op("BatchNorm").aux_update = _batchnorm_aux_update


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


@register("Dropout", mutates_rng=True)
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


# ---------------------------------------------------------------------------
# the rest of the reference's nn ops (the long tail of ``mxnet_tpu.ops.nn``)
# ---------------------------------------------------------------------------
@register("softmin")
def softmin(data, *, axis: int = -1, temperature=None, dtype=None):
    """softmax(-data); ``temperature`` and ``dtype`` are accepted and
    ignored, as by the JAX op."""
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation")
def SoftmaxActivation(data, *, mode: str = "instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


@register("L2Normalization")
def L2Normalization(data, *, eps: float = 1e-10, mode: str = "instance"):
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.square(data).sum(dim=red, keepdim=True)
                             + eps)


@register("LRN")
def LRN(data, *, alpha: float = 1e-4, beta: float = 0.75,
        knorm: float = 2.0, nsize: int = 5):
    """Local response normalisation across channels."""
    half = nsize // 2
    sq = F.pad(torch.square(data).movedim(1, -1), (half, half)).movedim(
        -1, 1)
    windows = sum(sq[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha * windows / nsize, beta)


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha: float = 0.2, beta: float = 0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("UpSampling", num_inputs=None)
def UpSampling(*data, scale: int = 1, sample_type: str = "nearest",
               num_args: int = 1, num_filter: int = 0,
               multi_input_mode: str = "concat", workspace: int = 512):
    """Nearest (repeat) or bilinear (``jax.image``'s linear resize, see
    ``ops.contrib.resize_linear``) upsampling; several inputs are
    concatenated on the channels."""
    outs = []
    for d in data:
        if sample_type == "nearest":
            outs.append(torch.repeat_interleave(
                torch.repeat_interleave(d, scale, dim=2), scale, dim=3))
        else:
            outs.append(resize_linear(d, d.shape[2] * scale,
                                      d.shape[3] * scale))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


@register("BilinearSampler", num_inputs=2)
def BilinearSampler(data, grid, *, cudnn_off: bool = False):
    """Bilinear samples of (N, C, H, W) data at grid (N, 2, Ho, Wo) [x; y]
    in [-1, 1], edges clamped."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    wx, wy = gx - x0, gy - y0
    flat = data.reshape(n, c, h * w)

    def gather(yy, xx):
        lin = (torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1)) \
            .reshape(n, 1, -1)
        return torch.gather(flat, 2, lin.expand(n, c, lin.shape[-1])) \
            .reshape((n, c) + tuple(gx.shape[1:]))

    return (gather(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
            + gather(y0, x0 + 1) * (wx * (1 - wy))[:, None]
            + gather(y0 + 1, x0) * ((1 - wx) * wy)[:, None]
            + gather(y0 + 1, x0 + 1) * (wx * wy)[:, None])


@register("GridGenerator")
def GridGenerator(data, *, transform_type: str = "affine", target_shape=()):
    """Affine sampling grid (N, 2, h, w) from theta (N, 6)."""
    h, w = target_shape
    ys = linspace(-1.0, 1.0, h, device=data.device)
    xs = linspace(-1.0, 1.0, w, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)], dim=0)
    out = torch.matmul(data.reshape(-1, 2, 3), base)
    return out.reshape(-1, 2, h, w)


@register("SpatialTransformer", num_inputs=2)
def SpatialTransformer(data, loc, *, target_shape=(),
                       transform_type: str = "affine",
                       sampler_type: str = "bilinear",
                       cudnn_off: bool = False):
    """GridGenerator then BilinearSampler."""
    return BilinearSampler(data, GridGenerator(
        loc, transform_type=transform_type, target_shape=target_shape))


@register("im2col")
def im2col(data, *, kernel=(), stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """Sliding-window patches, NCHW -> (N, C*kh*kw, L)."""
    return F.unfold(data, tuple(kernel), dilation=tuple(dilate),
                    padding=tuple(pad), stride=tuple(stride))


@register("col2im")
def col2im(data, *, output_size=(), kernel=(), stride=(1, 1),
           dilate=(1, 1), pad=(0, 0)):
    """The adjoint of :func:`im2col`: patches summed back into NCHW."""
    return F.fold(data, tuple(output_size), tuple(kernel),
                  dilation=tuple(dilate), padding=tuple(pad),
                  stride=tuple(stride))


@register("ROIPooling", num_inputs=2)
def ROIPooling(data, rois, *, pooled_size=(), spatial_scale: float = 1.0):
    """Max over ROI bins, the JAX package's way: each bin sampled on a
    static sub-grid dense enough (``ceil(H/ph)`` a side, at least 2)
    that samples lie at most a pixel apart, then the nearest pixels'
    max.  Not upstream's integer bins."""
    ph, pw = pooled_size
    _n, c, h, w = data.shape
    R = rois.shape[0]
    dev = data.device
    batch_idx = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    bin_h = torch.clamp(y2 - y1 + 1, min=1.0) / ph
    bin_w = torch.clamp(x2 - x1 + 1, min=1.0) / pw
    sgy = max(2, -(-h // ph))
    sgx = max(2, -(-w // pw))
    iy = (torch.arange(ph * sgy, device=dev) + 0.5) / sgy
    ix = (torch.arange(pw * sgx, device=dev) + 0.5) / sgx
    yi = torch.clamp(torch.floor(y1[:, None] + iy[None, :] * bin_h[:, None]),
                     0, h - 1).to(torch.int64)
    xi = torch.clamp(torch.floor(x1[:, None] + ix[None, :] * bin_w[:, None]),
                     0, w - 1).to(torch.int64)
    imgs = data[batch_idx]
    rows = torch.gather(imgs, 2, yi[:, None, :, None].expand(
        R, c, yi.shape[1], w))
    vals = torch.gather(rows, 3, xi[:, None, None, :].expand(
        R, c, yi.shape[1], xi.shape[1]))
    return vals.reshape(R, c, ph, sgy, pw, sgx).amax(dim=(3, 5))


@register("Correlation", num_inputs=2)
def Correlation(data1, data2, *, kernel_size: int = 1,
                max_displacement: int = 1, stride1: int = 1,
                stride2: int = 1, pad_size: int = 0,
                is_multiply: bool = True):
    """FlowNet cost volume: one channel per displacement of the stride2
    grid, each the channel- and window-summed product (or absolute
    difference) of data1 with data2 shifted, over kernel_size^2 * C.
    The shift is ``torch.roll`` (it wraps round, as the JAX op's
    ``jnp.roll`` does), not a zero-padded shift."""
    N, C, H, W = data1.shape
    kr = (kernel_size - 1) // 2
    border = max_displacement + kr
    pH, pW = H + 2 * pad_size, W + 2 * pad_size
    if pH - 2 * border < 1 or pW - 2 * border < 1:
        raise ValueError(
            f"Correlation: displacement border {border} "
            f"(max_displacement + kernel radius) leaves no valid output "
            f"for padded input {pH}x{pW}; increase pad_size or shrink "
            f"max_displacement/kernel_size")
    top_h = -(-(pH - 2 * border) // stride1)
    top_w = -(-(pW - 2 * border) // stride1)
    grid_r = max_displacement // stride2
    sumelems = float(kernel_size * kernel_size * C)
    pad = (pad_size,) * 4
    p1 = F.pad(data1, pad)
    p2 = F.pad(data2, pad)
    start = border - kr
    span_h = (top_h - 1) * stride1 + 1
    span_w = (top_w - 1) * stride1 + 1
    planes = []
    for dy in range(-grid_r * stride2, grid_r * stride2 + 1, stride2):
        for dx in range(-grid_r * stride2, grid_r * stride2 + 1, stride2):
            shifted = torch.roll(p2, (-dy, -dx), dims=(2, 3))
            prod = p1 * shifted if is_multiply else torch.abs(p1 - shifted)
            s = prod.sum(dim=1)
            if kernel_size > 1:
                oh = s.shape[1] - kernel_size + 1
                ow = s.shape[2] - kernel_size + 1
                s = sum(s[:, i:i + oh, j:j + ow]
                        for i in range(kernel_size)
                        for j in range(kernel_size))
            sub = s[:, start:start + span_h:stride1,
                    start:start + span_w:stride1]
            planes.append(sub / sumelems)
    return torch.stack(planes, dim=1)


# ---------------------------------------------------------------------------
# fused RNN: the flat cuDNN-layout parameter vector, a plain recurrence
# over T
# ---------------------------------------------------------------------------
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _rnn_nout(kwargs):
    if not kwargs.get("state_outputs", False):
        return 1
    return 3 if kwargs.get("mode", "lstm") == "lstm" else 2


def _unpack_rnn_params(params, mode, num_layers, input_size, H, D):
    """Split the flat parameter vector: every i2h / h2h weight (layer
    major, direction minor), then every bias pair in the same order."""
    G = _GATES[mode]
    weights, offset = [], 0
    for layer in range(num_layers):
        for _d in range(D):
            in_sz = input_size if layer == 0 else H * D
            for shape in ((G * H, in_sz), (G * H, H)):
                n = shape[0] * shape[1]
                weights.append(params[offset:offset + n].reshape(shape))
                offset += n
    biases = []
    for _ in range(2 * num_layers * D):
        biases.append(params[offset:offset + G * H])
        offset += G * H
    return weights, biases


def _run_layer(x, mode, w_i2h, w_h2h, b_i2h, b_h2h, h, c, reverse):
    """x (T, N, I) -> (T, N, H), h_T, c_T; gate orders: LSTM i, f, g, o;
    GRU r, z, n with n = tanh(x_n + r * (W_hn h + b_hn))."""
    xin = torch.flip(x, dims=(0,)) if reverse else x
    gates_i = torch.matmul(xin, w_i2h.t()) + b_i2h
    ys = []
    for t in range(xin.shape[0]):
        g_h = torch.matmul(h, w_h2h.t()) + b_h2h
        if mode == "lstm":
            i, f, g, o = torch.chunk(gates_i[t] + g_h, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            ir, iz, inn = torch.chunk(gates_i[t], 3, dim=-1)
            hr, hz, hn = torch.chunk(g_h, 3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(gates_i[t] + g_h)
        else:
            h = torch.relu(gates_i[t] + g_h)
        ys.append(h)
    ys = torch.stack(ys)
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys, h, c


@register("RNN", num_inputs=lambda kw: 4 if kw.get("mode") == "lstm" else 3,
          num_outputs=_rnn_nout, mutates_rng=True)
def RNN(data, parameters, state, state_cell=None, *, state_size: int = 0,
        num_layers: int = 1, mode: str = "lstm", bidirectional: bool = False,
        p: float = 0.0, state_outputs: bool = False, projection_size=None,
        use_sequence_length: bool = False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan: bool = False):
    """Fused multi-layer (bidirectional) LSTM / GRU / tanh / relu RNN over
    TNC input with the flat cuDNN-layout parameter vector.  Dropout of
    ``p`` between layers only in training, drawn from the default
    generator of the data's device.  ``projection_size``,
    ``use_sequence_length`` and the ``lstm_state_clip_*`` arguments are
    accepted and ignored, as by the JAX op."""
    _T, _N, I = data.shape
    D = 2 if bidirectional else 1
    weights, biases = _unpack_rnn_params(parameters, mode, num_layers, I,
                                         state_size, D)
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(D):
            li = layer * D + d
            ys, h_T, c_T = _run_layer(
                x, mode, weights[2 * li], weights[2 * li + 1],
                biases[2 * li], biases[2 * li + 1], state[li],
                state_cell[li] if mode == "lstm" else None, reverse=d == 1)
            outs.append(ys)
            h_states.append(h_T)
            if mode == "lstm":
                c_states.append(c_T)
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if p > 0 and layer < num_layers - 1 and autograd.is_training():
            keep = torch.rand(x.shape, device=x.device) < (1.0 - p)
            x = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    if not state_outputs:
        return x
    h_out = torch.stack(h_states, dim=0)
    if mode == "lstm":
        return x, h_out, torch.stack(c_states, dim=0)
    return x, h_out
