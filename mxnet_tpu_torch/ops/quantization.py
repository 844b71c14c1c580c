"""INT8 quantization operators of the PyTorch port: quantize /
dequantize / requantize and the quantized FC, convolution, pooling,
flatten and ReLU.

The counterpart of ``mxnet_tpu.ops.quantization``: signed int8 with the
symmetric scale ``s = max(|min|, |max|) / 127`` (a [0, 0] range gets
1/127), values ``round(x / s)`` clipped to [-127, 127]; int32
accumulators carry the range +-(2^31 - 1) s_a s_b.  Only ``int8`` is
supported (another ``out_type`` raises, as in the JAX package).

The int8 x int8 products accumulate exactly: torch has no int32 matmul
or convolution on CUDA, so they run in float64, where every partial sum
of a K-term product is an integer below K * 127^2 < 2^53, hence exact;
the int32 result equals the JAX op's ``preferred_element_type=int32``
one bit for bit.  The scale arithmetic is the JAX op's float32
arithmetic, step for step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import _CONV
from .registry import register

INT8_MAX = 127.0
INT32_MAX = 2147483647.0


def _f32(v, like):
    """A range argument (an array or a number) as a 0-d float32 tensor on
    ``like``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _sym_scale(min_r, max_r):
    """The symmetric int8 scale of a range; 1/127 for [0, 0]."""
    amax = torch.maximum(torch.abs(min_r), torch.abs(max_r))
    return torch.where(amax > 0, amax, torch.ones_like(amax)) / INT8_MAX


def _to_int8(real, scale):
    return torch.clamp(torch.round(real / scale), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


@register("_contrib_quantize", num_inputs=3, num_outputs=3,
          differentiable=False, aliases=["quantize"])
def quantize(data, min_range, max_range, *, out_type: str = "int8"):
    """float32 -> int8 over an explicit range: (q, min_out, max_out)."""
    if out_type != "int8":
        raise ValueError("only signed int8 quantization is supported")
    scale = _sym_scale(_f32(min_range, data), _f32(max_range, data))
    amax = scale * INT8_MAX
    return _to_int8(data, scale), -amax, amax


@register("_contrib_quantize_v2", num_outputs=3, differentiable=False,
          aliases=["quantize_v2"])
def quantize_v2(data, *, out_type: str = "int8", min_calib_range=None,
                max_calib_range=None):
    """float32 -> int8 over the calibration range if given, else the
    data's own min and max."""
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    else:
        mn = torch.amin(data).to(torch.float32)
        mx = torch.amax(data).to(torch.float32)
    return quantize(data, mn, mx, out_type=out_type)


@register("_contrib_dequantize", num_inputs=3, differentiable=False,
          aliases=["dequantize"])
def dequantize(qdata, min_range, max_range, *, out_type: str = "float32"):
    """int8 (or int32) -> float32."""
    mn, mx = _f32(min_range, qdata), _f32(max_range, qdata)
    qmax = INT8_MAX if qdata.dtype == torch.int8 else INT32_MAX
    scale = torch.maximum(torch.abs(mn), torch.abs(mx)) / qmax
    return qdata.to(torch.float32) * scale


@register("_contrib_requantize", num_inputs=3, num_outputs=3,
          differentiable=False, aliases=["requantize"])
def requantize(qdata, min_range, max_range, *, min_calib_range=None,
               max_calib_range=None):
    """int32 -> int8 over the calibrated (else the observed) range."""
    mn, mx = _f32(min_range, qdata), _f32(max_range, qdata)
    real = qdata.to(torch.float32) * (
        torch.maximum(torch.abs(mn), torch.abs(mx)) / INT32_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        omn, omx = _f32(min_calib_range, qdata), _f32(max_calib_range,
                                                      qdata)
    else:
        omn, omx = torch.amin(real), torch.amax(real)
    out_scale = _sym_scale(omn, omx)
    amax = out_scale * INT8_MAX
    return _to_int8(real, out_scale), -amax, amax


def _int32_range(mn_d, mx_d, mn_w, mx_w):
    amax = _sym_scale(mn_d, mx_d) * _sym_scale(mn_w, mx_w) * INT32_MAX
    return -amax, amax


def _rescale_bias(bias_q, min_bias, max_bias, out_scale):
    """int8 bias -> int32-accumulator units."""
    s_b = _sym_scale(_f32(min_bias, bias_q), _f32(max_bias, bias_q))
    return torch.round(bias_q.to(torch.float32) * (s_b / out_scale)).to(
        torch.int32)


@register("_contrib_quantized_fully_connected", num_inputs=9, num_outputs=3,
          differentiable=False, aliases=["quantized_fully_connected"])
def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias, max_bias, *,
                              num_hidden: int = 0, no_bias: bool = False,
                              flatten: bool = True):
    """int8 FC, int32 accumulation: (out_int32, min_out, max_out)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x.to(torch.float64),
                       weight.to(torch.float64).t()).to(torch.int32)
    mn_d, mx_d = _f32(min_data, data), _f32(max_data, data)
    mn_w, mx_w = _f32(min_weight, data), _f32(max_weight, data)
    omn, omx = _int32_range(mn_d, mx_d, mn_w, mx_w)
    if not no_bias and bias is not None:
        out_scale = _sym_scale(mn_d, mx_d) * _sym_scale(mn_w, mx_w)
        out = out + _rescale_bias(bias, min_bias, max_bias, out_scale)
    return out, omn, omx


@register("_contrib_quantized_conv", num_inputs=9, num_outputs=3,
          differentiable=False, aliases=["quantized_conv"])
def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias, max_bias, *, kernel=(), stride=(),
                   dilate=(), pad=(), num_filter: int = 0,
                   num_group: int = 1, no_bias: bool = False,
                   layout: str = "NCHW"):
    """int8 convolution, int32 accumulation."""
    ndim = data.dim() - 2
    out = _CONV[ndim](
        data.to(torch.float64), weight.to(torch.float64),
        stride=tuple(stride) or 1, padding=tuple(pad) or 0,
        dilation=tuple(dilate) or 1, groups=num_group).to(torch.int32)
    mn_d, mx_d = _f32(min_data, data), _f32(max_data, data)
    mn_w, mx_w = _f32(min_weight, data), _f32(max_weight, data)
    omn, omx = _int32_range(mn_d, mx_d, mn_w, mx_w)
    if not no_bias and bias is not None:
        out_scale = _sym_scale(mn_d, mx_d) * _sym_scale(mn_w, mx_w)
        b = _rescale_bias(bias, min_bias, max_bias, out_scale)
        out = out + b.reshape((1, -1) + (1,) * ndim)
    return out, omn, omx


@register("_contrib_quantized_pooling", num_inputs=3, num_outputs=3,
          differentiable=False, aliases=["quantized_pooling"])
def quantized_pooling(data, min_data, max_data, *, kernel=(), stride=(),
                      pad=(), pool_type: str = "max",
                      global_pool: bool = False):
    """Pooling on int8, range kept: max, or the window's int32 sum
    floor-divided by the window size.  The windows run in float64
    (exact for these integers)."""
    ndim = data.dim() - 2
    if global_pool:
        kernel, stride, pad = data.shape[2:], (1,) * ndim, (0,) * ndim
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(stride) or (1,) * ndim
    pad = tuple(pad) or (0,) * ndim
    x = data.to(torch.float64)
    if pool_type == "max":
        fn = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[ndim]
        out = fn(x, kernel, stride, pad).to(torch.int8)
    elif pool_type == "avg":
        n = 1
        for k in kernel:
            n *= k
        fn = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[ndim]
        total = torch.round(fn(x, kernel, stride, pad,
                               count_include_pad=True) * n)
        out = torch.div(total, n, rounding_mode="floor").to(torch.int8)
    else:
        raise ValueError(f"unsupported quantized pool_type {pool_type!r}")
    return out, _f32(min_data, data), _f32(max_data, data)


@register("_contrib_quantized_flatten", num_inputs=3, num_outputs=3,
          differentiable=False, aliases=["quantized_flatten"])
def quantized_flatten(data, min_data, max_data):
    return (data.reshape(data.shape[0], -1), _f32(min_data, data),
            _f32(max_data, data))


@register("_contrib_quantized_act", num_inputs=3, num_outputs=3,
          differentiable=False, aliases=["quantized_act"])
def quantized_act(data, min_data, max_data, *, act_type: str = "relu"):
    """ReLU on int8: range [0, max]."""
    if act_type != "relu":
        raise ValueError("only relu is supported on the int8 path")
    mn, mx = _f32(min_data, data), _f32(max_data, data)
    return (torch.clamp(data, min=0), torch.zeros_like(mn),
            torch.clamp(mx, min=0.0))
