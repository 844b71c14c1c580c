"""Contrib operators of the PyTorch port: the interleaved multi-head
attention products, the SSD box loss, resizing and pooling, ROIAlign and
the index ops.

The counterpart of ``mxnet_tpu.ops.contrib`` (its GELUs live in
``ops.nn``).  Layouts are the reference's: self-attention qkv
interleaved as (L, B, H*3*D), per head [q | k | v]; enc-dec q (L_q, B,
H*D) and kv (L_kv, B, H*2*D); attention maps (B*H, L_q, L_kv).

``jax.image.resize(..., "linear")`` is half-pixel sampling whose
triangle kernel widens by the shrink factor when the output is smaller
(antialiasing) and whose weights are renormalised at the edges; it is
not ``F.interpolate``.  :func:`resize_linear` builds those weights as
the JAX package does and applies them as two small products.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register
from .tensor import linspace


@register("_contrib_div_sqrt_dim", aliases=["div_sqrt_dim"])
def div_sqrt_dim(data):
    """data / sqrt(last dim)."""
    return data / math.sqrt(data.shape[-1])


def _split_interleaved(qkv, heads, n):
    """(L, B, H*n*D) -> n tensors of (B*H, L, D)."""
    L, B, HnD = qkv.shape
    D = HnD // (heads * n)
    x = qkv.reshape(L, B, heads, n, D)
    return [x[:, :, :, i, :].permute(1, 2, 0, 3).reshape(B * heads, L, D)
            for i in range(n)]


def _merge_heads(out, B, heads):
    """(B*H, L, D) -> (L, B, H*D)."""
    _BH, L, D = out.shape
    return out.reshape(B, heads, L, D).permute(2, 0, 1, 3).reshape(
        L, B, heads * D)


@register("_contrib_interleaved_matmul_selfatt_qk",
          aliases=["interleaved_matmul_selfatt_qk"])
def interleaved_matmul_selfatt_qk(queries_keys_values, *, heads: int = 1):
    """(Q / sqrt(D)) K^T from the interleaved qkv."""
    q, k, _ = _split_interleaved(queries_keys_values, heads, 3)
    return torch.matmul(q * (1.0 / math.sqrt(q.shape[-1])),
                        k.transpose(1, 2))


@register("_contrib_interleaved_matmul_selfatt_valatt", num_inputs=2,
          aliases=["interleaved_matmul_selfatt_valatt"])
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, *,
                                      heads: int = 1):
    """attention @ V, back to (L, B, H*D)."""
    _, _, v = _split_interleaved(queries_keys_values, heads, 3)
    return _merge_heads(torch.matmul(attention, v),
                        queries_keys_values.shape[1], heads)


@register("_contrib_interleaved_matmul_encdec_qk", num_inputs=2,
          aliases=["interleaved_matmul_encdec_qk"])
def interleaved_matmul_encdec_qk(queries, keys_values, *, heads: int = 1):
    Lq, B, HD = queries.shape
    D = HD // heads
    q = queries.reshape(Lq, B, heads, D).permute(1, 2, 0, 3).reshape(
        B * heads, Lq, D)
    k, _ = _split_interleaved(keys_values, heads, 2)
    return torch.matmul(q * (1.0 / math.sqrt(D)), k.transpose(1, 2))


@register("_contrib_interleaved_matmul_encdec_valatt", num_inputs=2,
          aliases=["interleaved_matmul_encdec_valatt"])
def interleaved_matmul_encdec_valatt(keys_values, attention, *,
                                     heads: int = 1):
    _, v = _split_interleaved(keys_values, heads, 2)
    return _merge_heads(torch.matmul(attention, v), keys_values.shape[1],
                        heads)


def _linear_weights(n_in, n_out, dtype, device):
    """(n_in, n_out) weights of ``jax.image``'s linear resize along one
    axis: half-pixel sample points, a triangle kernel widened by the
    shrink factor (antialiasing), columns renormalised, samples outside
    the input zeroed."""
    scale = n_out / n_in
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(float(inv_scale), 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * float(inv_scale) - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def resize_linear(data, out_h, out_w):
    """``jax.image.resize(data, (n, c, out_h, out_w), "linear")`` of NCHW
    data (module docstring); an axis whose size does not change is left
    as it is."""
    _n, _c, h, w = data.shape
    out = data
    if out_h != h:
        wh = _linear_weights(h, out_h, data.dtype, data.device)
        out = torch.einsum("nchw,hH->ncHw", out, wh)
    if out_w != w:
        ww = _linear_weights(w, out_w, data.dtype, data.device)
        out = torch.einsum("nchw,wW->nchW", out, ww)
    return out


@register("_contrib_AdaptiveAvgPooling2D",
          aliases=["AdaptiveAvgPooling2D"])
def adaptive_avg_pooling2d(data, *, output_size=()):
    """Mean over equal bins when the sizes divide; otherwise the JAX
    package's linear resize (:func:`resize_linear`)."""
    if not output_size:
        oh = ow = 1
    elif isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size[0], output_size[-1]
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(
            dim=(3, 5))
    return resize_linear(data, oh, ow)


@register("_contrib_BilinearResize2D", aliases=["BilinearResize2D"])
def bilinear_resize2d(data, *, height: int = 1, width: int = 1,
                      scale_height=None, scale_width=None,
                      mode: str = "size", align_corners: bool = True):
    """Bilinear resize; ``align_corners=True`` (the reference's default)
    maps the corners exactly, ``False`` is :func:`resize_linear`."""
    _n, _c, h, w = data.shape
    if scale_height is not None:
        height = int(h * scale_height)
        width = int(w * scale_width)
    if not align_corners:
        return resize_linear(data, height, width)
    dev = data.device

    def grid(n_in, n_out):
        # a size-1 axis samples its centre (align-corners' 0/0)
        if n_out > 1:
            return linspace(0.0, n_in - 1.0, n_out, device=dev)
        return torch.full((1,), (n_in - 1) / 2.0, dtype=torch.float32,
                          device=dev)

    ys, xs = grid(h, height), grid(w, width)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0).to(data.dtype)[None, None, :, None]
    wx = (xs - x0).to(data.dtype)
    rows = data[:, :, y0, :] * (1 - wy) + data[:, :, y1, :] * wy
    return rows[:, :, :, x0] * (1 - wx) + rows[:, :, :, x1] * wx


@register("_contrib_ROIAlign", num_inputs=2, aliases=["ROIAlign"])
def roi_align(data, rois, *, pooled_size=(), spatial_scale: float = 1.0,
              sample_ratio: int = -1, position_sensitive: bool = False,
              aligned: bool = False):
    """ROIAlign: bilinear samples on a regular (ph*s, pw*s) grid in each
    ROI, averaged per bin; rois (R, 5) [batch_idx, x1, y1, x2, y2]."""
    ph, pw = pooled_size
    _n, c, h, w = data.shape
    R = rois.shape[0]
    dev = data.device
    offset = 0.5 if aligned else 0.0
    batch_idx = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    floor = 1e-6 if aligned else 1.0
    roi_w = torch.clamp(x2 - x1, min=floor)
    roi_h = torch.clamp(y2 - y1, min=floor)
    s = sample_ratio if sample_ratio > 0 else 2
    fy = (torch.arange(ph * s, device=dev) + 0.5) / (ph * s)
    fx = (torch.arange(pw * s, device=dev) + 0.5) / (pw * s)
    ys = y1[:, None] + roi_h[:, None] * fy[None, :]         # (R, ph*s)
    xs = x1[:, None] + roi_w[:, None] * fx[None, :]         # (R, pw*s)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy, wx = ys - y0, xs - x0
    flat = data[batch_idx].reshape(R, c, h * w)

    def corner(yy, xx):
        lin = (yy[:, :, None] * w + xx[:, None, :]).reshape(R, 1, -1)
        return torch.gather(flat, 2, lin.expand(R, c, lin.shape[-1])) \
            .reshape(R, c, yy.shape[1], xx.shape[1])

    v = (corner(y0, x0) * ((1 - wy)[:, :, None] * (1 - wx)[:, None, :])
         [:, None]
         + corner(y0, x1i) * ((1 - wy)[:, :, None] * wx[:, None, :])[:, None]
         + corner(y1i, x0) * (wy[:, :, None] * (1 - wx)[:, None, :])[:, None]
         + corner(y1i, x1i) * (wy[:, :, None] * wx[:, None, :])[:, None])
    return v.reshape(R, c, ph, s, pw, s).mean(dim=(3, 5))


@register("_contrib_index_copy", num_inputs=3, aliases=["index_copy"])
def index_copy(old, index, new):
    """``old`` with rows ``index`` replaced by ``new``'s."""
    return torch.index_copy(old, 0, index.to(torch.int64), new)


@register("_contrib_index_array", aliases=["index_array"])
def index_array(data, *, axes=None):
    """Each element's index over ``axes`` (all by default), stacked on a
    last axis.  int32: the JAX op asks for int64, but its package runs
    without x64."""
    shape = data.shape
    axes = tuple(range(len(shape))) if axes is None else tuple(axes)
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.int32,
                                          device=data.device)
                             for s in shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1)


@register("smooth_l1")
def smooth_l1(data, *, scalar: float = 1.0):
    """0.5 (s x)^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * torch.square(data),
                       absd - 0.5 / s2)
