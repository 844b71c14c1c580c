"""Vision transforms (reference: gluon/data/vision/transforms.py; the
counterpart of ``mxnet_tpu.gluon.data.vision.transforms``).  The random
transforms draw from ``np.random`` as the JAX package's do, so one seed
gives both packages the same draws.  ``Resize`` (and the crops that
resize) interpolate as the JAX package's ``jax.image.resize`` does:
nearest at half-pixel centres, or linear with an antialiasing triangle
kernel when shrinking."""
from __future__ import annotations

import numpy as np
import torch

from .... import ndarray as nd
from ....ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomCrop", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomLighting"]


class Compose(Sequential):
    """Transforms applied in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (NHWC to NCHW)."""

    def hybrid_forward(self, F, x):
        if x.ndim == 3:
            return x.transpose((2, 0, 1)).astype("float32") / 255.0
        return x.transpose((0, 3, 1, 2)).astype("float32") / 255.0


class Normalize(HybridBlock):
    """``(x - mean) / std`` by channel on CHW."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        mean = nd.array(self._mean, ctx=x.context)
        std = nd.array(self._std, ctx=x.context)
        return (x - mean) / std


def _triangle_weights(n_in, n_out):
    """``jax.image``'s linear weights (n_in, n_out) in float32: a
    triangle kernel at half-pixel centres, widened by the shrink factor
    (antialiasing), each column normalised."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - dist / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize_hwc(x, size, interp=1):
    if isinstance(size, int):
        size = (size, size)
    w, h = size  # the reference's convention: (width, height)
    t = x._data
    H, W = t.shape[0], t.shape[1]
    if interp == 0:
        out = t
        for axis, (m, n) in enumerate(((H, h), (W, w))):
            if m != n:
                idx = np.floor((np.arange(n, dtype=np.float32) + 0.5)
                               * np.float32(m) / np.float32(n))
                out = out.index_select(axis, torch.as_tensor(
                    idx.astype(np.int64), device=t.device))
        return NDArray._wrap(out.contiguous(), x.context)
    out = t.to(torch.float32)
    if H != h:
        wh = torch.as_tensor(_triangle_weights(H, h), device=t.device)
        out = torch.einsum("hwc,hk->kwc", out, wh)
    if W != w:
        ww = torch.as_tensor(_triangle_weights(W, w), device=t.device)
        out = torch.einsum("hwc,wk->hkc", out, ww)
    return NDArray._wrap(out.to(t.dtype), x.context)


class Resize(Block):
    """Resize an HWC image to ``size`` (width, height), or its shorter
    side to ``size`` with ``keep_ratio``."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        if self._keep and isinstance(self._size, int):
            h, w = x.shape[0], x.shape[1]
            if w < h:
                size = (self._size, int(h * self._size / w))
            else:
                size = (int(w * self._size / h), self._size)
        else:
            size = self._size
        return _resize_hwc(x, size, self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._interpolation = interpolation

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        if H < h or W < w:
            return _resize_hwc(x, self._size, self._interpolation)
        y0, x0 = (H - h) // 2, (W - w) // 2
        return x[y0:y0 + h, x0:x0 + w, :]


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad
        self._interpolation = interpolation

    def forward(self, x):
        w, h = self._size
        if self._pad:
            p = self._pad
            x = nd.array(np.pad(x.asnumpy(),
                                ((p, p), (p, p), (0, 0)), mode="constant"),
                         ctx=x.context, dtype=str(x.dtype))
        H, W = x.shape[0], x.shape[1]
        if H < h or W < w:
            return _resize_hwc(x, self._size, self._interpolation)
        y0 = np.random.randint(0, H - h + 1)
        x0 = np.random.randint(0, W - w + 1)
        return x[y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            ar = np.exp(np.random.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * ar)))
            h = int(round(np.sqrt(target_area / ar)))
            if w <= W and h <= H:
                y0 = np.random.randint(0, H - h + 1)
                x0 = np.random.randint(0, W - w + 1)
                crop = x[y0:y0 + h, x0:x0 + w, :]
                return _resize_hwc(crop, self._size, self._interpolation)
        return _resize_hwc(x, self._size, self._interpolation)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return x.flip(axis=1)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return x.flip(axis=0)
        return x


class _RandomColorJitterBase(Block):
    def __init__(self, jitter):
        super().__init__()
        self._jitter = jitter

    def _alpha(self):
        return 1.0 + np.random.uniform(-self._jitter, self._jitter)


class RandomBrightness(_RandomColorJitterBase):
    def forward(self, x):
        return (x.astype("float32") * self._alpha()).clip(0, 255) \
            .astype(str(x.dtype))


class RandomContrast(_RandomColorJitterBase):
    def forward(self, x):
        xf = x.astype("float32")
        mean = xf.mean()
        a = self._alpha()
        return (xf * a + mean * (1 - a)).clip(0, 255).astype(str(x.dtype))


class RandomSaturation(_RandomColorJitterBase):
    def forward(self, x):
        xf = x.astype("float32")
        gray = xf.mean(axis=2, keepdims=True)
        a = self._alpha()
        return (xf * a + gray * (1 - a)).clip(0, 255).astype(str(x.dtype))


class RandomLighting(Block):
    """AlexNet's PCA colour noise."""

    _EIGVAL = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = np.random.normal(0, self._alpha, size=(3,)).astype(np.float32)
        rgb = (self._EIGVEC * a * self._EIGVAL).sum(axis=1)
        return (x.astype("float32") + nd.array(rgb, ctx=x.context)) \
            .clip(0, 255).astype(str(x.dtype))
