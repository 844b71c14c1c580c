"""Contrib layers of the PyTorch port (reference:
``python/mxnet/gluon/contrib/nn/basic_layers.py``): ``Concurrent`` /
``HybridConcurrent``, ``Identity``, ``SparseEmbedding``,
``SyncBatchNorm`` and ``PixelShuffle2D``; the counterpart of
``mxnet_tpu.gluon.contrib.nn``.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from ..nn import basic_layers as _nn

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle2D"]


class HybridConcurrent(HybridBlock):
    """Children run on the same input, outputs concatenated along
    ``axis`` (reference: contrib.nn.HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        out = [child(x) for child in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Concurrent(HybridConcurrent):
    """The imperative name (the reference keeps both)."""


class Identity(HybridBlock):
    """Pass-through block (reference: contrib.nn.Identity)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(HybridBlock):
    """Embedding whose gradient is row-sparse (reference:
    contrib.nn.SparseEmbedding): ``gluon.Trainer`` compresses it to the
    rows this batch used, and SGD's / Adam's ``lazy_update`` move only
    those rows."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, grad_stype="row_sparse")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim, sparse_grad=True)


class SyncBatchNorm(_nn.BatchNorm):
    """Cross-device batch normalisation (reference:
    contrib.nn.SyncBatchNorm).  On one card it is ``BatchNorm``, as in
    the JAX package; ``num_devices`` is accepted.  Statistics across
    cards wait for the multi-card data-parallel path (ROADMAP 6.5)."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class PixelShuffle2D(HybridBlock):
    """Depth to space (reference: contrib.nn.PixelShuffle2D):
    (N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        try:
            self._fh, self._fw = factor
        except TypeError:
            self._fh = self._fw = int(factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._fh, self._fw
        n, c, h, w = x.shape
        if c % (f1 * f2):
            raise MXNetError(
                f"PixelShuffle2D: channels {c} not divisible by "
                f"{f1}*{f2}")
        x = x.reshape((n, c // (f1 * f2), f1, f2, h, w))
        x = x.transpose((0, 1, 4, 2, 5, 3))
        return x.reshape((n, c // (f1 * f2), h * f1, w * f2))
