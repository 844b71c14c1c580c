"""Gluon utilities of the PyTorch port (reference:
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load`` and
``clip_global_norm``.  ``download`` and ``check_sha1`` get no
counterpart: the port runs without a network."""
from __future__ import annotations

import warnings

import torch

from ..base import MXNetError
from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split along the batch axis into ``num_slice`` chunks."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot evenly split batch of {size} into {num_slice} slices "
            f"(set even_split=False to allow uneven)")
    step = size // num_slice
    return [data.slice_axis(axis=batch_axis, begin=i * step,
                            end=(i + 1) * step if i < num_slice - 1
                            else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and place one slice on each context (the
    data-parallel primitive)."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` so that their global L2 norm is at most
    ``max_norm``; a non-finite norm leaves them as they are.  Returns the
    norm: a float with ``check_isfinite`` (one host sync), else an
    NDArray."""
    if not arrays:
        raise MXNetError("clip_global_norm: empty array list")
    with torch.no_grad():
        total = torch.sqrt(sum(torch.sum(torch.square(
            a._data.detach().to(torch.float32))).to(arrays[0]._data.device)
            for a in arrays))
        scale = torch.where(torch.isfinite(total) & (total > max_norm),
                            max_norm / (total + 1e-8),
                            torch.ones_like(total))
        for a in arrays:
            a._set_data(a._data.detach()
                        * scale.to(device=a._data.device,
                                   dtype=a._data.dtype))
    if check_isfinite:
        t = float(total)
        if not t < float("inf"):
            warnings.warn("nan or inf found in gradients during "
                          "clip_global_norm")
        return t
    return NDArray._wrap(total, arrays[0].context)
