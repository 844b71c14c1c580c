"""DataLoader (reference: python/mxnet/gluon/data/dataloader.py; the
counterpart of ``mxnet_tpu.gluon.data.dataloader``).

A batch is stacked on the host and copied to its context in one
transfer a field: ``current_context()`` when the iteration starts (the
card unless the caller asks for the CPU).  With ``pin_memory=True`` a
batch bound for the card is stacked into pinned memory and copied
``non_blocking``.  ``num_workers > 0`` assembles batches in a thread
pool, ``prefetch`` of them ahead (default ``2 * num_workers``), as the
JAX package does: the samples' work is numpy and torch, which release
the GIL.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...base import MXNetError
from ...context import current_context
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _batchify(data, ctx, pin):
    """Stack samples on the host, then one copy to ``ctx``; a tuple
    sample gives a list of batches, one a field."""
    if isinstance(data[0], tuple):
        return [_batchify(list(field), ctx, pin) for field in zip(*data)]
    if isinstance(data[0], NDArray):
        host = torch.stack([a._data.detach().cpu() for a in data])
    else:
        arr = np.asarray(data)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        host = torch.from_numpy(np.ascontiguousarray(arr))
    dev = ctx.torch_device()
    if dev.type == "cuda" and pin:
        host = host.pin_memory()
    return NDArray._wrap(host.to(dev, non_blocking=pin), ctx)


def default_batchify_fn(data):
    """Stack samples into a batch on the current context (float64 host
    data narrows to float32, int64 to int32)."""
    return _batchify(data, current_context(), False)


class DataLoader:
    """Mini-batches of a Dataset (reference: ``gluon.data.DataLoader``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError(
                    "batch_size is required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError(
                "batch_size/shuffle/sampler/last_batch are exclusive with "
                "batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn
        self._pin_memory = bool(pin_memory)
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pool = ThreadPoolExecutor(self._num_workers) \
            if self._num_workers > 0 else None

    def _make_batch(self, indices, ctx):
        samples = [self._dataset[i] for i in indices]
        if self._batchify_fn is not None:
            return self._batchify_fn(samples)
        return _batchify(samples, ctx, self._pin_memory)

    def __iter__(self):
        ctx = current_context()
        if self._pool is None:
            for indices in self._batch_sampler:
                yield self._make_batch(indices, ctx)
            return
        queue = collections.deque()
        it = iter(self._batch_sampler)

        def fill():
            while len(queue) < self._prefetch + 1:
                try:
                    indices = next(it)
                except StopIteration:
                    return
                queue.append(self._pool.submit(self._make_batch, indices,
                                               ctx))

        fill()
        while queue:
            fut = queue.popleft()
            fill()
            yield fut.result()

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Shut the worker pool down (idempotent; the loader then works
        without workers)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
