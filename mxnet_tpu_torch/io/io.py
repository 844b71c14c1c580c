"""Data iterators of the PyTorch port: the batch types and the
checkpointable in-memory iterator.

The counterpart of ``mxnet_tpu.io``'s iterator tier (``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter``).  Batches are CPU torch
tensors; the epoch orders are the JAX package's (``NDArrayIter(seed=s)``
shuffles epoch ``e`` with ``np.random.RandomState([s, e])``), so both
packages yield the same batch sequence from the same arrays.  Every
``next()`` is the ``train.data.next`` fault site, which fires before the
cursor advances: a failed fetch never half-consumes a batch.
"""
from __future__ import annotations

import time
from collections import namedtuple

import numpy as np
import torch

from .. import faults as _faults
from .. import perf_account as _pa
from .. import runtime_metrics as _rm
from .. import tracing as _tr
from ..base import MXNetError

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Shape/type descriptor (reference: io.DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One mini-batch (reference: io.DataBatch): ``data`` and ``label``
    are lists of tensors."""

    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise MXNetError("DataBatch.data must be a list of tensors")
        if label is not None and not isinstance(label, (list, tuple)):
            raise MXNetError("DataBatch.label must be a list of tensors")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [tuple(d.shape) for d in self.data] if self.data else []
        lshapes = [tuple(lb.shape) for lb in self.label] if self.label \
            else []
        return f"DataBatch: data shapes: {shapes} label shapes: {lshapes}"


class DataIter:
    """Iterator base (reference: io.DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        _faults.inject("train.data.next")
        # data-wait attribution: the interval this consumer spent in
        # next() becomes the following step's train.data.wait span
        timed = _rm._ENABLED or _tr._ENABLED
        t0 = time.perf_counter() if timed else 0.0
        if not self.iter_next():
            raise StopIteration
        batch = self._batch()
        if timed:
            _pa.note_data_wait(t0, time.perf_counter())
        return batch

    def _batch(self):
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=self.getindex())

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """-> list of (name, numpy array) (reference: io._init_data)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, torch.Tensor)):
        data = [data]
    if isinstance(data, (list, tuple)):
        pairs = []
        for i, d in enumerate(data):
            name = default_name if len(data) == 1 \
                else f"_{i}_{default_name}"
            pairs.append((name, d))
    elif isinstance(data, dict):
        pairs = list(data.items())
    else:
        raise MXNetError(f"unsupported data type {type(data)}")
    out = []
    for name, d in pairs:
        if isinstance(d, torch.Tensor):
            d = d.detach().cpu().numpy()
        d = np.asarray(d)
        if d.dtype == np.float64:
            d = d.astype(np.float32)
        out.append((name, d))
    return out


class NDArrayIter(DataIter):
    """Batches over in-memory arrays with pad/discard/roll_over handling
    (reference: io.NDArrayIter).

    ``seed`` opts into DETERMINISTIC epochs: epoch e's shuffle order is
    a pure function of (seed, e) instead of the global numpy RNG, which
    is what makes the iterator checkpointable — :meth:`get_cursor`
    captures (epoch, position, seed) and :meth:`set_cursor` replays the
    order chain so a supervised resume sees exactly the batch the
    killed run would have seen next, neither replaying nor skipping
    data."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        for name, arr in self.data + self.label:
            if arr.shape[0] != self.num_data:
                raise MXNetError(
                    f"field {name!r} has {arr.shape[0]} samples, expected "
                    f"{self.num_data}")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(
                f"invalid last_batch_handle {last_batch_handle!r}")
        if last_batch_handle == "discard" and self.num_data < batch_size:
            raise MXNetError("not enough data for even one batch")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._seed = None if seed is None else int(seed)
        self._epoch = -1    # reset() increments; first epoch is 0
        self._carry = None  # roll_over: sample indices left from last epoch
        self._order = np.arange(self.num_data)
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:],
                         arr.dtype) for name, arr in self.data]

    @property
    def provide_label(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:],
                         arr.dtype) for name, arr in self.label]

    def _epoch_perm(self, epoch):
        """Epoch ``epoch``'s permutation — pure in (seed, epoch)."""
        idx = np.arange(self.num_data)
        if self.shuffle:
            np.random.RandomState([self._seed, epoch]).shuffle(idx)
        return idx

    def reset(self):
        self._epoch += 1
        if self._seed is not None:
            idx = self._epoch_perm(self._epoch)
        else:
            idx = np.arange(self.num_data)
            if self.shuffle:
                np.random.shuffle(idx)
        if self.last_batch_handle == "roll_over" and self._carry is not None:
            # leftover samples from the previous epoch lead this one
            self._order = np.concatenate([self._carry, idx])
            self._carry = None
        else:
            self._order = idx
        self.cursor = -self.batch_size

    # ------------------------------------------------- checkpointable cursor
    def get_cursor(self):
        """Checkpointable position: exactly what :meth:`set_cursor`
        needs to make the NEXT ``next()`` return the same batch an
        uninterrupted run would have returned.  Requires ``seed=``
        when shuffling (the global-RNG order cannot be replayed)."""
        if self.shuffle and self._seed is None:
            raise MXNetError(
                "NDArrayIter.get_cursor: a shuffling iterator is only "
                "checkpointable with seed= (epoch order must be a "
                "pure function of (seed, epoch) to replay on resume)")
        return {"epoch": int(self._epoch), "cursor": int(self.cursor),
                "seed": self._seed, "shuffle": bool(self.shuffle),
                "num_data": int(self.num_data),
                "batch_size": int(self.batch_size),
                "last_batch_handle": self.last_batch_handle}

    def set_cursor(self, state):
        """Rewind/fast-forward to a :meth:`get_cursor` snapshot by
        replaying the deterministic epoch-order chain (roll_over
        carries included).  Refuses a snapshot from a differently
        configured iterator — resuming against different data is the
        silent replay/skip bug this cursor exists to prevent."""
        expected = {"seed": self._seed,
                    "shuffle": bool(self.shuffle),
                    "num_data": int(self.num_data),
                    "batch_size": int(self.batch_size),
                    "last_batch_handle": self.last_batch_handle}
        for key, mine in expected.items():
            if state.get(key) != mine:
                raise MXNetError(
                    f"NDArrayIter.set_cursor: snapshot {key}="
                    f"{state.get(key)!r} does not match this "
                    f"iterator's {mine!r} — refusing a cursor from a "
                    f"different data configuration")
        if self.shuffle and self._seed is None:
            raise MXNetError(
                "NDArrayIter.set_cursor requires seed= when shuffling")
        epoch = int(state["epoch"])
        # replay the order chain from epoch 0: with roll_over, epoch
        # e's head is epoch e-1's leftover tail, so the chain is the
        # only faithful reconstruction
        carry = None
        order = np.arange(self.num_data)
        for e in range(epoch + 1):
            idx = self._epoch_perm(e) if self._seed is not None \
                else np.arange(self.num_data)
            order = np.concatenate([carry, idx]) \
                if (self.last_batch_handle == "roll_over"
                    and carry is not None) else idx
            carry = None
            if self.last_batch_handle == "roll_over":
                leftover = len(order) % self.batch_size
                if leftover:
                    carry = order[len(order) - leftover:]
        self._epoch = epoch
        self._order = order
        # live iteration regenerates the roll_over carry itself at the
        # epoch boundary; a between-steps snapshot never holds one
        self._carry = None
        self.cursor = int(state["cursor"])

    def iter_next(self):
        self.cursor += self.batch_size
        n = len(self._order)
        if self.last_batch_handle == "pad":
            return self.cursor < n
        if self.cursor + self.batch_size <= n:
            return True
        if self.last_batch_handle == "roll_over" and self.cursor < n:
            self._carry = self._order[self.cursor:]
        return False

    def _take(self, arrs):
        n = len(self._order)
        start = self.cursor
        end = start + self.batch_size
        out = []
        for _, arr in arrs:
            if end <= n:
                sel = arr[self._order[start:end]]
            else:  # pad: wrap around to the epoch start
                sel = np.concatenate([arr[self._order[start:]],
                                      arr[self._order[:end - n]]])
            out.append(torch.from_numpy(sel))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > len(self._order):
            return end - len(self._order)
        return 0

    def _batch(self):
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
