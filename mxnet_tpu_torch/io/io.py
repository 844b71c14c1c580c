"""Data iterators of the PyTorch port (the counterpart of
``mxnet_tpu.io.io``; reference: python/mxnet/io/io.py + src/io/).

The in-memory tier (``NDArrayIter`` and the iterators over it,
``CSVIter`` and ``MNISTIter``) yields CPU torch tensors; the epoch
orders are the JAX package's (``NDArrayIter(seed=s)`` shuffles epoch
``e`` with ``np.random.RandomState([s, e])``), so both packages yield the
same batch sequence from the same arrays.  Every ``next()`` is the
``train.data.next`` fault site, which fires before the cursor advances:
a failed fetch never half-consumes a batch.

``ImageRecordIter`` is the RecordIO image pipeline: a producer thread
reads, decodes and augments batches on the host (native C++ JPEG tier,
else the ``image`` module's codec chain), each into one host buffer per
field (pinned when bound for the card), and ``next()`` copies each field
to the iterator's context once, ``non_blocking``: the context current
when the iterator was built or last reset, the card unless the caller
asks for the CPU.  The context is captured on the caller's thread and
passed on, because the default context is thread-local.  Its random
draws follow the JAX package's order, so both packages make the same
batches from the same seed.
"""
from __future__ import annotations

import gzip
import os
import queue as _queue
import struct
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from .. import engine as _engine
from .. import faults as _faults
from .. import perf_account as _pa
from .. import recordio
from .. import runtime_metrics as _rm
from .. import tracing as _tr
from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import to_torch_dtype

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "ImageRecordIter"]

# how long close() / reset() wait for a producer thread to stop
_JOIN_TIMEOUT_S = 5.0


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
        if _rm._ENABLED:
            _rm.IO_BATCHES.inc()
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


def _batch_context():
    """The context batches go to: the caller's current one, checked here
    on the caller's thread (a card the machine lacks raises
    :class:`MXNetError`)."""
    ctx = current_context()
    ctx.torch_device()
    return ctx


def _staging(shape, dtype, ctx):
    """A host buffer for a batch field bound for ``ctx``: (tensor, numpy
    view of it), in pinned memory when ``ctx`` is a card.  A pinned
    block comes from torch's caching host allocator, which hands it out
    again only after the copies recorded on it have finished."""
    pin = ctx.device_type == "gpu"
    t = torch.empty(tuple(shape), dtype=to_torch_dtype(np.dtype(dtype)),
                    pin_memory=pin)
    return t, t.numpy()


def _place(host, ctx):
    """``host`` (a tensor from :func:`_staging`) as an NDArray on ``ctx``:
    one copy to the card, ``non_blocking`` from pinned memory, on the
    calling thread's current stream; on the CPU the tensor itself."""
    if ctx.device_type != "gpu":
        return NDArray._wrap(host, ctx)
    return NDArray._wrap(
        host.to(ctx.torch_device(), non_blocking=host.is_pinned()), ctx)


class ResizeIter(DataIter):
    """Truncate/loop an iterator to a fixed number of batches per epoch
    (reference: io.ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        for attr in ("provide_data", "provide_label", "default_bucket_key"):
            if hasattr(data_iter, attr):
                setattr(self, attr, getattr(data_iter, attr))

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _drain(q):
    try:
        while True:
            q.get_nowait()
    except _queue.Empty:
        pass


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators
    (reference: io.PrefetchingIter ≙ src/io PrefetcherIter).  The inner
    iterators place their own batches (each captured its context when it
    was built or reset)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1 and (rename_data is None
                                or rename_label is None):
            raise MXNetError("multiple iters require rename_data/label")
        self.iters = iters
        # rename_*: one {old_name: new_name} dict per inner iter
        self._rename_data = rename_data
        self._rename_label = rename_label
        super().__init__(iters[0].batch_size)
        self._depth = prefetch_depth
        self._queue = None
        self._thread = None
        self._done = False
        self._start()

    def _renamed(self, attr, renames):
        descs = []
        for i, it in enumerate(self.iters):
            mapping = renames[i] if renames else {}
            for d in getattr(it, attr, []):
                descs.append(d._replace(name=mapping.get(d.name, d.name)))
        return descs

    @property
    def provide_data(self):
        return self._renamed("provide_data", self._rename_data)

    @property
    def provide_label(self):
        return self._renamed("provide_label", self._rename_label)

    def _start(self):
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop_evt = threading.Event()

        def worker():
            try:
                while not self._stop_evt.is_set():
                    try:
                        batches = [it.next() for it in self.iters]
                    except StopIteration:
                        self._queue.put(None)
                        return
                    self._queue.put(batches)
            except Exception as e:  # propagate to consumer
                self._queue.put(e)

        self._thread = _engine.make_thread(
            worker, name="mxnet-prefetch", owner="PrefetchingIter")
        self._thread.start()

    def _stop(self):
        if self._thread is None:
            return
        self._stop_evt.set()
        # drain so the worker can observe the stop event
        _drain(self._queue)
        self._thread.join(timeout=_JOIN_TIMEOUT_S)
        self._thread = None

    def reset(self):
        self._stop()
        for it in self.iters:
            it.reset()
        self._done = False
        self._start()

    def close(self):
        """Stop the prefetch thread (``reset()`` starts it again)."""
        self._stop()
        self._done = True

    def next(self):
        _faults.inject("train.data.next")
        # the consumer-visible wait is just the queue take
        timed = _rm._ENABLED or _tr._ENABLED
        t0 = time.perf_counter() if timed else 0.0
        if self._done:
            raise StopIteration
        got = self._queue.get()
        if _rm._ENABLED:
            # depth AFTER this take: how far ahead the producer is
            _rm.IO_PREFETCH_DEPTH.set(self._queue.qsize())
        if got is None:
            self._done = True  # producer exited; don't block on next call
            raise StopIteration
        if isinstance(got, Exception):
            self._done = True
            raise got
        if len(self.iters) == 1:
            batch = got[0]
        else:
            batch = DataBatch(
                data=[d for b in got for d in b.data],
                label=[lb for b in got for lb in (b.label or [])],
                pad=got[0].pad)
        if timed:
            _pa.note_data_wait(t0, time.perf_counter())
        return batch

    def iter_next(self):
        raise MXNetError("PrefetchingIter supports next() only")


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


def _jpeg_dims(buf):
    """(height, width) from a JPEG header without decoding, or None.
    A ~microsecond marker scan that lets the decode path pick a
    DCT-reduced scale before calling imdecode."""
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    i, n = 2, len(buf)
    while i + 9 < n:
        if buf[i] != 0xFF:
            return None
        m = buf[i + 1]
        if m == 0xFF:                                # fill byte (T.81 B.1.1.2)
            i += 1
            continue
        if m == 0xD9:                                # EOI before any SOF
            return None
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:   # markers w/o length
            i += 2
            continue
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):   # SOFn
            return ((buf[i + 5] << 8) | buf[i + 6],
                    (buf[i + 7] << 8) | buf[i + 8])
        i += 2 + ((buf[i + 2] << 8) | buf[i + 3])
    return None


def _shard_range(n, num_parts, part_index):
    """The reference's num_parts/part_index shard contract."""
    if not 0 <= part_index < num_parts:
        raise MXNetError(
            f"part_index {part_index} out of range for {num_parts} parts")
    per = n // num_parts
    start = per * part_index
    end = per * (part_index + 1) if part_index < num_parts - 1 else n
    return start, end


class CSVIter(NDArrayIter):
    """CSV reader (reference: src/io/iter_csv.cc / io.CSVIter)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 num_parts=1, part_index=0, data_name="data",
                 label_name="softmax_label"):
        data = _load_csv(data_csv)
        n = data.shape[0]
        data = data.reshape((n,) + tuple(data_shape))
        if label_csv is not None:
            label = _load_csv(label_csv)
            if label_shape is not None:
                label = label.reshape((n,) + tuple(label_shape))
            else:
                label = label.reshape(n)
        else:
            label = np.zeros(n, dtype=np.float32)
        s, e = _shard_range(n, num_parts, part_index)
        super().__init__(data[s:e], label[s:e], batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard",
                         data_name=data_name, label_name=label_name)


def _load_csv(path):
    """Numeric CSV → float32 (rows, cols); C++ parser when available
    (reference: iter_csv.cc), numpy fallback."""
    from ..lib import nativelib
    if nativelib.available():
        return nativelib.csv_load(path)
    return np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)


def _read_idx_file(path):
    """MNIST idx format (magic 0x801/0x803 big-endian)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    magic, = struct.unpack(">I", raw[:4])
    ndim = magic & 0xff
    dims = struct.unpack(f">{ndim}I", raw[4:4 + 4 * ndim])
    data = np.frombuffer(raw, dtype=np.uint8, offset=4 + 4 * ndim)
    return data.reshape(dims)


class MNISTIter(DataIter):
    """MNIST idx reader (reference: src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, seed=0, num_parts=1, part_index=0,
                 silent=True):
        super().__init__(batch_size)
        images = _read_idx_file(image).astype(np.float32) / 255.0
        labels = _read_idx_file(label).astype(np.float32)
        if images.shape[0] != labels.shape[0]:
            raise MXNetError("image/label count mismatch")
        s, e = _shard_range(images.shape[0], num_parts, part_index)
        images, labels = images[s:e], labels[s:e]
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images[:, None, :, :]  # NCHW
        if shuffle:
            order = np.random.RandomState(seed).permutation(len(images))
            images, labels = images[order], labels[order]
        self._inner = NDArrayIter(images, labels, batch_size,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class ImageRecordIter(DataIter):
    """RecordIO image pipeline: shard → decode → augment → batch
    (reference: src/io/iter_image_recordio_2.cc).

    A producer thread assembles batches ahead of the consumer (queue
    depth ``prefetch_buffer``) into host buffers, pinned when bound for
    the card, and fans decode/augment work out to ``preprocess_threads``
    pool workers; ``next()`` copies each field to the iterator's context
    once (module docstring).  Decode tiers, in order: the native C++
    JPEG tier (a whole batch on OS threads) where libjpeg was linked,
    then per image the ``image`` module's codec chain (cv2, PIL, the
    built-in PNG codec; a JPEG with none of them raises
    :class:`MXNetError`).  Augmentations cover the default ImageAugmenter
    set (resize, center/rand crop, mirror, mean subtraction, scale).
    ``close()`` stops the producer and the decode pool; ``reset()``
    restarts the producer.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 scale=1.0, resize=-1, num_parts=1, part_index=0,
                 label_width=1, round_batch=True, seed=0,
                 preprocess_threads=1, prefetch_buffer=4):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self.data_shape = tuple(data_shape)
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = np.array([mean_r, mean_g, mean_b],
                             np.float32).reshape(3, 1, 1)
        self.scale = scale
        self.resize = resize
        self.label_width = label_width
        self.round_batch = round_batch
        self._rng = np.random.RandomState(seed)
        self._shuffle = shuffle
        from ..lib import nativelib

        # index the record file once, then shard
        self._rec = recordio.MXIndexedRecordIO(
            path_imgidx or path_imgrec + ".idx", path_imgrec, "r") \
            if (path_imgidx or os.path.exists(path_imgrec + ".idx")) \
            else None
        self._native = None
        if self._rec is not None and self._rec.keys:
            keys = list(self._rec.keys)
        else:
            # no index: scan once recording offsets.  The C++ scanner
            # walks frames without copying payloads; the Python tier
            # reads them all.
            self._rec = None
            if nativelib.available():
                self._native = nativelib.NativeRecordReader(path_imgrec)
                self._offsets = self._native.index().tolist()
            else:
                self._offsets = []
                reader = recordio.MXRecordIO(path_imgrec, "r")
                while True:
                    pos = reader.tell()
                    if reader.read() is None:
                        break
                    self._offsets.append(pos)
                reader.close()
                self._plain_reader = recordio.MXRecordIO(path_imgrec, "r")
            keys = list(range(len(self._offsets)))
        s, e = _shard_range(len(keys), num_parts, part_index)
        self._keys = keys[s:e]
        self._order = list(range(len(self._keys)))
        self._pos = 0
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max(1, preprocess_threads)) \
            if preprocess_threads > 1 else None
        self._nthreads = max(1, preprocess_threads)
        # native decode tier: whole-batch JPEG decode+resize+crop+mirror
        # on C++ OS threads in ONE call.  Non-JPEG payloads and decode
        # failures fall back to the per-image path.
        self._native_jpeg = (self.data_shape[0] == 3
                             and nativelib.jpeg_available())
        self._depth = max(1, prefetch_buffer)
        self._queue = None
        self._producer = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        self._stop_producer()
        self._ctx = _batch_context()
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0
        self._done = False
        self._start_producer()

    # ------------------------------------------------------- prefetch plumbing
    def _start_producer(self):
        q = self._queue = _queue.Queue(maxsize=self._depth)
        stop = self._stop_evt = threading.Event()
        ctx = self._ctx

        def produce():
            try:
                while not stop.is_set():
                    try:
                        batch = self._next_batch_sync(ctx)
                    except StopIteration:
                        q.put(None)
                        return
                    q.put(batch)
            except Exception as e:
                q.put(e)

        self._producer = _engine.make_thread(
            produce, name="mxnet-imgrec-producer", owner="ImageRecordIter")
        self._producer.start()

    def _stop_producer(self):
        if self._producer is None:
            return
        self._stop_evt.set()
        _drain(self._queue)
        self._producer.join(timeout=_JOIN_TIMEOUT_S)
        self._producer = None

    def close(self):
        """Terminal stop: halt the producer and shut down the decode
        pool, each joined with a timeout (``reset()`` restarts the
        producer; ``close()`` does not)."""
        self._stop_producer()
        if self._pool is not None:
            pool, self._pool = self._pool, None
            pool.shutdown(wait=False, cancel_futures=True)
            for t in list(getattr(pool, "_threads", ())):
                t.join(timeout=_JOIN_TIMEOUT_S)
            self._nthreads = 1
        self._done = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def next(self):
        _faults.inject("train.data.next")
        timed = _rm._ENABLED or _tr._ENABLED
        t0 = time.perf_counter() if timed else 0.0
        if self._done:
            raise StopIteration
        got = self._queue.get()
        if _rm._ENABLED:
            _rm.IO_PREFETCH_DEPTH.set(self._queue.qsize())
        if got is None:
            self._done = True
            raise StopIteration
        if isinstance(got, Exception):
            self._done = True
            raise got
        data, label, pad = got
        batch = DataBatch(data=[_place(data, self._ctx)],
                          label=[_place(label, self._ctx)], pad=pad,
                          provide_data=self.provide_data,
                          provide_label=self.provide_label)
        if _rm._ENABLED:
            _rm.IO_BATCHES.inc()
        if timed:
            _pa.note_data_wait(t0, time.perf_counter())
        return batch

    def iter_next(self):
        raise MXNetError(
            "ImageRecordIter prefetches in the background; use next()")

    # ---------------------------------------------------------- decode path
    def _read_record(self, key):
        if self._rec is not None:
            return self._rec.read_idx(key)
        if self._native is not None:
            return self._native.read_at(self._offsets[key])
        self._plain_reader._f.seek(self._offsets[key])
        return self._plain_reader.read()

    def _decode_image(self, header, blob):
        """HWC uint8 image of one record on the codec chain, and whether
        its channels are BGR (cv2's order)."""
        from ..image import image as _image
        if _image._BACKEND != "cv2":
            if blob[:2] == b"\xff\xd8" and _image._BACKEND == "numpy":
                from ..lib import nativelib
                raise MXNetError(
                    f"record id={header.id} is a JPEG, and this host has no "
                    f"tier that decodes it: no cv2, no PIL, and the native "
                    f"JPEG tier is "
                    f"{'on' if nativelib.jpeg_available() else 'off'} "
                    f"(nativelib.jpeg_build_error(): "
                    f"{nativelib.jpeg_build_error()})")
            try:
                return _image._decode(blob, 1), False
            except MXNetError as e:
                raise MXNetError(f"record id={header.id}: image decode "
                                 f"failed: {e}") from e
        import cv2
        # DCT-domain reduced decode: when the source is >= 2x/4x/8x the
        # resize target, libjpeg can IDCT straight to the smaller scale
        flag = cv2.IMREAD_COLOR
        if self.resize > 0:
            dims = _jpeg_dims(blob)
            if dims is not None:
                short = min(dims)
                for k, f in ((8, cv2.IMREAD_REDUCED_COLOR_8),
                             (4, cv2.IMREAD_REDUCED_COLOR_4),
                             (2, cv2.IMREAD_REDUCED_COLOR_2)):
                    if short >= k * self.resize:
                        flag = f
                        break
        img = cv2.imdecode(np.frombuffer(blob, np.uint8), flag)
        if img is None:
            raise MXNetError(f"record id={header.id}: image decode failed")
        return img, True

    def _decode_one(self, payload, rng):
        from ..image import image as _image
        if _rm._ENABLED:
            _rm.IO_PYTHON_DECODE.inc()
        header, blob = recordio.unpack(payload)
        img, bgr = self._decode_image(header, blob)
        if self.resize > 0:
            h, w = img.shape[:2]
            if h < w:
                new = (int(w * self.resize / h), self.resize)
            else:
                new = (self.resize, int(h * self.resize / w))
            img = _image._resize(img, new[0], new[1], 1)
        c, th, tw = self.data_shape
        h, w = img.shape[:2]
        if h < th or w < tw:
            img = _image._resize(img, max(w, tw), max(h, th), 1)
            h, w = img.shape[:2]
        if self.rand_crop:
            y = rng.randint(0, h - th + 1)
            x = rng.randint(0, w - tw + 1)
        else:
            y, x = (h - th) // 2, (w - tw) // 2
        img = img[y:y + th, x:x + tw]
        if self.rand_mirror and rng.rand() < 0.5:
            img = img[:, ::-1]
        if bgr:
            img = img[:, :, ::-1]  # BGR (cv2) -> RGB
        chw = np.transpose(img, (2, 0, 1)).astype(np.float32)
        chw = (chw - self.mean) * self.scale
        label = np.atleast_1d(np.asarray(header.label, np.float32))
        if label.size < self.label_width:
            raise MXNetError(
                f"record id={header.id} has {label.size} label value(s), "
                f"label_width={self.label_width} requested")
        return chw, label[:self.label_width]

    def _decode_batch_native(self, payloads, data, labels):
        """Whole-batch decode on the native C++ thread pool into ``data``
        and ``labels``.  Returns False when the batch isn't native-
        eligible (no JPEG records); individual decode failures are
        re-done on the per-image path.  Augmentation randomness (crop
        position fractions, mirror coin flips) is drawn from the
        iterator's seeded RNG here, so determinism semantics match the
        per-image tier."""
        from ..lib import nativelib

        headers, blobs = [], []
        for p in payloads:
            hdr, blob = recordio.unpack(p)
            headers.append(hdr)
            blobs.append(blob)
        if not any(b[:2] == b"\xff\xd8" for b in blobs):
            # Zero JPEGs in this batch.  Disable the probe only while
            # we have NEVER seen a JPEG from this shard (first-batch
            # evidence of an all-PNG shard); once any batch has used
            # the native tier, a stray all-PNG batch under shuffle must
            # not turn it off for the rest of the epoch.
            if not getattr(self, "_native_seen_jpeg", False):
                self._native_jpeg = False
            return False
        self._native_seen_jpeg = True
        _c, th, tw = self.data_shape
        n = len(blobs)
        if self.rand_crop:
            cy = self._rng.random_sample(n).astype(np.float32)
            cx = self._rng.random_sample(n).astype(np.float32)
        else:
            # negative = center-crop sentinel (integer offset, native side)
            cy = np.full(n, -1.0, np.float32)
            cx = np.full(n, -1.0, np.float32)
        mir = (self._rng.random_sample(n) < 0.5).astype(np.uint8) \
            if self.rand_mirror else np.zeros(n, np.uint8)
        out, status = nativelib.decode_jpeg_batch(
            blobs, self.resize if self.resize > 0 else 0, th, tw,
            cy, cx, mir, self._nthreads)
        if _rm._ENABLED:
            # failed records are re-decoded on the per-image path below,
            # where _decode_one counts them
            _rm.IO_NATIVE_DECODE.inc(n - int(np.count_nonzero(status)))
        data[...] = out
        if self.mean.any() or self.scale != 1.0:
            data -= self.mean
            data *= self.scale
        for i, hdr in enumerate(headers):
            lab = np.atleast_1d(np.asarray(hdr.label, np.float32))
            if lab.size < self.label_width:
                raise MXNetError(
                    f"record id={hdr.id} has {lab.size} label value(s), "
                    f"label_width={self.label_width} requested")
            labels[i] = lab[:self.label_width]
        for i in np.nonzero(status)[0]:
            img, lab = self._decode_one(
                payloads[i],
                np.random.RandomState(self._rng.randint(0, 2**31)))
            data[i] = img
            labels[i] = lab
        return True

    def _next_batch_sync(self, ctx):
        """Assemble one batch into host buffers for ``ctx``: (data,
        label, pad).  Record reads stay on the producer thread,
        decode/augment fans out to the worker pool."""
        n = len(self._keys)
        if self._pos >= n:
            raise StopIteration
        idxs = []
        for i in range(self.batch_size):
            j = self._pos + i
            if j < n:
                idxs.append(self._order[j])
            elif self.round_batch:
                idxs.append(self._order[j % n])
            else:
                break
        if not idxs or (len(idxs) < self.batch_size
                        and not self.round_batch):
            raise StopIteration
        pad = self.batch_size - min(n - self._pos, self.batch_size)
        self._pos += self.batch_size
        payloads = [self._read_record(self._keys[k]) for k in idxs]
        data_t, data = _staging((len(idxs),) + self.data_shape,
                                np.float32, ctx)
        labels = np.empty((len(idxs), self.label_width), np.float32)
        if not (self._native_jpeg
                and self._decode_batch_native(payloads, data, labels)):
            # per-record RNG decided here so pool workers never share state
            rngs = [np.random.RandomState(self._rng.randint(0, 2**31))
                    for _ in idxs]
            if self._pool is not None:
                decoded = list(self._pool.map(self._decode_one, payloads,
                                              rngs))
            else:
                decoded = [self._decode_one(p, r)
                           for p, r in zip(payloads, rngs)]
            for i, (img, lab) in enumerate(decoded):
                data[i] = img
                labels[i] = lab
        label_arr = labels[:, 0] if self.label_width == 1 else labels
        label_t, label_host = _staging(label_arr.shape, np.float32, ctx)
        label_host[...] = label_arr
        return data_t, label_t, pad
