"""Shape-bucketed dynamic batching (docs/serving.md §3).

The PyTorch port of ``mxnet_tpu.serving.batcher``.  Concurrent
``predict()`` calls of ragged batch sizes coalesce into one dispatched
batch per model: request rows are concatenated along axis 0 and padded
up to the next power-of-two **bucket**, so any mix of N request shapes
reaches the device as at most ``ceil(log2(max)) + 1`` distinct program
shapes.  Each bucket's program is built once and cached — for an
``add_block`` entry on the card that build is one CUDA-graph capture
(``serving.repository``), the counterpart of one XLA compile;
``serving.bucket.cache{event=mem_hit|disk_hit|miss}`` counts lookups.
The invariant: **misses == freshly built programs**; a ``disk_hit`` is
a program its entry marks as loaded from a persistent cache
(``_mx_from_disk_cache``), so the in-memory program count equals misses
+ disk hits.

The decode engine pads prompt lengths and verify windows to the same
buckets (:func:`bucket_set`), so any traffic mix reaches a decode model
as at most ``len(bucket_set(max_context))`` shapes per program family.

Outputs must be batch-major (axis 0 = rows, the manifest contract);
padded rows are sliced off and per-request slices handed back, so a
ragged final batch un-pads exactly.
"""
from __future__ import annotations

import threading

import numpy as np

from .. import engine, faults as _faults, runtime_metrics as _rm, \
    tracing as _tr
from ..base import MXNetError
from .resilience import DeadlineExceededError

__all__ = ["DynamicBatcher", "next_bucket", "bucket_set", "pad_batch",
           "unpad_outputs"]


def next_bucket(rows, max_batch):
    """Smallest power of two >= rows, capped at max_batch (the cap
    itself is the last bucket even when it is not a power of two), so
    the bucket set is {1, 2, 4, ..., max_batch}."""
    if rows < 1:
        raise MXNetError(f"next_bucket: rows must be >= 1, got {rows}")
    if rows >= max_batch:
        return max_batch
    b = 1
    while b < rows:
        b <<= 1
    return min(b, max_batch)


def bucket_set(max_batch):
    """Every bucket :func:`next_bucket` can produce for ``max_batch``,
    ascending — the ONE definition of the bucket policy (prewarm builds
    exactly these; the decode engine's program bound counts it)."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b <<= 1
    buckets.append(max_batch)       # the cap is always the last bucket
    return buckets


def pad_batch(request_inputs, bucket_rows):
    """Concatenate per-request input tuples along axis 0 and zero-pad to
    ``bucket_rows``.

    ``request_inputs``: list of tuples of numpy arrays (one tuple per
    request, batch-major).  Returns ``(padded_inputs, offsets)`` where
    ``offsets[i]`` is the row offset of request i (``offsets[-1]`` is
    the real row total).  Padding rows are zeros: for a BERT entry a
    padding row has ``valid_length`` 0, which the flash kernel answers
    with zeros, and the row is dropped by :func:`unpad_outputs`.
    """
    n_in = len(request_inputs[0])
    offsets = [0]
    for req in request_inputs:
        offsets.append(offsets[-1] + req[0].shape[0])
    total = offsets[-1]
    if total > bucket_rows:
        raise MXNetError(
            f"pad_batch: {total} rows exceed bucket of {bucket_rows}")
    padded = []
    for pos in range(n_in):
        parts = [req[pos] for req in request_inputs]
        cat = parts[0] if len(parts) == 1 else np.concatenate(parts, 0)
        if total < bucket_rows:
            pad = np.zeros((bucket_rows - total,) + cat.shape[1:],
                           dtype=cat.dtype)
            cat = np.concatenate([cat, pad], 0)
        padded.append(cat)
    return tuple(padded), offsets


def _host(out):
    """A request input or program output as a numpy array (a torch
    tensor, on any device, is copied to the host)."""
    if hasattr(out, "detach") and hasattr(out, "cpu"):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _same_device(a, b):
    """Whether two device specs (``torch.device``, strings) name one
    device; a CUDA device without an index is the current one."""
    import torch

    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device()
                                if torch.cuda.is_available() else 0)
        return d
    return norm(a) == norm(b)


def unpad_outputs(outputs, offsets):
    """Split batch-major outputs back into per-request tuples, dropping
    padding rows (everything past ``offsets[-1]``)."""
    total = offsets[-1]
    # ONE device-to-host transfer per output, not one per request
    host = []
    for out in outputs:
        arr = _host(out)
        if arr.ndim < 1 or arr.shape[0] < total:
            raise MXNetError(
                f"serving outputs must be batch-major: output of "
                f"shape {arr.shape} cannot be split across "
                f"{total} request rows")
        host.append(arr)
    return [tuple(arr[offsets[i]:offsets[i + 1]] for arr in host)
            for i in range(len(offsets) - 1)]


class DynamicBatcher:
    """Executes coalesced batches through a per-(entry, bucket) program
    cache.  Stateless with respect to queuing — the ModelServer worker
    pool decides *what* to coalesce; this decides *how* it runs.

    Programs of one entry may be built and executed by several worker
    threads at once: each program serialises its own callers, and each
    build runs outside this batcher's lock.

    ``device`` (a replica's lead device; None for the server's own
    batcher) is where this batcher's programs must run.  A program runs
    where its entry's weights live (``entry.device``), so a batcher
    placed elsewhere refuses the entry with :class:`MXNetError` when its
    replica is built (:meth:`check_device`) instead of copying the
    weights to another card: placing replica weights across cards is
    ROADMAP.md Queue A, item 5."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = device
        self._lock = engine.make_lock("serving.DynamicBatcher._lock")
        self._progs = {}            # (entry.uid, bucket) -> callable
        self._building = {}         # key -> Event (in-flight builds)
        self._retired = set()       # uids evicted; never re-cache these
        self.bucket_hits = 0        # in-memory program reused
        self.bucket_disk_hits = 0   # marked as loaded from a disk cache
        self.bucket_misses = 0      # freshly built

    # ------------------------------------------------------------- cache
    def program_for(self, entry, bucket_rows, deadline=None):
        """The cached program for one (entry, bucket) — built on first
        lookup.  The build (for a block entry on the card: an eager
        forward and a CUDA-graph capture) runs OUTSIDE the batcher lock,
        so it never stalls other keys' mem-hit lookups.  Concurrent
        lookups of the SAME key wait on the builder instead of building
        twice, so misses stay == built programs.

        ``deadline`` (a :class:`~.resilience.Deadline`) bounds the
        builder wait: a wedged builder (the ``serving.compile`` stall
        fault) surfaces as ``DeadlineExceededError`` within the
        request's budget, never a hang.  Deadline-less callers (prewarm,
        tests) keep the unbounded wait."""
        key = (entry.uid, bucket_rows)
        while True:
            with self._lock:
                prog = self._progs.get(key)
                if prog is not None:
                    self.bucket_hits += 1
                    if _rm._ENABLED:
                        _rm.SERVING_BUCKET_CACHE.inc(event="mem_hit")
                    _tr.tag("bucket_outcome", "mem_hit")
                    return prog
                pending = self._building.get(key)
                if pending is None:
                    self._building[key] = threading.Event()
                    break               # this thread builds
            # builder done (or failed): recheck.  wait(None) is the
            # unbounded wait of deadline-less callers.
            remaining = None if deadline is None else deadline.remaining()
            if not pending.wait(remaining) and deadline is not None \
                    and deadline.expired():
                raise DeadlineExceededError(
                    f"serving program build ({entry.name!r}, bucket "
                    f"{bucket_rows})", deadline.timeout,
                    "another thread's bucket build did not complete "
                    "within the request deadline")
        try:
            # chaos site: a transient build failure — the worker-level
            # retry policy re-enters program_for, and the waiter-wake
            # contract below hands the build to a retrier
            _faults.inject("serving.compile")
            prog = entry.make_program(bucket_rows)
        except BaseException:
            # wake waiters so one of them retries as the next builder
            with self._lock:
                self._building.pop(key).set()
            raise
        with self._lock:
            if getattr(prog, "_mx_from_disk_cache", False):
                self.bucket_disk_hits += 1
                event = "disk_hit"
            else:
                self.bucket_misses += 1
                event = "miss"
            if _rm._ENABLED:
                _rm.SERVING_BUCKET_CACHE.inc(event=event)
            _tr.tag("bucket_outcome", event)
            # a batch admitted before unload can dispatch after evict():
            # run it, but never re-cache under a retired uid (no future
            # unload event would ever clear it again)
            if entry.uid not in self._retired:
                self._progs[key] = prog
            self._building.pop(key).set()
        return prog

    def programs(self, entry=None):
        """Cached program count (per entry, or total)."""
        with self._lock:
            if entry is None:
                return len(self._progs)
            return sum(1 for uid, _ in self._progs if uid == entry.uid)

    def program_list(self, entry):
        """The cached programs of ``entry``, by ascending bucket."""
        with self._lock:
            return [p for (uid, _b), p in sorted(
                self._progs.items(), key=lambda kv: kv[0][1])
                if uid == entry.uid]

    def check_device(self, entry):
        """Raise :class:`MXNetError` unless this batcher's ``device``
        (when set) is the device holding ``entry``'s weights (when it
        has one)."""
        want = entry.device
        if self.device is None or want is None \
                or _same_device(self.device, want):
            return
        raise MXNetError(
            f"serving {entry.name!r}: a replica placed on {self.device} "
            f"cannot run a version whose weights live on {want} — the "
            f"port does not copy weights between devices; placing "
            f"replica weights across cards is ROADMAP.md Queue A, "
            f"item 5 (multi-GPU)")

    def evict(self, entry):
        """Drop cached programs of an unloaded entry (with them its CUDA
        graphs, their memory pools and their hold on the weight
        snapshot) and bar the uid from re-caching (in-flight batches may
        still dispatch it once)."""
        with self._lock:
            self._retired.add(entry.uid)
            for key in [k for k in self._progs if k[0] == entry.uid]:
                del self._progs[key]

    # ---------------------------------------------------------- dispatch
    def bucket_for(self, entry, rows):
        if entry.dynamic_batch:
            return next_bucket(rows, self.config.max_batch_size)
        # static entry: every dispatch pads to the declared batch
        if entry.fixed_batch is None:
            raise MXNetError(
                f"model {entry.name!r}: static signature without a "
                f"batch dimension cannot be batch-served")
        return entry.fixed_batch

    def run_batch(self, entry, request_inputs, deadline=None):
        """Pad, execute, sync, un-pad one coalesced batch.  Returns the
        list of per-request output tuples.  ``deadline`` bounds the
        bucket-program build wait (see :meth:`program_for`)."""
        rows = sum(req[0].shape[0] for req in request_inputs)
        bucket = self.bucket_for(entry, rows)
        # annotate whatever span the dispatching worker entered (the
        # shared batch-assembly span) — no handle threading needed
        _tr.tag("bucket", bucket)
        _tr.tag("rows", rows)
        padded, offsets = pad_batch(request_inputs, bucket)
        prog = self.program_for(entry, bucket, deadline=deadline)
        with _tr.span("serving.execute", bucket=bucket, rows=rows):
            # chaos site: device-execute fail/delay/stall — what the
            # serving retry + bisection + deadline machinery absorbs
            _faults.inject("serving.execute")
            outs = prog(*padded)
            # bounded sync point: block on THIS batch (async errors
            # surface here, the rethrow-at-sync-point contract)
            engine.sync_outputs(outs, site="serving")
        if _rm._ENABLED:
            _rm.SERVING_BATCHES.inc(model=entry.name)
            _rm.SERVING_BATCH_OCCUPANCY.observe(rows / bucket)
        return unpad_outputs(outs, offsets)
