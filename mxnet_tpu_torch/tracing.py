"""End-to-end request tracing + flight recorder (docs/observability.md).

The PyTorch port's own copy of ``mxnet_tpu.tracing`` (the port imports
nothing of the JAX package); span names and knobs are identical.

The runtime-metrics registry answers *how much* and *how slow in
aggregate*; it cannot answer *where one slow request lost its time*.
The serving tier is three async layers deep (``ModelServer`` queues ->
``DynamicBatcher`` coalescing -> ``DecodeEngine`` token steps), so a
p99 in ``serving.request.seconds`` says nothing about whether the tail
came from queue wait, a bucket compile, prefill, or a starved decode
slot.  Production TPU serving is debugged span-by-span (the Gemma-on-
Cloud-TPU serving comparison attributes TTFT regressions to per-phase
timelines; tf.data's per-stage timing is the same idea on the input
path — PAPERS.md).  This module is that plane:

- **Spans**: named monotonic-clock intervals carrying a
  ``trace_id``/``span_id``/``parent_id`` triple and free-form tags.
  Every request gets ONE trace identity that survives all thread hops —
  contexts are handed across the batcher worker pool and the decode
  step loop explicitly (a span may be *started* in the caller's thread
  and *ended* in a worker).  Device calls that serve many traces at
  once (the shared batch execute, the fixed-shape decode step, a
  speculative ``decode.verify`` round) are recorded per interested
  trace via :func:`record_span` with the SAME interval — each trace
  keeps a complete private timeline (docs/observability.md lists the
  span taxonomy, including the §9 ``decode.prefill`` prefix-hit tags
  and ``decode.verify`` proposed/accepted tags).
- **Head-based sampling**: the keep/drop decision is made once, when
  the root span starts (``MXNET_TRACE_SAMPLE``, deterministic stride so
  tests are exact).  An unsampled request carries no context and every
  downstream span call is the no-op path.
- **Flight recorder**: completed traces land in a bounded ring
  (``MXNET_TRACE_RING``) — always the *most recent* N requests, which
  is what you want when a replica starts shedding: the ring plus
  ``ModelServer.debug_state()`` is dumped automatically on overload
  incidents (:func:`record_incident`) and on demand
  (``tools/diagnose.py``).
- **Exporters**: chrome-trace (``chrome://tracing`` / Perfetto) and
  JSON-lines.  ``runtime_metrics.Histogram`` exemplars link the two
  planes: ``observe(..., exemplar=trace_id)`` lets a Prometheus p99
  resolve to the exact trace that caused it.

The TRAINING plane rides the same tracer: ``perf_account`` roots one
``train.step`` trace per attributed ``ShardedTrainer`` step,
decomposed into ``train.data.wait`` / ``train.h2d`` /
``train.compute`` / ``train.collective`` / ``train.optimizer`` spans
(docs/observability.md span taxonomy), so a training timeline opens in
Perfetto next to a serving one and a slow ``trainer.step.seconds`` p99
resolves to its step trace through the same exemplar link.

Overhead contract (mirrors ``runtime_metrics``): tracing is **off by
default**; every instrumentation site either guards on the module-level
``_ENABLED`` bool or goes through :func:`span`/:func:`trace`, which
return a shared no-op singleton when the switch is off — one attribute
load + branch (~ns) per site.  Enable with ``MXNET_TRACE=1`` or
:func:`enable`.  Tracing never touches the device: with the switch in either
position, no extra kernel is launched.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from . import engine
from .base import MXNetError, env_truthy, get_env

__all__ = [
    "Span", "TraceContext", "Tracer", "TRACER",
    "enable", "disable", "enabled", "reset",
    "trace", "span", "record_span", "tag",
    "current_span", "current_context",
    "to_chrome_trace", "dump_chrome_trace", "dump_jsonl",
    "flight_record", "record_incident", "incident_paths",
]

_LOG = logging.getLogger("mxnet_tpu_torch")

# fast-path switch read by every instrumentation site (module attribute
# load + branch — the whole disabled-path cost)
_ENABLED = env_truthy("MXNET_TRACE", False)

# traces hold at most this many spans; a decode loop recording every
# step of a pathological sequence must degrade (drop + count), not grow
_MAX_SPANS_PER_TRACE = 2048
# active (incomplete) traces are bounded too: a request path that never
# closes its root (caller crashed between spans) must not leak forever
_MAX_ACTIVE_TRACES = 256

# one process-unique run prefix so trace ids from two replicas never
# collide in a merged dashboard
_RUN_PREFIX = os.urandom(4).hex()
_NEXT_ID = itertools.count(1)           # CPython: next() is atomic


def enable(sample=None):
    """Turn tracing on for this process (same as ``MXNET_TRACE=1``);
    optionally override the head-sampling rate (``sample=1.0`` traces
    everything)."""
    global _ENABLED
    _ENABLED = True
    if sample is not None:
        TRACER.set_sample(sample)


def disable():
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


class TraceContext:
    """The cross-thread handoff token: enough identity to parent a span
    started in another thread.  Existence implies *sampled* — an
    unsampled request's context is plain ``None`` everywhere, which
    keeps every downstream guard a single ``is None`` check."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext({self.trace_id}/{self.span_id})"

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __hash__(self):
        return hash((self.trace_id, self.span_id))


class _NoopSpan:
    """Shared do-nothing span: what every tracing entry point returns
    when the switch is off or the request was not sampled.  One global
    instance; every method is a constant-time no-op."""

    __slots__ = ()
    sampled = False
    context = None
    tags = None
    t0 = t1 = 0.0

    def set_tag(self, key, value):
        return self

    def end(self, **tags):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "<noop span>"


_NOOP = _NoopSpan()

_TLS = threading.local()


def _tls_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_span():
    """The innermost span entered (``with``) on THIS thread, or None.
    Cross-thread handoffs never use this — they pass a
    :class:`TraceContext` explicitly."""
    if not _ENABLED:
        return None
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def current_context() -> Optional[TraceContext]:
    s = current_span()
    return s.context if s is not None else None


class Span:
    """One named interval of one trace.

    Starts at construction (``time.perf_counter``), ends at
    :meth:`end` (idempotent — first end wins, which makes the
    timeout-vs-worker race on queue-wait spans benign).  May be used as
    a context manager, which additionally installs it as the
    thread-local parent for :func:`span` calls made underneath it.
    Tag mutation is single-writer by convention (the thread currently
    driving the span); the tracer only reads tags after ``end``.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "tags", "thread", "_tracer", "_root")

    sampled = True

    def __init__(self, tracer, name, trace_id, parent_id, tags=None,
                 root=False):
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"{next(_NEXT_ID):08x}"
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t1 = None
        self.tags = dict(tags) if tags else None
        self.thread = threading.current_thread().name
        self._tracer = tracer
        self._root = root

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set_tag(self, key, value):
        if self.tags is None:
            self.tags = {}
        self.tags[key] = value
        return self

    def end(self, **tags):
        """Close the span (idempotent) and hand it to the tracer.  A
        root span's end completes its trace."""
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter()
        for k, v in tags.items():
            self.set_tag(k, v)
        self._tracer._finish(self)

    def __enter__(self):
        _tls_stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        st = _tls_stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:                # defensive: unbalanced nesting
            st.remove(self)
        if exc_type is not None:
            self.set_tag("error", exc_type.__name__)
        self.end()
        return False

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t0": self.t0, "t1": self.t1, "thread": self.thread,
                "tags": dict(self.tags) if self.tags else {}}

    def __repr__(self):
        state = "open" if self.t1 is None else f"{self.t1 - self.t0:.6f}s"
        return (f"Span({self.name}, {self.trace_id}/{self.span_id}, "
                f"{state})")


class Tracer:
    """Span sink: sampling decisions, per-trace span buffers, and the
    bounded completed-trace ring (the flight recorder's storage).

    Span *starts* never take the lock — only :meth:`_finish` (append)
    and trace completion do, so the traced hot path pays one short
    uncontended lock hold per finished span.
    """

    def __init__(self, ring=None, sample=None):
        self._lock = engine.make_lock("tracing.Tracer._lock")
        if ring is None:
            ring = get_env("MXNET_TRACE_RING", typ=int)
        self.ring = max(1, int(ring))
        if sample is None:
            sample = get_env("MXNET_TRACE_SAMPLE", typ=float)
        self._sample = float(sample)
        self._heads = itertools.count()
        # trace_id -> {"root", "wall_time", "spans": [dict], "dropped"}
        self._active: "OrderedDict[str, dict]" = OrderedDict()
        self._completed = deque(maxlen=self.ring)
        self._stats = {"traces_started": 0, "traces_completed": 0,
                       "traces_evicted": 0, "traces_unsampled": 0,
                       "traces_aborted": 0, "spans": 0,
                       "spans_dropped": 0}

    # ------------------------------------------------------------ sampling
    @property
    def sample(self) -> float:
        return self._sample

    def set_sample(self, rate):
        rate = float(rate)
        if not 0.0 <= rate <= 1.0:
            raise MXNetError(
                f"trace sample rate must be in [0, 1], got {rate}")
        with self._lock:
            self._sample = rate

    def _sampled(self) -> bool:
        """Deterministic stride sampling: keep exactly
        ``floor((n+1)*rate) - floor(n*rate)`` of every head — rate 0.25
        keeps every 4th root, with no RNG state to perturb tests."""
        rate = self._sample
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        n = next(self._heads)
        return int((n + 1) * rate) > int(n * rate)

    # ------------------------------------------------------------- spans
    def start_trace(self, name, tags=None):
        """Root a new trace (the head-based sampling point).  Returns
        the root :class:`Span`, or the no-op span when sampled out."""
        if not self._sampled():
            with self._lock:
                self._stats["traces_unsampled"] += 1
            return _NOOP
        trace_id = f"{_RUN_PREFIX}{next(_NEXT_ID):010x}"
        sp = Span(self, name, trace_id, None, tags, root=True)
        with self._lock:
            self._stats["traces_started"] += 1
            self._active[trace_id] = {
                "root": sp.span_id, "wall_time": time.time(),
                "spans": [], "dropped": 0}
            # bound the incomplete set: a caller that dies between
            # spans must not leak its buffer forever
            while len(self._active) > _MAX_ACTIVE_TRACES:
                self._active.popitem(last=False)
                self._stats["traces_aborted"] += 1
        return sp

    def start_span(self, name, parent=None, tags=None):
        """Child span under ``parent`` (a :class:`TraceContext`, a
        :class:`Span`, or None for the current thread-local span).
        Never roots a trace: with no resolvable parent the call is the
        no-op path — traces start only at :meth:`start_trace`."""
        if parent is None:
            parent = current_context()
        elif isinstance(parent, (Span, _NoopSpan)):
            parent = parent.context
        if parent is None:
            return _NOOP
        return Span(self, name, parent.trace_id, parent.span_id, tags)

    def record_span(self, name, parent, t0, t1, tags=None):
        """Append an already-timed span (the decode step loop times one
        device call and attributes it to several sequences)."""
        if parent is None:
            return None
        if isinstance(parent, (Span, _NoopSpan)):
            parent = parent.context
            if parent is None:
                return None
        sp = Span(self, name, parent.trace_id, parent.span_id, tags)
        sp.t0 = t0
        sp.t1 = t1
        self._finish(sp)
        return sp

    def _finish(self, sp: Span):
        done = None
        with self._lock:
            buf = self._active.get(sp.trace_id)
            if buf is None:
                # trace already completed (or aborted): a straggler
                # ending after the root is dropped, not resurrected
                self._stats["spans_dropped"] += 1
                return
            if len(buf["spans"]) >= _MAX_SPANS_PER_TRACE:
                buf["dropped"] += 1
                self._stats["spans_dropped"] += 1
            else:
                buf["spans"].append(sp.to_dict())
                self._stats["spans"] += 1
            if sp.span_id == buf["root"]:
                del self._active[sp.trace_id]
                done = {"trace_id": sp.trace_id, "root": sp.name,
                        "wall_time": buf["wall_time"],
                        "duration": (sp.t1 or sp.t0) - sp.t0,
                        "dropped_spans": buf["dropped"],
                        "spans": sorted(buf["spans"],
                                        key=lambda s: s["t0"])}
                if len(self._completed) == self._completed.maxlen:
                    self._stats["traces_evicted"] += 1
                self._completed.append(done)
                self._stats["traces_completed"] += 1

    # ------------------------------------------------------------ readers
    def traces(self, n=None) -> List[dict]:
        """Completed traces, oldest first (the flight-recorder ring)."""
        with self._lock:
            out = list(self._completed)
        return out if n is None else out[-n:]

    def find(self, trace_id) -> Optional[dict]:
        with self._lock:
            for tr in self._completed:
                if tr["trace_id"] == trace_id:
                    return tr
        return None

    def last(self, root=None) -> Optional[dict]:
        """Most recent completed trace (optionally: whose root span has
        name ``root``)."""
        with self._lock:
            for tr in reversed(self._completed):
                if root is None or tr["root"] == root:
                    return tr
        return None

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["active"] = len(self._active)
            out["completed"] = len(self._completed)
        out["enabled"] = _ENABLED
        out["sample"] = self._sample
        out["ring"] = self.ring
        return out

    def reset(self):
        """Drop every buffered trace and zero the counters (tests)."""
        with self._lock:
            self._active.clear()
            self._completed.clear()
            for k in self._stats:
                self._stats[k] = 0


TRACER = Tracer()


def reset():
    TRACER.reset()


# ---------------------------------------------------------------------------
# Module-level instrumentation helpers (the hot-path entry points)
# ---------------------------------------------------------------------------

def trace(name, **tags):
    """Root a new trace; returns the root span (or the no-op span when
    tracing is off / sampled out).  Use as a context manager around one
    request."""
    if not _ENABLED:
        return _NOOP
    return TRACER.start_trace(name, tags or None)


def span(name, parent=None, **tags):
    """Child span under ``parent`` (explicit cross-thread context, or
    the current thread-local span).  No parent resolvable -> no-op."""
    if not _ENABLED:
        return _NOOP
    return TRACER.start_span(name, parent=parent, tags=tags or None)


def record_span(name, parent, t0, t1, tags=None):
    """Append a span with explicit timestamps (no-op when off or when
    ``parent`` is None)."""
    if not _ENABLED:
        return None
    return TRACER.record_span(name, parent, t0, t1, tags)


def tag(key, value):
    """Tag the current thread-local span, if any (the batcher annotates
    whatever span the worker entered, without threading handles)."""
    if not _ENABLED:
        return
    s = current_span()
    if s is not None:
        s.set_tag(key, value)


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def to_chrome_trace(traces) -> dict:
    """Render completed trace dicts as a chrome-trace JSON object
    (``chrome://tracing`` / Perfetto: ``ph:"X"`` complete events, ts in
    microseconds, one row per span thread).  Accepts one trace dict or
    a list of them."""
    if isinstance(traces, dict):
        traces = [traces]
    pid = os.getpid()
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": "mxnet_tpu_torch"}}]
    for tr in traces:
        for s in tr["spans"]:
            dur = max(0.0, (s["t1"] or s["t0"]) - s["t0"])
            args = dict(s["tags"])
            args.update({"trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"]})
            events.append({"name": s["name"], "cat": tr["root"],
                           "ph": "X", "ts": s["t0"] * 1e6,
                           "dur": dur * 1e6, "pid": pid,
                           "tid": s["thread"], "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path, traces=None) -> str:
    """Write chrome-trace JSON for ``traces`` (default: the whole
    completed ring) to ``path``; returns the path."""
    if traces is None:
        traces = TRACER.traces()
    with open(path, "w") as f:
        json.dump(to_chrome_trace(traces), f)
    return path


def dump_jsonl(path=None, traces=None) -> str:
    """One JSON object per span, one span per line (log-pipeline
    friendly).  Returns the serialized text; also writes it when
    ``path`` is given."""
    if traces is None:
        traces = TRACER.traces()
    elif isinstance(traces, dict):
        traces = [traces]
    lines = []
    for tr in traces:
        for s in tr["spans"]:
            rec = dict(s)
            rec["root"] = tr["root"]
            lines.append(json.dumps(rec, sort_keys=True))
    text = "\n".join(lines) + ("\n" if lines else "")
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

# incident bookkeeping lives under its own lock: record_incident is
# called from shed paths that may already hold serving locks released —
# the tracer lock is never needed here beyond the reader calls
_INCIDENT_LOCK = engine.make_lock("tracing._INCIDENT_LOCK")
_INCIDENTS: Dict[str, object] = {"last": 0.0, "count": 0,
                                 "paths": deque(maxlen=16)}
_INCIDENT_MIN_INTERVAL = 30.0


def flight_record(state=None) -> dict:
    """The flight-recorder snapshot: tracer stats + the completed-trace
    ring, plus whatever server ``state`` the caller attaches
    (``ModelServer.debug_state()``).  Under an active chaos plan
    (``MXNET_FAULTS``) the record also carries the plan spec and its
    fired-fault counters — an incident dump from a chaos run must say
    which injected faults the stack was absorbing at the time."""
    record = {"wall_time": time.time(),
              "tracer": TRACER.stats(),
              "traces": TRACER.traces(),
              "state": state}
    from . import faults as _faults        # lazy: faults imports tracing
    plan = _faults.active()
    if plan is not None:
        record["faults"] = {"spec": plan.spec,
                            "fired": plan.counters()}
    return record


def record_incident(reason, state=None, path=None, min_interval=None):
    """Dump the flight recorder to disk because something went wrong
    (load shedding, an eviction storm, a decode step failure).

    ``state`` may be a dict or a zero-arg callable (evaluated only when
    the dump actually happens — debounce keeps a shedding storm from
    serializing the server state per rejected request).  Dumps are
    rate-limited to one per ``min_interval`` seconds (default 30);
    returns the written path, or None when debounced/disabled.
    """
    if not _ENABLED:
        return None
    interval = _INCIDENT_MIN_INTERVAL if min_interval is None \
        else float(min_interval)
    now = time.monotonic()
    with _INCIDENT_LOCK:
        if now - _INCIDENTS["last"] < interval and _INCIDENTS["count"]:
            return None
        _INCIDENTS["last"] = now
        _INCIDENTS["count"] += 1
        seq = _INCIDENTS["count"]
    if callable(state):
        try:
            state = state()
        except Exception as e:          # noqa: BLE001 — best effort
            state = {"error": f"debug_state failed: {e}"}
    record = flight_record(state)
    record["reason"] = reason
    if path is None:
        path = os.path.join(
            tempfile.gettempdir(),
            f"mxnet_flight_{os.getpid()}_{seq:03d}.json")
    try:
        with open(path, "w") as f:
            json.dump(record, f, default=str)
    except OSError as e:
        _LOG.warning("tracing: flight-recorder dump failed: %s", e)
        return None
    with _INCIDENT_LOCK:
        _INCIDENTS["paths"].append(path)
    _LOG.warning("tracing: incident %r — flight record dumped to %s "
                 "(%d trace(s))", reason, path, len(record["traces"]))
    return path


def incident_paths() -> List[str]:
    """Paths of the flight-recorder dumps written so far."""
    with _INCIDENT_LOCK:
        return list(_INCIDENTS["paths"])
