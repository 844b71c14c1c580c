"""Process-wide runtime metrics registry: Counter / Gauge / Histogram.

The PyTorch port's copy of ``mxnet_tpu.runtime_metrics``: the same
registry, exporters and metric names for the serving slice
(``serving.decode.*``, ``serving.decode.prefix.*``,
``serving.decode.spec.*``, ``kv.shared_pages``, ...), so dashboards
read either package unchanged.  Exporters: ``dump_prometheus()`` (text
exposition) and ``chrome_counter_events()`` (chrome-trace counters).

Overhead contract: metrics are **off by default**.  Every
instrumentation site guards on the module-level ``_ENABLED`` bool, so
the disabled path costs one attribute load + branch per event.  Enable
with ``MXNET_RUNTIME_METRICS=1`` or ``runtime_metrics.enable()``.
"""
from __future__ import annotations

import logging
import math
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from .base import MXNetError, env_truthy

_LOG = logging.getLogger("mxnet_tpu_torch")

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "enable", "disable", "enabled",
    "reset", "snapshot", "dump_prometheus", "chrome_counter_events",
    "sample_memory",
]

# fast-path switch read by every instrumentation site (module attribute
# load + branch — the whole disabled-path cost)
_ENABLED = env_truthy("MXNET_RUNTIME_METRICS", False)


def enable():
    """Turn the registry on for this process (same as
    ``MXNET_RUNTIME_METRICS=1``)."""
    global _ENABLED
    _ENABLED = True

def disable():
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    """Canonical dotted names -> Prometheus metric names
    (``op.invoke`` -> ``op_invoke``)."""
    return _NAME_RE.sub("_", name)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    iv = int(v)
    return str(iv) if v == iv else repr(float(v))


# per-metric bound on distinct label-value tuples: a call site that
# labels with a request-scoped value (user id, trace id, prompt...)
# would otherwise grow the registry without bound.  Beyond the bound,
# new label sets clamp into one overflow series and the metric warns
# ONCE — memory stays bounded, the misuse stays visible.
MAX_LABEL_SETS = 512
_OVERFLOW_LABEL = "__overflow__"


class _Metric:
    """Base: a named metric with optional label dimensions.

    Values are stored per label-value tuple; the unlabeled case is the
    empty tuple.  Each metric carries its own lock — mutation under it,
    export takes a consistent snapshot under it.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        # per-instance so tests (and unusual metrics) can tighten it
        self.max_label_sets = MAX_LABEL_SETS
        self._cardinality_warned = False

    def _store_key(self, store: dict,
                   key: Tuple[str, ...]) -> Tuple[str, ...]:
        """Cardinality guard — call with ``self._lock`` held.  A key
        already tracked passes through; a NEW key past the bound clamps
        to the shared overflow series (warning once), so per-request
        label misuse cannot grow memory without bound."""
        if not self.labelnames or key in store \
                or len(store) < self.max_label_sets:
            return key
        # mxlint: disable=atomicity (contract: callers hold self._lock,
        # per this method's docstring — the flag check-then-set is
        # already serialized; and the worst case is one extra warning)
        if not self._cardinality_warned:
            # mxlint: disable=lock-discipline (contract: callers hold
            # self._lock — every call site is inside `with self._lock`)
            self._cardinality_warned = True
            _LOG.warning(
                "metric %r exceeded %d distinct label sets — further "
                "new label values clamp into %s (per-request values do "
                "not belong in labels; put them in span tags via "
                "mxnet_tpu_torch.tracing instead)",
                self.name, self.max_label_sets, _OVERFLOW_LABEL)
        return (_OVERFLOW_LABEL,) * len(self.labelnames)

    def _label_values(self, store, labelname):
        """Distinct recorded values of one label dimension, sorted —
        call via the subclass ``label_values`` (each owns its store).
        The enumeration a fleet sensor or doctor tool needs to sum a
        labeled family without touching private state."""
        try:
            i = self.labelnames.index(labelname)
        except ValueError:
            raise MXNetError(
                f"metric {self.name!r} has no label {labelname!r} "
                f"(labels: {self.labelnames})") from None
        with self._lock:
            return sorted({k[i] for k in store})

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if not self.labelnames:
            if labels:
                raise MXNetError(
                    f"metric {self.name!r} takes no labels, got {labels}")
            return ()
        try:
            return tuple(str(labels[k]) for k in self.labelnames)
        except KeyError as e:
            raise MXNetError(
                f"metric {self.name!r} requires labels "
                f"{self.labelnames}, got {sorted(labels)}") from e


class Counter(_Metric):
    """Monotonically increasing count (exported with a ``_total`` suffix)."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1, **labels):
        # validate BEFORE the enabled check: a bad call site must fail
        # the same way whether or not the registry is switched on
        if amount < 0:
            raise MXNetError(f"counter {self.name!r}: negative increment")
        if not _ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            key = self._store_key(self._values, key)
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def label_values(self, labelname):
        return self._label_values(self._values, labelname)

    def _snapshot(self):
        with self._lock:
            return dict(self._values)

    def _reset(self):
        with self._lock:
            self._values.clear()


class Gauge(_Metric):
    """A value that can go up and down (queue depth, live bytes, ...)."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels):
        if not _ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            key = self._store_key(self._values, key)
            self._values[key] = float(value)

    def set_max(self, value: float, **labels):
        """Keep the maximum seen (high-watermark gauges)."""
        if not _ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            key = self._store_key(self._values, key)
            cur = self._values.get(key)
            if cur is None or value > cur:
                self._values[key] = float(value)

    def inc(self, amount: float = 1, **labels):
        if not _ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            key = self._store_key(self._values, key)
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def label_values(self, labelname):
        return self._label_values(self._values, labelname)

    def _snapshot(self):
        with self._lock:
            return dict(self._values)

    def _reset(self):
        with self._lock:
            self._values.clear()


# default buckets cover host-side latencies (~us) through step times (~s)
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics) with a
    bucket-interpolated ``quantile()`` reader and per-bucket
    **exemplars**: ``observe(v, exemplar=trace_id)`` remembers the most
    recent trace that landed in each bucket, so a scraped p99 links
    straight to the trace behind it (``exemplar_for_quantile``)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bs:
            raise MXNetError(f"histogram {self.name!r}: empty buckets")
        self.buckets = bs
        # per label key: [[per-bucket counts..., +Inf count], sum,
        #                 count, [per-bucket (exemplar, value) | None]]
        self._data: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, exemplar=None, **labels):
        """Record one observation.  ``exemplar`` (typically a
        ``tracing`` trace id) is attached to the bucket the value lands
        in — latest exemplar per bucket wins."""
        if not _ENABLED:
            return
        key = self._key(labels)
        v = float(value)
        with self._lock:
            key = self._store_key(self._data, key)
            entry = self._data.get(key)
            if entry is None:
                n = len(self.buckets) + 1
                entry = [[0] * n, 0.0, 0, [None] * n]
                self._data[key] = entry
            counts = entry[0]
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            counts[i] += 1
            entry[1] += v
            entry[2] += 1
            if exemplar is not None:
                entry[3][i] = (str(exemplar), v)

    def count(self, **labels) -> int:
        with self._lock:
            entry = self._data.get(self._key(labels))
            return entry[2] if entry else 0

    def sum(self, **labels) -> float:
        with self._lock:
            entry = self._data.get(self._key(labels))
            return entry[1] if entry else 0.0

    def bucket_counts(self, **labels):
        """Cumulative per-bucket observation counts, aligned with
        ``buckets + (+Inf,)`` — a consistent snapshot.  The raw
        material for WINDOWED quantiles: diff two snapshots and feed
        the delta to an interpolator, so a control loop (the serving
        autoscaler's p99 sensor) reads the last interval instead of
        the process lifetime."""
        with self._lock:
            entry = self._data.get(self._key(labels))
            return list(entry[0]) if entry \
                else [0] * (len(self.buckets) + 1)

    def label_values(self, labelname):
        """Distinct recorded values of one label dimension, sorted —
        the enumeration a fleet sensor needs: replica-path engines
        observe under ``model="name/rid"`` while a direct engine uses
        ``model="name"``, and summing those series' ``bucket_counts``
        yields the set-wide distribution."""
        return self._label_values(self._data, labelname)

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile by linear interpolation inside the
        bucket that crosses rank q*count (Prometheus histogram_quantile
        semantics).  Values beyond the last finite bucket clamp to it."""
        if not 0.0 <= q <= 1.0:
            raise MXNetError(f"quantile {q} outside [0, 1]")
        with self._lock:
            entry = self._data.get(self._key(labels))
            if entry is None or entry[2] == 0:
                return float("nan")
            counts, _, total = entry[0], entry[1], entry[2]
            rank = q * total
            cum = 0.0
            lo = 0.0
            for i, b in enumerate(self.buckets):
                prev = cum
                cum += counts[i]
                if cum >= rank:
                    frac = 0.0 if counts[i] == 0 else \
                        (rank - prev) / counts[i]
                    return lo + (b - lo) * frac
                lo = b
            return self.buckets[-1]

    def exemplars(self, **labels):
        """Per-bucket ``(exemplar, value)`` pairs (None where no
        exemplar landed), aligned with ``buckets + (+Inf,)``."""
        with self._lock:
            entry = self._data.get(self._key(labels))
            return list(entry[3]) if entry else \
                [None] * (len(self.buckets) + 1)

    def exemplar_for_quantile(self, q: float, **labels):
        """The exemplar (trace id) nearest the q-quantile: the bucket
        the quantile falls in, else the closest populated neighbor
        (higher buckets first — for a p99 you want the slower trace).
        Returns the exemplar string, or None."""
        if not 0.0 <= q <= 1.0:
            raise MXNetError(f"quantile {q} outside [0, 1]")
        with self._lock:
            entry = self._data.get(self._key(labels))
            if entry is None or entry[2] == 0:
                return None
            counts, _, total, exemplars = entry
            rank = q * total
            cum = 0.0
            idx = len(counts) - 1
            for i, c in enumerate(counts):
                cum += c
                if cum >= rank:
                    idx = i
                    break
            for i in list(range(idx, len(exemplars))) + \
                    list(range(idx - 1, -1, -1)):
                if exemplars[i] is not None:
                    return exemplars[i][0]
            return None

    def _snapshot(self):
        with self._lock:
            return {k: (list(e[0]), e[1], e[2])
                    for k, e in self._data.items()}

    def _snapshot_exemplars(self):
        with self._lock:
            return {k: list(e[3]) for k, e in self._data.items()}

    def _reset(self):
        with self._lock:
            self._data.clear()


class MetricsRegistry:
    """Get-or-create store of named metrics (process-wide singleton at
    ``runtime_metrics.REGISTRY``)."""

    def __init__(self):
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, labelnames=labelnames, **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise MXNetError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        if tuple(labelnames) != m.labelnames:
            raise MXNetError(
                f"metric {name!r} registered with labels {m.labelnames}, "
                f"requested {tuple(labelnames)}")
        if cls is Histogram and kwargs.get("buckets") is not None:
            want = tuple(sorted(float(b) for b in kwargs["buckets"]))
            if want != m.buckets:
                raise MXNetError(
                    f"histogram {name!r} registered with buckets "
                    f"{m.buckets}, requested {want}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self):
        """Zero every metric's samples (registrations survive — module
        handles like ``OP_INVOKE`` stay valid).  Test/tool helper."""
        for m in self.collect():
            m._reset()


REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)


def reset():
    REGISTRY.reset()


def snapshot() -> Dict[str, dict]:
    """Plain-dict view {name: {"type", "labels", "values"}} for tooling
    (tools/diagnose.py)."""
    _run_collect_hooks()
    out = {}
    for m in REGISTRY.collect():
        if m.kind == "histogram":
            values = {",".join(k) or "": {"count": e[2], "sum": e[1]}
                      for k, e in m._snapshot().items()}
        else:
            values = {",".join(k) or "": v
                      for k, v in m._snapshot().items()}
        out[m.name] = {"type": m.kind, "labels": m.labelnames,
                       "values": values}
    return out


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def _escape_label(v: str) -> str:
    """Prometheus exposition label-value escaping (backslash, quote,
    newline) — label values are arbitrary user strings (model names)."""
    return v.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")


def _label_str(labelnames, key) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(labelnames, key))
    return "{" + pairs + "}"


# Gauges that are cheapest to refresh at scrape time (rather than on
# every mutation of the underlying structure) register a collect hook;
# every exporter runs them first.
_COLLECT_HOOKS: List = []
_COLLECT_HOOKS_LOCK = threading.Lock()


def register_collect_hook(fn):
    with _COLLECT_HOOKS_LOCK:
        _COLLECT_HOOKS.append(fn)


def _run_collect_hooks():
    for fn in list(_COLLECT_HOOKS):
        try:
            fn()
        except Exception:       # noqa: BLE001 — exporters must not die
            pass


def dump_prometheus() -> str:
    """Serialize every metric in the Prometheus text exposition format.
    Counters get the conventional ``_total`` suffix; histograms render
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``."""
    _run_collect_hooks()
    lines = []
    for m in REGISTRY.collect():
        base = _sanitize(m.name)
        if m.kind == "counter":
            base += "_total"
        if m.help:
            lines.append(f"# HELP {base} {m.help}")
        lines.append(f"# TYPE {base} {m.kind}")
        if m.kind in ("counter", "gauge"):
            snap = m._snapshot()
            if not snap and not m.labelnames:
                snap = {(): 0.0}
            for key in sorted(snap):
                lines.append(
                    f"{base}{_label_str(m.labelnames, key)} "
                    f"{_fmt(snap[key])}")
        else:  # histogram
            snap = m._snapshot()
            exs = m._snapshot_exemplars()

            def _ex(key, i):
                # OpenMetrics exemplar suffix: the bucket's most recent
                # trace id, so a scraped p99 resolves to a trace
                e = exs.get(key)
                if not e or e[i] is None:
                    return ""
                tid, v = e[i]
                return (f' # {{trace_id="{_escape_label(tid)}"}} '
                        f"{_fmt(v)}")

            for key in sorted(snap):
                counts, total, n = snap[key]
                cum = 0
                for i, b in enumerate(m.buckets):
                    cum += counts[i]
                    lbl = _label_str(m.labelnames + ("le",),
                                     key + (_fmt(b),))
                    lines.append(f"{base}_bucket{lbl} {cum}"
                                 f"{_ex(key, i)}")
                cum += counts[-1]
                lbl = _label_str(m.labelnames + ("le",), key + ("+Inf",))
                lines.append(f"{base}_bucket{lbl} {cum}"
                             f"{_ex(key, len(m.buckets))}")
                ls = _label_str(m.labelnames, key)
                lines.append(f"{base}_sum{ls} {_fmt(total)}")
                lines.append(f"{base}_count{ls} {n}")
    return "\n".join(lines) + "\n"


def chrome_counter_events(t0_us: float = 0.0) -> List[dict]:
    """Snapshot every metric as chrome-trace ``ph:"C"`` counter events
    (one event per metric; labeled series become one arg per label set).
    ``profiler.dumps()`` merges these into the host-span trace so
    counters share the timeline with op/user scopes."""
    _run_collect_hooks()
    ts = time.perf_counter() * 1e6 - t0_us
    pid = os.getpid()
    events = []
    for m in REGISTRY.collect():
        if m.kind == "histogram":
            args = {}
            for key, (counts, total, n) in sorted(m._snapshot().items()):
                tag = ",".join(key) or "all"
                args[f"{tag}.count"] = n
                args[f"{tag}.sum"] = total
        else:
            snap = m._snapshot()
            args = {",".join(key) or m.name: v
                    for key, v in sorted(snap.items())}
        if not args:
            continue
        events.append({"name": m.name, "ph": "C", "ts": ts, "pid": pid,
                       "args": args})
    return events


# ---------------------------------------------------------------------------
# Pre-declared instruments for the built-in instrumentation sites.
# Call sites guard on `_ENABLED` before touching these.
# ---------------------------------------------------------------------------

MEMORY_LIVE_BYTES = gauge(
    "memory.live_bytes",
    "Live accelerator bytes per device (host RSS fallback when the "
    "backend reports no memory_stats).", labelnames=("device",))
SERVING_SHED = counter(
    "serving.shed",
    "Requests rejected with ServerOverloadedError because the bounded "
    "queue sat at/above the load-shedding watermark.",
    labelnames=("model",))
SERVING_DECODE_STEPS = counter(
    "serving.decode.steps",
    "Scheduler iterations of the continuous-batching decode engine "
    "(admit -> prefill -> one decode step -> evict), per model.",
    labelnames=("model",))
SERVING_DECODE_TOKENS = counter(
    "serving.decode.tokens",
    "Tokens generated by the decode engine (prefill first tokens + "
    "decode-step tokens), per model.", labelnames=("model",))
SERVING_DECODE_EVICTIONS = counter(
    "serving.decode.evictions",
    "Sequences evicted from the decode batch (finished, cancelled, or "
    "failed) with their KV pages returned to the free list, per model.",
    labelnames=("model",))
SERVING_DECODE_TTFT_SECONDS = histogram(
    "serving.decode.ttft.seconds",
    "Time to first token: generate() submission to the first sampled "
    "token (queueing + prefill), per model.", labelnames=("model",))
SERVING_DECODE_TOKEN_SECONDS = histogram(
    "serving.decode.token.seconds",
    "Per-token decode latency (time between consecutive sampled tokens "
    "of one sequence), per model.", labelnames=("model",))
SERVING_DECODE_KV_OCCUPANCY = gauge(
    "serving.decode.kv.occupancy",
    "Used fraction of the paged KV cache pool (allocated pages / "
    "usable pages), per decode engine.", labelnames=("engine",))
SERVING_PREFIX_HITS = counter(
    "serving.decode.prefix.hits",
    "Prompts admitted with a prefix-cache hit (>= 1 full page of "
    "prompt K/V aliased from the radix tree instead of prefilled), "
    "per model (docs/serving.md §9).", labelnames=("model",))
SERVING_PREFIX_MISSES = counter(
    "serving.decode.prefix.misses",
    "Prefix-cache lookups that matched nothing (the prompt prefilled "
    "in full, then seeded the cache), per model.  hits/(hits+misses) "
    "is the live hit ratio.", labelnames=("model",))
SERVING_PREFIX_TOKENS_SAVED = counter(
    "serving.decode.prefix.tokens_saved",
    "Prompt tokens whose prefill was skipped by prefix-cache hits "
    "(matched tokens minus the one re-run token of a full hit), per "
    "model — the TTFT work the cache removed.", labelnames=("model",))
SERVING_SPEC_PROPOSED = counter(
    "serving.decode.spec.proposed",
    "Draft tokens proposed by speculative decoding, per model "
    "(docs/serving.md §9).", labelnames=("model",))
SERVING_SPEC_ACCEPTED = counter(
    "serving.decode.spec.accepted",
    "Draft tokens accepted by target verification, per model.  "
    "accepted/proposed is the draft acceptance rate; each round also "
    "emits one non-speculative (correction or bonus) token.",
    labelnames=("model",))
KV_SHARED_PAGES = gauge(
    "kv.shared_pages",
    "KV pages currently referenced more than once (shared between "
    "sequences and/or the prefix cache) in a decode engine's paged "
    "pool, per engine.", labelnames=("engine",))
SERVING_FAULTS = counter(
    "serving.faults",
    "Faults fired by the active fault-injection plan "
    "(mxnet_tpu.faults, MXNET_FAULTS), labeled by injection site and "
    "mode (fail|delay|corrupt|stall).",
    labelnames=("site", "mode"))
SERVING_RETRIES = counter(
    "serving.retries",
    "Transient-failure retries on the serving execute paths (coalesced "
    "batch re-execution, decode prefill/step re-execution), per model.",
    labelnames=("model",))
SERVING_DEADLINE_EXCEEDED = counter(
    "serving.deadline_exceeded",
    "Requests failed by end-to-end deadline expiry (in the queue, at "
    "batch assembly, or mid-generation), per model.",
    labelnames=("model",))
SERVING_DECODE_QUARANTINED = counter(
    "serving.decode.quarantined",
    "Sequences evicted alone after a decode/prefill step failure was "
    "bisected down to them (pages reclaimed, batchmates keep "
    "decoding), per model.", labelnames=("model",))


# ---------------------------------------------------------------------------
# Memory sampling
# ---------------------------------------------------------------------------

def _host_rss_bytes() -> float:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        return 0.0


def sample_memory() -> List[Tuple[str, float, Optional[float]]]:
    """Sample per-device live bytes into the ``memory.live_bytes`` gauge.

    Returns ``[(device_label, live_bytes, bytes_limit_or_None), ...]``
    for every CUDA device ``torch.cuda`` lists (allocated bytes against
    the device's total memory), or one host-RSS sample labeled ``host``
    when no card is present.
    """
    import torch
    stats = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats.append((f"cuda:{i}",
                          float(torch.cuda.memory_allocated(i)),
                          float(torch.cuda.get_device_properties(i)
                                .total_memory)))
    if not stats:
        stats = [("host", _host_rss_bytes(), None)]
    if _ENABLED:
        for dev, used, _limit in stats:
            MEMORY_LIVE_BYTES.set(used, device=dev)
    return stats
