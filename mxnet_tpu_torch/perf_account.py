"""Per-step training performance accounting: step attribution, MFU and
the bottleneck verdict.

The PyTorch port's copy of ``mxnet_tpu.perf_account``:

- **Step attribution** (:class:`StepAttribution`): each attributed
  trainer step roots a ``train.step`` trace decomposed into
  ``train.data.wait`` (noted by a data loader via :func:`note_data_wait`
  and back-dated into the step that consumes the batch), ``train.h2d``,
  ``train.compute`` and ``train.optimizer`` (each closed by a device
  synchronisation, so the interval is device time) and a zero-length
  ``train.collective`` marker (one card, no collective).
- **Runtime MFU** (:func:`step_flops` / :func:`mfu`): the matrix-product
  FLOPs of the step the trainer runs (the trainer counts them, once per
  batch signature), over the measured step time and the card's peak
  (``MXNET_PEAK_TFLOPS`` or :func:`detect_peak_tflops`), published as
  the ``train.mfu`` gauge.
- **Bottleneck verdict**: over a rolling window of steps, the largest
  non-compute phase names the bottleneck (``input_bound``,
  ``comm_bound``, else ``compute_bound``), published as the
  ``train.bottleneck`` gauge.

Overhead contract: with both ``MXNET_TRACE`` and
``MXNET_RUNTIME_METRICS`` off, :meth:`StepAttribution.step_start`
returns one shared inert handle and the trainer's step runs unobserved
(no synchronisation is added).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque

from . import runtime_metrics as _rm
from . import tracing as _tr
from .base import get_env

__all__ = [
    "PHASES", "VERDICTS", "StepAttribution",
    "mfu", "step_flops", "detect_peak_tflops",
    "note_data_wait", "take_data_wait",
    "current_verdict", "current_mfu", "reset",
]

_LOG = logging.getLogger("mxnet_tpu_torch")

# breakdown phases (the `phase` label of train.step.breakdown.seconds);
# every attributed step observes all five so the per-phase histograms
# stay directly comparable and the phases tile the train.step interval
PHASES = ("data_wait", "h2d", "compute", "collective", "optimizer")

# span leaf per phase (span name = f"train.{leaf}")
_SPAN_LEAF = {"data_wait": "data.wait"}

# verdict encoding of the train.bottleneck gauge (index = gauge value)
VERDICTS = ("compute_bound", "input_bound", "comm_bound")
_VERDICT_CODE = {v: i for i, v in enumerate(VERDICTS)}

# which verdict a non-compute phase votes for; compute + optimizer
# count as compute time
_PHASE_VERDICT = {"data_wait": "input_bound", "h2d": "input_bound",
                  "collective": "comm_bound"}

# dense bf16 tensor-core peak of the cards the port knows (NVIDIA's data
# sheets, SXM parts); matched against torch.cuda.get_device_name
_PEAK_TFLOPS = (("H100", 989.0), ("H200", 989.0))


# ---------------------------------------------------------------------------
# FLOPs / MFU accounting
# ---------------------------------------------------------------------------

def mfu(n_params, B, L, dt, peak_tflops):
    """The 6NBL transformer rule: 6 * params * tokens FLOPs per step,
    over measured step seconds and the per-card peak."""
    return 6.0 * n_params * B * L / dt / (peak_tflops * 1e12)


def step_flops(trainer, batch):
    """Model FLOPs of one training step of ``trainer`` on ``batch``: the
    trainer's own count (``trainer.step_flops(*batch)``; the port's
    :meth:`~mxnet_tpu_torch.parallel.ShardedTrainer.step_flops` counts
    the step it runs, as the JAX package counts its compiled step), or
    None for a trainer that cannot count its step."""
    count = getattr(trainer, "step_flops", None)
    return count(*batch) if count is not None else None


def detect_peak_tflops(device_name=None):
    """Per-card dense bf16 peak TFLOP/s for MFU: ``MXNET_PEAK_TFLOPS``
    when set (> 0), else the data-sheet peak of the card
    ``torch.cuda.get_device_name(0)`` names (H100 / H200: 989), else 0.0
    (unknown: MFU then reports 0 rather than a made-up figure)."""
    override = float(get_env("MXNET_PEAK_TFLOPS", typ=float) or 0.0)
    if override > 0:
        return override
    if device_name is None:
        import torch
        if not torch.cuda.is_available():
            return 0.0
        device_name = torch.cuda.get_device_name(0)
    for key, peak in _PEAK_TFLOPS:
        if key in device_name:
            return peak
    return 0.0


# ---------------------------------------------------------------------------
# Data-wait handoff (data loader -> the step that consumes the batch)
# ---------------------------------------------------------------------------

# thread-local: the loader runs on the train-loop thread right before
# step(); only the consumer-visible wait counts
_TLS = threading.local()


def note_data_wait(t0, t1):
    """Record the host interval one batch fetch took; the next
    :meth:`StepAttribution.step_start` on this thread consumes it as the
    step's ``train.data.wait``."""
    _TLS.data_wait = (t0, t1)


def take_data_wait():
    """Pop the pending data-wait interval, or None."""
    iv = getattr(_TLS, "data_wait", None)
    if iv is not None:
        _TLS.data_wait = None
    return iv


# ---------------------------------------------------------------------------
# Last-published snapshot (single-writer per publish, torn reads benign)
# ---------------------------------------------------------------------------

_LAST = {"verdict": None, "mfu": 0.0}


def current_verdict():
    """The verdict of the most recent attributed step in this process
    (any trainer), or None before the first one."""
    return _LAST["verdict"]


def current_mfu():
    """MFU over the attribution window of the most recent attributed
    step (0.0 when FLOPs or the peak are unknown)."""
    return _LAST["mfu"]


def reset():
    """Clear process-level attribution state (tests)."""
    _LAST["verdict"] = None
    _LAST["mfu"] = 0.0
    _TLS.data_wait = None


# ---------------------------------------------------------------------------
# Step handles
# ---------------------------------------------------------------------------

class _InertPhase:
    """No-op phase context (the off path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_INERT_PHASE = _InertPhase()


class _InertHandle:
    """Shared do-nothing step handle: what :meth:`step_start` returns
    when both tracing and metrics are off."""

    __slots__ = ()
    active = False
    root = None

    def phase(self, name, **tags):
        return _INERT_PHASE

    def record(self, name, t0, t1, **tags):
        return None

    def mark(self, name, **tags):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_INERT = _InertHandle()


class _PhaseTimer:
    """``with h.phase("h2d"):`` — times the block and records it."""

    __slots__ = ("_h", "_name", "_tags", "_t0")

    def __init__(self, h, name, tags):
        self._h = h
        self._name = name
        self._tags = tags
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if exc_type is not None:
            self._tags["error"] = exc_type.__name__
        self._h.record(self._name, self._t0, t1, **self._tags)
        return False


class _StepHandle:
    """One attributed step: phase accumulator + the ``train.step`` root
    span.  Enter it (``with h:``) around the step body; exiting ends the
    root and publishes the breakdown."""

    __slots__ = ("att", "root", "seconds", "t_begin", "t_end")

    def __init__(self, att, root, t_begin):
        self.att = att
        self.root = root
        self.seconds = {}
        self.t_begin = t_begin
        self.t_end = None

    active = True

    def phase(self, name, **tags):
        """Context manager timing one phase of this step."""
        return _PhaseTimer(self, name, tags)

    def record(self, name, t0, t1, **tags):
        """Add an already-timed interval to phase ``name`` and record
        the matching ``train.*`` span (no-op span when unsampled)."""
        self.seconds[name] = self.seconds.get(name, 0.0) + (t1 - t0)
        leaf = _SPAN_LEAF.get(name, name)
        _tr.record_span(f"train.{leaf}", self.root, t0, t1,
                        tags or None)

    def mark(self, name, **tags):
        """Zero-length phase marker: it contributes 0 s to the breakdown
        while its tags carry the accounting."""
        t = time.perf_counter()
        self.record(name, t, t, **tags)

    def __enter__(self):
        if self.root.sampled:
            self.root.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t_end = time.perf_counter()
        if self.root.sampled:
            self.root.__exit__(exc_type, exc, tb)
        self.att._publish(self)
        return False


class StepAttribution:
    """Per-trainer step-time attribution, windowed MFU, and the
    bottleneck verdict.

    Owned by one train-loop thread (no internal locking).
    ``ShardedTrainer`` drives it from ``step()``; other loops drive the
    same handle API directly::

        att = StepAttribution()
        h = att.step_start()
        with h:                      # roots the train.step span
            with h.phase("h2d"):
                dev_batch = stage(batch)
            with h.phase("compute"):
                loss = run(dev_batch)
            h.mark("collective")
        # exit published breakdown histograms, MFU, and the verdict

    ``threshold`` is the window fraction the largest non-compute phase
    must reach before the verdict leaves ``compute_bound``.
    """

    def __init__(self, window=32, threshold=0.25, peak_tflops=None):
        self._window = deque(maxlen=int(window))
        self.threshold = float(threshold)
        self.peak_tflops = (detect_peak_tflops()
                            if peak_tflops is None else
                            float(peak_tflops))
        self.flops_per_step = None      # unknown until note_flops
        self._flops_warned = False
        self._verdict = None
        self._mfu = 0.0
        self._steps = 0

    @property
    def active(self):
        """True when either observability switch is on — the gate the
        instrumented trainer checks before paying any per-step cost."""
        return _rm._ENABLED or _tr._ENABLED

    # ------------------------------------------------------------ flops
    def note_flops(self, flops):
        """Install the per-step FLOP count (from :func:`step_flops`).
        None/0 degrades to MFU 0 with one warning, never NaN."""
        if flops:
            self.flops_per_step = float(flops)
        else:
            self.flops_per_step = 0.0
            if not self._flops_warned:
                self._flops_warned = True
                _LOG.warning("perf_account: step FLOPs unavailable — "
                             "train.mfu reports 0")

    # ------------------------------------------------------------- steps
    def step_start(self, **tags):
        """Begin one attributed step.  Returns the step handle — the
        shared inert one when tracing and metrics are both off.  A
        pending data-wait interval (:func:`note_data_wait`) is consumed
        here: the root span is back-dated to its start so the phase
        spans tile the ``train.step`` interval."""
        if not (_rm._ENABLED or _tr._ENABLED):
            return _INERT
        pending = take_data_wait()
        root = _tr.trace("train.step", **tags)
        h = _StepHandle(self, root, time.perf_counter())
        if pending is not None:
            t0, t1 = pending
            if root.sampled:
                root.t0 = min(root.t0, t0)
            h.t_begin = min(h.t_begin, t0)
            h.record("data_wait", t0, t1)
        return h

    # ----------------------------------------------------------- publish
    def _publish(self, h):
        dt = max(h.t_end - h.t_begin, 0.0)
        self._window.append((dt, h.seconds))
        self._steps += 1
        self._verdict = self._compute_verdict()
        self._mfu = self._compute_mfu()
        _LAST["verdict"] = self._verdict
        _LAST["mfu"] = self._mfu
        if _rm._ENABLED:
            for p in PHASES:
                _rm.TRAIN_STEP_BREAKDOWN_SECONDS.observe(
                    h.seconds.get(p, 0.0), phase=p)
            tid = h.root.trace_id if h.root.sampled else None
            _rm.TRAINER_STEP_SECONDS.observe(dt, exemplar=tid)
            _rm.TRAIN_MFU.set(self._mfu)
            _rm.TRAIN_BOTTLENECK.set(_VERDICT_CODE[self._verdict])

    def _compute_verdict(self):
        wall = sum(dt for dt, _ in self._window)
        if wall <= 0:
            return "compute_bound"
        votes = {"input_bound": 0.0, "comm_bound": 0.0}
        for _, secs in self._window:
            for p, v in _PHASE_VERDICT.items():
                votes[v] += secs.get(p, 0.0)
        top = max(votes, key=votes.get)
        if votes[top] / wall >= self.threshold:
            return top
        return "compute_bound"

    def _compute_mfu(self):
        if not self.flops_per_step or self.peak_tflops <= 0:
            return 0.0
        wall = sum(dt for dt, _ in self._window)
        if wall <= 0:
            return 0.0
        return (self.flops_per_step * len(self._window)
                / wall / (self.peak_tflops * 1e12))

    # ------------------------------------------------------------ readers
    def verdict(self):
        """Current windowed verdict, or None before the first step."""
        return self._verdict

    def mfu_value(self):
        """MFU over the current window (0.0 while FLOPs unknown)."""
        return self._mfu

    def phase_means(self):
        """Mean seconds per phase over the window."""
        n = len(self._window)
        if not n:
            return {p: 0.0 for p in PHASES}
        return {p: sum(secs.get(p, 0.0)
                       for _, secs in self._window) / n
                for p in PHASES}

    def summary(self):
        """One JSON-ready block: window means, fractions of step time,
        verdict, MFU."""
        means = self.phase_means()
        wall = sum(dt for dt, _ in self._window)
        n = len(self._window)
        step_mean = wall / n if n else 0.0
        frac = {p: (means[p] / step_mean if step_mean > 0 else 0.0)
                for p in PHASES}
        return {"steps": self._steps,
                "step_seconds_mean": round(step_mean, 6),
                "phase_seconds_mean":
                    {p: round(means[p], 6) for p in PHASES},
                "phase_fraction":
                    {p: round(frac[p], 4) for p in PHASES},
                "verdict": self._verdict,
                "mfu": round(self._mfu, 4)}

    def debug_state(self):
        """Incident-dump payload."""
        out = self.summary()
        out["flops_per_step"] = self.flops_per_step
        out["peak_tflops"] = self.peak_tflops
        return out
