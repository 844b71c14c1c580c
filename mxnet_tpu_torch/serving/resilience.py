"""Resilience primitives for the serving tier (docs/serving.md §8):
deadlines, bounded retries, and per-model-version circuit breakers.

The PyTorch port's copy of ``mxnet_tpu.serving.resilience``.

The serving stack's failure philosophy: a caller sees **bounded latency
or a typed, fast failure — never a hang**.  Three pieces enforce it:

- :class:`Deadline` — a request's ``timeout`` becomes an absolute
  monotonic deadline carried through admission -> queue -> batch
  assembly -> execute, so every layer can answer "is this request
  already dead?" without re-deriving budgets.  An expired request is
  cancelled *before* it consumes a batch slot and fails with
  :class:`DeadlineExceededError` instead of hanging.
- :func:`retry_call` — bounded retries with jittered exponential
  backoff for TRANSIENT failures only (``exc.transient`` truthy — the
  marker :class:`~mxnet_tpu_torch.faults.InjectedFault` and real device
  blips carry).  Deterministic errors (shape mismatch, poisoned input)
  fail immediately; retrying them would just triple the latency of a
  guaranteed failure.  :func:`honor_retry_after` is its client-side
  twin for the server's overload hint.
- :class:`CircuitBreaker` — per model version, a sliding window of the
  last N request outcomes.  When the window is full and its error rate
  reaches the threshold the circuit OPENs: admissions shed instantly
  with a retry-after hint (no queueing behind a known-bad version).
  After a cooldown one HALF_OPEN probe is admitted; success re-CLOSEs,
  failure re-OPENs.

:class:`ServerOverloadedError` lives here so :class:`CircuitOpenError`
can subclass it — to a caller, an open circuit IS an overload: back off
and retry later.
"""
from __future__ import annotations

import time
from collections import deque

from .. import engine, runtime_metrics as _rm, tracing as _tr
from ..base import MXNetError, entropy_rng

__all__ = ["Deadline", "DeadlineExceededError", "ServerOverloadedError",
           "CircuitOpenError", "CircuitBreaker", "is_transient",
           "retry_call", "honor_retry_after"]


class ServerOverloadedError(MXNetError):
    """Request shed by the backpressure bounds.  ``retry_after_ms`` is
    the server's backoff hint (an HTTP frontend maps this to 429 +
    Retry-After); the message names which bound actually tripped so
    operators tune the right knob."""

    def __init__(self, model, retry_after_ms, reason):
        self.model = model
        self.retry_after_ms = retry_after_ms
        super().__init__(
            f"server overloaded: {reason} for model {model!r}; "
            f"retry after {retry_after_ms}ms")


class DeadlineExceededError(MXNetError):
    """The request's end-to-end deadline expired — in the queue, inside
    a coalesced batch, or mid-generation.  Replaces the silent hang: a
    caller that set ``timeout`` gets this error within ~one scheduling
    quantum of the deadline, and the server stops spending device time
    on the corpse."""

    def __init__(self, where, timeout, detail=""):
        self.timeout = timeout
        suffix = f" ({detail})" if detail else ""
        super().__init__(
            f"{where}: no result within {timeout}s deadline{suffix}")


class CircuitOpenError(ServerOverloadedError):
    """Admission refused because the model version's circuit is OPEN
    (error rate over the sliding window tripped the breaker).  Carries
    the standard overload retry-after contract: back off, then retry —
    by then the breaker is probing or closed again."""


class Deadline:
    """Absolute monotonic deadline (or no deadline at all).

    ``Deadline.start(timeout)`` converts a caller-relative ``timeout``
    into the absolute point every later layer compares against —
    computed ONCE at admission so queue wait, batch formation, retries,
    and execute all drain the same budget.
    """

    __slots__ = ("t", "timeout")

    def __init__(self, t=None, timeout=None):
        self.t = t                      # monotonic instant, or None
        self.timeout = timeout          # original relative budget (s)

    @classmethod
    def start(cls, timeout):
        if timeout is None:
            return cls()
        timeout = float(timeout)
        return cls(time.monotonic() + timeout, timeout)

    @property
    def unset(self):
        return self.t is None

    def expired(self, now=None):
        return self.t is not None \
            and (time.monotonic() if now is None else now) >= self.t

    def remaining(self, now=None):
        """Seconds left (never negative), or None when unbounded —
        shaped for ``Event.wait(remaining)``."""
        if self.t is None:
            return None
        return max(0.0,
                   self.t - (time.monotonic() if now is None else now))


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------
def is_transient(exc):
    """Whether the retry policy may re-execute after ``exc``.  The
    contract is an explicit opt-in marker (``exc.transient`` truthy —
    :class:`~mxnet_tpu_torch.faults.InjectedFault` sets it): retrying an
    arbitrary exception re-runs a failure that will deterministically
    recur and doubles down on a poisoned request."""
    return bool(getattr(exc, "transient", False))


def retry_call(fn, *, retries, backoff_ms, deadline=None, rng=None,
               on_retry=None):
    """Run ``fn()`` with up to ``retries`` re-executions of TRANSIENT
    failures, sleeping a jittered exponential backoff between attempts
    (``backoff_ms * 2^attempt * U[0.5, 1.0)``).  A deadline that cannot
    cover the next backoff stops retrying — better to surface the real
    error than burn the caller's remaining budget sleeping."""
    # deliberate nondeterminism, via the one sanctioned source: the
    # jitter must differ across processes or the retry waves sync up
    # (mxlint determinism-soundness exempts entropy_rng)
    rng = rng or entropy_rng()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:      # noqa: BLE001 — policy filter below
            if attempt >= retries or not is_transient(e):
                raise
            delay = (backoff_ms / 1e3) * (2 ** attempt) \
                * (0.5 + rng.random() / 2.0)
            if deadline is not None and deadline.t is not None \
                    and deadline.remaining() <= delay:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                time.sleep(delay)


def honor_retry_after(fn, *, attempts=4, deadline=None, rng=None,
                      on_backoff=None):
    """Client-side twin of the server's ``retry_after_ms`` hint: run
    ``fn()``, and on :class:`ServerOverloadedError` (including
    :class:`CircuitOpenError`) sleep the server's hint **scaled by a
    jitter factor of U[1.0, 1.5)** before retrying, up to ``attempts``
    re-executions.

    The jitter is the point.  A shed storm hits every closed-loop
    client at once; clients that all sleep exactly ``retry_after_ms``
    come back as one synchronized wave and shed again — the hint alone
    *causes* the retry storm it exists to prevent.  Multiplicative
    jitter spreads the wave, and honoring the server's hint (instead of
    a client-invented backoff) keeps the retry rate matched to what the
    server said it can absorb.

    ``deadline`` (a :class:`Deadline`) bounds the whole loop: a sleep
    that cannot fit in the remaining budget re-raises the overload
    error instead of burning the budget asleep.  ``on_backoff(attempt,
    delay_s, exc)`` observes each sleep (bench/client metrics).  Errors
    other than the overload family propagate immediately — this helper
    honors backpressure; it is not a general retry policy
    (:func:`retry_call` is).
    """
    rng = rng or entropy_rng()   # sanctioned jitter source — see retry_call
    attempt = 0
    while True:
        try:
            return fn()
        except ServerOverloadedError as e:
            if attempt >= attempts:
                raise
            delay = (max(0, e.retry_after_ms) / 1e3) \
                * (1.0 + rng.random() / 2.0)
            if deadline is not None and deadline.t is not None \
                    and deadline.remaining() <= delay:
                raise
            attempt += 1
            if on_backoff is not None:
                on_backoff(attempt, delay, e)
            if delay > 0:
                time.sleep(delay)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Per-model-version error-rate breaker.

    - CLOSED: admit everything; record outcomes into a sliding window
      of the last ``window`` requests.  Once the window is FULL and
      ``errors / window >= threshold``, trip to OPEN (the full-window
      requirement doubles as the min-samples guard — a single early
      failure cannot trip a cold breaker).
    - OPEN: shed instantly with :class:`CircuitOpenError` carrying the
      remaining cooldown as ``retry_after_ms``; after ``cooldown_ms``
      the next admission becomes the HALF_OPEN probe.
    - HALF_OPEN: exactly one probe request is in flight; concurrent
      admissions shed.  Probe success -> CLOSED (window cleared),
      probe failure -> OPEN for another cooldown.

    ``consecutive`` (0 = off) adds a second, faster trip rule on top of
    the windowed error rate: N consecutive failures open the circuit
    even before the window fills.  The replica layer (docs/serving.md
    §10) uses it as its dead-replica detector — a replica that fails
    every request since some instant is *down*, and waiting for a
    20-outcome window to fill against a corpse just queues more
    casualties.  A single success resets the run.

    ``window <= 0`` disables the windowed error-rate rule; the breaker
    as a whole (admit/record no-ops) is off only when ``consecutive``
    is ALSO 0 — a replica layer running with the windowed breaker
    disabled still needs its dead-replica fast trip.  Outcome
    recording is the caller's job and should count EXECUTE outcomes
    only — sheds, deadline expiries, and validation rejects say
    nothing about the model version's health.
    """

    def __init__(self, window, threshold, cooldown_ms, model="?",
                 version=None, consecutive=0):
        self.window = int(window)
        self.threshold = float(threshold)
        self.cooldown_ms = float(cooldown_ms)
        self.consecutive = int(consecutive or 0)
        self.model = model
        self.version = version
        self._lock = engine.make_lock("serving.CircuitBreaker._lock")
        self._outcomes = deque(maxlen=max(1, self.window))
        self._consec_failures = 0       # current run of failures
        self._state = CLOSED
        self._opened_at = None          # monotonic of last trip
        self._probing = False
        self._probe_started = None      # monotonic of probe admission
        self._stats = {"opened": 0, "closed": 0, "rejected": 0,
                       "probes": 0}

    # ------------------------------------------------------------- gauges
    def _publish(self):
        # mxlint: disable=lock-discipline (contract: callers hold
        # self._lock; the metric has its own lock)
        if _rm._ENABLED:
            _rm.SERVING_CIRCUIT_STATE.set(
                _STATE_CODE[self._state], model=self.model,
                version=str(self.version))

    @property
    def state(self):
        with self._lock:
            return self._state

    @property
    def _disabled(self):
        # mxlint: disable=lock-discipline (reads two immutable ints)
        return self.window <= 0 and self.consecutive <= 0

    # ---------------------------------------------------------- admission
    def admit(self):
        """Gate one admission.  Raises :class:`CircuitOpenError` when
        OPEN (or while the half-open probe is outstanding); returns
        True when this admission IS the probe (the caller must report
        its outcome via :meth:`record` or the breaker stays stuck in
        HALF_OPEN — record() is called for every execute outcome, so
        the existing bookkeeping covers it)."""
        if self._disabled:
            return False
        with self._lock:
            if self._state == CLOSED:
                return False
            now = time.monotonic()
            if self._state == OPEN:
                elapsed_ms = (now - self._opened_at) * 1e3
                if elapsed_ms < self.cooldown_ms:
                    self._stats["rejected"] += 1
                    retry_ms = max(1, int(self.cooldown_ms - elapsed_ms))
                    raise CircuitOpenError(
                        self.model, retry_ms,
                        f"circuit open ({self._state_reason()})")
                # cooldown over: this admission becomes the probe
                self._state = HALF_OPEN
                self._probing = True
                self._probe_started = now
                self._stats["probes"] += 1
                self._publish()
                return True
            # HALF_OPEN: one probe only — but a probe whose outcome
            # never came back (shed by the queue watermark, expired
            # before execute) must not wedge the breaker forever; after
            # one cooldown it is considered abandoned and the next
            # admission takes over as the probe
            if self._probing and (now - self._probe_started) * 1e3 \
                    < max(1.0, self.cooldown_ms):
                self._stats["rejected"] += 1
                raise CircuitOpenError(
                    self.model, max(1, int(self.cooldown_ms)),
                    "circuit half-open (probe in flight)")
            self._probing = True
            self._probe_started = now
            self._stats["probes"] += 1
            return True

    def _state_reason(self):
        # mxlint: disable=lock-discipline (contract: callers hold
        # self._lock)
        errs = sum(1 for ok in self._outcomes if not ok)
        return (f"{errs}/{len(self._outcomes)} recent requests failed "
                f">= threshold {self.threshold:.0%} for model "
                f"{self.model!r}:{self.version}")

    def record(self, ok):
        """Record one EXECUTE outcome.  Returns the state after the
        update so callers can fire incident dumps on a trip without
        re-locking."""
        if self._disabled:
            return CLOSED
        tripped = False
        with self._lock:
            if self._state == HALF_OPEN and self._probing:
                self._probing = False
                if ok:
                    self._state = CLOSED
                    self._outcomes.clear()
                    self._consec_failures = 0
                    self._stats["closed"] += 1
                else:
                    self._state = OPEN
                    self._opened_at = time.monotonic()
                    self._stats["opened"] += 1
                    tripped = True
                self._publish()
                state = self._state
            elif self._state == CLOSED:
                self._outcomes.append(bool(ok))
                self._consec_failures = 0 if ok \
                    else self._consec_failures + 1
                trip = False
                if len(self._outcomes) == self.window:
                    errs = sum(1 for o in self._outcomes if not o)
                    trip = errs / self.window >= self.threshold
                # the fast dead-backend rule: N-in-a-row failures open
                # the circuit without waiting for the window to fill
                if self.consecutive \
                        and self._consec_failures >= self.consecutive:
                    trip = True
                if trip:
                    self._state = OPEN
                    self._opened_at = time.monotonic()
                    self._stats["opened"] += 1
                    tripped = True
                    self._publish()
                state = self._state
            else:
                # OPEN: a straggler from before the trip — ignore
                state = self._state
        if tripped:
            # flight recorder outside the lock: a breaker trip is an
            # incident worth a dump (debounced inside record_incident)
            _tr.record_incident(
                f"serving.circuit_open: {self.model}:{self.version}",
                self.debug_state)
        return state

    # ------------------------------------------------------------ readers
    def debug_state(self):
        with self._lock:
            return {"model": self.model, "version": self.version,
                    "state": self._state, "window": self.window,
                    "threshold": self.threshold,
                    "cooldown_ms": self.cooldown_ms,
                    "consecutive": self.consecutive,
                    "consec_failures": self._consec_failures,
                    "recent_errors": sum(
                        1 for ok in self._outcomes if not ok),
                    "recent": len(self._outcomes),
                    "probing": self._probing,
                    "stats": dict(self._stats)}

    def __repr__(self):
        return (f"CircuitBreaker({self.model}:{self.version}, "
                f"state={self.state}, window={self.window}, "
                f"threshold={self.threshold})")
