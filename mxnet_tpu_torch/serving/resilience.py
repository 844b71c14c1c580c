"""Resilience primitives for decode serving (docs/serving.md §8):
deadlines and bounded retries.

The PyTorch port's copy of what the decode engine needs from
``mxnet_tpu.serving.resilience``; the circuit breaker and the client-side
retry-after helper belong to the predict/replica stack and come with it.

The serving stack's failure philosophy: a caller sees **bounded latency
or a typed, fast failure — never a hang**.  Two pieces enforce it here:

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
  guaranteed failure.
"""
from __future__ import annotations

import time

from ..base import MXNetError, entropy_rng

__all__ = ["Deadline", "DeadlineExceededError", "ServerOverloadedError",
           "is_transient", "retry_call"]


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
