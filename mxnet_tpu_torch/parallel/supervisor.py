"""Training durability on one card: the step watchdog and supervised
restarts.

The PyTorch port of ``mxnet_tpu.parallel.supervisor``, with the
reference's state machine, backoff, crash-loop breaker, metrics and
incidents.  A wedged step does not error, it HANGS the one thread the
whole loop runs on, and a crash loses every step since the last durable
checkpoint; three pieces close those holes:

- :class:`TrainStepTimeoutError` + :func:`run_with_deadline` — a step
  runs under a watchdog deadline (``MXNET_TRAIN_STEP_TIMEOUT_MS``); a
  step that does not complete in time raises the typed,
  ``transient``-marked error instead of hanging forever.  The stuck
  call is left behind on an abandoned daemon thread; the trainer's
  generation guard keeps it from replaying once the supervisor has
  restored (``ShardedTrainer.step``).
- :class:`StepWatchdog` — per-trainer deadline + straggler detection:
  a step slower than ``MXNET_TRAIN_SLOW_STEP_FACTOR`` x the rolling
  median step time increments ``train.slow_steps`` and dumps a
  flight-recorder incident.
- :class:`TrainingSupervisor` — wraps the train loop with a
  bounded-restart policy.  On a TRANSIENT failure (``exc.transient``
  truthy — injected faults, step timeouts) it sleeps a jittered
  exponential backoff, restores the newest VERIFIED checkpoint
  (:meth:`CheckpointManager.restore`'s torn-payload fallback included),
  rewinds the eager RNG stream and the data iterator's cursor from the
  checkpoint's extra payload, and resumes on the trajectory of an
  uninterrupted run.  Deterministic failures re-raise immediately:
  a :class:`~mxnet_tpu_torch.base.KernelError` (a kernel or graph that
  failed) is one, and nothing restarts around it.  More than
  ``MXNET_TRAIN_MAX_RESTARTS`` consecutive failures without a completed
  step trips the crash-loop breaker (:class:`CrashLoopError`); any
  completed step resets the run.

State machine::

    RUNNING --transient failure--> BACKOFF --> RESTORE --> RUNNING
    RUNNING --deterministic failure--> FAILED       (re-raise)
    BACKOFF --consec > MXNET_TRAIN_MAX_RESTARTS--> CRASH_LOOP

Observability: ``train.restarts`` / ``train.recovery.seconds`` /
``train.step.timeouts`` / ``train.slow_steps`` in ``runtime_metrics``,
plus :meth:`TrainingSupervisor.debug_state` attached to every restart
incident dump.

Threading contract: a supervisor (and a trainer's watchdog) belongs to
ONE train-loop thread; only :func:`run_with_deadline`'s internal
worker thread is ever concurrent, and it communicates through a
single-assignment box + Event.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque

from .. import engine as _engine
from .. import perf_account as _pa
from .. import random as _random
from .. import runtime_metrics as _rm, tracing as _tr
from ..base import MXNetError, entropy_rng, get_env

__all__ = ["TrainStepTimeoutError", "CrashLoopError", "StepWatchdog",
           "run_with_deadline", "TrainingSupervisor"]

_LOG = logging.getLogger("mxnet_tpu_torch")


class TrainStepTimeoutError(MXNetError):
    """A watched train step missed its watchdog deadline (a wedged
    step, a stuck device).  ``transient`` marks it restartable to the
    supervisor: a restore + re-run absorbs it."""

    transient = True

    def __init__(self, site, timeout_ms):
        self.site = site
        self.timeout_ms = timeout_ms
        super().__init__(
            f"{site}: no completion within {timeout_ms:g}ms watchdog "
            f"deadline (wedged step / stuck device)")


class CrashLoopError(MXNetError):
    """The supervisor's crash-loop breaker: more consecutive failed
    restart cycles than ``MXNET_TRAIN_MAX_RESTARTS`` without one
    completed step.  At that point the failure is not transient no
    matter what it claims — re-restoring the same state into the same
    fault forever is the training-plane retry storm."""

    def __init__(self, restarts, last_error):
        self.restarts = restarts
        self.last_error = last_error
        super().__init__(
            f"train loop crash-looping: {restarts} restart(s) without "
            f"progress; last error: {last_error!r}")


def run_with_deadline(fn, timeout_ms, site="train.step"):
    """Run ``fn()`` under a watchdog deadline; raise
    :class:`TrainStepTimeoutError` if it does not complete in
    ``timeout_ms``.  ``timeout_ms <= 0`` calls ``fn`` directly (the
    zero-cost off path).

    The deadline is enforced by running ``fn`` on a daemon worker
    thread and waiting on an Event: a wedged ``fn`` cannot be
    cancelled from Python, so on timeout the worker is ABANDONED
    (it parks on the blocked call; if it ever finishes, its result is
    discarded and the thread exits).  Callers that time out must not
    trust any state ``fn`` was mutating — the supervisor restores
    from the last verified checkpoint for exactly this reason."""
    if not timeout_ms or timeout_ms <= 0:
        return fn()
    box = {}
    done = threading.Event()

    def _worker():
        try:
            box["value"] = fn()
        except BaseException as e:          # noqa: BLE001 — re-raised
            box["error"] = e
        finally:
            done.set()

    worker = _engine.make_thread(
        _worker, name=f"mxnet-watchdog-{site}", owner="run_with_deadline")
    worker.start()
    if not done.wait(timeout_ms / 1e3):
        if _rm._ENABLED:
            _rm.TRAIN_STEP_TIMEOUTS.inc()
        _tr.record_incident(
            f"train.step_timeout: {site}",
            {"site": site, "timeout_ms": timeout_ms})
        # the wedged step is deliberately abandoned (daemonized by
        # construction): joining it would just relocate the hang
        _engine.forget_thread(
            worker, f"wedged past {timeout_ms}ms deadline at {site}")
        raise TrainStepTimeoutError(site, timeout_ms)
    worker.join()           # done is set: the join is immediate
    if "error" in box:
        raise box["error"]
    return box["value"]


class StepWatchdog:
    """Deadline + straggler detection for one trainer's ``step()``.

    ``timeout_ms``/``slow_factor`` default from
    ``MXNET_TRAIN_STEP_TIMEOUT_MS`` / ``MXNET_TRAIN_SLOW_STEP_FACTOR``;
    both 0 means :attr:`active` is False and callers skip the wrapper
    entirely.  Straggler rule: with >= 5 observations banked, a step
    slower than ``slow_factor`` x the rolling median fires
    ``train.slow_steps`` plus one flight-recorder incident.  Owned by
    one train-loop thread (no internal locking)."""

    def __init__(self, timeout_ms=None, slow_factor=None, window=32,
                 site="train.step"):
        self.timeout_ms = float(
            get_env("MXNET_TRAIN_STEP_TIMEOUT_MS", typ=float) or 0.0
            if timeout_ms is None else timeout_ms)
        self.slow_factor = float(
            get_env("MXNET_TRAIN_SLOW_STEP_FACTOR", typ=float) or 0.0
            if slow_factor is None else slow_factor)
        self.site = site
        self.timeouts = 0
        self.slow_steps = 0
        self._times = deque(maxlen=int(window))

    @property
    def active(self):
        return self.timeout_ms > 0 or self.slow_factor > 0

    def watch(self, fn):
        """Run one step under the deadline, then feed its duration to
        the straggler detector.  Timings are host wall-clock of the
        WATCHED call — under a deadline the call includes device
        completion, so the duration is the real step time."""
        t0 = time.perf_counter()
        try:
            out = run_with_deadline(fn, self.timeout_ms, self.site)
        except TrainStepTimeoutError:
            self.timeouts += 1
            # lands on the enclosing train.step span when the step is
            # attributed — the timeout shows up in the trace timeline
            _tr.tag("watchdog_timeout_ms", self.timeout_ms)
            raise
        self._observe(time.perf_counter() - t0)
        return out

    def _observe(self, dt):
        if self.slow_factor > 0 and len(self._times) >= 5:
            med = sorted(self._times)[len(self._times) // 2]
            if med > 0 and dt > self.slow_factor * med:
                self.slow_steps += 1
                if _rm._ENABLED:
                    _rm.TRAIN_SLOW_STEPS.inc()
                _tr.tag("slow_step", round(dt, 6))
                _tr.record_incident(
                    f"train.slow_step: {dt * 1e3:.1f}ms vs median "
                    f"{med * 1e3:.1f}ms",
                    {"site": self.site, "step_seconds": dt,
                     "median_seconds": med, "factor": self.slow_factor,
                     "verdict": _pa.current_verdict()})
        self._times.append(dt)

    def debug_state(self):
        times = sorted(self._times)
        return {"site": self.site, "timeout_ms": self.timeout_ms,
                "slow_factor": self.slow_factor,
                "timeouts": self.timeouts,
                "slow_steps": self.slow_steps,
                "observed": len(times),
                "median_ms": (times[len(times) // 2] * 1e3
                              if times else None)}


def _is_transient(exc):
    """The serving plane's ``resilience.is_transient`` contract, kept
    local so importing the training plane never pulls in the serving
    stack: only failures that opt in via a truthy ``exc.transient``
    (InjectedFault, TrainStepTimeoutError, real device blips) may be
    absorbed by a restart."""
    return bool(getattr(exc, "transient", False))


def _default_step_fn(trainer, batch):
    """One step from a ``DataBatch``: positional data then labels,
    matching ``ShardedTrainer.step(*inputs, *labels)``."""
    args = list(batch.data) + list(batch.label or [])
    return trainer.step(*args)


class TrainingSupervisor:
    """Run a train loop to completion through transient failures.

    ``trainer`` needs ``step``-compatible semantics plus the
    checkpointable surface ``CheckpointManager`` already uses
    (``params``/``opt_state``; optional ``extra_state()`` /
    ``set_extra_state()`` for step state that is not a tensor).
    ``manager`` is a :class:`~.checkpoint.CheckpointManager`.
    ``data_iter`` is a :class:`~mxnet_tpu_torch.io.DataIter`; epoch ends
    (StopIteration) reset and continue.  Bit-exact resume additionally
    needs the iterator to expose ``get_cursor()``/``set_cursor()``
    (``io.NDArrayIter(seed=...)``) — without it the supervisor still
    restarts, but warns that resume may replay or skip batches.

    ``run(num_steps)`` returns the loss trajectory (one float per
    completed step, global step order); every restart truncates it
    back to the restored step so the returned list is exactly what an
    uninterrupted run would have produced.
    """

    def __init__(self, trainer, manager, data_iter=None, *,
                 step_fn=None, save_every=50, max_restarts=None,
                 backoff_ms=None, backoff_max_ms=None,
                 auto_resume=True, rng=None):
        self.trainer = trainer
        self.manager = manager
        self.save_every = int(save_every)
        self.auto_resume = bool(auto_resume)
        self._iter = data_iter
        self._step_fn = step_fn or _default_step_fn
        self._max_restarts = int(
            get_env("MXNET_TRAIN_MAX_RESTARTS", typ=int)
            if max_restarts is None else max_restarts)
        self._backoff_ms = float(
            get_env("MXNET_TRAIN_RESTART_BACKOFF_MS", typ=float)
            if backoff_ms is None else backoff_ms)
        self._backoff_max_ms = float(
            get_env("MXNET_TRAIN_RESTART_BACKOFF_MAX_MS", typ=float)
            if backoff_max_ms is None else backoff_max_ms)
        # jitter only — never correctness; seedable for tests
        self._rng = rng if rng is not None else entropy_rng()
        self._step = 0                  # completed steps from origin
        self._losses = []
        self._restarts = 0              # lifetime restore+restart count
        self._consec = 0    # failures since the last completed step
        self._tripped = False
        self._last_error = None
        self._recovery_total = 0.0
        self._cursor_warned = False
        if data_iter is not None and not hasattr(data_iter,
                                                 "get_cursor"):
            _LOG.warning(
                "supervisor: data iterator %s has no cursor "
                "(get_cursor/set_cursor) — resume after a restart may "
                "replay or skip batches; use io.NDArrayIter(seed=...) "
                "or another checkpointable iterator for bit-exact "
                "resume", type(data_iter).__name__)

    # ------------------------------------------------------------ the loop
    def run(self, num_steps):
        """Supervised training to ``num_steps`` completed steps."""
        num_steps = int(num_steps)
        resumed = False
        pending = None
        # ONE try covers the whole attempt — including auto-resume,
        # the anchor save, and the previous failure's recovery — so a
        # transient blip during recovery itself (checkpoint.restore
        # fault, storage hiccup) re-enters the restart policy and is
        # bounded by the crash-loop breaker instead of escaping
        while True:
            try:
                if pending is not None:
                    exc, pending = pending, None
                    self._handle_transient(exc)
                if not resumed:
                    resumed = True
                    if self._step == 0 and self.manager \
                            .latest_verified_step() is not None \
                            and self.auto_resume:
                        self._recover()     # pick up a preempted run
                if self.manager.latest_verified_step() is None:
                    # the restore anchor: a failure before the first
                    # periodic checkpoint must still rewind to a
                    # bit-exact start
                    self._save(0)
                self._run_loop(num_steps)
                # a resume may pick up a checkpoint already past
                # num_steps; the contract is one loss per requested step
                return list(self._losses[:num_steps])
            except Exception as e:  # noqa: BLE001 — policy filter below
                if not _is_transient(e):
                    raise
                pending = e

    def _run_loop(self, num_steps):
        while self._step < num_steps:
            batch = self._next_batch()
            loss = self._step_fn(self.trainer, batch)
            self._losses.append(float(loss))
            self._step += 1
            self._consec = 0    # progress resets the crash-loop run
            if self.save_every and self._step % self.save_every == 0 \
                    and self._step < num_steps:
                self._save(self._step)
        if self._step == num_steps \
                and self.manager.latest_verified_step() != num_steps:
            self._save(num_steps)       # durable finish

    def _next_batch(self):
        if self._iter is None:
            return None
        try:
            return self._iter.next()
        except StopIteration:
            self._iter.reset()
            return self._iter.next()

    # -------------------------------------------------------- checkpointing
    def _save(self, step):
        # the FULL trajectory rides every sidecar: it is what lets a
        # cross-process resume return the same loss list as an
        # uninterrupted run (retention GC deletes older sidecars, so a
        # tail-only scheme could not reconstruct the prefix).  Cost is
        # O(steps) JSON per barrier — for very long runs, raise
        # save_every rather than shrinking this payload
        extra = {"step": int(step),
                 "rng": _random.get_state(),
                 "losses": list(self._losses),
                 "cursor": None, "trainer": None}
        get_cursor = getattr(self._iter, "get_cursor", None)
        if get_cursor is not None:
            try:
                extra["cursor"] = get_cursor()
            except MXNetError as e:
                # e.g. a shuffling NDArrayIter without seed= — degrade
                # to the documented restart-without-bit-exactness path
                # rather than failing the save
                if not self._cursor_warned:
                    self._cursor_warned = True
                    _LOG.warning(
                        "supervisor: data-iterator cursor unavailable "
                        "(%s) — resume after a restart may replay or "
                        "skip batches", e)
        trainer_extra = getattr(self.trainer, "extra_state", None)
        if trainer_extra is not None:
            extra["trainer"] = trainer_extra()
        self.manager.save(step, self.trainer, extra=extra)
        # the barrier makes save_every the VERIFIED cadence: each
        # periodic save is durable (manifest + marker) before the loop
        # continues, so it is always a legal restore target
        # mxlint: disable=deadline-soundness (contract: the durability
        # barrier must complete before the marker advances — a deadline
        # here would tear the checkpoint; the job's launcher bounds a
        # wedged disk)
        self.manager.wait()

    def _recover(self):
        try:
            step = self.manager.restore(self.trainer)
        except MXNetError:
            if self._step == 0 and not self._losses:
                # nothing restorable AND nothing mutated yet (the
                # failure hit before the step-0 anchor landed): the
                # initial state is still the bit-exact start
                _LOG.warning("supervisor: nothing restorable yet — "
                             "restarting from the initial state")
                return
            raise
        extra = self.manager.load_extra(step) or {}
        if extra.get("rng") is not None:
            _random.set_state(extra["rng"])
        cursor = extra.get("cursor")
        set_cursor = getattr(self._iter, "set_cursor", None)
        if cursor is not None and set_cursor is not None:
            set_cursor(cursor)
        set_extra = getattr(self.trainer, "set_extra_state", None)
        if set_extra is not None:
            set_extra(extra.get("trainer") or {})
        losses = extra.get("losses")
        self._losses = ([float(v) for v in losses]
                        if losses is not None
                        else self._losses[:int(step)])
        self._step = int(step)
        _LOG.warning("supervisor: restored to verified step %d", step)

    # ----------------------------------------------------- failure handling
    def _handle_transient(self, exc):
        self._consec += 1
        self._last_error = repr(exc)
        if self._consec > self._max_restarts:
            self._tripped = True
            raise CrashLoopError(self._restarts, exc) from exc
        self._restarts += 1
        if _rm._ENABLED:
            _rm.TRAIN_RESTARTS.inc()
        _tr.record_incident(f"train.restart: {exc}", self.debug_state)
        delay = min(self._backoff_ms * 2 ** (self._consec - 1),
                    self._backoff_max_ms) / 1e3 \
            * (0.5 + self._rng.random() / 2.0)
        _LOG.warning(
            "supervisor: transient train failure (%s) — restart "
            "%d (consecutive %d/%d) after %.0fms backoff", exc,
            self._restarts, self._consec, self._max_restarts,
            delay * 1e3)
        if delay > 0:
            # mxlint: disable=deadline-soundness (contract: restart
            # backoff, bounded by MXNET_TRAIN_RESTART_BACKOFF_MAX_MS
            # per sleep and by the crash-loop breaker in total — the
            # training plane has no request deadline to consume)
            time.sleep(delay)
        t0 = time.perf_counter()
        self._recover()
        recovery = time.perf_counter() - t0
        self._recovery_total += recovery
        if _rm._ENABLED:
            _rm.TRAIN_RECOVERY_SECONDS.observe(recovery)

    # ------------------------------------------------------------- readers
    @property
    def losses(self):
        return list(self._losses)

    @property
    def restarts(self):
        return self._restarts

    def debug_state(self):
        state = {"step": self._step,
                 "restarts": self._restarts,
                 "consecutive_failures": self._consec,
                 "max_restarts": self._max_restarts,
                 "crash_loop_tripped": self._tripped,
                 "last_error": self._last_error,
                 "recovery_seconds_total": self._recovery_total,
                 "latest_verified_step":
                     self.manager.latest_verified_step(),
                 "losses": len(self._losses),
                 "save_every": self.save_every}
        watchdog = getattr(self.trainer, "watchdog", None)
        if watchdog is not None:
            state["watchdog"] = watchdog.debug_state()
        perf = getattr(self.trainer, "perf", None)
        if perf is not None:
            state["perf"] = perf.debug_state()
        return state
