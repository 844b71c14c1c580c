"""Multi-replica serving (docs/serving.md §10).

The PyTorch port of ``mxnet_tpu.serving.replica``.  One model version,
N replicas: a :class:`ReplicaSet` places N copies of a model's execution
state on device groups (``parallel.placement.replica_groups``) and routes
each request to the least-loaded HEALTHY replica.  The replica is the
unit of throughput *and* availability, so the failure machinery ships
inside this module, not around it:

- **Per-replica execution state, one set of weights.**  A predict
  replica owns its own :class:`~mxnet_tpu_torch.serving.batcher.
  DynamicBatcher`, whose program per bucket is its own
  ``_BlockProgram``: its own CUDA graph, static input buffer, stream,
  memory pool and lock, over the entry's ONE weight snapshot (or loaded
  artifact module), never copied.  A decode replica owns its own
  :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` over its own
  :class:`~mxnet_tpu_torch.serving.decode.PagedLMAdapter` — its own KV
  pool, graphs, stream and lock — whose parameters share storage with
  the one LM.
- **Graphs do not persist.**  In the reference, N replicas share one
  cold compile per bucket through the persistent AOT store.  A CUDA
  graph cannot outlive its process (nor move between replicas: it holds
  its replica's buffer addresses), so here each replica captures its
  own graphs when it is prewarmed; only the kernel libraries come from
  the persistent tier (``ops/build.py``, ``compile_cache.py``).  Each
  replica records its capture seconds (:meth:`ReplicaSet.stats`).
- **Placement.**  On one card every replica shares it:
  ``replica_groups`` oversubscribes a one-device pool.  A replica whose
  lead device differs from the device holding the entry's weights is
  refused with :class:`~mxnet_tpu_torch.base.MXNetError` — weights are
  never copied to another card behind the caller's back (placing them
  across cards is ROADMAP.md Queue A, item 5).
- **Health.**  Each replica runs a heartbeat thread (interval
  ``replica_heartbeat_ms``); every beat also sweeps the set, so a
  stalled sibling is detected within one beat even with zero traffic.
  A heartbeat older than ``replica_heartbeat_window_ms`` or
  ``replica_failure_threshold`` consecutive typed execute failures
  (the per-replica :class:`~mxnet_tpu_torch.serving.resilience.
  CircuitBreaker`'s fast trip rule) marks the replica UNHEALTHY —
  unroutable, shedding its load onto siblings.
- **Failover.**  A retryable failure on one replica re-dispatches to
  a sibling under the request's ORIGINAL end-to-end deadline; every
  replica replays the same kernels on the same inputs, so the result
  is the same either way.  Decode sequences on a dead replica are
  quarantined leak-free by the engine's §8 path and re-admitted here as
  FRESH requests on a sibling while the retry budget and deadline
  allow.
- **Rolling recovery.**  A rejoining replica (heartbeats resumed, or an
  explicit :meth:`ReplicaSet.restart` / :meth:`add_replica`) must
  re-pass **prewarm** — every shape bucket built and executed once —
  before it becomes routable, so add/remove/rejoin under load never
  serves a program that has not run.  A predict replica rejoining after
  a stale heartbeat builds its programs anew, as a restarted one does
  (the reference re-runs its cached executables instead).  On the card
  that prewarm captures the replica's graphs while its siblings replay
  theirs on their own streams from other threads (captures run in
  ``thread_local`` mode).
  A failed capture raises :class:`~mxnet_tpu_torch.base.KernelError`
  inside the prewarm and leaves the replica UNHEALTHY with the error as
  its reason; nothing serves in its place.  :meth:`remove_replica`
  drains (unroutable, in-flight finishes) before stopping.

Chaos sites (``MXNET_FAULTS``): ``replica.<rid>.execute`` (dispatch),
``replica.<rid>.heartbeat`` (beat loop — ``stall`` is the dead-worker
shape), and ``replica.<rid>.decode.{prefill,step,verify,
prefix_lookup}`` (the engine's §8 sites, replica-scoped).
Observability: ``serving.replica.{state,requests,failovers,
heartbeat_age}`` metrics plus a ``replica=<rid>`` tag on every
dispatched request's span.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import OrderedDict

import numpy as np

from .. import engine as _engine, faults as _faults, \
    runtime_metrics as _rm, tracing as _tr
from ..base import MXNetError
from .batcher import DynamicBatcher
from .repository import prewarm_buckets, synth_inputs
from .resilience import (CircuitBreaker, Deadline,
                         DeadlineExceededError, ServerOverloadedError,
                         is_transient)

__all__ = ["Replica", "ReplicaSet", "STARTING", "PREWARMING", "HEALTHY",
           "UNHEALTHY", "DRAINING", "STOPPED"]

_LOG = logging.getLogger("mxnet_tpu_torch")

# generate(_trace_ctx=...) default: "no caller decision" — mapped to
# the decode engine's own _AMBIENT sentinel at submit
_UNSET = object()

# replica lifecycle states (gauge codes in serving.replica.state)
STARTING, PREWARMING, HEALTHY = "starting", "prewarming", "healthy"
UNHEALTHY, DRAINING, STOPPED = "unhealthy", "draining", "stopped"
_STATE_CODE = {STARTING: 0, PREWARMING: 1, HEALTHY: 2, UNHEALTHY: 3,
               DRAINING: 4, STOPPED: 5}


class Replica:
    """One replica's identity + execution resources.

    Pure data holder for scheduling purposes: every mutable scheduling
    field (``state``, ``inflight``, ``last_beat``, counters) is guarded
    by the owning :class:`ReplicaSet`'s condition — the replica itself
    takes no lock, so there is exactly one lock order through the set.
    """

    __slots__ = ("rid", "entry", "device", "state", "unhealthy_reason",
                 "inflight", "last_beat", "last_routed", "requests",
                 "failures", "prewarms", "breaker", "batcher", "engine",
                 "beat_thread", "last_bringup", "bringup_s",
                 "bringup_error")

    def __init__(self, rid, entry, config, device=None,
                 decode_model=None, draft_model=None):
        self.rid = rid
        self.entry = entry
        self.device = device
        self.state = STARTING
        self.unhealthy_reason = None
        self.inflight = 0
        self.last_beat = time.monotonic()
        self.last_routed = 0            # routing-fairness tiebreak
        self.requests = 0               # dispatches routed here
        self.failures = 0               # typed execute failures
        self.prewarms = 0               # completed prewarm passes
        self.last_bringup = 0.0         # monotonic of last prewarm try
        self.bringup_s = 0.0            # seconds the last prewarm took
        self.bringup_error = None       # what the last failed prewarm raised
        # per-REPLICA breaker extending §8's per-version one: same
        # windowed error rate + the consecutive-failures fast trip
        # (a replica failing everything since instant T is dead — do
        # not wait for a 20-outcome window to fill against a corpse)
        self.breaker = CircuitBreaker(
            config.circuit_window, config.circuit_threshold,
            config.circuit_cooldown_ms, model=entry.name,
            version=f"{entry.version}#{rid}",
            consecutive=config.replica_failure_threshold)
        if decode_model is not None:
            self.batcher = None
            from .decode import DecodeEngine
            # binding the adapter here captures its graphs (the
            # engine's warm-up)
            self.engine = DecodeEngine(
                decode_model, config,
                model_name=f"{entry.name}/{rid}",
                draft=draft_model,
                fault_scope=f"replica.{rid}.decode")
        else:
            self.batcher = DynamicBatcher(config, device=device)
            self.batcher.check_device(entry)
            self.engine = None
        self.beat_thread = None

    def capture_seconds(self):
        """Host seconds this replica's CUDA-graph captures took (0 on
        the CPU, where nothing is captured)."""
        if self.engine is not None:
            return float(getattr(self.engine.model, "capture_seconds", 0.0))
        return sum(float(getattr(p, "capture_s", 0.0))
                   for p in self.batcher.program_list(self.entry))

    def __repr__(self):
        return (f"Replica({self.entry.name}:{self.entry.version}/"
                f"{self.rid}, {self.state}, inflight={self.inflight})")


class ReplicaSet:
    """N replicas of ONE model version, with health-checked
    least-loaded routing, deadline-preserving failover, and
    prewarm-gated rolling recovery (module docstring).

    ``devices`` is an optional list of per-replica device groups
    (``parallel.placement.replica_groups`` output); each replica's
    programs run on its group's lead device, which must be the device
    holding the entry's weights.  For decoder entries, per-replica decode
    models come from ``entry.decode_model_factory``
    (``add_decoder(model_factory=...)``) or — for
    :class:`~mxnet_tpu_torch.serving.decode.PagedLMAdapter` models — an
    automatic per-replica adapter clone over the shared LM weights.
    """

    def __init__(self, entry, config, devices=None, autostart=True,
                 n=None):
        self.entry = entry
        self.config = config
        self.name = entry.name
        self._cond = _engine.make_condition("serving.ReplicaSet._cond")
        self._replicas = OrderedDict()          # rid -> Replica
        self._idx = itertools.count()           # rid allocator
        self._ticket = itertools.count(1)       # routing fairness clock
        self._stopping = False
        self._last_sweep = 0.0          # monotonic; rate-limits _sweep
        self._drain_waiters = 0         # gates the per-request notify
        self._stats = {"dispatched": 0, "failovers": 0,
                       "unhealthy_marks": 0, "rejoins": 0,
                       "prewarms": 0, "no_healthy_rejects": 0,
                       "drained": 0}
        n = config.replicas if n is None else int(n)
        if n < 1:
            raise MXNetError("ReplicaSet: need >= 1 replica")
        self._single = n == 1
        self._devices = list(devices) if devices else None
        try:
            for _ in range(n):
                self._create_replica()
        except BaseException:
            # a refused placement or a failed decode bind: the replicas
            # built so far must not keep their engines and pools
            self.stop()
            raise
        _engine.watch_races(self)
        if autostart:
            self.start()

    # ------------------------------------------------------------ creation
    def _device_for(self, idx):
        if not self._devices:
            return None
        group = self._devices[idx % len(self._devices)]
        if isinstance(group, (tuple, list)):
            return group[0] if group else None
        return group

    def _decode_models(self, rid):
        """A fresh (model, draft) pair for one decode replica — every
        replica's engine owns its model's device state (KV pool,
        captured graphs), so N engines can never share one stateful
        model object."""
        entry = self.entry

        def fresh(model, factory, role):
            if factory is not None:
                return factory()
            from .decode import PagedLMAdapter
            if isinstance(model, PagedLMAdapter):
                # clone over the SHARED weights: per-replica pool, graphs
                # and stream, one set of parameters in memory
                clone = PagedLMAdapter(model.lm, device=model.device,
                                       graphs=model.graphs)
                if hasattr(model, "eos_id"):
                    clone.eos_id = model.eos_id
                return clone
            if self._single:
                # a 1-replica set is the model's sole consumer — it
                # may own the registered object itself
                return model
            raise MXNetError(
                f"ReplicaSet({entry.name!r}): cannot replicate the "
                f"registered decode {role} ({type(model).__name__}) — "
                f"each replica's engine needs its own instance because "
                f"the model holds engine-local KV state (pages are "
                f"numbered per-engine).  Register with add_decoder("
                f"{role}_factory=...) returning a fresh object per "
                f"replica")

        model = fresh(entry.decode_model, entry.decode_model_factory,
                      "model")
        draft = None
        if entry.draft_model is not None:
            draft = fresh(entry.draft_model, entry.draft_model_factory,
                          "draft")
        return model, draft

    def _new_replica(self, rid, idx):
        decode_model = draft = None
        if self.entry.decode_model is not None:
            decode_model, draft = self._decode_models(rid)
        return Replica(rid, self.entry, self.config,
                       device=self._device_for(idx),
                       decode_model=decode_model, draft_model=draft)

    def _create_replica(self):
        idx = next(self._idx)
        rep = self._new_replica(f"r{idx}", idx)
        with self._cond:
            self._replicas[rep.rid] = rep
        self._publish_state(rep)
        return rep

    # ----------------------------------------------------------- lifecycle
    def start(self):
        """Prewarm every STARTING replica (serially — a replica is
        routable the moment ITS prewarm passes, so a slow sibling
        never blocks the set) and start the heartbeat threads."""
        with self._cond:
            self._stopping = False
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.state == STARTING:
                self._bring_up(rep)
        return self

    def _bring_up(self, rep):
        """STARTING/UNHEALTHY -> PREWARMING -> HEALTHY (or back to
        UNHEALTHY on a failed prewarm).  Runs the prewarm OUTSIDE the
        set condition — it builds and executes.  The beat thread starts
        either way: a replica whose FIRST prewarm failed still needs
        one, because the heartbeat loop is also the retry engine that
        brings it back once the failure clears (_maybe_rejoin)."""
        with self._cond:
            rep.state = PREWARMING
            rep.unhealthy_reason = None
            rep.last_bringup = time.monotonic()
        self._publish_state(rep)
        t0 = time.perf_counter()
        try:
            self._prewarm_replica(rep)
            ok = True
        except Exception as e:      # noqa: BLE001 — stay unroutable
            _LOG.warning("replica %s/%s: prewarm failed: %s",
                         self.name, rep.rid, e)
            rep.bringup_error = e
            self._mark_unhealthy(
                rep, f"prewarm failed: {type(e).__name__}: {e}")
            ok = False
        if ok:
            with self._cond:
                rep.state = HEALTHY
                rep.bringup_error = None
                rep.last_beat = time.monotonic()
                rep.prewarms += 1
                rep.bringup_s = time.perf_counter() - t0
                self._stats["prewarms"] += 1
            self._publish_state(rep)
        if rep.beat_thread is None or not rep.beat_thread.is_alive():
            t = _engine.make_thread(
                self._beat_loop, args=(rep,),
                name=f"mxnet-replica-{self.name}-{rep.rid}",
                owner=f"ReplicaSet({self.name})")
            with self._cond:
                rep.beat_thread = t
            t.start()
        return ok

    def _prewarm_replica(self, rep):
        """Build AND execute every shape bucket of this replica's
        program set — the hot-swap admission gate applied per replica:
        routable means no build left on the request path.  On the card
        each bucket's build is this replica's own CUDA-graph capture."""
        if rep.engine is not None:
            rep.engine.start()
            # run every prefill bucket + the decode program through one
            # short generation per bucket (prompt sized to the bucket,
            # one new token); pages are released at eviction so the
            # pool stays clean for traffic
            geo = rep.engine.geometry
            for bucket in rep.engine.prefill_buckets:
                length = min(bucket, geo.max_context - 1)
                if geo.pages_for(length + 1) > geo.usable_pages:
                    break           # pool-bounded: warm what can run
                prompt = np.zeros(length, np.int32)
                rep.engine.generate(prompt, max_new_tokens=1,
                                    eos_id=-1, timeout=60)
            return
        entry = self.entry
        for rows in prewarm_buckets(entry,
                                    self.config.max_batch_size):
            prog = rep.batcher.program_for(entry, rows)
            outs = prog(*synth_inputs(entry, rows))
            _engine.sync_outputs(
                outs if isinstance(outs, (tuple, list)) else (outs,),
                site="serving.replica.prewarm")

    def stop(self, timeout=None):
        """Stop every replica: heartbeats down, engines stopped,
        states STOPPED.  Returns False if an engine's step loop
        outlived the budget (call again to finish, mirroring
        ``ModelServer.stop``)."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cond:
            self._stopping = True
            reps = list(self._replicas.values())
            self._cond.notify_all()
        ok = True
        for rep in reps:
            t = rep.beat_thread
            if t is not None and t is not threading.current_thread():
                t.join(None if deadline is None
                       else max(0.0, deadline - time.monotonic()))
            if rep.engine is not None:
                if not rep.engine.stop(
                        timeout=None if deadline is None
                        else max(0.0, deadline - time.monotonic())):
                    ok = False
                    continue
            with self._cond:
                rep.state = STOPPED
            self._publish_state(rep)
        return ok

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------ health
    def _publish_state(self, rep):
        if _rm._ENABLED:
            _rm.SERVING_REPLICA_STATE.set(
                _STATE_CODE[rep.state], model=self.name,
                replica=rep.rid)

    def _mark_unhealthy(self, rep, reason):
        """HEALTHY/PREWARMING -> UNHEALTHY; unroutable until it
        rejoins through prewarm (heartbeat recovery) or a breaker
        probe succeeds (transient-failure recovery)."""
        changed = False
        with self._cond:
            if rep.state not in (UNHEALTHY, DRAINING, STOPPED):
                rep.state = UNHEALTHY
                rep.unhealthy_reason = reason
                self._stats["unhealthy_marks"] += 1
                changed = True
        if changed:
            self._publish_state(rep)
            _LOG.warning("replica %s/%s marked UNHEALTHY: %s",
                         self.name, rep.rid, reason)
            _tr.record_incident(
                f"serving.replica_unhealthy: {self.name}/{rep.rid}: "
                f"{reason}", self.debug_state)

    def _beat_loop(self, rep):
        """One replica's heartbeat worker: beat, publish age, sweep
        the whole set for stale siblings, trigger own rejoin when
        beats resume after a stale window.  The fault site
        ``replica.<rid>.heartbeat`` sits BEFORE the beat update, so a
        ``stall`` rule is exactly a wedged worker: the thread sleeps,
        the beat ages, siblings detect it."""
        interval = self.config.replica_heartbeat_ms / 1e3
        while True:
            with self._cond:
                if self._stopping or rep.state == STOPPED:
                    return
            beat_ok = True
            try:
                # stall sleeps HERE (outside any lock); fail skips the
                # beat — both age the heartbeat
                _faults.inject(f"replica.{rep.rid}.heartbeat")
            except Exception:       # noqa: BLE001 — a missed beat
                beat_ok = False
            now = time.monotonic()
            with self._cond:
                if beat_ok and rep.state not in (DRAINING, STOPPED):
                    rep.last_beat = now
            self._sweep(now)
            self._maybe_rejoin(rep)
            with self._cond:
                if self._stopping or rep.state == STOPPED:
                    return
                self._cond.wait(interval)

    def _sweep(self, now=None, force=False):
        """Mark every replica whose heartbeat aged past the window
        UNHEALTHY, and publish heartbeat-age gauges.  Called from
        every beat AND from every routing decision, so detection needs
        neither traffic nor a dedicated monitor — but rate-limited to
        one pass per beat interval."""
        now = time.monotonic() if now is None else now
        window = self.config.replica_heartbeat_window_ms / 1e3
        min_gap = self.config.replica_heartbeat_ms / 1e3
        stale = []
        with self._cond:
            if not force and now - self._last_sweep < min_gap:
                return
            self._last_sweep = now
            for rep in self._replicas.values():
                if rep.state in (DRAINING, STOPPED):
                    continue
                age = now - rep.last_beat
                if _rm._ENABLED:
                    _rm.SERVING_REPLICA_HEARTBEAT_AGE.set(
                        age, model=self.name, replica=rep.rid)
                # PREWARMING is exempt: a replica mid-bring-up has no
                # beat thread yet, and _bring_up owns its transition
                if rep.state == HEALTHY and age > window:
                    stale.append((rep, age))
        for rep, age in stale:
            self._mark_unhealthy(
                rep, f"heartbeat stale: {age * 1e3:.0f}ms > window "
                f"{self.config.replica_heartbeat_window_ms:.0f}ms")

    def _maybe_rejoin(self, rep):
        """Heartbeat-recovery rejoin: beats resumed on a replica that
        went stale -> it re-passes PREWARM before becoming routable
        again (the rolling-recovery gate).  A replica whose last
        PREWARM itself failed retries here too, backed off by
        ``circuit_cooldown_ms`` — one transient prewarm failure must
        not strand it dark forever.  Only the replica's own beat thread
        calls this, so the check under the condition cannot race
        another rejoin."""
        window = self.config.replica_heartbeat_window_ms / 1e3
        cooldown = self.config.circuit_cooldown_ms / 1e3
        now = time.monotonic()
        with self._cond:
            reason = rep.unhealthy_reason or ""
            eligible = (rep.state == UNHEALTHY
                        and (now - rep.last_beat) < window
                        and (reason.startswith("heartbeat")
                             or (reason.startswith("prewarm failed")
                                 and now - rep.last_bringup
                                 >= cooldown)))
        if not eligible:
            return
        if rep.batcher is not None and reason.startswith("heartbeat"):
            # a replica whose worker stopped beating rejoins with its
            # programs built anew, as a restarted one does: on the card
            # its graphs are captured again (while its siblings replay
            # theirs) instead of trusting streams and graphs that sat
            # under a stalled worker.  An in-flight batch keeps the old
            # programs until it ends
            with self._cond:
                rep.batcher = DynamicBatcher(self.config,
                                             device=rep.device)
        if self._bring_up(rep):
            with self._cond:
                self._stats["rejoins"] += 1
            _LOG.info("replica %s/%s rejoined after prewarm",
                      self.name, rep.rid)

    # ------------------------------------------------------------- routing
    def _select(self, exclude=()):
        """The least-loaded routable replica (HEALTHY, breaker
        admitting), ties broken least-recently-routed; a
        failure-tripped UNHEALTHY replica whose breaker cooldown
        passed may be returned as its half-open probe.  Raises
        :class:`ServerOverloadedError` when nothing is routable — to a
        caller, a fully-dark replica set IS an overload: back off and
        retry (by then a probe or rejoin may have recovered one)."""
        self._sweep()
        with self._cond:
            if self._stopping:
                raise MXNetError(
                    f"ReplicaSet({self.name!r}) is stopped")
            healthy = sorted(
                (rep for rep in self._replicas.values()
                 if rep.rid not in exclude and rep.state == HEALTHY),
                key=lambda r: (r.inflight, r.last_routed))
            probes = [rep for rep in self._replicas.values()
                      if rep.rid not in exclude
                      and rep.state == UNHEALTHY
                      and rep.unhealthy_reason == "failures"]
            states = {rep.rid: rep.state
                      for rep in self._replicas.values()}
        # probe candidates go FIRST: a failure-tripped replica whose
        # cooldown passed gets exactly ONE request as its half-open
        # probe (the breaker admits a single probe per cooldown; a
        # failed probe fails over like any other failure), because with
        # healthy siblings always winning the sort, a healthy-last
        # order would never probe and the replica would stay dark
        # forever
        for rep in probes + healthy:
            try:
                rep.breaker.admit()
            except ServerOverloadedError:
                # breaker OPEN (windowed trip) on a still-HEALTHY
                # replica: reflect it in the state machine too
                if rep.state == HEALTHY:
                    self._mark_unhealthy(rep, "failures")
                continue
            return rep
        with self._cond:
            self._stats["no_healthy_rejects"] += 1
        raise ServerOverloadedError(
            self.name, self.config.retry_after_ms,
            f"no healthy replicas ({states})")

    def _note_dispatch(self, rep):
        with self._cond:
            rep.inflight += 1
            rep.requests += 1
            rep.last_routed = next(self._ticket)
            self._stats["dispatched"] += 1
        if _rm._ENABLED:
            _rm.SERVING_REPLICA_REQUESTS.inc(model=self.name,
                                             replica=rep.rid)
        _tr.tag("replica", rep.rid)

    def _note_done(self, rep):
        with self._cond:
            rep.inflight -= 1
            # only a drain (remove/restart) waits on inflight; waking
            # every beat thread per completed request would put an
            # O(replicas) sweep on the hot path for nothing
            if self._drain_waiters:
                self._cond.notify_all()

    def _note_failover(self, rep, exc):
        with self._cond:
            self._stats["failovers"] += 1
        if _rm._ENABLED:
            _rm.SERVING_REPLICA_FAILOVERS.inc(model=self.name)
        _tr.tag("failover_from", rep.rid)
        _LOG.warning("replica %s/%s failed (%s); failing over to a "
                     "sibling", self.name, rep.rid, exc)

    def _record_outcome(self, rep, ok):
        """Feed one EXECUTE outcome to the replica's breaker and keep
        the state machine in step with it: a trip marks UNHEALTHY
        ("failures"), a successful probe re-closes AND re-heals the
        state — the breaker half-open machinery IS the recovery path
        for transient-failure unhealth (its programs are still built;
        the prewarm gate applies to restarts and heartbeat rejoins,
        where the replica may have lost its state)."""
        from .resilience import CLOSED, OPEN
        state = rep.breaker.record(ok)
        if not ok:
            with self._cond:
                rep.failures += 1
            if state == OPEN:
                self._mark_unhealthy(rep, "failures")
        elif state == CLOSED:
            healed = False
            with self._cond:
                if rep.state == UNHEALTHY \
                        and rep.unhealthy_reason == "failures":
                    rep.state = HEALTHY
                    rep.unhealthy_reason = None
                    self._stats["rejoins"] += 1
                    healed = True
            if healed:
                self._publish_state(rep)
                _LOG.info("replica %s/%s re-closed after probe",
                          self.name, rep.rid)

    # ------------------------------------------------------------- predict
    def run_batch(self, request_inputs, deadline=None):
        """Dispatch one coalesced batch to the best replica, failing
        over to siblings on retryable failures while the ORIGINAL
        deadline allows.  Each replica is tried at most once per call;
        every replica replays the same kernels on the same inputs, so
        the caller cannot observe which one served."""
        deadline = deadline or Deadline()
        excluded = set()
        while True:
            rep = self._select(exclude=excluded)
            self._note_dispatch(rep)
            try:
                _faults.inject(f"replica.{rep.rid}.execute")
                results = rep.batcher.run_batch(self.entry,
                                                request_inputs,
                                                deadline=deadline)
            except Exception as e:      # noqa: BLE001 — policy below
                self._note_done(rep)
                if isinstance(e, DeadlineExceededError):
                    # a deadline that expired waiting (e.g. on another
                    # thread's bucket build) says nothing about THIS
                    # replica's health — same exclusion the model-level
                    # breaker applies; the budget is burned, so no
                    # sibling can serve it either
                    raise
                self._record_outcome(rep, False)
                # only retryable failures reroute: a deterministic
                # error (malformed request, poisoned input) fails
                # identically everywhere — surfacing it immediately
                # beats running it N times (the worker-level bisection
                # isolates poison)
                if not is_transient(e) or deadline.expired():
                    raise
                excluded.add(rep.rid)
                with self._cond:
                    remaining = any(
                        r.rid not in excluded
                        and r.state in (HEALTHY, UNHEALTHY)
                        for r in self._replicas.values())
                if not remaining:
                    raise
                self._note_failover(rep, e)
                continue
            self._note_done(rep)
            self._record_outcome(rep, True)
            return results

    # ------------------------------------------------------------ generate
    def generate(self, prompt, max_new_tokens=None, eos_id=None,
                 on_token=None, timeout=None, _trace_ctx=_UNSET):
        """Route one generation to the best replica's decode engine;
        if that replica dies mid-generation (its engine quarantines or
        stops the sequence — pages reclaimed leak-free by the §8
        path), re-admit the prompt as a FRESH request on a sibling
        while the retry budget (``config.retry_max``) and the ORIGINAL
        deadline allow.  Greedy decoding is deterministic, so the
        failed-over result equals an undisturbed run's.  Note for
        streaming callers: a failover restarts the token stream —
        ``on_token`` may re-deliver from the first token.
        """
        from .decode import _AMBIENT
        deadline = Deadline.start(timeout)
        excluded = set()
        failovers = 0
        while True:
            rep = self._select(exclude=excluded)
            if rep.engine is None:
                raise MXNetError(
                    f"ReplicaSet({self.name!r}): not a decoder entry")
            self._note_dispatch(rep)
            seq = None
            try:
                seq = rep.engine.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    eos_id=eos_id, on_token=on_token,
                    timeout=deadline.remaining(),
                    _trace_ctx=_AMBIENT if _trace_ctx is _UNSET
                    else _trace_ctx)
                out = rep.engine.result(seq,
                                        timeout=deadline.remaining())
            except ServerOverloadedError as e:
                # engine queue shed: says nothing about health — try a
                # less loaded sibling once, else surface the shed
                self._note_done(rep)
                excluded.add(rep.rid)
                with self._cond:
                    remaining = any(
                        r.rid not in excluded and r.state == HEALTHY
                        for r in self._replicas.values())
                if not remaining or deadline.expired():
                    raise
                self._note_failover(rep, e)
                continue
            except Exception as e:      # noqa: BLE001 — policy below
                self._note_done(rep)
                reason = None if seq is None else seq.finish_reason
                replica_death = reason in ("quarantined", "stopped",
                                           "error")
                if replica_death or is_transient(e):
                    self._record_outcome(rep, False)
                if not (replica_death or is_transient(e)) \
                        or failovers >= self.config.retry_max \
                        or deadline.expired():
                    raise
                excluded.add(rep.rid)
                with self._cond:
                    remaining = any(
                        r.rid not in excluded
                        and r.state in (HEALTHY, UNHEALTHY)
                        for r in self._replicas.values())
                if not remaining:
                    raise
                failovers += 1
                self._note_failover(rep, e)
                continue
            self._note_done(rep)
            self._record_outcome(rep, True)
            return out

    # -------------------------------------------------------- rolling ops
    def add_replica(self):
        """Add one replica UNDER LOAD: created, prewarmed (every
        bucket built + executed), and only then routable — traffic
        keeps flowing to the existing replicas meanwhile.  Returns the
        new replica id.

        A failed prewarm removes the replica again and raises its error
        (a failed capture on the card as its
        :class:`~mxnet_tpu_torch.base.KernelError`), where the reference
        keeps it UNHEALTHY for its heartbeat to retry: a scale-up that
        cannot capture is the autoscaler's ``error`` decision, and no
        dead replica stays behind retrying captures."""
        rep = self._create_replica()
        if self._bring_up(rep):
            return rep.rid
        err = rep.bringup_error
        try:
            self.remove_replica(rep.rid, timeout=0)
        except MXNetError:
            pass                # already stopped with the set
        if isinstance(err, MXNetError):
            raise err
        raise MXNetError(
            f"ReplicaSet({self.name!r}): replica {rep.rid} failed its "
            f"prewarm: {type(err).__name__}: {err}") from err

    def _drain(self, rep, timeout, strict):
        """Wait for ``rep``'s in-flight work (it is DRAINING, so nothing
        new routes to it).  ``strict`` raises when the budget runs out;
        otherwise the wait just ends."""
        deadline = Deadline.start(timeout)
        with self._cond:
            self._drain_waiters += 1
            try:
                while rep.inflight > 0:
                    if deadline.expired():
                        if not strict:
                            break
                        raise MXNetError(
                            f"ReplicaSet({self.name!r}): replica "
                            f"{rep.rid} still has {rep.inflight} "
                            f"in-flight request(s) after {timeout}s "
                            f"drain")
                    self._cond.wait(
                        min(0.05, deadline.remaining() or 0.05))
            finally:
                self._drain_waiters -= 1

    def remove_replica(self, rid, timeout=None):
        """Remove one replica UNDER LOAD: DRAINING (unroutable) ->
        wait for its in-flight work to finish -> stop.  In-flight
        requests complete on it; nothing new routes to it."""
        with self._cond:
            rep = self._replicas.get(rid)
            if rep is None:
                raise MXNetError(
                    f"ReplicaSet({self.name!r}): no replica {rid!r} "
                    f"(have {list(self._replicas)})")
            if len(self._replicas) == 1:
                raise MXNetError(
                    f"ReplicaSet({self.name!r}): refusing to remove "
                    f"the last replica — stop() the set instead")
            rep.state = DRAINING
        self._publish_state(rep)
        self._drain(rep, timeout, strict=True)
        if rep.engine is not None:
            rep.engine.stop()
        with self._cond:
            rep.state = STOPPED
            self._replicas.pop(rid, None)
            self._stats["drained"] += 1
        self._publish_state(rep)
        on_cuda = self._retire(rep)
        del rep
        if on_cuda:
            # the replica's graphs, pools and KV tensors are garbage
            # now; hand their blocks (a destroyed graph's private pool
            # included) back to the device, so add/remove cycles under
            # an autoscaler do not grow the reserved memory
            import gc
            import torch
            from ..engine import _CAPTURE_LOCK
            gc.collect()
            with _CAPTURE_LOCK:     # never beside another capture
                torch.cuda.empty_cache()
        return True

    def _retire(self, rep):
        """Drop a removed replica's device state: join its heartbeat
        thread (the last holder of the replica besides the caller) and
        evict its bucket programs (CUDA graphs and their pools); a
        decode replica's engine goes with the replica object.  Returns
        whether that state lived on a CUDA device."""
        with self._cond:
            self._cond.notify_all()
        t = rep.beat_thread
        if t is not None and t is not threading.current_thread():
            t.join(2.0 * self.config.replica_heartbeat_ms / 1e3 + 1.0)
        if rep.batcher is not None:
            rep.batcher.evict(self.entry)
            dev = rep.batcher.device or self.entry.device
        else:
            dev = getattr(rep.engine.model, "device", None)
        return dev is not None and str(dev).startswith("cuda")

    def restart(self, rid, timeout=None):
        """Replace one replica in place: drain + stop the old
        incarnation, then bring the SAME rid back through the full
        STARTING -> PREWARMING -> HEALTHY ladder (fresh breaker, fresh
        programs or engine and KV state) — the operator-initiated half
        of rolling recovery.  On the card the new incarnation captures
        its graphs while its siblings keep serving."""
        with self._cond:
            rep = self._replicas.get(rid)
            if rep is None:
                raise MXNetError(
                    f"ReplicaSet({self.name!r}): no replica {rid!r}")
            rep.state = DRAINING
        self._publish_state(rep)
        self._drain(rep, timeout, strict=False)
        if rep.engine is not None:
            rep.engine.stop()
        with self._cond:
            rep.state = STOPPED
        self._publish_state(rep)
        idx = int(rid[1:]) if rid[1:].isdigit() else 0
        fresh = self._new_replica(rid, idx)
        with self._cond:
            self._replicas[rid] = fresh
        self._publish_state(fresh)
        self._bring_up(fresh)
        return fresh.rid

    # ------------------------------------------------------------- readers
    def replicas(self):
        """{rid: state} snapshot."""
        with self._cond:
            return {rid: rep.state
                    for rid, rep in self._replicas.items()}

    def replica(self, rid):
        with self._cond:
            return self._replicas[rid]

    def decode_stats(self):
        """{rid: engine stats} for every decode replica."""
        with self._cond:
            reps = list(self._replicas.items())
        return {rid: rep.engine.stats() for rid, rep in reps
                if rep.engine is not None}

    def check_leaks(self):
        """Assert every decode replica's page allocator is exact
        (refcount == block-table slots + cache holds) — the
        quarantine-is-leak-free proof surface for chaos tests."""
        with self._cond:
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.engine is not None:
                rep.engine.allocator.check_leaks()

    def stats(self):
        with self._cond:
            out = dict(self._stats)
            reps = list(self._replicas.items())
            out["replicas"] = {
                rid: {"state": rep.state, "inflight": rep.inflight,
                      "requests": rep.requests,
                      "failures": rep.failures,
                      "prewarms": rep.prewarms,
                      "bringup_s": rep.bringup_s,
                      "heartbeat_age_s": round(
                          time.monotonic() - rep.last_beat, 6)}
                for rid, rep in reps}
        # program/engine reads go through their own locks, after _cond
        for rid, rep in reps:
            if rid in out["replicas"]:
                out["replicas"][rid]["capture_s"] = rep.capture_seconds()
        return out

    def debug_state(self):
        """JSON-serializable snapshot for the flight recorder:
        per-replica state machine, load, heartbeat age, breaker state,
        and (for decoders) the engine's own debug state."""
        now = time.monotonic()
        with self._cond:
            reps = list(self._replicas.items())
            out = {"model": self.name,
                   "version": self.entry.version,
                   "stopping": self._stopping,
                   "stats": dict(self._stats)}
        out["replicas"] = {}
        for rid, rep in reps:
            info = {"state": rep.state,
                    "unhealthy_reason": rep.unhealthy_reason,
                    "inflight": rep.inflight,
                    "requests": rep.requests,
                    "failures": rep.failures,
                    "prewarms": rep.prewarms,
                    "heartbeat_age_s": round(now - rep.last_beat, 6),
                    "breaker": rep.breaker.debug_state()}
            if rep.engine is not None:
                info["engine"] = rep.engine.debug_state()
            else:
                info["programs"] = rep.batcher.programs()
            out["replicas"][rid] = info
        return out

    def __repr__(self):
        return (f"ReplicaSet({self.name}:{self.entry.version}, "
                f"{self.replicas()})")
