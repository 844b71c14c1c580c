"""Traffic plane, part 2: SLO-driven autoscaling of a ReplicaSet
(docs/serving.md §11).

The PyTorch port of ``mxnet_tpu.serving.autoscaler``: the same sensors,
policy and decision grammar, tick for tick.  The actuators are the
port's ``ReplicaSet.add_replica`` / ``remove_replica`` — prewarm-gated,
drain-gated, safe under load.  On the card a scale-up captures the new
replica's CUDA graphs (its bucket graphs, or its decode graphs and KV
pool) while the siblings keep replaying theirs; a scale-down drains the
replica and hands its graph pools and KV pages back to the device.
This module is the control loop that drives them:

- **sensors**: the signals already in
  :mod:`~mxnet_tpu_torch.runtime_metrics` — ``serving.queue.depth``,
  windowed p99 of the TTFT and request latency histograms
  (bucket-count deltas per control tick, so a burst an hour ago cannot
  pin today's quantile), and the replica state map;
- **targets** (:class:`SLOTargets`): declared TTFT/latency p99 bounds
  plus a queue-depth high watermark — the contract the controller
  defends, and what :func:`traffic.summarize` scores;
- **policy** (:class:`Autoscaler`): hysteresis (N consecutive breach
  ticks before scale-up, a longer idle streak before scale-down),
  per-direction cooldowns, a max-replica budget, and a prewarm-aware
  scale-up lead — bringing a replica up takes a measured prewarm
  time (on the card: its graph captures), so the breach streak
  required before acting SHRINKS by the ticks that prewarm will
  consume (capacity must start building before the SLO is fully lost,
  not after);
- **accountability**: every decision — hold included — increments
  ``serving.autoscale.decisions{model,action}``, publishes
  ``serving.autoscale.replicas_target``, and non-hold decisions root an
  ``autoscale.decide`` trace with the sensor readings as tags; the
  last decisions ring is in :meth:`Autoscaler.debug_state`;
- **overload coupling**: each tick publishes its pressure reading into
  the :class:`~mxnet_tpu_torch.serving.admission.AdmissionController`,
  so tier-ordered shedding reacts to the same SLO sensors that drive
  scaling;
- **chaos**: the ``autoscale.decide`` fault site fires before each
  actuation — an injected failure (e.g. a scale-up whose prewarm
  dies) must leave the loop alive, counted, and backing off.  A real
  prewarm failure is the same decision: the port's ``add_replica``
  removes a replica whose capture failed and raises its
  :class:`~mxnet_tpu_torch.base.KernelError`, an ``error`` decision;
  nothing serves in its place.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

from .. import engine as _engine
from .. import faults
from .. import runtime_metrics as _rm
from .. import tracing as _tr
from ..base import MXNetError, get_env
from .replica import HEALTHY

__all__ = ["SLOTargets", "AutoscalerConfig", "RuntimeMetricsSource",
           "Autoscaler"]


class SLOTargets:
    """Declared serving SLOs: p99 TTFT (generate) and p99 end-to-end
    latency (predict) in milliseconds, plus the queue-depth high
    watermark that signals saturation before latency does.  ``None``
    disables a target.  ``queue_low`` (default ``queue_high / 4``) is
    the scale-DOWN band — asymmetric on purpose, the hysteresis gap."""

    def __init__(self, ttft_p99_ms=None, latency_p99_ms=None,
                 queue_high=None, queue_low=None):
        def pick(value, env, typ=float):
            if value is None:
                value = get_env(env, typ=typ)
            return None if value is None else typ(value)

        self.ttft_p99_ms = pick(
            ttft_p99_ms, "MXNET_SERVING_AUTOSCALE_SLO_TTFT_P99_MS")
        self.latency_p99_ms = pick(
            latency_p99_ms, "MXNET_SERVING_AUTOSCALE_SLO_LATENCY_P99_MS")
        self.queue_high = pick(
            queue_high, "MXNET_SERVING_AUTOSCALE_QUEUE_HIGH", typ=int)
        if self.queue_high is not None and self.queue_high < 1:
            raise MXNetError("SLOTargets: queue_high must be >= 1")
        if queue_low is None and self.queue_high is not None:
            queue_low = max(1, self.queue_high // 4)
        self.queue_low = None if queue_low is None else int(queue_low)
        for name in ("ttft_p99_ms", "latency_p99_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise MXNetError(f"SLOTargets: {name} must be > 0")
        if self.queue_low is not None and self.queue_high is not None \
                and self.queue_low > self.queue_high:
            raise MXNetError(
                f"SLOTargets: queue_low ({self.queue_low}) above "
                f"queue_high ({self.queue_high}) — the hysteresis band "
                f"would invert")
        if self.ttft_p99_ms is None and self.latency_p99_ms is None \
                and self.queue_high is None:
            raise MXNetError(
                "SLOTargets: declare at least one target (ttft_p99_ms, "
                "latency_p99_ms, or queue_high)")

    def __repr__(self):
        return (f"SLOTargets(ttft_p99_ms={self.ttft_p99_ms}, "
                f"latency_p99_ms={self.latency_p99_ms}, "
                f"queue_high={self.queue_high}, "
                f"queue_low={self.queue_low})")


class AutoscalerConfig:
    """Control-loop policy (``MXNET_SERVING_AUTOSCALE_*`` defaults).

    - ``min_replicas`` / ``max_replicas``: the replica budget;
    - ``interval_s``: control period (the loop thread's tick);
    - ``breach_ticks``: consecutive breach ticks before scale-up
      (minus the prewarm lead, below); ``idle_ticks``: consecutive
      idle ticks before scale-down (longer — scaling down is cheap to
      delay, expensive to regret);
    - ``cooldown_up_s`` / ``cooldown_down_s``: per-direction refractory
      periods after ANY replica-count change, so one burst cannot
      staircase the fleet;
    - ``prewarm_lead_s``: initial estimate of one ``add_replica``
      prewarm (refined by an EWMA of measured prewarms).  The breach
      streak required before scaling up shrinks by
      ``prewarm / interval`` ticks — the lead time capacity needs to
      exist by the time the hysteresis window would have ended;
    - ``drain_timeout_s``: bound on a scale-down drain.
    """

    def __init__(self, min_replicas=None, max_replicas=None,
                 interval_s=None, breach_ticks=None, idle_ticks=None,
                 cooldown_up_s=None, cooldown_down_s=None,
                 prewarm_lead_s=None, drain_timeout_s=30.0,
                 scale_down_margin=0.5):
        def pick(value, env, typ=int):
            if value is None:
                value = get_env(env, typ=typ)
            return None if value is None else typ(value)

        def pick_s(value, env):
            # ctor args carry SECONDS; the env knobs are declared in
            # milliseconds, so only the env path converts
            if value is not None:
                return float(value)
            v = get_env(env, typ=float)
            return None if v is None else v / 1e3

        self.min_replicas = pick(min_replicas,
                                 "MXNET_SERVING_AUTOSCALE_MIN")
        self.max_replicas = pick(max_replicas,
                                 "MXNET_SERVING_AUTOSCALE_MAX")
        self.interval_s = pick_s(interval_s,
                                 "MXNET_SERVING_AUTOSCALE_INTERVAL_MS")
        self.breach_ticks = pick(breach_ticks,
                                 "MXNET_SERVING_AUTOSCALE_BREACH_TICKS")
        self.idle_ticks = pick(idle_ticks,
                               "MXNET_SERVING_AUTOSCALE_IDLE_TICKS")
        self.cooldown_up_s = pick_s(
            cooldown_up_s, "MXNET_SERVING_AUTOSCALE_COOLDOWN_UP_MS")
        self.cooldown_down_s = pick_s(
            cooldown_down_s, "MXNET_SERVING_AUTOSCALE_COOLDOWN_DOWN_MS")
        self.prewarm_lead_s = pick_s(
            prewarm_lead_s, "MXNET_SERVING_AUTOSCALE_PREWARM_LEAD_MS")
        self.drain_timeout_s = float(drain_timeout_s)
        self.scale_down_margin = float(scale_down_margin)
        if self.min_replicas < 1:
            raise MXNetError(
                "AutoscalerConfig: min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise MXNetError(
                f"AutoscalerConfig: max_replicas "
                f"({self.max_replicas}) below min_replicas "
                f"({self.min_replicas})")
        if self.interval_s <= 0:
            raise MXNetError(
                "AutoscalerConfig: interval must be > 0")
        if self.breach_ticks < 1 or self.idle_ticks < 1:
            raise MXNetError(
                "AutoscalerConfig: breach_ticks and idle_ticks must "
                "be >= 1")
        if self.cooldown_up_s < 0 or self.cooldown_down_s < 0 \
                or self.prewarm_lead_s < 0:
            raise MXNetError(
                "AutoscalerConfig: cooldowns and prewarm lead must "
                "be >= 0")
        if not 0.0 < self.scale_down_margin <= 1.0:
            raise MXNetError(
                "AutoscalerConfig: scale_down_margin must be in (0, 1]")

    def __repr__(self):
        return (f"AutoscalerConfig(min={self.min_replicas}, "
                f"max={self.max_replicas}, "
                f"interval_s={self.interval_s}, "
                f"breach_ticks={self.breach_ticks}, "
                f"idle_ticks={self.idle_ticks}, "
                f"cooldown_up_s={self.cooldown_up_s}, "
                f"cooldown_down_s={self.cooldown_down_s}, "
                f"prewarm_lead_s={self.prewarm_lead_s})")


def _quantile_from_counts(buckets, counts, q):
    """Prometheus-style interpolated quantile over one window's bucket
    counts (the delta between two cumulative snapshots).  NaN when the
    window saw nothing."""
    total = sum(counts)
    if total <= 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(buckets):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            frac = 0.0 if counts[i] == 0 else (rank - prev) / counts[i]
            return lo + (b - lo) * frac
        lo = b
    return buckets[-1]


class RuntimeMetricsSource:
    """The production sensor: reads the instruments the serving stack
    already publishes.  Queue depth comes from the
    ``serving.queue.depth`` gauge (labeled by server name); TTFT and
    latency p99 are WINDOWED — each :meth:`sample` diffs the
    histograms' cumulative bucket counts against the previous sample,
    so the quantile describes the last control interval, not the
    process lifetime.  Histogram reads aggregate across the model's
    replica series: replica-path engines observe under
    ``model="name/rid"`` while a direct engine uses ``model="name"``,
    and the controller defends the SET's tail, so both are summed into
    one distribution.  Not thread-safe: owned by one control loop
    (tests substitute any object with a compatible ``sample()``)."""

    def __init__(self, server_name, model):
        self.server_name = str(server_name)
        self.model = str(model)
        self._prev = {}

    def _fleet_counts(self, hist):
        prefix = self.model + "/"
        names = [m for m in hist.label_values("model")
                 if m == self.model or m.startswith(prefix)]
        counts = [0] * (len(hist.buckets) + 1)
        for m in names:
            for i, c in enumerate(hist.bucket_counts(model=m)):
                counts[i] += c
        return counts

    def _windowed_p99(self, hist):
        counts = self._fleet_counts(hist)
        prev = self._prev.get(hist.name)
        self._prev[hist.name] = counts
        if prev is None:
            delta = counts
        else:
            delta = [c - p for c, p in zip(counts, prev)]
        return _quantile_from_counts(hist.buckets, delta, 0.99)

    def sample(self):
        return {
            "queue_depth": _rm.SERVING_QUEUE_DEPTH.value(
                server=self.server_name),
            "ttft_p99_s": self._windowed_p99(
                _rm.SERVING_DECODE_TTFT_SECONDS),
            "latency_p99_s": self._windowed_p99(
                _rm.SERVING_REQUEST_SECONDS),
        }


class Autoscaler:
    """SLO-defending replica controller over one
    :class:`~mxnet_tpu_torch.serving.replica.ReplicaSet`.

    ``tick()`` runs one sense -> decide -> actuate cycle (tests drive
    it directly with a fake source and clock); :meth:`start` runs it on
    a daemon thread every ``config.interval_s``.  Actuation happens
    OUTSIDE the controller lock — ``add_replica`` blocks through a
    prewarm and must not freeze state readers meanwhile.

    Decision grammar (the ``action`` label of
    ``serving.autoscale.decisions``): ``up`` / ``down`` (actuated),
    ``hold`` (no change), ``blocked`` (breach sustained but the
    max-replica budget or a live cooldown refused it), ``error`` (the
    actuator raised — injected ``autoscale.decide`` chaos or a real
    prewarm failure, such as a graph capture's ``KernelError``; the
    loop stays alive and backs off by the up cooldown)."""

    def __init__(self, replica_set, slo=None, config=None, *,
                 source=None, admission=None, server_name=None,
                 clock=time.monotonic):
        self.rset = replica_set
        self.model = replica_set.name
        self.slo = slo or SLOTargets()
        self.config = config or AutoscalerConfig()
        if source is None:
            if server_name is None:
                raise MXNetError(
                    "Autoscaler: pass server_name= (the ModelServer's "
                    ".name, which labels serving.queue.depth) or an "
                    "explicit source=")
            source = RuntimeMetricsSource(server_name, self.model)
        self.source = source
        self.admission = admission
        self.clock = clock
        # engine.make_lock (not a bare threading.Lock) so the sanitizer
        # sees it in lock-order and lockset tracking
        self._lock = _engine.make_lock("serving.Autoscaler._lock")
        self._breach_streak = 0
        self._idle_streak = 0
        self._last_up = None            # clock stamps of last actuation
        self._last_change = None
        self._prewarm_s = self.config.prewarm_lead_s
        self._target = None
        self._decisions = deque(maxlen=32)
        # holds dominate a quiet loop and evict the interesting rows,
        # so actuations (up/down/blocked/error) keep their own ledger
        self._actuations = deque(maxlen=32)
        self._stats = {"ticks": 0, "up": 0, "down": 0, "hold": 0,
                       "blocked": 0, "error": 0}
        self._stop_evt = threading.Event()
        self._thread = None
        self._in_tick = False
        _engine.watch_races(self)

    # ------------------------------------------------------------- sensing
    def _pressure(self, depth, ttft_s, lat_s):
        """Worst breach ratio across declared targets, in [0, 1] —
        published to the admission controller so tier shedding tracks
        the same sensors."""
        ratios = [0.0]
        if self.slo.queue_high:
            ratios.append(depth / float(self.slo.queue_high))
        if self.slo.ttft_p99_ms and not math.isnan(ttft_s):
            ratios.append(1e3 * ttft_s / self.slo.ttft_p99_ms)
        if self.slo.latency_p99_ms and not math.isnan(lat_s):
            ratios.append(1e3 * lat_s / self.slo.latency_p99_ms)
        return min(1.0, max(ratios))

    def _breaches(self, depth, ttft_s, lat_s):
        out = []
        if self.slo.queue_high is not None \
                and depth >= self.slo.queue_high:
            out.append(f"queue depth {depth:.0f} >= "
                       f"{self.slo.queue_high}")
        if self.slo.ttft_p99_ms is not None and not math.isnan(ttft_s) \
                and 1e3 * ttft_s > self.slo.ttft_p99_ms:
            out.append(f"ttft p99 {1e3 * ttft_s:.1f}ms > "
                       f"{self.slo.ttft_p99_ms}ms")
        if self.slo.latency_p99_ms is not None \
                and not math.isnan(lat_s) \
                and 1e3 * lat_s > self.slo.latency_p99_ms:
            out.append(f"latency p99 {1e3 * lat_s:.1f}ms > "
                       f"{self.slo.latency_p99_ms}ms")
        return out

    def _is_idle(self, depth, ttft_s, lat_s):
        m = self.config.scale_down_margin
        if self.slo.queue_low is not None and depth > self.slo.queue_low:
            return False
        if self.slo.ttft_p99_ms is not None and not math.isnan(ttft_s) \
                and 1e3 * ttft_s > m * self.slo.ttft_p99_ms:
            return False
        if self.slo.latency_p99_ms is not None \
                and not math.isnan(lat_s) \
                and 1e3 * lat_s > m * self.slo.latency_p99_ms:
            return False
        return True

    # ------------------------------------------------------------ deciding
    def tick(self, now=None):
        """One control cycle; returns the decision record (or None when
        another tick is already in flight)."""
        now = self.clock() if now is None else now
        with self._lock:
            if self._in_tick:
                return None
            self._in_tick = True
        try:
            return self._tick_locked_out(now)
        finally:
            with self._lock:
                self._in_tick = False

    def _tick_locked_out(self, now):
        cfg = self.config
        sample = self.source.sample()

        def _f(key, default):
            v = sample.get(key, default)
            return default if v is None else float(v)

        depth = _f("queue_depth", 0.0)
        ttft_s = _f("ttft_p99_s", float("nan"))
        lat_s = _f("latency_p99_s", float("nan"))
        states = self.rset.replicas()
        total = len(states)
        healthy = sum(1 for s in states.values() if s == HEALTHY)
        breaches = self._breaches(depth, ttft_s, lat_s)
        idle = not breaches and self._is_idle(depth, ttft_s, lat_s)
        pressure = self._pressure(depth, ttft_s, lat_s)
        if self.admission is not None:
            self.admission.update_pressure(pressure, now=now)

        with self._lock:
            self._stats["ticks"] += 1
            self._breach_streak = self._breach_streak + 1 if breaches \
                else 0
            self._idle_streak = self._idle_streak + 1 if idle else 0
            breach_streak, idle_streak = self._breach_streak, \
                self._idle_streak
            # prewarm-aware lead: the ticks a prewarm will consume are
            # ticks the hysteresis window cannot afford to wait
            lead_ticks = int(math.ceil(
                self._prewarm_s / cfg.interval_s)) \
                if self._prewarm_s > 0 else 0
            need_ticks = max(1, cfg.breach_ticks - lead_ticks)
            in_up_cd = self._last_up is not None \
                and now - self._last_up < cfg.cooldown_up_s
            in_down_cd = self._last_change is not None \
                and now - self._last_change < cfg.cooldown_down_s

        action, reason = "hold", "within SLO band"
        if breaches:
            reason = "; ".join(breaches) \
                + f" (streak {breach_streak}/{need_ticks})"
            if breach_streak >= need_ticks:
                if total >= cfg.max_replicas:
                    action = "blocked"
                    reason += (f"; at max-replica budget "
                               f"({cfg.max_replicas})")
                elif in_up_cd:
                    action = "blocked"
                    reason += "; in scale-up cooldown"
                else:
                    action = "up"
        elif idle and idle_streak >= cfg.idle_ticks \
                and total > cfg.min_replicas:
            if in_down_cd:
                action = "blocked"
                reason = (f"idle streak {idle_streak} but in "
                          f"scale-down cooldown")
            else:
                action = "down"
                reason = (f"idle {idle_streak} ticks (queue "
                          f"{depth:.0f}, margin "
                          f"{cfg.scale_down_margin})")

        target = total
        error = None
        if action == "up":
            target = total + 1
            try:
                faults.inject("autoscale.decide")
                t0 = time.monotonic()
                rid = self.rset.add_replica()
                prewarm_s = time.monotonic() - t0
                with self._lock:
                    self._prewarm_s = prewarm_s \
                        if self._prewarm_s == 0 \
                        else 0.5 * self._prewarm_s + 0.5 * prewarm_s
                reason = (f"added {rid} (prewarm {prewarm_s:.3f}s): "
                          f"{reason}")
            except MXNetError as e:
                action, error = "error", e
                target = total
                reason = f"scale-up failed: {e}"
            stamp_up = True
        elif action == "down":
            target = total - 1
            victim = self._pick_victim(states)
            try:
                faults.inject("autoscale.decide")
                if victim is None:
                    raise MXNetError(
                        f"Autoscaler({self.model}): no healthy replica "
                        f"to drain (states {states})")
                self.rset.remove_replica(
                    victim, timeout=cfg.drain_timeout_s)
                reason = f"drained {victim}: {reason}"
            except MXNetError as e:
                action, error = "error", e
                target = total
                reason = f"scale-down failed: {e}"
            stamp_up = False
        else:
            stamp_up = None

        with self._lock:
            if action in ("up", "down") or error is not None:
                # an error backs off like the actuation it failed —
                # a dead actuator must not be hammered every tick
                self._last_change = now
                if stamp_up or error is not None:
                    self._last_up = now
                self._breach_streak = 0
                self._idle_streak = 0
            self._target = target
            self._stats[action] += 1
            record = {"t": now, "action": action, "reason": reason,
                      "replicas": total, "healthy": healthy,
                      "target": target, "queue_depth": depth,
                      "ttft_p99_s": None if math.isnan(ttft_s)
                      else round(ttft_s, 6),
                      "latency_p99_s": None if math.isnan(lat_s)
                      else round(lat_s, 6),
                      "pressure": round(pressure, 4)}
            self._decisions.append(record)
            if action != "hold":
                self._actuations.append(record)

        if _rm._ENABLED:
            _rm.SERVING_AUTOSCALE_DECISIONS.inc(
                model=self.model, action=action)
            _rm.SERVING_AUTOSCALE_REPLICAS_TARGET.set(
                target, model=self.model)
        if action != "hold":
            with _tr.trace("autoscale.decide", model=self.model,
                           action=action) as root:
                root.set_tag("reason", reason)
                root.set_tag("replicas", total)
                root.set_tag("target", target)
                root.set_tag("queue_depth", depth)
                root.set_tag("pressure", round(pressure, 4))
        return record

    def _pick_victim(self, states):
        """Healthy replica with the least in-flight work (ties: the
        newest rid) — the cheapest drain."""
        healthy = [rid for rid, s in states.items() if s == HEALTHY]
        if len(healthy) < 2:
            return None
        per = self.rset.stats()["replicas"]
        return min(healthy,
                   key=lambda r: (per.get(r, {}).get("inflight", 0),
                                  -_rid_ord(r)))

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Run the control loop on a daemon thread every
        ``config.interval_s`` until :meth:`stop`."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_evt.clear()
            self._thread = _engine.make_thread(
                self._loop, name=f"mxnet-autoscale-{self.model}",
                owner=f"Autoscaler({self.model})")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop_evt.wait(self.config.interval_s):
            try:
                self.tick()
            except MXNetError:
                # tick() already demoted actuator failures to counted
                # "error" decisions; anything landing here is a sensor
                # failure — the loop must outlive it
                continue

    def stop(self, timeout=5.0):
        self._stop_evt.set()
        with self._lock:
            th = self._thread
            self._thread = None
        if th is not None:
            th.join(timeout)
        return True

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- state
    def target(self):
        with self._lock:
            return self._target

    def last_decisions(self, n=8):
        with self._lock:
            return list(self._decisions)[-n:]

    def last_actuations(self, n=8):
        """The most recent NON-hold decisions (up/down/blocked/error)
        — survives long quiet stretches that evict them from
        :meth:`last_decisions`."""
        with self._lock:
            return list(self._actuations)[-n:]

    def stats(self):
        with self._lock:
            out = dict(self._stats)
            out["prewarm_estimate_s"] = round(self._prewarm_s, 6)
            out["target"] = self._target
            out["breach_streak"] = self._breach_streak
            out["idle_streak"] = self._idle_streak
        return out

    def debug_state(self):
        state = self.stats()
        state.update(model=self.model, slo=repr(self.slo),
                     config=repr(self.config),
                     replicas=self.rset.replicas(),
                     decisions=self.last_decisions(8),
                     actuations=self.last_actuations(8))
        if self.admission is not None:
            state["admission_pressure"] = self.admission.pressure()
        return state

    def __repr__(self):
        return (f"Autoscaler({self.model}, {self.slo}, "
                f"replicas={self.rset.replicas()})")


def _rid_ord(rid):
    """Numeric suffix of a replica id ('r2' -> 2) for tie-breaks."""
    digits = "".join(ch for ch in str(rid) if ch.isdigit())
    return int(digits) if digits else 0
