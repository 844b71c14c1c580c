"""Traffic plane, part 3: per-tenant tiered admission
(docs/serving.md §11).

The PyTorch port of ``mxnet_tpu.serving.admission``: the same tiers,
thresholds, token buckets and retry-after values, decision for
decision, on host state alone (nothing here touches a device).

The ModelServer's watermark shed (§4) is blind to WHO is asking: when
the queue fills, the request that happens to arrive next is shed,
whether it came from the paying tenant the SLO contract names or from
a free-tier batch job.  This module puts identity ahead of that shed:

- **tiers** (:class:`TierPolicy`): named priority classes
  (``MXNET_SERVING_TENANT_TIERS``, e.g. ``gold=100/50``) with a
  per-tenant token-bucket quota (requests/s + burst) — a tenant over
  its quota is shed with a typed
  :class:`~mxnet_tpu_torch.serving.resilience.ServerOverloadedError`
  whose retry-after says when a token accrues;
- **priority shedding under overload**: the controller tracks a live
  pressure signal in ``[0, 1]`` (the server's queue fraction at every
  admission, max'd with whatever the
  :mod:`~mxnet_tpu_torch.serving.autoscaler` last published from its
  SLO sensors) and sheds LOW tiers first — tier ``k`` of ``K`` (lowest
  priority first) sheds at pressure
  ``shed_start + (1-shed_start)*(k+1)/K``, so the highest tier is
  never pressure-shed here (only the watermark itself stops it);
- wired into ``ModelServer.predict/generate`` admission AHEAD of the
  watermark shed, with per-tenant metrics
  (``serving.tenant.{requests,shed}``) under the metrics'
  label-cardinality guard and an ``admission.check`` fault site for
  chaos tests.
"""
from __future__ import annotations

import threading
import time

from .. import faults
from .. import runtime_metrics as _rm
from ..base import MXNetError, get_env
from .resilience import ServerOverloadedError

__all__ = ["TierPolicy", "AdmissionController", "parse_tier_spec"]

DEFAULT_TIER = "default"


class TierPolicy:
    """One admission class: ``priority`` orders shedding (higher
    survives longer), ``quota_rps`` is the per-tenant token refill rate
    (None = unmetered), ``burst`` the bucket capacity (default
    ``max(1, quota_rps)``)."""

    def __init__(self, name, priority, quota_rps=None, burst=None):
        self.name = str(name)
        self.priority = float(priority)
        self.quota_rps = None if quota_rps is None else float(quota_rps)
        if self.quota_rps is not None and self.quota_rps <= 0:
            raise MXNetError(
                f"TierPolicy({name!r}): quota_rps must be > 0 "
                f"(omit it for unmetered)")
        if burst is None:
            burst = None if self.quota_rps is None \
                else max(1.0, self.quota_rps)
        self.burst = None if burst is None else float(burst)
        if self.burst is not None and self.burst < 1:
            raise MXNetError(
                f"TierPolicy({name!r}): burst must be >= 1")

    def __repr__(self):
        return (f"TierPolicy({self.name!r}, priority={self.priority}, "
                f"quota_rps={self.quota_rps}, burst={self.burst})")


def parse_tier_spec(spec):
    """Parse ``MXNET_SERVING_TENANT_TIERS``:
    ``name=priority[/quota_rps[/burst]]`` comma-separated, e.g.
    ``gold=100,silver=10/20,free=1/5/8``.  Returns ``{name:
    TierPolicy}`` in declaration order."""
    tiers = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise MXNetError(
                f"tenant tier spec {part!r}: expected "
                f"name=priority[/quota_rps[/burst]]")
        name, rhs = part.split("=", 1)
        name = name.strip()
        fields = [f.strip() for f in rhs.split("/")]
        if not 1 <= len(fields) <= 3:
            raise MXNetError(
                f"tenant tier spec {part!r}: expected "
                f"priority[/quota_rps[/burst]]")
        try:
            priority = float(fields[0])
            quota = float(fields[1]) if len(fields) > 1 else None
            burst = float(fields[2]) if len(fields) > 2 else None
        except ValueError as e:
            raise MXNetError(
                f"tenant tier spec {part!r}: non-numeric field") from e
        if name in tiers:
            raise MXNetError(f"tenant tier {name!r} declared twice")
        tiers[name] = TierPolicy(name, priority, quota, burst)
    if not tiers:
        raise MXNetError(f"tenant tier spec {spec!r}: no tiers")
    return tiers


class _Bucket:
    """Token bucket, mutated only under the controller's lock."""

    __slots__ = ("tokens", "stamp")

    def __init__(self, tokens, stamp):
        self.tokens = tokens
        self.stamp = stamp


class AdmissionController:
    """Tier-ordered, quota-metered admission gate.

    ``check(tenant, model=...)`` either returns (admitted) or raises
    :class:`ServerOverloadedError` — the same typed contract as every
    other shed, so ``honor_retry_after`` clients back off identically.
    Two shed causes, in evaluation order:

    1. **pressure** (overload): effective pressure = max(the ``load``
       the server passes from its queue fraction, the last
       :meth:`update_pressure` value — published by the autoscaler's
       SLO sensors each tick, decaying after ``pressure_ttl_s`` so a
       dead controller cannot pin the gate shut).  A tier sheds when
       pressure reaches its threshold; thresholds stack low tier first.
    2. **quota**: the tenant's token bucket (rate = its tier's
       ``quota_rps``, capacity ``burst``); an empty bucket sheds with
       retry-after = time until one token accrues.

    A tenant maps to a tier by :meth:`register_tenant`, by a
    ``tenant="name:tier"`` suffix at the call site, or to
    ``default_tier`` (the highest-priority tier unless configured).
    Anonymous requests (``tenant=None``) ride the default tier
    unmetered by quota but still pressure-ordered.
    """

    def __init__(self, tiers, *, default_tier=None, shed_start=None,
                 retry_after_ms=50, pressure_ttl_s=5.0):
        if isinstance(tiers, str):
            tiers = parse_tier_spec(tiers)
        if not tiers:
            raise MXNetError("AdmissionController: no tiers")
        self.tiers = {name: pol for name, pol in tiers.items()}
        if shed_start is None:
            shed_start = get_env("MXNET_SERVING_ADMISSION_SHED_START",
                                 typ=float)
        self.shed_start = float(shed_start)
        if not 0.0 <= self.shed_start <= 1.0:
            raise MXNetError(
                "AdmissionController: shed_start must be in [0, 1]")
        self.retry_after_ms = float(retry_after_ms)
        self.pressure_ttl_s = float(pressure_ttl_s)
        if default_tier is None:
            default_tier = max(self.tiers.values(),
                               key=lambda p: p.priority).name
        if default_tier not in self.tiers:
            raise MXNetError(
                f"AdmissionController: default tier {default_tier!r} "
                f"not in {sorted(self.tiers)}")
        self.default_tier = default_tier
        # pressure threshold per tier: rank tiers by priority
        # ascending; tier k of K sheds at
        # shed_start + (1 - shed_start) * (k + 1) / K, so the lowest
        # tier goes first and the highest only at full pressure
        ranked = sorted(self.tiers.values(), key=lambda p: p.priority)
        k_total = len(ranked)
        self._shed_at = {
            pol.name: self.shed_start
            + (1.0 - self.shed_start) * (k + 1) / k_total
            for k, pol in enumerate(ranked)}
        self._lock = threading.Lock()
        self._tenants = {}              # tenant -> tier name
        self._buckets = {}              # tenant -> _Bucket
        self._pressure = 0.0
        self._pressure_stamp = 0.0
        self._stats = {"admitted": 0, "quota_sheds": 0,
                       "pressure_sheds": 0}
        self._by_tenant = {}            # tenant -> {admitted, shed}

    @classmethod
    def from_config(cls, config):
        """Build from ``ServingConfig`` when its ``tenant_tiers`` spec
        is set; None otherwise (admission off: the server's path
        without a tenant gate)."""
        spec = getattr(config, "tenant_tiers", None)
        if not spec:
            return None
        return cls(spec, retry_after_ms=config.retry_after_ms,
                   shed_start=config.admission_shed_start)

    # ------------------------------------------------------------ identity
    def register_tenant(self, tenant, tier):
        if tier not in self.tiers:
            raise MXNetError(
                f"register_tenant({tenant!r}): unknown tier {tier!r} "
                f"(have {sorted(self.tiers)})")
        with self._lock:
            self._tenants[str(tenant)] = tier

    def resolve(self, tenant):
        """(tenant, tier) for a call-site identity: ``None`` ->
        anonymous on the default tier; ``"name"`` -> registered or
        default tier; ``"name:tier"`` -> explicit tier (validated)."""
        if tenant is None:
            return None, self.default_tier
        tenant = str(tenant)
        if ":" in tenant:
            tenant, tier = tenant.rsplit(":", 1)
            if tier not in self.tiers:
                raise MXNetError(
                    f"tenant {tenant!r}: unknown tier {tier!r} "
                    f"(have {sorted(self.tiers)})")
            return tenant, tier
        with self._lock:
            return tenant, self._tenants.get(tenant, self.default_tier)

    # ------------------------------------------------------------ pressure
    def update_pressure(self, pressure, now=None):
        """Publish an overload signal in [0, 1] (the autoscaler's SLO
        sensors, or any operator).  Stale publishes expire after
        ``pressure_ttl_s``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._pressure = min(1.0, max(0.0, float(pressure)))
            self._pressure_stamp = now

    def pressure(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._pressure_stamp > self.pressure_ttl_s:
                return 0.0
            return self._pressure

    # ------------------------------------------------------------- check
    def check(self, tenant, *, model="", load=0.0, cost=1.0, now=None):
        """Admit or shed one request.  ``load`` is the caller's
        instantaneous pressure (the server's queue fraction); ``cost``
        the quota tokens this request spends.  Raises
        :class:`ServerOverloadedError` on shed; returns the resolved
        ``(tenant, tier)`` on admit."""
        now = time.monotonic() if now is None else now
        faults.inject("admission.check")
        tenant, tier = self.resolve(tenant)
        policy = self.tiers[tier]
        label = tenant if tenant is not None else "__anon__"
        reason = None
        retry_ms = self.retry_after_ms
        with self._lock:
            pressure = float(load)
            if now - self._pressure_stamp <= self.pressure_ttl_s:
                pressure = max(pressure, self._pressure)
            pressure = min(1.0, max(0.0, pressure))
            if pressure >= self._shed_at[tier]:
                self._stats["pressure_sheds"] += 1
                reason = (f"tier {tier!r} sheds at pressure "
                          f"{pressure:.2f} >= "
                          f"{self._shed_at[tier]:.2f} (priority "
                          f"shedding, low tier first)")
            elif policy.quota_rps is not None and tenant is not None:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = _Bucket(policy.burst, now)
                    self._buckets[tenant] = bucket
                bucket.tokens = min(
                    policy.burst,
                    bucket.tokens
                    + (now - bucket.stamp) * policy.quota_rps)
                bucket.stamp = now
                if bucket.tokens < cost:
                    self._stats["quota_sheds"] += 1
                    wait_s = (cost - bucket.tokens) / policy.quota_rps
                    retry_ms = max(retry_ms, 1e3 * wait_s)
                    reason = (f"tenant {tenant!r} over its {tier!r} "
                              f"quota ({policy.quota_rps}/s, burst "
                              f"{policy.burst})")
                else:
                    bucket.tokens -= cost
            per = self._by_tenant.setdefault(
                label, {"tier": tier, "admitted": 0, "shed": 0})
            per["tier"] = tier
            if reason is None:
                self._stats["admitted"] += 1
                per["admitted"] += 1
            else:
                per["shed"] += 1
        if reason is not None:
            if _rm._ENABLED:
                _rm.SERVING_TENANT_SHED.inc(tenant=label, tier=tier)
            raise ServerOverloadedError(model, retry_ms, reason)
        if _rm._ENABLED:
            _rm.SERVING_TENANT_REQUESTS.inc(tenant=label, tier=tier)
        return tenant, tier

    # ------------------------------------------------------------- state
    def shed_thresholds(self):
        """{tier: pressure threshold}, low tier first."""
        return dict(sorted(self._shed_at.items(), key=lambda kv: kv[1]))

    def stats(self):
        with self._lock:
            out = dict(self._stats)
            out["by_tenant"] = {t: dict(v)
                                for t, v in self._by_tenant.items()}
        out["pressure"] = self.pressure()
        return out

    def debug_state(self):
        """JSON-serializable snapshot for the flight recorder (the
        server's ``debug_state()["admission"]``)."""
        with self._lock:
            buckets = {t: round(b.tokens, 3)
                       for t, b in self._buckets.items()}
            tenants = dict(self._tenants)
        state = self.stats()
        state.update(
            tiers={n: repr(p) for n, p in self.tiers.items()},
            shed_thresholds=self.shed_thresholds(),
            default_tier=self.default_tier,
            tenant_tiers=tenants,
            quota_tokens=buckets)
        return state

    def __repr__(self):
        return (f"AdmissionController(tiers={sorted(self.tiers)}, "
                f"default={self.default_tier!r}, "
                f"shed_start={self.shed_start})")
