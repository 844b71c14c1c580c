"""PyTorch port, traffic plane parts 2+3: SLO-driven autoscaling and
tiered admission — twins of the JAX package's
tests/test_autoscale_admission.py, case for case, on the same fakes.

The autoscaler is driven tick-by-tick with a fake metrics source and a
fake clock against REAL ReplicaSets of numpy function entries — no
device work, zero wall-clock sleeps in the decision logic — so
hysteresis, cooldowns, the prewarm-aware lead, and the chaos path are
asserted at exact tick granularity.  Admission is likewise clocked
through explicit ``now=`` stamps.

Then parity with the JAX package on the same inputs: a scripted
``(tenant, load, now)`` sequence gives the same admit/shed decisions
and retry-after values in both ``AdmissionController``s; the same fake
sensor sequence gives the same decision ring tick for tick in both
``Autoscaler``s; and both ``ModelServer``s with ``tenant_tiers`` set
shed the same requests of a small BERT classifier (predict) and a small
decoder LM (generate) and agree on the ok outputs.
"""
import math
import time

import numpy as np
import pytest

from mxnet_tpu_torch import faults, runtime_metrics as rm, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving.admission import (AdmissionController,
                                               TierPolicy, parse_tier_spec)
from mxnet_tpu_torch.serving.autoscaler import (Autoscaler,
                                                AutoscalerConfig,
                                                RuntimeMetricsSource,
                                                SLOTargets,
                                                _quantile_from_counts)
from mxnet_tpu_torch.serving.resilience import (Deadline,
                                                ServerOverloadedError,
                                                honor_retry_after)


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.clear()
    rm.reset()
    rm.enable()
    yield
    faults.clear()
    rm.disable()
    rm.reset()


SIG = [{"shape": [None, 2], "dtype": "float32"}]
TIERS = "gold=100,silver=10/50,free=1/5/8"


def _fn(a):
    return a * 2.0 + 1.0


def _server(**cfg_kw):
    repo = serving.ModelRepository()
    repo.add_function("m", _fn, SIG)
    cfg_kw.setdefault("max_batch_size", 4)
    cfg_kw.setdefault("max_latency_us", 1)
    return serving.ModelServer(repo, serving.ServingConfig(**cfg_kw))


# ------------------------------------------------------------ tier specs
class TestTierSpec:
    def test_parse(self):
        tiers = parse_tier_spec(TIERS)
        assert list(tiers) == ["gold", "silver", "free"]
        assert tiers["gold"].quota_rps is None
        assert tiers["silver"].quota_rps == 50 \
            and tiers["silver"].burst == 50     # burst defaults to quota
        assert tiers["free"].burst == 8

    @pytest.mark.parametrize("bad", ["", "gold", "gold=a", "g=1/2/3/4",
                                     "gold=1,gold=2"])
    def test_parse_rejects(self, bad):
        with pytest.raises(MXNetError):
            parse_tier_spec(bad)

    def test_policy_validation(self):
        with pytest.raises(MXNetError):
            TierPolicy("t", 1, quota_rps=0)
        with pytest.raises(MXNetError):
            TierPolicy("t", 1, quota_rps=5, burst=0)


# ------------------------------------------------------------- admission
class TestAdmission:
    def test_default_tier_is_highest_priority(self):
        adm = AdmissionController(TIERS)
        assert adm.default_tier == "gold"
        assert adm.resolve(None) == (None, "gold")
        assert adm.resolve("a") == ("a", "gold")
        assert adm.resolve("a:free") == ("a", "free")
        with pytest.raises(MXNetError):
            adm.resolve("a:platinum")

    def test_register_tenant(self):
        adm = AdmissionController(TIERS)
        adm.register_tenant("bob", "free")
        assert adm.resolve("bob") == ("bob", "free")
        with pytest.raises(MXNetError):
            adm.register_tenant("bob", "nope")

    def test_shed_thresholds_stack_low_tier_first(self):
        adm = AdmissionController(TIERS, shed_start=0.5)
        th = adm.shed_thresholds()
        assert list(th) == ["free", "silver", "gold"]
        assert th["free"] == pytest.approx(0.5 + 0.5 / 3)
        assert th["gold"] == pytest.approx(1.0)

    def test_pressure_sheds_in_tier_order(self):
        adm = AdmissionController(TIERS, shed_start=0.5)
        # free sheds at its threshold while silver and gold pass
        p_free = adm.shed_thresholds()["free"] + 0.01
        with pytest.raises(ServerOverloadedError) as ei:
            adm.check("a:free", model="m", load=p_free, now=0.0)
        assert "priority shedding" in str(ei.value)
        adm.check("b:silver", model="m", load=p_free, now=0.0)
        adm.check("c:gold", model="m", load=p_free, now=0.0)
        # at full pressure even gold sheds
        with pytest.raises(ServerOverloadedError):
            adm.check("c:gold", model="m", load=1.0, now=0.0)
        s = adm.stats()
        assert s["pressure_sheds"] == 2 and s["admitted"] == 2
        assert s["by_tenant"]["a"]["shed"] == 1

    def test_autoscaler_published_pressure_maxes_with_load(self):
        adm = AdmissionController(TIERS, shed_start=0.5,
                                  pressure_ttl_s=5.0)
        adm.update_pressure(0.95, now=10.0)
        # local load says calm, the published SLO pressure says shed
        with pytest.raises(ServerOverloadedError):
            adm.check("a:free", model="m", load=0.0, now=11.0)
        # and the publish decays after its TTL — a dead autoscaler
        # cannot pin the gate shut
        adm.check("a:free", model="m", load=0.0, now=20.0)
        assert adm.pressure(now=20.0) == 0.0

    def test_quota_bucket_meters_and_refills(self):
        adm = AdmissionController("gold=100,free=1/5/2")
        adm.check("a:free", now=0.0)
        adm.check("a:free", now=0.0)     # burst of 2 spent
        with pytest.raises(ServerOverloadedError) as ei:
            adm.check("a:free", now=0.0)
        assert "quota" in str(ei.value)
        # retry-after covers the time until one token accrues (0.2s
        # at 5 rps)
        assert ei.value.retry_after_ms >= 200
        # refill: 0.2s later exactly one token is back
        adm.check("a:free", now=0.2)
        with pytest.raises(ServerOverloadedError):
            adm.check("a:free", now=0.2)
        # quota is per tenant, not per tier
        adm.check("b:free", now=0.2)

    def test_anonymous_and_unquotad_tiers_are_exempt(self):
        adm = AdmissionController("gold=100,free=1/5/2")
        for _ in range(10):
            adm.check(None, now=0.0)         # anonymous: no bucket
            adm.check("g:gold", now=0.0)     # gold has no quota_rps
        assert adm.stats()["quota_sheds"] == 0

    def test_metrics_under_cardinality_guard(self):
        adm = AdmissionController("gold=100,free=1/5/1")
        adm.check("a:free", now=0.0)
        with pytest.raises(ServerOverloadedError):
            adm.check("a:free", now=0.0)
        adm.check(None, now=0.0)
        assert rm.SERVING_TENANT_REQUESTS.value(
            tenant="a", tier="free") == 1
        assert rm.SERVING_TENANT_SHED.value(
            tenant="a", tier="free") == 1
        assert rm.SERVING_TENANT_REQUESTS.value(
            tenant="__anon__", tier="gold") == 1

    def test_typed_contract_retries_cleanly(self):
        # the shed is the SAME typed family every other shed uses, so
        # honor_retry_after backs off and succeeds once quota refills
        adm = AdmissionController("free=1/100/1", retry_after_ms=5)
        t0 = time.monotonic()
        calls = []

        def attempt():
            calls.append(1)
            adm.check("a:free")          # real clock: refills at 100/s
            return "ok"

        out = honor_retry_after(attempt, attempts=6,
                                deadline=Deadline.start(5.0))
        assert out == "ok" and len(calls) >= 1
        assert time.monotonic() - t0 < 5.0

    def test_from_config_gating(self):
        cfg = serving.ServingConfig(tenant_tiers=None)
        assert AdmissionController.from_config(cfg) is None
        cfg = serving.ServingConfig(tenant_tiers=TIERS,
                                    admission_shed_start=0.25)
        adm = AdmissionController.from_config(cfg)
        assert adm is not None and adm.shed_start == 0.25

    def test_env_spec(self, monkeypatch):
        monkeypatch.setenv("MXNET_SERVING_TENANT_TIERS",
                           "vip=9,basic=1/10")
        cfg = serving.ServingConfig()
        adm = AdmissionController.from_config(cfg)
        assert sorted(adm.tiers) == ["basic", "vip"]
        assert adm.default_tier == "vip"

    def test_debug_state_serializes(self):
        import json
        adm = AdmissionController(TIERS)
        adm.check("a:free", now=0.0)
        json.dumps(adm.debug_state())


# --------------------------------------------------- server integration
class TestServerAdmission:
    def test_tenant_gate_ahead_of_watermark(self):
        srv = _server(tenant_tiers="gold=100,free=1/5/1")
        try:
            x = np.ones((1, 2), np.float32)
            out = srv.predict("m", x, tenant="a:gold")
            assert out.shape == (1, 2)
            srv.predict("m", x, tenant="b:free")
            with pytest.raises(ServerOverloadedError) as ei:
                srv.predict("m", x, tenant="b:free")   # burst 1 spent
            assert "quota" in str(ei.value)
            st = srv.stats()
            assert st["tenant_sheds"] == 1
            assert st["shed"] >= 1
            assert st["admission"]["quota_sheds"] == 1
            # the typed shed reached the shared serving.shed metric too
            assert rm.SERVING_SHED.value(model="m") == 1
            assert "admission" in srv.debug_state()
        finally:
            srv.stop()

    def test_generate_path_gated(self):
        # a numpy decode-model fake (the ChainModel protocol of
        # tests/test_torch_serving_decode.py) — the gate must sit ahead of
        # the decode engine, so the engine is never even built
        class ChainLM:
            vocab_size = 8
            max_context = 16

            def _row(self, t):
                row = np.zeros((self.vocab_size,), np.float32)
                row[(int(t) + 1) % self.vocab_size] = 1.0
                return row

            def prefill(self, tokens, length, block_table):
                return self._row(tokens[0, int(length) - 1])

            def decode_step(self, tokens, positions, block_tables):
                return np.stack([self._row(t) for t in tokens])

        repo = serving.ModelRepository()
        repo.add_decoder("lm", ChainLM())
        srv = serving.ModelServer(repo, serving.ServingConfig(
            tenant_tiers="gold=100,free=1/5/1",
            decode_page_size=4, decode_pool_pages=9,
            decode_max_batch=2))
        try:
            srv.admission_controller().update_pressure(1.0)
            with pytest.raises(ServerOverloadedError):
                srv.generate("lm", [1, 2], max_new_tokens=2,
                             tenant="a:gold")
            assert srv.stats()["tenant_sheds"] == 1
            # pressure decays / clears -> the same request admits
            srv.admission_controller().update_pressure(0.0)
            out = srv.generate("lm", [1, 2], max_new_tokens=2,
                               tenant="a:gold")
            assert list(out) == [3, 4]   # next = last + 1
        finally:
            srv.stop()

    def test_no_tiers_means_no_gate(self):
        srv = _server()
        try:
            assert srv.admission_controller() is None
            out = srv.predict("m", np.ones((1, 2), np.float32),
                              tenant="anyone:anything")
            assert out.shape == (1, 2)
        finally:
            srv.stop()


# ------------------------------------------------------------------ SLOs
class TestSLOTargets:
    def test_requires_one_target(self):
        with pytest.raises(MXNetError):
            SLOTargets()

    def test_queue_band_defaults(self):
        slo = SLOTargets(queue_high=8)
        assert slo.queue_low == 2
        with pytest.raises(MXNetError):
            SLOTargets(queue_high=4, queue_low=9)

    def test_env_defaults(self, monkeypatch):
        monkeypatch.setenv("MXNET_SERVING_AUTOSCALE_SLO_TTFT_P99_MS",
                           "250")
        slo = SLOTargets()
        assert slo.ttft_p99_ms == 250.0 and slo.queue_high is None

    def test_config_validation(self):
        with pytest.raises(MXNetError):
            AutoscalerConfig(min_replicas=3, max_replicas=2)
        with pytest.raises(MXNetError):
            AutoscalerConfig(breach_ticks=0)
        cfg = AutoscalerConfig(interval_s=0.25, cooldown_up_s=1.5)
        assert cfg.interval_s == 0.25        # ctor args are seconds
        assert cfg.cooldown_up_s == 1.5

    def test_config_env_is_milliseconds(self, monkeypatch):
        monkeypatch.setenv("MXNET_SERVING_AUTOSCALE_INTERVAL_MS", "500")
        monkeypatch.setenv("MXNET_SERVING_AUTOSCALE_COOLDOWN_UP_MS",
                           "2500")
        cfg = AutoscalerConfig()
        assert cfg.interval_s == 0.5 and cfg.cooldown_up_s == 2.5


class TestWindowedQuantile:
    def test_interpolated(self):
        buckets = [0.1, 1.0, 10.0]
        assert _quantile_from_counts(buckets, [100, 0, 0, 0], 0.99) \
            <= 0.1
        assert math.isnan(_quantile_from_counts(buckets, [0, 0, 0, 0],
                                                0.99))
        hi = _quantile_from_counts(buckets, [0, 0, 0, 5], 0.99)
        assert hi == 10.0                   # overflow pins to top edge

    def test_runtime_source_windows_the_histogram(self):
        src = RuntimeMetricsSource("srvX", "m")
        rm.SERVING_REQUEST_SECONDS.observe(9.0, model="m")
        s1 = src.sample()                   # window 1 sees the 9s burst
        assert s1["latency_p99_s"] > 1.0
        rm.SERVING_REQUEST_SECONDS.observe(0.001, model="m")
        s2 = src.sample()                   # window 2 must NOT
        assert s2["latency_p99_s"] < 1.0    # remember the old burst
        s3 = src.sample()                   # empty window -> NaN
        assert math.isnan(s3["latency_p99_s"])
        rm.SERVING_QUEUE_DEPTH.set(7, server="srvX")
        assert src.sample()["queue_depth"] == 7

    def test_runtime_source_aggregates_replica_series(self):
        # replica-path decode engines observe TTFT under
        # model="name/rid" (replica.py) — the sensor must sum those
        # series, or a replicated fleet's breach is invisible
        src = RuntimeMetricsSource("srvY", "lm")
        rm.SERVING_DECODE_TTFT_SECONDS.observe(4.0, model="lm/r0")
        rm.SERVING_DECODE_TTFT_SECONDS.observe(4.0, model="lm/r1")
        rm.SERVING_DECODE_TTFT_SECONDS.observe(4.0, model="lm2")  # other
        s = src.sample()
        assert s["ttft_p99_s"] > 1.0
        # windowing still applies across the aggregate
        assert math.isnan(src.sample()["ttft_p99_s"])

    def test_histogram_label_values(self):
        rm.SERVING_DECODE_TTFT_SECONDS.observe(0.1, model="a")
        rm.SERVING_DECODE_TTFT_SECONDS.observe(0.2, model="b")
        assert rm.SERVING_DECODE_TTFT_SECONDS.label_values("model") \
            == ["a", "b"]
        with pytest.raises(MXNetError):
            rm.SERVING_DECODE_TTFT_SECONDS.label_values("nope")


# ------------------------------------------------------------ autoscaler
class _FakeSource:
    def __init__(self, queue=0.0, ttft=None, latency=None):
        self.queue, self.ttft, self.latency = queue, ttft, latency

    def sample(self):
        return {"queue_depth": self.queue, "ttft_p99_s": self.ttft,
                "latency_p99_s": self.latency}


class _Harness:
    """Real server + ReplicaSet, fake clock + sensor, manual ticks."""

    def __init__(self, replicas=2, slo=None, admission=None, **cfg_kw):
        self.srv = _server(replicas=replicas)
        self.rset = self.srv.replica_set("m")
        self.src = _FakeSource()
        self.now = 0.0
        cfg_kw.setdefault("min_replicas", 1)
        cfg_kw.setdefault("max_replicas", 4)
        cfg_kw.setdefault("interval_s", 0.1)
        cfg_kw.setdefault("breach_ticks", 2)
        cfg_kw.setdefault("idle_ticks", 3)
        cfg_kw.setdefault("cooldown_up_s", 0.0)
        cfg_kw.setdefault("cooldown_down_s", 0.0)
        self.asc = Autoscaler(
            self.rset, slo or SLOTargets(queue_high=8),
            AutoscalerConfig(**cfg_kw), source=self.src,
            admission=admission, clock=lambda: self.now)

    def tick(self):
        self.now += 0.1
        return self.asc.tick()

    def replicas(self):
        return len(self.rset.replicas())

    def close(self):
        self.asc.stop()
        self.srv.stop()


@pytest.fixture
def h():
    hs = []

    def make(**kw):
        hs.append(_Harness(**kw))
        return hs[-1]

    yield make
    for x in hs:
        x.close()


class TestAutoscaler:
    def test_scale_up_needs_hysteresis(self, h):
        hx = h()
        hx.src.queue = 20.0
        assert hx.tick()["action"] == "hold"     # streak 1 < 2
        d = hx.tick()
        assert d["action"] == "up" and hx.replicas() == 3
        assert "queue depth" in d["reason"]

    def test_one_breach_tick_is_noise(self, h):
        hx = h()
        hx.src.queue = 20.0
        hx.tick()
        hx.src.queue = 0.0                       # breach clears
        assert hx.tick()["action"] == "hold"
        hx.src.queue = 20.0
        assert hx.tick()["action"] == "hold"     # streak restarted
        assert hx.replicas() == 2

    def test_up_cooldown_blocks_staircase(self, h):
        hx = h(cooldown_up_s=0.5)
        hx.src.queue = 20.0
        hx.tick()
        assert hx.tick()["action"] == "up"
        for _ in range(4):                       # 0.4s < cooldown
            d = hx.tick()
        assert d["action"] == "blocked" and "cooldown" in d["reason"]
        assert hx.replicas() == 3
        for _ in range(2):                       # past the cooldown
            d = hx.tick()
        assert d["action"] == "up" and hx.replicas() == 4

    def test_blocked_at_max_budget(self, h):
        hx = h(max_replicas=2)
        hx.src.queue = 20.0
        hx.tick()
        d = hx.tick()
        assert d["action"] == "blocked"
        assert "max-replica budget" in d["reason"]
        assert hx.replicas() == 2

    def test_scale_down_on_idle_not_below_min(self, h):
        hx = h(replicas=3, min_replicas=2, idle_ticks=3)
        hx.src.queue = 0.0
        acts = [hx.tick()["action"] for _ in range(4)]
        assert acts == ["hold", "hold", "down", "hold"]
        assert hx.replicas() == 2
        for _ in range(5):
            assert hx.tick()["action"] == "hold"     # at the floor
        assert hx.replicas() == 2

    def test_down_cooldown(self, h):
        hx = h(replicas=3, idle_ticks=1, cooldown_down_s=10.0)
        hx.src.queue = 0.0
        assert hx.tick()["action"] == "down"
        d = hx.tick()
        assert d["action"] == "blocked" and "cooldown" in d["reason"]
        assert hx.replicas() == 2

    def test_prewarm_lead_shrinks_the_window(self, h):
        # prewarm estimate of 2 ticks against breach_ticks=3 means the
        # controller cannot afford to wait: it must act after 1 tick
        hx = h(breach_ticks=3, prewarm_lead_s=0.2)
        hx.src.queue = 20.0
        assert hx.tick()["action"] == "up"
        assert hx.replicas() == 3
        # and the estimate is refreshed by the measured add
        assert hx.asc.stats()["prewarm_estimate_s"] > 0

    def test_latency_slo_breach(self, h):
        hx = h(slo=SLOTargets(latency_p99_ms=100.0))
        hx.src.latency = 0.5                     # 500ms > 100ms target
        hx.tick()
        assert hx.tick()["action"] == "up"
        hx.src.latency = float("nan")            # no data = no breach
        assert hx.tick()["action"] == "hold"

    def test_decisions_and_metrics(self, h):
        hx = h()
        hx.src.queue = 20.0
        hx.tick()
        hx.tick()
        assert rm.SERVING_AUTOSCALE_DECISIONS.value(
            model="m", action="hold") == 1
        assert rm.SERVING_AUTOSCALE_DECISIONS.value(
            model="m", action="up") == 1
        assert rm.SERVING_AUTOSCALE_REPLICAS_TARGET.value(
            model="m") == 3
        last = hx.asc.last_decisions(2)
        assert [d["action"] for d in last] == ["hold", "up"]
        assert hx.asc.target() == 3
        st = hx.asc.stats()
        assert st["ticks"] == 2 and st["up"] == 1

    def test_publishes_pressure_to_admission(self, h):
        adm = AdmissionController(TIERS, shed_start=0.5)
        hx = h(admission=adm)
        hx.src.queue = 6.0                       # 75% of queue_high 8
        hx.tick()
        assert adm.pressure(now=hx.now) == pytest.approx(0.75)
        # free's threshold is 2/3 — the SLO sensors now shed it even
        # though the caller's own load reading is calm
        with pytest.raises(ServerOverloadedError):
            adm.check("a:free", load=0.0, now=hx.now)

    def test_chaos_prewarm_failure_keeps_loop_alive(self, h):
        # the chaos clause: a scale-up whose prewarm dies must
        # leave the controller alive, counted, and backing off
        hx = h(cooldown_up_s=0.5)
        hx.src.queue = 20.0
        with faults.plan("autoscale.decide=fail,times=1"):
            hx.tick()
            d = hx.tick()
            assert d["action"] == "error"
            assert "scale-up failed" in d["reason"]
            assert hx.replicas() == 2            # nothing half-added
            # the failure resets the streak AND stamps the up-cooldown:
            # the rebuilt streak meets a live cooldown, no hot-loop
            assert hx.tick()["action"] == "hold"
            assert hx.tick()["action"] == "blocked"
            for _ in range(6):                   # past the cooldown
                d = hx.tick()
                if d["action"] == "up":
                    break
            assert d["action"] == "up"           # recovered
            assert hx.replicas() == 3
        st = hx.asc.stats()
        assert st["error"] == 1 and st["up"] == 1
        assert rm.SERVING_AUTOSCALE_DECISIONS.value(
            model="m", action="error") == 1

    def test_victim_is_least_loaded_newest(self, h):
        hx = h(replicas=3, idle_ticks=1)
        hx.src.queue = 0.0
        d = hx.tick()
        assert d["action"] == "down"
        # all idle -> the newest rid (r2) drains first
        assert "r2" in d["reason"]
        assert sorted(hx.rset.replicas()) == ["r0", "r1"]

    def test_loop_thread_start_stop(self, h):
        hx = h(interval_s=0.01)
        hx.asc.clock = time.monotonic
        with hx.asc:
            deadline = time.monotonic() + 5.0
            while hx.asc.stats()["ticks"] == 0:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        assert hx.asc.stats()["ticks"] >= 1

    def test_debug_state_serializes(self, h):
        import json
        hx = h(admission=AdmissionController(TIERS))
        hx.src.queue = 20.0
        hx.tick()
        hx.tick()
        json.dumps(hx.asc.debug_state())


# ------------------------------------------------ parity with the JAX package
def _admission_script():
    """(op, args) steps: pressure publishes and checks with explicit
    loads, costs and clock stamps — quota refill, TTL decay and every
    tier's threshold are crossed."""
    rs = np.random.RandomState(3)
    tenants = ["a:free", "b:silver", "c:gold", "d", None, "e:free",
               "bob", "f:silver"]
    steps = [("register", ("bob", "free"))]
    now = 0.0
    for i in range(160):
        now += float(rs.choice([0.0, 0.01, 0.05, 0.3, 1.5]))
        if i % 17 == 0:
            steps.append(("pressure", (float(rs.uniform(0, 1)), now)))
        tenant = tenants[int(rs.randint(len(tenants)))]
        load = float(rs.choice([0.0, 0.0, 0.3, 0.7, 0.8, 0.9, 1.0]))
        cost = float(rs.choice([1.0, 1.0, 2.0]))
        steps.append(("check", (tenant, load, cost, now)))
    return steps


def _run_admission(adm, shed_type, steps):
    out = []
    for op, args in steps:
        if op == "register":
            adm.register_tenant(*args)
        elif op == "pressure":
            adm.update_pressure(args[0], now=args[1])
            out.append(("pressure", adm.pressure(now=args[1])))
        else:
            tenant, load, cost, now = args
            try:
                got = adm.check(tenant, model="m", load=load, cost=cost,
                                now=now)
                out.append(("admit",) + tuple(got))
            except shed_type as e:
                out.append(("shed", e.retry_after_ms, str(e)))
    st = adm.stats()
    return out, st


@pytest.mark.parametrize("spec,shed_start", [
    ("gold=100,silver=10/8/12,free=1/2/4", 0.5),
    ("gold=100,silver=10/50,free=1/5/8", 0.25),
    ("vip=9,basic=1/10", 0.75)])
def test_admission_decisions_match_the_jax_package(spec, shed_start):
    from mxnet_tpu.serving.admission import \
        AdmissionController as JaxAdmission
    from mxnet_tpu.serving.resilience import \
        ServerOverloadedError as JaxOverloaded
    steps = _admission_script()
    if "gold" not in spec:
        steps = [(op, (a[0].replace(":free", ":basic").replace(
                      ":silver", ":basic").replace(":gold", ":vip"),)
                  + a[1:]) if op == "check" and a[0] else (op, a)
                 for op, a in steps]
        steps = [(op, ("bob", "basic")) if op == "register" else (op, a)
                 for op, a in steps]
    mine, st = _run_admission(
        AdmissionController(spec, shed_start=shed_start,
                            retry_after_ms=50),
        ServerOverloadedError, steps)
    theirs, jst = _run_admission(
        JaxAdmission(spec, shed_start=shed_start, retry_after_ms=50),
        JaxOverloaded, steps)
    assert [o[0] for o in mine].count("shed") > 10
    assert [o[0] for o in mine].count("admit") > 10
    assert mine == theirs
    for key in ("admitted", "quota_sheds", "pressure_sheds", "by_tenant"):
        assert st[key] == jst[key]


class _ScriptedSource:
    """One scripted sample per tick — the same sequence fed to both
    packages' autoscalers."""

    def __init__(self, samples):
        self.samples = list(samples)
        self.i = 0

    def sample(self):
        s = self.samples[min(self.i, len(self.samples) - 1)]
        self.i += 1
        return dict(s)


def _sensor_script():
    nan = float("nan")
    quiet = {"queue_depth": 0.0, "ttft_p99_s": nan,
             "latency_p99_s": 0.01}
    hot = {"queue_depth": 20.0, "ttft_p99_s": 0.9,
           "latency_p99_s": 0.5}
    warm = {"queue_depth": 5.0, "ttft_p99_s": 0.1,
            "latency_p99_s": 0.06}
    blip = {"queue_depth": 9.0, "ttft_p99_s": None,
            "latency_p99_s": None}
    return ([quiet] * 3 + [blip, quiet] + [hot] * 9 + [warm] * 3
            + [quiet] * 14 + [hot] * 4 + [quiet] * 20)


def _decision_ring(srv_mod, faults_mod, adm_mod, asc_mod):
    import re
    repo = srv_mod.ModelRepository()
    repo.add_function("m", _fn, SIG)
    srv = srv_mod.ModelServer(repo, srv_mod.ServingConfig(
        max_batch_size=4, max_latency_us=1, replicas=2))
    clock = [0.0]
    try:
        adm = adm_mod.AdmissionController(TIERS, shed_start=0.5)
        asc = asc_mod.Autoscaler(
            srv.replica_set("m"),
            asc_mod.SLOTargets(ttft_p99_ms=500.0, latency_p99_ms=100.0,
                               queue_high=8),
            asc_mod.AutoscalerConfig(
                min_replicas=1, max_replicas=4, interval_s=1.0,
                breach_ticks=3, idle_ticks=4, cooldown_up_s=2.5,
                cooldown_down_s=3.5),
            source=_ScriptedSource(_sensor_script()), admission=adm,
            clock=lambda: clock[0])
        ring = []
        with faults_mod.plan("autoscale.decide=fail,after=1,times=1"):
            for _ in range(len(_sensor_script())):
                clock[0] += 1.0
                d = asc.tick()
                ring.append((d["action"], d["target"], d["replicas"],
                             d["healthy"], d["pressure"],
                             re.sub(r"prewarm [0-9.]+s", "prewarm Xs",
                                    d["reason"]),
                             adm.pressure(now=clock[0])))
        st = asc.stats()
        return ring, {k: st[k] for k in ("ticks", "up", "down", "hold",
                                         "blocked", "error", "target")}
    finally:
        srv.stop()


def test_autoscaler_decisions_match_the_jax_package():
    """The same scripted sensor sequence on a fake clock gives the same
    decision ring (action, target, replica counts, pressure, reason)
    tick for tick in both packages' autoscalers, over real ReplicaSets
    of function entries, through one injected ``autoscale.decide``
    failure."""
    from mxnet_tpu import faults as jfaults
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.serving import admission as jadm, autoscaler as jasc
    from mxnet_tpu_torch.serving import admission as tadm, \
        autoscaler as tasc
    mine, st = _decision_ring(serving, faults, tadm, tasc)
    theirs, jst = _decision_ring(jserving, jfaults, jadm, jasc)
    actions = [r[0] for r in mine]
    assert {"up", "down", "blocked", "error", "hold"} <= set(actions), \
        actions
    assert mine == theirs
    assert st == jst


ATOL = RTOL = 1e-5          # tests/test_torch_serving_predict.py's
SERVER_TIERS = "gold=100,silver=10/0.001/3,free=1/0.001/2"
BERT_KW = dict(vocab_size=64, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0)
L = 32
VOCAB = 13


def _tenant_script(n, seed):
    """(tenant, published pressure) per request: quotas of 3 (silver)
    and 2 (free) requests that barely refill, and pressures that cross
    free's (2/3) and silver's (5/6) shed thresholds."""
    rs = np.random.RandomState(seed)
    tenants = ["a:gold", "b:silver", "c:free", "d", None, "e:free"]
    return [(tenants[int(rs.randint(len(tenants)))],
             float(rs.choice([0.0, 0.0, 0.5, 0.7, 0.9])))
            for _ in range(n)]


def _serve_script(srv, call, script):
    """Serve one request per step, publishing its pressure first;
    ("shed", retry_after_ms > 0, reason kind) or ("ok", output)."""
    out = []
    for i, (tenant, pressure) in enumerate(script):
        srv.admission_controller().update_pressure(pressure)
        try:
            out.append(("ok", call(i, tenant)))
        except Exception as e:      # noqa: BLE001 — typed below
            assert type(e).__name__ == "ServerOverloadedError", e
            assert e.retry_after_ms > 0
            out.append(("shed", "quota" if "quota" in str(e)
                        else "pressure"))
    return out


def test_tenant_gated_bert_predict_matches_jax_model_server():
    """A 2-layer, 64-wide flash ``BERTClassifier`` (the JAX package's
    weights, carried by ``load_numpy_params``) served by both packages'
    ``ModelServer`` with ``tenant_tiers`` set and the same published
    pressure per request: the same requests shed, for the same reason,
    and the ok logits agree within 1e-5."""
    import mxnet_tpu as mx
    from mxnet_tpu import models as jm
    from mxnet_tpu import nd
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.models.bert import BERTClassifier as JaxClassifier
    from mxnet_tpu_torch.models import torch_bert as tm

    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", use_flash=True, **BERT_KW)
    jbert.initialize()
    jclf = JaxClassifier(jbert, num_classes=2, dropout=0.0)
    jclf.initialize()
    pre = jclf.prefix
    np_params = {(k[len(pre):] if k.startswith(pre) else k):
                 v.data().asnumpy()
                 for k, v in jclf.collect_params().items()}
    tbert = tm.get_bert_model("bert_12_768_12", use_flash=True,
                              device="cpu", **BERT_KW)
    tclf = tm.BERTClassifier(tbert, dropout=0.0).load_numpy_params(
        np_params)
    example = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
               np.full((1,), L, np.int32))
    script = _tenant_script(14, seed=3)
    rs = np.random.RandomState(2)
    reqs = []
    for _ in script:
        rows = int(rs.choice([1, 2]))
        reqs.append((rs.randint(0, 64, (rows, L)).astype(np.int32),
                     rs.randint(0, 2, (rows, L)).astype(np.int32),
                     rs.randint(1, L + 1, rows).astype(np.int32)))
    cfg = dict(max_batch_size=2, max_latency_us=1, num_workers=1,
               tenant_tiers=SERVER_TIERS, admission_shed_start=0.5)
    repo = serving.ModelRepository()
    repo.add_block("bert", tclf, *example)
    with serving.ModelServer(repo, serving.ServingConfig(**cfg)) as srv:
        got = _serve_script(srv, lambda i, t: srv.predict(
            "bert", *reqs[i], tenant=t, timeout=300), script)
        st = srv.stats()
    jrepo = jserving.ModelRepository()
    jrepo.add_block("bert", jclf, *(nd.array(a, dtype="int32")
                                    for a in example))
    with jserving.ModelServer(jrepo,
                              jserving.ServingConfig(**cfg)) as jsrv:
        want = _serve_script(jsrv, lambda i, t: jsrv.predict(
            "bert", *reqs[i], tenant=t, timeout=300), script)
        jst = jsrv.stats()
    assert [g[0] for g in got] == [w[0] for w in want]
    kinds = [g[1] for g in got if g[0] == "shed"]
    assert "quota" in kinds and "pressure" in kinds, kinds
    assert kinds == [w[1] for w in want if w[0] == "shed"]
    for g, w in zip(got, want):
        if g[0] == "ok":
            np.testing.assert_allclose(g[1], w[1], atol=ATOL, rtol=RTOL)
    assert st["tenant_sheds"] == jst["tenant_sheds"] == len(kinds)
    assert st["admission"]["by_tenant"] == jst["admission"]["by_tenant"]


def test_tenant_gated_generate_matches_jax_model_server():
    """A small ``TransformerDecoderLM`` (the JAX package's weights in the
    port's LM) generating through both packages' ``ModelServer`` with
    ``tenant_tiers`` set: the same requests shed and the same tokens."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.models import transformer_blocks as jtb
    from mxnet_tpu_torch.models.transformer_blocks import \
        TransformerDecoderLM

    mx.random.seed(7)
    jlm = jtb.TransformerDecoderLM(VOCAB, units=8, hidden_size=16,
                                   num_layers=2, num_heads=2, max_length=16)
    jlm.initialize(mx.init.Xavier())
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jtb.paged_lm_params(jlm))
    tlm = TransformerDecoderLM(
        VOCAB, units=8, hidden_size=16, num_layers=2, num_heads=2,
        max_length=16, device="cpu").load_numpy_params(np_params)
    cfg = dict(decode_page_size=4, decode_pool_pages=17,
               decode_max_batch=2, decode_max_new_tokens=5,
               tenant_tiers=SERVER_TIERS, admission_shed_start=0.5)
    script = _tenant_script(12, seed=4)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, VOCAB, int(rs.randint(2, 7))).tolist()
               for _ in script]

    def run(srv_mod, lm):
        repo = srv_mod.ModelRepository()
        repo.add_decoder("lm", lm)
        with srv_mod.ModelServer(repo,
                                 srv_mod.ServingConfig(**cfg)) as srv:
            out = _serve_script(srv, lambda i, t: np.asarray(srv.generate(
                "lm", prompts[i], max_new_tokens=5, tenant=t,
                timeout=120)).tolist(), script)
            return out, srv.stats()

    got, st = run(serving, tlm)
    want, jst = run(jserving, jlm)
    assert got == want
    assert any(g[0] == "shed" for g in got)
    assert sum(g[0] == "ok" for g in got) >= 4
    assert st["tenant_sheds"] == jst["tenant_sheds"]


# ------------------------------------------------- the port's own contract
def test_failed_scale_up_prewarm_is_an_error_decision_not_a_dead_replica():
    """A scale-up whose new replica fails its prewarm (on the card: a
    graph capture raising ``KernelError``): ``add_replica`` removes the
    replica again and raises, the autoscaler counts an ``error``
    decision with the up cooldown, and nothing is left in the set."""
    from mxnet_tpu_torch.base import KernelError
    broken = {"on": False}

    def fn(a):
        if broken["on"]:
            raise KernelError("capture failed (test)")
        return a * 2.0 + 1.0

    repo = serving.ModelRepository()
    repo.add_function("m", fn, SIG)
    srv = serving.ModelServer(repo, serving.ServingConfig(
        max_batch_size=4, max_latency_us=1, replicas=2))
    try:
        rset = srv.replica_set("m")
        src = _FakeSource(queue=20.0)
        clock = [0.0]
        asc = Autoscaler(rset, SLOTargets(queue_high=8), AutoscalerConfig(
            min_replicas=1, max_replicas=4, interval_s=0.1,
            breach_ticks=1, idle_ticks=3, cooldown_up_s=0.5,
            cooldown_down_s=0.0), source=src, clock=lambda: clock[0])
        broken["on"] = True
        clock[0] += 0.1
        d = asc.tick()
        assert d["action"] == "error"
        assert "capture failed" in d["reason"]
        assert sorted(rset.replicas()) == ["r0", "r1"]
        assert set(rset.replicas().values()) == {"healthy"}
        clock[0] += 0.1
        assert asc.tick()["action"] == "blocked"    # up cooldown
        broken["on"] = False
        clock[0] += 0.5
        assert asc.tick()["action"] == "up"
        assert len(rset.replicas()) == 3
        assert srv.predict("m", np.ones((1, 2), np.float32)).tolist() \
            == [[3.0, 3.0]]
    finally:
        srv.stop()


def test_scale_down_evicts_the_removed_replicas_programs():
    """``remove_replica`` drops the drained replica's bucket programs
    (on the card its CUDA graphs and their pools) and joins its
    heartbeat thread."""
    srv = _server(replicas=3)
    try:
        rset = srv.replica_set("m")
        rep = rset.replica("r2")
        assert rep.batcher.program_list(rset.entry)
        rset.remove_replica("r2", timeout=5.0)
        assert rep.batcher.program_list(rset.entry) == []
        assert not rep.beat_thread.is_alive()
        assert sorted(rset.replicas()) == ["r0", "r1"]
    finally:
        srv.stop()
