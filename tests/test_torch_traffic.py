"""PyTorch port, traffic plane part 1: the workload simulator — twins of
the JAX package's tests/test_traffic.py, case for case.

Trace generation must be seed-deterministic (same config -> byte-equal
JSONL), record/replay must round-trip bit-exactly, and the replay
harness must uphold its zero-hung-requests contract and map server
outcomes onto the typed status taxonomy.  Everything here runs without
a server or any device work — ``replay_trace`` is driven with plain
callables.

Then parity with the JAX package: for several seeds and each arrival
process a port trace is byte-identical to the JAX trace of the same
``TraceConfig``, a JAX-saved trace loads in the port and saves back
byte for byte, payloads and prompts are equal, and the deterministic
replay twin scores identically in both packages.
"""
import os
import threading
import time

import numpy as np
import pytest

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import traffic
from mxnet_tpu_torch.serving.resilience import (DeadlineExceededError,
                                                ServerOverloadedError)
from mxnet_tpu_torch.serving.traffic import (Trace, TraceConfig,
                                             TraceRequest, exponential_gap,
                                             generate_trace, predict_payload,
                                             prompt_tokens, replay_trace,
                                             summarize)


# ------------------------------------------------------------ generation
class TestGeneration:
    def test_deterministic_by_seed(self):
        cfg = dict(seed=11, duration_s=4.0, base_rate=25.0)
        a = generate_trace(TraceConfig(**cfg))
        b = generate_trace(TraceConfig(**cfg))
        assert a.to_jsonl() == b.to_jsonl()
        c = generate_trace(TraceConfig(seed=12, duration_s=4.0,
                                       base_rate=25.0))
        assert a.to_jsonl() != c.to_jsonl()

    def test_timeline_sorted_and_bounded(self):
        tr = generate_trace(TraceConfig(seed=2, duration_s=3.0))
        ts = [r.t for r in tr.requests]
        assert ts == sorted(ts)
        assert all(0.0 <= t < 3.0 + 1e-9 for t in ts)
        assert len(tr) == len(tr.requests) > 0

    def test_rate_roughly_honored(self):
        tr = generate_trace(TraceConfig(seed=3, duration_s=10.0,
                                        base_rate=40.0,
                                        diurnal_amplitude=0.0))
        # Poisson(400) — a 4-sigma band is ±80
        assert 300 <= len(tr) <= 500

    def test_burst_window_is_hotter(self):
        tr = generate_trace(TraceConfig(
            seed=4, duration_s=8.0, base_rate=20.0, burst_at=0.5,
            burst_x=10.0, burst_duration_s=2.0, diurnal_amplitude=0.0))
        burst = sum(1 for r in tr.requests if 4.0 <= r.t < 6.0)
        before = sum(1 for r in tr.requests if 0.0 <= r.t < 4.0)
        # 10x the rate over half the baseline span -> ~5x the count
        assert burst > 2 * before

    def test_tenant_skew_and_tiers(self):
        cfg = TraceConfig(seed=5, duration_s=10.0, base_rate=50.0,
                          tenants=8, tenant_skew=1.5)
        tr = generate_trace(cfg)
        counts = {}
        for r in tr.requests:
            counts[r.tenant] = counts.get(r.tenant, 0) + 1
            assert r.tier in cfg.tiers
        top = max(counts.values())
        # zipf(1.5) over 8 tenants concentrates far beyond uniform
        assert top > 2 * (len(tr) / 8)

    def test_mixed_ops_and_lengths(self):
        tr = generate_trace(TraceConfig(seed=6, duration_s=10.0,
                                        base_rate=40.0,
                                        generate_fraction=0.5))
        ops = {r.op for r in tr.requests}
        assert ops == {"predict", "generate"}
        for r in tr.requests:
            if r.op == "predict":
                assert 1 <= r.rows
            else:
                assert r.prompt_len >= 1 and r.max_new_tokens >= 1

    def test_prefix_clusters_mark_generate_rows(self):
        cfg = TraceConfig(seed=7, duration_s=10.0, base_rate=40.0,
                          generate_fraction=1.0, prefix_clusters=3,
                          prefix_share=0.6)
        tr = generate_trace(cfg)
        gen = [r for r in tr.requests if r.op == "generate"]
        clustered = [r for r in gen if r.prefix_group is not None]
        assert gen and 0.3 <= len(clustered) / len(gen) <= 0.9
        assert {r.prefix_group for r in clustered} \
            <= set(range(cfg.prefix_clusters))

    def test_shared_prefix_tokens_actually_shared(self):
        a = TraceRequest(0.0, "t0", "gold", "m", "generate",
                         prompt_len=32, max_new_tokens=4,
                         prefix_group=1, seed=10)
        b = TraceRequest(1.0, "t1", "free", "m", "generate",
                         prompt_len=40, max_new_tokens=4,
                         prefix_group=1, seed=11)
        c = TraceRequest(2.0, "t2", "free", "m", "generate",
                         prompt_len=40, max_new_tokens=4,
                         prefix_group=2, seed=12)
        ta, tb, tc = (prompt_tokens(r, prefix_len=16) for r in (a, b, c))
        assert ta[:16] == tb[:16]        # same cluster, same prefix
        assert ta[:16] != tc[:16]        # different cluster differs
        assert ta[16:] != tb[16:]        # suffixes are per-request

    def test_payload_deterministic(self):
        r = TraceRequest(0.0, "t", "gold", "m", "predict", rows=3,
                         seed=99)
        x, y = predict_payload(r), predict_payload(r)
        assert x.shape == (3, 2) and x.dtype == np.float32
        np.testing.assert_array_equal(x, y)

    def test_heavy_tail_processes(self):
        for proc in ("poisson", "lognormal", "pareto"):
            tr = generate_trace(TraceConfig(seed=8, duration_s=5.0,
                                            base_rate=30.0,
                                            process=proc))
            assert len(tr) > 10, proc
        with pytest.raises(MXNetError):
            TraceConfig(process="weibull")

    def test_env_seed_and_rate(self, monkeypatch):
        monkeypatch.setenv("MXNET_SERVING_TRACE_SEED", "77")
        monkeypatch.setenv("MXNET_SERVING_TRACE_RATE", "12.5")
        cfg = TraceConfig()
        assert cfg.seed == 77 and cfg.base_rate == 12.5


# -------------------------------------------------------------- arrivals
class TestExponentialGap:
    def test_is_the_one_poisson_primitive(self):
        # the one Poisson primitive: the same rng call as a bare
        # exponential draw, so a seeded schedule is the same everywhere
        r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
        a = [float(r1.exponential(1.0 / 25.0)) for _ in range(64)]
        b = [exponential_gap(r2, 25.0) for _ in range(64)]
        assert a == b

    def test_positive_and_mean(self):
        rng = np.random.RandomState(123)
        gaps = [exponential_gap(rng, 50.0) for _ in range(4000)]
        assert min(gaps) > 0
        assert abs(np.mean(gaps) - 1.0 / 50.0) < 0.002


# ------------------------------------------------------------ record/replay
class TestRoundTrip:
    def test_save_load_bit_exact(self, tmp_path):
        tr = generate_trace(TraceConfig(seed=21, duration_s=5.0))
        p = os.path.join(str(tmp_path), "trace.jsonl")
        tr.save(p)
        back = Trace.load(p)
        assert back == tr
        assert back.to_jsonl() == tr.to_jsonl()
        # and a second save of the loaded trace is byte-identical
        p2 = os.path.join(str(tmp_path), "again.jsonl")
        back.save(p2)
        with open(p, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read()

    def test_header_carries_config(self):
        cfg = TraceConfig(seed=5, duration_s=2.0, base_rate=9.0,
                          burst_x=3.0)
        tr = generate_trace(cfg)
        assert tr.header["seed"] == 5
        assert tr.header["base_rate"] == 9.0
        assert tr.header["burst_x"] == 3.0

    def test_load_rejects_garbage(self, tmp_path):
        p = os.path.join(str(tmp_path), "bad.jsonl")
        with open(p, "w") as f:
            f.write('{"kind": "not-a-header"}\n')
        with pytest.raises(MXNetError):
            Trace.load(p)


class TestReplay:
    def _trace(self, n=12, gap=0.01):
        reqs = [TraceRequest(i * gap, f"t{i % 3}",
                             ("gold", "silver", "free")[i % 3], "m",
                             "predict", rows=1, seed=i)
                for i in range(n)]
        return Trace({"duration_s": n * gap}, reqs)

    def test_all_ok_and_ordered(self):
        tr = self._trace()
        calls = []
        lock = threading.Lock()

        def call(req):
            with lock:
                calls.append(req.tenant)
            return {"echo": req.seed}

        recs, wall = replay_trace(tr, call, clients=3, speed=4.0,
                                  timeout_s=5.0)
        assert len(recs) == len(tr)
        assert all(r["status"] == "ok" for r in recs)
        assert [r["index"] for r in recs] == list(range(len(tr)))
        assert recs[0]["echo"] == 0      # call() extras merge in
        assert len(calls) == len(tr)
        assert wall > 0

    def test_statuses_are_typed(self):
        tr = self._trace(n=3, gap=0.0)

        def call(req):
            if req.seed == 0:
                raise ServerOverloadedError("m", 1, "full")
            if req.seed == 1:
                raise DeadlineExceededError("op", 0.1, "q")
            raise MXNetError("boom")

        recs, _ = replay_trace(tr, call, clients=1, speed=100.0,
                               attempts=2, timeout_s=2.0)
        assert [r["status"] for r in recs] == ["shed", "deadline",
                                               "error"]
        assert recs[0]["error"] == "ServerOverloadedError"

    def test_retry_after_is_honored(self):
        tr = self._trace(n=1)
        state = {"n": 0}

        def call(req):
            state["n"] += 1
            if state["n"] < 3:
                raise ServerOverloadedError("m", 1, "warming")
            return None

        recs, _ = replay_trace(tr, call, clients=1, speed=100.0,
                               attempts=4, timeout_s=5.0)
        assert recs[0]["status"] == "ok"
        assert state["n"] == 3           # two sheds, then success

    def test_speed_compresses_wall_time(self):
        tr = self._trace(n=10, gap=0.05)    # 0.5s of timeline
        t0 = time.monotonic()
        replay_trace(tr, lambda r: None, clients=2, speed=10.0,
                     timeout_s=5.0)
        assert time.monotonic() - t0 < 0.45

    def test_rejects_bad_speed(self):
        with pytest.raises(MXNetError):
            replay_trace(self._trace(1), lambda r: None, speed=0.0)


# -------------------------------------------------------------- summarize
class TestSummarize:
    def _rec(self, status="ok", tier="gold", latency=0.01, ttft=None):
        r = {"status": status, "tier": tier, "latency_s": latency}
        if ttft is not None:
            r["ttft_s"] = ttft
        return r

    def test_sheds_count_against_attainment(self):
        recs = [self._rec() for _ in range(8)] \
            + [self._rec(status="shed", tier="free") for _ in range(2)]
        s = summarize(recs, wall_s=2.0, latency_slo_s=0.1)
        assert s["requests"] == 10 and s["ok"] == 8 and s["shed"] == 2
        assert s["attainment"] == pytest.approx(0.8)
        assert s["goodput_rps"] == pytest.approx(4.0)
        assert s["by_tier"]["free"]["shed"] == 2

    def test_slo_miss_is_not_goodput(self):
        recs = [self._rec(latency=0.01), self._rec(latency=5.0)]
        s = summarize(recs, wall_s=1.0, latency_slo_s=0.1)
        assert s["ok"] == 2 and s["slo_ok"] == 1

    def test_ttft_target_applies_to_generate(self):
        recs = [self._rec(ttft=0.01), self._rec(ttft=2.0)]
        s = summarize(recs, wall_s=1.0, ttft_slo_s=0.1)
        assert s["slo_ok"] == 1
        assert s["ttft_p50_s"] > 0

    def test_smoke_against_generated_trace(self):
        # the whole loop: generate -> replay (trivial server) -> score
        tr = generate_trace(TraceConfig(seed=31, duration_s=1.0,
                                        base_rate=30.0))
        recs, wall = replay_trace(tr, lambda r: None, clients=4,
                                  speed=20.0, timeout_s=5.0)
        s = summarize(recs, wall_s=wall, latency_slo_s=1.0)
        assert s["attainment"] == pytest.approx(1.0)
        assert set(s["by_tier"]) <= {"gold", "silver", "free"}


# ------------------------------------------------- replay determinism
class TestReplayDeterminism:
    """The reference bench's burst trace replayed twice against
    identical deterministic twins must score byte-identically — the
    regression that keeps ambient entropy out of the
    generate -> replay -> summarize chain."""

    def _bench_r07_config(self):
        # the reference bench's burst shape at 1/6 duration, so the
        # test stays inside the tier-1 budget
        duration = 1.0
        return TraceConfig(
            seed=0, duration_s=duration, base_rate=14.0,
            process="lognormal", models=("lm",), generate_fraction=1.0,
            tenants=6, burst_at=0.45, burst_x=10.0,
            burst_duration_s=duration * 0.25, prompt_max=16,
            output_max=10, output_mean=5.0)

    @staticmethod
    def _twin_call(req):
        # a deterministic server twin: outcome and every measured field
        # are pure functions of the request, overriding the wall-clock
        # measurements via the rec.update(info) contract
        lat = 0.001 + (req.prompt_len + req.max_new_tokens) * 1e-4
        return {"latency_s": lat, "ttft_s": lat * 0.25,
                "start_s": req.t}

    def _replay_summary(self, trace):
        import json
        recs, _ = replay_trace(trace, self._twin_call, clients=6,
                               speed=50.0, timeout_s=10.0)
        s = summarize(recs, wall_s=trace.duration_s,
                      latency_slo_s=0.05, ttft_slo_s=0.02)
        return json.dumps(s, sort_keys=True)

    def test_bench_r07_replay_is_byte_identical(self):
        cfg = self._bench_r07_config()
        tr_a = generate_trace(cfg)
        tr_b = generate_trace(cfg)
        assert tr_a.to_jsonl() == tr_b.to_jsonl()
        assert self._replay_summary(tr_a) == self._replay_summary(tr_b)


# ------------------------------------------------ parity with the JAX package
@pytest.mark.parametrize("process", ["poisson", "lognormal", "pareto"])
@pytest.mark.parametrize("seed", [0, 1, 17, 2024])
def test_trace_bytes_match_the_jax_package(seed, process):
    """Same TraceConfig -> the same JSONL bytes in both packages: every
    RandomState draw is taken in the reference's order."""
    from mxnet_tpu.serving import traffic as jtraffic
    kw = dict(seed=seed, duration_s=3.0, base_rate=30.0, process=process,
              tenants=6, models=("bert", "gpt2"), burst_x=10.0,
              burst_at=0.45, burst_duration_s=1.0, prompt_max=64,
              output_max=16)
    mine = generate_trace(TraceConfig(**kw)).to_jsonl()
    theirs = jtraffic.generate_trace(jtraffic.TraceConfig(**kw)).to_jsonl()
    assert len(mine) > 200
    assert mine == theirs


def test_chip_trace_config_matches_the_jax_package():
    """The trace chip_smoke.py's traffic phase replays, at its full 8 s:
    byte-identical across packages, payloads and prompts equal, and
    clusters whose later prompts share at least one full KV page (16
    tokens) with an earlier one, so the prefix cache hits."""
    import sys
    from mxnet_tpu.serving import traffic as jtraffic
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    kw = dict(chip_smoke.TRAFFIC_TRACE)
    tr = generate_trace(TraceConfig(**kw))
    seen = {}
    shared = 0
    for req in tr.requests:
        if req.op == "generate" and req.prefix_group is not None:
            toks = prompt_tokens(req, vocab=50257,
                                 prefix_len=kw["prefix_len"])
            prev = seen.setdefault(req.prefix_group, toks)
            shared += prev is not toks and prev[:16] == toks[:16] \
                and len(prev) > 16 and len(toks) > 16
    assert shared >= 4
    jtr = jtraffic.generate_trace(jtraffic.TraceConfig(**kw))
    assert tr.to_jsonl() == jtr.to_jsonl()
    for req, jreq in zip(tr.requests, jtr.requests):
        if req.op == "predict":
            np.testing.assert_array_equal(
                predict_payload(req, features=5),
                jtraffic.predict_payload(jreq, features=5))
        else:
            assert prompt_tokens(req, vocab=50257,
                                 prefix_len=kw["prefix_len"]) \
                == jtraffic.prompt_tokens(jreq, vocab=50257,
                                          prefix_len=kw["prefix_len"])


def test_jax_saved_trace_loads_and_saves_back_byte_for_byte(tmp_path):
    from mxnet_tpu.serving import traffic as jtraffic
    jtr = jtraffic.generate_trace(jtraffic.TraceConfig(
        seed=5, duration_s=4.0, base_rate=25.0, burst_x=4.0))
    p = os.path.join(str(tmp_path), "jax.jsonl")
    jtr.save(p)
    back = Trace.load(p)
    assert len(back) == len(jtr) > 0
    p2 = os.path.join(str(tmp_path), "port.jsonl")
    back.save(p2)
    with open(p, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    # and the other way round: the JAX package loads the port's file
    assert jtraffic.Trace.load(p2).to_jsonl() == back.to_jsonl()


def test_replay_scores_match_the_jax_package():
    """The deterministic replay twin scores byte-identically in both
    packages (same trace, same summary JSON)."""
    import json

    from mxnet_tpu.serving import traffic as jtraffic
    cfg = TestReplayDeterminism()._bench_r07_config()
    call = TestReplayDeterminism._twin_call

    def score(mod, tr):
        recs, _ = mod.replay_trace(tr, call, clients=6, speed=50.0,
                                   timeout_s=10.0)
        return json.dumps(mod.summarize(recs, wall_s=tr.duration_s,
                                        latency_slo_s=0.05,
                                        ttft_slo_s=0.02), sort_keys=True)

    jcfg = jtraffic.TraceConfig(**{
        k: v for k, v in cfg.header().items()
        if k not in ("kind", "version")})
    assert score(traffic, generate_trace(cfg)) \
        == score(jtraffic, jtraffic.generate_trace(jcfg))
