"""PyTorch port, the predict path's resilience layer: twins of the JAX
package's chaos tests (tests/test_faults.py — ``TestCircuitBreaker``,
``TestPredictResilience``, ``TestBuildWaitDeadline``,
``TestHonorRetryAfter`` and ``test_server_records_decode_outcomes_on_
breaker``) on the port's ``CircuitBreaker``, ``honor_retry_after``,
``DynamicBatcher`` and ``ModelServer``.

Everything runs on function entries and a numpy fake decode model,
with seeded fault plans on the port's declared sites
(``serving.execute``, ``serving.compile``, ``decode.prefill``): the
deadline, retry, bisection and breaker machinery is tested without a
model or a card.  The corrupt-artifact test waits for the port's
artifact path (ROADMAP item 3a′).
"""
import threading
import time

import numpy as np
import pytest

from mxnet_tpu_torch import faults, runtime_metrics as rm, serving, tracing
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import resilience
from mxnet_tpu_torch.serving.resilience import (CircuitBreaker,
                                                CircuitOpenError, Deadline,
                                                DeadlineExceededError)


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


def _cfg(**kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_latency_us", 1)
    kw.setdefault("retry_backoff_ms", 0)    # fast tests, same policy
    return serving.ServingConfig(**kw)


def _decode_cfg(**kw):
    kw.setdefault("decode_page_size", 4)
    kw.setdefault("decode_pool_pages", 9)   # 8 usable
    kw.setdefault("decode_max_batch", 2)
    kw.setdefault("decode_max_new_tokens", 4)
    kw.setdefault("retry_backoff_ms", 0)
    return serving.ServingConfig(**kw)


class FakeModel:
    """Decode-model protocol in plain numpy: next token = (last + 1)
    mod vocab; prefill proposes the prompt's last token."""

    vocab_size = 16
    max_context = 32

    def prefill(self, tokens, length, block_table):
        logits = np.zeros((self.vocab_size,), np.float32)
        logits[int(tokens[0, int(length) - 1]) % self.vocab_size] = 1.0
        return logits

    def decode_step(self, tokens, positions, block_tables):
        logits = np.zeros((tokens.shape[0], self.vocab_size), np.float32)
        logits[np.arange(tokens.shape[0]),
               (tokens + 1) % self.vocab_size] = 1.0
        return logits


class TestCircuitBreaker:
    def test_open_probe_close_lifecycle(self):
        br = CircuitBreaker(4, 0.5, 40, model="m", version=1)
        for ok in (True, False, False, True):   # 50% errors, window full
            br.record(ok)
        assert br.state == resilience.OPEN
        with pytest.raises(CircuitOpenError) as ei:
            br.admit()
        assert ei.value.retry_after_ms <= 40
        time.sleep(0.05)
        assert br.admit() is True           # the half-open probe
        with pytest.raises(CircuitOpenError):
            br.admit()                      # one probe at a time
        br.record(True)
        assert br.state == resilience.CLOSED
        assert br.admit() is False          # closed admits freely
        st = br.debug_state()
        assert st["stats"]["opened"] == 1 and st["stats"]["closed"] == 1

    def test_failed_probe_reopens(self):
        br = CircuitBreaker(2, 0.5, 10, model="m", version=1)
        br.record(False)
        br.record(False)
        assert br.state == resilience.OPEN
        time.sleep(0.02)
        assert br.admit() is True
        br.record(False)                    # probe fails
        assert br.state == resilience.OPEN

    def test_abandoned_probe_self_heals(self):
        br = CircuitBreaker(2, 0.5, 20, model="m", version=1)
        br.record(False)
        br.record(False)
        time.sleep(0.03)
        assert br.admit() is True           # probe admitted...
        with pytest.raises(CircuitOpenError):
            br.admit()                      # ...one probe at a time
        time.sleep(0.03)                    # a cooldown later: abandoned
        assert br.admit() is True           # takeover probe
        br.record(True)
        assert br.state == resilience.CLOSED

    def test_partial_window_cannot_trip(self):
        br = CircuitBreaker(8, 0.5, 10, model="m", version=1)
        for _ in range(7):
            br.record(False)                # 100% errors, window NOT full
        assert br.state == resilience.CLOSED

    def test_window_zero_disables(self):
        br = CircuitBreaker(0, 0.5, 10, model="m", version=1)
        for _ in range(16):
            br.record(False)
        assert br.admit() is False
        assert br.state == resilience.CLOSED

    def test_state_gauge_published(self):
        br = CircuitBreaker(2, 0.5, 10, model="gm", version=3)
        br.record(False)
        br.record(False)
        assert rm.SERVING_CIRCUIT_STATE.value(
            model="gm", version="3") == 2.0

    def test_consecutive_failures_trip_before_the_window_fills(self):
        br = CircuitBreaker(20, 0.5, 10, model="m", version=1,
                            consecutive=3)
        br.record(False)
        br.record(True)                     # a success resets the run
        br.record(False)
        br.record(False)
        assert br.state == resilience.CLOSED
        br.record(False)
        assert br.state == resilience.OPEN


class TestPredictResilience:
    def _server(self, fn, name="m", **cfg_kw):
        repo = serving.ModelRepository()
        repo.add_function(name, fn, SIG)
        return serving.ModelServer(repo, _cfg(**cfg_kw))

    def test_retry_then_success_parity(self):
        x = np.arange(6, dtype=np.float32).reshape(3, 2)
        with self._server(lambda a: a * 3.0) as srv:
            want = srv.predict("m", x, timeout=60)      # fault-free
            with faults.plan("serving.execute=fail,times=1"):
                got = srv.predict("m", x, timeout=60)
            np.testing.assert_array_equal(got, want)
            st = srv.stats()
        assert st["retries"] == 1 and st["errors"] == 0
        assert rm.SERVING_RETRIES.value(model="m") == 1
        assert rm.SERVING_FAULTS.value(site="serving.execute",
                                       mode="fail") == 1

    def test_retries_exhausted_fail_typed(self):
        with self._server(lambda a: a) as srv:
            with faults.plan("serving.execute=fail"):
                with pytest.raises(faults.InjectedFault):
                    srv.predict("m", np.ones((1, 2), np.float32),
                                timeout=60)
            st = srv.stats()
        assert st["errors"] == 1
        assert st["retries"] == srv.config.retry_max

    def test_transient_build_fault_is_retried(self):
        """A ``serving.compile`` fault fails the bucket build typed and
        transient: the retry policy builds again and serves."""
        x = np.ones((2, 2), np.float32)
        with self._server(lambda a: a + 1.0) as srv:
            with faults.plan("serving.compile=fail,times=1"):
                np.testing.assert_array_equal(
                    srv.predict("m", x, timeout=60), x + 1.0)
            st = srv.stats()
        assert st["retries"] == 1 and st["bucket_misses"] == 1
        assert rm.SERVING_FAULTS.value(site="serving.compile",
                                       mode="fail") == 1

    def test_bisection_isolates_poisoned_request(self):
        def picky(a):
            if np.isnan(a).any():
                raise ValueError("poisoned row")
            return a + 1.0

        repo = serving.ModelRepository()
        repo.add_function("m", picky, SIG)
        srv = serving.ModelServer(repo, _cfg(), autostart=False)
        entry = repo.get("m")
        good = [np.full((1, 2), float(i), np.float32) for i in range(3)]
        poison = np.full((1, 2), np.nan, np.float32)
        reqs = [serving.server._Request(entry, (g,), 1) for g in good]
        bad_req = serving.server._Request(entry, (poison,), 1)
        ok, bad = srv._dispatch_group(entry,
                                      reqs[:1] + [bad_req] + reqs[1:])
        assert [r is bad_req for r, _e in bad] == [True]
        assert isinstance(bad[0][1], ValueError)
        assert set(ok) == set(reqs)
        for r, g in zip(reqs, good):
            np.testing.assert_array_equal(r.result[0], g + 1.0)
        assert srv.stats()["bisected"] >= 1

    def test_deadline_bounds_queue_wait(self):
        gate = threading.Event()
        entered = threading.Event()

        def gated(a):
            entered.set()
            assert gate.wait(30)
            return a

        srv = self._server(gated, num_workers=1)
        t = threading.Thread(
            target=lambda: srv.predict(
                "m", np.ones((1, 2), np.float32), timeout=30))
        try:
            t.start()
            assert entered.wait(30)         # worker held inside batch 1
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceededError,
                               match="no result within"):
                srv.predict("m", np.ones((1, 2), np.float32),
                            timeout=0.1)
            assert time.monotonic() - t0 < 5
            assert srv.stats()["queue_depth"] == 0
            assert srv.stats()["deadline_exceeded"] == 1
            assert rm.SERVING_DEADLINE_EXCEEDED.value(model="m") == 1
        finally:
            gate.set()
            t.join(30)
            srv.stop()

    def test_expired_request_never_dispatched(self):
        calls = []
        gate = threading.Event()
        entered = threading.Event()

        def gated(a):
            calls.append(a.shape)
            entered.set()
            assert gate.wait(30)
            return a

        srv = self._server(gated, num_workers=1)
        results = []

        def hold():
            results.append(srv.predict(
                "m", np.ones((1, 2), np.float32), timeout=30))

        def doomed():
            try:
                srv.predict("m", np.ones((1, 2), np.float32),
                            timeout=0.05)
            except MXNetError as e:
                results.append(e)

        try:
            t1 = threading.Thread(target=hold)
            t1.start()
            assert entered.wait(30)
            t2 = threading.Thread(target=doomed)
            t2.start()
            t2.join(30)                     # fails via its own wait
            time.sleep(0.05)
            gate.set()                      # worker pops: must skip it
            t1.join(30)
            srv.stop()
        finally:
            gate.set()
        assert len(calls) == 1
        assert sum(isinstance(r, DeadlineExceededError)
                   for r in results) == 1

    def test_circuit_opens_sheds_probes_and_recovers(self):
        state = {"fail": True, "calls": 0}

        def flappy(a):
            state["calls"] += 1
            if state["fail"]:
                raise ValueError("version is sick")
            return a * 2.0

        srv = self._server(flappy, circuit_window=4,
                           circuit_threshold=0.5, circuit_cooldown_ms=80)
        x = np.ones((1, 2), np.float32)
        try:
            for _ in range(4):              # fill the window with errors
                with pytest.raises(ValueError):
                    srv.predict("m", x, timeout=30)
            calls_before = state["calls"]
            with pytest.raises(CircuitOpenError, match="circuit open"):
                srv.predict("m", x, timeout=30)
            assert state["calls"] == calls_before
            assert srv.stats()["circuit_open_rejects"] == 1
            dbg = srv.debug_state()
            assert [c["state"] for c in dbg["circuits"].values()] \
                == ["open"]
            state["fail"] = False
            time.sleep(0.1)
            np.testing.assert_array_equal(
                srv.predict("m", x, timeout=30), x * 2.0)
            np.testing.assert_array_equal(
                srv.predict("m", x, timeout=30), x * 2.0)
            dbg = srv.debug_state()
            assert [c["state"] for c in dbg["circuits"].values()] \
                == ["closed"]
        finally:
            srv.stop()

    def test_unloaded_version_breaker_not_resurrected(self):
        repo = serving.ModelRepository()
        repo.add_function("m", lambda a: a, SIG)
        with serving.ModelServer(repo, _cfg()) as srv:
            entry = repo.get("m")
            assert srv._breaker(entry) is srv._breakers[entry.uid]
            repo.unload("m")                # fires _on_unload
            assert entry.uid not in srv._breakers
            late = srv._breaker(entry)      # in-flight straggler path
            late.record(True)
            assert entry.uid not in srv._breakers

    def test_circuit_shed_tags_admit_span(self):
        tracing.enable(sample=1.0)
        try:
            srv = self._server(lambda a: a, circuit_window=2,
                               circuit_threshold=0.5,
                               circuit_cooldown_ms=60_000)
            x = np.ones((1, 2), np.float32)
            try:
                with faults.plan("serving.execute=fail"):
                    for _ in range(2):
                        with pytest.raises(faults.InjectedFault):
                            srv.predict("m", x, timeout=30)
                with pytest.raises(CircuitOpenError):
                    srv.predict("m", x, timeout=30)
            finally:
                srv.stop()
            t = tracing.TRACER.last(root="serving.predict")
            admits = [s for s in t["spans"]
                      if s["name"] == "serving.admit"]
            assert admits and "circuit open" in str(
                admits[0]["tags"].get("shed")), admits
        finally:
            tracing.disable()
            tracing.TRACER.reset()

    def test_chaos_plan_spec_in_incident_dump(self, tmp_path):
        import json
        tracing.enable(sample=1.0)
        try:
            with faults.plan("serving.execute=fail,times=1"):
                with pytest.raises(faults.InjectedFault):
                    faults.inject("serving.execute")
                path = tracing.record_incident(
                    "test.chaos", {"k": "v"},
                    path=str(tmp_path / "dump.json"), min_interval=0)
                with open(path) as fh:
                    rec = json.load(fh)
                assert rec["faults"]["spec"] == \
                    "serving.execute=fail,times=1"
                assert rec["faults"]["fired"] == \
                    {"serving.execute:fail": 1}
        finally:
            tracing.disable()
            tracing.TRACER.reset()


class TestBuildWaitDeadline:
    """The bucket-program build wait in DynamicBatcher.program_for drains
    the request Deadline: a wedged builder (the ``serving.compile`` stall
    shape) fails its waiters typed instead of hanging them."""

    def _blocked_entry(self):
        repo = serving.ModelRepository()
        repo.add_function("m", lambda a: a, SIG)
        entry = repo.get("m")
        in_build, release = threading.Event(), threading.Event()
        real = entry.make_program

        def blocking_make_program(rows):
            in_build.set()
            assert release.wait(30)
            return real(rows)
        entry.make_program = blocking_make_program
        return repo, entry, in_build, release

    def test_program_build_wait_honors_deadline(self):
        _repo, entry, in_build, release = self._blocked_entry()
        batcher = serving.DynamicBatcher(_cfg())
        builder = threading.Thread(
            target=lambda: batcher.program_for(entry, 1))
        builder.start()
        try:
            assert in_build.wait(10)
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceededError,
                               match="bucket build"):
                batcher.program_for(entry, 1,
                                    deadline=Deadline.start(0.2))
            assert time.monotonic() - t0 < 5
        finally:
            release.set()
            builder.join(30)
        assert batcher.program_for(entry, 1) is not None

    def test_stalled_build_fault_fails_waiters_typed(self):
        """The chaos shape itself: a ``serving.compile=stall`` plan
        wedges the builder; a waiter with a deadline fails typed."""
        repo = serving.ModelRepository()
        repo.add_function("m", lambda a: a, SIG)
        entry = repo.get("m")
        batcher = serving.DynamicBatcher(_cfg())
        with faults.plan("serving.compile=stall,ms=400,times=1"):
            builder = threading.Thread(
                target=lambda: batcher.program_for(entry, 1))
            builder.start()
            try:
                t0 = time.monotonic()
                while not batcher._building and \
                        time.monotonic() - t0 < 10:
                    time.sleep(0.005)
                with pytest.raises(DeadlineExceededError,
                                   match="bucket build"):
                    batcher.program_for(entry, 1,
                                        deadline=Deadline.start(0.1))
            finally:
                builder.join(30)
        assert batcher.programs(entry) == 1

    def test_build_wait_deadline_skips_breaker(self):
        repo, _entry, in_build, release = self._blocked_entry()
        x = np.zeros((1, 2), dtype=np.float32)
        with serving.ModelServer(repo, _cfg(
                num_workers=2, circuit_window=1,
                circuit_threshold=1.0)) as srv:
            done = []
            first = threading.Thread(
                target=lambda: done.append(
                    srv.predict("m", x, timeout=60)))
            first.start()
            try:
                assert in_build.wait(10)
                with pytest.raises(DeadlineExceededError):
                    srv.predict("m", x, timeout=0.3)
                t0 = time.monotonic()
                while time.monotonic() - t0 < 10 and \
                        rm.SERVING_DEADLINE_EXCEEDED.value(
                            model="m") < 1:
                    time.sleep(0.01)
                assert rm.SERVING_DEADLINE_EXCEEDED.value(
                    model="m") >= 1
            finally:
                release.set()
                first.join(30)
            assert len(done) == 1
            assert srv.stats()["deadline_exceeded"] >= 1
            np.testing.assert_array_equal(
                srv.predict("m", x, timeout=60), x)

    def test_group_deadline_expiry_is_not_bisection(self):
        repo, entry, in_build, release = self._blocked_entry()
        srv = serving.ModelServer(repo, _cfg(), autostart=False)
        x = np.zeros((1, 2), dtype=np.float32)
        bucket = srv.batcher.bucket_for(entry, 3)
        builder = threading.Thread(
            target=lambda: srv.batcher.program_for(entry, bucket))
        builder.start()
        timer = threading.Timer(0.3, release.set)
        try:
            assert in_build.wait(10)
            expired = [serving.server._Request(
                entry, (x,), 1, deadline=Deadline.start(0.0))
                for _ in range(2)]
            alive = serving.server._Request(
                entry, (x,), 1, deadline=Deadline.start(30.0))
            timer.start()
            ok, bad = srv._dispatch_group(entry, expired + [alive])
        finally:
            release.set()
            builder.join(30)
            timer.join(30)
        assert ok == [alive]
        np.testing.assert_array_equal(alive.result[0], x)
        assert sorted(id(r) for r, _e in bad) \
            == sorted(id(r) for r in expired)
        assert all(isinstance(e, DeadlineExceededError) for _r, e in bad)
        assert srv.stats()["bisected"] == 0


def test_server_records_decode_outcomes_on_breaker():
    repo = serving.ModelRepository()
    repo.add_decoder("lm", FakeModel())
    srv = serving.ModelServer(repo, _decode_cfg(
        circuit_window=2, circuit_threshold=0.5, circuit_cooldown_ms=50))
    try:
        with faults.plan("decode.prefill=fail"):    # beyond retries
            for _ in range(2):
                with pytest.raises(faults.InjectedFault):
                    srv.generate("lm", [1], max_new_tokens=2, timeout=30)
        with pytest.raises(CircuitOpenError):
            srv.generate("lm", [1], max_new_tokens=2, timeout=30)
        time.sleep(0.06)                    # cooldown -> probe succeeds
        out = srv.generate("lm", [2], max_new_tokens=2, timeout=30)
        assert out.tolist() == [2, 3]
        dbg = srv.debug_state()
        assert [c["state"] for c in dbg["circuits"].values()] \
            == ["closed"]
        assert srv.decode_stats("lm")["generated_tokens"] >= 2
    finally:
        srv.stop()


class TestHonorRetryAfter:
    """resilience.honor_retry_after — the client twin of the server's
    retry_after_ms hint: jittered sleeps (U[1.0, 1.5) x hint)."""

    class _Clock:
        def __init__(self):
            self.sleeps = []

        def __call__(self, s):
            self.sleeps.append(s)

    def _shedding(self, fail_n, retry_after_ms=40):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= fail_n:
                raise resilience.ServerOverloadedError(
                    "m", retry_after_ms, "queue full")
            return "served"

        return fn, calls

    def test_honors_hint_with_multiplicative_jitter(self, monkeypatch):
        import random
        clock = self._Clock()
        monkeypatch.setattr(resilience.time, "sleep", clock)
        fn, calls = self._shedding(3)
        out = resilience.honor_retry_after(fn, attempts=5,
                                           rng=random.Random(7))
        assert out == "served" and len(calls) == 4
        assert len(clock.sleeps) == 3
        for s in clock.sleeps:
            assert 0.040 <= s < 0.060, clock.sleeps

    def test_attempts_exhausted_reraises_typed(self, monkeypatch):
        monkeypatch.setattr(resilience.time, "sleep", self._Clock())
        fn, calls = self._shedding(100)
        with pytest.raises(resilience.ServerOverloadedError):
            resilience.honor_retry_after(fn, attempts=2)
        assert len(calls) == 3          # initial + 2 retries

    def test_circuit_open_is_honored_too(self, monkeypatch):
        monkeypatch.setattr(resilience.time, "sleep", self._Clock())
        calls = []

        def fn():
            calls.append(1)
            if len(calls) == 1:
                raise CircuitOpenError("m", 10, "circuit open")
            return "ok"

        assert resilience.honor_retry_after(fn) == "ok"
        assert len(calls) == 2

    def test_deadline_bounds_the_sleep(self, monkeypatch):
        clock = self._Clock()
        monkeypatch.setattr(resilience.time, "sleep", clock)
        fn, calls = self._shedding(5, retry_after_ms=10_000)
        with pytest.raises(resilience.ServerOverloadedError):
            resilience.honor_retry_after(
                fn, attempts=5, deadline=Deadline.start(0.05))
        assert len(calls) == 1 and not clock.sleeps

    def test_other_errors_propagate_immediately(self, monkeypatch):
        monkeypatch.setattr(resilience.time, "sleep", self._Clock())

        def fn():
            raise ValueError("not an overload")

        with pytest.raises(ValueError):
            resilience.honor_retry_after(fn)

    def test_on_backoff_observer(self, monkeypatch):
        monkeypatch.setattr(resilience.time, "sleep", self._Clock())
        fn, _ = self._shedding(2)
        seen = []
        resilience.honor_retry_after(
            fn, attempts=3,
            on_backoff=lambda n, d, e: seen.append((n, d > 0)))
        assert seen == [(1, True), (2, True)]

    def test_end_to_end_against_a_shedding_server(self):
        gate = threading.Event()
        entered = threading.Event()

        def gated(a):
            entered.set()
            assert gate.wait(30)
            return a

        repo = serving.ModelRepository()
        repo.add_function("g", gated, SIG)
        cfg = _cfg(max_batch_size=1, queue_depth=2, shed_watermark=1,
                   num_workers=1, retry_after_ms=5)
        x = np.ones((1, 2), np.float32)
        with serving.ModelServer(repo, cfg) as srv:
            t = threading.Thread(
                target=lambda: srv.predict("g", x, timeout=30))
            t.start()
            assert entered.wait(30)
            deadline = time.monotonic() + 30
            while srv.stats()["queue_depth"] > 0:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            t2 = threading.Thread(
                target=lambda: srv.predict("g", x, timeout=30))
            t2.start()
            deadline = time.monotonic() + 30
            while srv.stats()["queue_depth"] < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            with pytest.raises(resilience.ServerOverloadedError):
                srv.predict("g", x, timeout=30)
            released = threading.Timer(0.05, gate.set)
            released.start()
            out = resilience.honor_retry_after(
                lambda: srv.predict("g", x, timeout=30),
                attempts=20, deadline=Deadline.start(30))
            np.testing.assert_array_equal(out, x)
            t.join(30)
            t2.join(30)
            released.join(30)
        assert srv.stats()["shed"] >= 1
