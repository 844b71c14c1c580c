"""PyTorch port, multi-replica serving: twins of the JAX package's
tests/test_serving_replica.py — placement, the breaker's consecutive
fast trip, health-checked routing, failover, heartbeats, rolling
add/remove/restart, replica-scoped decode fault sites and the
``ModelServer`` wiring — on the same numpy fakes (``add_function``
entries and a numpy ``FakeLM``) with millisecond heartbeats.  Left out:
``TestReplicaCompileSharing`` (the reference's AOT executable tier; a
CUDA graph does not persist, so each port replica captures its own).

Then the port's own contract (placement refuses a replica on another
device than the weights', ``replica_groups`` needs a visible card or
explicit devices, replicas share one weight snapshot but not their
programs, ``replicas=1`` keeps the single-replica path), and parity
with the JAX package on the same numpy inputs: a 2-layer flash
``BERTClassifier`` carried by ``load_numpy_params`` served with
``replicas=2`` by both packages' ``ModelServer`` (logits within 1e-5),
and a small ``TransformerDecoderLM`` generating with ``replicas=2``
through one ``replica.r0.decode.step`` failure in both packages (equal
tokens).  Everything runs on the CPU; ``chip_smoke.py``'s ``replicas``
phase runs BERT-large and GPT-2 small on the card.
"""
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import faults, runtime_metrics as rm, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.placement import replica_groups, replica_mesh
from mxnet_tpu_torch.serving.batcher import bucket_set
from mxnet_tpu_torch.serving.decode import DecodeEngine
from mxnet_tpu_torch.serving.replica import (DRAINING, HEALTHY, STOPPED,
                                             UNHEALTHY, ReplicaSet)
from mxnet_tpu_torch.serving.resilience import (CircuitBreaker, Deadline,
                                                ServerOverloadedError)


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


def _fn(a):
    return a * 2.0 + 1.0


def _cfg(**kw):
    kw.setdefault("replicas", 3)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_latency_us", 1)
    kw.setdefault("retry_backoff_ms", 0)
    kw.setdefault("replica_heartbeat_ms", 10)
    kw.setdefault("replica_heartbeat_window_ms", 80)
    kw.setdefault("circuit_cooldown_ms", 30)
    return serving.ServingConfig(**kw)


def _entry(fn=_fn, name="m"):
    repo = serving.ModelRepository()
    repo.add_function(name, fn, SIG)
    return repo.get(name)


def _rset(fn=_fn, **cfg_kw):
    return ReplicaSet(_entry(fn), _cfg(**cfg_kw))


def _wait_state(rset, rid, state, timeout=10.0):
    deadline = time.monotonic() + timeout
    while rset.replicas()[rid] != state:
        assert time.monotonic() < deadline, \
            (rid, state, rset.debug_state())
        time.sleep(0.005)


X = {n: np.arange(2 * n, dtype=np.float32).reshape(n, 2)
     for n in (1, 2, 3)}


# ------------------------------------------------------------- placement
class TestPlacement:
    def test_disjoint_groups(self):
        devs = [f"d{i}" for i in range(8)]
        groups = replica_groups(4, devices=devs, tp=2)
        assert groups == [("d0", "d1"), ("d2", "d3"), ("d4", "d5"),
                          ("d6", "d7")]
        flat = [d for g in groups for d in g]
        assert len(set(flat)) == len(flat)          # strictly disjoint

    def test_subset_when_devices_exceed_need(self):
        groups = replica_groups(2, devices=list("abcdef"), tp=2)
        assert groups == [("a", "b"), ("c", "d")]

    def test_single_device_oversubscribes_by_default(self):
        groups = replica_groups(3, devices=["cpu0"])
        assert groups == [("cpu0",)] * 3

    def test_multi_device_shortfall_raises_by_default(self):
        with pytest.raises(MXNetError, match="fault isolation"):
            replica_groups(4, devices=["a", "b"])

    def test_explicit_oversubscribe_round_robins(self):
        groups = replica_groups(4, devices=["a", "b"],
                                oversubscribe=True)
        assert groups == [("a",), ("b",), ("a",), ("b",)]

    @pytest.mark.parametrize("bad", [dict(n_replicas=0),
                                     dict(n_replicas=1, tp=0)])
    def test_validation(self, bad):
        with pytest.raises(MXNetError):
            replica_groups(devices=["a"], **bad)

    def test_replica_mesh_axes(self):
        mesh = replica_mesh([torch.device("cpu")])
        assert mesh.axis_names == ("dp", "tp")
        assert mesh.shape["dp"] == 1 and mesh.shape["tp"] == 1
        with pytest.raises(MXNetError):
            replica_mesh([])

    def test_replica_mesh_shape_tracks_group_size(self):
        # a tp=4 group yields a (1, 4) device array: dp is always the
        # degenerate leading axis, tp spans the whole group in order
        mesh = replica_mesh(["a", "b", "c", "d"])
        assert mesh.devices.shape == (1, 4)
        assert list(mesh.devices[0]) == ["a", "b", "c", "d"]
        assert mesh.shape["dp"] == 1 and mesh.shape["tp"] == 4

    def test_replica_mesh_custom_axis_name(self):
        mesh = replica_mesh(["a", "b"], axis_name="mp")
        assert mesh.axis_names == ("dp", "mp")
        assert mesh.shape["mp"] == 2
        assert "tp" not in mesh.shape

    def test_replica_meshes_from_groups_are_disjoint(self):
        devs = [f"d{i}" for i in range(8)]
        meshes = [replica_mesh(g)
                  for g in replica_groups(4, devices=devs, tp=2)]
        seen = [d for m in meshes for d in m.devices.ravel()]
        assert len(seen) == len(set(seen))      # no device in two meshes
        assert all(m.axis_names == ("dp", "tp") for m in meshes)


# ------------------------------------------- breaker consecutive fast trip
class TestConsecutiveTrip:
    def test_trips_before_window_fills(self):
        br = CircuitBreaker(20, 0.5, 1000, consecutive=3)
        br.record(True)
        for _ in range(3):
            br.record(False)
        assert br.state == "open"

    def test_success_resets_the_run(self):
        # threshold high enough that the 2/3 windowed error rate never
        # trips — only the consecutive rule is in play here
        br = CircuitBreaker(20, 0.95, 1000, consecutive=3)
        for _ in range(10):
            br.record(False)
            br.record(False)
            br.record(True)             # never 3 in a row
        assert br.state == "closed"

    def test_zero_keeps_windowed_semantics(self):
        br = CircuitBreaker(20, 0.5, 1000, consecutive=0)
        for _ in range(5):
            br.record(False)
        assert br.state == "closed"     # window not full yet

    def test_probe_success_clears_run(self):
        br = CircuitBreaker(20, 0.5, 1, consecutive=2)
        br.record(False)
        br.record(False)
        assert br.state == "open"
        time.sleep(0.005)
        assert br.admit() is True       # the half-open probe
        br.record(True)
        assert br.state == "closed"
        assert br.debug_state()["consec_failures"] == 0


# ------------------------------------------------------- predict replicas
class TestReplicaSetPredict:
    def test_prewarm_gates_routability(self):
        with _rset() as rset:
            assert set(rset.replicas().values()) == {HEALTHY}
            st = rset.stats()
            bound = len(bucket_set(4))
            for rid, info in st["replicas"].items():
                assert info["prewarms"] == 1
                assert rset.replica(rid).batcher.programs() == bound

    def test_outputs_and_load_balance(self):
        with _rset() as rset:
            for i in range(30):
                n = (i % 3) + 1
                (out,) = rset.run_batch([(X[n],)])
                np.testing.assert_array_equal(out[0], _fn(X[n]))
            reqs = [v["requests"]
                    for v in rset.stats()["replicas"].values()]
            assert all(r > 0 for r in reqs), reqs
            assert sum(reqs) == 30

    def test_transient_failure_fails_over_byte_identical(self):
        with _rset() as rset:
            (ref,) = rset.run_batch([(X[2],)])
            with faults.plan("replica.*.execute=fail,times=1"):
                (out,) = rset.run_batch([(X[2],)])
            np.testing.assert_array_equal(out[0], ref[0])
            st = rset.stats()
            assert st["failovers"] == 1
            assert rm.SERVING_REPLICA_FAILOVERS.value(model="m") == 1

    def test_deterministic_failure_raises_without_failover(self):
        def picky(a):
            if np.any(a == 99.0):       # value-poisoned, prewarm-safe
                raise ValueError("poisoned")
            return _fn(a)

        poison = np.full((2, 2), 99.0, np.float32)
        with ReplicaSet(_entry(picky), _cfg()) as rset:
            with pytest.raises(ValueError):
                rset.run_batch([(poison,)])
            assert rset.stats()["failovers"] == 0

    def test_build_wait_deadline_never_counts_against_replica(self):
        """A deadline that expires waiting on
        another thread's bucket build says nothing about the replica's
        health — with threshold=1 a single recorded failure would mark
        it UNHEALTHY, so the expiry must skip the replica breaker
        (mirroring the model-level breaker's exclusion)."""
        from mxnet_tpu_torch.serving.resilience import DeadlineExceededError
        rset = _rset(replicas=1, replica_failure_threshold=1)
        try:
            entry = rset.entry
            in_build, release = threading.Event(), threading.Event()
            real = entry.make_program

            def blocking_make_program(rows):
                in_build.set()
                assert release.wait(30)
                return real(rows)
            # prewarm already built every bucket: evict so the next
            # dispatch rebuilds through the wedged build
            rset.replica("r0").batcher.evict(entry)
            entry.make_program = blocking_make_program
            x = np.ones((1, 2), np.float32)
            done = []
            build_thread = threading.Thread(
                target=lambda: done.append(rset.run_batch([(x,)])))
            build_thread.start()
            try:
                assert in_build.wait(10)
                with pytest.raises(DeadlineExceededError):
                    rset.run_batch([(x,)], deadline=Deadline.start(0.2))
                # no outcome recorded: the replica stays routable
                assert rset.replicas()["r0"] == HEALTHY
                assert rset.stats()["failovers"] == 0
            finally:
                release.set()
                build_thread.join(30)
            assert len(done) == 1
            entry.make_program = real
            # and the replica still serves
            np.testing.assert_allclose(
                rset.run_batch([(x,)])[0][0], _fn(x))
            assert rset.replicas()["r0"] == HEALTHY
        finally:
            rset.stop()

    def test_consecutive_failures_trip_then_probe_recovers(self):
        rset = _rset(replica_failure_threshold=2)
        try:
            rep = rset.replica("r0")
            rset._record_outcome(rep, False)
            rset._record_outcome(rep, False)
            assert rset.replicas()["r0"] == UNHEALTHY
            assert rep.unhealthy_reason == "failures"
            # routing avoids it while the breaker cools down
            picked = {rset._select().rid for _ in range(10)}
            assert "r0" not in picked
            # after the cooldown the router offers it the half-open
            # probe FIRST; a success re-heals the state machine
            time.sleep(0.05)
            probe = rset._select()
            assert probe.rid == "r0"
            rset._record_outcome(rep, True)
            assert rset.replicas()["r0"] == HEALTHY
        finally:
            rset.stop()

    def test_all_dark_sheds_typed(self):
        with _rset(replica_failure_threshold=1,
                   circuit_cooldown_ms=60000) as rset:
            for rid in list(rset.replicas()):
                rset._record_outcome(rset.replica(rid), False)
            assert set(rset.replicas().values()) == {UNHEALTHY}
            with pytest.raises(ServerOverloadedError, match="no healthy"):
                rset.run_batch([(X[1],)])
            assert rset.stats()["no_healthy_rejects"] == 1

    def test_expired_deadline_stops_failover(self):
        with _rset() as rset:
            dead = Deadline(time.monotonic() - 1.0, 0.001)
            with faults.plan("replica.*.execute=fail"):
                with pytest.raises(faults.InjectedFault):
                    rset.run_batch([(X[1],)], deadline=dead)
            assert rset.stats()["failovers"] == 0


# ---------------------------------------------------- heartbeats + rejoin
class TestHeartbeats:
    def test_stall_detect_dark_serve_prewarm_rejoin(self):
        with _rset() as rset:
            p0 = rset.replica("r1").prewarms
            with faults.plan("replica.r1.heartbeat=stall,ms=400,times=1"):
                _wait_state(rset, "r1", UNHEALTHY, timeout=5)
                assert rset.replica("r1").unhealthy_reason.startswith(
                    "heartbeat")
                # the dark window serves byte-identically via siblings
                for _ in range(5):
                    (out,) = rset.run_batch([(X[1],)])
                    np.testing.assert_array_equal(out[0], _fn(X[1]))
            # beats resume -> rejoin gated on a FRESH prewarm pass
            _wait_state(rset, "r1", HEALTHY, timeout=10)
            assert rset.replica("r1").prewarms == p0 + 1
            st = rset.stats()
            assert st["rejoins"] >= 1 and st["unhealthy_marks"] >= 1

    def test_detection_needs_no_traffic(self):
        # the sweep rides sibling heartbeats, not requests
        with _rset() as rset:
            with faults.plan("replica.r2.heartbeat=stall,ms=400,times=1"):
                _wait_state(rset, "r2", UNHEALTHY, timeout=5)
            _wait_state(rset, "r2", HEALTHY, timeout=10)

    def test_heartbeat_age_gauge_published(self):
        with _rset() as rset:
            time.sleep(0.05)
            age = rm.SERVING_REPLICA_HEARTBEAT_AGE.value(
                model="m", replica="r0")
            assert age is not None and age < 5.0


# -------------------------------------------------------------- rolling ops
class TestRollingOps:
    def test_add_replica_prewarms_before_routable(self):
        with _rset(replicas=2) as rset:
            rid = rset.add_replica()
            assert rset.replicas()[rid] == HEALTHY
            rep = rset.replica(rid)
            assert rep.prewarms == 1
            assert rep.batcher.programs() == len(bucket_set(4))
            # and it takes traffic
            for _ in range(12):
                rset.run_batch([(X[1],)])
            assert rset.replica(rid).requests > 0

    def test_remove_replica_drains(self):
        gate = threading.Event()
        entered = threading.Event()

        def gated(a):
            entered.set()
            assert gate.wait(30)
            return _fn(a)

        gate.set()                          # prewarm passes through
        with ReplicaSet(_entry(gated), _cfg(replicas=2)) as rset:
            gate.clear()
            entered.clear()
            done = []
            t = threading.Thread(
                target=lambda: done.append(
                    rset.run_batch([(X[1],)])))
            t.start()
            assert entered.wait(30)
            victim = next(rid for rid, rep in rset._replicas.items()
                          if rep.inflight > 0)
            remover = threading.Thread(
                target=rset.remove_replica, args=(victim,),
                kwargs=dict(timeout=30))
            remover.start()
            deadline = time.monotonic() + 5
            while rset.replicas().get(victim) != DRAINING:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            gate.set()                      # in-flight finishes
            remover.join(30)
            t.join(30)
            assert done and victim not in rset.replicas()
            assert rset.stats()["drained"] == 1

    def test_remove_last_replica_refused(self):
        with _rset(replicas=1) as rset:
            with pytest.raises(MXNetError, match="last replica"):
                rset.remove_replica("r0")

    def test_restart_fresh_state_through_prewarm(self):
        with _rset(replicas=2) as rset:
            rep = rset.replica("r0")
            rset._record_outcome(rep, False)
            assert rep.failures == 1
            rset.restart("r0", timeout=10)
            fresh = rset.replica("r0")
            assert fresh is not rep
            assert fresh.failures == 0 and fresh.prewarms == 1
            assert rset.replicas()["r0"] == HEALTHY
            (out,) = rset.run_batch([(X[1],)])
            np.testing.assert_array_equal(out[0], _fn(X[1]))


# --------------------------------------------------------- decode replicas
class FakeLM:
    """Decode-model protocol in plain numpy: next token = (last + 1)
    mod vocab; prefill proposes the prompt's last token."""

    vocab_size = 16
    max_context = 32

    def prefill(self, tokens, length, block_table):
        logits = np.zeros((self.vocab_size,), np.float32)
        logits[int(tokens[0, int(length) - 1]) % self.vocab_size] = 1.0
        return logits

    def decode_step(self, tokens, positions, block_tables):
        logits = np.zeros((tokens.shape[0], self.vocab_size),
                          np.float32)
        logits[np.arange(tokens.shape[0]),
               (tokens + 1) % self.vocab_size] = 1.0
        return logits


def _decode_entry(model_factory=FakeLM, name="lm"):
    repo = serving.ModelRepository()
    repo.add_decoder(name, model_factory(),
                     model_factory=model_factory)
    return repo.get(name)


def _decode_cfg(**kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("decode_page_size", 4)
    kw.setdefault("decode_pool_pages", 17)
    kw.setdefault("decode_max_batch", 4)
    kw.setdefault("decode_max_new_tokens", 8)
    kw.setdefault("retry_backoff_ms", 0)
    kw.setdefault("retry_max", 2)
    kw.setdefault("replica_heartbeat_ms", 10)
    kw.setdefault("replica_heartbeat_window_ms", 80)
    kw.setdefault("circuit_cooldown_ms", 30)
    return serving.ServingConfig(**kw)


class TestReplicaSetDecode:
    def test_generate_parity_and_leak_free(self):
        with ReplicaSet(_decode_entry(), _decode_cfg()) as rset:
            out = rset.generate([3], max_new_tokens=4, timeout=30)
            assert out.tolist() == [3, 4, 5, 6]
            rset.check_leaks()

    def test_kill_mid_generate_quarantines_then_fails_over(self):
        """The chaos criterion: a replica dying mid-generate()
        quarantines the sequence leak-free and the request is
        re-admitted fresh on a sibling — byte-identical tokens."""
        with ReplicaSet(_decode_entry(), _decode_cfg()) as rset:
            ref = rset.generate([3], max_new_tokens=4, timeout=30)
            # 3 fail firings: the serving replica burns its 2 retries
            # and quarantines; the sibling runs clean
            with faults.plan("replica.*.decode.step=fail,times=3"):
                out = rset.generate([3], max_new_tokens=4, timeout=30)
            assert out.tolist() == ref.tolist()
            st = rset.stats()
            assert st["failovers"] == 1
            quarantined = sum(s["quarantined"]
                              for s in rset.decode_stats().values())
            assert quarantined == 1
            rset.check_leaks()          # quarantine released every page
            used = sum(s["used_pages"]
                       for s in rset.decode_stats().values())
            assert used == 0

    def test_failover_budget_exhausts_typed(self):
        with ReplicaSet(_decode_entry(),
                        _decode_cfg(retry_max=1)) as rset:
            with faults.plan("replica.*.decode.step=fail"):
                with pytest.raises(MXNetError):
                    rset.generate([3], max_new_tokens=4, timeout=30)
            rset.check_leaks()

    def test_non_adapter_model_without_factory_rejected(self):
        repo = serving.ModelRepository()
        repo.add_decoder("lm", FakeLM())            # no factory
        with pytest.raises(MXNetError, match="model_factory"):
            ReplicaSet(repo.get("lm"), _decode_cfg(replicas=2))

    def test_single_replica_set_owns_the_model(self):
        repo = serving.ModelRepository()
        repo.add_decoder("lm", FakeLM())
        with ReplicaSet(repo.get("lm"),
                        _decode_cfg(replicas=1)) as rset:
            out = rset.generate([3], max_new_tokens=2, timeout=30)
            assert out.tolist() == [3, 4]


# ------------------------------------------------- scoped decode fault sites
class TestDecodeFaultScope:
    def _engine(self, scope):
        eng = DecodeEngine(FakeLM(), _decode_cfg(replicas=1),
                           model_name="fake", fault_scope=scope)
        eng._started = True             # manual stepping
        return eng

    def _run(self, eng):
        seq = eng.submit([3], max_new_tokens=2)
        n = 0
        while not seq.event.is_set():
            eng.step()
            n += 1
            assert n < 32
        return seq

    def test_scoped_engine_ignores_plain_decode_sites(self):
        eng = self._engine("replica.r7.decode")
        with faults.plan("decode.step=fail"):
            seq = self._run(eng)
        assert seq.finish_reason == "length"
        assert seq.tokens == [3, 4]

    def test_scoped_engine_honors_its_own_sites(self):
        eng = self._engine("replica.r7.decode")
        with faults.plan("replica.r7.decode.step=fail"):
            seq = self._run(eng)
        assert seq.finish_reason == "quarantined"

    def test_default_scope_unchanged(self):
        eng = self._engine("decode")
        with faults.plan("decode.step=fail"):
            seq = self._run(eng)
        assert seq.finish_reason == "quarantined"


# ------------------------------------------------------ server integration
class TestServerIntegration:
    def _server(self, fn=_fn, **cfg_kw):
        repo = serving.ModelRepository()
        repo.add_function("m", fn, SIG)
        return repo, serving.ModelServer(repo, _cfg(**cfg_kw))

    def test_predict_parity_with_single_replica(self):
        _, single = self._server(replicas=1)
        _, multi = self._server(replicas=3)
        with single, multi:
            for n in (1, 2, 3):
                a = single.predict("m", X[n], timeout=30)
                b = multi.predict("m", X[n], timeout=30)
                np.testing.assert_array_equal(a, b)
            st = multi.stats()
            assert "replica_sets" in st
            assert sum(v["requests"] for v in
                       st["replica_sets"]["m"]["replicas"].values()) \
                == 3

    def test_failover_under_threaded_load(self):
        repo, srv = self._server(replicas=3)
        errors, outs = [], []

        def worker(tid):
            for i in range(8):
                n = (tid + i) % 3 + 1
                try:
                    outs.append(
                        (n, srv.predict("m", X[n], timeout=30)))
                except Exception as e:          # noqa: BLE001
                    errors.append(e)

        with srv:
            with faults.plan("replica.r1.execute=fail,times=6,seed=2"):
                pool = [threading.Thread(target=worker, args=(t,))
                        for t in range(6)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(60)
            assert not errors, errors[:3]       # failover absorbed all
            for n, out in outs:
                np.testing.assert_array_equal(out, _fn(X[n]))
            assert len(outs) == 48

    def test_generate_through_server_with_failover(self):
        repo = serving.ModelRepository()
        repo.add_decoder("lm", FakeLM(), model_factory=FakeLM)
        with serving.ModelServer(repo, _decode_cfg()) as srv:
            ref = srv.generate("lm", [3], max_new_tokens=4, timeout=30)
            with faults.plan("replica.*.decode.step=fail,times=3"):
                out = srv.generate("lm", [3], max_new_tokens=4,
                                   timeout=30)
            assert out.tolist() == ref.tolist() == [3, 4, 5, 6]
            stats = srv.decode_stats("lm")
            assert set(stats) == {"r0", "r1"}
            entry = repo.get("lm")
            srv._replica_sets[entry.uid].check_leaks()

    def test_prewarm_builds_all_replicas_before_traffic(self):
        repo, srv = self._server(replicas=2)
        with srv:
            summary = srv.prewarm("m")
            assert set(summary["replicas"].values()) == {HEALTHY}
            rs = summary["stats"]["replicas"]
            assert all(v["prewarms"] == 1 for v in rs.values())
            assert all(v["requests"] == 0 for v in rs.values())

    def test_unload_stops_replica_set(self):
        repo, srv = self._server(replicas=2)
        with srv:
            srv.predict("m", X[1], timeout=30)
            entry = repo.get("m")
            rset = srv._replica_sets[entry.uid]
            repo.unload("m")
            assert entry.uid not in srv._replica_sets
            assert set(rset.replicas().values()) == {STOPPED}

    def test_debug_state_serializable(self):
        import json
        repo, srv = self._server(replicas=2)
        with srv:
            srv.predict("m", X[1], timeout=30)
            state = srv.debug_state()
            assert state["replica_sets"]
            (rset_state,) = state["replica_sets"].values()
            assert set(rset_state["replicas"]) == {"r0", "r1"}
            json.dumps(state)           # flight-recorder contract

    def test_server_stop_stops_replicas(self):
        repo, srv = self._server(replicas=2)
        srv.predict("m", X[1], timeout=30)
        entry = repo.get("m")
        rset = srv._replica_sets[entry.uid]
        assert srv.stop(timeout=30)
        assert set(rset.replicas().values()) == {STOPPED}

    def test_replica_traffic_tagged_in_traces(self):
        from mxnet_tpu_torch import tracing
        tracing.enable(sample=1.0)
        try:
            repo, srv = self._server(replicas=2)
            with srv:
                with faults.plan("replica.*.execute=fail,times=1"):
                    srv.predict("m", X[1], timeout=30)
                fo = srv.stats()["replica_sets"]["m"]["failovers"]
                assert fo == 1
                tagged = [
                    s for tr in tracing.TRACER.traces()
                    for s in tr["spans"]
                    if (s.get("tags") or {}).get("failover_from")]
                assert tagged, "no failover_from trace tag recorded"
                assert all((s["tags"] or {}).get("replica")
                           for s in tagged)
        finally:
            tracing.disable()
            tracing.reset()


# -------------------------------------------- sanitizer-mode router stress
class TestRouterStress:
    def test_threaded_routing_with_chaos_consistent_counters(self):
        """8 client threads x 10 requests against 3 replicas while a
        seeded plan kills one replica's executes AND stalls its
        heartbeat: every request resolves (typed or served), counters
        reconcile, and — under MXNET_ENGINE_SANITIZE=1 in CI — no
        lock-order inversion fires across the router / heartbeat /
        worker lock families."""
        with _rset() as rset:
            errors, served = [], []

            def worker(tid):
                for i in range(10):
                    n = (tid + i) % 3 + 1
                    try:
                        (out,) = rset.run_batch(
                            [(X[n],)],
                            deadline=Deadline.start(30))
                        np.testing.assert_array_equal(
                            out[0], _fn(X[n]))
                        served.append(n)
                    except MXNetError as e:
                        errors.append(e)

            plan = ("replica.r0.execute=fail,times=10,seed=5;"
                    "replica.r0.heartbeat=stall,ms=200,times=1")
            with faults.plan(plan):
                pool = [threading.Thread(target=worker, args=(t,))
                        for t in range(8)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(60)
            assert len(served) + len(errors) == 80
            assert not errors, errors[:3]
            st = rset.stats()
            assert sum(v["requests"]
                       for v in st["replicas"].values()) \
                == st["dispatched"]
            assert all(v["inflight"] == 0
                       for v in st["replicas"].values())


# ------------------------------------------------------------- hardening
class TestReviewHardening:
    def test_failed_rejoin_prewarm_retries_after_cooldown(self):
        """One transient prewarm failure during a
        heartbeat rejoin must not strand the replica dark forever —
        the beat loop retries the bring-up after the breaker
        cooldown."""
        poison = {"on": False}

        def flaky(a):
            if poison["on"]:
                raise RuntimeError("transient backend outage")
            return _fn(a)

        with ReplicaSet(_entry(flaky),
                        _cfg(replicas=2,
                             circuit_cooldown_ms=30)) as rset:
            with faults.plan(
                    "replica.r0.heartbeat=stall,ms=300,times=1"):
                poison["on"] = True     # the rejoin prewarm will fail
                _wait_state(rset, "r0", UNHEALTHY, timeout=5)
            # beats are back; the first rejoin attempt fails and the
            # reason becomes "prewarm failed: ..."
            deadline = time.monotonic() + 5
            while not (rset.replica("r0").unhealthy_reason or "") \
                    .startswith("prewarm failed"):
                assert time.monotonic() < deadline, \
                    rset.debug_state()["replicas"]["r0"]
                time.sleep(0.005)
            poison["on"] = False        # outage clears
            _wait_state(rset, "r0", HEALTHY, timeout=10)
            assert rset.replica("r0").prewarms >= 1

    def test_initial_prewarm_failure_self_heals(self):
        """A replica whose FIRST prewarm fails still gets
        a beat thread, so it recovers on its own once the failure
        clears — no operator restart() required."""
        poison = {"left": 100}

        def flaky(a):
            if poison["left"] > 0:
                poison["left"] -= 1
                raise RuntimeError("cold backend")
            return _fn(a)

        rset = ReplicaSet(_entry(flaky),
                          _cfg(replicas=1, circuit_cooldown_ms=20))
        try:
            assert rset.replicas()["r0"] == UNHEALTHY
            poison["left"] = 0
            _wait_state(rset, "r0", HEALTHY, timeout=10)
            (out,) = rset.run_batch([(X[1],)])
            np.testing.assert_array_equal(out[0], _fn(X[1]))
        finally:
            rset.stop()

    def test_window_zero_keeps_consecutive_fast_trip(self):
        """Disabling the windowed breaker
        (circuit_window=0) must NOT disable the replica layer's
        consecutive-failure dead-replica detector."""
        br = CircuitBreaker(0, 0.5, 20, consecutive=2)
        br.record(False)
        assert br.record(False) == "open"
        with pytest.raises(ServerOverloadedError):
            br.admit()
        time.sleep(0.03)
        assert br.admit() is True       # half-open probe still works
        br.record(True)
        assert br.state == "closed"
        # and fully-off stays fully-off
        off = CircuitBreaker(0, 0.5, 20, consecutive=0)
        for _ in range(10):
            assert off.record(False) == "closed"
        assert off.admit() is False

    def test_window_zero_replica_set_still_marks_unhealthy(self):
        with _rset(circuit_window=0,
                   replica_failure_threshold=2) as rset:
            rep = rset.replica("r0")
            rset._record_outcome(rep, False)
            rset._record_outcome(rep, False)
            assert rset.replicas()["r0"] == UNHEALTHY
            assert rep.unhealthy_reason == "failures"

    def test_stats_disambiguates_two_live_versions(self):
        repo = serving.ModelRepository()
        repo.add_function("m", _fn, SIG)                 # v1, active
        repo.add_function("m", lambda a: a * 5.0, SIG,
                          version=2, activate=False)     # staged
        with serving.ModelServer(repo, _cfg(replicas=2)) as srv:
            srv.predict("m", X[1], timeout=30)           # builds v1 set
            srv.prewarm("m", version=2)                  # builds v2 set
            keys = set(srv.stats()["replica_sets"])
            assert keys == {"m", "m@v2"}, keys


# -------------------------------------------------- the port's own contract
class TestPortPlacement:
    def test_visible_devices_needed_without_devices(self, monkeypatch):
        # the port places replicas on the card: with no CUDA device
        # visible and no explicit devices there is nothing to fall back to
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(MXNetError, match="no CUDA device"):
            replica_groups(2)

    def test_replica_on_another_device_than_the_weights_refused(self):
        repo = serving.ModelRepository()
        repo.add_block("net", torch.nn.Linear(2, 2), np.zeros((1, 2),
                                                              np.float32))
        entry = repo.get("net")
        assert entry.device == torch.device("cpu")
        with pytest.raises(MXNetError, match="Queue A, item 5"):
            ReplicaSet(entry, _cfg(replicas=2),
                       devices=[(torch.device("cpu"),),
                                (torch.device("cuda", 1),)])

    def test_block_replicas_share_the_snapshot_not_the_programs(self):
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.ReLU())
        repo = serving.ModelRepository()
        repo.add_block("net", net, np.zeros((1, 2), np.float32))
        entry = repo.get("net")
        with ReplicaSet(entry, _cfg(replicas=2),
                        devices=[(torch.device("cpu"),)] * 2) as rset:
            p0 = rset.replica("r0").batcher.program_list(entry)
            p1 = rset.replica("r1").batcher.program_list(entry)
            assert len(p0) == len(p1) == len(bucket_set(4))
            for a, b in zip(p0, p1):
                assert a is not b and a._dev.data_ptr() != b._dev.data_ptr()
                assert a.module is b.module     # one set of weights
            x = np.arange(6, dtype=np.float32).reshape(3, 2)
            (out,) = rset.run_batch([(x,)])
            with torch.no_grad():
                want = net(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(out[0], want, rtol=0, atol=1e-6)

    def test_single_replica_server_keeps_the_shared_batcher(self):
        repo = serving.ModelRepository()
        repo.add_function("m", _fn, SIG)
        with serving.ModelServer(repo, _cfg(replicas=1)) as srv:
            np.testing.assert_array_equal(
                srv.predict("m", X[2], timeout=30), _fn(X[2]))
            assert "replica_sets" not in srv.stats()
            assert srv.stats()["programs"] == 1
            with pytest.raises(MXNetError, match="replicas > 1"):
                srv.replica_set("m")

    def test_config_validation_and_env_defaults(self, monkeypatch):
        cfg = serving.ServingConfig()
        assert (cfg.replicas, cfg.replica_heartbeat_ms,
                cfg.replica_heartbeat_window_ms,
                cfg.replica_failure_threshold) == (1, 50.0, 500.0, 3)
        monkeypatch.setenv("MXNET_SERVING_REPLICAS", "3")
        assert serving.ServingConfig().replicas == 3
        for bad in (dict(replicas=0), dict(replica_heartbeat_ms=0),
                    dict(replica_heartbeat_ms=50,
                         replica_heartbeat_window_ms=50),
                    dict(replica_failure_threshold=-1)):
            with pytest.raises(MXNetError):
                serving.ServingConfig(**bad)


# ---------------------------------------------- parity with the JAX package
ATOL = 1e-5
BERT_KW = dict(vocab_size=64, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0)
L = 32


def _bert_requests(n=12, seed=0):
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        rows = int(rs.choice([1, 2, 3, 5]))
        reqs.append((rs.randint(0, 64, (rows, L)).astype(np.int32),
                     rs.randint(0, 2, (rows, L)).astype(np.int32),
                     rs.randint(1, L + 1, rows).astype(np.int32)))
    return reqs


def _serve_threads(call, reqs):
    out = [None] * len(reqs)

    def one(i):
        out[i] = call(reqs[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in
               range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None for o in out)
    return out


def test_bert_predict_with_two_replicas_matches_jax_model_server():
    """A 2-layer flash ``BERTClassifier`` with the JAX package's weights,
    served with ``replicas=2`` by the port's ``ModelServer`` and by the
    JAX package's on the same requests from threads: logits within 1e-5,
    both replicas served, one failover through ``replica.r0.execute``."""
    import mxnet_tpu as mx
    from mxnet_tpu import faults as jfaults
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
    reqs = _bert_requests()
    cfg = dict(max_batch_size=8, max_latency_us=20_000, num_workers=2,
               replicas=2, retry_backoff_ms=0)
    repo = serving.ModelRepository()
    repo.add_block("bert", tclf, *example)
    with serving.ModelServer(repo, serving.ServingConfig(**cfg)) as srv:
        srv.prewarm("bert")
        with faults.plan("replica.r0.execute=fail,times=1"):
            got = _serve_threads(
                lambda r: srv.predict("bert", *r, timeout=300), reqs)
        st = srv.stats()["replica_sets"]["bert"]
    jrepo = jserving.ModelRepository()
    jrepo.add_block("bert", jclf, *(nd.array(a, dtype="int32")
                                    for a in example))
    with jserving.ModelServer(jrepo,
                              jserving.ServingConfig(**cfg)) as jsrv:
        with jfaults.plan("replica.r0.execute=fail,times=1"):
            want = _serve_threads(
                lambda r: jsrv.predict("bert", *r, timeout=300), reqs)
        jst = jsrv.stats()["replica_sets"]["bert"]
    for req, g, w in zip(reqs, got, want):
        assert g.shape == (req[0].shape[0], 2)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    assert st["failovers"] == jst["failovers"] == 1
    assert all(v["requests"] > 0 for v in st["replicas"].values()), st
    assert all(v["prewarms"] == 1 for v in st["replicas"].values())


VOCAB = 13


def test_generate_with_two_replicas_and_a_step_failure_matches_jax():
    """A small ``TransformerDecoderLM`` (the JAX package's weights in the
    port's LM) generating with ``replicas=2`` in both packages, through
    three ``replica.r0.decode.step`` firings (r0 burns its two retries
    and quarantines the sequence; it fails over to r1): equal tokens in
    both packages, equal to a run with no fault, and no page leaked."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import faults as jfaults
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
    cfg = dict(replicas=2, decode_page_size=4, decode_pool_pages=17,
               decode_max_batch=2, decode_max_new_tokens=6, retry_max=2,
               retry_backoff_ms=0, replica_heartbeat_ms=10,
               replica_heartbeat_window_ms=2000)
    prompt = [1, 2, 3, 4, 5]
    spec = "replica.r0.decode.step=fail,times=3"

    repo = serving.ModelRepository()
    repo.add_decoder("lm", tlm)
    with serving.ModelServer(repo, serving.ServingConfig(**cfg)) as srv:
        # the first request routes to r0 (both idle, neither routed yet)
        with faults.plan(spec):
            got = srv.generate("lm", prompt, max_new_tokens=6,
                               timeout=120)
        ref = srv.generate("lm", prompt, max_new_tokens=6, timeout=120)
        rset = srv.replica_set("lm")
        st = rset.stats()
        dstats = srv.decode_stats("lm")
        rset.check_leaks()
    jrepo = jserving.ModelRepository()
    jrepo.add_decoder("lm", jlm)
    with jserving.ModelServer(jrepo,
                              jserving.ServingConfig(**cfg)) as jsrv:
        with jfaults.plan(spec):
            want = jsrv.generate("lm", prompt, max_new_tokens=6,
                                 timeout=120)
        jst = jsrv.replica_set("lm").stats()
    assert got.tolist() == ref.tolist() == want.tolist()
    assert st["failovers"] == jst["failovers"] == 1
    assert sum(s["quarantined"] for s in dstats.values()) == 1
    assert all(s["used_pages"] == 0 for s in dstats.values())
