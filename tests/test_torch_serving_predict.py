"""PyTorch port, the predict path of ``ModelServer``: twins of the JAX
package's serving tests (tests/test_serving.py — bucket math,
repository, validation, dynamic batching, backpressure, hot swap,
prewarm, config) on the port's ``ModelRepository``, ``DynamicBatcher``
and ``ModelServer``, with ``add_block`` / ``add_function`` where the
reference exports an artifact only to have something to serve; the
bucket program of ``add_block`` on the CPU (weight snapshot, static
buffers, concurrent callers, unload); and a parity run: a small
``BERTClassifier`` (2 layers, 64 units, 4 heads, L = 32,
``use_flash=True``, so the port takes B1's plain version on the CPU)
served by the port's ``ModelServer.predict`` from several threads
against the JAX package's ``ModelServer`` serving the JAX classifier
with the same weights on the same numpy requests, within atol 1e-5 (the
tolerance of tests/test_torch_bert.py: the frameworks sum in different
orders, nothing else differs).

Everything runs on the CPU: a bucket program there stages each batch
through its static buffers and calls the forward on them, the data path
its CUDA graph replays over on the card (``chip_smoke.py``'s ``predict``
phase checks the graphs).
"""
import gc
import math
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from torch import nn

from mxnet_tpu_torch import runtime_metrics as rm, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                     ServerOverloadedError, ServingConfig,
                                     next_bucket, pad_batch, unpad_outputs)


@pytest.fixture(autouse=True)
def _metrics_on():
    rm.reset()
    rm.enable()
    yield
    rm.disable()
    rm.reset()


def _mlp(seed=7, in_units=8, out_units=4):
    g = torch.Generator().manual_seed(seed)
    net = nn.Sequential(nn.Linear(in_units, 16), nn.ReLU(),
                        nn.Linear(16, out_units))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return net


def _ref(net, *xs):
    with torch.no_grad():
        return net(*(torch.from_numpy(x) for x in xs)).numpy()


def _x(rows, seed=0, cols=8):
    return np.random.RandomState(seed).randn(rows, cols).astype(np.float32)


def _cfg(**kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_latency_us", 20_000)
    return ServingConfig(**kw)


class TestBucketMath:
    def test_next_bucket_powers_of_two(self):
        assert [next_bucket(n, 8) for n in (1, 2, 3, 4, 5, 7, 8)] == \
            [1, 2, 4, 4, 8, 8, 8]

    def test_next_bucket_non_pow2_cap(self):
        assert next_bucket(5, 6) == 6
        assert next_bucket(6, 6) == 6
        assert next_bucket(9, 6) == 6

    def test_next_bucket_rejects_zero(self):
        with pytest.raises(MXNetError):
            next_bucket(0, 8)

    def test_bucket_set_size_bound(self):
        for max_batch in (1, 2, 6, 8, 16):
            buckets = {next_bucket(n, max_batch)
                       for n in range(1, 3 * max_batch)}
            assert len(buckets) <= math.ceil(math.log2(max_batch)) + 1
            assert sorted(buckets) == serving.bucket_set(max_batch)

    def test_pad_unpad_roundtrip_ragged(self):
        reqs = [(np.arange(2 * 3, dtype=np.float32).reshape(2, 3),),
                (np.ones((1, 3), np.float32),),
                (np.full((2, 3), 7, np.float32),)]
        padded, offsets = pad_batch(reqs, 8)        # 5 real + 3 pad rows
        assert padded[0].shape == (8, 3)
        assert offsets == [0, 2, 3, 5]
        assert np.all(padded[0][5:] == 0)
        outs = (padded[0] * 2,)                     # batch-major op
        back = unpad_outputs(outs, offsets)
        for req, out in zip(reqs, back):
            np.testing.assert_allclose(out[0], req[0] * 2)
        # a torch output un-pads the same way
        back = unpad_outputs((torch.from_numpy(padded[0] * 2),), offsets)
        np.testing.assert_allclose(back[2][0], reqs[2][0] * 2)

    def test_pad_batch_overflow_raises(self):
        with pytest.raises(MXNetError, match="exceed bucket"):
            pad_batch([(np.ones((4, 2), np.float32),)], 2)

    def test_unpad_rejects_non_batch_major(self):
        with pytest.raises(MXNetError, match="batch-major"):
            unpad_outputs((np.float32(3.0),), [0, 2, 4])


class TestRepository:
    def test_block_roundtrip_and_versioning(self):
        repo = ModelRepository()
        net = _mlp(1)
        x = _x(4)
        e1 = repo.add_block("net", net, x)
        assert repo.current_version("net") == e1.version == 1
        e2 = repo.add_block("net", net, x)          # auto-increments
        assert e2.version == 2
        assert repo.current_version("net") == 2     # activate=True
        assert repo.versions("net") == [1, 2]
        assert repo.swap("net", 1) == 2
        assert repo.get("net") is e1

    def test_register_without_activate_keeps_current(self):
        repo = ModelRepository()
        net = _mlp(2)
        repo.add_block("net", net, _x(4))
        repo.add_block("net", net, _x(4), activate=False)
        assert repo.current_version("net") == 1

    def test_first_version_staged_with_activate_false(self):
        repo = ModelRepository()
        repo.add_block("net", _mlp(2), _x(4), activate=False)
        assert repo.current_version("net") is None
        with pytest.raises(MXNetError, match="no active version"):
            repo.get("net")
        repo.swap("net", 1)
        assert repo.get("net").version == 1

    def test_duplicate_version_rejected(self):
        repo = ModelRepository()
        net = _mlp(3)
        repo.add_block("net", net, _x(4), version=5)
        with pytest.raises(MXNetError, match="already registered"):
            repo.add_block("net", net, _x(4), version=5)

    def test_unload_rules(self):
        repo = ModelRepository()
        net = _mlp(4)
        repo.add_block("net", net, _x(4))
        repo.add_block("net", net, _x(4))
        with pytest.raises(MXNetError, match="is current"):
            repo.unload("net", 2)
        repo.swap("net", 1)
        repo.unload("net", 2)
        assert repo.versions("net") == [1]
        repo.unload("net")
        with pytest.raises(MXNetError, match="no model"):
            repo.get("net")

    def test_missing_model_message_lists_known(self):
        repo = ModelRepository()
        with pytest.raises(MXNetError, match="no model 'ghost'"):
            repo.get("ghost")

    def test_block_weights_snapshot_at_registration(self):
        """Training after add_block must not mutate the served version —
        publish new weights by registering + swapping."""
        repo = ModelRepository()
        net = _mlp(5)
        x = _x(3)
        want_v1 = _ref(net, x)
        repo.add_block("net", net, x)
        with torch.no_grad():
            for p in net.parameters():              # "training"
                p.mul_(0.5)
        want_v2 = _ref(net, x)
        assert not np.allclose(want_v1, want_v2)
        repo.add_block("net", net, x, activate=False)
        with ModelServer(repo, _cfg()) as srv:
            np.testing.assert_allclose(srv.predict("net", x), want_v1,
                                       rtol=1e-5, atol=1e-5)
            repo.swap("net", 2)
            np.testing.assert_allclose(srv.predict("net", x), want_v2,
                                       rtol=1e-5, atol=1e-5)

    def test_concurrent_auto_versioning_never_collides(self):
        repo = ModelRepository()
        net = _mlp(30)
        errors = []
        barrier = threading.Barrier(4)

        def register():
            try:
                barrier.wait(10)
                repo.add_block("net", net, _x(2))
            except Exception as e:      # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=register) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors[:2]
        assert sorted(repo.versions("net")) == [1, 2, 3, 4]

    def test_unload_evicts_cached_programs(self):
        """Retired versions must not pin built programs."""
        repo = ModelRepository()
        net = _mlp(31)
        x = _x(2)
        repo.add_block("net", net, x)
        repo.add_block("net", net, x, activate=False)
        with ModelServer(repo, _cfg()) as srv:
            e1 = repo.get("net")
            srv.predict("net", x, timeout=60)
            assert srv.batcher.programs(e1) == 1
            repo.swap("net", 2)
            repo.unload("net", 1)
            assert srv.batcher.programs(e1) == 0
            srv.predict("net", x, timeout=60)      # v2 serves on
            assert srv.batcher.programs() == 1
            # a batch admitted pre-unload may still dispatch once, but
            # must NOT re-cache under the retired uid
            srv.batcher.run_batch(e1, [(x,)])
            assert srv.batcher.programs(e1) == 0

    def test_stopped_server_unsubscribes_from_repository(self):
        repo = ModelRepository()
        srv = ModelServer(repo, _cfg())
        assert len(repo._unload_listeners) == 1
        srv.stop()
        assert repo._unload_listeners == []
        srv.start()                         # re-subscribes
        assert len(repo._unload_listeners) == 1
        srv.stop()


class TestValidation:
    def test_predict_validates_dtype_and_shape(self):
        repo = ModelRepository()
        repo.add_block("net", _mlp(7), _x(5))
        with ModelServer(repo, _cfg()) as srv:
            with pytest.raises(MXNetError, match="dtype mismatch"):
                srv.predict("net", np.ones((2, 8), np.float64))
            with pytest.raises(MXNetError, match="rank mismatch"):
                srv.predict("net", np.ones((8,), np.float32))
            with pytest.raises(MXNetError, match="axis 1"):
                srv.predict("net", np.ones((2, 9), np.float32))
            with pytest.raises(MXNetError, match="expected 1 input"):
                srv.predict("net", np.ones((2, 8), np.float32),
                            np.ones((2, 8), np.float32))

    def test_request_rows_bounded_by_policy(self):
        repo = ModelRepository()
        repo.add_block("net", _mlp(8), _x(5))
        with ModelServer(repo, _cfg(max_batch_size=4)) as srv:
            with pytest.raises(MXNetError, match="outside"):
                srv.predict("net", np.ones((5, 8), np.float32))


class TestDynamicBatching:
    def test_concurrent_requests_coalesce_into_buckets(self):
        """32 concurrent predict()s of 3 distinct batch sizes: results
        exact, programs bounded by ceil(log2(max_batch))+1, cache-hit
        counter moves, padded rows never leak."""
        net = _mlp(9)
        repo = ModelRepository()
        repo.add_block("net", net, _x(5))
        cfg = _cfg(max_batch_size=8, max_latency_us=50_000)
        refs = {n: (_x(n, seed=n), _ref(net, _x(n, seed=n)))
                for n in (1, 2, 3)}
        errors = []
        start = threading.Barrier(32 + 1)

        with ModelServer(repo, cfg) as srv:
            def one(i):
                n = 1 + i % 3
                try:
                    start.wait(10)
                    x, want = refs[n]
                    got = srv.predict("net", x, timeout=60)
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-5)
                except Exception as e:      # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(32)]
            for t in threads:
                t.start()
            start.wait(10)
            for t in threads:
                t.join(60)
            stats = srv.stats()
        assert not errors, errors[:3]
        assert stats["completed"] == stats["requests"] == 32
        assert 1 <= stats["batches"] < 32
        assert stats["programs"] <= 4
        assert stats["bucket_misses"] == stats["programs"]
        assert stats["programs"] == \
            stats["bucket_misses"] + stats["bucket_disk_hits"]
        assert stats["bucket_disk_hits"] == 0
        assert rm.SERVING_BUCKET_CACHE.value(event="disk_hit") == 0
        assert stats["bucket_hits"] == \
            rm.SERVING_BUCKET_CACHE.value(event="mem_hit")
        assert stats["bucket_misses"] == \
            rm.SERVING_BUCKET_CACHE.value(event="miss")
        assert stats["bucket_hits"] + stats["bucket_misses"] == \
            stats["batches"]
        assert stats["queue_depth"] == 0
        p99 = rm.SERVING_REQUEST_SECONDS.quantile(0.99, model="net")
        assert rm.SERVING_REQUEST_SECONDS.count(model="net") == 32
        assert np.isfinite(p99) and p99 >= 0
        # the bounded sync point around batch dispatch was exercised
        assert rm.ENGINE_SYNC_SECONDS.count(site="serving") == \
            stats["batches"]
        prom = rm.dump_prometheus()
        assert 'serving_request_seconds_count{model="net"} 32' in prom
        assert "serving_queue_depth" in prom
        assert "serving_batch_occupancy_bucket" in prom

    def test_single_request_no_server_needed(self):
        """The batcher is usable standalone (no worker pool)."""
        net = _mlp(10)
        repo = ModelRepository()
        entry = repo.add_block("net", net, _x(5))
        b = serving.DynamicBatcher(_cfg())
        x = _x(3)
        [(out,)] = b.run_batch(entry, [(x,)])
        np.testing.assert_allclose(out, _ref(net, x), rtol=1e-5,
                                   atol=1e-5)
        assert b.bucket_misses == 1
        [(out2,)] = b.run_batch(entry, [(x,)])      # same bucket: hit
        assert b.bucket_hits == 1
        np.testing.assert_allclose(out, out2, rtol=1e-6)

    def test_static_block_pads_to_declared_batch(self):
        """dynamic_batch=False blocks serve every request padded to the
        example's batch (the counterpart of a static artifact)."""
        net = _mlp(11)
        repo = ModelRepository()
        repo.add_block("net", net, _x(4), dynamic_batch=False)
        entry = repo.get("net")
        assert not entry.dynamic_batch and entry.fixed_batch == 4
        with ModelServer(repo, _cfg()) as srv:
            for n in (1, 2, 4):
                x = _x(n, seed=n)
                np.testing.assert_allclose(
                    srv.predict("net", x, timeout=60), _ref(net, x),
                    rtol=1e-5, atol=1e-5)
            with pytest.raises(MXNetError, match="outside"):
                srv.predict("net", np.ones((5, 8), np.float32))
        assert srv.stats()["programs"] == 1

    def test_static_function_entry_pads_to_declared_batch(self):
        repo = ModelRepository()
        repo.add_function("f", lambda x: x * 2.0,
                          [{"shape": [4, 2], "dtype": "float32"}],
                          dynamic_batch=False)
        assert repo.get("f").fixed_batch == 4
        with ModelServer(repo, _cfg()) as srv:
            x = np.arange(4, dtype=np.float32).reshape(2, 2)
            np.testing.assert_allclose(
                srv.predict("f", x, timeout=60), x * 2)
            with pytest.raises(MXNetError, match="outside"):
                srv.predict("f", np.ones((5, 2), np.float32))

    def test_multi_output_model_returns_tuple(self):
        repo = ModelRepository()
        sig = [{"shape": [None, 3], "dtype": "float32"}]
        repo.add_function("twin", lambda x: (x * 2.0, x + 1.0), sig)
        with ModelServer(repo, _cfg()) as srv:
            x = np.ones((2, 3), np.float32)
            a, b = srv.predict("twin", x, timeout=60)
            np.testing.assert_allclose(a, x * 2)
            np.testing.assert_allclose(b, x + 1)


class _GatedModel:
    """Function entry whose batches block until released — makes queue
    buildup deterministic for backpressure tests."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def __call__(self, x):
        self.entered.set()
        assert self.release.wait(30), "test never released the gate"
        return x * 2.0


def _wait_depth(srv, cond):
    deadline = time.monotonic() + 30
    while not cond(srv.stats()["queue_depth"]):
        assert time.monotonic() < deadline
        time.sleep(0.005)


class TestBackpressure:
    SIG = [{"shape": [None, 2], "dtype": "float32"}]

    def _spawn_predicts(self, srv, n, results):
        threads = []
        for _ in range(n):
            def one():
                try:
                    results.append(srv.predict(
                        "gated", np.ones((1, 2), np.float32),
                        timeout=60))
                except Exception as e:  # noqa: BLE001
                    results.append(e)
            t = threading.Thread(target=one)
            t.start()
            threads.append(t)
        return threads

    def test_load_shedding_at_watermark(self):
        repo = ModelRepository()
        gate = _GatedModel()
        repo.add_function("gated", gate, self.SIG)
        cfg = _cfg(max_batch_size=1, max_latency_us=1, queue_depth=4,
                   shed_watermark=2, num_workers=1, retry_after_ms=17)
        srv = ModelServer(repo, cfg)
        try:
            results = []
            t1 = self._spawn_predicts(srv, 1, results)
            assert gate.entered.wait(30)
            _wait_depth(srv, lambda d: d == 0)
            t2 = self._spawn_predicts(srv, 2, results)
            _wait_depth(srv, lambda d: d >= 2)
            with pytest.raises(ServerOverloadedError) as ei:
                srv.predict("gated", np.ones((1, 2), np.float32))
            assert ei.value.retry_after_ms == 17
            assert "retry after 17ms" in str(ei.value)
            assert srv.stats()["shed"] == 1
            assert rm.SERVING_SHED.value(model="gated") == 1
            gate.release.set()
            for t in t1 + t2:
                t.join(60)
            assert all(isinstance(r, np.ndarray) for r in results), \
                results
        finally:
            gate.release.set()
            srv.stop()
        assert srv.stats()["completed"] == 3

    def test_inflight_counts_against_queue_depth(self):
        repo = ModelRepository()
        gate = _GatedModel()
        repo.add_function("gated", gate, self.SIG)
        cfg = _cfg(max_batch_size=1, max_latency_us=1, queue_depth=2,
                   shed_watermark=2, num_workers=1)
        srv = ModelServer(repo, cfg)
        try:
            results = []
            t1 = self._spawn_predicts(srv, 1, results)
            assert gate.entered.wait(30)        # in-flight, queue empty
            t2 = self._spawn_predicts(srv, 1, results)  # queued: depth 1
            _wait_depth(srv, lambda d: d >= 1)
            with pytest.raises(ServerOverloadedError):
                srv.predict("gated", np.ones((1, 2), np.float32))
            gate.release.set()
            for t in t1 + t2:
                t.join(60)
            assert all(isinstance(r, np.ndarray) for r in results)
        finally:
            gate.release.set()
            srv.stop()

    def test_graceful_drain_completes_queued_requests(self):
        repo = ModelRepository()
        gate = _GatedModel()
        repo.add_function("gated", gate, self.SIG)
        cfg = _cfg(max_batch_size=1, max_latency_us=1, queue_depth=8,
                   num_workers=1)
        srv = ModelServer(repo, cfg)
        results = []
        threads = self._spawn_predicts(srv, 4, results)
        assert gate.entered.wait(30)
        _wait_depth(srv, lambda d: d >= 3)
        gate.release.set()
        srv.stop(drain=True)
        for t in threads:
            t.join(60)
        assert len(results) == 4
        assert all(isinstance(r, np.ndarray) for r in results), results
        with pytest.raises(MXNetError, match="not accepting"):
            srv.predict("gated", np.ones((1, 2), np.float32))

    def test_hard_stop_fails_queued_requests(self):
        repo = ModelRepository()
        gate = _GatedModel()
        repo.add_function("gated", gate, self.SIG)
        cfg = _cfg(max_batch_size=1, max_latency_us=1, queue_depth=8,
                   num_workers=1)
        srv = ModelServer(repo, cfg)
        results = []
        threads = self._spawn_predicts(srv, 3, results)
        assert gate.entered.wait(30)
        _wait_depth(srv, lambda d: d >= 2)
        gate.release.set()
        srv.stop(drain=False)
        for t in threads:
            t.join(60)
        assert len(results) == 3
        stopped = [r for r in results if isinstance(r, MXNetError)]
        served = [r for r in results if isinstance(r, np.ndarray)]
        assert len(stopped) == 2 and len(served) == 1, results

    def test_timed_out_request_is_withdrawn(self):
        repo = ModelRepository()
        gate = _GatedModel()
        repo.add_function("gated", gate, self.SIG)
        cfg = _cfg(max_batch_size=1, max_latency_us=1, queue_depth=8,
                   shed_watermark=2, num_workers=1)
        srv = ModelServer(repo, cfg)
        try:
            results = []
            t1 = self._spawn_predicts(srv, 1, results)
            assert gate.entered.wait(30)
            with pytest.raises(MXNetError, match="no result within"):
                srv.predict("gated", np.ones((1, 2), np.float32),
                            timeout=0.05)
            assert srv.stats()["queue_depth"] == 0      # withdrawn
            t2 = self._spawn_predicts(srv, 1, results)
            gate.release.set()
            for t in t1 + t2:
                t.join(60)
            assert all(isinstance(r, np.ndarray) for r in results)
        finally:
            gate.release.set()
            srv.stop()
        assert srv.stats()["completed"] == 2

    def test_stop_timeout_keeps_stopping_state(self):
        repo = ModelRepository()
        gate = _GatedModel()
        repo.add_function("gated", gate, self.SIG)
        srv = ModelServer(repo, _cfg(max_batch_size=1, max_latency_us=1,
                                     num_workers=1))
        results = []
        threads = self._spawn_predicts(srv, 1, results)
        assert gate.entered.wait(30)
        assert srv.stop(drain=True, timeout=0.05) is False
        assert srv.started
        srv.start()                             # must be a no-op
        assert len(srv._workers) == 1
        gate.release.set()
        assert srv.stop(drain=True) is True
        for t in threads:
            t.join(60)
        assert all(isinstance(r, np.ndarray) for r in results)

    def test_full_batch_not_blocked_by_other_models_hold_window(self):
        repo = ModelRepository()
        repo.add_function("slow_form", lambda x: x, self.SIG)
        repo.add_function("fast", lambda x: x + 1.0, self.SIG)
        cfg = _cfg(max_batch_size=2, max_latency_us=10_000_000,
                   num_workers=1)
        srv = ModelServer(repo, cfg)
        try:
            holder_out = []
            holder = threading.Thread(
                target=lambda: holder_out.append(srv.predict(
                    "slow_form", np.ones((1, 2), np.float32),
                    timeout=60)))
            holder.start()                      # forms for 10s
            done = []

            def full_batch(results=done):
                results.append(srv.predict(
                    "fast", np.ones((1, 2), np.float32), timeout=60))
            t0 = time.monotonic()
            fast_threads = [threading.Thread(target=full_batch)
                            for _ in range(2)]         # 2 rows == cap
            for t in fast_threads:
                t.start()
            for t in fast_threads:
                t.join(60)
            assert len(done) == 2
            assert time.monotonic() - t0 < 5
        finally:
            srv.stop(drain=True)
        holder.join(60)
        assert srv.stats()["completed"] == 3

    def test_model_error_propagates_to_caller(self):
        repo = ModelRepository()

        def boom(x):
            raise ValueError("synthetic model failure")

        repo.add_function("boom", boom, self.SIG)
        with ModelServer(repo, _cfg(max_latency_us=1)) as srv:
            with pytest.raises(ValueError, match="synthetic"):
                srv.predict("boom", np.ones((1, 2), np.float32),
                            timeout=60)
        assert srv.stats()["errors"] == 1


class TestHotSwap:
    def test_swap_under_concurrent_load_is_atomic(self):
        """Every response matches exactly v1 or v2 — never a mix."""
        net1, net2 = _mlp(20), _mlp(21)
        x = _x(2)
        want1, want2 = _ref(net1, x), _ref(net2, x)
        assert not np.allclose(want1, want2)
        repo = ModelRepository()
        repo.add_block("net", net1, x, version=1)
        repo.add_block("net", net2, x, version=2, activate=False)
        errors, seen_v2 = [], threading.Event()

        with ModelServer(repo, _cfg(max_latency_us=1000,
                                    num_workers=2)) as srv:
            def caller():
                for _ in range(20):
                    try:
                        got = srv.predict("net", x, timeout=60)
                    except Exception as e:  # noqa: BLE001
                        errors.append(e)
                        return
                    if np.allclose(got, want2, rtol=1e-5, atol=1e-5):
                        seen_v2.set()
                    elif not np.allclose(got, want1, rtol=1e-5,
                                         atol=1e-5):
                        errors.append(AssertionError(
                            "response matches neither version"))
                        return
            threads = [threading.Thread(target=caller)
                       for _ in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.02)
            assert repo.swap("net", 2) == 1
            for t in threads:
                t.join(60)
        assert not errors, errors[:3]
        assert seen_v2.is_set()


class _CountingModel:
    """Function entry that counts executions: make_program constructions
    show up as bucket misses, prewarm's forced first call as an
    execution."""

    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def __call__(self, x):
        with self.lock:
            self.calls += 1
        return x * 2.0


class TestPrewarm:
    SIG = [{"shape": [None, 2], "dtype": "float32"}]

    def test_prewarm_builds_and_executes_every_bucket(self):
        repo = ModelRepository()
        model = _CountingModel()
        repo.add_function("m", model, self.SIG)
        with ModelServer(repo, _cfg(max_batch_size=8)) as srv:
            out = srv.prewarm("m")
            assert out["buckets"] == [1, 2, 4, 8]
            assert out["compiled"] == 4 and out["disk_hits"] == 0
            entry = repo.get("m")
            assert srv.batcher.programs(entry) == 4
            assert model.calls == 4
            misses = srv.batcher.bucket_misses
            got = srv.predict("m", np.ones((3, 2), np.float32),
                              timeout=60)
            np.testing.assert_allclose(got, np.full((3, 2), 2.0))
            assert srv.batcher.bucket_misses == misses

    def test_prewarm_non_pow2_cap_and_static_entry(self):
        repo = ModelRepository()
        repo.add_function("dyn", _CountingModel(), self.SIG)
        repo.add_function("static", _CountingModel(),
                          [{"shape": [4, 2], "dtype": "float32"}],
                          dynamic_batch=False)
        with ModelServer(repo, _cfg(max_batch_size=6)) as srv:
            assert srv.prewarm("dyn")["buckets"] == [1, 2, 4, 6]
            assert srv.prewarm("static")["buckets"] == [4]

    def test_prewarm_staged_version_then_swap_serves_without_compile(
            self):
        repo = ModelRepository()
        m1, m2 = _CountingModel(), _CountingModel()
        repo.add_function("m", m1, self.SIG, version=1)
        repo.add_function("m", m2, self.SIG, version=2, activate=False)
        with ModelServer(repo, _cfg(max_batch_size=4)) as srv:
            srv.predict("m", np.ones((1, 2), np.float32), timeout=60)
            assert srv.prewarm("m", version=2)["buckets"] == [1, 2, 4]
            misses = srv.batcher.bucket_misses
            assert repo.swap("m", 2) == 1
            for n in (1, 2, 3, 4):
                srv.predict("m", np.ones((n, 2), np.float32),
                            timeout=60)
            assert srv.batcher.bucket_misses == misses
            assert m2.calls == 3 + 4

    def test_prewarm_swap_under_concurrent_load(self):
        repo = ModelRepository()
        repo.add_function("m", lambda x: x * 2.0, self.SIG, version=1)
        repo.add_function("m", lambda x: x * 3.0, self.SIG, version=2,
                          activate=False)
        errors = []
        stop = threading.Event()

        with ModelServer(repo, _cfg(max_batch_size=4,
                                    max_latency_us=500)) as srv:
            def caller():
                x = np.ones((1, 2), np.float32)
                while not stop.is_set():
                    try:
                        got = srv.predict("m", x, timeout=60)
                    except Exception as e:      # noqa: BLE001
                        errors.append(e)
                        return
                    if not (np.allclose(got, 2.0)
                            or np.allclose(got, 3.0)):
                        errors.append(AssertionError(repr(got)))
                        return
            threads = [threading.Thread(target=caller)
                       for _ in range(4)]
            for t in threads:
                t.start()
            try:
                srv.prewarm("m", version=2)
                v2 = repo._resolve("m", 2)
                progs_at_swap = srv.batcher.programs(v2)
                repo.swap("m", 2)
                deadline = time.monotonic() + 30
                while not np.allclose(
                        srv.predict("m", np.ones((1, 2), np.float32),
                                    timeout=60), 3.0):
                    assert time.monotonic() < deadline
            finally:
                stop.set()
                for t in threads:
                    t.join(60)
            assert not errors, errors[:3]
            assert progs_at_swap == 3
            assert srv.batcher.programs(v2) == 3
            misses_settled = srv.batcher.bucket_misses
            for n in (1, 2, 3, 4):
                srv.predict("m", np.ones((n, 2), np.float32),
                            timeout=60)
            assert srv.batcher.bucket_misses == misses_settled

    def test_prewarm_summary_ignores_concurrent_other_entry_builds(
            self):
        repo = ModelRepository()
        repo.add_function("other", lambda x: x, self.SIG)
        other = repo.get("other")
        target = _CountingModel()
        repo.add_function("m", target, self.SIG)
        entry = repo.get("m")
        batcher = serving.DynamicBatcher(_cfg(max_batch_size=4))
        real = entry.make_program
        side = {"bucket": 16}

        def make_program_with_traffic(rows):
            side["bucket"] += 1
            batcher.program_for(other, side["bucket"])
            return real(rows)
        entry.make_program = make_program_with_traffic
        out = repo.prewarm("m", batcher=batcher)
        assert out["buckets"] == [1, 2, 4]
        assert out["compiled"] == 3 and out["disk_hits"] == 0
        assert batcher.bucket_misses == 6

    def test_prewarm_staged_needs_explicit_version(self):
        repo = ModelRepository()
        repo.add_function("m", _CountingModel(), self.SIG,
                          activate=False)
        with ModelServer(repo, _cfg()) as srv:
            with pytest.raises(MXNetError, match="no active version"):
                srv.prewarm("m")
            srv.prewarm("m", version=1)

    def test_prewarm_unknown_model_and_version(self):
        repo = ModelRepository()
        repo.add_function("m", _CountingModel(), self.SIG)
        with ModelServer(repo, _cfg()) as srv:
            with pytest.raises(MXNetError, match="no model"):
                srv.prewarm("ghost")
            with pytest.raises(MXNetError, match="no version"):
                srv.prewarm("m", version=9)

    def test_program_build_runs_outside_the_batcher_lock(self):
        repo = ModelRepository()
        repo.add_function("slow", lambda x: x, self.SIG)
        repo.add_function("fast", lambda x: x + 1.0, self.SIG)
        slow, fast = repo.get("slow"), repo.get("fast")
        batcher = serving.DynamicBatcher(_cfg(max_batch_size=4))
        batcher.program_for(fast, 1)
        in_build = threading.Event()
        release = threading.Event()
        builds = []
        real = slow.make_program

        def blocking_make_program(rows):
            builds.append(rows)
            in_build.set()
            assert release.wait(30)
            return real(rows)
        slow.make_program = blocking_make_program
        results = []
        builders = [threading.Thread(
            target=lambda: results.append(batcher.program_for(slow, 1)))
            for _ in range(3)]
        for t in builders:
            t.start()
        assert in_build.wait(30)
        t0 = time.monotonic()
        assert batcher.program_for(fast, 1) is not None
        assert time.monotonic() - t0 < 5
        release.set()
        for t in builders:
            t.join(30)
        assert builds == [1]
        assert len(results) == 3
        assert all(r is results[0] for r in results)
        assert batcher.programs(slow) == 1

    def test_failed_build_wakes_waiters_and_retries(self):
        repo = ModelRepository()
        repo.add_function("m", lambda x: x, self.SIG)
        entry = repo.get("m")
        real = entry.make_program
        state = {"calls": 0}

        def flaky(rows):
            state["calls"] += 1
            if state["calls"] == 1:
                raise RuntimeError("transient compile failure")
            return real(rows)
        entry.make_program = flaky
        batcher = serving.DynamicBatcher(_cfg(max_batch_size=4))
        with pytest.raises(RuntimeError, match="transient"):
            batcher.program_for(entry, 1)
        assert batcher.program_for(entry, 1) is not None
        assert state["calls"] == 2


class TestConfig:
    def test_env_defaults(self, monkeypatch):
        monkeypatch.setenv("MXNET_SERVING_MAX_BATCH", "16")
        monkeypatch.setenv("MXNET_SERVING_SHED_WATERMARK", "9")
        cfg = ServingConfig()
        assert cfg.max_batch_size == 16
        assert cfg.shed_watermark == 9
        assert cfg.queue_depth == 128
        assert (cfg.num_workers, cfg.max_latency_us) == (1, 2000)
        assert (cfg.circuit_window, cfg.circuit_threshold,
                cfg.circuit_cooldown_ms) == (20, 0.5, 1000.0)
        assert cfg.deadline_default is None and cfg.spec_draft is None

    def test_validation(self):
        with pytest.raises(MXNetError, match="max_batch_size"):
            ServingConfig(max_batch_size=0)
        with pytest.raises(MXNetError, match="shed_watermark"):
            ServingConfig(queue_depth=4, shed_watermark=9)
        with pytest.raises(MXNetError, match="max_latency_us"):
            ServingConfig(max_latency_us=-1)
        with pytest.raises(MXNetError, match="retry_after_ms"):
            ServingConfig(retry_after_ms=-1)
        with pytest.raises(MXNetError, match="num_workers"):
            ServingConfig(num_workers=0)
        with pytest.raises(MXNetError, match="circuit_threshold"):
            ServingConfig(circuit_threshold=0.0)
        with pytest.raises(MXNetError, match="deadline_default"):
            ServingConfig(deadline_default=0)


# ------------------------------------------------------ the bucket program
class _DropNorm(nn.Module):
    """A block with a buffer and train-mode behaviour: BatchNorm (running
    statistics) and dropout."""

    def __init__(self):
        super().__init__()
        self.net = _mlp(40)
        self.norm = nn.BatchNorm1d(4)
        self.drop = nn.Dropout(0.5)

    def forward(self, x):
        return self.drop(self.norm(self.net(x)))


class TestBucketProgram:
    def test_snapshot_is_independent_of_the_live_module(self):
        """The served copy holds its own parameters and buffers in eval
        mode with no gradients: training the live module afterwards
        (parameters, running statistics, gradients) changes nothing
        served, and dropout is off."""
        live = _DropNorm()
        x = _x(4)
        live.train()
        live(torch.from_numpy(x)).sum().backward()   # grads + BN stats
        live.eval()
        want = _ref(live, x)
        live.train()
        repo = ModelRepository()
        entry = repo.add_block("m", live, x)
        prog = entry.make_program(4)
        snap = prog.module
        assert not snap.training
        live_t = dict(live.named_parameters())
        live_t.update(live.named_buffers())
        for name, t in list(snap.named_parameters()) \
                + list(snap.named_buffers()):
            assert t.data_ptr() != live_t[name].data_ptr(), name
            assert not t.requires_grad and t.grad is None, name
        with torch.no_grad():
            for p in live.parameters():
                p.add_(1.0)
            live(torch.from_numpy(x))               # moves running stats
        np.testing.assert_allclose(prog(x)[0], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(prog(x)[0], prog(x)[0])

    def test_static_buffers_keep_their_addresses(self):
        """Every call stages into the same static input buffers (what a
        captured graph replays over), whatever the inputs."""
        net = _mlp(41)
        repo = ModelRepository()
        entry = repo.add_block("m", net, _x(4))
        prog = entry.make_program(4)
        ptrs = [a.data_ptr() for a in prog.args] + [prog._dev.data_ptr()]
        for seed in range(5):
            x = _x(4, seed=seed)
            np.testing.assert_allclose(prog(x)[0], _ref(net, x),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(prog.args[0].numpy(), x)
        assert [a.data_ptr() for a in prog.args] \
            + [prog._dev.data_ptr()] == ptrs

    def test_mixed_dtype_inputs_stage_into_one_buffer(self):
        """Inputs of several dtypes (BERT's int32 tokens and lengths
        beside float32) share the one packed buffer, each view in its
        signature dtype on a 16-byte boundary."""
        class Mixed(nn.Module):
            def forward(self, ids, scale, lens):
                return ids.float() * scale + lens[:, None].float()

        repo = ModelRepository()
        ids = np.arange(6, dtype=np.int32).reshape(2, 3)
        scale = np.full((2, 3), 0.5, np.float32)
        lens = np.array([7, 9], np.int64)
        entry = repo.add_block("m", Mixed(), ids, scale, lens)
        assert [s["dtype"] for s in entry.signature] == \
            ["int32", "float32", "int64"]
        prog = entry.make_program(2)
        assert [a.dtype for a in prog.args] == \
            [torch.int32, torch.float32, torch.int64]
        assert all((a.data_ptr() - prog._dev.data_ptr()) % 16 == 0
                   for a in prog.args)
        np.testing.assert_allclose(prog(ids, scale, lens)[0],
                                   ids * 0.5 + lens[:, None])

    def test_concurrent_calls_return_each_callers_rows(self):
        """Several threads calling ONE program at once each get the
        result of their own inputs: the program holds its lock from
        staging through readback."""
        net = _mlp(42)
        repo = ModelRepository()
        entry = repo.add_block("m", net, _x(4))
        prog = entry.make_program(4)
        errors = []

        def caller(seed):
            try:
                for k in range(25):
                    x = _x(4, seed=100 * seed + k)
                    np.testing.assert_allclose(prog(x)[0], _ref(net, x),
                                               rtol=1e-6, atol=1e-6)
            except Exception as e:      # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=caller, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors[:2]

    def test_unload_drops_programs_and_snapshot(self):
        """Unloading a version evicts its programs; once the caller
        drops its entry, nothing keeps the programs or the weight
        snapshot alive."""
        repo = ModelRepository()
        net = _mlp(43)
        x = _x(2)
        repo.add_block("m", net, x)
        repo.add_block("m", _mlp(44), x, activate=False)
        with ModelServer(repo, _cfg(max_batch_size=4)) as srv:
            srv.prewarm("m")
            entry = repo.get("m")
            progs = [srv.batcher.program_for(entry, b) for b in (1, 2, 4)]
            assert len({id(p.module) for p in progs}) == 1
            refs = [weakref.ref(p) for p in progs]
            snap = weakref.ref(progs[0].module)
            del progs
            repo.swap("m", 2)
            repo.unload("m", 1)
            assert srv.batcher.programs(entry) == 0
            del entry
            gc.collect()
            assert all(r() is None for r in refs)
            assert snap() is None
            np.testing.assert_allclose(srv.predict("m", x, timeout=60),
                                       _ref(_mlp(44), x), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------- parity with the JAX
ATOL = 1e-5
BERT_KW = dict(vocab_size=64, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0)
L = 32


def _requests(n=12, seed=0):
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        rows = int(rs.choice([1, 2, 3, 5]))
        reqs.append((rs.randint(0, 64, (rows, L)).astype(np.int32),
                     rs.randint(0, 2, (rows, L)).astype(np.int32),
                     rs.randint(1, L + 1, rows).astype(np.int32)))
    return reqs


def _serve(srv, model, reqs):
    out = [None] * len(reqs)

    def one(i):
        out[i] = srv.predict(model, *reqs[i], timeout=300)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert all(o is not None for o in out)
    return out


def test_bert_classifier_predict_matches_jax_model_server():
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
    reqs = _requests()
    cfg = dict(max_batch_size=8, max_latency_us=20_000, num_workers=2)
    repo = ModelRepository()
    repo.add_block("bert", tclf, *example)
    with ModelServer(repo, ServingConfig(**cfg)) as srv:
        got = _serve(srv, "bert", reqs)
        stats = srv.stats()
    jrepo = jserving.ModelRepository()
    jrepo.add_block("bert", jclf, *(nd.array(a, dtype="int32")
                                    for a in example))
    with jserving.ModelServer(jrepo, jserving.ServingConfig(**cfg)) as jsrv:
        want = _serve(jsrv, "bert", reqs)
    for req, g, w in zip(reqs, got, want):
        assert g.shape == (req[0].shape[0], 2)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    assert stats["completed"] == len(reqs)
    assert stats["programs"] <= len(serving.bucket_set(8))
