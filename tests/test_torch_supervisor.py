"""PyTorch port, training durability: the fault sites of the training
plane, ``run_with_deadline`` / ``StepWatchdog``, the checkpointable
``io.NDArrayIter``, the eager RNG state (``mxnet_tpu_torch.random``) and
``TrainingSupervisor`` (``mxnet_tpu_torch/parallel/supervisor.py``).

Twins of the single-process tests of ``tests/test_faults_train.py``:
``TestTrainingFaultSites`` (the kvstore sites wait for the multi-GPU
item), ``TestStepWatchdog``, ``TestCheckpointableIterator``,
``TestRNGStateCheckpoint`` and ``TestTrainingSupervisor``; the
corrupt-payload twins are in ``tests/test_torch_checkpoint.py``.  The
numpy trainer draws its noise from the port's RNG, so resuming on the
uninterrupted trajectory needs params, optimizer state, data cursor and
RNG stream all restored.

Against the JAX package, on the same numpy inputs: the port's
``NDArrayIter`` yields the JAX iterator's batches bit for bit, cursor
round trip included, for every ``last_batch_handle``; a numpy trainer
without RNG supervised under the same fault specs by both packages gives
the same losses, restarts and last verified step, bit for bit; and a
small BERT ``ShardedTrainer`` supervised through a kill and a corrupt
restore follows its uninterrupted run bit for bit and the JAX trainer's
losses within atol 1e-4.  Also: a ``KernelError`` is not restarted, and
a step abandoned by the watchdog does not update the trainer after a
restore (the generation guard).
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu import io as jio
from mxnet_tpu import models as jm
from mxnet_tpu import nd
from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import faults, io
from mxnet_tpu_torch.models import torch_bert as tm
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import runtime_metrics as rm
from mxnet_tpu_torch.base import KernelError, MXNetError
from mxnet_tpu_torch.parallel import (CheckpointManager, CrashLoopError,
                                      StepWatchdog, TrainingSupervisor,
                                      TrainStepTimeoutError,
                                      run_with_deadline)
from mxnet_tpu_torch.parallel import supervisor as supervisor_mod
from mxnet_tpu_torch.parallel.checkpoint import _trainer_state


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()
    # under MXNET_ENGINE_SANITIZE=1: no checkpoint writer or watchdog
    # worker outlives its test unless it was deliberately abandoned
    tengine.check_thread_leaks()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(getattr(x, "asnumpy", lambda: x)())


class NumpyTrainer:
    """Deterministic toy trainer on numpy: momentum SGD on least squares
    plus one draw of the port's eager RNG per step (``noise=True``), so
    resume follows the uninterrupted run only if params, opt state, data
    cursor AND the RNG stream are all restored.  ``fault_mod`` is the
    package whose ``train.step`` site the step fires."""

    def __init__(self, n_features=4, lr=0.05, noise=True, fault_mod=faults):
        rs = np.random.RandomState(0)
        self.params = {"w": rs.randn(n_features).astype(np.float32)}
        self.opt_state = {"m": np.zeros(n_features, np.float32)}
        self.lr = lr
        self.noise = noise
        self.fault_mod = fault_mod

    def step(self, data, label):
        self.fault_mod.inject("train.step")
        w = np.asarray(self.params["w"])
        m = np.asarray(self.opt_state["m"])
        x, y = _np(data), _np(label)
        pred = x @ w
        grad = 2 * x.T @ (pred - y) / len(y)
        if self.noise:
            grad = grad + trandom.uniform(
                shape=w.shape, device="cpu").numpy() * 1e-3
        m = 0.9 * m + grad
        w = w - self.lr * m
        self.params = {"w": w.astype(np.float32)}
        self.opt_state = {"m": m.astype(np.float32)}
        return float(np.mean((pred - y) ** 2))


def _dataset(n=30, n_features=4):
    rs = np.random.RandomState(1)
    x = rs.randn(n, n_features).astype(np.float32)
    y = (x @ np.arange(1, n_features + 1).astype(np.float32)) \
        .astype(np.float32)
    return x, y


def _supervised_run(ckpt_dir, spec=None, num_steps=12, save_every=3,
                    batch_size=6, record=None, **sup_kw):
    """One supervised training run; returns (losses, supervisor,
    fired-fault counters)."""
    trandom.seed(7)
    x, y = _dataset()
    it = io.NDArrayIter(x, y, batch_size=batch_size, shuffle=True,
                        seed=11)
    trainer = NumpyTrainer()
    manager = CheckpointManager(ckpt_dir, max_to_keep=4,
                                async_write=False)

    def step_fn(tr, batch):
        if record is not None:
            record.append((supervisor._step,
                           float(batch.data[0].numpy().sum())))
        return tr.step(batch.data[0], batch.label[0])

    supervisor = TrainingSupervisor(
        trainer, manager, it, step_fn=step_fn, save_every=save_every,
        backoff_ms=sup_kw.pop("backoff_ms", 1),
        backoff_max_ms=sup_kw.pop("backoff_max_ms", 2), **sup_kw)
    if spec:
        faults.install(spec)
    try:
        losses = supervisor.run(num_steps)
    finally:
        plan = faults.active()
        faults.clear()
        manager.close()
    return losses, supervisor, plan.counters() if plan else {}


def _watchdog_workers():
    return {t for t in threading.enumerate()
            if t.name.startswith("mxnet-watchdog")}


def _join_new_watchdog_workers(before, timeout=10.0):
    """Wait for the watchdog workers started since ``before`` (a
    :func:`_watchdog_workers` set) to finish; True when all did."""
    deadline = time.monotonic() + timeout
    new = _watchdog_workers() - before
    for t in new:
        t.join(max(0.0, deadline - time.monotonic()))
    return not any(t.is_alive() for t in new)


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------
class TestTrainingFaultSites:
    def test_data_next_site(self):
        x, y = _dataset(12)
        it = io.NDArrayIter(x, y, batch_size=4)
        with faults.plan("train.data.next=fail,times=1"):
            with pytest.raises(faults.InjectedFault) as err:
                it.next()
            assert err.value.site == "train.data.next"
            assert err.value.transient
            # the failed call did not consume the batch
            batch = it.next()
            assert batch.data[0].shape[0] == 4
            np.testing.assert_array_equal(batch.data[0].numpy(), x[:4])

    def test_fake_trainer_step_site(self):
        tr = NumpyTrainer()
        x, y = _dataset(6)
        with faults.plan("train.step=fail,times=1"):
            with pytest.raises(faults.InjectedFault):
                tr.step(x, y)
            assert tr.step(x, y) > 0

    def test_train_glob_matches_all_training_sites(self):
        plan = faults.FaultPlan.parse("train.*=fail")
        assert plan.rules[0].matches("train.step")
        assert plan.rules[0].matches("train.data.next")
        assert not plan.rules[0].matches("kvstore.push")


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
def _linear_trainer(**kw):
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 4)
    x = np.ones((2, 4), np.float32)
    return tpar.ShardedTrainer(
        net, lambda out, lab: ((out - lab) ** 2).mean(),
        tpar.make_mesh(device="cpu"), optimizer="sgd",
        example_inputs=(x,), n_labels=1, **kw), x


class TestStepWatchdog:
    def test_wedged_step_typed_timeout_no_leaked_thread(self):
        release = threading.Event()
        before = {t.name for t in threading.enumerate()}
        t0 = time.monotonic()
        with pytest.raises(TrainStepTimeoutError) as err:
            run_with_deadline(lambda: release.wait(30), 150,
                              site="train.step")
        elapsed = time.monotonic() - t0
        assert elapsed < 5, elapsed          # deadline, not the wedge
        assert err.value.transient
        assert "150" in str(err.value)
        # unwedge the fake step: the abandoned worker must exit
        release.set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            leaked = {t.name for t in threading.enumerate()} - before
            if not any(n.startswith("mxnet-watchdog") for n in leaked):
                break
            time.sleep(0.01)
        leaked = {t.name for t in threading.enumerate()} - before
        assert not any(n.startswith("mxnet-watchdog") for n in leaked)

    def test_zero_timeout_runs_in_caller_thread(self):
        seen = []
        run_with_deadline(lambda: seen.append(
            threading.current_thread().name), 0)
        assert seen == [threading.current_thread().name]

    def test_result_and_exception_propagate(self):
        assert run_with_deadline(lambda: 41 + 1, 1000) == 42
        with pytest.raises(ZeroDivisionError):
            run_with_deadline(lambda: 1 // 0, 1000)

    def test_straggler_detection(self, monkeypatch):
        # the watchdog reads a fake clock that only the watched steps
        # advance: 2 ms six times, then 50 ms, whatever the host's load
        class _Clock:
            t = 0.0

            def perf_counter(self):
                return self.t

            def advance(self, seconds):
                self.t += seconds

            def __getattr__(self, name):
                return getattr(time, name)

        clock = _Clock()
        monkeypatch.setattr(supervisor_mod, "time", clock)
        wd = StepWatchdog(timeout_ms=0, slow_factor=3.0)
        assert wd.active
        for _ in range(6):
            wd.watch(lambda: clock.advance(0.002))
        assert wd.slow_steps == 0
        wd.watch(lambda: clock.advance(0.05))
        assert wd.slow_steps == 1
        state = wd.debug_state()
        assert state["slow_steps"] == 1 and state["observed"] == 7

    def test_inactive_by_default(self, monkeypatch):
        monkeypatch.delenv("MXNET_TRAIN_STEP_TIMEOUT_MS",
                           raising=False)
        monkeypatch.delenv("MXNET_TRAIN_SLOW_STEP_FACTOR",
                           raising=False)
        assert not StepWatchdog().active
        trainer, _ = _linear_trainer()
        assert not trainer.watchdog.active

    def test_stall_fault_is_bounded_by_the_deadline(self):
        """train.step ``stall`` (the wedged-step chaos shape) fires
        INSIDE the watched call, so the deadline bounds it instead of
        the sleep hanging the train-loop thread."""
        wd = StepWatchdog(timeout_ms=150, slow_factor=0)

        def body():
            faults.inject("train.step")
            return 1.0

        with faults.plan("train.step=stall,ms=60000,times=1"):
            t0 = time.monotonic()
            with pytest.raises(TrainStepTimeoutError):
                wd.watch(body)
            assert time.monotonic() - t0 < 5

    def test_abandoned_worker_cannot_clobber_restored_state(self):
        """After a timeout the worker's eventual result is discarded:
        the caller got the typed timeout, not the late result."""
        release = threading.Event()
        finished = threading.Event()

        def wedged():
            release.wait(30)
            finished.set()
            return "poisoned result"

        with pytest.raises(TrainStepTimeoutError):
            run_with_deadline(wedged, 100)
        release.set()
        assert finished.wait(5)

    def test_sharded_trainer_wedged_step(self):
        """The real step() wiring: a wedged step raises the typed
        timeout within the deadline instead of hanging.  The reference
        arms its 300 ms deadline before the first step, which compiles
        under it, and it flaked once under load; here the step is warmed
        first and the deadline armed after, so the deadline times only
        the wedge."""
        trainer, x = _linear_trainer(step_timeout_ms=300,
                                     slow_step_factor=0)
        assert trainer.watchdog.active
        assert trainer.watchdog.timeout_ms == 300
        trainer.watchdog.timeout_ms = 0         # warm, unwatched
        assert float(trainer.step(x, x)) >= 0
        trainer.watchdog.timeout_ms = 300       # armed
        assert float(trainer.step(x, x)) >= 0   # a watched step
        release = threading.Event()
        trainer._train_step = lambda args: (release.wait(30),
                                            torch.zeros(()))[1]
        before = _watchdog_workers()
        t0 = time.monotonic()
        try:
            with pytest.raises(TrainStepTimeoutError):
                trainer.step(x, x)
            assert time.monotonic() - t0 < 5
            assert trainer.watchdog.timeouts == 1
        finally:
            release.set()
        assert _join_new_watchdog_workers(before)

    def test_trainer_refuses_multi_gpu_options(self):
        """Multi-rank training is ported (``test_torch_parallel_tp.py``):
        ``compression=`` on a dp x tp mesh and ``rules=`` that are not
        ``ShardingRules`` raise; on one card ``compression=`` runs the
        quantization of a dp of one."""
        dp_tp = tpar.Mesh("cpu", {"dp": 2, "tp": 2, "sp": 1, "ep": 1})
        with pytest.raises(MXNetError, match="pure data-parallel"):
            tpar.ShardedTrainer(torch.nn.Linear(4, 4),
                                lambda out, lab: ((out - lab) ** 2).mean(),
                                dp_tp, example_inputs=(np.ones((2, 4)),),
                                compression="int8")
        with pytest.raises(MXNetError, match="ShardingRules"):
            _linear_trainer(rules={})
        trainer, x = _linear_trainer(compression="int8")
        assert float(trainer.step(x, x)) >= 0
        assert trainer.residuals and trainer.wire_bytes_per_step > 0
        assert trainer.extra_state() == {"quant_step": 1}


# ---------------------------------------------------------------------------
# iterator cursor + RNG state
# ---------------------------------------------------------------------------
def _drive(it, n, as_np=_np):
    out = []
    for _ in range(n):
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        out.append((as_np(b.data[0]).copy(), as_np(b.label[0]).copy(),
                    b.pad))
    return out


class TestCheckpointableIterator:
    @pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
    def test_cursor_roundtrip_mid_epochs(self, handle):
        x, y = _dataset(20)
        make = lambda: io.NDArrayIter(  # noqa: E731
            x, y, batch_size=3, shuffle=True,
            last_batch_handle=handle, seed=5)
        it = make()
        _drive(it, 9)                   # into the second epoch
        cursor = it.get_cursor()
        want = _drive(it, 8)
        it2 = make()
        it2.set_cursor(cursor)
        got = _drive(it2, 8)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a[0], b[0])

    def test_unseeded_shuffle_not_checkpointable(self):
        x, y = _dataset(9)
        it = io.NDArrayIter(x, y, batch_size=3, shuffle=True)
        with pytest.raises(MXNetError, match="seed"):
            it.get_cursor()
        # unshuffled iterators are checkpointable without a seed
        it = io.NDArrayIter(x, y, batch_size=3)
        assert it.get_cursor()["epoch"] == 0

    def test_cursor_config_mismatch_refused(self):
        x, y = _dataset(12)
        it = io.NDArrayIter(x, y, batch_size=3, seed=1)
        cursor = it.get_cursor()
        other = io.NDArrayIter(x, y, batch_size=4, seed=1)
        with pytest.raises(MXNetError, match="batch_size"):
            other.set_cursor(cursor)
        other = io.NDArrayIter(x[:9], y[:9], batch_size=3, seed=1)
        with pytest.raises(MXNetError, match="num_data"):
            other.set_cursor(cursor)
        shuffled = io.NDArrayIter(x, y, batch_size=3, shuffle=True,
                                  seed=1)
        with pytest.raises(MXNetError, match="shuffle"):
            shuffled.set_cursor(cursor)

    def test_seeded_epochs_are_reproducible(self):
        x, y = _dataset(12)
        orders = []
        for _ in range(2):
            it = io.NDArrayIter(x, y, batch_size=4, shuffle=True,
                                seed=9)
            epoch = [it.next().data[0].numpy().copy() for _ in range(3)]
            orders.append(np.concatenate(epoch))
        np.testing.assert_array_equal(orders[0], orders[1])

    @pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
    def test_batches_equal_the_jax_iterator(self, handle):
        """The port's iterator against the JAX package's on the same
        arrays: the same batches, labels and pads bit for bit over three
        epochs, and after a cursor taken mid-epoch and set on a fresh
        iterator of each package."""
        x, y = _dataset(20)
        kw = dict(batch_size=3, shuffle=True, last_batch_handle=handle,
                  seed=5)
        jit_, tit = jio.NDArrayIter(x, y, **kw), io.NDArrayIter(x, y, **kw)
        for a, b in zip(_drive(jit_, 20), _drive(tit, 20)):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        cursor = tit.get_cursor()
        assert cursor == jit_.get_cursor()
        jit2, tit2 = jio.NDArrayIter(x, y, **kw), io.NDArrayIter(x, y, **kw)
        jit2.set_cursor(cursor)
        tit2.set_cursor(cursor)
        for a, b in zip(_drive(jit2, 9), _drive(tit2, 9)):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        batch = io.NDArrayIter(x, y, **kw).next()
        for t in batch.data + batch.label:
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"


class TestRNGStateCheckpoint:
    def test_roundtrip_bit_exact(self):
        trandom.seed(3)
        trandom.uniform(shape=(4,), device="cpu")   # advance stream
        state = trandom.get_state()
        want = [trandom.uniform(shape=(3,), device="cpu")
                for _ in range(3)]
        want.append(trandom.normal(shape=(2,), device="cpu"))
        trandom.set_state(state)
        got = [trandom.uniform(shape=(3,), device="cpu")
               for _ in range(3)]
        got.append(trandom.normal(shape=(2,), device="cpu"))
        for a, b in zip(want, got):
            assert torch.equal(a, b)

    def test_state_is_json_serializable(self):
        import json
        state = trandom.get_state()
        assert json.loads(json.dumps(state)) == state


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------
class TestTrainingSupervisor:
    def test_bit_exact_resume_after_midstep_kill(self, tmp_path):
        ref, _sup, _ = _supervised_run(tmp_path / "ref")
        chaos, sup, fired = _supervised_run(
            tmp_path / "chaos",
            spec="train.step=fail,after=5,times=1")
        assert fired["train.step:fail"] == 1
        assert sup.restarts == 1
        assert chaos == ref             # bit-exact trajectory
        assert sup.debug_state()["latest_verified_step"] == 12

    def test_resume_sees_exactly_batch_k_plus_1(self, tmp_path):
        ref_batches, chaos_batches = [], []
        _supervised_run(tmp_path / "r", record=ref_batches)
        _supervised_run(tmp_path / "c", record=chaos_batches,
                        spec="train.step=fail,after=7,times=1")
        ref_by_step = dict(ref_batches)
        for step, checksum in chaos_batches:
            assert checksum == ref_by_step[step], step
        steps = [s for s, _ in chaos_batches]
        assert sorted(set(steps)) == list(range(12))
        assert len(steps) > 12          # the kill forced replays

    def test_kill_during_checkpoint_save(self, tmp_path):
        ref, _s, _ = _supervised_run(tmp_path / "ref")
        chaos, sup, fired = _supervised_run(
            tmp_path / "chaos",
            spec="checkpoint.save=fail,after=1,times=1")
        assert fired["checkpoint.save:fail"] == 1
        assert sup.restarts == 1
        assert chaos == ref

    def test_corrupt_marker_checkpoint_plus_kill(self, tmp_path):
        """Corrupt the newest verified payload, then kill: restore falls
        back one checkpoint further and the trajectory still matches the
        twin."""
        ref, _s, _ = _supervised_run(tmp_path / "ref")
        chaos, sup, fired = _supervised_run(
            tmp_path / "chaos",
            spec="train.step=fail,after=7,times=1;"
                 "checkpoint.save=corrupt,after=2,times=1")
        assert fired == {"train.step:fail": 1,
                         "checkpoint.save:corrupt": 1}
        assert sup.restarts == 1
        assert chaos == ref

    def test_transient_restore_failure_stays_supervised(self, tmp_path):
        ref, _s, _ = _supervised_run(tmp_path / "ref")
        chaos, sup, fired = _supervised_run(
            tmp_path / "chaos",
            spec="train.step=fail,after=5,times=1;"
                 "checkpoint.restore=fail,times=1")
        assert fired == {"train.step:fail": 1,
                         "checkpoint.restore:fail": 1}
        assert sup.restarts == 2        # the kill + the restore blip
        assert chaos == ref

    def test_transient_restore_failures_trip_the_breaker(self, tmp_path):
        with pytest.raises(CrashLoopError):
            _supervised_run(tmp_path / "c",
                            spec="train.step=fail,after=5,times=1;"
                                 "checkpoint.restore=fail",
                            max_restarts=3)

    def test_unseeded_shuffle_iter_degrades_to_warning(self, tmp_path,
                                                       caplog):
        x, y = _dataset(18)
        it = io.NDArrayIter(x, y, batch_size=6, shuffle=True)
        mngr = CheckpointManager(tmp_path / "c", async_write=False)
        sup = TrainingSupervisor(
            NumpyTrainer(), mngr, it, save_every=2, backoff_ms=1,
            step_fn=lambda t, b: t.step(b.data[0], b.label[0]))
        with caplog.at_level("WARNING", logger="mxnet_tpu_torch"):
            losses = sup.run(4)
        assert len(losses) == 4
        assert sum("cursor unavailable" in r.message
                   for r in caplog.records) == 1
        assert mngr.load_extra(4)["cursor"] is None
        mngr.close()

    def test_explicit_step_corrupt_injection_applies(self, tmp_path):
        mngr = CheckpointManager(tmp_path / "c", async_write=False)
        holder = NumpyTrainer()
        mngr.save(1, holder)
        mngr.wait()
        assert mngr._verify_step(1) == (True, "verified")
        with faults.plan("checkpoint.restore=corrupt,times=1") as plan:
            with pytest.raises(MXNetError, match="damaged"):
                mngr.restore(NumpyTrainer(), step=1)
            assert plan.counters()["checkpoint.restore:corrupt"] == 1
        # the fired counter corresponds to a REAL on-disk effect
        ok, why = mngr._verify_step(1)
        assert not ok and "mismatch" in why
        mngr.close()

    def test_deterministic_failure_reraises(self, tmp_path):
        boom = ValueError("shape mismatch")

        def bad_step(_trainer, _batch):
            raise boom

        x, y = _dataset(12)
        it = io.NDArrayIter(x, y, batch_size=4, seed=1)
        mngr = CheckpointManager(tmp_path / "c", async_write=False)
        sup = TrainingSupervisor(NumpyTrainer(), mngr, it,
                                 step_fn=bad_step, backoff_ms=1)
        with pytest.raises(ValueError):
            sup.run(4)
        assert sup.restarts == 0
        mngr.close()

    def test_crash_loop_breaker_trips(self, tmp_path):
        with pytest.raises(CrashLoopError) as err:
            _supervised_run(tmp_path / "c", spec="train.step=fail",
                            max_restarts=2)
        assert err.value.restarts == 2
        assert isinstance(err.value.last_error, faults.InjectedFault)

    def test_backoff_is_jittered_exponential_and_bounded(self,
                                                         tmp_path,
                                                         monkeypatch):
        sleeps = []
        import mxnet_tpu_torch.parallel.supervisor as sup_mod
        monkeypatch.setattr(sup_mod.time, "sleep",
                            lambda s: sleeps.append(s))
        _losses, sup, _ = _supervised_run(
            tmp_path / "c", spec="train.step=fail,after=2,times=3",
            backoff_ms=8, backoff_max_ms=20)
        assert sup.restarts == 3
        lo, hi = 8 / 1e3, 20 / 1e3
        assert len(sleeps) == 3
        assert lo * 0.5 <= sleeps[0] <= lo          # 8ms * U[.5,1)
        assert lo <= sleeps[1] <= 2 * lo            # 16ms * U[.5,1)
        assert hi * 0.5 <= sleeps[2] <= hi          # capped at 20ms

    def test_progress_resets_the_breaker(self, tmp_path):
        chaos, sup, fired = _supervised_run(
            tmp_path / "c",
            spec="train.step=fail,after=3,times=1;"
                 "train.step=fail,after=8,times=1",
            max_restarts=2, num_steps=10)
        assert sup.restarts == 2
        assert fired["train.step:fail"] == 2    # aggregated rules
        assert len(chaos) == 10
        assert sup.debug_state()["consecutive_failures"] == 0

    def test_step_timeout_is_supervised(self, tmp_path):
        release = threading.Event()
        wedge = {"armed": True}
        watchdog = StepWatchdog(timeout_ms=200, slow_factor=0)

        def step_fn(trainer, batch):
            def body():
                if wedge.pop("armed", None):
                    release.wait(30)    # the wedged step
                return trainer.step(batch.data[0], batch.label[0])
            return watchdog.watch(body)

        before = _watchdog_workers()
        try:
            x, y = _dataset()
            it = io.NDArrayIter(x, y, batch_size=6, seed=1)
            mngr = CheckpointManager(tmp_path / "c", async_write=False)
            sup = TrainingSupervisor(NumpyTrainer(), mngr, it,
                                     step_fn=step_fn, save_every=3,
                                     backoff_ms=1, backoff_max_ms=2)
            losses = sup.run(6)
            assert len(losses) == 6
            assert sup.restarts == 1
            assert watchdog.timeouts == 1
            mngr.close()
        finally:
            release.set()
        assert _join_new_watchdog_workers(before)

    def test_cross_process_resume_from_anchor(self, tmp_path):
        ref, _s, _ = _supervised_run(tmp_path / "ref", num_steps=12)
        first, _s2, _ = _supervised_run(tmp_path / "c", num_steps=6)
        resumed, sup, _ = _supervised_run(tmp_path / "c", num_steps=12)
        assert resumed == ref
        assert first == ref[:6]

    def test_restart_metrics_published(self, tmp_path):
        rm.enable()
        rm.reset()
        try:
            _losses, sup, _ = _supervised_run(
                tmp_path / "c", spec="train.step=fail,after=4,times=1")
            assert rm.TRAIN_RESTARTS.value() == 1
            snap = rm.snapshot()
            recovery = snap["train.recovery.seconds"]["values"][""]
            assert recovery["count"] == 1
        finally:
            rm.disable()
            rm.reset()

    def test_debug_state_shape(self, tmp_path):
        _losses, sup, _ = _supervised_run(tmp_path / "c")
        state = sup.debug_state()
        assert state["step"] == 12
        assert state["restarts"] == 0
        assert state["crash_loop_tripped"] is False
        assert state["latest_verified_step"] == 12


# ---------------------------------------------------------------------------
# against the JAX package, and the port's own rules
# ---------------------------------------------------------------------------
SPECS = ["train.step=fail,after=5,times=1",
         "train.step=fail,after=7,times=1;"
         "checkpoint.save=corrupt,after=2,times=1",
         "train.step=fail,after=5,times=1;checkpoint.restore=fail,times=1",
         "train.step=fail,after=3,times=1;train.step=fail,after=8,times=1"]


@pytest.mark.parametrize("spec", SPECS)
def test_supervisor_matches_jax_under_the_same_faults(tmp_path, spec):
    """A numpy trainer without RNG draws, supervised by each package
    over its own iterator and checkpoint manager on the same arrays
    under the same fault spec: the same losses bit for bit, the same
    restarts, fired faults and last verified step."""
    x, y = _dataset()
    out = {}
    for pkg, fmod, iomod, par in (("jax", jfaults, jio, jpar),
                                  ("torch", faults, io, tpar)):
        it = iomod.NDArrayIter(x, y, batch_size=6, shuffle=True, seed=11)
        trainer = NumpyTrainer(noise=False, fault_mod=fmod)
        mngr = par.CheckpointManager(tmp_path / pkg, max_to_keep=4,
                                     async_write=False)
        sup = par.TrainingSupervisor(
            trainer, mngr, it, save_every=3, backoff_ms=1,
            backoff_max_ms=2,
            step_fn=lambda t, b: t.step(b.data[0], b.label[0]))
        with fmod.plan(spec) as plan:
            losses = sup.run(12)
            fired = plan.counters()
        mngr.close()
        out[pkg] = (losses, sup.restarts, fired,
                    sup.debug_state()["latest_verified_step"])
    assert out["torch"] == out["jax"]
    assert len(out["torch"][0]) == 12 and out["torch"][1] >= 1


def test_kernel_error_is_not_restarted(tmp_path):
    """A kernel or graph failure is deterministic: the supervisor
    re-raises it at once, with zero restarts and no restore."""
    x, y = _dataset(12)
    it = io.NDArrayIter(x, y, batch_size=4, seed=1)
    mngr = CheckpointManager(tmp_path / "c", async_write=False)
    calls = []

    def step_fn(trainer, batch):
        calls.append(1)
        if len(calls) == 2:
            raise KernelError("the flash kernel refused its inputs")
        return trainer.step(batch.data[0], batch.label[0])

    sup = TrainingSupervisor(NumpyTrainer(), mngr, it, step_fn=step_fn,
                             backoff_ms=1)
    with pytest.raises(KernelError):
        sup.run(4)
    assert sup.restarts == 0 and len(calls) == 2
    assert sup.losses == [sup.losses[0]]
    mngr.close()


# the narrow BERT of tests/test_torch_parallel.py
KW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
          num_heads=4, max_length=32, dropout=0.0)
B, L, M, ROWS = 2, 24, 5, 8


def _rows(seed=0):
    rs = np.random.RandomState(seed)
    valid = rs.randint(L // 2, L + 1, ROWS).astype(np.float32)
    feats = [rs.randint(0, 64, (ROWS, L)).astype(np.int32),
             (np.arange(L)[None] >= L // 2).astype(np.int32).repeat(ROWS, 0),
             valid,
             np.stack([rs.choice(int(v), M, replace=False)
                       for v in valid]).astype(np.int32)]
    labels = [rs.randint(0, 64, (ROWS, M)).astype(np.int32),
              rs.randint(0, 2, (ROWS,)).astype(np.int32)]
    return feats, labels


def _bert_head(seed=0):
    return tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", use_flash=True, device="cpu",
        generator=torch.Generator().manual_seed(seed), **KW), vocab_size=64)


def _bert_trainer(head=None):
    feats, _ = _rows()
    return tpar.ShardedTrainer(
        head if head is not None else _bert_head(), tm.pretrain_loss,
        tpar.make_mesh(device="cpu"),
        optimizer="adamw", optimizer_params={"learning_rate": 1e-3},
        example_inputs=[f[:B] for f in feats], n_labels=2)


def _jax_loss(outputs, mlm_y, nsp_y):
    import jax.numpy as jnp
    mlm_scores, nsp_scores = outputs
    mlm_lp = jax.nn.log_softmax(mlm_scores.astype(jnp.float32), -1)
    nsp_lp = jax.nn.log_softmax(nsp_scores.astype(jnp.float32), -1)
    return (-jnp.take_along_axis(mlm_lp, mlm_y[..., None], -1).mean()
            - jnp.take_along_axis(nsp_lp, nsp_y[:, None], -1).mean())


def _supervise(trainer, par, iomod, fmod, ckpt, spec):
    feats, labels = _rows()
    it = iomod.NDArrayIter(feats, labels, batch_size=B, shuffle=True,
                           seed=3)
    mngr = par.CheckpointManager(ckpt, max_to_keep=2, async_write=True)
    sup = par.TrainingSupervisor(trainer, mngr, it, save_every=2,
                                 backoff_ms=1, backoff_max_ms=2)
    with (fmod.plan(spec) if spec else contextlib.nullcontext()) as plan:
        losses = sup.run(6)
        fired = plan.counters() if plan else {}
    mngr.close()
    return [float(v) for v in losses], sup.restarts, fired


def test_supervised_bert_trainer_follows_uninterrupted_and_jax(tmp_path):
    """The slice on the CPU: a graphs-mode BERT ``ShardedTrainer``
    supervised through a mid-step kill and a corrupt restore (which
    falls back to the step-0 anchor) gives its uninterrupted run's six
    losses bit for bit, and the JAX ``ShardedTrainer`` supervised from
    the same weights under the same spec gives them within atol 1e-4
    (the tolerance of ``test_graph_steps_match_jax_three_adamw_steps``)."""
    spec = "train.step=fail,after=3,times=1;checkpoint.restore=corrupt,times=1"
    ref, r0, _ = _supervise(_bert_trainer(), tpar, io, faults,
                            tmp_path / "ref", None)
    got, restarts, fired = _supervise(_bert_trainer(), tpar, io, faults,
                                      tmp_path / "chaos", spec)
    assert r0 == 0 and restarts == 1
    assert fired == {"train.step:fail": 1, "checkpoint.restore:corrupt": 1}
    assert got == ref

    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", use_flash=True, **KW)
    jbert.initialize()
    jhead = jm.BERTForPretrain(jbert, vocab_size=64)
    jhead.initialize()
    pre = jhead.prefix
    np_params = {(k[len(pre):] if k.startswith(pre) else k):
                 v.data().asnumpy() for k, v in jhead.collect_params().items()}
    ttr = _bert_trainer(_bert_head().load_numpy_params(np_params))
    feats, _ = _rows()
    jtr = jpar.ShardedTrainer(
        jhead, _jax_loss,
        jpar.make_mesh(dp=1, tp=1, sp=1, devices=jax.devices()[:1]),
        optimizer="adamw", optimizer_params={"learning_rate": 1e-3},
        example_inputs=tuple(nd.array(f[:B], dtype=str(f.dtype))
                             for f in feats), n_labels=2)
    tl, _, _ = _supervise(ttr, tpar, io, faults, tmp_path / "t", spec)
    jl, jr, _ = _supervise(jtr, jpar, jio, jfaults, tmp_path / "j", spec)
    assert jr == 1
    np.testing.assert_allclose(tl, jl, atol=1e-4)


def test_abandoned_step_does_not_update_after_restore(tmp_path):
    """The generation guard on the CPU trainer with ``graphs=True`` (the
    staging path a graph replays over): a step stalled by the
    ``train.step`` fault times out, the trainer is restored, and when
    the stalled step wakes it returns without running the step — the
    restored state, optimizer step count included, is untouched."""
    trainer = _bert_trainer()
    feats, labels = _rows()
    batch = [a[:B] for a in feats + labels]
    trainer.step(*batch)
    mngr = CheckpointManager(tmp_path, async_write=False)
    mngr.save(1, trainer)
    mngr.wait()
    ran = []
    inner = trainer._train_step
    trainer._train_step = lambda args: (ran.append(1), inner(args))[1]
    trainer.watchdog = StepWatchdog(timeout_ms=150, slow_factor=0)
    before = _watchdog_workers()
    with faults.plan("train.step=stall,ms=1500,times=1"):
        with pytest.raises(TrainStepTimeoutError):
            trainer.step(*batch)
        assert mngr.restore(trainer) == 1
        state = {n: t.detach().clone()
                 for n, t in _trainer_state(trainer).items()}
        assert _join_new_watchdog_workers(before)
    assert ran == []
    for n, t in _trainer_state(trainer).items():
        assert torch.equal(t, state[n]), n
    assert int(trainer.opt_state["step"]) == 1
    trainer.watchdog = StepWatchdog(timeout_ms=0, slow_factor=0)
    trainer.step(*batch)
    assert ran == [1] and int(trainer.opt_state["step"]) == 2
    mngr.close()
