"""PyTorch port, training durability: ``CheckpointManager``
(``mxnet_tpu_torch/parallel/checkpoint.py``) — the atomic ``LATEST``
marker, the ``VERIFY-<step>.json`` manifest and the fallback to the
previous verified step, ``EXTRA-<step>.json``, retention, the
SIGTERM/preemption hook, and the in-place restore a captured trainer
needs.

Twins of ``tests/test_checkpoint_signal.py`` (all 13) and of
``TestCorruptPayloadFallback`` in ``tests/test_faults_train.py`` (7).
The reference drives the marker logic through a fake Orbax backend; the
port has its own on-disk format, so the twins run the real one, and a
save that is not followed by ``wait()`` is the torn window (its step
directory is listed, no barrier has verified it).  New here: a
graphs-mode trainer restored on the CPU keeps every tensor's address
and gets the saved state back bit for bit; a name, shape or dtype that
does not match raises before any tensor is written; a save that a step
follows at once still writes the state the save read; and the same
save / corrupt / restore sequence gives the JAX manager's verdicts.
"""
import contextlib
import os
import signal

import numpy as np
import pytest
import torch

from mxnet_tpu import faults as jfaults
from mxnet_tpu.parallel import CheckpointManager as JaxCheckpointManager
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.models import torch_bert as tm
from mxnet_tpu_torch import parallel as tpar
import mxnet_tpu_torch.parallel.checkpoint as cp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import CheckpointManager


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


class FakeTrainer:
    """The reference's fake trainer, with numpy leaves (the port saves
    tensors and numpy arrays)."""

    def __init__(self, val=1.0):
        self.params = {"w": np.full(2, val, np.float32)}
        self.opt_state = {"m": np.zeros(2, np.float32)}


def _settle(m):
    """Let the write in flight finish without a barrier (the state a
    killed process leaves on disk, minus the kill)."""
    if m._writer is not None:
        m._writer.join(30)
        assert not m._writer.is_alive()


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint_signal.py
# ---------------------------------------------------------------------------
class TestMarker:
    def test_marker_advances_only_at_the_barrier(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, FakeTrainer())
        # save returned: the step directory is listed, the marker is not
        # there yet
        assert m.all_steps() == [1]
        assert m.latest_verified_step() is None
        m.wait()
        assert m.latest_verified_step() == 1
        assert m.latest_step() == 1

    def test_kill_mid_save_restores_last_verified(self, tmp_path):
        """A kill between save(2) and its durability barrier must leave
        restore() on step 1 — the listing says 2 (torn), the marker says
        1 (verified)."""
        m = CheckpointManager(tmp_path)
        m.save(1, FakeTrainer(1.0))
        m.wait()
        m.save(2, FakeTrainer(2.0))     # ... killed here: no wait()
        _settle(m)

        # a fresh process opens the same directory
        m2 = CheckpointManager(tmp_path)
        assert m2.all_steps() == [1, 2]
        t = FakeTrainer(0.0)
        step = m2.restore(t)
        assert step == 1
        np.testing.assert_array_equal(t.params["w"], 1.0)

    def test_marker_beats_backend_listing(self, tmp_path):
        """The torn step stays in the directory listing; the marker pins
        restore to the verified step."""
        m = CheckpointManager(tmp_path)
        m.save(1, FakeTrainer(1.0))
        m.wait()
        m.save(2, FakeTrainer(2.0))
        _settle(m)
        assert max(m.all_steps()) == 2
        assert m.latest_step() == 1     # marker wins
        t = FakeTrainer(0.0)
        assert m.restore(t) == 1
        np.testing.assert_array_equal(t.params["w"], 1.0)

    def test_marker_write_is_atomic(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(3, FakeTrainer())
        m.wait()
        # no tmp leftovers; content is exactly the step
        assert not os.path.exists(m._marker_path + ".tmp")
        with open(m._marker_path) as f:
            assert f.read().strip() == "3"
        # a corrupted marker degrades to the directory listing
        with open(m._marker_path, "w") as f:
            f.write("garbage")
        assert m.latest_verified_step() is None
        assert m.latest_step() == 3


class TestSaveOnSignal:
    def test_sigterm_saves_then_chains(self, tmp_path):
        chained = []
        prev = signal.signal(signal.SIGTERM,
                             lambda s, f: chained.append(s))
        try:
            m = CheckpointManager(tmp_path)
            trainer = FakeTrainer(7.0)
            m.save_on_signal(trainer, step_fn=lambda: 42)
            signal.raise_signal(signal.SIGTERM)
            # one synchronous save + barrier + marker, then the chain
            assert m.latest_verified_step() == 42
            t = FakeTrainer(0.0)
            assert m.restore(t) == 42
            np.testing.assert_array_equal(t.params["w"], 7.0)
            assert chained == [signal.SIGTERM]
            # uninstall restores the previous handler
            m.remove_signal_handlers()
            signal.raise_signal(signal.SIGTERM)
            assert chained == [signal.SIGTERM, signal.SIGTERM]
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_step_fn_evaluated_at_signal_time(self, tmp_path):
        prev = signal.signal(signal.SIGTERM, lambda s, f: None)
        try:
            m = CheckpointManager(tmp_path)
            box = {"step": 0}
            m.save_on_signal(FakeTrainer(), step_fn=lambda: box["step"])
            box["step"] = 9
            signal.raise_signal(signal.SIGTERM)
            assert m.latest_verified_step() == 9
            m.remove_signal_handlers()
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_failed_signal_save_still_chains(self, tmp_path):
        chained = []
        prev = signal.signal(signal.SIGTERM,
                             lambda s, f: chained.append(s))
        try:
            m = CheckpointManager(tmp_path)
            m.save(1, FakeTrainer(1.0))
            m.wait()

            def bad_step():
                raise RuntimeError("no step available")

            m.save_on_signal(FakeTrainer(), step_fn=bad_step)
            signal.raise_signal(signal.SIGTERM)
            # marker untouched, previous handler still ran
            assert m.latest_verified_step() == 1
            assert chained == [signal.SIGTERM]
            m.remove_signal_handlers()
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_step_fn_must_be_callable(self, tmp_path):
        m = CheckpointManager(tmp_path)
        with pytest.raises(MXNetError, match="zero-arg callable"):
            m.save_on_signal(FakeTrainer(), step_fn=5)

    def test_context_exit_removes_handlers(self, tmp_path):
        prev = signal.getsignal(signal.SIGTERM)
        with CheckpointManager(tmp_path) as m:
            m.save_on_signal(FakeTrainer(), step_fn=lambda: 1)
            assert signal.getsignal(signal.SIGTERM) is not prev
        assert signal.getsignal(signal.SIGTERM) is prev


class TestRealBackendMarker:
    def test_roundtrip_marker(self, tmp_path):
        """The marker over a synchronous save of tensors; the restore
        writes into the trainer's own tensor."""
        class T:
            params = {"w": torch.ones(2)}
            opt_state = {"m": torch.zeros(2)}

        t = T()
        with CheckpointManager(tmp_path, async_write=False) as m:
            m.save(5, t)
            m.wait()
            assert m.latest_verified_step() == 5
            t.params = {"w": torch.zeros(2)}
            ptr = t.params["w"].data_ptr()
            assert m.restore(t) == 5
            np.testing.assert_array_equal(t.params["w"].numpy(),
                                          np.ones(2))
            assert t.params["w"].data_ptr() == ptr


class TestReviewHardening:
    def test_gc_collected_marker_falls_back_to_backend(self, tmp_path):
        """The marker's step may vanish (retention deleted it after
        later saves landed without a barrier): restore falls back to the
        newest step on disk, not wedge on the vanished one."""
        m = CheckpointManager(tmp_path)
        m.save(5, FakeTrainer(5.0))
        m.wait()
        m.save(6, FakeTrainer(6.0))
        m.wait()
        assert m.latest_verified_step() == 6
        # marker at 6; the disk loses 6 and gains 7
        os.rename(m._step_dir(6), m._step_dir(7))
        assert m.all_steps() == [5, 7]
        assert m.latest_step() == 7
        t = FakeTrainer(0.0)
        assert m.restore(t) == 7
        np.testing.assert_array_equal(t.params["w"], 6.0)

    def test_none_previous_disposition_still_terminates(self, tmp_path,
                                                        monkeypatch):
        """signal.signal() returns None for a C-installed handler; the
        chain re-raises with the default action (the process
        terminates), never swallows the signal."""
        actions = []
        prev = signal.signal(signal.SIGTERM, lambda s, f: None)
        try:
            m = CheckpointManager(tmp_path)
            m.save_on_signal(FakeTrainer(3.0), step_fn=lambda: 7)
            handler = signal.getsignal(signal.SIGTERM)
            m._signal_prev[signal.SIGTERM] = None   # C-level unknown
            monkeypatch.setattr(
                cp._signal, "signal",
                lambda s, h: actions.append(("reset", h)))
            monkeypatch.setattr(
                cp._signal, "raise_signal",
                lambda s: actions.append(("raise", s)))
            handler(signal.SIGTERM, None)
            assert m.latest_verified_step() == 7    # save still ran
            assert ("reset", signal.SIG_DFL) in actions
            assert ("raise", signal.SIGTERM) in actions
            m._signal_prev[signal.SIGTERM] = prev
            monkeypatch.undo()
            m.remove_signal_handlers()
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_sig_ign_previous_disposition_is_respected(self, tmp_path):
        prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
        try:
            m = CheckpointManager(tmp_path)
            m.save_on_signal(FakeTrainer(), step_fn=lambda: 1)
            signal.raise_signal(signal.SIGTERM)     # must NOT kill us
            assert m.latest_verified_step() == 1
            m.remove_signal_handlers()
        finally:
            signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# twins of TestCorruptPayloadFallback (tests/test_faults_train.py)
# ---------------------------------------------------------------------------
class _TinyState:
    def __init__(self, value=0.0):
        self.params = {"w": np.full(4, value, np.float32)}
        self.opt_state = {"m": np.zeros(4, np.float32)}


class TestCorruptPayloadFallback:
    def _manager_with_steps(self, tmp_path, steps=(1, 2)):
        mngr = CheckpointManager(tmp_path / "ckpt", max_to_keep=4,
                                 async_write=False)
        holder = _TinyState()
        for step in steps:
            holder.params["w"] = np.full(4, float(step), np.float32)
            mngr.save(step, holder, extra={"step": step})
            mngr.wait()
        return mngr

    def test_bit_flipped_blob_falls_back_with_warning(self, tmp_path,
                                                      caplog):
        mngr = self._manager_with_steps(tmp_path)
        assert mngr.latest_verified_step() == 2
        flipped = cp._flip_payload_byte(mngr._step_dir(2))
        assert flipped is not None
        target = _TinyState()
        with caplog.at_level("WARNING", logger="mxnet_tpu_torch"):
            step = mngr.restore(target)
        assert step == 1
        np.testing.assert_allclose(target.params["w"], 1.0)
        assert any("falling back" in r.message for r in caplog.records)
        mngr.close()

    def test_explicit_step_still_raises_on_corruption(self, tmp_path):
        mngr = self._manager_with_steps(tmp_path)
        cp._flip_payload_byte(mngr._step_dir(2))
        with pytest.raises(MXNetError, match="damaged"):
            mngr.restore(_TinyState(), step=2)
        mngr.close()

    def test_injected_save_corruption_detected(self, tmp_path):
        mngr = CheckpointManager(tmp_path / "c", async_write=False)
        holder = _TinyState()
        holder.params["w"] = np.full(4, 1.0, np.float32)
        mngr.save(1, holder)
        mngr.wait()
        with faults.plan("checkpoint.save=corrupt,times=1"):
            holder.params["w"] = np.full(4, 2.0, np.float32)
            mngr.save(2, holder)
            mngr.wait()                 # barrier fires the bit flip
        target = _TinyState()
        assert mngr.restore(target) == 1
        np.testing.assert_allclose(target.params["w"], 1.0)
        mngr.close()

    def test_restore_fail_site_raises_typed(self, tmp_path):
        mngr = self._manager_with_steps(tmp_path, steps=(1,))
        with faults.plan("checkpoint.restore=fail,times=1"):
            with pytest.raises(faults.InjectedFault):
                mngr.restore(_TinyState())
        assert mngr.restore(_TinyState()) == 1
        mngr.close()

    def test_residuals_ride_the_checkpoint_tree(self, tmp_path):
        holder = _TinyState()
        holder.residuals = {"w": np.full(4, 0.25, np.float32)}
        mngr = CheckpointManager(tmp_path / "c", async_write=False)
        mngr.save(1, holder)
        mngr.wait()
        target = _TinyState()
        target.residuals = {"w": np.zeros(4, np.float32)}
        assert mngr.restore(target) == 1
        np.testing.assert_allclose(target.residuals["w"], 0.25)
        mngr.close()

    def test_unbarriered_newer_step_never_auto_restored(self,
                                                        tmp_path):
        """A step saved but killed before its barrier (no manifest,
        NEWER than the marker) is torn by definition: when the marker
        step rots, fallback goes OLDER."""
        mngr = self._manager_with_steps(tmp_path, steps=(1, 2))
        holder = _TinyState(3.0)
        mngr.save(3, holder)            # kill before wait(): no
        mngr._pending = []              # manifest, marker stays at 2
        assert mngr.latest_verified_step() == 2
        cp._flip_payload_byte(mngr._step_dir(2))
        target = _TinyState()
        assert mngr.restore(target) == 1
        np.testing.assert_allclose(target.params["w"], 1.0)
        mngr.close()

    def test_extra_payload_roundtrip_and_gc(self, tmp_path):
        mngr = CheckpointManager(tmp_path / "c", max_to_keep=2,
                                 async_write=False)
        holder = _TinyState()
        for step in (1, 2, 3, 4):
            mngr.save(step, holder, extra={"losses": [0.1] * step})
            mngr.wait()
        assert mngr.load_extra(4) == {"losses": [0.1] * 4}
        # retention deleted steps 1/2: their sidecars are gone too
        assert mngr.all_steps() == [3, 4]
        assert mngr.load_extra(1) is None
        assert not (tmp_path / "c" / "VERIFY-1.json").exists()
        mngr.close()


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------
KW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
          num_heads=4, max_length=32, dropout=0.0)
B, L, M = 2, 24, 5


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    valid = np.asarray([L, L // 2 + 1], np.float32)
    return (rs.randint(0, 64, (B, L)).astype(np.int32),
            (np.arange(L)[None] >= L // 2).astype(np.int32).repeat(B, 0),
            valid,
            np.stack([rs.choice(int(v), M, replace=False)
                      for v in valid]).astype(np.int32),
            rs.randint(0, 64, (B, M)).astype(np.int32),
            rs.randint(0, 2, (B,)).astype(np.int32))


def _trainer(seed=0):
    head = tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", use_flash=True, device="cpu",
        generator=torch.Generator().manual_seed(seed), **KW), vocab_size=64)
    return tpar.ShardedTrainer(
        head, tm.pretrain_loss, tpar.make_mesh(device="cpu"),
        optimizer="adamw", optimizer_params={"learning_rate": 1e-3},
        example_inputs=_batch()[:4], n_labels=2)


def _state(trainer):
    return cp._trainer_state(trainer)


def test_captured_trainer_restore_keeps_addresses(tmp_path):
    """Restore into a graphs-mode trainer copies into its own tensors:
    every parameter, buffer and optimizer tensor (the AdamW step
    included) keeps its ``data_ptr()`` and equals the saved state bit
    for bit, and the next step repeats the step taken after the save."""
    trainer = _trainer()
    for seed in (3, 4):
        trainer.step(*_batch(seed))
    saved = {n: t.detach().clone() for n, t in _state(trainer).items()}
    assert "opt_state/step" in saved and int(saved["opt_state/step"]) == 2
    mngr = CheckpointManager(tmp_path)
    mngr.save(2, trainer)
    mngr.wait()
    after_save = trainer.step(*_batch(5))
    trainer.step(*_batch(6))
    ptrs = {n: t.data_ptr() for n, t in _state(trainer).items()}
    assert mngr.restore(trainer) == 2
    state = _state(trainer)
    assert {n: t.data_ptr() for n, t in state.items()} == ptrs
    for n, t in saved.items():
        assert torch.equal(state[n], t), n
    assert torch.equal(trainer.step(*_batch(5)), after_save)
    mngr.close()


@pytest.mark.parametrize("change", ["shape", "dtype", "name"])
def test_mismatch_raises_before_any_tensor_changes(tmp_path, change):
    class T:
        def __init__(self, b):
            self.params = {"a": torch.zeros(4), **b}
            self.opt_state = {"m": torch.zeros(3)}

    mngr = CheckpointManager(tmp_path, async_write=False)
    mngr.save(1, T({"b": torch.zeros(5)}))
    mngr.wait()
    other = {"shape": {"b": torch.ones(6)},
             "dtype": {"b": torch.ones(5, dtype=torch.bfloat16)},
             "name": {"c": torch.ones(5)}}[change]
    target = T(other)
    target.params["a"].fill_(1.0)
    target.opt_state["m"].fill_(1.0)
    with pytest.raises(MXNetError, match="step 1"):
        mngr.restore(target, step=1)
    for t in (target.params["a"], target.opt_state["m"],
              *other.values()):
        assert bool((t == 1).all())


def test_async_save_then_step_writes_the_saved_state(tmp_path):
    """An asynchronous save that a step follows at once writes the state
    the save read, not the state the step leaves."""
    trainer = _trainer()
    trainer.step(*_batch(3))
    saved = {n: t.detach().clone() for n, t in _state(trainer).items()}
    mngr = CheckpointManager(tmp_path, async_write=True)
    mngr.save(1, trainer)
    trainer.step(*_batch(4))            # in place, while the write runs
    mngr.wait()
    fresh = _trainer(seed=1)
    assert mngr.restore(fresh) == 1
    for n, t in _state(fresh).items():
        assert torch.equal(t, saved[n]), n
    mngr.close()


def test_fallback_matches_the_jax_manager(tmp_path):
    """The same saves, barrier corruption and restore through the JAX
    package's manager (Orbax) and the port's: the same marker, retained
    steps, restored step and values, and extra payloads."""
    out = {}
    for pkg, manager_cls, fmod in (
            ("jax", JaxCheckpointManager, jfaults),
            ("torch", CheckpointManager, faults)):
        mngr = manager_cls(tmp_path / pkg, max_to_keep=2,
                           async_write=False)
        holder = _TinyState()
        for step in (1, 2, 3):
            holder.params["w"] = np.full(4, float(step), np.float32)
            spec = "checkpoint.save=corrupt,times=1" if step == 3 else None
            with fmod.plan(spec) if spec else contextlib.nullcontext():
                mngr.save(step, holder, extra={"step": step})
                mngr.wait()
        rows = [mngr.latest_verified_step(), sorted(mngr.all_steps())]
        target = _TinyState()
        rows += [mngr.restore(target), target.params["w"].tolist(),
                 mngr.load_extra(2), mngr.load_extra(1)]
        mngr.close()
        out[pkg] = rows
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == [3, [2, 3], 2]
