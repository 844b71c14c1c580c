"""Asynchronous checkpoints of the one-card trainer, with crash safety.

The PyTorch port of ``mxnet_tpu.parallel.checkpoint``.  The JAX package
writes Orbax/TensorStore checkpoints; the port has its own on-disk
format:

    <directory>/step_<n>/state.pt    the flat state {name: CPU tensor},
                                     torch.save, read back with
                                     torch.load(weights_only=True)
    <directory>/VERIFY-<n>.json      {"step", "files": {path: sha256}}
    <directory>/EXTRA-<n>.json       the extra payload saved with step n
    <directory>/LATEST               the newest verified step

    mngr = CheckpointManager(dir, max_to_keep=3)
    mngr.save(step, trainer)               # snapshot now, write async
    mngr.restore(trainer)                  # latest; or restore(t, step=n)
    mngr.wait()                            # the durability barrier

The state is the trainer's ``params``, ``buffers`` and ``opt_state``
(the AdamW step tensor included), flattened to names such as
``params/<name>`` and ``opt_state/mean/<name>``.

- **Snapshot before write.**  ``save`` copies the state device -> host
  into pinned staging buffers on the caller's stream (after that stream
  waits for the trainer's), records an event and returns; a writer
  thread waits on the event and writes the step.  The writer reads only
  the host copies, never a device tensor.  The next step's in-place
  update cannot race the copy out: a step's stream waits for the
  caller's stream before it stages or replays
  (``parallel/trainer.py``, ``_StepProgram.__call__``).
- **Atomic last-step marker.**  A step's directory exists as soon as
  ``save`` returns, before its bytes are durable, so "the newest step
  directory" is not "a durable checkpoint".  ``LATEST`` is written by
  tmp + fsync + rename only at the durability barrier (:meth:`wait`),
  and ``restore`` prefers it: a kill mid-save restores the last
  verified checkpoint, never the torn one.
- **Per-step integrity manifest.**  At each barrier the manager writes
  ``VERIFY-<step>.json`` (relative path -> sha256 over the step
  directory), and auto-``restore()`` re-hashes against it first: a
  bit-flipped or torn payload at the marker step falls back to the
  previous verified step with a warning.  An explicit ``step=`` skips
  the fallback and raises on damage.
- **Extra payload.**  ``save(step, trainer, extra=...)`` persists a
  small JSON side-state (``EXTRA-<step>.json``, atomic, at the barrier)
  — the supervisor's RNG snapshot, data-iterator cursor and loss list,
  which make a resume follow the uninterrupted run.
- **Restore is in place.**  ``restore`` copies every loaded tensor into
  the trainer's own tensors with ``copy_`` and never rebinds them: a
  captured training step replays those addresses.  A name, shape or
  dtype that does not match raises before any tensor is written.  It
  first bumps the trainer's generation, so a step abandoned by the
  watchdog can no longer replay over the restored state.  Numpy state
  (the tests' stand-in trainers) is assigned back.
- **Sharded checkpoints.**  A trainer on a mesh of more than one rank
  (``torch.distributed``) saves one payload per rank,
  ``step_<n>/shard-<rank>-of-<world>.pt``: ``{"state": its local
  shards, "layout": the mesh shape, its coordinates and every
  parameter's placement}``.  Every rank calls ``save`` / ``wait`` /
  ``restore`` (they are collectives).  Rank 0 prepares the step
  directory, then all ranks write; at the barrier each rank hashes its
  own payload, the verdicts are gathered, and only when every rank's
  payload is verified does rank 0 write the one ``VERIFY-<n>.json``
  (all ranks' files) and move ``LATEST``.  ``restore`` agrees on one
  step across the ranks (a step any rank cannot verify or read falls
  back for all), checks that the layout matches the trainer's, and
  copies each shard back in place at the same placements, so captured
  graphs stay valid.  The compression residuals are per-rank tensors
  of the state; the step counter rides ``extra``.
- **``save_on_signal``** — a SIGTERM/preemption hook: one synchronous
  save + barrier + marker commit, then the previous handler (or the
  default action) runs.

Fault-injection sites (``mxnet_tpu_torch.faults``): ``checkpoint.save``
(fail/delay/stall at save; **corrupt** fires at the barrier and
bit-flips one payload byte of the just-verified step) and
``checkpoint.restore`` (fail/delay/stall at restore; **corrupt**
bit-flips the candidate step's payload before reading, which the
manifest check must turn into a fallback, never wrong weights).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import signal as _signal
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from .. import engine as _engine
from .. import faults as _faults
from ..base import MXNetError

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint"]

_LOG = logging.getLogger("mxnet_tpu_torch")

_MARKER = "LATEST"
_PAYLOAD = "state.pt"
_STEP_PREFIX = "step_"


def _flatten(prefix, tree, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(f"{prefix}/{key}", value, out)
    else:
        out[prefix] = tree


def _trainer_state(trainer):
    """The trainer's state as ``{name: leaf}``: ``params``, ``buffers``
    and ``opt_state`` (and the ``residuals`` a trainer may carry), each
    nested dict flattened to ``tree/key/...`` names.  Leaves are
    tensors or numpy arrays."""
    state = {}
    for tree in ("params", "buffers", "opt_state", "residuals"):
        value = getattr(trainer, tree, None)
        if value:
            _flatten(tree, value, state)
    return state


def _ranks(trainer):
    """``(rank, world)`` when ``trainer`` trains on a mesh of more than
    one rank (a sharded checkpoint), else None."""
    mesh = getattr(trainer, "mesh", None)
    if getattr(mesh, "groups", None) is None or not tdist.is_initialized():
        return None
    world = tdist.get_world_size()
    return None if world == 1 else (tdist.get_rank(), world)


def _layout(trainer):
    """What a rank's shards mean: the mesh, this rank's coordinates and
    each parameter's placement."""
    mesh = trainer.mesh
    return {"mesh": {a: int(n) for a, n in mesh.shape.items()},
            "coords": {a: int(c) for a, c in mesh.coords.items()},
            "placements": {n: [a for a in spec] for n, spec in
                           getattr(trainer, "placements", {}).items()}}


def _shard_name(rank, world):
    return f"shard-{rank}-of-{world}.pt"


def _all_agree(value):
    """Every rank's ``value`` (a collective over the default group)."""
    out = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, value)
    return out


def _as_tensor(leaf, name):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf)
    raise MXNetError(f"checkpoint: {name} is a {type(leaf).__name__}, "
                     f"not a tensor or a numpy array")


def _inject(site, modes):
    """Checkpoint-site fault hook.  fail raises, delay/stall sleep;
    a fired ``corrupt`` rule is RETURNED for the caller to apply to
    real bytes on disk (nothing useful flows through the call)."""
    plan = _faults.active()
    if plan is None:
        return None
    rule = plan.fire(site, modes=modes)
    if rule is None:
        return None
    if rule.mode == "fail":
        raise _faults.InjectedFault(site)
    if rule.mode in ("delay", "stall"):
        time.sleep(rule.ms / 1e3)
        return None
    return rule                         # corrupt


def _flip_payload_byte(root):
    """Bit-flip one byte of the largest payload file under ``root`` —
    the injected silent-rot / torn-write.  Returns the mutated path
    (or None when the directory holds nothing to corrupt)."""
    victim, size = None, -1
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            try:
                n = os.path.getsize(path)
            except OSError:
                continue
            if n > size:
                victim, size = path, n
    if victim is None or size <= 0:
        return None
    with open(victim, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    return victim


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """Rolling asynchronous checkpoints of a ``ShardedTrainer`` (or any
    object with ``params`` / ``opt_state`` dicts of tensors or numpy
    arrays).

    ``max_to_keep`` bounds the step directories kept (None: all); a
    save beyond it deletes the oldest step with its sidecars.
    ``async_write=False`` writes each step inline in :meth:`save`.
    ``timings`` holds the seconds of the last save's phases
    (``snapshot_s``: the device -> host copy, ``write_s``, then at the
    barrier ``hash_s`` and ``barrier_s``) and of the last restore's
    (``verify_s``, ``read_s``, ``copy_s``)."""

    def __init__(self, directory, max_to_keep: Optional[int] = 3,
                 async_write: bool = True):
        self._dir = os.path.abspath(str(directory))
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_write = bool(async_write)
        self._pending = []              # steps saved, durability unknown
        self._pending_extra = {}        # step -> extra payload (JSON)
        self._signal_prev = {}          # signum -> previous handler
        self._staging = {}              # name -> host tensor
        self._writer = None             # the async write in flight
        self._write_error = None
        self._shard = None              # (rank, world) of a sharded save
        self.timings = {}

    # ---------------------------------------------------------------- save
    def save(self, step: int, trainer, extra=None):
        """Snapshot ``trainer``'s state and queue its write as step
        ``step`` (rewriting a step already on disk).  ``extra``
        (JSON-serialisable: RNG snapshot, iterator cursor, ...) is
        persisted at the durability barrier beside the step; a save
        without ``extra`` keeps the one an earlier save of the same
        step left."""
        step = int(step)
        _inject("checkpoint.save", modes=("fail", "delay", "stall"))
        self._join_writer()         # the staging buffers are free again
        t0 = time.perf_counter()
        self._shard = _ranks(trainer)
        host, done = self._snapshot(trainer)
        root = self._step_dir(step)
        if self._shard is not None:
            # no rank is still writing an older step when rank 0 prunes,
            # and every rank writes into the directory rank 0 prepared
            host = {"state": host, "layout": _layout(trainer)}
            _all_agree(step)
        if self._shard is None or self._shard[0] == 0:
            if os.path.isdir(root):
                shutil.rmtree(root)
                self._remove_manifest(step)
            os.makedirs(root)
            self._retain(step)
        if self._shard is not None:
            _all_agree(step)
        # the marker only advances at the durability barrier (wait/
        # close/signal-save) — a queued save is not yet a fact
        self._pending.append(step)
        if extra is not None:
            self._pending_extra[step] = extra
        if self.async_write:
            self._writer = _engine.make_thread(
                self._write, name=f"mxnet-checkpoint-{step}",
                owner="CheckpointManager._writer",
                args=(root, host, done, t0))
            self._writer.start()
        else:
            self._write(root, host, done, t0)
            self._join_writer()

    def _snapshot(self, trainer):
        """Copy the state into host staging buffers (pinned for a CUDA
        tensor, reused from save to save).  Device copies are queued on
        the caller's stream after it waits for the trainer's stream;
        returns ``(host state, event)`` — the event, recorded after the
        copies, is None when no tensor is on a card."""
        state = {n: _as_tensor(v, n) for n, v in
                 _trainer_state(trainer).items()}
        for name in [n for n in self._staging if n not in state]:
            del self._staging[name]
        stream, trainer_stream = None, getattr(trainer, "_stream", None)
        host = {}
        for name, t in state.items():
            buf = self._staging.get(name)
            if buf is None or buf.shape != t.shape \
                    or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
                self._staging[name] = buf
            if t.is_cuda and stream is None:
                # the copies follow the last step's work on the trainer's
                # stream; the next step's in-place update cannot overtake
                # them, since a step's stream first waits for the
                # caller's (_StepProgram.__call__)
                stream = torch.cuda.current_stream(t.device)
                if trainer_stream is not None:
                    stream.wait_stream(trainer_stream)
            buf.copy_(t, non_blocking=t.is_cuda)
            host[name] = buf
        done = None
        if stream is not None:
            done = torch.cuda.Event()
            done.record(stream)
        return host, done

    def _write(self, root, host, done, t0):
        """Write one step (on the writer thread when ``async_write``):
        wait for the snapshot's copies, then ``torch.save`` into a tmp
        file, fsync, rename."""
        try:
            if done is not None:
                done.synchronize()
            t1 = time.perf_counter()
            path = os.path.join(root, self._payload_name())
            with open(path + ".tmp", "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(path + ".tmp", path)
            _fsync_dir(root)
            self.timings.update(snapshot_s=t1 - t0,
                                write_s=time.perf_counter() - t1)
        except BaseException as e:          # noqa: BLE001 — re-raised
            self._write_error = e

    def _payload_name(self, shard=None):
        shard = shard or self._shard
        return _PAYLOAD if shard is None else _shard_name(*shard)

    def _join_writer(self):
        """Wait for the write in flight; re-raise its failure."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise MXNetError(f"checkpoint: writing a step under "
                             f"{self._dir} failed: {err!r}") from err

    def _retain(self, newest):
        """Retention: keep the ``max_to_keep`` newest steps (``newest``
        included); delete the others with their sidecars."""
        if self.max_to_keep is None:
            return
        steps = sorted(set(self.all_steps()) | {newest}, reverse=True)
        for step in steps[int(self.max_to_keep):]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            self._remove_manifest(step)
            try:
                os.remove(self._extra_path(step))
            except OSError:
                pass

    def _remove_manifest(self, step):
        try:
            os.remove(self._manifest_path(step))
        except OSError:
            pass

    # ------------------------------------------------------------- restore
    def restore(self, trainer, step: Optional[int] = None) -> int:
        """Restore ``trainer``'s state in place; returns the restored
        step.  ``step=None`` walks the newest-verified-first candidate
        list: the atomic marker's step, then older retained steps —
        each integrity-checked against its barrier manifest before any
        bytes are trusted, so a corrupt/torn payload at the marker
        step FALLS BACK to the previous verified step with a warning
        instead of raising (or worse, loading rot).  An explicit
        ``step=`` restores exactly that step and raises on damage."""
        corrupt = _inject("checkpoint.restore",
                          modes=("fail", "delay", "stall", "corrupt"))
        self._shard = _ranks(trainer)
        if self._shard is not None:
            return self._restore_sharded(trainer, step)
        if step is not None:
            step = int(step)
            if corrupt is not None:
                flipped = _flip_payload_byte(self._step_dir(step))
                _LOG.warning("checkpoint: injected payload corruption "
                             "at step %d (%s)", step, flipped)
            ok, why = self._timed_verify(step)
            if not ok:
                raise MXNetError(f"checkpoint: step {step} under "
                                 f"{self._dir} is damaged: {why}")
            return self._restore_exact(trainer, step)
        candidates = self._candidate_steps()
        if not candidates:
            raise MXNetError(
                f"no checkpoint found under {self._dir}")
        if corrupt is not None:
            flipped = _flip_payload_byte(self._step_dir(candidates[0]))
            _LOG.warning("checkpoint: injected payload corruption at "
                         "step %d (%s)", candidates[0], flipped)
        verified = self.latest_verified_step()
        # while the marker step is still retained, any NEWER step
        # without a manifest never completed a barrier (kill mid-save)
        # — "no manifest" there means torn, and restoring it would also
        # skip its extra payload (RNG/cursor), breaking the resume.  A
        # STALE marker (its step already deleted by retention) proves
        # nothing about newer steps, so the best-available rule applies
        marker_retained = verified is not None and verified in candidates
        failures = []
        for cand in candidates:
            require = marker_retained and cand > verified
            ok, why = self._timed_verify(cand, require_manifest=require)
            if not ok:
                _LOG.warning(
                    "checkpoint: step %d payload corrupt/torn (%s) — "
                    "falling back to the previous verified step", cand,
                    why)
                failures.append((cand, why))
                continue
            try:
                return self._restore_exact(trainer, cand)
            except MXNetError as e:
                _LOG.warning(
                    "checkpoint: restore of step %d failed (%s) — "
                    "falling back to the previous verified step",
                    cand, e)
                failures.append((cand, repr(e)))
        raise MXNetError(
            f"no restorable checkpoint under {self._dir}: every "
            f"candidate failed verification or restore: {failures}")

    def _timed_verify(self, step, require_manifest=False):
        t0 = time.perf_counter()
        verdict = self._verify_step(step, require_manifest)
        self.timings["verify_s"] = time.perf_counter() - t0
        return verdict

    def _restore_exact(self, trainer, step: int) -> int:
        t0 = time.perf_counter()
        loaded = self._load_payload(trainer, step, _PAYLOAD)
        return self._copy_in(trainer, loaded, step, t0)

    def _load_payload(self, trainer, step, name):
        """Read payload ``name`` of ``step`` and check it against the
        trainer: the same names, shapes and dtypes (and, sharded, the
        same layout).  Returns the flat state; raises
        :class:`MXNetError` before anything is written."""
        path = os.path.join(self._step_dir(step), name)
        try:
            loaded = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:  # noqa: BLE001 — any unreadable payload
            raise MXNetError(f"checkpoint: cannot read step {step} "
                             f"({path}): {e!r}") from e
        if self._shard is not None:
            if not isinstance(loaded, dict) \
                    or loaded.get("layout") != _layout(trainer):
                raise MXNetError(
                    f"checkpoint: step {step}'s shard {name} was saved "
                    f"with another mesh or placements: "
                    f"{loaded.get('layout') if isinstance(loaded, dict) else None}"
                    f" vs the trainer's {_layout(trainer)}")
            loaded = loaded["state"]
        target = _trainer_state(trainer)
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            names = set(loaded) if isinstance(loaded, dict) else set()
            raise MXNetError(
                f"checkpoint: step {step} holds other state than the "
                f"trainer: missing {sorted(set(target) - names)[:4]}, "
                f"unexpected {sorted(names - set(target))[:4]}")
        for key, leaf in target.items():
            want, got = _as_tensor(leaf, key), loaded[key]
            if want.shape != got.shape or want.dtype != got.dtype:
                raise MXNetError(
                    f"checkpoint: step {step}: {key} is "
                    f"{tuple(got.shape)} {got.dtype}, the trainer's is "
                    f"{tuple(want.shape)} {want.dtype}")
        return loaded

    def _copy_in(self, trainer, loaded, step, t0):
        """Bump the trainer's generation, then ``copy_`` every loaded
        tensor into the trainer's own (addresses kept)."""
        t1 = time.perf_counter()
        target = _trainer_state(trainer)
        bump = getattr(trainer, "bump_generation", None)
        if bump is not None:
            bump()
        with torch.no_grad():
            for name, leaf in target.items():
                if isinstance(leaf, torch.Tensor):
                    leaf.copy_(loaded[name])
                else:
                    self._assign(trainer, name, loaded[name].numpy())
        self.timings.update(read_s=t1 - t0,
                            copy_s=time.perf_counter() - t1)
        return int(step)

    def _restore_sharded(self, trainer, step):
        """The collective restore of a sharded checkpoint: each rank
        verifies and reads its own shard of a candidate step, the ranks
        agree, and only a step every rank holds intact is copied in."""
        rank, world = self._shard
        name = _shard_name(rank, world)

        def attempt(cand, require):
            t0 = time.perf_counter()
            ok, why = self._verify_shard(cand, name, require)
            self.timings["verify_s"] = time.perf_counter() - t0
            loaded = None
            if ok:
                try:
                    loaded = self._load_payload(trainer, cand, name)
                except MXNetError as e:
                    why = str(e)
            bad = [(r, w) for r, w in enumerate(
                _all_agree(None if loaded is not None else why))
                if w is not None]
            return loaded, bad, t0

        if step is not None:
            step = int(step)
            loaded, bad, t0 = attempt(step, False)
            if bad:
                raise MXNetError(f"checkpoint: step {step} under "
                                 f"{self._dir} is damaged: {bad}")
            return self._copy_in(trainer, loaded, step, t0)
        candidates = self._candidate_steps()
        if not candidates:
            raise MXNetError(f"no checkpoint found under {self._dir}")
        verified = self.latest_verified_step()
        marker_retained = verified is not None and verified in candidates
        failures = []
        for cand in candidates:
            loaded, bad, t0 = attempt(
                cand, marker_retained and cand > verified)
            if not bad:
                return self._copy_in(trainer, loaded, cand, t0)
            _LOG.warning("checkpoint: step %d is not intact on every rank "
                         "(%s) — falling back to the previous verified "
                         "step", cand, bad)
            failures.append((cand, bad))
        raise MXNetError(
            f"no restorable checkpoint under {self._dir}: every "
            f"candidate failed verification or restore: {failures}")

    def _verify_shard(self, step, name, require_manifest=False):
        """(ok, why) for this rank's shard ``name`` of ``step``."""
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except OSError:
            if require_manifest:
                return False, ("no manifest — the step never "
                               "completed a durability barrier")
            if not os.path.exists(os.path.join(self._step_dir(step), name)):
                return False, f"no shard {name}"
            return True, "no manifest (pre-manifest step)"
        except ValueError as e:
            return False, f"manifest unreadable: {e}"
        expect = manifest.get("files", {}).get(name)
        got = self._hash_file(os.path.join(self._step_dir(step), name))
        if expect is None or got != expect:
            return False, f"shard {name} digest mismatch or missing"
        return True, "verified"

    @staticmethod
    def _assign(trainer, name, value):
        """Set the numpy leaf ``name`` (``tree/key/...``) of
        ``trainer`` to ``value``."""
        tree, *keys = name.split("/")
        node = getattr(trainer, tree)
        for key in keys[:-1]:
            node = node[key]
        node[keys[-1]] = value

    def _candidate_steps(self):
        """Auto-restore order: the verified-marker step first, then
        every other retained step newest-first."""
        steps = sorted(self.all_steps(), reverse=True)
        verified = self.latest_verified_step()
        if verified is not None and verified in steps:
            steps.remove(verified)
            steps.insert(0, verified)
        return steps

    def latest_step(self) -> Optional[int]:
        """Newest restorable step: the verified marker when present
        AND still retained (crash-safe), else the newest step directory
        on disk (a directory from before any barrier, or a marker step
        that retention deleted after later saves landed without a
        barrier)."""
        verified = self.latest_verified_step()
        steps = self.all_steps()
        if verified is not None and verified in steps:
            return verified
        return max(steps) if steps else None

    def all_steps(self):
        """Every step directory on disk, oldest first — torn ones (saved,
        barrier not reached) included."""
        steps = []
        for name in os.listdir(self._dir):
            if name.startswith(_STEP_PREFIX) and os.path.isdir(
                    os.path.join(self._dir, name)):
                try:
                    steps.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(steps)

    # --------------------------------------------------- the atomic marker
    @property
    def _marker_path(self):
        return os.path.join(self._dir, _MARKER)

    def latest_verified_step(self) -> Optional[int]:
        """The step the marker points at — i.e. the newest checkpoint
        PROVEN durable by a completed write barrier — or None."""
        try:
            with open(self._marker_path) as f:
                text = f.read().strip()
            return int(text) if text else None
        except (OSError, ValueError):
            return None

    def _commit_marker(self, step):
        """Atomically repoint the marker (tmp + fsync + rename): a
        kill at ANY instant leaves either the old marker or the new
        one — never a torn pointer."""
        self._atomic_write(self._marker_path, f"{int(step)}\n")

    # ------------------------------------------- integrity manifest + extra
    def _step_dir(self, step):
        return os.path.join(self._dir, f"{_STEP_PREFIX}{int(step)}")

    def _manifest_path(self, step):
        return os.path.join(self._dir, f"VERIFY-{int(step)}.json")

    def _extra_path(self, step):
        return os.path.join(self._dir, f"EXTRA-{int(step)}.json")

    @staticmethod
    def _atomic_write(path, text):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def _hash_file(path):
        """The sha256 of one file (None when it cannot be read)."""
        h = hashlib.sha256()
        try:
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 22), b""):
                    h.update(chunk)
        except OSError:
            return None
        return h.hexdigest()

    def _hash_step(self, step):
        """{relative path: sha256} over the step directory."""
        root = self._step_dir(step)
        digests = {}
        for dirpath, _dirs, files in os.walk(root):
            for name in sorted(files):
                path = os.path.join(dirpath, name)
                h = hashlib.sha256()
                try:
                    with open(path, "rb") as f:
                        for chunk in iter(lambda: f.read(1 << 22), b""):
                            h.update(chunk)
                except OSError:
                    continue            # transient tmp file mid-rename
                digests[os.path.relpath(path, root)] = h.hexdigest()
        return digests

    def _write_manifest(self, step):
        self._atomic_write(
            self._manifest_path(step),
            json.dumps({"step": int(step),
                        "files": self._hash_step(step)}))

    def _verify_step(self, step, require_manifest=False):
        """(ok, why) integrity verdict for one step.  Without
        ``require_manifest``, no manifest (a step from before any
        barrier) counts as ok — the restore itself is then the only
        available check, and its failure still falls back."""
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except OSError:
            if require_manifest:
                return False, ("no manifest — the step never "
                               "completed a durability barrier")
            return True, "no manifest (pre-manifest step)"
        except ValueError as e:
            return False, f"manifest unreadable: {e}"
        expect = manifest.get("files", {})
        got = self._hash_step(step)
        if got != expect:
            changed = sorted(
                set(expect) ^ set(got)
                | {p for p in expect
                   if p in got and got[p] != expect[p]})
            return False, f"payload digest mismatch: {changed[:4]}"
        return True, "verified"

    def load_extra(self, step):
        """The ``extra`` payload saved with ``step`` (or None)."""
        try:
            with open(self._extra_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _gc_sidecars(self):
        """Drop VERIFY-/EXTRA- files of steps no longer on disk."""
        live = set(self.all_steps())
        for name in os.listdir(self._dir):
            for prefix in ("VERIFY-", "EXTRA-"):
                if name.startswith(prefix) and name.endswith(".json"):
                    try:
                        step = int(name[len(prefix):-len(".json")])
                    except ValueError:
                        continue
                    if step not in live:
                        try:
                            os.remove(os.path.join(self._dir, name))
                        except OSError:
                            pass

    def wait(self):
        """The durability barrier: join the write in flight, then
        record each pending step's integrity manifest (+ extra payload)
        and advance the verified-latest marker to the newest of them."""
        t0 = time.perf_counter()
        if self._shard is not None:
            return self._wait_sharded(t0)
        self._join_writer()
        if not self._pending:
            return
        newest = max(self._pending)
        t1 = time.perf_counter()
        for step in sorted(set(self._pending)):
            extra = self._pending_extra.pop(step, None)
            if extra is not None:
                self._atomic_write(self._extra_path(step),
                                   json.dumps(extra))
            if os.path.isdir(self._step_dir(step)):
                self._write_manifest(step)
        t2 = time.perf_counter()
        self._commit_marker(newest)
        self._pending = []
        self._gc_sidecars()
        self.timings.update(hash_s=t2 - t1,
                            barrier_s=time.perf_counter() - t0)
        # the torn/bit-rot injection site: corrupt AFTER the barrier
        # verified the step, so restore must detect it via the
        # manifest and fall back
        if _inject("checkpoint.save", modes=("corrupt",)) is not None:
            flipped = _flip_payload_byte(self._step_dir(newest))
            _LOG.warning(
                "checkpoint: injected payload corruption at "
                "verified step %d (%s)", newest, flipped)

    def _wait_sharded(self, t0):
        """The barrier of a sharded save (every rank calls it): each rank
        joins its write and hashes its own payload; the verdicts are
        gathered; only if every rank's payload is verified does rank 0
        write the manifest of all ranks' files and the extras, and move
        the marker.  A rank's failure raises on every rank."""
        if not self._pending and self._writer is None:
            return
        err = None
        try:
            self._join_writer()
        except MXNetError as e:
            err = e
        rank, world = self._shard
        name = _shard_name(rank, world)
        pending = sorted(set(self._pending))
        mine = {}
        t1 = time.perf_counter()
        for step in pending if err is None else ():
            if not os.path.isdir(self._step_dir(step)):
                continue                # pruned by retention since
            digest = self._hash_file(os.path.join(self._step_dir(step),
                                                  name))
            if digest is None:
                err = MXNetError(f"checkpoint: shard {name} of step {step} "
                                 f"is missing after its write")
            mine[step] = digest
        t2 = time.perf_counter()
        verdicts = _all_agree(
            {"error": None if err is None else str(err), "files": mine})
        extras, self._pending_extra = self._pending_extra, {}
        self._pending = []
        failed = [(r, v["error"]) for r, v in enumerate(verdicts)
                  if v["error"] is not None]
        if failed:
            raise MXNetError(f"checkpoint: sharded save under {self._dir} "
                             f"not verified on every rank: {failed}") \
                from err
        if rank == 0:
            for step in sorted(verdicts[0]["files"]):
                if step in extras:
                    self._atomic_write(self._extra_path(step),
                                       json.dumps(extras[step]))
                files = {_shard_name(r, world): v["files"][step]
                         for r, v in enumerate(verdicts)}
                self._atomic_write(
                    self._manifest_path(step),
                    json.dumps({"step": int(step), "world": world,
                                "files": files}))
            self._commit_marker(max(pending))
            self._gc_sidecars()
        _all_agree(None)                # the marker is visible to all
        self.timings.update(hash_s=t2 - t1,
                            barrier_s=time.perf_counter() - t0)

    def close(self):
        """The barrier, then the staging buffers are released."""
        self.wait()
        self._staging = {}

    # ------------------------------------------------------ signal handling
    def save_on_signal(self, trainer, step_fn,
                       signals=(_signal.SIGTERM,)):
        """Install a preemption hook: on any of ``signals`` (default
        SIGTERM — what cluster schedulers send before eviction), run
        ONE synchronous save of ``trainer`` at ``step_fn()`` —
        save, write barrier, marker commit — then chain to the
        previously installed handler (or the default action), so the
        process still terminates the way its supervisor expects.

        ``step_fn`` is a zero-arg callable returning the step to stamp;
        it is evaluated at signal time, not install time.  The handler
        runs between two bytecodes of the main thread, so the state it
        saves is the trainer's at that moment: a loop that must stamp a
        step exactly is signalled between steps.  Returns this manager
        so the call chains.  Must run on the main thread (CPython
        signal rule).  ``remove_signal_handlers()`` undoes the
        install."""
        if not callable(step_fn):
            raise MXNetError(
                "save_on_signal: step_fn must be a zero-arg callable "
                "returning the step to save at signal time")

        def handler(signum, frame):
            try:
                step = int(step_fn())
                _LOG.warning(
                    "checkpoint: signal %s — saving final checkpoint "
                    "at step %d to %s", signum, step, self._dir)
                self.save(step, trainer)
                self.wait()             # barrier + marker commit
            except Exception as e:      # noqa: BLE001 — still terminate
                _LOG.error(
                    "checkpoint: signal-save failed (%s); the last "
                    "verified checkpoint is step %s", e,
                    self.latest_verified_step())
            prev = self._signal_prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev != _signal.SIG_IGN:
                # SIG_DFL — or None, a handler installed at the C level
                # that Python cannot re-invoke: re-raise with the
                # default action so the process still terminates and
                # its exit status reflects the signal
                _signal.signal(signum, _signal.SIG_DFL)
                _signal.raise_signal(signum)

        for signum in signals:
            self._signal_prev[signum] = _signal.signal(signum, handler)
        return self

    def remove_signal_handlers(self):
        """Restore the handlers ``save_on_signal`` displaced."""
        for signum, prev in self._signal_prev.items():
            _signal.signal(signum, prev)
        self._signal_prev = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove_signal_handlers()
        self.close()


def save_checkpoint(directory, trainer, step: int = 0):
    """One-shot synchronous save (no retention policy)."""
    with CheckpointManager(directory, max_to_keep=None,
                           async_write=False) as m:
        m.save(step, trainer)


def load_checkpoint(directory, trainer, step: Optional[int] = None) -> int:
    """Restore the latest (or ``step``) checkpoint into ``trainer``."""
    with CheckpointManager(directory) as m:
        return m.restore(trainer, step=step)
