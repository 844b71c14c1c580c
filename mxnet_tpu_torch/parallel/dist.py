"""Multi-process runtime: process-group bootstrap, host collectives and
the hang watchdog, over ``torch.distributed``.

The PyTorch port of ``mxnet_tpu.parallel.dist``.  Every process is a
worker; rank 0 hosts the TCP store that ``init_process_group`` meets at.
Collectives go through the process group: NCCL for a rank on a CUDA
device, gloo for a rank on the CPU.  The backend is chosen from the
rank's device, or named by ``backend=`` (gloo ranks on one card, where
NCCL refuses two ranks on one device); nothing switches backend after
an error, and a collective that fails raises.

Env protocol (what :mod:`mxnet_tpu_torch.tools.launch` sets; the
reference's names are accepted):

  MXNET_TPU_COORDINATOR | DMLC_PS_ROOT_URI[:DMLC_PS_ROOT_PORT]
  MXNET_TPU_NUM_PROCS   | DMLC_NUM_WORKER
  MXNET_TPU_PROC_ID     | DMLC_WORKER_ID

Point-to-point hops (:func:`exchange`) carry CUDA tensors directly over
NCCL and through pinned host memory over gloo; the choice is made from
the group's backend (:func:`transport`), never by retrying.
"""
from __future__ import annotations

import atexit
import datetime
import inspect
import logging
import os
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from .. import engine as _engine
from ..base import MXNetError

__all__ = ["initialize", "finalize", "is_initialized", "rank", "size",
           "backend", "device", "barrier", "allreduce_host",
           "broadcast_host", "transport", "exchange", "Watchdog"]

_LOG = logging.getLogger("mxnet_tpu_torch")

# _state is threading-reachable (atexit finalize vs. watchdog vs. user
# threads); mutate only under _STATE_LOCK.  "finalizing" claims the
# teardown without dropping "initialized" early: is_initialized() stays
# true (and a re-initialize stays a no-op) until the shutdown completes.
_state = {"initialized": False, "finalizing": False, "backend": None,
          "device": None}
_STATE_LOCK = threading.Lock()
_SHUTDOWN_S = 15


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: int = 60, backend: Optional[str] = None,
               device="cuda"):
    """Join the process group (reference: the KVStoreDist worker
    bootstrap).

    With no arguments the configuration is read from the env protocol
    above.  A standalone run (no env, no arguments) is a no-op, so a
    script runs unchanged on its own.  ``device`` is this rank's device:
    ``"cuda"`` (the default) takes card ``rank % device_count``, an
    explicit ``"cuda:<i>"`` that card, ``"cpu"`` the host.  ``backend``
    defaults to ``"nccl"`` for a CUDA rank and ``"gloo"`` for a CPU
    one."""
    with _STATE_LOCK:
        did_init = _initialize_locked(coordinator_address, num_processes,
                                      process_id, timeout_s, backend,
                                      device)
    if did_init:
        atexit.register(finalize)


def _rank_device(device, process_id):
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise MXNetError("dist.initialize: no CUDA device; pass "
                         "device='cpu' for a CPU rank")
    if device.index is None:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _initialize_locked(coordinator_address, num_processes, process_id,
                       timeout_s, backend, device):
    if _state["initialized"] or _state["finalizing"]:
        return False
    coordinator_address = coordinator_address or _env(
        "MXNET_TPU_COORDINATOR")
    if coordinator_address is None:
        uri = _env("DMLC_PS_ROOT_URI")
        if uri is not None:
            coordinator_address = \
                f"{uri}:{_env('DMLC_PS_ROOT_PORT', default='9091')}"
    if num_processes is None:
        v = _env("MXNET_TPU_NUM_PROCS", "DMLC_NUM_WORKER")
        num_processes = int(v) if v is not None else None
    if process_id is None:
        v = _env("MXNET_TPU_PROC_ID", "DMLC_WORKER_ID")
        process_id = int(v) if v is not None else None
    if coordinator_address is None and num_processes is None:
        return False  # standalone run
    if None in (coordinator_address, num_processes, process_id):
        raise MXNetError(
            "dist.initialize: coordinator_address, num_processes and "
            "process_id must all be provided (or none, for standalone)")
    device = _rank_device(device, int(process_id))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise MXNetError(f"dist.initialize: backend {backend!r}; known: "
                         f"'nccl' (CUDA ranks), 'gloo' (CPU or CUDA)")
    if backend == "nccl" and device.type != "cuda":
        raise MXNetError("dist.initialize: the nccl backend needs a CUDA "
                         "device; a CPU rank uses gloo")
    kwargs = {}
    if backend == "nccl" and "device_id" in inspect.signature(
            tdist.init_process_group).parameters:
        # bind the rank's card now (eager NCCL init) where torch can
        kwargs["device_id"] = device
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    # mxlint: disable=lock-discipline (contract: sole caller is
    # initialize(), which holds _STATE_LOCK around this helper)
    _state.update(initialized=True, backend=backend, device=device)
    return True


def finalize():
    """Leave the process group.  The teardown is claimed atomically: a
    concurrent finalize returns, and a concurrent initialize is a no-op
    until the shutdown is done.  A peer that is gone can wedge the
    shutdown; it is abandoned after 15 s and the process keeps its own
    exit code, which the launcher reads."""
    with _STATE_LOCK:
        if not _state["initialized"] or _state["finalizing"]:
            return
        _state["finalizing"] = True

    def _shutdown():
        try:
            tdist.destroy_process_group()
        except Exception:   # noqa: BLE001 — peers may already be gone
            pass

    t = _engine.make_thread(_shutdown, name="mxnet-dist-shutdown",
                            owner="dist.finalize")
    t.start()
    t.join(_SHUTDOWN_S)
    if t.is_alive():
        _engine.forget_thread(
            t, f"destroy_process_group() wedged >{_SHUTDOWN_S}s")
    with _STATE_LOCK:
        _state.update(initialized=False, finalizing=False, backend=None,
                      device=None)


def is_initialized() -> bool:
    return _state["initialized"]


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def backend() -> Optional[str]:
    """The default group's backend (None without a group)."""
    return tdist.get_backend() if tdist.is_initialized() else None


def device() -> Optional[torch.device]:
    """This rank's device as :func:`initialize` chose it (None before)."""
    return _state["device"]


def _comm_device(group=None):
    """Where a collective's tensors must live: the rank's card for an
    NCCL group, the host for a gloo group."""
    if tdist.get_backend(group) == "nccl":
        return _state["device"] or torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier", timeout_s: int = 120):
    """Cross-process sync point (reference: ps Barrier).  ``name`` labels
    a timeout's error."""
    if not tdist.is_initialized():
        return
    if tdist.get_backend() == "gloo":
        try:
            tdist.monitored_barrier(
                timeout=datetime.timedelta(seconds=timeout_s))
        except RuntimeError as e:
            raise MXNetError(f"dist.barrier({name!r}): {e}") from e
        return
    tdist.barrier(device_ids=[_comm_device().index])


def _as_tensor(arr):
    if isinstance(arr, torch.Tensor):
        return arr.detach(), True
    return torch.from_numpy(np.array(arr)), False


def allreduce_host(arr):
    """Sum a tensor or numpy array across processes (control-plane values:
    metrics, loss scalars, early-stop votes).  Returns the same kind as
    given (a tensor on its own device, or a numpy array)."""
    t, is_tensor = _as_tensor(arr)
    if tdist.is_initialized():
        buf = t.to(_comm_device(), copy=True)
        tdist.all_reduce(buf)
        t = buf.to(t.device)
    else:
        t = t.clone()
    return t if is_tensor else t.numpy()


def broadcast_host(arr, root: int = 0):
    """Broadcast from ``root`` to every process (control-plane values);
    same kinds as :func:`allreduce_host`."""
    t, is_tensor = _as_tensor(arr)
    if tdist.is_initialized():
        buf = t.to(_comm_device(), copy=True)
        tdist.broadcast(buf, src=int(root))
        t = buf.to(t.device)
    else:
        t = t.clone()
    return t if is_tensor else t.numpy()


def transport(group, device) -> str:
    """How a point-to-point hop of a tensor on ``device`` travels over
    ``group``: ``"nccl"`` (device to device), ``"gloo"`` (a CPU tensor)
    or ``"gloo_host_staged"`` (a CUDA tensor through pinned host memory:
    gloo's send/recv take host memory only).  Decided from the group's
    backend and the device, once per call site."""
    kind = tdist.get_backend(group)
    if kind == "nccl":
        return "nccl"
    if kind != "gloo":
        raise MXNetError(f"dist.transport: backend {kind!r} has no "
                         f"point-to-point path in the port")
    return "gloo_host_staged" if torch.device(device).type == "cuda" \
        else "gloo"


def exchange(sends, recvs, group):
    """One batch of point-to-point hops: ``sends`` is a list of
    ``(tensor, group_rank)``, ``recvs`` of ``(tensor, group_rank)``
    filled in place.  Over gloo a CUDA tensor is staged through pinned
    host memory both ways; over NCCL it goes as is."""
    if not sends and not recvs:
        return
    dev = (sends or recvs)[0][0].device
    staged = transport(group, dev) == "gloo_host_staged"
    ops, back = [], []
    for t, peer in sends:
        if staged:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            t = h
        ops.append(tdist.P2POp(tdist.isend, t.contiguous(),
                               tdist.get_global_rank(group, peer), group))
    for t, peer in recvs:
        buf = t
        if staged or not t.is_contiguous():
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=staged,
                              device="cpu" if staged else t.device)
            back.append((t, buf))
        ops.append(tdist.P2POp(tdist.irecv, buf,
                               tdist.get_global_rank(group, peer), group))
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    for t, buf in back:
        t.copy_(buf)


class Watchdog:
    """Hang detector: clean abort when a step stops making progress.

    Each process runs a watchdog thread; if :meth:`kick` is not called
    within ``timeout_s`` the process logs and hard-exits with code 42,
    which the launcher (:mod:`mxnet_tpu_torch.tools.launch`) sees and
    tears the whole job down on, instead of leaving the peers hung in a
    collective.

    Use::

        wd = dist.Watchdog(timeout_s=300); wd.start()
        for batch in data:
            train_step(batch)
            wd.kick()
        wd.stop()
    """

    def __init__(self, timeout_s: float = 300.0, name: str = "step"):
        self.timeout_s = float(timeout_s)
        self.name = name
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = None

    def kick(self):
        self._last = time.monotonic()

    def start(self):
        if self._thread is not None:
            return self

        def watch():
            while not self._stop.wait(min(self.timeout_s / 4, 10.0)):
                stalled = time.monotonic() - self._last
                if stalled > self.timeout_s:
                    _LOG.error(
                        "Watchdog %r: no progress for %.0fs (limit %.0fs) "
                        "— aborting process %d so the launcher can tear "
                        "down the job", self.name, stalled, self.timeout_s,
                        rank())
                    os._exit(42)

        self._thread = _engine.make_thread(
            watch, name=f"watchdog-{self.name}",
            owner=f"dist.Watchdog({self.name})")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
