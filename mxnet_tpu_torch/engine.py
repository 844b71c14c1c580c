"""Engine concurrency helpers of the PyTorch port.

The port's copy of the serving half of ``mxnet_tpu.engine``: the lock
and thread factories and their sanitizer (``MXNET_ENGINE_SANITIZE=1``).
With the knob off, :func:`make_lock` / :func:`make_condition` /
:func:`make_thread` return plain ``threading`` primitives and
:func:`watch_races` is a no-op, so the production path pays nothing.
With it on, locks record per-thread acquisition order and raise
``MXNetError`` on a lock-order inversion, framework threads are
registered so :func:`check_thread_leaks` names any thread that outlives
its owner's stop, and :func:`watch_races` arms Eraser-style lockset
tracking on an object's fields.

PyTorch orders device work on streams, so the JAX package's array
version counters have no counterpart here.  Its one sync helper,
:func:`sync_outputs`, waits on a dispatched batch's stream and rethrows
the batch's asynchronous device errors at that point.

The reference's engine names keep their meaning under torch:

- :class:`Engine` (``engine()`` is the process-wide one) holds the bulk
  size.  Torch launches each eager op as it is called, so the size
  fuses nothing: ``set_bulk_size`` records it and returns the previous
  one (``MXNET_EXEC_BULK_EXEC_TRAIN`` / ``_MAX_NODE_TRAIN`` set the
  start, 15 by default), and :class:`bulk` sets it for a ``with``
  block.  A hybridized block is the port's fusion: one CUDA graph.
- :func:`waitall` runs a deferred backward and every lazy forward, then
  waits for the card (``mx.nd.waitall``).
- :class:`Var` is the reference's per-array variable: a version count
  and a deferred exception, raised at :meth:`Var.check`.  Torch keeps
  the versions of its own tensors, so no array carries one.
- :func:`is_naive` is true under ``MXNET_ENGINE_TYPE=NaiveEngine``;
  torch's eager ops run in order either way.

``_CAPTURE_LOCK`` serialises every CUDA graph capture in the process:
serving's bucket programs and paged decoders, and the beam decoder's
step.
"""
from __future__ import annotations

import threading
import time

from . import runtime_metrics as _rm
from .base import KernelError, MXNetError, env_truthy, get_env

__all__ = ["Engine", "engine", "waitall", "is_naive", "set_bulk_size",
           "bulk", "Var", "make_lock", "make_condition", "make_thread",
           "forget_thread", "check_thread_leaks", "thread_registry",
           "sanitizer_active", "watch_races", "sync_outputs"]

# ---------------------------------------------------------------------------
# Concurrency sanitizer (MXNET_ENGINE_SANITIZE=1)
# ---------------------------------------------------------------------------

_SANITIZE = env_truthy("MXNET_ENGINE_SANITIZE", False)

# every CUDA graph capture in the process runs under this lock: a capture
# is rare (one per bucket, version or beam signature) and takes a
# device-wide synchronise on entry, so serialising them costs nothing on a
# hot path and rules out two captures interleaving their allocations
_CAPTURE_LOCK = threading.Lock()


def sanitizer_active() -> bool:
    """Whether lock-order recording is on for locks created from now
    on."""
    return _SANITIZE


class _LockOrders:
    """Process-wide lock-acquisition-order graph.

    Locks are identified by the *name* given to :func:`make_lock`, so
    every instance of a class shares one ordering contract (the static
    counterpart is mxlint's lock-discipline pass).  ``check(name)``
    runs BEFORE blocking on the lock: an inversion raises instead of
    deadlocking."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges = {}                # (held, acquiring) -> thread name
        self._held = threading.local()  # per-thread acquisition stack

    def _stack(self):
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def check_and_record(self, name: str):
        """Run BEFORE blocking on a *blocking* acquire: record the
        prospective held->name edges, then probe for the reverse order.
        Recording before the block matters — two threads entering a
        first-time ABBA simultaneously must see each other's edge and
        raise instead of deadlocking inside the real acquire.  (A
        timed-out blocking acquire leaves its edge behind: the ordering
        intent was real and can deadlock for the timeout's duration, so
        the conservative record is correct for a sanitizer.)  Trylocks
        never call this: a non-blocking attempt cannot deadlock and
        must not constrain blocking acquirers."""
        st = self._stack()
        me = threading.current_thread().name
        for held in st:
            if held == name:
                continue
            with self._mu:
                self._edges.setdefault((held, name), me)
                rev = self._edges.get((name, held))
            if rev is not None:
                raise MXNetError(
                    f"MXNET_ENGINE_SANITIZE: lock-order inversion — "
                    f"thread {me!r} acquires {name!r} while holding "
                    f"{held!r}, but thread {rev!r} acquired them in the "
                    f"reverse order; two such threads interleaving "
                    f"deadlock.  Pick one global order "
                    f"(docs/static_analysis.md)")

    def push(self, name: str):
        self._stack().append(name)

    def pop(self, name: str):
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

_LOCK_ORDERS = _LockOrders()


class _SanLock:
    """``threading.Lock`` wrapper with acquisition-order recording."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        if blocking:
            _LOCK_ORDERS.check_and_record(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _LOCK_ORDERS.push(self.name)
        return got

    def release(self):
        _LOCK_ORDERS.pop(self.name)
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _SanCondition:
    """``threading.Condition`` wrapper: order-records acquire/release;
    ``wait`` pops the held record while the underlying lock is released
    and re-pushes on wakeup (no false edge against locks taken by the
    thread that woke us)."""

    __slots__ = ("name", "_cond")

    def __init__(self, name: str):
        self.name = name
        self._cond = threading.Condition()

    def acquire(self, *args):
        blocking = args[0] if args else True
        if blocking:
            _LOCK_ORDERS.check_and_record(self.name)
        got = self._cond.acquire(*args)
        if got:
            _LOCK_ORDERS.push(self.name)
        return got

    def release(self):
        _LOCK_ORDERS.pop(self.name)
        self._cond.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout=None):
        _LOCK_ORDERS.pop(self.name)
        try:
            return self._cond.wait(timeout)
        finally:
            _LOCK_ORDERS.push(self.name)

    def wait_for(self, predicate, timeout=None):
        _LOCK_ORDERS.pop(self.name)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            _LOCK_ORDERS.push(self.name)

    def notify(self, n=1):
        # mxlint: disable=condition-discipline (contract: pure
        # delegation — the caller entered `with cond:` on THIS wrapper,
        # which acquired the wrapped lock; notifying unlocked raises
        # RuntimeError in the wrapped Condition itself)
        self._cond.notify(n)

    def notify_all(self):
        # mxlint: disable=condition-discipline (contract: pure
        # delegation, see notify())
        self._cond.notify_all()


def make_lock(name: str):
    """A mutex for engine/serving shared state: plain ``threading.Lock``
    normally, order-recording :class:`_SanLock` under
    ``MXNET_ENGINE_SANITIZE=1``.  ``name`` is the lock's identity in the
    order graph — use ``Class.attr`` so all instances share one
    contract."""
    return _SanLock(name) if _SANITIZE else threading.Lock()


def make_condition(name: str):
    """Condition-variable sibling of :func:`make_lock`."""
    return _SanCondition(name) if _SANITIZE else threading.Condition()


# ---------------------------------------------------------------------------
# Thread-lifecycle sanitizer (the runtime twin of mxlint's
# thread-lifecycle pass, docs/static_analysis.md §15)
# ---------------------------------------------------------------------------

class _ThreadRegistry:
    """Process-wide table of framework threads created via
    :func:`make_thread` while ``MXNET_ENGINE_SANITIZE=1``: who owns
    each thread, where it was created, whether it was deliberately
    abandoned.  ``check_leaks`` is the teardown assertion."""

    def __init__(self):
        self._mu = threading.Lock()
        # Thread -> {owner, site, daemon, created, abandoned}
        self._threads = {}

    def register(self, t, owner, site):
        with self._mu:
            self._threads[t] = {
                "owner": owner or "<unowned>",
                "site": site,
                "daemon": bool(t.daemon),
                "created": time.monotonic(),
                "abandoned": None,
            }

    def forget(self, t, reason):
        with self._mu:
            info = self._threads.get(t)
            if info is not None:
                info["abandoned"] = reason or "abandoned"

    def _prune(self):
        # contract: the caller already holds self._mu
        for t in [t for t in self._threads if not t.is_alive()]:
            # mxlint: disable=lock-discipline
            del self._threads[t]

    def rows(self):
        now = time.monotonic()
        with self._mu:
            self._prune()
            return [
                {"name": t.name, "owner": info["owner"],
                 "site": info["site"], "daemon": info["daemon"],
                 "age_s": now - info["created"],
                 "abandoned": info["abandoned"]}
                for t, info in sorted(self._threads.items(),
                                      key=lambda kv: kv[1]["created"])]

    def check_leaks(self, grace_s=1.0):
        """Raise ``MXNetError`` if any registered, non-abandoned thread
        is still alive after ``grace_s`` (split across the survivors —
        a stopping thread gets a moment to observe its stop signal, a
        genuinely leaked one cannot hide behind the grace)."""
        with self._mu:
            self._prune()
            live = [(t, info) for t, info in self._threads.items()
                    if info["abandoned"] is None]
        if not live:
            return
        deadline = time.monotonic() + max(0.0, grace_s)
        for t, _ in live:
            t.join(max(0.0, deadline - time.monotonic()))
        now = time.monotonic()
        leaked = [(t, info) for t, info in live if t.is_alive()]
        if not leaked:
            with self._mu:
                self._prune()
            return
        lines = [
            f"  {t.name!r} owner={info['owner']} "
            f"created at {info['site']} "
            f"daemon={info['daemon']} age={now - info['created']:.1f}s"
            for t, info in leaked]
        raise MXNetError(
            "MXNET_ENGINE_SANITIZE: thread leak — "
            f"{len(leaked)} framework thread(s) survived their owner's "
            "stop:\n" + "\n".join(lines) + "\n"
            "Every make_thread thread must exit on its owner's "
            "stop()/close() path (or be explicitly forgotten via "
            "forget_thread with a documented reason).  Static twin: "
            "mxlint thread-lifecycle (docs/static_analysis.md)")


_THREADS = _ThreadRegistry()


def thread_registry():
    """Live registered-thread rows (owner, site, daemon, age); empty when
    the sanitizer is off."""
    return _THREADS.rows()


def _caller_site(depth=2):
    import sys
    import os as _os
    f = sys._getframe(depth)
    path = f.f_code.co_filename
    try:
        rel = _os.path.relpath(path, _os.path.dirname(
            _os.path.dirname(_os.path.abspath(__file__))))
        if not rel.startswith(".."):
            path = rel
    except ValueError:
        pass
    return f"{path}:{f.f_lineno}"


def make_thread(target, *, name, owner=None, args=(), kwargs=None,
                daemon=True):
    """Factory for every framework-owned thread (mirrors
    :func:`make_lock`): a plain ``threading.Thread`` normally; under
    ``MXNET_ENGINE_SANITIZE=1`` the thread is additionally registered
    with its ``owner`` (``Class.attr``-style identity) and creation
    site so :func:`check_thread_leaks` can name any thread that
    survives its owner's stop.  The returned object is always a real
    ``threading.Thread`` — zero behavioral difference either way."""
    t = threading.Thread(target=target, name=name, args=args,
                         kwargs=kwargs or {}, daemon=daemon)
    if _SANITIZE:
        _THREADS.register(t, owner, _caller_site())
    return t


def forget_thread(t, reason):
    """Exempt ``t`` from :func:`check_thread_leaks`: the caller is
    deliberately abandoning it (``run_with_deadline``'s watchdog worker
    wedged past its deadline — a daemon by construction, and joining it
    would just move the hang).  ``reason`` is recorded beside it."""
    if _SANITIZE:
        _THREADS.forget(t, reason)


def check_thread_leaks(grace_s=1.0):
    """Teardown assertion (no-op when the sanitizer is off): every
    registered framework thread must have exited — a survivor raises
    ``MXNetError`` naming its owner and creation site.  The serving /
    replica / autoscaler / supervisor suites call this at teardown
    under ``MXNET_ENGINE_SANITIZE=1`` (tests/conftest.py)."""
    if _SANITIZE:
        _THREADS.check_leaks(grace_s)


# ---------------------------------------------------------------------------
# Eraser-style lockset race sanitizer (the runtime twin of mxlint's
# shared-state-race / atomicity passes, docs/static_analysis.md §20-21)
# ---------------------------------------------------------------------------

# classes whose __setattr__ has been wrapped by watch_races (wrap once
# per class; per-instance tracking state lives in the instance dict).
# _RACE_MU serializes the wrap: two threads constructing the first two
# instances of one class concurrently must not double-wrap __setattr__
_RACE_MU = threading.Lock()
_RACE_WATCHED_CLASSES = set()


def _race_stack(frame, limit=4):
    import traceback
    return "".join(traceback.format_stack(frame, limit=limit)).rstrip()


def _note_race_write(obj, fields, name):
    """The Eraser lockset state machine, write-only: the first writer
    owns the field (exclusive); the moment a SECOND thread writes, the
    field's candidate lockset becomes the intersection of the two
    writers' held locks, and every later write intersects again.  An
    empty intersection is the proof: two threads wrote this field with
    no lock in common, so an interleaving that tears a read-modify-
    write exists — raise naming both writes instead of silently losing
    an update on some future schedule."""
    import sys
    me = threading.current_thread().name
    locks = frozenset(_LOCK_ORDERS._stack())
    frame = sys._getframe(2)            # the assignment site
    st = fields.get(name)
    if st is None:                      # first write: exclusive owner
        fields[name] = {
            "thread": me, "locks": locks, "shared": False,
            "stack": _race_stack(frame)}
        return
    if not st["shared"] and st["thread"] == me:
        # still exclusive: refresh to the freshest write so the
        # eventual second-thread intersection uses real evidence
        st["locks"] = locks
        st["stack"] = _race_stack(frame)
        return
    candidate = st["locks"] & locks
    if candidate:
        st.update(shared=True, thread=me, locks=candidate,
                  stack=_race_stack(frame))
        return
    prev_thread, prev_stack = st["thread"], st["stack"]
    prev_locks = sorted(st["locks"]) or ["<none>"]
    # re-arm before raising so a caught error does not cascade into a
    # storm of reports for every later write to the same field
    fields[name] = {"thread": me, "locks": locks, "shared": False,
                    "stack": _race_stack(frame)}
    raise MXNetError(
        f"MXNET_ENGINE_SANITIZE: data race on "
        f"{type(obj).__name__}.{name} — no common lock across "
        f"writers.\n"
        f"  thread {me!r} writes holding "
        f"{sorted(locks) or ['<none>']}:\n{_race_stack(frame)}\n"
        f"  thread {prev_thread!r} wrote holding {prev_locks}:\n"
        f"{prev_stack}\n"
        f"Guard both writes with one engine.make_lock lock or confine "
        f"the field to a single thread.  Static twin: mxlint "
        f"shared-state-race (docs/static_analysis.md)")


def _install_race_hook(cls):
    with _RACE_MU:
        if cls in _RACE_WATCHED_CLASSES:
            return
        orig = cls.__setattr__

        def __setattr__(self, name, value, _orig=orig):
            fields = self.__dict__.get("_mx_race_fields_")
            if fields is not None \
                    and name not in self.__dict__["_mx_race_exempt_"]:
                _note_race_write(self, fields, name)
            _orig(self, name, value)

        cls.__setattr__ = __setattr__
        _RACE_WATCHED_CLASSES.add(cls)


def watch_races(obj, exempt=()):
    """Arm Eraser-style per-field lockset tracking on ``obj`` (no-op
    unless ``MXNET_ENGINE_SANITIZE=1``): every attribute write records
    the writing thread and the locks held (by ``make_lock`` name, via
    the same per-thread stack the lock-order sanitizer keeps); once two
    threads have written a field, the field's candidate lockset is the
    running intersection of the writers' locksets, and an empty
    intersection raises ``MXNetError`` naming the field, both threads,
    and both write stacks.  Call at the END of ``__init__`` —
    construction is single-threaded by contract and stays untracked.

    ``exempt`` names fields deliberately handed between threads by
    some other protocol (e.g. a field only ever plain-assigned once,
    published via the GIL's store atomicity).

    The thread-shared serving classes (ModelServer, DecodeEngine,
    ReplicaSet, Autoscaler, PageAllocator) arm themselves; use this
    directly when testing new multi-threaded state."""
    if not _SANITIZE:
        return obj
    _install_race_hook(type(obj))
    # plain dict stores (not setattr) so arming never trips the hook
    obj.__dict__["_mx_race_exempt_"] = frozenset(exempt)
    obj.__dict__["_mx_race_fields_"] = {}
    return obj


# ---------------------------------------------------------------------------
# Bounded sync point
# ---------------------------------------------------------------------------
def _cuda_streams(arrays, stream):
    """The streams ``sync_outputs`` waits on: ``stream`` when given,
    else the current stream of every CUDA device the torch tensors in
    ``arrays`` live on (host arrays are complete already)."""
    if stream is not None:
        return [stream]
    import torch
    devices = {a.device for a in arrays
               if isinstance(a, torch.Tensor) and a.device.type == "cuda"}
    return [torch.cuda.current_stream(d) for d in devices]


def sync_outputs(arrays, site="serving", stream=None):
    """Bounded sync point: block until one dispatched batch's device work
    is done — ``stream`` (the stream the batch ran on) when given, else
    the current stream of each CUDA tensor's device in ``arrays`` — and
    rethrow an asynchronous device error here as
    :class:`~mxnet_tpu_torch.base.KernelError` (the engine
    rethrow-at-sync-point contract applied to ONE batch instead of the
    whole device).  Host (numpy) outputs have nothing to wait for.
    Returns ``arrays``; with metrics on, the blocked time lands in
    ``engine.sync.seconds{site}``."""
    t0 = time.perf_counter()
    try:
        for s in _cuda_streams(arrays, stream):
            s.synchronize()
    except RuntimeError as e:
        raise KernelError(
            f"{site}: the batch's device work failed (reported at its "
            f"sync point): {e}") from e
    finally:
        if _rm._ENABLED:
            _rm.ENGINE_SYNC_SECONDS.observe(time.perf_counter() - t0,
                                            site=site)
    return arrays


# ---------------------------------------------------------------------------
# The reference's engine surface (module docstring)
# ---------------------------------------------------------------------------
class Var:
    """A version count and a deferred exception (reference:
    ``ThreadedVar``)."""

    __slots__ = ("version", "exc", "__weakref__")

    def __init__(self):
        self.version = 0
        self.exc = None

    def bump(self):
        self.version += 1

    def set_exception(self, exc: BaseException):
        self.exc = exc

    def check(self):
        if self.exc is not None:
            exc, self.exc = self.exc, None
            raise exc


_INSTANCE_LOCK = threading.Lock()


class Engine:
    """The process-wide engine (reference: ``Engine::Get()``)."""

    _instance = None

    def __init__(self):
        if str(get_env("MXNET_EXEC_BULK_EXEC_TRAIN", "1")) == "0":
            self._bulk_size = 1
        else:
            self._bulk_size = int(
                get_env("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN", 15))
        self._lock = threading.Lock()

    @classmethod
    def get(cls) -> "Engine":
        if cls._instance is None:
            with _INSTANCE_LOCK:
                if cls._instance is None:
                    cls._instance = Engine()
        return cls._instance

    def wait_for_all(self):
        waitall()

    def wait_for_var(self, arr):
        arr.wait_to_read()

    @property
    def is_naive(self) -> bool:
        return get_env("MXNET_ENGINE_TYPE") == "NaiveEngine"

    def set_bulk_size(self, size: int) -> int:
        with self._lock:
            old, self._bulk_size = self._bulk_size, int(size)
        return old

    @property
    def bulk_size(self) -> int:
        return self._bulk_size


def engine() -> Engine:
    return Engine.get()


def waitall():
    """``mx.nd.waitall``: run what is deferred, then wait for the card."""
    from . import ndarray
    ndarray.waitall()


def is_naive() -> bool:
    return Engine.get().is_naive


def set_bulk_size(size: int) -> int:
    """Set the bulk size; returns the previous one."""
    return Engine.get().set_bulk_size(size)


class bulk:
    """``with bulk(size):`` sets the bulk size for the block."""

    def __init__(self, size: int):
        self.size = size
        self._old = None

    def __enter__(self):
        self._old = Engine.get().set_bulk_size(self.size)
        return self

    def __exit__(self, *exc):
        Engine.get().set_bulk_size(self._old)
        return False
