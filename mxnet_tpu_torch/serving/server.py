"""In-process model server: bounded queues, worker pool, backpressure
(docs/serving.md §4).

The PyTorch port of ``mxnet_tpu.serving.server``: ``predict`` over the
port's ``DynamicBatcher`` (an ``add_block`` entry runs one CUDA graph
per batch bucket on the card) and ``generate`` over the port's
``DecodeEngine``; with ``ServingConfig(replicas=N > 1)`` each model
version serves through a :class:`~mxnet_tpu_torch.serving.replica.
ReplicaSet` instead (N replicas sharing the version's weights, each
with its own bucket graphs or decode engine; on one card all of them
share it).  With ``ServingConfig(tenant_tiers=...)`` every request
passes the tiered admission gate
(:class:`~mxnet_tpu_torch.serving.admission.AdmissionController`:
per-tenant quotas, low tiers shed first under pressure) after the
circuit gate and before the watermark; unset, there is no gate and no
per-request cost.

``predict()`` is synchronous from the caller's side; underneath,
admitted requests land in a bounded per-model queue, a worker pool
coalesces them into shape-bucketed batches (``DynamicBatcher``) and the
caller's thread wakes when its slice of the batch output is ready.
Backpressure is explicit: when queue depth sits at/above the
load-shedding watermark, admission fails *immediately* with
:class:`ServerOverloadedError` carrying a retry-after hint — the
serving-tier contract that callers see bounded latency or a cheap
reject, never an unbounded queue (reference: MXNet Model Server's
worker queues; the Gemma-on-TPU serving comparison's batching policy,
PAPERS.md).
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from .. import engine, runtime_metrics as _rm, tracing as _tr
from ..base import MXNetError, entropy_rng
from .admission import AdmissionController
from .batcher import DynamicBatcher, _host
from .config import ServingConfig
from .repository import ModelRepository
from .resilience import (CircuitBreaker, Deadline, DeadlineExceededError,
                         ServerOverloadedError, retry_call)

__all__ = ["ModelServer", "ServerOverloadedError",
           "DeadlineExceededError"]

_LOG = logging.getLogger("mxnet_tpu_torch")
_SERVER_SEQ = itertools.count(1)


class _Request:
    __slots__ = ("entry", "inputs", "rows", "event", "result", "error",
                 "t_enq", "trace", "queue_span", "deadline")

    def __init__(self, entry, inputs, rows, deadline=None):
        self.entry = entry
        self.inputs = inputs
        self.rows = rows
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enq = time.monotonic()
        # end-to-end deadline (resilience.Deadline; may be unbounded):
        # fixed at admission, consulted at batch assembly and by the
        # retry policy — a request can never outlive its timeout just
        # because it made it into a batch
        self.deadline = deadline or Deadline()
        # tracing: the request's TraceContext (None when untraced) and
        # its queue-wait span — started in the caller's thread at
        # enqueue, ended in whichever worker pops it (Span.end is
        # idempotent, so the timeout-withdrawal race is benign)
        self.trace = None
        self.queue_span = _tr._NOOP


class ModelServer:
    """Dynamic-batching server over a :class:`ModelRepository`.

    >>> repo = ModelRepository()
    >>> repo.add_block("bert", clf, tokens, types, valid_length)
    >>> with ModelServer(repo) as srv:
    ...     logits = srv.predict("bert", tokens, types, valid_length)

    Requests resolve their model entry at admission, so
    ``repository.swap`` hot-swaps versions without draining: in-flight
    requests finish on the old version, new admissions see the new one.
    """

    def __init__(self, repository=None, config=None, autostart=True,
                 name=None):
        self.repository = repository or ModelRepository()
        self.config = config or ServingConfig()
        self.batcher = DynamicBatcher(self.config)
        self.name = name or f"server{next(_SERVER_SEQ)}"
        self._evict_subscribed = False
        # engine.make_condition: plain Condition normally; lock-order
        # recording under MXNET_ENGINE_SANITIZE=1 (the serving tests
        # double as race tests in CI's sanity_lint job)
        self._cond = engine.make_condition("serving.ModelServer._cond")
        self._queues = OrderedDict()    # entry.uid -> (entry, deque)
        self._decoders = OrderedDict()  # entry.uid -> DecodeEngine
        # serializes decode-engine CONSTRUCTION (KV-pool allocation +
        # adapter bind) without holding _cond: two first-generate()
        # racers must not both run setup() on one shared adapter
        self._decoder_build = engine.make_lock(
            "serving.ModelServer._decoder_build")
        # replica layer: with config.replicas > 1 each entry serves
        # through a lazily built ReplicaSet instead of the shared
        # batcher / single decode engine.  Same build discipline as
        # decoders: construction (N prewarms) runs under its own lock,
        # never under _cond
        self._replica_sets = OrderedDict()  # entry.uid -> ReplicaSet
        self._replica_build = engine.make_lock(
            "serving.ModelServer._replica_build")
        self._depth = 0
        self._inflight = 0              # admitted, popped, not finished
        self._started = False
        self._stopping = False
        self._workers = []
        # per-model-version circuit breakers (entry.uid -> breaker),
        # created lazily at first admission; a hot-swap naturally gets
        # a FRESH breaker because the new version is a new uid.  The
        # retired set mirrors the batcher's: a worker finishing an
        # in-flight batch for an unloaded entry must not resurrect its
        # breaker into the map (nothing would ever evict it again)
        self._breakers = {}
        self._retired_uids = set()
        # jitter source for retry backoff — instance-owned so tests can
        # inject a seeded one; entropy-seeded by default so N replicas
        # hitting one backend failure do NOT retry in lockstep (the
        # thundering herd jitter exists to break up)
        self._retry_rng = entropy_rng()
        # tiered admission gate (docs/serving.md §11), built from
        # config.tenant_tiers; None = gate off, zero per-request cost
        self._admission = AdmissionController.from_config(self.config)
        self._stats = {"requests": 0, "completed": 0, "shed": 0,
                       "batches": 0, "errors": 0, "retries": 0,
                       "deadline_exceeded": 0, "bisected": 0,
                       "circuit_open_rejects": 0, "tenant_sheds": 0}
        engine.watch_races(self)
        if autostart:
            self.start()

    # ----------------------------------------------------------- lifecycle
    def start(self):
        with self._cond:
            if self._started:
                return self
            self._started = True
            self._stopping = False
            # retired versions must not pin compiled programs for the
            # process lifetime (hot-swap deploy loops); unsubscribed at
            # stop() so the repository never pins a dead server.  Flag
            # and subscription flip atomically under _cond (a racing
            # stop() must observe both or neither); the nested
            # repository lock is safe — the server->repository
            # acquisition order is one-way (the repository never calls
            # back into the server)
            if not self._evict_subscribed:
                self.repository.subscribe_unload(self._on_unload)
                self._evict_subscribed = True
        with self._cond:
            self._workers = [
                engine.make_thread(self._worker_loop,
                                   name=f"mxnet-serving-{i}",
                                   owner=f"ModelServer({self.name})")
                for i in range(self.config.num_workers)]
        for t in self._workers:
            t.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Shut down the worker pool.  ``drain=True`` (default) stops
        admission, lets workers finish every queued request, then joins;
        ``drain=False`` fails queued requests immediately.

        Returns True once the pool is down.  With a ``timeout``, a
        worker stuck in a dispatch can outlive the join — then the
        server STAYS in the stopping state (so a later ``start()``
        cannot spawn a second pool next to the orphan) and stop()
        returns False; call it again to finish the shutdown."""
        with self._cond:
            if not self._started:
                return True
            self._stopping = True
            if not drain:
                for _entry, q in self._queues.values():
                    for req in q:
                        req.error = MXNetError(
                            "ModelServer stopped before this request "
                            "was dispatched")
                        req.event.set()
                    q.clear()
                self._set_depth(0)
            self._cond.notify_all()
        # one total budget, not one per worker
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._workers:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        alive = [t for t in self._workers if t.is_alive()]
        if alive:
            return False
        # decode engines and replica sets go down with the worker pool;
        # outstanding generate() calls fail with finish_reason="stopped"
        with self._cond:
            decoders = dict(self._decoders)
            self._decoders.clear()
            rsets = dict(self._replica_sets)
            self._replica_sets.clear()
        stuck = {}
        for uid, eng in decoders.items():
            if not eng.stop(timeout=None if deadline is None
                            else max(0.0, deadline - time.monotonic())):
                stuck[uid] = eng
        stuck_sets = {}
        for uid, rset in rsets.items():
            if not rset.stop(timeout=None if deadline is None
                             else max(0.0,
                                      deadline - time.monotonic())):
                stuck_sets[uid] = rset
        if stuck or stuck_sets:
            # same contract as a stuck worker: keep the references so a
            # later stop() can finish the job, stay in the stopping
            # state, report failure — never leak a live step loop
            with self._cond:
                self._decoders.update(stuck)
                self._replica_sets.update(stuck_sets)
            return False
        with self._cond:
            self._started = False
            self._workers = []
            if self._evict_subscribed:
                self.repository.unsubscribe_unload(self._on_unload)
                self._evict_subscribed = False
        return True

    def _on_unload(self, entry):
        """Repository unload hook: drop the batcher's cached programs
        (their CUDA graphs and pools, and their hold on the weight
        snapshot), the version's circuit breaker (a retired uid's error
        history must not pin memory across hot-swap churn), AND
        stop/drop the entry's decode engine and replica set (their KV
        pools and per-replica graphs must not pin device memory for a
        retired version)."""
        self.batcher.evict(entry)
        with self._cond:
            eng = self._decoders.pop(entry.uid, None)
            rset = self._replica_sets.pop(entry.uid, None)
            self._breakers.pop(entry.uid, None)
            self._retired_uids.add(entry.uid)
        if eng is not None:
            eng.stop()
        if rset is not None:
            rset.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc == (None, None, None))
        return False

    @property
    def started(self):
        return self._started

    # ------------------------------------------------------------ breakers
    def _breaker(self, entry):
        """The (lazily created) circuit breaker of one model VERSION.
        Keyed on entry.uid: a hot-swapped version starts with a fresh,
        closed circuit, and a rolled-back version's error history dies
        with its uid.  A RETIRED uid (unloaded mid-flight) gets an
        ephemeral breaker that is never stored — the unload hook has
        already run, so re-inserting would leak it forever."""
        with self._cond:
            br = self._breakers.get(entry.uid)
            if br is None:
                br = CircuitBreaker(
                    self.config.circuit_window,
                    self.config.circuit_threshold,
                    self.config.circuit_cooldown_ms,
                    model=entry.name, version=entry.version)
                if entry.uid not in self._retired_uids:
                    self._breakers[entry.uid] = br
        return br

    def _admit_circuit(self, entry):
        """Breaker gate at admission; counts the reject as a shed (to a
        caller an open circuit IS an overload — back off and retry),
        with the same observability every other shed gets: an admit
        span tagged with the shed reason (parented to the ambient
        predict/generate root) and a debounced serving.shed incident
        dump."""
        try:
            self._breaker(entry).admit()
        except ServerOverloadedError as e:
            with self._cond:
                self._stats["shed"] += 1
                self._stats["circuit_open_rejects"] += 1
            if _rm._ENABLED:
                _rm.SERVING_SHED.inc(model=entry.name)
            sp = _tr.span("serving.admit")
            sp.set_tag("shed", str(e))
            sp.end()
            _tr.record_incident("serving.shed", self.debug_state)
            raise

    def _admit_tenant(self, entry, tenant):
        """Tenant-tier gate (docs/serving.md §11): quota token bucket
        plus priority shedding under overload — low tiers shed first.
        Runs AFTER the circuit gate and BEFORE the watermark check so
        a shed tenant never touches the bounded queue.  No-op when
        ``config.tenant_tiers`` is unset.  Observability mirrors every
        other shed: stats, serving.shed metric, tagged admit span,
        debounced incident dump."""
        if self._admission is None:
            return
        # instantaneous queue fraction, read without _cond — a stale
        # snapshot only skews the pressure one request, and the gate
        # must not nest the controller's lock inside the server's
        load = self._depth / float(max(1, self.config.shed_watermark))
        try:
            self._admission.check(tenant, model=entry.name, load=load)
        except ServerOverloadedError as e:
            with self._cond:
                self._stats["shed"] += 1
                self._stats["tenant_sheds"] += 1
            if _rm._ENABLED:
                _rm.SERVING_SHED.inc(model=entry.name)
            sp = _tr.span("serving.admit")
            sp.set_tag("shed", str(e))
            sp.set_tag("tenant", "" if tenant is None else str(tenant))
            sp.end()
            _tr.record_incident("serving.shed", self.debug_state)
            raise

    def admission_controller(self):
        """The tiered :class:`~mxnet_tpu_torch.serving.admission.
        AdmissionController` (None when ``config.tenant_tiers`` is
        unset) — an :class:`~mxnet_tpu_torch.serving.autoscaler.
        Autoscaler` publishes SLO pressure into it, tests read its
        stats."""
        return self._admission

    # -------------------------------------------------------------- predict
    def predict(self, model, *inputs, timeout=None, tenant=None):
        """Run one inference request; blocks until its slice of a
        coalesced batch is ready.  Inputs are batch-major numpy arrays or
        torch tensors validated against the model's serving signature;
        returns numpy (one array, or a tuple for multi-output models).

        ``timeout`` (default ``config.deadline_default``) is the
        request's END-TO-END deadline, not just the queue wait: it is
        fixed at admission and carried through queue -> batch assembly
        -> execute, an expired request is cancelled before it consumes
        a batch slot, and the caller gets
        :class:`~mxnet_tpu_torch.serving.resilience.DeadlineExceededError`
        within one scheduling quantum of the deadline — never a hang
        (docs/serving.md §8).

        ``tenant`` ("name" or "name:tier") routes the request through
        the tiered admission gate when ``config.tenant_tiers`` is set
        (docs/serving.md §11); None rides the default tier with no
        quota.

        With ``MXNET_TRACE=1`` the request carries one trace identity
        end to end: admission, queue wait, the (shared) batch-assembly
        span with its bucket outcome, and execute — and the latency
        histogram records the trace id as its exemplar, so a p99 links
        to the exact trace behind it (docs/observability.md).
        """
        with _tr.trace("serving.predict", model=model) as root:
            return self._predict_impl(model, inputs, timeout, root,
                                      tenant)

    def _predict_impl(self, model, inputs, timeout, root, tenant=None):
        from .. import deploy
        entry = self.repository.get(model)
        if entry.decode_model is not None:
            raise MXNetError(
                f"serving predict({model!r}): decoder entry — "
                f"autoregressive models serve through generate()")
        # requests are staged from host memory: a tensor (any device)
        # is copied to the host once here
        np_inputs = tuple(_host(x) for x in inputs)
        deploy.validate_inputs(entry.manifest, np_inputs,
                               where=f"serving predict({model!r})")
        if not np_inputs or np_inputs[0].ndim < 1:
            raise MXNetError(
                f"serving predict({model!r}): inputs must be batch-major "
                f"arrays with a leading batch dimension")
        rows = np_inputs[0].shape[0]
        cap = entry.max_rows(self.config.max_batch_size)
        if rows < 1 or rows > cap:
            raise MXNetError(
                f"serving predict({model!r}): request batch of {rows} "
                f"rows outside [1, {cap}] (max_batch_size="
                f"{self.config.max_batch_size}, "
                f"declared batch={entry.fixed_batch})")
        if timeout is None:
            timeout = self.config.deadline_default
        deadline = Deadline.start(timeout)
        # circuit gate AFTER validation (a malformed request says
        # nothing about version health) and BEFORE queueing (an open
        # circuit must shed instantly, not after a queue wait); the
        # tenant-tier gate follows the same rule
        self._admit_circuit(entry)
        self._admit_tenant(entry, tenant)

        req = _Request(entry, np_inputs, rows, deadline=deadline)
        req.trace = root.context
        admit = _tr.span("serving.admit", parent=req.trace, rows=rows)
        try:
            with self._cond:
                if not self._started or self._stopping:
                    raise MXNetError(
                        "ModelServer is not accepting requests "
                        "(not started, or shutting down)")
                # two-level backpressure: the watermark bounds the
                # WAITING queue; queue_depth additionally bounds total
                # outstanding work (queued + in-flight), so a slow
                # model cannot pile up unbounded
                # dispatched-but-unfinished requests
                reason = None
                if self._depth >= self.config.shed_watermark:
                    reason = (f"queue depth {self._depth} >= shed "
                              f"watermark {self.config.shed_watermark}")
                elif self._depth + self._inflight \
                        >= self.config.queue_depth:
                    reason = (f"outstanding work {self._depth} queued "
                              f"+ {self._inflight} in flight >= "
                              f"queue_depth {self.config.queue_depth}")
                if reason is not None:
                    self._stats["shed"] += 1
                    if _rm._ENABLED:
                        _rm.SERVING_SHED.inc(model=model)
                    admit.set_tag("shed", reason)
                    raise ServerOverloadedError(
                        model, self.config.retry_after_ms, reason)
                slot = self._queues.get(entry.uid)
                if slot is None:
                    slot = (entry, deque())
                    self._queues[entry.uid] = slot
                slot[1].append(req)
                self._set_depth(self._depth + 1)
                self._stats["requests"] += 1
                if _rm._ENABLED:
                    _rm.SERVING_REQUESTS.inc(model=model)
                req.queue_span = _tr.span("serving.queue_wait",
                                          parent=req.trace,
                                          depth=self._depth)
                self._cond.notify_all()
        except ServerOverloadedError:
            # flight recorder: an overloaded replica dumps its recent
            # traces + debug state ONCE per debounce window (the
            # callable defers the state walk until a dump really
            # happens) — called after _cond is released
            _tr.record_incident("serving.shed", self.debug_state)
            raise
        finally:
            admit.end()

        if not req.event.wait(deadline.remaining()):
            # withdraw an abandoned request so it neither occupies
            # bounded-queue depth (pushing admissions into the shed
            # watermark) nor burns device time computing a result
            # nobody will read; if a worker popped it meanwhile, let
            # that batch complete — the result is simply dropped.
            # Count the expiry only when WE withdrew it: a popped
            # request is counted by the worker instead (executed, or
            # expired at batch assembly) — never twice.
            withdrawn = False
            with self._cond:
                slot = self._queues.get(entry.uid)
                if slot is not None and req in slot[1]:
                    slot[1].remove(req)
                    if not slot[1]:
                        self._queues.pop(entry.uid, None)
                    self._set_depth(self._depth - 1)
                    withdrawn = True
                if withdrawn:
                    self._stats["deadline_exceeded"] += 1
            if withdrawn and _rm._ENABLED:
                _rm.SERVING_DEADLINE_EXCEEDED.inc(model=model)
            req.queue_span.end(error="timeout")
            raise DeadlineExceededError(
                f"serving predict({model!r})", timeout,
                f"queue depth {self._depth}")
        if req.error is not None:
            raise req.error
        return req.result if len(req.result) > 1 else req.result[0]

    # ------------------------------------------------------------- replicas
    def _replicated(self, entry):
        """Whether this entry serves through a ReplicaSet.  The
        single-replica configuration keeps the pre-replica path as it
        was (shared batcher / one decode engine), so replicas=1 cannot
        regress anything."""
        return self.config.replicas > 1

    def _replica_devices(self, entry):
        """Device placement for one entry's replicas.  Function entries
        have no device work to place, and a decoder's replicas run where
        its LM's weights are; a block or artifact entry's replicas take
        groups of the visible CUDA devices (``replica_groups``: a
        one-card pool is shared by every replica), or the entry's own
        device when its weights are on the CPU.  A group whose lead
        device does not hold the weights is refused when its replica is
        built; nothing here falls back."""
        if entry.kind in ("function", "decoder"):
            return None
        from ..parallel.placement import replica_groups
        dev = entry.device
        if dev is not None and dev.type != "cuda":
            return replica_groups(self.config.replicas, devices=[dev])
        return replica_groups(self.config.replicas)

    def _replica_set(self, entry):
        """The (lazily built) ReplicaSet of one entry uid.  Build —
        which prewarms every replica — runs under the dedicated build
        lock so admissions never stall behind it, with the same
        start-vs-stop re-check discipline as decode engines."""
        from .replica import ReplicaSet
        not_accepting = MXNetError(
            "ModelServer is not accepting requests "
            "(not started, or shutting down)")
        with self._cond:
            if not self._started or self._stopping:
                raise not_accepting
            rset = self._replica_sets.get(entry.uid)
        if rset is not None:
            return rset
        with self._replica_build:
            with self._cond:
                if not self._started or self._stopping:
                    raise not_accepting
                rset = self._replica_sets.get(entry.uid)
            if rset is not None:
                return rset
            fresh = ReplicaSet(entry, self.config,
                               devices=self._replica_devices(entry))
            reject = False
            with self._cond:
                if not self._started or self._stopping \
                        or entry.uid in self._retired_uids:
                    reject = True
                else:
                    self._replica_sets[entry.uid] = fresh
            if reject:
                fresh.stop()
                raise not_accepting
            # close the build-vs-unload race the decode engines also
            # guard: an unload that popped the map between our insert
            # and here has already "stopped" a set it never saw — stop
            # the orphan and reject rather than leak its threads
            with self._cond:
                tracked = self._replica_sets.get(entry.uid) is fresh
            if not tracked:
                fresh.stop()
                raise not_accepting
            return fresh

    def replica_set(self, model, version=None):
        """The :class:`~mxnet_tpu_torch.serving.replica.ReplicaSet`
        serving (model, version) — built (every replica prewarmed) on
        first use.  Raises unless ``config.replicas`` > 1."""
        entry = self.repository._resolve(model, version)
        if not self._replicated(entry):
            raise MXNetError(
                f"replica_set({model!r}): config.replicas="
                f"{self.config.replicas} — the replica layer needs "
                f"replicas > 1")
        return self._replica_set(entry)

    def _execute_batch(self, entry, inputs, deadline):
        """One batch execution: through the entry's ReplicaSet
        (least-loaded healthy replica, deadline-preserving failover)
        when replicas are configured, else the shared batcher."""
        if self._replicated(entry):
            return self._replica_set(entry).run_batch(
                inputs, deadline=deadline)
        return self.batcher.run_batch(entry, inputs, deadline=deadline)

    # ------------------------------------------------------------- generate
    def _decoder_engine(self, entry):
        """The (lazily created) decode engine of a decoder entry.  One
        engine per entry uid: a hot-swap makes later generate() calls
        resolve the new version's entry and spin up ITS engine, while
        in-flight sequences finish on the old one (the predict-path
        admission contract applied to engines)."""
        from .decode import DecodeEngine
        not_accepting = MXNetError(
            "ModelServer is not accepting requests "
            "(not started, or shutting down)")
        with self._cond:
            if not self._started or self._stopping:
                raise not_accepting
            eng = self._decoders.get(entry.uid)
        if eng is None:
            # engine construction is HEAVY (device KV-pool allocation +
            # adapter bind) — build under the dedicated build lock, NOT
            # _cond, so predict() admissions never stall behind a first
            # generate() and two racers cannot both run setup() on the
            # shared adapter (a losing racer's setup would zero the
            # winner's live KV pool)
            with self._decoder_build:
                with self._cond:
                    if not self._started or self._stopping:
                        raise not_accepting
                    eng = self._decoders.get(entry.uid)
                if eng is None:
                    # speculative draft: the entry's own attachment
                    # wins; else MXNET_SERVING_SPEC_DRAFT names a
                    # repository decoder entry whose decode model
                    # drafts for everyone.  Every engine gets its OWN
                    # adapter over the named entry's LM — an adapter
                    # binds one live engine (its pool/programs are
                    # engine state), so sharing the entry's adapter
                    # across N targets would reject the second one
                    draft = entry.draft_model
                    if draft is None and self.config.spec_k \
                            and self.config.spec_draft \
                            and self.config.spec_draft != entry.name:
                        from .decode import PagedLMAdapter
                        draft = self.repository.get(
                            self.config.spec_draft).decode_model
                        if isinstance(draft, PagedLMAdapter):
                            draft = PagedLMAdapter(
                                draft.lm, device=draft.device,
                                graphs=draft.graphs)
                    fresh = DecodeEngine(entry.decode_model, self.config,
                                         model_name=entry.name,
                                         draft=draft)
                    reject = False
                    with self._cond:
                        if not self._started or self._stopping:
                            reject = True
                        else:
                            self._decoders[entry.uid] = fresh
                            eng = fresh
                    if reject:
                        fresh.stop()        # unbinds the adapter again
                        raise not_accepting
        eng.start()
        # close the start-vs-stop race: a concurrent stop()/unload that
        # cleared the map between our insert and start() has already
        # "stopped" an engine with no thread — the one we just started
        # would leak; stop it and reject
        with self._cond:
            tracked = self._decoders.get(entry.uid) is eng
        if not tracked:
            eng.stop()
            raise not_accepting
        return eng

    def generate(self, model, prompt, *, max_new_tokens=None,
                 eos_id=None, on_token=None, timeout=None,
                 tenant=None):
        """Autoregressive generation through the continuous-batching
        decode engine (docs/serving.md §6).

        ``prompt`` is a 1-D int sequence; returns the generated ids as
        int32 (EOS included when hit).  ``on_token(token_id)`` streams
        every sampled token from the engine thread as it lands —
        time-to-first-token is one prefill away regardless of how many
        other sequences are mid-generation, because the engine admits
        new sequences every STEP, not every request.  Concurrent
        ``generate()`` calls of mixed lengths share the fixed-shape
        decode batch; a short request admitted mid-flight finishes
        ahead of a longer one admitted earlier.

        ``timeout`` (default ``config.deadline_default``) is the
        END-TO-END deadline: carried into the engine's waiting queue
        (an expired waiting sequence is cancelled before it consumes a
        decode slot or KV pages) and checked every step while running
        (an expired running sequence is evicted with its pages
        reclaimed), so a request can never outlive its timeout inside
        the decode batch (docs/serving.md §8).

        ``tenant`` ("name" or "name:tier") routes the request through
        the tiered admission gate when ``config.tenant_tiers`` is set
        (docs/serving.md §11), ahead of the decode engine; None rides
        the default tier with no quota.

        With ``MXNET_TRACE=1`` the request is one trace end to end:
        admission, queue wait, prefill, every Nth decode step, and
        eviction, with KV-page counts as tags (docs/observability.md).
        """
        with _tr.trace("serving.generate", model=model) as root:
            entry = self.repository.get(model)
            if entry.decode_model is None:
                raise MXNetError(
                    f"serving generate({model!r}): not a decoder entry "
                    f"— register the model with "
                    f"ModelRepository.add_decoder")
            if timeout is None:
                timeout = self.config.deadline_default
            self._admit_circuit(entry)
            self._admit_tenant(entry, tenant)
            if self._replicated(entry):
                # replica path: the set routes to the least-loaded
                # healthy replica's engine and fails a dead replica's
                # sequence over to a sibling as a fresh request under
                # this SAME deadline.  Health lives in the per-replica
                # breakers — the version-level breaker stays
                # admission-only here (a fully-dark set sheds as
                # ServerOverloadedError from the router)
                return self._replica_set(entry).generate(
                    prompt, max_new_tokens=max_new_tokens,
                    eos_id=eos_id, on_token=on_token, timeout=timeout,
                    _trace_ctx=root.context)
            eng = self._decoder_engine(entry)
            # pass the (already made) sampling decision down: a
            # sampled-out request must NOT re-enter head sampling in
            # the engine and root a fragment trace
            seq = eng.submit(prompt, max_new_tokens=max_new_tokens,
                             eos_id=eos_id, on_token=on_token,
                             timeout=timeout, _trace_ctx=root.context)
            breaker = self._breaker(entry)
            try:
                out = eng.result(seq, timeout=timeout)
            except Exception:
                # execute outcomes only: a step failure / quarantine is
                # version health, a cancel/deadline/shed is not
                if seq.finish_reason in ("error", "quarantined"):
                    breaker.record(False)
                raise
            breaker.record(True)
            return out

    def decode_stats(self, model):
        """The decode engine's scheduler/pool counters for ``model``
        (steps, generated tokens, admissions/evictions, KV-pool
        occupancy, programs vs bound).  With replicas configured, one
        entry per replica id."""
        entry = self.repository.get(model)
        with self._cond:
            eng = self._decoders.get(entry.uid)
            rset = self._replica_sets.get(entry.uid)
        if rset is not None:
            return rset.decode_stats()
        if eng is None:
            raise MXNetError(
                f"decode_stats({model!r}): no decode engine yet "
                f"(generate() creates it lazily)")
        return eng.stats()

    # -------------------------------------------------------------- prewarm
    def prewarm(self, model, version=None):
        """Build ALL shape buckets of (model, version) through this
        server's program cache before they can meet traffic — the
        zero-cold-start half of the hot-swap contract
        (docs/serving.md §5)::

            repo.add_block("m", module, *examples, activate=False)
            srv.prewarm("m", version=2)                     # warm
            repo.swap("m", 2)                               # cutover

        After a prewarmed swap no request ever waits on a build (for a
        block entry on the card: a CUDA-graph capture): every bucket's
        program is already in the batcher's memory cache, and each has
        run once.  Returns the repository's summary dict.

        With replicas configured, prewarming builds the whole
        ReplicaSet instead — EVERY replica's programs are built (on the
        card: each replica's own graphs captured) and executed before
        any of them is routable."""
        entry = self.repository._resolve(model, version)
        if self._replicated(entry):
            rset = self._replica_set(entry)
            return {"model": model, "version": entry.version,
                    "replicas": rset.replicas(),
                    "stats": rset.stats()}
        return self.repository.prewarm(
            model, version, batcher=self.batcher,
            max_batch_size=self.config.max_batch_size)

    # ---------------------------------------------------------------- stats
    def stats(self):
        """Plain-dict serving counters (always on, independent of the
        runtime-metrics switch)."""
        with self._cond:
            out = dict(self._stats)
            out["queue_depth"] = self._depth
            out["inflight"] = self._inflight
        out["bucket_hits"] = self.batcher.bucket_hits
        out["bucket_disk_hits"] = self.batcher.bucket_disk_hits
        out["bucket_misses"] = self.batcher.bucket_misses
        out["programs"] = self.batcher.programs()
        with self._cond:
            rsets = dict(self._replica_sets)
        if rsets:
            # keyed by model name; when TWO versions of one model are
            # live (staged prewarm during a hot-swap window) the later
            # uid disambiguates as "name@vN" instead of silently
            # shadowing the serving version's counters
            sets = {}
            for rset in rsets.values():
                key = rset.name
                if key in sets:
                    key = f"{rset.name}@v{rset.entry.version}"
                sets[key] = rset.stats()
            out["replica_sets"] = sets
        if self._admission is not None:
            out["admission"] = self._admission.stats()
        return out

    def debug_state(self):
        """Deep, JSON-serializable snapshot of the serving stack for
        the flight recorder: per-model queue depths and head ages,
        in-flight counts, per-engine decode state (running sequences
        with their block-table occupancy), program-cache sizes, the
        repository's version map, and tracer counters.  Dumped
        automatically on overload incidents
        (:func:`mxnet_tpu_torch.tracing.record_incident`)."""
        now = time.monotonic()
        with self._cond:
            queues = []
            for entry, q in self._queues.values():
                queues.append({
                    "model": entry.name, "version": entry.version,
                    "depth": len(q),
                    "head_age_s": None if not q
                    else round(now - q[0].t_enq, 6)})
            decoders = dict(self._decoders)
            rsets = dict(self._replica_sets)
            state = {
                "server": self.name,
                "started": self._started,
                "stopping": self._stopping,
                "workers": len(self._workers),
                "queue_depth": self._depth,
                "inflight": self._inflight,
                "stats": dict(self._stats),
                "queues": queues,
            }
            breakers = dict(self._breakers)
        # engine/batcher/repository snapshots go through THEIR locks
        # only after _cond is released (one-way acquisition order)
        state["decoders"] = {str(uid): eng.debug_state()
                             for uid, eng in decoders.items()}
        state["replica_sets"] = {str(uid): rset.debug_state()
                                 for uid, rset in rsets.items()}
        state["circuits"] = {str(uid): br.debug_state()
                             for uid, br in breakers.items()}
        state["batcher"] = {
            "programs": self.batcher.programs(),
            "bucket_hits": self.batcher.bucket_hits,
            "bucket_disk_hits": self.batcher.bucket_disk_hits,
            "bucket_misses": self.batcher.bucket_misses,
        }
        if self._admission is not None:
            state["admission"] = self._admission.debug_state()
        state["repository"] = self.repository.debug_state()
        state["tracer"] = _tr.TRACER.stats()
        return state

    # -------------------------------------------------------------- workers
    def _set_depth(self, depth):
        # mxlint: disable=lock-discipline (contract: callers hold
        # self._cond — every call site is inside `with self._cond`)
        self._depth = depth
        if _rm._ENABLED:
            _rm.SERVING_QUEUE_DEPTH.set(depth, server=self.name)
            _rm.SERVING_QUEUE_PEAK.set_max(depth, server=self.name)

    def _next_batch(self):
        """Block until a batch is ready to dispatch (or shutdown drain
        is complete).  Returns ``(entry, [requests], [expired])`` or
        None.

        A queue is *ripe* once it holds a full batch or its head request
        has aged past ``max_latency_us`` (always, during shutdown
        drain).  The ripe queue with the oldest head dispatches first so
        no model starves; when nothing is ripe yet, wait only until the
        earliest forming-batch deadline — a full batch for one model
        never sits behind another model's hold window.

        Requests whose end-to-end deadline already expired are split
        out at the pop (the deadline contract: a dead request must not
        consume a batch slot or device time) — the worker fails them
        with ``DeadlineExceededError`` without dispatching them.
        """
        max_latency_s = self.config.max_latency_us / 1e6
        with self._cond:
            while True:
                ripe, earliest = None, None
                for uid, (entry, q) in self._queues.items():
                    if not q:
                        continue
                    cap = entry.max_rows(self.config.max_batch_size)
                    deadline = q[0].t_enq + max_latency_s
                    now = time.monotonic()
                    if self._stopping or now >= deadline \
                            or sum(r.rows for r in q) >= cap \
                            or any(r.deadline.expired(now) for r in q):
                        if ripe is None or q[0].t_enq < ripe[1][0].t_enq:
                            ripe = (entry, q)
                    elif earliest is None or deadline < earliest:
                        earliest = deadline
                if ripe is None:
                    if earliest is not None:
                        # hold forming batches open for more work, then
                        # re-evaluate (new arrivals notify)
                        self._cond.wait(
                            max(0.0, earliest - time.monotonic()))
                        continue
                    if self._stopping:
                        return None
                    # idle: block until an enqueue/stop notifies (every
                    # state change that creates work calls notify_all)
                    # mxlint: disable=deadline-soundness (contract:
                    # idle park — the queues are empty, so no admitted
                    # request's deadline is burning)
                    self._cond.wait()
                    continue
                entry, q = ripe
                cap = entry.max_rows(self.config.max_batch_size)
                reqs, expired, rows = [], [], 0
                now = time.monotonic()
                while q and rows + q[0].rows <= cap:
                    r = q.popleft()
                    if r.deadline.expired(now):
                        expired.append(r)   # no slot for the dead
                        continue
                    reqs.append(r)
                    rows += r.rows
                if not q:
                    self._queues.pop(entry.uid, None)
                self._set_depth(self._depth - len(reqs) - len(expired))
                self._inflight += len(reqs)
                if expired:
                    self._stats["deadline_exceeded"] += len(expired)
                return entry, reqs, expired

    def _fail_expired(self, entry, expired):
        """Fail requests whose deadline passed before batch assembly
        (popped but never dispatched — the other half of the deadline
        contract next to the caller-side withdrawal)."""
        for r in expired:
            r.queue_span.end(error="deadline")
            if _rm._ENABLED:
                _rm.SERVING_DEADLINE_EXCEEDED.inc(model=entry.name)
            r.error = DeadlineExceededError(
                f"serving predict({entry.name!r})", r.deadline.timeout,
                "deadline expired in queue, request cancelled before "
                "batch assembly")
            r.event.set()

    def _group_deadline(self, reqs):
        """The tightest member deadline — the retry policy must not
        sleep past the first caller's budget."""
        times = [r.deadline.t for r in reqs if r.deadline.t is not None]
        return Deadline(min(times)) if times else Deadline()

    def _note_retry(self, entry, attempt, exc):
        with self._cond:
            self._stats["retries"] += 1
        if _rm._ENABLED:
            _rm.SERVING_RETRIES.inc(model=entry.name)
        _LOG.warning("serving: transient failure for %s:%s (retry "
                     "%d/%d): %s", entry.name, entry.version, attempt,
                     self.config.retry_max, exc)

    def _dispatch_group(self, entry, reqs):
        """Execute one request group with bounded transient retries;
        on persistent failure BISECT so one poisoned request fails
        alone instead of killing its coalesced batchmates.  Returns
        ``(succeeded_requests, [(failed_request, error), ...])``;
        results are assigned onto the requests, events are NOT set
        (the worker publishes outcomes after breaker accounting)."""
        group_deadline = self._group_deadline(reqs)
        try:
            results = retry_call(
                lambda: self._execute_batch(
                    entry, [r.inputs for r in reqs],
                    group_deadline),
                retries=self.config.retry_max,
                backoff_ms=self.config.retry_backoff_ms,
                deadline=group_deadline,
                rng=self._retry_rng,
                on_retry=lambda n, e: self._note_retry(entry, n, e))
        except DeadlineExceededError as e:
            # a group-deadline expiry (wedged bucket build, or the
            # retry budget burned against the tightest member) says
            # nothing about a poisoned request — don't bisect or count
            # it as one.  Fail the members whose own budget is gone
            # and re-dispatch the rest under their looser deadlines
            # (program_for raises only after the group deadline truly
            # expired, so at least one member leaves on every pass).
            alive, gone = [], []
            for r in reqs:
                (gone if r.deadline.expired() else alive).append(r)
            gone = [(r, e) for r in gone]
            if not alive or not gone:   # no-gone: unknown raise site —
                return [], gone + [(r, e) for r in alive]  # never loop
            ok, bad = self._dispatch_group(entry, alive)
            return ok, bad + gone
        except Exception as e:      # noqa: BLE001 — isolate the poison
            if len(reqs) == 1:
                # also log it: a caller that already timed out will
                # never read req.error, and a compile failure must not
                # be diagnosable only as caller-side timeouts
                _LOG.warning("serving: request for %s:%s failed: %s",
                             entry.name, entry.version, e)
                return [], [(reqs[0], e)]
            _LOG.warning("serving: batch of %d request(s) for %s:%s "
                         "failed (%s); bisecting to isolate the "
                         "poisoned request", len(reqs), entry.name,
                         entry.version, e)
            with self._cond:
                self._stats["bisected"] += 1
            _tr.tag("bisected", len(reqs))
            mid = len(reqs) // 2
            ok_lo, bad_lo = self._dispatch_group(entry, reqs[:mid])
            ok_hi, bad_hi = self._dispatch_group(entry, reqs[mid:])
            return ok_lo + ok_hi, bad_lo + bad_hi
        with self._cond:
            self._stats["batches"] += 1
        for r, out in zip(reqs, results):
            r.result = out
        return list(reqs), []

    def _worker_loop(self):
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._serve_batch(*batch)
            # an idle worker must not pin the entry it served last (and
            # with it a retired version's weights) while it waits
            del batch

    def _serve_batch(self, entry, reqs, expired):
        """Fail the expired, dispatch the rest as one group, publish
        every outcome."""
        self._fail_expired(entry, expired)
        if not reqs:
            return
        # queue-wait spans end at the pop (outside _cond — the
        # tracer lock is never taken while a serving lock is held)
        for r in reqs:
            r.queue_span.end()
        # ONE batch-assembly span shared by every coalesced
        # request: it lives in the first sampled request's trace
        # and is copied (same interval, same tags) into the others
        # after dispatch — chrome-trace has no multi-parent links,
        # so each trace gets a complete private timeline instead
        home = next((r.trace for r in reqs if r.trace is not None),
                    None)
        bspan = _tr.span("serving.batch", parent=home,
                         model=entry.name, requests=len(reqs))

        def _share_batch_span():
            # copy the (ended) shared span into the OTHER coalesced
            # traces — must run BEFORE any r.event.set(): a woken
            # caller completes its root, after which the copy would
            # be dropped as a straggler
            if bspan.sampled:
                for r in reqs:
                    if r.trace is not None \
                            and r.trace.trace_id != bspan.trace_id:
                        _tr.record_span(
                            "serving.batch", r.trace, bspan.t0,
                            bspan.t1 or bspan.t0,
                            dict(bspan.tags or {},
                                 shared_with=bspan.trace_id))

        with bspan:
            ok, bad = self._dispatch_group(entry, reqs)
            if bad:
                # failures no longer propagate out of the dispatch
                # (retry/bisection contains them) — tag the shared
                # batch span the way an escaping exception used to
                bspan.set_tag("error", type(bad[0][1]).__name__)
                bspan.set_tag("failed_requests", len(bad))
        _share_batch_span()           # bspan ended by the with-exit
        done = time.monotonic()
        breaker = self._breaker(entry)
        n_deadline = sum(1 for _r, e in bad
                         if isinstance(e, DeadlineExceededError))
        with self._cond:
            self._stats["completed"] += len(ok)
            self._stats["errors"] += len(bad)
            self._stats["deadline_exceeded"] += n_deadline
            self._inflight -= len(reqs)
            self._cond.notify_all()
        # publish outcomes AFTER the shared bookkeeping: breaker
        # records execute outcomes only (expired requests above
        # never reached the model and say nothing about health —
        # and neither does a deadline that expired waiting on a
        # bucket build, so those skip the breaker too)
        for r, e in bad:
            if isinstance(e, DeadlineExceededError):
                if _rm._ENABLED:
                    _rm.SERVING_DEADLINE_EXCEEDED.inc(
                        model=entry.name)
            else:
                breaker.record(False)
            r.error = e
            r.event.set()
        for r in ok:
            breaker.record(True)
            if _rm._ENABLED:
                _rm.SERVING_REQUEST_SECONDS.observe(
                    done - r.t_enq, model=entry.name,
                    exemplar=None if r.trace is None
                    else r.trace.trace_id)
            r.event.set()

