"""Autoregressive decode engine: token-level continuous batching over a
paged KV cache (docs/serving.md §6).

The PyTorch port of ``mxnet_tpu.serving.decode``.  The scheduler
(:class:`DecodeEngine`, with its prefix-cache and speculative-decoding
host logic) is the JAX package's, unchanged; :class:`PagedLMAdapter`
runs the port's eager paged forwards, whose decode and verify attention
are hand-written CUDA kernels on the card.

Request-level batching would hold every sequence of a batch hostage to
its longest member; this engine reschedules at TOKEN granularity
instead — every step it admits waiting sequences into free decode
slots, runs ONE fixed-shape decode step for all running sequences, and
evicts the finished ones (the continuous-batching design of Orca/vLLM,
with the kernel layout of "Ragged Paged Attention", PAPERS.md).  The
host-side step loop only schedules and samples; all per-token math
lives in two model-call families of bounded shape:

- **prefill** — one shape per prompt-length bucket (the power-of-two
  ``bucket_set`` policy applied to the length axis), batch 1, writes
  the prompt's K/V into cache pages and returns last-token logits;
- **decode** — ONE shape at the fixed ``decode_max_batch``, one token
  per slot, reading/writing K/V through per-sequence block tables
  (``serving.kv_cache``).

Distinct launched shapes (``programs``) are therefore bounded by
``len(bucket_set(max_context)) + 1`` for ANY traffic mix.

KV memory: sequences own fixed-size pages from a preallocated device
pool via a free-list allocator (:mod:`mxnet_tpu_torch.serving.kv_cache`).
Admission reserves a sequence's worst case
(``ceil((prompt + max_new_tokens) / page_size)``) up front —
all-or-nothing, so a running sequence can never hit pool exhaustion
mid-flight and no preemption machinery is needed; eviction returns the
pages, unblocking the admission queue.  (vLLM-style lazy allocation
with preemption is a policy swap inside ``_admit_locked``.)

Two composable optimizations ride the same paged substrate
(docs/serving.md §9):

- **prefix caching** (``config.prefix_cache``): prompts are looked up
  in a radix tree over page-size token chunks at admission; a hit
  aliases the cached (refcounted, immutable) pages instead of
  re-running prefill — the one page the sequence must append into is
  copy-on-write duplicated — and the last-token logits are recovered
  through a width-1 (full hit) or tail-width (partial hit) call of the
  **verify** program family.  Lookup/verify failures DEGRADE to a
  plain prefill, never to wrong tokens — except a
  :class:`~mxnet_tpu_torch.base.KernelError`: a kernel that cannot run
  fails the request instead of being served around.
- **speculative decoding** (``config.spec_k`` + a draft model): the
  draft proposes up to k tokens per running sequence (batched draft
  decode steps over the SAME block tables, its K/V in a parallel
  draft pool), the target verifies all k+1 positions in ONE call of
  the verify family (the ragged multi-token shape
  ``ragged_paged_verify`` exists for), greedy acceptance is exact
  (the degenerate rejection-sampling case — byte-identical outputs
  speculation on or off), and rejected positions roll back through
  the block-table/context-length bookkeeping alone (their stale K/V
  is never attended and is overwritten in place).

Programs stay bounded: prefill buckets + 1 decode + the verify-width
family (+ the draft's own prefill/decode/verify families when
speculation is on).
"""
from __future__ import annotations

import itertools
import logging
import threading
import time

import numpy as np
import torch

from .. import engine as _engine, faults as _faults, \
    runtime_metrics as _rm, tracing as _tr
from ..base import KernelError, MXNetError, entropy_rng
from ..models.transformer_blocks import (TransformerDecoderLM,
                                         paged_decode_step, paged_lm_params,
                                         paged_prefill, paged_verify,
                                         paged_verify_batch)
from .batcher import bucket_set, next_bucket
from .kv_cache import DeviceKVPool, PageAllocator, PageGeometry
from .resilience import (Deadline, DeadlineExceededError,
                         ServerOverloadedError, retry_call)

__all__ = ["DecodeEngine", "GenerateRequest", "PagedLMAdapter",
           "as_decode_model"]

_LOG = logging.getLogger("mxnet_tpu_torch")
_SEQ_IDS = itertools.count(1)
# traced sequences record a decode.step span for their FIRST decode
# step and then every Nth token — per-token spans on a long generation
# would blow the per-trace span budget without adding information
_STEP_SPAN_EVERY = 8
# submit(_trace_ctx=...) sentinel: "no caller decision — inspect the
# ambient context / make the head-sampling call here".  ModelServer
# always passes its root's context instead (None when that root was
# sampled out), so one request NEVER gets two sampling decisions.
_AMBIENT = object()


class GenerateRequest:
    """One ``generate()`` call's lifecycle handle.

    ``tokens`` fills with generated ids (EOS included when hit) as the
    engine steps; ``event`` fires at eviction (finished, failed, or
    cancelled).  ``finish_reason`` is one of ``eos | length |
    cancelled | stopped | error | deadline | quarantined``.
    """

    __slots__ = ("seq_id", "prompt", "max_new_tokens", "eos_id",
                 "on_token", "tokens", "event", "error", "finish_reason",
                 "slot", "context_len", "t_submit", "t_first", "t_prev",
                 "cancelled", "trace", "root_span", "queue_span",
                 "released_pages", "deadline", "prefix_len", "cow",
                 "draft_ctx", "no_cache", "no_spec")

    def __init__(self, prompt, max_new_tokens, eos_id, on_token,
                 deadline=None):
        self.seq_id = next(_SEQ_IDS)
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.on_token = on_token
        self.tokens = []                  # generated ids (ints)
        self.event = threading.Event()
        self.error = None
        self.finish_reason = None
        self.slot = None                  # decode-batch slot while running
        self.context_len = 0              # tokens whose K/V is written
        self.t_submit = time.monotonic()
        self.t_first = None               # first-token timestamp (TTFT)
        self.t_prev = None                # previous-token timestamp
        self.cancelled = False
        # end-to-end deadline (resilience.Deadline; may be unbounded):
        # checked in the waiting line (expire before consuming a slot
        # or pages) and after every step while running
        self.deadline = deadline or Deadline()
        # tracing: the request's TraceContext (None when untraced), an
        # engine-owned root span when generate() was called without an
        # ambient trace, and the queue-wait span started at submit and
        # ended by the step loop at admission
        self.trace = None
        self.root_span = None
        self.queue_span = _tr._NOOP
        self.released_pages = 0
        # prefix-cache admission plan (set by the step loop): tokens of
        # prompt covered by aliased cached pages, and the (src, dst)
        # copy-on-write pair when the hit covers the whole prompt
        self.prefix_len = 0
        self.cow = None
        # speculative decoding: positions with valid DRAFT K/V (lags
        # context_len by <= 1 after a fully-accepted round)
        self.draft_ctx = 0
        # degrade flags: a failed cached-path prefill requeues with the
        # cache bypassed; a failed draft prefill decodes plainly
        self.no_cache = False
        self.no_spec = False

    def token_at(self, pos):
        """The sequence's token at global position ``pos`` (prompt,
        then generated ids)."""
        if pos < self.prompt.size:
            return int(self.prompt[pos])
        return self.tokens[pos - self.prompt.size]

    @property
    def ttft(self):
        """Seconds from submit to first token, or None."""
        return None if self.t_first is None \
            else self.t_first - self.t_submit


class DecodeEngine:
    """Continuous-batching scheduler over one decode model.

    ``model`` implements the decode-model protocol (duck-typed so
    scheduler tests run on fake numpy models):

    - attrs ``vocab_size``, ``max_context`` (and for pool sizing,
      optional ``num_layers`` / ``num_heads`` / ``head_dim``);
    - ``prefill(tokens (1, L) i32, length () i32, block_table (P,) i32)
      -> last-token logits (V,)``, writing the prompt's K/V;
    - ``decode_step(tokens (B,) i32, positions (B,) i32,
      block_tables (B, P) i32) -> logits (B, V)`` — inactive slots
      carry zeros and their logits are never read;
    - optional ``verify(tokens (1, W) i32, start () i32, length () i32,
      block_table (P,) i32) -> logits (W, V)`` — the multi-token
      window forward prefix caching and speculative decoding need
      (writes the window's K/V, judges every position in one call);
    - optional ``copy_page(src, dst)`` — the copy-on-write page
      duplication behind full prefix-cache hits;
    - optional ``setup(geometry)`` (allocate device pools) and
      ``programs()`` (distinct launched shapes, for the bound asserts).

    A ``draft`` model (same protocol, smaller) plus ``config.spec_k``
    turns decode rounds speculative; ``config.prefix_cache`` turns on
    copy-on-write prefix sharing (both in docs/serving.md §9).

    The engine owns the HOST side only: waiting queue (bounded by
    ``config.queue_depth`` — submission past it sheds with
    :class:`~mxnet_tpu_torch.serving.resilience.ServerOverloadedError`, the same
    backpressure contract as the predict path), slot map, page
    allocator, sampling (greedy argmax), callbacks, metrics.  One
    background thread drives :meth:`step`; tests drive it directly with
    ``autostart=False``.
    """

    def __init__(self, model, config=None, model_name="decoder",
                 autostart=False, draft=None, fault_scope="decode"):
        from .config import ServingConfig
        from .kv_cache import PrefixCache
        self.model = model
        self.config = config or ServingConfig()
        self.model_name = model_name
        # fault-injection site prefix: "decode" for a plain engine
        # (sites decode.prefill / decode.step / ...), scoped to
        # "replica.<rid>.decode" for a replica-owned engine so a chaos
        # plan can kill ONE replica's step loop deterministically
        # (docs/serving.md §10)
        self.fault_scope = str(fault_scope)
        max_context = int(model.max_context)
        self.geometry = PageGeometry(
            page_size=self.config.decode_page_size,
            pool_pages=self.config.decode_pool_pages,
            max_context=max_context,
            num_layers=getattr(model, "num_layers", 1),
            num_heads=getattr(model, "num_heads", 1),
            head_dim=getattr(model, "head_dim", 1))
        self.allocator = PageAllocator(self.geometry)
        self.max_batch = self.config.decode_max_batch
        # prompt-length buckets: the SAME power-of-two policy the
        # predict path uses for batch rows, applied to the length axis —
        # at most len(bucket_set(max_context)) prefill programs
        self.prefill_buckets = bucket_set(max_context)
        # --- speculative decoding (docs/serving.md §9) ---------------
        # a draft model + spec_k > 0 turns decode rounds into propose-k
        # -> verify-(k+1)-in-one-call; both models need the protocol
        # halves they play (the draft proposes via prefill/decode_step,
        # the target judges via verify)
        self.draft = draft
        self.spec_k = int(self.config.spec_k or 0)
        if self.spec_k and draft is None:
            _LOG.warning(
                "decode engine %s: spec_k=%d but no draft model — "
                "speculative decoding disabled (pass the draft as "
                "DecodeEngine(draft=...))",
                model_name, self.spec_k)
            self.spec_k = 0
        if self.spec_k and getattr(model, "verify", None) is None:
            raise MXNetError(
                f"decode engine {model_name!r}: speculative decoding "
                f"needs the target model to implement verify() "
                f"(multi-token window forward)")
        if self.spec_k and self.spec_k + 1 > max_context:
            raise MXNetError(
                f"decode engine {model_name!r}: spec_k={self.spec_k} "
                f"+ 1 exceeds max_context {max_context}")
        self.draft_geometry = None
        if self.spec_k:
            # the draft's K/V lives in a PARALLEL pool with the same
            # page layout, indexed by the SAME block tables — one
            # allocator serves both models, and a cached prefix page
            # carries both models' K/V for its chunk
            self.draft_geometry = PageGeometry(
                page_size=self.geometry.page_size,
                pool_pages=self.geometry.pool_pages,
                max_context=max_context,
                num_layers=getattr(draft, "num_layers", 1),
                num_heads=getattr(draft, "num_heads", 1),
                head_dim=getattr(draft, "head_dim", 1))
        # --- prefix cache (docs/serving.md §9) -----------------------
        self.prefix_cache = None
        if self.config.prefix_cache:
            missing = [m for m in ("verify", "copy_page")
                       if getattr(model, m, None) is None]
            if missing:
                _LOG.warning(
                    "decode engine %s: prefix cache requested but the "
                    "model lacks %s — disabled (plain prefill serves "
                    "every prompt)", model_name, "/".join(missing))
            else:
                self.prefix_cache = PrefixCache(
                    self.allocator,
                    max_pages=self.config.prefix_cache_pages)
        # program accounting: prefill buckets + 1 decode per model,
        # + the verify-width family (shared by prefix-hit tails and
        # speculation windows, <= the same bucket set) + 1 COW copy
        # program when the prefix cache is on
        bound = len(self.prefill_buckets) + 1
        if self.prefix_cache is not None or self.spec_k:
            bound += len(self.prefill_buckets)      # verify family
        if self.prefix_cache is not None:
            bound += 1                              # COW copy program
        if self.spec_k:
            bound += 1                  # ONE batched verify program
            # draft: prefill buckets + 1 decode + its verify family
            # (prefix-hit tail writes draft K/V through verify too)
            bound += 2 * len(self.prefill_buckets) + 1
            if self.prefix_cache is not None:
                bound += 1                          # draft COW program
        self.program_bound = bound
        setup = getattr(model, "setup", None)
        if setup is not None:
            setup(self.geometry)
        self._model_bound = setup is not None
        self._draft_bound = False
        if self.spec_k:
            draft_setup = getattr(draft, "setup", None)
            if draft_setup is not None:
                draft_setup(self.draft_geometry)
                self._draft_bound = True
        self._cond = _engine.make_condition("serving.DecodeEngine._cond")
        self._waiting = []                # FIFO of GenerateRequest
        self._running = {}                # slot -> GenerateRequest
        self._free_slots = list(range(self.max_batch - 1, -1, -1))
        self._started = False
        self._stopping = False
        self._thread = None
        self._stats = {"steps": 0, "admitted": 0, "evicted": 0,
                       "generated_tokens": 0, "peak_running": 0,
                       "shed": 0, "retries": 0, "quarantined": 0,
                       "deadline_exceeded": 0, "prefix_hits": 0,
                       "prefix_misses": 0, "prefix_tokens_saved": 0,
                       "prefix_degraded": 0, "spec_rounds": 0,
                       "spec_proposed": 0, "spec_accepted": 0,
                       "spec_fallbacks": 0}
        # jitter source for transient-retry backoff — instance-owned so
        # tests can inject a seeded one; entropy-seeded by default so
        # replicas do not retry in lockstep against a shared backend
        # deliberate jitter for retry backoff — the one sanctioned
        # ambient-entropy source (determinism-soundness exempts it)
        self._retry_rng = entropy_rng()
        _engine.watch_races(self)
        if autostart:
            self.start()

    # ----------------------------------------------------------- lifecycle
    def start(self):
        setup = getattr(self.model, "setup", None)
        draft_setup = getattr(self.draft, "setup", None) \
            if self.spec_k else None
        with self._cond:
            if self._started:
                return self
            # restart after a stop(): the stop tore the adapter's
            # device pool down — bind it again before serving
            if setup is not None and not self._model_bound:
                setup(self.geometry)
                self._model_bound = True
            if draft_setup is not None and not self._draft_bound:
                draft_setup(self.draft_geometry)
                self._draft_bound = True
            self._started = True
            self._stopping = False
            self._thread = _engine.make_thread(
                self._loop, name=f"mxnet-decode-{self.model_name}",
                owner=f"DecodeEngine({self.model_name})")
        self._thread.start()
        return self

    def stop(self, timeout=None):
        """Stop the step loop and fail every outstanding request with
        ``finish_reason="stopped"``.  Returns True once the loop thread
        is down."""
        with self._cond:
            started, thread = self._started, self._thread
            self._stopping = True
            self._cond.notify_all()
        if started and thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                return False
        with self._cond:
            outstanding = self._waiting + list(self._running.values())
            self._waiting = []
        for seq in outstanding:
            self._evict(seq, reason="stopped",
                        error=MXNetError(
                            "DecodeEngine stopped before this request "
                            "finished"))
        with self._cond:
            self._started = False
            self._thread = None
        # unbind the model adapter (drops its device KV pool) so a
        # later engine — this one restarted, or a fresh server — can
        # bind; only reached once the step loop is provably down.  The
        # prefix cache's page references go with it: a stopped engine
        # must not pin pool pages (check_leaks stays exact at teardown)
        teardown = getattr(self.model, "teardown", None)
        draft_teardown = getattr(self.draft, "teardown", None) \
            if self.spec_k else None
        with self._cond:
            if self.prefix_cache is not None:
                self.prefix_cache.clear()
            if teardown is not None and self._model_bound:
                teardown()
                self._model_bound = False
            if draft_teardown is not None and self._draft_bound:
                draft_teardown()
                self._draft_bound = False
        return True

    @property
    def started(self):
        return self._started

    # -------------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               on_token=None, timeout=None, _trace_ctx=_AMBIENT):
        """Queue one prompt for generation; returns the
        :class:`GenerateRequest` handle (``result()`` blocks on it).
        ``on_token(token_id)`` streams each generated id from the engine
        thread as it is sampled.

        ``timeout`` becomes the sequence's END-TO-END deadline: an
        expired waiting sequence is failed with
        :class:`~mxnet_tpu_torch.serving.resilience.DeadlineExceededError`
        before it consumes a decode slot or KV pages, and an expired
        running sequence is evicted (pages reclaimed) on the step that
        observes the expiry.

        ``_trace_ctx`` (internal): the caller's already-decided trace
        context — a :class:`~mxnet_tpu_torch.tracing.TraceContext`, or None
        for "the request was sampled out, stay on the no-op path".
        Left at the sentinel, the engine inspects the ambient context
        and roots its own trace (the directly-driven case)."""
        prompt = np.asarray(prompt).astype(np.int32).reshape(-1)
        if prompt.size < 1:
            raise MXNetError("generate: prompt must hold >= 1 token")
        if max_new_tokens is None:
            max_new_tokens = self.config.decode_max_new_tokens
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise MXNetError("generate: max_new_tokens must be >= 1")
        total = prompt.size + max_new_tokens
        if total > self.geometry.max_context:
            raise MXNetError(
                f"generate: prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds the model's "
                f"max_context ({self.geometry.max_context})")
        worst = self.geometry.pages_for(total)
        if worst > self.geometry.usable_pages:
            raise MXNetError(
                f"generate: request needs {worst} KV pages but the pool "
                f"only has {self.geometry.usable_pages} usable pages — "
                f"raise MXNET_SERVING_DECODE_POOL_PAGES or shorten the "
                f"request")
        if eos_id is None:
            eos_id = getattr(self.model, "eos_id", None)
        seq = GenerateRequest(prompt, max_new_tokens, eos_id, on_token,
                              deadline=Deadline.start(timeout))
        # trace identity: an explicit caller decision wins (the
        # ModelServer passes its root's context — None when that root
        # was sampled out, so the head-sampling call is made ONCE per
        # request); otherwise join the ambient trace, else root one
        # here so a directly-driven engine still records full
        # timelines.  The engine-owned root is ended at eviction, in
        # the step loop.
        if _tr._ENABLED:
            if _trace_ctx is not _AMBIENT:
                seq.trace = _trace_ctx
            else:
                ctx = _tr.current_context()
                if ctx is None:
                    root = _tr.trace("decode.request",
                                     model=self.model_name)
                    if root.sampled:
                        seq.root_span = root
                        ctx = root.context
                seq.trace = ctx
        admission = _tr.span("decode.admission", parent=seq.trace,
                             prompt_tokens=int(prompt.size),
                             max_new_tokens=max_new_tokens,
                             pages_reserved=worst)
        try:
            with self._cond:
                if not self._started or self._stopping:
                    raise MXNetError(
                        "DecodeEngine is not accepting requests (not "
                        "started, or stopping)")
                # the serving tier's backpressure contract applies to
                # the decode path too: a bounded waiting line and a
                # cheap reject with a retry hint, never an unbounded
                # queue
                if len(self._waiting) >= self.config.queue_depth:
                    self._stats["shed"] += 1
                    if _rm._ENABLED:
                        _rm.SERVING_SHED.inc(model=self.model_name)
                    admission.set_tag("shed", True)
                    raise ServerOverloadedError(
                        self.model_name, self.config.retry_after_ms,
                        f"decode waiting queue {len(self._waiting)} >= "
                        f"queue_depth {self.config.queue_depth}")
                self._waiting.append(seq)
                seq.queue_span = _tr.span(
                    "decode.queue_wait", parent=seq.trace,
                    waiting=len(self._waiting))
                self._cond.notify_all()
        except MXNetError as e:
            # flight recorder on overload; the not-accepting reject is
            # not an incident.  Runs after _cond is released.
            if isinstance(e, ServerOverloadedError):
                _tr.record_incident("decode.shed", self.debug_state)
            # order matters on an engine-rooted trace: the admission
            # span (carrying the shed tag) must land BEFORE the root
            # ends and completes the trace — a straggler would be
            # dropped (the finally's end() is then an idempotent no-op)
            admission.end()
            if seq.root_span is not None:
                seq.root_span.end(error=type(e).__name__)
            raise
        finally:
            admission.end()
        return seq

    def result(self, seq, timeout=None):
        """Block until ``seq`` finishes; returns the generated ids as an
        int32 array.  On timeout — the tighter of this call's
        ``timeout`` and the sequence's submit-time deadline — the
        request is cancelled (its slot and pages are reclaimed on the
        next step) and
        :class:`~mxnet_tpu_torch.serving.resilience.DeadlineExceededError`
        raises."""
        wait = Deadline.start(timeout)
        if seq.deadline.t is not None \
                and (wait.t is None or seq.deadline.t < wait.t):
            wait = seq.deadline
        if not seq.event.wait(wait.remaining()):
            with self._cond:
                seq.cancelled = True
                self._stats["deadline_exceeded"] += 1
                self._cond.notify_all()
            if _rm._ENABLED:
                _rm.SERVING_DEADLINE_EXCEEDED.inc(model=self.model_name)
            raise DeadlineExceededError(
                "generate", wait.timeout,
                f"{len(seq.tokens)} token(s) generated so far; the "
                f"sequence is cancelled and its pages reclaimed")
        if seq.error is not None:
            raise seq.error
        return np.asarray(seq.tokens, np.int32)

    def generate(self, prompt, max_new_tokens=None, eos_id=None,
                 on_token=None, timeout=None):
        """``submit`` + ``result`` in one call; ``timeout`` is the
        end-to-end deadline (see :meth:`submit`)."""
        return self.result(
            self.submit(prompt, max_new_tokens=max_new_tokens,
                        eos_id=eos_id, on_token=on_token,
                        timeout=timeout),
            timeout=timeout)

    # ---------------------------------------------------------- scheduling
    def _loop(self):
        while True:
            with self._cond:
                while not self._stopping and not self._waiting \
                        and not self._running:
                    # mxlint: disable=deadline-soundness (contract:
                    # idle park — no sequence is admitted, so there is
                    # no deadline to consume; every submit/stop
                    # notifies)
                    self._cond.wait()
                if self._stopping:
                    return
            try:
                self.step()
            except Exception as e:      # noqa: BLE001 — fail the batch
                # a model/compile failure must surface on the callers,
                # not kill the loop silently
                _LOG.warning("decode engine %s: step failed: %s",
                             self.model_name, e)
                with self._cond:
                    victims = self._waiting \
                        + list(self._running.values())
                    self._waiting = []
                for seq in victims:
                    self._evict(seq, reason="error", error=e)
                # an eviction storm (every in-flight sequence failed
                # at once) is exactly what the flight recorder is for
                _tr.record_incident(
                    f"decode.step_failure: {e}", self.debug_state)

    def step(self):
        """ONE scheduler iteration: admit -> prefill admitted -> one
        decode step for every running sequence -> evict finished.
        Returns the number of tokens generated this step.  The step
        loop is the only mutator of the slot map and the allocator;
        ``submit``/``stats`` only touch the waiting queue and read
        counters under the condition."""
        admitted = self._admit()
        produced = 0
        for seq in admitted:
            produced += self._prefill_one(seq)
        produced += self._decode_step()
        with self._cond:
            self._stats["steps"] += 1
            self._stats["generated_tokens"] += produced
            occupancy = self.allocator.occupancy
            shared = self.allocator.shared_pages
        if _rm._ENABLED:
            _rm.SERVING_DECODE_STEPS.inc(model=self.model_name)
            _rm.SERVING_DECODE_KV_OCCUPANCY.set(
                occupancy, engine=self.model_name)
            _rm.KV_SHARED_PAGES.set(shared, engine=self.model_name)
        return produced

    def _prefix_plan(self, seq):
        """Admission-time prefix-cache lookup — called OUTSIDE the
        engine condition (the fault site may sleep, and the radix walk
        is single-writer step-loop state anyway).  Returns
        ``(shared_pages, cow_src, hit_tokens, attempted)``; ANY lookup
        failure — including an injected ``decode.prefix_lookup``
        corruption — degrades to a miss, so the cache can cost a
        prefill but never produce wrong tokens."""
        cache = self.prefix_cache
        L = int(seq.prompt.size)
        ps = self.geometry.page_size
        if cache is None or seq.no_cache or L < ps:
            return [], None, 0, False
        try:
            _faults.inject(self.fault_scope + ".prefix_lookup")
            pages = cache.lookup(seq.prompt)
        except Exception as e:      # noqa: BLE001 — degrade to a miss
            _LOG.warning(
                "decode engine %s: prefix lookup failed for seq %d "
                "(%s); degrading to plain prefill", self.model_name,
                seq.seq_id, e)
            with self._cond:
                self._stats["prefix_degraded"] += 1
            return [], None, 0, True
        if not pages:
            return [], None, 0, True
        hit = len(pages) * ps
        if hit == L:
            # full hit: the sequence must append into the last matched
            # page (position L-1 is re-run to recover its logits) —
            # copy-on-write that one, alias the rest read-only
            return pages[:-1], pages[-1], hit, True
        return pages, None, hit, True

    def _admit(self):
        """Move waiting sequences into free decode slots while both a
        slot AND the sequence's worst-case page reservation fit
        (all-or-nothing, FIFO — a too-big head blocks the line rather
        than starving: pages freed by the next eviction admit it).
        With the prefix cache on, a cached prefix shrinks the fresh
        reservation to the unmatched pages (the shared ones are
        aliased), and cache-only pages are LRU-evicted on demand when
        the free list cannot cover an admission."""
        admitted, dropped, expired = [], [], []
        with self._cond:
            # prune cancelled AND deadline-expired entries ANYWHERE in
            # the line first — a timed-out caller must not keep
            # occupying bounded queue space just because the decode
            # batch happens to be full, and a dead request must never
            # consume a slot or KV pages
            live = []
            now = time.monotonic()
            for seq in self._waiting:
                if seq.cancelled:
                    dropped.append(seq)
                elif seq.deadline.expired(now):
                    expired.append(seq)
                else:
                    live.append(seq)
            self._waiting = live
            if expired:
                self._stats["deadline_exceeded"] += len(expired)
        while True:
            with self._cond:
                if not self._waiting or not self._free_slots:
                    break
                seq = self._waiting[0]
            # the lookup runs between the lock holds: the step loop is
            # the only consumer of the line, so the head is stable
            shared, cow_src, hit, attempted = self._prefix_plan(seq)
            with self._cond:
                if not self._waiting or self._waiting[0] is not seq \
                        or not self._free_slots:
                    break
                total = self.geometry.pages_for(
                    seq.prompt.size + seq.max_new_tokens)
                fresh = total - len(shared)
                if not self.allocator.can_allocate(fresh) \
                        and self.prefix_cache is not None:
                    # refcount-aware LRU: only pages the cache alone
                    # holds can free — and never the pages THIS
                    # admission planned to alias or COW-copy from
                    # (freeing them would strand a half-shared
                    # sequence and fail the whole step)
                    planned = set(shared)
                    if cow_src is not None:
                        planned.add(cow_src)
                    self.prefix_cache.evict(
                        fresh - self.allocator.free_pages,
                        protect_pages=planned)
                if not self.allocator.admit(seq.seq_id, shared, fresh):
                    if shared or cow_src is not None:
                        # the HIT plan is unservable under pool
                        # pressure (the protected planned pages may be
                        # the only evictable ones left): degrade to a
                        # miss — now everything cache-only may evict —
                        # rather than blocking the line on a plan the
                        # pool cannot afford
                        shared, cow_src, hit = [], None, 0
                        fresh = total
                        if not self.allocator.can_allocate(fresh):
                            self.prefix_cache.evict(
                                fresh - self.allocator.free_pages)
                        if not self.allocator.admit(seq.seq_id, [],
                                                    fresh):
                            break
                    else:
                        break
                seq.prefix_len = hit
                if cow_src is not None:
                    seq.cow = (cow_src, self.allocator.pages_of(
                        seq.seq_id)[len(shared)])
                # misses are counted here; a HIT is counted only once
                # the cached prefill actually serves (_prefill_cached)
                # — a demoted hit ran the full prefill and must not
                # inflate the hit ratio or the tokens-saved counter
                if attempted and not hit:
                    self._stats["prefix_misses"] += 1
                    if _rm._ENABLED:
                        _rm.SERVING_PREFIX_MISSES.inc(
                            model=self.model_name)
                self._waiting.pop(0)
                seq.slot = self._free_slots.pop()
                self._running[seq.slot] = seq
                self._stats["admitted"] += 1
                self._stats["peak_running"] = max(
                    self._stats["peak_running"], len(self._running))
                admitted.append(seq)
        for seq in admitted:
            # queue wait ends at slot assignment (cross-thread end:
            # the span was started in the submitter's thread)
            seq.queue_span.end(
                slot=seq.slot,
                kv_pages=len(self.allocator.pages_of(seq.seq_id)),
                kv_free_pages=self.allocator.free_pages)
        for seq in dropped:
            seq.queue_span.end(error="cancelled")
            self._finish(seq, "cancelled",
                         MXNetError("generate: request cancelled "
                                    "before admission"))
        for seq in expired:
            if _rm._ENABLED:
                _rm.SERVING_DEADLINE_EXCEEDED.inc(model=self.model_name)
            seq.queue_span.end(error="deadline")
            self._finish(seq, "deadline",
                         DeadlineExceededError(
                             "generate", seq.deadline.timeout,
                             "deadline expired while waiting — "
                             "cancelled before admission"))
        return admitted

    def _note_retry(self, attempt, exc):
        with self._cond:
            self._stats["retries"] += 1
        if _rm._ENABLED:
            _rm.SERVING_RETRIES.inc(model=self.model_name)
        _LOG.warning("decode engine %s: transient failure (retry "
                     "%d/%d): %s", self.model_name, attempt,
                     self.config.retry_max, exc)

    def _quarantine(self, seq, error, where):
        """Evict ONE poisoned sequence after its model call failed
        (post-retry, post-bisection): pages reclaimed through the
        release path the leak guards watch, batchmates keep decoding.
        """
        _LOG.warning("decode engine %s: quarantining seq %d after %s "
                     "failure: %s", self.model_name, seq.seq_id, where,
                     error)
        with self._cond:
            self._stats["quarantined"] += 1
        if _rm._ENABLED:
            _rm.SERVING_DECODE_QUARANTINED.inc(model=self.model_name)
        self._release(seq)
        self._finish(seq, "quarantined", error)
        _tr.record_incident(
            f"decode.quarantine: {where} failed for seq {seq.seq_id}: "
            f"{error}", self.debug_state)

    def _prefill_one(self, seq):
        """Run the (length-bucketed) prefill program for one admitted
        sequence and sample its first token — or, on a prefix-cache
        hit, skip the matched work via :meth:`_prefill_cached`.
        Transient failures retry with backoff; a persistent failure
        quarantines THIS sequence only (prefill is per-sequence, so no
        bisection is needed)."""
        if seq.prefix_len:
            return self._prefill_cached(seq)
        L = seq.prompt.size
        bucket = next_bucket(L, self.geometry.max_context)
        with _tr.span("decode.prefill", parent=seq.trace,
                      prompt_tokens=int(L), bucket=bucket,
                      kv_pages=len(self.allocator.pages_of(seq.seq_id))):
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :L] = seq.prompt

            def call():
                _faults.inject(self.fault_scope + ".prefill")
                return np.asarray(self.model.prefill(
                    tokens, np.int32(L),
                    self.allocator.block_table(seq.seq_id)))

            try:
                logits = retry_call(
                    call, retries=self.config.retry_max,
                    backoff_ms=self.config.retry_backoff_ms,
                    deadline=seq.deadline, rng=self._retry_rng,
                    on_retry=self._note_retry)
            except Exception as e:      # noqa: BLE001 — isolate it
                self._quarantine(seq, e, where="prefill")
                return 0
            seq.context_len = L
            seq.draft_ctx = L
            self._draft_prefill(seq, tokens, L)
            self._cache_insert(seq)
            self._emit(seq, int(np.argmax(logits)))
        self._maybe_evict(seq)
        return 1

    def _prefill_cached(self, seq):
        """Prefix-hit admission: copy-on-write the one page the
        sequence appends into, then recover the last-token logits
        through the VERIFY family — width 1 for a full hit (only the
        last prompt token is re-run), the tail bucket for a partial hit
        (unmatched tokens prefill while attending over the aliased
        cached pages).  A failure here demotes the sequence to a plain
        prefill on the next step: the cache may cost time, never
        correctness.  A :class:`KernelError` (the verify kernel failed
        to build, launch or take its inputs) quarantines the sequence
        instead — demoting would serve the hit without the kernel."""
        L = int(seq.prompt.size)
        m = seq.prefix_len
        start = L - 1 if m == L else m
        tail = seq.prompt[start:]
        length = int(tail.size)
        bucket = next_bucket(length, self.geometry.max_context)
        with _tr.span("decode.prefill", parent=seq.trace,
                      prompt_tokens=int(L), bucket=bucket,
                      prefix_hit_tokens=int(m),
                      cow=seq.cow is not None,
                      kv_pages=len(self.allocator.pages_of(seq.seq_id))):
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :length] = tail
            block_table = self.allocator.block_table(seq.seq_id)

            def call():
                if seq.cow is not None:
                    # src is immutable, so re-copying on a retry is
                    # harmless — clear the plan only after both copies
                    # landed
                    src, dst = seq.cow
                    self.model.copy_page(src, dst)
                    if self.spec_k and not seq.no_spec:
                        self.draft.copy_page(src, dst)
                    seq.cow = None
                _faults.inject(self.fault_scope + ".prefill")
                return np.asarray(self.model.verify(
                    tokens, np.int32(start), np.int32(length),
                    block_table))

            try:
                logits = retry_call(
                    call, retries=self.config.retry_max,
                    backoff_ms=self.config.retry_backoff_ms,
                    deadline=seq.deadline, rng=self._retry_rng,
                    on_retry=self._note_retry)
            except KernelError as e:
                self._quarantine(seq, e, where="cached prefill")
                return 0
            except Exception as e:      # noqa: BLE001 — degrade
                self._demote_to_plain(seq, e)
                return 0
            # the hit is real only now — the cached path SERVED.  A
            # full hit still re-ran its last token, so it saves m-1
            saved = m - 1 if m == L else m
            with self._cond:
                self._stats["prefix_hits"] += 1
                self._stats["prefix_tokens_saved"] += saved
            if _rm._ENABLED:
                _rm.SERVING_PREFIX_HITS.inc(model=self.model_name)
                _rm.SERVING_PREFIX_TOKENS_SAVED.inc(
                    saved, model=self.model_name)
            seq.context_len = L
            seq.draft_ctx = L
            if self.spec_k and not seq.no_spec:
                # the draft's K/V for the tail rides the same verify
                # shape (its logits are discarded); cached pages
                # already hold the draft K/V their writer produced
                try:
                    self.draft.verify(tokens, np.int32(start),
                                      np.int32(length), block_table)
                except Exception as e:  # noqa: BLE001 — optimization
                    self._spec_fallback(seq, e, where="draft tail")
            self._cache_insert(seq)
            self._emit(seq, int(np.argmax(logits[length - 1])))
        self._maybe_evict(seq)
        return 1

    def _draft_prefill(self, seq, tokens, L):
        """Write the prompt's DRAFT K/V (speculation needs the draft to
        know the prefix).  A draft failure never fails the request —
        the sequence just decodes plainly."""
        if not self.spec_k or seq.no_spec:
            return
        try:
            self.draft.prefill(tokens, np.int32(L),
                               self.allocator.block_table(seq.seq_id))
        except Exception as e:          # noqa: BLE001 — optimization
            self._spec_fallback(seq, e, where="draft prefill")

    def _spec_fallback(self, seq, error, where):
        if isinstance(error, KernelError):
            # not an optimization failing: the kernel cannot run, and
            # the step loop fails the requests loudly
            raise error
        _LOG.warning(
            "decode engine %s: %s failed for seq %d (%s); the "
            "sequence decodes without speculation", self.model_name,
            where, seq.seq_id, error)
        seq.no_spec = True
        with self._cond:
            self._stats["spec_fallbacks"] += 1

    def _cache_insert(self, seq):
        """Admit the prompt's full-page chunks into the prefix cache,
        backed by this sequence's (now fully written) pages.  Chunks
        that were aliased at admission are already cached and skip."""
        if self.prefix_cache is None or seq.no_cache:
            return
        with self._cond:
            self.prefix_cache.insert(
                seq.prompt, self.allocator.pages_of(seq.seq_id))

    def _demote_to_plain(self, seq, error):
        """Cached-path prefill failed: release everything the sequence
        holds (aliased refs and fresh pages alike) and put it back at
        the HEAD of the waiting line with the cache bypassed — the
        next step admits it down the plain-prefill path.  Degradation,
        not quarantine: the failure sits on the optimization path, so
        the model itself is not implicated."""
        _LOG.warning(
            "decode engine %s: cached prefill failed for seq %d (%s); "
            "demoting to plain prefill", self.model_name, seq.seq_id,
            error)
        with self._cond:
            self._stats["prefix_degraded"] += 1
            # undo the admission bookkeeping (it re-admits next step:
            # counting it twice would break admitted-evicted==running)
            self._stats["admitted"] -= 1
            if seq.slot is not None:
                self._running.pop(seq.slot, None)
                self._free_slots.append(seq.slot)
                seq.slot = None
            self.allocator.release(seq.seq_id)
            seq.prefix_len = 0
            seq.cow = None
            seq.no_cache = True
            self._waiting.insert(0, seq)
            self._cond.notify_all()

    def _decode_call(self, active):
        """One fixed-shape decode-step model call for the ``active``
        subset (inactive slots zeroed, exactly the padding contract the
        programs already honor).  Transient failures retry with
        backoff; a persistent failure BISECTS the subset so the
        poisoned sequence is quarantined alone and the rest of the
        batch keeps decoding.  Returns ``(seq, logits_row, t0, t1,
        batch_n)`` tuples for the sequences that got a token."""
        B, P = self.max_batch, self.geometry.pages_per_seq
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        block_tables = np.zeros((B, P), np.int32)
        for seq in active:
            # the slot's current token is the LAST sampled one — its
            # K/V is written at `positions` (== context so far) by the
            # decode program, which then attends over the full context
            tokens[seq.slot] = seq.tokens[-1]
            positions[seq.slot] = seq.context_len
            block_tables[seq.slot] = self.allocator.block_table(
                seq.seq_id)

        def call():
            _faults.inject(self.fault_scope + ".step")
            return np.asarray(self.model.decode_step(
                tokens, positions, block_tables))

        # retry backoff must not sleep past the TIGHTEST member
        # deadline: the single engine thread is every sequence's clock,
        # so one sleep drains every running budget at once
        times = [s.deadline.t for s in active if s.deadline.t is not None]
        group_deadline = Deadline(min(times)) if times else Deadline()
        t0 = time.perf_counter()
        try:
            logits = retry_call(
                call, retries=self.config.retry_max,
                backoff_ms=self.config.retry_backoff_ms,
                deadline=group_deadline,
                rng=self._retry_rng, on_retry=self._note_retry)
        except Exception as e:          # noqa: BLE001 — isolate it
            if len(active) == 1:
                self._quarantine(active[0], e, where="decode step")
                return []
            _LOG.warning("decode engine %s: step failed for %d "
                         "sequence(s) (%s); bisecting to quarantine "
                         "the poisoned sequence", self.model_name,
                         len(active), e)
            mid = len(active) // 2
            # re-running a subset re-writes the SAME K/V positions
            # (idempotent) — a failed call never advanced context_len
            return self._decode_call(active[:mid]) \
                + self._decode_call(active[mid:])
        t1 = time.perf_counter()
        return [(seq, logits[seq.slot], t0, t1, len(active))
                for seq in active]

    def _decode_step(self):
        """One decode round over every running sequence: speculative
        sequences (draft available, >= 2 tokens of budget left) go
        through :meth:`_spec_round`; everything else gets the plain
        bisection-aware batched decode step.  The two groups share the
        fixed-shape programs — each zeroes the other's slots."""
        with self._cond:
            running = [s for s in self._running.values()
                       if not s.cancelled]
            cancelled = [s for s in self._running.values()
                         if s.cancelled]
        for seq in cancelled:
            self._release(seq)
            self._finish(seq, "cancelled",
                         MXNetError("generate: request cancelled"))
        if not running:
            return 0
        # deterministic bisection order: slot order, not dict order
        running.sort(key=lambda s: s.slot)
        if not self.spec_k:
            return self._plain_decode(running)
        spec, plain = [], []
        for s in running:
            # a sequence one token from its cap gains nothing from a
            # proposal round (the verify bonus token finishes it), and
            # a draft-fallback sequence decodes plainly for good
            if not s.no_spec and s.max_new_tokens - len(s.tokens) >= 2:
                spec.append(s)
            else:
                plain.append(s)
        produced = 0
        if plain:
            produced += self._plain_decode(plain)
        if spec:
            produced += self._spec_round(spec)
        return produced

    def _plain_decode(self, running):
        """One non-speculative decode step for ``running`` (the
        original bisection-aware path)."""
        produced = 0
        for seq, row, t0, t1, batch_n in self._decode_call(running):
            # per-sequence decode-step spans (first step, then every
            # Nth): ONE device call serves the whole batch, so each due
            # sequence gets the shared interval with its own tags
            if seq.trace is not None:
                n_prior = len(seq.tokens)
                if n_prior == 1 or n_prior % _STEP_SPAN_EVERY == 0:
                    _tr.record_span(
                        "decode.step", seq.trace, t0, t1,
                        {"step": n_prior, "slot": seq.slot,
                         "context_len": seq.context_len,
                         "batch": batch_n,
                         "kv_pages": len(self.allocator.pages_of(
                             seq.seq_id))})
            seq.context_len += 1
            self._emit(seq, int(np.argmax(row)))
            produced += 1
            self._maybe_evict(seq)
        return produced

    def _spec_round(self, seqs):
        """One speculative round (docs/serving.md §9): the draft
        proposes up to ``spec_k`` tokens per sequence via batched draft
        decode steps over the SHARED block tables (writing its own
        pool), then the target judges each sequence's whole window —
        last sampled token + proposals — in ONE verify call, the
        ragged multi-token shape ``ragged_paged_verify`` exists for
        (one ``verify_batch`` program when the model has it, else one
        width-bucketed call per window).  Greedy acceptance is exact
        (the
        zero-temperature limit of rejection sampling): proposal i
        survives iff it equals the target argmax after position i, the
        first mismatch is replaced by the target's own token, and a
        fully accepted window earns the bonus token — so outputs are
        byte-identical with speculation on or off.  Rejected positions
        roll back through bookkeeping alone: their K/V sits beyond
        ``context_len``, is never attended, and is overwritten in
        place by later writes.

        Failure containment: a draft failure degrades the ROUND to one
        plain decode step (the draft is an optimization); a verify
        failure is a target-model failure and quarantines that
        sequence alone, like the prefill/decode paths (§8)."""
        k = self.spec_k
        B, P = self.max_batch, self.geometry.pages_per_seq
        tables = {s.seq_id: self.allocator.block_table(s.seq_id)
                  for s in seqs}
        plan = []
        for s in seqs:
            ctx = s.context_len
            # known tokens the draft consumes before free-running: the
            # catch-up gap (a fully-accepted previous round leaves the
            # last accepted proposal's draft K/V unwritten) + the last
            # sampled token
            feed = [s.token_at(p) for p in range(s.draft_ctx, ctx + 1)]
            m = min(k, s.max_new_tokens - len(s.tokens) - 1)
            plan.append({"seq": s, "feed": feed, "cur": feed.pop(0),
                         "pos": s.draft_ctx, "proposals": [],
                         "steps": m + len(feed)})
        max_steps = max(p["steps"] for p in plan)
        for st in range(max_steps):
            tokens = np.zeros((B,), np.int32)
            positions = np.zeros((B,), np.int32)
            block_tables = np.zeros((B, P), np.int32)
            active = [p for p in plan if st < p["steps"]]
            for p in active:
                slot = p["seq"].slot
                tokens[slot] = p["cur"]
                positions[slot] = p["pos"]
                block_tables[slot] = tables[p["seq"].seq_id]
            try:
                logits = np.asarray(self.draft.decode_step(
                    tokens, positions, block_tables))
            except Exception as e:  # noqa: BLE001 — draft died
                if isinstance(e, KernelError):
                    raise
                # proposals so far are unusable mid-round state; the
                # round degrades to ONE plain target step (correct by
                # construction) and the draft gets another chance next
                # round — partially written draft K/V beyond draft_ctx
                # is rolled back by never advancing the counter
                _LOG.warning(
                    "decode engine %s: draft step failed mid-round "
                    "(%s); running this round without speculation",
                    self.model_name, e)
                with self._cond:
                    self._stats["spec_fallbacks"] += len(seqs)
                return self._plain_decode(seqs)
            for p in active:
                out = int(np.argmax(logits[p["seq"].slot]))
                p["pos"] += 1
                if p["feed"]:
                    p["cur"] = p["feed"].pop(0)     # catch-up: discard
                else:
                    p["proposals"].append(out)
                    p["cur"] = out
        W = next_bucket(k + 1, self.geometry.max_context)
        if getattr(self.model, "verify_batch", None) is not None:
            judged = self._verify_batched(plan, tables, W)
        else:
            judged = self._verify_each(plan, tables, W)
        produced = 0
        for p, logits, t0, t1 in judged:
            seq = p["seq"]
            proposals = p["proposals"]
            ctx = seq.context_len
            # greedy-exact acceptance: row i of logits is the target's
            # next-token distribution after consuming window[i]
            accept = 0
            while accept < len(proposals) \
                    and proposals[accept] == int(np.argmax(logits[accept])):
                accept += 1
            emits = proposals[:accept] + [int(np.argmax(logits[accept]))]
            with self._cond:
                self._stats["spec_rounds"] += 1
                self._stats["spec_proposed"] += len(proposals)
                self._stats["spec_accepted"] += accept
            if _rm._ENABLED:
                _rm.SERVING_SPEC_PROPOSED.inc(len(proposals),
                                              model=self.model_name)
                _rm.SERVING_SPEC_ACCEPTED.inc(accept,
                                              model=self.model_name)
            # KV rollback of rejected positions = counter bookkeeping:
            # target context covers the accepted prefix + the emitted
            # correction/bonus token's predecessor; the draft rolls
            # back to the target's context when it speculated past it
            seq.context_len = ctx + accept + 1
            seq.draft_ctx = min(p["pos"], seq.context_len)
            if seq.trace is not None:
                n_prior = len(seq.tokens)
                if n_prior == 1 or n_prior % _STEP_SPAN_EVERY == 0:
                    _tr.record_span(
                        "decode.verify", seq.trace, t0, t1,
                        {"proposed": len(proposals),
                         "accepted": accept, "slot": seq.slot,
                         "context_len": seq.context_len})
            for t in emits:
                self._emit(seq, int(t))
                produced += 1
                if self._maybe_evict(seq):
                    break
        return produced

    def _verify_batched(self, entries, tables, W):
        """ONE fixed-shape verify call judging every entry's window at
        once (inactive slots zeroed — the padding contract of
        ``paged_verify_batch``).  Transient failures retry with
        backoff; a persistent failure BISECTS so the poisoned sequence
        is quarantined alone while its batchmates' windows are
        re-judged — the §8 containment applied to the verify family.
        Re-running a subset re-writes the SAME K/V positions
        (idempotent: a failed call never advanced context_len).
        Returns ``(entry, logits (W, V), t0, t1)`` tuples."""
        B, P = self.max_batch, self.geometry.pages_per_seq
        tokens = np.zeros((B, W), np.int32)
        starts = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        block_tables = np.zeros((B, P), np.int32)
        for p in entries:
            seq = p["seq"]
            window = [seq.tokens[-1]] + p["proposals"]
            tokens[seq.slot, :len(window)] = window
            starts[seq.slot] = seq.context_len
            lengths[seq.slot] = len(window)
            block_tables[seq.slot] = tables[seq.seq_id]

        def call():
            _faults.inject(self.fault_scope + ".verify")
            return np.asarray(self.model.verify_batch(
                tokens, starts, lengths, block_tables))

        times = [p["seq"].deadline.t for p in entries
                 if p["seq"].deadline.t is not None]
        group_deadline = Deadline(min(times)) if times else Deadline()
        t0 = time.perf_counter()
        try:
            logits = retry_call(
                call, retries=self.config.retry_max,
                backoff_ms=self.config.retry_backoff_ms,
                deadline=group_deadline, rng=self._retry_rng,
                on_retry=self._note_retry)
        except Exception as e:          # noqa: BLE001 — isolate it
            if len(entries) == 1:
                self._quarantine(entries[0]["seq"], e, where="verify")
                return []
            _LOG.warning(
                "decode engine %s: verify failed for %d window(s) "
                "(%s); bisecting to quarantine the poisoned sequence",
                self.model_name, len(entries), e)
            mid = len(entries) // 2
            return self._verify_batched(entries[:mid], tables, W) \
                + self._verify_batched(entries[mid:], tables, W)
        t1 = time.perf_counter()
        return [(p, logits[p["seq"].slot], t0, t1) for p in entries]

    def _verify_each(self, entries, tables, W):
        """Per-sequence verify fallback for models without
        ``verify_batch`` (fakes, external adapters): same judging, one
        width-W call per window; a persistent failure quarantines that
        sequence alone (already single, no bisection needed)."""
        out = []
        for p in entries:
            seq = p["seq"]
            window = [seq.tokens[-1]] + p["proposals"]
            tokens = np.zeros((1, W), np.int32)
            tokens[0, :len(window)] = window
            block_table = tables[seq.seq_id]
            length = len(window)

            def call():
                _faults.inject(self.fault_scope + ".verify")
                return np.asarray(self.model.verify(
                    tokens, np.int32(seq.context_len),
                    np.int32(length), block_table))

            t0 = time.perf_counter()
            try:
                logits = retry_call(
                    call, retries=self.config.retry_max,
                    backoff_ms=self.config.retry_backoff_ms,
                    deadline=seq.deadline, rng=self._retry_rng,
                    on_retry=self._note_retry)
            except Exception as e:      # noqa: BLE001 — isolate it
                self._quarantine(seq, e, where="verify")
                continue
            out.append((p, logits, t0, time.perf_counter()))
        return out

    # ----------------------------------------------------- token plumbing
    def _emit(self, seq, token):
        now = time.monotonic()
        if seq.t_first is None:
            seq.t_first = now
            if _rm._ENABLED:
                _rm.SERVING_DECODE_TTFT_SECONDS.observe(
                    now - seq.t_submit, model=self.model_name,
                    exemplar=None if seq.trace is None
                    else seq.trace.trace_id)
        elif _rm._ENABLED:
            _rm.SERVING_DECODE_TOKEN_SECONDS.observe(
                now - seq.t_prev, model=self.model_name)
        seq.t_prev = now
        seq.tokens.append(token)
        if _rm._ENABLED:
            _rm.SERVING_DECODE_TOKENS.inc(model=self.model_name)
        if seq.on_token is not None:
            try:
                seq.on_token(token)
            except Exception as e:      # noqa: BLE001 — caller's bug
                _LOG.warning("decode engine %s: on_token callback "
                             "failed: %s", self.model_name, e)

    def _maybe_evict(self, seq):
        """Finish checks after a sampled token; evicts when done.  A
        running sequence past its deadline evicts here (pages
        reclaimed) — a request never outlives its timeout inside the
        decode batch."""
        reason = error = None
        if seq.eos_id is not None and seq.tokens[-1] == seq.eos_id:
            reason = "eos"
        elif len(seq.tokens) >= seq.max_new_tokens:
            reason = "length"
        elif seq.cancelled:
            reason = "cancelled"
            error = MXNetError("generate: request cancelled")
        elif seq.deadline.expired():
            reason = "deadline"
            error = DeadlineExceededError(
                "generate", seq.deadline.timeout,
                f"deadline expired mid-generation after "
                f"{len(seq.tokens)} token(s); sequence evicted and "
                f"pages reclaimed")
            with self._cond:
                self._stats["deadline_exceeded"] += 1
            if _rm._ENABLED:
                _rm.SERVING_DEADLINE_EXCEEDED.inc(model=self.model_name)
        if reason is None:
            return False
        self._release(seq)
        self._finish(seq, reason, error)
        return True

    def _release(self, seq):
        """Return a running sequence's slot + pages.  The evictions
        counter moves here, not in ``_finish``: a request cancelled
        while still WAITING never held a slot or pages, so counting it
        would break ``admitted - evicted == running``."""
        with self._cond:
            if seq.slot is not None:
                self._running.pop(seq.slot, None)
                self._free_slots.append(seq.slot)
                seq.slot = None
                seq.released_pages = self.allocator.release(seq.seq_id)
                self._stats["evicted"] += 1
                if _rm._ENABLED:
                    _rm.SERVING_DECODE_EVICTIONS.inc(
                        model=self.model_name)
                self._cond.notify_all()

    def _finish(self, seq, reason, error=None):
        seq.finish_reason = reason
        if error is not None:
            seq.error = error
        if seq.trace is not None:
            now = time.perf_counter()
            _tr.record_span(
                "decode.evict", seq.trace, now, now,
                {"reason": reason,
                 "pages_released": seq.released_pages,
                 "generated_tokens": len(seq.tokens)})
            if seq.root_span is not None:
                # engine-rooted trace: the request span closes at
                # eviction (server-rooted ones close in the caller)
                seq.root_span.end(finish_reason=reason)
        seq.event.set()

    def _evict(self, seq, reason, error):
        """Out-of-band eviction (stop/step-failure): release whatever
        the sequence holds and fail it."""
        self._release(seq)
        seq.queue_span.end(error=reason)     # idempotent if admitted
        self._finish(seq, reason, error)

    # ---------------------------------------------------------------- info
    def stats(self):
        with self._cond:
            out = dict(self._stats)
            out["running"] = len(self._running)
            out["waiting"] = len(self._waiting)
            out.update(self.allocator.stats())
            if self.prefix_cache is not None:
                out.update(self.prefix_cache.stats())
        out["program_bound"] = self.program_bound
        out["spec_k"] = self.spec_k
        if out.get("spec_proposed"):
            out["spec_acceptance"] = (out["spec_accepted"]
                                      / out["spec_proposed"])
        programs = getattr(self.model, "programs", None)
        if programs is not None:
            total = programs()
            draft_programs = getattr(self.draft, "programs", None) \
                if self.spec_k else None
            if draft_programs is not None:
                total += draft_programs()
            out["programs"] = total
        return out

    def debug_state(self):
        """JSON-serializable scheduler snapshot for the flight
        recorder: per-sequence slot map with block-table occupancy,
        the waiting line, free slots/pages, and the counters
        (``ModelServer.debug_state`` aggregates one per engine)."""
        now = time.monotonic()
        with self._cond:
            running = [
                {"seq_id": s.seq_id, "slot": s.slot,
                 "context_len": s.context_len,
                 "generated_tokens": len(s.tokens),
                 "max_new_tokens": s.max_new_tokens,
                 "cancelled": s.cancelled,
                 "age_s": round(now - s.t_submit, 6),
                 "kv_pages": len(self.allocator.pages_of(s.seq_id)),
                 "trace_id": None if s.trace is None
                 else s.trace.trace_id}
                for s in self._running.values()]
            waiting = [
                {"seq_id": s.seq_id, "prompt_tokens": int(s.prompt.size),
                 "cancelled": s.cancelled,
                 "age_s": round(now - s.t_submit, 6)}
                for s in self._waiting]
            state = {
                "model": self.model_name,
                "started": self._started,
                "stopping": self._stopping,
                "max_batch": self.max_batch,
                "free_slots": len(self._free_slots),
                "running": running,
                "waiting": waiting,
                "allocator": self.allocator.stats(),
                "stats": dict(self._stats),
            }
            if self.prefix_cache is not None:
                state["prefix_cache"] = self.prefix_cache.stats()
        state["program_bound"] = self.program_bound
        state["spec_k"] = self.spec_k
        programs = getattr(self.model, "programs", None)
        if programs is not None:
            state["programs"] = programs()
            draft_programs = getattr(self.draft, "programs", None) \
                if self.spec_k else None
            if draft_programs is not None:
                state["draft_programs"] = draft_programs()
        return state


# ---------------------------------------------------------------------------
# model adapters
# ---------------------------------------------------------------------------
class PagedLMAdapter:
    """Decode-model protocol over a
    :class:`~mxnet_tpu_torch.models.transformer_blocks.TransformerDecoderLM`.

    Owns the device KV pools and runs the LM's paged decode-mode
    forwards eagerly — ``paged_prefill`` / ``paged_decode_step`` /
    ``paged_verify`` / ``paged_verify_batch``, plus the copy-on-write
    page copy.  Decode and verify attention launch the hand-written CUDA
    kernels on a CUDA device and take their plain PyTorch versions on
    ``device="cpu"``: dispatch is by the tensors' device, with no
    fallback between the two.

    The engine's protocol stays numpy-facing: int32 inputs move to the
    device, logits come back as host numpy arrays.  :meth:`programs`
    counts the distinct (family, shape) signatures launched — the eager
    counterpart of the JAX adapter's compiled-program count, so the
    engine's ``programs <= program_bound`` check keeps its meaning.
    """

    def __init__(self, lm, eos_id=None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise MXNetError(
                "PagedLMAdapter: device 'cuda' requested but no CUDA "
                "device is available — pass device='cpu' to serve on the "
                "CPU")
        self.lm = lm
        self.device = device
        self.vocab_size = lm.vocab_size
        self.max_context = lm.max_context
        self.num_layers = lm.num_layers
        self.num_heads = lm.num_heads
        self.head_dim = lm.head_dim
        if eos_id is not None:
            self.eos_id = int(eos_id)
        self.params = paged_lm_params(lm, device=device)
        self.pool = None
        self._kw = None
        self._signatures = set()        # (family, shape...) launched

    def refresh(self):
        """Re-snapshot the LM's parameters (publish new weights)."""
        self.params = paged_lm_params(self.lm, device=self.device)

    def teardown(self):
        """Unbind from a stopped engine: drop the device pool (a retired
        engine must not pin KV memory) so a later engine can bind."""
        self.pool = None

    def setup(self, geometry):
        # one LIVE engine per adapter: the pool is this adapter's state,
        # and a second engine calling setup() would zero the pool under
        # the first one's feet.  The engine's stop() calls teardown(),
        # so restart cycles rebind cleanly.
        if self.pool is not None:
            raise MXNetError(
                "PagedLMAdapter: already bound to a live decode engine "
                "— one adapter serves ONE engine at a time; build a "
                "separate PagedLMAdapter per engine")
        self.pool = DeviceKVPool(geometry, device=self.device)
        self._kw = dict(num_heads=self.num_heads,
                        page_size=geometry.page_size,
                        activation=self.lm._activation,
                        layer_norm_eps=self.lm._eps)

    def programs(self):
        """Distinct (family, shape) signatures launched so far across
        prefill, decode, verify, batched verify and the COW copy."""
        return len(self._signatures)

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # ------------------------------------------------------------ protocol
    def prefill(self, tokens, length, block_table):
        pool = self.pool
        self._signatures.add(("prefill", tokens.shape[1]))
        # device-call child of the engine's decode.prefill span (no-op
        # without an ambient span)
        with _tr.span("paged_lm.prefill", bucket=int(tokens.shape[1])), \
                torch.no_grad():
            logits, _, _ = paged_prefill(
                self.params, self._dev(tokens), int(length),
                self._dev(block_table), pool.k_pages, pool.v_pages,
                **self._kw)
            return logits.cpu().numpy()

    def decode_step(self, tokens, positions, block_tables):
        pool = self.pool
        self._signatures.add(("decode", tokens.shape[0]))
        # no adapter-level span here: ONE device call serves many traces,
        # and the step loop records the timed interval per sequence
        with torch.no_grad():
            logits, _, _ = paged_decode_step(
                self.params, self._dev(tokens), self._dev(positions),
                self._dev(block_tables), pool.k_pages, pool.v_pages,
                **self._kw)
            return logits.cpu().numpy()

    def verify(self, tokens, start, length, block_table):
        """Multi-token window forward (speculation verify / prefix-hit
        tail): writes the window's K/V through the block table and
        returns per-row logits (rows past ``length`` are garbage the
        engine never reads)."""
        pool = self.pool
        self._signatures.add(("verify", tokens.shape[1]))
        with _tr.span("paged_lm.verify", bucket=int(tokens.shape[1])), \
                torch.no_grad():
            logits, _, _ = paged_verify(
                self.params, self._dev(tokens), int(start), int(length),
                self._dev(block_table), pool.k_pages, pool.v_pages,
                **self._kw)
            return logits.cpu().numpy()

    def verify_batch(self, tokens, starts, lengths, block_tables):
        """Batched verify: every running sequence's speculation window
        judged in ONE call (B and W are both fixed per engine)."""
        pool = self.pool
        self._signatures.add(("verify_batch",) + tuple(tokens.shape))
        with torch.no_grad():
            logits, _, _ = paged_verify_batch(
                self.params, self._dev(tokens), self._dev(starts),
                self._dev(lengths), self._dev(block_tables), pool.k_pages,
                pool.v_pages, **self._kw)
            return logits.cpu().numpy()

    def copy_page(self, src, dst):
        """Copy-on-write page duplication across all layers of both
        pools, in place."""
        self._signatures.add(("cow",))
        self.pool.copy_page(src, dst)


def as_decode_model(obj, eos_id=None, device="cuda"):
    """Normalize a decode model into the decode-model protocol: objects
    already implementing ``prefill``/``decode_step`` pass through
    (fake/cheap test models); a :class:`TransformerDecoderLM` is wrapped
    in :class:`PagedLMAdapter` on ``device``."""
    if hasattr(obj, "prefill") and hasattr(obj, "decode_step"):
        return obj
    if isinstance(obj, TransformerDecoderLM):
        return PagedLMAdapter(obj, eos_id=eos_id, device=device)
    raise MXNetError(
        f"as_decode_model: {type(obj).__name__} neither implements the "
        f"decode-model protocol (prefill/decode_step) nor is a "
        f"TransformerDecoderLM")
