"""Serving policy knobs (docs/serving.md).

The PyTorch port's copy of ``mxnet_tpu.serving.config``: the predict
path's batching, backpressure, deadline and circuit-breaker knobs and
the decode engine's, the replica layer's (``replicas*``) and the
tiered-admission gate's (``tenant_tiers``, ``admission_shed_start``),
under the same ``MXNET_SERVING_*`` names and with the same defaults and
validation.

Defaults come from the ``MXNET_SERVING_*`` environment variables
(declared in ``base.py``, documented in ``docs/env_vars.md``);
constructor arguments override per server.
"""
from __future__ import annotations

from ..base import MXNetError, get_env

__all__ = ["ServingConfig"]


class ServingConfig:
    """Batching + backpressure policy for one :class:`ModelServer` (and
    its decode engines).

    - ``max_batch_size``: row cap per coalesced batch; shape buckets are
      powers of two up to it, so at most ``ceil(log2(max_batch))+1``
      programs are built per model signature.
    - ``max_latency_us``: how long the batcher holds the first request
      of a forming batch waiting for more work (the latency half of the
      batching policy).
    - two-level backpressure: ``shed_watermark`` (<= queue_depth,
      default equal to it) bounds the WAITING queue — at/above it
      admission sheds with ``ServerOverloadedError(retry_after_ms)``;
      ``queue_depth`` additionally bounds total outstanding work
      (queued + dispatched-but-unfinished), so a slow model cannot
      pile up unbounded in-flight batches.  A decode engine bounds its
      waiting requests by ``queue_depth``.
    - ``num_workers``: dispatch threads forming and executing batches.

    Decode-engine knobs (autoregressive ``generate()``, docs/serving.md
    §6): ``decode_page_size`` tokens per KV page,
    ``decode_pool_pages`` total preallocated pages (incl. the null
    page), ``decode_max_batch`` sequence slots in the fixed-shape
    decode step, ``decode_max_new_tokens`` default generation cap.

    Decode optimizations (docs/serving.md §9): ``prefix_cache``
    enables copy-on-write KV page sharing (a prompt whose prefix is
    cached skips that prefill) with ``prefix_cache_pages`` capping
    cache-held pages (0 = bounded by the pool alone); ``spec_k`` > 0
    enables speculative decoding — a draft model proposes up to k
    tokens per sequence, the target verifies them in one call —
    with ``spec_draft`` naming the repository entry whose decode
    model serves as the default draft.

    Resilience knobs (docs/serving.md §8): ``deadline_default``
    seconds applied when a call passes no timeout (None = unbounded),
    ``retry_max`` transient-failure re-executions with
    ``retry_backoff_ms`` jittered exponential backoff, and the
    per-model-version circuit breaker (``circuit_window`` sliding
    outcomes, trip at ``circuit_threshold`` error rate, shed for
    ``circuit_cooldown_ms`` before the half-open probe;
    ``circuit_window=0`` disables).

    Replica knobs: ``replicas`` > 1 serves each model version through a
    :class:`~mxnet_tpu_torch.serving.replica.ReplicaSet` — N replicas,
    least-loaded routing among HEALTHY replicas, failover under the
    original deadline, prewarm-gated rolling recovery.  Health policy:
    ``replica_heartbeat_ms`` beat interval,
    ``replica_heartbeat_window_ms`` staleness bound past which a
    replica is unroutable, ``replica_failure_threshold`` consecutive
    typed failures that trip its breaker without filling the windowed
    error rate.

    Admission knobs (docs/serving.md §11): ``tenant_tiers`` spec
    string ('name=priority[/quota_rps[/burst]]', comma-separated)
    enables the per-tenant admission gate — quota token buckets plus
    priority shedding under overload, lowest tier first starting at
    pressure ``admission_shed_start``.  None (default) disables it.
    """

    def __init__(self, max_batch_size=None, max_latency_us=None,
                 queue_depth=None, shed_watermark=None, num_workers=None,
                 retry_after_ms=None, decode_page_size=None,
                 decode_pool_pages=None, decode_max_batch=None,
                 decode_max_new_tokens=None, deadline_default=None,
                 retry_max=None, retry_backoff_ms=None,
                 circuit_window=None, circuit_threshold=None,
                 circuit_cooldown_ms=None, prefix_cache=None,
                 prefix_cache_pages=None, spec_k=None, spec_draft=None,
                 replicas=None, replica_heartbeat_ms=None,
                 replica_heartbeat_window_ms=None,
                 replica_failure_threshold=None, tenant_tiers=None,
                 admission_shed_start=None):
        def pick(value, env, typ=int):
            if value is None:
                value = get_env(env, typ=typ)
            return None if value is None else typ(value)

        self.max_batch_size = pick(max_batch_size,
                                   "MXNET_SERVING_MAX_BATCH")
        self.max_latency_us = pick(max_latency_us,
                                   "MXNET_SERVING_MAX_LATENCY_US")
        self.queue_depth = pick(queue_depth, "MXNET_SERVING_QUEUE_DEPTH")
        self.shed_watermark = pick(shed_watermark,
                                   "MXNET_SERVING_SHED_WATERMARK")
        if self.shed_watermark is None:
            self.shed_watermark = self.queue_depth
        self.num_workers = pick(num_workers, "MXNET_SERVING_WORKERS")
        self.retry_after_ms = pick(retry_after_ms,
                                   "MXNET_SERVING_RETRY_AFTER_MS")
        self.decode_page_size = pick(decode_page_size,
                                     "MXNET_SERVING_DECODE_PAGE_SIZE")
        self.decode_pool_pages = pick(decode_pool_pages,
                                      "MXNET_SERVING_DECODE_POOL_PAGES")
        self.decode_max_batch = pick(decode_max_batch,
                                     "MXNET_SERVING_DECODE_MAX_BATCH")
        self.decode_max_new_tokens = pick(
            decode_max_new_tokens, "MXNET_SERVING_DECODE_MAX_NEW_TOKENS")
        # decode optimizations (docs/serving.md §9)
        self.prefix_cache = bool(pick(prefix_cache,
                                      "MXNET_SERVING_PREFIX_CACHE"))
        self.prefix_cache_pages = pick(prefix_cache_pages,
                                       "MXNET_SERVING_PREFIX_CACHE_PAGES")
        self.spec_k = pick(spec_k, "MXNET_SERVING_SPEC_K")
        self.spec_draft = spec_draft if spec_draft is not None \
            else get_env("MXNET_SERVING_SPEC_DRAFT", typ=str)
        # resilience policy (docs/serving.md §8)
        self.deadline_default = pick(deadline_default,
                                     "MXNET_SERVING_DEADLINE_DEFAULT",
                                     typ=float)
        self.retry_max = pick(retry_max, "MXNET_SERVING_RETRY_MAX")
        self.retry_backoff_ms = pick(retry_backoff_ms,
                                     "MXNET_SERVING_RETRY_BACKOFF_MS",
                                     typ=float)
        self.circuit_window = pick(circuit_window,
                                   "MXNET_SERVING_CIRCUIT_WINDOW")
        self.circuit_threshold = pick(circuit_threshold,
                                      "MXNET_SERVING_CIRCUIT_THRESHOLD",
                                      typ=float)
        self.circuit_cooldown_ms = pick(
            circuit_cooldown_ms, "MXNET_SERVING_CIRCUIT_COOLDOWN_MS",
            typ=float)
        # replica layer
        self.replicas = pick(replicas, "MXNET_SERVING_REPLICAS")
        self.replica_heartbeat_ms = pick(
            replica_heartbeat_ms, "MXNET_SERVING_REPLICA_HEARTBEAT_MS",
            typ=float)
        self.replica_heartbeat_window_ms = pick(
            replica_heartbeat_window_ms,
            "MXNET_SERVING_REPLICA_HEARTBEAT_WINDOW_MS", typ=float)
        self.replica_failure_threshold = pick(
            replica_failure_threshold,
            "MXNET_SERVING_REPLICA_FAILURE_THRESHOLD")
        # tiered admission (docs/serving.md §11)
        self.tenant_tiers = tenant_tiers if tenant_tiers is not None \
            else get_env("MXNET_SERVING_TENANT_TIERS", typ=str)
        self.admission_shed_start = pick(
            admission_shed_start, "MXNET_SERVING_ADMISSION_SHED_START",
            typ=float)

        if self.max_batch_size < 1:
            raise MXNetError("ServingConfig: max_batch_size must be >= 1")
        if self.queue_depth < 1:
            raise MXNetError("ServingConfig: queue_depth must be >= 1")
        if not 1 <= self.shed_watermark <= self.queue_depth:
            raise MXNetError(
                f"ServingConfig: shed_watermark must be in "
                f"[1, queue_depth={self.queue_depth}], "
                f"got {self.shed_watermark}")
        if self.num_workers < 1:
            raise MXNetError("ServingConfig: num_workers must be >= 1")
        if self.max_latency_us < 0:
            raise MXNetError(
                "ServingConfig: max_latency_us must be >= 0")
        if self.retry_after_ms < 0:
            raise MXNetError(
                "ServingConfig: retry_after_ms must be >= 0")
        if self.decode_page_size < 1:
            raise MXNetError(
                "ServingConfig: decode_page_size must be >= 1")
        if self.decode_pool_pages < 2:
            raise MXNetError(
                "ServingConfig: decode_pool_pages must be >= 2 (page 0 "
                "is the reserved null page)")
        if self.decode_max_batch < 1:
            raise MXNetError(
                "ServingConfig: decode_max_batch must be >= 1")
        if self.decode_max_new_tokens < 1:
            raise MXNetError(
                "ServingConfig: decode_max_new_tokens must be >= 1")
        if self.prefix_cache_pages < 0:
            raise MXNetError(
                "ServingConfig: prefix_cache_pages must be >= 0 "
                "(0 = bounded by the KV pool alone)")
        if self.spec_k < 0:
            raise MXNetError(
                "ServingConfig: spec_k must be >= 0 (0 disables "
                "speculative decoding)")
        if self.deadline_default is not None \
                and self.deadline_default <= 0:
            raise MXNetError(
                "ServingConfig: deadline_default must be > 0 seconds "
                "(or None for no deadline)")
        if self.retry_max < 0:
            raise MXNetError("ServingConfig: retry_max must be >= 0")
        if self.retry_backoff_ms < 0:
            raise MXNetError(
                "ServingConfig: retry_backoff_ms must be >= 0")
        if self.circuit_window < 0:
            raise MXNetError(
                "ServingConfig: circuit_window must be >= 0 "
                "(0 disables the breaker)")
        if not 0.0 < self.circuit_threshold <= 1.0:
            raise MXNetError(
                "ServingConfig: circuit_threshold must be in (0, 1]")
        if self.circuit_cooldown_ms < 0:
            raise MXNetError(
                "ServingConfig: circuit_cooldown_ms must be >= 0")
        if self.replicas < 1:
            raise MXNetError("ServingConfig: replicas must be >= 1")
        if self.replica_heartbeat_ms <= 0:
            raise MXNetError(
                "ServingConfig: replica_heartbeat_ms must be > 0")
        if self.replica_heartbeat_window_ms <= self.replica_heartbeat_ms:
            raise MXNetError(
                f"ServingConfig: replica_heartbeat_window_ms "
                f"({self.replica_heartbeat_window_ms}) must exceed the "
                f"beat interval ({self.replica_heartbeat_ms}) — a "
                f"window under one beat marks every replica dead")
        if self.replica_failure_threshold < 0:
            raise MXNetError(
                "ServingConfig: replica_failure_threshold must be >= 0 "
                "(0 = windowed error rate only)")
        if not 0.0 <= self.admission_shed_start <= 1.0:
            raise MXNetError(
                "ServingConfig: admission_shed_start must be in [0, 1]")

    def __repr__(self):
        return (f"ServingConfig(max_batch_size={self.max_batch_size}, "
                f"max_latency_us={self.max_latency_us}, "
                f"queue_depth={self.queue_depth}, "
                f"shed_watermark={self.shed_watermark}, "
                f"num_workers={self.num_workers}, "
                f"retry_after_ms={self.retry_after_ms}, "
                f"decode_page_size={self.decode_page_size}, "
                f"decode_pool_pages={self.decode_pool_pages}, "
                f"decode_max_batch={self.decode_max_batch}, "
                f"decode_max_new_tokens={self.decode_max_new_tokens}, "
                f"prefix_cache={self.prefix_cache}, "
                f"prefix_cache_pages={self.prefix_cache_pages}, "
                f"spec_k={self.spec_k}, "
                f"spec_draft={self.spec_draft!r}, "
                f"deadline_default={self.deadline_default}, "
                f"retry_max={self.retry_max}, "
                f"retry_backoff_ms={self.retry_backoff_ms}, "
                f"circuit_window={self.circuit_window}, "
                f"circuit_threshold={self.circuit_threshold}, "
                f"circuit_cooldown_ms={self.circuit_cooldown_ms}, "
                f"replicas={self.replicas}, "
                f"replica_heartbeat_ms={self.replica_heartbeat_ms}, "
                f"replica_heartbeat_window_ms="
                f"{self.replica_heartbeat_window_ms}, "
                f"replica_failure_threshold="
                f"{self.replica_failure_threshold}, "
                f"tenant_tiers={self.tenant_tiers!r}, "
                f"admission_shed_start={self.admission_shed_start})")
