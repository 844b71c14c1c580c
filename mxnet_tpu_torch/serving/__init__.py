"""Inference serving of the PyTorch port (docs/serving.md).

The port of ``mxnet_tpu.serving``, module for module:

- :class:`ModelRepository` — versioned ``nn.Module`` blocks (weights
  snapshotted at registration), decoders and functions, atomic
  hot-swap;
- :class:`DynamicBatcher` — shape-bucketed batch coalescing with a
  per-bucket program cache: an ``add_block`` bucket is one CUDA graph
  on the card (O(log N) programs for N request shapes);
- :class:`ModelServer` — bounded queues, worker pool, load shedding
  (:class:`ServerOverloadedError` + retry-after), graceful drain,
  ``prewarm()`` (build every bucket BEFORE a hot-swap admits traffic),
  and ``generate()`` routed to the model's :class:`DecodeEngine`;
- :class:`DecodeEngine` — autoregressive generation with token-level
  continuous batching over a paged KV cache
  (:mod:`~mxnet_tpu_torch.serving.kv_cache`), prefix caching and
  speculative decoding; :class:`PagedLMAdapter` runs the LM's paged
  forwards as CUDA graphs over the hand-written decode and verify
  attention kernels;
- :class:`ReplicaSet` — multi-replica serving: N replicas of one model
  version over its one set of weights, each with its own bucket graphs
  or decode engine and KV pool; heartbeat + consecutive-failure health
  checks, least-loaded routing among HEALTHY replicas, failover under
  the request's original deadline, and prewarm-gated rolling
  add/remove/rejoin — active whenever ``ServingConfig(replicas=N > 1)``
  (``MXNET_SERVING_REPLICAS``).  On one card every replica shares it,
  and each captures its own graphs (a CUDA graph does not persist);
- the traffic plane (docs/serving.md §11): seed-deterministic
  multi-tenant workload traces with bit-exact JSONL record/replay,
  byte-identical to the JAX package's
  (:mod:`~mxnet_tpu_torch.serving.traffic` — heavy-tailed bursty
  arrivals, shared-prefix clusters, closed-loop retry-after-honoring
  clients), SLO-driven autoscaling (:class:`Autoscaler` — a control
  loop over the runtime-metrics signals driving ``ReplicaSet``
  add/remove_replica with hysteresis, cooldowns and prewarm-aware
  lead; on the card a scale-up captures the new replica's graphs), and
  tiered admission (:class:`AdmissionController` — per-tenant quota
  token buckets plus priority shedding, lowest tier first, active
  whenever ``ServingConfig(tenant_tiers=...)`` or
  ``MXNET_SERVING_TENANT_TIERS`` is set);
- the resilience layer (docs/serving.md §8): end-to-end deadlines,
  bounded jittered retries, failed-batch bisection, decode quarantine,
  and per-model-version circuit breakers (:class:`CircuitBreaker`,
  :class:`CircuitOpenError`, client-side :func:`honor_retry_after`).

>>> from mxnet_tpu_torch import serving
>>> repo = serving.ModelRepository()
>>> repo.add_block("bert", clf, tokens, types, valid_length)
>>> with serving.ModelServer(repo) as srv:
...     logits = srv.predict("bert", tokens, types, valid_length)
"""
from .admission import AdmissionController, TierPolicy, \
    parse_tier_spec
from .autoscaler import Autoscaler, AutoscalerConfig, \
    RuntimeMetricsSource, SLOTargets
from .batcher import DynamicBatcher, bucket_set, next_bucket, pad_batch, \
    unpad_outputs
from .config import ServingConfig
from .decode import DecodeEngine, GenerateRequest, PagedLMAdapter, \
    as_decode_model
from .kv_cache import DeviceKVPool, PageAllocator, PageGeometry, PrefixCache
from .replica import Replica, ReplicaSet
from .repository import ModelEntry, ModelRepository
from .resilience import (CircuitBreaker, CircuitOpenError, Deadline,
                         DeadlineExceededError, ServerOverloadedError,
                         honor_retry_after)
from .server import ModelServer
from .traffic import Trace, TraceConfig, TraceRequest, \
    generate_trace, replay_trace, summarize

__all__ = ["ModelRepository", "ModelEntry", "ModelServer",
           "DynamicBatcher", "ServingConfig", "ServerOverloadedError",
           "next_bucket", "bucket_set", "pad_batch", "unpad_outputs",
           "DecodeEngine", "GenerateRequest", "PagedLMAdapter",
           "as_decode_model", "PageGeometry", "PageAllocator",
           "PrefixCache", "DeviceKVPool",
           "Deadline", "DeadlineExceededError", "CircuitBreaker",
           "CircuitOpenError", "honor_retry_after",
           "Replica", "ReplicaSet",
           "AdmissionController", "TierPolicy", "parse_tier_spec",
           "Autoscaler", "AutoscalerConfig", "RuntimeMetricsSource",
           "SLOTargets",
           "Trace", "TraceConfig", "TraceRequest", "generate_trace",
           "replay_trace", "summarize"]
