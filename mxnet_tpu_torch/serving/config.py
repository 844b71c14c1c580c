"""Serving policy knobs of the decode engine (docs/serving.md).

The PyTorch port's copy of the decode half of
``mxnet_tpu.serving.config``: ``ServingConfig`` with the fields
:class:`~mxnet_tpu_torch.serving.DecodeEngine` reads, under the same
``MXNET_SERVING_*`` names.  The predict-path, replica, admission and
circuit-breaker knobs come with the ``ModelServer`` slice.

Defaults come from the ``MXNET_SERVING_*`` environment variables
(declared in ``base.py``, documented in ``docs/env_vars.md``);
constructor arguments override per engine.
"""
from __future__ import annotations

from ..base import MXNetError, get_env

__all__ = ["ServingConfig"]


class ServingConfig:
    """Decode-engine policy.

    - ``queue_depth``: bound on WAITING requests — submission past it
      sheds with ``ServerOverloadedError(retry_after_ms)``.

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
    tokens per sequence, the target verifies them in one call.

    Resilience knobs (docs/serving.md §8): ``retry_max``
    transient-failure re-executions with ``retry_backoff_ms`` jittered
    exponential backoff.
    """

    def __init__(self, queue_depth=None, retry_after_ms=None,
                 decode_page_size=None, decode_pool_pages=None,
                 decode_max_batch=None, decode_max_new_tokens=None,
                 retry_max=None, retry_backoff_ms=None, prefix_cache=None,
                 prefix_cache_pages=None, spec_k=None):
        def pick(value, env, typ=int):
            if value is None:
                value = get_env(env, typ=typ)
            return None if value is None else typ(value)

        self.queue_depth = pick(queue_depth, "MXNET_SERVING_QUEUE_DEPTH")
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
        # resilience policy (docs/serving.md §8)
        self.retry_max = pick(retry_max, "MXNET_SERVING_RETRY_MAX")
        self.retry_backoff_ms = pick(retry_backoff_ms,
                                     "MXNET_SERVING_RETRY_BACKOFF_MS",
                                     typ=float)

        if self.queue_depth < 1:
            raise MXNetError("ServingConfig: queue_depth must be >= 1")
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
        if self.retry_max < 0:
            raise MXNetError("ServingConfig: retry_max must be >= 0")
        if self.retry_backoff_ms < 0:
            raise MXNetError(
                "ServingConfig: retry_backoff_ms must be >= 0")

    def __repr__(self):
        return (f"ServingConfig(queue_depth={self.queue_depth}, "
                f"retry_after_ms={self.retry_after_ms}, "
                f"decode_page_size={self.decode_page_size}, "
                f"decode_pool_pages={self.decode_pool_pages}, "
                f"decode_max_batch={self.decode_max_batch}, "
                f"decode_max_new_tokens={self.decode_max_new_tokens}, "
                f"prefix_cache={self.prefix_cache}, "
                f"prefix_cache_pages={self.prefix_cache_pages}, "
                f"spec_k={self.spec_k}, "
                f"retry_max={self.retry_max}, "
                f"retry_backoff_ms={self.retry_backoff_ms})")
