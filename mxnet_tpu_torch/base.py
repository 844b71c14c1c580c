"""Foundation utilities of the PyTorch port: errors and environment knobs.

The port's own copy of what serving needs from ``mxnet_tpu.base``
(``MXNetError``, ``declare_env``/``get_env``, ``entropy_rng``); the
port imports nothing of the JAX package.  Every ``MXNET_*`` knob keeps
its name, so one environment configures either package.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

__all__ = ["KernelError", "MXNetError", "declare_env", "entropy_rng",
           "env_truthy", "get_env"]


class MXNetError(RuntimeError):
    """Default error type raised by the framework (mirrors
    ``mxnet.base.MXNetError``)."""


class KernelError(MXNetError):
    """A hand-written CUDA kernel could not run a call on the card: it
    failed to build, to load or to launch, or refused its inputs.
    Nothing degrades around it — the decode engine fails the request
    rather than serve it down a path without the kernel."""


# ---------------------------------------------------------------------------
# Environment knob registry: every knob is declared once, with its
# default and its documentation.
# ---------------------------------------------------------------------------
_ENV_REGISTRY: Dict[str, tuple] = {}


def declare_env(name: str, default, doc: str = ""):
    _ENV_REGISTRY[name] = (default, doc)
    return name


def get_env(name: str, default=None, typ: Callable = None):
    """Read an environment knob (equivalent of ``dmlc::GetEnv``)."""
    if name in _ENV_REGISTRY and default is None:
        default = _ENV_REGISTRY[name][0]
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is None and default is not None:
        typ = type(default)
    if typ is bool:
        return raw not in ("0", "false", "False", "")
    return typ(raw) if typ else raw


def env_truthy(name: str, default: bool = False) -> bool:
    return get_env(name, default, bool)


def entropy_rng():
    """The ONE sanctioned source of deliberate nondeterminism: a
    ``random.Random`` seeded from OS entropy (retry/backoff jitter must
    differ across replicas, or their retries re-collide forever)."""
    import random as _random
    return _random.Random(os.urandom(16))


# Knobs the serving slice reads (names and defaults as in mxnet_tpu).
declare_env("MXNET_ENGINE_SANITIZE", "0",
            "1 = concurrency sanitizer: engine/serving locks record "
            "per-thread acquisition order and raise MXNetError on a "
            "cross-thread lock-order inversion (potential deadlock), "
            "in-place NDArray writes assert the array is engine-tracked, "
            "and framework threads (engine.make_thread) are registered "
            "with owner+creation site so engine.check_thread_leaks() "
            "raises on any thread surviving its owner's stop (asserted "
            "at test teardown). Debug/CI knob (sanity_lint re-runs the "
            "serving+engine tests under it); off by default, zero cost "
            "when off.")
declare_env("MXNET_RUNTIME_METRICS", "0",
            "1 = enable the process-wide runtime metrics registry "
            "(mxnet_tpu_torch.runtime_metrics): op dispatch counters/latency, "
            "engine/io/kvstore/trainer instrumentation, Prometheus + "
            "chrome-trace + TensorBoard exporters. Off by default; the "
            "disabled path is a single flag check per site.")
declare_env("MXNET_TRACE", "0",
            "1 = enable the request span tracer (mxnet_tpu_torch.tracing): "
            "every serving request gets a trace-id/span-id timeline "
            "(admission, queue wait, batch assembly, execute, prefill, "
            "decode steps, eviction) exportable as chrome-trace/JSONL, "
            "with histogram exemplars linking Prometheus quantiles to "
            "traces and the flight recorder dumping recent traces on "
            "overload incidents. Off by default; the disabled path is "
            "a single flag check per site and compiles zero additional "
            "XLA programs.")
declare_env("MXNET_TRACE_SAMPLE", 1.0,
            "Head-based trace sampling rate in [0, 1]: the keep/drop "
            "decision is made once per request at root-span start "
            "(deterministic stride, so 0.25 keeps exactly every 4th "
            "trace). 1.0 = trace everything (default).")
declare_env("MXNET_TRACE_RING", 64,
            "Completed traces retained by the flight-recorder ring "
            "(mxnet_tpu_torch.tracing) — always the most recent N; older "
            "traces are evicted in completion order.")
declare_env("MXNET_SERVING_QUEUE_DEPTH", 128,
            "Serving: bound on waiting requests per decode engine; "
            "submission past it sheds with "
            "ServerOverloadedError(retry_after_ms).")
declare_env("MXNET_SERVING_RETRY_AFTER_MS", 50,
            "Serving: retry-after hint (milliseconds) attached to "
            "ServerOverloadedError when a request is shed.")
declare_env("MXNET_SERVING_DECODE_PAGE_SIZE", 16,
            "Decode engine: tokens per KV-cache page "
            "(mxnet_tpu_torch.serving.kv_cache). Smaller pages waste less "
            "device memory on short sequences but deepen the "
            "per-sequence block table; the paged-attention kernels "
            "walk it one page at a time.")
declare_env("MXNET_SERVING_DECODE_POOL_PAGES", 64,
            "Decode engine: TOTAL pages preallocated in the device KV "
            "pool, including the reserved null page 0 (usable pages = "
            "pool - 1). Pool bytes = 2 * layers * pages * page_size * "
            "heads * head_dim * dtype_size.")
declare_env("MXNET_SERVING_DECODE_MAX_BATCH", 4,
            "Decode engine: sequence slots in the fixed-shape decode "
            "step (token-level continuous batching admits/evicts into "
            "these slots every step); every decode step runs at this "
            "batch size regardless of traffic mix.")
declare_env("MXNET_SERVING_DECODE_MAX_NEW_TOKENS", 32,
            "Decode engine: default cap on generated tokens per "
            "request (generate(max_new_tokens=...) overrides, bounded "
            "by the model's max_context).")
declare_env("MXNET_SERVING_PREFIX_CACHE", "0",
            "Decode engine: enable copy-on-write prefix caching "
            "(docs/serving.md §9) — full prompt pages are "
            "content-addressed in a radix tree, a request whose prefix "
            "is cached aliases the shared (refcounted) KV pages and "
            "skips that prefill; the one page it appends into is "
            "copy-on-write duplicated.  Lookup failures degrade to a "
            "plain prefill.")
declare_env("MXNET_SERVING_PREFIX_CACHE_PAGES", 0,
            "Decode engine: cap on KV pages the prefix cache may hold "
            "(refcount-aware LRU evicts beyond it; cache-only pages "
            "are also evicted on demand when admission needs the free "
            "list).  0 (default) = bounded by the pool alone.")
declare_env("MXNET_SERVING_SPEC_K", 0,
            "Decode engine: speculative-decoding proposal depth — the "
            "draft model proposes up to k tokens per sequence per "
            "round and the target verifies all k+1 positions in ONE "
            "model call (greedy acceptance is exact, so outputs are "
            "byte-identical with speculation on or off).  0 (default) "
            "disables; requires a draft model (DecodeEngine(draft=...)).")
declare_env("MXNET_SERVING_RETRY_MAX", 2,
            "Serving: max re-executions of a TRANSIENT failure "
            "(exc.transient truthy, e.g. an injected execute fault) "
            "per decode model call, with jittered "
            "exponential backoff.  0 disables retries.")
declare_env("MXNET_SERVING_RETRY_BACKOFF_MS", 10,
            "Serving: base of the jittered exponential retry backoff "
            "(sleep ~ backoff * 2^attempt * U[0.5,1.0) milliseconds "
            "between transient-failure retries).")
declare_env("MXNET_FAULTS", None,
            "Deterministic fault-injection plan for chaos testing "
            "(mxnet_tpu_torch.faults): 'site=mode[,k=v...][;...]' with mode "
            "in fail|delay|corrupt|stall and keys p/after/times/ms/"
            "seed, e.g. 'serving.execute=fail,p=0.05,seed=7'.  Sites "
            "thread through deploy, compile_cache, the serving "
            "batcher, the decode engine, the KV page allocator, and "
            "the replica layer (replica.<rid>.{execute,heartbeat,"
            "decode.*} — kill/stall one replica by id, or every "
            "replica via the replica.* glob).  Training-plane sites: "
            "train.step, train.data.next, kvstore.push, kvstore.pull, "
            "kvstore.pushpull (the fused XLA collective), "
            "checkpoint.save (corrupt = bit-flip a saved payload), "
            "checkpoint.restore.  Unset (default) = "
            "injection off at zero cost.")
