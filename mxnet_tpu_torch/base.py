"""Foundation utilities of the PyTorch port: errors and environment knobs.

The port's own copy of ``mxnet_tpu.base``: the errors, the generic
:class:`Registry`, the type tuples, ``declare_env``/``get_env``, the
deterministic-surface declarations and ``entropy_rng``; the port
imports nothing of the JAX package.  Every ``MXNET_*`` knob keeps
its name, so one environment configures either package.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

__all__ = ["KernelError", "MXNetError", "NotImplementedForSymbol",
           "Registry", "declare_deterministic", "declare_env",
           "entropy_rng", "env_truthy", "get_env", "list_deterministic",
           "string_types", "numeric_types", "integer_types"]

string_types = (str,)
numeric_types = (float, int)
integer_types = (int,)


class MXNetError(RuntimeError):
    """Default error type raised by the framework (mirrors
    ``mxnet.base.MXNetError``)."""


class KernelError(MXNetError):
    """A hand-written CUDA kernel could not run a call on the card: it
    failed to build, to load or to launch, or refused its inputs.
    Nothing degrades around it — the decode engine fails the request
    rather than serve it down a path without the kernel."""


class NotImplementedForSymbol(MXNetError):
    """Raised when an NDArray-only operation is attempted on a Symbol."""

    def __init__(self, function, alias=None, *args):
        super().__init__()
        self.function = function.__name__ if callable(function) \
            else str(function)
        self.alias = alias
        self.args_ = [str(type(a)) for a in args]

    def __str__(self):
        msg = f"Function {self.function}"
        if self.alias:
            msg += f" (alias {self.alias})"
        if self.args_:
            msg += " with arguments (" + ",".join(self.args_) + ")"
        msg += " is not supported for Symbol and only available in NDArray."
        return msg


class Registry:
    """Generic name -> object registry (reference: ``dmlc::Registry``)."""

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}
        self._lock = threading.Lock()
        Registry._registries[name] = self

    @classmethod
    def get(cls, name: str) -> "Registry":
        if name not in cls._registries:
            Registry(name)
        return cls._registries[name]

    def register(self, name: str, obj: Any = None, override: bool = False):
        """Register ``obj`` under ``name``; usable as a decorator."""
        if obj is None:
            def _decorator(fn):
                self.register(name, fn, override=override)
                return fn
            return _decorator
        with self._lock:
            if name in self._entries and not override:
                raise MXNetError(
                    f"'{name}' already registered in registry '{self.name}'")
            self._entries[name] = obj
        return obj

    def find(self, name: str) -> Optional[Any]:
        return self._entries.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> Any:
        if name not in self._entries:
            raise MXNetError(
                f"'{name}' is not registered in registry '{self.name}'. "
                f"Known: {sorted(self._entries)[:20]}...")
        return self._entries[name]

    def list_names(self) -> List[str]:
        return sorted(self._entries)

    def items(self):
        return self._entries.items()


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


_DETERMINISTIC_REGISTRY: Dict[str, str] = {}


def declare_deterministic(name: str, note: str = ""):
    """Declare ``name`` (a fully-qualified function or class path) a
    deterministic surface: equal inputs must give identical outputs."""
    _DETERMINISTIC_REGISTRY[name] = note
    return name


def list_deterministic() -> Dict[str, str]:
    """{declared surface: contract note}."""
    return dict(_DETERMINISTIC_REGISTRY)


def entropy_rng():
    """The ONE sanctioned source of deliberate nondeterminism: a
    ``random.Random`` seeded from OS entropy (retry/backoff jitter must
    differ across replicas, or their retries re-collide forever)."""
    import random as _random
    return _random.Random(os.urandom(16))


# Knobs the serving and training slices read (names and defaults as in
# mxnet_tpu).
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
declare_env("MXNET_RUNTIME_METRICS_GRAD_NORM", "0",
            "1 = also publish the global L2 gradient norm in the "
            "trainer.grad_norm gauge after each Trainer.step, read from "
            "the .grad buffers after the step's graphs ran (one host "
            "sync a step).")
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
declare_env("MXNET_PEAK_TFLOPS", 0.0,
            "Per-card peak TFLOP/s used as the train.mfu denominator "
            "(perf_account.detect_peak_tflops).  0 (default) = "
            "detect from the card's name (H100/H200: 989, the dense "
            "bf16 data-sheet peak; any other card or no card: unknown, "
            "MFU reports 0); set explicitly for hardware the table "
            "does not know.")
declare_env("MXNET_TRACE_SAMPLE", 1.0,
            "Head-based trace sampling rate in [0, 1]: the keep/drop "
            "decision is made once per request at root-span start "
            "(deterministic stride, so 0.25 keeps exactly every 4th "
            "trace). 1.0 = trace everything (default).")
declare_env("MXNET_TRACE_RING", 64,
            "Completed traces retained by the flight-recorder ring "
            "(mxnet_tpu_torch.tracing) — always the most recent N; older "
            "traces are evicted in completion order.")
declare_env("MXNET_SERVING_MAX_BATCH", 8,
            "Serving: max rows coalesced into one dispatched batch "
            "(mxnet_tpu_torch.serving.DynamicBatcher); shape buckets "
            "are powers of two up to this cap, so at most "
            "ceil(log2(max_batch))+1 programs (CUDA graphs) are built "
            "per model signature.")
declare_env("MXNET_SERVING_MAX_LATENCY_US", 2000,
            "Serving: how long the batcher holds the FIRST request of a "
            "forming batch waiting for more work before dispatching a "
            "partial batch (microseconds; the latency half of the "
            "batching policy).")
declare_env("MXNET_SERVING_QUEUE_DEPTH", 128,
            "Serving: bound on total outstanding work per ModelServer "
            "(queued + dispatched-but-unfinished requests) and on "
            "waiting requests per decode engine; admission sheds at it "
            "with ServerOverloadedError(retry_after_ms), even below the "
            "queue-only shed watermark.")
declare_env("MXNET_SERVING_SHED_WATERMARK", None,
            "Serving: queue depth at/above which new requests are shed "
            "with ServerOverloadedError(retry_after_ms) instead of "
            "queued (load-shedding watermark; default: the full queue "
            "capacity MXNET_SERVING_QUEUE_DEPTH).")
declare_env("MXNET_SERVING_WORKERS", 1,
            "Serving: dispatch worker threads per ModelServer (each "
            "forms and executes whole batches; >1 overlaps host "
            "pre/post-processing with device execution).")
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
declare_env("MXNET_SERVING_SPEC_DRAFT", None,
            "Decode engine: repository model name whose decode model "
            "serves as the DEFAULT speculative-decoding draft for "
            "decoder entries registered without an explicit "
            "add_decoder(draft=...).  The named entry must be "
            "registered before the first generate() call resolves it.")
declare_env("MXNET_SERVING_DEADLINE_DEFAULT", None,
            "Serving: default end-to-end deadline (seconds, float) for "
            "predict()/generate() calls that pass no timeout.  The "
            "timeout is an absolute deadline carried through admission "
            "-> queue -> batch assembly -> execute: expired requests "
            "are cancelled BEFORE consuming a batch slot and fail with "
            "DeadlineExceededError.  Unset (default) = no deadline.")
declare_env("MXNET_SERVING_RETRY_MAX", 2,
            "Serving: max re-executions of a TRANSIENT failure "
            "(exc.transient truthy, e.g. an injected execute fault) "
            "per coalesced batch / decode model call, with jittered "
            "exponential backoff.  0 disables retries.")
declare_env("MXNET_SERVING_RETRY_BACKOFF_MS", 10,
            "Serving: base of the jittered exponential retry backoff "
            "(sleep ~ backoff * 2^attempt * U[0.5,1.0) milliseconds "
            "between transient-failure retries).")
declare_env("MXNET_SERVING_CIRCUIT_WINDOW", 20,
            "Serving circuit breaker: sliding window of the last N "
            "execute outcomes per model version; the breaker can only "
            "trip once the window is full (doubling as the min-samples "
            "guard).  0 disables the breaker.")
declare_env("MXNET_SERVING_CIRCUIT_THRESHOLD", 0.5,
            "Serving circuit breaker: error rate over the full sliding "
            "window at/above which the circuit OPENs (admissions shed "
            "instantly with CircuitOpenError + retry-after until the "
            "cooldown's half-open probe).")
declare_env("MXNET_SERVING_CIRCUIT_COOLDOWN_MS", 1000,
            "Serving circuit breaker: how long an OPEN circuit sheds "
            "before admitting ONE half-open probe request (probe "
            "success re-closes, failure re-opens).")
declare_env("MXNET_SERVING_REPLICAS", 1,
            "Serving: number of replicas per model version "
            "(mxnet_tpu_torch.serving.replica).  With N > 1 the server "
            "builds a ReplicaSet — N replicas, each with its own bucket "
            "programs (CUDA graphs, streams and pools) or decode engine "
            "and KV pool over the version's one set of weights — and "
            "routes least-loaded among HEALTHY replicas; a failed "
            "replica's requests fail over to siblings under their "
            "original deadlines.  On one card every replica shares it.  "
            "1 (default) = the single-replica path, unchanged.")
declare_env("MXNET_SERVING_REPLICA_HEARTBEAT_MS", 50,
            "Serving replicas: heartbeat interval per replica worker "
            "(milliseconds).  Each replica's heartbeat thread beats, "
            "then sweeps the whole set for stale siblings, so a "
            "stalled replica is detected by its peers even with zero "
            "traffic.")
declare_env("MXNET_SERVING_REPLICA_HEARTBEAT_WINDOW_MS", 500,
            "Serving replicas: a replica whose last heartbeat is older "
            "than this window is marked UNHEALTHY (unroutable) until "
            "beats resume AND it re-passes prewarm (the rolling-"
            "recovery gate: a rejoining replica never serves a "
            "program it has not built and run).")
declare_env("MXNET_SERVING_REPLICA_FAILURE_THRESHOLD", 3,
            "Serving replicas: consecutive typed execute failures that "
            "trip one replica's circuit breaker (UNHEALTHY, sheds to "
            "siblings) without waiting for the sliding error-rate "
            "window to fill — the dead-replica fast path.  After "
            "MXNET_SERVING_CIRCUIT_COOLDOWN_MS one probe request may "
            "re-close it.  0 = windowed error rate only.")
declare_env("MXNET_SERVING_TENANT_TIERS", None,
            "Tiered admission (mxnet_tpu_torch.serving.admission, "
            "docs/serving.md §11): 'name=priority[/quota_rps[/burst]]' "
            "comma-separated, e.g. 'gold=100,silver=10/20,free=1/5'. "
            "Higher priority survives overload longer (low tiers "
            "priority-shed first); quota_rps meters each tenant "
            "through a token bucket of capacity burst.  Unset "
            "(default) = admission gate off (every request rides the "
            "watermark shed alone).")
declare_env("MXNET_SERVING_ADMISSION_SHED_START", 0.5,
            "Overload pressure (0..1 — the serving queue fraction, "
            "max'd with the autoscaler's published SLO pressure) at "
            "which the LOWEST tenant tier starts shedding; tiers "
            "above it shed at evenly spaced higher thresholds and the "
            "top tier only at full pressure.")
declare_env("MXNET_SERVING_AUTOSCALE_MIN", 1,
            "Autoscaler floor on replicas per model "
            "(mxnet_tpu_torch.serving.autoscaler, docs/serving.md §11); "
            "scale-down never drains below it.")
declare_env("MXNET_SERVING_AUTOSCALE_MAX", 4,
            "Autoscaler ceiling on replicas per model (the "
            "max-replica budget) — a sustained breach at the ceiling "
            "is counted as a 'blocked' decision, not actuated.")
declare_env("MXNET_SERVING_AUTOSCALE_INTERVAL_MS", 200,
            "Autoscaler control period: one sense -> decide -> "
            "actuate tick per interval (milliseconds).")
declare_env("MXNET_SERVING_AUTOSCALE_BREACH_TICKS", 3,
            "Scale-up hysteresis: consecutive SLO-breach ticks before "
            "adding a replica, MINUS the ticks the measured prewarm "
            "time will consume (prewarm-aware lead — capacity must "
            "start building before the window ends; floor 1).")
declare_env("MXNET_SERVING_AUTOSCALE_IDLE_TICKS", 10,
            "Scale-down hysteresis: consecutive idle ticks (queue "
            "under the low band AND latencies under the scale-down "
            "margin of their SLOs) before draining a replica.")
declare_env("MXNET_SERVING_AUTOSCALE_COOLDOWN_UP_MS", 1000,
            "Refractory period after a scale-up (or a failed "
            "actuation) before the next scale-up — one burst must not "
            "staircase the fleet to the ceiling.")
declare_env("MXNET_SERVING_AUTOSCALE_COOLDOWN_DOWN_MS", 5000,
            "Refractory period after ANY replica-count change before "
            "a scale-down — capacity just added (or a just-survived "
            "burst) must prove itself idle first.")
declare_env("MXNET_SERVING_AUTOSCALE_PREWARM_LEAD_MS", 0,
            "Initial estimate of one add_replica prewarm "
            "(milliseconds) for the prewarm-aware scale-up lead; "
            "refined at runtime by an EWMA of measured prewarms.  "
            "0 (default) = no lead until the first measured add.")
declare_env("MXNET_SERVING_AUTOSCALE_SLO_TTFT_P99_MS", None,
            "Declared SLO target: windowed p99 time-to-first-token "
            "(serving.decode.ttft.seconds) above this breaches and "
            "counts toward scale-up.  Unset (default) = TTFT not "
            "targeted.")
declare_env("MXNET_SERVING_AUTOSCALE_SLO_LATENCY_P99_MS", None,
            "Declared SLO target: windowed p99 end-to-end predict "
            "latency (serving.request.seconds) above this breaches "
            "and counts toward scale-up.  Unset (default) = latency "
            "not targeted.")
declare_env("MXNET_SERVING_AUTOSCALE_QUEUE_HIGH", None,
            "Declared SLO target: serving.queue.depth at/above this "
            "breaches (saturation shows in the queue before the "
            "latency histograms move); the scale-down band defaults "
            "to a quarter of it.  Unset (default) = queue not "
            "targeted.")
declare_env("MXNET_SERVING_TRACE_SEED", 0,
            "Workload-trace generator seed "
            "(mxnet_tpu_torch.serving.traffic.TraceConfig): one RandomState "
            "drives every draw, so equal configs yield byte-identical "
            "JSONL traces.")
declare_env("MXNET_SERVING_TRACE_RATE", 20.0,
            "Workload-trace base arrival rate (requests/s) before the "
            "diurnal ramp and burst multipliers.")
declare_env("MXNET_SERVING_TRACE_SPEED", 1.0,
            "Trace-replay time compression "
            "(serving.traffic.replay_trace): 2.0 plays an 8s trace in "
            "4s wall time; the recorded timeline itself is unchanged.")
declare_env("MXNET_CACHED_OP_CACHE_SIZE", 16,
            "Max per-signature programs kept per CachedOp (one CUDA "
            "graph set each on the card; LRU-evicted beyond, with a "
            "churn warning); override per block via "
            "hybridize(cache_size=...).")
declare_env("MXNET_FUSED_HYBRID_STEP", "1",
            "Defer a backward whose heads are the outputs of one "
            "hybridized replay, so that Trainer.step runs that backward "
            "and the optimizer update as one CUDA graph "
            "(record/backward/step at fused-step cost); 0 = the backward "
            "runs when called.")
declare_env("MXNET_DEFERRED_HYBRID_FWD", "1",
            "From the second recorded call of a hybridized block's "
            "signature on, return lazy outputs and run nothing: with the "
            "backward deferred too (MXNET_FUSED_HYBRID_STEP), "
            "Trainer.step runs forward, backward and update as one CUDA "
            "graph; any earlier read of an output runs the forward "
            "first.  0 = every recorded call runs when it is made.  "
            "MXNET_FUSED_STEP_SAVE_POLICY gets no counterpart: torch's "
            "autograd saves what it saves.")
declare_env("MXNET_COMPILE_CACHE_DIR", None,
            "Persistent compile-cache directory "
            "(mxnet_tpu_torch.compile_cache): the port keeps its nvcc-"
            "built kernel libraries there, content-addressed on their "
            "source digest, device topology and torch/CUDA versions, so "
            "a fresh checkout or a new process copies them instead of "
            "running nvcc.  Unset (default) = disabled.")
declare_env("MXNET_COMPILE_CACHE_MAX_BYTES", 1073741824,
            "Size bound on the compile-cache directory; least-recently-"
            "used entries are evicted beyond it (hits refresh recency). "
            "0 = unbounded.")
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
declare_env("MXNET_TRAIN_STEP_TIMEOUT_MS", 0,
            "Deadline on one ShardedTrainer.step(): the step (staging, "
            "replay or eager launches, and device completion) runs on a "
            "watchdog thread and a wedged step raises "
            "TrainStepTimeoutError instead of hanging the train loop. "
            "0 (default) = no deadline, direct in-thread dispatch.")
declare_env("MXNET_TRAIN_SLOW_STEP_FACTOR", 0.0,
            "Straggler detection: a step slower than this multiple of "
            "the rolling median step time increments "
            "train.slow_steps and dumps a flight-recorder incident. "
            "0 (default) = off.")
declare_env("MXNET_TRAIN_MAX_RESTARTS", 5,
            "TrainingSupervisor crash-loop breaker: more than this "
            "many CONSECUTIVE restore+restart cycles without a "
            "completed step raises CrashLoopError instead of "
            "retrying forever (progress resets the run).")
declare_env("MXNET_TRAIN_RESTART_BACKOFF_MS", 100,
            "Base of the TrainingSupervisor's jittered exponential "
            "restart backoff (doubles per consecutive failure, "
            "jitter U[0.5, 1.0)).")
declare_env("MXNET_TRAIN_RESTART_BACKOFF_MAX_MS", 5000,
            "Cap on one TrainingSupervisor restart backoff sleep.")
declare_env("MXNET_KVSTORE_GRAD_COMPRESSION", None,
            "Process-wide default gradient compression: a "
            "CompressionSpec string — 'int8' or 'fp8', optionally with "
            "options ('int8:block=64,stochastic=1,error_feedback=0'); "
            "read by quantize.CompressionSpec.from_env().  Unset "
            "(default) = uncompressed.")
declare_env("MXNET_SERVING_QUANT_REQUIRE_DIGEST", "1",
            "Serving admission of quantized artifacts "
            "(ModelRepository.load_artifact): 1 (default) rejects a "
            "manifest v4 quantization block that ships without its "
            "scale digest — undetectable scale tampering/corruption — "
            "with a clear MXNetError; 0 admits unprotected scales "
            "(dev/test only).  A PRESENT digest is always verified "
            "regardless of this knob.")
declare_env("MXNET_SERVING_QUANT_MAX_REL_ERR", None,
            "Serving admission bound on a quantized artifact's "
            "recorded calibration error: reject at "
            "ModelRepository.load_artifact when the manifest's "
            "quantization.calibration.max_rel_err exceeds this float "
            "(quality gate on what a replica will serve).  Unset "
            "(default) = no bound.")
