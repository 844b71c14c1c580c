"""Traffic plane, part 1: seed-deterministic multi-tenant workload
traces (docs/serving.md §11).

The PyTorch port of ``mxnet_tpu.serving.traffic`` (numpy and the
stdlib only).  Every draw is taken from the same ``RandomState`` calls
in the same order as the reference takes them, so a trace generated
here is byte-identical to the JAX package's trace of the same
:class:`TraceConfig`, and either package loads the other's files.  It
is the single source of truth for synthetic traffic in the port:

- **arrival processes**: :func:`exponential_gap` is the Poisson
  inter-arrival primitive, plus heavy-tailed lognormal and Pareto
  processes for :func:`generate_trace`;
- **trace generation** (:func:`generate_trace`): mixed
  predict/generate requests over N tenants and M models with
  hot-tenant/hot-model Zipf skew, lognormal prompt lengths, Pareto
  output lengths, shared-prefix clusters (drives the §9 radix prefix
  cache realistically), a diurnal rate ramp, and a step burst window —
  all from ONE numpy seed, so a trace is reproducible from its header
  alone;
- **record/replay** (:class:`Trace`): a JSONL format that round-trips
  bit-exactly (``save -> load -> save`` is byte-identical), so a
  recorded incident workload is a shippable artifact;
- **closed-loop replay** (:func:`replay_trace`): a client pool that
  paces requests to the trace timeline and HONORS the server's
  retry-after hints with jitter (:func:`resilience.honor_retry_after`)
  — shed storms must not come back as one synchronized wave — and
  proves the zero-hung-requests contract (every request resolves to a
  typed terminal status); its client threads come from
  :func:`mxnet_tpu_torch.engine.make_thread`, so the leak checker sees
  them;
- **SLO scoring** (:func:`summarize`): attainment and goodput against
  declared latency/TTFT targets, per tier — the objective the
  :mod:`~mxnet_tpu_torch.serving.autoscaler` control loop is judged on.
"""
from __future__ import annotations

import json
import random
import threading
import time

import numpy as np

from ..base import MXNetError, get_env
from .. import engine as _engine
from .resilience import Deadline, DeadlineExceededError, \
    ServerOverloadedError, honor_retry_after

__all__ = ["TraceRequest", "TraceConfig", "Trace", "generate_trace",
           "exponential_gap", "predict_payload", "prompt_tokens",
           "replay_trace", "summarize"]

TRACE_VERSION = 1

#: canonical field order of one JSONL request row — fixed so a trace
#: file is byte-stable across writers
_REQUEST_FIELDS = ("t", "tenant", "tier", "model", "op", "rows",
                   "prompt_len", "max_new_tokens", "prefix_group",
                   "seed")


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------
def exponential_gap(rng, rate):
    """One Poisson inter-arrival gap (seconds) at ``rate`` requests/s
    from ``rng`` (a ``numpy.random.RandomState``).  The one Poisson
    primitive: :func:`generate_trace` draws through here, so the same
    seed yields the same schedule everywhere."""
    return float(rng.exponential(1.0 / rate))


def _lognormal_gap(rng, rate, sigma):
    """Heavy-tailed inter-arrival with mean ``1/rate``: lognormal with
    ``exp(mu + sigma^2/2) = 1/rate``."""
    mu = -np.log(rate) - 0.5 * sigma * sigma
    return float(rng.lognormal(mu, sigma))


def _pareto_gap(rng, rate, alpha):
    """Pareto (Lomax-shifted) inter-arrival with mean ``1/rate``:
    ``x_m * (1 + Pareto(alpha))`` has mean ``x_m * alpha/(alpha-1)``."""
    xm = (1.0 / rate) * (alpha - 1.0) / alpha
    return xm * (1.0 + float(rng.pareto(alpha)))


_PROCESSES = ("poisson", "lognormal", "pareto")


# ---------------------------------------------------------------------------
# trace records
# ---------------------------------------------------------------------------
class TraceRequest:
    """One replayable request: arrival offset ``t`` (seconds from trace
    start), tenant/tier identity, target model, ``op`` in
    ``predict|generate``, and the deterministic payload recipe —
    ``rows``+``seed`` rebuild a predict input, ``prompt_len``/
    ``max_new_tokens``/``prefix_group``/``seed`` rebuild a prompt
    (:func:`predict_payload`, :func:`prompt_tokens`)."""

    __slots__ = _REQUEST_FIELDS

    def __init__(self, t, tenant, tier, model, op, rows=0,
                 prompt_len=0, max_new_tokens=0, prefix_group=None,
                 seed=0):
        if op not in ("predict", "generate"):
            raise MXNetError(f"TraceRequest: op must be "
                             f"predict|generate, got {op!r}")
        self.t = float(t)
        self.tenant = str(tenant)
        self.tier = str(tier)
        self.model = str(model)
        self.op = op
        self.rows = int(rows)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.prefix_group = None if prefix_group is None \
            else int(prefix_group)
        self.seed = int(seed)

    def to_dict(self):
        return {k: getattr(self, k) for k in _REQUEST_FIELDS}

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: d[k] for k in _REQUEST_FIELDS})

    def __eq__(self, other):
        return isinstance(other, TraceRequest) \
            and self.to_dict() == other.to_dict()

    def __repr__(self):
        return (f"TraceRequest(t={self.t:.6f}, {self.tenant}/"
                f"{self.tier}, {self.model}.{self.op})")


def _canonical(obj):
    """Canonical JSON: sorted keys, no whitespace — the byte-stability
    half of the record/replay round-trip contract (floats go through
    repr, which round-trips doubles exactly)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class Trace:
    """An ordered request list plus the header that generated it.

    JSONL on disk: line 1 is the header (``kind=header``, format
    version, generator config), every following line one request
    (``kind=request``).  ``save -> load -> save`` is byte-identical,
    and the bytes are the JAX package's for the same requests, so a
    recorded workload is a stable artifact, diffable and shippable
    between the two packages."""

    def __init__(self, header, requests):
        self.header = dict(header)
        self.header.setdefault("kind", "header")
        self.header.setdefault("version", TRACE_VERSION)
        self.requests = list(requests)

    def __len__(self):
        return len(self.requests)

    def __eq__(self, other):
        return isinstance(other, Trace) \
            and self.header == other.header \
            and self.requests == other.requests

    @property
    def duration_s(self):
        return self.requests[-1].t if self.requests else 0.0

    def to_jsonl(self):
        lines = [_canonical(self.header)]
        for req in self.requests:
            row = req.to_dict()
            row["kind"] = "request"
            lines.append(_canonical(row))
        return "\n".join(lines) + "\n"

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            raise MXNetError(f"Trace.load({path!r}): empty file")
        header = json.loads(lines[0])
        if header.get("kind") != "header":
            raise MXNetError(
                f"Trace.load({path!r}): first line is not a trace "
                f"header (kind={header.get('kind')!r})")
        if header.get("version") != TRACE_VERSION:
            raise MXNetError(
                f"Trace.load({path!r}): format version "
                f"{header.get('version')!r}, this reader speaks "
                f"{TRACE_VERSION}")
        requests = []
        for ln in lines[1:]:
            row = json.loads(ln)
            if row.pop("kind", None) != "request":
                raise MXNetError(
                    f"Trace.load({path!r}): non-request row {ln!r}")
            requests.append(TraceRequest.from_dict(row))
        return cls(header, requests)


# ---------------------------------------------------------------------------
# trace generation
# ---------------------------------------------------------------------------
class TraceConfig:
    """Workload-shape knobs for :func:`generate_trace`.  Everything is
    derived from ``seed`` (``MXNET_SERVING_TRACE_SEED``) — two configs
    with equal fields yield byte-identical traces.

    - ``base_rate`` requests/s (``MXNET_SERVING_TRACE_RATE``) modulated
      by a diurnal sine ramp (``diurnal_amplitude``) and one step-burst
      window: rate multiplies by ``burst_x`` for ``burst_duration_s``
      starting at ``burst_at`` (fraction of ``duration_s``);
    - ``process`` in ``poisson|lognormal|pareto`` picks the
      inter-arrival law (the heavy-tailed laws keep mean ``1/rate`` but
      arrive in clumps — the shape shed/autoscale logic must survive);
    - ``tenants`` tenants named ``t0..`` with Zipf(``tenant_skew``)
      traffic shares, assigned round-robin over ``tiers``; ``models``
      weighted by Zipf(``model_skew``) (hot model first);
    - ``generate_fraction`` of requests are decode (``generate``) ops
      with lognormal prompt lengths (median ``prompt_len_median``,
      shape ``prompt_sigma``, cap ``prompt_max``) and Pareto output
      lengths (mean ``output_mean``, cap ``output_max``); the rest are
      ``predict`` ops with 1..``rows_max`` rows;
    - a ``prefix_share`` fraction of generate requests join one of
      ``prefix_clusters`` shared-prefix groups (first ``prefix_len``
      prompt tokens identical within a group — what exercises the radix
      cache).
    """

    def __init__(self, seed=None, duration_s=8.0, base_rate=None,
                 process="lognormal", tenants=4,
                 tiers=("gold", "silver", "free"), tenant_skew=1.2,
                 models=("m",), model_skew=1.5, generate_fraction=0.35,
                 burst_at=0.45, burst_x=1.0, burst_duration_s=1.0,
                 diurnal_amplitude=0.3, arrival_sigma=0.8,
                 arrival_alpha=2.5, prompt_len_median=8.0,
                 prompt_sigma=0.6, prompt_max=24, output_mean=6.0,
                 output_alpha=2.0, output_max=16, prefix_clusters=4,
                 prefix_share=0.5, prefix_len=6, rows_max=3):
        self.seed = int(get_env("MXNET_SERVING_TRACE_SEED", typ=int)
                        if seed is None else seed)
        self.duration_s = float(duration_s)
        self.base_rate = float(
            get_env("MXNET_SERVING_TRACE_RATE", typ=float)
            if base_rate is None else base_rate)
        self.process = str(process)
        self.tenants = int(tenants)
        self.tiers = tuple(str(t) for t in tiers)
        self.tenant_skew = float(tenant_skew)
        self.models = tuple(str(m) for m in models)
        self.model_skew = float(model_skew)
        self.generate_fraction = float(generate_fraction)
        self.burst_at = float(burst_at)
        self.burst_x = float(burst_x)
        self.burst_duration_s = float(burst_duration_s)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.arrival_sigma = float(arrival_sigma)
        self.arrival_alpha = float(arrival_alpha)
        self.prompt_len_median = float(prompt_len_median)
        self.prompt_sigma = float(prompt_sigma)
        self.prompt_max = int(prompt_max)
        self.output_mean = float(output_mean)
        self.output_alpha = float(output_alpha)
        self.output_max = int(output_max)
        self.prefix_clusters = int(prefix_clusters)
        self.prefix_share = float(prefix_share)
        self.prefix_len = int(prefix_len)
        self.rows_max = int(rows_max)

        if self.process not in _PROCESSES:
            raise MXNetError(
                f"TraceConfig: process must be one of {_PROCESSES}, "
                f"got {self.process!r}")
        if self.duration_s <= 0 or self.base_rate <= 0:
            raise MXNetError(
                "TraceConfig: duration_s and base_rate must be > 0")
        if self.tenants < 1 or not self.tiers or not self.models:
            raise MXNetError(
                "TraceConfig: need >= 1 tenant, tier, and model")
        if not 0.0 <= self.generate_fraction <= 1.0 \
                or not 0.0 <= self.prefix_share <= 1.0:
            raise MXNetError(
                "TraceConfig: generate_fraction and prefix_share must "
                "be in [0, 1]")
        if self.burst_x < 1.0:
            raise MXNetError(
                "TraceConfig: burst_x must be >= 1 (1 = no burst)")
        if not 0.0 <= self.burst_at <= 1.0:
            raise MXNetError(
                "TraceConfig: burst_at is a fraction of duration_s")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise MXNetError(
                "TraceConfig: diurnal_amplitude must be in [0, 1)")
        if self.arrival_alpha <= 1.0 or self.output_alpha <= 1.0:
            raise MXNetError(
                "TraceConfig: Pareto alphas must be > 1 (finite mean)")
        if self.rows_max < 1 or self.prompt_max < 1 \
                or self.output_max < 1 or self.prefix_len < 1:
            raise MXNetError(
                "TraceConfig: rows/prompt/output/prefix caps must "
                "be >= 1")
        if self.prefix_clusters < 1:
            raise MXNetError(
                "TraceConfig: prefix_clusters must be >= 1")

    def header(self):
        """The generator fields, ordered — embedded in every saved
        trace so a file regenerates from its own header."""
        out = {"kind": "header", "version": TRACE_VERSION}
        for k in ("seed", "duration_s", "base_rate", "process",
                  "tenants", "tiers", "tenant_skew", "models",
                  "model_skew", "generate_fraction", "burst_at",
                  "burst_x", "burst_duration_s", "diurnal_amplitude",
                  "arrival_sigma", "arrival_alpha", "prompt_len_median",
                  "prompt_sigma", "prompt_max", "output_mean",
                  "output_alpha", "output_max", "prefix_clusters",
                  "prefix_share", "prefix_len", "rows_max"):
            v = getattr(self, k)
            out[k] = list(v) if isinstance(v, tuple) else v
        return out


def _zipf_weights(n, skew):
    w = np.array([1.0 / (i + 1.0) ** skew for i in range(n)])
    return w / w.sum()


def generate_trace(config=None, **kwargs):
    """Generate a :class:`Trace` from a :class:`TraceConfig` (or its
    kwargs).  Deterministic: one ``RandomState(seed)`` drives every
    draw in arrival order, so equal configs are byte-identical."""
    cfg = config if config is not None else TraceConfig(**kwargs)
    rng = np.random.RandomState(cfg.seed)
    tenant_w = _zipf_weights(cfg.tenants, cfg.tenant_skew)
    model_w = _zipf_weights(len(cfg.models), cfg.model_skew)
    tiers = [cfg.tiers[i % len(cfg.tiers)] for i in range(cfg.tenants)]
    burst_t0 = cfg.burst_at * cfg.duration_s
    burst_t1 = burst_t0 + cfg.burst_duration_s

    requests = []
    t = 0.0
    while True:
        # rate modulation: diurnal sine ramp over the trace duration,
        # times the step burst inside its window
        rate = cfg.base_rate * (
            1.0 + cfg.diurnal_amplitude
            * float(np.sin(2.0 * np.pi * t / cfg.duration_s)))
        if cfg.burst_x > 1.0 and burst_t0 <= t < burst_t1:
            rate *= cfg.burst_x
        if cfg.process == "poisson":
            gap = exponential_gap(rng, rate)
        elif cfg.process == "lognormal":
            gap = _lognormal_gap(rng, rate, cfg.arrival_sigma)
        else:
            gap = _pareto_gap(rng, rate, cfg.arrival_alpha)
        t += gap
        if t >= cfg.duration_s:
            break
        ti = int(rng.choice(cfg.tenants, p=tenant_w))
        mi = int(rng.choice(len(cfg.models), p=model_w))
        op = "generate" \
            if float(rng.random_sample()) < cfg.generate_fraction \
            else "predict"
        rows = prompt_len = max_new = 0
        prefix_group = None
        if op == "predict":
            rows = 1 + int(rng.randint(cfg.rows_max))
        else:
            prompt_len = int(np.clip(int(round(float(rng.lognormal(
                np.log(cfg.prompt_len_median), cfg.prompt_sigma)))),
                1, cfg.prompt_max))
            mean_scale = cfg.output_mean \
                * (cfg.output_alpha - 1.0) / cfg.output_alpha
            max_new = int(np.clip(int(round(
                (1.0 + float(rng.pareto(cfg.output_alpha)))
                * mean_scale)), 1, cfg.output_max))
            if float(rng.random_sample()) < cfg.prefix_share:
                prefix_group = int(rng.randint(cfg.prefix_clusters))
        requests.append(TraceRequest(
            t=t, tenant=f"t{ti}", tier=tiers[ti],
            model=cfg.models[mi], op=op, rows=rows,
            prompt_len=prompt_len, max_new_tokens=max_new,
            prefix_group=prefix_group,
            seed=int(rng.randint(0, 2 ** 31 - 1))))
    return Trace(cfg.header(), requests)


# ---------------------------------------------------------------------------
# deterministic payloads
# ---------------------------------------------------------------------------
def predict_payload(req, features=2, dtype=np.float32):
    """Rebuild the predict input a trace row describes — the same
    ``(rows, features)`` array on every replay (keyed by the row's
    ``seed``), so replays are byte-comparable across runs."""
    rng = np.random.RandomState(req.seed)
    return rng.randn(req.rows, features).astype(dtype)


def prompt_tokens(req, vocab=16, prefix_len=None):
    """Rebuild the prompt a trace row describes.  Rows sharing a
    ``prefix_group`` share their first ``prefix_len`` tokens exactly
    (drawn from the group id, not the request seed) — the shared-prefix
    clusters that make the §9 radix cache earn its keep (on the card a
    cache hit runs the verify kernel over the cached pages) — while the
    suffix stays per-request unique."""
    if req.prompt_len < 1:
        raise MXNetError(f"prompt_tokens: {req!r} is not a generate "
                         f"row (prompt_len={req.prompt_len})")
    rng = np.random.RandomState(req.seed)
    tokens = rng.randint(1, vocab, size=req.prompt_len)
    if req.prefix_group is not None:
        if prefix_len is None:
            prefix_len = 6
        n_pre = min(int(prefix_len), req.prompt_len - 1)
        if n_pre > 0:
            pre_rng = np.random.RandomState(7919 + req.prefix_group)
            tokens[:n_pre] = pre_rng.randint(1, vocab, size=n_pre)
    return [int(x) for x in tokens]


# ---------------------------------------------------------------------------
# closed-loop replay
# ---------------------------------------------------------------------------
def replay_trace(trace, call, *, clients=8, speed=None, attempts=4,
                 timeout_s=30.0, jitter_seed=0, on_backoff=None):
    """Replay ``trace`` through ``call(req)`` with a closed-loop client
    pool.

    Each of ``clients`` workers owns an interleaved slice of the trace
    and paces it to the recorded timeline (compressed by ``speed``,
    default ``MXNET_SERVING_TRACE_SPEED``); within one client requests
    are serial, so a slow server pushes back on that client's schedule
    — closed-loop, not a fire-and-forget thread storm.  Every call runs
    under its own :class:`Deadline` and inside
    :func:`~mxnet_tpu_torch.serving.resilience.honor_retry_after` with a
    per-client seeded jitter rng: shed requests back off by the
    server's own retry-after hint, never as a synchronized wave.

    ``call(req)`` performs one server round trip and may return a dict
    of extra fields to record (e.g. ``{"ttft_s": ...}`` from an
    ``on_token`` timestamp).  Returns ``(records, wall_s)`` where every
    record carries a terminal ``status`` in
    ``ok|shed|deadline|error`` — a replay that returns PROVES zero hung
    requests (a worker that wedges past every request deadline raises
    instead of returning partial records)."""
    if speed is None:
        speed = get_env("MXNET_SERVING_TRACE_SPEED", typ=float)
    speed = float(speed)
    if speed <= 0:
        raise MXNetError("replay_trace: speed must be > 0")
    reqs = trace.requests
    records = [None] * len(reqs)
    clients = max(1, min(int(clients), max(1, len(reqs))))
    start_evt = threading.Event()
    epoch = []

    def worker(tid):
        rng = random.Random(100003 + jitter_seed * 1009 + tid)
        start_evt.wait(timeout_s)
        t0 = epoch[0]
        for i in range(tid, len(reqs), clients):
            req = reqs[i]
            lag = t0 + req.t / speed - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            deadline = Deadline.start(timeout_s)
            t_start = time.monotonic()
            status, err, info = "ok", None, None
            try:
                info = honor_retry_after(
                    lambda: call(req), attempts=attempts, rng=rng,
                    deadline=deadline, on_backoff=on_backoff)
            except ServerOverloadedError as e:
                status, err = "shed", e
            except DeadlineExceededError as e:
                status, err = "deadline", e
            except MXNetError as e:
                status, err = "error", e
            rec = {"index": i, "t": req.t, "tenant": req.tenant,
                   "tier": req.tier, "model": req.model, "op": req.op,
                   "status": status,
                   "error": type(err).__name__ if err else None,
                   "start_s": t_start - t0,
                   "latency_s": time.monotonic() - t_start}
            if isinstance(info, dict):
                rec.update(info)
            records[i] = rec

    pool = [_engine.make_thread(worker, name=f"mxnet-replay-{tid}",
                                owner="replay_trace", args=(tid,))
            for tid in range(clients)]
    for th in pool:
        th.start()
    epoch.append(time.monotonic())
    start_evt.set()
    wall0 = epoch[0]
    # one total budget: the trace timeline plus every request's own
    # deadline — past it a worker is wedged, which is itself a failure
    budget = trace.duration_s / speed + timeout_s * (attempts + 1) + 30
    join_by = wall0 + budget
    for th in pool:
        th.join(max(0.0, join_by - time.monotonic()))
    wall_s = time.monotonic() - wall0
    hung = [i for i, r in enumerate(records) if r is None]
    if hung:
        raise MXNetError(
            f"replay_trace: {len(hung)} request(s) never resolved "
            f"within {budget:.1f}s (first: {hung[:5]}) — the "
            f"zero-hung-requests contract is broken")
    return records, wall_s


def summarize(records, *, wall_s, latency_slo_s=None, ttft_slo_s=None):
    """Score a replay against declared SLO targets.

    A record counts toward **attainment** when it completed (``ok``)
    AND met every declared target that applies to it: ``latency_slo_s``
    end to end, plus ``ttft_slo_s`` for generate rows that measured a
    ``ttft_s``.  ``attainment`` divides by ALL requests — a shed or
    hung-then-typed request is an SLO miss, not a denominator dodge —
    and ``goodput_rps`` is SLO-meeting completions per wall second.
    Per-tier rollups expose the tiered-admission contract: under
    overload the free tier's shed count rises first."""
    n = len(records)
    by_status = {}
    by_tier = {}
    slo_ok = 0
    lat_ok = []
    ttfts = []
    for r in records:
        by_status[r["status"]] = by_status.get(r["status"], 0) + 1
        tier = by_tier.setdefault(
            r["tier"], {"requests": 0, "ok": 0, "shed": 0, "slo_ok": 0})
        tier["requests"] += 1
        if r["status"] == "shed":
            tier["shed"] += 1
        if r["status"] != "ok":
            continue
        tier["ok"] += 1
        lat_ok.append(r["latency_s"])
        met = latency_slo_s is None or r["latency_s"] <= latency_slo_s
        ttft = r.get("ttft_s")
        if ttft is not None:
            ttfts.append(ttft)
            if ttft_slo_s is not None and ttft > ttft_slo_s:
                met = False
        if met:
            slo_ok += 1
            tier["slo_ok"] += 1

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else float("nan")

    return {
        "requests": n,
        "ok": by_status.get("ok", 0),
        "shed": by_status.get("shed", 0),
        "deadline": by_status.get("deadline", 0),
        "error": by_status.get("error", 0),
        "slo_ok": slo_ok,
        "attainment": slo_ok / n if n else float("nan"),
        "goodput_rps": slo_ok / wall_s if wall_s > 0 else float("nan"),
        "latency_p50_s": pct(lat_ok, 50),
        "latency_p99_s": pct(lat_ok, 99),
        "ttft_p50_s": pct(ttfts, 50),
        "ttft_p99_s": pct(ttfts, 99),
        "wall_s": wall_s,
        "by_tier": by_tier,
    }
