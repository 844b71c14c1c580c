"""Deterministic seeded fault injection for the serving stack
(docs/serving.md §8).

The PyTorch port's own copy of ``mxnet_tpu.faults``: the fault-site
catalogue and the ``MXNET_FAULTS`` grammar are identical, so one
chaos spec drives either package.

The serving/decode layers are deep but optimistic: a failed device
execute, a corrupt cache blob, or a stuck step loop must surface as a
*typed, bounded* failure, and the only way to prove that is to make the
failures happen on demand — reproducibly, in CI, on numpy fakes.  This
module is that chaos switch: a :class:`FaultPlan` maps named injection
points (threaded through ``deploy``, ``compile_cache``, the batcher,
the decode engine, and the page allocator) to one of four fault modes,
with seeded-RNG probability and after-N-calls triggers, so a 5%%
execute-fault chaos run replays byte-identically from its spec string.

Site catalogue: every injection point is **declared** via
:func:`declare_fault_site` at the bottom of this module — the single
source of truth for the tables in docs/serving.md §8 and
docs/training_resilience.md §2 (rendered by ``tools/gen_fault_docs.py
--check`` in CI) and for the ``fault-site-soundness`` mxlint pass,
which statically validates every ``inject()``/``check()`` site literal
and every ``MXNET_FAULTS`` spec pattern in tests/benches/CI against it
(a typo'd site silently never fires — a chaos test that tests
nothing).  Dynamic scopes (one site name per replica id) are declared
as templates with ``<placeholder>`` segments:
``replica.<rid>.heartbeat`` covers ``replica.r0.heartbeat``.  fnmatch
globs in plan specs match across the whole catalogue (``decode.*``
matches the engine, ``train.*`` the training plane,
``replica.<rid>.*`` one replica); :func:`FaultPlan.parse` warns on a
rule whose pattern can match no declared site.

Spec grammar (``MXNET_FAULTS``, or :func:`install` / :func:`plan`)::

    plan  := rule (';' rule)*
    rule  := site '=' mode (',' key '=' value)*
    site  := dotted injection-point name; fnmatch globs allowed
             ('serving.*' matches every serving-layer site)
    mode  := fail | delay | corrupt | stall
    keys  := p=<float>      fire probability per call (default 1.0)
             after=<int>    skip the first N calls of the site (0)
             times=<int>    fire at most N times (default unlimited)
             ms=<float>     delay duration (delay: 10ms, stall: 1000ms)
             seed=<int>     RNG seed component for this rule (0)

    MXNET_FAULTS='serving.execute=fail,p=0.05,seed=7;compile_cache.load=corrupt,times=1'

Modes: **fail** raises :class:`InjectedFault` (marked ``transient`` so
the serving retry policy treats it as retryable); **delay** and
**stall** sleep (stall defaults 100x longer — the stuck-worker shape
that deadline propagation must bound); **corrupt** mutates the value
passing through the injection point (bytes get a flipped byte, float
arrays a NaN) so checksum/validation layers downstream must catch it.

Contracts:

- **zero-cost when off**: :func:`inject` / :func:`check` test one
  module global against None and return — no parsing, no locks, no
  allocation on the fault-free path (mirrors the ``runtime_metrics``
  ``_ENABLED`` discipline).
- **every fired fault is observable**: counted per (site, mode) on the
  plan, mirrored into ``serving.faults{site,mode}`` when runtime
  metrics are on, and recorded as a zero-length ``fault.<mode>`` span
  in the active trace so a chaos run's flight-recorder dumps show
  exactly which faults a request absorbed.
- **deterministic**: each rule owns a ``random.Random`` seeded from
  (seed, site, mode); one plan spec -> one reproducible decision
  sequence per rule, independent of other rules.
"""
from __future__ import annotations

import fnmatch
import logging
import re as _re
import threading
import time

from .base import MXNetError, get_env

__all__ = ["FaultRule", "FaultPlan", "InjectedFault", "FaultSite",
           "declare_fault_site", "declared_sites",
           "pattern_matches_declared", "install",
           "clear", "active", "plan", "inject", "check", "counters"]

_LOG = logging.getLogger("mxnet_tpu_torch")

_MODES = ("fail", "delay", "corrupt", "stall")
_DEFAULT_MS = {"delay": 10.0, "stall": 1000.0}


# ---------------------------------------------------------------------------
# declared-site registry (the single source of truth for injection points)
# ---------------------------------------------------------------------------
_SITE_SEGMENT = _re.compile(r"^(?:[a-z0-9_]+|<[a-z0-9_]+>)$")


class FaultSite:
    """One declared injection point.  ``name`` may carry
    ``<placeholder>`` segments for dynamic scopes
    (``replica.<rid>.heartbeat``); ``modes`` are the fault modes the
    site honors (``kv_cache.allocate`` is fail-only: exhaustion is a
    refusal, not an exception); ``plane``/``where``/``notes`` feed the
    generated doc tables (tools/gen_fault_docs.py)."""

    __slots__ = ("name", "modes", "plane", "where", "notes")

    def __init__(self, name, modes, plane, where, notes):
        self.name = name
        self.modes = tuple(modes)
        self.plane = plane
        self.where = where
        self.notes = notes

    def glob(self):
        """The site as an fnmatch glob: placeholders become ``*``."""
        return _re.sub(r"<[a-z0-9_]+>", "*", self.name)

    def __repr__(self):
        return f"FaultSite({self.name!r}, modes={self.modes})"


FAULT_SITES = {}


def declare_fault_site(name, modes=_MODES, *, plane="serving", where="",
                       notes=""):
    """Register one injection point (or ``<placeholder>`` template).
    Call sites (``inject``/``check``) and ``MXNET_FAULTS`` spec
    patterns are validated against this registry — statically by the
    ``fault-site-soundness`` mxlint pass, and at plan-parse time by the
    unmatched-pattern warning in :meth:`FaultPlan.parse`."""
    name = str(name)
    if not name or not all(_SITE_SEGMENT.match(seg)
                           for seg in name.split(".")):
        raise MXNetError(
            f"fault site {name!r}: expected dotted lowercase segments "
            f"(dynamic parts as <placeholder>), e.g. "
            f"'replica.<rid>.heartbeat'")
    bad = [m for m in modes if m not in _MODES]
    if bad:
        raise MXNetError(
            f"fault site {name!r}: unknown mode(s) {bad} "
            f"(expected subset of {'/'.join(_MODES)})")
    # mxlint: disable=lock-discipline (contract: sites are declared at
    # import time — the module-bottom catalogue and plugin import
    # bodies — before any chaos plan can run; at runtime the registry
    # is read-only)
    FAULT_SITES[name] = FaultSite(name, modes, plane, where, notes)
    return name


def declared_sites():
    """{name: FaultSite} — the registry snapshot (doc generation,
    diagnose, tests)."""
    return dict(FAULT_SITES)


def _globs_intersect(a, b):
    """Whether two fnmatch globs can match a common string (``*`` any
    sequence, ``?``/``[...]`` any one char — the char-class
    overapproximation can only say "maybe" where the truth is "no",
    which keeps every consumer on the stay-quiet side)."""
    a = _re.sub(r"\[[^\]]*\]", "?", a)
    b = _re.sub(r"\[[^\]]*\]", "?", b)
    seen = set()
    stack = [(0, 0)]
    while stack:
        i, j = stack.pop()
        if (i, j) in seen:
            continue
        seen.add((i, j))
        if i == len(a) and j == len(b):
            return True
        if i < len(a) and a[i] == "*":
            stack.append((i + 1, j))            # * matches empty
            if j < len(b):
                stack.append((i, j + 1))        # * absorbs one char of b
            continue
        if j < len(b) and b[j] == "*":
            stack.append((i, j + 1))
            if i < len(a):
                stack.append((i + 1, j))
            continue
        if i < len(a) and j < len(b) \
                and (a[i] == "?" or b[j] == "?" or a[i] == b[j]):
            stack.append((i + 1, j + 1))
    return False


def pattern_matches_declared(pattern, mode=None):
    """Whether an fnmatch site ``pattern`` can match at least one
    declared site (template placeholders wild) — and, with ``mode``,
    one that honors that mode.  A pattern failing this is a chaos rule
    that can never fire."""
    pattern = str(pattern)
    if "<" in pattern or ">" in pattern:
        # a copy-pasted template name ("replica.<rid>.heartbeat"): the
        # literal placeholder never fnmatches a runtime site, but glob
        # intersection against the template would wave it through —
        # the site-name grammar forbids angle brackets, so reject here
        return False
    for site in FAULT_SITES.values():
        if _globs_intersect(str(pattern), site.glob()) \
                and (mode is None or mode in site.modes):
            return True
    return False


class InjectedFault(MXNetError):
    """A fault fired by the active :class:`FaultPlan`.

    ``transient`` marks it retryable to the serving retry policy — an
    injected execute failure models a transient device fault, which is
    exactly what bounded retries exist to absorb.  ``site``/``mode``
    let tests and the flight recorder attribute the failure."""

    transient = True

    def __init__(self, site, mode="fail"):
        self.site = site
        self.mode = mode
        super().__init__(f"injected fault at {site!r} (mode={mode})")


class FaultRule:
    """One ``site=mode,...`` clause of a plan.  Trigger state (calls
    seen, times fired, RNG) is mutated only under the owning plan's
    lock."""

    __slots__ = ("pattern", "mode", "p", "after", "times", "ms", "seed",
                 "calls", "fired", "_rng")

    def __init__(self, pattern, mode, p=1.0, after=0, times=None,
                 ms=None, seed=0):
        if mode not in _MODES:
            raise MXNetError(
                f"fault rule {pattern!r}: unknown mode {mode!r} "
                f"(expected one of {'/'.join(_MODES)})")
        if not 0.0 <= p <= 1.0:
            raise MXNetError(
                f"fault rule {pattern!r}: p={p} outside [0, 1]")
        if after < 0 or (times is not None and times < 1):
            raise MXNetError(
                f"fault rule {pattern!r}: after must be >= 0 and "
                f"times >= 1 (got after={after}, times={times})")
        self.pattern = pattern
        self.mode = mode
        self.p = float(p)
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.ms = _DEFAULT_MS.get(mode, 0.0) if ms is None else float(ms)
        self.seed = int(seed)
        self.calls = 0
        self.fired = 0
        # per-rule deterministic stream: the decision sequence depends
        # only on (seed, pattern, mode) and this rule's own call order,
        # never on other rules or global RNG state
        import random
        self._rng = random.Random(f"{self.seed}\x1f{pattern}\x1f{mode}")

    def matches(self, site):
        return self.pattern == site or fnmatch.fnmatchcase(site,
                                                           self.pattern)

    def should_fire(self):
        # mxlint: disable=lock-discipline (contract: FaultPlan calls
        # this under its plan lock — rules are plan-internal state)
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def spec(self):
        out = f"{self.pattern}={self.mode}"
        if self.p < 1.0:
            out += f",p={self.p}"
        if self.after:
            out += f",after={self.after}"
        if self.times is not None:
            out += f",times={self.times}"
        if self.ms != _DEFAULT_MS.get(self.mode, 0.0):
            out += f",ms={self.ms}"
        if self.seed:
            out += f",seed={self.seed}"
        return out

    def __repr__(self):
        return (f"FaultRule({self.spec()!r}, calls={self.calls}, "
                f"fired={self.fired})")


def _parse_rule(clause):
    head, _, tail = clause.partition(",")
    site, sep, mode = head.partition("=")
    if not sep or not site or not mode:
        raise MXNetError(
            f"fault spec clause {clause!r}: expected 'site=mode[,k=v...]'"
            f" (grammar in mxnet_tpu_torch/faults.py)")
    kw = {}
    if tail:
        for pair in tail.split(","):
            key, sep, value = pair.partition("=")
            key = key.strip()
            if not sep or key not in ("p", "after", "times", "ms",
                                      "seed"):
                raise MXNetError(
                    f"fault spec clause {clause!r}: bad option {pair!r} "
                    f"(expected p/after/times/ms/seed = value)")
            typ = float if key in ("p", "ms") else int
            try:
                kw[key] = typ(value)
            except ValueError as e:
                raise MXNetError(
                    f"fault spec clause {clause!r}: {e}") from None
    return FaultRule(site.strip(), mode.strip(), **kw)


class FaultPlan:
    """A parsed set of :class:`FaultRule`\\ s plus their firing state.

    The plan owns one lock for trigger bookkeeping; the sleep of a
    delay/stall fault happens OUTSIDE it so a stalled site never blocks
    other sites' trigger decisions."""

    def __init__(self, rules, spec=""):
        from . import engine
        self.rules = list(rules)
        self.spec = spec or ";".join(r.spec() for r in self.rules)
        self._lock = engine.make_lock("faults.FaultPlan._lock")

    @classmethod
    def parse(cls, spec):
        clauses = [c.strip() for c in str(spec).split(";") if c.strip()]
        if not clauses:
            raise MXNetError(
                f"fault spec {spec!r} holds no rules — expected "
                f"'site=mode[,k=v...][;...]'")
        rules = [_parse_rule(c) for c in clauses]
        # the PR-11 bug class: a typo'd site/pattern silently never
        # fires, and the chaos run "passes" while testing nothing.  A
        # warning (not an error): faults are a test harness, and the
        # registry must never make the harness itself the failure.
        for r in rules:
            if not pattern_matches_declared(r.pattern):
                _LOG.warning(
                    "faults: rule %r matches no declared fault site — "
                    "it can never fire (catalogue: "
                    "faults.declared_sites(), docs/serving.md §8)",
                    r.spec())
            elif not pattern_matches_declared(r.pattern, mode=r.mode):
                _LOG.warning(
                    "faults: rule %r: no site matching %r honors mode "
                    "%r — it can never fire", r.spec(), r.pattern,
                    r.mode)
        return cls(rules, spec=str(spec))

    # ------------------------------------------------------------- firing
    def fire(self, site, modes=None):
        """The first matching rule that fires for this call of ``site``
        (or None).  Every matching rule's call counter advances, so
        ``after=N`` counts real traffic even when an earlier rule
        shadows it.  ``modes`` restricts which rule modes may fire —
        sites with custom failure semantics (the page allocator's
        refusal contract) only honor the modes they can express; a
        non-matching mode neither fires nor consumes the rule's
        call/times budget at this site."""
        hit = None
        with self._lock:
            for rule in self.rules:
                if not rule.matches(site):
                    continue
                if modes is not None and rule.mode not in modes:
                    continue
                if rule.should_fire() and hit is None:
                    hit = rule
        if hit is not None:
            self._observe(site, hit)
        return hit

    def _observe(self, site, rule):
        from . import runtime_metrics as _rm, tracing as _tr
        if _rm._ENABLED:
            _rm.SERVING_FAULTS.inc(site=site, mode=rule.mode)
        if _tr._ENABLED:
            ctx = _tr.current_context()
            if ctx is not None:
                now = time.perf_counter()
                _tr.record_span(f"fault.{rule.mode}", ctx, now, now,
                                {"site": site})
        _LOG.debug("faults: fired %s at %s (rule %s)", rule.mode, site,
                   rule.spec())

    # ------------------------------------------------------------ readers
    def counters(self):
        """{'site-pattern:mode': fired} — what actually happened, for
        chaos-smoke assertions and incident dumps.  Multiple rules
        sharing a pattern+mode (staged kills: two ``after=N`` clauses
        on one site) aggregate into one entry."""
        with self._lock:
            out = {}
            for r in self.rules:
                key = f"{r.pattern}:{r.mode}"
                out[key] = out.get(key, 0) + r.fired
            return out

    def debug_state(self):
        with self._lock:
            return {"spec": self.spec,
                    "rules": [{"pattern": r.pattern, "mode": r.mode,
                               "p": r.p, "after": r.after,
                               "times": r.times, "ms": r.ms,
                               "seed": r.seed, "calls": r.calls,
                               "fired": r.fired}
                              for r in self.rules]}

    def __repr__(self):
        return f"FaultPlan({self.spec!r})"


# ---------------------------------------------------------------------------
# module-level switch (the hot path reads ONE global against None)
# ---------------------------------------------------------------------------
_ACTIVE = None


def _init_from_env():
    spec = get_env("MXNET_FAULTS", typ=str)
    if not spec:
        return None
    try:
        return FaultPlan.parse(spec)
    except MXNetError as e:
        # a typo in the chaos knob must not take the process down —
        # faults are a test harness, not a correctness dependency
        _LOG.warning("faults: ignoring invalid MXNET_FAULTS: %s", e)
        return None


def install(plan_or_spec):
    """Activate a plan process-wide (replacing any active one).
    Accepts a :class:`FaultPlan` or a spec string.  Returns the plan."""
    global _ACTIVE
    fp = plan_or_spec if isinstance(plan_or_spec, FaultPlan) \
        else FaultPlan.parse(plan_or_spec)
    _ACTIVE = fp
    return fp


def clear():
    """Deactivate fault injection (back to the zero-cost path)."""
    global _ACTIVE
    _ACTIVE = None


def active():
    """The installed :class:`FaultPlan`, or None."""
    return _ACTIVE


class plan:
    """Scoped installation for tests::

        with faults.plan("serving.execute=fail,times=1"):
            ...
    """

    def __init__(self, plan_or_spec):
        self._plan = plan_or_spec

    def __enter__(self):
        self._prev = _ACTIVE
        return install(self._plan)

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def counters():
    """The active plan's fired counters ({} when off) — merged into
    flight-recorder incident dumps by ``tracing.record_incident``."""
    fp = _ACTIVE
    return fp.counters() if fp is not None else {}


# ---------------------------------------------------------------------------
# injection points
# ---------------------------------------------------------------------------
def _flip_byte(data):
    if not data:
        return data
    buf = bytearray(data)
    buf[len(buf) // 2] ^= 0xFF
    return bytes(buf)


def _corrupt_value(site, value):
    import numpy as np
    if value is None:
        # nothing flows through this site — the honest degraded
        # behavior is a typed failure, not silent success
        raise InjectedFault(site, "corrupt")
    if isinstance(value, (bytes, bytearray)):
        return _flip_byte(value)
    arr = np.array(value, copy=True)
    if arr.dtype.kind == "f" and arr.size:
        arr.flat[arr.size // 2] = np.nan
    elif arr.size:
        arr.flat[arr.size // 2] = ~arr.flat[arr.size // 2]
    return arr


def inject(site, value=None):
    """The generic injection point.  Zero-cost no-op without an active
    plan; otherwise applies the first firing rule for ``site``:

    - ``fail``    -> raises :class:`InjectedFault` (transient);
    - ``delay`` / ``stall`` -> sleeps the rule's ``ms``;
    - ``corrupt`` -> returns a corrupted copy of ``value`` (bytes: one
      flipped byte; float array: one NaN; ``value=None``: raises).

    Returns ``value`` (possibly corrupted) so call sites can thread a
    payload through: ``raw = faults.inject("compile_cache.load", raw)``.
    """
    fp = _ACTIVE
    if fp is None:
        return value
    rule = fp.fire(site)
    if rule is None:
        return value
    if rule.mode == "fail":
        raise InjectedFault(site)
    if rule.mode == "corrupt":
        return _corrupt_value(site, value)
    # mxlint: disable=deadline-soundness (contract: this sleep IS the
    # injected delay/stall fault — the unbounded hang under test that
    # the runtime deadline machinery must bound from the outside)
    time.sleep(rule.ms / 1e3)           # delay | stall
    return value


def check(site):
    """Fire-only probe for sites with custom failure semantics (the
    page allocator reports exhaustion by returning False, not by
    raising).  True when a ``fail``-mode rule fired for ``site``;
    never raises, never sleeps — and only ``fail`` rules fire here,
    so a latency-only plan (``*=delay``) can never masquerade as
    resource exhaustion."""
    fp = _ACTIVE
    if fp is None:
        return False
    return fp.fire(site, modes=("fail",)) is not None


# ---------------------------------------------------------------------------
# the declared-site catalogue (tools/gen_fault_docs.py renders this into
# docs/serving.md §8 and docs/training_resilience.md §2; the
# fault-site-soundness mxlint pass validates every call site and spec
# pattern against it).  Declared BEFORE the env plan parses so a typo'd
# MXNET_FAULTS pattern warns at import.
# ---------------------------------------------------------------------------
declare_fault_site(
    "serving.execute", where="DynamicBatcher.run_batch device execute",
    notes="what the serving retry + bisection + deadline machinery "
          "absorbs")
declare_fault_site(
    "serving.compile", where="DynamicBatcher.program_for bucket build",
    notes="transient build failure; waiters hand the build to a "
          "retrier, `stall` is the wedged-builder shape the deadline "
          "bound covers")
declare_fault_site(
    "deploy.execute", where="StableHLOModel.call direct artifact call")
declare_fault_site(
    "compile_cache.load", where="persistent compile-cache blob read",
    notes="`corrupt` flips a byte so the checksum tier must catch it; "
          "all modes degrade to a counted miss — the cache never "
          "raises")
declare_fault_site(
    "repository.load_artifact", where="ModelRepository deploy-path pull")
declare_fault_site(
    "decode.prefill", where="DecodeEngine prefill model call")
declare_fault_site(
    "decode.step", where="DecodeEngine fixed-batch decode step")
declare_fault_site(
    "decode.verify", where="speculative verification (target model)",
    notes="failure bisects, then quarantines the poisoned sequence "
          "through the §8 path")
declare_fault_site(
    "decode.prefix_lookup", where="prefix-cache radix lookup at "
                                  "admission",
    notes="degrades to a plain prefill, never wrong tokens; no value "
          "flows through, so `corrupt` raises like `fail`")
declare_fault_site(
    "kv_cache.allocate", modes=("fail",),
    where="PageAllocator page grant",
    notes="fail-only: injected pool exhaustion is a refusal, not an "
          "exception")
declare_fault_site(
    "replica.<rid>.execute", where="one replica's dispatch "
                                   "(docs/serving.md §10)",
    notes="kill ONE replica by id, or all at once via `replica.*`")
declare_fault_site(
    "replica.<rid>.heartbeat", where="one replica's beat loop",
    notes="`stall` is the wedged-worker shape siblings must detect")
declare_fault_site(
    "replica.<rid>.decode.prefill",
    where="a replica-owned decode engine's prefill")
declare_fault_site(
    "replica.<rid>.decode.step",
    where="a replica-owned decode engine's decode step")
declare_fault_site(
    "replica.<rid>.decode.verify",
    where="a replica-owned decode engine's speculative verify")
declare_fault_site(
    "replica.<rid>.decode.prefix_lookup",
    where="a replica-owned decode engine's prefix-cache lookup")
declare_fault_site(
    "autoscale.decide", modes=("fail", "delay"),
    where="Autoscaler actuation — fires before add/remove_replica "
          "(docs/serving.md §11)",
    notes="`fail` is the scale-up-whose-prewarm-dies shape: the loop "
          "must count an error decision, keep its target, and back "
          "off, never crash or staircase retries")
declare_fault_site(
    "admission.check", modes=("fail", "delay"),
    where="AdmissionController.check tenant gate (docs/serving.md "
          "§11)",
    notes="`fail` models a broken quota/tier lookup; admission "
          "errors are typed at the caller, never a hang — `delay` "
          "stresses the deadline budget at the earliest gate")

declare_fault_site(
    "train.step", plane="training",
    where="ShardedTrainer.step() entry "
          "(docs/training_resilience.md §2)",
    notes="`stall` is the wedged-collective shape the step watchdog "
          "must bound; `fail` the mid-step kill; `corrupt` raises "
          "(nothing flows through)")
declare_fault_site(
    "train.data.next", modes=("fail", "delay", "stall"), plane="training",
    where="every DataIter.next() batch handoff",
    notes="fires before the cursor advances — a killed fetch never "
          "half-consumes a batch")
declare_fault_site(
    "kvstore.push", modes=("fail", "delay", "stall"), plane="training",
    where="classic kvstore push tier",
    notes="covers gluon.Trainer's sync path")
declare_fault_site(
    "kvstore.pull", modes=("fail", "delay", "stall"), plane="training",
    where="classic kvstore pull tier")
declare_fault_site(
    "kvstore.pushpull", modes=("fail", "delay", "stall"), plane="training",
    where="fused XLA collective launch (kvstore('xla'))",
    notes="one bucketed allreduce = one site")
declare_fault_site(
    "checkpoint.save", plane="training",
    where="CheckpointManager.save; the durability barrier (corrupt)",
    notes="`corrupt` bit-flips one byte of the just-verified step's "
          "payload — post-barrier silent rot the integrity manifest "
          "must detect, never load")
declare_fault_site(
    "checkpoint.restore", plane="training",
    where="CheckpointManager.restore",
    notes="`corrupt` flips the candidate payload before it is read, "
          "forcing the verified-step fallback")

_ACTIVE = _init_from_env()
