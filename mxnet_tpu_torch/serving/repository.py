"""Versioned model store for the serving subsystem (docs/serving.md §2).

The PyTorch port of ``mxnet_tpu.serving.repository``: named models,
integer versions, atomic ``swap`` between them while traffic is in
flight.  Four sources register:

- ``add_block``: an ``nn.Module`` served in-process.  Its parameters and
  buffers are snapshotted at registration (a copy on the module's
  device, eval mode, no gradients), so later training does not mutate
  the served version.  Each shape bucket is one :class:`_BlockProgram`:
  on the card, the forward over static input buffers captured as ONE
  CUDA graph — the counterpart of the JAX package's ``jax.jit`` program
  per bucket;
- ``add_decoder``: an autoregressive LM served by ``generate()``
  through the port's ``DecodeEngine``;
- ``add_function``: a raw python callable (testing / custom runners);
- ``load_artifact``: an artifact of ``deploy.export_stablehlo`` (a
  ``torch.export`` program and its manifest), loaded onto a device.  Its
  buckets are :class:`_BlockProgram` objects over the loaded program's
  module, one module shared by every bucket: on the card one CUDA graph
  per bucket, as ``add_block``'s, whose B1 nodes launch the kernel.

Hot-swap contract: ``swap(name, version)`` atomically repoints the
*current* entry.  Requests resolve their entry once at admission, so an
in-flight batch completes on the version it was admitted under; only
requests admitted after the swap see the new version.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import deploy, engine, faults
from ..base import KernelError, MXNetError, env_truthy, get_env
from ..deploy import (_dtype_name, _module_device, _resolve_dtype,
                      _sig_entry)

__all__ = ["ModelEntry", "ModelRepository", "prewarm_buckets",
           "synth_inputs"]

_UID = itertools.count(1)


class ModelEntry:
    """One immutable servable version of a model.

    ``signature`` is manifest-style: ``[{"shape": [...], "dtype": ...}]``
    with ``None`` dimensions free (``dynamic_batch`` additionally frees
    every leading dimension).  ``make_program(bucket_rows)`` returns a
    fresh built callable over raw arrays for one padded bucket size —
    the DynamicBatcher caches these per bucket.
    """

    def __init__(self, name, version, kind, signature, dynamic_batch,
                 make_program, fixed_batch=None, decode_model=None,
                 draft_model=None, decode_meta=None, quantization=None,
                 decode_model_factory=None, draft_model_factory=None,
                 device=None):
        self.name = name
        self.version = version
        # "block" | "function" | "decoder" | "stablehlo" (an artifact)
        self.kind = kind
        self.signature = signature
        self.dynamic_batch = bool(dynamic_batch)
        self.fixed_batch = fixed_batch      # the batch of a static entry
        self.make_program = make_program
        # decoder entries: the decode-model object generate() drives
        # (serving/decode.py protocol) and its speculative draft
        self.decode_model = decode_model
        self.draft_model = draft_model
        # replica serving: callables yielding a FRESH decode model /
        # draft per replica — each replica's engine owns its model's
        # device state (KV pool, graphs), so N replicas cannot share
        # one stateful model object.  None: the replica layer clones
        # PagedLMAdapters itself
        self.decode_model_factory = decode_model_factory
        self.draft_model_factory = draft_model_factory
        # the torch.device holding the version's weights (None for a
        # function entry): where every replica's programs must run
        self.device = device
        # an artifact's manifest "decode" metadata (export_stablehlo's
        # decode=): the contract for an external decode runtime
        self.decode_meta = decode_meta
        # a quantized artifact's manifest v4 block (mode, per-tensor
        # scales, calibration error); None for a float entry
        self.quantization = quantization
        self.uid = next(_UID)               # distinct across re-registrations

    @property
    def manifest(self):
        # admission-time signature: the batch axis is always free here —
        # static entries are padded up to their batch by the batcher
        # (rows > fixed_batch is rejected separately via max_rows)
        return {"dynamic_batch": True, "inputs": self.signature}

    def max_rows(self, max_batch_size):
        """Row capacity of one dispatched batch for this entry."""
        if self.dynamic_batch:
            return max_batch_size
        return self.fixed_batch if self.fixed_batch else max_batch_size

    def __repr__(self):
        return (f"ModelEntry({self.name}:{self.version}, {self.kind}, "
                f"dynamic_batch={self.dynamic_batch})")


def _as_tuple(out):
    if isinstance(out, tuple):
        return out
    if isinstance(out, list):
        return tuple(out)
    return (out,)


def prewarm_buckets(entry, max_batch_size):
    """The shape buckets a prewarm of ``entry`` must cover — the ONE
    definition of what the dispatcher will use."""
    from .batcher import bucket_set
    if entry.dynamic_batch:
        return bucket_set(max_batch_size)
    if entry.fixed_batch is None:
        raise MXNetError(
            f"prewarm({entry.name!r}): static signature without a "
            f"batch dimension cannot be batch-served")
    return [entry.fixed_batch]


def synth_inputs(entry, rows):
    """Zero-filled inputs matching ``entry``'s signature at ``rows``
    batch rows — the prewarm payload that forces a build and one
    execution without real data."""
    inputs = []
    for spec in entry.signature:
        shape = [1 if d is None else d for d in spec["shape"]]
        if entry.dynamic_batch and shape:
            shape[0] = rows
        inputs.append(np.zeros(tuple(shape),
                               _resolve_dtype(spec["dtype"])))
    return inputs


def _block_signature(example_inputs, dynamic_batch):
    sig = []
    for x in example_inputs:
        shape = list(x.shape)
        if dynamic_batch:
            shape[0] = None
        sig.append(_sig_entry(shape, _dtype_name(x.dtype)))
    return sig


def _snapshot(module):
    """The served copy of ``module``: every parameter and buffer copied
    on its device, eval mode, no gradients (the live module's ``.grad``
    tensors are not copied).  Complete on the device when this returns,
    so any stream may read it."""
    memo = {id(p.grad): None for p in module.parameters()
            if p.grad is not None}
    snap = copy.deepcopy(module, memo)
    snap.eval()
    snap.requires_grad_(False)
    for t in itertools.chain(snap.parameters(), snap.buffers()):
        if t.device.type == "cuda":
            # the copies ran on this thread's current stream
            torch.cuda.current_stream(t.device).synchronize()
            break
    return snap




class _BlockProgram:
    """One shape bucket of an ``add_block`` or ``load_artifact`` entry:
    the forward of the weight snapshot (or of the loaded program's
    module) over ``bucket_rows`` rows.

    Every input lives in ONE static device buffer (a view per input, in
    its signature dtype, each on a 16-byte boundary), staged from one
    packed host buffer (pinned on CUDA) by one non-blocking copy.  On
    CUDA the program is built when it is made: the forward runs once
    eagerly on the program's own stream (which loads the kernel
    libraries and makes cuBLAS's workspace on that stream), then is
    captured as a CUDA graph into the program's own memory pool.  Every
    call stages its inputs, replays the graph, copies each static output
    into pinned host memory, waits on the stream
    (:func:`~mxnet_tpu_torch.engine.sync_outputs`) and returns numpy
    copies.  The flash wrappers count only their eager launches: a
    replay runs the captured kernels without calling them.

    A graph over static buffers is not re-entrant, so one lock holds
    each call from staging through readback; two workers dispatching the
    same bucket take turns.  Each program has its own stream and pool,
    so programs of one entry replay side by side and a capture never
    meets another program's replay on its stream.

    On the CPU every call stages into the static buffers and calls the
    forward on them (the same data path without a graph).  A capture or
    replay that fails raises :class:`~mxnet_tpu_torch.base.KernelError`;
    nothing serves the batch another way."""

    def __init__(self, name, module, signature, dynamic_batch,
                 bucket_rows, device):
        self.name = name
        self.module = module
        self.rows = bucket_rows
        self.device = device
        cuda = device.type == "cuda"
        shapes, dtypes = [], []
        for spec in signature:
            shape = list(spec["shape"])
            if dynamic_batch and shape:
                shape[0] = bucket_rows
            if any(d is None for d in shape):
                raise MXNetError(
                    f"serving {name!r}: input shape {spec['shape']} "
                    f"has a free dimension besides the batch")
            shapes.append(tuple(shape))
            dtypes.append(np.dtype(spec["dtype"]))
        nbytes = [int(np.prod(s, dtype=np.int64)) * d.itemsize
                  for s, d in zip(shapes, dtypes)]
        offs = np.cumsum([0] + [-(-n // 16) * 16 for n in nbytes]).tolist()
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self._host = torch.zeros(max(offs[-1], 16), dtype=torch.uint8,
                                 pin_memory=cuda)
        with self._on_stream():
            self._dev = torch.zeros(max(offs[-1], 16), dtype=torch.uint8,
                                    device=device)
        host = self._host.numpy()
        self._host_views = [host[o:o + n].view(d).reshape(s)
                            for o, n, d, s in zip(offs, nbytes, dtypes,
                                                  shapes)]
        self.args = [self._dev[o:o + n].view(_torch_dtype(d)).view(s)
                     for o, n, d, s in zip(offs, nbytes, dtypes, shapes)]
        self._lock = threading.Lock()
        self.graph = None
        self.outs = None                # the graph's static outputs
        self._out_host = None
        self.replays = 0                # graph launches
        self.capture_s = 0.0            # host seconds of the capture
        if cuda:
            self._build()

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def _stage(self, arrays):
        for view, a in zip(self._host_views, arrays):
            view[...] = a
        self._dev.copy_(self._host, non_blocking=True)

    def _forward(self):
        return _as_tuple(self.module(*self.args))

    def _build(self):
        """Eager forward on the zeroed static inputs, then the capture
        (CUDA only)."""
        with self._on_stream(), torch.no_grad():
            self._forward()
            t0 = time.perf_counter()
            with engine._CAPTURE_LOCK:
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph, pool=self.pool,
                                          stream=self.stream,
                                          capture_error_mode="thread_local"):
                        outs = self._forward()
                except Exception as e:
                    raise KernelError(
                        f"serving: capture of {self.name!r} bucket "
                        f"{self.rows} as a CUDA graph failed: {e}") from e
            self.capture_s = time.perf_counter() - t0
        self.graph, self.outs = graph, outs
        self._out_host = [torch.empty(o.shape, dtype=o.dtype,
                                      pin_memory=True) for o in outs]

    def __call__(self, *arrays):
        with self._lock:
            if self.graph is None:
                with torch.no_grad():
                    self._stage(arrays)
                    return tuple(o.detach().numpy().copy()
                                 for o in self._forward())
            with self._on_stream():
                self._stage(arrays)
                try:
                    self.graph.replay()
                except Exception as e:
                    raise KernelError(
                        f"serving: replay of {self.name!r} bucket "
                        f"{self.rows}'s CUDA graph failed: {e}") from e
                self.replays += 1
                for h, o in zip(self._out_host, self.outs):
                    h.copy_(o, non_blocking=True)
            engine.sync_outputs(self._out_host, site="serving.program",
                                stream=self.stream)
            return tuple(h.numpy().copy() for h in self._out_host)


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


class ModelRepository:
    """Thread-safe name -> versions -> :class:`ModelEntry` store with an
    atomically swappable *current* pointer per name."""

    def __init__(self):
        self._lock = engine.make_lock("serving.ModelRepository._lock")
        # name -> {"current": version, "versions": OrderedDict}
        self._models = {}
        self._unload_listeners = []

    def subscribe_unload(self, callback):
        """Register ``callback(entry)`` to run whenever a version is
        unloaded — ModelServer wires its batcher's program-cache
        eviction here so retired versions do not pin built programs
        (their CUDA graphs, pools and weight snapshot)."""
        with self._lock:
            self._unload_listeners.append(callback)

    def unsubscribe_unload(self, callback):
        """Remove a listener added by :meth:`subscribe_unload` (a
        stopped ModelServer must not stay pinned by the repository)."""
        with self._lock:
            try:
                self._unload_listeners.remove(callback)
            except ValueError:
                pass

    def _notify_unload(self, entries):
        for cb in list(self._unload_listeners):
            for entry in entries:
                try:
                    cb(entry)
                except Exception:   # noqa: BLE001 — eviction best-effort
                    pass

    # ------------------------------------------------------------ register
    def _register(self, entry, activate):
        """Version assignment and registration under ONE lock hold, so
        concurrent auto-versioned registrations cannot collide."""
        with self._lock:
            slot = self._models.setdefault(
                entry.name, {"current": None, "versions": OrderedDict()})
            if entry.version is None:
                ints = [v for v in slot["versions"]
                        if isinstance(v, int)]
                entry.version = max(ints) + 1 if ints else 1
            if entry.version in slot["versions"]:
                raise MXNetError(
                    f"model {entry.name!r} version {entry.version} "
                    f"already registered; unload it or pick a new "
                    f"version")
            slot["versions"][entry.version] = entry
            # activate=False stages even the FIRST version: an operator
            # pre-loading a new model name must be able to validate it
            # before swap() makes it live
            if activate:
                slot["current"] = entry.version
        return entry

    def load_artifact(self, name, path, version=None, activate=True,
                      device="cuda"):
        """Register an artifact of ``deploy.export_stablehlo``.  ``path``
        is the ``.shlo`` file or the bare prefix; the ``.json`` manifest
        beside it becomes the serving signature (an artifact without one
        is refused), and its ``version`` the version unless one is given
        (null: the next free integer).  The program is loaded onto
        ``device`` (moved there if it was exported elsewhere); each
        bucket is a :class:`_BlockProgram` over its module — on the
        card one CUDA graph per bucket, whose capture or replay raises
        :class:`~mxnet_tpu_torch.base.KernelError` on failure, with no
        other path.  A static artifact pads every batch to its exported
        batch.

        A quantized (manifest v4) artifact is served the same way: its
        program dequantizes each weight inside the bucket graph where the
        forward reads it.  On top of ``validate_manifest``'s checks (a
        present digest must verify) it is admitted only with a scale
        digest, unless ``MXNET_SERVING_QUANT_REQUIRE_DIGEST=0``, and only
        if its ``calibration.max_rel_err`` is within
        ``MXNET_SERVING_QUANT_MAX_REL_ERR`` when that is set; the block
        lands on the entry as ``entry.quantization``."""
        if not path.endswith(".shlo"):
            path = path + ".shlo"
        # chaos site: artifact pull/parse failure during a deploy — a
        # typed error on the operator path while traffic keeps serving
        # the current version
        faults.inject("repository.load_artifact")
        model = deploy.load_stablehlo(path, device=device)
        manifest = model.manifest
        if manifest is None:
            raise MXNetError(
                f"load_artifact({name!r}): no manifest next to {path} — "
                f"serving needs the .json signature (re-export with "
                f"deploy.export_stablehlo)")
        quantization = manifest.get("quantization")
        if quantization is not None:
            _admit_quantized(name, quantization)
        dynamic = bool(manifest.get("dynamic_batch"))
        sig = manifest["inputs"]
        fixed = None if dynamic else (sig[0]["shape"][0] if sig else None)
        if version is None:
            version = manifest.get("version")
        module, dev = model.module, model.device

        def make_program(bucket_rows):
            return _BlockProgram(name, module, sig, dynamic, bucket_rows,
                                 dev)

        entry = ModelEntry(name, version, "stablehlo", sig, dynamic,
                           make_program, fixed_batch=fixed,
                           decode_meta=manifest.get("decode"),
                           quantization=quantization, device=dev)
        return self._register(entry, activate)

    def add_block(self, name, module, *example_inputs, version=None,
                  activate=True, dynamic_batch=True):
        """Register an ``nn.Module`` for in-process serving.

        ``example_inputs`` (numpy arrays or tensors, batch-major) fix the
        serving signature: their dtypes and every dimension but the
        batch (with ``dynamic_batch``; all of them without).  The
        module's parameters and buffers are snapshotted now, on its
        device, so later training does not mutate this served version
        (register again and swap to publish new weights).  Each shape
        bucket's program runs the snapshot's forward on the module's
        device — on the card as one CUDA graph (:class:`_BlockProgram`).
        The snapshot's memory returns once the version is unloaded and
        its entry is no longer referenced."""
        if not isinstance(module, torch.nn.Module):
            raise MXNetError(
                f"add_block({name!r}): expected a torch.nn.Module, got "
                f"{type(module).__name__}")
        if not example_inputs:
            raise MXNetError(
                f"add_block({name!r}): pass example inputs to fix the "
                f"serving signature")
        snap = _snapshot(module)
        device = _module_device(snap)
        sig = _block_signature(example_inputs, dynamic_batch)

        def make_program(bucket_rows):
            return _BlockProgram(name, snap, sig, dynamic_batch,
                                 bucket_rows, device)

        entry = ModelEntry(name, version, "block", sig, dynamic_batch,
                           make_program,
                           fixed_batch=None if dynamic_batch
                           else int(example_inputs[0].shape[0]),
                           device=device)
        return self._register(entry, activate)

    def add_decoder(self, name, model, version=None, activate=True,
                    eos_id=None, draft=None, device=None,
                    model_factory=None, draft_factory=None):
        """Register an autoregressive decode model served through
        ``ModelServer.generate()`` (docs/serving.md §6).

        ``model`` is either a
        :class:`~mxnet_tpu_torch.models.TransformerDecoderLM` (wrapped
        in a :class:`~mxnet_tpu_torch.serving.PagedLMAdapter` on
        ``device``, by default the LM's own device, whose decode and
        verify attention run the hand-written kernels inside the
        adapter's CUDA graphs) or any object already implementing the
        decode-model protocol (``prefill``/``decode_step`` — fake models
        in tests).  Decoder entries answer ``generate()`` only;
        ``predict()`` rejects them with a pointer here.  Versioning and
        hot-swap match every other entry kind.

        ``draft`` attaches a speculative-decoding draft model (same
        protocol, typically much smaller) to this entry: with
        ``spec_k`` > 0 the entry's engine has the draft propose k
        tokens per sequence per round and the target verify them in
        one call (docs/serving.md §9).

        ``model_factory`` / ``draft_factory`` (callables returning a
        fresh decode-model / draft object) serve multi-replica
        deployments (``ServingConfig(replicas=N)``): each replica's
        engine needs its OWN model instance because the model binds
        replica-local device state (KV pool, graphs).  Unneeded for a
        ``TransformerDecoderLM`` — the replica layer clones its adapter
        over the same weights."""
        from .decode import as_decode_model
        adapter = as_decode_model(model, eos_id=eos_id,
                                  device=device or _module_device_of(model))
        draft_adapter = None
        if draft is not None:
            draft_adapter = as_decode_model(
                draft, device=device or _module_device_of(draft))

        def wrap_factory(factory, **kw):
            if factory is None:
                return None

            def make():
                obj = factory()
                return as_decode_model(
                    obj, device=device or _module_device_of(obj), **kw)
            return make
        sig = [{"shape": [None], "dtype": "int32"}]

        def make_program(bucket_rows):
            raise MXNetError(
                f"model {name!r} is a decoder entry — it serves "
                f"autoregressive generate(), not predict()")

        entry = ModelEntry(name, version, "decoder", sig, False,
                           make_program, decode_model=adapter,
                           draft_model=draft_adapter,
                           decode_model_factory=wrap_factory(
                               model_factory, eos_id=eos_id),
                           draft_model_factory=wrap_factory(
                               draft_factory),
                           device=getattr(adapter, "device", None))
        return self._register(entry, activate)

    def add_function(self, name, fn, signature, version=None,
                     activate=True, dynamic_batch=True):
        """Register a raw callable ``fn(*arrays) -> array|tuple``
        (custom runners, tests).  ``signature`` is manifest-style."""
        # a hand-written signature gets the same validation a manifest
        # does — a malformed entry (or a concrete leading dim under
        # dynamic_batch, which would mis-split rows at un-pad) would
        # otherwise surface as an opaque failure mid-request
        deploy.validate_signature(signature,
                                  where=f"add_function({name!r})",
                                  dynamic_batch=dynamic_batch)

        def make_program(bucket_rows):
            return lambda *xs: _as_tuple(fn(*xs))

        fixed = None
        if not dynamic_batch and signature \
                and signature[0].get("shape"):
            fixed = signature[0]["shape"][0]
        entry = ModelEntry(name, version, "function", signature,
                           dynamic_batch, make_program,
                           fixed_batch=fixed)
        return self._register(entry, activate)

    # ------------------------------------------------------------- resolve
    def get(self, name):
        """The current :class:`ModelEntry` for ``name`` (atomic read)."""
        return self._resolve(name)

    def _resolve(self, name, version=None):
        """The entry for (name, version); version=None means current."""
        with self._lock:
            slot = self._models.get(name)
            if slot is None:
                raise MXNetError(
                    f"no model {name!r} in the repository "
                    f"(known: {sorted(self._models)})")
            v = slot["current"] if version is None else version
            if v is None:
                raise MXNetError(
                    f"model {name!r} has no active version (staged: "
                    f"{list(slot['versions'])}) — activate one with "
                    f"swap({name!r}, version), or address it directly "
                    f"with version=")
            if v not in slot["versions"]:
                raise MXNetError(
                    f"model {name!r} has no version {v!r} "
                    f"(have: {list(slot['versions'])})")
            return slot["versions"][v]

    def prewarm(self, name, version=None, *, batcher, max_batch_size=None):
        """Build EVERY shape bucket of (name, version) through
        ``batcher``'s program cache and execute each program once, so an
        atomic hot-swap admits traffic with no build left on the request
        path (docs/serving.md §5).  The deploy loop is::

            repo.add_block("m", module, *examples, activate=False)
            srv.prewarm("m", version=2)                     # build all
            repo.swap("m", 2)                               # cutover

        ``version=None`` prewarms the current version (cold-start path).
        Each program runs once here on zero-filled inputs.  Returns a
        summary dict (buckets warmed, build/disk-hit counts from the
        batcher delta)."""
        entry = self._resolve(name, version)
        if max_batch_size is None:
            max_batch_size = batcher.config.max_batch_size
        buckets = prewarm_buckets(entry, max_batch_size)
        compiled = disk_hits = 0
        for rows in buckets:
            # attribute builds to THIS entry (the global batcher
            # counters also move for concurrent traffic on other
            # models/versions — the documented prewarm-under-load flow)
            before = batcher.programs(entry)
            prog = batcher.program_for(entry, rows)
            if batcher.programs(entry) > before:
                if getattr(prog, "_mx_from_disk_cache", False):
                    disk_hits += 1
                else:
                    compiled += 1
            inputs = synth_inputs(entry, rows)
            try:
                outs = prog(*inputs)
                engine.sync_outputs(
                    outs if isinstance(outs, (tuple, list)) else (outs,),
                    site="serving.prewarm")
            except Exception as e:
                raise MXNetError(
                    f"prewarm({name!r}:{entry.version}): bucket {rows} "
                    f"failed: {e}") from e
        return {"model": name, "version": entry.version,
                "buckets": buckets,
                "compiled": compiled, "disk_hits": disk_hits}

    def swap(self, name, version):
        """Atomically repoint ``name`` to ``version``; returns the
        previous current version.  In-flight requests finish on the
        entry they were admitted under."""
        with self._lock:
            slot = self._models.get(name)
            if slot is None:
                raise MXNetError(f"no model {name!r} in the repository")
            if version not in slot["versions"]:
                raise MXNetError(
                    f"model {name!r} has no version {version!r} "
                    f"(have: {list(slot['versions'])})")
            prev, slot["current"] = slot["current"], version
            return prev

    def versions(self, name):
        with self._lock:
            slot = self._models.get(name)
            return list(slot["versions"]) if slot else []

    def models(self):
        with self._lock:
            return sorted(self._models)

    def debug_state(self):
        """JSON-serializable snapshot of the version map (one entry per
        model: current version, staged versions, entry kinds) for the
        flight recorder (``ModelServer.debug_state``)."""
        with self._lock:
            return {
                name: {
                    "current": slot["current"],
                    "versions": [
                        {"version": v, "kind": e.kind, "uid": e.uid,
                         "dynamic_batch": e.dynamic_batch}
                        for v, e in slot["versions"].items()],
                }
                for name, slot in self._models.items()}

    def current_version(self, name):
        with self._lock:
            slot = self._models.get(name)
            return slot["current"] if slot else None

    def unload(self, name, version=None):
        """Drop one version (or the whole model when ``version`` is
        None).  Refuses to drop the current version of a multi-version
        model — swap first.  Unload listeners (program-cache eviction)
        run after the lock is released."""
        with self._lock:
            slot = self._models.get(name)
            if slot is None:
                raise MXNetError(f"no model {name!r} in the repository")
            if version is None:
                removed = list(slot["versions"].values())
                del self._models[name]
            else:
                if version not in slot["versions"]:
                    raise MXNetError(
                        f"model {name!r} has no version {version!r}")
                if version == slot["current"] \
                        and len(slot["versions"]) > 1:
                    raise MXNetError(
                        f"model {name!r} version {version!r} is "
                        f"current — swap to another version before "
                        f"unloading it")
                removed = [slot["versions"].pop(version)]
                if not slot["versions"]:
                    del self._models[name]
        self._notify_unload(removed)


def _admit_quantized(name, quantization):
    """Serving admission of a quantized artifact, on top of the
    structural and digest checks ``validate_manifest`` ran: its scales
    must carry their digest, and an operator can bound the calibration
    error a version may serve (``MXNET_SERVING_QUANT_*``)."""
    if env_truthy("MXNET_SERVING_QUANT_REQUIRE_DIGEST", True) \
            and not isinstance(quantization.get("digest"), str):
        raise MXNetError(
            f"load_artifact({name!r}): quantized manifest ships no scale "
            f"digest — re-export with deploy.export_stablehlo("
            f"quantize=...) (or set MXNET_SERVING_QUANT_REQUIRE_DIGEST=0 "
            f"to admit unprotected scales)")
    max_err = get_env("MXNET_SERVING_QUANT_MAX_REL_ERR", typ=float)
    rel = (quantization.get("calibration") or {}).get("max_rel_err")
    if max_err is not None and rel is not None \
            and float(rel) > float(max_err):
        raise MXNetError(
            f"load_artifact({name!r}): quantized artifact's calibration "
            f"error {float(rel):.4g} exceeds the admission bound "
            f"MXNET_SERVING_QUANT_MAX_REL_ERR={float(max_err):.4g} — "
            f"recalibrate/re-export, or raise the bound")


def _module_device_of(model):
    """The device of a module's parameters ("cuda" for a non-module: the
    port's entry points run on the card unless asked otherwise)."""
    if isinstance(model, torch.nn.Module):
        return _module_device(model)
    return "cuda"
