"""The CachedOp tier of ``HybridBlock.hybridize`` (reference:
``src/imperative/cached_op.cc``; the JAX package's ``CachedOp``).

A hybridized block keeps one :class:`_HybridProgram` per signature: the
inputs' shapes and dtypes (under ``record()`` also whether each needs a
gradient: it is attached, or computed on the tape), the parameters'
shapes, dtypes and ``grad_req``, ``autograd.is_training()`` and the
device.  An input that is neither attached nor taped gets no gradient
from a replay, so ``autograd.grad`` with respect to it needs
``attach_grad()`` first, as in upstream MXNet.  :class:`CachedOp`
holds at most ``cache_size`` signatures, the least recently used going
first, with a warning at evictions 1, 10, 100 and 1000.

On the card a program is CUDA graphs over static buffers, on its
CachedOp's own stream (one per device: cuBLAS keeps a workspace per
stream), each instance in a memory pool of its own:

- the first call of a signature runs eagerly on that stream (once for
  its inference use and once under ``record()``): a real call, which
  also loads the kernel libraries and makes cuBLAS's workspace on the
  stream.  The graphs are captured after it;
- inference: one forward graph.  Every later call copies the inputs
  in, replays, and returns copies of the static outputs;
- under ``record()``: a forward graph whose autograd saved tensors stay
  in the instance's pool, and a backward graph, ``torch.autograd.grad``
  of the outputs with respect to the inputs that need a gradient and
  the attached parameters, from static output-gradient buffers.  A
  :class:`_Replay` node joins them on the tape: its forward replays the
  forward graph, its backward copies the cotangents in, replays the
  backward graph and returns copies of the gradients.  An instance is
  busy from its forward until a backward that keeps no graph ran over
  it or its outputs died; a recorded call that finds every instance of
  its signature busy captures another one, as many as the calls that
  wait (gradient accumulation over micro-batches in one ``record()``),
  and an idle instance is reused before a new one is captured.  Each
  instance holds its own pool: the static buffers, the graphs'
  workspace and the saved activations of one call.  ``stats()``'s
  ``pool_bytes`` is what the capture left allocated; the pool reserves
  more, for the captures' temporaries.  ``Trainer.step`` adds graphs
  of the backward and the update, or of the whole step, to an
  instance's pool (``instance.fused``, by Trainer); the whole step's
  graph holds a second forward's saved activations there.  On an H100
  (fp32): a BERT-large encoder layer with its loss at L 512, batch 8,
  453 MB allocated at capture, 841 MB reserved with the backward +
  update graph and 1,076 MB with the whole step's; LeNet of
  ``examples/mnist_gluon.py`` at batch 64, 42 MB allocated; each
  further LeNet instance of an 8-row micro-batch 2.6 MB allocated,
  23 MB reserved (the allocator's segments are 20 MB at least).

The lazy forward (``MXNET_DEFERRED_HYBRID_FWD``, default ``"1"``; the
reference's deferred forward).  The first recorded call of a signature
runs and captures as above; from the second on, a recorded call claims
an instance, copies its inputs into the instance's static buffers at
once (an input written in place before the step does not change it)
and returns lazy outputs (``NDArray._deferred``): nothing runs.  A
backward over them stays pending (``autograd.backward``), and
``Trainer.step`` runs forward, backward and update as one CUDA graph
of the instance (``Trainer._full_fused_step``).  Anything else
that reads a lazy output first runs the forward as a recorded replay
(:meth:`_Lazy.materialize`), and the step then takes the backward +
update graph with the same numbers.  A lazy forward runs at the latest
before anything writes the weights it reads: ``Trainer.step`` and
``update`` run every other one first, and so do a call of a block
that binds a replaced parameter value, ``Parameter.set_data``,
``nd.waitall`` and a write of a weight array (``NDArray.__setitem__``,
``_set_data``: :func:`before_write`, which also runs a deferred
backward over that weight first).  A lazy forward's effects happen
when it runs, not when it was recorded: BatchNorm's running statistics are written then (by a
materialized forward or by the step's graph, never both; reading one
runs the forward first), and Dropout draws its mask then, from the
default generator of the device, so the deferred and the materialized
forward of one call draw the same mask when nothing else draws in
between (on the card the graph registered that generator at capture
and advances its offset at every replay).  ``MXNET_DEFERRED_HYBRID_FWD=0`` runs
every recorded call when it is made.

The graphs read the parameters by address.  A captured forward reads
each parameter through an alias of its home (a fresh leaf over the
same storage, one per instance), and the captured backward
differentiates with respect to the aliases: a home's own autograd
accumulator may have been made on another stream by an eager recorded
call whose graph is still alive (a kept loss), and a capture that ran
into it would make the legacy stream wait on the capturing one.  Each
call binds every parameter array (``NDArray._bind``): a value replaced
since the last call (``Parameter.set_data``, ``load_parameters``, a
per-parameter optimizer's write) is copied into the bound tensor first
and counted in :meth:`CachedOp.stats` (``param_copies``).  Autograd
saves tensors as they are, without its version check (:func:`_as_is`):
a replayed backward reads what the last forward replay wrote, whatever
in-place writes (input staging, the update) came after the capture.  So a
replay's backward that would read weights written in place since its
forward (a binding copy, or ``Trainer.step``'s fused update between a
``backward(retain_graph=True)`` and the next) raises
:class:`~mxnet_tpu_torch.base.MXNetError` instead
(``ndarray.count_write``).  The reference's arrays are immutable, so
its second backward gives the gradient at the forward's weights.

On the CPU the same static-buffer path runs without graphs: each call
runs the forward on the instance's buffers, and its backward is
``torch.autograd.grad`` over that call's graph.

A capture or replay that fails raises
:class:`~mxnet_tpu_torch.base.KernelError`, and so does every later
call of that signature; nothing runs the forward another way.  A host
read inside the forward (``asnumpy``, CTC's ``tolist``) makes the
capture fail.  Only ``hybridize(False)`` runs the block eagerly.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import time
import warnings
import weakref
from collections import OrderedDict

import torch

from .. import autograd
from ..base import KernelError, MXNetError, get_env
from ..ndarray import NDArray, dtype_name
from ..ndarray.ndarray import home_writes
from ..ops.registry import OpDef, invoke

__all__ = ["CachedOp", "before_write", "in_program",
           "nb_cached_programs", "run_lazy"]

# set while a CachedOp runs its block's forward: the children run their
# plain forward inside the parent's program
_TRACING = contextvars.ContextVar("mxnet_tpu_torch_cached_op_tracing",
                                  default=False)
# set while a program runs its block's forward (not during the plain
# pass that resolves deferred shapes): a forward hook sees the program's
# tensors there, which a host read would break under capture
_IN_PROGRAM = contextvars.ContextVar("mxnet_tpu_torch_cached_op_program",
                                     default=False)
_N_CACHED_PROGRAMS = 0
# the lazy forwards not run yet, in the order they were recorded
_LAZY = []


def in_program():
    """A CachedOp program (or a functionalized block) is running its
    block's forward on this thread."""
    return _IN_PROGRAM.get()


def nb_cached_programs():
    """Programs built by the CachedOps of this process."""
    return _N_CACHED_PROGRAMS


def _defer_forward():
    """Recorded calls after a signature's first return lazy outputs
    (module docstring)."""
    return get_env("MXNET_FUSED_HYBRID_STEP", "1") != "0" \
        and get_env("MXNET_DEFERRED_HYBRID_FWD", "1") != "0"


@contextlib.contextmanager
def recording(training):
    """``autograd``'s state of a recorded call, for a forward that runs
    after its ``record()`` scope closed."""
    rec = autograd.set_recording(True)
    train = autograd.set_training(training)
    try:
        with torch.enable_grad():
            yield
    finally:
        autograd.set_recording(rec)
        autograd.set_training(train)


def _pending_lazy():
    """The lazy forwards not run yet, in the order they were recorded."""
    live = [r() for r in _LAZY]
    _LAZY[:] = [r for r, lz in zip(_LAZY, live)
                if lz is not None and lz.claim is not None]
    return [lz for lz in live if lz is not None and lz.claim is not None]


def run_lazy(exclude=None):
    """Run every lazy forward not run yet but ``exclude``'s, in the order
    they were recorded (module docstring)."""
    if _LAZY:
        for lz in _pending_lazy():
            if lz is not exclude:
                lz.materialize()


def before_write(home):
    """``home``, a bound tensor, is about to be written in place or its
    array's value replaced: every lazy forward (in order) if one of them
    reads it, then a deferred backward over a replay that reads it, so
    that both see the value their call was recorded with."""
    if _LAZY and any(h is home for lz in _pending_lazy()
                     for h in lz.claim.inst.prog.homes):
        run_lazy()
    pending = autograd.peek_pending()
    if pending is not None and any(h is home for h in
                                   pending["claim"].inst.prog.homes):
        autograd.flush_pending()


def _as_is():
    """Autograd saves each tensor as it is: the backward reads the
    tensor's memory when it runs, with no version check."""
    return torch.autograd.graph.saved_tensors_hooks(
        lambda t: t.detach(), lambda t: t)


class _CudaGraphs:
    """Graph capture on the card: one stream, a memory pool per
    instance."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def pool(self):
        return torch.cuda.graph_pool_handle()

    def capture(self, fn, pool):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    @contextlib.contextmanager
    def on_stream(self):
        """Run on this stream, ordered after the caller's work and before
        the caller's next; yields the caller's stream."""
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield caller
        caller.wait_stream(self.stream)

    def memory(self):
        return torch.cuda.memory_allocated(self.device)


def _graph_backend(device):
    """CUDA graphs on the card; None on the CPU (no graphs)."""
    return _CudaGraphs(device) if device.type == "cuda" else None


def _flatten(out):
    if isinstance(out, NDArray):
        return [out], None
    if isinstance(out, (list, tuple)):
        flat, tree = [], []
        for o in out:
            f, t = _flatten(o)
            flat.extend(f)
            tree.append((len(f), t))
        return flat, tree
    raise MXNetError(f"hybrid_forward returned unsupported type {type(out)}")


def _unflatten(flat, tree):
    if tree is None:
        return flat[0]
    out, i = [], 0
    for n, sub in tree:
        out.append(_unflatten(flat[i:i + n], sub))
        i += n
    return tuple(out)


def _needs_grad(x):
    """An input whose gradient someone reads: an attached array, or one
    computed on the tape (its gradient flows on to the leaves)."""
    return x._data.grad_fn is not None \
        or (x._grad is not None and x._grad_req != "null")


def _pad(x, *, pad):
    return torch.nn.functional.pad(x, pad)


class _Claim:
    """One recorded replay's hold on its instance (module docstring);
    lives as long as the replay's tape node."""

    __slots__ = ("inst", "arrays", "leaf_inputs", "released", "writes",
                 "staged", "__weakref__")

    def __init__(self, inst, arrays, leaf_inputs, staged=False):
        self.inst = inst
        self.arrays = arrays            # the replay's inputs, then params
        self.leaf_inputs = leaf_inputs
        self.released = False
        self.writes = home_writes(inst.prog.homes)
        self.staged = staged            # inputs copied in at record time

    def release(self):
        self.released = True

    def current(self):
        """No weight was written in place or replaced since the
        forward."""
        return home_writes(self.inst.prog.homes) == self.writes and all(
            a._t is a._home for a in self.arrays[self.inst.prog.n_in:])


class _Replay(torch.autograd.Function):
    """A recorded replay on the tape: forward and backward graphs."""

    @staticmethod
    def forward(ctx, claim, *tensors):
        ctx._mx_claim = claim
        return tuple(claim.inst.forward(tensors[:claim.inst.prog.n_in],
                                        stage=not claim.staged))

    @staticmethod
    def backward(ctx, *cots):
        claim = ctx._mx_claim
        if claim.released:
            raise MXNetError(
                "backward through this hybridized block's graph a second "
                "time: its saved buffers belong to a later call now; call "
                "every earlier backward with retain_graph=True")
        if home_writes(claim.inst.prog.homes) != claim.writes:
            raise MXNetError(
                "backward through this hybridized block's graph after its "
                "weights were written in place (a Trainer.step or a new "
                "value bound since the forward): it would not give the "
                "gradient at the forward's weights; run the backward "
                "before the step")
        return (None,) + tuple(claim.inst.backward(cots))


class _Lazy:
    """The forward of one deferred recorded call (module docstring):
    its claim on an instance (inputs staged), the call's input tensors
    (the tape's links) and its lazy outputs.  The forward writes the
    block's parameters without a gradient in place (BatchNorm's running
    statistics): those arrays carry the lazy forward too (``_lazy``),
    so that reading one runs it first."""

    __slots__ = ("claim", "tensors", "outs", "aux", "failed", "training",
                 "__weakref__")

    def __init__(self, claim, tensors, training):
        self.claim = claim              # None once the forward ran
        self.tensors = tensors
        self.training = training
        self.outs = []                  # weakrefs of the lazy outputs
        self.aux = [a for a in claim.arrays[claim.inst.prog.n_in:]
                    if a._grad_req == "null"]
        for a in self.aux:
            a._lazy = self
        self.failed = None

    def start(self):
        """The forward is about to run: its aux arrays read as they are."""
        for a in self.aux:
            if a._lazy is self:
                a._lazy = None

    def index(self, arr):
        """The flat output position of ``arr``."""
        return next(i for i, r in enumerate(self.outs) if r() is arr)

    def fill(self, tensors):
        """Give the lazy outputs their values: the forward ran."""
        self.start()
        for ref, t in zip(self.outs, tensors):
            out = ref()
            if out is not None:
                out._data = t
        self.claim = None
        self.tensors = None

    def fail(self, error):
        """The step that was to run this forward failed: every read of an
        output raises."""
        self.start()
        self.failed = error
        self.claim = None
        self.tensors = None

    def materialize(self):
        """Run the forward now, as a recorded replay on the tape."""
        if self.failed is not None:
            raise KernelError(
                f"this output's hybridized forward was to run inside a "
                f"Trainer.step that failed: {self.failed}")
        claim = self.claim
        if claim is None:
            return
        if not claim.current():
            raise MXNetError(
                "a lazy output of a hybridized block is read after the "
                "weights its forward reads were written in place; read it "
                "before the write, or set MXNET_DEFERRED_HYBRID_FWD=0")
        prog = claim.inst.prog
        self.start()
        with recording(self.training):
            outs = _Replay.apply(claim, *self.tensors, *prog.homes)
        self.fill(outs)


class _Instance:
    """The static buffers and graphs of one use of a program."""

    def __init__(self, prog, recording):
        self.prog = prog
        self.recording = recording
        self.inputs = []
        for shape, dtype, need in prog.in_specs:
            buf = torch.zeros(shape, dtype=dtype, device=prog.device)
            if need:
                buf.requires_grad_(True)
            self.inputs.append(buf)
        self.pool = prog.graphs.pool() if prog.graphs is not None else None
        self.fwd = self.bwd = None      # CUDA graphs
        self.outs = None                # static outputs (CPU: the last call's)
        self.root_idx = ()              # outputs that carry a gradient
        self.grad_outs = None           # static output gradients
        self.grads = None               # static gradients, by prog.grad_pos
        # Trainer -> its backward + update programs of this instance
        self.fused = weakref.WeakKeyDictionary()
        self.claim = None               # weakref of the replay holding it
        self.capture_s = 0.0
        self.pool_bytes = 0
        # on the card the graphs read and differentiate fresh leaves over
        # the homes' storage (module docstring)
        self.alias = None if prog.graphs is None else [
            h.detach().requires_grad_(h.requires_grad) for h in prog.homes]

    def busy(self):
        claim = self.claim() if self.claim is not None else None
        return claim is not None and not claim.released

    def leaves(self):
        """The tensors the backward differentiates with respect to."""
        n_in = self.prog.n_in
        homes = self.alias if self.alias is not None else self.prog.homes
        return [self.inputs[k] if k < n_in else homes[k - n_in]
                for k in self.prog.grad_pos]

    def stage(self, tensors):
        with torch.no_grad():
            for buf, t in zip(self.inputs, tensors):
                buf.copy_(t)

    @contextlib.contextmanager
    def _aliased(self):
        """The parameter arrays read this instance's aliases of their
        homes for the block's forward."""
        if self.alias is None:
            yield
            return
        arrays = self.prog.arrays
        saved = [a._t for a in arrays]
        for a, t in zip(arrays, self.alias):
            a._t = t
        try:
            yield
        finally:
            for a, t in zip(arrays, saved):
                a._t = t

    def run(self):
        """The block's forward on the static inputs, saving as it is."""
        with _as_is(), self._aliased():
            outs = self.prog.run(self.inputs)
        if self.recording:
            self.root_idx = tuple(i for i, o in enumerate(outs)
                                  if o.requires_grad)
        return outs

    def gradients(self, roots, cots):
        """``torch.autograd.grad`` of ``roots`` over this instance's
        saved tensors (kept for another backward)."""
        leaves = self.leaves()
        if not roots or not leaves:
            return [None] * len(leaves)
        return list(torch.autograd.grad(roots, leaves, cots,
                                        retain_graph=True,
                                        allow_unused=True))

    def capture(self):
        """Capture the forward graph (and under ``record()`` the backward
        graph) over the staged inputs."""
        graphs = self.prog.graphs
        t0 = time.perf_counter()
        self.fwd, self.outs = graphs.capture(self.run, self.pool)
        if self.recording:
            roots = [self.outs[i] for i in self.root_idx]
            self.grad_outs = [torch.zeros_like(o) for o in roots]
            if roots and self.prog.grad_pos:
                self.bwd, grads = graphs.capture(
                    lambda: self.gradients(roots, self.grad_outs), self.pool)
                self.grads = list(grads)
        self.capture_s = time.perf_counter() - t0

    def forward(self, tensors, stage=True):
        """Copies of the outputs of a forward over ``tensors`` (staged
        already when not ``stage``)."""
        prog = self.prog
        if prog.graphs is None:
            if stage:
                self.stage(tensors)
            with torch.enable_grad():
                self.outs = self.run()
            return [o.detach().clone() for o in self.outs]
        with prog.graphs.on_stream() as caller:
            if stage:
                self.stage(tensors)
            prog.replay(self.fwd)
            outs = [o.detach().clone() for o in self.outs]
        for o in outs:
            o.record_stream(caller)
        return outs

    def backward(self, cots):
        """The gradients of every input and parameter of the replay (None
        where there is none), from the outputs' cotangents."""
        prog = self.prog
        full = [None] * (prog.n_in + len(prog.homes))
        sel = [cots[i] for i in self.root_idx]
        if prog.graphs is None:
            grads = self.gradients([self.outs[i] for i in self.root_idx],
                                   sel)
        elif self.bwd is None:
            grads = []
        else:
            with prog.graphs.on_stream() as caller:
                with torch.no_grad():
                    for buf, c in zip(self.grad_outs, sel):
                        buf.copy_(c)
                prog.replay(self.bwd)
                grads = [None if g is None else g.clone()
                         for g in self.grads]
            for g in grads:
                if g is not None:
                    g.record_stream(caller)
        for pos, g in zip(prog.grad_pos, grads):
            full[pos] = g
        return full


class _HybridProgram:
    """One signature of a :class:`CachedOp` (module docstring)."""

    def __init__(self, cop, sig, inputs, arrays, homes):
        self.cop = cop
        self.block = cop._block
        self.sig = sig
        self.ctx = inputs[0].context
        self.device = inputs[0]._data.device
        self.in_specs = [(tuple(x.shape), x._data.dtype, need)
                         for x, (_s, _d, need) in zip(inputs, sig[0])]
        self.n_in = len(inputs)
        self.arrays = list(arrays)
        self.homes = homes
        self.grad_pos = [k for k, spec in enumerate(self.in_specs)
                         if spec[2]]
        self.grad_pos += [self.n_in + j for j, a in enumerate(arrays)
                          if a._grad is not None and a._grad_req != "null"]
        self.graphs = cop._graphs_on(self.device)
        self.tree = None
        self.out_specs = None           # recorded outputs' (shape, dtype)
        self.warm = set()               # uses that ran their eager call
        self.infer = None               # the inference instance
        self.rec = []                   # recorded instances
        self.failed = None
        self.replays = 0

    def run(self, tensors):
        """The block's forward over ``tensors``: flat output tensors."""
        xs = [NDArray._wrap(t, self.ctx) for t in tensors]
        tok, in_prog = _TRACING.set(True), _IN_PROGRAM.set(True)
        try:
            out = self.block.forward(*xs)
        finally:
            _IN_PROGRAM.reset(in_prog)
            _TRACING.reset(tok)
        flat, self.tree = _flatten(out)
        return [a._data for a in flat]

    def _error(self, what, e):
        self.failed = e
        return KernelError(
            f"CachedOp for block {self.block.name!r}: {what} of the CUDA "
            f"graph for inputs {[s[0] for s in self.sig[0]]} failed (a "
            f"host read inside the forward, such as asnumpy or CTC's "
            f"tolist, cannot be captured): {e}")

    def replay(self, graph):
        try:
            graph.replay()
        except Exception as e:
            raise self._error("replay", e) from e
        self.replays += 1

    def _instance(self, recording, tensors):
        if self.graphs is None:
            inst = _Instance(self, recording)
            inst.stage(tensors)
            return inst
        with self.graphs.on_stream():
            before = self.graphs.memory()
            inst = _Instance(self, recording)
            inst.stage(tensors)
            try:
                inst.capture()
            except Exception as e:
                raise self._error("capture", e) from e
            # the static buffers and what the captures keep allocated
            inst.pool_bytes = self.graphs.memory() - before
        return inst

    def __call__(self, inputs, arrays, recording):
        if self.failed is not None:
            raise KernelError(
                f"CachedOp for block {self.block.name!r}: the CUDA graph "
                f"of this signature failed earlier: {self.failed}")
        tensors = [x._data for x in inputs]
        use = "record" if recording else "infer"
        if self.graphs is not None and use not in self.warm:
            with self.graphs.on_stream() as caller:
                outs = self.run(tensors)
            for o in outs:
                o.record_stream(caller)
            self.warm.add(use)
            inst = self._instance(recording, tensors)
            if recording:
                self.rec.append(inst)
                self._recorded(outs)
            else:
                self.infer = inst
            return outs
        if not recording:
            return self._infer(tensors)
        leaf = all(t.grad_fn is None for t in tensors)
        if self.out_specs is not None and _defer_forward():
            return self._defer(inputs, arrays, tensors, leaf)
        inst = self._idle(tensors)
        claim = _Claim(inst, list(inputs) + list(arrays), leaf)
        inst.claim = weakref.ref(claim)
        outs = list(_Replay.apply(claim, *tensors, *self.homes))
        self._recorded(outs)
        return outs

    def _recorded(self, outs):
        """The first recorded call ran: later ones may defer."""
        if self.out_specs is None:
            self.out_specs = [(tuple(o.shape), o.dtype) for o in outs]

    def _idle(self, tensors):
        """An idle recorded instance, else a new one."""
        inst = next((i for i in self.rec if not i.busy()), None)
        if inst is None:
            inst = self._instance(True, tensors)
            self.rec.append(inst)
        return inst

    def _defer(self, inputs, arrays, tensors, leaf):
        """Claim an instance, stage the inputs, return lazy outputs."""
        inst = self._idle(tensors)
        if self.graphs is None:
            inst.stage(tensors)
        else:
            with self.graphs.on_stream():
                inst.stage(tensors)
        claim = _Claim(inst, list(inputs) + list(arrays), leaf, staged=True)
        inst.claim = weakref.ref(claim)
        lazy = _Lazy(claim, tensors, self.sig[2])
        outs = [NDArray._deferred(shape, dtype, self.ctx, lazy)
                for shape, dtype in self.out_specs]
        lazy.outs = [weakref.ref(o) for o in outs]
        _pending_lazy()
        _LAZY.append(weakref.ref(lazy))
        return outs

    def _infer(self, tensors):
        if self.infer is None:
            self.infer = _Instance(self, False)
        return self.infer.forward(tensors)

    def instances(self):
        return ([self.infer] if self.infer is not None else []) + self.rec

    def close(self):
        """Drop the graphs and buffers (and with them the pools, once no
        output of a replay holds an instance any more)."""
        self.infer, self.rec = None, []


class CachedOp:
    """The per-signature programs of a hybridized block (module
    docstring).  ``static_alloc`` / ``static_shape`` are accepted for
    the reference's signature: every program keeps static buffers."""

    def __init__(self, block, static_alloc=False, static_shape=False,
                 cache_size=None, bucket_shapes=None):
        self._block = block
        self._cache = OrderedDict()     # signature -> _HybridProgram (LRU)
        if cache_size is None:
            cache_size = int(get_env("MXNET_CACHED_OP_CACHE_SIZE", 16))
        self._cache_size = max(1, int(cache_size))
        self._n_evictions = 0
        self._param_copies = 0
        self._graphs = {}               # device -> graph backend
        if bucket_shapes is not None:
            bucket_shapes = {int(ax): sorted(int(s) for s in sizes)
                             for ax, sizes in dict(bucket_shapes).items()}
        self._bucket_shapes = bucket_shapes

    def _bucketize(self, inputs):
        """Pad each input's bucketed axes with zeros up to the next
        declared size, through the op dispatcher (a taped pad, whose
        backward is a slice).  The block must be padding-safe on those
        axes; outputs keep the padded size."""
        out = []
        for x in inputs:
            pad = [0] * (2 * x.ndim)
            for ax, sizes in self._bucket_shapes.items():
                if ax >= x.ndim:
                    continue
                cur = x.shape[ax]
                fit = [s for s in sizes if s >= cur]
                if not fit:
                    raise MXNetError(
                        f"CachedOp bucket_shapes: input axis {ax} has size "
                        f"{cur}, larger than the largest declared bucket "
                        f"{sizes[-1]}")
                # F.pad lists (before, after) from the last axis back
                pad[2 * (x.ndim - 1 - ax) + 1] = fit[0] - cur
            if any(pad):
                x = invoke(OpDef("bucket_pad",
                                 functools.partial(_pad, pad=tuple(pad)),
                                 1, 1, True), [x], {})
            out.append(x)
        return out

    def __call__(self, inputs, ctx):
        params = list(self._block.collect_params().values())
        # a parameter still waiting for its shape raises here, before
        # anything else happens
        arrays = [p.data(ctx) for p in params]
        if self._bucket_shapes:
            inputs = self._bucketize(inputs)
        recording = autograd.is_recording()
        sig = (tuple((tuple(x.shape), dtype_name(x._data.dtype),
                      recording and _needs_grad(x)) for x in inputs),
               tuple((tuple(a.shape), dtype_name(a._data.dtype), p.grad_req)
                     for p, a in zip(params, arrays)),
               autograd.is_training(), inputs[0]._data.device)
        if _LAZY and any(a._home is not None and a._t is not a._home
                         for a in arrays):
            # a replaced value is about to be copied into a weight that a
            # lazy forward reads
            run_lazy()
        prog = self._cache.get(sig)
        if prog is None:
            homes = [self._bind(a) for a in arrays]
            prog = self._build(sig, inputs, arrays, homes)
        else:
            self._cache.move_to_end(sig)
            for a, home in zip(arrays, prog.homes):
                self._bind(a, home)
            prog.arrays = arrays
        outs = prog(inputs, arrays, recording)
        ctx = inputs[0].context
        return _unflatten([o if isinstance(o, NDArray)
                           else NDArray._wrap(o, ctx) for o in outs],
                          prog.tree)

    def _graphs_on(self, device):
        if device not in self._graphs:
            self._graphs[device] = _graph_backend(device)
        return self._graphs[device]

    def _bind(self, arr, home=None):
        home, copied = arr._bind(home)
        self._param_copies += copied
        return home

    def _build(self, sig, inputs, arrays, homes):
        global _N_CACHED_PROGRAMS
        prog = _HybridProgram(self, sig, inputs, arrays, homes)
        _N_CACHED_PROGRAMS += 1
        self._cache[sig] = prog
        while len(self._cache) > self._cache_size:
            _old_sig, old = self._cache.popitem(last=False)
            old.close()
            self._n_evictions += 1
            if self._n_evictions in (1, 10, 100, 1000):
                warnings.warn(
                    f"CachedOp for {self._block.name!r}: "
                    f"{self._n_evictions} compiled-program eviction(s) — "
                    f"ragged input shapes are forcing recompiles.  "
                    f"Declare hybridize(bucket_shapes={{axis: [sizes]}}) "
                    f"to pad onto a fixed bucket set, or raise "
                    f"MXNET_CACHED_OP_CACHE_SIZE "
                    f"(now {self._cache_size}).", stacklevel=4)
        return prog

    def stats(self):
        """Programs, evictions, parameter copies of the binding check,
        replays, and each signature's capture seconds and pool bytes."""
        sigs = []
        for sig, prog in self._cache.items():
            insts = prog.instances()
            sigs.append(dict(
                inputs=[list(s[0]) for s in sig[0]], training=sig[2],
                instances=len(insts), replays=prog.replays,
                capture_s=sum(i.capture_s for i in insts),
                pool_bytes=sum(i.pool_bytes for i in insts)))
        return dict(programs=len(self._cache), evictions=self._n_evictions,
                    param_copies=self._param_copies,
                    replays=sum(s["replays"] for s in sigs),
                    signatures=sigs)
