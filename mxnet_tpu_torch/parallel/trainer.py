"""ShardedTrainer on one card: forward, backward and the optimizer update
of a block, step by step.

The PyTorch port of ``mxnet_tpu.parallel.ShardedTrainer`` at dp = 1.
The trainer holds its own copy of the block's parameters (cast to
``dtype`` where floating, as the JAX ``_own`` does), runs the block
through ``torch.func.functional_call`` — a Gluon block as a
:class:`.functional.GluonModule`, over ``functionalize`` — and updates
the trainable ones (``requires_grad``)
in place with the optimizers of :mod:`.optim`.  ``write_back()`` copies
the trained values, buffers included, into the block.

With ``graphs=True`` (the default) each batch signature (the shapes and
dtypes of the step's arrays) is one :class:`_StepProgram`, the
counterpart of the JAX trainer's one jitted step: on CUDA, forward,
backward and the optimizer update are captured as one CUDA graph that
every later step of the signature replays over static batch buffers.
``graphs=False`` launches every kernel from Python on each step; only a
caller that asks for it gets it, and nothing switches to it on a
failure.

In-place rule: ``params``, ``buffers`` and ``opt_state`` (the AdamW
step tensor included) keep their tensors, at their addresses, for the
trainer's life, because the graphs replay those addresses.  Whatever
sets new values into a trainer must ``copy_`` into them, never rebind
them: :meth:`.checkpoint.CheckpointManager.restore` does so.

Durability (the counterpart of the JAX trainer's watchdog): with
``step_timeout_ms`` or ``slow_step_factor`` (or their ``MXNET_TRAIN_*``
knobs) the step runs under ``self.watchdog``, a
:class:`~.supervisor.StepWatchdog`, on a deadline thread, and the
deadline covers the device's completion of the step, not only its
launch.  A restore bumps the trainer's generation; a step checks the
generation it started under right before it stages and replays (or
runs its eager update), under the trainer's lock, so a step abandoned
by the watchdog that wakes after a restore returns without touching the
restored state.

Multi-rank (SPMD, as the JAX multi-process path): over a mesh of an
initialized process group (:func:`.mesh.make_mesh` after
:func:`.dist.initialize`) every rank is given the same global batch and
:meth:`ShardedTrainer.shard_batch` keeps its own dp rows (a batch dp
does not divide is refused).  Parameters follow ``rules`` (default
:data:`.sharding.MEGATRON_RULES`, matched against the Gluon names of
the block's ``gluon_names()``): each rank holds its local shards as
plain tensors, and the block's layers bound to the tp group run the
Megatron collectives (``models.*.bind_tensor_parallel``), so flash
attention runs on the rank's ``heads / tp`` heads; a Gluon block's
``MoEFFN`` layers run their ``E / ep`` experts and route over the whole
dp batch (:mod:`.expert`).  The loss returned
is the global mean and the gradients the dp mean, all-reduced in
float32 buckets of at most 25 MiB over the dp group (floating
buffers, BatchNorm's running statistics, are averaged with them);
``collectives`` counts the dp collectives the host issued (a capture
issues a step's once; its replays issue none from the host).  On
an NCCL mesh those collectives are captured in the step's CUDA graph; a
gloo group cannot be captured, so ``graphs=True`` over gloo with CUDA
tensors raises :class:`MXNetError` (pass ``graphs=False``).

``compression='int8' | 'fp8' | spec`` (:mod:`..quantize`) replaces the
dp gradient mean by the quantized collective on a pure data-parallel
mesh: each rank error-feedback-quantizes its gradients (per-rank
float32 ``residuals``), all-gathers the payload and the per-block
scales, and dequantizes and sums in float32.  ``wire_bytes_per_step``
and ``logical_bytes_per_step`` account for it, and the
``kvstore.wire.bytes`` counter takes the wire bytes once per step.
Stochastic rounding draws from an explicit ``torch.Generator`` seeded
from the step counter, the dp rank and the parameter's index; the
counter is the trainer's :meth:`extra_state`.
"""
from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch
from torch.func import functional_call

from .. import engine as _engine
from .. import faults as _faults
from .. import perf_account as _pa
from .. import quantize as _qz
from .. import runtime_metrics as _rm
from ..base import KernelError, MXNetError
from . import optim as _optim
from .sharding import (MEGATRON_RULES, P, ShardingRules, TensorParallel,
                       all_reduce_, gather_params, local_shard)
from .supervisor import StepWatchdog

__all__ = ["ShardedTrainer"]

_LOG = logging.getLogger("mxnet_tpu_torch")

# the dp all-reduce's bucket size (float32 bytes), as DDP's default
_BUCKET_BYTES = 25 << 20

_OPTIMS = {
    "sgd": (_optim.sgd_init, _optim.sgd_update),
    "adamw": (_optim.adamw_init, _optim.adamw_update),
    "lamb": (_optim.lamb_init, _optim.lamb_update),
}


def _tensors(batch):
    """The step's arrays as tensors (a numpy array without a copy, an
    NDArray as its tensor where it lies: a batch already on the card
    does not go back through the host)."""
    from ..ndarray import NDArray
    out = []
    for b in batch:
        if isinstance(b, NDArray):
            b = b._data.detach()
        elif isinstance(b, np.ndarray):
            b = torch.from_numpy(b)
        elif not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b)
        out.append(b)
    return tuple(out)


def _signature(batch):
    """A batch's signature: each array's shape and dtype."""
    return tuple((tuple(b.shape), b.dtype) for b in batch)


class _StepProgram:
    """One batch signature of a graphs-mode :class:`ShardedTrainer`: the
    counterpart of the JAX trainer's jitted step for one input shape.

    The batch lives in ONE static device buffer (a view per array, each
    on a 16-byte boundary), staged from one packed host buffer (pinned)
    by one non-blocking copy; an array already on the card is copied
    into its view on the card.  Before the host buffer is written again
    the previous copy out of it must have finished (an event), so a
    step never waits for more than the copy of the step before.

    On CUDA the first step of the signature builds the program: the step
    runs eagerly on the trainer's stream (a real step, which also loads
    the kernel libraries and makes cuBLAS's workspaces on that stream),
    then the same step — forward, backward (B1-B3 included, B2 and B3
    launched by autograd on the capturing stream) and the optimizer's
    in-place update — is captured over the static buffers as one CUDA
    graph in the trainer's memory pool.  Capturing runs no kernel, so it
    changes no state.  Every later step stages its batch and replays the
    graph.  Both happen under the trainer's lock, and only if the
    trainer's generation is still the one the step began under (else the
    call returns None and touches nothing): a restore since then means
    the step was abandoned.
    The loss returned is a copy of the graph's static loss, so a later
    replay does not overwrite it.  The trainer's stream waits for the
    caller's stream before a step and the caller's stream for the
    trainer's after it, so work the caller queues before or after a
    step (a ``copy_`` into the parameters, reading the loss) is ordered
    with it without a host synchronisation.

    On the CPU every step stages into the static buffers and runs the
    step on them: the same data path without a graph.  A capture or
    replay that fails raises :class:`~mxnet_tpu_torch.base.KernelError`,
    and so does every later step of a signature whose capture failed;
    nothing runs the step another way.  A capture error comes after the
    signature's first step has run: that step's update (parameters,
    moments, step count) is applied and only its loss is lost, so a
    caller must not take the error for a step that did not happen and
    run the same batch again.
    """

    def __init__(self, trainer, signature):
        self.trainer = trainer
        self.device = trainer.device
        self.stream = trainer._stream
        cuda = self.device.type == "cuda"
        sizes = [int(np.prod(shape, dtype=np.int64))
                 * torch.empty((), dtype=dt).element_size()
                 for shape, dt in signature]
        offs = np.cumsum([0] + [-(-n // 16) * 16 for n in sizes]).tolist()

        def views(buf):
            return [buf[o:o + n].view(dt).view(shape)
                    for o, n, (shape, dt) in zip(offs, sizes, signature)]

        # every step overwrites the whole buffer before it is read; made
        # on the trainer's stream, which is the only one that uses it
        with self._on_stream():
            self._dev = torch.empty(offs[-1], dtype=torch.uint8,
                                    device=self.device)
        self.args = tuple(views(self._dev))
        self._host = self._host_args = self._copied = None
        if cuda:
            self._host = torch.empty(offs[-1], dtype=torch.uint8,
                                     pin_memory=True)
            self._host_args = views(self._host)
            self._copied = torch.cuda.Event()
        self.built = False              # captured (CUDA) / first run (CPU)
        self.capture_s = 0.0            # host seconds of the capture
        self.graph = None
        self.loss = None                # the graph's static loss
        self.replays = 0                # graph launches
        self.failed = None              # the capture's error, once raised

    def _on_stream(self):
        return torch.cuda.stream(self.stream) \
            if self.stream is not None else contextlib.nullcontext()

    def _stage(self, batch):
        if self._host is None:
            for view, b in zip(self.args, batch):
                view.copy_(b)
            return
        on_host = [i for i, b in enumerate(batch) if b.device.type == "cpu"]
        if on_host:
            self._copied.synchronize()
            for i in on_host:
                self._host_args[i].copy_(batch[i])
            self._dev.copy_(self._host, non_blocking=True)
            self._copied.record(self.stream)
        for view, b in zip(self.args, batch):
            if b.device.type != "cpu":
                view.copy_(b, non_blocking=True)
                b.record_stream(self.stream)

    def __call__(self, batch, generation):
        trainer = self.trainer
        if self.stream is None:
            with trainer._lock:
                if trainer._generation != generation:
                    return None
                self._stage(batch)
                self.built = True
                return trainer._train_step(self.args).clone()
        if self.failed is not None:
            raise KernelError(
                f"ShardedTrainer: the training step's CUDA graph for this "
                f"batch signature failed to capture: {self.failed}")
        caller = torch.cuda.current_stream(self.device)
        with trainer._lock:
            if trainer._generation != generation:
                return None
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                self._stage(batch)
                if self.graph is None:
                    loss = trainer._train_step(self.args).clone()
                    self._capture()
                else:
                    try:
                        self.graph.replay()
                    except Exception as e:
                        raise KernelError(
                            f"ShardedTrainer: replay of the training "
                            f"step's CUDA graph failed: {e}") from e
                    self.replays += 1
                    loss = self.loss.clone()
            loss.record_stream(caller)
            caller.wait_stream(self.stream)
        return loss

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.trainer._graph_pool,
                                  stream=self.stream,
                                  capture_error_mode="thread_local"):
                loss = self.trainer._train_step(self.args)
        except Exception as e:
            self.failed = e
            raise KernelError(
                f"ShardedTrainer: capture of the training step as a CUDA "
                f"graph failed: {e}") from e
        self.graph, self.loss, self.built = graph, loss, True
        self.capture_s = time.perf_counter() - t0


def _gluon_module(block, example_inputs, device):
    """A Gluon block as the trainer's ``nn.Module``
    (:class:`.functional.GluonModule`), its deferred shapes resolved on
    the example inputs placed on the trainer's device."""
    from ..context import context_of
    from ..ndarray import NDArray
    from .functional import GluonModule
    ctx = context_of(device)
    xs = [x if isinstance(x, NDArray) else NDArray(np.asarray(x), ctx=ctx)
          for x in example_inputs]
    return GluonModule(block, *xs)


class ShardedTrainer:
    """A training step for an ``nn.Module`` or a Gluon block on a
    :class:`Mesh`: one card, or this rank's part of a multi-rank mesh
    (module docstring).  A Gluon block (``gluon.Block``) is run as a
    :class:`.functional.GluonModule`: its parameters by their Gluon
    names, those with ``grad_req="null"`` (BatchNorm's running
    statistics) as buffers; ``write_back()`` copies into the block's
    arrays.

    ``loss_fn(outputs, *labels) -> scalar`` is written in torch over raw
    tensors.  ``step(*batch)`` takes the block's ``n_inputs =
    len(example_inputs)`` inputs followed by ``n_labels`` labels (numpy
    arrays or tensors), moves them to the mesh's device, and returns the
    loss tensor of that step (before the update).  ``example_inputs``
    only sets how many inputs the block takes: the port traces nothing.
    The inputs reach the block in the dtype the caller gives them.

    ``graphs=True`` (the default) runs each batch signature as a
    :class:`_StepProgram` (one CUDA graph on the card); at most
    ``program_bound`` signatures, beyond which a new one raises
    :class:`MXNetError` (bucket the batch shapes).  ``compiled`` counts
    the programs built and ``capture_seconds`` the host time of their
    captures.  All graphs of one trainer share one memory pool and the
    trainer's own stream: a step's graph leaves only its loss for the
    host, and that loss is copied out before any other replay.
    ``graphs=False`` runs each step eagerly on the caller's stream.

    ``step_timeout_ms`` / ``slow_step_factor`` (defaults from
    ``MXNET_TRAIN_STEP_TIMEOUT_MS`` / ``MXNET_TRAIN_SLOW_STEP_FACTOR``;
    both off = the step runs on the calling thread, no wrapper) set
    ``self.watchdog``.  A signature's first step runs under the same
    deadline and includes its capture, so a deadline must cover a
    capture.
    """

    def __init__(self, block, loss_fn, mesh, optimizer="adamw",
                 optimizer_params=None, rules=MEGATRON_RULES,
                 example_inputs=(), n_labels=1, dtype=None,
                 compression=None, graphs=True, program_bound=8,
                 step_timeout_ms=None, slow_step_factor=None):
        if optimizer not in _OPTIMS:
            raise MXNetError(f"unknown optimizer {optimizer!r}; "
                             f"known: {sorted(_OPTIMS)}")
        if not isinstance(rules, ShardingRules):
            raise MXNetError(f"ShardedTrainer: rules must be a "
                             f"parallel.ShardingRules, got "
                             f"{type(rules).__name__}")
        self.mesh = mesh
        self.device = mesh.device
        if not isinstance(block, torch.nn.Module):
            block = _gluon_module(block, example_inputs, self.device)
        self.block = block
        self.loss_fn = loss_fn
        self.compression = _qz.CompressionSpec.parse(compression)
        if self.compression is not None:
            if "dp" not in mesh.shape:
                raise MXNetError(
                    "ShardedTrainer(compression=...): mesh has no 'dp' "
                    "axis to compress gradients over")
            sharded_axes = [a for a, n in mesh.shape.items()
                            if a != "dp" and n > 1]
            if sharded_axes:
                raise MXNetError(
                    f"ShardedTrainer(compression=...) needs a pure "
                    f"data-parallel mesh: axes {sharded_axes} have size "
                    f"> 1, and quantized sync of tensor/pipeline-"
                    f"sharded gradients is not supported — drop "
                    f"compression or reshape the mesh to dp-only")
        cuda = self.device.type == "cuda"
        grouped = mesh.groups is not None
        if not grouped and any(int(n) > 1 for n in mesh.shape.values()):
            raise MXNetError(
                f"ShardedTrainer: mesh {mesh.shape} spans several devices "
                f"but has no process group; build it with "
                f"parallel.make_mesh after parallel.dist.initialize")
        if graphs and cuda and grouped and mesh.backend != "nccl":
            raise MXNetError(
                f"ShardedTrainer: graphs=True captures the step's "
                f"collectives in a CUDA graph, which a {mesh.backend} "
                f"group carrying CUDA tensors cannot be (its collectives "
                f"run on the host); pass graphs=False, or use an NCCL "
                f"mesh")
        if graphs and cuda and self.compression is not None \
                and self.compression.stochastic:
            raise MXNetError(
                "ShardedTrainer: stochastic rounding draws from a "
                "generator seeded on the host each step, which a "
                "captured step cannot replay; pass graphs=False")
        self.watchdog = StepWatchdog(timeout_ms=step_timeout_ms,
                                     slow_factor=slow_step_factor)
        # a restore bumps the generation under the lock; a step checks
        # it under the lock right before it touches state
        self._lock = _engine.make_lock("ShardedTrainer._lock")
        self._generation = 0
        # step-time attribution / MFU / bottleneck verdict — inert (one
        # attribute load + branch in step()) until MXNET_TRACE or
        # MXNET_RUNTIME_METRICS turns it on
        self.perf = _pa.StepAttribution()
        opt_init, self._opt_update = _OPTIMS[optimizer]
        opt_kw = dict(optimizer_params or {})
        if "learning_rate" in opt_kw:
            opt_kw["lr"] = opt_kw.pop("learning_rate")
        if "weight_decay" in opt_kw:            # Gluon naming -> optim's
            opt_kw["wd"] = opt_kw.pop("weight_decay")
        self._opt_kw = opt_kw

        # placements by the Gluon names the rules match (a block without
        # gluon_names() is matched by its torch names)
        named = dict(block.named_parameters())
        gluon = {id(t): n for n, t in getattr(
            block, "gluon_names", dict)().items()}
        self.placements = {
            n: rules.safe_spec(mesh, gluon.get(id(p), n), tuple(p.shape))
            for n, p in named.items()}
        self._full_shapes = {n: tuple(p.shape) for n, p in named.items()}

        def own(t, spec=P()):
            t = local_shard(t.detach(), spec, mesh)
            if dtype is not None and t.is_floating_point():
                return t.to(self.device, dtype, copy=True)
            return t.to(self.device, copy=True)

        self.trainable = frozenset(n for n, p in named.items()
                                   if p.requires_grad)
        self.params = {n: own(p, self.placements[n]).requires_grad_(
            n in self.trainable) for n, p in named.items()}
        self.buffers = {n: own(b) for n, b in block.named_buffers()}
        self._train_params = {n: p for n, p in self.params.items()
                              if n in self.trainable}
        self.opt_state = opt_init(self._train_params)
        self._tp_bound = self._bind_tensor_parallel(named)
        self._n_inputs = len(example_inputs)
        self._n_labels = int(n_labels)
        self._dp = int(mesh.shape.get("dp", 1))
        self._dp_group = mesh.group("dp") if grouped else None
        self._buckets = self._make_buckets()
        self.collectives = 0            # dp collectives issued (host)
        self._setup_compression()
        self.graphs = bool(graphs)
        self.program_bound = int(program_bound)
        self.compiled = 0               # programs built in this process
        self.capture_seconds = 0.0      # host time those captures took
        self._programs = {}             # batch signature -> _StepProgram
        self._flops = {}                # batch signature -> step FLOPs
        self._stream = torch.cuda.Stream(self.device) \
            if self.graphs and cuda else None
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self._stream is not None else None

    # ------------------------------------------------------ multi-rank
    def _bind_tensor_parallel(self, named):
        """The block's layers bound to the mesh: ``[(module, binding)]``
        from each module's ``bind_tensor_parallel`` (the transformer
        layers' tp, a Gluon block's ``MoEFFN`` layers' ep, tp and dp
        routing: :mod:`.expert`).  A
        parameter placed across a mesh axis of size > 1 that no layer
        runs split raises: nothing computes on a shard as if it were the
        whole."""
        mesh = self.mesh
        split = {n for n, spec in self.placements.items()
                 if any(a is not None and mesh.shape[a] > 1 for a in spec)}
        # an expert-parallel layer routes over the whole dp batch even
        # when nothing is split
        if not split and (mesh.groups is None or mesh.shape["dp"] == 1):
            return []
        # the layers see only the axes that split (size > 1)
        spec_of_id = {id(p): P(*[a if a is not None and mesh.shape[a] > 1
                                 else None for a in self.placements[n]])
                      for n, p in named.items()}
        tp = TensorParallel(mesh.group("tp"), mesh.shape["tp"],
                            mesh.coords["tp"],
                            lambda p: spec_of_id.get(id(p), P()), mesh=mesh)
        bound, claimed = [], set()
        for module in self.block.modules():
            bind = getattr(module, "bind_tensor_parallel", None)
            if bind is None:
                continue
            binding, params = bind(tp)
            if binding is not None:
                bound.append((module, binding))
                claimed |= {id(p) for p in params}
        unclaimed = sorted(n for n in split if id(named[n]) not in claimed)
        if unclaimed:
            raise MXNetError(
                f"ShardedTrainer: the rules split {unclaimed[:4]} "
                f"({[self.placements[n] for n in unclaimed[:4]]}) but no "
                f"layer of the block runs them split; only the "
                f"transformer layers' tensor parallelism and MoEFFN's "
                f"expert parallelism are ported")
        return bound

    @contextlib.contextmanager
    def _tensor_parallel(self):
        """The tp bindings set on their layers for one forward."""
        for module, binding in self._tp_bound:
            module._tp = binding
        try:
            yield
        finally:
            for module, _ in self._tp_bound:
                module._tp = None

    def _make_buckets(self):
        """The dp all-reduce's buckets: trainable parameter names in
        order, each bucket at most ``_BUCKET_BYTES`` of float32."""
        if self._dp_group is None:
            return []
        buckets, cur, size = [], [], 0
        for n in self._train_params:
            nbytes = 4 * self._train_params[n].numel()
            if cur and size + nbytes > _BUCKET_BYTES:
                buckets.append(cur)
                cur, size = [], 0
            cur.append(n)
            size += nbytes
        if cur:
            buckets.append(cur)
        return buckets

    def _setup_compression(self):
        spec = self.compression
        self.residuals = {}
        self._quant_step = 0
        self.wire_bytes_per_step = self.logical_bytes_per_step = 0
        if spec is None:
            return
        # per-rank float32 rounding error of every trainable floating
        # parameter (the EF accumulate-wide rule)
        self._comp_names = tuple(
            n for n, p in self._train_params.items()
            if p.is_floating_point())
        self.residuals = {
            n: torch.zeros(self.params[n].shape, dtype=torch.float32,
                           device=self.device) for n in self._comp_names}
        comp = set(self._comp_names)
        self._buckets = [[n for n in b if n not in comp]
                         for b in self._buckets]
        self._buckets = [b for b in self._buckets if b]
        self._quant_gen = torch.Generator(self.device) \
            if spec.stochastic else None
        # each of the dp ranks transmits its compressed contribution per
        # step (vs the payload the uncompressed all-reduce would move)
        sizes = [self.params[n].numel() for n in self._comp_names]
        self.wire_bytes_per_step = self._dp * sum(
            _qz.wire_bytes(n, spec) for n in sizes)
        self.logical_bytes_per_step = self._dp * sum(
            _qz.logical_bytes(k, self.params[n].dtype)
            for k, n in zip(sizes, self._comp_names))

    def shard_batch(self, *arrays):
        """This rank's dp rows of each array of a global batch (every
        rank is given the same batch); a batch dp does not divide raises.
        Without a process group the arrays come back as tensors."""
        arrays = _tensors(arrays)
        if self._dp == 1:
            return arrays
        c = self.mesh.coords["dp"]
        out = []
        for a in arrays:
            if a.dim() == 0 or a.shape[0] % self._dp:
                raise MXNetError(
                    f"ShardedTrainer.shard_batch: batch dim "
                    f"{tuple(a.shape)[:1]} is not divisible by dp="
                    f"{self._dp}")
            rows = a.shape[0] // self._dp
            out.append(a[c * rows:(c + 1) * rows])
        return tuple(out)

    def _reduce(self, loss, grads):
        """The dp reduction of one step, in place where it can: the loss
        and the gradients become their dp means (float32 buckets over the
        dp group, or the quantized collective), floating buffers their dp
        mean.  Without a process group only a compressed trainer's
        quantization runs (a dp of one, as the JAX trainer's)."""
        group = self._dp_group
        if self.compression is not None:
            self._reduce_compressed(grads, group)
        if group is None:
            return loss
        n = float(self._dp)
        loss = loss.reshape(1).to(torch.float32)
        for i, bucket in enumerate(self._buckets or [[]]):
            parts = [grads[k].reshape(-1).to(torch.float32) for k in bucket]
            if i == 0:
                parts.insert(0, loss)
            flat = torch.cat(parts)
            all_reduce_(flat, group).div_(n)
            self.collectives += 1
            off = 1 if i == 0 else 0
            if i == 0:
                loss = flat[:1]
            for k in bucket:
                g = grads[k]
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        floating = [b for b in self.buffers.values() if b.is_floating_point()]
        if floating and self._dp > 1:
            flat = torch.cat([b.reshape(-1).to(torch.float32)
                              for b in floating])
            all_reduce_(flat, group).div_(n)
            self.collectives += 1
            off = 0
            for b in floating:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
        return loss.reshape(())

    def _reduce_compressed(self, grads, group):
        spec, gen = self.compression, self._quant_gen
        keys = None
        if gen is not None:
            base = (self._quant_step + 1) * 1_000_003 \
                + self.mesh.coords["dp"]
            keys = [(gen, (base * 65_537 + i) % (1 << 62))
                    for i in range(len(self._comp_names))]
        means, residuals = _qz.allreduce_mean_many(
            [grads[k] for k in self._comp_names],
            [self.residuals[k] for k in self._comp_names], spec, group,
            keys=keys)
        if group is not None:
            self.collectives += 2       # payloads, scales
        for k, m, r in zip(self._comp_names, means, residuals):
            grads[k].copy_(m)
            self.residuals[k].copy_(r)

    def gathered_params(self):
        """The full parameters ``{name: tensor}`` (a collective over the
        mesh: every rank calls it)."""
        if self.mesh.groups is None:
            return {n: p.detach() for n, p in self.params.items()}
        return gather_params(self.params, self.placements, self.mesh)

    # ------------------------------------------------------------ steps
    def _to_device(self, batch):
        return tuple(b.to(self.device, non_blocking=True) for b in batch)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _loss_and_grads(self, params, buffers, batch):
        """Loss and gradients of the trainable entries of ``params``
        (with ``buffers``) on ``batch``; the block runs in train mode
        (dropout on) and is left as it was."""
        inputs = batch[:self._n_inputs]
        labels = batch[self._n_inputs:]
        was_training = self.block.training
        self.block.train(True)
        try:
            with self._tensor_parallel():
                out = functional_call(self.block, (params, buffers), inputs)
            loss = self.loss_fn(out, *labels)
        finally:
            self.block.train(was_training)
        names = [n for n in params if n in self.trainable]
        grads = torch.autograd.grad(
            loss, [params[n] for n in names], allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        return loss.detach(), {
            n: torch.zeros_like(params[n]) if g is None else g
            for n, g in zip(names, grads)}

    def _forward_backward(self, batch):
        return self._loss_and_grads(self.params, self.buffers, batch)

    def _update(self, grads):
        self._opt_update(self._train_params, grads, self.opt_state,
                         **self._opt_kw)

    def _train_step(self, batch):
        """Forward, backward, the dp reduction and the in-place update on
        device arrays: the work one CUDA graph captures.  Returns the
        loss (the global mean)."""
        loss, grads = self._forward_backward(batch)
        loss = self._reduce(loss, grads)
        self._update(grads)
        return loss

    def _program(self, batch):
        sig = _signature(batch)
        prog = self._programs.get(sig)
        if prog is None:
            if len(self._programs) >= self.program_bound:
                raise MXNetError(
                    f"ShardedTrainer: batch signature {sig} would be "
                    f"program {len(self._programs) + 1}, over "
                    f"program_bound={self.program_bound}; bucket the "
                    f"batch shapes or raise the bound")
            prog = self._programs[sig] = _StepProgram(self, sig)
        return prog

    def step(self, *batch):
        """One training step; returns the loss tensor of this step.

        ``faults.inject("train.step")`` is the chaos hook of the whole
        step, fired at its entry.  With tracing or runtime metrics on,
        the step runs attributed (:meth:`_step_attributed`, eager): each
        phase is timed into a ``train.*`` span and closed by a device
        synchronisation.  Otherwise, with ``graphs=True`` the step runs
        its signature's :class:`_StepProgram` (a replayed CUDA graph on
        the card), and with ``graphs=False`` eagerly.  A
        :class:`KernelError` raised by a signature's first step on the
        card comes from its capture, after the step's update was
        applied: do not run that batch again as a retry.

        Under an active watchdog the step runs on the deadline thread,
        inside the caller's current stream (a thread's current stream
        is its own, so the caller's is entered there), and the deadline
        covers the device: the thread waits on an event recorded after
        the step's work (the replay on the trainer's stream, which the
        caller's stream waits for, or the eager launches).  A wedged
        step raises :class:`~.supervisor.TrainStepTimeoutError`.  The
        step records the trainer's generation when it is called; if a
        restore has bumped it by the time the step reaches its state
        (under the trainer's lock, right before staging and the replay
        or the eager update), the step returns None and changes
        nothing."""
        if len(batch) != self._n_inputs + self._n_labels:
            raise MXNetError(
                f"ShardedTrainer.step: expected {self._n_inputs} inputs + "
                f"{self._n_labels} labels, got {len(batch)} arrays")
        batch = self.shard_batch(*batch)
        generation = self._generation
        if not self.watchdog.active:
            loss = self._run_step(batch, generation)
        else:
            caller = torch.cuda.current_stream(self.device) \
                if self.device.type == "cuda" else None
            loss = self.watchdog.watch(
                lambda: self._watched_step(batch, generation, caller))
        if loss is not None and self.compression is not None:
            self._quant_step += 1
            if _rm._ENABLED:
                _rm.KV_WIRE_BYTES.inc(self.wire_bytes_per_step)
        return loss

    def _watched_step(self, batch, generation, caller):
        """The step on the watchdog's thread, to the device's
        completion."""
        if caller is None:
            return self._run_step(batch, generation)
        with torch.cuda.stream(caller):
            loss = self._run_step(batch, generation)
            done = torch.cuda.Event()
            done.record(caller)
        done.synchronize()
        return loss

    def _run_step(self, batch, generation):
        # the fault hook stays outside the lock: a stalled step must
        # not block the restore that abandons it
        _faults.inject("train.step")
        if self.perf.active:
            return self._step_attributed(batch, generation)
        if not self.graphs:
            with self._lock:
                if self._generation != generation:
                    return None
                return self._train_step(self._to_device(batch))
        prog = self._program(batch)
        was_built = prog.built
        loss = prog(batch, generation)
        if not was_built and prog.built:
            self.compiled += 1
            self.capture_seconds += prog.capture_s
        return loss

    def bump_generation(self):
        """Invalidate every step begun before this call (a restore calls
        it before it copies state in): such a step returns None at its
        generation check without touching state.  A step already past
        the check has queued its work on the trainer's stream; the
        caller's current stream waits for that stream here, so what the
        caller queues next (the restore's copies) lands after it.
        Returns the new generation."""
        with self._lock:
            self._generation += 1
            if self._stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(
                    self._stream)
            return self._generation

    def extra_state(self):
        """Step state that is not a tensor, for a checkpoint's extra
        payload: the quantized collective's step counter, which seeds
        stochastic rounding (empty without compression).  The residuals
        are tensors and travel with the parameters."""
        if self.compression is not None:
            return {"quant_step": int(self._quant_step)}
        return {}

    def set_extra_state(self, state):
        """Take :meth:`extra_state`'s payload back."""
        if self.compression is not None and state \
                and "quant_step" in state:
            self._quant_step = int(state["quant_step"])

    def _step_attributed(self, batch, generation):
        """The observed variant of :meth:`step`: ``train.h2d``,
        ``train.compute`` (forward + backward) and ``train.optimizer``
        tile the ``train.step`` span, each ending in a device
        synchronisation; ``train.collective`` is a zero-length marker
        (one card).  It runs eagerly in both modes: a graph replays the
        three phases as one launch, which cannot be split by
        synchronisations."""
        if _rm._ENABLED:
            self.perf.note_flops(self.step_flops(*batch))
        with self._lock:
            if self._generation != generation:
                return None
            h = self.perf.step_start()
            with h:
                t0 = time.perf_counter()
                dev_batch = self._to_device(batch)
                self._sync()
                t1 = time.perf_counter()
                h.record("h2d", t0, t1)
                loss, grads = self._forward_backward(dev_batch)
                self._sync()
                t2 = time.perf_counter()
                h.record("compute", t1, t2)
                if self._dp_group is None:
                    h.mark("collective", devices=1)
                else:
                    loss = self._reduce(loss, grads)
                    self._sync()
                    t3 = time.perf_counter()
                    h.record("collective", t2, t3, devices=self.mesh.size,
                             wire_bytes=self.wire_bytes_per_step,
                             logical_bytes=self.logical_bytes_per_step)
                    t2 = t3
                self._update(grads)
                self._sync()
                h.record("optimizer", t2, time.perf_counter())
        return loss

    def step_flops(self, *batch):
        """Model FLOPs of one training step on ``batch``, counted from the
        step this trainer runs, as the JAX package counts its compiled
        step with XLA's cost analysis.

        The step's forward, loss and backward run once on the meta
        device (shapes only: the weights are not copied and nothing is
        computed) under ``torch.utils.flop_counter.FlopCounterMode``,
        which counts every matrix product (linear, matmul, bmm,
        convolution) at the shapes the step gives it: the MLM decoder at
        the masked positions only, the embeddings as the lookups they
        are.  Flash attention's kernels are opaque to the counter, so on
        meta its autograd Function runs the model's dense products of
        each call (``ops.flash_attention._meta_products``): 4 * BH * L^2
        * D FLOPs for each of B1, B2 and B3, the dense attention path's
        count, with neither the kernels' recomputation of S and dP nor
        the tiles a mask lets them skip.  Elementwise work and the
        optimizer update are not counted.  Counted once per batch
        signature; None where the block cannot run on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode

        sig = _signature(_tensors(batch))
        if sig not in self._flops:
            def meta(t):
                return torch.empty_like(t, device="meta").requires_grad_(
                    t.requires_grad)

            # the full parameters and no tp binding: the step's model
            # FLOPs over this rank's batch rows
            params = {n: torch.empty(self._full_shapes[n], dtype=p.dtype,
                                     device="meta").requires_grad_(
                                         p.requires_grad)
                      for n, p in self.params.items()}
            bound, self._tp_bound = self._tp_bound, []
            buffers = {n: meta(b) for n, b in self.buffers.items()}
            args = tuple(torch.empty(shape, dtype=dt, device="meta")
                         for shape, dt in sig)
            counter = FlopCounterMode(display=False)
            try:
                with counter:
                    self._loss_and_grads(params, buffers, args)
            except (NotImplementedError, RuntimeError) as e:
                _LOG.warning("ShardedTrainer.step_flops: the step does "
                             "not run on the meta device (%s); no FLOP "
                             "count", e)
                self._flops[sig] = None
            else:
                self._flops[sig] = float(counter.get_total_flops())
            finally:
                self._tp_bound = bound
        return self._flops[sig]

    def write_back(self):
        """Copy the trained parameters (gathered from their shards: a
        collective on a multi-rank mesh), and the buffers the steps
        updated (BatchNorm running statistics), back into the block (in
        the block's own dtypes)."""
        full = self.gathered_params()
        with torch.no_grad():
            for n, p in self.block.named_parameters():
                p.copy_(full[n])
            for n, b in self.block.named_buffers():
                b.copy_(self.buffers[n])
