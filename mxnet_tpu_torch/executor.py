"""Symbolic executor: bind / simple_bind, forward and backward over a
bound Symbol (reference: ``src/executor/graph_executor.cc``,
``python/mxnet/executor.py``).

The counterpart of ``mxnet_tpu.executor``, which compiles one XLA
program per ``(signature, train)`` for the forward and one per signature
for the backward.  Here a program runs the graph's interpretation
(``Symbol._interpret``) over static buffers: the bound arrays
themselves.  ``forward(**kwargs)`` copies into the bound array and never
rebinds it, and a value replaced since the last call (an initializer, an
optimizer's update, ``set_params``) is copied back into the bound tensor
first (``NDArray._bind``), so a program always reads the same addresses.

On the card a program is CUDA graphs, built on ``gluon.cached_op``'s
capture machinery (``_graph_backend``): one stream and one memory pool a
program.  A program's first call runs eagerly on its stream (a real
call, which also loads the kernel libraries), and the forward graph is
captured after it; later calls replay it.  A training forward's graph
keeps autograd's saved tensors in the program's pool.  The backward is
built at the first ``backward()`` of the training program: that call
takes ``torch.autograd.grad`` eagerly (over the first call's graph, or
the captured one after a replay), and then a backward graph is captured
over the forward graph's saved tensors: ``torch.autograd.grad`` of the
outputs with respect to the arguments whose ``grad_req`` is not
``"null"``, from static head-gradient buffers, written (``"write"``) or
added (``"add"``) into the bound gradient arrays inside the graph.  In
training, BatchNorm's moving statistics are written into the bound
auxiliary arrays in place, inside the forward graph (the op's
``aux_update`` hook).  Dropout's backward comes from the forward's own
saved graph, so the masks agree; a replayed forward draws anew from the
device's generator.  On the CPU the same static-buffer path runs
without graphs.

``num_compiles`` counts programs as the JAX package does: one forward a
``(signature, train)`` and one backward a signature.  A capture or
replay that fails raises :class:`~mxnet_tpu_torch.base.KernelError`, on
that call and on every later call of its program; nothing runs the
graph another way.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .base import KernelError, MXNetError
from . import ndarray as nd
from .gluon.cached_op import _as_is, _graph_backend
from .ndarray import NDArray
from .ndarray.ndarray import count_write

__all__ = ["Executor"]


def _write(arr: NDArray, value):
    """Copy ``value`` into ``arr``'s tensor in place (its bound buffer
    when it is bound)."""
    src = value._data if isinstance(value, NDArray) else value
    if not isinstance(src, torch.Tensor):
        src = torch.tensor(np.asarray(src))
    arr._before_write()
    dst = arr._data
    with torch.no_grad():
        dst.copy_(src)
    if arr._home is not None and dst is arr._home:
        count_write(dst)


class _Program:
    """A forward program of an executor (for training or inference) and,
    in training, its backward (module docstring)."""

    def __init__(self, ex, train, device):
        self.ex = ex
        self.train = train
        self.graphs = _graph_backend(device)
        self.pool = self.graphs.pool() if self.graphs is not None else None
        self.fwd = self.bwd = None      # CUDA graphs
        self.outs = None                # the captured forward's outputs
        self.leaves = None              # ... and its differentiated args
        self.grad_outs = None           # static head gradients
        self.root_idx = ()              # outputs that carry a gradient
        self.failed = None
        self.capture_s = 0.0

    # -- the graph's interpretation over the bound buffers -----------------
    def run(self):
        """The symbol over the bound tensors: (outputs, leaves).  Each
        differentiated argument enters as a leaf over its buffer's
        memory; the moving statistics are written into the auxiliary
        buffers."""
        ex = self.ex
        feed, leaves = {}, []
        for name in ex._arg_names:
            home = ex._arg_homes[name]
            if self.train and name in ex._diff:
                leaf = home.detach().requires_grad_(True)
                leaves.append(leaf)
                feed[name] = leaf
            else:
                feed[name] = home
        feed.update(ex._aux_homes)
        aux_up = {} if self.train else None
        with _as_is(), torch.set_grad_enabled(bool(leaves)):
            outs = ex._symbol._interpret(feed, train=self.train,
                                         aux_updates=aux_up)
        if aux_up:
            with torch.no_grad():
                for name, val in aux_up.items():
                    if name in ex._aux_homes:
                        ex._aux_homes[name].copy_(val)
        return outs, leaves

    def gradients(self, outs, leaves, cots):
        """The leaves' gradients from the outputs' cotangents, written
        into the bound gradient arrays per ``grad_req``."""
        ex = self.ex
        roots = [outs[i] for i in self.root_idx]
        grads = [None] * len(leaves)
        if roots and leaves:
            grads = torch.autograd.grad(
                roots, leaves, [cots[i] for i in self.root_idx],
                retain_graph=True, allow_unused=True)
        with torch.no_grad():
            for name, g in zip(ex._diff, grads):
                home = ex._grad_homes[name]
                if ex._grad_req[name] == "add":
                    if g is not None:
                        home.add_(g)
                elif g is None:
                    home.zero_()
                else:
                    home.copy_(g)

    # -- CUDA graphs ----------------------------------------------------------
    def _error(self, what, e):
        self.failed = e
        return KernelError(
            f"Executor: {what} of the CUDA graph of the "
            f"{'training' if self.train else 'inference'} program failed "
            f"(a host read inside an op, such as asnumpy or CTC's tolist, "
            f"cannot be captured): {e}")

    def _check(self):
        if self.failed is not None:
            raise KernelError(
                f"Executor: the CUDA graph of this "
                f"{'training' if self.train else 'inference'} program "
                f"failed earlier: {self.failed}")

    def _replay(self, graph):
        try:
            graph.replay()
        except Exception as e:
            raise self._error("replay", e) from e

    def _capture(self, fn):
        t0 = time.perf_counter()
        try:
            graph, out = self.graphs.capture(fn, self.pool)
        except Exception as e:
            raise self._error("capture", e) from e
        self.capture_s += time.perf_counter() - t0
        return graph, out

    # -- calls ----------------------------------------------------------------
    def forward(self):
        """Run the forward: (output copies, the autograd state the
        backward reads: (outputs, leaves) or None for a replay)."""
        self._check()
        if self.graphs is None:
            outs, leaves = self.run()
            self.root_idx = tuple(i for i, o in enumerate(outs)
                                  if o.requires_grad)
            return [o.detach() for o in outs], (outs, leaves)
        if self.fwd is None:
            with self.graphs.on_stream() as caller:
                outs, leaves = self.run()
                self.root_idx = tuple(i for i, o in enumerate(outs)
                                      if o.requires_grad)
                self.fwd, (self.outs, self.leaves) = self._capture(self.run)
            for o in outs:
                o.record_stream(caller)
            return [o.detach() for o in outs], (outs, leaves)
        with self.graphs.on_stream() as caller:
            self._replay(self.fwd)
            outs = [o.detach().clone() for o in self.outs]
        for o in outs:
            o.record_stream(caller)
        return outs, None

    def backward(self, state, cots):
        """Write the gradients of the forward that left ``state`` (None:
        a replay of the captured forward)."""
        self._check()
        if self.graphs is None:
            self.gradients(*state, cots)
            return
        with self.graphs.on_stream():
            if state is not None or self.bwd is None:
                # the first backward: eager over the forward that ran,
                # then the backward graph over the captured forward
                outs, leaves = state if state is not None \
                    else (self.outs, self.leaves)
                self.gradients(outs, leaves, cots)
                if self.bwd is None:
                    self.grad_outs = [torch.zeros_like(o)
                                      for o in self.outs]
                    self.bwd, _ = self._capture(lambda: self.gradients(
                        self.outs, self.leaves, self.grad_outs))
                return
            with torch.no_grad():
                for buf, c in zip(self.grad_outs, cots):
                    buf.copy_(c)
            self._replay(self.bwd)


class Executor:
    """Runs a Symbol graph over bound argument and auxiliary arrays
    (module docstring).

    args       : dict name -> NDArray, or a list in ``list_arguments()``
                 order
    args_grad  : the same container; receives the gradients
    grad_req   : 'write' | 'add' | 'null', or a dict / list per argument
    aux_states : dict / list of the auxiliary (non-differentiable) states
    """

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx
        # the reference's manual model parallelism (AttrScope ctx_group +
        # bind(group2ctx)): kept as metadata, one card runs the graph
        self._group2ctx = dict(group2ctx or {})
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self.arg_dict: Dict[str, NDArray] = _as_dict(args, arg_names, "args")
        self.aux_dict: Dict[str, NDArray] = _as_dict(
            aux_states or {}, aux_names, "aux_states")
        missing = [n for n in arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null") for n in arg_names}

        self.grad_dict: Dict[str, NDArray] = {}
        if args_grad is not None:
            self.grad_dict = _as_dict(args_grad, arg_names, "args_grad")
        for n, req in self._grad_req.items():
            if req not in ("write", "add", "null"):
                raise MXNetError(f"invalid grad_req {req!r} for {n!r}")
            if req != "null" and n not in self.grad_dict:
                self.grad_dict[n] = nd.zeros_like(self.arg_dict[n])
        self._arg_names = arg_names
        # the differentiated arguments, in list_arguments() order
        self._diff = [n for n in arg_names if self._grad_req[n] != "null"]

        self.outputs: List[NDArray] = []
        self._programs: Dict[bool, _Program] = {}
        self._last = None               # (program, autograd state)
        self._has_bwd = False
        self._arg_homes: Dict[str, torch.Tensor] = {}
        self._aux_homes: Dict[str, torch.Tensor] = {}
        self._grad_homes: Dict[str, torch.Tensor] = {}
        self.num_compiles = 0

    # ------------------------------------------------------------ properties
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n)
                for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n]
                for n in self._symbol.list_auxiliary_states()]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    # ------------------------------------------------------------ buffers
    @staticmethod
    def _bind(arrays, homes):
        """Each array keeps its value in its bound tensor (a replaced
        value is copied in)."""
        for name, arr in arrays.items():
            homes[name] = arr._bind(homes.get(name))[0]

    # -------------------------------------------------------------- forward
    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns ``self.outputs``.  ``kwargs`` are copied
        into the bound argument arrays by name."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k!r}")
            dst = self.arg_dict[k]
            if tuple(v.shape) != tuple(dst.shape):
                raise MXNetError(
                    f"forward: shape mismatch for {k!r}: got "
                    f"{tuple(v.shape)}, bound {dst.shape} (use "
                    f"Executor.reshape / a BucketingModule for new shapes)")
        self._bind(self.arg_dict, self._arg_homes)
        self._bind(self.aux_dict, self._aux_homes)
        for k, v in kwargs.items():
            _write(self.arg_dict[k], v)
        train = bool(is_train)
        prog = self._programs.get(train)
        if prog is None:
            device = next(iter(self._arg_homes.values())).device \
                if self._arg_homes else torch.device("cpu")
            prog = _Program(self, train, device)
            self._programs[train] = prog
            self.num_compiles += 1
        self._last = None
        outs, state = prog.forward()
        self._last = (prog, state)
        self.outputs = [NDArray._wrap(o, self._ctx) for o in outs]
        return self.outputs

    # ------------------------------------------------------------- backward
    def backward(self, out_grads=None):
        """Gradients of the outputs with respect to the arguments whose
        ``grad_req`` is not ``"null"``.  ``out_grads=None`` is ones for
        every output (SoftmaxOutput and make_loss ignore it anyway)."""
        if self._last is None:
            raise MXNetError("backward called before forward")
        prog, state = self._last
        if not prog.train:
            raise MXNetError("backward requires forward(is_train=True)")
        if not self._diff:
            return
        if out_grads is None:
            cots = [torch.ones_like(o._data) for o in self.outputs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [g._data if isinstance(g, NDArray)
                    else torch.as_tensor(np.asarray(g)) for g in out_grads]
            cots = [c.to(o._data.device, o._data.dtype)
                    for c, o in zip(cots, self.outputs)]
        self._bind({n: self.grad_dict[n] for n in self._diff},
                   self._grad_homes)
        if not self._has_bwd:
            self._has_bwd = True
            self.num_compiles += 1
        prog.backward(state, cots)

    # ------------------------------------------------------------- utility
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays."""
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                if tuple(arr.shape) != tuple(self.arg_dict[name].shape):
                    raise MXNetError(
                        f"copy_params_from: shape mismatch for {name!r}: "
                        f"{arr.shape} vs bound {self.arg_dict[name].shape}")
                _write(self.arg_dict[name], arr)
            elif not allow_extra_params:
                raise MXNetError(f"unknown parameter {name!r}")
        if aux_params:
            for name, arr in aux_params.items():
                if name in self.aux_dict:
                    _write(self.aux_dict[name], arr)
                elif not allow_extra_params:
                    raise MXNetError(f"unknown aux state {name!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound with new shapes: arrays of changed shapes
        are made anew, the others shared; its programs are its own."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def keep_or_new(cur, shape):
            if tuple(cur.shape) == tuple(shape):
                return cur
            return nd.zeros(shape, ctx=cur.context,
                            dtype=nd.dtype_name(cur._data.dtype))

        args = {n: keep_or_new(self.arg_dict[n], s) for n, s in
                zip(self._symbol.list_arguments(), arg_shapes)}
        aux = {n: keep_or_new(self.aux_dict[n], s) for n, s in
               zip(self._symbol.list_auxiliary_states(), aux_shapes)}
        grads = None
        if self.grad_dict:
            grads = {n: (g if tuple(g.shape) == tuple(args[n].shape)
                         else nd.zeros_like(args[n]))
                     for n, g in self.grad_dict.items()}
        return Executor(self._symbol, self._ctx, args, grads,
                        self._grad_req, aux)


def _as_dict(container, names, what) -> Dict[str, NDArray]:
    if isinstance(container, dict):
        return dict(container)
    if isinstance(container, (list, tuple)):
        if len(container) != len(names):
            raise MXNetError(
                f"{what}: expected {len(names)} arrays ({names}), "
                f"got {len(container)}")
        return dict(zip(names, container))
    raise MXNetError(f"{what} must be a dict or list of NDArray")
