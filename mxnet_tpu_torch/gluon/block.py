"""Block and HybridBlock of the PyTorch port (reference:
``python/mxnet/gluon/block.py``).

The counterpart of ``mxnet_tpu.gluon.block``: name scopes and
prefixes, child and parameter registration, ``collect_params`` (with
``select``), ``save_parameters`` / ``load_parameters``, ``summary`` and
forward hooks.  A HybridBlock's ``hybrid_forward(F, x, ...)`` receives
the ``nd`` namespace as ``F`` and its registered parameters as keyword
arrays.  After ``hybridize()`` a call with NDArray arguments and no
keyword arguments goes through the block's
:class:`~mxnet_tpu_torch.gluon.cached_op.CachedOp`: one set of CUDA
graphs per signature on the card.  Called with Symbols, a HybridBlock
composes a graph: ``hybrid_forward(mx.sym, x, ...)`` with its
parameters' variables (``Parameter.var``); ``export`` writes that graph
and the parameters (``path-symbol.json``, ``path-0000.params``), and
:class:`SymbolBlock` runs a graph as a block (through its CachedOp when
hybridized).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import torch

from ..base import MXNetError
from ..context import cpu, current_context
from .. import ndarray as nd
from ..ndarray import NDArray
from .cached_op import _TRACING, CachedOp, nb_cached_programs
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, match_names)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp",
           "nb_cached_programs"]


class _BlockScope(threading.local):
    """Name manager: per-process counters of block prefixes."""

    def __init__(self):
        self._current = None
        self._counters = {}

    def create(self, prefix, params, hint):
        current = self._current
        if current is None:
            if prefix is None:
                count = self._counters.get(hint, 0)
                self._counters[hint] = count + 1
                prefix = f"{hint}{count}_"
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._block._scope_counters.get(hint, 0)
            current._block._scope_counters[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params


_SCOPE = _BlockScope()


class _NameScope:
    def __init__(self, block):
        self._block = block
        self._old = None

    def __enter__(self):
        self._old = _SCOPE._current
        _SCOPE._current = self
        return self

    def __exit__(self, *exc):
        _SCOPE._current = self._old
        return False


def update_aux_state(param: Parameter, new_value, ctx=None):
    """Write an auxiliary (non-differentiable) state such as BatchNorm's
    running statistics, outside the tape and in place: a CUDA graph
    reads and writes it by address."""
    data = new_value._data if isinstance(new_value, NDArray) else new_value
    with torch.no_grad():
        for c, arr in param._data.items():
            if ctx is None or c == ctx:
                arr._data.copy_(data.detach())


def _resolve_shapes(block, inputs, train_mode):
    """One eager pass over ``inputs`` when a parameter of ``block`` waits
    for its shape, only then (``FusedTrainStep`` and
    ``parallel.functionalize`` both start with it).  A hybridized block
    finds deferred shapes through its own plain pass, so the block's
    hybridization is left as it is."""
    params = block.collect_params().values()
    if not any(p._deferred_init is not None or not p._data for p in params):
        return
    from .. import autograd
    xs = [x if isinstance(x, NDArray) else NDArray(x) for x in inputs]
    with autograd.pause(train_mode=train_mode):
        block(*xs)


def _prod(t):
    out = 1
    for x in t:
        out *= x
    return out


class Block:
    """Base class of layers and models (reference: ``gluon.Block``)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _SCOPE.create(prefix, params,
                                                   self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _NameScope(self)
        self._scope_counters = {}
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self):
        return self._scope

    def __repr__(self):
        mods = "\n".join(
            f"  ({k}): " + repr(v).replace("\n", "\n  ")
            for k, v in self._children.items())
        return f"{self.__class__.__name__}(\n{mods}\n)"

    def collect_params(self, select=None) -> ParameterDict:
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pat = re.compile(select)
            ret.update({n: p for n, p in self.params.items()
                        if pat.match(n)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from .. import initializer as init_mod
        self.collect_params().initialize(init or init_mod.Uniform(), ctx,
                                         verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters by structural name (``0.weight``) in the
        JAX package's npz."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {name: p._reduce() for name, p in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load :meth:`save_parameters`' file (this package's or the JAX
        package's); names match as in :func:`match_names`."""
        loaded = nd.load(filename, ctx=cpu(0))
        params = self._collect_params_with_prefix()
        mapping = match_names(list(params), list(loaded))
        if not allow_missing:
            for name in params:
                if name not in mapping:
                    raise MXNetError(
                        f"Parameter {name!r} missing in {filename!r}")
        used = set(mapping.values())
        if not ignore_extra:
            for name in loaded:
                if name not in used:
                    raise MXNetError(
                        f"Parameter {name!r} in file not found in Block "
                        f"(use ignore_extra=True)")
        for name, src in mapping.items():
            p, value = params[name], loaded[src]
            if p.shape is None or not all(s and s > 0 for s in p.shape):
                p.shape = tuple(value.shape)
            if not p._data:
                if p._deferred_init is not None:
                    p._finish_deferred_init()
                else:
                    p.initialize(ctx=ctx or [current_context()])
            p.set_data(value)

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + n: p for n, p in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args, **kwargs)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Print one row per block: name, type, output shape, parameter
        count."""
        rows = []

        def _hook(block, inp, out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            n_params = sum(int(_prod(p.shape))
                           for p in block._reg_params.values() if p.shape)
            rows.append((block.name, type(block).__name__,
                         tuple(getattr(o, "shape", ())), n_params))

        blocks = list(self._iter_blocks())
        for blk in blocks:
            blk._forward_hooks.append(_hook)
        try:
            self(*inputs)
        finally:
            for blk in blocks:
                blk._forward_hooks.remove(_hook)
        lines = [f"{'Layer':<30}{'Type':<20}{'Output':<24}{'Params':<12}"]
        total = 0
        for name, typ, shape, npar in rows:
            total += npar
            lines.append(f"{name:<30}{typ:<20}{str(shape):<24}{npar:<12}")
        lines.append(f"Total params: {total}")
        print("\n".join(lines))

    def _iter_blocks(self):
        yield self
        for c in self._children.values():
            yield from c._iter_blocks()


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  cache_size=None, bucket_shapes=None, **kwargs):
        """Run the block through a :class:`CachedOp` (``active=False``:
        eagerly again).  ``cache_size`` bounds the programs kept (default
        ``MXNET_CACHED_OP_CACHE_SIZE``); ``bucket_shapes={axis: [sizes]}``
        pads inputs with zeros along those axes up to the next declared
        size, so ragged shapes share programs (the block must be
        padding-safe there; outputs keep the padded size).
        ``static_alloc`` / ``static_shape`` are accepted for the
        reference's signature: every program keeps static buffers."""
        self._active = active
        self._flags = {"cache_size": cache_size,
                       "bucket_shapes": bucket_shapes}
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Overridden by layers that support deferred initialisation."""
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer parameter shapes; "
            f"provide explicit in_units/in_channels or run a forward pass")

    def _get_ctx(self, args):
        for a in args:
            if isinstance(a, NDArray):
                return a.context
        return current_context()

    def forward(self, x, *args, **kwargs):
        if not isinstance(x, NDArray):
            from ..symbol import Symbol
            if isinstance(x, Symbol):
                # symbolic composition: a graph over the parameters'
                # variables
                from .. import symbol as sym_mod
                pvars = {n: p.var() for n, p in self._reg_params.items()}
                return self.hybrid_forward(sym_mod, x, *args, **pvars,
                                           **kwargs)
            raise MXNetError(
                f"forward expects NDArray or Symbol, got {type(x)}")
        ctx = self._get_ctx((x,) + args)
        try:
            pdata = {n: p.data(ctx) for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(x, *args)
            pdata = {n: p.data(ctx) for n, p in self._reg_params.items()}
        if self._active and not _TRACING.get() and not kwargs \
                and all(isinstance(a, NDArray) for a in args):
            if self._cached_op is None:
                self._cached_op = CachedOp(self, **self._flags)
            try:
                return self._cached_op([x, *args], ctx)
            except DeferredInitializationError:
                # a child's parameters wait for their shapes: one plain
                # pass finds them, with the children's CachedOps off
                tok = _TRACING.set(True)
                try:
                    return self.hybrid_forward(nd, x, *args, **pdata)
                finally:
                    _TRACING.reset(tok)
        return self.hybrid_forward(nd, x, *args, **pdata, **kwargs)

    def _finish_deferred(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def optimize_for(self, x, *args, backend=None, **backend_opts):
        """Trace this block to a Symbol graph, run the registered
        subgraph-backend pass over it, and return a ``SymbolBlock`` over
        the rewritten graph sharing this block's parameters, run once on
        the example inputs (reference: HybridBlock.optimize_for)."""
        from .. import symbol as sym_mod
        if backend is None:
            raise MXNetError("optimize_for requires backend=<name>")
        n_in = 1 + len(args)
        data_syms = [sym_mod.var("data")] if n_in == 1 else \
            [sym_mod.var(f"data{i}") for i in range(n_in)]
        out = self(*data_syms)
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        opt = out.optimize_for(backend, **backend_opts)
        blk = SymbolBlock(opt, data_syms, params=self.collect_params())
        # the example inputs validate the rewritten graph end to end
        blk(x, *args)
        return blk

    def export(self, path, epoch=0):
        """Write the block's graph (its forward over a Symbol input named
        ``data``) to ``path-symbol.json`` and its parameters, by name, to
        ``path-NNNN.params`` (the JAX package's npz); returns the symbol
        file's name (reference: HybridBlock.export)."""
        from .. import symbol as sym_mod
        out = self(sym_mod.var("data"))
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        sym_file = f"{path}-symbol.json"
        out.save(sym_file)
        nd.save(f"{path}-{epoch:04d}.params",
                {name: p._reduce()
                 for name, p in self.collect_params().items()})
        return sym_file

    def export_stablehlo(self, *example_inputs, path, emit_text=False,
                         dynamic_batch=False, version=None,
                         precompile=(), quantize=None):
        """Export this block's inference forward as a deployable artifact:
        ``deploy.export_stablehlo`` of the block as an ``nn.Module``
        (``parallel.functional.GluonModule``, inference mode)."""
        from .. import deploy
        from ..parallel.functional import GluonModule
        xs = [x._data if isinstance(x, NDArray) else x
              for x in example_inputs]
        module = GluonModule(self, *example_inputs, train_mode=False)
        return deploy.export_stablehlo(
            module, *xs, path=path, emit_text=emit_text,
            dynamic_batch=dynamic_batch, version=version,
            precompile=precompile, quantize=quantize)


class SymbolBlock(HybridBlock):
    """A Symbol graph as a block (reference: gluon.SymbolBlock).  The
    graph's arguments other than ``inputs``, and its auxiliary states
    (``grad_req="null"``), are the block's parameters: those of
    ``params`` with the same names (shared), new ones otherwise.  A call records on the tape under ``record()``; after
    ``hybridize()`` it goes through the block's CachedOp like any
    HybridBlock's."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol as sym_mod
        from ..symbol import Symbol
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._out_sym = outputs
        self._in_names = [s.name for s in inputs]
        in_set = set(self._in_names)
        aux = set(outputs.list_auxiliary_states())
        for arg in outputs.list_arguments() + sorted(aux):
            if arg in in_set:
                continue
            # the graph's argument names are the parameters' full names:
            # a shared parameter of that name is adopted as it is
            if params is not None and arg in params:
                self._params._params[arg] = params[arg]
            else:
                self._params.get(arg, shape=None, allow_deferred_init=True,
                                 grad_req="null" if arg in aux else "write")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over a symbol file and, optionally, its
        parameters (this package's export, the JAX package's, or an
        upstream ``.params``)."""
        from .. import symbol as sym_mod
        out = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        blk = SymbolBlock(out, [sym_mod.var(n) for n in input_names])
        if param_file is not None:
            loaded = nd.load(param_file, ctx=cpu(0))
            for name, value in loaded.items():
                name = name.split(":", 1)[-1]   # a Module's arg: / aux:
                if name in blk._params:
                    p = blk._params[name]
                    p.shape = tuple(value.shape)
                    p.initialize(ctx=ctx or [current_context()])
                    p.set_data(value)
        return blk

    def infer_shape(self, *args):
        shapes = {n: tuple(a.shape) for n, a in zip(self._in_names, args)}
        arg_shapes, _, aux_shapes = self._out_sym.infer_shape_partial(
            **shapes)
        names = self._out_sym.list_arguments() + \
            self._out_sym.list_auxiliary_states()
        for name, shape in zip(names, arg_shapes + aux_shapes):
            if name in self._params and shape is not None:
                self._params[name].shape = shape

    def forward(self, x, *args):
        from ..symbol import Symbol
        inputs = (x,) + args
        if isinstance(x, Symbol):
            return self._out_sym(**dict(zip(self._in_names, inputs)))
        ctx = self._get_ctx(inputs)
        try:
            for p in self._params.values():
                p.data(ctx)
        except DeferredInitializationError:
            self.infer_shape(*inputs)
            for p in self._params.values():
                p._finish_deferred_init()
        if self._active and not _TRACING.get():
            if self._cached_op is None:
                self._cached_op = CachedOp(self, **self._flags)
            return self._cached_op(list(inputs), ctx)
        return self._run_graph(inputs, ctx)

    def _run_graph(self, inputs, ctx):
        """The graph over the inputs and the parameters' values, on the
        tape when recording."""
        from .. import autograd
        from ..ops.registry import _mark_leaves
        feed = {n: a._data for n, a in zip(self._in_names, inputs)}
        for name, p in self._params.items():
            if name not in feed:
                feed[name] = p.data(ctx)._data
        record = autograd.is_recording()
        if record and not _TRACING.get():
            _mark_leaves(feed.values())
        with torch.set_grad_enabled(record):
            outs = self._out_sym._interpret(feed)
        outs = [NDArray._wrap(o, ctx) for o in outs]
        return outs[0] if len(outs) == 1 else outs
