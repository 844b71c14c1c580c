"""Module: symbolic training over a bound Executor (reference:
``python/mxnet/module/module.py``).

The counterpart of ``mxnet_tpu.module.module``: one Executor runs the
whole graph (its forward and backward programs are CUDA graphs on the
card); the optimizer updates each parameter through an ``Updater``
keyed by the parameter's name.  Checkpoints are the JAX package's:
``prefix-symbol.json`` and ``prefix-NNNN.params`` (npz, ``arg:`` /
``aux:`` keys), ``prefix-NNNN.states`` from the updater.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .. import context as ctx_mod
from .. import initializer as init_mod
from .. import ndarray as nd
from .. import optimizer as opt_mod
from .. import runtime_metrics as _rm
from ..executor import Executor, _write
from ..initializer import InitDesc
from ..optimizer.optimizer import get_updater
from .base_module import BaseModule

__all__ = ["Module", "save_checkpoint", "load_checkpoint"]


class Module(BaseModule):
    """reference: mx.mod.Module(symbol, data_names, label_names, context).
    ``context`` defaults to the current context (the card)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._context = context if context is not None \
            else ctx_mod.current_context()
        if isinstance(self._context, (list, tuple)):
            # one Module runs on one context (the card)
            self._context = self._context[0]
        self._fixed_param_names = set(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        unknown_data = set(self._data_names) - set(arg_names)
        if unknown_data:
            raise MXNetError(
                f"Module: data names {sorted(unknown_data)} not found in "
                f"symbol arguments {arg_names}")
        # labels the graph does not use are tolerated (an inference
        # symbol; the reference's _check_input_names with throw=False)
        missing_labels = set(self._label_names) - set(arg_names)
        if missing_labels:
            self.logger.warning(
                "Module: label names %s not used by the symbol; ignoring",
                sorted(missing_labels))
            self._label_names = [n for n in self._label_names
                                 if n in arg_names]
        input_names = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None
        self._inputs_need_grad = False
        self._preloaded = None          # set by Module.load
        self._preloaded_states = None

    # ------------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        # a rebind keeps the trained values (the reference re-copies
        # arg_params into the new executor group)
        preserved = None
        if self.binded and self.params_initialized:
            preserved = self.get_params()
        self._data_shapes = _norm_shapes(data_shapes, self._data_names)
        self._label_shapes = _norm_shapes(label_shapes, self._label_names) \
            if label_shapes else []
        self._for_training = for_training
        self._inputs_need_grad = inputs_need_grad

        shapes = {n: s for n, s in self._data_shapes + self._label_shapes}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        arg_names = self._symbol.list_arguments()

        args, reqs = {}, {}
        shared = shared_module._exec if shared_module is not None else None
        for name, shape in zip(arg_names, arg_shapes):
            if shared is not None and name in shared.arg_dict and \
                    name in self._param_names:
                args[name] = shared.arg_dict[name]      # shared storage
            else:
                args[name] = nd.zeros(shape, ctx=self._context)
            if not for_training:
                reqs[name] = "null"
            elif name in self._fixed_param_names:
                reqs[name] = "null"
            elif name in self._param_names:
                reqs[name] = grad_req
            else:  # data / label inputs
                reqs[name] = grad_req if (inputs_need_grad and
                                          name in self._data_names) \
                    else "null"
        aux = {}
        for name, shape in zip(self._aux_names, aux_shapes):
            if shared is not None and name in shared.aux_dict:
                aux[name] = shared.aux_dict[name]
            else:
                aux[name] = nd.zeros(shape, ctx=self._context)

        self._exec = Executor(self._symbol, self._context, args,
                              args_grad=None, grad_req=reqs, aux_states=aux)
        self.binded = True
        if preserved is not None:
            self._restore_preserved(preserved)
        elif shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
        elif self._preloaded is not None:
            # Module.load: the checkpoint's values into the fresh bind
            arg_params, aux_params = self._preloaded
            self.init_params(arg_params=arg_params, aux_params=aux_params,
                             allow_extra=True)

    def _restore_preserved(self, preserved):
        """The trained values after a force_rebind.  A parameter whose
        shape changed cannot keep its value: it is initialized anew (the
        module's default initializer), with a warning."""
        arg_params, aux_params = preserved
        mismatched = []

        def _compat(params, bound):
            out = {}
            for n, v in params.items():
                if n in bound and tuple(bound[n].shape) == tuple(v.shape):
                    out[n] = v
                elif n in bound:
                    mismatched.append(n)
            return out

        self.init_params(
            initializer=None,
            arg_params=_compat(arg_params, self._exec.arg_dict),
            aux_params=_compat(aux_params, self._exec.aux_dict),
            allow_missing=True, force_init=True, allow_extra=True)
        if mismatched:
            self.logger.warning(
                "bind(force_rebind): parameters %s changed shape; "
                "re-initialized with the default initializer", mismatched)
            default_init = init_mod.Uniform(0.01)
            for n in mismatched:
                arr = self._exec.arg_dict[n] if n in self._exec.arg_dict \
                    else self._exec.aux_dict[n]
                default_init(InitDesc(n), arr)

    # ---------------------------------------------------------------- params
    _DEFAULT_INIT = object()  # "not given", apart from an explicit None

    def init_params(self, initializer=_DEFAULT_INIT, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params: call bind first")
        if initializer is Module._DEFAULT_INIT:
            initializer = init_mod.Uniform(0.01)

        def _copy_in(name, arr, src, kind):
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(
                    f"init_params: shape mismatch for {kind} {name!r}: "
                    f"provided {tuple(src.shape)}, bound {tuple(arr.shape)}")
            _write(arr, src)

        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                _copy_in(name, arr, arg_params[name], "arg")
            elif arg_params is not None and not allow_missing:
                raise MXNetError(f"init_params: missing arg {name!r}")
            elif initializer is not None:
                initializer(InitDesc(name), arr)
            # initializer=None and missing: the current value stays
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                _copy_in(name, arr, aux_params[name], "aux")
            elif aux_params is not None and not allow_missing:
                raise MXNetError(f"init_params: missing aux {name!r}")
            elif initializer is not None:
                initializer(InitDesc(name), arr)
        if arg_params is not None and not allow_extra:
            extra = set(arg_params) - set(self._param_names)
            if extra:
                raise MXNetError(
                    f"init_params: extra parameters {sorted(extra)} "
                    f"(pass allow_extra=True to ignore)")
        self.params_initialized = True

    def get_params(self):
        if not self.binded:
            raise MXNetError("get_params: module not bound")
        args = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return args, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Copy values in (numpy arrays too); a parameter absent from the
        dicts keeps its value (initializer=None)."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
        else:
            batch_size = self._data_shapes[0][1][0]
            params = dict(optimizer_params)
            params.setdefault("rescale_grad", 1.0 / batch_size)
            self._optimizer = opt_mod.create(optimizer, **params)
        self._updater = get_updater(self._optimizer)
        if self._preloaded_states is not None:
            self._updater.set_states(self._preloaded_states,
                                     ctx=self._context)
            self._preloaded_states = None
        self.optimizer_initialized = True

    # ----------------------------------------------------------- step pieces
    def forward(self, data_batch, is_train=None):
        if not self.binded:
            raise MXNetError("forward: module not bound")
        if is_train is None:
            is_train = self._for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads=out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("update: call init_optimizer first")
        # keyed by the parameter's name: the updater's states stay right
        # when buckets whose argument orders differ share it
        for name in self._param_names:
            if self._exec._grad_req.get(name, "null") == "null":
                continue
            self._updater(name, self._exec.grad_dict[name],
                          self._exec.arg_dict[name])
        if _rm._ENABLED and _rm.grad_norm_enabled():
            _rm.publish_grad_norm(
                self._exec.grad_dict[n] for n in self._param_names
                if self._exec._grad_req.get(n, "null") != "null"
                and n in self._exec.grad_dict)

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self._inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        save_checkpoint(prefix, epoch, self._symbol, *self.get_params())
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states(dump_optimizer=False))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg_params, aux_params)  # applied at bind()
        if load_optimizer_states:
            with open(f"{prefix}-{epoch:04d}.states", "rb") as f:
                mod._preloaded_states = f.read()  # at init_optimizer
        return mod

    @property
    def num_compiles(self):
        return self._exec.num_compiles if self._exec is not None else 0


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """reference: mx.model.save_checkpoint — symbol JSON + params."""
    symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in arg_params.items()}
    payload.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", payload)


def load_checkpoint(prefix, epoch):
    """reference: mx.model.load_checkpoint (this package's checkpoint,
    the JAX package's, or an upstream ``.params``)."""
    from .. import symbol as sym_mod
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    payload = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in payload.items():
        kind, name = k.split(":", 1)
        (arg_params if kind == "arg" else aux_params)[name] = v
    return symbol, arg_params, aux_params


def _norm_shapes(shapes, names):
    """[(name, shape)...] or [DataDesc...] -> [(name, shape)...]"""
    out = []
    for entry in shapes or []:
        if hasattr(entry, "name"):       # DataDesc
            out.append((entry.name, tuple(entry.shape)))
        else:
            out.append((entry[0], tuple(entry[1])))
    return out
