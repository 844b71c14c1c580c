"""Basic neural-network layers of the PyTorch port (reference:
gluon/nn/basic_layers.py): the counterpart of
``mxnet_tpu.gluon.nn.basic_layers``, each layer's ``hybrid_forward``
built from the registered ops of ``mxnet_tpu_torch.ops``.
"""
from __future__ import annotations

from ..block import Block, HybridBlock, update_aux_state

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "Swish", "GELU"]


class Sequential(Block):
    """Stack of Blocks executed sequentially (reference: nn.Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                args = tuple(x[1:])
                x = x[0]
        if args:
            return (x,) + args
        return x

    def __getitem__(self, key):
        children = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*children[key])
            return net
        return children[key]

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """Hybridizable Sequential (reference: nn.HybridSequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        children = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*children[key])
            return net
        return children[key]

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())

    def infer_shape(self, *args):
        # run children imperatively once; their own deferred init resolves
        x = args[0]
        for block in self._children.values():
            x = block(x)


class Dense(HybridBlock):
    """Fully-connected layer: ``act(dot(x, W.T) + b)``
    (reference: nn.Dense → FullyConnected op)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        in_units = x.size // x.shape[0] if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               flatten=self._flatten,
                               no_bias=bias is None)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    """Dropout (reference: nn.Dropout). Identity outside train_mode."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        from ... import autograd
        if self._rate == 0 or not autograd.is_training():
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes, mode="training")


class BatchNorm(HybridBlock):
    """Batch normalization with running stats (reference: nn.BatchNorm).

    Training: normalize by batch stats and update running stats (written
    by update_aux_state, outside the tape).  Inference: normalize by
    running stats.
    """

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, grad_req="null",
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, grad_req="null",
                allow_deferred_init=True, differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        if str(dtype) in ("float16", "bfloat16"):
            dtype = "float32"  # stats stay fp32 (reference AMP behavior)
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd
        from ...ndarray import NDArray

        # a half-precision input is normalised in float32 and the output
        # cast back to its dtype, as the reference's AMP runs BatchNorm
        half = isinstance(x, NDArray) and \
            str(x.dtype) in ("float16", "torch.bfloat16")
        if half:
            in_dtype, x = x.dtype, x.astype("float32")
        axis = self._axis if self._axis >= 0 else x.ndim + self._axis
        red = tuple(i for i in range(x.ndim) if i != axis)
        bshape = tuple(x.shape[i] if i == axis else 1 for i in range(x.ndim))

        use_batch_stats = autograd.is_training() and \
            not self._use_global_stats
        if use_batch_stats:
            # stats computed through registered ops so the tape
            # differentiates through them
            mean_nd = x.mean(axis=red)
            xm = x - mean_nd.reshape(bshape)
            var_nd = (xm * xm).mean(axis=red)
            m = self._momentum
            with autograd.pause():
                update_aux_state(
                    self.running_mean,
                    m * running_mean + (1 - m) * mean_nd.detach())
                update_aux_state(
                    self.running_var,
                    m * running_var + (1 - m) * var_nd.detach())
            out = xm / (var_nd.reshape(bshape) + self._eps).sqrt()
        else:
            out = (x - running_mean.reshape(bshape)) / \
                (running_var.reshape(bshape) + self._eps).sqrt()
        if self._scale:
            out = out * gamma.reshape(bshape)
        if self._center:
            out = out + beta.reshape(bshape)
        if half:
            out = out.astype(in_dtype)
        return out


class LayerNorm(HybridBlock):
    """Layer normalization (reference: nn.LayerNorm → LayerNorm op)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class GroupNorm(HybridBlock):
    """Group normalization (reference: nn.GroupNorm)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = num_groups
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = x.shape[1]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._eps)


class InstanceNorm(HybridBlock):
    """Instance normalization (reference: nn.InstanceNorm)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class Embedding(HybridBlock):
    """Index → vector lookup (reference: nn.Embedding → Embedding op)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    """Collapse all dims but batch (reference: nn.Flatten)."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """Wrap a function as a Block (reference: nn.Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as _nd
            function = getattr(_nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """Hybridizable Lambda (reference: nn.HybridLambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) else \
            getattr(function, "__name__", "custom")
        self._func = function

    def hybrid_forward(self, F, x, *args):
        f = getattr(F, self._func) if isinstance(self._func, str) \
            else self._func
        if isinstance(self._func, str):
            return f(x, *args)
        return self._func(F, x, *args)


class Activation(HybridBlock):
    """Activation layer (reference: nn.Activation)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod
        if alpha_initializer is None:
            alpha_initializer = init_mod.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    def __init__(self, approximation="erf", **kwargs):
        super().__init__(**kwargs)
        self._approx = approximation

    def hybrid_forward(self, F, x):
        if self._approx == "tanh":
            return F._contrib_gelu_tanh(x)
        return F._contrib_gelu_erf(x)
