"""Weight initializers of the PyTorch port (``mx.init``).

The counterpart of ``mxnet_tpu.initializer``: the same registry, string
aliases and name rules (``*gamma`` ones, ``*beta`` / ``*bias`` zeros,
running statistics zeros / ones).  Draws come from the default
generator of the array's device, which ``mx.random.seed`` seeds; they
cannot equal the JAX package's draws, so parity tests carry weights
across with ``nd.save`` / ``load_parameters``.
"""
from __future__ import annotations

import json
import math
import sys
import types

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "Zero", "One",
           "Xavier", "MSRAPrelu", "Orthogonal", "LSTMBias", "Bilinear",
           "InitDesc", "create", "register"]

_REG = {}


def register(klass):
    _REG[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Parameter-name descriptor carrying attributes."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _fill(arr, tensor):
    arr._set_data(tensor.to(arr._data.dtype))


class Initializer:
    """Base initializer; called on ``(name, NDArray)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, name, arr):
        if not isinstance(name, str):
            name, arr = getattr(name, "name", str(name)), name
        name_l = name.lower()
        with torch.no_grad():
            if name_l.endswith("gamma"):
                self._init_one(arr)
            elif name_l.endswith("beta") or name_l.endswith("bias"):
                self._init_zero(arr)
            elif "running_mean" in name_l or "moving_mean" in name_l:
                self._init_zero(arr)
            elif "running_var" in name_l or "moving_var" in name_l:
                self._init_one(arr)
            else:
                self._init_weight(name, arr)

    def init_weight(self, name, arr):
        with torch.no_grad():
            self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    @staticmethod
    def _init_zero(arr):
        _fill(arr, torch.zeros_like(arr._data))

    @staticmethod
    def _init_one(arr):
        _fill(arr, torch.ones_like(arr._data))


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(arr)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(arr)


_REG["zeros"] = Zero
_REG["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        _fill(arr, torch.full_like(arr._data, float(self.value)))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _fill(arr, torch.empty_like(arr._data, dtype=torch.float32)
              .uniform_(-self.scale, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _fill(arr, torch.empty_like(arr._data, dtype=torch.float32)
              .normal_(0.0, self.sigma))


@register
class Xavier(Initializer):
    """Xavier / Glorot (reference: initializer.py Xavier)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            fan_in = fan_out = shape[0] if shape else 1
        else:
            if len(shape) > 2:
                hw_scale = float(np.prod(shape[2:]))
            fan_in = shape[1] * hw_scale
            fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in}.get(
            self.factor_type, fan_out)
        scale = math.sqrt(self.magnitude / factor)
        t = torch.empty_like(arr._data, dtype=torch.float32)
        _fill(arr, t.uniform_(-scale, scale) if self.rnd_type == "uniform"
              else t.normal_(0.0, scale))


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """A scaled orthogonal matrix over the weight flattened to
    (shape[0], prod(shape[1:])): orthonormal rows (a wide weight) or
    columns, from the QR factorization of a normal draw.  The JAX
    package's version reshapes a non-square factor to the weight's shape
    and fails there; square weights are drawn alike."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_weight(self, name, arr):
        shape = arr.shape
        flat = (shape[0], int(np.prod(shape[1:])))
        a = torch.randn(flat, dtype=torch.float32, device=arr._data.device)
        wide = flat[0] < flat[1]
        # the orthonormal factor of the taller orientation, its columns'
        # signs fixed by R's diagonal
        q, r = torch.linalg.qr(a.T if wide else a)
        q = q * torch.sign(torch.diagonal(r))
        _fill(arr, self.scale * (q.T if wide else q).reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter set to ``forget_bias`` (gate
    order i, f, g, o)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape, dtype=torch.float32)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        _fill(arr, b.to(arr._data.device))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, torch.from_numpy(weight).to(arr._data.device))


def create(init, **kwargs):
    if isinstance(init, Initializer) or callable(init):
        return init
    if isinstance(init, str):
        klass = _REG.get(init.lower())
        if klass is None:
            raise MXNetError(f"unknown initializer {init!r}; known: "
                             f"{sorted(_REG)}")
        return klass(**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")


# the ``mx.init`` namespace
init = types.ModuleType(__name__ + ".init")
for _n in __all__:
    setattr(init, _n, globals()[_n])
sys.modules[init.__name__] = init
