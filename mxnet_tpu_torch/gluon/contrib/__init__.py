"""Gluon contrib of the PyTorch port (reference:
python/mxnet/gluon/contrib/): ``nn``, ``rnn`` and ``estimator``.

``detection``, ``FusedTrainStep`` and ``MoEFFN`` are not ported yet
(ROADMAP 6.4b): looking one up raises :class:`MXNetError` naming that
item, never a bare ``AttributeError``.
"""
from ...base import MXNetError
from . import estimator
from . import nn
from . import rnn

__all__ = ["estimator", "nn", "rnn"]

_NOT_PORTED = ("detection", "FusedTrainStep", "MoEFFN")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise MXNetError(
            f"gluon.contrib.{name} is not ported to mxnet_tpu_torch yet "
            f"(ROADMAP 6.4b: gluon.contrib.{{fused,moe,detection}})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
