"""Gluon contrib of the PyTorch port (reference:
python/mxnet/gluon/contrib/): ``nn``, ``rnn``, ``estimator``,
``detection``, ``FusedTrainStep`` and ``MoEFFN``."""
from . import estimator
from . import nn
from . import detection, rnn
from .fused import FusedTrainStep
from .moe import MoEFFN

__all__ = ["detection", "estimator", "nn", "rnn",
           "FusedTrainStep", "MoEFFN"]
