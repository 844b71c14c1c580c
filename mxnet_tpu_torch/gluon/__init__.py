"""Gluon of the PyTorch port: the imperative NN API (reference:
python/mxnet/gluon/) — Parameter, Block / HybridBlock, ``nn``, ``loss``,
``utils``, ``Trainer``, ``data``, ``SymbolBlock``, ``rnn``, ``contrib``
and ``model_zoo``."""
from . import parameter
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import loss
from . import utils
from . import trainer
from .trainer import Trainer
from . import data
from . import rnn
from . import contrib
from . import model_zoo

__all__ = ["Parameter", "Constant", "ParameterDict", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "rnn", "loss", "utils", "data",
           "contrib", "model_zoo"]
