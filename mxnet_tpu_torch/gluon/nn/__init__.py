"""Neural network layers of the PyTorch port (reference:
python/mxnet/gluon/nn/)."""
from .basic_layers import *
from .conv_layers import *
from . import basic_layers
from . import conv_layers

__all__ = basic_layers.__all__ + conv_layers.__all__
