"""Model zoo of the PyTorch port (reference:
python/mxnet/gluon/model_zoo/)."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
