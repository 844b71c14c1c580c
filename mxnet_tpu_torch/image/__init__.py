"""mx.image of the PyTorch port (reference: ``python/mxnet/image/``)."""
from .image import *          # noqa: F401,F403
from .image import __all__ as _image_all
from .detection import *      # noqa: F401,F403
from .detection import __all__ as _det_all

__all__ = list(_image_all) + list(_det_all)
