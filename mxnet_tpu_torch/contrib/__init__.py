"""contrib: mixed precision and int8 quantization (reference:
``python/mxnet/contrib/``).  The JAX package's ``onnx``, ``text`` and
``tensorboard`` are not ported yet (ROADMAP 6.8b)."""
from . import amp
from . import quantization

__all__ = ["amp", "quantization"]
