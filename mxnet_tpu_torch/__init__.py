"""mxnet_tpu_torch — the PyTorch / CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module paths and
public names.  This slice ports paged decode serving:
``serving.DecodeEngine`` over ``serving.PagedLMAdapter`` over
``models.TransformerDecoderLM``, whose decode and verify attention run
in two hand-written CUDA kernels (``ops.paged_attention``, sources in
``csrc/``).  Entry points run on ``device="cuda"`` unless the caller
asks for ``"cpu"``.  The package imports ``torch`` and numpy, never
``jax`` or ``mxnet_tpu``.
"""
from .base import MXNetError

__all__ = ["MXNetError"]
