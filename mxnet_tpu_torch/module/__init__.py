"""The legacy Module API of the PyTorch port (reference:
``python/mxnet/module/``): the counterpart of ``mxnet_tpu.module``.
``Module.fit`` over a bound Executor, and ``BucketingModule``'s bounded
set of programs for variable-length inputs.
"""
from .base_module import BaseModule
from .module import Module, save_checkpoint, load_checkpoint
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule", "save_checkpoint",
           "load_checkpoint"]
