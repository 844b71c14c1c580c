"""mxnet_tpu_torch — the PyTorch / CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module paths and
public names.  Import convention, as the reference's::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, autograd, gluon, kvstore

Entry points run on the card: the default context is ``mx.gpu(0)``, and
a missing card raises instead of falling back to the host; ask for the
CPU with ``ctx=mx.cpu(0)`` or ``with mx.cpu(0):``.  Kernels (the flash
attention and paged attention sources in ``csrc/``) are built by
``ops.build`` when first launched, never at import.  The package imports
``torch`` and numpy, never ``jax`` or ``mxnet_tpu``.
"""
from . import base
from .base import MXNetError
from . import context
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus)
from . import autograd
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import random
from . import initializer
from .initializer import init
from . import lr_scheduler
from . import optimizer
from . import gluon
from . import kvstore
from . import kvstore as kv
from . import metric
from . import recordio
from . import io
from . import image
from . import lib
from . import attribute
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from . import module
from . import callback
from . import compat
from . import test_utils
from . import engine
from . import monitor
from . import subgraph
from . import np
from . import npx
from . import contrib

# bound at first use (the JAX package imports them with the package): an
# exported artifact's loader imports the package root for its operators,
# and serving, deploy, parallel and models stay out of that process
_ON_FIRST_USE = ("parallel", "models", "serving", "deploy")


def waitall():
    """Block until every queued computation has finished."""
    engine.waitall()


def __getattr__(name):
    if name in _ON_FIRST_USE:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["MXNetError", "Context", "cpu", "cpu_pinned", "gpu",
           "current_context", "num_gpus", "autograd", "nd", "ndarray",
           "NDArray", "random", "init", "initializer", "lr_scheduler",
           "optimizer", "gluon", "kvstore", "kv", "metric", "recordio",
           "io", "image", "lib", "attribute", "AttrScope", "symbol", "sym", "Symbol", "executor",
           "module", "callback", "compat", "test_utils", "waitall", "base",
           "engine", "parallel", "models", "serving", "deploy", "monitor",
           "subgraph", "np", "npx", "contrib"]
