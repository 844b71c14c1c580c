"""``mx.npx``: the NumPy-extension namespace: operators with no NumPy
equivalent (neural-network layers, device placement, framework I/O).

The counterpart of ``mxnet_tpu.npx`` (reference:
``python/mxnet/ndarray/numpy_extension/``).  The layer functions call
the shared op registry (the same functions as ``mx.nd`` and
``mx.sym``).  ``set_np()`` / ``reset_np()`` only set a flag: ``mx.np``
arrays and ``mx.nd`` arrays are the same ``NDArray``.
"""
from __future__ import annotations

import threading

from ..ndarray import NDArray
from .. import ndarray as _nd

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape",
           "save", "load", "seed",
           "relu", "sigmoid", "softmax", "log_softmax", "activation",
           "fully_connected", "convolution", "pooling", "batch_norm",
           "layer_norm", "embedding", "dropout", "one_hot", "pick",
           "topk", "rnn", "gamma", "reshape_like", "batch_dot",
           "broadcast_like", "arange_like", "sequence_mask", "waitall",
           "current_device", "num_gpus"]

_flags = threading.local()


def set_np(shape=True, array=True, dtype=False):
    """Enable numpy semantics globally (reference: mx.npx.set_np).
    A flag only: ``mx.np`` has numpy semantics always."""
    _flags.np_shape = shape
    _flags.np_array = array


def reset_np():
    _flags.np_shape = False
    _flags.np_array = False


def is_np_array():
    return getattr(_flags, "np_array", False)


def is_np_shape():
    return getattr(_flags, "np_shape", False)


def seed(s):
    from .. import random as mxrand
    mxrand.seed(s)


def waitall():
    from .. import engine
    engine.waitall()


def current_device():
    from ..context import current_context
    return current_context()


def num_gpus():
    from ..context import num_gpus as _n
    return _n()


def save(file, arr):
    """reference: npx.save — dict or list of arrays to file."""
    if isinstance(arr, NDArray):
        arr = [arr]
    _nd.save(file, arr)


def load(file):
    return _nd.load(file)


# ---------------------------------------------------------------------------
# Neural-network extension ops: thin delegations to the shared op registry
# (same FCompute bodies as mx.nd/mx.sym — one registry, three namespaces).
# ---------------------------------------------------------------------------

def _op(name, *args, **kwargs):
    return _nd.invoke_by_name(name, list(args), kwargs)


def relu(data):
    return _op("relu", data)


def sigmoid(data):
    return _op("sigmoid", data)


def activation(data, act_type="relu"):
    return _op("Activation", data, act_type=act_type)


def softmax(data, axis=-1, length=None, temperature=None):
    kwargs = {"axis": axis}
    if temperature is not None:
        kwargs["temperature"] = temperature
    return _op("softmax", data, **kwargs)


def log_softmax(data, axis=-1):
    return _op("log_softmax", data, axis=axis)


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    if num_hidden is None:
        num_hidden = weight.shape[0]
    args = (x, weight) if bias is None else (x, weight, bias)
    return _op("FullyConnected", *args, num_hidden=num_hidden,
               no_bias=bias is None or no_bias, flatten=flatten)


def convolution(data=None, weight=None, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    args = (data, weight) if bias is None else (data, weight, bias)
    return _op("Convolution", *args, kernel=tuple(kernel),
               stride=tuple(stride or ()), dilate=tuple(dilate or ()),
               pad=tuple(pad or ()), num_filter=num_filter,
               num_group=num_group, no_bias=bias is None or no_bias,
               layout=layout)


def pooling(data, kernel=(2, 2), stride=None, pad=None, pool_type="max",
            global_pool=False):
    return _op("Pooling", data, kernel=tuple(kernel),
               stride=tuple(stride or ()), pad=tuple(pad or ()),
               pool_type=pool_type, global_pool=global_pool)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-3,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    return _op("BatchNorm", x, gamma, beta, running_mean, running_var,
               eps=eps, momentum=momentum, fix_gamma=fix_gamma,
               use_global_stats=use_global_stats,
               output_mean_var=output_mean_var, axis=axis)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return _op("LayerNorm", data, gamma, beta, axis=axis, eps=eps)


def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    if input_dim is None:
        input_dim, output_dim = weight.shape
    return _op("Embedding", data, weight, input_dim=input_dim,
               output_dim=output_dim, dtype=dtype,
               sparse_grad=sparse_grad)


def dropout(data, p=0.5, axes=(), mode="training"):
    return _op("Dropout", data, p=p, axes=axes, mode=mode)


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    return _op("one_hot", data, depth=depth, on_value=on_value,
               off_value=off_value, dtype=dtype)


def pick(data, index, axis=-1, mode="clip", keepdims=False):
    return _op("pick", data, index, axis=axis, mode=mode,
               keepdims=keepdims)


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    return _op("topk", data, axis=axis, k=k, ret_typ=ret_typ,
               is_ascend=is_ascend, dtype=dtype)


def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=True):
    args = [data, parameters, state]
    if mode == "lstm":
        args.append(state_cell)
    return _op("RNN", *args, state_size=state_size, num_layers=num_layers,
               mode=mode, bidirectional=bidirectional, p=p,
               state_outputs=state_outputs)


def gamma(data):
    return _op("gamma", data)


def reshape_like(lhs, rhs):
    return _op("reshape_like", lhs, rhs)


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    return _op("batch_dot", lhs, rhs, transpose_a=transpose_a,
               transpose_b=transpose_b)


def broadcast_like(lhs, rhs):
    return _op("broadcast_like", lhs, rhs)


def arange_like(data, start=0.0, step=1.0, axis=None):
    return _op("arange_like", data, start=start, step=step, axis=axis)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    args = (data,) if sequence_length is None \
        else (data, sequence_length)
    return _op("SequenceMask", *args,
               use_sequence_length=sequence_length is not None
               or use_sequence_length, value=value, axis=axis)
