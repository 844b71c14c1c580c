"""The legacy upstream ``.params`` container (reference:
``MXNDArraySave`` / ``MXNDArrayLoad``, ``NDArray::Save`` / ``Load``): the
dmlc-stream binary behind ``mx.nd.save`` / ``load`` and every upstream
``model-0000.params`` checkpoint.  The counterpart of
``mxnet_tpu.compat``; dense tensors only:

    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  n_arrays
    per array (NDArray::Save, V2):
        uint32  NDARRAY_V2_MAGIC = 0xF993FAC9
        int32   storage_type     (0 = kDefaultStorage; sparse refused)
        uint32  ndim             (TShape::Save)
        int64   dims[ndim]
        int32   dev_type, int32 dev_id   (Context; ignored on load)
        int32   type_flag        (mshadow order, _MSHADOW_DTYPES below)
        raw     data bytes (C order, prod(dims) * itemsize)
    uint64  n_names
    per name: uint64 len, bytes (utf-8)

``nd.load`` recognises the 0x112 magic and comes here; npz stays the
native container.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .base import MXNetError

__all__ = ["save_params_dmlc", "load_params_dmlc", "is_dmlc_params"]

_LIST_MAGIC = 0x112
_NDARRAY_V2_MAGIC = 0xF993FAC9

# mshadow type_flag order (mshadow/base.h)
_MSHADOW_DTYPES = ["float32", "float64", "float16", "uint8", "int32",
                   "int8", "int64", "bool", "int16", "uint16", "uint32",
                   "uint64", "bfloat16"]


def is_dmlc_params(path) -> bool:
    if not isinstance(path, (str, bytes)) and not hasattr(path,
                                                          "__fspath__"):
        return False                # file-like objects go to np.load
    try:
        with open(path, "rb") as f:
            head = f.read(8)
        return len(head) == 8 and \
            struct.unpack("<Q", head)[0] == _LIST_MAGIC
    except OSError:
        return False


def save_params_dmlc(path, arrays):
    """Write a name->NDArray dict in the legacy .params layout."""
    if not isinstance(arrays, dict):
        raise MXNetError("save_params_dmlc expects a dict of name->array")
    names = list(arrays.keys())
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(names)))
        for name in names:
            a = arrays[name]
            if getattr(getattr(a, "_data", None), "dtype", None) \
                    is torch.bfloat16:
                # the bits as they are (numpy has no bfloat16)
                npa = a._data.detach().cpu().contiguous().view(
                    torch.int16).numpy()
                type_flag = _MSHADOW_DTYPES.index("bfloat16")
                raw = npa.tobytes()
            else:
                npa = a.asnumpy() if hasattr(a, "asnumpy") \
                    else np.asarray(a)
                if str(npa.dtype) not in _MSHADOW_DTYPES:
                    npa = npa.astype(np.float32)
                type_flag = _MSHADOW_DTYPES.index(str(npa.dtype))
                raw = np.ascontiguousarray(npa).tobytes()
            f.write(struct.pack("<Ii", _NDARRAY_V2_MAGIC, 0))
            f.write(struct.pack("<I", npa.ndim))
            f.write(struct.pack(f"<{npa.ndim}q", *npa.shape))
            f.write(struct.pack("<ii", 1, 0))          # cpu(0)
            f.write(struct.pack("<i", type_flag))
            f.write(raw)
        f.write(struct.pack("<Q", len(names)))
        for name in names:
            b = name.encode("utf-8")
            f.write(struct.pack("<Q", len(b)) + b)
    return path


def load_params_dmlc(path, ctx=None):
    """Read a legacy .params file: a dict name -> NDArray on ``ctx`` (the
    current context), or a list when the file names nothing, as
    ``mx.nd.load``."""
    from . import ndarray as nd
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def take(fmt):
        nonlocal pos
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, data, pos)
        pos += size
        return vals if len(vals) > 1 else vals[0]

    magic = take("<Q")
    if magic != _LIST_MAGIC:
        raise MXNetError(f"{path!r}: not a .params file (magic {magic:#x})")
    take("<Q")                                   # reserved
    n = take("<Q")
    arrays = []
    for _ in range(n):
        amagic = take("<I")
        if amagic != _NDARRAY_V2_MAGIC:
            raise MXNetError(
                f"{path!r}: unsupported NDArray magic {amagic:#x} "
                f"(only the dense V2 layout is implemented)")
        stype = take("<i")
        if stype != 0:
            raise MXNetError(f"{path!r}: sparse storage type {stype} "
                             f"unsupported in the .params shim")
        ndim = take("<I")
        shape = tuple(take(f"<{ndim}q")) if ndim > 1 else \
            ((take("<q"),) if ndim == 1 else ())
        take("<ii")                              # context, ignored
        type_flag = take("<i")
        if not 0 <= type_flag < len(_MSHADOW_DTYPES):
            raise MXNetError(f"{path!r}: unknown dtype flag {type_flag}")
        dtype = _MSHADOW_DTYPES[type_flag]
        count = int(np.prod(shape)) if shape else 1
        if dtype == "bfloat16":
            raw = np.frombuffer(data, np.uint16, count, pos)
            pos += raw.nbytes
            arrays.append(nd.NDArray(torch.from_numpy(
                raw.reshape(shape).copy()).view(torch.bfloat16), ctx=ctx))
        else:
            raw = np.frombuffer(data, np.dtype(dtype), count, pos)
            pos += raw.nbytes
            arrays.append(nd.NDArray(raw.reshape(shape).copy(), ctx=ctx))
    n_names = take("<Q")
    names = []
    for _ in range(n_names):
        ln = take("<Q")
        names.append(data[pos:pos + ln].decode("utf-8"))
        pos += ln
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise MXNetError(f"{path!r}: {len(names)} names for "
                         f"{len(arrays)} arrays")
    return dict(zip(names, arrays))
