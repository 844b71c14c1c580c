"""Sparse NDArrays of the PyTorch port: CSR and row-sparse storage
(reference: ``python/mxnet/ndarray/sparse.py``).

The counterpart of ``mxnet_tpu.ndarray.sparse``, in its layout: an
array holds its components as dense tensors on its device (``data``,
``indices`` and, for CSR, ``indptr``), and a dense materialisation,
made on first use and kept, stands in for it in every op that has no
sparse form (``_data``: ``nd.relu(csr)`` reads it).  Not
``torch.sparse``: its coalescing and autograd rules are not the JAX
package's.  ``_set_data`` and ``copyto`` raise, as in the JAX package.

The materialisation and :func:`dot` add stored values into rows with
``index_add_`` / ``index_put_(accumulate=True)``; on the card those
add in an unspecified order, so repeated runs agree to rounding, not
bit for bit.

Three conversions read a row mask or a row pointer on the host, as the
JAX package does (``np.flatnonzero``): dense to row-sparse
(:func:`row_sparse_array` of an NDArray, ``tostype("row_sparse")``,
which ``gluon.Trainer`` calls on a ``grad_stype="row_sparse"``
parameter's gradient each step), :meth:`RowSparseNDArray.retain` and
CSR row slicing; dense to CSR reads the whole matrix.  On the card each
read is one device-to-host synchronisation, counted in
:data:`HOST_SYNCS`.  Inside a CUDA-graph capture the read would fail
the capture, so these conversions raise :class:`MXNetError` there,
naming the conversion.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..base import MXNetError
from ..context import context_of, current_context
from .ndarray import _NP_OF_TORCH, NDArray, to_torch_dtype

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "zeros", "empty", "array",
           "retain", "dot", "add", "elemwise_add", "tostype", "HOST_SYNCS"]

# device-to-host reads made by the conversions above, by conversion
HOST_SYNCS = collections.Counter()


def _host_read(tensor, what):
    """``tensor`` as a numpy array: one counted synchronisation on the
    card, refused inside a CUDA-graph capture."""
    if tensor.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f"{what}: the result's size depends on the data, read on "
                f"the host, which cannot happen inside a captured CUDA "
                f"graph (a hybridized block); convert outside the block")
        HOST_SYNCS[what] += 1
    return tensor.detach().cpu().numpy()


def _ctx_device(ctx):
    ctx = ctx or current_context()
    return ctx, ctx.torch_device()


def _tensor(value, device, dtype=None):
    """A component tensor on ``device``."""
    if isinstance(value, NDArray):
        value = value._data.detach()
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype or value.dtype)
    arr = np.asarray(value)
    if dtype is None and arr.dtype == np.float64:
        dtype = torch.float32
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _index(value, device):
    return _tensor(value, device, torch.int32)


class BaseSparseNDArray(NDArray):
    """Components on a device plus a kept dense materialisation."""

    __slots__ = ("_sparse_shape", "_dense_cache", "_components")

    def __init__(self, components: dict, shape, ctx=None):
        # no NDArray.__init__: there is no dense tensor yet
        self._components = dict(components)
        self._sparse_shape = tuple(int(s) for s in shape)
        self._dense_cache = None
        self._t = None
        self._lazy = None
        self._ctx = ctx or context_of(self._components["data"].device)
        self._grad = None
        self._grad_req = "null"
        self._home = None

    # -- the dense stand-in ------------------------------------------------
    @property
    def _data(self):
        """The dense materialisation (module docstring)."""
        if self._dense_cache is None:
            self._dense_cache = self._to_dense()
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        raise MXNetError(
            f"cannot assign a dense buffer into a {self.stype} array; "
            f"convert with tostype('default') first")

    def _set_data(self, new):
        raise MXNetError(
            f"in-place write on a {self.stype} array is not supported; "
            f"convert with tostype('default') first")

    @property
    def shape(self):
        return self._sparse_shape

    @property
    def dtype(self):
        t = self._components["data"].dtype
        return np.dtype(_NP_OF_TORCH[t]) if t in _NP_OF_TORCH else t

    @property
    def size(self):
        n = 1
        for s in self._sparse_shape:
            n *= s
        return n

    @property
    def ndim(self):
        return len(self._sparse_shape)

    @property
    def data(self) -> NDArray:
        """The stored values (reference: ``CSRNDArray.data``)."""
        return NDArray._wrap(self._components["data"], self._ctx)

    @property
    def indices(self) -> NDArray:
        return NDArray._wrap(self._components["indices"], self._ctx)

    def todense(self) -> NDArray:
        return NDArray._wrap(self._to_dense(), self._ctx)

    def tostype(self, stype: str):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return _from_dense(self.todense(), stype)

    def astype(self, dtype, copy=True):
        comp = dict(self._components)
        comp["data"] = comp["data"].to(to_torch_dtype(dtype))
        return type(self)(comp, self._sparse_shape, self._ctx)

    def copy(self):
        return type(self)({k: v.clone() for k, v in
                           self._components.items()},
                          self._sparse_shape, self._ctx)

    def copyto(self, other):
        raise MXNetError("copyto on sparse arrays is not supported; "
                         "use tostype/todense")

    def wait_to_read(self):
        t = self._components["data"]
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        return self

    def __repr__(self):
        return (f"<{type(self).__name__} {self.shape} {self.dtype} "
                f"nnz-storage={tuple(self._components['data'].shape)} "
                f"@{self._ctx}>")


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (reference: ``CSRNDArray``)."""

    __slots__ = ()

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return NDArray._wrap(self._components["indptr"], self._ctx)

    def _row_ids(self):
        """The row of each stored element, from ``indptr``."""
        indptr = self._components["indptr"].to(torch.int64)
        nnz = self._components["data"].shape[0]
        pos = torch.arange(nnz, device=indptr.device)
        return torch.searchsorted(indptr, pos, right=True) - 1

    def _to_dense(self):
        data = self._components["data"]
        out = torch.zeros(self._sparse_shape, dtype=data.dtype,
                          device=data.device)
        cols = self._components["indices"].to(torch.int64)
        out.index_put_((self._row_ids(), cols), data, accumulate=True)
        return out

    def __getitem__(self, key):
        if isinstance(key, int):
            nrows = self._sparse_shape[0]
            if key < 0:
                key += nrows
            if not 0 <= key < nrows:
                raise MXNetError(f"row index {key} out of range "
                                 f"for {self.shape}")
            key = slice(key, key + 1)
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise MXNetError("CSR supports only contiguous row slicing")
        start, stop, _ = key.indices(self._sparse_shape[0])
        indptr = self._components["indptr"]
        ends = _host_read(indptr[[start, stop]], "CSR row slicing")
        s, e = int(ends[0]), int(ends[1])
        comp = {"data": self._components["data"][s:e],
                "indices": self._components["indices"][s:e],
                "indptr": indptr[start:stop + 1] - s}
        return CSRNDArray(comp, (stop - start, self._sparse_shape[1]),
                          self._ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """First-dimension-sparse tensor: stored rows and their indices
    (reference: ``RowSparseNDArray``), the gradient type of
    embedding-style lookups."""

    __slots__ = ()

    @property
    def stype(self):
        return "row_sparse"

    def _to_dense(self):
        data = self._components["data"]
        out = torch.zeros(self._sparse_shape, dtype=data.dtype,
                          device=data.device)
        out.index_add_(0, self._components["indices"].to(torch.int64), data)
        return out

    def retain(self, indices):
        """Keep only the given rows (reference: ``sparse.retain``)."""
        mine = self._components["indices"]
        keep = _index(indices, mine.device)
        mask = torch.isin(mine, keep)
        sel = torch.from_numpy(np.flatnonzero(
            _host_read(mask, "retain"))).to(mine.device)
        comp = {"data": self._components["data"].index_select(0, sel),
                "indices": mine.index_select(0, sel)}
        return RowSparseNDArray(comp, self._sparse_shape, self._ctx)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """``csr_matrix((data, indices, indptr), shape=(M, N))``, or from a
    dense array or NDArray (reference: ``mx.nd.sparse.csr_matrix``)."""
    dtype = to_torch_dtype(dtype)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("csr_matrix: shape required with components")
        if ctx is None and isinstance(data, NDArray):
            ctx = data.context
        ctx, dev = _ctx_device(ctx)
        comp = {"data": _tensor(data, dev, dtype),
                "indices": _index(indices, dev),
                "indptr": _index(indptr, dev)}
        return CSRNDArray(comp, shape, ctx)
    if isinstance(arg1, NDArray):
        ctx = ctx or arg1.context
        dense = _host_read(arg1._data, "csr_matrix of a dense array")
    else:
        dense = np.asarray(arg1)
    if dense.ndim != 2:
        raise MXNetError("csr_matrix: dense input must be 2-D")
    ctx, dev = _ctx_device(ctx)
    mask = dense != 0
    indptr = np.concatenate([[0], mask.sum(axis=1).cumsum()])
    rows, cols = np.nonzero(mask)
    comp = {"data": _tensor(dense[rows, cols], dev, dtype),
            "indices": _index(cols, dev), "indptr": _index(indptr, dev)}
    return CSRNDArray(comp, dense.shape, ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None) \
        -> RowSparseNDArray:
    """``row_sparse_array((data, indices), shape=...)``, or from a dense
    array or NDArray (reference: ``mx.nd.sparse.row_sparse_array``)."""
    dtype = to_torch_dtype(dtype)
    if isinstance(arg1, tuple) and len(arg1) == 2 and not \
            isinstance(arg1[0], int):
        data, indices = arg1
        if shape is None:
            raise MXNetError("row_sparse_array: shape required")
        if ctx is None and isinstance(data, NDArray):
            ctx = data.context
        ctx, dev = _ctx_device(ctx)
        return RowSparseNDArray({"data": _tensor(data, dev, dtype),
                                 "indices": _index(indices, dev)},
                                shape, ctx)
    if isinstance(arg1, NDArray):
        # the row mask goes to the host (O(rows) bytes), the rows are
        # gathered on the device
        d = arg1._data.detach()
        mask = (d.reshape(d.shape[0], -1) != 0).any(dim=1)
        nz = torch.from_numpy(np.flatnonzero(_host_read(
            mask, "tostype('row_sparse')"))).to(d.device)
        comp = {"data": d.index_select(0, nz).to(dtype or d.dtype),
                "indices": nz.to(torch.int32)}
        return RowSparseNDArray(comp, d.shape, ctx or arg1.context)
    dense = np.asarray(arg1)
    ctx, dev = _ctx_device(ctx)
    nz = np.flatnonzero((dense.reshape(dense.shape[0], -1) != 0).any(axis=1))
    return RowSparseNDArray({"data": _tensor(dense[nz], dev, dtype),
                             "indices": _index(nz, dev)}, dense.shape, ctx)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """reference: ``mx.nd.sparse.zeros``."""
    dt = to_torch_dtype(dtype)
    if stype == "default":
        from . import zeros as dense_zeros
        return dense_zeros(shape, ctx=ctx, dtype=dtype)
    ctx, dev = _ctx_device(ctx)
    idx = torch.zeros((0,), dtype=torch.int32, device=dev)
    if stype == "csr":
        return CSRNDArray({"data": torch.zeros((0,), dtype=dt, device=dev),
                           "indices": idx,
                           "indptr": torch.zeros((shape[0] + 1,),
                                                 dtype=torch.int32,
                                                 device=dev)}, shape, ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            {"data": torch.zeros((0,) + tuple(shape[1:]), dtype=dt,
                                 device=dev), "indices": idx}, shape, ctx)
    raise MXNetError(f"unknown stype {stype!r}")


empty = zeros


def array(source, ctx=None, dtype=None):
    """Sparse-preserving ``nd.sparse.array`` (reference)."""
    if isinstance(source, BaseSparseNDArray):
        return source.copy()
    raise MXNetError("sparse.array expects a sparse input; use "
                     "csr_matrix/row_sparse_array to construct")


def _from_dense(arr: NDArray, stype: str):
    if stype == "csr":
        return csr_matrix(arr)
    if stype == "row_sparse":
        return row_sparse_array(arr)
    raise MXNetError(f"unknown stype {stype!r}")


def tostype(arr, stype: str):
    """Storage conversion of a dense or sparse array."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    return _from_dense(arr, stype)


# ---------------------------------------------------------------------------
# sparse ops
# ---------------------------------------------------------------------------
def retain(data: RowSparseNDArray, indices):
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    return data.retain(indices)


def dot(lhs, rhs, transpose_a=False, transpose_b=False) -> NDArray:
    """``dot(csr, dense)`` and ``dot(csr.T, dense)``: the stored values
    times the gathered dense rows, added into the output rows
    (reference: ``src/operator/tensor/dot.cc``'s sparse paths).  Not
    recorded by autograd, as in the JAX package."""
    if not isinstance(lhs, CSRNDArray):
        from . import op
        return op.dot(lhs, rhs, transpose_a=transpose_a,
                      transpose_b=transpose_b)
    if transpose_b:
        raise MXNetError("dot(csr, dense, transpose_b=True) unsupported")
    data = lhs._components["data"]
    col = lhs._components["indices"].to(torch.int64)
    rows, cols = lhs.shape
    with torch.no_grad():
        dense = rhs._data.to(data.device)
        row_ids = lhs._row_ids()
        if not transpose_a:
            # out[r] = sum_j a[r, j] * dense[j]
            out = torch.zeros((rows, dense.shape[1]), dtype=data.dtype,
                              device=data.device)
            out.index_add_(0, row_ids, data[:, None] * dense[col])
        else:
            # out[c] = sum_r a[r, c] * dense[r]
            out = torch.zeros((cols, dense.shape[1]), dtype=data.dtype,
                              device=data.device)
            out.index_add_(0, col, data[:, None] * dense[row_ids])
    return NDArray._wrap(out, lhs.context)


def add(lhs, rhs) -> NDArray:
    """sparse + sparse or dense: a dense result (the JAX package's)."""
    with torch.no_grad():
        return NDArray._wrap(lhs._data + rhs._data, lhs.context)


elemwise_add = add
