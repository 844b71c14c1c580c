"""Linear-algebra operators of the PyTorch port: the ``_linalg_*`` family
(each also as ``linalg_*``) over ``torch.linalg``, which runs LAPACK on
the host's tensors and cuSOLVER / cuBLAS on the card's.

The counterpart of ``mxnet_tpu.ops.linalg``, with its output orders:
``gelqf`` returns (L, Q), ``syevd`` (V^T, w) with the eigenvectors as
rows; ``potri`` takes the lower Cholesky factor L and returns
inv(L L^T).  Eigenvectors are defined up to sign, and LAPACK and
cuSOLVER may pick different ones.
"""
from __future__ import annotations

import torch

from .registry import register


def _t(a):
    return a.transpose(-1, -2)


@register("_linalg_gemm", num_inputs=3, aliases=["linalg_gemm"])
def linalg_gemm(A, B, C, *, transpose_a: bool = False,
                transpose_b: bool = False, alpha: float = 1.0,
                beta: float = 1.0, axis: int = -2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_gemm2", num_inputs=2, aliases=["linalg_gemm2"])
def linalg_gemm2(A, B, *, transpose_a: bool = False,
                 transpose_b: bool = False, alpha: float = 1.0,
                 axis: int = -2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("_linalg_potrf", aliases=["linalg_potrf"])
def linalg_potrf(A):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(A)


@register("_linalg_potri", aliases=["linalg_potri"])
def linalg_potri(A):
    """inv(L L^T) from the lower Cholesky factor L."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("_linalg_trsm", num_inputs=2, aliases=["linalg_trsm"])
def linalg_trsm(A, B, *, transpose: bool = False, rightside: bool = False,
                lower: bool = True, alpha: float = 1.0):
    """op(A) X = alpha B (or X op(A) = alpha B with ``rightside``), A
    triangular."""
    a = _t(A) if transpose else A
    low = lower != transpose
    if rightside:
        return _t(torch.linalg.solve_triangular(_t(a), _t(alpha * B),
                                                upper=low))
    return torch.linalg.solve_triangular(a, alpha * B, upper=not low)


@register("_linalg_trmm", num_inputs=2, aliases=["linalg_trmm"])
def linalg_trmm(A, B, *, transpose: bool = False, rightside: bool = False,
                lower: bool = True, alpha: float = 1.0):
    a = _t(A) if transpose else A
    tri = torch.tril(a) if lower != transpose else torch.triu(a)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register("_linalg_syrk", aliases=["linalg_syrk"])
def linalg_syrk(A, *, transpose: bool = False, alpha: float = 1.0):
    return alpha * (torch.matmul(_t(A), A) if transpose
                    else torch.matmul(A, _t(A)))


@register("_linalg_sumlogdiag", aliases=["linalg_sumlogdiag"])
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("_linalg_extractdiag", aliases=["linalg_extractdiag"])
def linalg_extractdiag(A, *, offset: int = 0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("_linalg_makediag", aliases=["linalg_makediag"])
def linalg_makediag(A, *, offset: int = 0):
    return torch.diag_embed(A, offset=offset)


@register("_linalg_det", aliases=["linalg_det"])
def linalg_det(A):
    return torch.linalg.det(A)


@register("_linalg_slogdet", num_outputs=2, aliases=["linalg_slogdet"])
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("_linalg_inverse", aliases=["linalg_inverse"])
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("_linalg_gelqf", num_outputs=2, aliases=["linalg_gelqf"])
def linalg_gelqf(A):
    """LQ factorisation A = L Q, from the QR of A^T; returns (L, Q)."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("_linalg_syevd", num_outputs=2, aliases=["linalg_syevd"])
def linalg_syevd(A):
    """Symmetric eigendecomposition: (V^T, w), eigenvalues ascending."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w
