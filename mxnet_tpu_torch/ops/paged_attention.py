"""Ragged paged attention for the decode engine: decode (one query per
sequence) and verify (a causal window of queries per sequence) over a
paged KV pool read through per-sequence block tables.

The PyTorch port of the paged half of ``mxnet_tpu/ops/pallas_kernels.py``.
Each function keeps the JAX signature and tensor layouts:

- :func:`ragged_paged_attention` — q (B, H, D), pools
  (num_pages, page_size, H, D), block_tables (B, P), context_lens (B,);
- :func:`ragged_paged_verify` — q (B, W, H, D), the same pools and block
  tables, starts and lengths (B,).

Dispatch is by the tensors' device.  A CUDA tensor launches the
hand-written CUDA kernel (``csrc/ragged_paged_attention.cu``,
``csrc/ragged_paged_verify.cu``, built for ``sm_90a`` on first use) or
raises :class:`~mxnet_tpu_torch.base.KernelError` (an
:class:`MXNetError`) when the kernel cannot run the call — there is no
fallback.  A CPU tensor takes the plain PyTorch version
(``*_reference``), which is also what the kernels are checked against.

Shared contract (from the Pallas kernels): mask value -1e30, fp32
softmax statistics and accumulator over storage-dtype inputs, output in
the query dtype, exact zeros for a row with no visible key (an inactive
slot), and block-table entries past a sequence's context point at a
valid page (the null page 0) and are never read.  Each wrapper counts
its kernel launches in a plain integer attribute (``.launches``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import KernelError, MXNetError

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "ragged_paged_verify", "ragged_paged_verify_reference"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "ragged_paged_attention": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
         _P]),
    "ragged_paged_verify": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _I, _P]),
}
_FNS = {}


def _kernel(name):
    """The C entry point ``mxtt_<name>`` of ``csrc/<name>.cu`` with its
    ctypes signature declared (building the library on first use)."""
    fn = _FNS.get(name)
    if fn is None:
        from . import build
        fn = getattr(build.load(name), f"mxtt_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_launchable(name, q, k_pages, v_pages, ints):
    """Validate what the CUDA kernels take; returns the int32 index
    tensors (any integer dtype is accepted and cast, as the JAX kernels
    cast with ``astype``)."""
    dev = q.device
    for t in (k_pages, v_pages, *ints):
        if t.device != dev:
            raise KernelError(
                f"{name}: every tensor must be on {dev}, got one on "
                f"{t.device}")
    if q.dtype not in _DTYPE_CODE:
        raise KernelError(
            f"{name}: the CUDA kernel takes float32 or bfloat16, got "
            f"{q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise KernelError(
            f"{name}: q, k_pages and v_pages must share one dtype, got "
            f"{q.dtype} / {k_pages.dtype} / {v_pages.dtype}")
    D = q.shape[-1]
    if D not in _HEAD_DIMS:
        raise KernelError(
            f"{name}: the CUDA kernel takes head_dim in {_HEAD_DIMS} "
            f"(none > 256), got {D}")
    for label, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise KernelError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise KernelError(
                f"{name}: {label} must start on a 16-byte boundary (the "
                f"kernel reads 16-byte vectors)")
    out = []
    for t in ints:
        if t.dtype.is_floating_point or t.dtype.is_complex:
            raise KernelError(
                f"{name}: block tables and lengths must be integer "
                f"tensors, got {t.dtype}")
        out.append(t.to(torch.int32).contiguous())
    if k_pages.shape[0] * k_pages.shape[1] >= 2 ** 31:
        raise KernelError(f"{name}: pool of {k_pages.shape[0]} pages x "
                         f"{k_pages.shape[1]} slots exceeds int32 range")
    return out


# ---------------------------------------------------------------------------
# decode attention (B4)
# ---------------------------------------------------------------------------
def ragged_paged_attention(q, k_pages, v_pages, block_tables,
                           context_lens, sm_scale=None):
    """Decode attention over a paged KV cache.

    - ``q``: (B, H, D) — ONE query token per sequence slot;
    - ``k_pages`` / ``v_pages``: (num_pages, page_size, H, D) pool;
    - ``block_tables``: (B, pages_per_seq) int — physical page of each
      logical page of each sequence;
    - ``context_lens``: (B,) int — tokens of valid context per slot,
      INCLUDING the token whose K/V was just written; 0 = inactive slot
      (output row is zeros).

    Returns (B, H, D) in the query dtype.  CUDA tensors launch
    ``csrc/ragged_paged_attention.cu``; CPU tensors take
    :func:`ragged_paged_attention_reference`."""
    B, H, D = q.shape
    _n_pool, _page_size, HK, DK = k_pages.shape
    if (HK, DK) != (H, D) or v_pages.shape != k_pages.shape:
        raise MXNetError(
            f"ragged_paged_attention: q (B,H,D)={tuple(q.shape)} "
            f"inconsistent with k_pages {tuple(k_pages.shape)} / v_pages "
            f"{tuple(v_pages.shape)} (want (num_pages, page_size, {H}, "
            f"{D}))")
    if tuple(block_tables.shape[:1]) != (B,) or block_tables.dim() != 2 \
            or tuple(context_lens.shape) != (B,):
        raise MXNetError(
            f"ragged_paged_attention: block_tables "
            f"{tuple(block_tables.shape)} / context_lens "
            f"{tuple(context_lens.shape)} do not match batch {B}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, block_tables, context_lens, sm_scale)
    if q.device.type != "cuda":
        raise KernelError(f"ragged_paged_attention: no kernel for device "
                         f"{q.device}")
    bt, lens = _check_launchable("ragged_paged_attention", q, k_pages,
                                 v_pages, (block_tables, context_lens))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _kernel("ragged_paged_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(), lens.data_ptr(), out.data_ptr(), B, H, D,
            bt.shape[1], k_pages.shape[1], float(sm_scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"ragged_paged_attention: kernel launch failed "
                         f"with CUDA error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def ragged_paged_attention_reference(q, k_pages, v_pages, block_tables,
                                     context_lens, sm_scale=None):
    """Plain PyTorch version of :func:`ragged_paged_attention` — same
    signature and semantics (inactive ``context_lens == 0`` slots yield
    zeros).  Gathers each sequence's pages into a contiguous context and
    runs masked softmax attention in fp32."""
    B, H, D = q.shape
    page_size = k_pages.shape[1]
    n_pages = block_tables.shape[1]
    T = n_pages * page_size
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    lens = context_lens.long()
    k = k_pages[bt].reshape(B, T, H, D).float()
    v = v_pages[bt].reshape(B, T, H, D).float()
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * sm_scale
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    s = torch.where(valid[:, None, :], s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m) * valid[:, None, :]
    l = e.sum(-1, keepdim=True)                              # (B, H, 1)
    out = torch.einsum("bht,bthd->bhd", e, v)
    return (out / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


# ---------------------------------------------------------------------------
# multi-token verify attention (B5)
# ---------------------------------------------------------------------------
def ragged_paged_verify(q, k_pages, v_pages, block_tables, starts,
                        lengths, sm_scale=None):
    """Multi-token window attention over a paged KV cache.

    - ``q``: (B, W, H, D) — a W-token window per sequence slot;
    - ``k_pages`` / ``v_pages``: (num_pages, page_size, H, D) pool, the
      window's own K/V already written through the block table;
    - ``block_tables``: (B, pages_per_seq) int;
    - ``starts``: (B,) int — global position of each window's row 0;
    - ``lengths``: (B,) int — valid rows per window (0 = inactive
      slot).  Rows past ``lengths`` come back as zeros.

    Row ``w`` attends causally over positions ``0 .. starts[b] + w``.
    Returns (B, W, H, D) in the query dtype.  CUDA tensors launch
    ``csrc/ragged_paged_verify.cu``; CPU tensors take
    :func:`ragged_paged_verify_reference`."""
    B, W, H, D = q.shape
    _n_pool, _page_size, HK, DK = k_pages.shape
    if (HK, DK) != (H, D) or v_pages.shape != k_pages.shape:
        raise MXNetError(
            f"ragged_paged_verify: q (B,W,H,D)={tuple(q.shape)} "
            f"inconsistent with k_pages {tuple(k_pages.shape)} / v_pages "
            f"{tuple(v_pages.shape)} (want (num_pages, page_size, {H}, "
            f"{D}))")
    if tuple(block_tables.shape[:1]) != (B,) or block_tables.dim() != 2 \
            or tuple(starts.shape) != (B,) \
            or tuple(lengths.shape) != (B,):
        raise MXNetError(
            f"ragged_paged_verify: block_tables "
            f"{tuple(block_tables.shape)} / starts {tuple(starts.shape)} "
            f"/ lengths {tuple(lengths.shape)} do not match batch {B}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return ragged_paged_verify_reference(
            q, k_pages, v_pages, block_tables, starts, lengths, sm_scale)
    if q.device.type != "cuda":
        raise KernelError(f"ragged_paged_verify: no kernel for device "
                         f"{q.device}")
    bt, st, ln = _check_launchable("ragged_paged_verify", q, k_pages,
                                   v_pages, (block_tables, starts, lengths))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _kernel("ragged_paged_verify")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(), st.data_ptr(), ln.data_ptr(), out.data_ptr(),
            B, W, H, D, bt.shape[1], k_pages.shape[1], float(sm_scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"ragged_paged_verify: kernel launch failed with "
                         f"CUDA error {rc}")
    ragged_paged_verify.launches += 1
    return out


ragged_paged_verify.launches = 0


def ragged_paged_verify_reference(q, k_pages, v_pages, block_tables,
                                  starts, lengths, sm_scale=None):
    """Plain PyTorch version of :func:`ragged_paged_verify` — same
    signature and semantics (rows past ``lengths`` yield zeros)."""
    B, W, H, D = q.shape
    page_size = k_pages.shape[1]
    n_pages = block_tables.shape[1]
    T = n_pages * page_size
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    starts = starts.long()
    lengths = lengths.long()
    k = k_pages[bt].reshape(B, T, H, D).float()
    v = v_pages[bt].reshape(B, T, H, D).float()
    s = torch.einsum("bwhd,bthd->bhwt", q.float(), k) * sm_scale
    rows = torch.arange(W, device=q.device)
    row_pos = starts[:, None] + rows[None, :]                # (B, W)
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= row_pos[:, :, None]) \
        & (rows[None, :, None] < lengths[:, None, None])     # (B, W, T)
    s = torch.where(mask[:, None], s, _NEG_INF)              # (B,H,W,T)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m) * mask[:, None]
    l = e.sum(-1)                                            # (B, H, W)
    out = torch.einsum("bhwt,bthd->bwhd", e, v)
    denom = torch.where(l == 0.0, 1.0, l).transpose(1, 2)    # (B, W, H)
    return (out / denom[:, :, :, None]).to(q.dtype)
