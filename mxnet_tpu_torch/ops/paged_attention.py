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
``csrc/ragged_paged_verify.cu``, built for ``sm_90a`` on first use; both
split long contexts across blocks by a plan made from shapes alone,
``_decode_plan`` / ``_verify_plan``, and B4 merges the partials in the
same launch through a workspace kept per device and stream) or
raises :class:`~mxnet_tpu_torch.base.KernelError` (an
:class:`MXNetError`) when the kernel cannot run the call — there is no
fallback.  A CPU tensor takes the plain PyTorch version
(``*_reference``), which is also what the kernels are checked against.

Shared contract (from the Pallas kernels): mask value -1e30, fp32
softmax statistics and accumulator over storage-dtype inputs, output in
the query dtype, exact zeros for a row with no visible key (an inactive
slot), and block-table entries past a sequence's context point at a
valid page (the null page 0) and are never read.  Each wrapper counts
its kernel launches in a plain integer attribute (``.launches``).  A
call made while its stream is capturing a CUDA graph launches nothing:
it records the kernel into the graph and is not counted; the graph's
replays run the kernel without calling the wrapper, so a profiler's
kernel records count them.  Neither wrapper reads a tensor back to the
host, so both can be captured.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

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
    # q, k, v, block_tables, context_lens, out, workspace, counters, B, H,
    # D, P, page_size, n_split, chunk, sm_scale, dtype, stream
    "ragged_paged_attention": (
        [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P]),
    "ragged_paged_verify": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, ctypes.c_float, _I, _P]),
}

# The launch plans of B4 (_decode_plan) and B5 (_verify_plan): the H100's
# SMs, the waves of blocks a split aims for, the fewest tokens a split's
# chunk holds, and the most pages (block-table entries in shared memory)
# it holds (csrc/ragged_paged_verify.cu kMaxChunkPages).
_SMS = 132
_WAVES = 4
# B4 aims for more waves than B5: its blocks hold one query row each, and
# on the H100 eight waves of ~96-token chunks beat four of ~176 at the
# serving batch (PERF.md, kernel table)
_DECODE_WAVES = 8
_MIN_CHUNK_TOKENS = 64
_MAX_CHUNK_PAGES = 4096


def _kernel(name):
    from . import build
    return build.entry(name, _ARGTYPES[name])


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
    page_size = k_pages.shape[1]
    plan = _decode_plan(B, H, D, bt.shape[1] * page_size, page_size)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        ws = counters = None
        if plan.workspace is not None:
            ws, counters = _decode_workspace(q.device, stream,
                                             plan.workspace)
        rc = _kernel("ragged_paged_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), B, H, D,
            bt.shape[1], page_size, plan.n_split, plan.chunk,
            float(sm_scale), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise KernelError(f"ragged_paged_attention: kernel launch failed "
                         f"with CUDA error {rc}")
    if not capturing:
        ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


class _DecodePlan(NamedTuple):
    """How B4 is launched: each (b, h) context split into ``n_split``
    chunks of ``chunk`` tokens (whole pages), and the fp32 partials'
    shape ``(n_split, B, H, D + 2)`` (``None`` when ``n_split == 1``)."""
    n_split: int
    chunk: int
    workspace: Optional[Tuple[int, ...]]


@functools.lru_cache(maxsize=256)
def _decode_plan(B, H, D, T, page_size):
    """B4's launch plan from shapes alone (no tensor is read, so the
    wrapper never waits on the card); ``T`` is the block tables' capacity
    in tokens (pages_per_seq * page_size).  Memoized: a decode step asks
    for the same plan once per layer.

    One block per (b, h, chunk).  When the B * H rows alone give fewer
    than two waves of blocks on the 132 SMs, each context is split into
    chunks of whole pages so the grid reaches ``_DECODE_WAVES`` waves, no
    chunk shorter than ``_MIN_CHUNK_TOKENS``; no chunk holds more than
    ``_MAX_CHUNK_PAGES`` pages."""
    rows = B * H
    pages = max(1, -(-T // page_size))
    want = 1 if rows >= 2 * _SMS \
        else -(-_DECODE_WAVES * _SMS // max(rows, 1))
    chunk_pages = max(-(-pages // want),
                      -(-_MIN_CHUNK_TOKENS // page_size))
    chunk_pages = min(chunk_pages, pages, _MAX_CHUNK_PAGES)
    n_split = -(-pages // chunk_pages)
    return _DecodePlan(n_split, chunk_pages * page_size,
                       (n_split, B, H, D + 2) if n_split > 1 else None)


_DECODE_WORKSPACES = {}


def _decode_workspace(device, stream, shape):
    """B4's fp32 partials ``shape = (n_split, B, H, D + 2)`` and its
    ``B * H`` int32 arrival counters for one (device, stream, shape):
    made on first use and kept, so a decode step allocates nothing and
    the addresses stay fixed.  The counters are zeroed once, here: the
    kernel's last block of each (b, h) sets its counter back to 0.
    Calls on one stream run in order, so they may share one workspace.

    Under CUDA-graph capture the stream is the capture stream, and the
    workspace must already exist (an eager call on that stream makes
    it, as ``serving.decode.PagedLMAdapter`` does before it captures):
    each graph then holds these fixed addresses.  Two graphs that share
    one workspace must never replay at the same time; the adapter's
    one engine thread runs its replays one after another."""
    key = (device, stream, shape)
    found = _DECODE_WORKSPACES.get(key)
    if found is None:
        found = (torch.empty(shape, dtype=torch.float32, device=device),
                 torch.zeros(shape[1] * shape[2], dtype=torch.int32,
                             device=device))
        _DECODE_WORKSPACES[key] = found
    return found


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


def _decode_split_reference(q, k_pages, v_pages, block_tables,
                            context_lens, n_split, chunk, sm_scale=None):
    """Plain mirror of B4's split arithmetic, for the tests (CPU
    tensors): each context cut into ``n_split`` chunks of ``chunk``
    tokens, each chunk's partial (acc, m, l) from an online softmax over
    16-token tiles from the chunk's start with P rounded to the storage
    dtype before P V, then the combine; exact zeros where the context is
    empty.  That is B5's split arithmetic for a one-row window ending at
    the context's last token, so it is :func:`_verify_split_reference`
    at W = 1."""
    lens = context_lens.long()
    out = _verify_split_reference(
        q[:, None], k_pages, v_pages, block_tables, (lens - 1).clamp(min=0),
        (lens > 0).long(), n_split, chunk, sm_scale)
    return out[:, 0]


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
    page_size = k_pages.shape[1]
    plan = _verify_plan(B, W, H, D, bt.shape[1] * page_size, page_size)
    out = torch.empty_like(q)
    ws = None
    if plan.workspace is not None:
        # per call: under CUDA-graph capture it comes from the graph's
        # memory pool, at an address fixed for the graph's replays
        ws = torch.empty(plan.workspace, dtype=torch.float32,
                         device=q.device)
    with torch.cuda.device(q.device):
        capturing = torch.cuda.is_current_stream_capturing()
        rc = _kernel("ragged_paged_verify")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(), st.data_ptr(), ln.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, W, H, D, bt.shape[1],
            page_size, plan.rows, plan.n_split, plan.chunk,
            float(sm_scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"ragged_paged_verify: kernel launch failed with "
                         f"CUDA error {rc}")
    if not capturing:
        ragged_paged_verify.launches += 1
    return out


ragged_paged_verify.launches = 0


class _VerifyPlan(NamedTuple):
    """How B5 is launched: ``rows`` query rows per block (16 or 64), the
    context split into ``n_split`` chunks of ``chunk`` tokens (whole
    pages), and the fp32 partials' shape ``(n_split, B, W, H, D + 2)``
    (``None`` when ``n_split == 1``)."""
    rows: int
    n_split: int
    chunk: int
    workspace: Optional[Tuple[int, ...]]


def _verify_plan(B, W, H, D, T, page_size):
    """B5's launch plan from shapes alone (no tensor is read, so the
    wrapper never waits on the card): ``T`` is the block tables' capacity
    in tokens (pages_per_seq * page_size).

    Row tiles of 16 rows for W <= 16, else 64.  When the row tiles alone
    give fewer than two waves of blocks on the 132 SMs, the context is
    split into chunks of whole pages so the grid reaches ``_WAVES`` waves,
    no chunk shorter than ``_MIN_CHUNK_TOKENS``; no chunk holds more than
    ``_MAX_CHUNK_PAGES`` pages."""
    rows = 16 if W <= 16 else 64
    tiles = B * H * -(-W // rows)
    pages = max(1, -(-T // page_size))
    want = 1 if tiles >= 2 * _SMS else -(-_WAVES * _SMS // max(tiles, 1))
    chunk_pages = max(-(-pages // want),
                      -(-_MIN_CHUNK_TOKENS // page_size))
    chunk_pages = min(chunk_pages, pages, _MAX_CHUNK_PAGES)
    n_split = -(-pages // chunk_pages)
    return _VerifyPlan(rows, n_split, chunk_pages * page_size,
                      (n_split, B, W, H, D + 2) if n_split > 1 else None)


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


def _verify_split_reference(q, k_pages, v_pages, block_tables, starts,
                            lengths, n_split, chunk, sm_scale=None):
    """Plain mirror of B5's split arithmetic, for the tests: the context
    cut into ``n_split`` chunks of ``chunk`` tokens, each chunk's partial
    (acc, m, l) from an online softmax over 16-key tiles with P rounded to
    the storage dtype before P V (as the kernel's warps do), then the
    merge kernel's combine; exact zeros where no key is visible."""
    B, W, H, D = q.shape
    T = block_tables.shape[1] * k_pages.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, T, H, D).float()
    v = v_pages[bt].reshape(B, T, H, D).float()
    s = torch.einsum("bwhd,bthd->bhwt", q.float(), k) * sm_scale
    rows = torch.arange(W)
    vis = ((torch.arange(T)[None, None, :]
            <= (starts.long()[:, None] + rows[None, :])[:, :, None])
           & (rows[None, :, None] < lengths.long()[:, None, None]))
    vis = vis[:, None]                                       # (B,1,W,T)
    parts = []
    for z in range(n_split):
        m = torch.full((B, H, W), _NEG_INF)
        l = torch.zeros(B, H, W)
        acc = torch.zeros(B, H, W, D)
        for kb in range(z * chunk, min((z + 1) * chunk, T), 16):
            sl = slice(kb, min(kb + 16, (z + 1) * chunk, T))
            vt = vis[..., sl]
            st = torch.where(vt, s[..., sl], _NEG_INF)
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(vt, torch.exp(st - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhwt,bthd->bhwd", p.to(v_pages.dtype).float(), v[:, sl])
            m = m_new
        parts.append((acc, m, l))
    m_all = torch.stack([m for _, m, _ in parts]).amax(0)
    l_all = sum(l * torch.exp(m - m_all) for _, m, l in parts)
    acc_all = sum(a * torch.exp(m - m_all)[..., None] for a, m, _ in parts)
    out = torch.where(l_all[..., None] != 0,
                      acc_all / torch.where(l_all == 0, 1.0, l_all)[..., None],
                      0.0)
    return out.transpose(1, 2).to(q.dtype)
