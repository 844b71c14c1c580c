"""Flash attention over (B*H, L, D) tensors: forward, backward, and the
interleaved self-attention front ends.

The PyTorch port of the flash half of ``mxnet_tpu/ops/pallas_kernels.py``:

- :func:`flash_attention` — the public function, with the JAX contract
  (per-row key ``lengths``, ``causal``, a causal sliding ``window``;
  ``Lq != Lk`` allowed).  It runs :class:`_Flash`, the
  ``torch.autograd.Function`` that takes the place of ``jax.custom_vjp``:
  its forward launches B1 and saves ``(q, k, v, lens, out, lse)``; its
  backward computes Delta = rowsum(dO * O) in fp32 with plain torch, as
  the JAX wrapper does, then launches B2 (dQ) and B3 (dK, dV).
  ``lengths`` gets no gradient.
- :func:`flash_selfatt` / :func:`flash_selfatt_nomask` — the interleaved
  layout (L, B, H*3*D) -> (L, B, H*D) of the JAX registry ops.
- The kernel entry points :func:`flash_attention_fwd` (B1,
  ``csrc/flash_attention_fwd.cu``), :func:`flash_attention_bwd_dq` (B2,
  ``csrc/flash_attention_bwd_dq.cu``) and :func:`flash_attention_bwd_dkv`
  (B3, ``csrc/flash_attention_bwd_dkv.cu``), each with a launch count in
  ``.launches``, and their plain PyTorch versions (``*_reference``).
  B1 is also the registered operator
  ``torch.ops.mxnet_tpu_torch.flash_attention_fwd``
  (:data:`flash_attention_fwd_op`, registered by importing this module;
  its impl is the wrapper), which :class:`_Flash` calls, so that
  ``torch.export`` keeps one node per call and a loaded artifact
  launches the kernel.

Dispatch is by the tensors' device.  A CUDA tensor launches the kernel or
raises :class:`~mxnet_tpu_torch.base.KernelError` — there is no
fallback.  A CPU tensor takes the plain version, which is also what the
kernels are checked against; any other device raises.  On meta tensors
(shapes only, as :meth:`ShardedTrainer.step_flops` runs a
step) :class:`_Flash` makes its outputs by the call's model products as
dense ``bmm`` on meta (:func:`_meta_products`), so that
``torch.utils.flop_counter.FlopCounterMode`` counts the model FLOPs of
kernels it cannot see inside.  A wrapper counts in ``.launches`` the
launches it makes; under CUDA-graph capture it records the kernel into
the graph and counts nothing, and a replay does not call it.  Inside
B1, B2 and B3 the C entry point picks the kernel by dtype: bf16 runs
the tensor-core (``wgmma``) kernels; fp32 B1, B2 and B3 run their
products on the tensor cores as
error-compensated 3xTF32 (each operand split into two TF32 halves,
three ``mma.sync`` products, fp32-accurate; :func:`_fwd_tf32_mirror`
and :func:`_bwd_tf32_mirror` repeat that arithmetic on the CPU).
On the card the kernels take head dims 16, 32, 64 and 128
(``_HEAD_DIMS``; 256 and any other raise ``KernelError``); in bf16 the
wrappers zero-pad a head dim under 64 to 64 columns for the tensor cores
and slice O and the gradients back.

Contract (from the Pallas kernels): mask value -1e30; fp32 softmax
statistics and accumulators; inputs stay in their storage dtype; P, and
dS in the backward, are rounded to the storage dtype before their
products; O in the query dtype, LSE (B*H, Lq, 1) fp32.  Departure: a
query row that sees no key (a ``lengths == 0`` row, or a padding row
under ``window`` and ``lengths`` together) gets O = 0, LSE = -1e30 and
zero gradients, and P is exactly 0 wherever the mask is false; the
Pallas forward left block-size-dependent values in such rows.  The
tiles are fixed constants of the kernels (64 x 64), so the JAX
``block_q`` / ``block_k`` / ``interpret`` arguments and the
``MXNET_FLASH_BLOCK_*`` knobs have no counterpart.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import KernelError, MXNetError

__all__ = ["flash_attention", "flash_selfatt", "flash_selfatt_nomask",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_op",
           "flash_attention_fwd_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the CUDA kernels take.  D = 256 is refused: the fp32
# backward's tiles need 399 KB (B2) and 400 KB (B3) of shared memory, over
# the H100's 227 KB, and bf16 B3's two 64 x 256 fp32 accumulators need
# 256 registers a thread, over 255.
_HEAD_DIMS = (16, 32, 64, 128)
# The bf16 kernels (wgmma) read 128-byte swizzled lines of 64 columns; a
# narrower bf16 head dim is zero-padded to this width.
_WGMMA_D = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # q, k, v, lens, out, lse, BH, Lq, Lk, D, scale, causal, window,
    # dtype, stream
    "flash_attention_fwd": [_P] * 6 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # q, k, v, dout, lens, lse, delta, dq, ...
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # q, k, v, dout, lens, lse, delta, dk, dv, ...
    "flash_attention_bwd_dkv": [_P] * 9 + [_I] * 4 + [_F, _I, _I, _I, _P],
}


def _kernel(name):
    from . import build
    return build.entry(name, _ARGTYPES[name])


def _check_launchable(name, tensors, lens, row_stats=()):
    """Validate what the CUDA kernels take: one device, one storage
    dtype (fp32 or bf16), a compiled head dim, contiguous 16-byte-aligned
    tensors, int32 lengths and fp32 row statistics."""
    q = tensors[0]
    dev = q.device
    for t in (*tensors, lens, *row_stats):
        if t.device != dev:
            raise KernelError(f"{name}: every tensor must be on {dev}, got "
                              f"one on {t.device}")
    if q.dtype not in _DTYPE_CODE:
        raise KernelError(f"{name}: the CUDA kernel takes float32 or "
                          f"bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in tensors):
        raise KernelError(f"{name}: q, k, v (and dout) must share one "
                          f"dtype, got {[t.dtype for t in tensors]}")
    D = q.shape[-1]
    if D not in _HEAD_DIMS:
        raise KernelError(f"{name}: the CUDA kernel takes head_dim in "
                          f"{_HEAD_DIMS}, got {D}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise KernelError(f"{name}: inputs must be contiguous and start "
                              f"on a 16-byte boundary")
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        raise KernelError(f"{name}: lengths must be contiguous int32")
    for t in row_stats:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise KernelError(f"{name}: lse and delta must be contiguous "
                              f"float32")
    BH = q.shape[0]
    if BH > 2 ** 31 - 1 or max(q.shape[1], tensors[1].shape[1]) \
            > 65535 * 64:
        raise KernelError(f"{name}: shape {tuple(q.shape)} exceeds the "
                          f"launch grid")


def _visible(Lq, Lk, lens, causal, window, device):
    """(BH, Lq, Lk) bool: which key each query row sees."""
    r = torch.arange(Lq, device=device)[:, None]
    c = torch.arange(Lk, device=device)[None, :]
    mask = c[None] < lens.long()[:, None, None]
    if causal:
        mask = mask & (c <= r)[None]
        if window > 0:
            mask = mask & (c >= r - (window - 1))[None]
    return mask


def _pad_for_wgmma(*tensors):
    """bf16 inputs of B1-B3 with a head dim under 64, zero-padded to 64
    columns (``None`` when no padding is needed).  Exact: a zero column
    adds nothing to S, dP, Delta or any product, a zero column of V gives
    a zero column of O, and ``sm_scale`` comes from the caller's true
    head dim."""
    D = tensors[0].shape[-1]
    if tensors[0].dtype != torch.bfloat16 or D >= _WGMMA_D:
        return None
    return [torch.nn.functional.pad(t, (0, _WGMMA_D - D)) for t in tensors]


def _launch(name, *args):
    rc = _kernel(name)(*args)
    if rc != 0:
        raise KernelError(f"{name}: kernel launch failed with CUDA error "
                          f"{rc}")


def _meta_products(kind, q, k, v, dout=None):
    """The outputs of B1 (``kind="fwd"``), B2 (``"dq"``) or B3
    (``"dkv"``) on meta tensors, made by the model's dense products of
    the call: B1 S = Q K^T and O = P V; B2 dP = dO V^T and dQ = dS K;
    B3 dK = dS^T Q and dV = P^T dO.  Each is 4 * BH * Lq * Lk * D FLOPs,
    12 for a forward and backward, with neither the kernels'
    recomputation of S and dP nor the tiles they skip under a mask.
    Meta tensors hold no data, so nothing is computed."""
    BH, Lq, _ = q.shape
    if kind == "fwd":
        p = torch.bmm(q, k.transpose(1, 2))
        return (torch.bmm(p, v),
                q.new_empty((BH, Lq, 1), dtype=torch.float32))
    if kind == "dq":
        return torch.bmm(torch.bmm(dout, v.transpose(1, 2)), k)
    pt = q.new_empty((BH, k.shape[1], Lq))       # P^T and dS^T
    return torch.bmm(pt, q), torch.bmm(pt, dout)


# ---------------------------------------------------------------------------
# B1: forward
# ---------------------------------------------------------------------------
def flash_attention_fwd(q, k, v, lens, causal, sm_scale, window):
    """Forward of flash attention: ``(out (BH, Lq, D) in q's dtype,
    lse (BH, Lq, 1) fp32)``.  ``lens`` (BH,) int32 key lengths;
    ``window <= 0`` means none.  CUDA tensors launch
    ``csrc/flash_attention_fwd.cu``; CPU tensors take
    :func:`flash_attention_fwd_reference`."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, lens, causal,
                                             sm_scale, window)
    if q.device.type != "cuda":
        raise KernelError(f"flash_attention_fwd: no kernel for device "
                          f"{q.device}")
    _check_launchable("flash_attention_fwd", (q, k, v), lens)
    D = q.shape[-1]
    padded = _pad_for_wgmma(q, k, v)
    if padded is not None:
        q, k, v = padded
    BH, Lq, DK = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, Lq, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        capturing = torch.cuda.is_current_stream_capturing()
        _launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                lse.data_ptr(), BH, Lq, k.shape[1], DK, float(sm_scale),
                int(bool(causal)), int(window), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if not capturing:
        flash_attention_fwd.launches += 1
    return (out if padded is None else out[..., :D].contiguous()), lse


flash_attention_fwd.launches = 0


# B1 as a registered operator, so that ``torch.export`` records one node
# per call instead of tracing through the wrapper's ctypes launch (or the
# plain version): a loaded artifact then reaches the kernel wherever
# ``mxnet_tpu_torch.ops`` is imported.  The impl is the wrapper itself,
# so device dispatch and ``flash_attention_fwd.launches`` are unchanged;
# the fake gives the output shapes to tracing (meta tensors never get
# here: ``_Flash`` makes their outputs first).  Outputs never alias the
# inputs.
flash_attention_fwd_op = torch.library.custom_op(
    "mxnet_tpu_torch::flash_attention_fwd", flash_attention_fwd,
    mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor lens, bool causal, "
           "float sm_scale, int window) -> (Tensor, Tensor)")


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, lens, causal, sm_scale, window):
    return (q.new_empty(q.shape),
            q.new_empty((q.shape[0], q.shape[1], 1), dtype=torch.float32))


def flash_attention_fwd_reference(q, k, v, lens, causal, sm_scale, window):
    """Plain PyTorch version of :func:`flash_attention_fwd`: a dense
    masked softmax in fp32 over storage-dtype inputs, P rounded to the
    storage dtype before P V; rows with no visible key give O = 0 and
    LSE = -1e30."""
    BH, Lq, D = q.shape
    mask = _visible(Lq, k.shape[1], lens, causal, window, q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    out = (acc / safe_l).to(q.dtype)
    lse = torch.where(empty, _NEG_INF, m + torch.log(safe_l))
    return out, lse


# ---------------------------------------------------------------------------
# B2: backward, dQ
# ---------------------------------------------------------------------------
def flash_attention_bwd_dq(q, k, v, dout, lens, lse, delta, causal,
                           sm_scale, window):
    """dQ of flash attention, in q's dtype.  ``lse`` and ``delta``:
    (BH, Lq, 1) fp32.  CUDA tensors launch
    ``csrc/flash_attention_bwd_dq.cu``; CPU tensors take
    :func:`flash_attention_bwd_dq_reference`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, dout, lens, lse,
                                                delta, causal, sm_scale,
                                                window)
    if q.device.type != "cuda":
        raise KernelError(f"flash_attention_bwd_dq: no kernel for device "
                          f"{q.device}")
    _check_launchable("flash_attention_bwd_dq", (q, k, v, dout), lens,
                      (lse, delta))
    D = q.shape[-1]
    padded = _pad_for_wgmma(q, k, v, dout)
    if padded is not None:
        q, k, v, dout = padded
    BH, Lq, DK = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        capturing = torch.cuda.is_current_stream_capturing()
        _launch("flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(), lens.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, Lq,
                k.shape[1], DK, float(sm_scale), int(bool(causal)),
                int(window), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if not capturing:
        flash_attention_bwd_dq.launches += 1
    return dq if padded is None else dq[..., :D].contiguous()


flash_attention_bwd_dq.launches = 0


def _bwd_common(q, k, v, dout, lens, lse, delta, causal, sm_scale,
                window):
    """P (exactly 0 where masked) and dS, both fp32 (BH, Lq, Lk)."""
    mask = _visible(q.shape[1], k.shape[1], lens, causal, window, q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dout.float(), v.float())
    ds = p * (dp - delta) * sm_scale
    return p, ds


def flash_attention_bwd_dq_reference(q, k, v, dout, lens, lse, delta,
                                     causal, sm_scale, window):
    """Plain PyTorch version of :func:`flash_attention_bwd_dq`: dense
    P = exp(S - LSE) (0 where masked), dS = P * (dP - Delta) * scale
    rounded to the storage dtype, dQ = dS K accumulated in fp32."""
    _p, ds = _bwd_common(q, k, v, dout, lens, lse, delta, causal,
                         sm_scale, window)
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


# ---------------------------------------------------------------------------
# B3: backward, dK and dV
# ---------------------------------------------------------------------------
def flash_attention_bwd_dkv(q, k, v, dout, lens, lse, delta, causal,
                            sm_scale, window):
    """``(dk, dv)`` of flash attention in k's and v's dtype.  CUDA
    tensors launch ``csrc/flash_attention_bwd_dkv.cu``; CPU tensors take
    :func:`flash_attention_bwd_dkv_reference`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, dout, lens, lse,
                                                 delta, causal, sm_scale,
                                                 window)
    if q.device.type != "cuda":
        raise KernelError(f"flash_attention_bwd_dkv: no kernel for device "
                          f"{q.device}")
    _check_launchable("flash_attention_bwd_dkv", (q, k, v, dout), lens,
                      (lse, delta))
    D = q.shape[-1]
    padded = _pad_for_wgmma(q, k, v, dout)
    if padded is not None:
        q, k, v, dout = padded
    BH, Lq, DK = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        capturing = torch.cuda.is_current_stream_capturing()
        _launch("flash_attention_bwd_dkv", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(), lens.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), BH, Lq, k.shape[1], DK, float(sm_scale),
                int(bool(causal)), int(window), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if not capturing:
        flash_attention_bwd_dkv.launches += 1
    if padded is not None:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dkv_reference(q, k, v, dout, lens, lse, delta,
                                      causal, sm_scale, window):
    """Plain PyTorch version of :func:`flash_attention_bwd_dkv`: dV =
    P^T dO and dK = dS^T Q with P and dS rounded to the storage dtype,
    accumulated in fp32."""
    p, ds = _bwd_common(q, k, v, dout, lens, lse, delta, causal, sm_scale,
                        window)
    dv = torch.einsum("bqk,bqd->bkd", p.to(dout.dtype).float(),
                      dout.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the fp32 kernels' tensor-core arithmetic, on the CPU
# ---------------------------------------------------------------------------
def _round_tf32(x):
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits, ties away
    from zero), the kernels' ``cvt.rna.tf32.f32``: half a TF32 ulp is
    added to the magnitude and the 13 dropped bits are cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_tf32(a, b, passes=3):
    """``a @ b`` in fp32 with every product as the fp32 B1-B3 kernels
    issue it: ``passes=3`` is 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi,
    hi = tf32(x), lo = tf32(x - hi)); ``passes=1`` is one TF32 product.
    A product of two TF32 values is exact in fp32."""
    a_hi, b_hi = _round_tf32(a), _round_tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _round_tf32(a - a_hi), _round_tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _fwd_tf32_mirror(q, k, v, lens, causal, sm_scale, window, passes=3):
    """``(out, lse)`` of fp32 B1 with S = Q K^T and P V done as
    :func:`_matmul_tf32` does them, and the masking and empty-row rules
    of :func:`flash_attention_fwd_reference` (whose products are fp32):
    the CPU model of the kernel's 3xTF32 arithmetic."""
    mask = _visible(q.shape[1], k.shape[1], lens, causal, window, q.device)
    s = torch.where(mask, _matmul_tf32(q, k.transpose(1, 2), passes)
                    * sm_scale, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    out = _matmul_tf32(p, v, passes) / safe_l
    return out, torch.where(empty, _NEG_INF, m + torch.log(safe_l))


def _bwd_tf32_mirror(q, k, v, dout, lens, lse, delta, causal, sm_scale,
                     window, passes=3):
    """``(dq, dk, dv)`` of fp32 B2 and B3 with their products done as
    :func:`_matmul_tf32` does them (the plain versions use fp32
    products): the CPU model of the kernels' 3xTF32 arithmetic."""
    mask = _visible(q.shape[1], k.shape[1], lens, causal, window, q.device)
    s = _matmul_tf32(q, k.transpose(1, 2), passes) * sm_scale
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = _matmul_tf32(dout, v.transpose(1, 2), passes)
    ds = p * (dp - delta) * sm_scale
    return (_matmul_tf32(ds, k, passes),
            _matmul_tf32(ds.transpose(1, 2), q, passes),
            _matmul_tf32(p.transpose(1, 2), dout, passes))


# ---------------------------------------------------------------------------
# autograd and the public front ends
# ---------------------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """Flash attention with B1 forward and B2 + B3 backward (the
    counterpart of the JAX ``_flash`` custom VJP); on meta tensors, the
    shapes and model products of :func:`_meta_products`."""

    @staticmethod
    def forward(ctx, q, k, v, lens, causal, sm_scale, window):
        if q.device.type == "meta":
            out, lse = _meta_products("fwd", q, k, v)
        else:
            out, lse = flash_attention_fwd_op(q, k, v, lens, causal,
                                              sm_scale, window)
        ctx.save_for_backward(q, k, v, lens, out, lse)
        ctx.args = (causal, sm_scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lens, out, lse = ctx.saved_tensors
        causal, sm_scale, window = ctx.args
        dout = dout.contiguous()
        if q.device.type == "meta":
            return (_meta_products("dq", q, k, v, dout),
                    *_meta_products("dkv", q, k, v, dout),
                    None, None, None, None)
        delta = (dout.float() * out.float()).sum(-1, keepdim=True)
        dq = flash_attention_bwd_dq(q, k, v, dout, lens, lse, delta, causal,
                                    sm_scale, window)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lens, lse, delta,
                                         causal, sm_scale, window)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, lengths=None, causal=False, sm_scale=None,
                    window=None):
    """Fused attention over (B*H, L, D) tensors, differentiable in q, k
    and v.

    ``lengths``: optional (B*H,) integer valid key lengths (a padding
    mask).  ``window``: optional causal sliding-window width — query q
    attends keys in [q - window + 1, q]; key tiles out of the window are
    skipped.  Requires ``causal=True``.  ``Lq != Lk`` is allowed (causal
    compares absolute positions).  Returns (B*H, Lq, D) in the query
    dtype."""
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    if k.shape != (BH, Lk, D) or v.shape != k.shape:
        raise MXNetError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"agree on (B*H, L, D)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if window is not None:
        if not causal:
            raise MXNetError("flash_attention: window requires causal=True")
        if int(window) < 1:
            raise MXNetError(f"flash_attention: window must be >= 1, got "
                             f"{window}")
    if lengths is None:
        lens = torch.full((BH,), Lk, dtype=torch.int32, device=q.device)
    else:
        if tuple(lengths.shape) != (BH,):
            raise MXNetError(f"flash_attention: lengths "
                             f"{tuple(lengths.shape)} does not match B*H "
                             f"{BH}")
        lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        lens, bool(causal), float(sm_scale),
                        -1 if window is None else int(window))


def _split_qkv(qkv, heads):
    """(L, B, H*3*D) interleaved per head [q|k|v] -> q, k, v as
    (B*H, L, D)."""
    L, B, H3D = qkv.shape
    D = H3D // (heads * 3)
    x = qkv.reshape(L, B, heads, 3, D)
    return [x[:, :, :, i].permute(1, 2, 0, 3).reshape(B * heads, L, D)
            for i in range(3)]


def _merge_heads(out, L, B, heads):
    """(B*H, L, D) -> (L, B, H*D)."""
    D = out.shape[-1]
    return out.reshape(B, heads, L, D).permute(2, 0, 1, 3).reshape(
        L, B, heads * D)


def flash_selfatt(queries_keys_values, valid_length, heads=1,
                  causal=False, window=-1):
    """Flash self-attention over the interleaved layout: ``qkv`` (L, B,
    H*3*D) -> (L, B, H*D).  ``valid_length``: (B,) float or int valid
    KEY lengths.  ``window > 0``: causal sliding-window attention."""
    L, B, _ = queries_keys_values.shape
    q, k, v = _split_qkv(queries_keys_values, heads)
    lens = valid_length.to(torch.int32).repeat_interleave(heads)
    out = flash_attention(q, k, v, lengths=lens, causal=causal,
                          window=None if window <= 0 else window)
    return _merge_heads(out, L, B, heads)


def flash_selfatt_nomask(queries_keys_values, heads=1, causal=False,
                         window=-1):
    """:func:`flash_selfatt` without a padding mask (full key length)."""
    L, B, _ = queries_keys_values.shape
    q, k, v = _split_qkv(queries_keys_values, heads)
    out = flash_attention(q, k, v, causal=causal,
                          window=None if window <= 0 else window)
    return _merge_heads(out, L, B, heads)
