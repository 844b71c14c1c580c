"""Blockwise and per-tensor int8/fp8 quantization, in plain torch ops.

The PyTorch port of ``mxnet_tpu.quantize``'s core and its serving half:

- the blockwise algebra (:func:`quantize`, :func:`dequantize`,
  :func:`quantize_with_feedback`) and its sizing (:func:`wire_bytes`,
  :func:`logical_bytes`) under one :class:`CompressionSpec`;
- the per-tensor serving path (:func:`tensor_scale`,
  :func:`quantize_tensor`, :func:`dequantize_tensor`) that
  ``deploy.export_stablehlo(quantize='int8'|'fp8')`` bakes into a
  manifest v4 artifact.

- the collective half (:func:`allreduce_sum`, :func:`allreduce_mean`
  and the many-tensor :func:`allreduce_mean_many` that
  ``parallel.ShardedTrainer(compression=...)`` runs) over a
  ``torch.distributed`` process group: each rank quantizes with error
  feedback, all-gathers the payload (fp8 as its ``uint8`` bits) and the
  per-block float32 scales, and dequantizes and sums in float32.

The kvstore's compression comes with the kvstore (ROADMAP item 6).

Numerical contract, as the reference's: the payload is widened to
float32, the scale applied in float32, and the result narrowed once to
the caller's dtype.  int8 is the symmetric codebook [-127, 127] rounded
half to even (``torch.round``, as ``jnp.round``); fp8 is
``float8_e4m3fn``, rounded by the cast.  Stochastic int8 rounding is
``floor(y + u)`` with ``u ~ U[0, 1)`` drawn from the caller's
``torch.Generator``.

Host data (numpy arrays, lists) is placed on ``device`` (``"cuda"``
unless the caller asks for the CPU); a tensor stays on its own device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError, get_env

__all__ = [
    "CompressionSpec", "quantize", "dequantize",
    "quantize_with_feedback", "allreduce_sum", "allreduce_mean",
    "allreduce_mean_many", "wire_bytes", "logical_bytes",
    "quantize_tensor", "dequantize_tensor", "tensor_scale",
]

# int8 uses the symmetric range [-127, 127] (-128 is never emitted, so
# dequantization needs no zero point); fp8 e4m3fn saturates at +-448
_QMAX = {"int8": 127.0, "fp8": 448.0}
_WIRE_ITEMSIZE = {"int8": 1, "fp8": 1}
_SCALE_ITEMSIZE = 4                          # one float32 scale a block
# the reference's float32 -> e4m3fn cast (ml_dtypes) turns |y| > 464,
# the rounding midpoint above 448, into NaN; torch's saturates to 448
_FP8_OVERFLOW = 464.0


class CompressionSpec:
    """Immutable description of one quantization policy.

    - ``kind``: ``'int8'`` (symmetric codebook, round-to-nearest or
      stochastic) or ``'fp8'`` (float8_e4m3fn payload; the cast rounds).
    - ``block``: elements per scale block.
    - ``stochastic``: int8 rounds stochastically (unbiased: E[q] = x);
      needs a ``torch.Generator`` at quantize time.
    - ``error_feedback``: carry the rounding error into the next step.
    """

    __slots__ = ("kind", "block", "stochastic", "error_feedback")

    def __init__(self, kind="int8", block=128, stochastic=False,
                 error_feedback=True):
        if kind not in _QMAX:
            raise MXNetError(
                f"CompressionSpec: unknown kind {kind!r} "
                f"(supported: {sorted(_QMAX)})")
        if kind == "fp8" and stochastic:
            raise MXNetError(
                "CompressionSpec: stochastic rounding is int8-only — "
                "the fp8 payload rounds in the e4m3 cast itself "
                "(round-to-nearest-even); silently ignoring the knob "
                "would hand back biased rounding where unbiased was "
                "asked for")
        block = int(block)
        if block < 1:
            raise MXNetError(
                f"CompressionSpec: block must be >= 1, got {block}")
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "block", block)
        object.__setattr__(self, "stochastic", bool(stochastic))
        object.__setattr__(self, "error_feedback", bool(error_feedback))

    def __setattr__(self, name, value):
        raise AttributeError("CompressionSpec is immutable")

    @classmethod
    def parse(cls, value):
        """``None`` | spec | ``'int8'`` | ``'int8:block=64,stochastic=1'``
        | ``{'type': 'int8', 'block': 64, ...}`` -> CompressionSpec|None.
        """
        if value is None:
            return None
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            text = value.strip()
            if not text or text.lower() == "none":
                return None
            kind, _, opts = text.partition(":")
            params = {"type": kind.strip()}
            for item in filter(None, opts.split(",")):
                k, sep, v = item.partition("=")
                if not sep:
                    raise MXNetError(
                        f"CompressionSpec: malformed option {item!r} in "
                        f"{value!r} (want key=value)")
                params[k.strip()] = v.strip()
            value = params
        if not isinstance(value, dict):
            raise MXNetError(f"CompressionSpec: cannot parse {value!r}")
        params = dict(value)
        kind = params.pop("type", params.pop("kind", "int8"))
        known = {"block", "stochastic", "error_feedback"}
        unknown = set(params) - known
        if unknown:
            raise MXNetError(
                f"CompressionSpec: unknown params {sorted(unknown)} "
                f"(known: {sorted(known)})")

        def as_bool(v):
            if isinstance(v, str):
                return v.strip().lower() not in ("0", "false", "no", "")
            return bool(v)

        return cls(kind=kind,
                   block=params.get("block", 128),
                   stochastic=as_bool(params.get("stochastic", False)),
                   error_feedback=as_bool(
                       params.get("error_feedback", True)))

    @classmethod
    def from_env(cls):
        """The ``MXNET_KVSTORE_GRAD_COMPRESSION`` default (None when
        unset)."""
        return cls.parse(get_env("MXNET_KVSTORE_GRAD_COMPRESSION"))

    @property
    def qmax(self) -> float:
        return _QMAX[self.kind]

    @property
    def wire_dtype(self):
        return torch.int8 if self.kind == "int8" else torch.float8_e4m3fn

    def key(self):
        """Hashable identity for program caches."""
        return (self.kind, self.block, self.stochastic,
                self.error_feedback)

    def __repr__(self):
        return (f"CompressionSpec({self.kind!r}, block={self.block}, "
                f"stochastic={self.stochastic}, "
                f"error_feedback={self.error_feedback})")

    def __eq__(self, other):
        return isinstance(other, CompressionSpec) \
            and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())


# ------------------------------------------------------------------ sizing
def _nblocks(n_elems: int, spec: CompressionSpec) -> int:
    return max(1, math.ceil(n_elems / spec.block))


def wire_bytes(n_elems: int, spec: CompressionSpec) -> int:
    """Bytes of the compressed form of an ``n_elems`` tensor: the
    block-padded 1-byte payload plus one float32 scale a block."""
    nb = _nblocks(n_elems, spec)
    return nb * spec.block * _WIRE_ITEMSIZE[spec.kind] \
        + nb * _SCALE_ITEMSIZE


def logical_bytes(n_elems: int, dtype) -> int:
    """Uncompressed size of ``n_elems`` elements of ``dtype`` (a torch
    dtype, a numpy dtype or a name such as ``"bfloat16"``)."""
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        dtype = getattr(torch, dtype)
    if isinstance(dtype, torch.dtype):
        return int(n_elems) * dtype.itemsize
    return int(n_elems) * np.dtype(dtype).itemsize


# -------------------------------------------------------------- quant core
def _f32(x, device):
    """``x`` as a float32 tensor: a tensor on its own device, host data
    on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _to_fp8(y):
    """float32 -> float8_e4m3fn as the reference's cast: torch's cast,
    with |y| > 464 (and +-inf) made NaN of y's sign where torch
    saturates to +-448."""
    q = y.to(torch.float8_e4m3fn)
    over = y.abs() > _FP8_OVERFLOW
    bits = q.view(torch.uint8)
    return torch.where(over, bits | 0x7F, bits).view(torch.float8_e4m3fn)


def _blockify(x, spec: CompressionSpec, device="cuda"):
    """Flatten and zero-pad to a block multiple -> (nb, block) float32."""
    flat = _f32(x, device).reshape(-1)
    n = flat.shape[0]
    nb = _nblocks(n, spec)
    pad = nb * spec.block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, spec.block)


def quantize(x, spec: CompressionSpec, key=None, device="cuda"):
    """Blockwise quantize ``x`` -> ``(payload, scales)``.

    ``payload`` is ``(nb, block)`` of ``spec.wire_dtype``; ``scales``
    is ``(nb,)`` float32 with ``x ~= payload * scales[:, None]``.
    Stochastic int8 rounding draws from ``key``, a ``torch.Generator``
    on the data's device (the reference takes a PRNG key there)."""
    blocks = _blockify(x, spec, device)
    amax = blocks.abs().amax(dim=1)
    # an all-zero block quantizes through scale 1 (guards 0/0); qmax is
    # a device tensor because CUDA divides by a host scalar through its
    # reciprocal, which is not the reference's division
    scales = torch.where(amax > 0.0, amax / amax.new_tensor(spec.qmax),
                         torch.ones_like(amax))
    y = blocks / scales[:, None]
    if spec.kind == "fp8":
        return _to_fp8(y), scales
    if spec.stochastic:
        if key is None:
            raise MXNetError(
                "quantize: stochastic rounding needs a PRNG key (a "
                "torch.Generator on the data's device)")
        # floor(y + u), u ~ U[0, 1): rounds up with probability frac(y)
        u = torch.rand(y.shape, generator=key, dtype=torch.float32,
                       device=y.device)
        q = torch.floor(y + u)
    else:
        q = torch.round(y)
    return torch.clamp(q, -spec.qmax, spec.qmax).to(torch.int8), scales


def dequantize(payload, scales, shape, dtype, n_elems=None):
    """Invert :func:`quantize` back to ``shape`` / ``dtype``: the
    widen-multiply in float32, then one narrowing cast."""
    flat = (payload.to(torch.float32) * scales[:, None]).reshape(-1)
    n = n_elems if n_elems is not None else math.prod(int(d) for d in shape)
    return flat[:n].reshape(tuple(shape)).to(dtype)


def quantize_with_feedback(grad, residual, spec: CompressionSpec,
                           key=None, device="cuda"):
    """Error-feedback quantize: ``(payload, scales, new_residual)``.

    The residual (float32, ``grad``'s shape) is added before quantizing;
    the new residual is what this quantization failed to represent.
    Without ``spec.error_feedback`` the residual comes back as zeros."""
    g32 = _f32(grad, device)
    residual = _f32(residual, g32.device)
    total = g32 + residual if spec.error_feedback else g32
    payload, scales = quantize(total, spec, key=key)
    if spec.error_feedback:
        deq = dequantize(payload, scales, total.shape, torch.float32)
        new_residual = total - deq
    else:
        new_residual = torch.zeros_like(residual)
    return payload, scales, new_residual


# ------------------------------------------------------- collectives
def _world(group):
    """The size of ``group``; None is a world of one (no collective)."""
    import torch.distributed as tdist
    return 1 if group is None else tdist.get_world_size(group)


def _allreduce_sum_many(xs, residuals, spec, group, keys):
    """Quantize every ``x`` (+ its residual) on this rank, all-gather the
    payloads and scales of all of them in one collective each, and
    dequantize and sum each tensor's contributions in float32.  Returns
    (the sums, each cast once to its ``x``'s dtype; the new
    residuals)."""
    from .parallel.sharding import all_gather
    fp8 = spec.kind == "fp8"
    payloads, scales, new_res, sizes = [], [], [], []
    for i, (x, r) in enumerate(zip(xs, residuals)):
        key = None if keys is None else keys[i]
        if isinstance(key, tuple):
            key, seed = key
            key.manual_seed(int(seed))
        payload, sc, nr = quantize_with_feedback(x, r, spec, key=key)
        flat = payload.reshape(-1)
        payloads.append(flat.view(torch.uint8) if fp8 else flat)
        scales.append(sc)
        new_res.append(nr)
        sizes.append((flat.numel(), sc.numel()))
    ndev = _world(group)
    got_p, got_s = torch.cat(payloads), torch.cat(scales)
    if group is not None:
        got_p, got_s = all_gather(got_p, group), all_gather(got_s, group)
    got_p, got_s = got_p.reshape(ndev, -1), got_s.reshape(ndev, -1)
    if fp8:
        got_p = got_p.view(torch.float8_e4m3fn)
    sums, po, so = [], 0, 0
    for x, (np_, ns) in zip(xs, sizes):
        q = got_p[:, po:po + np_].reshape(ndev, ns, -1)
        acc = (q.to(torch.float32) * got_s[:, so:so + ns, None]).sum(0)
        n = x.numel()
        sums.append(acc.reshape(-1)[:n].reshape(x.shape).to(x.dtype))
        po, so = po + np_, so + ns
    return sums, new_res


def allreduce_sum(x, residual, spec: CompressionSpec, group, key=None):
    """Quantized all-reduce sum over the process group ``group``: this
    rank quantizes ``x`` (+ its error-feedback ``residual``), every
    rank's compressed payload and scales are all-gathered (only the
    compressed bytes cross the wire), dequantized in float32 and summed.
    ``group=None`` is a world of one (the quantization alone).
    Returns ``(summed, new_residual)``: ``summed`` is the same on every
    rank, ``new_residual`` stays this rank's.  ``key``: a seeded
    ``torch.Generator`` for stochastic rounding."""
    keys = None if key is None else [key]
    sums, res = _allreduce_sum_many([x], [residual], spec, group, keys)
    return sums[0], res[0]


def _mean(summed, ndev, dtype):
    return (summed.to(torch.float32) / ndev).to(dtype)


def allreduce_mean(x, residual, spec: CompressionSpec, group, key=None):
    """:func:`allreduce_sum` divided by the group's size (the
    data-parallel gradient mean)."""
    summed, res = allreduce_sum(x, residual, spec, group, key=key)
    return _mean(summed, _world(group), x.dtype), res


def allreduce_mean_many(xs, residuals, spec: CompressionSpec, group,
                        keys=None):
    """:func:`allreduce_mean` of several tensors with one all-gather of
    payloads and one of scales (each tensor keeps its own blocks, as one
    call per tensor would).  ``keys``: None, or per tensor a
    ``(torch.Generator, seed)`` to seed before its stochastic rounding.
    Returns ``(means, new_residuals)``."""
    sums, res = _allreduce_sum_many(xs, residuals, spec, group, keys)
    ndev = _world(group)
    return [_mean(sm, ndev, x.dtype) for sm, x in zip(sums, xs)], res


# -------------------------------------------------- per-tensor (serving)
def tensor_scale(w, spec: CompressionSpec) -> float:
    """Per-tensor calibration scale: the float32 amax as a Python float
    over ``qmax`` in float64, 1.0 for an all-zero tensor."""
    if isinstance(w, torch.Tensor):
        amax = float(w.detach().to(torch.float32).abs().max())
    else:
        amax = float(np.max(np.abs(np.asarray(w, dtype=np.float32))))
    return amax / spec.qmax if amax > 0.0 else 1.0


def quantize_tensor(w, scale: float, spec: CompressionSpec, device="cuda"):
    """Whole-tensor quantize against a fixed ``scale`` (the serving
    export: one scale a weight tensor).  ``w`` is divided by the scale
    cast to float32.  With a caller's own scale an fp8 ``|w / scale|``
    can pass 448: above 464 the result is NaN, as the reference's cast
    gives (torch's own cast would saturate to 448)."""
    w32 = _f32(w, device)
    y = w32 / torch.tensor(scale, dtype=torch.float32, device=w32.device)
    if spec.kind == "int8":
        return torch.clamp(torch.round(y), -spec.qmax,
                           spec.qmax).to(torch.int8)
    return _to_fp8(y)


def dequantize_tensor(q, scale, dtype):
    """Widen a per-tensor quantized weight back: float32 multiply by the
    float32 scale (a float or a float32 tensor of one element), then one
    narrowing cast to ``dtype``.  An int8 payload is widened inside the
    multiply (one pass: torch promotes int8 x float32 to float32); fp8
    has no such promotion in torch and is widened first."""
    s = scale if isinstance(scale, torch.Tensor) \
        else torch.tensor(scale, dtype=torch.float32, device=q.device)
    if s.dim() != q.dim():
        s = s.reshape((1,) * q.dim())
    w = torch.mul(q, s) if q.dtype == torch.int8 \
        else q.to(torch.float32) * s
    return w if w.dtype == dtype else w.to(dtype)
