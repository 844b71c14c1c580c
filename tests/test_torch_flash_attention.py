"""PyTorch port, flash attention: the port's ``flash_attention`` (its
``_Flash`` autograd function over the plain versions of kernels B1-B3,
which CPU tensors take) against the JAX package's Pallas
``flash_attention`` run in interpreter mode on the CPU, on the same numpy
inputs; the cases of ``tests/test_pallas.py``.

The CUDA kernels need a card: ``chip_smoke.py`` holds each against its
plain version on the H100.  Tolerances: fp32 atol 1e-5 on outputs and
1e-4 on gradients (the two frameworks sum in different orders); bf16
inputs against the fp32 dense oracle within 0.06, as the JAX test holds
its own kernel; bf16 gradients against the JAX package's within 1e-2 of
each gradient's max.  Rows that see no key are compared only where both
packages define them (``lengths == 0`` rows: zeros); the port writes
zeros for every such row (a departure from the Pallas forward).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import nd
from mxnet_tpu.ops.pallas_kernels import _flash_fwd as _jax_flash_fwd
from mxnet_tpu.ops.pallas_kernels import flash_attention as jax_flash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa

ATOL, GRAD_ATOL = 1e-5, 1e-4


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(BH=4, L=48, D=16, seed=0, Lk=None):
    Lk = L if Lk is None else Lk
    return (_rand((BH, L, D), seed), _rand((BH, Lk, D), seed + 100),
            _rand((BH, Lk, D), seed + 200))


def _jax(q, k, v, lens=None, **kw):
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    return jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     lengths=jl, block_q=16, block_k=16, **kw)


def _port(q, k, v, lens=None, **kw):
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    return fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              lengths=tl, **kw)


def _grads(q, k, v, cot, lens=None, **kw):
    """(q, k, v) gradients of sum(flash(q, k, v) * cot), both packages."""
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    jg = jax.grad(lambda a, b, c: (jax_flash(
        a, b, c, lengths=jl, block_q=16, block_k=16, **kw) * cot).sum(),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = fa.flash_attention(tq, tk, tv, lengths=tl, **kw)
    tg = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                             (tq, tk, tv))
    return [np.asarray(g) for g in jg], [g.numpy() for g in tg]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_lens", [False, True])
def test_forward_matches_jax(causal, with_lens):
    q, k, v = _qkv()
    lens = [48, 17, 32, 5] if with_lens else None
    want = np.asarray(_jax(q, k, v, lens, causal=causal))
    got = _port(q, k, v, lens, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_nondivisible_length_matches_jax():
    """L = 37: the JAX wrapper pads to its blocks and slices back; the
    port's kernels mask the ragged edge themselves."""
    q, k, v = _qkv(BH=2, L=37, D=8, seed=3)
    np.testing.assert_allclose(_port(q, k, v).numpy(),
                               np.asarray(_jax(q, k, v)), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_unequal_query_and_key_lengths_match_jax(causal):
    q, k, v = _qkv(BH=3, L=37, D=8, seed=4, Lk=53)
    lens = [53, 20, 7]
    np.testing.assert_allclose(
        _port(q, k, v, lens, causal=causal).numpy(),
        np.asarray(_jax(q, k, v, lens, causal=causal)), atol=ATOL)


def test_grads_match_jax():
    q, k, v = _qkv(seed=7)
    cot = _rand(q.shape, 8)
    jg, tg = _grads(q, k, v, cot, lens=[48, 20, 48, 9], causal=True)
    for want, got in zip(jg, tg):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_noncausal_grads_with_lengths_match_jax():
    q, k, v = _qkv(BH=3, L=37, D=8, seed=9)
    cot = _rand(q.shape, 10)
    jg, tg = _grads(q, k, v, cot, lens=[37, 11, 30])
    for want, got in zip(jg, tg):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_sliding_window_forward_and_grads_match_jax():
    q, k, v = _qkv(BH=2, L=48, D=8, seed=11)
    out_j = np.asarray(_jax(q, k, v, causal=True, window=12))
    out_t = _port(q, k, v, causal=True, window=12)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=ATOL)
    cot = _rand(q.shape, 12)
    jg, tg = _grads(q, k, v, cot, causal=True, window=12)
    for want, got in zip(jg, tg):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_window_requires_causal_and_positive():
    q, k, v = (torch.zeros(1, 16, 8) for _ in range(3))
    with pytest.raises(MXNetError, match="causal"):
        fa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(MXNetError, match=">= 1"):
        fa.flash_attention(q, k, v, causal=True, window=0)


def test_bf16_inputs_close_to_fp32_dense():
    """bf16 storage (fp32 statistics): within bf16-grade tolerance of
    the fp32 dense oracle, as ``test_pallas.py`` holds the JAX kernel."""
    q, k, v = _qkv(BH=4, L=64, D=16, seed=0)
    out = fa.flash_attention(*(torch.from_numpy(a).bfloat16()
                               for a in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    D = q.shape[-1]
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(D)
    s[:, np.triu(np.ones((64, 64), bool), k=1)] = -1e30
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("bqk,bkd->bqd", p, v)
    assert np.abs(out.float().numpy() - ref).max() < 0.06


@pytest.mark.parametrize("L", [64, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_grads_match_jax(L, causal):
    """bf16 (dQ, dK, dV): the port's backward (B2/B3's plain versions on
    the CPU) against ``jax.grad`` of the Pallas kernel in interpreter
    mode, on the same bf16-rounded inputs and cotangent, D = 64, with
    lengths (one row of length 0).  This pins the rounding contract of
    the bf16 tensor-core kernels: P and dS are rounded to bf16 before
    their products on both sides.  Each gradient is held to 1e-2 of its
    max: gradients are stored in bf16, whose ulp at the max is 2^-8 of
    it, and the sums run in other orders (and JAX's forward O, hence
    Delta, rounds P against a running max), so a value may land on a
    neighbouring bf16."""
    q, k, v = (torch.from_numpy(_rand((3, L, 64), s)).bfloat16()
               for s in (31, 131, 231))
    cot = torch.from_numpy(_rand((3, L, 64), 32)).bfloat16().float()
    lens = [L, 20, 0]
    jl = jnp.asarray(lens, jnp.int32)
    jg = jax.grad(lambda a, b, c: (jax_flash(
        a, b, c, lengths=jl, causal=causal, block_q=16,
        block_k=16).astype(jnp.float32) * cot.numpy()).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                             for t in (q, k, v)))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal,
                             lengths=torch.tensor(lens, dtype=torch.int32))
    tg = torch.autograd.grad((out.float() * cot).sum(), (tq, tk, tv))
    for name, want, got in zip("qkv", jg, tg):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        assert np.all(got[2] == 0), f"d{name}: the length-0 row"
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-2, f"d{name}: {err} of max"


def test_flash_selfatt_matches_interleaved_chain():
    """flash_selfatt == interleaved qk -> masked softmax -> valatt (the
    JAX registry ops), and == the JAX flash_selfatt."""
    L, B, H, D = 24, 3, 2, 8
    qkv = _rand((L, B, H * 3 * D), 0)
    valid = np.array([24, 10, 17], np.float32)
    scores = nd.interleaved_matmul_selfatt_qk(nd.array(qkv), heads=H)
    neg = np.zeros((B, 1, 1, L), np.float32)
    for b in range(B):
        neg[b, 0, 0, np.arange(L) >= int(valid[b])] = -1e30
    mask = nd.array(np.broadcast_to(neg, (B, H, L, L)).reshape(
        B * H, L, L).copy())
    dense = nd.interleaved_matmul_selfatt_valatt(
        nd.array(qkv), nd.softmax(scores + mask, axis=-1), heads=H)
    got = fa.flash_selfatt(torch.from_numpy(qkv), torch.from_numpy(valid),
                           heads=H)
    np.testing.assert_allclose(got.numpy(), dense.asnumpy(), atol=1e-4)
    jflash = nd.flash_selfatt(nd.array(qkv), nd.array(valid), heads=H)
    np.testing.assert_allclose(got.numpy(), jflash.asnumpy(), atol=ATOL)
    full = fa.flash_selfatt_nomask(torch.from_numpy(qkv), heads=H)
    jfull = nd.flash_selfatt_nomask(nd.array(qkv), heads=H)
    np.testing.assert_allclose(full.numpy(), jfull.asnumpy(), atol=ATOL)


def test_zero_length_rows_give_zeros_and_zero_grads():
    q, k, v = _qkv(BH=3, L=40, D=8, seed=5)
    lens = [40, 0, 9]
    cot = _rand(q.shape, 6)
    got = _port(q, k, v, lens, causal=True)
    want = np.asarray(_jax(q, k, v, lens, causal=True))
    assert np.all(got[1].numpy() == 0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    jg, tg = _grads(q, k, v, cot, lens=lens, causal=True)
    for want_g, got_g in zip(jg, tg):
        assert np.all(got_g[1] == 0)
        np.testing.assert_allclose(got_g, want_g, atol=GRAD_ATOL)
    _, lse = fa.flash_attention_fwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor(lens, dtype=torch.int32), True, 8 ** -0.5, -1)
    assert lse.shape == (3, 40, 1) and torch.all(lse[1] == -1e30)


def test_rows_with_no_visible_key_are_zero():
    """window + lengths: padding query rows past length + window - 1 see
    no key.  The port gives them O = 0 and LSE = -1e30 (the Pallas
    forward leaves block-size-dependent values there); rows that see a
    key match JAX."""
    q, k, v = _qkv(BH=2, L=48, D=8, seed=13)
    lens, w = [10, 48], 4
    got = _port(q, k, v, lens, causal=True, window=w).numpy()
    want = np.asarray(_jax(q, k, v, lens, causal=True, window=w))
    empty = np.arange(48) >= lens[0] + w - 1
    assert np.all(got[0, empty] == 0)
    np.testing.assert_allclose(got[0, ~empty], want[0, ~empty], atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL)
    # gradients of the rows that see a key: dO is zero on the empty rows
    cot = _rand(q.shape, 14)
    cot[0, empty] = 0.0
    jg, tg = _grads(q, k, v, cot, lens=lens, causal=True, window=w)
    for want_g, got_g in zip(jg, tg):
        np.testing.assert_allclose(got_g, want_g, atol=GRAD_ATOL)


def test_plain_backward_pieces_match_autograd_of_dense():
    """B2 and B3's plain versions (through _Flash) equal autograd of a
    dense masked softmax in the port itself, Lq != Lk with lengths."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv(BH=2, L=19, D=8, seed=21, Lk=33))
    lens = torch.tensor([33, 12], dtype=torch.int32)
    cot = torch.from_numpy(_rand((2, 19, 8), 22))
    g_flash = torch.autograd.grad((fa.flash_attention(
        q, k, v, lengths=lens, causal=True) * cot).sum(), (q, k, v))
    mask = fa._visible(19, 33, lens, True, -1, "cpu")
    s = torch.where(mask, q @ k.transpose(1, 2) / np.sqrt(8), -1e30)
    dense = torch.softmax(s, -1) @ v
    g_dense = torch.autograd.grad((dense * cot).sum(), (q, k, v))
    for a, b in zip(g_flash, g_dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)


def test_cpu_never_counts_a_kernel_launch():
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    q, k, v = (torch.randn(2, 16, 8, requires_grad=True) for _ in range(3))
    fa.flash_attention(q, k, v).sum().backward()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before


def test_kernel_guards_refuse_before_launching():
    """The CUDA path validates in Python before any pointer is passed:
    an unsupported head dim or dtype raises KernelError."""
    from mxnet_tpu_torch.base import KernelError
    q = torch.zeros(1, 8, 24)
    lens = torch.full((1,), 8, dtype=torch.int32)
    with pytest.raises(KernelError, match="head_dim"):
        fa._check_launchable("flash_attention_fwd", (q, q, q), lens)
    with pytest.raises(KernelError, match="float32 or bfloat16"):
        h = torch.zeros(1, 8, 64, dtype=torch.float16)
        fa._check_launchable("flash_attention_fwd", (h, h, h), lens)
    with pytest.raises(KernelError, match="no kernel for device"):
        m = torch.zeros(1, 8, 64, device="meta")
        fa.flash_attention_fwd(m, m, m, lens, False, 0.125, -1)


@pytest.mark.parametrize("D", [16, 32])
def test_narrow_head_dims_match_jax(D):
    """The head dims the CUDA kernels gained (16, 32): forward and the
    three gradients against the JAX package's Pallas kernel, causal with
    key lengths."""
    q, k, v = _qkv(BH=3, L=40, D=D, seed=30 + D)
    lens = [40, 17, 3]
    np.testing.assert_allclose(
        _port(q, k, v, lens, causal=True).numpy(),
        np.asarray(_jax(q, k, v, lens, causal=True)), atol=ATOL)
    jg, tg = _grads(q, k, v, _rand(q.shape, 40 + D), lens=lens, causal=True)
    for want, got in zip(jg, tg):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_cuda_head_dims_are_the_stated_set():
    """The head dims the CUDA kernels take (README and PERF.md state the
    same set): 16, 32, 64 and 128; 8, 24 and 256 raise KernelError."""
    from mxnet_tpu_torch.base import KernelError
    assert fa._HEAD_DIMS == (16, 32, 64, 128)
    lens = torch.full((1,), 8, dtype=torch.int32)
    for D in fa._HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.zeros(1, 8, D, dtype=dt)
            fa._check_launchable("flash_attention_bwd_dkv", (q, q, q, q),
                                 lens, (torch.zeros(1, 8, 1),) * 2)
    for D in (8, 24, 256):
        q = torch.zeros(1, 8, D)
        with pytest.raises(KernelError, match="head_dim"):
            fa._check_launchable("flash_attention_fwd", (q, q, q), lens)


@pytest.mark.parametrize("D", [16, 32])
def test_bf16_forward_padding_to_64_columns_is_exact(D):
    """bf16 B1 runs the tensor-core kernel at 64 columns: the wrapper
    zero-pads q, k and v and slices O back.  On the plain version the
    padded call gives the unpadded one's O (within one bf16 rounding:
    fp32 sums over 64 columns may group differently) and LSE, with
    ``sm_scale`` from the true head dim, and zero columns beyond D."""
    BH, L = 3, 40
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(BH=BH, L=L, D=D, seed=60 + D))
    lens = torch.tensor([40, 9, 0], dtype=torch.int32)
    sc = 1.0 / D ** 0.5
    out, lse = fa.flash_attention_fwd_reference(q, k, v, lens, True, sc, -1)
    padded = fa._pad_for_wgmma(q, k, v)
    assert [t.shape[-1] for t in padded] == [fa._WGMMA_D] * 3
    assert all(t.is_contiguous() for t in padded)
    out_p, lse_p = fa.flash_attention_fwd_reference(*padded, lens, True, sc,
                                                    -1)
    torch.testing.assert_close(out_p[..., :D].float(), out.float(),
                               rtol=2 ** -7, atol=1e-6)
    assert torch.all(out_p[..., D:] == 0)
    torch.testing.assert_close(lse_p, lse, rtol=0, atol=1e-6)
    assert torch.all(out_p[2] == 0) and torch.all(lse_p[2] == -1e30)
    assert fa._pad_for_wgmma(q.float(), k.float(), v.float()) is None


@pytest.mark.parametrize("D", [16, 32])
def test_bf16_backward_padding_to_64_columns_is_exact(D):
    """bf16 B2/B3 run the tensor-core kernels at 64 columns: the wrapper
    zero-pads q, k, v and dO and slices the gradients back.  On the plain
    versions the padded call gives the unpadded one's gradients (within
    one bf16 rounding: fp32 sums over 64 columns may group differently)
    and zero columns beyond D."""
    BH, L = 2, 40
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(BH=BH, L=L, D=D, seed=50))
    do = torch.from_numpy(_rand((BH, L, D), 51)).to(torch.bfloat16)
    lens = torch.tensor([40, 9], dtype=torch.int32)
    sc = 1.0 / D ** 0.5
    out, lse = fa.flash_attention_fwd_reference(q, k, v, lens, True, sc, -1)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (lens, lse, delta, True, sc, -1)
    padded = fa._pad_for_wgmma(q, k, v, do)
    assert [t.shape[-1] for t in padded] == [fa._WGMMA_D] * 4
    assert all(t.is_contiguous() for t in padded)
    dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, *args)
    dq_p = fa.flash_attention_bwd_dq_reference(*padded, *args)
    dk, dv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, *args)
    dk_p, dv_p = fa.flash_attention_bwd_dkv_reference(*padded, *args)
    for got, want in ((dq_p, dq), (dk_p, dk), (dv_p, dv)):
        torch.testing.assert_close(got[..., :D].float(), want.float(),
                                   rtol=2 ** -7, atol=1e-6)
        assert torch.all(got[..., D:] == 0)
    assert fa._pad_for_wgmma(q.float(), k.float(), v.float(),
                             do.float()) is None


# ---------------------------------------------------------------------------
# fp32 B2/B3 run their products as 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------
def _tf32_numpy(x):
    """Round-to-nearest, ties away from zero, to 11 significant bits (TF32)
    in float64 arithmetic: an independent reference of ``_round_tf32``
    (normal fp32 values)."""
    m, e = np.frexp(x.astype(np.float64))
    m = np.sign(m) * np.floor(np.abs(m) * 2048.0 + 0.5) / 2048.0
    return np.ldexp(m, e).astype(np.float32)


def test_round_tf32_matches_numpy_bits_and_fixes_tf32_values():
    x = (_rand((4096,), 70) * np.float32(3.7)) * np.exp2(
        np.random.RandomState(71).randint(-60, 60, 4096)).astype(np.float32)
    got = fa._round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _tf32_numpy(x).view(np.uint32))
    # ties go away from zero: 1 + 2^-11 lies halfway between two TF32 values
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 3 * 2 ** -11 + 1],
                    np.float32)
    np.testing.assert_array_equal(
        fa._round_tf32(torch.from_numpy(ties)).numpy(),
        np.array([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9], np.float32))
    # values that are TF32 already (and 0, -0) come back bit for bit
    for v in (got, np.array([0.0, -0.0, 1.0, -2.5, 2.0 ** -100],
                            np.float32)):
        again = fa._round_tf32(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(again.view(np.uint32),
                                      v.view(np.uint32))


def test_tf32_split_of_the_mask_value_and_zero():
    """The kernels split each operand into hi = tf32(x) and lo =
    tf32(x - hi).  A masked 0 splits into (0, 0).  The mask value -1e30
    is not a TF32 value (hi is its TF32 neighbour), but hi + lo gives it
    back exactly; the kernels never round it (P = 0 comes from the mask,
    not from exp)."""
    x = torch.tensor([0.0, -1e30])
    hi = fa._round_tf32(x)
    lo = fa._round_tf32(x - hi)
    assert hi[0] == 0 and lo[0] == 0
    assert float(hi[1]) == float(_tf32_numpy(np.float32([-1e30]))[0])
    assert hi[1] != x[1] and hi[1] + lo[1] == x[1]


def _grads_tf32(passes, q, k, v, cot, lens, **kw):
    """``_grads`` with the port's backward done in the fp32 kernels'
    arithmetic (``_bwd_tf32_mirror``, ``passes`` TF32 products each)."""
    def dq(*a):
        return fa._bwd_tf32_mirror(*a, passes=passes)[0]

    def dkv(*a):
        return fa._bwd_tf32_mirror(*a, passes=passes)[1:]
    mp = pytest.MonkeyPatch()
    mp.setattr(fa, "flash_attention_bwd_dq_reference", dq)
    mp.setattr(fa, "flash_attention_bwd_dkv_reference", dkv)
    try:
        return _grads(q, k, v, cot, lens=lens, **kw)
    finally:
        mp.undo()


def _rel_errs(got, want):
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


_TF32_CASE = dict(BH=4, L=80, D=32, seed=21)
_TF32_LENS = [80, 33, 1, 64]


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_matches_jax(causal):
    """B2/B3's arithmetic with every product as 3xTF32 against the JAX
    package's backward: within 1e-5 of each gradient's max|.| (fp32
    sums differ from it by ~1e-6 here too), ragged lengths over 80 rows
    (a partial second tile of the kernels' 64)."""
    q, k, v = _qkv(**_TF32_CASE)
    cot = _rand(q.shape, 22)
    jg, tg = _grads_tf32(3, q, k, v, cot, _TF32_LENS, causal=causal)
    assert max(_rel_errs(tg, jg)) <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_pass_is_100x_further_off(causal):
    """One TF32 product (hi x hi) is at least 100 times further from the
    JAX backward than 3xTF32 on the same inputs: the kernels' accuracy
    comes from the split."""
    q, k, v = _qkv(**_TF32_CASE)
    cot = _rand(q.shape, 22)
    jg, g3 = _grads_tf32(3, q, k, v, cot, _TF32_LENS, causal=causal)
    _, g1 = _grads_tf32(1, q, k, v, cot, _TF32_LENS, causal=causal)
    for e3, e1 in zip(_rel_errs(g3, jg), _rel_errs(g1, jg)):
        assert e1 >= 100 * e3, (e1, e3)


def _jax_fwd(q, k, v, lens, causal):
    """The JAX package's forward (its Pallas kernel in interpreter mode,
    16 x 16 blocks): ``(out, lse)`` as numpy."""
    out, res = _jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lens, jnp.int32), causal, 1.0 / np.sqrt(q.shape[-1]),
        16, 16, True, -1)
    return np.asarray(out), np.asarray(res[5])


def _fwd_mirror(passes, q, k, v, lens, causal):
    """fp32 B1's arithmetic on the CPU (``_fwd_tf32_mirror``)."""
    out, lse = fa._fwd_tf32_mirror(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor(lens, dtype=torch.int32), causal,
        1.0 / np.sqrt(q.shape[-1]), -1, passes=passes)
    return out.numpy(), lse.numpy()


def _fwd_errs(got, want):
    """O's largest error as a share of max|O|, and LSE's absolute one."""
    (o, lse), (want_o, want_lse) = got, want
    return (float(np.abs(o - want_o).max() / np.abs(want_o).max()),
            float(np.abs(lse - want_lse).max()))


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_forward_matches_jax(causal):
    """fp32 B1's arithmetic with S = Q K^T and P V as 3xTF32 against the
    JAX package's forward: O within 1e-5 of max|O|, LSE within 1e-5
    (fp32 sums differ from it by ~1e-7 here), ragged lengths over 80
    rows (a partial second tile of the kernel's 64)."""
    q, k, v = _qkv(**_TF32_CASE)
    want = _jax_fwd(q, k, v, _TF32_LENS, causal)
    err_o, err_lse = _fwd_errs(_fwd_mirror(3, q, k, v, _TF32_LENS, causal),
                               want)
    assert err_o <= 1e-5 and err_lse <= 1e-5, (err_o, err_lse)


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_pass_forward_is_100x_further_off(causal):
    """One TF32 product in S and in P V is at least 100 times further
    from the JAX forward than 3xTF32, in O and in LSE."""
    q, k, v = _qkv(**_TF32_CASE)
    want = _jax_fwd(q, k, v, _TF32_LENS, causal)
    e3 = _fwd_errs(_fwd_mirror(3, q, k, v, _TF32_LENS, causal), want)
    e1 = _fwd_errs(_fwd_mirror(1, q, k, v, _TF32_LENS, causal), want)
    assert e1[0] >= 100 * e3[0] and e1[1] >= 100 * e3[1], (e1, e3)


@pytest.mark.parametrize("passes", [1, 3])
def test_tf32_forward_mirror_empty_rows(passes):
    """A ``lengths == 0`` row gives O = 0 and LSE = -1e30 in the mirror,
    exactly as in the plain version; the other rows agree with it, to
    1e-5 in 3xTF32 and to 2e-3 in one TF32 pass (11 significant bits:
    ~8e-4 here)."""
    q, k, v = _qkv(**_TF32_CASE)
    lens = [80, 0, 33, 0]
    out, lse = _fwd_mirror(passes, q, k, v, lens, True)
    r_out, r_lse = fa.flash_attention_fwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor(lens, dtype=torch.int32), True,
        1.0 / np.sqrt(q.shape[-1]), -1)
    for b in (1, 3):
        assert np.all(out[b] == 0) and np.all(lse[b] == -1e30)
        assert torch.all(r_out[b] == 0) and torch.all(r_lse[b] == -1e30)
    tol = 1e-5 if passes == 3 else 2e-3
    np.testing.assert_allclose(out, r_out.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(lse, r_lse.numpy(), rtol=0, atol=tol)
