"""PyTorch port, paged attention: the port's plain decode (B4) and
verify (B5) attention against the JAX package's Pallas kernels (CPU
interpreter mode) and pure-jax references, on the same numpy inputs.

The port's CUDA kernels need a card; on CPU tensors the wrappers take
the plain versions tested here, and ``chip_smoke.py`` holds each kernel
against its plain version on the H100.  Tolerance: fp32, atol 1e-5
(the two frameworks sum in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import (
    ragged_paged_attention as jax_attention,
    ragged_paged_attention_reference as jax_attention_ref,
    ragged_paged_verify as jax_verify,
    ragged_paged_verify_reference as jax_verify_ref)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.paged_attention import (
    ragged_paged_attention, ragged_paged_attention_reference,
    ragged_paged_verify, ragged_paged_verify_reference)

ATOL = 1e-5


def _pool(seed, n_pages, page_size, H, D):
    rs = np.random.RandomState(seed)
    k = rs.randn(n_pages, page_size, H, D).astype(np.float32)
    v = rs.randn(n_pages, page_size, H, D).astype(np.float32)
    return k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("lens,pages_per_seq,page_size", [
    ([12, 5, 0], 3, 4),        # full table / partial last page / inactive
    ([8, 8], 2, 4),            # exact page boundary
    ([1, 3], 4, 4),            # single token / partial first page
    ([7], 1, 8),               # one sequence, one partially-filled page
])
def test_decode_attention_matches_jax(lens, pages_per_seq, page_size):
    rs = np.random.RandomState(42)
    B, H, D, n_pool = len(lens), 2, 8, 11
    q = rs.randn(B, H, D).astype(np.float32)
    k, v = _pool(1, n_pool, page_size, H, D)
    bt = rs.randint(1, n_pool, (B, pages_per_seq)).astype(np.int32)
    ln = np.asarray(lens, np.int32)
    want_kernel = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True))
    want_ref = np.asarray(jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(ln)))
    got = ragged_paged_attention(*_t(q, k, v, bt, ln)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    for b, L in enumerate(lens):
        if L == 0:
            assert np.all(got[b] == 0.0)        # inactive slot: zeros


def test_decode_block_table_indirection_is_honored():
    """Two sequences sharing identical context through DIFFERENT page
    orderings attend identically — the indirection defines the
    context."""
    rs = np.random.RandomState(7)
    H, D, ps = 2, 4, 4
    k, v = _pool(3, 6, ps, H, D)
    k[3], k[4] = k[1], k[2]
    v[3], v[4] = v[1], v[2]
    q1 = rs.randn(1, H, D).astype(np.float32)
    q = np.concatenate([q1, q1], 0)
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    ln = np.asarray([7, 7], np.int32)
    out = ragged_paged_attention(*_t(q, k, v, bt, ln)).numpy()
    np.testing.assert_allclose(out[0], out[1], atol=1e-6)


@pytest.mark.parametrize("starts,lens,W,pages_per_seq,page_size", [
    ([4, 0, 9], [3, 4, 0], 4, 4, 4),   # spec window / prefill / inactive
    ([0, 3], [8, 1], 8, 2, 4),         # whole-context window / width 1
    ([6, 5], [2, 3], 4, 3, 4),         # mid-page starts
    ([7], [1], 1, 1, 8),               # degenerate W=1 recovery shape
])
def test_verify_attention_matches_jax(starts, lens, W, pages_per_seq,
                                      page_size):
    rs = np.random.RandomState(17)
    B, H, D, n_pool = len(lens), 2, 8, 11
    q = rs.randn(B, W, H, D).astype(np.float32)
    k, v = _pool(5, n_pool, page_size, H, D)
    bt = rs.randint(1, n_pool, (B, pages_per_seq)).astype(np.int32)
    st = np.asarray(starts, np.int32)
    ln = np.asarray(lens, np.int32)
    jx = [jnp.asarray(a) for a in (q, k, v, bt, st, ln)]
    want_kernel = np.asarray(jax_verify(*jx, interpret=True))
    want_ref = np.asarray(jax_verify_ref(*jx))
    got = ragged_paged_verify(*_t(q, k, v, bt, st, ln)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    for b, L in enumerate(lens):
        assert np.all(got[b, L:] == 0.0)        # rows past lengths: zeros


def test_verify_width1_equals_decode_attention():
    """The W=1 verify window IS decode attention: start = ctx - 1,
    length 1 reproduces ragged_paged_attention for the same query."""
    rs = np.random.RandomState(23)
    B, H, D, ps = 3, 2, 4, 4
    q = rs.randn(B, H, D).astype(np.float32)
    k, v = _pool(9, 9, ps, H, D)
    bt = rs.randint(1, 9, (B, 3)).astype(np.int32)
    ctx = np.asarray([5, 12, 1], np.int32)
    dec = ragged_paged_attention(*_t(q, k, v, bt, ctx)).numpy()
    ver = ragged_paged_verify(*_t(q[:, None], k, v, bt, ctx - 1,
                                  np.ones((B,), np.int32))).numpy()
    np.testing.assert_allclose(ver[:, 0], dec, atol=1e-6)


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors each wrapper IS its plain version (no kernel
    launch, launch counters unchanged)."""
    rs = np.random.RandomState(5)
    q = rs.randn(2, 2, 8).astype(np.float32)
    k, v = _pool(4, 5, 4, 2, 8)
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    ln = np.asarray([6, 3], np.int32)
    before = (ragged_paged_attention.launches, ragged_paged_verify.launches)
    a = ragged_paged_attention(*_t(q, k, v, bt, ln))
    b = ragged_paged_attention_reference(*_t(q, k, v, bt, ln))
    assert torch.equal(a, b)
    qv = q[:, None]
    st = np.asarray([2, 0], np.int32)
    one = np.ones((2,), np.int32)
    c = ragged_paged_verify(*_t(qv, k, v, bt, st, one))
    d = ragged_paged_verify_reference(*_t(qv, k, v, bt, st, one))
    assert torch.equal(c, d)
    assert (ragged_paged_attention.launches,
            ragged_paged_verify.launches) == before


def test_shape_guards_raise():
    k, v = _pool(11, 4, 2, 1, 4)                # one head in the pool
    bt = np.zeros((1, 2), np.int32)
    with pytest.raises(MXNetError, match="inconsistent"):
        ragged_paged_verify(*_t(np.ones((1, 2, 2, 4), np.float32), k, v,
                                bt, np.zeros((1,), np.int32),
                                np.ones((1,), np.int32)))
    with pytest.raises(MXNetError, match="inconsistent"):
        ragged_paged_attention(*_t(np.ones((1, 2, 4), np.float32), k, v,
                                   bt, np.ones((1,), np.int32)))
    with pytest.raises(MXNetError, match="do not match batch"):
        ragged_paged_attention(*_t(np.ones((1, 1, 4), np.float32), k, v,
                                   np.zeros((2, 2), np.int32),
                                   np.ones((1,), np.int32)))


def test_kernel_guard_rejects_what_the_kernel_cannot_take():
    """The CUDA-side validation (run without a card): head_dim > 256,
    odd head_dims, mixed dtypes and non-contiguous inputs raise
    KernelError."""
    from mxnet_tpu_torch.base import KernelError
    from mxnet_tpu_torch.ops.paged_attention import _check_launchable
    ints = (torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))

    def check(q, kp):
        return _check_launchable("ragged_paged_attention", q, kp, kp, ints)

    with pytest.raises(KernelError, match="> 256"):
        check(torch.zeros(1, 1, 512), torch.zeros(3, 4, 1, 512))
    with pytest.raises(KernelError, match="head_dim in"):
        check(torch.zeros(1, 1, 24), torch.zeros(3, 4, 1, 24))
    with pytest.raises(KernelError, match="one dtype"):
        check(torch.zeros(1, 1, 64),
              torch.zeros(3, 4, 1, 64, dtype=torch.bfloat16))
    with pytest.raises(KernelError, match="float32 or bfloat16"):
        check(torch.zeros(1, 1, 64, dtype=torch.float16),
              torch.zeros(3, 4, 1, 64, dtype=torch.float16))
    with pytest.raises(KernelError, match="contiguous"):
        check(torch.zeros(1, 1, 128)[:, :, ::2],
              torch.zeros(3, 4, 1, 64))
    bt, ln = check(torch.zeros(1, 1, 64), torch.zeros(3, 4, 1, 64))
    assert bt.dtype == ln.dtype == torch.int32
