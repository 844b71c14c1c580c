"""PyTorch port, B5's split context: the plain mirror of the verify
kernel's split and merge (``_verify_split_reference``) against the JAX
package's Pallas ``ragged_paged_verify`` (CPU interpreter mode) and its
pure-jax reference, and the launch plan ``_verify_plan``'s invariants.

The CUDA kernel itself needs a card (``chip_smoke.py`` holds it against
the plain version on the H100).  Tolerances: fp32 atol 1e-5 (other
summation orders); bf16 inputs atol 2e-2 (P is rounded to bf16 before
P V against each 16-key tile's running max, the Pallas kernel rounds it
against each page's, the pure-jax reference not at all).
"""
import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import (
    ragged_paged_verify as jax_verify,
    ragged_paged_verify_reference as jax_verify_ref)
from mxnet_tpu_torch.ops import paged_attention as pa

H, D, PAGE, N_POOL = 2, 8, 4, 40
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# per width: starts and lengths of 3 slots (the last inactive or short)
CASES = {
    1: ([0, 13, 30], [1, 1, 0]),
    5: ([3, 0, 26], [5, 2, 0]),
    17: ([0, 9, 14], [17, 3, 0]),
    33: ([2, 0, 1], [33, 20, 7]),
}


def _inputs(W):
    starts, lens = CASES[W]
    rs = np.random.RandomState(100 + W)
    pages = -(-(max(starts) + W) // PAGE)
    q = rs.randn(3, W, H, D).astype(np.float32)
    k = rs.randn(N_POOL, PAGE, H, D).astype(np.float32)
    v = rs.randn(N_POOL, PAGE, H, D).astype(np.float32)
    bt = np.stack([rs.permutation(N_POOL - 1)[:pages] + 1
                   for _ in range(3)]).astype(np.int32)
    return (q, k, v, bt, np.asarray(starts, np.int32),
            np.asarray(lens, np.int32))


@functools.lru_cache(maxsize=None)
def _jax_outputs(W, dtype):
    q, k, v, bt, st, ln = _inputs(W)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    args = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [
        jnp.asarray(a) for a in (bt, st, ln)]
    kern = np.asarray(jax_verify(*args, interpret=True).astype(jnp.float32))
    ref = np.asarray(jax_verify_ref(*args).astype(jnp.float32))
    return kern, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", sorted(CASES))
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
def test_split_mirror_matches_jax(n_split, W, dtype):
    q, k, v, bt, st, ln = _inputs(W)
    T = bt.shape[1] * PAGE
    chunk = -(-(-(-T // n_split)) // PAGE) * PAGE       # whole pages
    assert n_split * chunk >= T
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(dt) for a in (q, k, v)] + [
        torch.from_numpy(a) for a in (bt, st, ln)]
    got = pa._verify_split_reference(*args, n_split=n_split, chunk=chunk)
    assert got.dtype == dt
    got = got.float().numpy()
    want_kernel, want_ref = _jax_outputs(W, dtype)
    np.testing.assert_allclose(got, want_kernel, atol=TOL[dtype])
    np.testing.assert_allclose(got, want_ref, atol=TOL[dtype])
    plain = pa.ragged_paged_verify_reference(*args).float().numpy()
    np.testing.assert_allclose(got, plain, atol=TOL[dtype])
    for b, n in enumerate(ln):
        assert np.all(got[b, n:] == 0.0)    # rows past lengths, inactive


def test_split_mirror_empty_chunks_are_exact():
    """Chunks wholly past every row's horizon add nothing: 7 splits of
    one page over a context whose rows see at most 9 keys give the same
    bits as one split over the same keys."""
    q, k, v, bt, st, ln = _inputs(5)
    st, ln = np.asarray([0, 4, 0], np.int32), np.asarray([5, 5, 0],
                                                         np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, bt, st, ln)]
    T = bt.shape[1] * PAGE
    one = pa._verify_split_reference(*args, n_split=1, chunk=T)
    many = pa._verify_split_reference(*args, n_split=7, chunk=PAGE)
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=1e-6)
    assert torch.all(many[2] == 0)


def test_split_mirror_rounds_p_like_the_kernel():
    """bf16: the mirror rounds P to bf16 before P V, so it moves away
    from the unrounded plain version, but stays within the bf16 limit."""
    q, k, v, bt, st, ln = _inputs(17)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)] + [
        torch.from_numpy(a) for a in (bt, st, ln)]
    T = bt.shape[1] * PAGE
    got = pa._verify_split_reference(*args, n_split=1, chunk=T).float()
    plain = pa.ragged_paged_verify_reference(*args).float()
    err = float((got - plain).abs().max())
    assert 0.0 < err < TOL["bfloat16"]


@pytest.mark.parametrize("B,W,H,T,page_size", [
    (8, 1, 12, 1024, 16), (8, 5, 12, 1024, 16), (8, 256, 12, 1024, 16),
    (1, 64, 12, 1024, 16), (1, 1, 1, 16, 16), (2, 33, 3, 40, 4),
    (3, 17, 2, 7, 1), (64, 16, 16, 2048, 16), (1, 1, 12, 1 << 17, 16),
    (4, 300, 8, 4096, 8),
])
def test_verify_plan_invariants(B, W, H, T, page_size):
    D = 64
    plan = pa._verify_plan(B, W, H, D, T, page_size)
    assert plan.rows == (16 if W <= 16 else 64)
    assert plan.chunk % page_size == 0 and plan.chunk > 0
    assert plan.chunk // page_size <= pa._MAX_CHUNK_PAGES
    assert plan.n_split * plan.chunk >= T            # every key is covered
    assert (plan.n_split - 1) * plan.chunk < max(T, 1)   # no idle split
    tiles = B * H * -(-W // plan.rows)
    if tiles >= 2 * pa._SMS and T // page_size <= pa._MAX_CHUNK_PAGES:
        assert plan.n_split == 1
    if plan.n_split == 1:
        assert plan.workspace is None
    else:
        assert plan.workspace == (plan.n_split, B, W, H, D + 2)
        assert plan.chunk >= min(pa._MIN_CHUNK_TOKENS, T)


def test_verify_plan_fills_the_card_when_rows_do_not():
    # the kernels phase's W = 1 shape: 96 row tiles alone are under one
    # wave; the served prefix-hit tail (B = 1, W = 64) even more so
    for B, W in ((8, 1), (8, 5), (1, 64)):
        plan = pa._verify_plan(B, W, 12, 64, 1024, 16)
        assert plan.n_split > 1
        assert B * 12 * -(-W // plan.rows) * plan.n_split >= pa._SMS


def test_verify_plan_reads_no_tensor():
    """The plan is a function of Python ints, and the wrapper around the
    launch never reads a tensor back to the host."""
    params = list(inspect.signature(pa._verify_plan).parameters)
    assert params == ["B", "W", "H", "D", "T", "page_size"]
    src = inspect.getsource(pa.ragged_paged_verify)
    for sync in (".item(", ".cpu(", ".tolist(", ".numpy(", "int(st",
                 "int(ln", "synchronize"):
        assert sync not in src
