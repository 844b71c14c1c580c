"""PyTorch port, B4's split context: the plain mirror of the decode
kernel's split and in-launch merge (``_decode_split_reference``) against
the JAX package's Pallas ``ragged_paged_attention`` (CPU interpreter
mode), its pure-jax reference and the port's plain version; the launch
plan ``_decode_plan``'s invariants; and the workspace the wrapper keeps.

The CUDA kernel itself needs a card (``chip_smoke.py`` holds it against
the plain version and this mirror on the H100).  Tolerances: fp32 atol
1e-5 (other summation orders); bf16 inputs atol 2e-2, as the split tests
of B5 hold theirs (P is rounded to bf16 before P V against each 16-token
tile's running max, the Pallas kernel rounds it against each page's, the
pure-jax reference not at all).
"""
import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import (
    ragged_paged_attention as jax_attention,
    ragged_paged_attention_reference as jax_attention_ref)
from mxnet_tpu_torch.ops import paged_attention as pa

H, D, PAGE, N_POOL, PAGES = 2, 8, 4, 40, 9
T = PAGES * PAGE
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# four slots: inactive, one token, a partial page, the whole table
LENS = [0, 1, 13, T]


def _inputs(seed=0, lens=LENS):
    rs = np.random.RandomState(200 + seed)
    B = len(lens)
    q = rs.randn(B, H, D).astype(np.float32)
    k = rs.randn(N_POOL, PAGE, H, D).astype(np.float32)
    v = rs.randn(N_POOL, PAGE, H, D).astype(np.float32)
    bt = np.stack([rs.permutation(N_POOL - 1)[:PAGES] + 1
                   for _ in range(B)]).astype(np.int32)
    return q, k, v, bt, np.asarray(lens, np.int32)


def _torch_args(dtype, seed=0, lens=LENS):
    q, k, v, bt, ln = _inputs(seed, lens)
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(dt) for a in (q, k, v)] + [
        torch.from_numpy(bt), torch.from_numpy(ln)]


@functools.lru_cache(maxsize=None)
def _jax_outputs(dtype):
    q, k, v, bt, ln = _inputs()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    args = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [
        jnp.asarray(bt), jnp.asarray(ln)]
    kern = np.asarray(jax_attention(*args, interpret=True).astype(
        jnp.float32))
    ref = np.asarray(jax_attention_ref(*args).astype(jnp.float32))
    return kern, ref


# (n_split, chunk pages): one chunk; two and three of whole pages; nine
# one-page chunks, of which those past a context hold nothing for it
SPLITS = [(1, PAGES), (2, 5), (3, 3), (9, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split,chunk_pages", SPLITS)
def test_split_mirror_matches_jax(n_split, chunk_pages, dtype):
    chunk = chunk_pages * PAGE
    assert n_split * chunk >= T
    args = _torch_args(dtype)
    got = pa._decode_split_reference(*args, n_split=n_split, chunk=chunk)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    want_kernel, want_ref = _jax_outputs(dtype)
    np.testing.assert_allclose(got, want_kernel, atol=TOL[dtype])
    np.testing.assert_allclose(got, want_ref, atol=TOL[dtype])
    plain = pa.ragged_paged_attention_reference(*args).float().numpy()
    np.testing.assert_allclose(got, plain, atol=TOL[dtype])
    assert np.all(got[0] == 0.0)                 # inactive slot


def test_split_mirror_empty_chunks_are_exact():
    """Chunks wholly past a context add nothing: nine one-page chunks
    over contexts of at most 7 tokens give what one chunk gives, and an
    inactive slot's row is exact zeros."""
    args = _torch_args("float32", seed=1, lens=[7, 0, 3, 4])
    one = pa._decode_split_reference(*args, n_split=1, chunk=T)
    many = pa._decode_split_reference(*args, n_split=9, chunk=PAGE)
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=1e-6)
    assert torch.all(many[1] == 0) and torch.all(one[1] == 0)
    plain = pa.ragged_paged_attention_reference(*args)
    np.testing.assert_allclose(many.numpy(), plain.numpy(), atol=1e-5)


def test_split_mirror_rounds_p_like_the_kernel():
    """bf16: the mirror rounds P to bf16 before P V, so it moves away
    from the unrounded plain version, but stays within the bf16 limit."""
    args = _torch_args("bfloat16", seed=2, lens=[T, 29, 17, 30])
    got = pa._decode_split_reference(*args, n_split=3, chunk=3 * PAGE)
    plain = pa.ragged_paged_attention_reference(*args)
    err = float((got.float() - plain.float()).abs().max())
    assert 0.0 < err < TOL["bfloat16"]


@pytest.mark.parametrize("B,H_,T_,page_size", [
    (8, 12, 1024, 16), (1, 12, 1024, 16), (1, 1, 16, 16), (2, 3, 40, 4),
    (3, 2, 7, 1), (24, 12, 1024, 16), (64, 16, 2048, 16),
    (1, 12, 1 << 17, 16), (4, 8, 4096, 8), (3, 2, 768, 16),
])
def test_decode_plan_invariants(B, H_, T_, page_size):
    plan = pa._decode_plan(B, H_, 64, T_, page_size)
    assert plan.chunk % page_size == 0 and plan.chunk > 0   # whole pages
    assert plan.chunk // page_size <= pa._MAX_CHUNK_PAGES
    assert plan.n_split * plan.chunk >= T_           # every key is covered
    assert (plan.n_split - 1) * plan.chunk < T_      # no idle split
    assert plan.chunk >= min(pa._MIN_CHUNK_TOKENS, -(-T_ // page_size)
                             * page_size)
    if B * H_ >= 2 * pa._SMS and T_ // page_size <= pa._MAX_CHUNK_PAGES:
        assert plan.n_split == 1                     # rows fill two waves
    if plan.n_split == 1:
        assert plan.workspace is None
    else:
        assert plan.workspace == (plan.n_split, B, H_, 66)


def test_decode_plan_fills_the_card_when_rows_do_not():
    # the serving batch (8 slots x 12 heads = 96 rows) is under one wave
    # of 132 SMs alone; split, it reaches about _DECODE_WAVES waves
    plan = pa._decode_plan(8, 12, 64, 1024, 16)
    assert plan.n_split > 1
    assert 8 * 12 * plan.n_split >= pa._DECODE_WAVES * pa._SMS // 2
    assert pa._decode_plan(1, 1, 64, 1024, 16).n_split == 16  # 64 tokens


def test_decode_plan_is_memoized():
    pa._decode_plan.cache_clear()
    a = pa._decode_plan(8, 12, 64, 1024, 16)
    b = pa._decode_plan(8, 12, 64, 1024, 16)
    assert a is b and pa._decode_plan.cache_info().hits == 1


def test_decode_plan_reads_no_tensor():
    """The plan is a function of Python ints, and the wrapper around the
    launch never reads a tensor back to the host."""
    params = list(inspect.signature(pa._decode_plan).parameters)
    assert params == ["B", "H", "D", "T", "page_size"]
    src = inspect.getsource(pa.ragged_paged_attention)
    for sync in (".item(", ".cpu(", ".tolist(", ".numpy(", "int(lens",
                 "int(context", "synchronize"):
        assert sync not in src


def test_decode_workspace_is_made_once_per_device_stream_and_shape():
    """The partials and the arrival counters are allocated on first use
    and handed back unchanged after that (the kernel leaves the counters
    at zero); another stream or shape gets its own."""
    dev = torch.device("cpu")
    shape = (6, 8, 12, 66)
    ws, cnt = pa._decode_workspace(dev, 1234, shape)
    assert ws.shape == shape and ws.dtype == torch.float32
    assert cnt.shape == (8 * 12,) and cnt.dtype == torch.int32
    assert torch.all(cnt == 0)
    again = pa._decode_workspace(dev, 1234, shape)
    assert again[0] is ws and again[1] is cnt
    assert pa._decode_workspace(dev, 5678, shape)[0] is not ws
    assert pa._decode_workspace(dev, 1234, (3, 8, 12, 66))[0] is not ws
