"""PyTorch port, the MoE routing ops (``mxnet_tpu_torch/ops/moe.py``).

Twins of ``tests/test_moe.py``'s first 4 tests: the same inputs through
the JAX op and the port's, the JAX test's assertions on the port's
outputs, and the port's outputs within 1e-5 of the JAX ones (dispatch
masks exactly).  ``test_moe_ffn_under_jit_and_grad`` becomes the op
inside a hybridized ``HybridBlock`` under ``autograd.record`` (the
CachedOp path on the CPU), its gradients against ``jax.grad`` of the
jitted JAX loss within 1e-4 of their max.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import moe as jmoe

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, tol=1e-5):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)
    return got


def test_top1_dispatch_routing():
    logits = np.array([[2.0, 0.0], [0.0, 3.0], [1.5, 0.1], [0.0, 2.5]],
                      np.float32)
    combine, dispatch, aux = nd.moe_top1_dispatch(nd.array(logits),
                                                  capacity=2)
    jc, jd, ja = jmoe.moe_top1_dispatch(jnp.asarray(logits), capacity=2)
    d = dispatch.asnumpy()
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert d[0, 0, 0] == 1 and d[2, 0, 1] == 1
    assert d[1, 1, 0] == 1 and d[3, 1, 1] == 1
    np.testing.assert_allclose(d.sum(axis=(1, 2)), 1.0)
    c = _close(combine, jc)
    gates = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(c.sum(axis=(1, 2)), gates.max(axis=1),
                               rtol=1e-6)
    assert np.isfinite(_close(aux, ja))


def test_top1_capacity_drop():
    logits = np.array([[5.0, 0.0]] * 4, np.float32)
    _c, dispatch, _a = nd.moe_top1_dispatch(nd.array(logits), capacity=2)
    _jc, jd, _ja = jmoe.moe_top1_dispatch(jnp.asarray(logits), capacity=2)
    d = dispatch.asnumpy()
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(d.sum(), 2.0)
    np.testing.assert_allclose(d.sum(axis=(1, 2)), [1, 1, 0, 0])


def test_moe_ffn_single_expert_equals_mlp():
    rng = np.random.RandomState(0)
    S, C, H = 8, 4, 16
    x = rng.randn(S, C).astype(np.float32)
    w1 = rng.randn(1, C, H).astype(np.float32)
    w2 = rng.randn(1, H, C).astype(np.float32)
    args = [x, np.zeros((C, 1), np.float32), w1,
            np.zeros((1, H), np.float32), w2, np.zeros((1, C), np.float32)]
    out, aux = nd.moe_ffn(*map(nd.array, args), capacity_factor=2.0,
                          activation="relu")
    jout, jaux = jmoe.moe_ffn(*map(jnp.asarray, args), capacity_factor=2.0,
                              activation="relu")
    got = _close(out, jout)
    ref = np.maximum(x @ w1[0], 0) @ w2[0]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_close(aux, jaux), 1.0, rtol=1e-5)


class _MoELoss(gluon.HybridBlock):
    def hybrid_forward(self, F, x, wg, w1, b1, w2, b2):
        out, aux = F.moe_ffn(x, wg, w1, b1, w2, b2)
        return (out ** 2).sum() + 0.01 * aux


def test_moe_ffn_under_jit_and_grad():
    rng = np.random.RandomState(1)
    B, L, C, H, E = 2, 8, 4, 8, 4
    x = rng.randn(B, L, C).astype(np.float32)
    params = [rng.randn(C, E).astype(np.float32),
              rng.randn(E, C, H).astype(np.float32) * 0.1,
              np.zeros((E, H), np.float32),
              rng.randn(E, H, C).astype(np.float32) * 0.1,
              np.zeros((E, C), np.float32)]

    @jax.jit
    def loss(wg, w1, b1, w2, b2):
        out, aux = jmoe.moe_ffn(jnp.asarray(x), wg, w1, b1, w2, b2)
        return (out ** 2).sum() + 0.01 * aux

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, params))
    block = _MoELoss()
    block.hybridize()
    for _ in range(2):        # the capture call, then a replay
        arrs = [nd.array(p) for p in params]
        for a in arrs:
            a.attach_grad()
        with autograd.record():
            out = block(nd.array(x), *arrs)
        out.backward()
        _close(out, loss(*map(jnp.asarray, params)), 1e-4)
        for a, w in zip(arrs, want):
            g = a.grad.asnumpy()
            assert np.isfinite(g).all()
            np.testing.assert_allclose(
                g, np.asarray(w), rtol=0,
                atol=1e-4 * float(np.abs(np.asarray(w)).max()))
    assert np.abs(arrs[0].grad.asnumpy()).max() > 0
