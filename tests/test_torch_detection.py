"""PyTorch port, the SSD MultiBox ops (``mxnet_tpu_torch/ops/detection.py``).

Twins of ``tests/test_detection.py``'s 9 tests: each runs the same
inputs through the JAX package's ``nd`` op and the port's, asserts what
the JAX test asserts on the port's outputs, and holds the port's
outputs to the JAX ones (float within 1e-5, class and mask outputs
exactly).  ``test_multibox_under_jit`` becomes the three ops inside a
hybridized ``HybridBlock`` (the CachedOp path on the CPU) against the
eager block and the JAX pipeline under ``jax.jit``.  A last test runs a
batched case with hard-negative mining where anchors tie on their
background score, so the stable sorts decide which negatives stay.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _both(op, arrays, **kwargs):
    """``op`` through both packages on the same numpy inputs: (port
    outputs, JAX outputs) as lists of numpy arrays."""
    def run(mod):
        out = getattr(mod, op)(*[mod.array(a) for a in arrays], **kwargs)
        out = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in out]
    got, want = run(nd), run(jnd)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    return got


def test_multibox_prior_shapes_and_values():
    a, = _both("MultiBoxPrior", [np.zeros((1, 3, 2, 2), np.float32)],
               sizes=(0.5, 0.25), ratios=(1.0, 2.0))
    assert a.shape == (1, 2 * 2 * 3, 4)
    a = a[0]
    np.testing.assert_allclose(a[0], [0.0, 0.0, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(a[1], [0.125, 0.125, 0.375, 0.375],
                               atol=1e-6)
    w, h = 0.5 * np.sqrt(2) / 2, 0.5 / np.sqrt(2) / 2
    np.testing.assert_allclose(a[2], [0.25 - w, 0.25 - h, 0.25 + w,
                                      0.25 + h], atol=1e-6)


def test_multibox_prior_nonsquare_aspect():
    a, = _both("MultiBoxPrior", [np.zeros((1, 3, 2, 4), np.float32)],
               sizes=(0.5,))
    a = a[0]
    np.testing.assert_allclose(a[0, 2] - a[0, 0], 0.5 * (2 / 4), atol=1e-6)
    np.testing.assert_allclose(a[0, 3] - a[0, 1], 0.5, atol=1e-6)


def test_multibox_prior_clip():
    a, = _both("MultiBoxPrior", [np.zeros((1, 3, 1, 1), np.float32)],
               sizes=(1.5,), clip=True)
    assert a.min() >= 0.0 and a.max() <= 1.0


def test_multibox_target_matching_and_encoding():
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0]]],
                       np.float32)
    label = np.array([[[1.0, 0.0, 0.0, 0.5, 0.5],
                       [-1.0, 0.0, 0.0, 0.0, 0.0]]], np.float32)
    box_t, box_m, cls_t = _both("MultiBoxTarget", [
        anchors, label, np.zeros((1, 3, 2), np.float32)])
    ct = cls_t[0]
    assert ct[0] == 2.0 and ct[1] == 0.0
    bm = box_m[0].reshape(2, 4)
    np.testing.assert_allclose(bm[0], 1.0)
    np.testing.assert_allclose(bm[1], 0.0)
    np.testing.assert_allclose(box_t[0].reshape(2, 4)[0], 0.0, atol=1e-5)


def test_multibox_target_offset_encoding_roundtrip():
    anchors = np.array([[[0.1, 0.1, 0.6, 0.7]]], np.float32)
    gt = np.array([[[0.0, 0.15, 0.05, 0.7, 0.8]]], np.float32)
    box_t, _box_m, cls_t = _both("MultiBoxTarget", [
        anchors, gt, np.zeros((1, 2, 1), np.float32)])
    assert cls_t[0, 0] == 1.0
    cls_prob = np.array([[[0.1], [0.9]]], np.float32)
    out, = _both("MultiBoxDetection", [cls_prob, box_t, anchors],
                 threshold=0.5, clip=False)
    row = out[0, 0]
    assert row[0] == 0.0
    np.testing.assert_allclose(row[2:], gt[0, 0, 1:], atol=1e-5)


def test_multibox_detection_nms():
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4], [0.12, 0.1, 0.42, 0.4],
                         [0.6, 0.6, 0.9, 0.9]]], np.float32)
    cls_prob = np.array([[[0.1, 0.2, 0.1], [0.9, 0.8, 0.85]]], np.float32)
    out, = _both("MultiBoxDetection", [
        cls_prob, np.zeros((1, 12), np.float32), anchors],
        nms_threshold=0.5)
    kept = out[0][out[0][:, 0] >= 0]
    assert kept.shape[0] == 2
    np.testing.assert_allclose(sorted(kept[:, 1]), [0.85, 0.9], atol=1e-6)


def test_multibox_detection_threshold():
    out, = _both("MultiBoxDetection", [
        np.array([[[0.99], [0.005]]], np.float32),
        np.zeros((1, 4), np.float32),
        np.array([[[0.1, 0.1, 0.4, 0.4]]], np.float32)], threshold=0.01)
    assert (out[0][:, 0] == -1).all()


def test_multibox_target_negative_mining():
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.0, 1.0, 0.5],
                         [0.0, 0.5, 0.5, 1.0], [0.5, 0.5, 1.0, 1.0]]],
                       np.float32)
    label = np.array([[[0.0, 0.0, 0.0, 0.5, 0.5]]], np.float32)
    cls_pred = np.array([[[0.9, 0.1, 0.8, 0.7], [0.1, 0.9, 0.2, 0.3]]],
                        np.float32)
    _, _, cls_t = _both("MultiBoxTarget", [anchors, label, cls_pred],
                        negative_mining_ratio=1.0, ignore_label=-1.0)
    ct = cls_t[0]
    assert ct[0] == 1.0
    assert (ct == 0.0).sum() == 1
    assert ct[1] == 0.0
    assert (ct == -1.0).sum() == 2


class _Pipeline(gluon.HybridBlock):
    """The JAX test's jitted pipeline as a port block."""

    def hybrid_forward(self, F, feat, label, cls_pred, cls_prob, loc):
        anchors = F.MultiBoxPrior(feat, sizes=(0.4, 0.2), ratios=(1.0, 2.0))
        bt, bm, ct = F.MultiBoxTarget(anchors, label, cls_pred)
        det = F.MultiBoxDetection(cls_prob, loc, anchors)
        return bt, bm, ct, det


def test_multibox_under_jit():
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.detection import (MultiBoxDetection, MultiBoxPrior,
                                         MultiBoxTarget)

    @jax.jit
    def pipeline(feat, label, cls_pred, cls_prob, loc):
        anchors = MultiBoxPrior(feat, sizes=(0.4, 0.2), ratios=(1.0, 2.0))
        bt, bm, ct = MultiBoxTarget(anchors, label, cls_pred)
        return bt, bm, ct, MultiBoxDetection(cls_prob, loc, anchors)

    rng = np.random.RandomState(1)
    N = 4 * 4 * 3
    label = rng.rand(2, 3, 5).astype(np.float32)
    label[:, :, 0] = 0.0
    inputs = [np.zeros((2, 8, 4, 4), np.float32), label,
              rng.rand(2, 3, N).astype(np.float32),
              rng.rand(2, 3, N).astype(np.float32),
              (rng.randn(2, N * 4) * 0.1).astype(np.float32)]
    want = [np.asarray(o) for o in pipeline(*map(jnp.asarray, inputs))]
    block = _Pipeline()
    eager = [o.asnumpy() for o in block(*map(nd.array, inputs))]
    block.hybridize()
    for _ in range(2):        # the capture call, then a replay
        got = [o.asnumpy() for o in block(*map(nd.array, inputs))]
        assert got[0].shape == (2, N * 4) and got[2].shape == (2, N)
        assert got[3].shape == (2, N, 6) and np.isfinite(got[3]).all()
        for g, e, w in zip(got, eager, want):
            np.testing.assert_array_equal(g, e)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_multibox_target_mining_ties_follow_stable_order():
    """Anchors whose background scores tie: the stable sort keeps the
    lower-indexed ones, as ``jnp.argsort`` does."""
    rng = np.random.RandomState(7)
    feat = np.zeros((1, 1, 4, 4), np.float32)
    anchors, = _both("MultiBoxPrior", [feat], sizes=(0.3,),
                     ratios=(1.0, 2.0))
    N = anchors.shape[1]
    label = np.array([[[1, 0.1, 0.1, 0.35, 0.4], [0, 0.6, 0.55, 0.9, 0.9],
                       [-1, 0, 0, 0, 0]],
                      [[0, 0.3, 0.3, 0.7, 0.7], [-1, 0, 0, 0, 0],
                       [-1, 0, 0, 0, 0]]], np.float32)
    cls_pred = np.round(rng.rand(2, 3, N), 1).astype(np.float32)
    out = _both("MultiBoxTarget", [anchors, label, cls_pred],
                negative_mining_ratio=3.0, minimum_negative_samples=2)
    assert (out[2] == 0).sum() > 0 and (out[2] == -1).sum() > 0
