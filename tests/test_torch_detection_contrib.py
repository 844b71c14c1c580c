"""PyTorch port, ``gluon.contrib.detection`` (``mxnet_tpu_torch/gluon/
contrib/detection.py``: FPN, RPN, Faster R-CNN) against the JAX package.

Twins of the 9 tests of ``tests/test_detection_contrib.py``; each also
runs the same numpy inputs through the JAX function, and the port's
blocks take the JAX blocks' weights (``ParameterDict.load_dict``, the
user backbone included).  Tolerances: box math and feature maps within
rtol 1e-5 / atol 1e-5 (boxes in pixels atol 1e-3: exp of a delta times
a 512-pixel anchor), indices, masks and levels exactly, losses rtol 1e-5
on the first step and 1e-4 after Adam's steps.  The JAX package compiles
every new shape, so the reference's 60-step RPN training (and its
second-stage run, slow there) become 4 steps against the JAX trainer,
the loss falling over them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.contrib import detection as jdet

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon.contrib import detection as det


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _backbone(m):
    """Three-stage toy feature extractor: strides 8/16/32 at 64ch."""
    g, n = m.gluon, m.gluon.nn

    class Feats(g.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.s1 = n.HybridSequential()
                for _ in range(3):                 # 8x total
                    self.s1.add(n.Conv2D(32, 3, strides=2, padding=1,
                                         activation="relu"))
                self.s2 = n.Conv2D(48, 3, strides=2, padding=1,
                                   activation="relu")
                self.s3 = n.Conv2D(64, 3, strides=2, padding=1,
                                   activation="relu")

        def hybrid_forward(self, F, x):
            c3 = self.s1(x)
            c4 = self.s2(c3)
            c5 = self.s3(c4)
            return c3, c4, c5
    return Feats(), (32, 48, 64)


def _carry(jblock, block, x):
    """The JAX block's weights into the port's (shapes resolved on
    ``x``)."""
    block(nd.array(x))
    block.collect_params().load_dict(
        {k: v.data().asnumpy() for k, v in jblock.collect_params().items()})


def _frcnn_pair(seed, num_classes):
    jmx.random.seed(seed)
    jfeats, chans = _backbone(jmx)
    jnet = jdet.FasterRCNN(jfeats, chans, num_classes=num_classes,
                           image_size=(128, 128), channels=32,
                           rpn_pre_topk=64, rpn_post_topk=16)
    jnet.initialize(jmx.init.Xavier())
    feats, chans = _backbone(mx)
    net = det.FasterRCNN(feats, chans, num_classes=num_classes,
                         image_size=(128, 128), channels=32,
                         rpn_pre_topk=64, rpn_post_topk=16)
    net.initialize(mx.init.Xavier())
    x = np.zeros((1, 3, 128, 128), np.float32)
    jnet(jnd.array(x))
    _carry(jnet, net, x)
    return jnet, net


def test_fpn_shapes():
    jmx.random.seed(0)
    jfeats, chans = _backbone(jmx)
    jfpn = jdet.FPN(chans, channels=32)
    jfeats.initialize(jmx.init.Xavier())
    jfpn.initialize(jmx.init.Xavier())
    feats, _ = _backbone(mx)
    fpn = det.FPN(chans, channels=32)
    feats.initialize()
    fpn.initialize()
    x = np.random.RandomState(0).randn(2, 3, 128, 128).astype(np.float32)
    jlevels = jfpn(*jfeats(jnd.array(x)))
    _carry(jfeats, feats, x)
    fpn.collect_params().load_dict(
        {k: v.data().asnumpy() for k, v in jfpn.collect_params().items()})
    levels = fpn(*feats(nd.array(x)))
    assert len(levels) == 4                         # P3..P5 + P6
    assert [tuple(l.shape) for l in levels] == [
        (2, 32, 16, 16), (2, 32, 8, 8), (2, 32, 4, 4), (2, 32, 2, 2)]
    for got, want in zip(levels, jlevels):
        _close(got.asnumpy(), want.asnumpy())


def test_anchor_generator_oracle():
    gen = det.AnchorGenerator(strides=(8,), sizes=(32,), ratios=(1.0,))
    a = gen.level(0, 2, 2)
    assert a.shape == (4, 4)
    # first anchor: center (4, 4), 32x32 square
    np.testing.assert_allclose(a[0], [4 - 16, 4 - 16, 4 + 16, 4 + 16])
    # second cell along x: center (12, 4)
    np.testing.assert_allclose(a[1], [12 - 16, 4 - 16, 12 + 16, 4 + 16])
    big = det.AnchorGenerator((8, 16), (32, 64)).level(1, 3, 5)
    np.testing.assert_array_equal(
        big, jdet.AnchorGenerator((8, 16), (32, 64)).level(1, 3, 5))


def test_box_iou_and_delta_roundtrip():
    rng = np.random.RandomState(0)
    xy = rng.rand(6, 2) * 50
    wh = rng.rand(6, 2) * 30 + 2
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    iou = _np(det.box_iou(torch.from_numpy(boxes), boxes))
    np.testing.assert_allclose(np.diag(iou), 1.0, rtol=1e-5)
    assert (iou >= 0).all() and (iou <= 1 + 1e-6).all()
    _close(iou, jdet.box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    # encode/decode round trip
    anchors = boxes
    gt = boxes[::-1].copy()
    deltas = det.encode_deltas(anchors, gt)
    back = _np(det.decode_deltas(anchors, deltas))
    np.testing.assert_allclose(back, gt, rtol=1e-4, atol=1e-3)
    jdeltas = jdet.encode_deltas(jnp.asarray(anchors), jnp.asarray(gt))
    _close(deltas, jdeltas)
    _close(back, jdet.decode_deltas(jnp.asarray(anchors), jdeltas),
           atol=1e-4)


def test_nms_static_suppresses_overlaps():
    boxes = np.array([
        [0, 0, 10, 10], [1, 1, 11, 11],        # heavy overlap pair
        [50, 50, 60, 60], [100, 100, 110, 110]], np.float32)
    scores = np.array([0.9, 0.95, 0.5, 0.8], np.float32)
    out_boxes, out_scores, keep = det.nms_static(boxes, scores, topk=4,
                                                 iou_thr=0.5)
    kept = _np(out_scores)[_np(keep)]
    # the 0.9 box is suppressed by its 0.95 twin: 3 survivors
    assert _np(keep).sum() == 3
    np.testing.assert_allclose(sorted(kept, reverse=True),
                               [0.95, 0.8, 0.5], rtol=1e-6)
    jb, js, jk = jdet.nms_static(jnp.asarray(boxes), jnp.asarray(scores),
                                 topk=4, iou_thr=0.5)
    np.testing.assert_array_equal(_np(keep), np.asarray(jk))
    np.testing.assert_array_equal(_np(out_scores), np.asarray(js))
    np.testing.assert_array_equal(_np(out_boxes), np.asarray(jb))
    # ties: equal scores pick the lowest index first, as lax's argmax
    tied = np.array([0.7, 0.7, 0.7, 0.7], np.float32)
    got = det.nms_static(boxes, tied, topk=4, iou_thr=0.5)
    want = jdet.nms_static(jnp.asarray(boxes), jnp.asarray(tied), topk=4,
                           iou_thr=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.fixture(scope="module")
def frcnn():
    with mx.cpu(0):
        return _frcnn_pair(0, 3)


def test_faster_rcnn_inference_shapes(frcnn):
    jnet, net = frcnn
    x = np.random.RandomState(1).randn(2, 3, 128, 128).astype(np.float32)
    cls, boxes, rscores = net(nd.array(x))
    assert tuple(cls.shape) == (2, 16, 4)           # nc + background
    assert tuple(boxes.shape) == (2, 16, 3, 4)
    assert tuple(rscores.shape) == (2, 16)
    assert np.isfinite(cls.asnumpy()).all()
    assert np.isfinite(boxes.asnumpy()).all()
    jcls, jboxes, jrs = jnet(jnd.array(x))
    _close(cls.asnumpy(), jcls.asnumpy())
    _close(boxes.asnumpy(), jboxes.asnumpy(), atol=1e-3)
    got, want = rscores.asnumpy(), jrs.asnumpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    _close(got[np.isfinite(got)], want[np.isfinite(want)])


def test_rpn_targets_match_obvious_gt(frcnn):
    jnet, net = frcnn
    x = np.random.RandomState(2).randn(1, 3, 128, 128).astype(np.float32)
    levels, anchors, obj, reg = net.rpn_forward(nd.array(x))
    gt = np.array([[16, 16, 48, 48]], np.float32)
    obj_t, obj_m, delta_t, pos = net.rpn_targets(anchors, gt)
    assert float(pos.sum()) >= 1                    # someone matched
    # every positive anchor decodes back onto the gt box
    back = _np(det.decode_deltas(anchors, delta_t))
    pos_np = _np(pos) > 0
    np.testing.assert_allclose(back[pos_np],
                               np.tile(gt, (pos_np.sum(), 1)),
                               rtol=1e-4, atol=1e-2)
    _jl, janchors, _jo, _jr = jnet.rpn_forward(jnd.array(x))
    np.testing.assert_array_equal(anchors, janchors)
    want = jnet.rpn_targets(janchors, jnp.asarray(gt))
    for got, w in zip((obj_t, obj_m, pos), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(_np(got), np.asarray(w))
    _close(delta_t, want[2])


def _rpn_losses(m, ag, net, x, gt, steps, lr):
    params = {k: p for k, p in net.collect_params().items()
              if p.grad_req != "null"}
    tr = m.gluon.Trainer(params, "adam", {"learning_rate": lr})
    losses = []
    for _ in range(steps):
        with ag.record():
            _lv, anchors, obj, reg = net.rpn_forward(x)
            loss = net.rpn_loss(anchors, obj, reg, gt)
        loss.backward()
        tr.step(2)
        losses.append(float(loss.asnumpy()))
    return losses


def test_rpn_trains_on_synthetic_boxes():
    """RPN loss decreases on a fixed scene, step for step with the JAX
    package's."""
    jnet, net = _frcnn_pair(3, 2)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 128, 128).astype(np.float32)
    gt = np.array([[[20, 20, 60, 60]], [[60, 60, 100, 100]]], np.float32)
    losses = _rpn_losses(mx, autograd, net, nd.array(x), nd.array(gt), 4,
                         3e-3)
    jl = _rpn_losses(jmx, jautograd, jnet, jnd.array(x), jnd.array(gt), 4,
                     3e-3)
    np.testing.assert_allclose(losses[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    assert losses[-1] < losses[0], losses


def test_fpn_level_routing():
    """Small ROIs pool from fine levels, large from coarse — guards the
    absolute-level vs list-index off-by-base bug."""
    w = np.array([32.0, 112.0, 224.0, 500.0], np.float32)
    lvl = _np(det.fpn_level_index(w, w, n_levels=4))
    # 32px -> k = floor(4 + log2(32/224)) = 1 -> clipped index 0 (P3)
    # 112px -> k=3 -> index 0; 224px -> k=4 -> index 1 (P4)
    # 500px -> k=5 -> index 2 (P5)
    assert list(lvl) == [0, 0, 1, 2], list(lvl)
    assert lvl.dtype == np.int32
    np.testing.assert_array_equal(lvl, np.asarray(jdet.fpn_level_index(
        jnp.asarray(w), jnp.asarray(w), n_levels=4)))


def _two_stage_losses(m, ag, net, x, gt, gtc, steps):
    params = {k: p for k, p in net.collect_params().items()
              if p.grad_req != "null"}
    tr = m.gluon.Trainer(params, "adam", {"learning_rate": 5e-4})
    losses = []
    for _ in range(steps):
        with ag.record():
            levels, anchors, obj, reg = net.rpn_forward(x)
            rloss = net.rpn_loss(anchors, obj, reg, gt)
            rois_b, _sc, keep_b = net.proposals(anchors, obj, reg)
            closs = net.rcnn_loss(levels, rois_b, gt, gtc, keep=keep_b)
            loss = rloss + closs
        loss.backward()
        tr.step(2)
        losses.append((float(rloss.asnumpy()), float(closs.asnumpy())))
    return losses, tr


def test_rcnn_targets_and_second_stage_trains():
    """Second-stage targets assign the right class, and the two-stage
    loss (RPN + ROI head) falls on a fixed scene, step for step with the
    JAX package's; the second stage's gradient reaches the backbone."""
    jnet, net = _frcnn_pair(4, 2)
    # targets: a roi sitting on gt box 1 (class 2) gets class 2
    rois = np.array([[20, 20, 60, 60], [90, 90, 120, 120], [0, 0, 8, 8]],
                    np.float32)
    gt = np.array([[22, 22, 58, 58], [88, 88, 118, 118]], np.float32)
    gtc = np.array([1, 2], np.int32)
    cls_t, delta_t, fg = net.rcnn_targets(rois, gt, gtc)
    assert list(_np(cls_t)) == [1, 2, 0]
    assert list(_np(fg)) == [1.0, 1.0, 0.0]
    jcls_t, jdelta_t, _jfg = jnet.rcnn_targets(
        jnp.asarray(rois), jnp.asarray(gt), jnp.asarray(gtc))
    np.testing.assert_array_equal(_np(cls_t), np.asarray(jcls_t))
    _close(delta_t, jdelta_t)

    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 128, 128).astype(np.float32)
    gt_b = np.array([[[20, 20, 60, 60]], [[60, 60, 100, 100]]], np.float32)
    gtc_b = np.array([[1], [2]], np.int32)
    losses, tr = _two_stage_losses(mx, autograd, net, nd.array(x),
                                   nd.array(gt_b),
                                   nd.array(gtc_b, dtype="int32"), 4)
    jl, _ = _two_stage_losses(jmx, jautograd, jnet, jnd.array(x),
                              jnd.array(gt_b),
                              jnd.array(gtc_b, dtype="int32"), 4)
    np.testing.assert_allclose(losses[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    total = [r + c for r, c in losses]
    assert total[-1] < total[0], total
    g = net.features.s1[0].weight.grad().asnumpy()
    assert np.abs(g).max() > 0
