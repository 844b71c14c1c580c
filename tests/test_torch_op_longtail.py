"""PyTorch port, the long-tail ops (``mxnet_tpu_torch/ops/{tensor,nn}.py``):
cumsum / cumprod, digamma, unravel_index, split_v2, Crop, im2col /
col2im, hard_sigmoid, SpatialTransformer and ROIPooling.

Twins of ``tests/test_op_longtail.py``'s 10 tests: the same inputs go
through the JAX package's ``nd`` op and the port's; each test asserts
what the JAX test asserts on the port's outputs and holds them to the
JAX ones (float32 within rtol 1e-5, atol 1e-6; integer outputs bit for
bit; gradients within 1e-5).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _same(got, want):
    got, want = got.asnumpy(), want.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    return got


def _run(op, arrays, **kwargs):
    """(port output, JAX output) of ``op`` on the same numpy inputs."""
    return (getattr(nd, op)(*[nd.array(a) for a in arrays], **kwargs),
            getattr(jnd, op)(*[jnd.array(a) for a in arrays], **kwargs))


def test_cumsum_cumprod():
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    np.testing.assert_allclose(_same(*_run("cumsum", [x], axis=1)),
                               np.cumsum(x, axis=1))
    np.testing.assert_allclose(_same(*_run("cumsum", [x])), np.cumsum(x))
    np.testing.assert_allclose(_same(*_run("cumprod", [x], axis=0)),
                               np.cumprod(x, axis=0))
    grads = []
    for m, ag in ((nd, autograd), (jnd, jautograd)):
        a = m.array(x)
        a.attach_grad()
        with ag.record():
            y = m.sum(m.cumsum(a, axis=1))
        y.backward()
        grads.append(a.grad)
    np.testing.assert_allclose(_same(*grads), [[3, 2, 1], [3, 2, 1]])


def test_digamma_unravel():
    d = _same(*_run("digamma", [np.array([1.0], np.float32)]))
    np.testing.assert_allclose(d, [-0.5772157], rtol=1e-5)
    u = _same(nd.unravel_index(nd.array(np.array([5, 7]), dtype="int32"),
                               shape=(3, 4)),
              jnd.unravel_index(jnd.array(np.array([5, 7]), dtype="int32"),
                                shape=(3, 4)))
    assert u.tolist() == [[1, 1], [1, 3]]


def test_split_v2():
    (a, b), (ja, jb) = _run("split_v2", [np.arange(8.0, dtype=np.float32)],
                            indices_or_sections=(3,))
    assert _same(a, ja).shape == (3,) and _same(b, jb).shape == (5,)
    parts, jparts = _run("split_v2", [np.arange(8.0, dtype=np.float32)
                                      .reshape(2, 4)],
                         indices_or_sections=2, axis=0, squeeze_axis=True)
    assert _same(parts[0], jparts[0]).shape == (4,)
    one, jone = _run("split_v2", [np.arange(4.0, dtype=np.float32)],
                     indices_or_sections=1)
    _same(one, jone)          # one section: one array, not a list


def test_crop():
    img = np.arange(2 * 3 * 6 * 6, dtype=np.float32).reshape(2, 3, 6, 6)
    c = _same(*_run("Crop", [img], offset=(1, 2), h_w=(3, 3)))
    np.testing.assert_allclose(c, img[:, :, 1:4, 2:5])
    c2 = _same(*_run("Crop", [img, np.zeros((1, 1, 4, 4), np.float32)],
                     center_crop=True, num_args=2))
    np.testing.assert_allclose(c2, img[:, :, 1:5, 1:5])


def test_im2col_col2im_adjoint():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 8, 8).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    cols = _same(*_run("im2col", [img], **kw))
    assert cols.shape == (2, 27, 16)
    y = rng.randn(*cols.shape).astype(np.float32)
    back = _same(*_run("col2im", [y], output_size=(8, 8), **kw))
    lhs = float((cols * y).sum())
    rhs = float((img * back).sum())
    assert abs(lhs - rhs) < 1e-2 * max(1.0, abs(lhs))


def test_hard_sigmoid():
    x = np.linspace(-5, 5, 11).astype(np.float32)
    hs = _same(*_run("hard_sigmoid", [x]))
    np.testing.assert_allclose(hs, np.clip(0.2 * x + 0.5, 0, 1), rtol=1e-6)


def test_spatial_transformer_identity():
    rng = np.random.RandomState(1)
    img = rng.randn(2, 3, 5, 5).astype(np.float32)
    ident = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    out = _same(*_run("SpatialTransformer", [img, ident],
                      target_shape=(5, 5)))
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_roi_pooling():
    data = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
    out = _same(*_run("ROIPooling", [
        data, np.array([[0, 0, 0, 7, 7]], np.float32)],
        pooled_size=(2, 2), spatial_scale=1.0))
    assert out.shape == (1, 1, 2, 2)
    assert float(out[0, 0, 1, 1]) == 63.0
    assert float(out.min()) >= 0.0


def test_roi_pooling_covers_all_pixels():
    arr = np.zeros((1, 1, 8, 8), np.float32)
    arr[0, 0, 0, 0] = 100.0
    out = _same(*_run("ROIPooling", [
        arr, np.array([[0, 0, 0, 7, 7]], np.float32)],
        pooled_size=(2, 2), spatial_scale=1.0))
    assert float(out[0, 0, 0, 0]) == 100.0


def test_crop_out_of_bounds_raises():
    for m, err in ((nd, MXNetError), (jnd, jmx.base.MXNetError)):
        img = m.zeros((1, 1, 4, 4))
        with pytest.raises(err, match="exceeds"):
            m.Crop(img, h_w=(6, 6))
        with pytest.raises(err, match="exceeds"):
            m.Crop(img, m.zeros((1, 1, 6, 6)), center_crop=True,
                   num_args=2)
