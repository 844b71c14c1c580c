"""PyTorch port, the int8 quantization ops
(``mxnet_tpu_torch/ops/quantization.py``).

Twins of ``tests/test_quantization.py``'s first 4 tests (the op-level
ones).  The JAX tests draw their inputs with ``nd.random.uniform``; here
the inputs are seeded numpy arrays, the same for both packages, so the
outputs can be held bit for bit: int8 and int32 arrays equal, and the
float32 ranges and dequantized values equal too (the port repeats the
JAX op's float32 scale arithmetic).  The int8 x int8 products run in
float64 in the port, exact at these sizes.
"""
import numpy as np
import pytest

from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _bitwise(got, want):
    got = [g.asnumpy() for g in (got if isinstance(got, (list, tuple))
                                 else [got])]
    want = [w.asnumpy() for w in (want if isinstance(want, (list, tuple))
                                  else [want])]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    return got


def _uniform(seed, low, high, shape):
    return np.random.RandomState(seed).uniform(low, high, shape).astype(
        np.float32)


def _pair(x):
    return nd.array(x), jnd.array(x)


def test_quantize_dequantize_roundtrip():
    x, jx = _pair(_uniform(0, -3, 3, (16, 32)))
    q, mn, mxr = nd.quantize_v2(x)
    jq, jmn, jmxr = jnd.quantize_v2(jx)
    qa, _, _ = _bitwise([q, mn, mxr], [jq, jmn, jmxr])
    assert str(qa.dtype) == "int8"
    back, = _bitwise(nd.dequantize(q, mn, mxr),
                     jnd.dequantize(jq, jmn, jmxr))
    assert np.abs(back - x.asnumpy()).max() < 3.0 / 127 * 1.01


def test_quantize_with_calib_range_clips():
    x, jx = _pair(np.array([[-10.0, -1.0, 0.0, 1.0, 10.0]], np.float32))
    qa, _mn, mxr = _bitwise(
        nd.quantize_v2(x, min_calib_range=-2.0, max_calib_range=2.0),
        jnd.quantize_v2(jx, min_calib_range=-2.0, max_calib_range=2.0))
    assert qa.min() == -127 and qa.max() == 127
    assert float(mxr) == pytest.approx(2.0)


def test_requantize_int32_to_int8():
    xs, ws = _uniform(1, -1, 1, (8, 8)), _uniform(2, -1, 1, (4, 8))
    outs = []
    for m in (nd, jnd):
        qx, xmn, xmx = m.quantize_v2(m.array(xs))
        qw, wmn, wmx = m.quantize_v2(m.array(ws))
        out32, omn, omx = m.quantized_fully_connected(
            qx, qw, None, xmn, xmx, wmn, wmx, None, None, num_hidden=4,
            no_bias=True)
        q8, rmn, rmx = m.requantize(out32, omn, omx)
        outs.append([out32, omn, omx, q8, rmn, rmx,
                     m.dequantize(q8, rmn, rmx)])
    got = _bitwise(*outs)
    assert str(got[0].dtype) == "int32" and str(got[3].dtype) == "int8"
    assert np.abs(got[-1] - xs @ ws.T).max() < 0.05


def test_quantized_conv_matches_fp32():
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, (4, 3, 3, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (4,)).astype(np.float32)
    outs = []
    for m in (nd, jnd):
        qx, xmn, xmx = m.quantize_v2(m.array(x))
        qw, wmn, wmx = m.quantize_v2(m.array(w))
        qb, bmn, bmx = m.quantize_v2(m.array(b))
        out32, omn, omx = m.quantized_conv(
            qx, qw, qb, xmn, xmx, wmn, wmx, bmn, bmx, kernel=(3, 3),
            pad=(1, 1), num_filter=4)
        outs.append([out32, omn, omx, m.dequantize(out32, omn, omx)])
    got = _bitwise(*outs)[-1]
    ref = nd.Convolution(nd.array(x), nd.array(w), nd.array(b),
                         kernel=(3, 3), pad=(1, 1), num_filter=4).asnumpy()
    assert np.abs(got - ref).max() < 0.2
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999
