"""PyTorch port, ``contrib.quantization``: a twin of each test of
``tests/test_quantization.py``, the entropy threshold search against
the JAX package's, and ``quantize_net`` over a two-layer flash
``BERTClassifier``.

The same numpy inputs and the JAX package's weights (``save_parameters``
/ ``load_parameters``) go through both packages.  Tolerances: the int8
ops' outputs equal (int8 / int32 bit for bit: the port accumulates the
int8 products exactly); float outputs of quantized networks within one
int8 step of the output's scale (a float32 rounding boundary in
``round(x / scale)`` may flip one step of one activation) — stated per
test as ``STEP_TOL`` of max|out|; the entropy search's chosen threshold
equal and its KL curve within 1e-9 relative, point by point.
"""
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jqt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.contrib import quantization as qt

# a float output of an int8 network: within 1% of its max, about one
# int8 step (1/127) of the layer's range
STEP_TOL = 1e-2


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= lim, (what, err, lim)


def _both(fn):
    """``fn(pkg)`` in the JAX package and in the port, as numpy."""
    out = []
    for pkg in (jmx, mx):
        r = fn(pkg)
        out.append([a.asnumpy() for a in r] if isinstance(r, (list, tuple))
                   else r.asnumpy())
    return out


def test_quantize_dequantize_roundtrip():
    x = np.random.RandomState(0).uniform(-3, 3, (16, 32)).astype(np.float32)
    want, got = _both(lambda p: list(p.nd.quantize_v2(p.nd.array(x))) + [
        p.nd.dequantize(*p.nd.quantize_v2(p.nd.array(x)))])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int8
    assert np.abs(got[3] - x).max() < 3.0 / 127 * 1.01


def test_quantize_with_calib_range_clips():
    x = np.array([[-10.0, -1.0, 0.0, 1.0, 10.0]], np.float32)
    want, got = _both(lambda p: p.nd.quantize_v2(
        p.nd.array(x), min_calib_range=-2.0, max_calib_range=2.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].min() == -127 and got[0].max() == 127
    assert float(got[2]) == pytest.approx(2.0)


def test_requantize_int32_to_int8():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, (4, 8)).astype(np.float32)

    def run(p):
        qx, xmn, xmx = p.nd.quantize_v2(p.nd.array(x))
        qw, wmn, wmx = p.nd.quantize_v2(p.nd.array(w))
        out32, omn, omx = p.nd.quantized_fully_connected(
            qx, qw, None, xmn, xmx, wmn, wmx, None, None, num_hidden=4,
            no_bias=True)
        q8, rmn, rmx = p.nd.requantize(out32, omn, omx)
        return [out32, q8, rmn, rmx, p.nd.dequantize(q8, rmn, rmx)]

    want, got = _both(run)
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g, v)
    assert got[1].dtype == np.int8
    assert np.abs(got[4] - x @ w.T).max() < 0.05


def test_quantized_conv_matches_fp32():
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, (4, 3, 3, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (4,)).astype(np.float32)

    def run(p):
        nd_ = p.nd
        qx, xmn, xmx = nd_.quantize_v2(nd_.array(x))
        qw, wmn, wmx = nd_.quantize_v2(nd_.array(w))
        qb, bmn, bmx = nd_.quantize_v2(nd_.array(b))
        out32, omn, omx = nd_.quantized_conv(
            qx, qw, qb, xmn, xmx, wmn, wmx, bmn, bmx, kernel=(3, 3),
            pad=(1, 1), num_filter=4)
        return [out32, nd_.dequantize(out32, omn, omx)]

    want, got = _both(run)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    ref = nd.Convolution(nd.array(x), nd.array(w), nd.array(b),
                         kernel=(3, 3), pad=(1, 1), num_filter=4).asnumpy()
    assert np.abs(got[1] - ref).max() < 0.2
    assert np.corrcoef(got[1].ravel(), ref.ravel())[0, 1] > 0.999


def _make_net(pkg, path=None):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="qnet_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, activation="relu"),
                nn.MaxPool2D(2), nn.Dense(32, activation="relu"),
                nn.Dense(10))
    if path is None:
        pkg.random.seed(0)
        net.initialize()
    return net


def _pair(tmp_path, x):
    """The JAX net (shapes resolved on ``x``) and the port's with its
    weights."""
    jnet = _make_net(jmx)
    jnet(jmx.nd.array(x))
    path = str(tmp_path / "q.params")
    jnet.save_parameters(path)
    net = _make_net(mx, path)
    net.load_parameters(path, ctx=mx.cpu(0))
    return jnet, net


def _small_collectors(monkeypatch, bins=1001):
    """Both packages' ``quantize_net`` calibrate with ``bins``-bin
    histograms (the JAX package's 8001-bin entropy search takes seconds
    a tensor; the search itself is held to it above)."""
    for q in (jqt, qt):
        base = q.CalibrationCollector

        class Small(base):
            def __init__(self, mode="naive", num_bins=bins, _b=base):
                _b.__init__(self, mode=mode, num_bins=num_bins)

        monkeypatch.setattr(q, "CalibrationCollector", Small)


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_net_close_to_fp32(tmp_path, monkeypatch, calib_mode):
    _small_collectors(monkeypatch)
    x = np.random.RandomState(0).uniform(-1, 1, (4, 3, 16, 16)).astype(
        np.float32)
    jnet, net = _pair(tmp_path, x)
    ref = net(nd.array(x)).asnumpy()
    outs = []
    for pkg, n, q in ((jmx, jnet, jqt), (mx, net, qt)):
        calib = [pkg.nd.array(x)] if calib_mode != "none" else None
        qnet = q.quantize_net(n, calib_mode=calib_mode, calib_data=calib)
        outs.append(qnet(pkg.nd.array(x)).asnumpy())
    want, got = outs
    _close(got, want, STEP_TOL, "int8 net vs JAX")
    assert got.shape == ref.shape
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99
    assert np.abs(got - ref).max() < 0.25 * max(1.0, np.abs(ref).max())


def test_quantize_net_excludes_and_hybridize(tmp_path):
    x = np.random.RandomState(1).uniform(0, 1, (2, 3, 16, 16)).astype(
        np.float32)
    jnet, net = _pair(tmp_path, x)
    ref = net(nd.array(x)).asnumpy()
    jq = jqt.quantize_net(jnet, exclude_layers_match=["dense"])
    q = qt.quantize_net(net, exclude_layers_match=["dense"])
    denses = [b for b in q._children.values()
              if isinstance(b, gluon.nn.Dense)]
    assert len(denses) == 2
    q.hybridize()
    out = q(nd.array(x)).asnumpy()
    _close(out, jq(jmx.nd.array(x)).asnumpy(), STEP_TOL, "vs JAX")
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.99
    np.testing.assert_array_equal(q(nd.array(x)).asnumpy(), out)


def _jax_kl_curve(hist, edges):
    """The JAX package's KL curve: its ``_get_optimal_threshold`` run
    with a numpy whose ``argmin`` records what it is given."""
    seen = {}

    class _Np:
        def __getattr__(self, name):
            return getattr(np, name)

        def argmin(self, a):
            seen["kl"] = list(a)
            return np.argmin(a)

    real = jqt.np
    jqt.np = _Np()
    try:
        t = jqt._get_optimal_threshold(hist, edges)
    finally:
        jqt.np = real
    return t, seen["kl"]


def _histograms():
    rng = np.random.RandomState(0)
    outlier = np.concatenate([rng.normal(0, 1, 100000),
                              [1000.0]]).astype(np.float32)
    gauss = rng.normal(0.3, 2.0, 50000).astype(np.float32)
    relu = np.maximum(rng.normal(0, 1, 50000), 0).astype(np.float32)
    return {"outlier": (outlier, 8001), "gaussian": (gauss, 2001),
            "relu": (relu, 2001)}


@pytest.mark.parametrize("case", ["outlier", "gaussian", "relu"])
def test_entropy_threshold_equals_the_jax_packages(case):
    """The same histogram (the JAX collector's) gives the same threshold
    and, candidate for candidate, the same KL divergences within 1e-9
    relative; an 8001-bin search takes at most 0.5 s here."""
    data, bins = _histograms()[case]
    c = jqt.CalibrationCollector(mode="entropy", num_bins=bins)
    c.collect("t", data)
    hist, edges = c.hists["t"]
    seconds = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = qt._get_optimal_threshold(hist, edges)
        seconds.append(time.perf_counter() - t0)
    thresholds, kl = qt._kl_curve(hist, edges)
    want, jkl = _jax_kl_curve(hist, edges)
    assert got == want
    assert len(kl) == len(jkl)
    np.testing.assert_allclose(kl, jkl, rtol=1e-9, atol=0)
    assert len(thresholds) == len(kl)
    if bins == 8001:
        assert min(seconds) <= 0.5, seconds


def test_entropy_threshold_ignores_outlier():
    data, _bins = _histograms()["outlier"]
    outs = []
    for q in (jqt, qt):
        c = q.CalibrationCollector(mode="entropy")
        c.collect("t", data[:50000])
        c.collect("t", data[50000:])
        (mn, mxr), = c.ranges().values()
        outs.append((mn, mxr))
    assert outs[1] == outs[0]
    assert outs[1][1] < 100.0 and outs[1][0] == -outs[1][1]


def _fc_symbol(pkg):
    s = pkg.sym
    fc1 = s.FullyConnected(s.var("data"), s.var("fc1_weight"),
                           s.var("fc1_bias"), num_hidden=16, name="fc1")
    act = s.Activation(fc1, act_type="relu")
    return s.FullyConnected(act, s.var("fc2_weight"), s.var("fc2_bias"),
                            num_hidden=4, name="fc2")


def test_quantize_model_symbolic():
    rng = np.random.RandomState(0)
    args = {"fc1_weight": (rng.randn(16, 8) * 0.3).astype(np.float32),
            "fc1_bias": (rng.randn(16) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(4, 16) * 0.3).astype(np.float32),
            "fc2_bias": (rng.randn(4) * 0.1).astype(np.float32)}
    x = rng.randn(8, 8).astype(np.float32)
    outs = []
    for pkg, q in ((jmx, jqt), (mx, qt)):
        a = {k: pkg.nd.array(v) for k, v in args.items()}
        ref = _fc_symbol(pkg).eval(data=pkg.nd.array(x), **a)[0].asnumpy()
        qsym, qargs, _ = q.quantize_model(_fc_symbol(pkg), a,
                                          calib_mode="naive",
                                          calib_data=[pkg.nd.array(x)])
        got = qsym.eval(data=pkg.nd.array(x), **qargs)[0].asnumpy()
        outs.append((ref, qsym.list_arguments(),
                     {k: v.asnumpy() for k, v in qargs.items()}, got))
    (jref, jnames, jargs, jgot), (ref, names, qargs, got) = outs
    assert names == jnames and "fc1_weight_quantize" in names
    assert sorted(qargs) == sorted(jargs)
    for k in qargs:
        np.testing.assert_array_equal(qargs[k], jargs[k], err_msg=k)
    assert qargs["fc1_weight_quantize"].dtype == np.int8
    _close(got, jgot, STEP_TOL, "quantized graph vs JAX")
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99
    assert np.abs(got - ref).max() < 0.25 * max(1.0, np.abs(ref).max())


def test_quantize_model_excluded_layer_stays_fp32():
    names = []
    for pkg, q in ((jmx, jqt), (mx, qt)):
        s = pkg.sym
        fc1 = s.FullyConnected(s.var("data"), s.var("w1"), num_hidden=8,
                               no_bias=True, name="fc1")
        qsym, _ = q.quantize_graph(fc1, excluded_sym_names=["fc1"])
        assert "w1_quantize" not in qsym.list_arguments()
        assert "w1" in qsym.list_arguments()
        qsym, _ = q.quantize_graph(fc1)
        names.append(qsym.list_arguments())
    assert names[1] == names[0]
    assert sorted(names[1]) == ["data", "w1_max", "w1_min", "w1_quantize"]


def test_zero_range_all_zero_batch_keeps_bias(tmp_path):
    outs = []
    for pkg, q in ((jmx, jqt), (mx, qt)):
        nn = pkg.gluon.nn
        dense = nn.Dense(4, in_units=3, prefix="zd_")
        net = nn.HybridSequential(prefix="zn_")
        net.add(dense)
        net.initialize()
        dense.bias.set_data(pkg.nd.array([1.0, -2.0, 3.0, 0.5]))
        dense.weight.set_data(pkg.nd.array(
            np.arange(12, dtype=np.float32).reshape(4, 3) / 10))
        x = pkg.nd.zeros((2, 3))
        ref = net(x).asnumpy()
        out = q.quantize_net(net)(x).asnumpy()
        assert np.isfinite(out).all()
        assert np.abs(out - ref).max() < 0.05, (out, ref)
        outs.append(out)
    np.testing.assert_array_equal(outs[1], outs[0])


def _bert_clf(pkg, path=None):
    from importlib import import_module
    bert = import_module(pkg.__name__ + ".models.bert")
    enc = bert.BERTModel(vocab_size=64, units=32, hidden_size=64,
                         num_layers=2, num_heads=4, max_length=16,
                         dropout=0.0, use_flash=True, prefix="qbert_")
    clf = bert.BERTClassifier(enc, num_classes=3, dropout=0.0,
                              prefix="qclf_")

    class Packed(pkg.gluon.HybridBlock):
        """The classifier over one (B, 3, L) array: token ids, token
        types and the valid length, for a calibration batch of one
        array."""

        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.clf = clf

        def hybrid_forward(self, F, x):
            ids = F.squeeze(F.slice_axis(x, axis=1, begin=0, end=1), axis=1)
            tt = F.squeeze(F.slice_axis(x, axis=1, begin=1, end=2), axis=1)
            vl = F.reshape(F.slice_axis(F.slice_axis(
                x, axis=1, begin=2, end=3), axis=2, begin=0, end=1),
                shape=(-1,))
            return self.clf(ids, tt, vl)

    net = Packed(prefix="qpk_")
    if path is None:
        pkg.random.seed(0)
        net.initialize(pkg.init.Normal(0.05))
    else:
        net.load_parameters(path, ctx=mx.cpu(0))
    return net


def _bert_batch(seed):
    rng = np.random.RandomState(seed)
    x = np.zeros((4, 3, 16), np.float32)
    x[:, 0] = rng.randint(0, 64, (4, 16))
    x[:, 1, 8:] = 1
    x[:, 2] = np.array([16, 9, 12, 5])[:, None]
    return x


def test_bert_classifier_quantize_net(tmp_path):
    """A two-layer flash ``BERTClassifier``: ``quantize_net`` with naive
    calibration over two batches swaps all 10 Dense layers (qkv,
    out_proj and two FFN layers a layer, the pooler, the classifier) in
    both packages; the int8 logits equal the JAX package's within
    ``STEP_TOL`` of max|logit|, eager and hybridized, and keep the float
    model's ranking (correlation > 0.99)."""
    jnet = _bert_clf(jmx)
    x0, x1 = _bert_batch(0), _bert_batch(1)
    jnet(jmx.nd.array(x0))
    path = str(tmp_path / "qbert.params")
    jnet.save_parameters(path)
    net = _bert_clf(mx, path)
    ref = net(nd.array(x1)).asnumpy()
    jq = jqt.quantize_net(jnet, calib_mode="naive",
                          calib_data=[jmx.nd.array(x0), jmx.nd.array(x1)])
    q = qt.quantize_net(net, calib_mode="naive",
                        calib_data=[nd.array(x0), nd.array(x1)])
    kinds = [type(b).__name__ for b in q._iter_blocks()]
    assert kinds.count("QuantizedDense") == 10
    assert "Dense" not in kinds
    want = jq(jmx.nd.array(x1)).asnumpy()
    got = q(nd.array(x1)).asnumpy()
    _close(got, want, STEP_TOL, "int8 BERT vs JAX")
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99
    q.hybridize()
    _close(q(nd.array(x1)).asnumpy(), got, 1e-6, "hybridized vs eager")
    _close(q(nd.array(x1)).asnumpy(), got, 1e-6, "replay vs eager")
