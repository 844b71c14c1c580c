"""PyTorch port, ``gluon.contrib`` (``mxnet_tpu_torch/gluon/contrib/{nn,
rnn,estimator}.py``) against the JAX package.

Twins of the 8 tests of ``tests/test_gluon_contrib.py`` on the same
numpy inputs, with the JAX blocks' weights carried across
(``save_parameters``): values within rtol 1e-5 / atol 1e-6, gradients
within 1e-5 of their max, index-like results exactly.  Dropout masks
come from each package's own generator, so ``VariationalDropoutCell`` is
held to the JAX cell with the same mask set on both.  Beyond them:
``Estimator.fit`` over 2 epochs and ``evaluate``, against the JAX
package's (per-epoch metrics exactly, weights within 1e-5 of their
max).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.contrib import estimator as jestimator
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu.gluon.contrib import rnn as jcrnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn, rnn
from mxnet_tpu_torch.gluon.contrib import estimator
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from mxnet_tpu_torch.gluon.contrib import rnn as crnn

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_of_max(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert float(np.abs(got - want).max()) <= tol * max(
        float(np.abs(want).max()), 1e-30)


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _carry(jblock, block, tmp_path):
    path = str(tmp_path / "w.npz")
    jblock.save_parameters(path)
    block.load_parameters(path)


# ---------------------------------------------------------------------------
# tests/test_gluon_contrib.py
# ---------------------------------------------------------------------------
def test_concurrent_and_identity(tmp_path):
    def build(c, n):
        con = c.HybridConcurrent(axis=1)
        con.add(n.Dense(3), c.Identity(), n.Dense(2))
        return con

    x = _rand((2, 4), 0)
    jcon = build(jcnn, jnn)
    jcon.initialize()
    want = jcon(jnd.array(x)).asnumpy()
    con = build(cnn, nn)
    con.initialize()
    con(nd.array(x))
    _carry(jcon, con, tmp_path)
    out = con(nd.array(x))
    assert out.shape == (2, 3 + 4 + 2)
    _close(out.asnumpy(), want)
    _close(out.asnumpy()[:, 3:7], x)
    con.hybridize()
    for _ in range(2):
        _close(con(nd.array(x)).asnumpy(), out.asnumpy())
    assert cnn.Concurrent.__mro__[1] is cnn.HybridConcurrent


def test_pixelshuffle2d():
    x = np.arange(2 * 8 * 3 * 3, dtype=np.float32).reshape((2, 8, 3, 3))
    for factor, shape in ((2, (2, 2, 6, 6)), ((1, 2), (2, 4, 3, 6))):
        y = cnn.PixelShuffle2D(factor)(nd.array(x))
        assert y.shape == shape
        np.testing.assert_array_equal(
            y.asnumpy(), jcnn.PixelShuffle2D(factor)(jnd.array(x)).asnumpy())
        np.testing.assert_array_equal(np.sort(y.asnumpy().ravel()),
                                      np.sort(x.ravel()))
    with pytest.raises(mx.MXNetError, match="divisible"):
        cnn.PixelShuffle2D(3)(nd.array(x))


def test_sync_batchnorm_matches_batchnorm():
    x = _rand((4, 3, 5, 5), 1)
    a = cnn.SyncBatchNorm(num_devices=8)
    b = nn.BatchNorm()
    ja = jcnn.SyncBatchNorm(num_devices=8)
    for blk in (a, b, ja):
        blk.initialize()
    with autograd.record():
        ya = a(nd.array(x))
    with autograd.record():
        yb = b(nd.array(x))
    with jautograd.record():
        yj = ja(jnd.array(x))
    _close(ya.asnumpy(), yb.asnumpy())
    _close(ya.asnumpy(), yj.asnumpy())
    _close(a.running_mean.data().asnumpy(), ja.running_mean.data().asnumpy())
    _close(a.running_var.data().asnumpy(), ja.running_var.data().asnumpy())
    # inference reads the running statistics
    _close(a(nd.array(x)).asnumpy(), ja(jnd.array(x)).asnumpy())


def test_sparse_embedding_trains_only_touched_rows():
    def run(m, c):
        se = c.SparseEmbedding(20, 4)
        se.initialize(m.init.Constant(0.25))
        tr = m.gluon.Trainer(se.collect_params(), "sgd",
                             {"learning_rate": 1.0})
        x = m.nd.array([2, 7, 7], dtype="int32")
        with m.autograd.record():
            se(x).sum().backward()
        before = se.weight.data().asnumpy().copy()
        tr.step(1)
        return before, se.weight.data().asnumpy()

    before, after = run(mx, cnn)
    _jbefore, jafter = run(jmx, jcnn)
    changed = np.abs(after - before).sum(axis=1) > 0
    assert changed[2] and changed[7]
    assert not changed[0] and not changed[19]
    np.testing.assert_array_equal(after, jafter)


def _vd_pair(tmp_path, **drops):
    jvd = jcrnn.VariationalDropoutCell(jrnn.LSTMCell(4, input_size=6),
                                       **drops)
    jvd.initialize()
    vd = crnn.VariationalDropoutCell(rnn.LSTMCell(4, input_size=6), **drops)
    vd.initialize()
    _carry(jvd, vd, tmp_path)
    return jvd, vd


def test_variational_dropout_same_mask_across_steps(tmp_path):
    mx.random.seed(3)
    jvd, vd = _vd_pair(tmp_path, drop_inputs=0.5)
    vd.reset()
    x = nd.ones((2, 6))
    with autograd.record():
        _, s = vd(x, vd.begin_state(batch_size=2))
        mask1 = vd._mask_in.asnumpy().copy()
        vd(x, s)
        mask2 = vd._mask_in.asnumpy()
    np.testing.assert_array_equal(mask1, mask2)
    assert set(np.unique(mask1)) <= {0.0, 2.0}
    vd.reset()
    with autograd.record():
        vd(x, vd.begin_state(batch_size=2))
    assert not np.array_equal(vd._mask_in.asnumpy(), mask1)
    # the JAX cell under the same mask: the same two steps
    xs = _rand((2, 6), 4)
    outs = []
    for m, ag, cell in ((mx, autograd, vd), (jmx, jautograd, jvd)):
        cell.reset()
        cell._mask_in = m.nd.array(mask1)
        with ag.record():
            o1, st = cell(m.nd.array(xs), cell.begin_state(batch_size=2))
            o2, st = cell(m.nd.array(xs), st)
        outs.append([o1.asnumpy(), o2.asnumpy()] +
                    [v.asnumpy() for v in st])
    for g, w in zip(*outs):
        _close(g, w)


def test_conv2d_lstm_cell_unroll(tmp_path):
    def build(c):
        return c.Conv2DLSTMCell((3, 6, 6), 4, 3, 3, i2h_pad=1)

    jcell, cell = build(jcrnn), build(crnn)
    jcell.initialize()
    cell.initialize()
    _carry(jcell, cell, tmp_path)
    xs = [_rand((2, 3, 6, 6), 5 + i) for i in range(3)]
    got = []
    for m, ag, c in ((mx, autograd, cell), (jmx, jautograd, jcell)):
        arrs = [m.nd.array(x) for x in xs]
        outs, states = c.unroll(3, arrs, layout="TNC", merge_outputs=False)
        assert len(outs) == 3 and outs[-1].shape == (2, 4, 6, 6)
        assert states[0].shape == (2, 4, 6, 6)
        for p in c.collect_params().values():
            p.grad_req = "write"
        with ag.record():
            outs2, _ = c.unroll(3, arrs, layout="TNC", merge_outputs=False)
            outs2[-1].sum().backward()
        got.append(([o.asnumpy() for o in outs] +
                    [s.asnumpy() for s in states],
                    {k: p.grad().asnumpy() for k, p in
                     c._collect_params_with_prefix().items()}))
    (vals, grads), (jvals, jgrads) = got
    for g, w in zip(vals, jvals):
        _close(g, w)
    assert sorted(grads) == sorted(jgrads)
    assert np.abs(grads["i2h_weight"]).sum() > 0
    for k, g in grads.items():
        _close_of_max(g, jgrads[k])


def test_conv2d_lstm_default_pad_geometry(tmp_path):
    jcell = jcrnn.Conv2DLSTMCell((3, 6, 6), 4, 3, 3)
    cell = crnn.Conv2DLSTMCell((3, 6, 6), 4, 3, 3)
    jcell.initialize()
    cell.initialize()
    _carry(jcell, cell, tmp_path)
    x = _rand((2, 3, 6, 6), 9)
    out, st = cell(nd.array(x), cell.begin_state(batch_size=2))
    jout, jst = jcell(jnd.array(x), jcell.begin_state(batch_size=2))
    assert out.shape == (2, 4, 4, 4)
    _close(out.asnumpy(), jout.asnumpy())
    for s, js in zip(st, jst):
        _close(s.asnumpy(), js.asnumpy())
    with pytest.raises(mx.MXNetError, match="odd"):
        crnn.Conv2DLSTMCell((3, 6, 6), 4, 3, 2)
    with pytest.raises(mx.MXNetError, match="no output"):
        crnn.Conv2DLSTMCell((3, 2, 2), 4, 5, 3)


def test_variational_dropout_hybridize_raises():
    vd = crnn.VariationalDropoutCell(rnn.LSTMCell(4, input_size=6),
                                     drop_inputs=0.5)
    vd.initialize()
    vd.hybridize()
    vd.reset()
    x = nd.ones((2, 6))
    with pytest.raises(mx.MXNetError, match="hybridiz"):
        with autograd.record():
            vd(x, vd.begin_state(batch_size=2))


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------
def _estimator_run(m, est_mod, batches, path, epochs):
    net = m.gluon.nn.HybridSequential()
    net.add(m.gluon.nn.Dense(8, activation="relu"), m.gluon.nn.Dense(3))
    net.initialize()
    net(m.nd.array(batches[0][0]))
    net.load_parameters(path)
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.5, "momentum": 0.9})
    est = est_mod.Estimator(net, m.gluon.loss.SoftmaxCrossEntropyLoss(),
                            train_metrics=[m.metric.Accuracy()],
                            trainer=trainer)
    data = [(m.nd.array(x), m.nd.array(y)) for x, y in batches]
    history = est.fit(data, epochs=epochs)
    evaluated = est.evaluate(data)
    return history, evaluated, {k: p.data().asnumpy() for k, p in
                                net._collect_params_with_prefix().items()}


def test_estimator_fit_two_epochs_against_jax(tmp_path):
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 5).astype(np.float32) * 2
    batches = []
    for _ in range(4):
        y = rng.randint(0, 3, 16)
        x = (centers[y] + rng.randn(16, 5)).astype(np.float32)
        batches.append((x, y.astype(np.float32)))
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(8, activation="relu"), jnn.Dense(3))
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(batches[0][0]))
    path = str(tmp_path / "est.npz")
    jnet.save_parameters(path)
    got = _estimator_run(mx, estimator, batches, path, 2)
    want = _estimator_run(jmx, jestimator, batches, path, 2)
    assert len(got[0]) == 2 and got[0] == want[0]
    assert got[1] == want[1]
    assert got[0][-1]["accuracy"] > got[0][0]["accuracy"] - 1e-9
    for k, v in got[2].items():
        _close_of_max(v, want[2][k])
    with pytest.raises(mx.MXNetError, match="Trainer"):
        estimator.Estimator(nn.Dense(2), gluon.loss.L2Loss()).fit([])
