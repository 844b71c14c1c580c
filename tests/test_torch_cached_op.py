"""PyTorch port, the CachedOp tier of ``hybridize``
(``mxnet_tpu_torch/gluon/cached_op.py``).

Twins of ``tests/test_gluon.py::test_cached_op_reuse``,
``::test_cached_op_cache_bounded_lru``, ``::test_cached_op_bucket_shapes``
and ``::test_cached_op_bucket_pad_keeps_input_grads``, of
``tests/test_autograd.py::test_retain_graph_hybrid_block_second_backward``
and of ``tests/test_loss.py::test_loss_hybridize_consistency``, on the
CPU's static-buffer path (no graphs), and the port's own cases: a
replaced parameter value (``set_data``, a per-parameter optimizer's
write) reaches the next call, BatchNorm's running statistics accumulate,
two recorded calls of one signature keep their own saved tensors,
nested outputs, deferred initialisation, and hybridized outputs against
the JAX package's.

The card's control flow runs here on :class:`StandIn`, a CUDA-less
stand-in of ``cached_op._CudaGraphs``: a capture runs the function once
with host reads raising, as they do inside a CUDA capture, and a replay
runs it again into the captured outputs (a faithful replay for a
forward that keeps no autograd graph).
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import KernelError, MXNetError
from mxnet_tpu_torch.gluon import cached_op, nn
from mxnet_tpu_torch.gluon.block import nb_cached_programs


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


# ---------------------------------------------------------------------------
# the stand-in of the card's graph backend
# ---------------------------------------------------------------------------
_HOST_READS = ("cpu", "numpy", "tolist", "item")


@contextlib.contextmanager
def _no_host_reads():
    saved = {n: getattr(torch.Tensor, n) for n in _HOST_READS}

    def refuse(*_a, **_k):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    try:
        for n in _HOST_READS:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


class _StandInGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        with torch.no_grad():
            new = self.fn()
            if isinstance(self.out, (list, tuple)):
                for dst, src in zip(self.out, new):
                    if isinstance(dst, torch.Tensor):
                        dst.copy_(src)


class StandIn:
    """``cached_op._CudaGraphs`` without CUDA (module docstring)."""

    captures = 0

    def __init__(self, device):
        self.device = device
        self.stream = None

    def pool(self):
        return None

    def capture(self, fn, pool):
        StandIn.captures += 1
        with _no_host_reads():
            out = fn()
        return _StandInGraph(fn, out), out

    @contextlib.contextmanager
    def on_stream(self):
        yield None

    def memory(self):
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """Programs built inside the test take the card's path on
    :class:`StandIn`."""
    monkeypatch.setattr(cached_op, "_graph_backend", StandIn)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, stream: None)
    StandIn.captures = 0
    return StandIn


def _mlp():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu", in_units=6))
        net.add(nn.Dense(8, in_units=32))
    return net


def _twins(build, seed=0):
    """Two copies of ``build()`` with the same weights: (eager, hybrid)."""
    mx.random.seed(seed)
    a = build()
    a.initialize(mx.init.Xavier())
    b = build()
    b.initialize()
    for pa, pb in zip(a.collect_params().values(),
                      b.collect_params().values()):
        pb.set_data(pa.data())
    b.hybridize()
    return a, b


def _r(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# twins of the reference's tests
# ---------------------------------------------------------------------------
def test_cached_op_reuse():
    net = _mlp()
    net.initialize()
    net.hybridize()
    x = nd.ones((2, 6))
    before = nb_cached_programs()
    net(x)
    net(x)
    net(x)
    after_same = nb_cached_programs()
    assert after_same == before + 1
    net(nd.ones((4, 6)))
    assert nb_cached_programs() == after_same + 1


def test_cached_op_cache_bounded_lru():
    net = nn.Dense(4, in_units=8, prefix="lru_dense_")
    net.initialize()
    net.hybridize(cache_size=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for B in (1, 2, 3, 4):
            net(nd.zeros((B, 8)))
        cop = net._cached_op
        assert len(cop._cache) == 2
        assert cop._n_evictions == 2
        assert any("eviction" in str(x.message) for x in w)
    net(nd.zeros((4, 8)))
    net(nd.zeros((5, 8)))
    sigs = [s[0][0][0] for s in cop._cache]
    assert (4, 8) in sigs and (5, 8) in sigs
    assert cop.stats()["evictions"] == 3


def test_cached_op_bucket_shapes():
    net = nn.Dense(4, flatten=False, in_units=8, prefix="bkt_dense_")
    net.initialize()
    net.hybridize(bucket_shapes={1: [4, 8]})
    n0 = nb_cached_programs()
    out3 = net(nd.ones((2, 3, 8)))
    assert out3.shape == (2, 4, 4)
    net(nd.ones((2, 4, 8)))
    net(nd.ones((2, 6, 8)))
    net(nd.ones((2, 7, 8)))
    assert nb_cached_programs() - n0 == 2
    ref = net(nd.ones((2, 4, 8))).asnumpy()
    np.testing.assert_allclose(out3.asnumpy()[:, :3], ref[:, :3], rtol=1e-5)
    with pytest.raises(MXNetError, match="larger than the largest"):
        net(nd.ones((2, 9, 8)))


def test_cached_op_bucket_pad_keeps_input_grads():
    net = nn.Dense(4, flatten=False, in_units=8, prefix="bktg_dense_")
    net.initialize()
    net.hybridize(bucket_shapes={1: [4, 8]})
    x = nd.random.uniform(shape=(2, 3, 8))
    x.attach_grad()
    with autograd.record():
        y = net(x)
    y.backward()
    assert np.abs(x.grad.asnumpy()).sum() > 0
    net2 = nn.Dense(4, flatten=False, in_units=8, prefix="bktg2_dense_")
    net2.initialize()
    for p1, p2 in zip(net.collect_params().values(),
                      net2.collect_params().values()):
        p2.set_data(p1.data())
    x2 = nd.array(x.asnumpy())
    x2.attach_grad()
    with autograd.record():
        y2 = net2(x2)
    y2.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), x2.grad.asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_retain_graph_hybrid_block_second_backward():
    net = nn.Dense(3, in_units=4)
    net.initialize()
    net.hybridize(static_alloc=True)
    x = nd.random.uniform(shape=(2, 4))
    x.attach_grad()
    with autograd.record():
        y = net(x).sum()
    y.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    y.backward()
    assert np.allclose(x.grad.asnumpy(), g1, rtol=1e-5)


def test_retain_graph_hybrid_block_step_between_backwards_raises(stand_in):
    """A Trainer step between the two backwards writes the weights the
    replayed backward reads: the second backward raises instead of
    giving a gradient at other weights than the forward's.  On the
    card's path (the stand-in), whose graphs skip autograd's version
    check."""
    net = nn.Dense(3, in_units=4)
    net.initialize()
    net.hybridize(static_alloc=True)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    x = nd.random.uniform(shape=(2, 4))
    x.attach_grad()
    for _ in range(3):                  # past the warm-up, onto replays
        with autograd.record():
            y = net(x).sum()
        y.backward(retain_graph=True)
        g1 = x.grad.asnumpy().copy()
        y.backward(retain_graph=True)
        np.testing.assert_allclose(x.grad.asnumpy(), g1, rtol=1e-5)
        tr.step(2)
        with pytest.raises(MXNetError, match="written in place"):
            y.backward()


def test_loss_hybridize_consistency():
    L = gluon.loss
    for loss_fn in [L.L2Loss(), L.SoftmaxCrossEntropyLoss(),
                    L.SigmoidBinaryCrossEntropyLoss()]:
        pred = nd.array(np.random.randn(4, 3).astype(np.float32))
        if isinstance(loss_fn, L.SoftmaxCrossEntropyLoss):
            label = nd.array(np.random.randint(0, 3, (4,)))
        else:
            label = nd.array(np.random.rand(4, 3).astype(np.float32))
        y1 = loss_fn(pred, label).asnumpy()
        loss_fn.hybridize()
        y2 = loss_fn(pred, label).asnumpy()
        assert np.allclose(y1, y2, atol=1e-5), type(loss_fn)
        assert loss_fn._cached_op.stats()["programs"] == 1


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------
def test_set_data_and_per_param_optimizer_reach_the_next_call():
    eager, hyb = _twins(_mlp)
    x = nd.array(_r((4, 6), 1))
    np.testing.assert_array_equal(hyb(x).asnumpy(), eager(x).asnumpy())
    w = _r((32, 6), 2)
    for net in (eager, hyb):
        net[0].weight.set_data(nd.array(w))
    np.testing.assert_array_equal(hyb(x).asnumpy(), eager(x).asnumpy())
    assert hyb._cached_op.stats()["param_copies"] == 1
    # RMSProp is not fused: its per-parameter update replaces every tensor
    for net in (eager, hyb):
        tr = gluon.Trainer(net.collect_params(), "rmsprop",
                           {"learning_rate": 0.01})
        with autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
        tr.step(4)
    np.testing.assert_array_equal(hyb(x).asnumpy(), eager(x).asnumpy())
    assert hyb._cached_op.stats()["param_copies"] == 1 + 4


def _bn_net():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, in_units=5), nn.BatchNorm(in_channels=8))
    return net


def test_batchnorm_statistics_accumulate_through_the_cached_op():
    eager, hyb = _twins(_bn_net)
    for step in range(3):
        x = nd.array(_r((6, 5), 10 + step))
        for net in (eager, hyb):
            with autograd.record():
                out = net(x)
            out.backward()
    for name in ("running_mean", "running_var"):
        a = getattr(eager[1], name).data().asnumpy()
        b = getattr(hyb[1], name).data().asnumpy()
        assert not np.allclose(b, 0.0 if name == "running_mean" else 1.0)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_two_recorded_calls_before_one_backward():
    grads = []
    for net in _twins(_mlp):
        x1, x2 = nd.array(_r((4, 6), 3)), nd.array(_r((4, 6), 4))
        x1.attach_grad()
        x2.attach_grad()
        with autograd.record():
            y1 = net(x1)
            y2 = net(x2)
            loss = (y1 * y1).sum() + (y2 * y2 * 3).sum()
        loss.backward()
        grads.append([x1.grad.asnumpy(), x2.grad.asnumpy()] + [
            p.grad().asnumpy() for p in net.collect_params().values()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    sig = net._cached_op.stats()["signatures"]
    assert [s["instances"] for s in sig] == [2]


def test_nested_outputs_and_deferred_init():
    class Split(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = nn.Dense(4)

        def hybrid_forward(self, F, x):
            h = self.dense(x)
            return h, (h * 2, F.relu(h))

    net = Split()
    net.initialize()
    net.hybridize()
    x = nd.array(_r((3, 5), 5))
    a, (b, c) = net(x)            # deferred: one plain pass finds shapes
    assert net.dense.weight.shape == (4, 5)
    n0 = nb_cached_programs()
    a2, (b2, c2) = net(x)
    assert nb_cached_programs() == n0 + 1
    for u, v in ((a, a2), (b, b2), (c, c2)):
        np.testing.assert_array_equal(u.asnumpy(), v.asnumpy())
    np.testing.assert_array_equal(b2.asnumpy(), 2 * a2.asnumpy())


def test_hybridized_block_matches_jax(tmp_path):
    def build(pkg):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=8),
                    pkg.gluon.nn.BatchNorm(in_channels=16),
                    pkg.gluon.nn.Dense(3, in_units=16))
        return net

    jnet, net = build(jmx), build(mx)
    jnet.initialize(jmx.init.Xavier())
    path = str(tmp_path / "mlp.npz")
    jnet.save_parameters(path)
    net.load_parameters(path)
    x = _r((5, 8), 6)
    res = []
    for pkg, ndm, model in ((mx, nd, net), (jmx, jnd, jnet)):
        model.hybridize()
        xa = ndm.array(x)
        xa.attach_grad()
        with pkg.autograd.record():
            out = model(xa)
        out.backward()
        with pkg.autograd.predict_mode():
            pred = model(ndm.array(x))
        res.append([out.asnumpy(), pred.asnumpy(), xa.grad.asnumpy()] + [
            p.grad().asnumpy() for p in model.collect_params().values()
            if p.grad_req != "null"])
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the card's control flow on the stand-in
# ---------------------------------------------------------------------------
def test_stand_in_warms_up_once_then_replays(stand_in):
    eager, hyb = _twins(_mlp)
    n0 = nb_cached_programs()
    for seed in range(4):
        x = nd.array(_r((4, 6), 20 + seed))
        np.testing.assert_allclose(hyb(x).asnumpy(), eager(x).asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    assert nb_cached_programs() == n0 + 1
    assert stand_in.captures == 1
    assert hyb._cached_op.stats()["replays"] == 3


def test_host_read_fails_the_capture_loudly(stand_in):
    class Reads(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * float(x.sum().asnumpy())

    net = Reads(prefix="hostread_")
    net.hybridize()
    x = nd.ones((2, 3))
    with pytest.raises(KernelError, match="hostread"):
        net(x)
    with pytest.raises(KernelError, match="failed earlier"):
        net(x)
    net.hybridize(False)
    np.testing.assert_array_equal(net(x).asnumpy(), np.full((2, 3), 6.0))
