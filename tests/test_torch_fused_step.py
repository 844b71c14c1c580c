"""PyTorch port, ``gluon.contrib.FusedTrainStep``
(``mxnet_tpu_torch/gluon/contrib/fused.py``) against the record /
backward / step recipe and the JAX package's ``FusedTrainStep``.

Twins of the 10 tests of ``tests/test_fused_step.py`` on the CPU, where
the step's program runs without a graph.  The nets start from one seed
in each package and the port's copies take the JAX net's weights
(``ParameterDict.load_dict``).  Tolerances: the fused step against the
three-call recipe, losses rtol 1e-5 and parameters rtol 1e-4 / atol 1e-6
(the reference's); against the JAX ``FusedTrainStep`` on the same
inputs, losses rtol 1e-5 and parameters atol 1e-5.

The failure twins inject at the port's seams: a launch that writes the
weights and then fails replaces the signature's ``_FusedUpdate._body``
(the eager body the CPU runs, as a replay on the card would have begun
writing them), and a failure before the launch replaces its
``_refresh`` (the step-varying scalars written before anything runs).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.contrib import FusedTrainStep as JFusedTrainStep

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import KernelError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.contrib import FusedTrainStep


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _net(m, n, seed, with_bn):
    m.random.seed(seed)
    net = n.HybridSequential()
    # explicit in_units: init draws happen eagerly under the seed, so
    # both copies start from identical weights
    net.add(n.Dense(16, activation="relu", in_units=4))
    if with_bn:
        net.add(n.BatchNorm(in_channels=16))
    net.add(n.Dense(1, in_units=16))
    net.initialize(m.init.Xavier())
    return net


def _jax_net(seed, with_bn=False):
    return _net(jmx, jnn, seed, with_bn)


def _make_pair(seed, with_bn=False, optimizer="adam", opt_args=None):
    """Two identical (net, trainer) pairs of the port, with the JAX net's
    weights carried across."""
    opt_args = dict(opt_args or {"learning_rate": 1e-2})
    want = {k: v.data().asnumpy()
            for k, v in _jax_net(seed, with_bn).collect_params().items()}
    nets = []
    for _ in range(2):
        net = _net(mx, nn, seed, with_bn)
        net.collect_params().load_dict(want)
        tr = gluon.Trainer(net.collect_params(), optimizer, dict(opt_args))
        nets.append((net, tr))
    return nets


class LossBlock(gluon.HybridBlock):
    def __init__(self, net, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.net = net

    def hybrid_forward(self, F, x, y):
        return ((self.net(x) - y) ** 2).mean()


class JLossBlock(jgluon.HybridBlock):
    def __init__(self, net, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.net = net

    def hybrid_forward(self, F, x, y):
        return ((self.net(x) - y) ** 2).mean()


def _params(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def test_matches_three_call_recipe():
    (net_a, tr_a), (net_b, tr_b) = _make_pair(0)
    rng = np.random.RandomState(0)
    X = rng.randn(64, 4).astype(np.float32)
    Y = rng.randn(64, 1).astype(np.float32)

    blk_a = LossBlock(net_a)
    blk_b = LossBlock(net_b)
    blk_a.hybridize(static_alloc=True)
    fused = FusedTrainStep(blk_b, tr_b)
    jnet = _jax_net(0)
    jfused = JFusedTrainStep(JLossBlock(jnet), jgluon.Trainer(
        jnet.collect_params(), "adam", {"learning_rate": 1e-2}))

    grads_before = [p.grad().asnumpy().copy()
                    for p in net_b.collect_params().values()]
    for step in range(5):
        x, y = nd.array(X), nd.array(Y)
        with autograd.record():
            la = blk_a(x, y)
        la.backward()
        tr_a.step(64)
        lb = fused(x, y, batch_size=64)
        lj = jfused(jnd.array(X), jnd.array(Y), batch_size=64)
        np.testing.assert_allclose(float(la.asscalar()),
                                   float(lb.asscalar()), rtol=1e-5)
        np.testing.assert_allclose(float(lb.asscalar()),
                                   float(lj.asscalar()), rtol=1e-5)
    # parameters identical after 5 steps
    for pa, pb, pj in zip(_params(net_a), _params(net_b), _params(jnet)):
        np.testing.assert_allclose(pa, pb, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(pb, pj, atol=1e-5)
    # the .grad buffers are not written
    for g0, p in zip(grads_before, net_b.collect_params().values()):
        np.testing.assert_array_equal(p.grad().asnumpy(), g0)


def test_lr_change_applies():
    (net_a, tr_a), (net_b, tr_b) = _make_pair(1, optimizer="sgd")
    rng = np.random.RandomState(1)
    X = rng.randn(32, 4).astype(np.float32)
    Y = rng.randn(32, 1).astype(np.float32)
    blk_a, blk_b = LossBlock(net_a), LossBlock(net_b)
    fused = FusedTrainStep(blk_b, tr_b)
    for step in range(4):
        if step == 2:
            tr_a.set_learning_rate(1e-3)
            tr_b.set_learning_rate(1e-3)
        x, y = nd.array(X), nd.array(Y)
        with autograd.record():
            la = blk_a(x, y)
        la.backward()
        tr_a.step(32)
        fused(x, y, batch_size=32)
    for pa, pb in zip(_params(net_a), _params(net_b)):
        np.testing.assert_allclose(pa, pb, rtol=1e-4, atol=1e-6)


def test_batchnorm_aux_states_update():
    (net, tr), _ = _make_pair(2, with_bn=True)
    jnet = _jax_net(2, with_bn=True)
    jfused = JFusedTrainStep(JLossBlock(jnet), jgluon.Trainer(
        jnet.collect_params(), "adam", {"learning_rate": 1e-2}))
    blk = LossBlock(net)
    fused = FusedTrainStep(blk, tr)
    bn = [b for b in net._children.values()
          if isinstance(b, nn.BatchNorm)][0]
    jbn = [b for b in jnet._children.values()
           if isinstance(b, jnn.BatchNorm)][0]
    before = bn.running_mean.data().asnumpy().copy()
    rng = np.random.RandomState(2)
    for _ in range(3):
        xs = rng.randn(32, 4).astype(np.float32) + 5.0
        fused(nd.array(xs), nd.zeros((32, 1)))
        jfused(jnd.array(xs), jnd.zeros((32, 1)))
    after = bn.running_mean.data().asnumpy()
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_allclose(after, jbn.running_mean.data().asnumpy(),
                               atol=1e-5)


def test_convergence():
    (net, tr), _ = _make_pair(3)
    blk = LossBlock(net)
    fused = FusedTrainStep(blk, tr)
    rng = np.random.RandomState(3)
    X = rng.randn(128, 4).astype(np.float32)
    Y = (X.sum(1, keepdims=True) * 0.5).astype(np.float32)
    first = last = None
    for i in range(150):
        loss = fused(nd.array(X), nd.array(Y))
        if i == 0:
            first = float(loss.asscalar())
    last = float(loss.asscalar())
    assert last < 0.1 * first, (first, last)


def test_sparse_grad_rejected():
    (net, tr), _ = _make_pair(7)
    p = next(iter(net.collect_params().values()))
    p._grad_stype = "row_sparse"
    with pytest.raises(mx.MXNetError, match="grad_stype"):
        FusedTrainStep(LossBlock(net), tr)


def test_grad_add_rejected():
    (net, tr), _ = _make_pair(4)
    for p in net.collect_params().values():
        p.grad_req = "add"
    with pytest.raises(mx.MXNetError, match="grad_req='add'"):
        FusedTrainStep(LossBlock(net), tr)


def test_save_load_still_works(tmp_path):
    (net, tr), _ = _make_pair(5)
    blk = LossBlock(net)
    fused = FusedTrainStep(blk, tr)
    rng = np.random.RandomState(5)
    fused(nd.array(rng.randn(8, 4).astype(np.float32)),
          nd.array(rng.randn(8, 1).astype(np.float32)))
    f = str(tmp_path / "net.params")
    net.save_parameters(f)
    (net2, _), _ = _make_pair(6)
    net2(nd.ones((1, 4)))          # shape init
    net2.load_parameters(f)
    for pa, pb in zip(_params(net), _params(net2)):
        np.testing.assert_allclose(pa, pb)
    # the JAX package reads the port's file
    jnet = _jax_net(6)
    jnet.load_parameters(f)
    for pa, pj in zip(_params(net), _params(jnet)):
        np.testing.assert_allclose(pa, pj)


def _only_entry(step):
    (entry,) = step._cache.values()
    return entry


def test_failure_recovery_poison_and_reset(tmp_path):
    """A step failing after its launch began writing the weights poisons
    the instance, rolls back update counts, and reset() (after a
    reload) makes training work again."""
    (net, tr), _ = _make_pair(3)
    rng = np.random.RandomState(3)
    x = nd.array(rng.randn(8, 4).astype(np.float32))
    y = nd.array(rng.randn(8, 1).astype(np.float32))
    step = FusedTrainStep(LossBlock(net), tr)
    step(x, y)  # build + one good step
    net.save_parameters(str(tmp_path / "fused_recover.params"))
    o = tr._optimizer
    counts_before = dict(o._index_update_count)
    num_update_before = o.num_update
    saved = _params(net)

    update = _only_entry(step).update
    real_body = update._body

    def failing_body():
        # emulate a launch that wrote part of the weights, then failed
        update.bound[0].add_(1.0)
        raise RuntimeError("synthetic post-launch failure")

    update._body = failing_body
    with pytest.raises(mx.MXNetError, match="donated") as err:
        step(x, y)
    assert isinstance(err.value, KernelError)
    # counts rolled back: the failed step must not advance schedules
    assert dict(o._index_update_count) == counts_before
    assert o.num_update == num_update_before
    # subsequent calls raise the poisoned guidance without touching counts
    with pytest.raises(KernelError, match="reset"):
        step(x, y)
    assert dict(o._index_update_count) == counts_before

    update._body = real_body
    net.load_parameters(str(tmp_path / "fused_recover.params"))
    for a, b in zip(_params(net), saved):
        np.testing.assert_array_equal(a, b)
    step.reset()
    l1 = float(step(x, y).asnumpy())
    l2 = float(step(x, y).asnumpy())
    assert np.isfinite(l1) and np.isfinite(l2) and l2 < l1


def test_failure_before_donation_does_not_poison():
    """A failure before the launch writes nothing: weights stay intact,
    the counts roll back and the instance is NOT poisoned."""
    (net, tr), _ = _make_pair(4)
    rng = np.random.RandomState(4)
    x = nd.array(rng.randn(8, 4).astype(np.float32))
    y = nd.array(rng.randn(8, 1).astype(np.float32))
    step = FusedTrainStep(LossBlock(net), tr)
    step(x, y)
    o = tr._optimizer
    counts_before = dict(o._index_update_count)
    saved = _params(net)
    update = _only_entry(step).update
    real_refresh = update._refresh

    def pre_launch_fail():
        raise ValueError("synthetic compile failure")

    update._refresh = pre_launch_fail
    with pytest.raises(ValueError, match="synthetic compile"):
        step(x, y)
    assert step._poisoned is None
    assert dict(o._index_update_count) == counts_before
    for a, b in zip(_params(net), saved):
        np.testing.assert_array_equal(a, b)
    update._refresh = real_refresh
    # weights intact, training continues without reset
    assert np.isfinite(float(step(x, y).asnumpy()))


def test_reset_keeps_reloaded_optimizer_states():
    """reset() must not wipe optimizer states the user restored — only
    states the failed launch was writing are dropped."""
    (net, tr), _ = _make_pair(5)
    rng = np.random.RandomState(5)
    x = nd.array(rng.randn(8, 4).astype(np.float32))
    y = nd.array(rng.randn(8, 1).astype(np.float32))
    step = FusedTrainStep(LossBlock(net), tr)
    step(x, y)
    upd = tr._updater
    live_states = dict(upd.states)
    step._poisoned = RuntimeError("synthetic")
    step.reset()
    assert upd.states == live_states  # live states preserved
    # a state the failed launch was writing is dropped unless restored
    step._poisoned = RuntimeError("synthetic")
    step._consumed = {0: upd.states[0], 1: upd.states[1]}
    upd.states[1] = tuple(s.copy() for s in upd.states[1])   # restored
    restored = upd.states[1]
    step.reset()
    assert 0 not in upd.states and upd.states[1] is restored
    assert np.isfinite(float(step(x, y).asnumpy()))
