"""PyTorch port, ``gluon.Trainer``, the optimizers and the lr schedulers
(``mxnet_tpu_torch/{gluon/trainer,optimizer,ops/optimizer_ops,
lr_scheduler}.py``).

Twins of the tests of ``tests/test_gluon_trainer.py`` that do not drive
the fused tiers (``:37-150``: the loss falls under each optimizer, the lr
scheduler, save / load of states, ``zero_grad``, gradient accumulation,
``clip_global_norm`` and ``split_and_load``) and of
``test_clip_global_norm_nan_preserves_arrays``.  The fused tiers
(``test_fused_update_*``, ``TestFusedHybridStep``, the one-program clip)
wait with the CachedOp tier.

Against the JAX package, from weights carried across by file and on the
same numpy batches: three ``Trainer`` steps of a two-layer MLP under
every optimizer class of ``mxnet_tpu/optimizer/optimizer.py`` give the
same parameters within rtol 1e-5 / atol 1e-6 (LAMB's trust ratio and
LARS's norms are float32 reductions taken in another order: rtol 1e-4);
the lr schedulers give the same rates; and a fresh trainer that loads
the saved momentum takes the same fourth step in both packages.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, lr_scheduler, nd
from mxnet_tpu_torch import runtime_metrics as rm


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _net(pkg=mx):
    nnm = pkg.gluon.nn
    net = nnm.HybridSequential()
    with net.name_scope():
        net.add(nnm.Dense(16, activation="relu", in_units=8))
        net.add(nnm.Dense(4, in_units=16))
    return net


def _step(net, trainer, x, y, pkg=mx):
    loss_fn = pkg.gluon.loss.L2Loss()
    with pkg.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return float(loss.mean().asscalar())


# ---------------------------------------------------------------------------
# tests/test_gluon_trainer.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2}),
    ("adamw", {"learning_rate": 1e-2}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("rmsprop", {"learning_rate": 1e-2}),
    ("lamb", {"learning_rate": 1e-2}),
])
def test_trainer_decreases_loss(opt, kw):
    net = _net()
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), opt, kw)
    x = nd.random.uniform(shape=(16, 8))
    y = nd.random.uniform(shape=(16, 4))
    first = _step(net, trainer, x, y)
    for _ in range(10):
        last = _step(net, trainer, x, y)
    assert last < first, f"{opt}: {first} -> {last}"


def test_trainer_lr_scheduler():
    net = _net()
    net.initialize()
    sched = lr_scheduler.FactorScheduler(step=2, factor=0.5, base_lr=0.1)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "lr_scheduler": sched})
    x = nd.random.uniform(shape=(4, 8))
    y = nd.random.uniform(shape=(4, 4))
    for _ in range(6):
        _step(net, trainer, x, y)
    assert trainer.learning_rate < 0.1


def test_trainer_save_load_states(tmp_path):
    net = _net()
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    x = nd.random.uniform(shape=(4, 8))
    y = nd.random.uniform(shape=(4, 4))
    _step(net, trainer, x, y)
    fname = str(tmp_path / "trainer.states")
    trainer.save_states(fname)
    trainer2 = gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
    trainer2.load_states(fname)
    s1, s2 = trainer._updater.states, trainer2._updater.states
    for k in s1:
        if s1[k] is None:
            continue
        a = s1[k] if not isinstance(s1[k], tuple) else s1[k][0]
        b = s2[k] if not isinstance(s2[k], tuple) else s2[k][0]
        assert np.allclose(a.asnumpy(), b.asnumpy())


def test_zero_grad():
    net = _net()
    net.initialize()
    x = nd.random.uniform(shape=(4, 8))
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    params = net.collect_params()
    params.zero_grad()
    for _, p in params.items():
        assert np.abs(p.grad().asnumpy()).sum() == 0


def test_gradient_accumulation():
    net = _net()
    net.initialize()
    for _, p in net.collect_params().items():
        p.grad_req = "add"
    x = nd.random.uniform(shape=(4, 8))
    with autograd.record():
        net(x).sum().backward()
    g1 = net[0].weight.grad().asnumpy().copy()
    with autograd.record():
        net(x).sum().backward()
    g2 = net[0].weight.grad().asnumpy()
    assert np.allclose(g2, 2 * g1, rtol=1e-4, atol=1e-5)


def test_clip_global_norm():
    arrays = [nd.ones((2, 2)) * 3, nd.ones((3,)) * 4]
    total = gluon.utils.clip_global_norm(arrays, 1.0)
    new_total = sum(float(a.norm().asscalar()) ** 2 for a in arrays) ** 0.5
    assert new_total < 1.01
    assert total > 1.0


def test_split_and_load():
    data = nd.arange(12).reshape((6, 2))
    parts = gluon.utils.split_and_load(data, [mx.cpu(0), mx.cpu(0)])
    assert len(parts) == 2
    assert parts[0].shape == (3, 2)
    got = np.concatenate([p.asnumpy() for p in parts])
    assert np.allclose(got, data.asnumpy())


def test_clip_global_norm_async():
    arrays = [nd.ones((2, 2)) * 3, nd.ones((3,)) * 4]
    total = gluon.utils.clip_global_norm(arrays, 1.0, check_isfinite=False)
    assert isinstance(total, nd.NDArray)
    assert float(total.asscalar()) > 1.0
    new_total = sum(float(a.norm().asscalar()) ** 2 for a in arrays) ** 0.5
    assert new_total < 1.01
    small = [nd.ones((2,)) * 0.1]
    gluon.utils.clip_global_norm(small, 10.0)
    assert np.allclose(small[0].asnumpy(), 0.1)


def test_clip_global_norm_nan_preserves_arrays():
    a = nd.array([1.0, np.nan])
    b = nd.array([2.0, 3.0])
    with pytest.warns(UserWarning):
        total = gluon.utils.clip_global_norm([a, b], 1.0)
    assert not (total < float("inf"))
    got = a.asnumpy()
    assert got[0] == 1.0 and np.isnan(got[1])
    assert np.allclose(b.asnumpy(), [2.0, 3.0])


def test_trainer_step_seconds_observed():
    """With runtime metrics on, every step lands in
    ``trainer.step.seconds``."""
    net = _net()
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = nd.random.uniform(shape=(4, 8))
    y = nd.random.uniform(shape=(4, 4))
    rm.enable()
    rm.reset()
    try:
        for _ in range(3):
            _step(net, trainer, x, y)
        assert rm.TRAINER_STEP_SECONDS.count() == 3
    finally:
        rm.disable()
        rm.reset()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _r(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.1, "clip_gradient": 0.05}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("adamw", {"learning_rate": 1e-2, "wd": 1e-2}),
    ("lamb", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 1e-2}),
    ("rmsprop", {"learning_rate": 1e-2, "centered": True}),
    ("adagrad", {"learning_rate": 0.1}),
    ("adadelta", {"rho": 0.9}),
    ("ftrl", {"learning_rate": 0.1}),
    ("signsgd", {"learning_rate": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {}),
]
_LOOSE = {"lamb", "lars"}


def _three_steps(pkg, ndm, path, opt, kw, x, y):
    net = _net(pkg)
    net.initialize()
    net.load_parameters(path)
    trainer = pkg.gluon.Trainer(net.collect_params(), opt, dict(kw))
    losses = [_step(net, trainer, ndm.array(x), ndm.array(y), pkg)
              for _ in range(3)]
    return losses, [p.data().asnumpy()
                    for p in net.collect_params().values()], trainer


@pytest.mark.parametrize("case", range(len(OPTIMIZERS)),
                         ids=[f"{o}{i}" for i, (o, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_matches_jax(case, tmp_path):
    opt, kw = OPTIMIZERS[case]
    x, y = _r((8, 8), 1), _r((8, 4), 2)
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier())
    path = str(tmp_path / "w.npz")
    jnet.save_parameters(path)
    ours = _three_steps(mx, nd, path, opt, kw, x, y)
    ref = _three_steps(jmx, jnd, path, opt, kw, x, y)
    rtol = 1e-4 if opt in _LOOSE else 1e-5
    np.testing.assert_allclose(ours[0], ref[0], rtol=rtol, atol=1e-6)
    for a, b in zip(ours[1], ref[1]):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)


def test_load_states_continues_jax_momentum(tmp_path):
    """After three steps, a fresh trainer on a copy of the net loads the
    saved momentum and takes a fourth step: ours lands where the JAX
    package's does."""
    x, y = _r((8, 8), 3), _r((8, 4), 4)
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier())
    path = str(tmp_path / "w.npz")
    jnet.save_parameters(path)
    finals = []
    for pkg, ndm in ((mx, nd), (jmx, jnd)):
        _, _, trainer = _three_steps(pkg, ndm, path, "sgd",
                                     {"learning_rate": 0.1,
                                      "momentum": 0.9}, x, y)
        net = trainer._params
        states = str(tmp_path / f"{pkg.__name__}.states")
        trainer.save_states(states)
        block = _net(pkg)
        block.initialize()
        for p, q in zip(block.collect_params().values(), net):
            p.set_data(q.data())
        fresh2 = pkg.gluon.Trainer(block.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        fresh2.load_states(states)
        _step(block, fresh2, ndm.array(x), ndm.array(y), pkg)
        finals.append([p.data().asnumpy()
                       for p in block.collect_params().values()])
    for a, b in zip(*finals):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("FactorScheduler", {"step": 3, "factor": 0.5, "base_lr": 0.1}),
    ("MultiFactorScheduler", {"step": [2, 5], "factor": 0.3,
                              "base_lr": 0.2}),
    ("PolyScheduler", {"max_update": 10, "base_lr": 0.1, "pwr": 2,
                       "warmup_steps": 2}),
    ("CosineScheduler", {"max_update": 10, "base_lr": 0.1,
                         "final_lr": 0.01}),
])
def test_lr_scheduler_matches_jax(name, kw):
    ours = getattr(lr_scheduler, name)(**kw)
    ref = getattr(jmx.lr_scheduler, name)(**kw)
    for t in range(12):
        assert ours(t) == pytest.approx(ref(t), rel=1e-12)
