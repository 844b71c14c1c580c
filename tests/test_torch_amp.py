"""PyTorch port, ``contrib.amp``: a twin of each test of
``tests/test_amp.py``, and AMP over the port's graph tiers.

Both packages run the same numpy inputs and the JAX package's initial
weights (``save_parameters`` / ``load_parameters``).  Tolerances: a
bf16 op's output within 2^-7 relative of the JAX package's (bf16 keeps
8 bits of mantissa; the two round the same products in another order);
float32 ops 1e-5; the trained MLP's final loss under AMP within 0.02 of
the JAX package's AMP run (the JAX test's own bar between AMP and
float32); loss scales and skipped steps equal.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.contrib import amp as jamp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.ndarray.ndarray import dtype_name

BF16_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


@pytest.fixture
def amp_on():
    amp.init(target_dtype="bfloat16")
    jamp.init(target_dtype="bfloat16")
    yield
    amp.amp._deinit()
    jamp.amp._deinit()


def _dt(a):
    return dtype_name(a._data.dtype) if isinstance(a, mx.nd.NDArray) \
        else str(a.dtype)


def _f32(a):
    return a.astype("float32").asnumpy()


def _close(got, want, rtol, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, rtol * scale)


def _toy(n=256, seed=3):
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 1).astype(np.float32)
    x = rng.randn(n, 16).astype(np.float32)
    y = x @ w + 0.1 * rng.randn(n, 1).astype(np.float32)
    return x, y


def _mlp(pkg, path=None):
    nn = pkg.gluon.nn
    net = nn.Sequential(prefix="ampmlp_")
    with net.name_scope():
        net.add(nn.Dense(32, in_units=16, activation="relu"))
        net.add(nn.Dense(1, in_units=32))
    if path is None:
        pkg.random.seed(0)
        net.initialize(pkg.init.Xavier())
    else:
        net.load_parameters(path, ctx=mx.cpu(0))
    return net


def _train_mlp(pkg, amp_mod, net, x, y, use_amp, epochs=60):
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05})
    if use_amp:
        amp_mod.init_trainer(trainer)
    loss_fn = pkg.gluon.loss.L2Loss()
    xs, ys = pkg.nd.array(x), pkg.nd.array(y)
    losses = []
    for _ in range(epochs):
        with pkg.autograd.record():
            loss = loss_fn(net(xs), ys)
        if use_amp:
            with amp_mod.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        else:
            loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses


class TestAmpInit:
    def test_bf16_ops_patched(self, amp_on):
        rng = np.random.RandomState(0)
        x = rng.rand(4, 8).astype(np.float32)
        w = rng.rand(3, 8).astype(np.float32)
        outs = []
        for pkg in (jmx, mx):
            out = pkg.nd.FullyConnected(pkg.nd.array(x), pkg.nd.array(w),
                                        pkg.nd.zeros((3,)), num_hidden=3)
            outs.append((out, pkg.nd.softmax(out)))
        (jout, jsm), (out, sm) = outs
        assert _dt(out) == _dt(jout) == "bfloat16"
        assert _dt(sm) == _dt(jsm) == "float32"
        _close(_f32(out), _f32(jout), BF16_RTOL, "FullyConnected")
        _close(sm.asnumpy(), jsm.asnumpy(), BF16_RTOL, "softmax")

    def test_symbolic_path_patched(self, amp_on):
        outs = []
        for pkg in (jmx, mx):
            s = pkg.sym
            out = s.FullyConnected(s.var("data"), s.var("w"), s.var("b"),
                                   num_hidden=4, name="fc")
            outs.append(out)
        assert "amp_cast" in outs[1].tojson()
        ops = [[n.op.name for n in o._topo() if n.op is not None]
               for o in outs]
        assert ops[1] == ops[0]
        x = np.random.RandomState(1).rand(2, 5).astype(np.float32)
        w = np.random.RandomState(2).rand(4, 5).astype(np.float32)
        res = [o.eval(data=p.nd.array(x), w=p.nd.array(w),
                      b=p.nd.zeros((4,)))[0]
               for o, p in zip(outs, (jmx, mx))]
        assert _dt(res[1]) == _dt(res[0]) == "bfloat16"
        _close(_f32(res[1]), _f32(res[0]), BF16_RTOL, "symbolic")

    def test_double_init_consistent(self, amp_on):
        amp.init(target_dtype="bfloat16")
        with pytest.raises(mx.MXNetError):
            amp.init(target_dtype="float16")
        with pytest.raises(mx.MXNetError):
            amp.amp._deinit() or amp.init(target_dtype="int8")
        amp.init(target_dtype="bfloat16")

    def test_widest_cast(self, amp_on):
        outs = []
        for pkg in (jmx, mx):
            a = pkg.nd.array(np.ones((2, 2), np.float32)).astype("bfloat16")
            b = pkg.nd.array(np.full((2, 2), 0.5, np.float32))
            outs.append(pkg.nd.broadcast_add(a, b))
        assert _dt(outs[1]) == _dt(outs[0]) == "float32"
        np.testing.assert_array_equal(outs[1].asnumpy(), outs[0].asnumpy())


class TestAmpTraining:
    def test_bf16_matches_fp32_loss(self, amp_on, tmp_path):
        x, y = _toy()
        jnet = _mlp(jmx)
        path = str(tmp_path / "mlp.params")
        jnet.save_parameters(path)
        jl = _train_mlp(jmx, jamp, jnet, x, y, True)
        pl = _train_mlp(mx, amp, _mlp(mx, path), x, y, True)
        assert abs(pl[-1] - jl[-1]) < 0.02, (pl[-1], jl[-1])
        assert abs(pl[0] - jl[0]) <= 1e-2 * abs(jl[0])
        amp.amp._deinit()
        fl = _train_mlp(mx, amp, _mlp(mx, path), x, y, False)
        assert abs(pl[-1] - fl[-1]) < 0.02, (pl[-1], fl[-1])
        assert pl[-1] < 0.15

    def test_multi_precision_master_weights(self, tmp_path):
        x = np.random.RandomState(4).rand(16, 8).astype(np.float32)
        states, weights = [], []
        path = str(tmp_path / "mp.params")
        for pkg in (jmx, mx):
            net = pkg.gluon.nn.Dense(4, in_units=8, prefix="mp_")
            if pkg is jmx:
                pkg.random.seed(0)
                net.initialize(pkg.init.Xavier())
                net.save_parameters(path)
            else:
                net.load_parameters(path, ctx=mx.cpu(0))
            net.cast("bfloat16")
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1,
                                         "multi_precision": True})
            with pkg.autograd.record():
                loss = net(pkg.nd.array(x).astype("bfloat16")).sum()
            loss.backward()
            trainer.step(16)
            state = trainer._dev_updaters[0].states[0]
            assert isinstance(state, tuple)
            states.append(state[0])
            weights.append(net.weight.data())
        assert _dt(weights[1]) == _dt(weights[0]) == "bfloat16"
        assert _dt(states[1]) == _dt(states[0]) == "float32"
        _close(states[1].asnumpy(), states[0].asnumpy(), BF16_RTOL,
               "fp32 master")
        _close(_f32(weights[1]), _f32(weights[0]), BF16_RTOL, "weights")


class TestLossScaler:
    def _dense(self, pkg, path):
        net = pkg.gluon.nn.Dense(2, in_units=4, prefix="ls_")
        if pkg is jmx:
            pkg.random.seed(0)
            net.initialize()
            net.save_parameters(path)
        else:
            net.load_parameters(path, ctx=mx.cpu(0))
        return net

    def test_overflow_skips_step_and_halves_scale(self, tmp_path):
        x = np.random.RandomState(5).rand(4, 4).astype(np.float32)
        path = str(tmp_path / "ls.params")
        res = []
        for pkg, amp_mod in ((jmx, jamp), (mx, amp)):
            net = self._dense(pkg, path)
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1})
            amp_mod.init_trainer(trainer)
            scaler = trainer._amp_loss_scaler
            s0 = scaler.loss_scale
            w0 = net.weight.data().asnumpy().copy()
            with pkg.autograd.record():
                loss = net(pkg.nd.array(x)).sum()
            loss.backward()
            g = net.weight.grad()
            poisoned = g.asnumpy().copy()
            poisoned[0, 0] = np.inf
            g[:] = pkg.nd.array(poisoned)
            trainer.step(4)
            np.testing.assert_array_equal(net.weight.data().asnumpy(), w0)
            assert scaler.loss_scale == s0 / 2
            res.append((s0, scaler.stats))
        assert res[1] == res[0]

    def test_scale_grows_after_window(self):
        seq = []
        for amp_mod in (jamp, amp):
            scaler = amp_mod.LossScaler(init_scale=4.0, scale_window=3)
            scales = []
            for overflow in (False, False, False, True, False, False, False):
                scaler.update_scale(overflow)
                scales.append(scaler.loss_scale)
            seq.append((scales, scaler.stats))
        assert seq[1] == seq[0]
        assert seq[1][0][2] == 8.0

    def test_scale_loss_divides_grads(self):
        grads = []
        for pkg, amp_mod in ((jmx, jamp), (mx, amp)):
            net = pkg.gluon.nn.Dense(1, in_units=2, use_bias=False)
            net.initialize(pkg.init.One())
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.0})
            amp_mod.init_trainer(trainer)
            scale = trainer._amp_loss_scaler.loss_scale
            with pkg.autograd.record():
                loss = net(pkg.nd.array(np.ones((1, 2), np.float32))).sum()
            with amp_mod.scale_loss(loss, trainer) as scaled:
                scaled.backward()
            raw = net.weight.grad().asnumpy().copy()
            np.testing.assert_allclose(raw, scale * np.ones((1, 2)))
            amp_mod.unscale(trainer)
            grads.append((raw, net.weight.grad().asnumpy()))
        np.testing.assert_array_equal(grads[1][0], grads[0][0])
        np.testing.assert_array_equal(grads[1][1], np.ones((1, 2)))


def _hybrid_amp_run(net, x, y, scales, hybrid):
    """Adam steps of ``net`` under ``init_trainer`` at the given loss
    scales (set before each step), hybridized or not; losses and the
    final weights."""
    if hybrid:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    amp.init_trainer(trainer)
    loss_fn = gluon.loss.L2Loss()
    losses = []
    for s in scales:
        trainer._amp_loss_scaler.loss_scale = s
        with autograd.record():
            loss = loss_fn(net(nd.array(x)), nd.array(y))
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


def test_changed_loss_scale_reaches_the_update_graph(tmp_path):
    """Under ``init_trainer`` a hybridized net updates through the
    Trainer's fused update (``rescale`` a device scalar refreshed when
    the loss scale changes): with the scale changed every step it gives
    the eager net's losses and weights (1e-6 relative / of max|w|); a
    scale of 2^140 overflows float32 gradients and skips the step, the
    weights unchanged bit for bit and the scale halved."""
    amp.init(target_dtype="bfloat16")
    try:
        x, y = _toy(n=32, seed=6)
        jnet = _mlp(jmx)
        path = str(tmp_path / "h.params")
        jnet.save_parameters(path)
        scales = [2.0 ** 10, 2.0 ** 3, 2.0 ** 16, 1.0]
        eager = _hybrid_amp_run(_mlp(mx, path), x, y, scales, False)
        hyb = _hybrid_amp_run(_mlp(mx, path), x, y, scales, True)
        np.testing.assert_allclose(hyb[0], eager[0], rtol=1e-6)
        for k in eager[1]:
            _close(hyb[1][k], eager[1][k], 1e-6, k)
        # an overflowing scale skips the step on the hybridized path too
        net = _mlp(mx, path)
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
        amp.init_trainer(trainer)
        loss_fn = gluon.loss.L2Loss()
        for step, s in enumerate((2.0 ** 4, 2.0 ** 4, 2.0 ** 140)):
            trainer._amp_loss_scaler.loss_scale = s
            before = {k: p.data().asnumpy().copy()
                      for k, p in net.collect_params().items()}
            with autograd.record():
                loss = loss_fn(net(nd.array(x)), nd.array(y))
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
            trainer.step(x.shape[0])
        for k, p in net.collect_params().items():
            np.testing.assert_array_equal(p.data().asnumpy(), before[k])
        assert trainer._amp_loss_scaler.loss_scale == 2.0 ** 139
        assert trainer._amp_loss_scaler.stats["skipped"] == 1
    finally:
        amp.amp._deinit()


def test_amp_patches_are_undone():
    before = {n: getattr(nd, n) for n in ("FullyConnected", "softmax",
                                          "broadcast_add")}
    amp.init(target_dtype="float16")
    try:
        assert all(getattr(nd, n) is not f for n, f in before.items())
        assert amp.list_lp16_ops() == jamp.list_lp16_ops()
        assert amp.list_fp32_ops() == jamp.list_fp32_ops()
        out = nd.FullyConnected(nd.ones((2, 3)), nd.ones((4, 3)),
                                nd.zeros((4,)), num_hidden=4)
        assert _dt(out) == "float16"
    finally:
        amp.amp._deinit()
    assert all(getattr(nd, n) is f for n, f in before.items())
    block = gluon.nn.Dense(2, in_units=3)
    block.initialize()
    assert amp.convert_hybrid_block(block) is block
    assert _dt(block.weight.data()) == "bfloat16"
