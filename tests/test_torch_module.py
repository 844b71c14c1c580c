"""PyTorch port, the Module API: twins of ``tests/test_module.py``'s
``TestModule``, ``TestModuleRebind`` and ``TestBucketingModule`` (each
run through the JAX package and the port, the port on the CPU, on the
same seeded numpy data), ``examples/lenet_symbol.py``'s loop at 256
samples from the JAX package's initial arrays (``set_params`` /
``fit(arg_params=)``: the first 5 batches' outputs and the parameters
after them), checkpoints both ways with their ``.states``, the callbacks
(``do_checkpoint`` files the JAX package loads, ``Speedometer``
publishing samples/s) and the legacy ``.params`` container.

Both packages' ``NDArrayIter`` shuffle with ``seed=0`` where the twins
compare batch for batch (epoch ``e`` in the order of
``RandomState([0, e])``).  Tolerances: fp32 outputs 1e-5 relative to
their max; parameters after SGD steps 1e-5 relative to their max|w|;
accuracies to the JAX test's bars.
"""
import logging
import os
import types

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

FWD_RTOL, PARAM_RTOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, (what, err)


def _mlp_symbol(pkg, num_hidden=16, num_classes=4):
    S = pkg.sym
    h = S.FullyConnected(S.var("data"), S.var("fc1_weight"),
                         S.var("fc1_bias"), num_hidden=num_hidden,
                         name="fc1")
    h = S.Activation(h, act_type="relu", name="relu1")
    out = S.FullyConnected(h, S.var("fc2_weight"), S.var("fc2_bias"),
                           num_hidden=num_classes, name="fc2")
    return S.SoftmaxOutput(out, S.var("softmax_label"), name="softmax")


def _toy_data(n=64, num_classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(num_classes, 8).astype(np.float32) * 3
    y = rng.randint(0, num_classes, size=n)
    x = centers[y] + rng.randn(n, 8).astype(np.float32) * 0.1
    return x, y.astype(np.float32)


def _init_arrays(symbol_fn, data_shape, label_shape, seed=0):
    """The JAX package's Module default initializer's arrays (numpy)."""
    jmx.random.seed(seed)
    mod = jmx.module.Module(symbol_fn(jmx), context=jmx.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(initializer=jmx.init.Xavier())
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _as(pkg, arrays):
    return {k: pkg.nd.array(v) for k, v in arrays.items()}


# ------------------------------------------------------- TestModule twins
@pytest.mark.parametrize("epochs,explicit_init", [(12, True), (6, False)])
def test_module_fit_converges(epochs, explicit_init):
    x, y = _toy_data()
    scores = []
    for pkg in (mx, jmx):
        pkg.random.seed(0)
        it = pkg.io.NDArrayIter(x, y, batch_size=16, shuffle=True,
                                label_name="softmax_label")
        mod = pkg.module.Module(_mlp_symbol(pkg), context=pkg.cpu())
        kw = dict(initializer=pkg.init.Xavier()) if explicit_init else {}
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5}, eval_metric="acc",
                **kw)
        scores.append(dict(mod.score(it, "acc"))["accuracy"])
        assert np.abs(mod.get_params()[0]["fc1_weight"].asnumpy()).max() > 0
    assert scores[0] > (0.9 if explicit_init else 0.8), scores


def test_module_fit_matches_jax_from_the_same_weights():
    x, y = _toy_data()
    init = _init_arrays(_mlp_symbol, (16, 8), (16,))
    res = []
    for pkg in (mx, jmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=16, shuffle=True, seed=0,
                                label_name="softmax_label")
        mod = pkg.module.Module(_mlp_symbol(pkg), context=pkg.cpu())
        outs = []
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5}, eval_metric="acc",
                arg_params=_as(pkg, init),
                batch_end_callback=lambda p: outs.append(
                    p.locals["self"].get_outputs()[0].asnumpy()))
        res.append((outs, {k: v.asnumpy()
                           for k, v in mod.get_params()[0].items()}))
    for i, (a, b) in enumerate(zip(res[0][0], res[1][0])):
        _close(a, b, FWD_RTOL, what=f"batch {i}")
    for k in init:
        _close(res[0][1][k], res[1][1][k], PARAM_RTOL, what=k)


def test_module_predict_shapes():
    x, y = _toy_data(n=50)
    outs = []
    for pkg in (mx, jmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=16,
                                label_name="softmax_label")
        mod = pkg.module.Module(_mlp_symbol(pkg), context=pkg.cpu())
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.init_params()
        mod.set_params(_as(pkg, _init_arrays(_mlp_symbol, (16, 8),
                                             (16,))), {})
        out = mod.predict(it)
        assert out.shape == (50, 4)          # pad rows stripped
        outs.append(out.asnumpy())
    _close(outs[0], outs[1], FWD_RTOL)


def test_module_checkpoint_roundtrip(tmp_path):
    x, y = _toy_data()
    it = mx.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
    mod = mx.module.Module(_mlp_symbol(mx), context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    prefix = str(tmp_path / "toy")
    mod.save_checkpoint(prefix, 0)
    symbol, arg_params, aux_params = mx.module.load_checkpoint(prefix, 0)
    mod2 = mx.module.Module(symbol, context=mx.cpu())
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod2.set_params(arg_params, aux_params)
    it.reset()
    batch = next(it)
    mod.forward(batch, is_train=False)
    mod2.forward(batch, is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                               mod2.get_outputs()[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_fixed_params_not_updated():
    x, y = _toy_data()
    for pkg in (mx, jmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=16,
                                label_name="softmax_label")
        mod = pkg.module.Module(_mlp_symbol(pkg), context=pkg.cpu(),
                                fixed_param_names=["fc1_weight"])
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(initializer=pkg.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        before = mod.get_params()[0]["fc1_weight"].asnumpy().copy()
        other = mod.get_params()[0]["fc2_weight"].asnumpy().copy()
        mod.forward_backward(next(it))
        mod.update()
        after = mod.get_params()[0]
        np.testing.assert_array_equal(before,
                                      after["fc1_weight"].asnumpy())
        assert not np.array_equal(other, after["fc2_weight"].asnumpy())


def test_inputs_need_grad_and_input_grads_match_jax():
    x, y = _toy_data(n=16)
    init = _init_arrays(_mlp_symbol, (16, 8), (16,))
    grads = []
    for pkg in (mx, jmx):
        mod = pkg.module.Module(_mlp_symbol(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[("data", (16, 8))],
                 label_shapes=[("softmax_label", (16,))],
                 inputs_need_grad=True)
        mod.set_params(_as(pkg, init), {})
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x)],
                                 label=[pkg.nd.array(y)])
        mod.forward_backward(batch)
        grads.append(mod.get_input_grads()[0].asnumpy())
    _close(grads[0], grads[1], 1e-4)
    with pytest.raises(mx.MXNetError):
        mx.module.Module(_mlp_symbol(mx), context=mx.cpu()) \
            .get_input_grads()


def test_fit_refuses_a_monitor():
    """``fit(monitor=)`` takes a ``Monitor`` (installed, ticked and
    printed every batch, as in the JAX package) and refuses an object
    that is not one, as the JAX package's fit does."""
    x, y = _toy_data(n=16)
    for pkg in (mx, jmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=8,
                                label_name="softmax_label")
        mod = pkg.module.Module(_mlp_symbol(pkg), context=pkg.cpu())
        with pytest.raises(AttributeError, match="install"):
            mod.fit(it, num_epoch=1, monitor=object())
    it = mx.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
    mod = mx.module.Module(_mlp_symbol(mx), context=mx.cpu())
    mon = mx.monitor.Monitor(interval=1, pattern=".*weight$")
    mod.fit(it, num_epoch=1, monitor=mon)
    assert mon.step == 2 and any(m is mod for m in mon._modules)


# ------------------------------------------------- TestModuleRebind twins
def _rebind_mod(pkg):
    S = pkg.sym
    out = S.FullyConnected(S.var("data"), S.var("w"), S.var("b"),
                           num_hidden=3)
    mod = pkg.module.Module(out, label_names=None, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (2, 5))], for_training=False)
    mod.init_params(initializer=pkg.init.Xavier())
    return mod


@pytest.mark.parametrize("pkg", [mx, jmx], ids=["port", "jax"])
def test_force_rebind_preserves_params(pkg):
    mod = _rebind_mod(pkg)
    w = mod._exec.arg_dict["w"].asnumpy().copy()
    mod.bind(data_shapes=[("data", (4, 5))], for_training=False,
             force_rebind=True)
    mod.init_params()
    np.testing.assert_array_equal(mod._exec.arg_dict["w"].asnumpy(), w)
    assert mod._exec.arg_dict["data"].shape == (4, 5)


@pytest.mark.parametrize("pkg", [mx, jmx], ids=["port", "jax"])
def test_partial_set_params_keeps_others(pkg):
    mod = _rebind_mod(pkg)
    w = mod._exec.arg_dict["w"].asnumpy().copy()
    mod.set_params({"b": pkg.nd.ones((3,))}, {}, allow_missing=True)
    np.testing.assert_array_equal(mod._exec.arg_dict["w"].asnumpy(), w)
    np.testing.assert_array_equal(mod._exec.arg_dict["b"].asnumpy(),
                                  np.ones((3,)))


@pytest.mark.parametrize("pkg", [mx, jmx], ids=["port", "jax"])
def test_forward_shape_mismatch_raises(pkg):
    mod = _rebind_mod(pkg)
    with pytest.raises(pkg.MXNetError):
        mod._exec.forward(data=pkg.nd.zeros((7, 5)))


def test_set_params_takes_numpy_weights_of_the_jax_package():
    ours, theirs = _rebind_mod(mx), _rebind_mod(jmx)
    args, aux = theirs.get_params()
    ours.set_params({k: v.asnumpy() for k, v in args.items()}, aux)
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    outs = []
    for pkg, mod in ((mx, ours), (jmx, theirs)):
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x)], label=None),
                    is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    _close(outs[0], outs[1], FWD_RTOL)


# ----------------------------------------------- TestBucketingModule twins
def _sym_gen_for(pkg):
    def sym_gen(seq_len):
        S = pkg.sym
        h = S.mean(S.var("data"), axis=1, name="pool")
        out = S.FullyConnected(h, S.var("cls_weight"), S.var("cls_bias"),
                               num_hidden=3, name="cls")
        return S.SoftmaxOutput(out, S.var("softmax_label"),
                               name="softmax"), ("data",), ("softmax_label",)
    return sym_gen


def _bucket_batch(pkg, seq_len, n=8, seed=0):
    rng = np.random.RandomState(seed + seq_len)
    y = rng.randint(0, 3, size=n).astype(np.float32)
    x = rng.randn(n, seq_len, 4).astype(np.float32) + y[:, None, None]
    b = pkg.io.DataBatch(data=[pkg.nd.array(x)], label=[pkg.nd.array(y)],
                         provide_data=[("data", (n, seq_len, 4))],
                         provide_label=[("softmax_label", (n,))])
    b.bucket_key = seq_len
    return b


def _bucketing(pkg, keys, default, init=None):
    bm = pkg.module.BucketingModule(_sym_gen_for(pkg),
                                    default_bucket_key=default,
                                    context=pkg.cpu(), bucket_keys=keys)
    b = _bucket_batch(pkg, default)
    bm.bind(data_shapes=b.provide_data, label_shapes=b.provide_label)
    bm.init_params(initializer=pkg.init.Xavier())
    if init is not None:
        bm.set_params(_as(pkg, init), {})
    return bm


def test_bucketing_bounded_compiles_and_matches_jax():
    keys = [4, 8, 16]
    init = {"cls_weight": np.random.RandomState(1).randn(3, 4).astype(
        np.float32) * 0.3, "cls_bias": np.zeros(3, np.float32)}
    res = []
    for pkg in (mx, jmx):
        bm = _bucketing(pkg, keys, 16, init)
        bm.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1})
        outs = []
        for step in range(12):
            b = _bucket_batch(pkg, keys[step % 3], seed=step)
            bm.forward(b, is_train=True)
            bm.backward()
            bm.update()
            outs.append(bm.get_outputs()[0].asnumpy())
        assert set(bm.active_buckets) == set(keys)
        assert bm.num_compiles <= 2 * len(keys)
        w_def = bm._buckets[16]._exec.arg_dict["cls_weight"]
        for k in (4, 8):
            assert bm._buckets[k]._exec.arg_dict["cls_weight"] is w_def
        res.append((outs, bm.get_params()[0]["cls_weight"].asnumpy(),
                    bm.num_compiles))
    for i, (a, b) in enumerate(zip(res[0][0], res[1][0])):
        _close(a, b, FWD_RTOL, what=f"step {i}")
    _close(res[0][1], res[1][1], PARAM_RTOL)
    assert res[0][2] == res[1][2] == 6


@pytest.mark.parametrize("pkg", [mx, jmx], ids=["port", "jax"])
def test_bucketing_force_rebind_preserves_params(pkg):
    bm = _bucketing(pkg, [4, 8], 8)
    w = bm.get_params()[0]["cls_weight"].asnumpy().copy()
    assert np.abs(w).max() > 0
    b8 = _bucket_batch(pkg, 8)
    bm.bind(data_shapes=b8.provide_data, label_shapes=b8.provide_label,
            force_rebind=True)
    np.testing.assert_array_equal(
        bm.get_params()[0]["cls_weight"].asnumpy(), w)


@pytest.mark.parametrize("pkg", [mx, jmx], ids=["port", "jax"])
def test_bucketing_rejects_unregistered_key(pkg):
    bm = _bucketing(pkg, [8], 8)
    with pytest.raises(pkg.MXNetError):
        bm.switch_bucket(32, _bucket_batch(pkg, 32).provide_data)


def test_bucketing_training_converges():
    keys = [4, 8]
    bm = _bucketing(mx, keys, 8)
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.3})
    metric = mx.metric.create("acc")
    for step in range(60):
        b = _bucket_batch(mx, keys[step % 2], seed=step % 5)
        bm.forward(b, is_train=True)
        bm.backward()
        bm.update()
    metric.reset()
    for s in range(5):
        b = _bucket_batch(mx, keys[s % 2], seed=s)
        bm.forward(b, is_train=False)
        bm.update_metric(metric, b.label)
    assert metric.get()[1] > 0.8


# ------------------------------------------------- examples/lenet_symbol.py
def _lenet_symbol(pkg):
    S = pkg.sym
    h = S.FullyConnected(S.var("data"), S.var("fc1_weight"),
                         S.var("fc1_bias"), num_hidden=128, name="fc1")
    h = S.Activation(h, act_type="relu", name="relu1")
    h = S.FullyConnected(h, S.var("fc2_weight"), S.var("fc2_bias"),
                         num_hidden=10, name="fc2")
    return S.SoftmaxOutput(h, S.var("softmax_label"), name="softmax")


def test_lenet_symbol_loop_matches_jax():
    """The example's data recipe and loop at 256 samples (2 batches an
    epoch): the first 5 batches' outputs and the parameters after them,
    from the JAX package's initial arrays."""
    rng = np.random.RandomState(0)
    n = 256
    centers = rng.randn(10, 64).astype(np.float32) * 3
    labels = rng.randint(0, 10, n)
    data = centers[labels] + rng.randn(n, 64).astype(np.float32)
    init = _init_arrays(_lenet_symbol, (128, 64), (128,))
    res = []
    for pkg in (mx, jmx):
        it = pkg.io.NDArrayIter(
            data={"data": pkg.nd.array(data)},
            label={"softmax_label": pkg.nd.array(labels.astype(np.float32))},
            batch_size=128, shuffle=True, seed=0)
        mod = pkg.module.Module(_lenet_symbol(pkg), data_names=("data",),
                                label_names=("softmax_label",),
                                context=pkg.cpu())
        outs, params = [], []

        def on_batch(param, outs=outs, params=params):
            m = param.locals["self"]
            outs.append(m.get_outputs()[0].asnumpy())
            if len(outs) == 5:
                params.append({k: v.asnumpy()
                               for k, v in m.get_params()[0].items()})

        mod.fit(it, num_epoch=3, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1}, eval_metric="acc",
                arg_params=_as(pkg, init), batch_end_callback=on_batch)
        res.append((outs[:5], params[0],
                    dict(mod.score(it, pkg.metric.Accuracy()))["accuracy"]))
    for i, (a, b) in enumerate(zip(res[0][0], res[1][0])):
        _close(a, b, FWD_RTOL, what=f"batch {i}")
    for k in init:
        _close(res[0][1][k], res[1][1][k], PARAM_RTOL, what=k)
    assert abs(res[0][2] - res[1][2]) <= 1.0 / n


# ----------------------------------------------------------- checkpoints
def _trained(pkg, init, steps=3):
    x, y = _toy_data(n=32)
    it = pkg.io.NDArrayIter(x, y, batch_size=16, shuffle=True, seed=0,
                            label_name="softmax_label")
    mod = pkg.module.Module(_mlp_symbol(pkg), context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.set_params(_as(pkg, init), {})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.2, "momentum": 0.9})
    for i in range(steps):
        it.reset() if i % 2 == 0 else None
        mod.forward_backward(next(it))
        mod.update()
    return mod, it


def _one_more_step(pkg, mod):
    x, y = _toy_data(n=16, seed=5)
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x)], label=[pkg.nd.array(y)])
    mod.forward_backward(batch)
    mod.update()
    mod.forward(batch, is_train=False)
    return mod.get_outputs()[0].asnumpy(), {
        k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("writer,reader", [(jmx, mx), (mx, jmx)],
                         ids=["jax_saves_port_loads", "port_saves_jax_loads"])
def test_checkpoint_with_states_crosses_packages(tmp_path, writer, reader):
    init = _init_arrays(_mlp_symbol, (16, 8), (16,))
    mod, _it = _trained(writer, init)
    prefix = str(tmp_path / "ck")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    for suffix in ("-symbol.json", "-0002.params", "-0002.states"):
        assert os.path.exists(prefix + suffix)
    loaded = reader.module.Module.load(prefix, 2, load_optimizer_states=True,
                                       context=reader.cpu())
    loaded.bind(data_shapes=[("data", (16, 8))],
                label_shapes=[("softmax_label", (16,))])
    loaded.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.2, "momentum": 0.9})
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(
            loaded.get_params()[0][k].asnumpy(), v.asnumpy())
    # the momentum came across: the next step agrees with the writer's
    want = _one_more_step(writer, mod)
    got = _one_more_step(reader, loaded)
    _close(got[0], want[0], FWD_RTOL)
    for k in want[1]:
        _close(got[1][k], want[1][k], PARAM_RTOL, what=k)


# ------------------------------------------------------------- callbacks
def test_do_checkpoint_files_load_in_the_jax_package(tmp_path):
    x, y = _toy_data()
    it = mx.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
    mod = mx.module.Module(_mlp_symbol(mx), context=mx.cpu())
    prefix = str(tmp_path / "cb")
    saved = []
    mod.fit(it, num_epoch=4, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5},
            initializer=mx.init.Xavier(),
            epoch_end_callback=[
                mx.callback.do_checkpoint(prefix, period=2),
                mx.callback.module_checkpoint(mod, prefix + "-m", period=4,
                                              save_optimizer_states=True),
                lambda epoch, *a: saved.append(epoch)])
    assert saved == [0, 1, 2, 3]
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("cb-0")) \
        == ["cb-0001.params", "cb-0003.params"]
    assert os.path.exists(prefix + "-m-0003.states")
    symbol, args, aux = jmx.module.load_checkpoint(prefix, 3)
    jmod = jmx.module.Module(symbol, context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (16, 8))],
              label_shapes=[("softmax_label", (16,))])
    jmod.set_params(args, aux)
    xb = x[:16]
    jmod.forward(jmx.io.DataBatch(data=[jmx.nd.array(xb)], label=None),
                 is_train=False)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(xb)], label=None),
                is_train=False)
    _close(mod.get_outputs()[0].asnumpy(), jmod.get_outputs()[0].asnumpy(),
           FWD_RTOL)


@pytest.fixture
def metrics():
    from mxnet_tpu_torch import perf_account as pa
    from mxnet_tpu_torch import runtime_metrics as rm
    rm.enable()
    rm.reset()
    pa.reset()
    try:
        yield rm
    finally:
        rm.disable()
        rm.reset()
        pa.reset()


def test_speedometer_publishes_samples_per_sec(metrics, caplog):
    rm = metrics
    x, y = _toy_data()
    it = mx.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
    mod = mx.module.Module(_mlp_symbol(mx), context=mx.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                batch_end_callback=mx.callback.Speedometer(16, frequent=2))
    assert rm.TRAINER_SAMPLES_PER_SEC.value() > 0
    assert "trainer_samples_per_sec" in rm.dump_prometheus()
    # fit observes each step's seconds, as the JAX package's does
    assert rm.TRAINER_STEP_SECONDS.count() == 8
    assert any("samples/sec" in r.getMessage() and "accuracy=" in
               r.getMessage() for r in caplog.records)


def test_speedometer_progress_and_validation_callbacks_log(caplog):
    sm = mx.callback.Speedometer(batch_size=4, frequent=1, auto_reset=False)
    bar = mx.callback.ProgressBar(total=4, length=8)
    val = mx.callback.LogValidationMetricsCallback()
    metric = mx.metric.create("acc")
    metric.update([nd.array([1, 0])], [nd.array([[0.1, 0.9], [0.8, 0.2]])])
    with caplog.at_level(logging.INFO):
        for nbatch in range(3):
            p = types.SimpleNamespace(nbatch=nbatch, epoch=1,
                                      eval_metric=metric)
            sm(p)
            bar(p)
        val(types.SimpleNamespace(epoch=1, eval_metric=metric))
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "Speed:" in text and "accuracy=1.000000" in text
    assert "[====----] 50.0%" in text
    assert "Epoch[1] Validation-accuracy=1.000000" in text


# ------------------------------------------------ the legacy .params file
def test_dmlc_params_written_by_the_jax_package_load_in_the_port(tmp_path):
    from mxnet_tpu import compat as jcompat
    rs = np.random.RandomState(0)
    arrays = {"arg:w": rs.randn(3, 4).astype(np.float32),
              "arg:b": np.arange(3, dtype=np.int32),
              "aux:mv": (rs.rand(5) * 200).astype(np.uint8)}
    path = str(tmp_path / "legacy-0000.params")
    written = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    jcompat.save_params_dmlc(path, written)
    assert mx.compat.is_dmlc_params(path)
    loaded = nd.load(path)
    assert sorted(loaded) == sorted(arrays)
    for k, v in written.items():
        want = v.asnumpy()
        got = loaded[k].asnumpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)


def test_dmlc_params_round_trip_and_jax_reads_the_ports(tmp_path):
    import torch
    path = str(tmp_path / "p.params")
    w = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    bf = nd.NDArray(torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16))
    mx.compat.save_params_dmlc(path, {"w": nd.array(w), "h": bf})
    ours = mx.compat.load_params_dmlc(path)
    theirs = jmx.compat.load_params_dmlc(path)
    np.testing.assert_array_equal(ours["w"].asnumpy(), w)
    np.testing.assert_array_equal(theirs["w"].asnumpy(), w)
    assert ours["h"]._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ours["h"]._data.float().numpy(), [1.5, -2.25, 3.0])
    np.testing.assert_array_equal(
        np.asarray(theirs["h"].asnumpy(), np.float32), [1.5, -2.25, 3.0])
    with open(str(tmp_path / "bad.params"), "wb") as f:
        f.write(b"\x00" * 16)
    assert not mx.compat.is_dmlc_params(str(tmp_path / "bad.params"))
