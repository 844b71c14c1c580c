"""PyTorch port, kvstore (``mxnet_tpu_torch/kvstore``): the twins of all
20 cases of ``tests/test_kvstore.py``, of the ten cases of
``tests/test_quantize.py::TestKVStoreQuantized`` and of
``tests/test_dist.py::TestLauncher::test_dist_sync_kvstore``, and the
port against the JAX package on the same numpy inputs.

Tolerances are the reference tests' own: sums rtol 1e-6 (four copies
1e-5), trainer runs rtol 1e-5 / atol 1e-6.  Against the JAX package:
uncompressed sums to 1e-6, the int8 / fp8 buckets to rtol 1e-6 / atol
1e-7 (the same float32 quantize, round half to even and dequantize; XLA
may divide by the scale through its reciprocal, one ulp), and a two-context
``Trainer`` run (``device`` and ``xla``) from carried-across weights to
rtol 1e-5 / atol 1e-6.

The dist case runs two gloo CPU ranks started by
``mxnet_tpu_torch/tools/launch.py`` (every process joined under the
launcher's timeout): the reference's ``dist_sync`` sequence, then the
port's dist rule: ``gluon.Trainer(..., kvstore="dist_sync")`` at one
context per rank, ranks started from different weights, three SGD steps
on rank-split data.  Both ranks end bit for bit equal, and equal to a
one-process full-batch run from rank 0's weights at rtol 1e-5 / atol
1e-6.  (The JAX Trainer creates no store at one context, so its ranks
would not average: ``ROADMAP.md``, "Not the port's to fix".)
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkvstore
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, kvstore, nd
from mxnet_tpu_torch import runtime_metrics as rm
from mxnet_tpu_torch.base import MXNetError

from test_torch_dist import run_job

CTXS = [mx.cpu(0), mx.cpu(1)]
JCTXS = [jmx.cpu(0), jmx.cpu(1)]


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).uniform(-1, 1, shape)
            * scale).astype("float32")


# ---------------------------------------------------------------------------
# tests/test_kvstore.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_type", ["local", "device", "xla"])
def test_push_pull_sum(kv_type):
    kv = kvstore.create(kv_type)
    shape = (4, 5)
    a, b = _rand(shape, 1), _rand(shape, 2)
    kv.init("w", nd.array(np.zeros(shape, "float32")))
    vals = [nd.array(a, ctx=CTXS[0]), nd.array(b, ctx=CTXS[1])]
    outs = [nd.zeros(shape, ctx=c) for c in CTXS]
    kv.pushpull("w", vals, out=outs)
    for o, c in zip(outs, CTXS):
        np.testing.assert_allclose(o.asnumpy(), a + b, rtol=1e-6)
        assert o.context == c
    # the copies are separate tensors, also on two CPU contexts
    assert outs[0]._data.data_ptr() != outs[1]._data.data_ptr()


@pytest.mark.parametrize("kv_type", ["local", "device", "xla"])
def test_multi_key_list_api(kv_type):
    kv = kvstore.create(kv_type)
    shapes = [(3,), (2, 4), (5, 1)]
    keys = [str(i) for i in range(len(shapes))]
    kv.init(keys, [nd.zeros(s) for s in shapes])
    per_key = [[nd.array(_rand(s, 10 + i), ctx=CTXS[0]),
                nd.array(_rand(s, 20 + i), ctx=CTXS[1])]
               for i, s in enumerate(shapes)]
    outs = [[nd.zeros(s, ctx=c) for c in CTXS] for s in shapes]
    kv.pushpull(keys, per_key, out=outs)
    for i, s in enumerate(shapes):
        want = _rand(s, 10 + i) + _rand(s, 20 + i)
        for o in outs[i]:
            np.testing.assert_allclose(o.asnumpy(), want, rtol=1e-6)


def test_xla_bucket_fusion_many_small_keys():
    kv = kvstore.create("xla")
    kv.bigarray_bound = 64
    n_keys = 20
    shapes = [(7,)] * (n_keys - 1) + [(130,)]
    keys = [str(i) for i in range(n_keys)]
    kv.init(keys, [nd.zeros(s) for s in shapes])
    per_key, want = [], []
    for i, s in enumerate(shapes):
        a, b = _rand(s, i), _rand(s, 100 + i)
        per_key.append([nd.array(a, ctx=CTXS[0]), nd.array(b, ctx=CTXS[1])])
        want.append(a + b)
    outs = [[nd.zeros(s, ctx=c) for c in CTXS] for s in shapes]
    kv.pushpull(keys, per_key, out=outs)
    for i in range(n_keys):
        for o in outs[i]:
            np.testing.assert_allclose(o.asnumpy(), want[i], rtol=1e-6)


def test_xla_four_devices():
    ctxs = [mx.cpu(i) for i in range(4)]
    kv = kvstore.create("xla")
    shape = (6, 3)
    kv.init("0", nd.zeros(shape))
    arrs = [_rand(shape, i) for i in range(4)]
    vals = [nd.array(a, ctx=c) for a, c in zip(arrs, ctxs)]
    outs = [nd.zeros(shape, ctx=c) for c in ctxs]
    kv.pushpull("0", vals, out=outs)
    for o in outs:
        np.testing.assert_allclose(o.asnumpy(), sum(arrs), rtol=1e-5)


def test_update_on_kvstore_optimizer():
    kv = kvstore.create("local")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0))
    w0 = _rand((4,), 3)
    kv.init("0", nd.array(w0))
    g = [nd.array(np.ones(4, "float32"), ctx=CTXS[0]),
         nd.array(np.ones(4, "float32"), ctx=CTXS[1])]
    kv.push("0", g)
    out = [nd.zeros((4,), ctx=CTXS[0])]
    kv.pull("0", out=out)
    np.testing.assert_allclose(out[0].asnumpy(), w0 - 0.5 * 2.0, rtol=1e-6)


def test_xla_rejects_optimizer():
    kv = kvstore.create("xla")
    with pytest.raises(MXNetError):
        kv.set_optimizer(mx.optimizer.SGD())


def test_gradient_compression_2bit():
    kv = kvstore.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("0", nd.zeros((4,)))
    g = np.array([0.3, -0.3, 0.8, -0.9], "float32")
    vals = [nd.array(g, ctx=CTXS[0]), nd.array(g, ctx=CTXS[1])]
    outs = [nd.zeros((4,), ctx=CTXS[0])]
    kv.pushpull("0", vals, out=outs)
    np.testing.assert_allclose(outs[0].asnumpy(),
                               np.array([0, 0, 1.0, -1.0], "float32"))
    kv.pushpull("0", vals, out=outs)
    np.testing.assert_allclose(outs[0].asnumpy(),
                               np.array([1.0, -1.0, 1.0, -1.0], "float32"))


def test_custom_kvstore_registration():
    from mxnet_tpu_torch.kvstore import KVStoreBase

    @KVStoreBase.register
    class Doubling(kvstore.KVStore):
        _TYPE = "doubling"
        CAPABILITIES = ()

        def _reduce(self, k, vals):
            acc = vals[0]
            for v in vals[1:]:
                acc = acc + v.as_in_context(acc.context)
            return acc * 2

    kv = kvstore.create("doubling")
    assert kv.type == "doubling"
    kv.init("0", nd.zeros((2,)))
    vals = [nd.array(np.ones(2, "float32"), ctx=c) for c in CTXS]
    outs = [nd.zeros((2,), ctx=CTXS[0])]
    kv.pushpull("0", vals, out=outs)
    np.testing.assert_allclose(outs[0].asnumpy(), np.full(2, 4.0))


def test_unknown_type_raises():
    with pytest.raises(MXNetError):
        kvstore.create("no_such_store")


def _make_net(ctxs):
    net = gluon.nn.Dense(1, use_bias=True)
    net.initialize(mx.initializer.Xavier(), ctx=ctxs)
    return net


def _train_two_ctx(mod, ctxs, kv, X, Y, steps, opt="sgd", lr=0.1,
                   weights=None, update_on_kvstore=None):
    """``steps`` data-parallel steps of a Dense(1) in package ``mod`` (the
    port or the JAX package); returns the parameters by order."""
    g, ag, ndm = mod.gluon, mod.autograd, mod.nd
    net = g.nn.Dense(1, use_bias=True, in_units=X.shape[1])
    net.initialize(mod.initializer.Xavier(), ctx=ctxs)
    if weights is not None:
        for p, w in zip(net.collect_params().values(), weights):
            p.set_data(ndm.array(w, ctx=ctxs[0]))
    trainer = g.Trainer(net.collect_params(), opt, {"learning_rate": lr},
                        kvstore=kv, update_on_kvstore=update_on_kvstore)
    loss_fn = g.loss.L2Loss()
    for _ in range(steps):
        xs = g.utils.split_and_load(ndm.array(X, ctx=ctxs[0]), ctxs)
        ys = g.utils.split_and_load(ndm.array(Y, ctx=ctxs[0]), ctxs)
        with ag.record():
            losses = [loss_fn(net(x), y) for x, y in zip(xs, ys)]
        for lo in losses:
            lo.backward()
        trainer.step(X.shape[0])
    return [v.data(ctxs[0]).asnumpy()
            for v in net.collect_params().values()], net, trainer


@pytest.mark.parametrize("kv_type", ["device", "xla"])
def test_trainer_multi_device_matches_single(kv_type):
    X = _rand((8, 3), 7)
    Y = (X @ np.array([[1.0], [-2.0], [0.5]], "float32")
         + 0.1).astype("float32")
    w0 = [_rand((1, 3), 5), np.zeros((1,), np.float32)]
    single, _, _ = _train_two_ctx(mx, [mx.cpu(0)], None, X, Y, 5,
                                  weights=w0)
    multi, _, _ = _train_two_ctx(mx, CTXS, kv_type, X, Y, 5, weights=w0)
    assert len(single) == len(multi)
    for s, m in zip(single, multi):
        np.testing.assert_allclose(m, s, rtol=1e-5, atol=1e-6)
    # the same run in the JAX package on cpu(0) / cpu(1)
    ref, _, _ = _train_two_ctx(jmx, JCTXS, kv_type, X, Y, 5, weights=w0)
    for r, m in zip(ref, multi):
        np.testing.assert_allclose(m, r, rtol=1e-5, atol=1e-6)


def test_trainer_multi_device_replicas_stay_synced():
    X, Y = _rand((8, 3), 11), _rand((8, 1), 12)
    _, net, _ = _train_two_ctx(mx, CTXS, "xla", X, Y, 3, opt="adam",
                               lr=1e-2)
    for p in net.collect_params().values():
        copies = [d.asnumpy() for d in p.list_data()]
        np.testing.assert_allclose(copies[0], copies[1], rtol=1e-6)


def test_trainer_set_lr_reaches_all_devices():
    net = _make_net(CTXS)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore="device")
    X, Y = _rand((4, 3), 1), _rand((4, 1), 2)
    loss_fn = gluon.loss.L2Loss()

    def one_step():
        xs = gluon.utils.split_and_load(nd.array(X), CTXS)
        ys = gluon.utils.split_and_load(nd.array(Y), CTXS)
        with autograd.record():
            losses = [loss_fn(net(x), y) for x, y in zip(xs, ys)]
        for lo in losses:
            lo.backward()
        trainer.step(X.shape[0])

    one_step()
    trainer.set_learning_rate(0.0)
    before = [d.asnumpy() for p in net.collect_params().values()
              for d in p.list_data()]
    one_step()
    after = [d.asnumpy() for p in net.collect_params().values()
             for d in p.list_data()]
    for b, a in zip(before, after):
        np.testing.assert_array_equal(b, a)


def test_trainer_save_load_states_multi_device(tmp_path):
    net = _make_net(CTXS)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-2}, kvstore="device")
    X, Y = _rand((4, 3), 1), _rand((4, 1), 2)
    loss_fn = gluon.loss.L2Loss()
    xs = gluon.utils.split_and_load(nd.array(X), CTXS)
    ys = gluon.utils.split_and_load(nd.array(Y), CTXS)
    with autograd.record():
        losses = [loss_fn(net(x), y) for x, y in zip(xs, ys)]
    for lo in losses:
        lo.backward()
    trainer.step(X.shape[0])
    fname = str(tmp_path / "trainer.states")
    trainer.save_states(fname)
    trainer2 = gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 1e-2}, kvstore="device")
    trainer2.load_states(fname)
    assert len(trainer2._dev_updaters) == len(CTXS)
    for updater in trainer2._dev_updaters.values():
        assert updater.states.keys() == trainer._updater.states.keys()
        assert updater.optimizer is trainer2._optimizer


def test_trainer_update_on_kvstore():
    X = _rand((8, 3), 7)
    Y = (X @ np.array([[1.0], [-2.0], [0.5]], "float32")).astype("float32")
    w0 = [_rand((1, 3), 9), np.zeros((1,), np.float32)]
    worker_side, _, _ = _train_two_ctx(mx, CTXS, "local", X, Y, 3,
                                       weights=w0, update_on_kvstore=False)
    server_side, _, _ = _train_two_ctx(mx, CTXS, "local", X, Y, 3,
                                       weights=w0, update_on_kvstore=True)
    for w, s in zip(worker_side, server_side):
        np.testing.assert_allclose(s, w, rtol=1e-5, atol=1e-6)


def test_dist_async_documented_unsupported():
    with pytest.raises(MXNetError, match="intentionally unsupported"):
        kvstore.create("dist_async")
    with pytest.raises(MXNetError, match="dist_sync"):
        kvstore.create("dist_device_async")


# ---------------------------------------------------------------------------
# tests/test_quantize.py::TestKVStoreQuantized
# ---------------------------------------------------------------------------
class TestKVStoreQuantized:
    @pytest.mark.parametrize("kind", ["int8", "fp8"])
    def test_xla_compressed_pushpull_parity(self, kind):
        shape = (128, 40)
        a, b = _rand(shape, 1, 0.1), _rand(shape, 2, 0.1)
        got = []
        for mod, ctxs in ((mx, CTXS), (jmx, JCTXS)):
            kv = mod.kvstore.create("xla")
            kv.set_gradient_compression({"type": kind, "block": 128})
            kv.init("w", mod.nd.zeros(shape, ctx=ctxs[0]))
            vals = [mod.nd.array(a, ctx=ctxs[0]),
                    mod.nd.array(b, ctx=ctxs[1])]
            outs = [mod.nd.zeros(shape, ctx=c) for c in ctxs]
            kv.pushpull("w", vals, out=outs)
            got.append([o.asnumpy() for o in outs])
        ours, ref = got
        assert np.abs(ours[0] - (a + b)).max() < 0.02
        np.testing.assert_array_equal(ours[0], ours[1])
        np.testing.assert_allclose(ours[0], ref[0], rtol=1e-6, atol=1e-7)

    def _wire(self, shape, compression, push_only=False):
        rm.enable()
        rm.reset()
        try:
            kv = kvstore.create("xla")
            if compression:
                kv.set_gradient_compression({"type": compression})
            kv.init("w", nd.zeros(shape))
            vals = [nd.array(_rand(shape, i, 0.1), ctx=c)
                    for i, c in enumerate(CTXS)]
            if push_only:
                kv.push("w", vals)
                outs = [nd.zeros(shape, ctx=CTXS[0])]
                kv.pull("w", out=outs)
            else:
                outs = [nd.zeros(shape, ctx=c) for c in CTXS]
                kv.pushpull("w", vals, out=outs)
            return (rm.KV_PUSH_BYTES.value(), rm.KV_WIRE_BYTES.value(),
                    outs[0].asnumpy(), vals)
        finally:
            rm.disable()
            rm.reset()

    def test_xla_wire_bytes_ratio(self):
        push, wire, _, _ = self._wire((256, 64), "int8")
        assert push / wire >= 3.5, (push, wire)
        assert wire < push / 3, (push, wire)

    def test_xla_uncompressed_wire_equals_logical(self):
        push, wire, _, _ = self._wire((64, 8), None)
        assert wire == push > 0

    def test_xla_error_feedback_converges(self):
        kv = kvstore.create("xla")
        kv.set_gradient_compression({"type": "int8", "block": 64})
        shape = (64, 9)
        kv.init("w", nd.zeros(shape))
        a, b = _rand(shape, 1, 0.1), _rand(shape, 2, 0.1)
        vals = [nd.array(a, ctx=CTXS[0]), nd.array(b, ctx=CTXS[1])]
        outs = [nd.zeros(shape, ctx=c) for c in CTXS]
        want = a + b
        kv.pushpull("w", vals, out=outs)
        one_step = np.abs(outs[0].asnumpy() - want).max()
        acc = np.zeros(shape, np.float32)
        steps = 16
        for _ in range(steps):
            kv.pushpull("w", vals, out=outs)
            acc += outs[0].asnumpy()
        averaged = np.abs(acc / steps - want).max()
        assert averaged < one_step / 3, (averaged, one_step)

    def test_xla_compressed_multi_key_bucket_fusion(self):
        kv = kvstore.create("xla")
        kv.set_gradient_compression({"type": "int8", "block": 64})
        kv.bigarray_bound = 256
        shapes = [(7,), (130,), (300,)]
        keys = [str(i) for i in range(len(shapes))]
        kv.init(keys, [nd.zeros(s) for s in shapes])
        per_key, want = [], []
        for i, s in enumerate(shapes):
            a, b = _rand(s, i, 0.1), _rand(s, 100 + i, 0.1)
            per_key.append([nd.array(a, ctx=CTXS[0]),
                            nd.array(b, ctx=CTXS[1])])
            want.append(a + b)
        outs = [[nd.zeros(s, ctx=c) for c in CTXS] for s in shapes]
        kv.pushpull(keys, per_key, out=outs)
        for i in range(len(shapes)):
            assert np.abs(outs[i][0].asnumpy() - want[i]).max() < 0.02

    def test_local_tier_quant_compressor(self):
        kv = kvstore.create("device")
        kv.set_gradient_compression("int8:block=32")
        shape = (64,)
        kv.init("0", nd.zeros(shape))
        g = _rand(shape, 3, 0.1)
        vals = [nd.array(g, ctx=c) for c in CTXS]
        outs = [nd.zeros(shape, ctx=CTXS[0])]
        kv.pushpull("0", vals, out=outs)
        assert np.abs(outs[0].asnumpy() - 2 * g).max() < 0.01
        # the JAX tier's value round trip gives the same sum
        jkv = jkvstore.create("device")
        jkv.set_gradient_compression("int8:block=32")
        jkv.init("0", jnd.zeros(shape))
        jouts = [jnd.zeros(shape, ctx=JCTXS[0])]
        jkv.pushpull("0", [jnd.array(g, ctx=c) for c in JCTXS], out=jouts)
        np.testing.assert_allclose(outs[0].asnumpy(), jouts[0].asnumpy(),
                                   rtol=0, atol=1e-7)

    def test_env_knob_compresses_created_stores(self, monkeypatch):
        monkeypatch.setenv("MXNET_KVSTORE_GRAD_COMPRESSION", "int8")
        kv = kvstore.create("xla")
        from mxnet_tpu_torch.kvstore.kvstore import _QuantCompressor
        assert isinstance(kv._compressor, _QuantCompressor)
        assert kv._compressor.spec.kind == "int8"
        kv.set_gradient_compression(None)
        assert kv._compressor is None

    def test_xla_classic_push_path_still_compresses(self):
        shape = (256, 16)
        push, wire, out, vals = self._wire(shape, "int8", push_only=True)
        want = vals[0].asnumpy() + vals[1].asnumpy()
        assert np.abs(out - want).max() < 0.02
        assert wire < push / 3, (push, wire)

    def test_int8_int_dtype_keys_stay_exact(self):
        kv = kvstore.create("xla")
        kv.set_gradient_compression({"type": "int8"})
        kv.init("i", nd.array(np.zeros((8,), "int32")))
        vals = [nd.array(np.arange(8, dtype="int32"), ctx=c) for c in CTXS]
        outs = [nd.array(np.zeros((8,), "int32"), ctx=CTXS[0])]
        kv.pushpull("i", vals, out=outs)
        np.testing.assert_array_equal(outs[0].asnumpy(),
                                      2 * np.arange(8, dtype="int32"))


def test_xla_copies_on_two_cards_are_refused():
    """The multi-card branch of the ``xla`` tier raises until a machine
    with more cards runs it (two copies whose tensors report two
    cards)."""
    import torch

    class _Copy:
        def __init__(self, i):
            self.context = mx.gpu(i)
            self.shape, self.size = (2,), 2
            self._data = type("T", (), {"device": torch.device("cuda", i)})

    kv = kvstore.create("xla")
    with pytest.raises(MXNetError, match="more than one card"):
        kv._fused_allreduce([("w", [_Copy(0), _Copy(1)])])


# ---------------------------------------------------------------------------
# tests/test_dist.py::TestLauncher::test_dist_sync_kvstore, and the dist
# rule of the port's Trainer
# ---------------------------------------------------------------------------
DIST_BODY = """
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
with mx.cpu(0):
    kv = mx.kv.create("dist_sync")
    assert kv.num_workers == 2
    kv.init("w", nd.array(np.full((2,), 10.0 * (kv.rank + 1), np.float32)))
    w0 = nd.zeros((2,))
    kv.pull("w", out=w0)
    np.testing.assert_allclose(w0.asnumpy(), 10.0)
    kv.init("3", nd.zeros((2, 2)))
    kv.push("3", nd.array(np.full((2, 2), kv.rank + 1.0, np.float32)))
    out = nd.zeros((2, 2))
    kv.pull("3", out=out)
    np.testing.assert_allclose(out.asnumpy(), 3.0)
    OUT["kv_ok"] = np.array(1)

    # the dist rule: one context per rank, rank-dependent initial weights
    net = gluon.nn.Dense(2, in_units=4)
    net.initialize(mx.init.Xavier())
    params = list(net.collect_params().values())
    for p, k in zip(params, ("w0", "b0")):
        p.set_data(nd.array(IN[k] * (RANK + 1)))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore="dist_sync")
    loss_fn = gluon.loss.L2Loss()
    rows = slice(4 * RANK, 4 * RANK + 4)
    X, Y = nd.array(IN["X"][rows]), nd.array(IN["Y"][rows])
    for step in range(3):
        with autograd.record():
            loss = loss_fn(net(X), Y)
        loss.backward()
        trainer.step(8)
        for i, p in enumerate(params):
            OUT[f"step{step}_p{i}"] = p.data().asnumpy()
    OUT["kvstore_type"] = np.array(trainer._kvstore.type)
"""


def test_dist_sync_kvstore_and_trainer_dist_rule(tmp_path):
    X, Y = _rand((8, 4), 21), _rand((8, 2), 22)
    w0, b0 = _rand((2, 4), 23), _rand((2,), 24)
    outs = run_job(tmp_path, 2, DIST_BODY,
                   inputs={"X": X, "Y": Y, "w0": w0, "b0": b0},
                   timeout=240)
    assert all(int(o["kv_ok"]) == 1 for o in outs)
    assert [str(o["kvstore_type"]) for o in outs] == ["dist_sync"] * 2
    # one process, the whole batch, from rank 0's weights
    net = gluon.nn.Dense(2, in_units=4)
    net.initialize()
    params = list(net.collect_params().values())
    for p, w in zip(params, (w0, b0)):
        p.set_data(nd.array(w))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore=None)
    loss_fn = gluon.loss.L2Loss()
    for step in range(3):
        with autograd.record():
            loss = loss_fn(net(nd.array(X)), nd.array(Y))
        loss.backward()
        trainer.step(8)
        for i, p in enumerate(params):
            key = f"step{step}_p{i}"
            np.testing.assert_array_equal(outs[0][key], outs[1][key])
            np.testing.assert_allclose(outs[0][key], p.data().asnumpy(),
                                       rtol=1e-5, atol=1e-6)
