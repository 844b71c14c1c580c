"""PyTorch port, Gluon's symbolic side: a HybridBlock composed over
Symbols (``Parameter.var``), ``HybridBlock.export`` /
``SymbolBlock.imports`` within the port and across the packages both
ways, a ``SymbolBlock`` over shared parameters (trained through a
``Trainer``), a hybridized ``SymbolBlock`` (its ``CachedOp``), and the
encoder layer of ``chip_smoke.py`` (``F.flash_selfatt``) as a
SymbolBlock against the JAX package's layer.  Blocks are made under an
explicit prefix so that both packages name their parameters alike.

Tolerances: fp32 forward 1e-5 relative to the output's max; gradients
1e-4 relative to each gradient's max|grad|.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd

FWD_RTOL, GRAD_RTOL = 1e-5, 1e-4


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


def _lenet(pkg, prefix):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(channels=6, kernel_size=3, activation="relu"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Dense(32, activation="relu"),
                nn.Dense(10))
    return net


def _x(seed=0, n=4):
    return np.random.RandomState(seed).rand(n, 1, 12, 12).astype(np.float32)


def _made(pkg, prefix, path=None):
    """The LeNet initialized (the JAX package's draw) or loaded."""
    net = _lenet(pkg, prefix)
    if path is None:
        pkg.random.seed(0)
        net.initialize(pkg.init.Xavier())
        net(pkg.nd.array(_x()))
    else:
        net.load_parameters(path)
    return net


@pytest.fixture
def weights(tmp_path):
    """A LeNet's weights drawn by the JAX package, by structural name."""
    path = str(tmp_path / "lenet.npz")
    _made(jmx, "lenet_").save_parameters(path)
    return path


def test_composition_names_the_parameters_as_the_jax_package():
    outs = []
    for pkg in (mx, jmx):
        net = _lenet(pkg, "comp_")
        net.initialize()
        s = net(pkg.sym.var("data"))
        outs.append((s.list_arguments(), s.infer_shape(data=(4, 1, 12, 12))))
        assert isinstance(s, pkg.Symbol)
    assert outs[0][0] == outs[1][0]
    assert "comp_dense1_weight" in outs[0][0]
    assert outs[0][1] == outs[1][1]


def test_parameter_var_carries_shape_and_dtype():
    p = gluon.Parameter("w", shape=(3, 4), dtype="float32")
    v = p.var()
    assert v.name == "w" and v is p.var()
    assert v.attr("__shape__") == "(3, 4)"
    assert v.attr("__dtype__") == "float32"
    assert v.infer_shape()[0] == [(3, 4)]


@pytest.mark.parametrize("hybridize", [False, True])
def test_export_then_imports(tmp_path, weights, hybridize):
    net = _made(mx, "lenet_", weights)
    if hybridize:
        net.hybridize()
    x = nd.array(_x(1))
    want = net(x).asnumpy()
    sym_file = net.export(str(tmp_path / "exp"), epoch=3)
    assert sym_file.endswith("exp-symbol.json")
    blk = gluon.SymbolBlock.imports(sym_file, ["data"],
                                    str(tmp_path / "exp-0003.params"))
    _close(blk(x).asnumpy(), want, FWD_RTOL)
    blk.hybridize()
    _close(blk(x).asnumpy(), want, FWD_RTOL)
    _close(blk(x).asnumpy(), want, FWD_RTOL)
    assert blk._cached_op.stats()["programs"] == 1


@pytest.mark.parametrize("writer,reader", [(jmx, mx), (mx, jmx)],
                         ids=["jax_exports_port_imports",
                              "port_exports_jax_imports"])
def test_export_crosses_packages(tmp_path, weights, writer, reader):
    net = _made(writer, "lenet_", weights)
    x = _x(2)
    want = net(writer.nd.array(x)).asnumpy()
    sym_file = net.export(str(tmp_path / "cross"))
    blk = reader.gluon.SymbolBlock.imports(
        sym_file, "data", str(tmp_path / "cross-0000.params"))
    _close(blk(reader.nd.array(x)).asnumpy(), want, FWD_RTOL)


def test_symbol_block_over_shared_parameters_trains_them(weights):
    """Gradients through the SymbolBlock are the block's; a Trainer over
    the SymbolBlock's parameters moves the source block's weights."""
    net = _made(mx, "lenet_", weights)
    ref = _made(mx, "lenet_", weights)
    data = mx.sym.var("data")
    sb = gluon.SymbolBlock(net(data), data, params=net.collect_params())
    assert set(sb.collect_params().keys()) == set(
        net.collect_params().keys())
    for name, p in sb.collect_params().items():
        assert p is net.collect_params()[name]
    x = nd.array(_x(3))
    y = nd.array(np.arange(4, dtype=np.float32))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for block in (sb, ref):
        with autograd.record():
            loss = loss_fn(block(x), y)
        loss.backward()
    for (n, p), q in zip(net.collect_params().items(),
                         ref.collect_params().values()):
        _close(p.grad().asnumpy(), q.grad().asnumpy(), GRAD_RTOL, what=n)
    before = net[0].weight.data().asnumpy().copy()
    gluon.Trainer(sb.collect_params(), "sgd",
                  {"learning_rate": 0.1}).step(4)
    assert not np.array_equal(before, net[0].weight.data().asnumpy())


def test_hybridized_symbol_block_gradients(weights):
    net = _made(mx, "lenet_", weights)
    data = mx.sym.var("data")
    grads = []
    for hybridize in (False, True):
        sb = gluon.SymbolBlock(net(data), data, params=net.collect_params())
        if hybridize:
            sb.hybridize()
        x = nd.array(_x(4))
        x.attach_grad()
        for _ in range(2):
            with autograd.record():
                out = sb(x)
            out.backward(nd.array(np.random.RandomState(5).randn(
                *out.shape).astype(np.float32)))
        grads.append((x.grad.asnumpy().copy(),
                      net[2].weight.grad().asnumpy().copy()))
    for a, b in zip(*grads):
        _close(a, b, GRAD_RTOL)
    assert sb._cached_op.stats()["programs"] == 1


def test_imports_without_params_defers_until_the_first_call(tmp_path,
                                                           weights):
    net = _made(mx, "lenet_", weights)
    sym_file = net.export(str(tmp_path / "bare"))
    blk = gluon.SymbolBlock.imports(sym_file, "data")
    blk.initialize(mx.init.Xavier())
    out = blk(nd.array(_x()))
    assert out.shape == (4, 10)
    shapes = {n: p.shape for n, p in blk.collect_params().items()}
    assert shapes["lenet_conv2d0_weight"] == (6, 1, 3, 3)
    assert shapes["lenet_dense0_weight"] == (32, 150)


def test_symbol_block_of_a_symbol_composes_again():
    data = mx.sym.var("data")
    sb = gluon.SymbolBlock(mx.sym.relu(data, name="r"), data)
    out = sb(mx.sym.var("x"))
    assert out.list_arguments() == ["x"]


def _encoder(pkg, units, heads, ffn):
    nnm = pkg.gluon.nn

    class EncoderLayer(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.qkv = nnm.Dense(3 * units, flatten=False,
                                     in_units=units)
                self.proj = nnm.Dense(units, flatten=False, in_units=units)
                self.ln1 = nnm.LayerNorm(in_channels=units)
                self.head = nnm.Dense(2, in_units=units)

        def hybrid_forward(self, F, x, valid_length):
            att = F.flash_selfatt(self.qkv(x), valid_length, heads=heads)
            h = self.ln1(x + self.proj(att))
            return self.head(F.squeeze(F.slice_axis(h, axis=0, begin=0,
                                                    end=1), axis=0))

    return EncoderLayer(prefix="enc_")


def test_flash_encoder_symbol_block_matches_jax(tmp_path):
    L, B, units, heads, ffn = 16, 3, 32, 2, 64
    rs = np.random.RandomState(9)
    x = (rs.randn(L, B, units) * 0.5).astype(np.float32)
    valid = np.array([16, 7, 0], np.float32)
    jnet = _encoder(jmx, units, heads, ffn)
    jnet.initialize(jmx.init.Xavier())
    path = str(tmp_path / "enc.npz")
    jnet.save_parameters(path)
    want = jnet(jmx.nd.array(x), jmx.nd.array(valid)).asnumpy()
    net = _encoder(mx, units, heads, ffn)
    net.load_parameters(path)
    dv, vv = mx.sym.var("data"), mx.sym.var("valid_length")
    sb = gluon.SymbolBlock(net(dv, vv), [dv, vv],
                           params=net.collect_params())
    for hybridize in (False, True):
        if hybridize:
            sb.hybridize()
        got = sb(nd.array(x), nd.array(valid)).asnumpy()
        _close(got, want, FWD_RTOL, what=hybridize)
    jsym = jnet(jmx.sym.var("data"), jmx.sym.var("valid_length"))
    assert jsym.list_arguments() == net(dv, vv).list_arguments()


def test_imports_the_jax_fixture_with_auxiliary_states(tmp_path):
    """``tests/fixtures/jax_symbol_graph.json`` (written by the JAX
    package; BatchNorm's moving statistics are auxiliary states) as a
    SymbolBlock, its values from an npz, against the JAX executor."""
    from test_torch_symbol import FIXTURE, fixture_arrays, forward
    theirs = jmx.sym.load(FIXTURE)
    args, aux = fixture_arrays(theirs)
    inputs = ("data", "valid_length", "image")
    path = str(tmp_path / "fixture.npz")
    jmx.nd.save(path, {k: jmx.nd.array(v) for k, v in {**args, **aux}.items()
                       if k not in inputs})
    blk = gluon.SymbolBlock.imports(FIXTURE, list(inputs), path)
    assert blk.collect_params()["bn_moving_var"].grad_req == "null"
    want = forward(jmx, theirs, args, aux)
    got = blk(*(nd.array(args[n]) for n in inputs))
    for g, w in zip(got, want):
        _close(g.asnumpy(), w, FWD_RTOL)
