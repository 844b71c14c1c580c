"""PyTorch port, ``subgraph.py`` and ``optimize_for``: a twin of each
test of ``tests/test_subgraph.py``.  The same graphs and blocks (the
JAX package's weights loaded into the port's) run on the same numpy
inputs in both packages; outputs agree within 1e-5 of the output's max
(fp32).  Also the ``"inference"`` pass over a two-layer flash
``BERTClassifier`` with dropout 0.1: its ``SymbolBlock`` holds no
``Dropout`` and its logits, eager and hybridized, equal the original
block's eval forward.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.subgraph import (SubgraphProperty, list_backends,
                                      register_backend, rewrite_nodes)

FWD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, rtol=FWD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    assert float(np.abs(got - want).max()) <= rtol * scale


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _ops(sym):
    return [n.op.name for n in sym._topo() if n.op is not None]


def test_inference_pass_strips_dropout():
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        s = pkg.sym
        out = s.relu(s.Dropout(s.dot(s.Variable("data"), s.Variable("w")),
                               p=0.5))
        opt = out.optimize_for("inference")
        assert "Dropout" in _ops(out) and "Dropout" not in _ops(opt)
        outs.append(_first(opt.eval(data=pkg.nd.array(x),
                                    w=pkg.nd.array(w))).asnumpy())
        assert _ops(opt) == ["dot", "relu"]
    _close(outs[1], outs[0])
    _close(outs[1], np.maximum(x @ w, 0))


def test_unknown_backend_raises():
    data = mx.sym.Variable("data")
    with pytest.raises(mx.MXNetError, match="no_such_backend"):
        (data + 1).optimize_for("no_such_backend")
    assert "inference" in list_backends()
    import mxnet_tpu.subgraph as jsub
    assert set(jsub.list_backends()) >= {"inference"}


def test_custom_backend_rewrite():
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.symbol.symbol import _SymNode

    @register_backend("swap_relu_test_torch")
    class SwapRelu(SubgraphProperty):
        def apply(self, sym, **kwargs):
            def node_fn(node, new_inputs):
                if node.op is not None and node.op.name == "relu":
                    return _SymNode(get_op("sigmoid"), new_inputs, {},
                                    node.name + "_sig")
                return None

            return rewrite_nodes(sym, node_fn)

    x = np.array([-1.0, 0.0, 2.0], np.float32)
    opt = mx.sym.relu(mx.sym.Variable("data")).optimize_for(
        "swap_relu_test_torch")
    got = _first(opt.eval(data=nd.array(x))).asnumpy()
    want = jmx.nd.sigmoid(jmx.nd.array(x)).asnumpy()
    _close(got, want)


def _mlp(pkg, path=None):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="sg_")
    with net.name_scope():
        net.add(nn.Dense(8, in_units=4, activation="relu"),
                nn.Dropout(0.5), nn.Dense(3, in_units=8))
    if path is None:
        pkg.random.seed(0)
        net.initialize(pkg.init.Xavier())
    else:
        net.load_parameters(path, ctx=mx.cpu(0))
    return net


def test_hybrid_block_optimize_for(tmp_path):
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    jnet = _mlp(jmx)
    path = str(tmp_path / "mlp.params")
    jnet.save_parameters(path)
    want = jnet.optimize_for(jmx.nd.array(x), backend="inference")(
        jmx.nd.array(x)).asnumpy()
    net = _mlp(mx, path)
    ref = net(nd.array(x)).asnumpy()
    blk = net.optimize_for(nd.array(x), backend="inference")
    _close(blk(nd.array(x)).asnumpy(), want)
    _close(blk(nd.array(x)).asnumpy(), ref)
    assert "Dropout" not in _ops(blk._out_sym)
    # the SymbolBlock shares the block's parameters
    assert blk.collect_params()["sg_dense0_weight"] is \
        net.collect_params()["sg_dense0_weight"]
    blk.hybridize()
    _close(blk(nd.array(x)).asnumpy(), want)


def test_hybrid_block_optimize_for_multi_input(tmp_path):
    a = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    b = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    outs = []
    path = str(tmp_path / "two.params")
    for pkg in (jmx, mx):
        class TwoIn(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = pkg.gluon.nn.Dense(4, in_units=3)

            def hybrid_forward(self, F, a, b):
                return self.fc(a) + self.fc(b)

        net = TwoIn(prefix="two_")
        if pkg is jmx:
            pkg.random.seed(0)
            net.initialize(pkg.init.Xavier())
            net.save_parameters(path)
        else:
            net.load_parameters(path, ctx=mx.cpu(0))
        A, B = pkg.nd.array(a), pkg.nd.array(b)
        ref = net(A, B).asnumpy()
        blk = net.optimize_for(A, B, backend="inference")
        got = blk(A, B).asnumpy()
        _close(got, ref)
        outs.append(got)
    _close(outs[1], outs[0])


def test_optimize_for_requires_backend():
    net = gluon.nn.Dense(2)
    net.initialize()
    x = nd.ones((1, 3))
    net(x)
    with pytest.raises(mx.MXNetError, match="backend"):
        net.optimize_for(x)


def test_bert_classifier_inference_pass():
    """A two-layer flash ``BERTClassifier`` with dropout 0.1 through
    ``optimize_for(..., backend="inference")``: no ``Dropout`` node is
    left, ``_contrib_flash_selfatt`` is kept (one a layer), and the
    SymbolBlock's logits, eager and hybridized, equal the block's eval
    forward within 1e-5 of max|logit|."""
    from mxnet_tpu_torch.models import bert
    mx.random.seed(0)
    enc = bert.BERTModel(vocab_size=64, units=32, hidden_size=64,
                         num_layers=2, num_heads=4, max_length=16,
                         dropout=0.1, use_flash=True)
    clf = bert.BERTClassifier(enc, num_classes=3, dropout=0.1)
    clf.initialize(mx.init.Normal(0.02))
    rng = np.random.RandomState(0)
    ids = nd.array(rng.randint(0, 64, (2, 16)).astype(np.float32))
    tt = nd.zeros((2, 16))
    vl = nd.array(np.array([16, 9], np.float32))
    want = clf(ids, tt, vl).asnumpy()
    blk = clf.optimize_for(ids, tt, vl, backend="inference")
    ops = _ops(blk._out_sym)
    assert "Dropout" not in ops
    assert ops.count("_contrib_flash_selfatt") == 2
    _close(blk(ids, tt, vl).asnumpy(), want)
    blk.hybridize()
    _close(blk(ids, tt, vl).asnumpy(), want)
    _close(blk(ids, tt, vl).asnumpy(), want)
