"""PyTorch port, Gluon (``mxnet_tpu_torch/gluon/{parameter,block,nn,loss,
utils}``).

Twins of the ``tests/test_gluon.py`` tests that do not count compiled
programs (all but ``test_cached_op_*``: the CachedOp tier waits; in the
port ``hybridize()`` is accepted and runs eagerly, so the hybrid twins
hold the hybridized block to its imperative self).

Against the JAX package, with weights carried across (a block's
``save_parameters`` npz, or ``ParameterDict.save`` by prefixed name):

- the name-prefix case: the twin is built after other blocks, so its
  names count from other numbers, and the port's loaders match them
  with the counters normalised;
- a narrow LeNet (Conv2D / MaxPool2D / Dense, batch 4 of 1x28x28) and
  every loss of ``gluon/loss.py``: loss and gradients within 1e-5
  (LeNet gradients rtol 1e-4: a 800-term float32 contraction summed in
  another order);
- a user ``HybridBlock`` encoder layer around ``F.flash_selfatt`` (the
  port's plain version on the CPU, the JAX op in the Pallas
  interpreter): loss and every gradient within 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _mlp():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"))
        net.add(nn.Dense(8))
    return net


# ---------------------------------------------------------------------------
# tests/test_gluon.py
# ---------------------------------------------------------------------------
def test_parameter_basic():
    p = gluon.Parameter("weight", shape=(4, 3))
    p.initialize(ctx=mx.cpu(0))
    assert p.data().shape == (4, 3)
    assert p.grad().shape == (4, 3)
    assert p.list_ctx() == [mx.cpu(0)]
    p.set_data(nd.ones((4, 3)))
    assert p.data().asnumpy().sum() == 12


def test_parameter_deferred_init():
    net = _mlp()
    net.initialize()
    with pytest.raises(Exception):
        net[0].weight.data()
    net(nd.ones((2, 5)))
    assert net[0].weight.shape == (32, 5)


def test_parameter_sharing():
    d1 = nn.Dense(8, in_units=8)
    d2 = nn.Dense(8, in_units=8, params=d1.collect_params())
    d1.initialize()
    x = nd.random.uniform(shape=(4, 8))
    assert np.allclose(d1(x).asnumpy(), d2(x).asnumpy())


def test_hybrid_vs_imperative():
    net = _mlp()
    net.initialize()
    x = nd.random.uniform(shape=(4, 10))
    y_imp = net(x).asnumpy()
    net.hybridize()
    y_hyb = net(x).asnumpy()
    assert np.allclose(y_imp, y_hyb, atol=1e-5)


def test_hybrid_gradients_match():
    x_np = np.random.RandomState(7).randn(4, 10).astype(np.float32)

    def run(hybridize):
        mx.random.seed(7)
        net = _mlp()
        net.initialize()
        if hybridize:
            net.hybridize()
        x = nd.array(x_np)
        x.attach_grad()
        with autograd.record():
            y = net(x)
            loss = (y * y).sum()
        loss.backward()
        grads = {name[len(net.prefix):]: p.grad().asnumpy()
                 for name, p in net.collect_params().items()}
        return x.grad.asnumpy(), grads

    xg_i, g_i = run(False)
    xg_h, g_h = run(True)
    assert np.allclose(xg_i, xg_h, atol=1e-4)
    for name in g_i:
        assert np.allclose(g_i[name], g_h[name], atol=1e-4), name


def test_conv_pool_shapes():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.MaxPool2D(2, 2),
                nn.Conv2D(16, 3, padding=1), nn.GlobalAvgPool2D(),
                nn.Flatten(), nn.Dense(10))
    net.initialize()
    assert net(nd.ones((2, 3, 16, 16))).shape == (2, 10)


def test_conv_transpose_shape():
    net = nn.Conv2DTranspose(4, 3, strides=2, padding=1, output_padding=1,
                             in_channels=8)
    net.initialize()
    assert net(nd.ones((2, 8, 7, 7))).shape == (2, 4, 14, 14)


def test_batchnorm_train_vs_eval():
    bn = nn.BatchNorm(in_channels=4)
    bn.initialize()
    x = nd.random.uniform(shape=(8, 4, 3, 3))
    with autograd.record():
        y_train = bn(x)
    y_eval = bn(x)
    m = y_train.asnumpy().mean(axis=(0, 2, 3))
    assert np.abs(m).max() < 1e-4
    assert not np.allclose(y_train.asnumpy(), y_eval.asnumpy())


def test_embedding_layer():
    emb = nn.Embedding(10, 6)
    emb.initialize()
    idx = nd.array(np.array([[1, 2], [3, 4]]), dtype="int32")
    assert emb(idx).shape == (2, 2, 6)


def test_layernorm_groupnorm():
    ln = nn.LayerNorm(in_channels=6)
    ln.initialize()
    y = ln(nd.random.uniform(shape=(3, 6)))
    assert np.abs(y.asnumpy().mean(axis=-1)).max() < 1e-4
    gn = nn.GroupNorm(num_groups=2, in_channels=4)
    gn.initialize()
    assert gn(nd.random.uniform(shape=(2, 4, 5, 5))).shape == (2, 4, 5, 5)


def test_save_load_parameters(tmp_path):
    net = _mlp()
    net.initialize()
    x = nd.random.uniform(shape=(2, 12))
    y0 = net(x).asnumpy()
    fname = str(tmp_path / "mlp.params")
    net.save_parameters(fname)
    net2 = _mlp()
    net2.load_parameters(fname)
    assert np.allclose(y0, net2(x).asnumpy(), atol=1e-6)


def test_sequential_getitem_len():
    net = _mlp()
    assert len(net) == 2
    assert isinstance(net[0], nn.Dense)
    assert isinstance(net[0:1], nn.HybridSequential)


def test_activations():
    x = nd.array(np.linspace(-3, 3, 13, dtype=np.float32))
    for blk, ref in [
        (nn.Activation("relu"), lambda v: np.maximum(v, 0)),
        (nn.LeakyReLU(0.1), lambda v: np.where(v > 0, v, 0.1 * v)),
        (nn.ELU(1.0), lambda v: np.where(v > 0, v, np.expm1(v))),
        (nn.Swish(), lambda v: v / (1 + np.exp(-v))),
    ]:
        assert np.allclose(blk(x).asnumpy(), ref(x.asnumpy()), atol=1e-5)


def test_custom_hybrid_block():
    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc = nn.Dense(6, in_units=4)
                self.scale = self.params.get("scale", shape=(1,),
                                             init="ones")

        def hybrid_forward(self, F, x, scale):
            return self.fc(x) * scale

    net = Net()
    net.initialize()
    x = nd.ones((2, 4))
    y1 = net(x).asnumpy()
    net.hybridize()
    y2 = net(x).asnumpy()
    assert np.allclose(y1, y2, atol=1e-6)
    with autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    assert float(np.abs(net.scale.grad().asnumpy()).sum()) > 0
    assert float(np.abs(net.fc.weight.grad().asnumpy()).sum()) > 0


def test_block_summary_runs(capsys):
    net = _mlp()
    net.initialize()
    net.summary(nd.ones((1, 5)))
    assert "Total params" in capsys.readouterr().out


def test_hybrid_dropout_varies_across_calls():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dropout(0.5))
    net.initialize()
    net.hybridize()
    x = nd.ones((4, 64))
    with autograd.record():
        m1 = net(x).asnumpy()
    with autograd.record():
        m2 = net(x).asnumpy()
    assert (m1 != m2).any()
    assert np.allclose(net(x).asnumpy(), 1.0)


def test_multi_precision_adam():
    import mxnet_tpu_torch.optimizer as opt
    w = nd.array(np.ones((4,), np.float16), dtype="float16")
    g = nd.array(np.full((4,), 0.5, np.float16), dtype="float16")
    o = opt.Adam(learning_rate=0.1, multi_precision=True)
    state = o.create_state_multi_precision(0, w)
    assert isinstance(state, tuple) and str(state[0].dtype) == "float32"
    o.update_multi_precision(0, w, g, state)
    assert str(w.dtype) == "float16"
    assert (w.asnumpy() < 1.0).all()


def test_trainer_multi_device_state_not_double_stepped():
    p = gluon.Parameter("w", shape=(2,))
    p.initialize(ctx=[mx.cpu(0)])
    trainer = gluon.Trainer([p], "adam", {"learning_rate": 0.1})
    with autograd.record():
        loss = (p.data() * p.data()).sum()
    loss.backward()
    trainer.step(1)
    assert trainer._updater.optimizer._index_update_count[0] == 1


def test_hybrid_second_backward_raises_clear_error():
    net = nn.Dense(3, in_units=4)
    net.initialize()
    net.hybridize()
    x = nd.random.uniform(shape=(2, 4))
    x.attach_grad()
    with autograd.record():
        h = net(x)
        y1 = h.sum()
        y2 = (h * 2).sum()
    y1.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    y2.backward()
    assert np.allclose(x.grad.asnumpy(), 2 * g1, rtol=1e-5)
    with autograd.record():
        h = net(x)
        y1 = h.sum()
        y2 = (h * 2).sum()
    y1.backward()
    with pytest.raises(mx.MXNetError, match="retain_graph"):
        y2.backward()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).uniform(-1, 1, shape)
            * scale).astype(np.float32)


def test_name_prefix_case_loads_by_normalised_names(tmp_path):
    """The twin is built after other blocks, so its prefixed names count
    from other numbers than the JAX net's (``hybridsequential5_`` against
    ``hybridsequential2_``).  The prefixed ``ParameterDict`` file, the
    structural ``save_parameters`` file and a dict of numpy arrays all
    load, and the outputs agree."""
    def build(pkg):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=8),
                    pkg.gluon.nn.Dense(4, in_units=16))
        return net

    def twin(jnames):
        net = build(mx)
        while list(net.collect_params().keys()) == jnames:
            net = build(mx)
        return net

    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnames = list(jnet.collect_params().keys())
    x = _r((3, 8), 1)
    want = jnet(jnd.array(x)).asnumpy()
    by_name = str(tmp_path / "prefixed.npz")
    jnet.collect_params().save(by_name)
    by_structure = str(tmp_path / "structural.npz")
    jnet.save_parameters(by_structure)

    net = twin(jnames)
    net.collect_params().load(by_name)
    np.testing.assert_allclose(net(nd.array(x)).asnumpy(), want,
                               rtol=1e-5, atol=1e-6)
    net = twin(jnames)
    net.load_parameters(by_structure)
    np.testing.assert_allclose(net(nd.array(x)).asnumpy(), want,
                               rtol=1e-5, atol=1e-6)
    net = twin(jnames)
    net.collect_params().load_dict(
        {k: v.data().asnumpy() for k, v in jnet.collect_params().items()})
    np.testing.assert_allclose(net(nd.array(x)).asnumpy(), want,
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(mx.MXNetError, match="missing"):
        build(mx).collect_params().load_dict({"x_weight": x})


def _lenet(pkg, c1=4, c2=6, hidden=16):
    nnm = pkg.gluon.nn
    net = nnm.HybridSequential()
    with net.name_scope():
        net.add(nnm.Conv2D(c1, kernel_size=5, activation="relu"),
                nnm.MaxPool2D(pool_size=2, strides=2),
                nnm.Conv2D(c2, kernel_size=5, activation="relu"),
                nnm.MaxPool2D(pool_size=2, strides=2),
                nnm.Dense(hidden, activation="relu"),
                nnm.Dense(10))
    return net


def _carry(jnet, net, path, x):
    """Initialise both nets, carry the JAX weights across by file."""
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(x))
    jnet.save_parameters(path)
    net.load_parameters(path)


def _grads(net):
    return [p.grad().asnumpy() for p in net.collect_params().values()
            if p.grad_req != "null"]


def test_lenet_narrow_matches_jax(tmp_path):
    x = _r((4, 1, 28, 28), 2)
    y = np.array([1, 7, 3, 0], np.float32)
    jnet, net = _lenet(jmx), _lenet(mx)
    _carry(jnet, net, str(tmp_path / "lenet.npz"), x)
    res = []
    for pkg, ndm, model in ((mx, nd, net), (jmx, jnd, jnet)):
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = loss_fn(model(ndm.array(x)), ndm.array(y))
        loss.backward()
        res.append((loss.asnumpy(), _grads(model)))
    (lo, go), (lr, gr) = res
    np.testing.assert_allclose(lo, lr, rtol=1e-5, atol=1e-5)
    assert len(go) == len(gr) == 8
    for a, b in zip(go, gr):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


LOSSES = [
    ("L2Loss", {}, "regress"), ("L1Loss", {}, "regress"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob"),
    ("SoftmaxCrossEntropyLoss", {}, "class"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dense"),
    ("KLDivLoss", {"from_logits": False}, "prob"),
    ("HuberLoss", {"rho": 0.5}, "regress"),
    ("HingeLoss", {}, "signed"), ("SquaredHingeLoss", {}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("TripletLoss", {}, "triplet"), ("CosineEmbeddingLoss", {}, "cosine"),
    ("PoissonNLLLoss", {}, "count"),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     "count"),
    ("CTCLoss", {}, "ctc"),
]


def _loss_inputs(kind):
    rs = np.random.RandomState(len(kind))
    pred = rs.uniform(-1, 1, (4, 5)).astype(np.float32)
    if kind == "regress":
        return [pred, rs.uniform(-1, 1, (4, 5)).astype(np.float32)]
    if kind == "binary":
        return [pred, (rs.rand(4, 5) > 0.5).astype(np.float32)]
    if kind == "prob":
        p = rs.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
        return [p, (rs.rand(4, 5) > 0.5).astype(np.float32)]
    if kind == "class":
        return [pred, np.array([0, 4, 2, 1], np.float32)]
    if kind == "dense":
        lab = rs.rand(4, 5).astype(np.float32)
        return [pred, lab / lab.sum(1, keepdims=True)]
    if kind == "signed":
        return [pred, np.sign(rs.uniform(-1, 1, (4, 5))).astype(np.float32)]
    if kind == "triplet":
        return [pred] + [rs.uniform(-1, 1, (4, 5)).astype(np.float32)
                         for _ in range(2)]
    if kind == "cosine":
        return [pred, rs.uniform(-1, 1, (4, 5)).astype(np.float32),
                np.array([1, -1, 1, -1], np.float32)]
    if kind == "count":
        return [rs.uniform(0.1, 2, (4, 5)).astype(np.float32),
                rs.randint(0, 4, (4, 5)).astype(np.float32)]
    # ctc: (N, T, C) activations, labels padded with 0 (blank)
    return [rs.uniform(-1, 1, (2, 6, 5)).astype(np.float32),
            np.array([[1, 2, 0], [3, 3, 4]], np.float32)]


@pytest.mark.parametrize("case", range(len(LOSSES)),
                         ids=[f"{n}{i}" for i, (n, _, _) in enumerate(LOSSES)])
def test_loss_matches_jax(case):
    name, kw, kind = LOSSES[case]
    inputs = _loss_inputs(kind)
    res = []
    for pkg, ndm in ((mx, nd), (jmx, jnd)):
        arrs = [ndm.array(v) for v in inputs]
        arrs[0].attach_grad()
        with pkg.autograd.record():
            loss = getattr(pkg.gluon.loss, name)(**kw)(*arrs)
        loss.backward()
        res.append((loss.asnumpy(), arrs[0].grad.asnumpy()))
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def make_encoder_layer(pkg, units, heads, ffn):
    """The encoder layer of ``chip_smoke.py``'s ``gluon_flash`` phase, as a
    user HybridBlock of package ``pkg``."""
    nnm = pkg.gluon.nn

    class EncoderLayer(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.qkv = nnm.Dense(3 * units, flatten=False,
                                     in_units=units)
                self.proj = nnm.Dense(units, flatten=False, in_units=units)
                self.ln1 = nnm.LayerNorm(in_channels=units)
                self.ffn1 = nnm.Dense(ffn, flatten=False, in_units=units)
                self.gelu = nnm.GELU()
                self.ffn2 = nnm.Dense(units, flatten=False, in_units=ffn)
                self.ln2 = nnm.LayerNorm(in_channels=units)
                self.head = nnm.Dense(2, in_units=units)

        def hybrid_forward(self, F, x, valid_length):
            att = F.flash_selfatt(self.qkv(x), valid_length, heads=heads)
            h = self.ln1(x + self.proj(att))
            h = self.ln2(h + self.ffn2(self.gelu(self.ffn1(h))))
            return self.head(h[0])

    return EncoderLayer()


def test_flash_encoder_block_matches_jax(tmp_path):
    L, B, units, heads, ffn = 16, 2, 32, 2, 64
    x = _r((L, B, units), 3)
    valid = np.array([16, 7], np.float32)
    y = np.array([0, 1], np.float32)
    jnet = make_encoder_layer(jmx, units, heads, ffn)
    net = make_encoder_layer(mx, units, heads, ffn)
    jnet.initialize(jmx.init.Xavier())
    path = str(tmp_path / "enc.npz")
    jnet.save_parameters(path)
    net.load_parameters(path)
    res = []
    for pkg, ndm, model in ((mx, nd, net), (jmx, jnd, jnet)):
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = loss_fn(model(ndm.array(x), ndm.array(valid)),
                           ndm.array(y))
        loss.backward()
        res.append((loss.asnumpy(), _grads(model)))
    (lo, go), (lr, gr) = res
    np.testing.assert_allclose(lo, lr, rtol=1e-5, atol=1e-5)
    assert len(go) == len(gr) == 14
    for a, b in zip(go, gr):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
