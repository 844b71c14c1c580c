"""PyTorch port, the vision model zoo
(``mxnet_tpu_torch/gluon/model_zoo/vision.py``) against the JAX package.

Twins of ``tests/test_models.py``'s model-zoo forwards (five names at
1x3x64x64 and Inception V3 at 299x299): each model is built and
initialised in the port, its weights saved (``save_parameters``) and
loaded into the JAX package's twin, and both logits compared within
1e-5 of max|logit| (float32 convolutions summed in another order).
``tests/test_torch_model_zoo_families.py`` runs the same twin for the
other ResNets, the VGGs, AlexNet and the MobileNets.  DenseNet-161 /
169 / 201 differ from DenseNet-121 only by their row of the spec table;
their JAX forwards cost ~120 s of one worker (the JAX package compiles
each new operator shape on first use, and every dense layer's input
width is new), so they are held here by that row, their parameters'
names and declared shapes against the JAX models', and a forward of the
port's model, while DenseNet-121's twin holds the code they share.
Also: the table's names and ``pretrained=True`` against the JAX
package's, and a hybridized ResNet trained after eager steps whose
losses are kept (the card's captures read aliases of the weights, so an
eager step's live graph cannot reach into them).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import cached_op
from mxnet_tpu_torch.gluon.model_zoo import vision

LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _twin(name, shape, tmp_path, seed=0, **kw):
    """The JAX model's logits and the port's from the same weights: the
    port's, drawn from ``seed``, saved and loaded into the JAX model.
    The JAX model is given its parameters' shapes from the file and
    zeros before the load, so that it skips its per-shape random draws
    (the JAX package compiles each on first use)."""
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    mx.random.seed(seed)
    net = gluon.model_zoo.get_model(name, **kw)
    net.initialize()
    got = net(nd.array(x)).asnumpy()
    path = str(tmp_path / f"{name}.npz")
    net.save_parameters(path)
    jnet = jgluon.model_zoo.get_model(name, **kw)
    saved = np.load(path)
    for key, p in jnet._collect_params_with_prefix().items():
        p.shape = tuple(saved[key].shape)
    jnet.initialize(jmx.init.Zero())
    jnet.load_parameters(path)
    want = jnet(jnd.array(x)).asnumpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_TOL * max(float(np.abs(want).max()), 1e-30), \
        (name, err, float(np.abs(want).max()))
    return got


# ---------------------------------------------------------------------------
# tests/test_models.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["resnet18_v1", "resnet18_v2",
                                  "mobilenetv2_1.0", "squeezenet1.0",
                                  "densenet121"])
def test_model_zoo_forward(name, tmp_path):
    out = _twin(name, (1, 3, 64, 64), tmp_path, classes=10)
    assert out.shape == (1, 10)


def test_model_zoo_inception_forward(tmp_path):
    out = _twin("inceptionv3", (1, 3, 299, 299), tmp_path, classes=7)
    assert out.shape == (1, 7)


# ---------------------------------------------------------------------------
# the deep DenseNets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["densenet161", "densenet169",
                                  "densenet201"])
def test_deep_densenet_structure(name):
    depth = int(name[len("densenet"):])
    assert vision._DENSENET_SPEC[depth] == jvision._DENSENET_SPEC[depth]
    net = vision.get_model(name, classes=10)
    net.initialize()
    out = net(nd.array(np.random.RandomState(depth).rand(1, 3, 32, 32)
                       .astype(np.float32)))
    assert out.shape == (1, 10) and np.isfinite(out.asnumpy()).all()
    jnet = jvision.get_model(name, classes=10)
    mine = net._collect_params_with_prefix()
    theirs = jnet._collect_params_with_prefix()
    assert list(mine) == list(theirs)
    for key, p in theirs.items():
        # the JAX model is not run: its input widths are still 0
        declared = tuple(p.shape)
        inferred = tuple(mine[key].shape)
        assert len(declared) == len(inferred), key
        assert all(d in (0, i) for d, i in zip(declared, inferred)), \
            (key, declared, inferred)


def test_families_cover_the_table():
    from test_torch_model_zoo_families import FAMILIES
    twins = {"resnet18_v1", "resnet18_v2", "mobilenetv2_1.0",
             "squeezenet1.0", "densenet121", "inceptionv3"}
    deep = {"densenet161", "densenet169", "densenet201"}
    grouped = {n for names, _s in FAMILIES.values() for n in names}
    assert sorted(vision._MODELS) == sorted(jvision._MODELS)
    assert grouped | twins | deep == set(vision._MODELS)
    assert not grouped & twins and not (grouped | twins) & deep


def test_get_model_refusals_match_jax():
    for name in ("resnet18_v1", "vgg11", "alexnet", "densenet121",
                 "inceptionv3"):
        with pytest.raises(mx.MXNetError, match="pretrained"):
            vision.get_model(name, pretrained=True)
        with pytest.raises(jmx.MXNetError, match="pretrained"):
            jvision.get_model(name, pretrained=True)
    with pytest.raises(mx.MXNetError, match="unknown model"):
        vision.get_model("resnet19_v1")
    assert type(vision.get_model("ResNet18_V1")).__name__ == "ResNetV1"


# ---------------------------------------------------------------------------
# training a hybridized zoo model after eager steps
# ---------------------------------------------------------------------------
def test_resnet_trains_eager_then_hybridized_with_kept_losses(
        tmp_path, monkeypatch):
    """Two eager SGD steps whose losses stay alive, then hybridized steps
    through the card's path on a CUDA-less stand-in of the graphs: the
    captured forward and backward read aliases of the weights (fresh
    leaves over the same storage), and the losses of the first
    hybridized call (eager, then captured) and of the first replayed
    forward equal an eager run's.  (The stand-in's backward replay
    differentiates the capture's saved tensors, so later steps are the
    card's to check.)"""
    from test_torch_cached_op import StandIn
    monkeypatch.setattr(cached_op, "_graph_backend", StandIn)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, stream: None)
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(2, 3, 32, 32).astype(np.float32))
    y = nd.array(rng.randint(0, 10, 2).astype(np.float32))
    path = str(tmp_path / "r18.npz")
    net = vision.get_model("resnet18_v1", classes=10)
    net.initialize(mx.init.MSRAPrelu())
    net(x)
    net.save_parameters(path)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def run(hybrid_from):
        m = vision.get_model("resnet18_v1", classes=10)
        m.load_parameters(path)
        tr = gluon.Trainer(m.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9,
                            "wd": 1e-4})
        kept = []
        for i in range(4):
            if i == hybrid_from:
                m.hybridize(static_alloc=True)
            with autograd.record():
                loss = loss_fn(m(x), y).mean()
            loss.backward()
            tr.step(2)
            kept.append(loss)
        return m, [float(v.asscalar()) for v in kept]

    hybrid, losses = run(2)
    _eager, want = run(99)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[-1] < losses[0]
    prog = next(iter(hybrid._cached_op._cache.values()))
    inst = prog.rec[0]
    homes = {h.data_ptr() for h in prog.homes}
    assert inst.alias is not None
    assert all(a is not h and a.data_ptr() == h.data_ptr()
               for a, h in zip(inst.alias, prog.homes))
    assert {t.data_ptr() for t in inst.leaves()} <= homes | {
        t.data_ptr() for t in inst.inputs}
