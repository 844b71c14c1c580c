"""PyTorch port, ``gluon.contrib.MoEFFN`` (``mxnet_tpu_torch/gluon/
contrib/moe.py``) and the expert rules, against the JAX package.

Twins of ``tests/test_moe.py``'s ``test_gluon_moe_block_eager_hybrid_
parity``, ``test_moe_trains_with_gradient``,
``test_expert_rules_on_mesh_without_ep_axis`` and
``test_make_mesh_ep_backcompat`` (the op tests are twinned in
``test_torch_moe_ops.py``; the dp 2 x ep 2 ``test_expert_parallel_
sharded_step`` runs in the four-rank job of
``test_torch_parallel_tp.py``).  The port's layer takes the JAX layer's
weights (``ParameterDict.load_dict``); outputs within rtol 1e-5 / atol
1e-6, aux losses rtol 1e-5, training losses rtol 1e-5 for the first
three Adam steps (the reference's bounds).  Beyond them: the errors of
the constructor, the one-rank ``ShardedTrainer`` over the Gluon layer
(its parameters by their Gluon names) against the JAX trainer's losses
(atol 1e-5), and BatchNorm's running statistics coming back from the
trainer (``write_back``).
"""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.contrib import MoEFFN as JMoEFFN

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.gluon.contrib import MoEFFN


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _pair(seed, **kw):
    """The JAX layer from ``seed`` and the port's with its weights."""
    jmx.random.seed(seed)
    jlayer = JMoEFFN(**kw)
    jlayer.initialize(jmx.init.Xavier())
    layer = MoEFFN(**kw)
    layer.initialize()
    layer.collect_params().load_dict(
        {k: v.data().asnumpy() for k, v in jlayer.collect_params().items()})
    return jlayer, layer


def test_gluon_moe_block_eager_hybrid_parity():
    jlayer, layer = _pair(0, units=8, hidden_size=16, num_experts=4,
                          capacity_factor=2.0)
    x = np.random.RandomState(2).randn(2, 6, 8).astype(np.float32)
    out_e, aux_e = layer(nd.array(x))
    layer.hybridize()
    out_h, aux_h = layer(nd.array(x))
    out_h2, _ = layer(nd.array(x))
    np.testing.assert_allclose(out_e.asnumpy(), out_h.asnumpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_h2.asnumpy(), out_h.asnumpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux_e.asscalar()),
                               float(aux_h.asscalar()), rtol=1e-5)
    jout, jaux = jlayer(jnd.array(x))
    np.testing.assert_allclose(out_e.asnumpy(), jout.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux_e.asscalar()),
                               float(jaux.asscalar()), rtol=1e-5)


def test_moe_constructor_errors_match_jax():
    for kw, match in ((dict(num_experts=0), "num_experts >= 1"),
                      (dict(num_experts=2, activation="tanh"),
                       "unsupported activation 'tanh'")):
        with pytest.raises(mx.MXNetError, match=match):
            MoEFFN(units=4, hidden_size=8, **kw)
        with pytest.raises(jmx.MXNetError, match=match):
            JMoEFFN(units=4, hidden_size=8, **kw)


def _train(m, ag, layer, trainer, X, Y, steps):
    losses = []
    for _ in range(steps):
        x, y = m.nd.array(X), m.nd.array(Y)
        with ag.record():
            out, aux = layer(x)
            loss = ((out + x - y) ** 2).mean() + 0.01 * aux
        loss.backward()
        trainer.step(64)
        losses.append(float(loss.asscalar()))
    return losses


def test_moe_trains_with_gradient():
    # tiny regression: MoE layer + residual learns a mapping; aux loss
    # balances experts
    kw = dict(units=4, hidden_size=8, num_experts=2, capacity_factor=2.0,
              activation="relu")
    jlayer, layer = _pair(1, **kw)
    rng = np.random.RandomState(3)
    X = rng.randn(64, 4).astype(np.float32)
    Y = np.tanh(X[:, ::-1].copy()).astype(np.float32)
    trainer = gluon.Trainer(layer.collect_params(), "adam",
                            {"learning_rate": 5e-3})
    losses = _train(mx, autograd, layer, trainer, X, Y, 120)
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    jtrainer = jgluon.Trainer(jlayer.collect_params(), "adam",
                              {"learning_rate": 5e-3})
    jl = _train(jmx, jautograd, jlayer, jtrainer, X, Y, 3)
    np.testing.assert_allclose(losses[:3], jl, rtol=1e-5)


def test_expert_rules_on_mesh_without_ep_axis():
    # a hand-built 3-axis mesh: 'ep' rules degrade to replication, not
    # KeyError
    mesh = tpar.Mesh("cpu", {"dp": 2, "tp": 2, "sp": 1},
                     axis_names=("dp", "tp", "sp"))
    spec = tpar.MEGATRON_RULES.safe_spec(mesh, "net_moe_expert_w1",
                                         (4, 8, 16))
    assert spec[0] is None         # ep dropped
    assert tuple(spec) == (None, None, "tp")
    from jax.sharding import Mesh
    from mxnet_tpu.parallel.sharding import MEGATRON_RULES
    devs = np.array(jax.devices()[:4]).reshape(2, 2, 1)
    jspec = MEGATRON_RULES.shardings(
        Mesh(devs, axis_names=("dp", "tp", "sp")),
        {"net_moe_expert_w1": jnp.zeros((4, 8, 16))})[
        "net_moe_expert_w1"].spec
    assert tuple(jspec) == tuple(spec)


def test_make_mesh_ep_backcompat():
    # existing call sites keep working; default ep axis size 1 (the
    # four-rank job of test_torch_parallel_tp.py makes dp 2 x tp 2 over
    # a group)
    mesh = tpar.make_mesh(device="cpu")
    assert mesh.shape["ep"] == 1 and mesh.shape["dp"] == 1
    assert tpar.Mesh("cpu").shape == {"dp": 1, "tp": 1, "sp": 1, "ep": 1}
    with pytest.raises(mx.MXNetError, match="initialize a process group"):
        tpar.make_mesh(dp=2, tp=2, sp=2, device="cpu")
    jmesh = jpar.make_mesh(dp=2, tp=2, sp=2, devices=jax.devices()[:8])
    assert jmesh.shape["ep"] == 1 and jmesh.shape["dp"] == 2


def _norm(d):
    """``d`` keyed by Gluon names with the blocks' counters dropped (each
    package counts the blocks its process made)."""
    return {re.sub(r"\d+_", "_", k): v for k, v in d.items()}


def _moe_net(m, g):
    class Net(g.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.moe = (MoEFFN if m is mx else JMoEFFN)(
                    units=8, hidden_size=16, num_experts=4,
                    capacity_factor=1.0)
                self.bn = g.nn.BatchNorm(axis=2, in_channels=8)

        def hybrid_forward(self, F, x):
            out, aux = self.moe(x)
            return self.bn(out + x), aux
    return Net()


def test_sharded_trainer_takes_a_gluon_block():
    """The one-rank ShardedTrainer over a Gluon MoE layer + BatchNorm:
    the parameters by their Gluon names, the expert weights unsplit (no
    binding: the plain moe_ffn), three AdamW steps against the JAX
    trainer, and BatchNorm's running mean back in the block."""
    jmx.random.seed(2)
    jnet = _moe_net(jmx, jgluon)
    jnet.initialize(jmx.init.Xavier())
    net = _moe_net(mx, gluon)
    net.initialize()
    net.collect_params().load_dict(
        {k: v.data().asnumpy() for k, v in jnet.collect_params().items()})
    x = np.random.RandomState(4).randn(8, 6, 8).astype(np.float32)
    y = np.random.RandomState(5).randn(8, 6, 8).astype(np.float32)

    def loss_fn(outputs, y):
        out, aux = outputs
        return ((out - y) ** 2).mean() + 0.01 * aux.float()

    def jloss(outputs, y):
        out, aux = outputs
        return ((out - y) ** 2).mean() + 0.01 * aux.astype(jnp.float32)

    opt = dict(optimizer="adamw", optimizer_params={"learning_rate": 1e-3})
    tr = tpar.ShardedTrainer(net, loss_fn, tpar.Mesh("cpu"),
                             example_inputs=(x,), n_labels=1, **opt)
    assert set(tr.params) | set(tr.buffers) == set(net.collect_params())
    assert not tr._tp_bound
    w1 = next(n for n in tr.params if n.endswith("expert_w1"))
    assert tuple(tr.params[w1].shape) == (4, 8, 16)
    losses = [float(tr.step(x, y)) for _ in range(3)]
    jtr = jpar.ShardedTrainer(
        jnet, jloss, jpar.make_mesh(dp=1, tp=1, sp=1,
                                    devices=jax.devices()[:1]),
        example_inputs=(jnd.array(x),), n_labels=1, **opt)
    jl = [float(jax.device_get(jtr.step(jnd.array(x), jnd.array(y))))
          for _ in range(3)]
    np.testing.assert_allclose(losses, jl, atol=1e-5)
    want = _norm(jtr.params)
    mean = next(n for n in tr.buffers if n.endswith("running_mean"))
    tr.write_back()
    got = net.collect_params()[mean].data().asnumpy()
    np.testing.assert_allclose(
        got, np.asarray(want[re.sub(r"\d+_", "_", mean)]), atol=1e-5)
    assert np.abs(got).max() > 1e-3
    params = _norm(tr.params)
    assert set(params) <= set(want)
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   atol=1e-5, err_msg=n)


def test_functionalize_matches_jax():
    """``parallel.functionalize``: the block's forward over given tensors
    (outputs within rtol 1e-5 / atol 1e-6 of the JAX package's
    ``apply_fn``) and the aux states (BatchNorm's running mean) returned
    after the forward."""
    import torch
    from mxnet_tpu.parallel import functionalize as jfunctionalize
    jmx.random.seed(3)
    jnet = _moe_net(jmx, jgluon)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(6).randn(4, 6, 8).astype(np.float32)
    japply, jparams = jfunctionalize(jnet, jnd.array(x))
    net = _moe_net(mx, gluon)
    net.initialize()
    apply_fn, params = tpar.functionalize(net, nd.array(x))
    jnames = {re.sub(r"\d+_", "_", n): n for n in jparams}
    to_jax = {n: jnames[re.sub(r"\d+_", "_", n)] for n in params}
    given = {n: torch.from_numpy(np.asarray(jparams[to_jax[n]]).copy())
             for n in params}
    (out, aux), got_aux = apply_fn(given, torch.from_numpy(x))
    (jout, jaux), jgot_aux = japply(jparams, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    mean = next(n for n in params if n.endswith("running_mean"))
    assert set(got_aux) == {n for n in params if "running" in n}
    np.testing.assert_allclose(got_aux[mean].numpy(),
                               np.asarray(jgot_aux[to_jax[mean]]), atol=1e-6)
    # the block's own arrays are untouched: the given tensors took it
    assert np.abs(net.collect_params()[mean].data().asnumpy()).max() == 0
