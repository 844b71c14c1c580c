"""PyTorch port, training: the port's optimizers and its one-card
``ShardedTrainer`` against the JAX package's on the same numpy inputs.

- ``sgd`` / ``adamw`` / ``lamb`` over five steps on random dicts, atol
  1e-6 (fp32; the port updates in place, the JAX versions return new
  trees);
- the slice as a whole: three ``adamw`` steps of ``ShardedTrainer`` on a
  tiny ``use_flash=True`` ``BERTForPretrain`` (the port's plain flash
  versions on the CPU, the JAX Pallas kernels in interpreter mode on a
  one-device CPU mesh), same weights and batch: losses per step and
  parameters after them agree within atol 1e-4 (three updates of
  different summation orders);
- ``write_back`` carries BatchNorm running statistics (buffers) to the
  block and leaves frozen parameters untouched, against the JAX trainer
  after one SGD step (atol 1e-5);
- without a process group a mesh with an axis above 1 is refused, and
  ``compression=`` on a dp x tp mesh is refused (multi-rank training
  itself: ``test_torch_dist.py``, ``test_torch_parallel_tp.py``).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jm
from mxnet_tpu import nd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import optim as jopt
from mxnet_tpu_torch.models import torch_bert as tm
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import optim as topt

SHAPES = {"w": (7, 5), "b": (5,), "g": (3, 2, 4)}


def _dicts(seed):
    rs = np.random.RandomState(seed)
    return {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("adamw", dict(lr=0.01, wd=0.01)),
    ("lamb", dict(lr=0.01, wd=0.01)),
])
def test_optimizer_matches_jax(name, kw):
    init_j, upd_j = getattr(jopt, f"{name}_init"), getattr(jopt,
                                                           f"{name}_update")
    init_t, upd_t = getattr(topt, f"{name}_init"), getattr(topt,
                                                           f"{name}_update")
    p0 = _dicts(0)
    pj = {n: jnp.asarray(a) for n, a in p0.items()}
    pt = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    sj, st = init_j(pj), init_t(pt)
    for step in range(5):
        g = _dicts(10 + step)
        pj, sj = upd_j(pj, {n: jnp.asarray(a) for n, a in g.items()}, sj,
                       **kw)
        pt, st = upd_t(pt, {n: torch.from_numpy(a) for n, a in g.items()},
                       st, **kw)
    for n in SHAPES:
        np.testing.assert_allclose(pt[n].numpy(), np.asarray(pj[n]),
                                   atol=1e-6)
    if name != "sgd":
        assert st["step"] == int(sj["step"]) == 5


def test_updates_are_in_place():
    p = {n: torch.from_numpy(a) for n, a in _dicts(1).items()}
    ids = {n: t.data_ptr() for n, t in p.items()}
    st = topt.adamw_init(p)
    out, _ = topt.adamw_update(p, {n: torch.ones_like(t)
                                   for n, t in p.items()}, st)
    assert all(out[n].data_ptr() == ids[n] for n in p)
    assert all(st["mean"][n].dtype == p[n].dtype for n in p)


# ---------------------------------------------------------------- the slice
KW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
          num_heads=4, max_length=32, dropout=0.0)
B, L, M = 2, 24, 5


def _batch():
    rs = np.random.RandomState(3)
    valid = np.asarray([24, 13], np.float32)
    return (rs.randint(0, 64, (B, L)).astype(np.int32),
            (np.arange(L)[None] >= 10).astype(np.int32).repeat(B, 0),
            valid,
            np.stack([rs.choice(int(v), M, replace=False)
                      for v in valid]).astype(np.int32),
            rs.randint(0, 64, (B, M)).astype(np.int32),
            rs.randint(0, 2, (B,)).astype(np.int32))


def _jax_loss(outputs, mlm_y, nsp_y):
    mlm_scores, nsp_scores = outputs
    mlm_lp = jax.nn.log_softmax(mlm_scores.astype(jnp.float32), -1)
    nsp_lp = jax.nn.log_softmax(nsp_scores.astype(jnp.float32), -1)
    return (-jnp.take_along_axis(mlm_lp, mlm_y[..., None], -1).mean()
            - jnp.take_along_axis(nsp_lp, nsp_y[:, None], -1).mean())


def test_sharded_trainer_matches_jax_three_adamw_steps():
    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", use_flash=True, **KW)
    jbert.initialize()
    jhead = jm.BERTForPretrain(jbert, vocab_size=64)
    jhead.initialize()
    pre = jhead.prefix
    np_params = {(k[len(pre):] if k.startswith(pre) else k):
                 v.data().asnumpy() for k, v in jhead.collect_params().items()}
    thead = tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", use_flash=True, device="cpu", **KW),
        vocab_size=64).load_numpy_params(np_params)

    batch = _batch()
    feats = tuple(nd.array(a, dtype=str(a.dtype)) for a in batch[:4])
    labels = tuple(nd.array(a, dtype=str(a.dtype)) for a in batch[4:])
    opt = dict(optimizer="adamw", optimizer_params={"learning_rate": 1e-3})
    jtr = jpar.ShardedTrainer(
        jhead, _jax_loss,
        jpar.make_mesh(dp=1, tp=1, sp=1, devices=jax.devices()[:1]),
        example_inputs=feats, n_labels=2, **opt)
    ttr = tpar.ShardedTrainer(thead, tm.pretrain_loss,
                              tpar.make_mesh(dp=1, device="cpu"),
                              example_inputs=batch[:4], n_labels=2, **opt)
    for _ in range(3):
        lj = float(jax.device_get(jtr.step(*feats, *labels)))
        lt = float(ttr.step(*batch))
        np.testing.assert_allclose(lt, lj, atol=1e-4)
    # trainer params by the JAX names (the BERT model's own prefix
    # number depends on how many models the process built before)
    port_name = {id(p): n for n, p in thead.named_parameters()}
    want = {re.sub(r"^bertmodel\d+_", "bertmodel0_", k): np.asarray(v)
            for k, v in jtr.params.items()}
    gluon = thead.gluon_names()
    assert len(gluon) == len(ttr.params) == len(want)
    for gname, p in gluon.items():
        key = gname if gname.startswith("bertmodel0_") else pre + gname
        got = ttr.params[port_name[id(p)]].detach().numpy()
        np.testing.assert_allclose(got, want[key], atol=1e-4, err_msg=key)
    ttr.write_back()
    for n, p in thead.named_parameters():
        assert torch.equal(p.detach(), ttr.params[n].detach())


def test_trainer_refuses_options_of_later_slices():
    """The twin of ``test_quantize.py::TestShardedTrainerCompression::
    test_requires_pure_dp_mesh``: ``compression=`` on a dp x tp mesh (a
    descriptor: the refusal comes before any process group is used)
    raises; an unknown optimizer raises."""
    head = tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", use_flash=True, device="cpu", **KW), vocab_size=64)
    dp_tp = tpar.Mesh("cpu", {"dp": 2, "tp": 2, "sp": 1, "ep": 1})
    with pytest.raises(MXNetError, match="pure data-parallel"):
        tpar.ShardedTrainer(head, tm.pretrain_loss, dp_tp,
                            compression="int8")
    mesh = tpar.make_mesh(device="cpu")
    with pytest.raises(MXNetError, match="unknown optimizer"):
        tpar.ShardedTrainer(head, tm.pretrain_loss, mesh, optimizer="adam")


@pytest.mark.parametrize("axes", [dict(dp=2), dict(tp=2), dict(sp=4)])
def test_make_mesh_refuses_more_than_one_device(axes):
    """Without a process group a mesh is one device: more raises and
    says to initialize the group (``parallel.dist.initialize``)."""
    with pytest.raises(MXNetError, match="initialize a process group"):
        tpar.make_mesh(device="cpu", **axes)


def test_make_mesh_default_device_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tpar.make_mesh()
    assert tpar.make_mesh(devices=["cpu"]).device.type == "cpu"


def test_write_back_carries_batchnorm_stats_and_frozen_params():
    """The dp = 1 twin of the JAX package's BatchNorm trainer test: one
    SGD step on Dense(4 -> 8) + BatchNorm + Dense(8 -> 2) with the first
    layer's bias frozen, same weights and batch in both packages.  The
    trainer's running statistics move and equal the JAX trainer's (its
    running_var keeps the biased batch variance, torch's the unbiased
    one: n / (n - 1) apart), ``write_back`` hands them to the block, and
    the frozen bias comes back untouched."""
    from mxnet_tpu.gluon import nn as jnn
    rs = np.random.RandomState(21)
    x = (rs.rand(8, 4) + 3.0).astype(np.float32)     # nonzero-mean input
    y = rs.rand(8, 2).astype(np.float32)
    n = x.shape[0]
    opt = dict(optimizer="sgd", optimizer_params={"learning_rate": 0.1})

    mx.random.seed(0)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(8, in_units=4))
    jnet.add(jnn.BatchNorm(in_channels=8))
    jnet.add(jnn.Dense(2, in_units=8))
    jnet.initialize()
    tnet = torch.nn.Sequential(torch.nn.Linear(4, 8),
                               torch.nn.BatchNorm1d(8),
                               torch.nn.Linear(8, 2))
    pairs = [(tnet[0].weight, jnet[0].weight), (tnet[0].bias, jnet[0].bias),
             (tnet[1].weight, jnet[1].gamma), (tnet[1].bias, jnet[1].beta),
             (tnet[1].running_mean, jnet[1].running_mean),
             (tnet[1].running_var, jnet[1].running_var),
             (tnet[2].weight, jnet[2].weight), (tnet[2].bias, jnet[2].bias)]
    with torch.no_grad():
        for t, p in pairs:
            t.copy_(torch.from_numpy(p.data().asnumpy().copy()))
    jnet[0].bias.grad_req = "null"
    jtr = jpar.ShardedTrainer(
        jnet, lambda o, t: ((o - t) ** 2).mean(),
        jpar.make_mesh(dp=1, tp=1, sp=1, devices=jax.devices()[:1]),
        example_inputs=(nd.array(x),), n_labels=1, **opt)
    jtr.step(nd.array(x), nd.array(y))

    def jget(param):
        return np.asarray(jax.device_get(jtr.params[param.name]))

    tnet[0].bias.requires_grad_(False)
    bias0 = tnet[0].bias.detach().clone()
    ttr = tpar.ShardedTrainer(tnet, lambda o, t: ((o - t) ** 2).mean(),
                              tpar.make_mesh(dp=1, device="cpu"),
                              example_inputs=(x,), n_labels=1, **opt)
    ttr.step(x, y)

    mean = ttr.buffers["1.running_mean"].numpy()
    var = ttr.buffers["1.running_var"].numpy()
    assert np.abs(mean).max() > 1e-2, "running_mean did not move"
    np.testing.assert_allclose(mean, jget(jnet[1].running_mean), atol=1e-5)
    # running = 0.9 * 1 + 0.1 * batch variance in both packages
    np.testing.assert_allclose(var - 0.9,
                               (jget(jnet[1].running_var) - 0.9) * n
                               / (n - 1),
                               atol=1e-5)
    assert not torch.equal(tnet[1].running_mean,
                           ttr.buffers["1.running_mean"])
    ttr.write_back()
    for name, b in tnet.named_buffers():
        assert torch.equal(b, ttr.buffers[name]), name
    assert int(tnet[1].num_batches_tracked) == 1
    assert torch.equal(tnet[0].bias.detach(), bias0)
    np.testing.assert_array_equal(jget(jnet[0].bias), bias0.numpy())
    np.testing.assert_allclose(tnet[2].weight.detach().numpy(),
                               jget(jnet[2].weight), atol=1e-5)
