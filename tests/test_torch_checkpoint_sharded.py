"""PyTorch port, sharded checkpoints: ``CheckpointManager`` over a
four-rank dp 2 x tp 2 trainer (``mxnet_tpu_torch/parallel/
checkpoint.py``), every rank writing its own shard.

Twins of ``tests/test_checkpoint_sharded.py`` (all four: round trip and
resume, restored arrays keep their placements, rolling retention, a
missing checkpoint raises) on one gloo CPU job
(``test_torch_dist.run_job``), the reference's MLP drawn by the JAX
package (its losses and the port's agree within 1e-5).  New here: a
tiny BERT whose attention and FFN weights are really split over tp is
saved after two steps and restored into fresh trainers, whose third
step equals the uninterrupted one bit for bit with every tensor at its
old address; and a shard damaged on one rank makes every rank fall back
to the previous verified step together.
"""
import numpy as np
import pytest

import jax

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import nn as jnn

from test_torch_dist import CLASSIFIER, _cls_batch, jax_classifier, run_job


def _jax_setup(seed):
    mx.random.seed(seed)
    net = jnn.HybridSequential(prefix="ck_net_")
    with net.name_scope():
        net.add(jnn.Dense(16, activation="relu", in_units=8, prefix="fc1_"),
                jnn.Dense(4, in_units=16, prefix="fc2_"))
    net.initialize(mx.init.Xavier())
    mesh = jpar.make_mesh(dp=2, tp=2, sp=1, devices=jax.devices()[:4])
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    tr = jpar.ShardedTrainer(
        net, lambda o, t: ((o - t) ** 2).mean(), mesh, optimizer="adamw",
        optimizer_params={"learning_rate": 1e-2},
        example_inputs=(nd.array(x),), n_labels=1)
    return tr, x, y


WORKER = '''
from mxnet_tpu_torch.base import MXNetError

mesh = tpar.make_mesh(dp=2, tp=2, device="cpu")
ROOT = os.path.join(DIR, "ck")

def setup(seed):
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p, k in zip((net[0].weight, net[0].bias, net[2].weight,
                         net[2].bias), ("w1", "b1", "w2", "b2")):
            p.copy_(torch.from_numpy(IN["s%d_%s" % (seed, k)]))
    tr = tpar.ShardedTrainer(
        net, lambda o, t: ((o - t) ** 2).mean(), mesh, optimizer="adamw",
        optimizer_params={"learning_rate": 1e-2},
        example_inputs=(IN["s%d_x" % seed],), n_labels=1)
    return tr, IN["s%d_x" % seed], IN["s%d_y" % seed]

# -- round trip and resume
tr, x, y = setup(0)
losses = [float(tr.step(x, y)) for _ in range(3)]
with tpar.CheckpointManager(os.path.join(ROOT, "c1"),
                            async_write=False) as mngr:
    mngr.save(3, tr)
ref = [float(tr.step(x, y)) for _ in range(3)]
tr2, x2, y2 = setup(0)
OUT["rt_step"] = np.array(tpar.load_checkpoint(os.path.join(ROOT, "c1"), tr2))
OUT["rt_losses"], OUT["rt_ref"] = np.array(losses + ref), np.array(
    [float(tr2.step(x2, y2)) for _ in range(3)])
OUT["rt_files"] = np.array(sorted(os.listdir(os.path.join(ROOT, "c1",
                                                          "step_3"))))

# -- placements kept
tr, x, y = setup(1)
tr.step(x, y)
tpar.save_checkpoint(os.path.join(ROOT, "c2"), tr, step=1)
tr2, _, _ = setup(1)
tpar.load_checkpoint(os.path.join(ROOT, "c2"), tr2)
OUT["placements_equal"] = np.array(tr2.placements == tr.placements)
OUT["values_equal"] = np.array(all(torch.equal(tr.params[n], tr2.params[n])
                                   for n in tr.params))

# -- rolling retention
tr, x, y = setup(2)
with tpar.CheckpointManager(os.path.join(ROOT, "c3"), max_to_keep=2,
                            async_write=False) as mngr:
    for s in (1, 2, 3, 4):
        tr.step(x, y)
        mngr.save(s, tr)
    mngr.wait()
    OUT["latest"] = np.array(mngr.latest_step())
    OUT["all_steps"] = np.array(mngr.all_steps())

# -- missing
tr, _, _ = setup(3)
try:
    tpar.load_checkpoint(os.path.join(ROOT, "nope"), tr)
except MXNetError as e:
    OUT["missing"] = np.array(str(e))

# -- a BERT split over tp: save after 2 steps, replay step 3 bit for bit
def bert_trainer():
    return tpar.ShardedTrainer(classifier(use_flash=True), cls_loss, mesh,
                               optimizer="adamw",
                               optimizer_params={"learning_rate": 1e-3},
                               example_inputs=BATCH[:3], n_labels=1)

tb = bert_trainer()
split = [n for n, s in tb.placements.items() if any(s)]
for _ in range(2):
    tb.step(*BATCH)
mngr = tpar.CheckpointManager(os.path.join(ROOT, "c4"))
mngr.save(2, tb, extra={"who": "bert"})
mngr.wait()
want = float(tb.step(*BATCH))
want_params = {n: p.detach().clone() for n, p in tb.params.items()}
fresh = bert_trainer()
ptrs = {n: p.data_ptr() for n, p in fresh.params.items()}
OUT["bert_step"] = np.array(mngr.restore(fresh))
OUT["bert_extra"] = np.array(mngr.load_extra(2)["who"])
got = float(fresh.step(*BATCH))
OUT["bert_bitwise"] = np.array(
    got == want and all(torch.equal(fresh.params[n], want_params[n])
                        for n in want_params))
OUT["bert_ptrs"] = np.array(all(fresh.params[n].data_ptr() == ptrs[n]
                                for n in ptrs))
OUT["bert_split"] = np.array(len(split))
OUT["bert_timings"] = np.array([mngr.timings.get("barrier_s", -1.0),
                                mngr.timings.get("copy_s", -1.0)])

# -- a shard damaged on rank 2: every rank falls back together
mngr.save(3, tb)
mngr.wait()
dist.barrier()
if RANK == 2:
    path = os.path.join(ROOT, "c4", "step_3", "shard-2-of-4.pt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
dist.barrier()
fresh2 = bert_trainer()
OUT["fallback_step"] = np.array(mngr.restore(fresh2))
try:
    mngr.restore(fresh2, step=3)
except MXNetError as e:
    OUT["explicit_damaged"] = np.array(str(e))
mngr.close()
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = {}
    for seed in range(4):
        tr, x, y = _jax_setup(seed)
        names = sorted(tr.params)   # fc1 bias, fc1 weight, fc2 bias, ...
        b1, w1, b2, w2 = (np.asarray(jax.device_get(tr.params[n]))
                          for n in names)
        inputs.update({"s%d_w1" % seed: w1, "s%d_b1" % seed: b1,
                       "s%d_w2" % seed: w2, "s%d_b2" % seed: b2,
                       "s%d_x" % seed: x, "s%d_y" % seed: y})
    _, np_params = jax_classifier()
    batch = _cls_batch()
    inputs.update({"np:" + k: v for k, v in np_params.items()})
    inputs.update(inp=batch[0], tt=batch[1], vl=batch[2], lab=batch[3])
    outs = run_job(tmp_path_factory.mktemp("cks"), 4, CLASSIFIER + WORKER,
                   inputs, timeout=400)
    return outs


def test_roundtrip_and_resume(job):
    tr, x, y = _jax_setup(0)
    jl = [float(jax.device_get(tr.step(nd.array(x), nd.array(y))))
          for _ in range(6)]
    for o in job:
        assert int(o["rt_step"]) == 3
        losses, got = list(o["rt_losses"]), list(o["rt_ref"])
        np.testing.assert_allclose(got, losses[3:], rtol=1e-5)
        assert losses[0] > got[-1]            # training progressed
        np.testing.assert_allclose(losses, jl, atol=1e-5)
        assert list(o["rt_files"]) == [f"shard-{r}-of-4.pt"
                                       for r in range(4)]


def test_restored_arrays_keep_shardings(job):
    for o in job:
        assert bool(o["placements_equal"]) and bool(o["values_equal"])


def test_rolling_retention(job):
    for o in job:
        assert int(o["latest"]) == 4
        assert list(o["all_steps"]) == [3, 4]


def test_restore_missing_raises(job):
    for o in job:
        assert "no checkpoint found" in str(o["missing"])


def test_tp_split_trainer_resumes_bit_for_bit(job):
    for o in job:
        assert int(o["bert_split"]) > 0
        assert int(o["bert_step"]) == 2 and str(o["bert_extra"]) == "bert"
        assert bool(o["bert_bitwise"]) and bool(o["bert_ptrs"])
        assert (o["bert_timings"] >= 0).all()


def test_shard_damaged_on_one_rank_falls_back_on_every_rank(job):
    for o in job:
        assert int(o["fallback_step"]) == 2
        assert "is damaged" in str(o["explicit_damaged"])
        assert "(2, " in str(o["explicit_damaged"])
