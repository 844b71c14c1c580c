"""PyTorch port, tensor and data parallelism: ``make_mesh`` over a
process group, ``MEGATRON_RULES`` and ``partition_params``, the
Megatron layers of the port's BERT on a rank's local heads, and
``ShardedTrainer(compression=...)``, held against the JAX package on
its virtual devices.

One four-rank gloo CPU job (``test_torch_dist.run_job``) runs every
multi-rank case; the JAX side runs in the test process:

- ``make_mesh`` shapes, coordinates and errors (the twin of
  ``test_parallel.py::test_make_mesh``);
- dp 2 x tp 2 ``BERTClassifier`` (the reference's
  ``test_sharded_trainer_bert_converges``, flash attention on the
  port's side) against the JAX ``make_mesh(dp=2, tp=2)`` trainer: six
  steps' losses and the gathered parameters within atol 1e-4;
- ``BERTForPretrain`` under rules that also split the word embedding
  on units and the MLM decoder on the vocabulary (the port gathers
  both), three steps against the JAX trainer under the same rules;
- ``TestShardedTrainerCompression`` (all four) and
  ``TestConvergenceParity`` of ``test_quantize.py`` on dp = 4 (JAX on
  four of its devices), with the reference's tolerances; and the
  port's int8 losses against the JAX int8 run with round-to-nearest:
  within 2e-4 relative (see ``test_compressed_losses_match_jax``).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon, nd
from mxnet_tpu import models as jm
from mxnet_tpu import parallel as jpar
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.flash_attention import _split_qkv

from test_torch_dist import (CLASSIFIER, _cls_batch, jax_classifier,
                             jax_losses, run_job)


# --------------------------------------------------------- in-process
def test_sharding_rules():
    rules = tpar.MEGATRON_RULES
    assert rules.spec_for("enc_qkv_weight") == tpar.P("tp", None)
    assert rules.spec_for("enc_ffn_2_weight") == tpar.P(None, "tp")
    assert rules.spec_for("bn_gamma") == tpar.P()
    # the same table as the JAX package's, rule for rule
    jr = jpar.MEGATRON_RULES
    for name in ("a_qkv_weight", "a_qkv_bias", "a_q_proj_weight",
                 "a_kv_proj_bias", "a_out_proj_weight", "x_ffn_1_weight",
                 "x_ffn_1_bias", "x_ffn_2_weight", "word_embed_weight",
                 "mlm_decoder_weight", "mlm_decoder_bias", "m_expert_w1",
                 "m_expert_b2", "bertmodel0_embedding0_weight",
                 "bertforpretrain0_dense1_weight", "pooler_bias"):
        assert tuple(rules.spec_for(name)) == tuple(jr.spec_for(name)), name


class _FakeMesh:
    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords


def test_safe_spec_degrades_like_jax():
    """Axes the mesh lacks and dims an axis does not divide stay
    replicated, as ``_safe_spec`` does in the JAX package."""
    mesh = _FakeMesh({"dp": 2, "tp": 4, "sp": 1, "ep": 1}, None)
    jmesh = jpar.make_mesh(dp=2, tp=4, sp=1)
    rules = tpar.MEGATRON_RULES
    for name, shape in (("q_qkv_weight", (12, 4)), ("q_qkv_weight", (6, 4)),
                        ("f_ffn_2_weight", (4, 6)), ("m_expert_w1",
                                                     (4, 8, 8)),
                        ("norm_gamma", (8,))):
        got = rules.safe_spec(mesh, name, shape)
        want = jpar.MEGATRON_RULES._safe_spec(jmesh, name, shape)
        assert tuple(got) == tuple(want), (name, shape)


@pytest.mark.parametrize("tp", [2, 4])
def test_qkv_split_gives_each_rank_whole_heads(tp):
    """``partition_params`` under ``MEGATRON_RULES`` splits the
    interleaved ``[q|k|v]`` rows of ``qkv_weight`` (``P("tp", None)``)
    so that rank r holds heads ``r * H / tp ... (r + 1) * H / tp - 1``,
    each whole."""
    H, D, C, L, B = 8, 4, 32, 3, 2
    rs = np.random.RandomState(0)
    w = rs.randn(3 * C, C).astype(np.float32)
    x = torch.from_numpy(rs.randn(L, B, C).astype(np.float32))
    full = _split_qkv(x @ torch.from_numpy(w).T, H)      # (B*H, L, D) each
    for r in range(tp):
        mesh = _FakeMesh({"dp": 1, "tp": tp}, {"dp": 0, "tp": r})
        shards, placements = tpar.partition_params(
            {"attn_qkv_weight": w}, mesh)
        assert placements["attn_qkv_weight"] == tpar.P("tp", None)
        local = shards["attn_qkv_weight"]
        got = _split_qkv(x @ local.T, H // tp)
        hl = H // tp
        for want, part in zip(full, got):
            want = want.reshape(B, H, L, D)[:, r * hl:(r + 1) * hl]
            torch.testing.assert_close(part.reshape(B, hl, L, D), want)


def test_compression_refused_on_dp_by_tp_mesh_without_ranks():
    """The refusal needs no ranks: a mesh descriptor of dp 2 x tp 2
    (its groups are never used before the check)."""
    mesh = tpar.Mesh("cpu", {"dp": 2, "tp": 2, "sp": 1, "ep": 1})
    net = torch.nn.Linear(8, 1)
    with pytest.raises(MXNetError, match="pure data-parallel"):
        tpar.ShardedTrainer(net, lambda o, t: ((o - t) ** 2).mean(), mesh,
                            example_inputs=(np.zeros((8, 8), np.float32),),
                            compression="int8")


# --------------------------------------------------------- the job
KW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
          num_heads=4, max_length=32, dropout=0.0)
PB, PL, PM = 4, 24, 5
SPLIT_RULES = [(r"embedding0_weight$", ("None", "tp")),
               (r"bertforpretrain\d*_?dense1_weight$|^dense1_weight$",
                ("tp", "None")),
               (r"bertforpretrain\d*_?dense1_bias$|^dense1_bias$", ("tp",))]


def _pretrain_batch():
    rs = np.random.RandomState(3)
    valid = np.asarray([24, 13, 20, 24], np.float32)
    return (rs.randint(0, 64, (PB, PL)).astype(np.int32),
            (np.arange(PL)[None] >= 10).astype(np.int32).repeat(PB, 0),
            valid,
            np.stack([rs.choice(int(v), PM, replace=False)
                      for v in valid]).astype(np.int32),
            rs.randint(0, 64, (PB, PM)).astype(np.int32),
            rs.randint(0, 2, (PB,)).astype(np.int32))


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).uniform(-1, 1, shape)
            * scale).astype("float32")


def _jax_mlp():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(1))
    net.initialize(mx.init.Xavier())
    return net


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _jax_pretrain_loss(outputs, mlm_y, nsp_y):
    mlm_scores, nsp_scores = outputs
    mlm_lp = jax.nn.log_softmax(mlm_scores.astype(jnp.float32), -1)
    nsp_lp = jax.nn.log_softmax(nsp_scores.astype(jnp.float32), -1)
    return (-jnp.take_along_axis(mlm_lp, mlm_y[..., None], -1).mean()
            - jnp.take_along_axis(nsp_lp, nsp_y[:, None], -1).mean())


def _jax_pretrain():
    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", **KW)
    jbert.initialize()
    jhead = jm.BERTForPretrain(jbert, vocab_size=64)
    jhead.initialize()
    pre = jhead.prefix
    params = {(k[len(pre):] if k.startswith(pre) else k):
              v.data().asnumpy() for k, v in jhead.collect_params().items()}
    return jhead, params


def _jax_mlp_run(compression, X, Y, steps, devices=4, seed=0):
    """The JAX package's compressed/uncompressed MLP run on ``devices``
    of its virtual devices, and the initial parameters it drew."""
    mesh = jpar.make_mesh(dp=devices, devices=jax.devices()[:devices])
    xs, ys = nd.array(X), nd.array(Y)
    mx.random.seed(seed)
    tr = jpar.ShardedTrainer(_jax_mlp(), _mse, mesh, optimizer="adamw",
                             optimizer_params={"learning_rate": 1e-2},
                             example_inputs=(xs,), n_labels=1,
                             compression=compression)
    names = sorted(tr.params)           # dense0 weight/bias, dense1 ...
    init = [np.asarray(jax.device_get(tr.params[n])) for n in names]
    losses = [float(jax.device_get(tr.step(xs, ys))) for _ in range(steps)]
    return losses, init, tr


WORKER = '''
from mxnet_tpu_torch import runtime_metrics as rm
from mxnet_tpu_torch.parallel import P, ShardingRules
from mxnet_tpu_torch.base import MXNetError

# -- make_mesh over the group
m = tpar.make_mesh(dp=2, tp=2, device="cpu")
assert m.shape == {"dp": 2, "tp": 2, "sp": 1, "ep": 1}, m.shape
assert m.coords["dp"] == RANK // 2 and m.coords["tp"] == RANK % 2, m.coords
assert tpar.make_mesh(tp=2, device="cpu").shape["dp"] == 2
assert tpar.make_mesh(device="cpu").shape["dp"] == 4
errs = []
for kw in (dict(dp=3, tp=3, sp=1), dict(tp=3), dict(dp=1, tp=2)):
    try:
        tpar.make_mesh(device="cpu", **kw)
    except MXNetError as e:
        errs.append(str(e))
OUT["mesh_errors"] = np.array(errs)

# -- dp 2 x tp 2 BERTClassifier
opt = dict(optimizer="adamw", optimizer_params={"learning_rate": 1e-3})
head = classifier(use_flash=True)
tr = tpar.ShardedTrainer(head, cls_loss, m, example_inputs=BATCH[:3],
                         n_labels=1, **opt)
qkv = [n for n in tr.placements if n.endswith("qkv.weight")][0]
assert tuple(tr.placements[qkv]) == ("tp", None)
assert tr.params[qkv].shape[0] == 3 * 64 // 2
OUT["cls_losses"] = np.array([float(tr.step(*BATCH)) for _ in range(6)])
OUT.update(gluon_params(head, tr.gathered_params()))

# -- BERTForPretrain with the embedding and the decoder split
pkw = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
           num_heads=4, max_length=32, dropout=0.0)
pre = {k[4:]: v for k, v in IN.items() if k.startswith("pre:")}
phead = tm.BERTForPretrain(tm.get_bert_model(
    "bert_12_768_12", use_flash=True, device="cpu", **pkw),
    vocab_size=64).load_numpy_params(pre)
rules = ShardingRules(
    [(pat, P(*[None if a == "None" else a for a in spec]))
     for pat, spec in SPLIT_RULES]
    + [(p.pattern, s) for p, s in tpar.MEGATRON_RULES._rules],
    default=P())
ptr = tpar.ShardedTrainer(phead, tm.pretrain_loss, m, rules=rules,
                          example_inputs=tuple(IN["pb%d" % i]
                                               for i in range(4)),
                          n_labels=2, **opt)
split = sorted(n for n, s in ptr.placements.items() if any(s))
OUT["pre_split"] = np.array(split)
pbatch = tuple(IN["pb%d" % i] for i in range(6))
OUT["pre_losses"] = np.array([float(ptr.step(*pbatch)) for _ in range(3)])

# -- dp 2 x ep 2: a Gluon MoE layer whose experts split over ep
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.contrib import MoEFFN

class Net(tmx.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.moe = MoEFFN(units=8, hidden_size=16, num_experts=4,
                              capacity_factor=MOE_CF)

    def hybrid_forward(self, F, x):
        out, aux = self.moe(x)
        return out + x, aux

with tmx.cpu(0):
    mnet = Net()
    mnet.initialize()
    mnet.collect_params().load_dict(
        {k[3:]: v for k, v in IN.items() if k.startswith("ep:")})

def moe_loss(outputs, y):
    out, aux = outputs
    return ((out - y) ** 2).mean() + 0.01 * aux.float()

for dp, tp in MOE_MESHES:
    mep = tpar.make_mesh(dp=dp, tp=tp, ep=2, device="cpu")
    assert mep.coords["ep"] == RANK % 2
    etr = tpar.ShardedTrainer(mnet, moe_loss, mep,
                              example_inputs=(IN["ep_x"],), n_labels=1, **opt)
    w1 = next(n for n in etr.params if n.endswith("expert_w1"))
    key = "ep%d%d" % (dp, tp)
    OUT[key + "_w1_spec"] = np.array([str(a) for a in etr.placements[w1]])
    OUT[key + "_w1_local"] = np.array(etr.params[w1].shape)
    OUT[key + "_losses"] = np.array(
        [float(etr.step(IN["ep_x"], IN["ep_y"])) for _ in range(3)])
    OUT.update({key + ":" + n: t.numpy() for n, t in
                etr.gathered_params().items()})

# -- compression (dp = 4)
mesh4 = tpar.make_mesh(dp=4, device="cpu")
try:
    tpar.ShardedTrainer(torch.nn.Linear(8, 1), mse, m,
                        example_inputs=(IN["mlp_x"],), compression="int8")
except MXNetError as e:
    OUT["pure_dp_error"] = np.array(str(e))

def mlp(prefix):
    net = torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 1))
    with torch.no_grad():
        for p, k in zip((net[0].weight, net[0].bias, net[2].weight,
                         net[2].bias), ("w0", "b0", "w1", "b1")):
            p.copy_(torch.from_numpy(IN[prefix + k]))
    return net

def mlp_run(prefix, x, y, compression, steps):
    tr = tpar.ShardedTrainer(mlp(prefix), mse, mesh4, optimizer="adamw",
                             optimizer_params={"learning_rate": 1e-2},
                             example_inputs=(x,), n_labels=1,
                             compression=compression)
    return [float(tr.step(x, y)) for _ in range(steps)], tr

OUT["f32"], _ = mlp_run("m", IN["mlp_x"], IN["mlp_y"], None, 8)
OUT["int8"], tr8 = mlp_run("m", IN["mlp_x"], IN["mlp_y"], "int8", 8)
OUT["fp8"], _ = mlp_run("m", IN["mlp_x"], IN["mlp_y"], "fp8", 8)
OUT["wire"] = np.array([tr8.wire_bytes_per_step, tr8.logical_bytes_per_step,
                        len(tr8.residuals)])
OUT["extra"] = np.array(tr8.extra_state()["quant_step"])
OUT["sr"], _ = mlp_run("s", IN["sr_x"], IN["sr_y"], "int8:stochastic=1", 6)
rm.enable()
rm.reset()
_, trw = mlp_run("m", IN["w_x"], IN["w_y"], "int8", 2)
OUT["wire_counter"] = np.array([rm.KV_WIRE_BYTES.value(),
                                trw.wire_bytes_per_step])
rm.disable()
rm.reset()

# -- convergence parity: BERT-tiny f32 vs int8 on dp = 4
ckw = dict(vocab_size=64, units=32, hidden_size=64, num_layers=1,
           num_heads=2, max_length=16, dropout=0.0)
cp = {k[3:]: v for k, v in IN.items() if k.startswith("cp:")}
def tiny(compression):
    h = tm.BERTClassifier(tm.get_bert_model("bert_12_768_12", device="cpu",
                                            **ckw),
                          num_classes=2, dropout=0.0, device="cpu")
    h.load_numpy_params(cp)
    tr = tpar.ShardedTrainer(h, cls_loss, mesh4, optimizer="adamw",
                             optimizer_params={"learning_rate": 5e-3},
                             example_inputs=tuple(IN["cb%d" % i]
                                                  for i in range(3)),
                             n_labels=1, compression=compression)
    cb = tuple(IN["cb%d" % i] for i in range(4))
    return [float(tr.step(*cb)) for _ in range(6)]
OUT["cp_f32"] = np.array(tiny(None))
OUT["cp_int8"] = np.array(tiny("int8"))
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    _, cls_params = jax_classifier()
    _, pre_params = _jax_pretrain()
    batch = _cls_batch()
    inputs = {"np:" + k: v for k, v in cls_params.items()}
    inputs.update({"pre:" + k: v for k, v in pre_params.items()})
    inputs.update(inp=batch[0], tt=batch[1], vl=batch[2], lab=batch[3])
    inputs.update({"pb%d" % i: a for i, a in enumerate(_pretrain_batch())})
    X = _rand((16, 8), 7)
    inputs.update(mlp_x=X, mlp_y=(X @ _rand((8, 1), 8) + 0.1)
                  .astype("float32"))
    Xs = _rand((16, 8), 3)
    inputs.update(sr_x=Xs, sr_y=(Xs @ _rand((8, 1), 4)).astype("float32"))
    inputs.update(w_x=_rand((8, 8), 1), w_y=_rand((8, 1), 2))
    # the JAX runs' initial MLP weights, for the port's MLPs
    _, init, _ = _jax_mlp_run(None, X, inputs["mlp_y"], 0)
    _, sinit, _ = _jax_mlp_run(None, Xs, inputs["sr_y"], 0)
    for prefix, ws in (("m", init), ("s", sinit)):
        b0, w0, b1, w1 = ws             # sorted: bias before weight
        inputs.update({prefix + "w0": w0, prefix + "b0": b0,
                       prefix + "w1": w1, prefix + "b1": b1})
    cp_params, cbatch = _tiny_setup()
    inputs.update({"cp:" + k: v for k, v in cp_params.items()})
    inputs.update({"cb%d" % i: a for i, a in enumerate(cbatch)})
    moe, ep_x, ep_y = _jax_moe()
    inputs.update({"ep:" + k: v.data().asnumpy()
                   for k, v in moe.collect_params().items()})
    inputs.update(ep_x=ep_x, ep_y=ep_y)
    body = ("SPLIT_RULES = %r\nMOE_CF = %r\nMOE_MESHES = %r\n"
            % (SPLIT_RULES, MOE_CF, MOE_MESHES)
            + CLASSIFIER
            + "mse = lambda o, t: ((o - t) ** 2).mean()\n" + WORKER)
    outs = run_job(tmp, 4, body, inputs, timeout=400)
    return outs, inputs


# the MoE cases, (dp, tp) with ep 2: at capacity factor 1.0 the 48
# tokens' global routing drops 0 of the first dp rank's 24 tokens and 2
# of the second's, where routing each rank's tokens alone would drop 3
# and 4; at dp 1 x tp 2 each rank holds 2 experts' half hidden width
MOE_CF = 1.0
MOE_MESHES = ((2, 1), (1, 2))


def _jax_moe():
    """The JAX net of ``test_moe.py::test_expert_parallel_sharded_step``
    (seed 2) at ``MOE_CF``, and its batch."""
    from mxnet_tpu.gluon.contrib import MoEFFN as JMoEFFN

    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.moe = JMoEFFN(units=8, hidden_size=16, num_experts=4,
                                   capacity_factor=MOE_CF)

        def hybrid_forward(self, F, x):
            out, aux = self.moe(x)
            return out + x, aux

    mx.random.seed(2)
    net = Net()
    net.initialize(mx.init.Xavier())
    x = np.random.RandomState(4).randn(8, 6, 8).astype(np.float32)
    y = np.random.RandomState(5).randn(8, 6, 8).astype(np.float32)
    return net, x, y


def _drops(wg, x, tokens, capacity_factor, E=4):
    """Tokens past their expert's capacity in each half of ``x``'s
    tokens, routing ``tokens`` at a time (all of them: the global
    routing)."""
    xs = x.reshape(-1, x.shape[-1])
    onehot = np.eye(E)[(xs @ wg).argmax(1)]
    dropped = []
    for s in range(0, len(xs), tokens):
        part = onehot[s:s + tokens]
        pos = (np.cumsum(part, 0) * part).max(1) - 1
        dropped.append(pos >= max(1, int(capacity_factor * tokens / E)))
    dropped = np.concatenate(dropped)
    half = len(xs) // 2
    return int(dropped[:half].sum()), int(dropped[half:].sum())


def _tiny_setup():
    mx.random.seed(0)
    bert = jm.get_bert_model("bert_12_768_12", vocab_size=64, units=32,
                             hidden_size=64, num_layers=1, num_heads=2,
                             max_length=16, dropout=0.0)
    bert.initialize()
    head = jm.BERTClassifier(bert, num_classes=2, dropout=0.0)
    head.initialize()
    pre = head.prefix
    params = {(k[len(pre):] if k.startswith(pre) else k):
              v.data().asnumpy() for k, v in head.collect_params().items()}
    rng = np.random.RandomState(0)
    B, L, V = 8, 8, 64
    batch = (rng.randint(0, V, (B, L)).astype(np.int32),
             np.zeros((B, L), np.int32), np.full((B,), L, np.float32),
             rng.randint(0, 2, (B,)).astype(np.int32))
    return params, batch


def test_make_mesh(job):
    outs, _ = job
    errs = [str(e) for e in outs[0]["mesh_errors"]]
    assert len(errs) == 3
    assert "needs 9 devices, only 4 available" in errs[0]
    assert "4 devices not divisible by tp*sp*ep=3" in errs[1]
    assert "covers 2 of the group's 4 ranks" in errs[2]
    # the JAX package's messages for the first two
    with pytest.raises(JaxMXNetError, match="needs 9 devices"):
        jpar.make_mesh(dp=3, tp=3, sp=1)
    with pytest.raises(JaxMXNetError, match="not divisible by tp"):
        jpar.make_mesh(tp=3)


def test_make_mesh_refuses_without_a_group():
    with pytest.raises(MXNetError, match="initialize a process group"):
        tpar.make_mesh(dp=2, tp=2, device="cpu")


def test_sharded_trainer_bert_dp2_tp2_matches_jax(job):
    outs, inputs = job
    jhead, _ = jax_classifier()
    mesh = jpar.make_mesh(dp=2, tp=2, sp=1, devices=jax.devices()[:4])
    jl, jtr = jax_losses(jhead, mesh, _cls_batch(), 6)
    assert jl[-1] < jl[0]
    name = [n for n in jtr.params if n.endswith("qkv_weight")][0]
    assert jtr.params[name].sharding.spec[0] == "tp"
    want = {re.sub(r"^bertmodel\d+_", "bertmodel0_", k): np.asarray(v)
            for k, v in jtr.params.items()}
    pre = jhead.prefix
    for o in outs:
        np.testing.assert_allclose(o["cls_losses"], jl, atol=1e-4)
        got = {k[2:]: v for k, v in o.items() if k.startswith("p:")}
        assert len(got) == len(want)
        for g, v in got.items():
            key = g if g.startswith("bertmodel0_") else pre + g
            np.testing.assert_allclose(v, want[key], atol=1e-4, err_msg=g)


@pytest.mark.parametrize("dp,tp", MOE_MESHES)
def test_expert_parallel_sharded_step(job, dp, tp):
    """The twin of ``test_moe.py::test_expert_parallel_sharded_step``:
    dp 2 x ep 2 (each rank holding 2 of the 4 experts) and dp 1 x tp 2 x
    ep 2 (2 experts' half hidden width), three AdamW steps against the
    JAX trainer on the same mesh (one pjit program over the global
    batch): losses and gathered parameters within atol 1e-5.  At this
    capacity the global routing drops tokens unevenly across dp, and
    routing each dp shard alone would drop others."""
    outs, inputs = job
    jnet, x, y = _jax_moe()
    wg = next(v.data().asnumpy() for k, v in jnet.collect_params().items()
              if k.endswith("gate_weight"))
    assert _drops(wg, x, 48, MOE_CF) == (0, 2)
    assert _drops(wg, x, 24, MOE_CF) == (3, 4)
    mesh = jpar.make_mesh(dp=dp, tp=tp, sp=1, ep=2,
                          devices=jax.devices()[:4])
    assert mesh.shape["ep"] == 2

    def loss_fn(outputs, y):
        out, aux = outputs
        return ((out - y) ** 2).mean() + 0.01 * aux.astype(jnp.float32)

    jtr = jpar.ShardedTrainer(jnet, loss_fn, mesh, optimizer="adamw",
                              optimizer_params={"learning_rate": 1e-3},
                              example_inputs=(nd.array(x),), n_labels=1)
    jl = [float(jax.device_get(jtr.step(nd.array(x), nd.array(y))))
          for _ in range(3)]
    w1 = [n for n in jtr.params if n.endswith("expert_w1")]
    assert jtr.params[w1[0]].sharding.spec[0] == "ep"
    key = "ep%d%d" % (dp, tp)
    for o in outs:
        assert list(o[key + "_w1_spec"]) == ["ep", "None", "tp"]
        assert list(o[key + "_w1_local"]) == [2, 8, 16 // tp]
        np.testing.assert_allclose(o[key + "_losses"], jl, atol=1e-5)
        # the Gluon names up to the blocks' counters
        got = {re.sub(r"\d+_", "_", k[len(key) + 1:]): v
               for k, v in o.items() if k.startswith(key + ":")}
        want = {re.sub(r"\d+_", "_", n): np.asarray(v)
                for n, v in jtr.params.items()}
        assert set(got) == set(want) and len(want) == 5
        for n, v in want.items():
            np.testing.assert_allclose(got[n], v, atol=1e-5, err_msg=n)


def test_embedding_and_decoder_split_match_jax(job):
    """Rules that split the word embedding on units and the MLM decoder
    on the vocabulary: the port gathers the lookups before the embedding
    LayerNorm and the logits before the loss; the JAX package, given the
    same rules, lets GSPMD place them.  Three steps' losses agree."""
    outs, inputs = job
    split = list(outs[0]["pre_split"])
    assert any(n.endswith("word_embed.weight") for n in split), split
    assert any(n.endswith("mlm_decoder.weight") for n in split), split
    from jax.sharding import PartitionSpec as JP
    jhead, _ = _jax_pretrain()
    jrules = jpar.ShardingRules(
        [(pat, JP(*[None if a == "None" else a for a in spec]))
         for pat, spec in SPLIT_RULES]
        + [(p.pattern, s) for p, s in jpar.MEGATRON_RULES._rules])
    pb = _pretrain_batch()
    feats = tuple(nd.array(a, dtype=str(a.dtype)) for a in pb[:4])
    labels = tuple(nd.array(a, dtype=str(a.dtype)) for a in pb[4:])
    jtr = jpar.ShardedTrainer(
        jhead, _jax_pretrain_loss,
        jpar.make_mesh(dp=2, tp=2, sp=1, devices=jax.devices()[:4]),
        optimizer="adamw", optimizer_params={"learning_rate": 1e-3},
        rules=jrules, example_inputs=feats, n_labels=2)
    jl = [float(jax.device_get(jtr.step(*feats, *labels)))
          for _ in range(3)]
    for o in outs:
        np.testing.assert_allclose(o["pre_losses"], jl, atol=1e-4)


class TestShardedTrainerCompression:
    def test_requires_pure_dp_mesh(self, job):
        outs, _ = job
        for o in outs:
            assert "pure data-parallel" in str(o["pure_dp_error"])

    def test_compressed_step_matches_f32(self, job):
        outs, _ = job
        for o in outs:
            f32, int8 = list(o["f32"]), list(o["int8"])
            assert abs(f32[0] - int8[0]) < 1e-4
            assert abs(f32[-1] - int8[-1]) < 0.05 * abs(f32[0])
            assert int8[-1] < int8[0] * 0.5, "compressed run not learning"
            wire, logical, n_res = o["wire"]
            assert wire < logical
            assert n_res > 0
            assert int(o["extra"]) == 8
            assert o["fp8"][-1] < o["fp8"][0] * 0.5

    def test_stochastic_rounding_variant_learns(self, job):
        outs, _ = job
        for o in outs:
            assert o["sr"][-1] < o["sr"][0]

    def test_wire_counter_increments(self, job):
        outs, _ = job
        for o in outs:
            counted, per_step = o["wire_counter"]
            assert counted == 2 * per_step > 0

    def test_compressed_losses_match_jax(self, job):
        """The port's int8 and fp8 runs against the JAX package's on four
        devices, round to nearest, the same initial weights and data.
        Both packages quantize the same per-device gradients; where a
        gradient lands within float32 rounding of a rounding midpoint
        the two can round it one quantum (amax / 127 of its block)
        apart, and error feedback returns that quantum the next step.
        The float32 run differs from JAX's by summation order alone
        (atol 1e-5); the compressed ones stay within 2e-4 relative."""
        outs, inputs = job
        X, Y = inputs["mlp_x"], inputs["mlp_y"]
        jf32, _, _ = _jax_mlp_run(None, X, Y, 8)
        jint8, _, jtr = _jax_mlp_run("int8", X, Y, 8)
        jfp8, _, _ = _jax_mlp_run("fp8", X, Y, 8)
        o = outs[0]
        np.testing.assert_allclose(o["f32"], jf32, atol=1e-5)
        np.testing.assert_allclose(o["int8"], jint8, rtol=2e-4)
        np.testing.assert_allclose(o["fp8"], jfp8, rtol=2e-4)
        assert list(o["wire"][:2]) == [jtr.wire_bytes_per_step,
                                       jtr.logical_bytes_per_step]


class TestConvergenceParity:
    def test_bert_tiny_int8_matches_f32(self, job):
        outs, _ = job
        for o in outs:
            f32, int8 = list(o["cp_f32"]), list(o["cp_int8"])
            assert np.isfinite(int8).all()
            assert abs(f32[0] - int8[0]) < 1e-4, (f32[0], int8[0])
            tol = max(0.03 * abs(f32[-1]), 0.03)
            assert abs(f32[-1] - int8[-1]) < tol, (f32, int8)
            assert int8[-1] < int8[0], "int8 run did not descend"
