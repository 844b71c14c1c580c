"""PyTorch port, the training step's compile tier: ``ShardedTrainer``'s
per-signature step programs (``graphs=True``, the default), the AdamW /
LAMB step count on the device, and ``compile_cache.enable_persistent_cache``.

On the CPU a graphs-mode trainer stages every batch into its program's
static buffers and runs the step on them (no graph): the data path that a
CUDA graph replays over on the card.  Here it is held:

- bit for bit against ``graphs=False`` over three AdamW steps (losses and
  every parameter), and within atol 1e-4 of the JAX ``ShardedTrainer``
  (the tolerance of ``test_sharded_trainer_matches_jax_three_adamw_steps``);
- losses that later steps leave untouched; parameters, buffers and
  optimizer state (the step tensor included) at fixed addresses, which a
  graph replays; ``write_back`` after graph-mode steps;
- one program per batch signature, at most ``program_bound``;
- the ``train.step`` chaos hook in both modes.

The optimizers' step count is a 0-d int32 tensor equal to JAX's, and the
bias corrections are fp32 device tensors, over five steps against
``mxnet_tpu.parallel.optim``.  Every test runs on the CPU (the JAX
package is the reference and the card's machine has no JAX); the card's
checks of the graphs are ``chip_smoke.py``'s ``train_graphs`` phase.
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
from mxnet_tpu_torch import compile_cache as cc
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.models import torch_bert as tm
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.faults import InjectedFault
from mxnet_tpu_torch.parallel import optim as topt

# the narrow BERT of tests/test_torch_parallel.py
KW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
          num_heads=4, max_length=32, dropout=0.0)
B, L, M = 2, 24, 5
OPT = dict(optimizer="adamw", optimizer_params={"learning_rate": 1e-3})


def _batch(seed=3, L=L):
    rs = np.random.RandomState(seed)
    valid = np.asarray([L, L // 2 + 1], np.float32)
    return (rs.randint(0, 64, (B, L)).astype(np.int32),
            (np.arange(L)[None] >= L // 2).astype(np.int32).repeat(B, 0),
            valid,
            np.stack([rs.choice(int(v), M, replace=False)
                      for v in valid]).astype(np.int32),
            rs.randint(0, 64, (B, M)).astype(np.int32),
            rs.randint(0, 2, (B,)).astype(np.int32))


def _head(seed=0):
    return tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", use_flash=True, device="cpu",
        generator=torch.Generator().manual_seed(seed), **KW), vocab_size=64)


def _trainer(head, graphs=True, **kw):
    return tpar.ShardedTrainer(head, tm.pretrain_loss,
                               tpar.make_mesh(device="cpu"),
                               example_inputs=_batch()[:4], n_labels=2,
                               graphs=graphs, **{**OPT, **kw})


def test_graph_steps_equal_eager_steps_bit_for_bit():
    """The static-buffer path runs the same step on the same values as
    ``graphs=False``: three AdamW steps on two batches give the same
    losses and parameters bit for bit."""
    graphs, eager = _trainer(_head()), _trainer(_head(), graphs=False)
    assert graphs.graphs and not eager.graphs
    batches = [_batch(3), _batch(4), _batch(3)]
    for b in batches:
        lg, le = graphs.step(*b), eager.step(*b)
        assert torch.equal(lg, le), (float(lg), float(le))
    for n, p in eager.params.items():
        assert torch.equal(graphs.params[n], p), n
    for tree in ("mean", "var"):
        for n, t in eager.opt_state[tree].items():
            assert torch.equal(graphs.opt_state[tree][n], t), (tree, n)
    assert int(graphs.opt_state["step"]) == int(eager.opt_state["step"]) == 3
    assert graphs.compiled == 1 and eager.compiled == 0


def _jax_loss(outputs, mlm_y, nsp_y):
    mlm_scores, nsp_scores = outputs
    mlm_lp = jax.nn.log_softmax(mlm_scores.astype(jnp.float32), -1)
    nsp_lp = jax.nn.log_softmax(nsp_scores.astype(jnp.float32), -1)
    return (-jnp.take_along_axis(mlm_lp, mlm_y[..., None], -1).mean()
            - jnp.take_along_axis(nsp_lp, nsp_y[:, None], -1).mean())


def test_graph_steps_match_jax_three_adamw_steps():
    """The graphs-mode trainer against the JAX ``ShardedTrainer`` (one
    jitted step, Pallas kernels in interpreter mode on a one-device CPU
    mesh) from the same weights on the same batch: losses per step and
    parameters after three steps within atol 1e-4."""
    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", use_flash=True, **KW)
    jbert.initialize()
    jhead = jm.BERTForPretrain(jbert, vocab_size=64)
    jhead.initialize()
    pre = jhead.prefix
    np_params = {(k[len(pre):] if k.startswith(pre) else k):
                 v.data().asnumpy() for k, v in jhead.collect_params().items()}
    thead = _head().load_numpy_params(np_params)
    batch = _batch()
    feats = tuple(nd.array(a, dtype=str(a.dtype)) for a in batch[:4])
    labels = tuple(nd.array(a, dtype=str(a.dtype)) for a in batch[4:])
    jtr = jpar.ShardedTrainer(
        jhead, _jax_loss,
        jpar.make_mesh(dp=1, tp=1, sp=1, devices=jax.devices()[:1]),
        example_inputs=feats, n_labels=2, **OPT)
    ttr = _trainer(thead)
    for _ in range(3):
        lj = float(jax.device_get(jtr.step(*feats, *labels)))
        np.testing.assert_allclose(float(ttr.step(*batch)), lj, atol=1e-4)
    assert len(ttr._programs) == 1
    port_name = {id(p): n for n, p in thead.named_parameters()}
    want = {re.sub(r"^bertmodel\d+_", "bertmodel0_", k): np.asarray(v)
            for k, v in jtr.params.items()}
    gluon = thead.gluon_names()
    assert len(gluon) == len(ttr.params) == len(want)
    for gname, p in gluon.items():
        key = gname if gname.startswith("bertmodel0_") else pre + gname
        got = ttr.params[port_name[id(p)]].detach().numpy()
        np.testing.assert_allclose(got, want[key], atol=1e-4, err_msg=key)
    assert int(ttr.opt_state["step"]) == int(jtr.opt_state["step"]) == 3


SHAPES = {"w": (7, 5), "b": (5,), "g": (3, 2, 4)}


def _dicts(seed):
    rs = np.random.RandomState(seed)
    return {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_step_count_is_a_device_tensor(name):
    """Five AdamW / LAMB updates against the JAX optimizers: the state's
    ``step`` is one 0-d int32 tensor on the parameters' device, advanced
    in place and equal to JAX's int32 step after every update; the bias
    corrections are fp32 0-d tensors equal to JAX's
    ``1 - beta ** step.astype(float32)``; the parameters agree within
    atol 1e-6."""
    init_j = getattr(jopt, f"{name}_init")
    upd_j = getattr(jopt, f"{name}_update")
    init_t = getattr(topt, f"{name}_init")
    upd_t = getattr(topt, f"{name}_update")
    p0 = _dicts(0)
    pj = {n: jnp.asarray(a) for n, a in p0.items()}
    pt = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    sj, st = init_j(pj), init_t(pt)
    step = st["step"]
    assert step.shape == () and step.dtype == torch.int32
    assert step.device == pt["w"].device
    kw = dict(lr=0.01, wd=0.01)
    for i in range(5):
        g = _dicts(10 + i)
        pj, sj = upd_j(pj, {n: jnp.asarray(a) for n, a in g.items()}, sj,
                       **kw)
        pt, st = upd_t(pt, {n: torch.from_numpy(a) for n, a in g.items()},
                       st, **kw)
        assert st["step"] is step
        assert int(step) == int(sj["step"]) == i + 1
        for beta in (0.9, 0.999):
            c = topt._bias_correction(beta, step)
            want = 1.0 - beta ** jnp.asarray(sj["step"]).astype(jnp.float32)
            assert c.dtype == torch.float32 and c.shape == ()
            np.testing.assert_allclose(float(c), float(want), rtol=1e-6)
    for n in SHAPES:
        np.testing.assert_allclose(pt[n].numpy(), np.asarray(pj[n]),
                                   atol=1e-6)


def _step_err(got, want, before):
    """Normwise error of a step's result ``got`` against ``want``, as a
    share of the step ``want - before`` (over every tensor at once)."""
    num = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in want)
    den = sum(float(np.sum((want[n] - before[n]) ** 2)) for n in want)
    return np.sqrt(num / den)


# bf16 against JAX: the port rounds to bf16 after every elementwise op of
# the update (the bias corrections included, to stay on the multi-tensor
# kernels), JAX computes the direction in fp32 from the bf16 state; the
# step lands within 2^-6 of JAX's (measured: 0.4-1.1 %), the moments
# within 2^-8 (0.2 %).  fp32 on the same values: within 1e-6.
BF16_STEP_TOL, BF16_MOMENT_TOL, FP32_STEP_TOL = 2.0 ** -6, 2.0 ** -8, 1e-6


@pytest.mark.parametrize("name, lr, w_scale",
                         [("adamw", 0.1, 1e-2), ("lamb", 1.0, 1.0)])
def test_bf16_update_matches_jax_within_its_rounding(name, lr, w_scale):
    """Five bf16 AdamW / LAMB updates against ``mxnet_tpu.parallel.optim``
    on the same bf16 weights, moments and gradients (each step starts
    both sides from the port's state; JAX promotes the direction to
    fp32, the port keeps every tensor in bf16).  The step is large
    against the weights' bf16 spacing (lr 0.1 on weights of 1e-2; LAMB's
    trust ratio makes its step the weights' size at lr 1), so the
    comparison sees the direction, not the weights' rounding.  Each
    step's change lies within ``BF16_STEP_TOL`` of JAX's and the moments
    within ``BF16_MOMENT_TOL``; the same values in fp32 give
    ``FP32_STEP_TOL``, a bound the bf16 update does not meet.  AdamW's
    control: JAX's step with the step count before (a stale bias
    correction) lies outside the bf16 bound.  LAMB's trust ratio cancels
    any uniform scale of the direction, so its bias corrections move
    its step only through ``eps`` and weight decay and it has no such
    control."""
    upd_j = getattr(jopt, f"{name}_update")
    upd_t = getattr(topt, f"{name}_update")
    kw = dict(lr=lr, wd=0.01)
    errs = {}
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        p = {n: torch.from_numpy(a * w_scale).to(dt)
             for n, a in _dicts(0).items()}
        st = getattr(topt, f"{name}_init")(p)
        errs[dt] = []
        for i in range(5):
            g = {n: torch.from_numpy(a * 0.1).to(dt)
                 for n, a in _dicts(10 + i).items()}

            def j(tree):
                return {n: jnp.asarray(t.float().numpy()).astype(jdt)
                        for n, t in tree.items()}

            sj = {"mean": j(st["mean"]), "var": j(st["var"]),
                  "step": jnp.asarray(int(st["step"]), jnp.int32)}
            pj, gj = j(p), j(g)
            before = {n: t.float().numpy().copy() for n, t in p.items()}
            want, wst = upd_j(pj, gj, sj, **kw)
            stale, _ = upd_j(pj, gj, dict(sj, step=sj["step"] - 1), **kw)
            p, st = upd_t(p, g, st, **kw)
            assert all(t.dtype == dt for t in p.values())

            def f32(tree):
                return {n: np.asarray(a, np.float32) for n, a in tree.items()}

            got = {n: t.float().numpy() for n, t in p.items()}
            err = _step_err(got, f32(want), before)
            errs[dt].append(err)
            if dt is torch.float32:
                assert err <= FP32_STEP_TOL, (i, err)
                continue
            assert err <= BF16_STEP_TOL, (i, err)
            for k in ("mean", "var"):
                mw = f32(wst[k])
                mg = {n: t.float().numpy() for n, t in st[k].items()}
                num = sum(float(np.sum((mg[n] - mw[n]) ** 2)) for n in mw)
                den = sum(float(np.sum(mw[n] ** 2)) for n in mw)
                assert np.sqrt(num / den) <= BF16_MOMENT_TOL, (i, k)
            if name == "adamw":
                ctl = _step_err(f32(stale), f32(want), before)
                assert not ctl <= BF16_STEP_TOL, (i, ctl)
    assert min(errs[torch.bfloat16]) > FP32_STEP_TOL


def test_returned_losses_survive_later_steps():
    """Each ``step()`` returns its own loss tensor: later steps (which
    replay into the program's static loss on the card) leave it as it
    was, and the losses of successive steps differ."""
    trainer = _trainer(_head())
    batch = _batch()
    losses, values = [], []
    for _ in range(3):
        loss = trainer.step(*batch)
        losses.append(loss)
        values.append(loss.clone())
    assert len({float(v) for v in values}) == 3
    assert len({t.data_ptr() for t in losses}) == 3
    for loss, v in zip(losses, values):
        assert torch.equal(loss, v)


def test_state_keeps_its_addresses_and_write_back():
    """Parameters, buffers and the optimizer's tensors (the step count
    included) stay the same tensors at the same addresses over steps, as
    a replayed graph needs; ``write_back`` still carries the trained
    values into the block."""
    head = _head()
    trainer = _trainer(head)

    def addresses():
        st = trainer.opt_state
        return ({n: t.data_ptr() for n, t in trainer.params.items()},
                {n: t.data_ptr() for n, t in trainer.buffers.items()},
                {n: t.data_ptr() for n, t in st["mean"].items()},
                {n: t.data_ptr() for n, t in st["var"].items()},
                st["step"].data_ptr())

    before = addresses()
    first = {n: p.detach().clone() for n, p in trainer.params.items()}
    for seed in (3, 4, 5):
        trainer.step(*_batch(seed))
    assert addresses() == before
    assert not torch.equal(first["mlm_dense.weight"],
                           trainer.params["mlm_dense.weight"])
    trainer.write_back()
    for n, p in head.named_parameters():
        assert torch.equal(p.detach(), trainer.params[n]), n


def test_one_program_per_signature_within_the_bound():
    """A second batch shape builds a second program and a repeated shape
    reuses its program; a signature over ``program_bound`` raises and
    leaves the trainer as it was."""
    trainer = _trainer(_head(), program_bound=2)
    trainer.step(*_batch(L=24))
    trainer.step(*_batch(L=16))
    trainer.step(*_batch(seed=5, L=24))
    assert trainer.compiled == len(trainer._programs) == 2
    sigs = sorted(s[0][0] for s in trainer._programs)
    assert sigs == [(B, 16), (B, 24)]
    step = int(trainer.opt_state["step"])
    with pytest.raises(MXNetError, match="program_bound=2"):
        trainer.step(*_batch(L=8))
    assert len(trainer._programs) == 2
    assert int(trainer.opt_state["step"]) == step == 3
    # a dtype change is a signature too
    b = list(_batch(L=16))
    b[2] = b[2].astype(np.int32)
    with pytest.raises(MXNetError, match="over program_bound"):
        trainer.step(*b)


@pytest.mark.parametrize("graphs", [True, False])
def test_train_step_fault_fires_before_the_update(graphs):
    """``faults.inject("train.step")`` is the chaos hook of every step in
    both modes: a failing rule raises ``InjectedFault`` and the step
    updates nothing; the next step runs as if the failed one had not
    been asked for."""
    trainer, twin = _trainer(_head(), graphs), _trainer(_head(), graphs)
    batch = _batch()
    trainer.step(*batch)
    twin.step(*batch)
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    with faults.plan("train.step=fail,times=1"):
        with pytest.raises(InjectedFault):
            trainer.step(*batch)
    assert int(trainer.opt_state["step"]) == 1
    for n, p in trainer.params.items():
        assert torch.equal(p, before[n]), n
    assert torch.equal(trainer.step(*batch), twin.step(*batch))


def test_enable_persistent_cache_points_the_default_store(tmp_path,
                                                          monkeypatch):
    """``enable_persistent_cache`` sets the default store that
    ``ops.build`` uses to ``cache_dir`` and returns a live mapping of
    the default store's hits and misses."""
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("MXNET_COMPILE_CACHE_MAX_BYTES", raising=False)
    assert not cc.get_default().enabled
    d = tmp_path / "kernels"
    stats = cc.enable_persistent_cache(str(d))
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(d))   # undone after
    cache = cc.get_default()
    assert cache.enabled and cache.cache_dir == str(d) and d.is_dir()
    assert stats == {"hits": 0, "misses": 0}
    key = cc.cache_key("lib", 0, ["sm_90a"])
    assert cache.get(key) is None
    assert cache.put(key, b"library bytes")
    assert cache.get(key) == b"library bytes"
    assert stats == {"hits": 1, "misses": 1}
    # the mapping reads whichever store is the default: a changed size
    # limit rebuilds it, and the counts are the new store's
    monkeypatch.setenv("MXNET_COMPILE_CACHE_MAX_BYTES", str(1 << 20))
    rebuilt = cc.get_default()
    assert rebuilt is not cache and rebuilt.cache_dir == str(d)
    assert stats == {"hits": 0, "misses": 0}
    assert rebuilt.get(key) == b"library bytes"
    assert dict(stats) == {"hits": 1, "misses": 0}
