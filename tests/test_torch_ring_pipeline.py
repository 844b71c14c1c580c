"""PyTorch port, sequence and pipeline parallelism:
``parallel.ring_attention`` / ``ring_self_attention`` over an ``sp``
group and ``parallel.pipeline_apply`` over a ``pp`` group, held against
the JAX package.

One four-rank gloo CPU job (``test_torch_dist.run_job``) runs them all;
each rank holds its quarter of the sequence (sp = 4, L = 32):

- ``test_parallel.py``'s ring tests — dense agreement, causal and not
  (1e-4), the windowed ring for windows 4, 7, 16, 64 (1e-4) and its two
  ``MXNetError`` checks, ``ring_self_attention`` — and the port's ring
  against the JAX ring on four devices (1e-4);
- the ring's gradient (the reverse ring of its autograd Function)
  against ``jax.grad`` of the JAX ``ring_attention`` (causal) and of the
  dense windowed softmax (window 5): dQ / dK / dV within 1e-4;
- the five tests of ``test_pipeline.py``: 4 / 2 / 1 stages on the
  first ranks of the job (the rest are not members), gradients against
  ``jax.grad`` of the sequential composition, a training loop, pytree
  stage parameters, and the too-few-devices error.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError

from test_torch_dist import run_job

B, H, L, D = 2, 4, 32, 8
WB, WH = 2, 2
STAGES = [(4, 6), (2, 3), (4, 2), (1, 3)]


def _qkv(seed, b, h):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, L, D).astype(np.float32) for _ in range(3)]


def _dense(q, k, v, causal, window=None):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    qi, ki = np.arange(L)[:, None], np.arange(L)[None, :]
    if causal:
        dead = ki > qi
        if window is not None:
            dead = dead | (ki <= qi - window)
        s[:, :, dead] = -1e30
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def _stage_np(w, x):
    return np.tanh(x @ w)


WORKER = '''
import torch
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError

sp = tpar.make_mesh(dp=1, sp=4, device="cpu")
n = 32 // 4
mine = slice(RANK * n, (RANK + 1) * n)
OUT["transport"] = np.array(dist.transport(sp.group("sp"), sp.device))

def blocks(prefix):
    return [torch.from_numpy(IN[prefix + c][:, :, mine].copy())
            for c in "qkv"]

q, k, v = blocks("d_")
for causal in (False, True):
    OUT["ring_%d" % causal] = tpar.ring_attention(
        q, k, v, sp, "sp", causal=causal).numpy()
q, k, v = blocks("w_")
for window in (4, 7, 16, 64):
    OUT["win_%d" % window] = tpar.ring_attention(
        q, k, v, sp, "sp", causal=True, window=window).numpy()
errs = []
for kw in (dict(causal=False, window=4), dict(causal=True, window=0)):
    try:
        tpar.ring_attention(q, k, v, sp, "sp", **kw)
    except MXNetError as e:
        errs.append(str(e))
OUT["ring_errors"] = np.array(errs)
x = torch.from_numpy(IN["sa_x"][:, mine].copy())
OUT["self_att"] = tpar.ring_self_attention(
    x, torch.from_numpy(IN["sa_wqkv"]), torch.from_numpy(IN["sa_wout"]), 2,
    sp, "sp").numpy()

# gradients through the reverse ring
for window in (None, 5):
    q, k, v = (t.requires_grad_() for t in blocks("g_"))
    out = tpar.ring_attention(q, k, v, sp, "sp", causal=True, window=window)
    ct = torch.from_numpy(IN["g_ct"][:, :, mine].copy())
    (out * ct).sum().backward()
    tag = "none" if window is None else str(window)
    OUT["gq_" + tag], OUT["gk_" + tag], OUT["gv_" + tag] = (
        q.grad.numpy(), k.grad.numpy(), v.grad.numpy())

# pipelines on the first n_stages ranks
def stage(w, x):
    return torch.tanh(x @ w)

for n_stages, n_micro in ((4, 6), (2, 3), (4, 2), (1, 3)):
    pp = tpar.make_pipeline_mesh(n_stages, device="cpu")
    if RANK < n_stages:
        ws = torch.from_numpy(IN["pp_w_%d_%d" % (n_stages, n_micro)])
        xs = torch.from_numpy(IN["pp_x_%d_%d" % (n_stages, n_micro)])
        OUT["pp_%d_%d" % (n_stages, n_micro)] = tpar.pipeline_apply(
            stage, ws, xs, pp).numpy()
pp4 = tpar.make_pipeline_mesh(4, device="cpu")
ws = torch.from_numpy(IN["pg_w"]).requires_grad_()
xs = torch.from_numpy(IN["pg_x"]).requires_grad_()
(tpar.pipeline_apply(stage, ws, xs, pp4) ** 2).sum().backward()
OUT["pg_w"], OUT["pg_x"] = ws.grad.numpy(), xs.grad.numpy()

pp2 = tpar.make_pipeline_mesh(2, device="cpu")
if RANK < 2:
    ws = torch.from_numpy(IN["tr_w"]).clone()
    xs = torch.from_numpy(IN["tr_x"])
    ys = tpar.pipeline_apply(stage, torch.from_numpy(IN["tr_teacher"]),
                             xs, pp2)
    losses = []
    for i in range(120):
        w = ws.clone().requires_grad_()
        loss = ((tpar.pipeline_apply(stage, w, xs, pp2) - ys) ** 2).mean()
        loss.backward()
        ws = ws - 0.5 * w.grad
        losses.append(float(loss))
    OUT["tr_losses"] = np.array(losses)
    params = {"w": torch.from_numpy(IN["pt_w"]),
              "b": torch.from_numpy(IN["pt_b"])}
    OUT["pytree"] = tpar.pipeline_apply(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]), params,
        torch.from_numpy(IN["pt_x"]), pp2).numpy()
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = {}
    for prefix, seed, b, h in (("d_", 0, B, H), ("w_", 1, WB, WH),
                               ("g_", 4, 1, 2)):
        for c, a in zip("qkv", _qkv(seed, b, h)):
            inputs[prefix + c] = a
    inputs["g_ct"] = np.random.RandomState(5).randn(1, 2, L, D).astype(
        np.float32)
    rng = np.random.RandomState(1)
    inputs["sa_x"] = rng.randn(2, 16 * 2, 8).astype(np.float32)
    inputs["sa_wqkv"] = (rng.randn(24, 8) * 0.1).astype(np.float32)
    inputs["sa_wout"] = (rng.randn(8, 8) * 0.1).astype(np.float32)
    for n_stages, n_micro in STAGES:
        rng = np.random.RandomState(0)
        inputs["pp_w_%d_%d" % (n_stages, n_micro)] = (
            rng.randn(n_stages, 8, 8).astype(np.float32) * 0.5)
        inputs["pp_x_%d_%d" % (n_stages, n_micro)] = rng.randn(
            n_micro, 4, 8).astype(np.float32)
    rng = np.random.RandomState(1)
    inputs["pg_w"] = rng.randn(4, 6, 6).astype(np.float32) * 0.5
    inputs["pg_x"] = rng.randn(5, 3, 6).astype(np.float32)
    rng = np.random.RandomState(2)
    inputs["tr_w"] = rng.randn(2, 4, 4).astype(np.float32) * 0.3
    inputs["tr_x"] = rng.randn(4, 8, 4).astype(np.float32)
    inputs["tr_teacher"] = rng.randn(2, 4, 4).astype(np.float32) * 0.3
    rng = np.random.RandomState(3)
    inputs["pt_w"] = rng.randn(2, 4, 4).astype(np.float32) * 0.5
    inputs["pt_b"] = rng.randn(2, 4).astype(np.float32)
    inputs["pt_x"] = rng.randn(3, 2, 4).astype(np.float32)
    outs = run_job(tmp_path_factory.mktemp("ring"), 4, WORKER, inputs,
                   timeout=400)
    return outs, inputs


def _gathered(outs, key, axis=2):
    return np.concatenate([o[key] for o in outs], axis=axis)


def test_ring_attention_matches_dense(job):
    outs, inp = job
    q, k, v = (inp["d_" + c] for c in "qkv")
    jmesh = jpar.make_mesh(dp=1, tp=1, sp=4, devices=jax.devices()[:4])
    for causal in (False, True):
        got = _gathered(outs, "ring_%d" % causal)
        assert np.abs(got - _dense(q, k, v, causal)).max() < 1e-4, causal
        want = np.asarray(jpar.ring_attention(
            jnp.array(q), jnp.array(k), jnp.array(v), jmesh, "sp",
            causal=causal))
        assert np.abs(got - want).max() < 1e-4, causal
    assert str(outs[0]["transport"]) == "gloo"


def test_ring_self_attention_runs(job):
    outs, inp = job
    got = _gathered(outs, "self_att", axis=1)
    assert got.shape == (2, 32, 8)
    assert np.isfinite(got).all()
    jmesh = jpar.make_mesh(dp=1, tp=1, sp=4, devices=jax.devices()[:4])
    want = np.asarray(jpar.ring_self_attention(
        jnp.asarray(inp["sa_x"]), jnp.asarray(inp["sa_wqkv"]),
        jnp.asarray(inp["sa_wout"]), 2, jmesh, "sp"))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ring_attention_windowed_matches_dense(job):
    outs, inp = job
    q, k, v = (inp["w_" + c] for c in "qkv")
    for window in (4, 7, 16, 64):
        got = _gathered(outs, "win_%d" % window)
        assert np.abs(got - _dense(q, k, v, True, window)).max() < 1e-4
    errs = [str(e) for e in outs[0]["ring_errors"]]
    assert "causal" in errs[0] and ">= 1" in errs[1]


@pytest.mark.parametrize("window", [None, 5])
def test_ring_attention_gradient_matches_jax(job, window):
    """Causal: against ``jax.grad`` of the JAX ``ring_attention`` on four
    devices.  Windowed: against ``jax.grad`` of the dense windowed
    softmax in jnp (the JAX ring's windowed gradient compiles for ~18 s
    on the CPU and equals the dense one; the forward test holds the
    JAX ring and the dense oracle together)."""
    outs, inp = job
    q, k, v = (jnp.asarray(inp["g_" + c]) for c in "qkv")
    ct = jnp.asarray(inp["g_ct"])
    jmesh = jpar.make_mesh(dp=1, tp=1, sp=4, devices=jax.devices()[:4])

    def dense(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
        qi, ki = jnp.arange(L)[:, None], jnp.arange(L)[None, :]
        s = jnp.where((ki > qi) | (ki <= qi - window), -1e30, s)
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)

    def f(q, k, v):
        if window is not None:
            return (dense(q, k, v) * ct).sum()
        return (jpar.ring_attention(q, k, v, jmesh, "sp", causal=True,
                                    window=window) * ct).sum()

    grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tag = "none" if window is None else str(window)
    for name, want in zip("qkv", grads):
        got = _gathered(outs, "g%s_%s" % (name, tag))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   err_msg=name)


# ------------------------------------------------------------ pipeline
def _sequential(ws, xs):
    outs = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for s in range(ws.shape[0]):
            h = _stage_np(ws[s], h)
        outs.append(h)
    return np.stack(outs)


@pytest.mark.parametrize("n_stages,n_micro", STAGES)
def test_pipeline_matches_sequential(job, n_stages, n_micro):
    outs, inp = job
    ws = inp["pp_w_%d_%d" % (n_stages, n_micro)]
    xs = inp["pp_x_%d_%d" % (n_stages, n_micro)]
    want = _sequential(ws, xs)
    for r in range(n_stages):
        np.testing.assert_allclose(outs[r]["pp_%d_%d" % (n_stages, n_micro)],
                                   want, rtol=1e-5, atol=1e-6)
    jout = jpar.pipeline_apply(lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws),
                               jnp.asarray(xs),
                               jpar.make_pipeline_mesh(n_stages))
    np.testing.assert_allclose(outs[0]["pp_%d_%d" % (n_stages, n_micro)],
                               np.asarray(jout), rtol=1e-5, atol=1e-6)


def test_pipeline_gradients_match_sequential(job):
    outs, inp = job
    ws, xs = jnp.asarray(inp["pg_w"]), jnp.asarray(inp["pg_x"])

    def loss_seq(ws, xs):
        h = xs
        for s in range(ws.shape[0]):
            h = jnp.tanh(h @ ws[s])
        return (h ** 2).sum()

    g_w, g_x = jax.grad(loss_seq, argnums=(0, 1))(ws, xs)
    for o in outs:
        np.testing.assert_allclose(o["pg_w"], np.asarray(g_w), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(o["pg_x"], np.asarray(g_x), rtol=1e-4,
                                   atol=1e-5)


def test_pipeline_trains(job):
    outs, _ = job
    for o in outs[:2]:
        losses = o["tr_losses"]
        assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])


def test_pipeline_params_pytree(job):
    outs, inp = job
    res = []
    for m in range(3):
        v = inp["pt_x"][m]
        for s in range(2):
            v = np.tanh(v @ inp["pt_w"][s] + inp["pt_b"][s])
        res.append(v)
    for o in outs[:2]:
        np.testing.assert_allclose(o["pytree"], np.stack(res), rtol=1e-5,
                                   atol=1e-6)


def test_pipeline_too_few_devices_raises():
    with pytest.raises(MXNetError, match="needs 100 devices, have 1"):
        tpar.make_pipeline_mesh(100, device="cpu")
