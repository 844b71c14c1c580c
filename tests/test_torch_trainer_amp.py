"""PyTorch port, ``parallel.ShardedTrainer`` in bfloat16 (the AMP path of
``examples/train_imagenet.py``), which the JAX package cannot run (its
cast BatchNorm returns float32 and the next convolution refuses it), so
it is held to a plain-PyTorch computation instead:

- the inputs reach the block in the dtype the caller gives them: a
  float32 ``valid_length`` of 301 stays 301 under ``dtype=bfloat16``
  (bfloat16 would round it to 300);
- one SGD-with-momentum step of the zoo's resnet18_v1, cast to
  bfloat16, against the same network written in ``torch.nn.functional``
  (bfloat16 convolutions and dense layer, BatchNorm normalised in
  float32 with the batch's biased variance, MXNet's running-statistics
  rule) on the same weights, with hand-written SGD: the first loss, the
  momentum (``-lr * g``), the weights after the update and the
  BatchNorm running statistics.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel

LR, MOMENTUM, BN_MOMENTUM, EPS = 0.02, 0.9, 0.9, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu(0):
        yield


def _loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


class _CountKeys(torch.nn.Module):
    """Counts the keys below each row's ``valid_length`` (as a mask built
    from a float ``valid_length`` does), times a weight."""

    def __init__(self, keys):
        super().__init__()
        self.keys = keys
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, valid_length):
        mask = torch.arange(self.keys) < valid_length[:, None]
        return (x.float() * mask).sum(-1) * self.w.float()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_float_valid_length_is_not_cast(dtype):
    keys = 512
    valid = np.array([301.0, 257.0, 511.0, 383.0], np.float32)
    assert (torch.from_numpy(valid).to(torch.bfloat16).float().numpy()
            != valid).all()             # each would round in bfloat16
    x = torch.ones((4, keys), dtype=dtype or torch.float32)
    tr = parallel.ShardedTrainer(
        _CountKeys(keys), lambda out, _y: out.mean(),
        parallel.make_mesh(dp=1, device="cpu"), optimizer="sgd",
        optimizer_params={"learning_rate": 0.0},
        example_inputs=(x, valid), n_labels=1, dtype=dtype)
    loss = float(tr.step(x, torch.from_numpy(valid), np.zeros(4, np.int32)))
    assert loss == valid.mean()


# ------------------------------------------------ resnet18_v1, by hand
_STAGES = ((4, 64, 64, 1), (5, 64, 128, 2), (6, 128, 256, 2),
           (7, 256, 512, 2))


def _resnet18_v1(P, x, stats):
    """The zoo's resnet18_v1 over ``P`` (its parameters by structural
    name); the batch statistics of each BatchNorm go into ``stats``."""
    def conv(name, h, stride, pad):
        return F.conv2d(h, P[name + ".weight"], None, stride, pad)

    def bn(name, h):
        h32 = h.float()
        var, mean = torch.var_mean(h32, dim=(0, 2, 3), unbiased=False)
        stats[name] = (mean.detach(), var.detach())
        out = F.batch_norm(h32, None, None, P[name + ".gamma"].float(),
                           P[name + ".beta"].float(), training=True,
                           eps=EPS)
        return out.to(h.dtype)

    h = F.relu(bn("features.1", conv("features.0", x, 2, 3)))
    h = F.max_pool2d(h, 3, 2, 1)
    for stage, cin, cout, stride in _STAGES:
        for b in (0, 1):
            pre = f"features.{stage}.{b}"
            s = stride if b == 0 else 1
            y = F.relu(bn(pre + ".body.1", conv(pre + ".body.0", h, s, 1)))
            y = bn(pre + ".body.4", conv(pre + ".body.3", y, 1, 1))
            if b == 0 and (stride != 1 or cin != cout):
                h = bn(pre + ".downsample.1",
                       conv(pre + ".downsample.0", h, s, 0))
            h = F.relu(y + h)
    h = h.mean(dim=(2, 3))
    return F.linear(h, P["output.weight"], P["output.bias"])


def _reference_step(saved, x, y):
    """One step by hand: every floating tensor in bfloat16 (as the
    trainer owns them), the momentum from zero, so ``-lr * g``, the
    running statistics moved by ``BN_MOMENTUM``.  Returns the loss, each weight's momentum, the new
    weights (float32) and the new running statistics."""
    P = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in saved.items()}
    train = [k for k in P if not k.endswith(("running_mean",
                                             "running_var"))]
    for k in train:
        P[k].requires_grad_(True)
    stats = {}
    loss = _loss(_resnet18_v1(P, x.to(torch.bfloat16), stats), y)
    loss.backward()
    moms, new = {}, {}
    with torch.no_grad():
        for k in train:
            moms[k] = -LR * P[k].grad
            new[k] = (P[k] + moms[k]).float()
        for name, (mean, var) in stats.items():
            for key, batch in (("running_mean", mean), ("running_var", var)):
                run = P[f"{name}.{key}"].float()
                new[f"{name}.{key}"] = BN_MOMENTUM * run \
                    + (1 - BN_MOMENTUM) * batch
    return float(loss.detach()), moms, new


def _rel(a, b):
    """||a - b|| / ||b||; 0 where both are 0 (a gradient that is 0)."""
    num = float((a.float() - b.float()).norm())
    den = float(b.float().norm())
    return num / den if den else (0.0 if num == 0 else float("inf"))


def test_bf16_step_matches_plain_torch_resnet18(tmp_path):
    """The loss within rtol 1e-3 (read: equal); each momentum tensor,
    ``-lr * g``, within 5e-2 of the reference's in relative L2 norm (read:
    at most 3.2e-2; the two backward passes round each layer's gradient
    to bfloat16 in another order, through 18 layers); SGD applied by
    hand to the trainer's own momentum gives its weights bit for bit;
    each weight's
    change within 0.15 of the reference's in relative L2 norm (read: at
    most 0.104: a change of a few bfloat16 ulps, as BatchNorm's gamma
    near 1 takes, flips by one ulp where the two gradients straddle a
    rounding boundary); each running statistic within 2^-7 in relative
    L2 norm (read: 2.7e-3; it is stored in bfloat16)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(np.array([0, 3, 1, 5], np.int32))
    mx.random.seed(0)
    net = mx.gluon.model_zoo.get_model("resnet18_v1", classes=6)
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(x.numpy()))
    # running statistics away from their 0 / 1 start
    for p in net.collect_params().values():
        if p.name.endswith(("running_mean", "running_var")):
            shift = 0.0 if p.name.endswith("mean") else 1.0
            p.set_data(mx.nd.array(rng.rand(*p.shape).astype(np.float32)
                                   * 0.5 + shift))
    path = str(tmp_path / "r18.npz")
    net.save_parameters(path)
    with np.load(path) as f:
        saved = {k: f[k] for k in f.files if not k.startswith("__")}
    net.cast("bfloat16")
    tr = parallel.ShardedTrainer(
        net, _loss, parallel.make_mesh(dp=1, device="cpu"),
        optimizer="sgd",
        optimizer_params={"learning_rate": LR, "momentum": MOMENTUM},
        example_inputs=(mx.nd.zeros((4, 3, 32, 32), dtype="bfloat16"),),
        n_labels=1, dtype=torch.bfloat16)
    got_loss = float(tr.step(mx.nd.array(x.numpy()).astype("bfloat16"),
                             mx.nd.array(y.numpy(), dtype="int32")))
    want_loss, want_mom, want = _reference_step(saved, x, y)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-3)

    tr.write_back()
    structural = net._collect_params_with_prefix()
    got = {k: p.data().data_torch.detach().float()
           for k, p in structural.items()}
    assert set(got) == set(want)
    name_of = {p.name: k for k, p in structural.items()}
    assert {name_of[n] for n in tr.opt_state["mom"]} == set(want_mom)
    for n, mom in tr.opt_state["mom"].items():
        k = name_of[n]
        start = torch.from_numpy(saved[k]).to(torch.bfloat16)
        assert mom.dtype == torch.bfloat16, k
        assert _rel(mom, want_mom[k]) <= 5e-2, k
        assert torch.equal(got[k], (start + mom).float()), k
        assert _rel(got[k] - start.float(), want[k] - start.float()) \
            <= 0.15, k
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(got[k], w) <= 2 ** -7, k
