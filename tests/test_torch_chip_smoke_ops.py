"""PyTorch port, the inputs of ``chip_smoke.py``'s ``ops_card`` and
``gluon_ssd`` phases on the CPU, against the JAX package.

``ops_card`` holds the card to the port's CPU over its own table of
seeded inputs (the card has no JAX); here the same table runs through
the JAX op and the port's CPU op, forward, with the phase's own limits
(``chip_smoke._ops_card_err``), and the table must cover the op
library's 160-name long tail.  ``gluon_ssd`` runs examples/ssd_detection.py's
loop through chip_smoke's copy of TinySSD; here that copy and the
example's own TinySSD (the JAX package) start from the same weights and
take the same 3 batches: anchors equal, losses within
``GLUON_LENET_RTOL``, and the port's hybridized forward (the CachedOp
path on the CPU) equals its eager one.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as preg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))
import chip_smoke  # noqa: E402

SPECS = chip_smoke._ops_card_specs()


def test_ops_card_covers_the_new_names():
    names = chip_smoke._ops_card_names(preg)
    assert len(names) == chip_smoke.OPS_CARD_NEW == 160
    old = set(preg.list_ops()) - set(names)
    assert len(old) == 200 and "Custom" not in old


@pytest.mark.parametrize("name", sorted(SPECS))
def test_ops_card_table_against_jax(name):
    import torch
    make, kwargs, wrt = SPECS[name]
    arrays = make(np.random.RandomState(len(name) * 7 + 1))
    got, _g, _c = chip_smoke._ops_card_run(
        torch, mx, name, arrays, kwargs, wrt, torch.device("cpu"))
    want = jreg.get_op(name).fn(*[jnp.asarray(a) for a in arrays],
                                **kwargs)
    want = [np.asarray(w) for w in (want if isinstance(want, (list, tuple))
                                    else [want])]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err, lim = chip_smoke._ops_card_err(name, i, g, w)
        assert err <= lim, (name, i, err, lim)


def test_gluon_ssd_loop_against_the_example(tmp_path):
    import ssd_detection as ex
    cfg = chip_smoke.GLUON_SSD
    path = str(tmp_path / "ssd.npz")
    jmx.random.seed(0)
    jnet = ex.TinySSD()
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((1, 1, cfg["img"], cfg["img"])))
    jnet.save_parameters(path)
    rng = np.random.RandomState(0)
    batches = [chip_smoke._ssd_batch(mx, rng, 8) for _ in range(3)]
    jtrainer = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                                 {"learning_rate": cfg["lr"]})
    jce = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    want = [float(chip_smoke._ssd_step(
        jmx, jnet, jtrainer, jce, jmx.nd.array(x), jmx.nd.array(y))[0]
        .asscalar()) for x, y in batches]
    with mx.cpu(0):
        net = chip_smoke._tiny_ssd(mx)
        net.load_parameters(path)
        x = mx.nd.array(batches[0][0])
        anchors = net(x)[0].asnumpy()
        np.testing.assert_allclose(anchors, jnet(jmx.nd.array(
            batches[0][0]))[0].asnumpy(), rtol=1e-6, atol=1e-7)
        assert anchors.shape == (1, 256, 4)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": cfg["lr"]})
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        got = [float(chip_smoke._ssd_step(
            mx, net, trainer, ce, mx.nd.array(x), mx.nd.array(y))[0]
            .asscalar()) for x, y in batches]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        assert all(e <= t for e, t in zip(rel, chip_smoke.GLUON_LENET_RTOL)), \
            (got, want)
        eager = [o.asnumpy() for o in net(x)]
        net.hybridize()
        for _ in range(2):
            hybrid = [o.asnumpy() for o in net(x)]
            for h, e in zip(hybrid, eager):
                np.testing.assert_allclose(h, e, rtol=0, atol=1e-5 * float(
                    np.abs(e).max()))
        miou, acc = chip_smoke._ssd_eval(mx, net, x, batches[0][1])
        assert 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0
