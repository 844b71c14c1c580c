"""PyTorch port, ``metric`` (``mxnet_tpu_torch/metric.py``): every metric
class against the JAX package's on the same numpy inputs (relative
1e-7), ``create`` by name, alias and list, ``CompositeEvalMetric``,
``CustomMetric`` / ``np_metric``, ``update_dict`` and
``get_name_value``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _inputs(kind, seed):
    rs = np.random.RandomState(seed)
    if kind == "class":
        pred = rs.rand(12, 5).astype(np.float32)
        pred /= pred.sum(axis=1, keepdims=True)
        return [rs.randint(0, 5, 12).astype(np.float32)], [pred]
    if kind == "binary":
        return [rs.randint(0, 2, 10).astype(np.float32)], \
            [rs.rand(10, 2).astype(np.float32)]
    if kind == "seq":
        pred = rs.rand(3, 4, 6).astype(np.float32)
        pred /= pred.sum(axis=-1, keepdims=True)
        return [rs.randint(0, 6, (3, 4)).astype(np.float32)], [pred]
    return [rs.randn(9, 1).astype(np.float32)], \
        [rs.randn(9, 1).astype(np.float32)]


CASES = [
    ("Accuracy", {}, "class"), ("TopKAccuracy", {"top_k": 3}, "class"),
    ("F1", {}, "binary"), ("MAE", {}, "reg"), ("MSE", {}, "reg"),
    ("RMSE", {}, "reg"), ("CrossEntropy", {}, "class"),
    ("Perplexity", {"ignore_label": 0}, "seq"), ("Loss", {}, "reg"),
    ("PearsonCorrelation", {}, "reg"),
]


@pytest.mark.parametrize("name,kw,kind", CASES)
def test_metric_matches_jax(name, kw, kind):
    got = []
    for pkg, ndm in ((mx, nd), (jmx, jnd)):
        m = getattr(pkg.metric, name)(**kw)
        for seed in (0, 1):
            labels, preds = _inputs(kind, seed)
            m.update([ndm.array(a) for a in labels],
                     [ndm.array(a) for a in preds])
        got.append((m.get(), m.num_inst, m.get_name_value(), str(m)))
        m.reset()
        assert m.num_inst == 0
    (nv, n, gnv, s), (jnv, jn, jgnv, js) = got
    assert nv[0] == jnv[0] and n == jn and s.split(":")[0] == \
        js.split(":")[0]
    np.testing.assert_allclose(nv[1], jnv[1], rtol=1e-7)
    assert isinstance(nv[1], float)


@pytest.mark.parametrize("spec", ["acc", "accuracy", "ce", "top_k_accuracy",
                                  "mse", "cross-entropy", "f1"])
def test_create_by_name(spec):
    m, jm = mx.metric.create(spec), jmx.metric.create(spec)
    assert type(m).__name__ == type(jm).__name__ and m.name == jm.name


def test_create_by_list_and_composite():
    labels, preds = _inputs("class", 3)
    got = []
    for pkg, ndm in ((mx, nd), (jmx, jnd)):
        comp = pkg.metric.create(["acc", pkg.metric.TopKAccuracy(top_k=2)])
        assert isinstance(comp, pkg.metric.CompositeEvalMetric)
        comp.add("ce")
        comp.update([ndm.array(labels[0])], [ndm.array(preds[0])])
        got.append(comp.get())
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-7)
    with pytest.raises(MXNetError):
        mx.metric.create("no-such-metric")


def test_custom_metric_and_np_metric():
    def err_sum(label, pred):
        return float(np.abs(label - pred.ravel()).sum()), label.size

    labels, preds = _inputs("reg", 4)
    got = []
    for pkg, ndm in ((mx, nd), (jmx, jnd)):
        f = pkg.metric.np_metric(err_sum)()
        c = pkg.metric.create(lambda lab, pr: float((lab > 0).mean()))
        for m in (f, c):
            m.update([ndm.array(labels[0])], [ndm.array(preds[0])])
        got.append((f.get(), c.get()))
    assert got[0][0][0] == got[1][0][0] == "custom(err_sum)"
    for a, b in zip(got[0], got[1]):
        np.testing.assert_allclose(a[1], b[1], rtol=1e-7)


def test_update_dict():
    labels, preds = _inputs("class", 5)
    got = []
    for pkg, ndm in ((mx, nd), (jmx, jnd)):
        m = pkg.metric.Accuracy(output_names=["out"], label_names=["lab"])
        m.update_dict({"lab": ndm.array(labels[0])},
                      {"out": ndm.array(preds[0])})
        got.append(m.get())
    assert got[0] == got[1]
