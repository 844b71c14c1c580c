"""PyTorch port, ``test_utils`` (``mxnet_tpu_torch/test_utils.py``)
against the JAX package's ``mxnet_tpu.test_utils``.

Each helper runs on the same inputs in both packages: the comparisons
(``same``, ``almost_equal``, ``assert_almost_equal``'s verdicts and
messages) agree exactly, ``rand_shape_*`` draw the same shapes from one
numpy seed, ``numeric_grad`` gives the same differences bit for bit,
``check_numeric_gradient``, ``check_consistency`` and the
``check_symbolic_*`` pair pass on the same ops and fail on a wrong
expectation.  ``rand_ndarray``'s draws come from each package's own
generator, so they are held to their range, dtype and (for the port's
``"csr"`` / ``"row_sparse"``, which the JAX package ignores) the
storage and density asked for.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import test_utils as jtu

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import test_utils as tu


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def test_default_context(monkeypatch):
    monkeypatch.delenv("MXNET_TEST_CTX", raising=False)
    assert tu.default_context() == mx.cpu(0)
    with mx.cpu(1):
        assert tu.default_context() == mx.cpu(1)
    monkeypatch.setenv("MXNET_TEST_CTX", "cpu")
    assert tu.default_context() == mx.cpu(0)
    assert str(tu.default_context()) == str(jtu.default_context())
    tu.set_default_context(mx.cpu(1))
    try:
        assert tu.default_context() == mx.cpu(1)
    finally:
        tu.set_default_context(None)
    monkeypatch.delenv("MXNET_TEST_CTX")
    assert tu.default_context() == mx.cpu(0)


@pytest.mark.parametrize("a,b", [
    ([1.0, 2.0], [1.0, 2.0]),
    ([1.0, 2.0], [1.0, 2.000001]),
    ([1.0, 2.0], [1.0, 2.1]),
    ([[0.0, 1e-7]], [[0.0, 0.0]]),
])
def test_comparisons_match_jax(a, b):
    a32, b32 = np.array(a, np.float32), np.array(b, np.float32)
    assert tu.same(nd.array(a32), b32) == jtu.same(jmx.nd.array(a32), b32)
    assert tu.almost_equal(nd.array(a32), b32) \
        == jtu.almost_equal(jmx.nd.array(a32), b32)
    outcomes = []
    for mod, arr in ((tu, nd.array), (jtu, jmx.nd.array)):
        try:
            mod.assert_almost_equal(arr(a32), b32, names=("got", "want"))
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_assert_almost_equal_shape_mismatch():
    for mod in (tu, jtu):
        with pytest.raises(AssertionError, match="shape mismatch"):
            mod.assert_almost_equal(np.zeros((2, 3)), np.zeros((3, 2)))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_rand_ndarray_dense(dtype):
    mx.random.seed(0)
    a = tu.rand_ndarray((4, 5), dtype=dtype)
    j = jtu.rand_ndarray((4, 5), dtype=dtype)
    assert a.shape == j.shape == (4, 5)
    assert a.dtype == j.dtype
    assert a.context == mx.cpu(0)
    v = a.asnumpy()
    assert (v >= -1).all() and (v < 1).all() and np.unique(v).size > 10


@pytest.mark.parametrize("stype,density", [("csr", 0.3),
                                           ("row_sparse", 0.5)])
def test_rand_ndarray_sparse(stype, density):
    mx.random.seed(1)
    a = tu.rand_ndarray((40, 30), stype=stype, density=density)
    assert a.stype == stype and a.shape == (40, 30)
    dense = a.tostype("default").asnumpy()
    if stype == "csr":
        share = (dense != 0).mean()
        np.testing.assert_array_equal(dense[dense != 0],
                                      a.data.asnumpy())
    else:
        rows = (dense != 0).any(axis=1)
        share = rows.mean()
        np.testing.assert_array_equal(np.flatnonzero(rows),
                                      a.indices.asnumpy())
    assert abs(share - density) < 0.15, share
    with pytest.raises(mx.MXNetError, match="2-D"):
        tu.rand_ndarray((2, 3, 4), stype="csr")


def test_rand_shapes_match_jax():
    for fn in ("rand_shape_2d", "rand_shape_3d"):
        np.random.seed(7)
        got = [getattr(tu, fn)() for _ in range(5)]
        np.random.seed(7)
        want = [getattr(jtu, fn)() for _ in range(5)]
        assert got == want


def test_numeric_grad_matches_jax():
    def f(xs):
        return float((np.sin(xs[0]) * xs[1] ** 2).sum())

    rs = np.random.RandomState(0)
    inputs = [rs.rand(3, 2), rs.rand(3, 2)]
    got = tu.numeric_grad(f, [x.copy() for x in inputs])
    want = jtu.numeric_grad(f, [x.copy() for x in inputs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], np.cos(inputs[0]) * inputs[1] ** 2,
                               rtol=1e-6)


@pytest.mark.parametrize("op", ["mul_sin", "tanh_sum", "dot"])
def test_check_numeric_gradient(op):
    rs = np.random.RandomState(1)
    xs = [rs.rand(3, 4), rs.rand(3, 4)] if op != "dot" \
        else [rs.rand(3, 4), rs.rand(4, 2)]
    for m in (mx, jmx):
        fn = {"mul_sin": lambda x, y: x * y + m.nd.sin(x),
              "tanh_sum": lambda x, y: m.nd.tanh(x + y).sum(axis=1),
              "dot": lambda x, y: m.nd.dot(x, y)}[op]
        # eps 1e-2: the float32 forward's rounding over 2 * eps stays
        # under the default atol 1e-4
        (tu if m is mx else jtu).check_numeric_gradient(fn, xs, eps=1e-2)


def test_check_numeric_gradient_catches_a_wrong_gradient():
    x = [np.random.RandomState(2).rand(2, 2)]
    for m, mod in ((mx, tu), (jmx, jtu)):
        # forward 2x, but the tape sees 3x (a stop-gradient term)
        with pytest.raises(AssertionError, match="autograd_grad"):
            mod.check_numeric_gradient(
                lambda a: a * 3 - m.nd.stop_gradient(a), x, eps=1e-2)


def test_check_consistency_across_contexts():
    x = np.array([[-1.0, 0.5], [2.0, -3.0]], np.float32)
    got = tu.check_consistency(lambda a: nd.relu(a) * 2, [x],
                               ctx_list=[mx.cpu(0), mx.cpu(1)])
    want = jtu.check_consistency(lambda a: jmx.nd.relu(a) * 2, [x])
    np.testing.assert_array_equal(got[0], want[0])


def _sym(m):
    s = m.sym
    x, y = s.var("x"), s.var("y")
    return s.FullyConnected(x, y, no_bias=True, num_hidden=3) * 2


def test_check_symbolic_forward_and_backward():
    rs = np.random.RandomState(3)
    x, w = rs.rand(2, 4).astype(np.float32), rs.rand(3, 4).astype(np.float32)
    out = (x @ w.T) * 2
    og = rs.rand(2, 3).astype(np.float32)
    args = {"x": x, "y": w}
    grads = {"x": og @ w * 2, "y": og.T @ x * 2}
    names = _sym(jmx).list_arguments()
    for m, mod in ((mx, tu), (jmx, jtu)):
        sym = _sym(m)
        # the arguments in the graph's order (the same in both packages)
        assert sym.list_arguments() == names
        inputs = [args[n] for n in names]
        mod.check_symbolic_forward(sym, inputs, [out])
        mod.check_symbolic_backward(sym, inputs, [og],
                                    [grads[n] for n in names], rtol=1e-5,
                                    atol=1e-5)
        with pytest.raises(AssertionError):
            mod.check_symbolic_forward(sym, inputs, [out + 1.0])
        with pytest.raises(AssertionError, match="grad"):
            mod.check_symbolic_backward(sym, inputs, [og],
                                        [grads[names[0]] + 1.0, None])


def test_simple_forward():
    x = np.array([1.0, -2.0], np.float32)
    np.testing.assert_array_equal(tu.simple_forward(nd.abs, x),
                                  jtu.simple_forward(jmx.nd.abs, x))
