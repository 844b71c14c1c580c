"""PyTorch port, sparse storage (``mxnet_tpu_torch/ndarray/sparse.py``)
and the lazy row updates it feeds (``optimizer.SGD`` / ``Adam``
``lazy_update``, ``gluon.Trainer`` on a ``grad_stype="row_sparse"``
parameter, ``kvstore.row_sparse_pull``).

Twins of every test in ``tests/test_sparse.py``, run on the same numpy
inputs through the JAX package and the port: dense values within rtol
1e-5 / atol 1e-6 (float32 sums in another order), index arrays and
untouched rows exactly.  Beyond them: the sparse-gradient embedding
trained two steps with momentum and weight decay (the port once updated
every row densely: row 0, never touched, went 0.5 -> 0.36), a multi-step
lazy-Adam Trainer run, ``contrib.nn.SparseEmbedding`` under SGD and
Adam, ``row_sparse_pull`` and ``dot`` with ``transpose_a``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import sparse as jsparse

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _rand_csr_dense(m=8, n=6, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.randn(m, n).astype(np.float32)
    dense[rng.rand(m, n) > density] = 0.0
    return dense


# ---------------------------------------------------------------------------
# tests/test_sparse.py
# ---------------------------------------------------------------------------
class TestCSR:
    def test_from_dense_roundtrip(self):
        dense = _rand_csr_dense()
        csr, jcsr = sparse.csr_matrix(dense), jsparse.csr_matrix(dense)
        assert csr.stype == jcsr.stype == "csr"
        assert csr.shape == jcsr.shape and csr.dtype == jcsr.dtype
        np.testing.assert_array_equal(csr.asnumpy(), jcsr.asnumpy())
        for name in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(
                getattr(csr, name).asnumpy(), getattr(jcsr, name).asnumpy())
        back = csr.tostype("default")
        assert back.stype == "default"
        np.testing.assert_array_equal(back.asnumpy(),
                                      jcsr.tostype("default").asnumpy())

    def test_from_components(self):
        comp = ([1., 2., 3.], [0, 2, 2], [0, 2, 3])
        csr = sparse.csr_matrix(comp, shape=(2, 3))
        jcsr = jsparse.csr_matrix(comp, shape=(2, 3))
        np.testing.assert_array_equal(csr.asnumpy(), jcsr.asnumpy())
        np.testing.assert_array_equal(csr.asnumpy(), [[1, 0, 2], [0, 0, 3]])
        np.testing.assert_array_equal(csr.indptr.asnumpy(),
                                      jcsr.indptr.asnumpy())

    def test_dot_vs_dense(self):
        a = _rand_csr_dense(10, 7, seed=1)
        b = np.random.RandomState(2).randn(7, 4).astype(np.float32)
        got = sparse.dot(sparse.csr_matrix(a), nd.array(b)).asnumpy()
        want = jsparse.dot(jsparse.csr_matrix(a), jnd.array(b)).asnumpy()
        _close(got, want)
        _close(got, a @ b, rtol=1e-5, atol=1e-5)

    def test_dot_transpose_a(self):
        a = _rand_csr_dense(10, 7, seed=3)
        b = np.random.RandomState(4).randn(10, 5).astype(np.float32)
        got = sparse.dot(sparse.csr_matrix(a), nd.array(b),
                         transpose_a=True).asnumpy()
        want = jsparse.dot(jsparse.csr_matrix(a), jnd.array(b),
                           transpose_a=True).asnumpy()
        _close(got, want)
        _close(got, a.T @ b, rtol=1e-5, atol=1e-5)

    def test_row_slice(self):
        dense = _rand_csr_dense(8, 5, seed=5)
        csr, jcsr = sparse.csr_matrix(dense), jsparse.csr_matrix(dense)
        sl, jsl = csr[2:6], jcsr[2:6]
        assert sl.stype == "csr" and sl.shape == jsl.shape
        np.testing.assert_array_equal(sl.asnumpy(), jsl.asnumpy())
        np.testing.assert_array_equal(sl.indptr.asnumpy(),
                                      jsl.indptr.asnumpy())
        np.testing.assert_array_equal(csr[-1].asnumpy(), jcsr[-1].asnumpy())
        np.testing.assert_array_equal(csr[-1].asnumpy(), dense[-1:])
        with pytest.raises(MXNetError):
            csr[8]
        with pytest.raises(jmx.MXNetError):
            jcsr[8]

    def test_dense_op_fallback(self):
        dense = _rand_csr_dense()
        got = nd.relu(sparse.csr_matrix(dense)).asnumpy()
        want = jnd.relu(jsparse.csr_matrix(dense)).asnumpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.maximum(dense, 0))

    def test_zeros(self):
        for stype, shape in (("csr", (3, 4)), ("row_sparse", (5, 2))):
            z, jz = sparse.zeros(stype, shape), jsparse.zeros(stype, shape)
            assert z.stype == jz.stype == stype
            np.testing.assert_array_equal(z.asnumpy(), jz.asnumpy())
            np.testing.assert_array_equal(z.asnumpy(), np.zeros(shape))


class TestRowSparse:
    def test_roundtrip_and_retain(self):
        dense = np.zeros((6, 3), np.float32)
        dense[1] = 1.0
        dense[4] = 2.0
        rsp, jrsp = sparse.row_sparse_array(dense), \
            jsparse.row_sparse_array(dense)
        assert rsp.stype == "row_sparse"
        np.testing.assert_array_equal(rsp.indices.asnumpy(),
                                      jrsp.indices.asnumpy())
        np.testing.assert_array_equal(rsp.indices.asnumpy(), [1, 4])
        np.testing.assert_array_equal(rsp.asnumpy(), jrsp.asnumpy())
        kept = sparse.retain(rsp, nd.array([4.0]))
        jkept = jsparse.retain(jrsp, jnd.array([4.0]))
        np.testing.assert_array_equal(kept.indices.asnumpy(),
                                      jkept.indices.asnumpy())
        np.testing.assert_array_equal(kept.asnumpy(), jkept.asnumpy())
        np.testing.assert_array_equal(kept.asnumpy()[1], 0.0)

    def test_from_components(self):
        comp = (np.ones((2, 3), np.float32), [0, 5])
        rsp = sparse.row_sparse_array(comp, shape=(7, 3))
        jrsp = jsparse.row_sparse_array(comp, shape=(7, 3))
        np.testing.assert_array_equal(rsp.asnumpy(), jrsp.asnumpy())
        assert rsp.asnumpy().sum() == 6.0

    def test_dense_tostype(self):
        eye = np.eye(4, dtype=np.float32)
        for stype in ("row_sparse", "csr"):
            got = nd.array(eye).tostype(stype)
            want = jnd.array(eye).tostype(stype)
            assert got.stype == want.stype == stype
            np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
            np.testing.assert_array_equal(got.indices.asnumpy(),
                                          want.indices.asnumpy())


def _grad(shape, rows, seed=0):
    g = np.zeros(shape, np.float32)
    g[rows] = np.random.RandomState(seed).randn(
        len(rows), shape[1]).astype(np.float32)
    return g


def _one_update(m, opt_name, kw, w0, grad, sparse_grad):
    opt = m.optimizer.create(opt_name, **kw)
    w = m.nd.array(w0)
    state = opt.create_state(0, w)
    g = m.nd.sparse.row_sparse_array(grad) if sparse_grad \
        else m.nd.array(grad)
    opt.update(0, w, g, state)
    return w.asnumpy(), state


class TestSparseOptimizer:
    def test_sgd_lazy_matches_dense_on_touched_rows(self):
        shape, rows = (10, 4), [2, 7]
        w0 = np.random.RandomState(1).randn(*shape).astype(np.float32)
        gd = _grad(shape, rows)
        kw = dict(learning_rate=0.1, momentum=0.9)
        lazy, _ = _one_update(mx, "sgd", kw, w0, gd, True)
        dense, _ = _one_update(mx, "sgd", kw, w0, gd, False)
        jlazy, _ = _one_update(jmx, "sgd", kw, w0, gd, True)
        _close(lazy, jlazy)
        _close(lazy, dense, rtol=1e-5, atol=1e-6)

    def test_sgd_lazy_untouched_rows_frozen(self):
        shape, rows = (10, 4), [0, 3]
        w0 = np.random.RandomState(2).randn(*shape).astype(np.float32)
        kw = dict(learning_rate=0.5, momentum=0.9, wd=0.1)
        out, state = _one_update(mx, "sgd", kw, w0, _grad(shape, rows),
                                 True)
        jout, jstate = _one_update(jmx, "sgd", kw, w0, _grad(shape, rows),
                                   True)
        untouched = [i for i in range(10) if i not in rows]
        np.testing.assert_array_equal(out[untouched], w0[untouched])
        np.testing.assert_array_equal(out[untouched], jout[untouched])
        np.testing.assert_array_equal(state.asnumpy()[untouched], 0.0)
        _close(out, jout)
        _close(state.asnumpy(), jstate.asnumpy())
        assert np.abs(out[rows] - w0[rows]).max() > 0

    def test_adam_lazy_converges(self):
        vocab, dim, steps = 50, 8, 800
        true_emb = np.random.RandomState(0).randn(vocab, dim) \
            .astype(np.float32)
        idx_rng = np.random.RandomState(0)
        batches = [np.unique(idx_rng.randint(0, vocab, size=8))
                   for _ in range(steps)]

        def run(m):
            opt = m.optimizer.create("adam", learning_rate=0.05)
            w = m.nd.array(np.zeros((vocab, dim), np.float32))
            state = opt.create_state(0, w)
            for uniq in batches:
                rows = w.asnumpy()[uniq] - true_emb[uniq]
                opt.update(0, w, m.nd.sparse.row_sparse_array(
                    (rows, uniq), shape=(vocab, dim)), state)
            return w.asnumpy()

        got, want = run(mx), run(jmx)
        assert np.abs(got - true_emb).mean() < 0.03
        _close(got, want, rtol=1e-4, atol=1e-5)


def _embedding_run(m, steps, opt_name, kw, init, make=None):
    """An embedding with a row-sparse gradient trained through a Trainer
    over ``steps`` (ids, weights of the loss): the weight after each
    step."""
    net = make(m) if make else m.gluon.nn.Embedding(20, 4, sparse_grad=True)
    net.initialize(init(m))
    trainer = m.gluon.Trainer(net.collect_params(), opt_name, kw)
    out = []
    for ids, coef in steps:
        x = m.nd.array(np.asarray(ids, np.float32))
        with m.autograd.record():
            loss = (net(x) * m.nd.array(coef)).sum()
        loss.backward()
        trainer.step(1)
        out.append(net.weight.data().asnumpy().copy())
    return out


class TestSparseEmbeddingTraining:
    def test_gluon_embedding_sparse_grad(self):
        steps = [([1, 5, 5], np.ones(4, np.float32))]
        kw = {"learning_rate": 1.0, "momentum": 0.0}

        def init(m):
            m.random.seed(0)
            return m.init.Constant(0.25)

        before = np.full((20, 4), 0.25, np.float32)
        (got,) = _embedding_run(mx, steps, "sgd", kw, init)
        (want,) = _embedding_run(jmx, steps, "sgd", kw, init)
        changed = np.abs(got - before).sum(axis=1) > 0
        assert changed[1] and changed[5]
        assert not changed[0] and not changed[19]
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the lazy Trainer path against the JAX package
# ---------------------------------------------------------------------------
def _const(value):
    return lambda m: m.init.Constant(value)


def test_sparse_grad_embedding_momentum_and_wd_two_steps():
    """The row-sparse gradient is compressed before the update, so
    untouched rows see no weight decay and no momentum (the JAX
    package's ``Trainer._update`` and lazy SGD)."""
    steps = [([1, 5, 5], np.ones(4, np.float32)),
             ([2, 3], np.ones(4, np.float32))]
    kw = {"learning_rate": 1.0, "momentum": 0.9, "wd": 0.1}
    got = _embedding_run(mx, steps, "sgd", kw, _const(0.5))
    want = _embedding_run(jmx, steps, "sgd", kw, _const(0.5))
    for g, w in zip(got, want):
        _close(g, w)
    final = got[-1]
    for row in (0, 4, 19):            # never touched
        np.testing.assert_array_equal(final[row], 0.5)
        np.testing.assert_array_equal(final[row], want[-1][row])
    # row 1 is touched in step 1 only: no momentum carries it in step 2
    np.testing.assert_array_equal(got[1][1], got[0][1])
    np.testing.assert_array_equal(final[1], want[-1][1])


def test_sparse_grad_embedding_lazy_adam_steps():
    rng = np.random.RandomState(7)
    steps = [(rng.randint(0, 20, size=rng.randint(2, 6)).tolist(),
              rng.randn(4).astype(np.float32)) for _ in range(6)]
    kw = {"learning_rate": 0.1, "wd": 0.01, "lazy_update": True}
    got = _embedding_run(mx, steps, "adam", kw, _const(0.5))
    want = _embedding_run(jmx, steps, "adam", kw, _const(0.5))
    seen = set()
    for (ids, _c), g, w in zip(steps, got, want):
        seen.update(ids)
        _close(g, w, rtol=1e-5, atol=1e-6)
        untouched = [r for r in range(20) if r not in seen]
        np.testing.assert_array_equal(g[untouched], 0.5)
        np.testing.assert_array_equal(g[untouched], w[untouched])


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {"learning_rate": 1.0, "momentum": 0.9, "wd": 0.05}),
    ("adam", {"learning_rate": 0.05})])
def test_sparse_embedding_contrib_trains_only_touched_rows(opt_name, kw):
    from mxnet_tpu.gluon.contrib import nn as jcnn
    from mxnet_tpu_torch.gluon.contrib import nn as cnn
    steps = [([2, 7, 7], np.array([1, -1, 2, 0.5], np.float32)),
             ([7, 11], np.array([0.5, 1, -1, 2], np.float32))]

    def make(m):
        return (cnn if m is mx else jcnn).SparseEmbedding(20, 4)

    got = _embedding_run(mx, steps, opt_name, kw, _const(0.3), make)
    want = _embedding_run(jmx, steps, opt_name, kw, _const(0.3), make)
    for g, w in zip(got, want):
        _close(g, w)
    untouched = [r for r in range(20) if r not in (2, 7, 11)]
    np.testing.assert_array_equal(got[-1][untouched], np.float32(0.3))
    assert np.abs(got[-1][[2, 7, 11]] - np.float32(0.3)).min() > 0


def test_sparse_grad_parameter_stays_off_the_fused_tiers():
    net = gluon.nn.Embedding(20, 4, sparse_grad=True)
    net.initialize(mx.init.Constant(0.5))
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.1})
    assert not trainer._fused_eligible()
    x = nd.array(np.array([3, 4], np.float32))
    with autograd.record():
        net(x).sum().backward()
    trainer.step(1)
    assert trainer.fused_stats()["update_programs"] == 0


# ---------------------------------------------------------------------------
# kvstore.row_sparse_pull, dot with transpose_a, host reads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["local", "device"])
def test_kvstore_row_sparse_pull(kind):
    """The rows of the stored value, on ``out``'s device in its dtype.
    (The JAX package's method zips each key's ``(key, row_ids)`` pair
    with its outputs and raises AttributeError on any call, so the port
    is held to the gathered rows of the stored value, its documented
    result; the refusal without ``out`` / ``row_ids`` is the JAX
    package's.)"""
    value = np.arange(24, dtype=np.float32).reshape(6, 4)
    rows = np.array([4, 1, 5], np.int32)
    kv = mx.kvstore.create(kind)
    kv.init("w", nd.array(value))
    out = nd.zeros((3, 4))
    kv.row_sparse_pull("w", out=out, row_ids=nd.array(rows, dtype="int32"))
    np.testing.assert_array_equal(out.asnumpy(), value[rows])
    jkv = jmx.kvstore.create(kind)
    jkv.init("w", jnd.array(value))
    np.testing.assert_array_equal(jkv._store["w"].asnumpy()[rows],
                                  out.asnumpy())
    outs = [nd.zeros((2, 4)), nd.zeros((1, 4), dtype="float64")]
    ids = [nd.array([0, 5], dtype="int32"), nd.array([3], dtype="int32")]
    kv.row_sparse_pull("w", out=outs, row_ids=ids)
    np.testing.assert_array_equal(outs[0].asnumpy(), value[[0, 5]])
    np.testing.assert_array_equal(outs[1].asnumpy(), value[[3]])
    assert outs[1].dtype == np.float64
    for bad in (dict(out=out), dict(row_ids=ids[0])):
        with pytest.raises(MXNetError, match="row_sparse_pull"):
            kv.row_sparse_pull("w", **bad)
        with pytest.raises(jmx.MXNetError, match="row_sparse_pull"):
            jkv.row_sparse_pull("w", **bad)


@pytest.mark.parametrize("shape,k", [((12, 9), 5), ((40, 30), 16)])
def test_sparse_dot_transpose_a_against_jax(shape, k):
    a = _rand_csr_dense(*shape, density=0.2, seed=shape[0])
    rng = np.random.RandomState(k)
    for transpose_a in (False, True):
        rhs = rng.randn(shape[0] if transpose_a else shape[1], k) \
            .astype(np.float32)
        got = sparse.dot(sparse.csr_matrix(a), nd.array(rhs),
                         transpose_a=transpose_a)
        want = jsparse.dot(jsparse.csr_matrix(a), jnd.array(rhs),
                           transpose_a=transpose_a)
        assert got.shape == want.shape
        _close(got.asnumpy(), want.asnumpy())
    # a dense lhs goes to the dense dot, as in the JAX package
    rhs = rng.randn(shape[0], k).astype(np.float32)
    _close(sparse.dot(nd.array(a), nd.array(rhs), transpose_a=True)
           .asnumpy(), jsparse.dot(jnd.array(a), jnd.array(rhs),
                                   transpose_a=True).asnumpy())
    with pytest.raises(MXNetError, match="transpose_b"):
        sparse.dot(sparse.csr_matrix(a), nd.array(rhs), transpose_b=True)


def test_sparse_arrays_refuse_writes_and_keep_components():
    rsp = sparse.row_sparse_array(_grad((6, 3), [1, 4]))
    with pytest.raises(MXNetError, match="row_sparse"):
        rsp._set_data(nd.zeros((6, 3)))
    with pytest.raises(MXNetError, match="copyto"):
        rsp.copyto(nd.zeros((6, 3)))
    with pytest.raises(MXNetError):
        sparse.array(nd.zeros((2, 2)))
    dup = sparse.array(rsp)
    assert dup is not rsp and dup.stype == "row_sparse"
    np.testing.assert_array_equal(dup.asnumpy(), rsp.asnumpy())
    # duplicate stored rows add up in the dense form, as in the JAX
    # package
    comp = (np.ones((3, 2), np.float32), [1, 1, 2])
    np.testing.assert_array_equal(
        sparse.row_sparse_array(comp, shape=(4, 2)).asnumpy(),
        jsparse.row_sparse_array(comp, shape=(4, 2)).asnumpy())
    half = rsp.astype("float16")
    assert half.dtype == np.float16 and half.stype == "row_sparse"
    assert nd.sparse.CSRNDArray is sparse.CSRNDArray
    assert nd.RowSparseNDArray is sparse.RowSparseNDArray
    x = nd.ones((2, 3))
    x.attach_grad(stype="row_sparse")
    assert x.grad.stype == "default"


class _CudaStandIn:
    """A tensor stand-in that says it lives on the card."""

    is_cuda = True

    def __init__(self, value):
        self.value = torch.as_tensor(value)

    def detach(self):
        return self.value


def test_host_reads_are_counted_and_refused_under_capture(monkeypatch):
    before = sparse.HOST_SYNCS["retain"]
    total = sum(sparse.HOST_SYNCS.values())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    got = sparse._host_read(_CudaStandIn([1, 0, 1]), "retain")
    np.testing.assert_array_equal(got, [1, 0, 1])
    assert sparse.HOST_SYNCS["retain"] == before + 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(MXNetError, match=r"tostype\('row_sparse'\).*"
                                         r"captured CUDA graph"):
        sparse._host_read(_CudaStandIn([1]), "tostype('row_sparse')")
    assert sparse.HOST_SYNCS["retain"] == before + 1
    # host tensors are read without a count
    sparse.row_sparse_array(nd.array(_grad((5, 2), [3])))
    assert sum(sparse.HOST_SYNCS.values()) == total + 1
