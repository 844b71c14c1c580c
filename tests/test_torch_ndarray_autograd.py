"""PyTorch port, NDArray, the op registry and autograd
(``mxnet_tpu_torch/{ndarray,ops/registry,ops/tensor,ops/nn,autograd}``).

Twins of ``tests/test_autograd.py`` through
``test_retain_graph_hybrid_block_second_backward`` (less
``test_rnn_op_grad_flows``: the RNN op waits), with
``test_eager_dropout_backward_mask_matches_forward``, and of the
``tests/test_ndarray.py`` tests whose ops this slice ports (not the
Correlation op nor the legacy ``.params`` container).  The numeric
gradient harness of ``mxnet_tpu.test_utils`` is a central difference
here.

Against the JAX package, on the same seeded numpy inputs: a sweep of the
ported ops (forward, and the gradient of ``sum(out * cot)``) within
1e-5; ``grad_req`` write / add and ``create_graph`` second order;
``nd.flash_selfatt`` under ``autograd.record`` (the port's plain
version on the CPU) against the JAX op run in the Pallas interpreter, as
``tests/test_pallas.py`` runs it, forward and qkv gradient within 1e-5;
and ``nd._contrib_ragged_paged_attention`` against the JAX registry op
within 1e-5.  ``nd.save`` files load in the other package.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3):
    """Autograd gradients of ``sum(fn(*inputs))`` against central
    differences in float64 on the host."""
    arrs = [nd.array(np.asarray(x, np.float32)) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = fn(*arrs).sum()
    out.backward()
    for i, x in enumerate(inputs):
        x = np.asarray(x, np.float64)
        num = np.zeros_like(x)
        for j in range(x.size):
            for sign in (1, -1):
                xp = x.copy()
                xp.flat[j] += sign * eps
                args = [nd.array(np.asarray(v, np.float32)) if k != i
                        else nd.array(xp.astype(np.float32))
                        for k, v in enumerate(inputs)]
                num.flat[j] += sign * float(fn(*args).sum().asscalar())
        num /= 2 * eps
        np.testing.assert_allclose(arrs[i].grad.asnumpy(), num, rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# tests/test_autograd.py
# ---------------------------------------------------------------------------
def test_simple_grad():
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    y.backward()
    assert_almost_equal(x.grad.asnumpy(), 2 * x.asnumpy())


def test_chain_rule():
    x = nd.array([[1.0, 2.0], [3.0, 4.0]])
    x.attach_grad()
    with autograd.record():
        y = nd.exp(x)
        z = (y * 2).sum()
    z.backward()
    assert_almost_equal(x.grad.asnumpy(), 2 * np.exp(x.asnumpy()), rtol=1e-5)


def test_two_inputs():
    a = nd.array([1.0, 2.0])
    b = nd.array([3.0, 4.0])
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        c = (a * b).sum()
    c.backward()
    assert_almost_equal(a.grad.asnumpy(), b.asnumpy())
    assert_almost_equal(b.grad.asnumpy(), a.asnumpy())


def test_reused_input():
    x = nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        y = x * x + x
    y.backward()
    assert_almost_equal(x.grad.asnumpy(), [5.0])


def test_dot_grad():
    rs = np.random.RandomState(0)
    a = nd.array(rs.rand(3, 4).astype(np.float32))
    b = nd.array(rs.rand(4, 2).astype(np.float32))
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        c = nd.dot(a, b).sum()
    c.backward()
    assert_almost_equal(a.grad.asnumpy(), np.ones((3, 2)) @ b.asnumpy().T,
                        rtol=1e-5)
    assert_almost_equal(b.grad.asnumpy(), a.asnumpy().T @ np.ones((3, 2)),
                        rtol=1e-5)


def test_head_gradient():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = x * 3
    y.backward(nd.array([10.0, 20.0]))
    assert_almost_equal(x.grad.asnumpy(), [30.0, 60.0])


def test_pause_scope():
    x = nd.array([1.0])
    x.attach_grad()
    with autograd.record():
        y = x * 2
        with autograd.pause():
            z = x * 100
        w = y + z.detach()
    w.backward()
    assert_almost_equal(x.grad.asnumpy(), [2.0])
    assert autograd.is_recording() is False


def test_train_predict_mode():
    assert not autograd.is_training()
    with autograd.record(train_mode=True):
        assert autograd.is_training()
        with autograd.predict_mode():
            assert not autograd.is_training()
    with autograd.record(train_mode=False):
        assert not autograd.is_training()


def test_grad_req_add():
    x = nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with autograd.record():
            y = (x * x).sum()
        y.backward()
    assert_almost_equal(x.grad.asnumpy(), 4 * x.asnumpy())
    x.zero_grad()
    assert_almost_equal(x.grad.asnumpy(), [0, 0])


def test_autograd_grad_function():
    x = nd.array([2.0, 3.0])
    with autograd.record():
        y = (x * x).sum()
    gx = autograd.grad(y, [x], create_graph=False)[0]
    assert_almost_equal(gx.asnumpy(), 2 * x.asnumpy())


def test_detach_cuts_graph():
    x = nd.array([1.0])
    x.attach_grad()
    with autograd.record():
        y = x * 2
        z = y.detach() * 3
        w = y + z
    w.backward()
    assert_almost_equal(x.grad.asnumpy(), [2.0])


def test_multi_output_op_grad():
    x = nd.array(np.random.RandomState(1).rand(4, 6).astype(np.float32))
    x.attach_grad()
    with autograd.record():
        parts = nd.split(x, num_outputs=2, axis=1)
        loss = (parts[0] * 2).sum() + (parts[1] * 3).sum()
    loss.backward()
    expected = np.concatenate([2 * np.ones((4, 3)), 3 * np.ones((4, 3))],
                              axis=1)
    assert_almost_equal(x.grad.asnumpy(), expected)


def test_nondifferentiable_cuts_tape():
    x = nd.array([1.0, 5.0, 3.0])
    x.attach_grad()
    with autograd.record():
        idx = nd.argmax(x)
        y = (x * 2).sum() + idx
    y.backward()
    assert_almost_equal(x.grad.asnumpy(), [2.0, 2.0, 2.0])


def test_softmax_output_loss_grad():
    data = nd.array(np.random.RandomState(2).rand(4, 10).astype(np.float32))
    label = nd.array([1, 2, 3, 4])
    data.attach_grad()
    with autograd.record():
        out = nd.SoftmaxOutput(data, label)
    out.backward()
    p = np.exp(data.asnumpy()) / np.exp(data.asnumpy()).sum(1, keepdims=True)
    oh = np.eye(10)[label.asnumpy().astype(int)]
    assert_almost_equal(data.grad.asnumpy(), p - oh, rtol=1e-4, atol=1e-5)


def test_custom_function():
    class MyClip(autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return nd.clip(x, a_min=-1.0, a_max=1.0)

        def backward(self, dy):
            x, = self.saved_tensors
            mask = (x.asnumpy() > -1) & (x.asnumpy() < 1)
            return dy * nd.array(mask.astype(np.float32))

    f = MyClip()
    x = nd.array([-2.0, 0.5, 2.0])
    x.attach_grad()
    with autograd.record():
        y = f(x)
        loss = y.sum()
    loss.backward()
    assert_almost_equal(x.grad.asnumpy(), [0.0, 1.0, 0.0])


def test_numeric_gradient_harness():
    rs = np.random.RandomState(3)
    check_numeric_gradient(lambda x: nd.tanh(x), [rs.rand(3, 3) * 0.5])
    check_numeric_gradient(lambda a, b: nd.dot(a, b),
                           [rs.rand(2, 3), rs.rand(3, 2)])
    check_numeric_gradient(lambda x: nd.Activation(x, act_type="sigmoid"),
                           [rs.rand(4, 4)])


def test_grad_create_graph_second_order():
    x = nd.array([1.0, 2.0, -3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x * x).sum()
        gx = autograd.grad(y, [x], create_graph=True)[0]
        gsum = gx.sum()
    gsum.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 6 * x.asnumpy(), rtol=1e-5)


def test_grad_create_graph_third_order():
    x = nd.array([0.5, 2.0])
    x.attach_grad()
    with autograd.record():
        y = (x ** 4).sum()
        g1 = autograd.grad(y, [x], create_graph=True)[0]
        g2 = autograd.grad(g1.sum(), [x], create_graph=True)[0]
        g3sum = g2.sum()
    g3sum.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 24 * x.asnumpy(), rtol=1e-5)


def test_grad_create_graph_sin():
    x = nd.array([0.3, 1.2, -0.7])
    x.attach_grad()
    with autograd.record():
        y = nd.sin(x).sum()
        gx = autograd.grad(y, [x], create_graph=True)[0]
        gsum = gx.sum()
    gsum.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), -np.sin(x.asnumpy()),
                               rtol=1e-5, atol=1e-6)


def test_grad_create_graph_gradient_penalty():
    x = nd.array([[1.0, 2.0], [3.0, 4.0]])
    w = nd.array([[0.5], [0.25]])
    w.attach_grad()
    x.attach_grad()
    with autograd.record():
        y = nd.dot(x, w).sum()
        gx = autograd.grad(y, [x], create_graph=True)[0]
        penalty = (gx * gx).sum()
        loss = y + penalty
    loss.backward()
    expect = x.asnumpy().sum(0)[:, None] + 4 * w.asnumpy()
    np.testing.assert_allclose(w.grad.asnumpy(), expect, rtol=1e-5)


def test_grad_create_graph_mixed_partials():
    x = nd.array([1.5, -2.0])
    y = nd.array([2.0, 3.0])
    x.attach_grad()
    y.attach_grad()
    with autograd.record():
        f = (x * x * y).sum()
        gx = autograd.grad(f, [x], create_graph=True)[0]
        gsum = gx.sum()
    gsum.backward()
    np.testing.assert_allclose(y.grad.asnumpy(), 2 * x.asnumpy(), rtol=1e-5)


def test_grad_create_graph_leaf_head():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    g = autograd.grad(x, [x], create_graph=True)
    np.testing.assert_allclose(g[0].asnumpy(), [1.0, 1.0])


def test_grad_create_graph_dropout_train_mode():
    mx.random.seed(7)
    x = nd.ones((64,))
    x.attach_grad()
    with autograd.record():
        y = nd.Dropout(x, p=0.5).sum()
    gx = autograd.grad(y, [x], create_graph=True)[0]
    y.backward()
    np.testing.assert_allclose(gx.asnumpy(), x.grad.asnumpy())
    vals = set(np.unique(gx.asnumpy()))
    assert vals <= {0.0, 2.0} and 2.0 in vals


def test_grad_create_graph_duplicate_variables():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    g = autograd.grad(y, [x, x], create_graph=True)
    np.testing.assert_allclose(g[0].asnumpy(), [2.0, 4.0])
    np.testing.assert_allclose(g[1].asnumpy(), [2.0, 4.0])


def test_grad_create_graph_leaf_head_no_attach():
    x = nd.array([1.0, 2.0])
    g = autograd.grad(x, [x], create_graph=True)
    np.testing.assert_allclose(g[0].asnumpy(), [1.0, 1.0])


def test_grad_create_graph_recorded_head_grads_raise():
    x = nd.array([1.0, 2.0])
    w = nd.array([3.0, 4.0])
    x.attach_grad()
    w.attach_grad()
    with autograd.record():
        y = x * w
        hg = w * 2
    with pytest.raises(MXNetError):
        autograd.grad(y, [x], head_grads=hg, create_graph=True)


def test_grad_create_graph_nonleaf_variable_raises():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        z = x * 2
        y = (z * z).sum()
    with pytest.raises(MXNetError):
        autograd.grad(y, [z], create_graph=True)


def test_grad_create_graph_custom_function_raises():
    class Square(autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 2 * x * dy

    sq = Square()
    x = nd.array([1.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = sq(x).sum()
    with pytest.raises(MXNetError):
        autograd.grad(y, [x], create_graph=True)


def test_retain_graph_second_backward_not_accumulated():
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    y.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    y.backward()
    g2 = x.grad.asnumpy()
    assert np.allclose(g1, [2.0, 4.0, 6.0])
    assert np.allclose(g2, g1)


def test_retain_graph_hybrid_block_second_backward():
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(3, in_units=4)
    net.initialize()
    net.hybridize(static_alloc=True)
    x = nd.random.uniform(shape=(2, 4))
    x.attach_grad()
    with autograd.record():
        y = net(x).sum()
    y.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    y.backward()
    assert np.allclose(x.grad.asnumpy(), g1, rtol=1e-5)


def test_eager_dropout_backward_mask_matches_forward():
    mx.random.seed(0)
    x = nd.ones((4000,))
    x.attach_grad()
    with autograd.record():
        y = nd.Dropout(x, p=0.5, mode="always")
    y.backward()
    yv, g = y.asnumpy(), x.grad.asnumpy()
    assert ((yv != 0) == (g != 0)).all()
    assert np.allclose(g[g != 0], 2.0)


def test_without_record_nothing_is_taped():
    """Ops outside ``record()`` build no graph, also on an attached
    array."""
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 3
    assert y._data.grad_fn is None
    with pytest.raises(MXNetError, match="record"):
        y.backward()


# ---------------------------------------------------------------------------
# tests/test_ndarray.py
# ---------------------------------------------------------------------------
def test_creation():
    a = nd.array([[1, 2], [3, 4]])
    assert a.shape == (2, 2)
    assert a.dtype == np.float32
    assert np.allclose(a.asnumpy(), [[1, 2], [3, 4]])
    z = nd.zeros((3, 4))
    assert z.shape == (3, 4) and z.asnumpy().sum() == 0
    o = nd.ones((2,), dtype="int32")
    assert o.dtype == np.int32
    f = nd.full((2, 2), 7.0)
    assert (f.asnumpy() == 7).all()
    r = nd.arange(0, 10, 2)
    assert np.allclose(r.asnumpy(), [0, 2, 4, 6, 8])


def test_arithmetic():
    a = nd.array([1.0, 2.0, 3.0])
    b = nd.array([4.0, 5.0, 6.0])
    assert np.allclose((a + b).asnumpy(), [5, 7, 9])
    assert np.allclose((a - b).asnumpy(), [-3, -3, -3])
    assert np.allclose((a * b).asnumpy(), [4, 10, 18])
    assert np.allclose((b / a).asnumpy(), [4, 2.5, 2])
    assert np.allclose((a + 1).asnumpy(), [2, 3, 4])
    assert np.allclose((1 + a).asnumpy(), [2, 3, 4])
    assert np.allclose((10 - a).asnumpy(), [9, 8, 7])
    assert np.allclose((a ** 2).asnumpy(), [1, 4, 9])
    assert np.allclose((2 / a).asnumpy(), [2, 1, 2 / 3])
    assert np.allclose((-a).asnumpy(), [-1, -2, -3])


def test_inplace_arithmetic():
    a = nd.array([1.0, 2.0])
    a += 1
    assert np.allclose(a.asnumpy(), [2, 3])
    a *= 2
    assert np.allclose(a.asnumpy(), [4, 6])


def test_comparison():
    a = nd.array([1.0, 2.0, 3.0])
    b = nd.array([2.0, 2.0, 2.0])
    assert np.allclose((a > b).asnumpy(), [0, 0, 1])
    assert np.allclose((a >= b).asnumpy(), [0, 1, 1])
    assert np.allclose((a == b).asnumpy(), [0, 1, 0])
    assert np.allclose((a < 2).asnumpy(), [1, 0, 0])


def test_indexing():
    a = nd.array(np.arange(24).reshape(2, 3, 4))
    assert a[0].shape == (3, 4)
    assert a[0, 1, 2].asscalar() == 6
    assert a[:, 1].shape == (2, 4)
    assert a[0, :, 1:3].shape == (3, 2)
    a[0, 0, 0] = 100
    assert a[0, 0, 0].asscalar() == 100
    idx = nd.array([0, 1], dtype="int32")
    assert a[idx].shape == (2, 3, 4)


def test_shape_methods():
    a = nd.array(np.arange(24).reshape(2, 3, 4))
    assert a.reshape(6, 4).shape == (6, 4)
    assert a.reshape((-1,)).shape == (24,)
    assert a.reshape(0, -1).shape == (2, 12)
    assert a.transpose().shape == (4, 3, 2)
    assert a.transpose((1, 0, 2)).shape == (3, 2, 4)
    assert a.flatten().shape == (2, 12)
    assert a.expand_dims(0).shape == (1, 2, 3, 4)
    assert a.expand_dims(0).squeeze(0).shape == (2, 3, 4)
    assert a.T.shape == (4, 3, 2)


def test_reductions():
    a = nd.array([[1.0, 2.0], [3.0, 4.0]])
    assert a.sum().asscalar() == 10
    assert np.allclose(a.sum(axis=0).asnumpy(), [4, 6])
    assert np.allclose(a.mean(axis=1).asnumpy(), [1.5, 3.5])
    assert a.max().asscalar() == 4
    assert a.min().asscalar() == 1
    assert np.allclose(a.argmax(axis=1).asnumpy(), [1, 1])
    assert abs(a.norm().asscalar() - np.sqrt(30)) < 1e-5


def test_dot():
    rs = np.random.RandomState(4)
    a = nd.array(rs.rand(3, 4))
    b = nd.array(rs.rand(4, 5))
    c = nd.dot(a, b)
    assert c.shape == (3, 5)
    assert np.allclose(c.asnumpy(), a.asnumpy() @ b.asnumpy(), atol=1e-5)
    c2 = nd.dot(a, b.T, transpose_b=True)
    assert np.allclose(c2.asnumpy(), c.asnumpy(), atol=1e-5)


def test_batch_dot():
    rs = np.random.RandomState(5)
    a = nd.array(rs.rand(2, 3, 4))
    b = nd.array(rs.rand(2, 4, 5))
    c = nd.batch_dot(a, b)
    assert c.shape == (2, 3, 5)
    assert np.allclose(c.asnumpy(), a.asnumpy() @ b.asnumpy(), atol=1e-5)


def test_concat_split_stack():
    a = nd.ones((2, 3))
    b = nd.zeros((2, 3))
    assert nd.concat(a, b, dim=0).shape == (4, 3)
    assert nd.concat(a, b, dim=1).shape == (2, 6)
    assert nd.stack(a, b, axis=0).shape == (2, 2, 3)
    parts = nd.split(nd.concat(a, b, dim=0), num_outputs=2, axis=0)
    assert len(parts) == 2 and parts[0].shape == (2, 3)


def test_broadcast_ops():
    a = nd.array([[1.0], [2.0]])
    b = nd.array([[10.0, 20.0]])
    c = nd.broadcast_add(a, b)
    assert c.shape == (2, 2)
    assert np.allclose(c.asnumpy(), [[11, 21], [12, 22]])
    assert nd.broadcast_to(a, shape=(2, 3)).shape == (2, 3)


def test_take_pick_onehot():
    w = nd.array(np.arange(12).reshape(4, 3))
    idx = nd.array([0, 2], dtype="int32")
    t = nd.take(w, idx)
    assert t.shape == (2, 3)
    assert np.allclose(t.asnumpy(), [[0, 1, 2], [6, 7, 8]])
    data = nd.array([[0.1, 0.9], [0.8, 0.2]])
    p = nd.pick(data, nd.array([1, 0]))
    assert np.allclose(p.asnumpy(), [0.9, 0.8])
    oh = nd.one_hot(nd.array([0, 2]), depth=3)
    assert np.allclose(oh.asnumpy(), [[1, 0, 0], [0, 0, 1]])


def test_topk_sort():
    a = nd.array([3.0, 1.0, 2.0])
    assert np.allclose(nd.topk(a, k=2, ret_typ="value").asnumpy(), [3, 2])
    assert np.allclose(nd.sort(a).asnumpy(), [1, 2, 3])
    assert np.allclose(nd.argsort(a).asnumpy(), [1, 2, 0])


def test_astype_cast():
    a = nd.array([1.5, 2.5])
    assert a.astype("int32").dtype == np.int32
    assert nd.cast(a, dtype="float16").dtype == np.float16


def test_save_load(tmp_path):
    fname = str(tmp_path / "arrays.npz")
    nd.save(fname, {"w": nd.array([1.0, 2.0]), "b": nd.ones((2, 2))})
    loaded = nd.load(fname)
    assert set(loaded) == {"w", "b"}
    assert np.allclose(loaded["w"].asnumpy(), [1, 2])
    nd.save(fname, [nd.array([3.0])])
    lst = nd.load(fname)
    assert isinstance(lst, list) and np.allclose(lst[0].asnumpy(), [3])


def test_context_placement():
    a = nd.ones((2, 2), ctx=mx.cpu(0))
    assert a.context.device_type == "cpu"
    assert a.as_in_context(mx.cpu(0)) is a
    c = a.copyto(mx.cpu(0))
    assert c is not a
    # another CPU context is a copy of its own, never an alias
    d = a.as_in_context(mx.cpu(1))
    assert d.context == mx.cpu(1)
    assert d._data.data_ptr() != a._data.data_ptr()


def test_waitall_and_wait_to_read():
    a = nd.random.uniform(shape=(100, 100))
    b = nd.dot(a, a)
    b.wait_to_read()
    mx.waitall()


def test_numpy_interop():
    a = nd.array([1.0, 2.0])
    assert isinstance(np.asarray(a), np.ndarray)
    assert float(a.sum()) == 3.0
    assert a.tolist() == [1.0, 2.0]


def test_random_ops():
    mx.random.seed(0)
    u = nd.random.uniform(0, 1, shape=(1000,))
    assert 0.4 < u.asnumpy().mean() < 0.6
    n = nd.random.normal(0, 1, shape=(1000,))
    assert abs(n.asnumpy().mean()) < 0.2
    r = nd.random.randint(0, 10, shape=(100,))
    assert r.asnumpy().min() >= 0 and r.asnumpy().max() < 10
    mx.random.seed(7)
    x1 = nd.random.uniform(shape=(5,)).asnumpy()
    mx.random.seed(7)
    x2 = nd.random.uniform(shape=(5,)).asnumpy()
    assert np.allclose(x1, x2)


# ---------------------------------------------------------------------------
# the default context is the card, with no fallback
# ---------------------------------------------------------------------------
def test_default_context_is_the_card(monkeypatch):
    assert mx.cpu(0) == mx.current_context()     # the fixture's scope
    with mx.gpu(0):
        assert mx.current_context() == mx.gpu(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mx.context.Context._default_ctx.value == mx.cpu(0)
    mx.context.Context._default_ctx.value = None
    try:
        assert mx.current_context() == mx.gpu(0)
        with pytest.raises(MXNetError, match="no device"):
            nd.zeros((2,))
        with pytest.raises(MXNetError, match="no device"):
            nd.array([1.0])
    finally:
        mx.context.Context._default_ctx.value = mx.cpu(0)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _r(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


OP_CASES = [
    ("exp", [_r((3, 4), 1)], {}),
    ("log", [_r((3, 4), 2, 0.5, 2.0)], {}),
    ("sqrt", [_r((3, 4), 3, 0.5, 2.0)], {}),
    ("tanh", [_r((3, 4), 4)], {}),
    ("sigmoid", [_r((3, 4), 5)], {}),
    ("relu", [_r((3, 4), 6)], {}),
    ("erf", [_r((3, 4), 7)], {}),
    ("broadcast_mul", [_r((3, 1), 8), _r((1, 4), 9)], {}),
    ("broadcast_div", [_r((3, 4), 10), _r((3, 4), 11, 0.5, 1.5)], {}),
    ("broadcast_maximum", [_r((3, 4), 12), _r((3, 4), 13)], {}),
    ("_power_scalar", [_r((3, 4), 14, 0.5, 1.5)], {"scalar": 3.0}),
    ("sum", [_r((3, 4, 5), 15)], {"axis": (0, 2), "keepdims": True}),
    ("mean", [_r((3, 4, 5), 16)], {"axis": 1}),
    ("max", [_r((3, 4), 17)], {"axis": 1}),
    ("norm", [_r((3, 4), 18)], {}),
    ("dot", [_r((3, 4), 19), _r((5, 4), 20)], {"transpose_b": True}),
    ("batch_dot", [_r((2, 3, 4), 21), _r((2, 4, 5), 22)], {}),
    ("reshape", [_r((2, 3, 4), 23)], {"shape": (0, -3)}),
    ("transpose", [_r((2, 3, 4), 24)], {"axes": (1, 0, 2)}),
    ("concat", [_r((2, 3), 25), _r((2, 2), 26)], {"dim": 1}),
    ("slice_axis", [_r((4, 6), 27)], {"axis": 1, "begin": 1, "end": 4}),
    ("take", [_r((5, 3), 28), np.array([0, 4, 2], np.float32)], {}),
    ("pick", [_r((4, 5), 29), np.array([1, 0, 4, 2], np.float32)], {}),
    ("softmax", [_r((3, 5), 30)], {"axis": -1}),
    ("log_softmax", [_r((3, 5), 31)], {}),
    ("FullyConnected", [_r((4, 6), 32), _r((3, 6), 33), _r((3,), 34)],
     {"num_hidden": 3}),
    ("Convolution", [_r((2, 3, 6, 6), 35), _r((4, 3, 3, 3), 36),
                     _r((4,), 37)],
     {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1), "stride": (2, 2)}),
    ("Deconvolution", [_r((2, 4, 4, 4), 38), _r((4, 2, 3, 3), 39)],
     {"kernel": (3, 3), "num_filter": 2, "stride": (2, 2), "pad": (1, 1),
      "adj": (1, 1)}),
    ("Pooling", [_r((2, 3, 6, 6), 40)],
     {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}),
    ("Pooling", [_r((2, 3, 6, 6), 41)],
     {"kernel": (3, 3), "stride": (1, 1), "pool_type": "avg",
      "pad": (1, 1)}),
    ("LayerNorm", [_r((3, 8), 42), _r((8,), 43), _r((8,), 44)], {}),
    ("GroupNorm", [_r((2, 4, 3, 3), 45), _r((4,), 46), _r((4,), 47)],
     {"num_groups": 2}),
    ("LeakyReLU", [_r((3, 4), 48)], {"act_type": "elu", "slope": 1.0}),
    ("_contrib_gelu_erf", [_r((3, 4), 49)], {}),
    ("_contrib_gelu_tanh", [_r((3, 4), 50)], {}),
    ("Embedding", [np.array([[1, 3], [0, 2]], np.float32), _r((4, 5), 51)],
     {"input_dim": 4, "output_dim": 5}),
    ("where", [np.array([1, 0, 1], np.float32), _r((3,), 52),
               _r((3,), 53)], {}),
    ("clip", [_r((3, 4), 54)], {"a_min": -0.5, "a_max": 0.5}),
]


def _run_op(mod, ndm, name, inputs, kwargs, diff):
    arrs = [ndm.array(x) for x in inputs]
    for a in arrs[:diff]:
        a.attach_grad()
    with mod.autograd.record():
        out = getattr(ndm, name)(*arrs, **kwargs)
        cot = ndm.array(_r(out.shape, 99))
        loss = (out * cot).sum()
    loss.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in arrs[:diff]]


_INT_INPUTS = {"take": 1, "pick": 1, "Embedding": 0, "where": 0}


@pytest.mark.parametrize("case", range(len(OP_CASES)),
                         ids=[f"{c[0]}{i}" for i, c in enumerate(OP_CASES)])
def test_op_matches_jax(case):
    """Forward within 1e-5 and the gradients of ``sum(out * cot)`` with
    respect to the float inputs within 1e-5."""
    name, inputs, kwargs = OP_CASES[case]
    diff = _INT_INPUTS.get(name, len(inputs))
    (ours, og), (ref, rg) = [_run_op(m, n, name, inputs, kwargs, diff)
                             for m, n in ((mx, nd), (jmx, jnd))]
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(og, rg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_grad_req_and_second_order_match_jax():
    x0 = _r((5,), 60)
    res = []
    for mod, ndm in ((mx, nd), (jmx, jnd)):
        x = ndm.array(x0)
        x.attach_grad(grad_req="add")
        for _ in range(2):
            with mod.autograd.record():
                y = (ndm.sin(x) * x).sum()
            y.backward()
        acc = x.grad.asnumpy()
        z = ndm.array(x0)
        z.attach_grad()
        with mod.autograd.record():
            f = (z * z * z).sum()
            g = mod.autograd.grad(f, [z], create_graph=True)[0]
            h = (g * g).sum()
        h.backward()
        res.append((acc, z.grad.asnumpy()))
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_flash_selfatt_through_nd_matches_jax():
    """``nd.flash_selfatt`` under ``record``: the port's plain version
    against the JAX Pallas op in interpret mode, output and qkv
    gradient; the mask-free op too."""
    L, B, H, D = 16, 3, 2, 8
    qkv0 = _r((L, B, H * 3 * D), 70)
    valid0 = np.array([16, 9, 13], np.float32)
    cot0 = _r((L, B, H * D), 71)
    res = []
    for mod, ndm in ((mx, nd), (jmx, jnd)):
        qkv = ndm.array(qkv0)
        qkv.attach_grad()
        with mod.autograd.record():
            out = ndm.flash_selfatt(qkv, ndm.array(valid0), heads=H)
            loss = (out * ndm.array(cot0)).sum()
        loss.backward()
        nomask = ndm.flash_selfatt_nomask(ndm.array(qkv0), heads=H,
                                          causal=True)
        res.append((out.asnumpy(), qkv.grad.asnumpy(), nomask.asnumpy()))
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_ragged_paged_attention_op_matches_jax():
    B, H, D, P, T = 3, 2, 16, 4, 6
    rs = np.random.RandomState(80)
    q = rs.randn(B, H, D).astype(np.float32)
    k_pages = rs.randn(T * B, P, H, D).astype(np.float32)
    v_pages = rs.randn(T * B, P, H, D).astype(np.float32)
    tables = rs.permutation(T * B).reshape(B, T).astype(np.float32)
    lens = np.array([5, 0, 17], np.float32)
    ours = nd.ragged_paged_attention_op(
        nd.array(q), nd.array(k_pages), nd.array(v_pages),
        nd.array(tables), nd.array(lens)).asnumpy()
    ref = jnd._contrib_ragged_paged_attention(
        jnd.array(q), jnd.array(k_pages), jnd.array(v_pages),
        jnd.array(tables), jnd.array(lens)).asnumpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_save_load_across_packages(tmp_path):
    a = {"w": _r((3, 4), 90), "b": _r((4,), 91)}
    ours = str(tmp_path / "ours.npz")
    theirs = str(tmp_path / "theirs.npz")
    nd.save(ours, {k: nd.array(v) for k, v in a.items()})
    jnd.save(theirs, {k: jnd.array(v) for k, v in a.items()})
    for k, v in jnd.load(ours).items():
        np.testing.assert_array_equal(v.asnumpy(), a[k])
    for k, v in nd.load(theirs).items():
        np.testing.assert_array_equal(v.asnumpy(), a[k])
