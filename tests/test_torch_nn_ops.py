"""PyTorch port, the fused RNN op and the Correlation cost volume
(``mxnet_tpu_torch/ops/nn.py``).

Twins of ``tests/test_autograd.py::test_rnn_op_grad_flows`` and
``tests/test_ndarray.py::test_correlation_vs_oracle``.  The RNN twin
runs every mode (``lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``), one and
two directions, two layers, with the final states, through ``nd.RNN``
under ``autograd.record`` in both packages on the same seeded inputs:
outputs and states within 1e-5, and the gradients of
``sum(out * cot)`` with respect to the data, the flat parameter vector
and the initial states within 1e-4 of their max.  The Correlation twin
holds the port to the JAX test's numpy oracle (rtol 1e-4, atol 1e-5)
and to the JAX op (rtol 1e-5, atol 1e-6) on its three settings.
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd

from test_ndarray import _correlation_oracle

GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _n_params(mode, layers, I, H, D):
    G = GATES[mode]
    n = 0
    for layer in range(layers):
        in_sz = I if layer == 0 else H * D
        n += D * (G * H * in_sz + G * H * H + 2 * G * H)
    return n


def _rnn(m, ag, arrays, cots, **kw):
    arrs = [m.array(a) for a in arrays]
    for a in arrs:
        a.attach_grad()
    with ag.record():
        outs = m.RNN(*arrs, state_outputs=True, **kw)
        loss = sum((o * m.array(c)).sum() for o, c in zip(outs, cots))
    loss.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrs]


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", sorted(GATES))
def test_rnn_op_grad_flows(mode, bidirectional):
    T, N, I, H, layers = 3, 2, 4, 5, 2
    D = 2 if bidirectional else 1
    rng = np.random.RandomState(sorted(GATES).index(mode) + 10 * D)
    arrays = [rng.rand(T, N, I).astype(np.float32) * 0.1,
              (rng.rand(_n_params(mode, layers, I, H, D)) - 0.5)
              .astype(np.float32) * 0.6,
              rng.randn(layers * D, N, H).astype(np.float32) * 0.1]
    if mode == "lstm":
        arrays.append(rng.randn(layers * D, N, H).astype(np.float32) * 0.1)
    n_out = 3 if mode == "lstm" else 2
    shapes = [(T, N, H * D)] + [(layers * D, N, H)] * (n_out - 1)
    cots = [rng.randn(*s).astype(np.float32) for s in shapes]
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidirectional)
    outs, grads = _rnn(nd, autograd, arrays, cots, **kw)
    jouts, jgrads = _rnn(jnd, jautograd, arrays, cots, **kw)
    assert [o.shape for o in outs] == shapes
    for o, w in zip(outs, jouts):
        np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-6)
    assert np.abs(grads[1]).sum() > 0
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("kwargs", [
    dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1,
         pad_size=2, is_multiply=True),
    dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
         pad_size=3, is_multiply=True),
    dict(kernel_size=1, max_displacement=1, stride1=1, stride2=1,
         pad_size=1, is_multiply=False),
])
def test_correlation_vs_oracle(kwargs):
    rng = np.random.RandomState(0)
    d1 = rng.randn(2, 3, 8, 8).astype(np.float32)
    d2 = rng.randn(2, 3, 8, 8).astype(np.float32)
    got = nd.Correlation(nd.array(d1), nd.array(d2), **kwargs).asnumpy()
    want = _correlation_oracle(d1, d2, **kwargs)
    assert got.shape == want.shape, (got.shape, want.shape, kwargs)
    assert np.allclose(got, want, rtol=1e-4, atol=1e-5), kwargs
    jax_out = jnd.Correlation(jnd.array(d1), jnd.array(d2),
                              **kwargs).asnumpy()
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-6)
