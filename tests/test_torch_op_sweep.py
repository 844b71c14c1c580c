"""PyTorch port, the whole op registry against the JAX package's
(``mxnet_tpu_torch/ops/*``, ``mxnet_tpu_torch/random.py``).

The port registers every name of ``mxnet_tpu``'s registry but
``Custom`` (a Python ``CustomOp`` run through ``jax.pure_callback``,
which a CUDA graph cannot hold).  For every name both registries hold,
on the inputs of ``tests/test_op_sweep.py``'s specs (the same seeded
numpy arrays, made by its ``_get_spec``):

- the registration: primary name, aliases, arity, ``differentiable``,
  ``mutates_rng`` and the keyword schema;
- forward, through the port's ``nd`` frontend on the CPU against the JAX
  op (``test_forward``): every output's shape and dtype equal; integer,
  boolean, index and quantized outputs bit for bit; float32 within
  rtol 1e-5, atol 1e-6, and the linear-algebra decompositions
  (``FACTORS``) within 1e-4 of the output's max, ``syevd``'s
  eigenvector rows up to sign;
- for differentiable ops (``test_gradient``), the gradient of
  ``sum_i sum(out_i * cot_i)`` over the float outputs with respect to
  the spec's float inputs (``wrt``), torch autograd against
  ``jax.grad``, within 1e-4 of the JAX gradient's max;
- the samplers (``mutates_rng``, not Dropout / RNN), which cannot agree
  value for value with threefry (``test_sampler``): shape and dtype
  against the JAX op's, the same draws after ``mx.random.seed``, and the
  distribution: a two-sample KS test (scipy) of 20,000 port draws
  against 20,000 JAX draws, a one-sample KS test against the exact
  distribution where it is continuous, and the mean within 5 standard
  errors; ``nd.random``'s frontends of the samplers (``gamma``,
  ``exponential``, ``poisson``, ``negative_binomial``, ``multinomial``,
  ``shuffle``) by shape, dtype, seed and mean.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import registry as preg

import test_op_sweep as ref

NAMES = preg.list_ops()
# samplers: compared by distribution (Dropout and RNN draw only in
# training, and the sweep runs them deterministically)
SAMPLERS = sorted(n for n in NAMES if preg.get_op(n).mutates_rng
                  and preg.get_op(n).name not in ("Dropout", "RNN"))
DETERMINISTIC = [n for n in NAMES if n not in SAMPLERS]
FACTORS = {"_linalg_gelqf", "_linalg_syevd", "_linalg_potrf",
           "_linalg_potri", "_linalg_inverse", "_linalg_det",
           "_linalg_slogdet"}


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _canonical(name):
    """The JAX sweep's name for the op (its first registered name)."""
    return ref._seen[id(jreg.get_op(name))]


def _spec(name):
    canon = _canonical(name)
    inputs, kwargs, wrt, _gr, _rtol, _atol = ref._get_spec(
        canon, jreg.get_op(canon))
    return canon, inputs, kwargs, wrt


def _outs(result):
    return list(result) if isinstance(result, (list, tuple)) else [result]


def _jax_forward(name, inputs, kwargs):
    op = jreg.get_op(name)
    return [np.asarray(o) for o in
            _outs(op.fn(*[jnp.asarray(x) for x in inputs], **kwargs))]


def _port_forward(name, inputs, kwargs):
    frontend = getattr(nd.op, name)
    out = frontend(*[nd.array(x, dtype=str(x.dtype)) for x in inputs],
                   **kwargs)
    return [o.asnumpy() for o in _outs(out)]


def test_registry_is_the_jax_packages_less_custom():
    assert set(NAMES) == set(jreg.list_ops()) - {"Custom"}
    assert len(NAMES) == 360


def _arity(n, kwargs):
    return n(kwargs) if callable(n) else n


@pytest.mark.parametrize("name", NAMES)
def test_registration(name):
    want, got = jreg.get_op(name), preg.get_op(name)
    assert got.name == want.name
    assert sorted(got.aliases) == sorted(want.aliases)
    assert got.differentiable == want.differentiable
    assert got.mutates_rng == want.mutates_rng
    assert set(got.params) == set(want.params)
    assert got.open_schema == want.open_schema
    _c, _i, kwargs, _w = _spec(name)
    for kw in (kwargs, {}, {"mode": "lstm"}, {"mode": "gru"},
               {"state_outputs": True}, {"no_bias": True}):
        assert _arity(got.num_inputs, kw) == _arity(want.num_inputs, kw)
        assert _arity(got.n_outputs(kw) if not callable(got.num_outputs)
                      else got.num_outputs, kw) == \
            _arity(want.num_outputs, kw)


def _row_signs(got, want):
    """``syevd``'s V^T rows flipped to the JAX rows' signs."""
    s = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    return got * np.where(s == 0, 1, s)


def _assert_output(name, i, got, want):
    assert got.shape == want.shape, (name, i, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, i, got.dtype, want.dtype)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=f"{name}[{i}]")
        return
    if name in FACTORS:
        if name == "_linalg_syevd" and i == 0:
            got = _row_signs(got, want)
        tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{name}[{i}]")
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=f"{name}[{i}]")


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_forward(name):
    canon, inputs, kwargs, _wrt = _spec(name)
    want = _jax_forward(name, inputs, kwargs)
    got = _port_forward(name, inputs, kwargs)
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_output(name, i, g, w)


DIFFERENTIABLE = [n for n in DETERMINISTIC
                  if jreg.get_op(n).differentiable]


@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_gradient(name):
    canon, inputs, kwargs, wrt = _spec(name)
    if wrt is None:
        wrt = [i for i, x in enumerate(inputs)
               if np.issubdtype(x.dtype, np.floating)]
    want_outs = _jax_forward(name, inputs, kwargs)
    floats = [i for i, o in enumerate(want_outs)
              if np.issubdtype(o.dtype, np.floating)]
    assert wrt, f"{name}: no float input"
    if not floats:
        # registered differentiable, but every output is integer
        # (index_array): nothing reaches the tape on either side
        assert not any(np.issubdtype(o.dtype, np.floating) for o in
                       _port_forward(name, inputs, kwargs)), name
        return
    rng = ref._rng(canon + "/cot")
    cots = {i: np.asarray(rng.randn(*want_outs[i].shape), np.float32)
            for i in floats}
    jfn = jreg.get_op(name).fn

    def jax_scalar(*wrt_vals):
        full = [jnp.asarray(x) for x in inputs]
        for i, v in zip(wrt, wrt_vals):
            full[i] = v
        outs = _outs(jfn(*full, **kwargs))
        return sum(jnp.sum(outs[i] * cots[i]) for i in floats)

    want = jax.grad(jax_scalar, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(inputs[i]) for i in wrt])
    ts = [torch.tensor(x) for x in inputs]
    for i in wrt:
        ts[i].requires_grad_(True)
    with torch.enable_grad():
        outs = _outs(preg.get_op(name).fn(*ts, **kwargs))
        scalar = sum((outs[i] * torch.tensor(cots[i])).sum()
                     for i in floats)
        # a detached output (stop_gradient) has no gradient at all
        got = torch.autograd.grad(scalar, [ts[i] for i in wrt],
                                  allow_unused=True) \
            if scalar.requires_grad else [None] * len(wrt)
    for i, g, w in zip(wrt, got, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= 1e-4 * float(np.abs(w).max(initial=0.0)), \
            (name, i, err, float(np.abs(w).max(initial=0.0)))


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
N_DRAWS = 20000
# canonical sampler -> (kwargs of a large draw, the exact distribution of
# one draw or None, the draw's inputs)
DISTRIBUTIONS = {
    "_random_uniform": (dict(low=-1.0, high=3.0),
                        scipy.stats.uniform(-1.0, 4.0), []),
    "_random_normal": (dict(loc=0.5, scale=2.0),
                       scipy.stats.norm(0.5, 2.0), []),
    "_random_gamma": (dict(alpha=2.5, beta=1.5),
                      scipy.stats.gamma(2.5, scale=1.5), []),
    "_random_exponential": (dict(lam=2.0), scipy.stats.expon(scale=0.5),
                            []),
    "_random_poisson": (dict(lam=3.5), None, []),
    "_random_randint": (dict(low=-3, high=7), None, []),
    "_random_negative_binomial": (dict(k=3, p=0.4), None, []),
    "_sample_unique_zipfian": (dict(range_max=50), None, []),
    "_sample_multinomial": (dict(), None,
                            [np.array([0.1, 0.2, 0.3, 0.4], np.float32)]),
    "sample_uniform": (dict(), scipy.stats.uniform(-1.0, 3.0),
                       [np.array([-1.0], np.float32),
                        np.array([2.0], np.float32)]),
    "sample_normal": (dict(), scipy.stats.norm(1.0, 0.5),
                      [np.array([1.0], np.float32),
                       np.array([0.5], np.float32)]),
}


def _draws(fn, name, inputs, kwargs, shape):
    kw = dict(kwargs, shape=shape)
    return fn(name, inputs, kw)[0].reshape(-1).astype(np.float64)


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler(name):
    canon, inputs, kwargs, _wrt = _spec(name)
    jmx.random.seed(0)
    want = _jax_forward(name, inputs, kwargs)
    mx.random.seed(0)
    got = _port_forward(name, inputs, kwargs)
    mx.random.seed(0)
    again = _port_forward(name, inputs, kwargs)
    assert [(g.shape, g.dtype) for g in got] == \
        [(w.shape, w.dtype) for w in want]
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    if canon == "_shuffle":
        x = np.arange(1000, dtype=np.float32)
        mx.random.seed(1)
        perm = _port_forward(name, [x], {})[0]
        np.testing.assert_array_equal(np.sort(perm), x)
        assert (perm != x).mean() > 0.9
        return
    kwargs, exact, inputs = DISTRIBUTIONS[canon]
    shape = (N_DRAWS,)
    jmx.random.seed(1)
    j = _draws(_jax_forward, name, inputs, kwargs, shape)
    mx.random.seed(1)
    p = _draws(_port_forward, name, inputs, kwargs, shape)
    assert scipy.stats.ks_2samp(p, j).pvalue > 1e-3, name
    if exact is not None:
        assert scipy.stats.kstest(p, exact.cdf).pvalue > 1e-3, name
    se = np.sqrt(j.var() / N_DRAWS + p.var() / N_DRAWS)
    assert abs(p.mean() - j.mean()) < 5 * se + 1e-12, \
        (name, p.mean(), j.mean())


@pytest.mark.parametrize("frontend, args, mean", [
    ("gamma", dict(alpha=2.0, beta=0.5, shape=(4000,)), 1.0),
    ("exponential", dict(scale=2.0, shape=(4000,)), 2.0),
    ("poisson", dict(lam=3.0, shape=(4000,)), 3.0),
    ("negative_binomial", dict(k=2, p=0.5, shape=(4000,)), 2.0),
])
def test_nd_random_frontends(frontend, args, mean):
    fn = getattr(nd.random, frontend)
    mx.random.seed(3)
    a = fn(**args)
    mx.random.seed(3)
    b = fn(**args)
    assert a.shape == (4000,) and str(a.dtype) == "float32"
    assert a.context == mx.cpu(0)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    x = a.asnumpy().astype(np.float64)
    assert abs(x.mean() - mean) < 5 * x.std() / np.sqrt(x.size)


def test_nd_random_multinomial_and_shuffle():
    probs = nd.array(np.array([[0.7, 0.1, 0.2], [0.0, 0.5, 0.5]],
                              np.float32))
    draws = nd.random.multinomial(probs, shape=(4000,)).asnumpy()
    assert draws.shape == (2, 4000) and draws.dtype == np.int32
    np.testing.assert_allclose(np.bincount(draws[0], minlength=3) / 4000,
                               [0.7, 0.1, 0.2], atol=0.03)
    assert (draws[1] != 0).all()
    rows = nd.array(np.arange(12, dtype=np.float32).reshape(6, 2))
    mixed = nd.random.shuffle(rows).asnumpy()
    assert sorted(map(tuple, mixed)) == sorted(map(tuple, rows.asnumpy()))
