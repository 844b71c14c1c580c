"""PyTorch port, ``mx.np`` / ``mx.npx``: a twin of each test of
``tests/test_numpy.py``, and a sweep of the namespace: each case runs
the same numpy inputs through the JAX package's ``mx.np`` and the
port's, and the results must agree in type, shape and dtype (the JAX
package's x64-off dtypes: int32 default ints, float64 requests giving
float32) and in value: integers, booleans and indices exactly, floats
within rtol 1e-5 / atol 1e-5 (fp32, the same arithmetic in another
order; 1e-4 for the decompositions and the transcendental reductions
marked so).  Samplers are compared by shape, dtype and moments, as the
port's earlier sampler twins are: the two packages' generators differ.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import np as jnp_mx
from mxnet_tpu import npx as jnpx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np as mnp
from mxnet_tpu_torch import npx
from mxnet_tpu_torch.ndarray import NDArray
from mxnet_tpu_torch.ndarray.ndarray import dtype_name

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


class A:
    """An array argument: numpy data made into each package's array."""

    def __init__(self, data):
        self.data = onp.asarray(data)


def _args(pkg_np, x):
    if isinstance(x, A):
        return pkg_np.array(x.data)
    if isinstance(x, list) and x and any(isinstance(v, A) for v in x):
        return [_args(pkg_np, v) for v in x]
    if isinstance(x, tuple) and any(isinstance(v, A) for v in x):
        return tuple(_args(pkg_np, v) for v in x)
    return x


def _dt(arr):
    if isinstance(arr, NDArray):
        return dtype_name(arr._data.dtype)
    return str(arr.dtype)


def _same(got, want, tol, where):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), (where, type(got))
        assert type(got).__name__ == type(want).__name__ or (
            isinstance(got, list) == isinstance(want, list)), \
            (where, type(got), type(want))
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, f"{where}[{i}]")
        return
    if hasattr(want, "asnumpy"):
        assert isinstance(got, NDArray), (where, type(got))
        w, g = want.asnumpy(), got.asnumpy()
        assert g.shape == w.shape, (where, g.shape, w.shape)
        assert _dt(got) == _dt(want), (where, _dt(got), _dt(want))
        if w.dtype.kind in "biu":
            onp.testing.assert_array_equal(g, w, err_msg=where)
        else:
            onp.testing.assert_allclose(
                g.astype(onp.complex128 if w.dtype.kind == "c"
                         else onp.float64),
                w.astype(onp.complex128 if w.dtype.kind == "c"
                         else onp.float64),
                rtol=tol, atol=tol, equal_nan=True, err_msg=where)
        return
    if isinstance(want, onp.dtype) or isinstance(got, onp.dtype):
        assert str(got) == str(want), (where, got, want)
        return
    if isinstance(want, float):
        assert got == pytest.approx(want, rel=tol, abs=tol), (where, got)
        return
    assert got == want, (where, got, want)


def _twin(name, *args, tol=RTOL, **kwargs):
    """``name`` (dotted for submodules) on both packages; results held
    to each other; the port's returned."""
    outs = []
    for pkg_np in (jnp_mx, mnp):
        fn = pkg_np
        for part in name.split("."):
            fn = getattr(fn, part)
        a = [_args(pkg_np, x) for x in args]
        kw = {k: _args(pkg_np, v) for k, v in kwargs.items()}
        outs.append(fn(*a, **kw))
    _same(outs[1], outs[0], tol, name)
    return outs[1]


# ------------------------------------------------- twins of test_numpy.py
class TestNpCreation:
    def test_array_zeros_ones(self):
        a = _twin("array", [[1, 2], [3, 4]])
        assert isinstance(a, NDArray) and a.shape == (2, 2)
        _twin("zeros", (2, 3))
        _twin("ones", (2,), dtype=onp.int32)

    def test_zero_dim_and_zero_size(self):
        s = _twin("array", 3.5)
        assert s.shape == () and float(s.asnumpy()) == 3.5
        z = _twin("zeros", (0, 4))
        assert z.shape == (0, 4)
        _twin("concatenate", [A(onp.zeros((0, 4), onp.float32))] * 2)

    def test_arange_linspace(self):
        _twin("arange", 5)
        _twin("linspace", 0, 1, 5)


class TestNpBroadcastSemantics:
    def test_true_numpy_broadcasting(self):
        out = _twin("add", A(onp.ones((3, 1, 4), onp.float32)),
                    A(onp.arange(2, dtype=onp.float32).reshape(2, 1)))
        assert out.shape == (3, 2, 4)

    def test_where_and_comparison(self):
        x = onp.array([1.0, -2.0, 3.0], onp.float32)
        outs = []
        for p in (jnp_mx, mnp):
            ax = p.array(x)
            outs.append(p.where(p.greater(ax, 0), ax, p.zeros_like(ax)))
        _same(outs[1], outs[0], RTOL, "where")
        onp.testing.assert_allclose(outs[1].asnumpy(), [1.0, 0.0, 3.0])

    def test_reductions_match_numpy(self):
        x = onp.random.RandomState(0).randn(3, 4, 5).astype(onp.float32)
        for red in ("sum", "mean", "max", "min", "var", "std", "prod"):
            got = _twin(red, A(x), axis=1).asnumpy()
            onp.testing.assert_allclose(got, getattr(onp, red)(x, axis=1),
                                        rtol=2e-5, atol=1e-5)

    def test_einsum_matmul(self):
        rng = onp.random.RandomState(1)
        a = rng.randn(2, 3).astype(onp.float32)
        b = rng.randn(3, 4).astype(onp.float32)
        _twin("einsum", "ij,jk->ik", A(a), A(b))
        _twin("matmul", A(a), A(b))

    def test_split_returns_ndarrays(self):
        parts = []
        for p in (jnp_mx, mnp):
            parts.append(p.split(p.arange(12).reshape((3, 4)), 2, axis=1))
        _same(parts[1], parts[0], RTOL, "split")
        assert len(parts[1]) == 2 and parts[1][0].shape == (3, 2)
        assert all(isinstance(p, NDArray) for p in parts[1])


class TestNpSubmodules:
    def test_linalg(self):
        a = onp.array([[4.0, 0.0], [0.0, 9.0]], onp.float32)
        _twin("linalg.norm", A(a))
        _twin("linalg.inv", A(a))

    def test_fft_roundtrip(self):
        x = onp.random.RandomState(0).randn(8).astype(onp.float32)
        outs = []
        for p in (jnp_mx, mnp):
            outs.append(p.fft.ifft(p.fft.fft(p.array(x))))
        _same(outs[1], outs[0], RTOL, "fft")
        onp.testing.assert_allclose(outs[1].asnumpy().real, x, atol=1e-5)

    def test_random_seeded(self):
        mnp.random.seed(42)
        a = mnp.random.uniform(size=(4,)).asnumpy()
        mnp.random.seed(42)
        b = mnp.random.uniform(size=(4,)).asnumpy()
        onp.testing.assert_array_equal(a, b)
        r = mnp.random.randint(0, 10, size=(100,))
        jr = jnp_mx.random.randint(0, 10, size=(100,))
        assert r.shape == jr.shape and _dt(r) == _dt(jr)
        assert r.asnumpy().max() < 10 and r.asnumpy().min() >= 0
        n = mnp.random.normal(2.0, 0.5, size=(2000,))
        jn = jnp_mx.random.normal(2.0, 0.5, size=(2000,))
        assert _dt(n) == _dt(jn) == "float32"
        for v in (n.asnumpy(), jn.asnumpy()):
            assert abs(v.mean() - 2.0) < 0.1 and abs(v.std() - 0.5) < 0.05

    def test_error_wraps_mxnet_error(self):
        for p, err in ((jnp_mx, jmx.MXNetError), (mnp, mx.MXNetError)):
            with pytest.raises(err):
                p.reshape(p.zeros((4,)), (3,))


class TestNpx:
    def test_set_np_flags(self):
        for p in (jnpx, npx):
            p.set_np()
            assert p.is_np_array() and p.is_np_shape()
            p.reset_np()
            assert not p.is_np_array()

    def test_nn_extension_ops(self):
        rng = onp.random.RandomState(0)
        x = rng.randn(2, 8).astype(onp.float32)
        w = rng.randn(4, 8).astype(onp.float32)
        outs = []
        for p, pn in ((jnp_mx, jnpx), (mnp, npx)):
            out = pn.fully_connected(p.array(x), p.array(w), p.zeros((4,)),
                                     num_hidden=4)
            outs.append((out, pn.softmax(out),
                         pn.relu(p.array([-1.0, 2.0]))))
        _same(list(outs[1]), list(outs[0]), 2e-5, "npx")
        onp.testing.assert_allclose(outs[1][0].asnumpy(), x @ w.T,
                                    rtol=2e-5, atol=2e-5)
        assert outs[1][2].asnumpy().tolist() == [0.0, 2.0]

    def test_one_hot_pick(self):
        outs = []
        for p, pn in ((jnp_mx, jnpx), (mnp, npx)):
            idx = p.array([0, 2]).astype("int32")
            data = p.array(onp.arange(6, dtype=onp.float32).reshape(2, 3))
            outs.append([pn.one_hot(idx, 3), pn.pick(data, idx),
                         pn.topk(data, k=2), pn.sequence_mask(
                             data, p.array([1.0, 2.0]),
                             use_sequence_length=True, axis=1)])
        _same(outs[1], outs[0], RTOL, "npx")
        onp.testing.assert_array_equal(outs[1][0].asnumpy(),
                                       [[1, 0, 0], [0, 0, 1]])

    def test_save_load(self, tmp_path):
        path = str(tmp_path / "arrs")
        npx.save(path, {"w": mnp.ones((2, 2))})
        back = npx.load(path)
        onp.testing.assert_array_equal(back["w"].asnumpy(), onp.ones((2, 2)))
        # the JAX package reads the port's file
        jback = jnpx.load(path)
        onp.testing.assert_array_equal(jback["w"].asnumpy(),
                                       onp.ones((2, 2)))


class TestNpAutograd:
    def _grad(self, pkg, pkg_np, x, fn):
        a = pkg_np.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = fn(pkg_np, a)
        y.backward()
        return a.grad.asnumpy(), y

    def test_grad_through_np_ops(self):
        x = onp.array([[1.0, 2.0], [3.0, 4.0]], onp.float32)
        f = lambda p, a: p.sum(p.square(a) * 3.0)
        jg, _ = self._grad(jmx, jnp_mx, x, f)
        g, _ = self._grad(mx, mnp, x, f)
        onp.testing.assert_allclose(g, jg, rtol=RTOL)
        onp.testing.assert_allclose(g, 6 * x)

    def test_multi_output_and_mixed_tape(self):
        x = onp.array([1.0, 2.0, 3.0, 4.0], onp.float32)
        grads = []
        for pkg, p in ((jmx, jnp_mx), (mx, mnp)):
            a = p.array(x)
            a.attach_grad()
            with pkg.autograd.record():
                p0, p1 = p.split(a, 2)
                loss = pkg.nd.sum(p0 * 2.0) + p.sum(p1 * 3.0)
            loss.backward()
            grads.append(a.grad.asnumpy())
        onp.testing.assert_allclose(grads[1], grads[0])
        onp.testing.assert_allclose(grads[1], [2, 2, 3, 3])

    def test_train_tiny_model_in_np(self):
        """A linear regression written in mx.np trains to convergence,
        with the JAX package's losses step for step (1e-5 relative)."""
        rng = onp.random.RandomState(0)
        Xh = rng.randn(64, 4).astype(onp.float32)
        true_w = onp.array([[1.0], [-2.0], [0.5], [3.0]], onp.float32)
        Yh = Xh @ true_w
        runs = []
        for pkg, p in ((jmx, jnp_mx), (mx, mnp)):
            X, Y = p.array(Xh), p.array(Yh)
            w, b = p.zeros((4, 1)), p.zeros((1,))
            w.attach_grad()
            b.attach_grad()
            losses = []
            for _ in range(60):
                with pkg.autograd.record():
                    loss = p.mean(p.square(p.matmul(X, w) + b - Y))
                loss.backward()
                for q in (w, b):
                    q -= 0.1 * q.grad
                    q.grad[:] = 0
                losses.append(float(loss.asnumpy()))
            runs.append((losses, w.asnumpy()))
        (jl, jw), (pl, pw) = runs
        onp.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-7)
        assert pl[-1] < 1e-3 < pl[0]
        onp.testing.assert_allclose(pw, true_w, atol=0.05)

    def test_metadata_fns_stay_tape_free(self):
        x = mnp.ones((2, 3))
        x.attach_grad()
        with mx.autograd.record():
            assert mnp.shape(x) == (2, 3) == jnp_mx.shape(jnp_mx.ones((2, 3)))
            assert mnp.ndim(x) == 2
            assert mnp.size(x) == 6
            y = mnp.sum(x)
        y.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), onp.ones((2, 3)))

    def test_namedtuple_results_eager_and_taped(self):
        x = onp.array([[2.0, 1.0], [1.0, 3.0]], onp.float32)
        r = _twin("linalg.eigh", A(x), tol=1e-4)
        assert hasattr(r, "eigenvalues") and hasattr(r, "eigenvectors")
        jg, _ = self._grad(jmx, jnp_mx, x, lambda p, a: p.sum(
            p.linalg.eigh(a)[0]))
        g, _ = self._grad(mx, mnp, x, lambda p, a: p.sum(
            p.linalg.eigh(a)[0]))
        onp.testing.assert_allclose(g, jg, atol=1e-5)
        onp.testing.assert_allclose(g, onp.eye(2), atol=1e-5)

    def test_baked_constants_not_shared_across_bulk_cache(self):
        for c in (3.0, 5.0):
            x = onp.array([1.0, 2.0], onp.float32)
            f = lambda p, a, c=c: p.sum(p.multiply(p.square(a), c))
            jg, _ = self._grad(jmx, jnp_mx, x, f)
            g, _ = self._grad(mx, mnp, x, f)
            onp.testing.assert_allclose(g, jg)
            onp.testing.assert_allclose(g, 2 * c * x)


# ------------------------------------------------------------- the sweep
_R = onp.random.RandomState(7)
F = A(_R.randn(3, 4).astype(onp.float32))
F3 = A(_R.randn(2, 3, 4).astype(onp.float32))
V = A(_R.randn(6).astype(onp.float32))
P = A(_R.rand(3, 4).astype(onp.float32) + 0.5)
U = A((_R.rand(3, 4).astype(onp.float32) * 1.8) - 0.9)
I = A(_R.randint(-5, 9, (3, 4)).astype(onp.int32))
IP = A(_R.randint(1, 9, (3, 4)).astype(onp.int32))
IV = A(onp.array([3, 1, 4, 1, 5, 9, 2, 6], onp.int32))
B = A(_R.rand(3, 4) > 0.5)
SQ = A((_R.randn(3, 3) + 3 * onp.eye(3)).astype(onp.float32))
SPD = A((lambda m: (m @ m.T + 3 * onp.eye(3)).astype(onp.float32))(
    _R.randn(3, 3)))
NANS = A(onp.array([[1.0, onp.nan, 3.0], [onp.nan, 5.0, -1.0]],
                   onp.float32))
SORTED = A(onp.array([0.0, 1.0, 2.5, 4.0, 7.0], onp.float32))
C = A((_R.randn(4) + 1j * _R.randn(4)).astype(onp.complex64))

SWEEP = [
    # creation
    ("array", ([1.5, 2, 3],), {}), ("array", ([[True, False]],), {}),
    ("array", (onp.arange(4, dtype=onp.float64),), {}),
    ("array", ([1, 2],), dict(dtype="float64")),
    ("asarray", (F,), {}), ("asarray", ([1, 2],), dict(dtype="float32")),
    ("zeros", ((2, 3),), dict(dtype="int32")), ("ones", (3,), {}),
    ("full", ((2, 2), 7), {}), ("full", ((2,), 1.5), {}),
    ("full", ((2,), True), {}), ("empty", ((2, 3),), {}),
    ("zeros_like", (I,), {}), ("ones_like", (F,), dict(dtype="int32")),
    ("full_like", (F, 3), {}), ("empty_like", (F,), {}),
    ("arange", (2, 11, 3), {}), ("arange", (0.0, 1.0, 0.25), {}),
    ("arange", (5,), dict(dtype="float32")),
    ("linspace", (0, 10, 7), {}), ("linspace", (0, 1, 4),
                                      dict(endpoint=False)),
    ("linspace", (2.0, 3.0, 5), dict(retstep=True)),
    ("logspace", (0, 2, 5), {}), ("eye", (3,), {}), ("eye", (3, 4, 1), {}),
    ("identity", (3,), {}), ("tri", (3, 4), {}), ("tril", (F,), {}),
    ("triu", (F, 1), {}), ("diag", (V,), {}), ("diag", (F, 1), {}),
    ("diagflat", (A([[1.0, 2.0], [3.0, 4.0]]),), {}),
    ("meshgrid", (A([1.0, 2.0, 3.0]), A([4.0, 5.0])), {}),
    ("meshgrid", (A([1.0, 2.0, 3.0]), A([4.0, 5.0])),
     dict(indexing="ij")),
    ("indices", ((2, 3),), {}),
    # manipulation
    ("reshape", (F, (4, 3)), {}), ("reshape", (F, (-1,)), {}),
    ("ravel", (F3,), {}), ("transpose", (F3,), {}),
    ("transpose", (F3, (1, 0, 2)), {}), ("swapaxes", (F3, 0, 2), {}),
    ("moveaxis", (F3, 0, -1), {}), ("rollaxis", (F3, 2), {}),
    ("expand_dims", (F, 1), {}), ("expand_dims", (F, (0, 3)), {}),
    ("squeeze", (A(onp.ones((1, 3, 1), onp.float32)),), {}),
    ("squeeze", (A(onp.ones((1, 3, 1), onp.float32)), 2), {}),
    ("concatenate", ([F, F],), dict(axis=1)),
    ("concatenate", ([F, I],), {}), ("concatenate", ([F, F],),
                                     dict(axis=None)),
    ("stack", ([V, V],), dict(axis=1)), ("vstack", ([V, V],), {}),
    ("hstack", ([F, F],), {}), ("dstack", ([F, F],), {}),
    ("column_stack", ([V, V],), {}),
    ("split", (V, [2, 5]), {}), ("array_split", (V, 4), {}),
    ("hsplit", (F, 2), {}), ("vsplit", (A(onp.ones((4, 2))), 2), {}),
    ("dsplit", (A(onp.ones((2, 2, 4))), 2), {}),
    ("tile", (V, (2, 2)), {}), ("repeat", (F, 2), dict(axis=1)),
    ("repeat", (F, 2), {}), ("flip", (F,), {}), ("flip", (F, 1), {}),
    ("fliplr", (F,), {}), ("flipud", (F,), {}), ("roll", (F, 2), {}),
    ("roll", (F, -1, 1), {}), ("rot90", (F,), {}),
    ("rot90", (F, 2, (1, 0)), {}), ("broadcast_to", (V, (2, 6)), {}),
    ("broadcast_arrays", (F, A([1.0, 2.0, 3.0, 4.0])), {}),
    ("atleast_1d", (A(3.0),), {}), ("atleast_2d", (V,), {}),
    ("atleast_3d", (F,), {}), ("atleast_3d", (V,), {}),
    ("insert", (V, 2, 9.0), {}), ("insert", (F, 1, 5.0), dict(axis=1)),
    ("insert", (V, A(onp.int32([1, 3])), A([7.0, 8.0])), {}),
    ("insert", (F, 1, A([1.0, 2.0, 3.0])), dict(axis=1)),
    ("delete", (V, 1), {}), ("delete", (F, A(onp.int32([0, 2])), 1), {}),
    ("append", (V, A([1.0, 2.0])), {}), ("append", (F, F), dict(axis=0)),
    ("pad", (F, 1), {}), ("pad", (F, ((1, 0), (0, 2))),
                           dict(constant_values=3.0)),
    ("pad", (V, 2), dict(mode="edge")), ("pad", (V, 3), dict(mode="reflect")),
    ("pad", (V, 3), dict(mode="symmetric")), ("pad", (V, 4),
                                               dict(mode="wrap")),
    ("trim_zeros", (A([0.0, 0.0, 1.0, 2.0, 0.0]),), {}),
    ("unique", (IV,), {}),
    ("unique", (IV,), dict(return_index=True, return_inverse=True,
                          return_counts=True)),
    # math (elementwise)
    ("add", (F, 2), {}), ("add", (I, 2.5), {}), ("add", (I, F), {}),
    ("subtract", (F, F), {}), ("multiply", (I, I), {}),
    ("divide", (I, IP), {}), ("true_divide", (F, P), {}),
    ("floor_divide", (I, IP), {}), ("floor_divide", (F, P), {}),
    ("power", (P, 1.5), {}), ("power", (IP, 2), {}),
    ("float_power", (IP, 2), {}), ("mod", (I, IP), {}),
    ("remainder", (F, P), {}), ("fmod", (I, IP), {}),
    ("divmod", (I, IP), {}), ("negative", (I,), {}),
    ("positive", (F,), {}), ("reciprocal", (P,), {}),
    ("abs", (I,), {}), ("absolute", (F,), {}), ("fabs", (I,), {}),
    ("sign", (F,), {}), ("rint", (A([0.5, 1.5, -2.5, 2.4]),), {}),
    ("exp", (F,), {}), ("exp2", (F,), {}), ("expm1", (F,), {}),
    ("log", (P,), {}), ("log2", (P,), {}), ("log10", (P,), {}),
    ("log1p", (P,), {}), ("sqrt", (P,), {}), ("sqrt", (IP,), {}),
    ("cbrt", (F,), {}), ("square", (I,), {}), ("sin", (F,), {}),
    ("cos", (I,), {}), ("tan", (U,), {}), ("arcsin", (U,), {}),
    ("arccos", (U,), {}), ("arctan", (F,), {}), ("arctan2", (F, P), {}),
    ("sinh", (F,), {}), ("cosh", (F,), {}), ("tanh", (F,), {}),
    ("arcsinh", (F,), {}), ("arccosh", (A(onp.float32([1.5, 2.0])),), {}),
    ("arctanh", (U,), {}), ("hypot", (F, P), {}), ("degrees", (F,), {}),
    ("radians", (F,), {}), ("deg2rad", (F,), {}), ("rad2deg", (F,), {}),
    ("floor", (F,), {}), ("ceil", (F,), {}), ("trunc", (F,), {}),
    ("floor", (I,), {}), ("round", (F, 2), {}), ("around", (F,), {}),
    ("clip", (F, -0.5, 0.5), {}), ("clip", (I, 0, 4), {}),
    ("maximum", (F, P), {}), ("minimum", (I, 2), {}),
    ("fmax", (NANS, 2.0), {}), ("fmin", (NANS, 2.0), {}),
    ("nan_to_num", (NANS,), {}), ("real", (C,), {}), ("imag", (C,), {}),
    ("conj", (C,), {}), ("conjugate", (F,), {}), ("angle", (C,), {}),
    ("i0", (F,), {}), ("sinc", (F,), {}), ("gcd", (I, IP), {}),
    ("lcm", (I, IP), {}), ("heaviside", (F, 0.5), {}),
    ("copysign", (P, F), {}), ("frexp", (F,), {}),
    ("ldexp", (F, A(onp.int32([[1, 2, 3, 0]] * 3))), {}),
    ("interp", (A([0.5, 1.5, 5.0, -1.0]), SORTED,
                A([1.0, 2.0, 3.0, 4.0, 5.0])), {}),
    ("convolve", (V, A([1.0, 2.0, 3.0])), {}),
    ("convolve", (V, A([1.0, 2.0, 3.0])), dict(mode="same")),
    ("correlate", (V, A([1.0, 2.0, 3.0])), {}),
    ("correlate", (V, A([1.0, 2.0, 3.0])), dict(mode="full")),
    ("cross", (A(_R.randn(4, 3).astype(onp.float32)),
               A(_R.randn(4, 3).astype(onp.float32))), {}),
    ("trapezoid", (F,), {}), ("trapezoid", (V,), dict(dx=0.5)),
    ("ediff1d", (V,), {}), ("gradient", (V,), {}), ("gradient", (F,), {}),
    ("diff", (F,), {}), ("diff", (F, 2, 0), {}),
    ("cumsum", (I,), {}), ("cumsum", (F,), dict(axis=1)),
    ("cumprod", (P,), dict(axis=0)), ("nancumsum", (NANS,), {}),
    ("nancumprod", (NANS,), dict(axis=1)), ("cumsum", (B,), {}),
    # reductions
    ("sum", (I,), {}), ("sum", (B,), dict(axis=0)),
    ("sum", (F3,), dict(axis=(0, 2), keepdims=True)),
    ("prod", (IP,), dict(axis=1)), ("mean", (I,), {}),
    ("std", (F,), dict(ddof=1)), ("var", (F3,), dict(axis=(1, 2))),
    ("min", (F,), {}), ("max", (I,), dict(axis=0)), ("amin", (F,), {}),
    ("amax", (F3,), dict(axis=-1, keepdims=True)),
    ("nansum", (NANS,), {}), ("nanprod", (NANS,), dict(axis=1)),
    ("nanmean", (NANS,), dict(axis=0)), ("nanstd", (NANS,), {}),
    ("nanvar", (NANS,), dict(axis=1)), ("nanmin", (NANS,), {}),
    ("nanmax", (NANS,), dict(axis=1)), ("argmin", (F,), {}),
    ("argmax", (F,), dict(axis=1)), ("argmax", (F,),
                                     dict(axis=0, keepdims=True)),
    ("nanargmin", (NANS,), {}), ("nanargmax", (NANS,), dict(axis=1)),
    ("ptp", (F,), dict(axis=1)), ("median", (F,), {}),
    ("median", (F,), dict(axis=1)), ("average", (F,), {}),
    ("average", (F,), dict(axis=1, weights=A([1.0, 2.0, 3.0, 4.0]))),
    ("percentile", (F, 30), {}), ("quantile", (F, 0.7), dict(axis=0)),
    ("count_nonzero", (I,), {}), ("count_nonzero", (B,), dict(axis=1)),
    ("any", (B,), {}), ("all", (B,), dict(axis=1)),
    # sorting / searching
    ("sort", (F,), {}), ("sort", (F,), dict(axis=0)),
    ("argsort", (IV,), {}), ("partition", (V, 2), {}),
    ("argpartition", (V, 2), {}),
    ("searchsorted", (SORTED, A([1.5, 7.0, -1.0])), {}),
    ("searchsorted", (SORTED, A([1.0, 2.5])), dict(side="right")),
    ("nonzero", (I,), {}), ("flatnonzero", (I,), {}),
    ("argwhere", (B,), {}), ("where", (B,), {}),
    ("where", (B, F, 0.0), {}), ("where", (B, 1, 2), {}),
    ("extract", (B, F), {}), ("take", (V, A([0, 5, 2])), {}),
    ("take", (F, A([3, 0])), dict(axis=1)),
    ("take_along_axis", (F, A(onp.int32([[0], [3], [1]])), 1), {}),
    ("choose", (A(onp.int32([0, 1, 2, 1])),
                [A([1.0, 2.0, 3.0, 4.0]), A([5.0, 6.0, 7.0, 8.0]),
                 A([9.0, 10.0, 11.0, 12.0])]), {}),
    ("compress", (A([True, False, True]), F), dict(axis=0)),
    ("select", ([A(onp.array([True, False, False])),
                 A(onp.array([False, True, False]))],
                [A([1.0, 2.0, 3.0]), A([4.0, 5.0, 6.0])]), {}),
    ("digitize", (V, A([-1.0, 0.0, 1.0])), {}),
    ("digitize", (V, A([-1.0, 0.0, 1.0])), dict(right=True)),
    # logic / comparison
    ("equal", (I, 2), {}), ("not_equal", (F, F), {}),
    ("greater", (F, 0), {}), ("greater_equal", (I, 1), {}),
    ("less", (F, P), {}), ("less_equal", (I, IP), {}),
    ("logical_and", (B, I), {}), ("logical_or", (B, B), {}),
    ("logical_xor", (B, F), {}), ("logical_not", (I,), {}),
    ("isfinite", (NANS,), {}), ("isinf", (A([1.0, onp.inf]),), {}),
    ("isnan", (NANS,), {}), ("isneginf", (A([-onp.inf, 1.0]),), {}),
    ("isposinf", (A([onp.inf, 1.0]),), {}),
    ("isclose", (F, F), {}), ("allclose", (F, P), {}),
    ("array_equal", (F, F), {}), ("array_equal", (F, V), {}),
    ("array_equiv", (V, V), {}), ("signbit", (F,), {}),
    # linear algebra
    ("dot", (F, A(_R.randn(4, 2).astype(onp.float32))), {}),
    ("dot", (F3, A(_R.randn(4, 5).astype(onp.float32))), {}),
    ("dot", (I, A(onp.int32([1, 2, 3, 4]))), {}), ("dot", (V, V), {}),
    ("vdot", (F, F), {}), ("inner", (F, F), {}), ("outer", (V, V), {}),
    ("matmul", (F3, A(_R.randn(4, 2).astype(onp.float32))), {}),
    ("matmul", (I, A(onp.int32([[1], [2], [3], [4]]))), {}),
    ("tensordot", (F3, A(_R.randn(3, 4).astype(onp.float32))), {}),
    ("tensordot", (F3, A(_R.randn(4, 3).astype(onp.float32))),
     dict(axes=([1, 2], [1, 0]))),
    ("einsum", ("bij,jk->bik", F3, A(_R.randn(4, 2).astype(onp.float32))),
     {}),
    ("kron", (A([[1.0, 2.0]]), A([[1.0], [3.0]])), {}),
    ("trace", (SQ,), {}), ("trace", (F3,), dict(axis1=1, axis2=2)),
    # bit ops
    ("bitwise_and", (I, IP), {}), ("bitwise_or", (I, 3), {}),
    ("bitwise_xor", (I, IP), {}), ("invert", (I,), {}),
    ("left_shift", (IP, 2), {}), ("right_shift", (IP, 1), {}),
    # statistics
    ("histogram", (V,), {}), ("histogram", (V,), dict(bins=3,
                                                       range=(-1, 1))),
    ("histogram", (V,), dict(bins=4, density=True)),
    ("histogram_bin_edges", (V,), dict(bins=5)),
    ("histogram2d", (V, A(_R.randn(6).astype(onp.float32))), dict(bins=3)),
    ("bincount", (A(onp.int32([0, 1, 1, 3])),), {}),
    ("bincount", (A(onp.int32([0, 1, 1, 3])),),
     dict(weights=A([0.5, 1.0, 2.0, 1.5]), minlength=6)),
    ("cov", (F,), {}), ("cov", (F,), dict(rowvar=False, bias=True)),
    ("corrcoef", (F,), {}),
    # sets
    ("intersect1d", (IV, A(onp.int32([1, 2, 7, 9]))), {}),
    ("union1d", (IV, A(onp.int32([0, 10]))), {}),
    ("setdiff1d", (IV, A(onp.int32([1, 2]))), {}),
    ("setxor1d", (IV, A(onp.int32([1, 2, 11]))), {}),
    ("isin", (IV, A(onp.int32([1, 9]))), {}),
    ("isin", (IV, A(onp.int32([1, 9]))), dict(invert=True)),
    # misc
    ("shape", (F3,), {}), ("ndim", (F3,), {}), ("size", (F3,), {}),
    ("size", (F3, 1), {}), ("copy", (F,), {}),
    ("result_type", (I, F), {}), ("result_type", (I, 2.0), {}),
    ("result_type", ("float64",), {}),
    ("promote_types", ("int32", "float32"), {}),
    ("promote_types", ("bfloat16", "float16"), {}),
    ("can_cast", ("int32", "float32"), {}), ("iscomplexobj", (C,), {}),
    ("isrealobj", (F,), {}), ("isscalar", (3.0,), {}),
    ("isscalar", (F,), {}), ("vander", (A([1.0, 2.0, 3.0]),), {}),
    ("vander", (A([1.0, 2.0, 3.0]), 4), dict(increasing=True)),
    ("unravel_index", (A(onp.int32([1, 7, 11])), (3, 4)), {}),
    ("ravel_multi_index", ((A(onp.int32([0, 2])), A(onp.int32([1, 3]))),
                           (3, 4)), {}),
    ("tril_indices", (3,), {}), ("triu_indices", (3, 1), {}),
    ("diag_indices", (3,), {}),
    # linalg and fft
    ("linalg.norm", (F,), {}), ("linalg.norm", (F,), dict(axis=1)),
    ("linalg.norm", (F,), dict(ord=1)), ("linalg.inv", (SQ,), {}),
    ("linalg.pinv", (F,), {}), ("linalg.det", (SQ,), {}),
    ("linalg.slogdet", (SQ,), {}), ("linalg.cholesky", (SPD,), {}),
    ("linalg.eigvalsh", (SPD,), {}),
    ("linalg.solve", (SQ, A(onp.float32([1.0, 2.0, 3.0]))), {}),
    ("linalg.matrix_rank", (F,), {}), ("linalg.matrix_power", (SQ, 3), {}),
    ("linalg.multi_dot", ([F, A(_R.randn(4, 2).astype(onp.float32)),
                           A(_R.randn(2, 3).astype(onp.float32))],), {}),
    ("linalg.svd", (F,), dict(compute_uv=False)),
    ("fft.fft", (V,), {}), ("fft.rfft", (V,), {}), ("fft.fft2", (F,), {}),
    ("fft.irfft", (A(onp.complex64([1, 2 + 1j, 3])),), {}),
    ("fft.fftshift", (V,), {}), ("fft.fftfreq", (8,), {}),
    ("fft.rfftfreq", (8, 0.5), {}),
]
_DECOMP = {"linalg.inv", "linalg.pinv", "linalg.det", "linalg.slogdet",
           "linalg.cholesky", "linalg.eigvalsh", "linalg.solve",
           "linalg.matrix_power", "linalg.svd", "linalg.multi_dot",
           "i0", "percentile", "quantile", "cov", "corrcoef", "nanstd",
           "std", "var", "nanvar", "fft.fft2", "fft.irfft"}


@pytest.mark.parametrize("case", range(len(SWEEP)),
                         ids=[f"{i}-{c[0]}" for i, c in enumerate(SWEEP)])
def test_sweep_against_the_jax_namespace(case):
    name, args, kwargs = SWEEP[case]
    _twin(name, *args, tol=1e-4 if name in _DECOMP else RTOL, **kwargs)


def test_every_jax_function_is_here():
    """The port's namespace holds every function the JAX package's
    generated (its list, as far as its ``jax.numpy`` provides them), and
    the sweep calls all but the creation helpers that take callables."""
    names = [n for n in jnp_mx._FUNCS if callable(getattr(jnp_mx, n, None))
             and getattr(jnp_mx, n).__module__ == "mxnet_tpu.np"]
    assert names and all(callable(getattr(mnp, n, None)) for n in names)
    swept = {c[0] for c in SWEEP}
    assert set(names) - swept <= {"fromfunction"}


def test_fromfunction():
    got = mnp.fromfunction(lambda i, j: i * 10 + j, (2, 3),
                           dtype=onp.int32)
    want = jnp_mx.fromfunction(lambda i, j: i * 10 + j, (2, 3),
                               dtype=onp.int32)
    _same(got, want, RTOL, "fromfunction")


@pytest.mark.parametrize("sampler,args", [
    ("uniform", dict(low=-1.0, high=3.0, size=(20000,))),
    ("normal", dict(loc=1.0, scale=2.0, size=(20000,))),
    ("exponential", dict(scale=2.0, size=(20000,))),
    ("gamma", dict(shape_param=3.0, size=(20000,))),
    ("beta", dict(a=2.0, b=5.0, size=(20000,))),
    ("binomial", dict(n=10, p=0.3, size=(20000,))),
    ("randint", dict(low=2, high=9, size=(20000,)))])
def test_samplers_match_in_distribution(sampler, args):
    """Shape, dtype, and mean and variance within 5 standard errors /
    5% of the JAX package's draws."""
    mx.random.seed(0)
    jmx.random.seed(0)
    got = getattr(mnp.random, sampler)(**args)
    want = getattr(jnp_mx.random, sampler)(**args)
    assert got.shape == want.shape and _dt(got) == _dt(want)
    g, w = got.asnumpy().astype(onp.float64), want.asnumpy().astype(
        onp.float64)
    se = w.std() / onp.sqrt(w.size)
    assert abs(g.mean() - w.mean()) < 5 * onp.sqrt(2) * se
    assert abs(g.var() / w.var() - 1) < 0.05


def test_choice_permutation_multinomial():
    mx.random.seed(0)
    c = mnp.random.choice(5, size=(3, 2))
    jc = jnp_mx.random.choice(5, size=(3, 2))
    assert c.shape == jc.shape and _dt(c) == _dt(jc)
    p = mnp.random.permutation(6)
    assert sorted(p.asnumpy().tolist()) == list(range(6))
    assert _dt(p) == _dt(jnp_mx.random.permutation(6))
    m = mnp.random.multinomial(10, [0.2, 0.8], size=(4,))
    jm = jnp_mx.random.multinomial(10, [0.2, 0.8], size=(4,))
    assert m.shape == jm.shape and _dt(m) == _dt(jm)
    assert (m.asnumpy().sum(-1) == 10).all()
