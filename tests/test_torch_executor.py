"""PyTorch port, the Executor: twins of ``tests/test_module.py``'s
``TestExecutor`` and ``TestExecutorModes`` (the JAX package's executor
and the port's on the same seeded numpy inputs, the port on the CPU),
BatchNorm's moving statistics in training, ``grad_req`` as a string, a
list and a dict, and a ``flash_selfatt`` graph (L 16, 2 heads, units
32, a row of length 0) whose forward and every argument's gradient match
the JAX package's (its Pallas flash kernel in interpreter mode, as
``tests/test_torch_flash_attention.py`` runs it).

Tolerances: fp32 forward 1e-5 relative to the output's max; gradients
1e-4 relative to each gradient's max|grad|.  On the CPU a program runs
without CUDA graphs; the graphs' failure rule is held with a stand-in
capture that fails.
"""
import contextlib

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch.base import KernelError

FWD_RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, (what, err)


def _both(fn):
    """``fn(pkg)`` for the port and the JAX package."""
    return fn(mx), fn(jmx)


# ---------------------------------------------------- TestExecutor twins
def test_simple_bind_forward():
    def run(pkg):
        S = pkg.sym
        z = 2.0 * S.var("x") + S.var("y")
        ex = z.simple_bind(pkg.cpu(), x=(2, 3), y=(2, 3))
        ex.arg_dict["x"][:] = 1.0
        ex.arg_dict["y"][:] = 3.0
        return ex.forward()[0].asnumpy()
    ours, theirs = _both(run)
    np.testing.assert_allclose(ours, np.full((2, 3), 5.0))
    np.testing.assert_array_equal(ours, theirs)


def test_bind_backward_grads():
    def run(pkg):
        S, ndm = pkg.sym, pkg.nd
        z = S.sum(S.var("x") * S.var("w"))
        xv = ndm.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        wv = ndm.array(np.full((2, 3), 2.0, dtype=np.float32))
        gx, gw = ndm.zeros((2, 3)), ndm.zeros((2, 3))
        ex = z.bind(pkg.cpu(), {"x": xv, "w": wv},
                    args_grad={"x": gx, "w": gw})
        ex.forward(is_train=True)
        ex.backward()
        return gx.asnumpy(), gw.asnumpy(), xv.asnumpy(), wv.asnumpy()
    ours, theirs = _both(run)
    np.testing.assert_allclose(ours[0], ours[3])
    np.testing.assert_allclose(ours[1], ours[2])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_grad_req_add_and_null():
    def run(pkg):
        S, ndm = pkg.sym, pkg.nd
        z = S.sum(S.var("x") * S.var("x"))
        xv = ndm.array(np.ones((3,), dtype=np.float32))
        gx = ndm.zeros((3,))
        ex = z.bind(pkg.cpu(), {"x": xv}, args_grad={"x": gx},
                    grad_req="add")
        for _ in range(3):
            ex.forward(is_train=True)
            ex.backward()
        ex2 = z.bind(pkg.cpu(), {"x": xv}, grad_req="null")
        ex2.forward(is_train=True)
        ex2.backward()          # no-op, no crash
        return gx.asnumpy(), ex2.grad_dict
    ours, theirs = _both(run)
    np.testing.assert_allclose(ours[0], np.full((3,), 6.0))
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1] == {}


def test_compile_cache_reused():
    def run(pkg):
        S, ndm = pkg.sym, pkg.nd
        z = S.exp(S.var("x")) + 1.0
        ex = z.bind(pkg.cpu(), {"x": ndm.zeros((4, 4))})
        ex.forward()
        n = ex.num_compiles
        rs = np.random.RandomState(0)
        outs = []
        for _ in range(5):
            v = rs.rand(4, 4).astype(np.float32)
            outs.append(ex.forward(x=ndm.array(v))[0].asnumpy())
        return n, ex.num_compiles, outs
    ours, theirs = _both(run)
    assert ours[0] == ours[1] == theirs[0] == theirs[1] == 1
    for a, b in zip(ours[2], theirs[2]):
        _close(a, b, FWD_RTOL)


def test_copy_params_and_outputs_dict():
    def run(pkg):
        S, ndm = pkg.sym, pkg.nd
        z = S.broadcast_add(S.var("x"), S.var("w"), name="z")
        ex = z.simple_bind(pkg.cpu(), x=(2,), w=(2,))
        ex.copy_params_from({"w": ndm.array(np.array([5., 7.],
                                                     dtype=np.float32))},
                            allow_extra_params=True)
        ex.forward(x=ndm.zeros((2,)))
        return list(ex.output_dict), ex.outputs[0].asnumpy()
    ours, theirs = _both(run)
    assert ours[0] == theirs[0] == ["z_output"]
    np.testing.assert_allclose(ours[1], [5., 7.])


def test_compile_counts_match_jax_over_train_and_eval():
    """A forward program a (signature, train), a backward one: the JAX
    package's count, call for call."""
    def run(pkg):
        S, ndm = pkg.sym, pkg.nd
        z = S.sum(S.tanh(S.var("x")) * S.var("w"))
        ex = z.bind(pkg.cpu(), {"x": ndm.ones((3, 2)), "w": ndm.ones((3, 2))})
        counts = []
        for train in (False, True, True, False, True):
            ex.forward(is_train=train)
            if train:
                ex.backward()
            counts.append(ex.num_compiles)
        return counts
    ours, theirs = _both(run)
    assert ours == theirs == [1, 3, 3, 3, 3]


def test_grad_req_list_and_dict_and_head_gradient():
    rs = np.random.RandomState(3)
    x = rs.randn(4, 3).astype(np.float32)
    w = rs.randn(5, 3).astype(np.float32)
    cot = rs.randn(4, 5).astype(np.float32)

    def run(pkg, req):
        S, ndm = pkg.sym, pkg.nd
        z = S.FullyConnected(S.var("x"), S.var("w"), no_bias=True,
                             num_hidden=5, name="fc")
        grads = {"x": ndm.zeros((4, 3)), "w": ndm.zeros((5, 3))}
        ex = z.bind(pkg.cpu(), {"x": ndm.array(x), "w": ndm.array(w)},
                    args_grad=grads, grad_req=req)
        ex.forward(is_train=True)
        ex.backward(out_grads=ndm.array(cot))
        return {k: v.asnumpy() for k, v in grads.items()}

    for req in (["null", "write"], {"w": "write"}, "write"):
        ours, theirs = run(mx, req), run(jmx, req)
        for k in ours:
            _close(ours[k], theirs[k], GRAD_RTOL, what=(req, k))
    assert not run(mx, {"w": "write"})["x"].any()
    _close(run(mx, "write")["w"], cot.T @ x, GRAD_RTOL)


def test_errors_match_jax():
    for pkg in (mx, jmx):
        S, ndm = pkg.sym, pkg.nd
        z = S.sum(S.var("x") * 2.0)
        ex = z.bind(pkg.cpu(), {"x": ndm.ones((2, 2))})
        with pytest.raises(pkg.MXNetError):
            ex.backward()                   # before forward
        ex.forward(is_train=False)
        with pytest.raises(pkg.MXNetError):
            ex.backward()                   # after an inference forward
        with pytest.raises(pkg.MXNetError):
            ex.forward(x=ndm.ones((3, 2)))   # shape mismatch
        with pytest.raises(pkg.MXNetError):
            ex.forward(y=ndm.ones((2, 2)))   # unknown argument
        with pytest.raises(pkg.MXNetError):
            z.bind(pkg.cpu(), {})           # missing argument
        with pytest.raises(pkg.MXNetError):
            z.bind(pkg.cpu(), {"x": ndm.ones((2,))}, grad_req="maybe")


def test_forward_writes_the_bound_array_in_place():
    """``forward(x=...)`` copies into the bound array (the static buffer
    a graph reads); the array object and its tensor stay."""
    x = nd.zeros((2, 2))
    ex = (sym.var("x") * 3.0).bind(mx.cpu(), {"x": x})
    ex.forward()
    before = x._data
    out = ex.forward(x=nd.ones((2, 2)))[0].asnumpy()
    assert ex.arg_dict["x"] is x and x._data is before
    np.testing.assert_array_equal(x.asnumpy(), np.ones((2, 2)))
    np.testing.assert_array_equal(out, np.full((2, 2), 3.0))
    x._set_data(nd.full((2, 2), 2.0)._data)     # a replaced value
    out = ex.forward()[0].asnumpy()
    np.testing.assert_array_equal(out, np.full((2, 2), 6.0))
    assert x._data is before


def test_reshape_shares_unchanged_arrays():
    for pkg in (mx, jmx):
        S = pkg.sym
        z = S.FullyConnected(S.var("data"), S.var("w"), S.var("b"),
                             num_hidden=3, name="fc")
        ex = z.simple_bind(pkg.cpu(), data=(2, 4))
        ex2 = ex.reshape(data=(5, 4))
        assert ex2.arg_dict["w"] is ex.arg_dict["w"]
        assert ex2.arg_dict["data"].shape == (5, 4)
        assert ex2.forward()[0].shape == (5, 3)


def test_group2ctx_is_kept_as_metadata():
    with mx.AttrScope(ctx_group="dev1"):
        a = sym.var("a") * 2.0
    ex = a.bind(mx.cpu(), {"a": nd.ones((2,))},
                group2ctx={"dev1": mx.cpu(0)})
    assert ex._group2ctx == {"dev1": mx.cpu(0)}
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), [2.0, 2.0])


# ---------------------------------------------- TestExecutorModes twins
def test_dropout_active_in_train_mode():
    x = sym.var("x")
    y = sym.Dropout(x, p=0.5)
    ex = y.bind(mx.cpu(), {"x": nd.array(np.ones((64, 64), np.float32))})
    train_out = ex.forward(is_train=True)[0].asnumpy()
    assert (train_out == 0).sum() > 0
    assert set(np.unique(train_out)) <= {0.0, 2.0}
    second = ex.forward(is_train=True)[0].asnumpy()
    assert not np.array_equal(train_out, second)
    eval_out = ex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_array_equal(eval_out, np.ones((64, 64)))


def test_dropout_backward_uses_the_forwards_mask():
    x = nd.array(np.ones((32, 32), np.float32))
    g = nd.zeros((32, 32))
    ex = sym.Dropout(sym.var("x"), p=0.5).bind(mx.cpu(), {"x": x},
                                               args_grad={"x": g})
    for _ in range(2):
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        np.testing.assert_array_equal(g.asnumpy(), out)


def _bn_symbol(pkg):
    S = pkg.sym
    bn = S.BatchNorm(S.var("data"), S.var("gamma"), S.var("beta"),
                     S.var("mm"), S.var("mv"), momentum=0.5,
                     fix_gamma=False, name="bn")
    bn._outputs[0][0].inputs[3][0].attrs["__aux__"] = "1"
    bn._outputs[0][0].inputs[4][0].attrs["__aux__"] = "1"
    return bn


def test_batchnorm_aux_updated_by_executor():
    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype(np.float32) * 3 + 7

    def run(pkg):
        ndm = pkg.nd
        args = {"data": ndm.array(x), "gamma": ndm.ones((4,)),
                "beta": ndm.zeros((4,))}
        aux = {"mm": ndm.zeros((4,)), "mv": ndm.ones((4,))}
        ex = _bn_symbol(pkg).bind(pkg.cpu(), args, aux_states=aux,
                                  grad_req="null")
        out = [ex.forward(is_train=True)[0].asnumpy()]
        stats = [(ex.aux_dict["mm"].asnumpy().copy(),
                  ex.aux_dict["mv"].asnumpy().copy())]
        out.append(ex.forward(is_train=True)[0].asnumpy())
        stats.append((ex.aux_dict["mm"].asnumpy().copy(),
                      ex.aux_dict["mv"].asnumpy().copy()))
        out.append(ex.forward(is_train=False)[0].asnumpy())
        stats.append((ex.aux_dict["mm"].asnumpy().copy(),
                      ex.aux_dict["mv"].asnumpy().copy()))
        return out, stats, aux["mm"].asnumpy()

    ours, theirs = run(mx), run(jmx)
    np.testing.assert_allclose(ours[1][0][0], 0.5 * x.mean(axis=0),
                               rtol=1e-4, atol=1e-4)
    assert np.all(ours[1][0][1] > 1.5)
    # inference leaves them as they are, and reads them
    np.testing.assert_array_equal(ours[1][2][0], ours[1][1][0])
    # the bound aux arrays are written in place
    np.testing.assert_array_equal(ours[2], ours[1][2][0])
    for a, b in zip(ours[0], theirs[0]):
        _close(a, b, FWD_RTOL)
    for (am, av), (bm, bv) in zip(ours[1], theirs[1]):
        _close(am, bm, FWD_RTOL)
        _close(av, bv, FWD_RTOL)


def test_batchnorm_grads_with_aux_update_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(8, 3, 4, 4).astype(np.float32)
    cot = rng.randn(8, 3, 4, 4).astype(np.float32)
    gamma = rng.rand(3).astype(np.float32) + 0.5
    beta = np.linspace(-1, 1, 3, dtype=np.float32)

    def run(pkg):
        ndm = pkg.nd
        args = {"data": ndm.array(x), "gamma": ndm.array(gamma),
                "beta": ndm.array(beta)}
        grads = {k: ndm.zeros(v.shape) for k, v in args.items()}
        aux = {"mm": ndm.zeros((3,)), "mv": ndm.ones((3,))}
        ex = _bn_symbol(pkg).bind(pkg.cpu(), args, args_grad=grads,
                                  aux_states=aux)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=ndm.array(cot))
        return out, {k: v.asnumpy() for k, v in grads.items()}, \
            aux["mv"].asnumpy()

    ours, theirs = run(mx), run(jmx)
    _close(ours[0], theirs[0], FWD_RTOL)
    for k in ours[1]:
        _close(ours[1][k], theirs[1][k], GRAD_RTOL, what=k)
    _close(ours[2], theirs[2], FWD_RTOL)


def test_module_load_restores_params(tmp_path):
    x = sym.var("data")
    out = sym.FullyConnected(x, sym.var("w"), sym.var("b"), num_hidden=3)
    mod = mx.module.Module(out, label_names=None, context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 5))], for_training=False)
    mod.init_params(initializer=mx.init.Xavier())
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 3)
    mod2 = mx.module.Module.load(prefix, 3, label_names=None,
                                 context=mx.cpu())
    mod2.bind(data_shapes=[("data", (2, 5))], for_training=False)
    np.testing.assert_array_equal(mod2._exec.arg_dict["w"].asnumpy(),
                                  mod._exec.arg_dict["w"].asnumpy())


def test_module_tolerates_missing_label():
    out = sym.FullyConnected(sym.var("data"), sym.var("w"), sym.var("b"),
                             num_hidden=3)
    mod = mx.module.Module(out, context=mx.cpu())
    assert "w" in mod._param_names and mod._label_names == []


# ------------------------------------------------------ the flash graph
def _flash_symbol(pkg):
    S = pkg.sym
    qkv = S.FullyConnected(S.var("data"), S.var("qkv_weight"),
                           S.var("qkv_bias"), num_hidden=96, flatten=False,
                           name="qkv")
    att = S.flash_selfatt(qkv, S.var("valid_length"), heads=2, name="att")
    return S.FullyConnected(att, S.var("proj_weight"), S.var("proj_bias"),
                            num_hidden=32, flatten=False, name="proj")


def test_flash_graph_forward_and_gradients_match_jax():
    L, B, units = 16, 3, 32
    shapes = dict(data=(L, B, units), valid_length=(B,))
    rs = np.random.RandomState(7)
    names = _flash_symbol(mx).list_arguments()
    arg_shapes = _flash_symbol(mx).infer_shape(**shapes)[0]
    args = {n: (rs.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(names, arg_shapes)}
    args["valid_length"] = np.array([16, 5, 0], np.float32)
    cot = rs.randn(L, B, units).astype(np.float32)

    def run(pkg):
        ndm = pkg.nd
        grads = {n: ndm.zeros(v.shape) for n, v in args.items()}
        ex = _flash_symbol(pkg).bind(
            pkg.cpu(), {n: ndm.array(v) for n, v in args.items()},
            args_grad=grads)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=ndm.array(cot))
        return out, {n: g.asnumpy() for n, g in grads.items()}

    ours, theirs = run(mx), run(jmx)
    _close(ours[0], theirs[0], FWD_RTOL, what="output")
    for n in names:
        _close(ours[1][n], theirs[1][n], GRAD_RTOL, what=n)
    assert not ours[1]["valid_length"].any()


# ------------------------------------------- the graphs' failure rule
class _FailingCapture:
    """A graph backend whose capture fails (the rule: KernelError on that
    call and on every later call of the program)."""

    def __init__(self):
        self.captures = 0

    def pool(self):
        return None

    @contextlib.contextmanager
    def on_stream(self):
        yield None

    def capture(self, fn, pool):
        self.captures += 1
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def test_failed_capture_raises_on_every_later_call(monkeypatch):
    backend = _FailingCapture()
    monkeypatch.setattr(mx.executor, "_graph_backend",
                        lambda device: backend)
    ex = (sym.var("x") * 2.0).bind(mx.cpu(), {"x": nd.ones((2,))})
    with pytest.raises(KernelError, match="capture"):
        ex.forward()
    with pytest.raises(KernelError, match="failed earlier"):
        ex.forward()
    assert backend.captures == 1
    assert ex.num_compiles == 1
