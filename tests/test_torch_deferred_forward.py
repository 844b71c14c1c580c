"""PyTorch port, the lazy forward of a hybridized block and the full
fused step (``mxnet_tpu_torch/gluon/cached_op.py`` ``_Lazy``,
``ndarray/ndarray.py``'s lazy state, ``autograd._deferrable``,
``gluon/trainer.py``'s full step), the two repaired faults of the
Gluon tier (any number of recorded calls of one signature before a
backward; ``trainer.grad_norm``) and ``clip_global_norm`` as one
program.

Twins of ``tests/test_gluon_trainer.py::TestFusedHybridStep::
test_deferred_forward_compiles_one_program`` and
``::test_deferred_forward_read_before_step_materializes`` (the
reference's tolerances), of
``::test_clip_global_norm_one_program_across_thresholds`` and of
``tests/test_runtime_metrics.py::test_trainer_grad_norm_gauge_gated``
(on the eager path and on the fused one); against the JAX package: the
deferred ``LossBlock`` over 3 Adam steps (losses rtol 1e-4, parameters
rtol 1e-3 / atol 1e-4: the reference's bounds for its own fused vs
eager paths, since Adam's normalised step turns the rounding of a
near-zero gradient, summed in another order, into up to lr on that
weight), ``waitall`` with a lazy output, and 6 and 8 recorded calls of
one signature before one ``autograd.backward`` (gradients to 1e-6).
The port's own cases: each read path of a lazy output, an input written
in place between ``record()`` and ``step()``, BatchNorm's running
statistics and Dropout's masks against the eager path,
``MXNET_DEFERRED_HYBRID_FWD=0``, and the full step on the card's control
flow (``StandIn``).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch import runtime_metrics as rm
from mxnet_tpu_torch.gluon import nn

from test_torch_cached_op import stand_in  # noqa: F401
from test_torch_fused_trainer import _inner, _jax_twin, _loss_block


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _build(seed, pkg=mx):
    """The reference's ``TestFusedHybridStep._build``."""
    pkg.random.seed(seed)
    net = _inner(pkg)
    net.initialize(pkg.init.Xavier())
    blk = _loss_block(pkg, net)
    blk.hybridize(static_alloc=True)
    return net, blk


def _data(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(8, 4).astype(np.float32), \
        rng.randn(8, 1).astype(np.float32)


def _params(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def _run(net, blk, X, Y, steps, opt="adam", lr=1e-2, read_early=False,
         ndm=nd, pkg=mx):
    tr = pkg.gluon.Trainer(net.collect_params(), opt, {"learning_rate": lr})
    losses, lazy = [], []
    for _ in range(steps):
        x, y = ndm.array(X), ndm.array(Y)
        with pkg.autograd.record():
            loss = blk(x, y)
        lazy.append(getattr(loss, "_lazy_cb" if pkg is jmx else "_lazy")
                    is not None)
        loss.backward()
        if read_early:
            losses.append(float(loss.asscalar()))
        tr.step(8)
        if not read_early:
            losses.append(float(loss.asscalar()))
    return losses, tr, lazy


# ---------------------------------------------------------------------------
# twins of TestFusedHybridStep
# ---------------------------------------------------------------------------
def test_deferred_forward_compiles_one_program():
    net, blk = _build(31)
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    X, Y = _data(9)
    x, y = nd.array(X), nd.array(Y)
    losses = []
    for it in range(3):
        with autograd.record():
            loss = blk(x, y)
        if it > 0:
            assert loss._lazy is not None
        loss.backward()
        tr.step(8)
        assert loss._lazy is None
        losses.append(float(loss.asnumpy()))
    assert any(isinstance(k, tuple) and k and k[0] == "full"
               for k in tr._fused_step_progs)
    assert losses[0] > losses[-1]
    for p in net.collect_params().values():
        if p.grad_req != "null":
            assert np.isfinite(p.grad().asnumpy()).all()


def test_deferred_forward_read_before_step_materializes():
    X, Y = _data(10)
    out = {}
    for read_early in (False, True):
        net, blk = _build(32)
        vals, tr, lazy = _run(net, blk, X, Y, 3, opt="sgd",
                              read_early=read_early)
        assert lazy == [False, True, True]
        full = [k for k in tr._fused_step_progs if k[0] == "full"]
        assert bool(full) == (not read_early)
        out[read_early] = (vals, _params(net))
    np.testing.assert_allclose(out[True][0], out[False][0],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_deferred_loss_block_matches_jax(tmp_path):
    X, Y = _data(0)
    jnet, net = _inner(jmx), _inner(mx)
    jmx.random.seed(21)
    jnet.initialize(jmx.init.Xavier())
    _jax_twin(tmp_path, jnet, net, "lossblock.npz")
    res = []
    for pkg, ndm, inner in ((mx, nd, net), (jmx, jnd, jnet)):
        blk = _loss_block(pkg, inner)
        blk.hybridize(static_alloc=True)
        losses, tr, lazy = _run(inner, blk, X, Y, 3, ndm=ndm, pkg=pkg)
        assert lazy == [False, True, True]
        assert any(k[0] == "full" for k in tr._fused_step_progs)
        res.append((losses, _params(inner)))
    (lo, po), (lr, pr) = res
    np.testing.assert_allclose(lo, lr, rtol=1e-4, atol=1e-5)
    for a, b in zip(po, pr):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_deferred_forward_off_gives_the_backward_update_path(monkeypatch):
    """``MXNET_DEFERRED_HYBRID_FWD=0``: no lazy output and no full step,
    the deferred backward + update entry instead; the same numbers as
    the full step."""
    X, Y = _data(12)
    out = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("MXNET_DEFERRED_HYBRID_FWD", knob)
        net, blk = _build(33)
        losses, tr, lazy = _run(net, blk, X, Y, 4)
        keys = list(tr._fused_step_progs)
        assert lazy == [False] + [knob == "1"] * 3
        assert any(k[0] == "full" for k in keys) == (knob == "1")
        out[knob] = (losses, _params(net))
    np.testing.assert_allclose(out["0"][0], out["1"][0], rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(out["0"][1], out["1"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# reads of a lazy output
# ---------------------------------------------------------------------------
def _lazy_loss():
    """A lazy loss after one step, and the eager block's loss there."""
    X, Y = _data(13)
    out = []
    for hybrid in (False, True):
        net, blk = _build(34)
        if not hybrid:
            blk.hybridize(False)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        x, y = nd.array(X), nd.array(Y)
        with autograd.record():
            blk(x, y).backward()
        tr.step(8)
        with autograd.record():
            out.append(blk(x, y))
    eager, loss = out
    assert loss._lazy is not None
    return loss, float(eager.asscalar())


_READS = {
    "asnumpy": lambda a: a.asnumpy(),
    "asscalar": lambda a: a.asscalar(),
    "wait_to_read": lambda a: a.wait_to_read().asnumpy(),
    "op_input": lambda a: nd.exp(a).log(),
    "indexing": lambda a: a.reshape((1,))[0],
    "copyto": lambda a: a.copyto(nd.zeros(())),
    "copyto_context": lambda a: a.copyto(mx.cpu(1)),
    "as_in_context": lambda a: a.as_in_context(mx.cpu(1)),
    "arithmetic": lambda a: a * 1.0,
    "float": float,
    "data_torch": lambda a: nd.NDArray._wrap(a.data_torch.clone()),
}


@pytest.mark.parametrize("read", sorted(_READS))
def test_each_read_of_a_lazy_output_materializes(read):
    loss, want = _lazy_loss()
    assert loss.shape == () and loss.ndim == 0 and loss.size == 1
    assert loss.dtype == np.float32 and loss.context == mx.cpu(0)
    assert loss._lazy is not None          # the metadata ran nothing
    got = _READS[read](loss)
    assert loss._lazy is None
    got = float(got) if not isinstance(got, nd.NDArray) \
        else float(got.asscalar())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(float(loss.asscalar()), want, rtol=1e-6)


def test_waitall_runs_a_lazy_forward_as_the_jax_package_does(tmp_path):
    X, Y = _data(14)
    jnet, net = _inner(jmx), _inner(mx)
    jmx.random.seed(22)
    jnet.initialize(jmx.init.Xavier())
    _jax_twin(tmp_path, jnet, net, "waitall.npz")
    got = []
    for pkg, ndm, inner in ((mx, nd, net), (jmx, jnd, jnet)):
        blk = _loss_block(pkg, inner)
        blk.hybridize(static_alloc=True)
        tr = pkg.gluon.Trainer(inner.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        x, y = ndm.array(X), ndm.array(Y)
        with pkg.autograd.record():
            blk(x, y).backward()
        tr.step(8)
        with pkg.autograd.record():
            loss = blk(x, y)
        assert loss._lazy_cb is not None if pkg is jmx \
            else loss._lazy is not None
        pkg.waitall()
        assert loss._lazy_cb is None if pkg is jmx else loss._lazy is None
        got.append(float(loss.asscalar()))
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5)


def test_input_written_in_place_after_record_does_not_change_the_step():
    X, Y = _data(15)
    out = []
    for write in (False, True):
        net, blk = _build(35)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2})
        x, y = nd.array(X), nd.array(Y)
        losses = []
        for _ in range(3):
            with autograd.record():
                loss = blk(x, y)
            if write:
                x[:] = 100.0                # after record(), before step
            loss.backward()
            tr.step(8)
            losses.append(float(loss.asscalar()))
            x = nd.array(X)
        out.append((losses, _params(net)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


def test_batchnorm_running_statistics_match_the_eager_path():
    X, Y = _data(16)
    stats = []
    for hybrid in (True, False):
        net, blk = _build(36)
        if not hybrid:
            blk.hybridize(False)
        losses, _tr, lazy = _run(net, blk, X, Y, 4)
        assert lazy == [False] + [hybrid] * 3
        bn = net[1]
        stats.append([bn.running_mean.data().asnumpy(),
                      bn.running_var.data().asnumpy(), losses])
    for a, b in zip(stats[0][:2], stats[1][:2]):
        assert not np.allclose(a, 0.0) and not np.allclose(b, 1.0)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stats[0][2], stats[1][2], rtol=1e-4)


def test_set_data_runs_a_lazy_forward_with_the_old_weights():
    X, Y = _data(21)
    got = []
    for replace in (False, True):
        net, blk = _build(41)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        x, y = nd.array(X), nd.array(Y)
        with autograd.record():
            blk(x, y).backward()
        tr.step(8)
        with autograd.record():
            loss = blk(x, y)
        assert loss._lazy is not None
        if replace:
            net[0].weight.set_data(nd.zeros(net[0].weight.shape))
            assert loss._lazy is None
        got.append(float(loss.asscalar()))
    assert got[0] == got[1]


_WRITES = {
    "setitem": lambda w: w.__setitem__(slice(None), 0.5),
    "setitem_row": lambda w: w.__setitem__(0, 0.5),
    "iadd": lambda w: w.__iadd__(0.5),
}


def _weight_written_after_record(pkg, ndm, inner, write, read_first):
    """One step, then a recorded call and its backward, a write of the
    first weight, the step, and the loss read before or after it."""
    blk = _loss_block(pkg, inner)
    blk.hybridize(static_alloc=True)
    tr = pkg.gluon.Trainer(inner.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    X, Y = _data(23)
    x, y = ndm.array(X), ndm.array(Y)
    with pkg.autograd.record():
        blk(x, y).backward()
    tr.step(8)
    with pkg.autograd.record():
        loss = blk(x, y)
    loss.backward()
    _WRITES[write](inner[0].weight.data())
    if read_first:
        got = float(loss.asscalar())
    tr.step(8)
    if not read_first:
        got = float(loss.asscalar())
    grads = [p.grad().asnumpy() for p in inner.collect_params().values()
             if p.grad_req != "null"]
    return got, grads, _params(inner)


@pytest.mark.parametrize("read_first", [False, True])
@pytest.mark.parametrize("write", sorted(_WRITES))
def test_weight_written_after_record_matches_jax(tmp_path, write,
                                                 read_first):
    """A weight written in place between ``record()`` and the step: the
    loss and the gradients are those of the recorded weights, as the JAX
    package's record-time snapshot gives.  The update starts from the
    written value, as the JAX package's materialized path does (read
    first); its full step starts from its snapshot, so the port is held
    to the read-first run there too."""
    jnet, net = _inner(jmx), _inner(mx)
    jmx.random.seed(24)
    jnet.initialize(jmx.init.Xavier())
    _jax_twin(tmp_path, jnet, net, "written.npz")
    got = _weight_written_after_record(mx, nd, net, write, read_first)
    want = _weight_written_after_record(jmx, jnd, jnet, write, True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_weight_written_before_backward_raises():
    """A recorded call, a write of its weight, then its backward: the
    forward ran first at the recorded weights, but the replay's backward
    would read the written ones, so it raises."""
    net, blk = _build(42)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    X, Y = _data(24)
    x, y = nd.array(X), nd.array(Y)
    with autograd.record():
        blk(x, y).backward()
    tr.step(8)
    with autograd.record():
        loss = blk(x, y)
    assert loss._lazy is not None
    net[0].weight.data()[:] = 0.5
    assert loss._lazy is None
    with pytest.raises(mx.base.MXNetError, match="written in place"):
        loss.backward()


def test_running_statistic_read_runs_the_lazy_forward():
    net, blk = _build(37)
    X, Y = _data(17)
    x, y = nd.array(X), nd.array(Y)
    gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with autograd.record():
        blk(x, y).backward()
    before = net[1].running_mean.data().asnumpy().copy()
    with autograd.record():
        loss = blk(x, y)
    assert loss._lazy is not None
    after = net[1].running_mean.data().asnumpy()
    assert loss._lazy is None
    assert not np.allclose(before, after)


def _dropout_block():
    class DropLoss(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = nn.Dense(16, in_units=4)
                self.drop = nn.Dropout(0.5)
                self.out = nn.Dense(1, in_units=16)

        def hybrid_forward(self, F, x, y):
            return ((self.out(self.drop(self.dense(x))) - y) ** 2).mean()

    mx.random.seed(38)
    blk = DropLoss()
    blk.initialize(mx.init.Xavier())
    blk.hybridize()
    return blk


def test_dropout_masks_of_the_deferred_and_materialized_forwards_agree():
    X, Y = _data(18)
    out = []
    for read_early in (False, True):
        blk = _dropout_block()
        mx.random.seed(7)
        losses, tr, lazy = _run(blk, blk, X, Y, 4, read_early=read_early)
        assert lazy == [False, True, True, True]
        out.append((losses, _params(blk)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_full_step_on_the_stand_in_graph_backend(stand_in):
    net, blk = _build(39)
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    X, Y = _data(19)
    x, y = nd.array(X), nd.array(Y)
    losses = []
    for it in range(5):
        with autograd.record():
            loss = blk(x, y)
        assert (loss._lazy is not None) == (it > 0)
        loss.backward()
        tr.step(8)
        losses.append(float(loss.asscalar()))
    prog = blk._cached_op._cache[next(iter(blk._cached_op._cache))]
    inst = prog.rec[0]
    # step 1: the eager warm-up call and the update graph; step 2: the
    # full step's eager call and capture; steps 3-5: its replays, and
    # no replay of the forward graph
    full = [e for k, e in inst.fused[tr].items() if k[0] == "full"]
    assert len(full) == 1 and full[0].replays == 3
    assert prog.replays == 0 and len(prog.rec) == 1
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert set(tr._optimizer._index_update_count.values()) == {5}


# ---------------------------------------------------------------------------
# Queue C: recorded calls of one signature before one backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("calls", [6, 8])
def test_recorded_calls_before_one_backward_match_jax_and_eager(calls):
    rs = np.random.RandomState(calls)
    w = rs.randn(2, 3).astype(np.float32)
    b = rs.randn(2).astype(np.float32)
    xs = [rs.randn(4, 3).astype(np.float32) for _ in range(calls)]
    grads = []
    for pkg, ndm, hybrid in ((mx, nd, True), (mx, nd, False),
                             (jmx, jnd, True)):
        net = pkg.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        net.weight.set_data(ndm.array(w))
        net.bias.set_data(ndm.array(b))
        if hybrid:
            net.hybridize()
        with pkg.autograd.record():
            ls = [net(ndm.array(x)).sum() for x in xs]
        pkg.autograd.backward(ls)
        grads.append((net.weight.grad().asnumpy(),
                      net.bias.grad().asnumpy()))
    for got in grads[1:]:
        for a, b_ in zip(grads[0], got):
            np.testing.assert_allclose(a, b_, rtol=1e-6, atol=1e-6)
    assert len(net._cached_op._cache) == 1


def test_each_waiting_call_holds_its_own_instance_and_idle_ones_are_reused():
    net = nn.Dense(2, in_units=3)
    net.initialize()
    net.hybridize()
    x = nd.ones((4, 3))
    for _ in range(2):
        with autograd.record():
            ls = [net(x).sum() for _ in range(8)]
        autograd.backward(ls)
    sig = net._cached_op.stats()["signatures"]
    assert len(sig) == 1 and sig[0]["instances"] == 8
    np.testing.assert_allclose(net.weight.grad().asnumpy(),
                               np.full((2, 3), 32.0))


# ---------------------------------------------------------------------------
# Queue C: trainer.grad_norm
# ---------------------------------------------------------------------------
@pytest.fixture
def grad_norm(monkeypatch):
    rm.reset()
    monkeypatch.setattr(rm, "_ENABLED", True)
    monkeypatch.setattr(rm, "_GRAD_NORM", True)
    yield rm
    rm.reset()


def _host_norm(net):
    return float(np.sqrt(sum(
        (p.grad().asnumpy().astype(np.float64) ** 2).sum()
        for p in net.collect_params().values() if p.grad_req != "null")))


def test_trainer_grad_norm_gauge_gated(grad_norm):
    net = gluon.nn.Dense(2)
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = nd.ones((4, 3))
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(4)
    assert rm.TRAINER_GRAD_NORM.value() > 0
    np.testing.assert_allclose(rm.TRAINER_GRAD_NORM.value(),
                               _host_norm(net), rtol=1e-12)


@pytest.mark.parametrize("path", ["fused_update", "backward_update", "full",
                                  "per_parameter"])
def test_trainer_grad_norm_on_every_step_path(grad_norm, monkeypatch, path):
    if path == "backward_update":
        monkeypatch.setenv("MXNET_DEFERRED_HYBRID_FWD", "0")
    net, blk = _build(40)
    if path in ("fused_update", "per_parameter"):
        blk.hybridize(False)
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    if path == "per_parameter":
        tr._optimizer.fused = False
    X, Y = _data(20)
    norms = []
    for _ in range(3):
        with autograd.record():
            loss = blk(nd.array(X), nd.array(Y))
        loss.backward()
        tr.step(8)
        norms.append(rm.TRAINER_GRAD_NORM.value())
        np.testing.assert_allclose(norms[-1], _host_norm(net), rtol=1e-12)
    keys = [k[0] for k in tr._fused_step_progs]
    assert ("full" in keys) == (path == "full")
    assert len(set(norms)) == 3


def test_grad_norm_off_publishes_nothing(monkeypatch):
    rm.reset()
    monkeypatch.setattr(rm, "_ENABLED", True)
    monkeypatch.setattr(rm, "_GRAD_NORM", False)
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with autograd.record():
        net(nd.ones((4, 3))).sum().backward()
    tr.step(4)
    assert rm.TRAINER_GRAD_NORM.value() == 0
    rm.reset()


# ---------------------------------------------------------------------------
# clip_global_norm
# ---------------------------------------------------------------------------
def test_clip_global_norm_one_program_across_thresholds():
    def clip(max_norm):
        arrays = [nd.ones((2, 2)) * 3, nd.ones((3,)) * 4]
        gluon.utils.clip_global_norm(arrays, max_norm)
        return arrays

    clip(1.0)
    baseline = gluon.utils.clip_programs()["programs"]
    clip(2.0)
    clip(3.5)
    assert gluon.utils.clip_programs()["programs"] == baseline


@pytest.mark.parametrize("max_norm", [1.0, 5.0, 100.0])
@pytest.mark.parametrize("check", [True, False])
def test_clip_global_norm_matches_jax(max_norm, check):
    rs = np.random.RandomState(int(max_norm))
    host = [rs.randn(3, 4).astype(np.float32),
            rs.randn(5).astype(np.float32)]
    got = []
    for ndm, utils in ((nd, gluon.utils), (jnd, jmx.gluon.utils)):
        arrays = [ndm.array(a) for a in host]
        total = utils.clip_global_norm(arrays, max_norm,
                                       check_isfinite=check)
        if not check:
            total = float(total.asscalar())
        got.append((total, [a.asnumpy() for a in arrays]))
    np.testing.assert_allclose(got[0][0], got[1][0], rtol=1e-6)
    for a, b in zip(got[0][1], got[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_clip_global_norm_one_capture_on_the_stand_in(stand_in):
    """The card's control flow: the first call over a list of tensors
    runs and captures, later calls over them replay, other tensors of the
    same shapes capture again.  The stand-in's capture runs the function,
    which a CUDA capture does not, so the values are held on the replays
    (the CPU cases above hold every call)."""
    from mxnet_tpu_torch.gluon import utils
    shapes = [(7, 3), (11,)]
    arrays = [nd.ones(s) * 2 for s in shapes]
    before = utils.clip_programs()
    want = np.sqrt(4.0 * (21 + 11))
    for k, m in enumerate((0.5, 1.5, 2.5)):
        for a in arrays:
            a[:] = 2.0
        total = utils.clip_global_norm(arrays, m)
        np.testing.assert_allclose(total, want, rtol=1e-6)
        if k:
            np.testing.assert_allclose(arrays[0].asnumpy(),
                                       2 * m / (want + 1e-8), rtol=1e-6)
    after = utils.clip_programs()
    assert after["programs"] == before["programs"] + 1
    assert after["captures"] == before["captures"] + 1
    assert after["replays"] == before["replays"] + 2
    utils.clip_global_norm([nd.ones(s) for s in shapes], 1.0)
    again = utils.clip_programs()
    assert again["programs"] == after["programs"]
    assert again["captures"] == after["captures"] + 1
