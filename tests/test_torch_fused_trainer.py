"""PyTorch port, the fused tiers of ``gluon.Trainer``
(``mxnet_tpu_torch/gluon/trainer.py``: ``_fused_update`` and
``_try_fused_hybrid_step``; the deferred backward of
``mxnet_tpu_torch/autograd.py``; ``_fused_one`` of SGD, Adam, AdamW).

Twins of ``tests/test_gluon_trainer.py::test_fused_update_matches_unfused``
(sgd / adam / adamw), ``::test_fused_update_multi_precision_bf16``,
``::test_fused_update_ineligible_falls_back`` and of
``TestFusedHybridStep`` (``_build``'s ``LossBlock``: Dense / BatchNorm /
Dense inside a hybridized loss block).  The reference's
``test_broken_fusion_no_double_count_advance`` falls back to the eager
path for a negative-cached entry; the port's graphs fail loudly, so its
twin holds the port's rule: a broken entry raises ``KernelError`` and the
update counts advance by 0.  The two lazy-forward tests
(``test_deferred_forward_*``) wait for the lazy forward (ROADMAP 6.2').

Against the JAX package, each hybridized with its fused tiers on and the
weights carried across: the ``LossBlock`` from the weights of the
reference's ``_build(21)``, 5 Adam steps at lr 1e-2 (losses rtol 1e-4,
parameters rtol 1e-3 / atol 1e-4, the reference's bounds for its own
fused vs eager paths), and a narrow flash encoder layer (L 16, batch 2,
32 units, 2 heads; the JAX op in the Pallas interpreter) inside a
hybridized block with its loss, 3 Adam steps at ``gluon_flash``'s lr
1e-4 (the first loss and every first gradient rtol / atol 1e-5, then the
bounds above).  Adam's first steps move a weight by about lr whatever
its gradient's size, so a gradient that is rounding noise (the key bias
of attention, whose exact gradient is 0; a BatchNorm feature that is
nearly constant over the batch) turns the two packages' summation
orders into differences of up to lr: the parameter bound holds where lr
is small against 1e-4 or no such feature exists.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import KernelError
from mxnet_tpu_torch.gluon import nn

from test_torch_cached_op import stand_in  # noqa: F401


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


# ---------------------------------------------------------------------------
# _fused_update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optname,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
])
def test_fused_update_matches_unfused(optname, kw):
    def build():
        net = nn.Sequential()
        net.add(nn.Dense(16, in_units=8), nn.Dense(4, in_units=16))
        net.initialize(mx.init.Xavier(rnd_type="gaussian"))
        return net

    mx.random.seed(42)
    net_a = build()
    mx.random.seed(42)
    net_b = build()
    tr_a = gluon.Trainer(net_a.collect_params(), optname, dict(kw))
    tr_b = gluon.Trainer(net_b.collect_params(), optname, dict(kw))
    tr_b._optimizer.fused = False
    assert tr_a._fused_eligible()
    x = nd.random.uniform(shape=(8, 8))
    y = nd.random.uniform(shape=(8, 4))
    for _step in range(4):
        for net, tr in ((net_a, tr_a), (net_b, tr_b)):
            with autograd.record():
                loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            tr.step(1)
    for (na, pa), (_nb, pb) in zip(net_a.collect_params().items(),
                                   net_b.collect_params().items()):
        assert np.allclose(pa.data().asnumpy(), pb.data().asnumpy(),
                           rtol=1e-5, atol=1e-6), (optname, na)
    assert len(tr_a._fused_progs) == 1
    assert tr_a._optimizer._index_update_count == \
        tr_b._optimizer._index_update_count


def test_fused_update_multi_precision_bf16():
    net = nn.Sequential()
    net.add(nn.Dense(16, in_units=8), nn.Dense(4, in_units=16))
    net.initialize()
    net.cast("bfloat16")
    tr = gluon.Trainer(net.collect_params(), "adamw",
                       {"learning_rate": 0.05, "multi_precision": True})
    assert tr._fused_eligible()
    x = nd.random.uniform(shape=(8, 8)).astype("bfloat16")
    y = nd.ones((8, 4)).astype("bfloat16")
    losses = []
    for _ in range(20):
        with autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asscalar()))
    assert losses[-1] < losses[0] * 0.5
    st = tr._updater.states[0]
    assert isinstance(st, tuple) and str(st[0].dtype) == "float32"
    assert len(tr._fused_progs) == 1


def test_fused_update_ineligible_falls_back():
    net = nn.Sequential()
    net.add(nn.Dense(4, in_units=8))
    net.initialize()
    for p in net.collect_params().values():
        p.grad_req = "add"
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.1})
    assert not tr._fused_eligible()
    x = nd.random.uniform(shape=(2, 8))
    with autograd.record():
        net(x).sum().backward()
    tr.step(1)
    assert not tr._fused_progs


def test_fused_update_follows_which_layer_is_frozen():
    """Freezing one of two equal-shaped layers, then the other: each
    subset gets its own entry, the frozen layer stays as it was, and the
    trained one matches the per-parameter path."""
    def build():
        net = nn.Sequential()
        net.add(nn.Dense(4, in_units=4), nn.Dense(4, in_units=4))
        net.initialize(mx.init.Xavier())
        return net

    mx.random.seed(7)
    net_a = build()
    mx.random.seed(7)
    net_b = build()
    tr_a = gluon.Trainer(net_a.collect_params(), "adam",
                         {"learning_rate": 0.05})
    tr_b = gluon.Trainer(net_b.collect_params(), "adam",
                         {"learning_rate": 0.05})
    tr_b._optimizer.fused = False
    rng = np.random.RandomState(3)
    x = nd.array(rng.randn(8, 4).astype(np.float32))
    y = nd.array(rng.randn(8, 4).astype(np.float32))
    for frozen in (0, 1, 0):
        for net, tr in ((net_a, tr_a), (net_b, tr_b)):
            for k in range(2):
                for p in net[k].collect_params().values():
                    p.grad_req = "null" if k == frozen else "write"
            held = [p.data().asnumpy().copy()
                    for p in net[frozen].collect_params().values()]
            for _step in range(2):
                with autograd.record():
                    loss = ((net(x) - y) ** 2).mean()
                loss.backward()
                tr.step(1)
            for p, w in zip(net[frozen].collect_params().values(), held):
                np.testing.assert_array_equal(p.data().asnumpy(), w)
    for (na, pa), (_nb, pb) in zip(net_a.collect_params().items(),
                                   net_b.collect_params().items()):
        np.testing.assert_allclose(pa.data().asnumpy(), pb.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=na)
    assert len(tr_a._fused_progs) == 2
    assert tr_a._optimizer._index_update_count == \
        tr_b._optimizer._index_update_count


def test_fused_update_keeps_addresses_and_refreshes_only_changes():
    net = nn.Dense(4, in_units=8)
    net.initialize()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.1})
    x = nd.random.uniform(shape=(2, 8))
    homes = None
    for step in range(3):
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        if step == 2:
            tr.set_learning_rate(0.05)
        tr.step(1)
        now = [p.data()._data for p in net.collect_params().values()]
        assert homes is None or all(a is b for a, b in zip(homes, now))
        homes = now
    entry = next(iter(tr._fused_progs.values()))
    assert entry.hyper[0] == (0.05, 0.05)
    np.testing.assert_array_equal(entry.ts.numpy(), [4.0, 4.0])
    assert tr.fused_stats()["binding_copies"] == 0


def test_fused_update_after_load_states(tmp_path):
    """States restored by ``load_states`` are adopted by the fused
    update: the restored trainer's next step equals the original's."""
    nets, trainers = [], []
    for seed in (0, 0):
        mx.random.seed(seed)
        net = nn.Dense(4, in_units=8)
        net.initialize(mx.init.Xavier())
        nets.append(net)
        trainers.append(gluon.Trainer(net.collect_params(), "sgd",
                                      {"learning_rate": 0.1,
                                       "momentum": 0.9}))
    x = nd.array(np.random.RandomState(1).randn(4, 8).astype(np.float32))

    def step(net, tr):
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(4)

    for _ in range(2):
        step(nets[0], trainers[0])
    path = str(tmp_path / "states")
    trainers[0].save_states(path)
    for pa, pb in zip(nets[0].collect_params().values(),
                      nets[1].collect_params().values()):
        pb.set_data(pa.data())
    step(nets[1], trainers[1])          # builds its fused entry
    for pa, pb in zip(nets[0].collect_params().values(),
                      nets[1].collect_params().values()):
        pb.set_data(pa.data())
    trainers[1].load_states(path)
    for net, tr in zip(nets, trainers):
        step(net, tr)
    for pa, pb in zip(nets[0].collect_params().values(),
                      nets[1].collect_params().values()):
        np.testing.assert_array_equal(pa.data().asnumpy(),
                                      pb.data().asnumpy())
    # set_data's two weights and load_states' two momenta
    assert trainers[1].fused_stats()["binding_copies"] == 4


# ---------------------------------------------------------------------------
# TestFusedHybridStep
# ---------------------------------------------------------------------------
def _loss_block(pkg, inner):
    class LossBlock(pkg.gluon.HybridBlock):
        def __init__(self, inner, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.inner = inner

        def hybrid_forward(self, F, x, y):
            return ((self.inner(x) - y) ** 2).mean()

    return LossBlock(inner)


def _inner(pkg):
    nnm = pkg.gluon.nn
    net = nnm.HybridSequential()
    net.add(nnm.Dense(16, activation="relu", in_units=4))
    net.add(nnm.BatchNorm(in_channels=16))
    net.add(nnm.Dense(1, in_units=16))
    return net


class TestFusedHybridStep:
    def _build(self, seed):
        mx.random.seed(seed)
        net = _inner(mx)
        net.initialize(mx.init.Xavier())
        blk = _loss_block(mx, net)
        blk.hybridize(static_alloc=True)
        return net, blk

    def _data(self, seed, scale=1.0):
        rng = np.random.RandomState(seed)
        return (nd.array(scale * rng.randn(8, 4).astype(np.float32)),
                nd.array(scale * rng.randn(8, 1).astype(np.float32)))

    def test_matches_eager_path(self, monkeypatch):
        rng = np.random.RandomState(0)
        X, Y = rng.randn(8, 4).astype(np.float32), \
            rng.randn(8, 1).astype(np.float32)
        out = {}
        for knob in ("0", "1"):
            monkeypatch.setenv("MXNET_FUSED_HYBRID_STEP", knob)
            net, blk = self._build(21)
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-2})
            losses, deferred = [], []
            for _ in range(5):
                x, y = nd.array(X), nd.array(Y)
                with autograd.record():
                    loss = blk(x, y)
                loss.backward()
                deferred.append(autograd.peek_pending() is not None)
                tr.step(8)
                losses.append(float(loss.asnumpy()))
            assert deferred == [knob == "1"] * 5
            out[knob] = (losses,
                         [p.data().asnumpy().copy()
                          for p in net.collect_params().values()],
                         [p.grad().asnumpy().copy()
                          for p in net.collect_params().values()
                          if p.grad_req != "null"])
        np.testing.assert_allclose(out["0"][0], out["1"][0],
                                   rtol=1e-4, atol=1e-5)
        for a, b in zip(out["0"][1], out["1"][1]):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
        for a, b in zip(out["0"][2], out["1"][2]):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)

    def test_grad_read_flushes_pending(self):
        net, blk = self._build(22)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 1e-2})
        x, y = self._data(1)
        with autograd.record():
            loss = blk(x, y)
        loss.backward()
        assert autograd.peek_pending() is not None
        p = next(iter(net.collect_params().values()))
        g = p.grad().asnumpy()
        assert autograd.peek_pending() is None
        assert np.isfinite(g).all() and np.abs(g).sum() > 0
        tr.step(8)

    def test_input_grads_via_fused_step(self):
        net, blk = self._build(23)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2})
        x, y = self._data(2)
        x.attach_grad()
        with autograd.record():
            loss = blk(x, y)
        loss.backward()
        assert autograd.peek_pending() is not None
        tr.step(8)
        assert autograd.peek_pending() is None
        assert np.abs(x.grad.asnumpy()).sum() > 0

    def test_waitall_flushes(self):
        net, blk = self._build(24)
        gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 1e-2})
        x, y = self._data(3)
        with autograd.record():
            loss = blk(x, y)
        loss.backward()
        assert autograd.peek_pending() is not None
        mx.waitall()
        assert autograd.peek_pending() is None

    def test_hoisted_grad_alias_sees_fresh_grads(self):
        net, blk = self._build(27)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 1e-2})
        params = [p for p in net.collect_params().values()
                  if p.grad_req != "null"]
        x, y = self._data(5)
        with autograd.record():
            loss = blk(x, y)
        loss.backward()
        tr.step(8)
        grads = [p.grad() for p in params]
        stale = [g.asnumpy().copy() for g in grads]
        x2, y2 = self._data(55, scale=3.0)
        with autograd.record():
            loss = blk(x2, y2)
        loss.backward()
        assert autograd.peek_pending() is not None
        fresh = [g.asnumpy() for g in grads]
        assert autograd.peek_pending() is None
        assert any(not np.allclose(a, b) for a, b in zip(stale, fresh))
        tr.step(8)

    def test_hoisted_grad_alias_as_op_input_flushes(self):
        net, blk = self._build(28)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 1e-2})
        params = [p for p in net.collect_params().values()
                  if p.grad_req != "null"]
        x, y = self._data(6)
        with autograd.record():
            loss = blk(x, y)
        loss.backward()
        tr.step(8)
        grads = [p.grad() for p in params]
        stale0 = grads[0].asnumpy().copy()
        x2, y2 = self._data(66, scale=3.0)
        with autograd.record():
            loss = blk(x2, y2)
        loss.backward()
        assert autograd.peek_pending() is not None
        scaled = grads[0] * 1.0
        assert autograd.peek_pending() is None
        assert not np.allclose(scaled.asnumpy(), stale0)
        tr.step(8)

    def test_update_runs_a_deferred_backward_first(self, monkeypatch):
        """``allreduce_grads()`` + ``update()`` after a deferred backward
        update with this step's gradients, as the eager path does."""
        params = []
        for knob in ("0", "1"):
            monkeypatch.setenv("MXNET_FUSED_HYBRID_STEP", knob)
            net, blk = self._build(32)
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-2})
            for seed in (10, 11):
                x, y = self._data(seed)
                with autograd.record():
                    loss = blk(x, y)
                loss.backward()
                assert (autograd.peek_pending() is not None) == \
                    (knob == "1")
                tr.allreduce_grads()
                tr.update(8)
            params.append([p.data().asnumpy()
                           for p in net.collect_params().values()])
        for a, b in zip(*params):
            np.testing.assert_array_equal(a, b)

    def test_failed_fused_step_restores_num_update(self, stand_in):
        net, blk = self._build(29)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2})
        x, y = self._data(7)
        for _ in range(3):      # eager warm-up; the fused entry; a replay
            with autograd.record():
                loss = blk(x, y)
            loss.backward()
            tr.step(8)
        inst = blk._cached_op._cache[next(iter(blk._cached_op._cache))].rec[0]
        entry = next(iter(inst.fused[tr].values()))
        assert entry.replays == 1
        o = tr._optimizer
        counts_before = dict(o._index_update_count)
        num_update_before = o.num_update

        def failing_replay():
            raise RuntimeError("synthetic replay failure")

        entry.graph.replay = failing_replay
        with autograd.record():
            loss = blk(x, y)
        loss.backward()
        with pytest.raises(KernelError, match="synthetic"):
            tr.step(8)
        assert dict(o._index_update_count) == counts_before
        assert o.num_update == num_update_before
        assert autograd.peek_pending() is None

    def test_broken_fusion_raises_and_counts_advance_by_zero(
            self, monkeypatch):
        """Both fused entries of a hybridized step: the backward + update
        (``MXNET_DEFERRED_HYBRID_FWD=0``) and the full step."""
        for knob in ("0", "1"):
            monkeypatch.setenv("MXNET_DEFERRED_HYBRID_FWD", knob)
            net, blk = self._build(25)
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-2})
            x, y = self._data(4)
            for _ in range(2):
                with autograd.record():
                    loss = blk(x, y)
                loss.backward()
                tr.step(8)
            o = tr._optimizer
            counts1 = dict(o._index_update_count)
            inst = blk._cached_op._cache[
                next(iter(blk._cached_op._cache))].rec[0]
            assert any(k[0] == "full" for k in inst.fused[tr]) \
                == (knob == "1")
            for entry in inst.fused[tr].values():
                entry.failed = RuntimeError("capture failed")
            for _ in range(2):
                with autograd.record():
                    loss = blk(x, y)
                loss.backward()
                with pytest.raises(KernelError, match="capture failed"):
                    tr.step(8)
                assert dict(o._index_update_count) == counts1
            if knob == "1":
                with pytest.raises(KernelError, match="capture failed"):
                    loss.asnumpy()

    def test_lr_change_and_frozen_param_through_fusion(self):
        mx.random.seed(26)
        net = nn.HybridSequential()
        net.add(nn.Dense(8, activation="relu", in_units=4))
        net.add(nn.Dense(1, in_units=8))
        net.initialize(mx.init.Xavier())
        frozen_p = next(iter(net.collect_params().values()))
        frozen_p.grad_req = "null"
        w0 = frozen_p.data().asnumpy().copy()
        blk = _loss_block(mx, net)
        blk.hybridize(static_alloc=True)
        tr = gluon.Trainer(
            [p for p in net.collect_params().values()
             if p.grad_req != "null"], "sgd", {"learning_rate": 0.1})
        x, y = self._data(6)

        def step():
            with autograd.record():
                loss = blk(x, y)
            loss.backward()
            assert autograd.peek_pending() is not None
            tr.step(8)
            return float(loss.asnumpy())

        step()
        tuned = next(p for p in net.collect_params().values()
                     if p.grad_req != "null")
        before = tuned.data().asnumpy().copy()
        tr.set_learning_rate(0.0)
        step()
        np.testing.assert_allclose(tuned.data().asnumpy(), before,
                                   rtol=1e-6)
        tr.set_learning_rate(0.1)
        step()
        assert np.abs(tuned.data().asnumpy() - before).max() > 0
        np.testing.assert_allclose(frozen_p.data().asnumpy(), w0)

    def test_second_backward_after_fused_step_raises(self):
        net, blk = self._build(30)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 1e-2})
        x, y = self._data(8)
        with autograd.record():
            loss = blk(x, y)
        loss.backward()
        tr.step(8)
        with pytest.raises(mx.MXNetError, match="retain_graph"):
            loss.backward()

    def test_two_trainers_on_one_block_keep_their_own_entries(self):
        """A second Trainer (a fine-tuning phase at another lr) over the
        same hybridized LossBlock: each against its eager twin on the
        per-parameter path."""
        x, y = self._data(10)
        runs = {}
        for mode in ("hybrid", "eager"):
            net, blk = self._build(32)
            if mode == "eager":
                blk.hybridize(False)
            losses, trainers = [], []
            for lr in (1e-2, 1e-4):
                tr = gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": lr})
                if mode == "eager":
                    tr._optimizer.fused = False
                trainers.append(tr)
                for _ in range(2):
                    with autograd.record():
                        loss = blk(x, y)
                    loss.backward()
                    assert (autograd.peek_pending() is not None) \
                        == (mode == "hybrid")
                    tr.step(8)
                    losses.append(float(loss.asnumpy()))
            for tr in trainers:
                assert set(tr._optimizer._index_update_count.values()) \
                    == {2}
            runs[mode] = (losses, [p.data().asnumpy().copy()
                                   for p in net.collect_params().values()])
        np.testing.assert_allclose(runs["hybrid"][0], runs["eager"][0],
                                   rtol=1e-4, atol=1e-5)
        for a, b in zip(runs["hybrid"][1], runs["eager"][1]):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)

    def test_step_between_retained_backwards_raises(self):
        """``backward(retain_graph=True)``, ``step``, ``backward``: the
        second backward would read the updated weights, so it raises,
        hybridized or eager."""
        for hybrid in (True, False):
            net, blk = self._build(33)
            if not hybrid:
                blk.hybridize(False)
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-2})
            x, y = self._data(11)
            with autograd.record():
                loss = blk(x, y)
            loss.backward(retain_graph=True)
            tr.step(8)
            with pytest.raises(mx.MXNetError, match="in place"):
                loss.backward()

    def test_stand_in_fuses_backward_and_update_in_one_capture(
            self, stand_in):
        net, blk = self._build(31)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2})
        x, y = self._data(9)
        for _ in range(4):
            with autograd.record():
                loss = blk(x, y)
            loss.backward()
            tr.step(8)
        inst = blk._cached_op._cache[next(iter(blk._cached_op._cache))].rec[0]
        # step 1: the eager warm-up call, its backward, the update graph;
        # steps 2-4: forward replays, one backward + update entry
        assert len(inst.fused) == 1 and len(tr._fused_progs) == 1
        assert len(inst.fused[tr]) == 1
        assert next(iter(inst.fused[tr].values())).replays == 2
        assert blk._cached_op.stats()["param_copies"] == 0
        assert set(tr._optimizer._index_update_count.values()) == {4}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _jax_twin(tmp_path, jnet, net, name):
    path = str(tmp_path / name)
    jnet.save_parameters(path)
    net.load_parameters(path)


def _train(pkg, ndm, net, blk, batches, steps, batch_size, lr):
    tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
    losses, first_grads = [], None
    for _ in range(steps):
        arrs = [ndm.array(b) for b in batches]
        with pkg.autograd.record():
            loss = blk(*arrs)
        loss.backward()
        tr.step(batch_size)
        losses.append(loss.asnumpy().copy())
        if first_grads is None:
            first_grads = [p.grad().asnumpy().copy()
                           for p in net.collect_params().values()
                           if p.grad_req != "null"]
    params = [p.data().asnumpy().copy()
              for p in net.collect_params().values()]
    return losses, first_grads, params


def test_loss_block_fused_steps_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    batch = [rng.randn(8, 4).astype(np.float32),
             rng.randn(8, 1).astype(np.float32)]
    jnet, net = _inner(jmx), _inner(mx)
    jmx.random.seed(21)                 # TestFusedHybridStep._build(21)
    jnet.initialize(jmx.init.Xavier())
    _jax_twin(tmp_path, jnet, net, "lossblock.npz")
    res = []
    for pkg, ndm, inner in ((mx, nd, net), (jmx, jnd, jnet)):
        blk = _loss_block(pkg, inner)
        blk.hybridize(static_alloc=True)
        res.append(_train(pkg, ndm, inner, blk, batch, 5, 8, 1e-2))
    (lo, _go, po), (lr, _gr, pr) = res
    np.testing.assert_allclose(np.ravel(lo), np.ravel(lr), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(po, pr):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_flash_encoder_fused_steps_match_jax(tmp_path):
    from test_torch_gluon import make_encoder_layer

    L, B, units, heads, ffn = 16, 2, 32, 2, 64
    rs = np.random.RandomState(3)
    batch = [rs.uniform(-1, 1, (L, B, units)).astype(np.float32),
             np.array([16, 7], np.float32), np.array([0, 1], np.float32)]

    def wrap(pkg, inner):
        class WithLoss(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.inner = inner
                    self.loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

            def hybrid_forward(self, F, x, valid_length, label):
                return self.loss(self.inner(x, valid_length), label)

        blk = WithLoss()
        blk.hybridize()
        return blk

    jnet = make_encoder_layer(jmx, units, heads, ffn)
    net = make_encoder_layer(mx, units, heads, ffn)
    jnet.initialize(jmx.init.Xavier())
    _jax_twin(tmp_path, jnet, net, "encoder.npz")
    res = [_train(pkg, ndm, inner, wrap(pkg, inner), batch, 3, B, 1e-4)
           for pkg, ndm, inner in ((mx, nd, net), (jmx, jnd, jnet))]
    (lo, go, po), (lr, gr, pr) = res
    np.testing.assert_allclose(lo[0], lr[0], rtol=1e-5, atol=1e-5)
    assert len(go) == len(gr) == 14
    for a, b in zip(go, gr):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.ravel(lo[1:]), np.ravel(lr[1:]),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(po, pr):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
