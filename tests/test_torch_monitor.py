"""PyTorch port, ``monitor.py``: a twin of each test of
``tests/test_monitor.py``.  The same network (the JAX package's weights
loaded into the port's block) sees the same numpy batches in both
packages, and each monitored batch gives the same ``(name, stat)``
list, stats within 1e-5 relative (fp32, the same products in another
order).  A hybridized block yields the JAX package's names: the plain
pass that resolves deferred shapes is statted like an eager call, the
CachedOp's later calls only at the outermost output and the
parameters.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import monitor as jmon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.monitor import Monitor, default_stat

STAT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _net(pkg, path=None):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="mon_")
    with net.name_scope():
        net.add(nn.Dense(4, activation="relu"), nn.Dense(2))
    if path is None:
        pkg.random.seed(0)
        net.initialize(pkg.init.Xavier())
    else:
        net.initialize()
    return net


def _pair(tmp_path):
    """The JAX package's net (deferred shapes resolved by a first call
    outside the monitored ones) and the port's with its weights."""
    jnet = _net(jmx)
    jnet(jmx.nd.ones((1, 5)))
    path = str(tmp_path / "mon.params")
    jnet.save_parameters(path)
    net = _net(mx, path)
    net.load_parameters(path, ctx=mx.cpu(0))
    return jnet, net


def _same(got, want):
    assert [(s, n) for s, n, _v in got] == [(s, n) for s, n, _v in want]
    for (_s, n, g), (_s2, _n, w) in zip(got, want):
        if isinstance(w, str):
            assert isinstance(g, str), (n, g, w)
            continue
        assert abs(g - w) <= STAT_RTOL * max(abs(w), 1e-6), (n, g, w)


def _batch(seed=0, rows=3):
    return np.random.RandomState(seed).randn(rows, 5).astype(np.float32)


def _recorded_step(pkg, net, x):
    with pkg.autograd.record():
        out = net(pkg.nd.array(x)).sum()
    out.backward()


class TestMonitorGluon:
    def test_install_tic_toc_collects_outputs_weights_grads(self, tmp_path):
        jnet, net = _pair(tmp_path)
        got, want = [], []
        for pkg, n, mon_cls, res in ((jmx, jnet, jmon.Monitor, want),
                                     (mx, net, Monitor, got)):
            mon = mon_cls(interval=1).install(n)
            mon.tic()
            _recorded_step(pkg, n, _batch())
            res.extend(mon.toc())
            assert mon.toc() == []
        _same(got, want)
        names = [n for _s, n, _v in got]
        assert any(n.endswith("_output") for n in names)
        assert any(n.endswith("weight_grad") for n in names)

    def test_pattern_filters_stats(self, tmp_path):
        jnet, net = _pair(tmp_path)
        res = []
        for pkg, n, mon_cls in ((jmx, jnet, jmon.Monitor),
                                (mx, net, Monitor)):
            mon = mon_cls(interval=1, pattern=".*weight.*").install(n)
            mon.tic()
            n(pkg.nd.array(_batch(rows=2)))
            res.append(mon.toc())
        _same(res[1], res[0])
        assert res[1] and all("weight" in n for _s, n, _v in res[1])

    def test_interval_gates_collection(self, tmp_path):
        jnet, net = _pair(tmp_path)
        seen = []
        for pkg, n, mon_cls in ((jmx, jnet, jmon.Monitor),
                                (mx, net, Monitor)):
            mon = mon_cls(interval=2).install(n)
            runs = []
            for k in range(3):
                mon.tic()
                n(pkg.nd.array(_batch(seed=k, rows=2)))
                runs.append(mon.toc())
            seen.append(runs)
        for got, want in zip(seen[1], seen[0]):
            _same(got, want)
        assert seen[1][0] and seen[1][1] == [] and seen[1][2]

    def test_custom_stat_func_detects_nan(self, tmp_path):
        jnet, net = _pair(tmp_path)
        res = []
        x = np.full((2, 5), np.nan, np.float32)
        for pkg, n, mon_cls in ((jmx, jnet, jmon.Monitor),
                                (mx, net, Monitor)):
            mon = mon_cls(interval=1, stat_func=lambda a: float(
                np.isnan(a.asnumpy()).any())).install(n)
            mon.tic()
            n(pkg.nd.array(x))
            res.append(mon.toc())
        _same(res[1], res[0])
        assert [n for _s, n, v in res[1]
                if n.endswith("_output") and v == 1.0]

    def test_sort_orders_by_name(self, tmp_path):
        jnet, net = _pair(tmp_path)
        res = []
        for pkg, n, mon_cls in ((jmx, jnet, jmon.Monitor),
                                (mx, net, Monitor)):
            mon = mon_cls(interval=1, sort=True).install(n)
            mon.tic()
            n(pkg.nd.array(_batch(rows=2)))
            res.append(mon.toc())
        _same(res[1], res[0])
        names = [n for _s, n, _v in res[1]]
        assert names == sorted(names)

    def test_toc_print_logs_and_returns(self, tmp_path, caplog):
        _jnet, net = _pair(tmp_path)
        mon = Monitor(interval=1, pattern=".*bias.*").install(net)
        mon.tic()
        net(nd.array(_batch(rows=2)))
        with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch"):
            res = mon.toc_print()
        assert res
        assert any("bias" in r.message for r in caplog.records)
        assert len([r for r in caplog.records if "bias" in r.message]) \
            == len(res)

    def test_hybridized_block_safe(self):
        """A hybridized block with deferred shapes, monitored from its
        first call: the same names and stats as the JAX package's in
        each of three recorded steps (the first resolves the shapes in a
        plain pass; later ones run the CachedOp, whose program tensors
        are skipped and whose lazy output is statted at ``toc``).  The
        weights are constants, so both packages start alike."""
        seen = []
        for pkg, mon_cls in ((jmx, jmon.Monitor), (mx, Monitor)):
            nn = pkg.gluon.nn
            net = nn.HybridSequential(prefix="hmon_")
            with net.name_scope():
                net.add(nn.Dense(4, activation="relu"), nn.Dense(2))
            net.initialize(pkg.init.Constant(0.1))
            net.hybridize(static_alloc=True)
            mon = mon_cls(interval=1).install(net)
            runs = []
            for k in range(3):
                mon.tic()
                _recorded_step(pkg, net, _batch(seed=k, rows=2))
                runs.append(mon.toc())
            seen.append(runs)
        for got, want in zip(seen[1], seen[0]):
            _same(got, want)
            assert not any(str(v).startswith("<error")
                           for _s, _n, v in got)
            assert any("weight" in n for _s, n, _v in got)
        assert any(n.startswith("hmon_dense") and n.endswith("_output")
                   for _s, n, _v in seen[1][0])
        assert not any(n.startswith("hmon_dense") and n.endswith("_output")
                       for _s, n, _v in seen[1][1])

    def test_install_is_idempotent(self, tmp_path):
        _jnet, net = _pair(tmp_path)
        mon = Monitor(interval=1)
        mon.install(net)
        mon.install(net)
        mon.tic()
        net(nd.array(_batch(rows=2)))
        names = [n for _s, n, _v in mon.toc()]
        assert len(names) == len(set(names))

    def test_uninstall_removes_hooks(self, tmp_path):
        _jnet, net = _pair(tmp_path)
        n_hooks_before = sum(len(b._forward_hooks)
                             for b in net._iter_blocks())
        mon = Monitor(interval=1)
        mon.install(net)
        assert sum(len(b._forward_hooks)
                   for b in net._iter_blocks()) > n_hooks_before
        mon.uninstall()
        assert sum(len(b._forward_hooks)
                   for b in net._iter_blocks()) == n_hooks_before
        mon.tic()
        net(nd.array(_batch(rows=2)))
        assert mon.toc() == []
        mon.install(net)
        mon.tic()
        net(nd.array(_batch(rows=2)))
        assert mon.toc()

    def test_default_stat(self):
        x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
        got = default_stat(nd.array(x))
        want = jmon.default_stat(jmx.nd.array(x))
        assert got == pytest.approx(want, rel=1e-12)
        assert default_stat(nd.array(np.ones((4,), np.float32) * 3.0)) \
            == pytest.approx(3.0)

    def test_install_rejects_unknown_target(self):
        with pytest.raises(mx.MXNetError):
            Monitor().install(42)


def _softmax_symbol(pkg):
    s = pkg.sym
    out = s.FullyConnected(s.var("data"), s.var("fc_weight"),
                           s.var("fc_bias"), num_hidden=3, name="fc")
    return s.SoftmaxOutput(out, s.var("softmax_label"), name="softmax")


class TestMonitorModule:
    def test_module_toc_stats_args_and_outputs(self):
        rng = np.random.RandomState(0)
        args = {"fc_weight": rng.randn(3, 6).astype(np.float32),
                "fc_bias": rng.randn(3).astype(np.float32)}
        x = rng.randn(2, 6).astype(np.float32)
        res = []
        for pkg, mon_cls in ((jmx, jmon.Monitor), (mx, Monitor)):
            s = pkg.sym
            y = s.FullyConnected(s.var("data"), s.var("fc_weight"),
                                 s.var("fc_bias"), num_hidden=3, name="fc")
            mod = pkg.module.Module(y, data_names=("data",),
                                    label_names=None, context=pkg.cpu())
            mod.bind(data_shapes=[("data", (2, 6))])
            mod.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in args.items()})
            mon = mon_cls(interval=1).install(mod)
            mon.tic()
            mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x)]),
                        is_train=True)
            mod.backward([pkg.nd.ones((2, 3))])
            res.append(mon.toc())
        _same(res[1], res[0])
        names = [n for _s, n, _v in res[1]]
        assert "fc_weight" in names and "fc_weight_grad" in names
        assert any(n.startswith("output") for n in names)

    def test_fit_with_monitor_smoke(self, caplog):
        """``Module.fit(monitor=...)`` ticks once a batch and logs the
        weights' stats: the same lines as the JAX package's fit."""
        rng = np.random.RandomState(0)
        data = rng.rand(8, 6).astype(np.float32)
        labels = np.zeros(8, np.float32)
        w = {"fc_weight": rng.randn(3, 6).astype(np.float32) * 0.1,
             "fc_bias": np.zeros(3, np.float32)}
        logged = []
        for pkg, mon_cls in ((jmx, jmon.Monitor), (mx, Monitor)):
            mon = mon_cls(interval=1, pattern=".*weight$")
            it = pkg.io.NDArrayIter(data, labels, batch_size=4,
                                    label_name="softmax_label")
            mod = pkg.module.Module(_softmax_symbol(pkg), context=pkg.cpu())
            caplog.clear()
            with caplog.at_level(logging.INFO, logger=pkg.__name__):
                mod.fit(it, num_epoch=1, monitor=mon,
                        arg_params={k: pkg.nd.array(v)
                                    for k, v in w.items()},
                        optimizer_params=(("learning_rate", 0.01),))
            assert mon.step >= 2
            logged.append([r.getMessage().split() for r in caplog.records
                           if r.getMessage().startswith("Batch:")])
        assert len(logged[1]) == len(logged[0]) == 2
        for got, want in zip(logged[1], logged[0]):
            assert got[:3] == want[:3]
            assert float(got[3]) == pytest.approx(float(want[3]),
                                                  rel=STAT_RTOL)


def test_monitored_hybrid_step_runs_no_extra_forward(monkeypatch):
    """A monitored hybridized step whose ``toc`` comes after
    ``trainer.step``: the lazy output is filled by the step, so no
    forward runs apart from it (the same count as unmonitored), and the
    outermost output's stat equals the loss's."""
    from mxnet_tpu_torch.gluon import cached_op
    runs = []
    real = cached_op._Lazy.materialize

    def counted(self):
        runs.append(self.claim is not None)
        return real(self)

    monkeypatch.setattr(cached_op._Lazy, "materialize", counted)
    counts = []
    for monitored in (False, True):
        nn = gluon.nn
        net = nn.HybridSequential(prefix="lmon_")
        with net.name_scope():
            net.add(nn.Dense(4, in_units=5, activation="relu"),
                    nn.Dense(1, in_units=4))
        net.initialize(mx.init.Constant(0.1))
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        mon = Monitor(interval=1).install(net) if monitored else None
        del runs[:]
        for k in range(4):
            if mon:
                mon.tic()
            with autograd.record():
                loss = net(nd.array(_batch(seed=k, rows=2)))
            loss.backward()
            trainer.step(2)
            if mon:
                res = dict((n, v) for _s, n, v in mon.toc())
                want = float(np.sqrt((loss.asnumpy() ** 2).mean()))
                assert res["lmon_output"] == pytest.approx(want, rel=1e-6)
        counts.append(sum(runs))
    assert counts[0] == counts[1], counts
