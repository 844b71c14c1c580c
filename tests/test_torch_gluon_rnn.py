"""PyTorch port, ``gluon.rnn`` (``mxnet_tpu_torch/gluon/rnn/{rnn_layer,
rnn_cell}.py``) against the JAX package.

Twins of the 9 tests of ``tests/test_gluon_rnn.py``, comparing values,
not only shapes: each block is built in the JAX package, its weights
saved (``save_parameters``) and loaded into the port's twin, and both
run on the same numpy inputs.  Beyond them: ``RNN`` (relu and tanh),
``LSTM`` and ``GRU``, one and two directions, forward, the state
outputs and every gradient (input, begin states, each parameter), also
hybridized; cell ``unroll`` against the fused layer for each cell kind;
and ``examples/word_language_model.py``'s ``RNNModel`` at narrow widths
trained 3 Adam steps, eager and hybridized, against the example's model
in the JAX package.

Tolerances: forward values rtol 1e-5 / atol 1e-6 (float32 recurrences
summed in another order); gradients within 1e-5 of each tensor's max;
the language model's losses 1e-5 relative and its parameters 1e-5 of
each tensor's max.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import rnn as jrnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import rnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_of_max(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


def _carry(jblock, block, tmp_path, name="w.npz"):
    """The JAX block's weights into the port's twin."""
    path = str(tmp_path / name)
    jblock.save_parameters(path)
    block.load_parameters(path)


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _pair(mod_j, mod_p, build, tmp_path):
    jb = build(mod_j)
    jb.initialize()
    pb = build(mod_p)
    pb.initialize()
    _carry(jb, pb, tmp_path)
    return jb, pb


# ---------------------------------------------------------------------------
# tests/test_gluon_rnn.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,nstates", [("RNN", 1), ("GRU", 1),
                                          ("LSTM", 2)])
def test_rnn_layer_forward_shapes(name, nstates, tmp_path):
    jl, pl = _pair(jrnn, rnn, lambda m: getattr(m, name)(
        16, num_layers=2, input_size=8), tmp_path)
    x = _rand((5, 3, 8), 0)
    out = pl(nd.array(x))
    assert out.shape == (5, 3, 16)
    _close(out.asnumpy(), jl(jnd.array(x)).asnumpy())
    states = [_rand(s.shape, 1 + i) for i, s in enumerate(pl.begin_state(3))]
    out, new_states = pl(nd.array(x), [nd.array(s) for s in states])
    jout, jstates = jl(jnd.array(x), [jnd.array(s) for s in states])
    assert out.shape == (5, 3, 16) and len(new_states) == nstates
    assert new_states[0].shape == (2, 3, 16)
    _close(out.asnumpy(), jout.asnumpy())
    for s, js in zip(new_states, jstates):
        _close(s.asnumpy(), js.asnumpy())


def test_bidirectional_lstm_shape(tmp_path):
    jl, pl = _pair(jrnn, rnn, lambda m: m.LSTM(
        10, num_layers=1, bidirectional=True, input_size=6), tmp_path)
    x = _rand((4, 2, 6), 2)
    out = pl(nd.array(x))
    assert out.shape == (4, 2, 20)
    _close(out.asnumpy(), jl(jnd.array(x)).asnumpy())


def test_rnn_layer_ntc_layout(tmp_path):
    jl, pl = _pair(jrnn, rnn, lambda m: m.GRU(12, layout="NTC",
                                              input_size=5), tmp_path)
    x = _rand((2, 7, 5), 3)
    out = pl(nd.array(x))
    assert out.shape == (2, 7, 12)
    _close(out.asnumpy(), jl(jnd.array(x)).asnumpy())


def _grads(m, autograd_mod, layer, x, states=None, hybrid=False):
    """Output, state outputs, the input's (and begin states') gradient and
    every parameter's gradient of sum(out * out) + sum of each state
    output squared."""
    if hybrid:
        layer.hybridize()
    xs = m.nd.array(x)
    xs.attach_grad()
    st = None
    if states is not None:
        st = [m.nd.array(s) for s in states]
        for s in st:
            s.attach_grad()
    with autograd_mod.record():
        if st is None:
            out, outs = layer(xs), []
        else:
            out, outs = layer(xs, st)
        loss = (out * out).sum()
        for o in outs:
            loss = loss + (o * o).sum()
    loss.backward()
    params = {k.split("_", 1)[1] if "_" in k else k: p
              for k, p in layer._collect_params_with_prefix().items()}
    return dict(out=out.asnumpy(), states=[o.asnumpy() for o in outs],
                x=xs.grad.asnumpy(),
                begin=[s.grad.asnumpy() for s in st or []],
                params={k: p.grad().asnumpy() for k, p in params.items()})


def test_rnn_grad_flows(tmp_path):
    jl, pl = _pair(jrnn, rnn, lambda m: m.LSTM(8, input_size=4), tmp_path)
    x = _rand((3, 2, 4), 4)
    got = _grads(mx, autograd, pl, x)
    want = _grads(jmx, jautograd, jl, x)
    assert np.abs(got["x"]).sum() > 0
    _close_of_max(got["x"], want["x"])
    assert sorted(got["params"]) == sorted(want["params"])
    for k, g in got["params"].items():
        assert np.abs(g).sum() > 0, k
        _close_of_max(g, want["params"][k])


def _cell_from_fused(fused, cell):
    """The fused layer's l0_* weights into a cell (as the JAX test does)."""
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, name).set_data(getattr(fused, "l0_" + name).data())


def test_lstm_cell_unroll_matches_fused(tmp_path):
    H, I, T, N = 6, 4, 5, 2
    jfused, fused = _pair(jrnn, rnn, lambda m: m.LSTM(H, input_size=I),
                          tmp_path)
    cell = rnn.LSTMCell(H, input_size=I)
    cell.initialize()
    _cell_from_fused(fused, cell)
    x = _rand((T, N, I), 5)
    out_fused = fused(nd.array(x)).asnumpy()
    outs, _ = cell.unroll(T, nd.array(x), layout="TNC", merge_outputs=True)
    _close(outs.asnumpy(), out_fused, atol=1e-5)
    _close(out_fused, jfused(jnd.array(x)).asnumpy())


def _cell_step(m, cell, x, states):
    out, new = cell(m.nd.array(x), [m.nd.array(s) for s in states])
    return out.asnumpy(), [s.asnumpy() for s in new]


def test_sequential_rnn_cell(tmp_path):
    def build(m):
        stack = m.SequentialRNNCell()
        stack.add(m.LSTMCell(8, input_size=4))
        stack.add(m.GRUCell(6, input_size=8))
        return stack

    jstack, stack = _pair(jrnn, rnn, build, tmp_path)
    x = _rand((2, 4), 6)
    states = [_rand(s.shape, 7 + i)
              for i, s in enumerate(stack.begin_state(2))]
    out, new = _cell_step(mx, stack, x, states)
    jout, jnew = _cell_step(jmx, jstack, x, states)
    assert out.shape == (2, 6) and len(new) == 3
    _close(out, jout)
    for s, js in zip(new, jnew):
        _close(s, js)


def test_residual_cell(tmp_path):
    def build(m):
        return m.ResidualCell(m.GRUCell(4, input_size=4))

    jcell, cell = _pair(jrnn, rnn, build, tmp_path)
    x = _rand((2, 4), 8)
    states = [_rand((2, 4), 9)]
    out, _ = _cell_step(mx, cell, x, states)
    base_out, _ = _cell_step(mx, cell.base_cell, x, states)
    _close(out, base_out + x, atol=1e-6)
    _close(out, _cell_step(jmx, jcell, x, states)[0])


def test_cell_unroll_valid_length(tmp_path):
    jcell, cell = _pair(jrnn, rnn, lambda m: m.RNNCell(5, input_size=3),
                        tmp_path)
    x = _rand((2, 6, 3), 10)
    valid = np.array([3, 5], np.float32)
    out, _ = cell.unroll(6, nd.array(x), layout="NTC", merge_outputs=True,
                         valid_length=nd.array(valid))
    jout, _ = jcell.unroll(6, jnd.array(x), layout="NTC",
                           merge_outputs=True, valid_length=jnd.array(valid))
    o = out.asnumpy()
    assert np.abs(o[0, 3:]).sum() == 0
    assert np.abs(o[1, :5]).sum() > 0
    _close(o, jout.asnumpy())
    # merge_outputs=False keeps the mask, one step an array
    steps, _ = cell.unroll(6, nd.array(x), layout="NTC",
                           merge_outputs=False, valid_length=nd.array(valid))
    assert len(steps) == 6
    _close(np.stack([s.asnumpy() for s in steps], axis=1), o)


def test_bidirectional_valid_length_reversal(tmp_path):
    H, I, T = 4, 3, 6

    def build(m):
        return m.BidirectionalCell(m.GRUCell(H, input_size=I),
                                   m.GRUCell(H, input_size=I))

    jbi, bi = _pair(jrnn, rnn, build, tmp_path)
    x_short = np.random.RandomState(0).randn(1, 4, I).astype(np.float32)
    x_pad = np.concatenate([x_short, np.zeros((1, 2, I), np.float32)],
                           axis=1)
    out_pad, _ = bi.unroll(T, nd.array(x_pad), layout="NTC",
                           merge_outputs=True,
                           valid_length=nd.array(np.array([4.0])))
    out_ref, _ = bi.unroll(4, nd.array(x_short), layout="NTC",
                           merge_outputs=True)
    a, b = out_pad.asnumpy()[0, :4], out_ref.asnumpy()[0]
    _close(a, b, atol=1e-5)
    jout, _ = jbi.unroll(T, jnd.array(x_pad), layout="NTC",
                         merge_outputs=True,
                         valid_length=jnd.array(np.array([4.0])))
    _close(out_pad.asnumpy(), jout.asnumpy())
    with pytest.raises(mx.MXNetError, match="unroll"):
        bi(nd.array(x_short[:, 0]), bi.begin_state(1))


# ---------------------------------------------------------------------------
# the fused layers: forward, state outputs and every gradient
# ---------------------------------------------------------------------------
_LAYERS = {"rnn_relu": lambda m, **k: m.RNN(activation="relu", **k),
           "rnn_tanh": lambda m, **k: m.RNN(activation="tanh", **k),
           "lstm": lambda m, **k: m.LSTM(**k),
           "gru": lambda m, **k: m.GRU(**k)}


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", sorted(_LAYERS))
def test_fused_layer_forward_and_every_gradient(mode, bidirectional,
                                                tmp_path):
    T, N, I, H = 5, 3, 4, 6

    def build(m):
        return _LAYERS[mode](m, hidden_size=H, num_layers=2,
                             bidirectional=bidirectional, input_size=I)

    jl, pl = _pair(jrnn, rnn, build, tmp_path)
    hl = build(rnn)
    hl.initialize()
    _carry(jl, hl, tmp_path, "h.npz")
    x = _rand((T, N, I), 11) - 0.5
    states = [_rand(s.shape, 12 + i) - 0.5
              for i, s in enumerate(pl.begin_state(N))]
    want = _grads(jmx, jautograd, jl, x, states)
    for got in (_grads(mx, autograd, pl, x, states),
                _grads(mx, autograd, hl, x, states, hybrid=True)):
        _close(got["out"], want["out"])
        assert len(got["states"]) == (2 if mode == "lstm" else 1)
        for s, ws in zip(got["states"], want["states"]):
            _close(s, ws)
        _close_of_max(got["x"], want["x"])
        for g, w in zip(got["begin"], want["begin"]):
            _close_of_max(g, w)
        assert sorted(got["params"]) == sorted(want["params"])
        for k, g in got["params"].items():
            _close_of_max(g, want["params"][k])
    assert hl._cached_op.stats()["programs"] == 1


def test_layer_hybridized_runs_one_program_and_dropout_draws():
    layer = rnn.LSTM(6, num_layers=2, dropout=0.5, input_size=4)
    layer.initialize()
    x = nd.array(_rand((5, 2, 4), 13))
    eager = layer(x).asnumpy()
    layer.hybridize()
    for _ in range(2):
        _close(layer(x).asnumpy(), eager)
    assert layer._cached_op.stats()["programs"] == 1
    with autograd.record():
        a = layer(x).asnumpy()
        b = layer(x).asnumpy()
    assert not np.array_equal(a, b)      # a new inter-layer mask a call
    assert len(layer.collect_params()) == 8
    assert [k.split("_", 1)[1] for k in layer.collect_params()][:4] == [
        "l0_i2h_weight", "l0_h2h_weight", "l0_i2h_bias", "l0_h2h_bias"]


@pytest.mark.parametrize("kind", ["rnn", "gru"])
def test_cell_unroll_matches_fused_layer(kind, tmp_path):
    H, I, T, N = 5, 3, 6, 2
    fused = rnn.RNN(H, activation="tanh", input_size=I) if kind == "rnn" \
        else rnn.GRU(H, input_size=I)
    fused.initialize()
    cell = rnn.RNNCell(H, activation="tanh", input_size=I) \
        if kind == "rnn" else rnn.GRUCell(H, input_size=I)
    cell.initialize()
    _cell_from_fused(fused, cell)
    x = _rand((N, T, I), 14)
    want = fused(nd.array(x.transpose(1, 0, 2))).asnumpy().transpose(1, 0, 2)
    got, states = cell.unroll(T, nd.array(x), layout="NTC")
    _close(got.asnumpy(), want, atol=1e-5)
    _close(states[0].asnumpy(), want[:, -1], atol=1e-5)


def test_deferred_input_size_and_zoneout_dropout_cells():
    layer = rnn.GRU(7, num_layers=2, layout="NTC")
    layer.initialize()
    assert layer(nd.array(_rand((2, 3, 5), 15))).shape == (2, 3, 7)
    assert layer.l0_i2h_weight.shape == (21, 5)
    assert layer.l1_i2h_weight.shape == (21, 7)
    cell = rnn.ZoneoutCell(rnn.LSTMCell(4, input_size=3),
                           zoneout_outputs=0.5, zoneout_states=0.5)
    cell.initialize()
    with pytest.raises(mx.MXNetError, match="modified"):
        cell.base_cell.begin_state(2)
    x = nd.array(_rand((2, 5, 3), 16))
    with autograd.record():
        out, _ = cell.unroll(5, x, layout="NTC")
    assert out.shape == (2, 5, 4)
    out, _ = cell.unroll(5, x, layout="NTC")      # inference: no zoneout
    base, _ = cell.base_cell.unroll(5, x, begin_state=cell.begin_state(2),
                                    layout="NTC")
    _close(out.asnumpy(), base.asnumpy())
    drop = rnn.SequentialRNNCell()
    drop.add(rnn.GRUCell(4, input_size=3))
    drop.add(rnn.DropoutCell(0.5))
    drop.initialize()
    out, states = drop.unroll(5, x, layout="NTC")
    assert out.shape == (2, 5, 4) and len(states) == 1


# ---------------------------------------------------------------------------
# examples/word_language_model.py's RNNModel, narrow
# ---------------------------------------------------------------------------
def _example():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import word_language_model as ex
    finally:
        sys.path.pop(0)
    return ex


@pytest.fixture(scope="module")
def jax_word_lm(tmp_path_factory):
    """The example's ``RNNModel`` (narrow) in the JAX package, hybridized
    as the example does, after 3 Adam steps: its initial weights' file,
    the batches, its losses and its parameters."""
    sys.path.insert(0, REPO)
    import chip_smoke
    ex = _example()
    ids, vocab = ex.make_corpus()
    mine, my_vocab = chip_smoke._word_lm_corpus()
    np.testing.assert_array_equal(ids, mine)
    assert vocab == my_vocab
    V, E, H, B, T = len(vocab), 8, 16, 4, 6
    batches = chip_smoke._word_lm_batches(ids, B, T)[:3]
    jnet = ex.RNNModel(V, embed=E, hidden=H)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(batches[0][0], dtype="int32"))
    path = str(tmp_path_factory.mktemp("word_lm") / "lm.npz")
    jnet.save_parameters(path)
    jnet.hybridize(static_alloc=True)
    jtrainer = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                                 {"learning_rate": 3e-3})
    jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = [float(chip_smoke._word_lm_step(
        jmx, jnet, jtrainer, jloss, jnd.array(x, dtype="int32"),
        jnd.array(y, dtype="int32"), V).asscalar()) for x, y in batches]
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    return dict(chip_smoke=chip_smoke, path=path, batches=batches,
                losses=losses, params=params, dims=(V, E, H))


@pytest.mark.parametrize("hybrid", [False, True])
def test_word_language_model_three_adam_steps(hybrid, jax_word_lm):
    chip_smoke = jax_word_lm["chip_smoke"]
    V, E, H = jax_word_lm["dims"]
    net = chip_smoke._word_lm_model(mx, V, E, H)
    net.load_parameters(jax_word_lm["path"])
    if hybrid:
        net.hybridize(static_alloc=True)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 3e-3})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    got = [float(chip_smoke._word_lm_step(
        mx, net, trainer, loss_fn, nd.array(x, dtype="int32"),
        nd.array(y, dtype="int32"), V).asscalar())
        for x, y in jax_word_lm["batches"]]
    _close(got, jax_word_lm["losses"], rtol=1e-5, atol=0)
    for name, p in net._collect_params_with_prefix().items():
        _close_of_max(p.data().asnumpy(), jax_word_lm["params"][name])
    if hybrid:
        assert net._cached_op.stats()["programs"] == 1
