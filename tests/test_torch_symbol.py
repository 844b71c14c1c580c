"""PyTorch port, the symbolic API: ``mxnet_tpu_torch.symbol`` against
``mxnet_tpu.symbol`` on the same graphs and the same seeded numpy
inputs, the port on the CPU.

Construction (``list_*``, compose, ``get_internals``), the JSON both
ways (a graph written by either package loads in the other and computes
the same; the two packages write the same bytes for the same graph),
and shape / dtype inference.  Every node is named: auto-generated names
come from a process-wide counter in each package.  The JAX flash op
runs as ``tests/test_torch_flash_attention.py`` runs it (Pallas in
interpreter mode on the CPU).  Tolerance: fp32 forward 1e-5 relative to
the output's max.

``tests/fixtures/jax_symbol_graph.json`` is :func:`fixture_graph` as
the JAX package writes it (``test_fixture_is_the_jax_packages_json``
holds the committed file to that); ``chip_smoke.py``'s ``symbolic``
phase runs it on the card.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

FWD_RTOL = 1e-5
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "jax_symbol_graph.json")
# the fixture's inputs: L 16, B 2, units 32 (2 heads of 16), an image
# batch of 2 x 3 x 8 x 8
FIXTURE_SHAPES = dict(data=(16, 2, 32), valid_length=(2,),
                      image=(2, 3, 8, 8))
FIXTURE_VALID = (16.0, 0.0)             # a row that sees no key


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def fixture_graph(pkg):
    """An FC, ``flash_selfatt``, a multi-output op (``split``), a Conv +
    BatchNorm (moving statistics as auxiliary states) and ``AttrScope``
    attributes, grouped; ``pkg`` is either package."""
    S = pkg.sym
    data, vl, image = S.var("data"), S.var("valid_length"), S.var("image")
    with pkg.AttrScope(ctx_group="dev1", __layout__="TNC"):
        qkv = S.FullyConnected(data, S.var("qkv_weight"), S.var("qkv_bias"),
                               num_hidden=96, flatten=False, name="qkv")
        att = S.flash_selfatt(qkv, vl, heads=2, name="att")
    halves = S.split(att, num_outputs=2, axis=2, name="halves")
    mixed = S.broadcast_add(halves[0], halves[1], name="mixed")
    conv = S.Convolution(image, S.var("conv_weight"), S.var("conv_bias"),
                         kernel=(3, 3), num_filter=4, pad=(1, 1), name="conv")
    bn = S.BatchNorm(conv, S.var("bn_gamma"), S.var("bn_beta"),
                     S.var("bn_moving_mean", attr={"__aux__": "1"}),
                     S.var("bn_moving_var", attr={"__aux__": "1"}),
                     fix_gamma=False, name="bn")
    pooled = S.mean(S.mean(bn, axis=3, name="pool_w"), axis=2,
                    name="pool_h")
    return S.Group([mixed, pooled])


def fixture_arrays(symbol, seed=0):
    """Seeded numpy values of every argument and auxiliary state of the
    fixture graph: (args, aux)."""
    rs = np.random.RandomState(seed)
    shapes = dict(FIXTURE_SHAPES)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name == "valid_length":
            args[name] = np.array(FIXTURE_VALID, np.float32)
        else:
            args[name] = (rs.randn(*shape) * 0.5).astype(np.float32)
    aux = {n: (rs.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def forward(pkg, symbol, args, aux, is_train=False):
    """The graph's outputs (numpy) through ``bind`` on the CPU."""
    ndm = pkg.nd
    ex = symbol.bind(pkg.cpu(), {k: ndm.array(v) for k, v in args.items()},
                     aux_states={k: ndm.array(v) for k, v in aux.items()},
                     grad_req="null")
    return [o.asnumpy() for o in ex.forward(is_train=is_train)]


def assert_close(got, want, rtol=FWD_RTOL, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, (what, err)


# ---------------------------------------------------------------- fixture
def test_fixture_is_the_jax_packages_json():
    with open(FIXTURE) as f:
        committed = f.read()
    assert fixture_graph(jmx).tojson() == committed


# ----------------------------------------------------------- construction
def test_lists_match_jax():
    ours, theirs = fixture_graph(mx), fixture_graph(jmx)
    for what in ("list_arguments", "list_auxiliary_states", "list_inputs",
                 "list_outputs"):
        assert getattr(ours, what)() == getattr(theirs, what)(), what
    assert ours.get_internals().list_outputs() == \
        theirs.get_internals().list_outputs()
    assert ours[0].name == theirs[0].name == "mixed"
    assert ours["pool_h_output"].name == "pool_h"
    assert len(ours) == 2
    assert ours.get_internals()["att_output"].attr("ctx_group") == "dev1"


def test_compose_matches_jax():
    outs = []
    for pkg in (mx, jmx):
        S = pkg.sym
        x = S.var("x")
        body = S.Activation(S.FullyConnected(
            x, S.var("w"), S.var("b"), num_hidden=3, name="fc"),
            act_type="tanh", name="act")
        head = S.FullyConnected(S.var("h"), S.var("w2"), S.var("b2"),
                                num_hidden=2, name="fc2")
        composed = head(h=body)
        assert composed.list_arguments() == ["b2", "w2", "b", "w", "x"]
        assert head.list_arguments() == ["b2", "w2", "h"]   # unchanged
        rs = np.random.RandomState(0)
        args = {n: rs.randn(*s).astype(np.float32) for n, s in zip(
            composed.list_arguments(),
            composed.infer_shape(x=(4, 5))[0])}
        outs.append((composed.tojson(), forward(pkg, composed, args, {})[0]))
    assert outs[0][0] == outs[1][0]
    assert_close(outs[0][1], outs[1][1])


def test_sugar_and_scalars_match_jax():
    res = []
    for pkg in (mx, jmx):
        S = pkg.sym
        a, b = S.var("a"), S.var("b")
        z = -((2.0 * a + b) / (a - 3.0) ** 2.0) + 1.0 / (b + 5.0) - a * b
        args = {"a": np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3),
                "b": np.linspace(0, 2, 6, dtype=np.float32).reshape(2, 3)}
        res.append((z.list_arguments(), forward(pkg, z, args, {})[0]))
    assert res[0][0] == res[1][0]
    assert_close(res[0][1], res[1][1])


def test_grouped_input_is_refused():
    g = mx.sym.Group([mx.sym.var("a"), mx.sym.var("b")])
    with pytest.raises(mx.MXNetError):
        mx.sym.relu(g)


def test_symbolic_dispatch_through_nd_invoke():
    """A registry call with a Symbol first builds a node, through the
    generated frontend and through ``invoke`` alike."""
    from mxnet_tpu_torch.ops import registry
    x = mx.sym.var("x")
    s1 = mx.nd.relu(x, name="r1")
    s2 = registry.invoke(registry.get_op("relu"), [x], {"name": "r2"})
    assert isinstance(s1, mx.Symbol) and isinstance(s2, mx.Symbol)
    assert (s1.name, s2.name) == ("r1", "r2")
    s3 = mx.sym.concat(*[x, mx.sym.var("y")], dim=0, name="c")
    assert s3.list_arguments() == ["y", "x"]


def test_optimize_for_names_the_missing_item():
    """``optimize_for`` runs a registered subgraph backend; an unknown
    one is named in the error, as in the JAX package."""
    for pkg in (mx, jmx):
        with pytest.raises(pkg.MXNetError,
                           match="unknown subgraph backend 'default'"):
            pkg.sym.var("x").optimize_for("default")
    opt = mx.sym.Dropout(mx.sym.var("x"), p=0.5).optimize_for("inference")
    assert [n.op for n in opt._topo()] == [None]


# ------------------------------------------------------------------ JSON
def test_json_round_trip():
    g = fixture_graph(mx)
    text = g.tojson()
    again = mx.sym.load_json(text)
    assert again.tojson() == text
    assert json.loads(text)["mxnet_tpu_version"] == 1


def test_same_graph_same_bytes():
    assert fixture_graph(mx).tojson() == fixture_graph(jmx).tojson()


@pytest.mark.parametrize("is_train", [False, True])
def test_jax_json_loads_in_the_port(is_train):
    with open(FIXTURE) as f:
        text = f.read()
    ours, theirs = mx.sym.load_json(text), jmx.sym.load_json(text)
    args, aux = fixture_arrays(theirs)
    got = forward(mx, ours, args, aux, is_train)
    want = forward(jmx, theirs, args, aux, is_train)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, what=f"output {i}")
    node = json.loads(ours.tojson())["nodes"]
    att = next(n for n in node if n["name"] == "att")
    assert att["op"] == "_contrib_flash_selfatt"
    assert att["user_attrs"] == {"ctx_group": "dev1", "__layout__": "TNC"}


def test_port_json_loads_in_the_jax_package(tmp_path):
    path = str(tmp_path / "g-symbol.json")
    fixture_graph(mx).save(path)
    theirs, ours = jmx.sym.load(path), mx.sym.load(path)
    args, aux = fixture_arrays(ours)
    got = forward(mx, ours, args, aux)
    want = forward(jmx, theirs, args, aux)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, what=f"output {i}")
    assert theirs.list_auxiliary_states() == ["bn_moving_var",
                                              "bn_moving_mean"]


# ------------------------------------------------------------- inference
def _mlp_symbol(pkg, num_hidden=16, num_classes=4):
    S = pkg.sym
    h = S.FullyConnected(S.var("data"), S.var("fc1_weight"),
                         S.var("fc1_bias"), num_hidden=num_hidden,
                         name="fc1")
    h = S.Activation(h, act_type="relu", name="relu1")
    out = S.FullyConnected(h, S.var("fc2_weight"), S.var("fc2_bias"),
                           num_hidden=num_classes, name="fc2")
    return S.SoftmaxOutput(out, S.var("softmax_label"), name="softmax")


def _conv_bn(pkg):
    S = pkg.sym
    h = S.Convolution(S.var("data"), S.var("w"), S.var("b"), kernel=(3, 3),
                      num_filter=8, pad=(1, 1), name="conv")
    return S.BatchNorm(h, S.var("gamma"), S.var("beta"), S.var("mm"),
                       S.var("mv"), name="bn")


def _flash_graph(pkg):
    S = pkg.sym
    qkv = S.FullyConnected(S.var("data"), S.var("qkv_weight"),
                           S.var("qkv_bias"), num_hidden=96, flatten=False,
                           name="qkv")
    return S.flash_selfatt(qkv, S.var("valid_length"), heads=2, name="att")


INFER_CASES = {
    "mlp": (_mlp_symbol, dict(data=(32, 8), softmax_label=(32,))),
    "conv_bn": (_conv_bn, dict(data=(2, 3, 16, 16))),
    "flash": (_flash_graph, dict(data=(16, 2, 32), valid_length=(2,))),
    "fixture": (fixture_graph, dict(FIXTURE_SHAPES)),
}


@pytest.mark.parametrize("case", sorted(INFER_CASES))
def test_infer_shape_matches_jax(case):
    build, shapes = INFER_CASES[case]
    ours, theirs = build(mx), build(jmx)
    got = ours.infer_shape(**shapes)
    want = theirs.infer_shape(**shapes)
    assert [list(map(tuple, g)) for g in got] == \
        [list(map(tuple, w)) for w in want]


def test_infer_shape_partial_matches_jax():
    res = []
    for pkg in (mx, jmx):
        S = pkg.sym
        z = S.broadcast_add(S.var("x"), S.var("y"), name="z")
        args, outs, _ = z.infer_shape_partial(x=(2, 3))
        res.append((args, outs))
        with pytest.raises(pkg.MXNetError):
            z.infer_shape(x=(2, 3))
    assert res[0] == res[1] == ([None, (2, 3)], [None])


def test_declared_shape_fills_a_variable():
    for pkg in (mx, jmx):
        S = pkg.sym
        w = S.var("w", shape=(4, 6))
        z = S.dot(S.var("x"), w, name="d")
        args, outs, _ = z.infer_shape(x=(3, 4))
        assert dict(zip(z.list_arguments(), args)) == {"x": (3, 4),
                                                       "w": (4, 6)}
        assert outs == [(3, 6)]


def test_infer_shape_failure_names_the_node():
    S = mx.sym
    z = S.FullyConnected(S.var("x"), S.var("w"), S.var("b"), num_hidden=3,
                         name="fc_bad")
    with pytest.raises(mx.MXNetError, match="fc_bad"):
        z.infer_shape(x=(2, 5), w=(3, 4))


def _type_cases(pkg):
    S = pkg.sym
    return [
        (S.Cast(S.var("x"), dtype="float16", name="c"), dict(x=np.float32)),
        (S.Embedding(S.var("i"), S.var("w"), input_dim=10, output_dim=4,
                     name="e"), dict(i=np.int32, w=np.float32)),
        (S.argmax(S.var("x"), axis=1, name="am"), dict(x=np.float32)),
        (S.broadcast_add(S.var("a"), S.var("b"), name="p"),
         dict(a=np.float16, b=np.float32)),
        (fixture_graph(pkg), {}),
    ]


@pytest.mark.parametrize("idx", range(5))
def test_infer_type_matches_jax(idx):
    ours = _type_cases(mx)[idx]
    theirs = _type_cases(jmx)[idx]
    assert ours[0].infer_type(**ours[1]) == theirs[0].infer_type(**theirs[1])


def test_attr_scope_nests_and_serialises():
    with mx.AttrScope(ctx_group="a", k="1"):
        with mx.AttrScope(ctx_group="b"):
            v = mx.sym.var("v")
            r = mx.sym.relu(v, name="r")
        assert mx.AttrScope.get({"x": 3}) == {"ctx_group": "a", "k": "1",
                                              "x": "3"}
    assert r.attr("ctx_group") == "b" and r.attr("k") == "1"
    again = mx.sym.load_json(r.tojson())
    assert again.attr("ctx_group") == "b"
    assert mx.attribute.current_attrs() == {}
