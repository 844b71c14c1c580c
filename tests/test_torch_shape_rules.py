"""PyTorch port, ``ops/shape_rules.py`` and ``OpDef.infer_signature``:
twins of the shape-rule cases of ``tests/test_op_sweep.py`` (the
juggling core covered, every ruled op's signature against its forward,
symbolic and infeasible queries), run on that sweep's inputs (its
``_get_spec``, the same seeded numpy arrays).  Each ruled op's predicted
signature must equal the JAX registry's for the same query, and every
concrete predicted dim and dtype must match the port's forward output
exactly.  The module itself is the JAX package's algebra: the same
public names, and the same answers to a table of queries.
"""
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops import shape_rules as JSR

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.ops import shape_rules as SR

import test_op_sweep as ref

RULED = [n for n in ref.CANONICAL
         if n in preg._OPS and preg.get_op(n).shape_rule is not None
         and n not in ref.FWD_SKIP]


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


def _fmt(sig):
    """A signature in comparable form across the two modules' Dim
    classes."""
    if sig is None:
        return None
    shape, dtype = sig
    if shape is not None:
        shape = tuple(None if d is None else SR.fmt_dim(d)
                      if isinstance(d, SR.Dim) else JSR.fmt_dim(d)
                      for d in shape)
    return shape, dtype


def test_rules_are_the_jax_packages():
    assert set(SR.__all__) == set(JSR.__all__)
    assert set(SR.SHAPE_RULES) == set(JSR.SHAPE_RULES)
    assert SR.DTYPES == JSR.DTYPES and SR.QUANT_DTYPES == JSR.QUANT_DTYPES
    for a in sorted(SR.DTYPES):
        for b in sorted(SR.DTYPES):
            assert SR.promote(a, b) == JSR.promote(a, b), (a, b)


def test_shape_rules_cover_the_juggling_core():
    assert {"Reshape", "transpose", "expand_dims", "dot", "batch_dot",
            "sum", "Concat"} <= set(RULED)
    jruled = [n for n in ref.CANONICAL
              if jreg.OP_REGISTRY[n].shape_rule is not None
              and n not in ref.FWD_SKIP]
    assert RULED == jruled


@pytest.mark.parametrize("name", RULED)
def test_infer_signature_agrees_with_forward(name):
    od = preg.get_op(name)
    np_inputs, kwargs, _wrt, _gr, _rtol, _atol = ref._get_spec(
        name, jreg.OP_REGISTRY[name])
    query = [(x.shape, str(x.dtype)) for x in np_inputs]
    sig = od.infer_signature(query, kwargs)
    assert sig is not None
    assert _fmt(sig) == _fmt(jreg.OP_REGISTRY[name].infer_signature(
        query, kwargs))
    out = getattr(nd.op, name)(
        *[nd.array(x, dtype=str(x.dtype)) for x in np_inputs], **kwargs)
    actual = (out[0] if isinstance(out, (list, tuple)) else out).asnumpy()
    shape, dtype = sig
    if shape is not None:
        assert len(shape) == actual.ndim, (name, len(shape), actual.ndim)
        for i, d in enumerate(shape):
            if d is not None and d.concrete is not None:
                assert d.concrete == actual.shape[i], (name, i)
    if dtype is not None:
        assert dtype == str(actual.dtype), (name, dtype, actual.dtype)


def test_infer_signature_symbolic_and_infeasible():
    od = preg.get_op("reshape")
    B = SR.sym("B")
    shape, dtype = od.infer_signature([((B, 8), "float32")],
                                      {"shape": (-1, 4)})
    assert SR.dim_eq(shape[0], SR.dim_mul(SR.lit(2), B)) is True
    assert SR.dim_eq(shape[1], SR.lit(4)) is True
    assert dtype == "float32"
    jshape, _ = jreg.OP_REGISTRY["reshape"].infer_signature(
        [((JSR.sym("B"), 8), "float32")], {"shape": (-1, 4)})
    assert [SR.fmt_dim(d) for d in shape] == [JSR.fmt_dim(d)
                                              for d in jshape]
    for reg, err in ((preg, MXNetError), (jreg, jmx.MXNetError)):
        with pytest.raises(err, match="infeasible"):
            reg.get_op("reshape").infer_signature([((3, 4), "float32")],
                                                  {"shape": (5, 2)})
    shape, _ = od.infer_signature([((6, 4), "float32")], {"shape": (3, -1)})
    assert shape == (SR.lit(3), SR.lit(8))
    no_rule = next(n for n in ref.CANONICAL if n in preg._OPS
                   and preg.get_op(n).shape_rule is None)
    assert preg.get_op(no_rule).infer_signature(
        [((2, 2), "float32")], {}) is None
    assert jreg.OP_REGISTRY[no_rule].shape_rule is None


class D:
    """A dim in a query: a symbol name, a literal, or None (unknown)."""

    def __init__(self, v, k=1):
        self.v, self.k = v, k

    def build(self, mod):
        if self.v is None:
            return None
        if isinstance(self.v, int):
            return mod.lit(self.v)
        d = mod.sym(self.v)
        return d if self.k == 1 else mod.dim_mul(mod.lit(self.k), d)


@pytest.mark.parametrize("check,args", [
    ("check_reshape", ((D("B", 2), D("H")), [D("B"), -1])),
    ("check_reshape", ((D(None), D(3)), [D(3), D(2)])),
    ("check_reshape", ((D(3), D(4)), [D(5), D(2)])),
    ("check_transpose", ((D("B"), D(4), D(5)), (2, 0, 1))),
    ("check_transpose", ((D("B"), D(4)), (0, 0))),
    ("broadcast", ((D("B"), D(1)), (D(4),))),
    ("broadcast", ((D(3), D(2)), (D(4),))),
    ("check_matmul", ((D(2), D("K")), (D("K"), D(7)))),
    ("check_matmul", ((D(2), D(3)), (D(4), D(7)))),
    ("check_einsum", ("ij,jk->ik", [(D(2), D(3)), (D(3), D(4))])),
    ("reduce_shape", ((D("B"), D(4), D(5)), (0, 2), True)),
    ("concat_shapes", ([(D(2), D(3)), (D(5), D(3))], 0)),
    ("concat_shapes", ([(D(2), D(3)), (D(5), D(4))], 0)),
])
def test_algebra_answers_as_the_jax_module(check, args):
    """Each checker on the same query in both modules: the same result
    (dims formatted) or the same error."""

    def build(mod, x):
        if isinstance(x, D):
            return x.build(mod)
        if isinstance(x, tuple):
            return tuple(build(mod, v) for v in x)
        if isinstance(x, list):
            return [build(mod, v) for v in x]
        return x

    res = []
    for mod in (JSR, SR):
        try:
            out = getattr(mod, check)(*[build(mod, a) for a in args])
            res.append(("ok", None if out is None else tuple(
                mod.fmt_dim(d) for d in out)))
        except mod.ShapeError as e:
            res.append(("err", str(e)))
    assert res[1] == res[0]
