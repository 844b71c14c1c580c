"""Declarative symbolic shape / dtype algebra and per-op inference rules.

The port's own copy of ``mxnet_tpu.ops.shape_rules`` (stdlib only): an
op with a rule here answers "what comes out?" from its inputs' shapes
and dtypes without running (``OpDef.infer_signature`` in
``ops/registry.py``).  Rules key on the registry's op names, so the
port's registry gets the same rules for the same names.

The dim lattice
---------------
A dimension is a :class:`Dim` — a rational coefficient times a product
of named symbols with integer exponents (``2*B*H/heads``) — or ``None``
for unknown.  Symbols stand for unknown positive extents (>= 1), which
lets ``2*B == 3*B`` be provably false instead of "true when B == 0".
Provability answers are three-valued (True / False / None-unknown), and
every consumer treats unknown as "stay quiet".

Dtypes follow the JAX package's promotion lattice (weak Python scalars
included), so ``bfloat16 + float16 -> float32`` and ``uint64 + int8 ->
weak float`` come out as that package resolves them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Dim", "ShapeError", "lit", "sym", "dim_mul", "dim_div", "dim_add",
    "dim_eq", "product", "fmt_dim", "fmt_shape",
    "check_reshape", "check_transpose", "broadcast", "check_matmul",
    "check_einsum", "reduce_shape", "concat_shapes",
    "promote", "DTYPES", "FLOAT_DTYPES", "INT_DTYPES", "QUANT_DTYPES",
    "SHAPE_RULES", "shape_rule", "rule_for",
]


class ShapeError(Exception):
    """A *provably* infeasible shape/dtype combination (never raised on
    merely-unknown inputs)."""


# --------------------------------------------------------------------- dims
class Dim:
    """``(num/den) * prod(sym_i ** exp_i)`` with num, den coprime ints,
    den >= 1, exponents nonzero.  Immutable; construct via :func:`lit` /
    :func:`sym` / the ``dim_*`` operations."""

    __slots__ = ("num", "den", "syms")

    def __init__(self, num: int, den: int = 1,
                 syms: Tuple[Tuple[str, int], ...] = ()):
        if den < 0:
            num, den = -num, -den
        if num == 0:
            den, syms = 1, ()
        g = math.gcd(abs(num), den) or 1
        self.num = num // g
        self.den = den // g
        self.syms = tuple(sorted((s, e) for s, e in syms if e != 0))

    # concrete = a plain nonnegative integer
    @property
    def concrete(self) -> Optional[int]:
        if not self.syms and self.den == 1:
            return self.num
        return None

    def _key(self):
        return (self.num, self.den, self.syms)

    def __eq__(self, other):
        return isinstance(other, Dim) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Dim({fmt_dim(self)})"


def lit(n: int) -> Dim:
    return Dim(int(n))


def sym(name: str) -> Dim:
    return Dim(1, 1, ((name, 1),))


def _merge_syms(a, b, negate_b=False):
    out: Dict[str, int] = {}
    for s, e in a:
        out[s] = out.get(s, 0) + e
    for s, e in b:
        out[s] = out.get(s, 0) + (-e if negate_b else e)
    return tuple((s, e) for s, e in out.items() if e != 0)


def dim_mul(a: Optional[Dim], b: Optional[Dim]) -> Optional[Dim]:
    if a is None or b is None:
        return None
    return Dim(a.num * b.num, a.den * b.den, _merge_syms(a.syms, b.syms))


def dim_div(a: Optional[Dim], b: Optional[Dim]) -> Optional[Dim]:
    """Exact symbolic division (the static model of ``//`` in shape
    arithmetic: code that floor-divides an extent intends it to divide,
    and if it does not the runtime fails regardless)."""
    if a is None or b is None or b.num == 0:
        return None
    return Dim(a.num * b.den, a.den * b.num,
               _merge_syms(a.syms, b.syms, negate_b=True))


def dim_add(a: Optional[Dim], b: Optional[Dim]) -> Optional[Dim]:
    """Addition is only closed over concrete dims; symbolic sums leave
    the product domain and go to ⊤."""
    if a is None or b is None:
        return None
    ca, cb = a.concrete, b.concrete
    if ca is not None and cb is not None:
        return lit(ca + cb)
    return None


def dim_eq(a: Optional[Dim], b: Optional[Dim]) -> Optional[bool]:
    """True / False / None(unknown).  Uses the symbols-are->=1
    assumption: if a/b reduces to a symbol-free ratio != 1, the dims are
    provably unequal."""
    if a is None or b is None:
        return None
    if a == b:
        return True
    if a.num == 0 or b.num == 0:
        # one side is exactly 0: symbols are >= 1, concretes differ
        return (a.num == 0) == (b.num == 0) or False
    r = dim_div(a, b)
    if r is not None and not r.syms:
        return r.num == r.den
    return None


def product(dims: Sequence[Optional[Dim]]) -> Optional[Dim]:
    out: Optional[Dim] = lit(1)
    for d in dims:
        out = dim_mul(out, d)
    return out


def fmt_dim(d: Optional[Dim]) -> str:
    if d is None:
        return "?"
    if d.concrete is not None:
        return str(d.concrete)
    parts = []
    if d.num != 1 or not d.syms:
        parts.append(str(d.num))
    for s, e in d.syms:
        parts.append(s if e == 1 else f"{s}^{e}")
    text = "*".join(parts)
    return f"{text}/{d.den}" if d.den != 1 else text


def fmt_shape(shape: Optional[Sequence[Optional[Dim]]]) -> str:
    if shape is None:
        return "(?)"
    return "(" + ", ".join(fmt_dim(d) for d in shape) + ")"


Shape = Optional[Tuple[Optional[Dim], ...]]


# ----------------------------------------------------------------- checkers
def check_reshape(in_shape: Shape, out_dims: List) -> Shape:
    """Feasibility of reshaping ``in_shape`` to ``out_dims`` (entries:
    Dim, None for unknown, or the python int ``-1`` to infer).

    Raises :class:`ShapeError` only on *provable* infeasibility: both
    element products symbol-free and unequal, or the products' ratio
    symbol-free and != 1 (same symbols, incompatible concrete factors —
    the ``reshape(L, B, heads, n, D)`` class where the factors cannot
    divide the input).  Returns the (possibly partially unknown) result
    shape otherwise.
    """
    if sum(1 for d in out_dims if isinstance(d, int) and d == -1) > 1:
        raise ShapeError("reshape target has more than one -1")
    infer = any(isinstance(d, int) and d == -1 for d in out_dims)
    known = [d for d in out_dims if not (isinstance(d, int) and d == -1)]

    def _resolved(inferred: Optional[Dim]) -> Shape:
        return tuple(inferred if isinstance(d, int) and d == -1 else d
                     for d in out_dims)

    if in_shape is None or any(d is None for d in in_shape) \
            or any(d is None for d in known):
        return _resolved(None)
    in_p = product(in_shape)
    out_p = product(known)
    if in_p is None or out_p is None:
        return _resolved(None)
    if infer:
        q = dim_div(in_p, out_p)
        if q is not None and not q.syms:
            if q.den != 1 or q.num < 1:
                raise ShapeError(
                    f"cannot reshape {fmt_shape(in_shape)} to "
                    f"{fmt_shape(_resolved(None))}: the -1 dimension "
                    f"resolves to {q.num}/{q.den}, not a positive "
                    f"integer — the explicit factors do not divide the "
                    f"input element count")
            return _resolved(lit(q.num))
        if q is not None and all(e > 0 for _, e in q.syms) and q.den == 1:
            return _resolved(q)     # -1 binds to a clean symbolic factor
        return _resolved(None)
    ok = dim_eq(in_p, out_p)
    if ok is False:
        raise ShapeError(
            f"reshape {fmt_shape(in_shape)} -> "
            f"{fmt_shape(tuple(known))} changes the element count "
            f"({fmt_dim(in_p)} vs {fmt_dim(out_p)}): the target factors "
            f"cannot tile the input")
    return _resolved(None)


def check_transpose(shape: Shape, axes) -> Shape:
    """``axes=None`` reverses; otherwise must be a permutation of
    ``range(rank)`` (negatives allowed)."""
    if shape is None:
        return None
    rank = len(shape)
    if axes is None:
        return tuple(reversed(shape))
    axes = list(axes)
    if len(axes) != rank:
        raise ShapeError(
            f"transpose axes {tuple(axes)} has {len(axes)} entries for a "
            f"rank-{rank} input {fmt_shape(shape)}")
    norm = []
    for a in axes:
        if not isinstance(a, int):
            return None
        if a < -rank or a >= rank:
            raise ShapeError(
                f"transpose axis {a} out of range for rank {rank}")
        norm.append(a % rank)
    if sorted(norm) != list(range(rank)):
        raise ShapeError(
            f"transpose axes {tuple(axes)} is not a permutation of "
            f"rank {rank}: axes repeat or are omitted")
    return tuple(shape[a] for a in norm)


def broadcast(s1: Shape, s2: Shape) -> Shape:
    """NumPy broadcast join.  Flags only concrete mismatches where
    neither side is 1 (a symbol could still *be* 1 and broadcast)."""
    if s1 is None or s2 is None:
        return None
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    s2 = (lit(1),) * (len(s1) - len(s2)) + tuple(s2)
    out = []
    for a, b in zip(s1, s2):
        ca = a.concrete if a is not None else None
        cb = b.concrete if b is not None else None
        if ca == 1:
            out.append(b)
        elif cb == 1:
            out.append(a)
        elif dim_eq(a, b) is True:
            out.append(a)
        elif ca is not None and cb is not None:
            raise ShapeError(
                f"operands {fmt_shape(s1)} and {fmt_shape(s2)} are not "
                f"broadcast-compatible: {ca} vs {cb} (neither is 1)")
        else:
            out.append(None)
    return tuple(out)


def check_matmul(s1: Shape, s2: Shape) -> Shape:
    """``a @ b`` contraction check: last axis of ``a`` against
    second-to-last of ``b`` (numpy matmul semantics, 1-D promotion)."""
    if s1 is None or s2 is None or not s1 or not s2:
        return None
    k1 = s1[-1]
    k2 = s2[-2] if len(s2) >= 2 else s2[-1]
    if dim_eq(k1, k2) is False:
        raise ShapeError(
            f"matmul contraction mismatch: {fmt_shape(s1)} @ "
            f"{fmt_shape(s2)} contracts {fmt_dim(k1)} against "
            f"{fmt_dim(k2)}")
    a_batch = s1[:-2] if len(s1) >= 2 else ()
    b_batch = s2[:-2] if len(s2) >= 2 else ()
    batch = broadcast(a_batch, b_batch)
    if batch is None:
        batch = ()
    out = list(batch)
    if len(s1) >= 2:
        out.append(s1[-2])
    if len(s2) >= 2:
        out.append(s2[-1])
    return tuple(out)


def check_einsum(spec: str, shapes: Sequence[Shape]) -> Shape:
    """Einsum axis algebra over explicit letter specs; ``...`` specs are
    left unchecked (⊤).  Flags rank mismatches and a letter bound to two
    provably different extents."""
    spec = spec.replace(" ", "")
    if "..." in spec:
        return None
    if "->" in spec:
        lhs, out_term = spec.split("->", 1)
    else:
        lhs, out_term = spec, None
    terms = lhs.split(",")
    if len(terms) != len(shapes):
        raise ShapeError(
            f"einsum spec {spec!r} names {len(terms)} operand(s) but "
            f"{len(shapes)} were supplied")
    binding: Dict[str, Optional[Dim]] = {}
    for term, shape in zip(terms, shapes):
        if shape is None:
            for letter in term:
                binding.setdefault(letter, None)
            continue
        if len(term) != len(shape):
            raise ShapeError(
                f"einsum term {term!r} has {len(term)} axes but its "
                f"operand is {fmt_shape(shape)} (rank {len(shape)})")
        for letter, d in zip(term, shape):
            if letter in binding:
                prev = binding[letter]
                same = dim_eq(prev, d)
                if same is False:
                    raise ShapeError(
                        f"einsum axis {letter!r} is bound to both "
                        f"{fmt_dim(prev)} and {fmt_dim(d)}")
                if same is not True:
                    binding[letter] = None
            else:
                binding[letter] = d
    if out_term is None:
        counts: Dict[str, int] = {}
        for t in terms:
            for letter in t:
                counts[letter] = counts.get(letter, 0) + 1
        out_term = "".join(sorted(k for k, v in counts.items() if v == 1))
    for letter in out_term:
        if letter not in binding:
            raise ShapeError(
                f"einsum output axis {letter!r} does not appear in any "
                f"input term of {spec!r}")
    return tuple(binding[letter] for letter in out_term)


def reduce_shape(shape: Shape, axis, keepdims: bool = False) -> Shape:
    """Reduction result shape; flags a concrete out-of-range axis."""
    if shape is None:
        return None
    rank = len(shape)
    if axis is None:
        return tuple(lit(1) for _ in shape) if keepdims else ()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    norm = set()
    for a in axes:
        if not isinstance(a, int):
            return None
        if a < -rank or a >= rank:
            raise ShapeError(
                f"reduction axis {a} out of range for input "
                f"{fmt_shape(shape)} (rank {rank})")
        norm.add(a % rank)
    if keepdims:
        return tuple(lit(1) if i in norm else d
                     for i, d in enumerate(shape))
    return tuple(d for i, d in enumerate(shape) if i not in norm)


def concat_shapes(shapes: Sequence[Shape], axis: int) -> Shape:
    """Concatenate along ``axis``: every other axis must agree."""
    if any(s is None for s in shapes) or not shapes:
        return None
    rank = len(shapes[0])
    for s in shapes[1:]:
        if len(s) != rank:
            raise ShapeError(
                f"concat operands disagree on rank: {fmt_shape(shapes[0])}"
                f" vs {fmt_shape(s)}")
    if not isinstance(axis, int) or axis < -rank or axis >= rank:
        return None
    axis %= rank
    out: List[Optional[Dim]] = list(shapes[0])
    for s in shapes[1:]:
        for i in range(rank):
            if i == axis:
                out[i] = dim_add(out[i], s[i])
            elif dim_eq(out[i], s[i]) is False:
                raise ShapeError(
                    f"concat operands disagree on non-concat axis {i}: "
                    f"{fmt_dim(out[i])} vs {fmt_dim(s[i])}")
            elif dim_eq(out[i], s[i]) is not True:
                out[i] = None
    return tuple(out)


# --------------------------------------------------------------- dtype join
# The JAX type-promotion lattice (jax.numpy.promote_types): weak python
# scalars are first-class members ('int', 'float', 'complex'), so
# `x_f32 * 2.0` stays float32 while `x_f32 * np.float64(2)` widens.
_LATTICE_EDGES = {
    "bool": ("int",),
    "int": ("uint8", "int8", "float"),
    "uint8": ("uint16", "int16"),
    "uint16": ("uint32", "int32"),
    "uint32": ("uint64", "int64"),
    "uint64": ("float",),
    "int8": ("int16",),
    "int16": ("int32",),
    "int32": ("int64",),
    # float8 members mirror jnp.promote_types exactly: each fp8 flavor
    # joins with every int (int64 sits atop the signed-int chain) but
    # with NO other float — jax raises TypePromotionError there, which
    # this lattice models as "no common ancestor" (promote -> None,
    # checkers stay quiet)
    "int64": ("float", "float8_e4m3fn", "float8_e5m2"),
    "float8_e4m3fn": (),
    "float8_e5m2": (),
    "float": ("bfloat16", "float16", "complex"),
    "bfloat16": ("float32",),
    "float16": ("float32",),
    "float32": ("float64", "complex64"),
    "float64": ("complex128",),
    "complex": ("complex64",),
    "complex64": ("complex128",),
    "complex128": (),
}
DTYPES = frozenset(_LATTICE_EDGES)
FLOAT_DTYPES = frozenset({"bfloat16", "float16", "float32", "float64"})
INT_DTYPES = frozenset({"int8", "int16", "int32", "int64",
                        "uint8", "uint16", "uint32", "uint64"})
# wire/storage dtypes a quantized artifact may declare for its packed
# weights (deploy manifest v4 `quantization` block)
QUANT_DTYPES = frozenset({"int8", "float8_e4m3fn", "float8_e5m2"})

_ANCESTORS: Dict[str, frozenset] = {}


def _ancestors(dt: str) -> frozenset:
    cached = _ANCESTORS.get(dt)
    if cached is None:
        out = {dt}
        for parent in _LATTICE_EDGES[dt]:
            out |= _ancestors(parent)
        cached = _ANCESTORS[dt] = frozenset(out)
    return cached


def promote(a: Optional[str], b: Optional[str]) -> Optional[str]:
    """Least upper bound in the JAX lattice; None (unknown) absorbs."""
    if a is None or b is None:
        return None
    if a not in DTYPES or b not in DTYPES:
        return None
    if a == b:
        return a
    common = _ancestors(a) & _ancestors(b)
    if not common:
        return None
    # the JAX lattice has a unique least element of every common set:
    # the one that is an ancestor of no *other* common element
    for c in common:
        if all(c == d or c not in _ancestors(d) for d in common):
            return c
    return None


# ---------------------------------------------------------- per-op rules
# A rule maps the op's input signatures to its output signature without
# tracing: rule(shapes, dtypes, kw) -> (shape, dtype), raising
# ShapeError on provable infeasibility and returning (None, None) when
# unknown.  `kw` values are python literals where the caller had them,
# Dim for symbolic extents, None otherwise — rules must treat missing
# or unknown entries as ⊤.
SHAPE_RULES: Dict[str, "callable"] = {}


def shape_rule(*names):
    """Register one inference rule under the op's registry name(s)."""

    def _deco(fn):
        for n in names:
            SHAPE_RULES[n] = fn
        return fn

    return _deco


def rule_for(name: str):
    return SHAPE_RULES.get(name)


def _as_dim(v):
    if isinstance(v, Dim):
        return v
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return v if v == -1 else lit(v)
    return None


def _first(shapes, dtypes):
    shape = shapes[0] if shapes else None
    dtype = dtypes[0] if dtypes else None
    return shape, dtype


@shape_rule("reshape", "Reshape")
def _rule_reshape(shapes, dtypes, kw):
    shape, dtype = _first(shapes, dtypes)
    target = kw.get("shape")
    if not isinstance(target, (tuple, list)) or kw.get("reverse"):
        return None, dtype
    out = []
    src = list(shape) if shape is not None else None
    i = 0
    for s in target:
        if isinstance(s, int) and s in (-2, -3, -4):
            return None, dtype          # MXNet splice codes: stay quiet
        if isinstance(s, int) and s == 0:
            # 0 = copy the input dim at this position
            out.append(src[i] if src is not None and i < len(src)
                       else None)
        else:
            out.append(_as_dim(s))
        i += 1
    return check_reshape(shape, out), dtype


@shape_rule("transpose")
def _rule_transpose(shapes, dtypes, kw):
    shape, dtype = _first(shapes, dtypes)
    axes = kw.get("axes")
    axes = tuple(axes) if isinstance(axes, (tuple, list)) and axes else None
    return check_transpose(shape, axes), dtype


@shape_rule("expand_dims")
def _rule_expand_dims(shapes, dtypes, kw):
    shape, dtype = _first(shapes, dtypes)
    axis = kw.get("axis", 0)
    if shape is None or not isinstance(axis, int):
        return None, dtype
    rank = len(shape)
    if axis < -rank - 1 or axis > rank:
        raise ShapeError(
            f"expand_dims axis {axis} out of range for rank {rank}")
    axis %= (rank + 1)
    return shape[:axis] + (lit(1),) + shape[axis:], dtype


@shape_rule("flatten", "Flatten")
def _rule_flatten(shapes, dtypes, kw):
    shape, dtype = _first(shapes, dtypes)
    if shape is None:
        return None, dtype
    if len(shape) == 0:
        return None, dtype
    return check_reshape(shape, [shape[0], -1]), dtype


@shape_rule("dot")
def _rule_dot(shapes, dtypes, kw):
    if len(shapes) < 2 or kw.get("transpose_a") or kw.get("transpose_b"):
        return None, None
    s1, s2 = shapes[0], shapes[1]
    dtype = promote(dtypes[0], dtypes[1])
    if s1 is None or s2 is None:
        return None, dtype
    # contracts last axis of lhs with FIRST of rhs (mxnet dot semantics)
    if dim_eq(s1[-1] if s1 else None, s2[0] if s2 else None) is False:
        raise ShapeError(
            f"dot contraction mismatch: {fmt_shape(s1)} . {fmt_shape(s2)}"
            f" contracts {fmt_dim(s1[-1])} against {fmt_dim(s2[0])}")
    return tuple(s1[:-1]) + tuple(s2[1:]), dtype


@shape_rule("batch_dot")
def _rule_batch_dot(shapes, dtypes, kw):
    if len(shapes) < 2:
        return None, None
    s1, s2 = shapes[0], shapes[1]
    dtype = promote(dtypes[0], dtypes[1])
    if kw.get("transpose_a") or kw.get("transpose_b"):
        return None, dtype
    return check_matmul(s1, s2), dtype


def _rule_reduce(shapes, dtypes, kw):
    shape, dtype = _first(shapes, dtypes)
    axis = kw.get("axis")
    if kw.get("exclude") or not (axis is None or isinstance(axis, int)
                                 or isinstance(axis, (tuple, list))):
        return None, dtype
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
    keep = kw.get("keepdims", False)
    if not isinstance(keep, bool):
        return None, dtype
    return reduce_shape(shape, axis, keep), dtype


for _name in ("sum", "sum_axis", "mean", "prod", "nansum", "nanprod",
              "max", "max_axis", "min", "min_axis"):
    SHAPE_RULES[_name] = _rule_reduce


@shape_rule("concat", "Concat")
def _rule_concat(shapes, dtypes, kw):
    axis = kw.get("dim", kw.get("axis", 1))
    dtype = None
    if dtypes:
        dtype = dtypes[0]
        for d in dtypes[1:]:
            dtype = promote(dtype, d)
    if not isinstance(axis, int):
        return None, dtype
    return concat_shapes(list(shapes), axis), dtype
