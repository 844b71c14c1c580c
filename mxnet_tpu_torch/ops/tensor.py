"""Tensor operators of the PyTorch port: elementwise, broadcast, scalar,
reduce, ordering, matrix, shape and indexing ops.

The counterpart of the part of ``mxnet_tpu.ops.tensor`` that the Gluon
path and its tests call, under the reference's names and aliases.  Each
op is a plain function on tensors.
"""
from __future__ import annotations

import torch

from .registry import alias, register


def _dtype(name):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(name)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "ceil": torch.ceil,
    "floor": torch.floor, "rint": torch.round, "round": torch.round,
    "trunc": torch.trunc, "exp": torch.exp, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "expm1": torch.expm1, "sqrt": torch.sqrt,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
    "square": torch.square, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "degrees": torch.rad2deg,
    "radians": torch.deg2rad, "erf": torch.erf, "erfinv": torch.erfinv,
    "gammaln": torch.lgamma, "negative": torch.neg,
    "reciprocal": torch.reciprocal, "rsqrt": torch.rsqrt,
    "relu": torch.relu, "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "erfc": lambda x: 1.0 - torch.erf(x),
}

for _name, _fn in _UNARY.items():
    register(_name)((lambda f: (lambda data: f(data)))(_fn))

register("logical_not", differentiable=False)(
    lambda data: torch.logical_not(data).to(data.dtype))


@register("clip")
def clip(data, *, a_min: float = None, a_max: float = None):
    return torch.clamp(data, a_min, a_max)


@register("cast", aliases=["Cast"])
def cast(data, *, dtype: str = "float32"):
    return data.to(_dtype(dtype))


@register("zeros_like", differentiable=False)
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", differentiable=False)
def ones_like(data):
    return torch.ones_like(data)


@register("full_like", differentiable=False)
def full_like(data, *, fill_value: float = 0.0):
    return torch.full_like(data, fill_value)


@register("stop_gradient", aliases=["BlockGrad"])
def stop_gradient(data):
    return data.detach()


@register("identity", aliases=["_copy"])
def identity(data):
    return data.clone()


# ---------------------------------------------------------------------------
# binary, broadcast and scalar
# ---------------------------------------------------------------------------
def _mod(a, b):
    return torch.remainder(a, b)


_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "mod": _mod, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": torch.hypot, "arctan2": torch.atan2,
}

for _name, _fn in _BINARY.items():
    register(f"broadcast_{_name}", num_inputs=2)(
        (lambda f: (lambda lhs, rhs: f(lhs, rhs)))(_fn))

alias("broadcast_add", "broadcast_plus")
alias("broadcast_sub", "broadcast_minus")
alias("broadcast_power", "_power")

for _name in ("add", "sub", "mul", "div"):
    register(f"elemwise_{_name}", num_inputs=2,
             aliases=[f"_{_name}"] if _name != "sub" else ["_sub", "_minus"])(
        (lambda f: (lambda lhs, rhs: f(lhs, rhs)))(_BINARY[_name]))

_CMP = {
    "equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
    "greater_equal": torch.ge, "lesser": torch.lt,
    "lesser_equal": torch.le,
}
for _name, _fn in _CMP.items():
    register(f"broadcast_{_name}", num_inputs=2, differentiable=False)(
        (lambda f: (lambda lhs, rhs: f(lhs, rhs).to(lhs.dtype)))(_fn))
    register(f"_{_name}_scalar", differentiable=False)(
        (lambda f: (lambda data, *, scalar=0.0:
                    f(data, scalar).to(data.dtype)))(_fn))

for _name, _fn in (("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    register(f"broadcast_{_name}", num_inputs=2, differentiable=False)(
        (lambda f: (lambda lhs, rhs: f(lhs, rhs).to(lhs.dtype)))(_fn))


register("_plus_scalar")(lambda data, *, scalar=0.0: data + scalar)
register("_minus_scalar")(lambda data, *, scalar=0.0: data - scalar)
register("_rminus_scalar")(lambda data, *, scalar=0.0: scalar - data)
register("_mul_scalar")(lambda data, *, scalar=1.0: data * scalar)
register("_div_scalar")(lambda data, *, scalar=1.0: data / scalar)
register("_rdiv_scalar")(lambda data, *, scalar=1.0: scalar / data)
register("_mod_scalar")(lambda data, *, scalar=1.0: torch.remainder(
    data, scalar))
register("_rmod_scalar")(lambda data, *, scalar=1.0: torch.remainder(
    torch.full_like(data, scalar), data))
register("_power_scalar")(lambda data, *, scalar=1.0: data ** scalar)
register("_rpower_scalar")(lambda data, *, scalar=1.0: torch.pow(
    torch.full_like(data, scalar), data))
register("_maximum_scalar")(lambda data, *, scalar=0.0: torch.clamp(
    data, min=scalar))
register("_minimum_scalar")(lambda data, *, scalar=0.0: torch.clamp(
    data, max=scalar))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _norm_axis(axis):
    if axis is None or axis == ():
        return None
    if isinstance(axis, int):
        return (axis,)
    return tuple(axis)


def _axes(data, axis, exclude=False):
    axis = _norm_axis(axis)
    if exclude and axis is not None:
        axis = tuple(i for i in range(data.dim())
                     if i not in tuple(a % data.dim() for a in axis))
    return axis


@register("sum", aliases=["sum_axis"])
def sum_op(data, *, axis=None, keepdims: bool = False,
           exclude: bool = False):
    axis = _axes(data, axis, exclude)
    if axis is None:
        out = data.sum()
        return out.reshape((1,) * data.dim()) if keepdims else out
    return data.sum(dim=axis, keepdim=keepdims)


@register("mean")
def mean(data, *, axis=None, keepdims: bool = False, exclude: bool = False):
    axis = _axes(data, axis, exclude)
    if axis is None:
        out = data.mean()
        return out.reshape((1,) * data.dim()) if keepdims else out
    return data.mean(dim=axis, keepdim=keepdims)


@register("prod")
def prod(data, *, axis=None, keepdims: bool = False, exclude: bool = False):
    axis = _axes(data, axis, exclude)
    if axis is None:
        out = data.prod()
        return out.reshape((1,) * data.dim()) if keepdims else out
    out = data
    for a in sorted((a % data.dim() for a in axis), reverse=True):
        out = out.prod(dim=a, keepdim=keepdims)
    return out


def _minmax(fn, data, axis, keepdims, exclude):
    axis = _axes(data, axis, exclude)
    if axis is None:
        out = fn(data)
        return out.reshape((1,) * data.dim()) if keepdims else out
    return (torch.amax if fn is torch.max else torch.amin)(
        data, dim=axis, keepdim=keepdims)


@register("max", aliases=["max_axis"])
def max_op(data, *, axis=None, keepdims: bool = False,
           exclude: bool = False):
    return _minmax(torch.max, data, axis, keepdims, exclude)


@register("min", aliases=["min_axis"])
def min_op(data, *, axis=None, keepdims: bool = False,
           exclude: bool = False):
    return _minmax(torch.min, data, axis, keepdims, exclude)


@register("norm")
def norm(data, *, ord: int = 2, axis=None, keepdims: bool = False):
    axis = _norm_axis(axis)
    if ord == 1:
        return sum_op(torch.abs(data), axis=axis, keepdims=keepdims)
    return torch.sqrt(sum_op(torch.square(data), axis=axis,
                             keepdims=keepdims))


@register("argmax", differentiable=False)
def argmax(data, *, axis=None, keepdims: bool = False):
    return torch.argmax(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register("argmin", differentiable=False)
def argmin(data, *, axis=None, keepdims: bool = False):
    return torch.argmin(data, dim=axis, keepdim=keepdims).to(torch.float32)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------
@register("sort")
def sort(data, *, axis: int = -1, is_ascend: bool = True):
    return torch.sort(data, dim=axis, descending=not is_ascend,
                      stable=True).values


@register("argsort", differentiable=False)
def argsort(data, *, axis: int = -1, is_ascend: bool = True,
            dtype="float32"):
    idx = torch.sort(data, dim=axis, stable=True).indices
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(_dtype(dtype))


def _topk_nout(kwargs):
    return 2 if kwargs.get("ret_typ", "indices") == "both" else 1


@register("topk", differentiable=False, num_outputs=_topk_nout)
def topk(data, *, axis: int = -1, k: int = 1, ret_typ: str = "indices",
         is_ascend: bool = False, dtype="float32"):
    vals, idx = torch.topk(data, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    idx = idx.to(_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


# ---------------------------------------------------------------------------
# matrix
# ---------------------------------------------------------------------------
@register("dot", num_inputs=2)
def dot(lhs, rhs, *, transpose_a: bool = False, transpose_b: bool = False):
    """Contract the last axis of ``lhs`` with the first of ``rhs``."""
    if transpose_a and lhs.dim() > 1:
        lhs = torch.movedim(lhs, 0, -1)
    if transpose_b and rhs.dim() > 1:
        rhs = torch.movedim(rhs, -1, 0)
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register("batch_dot", num_inputs=2)
def batch_dot(lhs, rhs, *, transpose_a: bool = False,
              transpose_b: bool = False):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


# ---------------------------------------------------------------------------
# shape
# ---------------------------------------------------------------------------
def _reshape_target(src_shape, shape, reverse=False):
    """MXNet's special reshape codes: 0 keep, -1 infer, -2 copy the rest,
    -3 merge two, -4 split one."""
    shape = list(shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return tuple(shape)
    src = list(src_shape)[::-1] if reverse else list(src_shape)
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out[::-1] if reverse else out)


@register("reshape", aliases=["Reshape"])
def reshape(data, *, shape=(), reverse: bool = False):
    return data.reshape(_reshape_target(data.shape, shape, reverse))


@register("transpose")
def transpose(data, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(data.dim()))[::-1]
    return data.permute(axes)


@register("expand_dims")
def expand_dims(data, *, axis: int = 0):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, *, axis=None):
    axis = _norm_axis(axis)
    return data.squeeze() if axis is None else data.squeeze(axis)


@register("flatten", aliases=["Flatten"])
def flatten(data):
    return data.reshape(data.shape[0], -1)


@register("flip", aliases=["reverse"])
def flip(data, *, axis=0):
    return torch.flip(data, dims=_norm_axis(axis))


@register("repeat")
def repeat(data, *, repeats: int = 1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("tile")
def tile(data, *, reps=()):
    return torch.tile(data, tuple(reps))


@register("pad", aliases=["Pad"])
def pad(data, *, mode: str = "constant", pad_width=(),
        constant_value: float = 0.0):
    """N-d pad; ``pad_width`` is the flat (before, after) list per axis."""
    pw = tuple(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    flat = []
    for before, after in reversed(pairs):
        flat += [before, after]
    # trailing axes without padding are dropped from torch's list
    while flat and flat[-2:] == [0, 0] and len(flat) > 2:
        flat = flat[:-2]
    if mode == "constant":
        return torch.nn.functional.pad(data, flat, mode="constant",
                                       value=constant_value)
    return torch.nn.functional.pad(
        data, flat, mode={"edge": "replicate", "reflect": "reflect"}[mode])


@register("stack", num_inputs=None)
def stack(*data, axis: int = 0):
    return torch.stack(data, dim=axis)


@register("concat", num_inputs=None, aliases=["Concat"])
def concat(*data, dim: int = 1, num_args: int = 0):
    return torch.cat(data, dim=dim)


def _split_nout(kwargs):
    return int(kwargs.get("num_outputs", 1))


@register("split", num_outputs=_split_nout, aliases=["SliceChannel"])
def split(data, *, num_outputs: int = 1, axis: int = 1,
          squeeze_axis: bool = False):
    parts = torch.chunk(data, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("broadcast_to")
def broadcast_to(data, *, shape=()):
    tgt = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.expand(tgt)


@register("broadcast_like", num_inputs=2)
def broadcast_like(lhs, rhs, *, lhs_axes=None, rhs_axes=None):
    return lhs.expand(rhs.shape)


@register("broadcast_axis", aliases=["broadcast_axes"])
def broadcast_axis(data, *, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return data.expand(tuple(tgt))


@register("swapaxes", aliases=["SwapAxis"])
def swapaxes(data, *, dim1: int = 0, dim2: int = 0):
    return data.transpose(dim1, dim2)


# ---------------------------------------------------------------------------
# slicing and indexing
# ---------------------------------------------------------------------------
@register("slice", aliases=["crop"])
def slice_op(data, *, begin=(), end=(), step=()):
    step = tuple(step) if step else (None,) * len(begin)
    return data[tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))]


@register("slice_axis")
def slice_axis(data, *, axis: int = 0, begin: int = 0, end=None):
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("slice_like", num_inputs=2)
def slice_like(lhs, rhs, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(lhs.dim()))
    idx = [slice(None)] * lhs.dim()
    for a in axes:
        idx[a] = slice(0, rhs.shape[a])
    return lhs[tuple(idx)]


@register("take", num_inputs=2)
def take(a, indices, *, axis: int = 0, mode: str = "clip"):
    """Gather along ``axis``; out-of-range indices are clipped (or
    wrapped with ``mode='wrap'``), as in the reference."""
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" \
        else torch.clamp(idx, 0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    shape = a.shape[:axis % a.dim()] + tuple(indices.shape) \
        + a.shape[axis % a.dim() + 1:]
    return out.reshape(shape)


@register("pick", num_inputs=2)
def pick(data, index, *, axis: int = -1, keepdims: bool = False,
         mode: str = "clip"):
    idx = torch.clamp(index.to(torch.int64), 0, data.shape[axis] - 1)
    picked = torch.gather(data, axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


@register("one_hot", differentiable=False)
def one_hot(indices, *, depth: int = 0, on_value: float = 1.0,
            off_value: float = 0.0, dtype: str = "float32"):
    idx = indices.to(torch.int64)
    valid = (idx >= 0) & (idx < depth)
    oh = torch.nn.functional.one_hot(
        torch.where(valid, idx, 0), depth).to(_dtype(dtype))
    oh = oh * valid.unsqueeze(-1).to(oh.dtype)
    return oh * (on_value - off_value) + off_value


@register("where", num_inputs=3)
def where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)
