"""Tensor operators of the PyTorch port: elementwise, broadcast, scalar,
reduce, ordering, matrix, shape and indexing ops.

The counterpart of the part of ``mxnet_tpu.ops.tensor`` that the Gluon
path and its tests call, under the reference's names and aliases.  Each
op is a plain function on tensors.
"""
from __future__ import annotations

import math

import torch

from .registry import alias, register


def _dtype(name):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(name)


# XLA's lgamma (the JAX package's ``gammaln``): the Lanczos approximation
# with g = 7 and Euler's reflection below 0.5, in the input's dtype.
# libm's lgamma is more exact, but differs from the JAX op by ~1e-6 near
# the roots at 1 and 2; this one follows the JAX op's steps.
_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def _lanczos_lgamma(x):
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1)
    acc = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        acc = acc + c / (z + float(i) + 1.0)
    t = (_LANCZOS_G + 0.5) + z
    log_t = math.log(_LANCZOS_G + 0.5) + torch.log1p(z / (_LANCZOS_G + 0.5))
    log_y = (math.log(2) + math.log(math.pi)) / 2 \
        + (z + 0.5 - t / log_t) * log_t + torch.log(acc)
    frac = torch.abs(x) - torch.floor(torch.abs(x))
    frac = torch.where(frac > 0.5, 1 - frac, frac)
    denom = torch.log(torch.sin(math.pi * frac))
    refl = torch.where(torch.isfinite(denom),
                       math.log(math.pi) - denom - log_y, -denom)
    out = torch.where(reflect, refl, log_y)
    return torch.where(torch.isinf(x), torch.full_like(x, math.inf), out)


class _LGamma(torch.autograd.Function):
    """:func:`_lanczos_lgamma` with digamma as its derivative."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _lanczos_lgamma(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.digamma(x)


def lgamma(x):
    return _LGamma.apply(x)


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
    "gammaln": lgamma, "negative": torch.neg,
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


# ---------------------------------------------------------------------------
# the rest of the reference's tensor ops (the long tail of
# ``mxnet_tpu.ops.tensor``)
# ---------------------------------------------------------------------------
def device_for(ctx=""):
    """The device of an op without array inputs: its ``ctx`` argument (a
    Context or a name like ``"gpu(0)"``), else the current context."""
    from ..context import Context, cpu, current_context, gpu
    if isinstance(ctx, Context):
        return ctx.torch_device()
    if ctx:
        kind, _, rest = str(ctx).partition("(")
        idx = int(rest.rstrip(")") or 0)
        return (gpu(idx) if kind in ("gpu", "cuda") else cpu(idx)) \
            .torch_device()
    return current_context().torch_device()


def const(values, dtype, device):
    """A small 1-d tensor of host constants made on ``device`` by fill
    kernels, never by a host-to-device copy, so it can be made while a
    CUDA graph captures."""
    values = list(values)
    if not values:
        return torch.empty(0, dtype=dtype, device=device)
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


def linspace(start, stop, num, endpoint=True, dtype=torch.float32,
             device=None):
    """``jnp.linspace``'s arithmetic as XLA runs it: ``start * (1 - t) +
    stop * t`` for ``t = i * (1 / div)`` (XLA turns the division by a
    constant into a product) in the (inexact) dtype, the endpoint
    appended as ``stop`` itself; integer dtypes take the floor."""
    comp = dtype if dtype.is_floating_point else torch.float32
    div = (num - 1) if endpoint else num
    if num > 1:
        inv = torch.full((), 1.0, dtype=comp, device=device) / div
        t = torch.arange(div, dtype=comp, device=device) * inv
        start_t = torch.full((), start, dtype=comp, device=device)
        stop_t = torch.full((), stop, dtype=comp, device=device)
        out = start_t * (1 - t) + stop_t * t
        if endpoint:
            out = torch.cat([out, stop_t.reshape(1)])
    else:
        out = torch.full((num,), start, dtype=comp, device=device)
    if not dtype.is_floating_point:
        out = torch.floor(out)
    return out.to(dtype)


register("rcbrt")(lambda data: 1.0 / _UNARY["cbrt"](data))
# exp(gammaln): the sign of Gamma is dropped for negative x, as in the
# JAX package
register("gamma")(lambda data: torch.exp(lgamma(data)))


@register("shape_array", differentiable=False)
def shape_array(data):
    """The shape as a 1-d int32 array: the JAX package asks for int64
    but runs without x64, so its arrays are int32."""
    return const(data.shape, torch.int32, data.device)


@register("size_array", differentiable=False)
def size_array(data):
    """The element count as a (1,) int32 array (int32 for the reason
    :func:`shape_array` gives)."""
    return const([data.numel()], torch.int32, data.device)


@register("make_loss", aliases=["MakeLoss"])
def make_loss(data, *, grad_scale: float = 1.0, valid_thresh: float = 0.0,
              normalization: str = "null"):
    return data.clone()


register("_hypot_scalar")(lambda data, *, scalar=0.0: torch.hypot(
    data, torch.full_like(data, scalar)))
register("_greater_scalar_rev", differentiable=False)(
    lambda data, *, scalar=0.0: (scalar > data).to(data.dtype))


def _nan_reduce(data, axis, keepdims, exclude, unit, fn):
    return fn(torch.where(torch.isnan(data), torch.full_like(data, unit),
                          data), axis=axis, keepdims=keepdims,
              exclude=exclude)


@register("nansum")
def nansum(data, *, axis=None, keepdims: bool = False,
           exclude: bool = False):
    return _nan_reduce(data, axis, keepdims, exclude, 0.0, sum_op)


@register("nanprod")
def nanprod(data, *, axis=None, keepdims: bool = False,
            exclude: bool = False):
    return _nan_reduce(data, axis, keepdims, exclude, 1.0, prod)


@register("argmax_channel", differentiable=False)
def argmax_channel(data):
    return torch.argmax(data, dim=-1).to(torch.float32)


@register("khatri_rao", num_inputs=None)
def khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("depth_to_space")
def depth_to_space(data, *, block_size: int = 1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, *, block_size: int = 1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def diag(data, *, k: int = 0, axis1: int = 0, axis2: int = 1):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


def _nd_index(indices, shape):
    """The rows of ``indices`` (M, ...) as a tuple of int64 index
    tensors, negative entries counted from the end of their axis."""
    idx = indices.to(torch.int64)
    return tuple(torch.where(row < 0, row + shape[i], row)
                 for i, row in enumerate(idx))


@register("gather_nd", num_inputs=2)
def gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]`` (indices (M, ...))."""
    idx = _nd_index(indices, data.shape)
    return data[tuple(torch.clamp(t, 0, data.shape[i] - 1)
                      for i, t in enumerate(idx))]


@register("scatter_nd", num_inputs=2)
def scatter_nd(data, indices, *, shape=()):
    """Zeros of ``shape`` with ``data`` added at ``indices``' rows."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices, tuple(shape)), data,
                         accumulate=True)


@register("sequence_mask", num_inputs=2, aliases=["SequenceMask"])
def sequence_mask(data, sequence_length, *, use_sequence_length: bool = True,
                  value: float = 0.0, axis: int = 0):
    """Positions past each sequence's length set to ``value`` (axis 0:
    time-major).  ``use_sequence_length`` is ignored, as in the JAX
    package: the lengths are always read."""
    maxlen = data.shape[axis]
    steps = torch.arange(maxlen, device=data.device)
    mask = steps[:, None] < sequence_length.to(torch.int32)[None, :]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    if axis == 1:
        mask = mask.transpose(0, 1)
    return torch.where(mask, data, torch.full_like(data, value))


@register("sequence_last", num_inputs=2, aliases=["SequenceLast"])
def sequence_last(data, sequence_length, *,
                  use_sequence_length: bool = True, axis: int = 0):
    idx = sequence_length.to(torch.int64) - 1
    tail = data.shape[2:]
    if axis == 0:
        idx = idx.reshape((1, -1) + (1,) * len(tail)).expand(
            (1, data.shape[1]) + tail)
        return torch.gather(data, 0, idx)[0]
    idx = idx.reshape((-1, 1) + (1,) * len(tail)).expand(
        (data.shape[0], 1) + tail)
    return torch.gather(data, 1, idx)[:, 0]


@register("sequence_reverse", num_inputs=2, aliases=["SequenceReverse"])
def sequence_reverse(data, sequence_length, *,
                     use_sequence_length: bool = True, axis: int = 0):
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    rev = rev.reshape(rev.shape + (1,) * (data.dim() - 2)).expand(
        data.shape)
    return torch.gather(data, 0, rev)


@register("boolean_mask", num_inputs=2, aliases=["_contrib_boolean_mask"],
          differentiable=False)
def boolean_mask(data, index, *, axis: int = 0):
    """The rows of ``data`` whose ``index`` entry is non-zero.  The
    output's length depends on the data: on the card the op waits for
    the mask's count (``nonzero``'s sync), so it cannot run inside a
    captured CUDA graph and raises there instead."""
    from ..base import MXNetError
    if data.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "operator boolean_mask: its output size depends on the data, "
            "so it cannot run inside a captured CUDA graph (a hybridized "
            "block); call it outside the block")
    return data[index.to(torch.bool)]


# fills (the init ops of symbol graphs)
@register("_zeros", num_inputs=0, differentiable=False)
def _zeros(*, shape=(), dtype: str = "float32", ctx: str = ""):
    return torch.zeros(tuple(shape), dtype=_dtype(dtype),
                       device=device_for(ctx))


@register("_ones", num_inputs=0, differentiable=False)
def _ones(*, shape=(), dtype: str = "float32", ctx: str = ""):
    return torch.ones(tuple(shape), dtype=_dtype(dtype),
                      device=device_for(ctx))


@register("_full", num_inputs=0, differentiable=False)
def _full(*, shape=(), value: float = 0.0, dtype: str = "float32",
          ctx: str = ""):
    return torch.full(tuple(shape), value, dtype=_dtype(dtype),
                      device=device_for(ctx))


@register("_arange", num_inputs=0, differentiable=False)
def _arange(*, start: float = 0, stop=None, step: float = 1.0,
            repeat: int = 1, dtype: str = "float32", ctx: str = "",
            infer_range: bool = False):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch.float64,
                       device=device_for(ctx)).to(_dtype(dtype))
    return torch.repeat_interleave(out, repeat) if repeat > 1 else out


@register("_linspace", num_inputs=0, differentiable=False)
def _linspace(*, start: float = 0, stop: float = 1, num: int = 50,
              endpoint: bool = True, dtype: str = "float32", ctx: str = ""):
    return linspace(start, stop, num, endpoint, _dtype(dtype),
                    device_for(ctx))


@register("_eye", num_inputs=0, differentiable=False)
def _eye(*, N: int = 0, M: int = 0, k: int = 0, dtype: str = "float32",
         ctx: str = ""):
    dev = device_for(ctx)
    rows = torch.arange(N, device=dev)[:, None]
    cols = torch.arange(M if M else N, device=dev)[None, :]
    return (rows + k == cols).to(_dtype(dtype))


@register("_contrib_arange_like", differentiable=False,
          aliases=["arange_like"])
def arange_like(data, *, start: float = 0.0, step: float = 1.0,
                repeat: int = 1, axis=None):
    """``start + step * i`` over ``data``'s elements (``axis=None``) or
    along one axis, in ``data``'s dtype; ``repeat`` is ignored, as in
    the JAX package."""
    n = data.numel() if axis is None else data.shape[axis]
    out = torch.arange(n, dtype=data.dtype, device=data.device) * step \
        + start
    return out.reshape(data.shape) if axis is None else out


# AMP support
@register("amp_cast")
def amp_cast(data, *, dtype: str = "float32"):
    return data.to(_dtype(dtype))


def _amp_multicast_nout(kw):
    return int(kw.get("num_outputs", 1))


@register("amp_multicast", num_inputs=None, num_outputs=_amp_multicast_nout)
def amp_multicast(*data, num_outputs: int = 0):
    """Every input cast to the widest dtype among them."""
    if num_outputs != len(data):
        raise ValueError(
            f"amp_multicast: num_outputs={num_outputs} must equal the "
            f"number of inputs ({len(data)})")
    widest = data[0].dtype
    for d in data[1:]:
        widest = torch.promote_types(widest, d.dtype)
    return tuple(d.to(widest) for d in data)


@register("all_finite", num_inputs=None, differentiable=False)
def all_finite(*data, init_output: bool = True):
    """(1,) float32: 1 if every element of every input is finite, else
    0; one device reduction, no host read."""
    ok = torch.stack([torch.isfinite(d).all() for d in data]).all()
    return ok.to(torch.float32).reshape(1)


def _scan_dtype(data, dtype):
    if dtype:
        return _dtype(dtype)
    if data.dtype == torch.bool or (not data.is_floating_point()
                                    and data.element_size() < 4):
        return torch.int32
    return data.dtype


@register("cumsum", aliases=["_np_cumsum"])
def cumsum(data, *, axis=None, dtype=None):
    """Cumulative sum, numpy semantics (``axis=None`` flattens)."""
    x = data.reshape(-1) if axis is None else data
    return torch.cumsum(x, dim=0 if axis is None else axis).to(
        _scan_dtype(data, dtype))


@register("cumprod")
def cumprod(data, *, axis=None, dtype=None):
    """Cumulative product, numpy semantics (``axis=None`` flattens)."""
    x = data.reshape(-1) if axis is None else data
    return torch.cumprod(x, dim=0 if axis is None else axis).to(
        _scan_dtype(data, dtype))


@register("digamma")
def digamma(data):
    return torch.digamma(data)


@register("unravel_index", differentiable=False)
def unravel_index(data, *, shape=()):
    """Flat indices to multi-indices stacked on a leading axis, int32;
    negative indices count from the end and the rest are clipped into
    range, as ``jnp.unravel_index`` does."""
    shape = tuple(int(s) for s in shape)
    total = 1
    for s in shape:
        total *= s
    idx = data.to(torch.int64)
    idx = torch.clamp(torch.where(idx < 0, idx + total, idx), 0, total - 1)
    out = []
    for s in reversed(shape):
        out.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(out[::-1], dim=0).to(torch.int32)


def _split_v2_n_out(kwargs):
    ios = kwargs.get("indices_or_sections", 1)
    if isinstance(ios, int):
        return ios
    return len(tuple(ios)) + 1


@register("split_v2", num_outputs=_split_v2_n_out)
def split_v2(data, *, indices_or_sections=1, axis: int = 0,
             squeeze_axis: bool = False):
    """numpy-style split: an int is that many equal sections, a tuple the
    split points; one section comes back as one array."""
    ios = indices_or_sections
    if isinstance(ios, int):
        if data.shape[axis] % ios:
            raise ValueError(
                f"split_v2: axis {axis} of size {data.shape[axis]} does "
                f"not split into {ios} equal sections")
        parts = torch.tensor_split(data, ios, dim=axis)
    else:
        parts = torch.tensor_split(data, [int(i) for i in ios], dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("Crop", num_inputs=None, aliases=["crop_v1"])
def Crop(*inputs, offset=(0, 0), h_w=(0, 0), center_crop: bool = False,
         num_args: int = 1):
    """Spatial crop of NCHW data; with two inputs, to the second one's
    (H, W).  A region outside the input raises."""
    data = inputs[0]
    H, W = data.shape[2], data.shape[3]
    th, tw = (inputs[1].shape[2], inputs[1].shape[3]) \
        if len(inputs) == 2 else tuple(h_w)
    oy, ox = ((H - th) // 2, (W - tw) // 2) if center_crop \
        else tuple(offset)
    if not (0 <= oy and 0 <= ox and oy + th <= H and ox + tw <= W):
        raise ValueError(
            f"Crop: region offset={int(oy), int(ox)} h_w={th, tw} "
            f"exceeds input spatial size {H, W}")
    return data[:, :, oy:oy + th, ox:ox + tw]
