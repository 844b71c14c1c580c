"""Test fixture library of the PyTorch port (reference:
python/mxnet/test_utils.py — ``check_numeric_gradient``,
``check_consistency``, ``assert_almost_equal``, ``rand_ndarray``,
``default_context``; the counterpart of ``mxnet_tpu.test_utils``).

``default_context()`` is ``MXNET_TEST_CTX`` when set (``"cpu"``,
``"gpu"``: a context constructor's name), else the current context —
the card, unless the caller is inside ``with mx.cpu(0):``.
``rand_ndarray(..., stype="csr" | "row_sparse")`` returns the port's
sparse arrays (``nd.sparse``): a ``density`` share of the elements
(CSR) or of the rows (row-sparse) are non-zero.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from .base import MXNetError, declare_env, get_env
from .context import Context, current_context

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "same", "almost_equal", "rand_ndarray", "rand_shape_2d",
           "rand_shape_3d", "check_numeric_gradient", "check_consistency",
           "numeric_grad", "simple_forward", "check_symbolic_forward",
           "check_symbolic_backward"]

declare_env("MXNET_TEST_CTX", None,
            "Context for test_utils.default_context (the reference's "
            "GPU-suite switch): 'cpu' or 'gpu', a mxnet_tpu_torch.context "
            "constructor's name; unset, the current context.")

_DEFAULT_CTX = None


def default_context() -> Context:
    """The tests' context (module docstring)."""
    if _DEFAULT_CTX is not None:
        return _DEFAULT_CTX
    name = get_env("MXNET_TEST_CTX")
    if not name:
        return current_context()
    from . import context as ctx_mod
    return getattr(ctx_mod, name.split("(")[0])(0)


def set_default_context(ctx: Context):
    global _DEFAULT_CTX
    _DEFAULT_CTX = ctx


def _as_np(x):
    from .ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same(a, b) -> bool:
    return np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20) -> bool:
    return np.allclose(_as_np(a), _as_np(b), rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-6, names=("a", "b")):
    a_np, b_np = _as_np(a), _as_np(b)
    if a_np.shape != b_np.shape:
        raise AssertionError(
            f"shape mismatch: {names[0]}{a_np.shape} vs {names[1]}{b_np.shape}")
    if not np.allclose(a_np, b_np, rtol=rtol, atol=atol):
        err = np.abs(a_np - b_np)
        rel = err / (np.abs(b_np) + atol)
        idx = np.unravel_index(np.argmax(rel), rel.shape)
        raise AssertionError(
            f"{names[0]} != {names[1]} (rtol={rtol}, atol={atol}): "
            f"max abs err {err.max():.3g}, max rel err {rel.max():.3g} "
            f"at {idx}: {a_np[idx]} vs {b_np[idx]}")


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None):
    """U[-1, 1) draws of ``shape`` on ``ctx`` (default: the current
    context) from that device's generator; with ``stype`` ``"csr"`` (2-D)
    or ``"row_sparse"`` a sparse array whose non-zero elements (CSR) or
    rows (row-sparse) are a ``density`` share (default 0.5), drawn from
    the same generator."""
    from .ndarray import NDArray, to_torch_dtype
    ctx = ctx or current_context()
    dev = ctx.torch_device()
    shape = tuple(shape)
    data = torch.empty(shape, dtype=torch.float32, device=dev).uniform_(
        -1.0, 1.0)
    if stype == "default":
        return NDArray(data.to(to_torch_dtype(dtype)), ctx=ctx)
    if stype not in ("csr", "row_sparse"):
        raise MXNetError(f"rand_ndarray: unknown stype {stype!r}")
    if stype == "csr" and len(shape) != 2:
        raise MXNetError(f"rand_ndarray: a CSR array is 2-D, got {shape}")
    density = 0.5 if density is None else float(density)
    mask_shape = shape if stype == "csr" else shape[:1]
    keep = torch.empty(mask_shape, device=dev).uniform_() < density
    if stype == "row_sparse":
        keep = keep.reshape((-1,) + (1,) * (len(shape) - 1))
    dense = torch.where(keep, data, torch.zeros_like(data))
    return NDArray(dense.to(to_torch_dtype(dtype)), ctx=ctx).tostype(stype)


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def simple_forward(fn, *inputs, **kwargs):
    from .ndarray import array
    outs = fn(*[array(i) for i in inputs], **kwargs)
    if isinstance(outs, (list, tuple)):
        return [o.asnumpy() for o in outs]
    return outs.asnumpy()


def numeric_grad(f: Callable[[List[np.ndarray]], float],
                 inputs: List[np.ndarray], eps: float = 1e-4):
    """Central finite differences of a scalar function (reference:
    test_utils.numeric_grad)."""
    grads = []
    for x in inputs:
        g = np.zeros_like(x, dtype=np.float64)
        flat = x.reshape(-1)
        gf = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = f(inputs)
            flat[j] = orig - eps
            fm = f(inputs)
            flat[j] = orig
            gf[j] = (fp - fm) / (2 * eps)
        grads.append(g)
    return grads


def check_numeric_gradient(fn, inputs, kwargs=None, rtol=1e-2, atol=1e-4,
                           eps=1e-3, aggregate="sum"):
    """Compare autograd gradients of ``fn`` against finite differences.

    ``fn`` maps NDArrays -> NDArray (or tuple; first output used); the
    tape path (``autograd.record`` / ``backward``) is what is checked.
    """
    from . import autograd
    from .ndarray import array
    kwargs = kwargs or {}
    np_inputs = [np.asarray(i, dtype=np.float64) for i in inputs]

    def scalar_f(nps):
        outs = fn(*[array(x.astype(np.float32)) for x in nps], **kwargs)
        if isinstance(outs, (list, tuple)):
            outs = outs[0]
        return float(outs.sum().asscalar())

    expected = numeric_grad(scalar_f, [x.copy() for x in np_inputs], eps=eps)

    nd_inputs = [array(x.astype(np.float32)) for x in np_inputs]
    for x in nd_inputs:
        x.attach_grad()
    with autograd.record():
        outs = fn(*nd_inputs, **kwargs)
        if isinstance(outs, (list, tuple)):
            outs = outs[0]
        loss = outs.sum()
    loss.backward()
    for i, (x, exp) in enumerate(zip(nd_inputs, expected)):
        assert_almost_equal(x.grad.asnumpy(), exp.astype(np.float32),
                            rtol=rtol, atol=atol,
                            names=(f"autograd_grad[{i}]", f"numeric_grad[{i}]"))


def check_consistency(fn, inputs, ctx_list=None, rtol=1e-4, atol=1e-5,
                      kwargs=None):
    """Run the same computation on several contexts and compare — the
    reference's cpu-vs-gpu consistency pattern (the first context is
    the oracle; default: :func:`default_context` alone)."""
    from .ndarray import array
    kwargs = kwargs or {}
    if ctx_list is None:
        ctx_list = [default_context()]
    results = []
    for ctx in ctx_list:
        outs = fn(*[array(i, ctx=ctx) for i in inputs], **kwargs)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        results.append([o.asnumpy() for o in outs])
    base = results[0]
    for r in results[1:]:
        for b, o in zip(base, r):
            assert_almost_equal(b, o, rtol=rtol, atol=atol)
    return base


def check_symbolic_forward(sym, inputs, expected, rtol=1e-5, atol=1e-6,
                           ctx=None):
    """Evaluate a Symbol graph and compare to numpy expectation
    (reference: test_utils.check_symbolic_forward)."""
    from .ndarray import array
    args = {name: array(val, ctx=ctx) for name, val in
            zip(sym.list_arguments(), inputs)}
    outs = sym.eval(ctx=ctx, **args)
    for o, e in zip(outs, expected):
        assert_almost_equal(o.asnumpy(), e, rtol=rtol, atol=atol)


def check_symbolic_backward(sym, inputs, out_grads, expected, rtol=1e-5,
                            atol=1e-6, ctx=None):
    """Bind ``sym`` in an Executor, run forward (training) and backward
    from ``out_grads``, and compare each argument's gradient with
    ``expected`` (None skips one)."""
    from .executor import Executor
    from .ndarray import array
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    args = {n: array(v, ctx=ctx) for n, v in zip(arg_names, inputs)}
    grads = {n: array(np.zeros_like(v), ctx=ctx)
             for n, v in zip(arg_names, inputs)}
    exe = Executor(sym, ctx, args, grads, "write", {})
    exe.forward(is_train=True)
    exe.backward([array(g, ctx=ctx) for g in out_grads])
    for n, e in zip(arg_names, expected):
        if e is None:
            continue
        assert_almost_equal(exe.grad_dict[n].asnumpy(), e, rtol=rtol,
                            atol=atol, names=(f"grad[{n}]", "expected"))
