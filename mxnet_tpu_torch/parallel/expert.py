"""Expert parallelism of the PyTorch port: ``gluon.contrib.MoEFFN`` run
over the ``dp``, ``ep`` and ``tp`` axes of a :class:`.mesh.Mesh`.

The JAX package hands ``MEGATRON_RULES``' expert specs (``expert_w1``
``P("ep", None, "tp")``, ...) to GSPMD, which runs ``moe_ffn`` as one
program over the global batch.  The port holds each rank's shards as
plain tensors, so the bound layer (:func:`bind_moe`) runs
``ops.moe.moe_ffn_sharded`` on this rank's axes, which computes what that
one program computes:

- the tokens are replicated within an ``ep`` (and ``tp``) group, and
  ``dp`` splits the batch;
- every rank computes the gates of its tokens (``gate_weight`` is
  replicated);
- routing is the whole batch's: a token's place in its expert's queue is
  a cumsum over every token in batch-major order, so each rank offsets
  its positions by the per-expert counts of the ``dp`` ranks before it
  (an all-gather of ``E`` counts); the capacity is
  ``capacity_factor * S_global / E``; the Switch aux loss takes its two
  means over all tokens (the token fractions and the gate sums summed
  over ``dp``, the latter differentiably: all-reduce forward and
  backward, :func:`.sharding.all_reduce_sum`);
- each rank runs only its ``E / ep`` experts, their ``H / tp`` hidden
  units: the expert inputs are summed back over ``tp`` after the second
  product, ``b2`` added after that sum, and the partial outputs summed
  over ``ep`` — Megatron's ``g`` (all-reduce forward, identity
  backward);
- the inputs of the local part take Megatron's ``f`` (identity forward,
  all-reduce of the gradient backward): the tokens entering the experts
  over ``ep`` and ``tp``, and the gates entering the combine over
  ``ep``, so that the replicated ``gate_weight`` and the input get their
  whole gradients.  The gates that feed the aux loss skip ``f``: every
  rank computes that gradient whole.

A mesh of one rank, or one whose ``dp``, ``ep`` and ``tp`` are all 1,
binds nothing: the layer runs the plain ``moe_ffn`` with no collective.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ops.moe import moe_ffn_sharded
from . import sharding as _sh

__all__ = ["bind_moe"]

_NAMES = ("gate_weight", "expert_w1", "expert_b1", "expert_w2",
          "expert_b2")


def _axis(mesh, name):
    """One mesh axis as the bound layer uses it: its group, size and this
    rank's coordinate, with Megatron's ``f`` (``copy``) and ``g``
    (``reduce``), and the ``gather`` and ``sum`` that ``dp`` routing
    takes."""
    return _sh.TensorParallel(mesh.group(name), mesh.shape[name],
                              mesh.coords[name], None)


class _MoEBinding:
    """A bound ``MoEFFN``'s forward: the registered-op-like call over
    NDArrays that runs :func:`moe_ffn_sharded` on this rank's axes."""

    def __init__(self, dp, ep, tp):
        self.dp, self.ep, self.tp = dp, ep, tp

    def __call__(self, x, wg, w1, b1, w2, b2, *, capacity_factor,
                 activation):
        from ..ops.registry import OpDef, invoke

        def fn(x, wg, w1, b1, w2, b2):
            return moe_ffn_sharded(x, wg, w1, b1, w2, b2,
                                   capacity_factor=capacity_factor,
                                   activation=activation, dp=self.dp,
                                   ep=self.ep, tp=self.tp)

        out, aux = invoke(OpDef("moe_ffn_expert_parallel", fn, 6, 2, True),
                          [x, wg, w1, b1, w2, b2], {})
        return out, aux


def bind_moe(block, tp):
    """``MoEFFN.bind_tensor_parallel``: ``(binding, the parameters it runs
    split)`` on ``tp.mesh``, or ``(None, [])`` when no axis of size > 1
    reaches the layer.  Each expert parameter is split over ``ep`` on its
    expert dimension, or not at all, and its hidden dimension over
    ``tp``, or not at all, all of them alike (``MEGATRON_RULES``'
    layout); ``gate_weight`` is replicated.  Any other placement
    raises."""
    mesh = tp.mesh
    if mesh is None or mesh.groups is None:
        return None, []
    # ShardedTrainer's spec_of names only the axes of size > 1
    params = {n: getattr(block, n) for n in _NAMES}
    specs = {n: (tuple(tp.spec_of(p)) + (None,) * 3)[:len(p.shape)]
             for n, p in params.items()}
    e, _m, h = specs["expert_w1"]
    want = {"gate_weight": (None, None), "expert_w1": (e, None, h),
            "expert_b1": (e, h), "expert_w2": (e, h, None),
            "expert_b2": (e, None)}
    if e not in (None, "ep") or h not in (None, "tp") or specs != want:
        raise MXNetError(
            f"MoEFFN {block.name!r}: expert placements {specs} are not the "
            f"expert-parallel layout (expert dim over 'ep', hidden dim over "
            f"'tp', gate_weight replicated)")
    dp = _axis(mesh, "dp") if mesh.shape.get("dp", 1) > 1 else None
    ep = _axis(mesh, "ep") if e else None
    tpa = _axis(mesh, "tp") if h else None
    if dp is None and ep is None and tpa is None:
        return None, []
    split = [params[n] for n in _NAMES[1:]] if (e or h) else []
    return _MoEBinding(dp, ep, tpa), split
