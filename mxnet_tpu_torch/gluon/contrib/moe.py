"""Mixture-of-Experts Gluon layer of the PyTorch port, expert-parallel
on the ``ep`` mesh axis (the counterpart of
``mxnet_tpu.gluon.contrib.moe``).

A ``HybridBlock`` over the registered ``moe_ffn`` (``ops/moe.py``):
top-1 (Switch) routing over a fixed expert capacity, the experts' MLPs
as batched products, the combine back to the tokens.  Its parameters
carry the names ``parallel.MEGATRON_RULES`` splits over ``ep`` (and the
hidden dimension over ``tp``).  Under a ``parallel.ShardedTrainer`` over
such a mesh the layer runs bound (:mod:`mxnet_tpu_torch.parallel.expert`):
each rank routes its tokens as the whole batch's routing would, runs
only its own experts, and the partial outputs are summed over the
group.

    layer = MoEFFN(units=512, hidden_size=2048, num_experts=8)
    out, aux_loss = layer(x)          # add aux_weight*aux_loss to loss
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["MoEFFN"]


class MoEFFN(HybridBlock):
    """Switch/GShard top-1 MoE feed-forward block.

    Inputs (..., units); returns (output (..., units), aux_loss ()).
    Tokens routed past an expert's ``capacity_factor`` allowance are
    dropped (carried by the caller's residual connection, per GShard).
    """

    def __init__(self, units, hidden_size, num_experts,
                 capacity_factor=1.25, activation="gelu",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        if num_experts < 1:
            raise MXNetError("MoEFFN needs num_experts >= 1")
        if activation not in ("relu", "gelu"):
            raise MXNetError(
                f"MoEFFN: unsupported activation {activation!r} "
                f"(supported: 'relu', 'gelu')")
        self._capacity_factor = float(capacity_factor)
        self._activation = activation
        # the expert-parallel binding a ShardedTrainer sets for a forward
        self._tp = None
        with self.name_scope():
            self.gate_weight = self.params.get(
                "gate_weight", shape=(units, num_experts),
                init=weight_initializer)
            self.expert_w1 = self.params.get(
                "expert_w1", shape=(num_experts, units, hidden_size),
                init=weight_initializer)
            self.expert_b1 = self.params.get(
                "expert_b1", shape=(num_experts, hidden_size), init="zeros")
            self.expert_w2 = self.params.get(
                "expert_w2", shape=(num_experts, hidden_size, units),
                init=weight_initializer)
            self.expert_b2 = self.params.get(
                "expert_b2", shape=(num_experts, units), init="zeros")

    def bind_tensor_parallel(self, tp):
        """The layer's layout on ``tp``'s mesh (``tp.spec_of`` takes this
        block's Parameters): ``(binding, the parameters it runs split)``,
        or ``(None, [])`` when nothing needs a collective (one rank: the
        plain ``moe_ffn``)."""
        from ...parallel.expert import bind_moe
        return bind_moe(self, tp)

    def hybrid_forward(self, F, x, gate_weight, expert_w1, expert_b1,
                       expert_w2, expert_b2):
        kw = dict(capacity_factor=self._capacity_factor,
                  activation=self._activation)
        if self._tp is not None:
            return self._tp(x, gate_weight, expert_w1, expert_b1,
                            expert_w2, expert_b2, **kw)
        out, aux = F.moe_ffn(x, gate_weight, expert_w1, expert_b1,
                             expert_w2, expert_b2, **kw)
        return out, aux
