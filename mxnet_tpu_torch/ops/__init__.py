"""Kernels of the PyTorch port and their plain PyTorch versions, and the
op registry's entry points (``OP_REGISTRY``, ``register``, ``get_op``,
``list_ops``, ``invoke``; ``import mxnet_tpu_torch`` registers the ops).

The flash-attention function is ``ops.flash_attention.flash_attention``;
it is not re-exported here, where its name would hide the module.
"""
from .flash_attention import (flash_attention_bwd_dkv,
                              flash_attention_bwd_dkv_reference,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_dq_reference,
                              flash_attention_fwd,
                              flash_attention_fwd_reference, flash_selfatt,
                              flash_selfatt_nomask)
from .paged_attention import (ragged_paged_attention,
                              ragged_paged_attention_reference,
                              ragged_paged_verify,
                              ragged_paged_verify_reference)
from .registry import OP_REGISTRY, get_op, invoke, list_ops, register

__all__ = ["flash_selfatt", "flash_selfatt_nomask",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference",
           "ragged_paged_attention", "ragged_paged_attention_reference",
           "ragged_paged_verify", "ragged_paged_verify_reference",
           "OP_REGISTRY", "get_op", "invoke", "list_ops", "register"]
