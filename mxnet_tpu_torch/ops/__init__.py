"""Kernels of the PyTorch port and their plain PyTorch versions."""
from .paged_attention import (ragged_paged_attention,
                              ragged_paged_attention_reference,
                              ragged_paged_verify,
                              ragged_paged_verify_reference)

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "ragged_paged_verify", "ragged_paged_verify_reference"]
