"""Models of the PyTorch port."""
from .transformer_blocks import (TransformerDecoderLM, load_paged_params,
                                 paged_decode_step, paged_lm_params,
                                 paged_prefill, paged_verify,
                                 paged_verify_batch)

__all__ = ["TransformerDecoderLM", "load_paged_params", "paged_lm_params",
           "paged_prefill", "paged_decode_step", "paged_verify",
           "paged_verify_batch"]
