"""Automatic Mixed Precision (reference: ``python/mxnet/contrib/amp``)."""
from .amp import (init, init_trainer, scale_loss, unscale,
                  convert_hybrid_block, list_lp16_ops, list_fp32_ops)
from .loss_scaler import LossScaler
from . import lists

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "list_lp16_ops", "list_fp32_ops",
           "LossScaler", "lists"]
