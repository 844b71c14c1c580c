"""Models of the PyTorch port."""
from .bert import (BERTClassifier, BERTEncoder, BERTForPretrain, BERTModel,
                   BERTPretrainLoss, bert_12_768_12, bert_24_1024_16,
                   get_bert_model, pretrain_loss)
from .transformer_blocks import (MultiHeadSelfAttention, PositionwiseFFN,
                                 TransformerDecoderLM, TransformerEncoderCell,
                                 load_paged_params, paged_decode_step,
                                 paged_lm_params, paged_prefill, paged_verify,
                                 paged_verify_batch)

__all__ = ["BERTEncoder", "BERTModel", "BERTClassifier", "BERTForPretrain", "BERTPretrainLoss",
           "pretrain_loss", "bert_12_768_12", "bert_24_1024_16",
           "get_bert_model", "PositionwiseFFN", "MultiHeadSelfAttention",
           "TransformerEncoderCell", "TransformerDecoderLM",
           "load_paged_params", "paged_lm_params", "paged_prefill",
           "paged_decode_step", "paged_verify", "paged_verify_batch"]
