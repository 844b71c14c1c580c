"""Models of the PyTorch port.

The JAX package's names, at its module paths, are Gluon
``HybridBlock``\\ s: BERT (:mod:`.bert`), the NMT Transformer
(:mod:`.transformer`) with its beam search (:mod:`.decoding`), and their
blocks (:mod:`.transformer_blocks`).  The ``torch.nn.Module`` forms that
serving, ``ShardedTrainer``'s tensor parallelism and the artifact path
run are :mod:`.torch_bert` and :mod:`.torch_blocks`; the decoder-only LM
and its paged forwards, which the decode engine runs, are
``nn.Module`` code in :mod:`.transformer_blocks`.
"""
from . import torch_blocks
from . import torch_bert
from . import transformer_blocks
from . import bert
from . import transformer
from . import decoding
from .bert import (BERTClassifier, BERTEncoder, BERTForPretrain, BERTForQA,
                   BERTModel, BERTPretrainLoss, bert_12_768_12,
                   bert_24_1024_16, get_bert_model)
from .transformer import (SmoothedSoftmaxCELoss, Transformer,
                          TransformerDecoder, TransformerEncoder,
                          transformer_base, transformer_big)
from .transformer_blocks import (TransformerDecoderLM, load_paged_params,
                                 paged_decode_step, paged_lm_params,
                                 paged_prefill, paged_verify,
                                 paged_verify_batch)

__all__ = ["BERTEncoder", "BERTModel", "BERTForPretrain",
           "BERTPretrainLoss", "BERTForQA",
           "BERTClassifier", "bert_12_768_12", "bert_24_1024_16",
           "get_bert_model", "Transformer", "TransformerEncoder",
           "TransformerDecoder", "transformer_base", "transformer_big",
           "SmoothedSoftmaxCELoss", "TransformerDecoderLM",
           "load_paged_params", "paged_lm_params", "paged_prefill",
           "paged_decode_step", "paged_verify", "paged_verify_batch"]
