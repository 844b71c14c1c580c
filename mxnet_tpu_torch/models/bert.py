"""BERT as Gluon blocks: the encoder, the model, the pretraining heads
and loss, and the classification and SQuAD span heads.

The PyTorch port of ``mxnet_tpu/models/bert.py`` (GluonNLP's
``bert_12_768_12`` / ``bert_24_1024_16``), as ``HybridBlock``\\ s under
the JAX package's names and parameter prefixes: ``initialize``,
``collect_params``, ``hybridize`` (one CUDA graph a step on the card)
and ``gluon.Trainer`` work on them, and a JAX block's
``save_parameters`` file loads with ``load_parameters``.  The internal
layout is (L, B, C) time-major with (B, L) int token inputs at the API
boundary: ``model(inputs, token_types, valid_length)``.

``use_flash=True`` passes ``valid_length`` to each layer's
``F.flash_selfatt`` as its key lengths (B1 forward, B2/B3 backward on
the card; no (L, L) mask is made); ``use_flash=False`` adds the
additive (B*H, L, L) mask of :meth:`BERTModel._make_mask`, built on the
inputs' device.  The ``nn.Module`` form, which serving and tensor
parallelism run, is :mod:`.torch_bert`.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import ndarray as nd
from ..gluon import nn
from ..gluon.block import HybridBlock
from .transformer_blocks import TransformerEncoderCell

__all__ = ["BERTEncoder", "BERTModel", "BERTForPretrain", "BERTPretrainLoss",
           "BERTForQA", "BERTClassifier", "bert_12_768_12",
           "bert_24_1024_16", "get_bert_model"]

NEG_INF = -1e9


class BERTEncoder(HybridBlock):
    """Learned positions + LayerNorm + a stack of post-norm GELU
    :class:`TransformerEncoderCell` layers over (L, B, C)."""

    def __init__(self, units=768, hidden_size=3072, num_layers=12,
                 num_heads=12, dropout=0.1, max_length=512,
                 layer_norm_eps=1e-12, use_flash=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        self._max_length = max_length
        with self.name_scope():
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units),
                init="normal")
            self.layer_norm = nn.LayerNorm(in_channels=units,
                                           epsilon=layer_norm_eps)
            self.dropout_layer = nn.Dropout(dropout)
            self.transformer_cells = nn.HybridSequential()
            for _ in range(num_layers):
                self.transformer_cells.add(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout,
                    activation="gelu", layer_norm_eps=layer_norm_eps,
                    use_flash=use_flash))

    def hybrid_forward(self, F, x, mask=None, valid_length=None,
                       position_weight=None):
        # the first L positions, written with ops a Symbol also composes
        pos = F.slice_like(position_weight, x, axes=(0,))
        x = F.broadcast_add(x, F.expand_dims(pos, axis=1))
        x = self.dropout_layer(self.layer_norm(x))
        for cell in self.transformer_cells:
            x = cell(x, mask, valid_length)
        return x


class BERTModel(HybridBlock):
    """Embeddings + encoder + pooler (GluonNLP ``BERTModel``).

    Call: ``model(inputs, token_types, valid_length)`` with (B, L) ints;
    returns (sequence_output (B, L, C), pooled_output (B, C)), or the
    sequence output alone with ``use_pooler=False``."""

    def __init__(self, units=768, hidden_size=3072, num_layers=12,
                 num_heads=12, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, dropout=0.1, layer_norm_eps=1e-12,
                 use_pooler=True, use_flash=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        self._use_pooler = use_pooler
        self._use_flash = use_flash
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units,
                                           weight_initializer="normal")
            self.token_type_embed = nn.Embedding(token_type_vocab_size,
                                                 units,
                                                 weight_initializer="normal")
            self.encoder = BERTEncoder(units, hidden_size, num_layers,
                                       num_heads, dropout, max_length,
                                       layer_norm_eps, use_flash=use_flash)
            if use_pooler:
                self.pooler = nn.Dense(units, in_units=units,
                                       activation="tanh", flatten=False)

    def _make_mask(self, F, valid_length, L):
        """Additive (B*H, L, L) mask: 0 where the key is below the row's
        valid length, NEG_INF past it; made on ``valid_length``'s device."""
        steps = nd.arange(L, ctx=valid_length.context)          # (L,)
        keys_ok = F.broadcast_lesser(
            steps.reshape((1, L)),
            valid_length.reshape((-1, 1)).astype("float32"))    # (B, L)
        mask = (1.0 - keys_ok) * NEG_INF
        mask = mask.reshape((-1, 1, 1, L))
        mask = mask.broadcast_to((mask.shape[0], self._num_heads, L, L))
        return mask.reshape((-1, L, L))

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None):
        # F.* ops throughout, so that the flash model also composes over
        # Symbols (HybridBlock.export, optimize_for)
        emb = self.word_embed(inputs)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        x = F.swapaxes(emb, dim1=0, dim2=1)                     # (L, B, C)
        if self._use_flash:
            # padding rides the flash kernel's lengths
            out = self.encoder(x, None, valid_length)
        else:
            mask = None
            if valid_length is not None:
                mask = self._make_mask(F, valid_length, inputs.shape[1])
            out = self.encoder(x, mask)
        seq = F.swapaxes(out, dim1=0, dim2=1)                   # (B, L, C)
        if not self._use_pooler:
            return seq
        pooled = self.pooler(F.squeeze(
            F.slice_axis(seq, axis=1, begin=0, end=1), axis=1))
        return seq, pooled


class BERTForPretrain(HybridBlock):
    """MLM + NSP heads over :class:`BERTModel` (GluonNLP
    ``BERTForPretrain``)."""

    def __init__(self, bert: BERTModel, vocab_size=None, **kwargs):
        super().__init__(**kwargs)
        units = bert._units
        self._vocab_size = vocab_size or bert.word_embed._input_dim
        with self.name_scope():
            self.bert = bert
            self.mlm_dense = nn.Dense(units, in_units=units, flatten=False)
            self.mlm_norm = nn.LayerNorm(in_channels=units, epsilon=1e-12)
            self.mlm_decoder = nn.Dense(self._vocab_size, in_units=units,
                                        flatten=False)
            self.nsp_classifier = nn.Dense(2, in_units=units)

    def hybrid_forward(self, F, inputs, token_types, valid_length,
                       masked_positions):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        gathered = _gather_positions(F, seq, masked_positions)  # (B, M, C)
        h = F._contrib_gelu_erf(self.mlm_dense(gathered))
        mlm_scores = self.mlm_decoder(self.mlm_norm(h))         # (B, M, V)
        nsp_scores = self.nsp_classifier(pooled)                # (B, 2)
        return mlm_scores, nsp_scores


class BERTPretrainLoss(HybridBlock):
    """The MLM + NSP loss inside the block, so that one hybridized
    program holds the whole step's forward."""

    def __init__(self, pretrain: "BERTForPretrain", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.pretrain = pretrain

    def hybrid_forward(self, F, inputs, token_types, valid_length,
                       masked_positions, mlm_labels, nsp_labels):
        mlm_scores, nsp_scores = self.pretrain(
            inputs, token_types, valid_length, masked_positions)
        mlm_lp = F.log_softmax(mlm_scores.astype("float32"), axis=-1)
        nsp_lp = F.log_softmax(nsp_scores.astype("float32"), axis=-1)
        mlm_loss = 0.0 - F.pick(mlm_lp, mlm_labels, axis=-1).mean()
        nsp_loss = 0.0 - F.pick(nsp_lp, nsp_labels, axis=-1).mean()
        return mlm_loss + nsp_loss


def _gather_positions(F, seq, positions):
    """seq (B, L, C), positions (B, M) -> (B, M, C)."""
    B, L, C = seq.shape
    M = positions.shape[1]
    flat = seq.reshape((B * L, C))
    offset = nd.arange(B, ctx=seq.context).reshape((B, 1)) * L
    idx = (positions.astype("float32") + offset).reshape((-1,))
    out = F.take(flat, idx.astype("int32"), axis=0)
    return out.reshape((B, M, C))


class BERTClassifier(HybridBlock):
    """Sentence-pair classification head (GluonNLP ``BERTClassifier``)."""

    def __init__(self, bert: BERTModel, num_classes=2, dropout=0.1,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bert = bert
            self.classifier = nn.HybridSequential()
            self.classifier.add(nn.Dropout(dropout))
            self.classifier.add(nn.Dense(num_classes,
                                         in_units=bert._units))

    def hybrid_forward(self, F, inputs, token_types, valid_length=None):
        _, pooled = self.bert(inputs, token_types, valid_length)
        return self.classifier(pooled)


class BERTForQA(HybridBlock):
    """SQuAD span head (GluonNLP ``BertForQA``): (B, L, 2) start / end
    logits."""

    def __init__(self, bert: BERTModel, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bert = bert
            self.span_classifier = nn.Dense(2, in_units=bert._units,
                                            flatten=False)

    def hybrid_forward(self, F, inputs, token_types, valid_length=None):
        seq, _ = self.bert(inputs, token_types, valid_length)
        return self.span_classifier(seq)                        # (B, L, 2)


_BERT_CONFIGS = {
    "bert_12_768_12": dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
    "bert_24_1024_16": dict(units=1024, hidden_size=4096, num_layers=24,
                            num_heads=16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   dropout=0.1, max_length=512, use_pooler=True, **kwargs):
    if model_name not in _BERT_CONFIGS:
        raise MXNetError(f"unknown bert config {model_name!r}; "
                         f"known: {sorted(_BERT_CONFIGS)}")
    cfg = dict(_BERT_CONFIGS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, dropout=dropout,
                     max_length=max_length, use_pooler=use_pooler, **cfg)


def bert_12_768_12(**kwargs):
    """BERT-base (GluonNLP name)."""
    return get_bert_model("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large (GluonNLP name)."""
    return get_bert_model("bert_24_1024_16", **kwargs)
