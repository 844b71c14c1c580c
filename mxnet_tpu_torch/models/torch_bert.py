"""BERT as ``torch.nn.Module``\\ s: encoder, model, the MLM + NSP
pretraining head and loss, and the classification head.

The form of ``mxnet_tpu/models/bert.py`` (GluonNLP's
``bert_12_768_12`` / ``bert_24_1024_16``) that serving,
``ShardedTrainer``'s tensor parallelism and the artifact path run; the
Gluon ``HybridBlock`` form under the JAX package's names, with
``BERTForQA``, is :mod:`.bert`.  The internal layout is
(L, B, C) time-major, the layout of the interleaved attention, with (B, L)
int token inputs at the API boundary: ``model(inputs, token_types,
valid_length)``.  ``use_flash=True`` sends each layer's self-attention
through :mod:`mxnet_tpu_torch.ops.flash_attention` (kernels B1-B3 on the
card) with the valid lengths as per-row key lengths; ``use_flash=False``
is the dense path with an additive (B*H, L, L) mask (``_make_mask``).

Every model takes ``device=`` (default ``"cuda"``) and draws its weights
from ``generator`` (a CPU ``torch.Generator``, seed 0 when omitted) by
the JAX package's ``initialize()`` rule: embeddings and positions
N(0, 0.01), dense weights U(-0.07, 0.07), zero biases, unit LayerNorm
gains.  ``load_numpy_params`` takes ``{name: np.ndarray}`` from the JAX
block's ``collect_params()`` with the top block's prefix removed.
``BERTClassifier`` is the sentence-pair classification head that
``serving.ModelRepository.add_block`` serves; the SQuAD span head
``BERTForQA`` is a Gluon block of :mod:`.bert`.

The word and token-type embeddings take their weight gradient as a plain
sorted segment sum (:class:`_SortedSegmentEmbedding`), the same bits on
every run: PyTorch's CUDA embedding backward sums a row that many
positions share in a run-dependent order (on the card the 2-row
token-type table's gradient differed between two backward passes), which
kept fp32 training from resuming bit for bit.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from .torch_blocks import (_META, TransformerEncoderCell, _LayerNorm,
                           _dense_names, _materialize, _scoped,
                           load_gluon_params)

__all__ = ["BERTEncoder", "BERTModel", "BERTClassifier", "BERTForPretrain",
           "BERTPretrainLoss", "pretrain_loss", "bert_12_768_12",
           "bert_24_1024_16", "get_bert_model"]

NEG_INF = -1e9
# the parameters the JAX BERT declares init="normal"
_NORMAL_INIT = ("word_embed.weight", "token_type_embed.weight",
                "position_weight")


class _SortedSegmentEmbedding(torch.autograd.Function):
    """``F.embedding(idx, weight)`` whose weight gradient is a sorted
    segment sum: the output gradient's rows stably sorted by index, each
    table row's run summed in order (``torch.segment_reduce``, fp32) — one
    order on every run, on every device, and no shape that depends on the
    data, so a captured training step replays it."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = weight.shape[0], weight.dtype
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(ctx.rows, dtype=torch.long,
                             device=flat.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        rows = grad.reshape(flat.numel(), -1).index_select(0, order)
        dw = torch.segment_reduce(rows.float(), "sum", lengths=counts,
                                  unsafe=True)
        return dw.to(ctx.dtype), None


def _embed(table, idx):
    """``table(idx)`` (an ``nn.Embedding``) with the sorted-segment-sum
    weight gradient."""
    return _SortedSegmentEmbedding.apply(table.weight, idx.long())


class BERTEncoder(nn.Module):
    """Learned positions + LayerNorm + a stack of post-norm GELU
    :class:`TransformerEncoderCell` layers over (L, B, C)."""

    def __init__(self, units=768, hidden_size=3072, num_layers=12,
                 num_heads=12, dropout=0.1, max_length=512,
                 layer_norm_eps=1e-12, use_flash=False, device="cuda",
                 generator=None):
        super().__init__()
        self._units = units
        self._num_heads = num_heads
        self._max_length = max_length
        self.position_weight = nn.Parameter(
            torch.empty(max_length, units, device=_META))
        self.layer_norm = _LayerNorm(units, layer_norm_eps, _META)
        self.dropout_layer = nn.Dropout(dropout)
        self.transformer_cells = nn.ModuleList(
            TransformerEncoderCell(units, hidden_size, num_heads, dropout,
                                   activation="gelu",
                                   layer_norm_eps=layer_norm_eps,
                                   use_flash=use_flash, device=_META)
            for _ in range(num_layers))
        _materialize(self, device, generator, _NORMAL_INIT)

    def forward(self, x, mask=None, valid_length=None):
        # x: (L, B, C)
        L = x.shape[0]
        x = x + self.position_weight[:L, None]
        x = self.dropout_layer(self.layer_norm(x))
        for cell in self.transformer_cells:
            x = cell(x, mask, valid_length)
        return x

    def gluon_names(self):
        names = {"position_weight": self.position_weight,
                 **_scoped("layernorm0_", self.layer_norm.gluon_names())}
        for i, cell in enumerate(self.transformer_cells):
            names.update(_scoped(f"transformerencodercell{i}_",
                                 cell.gluon_names()))
        return names


class BERTModel(nn.Module):
    """Embeddings + encoder + pooler (GluonNLP ``BERTModel``).

    Call: ``model(inputs, token_types, valid_length)`` with (B, L) int
    tokens and (B,) valid lengths.  Returns ``(sequence_output (B, L, C),
    pooled_output (B, C))``, or the sequence output alone without a
    pooler."""

    def __init__(self, units=768, hidden_size=3072, num_layers=12,
                 num_heads=12, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, dropout=0.1, layer_norm_eps=1e-12,
                 use_pooler=True, use_flash=False, device="cuda",
                 generator=None):
        super().__init__()
        self._units = units
        self._num_heads = num_heads
        self._vocab_size = vocab_size
        self._use_pooler = use_pooler
        self._use_flash = use_flash
        self._tp = None                 # set while bound to a tp group
        self.word_embed = nn.Embedding(vocab_size, units, device=_META)
        self.token_type_embed = nn.Embedding(token_type_vocab_size, units,
                                             device=_META)
        self.encoder = BERTEncoder(units, hidden_size, num_layers, num_heads,
                                   dropout, max_length, layer_norm_eps,
                                   use_flash=use_flash, device=_META)
        if use_pooler:
            self.pooler = nn.Linear(units, units, device=_META)
        _materialize(self, device, generator, _NORMAL_INIT)

    def _make_mask(self, valid_length, L):
        """Additive (B*H, L, L) mask: 0 where key < valid_length, else
        ``NEG_INF``."""
        steps = torch.arange(L, device=valid_length.device)
        keys_ok = (steps[None, :] < valid_length.reshape(-1, 1).float())
        mask = (1.0 - keys_ok.float()) * NEG_INF                 # (B, L)
        B = mask.shape[0]
        return mask.reshape(B, 1, 1, L).expand(
            B, self._num_heads, L, L).reshape(B * self._num_heads, L, L)

    def bind_tensor_parallel(self, tp):
        """The tensor-parallel layout of the embeddings under ``tp``: a
        table split on its units (``P(None, "tp")``) looks up its local
        columns and all-gathers them before the embedding LayerNorm.
        Returns ``(binding, the tables it runs split)``."""
        split, names = [], set()
        for name in ("word_embed", "token_type_embed"):
            weight = getattr(self, name).weight
            spec = tuple(tp.spec_of(weight))
            if spec[:1] not in ((), (None,)):
                raise MXNetError(f"BERTModel: an embedding table split on "
                                 f"its rows ({spec}) is not supported")
            if spec[1:2] == ("tp",):
                split.append(weight)
                names.add(name)
        if not split:
            return None, []
        return (tp, names), split

    def _lookup(self, name, idx):
        emb = _embed(getattr(self, name), idx)
        if self._tp is not None and name in self._tp[1]:
            emb = self._tp[0].gather(emb, -1)
        return emb

    def forward(self, inputs, token_types=None, valid_length=None):
        L = inputs.shape[1]
        emb = self._lookup("word_embed", inputs)
        if token_types is not None:
            emb = emb + self._lookup("token_type_embed", token_types)
        x = emb.transpose(0, 1)                                 # (L, B, C)
        if self._use_flash:
            # padding rides the flash kernels' lengths vector; no O(L^2)
            # mask is ever materialised
            out = self.encoder(x, None, valid_length=valid_length)
        else:
            mask = None
            if valid_length is not None:
                mask = self._make_mask(valid_length, L)
            out = self.encoder(x, mask)
        seq = out.transpose(0, 1)                               # (B, L, C)
        if not self._use_pooler:
            return seq
        return seq, torch.tanh(self.pooler(seq[:, 0]))

    def gluon_names(self):
        names = {"embedding0_weight": self.word_embed.weight,
                 "embedding1_weight": self.token_type_embed.weight,
                 **_scoped("bertencoder0_", self.encoder.gluon_names())}
        if self._use_pooler:
            names.update(_dense_names("dense0_", self.pooler))
        return names

    def load_numpy_params(self, np_params):
        """Load the JAX ``BERTModel``'s parameters: ``{name: array}``
        from its ``collect_params()`` with the ``bertmodel<N>_`` prefix
        removed."""
        load_gluon_params(self.gluon_names(), np_params, "BERTModel")
        return self


class BERTForPretrain(nn.Module):
    """MLM + NSP heads over a :class:`BERTModel` (GluonNLP
    ``BERTForPretrain``).  The heads are drawn from ``generator`` on the
    BERT model's device unless ``device`` says otherwise."""

    def __init__(self, bert: BERTModel, vocab_size=None, device=None,
                 generator=None):
        super().__init__()
        units = bert._units
        self._vocab_size = vocab_size or bert._vocab_size
        self.bert = bert
        self.mlm_dense = nn.Linear(units, units, device=_META)
        self.mlm_norm = _LayerNorm(units, 1e-12, _META)
        self.mlm_decoder = nn.Linear(units, self._vocab_size, device=_META)
        self.nsp_classifier = nn.Linear(units, 2, device=_META)
        self._tp = None                 # set while bound to a tp group
        if device is None:
            device = bert.word_embed.weight.device
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for head in (self.mlm_dense, self.mlm_norm, self.mlm_decoder,
                     self.nsp_classifier):
            _materialize(head, device, generator)

    def bind_tensor_parallel(self, tp):
        """The tensor-parallel layout of the MLM decoder under ``tp``: split
        on the vocabulary (``P("tp", None)``, bias with it), it computes
        its local logits and all-gathers them before the loss (which sees
        full logits, as the JAX ``loss_fn`` does).  Returns ``(binding,
        the parameters it runs split)``."""
        if not tp.column(self.mlm_decoder.weight, self.mlm_decoder.bias):
            return None, []
        return tp, [self.mlm_decoder.weight, self.mlm_decoder.bias]

    def forward(self, inputs, token_types, valid_length, masked_positions):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        gathered = _gather_positions(seq, masked_positions)     # (B, M, C)
        h = self.mlm_norm(F.gelu(self.mlm_dense(gathered)))
        tp = self._tp
        if tp is None:
            mlm_scores = self.mlm_decoder(h)                    # (B, M, V)
        else:
            mlm_scores = tp.gather(self.mlm_decoder(tp.copy(h)), -1)
        nsp_scores = self.nsp_classifier(pooled)                # (B, 2)
        return mlm_scores, nsp_scores

    def gluon_names(self):
        return {**_scoped("bertmodel0_", self.bert.gluon_names()),
                **_dense_names("dense0_", self.mlm_dense),
                **_scoped("layernorm0_", self.mlm_norm.gluon_names()),
                **_dense_names("dense1_", self.mlm_decoder),
                **_dense_names("dense2_", self.nsp_classifier)}

    def load_numpy_params(self, np_params):
        """Load the JAX ``BERTForPretrain``'s parameters: ``{name:
        array}`` from its ``collect_params()`` with the
        ``bertforpretrain<N>_`` prefix removed; the BERT model's own
        parameters keep their ``bertmodel<N>_`` prefix (any N)."""
        np_params = {re.sub(r"^bertmodel\d+_", "bertmodel0_", k): v
                     for k, v in np_params.items()}
        load_gluon_params(self.gluon_names(), np_params, "BERTForPretrain")
        return self


class BERTClassifier(nn.Module):
    """Sentence-pair classification head over a :class:`BERTModel`
    (GluonNLP ``BERTClassifier``): dropout, then a dense layer on the
    pooled output.  Call: ``clf(inputs, token_types, valid_length)`` ->
    (B, num_classes) logits.  The dense layer is drawn from
    ``generator`` on the BERT model's device unless ``device`` says
    otherwise."""

    def __init__(self, bert: BERTModel, num_classes=2, dropout=0.1,
                 device=None, generator=None):
        super().__init__()
        if not bert._use_pooler:
            raise MXNetError("BERTClassifier: the BERT model needs its "
                             "pooler (use_pooler=True)")
        self.bert = bert
        self.dropout = nn.Dropout(dropout)
        self.classifier = nn.Linear(bert._units, num_classes, device=_META)
        if device is None:
            device = bert.word_embed.weight.device
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        _materialize(self.classifier, device, generator)

    def forward(self, inputs, token_types, valid_length=None):
        _, pooled = self.bert(inputs, token_types, valid_length)
        return self.classifier(self.dropout(pooled))

    def gluon_names(self):
        # the JAX head's Dense sits in a HybridSequential after a Dropout
        return {**_scoped("bertmodel0_", self.bert.gluon_names()),
                **_dense_names("dense0_", self.classifier)}

    def load_numpy_params(self, np_params):
        """Load the JAX ``BERTClassifier``'s parameters: ``{name:
        array}`` from its ``collect_params()`` with the
        ``bertclassifier<N>_`` prefix removed; the BERT model's own
        parameters keep their ``bertmodel<N>_`` prefix (any N)."""
        np_params = {re.sub(r"^bertmodel\d+_", "bertmodel0_", k): v
                     for k, v in np_params.items()}
        load_gluon_params(self.gluon_names(), np_params, "BERTClassifier")
        return self


class BERTPretrainLoss(nn.Module):
    """MLM + NSP loss: mean negative log-likelihood of ``mlm_labels`` at
    the masked positions plus that of ``nsp_labels``, in fp32."""

    def __init__(self, pretrain: BERTForPretrain):
        super().__init__()
        self.pretrain = pretrain

    def forward(self, inputs, token_types, valid_length, masked_positions,
                mlm_labels, nsp_labels):
        mlm_scores, nsp_scores = self.pretrain(
            inputs, token_types, valid_length, masked_positions)
        return pretrain_loss((mlm_scores, nsp_scores), mlm_labels,
                             nsp_labels)


def pretrain_loss(outputs, mlm_labels, nsp_labels):
    """The MLM + NSP loss over ``(mlm_scores, nsp_scores)``, the
    ``loss_fn`` a trainer of :class:`BERTForPretrain` takes."""
    mlm_scores, nsp_scores = outputs
    mlm_lp = torch.log_softmax(mlm_scores.float(), dim=-1)
    nsp_lp = torch.log_softmax(nsp_scores.float(), dim=-1)
    mlm_loss = -mlm_lp.gather(-1, mlm_labels.long()[..., None]).mean()
    nsp_loss = -nsp_lp.gather(-1, nsp_labels.long()[..., None]).mean()
    return mlm_loss + nsp_loss


def _gather_positions(seq, positions):
    """seq (B, L, C), positions (B, M) -> (B, M, C)."""
    B, L, C = seq.shape
    offset = torch.arange(B, device=seq.device)[:, None] * L
    idx = (positions.long() + offset).reshape(-1)
    return seq.reshape(B * L, C)[idx].reshape(B, -1, C)


_BERT_CONFIGS = {
    "bert_12_768_12": dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
    "bert_24_1024_16": dict(units=1024, hidden_size=4096, num_layers=24,
                            num_heads=16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   dropout=0.1, max_length=512, use_pooler=True, **kwargs):
    """A :class:`BERTModel` of a named configuration; ``kwargs``
    override its widths and pass ``use_flash``, ``device`` and
    ``generator``."""
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
    """BERT-large (GluonNLP name): 24 layers, 1024 units, 16 heads."""
    return get_bert_model("bert_24_1024_16", **kwargs)
