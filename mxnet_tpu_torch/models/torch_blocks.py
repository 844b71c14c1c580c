"""The encoder blocks as ``torch.nn.Module``\\ s: the form that serving,
``ShardedTrainer``'s tensor parallelism and the paged decoder run.

:class:`PositionwiseFFN`, :class:`MultiHeadSelfAttention` and
:class:`TransformerEncoderCell` carry the JAX blocks' submodule names
(``qkv``, ``out_proj``, ``attn_norm``, ``ffn.ffn_1``, ...), the JAX
(L, B, C) time-major layout at ``forward`` and the interleaved per-head
``[q|k|v]`` projection.  ``use_flash=True`` routes self-attention to
:mod:`mxnet_tpu_torch.ops.flash_attention` (kernels B1-B3 on CUDA
tensors); the dense path is plain torch matmuls + softmax with an
additive mask, as the JAX package computes it outside any kernel.
:mod:`.torch_bert` builds BERT from them and
:class:`~.transformer_blocks.TransformerDecoderLM` its cells.  The
Gluon ``HybridBlock`` forms under the JAX package's names are in
:mod:`.transformer_blocks`.

Blocks built on ``device="meta"`` stay unmaterialised (a parent model
materialises and draws them once); on any other device a block draws
its weights from ``generator`` (a CPU ``torch.Generator``, seed 0 when
omitted) by the JAX package's ``initialize()`` rule (:func:`init_params`).
``gluon_names()`` maps each block's parameters to the names of the JAX
block's ``collect_params()`` below the block's own prefix, which is how
weights are carried across between the two packages
(:func:`load_gluon_params`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from ..ops.flash_attention import (_merge_heads, _split_qkv, flash_selfatt,
                                   flash_selfatt_nomask)

__all__ = ["PositionwiseFFN", "MultiHeadSelfAttention",
           "TransformerEncoderCell", "NEG_INF", "init_params",
           "load_gluon_params"]


def _sinusoid_table(max_len, units):
    """Shared sinusoidal position table (the JAX package's formula)."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(units)[None, :]
    angle = pos / np.power(10000, (2 * (dim // 2)) / units)
    table = np.zeros((max_len, units), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


NEG_INF = -1e9
_META = torch.device("meta")


# ---------------------------------------------------------------------------
# weights: the JAX package's initialize() rule and its parameter names
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_params(module, generator=None, normal=()):
    """Draw every parameter of ``module`` as the JAX package's
    ``initialize()`` does with its default initializer: names ending in
    ``gamma`` -> 1, in ``beta`` or ``bias`` -> 0, in one of ``normal``
    (the parameters declared ``init="normal"``) -> N(0, 0.01), every
    other weight -> U(-0.07, 0.07).  Values are drawn on the CPU from
    ``generator`` (seed 0 when omitted), in ``named_parameters`` order."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    normal = tuple(normal)
    for name, p in module.named_parameters():
        if name.endswith("gamma"):
            val = torch.ones(p.shape)
        elif name.endswith(("beta", "bias")):
            val = torch.zeros(p.shape)
        elif normal and name.endswith(normal):
            val = torch.empty(p.shape).normal_(0.0, 0.01,
                                               generator=generator)
        else:
            val = torch.empty(p.shape).uniform_(-0.07, 0.07,
                                                generator=generator)
        p.copy_(val)


def _materialize(module, device, generator, normal=()):
    """Allocate a module built on the meta device on ``device`` and draw
    its weights (:func:`init_params`); a no-op for ``device="meta"``."""
    device = torch.device(device)
    if device.type == "meta":
        return module
    module.to_empty(device=device)
    init_params(module, generator, normal)
    return module


def _dense_names(prefix, layer):
    return {f"{prefix}weight": layer.weight, f"{prefix}bias": layer.bias}


def _scoped(prefix, names):
    return {prefix + k: v for k, v in names.items()}


@torch.no_grad()
def load_gluon_params(names, np_params, who):
    """Copy ``{gluon name: np.ndarray}`` into the tensors of ``names``
    (a block's :meth:`gluon_names`).  Raises :class:`MXNetError` on a
    missing or unknown name or a wrong shape."""
    missing = sorted(set(names) - set(np_params))
    extra = sorted(set(np_params) - set(names))
    if missing or extra:
        raise MXNetError(f"{who}.load_numpy_params: missing {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}, unknown "
                         f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
    for name, p in names.items():
        a = np.asarray(np_params[name])
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"{who}.load_numpy_params: {name!r} has shape "
                             f"{tuple(a.shape)}, want {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, np.float32)).to(p.dtype))


# ---------------------------------------------------------------------------
# encoder blocks
# ---------------------------------------------------------------------------
class _LayerNorm(nn.Module):
    """LayerNorm over the last axis with the Gluon parameter names
    ``gamma`` / ``beta``."""

    def __init__(self, units, eps, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(units, device=device))
        self.beta = nn.Parameter(torch.empty(units, device=device))
        self.eps = eps

    def forward(self, x):
        return _f_ln(x, self.gamma, self.beta, self.eps)

    def gluon_names(self):
        return {"gamma": self.gamma, "beta": self.beta}


_ACTIVATIONS = ("relu", "gelu", "gelu_erf", "gelu_tanh")


def _f_act(x, activation):
    if activation == "relu":
        return F.relu(x)
    if activation in ("gelu", "gelu_erf"):
        return F.gelu(x, approximate="none")
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise MXNetError(f"unsupported activation {activation!r}; known: "
                     f"{_ACTIVATIONS}")


class PositionwiseFFN(nn.Module):
    """FFN(x) = W2 act(W1 x) with residual + LayerNorm (post-norm, the
    BERT layout) or LayerNorm first (``pre_norm=True``).  ``gelu`` is
    the erf GELU, ``gelu_tanh`` its tanh approximation."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 layer_norm_eps=1e-5, pre_norm=False, device="cuda",
                 generator=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise MXNetError(f"unsupported activation {activation!r}; "
                             f"known: {_ACTIVATIONS}")
        self._pre_norm = pre_norm
        self._activation = activation
        self._tp = None                 # set while bound to a tp group
        self.ffn_1 = nn.Linear(units, hidden_size, device=_META)
        self.ffn_2 = nn.Linear(hidden_size, units, device=_META)
        self.layer_norm = _LayerNorm(units, layer_norm_eps, _META)
        self.dropout_layer = nn.Dropout(dropout)
        _materialize(self, device, generator)

    def bind_tensor_parallel(self, tp):
        """The tensor-parallel layout of this block under ``tp`` (a
        ``parallel.sharding.TensorParallel``): ``(tp, the parameters it
        runs split)`` when ``ffn_1`` is column- and ``ffn_2``
        row-parallel, ``(None, [])`` when both are replicated; any other
        placement raises."""
        col = tp.column(self.ffn_1.weight, self.ffn_1.bias)
        row = tp.row(self.ffn_2.weight, self.ffn_2.bias)
        if col != row:
            raise MXNetError("PositionwiseFFN: tensor parallelism needs "
                             "ffn_1 column-parallel and ffn_2 row-parallel "
                             "together")
        if not col:
            return None, []
        return tp, [self.ffn_1.weight, self.ffn_1.bias, self.ffn_2.weight]

    def forward(self, x):
        residual = x
        if self._pre_norm:
            x = self.layer_norm(x)
        tp = self._tp
        if tp is None:
            out = self.ffn_2(_f_act(self.ffn_1(x), self._activation))
        else:
            # ffn_1 holds this rank's hidden units, ffn_2 the matching
            # input columns: the partial products sum over the tp group
            h = _f_act(self.ffn_1(tp.copy(x)), self._activation)
            out = tp.reduce(F.linear(h, self.ffn_2.weight)) \
                + self.ffn_2.bias
        out = self.dropout_layer(out) + residual
        if not self._pre_norm:
            out = self.layer_norm(out)
        return out

    def gluon_names(self):
        return {**_dense_names("ffn_1_", self.ffn_1),
                **_dense_names("ffn_2_", self.ffn_2),
                **_scoped("layernorm0_", self.layer_norm.gluon_names())}


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over (L, B, C) through an interleaved per-head
    ``[q|k|v]`` projection.

    ``use_flash=True`` routes the qk -> softmax -> valatt chain to flash
    attention whenever the mask is expressible as key valid-lengths (+
    optional causal / sliding window), i.e. ``mask is None``; the flash
    path applies dropout to the attention OUTPUT (the score matrix never
    materialises).  The dense path adds an explicit additive ``mask``
    (broadcastable to (B*H, L, L)) to the scores and applies dropout to
    the probabilities."""

    def __init__(self, units, num_heads, dropout=0.0, use_flash=False,
                 causal=False, window=None, device="cuda", generator=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        if causal and not use_flash:
            raise MXNetError(
                "causal=True requires use_flash=True; on the dense path "
                "pass an explicit additive causal mask instead")
        if window is not None:
            if not (use_flash and causal):
                raise MXNetError(
                    "window (sliding-window attention) requires "
                    "use_flash=True and causal=True")
            if int(window) < 1:
                raise MXNetError(f"window must be >= 1, got {window}")
        self._units = units
        self._heads = num_heads
        self._use_flash = use_flash
        self._causal = causal
        self._window = -1 if window is None else int(window)
        self._tp = None                 # set while bound to a tp group
        self.qkv = nn.Linear(units, 3 * units, device=_META)
        self.out_proj = nn.Linear(units, units, device=_META)
        self.dropout_layer = nn.Dropout(dropout)
        _materialize(self, device, generator)

    def bind_tensor_parallel(self, tp):
        """The tensor-parallel layout of this block under ``tp`` (a
        ``parallel.sharding.TensorParallel``): ``(tp, the parameters it
        runs split)`` when ``qkv`` is column- and ``out_proj``
        row-parallel — the interleaved ``[q|k|v]`` rows give each rank
        ``heads / tp.size`` whole heads — ``(None, [])`` when both are
        replicated; any other placement raises."""
        col = tp.column(self.qkv.weight, self.qkv.bias)
        row = tp.row(self.out_proj.weight, self.out_proj.bias)
        if col != row:
            raise MXNetError("MultiHeadSelfAttention: tensor parallelism "
                             "needs qkv column-parallel and out_proj "
                             "row-parallel together")
        if col and self._heads % tp.size:
            raise MXNetError(f"MultiHeadSelfAttention: {self._heads} heads "
                             f"do not split over tp={tp.size}")
        if not col:
            return None, []
        return tp, [self.qkv.weight, self.qkv.bias, self.out_proj.weight]

    def _project_out(self, out):
        tp = self._tp
        if tp is None:
            return self.out_proj(out)
        return tp.reduce(F.linear(out, self.out_proj.weight)) \
            + self.out_proj.bias

    def forward(self, x, mask=None, valid_length=None):
        # x: (L, B, C); qkv: (L, B, 3C) interleaved per head [q|k|v]; a
        # tp rank holds heads / tp of them, whole
        tp = self._tp
        heads = self._heads if tp is None else self._heads // tp.size
        qkv = self.qkv(x if tp is None else tp.copy(x))
        if self._use_flash and mask is None:
            if valid_length is None:
                out = flash_selfatt_nomask(qkv, heads=heads,
                                           causal=self._causal,
                                           window=self._window)
            else:
                out = flash_selfatt(qkv, valid_length, heads=heads,
                                    causal=self._causal,
                                    window=self._window)
            return self._project_out(self.dropout_layer(out))
        if self._window > 0:
            raise MXNetError(
                "window (sliding-window attention) is only honored on "
                "the flash path (mask=None); passing an explicit mask "
                "would silently drop the window — fold the window into "
                "the mask instead")
        if valid_length is not None:
            raise MXNetError(
                "valid_length is only consumed by the flash path "
                "(use_flash=True, mask=None); the dense path needs an "
                "explicit additive mask — it would otherwise be silently "
                "ignored")
        L, B, _ = qkv.shape
        q, k, v = _split_qkv(qkv, heads)                    # (B*H, L, D)
        scores = torch.bmm(q * (1.0 / math.sqrt(q.shape[-1])),
                           k.transpose(1, 2))               # (B*H, L, L)
        if mask is not None:
            if tp is not None and mask.dim() == 3 \
                    and mask.shape[0] == B * self._heads:
                # a (B*H, L, L) mask: this rank's heads of each row
                mask = mask.reshape(B, self._heads, *mask.shape[1:]) \
                    .narrow(1, tp.rank * heads, heads) \
                    .reshape(B * heads, *mask.shape[1:])
            scores = scores + mask
        att = self.dropout_layer(torch.softmax(scores, dim=-1))
        out = torch.bmm(att.to(v.dtype), v)
        return self._project_out(_merge_heads(out, L, B, heads))

    def gluon_names(self):
        return {**_dense_names("qkv_", self.qkv),
                **_dense_names("out_proj_", self.out_proj)}


class TransformerEncoderCell(nn.Module):
    """Transformer encoder layer: post-norm (the BERT layout) or
    pre-norm (``pre_norm=True``, the GPT layout of the LM)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="gelu", layer_norm_eps=1e-5, pre_norm=False,
                 use_flash=False, device="cuda", generator=None):
        super().__init__()
        self._pre_norm = pre_norm
        self.attention = MultiHeadSelfAttention(units, num_heads, dropout,
                                                use_flash=use_flash,
                                                device=_META)
        self.attn_norm = _LayerNorm(units, layer_norm_eps, _META)
        self.dropout_layer = nn.Dropout(dropout)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, activation,
                                   layer_norm_eps, pre_norm, device=_META)
        _materialize(self, device, generator)

    def forward(self, x, mask=None, valid_length=None):
        residual = x
        h = self.attn_norm(x) if self._pre_norm else x
        h = self.attention(h, mask, valid_length)
        h = self.dropout_layer(h) + residual
        if not self._pre_norm:
            h = self.attn_norm(h)
        return self.ffn(h)

    def gluon_names(self):
        return {**_scoped("multiheadselfattention0_",
                          self.attention.gluon_names()),
                **_scoped("layernorm0_", self.attn_norm.gluon_names()),
                **_scoped("positionwiseffn0_", self.ffn.gluon_names())}


def _f_ln(x, gamma, beta, eps=1e-5):
    return F.layer_norm(x, gamma.shape, gamma, beta, eps)
