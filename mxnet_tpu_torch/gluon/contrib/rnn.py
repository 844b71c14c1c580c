"""Contrib recurrent cells of the PyTorch port (reference:
``python/mxnet/gluon/contrib/rnn/``; the counterpart of
``mxnet_tpu.gluon.contrib.rnn``): ``VariationalDropoutCell`` (one
dropout mask per sequence, Gal & Ghahramani) and ``Conv2DLSTMCell``
(convolutional state transitions, Shi et al.).
"""
from __future__ import annotations

from ...base import MXNetError
from ... import autograd
from ..cached_op import _TRACING
from ..rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["VariationalDropoutCell", "Conv2DLSTMCell"]


class VariationalDropoutCell(ModifierCell):
    """The same dropout mask at every step of a sequence (reference:
    contrib.rnn.VariationalDropoutCell).  The masks are drawn once per
    sequence (after ``reset()``) from the framework's generator.

    Imperative only: the per-sequence mask is Python state, which a
    CachedOp graph would replay as a constant; under ``hybridize`` the
    cell raises instead, as the JAX package's does."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._mask_in = None
        self._mask_states = None
        self._mask_out = None

    def reset(self):
        super().reset()
        self._mask_in = None
        self._mask_states = None
        self._mask_out = None

    @staticmethod
    def _mask(F, p, like):
        keep = F.random.uniform(0, 1, shape=like.shape,
                                ctx=like.context) >= p
        return keep.astype(like.dtype) / (1 - p)

    def hybrid_forward(self, F, x, *states):
        if _TRACING.get():
            raise MXNetError(
                "VariationalDropoutCell cannot be hybridized: the "
                "per-sequence dropout mask is Python state that a "
                "CachedOp graph would freeze; use the cell imperatively")
        training = autograd.is_training()
        if training and self._drop_inputs:
            if self._mask_in is None:
                self._mask_in = self._mask(F, self._drop_inputs, x)
            x = x * self._mask_in
        if training and self._drop_states:
            if self._mask_states is None:
                self._mask_states = self._mask(F, self._drop_states,
                                               states[0])
            states = (states[0] * self._mask_states,) + tuple(states[1:])
        out, nstates = self.base_cell(x, list(states))
        if training and self._drop_outputs:
            if self._mask_out is None:
                self._mask_out = self._mask(F, self._drop_outputs, out)
            out = out * self._mask_out
        return out, nstates

    def _alias(self):
        return "vardrop"


def _pair(v):
    return v if isinstance(v, tuple) else (v, v)


class Conv2DLSTMCell(HybridRecurrentCell):
    """Convolutional LSTM over NCHW inputs (reference:
    contrib.rnn.Conv2DLSTMCell): the gates are convolutions of the input
    and of the hidden state; the states are feature maps of the i2h
    convolution's output size."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, **kwargs):
        super().__init__(**kwargs)
        c_in, h, w = input_shape
        self._hidden_channels = hidden_channels
        k_i, k_h, pad_i = _pair(i2h_kernel), _pair(h2h_kernel), \
            _pair(i2h_pad)
        if any(k % 2 == 0 for k in k_h):
            raise MXNetError("h2h_kernel must be odd (same-size state)")
        state_h = h + 2 * pad_i[0] - k_i[0] + 1
        state_w = w + 2 * pad_i[1] - k_i[1] + 1
        if state_h < 1 or state_w < 1:
            raise MXNetError(
                f"Conv2DLSTMCell: i2h kernel {k_i} with pad {pad_i} "
                f"leaves no output for input {h}x{w}")
        self._state_shape = (hidden_channels, state_h, state_w)
        self._i2h_kernel, self._h2h_kernel = k_i, k_h
        self._i2h_pad = pad_i
        self._h2h_pad = (k_h[0] // 2, k_h[1] // 2)
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_channels, c_in) + k_i,
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(4 * hidden_channels, hidden_channels) + k_h,
                allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_channels,), init="zeros",
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_channels,), init="zeros",
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NCHW"}] * 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, x, h, c, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.Convolution(x, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=4 * self._hidden_channels)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=4 * self._hidden_channels)
        i, f, g, o = F.split(i2h + h2h, num_outputs=4, axis=1)
        c_new = F.sigmoid(f) * c + F.sigmoid(i) * F.tanh(g)
        h_new = F.sigmoid(o) * F.tanh(c_new)
        return h_new, [h_new, c_new]
