"""Fused recurrent layers of the PyTorch port (reference:
``python/mxnet/gluon/rnn/rnn_layer.py``).

The counterpart of ``mxnet_tpu.gluon.rnn.rnn_layer``: parameters are
kept per layer and direction, under the reference's names
(``l0_i2h_weight`` ... ``r0_h2h_bias``), and packed at each forward
into the flat cuDNN-layout vector of the ``RNN`` op (``ops/nn.py``:
every weight, layer major and direction minor, then every bias in the
same order).  Hybridized, a layer runs as one CachedOp graph per
signature; the op's inter-layer dropout draws from the device's
default generator, so each replay draws new masks.
"""
from __future__ import annotations

from ...base import MXNetError
from ... import ndarray as nd
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"bad layout {layout!r}")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for d in self._dirs():
                    for name, shape, init in (
                            ("i2h_weight", (ng * nh, ni),
                             i2h_weight_initializer),
                            ("h2h_weight", (ng * nh, nh),
                             h2h_weight_initializer),
                            ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                            ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                        setattr(self, f"{d}{i}_{name}", self.params.get(
                            f"{d}{i}_{name}", shape=shape, init=init,
                            allow_deferred_init=True))
                ni = nh * self._dir

    def _dirs(self):
        return ["l", "r"] if self._dir == 2 else ["l"]

    def _param_names(self):
        """The flat vector's order: weights, then biases."""
        weights, biases = [], []
        for i in range(self._num_layers):
            for d in self._dirs():
                weights += [f"{d}{i}_i2h_weight", f"{d}{i}_h2h_weight"]
                biases += [f"{d}{i}_i2h_bias", f"{d}{i}_h2h_bias"]
        return weights + biases

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"}] * n

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """Initial hidden state(s) (reference: _RNNLayer.begin_state)."""
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def infer_shape(self, x, *args):
        nh, ng = self._hidden_size, self._gates
        cur = x.shape[2]
        for i in range(self._num_layers):
            for d in self._dirs():
                getattr(self, f"{d}{i}_i2h_weight").shape = (ng * nh, cur)
            cur = nh * self._dir
        self._input_size = x.shape[2]

    def __call__(self, inputs, states=None, **kwargs):
        """``layer(x)`` returns the output; ``layer(x, states)`` returns
        ``(output, new_states)`` (reference rule)."""
        skip_states = states is None
        if skip_states:
            batch = inputs.shape[self._layout.index("N")]
            states = self.begin_state(batch, ctx=inputs.context)
        elif isinstance(states, NDArray):
            states = [states]
        out = super().__call__(inputs, *states, **kwargs)
        if skip_states:
            return out[0]
        return out[0], list(out[1:])

    def hybrid_forward(self, F, x, *states, **params):
        if self._layout == "NTC":
            x = x.swapaxes(0, 1)
        flat = F.concat(*[params[n].reshape((-1,))
                          for n in self._param_names()], dim=0)
        outs = F.RNN(x, flat, *states[:2 if self._mode == "lstm" else 1],
                     state_size=self._hidden_size,
                     num_layers=self._num_layers, mode=self._mode,
                     bidirectional=self._dir == 2, p=self._dropout,
                     state_outputs=True)
        out = outs[0]
        if self._layout == "NTC":
            out = out.swapaxes(0, 1)
        return (out,) + tuple(outs[1:])

    def __repr__(self):
        return f"{type(self).__name__}({self._hidden_size}, " \
               f"layers={self._num_layers}, bidirectional={self._dir == 2})"


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, relu or tanh (reference: rnn_layer.RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer (bidirectional) LSTM (reference: rnn_layer.LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer (bidirectional) GRU (reference: rnn_layer.GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
