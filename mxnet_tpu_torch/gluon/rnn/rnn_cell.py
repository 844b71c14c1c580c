"""Recurrent cells of the PyTorch port (reference:
``python/mxnet/gluon/rnn/rnn_cell.py``).

The counterpart of ``mxnet_tpu.gluon.rnn.rnn_cell``: a cell is one time
step; ``unroll`` runs it as a Python loop over the sequence, with
``valid_length`` masking each sample's outputs past its length.  A
hybridized cell runs each step through its CachedOp (one graph per
step signature); the fused layers of ``rnn_layer.py`` are the fast
path.
"""
from __future__ import annotations

from ...base import MXNetError
from ... import autograd
from ... import ndarray as nd
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _format_sequence(length, inputs, layout, merge):
    """Split a TNC / NTC sequence into steps, or stack steps into one
    (reference: rnn_cell._format_sequence)."""
    t_axis = layout.index("T")
    batch_axis = layout.index("N")
    if isinstance(inputs, NDArray):
        if length is None:
            length = inputs.shape[t_axis]
        seq = [inputs.slice_axis(axis=t_axis, begin=i, end=i + 1)
               .squeeze(axis=t_axis) for i in range(length)]
    else:
        seq = list(inputs)
    if merge:
        return nd.op.stack(*seq, axis=t_axis), t_axis, batch_axis, len(seq)
    return seq, t_axis, batch_axis, len(seq)


def _mask_steps(outputs, layout, valid_length):
    """The stacked outputs, zero past each sample's ``valid_length``."""
    stacked = nd.op.stack(*outputs, axis=layout.index("T"))
    tnc = stacked.swapaxes(0, 1) if layout == "NTC" else stacked
    masked = nd.op.sequence_mask(tnc, valid_length,
                                 use_sequence_length=True, axis=0)
    return masked.swapaxes(0, 1) if layout == "NTC" else masked


def _gate_params(block, gates, hidden_size, input_size, inits):
    """The i2h / h2h weights and biases of a gated cell."""
    i2h_w, h2h_w, i2h_b, h2h_b = inits
    with block.name_scope():
        block.i2h_weight = block.params.get(
            "i2h_weight", shape=(gates * hidden_size, input_size),
            init=i2h_w, allow_deferred_init=True)
        block.h2h_weight = block.params.get(
            "h2h_weight", shape=(gates * hidden_size, hidden_size),
            init=h2h_w, allow_deferred_init=True)
        block.i2h_bias = block.params.get(
            "i2h_bias", shape=(gates * hidden_size,), init=i2h_b,
            allow_deferred_init=True)
        block.h2h_bias = block.params.get(
            "h2h_bias", shape=(gates * hidden_size,), init=h2h_b,
            allow_deferred_init=True)


class RecurrentCell(HybridBlock):
    """Base recurrent cell (reference: RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        if self._modified:
            raise MXNetError("cannot call begin_state on a modified cell "
                             "(e.g. Zoneout); call on the base cell")
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(shape=info["shape"], **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps (reference: RecurrentCell.unroll)."""
        self.reset()
        seq, _t_axis, _b_axis, length = _format_sequence(
            length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(seq[0].shape[0],
                                           ctx=seq[0].context)
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = _mask_steps(outputs, layout, valid_length)
            if merge_outputs is not False:
                return stacked, states
            outputs, _, _, _ = _format_sequence(length, stacked, layout,
                                                False)
        if merge_outputs is None or merge_outputs:
            merged, _, _, _ = _format_sequence(length, outputs, layout, True)
            return merged, states
        return outputs, states

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        if isinstance(states, NDArray):
            states = [states]
        return super().__call__(inputs, *states, **kwargs)


class HybridRecurrentCell(RecurrentCell):
    pass


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell (reference: RNNCell)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        _gate_params(self, 1, hidden_size, input_size,
                     (i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, h, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(h, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order i, f, g, o (reference: LSTMCell)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        _gate_params(self, 4, hidden_size, input_size,
                     (i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * 2

    def _alias(self):
        return "lstm"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, h, c, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        H = self._hidden_size
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=4 * H)
        h2h = F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=4 * H)
        i, f, g, o = F.split(i2h + h2h, num_outputs=4, axis=-1)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        c_new = f * c + i * F.tanh(g)
        h_new = o * F.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order r, z, n (reference: GRUCell)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        _gate_params(self, 3, hidden_size, input_size,
                     (i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, x, h, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        H = self._hidden_size
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=3 * H)
        h2h = F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=3 * H)
        ir, iz, inn = F.split(i2h, num_outputs=3, axis=-1)
        hr, hz, hn = F.split(h2h, num_outputs=3, axis=-1)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = F.tanh(inn + r * hn)
        h_new = (1 - z) * n + z * h
        return h_new, [h_new]


class SequentialRNNCell(RecurrentCell):
    """Stacked cells, stepped together (reference: SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        states = []
        for cell in self._children.values():
            states.extend(cell.begin_state(batch_size, func, **kwargs))
        return states

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        if isinstance(states, NDArray):
            states = [states]
        next_states, p = [], 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, *args, **kwargs):
        raise MXNetError("SequentialRNNCell is called step-wise, not via "
                         "forward")


class DropoutCell(HybridRecurrentCell):
    """Dropout on each step's input (reference: DropoutCell)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, x):
        if self._rate > 0 and autograd.is_training():
            x = F.Dropout(x, p=self._rate, axes=self._axes)
        return x, []

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        out = HybridBlock.__call__(self, inputs)
        return out[0], states


class ModifierCell(HybridRecurrentCell):
    """Base of the cells that wrap another cell (reference:
    ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + self._alias() + "_")
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularisation (reference: ZoneoutCell); its masks come
    from the framework's generator (``mx.random.seed``)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        next_output, next_states = self.base_cell(inputs, states)
        if not autograd.is_training():
            return next_output, next_states

        def mask(p, like):
            u = nd.random.uniform(0.0, 1.0, shape=like.shape,
                                  ctx=like.context)
            return (u >= p).astype("float32")

        prev = self._prev_output
        if prev is None:
            prev = nd.zeros(next_output.shape, ctx=next_output.context)
        output = next_output
        if self.zoneout_outputs > 0.:
            m = mask(self.zoneout_outputs, next_output)
            output = m * next_output + (1 - m) * prev
        new_states = next_states
        if self.zoneout_states > 0.:
            new_states = []
            for new_s, old_s in zip(next_states, states):
                m = mask(self.zoneout_states, new_s)
                new_states.append(m * new_s + (1 - m) * old_s)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds the input to the cell's output (reference: ResidualCell)."""

    def _alias(self):
        return "residual"

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence, one each way (reference:
    BidirectionalCell); only ``unroll`` runs it."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll()")

    def state_info(self, batch_size=0):
        l, r = self._children["l_cell"], self._children["r_cell"]
        return l.state_info(batch_size) + r.state_info(batch_size)

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        l, r = self._children["l_cell"], self._children["r_cell"]
        return l.begin_state(batch_size, func, **kwargs) + \
            r.begin_state(batch_size, func, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        seq, _t_axis, _b_axis, length = _format_sequence(length, inputs,
                                                         layout, False)
        l_cell = self._children["l_cell"]
        r_cell = self._children["r_cell"]
        if begin_state is None:
            begin_state = self.begin_state(seq[0].shape[0],
                                           ctx=seq[0].context)

        def _rev(frames):
            """With ``valid_length`` each sample is reversed within its
            valid steps only (SequenceReverse), so the backward cell
            never reads padding before the sample's data."""
            if valid_length is None:
                return list(reversed(frames))
            rev = nd.op.sequence_reverse(nd.op.stack(*frames, axis=0),
                                         valid_length,
                                         use_sequence_length=True)
            return [rev[i] for i in range(len(frames))]

        nl = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(
            length, seq, begin_state[:nl], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_out, r_states = r_cell.unroll(
            length, _rev(seq), begin_state[nl:], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        outputs = [nd.op.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_out, _rev(r_out))]
        states = list(l_states) + list(r_states)
        if merge_outputs is None or merge_outputs:
            merged, _, _, _ = _format_sequence(length, outputs, layout, True)
            return merged, states
        return outputs, states
