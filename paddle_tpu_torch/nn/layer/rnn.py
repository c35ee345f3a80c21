"""RNN layers (the port of ``paddle_tpu/nn/layer/rnn.py``).

A cell is one op over its weights (the reference's gate order and
weight shapes: ``weight_ih`` [G·hidden, input], ``weight_hh`` [G·hidden,
hidden], LSTM gates i, f, g, o; GRU r, z, c); ``RNN`` steps it over time
in a Tensor-level loop, ``BiRNN`` runs a forward and a reversed one,
and ``SimpleRNN`` / ``LSTM`` / ``GRU`` stack layers with the states
sliced and stacked as the reference does.  torch's cuDNN RNN is not
used: its gate layout differs.  ``sequence_length`` is accepted and
ignored, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import Layer, LayerList
from .. import functional as F
from .. import initializer as I
from ...core.tensor import apply_op
from ...tensor import manipulation as M

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        state_shape = shape or self.state_shape
        from ...tensor.creation import full

        def build(s):
            return full([batch] + list(s), init_value,
                        dtype or "float32")
        if isinstance(state_shape, (list, tuple)) and state_shape and \
                isinstance(state_shape[0], (list, tuple)):
            return tuple(build(s) for s in state_shape)
        return build(state_shape)


def _cell_weights(cell, gates, input_size, hidden_size, weight_ih_attr,
                  weight_hh_attr, bias_ih_attr, bias_hh_attr):
    std = 1.0 / np.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    cell.weight_ih = cell.create_parameter(
        [gates * hidden_size, input_size], weight_ih_attr,
        default_initializer=u)
    cell.weight_hh = cell.create_parameter(
        [gates * hidden_size, hidden_size], weight_hh_attr,
        default_initializer=u)
    cell.bias_ih = cell.create_parameter(
        [gates * hidden_size], bias_ih_attr, is_bias=True,
        default_initializer=u)
    cell.bias_hh = cell.create_parameter(
        [gates * hidden_size], bias_hh_attr, is_bias=True,
        default_initializer=u)
    cell.input_size = input_size
    cell.hidden_size = hidden_size


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        _cell_weights(self, 1, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else \
            (lambda v: torch.clamp(v, min=0))
        args = [inputs, states, self.weight_ih, self.weight_hh]
        if self.bias_ih is not None:
            args += [self.bias_ih, self.bias_hh]

        def _f(x, h, wih, whh, *biases):
            z = x @ wih.T + h @ whh.T
            if biases:
                z = z + biases[0] + biases[1]
            return act(z)
        h = apply_op(_f, *args, op_name="simple_rnn_cell")
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None):
        super().__init__()
        _cell_weights(self, 4, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        args = [inputs, h, c, self.weight_ih, self.weight_hh]
        if self.bias_ih is not None:
            args += [self.bias_ih, self.bias_hh]

        def _f(x, h_, c_, wih, whh, *biases):
            z = x @ wih.T + h_ @ whh.T
            if biases:
                z = z + biases[0] + biases[1]
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            new_c = torch.sigmoid(f) * c_ + torch.sigmoid(i) * torch.tanh(g)
            new_h = torch.sigmoid(o) * torch.tanh(new_c)
            return new_h, new_c
        new_h, new_c = apply_op(_f, *args, op_name="lstm_cell")
        return new_h, (new_h, new_c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        _cell_weights(self, 3, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        args = [inputs, states, self.weight_ih, self.weight_hh]
        if self.bias_ih is not None:
            args += [self.bias_ih, self.bias_hh]

        def _f(x, h, wih, whh, *biases):
            zx = x @ wih.T
            zh = h @ whh.T
            if biases:
                zx = zx + biases[0]
                zh = zh + biases[1]
            xr, xz, xc = torch.chunk(zx, 3, dim=-1)
            hr, hz, hc = torch.chunk(zh, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            c = torch.tanh(xc + r * hc)
            return (1 - z) * c + z * h
        new_h = apply_op(_f, *args, op_name="gru_cell")
        return new_h, new_h


class RNN(Layer):
    """Runs a cell over time in a Tensor-level loop (one cell op a
    step)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        states = initial_states
        outputs = []
        idxs = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for i in idxs:
            x_t = M.squeeze(M.slice(inputs, [time_axis], [i], [i + 1]),
                            axis=time_axis)
            out, states = self.cell(x_t, states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return M.stack(outputs, axis=time_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            states_fw = states_bw = None
        else:
            states_fw, states_bw = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return M.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        self.num_directions = bidirect
        cell_cls = {"LSTM": LSTMCell, "GRU": GRUCell}.get(mode,
                                                          SimpleRNNCell)

        def make_cell(in_sz):
            return cell_cls(in_sz, hidden_size,
                            weight_ih_attr=weight_ih_attr,
                            weight_hh_attr=weight_hh_attr,
                            bias_ih_attr=bias_ih_attr,
                            bias_hh_attr=bias_hh_attr)

        self.rnns = LayerList()
        for layer_i in range(num_layers):
            in_sz = input_size if layer_i == 0 else hidden_size * bidirect
            if bidirect == 2:
                self.rnns.append(BiRNN(make_cell(in_sz), make_cell(in_sz),
                                       time_major))
            else:
                self.rnns.append(RNN(make_cell(in_sz),
                                     direction == "backward", time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        out = inputs
        final_states = []
        for i, rnn in enumerate(self.rnns):
            init = None
            if initial_states is not None:
                init = self._slice_states(initial_states, i)
            out, st = rnn(out, init)
            final_states.append(st)
            if self.dropout > 0 and i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        return out, self._stack_states(final_states)

    def _slice_states(self, initial_states, layer_i):
        nd = self.num_directions

        def pick(t, j):
            return M.squeeze(M.slice(t, [0], [j], [j + 1]), axis=0)
        if self.mode == "LSTM":
            h, c = initial_states
            if nd == 2:
                return ((pick(h, 2 * layer_i), pick(c, 2 * layer_i)),
                        (pick(h, 2 * layer_i + 1), pick(c, 2 * layer_i + 1)))
            return (pick(h, layer_i), pick(c, layer_i))
        h = initial_states
        if nd == 2:
            return (pick(h, 2 * layer_i), pick(h, 2 * layer_i + 1))
        return pick(h, layer_i)

    def _stack_states(self, states):
        nd = self.num_directions
        if self.mode == "LSTM":
            hs, cs = [], []
            for st in states:
                pairs = st if nd == 2 else (st,)
                for h, c in pairs:
                    hs.append(h)
                    cs.append(c)
            return M.stack(hs, axis=0), M.stack(cs, axis=0)
        hs = []
        for st in states:
            hs += list(st) if nd == 2 else [st]
        return M.stack(hs, axis=0)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
