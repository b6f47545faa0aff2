"""Recurrent models (counterpart of ``hetu_tpu.models.rnn``): LSTM, GRU,
the tanh RNN and a language model over them.

The JAX package's ``lax.scan`` is a loop over the sequence inside one
op's impl here; autograd differentiates through it.  Each layer keeps one
input projection for the whole sequence (``[b, s, i] x [i, gH]``) and one
``[H, gH]`` hidden product a step, with the JAX package's gate layouts:
LSTM ``(i, f, g, o)`` with 1 added to the forget gate, GRU ``(r, z, n)``
with ``r`` gating only the hidden term of ``n``.
"""
from __future__ import annotations

import torch

from ..graph.ctor import (ConstantInitializer, XavierUniformInitializer,
                          parameter)
from ..nn import Embedding, Linear, Module
from ..ops import functional as ops


def _input_gates(x, w_ih, b):
    """All input projections of the sequence in one product: [b, s, gH]."""
    return torch.einsum("bsi,ig->bsg", x, w_ih) + b


class _RecurrentBase(Module):
    """The fused input and hidden projections and the loop over steps."""

    GATES = 1

    def __init__(self, input_size: int, hidden_size: int,
                 name: str = "rnn"):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        g = self.GATES
        self.w_ih = parameter(XavierUniformInitializer(),
                              (input_size, g * hidden_size),
                              name=f"{name}.w_ih")
        self.w_hh = parameter(XavierUniformInitializer(),
                              (hidden_size, g * hidden_size),
                              name=f"{name}.w_hh")
        self.bias = parameter(ConstantInitializer(0.0), (g * hidden_size,),
                              name=f"{name}.bias")

    def _cell(self, carry, gates):
        raise NotImplementedError

    def _init_carry(self, x):
        raise NotImplementedError

    def _scan(self, x, w_ih, w_hh, b, *carry_in):
        xg = _input_gates(x, w_ih, b)
        if carry_in:
            carry = carry_in[0] if len(carry_in) == 1 else tuple(carry_in)
        else:
            carry = self._init_carry(x)
        ys = []
        for t in range(x.shape[1]):
            h = carry[0] if isinstance(carry, tuple) else carry
            carry = self._cell(carry, xg[:, t] + h @ w_hh)
            ys.append(carry[0] if isinstance(carry, tuple) else carry)
        h_final = carry[0] if isinstance(carry, tuple) else carry
        return torch.stack(ys, dim=1), h_final

    def forward(self, x, initial_state=None):
        """x: [batch, seq, input] -> (outputs [batch, seq, hidden], final
        hidden state).  ``initial_state``: the [batch, hidden] hidden state
        (RNN, GRU) or an (h, c) pair (LSTM); zeros when omitted."""
        init_inputs = []
        if initial_state is not None:
            init_inputs = list(initial_state) \
                if isinstance(initial_state, (tuple, list)) \
                else [initial_state]
        return ops._op(f"{type(self).__name__}_scan", self._scan,
                       [x, self.w_ih, self.w_hh, self.bias, *init_inputs],
                       num_outputs=2)


class RNN(_RecurrentBase):
    """Tanh RNN."""

    GATES = 1

    def _cell(self, h, gates):
        return torch.tanh(gates)

    def _init_carry(self, x):
        return x.new_zeros((x.shape[0], self.hidden_size))


class GRU(_RecurrentBase):
    """GRU: the reset gate scales the candidate's hidden term only, so
    the step keeps the hidden product apart from the input gates."""

    GATES = 3

    def _scan(self, x, w_ih, w_hh, b, *carry_in):
        H = self.hidden_size
        xg = _input_gates(x, w_ih, b)
        h = carry_in[0] if carry_in else x.new_zeros((x.shape[0], H))
        ys = []
        for t in range(x.shape[1]):
            xt, hg = xg[:, t], h @ w_hh                  # [b, 3H] each
            r = torch.sigmoid(xt[:, :H] + hg[:, :H])
            z = torch.sigmoid(xt[:, H:2 * H] + hg[:, H:2 * H])
            n = torch.tanh(xt[:, 2 * H:] + r * hg[:, 2 * H:])
            h = (1 - z) * n + z * h
            ys.append(h)
        return torch.stack(ys, dim=1), h

    def forward(self, x, initial_state=None):
        init_inputs = [initial_state] if initial_state is not None else []
        return ops._op("gru_scan", self._scan,
                       [x, self.w_ih, self.w_hh, self.bias, *init_inputs],
                       num_outputs=2)


class LSTM(_RecurrentBase):
    GATES = 4

    def _cell(self, carry, gates):
        h, c = carry
        H = self.hidden_size
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H] + 1.0)     # forget bias 1
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_new = f * c + i * g
        return o * torch.tanh(c_new), c_new

    def _init_carry(self, x):
        z = x.new_zeros((x.shape[0], self.hidden_size))
        return z, z


class RNNLanguageModel(Module):
    """Embedding, a stack of recurrent layers and an LM head."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 cell: str = "lstm", num_layers: int = 1,
                 name: str = "rnnlm"):
        super().__init__()
        cells = {"rnn": RNN, "gru": GRU, "lstm": LSTM}
        self.embed = Embedding(vocab_size, hidden_size)
        self.layers = []
        for li in range(num_layers):
            layer = cells[cell](hidden_size, hidden_size,
                                name=f"{name}.l{li}")
            self.add_module(f"l{li}", layer)
            self.layers.append(layer)
        self.head = Linear(hidden_size, vocab_size)

    def forward(self, input_ids, labels=None):
        x = self.embed(input_ids)
        for layer in self.layers:
            x, _ = layer(x)
        logits = self.head(x)
        if labels is None:
            return logits
        return ops.softmax_cross_entropy(logits, labels)
