"""Multi-layer LSTM encoder + attention decoder (counterpart of
``magnet_tpu/nn/lstm.py``: ``LSTMCellT``, ``LSTM``, ``_AttnDecStep``,
``AttnSeq2Seq``).

The JAX package writes torch's LSTM out in ``jnp`` (gate order i, f, g, o,
all weights and biases U(±1/sqrt(hidden)), the two bias vectors b_ih and
b_hh); the port uses ``nn.LSTM`` itself, which is those semantics and has
the reference's key names (``weight_ih_l{k}``, ``weight_hh_l{k}``,
``bias_ih_l{k}``, ``bias_hh_l{k}``).  The decoder is stepped one step at a
time with its (h, c) of shape (layers, M, H).
"""
from __future__ import annotations

import torch
from torch import nn


class AttnSeq2Seq(nn.Module):
    """Encoder LSTM over (M, T, in_dim) sequences, then ``future_step``
    steps of the attention decoder: each scores every encoder state with
    ``attn`` on (h, c) of the decoder's last layer joined to that state,
    takes the softmax over T, and feeds the previous output joined to the
    weighted sum of encoder states to the decoder LSTM; the first input is
    the last encoder output.

    The three layers are the reference model's own top-level modules
    (``lstm_encoder``, ``lstm_decoder``, ``attn``), so a model that runs
    the seq2seq subclasses this module rather than holding it."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int):
        super().__init__()
        self.lstm_encoder = nn.LSTM(in_dim, hidden, num_layers,
                                    batch_first=True)
        self.lstm_decoder = nn.LSTM(2 * hidden, hidden, num_layers,
                                    batch_first=True)
        self.attn = nn.Sequential(nn.Linear(3 * hidden, hidden), nn.Tanh(),
                                  nn.Linear(hidden, 1, bias=False))

    def attend(self, hidden, enc: torch.Tensor) -> torch.Tensor:
        """The context of one decoder step: ``attn`` scores each encoder
        state of enc (M, T, H) joined to (h, c) of the decoder's last layer
        (``hidden``, each (layers, M, H)); returns the softmax-weighted sum
        of enc over T, (M, 1, H)."""
        h, c = hidden
        hc = torch.cat([h[-1], c[-1]], dim=-1)[:, None]           # (M, 1, 2H)
        scores = self.attn(torch.cat([hc.expand(-1, enc.shape[1], -1), enc],
                                     dim=-1))
        return torch.bmm(torch.softmax(scores, dim=1).transpose(1, 2), enc)

    def forward(self, x: torch.Tensor, future_step: int):
        """x (M, T, in_dim) -> (outputs (M, future_step, H), (h, c) of the
        decoder, each (layers, M, H))."""
        enc, hidden = self.lstm_encoder(x)                       # (M, T, H)
        inp = enc[:, -1:]                                        # (M, 1, H)
        outs = []
        for _ in range(future_step):
            context = self.attend(hidden, enc)
            inp, hidden = self.lstm_decoder(
                torch.cat([inp, context], dim=-1), hidden)
            outs.append(inp)
        return torch.cat(outs, dim=1), hidden
