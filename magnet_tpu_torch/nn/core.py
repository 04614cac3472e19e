"""Core layers (counterpart of ``magnet_tpu/nn/core.py:78-158``).

PyTorch's own ``nn.Linear``, ``nn.Conv1d`` / ``nn.Conv2d`` and
``nn.LayerNorm`` are the
semantics the JAX package reproduces (torch default init U(±1/sqrt(fan_in)),
``padding=k//2``, LayerNorm eps 1e-5 with the variance taken as
E[(x-mu)^2]), so the port uses them directly.  ``MLP`` keeps the
reference's ``layers`` ModuleList (Linear, ReLU, ..., Linear), whose
Linears sit at even indices: that is the state_dict layout
``magnet_tpu/train/import_torch.py`` reads.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def Conv(ndim: int, in_chan: int, out_chan: int, kernel_size: int,
         bias: bool = True) -> nn.Module:
    """``nn.Conv1d`` (``ndim`` 1) or ``nn.Conv2d`` (2) with a square kernel
    and ``padding=k//2``: the JAX package's 'SAME' for odd k."""
    cls = {1: nn.Conv1d, 2: nn.Conv2d}[ndim]
    return cls(in_chan, out_chan, kernel_size, padding=kernel_size // 2,
               bias=bias)


class MLP(nn.Module):
    """Linear + ReLU per hidden width, then a final Linear."""

    def __init__(self, in_dim: int, hidden_list: Sequence[int], out_dim: int):
        super().__init__()
        dims = [in_dim, *hidden_list]
        layers: list[nn.Module] = []
        for a, b in zip(dims[:-1], dims[1:]):
            layers += [nn.Linear(a, b), nn.ReLU()]
        layers.append(nn.Linear(dims[-1], out_dim))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    @property
    def linears(self) -> list[nn.Linear]:
        return [m for m in self.layers if isinstance(m, nn.Linear)]


def init_torch_default(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every parameter with torch's default init from ``generator``:
    U(±1/sqrt(fan_in)) for Linear/Conv weights and biases, ones and zeros
    for LayerNorm, U(±1/sqrt(hidden)) for every LSTM weight and bias (as
    ``nn.LSTM.reset_parameters``); a module with its own ``init_from`` (the
    spectral convolutions) draws its parameters itself."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / fan_in ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LSTM):
                bound = 1.0 / m.hidden_size ** 0.5
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
            elif hasattr(m, "init_from"):
                m.init_from(generator)
