"""Core layers (counterpart of ``magnet_tpu/nn/core.py:78-158``).

PyTorch's own ``nn.Linear``, ``nn.Conv1d`` / ``nn.Conv2d`` and
``nn.LayerNorm`` are the
semantics the JAX package reproduces (torch default init U(±1/sqrt(fan_in)),
``padding=k//2``, LayerNorm eps 1e-5 with the variance taken as
E[(x-mu)^2]), so the port uses them directly.  ``MLP`` keeps the
reference's ``layers`` ModuleList (Linear, ReLU, ..., Linear), whose
Linears sit at even indices: that is the state_dict layout
``magnet_tpu/train/import_torch.py`` reads.

``MLP`` and ``LayerNorm`` take a compute ``dtype`` (None: f32) with the
semantics of flax's ``Dense(dtype=...)`` and ``LayerNorm(dtype=...)``, as
the JAX package's ``Linear`` and ``LayerNorm`` use them: the parameters
stay f32 and are rounded where they are used; a Dense layer takes its
input and weight in ``dtype`` and gives its product, and then the product
plus the bias, in ``dtype``; a LayerNorm takes its statistics in f32
(two-pass variance) and rounds its result to ``dtype``.
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


def dense(x: torch.Tensor, linear: nn.Linear, dtype=None) -> torch.Tensor:
    """``linear`` applied to x in compute dtype ``dtype`` (None: f32, the
    Linear itself) as flax's ``Dense(dtype=...)``: operands rounded to
    ``dtype``, the product in ``dtype``, then the bias added in ``dtype``."""
    if dtype is None:
        return linear(x)
    y = x.to(dtype) @ linear.weight.to(dtype).t()
    return y if linear.bias is None else y + linear.bias.to(dtype)


class MLP(nn.Module):
    """Linear + ReLU per hidden width, then a final Linear, in compute
    ``dtype`` (see ``dense``)."""

    def __init__(self, in_dim: int, hidden_list: Sequence[int], out_dim: int,
                 dtype=None):
        super().__init__()
        dims = [in_dim, *hidden_list]
        layers: list[nn.Module] = []
        for a, b in zip(dims[:-1], dims[1:]):
            layers += [nn.Linear(a, b), nn.ReLU()]
        layers.append(nn.Linear(dims[-1], out_dim))
        self.layers = nn.ModuleList(layers)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = (dense(x, layer, self.dtype) if isinstance(layer, nn.Linear)
                 else layer(x))
        return x

    @property
    def linears(self) -> list[nn.Linear]:
        return [m for m in self.layers if isinstance(m, nn.Linear)]


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5, affine) in compute ``dtype``: None is
    ``nn.LayerNorm`` itself; otherwise flax's ``LayerNorm(dtype=...)``:
    mean and two-pass variance of the input in f32, (x - mean) times
    rsqrt(var + eps) * weight, plus bias, in f32, rounded to ``dtype``."""

    def __init__(self, width: int, dtype=None):
        super().__init__(width)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
        y = (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


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
