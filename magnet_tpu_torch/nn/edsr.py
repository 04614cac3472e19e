"""EDSR backbone without upsampling, 1D or 2D (counterpart of
``magnet_tpu/nn/edsr.py:21-70``), channels-first as torch's Conv1d and
Conv2d (the JAX package's is feature-last).

The reference builds ``ResBlock(n_chan, kernel_size, res_scale, mode=...)``
positionally, so ``res_scale`` lands in the block's ``bias`` argument and
the block's own res_scale stays 1.  That written behaviour is kept: the
convolutions of a block have a bias iff ``res_scale`` is non-zero.
"""
from __future__ import annotations

import torch
from torch import nn

from magnet_tpu_torch.nn.core import Conv


class ResBlock(nn.Module):
    def __init__(self, n_chan: int, kernel_size: int, bias: bool = True,
                 ndim: int = 1):
        super().__init__()
        self.conv_1 = Conv(ndim, n_chan, n_chan, kernel_size, bias=bias)
        self.conv_2 = Conv(ndim, n_chan, n_chan, kernel_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_2(torch.relu(self.conv_1(x))) + x


class EDSR(nn.Module):
    """x (B, C_in, L) -> (B, n_chan, L), or with ``ndim=2`` x (B, C_in, H,
    W) -> (B, n_chan, H, W)."""

    def __init__(self, in_chan: int, n_chan: int = 64, res_layers: int = 16,
                 kernel_size: int = 3, res_scale: float = 1.0, ndim: int = 1):
        super().__init__()
        self.head_conv = Conv(ndim, in_chan, n_chan, kernel_size)
        self.res_layers = nn.ModuleList(
            ResBlock(n_chan, kernel_size, bias=bool(res_scale), ndim=ndim)
            for _ in range(res_layers))
        self.tail_conv = Conv(ndim, n_chan, n_chan, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head_conv(x)
        res = x
        for block in self.res_layers:
            res = block(res)
        return self.tail_conv(res) + x
