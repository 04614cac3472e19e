"""Spectral convolutions of the FNO baselines (counterpart of
``magnet_tpu/nn/spectral.py:36-115``): an FFT over the space axes, a
complex channel mix of the lowest modes, and the inverse FFT with the
input's lengths.

The complex weights are ``torch.cfloat`` parameters under the reference's
names (``weights`` in 1D; ``weights1``, ``weights2`` in 2D) and shapes
(in, out, modes...), drawn as ``scale * torch.rand(dtype=cfloat)``: real
and imaginary parts each U(0, 1) times 1 / (in * out).  The JAX package
keeps each as a real/imaginary pair of float32 leaves.
"""
from __future__ import annotations

import torch
from torch import nn


class _Spectral(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, modes: tuple,
                 names: tuple):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.scale = 1.0 / (in_channels * out_channels)
        for name in names:
            self.register_parameter(name, nn.Parameter(
                torch.empty(in_channels, out_channels, *modes,
                            dtype=torch.cfloat)))

    def init_from(self, generator: torch.Generator) -> None:
        """Redraw the weights from ``generator`` (the reference's init)."""
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(self.scale * torch.rand(p.shape, dtype=p.dtype,
                                                generator=generator))


class SpectralConv1d(_Spectral):
    """rfft -> per-mode complex channel mix of the lowest ``modes`` modes
    -> irfft.  Input (B, C, L), output (B, out, L)."""

    def __init__(self, in_channels: int, out_channels: int, modes: int):
        super().__init__(in_channels, out_channels, (modes,), ("weights",))
        self.modes = modes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[-1]
        x_ft = torch.fft.rfft(x, n=L)                          # (B, C, L//2+1)
        out = torch.einsum("bix,iox->box", x_ft[:, :, :self.modes],
                           self.weights)
        out = nn.functional.pad(out, (0, L // 2 + 1 - self.modes))
        return torch.fft.irfft(out, n=L)


class SpectralConv2d(_Spectral):
    """The 2D variant: the ``modes1`` x ``modes2`` corner blocks of the
    lowest positive (``weights1``) and negative (``weights2``) first-axis
    modes, every other mode zero.  Input (B, C, H, W) with H >= 2 modes1,
    output (B, out, H, W)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int):
        super().__init__(in_channels, out_channels, (modes1, modes2),
                         ("weights1", "weights2"))
        self.modes1, self.modes2 = modes1, modes2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        m1, m2 = self.modes1, self.modes2
        x_ft = torch.fft.rfft2(x, s=(H, W))                    # (B,C,H,W//2+1)
        top = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, :m1, :m2],
                           self.weights1)
        bottom = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, H - m1:, :m2],
                              self.weights2)
        mid = top.new_zeros(*top.shape[:2], H - 2 * m1, m2)
        out = torch.cat([top, mid, bottom], dim=2)              # (B,out,H,m2)
        out = nn.functional.pad(out, (0, W // 2 + 1 - m2))
        return torch.fft.irfft2(out, s=(H, W))
