"""Nearest and (bi)linear resampling with torch's semantics
(counterpart of ``magnet_tpu/ops/interp.py:19-74``)."""
from __future__ import annotations

import torch


def _nearest_index(gx: torch.Tensor, n: int) -> torch.Tensor:
    """Normalised coordinate in [-1, 1] -> nearest pixel index, as
    ``F.grid_sample(mode='nearest', padding_mode='border',
    align_corners=False)``: clip the float position, then round half to
    even (``torch.round`` does)."""
    ix = ((gx + 1.0) * n - 1.0) / 2.0
    ix = torch.clamp(ix, 0.0, n - 1.0)
    return torch.round(ix).long()


def interpolate_linear_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """x (..., L) -> (..., size), as ``F.interpolate(mode='linear',
    align_corners=False)``: half-pixel centres, no antialias, edge clamp."""
    l = x.shape[-1]
    scale = l / size
    pos = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) \
        * scale - 0.5
    lo = torch.floor(pos)
    frac = pos - lo
    lo_i = torch.clamp(lo.long(), 0, l - 1)
    hi_i = torch.clamp(lo_i + 1, 0, l - 1)
    # torch clamps the source position at the left edge: pos < 0 reads the
    # first pixel with no blend
    frac = torch.where(pos < 0, torch.zeros_like(frac), frac)
    return x[..., lo_i] * (1.0 - frac) + x[..., hi_i] * frac


def grid_sample_nearest_2d(feat: torch.Tensor, g_row: torch.Tensor,
                           g_col: torch.Tensor) -> torch.Tensor:
    """feat (C, H, W); g_row / g_col (N,) normalised coordinates along the
    H and W axes -> (N, C), as ``F.grid_sample(mode='nearest',
    padding_mode='border', align_corners=False)`` on the reference's
    flipped (row, col) coordinates."""
    c, h, w = feat.shape
    iy = _nearest_index(g_row, h)
    ix = _nearest_index(g_col, w)
    return feat.reshape(c, h * w)[:, iy * w + ix].t()


def interpolate_bilinear_2d(x: torch.Tensor, size) -> torch.Tensor:
    """x (..., H, W) -> (..., size[0], size[1]), as ``F.interpolate(
    mode='bilinear', align_corners=False)``: the linear resampling along
    each axis, no antialias."""
    out = interpolate_linear_1d(x, size[1]).transpose(-1, -2)
    return interpolate_linear_1d(out, size[0]).transpose(-1, -2)
