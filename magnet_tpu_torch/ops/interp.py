"""Nearest and linear resampling with torch's semantics
(counterpart of ``magnet_tpu/ops/interp.py:19-65``)."""
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
