"""Shared model plumbing: the loss, nRMSE and time windows (counterpart of
``magnet_tpu/models/common.py:85-116, 289-295``)."""
from __future__ import annotations

import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


LOSSES = {"l1": l1_loss}


def nrmse(pred, target, eps: float = 1e-12):
    """Normalised RMSE over the whole tensor."""
    num = torch.sqrt(torch.mean((pred - target) ** 2))
    den = torch.sqrt(torch.mean(target ** 2))
    return num / (den + eps)


def time_windows(t: torch.Tensor, n_windows: int, slice_len: int) -> torch.Tensor:
    """(B, nt) -> (B, n, 2*slice_len); window i covers [i*ts, (i+2)*ts)."""
    idx = (torch.arange(n_windows)[:, None] * slice_len
           + torch.arange(2 * slice_len)[None, :])
    return t[:, idx.to(t.device)]
