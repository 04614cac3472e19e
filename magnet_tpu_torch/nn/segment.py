"""Per-sample normalisation over a batch-flattened node table (counterpart
of ``magnet_tpu/ops/segment.py:71-85``)."""
from __future__ import annotations

import torch


def segment_instance_norm(x: torch.Tensor, batch_size: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """x (B*N, C), sample b's nodes at rows b*N:(b+1)*N.  Standardises each
    channel over the nodes of each sample, never across samples: torch
    geometric's ``InstanceNorm`` with its defaults (no affine, no running
    statistics, biased two-pass variance, eps 1e-5)."""
    if x.shape[0] % batch_size:
        raise ValueError(f"{x.shape[0]} rows do not split into {batch_size} "
                         f"samples of equal size")
    v = x.view(batch_size, -1, x.shape[-1])
    mean = v.mean(dim=1, keepdim=True)
    d = v - mean
    var = (d * d).mean(dim=1, keepdim=True)
    return (d / torch.sqrt(var + eps)).view_as(x)
