"""Coordinate helpers (counterpart of ``magnet_tpu/utils.py:24-62``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def make_coord_np(shape: Sequence[int], ranges=None,
                  flatten: bool = True) -> np.ndarray:
    """Grid-cell-centre coordinates in [-1, 1], float32.  ``shape=[n]``
    gives (n, 1); ``[h, w]`` gives (h*w, 2) with 'ij' indexing (or
    (h, w, 2) when ``flatten=False``)."""
    coord_seqs = []
    for i, n in enumerate(shape):
        v0, v1 = (-1.0, 1.0) if ranges is None else ranges[i]
        r = (v1 - v0) / (2 * n)
        coord_seqs.append(v0 + r + (2 * r) * np.arange(n, dtype=np.float32))
    grids = np.meshgrid(*coord_seqs, indexing="ij")
    ret = np.stack(grids, axis=-1).astype(np.float32)
    if flatten:
        ret = ret.reshape(-1, ret.shape[-1])
    return ret


def make_coord(shape: Sequence[int], ranges=None, flatten: bool = True,
               device=None) -> torch.Tensor:
    """:func:`make_coord_np` as a tensor on ``device``."""
    return torch.from_numpy(make_coord_np(shape, ranges, flatten)).to(device)
