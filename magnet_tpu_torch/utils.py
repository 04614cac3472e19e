"""Coordinate helpers (counterpart of ``magnet_tpu/utils.py:24-62``), the
host-batch-to-device copy and the ``trainer.precision`` switch."""
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


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


#: ``trainer.precision`` values that let cuBLAS and cuDNN compute f32
#: products in TF32 (the repo's ``run.py:50-54`` maps them to the matmul
#: precision ``high``)
TF32_PRECISIONS = ("tensorfloat32", "high")


def set_precision(precision="default") -> None:
    """cuBLAS's and cuDNN's f32 products: TF32 for ``tensorfloat32`` and
    ``high``, full f32 for ``default``, ``float32``, ``highest`` and any
    other value (the repo's ``run.py`` changes nothing for another value,
    and its ``default`` is f32 on the CPU the tests run on).  The port's
    own kernels do not read it: they always compute in 3xTF32 (f32) or
    bf16."""
    tf32 = str(precision) in TF32_PRECISIONS
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
