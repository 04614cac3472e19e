"""Datasets with the reference reader's semantics (counterpart of
``magnet_tpu/data/datasets.py``): MAgNet[CNN]'s, 1D and 2D, and the MPNN
graph datasets, 1D and 2D.

A split comes from an HDF5 file (group ``train``/``valid``/``test`` with
``t``, ``x`` and ``pde_<nt>-<nx>``, in 2D also ``y`` or ``coords``;
``h5py`` is imported only when a file is read, and the split is read into
memory whole) or from arrays already in memory under the same keys, as
``data.synthetic.make_split`` makes them.  ``__getitem__`` returns a dict of numpy arrays.
MAgNet[GNN]'s 1D samples are ``DatasetImplicitGNN1D``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from magnet_tpu_torch.ops.interp import (
    interpolate_bilinear_2d,
    interpolate_linear_1d,
)
from magnet_tpu_torch.utils import make_coord_np

MODES = ("train", "valid", "test")


def bilinear_resize_2d_np(u: np.ndarray, size) -> np.ndarray:
    """``F.interpolate(mode='bilinear', align_corners=False)`` of the last
    two axes of a host array, on the CPU (``_np_bilinear_resize_2d``)."""
    return interpolate_bilinear_2d(torch.from_numpy(np.asarray(u)),
                                   size).numpy()


def read_h5_split(path: str, mode: str) -> dict:
    """Every dataset of group ``mode`` of an HDF5 file, as numpy arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[mode][k][:] for k in f[mode].keys()}


class DatasetImplicit1D:
    """MAgNet[CNN] samples: a half-resolution support (linear resize to
    L//2) and HR queries.  Train mode draws ``samples`` sorted query
    indices without replacement from the dataset's generator ('uniform',
    or 'boundary': softmax weights growing towards both ends).  Eval modes
    query every point; ``eval_support='full'`` makes the support the full
    mesh too."""

    def __init__(self, source, mode: str, nt: int, nx: int,
                 sampling: str = "uniform", samples: int = 256,
                 eval_support: str = "lr"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if sampling not in ("uniform", "boundary"):
            raise ValueError(f"unknown sampling {sampling!r}")
        self.mode = mode
        self.key = f"pde_{nt}-{nx}"
        self.data = source if isinstance(source, dict) \
            else read_h5_split(source, mode)
        if self.key not in self.data:
            raise KeyError(f"{self.key} not in the {mode} split "
                           f"(it holds {sorted(self.data)})")
        self.samples = samples
        self.sampling = sampling
        self.eval_support = eval_support
        self.rng = np.random.default_rng(0)

    def set_epoch(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.data[self.key].shape[0]

    def __getitem__(self, idx):
        t = np.asarray(self.data["t"][idx], np.float32)
        u_hr = np.asarray(self.data[self.key][idx], np.float32)[:, None, :]
        L = u_hr.shape[-1]                                    # u_hr (T, 1, L)
        full = self.mode != "train" and self.eval_support == "full"
        u_lr = u_hr if full else interpolate_linear_1d(
            torch.from_numpy(u_hr), L // 2).numpy()

        full_coord = make_coord_np([L])                       # (L, 1)
        if self.mode != "train":
            sample_lst = np.arange(L)
        elif self.sampling == "uniform":
            sample_lst = np.sort(self.rng.choice(L, self.samples, replace=False))
        else:
            logits = (np.abs(np.arange(L) - L // 2) / L) ** 2 / 0.1
            p = np.exp(logits - logits.max())
            p = p / p.sum()
            sample_lst = np.sort(
                self.rng.choice(L, self.samples, p=p, replace=False))

        hr_coord = full_coord[sample_lst]
        out = {
            "t": t,
            "lr_frames": u_lr,
            "hr_frames": u_hr,
            "hr_points": u_hr[:, 0, sample_lst][:, :, None],   # (T, n, 1)
            "coords": hr_coord,
            "cells": np.full_like(hr_coord, 2.0 / L),
        }
        if self.mode == "train":
            out["sample_idx"] = sample_lst.astype(np.int64)
        return out


class DatasetImplicitGNN1D(DatasetImplicit1D):
    """MAgNet[GNN] samples (``magnet_tpu/data/datasets.py:162-208``): x
    normalised to [-1, 1]; the support is every second mesh node (the
    stride-2 frames ``u[:, :, ::2]``), the queries the odd complement.
    Train mode draws ``samples`` sorted queries from that complement
    without replacement from the dataset's generator; eval modes query all
    of it, and ``eval_support='full'`` makes the support and the queries
    the whole mesh (``sampling`` is not read)."""

    def __getitem__(self, idx):
        x = np.asarray(self.data["x"][idx], np.float32)
        x = 2 * (x - x.min()) / (x.max() - x.min()) - 1
        t = np.asarray(self.data["t"][idx], np.float32)
        u_hr = np.asarray(self.data[self.key][idx], np.float32)[:, None, :]
        L = u_hr.shape[-1]                                    # u_hr (T, 1, L)
        full = self.mode != "train" and self.eval_support == "full"
        u_lr = u_hr if full else u_hr[:, :, ::2]
        lr_coord = (x if full else x[::2])[:, None]
        left = np.setdiff1d(np.arange(L), np.arange(L)[::2])
        if self.mode == "train":
            sample_lst = np.sort(self.rng.choice(left, self.samples,
                                                 replace=False))
        else:
            sample_lst = np.arange(L) if full else left
        out = {
            "t": t,
            "lr_frames": u_lr,
            "hr_frames": u_hr,
            "hr_points": u_hr[:, 0, sample_lst][:, :, None],   # (T, n, 1)
            "coords_hr": x[sample_lst][:, None],
            "coords_lr": lr_coord,
        }
        if self.mode == "train":
            out["sample_idx"] = sample_lst.astype(np.int64)
        return out


class _Split:
    """One split's arrays and the trajectory key ``pde_<nt>-<res>``."""

    def __init__(self, source, mode: str, key: str):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode, self.key = mode, key
        self.data = source if isinstance(source, dict) \
            else read_h5_split(source, mode)
        if key not in self.data:
            raise KeyError(f"{key} not in the {mode} split "
                           f"(it holds {sorted(self.data)})")

    def set_epoch(self, seed: int):
        """The graph datasets draw nothing at random."""

    def __len__(self):
        return self.data[self.key].shape[0]


class DatasetGraph1D(_Split):
    """MPNN samples {u (N, T), x (N, 1), t (T,)}."""

    def __init__(self, source, mode: str, nt: int, nx: int):
        super().__init__(source, mode, f"pde_{nt}-{nx}")

    def __getitem__(self, idx):
        u = np.asarray(self.data[self.key][idx], np.float32)   # (T, N)
        x = np.asarray(self.data["x"][idx], np.float32)[:, None]
        t = np.asarray(self.data["t"][idx], np.float32)
        return {"u": u.T, "x": x, "t": t}


class DatasetGraph2D(_Split):
    """MPNN-2D samples {u (N, T), x (N, 2), t (T,)}: ``regular`` meshes are
    the 'ij' meshgrid of the stored ``x`` and ``y`` (N = W*W), irregular
    ones read their stored ``coords``."""

    def __init__(self, source, mode: str, nt: int, res: int,
                 regular: bool = True):
        super().__init__(source, mode, f"pde_{nt}-{res}")
        self.regular = regular

    def __getitem__(self, idx):
        u = np.asarray(self.data[self.key][idx], np.float32)   # (T, W, W) | (T, N)
        u = u.reshape(u.shape[0], -1).T                        # (N, T)
        if self.regular:
            x = np.asarray(self.data["x"][idx], np.float32)
            y = np.asarray(self.data["y"][idx], np.float32)
            coords = np.stack(np.meshgrid(x, y, indexing="ij"), -1).reshape(-1, 2)
        else:
            coords = np.asarray(self.data["coords"][idx], np.float32)
        t = np.asarray(self.data["t"][idx], np.float32)
        return {"u": u, "x": coords, "t": t}


class DatasetImplicit2D(_Split):
    """MAgNet[CNN] 2D samples: a half-resolution support (bilinear resize
    to W//2 x W//2) and HR queries over the W x W mesh.  Train mode draws
    ``samples`` sorted query indices without replacement from the dataset's
    generator; eval modes query every point, and ``eval_support='full'``
    makes the support the full mesh too."""

    def __init__(self, source, mode: str, nt: int, res: int,
                 samples: int = 256, eval_support: str = "lr"):
        super().__init__(source, mode, f"pde_{nt}-{res}")
        self.samples = samples
        self.eval_support = eval_support
        self.rng = np.random.default_rng(0)

    def set_epoch(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __getitem__(self, idx):
        t = np.asarray(self.data["t"][idx], np.float32)
        u_hr = np.asarray(self.data[self.key][idx], np.float32)[:, None]
        T, _, W, _ = u_hr.shape                               # (T, 1, W, W)
        full = self.mode != "train" and self.eval_support == "full"
        u_lr = u_hr if full else bilinear_resize_2d_np(u_hr, (W // 2, W // 2))
        full_coord = make_coord_np([W, W])                    # (W*W, 2)
        if self.mode == "train":
            sample_lst = np.sort(self.rng.choice(W * W, self.samples,
                                                 replace=False))
        else:
            sample_lst = np.arange(W * W)
        hr_coord = full_coord[sample_lst]
        out = {
            "t": t,
            "lr_frames": u_lr,
            "hr_frames": u_hr,
            "hr_points": u_hr.reshape(T, -1)[:, sample_lst][:, :, None],
            "coords": hr_coord,
            "cells": np.full_like(hr_coord, 2.0 / W),
        }
        if self.mode == "train":
            out["sample_idx"] = sample_lst.astype(np.int64)
        return out
