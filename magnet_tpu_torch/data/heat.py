"""Heat test batches made from a seed, with no file and no ``h5py``.

Own copies of ``magnet_tpu/data/synthetic.py:_initial_condition_1d`` and
``solve_heat_1d`` (the Heat equation solved exactly in Fourier space), and
of the eval-mode sample assembly of ``DatasetImplicit1D``
(``magnet_tpu/data/datasets.py:121-159``, ``eval_support='lr'``): the model
gets a half-resolution support (linear resize to L//2, on the CPU) and
queries every point of the full mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from magnet_tpu_torch.ops.interp import interpolate_linear_1d
from magnet_tpu_torch.utils import make_coord_np


def _initial_condition_1d(rng, n, n_modes=5, lmax=3):
    k = rng.integers(1, lmax + 1, size=n_modes)
    amp = rng.uniform(-0.5, 0.5, size=n_modes)
    phase = rng.uniform(0, 2 * np.pi, size=n_modes)
    x = np.arange(n) / n
    u = np.zeros(n)
    for a, kk, p in zip(amp, k, phase):
        u += a * np.sin(2 * np.pi * kk * x + p)
    return u


def solve_heat_1d(rng, nx=256, nt_out=256, t_end=4.0, length=16.0, nu=0.3):
    """∂_t u = ν ∂_xx u, periodic.  Returns (u (nt_out, nx), x, t) float32."""
    u0 = _initial_condition_1d(rng, nx) * 2.0
    k = 2 * np.pi * np.fft.rfftfreq(nx, d=length / nx)
    uh0 = np.fft.rfft(u0)
    t = np.linspace(0, t_end, nt_out, endpoint=False)
    frames = [np.fft.irfft(uh0 * np.exp(-nu * k**2 * ti), n=nx) for ti in t]
    x = (np.arange(nx) * (length / nx)).astype(np.float32)
    return np.stack(frames).astype(np.float32), x, t.astype(np.float32)


def implicit_eval_sample(u: np.ndarray, t: np.ndarray) -> dict:
    """One eval sample from a trajectory u (nt, L): the model's batch keys."""
    u_hr = u.astype(np.float32)[:, None, :]                      # (T, 1, L)
    L = u_hr.shape[-1]
    u_lr = interpolate_linear_1d(torch.from_numpy(u_hr), L // 2).numpy()
    hr_coord = make_coord_np([L])                                # every point
    return {
        "t": t.astype(np.float32),
        "lr_frames": u_lr,
        "hr_points": u_hr[:, 0, :, None],                        # (T, L, 1)
        "coords": hr_coord,
        "cells": np.full_like(hr_coord, 2.0 / L),
    }


def heat_batches(n_traj: int, batch_size: int, nt: int = 256, nx: int = 256,
                 seed: int = 0) -> list[dict]:
    """``n_traj`` Heat trajectories from ``seed``, as eval batches of numpy
    arrays (the last batch may be smaller)."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n_traj):
        u, _, t = solve_heat_1d(rng, nx=nx, nt_out=nt)
        samples.append(implicit_eval_sample(u, t))
    return [
        {k: np.stack([s[k] for s in samples[i:i + batch_size]])
         for k in samples[0]}
        for i in range(0, n_traj, batch_size)
    ]
