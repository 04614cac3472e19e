"""Trajectories made from a seed with numpy, no file and no ``h5py``: own
copies of ``magnet_tpu/data/synthetic.py``'s ``_initial_condition_1d``,
``solve_ks_1d`` (the training PDE of the implicit-1D protocol) and
``solve_heat_1d`` (its zero-shot transfer test)."""
from __future__ import annotations

import numpy as np


def _initial_condition_1d(rng, n, n_modes=5, lmax=3):
    k = rng.integers(1, lmax + 1, size=n_modes)
    amp = rng.uniform(-0.5, 0.5, size=n_modes)
    phase = rng.uniform(0, 2 * np.pi, size=n_modes)
    x = np.arange(n) / n
    u = np.zeros(n)
    for a, kk, p in zip(amp, k, phase):
        u += a * np.sin(2 * np.pi * kk * x + p)
    return u


def solve_ks_1d(rng, nx_fine=256, nt_out=128, nx_out=None, t_end=32.0,
                length=64.0, burn_in=40.0, dt=0.01):
    """Kuramoto-Sivashinsky equation

        ∂_t u + u ∂_x u + ∂_xx u + ∂_xxxx u = 0,  periodic on [0, L)

    L=64 puts the system deep in the chaotic regime.  The linear symbol
    (k² − k⁴) is integrated exactly by a Fourier integrating factor; the
    conservative nonlinearity −½∂_x(u²) advances with IF-RK2 (dealiased).
    A burn-in window discards the transient so saved trajectories live on
    the chaotic attractor.  Returns (u (nt_out, nx_out), x, t) float32."""
    nx_out = nx_out or nx_fine
    dx = length / nx_fine
    u = _initial_condition_1d(rng, nx_fine) * 2.0
    k = 2 * np.pi * np.fft.rfftfreq(nx_fine, d=dx)
    dealias = np.ones_like(k)
    dealias[k > (2 / 3) * k.max()] = 0.0
    lin = k**2 - k**4
    efac = np.exp(lin * dt)
    efac_h = np.exp(lin * (dt / 2))

    def nonlin(uh):
        uu = np.fft.irfft(uh, n=nx_fine)
        return -0.5j * k * np.fft.rfft(uu * uu) * dealias

    uh = np.fft.rfft(u)
    n_burn = int(round(burn_in / dt))
    n_steps = int(round(t_end / dt))
    save_every = n_steps // nt_out
    frames = []
    for s in range(n_burn + n_steps):
        if s >= n_burn and (s - n_burn) % save_every == 0 \
                and len(frames) < nt_out:
            frames.append(np.fft.irfft(uh, n=nx_fine))
        k1 = nonlin(uh)
        k2 = nonlin(efac_h * (uh + 0.5 * dt * k1))
        uh = efac * uh + dt * efac_h * k2
    while len(frames) < nt_out:
        frames.append(np.fft.irfft(uh, n=nx_fine))
    u_t = np.stack(frames)
    stride = nx_fine // nx_out
    u_out = u_t[:, ::stride][:, :nx_out]
    x = (np.arange(nx_out) * (length / nx_out)).astype(np.float32)
    t = np.linspace(0, t_end, nt_out, endpoint=False).astype(np.float32)
    return u_out.astype(np.float32), x, t


def solve_heat_1d(rng, nx=256, nt_out=256, t_end=4.0, length=16.0, nu=0.3):
    """∂_t u = ν ∂_xx u, periodic, solved exactly in Fourier space.
    Returns (u (nt_out, nx), x, t) float32."""
    u0 = _initial_condition_1d(rng, nx) * 2.0
    k = 2 * np.pi * np.fft.rfftfreq(nx, d=length / nx)
    uh0 = np.fft.rfft(u0)
    t = np.linspace(0, t_end, nt_out, endpoint=False)
    frames = [np.fft.irfft(uh0 * np.exp(-nu * k**2 * ti), n=nx) for ti in t]
    x = (np.arange(nx) * (length / nx)).astype(np.float32)
    return np.stack(frames).astype(np.float32), x, t.astype(np.float32)


def make_split(eq: str, n: int, nt: int, nx: int, seed: int = 0,
               **solver_kw) -> dict:
    """``n`` trajectories of ``eq`` ('KS' or 'Heat') from ``seed`` as one
    split's arrays: ``{"t": (n, nt), "pde_<nt>-<nx>": (n, nt, nx)}``, the
    in-memory form of one group of the HDF5 schema."""
    if eq not in ("KS", "Heat"):
        raise ValueError(f"eq must be 'KS' or 'Heat', got {eq!r}")
    rng = np.random.default_rng(seed)
    us, ts = [], []
    for _ in range(n):
        if eq == "KS":
            u, _, t = solve_ks_1d(rng, nx_fine=max(256, nx), nt_out=nt,
                                  nx_out=nx, **solver_kw)
        else:
            u, _, t = solve_heat_1d(rng, nx=nx, nt_out=nt, **solver_kw)
        us.append(u)
        ts.append(t)
    return {"t": np.stack(ts), f"pde_{nt}-{nx}": np.stack(us)}
