"""Trajectories made from a seed with numpy (counterpart of
``magnet_tpu/data/synthetic.py``, own copies, bit for bit):
``_initial_condition_1d``, ``solve_ks_1d`` (the training PDE of the
implicit-1D protocol), ``solve_heat_1d`` (its zero-shot transfer test),
``solve_burgers_1d`` (the writers' plain-Burgers set), ``solve_combined_1d``
with its forcing, presets and WENO5 flux (the E1/E2/E3 sets MPNN 1D and
FNO-1D train on) and its irregular-mesh variant
``solve_combined_1d_irregular``, ``solve_burgers_2d`` (the B1 set of the 2D
models), in memory (``make_split``, with the irregular subsample of
``generate_2d_file``), and the HDF5 writers ``generate_1d_file``,
``generate_ce_suite`` and ``generate_2d_file`` in the reference schema.
Only the writers need ``h5py``, imported inside them.

  python -m magnet_tpu_torch.data.synthetic [ROOT]

writes the synthetic dataset suite of ``scripts/gen_synthetic_data.sh``
under ROOT (default ``data``); ``GEN_CE_SUITE=0`` leaves out the E1/E2/E3
tree.
"""
from __future__ import annotations

import os
import shutil
import sys

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


class _Forcing1D:
    """Brandstetter et al. 2022 forcing δ(t, x) = Σ_j A_j sin(ω_j t +
    2π ℓ_j x / L + φ_j) with J=5, A~U(-0.5,0.5), ω~U(-0.4,0.4),
    ℓ ∈ {1,2,3}, φ~U(0,2π).  The initial condition is u(0,·) = δ(0,·)."""

    def __init__(self, rng, length, n_modes=5, lmax=3):
        self.A = rng.uniform(-0.5, 0.5, n_modes)
        self.omega = rng.uniform(-0.4, 0.4, n_modes)
        self.ell = rng.integers(1, lmax + 1, n_modes)
        self.phi = rng.uniform(0, 2 * np.pi, n_modes)
        self.length = length

    def __call__(self, t, x):
        """x (n,) physical coords in [0, L)."""
        out = np.zeros_like(x)
        for a, w, l, p in zip(self.A, self.omega, self.ell, self.phi):
            out += a * np.sin(w * t + 2 * np.pi * l * x / self.length + p)
        return out


# (α, β, γ) presets of the combined equation
#   ∂_t u + ∂_x(α u² − β ∂_x u + γ ∂_xx u) = δ(t, x)
# (Brandstetter et al. 2022, the source of the reference's CE_* datasets,
# reference README.md:34-60):
#   E1: Burgers without diffusion (0.5, 0, 0)
#   E2: Burgers with variable diffusion (0.5, η, 0), η ~ U(0, 0.2)
#   E3: fully mixed, α ~ U(0, 3), β ~ U(0, 0.4), γ ~ U(0, 1)
def _ce_params(eq: str, rng) -> tuple[float, float, float]:
    if eq == "E1":
        return 0.5, 0.0, 0.0
    if eq == "E2":
        return 0.5, float(rng.uniform(0.0, 0.2)), 0.0
    if eq == "E3":
        return (float(rng.uniform(0.0, 3.0)), float(rng.uniform(0.0, 0.4)),
                float(rng.uniform(0.0, 1.0)))
    raise ValueError(f"unknown combined-equation preset {eq!r}")


def _weno5_flux_divergence(u, flux, dflux_max, dx):
    """∂_x f(u) via 5th-order WENO-JS reconstruction with global
    Lax-Friedrichs flux splitting, periodic (vectorized with np.roll).

    The reference's CE_* datasets come from Brandstetter et al.'s solver,
    which uses WENO5 for the convective flux — required for the INVISCID
    E1 (shocks form; a pure spectral method rings/blows up there).
    """
    f = flux(u)
    a = dflux_max
    fp = 0.5 * (f + a * u)        # right-moving part, left-biased stencil
    fm = 0.5 * (f - a * u)        # left-moving part, right-biased stencil

    eps = 1e-6

    def rec_left(g):
        """f̂_{i+1/2} from left-biased stencils of g (for f+)."""
        gm2 = np.roll(g, 2)
        gm1 = np.roll(g, 1)
        g0 = g
        gp1 = np.roll(g, -1)
        gp2 = np.roll(g, -2)
        p0 = (2 * gm2 - 7 * gm1 + 11 * g0) / 6
        p1 = (-gm1 + 5 * g0 + 2 * gp1) / 6
        p2 = (2 * g0 + 5 * gp1 - gp2) / 6
        b0 = (13 / 12) * (gm2 - 2 * gm1 + g0) ** 2 + 0.25 * (
            gm2 - 4 * gm1 + 3 * g0
        ) ** 2
        b1 = (13 / 12) * (gm1 - 2 * g0 + gp1) ** 2 + 0.25 * (gm1 - gp1) ** 2
        b2 = (13 / 12) * (g0 - 2 * gp1 + gp2) ** 2 + 0.25 * (
            3 * g0 - 4 * gp1 + gp2
        ) ** 2
        a0 = 0.1 / (eps + b0) ** 2
        a1 = 0.6 / (eps + b1) ** 2
        a2 = 0.3 / (eps + b2) ** 2
        s = a0 + a1 + a2
        return (a0 * p0 + a1 * p1 + a2 * p2) / s

    fhat_p = rec_left(fp)                       # at i+1/2
    # mirror-symmetric reconstruction for f−: the right-biased estimate at
    # interface i+1/2 equals the left-biased estimate on the reversed
    # array at reversed interface N-2-i ( = roll(rev(rec_left(rev(g))),-1))
    fhat_m = np.roll(rec_left(fm[::-1])[::-1], -1)
    fhat = fhat_p + fhat_m                      # numerical flux at i+1/2
    return (fhat - np.roll(fhat, 1)) / dx


def solve_combined_1d(
    rng, eq="E1", nx_fine=256, nt_out=250, nx_out=None, t_end=4.0,
    length=16.0, n_steps=4000,
):
    """Combined 1D equation (Brandstetter et al. 2022; the E1/E2/E3 CE_*
    datasets):

        ∂_t u + ∂_x(α u² − β ∂_x u + γ ∂_xx u) = δ(t, x),  periodic on [0, L)

    i.e. ∂_t u = −∂_x(α u²) + β ∂_xx u − γ ∂_xxx u + δ.  The convective
    flux is WENO5 (shock-capturing — E1 is inviscid); the linear symbol
    (−β k² + i γ k³) is integrated EXACTLY by a Fourier integrating factor
    (diffusion decayed, dispersion rotated — stable for E3's γ up to 1);
    nonlinearity + forcing advance with IF-RK2.  Domain L = 16, t ∈ [0, 4],
    250 saved frames — the reference datasets' shape.

    Returns (u (nt_out, nx_out), x (nx_out,), t (nt_out,)).
    """
    nx_out = nx_out or nx_fine
    alpha, beta, gamma = _ce_params(eq, rng)
    forcing = _Forcing1D(rng, length)
    dx = length / nx_fine
    xg = np.arange(nx_fine) * dx
    u = forcing(0.0, xg)                                     # u(0,·) = δ(0,·)

    k = 2 * np.pi * np.fft.rfftfreq(nx_fine, d=dx)

    def nonlin(uh, t):
        uu = np.fft.irfft(uh, n=nx_fine)
        a = 2.0 * alpha * max(np.abs(uu).max(), 1e-12)       # max |f'(u)|
        div = _weno5_flux_divergence(uu, lambda v: alpha * v * v, a, dx)
        return np.fft.rfft(-div + forcing(t, xg))

    dt = t_end / n_steps
    save_every = n_steps // nt_out
    lin = -beta * (k**2) + 1j * gamma * (k**3)
    efac = np.exp(lin * dt)
    efac_h = np.exp(lin * (dt / 2))
    uh = np.fft.rfft(u)
    frames = []
    for s in range(n_steps):
        if s % save_every == 0 and len(frames) < nt_out:
            frames.append(np.fft.irfft(uh, n=nx_fine))
        t0 = s * dt
        k1 = nonlin(uh, t0)
        k2 = nonlin(efac_h * (uh + 0.5 * dt * k1), t0 + 0.5 * dt)
        uh = efac * uh + dt * efac_h * k2
    while len(frames) < nt_out:
        frames.append(np.fft.irfft(uh, n=nx_fine))
    u_t = np.stack(frames)                                   # (nt, nx_fine)
    stride = nx_fine // nx_out
    u_out = u_t[:, ::stride][:, :nx_out]
    x = (np.arange(nx_out) * (length / nx_out)).astype(np.float32)
    t = np.linspace(0, t_end, nt_out, endpoint=False).astype(np.float32)
    return u_out.astype(np.float32), x, t


def solve_combined_1d_irregular(
    rng, eq="E1", n_nodes=50, nx_fine=256, nt_out=250, t_end=4.0,
    length=16.0,
):
    """Irregular-mesh variant: solve at the fine regular resolution, then
    keep ``n_nodes`` randomly selected grid points (sorted), as the
    irregular CE_*_graph_* files store per-sample node coordinates."""
    u, x, t = solve_combined_1d(
        rng, eq=eq, nx_fine=nx_fine, nt_out=nt_out, nx_out=nx_fine,
        t_end=t_end, length=length,
    )
    sel = np.sort(rng.choice(nx_fine, n_nodes, replace=False))
    return u[:, sel], x[sel], t


def solve_burgers_1d(
    rng, nx_fine=256, nt_out=250, nx_out=None, t_end=2.0, nu=0.01, length=16.0
):
    """Returns (u (nt_out, nx_out), x (nx_out,), t (nt_out,))."""
    nx_out = nx_out or nx_fine
    u = _initial_condition_1d(rng, nx_fine)
    k = 2 * np.pi * np.fft.rfftfreq(nx_fine, d=length / nx_fine)
    dealias = np.ones_like(k)
    dealias[k > (2 / 3) * k.max()] = 0.0

    def rhs(uh):
        ux = np.fft.irfft(1j * k * uh, n=nx_fine)
        uu = np.fft.irfft(uh, n=nx_fine)
        return -np.fft.rfft(uu * ux) * dealias

    n_steps = 2000
    dt = t_end / n_steps
    save_every = n_steps // nt_out
    # integrating factor: diffusion handled exactly (unconditionally stable)
    efac = np.exp(-nu * (k**2) * dt)
    uh = np.fft.rfft(u)
    frames = []
    for s in range(n_steps):
        if s % save_every == 0 and len(frames) < nt_out:
            frames.append(np.fft.irfft(uh, n=nx_fine))
        k1 = rhs(uh)
        k2 = rhs(uh + 0.5 * dt * k1)
        uh = (uh + dt * k2) * efac
    while len(frames) < nt_out:
        frames.append(np.fft.irfft(uh, n=nx_fine))
    u_t = np.stack(frames)                                   # (nt, nx_fine)
    stride = nx_fine // nx_out
    u_out = u_t[:, ::stride][:, :nx_out]
    x = (np.arange(nx_out) * (length / nx_out)).astype(np.float32)
    t = np.linspace(0, t_end, nt_out, endpoint=False).astype(np.float32)
    return u_out.astype(np.float32), x, t


def solve_burgers_2d(
    rng, w_fine=64, nt_out=50, w_out=None, t_end=1.0, nu=0.02, length=1.0
):
    """Returns (u (nt_out, w_out, w_out), x (w_out,), y (w_out,), t)."""
    w_out = w_out or w_fine
    xg = np.arange(w_fine) / w_fine
    X, Y = np.meshgrid(xg, xg, indexing="ij")
    u = np.zeros((w_fine, w_fine))
    for _ in range(4):
        kx, ky = rng.integers(1, 4, size=2)
        a = rng.uniform(-0.4, 0.4)
        px, py = rng.uniform(0, 2 * np.pi, size=2)
        u += a * np.sin(2 * np.pi * kx * X + px) * np.sin(2 * np.pi * ky * Y + py)

    kvec = 2 * np.pi * np.fft.fftfreq(w_fine, d=length / w_fine)
    KX, KY = np.meshgrid(kvec, kvec, indexing="ij")
    K2 = KX**2 + KY**2
    kmax = np.abs(kvec).max()
    dealias = (np.abs(KX) <= (2 / 3) * kmax) & (np.abs(KY) <= (2 / 3) * kmax)

    def rhs(uh):
        uu = np.real(np.fft.ifft2(uh))
        ux = np.real(np.fft.ifft2(1j * KX * uh))
        uy = np.real(np.fft.ifft2(1j * KY * uh))
        return -np.fft.fft2(uu * (ux + uy)) * dealias

    n_steps = 1000
    dt = t_end / n_steps
    save_every = n_steps // nt_out
    efac = np.exp(-nu * K2 * dt)
    uh = np.fft.fft2(u)
    frames = []
    for s in range(n_steps):
        if s % save_every == 0 and len(frames) < nt_out:
            frames.append(np.real(np.fft.ifft2(uh)))
        k1 = rhs(uh)
        k2 = rhs(uh + 0.5 * dt * k1)
        uh = (uh + dt * k2) * efac
    while len(frames) < nt_out:
        frames.append(np.real(np.fft.ifft2(uh)))
    u_t = np.stack(frames)
    stride = w_fine // w_out
    u_out = u_t[:, ::stride, ::stride][:, :w_out, :w_out]
    x = (np.arange(w_out) * (length / w_out)).astype(np.float32)
    t = np.linspace(0, t_end, nt_out, endpoint=False).astype(np.float32)
    return u_out.astype(np.float32), x, x.copy(), t


def irregular_nodes(rng, x, y, n_nodes: int, concentrated: bool):
    """``n_nodes`` sorted flat indices of the len(x) x len(y) grid and
    their coordinates, drawn as ``generate_2d_file`` draws them: uniform,
    or weighted by a Gaussian (sigma 0.15) around a random grid point."""
    grid = np.stack(np.meshgrid(x, y, indexing="ij"), -1).reshape(-1, 2)
    n_grid = grid.shape[0]
    if concentrated:
        focus = grid[rng.integers(n_grid)]
        w = np.exp(-((grid - focus) ** 2).sum(-1) / (2 * 0.15**2))
        sel = np.sort(rng.choice(n_grid, n_nodes, replace=False, p=w / w.sum()))
    else:
        sel = np.sort(rng.choice(n_grid, n_nodes, replace=False))
    return sel, grid[sel]


#: the equations of the datamodules' synthetic sources
EQUATIONS = ("KS", "Heat", "E1", "E2", "E3", "B2D")


def make_split(eq: str, n: int, nt: int, nx: int, seed: int = 0,
               n_nodes: int | None = None, concentrated: bool = False,
               **solver_kw) -> dict:
    """``n`` trajectories of ``eq`` (one of ``EQUATIONS``) from ``seed``
    as one split's arrays, the in-memory form of one group of the HDF5
    schema (``draw_split`` with a generator seeded ``seed``)."""
    if eq not in EQUATIONS:
        raise ValueError(f"unknown equation {eq!r}")
    return draw_split(np.random.default_rng(seed), eq, n, nt, nx, n_nodes,
                      concentrated, **solver_kw)


def draw_split(rng, eq: str, n: int, nt: int, nx: int,
               n_nodes: int | None = None, concentrated: bool = False,
               **solver_kw) -> dict:
    """``n`` trajectories of ``eq`` drawn from the generator ``rng``, as
    ``generate_1d_file`` / ``generate_2d_file`` draw a split.  'KS',
    'Heat', 'Burgers' (the writers' plain 1D Burgers, no datamodule's
    source) and the combined equation's
    'E1'/'E2'/'E3' give ``{"t": (n, nt), "x": (n, nx), "pde_<nt>-<nx>":
    (n, nt, nx)}``; 'B2D' (2D Burgers on an nx x nx grid) gives ``{"t",
    "x": (n, nx), "y": (n, nx), "dx", "dy", "dt": (n, 1),
    "pde_<nt>-<nx>": (n, nt, nx, nx)}``.  With ``n_nodes`` a 'B2D' split
    is irregular, as ``generate_2d_file(irregular=True)`` writes it: after
    each solve ``n_nodes`` nodes of the nx x nx grid are drawn from the
    same generator (``concentrated``: around a random focus point), and
    the split holds ``coords`` (n, n_nodes, 2) and ``pde_<nt>-<n_nodes>``
    (n, nt, n_nodes) in place of the grid's field."""
    if eq not in (*EQUATIONS, "Burgers"):
        raise ValueError(f"unknown equation {eq!r}")
    if n_nodes is not None and eq != "B2D":
        raise ValueError("only a 'B2D' split is irregular")
    cols: dict[str, list] = {"u": [], "x": [], "t": []}
    for _ in range(n):
        if eq == "KS":
            u, x, t = solve_ks_1d(rng, nx_fine=max(256, nx), nt_out=nt,
                                  nx_out=nx, **solver_kw)
        elif eq == "Heat":
            u, x, t = solve_heat_1d(rng, nx=nx, nt_out=nt, **solver_kw)
        elif eq == "Burgers":
            u, x, t = solve_burgers_1d(rng, nx_fine=max(256, nx), nt_out=nt,
                                       nx_out=nx, **solver_kw)
        elif eq == "B2D":
            u, x, y, t = solve_burgers_2d(rng, w_fine=max(64, nx), nt_out=nt,
                                          w_out=nx, **solver_kw)
            cols.setdefault("y", []).append(y)
            if n_nodes is not None:
                sel, coords = irregular_nodes(rng, x, y, n_nodes,
                                               concentrated)
                cols.setdefault("coords", []).append(coords)
                u = u.reshape(nt, -1)[:, sel]
        else:
            u, x, t = solve_combined_1d(
                rng, eq=eq, nx_fine=nx * max(8, -(-256 // nx)), nt_out=nt,
                nx_out=nx, **solver_kw)
        for k, v in (("u", u), ("x", x), ("t", t)):
            cols[k].append(v)
    out = {k: np.stack(v) for k, v in cols.items()}
    out[f"pde_{nt}-{nx if n_nodes is None else n_nodes}"] = out.pop("u")
    if eq == "B2D":
        # the FNO-2D reader's spacings, one row per trajectory, from the
        # first trajectory as the file writer takes them
        out["dx"] = np.full((n, 1), float(out["x"][0, 1] - out["x"][0, 0]),
                            np.float32)
        out["dy"] = out["dx"].copy()
        out["dt"] = np.full((n, 1), float(out["t"][0, 1] - out["t"][0, 0]),
                            np.float32)
    return out


SPLITS_1D = ("train", "valid", "test")


def _write(path, groups: dict) -> str:
    """An HDF5 file of one group per split, each array a dataset."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for mode, arrays in groups.items():
            g = f.create_group(mode)
            for k, v in arrays.items():
                g.create_dataset(k, data=v)
    return path


def generate_1d_file(
    path, n_train=16, n_valid=4, n_test=4, nt=250, nx=50, seed=0, t_end=2.0,
    nu=0.05, eq=None, n_steps=4000,
):
    """Write a 1D HDF5 file in the reference schema (CE_* layout): groups
    train, valid, test, each with ``pde_<nt>-<nx>``, ``x`` and ``t``.

    ``eq`` None keeps the fast plain-Burgers generator (unit tests);
    'E1'/'E2'/'E3' uses the combined-equation solver; 'KS' / 'Heat' produce
    the Kuramoto-Sivashinsky train and heat-equation transfer-test sets of
    the 1D implicit protocol.  One generator seeded ``seed`` draws the
    three splits in turn."""
    rng = np.random.default_rng(seed)
    kw = ({"t_end": t_end, "nu": nu} if eq is None else
          {} if eq in ("KS", "Heat") else {"n_steps": n_steps})
    return _write(path, {mode: draw_split(rng, eq or "Burgers", n, nt, nx,
                                          **kw)
                         for mode, n in zip(SPLITS_1D,
                                            (n_train, n_valid, n_test))})


def generate_ce_suite(
    root,
    eq: str = "E1",
    n_train=64,
    n_valid=16,
    n_test=16,
    nt=250,
    resolutions=(50, 100, 200, 40),
    train_resolution=50,
    irregular_nodes=(),
    nx_fine=400,
    seed=0,
    n_steps=4000,
):
    """The E1/E2/E3 dataset tree of the combined-equation solver.

    Writes, under ``root`` (e.g. data/1d/E1):
      regular/CE_train_{eq}_{train_resolution}.h5   (train+valid+test groups)
      regular/CE_test_{eq}_{r}.h5 for every r in resolutions
      irregular/CE_train_{eq}_graph_{n}.h5 for n in irregular_nodes
    Every resolution of a split is a downsampling of the SAME fine solves,
    so zero-shot super-resolution evaluation compares identical
    trajectories across resolutions.  Returns the paths written."""
    rng = np.random.default_rng(seed)
    splits = {}
    for mode, n in zip(SPLITS_1D, (n_train, n_valid, n_test)):
        splits[mode] = [solve_combined_1d(rng, eq=eq, nx_fine=nx_fine,
                                          nt_out=nt, nx_out=nx_fine,
                                          n_steps=n_steps)
                        for _ in range(n)]

    def down(u, x, nx_out):
        stride = nx_fine // nx_out
        return u[:, ::stride][:, :nx_out], x[::stride][:nx_out]

    def write(path, groups, nx_out, irregular_n=None):
        arrays = {}
        for mode, sols in groups.items():
            us, xs, ts = [], [], []
            for u, x, t in sols:
                if irregular_n is not None:
                    sel = np.sort(rng.choice(nx_fine, irregular_n,
                                             replace=False))
                    us.append(u[:, sel])
                    xs.append(x[sel])
                else:
                    ud, xd = down(u, x, nx_out)
                    us.append(ud)
                    xs.append(xd)
                ts.append(t)
            tag = irregular_n if irregular_n is not None else nx_out
            arrays[mode] = {f"pde_{nt}-{tag}": np.stack(us),
                            "x": np.stack(xs), "t": np.stack(ts)}
        return _write(path, arrays)

    out = [write(os.path.join(root, "regular",
                              f"CE_train_{eq}_{train_resolution}.h5"),
                 splits, train_resolution)]
    for r in resolutions:
        out.append(write(
            os.path.join(root, "regular", f"CE_test_{eq}_{r}.h5"),
            {"train": splits["test"], "valid": splits["valid"],
             "test": splits["test"]}, r))
    for n_nodes in irregular_nodes:
        out.append(write(
            os.path.join(root, "irregular",
                         f"CE_train_{eq}_graph_{n_nodes}.h5"),
            splits, None, irregular_n=n_nodes))
    return out


def generate_2d_file(
    path,
    n_train=8,
    n_valid=2,
    n_test=2,
    nt=50,
    res=32,
    seed=0,
    t_end=1.0,
    nu=0.02,
    irregular=False,
    n_nodes=None,
    concentrated=False,
):
    """Write a 2D HDF5 file in the reference schema: groups train, valid,
    test, each with ``pde_<nt>-<res>``, the per-dimension coordinates ``x``,
    ``y``, ``t`` and the FNO reader's ``dx``, ``dy``, ``dt``.  ``irregular``
    keeps ``n_nodes`` (default res² / 2) random nodes of each solve's grid
    (``concentrated``: around a random focus point), stored as ``coords``
    with ``pde_<nt>-<n_nodes>`` (n, nt, n_nodes).  One generator seeded
    ``seed`` draws the three splits in turn."""
    rng = np.random.default_rng(seed)
    nodes = (n_nodes or res * res // 2) if irregular else None
    groups = {}
    for mode, n in zip(SPLITS_1D, (n_train, n_valid, n_test)):
        arrays = draw_split(rng, "B2D", n, nt, res, nodes, concentrated,
                            t_end=t_end, nu=nu)
        if irregular and n_nodes is None:
            # the key names the n_nodes argument, as the writer's does
            arrays[f"pde_{nt}-None"] = arrays.pop(f"pde_{nt}-{nodes}")
        groups[mode] = arrays
    return _write(path, groups)


def generate_suite(root: str = "data") -> None:
    """The synthetic dataset suite of ``scripts/gen_synthetic_data.sh``,
    under ``root``: the E3 headline file, KS train/valid and the Heat test
    split, the Burgers-2D B1 and B2 files, the irregular 2D meshes, and
    (unless ``GEN_CE_SUITE=0``) the E1/E2/E3 trees."""
    d = lambda *parts: os.path.join(root, *parts)  # noqa: E731
    generate_1d_file(d("CE_train_E3.h5"), n_train=64, n_valid=16, n_test=16,
                     nt=250, nx=50, seed=0, eq="E3")
    generate_1d_file(d("KS_train.h5"), n_train=256, n_valid=32, n_test=32,
                     nt=128, nx=256, seed=1, eq="KS")
    generate_1d_file(d("Heat_test.h5"), n_train=8, n_valid=16, n_test=16,
                     nt=256, nx=256, seed=21, eq="Heat")
    for name, kw in (
            ("B1/burgers_train_B1_64.h5",
             dict(n_train=32, n_valid=8, n_test=8, res=64, seed=2)),
            ("B1/burgers_train_B1_32.h5",
             dict(n_train=32, n_valid=8, n_test=8, res=32, seed=9)),
            ("B1/burgers_test_B1_32.h5",
             dict(n_train=8, n_valid=8, n_test=8, res=32, seed=3)),
            ("B1/burgers_test_B1_64.h5",
             dict(n_train=8, n_valid=8, n_test=8, res=64, seed=5)),
            ("B2/burgers_train_B2_64.h5",
             dict(n_train=32, n_valid=8, n_test=8, res=64, seed=6, nu=0.05)),
            ("B2/burgers_test_B2_64.h5",
             dict(n_train=8, n_valid=8, n_test=8, res=64, seed=7, nu=0.05))):
        generate_2d_file(d(name), nt=50, **kw)
    for i, n_nodes in enumerate([64, 128, 256, 512]):
        for kind, seed, extra in (("uniform", 4, {}),
                                  ("concentrated", 5, {"concentrated": True})):
            generate_2d_file(
                d("B1", kind, f"burgers_train_irregular_B1_{n_nodes}.h5"),
                n_train=32, n_valid=8, n_test=8, nt=50, res=64,
                seed=seed + 10 * i, irregular=True, n_nodes=n_nodes, **extra)
    if os.environ.get("GEN_CE_SUITE", "1") != "0":
        generate_ce_suite(d("1d", "E1"), eq="E1", seed=10,
                          irregular_nodes=(30, 50, 70))
        generate_ce_suite(d("1d", "E2"), eq="E2", seed=11)
        generate_ce_suite(d("1d", "E3"), eq="E3", seed=12)
    # each file holds train/valid/test groups; the separate-file layout by
    # copies
    shutil.copy(d("CE_train_E3.h5"), d("CE_valid_E3.h5"))
    shutil.copy(d("CE_train_E3.h5"), d("CE_test_E3.h5"))
    shutil.copy(d("KS_train.h5"), d("KS_valid.h5"))
    print(f"synthetic data suite written to {root}/")


if __name__ == "__main__":
    generate_suite(*sys.argv[1:2])
