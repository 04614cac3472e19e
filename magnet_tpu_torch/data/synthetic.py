"""Trajectories made from a seed with numpy, no file and no ``h5py``: own
copies of ``magnet_tpu/data/synthetic.py``'s ``_initial_condition_1d``,
``solve_ks_1d`` (the training PDE of the implicit-1D protocol),
``solve_heat_1d`` (its zero-shot transfer test), ``solve_combined_1d`` with
its forcing, presets and WENO5 flux (the E1/E2/E3 sets MPNN 1D trains on)
and ``solve_burgers_2d`` (MPNN 2D's B1 set)."""
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


def make_split(eq: str, n: int, nt: int, nx: int, seed: int = 0,
               **solver_kw) -> dict:
    """``n`` trajectories of ``eq`` from ``seed`` as one split's arrays,
    the in-memory form of one group of the HDF5 schema.  'KS', 'Heat' and
    the combined equation's 'E1'/'E2'/'E3' give ``{"t": (n, nt), "x":
    (n, nx), "pde_<nt>-<nx>": (n, nt, nx)}``; 'B2D' (2D Burgers on an
    nx x nx grid) gives ``{"t", "x": (n, nx), "y": (n, nx),
    "pde_<nt>-<nx>": (n, nt, nx, nx)}``."""
    if eq not in ("KS", "Heat", "E1", "E2", "E3", "B2D"):
        raise ValueError(f"unknown equation {eq!r}")
    rng = np.random.default_rng(seed)
    cols: dict[str, list] = {"u": [], "x": [], "t": []}
    for _ in range(n):
        if eq == "KS":
            u, x, t = solve_ks_1d(rng, nx_fine=max(256, nx), nt_out=nt,
                                  nx_out=nx, **solver_kw)
        elif eq == "Heat":
            u, x, t = solve_heat_1d(rng, nx=nx, nt_out=nt, **solver_kw)
        elif eq == "B2D":
            u, x, y, t = solve_burgers_2d(rng, w_fine=max(64, nx), nt_out=nt,
                                          w_out=nx, **solver_kw)
            cols.setdefault("y", []).append(y)
        else:
            u, x, t = solve_combined_1d(
                rng, eq=eq, nx_fine=nx * max(8, -(-256 // nx)), nt_out=nt,
                nx_out=nx, **solver_kw)
        for k, v in (("u", u), ("x", x), ("t", t)):
            cols[k].append(v)
    out = {k: np.stack(v) for k, v in cols.items()}
    out[f"pde_{nt}-{nx}"] = out.pop("u")
    return out
