"""Hyperparameter sweep (counterpart of the repo's ``tune.py``).

Runs ``sweep.n_trials`` trials; each samples overrides from ``--space``
(key=low:high[:log|int] specs), trains through ``magnet_tpu_torch.run.
main`` in a work directory of its own (``name=<name>_trial<k>``), and
reports the best checkpoint's ``val_mae_loss``.  Sampling is the repo's
Tree-structured Parzen Estimator (``TPESampler``, plain numpy, a copy that
gives its suggestions exactly for the same space, seed and observations):
after ``n_startup`` random trials, each dimension fits "good" (top-γ
quantile) and "bad" Parzen mixtures over the observed values and proposes
the candidate maximizing l(x)/g(x) among draws from the good mixture
(Bergstra et al. 2011).  One JSON line a trial, then the best one.

On the card, a space over a kernel width (``latent_dim``, ``mlp_hidden`` of
the GraphNet models, ``hidden_features`` of MPNN) is checked against the
widths the CUDA kernels are compiled for before the first trial: a value
outside them raises and names them.  ``device=cpu`` takes any width (the
kernels' plain versions).

Usage (on the card; ``device=cpu`` runs the plain PyTorch path):
  python -m magnet_tpu_torch.tune model=magnet_cnn \\
      datamodule.source=synthetic_ks trainer.max_epochs=1 sweep.n_trials=2 \\
      --space model.params.lr=1e-4:1e-2:log
"""
from __future__ import annotations

import itertools
import json
import sys

import numpy as np
import torch

from magnet_tpu_torch.config import compose


def parse_space(specs: list[str]):
    space = {}
    for s in specs:
        key, rng = s.split("=", 1)
        parts = rng.split(":")
        lo, hi = float(parts[0]), float(parts[1])
        kind = parts[2] if len(parts) > 2 else "linear"
        space[key] = (lo, hi, kind)
    return space


class TPESampler:
    """Independent per-dimension TPE (Optuna's default mode).

    Internal space: log dims are sampled in ln-space, int dims as continuous
    then rounded.  Each Parzen mixture is a sum of truncated normals centered
    at the observations plus one wide prior component spanning the range.
    """

    def __init__(self, space, seed, n_startup=5, gamma=0.25, n_candidates=24):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.obs_x: list[dict] = []   # internal-space params per trial
        self.obs_y: list[float] = []

    def _bounds(self, key):
        lo, hi, kind = self.space[key]
        if kind == "log":
            return np.log(lo), np.log(hi), kind
        return float(lo), float(hi), kind

    def _externalize(self, key, v):
        lo, hi, kind = self.space[key]
        if kind == "log":
            return float(np.clip(np.exp(v), lo, hi))
        if kind == "int":
            return int(np.clip(round(v), int(lo), int(hi)))
        return float(np.clip(v, lo, hi))

    def _random_point(self):
        return {
            k: self.rng.uniform(*self._bounds(k)[:2]) for k in self.space
        }

    @staticmethod
    def _mixture_logpdf(x, centers, sigmas, lo, hi):
        """log density at x of the equal-weight truncated-normal mixture."""
        from math import erf, sqrt

        def ncdf(z):
            return 0.5 * (1.0 + erf(z / sqrt(2.0)))

        comps = []
        for c, s in zip(centers, sigmas):
            z = (x - c) / s
            norm = ncdf((hi - c) / s) - ncdf((lo - c) / s)
            comps.append(-0.5 * z * z - np.log(s) - np.log(max(norm, 1e-12)))
        m = max(comps)
        return m + np.log(sum(np.exp(c - m) for c in comps)) - np.log(len(comps))

    def _parzen(self, key, values):
        """Centers + bandwidths for one dimension's observations, with a
        range-wide prior component (keeps exploration alive).  Bandwidths
        follow Bergstra et al. 2011: each center's sigma is the max distance
        to its sorted neighbors, clipped to [width/min(100,n), width]."""
        lo, hi, _ = self._bounds(key)
        width = hi - lo
        centers = sorted(values) + [(lo + hi) / 2.0]
        n = len(centers)
        lo_bw = width / min(100.0, max(n, 2.0))
        sigmas = []
        srt = centers[:-1]
        for i, c in enumerate(srt):
            left = srt[i - 1] if i > 0 else lo
            right = srt[i + 1] if i + 1 < len(srt) else hi
            sigmas.append(float(np.clip(max(c - left, right - c), lo_bw, width)))
        sigmas.append(width)  # prior component is wide
        return centers, sigmas, lo, hi

    def suggest(self):
        if len(self.obs_y) < self.n_startup:
            xi = self._random_point()
        else:
            order = np.argsort(self.obs_y)
            n_good = max(1, int(np.ceil(self.gamma * len(self.obs_y))))
            good = [self.obs_x[i] for i in order[:n_good]]
            bad = [self.obs_x[i] for i in order[n_good:]] or good
            xi = {}
            for k in self.space:
                gc, gs, lo, hi = self._parzen(k, [p[k] for p in good])
                bc, bs, _, _ = self._parzen(k, [p[k] for p in bad])
                # draw candidates from the good mixture, truncated to range
                best_x, best_score = None, -np.inf
                for _ in range(self.n_candidates):
                    i = self.rng.integers(len(gc))
                    x = float(
                        np.clip(self.rng.normal(gc[i], gs[i]), lo, hi)
                    )
                    score = self._mixture_logpdf(
                        x, gc, gs, lo, hi
                    ) - self._mixture_logpdf(x, bc, bs, lo, hi)
                    if score > best_score:
                        best_x, best_score = x, score
                xi[k] = best_x
        self._pending = xi
        return {k: self._externalize(k, v) for k, v in xi.items()}

    def observe(self, value):
        self.obs_x.append(self._pending)
        self.obs_y.append(float(value))


#: the hyperparameters that set a CUDA kernel's widths, by model: the
#: GraphNet edge kernels' (latent C, hidden H), MPNN's hidden width
WIDTH_KEYS = {**{name: ("latent_dim", "mlp_hidden")
                 for name in ("magnet_cnn", "magnet_cnn_2d", "magnet_gnn")},
              "mpnn": ("hidden_features",), "mpnn_2d": ("hidden_features",)}


def kernel_builds(model_name: str) -> set:
    """The width tuples (``WIDTH_KEYS`` order) ``model_name``'s kernels are
    compiled for: for a GraphNet model the (C, H) that every entry (fold,
    pregathered, pe, each in f32 and bf16) is built for."""
    from magnet_tpu_torch.ops import fused_edge, mpnn_edge

    if model_name.startswith("mpnn"):
        return {(h,) for h in mpnn_edge.KERNEL_WIDTHS}
    builds = None
    for entry, widths in fused_edge.KERNEL_WIDTHS.items():
        pairs = {(w[-1], w[-2]) for w in widths
                 if not entry.startswith("fold") or w[0] == w[-1]}
        builds = pairs if builds is None else builds & pairs
    return builds


def check_widths(cfg: dict, space: dict) -> None:
    """On the card, raise unless every value ``space`` can give a width key
    of the model (``WIDTH_KEYS``), with the config's other widths, is a
    compiled build; a range of more than one value is such a space."""
    keys = WIDTH_KEYS.get(cfg["model_name"])
    if keys is None or torch.device(cfg["device"]).type == "cpu":
        return
    builds = kernel_builds(cfg["model_name"])
    values = []
    for key in keys:
        spec = next((v for k, v in space.items()
                     if k.removeprefix("model.").removeprefix("params.")
                     == key), None)
        if spec is None:
            values.append([cfg["model"][key]])
        elif spec[0] == spec[1]:
            values.append([int(spec[0])])
        else:
            raise ValueError(
                f"--space sweeps {key} over [{spec[0]}, {spec[1]}], but "
                f"{cfg['model_name']}'s CUDA kernels are compiled for "
                f"{keys} in {sorted(builds)} only")
    for combo in itertools.product(*values):
        if combo not in builds:
            raise ValueError(
                f"{cfg['model_name']}'s CUDA kernels are compiled for {keys} "
                f"in {sorted(builds)}, not {combo}")


def split_space(argv: list[str]) -> tuple[list[str], list[str]]:
    """Take ``--space spec ...`` out of ``argv``: (the specs, the rest)."""
    argv = list(argv)
    specs = []
    if "--space" in argv:
        i = argv.index("--space")
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--") and "=" in argv[j]:
            specs.append(argv[j])
            j += 1
        del argv[i:j]
    return specs, argv


def main(argv=None) -> dict:
    """The sweep of ``argv`` (``sys.argv[1:]`` when None): prints one JSON
    line a trial and the best one; returns the trial lines, the best one
    and each trial's work directory."""
    from magnet_tpu_torch import run as run_mod

    specs, argv = split_space(sys.argv[1:] if argv is None else argv)
    space = parse_space(specs)
    base_cfg = compose(argv)
    sweep = base_cfg["sweep"]
    if sweep["direction"] != "minimize":
        raise ValueError(f"sweep.direction must be minimize (the best "
                         f"checkpoint's {sweep['metric']}), got "
                         f"{sweep['direction']!r}")
    check_widths(base_cfg, space)
    n_trials, metric = int(sweep["n_trials"]), sweep["metric"]

    sampler = TPESampler(space, seed=int(base_cfg["seed"]))
    results, workdirs = [], []
    best = (float("inf"), None)
    for trial in range(n_trials):
        trial_overrides = sampler.suggest()
        ov = argv + [f"{k}={v}" for k, v in trial_overrides.items()] + [
            f"name={base_cfg['name']}_trial{trial}"]
        trainer = run_mod.main(ov)
        val = trainer.ckpt.best
        sampler.observe(val)
        results.append({"trial": trial, "overrides": trial_overrides,
                        metric: val})
        workdirs.append(trainer.workdir)
        if val < best[0]:
            best = (val, trial_overrides)
        print(json.dumps(results[-1]), flush=True)
    best_line = {"best_value": best[0], "best_overrides": best[1]}
    print(json.dumps(best_line), flush=True)
    return {"trials": results, "best": best_line, "workdirs": workdirs}


if __name__ == "__main__":
    main()
