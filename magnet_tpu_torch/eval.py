"""Evaluation: no-teacher-forcing rollout metrics on Heat test batches
(counterpart of the repo's ``eval.py``).

Usage (on the card; ``device=cpu`` runs the plain PyTorch path):
  python -m magnet_tpu_torch.eval [seed=0] [n_traj=16] [batch_size=16] \\
      [device=cuda] [magnet_cnn_key=value ...]
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from magnet_tpu_torch.config import HEAT_TEST, MAGNET_CNN, parse_overrides
from magnet_tpu_torch.data.heat import heat_batches
from magnet_tpu_torch.models.common import nrmse
from magnet_tpu_torch.models.factory import create_model, resolve_device


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def evaluate(model, batches, device="cuda", return_predictions: bool = False):
    """``test_loss``, ``test_mae_loss`` (means over batches of
    ``loss(train=False)``'s metrics) and ``test_nrmse`` (mean over batches
    of the rollout's nRMSE), from one rollout per batch.  With
    ``return_predictions`` also the list of per-batch HR rollouts."""
    device = resolve_device(device)
    agg: dict[str, float] = {}
    nrmse_vals, preds = [], []
    for batch in batches:
        batch = to_device(batch, device)
        graph = model.build_graph(batch)
        hr_hat, _ = model.predict(batch, graph)
        _, metrics = model.eval_metrics(batch, hr_hat)
        for k, v in metrics.items():
            agg[k] = agg.get(k, 0.0) + float(v)
        target = model.rollout_target(batch, int(hr_hat.shape[1]))
        nrmse_vals.append(float(nrmse(hr_hat, target)))
        if return_predictions:
            preds.append(hr_hat)
    n = max(len(nrmse_vals), 1)
    out = {f"test_{k}": v / n for k, v in agg.items()}
    out["test_nrmse"] = float(np.mean(nrmse_vals))
    return (out, preds) if return_predictions else out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    run_keys = {"seed": 0, "n_traj": 16, "batch_size": 16, "device": "cuda"}
    run = parse_overrides(
        [a for a in argv if a.split("=")[0] in run_keys], run_keys)
    hp = parse_overrides(
        [a for a in argv if a.split("=")[0] not in run_keys], MAGNET_CNN)
    model = create_model("magnet_cnn", hp, device=run["device"],
                         seed=run["seed"])
    batches = heat_batches(run["n_traj"], run["batch_size"],
                           nt=HEAT_TEST["nt"], nx=HEAT_TEST["nx"],
                           seed=run["seed"])
    out = evaluate(model, batches, run["device"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
