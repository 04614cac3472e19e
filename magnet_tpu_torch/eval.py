"""Evaluation: no-teacher-forcing rollout metrics on test batches made
from a seed at the shape of the model's test split (counterpart of the
repo's ``eval.py``): Heat for ``magnet_cnn`` and ``magnet_gnn``, the
combined equation for ``mpnn``, 2D Burgers for ``mpnn_2d`` and
``magnet_cnn_2d``.

Usage (on the card; ``device=cpu`` runs the plain PyTorch path):
  python -m magnet_tpu_torch.eval [model=magnet_cnn] [seed=0] [n_traj=16] \\
      [batch_size=16] [device=cuda] [ckpt=runs/x/checkpoints/best.pt] \\
      [model_key=value ...]

Without ``ckpt`` a fresh initialisation is evaluated.
"""
from __future__ import annotations

import json
import sys

import numpy as np

from magnet_tpu_torch.config import MODELS, parse_overrides, split_model
from magnet_tpu_torch.data.datamodule import synthetic_test_batches
from magnet_tpu_torch.models.common import nrmse
from magnet_tpu_torch.models.factory import create_model, resolve_device
from magnet_tpu_torch.train.checkpoint import load_checkpoint
from magnet_tpu_torch.utils import to_device


def evaluate(model, batches, device="cuda", return_predictions: bool = False):
    """``test_loss``, ``test_mae_loss`` (means over batches of
    ``loss(train=False)``'s metrics, which each model's ``eval_metrics``
    forms from its ``predict`` output) and ``test_nrmse`` (mean over
    batches of the primary rollout's nRMSE), from one rollout per batch.  With
    ``return_predictions`` also the list of per-batch rollouts (of a model
    whose ``predict`` returns a tuple, its first, primary output)."""
    device = resolve_device(device)
    agg: dict[str, float] = {}
    nrmse_vals, preds = [], []
    for batch in batches:
        batch = to_device(batch, device)
        graph = model.build_graph(batch)
        pred = model.predict(batch, graph)
        hr_hat = pred[0] if isinstance(pred, tuple) else pred
        _, metrics = model.eval_metrics(batch, pred)
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
    name, argv = split_model(list(sys.argv[1:] if argv is None else argv))
    run_keys = {"seed": 0, "n_traj": 16, "batch_size": 16, "device": "cuda",
                "ckpt": ""}
    run = parse_overrides(
        [a for a in argv if a.split("=")[0] in run_keys], run_keys)
    hp = parse_overrides(
        [a for a in argv if a.split("=")[0] not in run_keys], MODELS[name][0])
    model = create_model(name, hp, device=run["device"], seed=run["seed"])
    if run["ckpt"]:
        state, _ = load_checkpoint(run["ckpt"], require=("model",))
        model.load_state_dict(state["model"])
    batches = synthetic_test_batches(name, run["n_traj"], run["batch_size"],
                                     seed=run["seed"])
    out = evaluate(model, batches, run["device"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
