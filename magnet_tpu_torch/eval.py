"""Evaluation: no-teacher-forcing rollout metrics on the datamodule's test
split (counterpart of the repo's ``eval.py``).  With ``datamodule.source=
h5`` (the default) that is the file at ``datamodule.test_path``, in order;
with a synthetic source it is ``n_traj`` trajectories made from the seed at
the test split's shape: Heat for ``magnet_cnn``, ``magnet_gnn`` and
``magnet_cnn_no_interaction``, the combined equation for ``mpnn`` and
``fno_1d``, 2D Burgers for ``mpnn_2d``, ``magnet_cnn_2d`` and ``fno_2d``,
and for ``magnet_gnn`` with ``datamodule=h5_datamodule_implicit_gnn_2d``
2D Burgers on its regular 32 x 32 test grid.

Usage (on the card; ``device=cpu`` runs the plain PyTorch path):
  python -m magnet_tpu_torch.eval [model=magnet_cnn] [datamodule=NAME] \\
      [seed=0] [n_traj=16] [batch_size=16] [device=cuda] \\
      [ckpt=runs/x/checkpoints/best.pt] [datamodule.key=value ...] \\
      [model_key=value | model.model_key=value ...]

Without ``ckpt`` a fresh initialisation is evaluated.  The batch is
``min(batch_size, n)`` for a split of n trajectories (``n_traj`` of a
synthetic source; a file's test split is read whole) and a trailing
partial batch is dropped, as the repo's ``eval.py`` does.  TF32 is off in
matmuls and convolutions: f32 throughout, as in training.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from magnet_tpu_torch.config import (
    model_overrides,
    parse_overrides,
    split_datamodule,
    split_model,
    take_prefixed,
)
from magnet_tpu_torch.data.datamodule import eval_batches
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
    dm, argv = split_datamodule(name, argv)
    dm_args, argv = take_prefixed(argv, "datamodule.")
    dm = parse_overrides(dm_args, dm)
    run_keys = {"seed": 0, "n_traj": 16, "batch_size": 16, "device": "cuda",
                "ckpt": ""}
    run = parse_overrides(
        [a for a in argv if a.split("=")[0] in run_keys], run_keys)
    hp = model_overrides(name, [
        a.removeprefix("model.params.").removeprefix("model.")
        for a in argv if a.split("=")[0] not in run_keys])
    # f32 throughout, as in training: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = create_model(name, hp, device=run["device"], seed=run["seed"],
                         kind=dm["kind"])
    if run["ckpt"]:
        state, _ = load_checkpoint(run["ckpt"], require=("model",))
        model.load_state_dict(state["model"])
    batches = eval_batches(name, run["n_traj"], run["batch_size"],
                           seed=run["seed"], datamodule=dm)
    out = evaluate(model, batches, run["device"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
