"""Training entry point (counterpart of the repo's ``run.py``).

Usage (on the card; ``device=cpu`` runs the plain PyTorch path):
  python -m magnet_tpu_torch.run \\
      [model=magnet_cnn|magnet_cnn_2d|mpnn|mpnn_2d|magnet_gnn] \\
      [datamodule.source=synthetic_ks|synthetic_ce|synthetic_burgers_2d] \\
      [model.params.lr=1e-4] [seed=21] [trainer.max_epochs=250] [name=run] \\
      [ckpt_path=.../last.pt]

Composes the config from ``magnet_tpu_torch.config`` and the overrides,
builds loaders, model and trainer, saves the config under a time-stamped
work directory, fits, and reports the best checkpoint.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from magnet_tpu_torch.config import compose
from magnet_tpu_torch.data.datamodule import build_loaders
from magnet_tpu_torch.models.factory import create_model, resolve_device
from magnet_tpu_torch.train.trainer import Trainer


def main(argv=None) -> Trainer:
    cfg = compose(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(cfg["device"])
    # f32 throughout, as the reference: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"training {cfg['model_name']} on {cfg['datamodule']['name']}",
          flush=True)

    workdir = cfg["workdir"].replace("${name}", cfg["name"])
    workdir = os.path.join(workdir, time.strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)

    loaders = build_loaders(cfg["datamodule"], seed=cfg["seed"])
    hp, tr = cfg["model"], cfg["trainer"]
    model = create_model(cfg["model_name"], hp, device=device,
                         seed=cfg["seed"])
    trainer = Trainer(
        model, max_epochs=tr["max_epochs"], lr=hp["lr"],
        weight_decay=hp["weight_decay"], factor=hp["factor"],
        step_size=hp["step_size"], patience=cfg["callbacks"]["patience"],
        workdir=workdir, device=device,
        check_val_every=tr["check_val_every"],
        skip_nonfinite=tr["skip_nonfinite"], grad_clip=tr["grad_clip"],
        save_last_every=tr["save_last_every"],
        best_weights_only=tr["best_weights_only"])
    trainer.fit(loaders["train"], loaders["val"],
                resume=cfg["ckpt_path"] or None)
    print(f"best checkpoint at {trainer.ckpt.best_path} "
          f"(val_mae_loss={trainer.ckpt.best:.6f})", flush=True)
    return trainer


if __name__ == "__main__":
    main()
