"""Training entry point (counterpart of the repo's ``run.py``).

Usage (on the card; ``device=cpu`` runs the plain PyTorch path):
  python -m magnet_tpu_torch.run \\
      [model=magnet_cnn|magnet_cnn_2d|mpnn|mpnn_2d|magnet_gnn|fno_1d|fno_2d|
             magnet_cnn_no_interaction] \\
      [datamodule=NAME] \\
      [datamodule.source=synthetic_ks|synthetic_ce|synthetic_burgers_2d] \\
      [model.params.lr=1e-4] [seed=21] [trainer.max_epochs=250] [name=run] \\
      [ckpt_path=.../last.pt] [model.params.remat=true] \\
      [trainer.steps_per_call=4] [trainer.precision=tensorfloat32] \\
      [datamodule.num_workers=3]

``trainer.steps_per_call=k`` runs k steps a chunk, as replays of a captured
CUDA graph where the chunk allows it (``train.trainer``);
``trainer.precision`` ``tensorfloat32`` or ``high`` lets cuBLAS and cuDNN
use TF32 (any other value: f32; the port's own kernels are not affected);
``trainer.log_every`` is accepted and read nowhere, as in the repo;
``datamodule.num_workers`` > 0 collates the batches on a prefetch thread;
``model.params.remat`` recomputes the GraphNet processors' steps in the
backward.

Data and graph parallelism, one rank a card:
  torchrun --nproc_per_node=N -m magnet_tpu_torch.run \\
      trainer.devices=D trainer.graph_shards=G \\
      [trainer.graph_halo=false|true|fused|overlap|ring] ...

with N = D x G (``trainer.devices=-1``: N / G): the batch splits over D,
each sample's graph over G (MAgNet[CNN], MAgNet[GNN], MPNN).  Any other
world size raises.  ``device=cpu`` runs the ranks on gloo.  Each
message-passing step brings the sender rows a shard reads from the others:
``false`` all-gathers the node blocks; ``true`` (and ``fused``) sends only
the halo rows, all-to-all; ``overlap`` splits each shard's edges into
interior and boundary and runs the interior edges while the all-to-all is
in flight; ``ring`` is ``overlap`` with the all-to-all as G - 1 rotations.
MPNN always all-gathers.

Composes the config from ``magnet_tpu_torch.config`` and the overrides,
builds loaders, model and trainer, saves the config under a time-stamped
work directory (rank 0's), fits, and reports the best checkpoint.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from magnet_tpu_torch.config import compose
from magnet_tpu_torch.data.datamodule import build_loaders
from magnet_tpu_torch.models.factory import create_model, resolve_device
from magnet_tpu_torch.parallel.mesh import init_distributed, make_mesh
from magnet_tpu_torch.train.trainer import Trainer
from magnet_tpu_torch.utils import set_precision


def launch_mesh(tr: dict, device):
    """The (dp, graph) mesh of this launch and this rank's device: the
    world size must be ``trainer.devices`` x ``trainer.graph_shards``."""
    world = init_distributed(device)
    graph = int(tr["graph_shards"])
    dp = int(tr["devices"])
    if dp == -1:
        dp = world // graph
    if dp * graph != world:
        raise ValueError(
            f"{world} rank(s) launched, but trainer.devices={tr['devices']} x "
            f"trainer.graph_shards={graph} asks for {dp * graph} (launch "
            f"with torchrun --nproc_per_node={dp * graph})")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return make_mesh(dp, graph, device), device


def main(argv=None) -> Trainer:
    cfg = compose(list(sys.argv[1:] if argv is None else argv))
    tr = cfg["trainer"]
    own_group = not dist.is_initialized()
    mesh, device = launch_mesh(tr, resolve_device(cfg["device"]))
    # f32 in matmuls and convolutions, as the reference, unless
    # trainer.precision asks for TF32
    set_precision(tr["precision"])
    if mesh.rank == 0:
        print(f"training {cfg['model_name']} on {cfg['datamodule']['name']} "
              f"(dp={mesh.dp}, graph={mesh.graph})", flush=True)

    workdir = cfg["workdir"].replace("${name}", cfg["name"])
    workdir = [os.path.join(workdir, time.strftime("%Y-%m-%d_%H-%M-%S"))]
    if mesh.world > 1:
        dist.broadcast_object_list(workdir, src=0)
    workdir = workdir[0]
    if mesh.rank == 0:
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)

    loaders = build_loaders(cfg["datamodule"], seed=cfg["seed"])
    hp = cfg["model"]
    model = create_model(cfg["model_name"], hp, device=device,
                         seed=cfg["seed"], kind=cfg["datamodule"]["kind"])
    trainer = Trainer(
        model, max_epochs=tr["max_epochs"], lr=hp["lr"],
        weight_decay=hp["weight_decay"], factor=hp["factor"],
        step_size=hp["step_size"], patience=cfg["callbacks"]["patience"],
        workdir=workdir, device=device,
        check_val_every=tr["check_val_every"],
        skip_nonfinite=tr["skip_nonfinite"], grad_clip=tr["grad_clip"],
        save_last_every=tr["save_last_every"],
        best_weights_only=tr["best_weights_only"],
        mesh=mesh if mesh.world > 1 else None,
        graph_shards=mesh.graph, graph_halo=tr["graph_halo"],
        steps_per_call=tr["steps_per_call"], log_every=tr["log_every"])
    trainer.fit(loaders["train"], loaders["val"],
                resume=cfg["ckpt_path"] or None)
    if mesh.rank == 0:
        print(f"best checkpoint at {trainer.ckpt.best_path} "
              f"(val_mae_loss={trainer.ckpt.best:.6f})", flush=True)
    if own_group and dist.is_initialized():
        dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
