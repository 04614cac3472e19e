"""Run a function on N ranks of one process group: the multi-rank
launcher of the tests and of ``chip_smoke.py`` (torchrun is the users').

``run_ranks(fn, world, args)`` spawns ``world`` processes, each of which
joins a process group by a file rendezvous in a fresh temporary directory
(no TCP port, so concurrent launches never meet), calls ``fn(rank, world,
*args)`` and hands its result back through that directory.  The group and
the join share one timeout, so a hang fails the call instead of holding
it.  A rank's exception is raised again in the caller.  ``fn`` must be a
top-level function of a module that imports torch but no JAX: every rank
imports that module anew.
"""
from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from magnet_tpu_torch.parallel.mesh import backend_of

#: seconds a launch may take, the group's timeout too
TIMEOUT_S = 60


def _rank_main(rank, fn, world, args, device, tmp, timeout_s):
    # f32 throughout, as the entry points set it; the host's cores shared
    # by the ranks (torchrun likewise starts each with few threads), and a
    # gloo rank's work is small: one thread
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1)
                                         // (2 * world))))
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend_of(device), init_method=f"file://{tmp}/rendezvous",
        rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), device="cpu",
              timeout_s: float = TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks over gloo
    (``device`` cpu) or NCCL (cuda, rank r on card r); returns each rank's
    result in rank order.  Raises the first failure of a rank, and
    ``TimeoutError`` (the ranks killed) when they have not all finished
    within ``timeout_s`` seconds."""
    with tempfile.TemporaryDirectory(prefix="magnet_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, args, str(device), tmp, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} did "
                                       f"not finish in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


# ---- rank functions (``run_ranks``' fn) ----------------------------------


def _rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    return torch.device("cuda", rank) if device.type == "cuda" else device


def _model(spec: dict, device):
    from magnet_tpu_torch.models.factory import create_model

    model = create_model(spec["model"], spec["hp"], device=device,
                         kind=spec.get("kind"))
    if spec.get("state") is not None:
        model.load_state_dict(spec["state"])
    return model


def loss_rank(rank: int, world: int, cases: list) -> list:
    """On a graph axis of all ``world`` ranks, for each case: model
    ``case["model"]`` (``hp``, ``kind``, weights ``state``) takes
    ``case["batch"]``'s training loss over its partitioned graph
    (``halo``), every parameter's gradient summed over the ranks and
    divided by their number (as the trainer reduces them), and the
    validation loss.  Returns, for each case, the losses, the gradients
    (numpy, by parameter name) and each shard's lane and edge count."""
    from magnet_tpu_torch.parallel.mesh import make_mesh
    from magnet_tpu_torch.train.trainer import all_reduce_mean
    from magnet_tpu_torch.utils import to_device

    device = _rank_device(cases[0].get("device", "cpu"), rank)
    mesh = make_mesh(1, world, device)
    out = []
    for case in cases:
        model = _model(case, device)
        batch = to_device(case["batch"], device)
        pg = model.build_graph_partitioned(batch, world, halo=case["halo"],
                                           axis=mesh.graph_axis())
        model.train()
        loss, metrics = model.loss_partitioned(batch, pg, train=True)
        loss.backward()
        params = list(model.named_parameters())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for _, p in params]
        all_reduce_mean(grads, world)
        model.eval()
        val, val_metrics = model.loss_partitioned(batch, pg, train=False)
        parts = (pg.lr, pg.all) if hasattr(pg, "nbr") else (pg,)
        out.append({
            "loss": loss.item(), "mae_loss": metrics["mae_loss"].item(),
            "val_loss": val.item(),
            "val_mae_loss": val_metrics["mae_loss"].item(),
            "grads": {n: g.cpu().numpy() for (n, _), g in zip(params, grads)},
            "lanes": [p.lanes() for p in parts],
            "edges": [p.edge_counts() for p in parts]})
    return out


def fit_rank(rank: int, world: int, spec: dict) -> dict:
    """``Trainer.fit`` of ``spec["model"]`` (weights ``state``) on
    ``spec["loaders"]`` over a mesh of dp = ``spec["dp"]`` x graph =
    ``world / dp`` ranks (``halo``), ``max_epochs`` epochs, in
    ``workdir`` (rank 0 writes there).  Returns the final weights and the
    last step's reduced gradients (numpy), and whether this rank wrote."""
    from magnet_tpu_torch.parallel.mesh import make_mesh
    from magnet_tpu_torch.train.trainer import Trainer

    device = _rank_device(spec.get("device", "cpu"), rank)
    dp = spec["dp"]
    mesh = make_mesh(dp, world // dp, device)
    model = _model(spec, device)
    trainer = Trainer(model, max_epochs=spec["max_epochs"],
                      lr=spec.get("lr", 1e-3), workdir=spec["workdir"],
                      device=device, mesh=mesh, graph_shards=mesh.graph,
                      graph_halo=spec.get("halo", False))
    trainer.fit(spec["loaders"]["train"], spec["loaders"].get("val"))
    return {"state": {k: v.cpu().numpy()
                      for k, v in model.state_dict().items()},
            "grads": {k: p.grad.cpu().numpy()
                      for k, p in model.named_parameters()},
            "metrics_written": trainer.writer}
