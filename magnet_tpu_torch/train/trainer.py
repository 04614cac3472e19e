"""Training engine (counterpart of ``magnet_tpu/train/trainer.py``): the
train and validation steps, the epoch loop, early stopping, checkpoints
and the metric log, on one device or over a (dp, graph) mesh of ranks
(``parallel.mesh``).

A train step is ``loss(train=True)`` -> backward -> global-norm clip ->
optimizer, with the model in training mode (cuDNN's LSTM takes its
backward only there); validation puts it back in eval mode.  Metrics stay
on the device and are read once per epoch.

Over a mesh (JAX ``trainer.py:65-93, 139-240``): every rank reads the same
global batch and takes its dp block (contiguous, as ``P("dp")`` splits
it; a batch that does not divide raises); with ``graph_shards`` > 1 the
ranks of a graph axis partition their block's graph
(``build_graph_partitioned``) and run the processor a shard each.  The
gradients are summed over all ranks and divided by their number (an
explicit all-reduce): the mean over dp blocks, each graph axis's ranks
counting their shared loss once.  Metrics are averaged over the ranks.
Rank 0 alone writes ``metrics.jsonl`` and the checkpoints, in the
single-process format, so a run saved on any mesh resumes on any other.
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from magnet_tpu_torch.models.factory import resolve_device
from magnet_tpu_torch.parallel.graph_partition import check_halo
from magnet_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint
from magnet_tpu_torch.train.optim import clip_grad_global_norm, make_optimizer
from magnet_tpu_torch.utils import to_device


def all_reduce_mean(tensors: list, n: int) -> None:
    """Each tensor replaced in place by its mean over the ``n`` ranks of
    the world, in one all-reduce (complex tensors as real pairs)."""
    views = [torch.view_as_real(t) if t.is_complex() else t for t in tensors]
    flat = torch.cat([v.reshape(-1) for v in views])
    dist.all_reduce(flat)
    flat /= n
    for v, part in zip(views, flat.split([v.numel() for v in views])):
        v.copy_(part.view_as(v))


def mean_metrics(pending: list[dict]) -> dict[str, float]:
    """Means over a list of per-step metric dicts of device scalars, with
    one read from the device."""
    if not pending:
        return {}
    keys = list(pending[0])
    table = torch.stack([torch.stack([m[k] for k in keys]) for m in pending])
    return dict(zip(keys, table.double().mean(0).tolist()))


class EarlyStopping:
    def __init__(self, patience: int = 35, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.patience


class Trainer:
    def __init__(self, model, max_epochs: int = 100, lr: float = 1e-3,
                 weight_decay: float = 0.0, factor: float = 0.3,
                 step_size: int = 50, patience: int = 35,
                 workdir: str = "runs/default", device="cuda",
                 check_val_every: int = 1, skip_nonfinite: bool = False,
                 grad_clip: float = 0.0, save_last_every: int = 1,
                 best_weights_only: bool = False, mesh=None,
                 graph_shards: int = 1, graph_halo=False):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh = mesh
        self.graph_shards = int(graph_shards)
        self.graph_halo = check_halo(graph_halo)
        if self.graph_shards > 1 and (mesh is None
                                      or mesh.graph != self.graph_shards):
            raise ValueError(f"graph_shards={self.graph_shards} needs a mesh "
                             f"with a graph axis of that size")
        if self.graph_shards > 1 and not hasattr(model,
                                                 "build_graph_partitioned"):
            raise ValueError(f"{type(model).__name__} has no graph-parallel "
                             f"execution path")
        self.world = 1 if mesh is None else mesh.world
        self.writer = mesh is None or mesh.rank == 0
        if mesh is not None and hasattr(model, "batch_block"):
            model.batch_block = (mesh.dp_index, mesh.dp)
        self.max_epochs = max_epochs
        self.lr, self.weight_decay = lr, weight_decay
        self.factor, self.step_size = factor, step_size
        self.workdir = workdir
        self.check_val_every = check_val_every
        self.skip_nonfinite = bool(skip_nonfinite)
        self.grad_clip = float(grad_clip)
        self.ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"),
                                      last_every=save_last_every,
                                      best_weights_only=best_weights_only)
        self.early = EarlyStopping(patience=patience)
        self.optimizer = None
        self._last_val: Optional[float] = None
        if self.writer:
            os.makedirs(workdir, exist_ok=True)

    def state(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.optimizer.step_count}

    def _local(self, batch):
        """This rank's dp block of a host batch, on its device, and the
        block's graph (partitioned over the mesh's graph axis when
        ``graph_shards`` > 1)."""
        if self.mesh is not None and self.mesh.dp > 1:
            n, i = self.mesh.dp, self.mesh.dp_index
            size = len(next(iter(batch.values())))
            if size % n:
                raise ValueError(f"a batch of {size} does not split over "
                                 f"dp={n}")
            b = size // n
            batch = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        batch = to_device(batch, self.device)
        if self.graph_shards > 1:
            return batch, self.model.build_graph_partitioned(
                batch, self.graph_shards, halo=self.graph_halo,
                axis=self.mesh.graph_axis())
        return batch, self.model.build_graph(batch)

    def _world_mean(self, metrics: dict) -> dict:
        """Host metrics averaged over the ranks."""
        if self.world == 1 or not metrics:
            return metrics
        t = torch.tensor(list(metrics.values()), dtype=torch.float64,
                         device=self.device)
        all_reduce_mean([t], self.world)
        return dict(zip(metrics, t.tolist()))

    def train_step(self, batch) -> dict:
        """One optimizer step on a host batch; the metrics, on the device."""
        batch, graph = self._local(batch)
        self.model.train()
        self.optimizer.zero_grad()
        loss, metrics = self.model.loss(batch, graph, train=True)
        loss.backward()
        if self.world > 1:
            for p in self.optimizer.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_mean([p.grad for p in self.optimizer.params],
                            self.world)
        clip_grad_global_norm(self.optimizer.params, self.grad_clip)
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def setup(self, steps_per_epoch: int) -> None:
        """Make the optimizer; its learning rate decays by epochs of
        ``steps_per_epoch`` steps."""
        self.optimizer = make_optimizer(
            self.model.parameters(), self.lr, self.weight_decay, self.factor,
            self.step_size, steps_per_epoch,
            skip_nonfinite=self.skip_nonfinite)

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            resume: Optional[str] = None):
        self.setup(len(train_loader))
        start_epoch = 0
        if resume:
            state, meta = load_checkpoint(resume, require=("model", "optimizer"))
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            start_epoch = int(meta.get("epoch", -1)) + 1
            self._print(f"resumed from {resume} at epoch {start_epoch}")

        stop = False
        epoch = start_epoch - 1
        for epoch in range(start_epoch, self.max_epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            pending = [self.train_step(batch) for batch in train_loader]
            tm = self._world_mean(mean_metrics(pending))  # waits for the device
            train_time = time.time() - t0
            row = {"epoch": epoch, "time": train_time,
                   "steps_per_s": len(pending) / max(train_time, 1e-9),
                   **{f"train_{k}": v for k, v in tm.items()}}

            if val_loader is not None and (epoch + 1) % self.check_val_every == 0:
                vm = self.evaluate(val_loader)
                row.update({f"val_{k}": v for k, v in vm.items()})
                monitored = row.get("val_mae_loss", row.get("val_loss"))
                if monitored is not None:
                    self._last_val = float(monitored)
                    if self.writer:
                        self.ckpt.update(self.state(), epoch,
                                         {"val_mae_loss": monitored})
                    stop = self.early.update(monitored)
                else:
                    self._print("val loader produced no batches; no "
                                "checkpoint or early-stop update this epoch")

            if self.writer:
                with open(os.path.join(self.workdir, "metrics.jsonl"),
                          "a") as f:
                    f.write(json.dumps(row) + "\n")
            self._print(" ".join([f"epoch {epoch}"] + [
                f"{k}={v:.5f}" for k, v in row.items() if k != "epoch"]))
            if stop:
                self._print(f"early stopping at epoch {epoch}")
                break

        # a final rolling checkpoint for resume even when save_last_every
        # skipped the last epoch's write; its sidecar carries that epoch's
        # metric, and none when no validation ran
        if (self.writer and epoch >= start_epoch
                and self.ckpt.last_epoch != epoch):
            meta = ({"val_mae_loss": self._last_val}
                    if self._last_val is not None else {})
            self.ckpt.save_last(self.state(), epoch, meta)
        return self.model

    def _print(self, text: str) -> None:
        if self.writer:
            print(text, flush=True)

    def evaluate(self, loader) -> dict[str, float]:
        """Means of ``loss(train=False)``'s metrics over the loader (and
        the ranks)."""
        self.model.eval()
        pending = []
        for batch in loader:
            batch, graph = self._local(batch)
            _, metrics = self.model.loss(batch, graph, train=False)
            pending.append(metrics)
        return self._world_mean(mean_metrics(pending))
