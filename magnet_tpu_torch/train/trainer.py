"""Training engine (counterpart of ``magnet_tpu/train/trainer.py``): the
train and validation steps, the epoch loop, early stopping, checkpoints
and the metric log, on one device.

A train step is ``loss(train=True)`` -> backward -> global-norm clip ->
optimizer.  Metrics stay on the device and are read once per epoch.
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

import torch

from magnet_tpu_torch.models.factory import resolve_device
from magnet_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint
from magnet_tpu_torch.train.optim import clip_grad_global_norm, make_optimizer
from magnet_tpu_torch.utils import to_device


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
                 best_weights_only: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
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
        os.makedirs(workdir, exist_ok=True)

    def state(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.optimizer.step_count}

    def train_step(self, batch) -> dict:
        """One optimizer step on a host batch; the metrics, on the device."""
        batch = to_device(batch, self.device)
        graph = self.model.build_graph(batch)
        self.optimizer.zero_grad()
        loss, metrics = self.model.loss(batch, graph, train=True)
        loss.backward()
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
            print(f"resumed from {resume} at epoch {start_epoch}", flush=True)

        stop = False
        epoch = start_epoch - 1
        for epoch in range(start_epoch, self.max_epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            pending = [self.train_step(batch) for batch in train_loader]
            tm = mean_metrics(pending)  # waits for the device
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
                    self.ckpt.update(self.state(), epoch,
                                     {"val_mae_loss": monitored})
                    stop = self.early.update(monitored)
                else:
                    print("val loader produced no batches; no checkpoint or "
                          "early-stop update this epoch", flush=True)

            with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(row) + "\n")
            print(" ".join([f"epoch {epoch}"] + [
                f"{k}={v:.5f}" for k, v in row.items() if k != "epoch"]),
                flush=True)
            if stop:
                print(f"early stopping at epoch {epoch}", flush=True)
                break

        # a final rolling checkpoint for resume even when save_last_every
        # skipped the last epoch's write; its sidecar carries that epoch's
        # metric, and none when no validation ran
        if epoch >= start_epoch and self.ckpt.last_epoch != epoch:
            meta = ({"val_mae_loss": self._last_val}
                    if self._last_val is not None else {})
            self.ckpt.save_last(self.state(), epoch, meta)
        return self.model

    def evaluate(self, loader) -> dict[str, float]:
        """Means of ``loss(train=False)``'s metrics over the loader."""
        pending = []
        for batch in loader:
            batch = to_device(batch, self.device)
            graph = self.model.build_graph(batch)
            _, metrics = self.model.loss(batch, graph, train=False)
            pending.append(metrics)
        return mean_metrics(pending)
