"""Checkpoints with best/last policies and resume (counterpart of
``magnet_tpu/train/checkpoint.py``).

Format: ``torch.save`` of ``{"model", "optimizer", "step"}`` (a weights-only
``best`` holds ``{"model"}``) and a JSON sidecar with the epoch and the
monitored metric.  Files are read with ``weights_only=True``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch


def save_checkpoint(path: str, state: dict[str, Any], meta: dict[str, Any]):
    """Atomic write: a run killed mid-write must not leave a truncated file
    where the last good checkpoint was.  Both files are written beside
    their targets and moved into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def load_checkpoint(path: str, require: tuple[str, ...] = ()):
    """Returns (state, meta).  ``require`` names the keys the caller will
    restore from; a sidecar that is missing or truncated gives empty meta."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    missing = sorted(set(require) - set(state))
    if missing:
        raise ValueError(
            f"checkpoint {path} lacks {missing} (it holds {sorted(state)}). "
            "If it was written with best_weights_only=true, resume from the "
            "rolling last.pt instead.")
    meta = {}
    if os.path.exists(path + ".json"):
        try:
            with open(path + ".json") as f:
                meta = json.load(f)
        except ValueError:
            meta = {}
    return state, meta


class CheckpointManager:
    """``best`` (lowest monitored metric) and a rolling ``last``.

    ``last_every``: write ``last`` only every K calls of ``update`` (the
    trainer writes a final ``last`` on exit whatever K is).  When ``best``
    improves on a call where ``last`` is due too, ``last`` is a file copy
    of ``best``.  ``best_weights_only``: ``best`` keeps only the model's
    weights, what eval needs; ``last`` always keeps the full state.
    """

    def __init__(self, dirpath: str, monitor: str = "val_mae_loss",
                 last_every: int = 1, best_weights_only: bool = False):
        self.monitor = monitor
        self.last_every = max(1, int(last_every))
        self.best_weights_only = bool(best_weights_only)
        self.best = float("inf")
        self.best_path = os.path.join(dirpath, "best.pt")
        self.last_path = os.path.join(dirpath, "last.pt")
        self.last_epoch = -1
        self._updates = 0

    def _copy_best_to_last(self):
        # stage both files before publishing either, so that a kill
        # mid-copy leaves no truncated file
        shutil.copyfile(self.best_path, self.last_path + ".tmp")
        shutil.copyfile(self.best_path + ".json", self.last_path + ".json.tmp")
        os.replace(self.last_path + ".tmp", self.last_path)
        os.replace(self.last_path + ".json.tmp", self.last_path + ".json")

    def save_last(self, state: dict, epoch: int, metrics: dict):
        if self.last_epoch == epoch:
            return
        meta = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        save_checkpoint(self.last_path, state, meta)
        self.last_epoch = epoch

    def update(self, state: dict, epoch: int, metrics: dict) -> bool:
        """Record one validated epoch; True when ``best`` improved."""
        meta = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        val = float(metrics.get(self.monitor, float("inf")))
        improved = val < self.best
        if improved:
            self.best = val
            bstate = ({"model": state["model"]} if self.best_weights_only
                      else state)
            save_checkpoint(self.best_path, bstate, meta)
        self._updates += 1
        if self._updates % self.last_every == 0:
            if improved and not self.best_weights_only:
                self._copy_best_to_last()
            else:
                save_checkpoint(self.last_path, state, meta)
            self.last_epoch = epoch
        return improved
