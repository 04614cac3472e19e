"""FNO 1D/2D, the paper's baselines (counterpart of ``magnet_tpu/models/
fno.py:20-218``): the lift (u ‖ dx ‖ dt, plus dy in 2D) through ``fc0`` to
``width`` channels, ``num_layers`` x [spectral convolution ⊕ 1x1
convolution] each followed by the exact-erf GELU, then ``fc1`` (128) with
GELU and ``fc2`` to ``time_future`` steps; the autoregressive rollout over
windows of ``time_history`` steps with teacher forcing.

Submodule names are the reference's (``fc0``, ``fourier_layers.{i}``,
``conv_layers.{i}``, ``fc1``, ``fc2``), so the state_dict keys are too.
FNO runs no kernel of its own: its FFTs and complex channel products are
``torch.fft`` and ``torch.einsum``, as the JAX package's are XLA's.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.nn.functional import gelu

from magnet_tpu_torch.models.common import LOSSES, l1_loss
from magnet_tpu_torch.nn.spectral import SpectralConv1d, SpectralConv2d


class _FNO(nn.Module):
    """The layers and the task side shared by both dimensions.  ``ndim``
    is the number of space axes; the batch holds ``u`` (B, nt, *space) and
    the spacings ``dx``, ``dt`` (and ``dy`` in 2D), each (B,)."""

    ndim = 1
    spacings = ("dx", "dt")

    def __init__(self, hparams: dict[str, Any], modes: tuple,
                 time_history: int, time_future: int):
        super().__init__()
        hp = dict(hparams)
        self.time_history = int(hp.get("time_history", time_history))
        self.time_future = int(hp.get("time_future", time_future))
        # each window's prediction is the next window's input
        # (magnet_tpu/models/fno.py:96-104)
        if self.time_history != self.time_future:
            raise ValueError(
                "FNO autoregressive rollout requires time_history == "
                f"time_future (got {self.time_history} != "
                f"{self.time_future}): each window's prediction becomes the "
                "next window's input.")
        self.teacher_forcing = bool(hp.get("teacher_forcing", True))
        self.criterion = LOSSES[hp.get("loss", "l1")]
        width = int(hp.get("width", 256))
        n_layers = int(hp.get("num_layers", 5))
        conv = {1: nn.Conv1d, 2: nn.Conv2d}[self.ndim]
        spectral = {1: SpectralConv1d, 2: SpectralConv2d}[self.ndim]
        self.fc0 = nn.Linear(self.time_history + len(self.spacings), width)
        self.fourier_layers = nn.ModuleList(
            spectral(width, width, *modes) for _ in range(n_layers))
        self.conv_layers = nn.ModuleList(
            conv(width, width, 1) for _ in range(n_layers))
        self.fc1 = nn.Linear(width, 128)
        self.fc2 = nn.Linear(128, self.time_future)

    def forward(self, u, *spacing):
        """u (B, *space, time_history) and the batch's spacings, each (B,)
        -> (B, *space, time_future)."""
        ones = (-1,) + (1,) * (self.ndim + 1)
        x = torch.cat([u] + [s.reshape(ones).expand(*u.shape[:-1], 1)
                             for s in spacing], dim=-1)
        x = self.fc0(x).movedim(-1, 1)                         # (B, W, *space)
        for spec, conv in zip(self.fourier_layers, self.conv_layers):
            x = gelu(spec(x) + conv(x))
        x = gelu(self.fc1(x.movedim(1, -1)))
        return self.fc2(x)

    def build_graph(self, batch):
        return None

    def _rollout(self, batch, teacher_forcing: bool):
        """One forward per window; the next window's input is the ground
        truth (``teacher_forcing``) or this window's prediction.  Returns
        (B, n_win * time_future, *space)."""
        u = batch["u"]
        th, tf = self.time_history, self.time_future
        n_win = (u.shape[1] - th) // tf
        spacing = [batch[k] for k in self.spacings]
        inp, outs = u[:, :th], []
        for w in range(n_win):
            y = self(inp.movedim(1, -1), *spacing).movedim(-1, 1)
            inp = u[:, th + w * tf:th + (w + 1) * tf] if teacher_forcing else y
            outs.append(y)
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def predict(self, batch, graph=None):
        """The no-teacher-forcing rollout."""
        return self._rollout(batch, teacher_forcing=False)

    def rollout_target(self, batch, horizon: int):
        """Ground truth of the rollout: ``u`` shifted by ``time_history``."""
        th = self.time_history
        return batch["u"][:, th:th + horizon]

    def eval_metrics(self, batch, pred):
        """``loss(train=False)``'s metrics from ``predict``'s output."""
        target = self.rollout_target(batch, pred.shape[1])
        loss = self.criterion(pred, target)
        return loss, {"loss": loss, "mae_loss": l1_loss(pred, target)}

    def loss(self, batch, graph=None, train: bool = True):
        """``train``: the criterion on the rollout with teacher forcing as
        configured; otherwise the eval loss of the no-teacher-forcing
        rollout, under ``no_grad``."""
        if not train:
            return self.eval_metrics(batch, self.predict(batch))
        return self.eval_metrics(batch, self._rollout(batch,
                                                      self.teacher_forcing))


class FNO1D(_FNO):
    """Batch: u (B, nt, L), dx (B,), dt (B,)."""

    def __init__(self, hparams: dict[str, Any]):
        super().__init__(hparams, (int(hparams.get("modes", 12)),), 25, 25)


class FNO2D(_FNO):
    """Batch: u (B, nt, H, W), dx, dy, dt (B,); time_history and
    time_future 10 by default (``magnet_tpu/models/fno.py:184-188``)."""

    ndim = 2
    spacings = ("dx", "dy", "dt")

    def __init__(self, hparams: dict[str, Any]):
        super().__init__(hparams, (int(hparams.get("modes_1", 12)),
                                   int(hparams.get("modes_2", 12))), 10, 10)
