"""Shared model plumbing: the losses, the ``graph_dtype`` knob, nRMSE and
time windows (counterpart of ``magnet_tpu/models/common.py:85-116,
289-295``), and a model's own random generator."""
from __future__ import annotations

import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def smooth_l1_loss(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


LOSSES = {"l1": l1_loss, "l2": l2_loss, "smooth_l1": smooth_l1_loss}


def parse_dtype(name):
    """The ``graph_dtype`` hyperparameter as a compute dtype: None,
    ``none``, ``float32`` and ``fp32`` keep f32 (None); ``bf16`` and
    ``bfloat16`` give torch.bfloat16, the GraphNet stage's bf16 lane."""
    if name in (None, "none", "float32", "fp32"):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unknown dtype {name!r} (use float32 or bf16)")


def nrmse(pred, target, eps: float = 1e-12):
    """Normalised RMSE over the whole tensor."""
    num = torch.sqrt(torch.mean((pred - target) ** 2))
    den = torch.sqrt(torch.mean(target ** 2))
    return num / (den + eps)


def time_windows(t: torch.Tensor, n_windows: int, slice_len: int) -> torch.Tensor:
    """(B, nt) -> (B, n, 2*slice_len); window i covers [i*ts, (i+2)*ts)."""
    idx = (torch.arange(n_windows)[:, None] * slice_len
           + torch.arange(2 * slice_len)[None, :])
    return t[:, idx.to(t.device)]


GENERATOR_SEED = 0  # the seed of a model's own generator


class OwnGenerator:
    """Mixin for an ``nn.Module`` that draws random numbers in training
    (MAgNet[GNN]'s noise, the no-interaction ablation's latents):
    ``default_generator`` is the model's own generator on its device,
    seeded with ``GENERATOR_SEED`` when first asked for."""

    _generator = None
    #: (index, count): this process's block of a batch split ``count`` ways
    #: over the data-parallel axis (set by the trainer).  Each draw covers
    #: the whole batch and the block is taken, so the numbers a sample
    #: gets do not depend on the split.
    batch_block = (0, 1)

    def block_draw(self, draw, shape, generator: torch.Generator):
        """``draw(shape, generator)`` for this process's block of the batch
        (shape[0] samples) of a draw for the whole batch."""
        i, n = self.batch_block
        if n == 1:
            return draw(shape, generator)
        b = shape[0]
        return draw((n * b, *shape[1:]), generator)[i * b:(i + 1) * b]

    def default_generator(self) -> torch.Generator:
        dev = next(self.parameters()).device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev).manual_seed(
                GENERATOR_SEED)
        return self._generator
