"""Optimizer and learning-rate schedule (counterpart of
``magnet_tpu/train/optim.py``): Adam with the L2 weight decay coupled into
the gradient (betas 0.9/0.999, eps 1e-8) and a step decay of the learning
rate per epoch, ``lr · factor^(epoch // step_size)``.

The epoch is taken from the count of applied updates
(``step // steps_per_epoch``), not from a scheduler stepped by the training
loop, so a resumed run and a partial epoch get the same rate.
"""
from __future__ import annotations

import torch

MAX_CONSECUTIVE_NONFINITE = 100


class StepDecayAdam:
    """``torch.optim.Adam`` whose learning rate is set from the global step
    before every update.

    ``skip_nonfinite`` drops an update whose gradients hold an inf or a
    nan: parameters, moments and the step count stay as they were (the
    semantics of ``optax.apply_if_finite`` with 100 consecutive errors
    allowed, after which the update is applied whatever it holds).  The
    check reads one flag back from the device per step.
    """

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 factor: float = 0.3, step_size: int = 50,
                 steps_per_epoch: int = 1, skip_nonfinite: bool = False):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.factor, self.step_size = lr, factor, step_size
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.skip_nonfinite = skip_nonfinite
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.step_count = 0       # applied updates
        self.notfinite_count = 0  # consecutive dropped updates

    def lr_at(self, step: int) -> float:
        epoch = step // self.steps_per_epoch
        return self.lr * self.factor ** (epoch // self.step_size)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Apply one update from the parameters' ``.grad``; False when the
        update was dropped as non-finite."""
        if self.skip_nonfinite:
            grads = [p.grad for p in self.params if p.grad is not None]
            finite = bool(torch.stack(
                [torch.isfinite(g).all() for g in grads]).all())
            if not finite and self.notfinite_count < MAX_CONSECUTIVE_NONFINITE:
                self.notfinite_count += 1
                return False
            self.notfinite_count = 0
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.step_count)
        self.adam.step()
        self.step_count += 1
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "step": self.step_count,
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.step_count = int(state["step"])
        self.notfinite_count = int(state.get("notfinite_count", 0))


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   factor: float = 0.3, step_size: int = 50,
                   steps_per_epoch: int = 1,
                   skip_nonfinite: bool = False) -> StepDecayAdam:
    return StepDecayAdam(params, lr, weight_decay, factor, step_size,
                         steps_per_epoch, skip_nonfinite)


def clip_grad_global_norm(params, clip: float) -> None:
    """Scale every gradient in place by ``min(1, clip / max(norm, 1e-12))``,
    norm being the global L2 norm; nothing is read back from the device."""
    grads = [p.grad for p in params if p.grad is not None]
    if clip <= 0 or not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)
