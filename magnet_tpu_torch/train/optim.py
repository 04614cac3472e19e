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
    allowed, after which the update is applied whatever it holds).

    The step count, the count of dropped updates and the learning rate are
    tensors on the parameters' device, and everything is decided there, so
    that a step reads nothing back and can be captured in a CUDA graph
    (``train.trainer``): the rate is looked up in a table of the schedule's
    values by the applied-update count, on a CUDA device the update is a
    capturable Adam's, and a dropped update is undone by restoring a copy
    of the parameters and moments.  ``state_dict`` keeps the format of a
    plain Adam (a float rate, the step on the host).
    """

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 factor: float = 0.3, step_size: int = 50,
                 steps_per_epoch: int = 1, skip_nonfinite: bool = False,
                 max_epochs: int = 1000):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.factor, self.step_size = lr, factor, step_size
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.skip_nonfinite = skip_nonfinite
        dev = self.params[0].device if self.params else torch.device("cpu")
        capturable = dev.type == "cuda"
        # f32 where the capturable Adam reads it on the device; f64 on the
        # host, where Adam reads it as a Python float (``lr_at``'s value)
        n = max(max_epochs, 1) // max(step_size, 1) + 2
        self._lr_table = torch.tensor(
            [self.lr * self.factor ** d for d in range(n)],
            dtype=torch.float32 if capturable else torch.float64, device=dev)
        self._applied = torch.zeros((), dtype=torch.int64, device=dev)
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        self.adam = torch.optim.Adam(
            self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay, capturable=capturable)
        self._init_state()

    def _init_state(self) -> None:
        """Adam's state before its first update (step 0, zero moments), made
        up front so that a captured or a dropped first update finds it."""
        capturable = self.adam.defaults["capturable"]
        for p in self.params:
            if not self.adam.state[p]:
                self.adam.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32,
                                        device=p.device if capturable
                                        else "cpu"),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}

    @property
    def step_count(self) -> int:
        """Applied updates (read from the device)."""
        return int(self._applied)

    @property
    def notfinite_count(self) -> int:
        """Consecutive dropped updates (read from the device)."""
        return int(self._nonfinite)

    def lr_at(self, step: int) -> float:
        epoch = step // self.steps_per_epoch
        return self.lr * self.factor ** (epoch // self.step_size)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool | None:
        """Apply one update from the parameters' ``.grad`` (or, with
        ``skip_nonfinite``, drop it when they are not all finite).  Returns
        whether it was applied on the host, and None on a CUDA device,
        where that is decided on the device and not read back."""
        epoch = self._applied // self.steps_per_epoch
        idx = torch.clamp(epoch // self.step_size,
                          max=self._lr_table.numel() - 1)
        # a gather, not an index: indexing by a tensor reads it on the host.
        # Under capture the gather's output is the tensor that every replay
        # writes the rate into.
        lr = self._lr_table.index_select(0, idx.reshape(1)).reshape(())
        for group in self.adam.param_groups:
            group["lr"] = lr
        if self.skip_nonfinite:
            apply = self._step_if_finite()
        else:
            self.adam.step()
            self._applied += 1
            apply = True
        return None if self.adam.defaults["capturable"] else bool(apply)

    def _step_if_finite(self) -> torch.Tensor:
        """The update, kept where the gradients are finite or the limit of
        consecutive drops is reached; whether it was kept."""
        live = [p for p in self.params if p.grad is not None]
        apply = torch.stack([torch.isfinite(p.grad).all() for p in live]).all()
        apply |= self._nonfinite >= MAX_CONSECUTIVE_NONFINITE
        kept = [t for p in live for t in (p, *self.adam.state[p].values())]
        before = [t.detach().clone() for t in kept]
        self.adam.step()
        with torch.no_grad():
            for t, old in zip(kept, before):
                t.copy_(torch.where(apply, t, old))
        self._applied += apply.long()
        self._nonfinite.copy_(torch.where(apply, 0, self._nonfinite + 1))
        return apply

    def state_dict(self) -> dict:
        """Adam's state as a plain Adam keeps it (a float rate, the step on
        the host, not capturable), the applied updates and the dropped
        ones."""
        adam = self.adam.state_dict()
        adam = {"state": {i: {k: (v.detach().to("cpu", torch.float32)
                                  if k == "step" else v)
                              for k, v in st.items()}
                          for i, st in adam["state"].items()},
                "param_groups": [{**g, "lr": float(g["lr"]),
                                  "capturable": False}
                                 for g in adam["param_groups"]]}
        return {"adam": adam, "step": self.step_count,
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: dict) -> None:
        capturable = self.adam.defaults["capturable"]
        self.adam.load_state_dict(state["adam"])
        for group in self.adam.param_groups:
            group["capturable"] = capturable
        step_dev = self.params[0].device if capturable else "cpu"
        for st in self.adam.state.values():
            if "step" in st:
                st["step"] = st["step"].to(step_dev, torch.float32)
        self._init_state()
        self._applied.fill_(int(state["step"]))
        self._nonfinite.fill_(int(state.get("notfinite_count", 0)))


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   factor: float = 0.3, step_size: int = 50,
                   steps_per_epoch: int = 1, skip_nonfinite: bool = False,
                   max_epochs: int = 1000) -> StepDecayAdam:
    return StepDecayAdam(params, lr, weight_decay, factor, step_size,
                         steps_per_epoch, skip_nonfinite, max_epochs)


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
