"""Shared model plumbing: the losses, the ``graph_dtype`` knob, nRMSE and
time windows (counterpart of ``magnet_tpu/models/common.py:85-116,
289-295``), a model's own random generator, and the hooks by which a
trainer pads a GraphNet model's graphs for a captured chunk of steps."""
from __future__ import annotations

import torch

from magnet_tpu_torch.nn.graphnet import GraphProcessor, step_lane


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
    """(B, nt) -> (B, n, 2*slice_len); window i covers [i*ts, (i+2)*ts).
    The index is made on t's device (no copy from the host)."""
    idx = (torch.arange(n_windows, device=t.device)[:, None] * slice_len
           + torch.arange(2 * slice_len, device=t.device)[None, :])
    return t[:, idx]


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


class PaddedGraphMixin:
    """Mixin for a GraphNet model whose graphs differ from batch to batch
    (new query points) and which a captured chunk of training steps pads to
    fixed edge rows (``train.trainer``, ``ops.graph.pad_edges``): the model
    names its CSR graphs by role (``graph_parts``) and rebuilds its graph
    from padded ones (``with_graph_parts``); ``graph_lanes`` says which
    lanes, in which dtype and at which width, its processors take on them
    (the trainer pads a chunk's graphs where every one of those kernels
    reads a padded graph's end on the card: the fold, pe and pre-gathered
    entries, in f32 and bf16 at either width)."""

    def graph_parts(self, graph) -> dict:
        """The model's graph's ``CSRGraph``s by role."""
        raise NotImplementedError

    def with_graph_parts(self, graph, parts: dict):
        """The model's graph with its ``CSRGraph``s replaced by ``parts``
        (by role)."""
        raise NotImplementedError

    def graph_lanes(self, graph) -> set[tuple[str, str, int]]:
        """The (lane, dtype, width) of this model's processor steps on
        ``graph``'s parts under its ``impl``: the lane as
        ``nn.graphnet.step_lane`` decides it (``plain``: the plain
        versions), ``f32`` or ``bf16``, and the edge MLP's hidden width H,
        which picks the kernels' build."""
        lanes = set()
        for proc in self.modules():
            if not isinstance(proc, GraphProcessor) or not proc.gnn_stacks:
                continue
            hidden = proc.gnn_stacks[0].edge_fn[0].linears[0].weight.shape[0]
            dtype = "f32" if proc.dtype is None else "bf16"
            for part in self.graph_parts(graph).values():
                lane = ("plain" if self.impl == "plain"
                        else step_lane(part, self.impl, hidden))
                lanes.add((lane, dtype, hidden))
        return lanes
