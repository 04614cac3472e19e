"""MPNN 1D/2D baselines (counterpart of ``magnet_tpu/models/mpnn.py``).

Pure message-passing PDE solver: embedding MLP on (u, x/L, t/tmax), stacked
MPNN layers with InstanceNorm, temporal-bundling CNN decoder, Euler update
``u_last + cumsum(dt) * diff``.

Reference quirks kept:
  * 1D freezes the time variable at t[b, 0]; 2D advances it with the
    rollout window;
  * the 1D time_window == 10 decoder has no mid Swish, the 2D one has;
  * radius: 1D r = n·dx + 1e-4; 2D r = n·‖dx − dy‖ + 1e-4, where dy is
    x[0][W] − x[0][0] on the flattened grid.

The radius graph is built once per batch on the host, flattened over the
batch (one kernel launch per layer covers every sample) and cached by its
coordinates: a regular grid asks for the same graph at every step.  The
rollout over windows is a Python loop.  ``build_graph_partitioned``
edge-partitions the graph over a graph axis instead (the all-gather layout
alone, as in the JAX package: the sender-side projections are exchanged,
``parallel.graph_partition.mpnn_processor``); the rollout and losses are
the same.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from magnet_tpu_torch.models.common import LOSSES, l1_loss
from magnet_tpu_torch.models.partitioned_mixin import (
    PartitionedGraphMixin,
    partition,
)
from magnet_tpu_torch.nn.gnn_layer import MPNNLayer, TemporalBundlingDecoder
from magnet_tpu_torch.ops.graph import CSRGraph, GraphCache
from magnet_tpu_torch.parallel.graph_partition import (
    PartitionedGraph,
    mpnn_processor,
)


class MPNNCore(nn.Module):
    """Per-window forward over a batch of same-size graphs."""

    def __init__(self, hidden_features: int = 128, hidden_layer: int = 5,
                 time_window: int = 16, pos_dim: int = 1,
                 with_mid_swish: bool = True):
        super().__init__()
        h = hidden_features
        self.time_window = time_window
        self.impl = "kernel"
        self.embedding_mlp = nn.Sequential(
            nn.Linear(time_window + pos_dim + 1, h), nn.SiLU(),
            nn.Linear(h, h), nn.SiLU())
        self.gnn_layers = nn.ModuleList(
            MPNNLayer(h, h, pos_dim=pos_dim, time_window=time_window)
            for _ in range(hidden_layer))
        self.output_mlp = TemporalBundlingDecoder(time_window, with_mid_swish)

    def embed(self, u, pos_x, variables):
        return self.embedding_mlp(torch.cat([u, pos_x, variables], dim=-1))

    def decode(self, h, u, dt):
        """Temporal-bundling decode + Euler: h (M, H), u (M, tw)."""
        diff = self.output_mlp(h)
        dt_row = torch.cumsum(dt.expand(self.time_window), dim=0)
        return u[:, -1:] + dt_row[None, :] * diff

    def forward(self, u, pos_x, variables, dt, graph: CSRGraph):
        """u (B, N, tw) node time histories; pos_x (B, N, P) positions
        over L; variables (B, N, 1) time over tmax; dt a scalar tensor;
        graph a ``CSRGraph`` or a ``PartitionedGraph``.  Returns the
        (B, N, tw) bundled predictions."""
        B, N, tw = u.shape
        u, pos_x, variables = (a.reshape(B * N, -1)
                               for a in (u, pos_x, variables))
        h = self.embed(u, pos_x, variables)
        if isinstance(graph, PartitionedGraph):
            h = mpnn_processor(self.gnn_layers, h, u, pos_x, variables, graph,
                               self.impl)
        else:
            for layer in self.gnn_layers:
                h = layer(h, u, pos_x, variables, graph, B, impl=self.impl)
        return self.decode(h, u, dt).view(B, N, tw)


class MPNN(PartitionedGraphMixin, MPNNCore):
    """1D task wrapper.  Batch dict of tensors: u (B, N, nt), x (B, N, 1),
    t (B, nt)."""

    pos_dim = 1
    defaults = {"time_window": 16, "neighbors": 3}

    def __init__(self, hparams: dict[str, Any]):
        hp = {**self.defaults, **hparams}
        tw = int(hp["time_window"])
        super().__init__(
            hidden_features=int(hp.get("hidden_features", 128)),
            hidden_layer=int(hp.get("hidden_layer", 5)), time_window=tw,
            pos_dim=self.pos_dim, with_mid_swish=self._mid_swish(tw))
        self.teacher_forcing = bool(hp.get("teacher_forcing", False))
        self.neighbors = int(hp["neighbors"])
        self.criterion = LOSSES[hp.get("loss", "l1")]
        self.graphs = GraphCache(
            lane_rule=("mpnn", int(hp.get("hidden_features", 128))))

    @staticmethod
    def _mid_swish(time_window: int) -> bool:
        return time_window != 10

    def _radius(self, x: np.ndarray) -> float:
        dx = float(x[0, 1, 0] - x[0, 0, 0])
        return self.neighbors * dx + 1e-4

    def build_graph(self, batch) -> CSRGraph:
        """The radius graph of every sample (no self loops), flattened over
        the batch, on the model's device."""
        x = batch["x"].detach().cpu().numpy()                  # (B, N, P)
        return self.graphs.radius_graph_batch(
            x, self._radius(x), loop=False,
            device=next(self.parameters()).device)

    def build_graph_partitioned(self, batch, n_shards: int, halo=False,
                                axis=None) -> PartitionedGraph:
        """The radius graph partitioned over ``n_shards`` in the all-gather
        layout whatever ``halo`` is (True, "fused", "overlap", "ring"
        alike: the MPNN step exchanges the sender projections, as in the
        JAX package, ``magnet_tpu/models/mpnn.py:217-232``)."""
        x = batch["x"].detach().cpu().numpy()
        return partition(x, self._radius(x), False, n_shards, False, axis,
                         next(self.parameters()).device,
                         self.graphs.lane_rule)

    def _time_variable(self, t, window: int):
        """(B,) time variable of rollout window ``window``: 1D always reads
        step 0."""
        return t[:, 0] / t[0, -1]

    def _rollout(self, batch, graph: CSRGraph, teacher_forcing: bool):
        """One core call per window; the next window's input is the ground
        truth (``teacher_forcing``) or the prediction.  Returns u_hat
        (B, n*tw, N)."""
        u = batch["u"].transpose(1, 2)                         # (B, nt, N)
        x, t = batch["x"], batch["t"]
        B, nt, N = u.shape
        tw = self.time_window
        n_win = (nt - tw) // tw
        pos = x / x[0, -1, 0]
        dt = t[0, 1] - t[0, 0]
        inp = u[:, :tw].transpose(1, 2)                        # (B, N, tw)
        outs = []
        for w in range(n_win):
            variables = self._time_variable(t, w)[:, None, None].expand(B, N, 1)
            y = self(inp, pos, variables, dt, graph)
            outs.append(y.transpose(1, 2))                     # (B, tw, N)
            inp = (u[:, (w + 1) * tw:(w + 2) * tw].transpose(1, 2)
                   if teacher_forcing else y)
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def predict(self, batch, graph: CSRGraph):
        """No-teacher-forcing rollout, u_hat (B, n*tw, N)."""
        return self._rollout(batch, graph, teacher_forcing=False)

    def rollout_target(self, batch, horizon: int):
        """Ground truth aligned with ``predict``: u is stored (B, N, nt);
        the time-major slice shifted by ``time_window``."""
        tw = self.time_window
        return batch["u"].transpose(1, 2)[:, tw:tw + horizon]

    def eval_metrics(self, batch, u_hat):
        """``loss(train=False)``'s metrics from a finished rollout."""
        target = self.rollout_target(batch, u_hat.shape[1])
        loss = self.criterion(u_hat, target)
        return loss, {"loss": loss, "mae_loss": l1_loss(u_hat, target)}

    def loss(self, batch, graph: CSRGraph, train: bool = True):
        """The criterion on the rollout against the shifted ground truth:
        differentiable and with the configured ``teacher_forcing`` when
        ``train``, else the free rollout under ``no_grad``."""
        if not train:
            return self.eval_metrics(batch, self.predict(batch, graph))
        return self.eval_metrics(
            batch, self._rollout(batch, graph, self.teacher_forcing))


class MPNN2D(MPNN):
    """2D task wrapper.  Batch: u (B, N, nt), x (B, N, 2), t (B, nt)."""

    pos_dim = 2
    defaults = {"time_window": 10, "neighbors": 4}

    @staticmethod
    def _mid_swish(time_window: int) -> bool:
        return True

    def _radius(self, x: np.ndarray) -> float:
        w = int(round(np.sqrt(x.shape[1])))
        dx = x[0, 1] - x[0, 0]                                 # (2,)
        dy = x[0, w] - x[0, 0]
        return self.neighbors * float(np.linalg.norm(dx - dy)) + 1e-4

    def _time_variable(self, t, window: int):
        """Window i's input graph carries t[:, (i+1)·tw − 1] / tmax."""
        step = min((window + 1) * self.time_window - 1, t.shape[1] - 1)
        return t[:, step] / t[0, -1]
