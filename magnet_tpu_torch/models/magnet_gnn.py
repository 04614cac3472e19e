"""MAgNet[GNN], the fully graph-based flavour, in 1D and 2D: forward, the
rollout over windows with teacher forcing and training noise, and the
training and eval losses (counterpart of ``magnet_tpu/models/
magnet_gnn.py:38-312``).  The position dimension P (1 or 2) sizes the two
encoders' inputs and the k-NN head's; the JAX model reads it off the
coordinates at ``init``, the port takes it as ``pos_dim``.

Per window: a first GraphNet pass (encoder, processor) over the LR support
nodes -> the k-NN INR decoder interpolates their latents to the HR query
coordinates -> the projector seeds HR values -> a second GraphNet pass
(encoder, processor, decoder) over LR ∪ HR -> per-node Euler update.

Both radius graphs and the k-NN table are built once per batch on the host
(coordinates do not change over the rollout) and flattened over the batch,
so every processor step is one fused-edge kernel launch for the whole
batch.  ``build_graph_partitioned`` partitions both radius graphs over a
graph axis instead (``PartitionedGraphMixin``; the k-NN table stays whole,
the INR decode being node-local): the rollout and losses are the same.
``graph_dtype`` (None: f32; bf16) is the compute dtype of both GraphNet
stages (the two encoders, the two processors and the decoder), as the JAX
core's ``gk``/``pk`` pass it; the k-NN head and the projector stay f32.
``remat`` (hp key, as the JAX model reads it) recomputes each step of both
processors in the backward (``nn.graphnet.GraphProcessor``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from magnet_tpu_torch.models.common import (
    LOSSES,
    OwnGenerator,
    l1_loss,
    parse_dtype,
    time_windows,
)
from magnet_tpu_torch.models.partitioned_mixin import (
    PartitionedGraphMixin,
    encode_process,
    partition,
)
from magnet_tpu_torch.nn.core import MLP
from magnet_tpu_torch.nn.graphnet import (
    GraphDecoder,
    GraphEncoder,
    GraphProcessor,
)
from magnet_tpu_torch.nn.inr import KNNDecoder
from magnet_tpu_torch.ops.graph import CSRGraph, GraphCache, knn
from magnet_tpu_torch.parallel.graph_partition import PartitionedGraph

N_FIELDS = 1  # one scalar field


@dataclass
class GNNGraphs:
    """A batch's graphs: the radius graph over the B·L LR nodes, the one
    over the B·(L+N) LR ∪ HR nodes (both flattened over the batch, or both
    partitioned), and ``nbr`` (B, N, k) int64, the k nearest LR nodes of
    each HR query."""

    lr: CSRGraph | PartitionedGraph
    all: CSRGraph | PartitionedGraph
    nbr: torch.Tensor


class MAgNetGNNCore(nn.Module):
    """Single-window forward over a batch.  Submodule names are the
    reference's, so the state_dict keys are too.  ``graph_dtype`` is the
    compute dtype of both GraphNet stages (None: f32): where their bf16
    latents meet the f32 k-NN head and the decoder's bf16 output meets the
    f32 Euler update, each is cast to f32, as flax promotes bf16 with f32
    in the JAX model (an exact cast)."""

    def __init__(self, time_slice: int = 25, latent_dim: int = 128,
                 num_message_passing_steps: int = 5, mlp_layers: int = 4,
                 mlp_hidden: int = 128, n_chan: int = 128,
                 interpolation: str = "area", pos_dim: int = 1,
                 graph_dtype=None, remat: bool = False):
        super().__init__()
        tc = time_slice * N_FIELDS
        self.time_slice = time_slice
        self.pos_dim = pos_dim
        self.impl = "kernel"
        enc = (tc + pos_dim + 1, tc + pos_dim, latent_dim, latent_dim,
               mlp_layers, mlp_hidden, graph_dtype)
        proc = (latent_dim, num_message_passing_steps, mlp_layers, mlp_hidden,
                graph_dtype, remat)
        self.encoder = GraphEncoder(*enc)
        self.processor = GraphProcessor(*proc)
        self.proj_head = KNNDecoder(latent_dim + N_FIELDS + pos_dim + 1,
                                    n_chan, interpolation)
        self.projector = MLP(n_chan, [mlp_hidden] * mlp_layers, 1)
        self._encoder = GraphEncoder(*enc)
        self._processor = GraphProcessor(*proc)
        self._decoder = GraphDecoder(latent_dim, time_slice, mlp_layers,
                                     mlp_hidden, graph_dtype)

    def forward(self, x_lr, lr_coords, hr_coords, t, hr_last,
                graphs: GNNGraphs):
        """x_lr (B, T, C, L) LR frames, T == time_slice; lr_coords (B, L, P),
        hr_coords (B, N, P); t (B, 2T) the window's times; hr_last (B, N, 1)
        last known HR values.  Returns (out_hr (B, T, N, 1), out_lr
        (B, T, L, 1), hr_points (B, T, N, 1))."""
        B, T, C, L = x_lr.shape
        N = hr_coords.shape[1]
        M = L + N
        t_last = t[:, T - 1:T]                                     # (B, 1)

        # first pass over the LR nodes
        u_lr = x_lr.permute(0, 3, 1, 2).reshape(B, L, T * C)
        lr_encoded = encode_process(
            self.encoder, self.processor, u_lr.reshape(B * L, -1),
            lr_coords.reshape(B * L, -1),
            t_last[:, None].expand(B, L, 1).reshape(B * L, 1), graphs.lr,
            self.impl)

        # k-NN INR decode and projector
        z = self.proj_head(x_lr, lr_encoded.float().reshape(B, L, -1),
                           lr_coords, hr_coords, t, graphs.nbr)    # (B,N,T,nc)
        hr_points = self.projector(z)                              # (B,N,T,1)

        # second pass over LR ∪ HR
        all_feats = torch.cat([u_lr, hr_points.reshape(B, N, T * C)], dim=1)
        all_coords = torch.cat([lr_coords, hr_coords], dim=1)
        nf = encode_process(
            self._encoder, self._processor, all_feats.reshape(B * M, -1),
            all_coords.reshape(B * M, -1),
            t_last[:, None].expand(B, M, 1).reshape(B * M, 1), graphs.all,
            self.impl)
        ret = self._decoder(nf).float().reshape(B, M, -1)          # (B, M, T_out)

        # Euler update
        last_values = torch.cat(
            [x_lr[:, -1].transpose(1, 2), hr_last], dim=1)         # (B, M, 1)
        dt = t[:, T:] - t[:, T - 1:T]                              # (B, T_out)
        outputs = (last_values[:, None]
                   + dt[:, :, None, None] * ret.transpose(1, 2)[..., None])
        return outputs[:, :, L:], outputs[:, :, :L], hr_points.transpose(1, 2)


class MAgNetGNN(OwnGenerator, PartitionedGraphMixin, MAgNetGNNCore):
    """MAgNet[GNN]: the core with the task side.  Batch dict of tensors
    (``DatasetImplicitGNN1D`` at ``pos_dim`` 1, ``DatasetImplicitGNN2D`` at
    2): t (B, nt), lr_frames (B, nt, 1, L), hr_points (B, nt, N, 1),
    coords_hr (B, N, P), coords_lr (B, L, P).

    ``noise`` > 0 adds Gaussian noise of that scale to each training
    window's input frames and last HR values (reference magnet_gnn.py:
    401-426), drawn from ``loss``'s ``generator`` (by default the model's
    own, ``default_generator``) through ``draw_noise``."""

    def __init__(self, hparams: dict[str, Any], pos_dim: int = 1):
        hp = dict(hparams)
        super().__init__(
            time_slice=int(hp.get("time_slice", 25)),
            latent_dim=int(hp.get("latent_dim", 128)),
            num_message_passing_steps=int(hp.get("num_message_passing_steps", 5)),
            mlp_layers=int(hp.get("mlp_layers", 4)),
            mlp_hidden=int(hp.get("mlp_hidden", 128)),
            n_chan=int(hp.get("n_chan", 128)),
            interpolation=hp.get("interpolation", "area"),
            pos_dim=pos_dim,
            graph_dtype=parse_dtype(hp.get("graph_dtype")),
            remat=bool(hp.get("remat", False)),
        )
        self.radius = float(hp.get("radius", 0.08))
        self.teacher_forcing = bool(hp.get("teacher_forcing", True))
        self.noise = float(hp.get("noise", 0.0))
        self.criterion = LOSSES[hp.get("loss", "l1")]
        self.codec_neighbors = int(hp.get("codec_neighbors", 4))
        self.graphs = GraphCache(
            lane_rule=("graphnet", int(hp.get("mlp_hidden", 128))))

    # ---------- host-side ----------
    def build_graph(self, batch) -> GNNGraphs:
        """The LR and LR ∪ HR radius graphs (self loops, cached by their
        coordinates, each with its GraphNet lane) and the k-NN table, on the
        model's device."""
        dev = next(self.parameters()).device
        lr = batch["coords_lr"].detach().cpu().numpy()             # (B, L, P)
        hr = batch["coords_hr"].detach().cpu().numpy()             # (B, N, P)
        g_lr = self.graphs.radius_graph_batch(lr, self.radius, loop=True,
                                              device=dev)
        g_all = self.graphs.radius_graph_batch(
            np.concatenate([lr, hr], axis=1), self.radius, loop=True,
            device=dev)
        return GNNGraphs(g_lr, g_all, self._knn(lr, hr, dev))

    def _knn(self, lr, hr, dev):
        return torch.stack([knn(lr[b], hr[b], self.codec_neighbors)
                            for b in range(lr.shape[0])]).long().to(dev)

    def build_graph_partitioned(self, batch, n_shards: int, halo=False,
                                axis=None) -> GNNGraphs:
        """Both radius graphs (LR, and LR ∪ HR) partitioned over
        ``n_shards`` (``PartitionedGraphMixin``); the k-NN table whole."""
        dev = next(self.parameters()).device
        lr = batch["coords_lr"].detach().cpu().numpy()             # (B, L, P)
        hr = batch["coords_hr"].detach().cpu().numpy()             # (B, N, P)
        parts = [partition(c, self.radius, True, n_shards, halo, axis, dev,
                           self.graphs.lane_rule)
                 for c in (lr, np.concatenate([lr, hr], axis=1))]
        return GNNGraphs(*parts, self._knn(lr, hr, dev))

    # ---------- device-side ----------
    def draw_noise(self, shape, generator: torch.Generator):
        """Standard normal draws of ``shape`` for the training noise: the one
        place it is drawn."""
        return torch.randn(shape, generator=generator,
                           device=generator.device)

    def _rollout(self, batch, graphs: GNNGraphs, teacher_forcing: bool,
                 generator: Optional[torch.Generator] = None):
        """One core call per window.  The next window's input is the ground
        truth (``teacher_forcing``), else this window's LR output and the
        last frame of its HR output.  With a ``generator`` and ``noise`` >
        0 each window's input and last HR values get noise first.  Returns
        (hr_seq (B, n*ts, N, 1), lr_seq (B, n*ts, L, 1), pts_seq
        (B, n*ts, N, 1))."""
        ts = self.time_slice
        u, uv, t = batch["lr_frames"], batch["hr_points"], batch["t"]
        n_win = (u.shape[1] - ts) // ts
        t_win = time_windows(t, n_win, ts)                         # (B, n, 2ts)
        inp, hr_last = u[:, :ts], uv[:, ts - 1]
        use_noise = self.noise > 0 and generator is not None
        hr_seq, lr_seq, pts_seq = [], [], []
        for w in range(n_win):
            if use_noise:
                inp = inp + self.noise * self.block_draw(
                    self.draw_noise, inp.shape, generator)
                hr_last = hr_last + self.noise * self.block_draw(
                    self.draw_noise, hr_last.shape, generator)
            out_hr, out_lr, hr_pts = self(inp, batch["coords_lr"],
                                          batch["coords_hr"], t_win[:, w],
                                          hr_last, graphs)
            if teacher_forcing:
                inp = u[:, (w + 1) * ts:(w + 2) * ts]
                hr_last = uv[:, (w + 2) * ts - 1]
            else:
                inp = out_lr.transpose(2, 3)                       # (B,T,1,L)
                hr_last = out_hr[:, -1]
            hr_seq.append(out_hr)
            lr_seq.append(out_lr)
            pts_seq.append(hr_pts)
        return (torch.cat(hr_seq, dim=1), torch.cat(lr_seq, dim=1),
                torch.cat(pts_seq, dim=1))

    def _targets(self, batch, horizon: int):
        """The rollout's ground truth: HR queries then LR nodes, (B,
        horizon, N + L, 1)."""
        ts = self.time_slice
        lr = batch["lr_frames"][:, ts:ts + horizon].transpose(2, 3)
        return torch.cat([self.rollout_target(batch, horizon), lr], dim=2)

    @torch.no_grad()
    def predict(self, batch, graphs: GNNGraphs):
        """No-teacher-forcing rollout with no noise.  Returns (hr_hat
        (B, n*ts, N, 1), lr_hat (B, n*ts, L, 1))."""
        hr_hat, lr_hat, _ = self._rollout(batch, graphs, teacher_forcing=False)
        return hr_hat, lr_hat

    def rollout_target(self, batch, horizon: int):
        """Ground truth of the HR rollout: ``hr_points`` shifted by
        ``time_slice``."""
        ts = self.time_slice
        return batch["hr_points"][:, ts:ts + horizon]

    def eval_metrics(self, batch, pred):
        """``loss(train=False)``'s metrics from ``predict``'s output: the
        criterion and the L1 error over the HR and LR outputs together."""
        hr_hat, lr_hat = pred
        y_hat = torch.cat([hr_hat, lr_hat], dim=2)
        target = self._targets(batch, hr_hat.shape[1])
        loss = self.criterion(y_hat, target)
        return loss, {"loss": loss, "mae_loss": l1_loss(y_hat, target)}

    def loss(self, batch, graphs: GNNGraphs, train: bool = True,
             generator: Optional[torch.Generator] = None):
        """``train``: the differentiable training loss, the criterion on the
        HR and LR outputs of every window plus the criterion on the INR
        head's HR estimate of each window's own frames (metrics ``loss``,
        ``mae_loss``, ``interp_loss``), with teacher forcing as configured
        and noise from ``generator`` (default: the model's own) when
        ``noise`` > 0.  Otherwise the eval loss of the no-teacher-forcing
        rollout, under ``no_grad``."""
        if not train:
            return self.eval_metrics(batch, self.predict(batch, graphs))
        if generator is None and self.noise > 0:
            generator = self.default_generator()
        hr_hat, lr_hat, pts_hat = self._rollout(
            batch, graphs, self.teacher_forcing, generator)
        y_hat = torch.cat([hr_hat, lr_hat], dim=2)
        target = self._targets(batch, hr_hat.shape[1])
        interp_target = batch["hr_points"][:, :hr_hat.shape[1]]
        loss = self.criterion(y_hat, target) + self.criterion(pts_hat,
                                                              interp_target)
        return loss, {"loss": loss, "mae_loss": l1_loss(y_hat, target),
                      "interp_loss": l1_loss(pts_hat, interp_target)}
