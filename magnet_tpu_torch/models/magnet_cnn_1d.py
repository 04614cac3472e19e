"""MAgNet[CNN] 1D, the flagship model: forward, the rollout over windows
with its three feedback branches, and the training and eval losses
(counterpart of ``magnet_tpu/models/magnet_cnn_1d.py``).  The task side
(``MAgNetCNNTask``) is shared with MAgNet[CNN] 2D.

Per window: EDSR features of the stacked LR frames -> INR decoder at the HR
query coords -> projector seeds HR values -> GraphNet (encoder, processor,
decoder) over the LR ∪ HR nodes -> per-node Euler update.

The radius graph over LR ∪ HR coords is built once per batch on the host
(coords do not change over the rollout) and flattened over the batch, so
every processor step is one fused-edge kernel launch for the whole batch;
or it is edge-partitioned over a graph axis (``build_graph_partitioned``),
one launch a shard.  The rollout over windows is a Python loop.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from magnet_tpu_torch.models.common import (
    LOSSES,
    PaddedGraphMixin,
    l1_loss,
    parse_dtype,
    time_windows,
)
from magnet_tpu_torch.models.partitioned_mixin import (
    PartitionedGraphMixin,
    encode_process,
)
from magnet_tpu_torch.nn.core import MLP
from magnet_tpu_torch.nn.edsr import EDSR
from magnet_tpu_torch.nn.graphnet import (
    GraphDecoder,
    GraphEncoder,
    GraphProcessor,
)
from magnet_tpu_torch.nn.inr import INRDecoder1D
from magnet_tpu_torch.ops.graph import CSRGraph, GraphCache
from magnet_tpu_torch.ops.interp import interpolate_linear_1d
from magnet_tpu_torch.utils import make_coord, make_coord_np

N_FIELDS = 1  # one scalar field in 1D


class MAgNetCNN1DCore(nn.Module):
    """Single-window forward over a batch.  Submodule names are the
    reference's, so the state_dict keys are too.  ``graph_dtype`` is the
    compute dtype of the GraphNet stage alone (encoder, processor,
    decoder; None: f32): the EDSR and INR front end stays f32, and the
    decoder's bf16 output meets the f32 Euler update by type promotion, as
    in the JAX model."""

    def __init__(self, time_slice: int = 16, latent_dim: int = 32,
                 num_message_passing_steps: int = 10, mlp_layers: int = 4,
                 mlp_hidden: int = 64, n_chan: int = 128, kernel_size: int = 3,
                 res_scale: float = 1.0, res_layers: int = 4,
                 graph_dtype=None, remat: bool = False):
        super().__init__()
        tc = time_slice * N_FIELDS
        self.time_slice = time_slice
        self.impl = "kernel"
        self.encoder = EDSR(tc, n_chan=n_chan, res_layers=res_layers,
                            kernel_size=kernel_size, res_scale=res_scale)
        self.proj_head = INRDecoder1D(n_chan, N_FIELDS, mlp_layers, mlp_hidden)
        self.projector = MLP(n_chan, [mlp_hidden] * mlp_layers, 1)
        # node features: values, coord, t; edge features: value and coord
        # differences
        self._encoder = GraphEncoder(tc + 2, tc + 1, latent_dim, latent_dim,
                                     mlp_layers, mlp_hidden, graph_dtype)
        self._processor = GraphProcessor(latent_dim, num_message_passing_steps,
                                         mlp_layers, mlp_hidden, graph_dtype,
                                         remat)
        self._decoder = GraphDecoder(latent_dim, time_slice, mlp_layers,
                                     mlp_hidden, graph_dtype)

    def forward(self, x_t, coords, cell, t, hr_last, graph: CSRGraph):
        """x_t (B, T, C, L) LR frames, T == time_slice; coords, cell
        (B, N, 1); t (B, 2T) the window's times; hr_last (B, N, 1) last
        known HR values; graph over the B*(L+N) nodes (a ``CSRGraph`` or
        a ``PartitionedGraph``).  Returns (out_hr
        (B, T, N, 1), out_lr (B, T, L, 1), hr_points (B, T, N, 1))."""
        B, T, C, L = x_t.shape
        N = coords.shape[1]
        M = L + N
        feat = self.encoder(x_t.reshape(B, T * C, L))              # (B, Cf, L)
        z = self.proj_head(x_t, feat, cell, coords, t)             # (B,N,T,nc)
        hr_points = self.projector(z)                              # (B,N,T,1)

        # node features over LR ∪ HR
        hr_flat = hr_points.reshape(B, N, T * C)
        lr_flat = x_t.permute(0, 3, 1, 2).reshape(B, L, T * C)
        lr_coords = make_coord([L], device=x_t.device)[None].expand(B, L, 1)
        all_coords = torch.cat([lr_coords, coords], dim=1).reshape(B * M, 1)
        all_feats = torch.cat([lr_flat, hr_flat], dim=1).reshape(B * M, T * C)
        t_last = t[:, T - 1:T, None].expand(B, M, 1).reshape(B * M, 1)
        nf = encode_process(self._encoder, self._processor, all_feats,
                            all_coords, t_last, graph, self.impl)
        ret = self._decoder(nf).reshape(B, M, -1)                  # (B, M, T_out)

        # Euler update
        last_values = torch.cat(
            [x_t[:, -1].transpose(1, 2), hr_last], dim=1)          # (B, M, 1)
        dt = t[:, T:] - t[:, T - 1:T]                              # (B, T_out)
        outputs = (last_values[:, None]
                   + dt[:, :, None, None] * ret.transpose(1, 2)[..., None])
        return outputs[:, :, L:], outputs[:, :, :L], hr_points.transpose(1, 2)


class MAgNetCNNTask(PaddedGraphMixin, PartitionedGraphMixin):
    """The task side shared by MAgNet[CNN] 1D and 2D: host graph building,
    the rollout with its three feedback branches, and the losses.  The
    class it is mixed into is the core (an ``nn.Module`` whose forward is
    one window) and gives ``ndim`` and the three shape hooks below.  The
    graph may be partitioned (``build_graph_partitioned``, the
    ``PartitionedGraphMixin``), or padded for a captured chunk of steps
    (its one graph, role ``all``: ``PaddedGraphMixin``): the rollout and
    losses are the same.

    Batch dict of tensors: t (B, nt), lr_frames (B, nt, 1, *grid),
    hr_points (B, nt, N, 1), coords (B, N, ndim), cells (B, N, ndim).
    """

    ndim = 1

    def _task_init(self, hp: dict, radius: float) -> None:
        self.radius = float(hp.get("radius", radius))
        self.teacher_forcing = bool(hp.get("teacher_forcing", True))
        self.criterion = LOSSES[hp.get("loss", "l1")]
        self.graphs = GraphCache(
            lane_rule=("graphnet", int(hp.get("mlp_hidden", 64))))

    def _resampled_input(self, out_hr, size: int):
        """The next window's input from this window's HR output, resampled
        to the LR grid of side ``size`` (the validation feedback)."""
        raise NotImplementedError

    def _output_input(self, out_lr):
        """The next window's input from this window's LR output."""
        raise NotImplementedError

    def _as_nodes(self, frames):
        """LR frames (B, T, C, *grid) as node values (B, T, L, C)."""
        raise NotImplementedError

    def _output_nodes(self, lr_hat):
        """The core's LR output as node values (B, T, L, 1)."""
        raise NotImplementedError

    def _graph_coords(self, batch) -> np.ndarray:
        """Every sample's LR grid ∪ HR query coordinates, (B, L + N, d)."""
        coords = batch["coords"].detach().cpu().numpy()            # (B, N, d)
        lr = make_coord_np([batch["lr_frames"].shape[-1]] * self.ndim)
        return np.concatenate(
            [np.broadcast_to(lr[None], (coords.shape[0],) + lr.shape), coords],
            axis=1)

    def build_graph(self, batch) -> CSRGraph:
        """The radius graph over LR ∪ HR coords of every sample, flattened
        over the batch, with its GraphNet lane, on the model's device (and
        cached by its coordinates)."""
        return self.graphs.radius_graph_batch(
            self._graph_coords(batch), self.radius, loop=True,
            device=next(self.parameters()).device)

    def graph_parts(self, graph: CSRGraph) -> dict:
        return {"all": graph}

    def with_graph_parts(self, graph: CSRGraph, parts: dict) -> CSRGraph:
        return parts["all"]

    def _rollout(self, batch, graph: CSRGraph, teacher_forcing: bool,
                 val_feedback: bool):
        """One core call per window.  The next window's input is the ground
        truth (``teacher_forcing``), else the HR output resampled to the LR
        grid (``val_feedback``), else the LR output.  Returns (hr_seq
        (B, n*ts, N, 1), lr_seq (the core's LR output, n*ts frames),
        pts_seq (B, n*ts, N, 1))."""
        ts = self.time_slice
        u, uv, t = batch["lr_frames"], batch["hr_points"], batch["t"]
        n_win = (u.shape[1] - ts) // ts
        t_win = time_windows(t, n_win, ts)                         # (B, n, 2ts)
        inp, hr_last = u[:, :ts], uv[:, ts - 1]
        hr_seq, lr_seq, pts_seq = [], [], []
        for w in range(n_win):
            out_hr, out_lr, hr_pts = self(inp, batch["coords"], batch["cells"],
                                          t_win[:, w], hr_last, graph)
            if teacher_forcing:
                inp = u[:, (w + 1) * ts:(w + 2) * ts]
                hr_last = uv[:, (w + 2) * ts - 1]
            else:
                inp = (self._resampled_input(out_hr, u.shape[-1])
                       if val_feedback else self._output_input(out_lr))
                hr_last = out_hr[:, -1]
            hr_seq.append(out_hr)
            lr_seq.append(out_lr)
            pts_seq.append(hr_pts)
        return (torch.cat(hr_seq, dim=1), torch.cat(lr_seq, dim=1),
                torch.cat(pts_seq, dim=1))

    @torch.no_grad()
    def predict(self, batch, graph: CSRGraph):
        """No-teacher-forcing rollout (eval / super-resolution): each
        window's input is its predecessor's HR output resampled to the LR
        grid.  Returns (hr_hat (B, n*ts, N, 1), lr_hat)."""
        hr_hat, lr_hat, _ = self._rollout(batch, graph, teacher_forcing=False,
                                          val_feedback=True)
        return hr_hat, lr_hat

    def rollout_target(self, batch, horizon: int):
        """Ground truth of the HR rollout: ``hr_points`` shifted by
        ``time_slice``."""
        ts = self.time_slice
        return batch["hr_points"][:, ts:ts + horizon]

    def eval_metrics(self, batch, pred):
        """``loss(train=False)``'s metrics from a finished rollout:
        ``predict``'s output, or its HR part alone."""
        hr_hat = pred[0] if isinstance(pred, tuple) else pred
        target = self.rollout_target(batch, hr_hat.shape[1])
        loss = self.criterion(hr_hat, target)
        return loss, {"loss": loss, "mae_loss": l1_loss(hr_hat, target)}

    def loss(self, batch, graph: CSRGraph, train: bool = True):
        """``train``: the differentiable training loss, the criterion on
        the HR and LR outputs of every window plus the criterion on the
        INR head's HR estimate of each window's own frames; metrics
        ``loss``, ``mae_loss``, ``interp_loss``.  Otherwise the eval loss of
        the no-teacher-forcing rollout, under ``no_grad``."""
        if not train:
            hr_hat, _ = self.predict(batch, graph)
            return self.eval_metrics(batch, hr_hat)
        ts = self.time_slice
        u, uv = batch["lr_frames"], batch["hr_points"]
        hr_hat, lr_hat, pts_hat = self._rollout(
            batch, graph, self.teacher_forcing, val_feedback=False)
        used = ts + hr_hat.shape[1]
        y_hat = torch.cat([hr_hat, self._output_nodes(lr_hat)], dim=2)
        target = torch.cat([uv[:, ts:used], self._as_nodes(u[:, ts:used])],
                           dim=2)
        interp_target = uv[:, :used - ts]
        loss = self.criterion(y_hat, target) + self.criterion(pts_hat,
                                                              interp_target)
        return loss, {"loss": loss, "mae_loss": l1_loss(y_hat, target),
                      "interp_loss": l1_loss(pts_hat, interp_target)}


class MAgNetCNN1D(MAgNetCNNTask, MAgNetCNN1DCore):
    """MAgNet[CNN] 1D: the core with the task side.  The core's LR output
    is already per node, (B, T, L, 1)."""

    def __init__(self, hparams: dict[str, Any]):
        hp = dict(hparams)
        super().__init__(
            time_slice=int(hp.get("time_slice", 16)),
            latent_dim=int(hp.get("latent_dim", 32)),
            num_message_passing_steps=int(hp.get("num_message_passing_steps", 10)),
            mlp_layers=int(hp.get("mlp_layers", 4)),
            mlp_hidden=int(hp.get("mlp_hidden", 64)),
            n_chan=int(hp.get("n_chan", 128)),
            kernel_size=int(hp.get("kernel_size", 3)),
            res_scale=float(hp.get("res_scale", 1.0)),
            res_layers=int(hp.get("res_layers", 4)),
            graph_dtype=parse_dtype(hp.get("graph_dtype")),
            remat=bool(hp.get("remat", False)),
        )
        self._task_init(hp, radius=0.08)

    def _resampled_input(self, out_hr, size: int):
        return interpolate_linear_1d(out_hr[..., 0], size)[:, :, None, :]

    def _output_input(self, out_lr):
        return out_lr.transpose(2, 3)                               # (B, T, 1, L)

    def _as_nodes(self, frames):
        return frames.transpose(2, 3)

    def _output_nodes(self, lr_hat):
        return lr_hat
