"""MAgNet[CNN] 1D, the flagship model: forward and the no-teacher-forcing
eval rollout (counterpart of ``magnet_tpu/models/magnet_cnn_1d.py``).

Per window: EDSR features of the stacked LR frames -> INR decoder at the HR
query coords -> projector seeds HR values -> GraphNet (encoder, processor,
decoder) over the LR ∪ HR nodes -> per-node Euler update.

The radius graph over LR ∪ HR coords is built once per batch on the host
(coords do not change over the rollout) and flattened over the batch, so
every processor step is one fused-edge kernel launch for the whole batch.
The rollout over windows is a Python loop.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from magnet_tpu_torch.models.common import LOSSES, l1_loss, time_windows
from magnet_tpu_torch.nn.core import MLP
from magnet_tpu_torch.nn.edsr import EDSR
from magnet_tpu_torch.nn.graphnet import (
    GraphDecoder,
    GraphEncoder,
    GraphProcessor,
)
from magnet_tpu_torch.nn.inr import INRDecoder1D
from magnet_tpu_torch.ops.graph import CSRGraph, radius_graph_batch
from magnet_tpu_torch.ops.interp import interpolate_linear_1d
from magnet_tpu_torch.utils import make_coord, make_coord_np

N_FIELDS = 1  # one scalar field in 1D


class MAgNetCNN1DCore(nn.Module):
    """Single-window forward over a batch.  Submodule names are the
    reference's, so the state_dict keys are too."""

    def __init__(self, time_slice: int = 16, latent_dim: int = 32,
                 num_message_passing_steps: int = 10, mlp_layers: int = 4,
                 mlp_hidden: int = 64, n_chan: int = 128, kernel_size: int = 3,
                 res_scale: float = 1.0, res_layers: int = 4):
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
                                     mlp_layers, mlp_hidden)
        self._processor = GraphProcessor(latent_dim, num_message_passing_steps,
                                         mlp_layers, mlp_hidden)
        self._decoder = GraphDecoder(latent_dim, time_slice, mlp_layers,
                                     mlp_hidden)

    def forward(self, x_t, coords, cell, t, hr_last, graph: CSRGraph):
        """x_t (B, T, C, L) LR frames, T == time_slice; coords, cell
        (B, N, 1); t (B, 2T) the window's times; hr_last (B, N, 1) last
        known HR values; graph over the B*(L+N) nodes.  Returns (out_hr
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
        node_feats = torch.cat([all_feats, all_coords, t_last], dim=-1)

        s, r = graph.senders, graph.receivers
        edge_feats = torch.cat(
            [all_feats.index_select(0, s) - all_feats.index_select(0, r),
             all_coords.index_select(0, s) - all_coords.index_select(0, r)],
            dim=-1)
        nf, ef = self._encoder(node_feats, edge_feats)
        nf = self._processor(nf, ef, graph, impl=self.impl)
        ret = self._decoder(nf).reshape(B, M, -1)                  # (B, M, T_out)

        # Euler update
        last_values = torch.cat(
            [x_t[:, -1].transpose(1, 2), hr_last], dim=1)          # (B, M, 1)
        dt = t[:, T:] - t[:, T - 1:T]                              # (B, T_out)
        outputs = (last_values[:, None]
                   + dt[:, :, None, None] * ret.transpose(1, 2)[..., None])
        return outputs[:, :, L:], outputs[:, :, :L], hr_points.transpose(1, 2)


class MAgNetCNN1D(MAgNetCNN1DCore):
    """Task wrapper: host graph building, the eval rollout and its loss.

    Batch dict of tensors: t (B, nt), lr_frames (B, nt, 1, L), hr_points
    (B, nt, N, 1), coords (B, N, 1), cells (B, N, 1).
    """

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
        )
        self.radius = float(hp.get("radius", 0.08))
        self.criterion = LOSSES[hp.get("loss", "l1")]

    def build_graph(self, batch) -> CSRGraph:
        """The radius graph over LR ∪ HR coords of every sample, flattened
        over the batch, on the model's device."""
        coords = batch["coords"].detach().cpu().numpy()            # (B, N, 1)
        L = batch["lr_frames"].shape[-1]
        lr = make_coord_np([L])
        all_coords = np.concatenate(
            [np.broadcast_to(lr[None], (coords.shape[0],) + lr.shape), coords],
            axis=1)
        graph = radius_graph_batch(torch.from_numpy(all_coords), self.radius,
                                   loop=True)
        return graph.to(next(self.parameters()).device)

    @torch.no_grad()
    def predict(self, batch, graph: CSRGraph):
        """No-teacher-forcing rollout (eval / super-resolution): each
        window's input is its predecessor's HR output resampled to the LR
        length.  Returns (hr_hat (B, n*ts, N, 1), lr_hat (B, n*ts, L, 1))."""
        ts = self.time_slice
        u, uv, t = batch["lr_frames"], batch["hr_points"], batch["t"]
        L = u.shape[-1]
        n_win = (u.shape[1] - ts) // ts
        t_win = time_windows(t, n_win, ts)                         # (B, n, 2ts)
        inp, hr_last = u[:, :ts], uv[:, ts - 1]
        hr_seq, lr_seq = [], []
        for w in range(n_win):
            out_hr, out_lr, _ = self(inp, batch["coords"], batch["cells"],
                                     t_win[:, w], hr_last, graph)
            inp = interpolate_linear_1d(out_hr[..., 0], L)[:, :, None, :]
            hr_last = out_hr[:, -1]
            hr_seq.append(out_hr)
            lr_seq.append(out_lr)
        return torch.cat(hr_seq, dim=1), torch.cat(lr_seq, dim=1)

    def rollout_target(self, batch, horizon: int):
        """Ground truth of the HR rollout: ``hr_points`` shifted by
        ``time_slice``."""
        ts = self.time_slice
        return batch["hr_points"][:, ts:ts + horizon]

    def eval_metrics(self, batch, hr_hat):
        """``loss(train=False)``'s metrics from a finished rollout."""
        target = self.rollout_target(batch, hr_hat.shape[1])
        loss = self.criterion(hr_hat, target)
        return loss, {"loss": loss, "mae_loss": l1_loss(hr_hat, target)}

    def loss(self, batch, graph: CSRGraph, train: bool = False):
        """Eval loss of the rollout; training waits for the next slice."""
        if train:
            raise NotImplementedError("training is not ported yet")
        hr_hat, _ = self.predict(batch, graph)
        return self.eval_metrics(batch, hr_hat)
