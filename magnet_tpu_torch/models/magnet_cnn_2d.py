"""MAgNet[CNN] 2D (counterpart of ``magnet_tpu/models/magnet_cnn_2d.py``):
the 1D model's architecture with a 2D EDSR encoder and the four-corner INR
decoder, over the graph of the W×W LR grid ∪ the N HR queries of every
sample.  The task side (graph, rollout, losses) is ``MAgNetCNNTask``'s;
the validation feedback reshapes the HR prediction to its √N × √N grid and
resizes it bilinearly to W × W.  ``graph_dtype`` is the GraphNet stage's
compute dtype, as in 1D (``MAgNetCNN1DCore``): in bf16 its training graph
runs the pregathered lane's bf16 kernels and its eval graph the fold
lane's.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from magnet_tpu_torch.models.common import parse_dtype
from magnet_tpu_torch.models.magnet_cnn_1d import MAgNetCNNTask
from magnet_tpu_torch.models.partitioned_mixin import encode_process
from magnet_tpu_torch.nn.core import MLP
from magnet_tpu_torch.nn.edsr import EDSR
from magnet_tpu_torch.nn.graphnet import (
    GraphDecoder,
    GraphEncoder,
    GraphProcessor,
)
from magnet_tpu_torch.nn.inr import INRDecoder2D
from magnet_tpu_torch.ops.graph import CSRGraph
from magnet_tpu_torch.ops.interp import interpolate_bilinear_2d
from magnet_tpu_torch.utils import make_coord

N_FIELDS = 1  # one scalar field


class MAgNetCNN2DCore(nn.Module):
    """Single-window forward over a batch.  Submodule names are the
    reference's, so the state_dict keys are too.  ``graph_dtype`` is the
    compute dtype of the GraphNet stage alone (None: f32), as
    ``MAgNetCNN1DCore``'s."""

    def __init__(self, time_slice: int = 16, latent_dim: int = 32,
                 num_message_passing_steps: int = 10, mlp_layers: int = 4,
                 mlp_hidden: int = 64, n_chan: int = 128, kernel_size: int = 3,
                 res_scale: float = 1.0, res_layers: int = 16,
                 graph_dtype=None, remat: bool = False):
        super().__init__()
        tc = time_slice * N_FIELDS
        self.time_slice = time_slice
        self.impl = "kernel"
        self.encoder = EDSR(tc, n_chan=n_chan, res_layers=res_layers,
                            kernel_size=kernel_size, res_scale=res_scale,
                            ndim=2)
        self.proj_head = INRDecoder2D(n_chan, N_FIELDS, mlp_layers, mlp_hidden)
        self.projector = MLP(n_chan, [mlp_hidden] * mlp_layers, 1)
        # node features: values, coords (2), t; edge features: value and
        # coord differences
        self._encoder = GraphEncoder(tc + 3, tc + 2, latent_dim, latent_dim,
                                     mlp_layers, mlp_hidden, graph_dtype)
        self._processor = GraphProcessor(latent_dim, num_message_passing_steps,
                                         mlp_layers, mlp_hidden, graph_dtype,
                                         remat)
        self._decoder = GraphDecoder(latent_dim, time_slice, mlp_layers,
                                     mlp_hidden, graph_dtype)

    def forward(self, x_t, coords, cell, t, hr_last, graph: CSRGraph):
        """x_t (B, T, C, W, W) LR frames, T == time_slice; coords, cell
        (B, N, 2); t (B, 2T) the window's times; hr_last (B, N, 1) last
        known HR values; graph over the B*(W*W+N) nodes (or partitioned).
        Returns (out_hr (B, T, N, 1), out_lr (B, T, C, W, W), hr_points
        (B, T, N, 1))."""
        B, T, C, W, _ = x_t.shape
        N = coords.shape[1]
        WW = W * W
        M = WW + N
        feat = self.encoder(x_t.reshape(B, T * C, W, W))           # (B,Cf,W,W)
        z = self.proj_head(x_t, feat, cell, coords, t)             # (B,N,T,nc)
        hr_points = self.projector(z)                              # (B,N,T,1)

        # node features over LR ∪ HR
        hr_flat = hr_points.reshape(B, N, T * C)
        lr_flat = x_t.permute(0, 3, 4, 1, 2).reshape(B, WW, T * C)
        lr_coords = make_coord([W, W], device=x_t.device)[None].expand(B, WW, 2)
        all_coords = torch.cat([lr_coords, coords], dim=1).reshape(B * M, 2)
        all_feats = torch.cat([lr_flat, hr_flat], dim=1).reshape(B * M, T * C)
        t_last = t[:, T - 1:T, None].expand(B, M, 1).reshape(B * M, 1)
        nf = encode_process(self._encoder, self._processor, all_feats,
                            all_coords, t_last, graph, self.impl)
        ret = self._decoder(nf).reshape(B, M, -1)                  # (B, M, T_out)

        # Euler update
        last_values = torch.cat(
            [x_t[:, -1].permute(0, 2, 3, 1).reshape(B, WW, C), hr_last],
            dim=1)                                                 # (B, M, 1)
        dt = t[:, T:] - t[:, T - 1:T]                              # (B, T_out)
        outputs = (last_values[:, None]
                   + dt[:, :, None, None] * ret.transpose(1, 2)[..., None])
        out_lr = outputs[:, :, :WW].transpose(2, 3).reshape(B, -1, C, W, W)
        return outputs[:, :, WW:], out_lr, hr_points.transpose(1, 2)


class MAgNetCNN2D(MAgNetCNNTask, MAgNetCNN2DCore):
    """MAgNet[CNN] 2D: the core with the task side.  Batch (the samples of
    ``DatasetImplicit2D``): t (B, nt), lr_frames (B, nt, 1, W, W),
    hr_points (B, nt, N, 1), coords (B, N, 2), cells (B, N, 2)."""

    ndim = 2

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
            res_layers=int(hp.get("res_layers", 16)),
            graph_dtype=parse_dtype(hp.get("graph_dtype")),
            remat=bool(hp.get("remat", False)),
        )
        self._task_init(hp, radius=0.1)

    def _resampled_input(self, out_hr, size: int):
        B, T, N = out_hr.shape[:3]
        w_in = int(round(np.sqrt(N)))
        sig = out_hr[..., 0].reshape(B, T, w_in, w_in)
        return interpolate_bilinear_2d(sig, (size, size))[:, :, None]

    def _output_input(self, out_lr):
        return out_lr

    def _as_nodes(self, frames):
        B, T, C = frames.shape[:3]
        return frames.reshape(B, T, C, -1).transpose(2, 3)

    _output_nodes = _as_nodes
