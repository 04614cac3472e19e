"""MAgNet[CNN] no-interaction ablation: EDSR features of the downsampled
frames, a recurrent INR decoder that threads an LSTM-sized latent through
both taps and every timestep, the sinusoidal position encoding, the
seq2seq LSTM with attention over the future steps, MLP decode and Euler
update (counterpart of ``magnet_tpu/models/magnet_cnn_no_interaction.py``).

No graph stage and no kernel of the port: EDSR runs on cuDNN's
convolutions, the seq2seq on cuDNN's LSTM, the rest on plain PyTorch.

Written behaviour kept from the JAX model:
  * a fresh standard-normal latent (B, N, H) for every window, from one
    method of the model (``draw_latent``); ``predict`` and the eval loss
    draw from a generator seeded 0 anew on every call, as the JAX model
    uses ``PRNGKey(0)`` for every ``predict``; training draws from the
    model's own generator;
  * inside a timestep the vx = +1 tap reads the latent the vx = -1 tap just
    wrote, and the next timestep starts from the vx = +1 latent;
  * training feeds ground-truth frames as the next window's input; without
    teacher forcing the predictions are written into them at
    ``sample_idx`` first.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from magnet_tpu_torch.models.common import (
    GENERATOR_SEED,
    LOSSES,
    OwnGenerator,
    l1_loss,
    time_windows,
)
from magnet_tpu_torch.nn.core import MLP
from magnet_tpu_torch.nn.edsr import EDSR
from magnet_tpu_torch.nn.lstm import AttnSeq2Seq
from magnet_tpu_torch.ops.interp import _nearest_index, interpolate_linear_1d
from magnet_tpu_torch.utils import make_coord

N_FIELDS = 1  # one scalar field in 1D


def recurrent_inr(proj_head: nn.Linear, x_t, feat, cell, coords, t, latent0):
    """The recurrent INR decode over a batch (the JAX ``RecurrentINR``,
    whose one Linear is the model's top-level ``proj_head``).  x_t (B, T,
    C, L) the frames on the feature grid, feat (B, Cf, L), cell and coords
    (B, N, 1), t (B, >= T) (the first T times are scanned), latent0
    (B, N, H).  Returns (B, T, N, H): at each timestep the two taps' latents
    blended by the distance to the other tap's cell centre."""
    b, n_t, c, length = x_t.shape
    n = coords.shape[1]
    feat_coord = make_coord([length], device=x_t.device)[:, 0]
    dx = 1.0 / length
    taps = []
    for vx in (-1.0, 1.0):
        gx = torch.clamp(coords[..., 0] + vx * dx + 1e-6, -1 + 1e-6, 1 - 1e-6)
        idx = _nearest_index(gx, length)                           # (B, N)
        q_feat = torch.gather(
            feat, 2, idx[:, None].expand(-1, feat.shape[1], -1))   # (B, Cf, N)
        q_inp = torch.gather(x_t, 3, idx[:, None, None].expand(b, n_t, c, n))
        fc = (coords - feat_coord[idx][..., None]) * length        # (B, N, 1)
        taps.append((q_feat.transpose(1, 2), q_inp.transpose(2, 3), fc,
                     cell * length))
    area0, area1 = taps[0][2].abs(), taps[1][2].abs()
    latent, out = latent0, []
    for i in range(n_t):
        ti = t[:, i, None, None].expand(b, n, 1)
        preds = []
        for q_feat, q_inp, fc, fcell in taps:
            latent = proj_head(torch.cat(
                [q_feat, q_inp[:, i], fc, fcell, latent, ti], dim=-1))
            preds.append(latent)
        out.append((preds[0] * area1 + preds[1] * area0) / (area1 + area0))
    return torch.stack(out, dim=1)


class NoInteractionCore(AttnSeq2Seq):
    """Single-window forward over a batch.  The seq2seq's layers and the
    others sit at the top level under the reference's names (``encoder``,
    ``proj_head``, ``lstm_encoder``, ``lstm_decoder``, ``attn``,
    ``layernorm``, ``decoder``), so the state_dict keys are the
    reference's."""

    def __init__(self, time_slice: int = 16, lstm_hidden: int = 256,
                 lstm_layers: int = 4, mlp_layers: int = 1,
                 mlp_hidden: int = 32, scales: int = 1, n_chan: int = 128,
                 kernel_size: int = 3, res_scale: float = 1.0,
                 res_layers: int = 16):
        super().__init__(lstm_hidden + 2, lstm_hidden, lstm_layers)
        self.time_slice = time_slice
        self.lstm_hidden = lstm_hidden
        self.scales = scales
        self.encoder = EDSR(time_slice * N_FIELDS, n_chan=n_chan,
                            res_layers=res_layers, kernel_size=kernel_size,
                            res_scale=res_scale)
        # q_feat, q_inp, fc, fcell, latent, t
        self.proj_head = nn.Linear(n_chan + N_FIELDS + 3 + lstm_hidden,
                                   lstm_hidden)
        self.layernorm = nn.LayerNorm(lstm_hidden)
        self.decoder = MLP(lstm_hidden, [mlp_hidden] * mlp_layers, 1)

    def forward(self, x_t, coords, cell, t, hr_last, latent0):
        """x_t (B, T, C, L) full-resolution frames, T == time_slice; coords,
        cell (B, N, 1); t (B, 2T) the window's times; hr_last (B, N, 1) the
        last known values at the queries; latent0 (B, N, H).  Returns
        (B, T, N, 1)."""
        b, n_t, c, length = x_t.shape
        n = coords.shape[1]
        t_out = t.shape[-1] - n_t
        z = 0.0
        for s in range(1, self.scales + 1):
            x_lr = interpolate_linear_1d(x_t.reshape(b, n_t * c, length),
                                         length // 2 ** s)
            z = z + recurrent_inr(self.proj_head, x_lr.reshape(b, n_t, c, -1),
                                  self.encoder(x_lr), cell, coords, t, latent0)
        pe = torch.cat([torch.sin(2 * np.pi * coords),
                        torch.cos(2 * np.pi * coords)], dim=-1)     # (B, N, 2)
        z = torch.cat([z.transpose(1, 2), pe[:, :, None].expand(b, n, n_t, 2)],
                      dim=-1).reshape(b * n, n_t, self.lstm_hidden + 2)
        out, _ = super().forward(z, t_out)                    # (B*N, T_out, H)
        ret = self.decoder(self.layernorm(out)).reshape(b, n, t_out)
        dt = t[:, n_t:] - t[:, n_t - 1:n_t]                        # (B, T_out)
        return hr_last[:, None] + dt[:, :, None, None] * ret.transpose(1, 2)[
            ..., None]


class MAgNetCNNNoInteraction(OwnGenerator, NoInteractionCore):
    """The core with the task side: the rollout over windows with its three
    feedback branches, and the losses.  Batch dict of tensors
    (``DatasetImplicit1D``): t (B, nt), hr_frames (B, nt, 1, L), hr_points
    (B, nt, N, 1), coords and cells (B, N, 1), in training sample_idx
    (B, N)."""

    def __init__(self, hparams: dict[str, Any]):
        hp = dict(hparams)
        super().__init__(
            time_slice=int(hp.get("time_slice", 16)),
            lstm_hidden=int(hp.get("lstm_hidden", 256)),
            lstm_layers=int(hp.get("lstm_layers", 4)),
            mlp_layers=int(hp.get("mlp_layers", 1)),
            mlp_hidden=int(hp.get("mlp_hidden", 32)),
            scales=int(hp.get("scales", 1)),
            n_chan=int(hp.get("n_chan", 128)),
            kernel_size=int(hp.get("kernel_size", 3)),
            res_scale=float(hp.get("res_scale", 1.0)),
            res_layers=int(hp.get("res_layers", 16)),
        )
        self.teacher_forcing = bool(hp.get("teacher_forcing", False))
        self.criterion = LOSSES[hp.get("loss", "l1")]

    def build_graph(self, batch):
        return None

    def draw_latent(self, shape, generator: torch.Generator):
        """Standard normal draws of ``shape`` for a window's first latent:
        the one place it is drawn."""
        return torch.randn(shape, generator=generator,
                           device=generator.device)

    def _rollout(self, batch, teacher_forcing: bool, scatter_feedback: bool,
                 generator: torch.Generator):
        """One core call per window.  The next window's input is the ground
        truth (``teacher_forcing``), else the ground truth with this
        window's predictions written in at ``sample_idx``
        (``scatter_feedback``, where the batch has it), else the
        predictions themselves (which needs queries on every mesh point,
        N == L).  Returns (B, n*ts, N, 1)."""
        ts = self.time_slice
        u, uv, t = batch["hr_frames"], batch["hr_points"], batch["t"]
        b, nt, _, length = u.shape
        n = uv.shape[2]
        n_win = (nt - ts) // ts
        t_win = time_windows(t, n_win, ts)                         # (B, n, 2ts)
        sample_idx = batch.get("sample_idx") if scatter_feedback else None
        if not teacher_forcing and sample_idx is None and n != length:
            raise ValueError(
                f"feeding the predictions back needs a query at every mesh "
                f"point: N = {n}, L = {length}")
        inp, hr_last = u[:, :ts], uv[:, ts - 1]
        ys = []
        for w in range(n_win):
            y = self(inp, batch["coords"], batch["cells"], t_win[:, w],
                     hr_last, self.block_draw(self.draw_latent,
                                               (b, n, self.lstm_hidden),
                                               generator))  # (B, ts, N, 1)
            if teacher_forcing:
                inp = u[:, (w + 1) * ts:(w + 2) * ts]
                hr_last = uv[:, (w + 2) * ts - 1]
            elif sample_idx is not None:
                frames = u[:, (w + 1) * ts:(w + 2) * ts]           # (B,ts,C,L)
                written = frames[:, :, 0].scatter(
                    -1, sample_idx[:, None].expand(b, ts, n), y[..., 0])
                inp = torch.cat([written[:, :, None], frames[:, :, 1:]], dim=2)
                hr_last = y[:, -1]
            else:
                inp = y.transpose(2, 3)                            # (B,ts,1,L)
                hr_last = y[:, -1]
            ys.append(y)
        return torch.cat(ys, dim=1)

    @torch.no_grad()
    def predict(self, batch, graph=None):
        """No-teacher-forcing rollout, each window's predictions the next
        window's input, latents from a new generator seeded
        ``GENERATOR_SEED``.  Returns (B, n*ts, N, 1)."""
        generator = torch.Generator(
            device=next(self.parameters()).device).manual_seed(GENERATOR_SEED)
        return self._rollout(batch, teacher_forcing=False,
                             scatter_feedback=False, generator=generator)

    def rollout_target(self, batch, horizon: int):
        """Ground truth of the rollout: ``hr_points`` shifted by
        ``time_slice``."""
        ts = self.time_slice
        return batch["hr_points"][:, ts:ts + horizon]

    def eval_metrics(self, batch, pred):
        """``loss(train=False)``'s metrics from ``predict``'s output."""
        target = self.rollout_target(batch, pred.shape[1])
        loss = self.criterion(pred, target)
        return loss, {"loss": loss, "mae_loss": l1_loss(pred, target)}

    def loss(self, batch, graph=None, train: bool = True,
             generator: Optional[torch.Generator] = None):
        """``train``: the differentiable training loss of the rollout with
        teacher forcing as configured, else with the predictions written
        into the ground truth at ``sample_idx``; latents from ``generator``
        (default: the model's own).  Otherwise the eval loss of
        ``predict``'s rollout, under ``no_grad``.  Metrics ``loss`` and
        ``mae_loss``."""
        if not train:
            return self.eval_metrics(batch, self.predict(batch))
        if generator is None:
            generator = self.default_generator()
        y_hat = self._rollout(batch, self.teacher_forcing,
                              scatter_feedback=True, generator=generator)
        return self.eval_metrics(batch, y_hat)
