"""Continuous (INR) decoder of MAgNet[CNN] 1D (counterpart of
``magnet_tpu/nn/inr.py:38-91``), batched.

Two-tap (±dx) nearest grid-sample of the EDSR features, an MLP +
LayerNorm head on each tap, and the area-weighted blend of the two.
"""
from __future__ import annotations

import torch
from torch import nn

from magnet_tpu_torch.nn.core import MLP
from magnet_tpu_torch.ops.interp import _nearest_index
from magnet_tpu_torch.utils import make_coord


class INRDecoder1D(nn.Sequential):
    """The reference's ``proj_head = Sequential(MLP, LayerNorm)``, with the
    sampling around it in ``forward``; as a Sequential its parameters keep
    the reference's key names (``proj_head.0.layers.*``, ``proj_head.1``).

    forward(x_t (B, T, C, L), feat (B, Cf, L), cell (B, N, 1),
    coord_hr (B, N, 1), t (B, T_total)) -> (B, N, T, n_chan).
    """

    def __init__(self, n_chan: int, in_fields: int, mlp_layers: int,
                 mlp_hidden: int):
        # input per tap: features, field values, coord, cell, t
        in_dim = n_chan + in_fields + 3
        super().__init__(MLP(in_dim, [mlp_hidden] * mlp_layers, n_chan),
                         nn.LayerNorm(n_chan))

    def forward(self, x_t, feat, cell, coord_hr, t):
        B, T, C, L = x_t.shape
        N = coord_hr.shape[1]
        dev = x_t.device
        feat_coord = make_coord([L], device=dev)[:, 0]              # (L,)
        dx = 1.0 / L
        vx = torch.tensor([-1.0, 1.0], device=dev)
        gx = torch.clamp(
            coord_hr[:, None, :, 0] + vx[None, :, None] * dx + 1e-6,
            -1 + 1e-6, 1 - 1e-6)                                    # (B, 2, N)
        idx = _nearest_index(gx, L)                                 # (B, 2, N)
        bi = torch.arange(B, device=dev)[:, None, None]
        q_feat = feat.transpose(1, 2)[bi, idx]                      # (B,2,N,Cf)
        q_coord = feat_coord[idx][..., None]                        # (B,2,N,1)
        q_inp = x_t.permute(0, 3, 1, 2)[bi, idx]                    # (B,2,N,T,C)
        final_coord = (coord_hr[:, None] - q_coord) * L             # (B,2,N,1)
        final_cell = (cell[:, None] * L).expand(B, 2, N, 1)
        areas = final_coord.abs()[:, :, :, None, :]                 # (B,2,N,1,1)

        def bt(a):                                      # (B,2,N,D) -> (B,2,N,T,D)
            return a[:, :, :, None, :].expand(B, 2, N, T, a.shape[-1])

        tcol = t[:, None, None, :T, None].expand(B, 2, N, T, 1)
        inp = torch.cat(
            [bt(q_feat), q_inp, bt(final_coord), bt(final_cell), tcol], dim=-1)
        preds = super().forward(inp)                                # (B,2,N,T,nc)

        num = preds[:, 0] * areas[:, 1] + preds[:, 1] * areas[:, 0]
        den = areas[:, 1] + areas[:, 0]
        # den == 0 only when both taps clip into the same cell exactly at
        # its centre on the mesh edge: the blend is then that cell's value
        safe = torch.where(den > 0, den, torch.ones_like(den))
        return torch.where(den > 0, num / safe, preds[:, 0])
