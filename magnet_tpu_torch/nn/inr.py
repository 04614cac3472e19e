"""Continuous (INR) decoders of MAgNet[CNN] 1D and 2D and of MAgNet[GNN]
(counterpart of ``magnet_tpu/nn/inr.py:38-229``), batched.

1D: two-tap (±dx) nearest grid-sample of the EDSR features, an MLP +
LayerNorm head on each tap, and the area-weighted blend of the two.
2D: the same over four corners, with the reference's diagonal area swap.
k-NN (MAgNet[GNN]): one Linear on each of a query's k nearest support
nodes and the blend of the first two.
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


class INRDecoder2D(nn.Sequential):
    """The 2D ``proj_head = Sequential(MLP, LayerNorm)`` with its sampling:
    four corners (vx, vy) = (-1,-1), (-1,1), (1,-1), (1,1) around each
    query, a nearest sample of the features and field values at each, the
    head on each, and the blend weighted by the area of the diagonally
    opposite corner (the reference's swap ``[3, 2, 1, 0]``).

    forward(x_t (B, T, C, W, W), feat (B, Cf, W, W), cell (B, N, 2),
    coord_hr (B, N, 2), t (B, T_total)) -> (B, N, T, n_chan).
    """

    def __init__(self, n_chan: int, in_fields: int, mlp_layers: int,
                 mlp_hidden: int):
        # input per corner: features, field values, coord (2), cell (2), t
        in_dim = n_chan + in_fields + 5
        super().__init__(MLP(in_dim, [mlp_hidden] * mlp_layers, n_chan),
                         nn.LayerNorm(n_chan))

    def forward(self, x_t, feat, cell, coord_hr, t):
        B, T, C, H, W = x_t.shape
        N = coord_hr.shape[1]
        K = 4
        dx = 1.0 / W
        dev = x_t.device
        feat_coord = make_coord([W, W], device=dev)                 # (W*W, 2)
        vx = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=dev)[None, :, None]
        vy = torch.tensor([-1.0, 1.0, -1.0, 1.0], device=dev)[None, :, None]
        g0 = torch.clamp(coord_hr[:, None, :, 0] + vx * dx + 1e-6,
                         -1 + 1e-6, 1 - 1e-6)                       # (B, 4, N)
        g1 = torch.clamp(coord_hr[:, None, :, 1] + vy * dx + 1e-6,
                         -1 + 1e-6, 1 - 1e-6)
        lin = _nearest_index(g0, H) * W + _nearest_index(g1, W)     # (B, 4, N)
        bi = torch.arange(B, device=dev)[:, None, None]
        q_feat = feat.reshape(B, -1, H * W).transpose(1, 2)[bi, lin]
        q_coord = feat_coord[lin]                                   # (B,4,N,2)
        q_inp = x_t.reshape(B, T, C, H * W).permute(0, 3, 1, 2)[bi, lin]
        final_coord = (coord_hr[:, None] - q_coord) * W             # (B,4,N,2)
        final_cell = (cell[:, None] * W).expand(B, K, N, 2)
        area = (final_coord[..., 0] * final_coord[..., 1]).abs() + 1e-9

        def bt(a):                                      # (B,4,N,D) -> (B,4,N,T,D)
            return a[:, :, :, None, :].expand(B, K, N, T, a.shape[-1])

        tcol = t[:, None, None, :T, None].expand(B, K, N, T, 1)
        inp = torch.cat(
            [bt(q_feat), q_inp, bt(final_coord), bt(final_cell), tcol], dim=-1)
        preds = super().forward(inp)                                # (B,4,N,T,nc)
        weight = area[:, [3, 2, 1, 0]] / area.sum(1, keepdim=True)  # (B, 4, N)
        return (preds * weight[..., None, None]).sum(1)


class KNNDecoder(nn.Linear):
    """MAgNet[GNN]'s continuous decoder (``magnet_tpu/nn/inr.py:160-229``),
    the reference's ``proj_head`` Linear with the k-NN sampling and blend
    around it in ``forward``, so that its parameters keep the key names
    ``proj_head.weight`` / ``bias``.

    Per query: the latent, field values and coordinate offset of each of
    its k nearest support nodes (``nbr_idx``, ascending distance), with the
    window's times, through the Linear; then the blend of the FIRST TWO
    neighbours by their squared distances d2: ``area`` weighs each by the
    other's d2, ``knn`` by its own 1/d2, ``sph`` by (1 - L·d2)³.  Where a
    query coincides with one of those two (min d2 = 0, e.g. under
    ``eval_support='full'``) the result is the nearer one's latent, taken
    by a where-in-where so that the gradients stay free of NaN.

    forward(x_lr (B, T, C, L), lr_encoded (B, L, latent), lr_coords
    (B, L, P), hr_coords (B, N, P), t (B, T_total), nbr_idx (B, N, k))
    -> (B, N, T, n_chan).  The input width is latent + C + P + 1.
    """

    INTERPOLATIONS = ("area", "knn", "sph")

    def __init__(self, in_dim: int, n_chan: int, interpolation: str = "area"):
        if interpolation not in self.INTERPOLATIONS:
            raise ValueError(f"interpolation must be one of "
                             f"{self.INTERPOLATIONS}, got {interpolation!r}")
        super().__init__(in_dim, n_chan)
        self.interpolation = interpolation

    def forward(self, x_lr, lr_encoded, lr_coords, hr_coords, t, nbr_idx):
        B, T, C, L = x_lr.shape
        N, K = nbr_idx.shape[1:]
        idx = nbr_idx.long().transpose(1, 2)                        # (B, K, N)
        bi = torch.arange(B, device=x_lr.device)[:, None, None]
        q_feat = lr_encoded[bi, idx]                                # (B,K,N,lat)
        q_inp = x_lr.permute(0, 3, 1, 2)[bi, idx]                   # (B,K,N,T,C)
        final_coord = lr_coords[bi, idx] - hr_coords[:, None]       # (B,K,N,P)
        d2 = (final_coord ** 2).sum(-1, keepdim=True)               # (B,K,N,1)
        if self.interpolation == "area":
            w = d2
        elif self.interpolation == "knn":
            w = 1.0 / torch.where(d2 > 0, d2, torch.ones_like(d2))
        else:
            w = (1.0 - L * d2) ** 3
        weights = w[:, :, :, None, :]                               # (B,K,N,1,1)

        def bt(a):                                      # (B,K,N,D) -> (B,K,N,T,D)
            return a[:, :, :, None, :].expand(B, K, N, T, a.shape[-1])

        tcol = t[:, None, None, :T, None].expand(B, K, N, T, 1)
        inp = torch.cat([bt(q_feat), q_inp, bt(final_coord), tcol], dim=-1)
        latents = super().forward(inp)                              # (B,K,N,T,nc)
        if self.interpolation == "area":
            num = latents[:, 0] * weights[:, 1] + latents[:, 1] * weights[:, 0]
        else:
            num = latents[:, 0] * weights[:, 0] + latents[:, 1] * weights[:, 1]
        den = weights[:, 1] + weights[:, 0]                         # (B,N,1,1)
        d2_01 = d2[:, :2]                                           # (B,2,N,1)
        degen = (d2_01.min(dim=1).values <= 0)[:, :, None, :]       # (B,N,1,1)
        safe = torch.where(den != 0, den, torch.ones_like(den))
        nearest = (d2_01[:, 0] <= d2_01[:, 1])[:, :, None, :]
        near_lat = torch.where(nearest, latents[:, 0], latents[:, 1])
        return torch.where(degen, near_lat, num / safe)
