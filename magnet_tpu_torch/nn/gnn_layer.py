"""Brandstetter-style MPNN message-passing layer and the temporal-bundling
decoder (counterpart of ``magnet_tpu/nn/gnn_layer.py``).

Every module works on one batch-flattened graph (``ops.graph.CSRGraph``):
node rows (B*N, C), sample b's nodes at rows b*N:(b+1)*N.  Submodule names
are the reference's, so the ``state_dict`` keys are too.
"""
from __future__ import annotations

import torch
from torch import nn

from magnet_tpu_torch.nn.segment import segment_instance_norm
from magnet_tpu_torch.ops.graph import CSRGraph, lane_of
from magnet_tpu_torch.ops.mpnn_edge import (
    fused_mpnn_edge_agg,
    fused_mpnn_edge_agg2r,
    fused_mpnn_edge_agg2r_plain,
)
from magnet_tpu_torch.ops.segment import gather_rows

#: ``kernel``: the graph's lane, the one the JAX package's MPNN layer takes
#: on it: ``gather`` (both node gathers inside the fused kernel) where its
#: sender table fits the TPU's fast memory, else ``pregathered`` (the
#: sender rows gathered into an (E, H) array first, whose backward is the
#: segment-sum kernel over the sender CSR); ``kernel_gather`` /
#: ``kernel_pregathered``: that lane whatever the graph; ``plain``: the
#: plain PyTorch version on any device.
IMPLS = ("kernel", "kernel_gather", "kernel_pregathered", "plain")


class MPNNLayer(nn.Module):
    """One GNN_Layer: message MLP on (x_i, x_j, u_i - u_j, pos_i - pos_j,
    var_i), mean over the incoming edges, update MLP on (x, mean, var),
    residual when in == out, then InstanceNorm over each sample's nodes.

    ``message_net_1`` is the reference's unsplit Linear over the
    concatenated edge input.  The forward slices its weight into the
    x_i | x_j | u | pos | var column chunks and applies them to the N node
    rows, not the E edges: the receiver side ``W_xi x + W_u u + W_p pos +
    W_v var + b`` and the sender side ``W_xj x - W_u u - W_p pos`` are
    summed per edge inside the fused kernel, which also runs
    ``message_net_2`` between its two swishes and the receiver sum.
    """

    def __init__(self, hidden_features: int, out_features: int,
                 pos_dim: int = 1, time_window: int = 16):
        super().__init__()
        h = hidden_features
        self.hidden, self.out_features = h, out_features
        self.time_window, self.pos_dim = time_window, pos_dim
        self.message_net_1 = nn.Sequential(
            nn.Linear(2 * h + time_window + pos_dim + 1, h))
        self.message_net_2 = nn.Sequential(nn.Linear(h, h))
        self.update_net_1 = nn.Sequential(nn.Linear(2 * h + 1, h))
        self.update_net_2 = nn.Sequential(nn.Linear(h, out_features))

    def project(self, x, u, pos, variables):
        """The receiver-side and sender-side node tables, (N, H) each."""
        lin = self.message_net_1[0]
        h, tw, p = self.hidden, self.time_window, self.pos_dim
        w_xi, w_xj, w_u, w_p, w_v = lin.weight.split([h, h, tw, p, 1], dim=1)
        p_up = u @ w_u.t() + pos @ w_p.t()
        recv_side = x @ w_xi.t() + p_up + variables @ w_v.t() + lin.bias
        send_side = x @ w_xj.t() - p_up
        return recv_side, send_side

    def messages(self, send_side, recv_side, graph: CSRGraph,
                 impl: str = "kernel"):
        """The per-receiver sums of the message tail over ``graph``'s edges,
        (N, H), by the graph's lane (``impl``)."""
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        lin2 = self.message_net_2[0]
        w2 = lin2.weight.t().contiguous()                     # (in, out)
        lane = (lane_of(graph, "mpnn", self.hidden) if impl == "kernel"
                 else impl.removeprefix("kernel_"))
        if lane == "pregathered":
            return fused_mpnn_edge_agg(gather_rows(send_side, graph),
                                       recv_side, w2, lin2.bias, graph.rowptr)
        fn = (fused_mpnn_edge_agg2r if lane == "gather"
              else fused_mpnn_edge_agg2r_plain)
        return fn(send_side, recv_side, w2, lin2.bias, graph.senders,
                  graph.rowptr)

    def update(self, x, agg, variables):
        """The update MLP on (x, mean message, variables), residual when
        in == out; before the InstanceNorm."""
        upd = torch.cat([x, agg, variables], dim=-1)
        upd = nn.functional.silu(self.update_net_1(upd))
        upd = nn.functional.silu(self.update_net_2(upd))
        return x + upd if x.shape[-1] == self.out_features else upd

    def forward(self, x, u, pos, variables, graph: CSRGraph, batch_size: int,
                impl: str = "kernel"):
        """x (B*N, H), u (B*N, tw), pos (B*N, P), variables (B*N, 1)."""
        recv_side, send_side = self.project(x, u, pos, variables)
        sums = self.messages(send_side, recv_side, graph, impl)
        agg = sums / torch.clamp(graph.degree, min=1.0)[:, None]
        return segment_instance_norm(self.update(x, agg, variables),
                                     batch_size)


class TemporalBundlingDecoder(nn.Sequential):
    """The strided Conv1d pair mapping (N, hidden) -> (N, time_window):
    Conv1d(1 -> 8, k1, stride s1) [Swish] Conv1d(8 -> 1, k2), kernel sizes
    and stride keyed on ``time_window`` as the reference hand-picks them for
    hidden = 128.  ``with_mid_swish`` tells the 1D time_window == 10 variant
    (no Swish between the convolutions, second Conv1d at index 1) from the
    others (second Conv1d at index 2)."""

    # time_window: (k1, s1, k2)
    TABLE = {10: (16, 6, 10), 16: (16, 5, 8), 20: (15, 4, 10),
             25: (16, 3, 14), 50: (12, 2, 10)}

    def __init__(self, time_window: int, with_mid_swish: bool = True):
        if time_window not in self.TABLE:
            raise ValueError(f"time_window must be one of "
                             f"{sorted(self.TABLE)}, got {time_window}")
        k1, s1, k2 = self.TABLE[time_window]
        mid = [nn.SiLU()] if with_mid_swish else []
        super().__init__(nn.Conv1d(1, 8, k1, stride=s1), *mid,
                         nn.Conv1d(8, 1, k2))

    def forward(self, h):
        """h (N, hidden) -> (N, time_window)."""
        return super().forward(h[:, None, :])[:, 0, :]
