"""GraphNet encoder / InteractionNetwork / processor / decoder (counterpart
of ``magnet_tpu/nn/graphnet.py:39-470``), forward only.

Every module works on one batch-flattened graph (``ops.graph.CSRGraph``):
node rows (N, C) and edge rows (E, C) in receiver-CSR order.

The PyG semantics quirk is kept: an InteractionNetwork step returns
``e + e`` as its edge output (PyG hands ``update`` the original edge
features), so step k sees 2^k·e0, while the fresh edge messages only feed
the node aggregation.  As in the JAX package the doubling is carried as a
power-of-two scale folded into the edge projection weight W_e, so no
(E, C) array is scaled per step.
"""
from __future__ import annotations

import torch
from torch import nn

from magnet_tpu_torch.nn.core import MLP
from magnet_tpu_torch.ops.fused_edge import (
    fused_edge_tail_agg,
    fused_edge_tail_agg_plain,
)
from magnet_tpu_torch.ops.graph import CSRGraph

IMPLS = ("kernel", "plain")


class GraphEncoder(nn.Module):
    """Independent node and edge embedders, each MLP + LayerNorm."""

    def __init__(self, node_in: int, edge_in: int, node_out: int,
                 edge_out: int, mlp_layers: int, mlp_hidden: int):
        super().__init__()
        hidden = [mlp_hidden] * mlp_layers
        self.node_fn = nn.Sequential(MLP(node_in, hidden, node_out),
                                     nn.LayerNorm(node_out))
        self.edge_fn = nn.Sequential(MLP(edge_in, hidden, edge_out),
                                     nn.LayerNorm(edge_out))

    def forward(self, node_feats, edge_feats):
        return self.node_fn(node_feats), self.edge_fn(edge_feats)


class InteractionNetwork(nn.Module):
    """One message-passing step with the reference's unsplit first edge
    Linear (H, 3C) over ``[x_i | x_j | e]``.

    The forward slices that weight: the x_i and x_j chunks are applied once
    to the N node rows (p_xi, p_xj) and gathered per edge inside the fused
    edge kernel, which also applies the e chunk to e0 (fold-e), runs the
    tail MLP and LayerNorm and sums per receiver.
    """

    def __init__(self, latent: int, mlp_layers: int, mlp_hidden: int):
        super().__init__()
        hidden = [mlp_hidden] * mlp_layers
        self.latent = latent
        self.edge_fn = nn.Sequential(MLP(3 * latent, hidden, latent),
                                     nn.LayerNorm(latent))
        self.node_fn = nn.Sequential(MLP(2 * latent, hidden, latent),
                                     nn.LayerNorm(latent))

    def edge_weights(self, e_scale: float):
        """The fused kernel's weight operands, all (in, out):
        (we, be, w_rest, b_rest, w_out, b_out, ln_s, ln_b), with the edge
        scale folded into we (exact: e_scale is a power of two)."""
        lin = self.edge_fn[0].linears
        c = self.latent
        we = (lin[0].weight[:, 2 * c:].t() * e_scale).contiguous()
        hid = lin[1:-1]
        h = lin[0].weight.shape[0]
        if hid:
            w_rest = torch.stack([m.weight.t() for m in hid])
            b_rest = torch.stack([m.bias for m in hid])
        else:
            w_rest = lin[0].weight.new_zeros(0, h, h)
            b_rest = lin[0].weight.new_zeros(0, h)
        ln = self.edge_fn[1]
        return (we, lin[0].bias, w_rest, b_rest,
                lin[-1].weight.t().contiguous(), lin[-1].bias, ln.weight,
                ln.bias)

    def forward(self, x, e0, graph: CSRGraph, e_scale: float = 1.0,
                impl: str = "kernel"):
        """x (N, C) node latents; e0 (E, C) step-0 edge latents, the step's
        edge input being e_scale·e0.  Returns the updated node latents."""
        w0 = self.edge_fn[0].linears[0].weight                   # (H, 3C)
        c = self.latent
        p_xi = x @ w0[:, :c].t()                                 # (N, H)
        p_xj = x @ w0[:, c:2 * c].t()                            # (N, H)
        we, be, w_rest, b_rest, w_out, b_out, ln_s, ln_b = \
            self.edge_weights(e_scale)
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        fn = fused_edge_tail_agg if impl == "kernel" else fused_edge_tail_agg_plain
        agg_sum = fn(e0, we, be, p_xj, p_xi, graph.senders, graph.rowptr,
                     w_rest, b_rest, w_out, b_out, ln_s, ln_b)
        agg = agg_sum / torch.clamp(graph.degree, min=1.0)[:, None]
        return x + self.node_fn(torch.cat([agg, x], dim=-1))


class GraphProcessor(nn.Module):
    """A stack of InteractionNetworks; step k gets the edge scale 2^k."""

    def __init__(self, latent: int, num_steps: int, mlp_layers: int,
                 mlp_hidden: int):
        super().__init__()
        self.gnn_stacks = nn.ModuleList(
            InteractionNetwork(latent, mlp_layers, mlp_hidden)
            for _ in range(num_steps))

    def forward(self, x, e0, graph: CSRGraph, impl: str = "kernel"):
        """Returns the node latents.  The reference's edge output,
        e0·2^num_steps, is read by no caller and is not formed."""
        scale = 1.0
        for step in self.gnn_stacks:
            x = step(x, e0, graph, e_scale=scale, impl=impl)
            scale *= 2.0
        return x


class GraphDecoder(nn.Module):
    """Node MLP head."""

    def __init__(self, latent: int, node_out: int, mlp_layers: int,
                 mlp_hidden: int):
        super().__init__()
        self.node_fn = MLP(latent, [mlp_hidden] * mlp_layers, node_out)

    def forward(self, x):
        return self.node_fn(x)
