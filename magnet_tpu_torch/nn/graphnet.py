"""GraphNet encoder / InteractionNetwork / processor / decoder (counterpart
of ``magnet_tpu/nn/graphnet.py:39-470``).

Every module works on one batch-flattened graph (``ops.graph.CSRGraph``):
node rows (N, C) and edge rows (E, C) in receiver-CSR order.

The PyG semantics quirk is kept: an InteractionNetwork step returns
``e + e`` as its edge output (PyG hands ``update`` the original edge
features), so step k sees 2^k·e0, while the fresh edge messages only feed
the node aggregation.  As in the JAX package the doubling is carried as a
power-of-two scale folded into the edge projection weight W_e, so no
(E, C) array is scaled per step.

Which fused kernel a step runs is its lane (``ops.graph.lane_of``): the
one the JAX package's GraphNet takes on the same graph.  ``fold`` gathers
both node sides and projects e0 inside the kernel; ``pregathered`` forms
h0 = p_xj[senders] + e0·W_e + b_e per edge first (the gather's backward is
the segment-sum kernel over the sender CSR) and runs the kernel on h0.
The lane decides which kernel runs, never what is computed.

``impl="kernel_pe"`` is the JAX GraphNet's lane under
``MAGNET_TPU_NO_FUSED2R`` (``ops.graph.graphnet_pe_lane``): a third lane,
``pe``, where its ``_fused2_mode`` is not None (the graph has the
sender-tile and the sender-transpose layouts: MAgNet[CNN] 1D's graphs, 2D's
eval graph, every MAgNet[GNN] graph), and ``pregathered`` where it is None
(MAgNet[CNN] 2D's training graph).  On ``pe``, pe = e0·W_e + b_e is formed
per edge and the ``pe`` entry gathers the sender rows in its kernel (#6;
backward #7, with d_p_xj by the segment-sum kernel #1), at both widths:
(H, C) = (64, 32) for MAgNet[CNN] 1D and 2D, (128, 128) for MAgNet[GNN].
It is ``fused_edge_tail_agg2``, and it also computes what the JAX
package's no-fold ragged lanes (``fused_edge_tail_agg2r`` / ``2h``)
compute; the port sends those lanes to ``fold``.  ``impl=
"kernel_pregathered"`` (the JAX lane under ``MAGNET_TPU_NO_FUSED2``) runs
``pregathered`` on every graph, at (64, 32) and (128, 128) in f32 and bf16.

Every module takes a compute ``dtype`` (None: f32), the JAX models'
``graph_dtype``.  In bf16 (``magnet_tpu/nn/graphnet.py``, the flax modules'
``dtype=jnp.bfloat16``) the parameters stay f32 and are rounded to bf16
where they are used; the MLPs and LayerNorms follow flax's dtype semantics
(``nn.core.dense``, ``nn.core.LayerNorm``); the processor casts the node
and edge latents to bf16 at its entry, so the node stream is bf16 across
its steps; each step's edge kernel is the bf16 build of its lane's entry
(``fused_edge_tail_agg_bf16`` on ``fold``,
``fused_edge_tail_agg_pregathered_bf16`` on ``pregathered``: bf16
operands, f32 accumulation, LayerNorm and receiver sums, an f32 result),
whose per-receiver mean is rounded to bf16 before the node MLP, and the
residual is a bf16 add.  On the ``pregathered`` lane h0 is formed as the
JAX step forms it in bf16 (``_project_edges``, ``graphnet.py:175-189,
357-360``): pe = bf16 Dense(e0) with its bias, then s·pe + (1 − s)·b_e,
then h0 = p_xj[senders] + pe, every operation in bf16 (the f32 lane's
fold of s into W_e would round the bias term elsewhere).  On the ``pe``
lane (``impl="kernel_pe"``) pe is formed the same way and the pe entry's
bf16 build (``fused_edge_tail_agg_pe_bf16``, width 64 for MAgNet[CNN] and 128 for
MAgNet[GNN]) gathers p_xj in its kernel; its d_p_xj is the f32 segment sum
of the unrounded dz, rounded once, as the JAX VJP of
``fused_edge_tail_agg2`` forms it.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from magnet_tpu_torch.nn.core import MLP, LayerNorm
from magnet_tpu_torch.ops.fused_edge import (
    fused_edge_tail_agg,
    fused_edge_tail_agg_bf16,
    fused_edge_tail_agg_pe,
    fused_edge_tail_agg_pe_bf16,
    fused_edge_tail_agg_plain,
    fused_edge_tail_agg_pregathered,
    fused_edge_tail_agg_pregathered_bf16,
)
from magnet_tpu_torch.ops.graph import CSRGraph, lane_of
from magnet_tpu_torch.ops.segment import gather_rows
from magnet_tpu_torch.utils import device_constant

#: ``kernel``: the graph's lane; ``kernel_fold`` / ``kernel_pregathered``:
#: that lane whatever the graph; ``kernel_pe``: the pe lane rule's;
#: ``plain``: the plain PyTorch version (in bf16, of the graph's lane).
IMPLS = ("kernel", "kernel_fold", "kernel_pregathered", "plain", "kernel_pe")


def step_lane(graph: CSRGraph, impl: str, hidden: int) -> str:
    """The lane a step of width ``hidden`` takes on ``graph`` under
    ``impl``: the graph's (``kernel``, ``plain``), the pe lane rule's
    (``kernel_pe``: ``pe`` or ``pregathered``, as the JAX step decides
    under ``MAGNET_TPU_NO_FUSED2R``), or the one named."""
    if impl in ("kernel", "plain"):
        return lane_of(graph, "graphnet", hidden)
    if impl == "kernel_pe":
        return lane_of(graph, "graphnet_pe", hidden)
    return impl.removeprefix("kernel_")


def _rows(t, n: int):
    """t padded with zero rows to n rows: the receiver table of a graph
    whose receivers are its first rows."""
    return t if t.shape[0] == n else nn.functional.pad(
        t, (0, 0, 0, n - t.shape[0]))


class GraphEncoder(nn.Module):
    """Independent node and edge embedders, each MLP + LayerNorm."""

    def __init__(self, node_in: int, edge_in: int, node_out: int,
                 edge_out: int, mlp_layers: int, mlp_hidden: int,
                 dtype=None):
        super().__init__()
        hidden = [mlp_hidden] * mlp_layers
        self.node_fn = nn.Sequential(MLP(node_in, hidden, node_out, dtype),
                                     LayerNorm(node_out, dtype))
        self.edge_fn = nn.Sequential(MLP(edge_in, hidden, edge_out, dtype),
                                     LayerNorm(edge_out, dtype))

    def forward(self, node_feats, edge_feats):
        return self.node_fn(node_feats), self.edge_fn(edge_feats)


class InteractionNetwork(nn.Module):
    """One message-passing step with the reference's unsplit first edge
    Linear (H, 3C) over ``[x_i | x_j | e]``.

    The forward slices that weight: the x_i and x_j chunks are applied once
    to the N node rows (p_xi, p_xj) and gathered per edge, inside the fused
    edge kernel on the ``fold`` lane, which also applies the e chunk to e0
    (fold-e), or before it on the ``pregathered`` lane; on the ``pe`` lane
    the e chunk is applied before the kernel (pe = e0·W_e + b_e, a
    ``torch.matmul``, as the JAX package's ``_project_edges`` leaves it to
    XLA) and the kernel gathers p_xj.  The kernel runs the tail MLP and
    LayerNorm and sums per receiver.  The fused function is
    differentiable in its float operands (its backward is a kernel too);
    the gradient of the slicing, transposing, stacking and the edge scale
    in ``edge_weights`` is autograd's.  In bf16 the step runs the fold
    entry's bf16 build (module docstring); p_xi and p_xj are bias-free
    bf16 Dense outputs, as the JAX step's ``e_w_xi`` / ``e_w_xj``; on the
    ``pregathered`` lane the pregathered entry's bf16 build takes h0 formed
    in bf16 (module docstring), and so does the ``pe`` lane its pe.
    """

    def __init__(self, latent: int, mlp_layers: int, mlp_hidden: int,
                 dtype=None):
        super().__init__()
        hidden = [mlp_hidden] * mlp_layers
        self.latent = latent
        self.dtype = dtype
        self.edge_fn = nn.Sequential(MLP(3 * latent, hidden, latent),
                                     nn.LayerNorm(latent))
        self.node_fn = nn.Sequential(MLP(2 * latent, hidden, latent, dtype),
                                     LayerNorm(latent, dtype))

    def edge_weights(self, e_scale: float):
        """The fused kernel's weight operands, all (in, out):
        (we, be, w_rest, b_rest, w_out, b_out, ln_s, ln_b), with the edge
        scale folded into we (exact: e_scale is a power of two).  In bf16
        every one but ln_s and ln_b is rounded to bf16 (the scale after the
        rounding, as the JAX step folds it)."""
        lin = self.edge_fn[0].linears
        c = self.latent
        we = lin[0].weight[:, 2 * c:].t()
        be = lin[0].bias
        if self.dtype is not None:
            we, be = we.to(self.dtype), be.to(self.dtype)
        return ((we * e_scale).contiguous(), be, *self.tail_weights())

    def tail_weights(self):
        """The fused kernel's tail operands (w_rest, b_rest, w_out, b_out,
        ln_s, ln_b), all (in, out); in bf16 all but ln_s and ln_b rounded
        to bf16."""
        lin = self.edge_fn[0].linears
        cast = ((lambda t: t) if self.dtype is None
                else (lambda t: t.to(self.dtype)))
        hid = lin[1:-1]
        h = lin[0].weight.shape[0]
        if hid:
            w_rest = torch.stack([m.weight.t() for m in hid])
            b_rest = torch.stack([m.bias for m in hid])
        else:
            w_rest = lin[0].weight.new_zeros(0, h, h)
            b_rest = lin[0].weight.new_zeros(0, h)
        ln = self.edge_fn[1]
        return (cast(w_rest), cast(b_rest),
                cast(lin[-1].weight.t().contiguous()), cast(lin[-1].bias),
                ln.weight, ln.bias)

    def _pe_bf16(self, e0, e_scale):
        """The JAX step's bf16 ``_project_edges``: pe = bf16 Dense(e0)
        (product, then bias, each rounded), then s·pe + (1 − s)·b_e with s
        and b_e in bf16, every operation rounded to bf16: (E, H) bf16.  s
        is kept on the device (``utils.device_constant``): a captured step
        copies nothing from the host."""
        lin = self.edge_fn[0].linears[0]
        c, dt = self.latent, self.dtype
        b = lin.bias.to(dt)
        pe = e0 @ lin.weight[:, 2 * c:].t().to(dt) + b
        s = device_constant((e_scale,), e0.device, dt)
        return s * pe + (1 - s) * b

    def _edge_sums_bf16(self, x, e0, graph: CSRGraph, e_scale, impl,
                        n_recv):
        """The bf16 step's sums: x and e0 bf16; the fold, pregathered and pe
        lanes.  In bf16 the lanes round differently, so ``plain`` runs the
        plain versions of the graph's own lane (the sender gather through
        f32, so that autograd's ``index_add_`` sums its backward in f32 and
        rounds once, as the segment sum does)."""
        w0 = self.edge_fn[0].linears[0].weight                   # (H, 3C)
        lane = step_lane(graph, impl, w0.shape[0])
        plain = impl == "plain"
        c = self.latent
        x_r = x[:n_recv]
        p_xi = _rows(x_r @ w0[:, :c].t().to(self.dtype), x.shape[0])
        p_xj = x @ w0[:, c:2 * c].t().to(self.dtype)             # (N, H)
        if lane == "pe":
            agg_sum = fused_edge_tail_agg_pe_bf16(
                self._pe_bf16(e0, e_scale), p_xj, p_xi, graph.senders,
                graph.rowptr, graph.snd_ptr, graph.snd_perm,
                *self.tail_weights())
        elif lane == "pregathered":
            gathered = (p_xj.float().index_select(0, graph.senders)
                        .to(self.dtype) if plain
                        else gather_rows(p_xj, graph))
            h0 = gathered + self._pe_bf16(e0, e_scale)
            agg_sum = fused_edge_tail_agg_pregathered_bf16(
                h0, p_xi, graph.rowptr, *self.tail_weights(), plain=plain)
        else:
            we, be, *tail = self.edge_weights(e_scale)
            agg_sum = fused_edge_tail_agg_bf16(
                e0, we, be, p_xj, p_xi, graph.senders, graph.rowptr, *tail,
                plain=plain)
        return agg_sum

    def node_update(self, x_r, agg_sum, degree):
        """The node update of the receiver rows x_r (n, C) from their sums
        agg_sum (n, C) f32 and their in-degree (n,), clamped at 1."""
        agg = agg_sum / torch.clamp(degree, min=1.0)[:, None]
        return x_r + self.node_fn(torch.cat([agg.to(x_r.dtype), x_r], dim=-1))

    def edge_sums(self, x, e0, graph: CSRGraph, e_scale: float = 1.0,
                  impl: str = "kernel", n_recv: int | None = None):
        """The fused edge kernel's per-receiver sums of the step's edge
        messages on ``graph`` (``forward``'s arguments): (n_recv, C) f32.
        A graph with no edges (a region of a partitioned graph,
        ``parallel.graph_partition.overlap_step``) sums to zero; no kernel
        runs for it."""
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        n = x.shape[0] if n_recv is None else n_recv
        if graph.n_edge == 0:
            return x.new_zeros(n, self.latent, dtype=torch.float32)
        if self.dtype is not None:
            return self._edge_sums_bf16(x, e0, graph, e_scale, impl,
                                        n_recv)[:n]
        w0 = self.edge_fn[0].linears[0].weight                   # (H, 3C)
        c = self.latent
        x_r = x[:n_recv]
        p_xi = _rows(x_r @ w0[:, :c].t(), x.shape[0])            # (N, H)
        p_xj = x @ w0[:, c:2 * c].t()                            # (N, H)
        we, be, *tail = self.edge_weights(e_scale)
        lane = "plain" if impl == "plain" else step_lane(graph, impl,
                                                         w0.shape[0])
        if lane == "plain":
            agg_sum = fused_edge_tail_agg_plain(
                e0, we, be, p_xj, p_xi, graph.senders, graph.rowptr, *tail)
        elif lane == "pe":
            agg_sum = fused_edge_tail_agg_pe(
                e0 @ we + be, p_xj, p_xi, graph.senders, graph.rowptr,
                graph.snd_ptr, graph.snd_perm, *tail)
        elif lane == "fold":
            agg_sum = fused_edge_tail_agg(e0, we, be, p_xj, p_xi,
                                          graph.senders, graph.rowptr, *tail)
        else:
            h0 = gather_rows(p_xj, graph) + (e0 @ we + be)       # (E, H)
            agg_sum = fused_edge_tail_agg_pregathered(h0, p_xi, graph.rowptr,
                                                      *tail)
        return agg_sum[:n]

    def forward(self, x, e0, graph: CSRGraph, e_scale: float = 1.0,
                impl: str = "kernel", n_recv: int | None = None):
        """x (N, C) node latents; e0 (E, C) step-0 edge latents, the step's
        edge input being e_scale·e0.  Returns the updated node latents.
        ``n_recv``: only x's first n_recv rows receive (a shard of a
        partitioned graph, ``parallel.graph_partition``, whose other rows
        are the senders it reads); the step returns those rows updated."""
        sums = self.edge_sums(x, e0, graph, e_scale, impl, n_recv)
        n = sums.shape[0]
        return self.node_update(x[:n], sums, graph.degree[:n])

    def f32_twin(self) -> "InteractionNetwork":
        """This step as an f32 module over the same parameters (not a
        child of this one: no state of its own)."""
        lin = self.edge_fn[0].linears
        with torch.device("meta"):
            twin = InteractionNetwork(self.latent, len(lin) - 1,
                                      lin[0].weight.shape[0])
        for name, p in self.named_parameters():
            owner, _, leaf = name.rpartition(".")
            setattr(twin.get_submodule(owner), leaf, p)
        return twin


class GraphProcessor(nn.Module):
    """A stack of InteractionNetworks; step k gets the edge scale 2^k.  In
    a compute ``dtype`` the node and edge latents are cast to it at the
    entry.

    ``remat`` (the JAX processor's ``fnn.remat`` of each step,
    ``magnet_tpu/nn/graphnet.py:432-440``) keeps no step's activations for
    the backward: each step runs under ``torch.utils.checkpoint`` and is
    run again, on the same lane and the same kernel, when the backward
    reaches it, so each step's forward kernel launches twice a training
    step and its backward kernel once.  The partitioned processor
    (``parallel.graph_partition``) ignores it, as the JAX package's does.
    """

    def __init__(self, latent: int, num_steps: int, mlp_layers: int,
                 mlp_hidden: int, dtype=None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = bool(remat)
        self.gnn_stacks = nn.ModuleList(
            InteractionNetwork(latent, mlp_layers, mlp_hidden, dtype)
            for _ in range(num_steps))
        self._f32 = (), []

    def f32_steps(self) -> list:
        """The steps in f32 over the same parameters: ``gnn_stacks`` itself
        without a compute dtype, else each step's ``f32_twin`` (kept while
        the parameters are the same tensors).  The graph-partitioned
        processor runs these (``parallel.graph_partition``)."""
        if self.dtype is None:
            return list(self.gnn_stacks)
        key = tuple(map(id, self.parameters()))
        if self._f32[0] != key:
            self._f32 = key, [step.f32_twin() for step in self.gnn_stacks]
        return self._f32[1]

    def forward(self, x, e0, graph: CSRGraph, impl: str = "kernel"):
        """Returns the node latents.  The reference's edge output,
        e0·2^num_steps, is read by no caller and is not formed."""
        if self.dtype is not None:
            x, e0 = x.to(self.dtype), e0.to(self.dtype).contiguous()
        remat = self.remat and torch.is_grad_enabled()
        for k, step in enumerate(self.gnn_stacks):
            if remat:
                # the step's scale 2^k is an argument, so the recompute
                # takes the first pass's lane, kernel and edge scale; a step
                # draws no random numbers, so no RNG state is kept for it
                x = checkpoint(step, x, e0, graph, 2.0 ** k, impl,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = step(x, e0, graph, e_scale=2.0 ** k, impl=impl)
        return x


class GraphDecoder(nn.Module):
    """Node MLP head, in compute ``dtype``."""

    def __init__(self, latent: int, node_out: int, mlp_layers: int,
                 mlp_hidden: int, dtype=None):
        super().__init__()
        self.node_fn = MLP(latent, [mlp_hidden] * mlp_layers, node_out, dtype)

    def forward(self, x):
        return self.node_fn(x)
