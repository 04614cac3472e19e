"""Edge-partitioned graph parallelism over the mesh's ``graph`` axis
(counterpart of ``magnet_tpu/parallel/graph_partition.py``).

Nodes are block-partitioned over G shards, each sample padded to G * ns
nodes; every edge lives on the shard of its receiver, so the sums are
local, and each message-passing step first brings the sender rows a shard
reads from the others:

* all-gather (``halo=False``): every shard's node block, the whole table;
* halo (``halo=True``): an all-to-all of only the rows each shard's edges
  read from another (``HaloGraph.halo_idx``).

Host side (numpy, a copy of the JAX package's ``:38-108, 209-284,
922-978``): ``partition_graph``, ``partition_graph_halo`` and
``build_partition_buffers``, whose buffers equal the JAX package's bit for
bit.  ``graph_halo="fused"`` is the JAX package's blocked TPU layout of the
same halo exchange (``build_partition_buffers_fused``); the port's shard
graph is CSR in every case, so "fused" builds and runs the halo buffers.
``"overlap"`` (the interior/boundary split) and the ppermute ring of the
JAX package are not ported (ROADMAP A.6) and raise.

Device side: each shard's buffers become a ``ShardGraph``, a CSR graph
flattened over the batch whose receivers are the shard's B * ns local
rows, the first rows of its sender table: the gathered blocks, rotated so
that its own block comes first (all-gather), or its own block then the
halo rows received from each source shard (halo).  The graph is square
over that table, so the port's fused edge kernels run on it unchanged, in
the lane ``ops.graph.lane_of`` gives it as for any graph
(``nn.graphnet.InteractionNetwork.forward`` with ``n_recv``, and the MPNN
layer's ``messages``).  ``graphnet_processor`` and ``mpnn_processor`` run
the step loop over the shards a process holds (``parallel.mesh``: one a
rank, or all of them on one device).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from magnet_tpu_torch.ops.graph import (
    CSRGraph,
    _radius_edges,
    csr_from_edges,
    lane_of,
    tile_layout,
)

#: the ``graph_halo`` values with a port: all-gather, halo, and the JAX
#: package's blocked layout of the halo exchange (run as ``True``)
HALO_MODES = (False, True, "fused")
NOT_PORTED = ("overlap", "ring")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def check_halo(halo):
    """``halo`` if it is a ported mode, else raise."""
    if halo in NOT_PORTED:
        raise NotImplementedError(
            f"graph_halo={halo!r} (the interior/boundary overlap split and "
            "its ppermute ring) is not ported: ROADMAP A.6")
    if halo not in HALO_MODES:
        raise ValueError(f"graph_halo must be one of {HALO_MODES}, got "
                         f"{halo!r}")
    return halo


# ---- host side: a copy of the JAX package's partition buffers -----------


@dataclasses.dataclass
class ShardedGraph:
    """Per-shard fixed-shape graph buffers, stacked over shards (axis 0).

    senders:        (G, E_s) int32, GLOBAL node index of each edge source.
    receivers_loc:  (G, E_s) int32, LOCAL (within-shard) receiver index.
    edge_mask:      (G, E_s) float32.
    recv_edge_ids:  (G, N_s, K) int32, local edge ids per local node.
    n_node_pad:     padded global node count (G * N_s).
    n_node:         true node count.
    """

    senders: np.ndarray
    receivers_loc: np.ndarray
    edge_mask: np.ndarray
    recv_edge_ids: np.ndarray
    n_node_pad: int
    n_node: int


def partition_graph(senders: np.ndarray, receivers: np.ndarray, n_node: int,
                    n_shards: int, e_shard: int | None = None,
                    k_max: int | None = None) -> ShardedGraph:
    """Partition an edge list by receiver block.  Nodes are padded to a
    multiple of n_shards; contiguous blocks per shard."""
    n_pad = round_up(n_node, n_shards)
    ns = n_pad // n_shards
    shard_of = receivers // ns

    per_s, per_r = [], []
    for g in range(n_shards):
        sel = np.nonzero(shard_of == g)[0]
        per_s.append(senders[sel])
        per_r.append(receivers[sel] - g * ns)
    if e_shard is None:
        e_shard = max(1, max(len(s) for s in per_s))
    if k_max is None:
        k_req = 1
        for g in range(n_shards):
            if len(per_r[g]):
                k_req = max(k_req, int(np.bincount(per_r[g]).max()))
        k_max = k_req

    S = np.zeros((n_shards, e_shard), np.int32)
    R = np.zeros((n_shards, e_shard), np.int32)
    M = np.zeros((n_shards, e_shard), np.float32)
    T = np.full((n_shards, ns, k_max), e_shard, np.int32)
    for g in range(n_shards):
        e = len(per_s[g])
        assert e <= e_shard
        S[g, :e] = per_s[g]
        R[g, :e] = per_r[g]
        M[g, :e] = 1.0
        if e:
            order = np.argsort(per_r[g], kind="stable")
            rs = per_r[g][order]
            starts = np.zeros(ns + 1, np.int64)
            np.cumsum(np.bincount(rs, minlength=ns), out=starts[1:])
            slot = np.arange(e) - starts[rs]
            T[g, rs, slot] = order
    return ShardedGraph(S, R, M, T, n_pad, n_node)


@dataclasses.dataclass
class HaloGraph(ShardedGraph):
    """ShardedGraph + halo exchange plan.

    halo_idx:      (G_src, G_dst, H_pad) int32, LOCAL row indices within
                   shard g_src to send to g_dst (pad -> 0).
    senders_remap: (G, E_s) int32, sender position in the extended local
                   space [0, ns) local ∪ [ns + src*H_pad + slot) halo.
    """

    halo_idx: np.ndarray | None = None
    senders_remap: np.ndarray | None = None


def partition_graph_halo(senders: np.ndarray, receivers: np.ndarray,
                         n_node: int, n_shards: int,
                         e_shard: int | None = None, k_max: int | None = None,
                         h_pad: int | None = None) -> HaloGraph:
    base = partition_graph(senders, receivers, n_node, n_shards, e_shard,
                           k_max)
    g = n_shards
    ns = base.n_node_pad // g

    # per (src, dst) unique sender nodes living in src needed by dst's edges
    need: list[list[np.ndarray]] = [[None] * g for _ in range(g)]
    h_req = 1
    for dst in range(g):
        s_dst = base.senders[dst][base.edge_mask[dst] > 0]
        for src in range(g):
            if src == dst:
                need[src][dst] = np.zeros(0, np.int64)
                continue
            uniq = np.unique(s_dst[(s_dst // ns) == src])
            need[src][dst] = uniq
            h_req = max(h_req, len(uniq))
    h_req = ((h_req + 7) // 8) * 8
    if h_pad is None:
        h_pad = h_req
    assert h_req <= h_pad, f"h_pad={h_pad} < required {h_req}"

    halo_idx = np.zeros((g, g, h_pad), np.int32)
    # per dst: global node id -> extended-space index
    ext_map = np.zeros((g, base.n_node_pad), np.int64)
    for src in range(g):
        for dst in range(g):
            uniq = need[src][dst]
            halo_idx[src, dst, : len(uniq)] = uniq - src * ns
            ext_map[dst, uniq] = ns + src * h_pad + np.arange(len(uniq))

    e_s = base.senders.shape[1]
    remap = np.zeros((g, e_s), np.int32)
    for dst in range(g):
        sg = base.senders[dst].astype(np.int64)
        local = (sg // ns) == dst
        vals = np.where(local, sg - dst * ns, ext_map[dst, sg])
        remap[dst] = np.where(base.edge_mask[dst] > 0, vals, 0).astype(np.int32)

    return HaloGraph(
        senders=base.senders, receivers_loc=base.receivers_loc,
        edge_mask=base.edge_mask, recv_edge_ids=base.recv_edge_ids,
        n_node_pad=base.n_node_pad, n_node=base.n_node,
        halo_idx=halo_idx, senders_remap=remap)


def build_partition_buffers(raw, n_node: int, n_shards: int, halo=False):
    """Batch a list of per-sample raw edge lists [(senders, receivers),
    ...] into batch-uniform fixed-shape partition buffers (numpy; the JAX
    package's ``pg`` dict, key for key).  ``halo``: False = all-gather;
    True = halo all-to-all; "fused" = the JAX package's blocked layout of
    the halo exchange, built here as True (the port's shard graphs are CSR
    whatever the layout)."""
    halo = bool(check_halo(halo))
    bsz = len(raw)
    e_shard = k_max = 1
    for s, t in raw:
        sg = partition_graph(s, t, n_node, n_shards)
        e_shard = max(e_shard, sg.senders.shape[1])
        k_max = max(k_max, sg.recv_edge_ids.shape[2])
    e_shard = ((e_shard + 127) // 128) * 128
    part = partition_graph_halo if halo else partition_graph
    sgs = [part(s, t, n_node, n_shards, e_shard=e_shard, k_max=k_max)
           for s, t in raw]
    ns = sgs[0].n_node_pad // n_shards
    shard_off = (np.arange(n_shards, dtype=np.int32) * ns)[None, :, None]
    senders = np.stack([g.senders for g in sgs])
    recv_loc = np.stack([g.receivers_loc for g in sgs])
    out = {
        "senders": senders,
        "recv_loc": recv_loc,
        "mask": np.stack([g.edge_mask for g in sgs]),
        "table": np.stack([g.recv_edge_ids for g in sgs]),
        "senders_flat": senders.reshape(bsz, -1),
        "receivers_flat": (recv_loc + shard_off).reshape(bsz, -1),
        "n_node": n_node,
        "n_node_pad": sgs[0].n_node_pad,
        "n_shards": n_shards,
    }
    if halo:
        h_pad = max(g.halo_idx.shape[2] for g in sgs)
        halo_idx = np.zeros((bsz, n_shards, n_shards, h_pad), np.int32)
        for b, g in enumerate(sgs):
            halo_idx[b, :, :, : g.halo_idx.shape[2]] = g.halo_idx
        remap = np.stack([g.senders_remap for g in sgs])
        for b, g in enumerate(sgs):
            own = g.halo_idx.shape[2]
            if own != h_pad:
                halo_slots = remap[b] >= ns
                src = (remap[b] - ns) // own
                pos = (remap[b] - ns) % own
                remap[b] = np.where(halo_slots, ns + src * h_pad + pos,
                                    remap[b])
        out["halo_idx"] = halo_idx
        out["senders_remap"] = remap
    return out


def radius_edges(pos: np.ndarray, r: float, loop: bool):
    """Per-sample radius graphs of pos (B, N, D): [(senders, receivers),
    ...] int32, receiver-sorted, senders ascending (``radius_graph``'s)."""
    b, recv, send = _radius_edges(torch.from_numpy(np.ascontiguousarray(pos)),
                                  r, loop, 32)
    cuts = torch.searchsorted(b, torch.arange(1, pos.shape[0])).tolist()
    return [(s.numpy().astype(np.int32), t.numpy().astype(np.int32))
            for s, t in zip(torch.tensor_split(send, cuts),
                            torch.tensor_split(recv, cuts))]


# ---- device side: the shard graphs ---------------------------------------


@dataclasses.dataclass
class ShardGraph:
    """One shard's graph flattened over the batch.

    graph: CSR over the shard's sender table (all-gather: the G blocks of
      B * ns rows, its own first, then the next shards in order; halo: its
      own block, then B * h_pad rows from each source shard), square over
      it; the receivers are its first ``n_recv`` = B * ns rows.
    senders_glob, receivers_glob: (E,) int64, each edge's endpoints as rows
      b * n_node + node of the batch-flattened nodes (for edge features).
    send_idx: halo only, for each destination shard the (B * h_pad,) rows
      of the local block it is sent.
    """

    shard: int
    graph: CSRGraph
    n_recv: int
    senders_glob: torch.Tensor
    receivers_glob: torch.Tensor
    send_idx: Optional[list] = None


@dataclasses.dataclass
class PartitionedGraph:
    """A batch's graph partitioned over ``axis`` (``parallel.mesh``): the
    shards this process holds, and the sizes every shard shares."""

    shards: list
    axis: object
    n_shards: int
    n_node: int
    ns: int
    batch: int
    halo: bool

    def lanes(self) -> list:
        return [sg.graph.lane for sg in self.shards]

    def edge_counts(self) -> list:
        return [sg.graph.n_edge for sg in self.shards]


def _shard_graph(pg: dict, g: int, halo: bool, device,
                 lane_rule) -> ShardGraph:
    """Shard ``g``'s ``ShardGraph`` from the partition buffers ``pg``."""
    G, n_node = pg["n_shards"], pg["n_node"]
    bsz = pg["senders"].shape[0]
    ns = pg["n_node_pad"] // G
    h_pad = pg["halo_idx"].shape[-1] if halo else 0
    snd, rcv, sglob, rglob, samples = [], [], [], [], []
    for b in range(bsz):
        sel = pg["mask"][b, g] > 0
        s = pg["senders"][b, g, sel].astype(np.int64)
        r = pg["recv_loc"][b, g, sel].astype(np.int64)
        if halo:
            ext = pg["senders_remap"][b, g, sel].astype(np.int64)
            src, slot = np.divmod(ext - ns, h_pad)
            tab = np.where(ext < ns, b * ns + ext,
                           bsz * ns + src * bsz * h_pad + b * h_pad + slot)
            samples.append((ext, r))
        else:
            rot = (s // ns - g) % G
            tab = rot * bsz * ns + b * ns + s % ns
            samples.append((rot * ns + s % ns, r))
        snd.append(tab)
        rcv.append(b * ns + r)
        sglob.append(b * n_node + s)
        rglob.append(b * n_node + g * ns + r)
    n_tab = bsz * ns + (G * bsz * h_pad if halo else (G - 1) * bsz * ns)
    # CSR: grouped by receiver, each receiver's edges in the buffers' order
    order = np.argsort(np.concatenate(rcv), kind="stable")
    snd, rcv, sglob, rglob = (np.concatenate(a)[order]
                              for a in (snd, rcv, sglob, rglob))
    graph = csr_from_edges(
        torch.from_numpy(snd), torch.from_numpy(rcv), n_tab,
        layout=tile_layout(samples, ns + G * h_pad if halo else G * ns))
    if lane_rule is not None:
        graph.lane = lane_of(graph, *lane_rule)
    send_idx = None
    if halo:
        base = (np.arange(bsz) * ns)[:, None]
        send_idx = [torch.from_numpy((base + pg["halo_idx"][:, g, d])
                                     .reshape(-1).astype(np.int64)).to(device)
                    for d in range(G)]
    return ShardGraph(g, graph.to(device), bsz * ns,
                      torch.from_numpy(sglob).to(device),
                      torch.from_numpy(rglob).to(device), send_idx)


def partitioned_graph(pg: dict, axis, device="cpu",
                      lane_rule=None) -> PartitionedGraph:
    """The shards of the buffers ``pg`` that ``axis`` holds, on ``device``;
    ``lane_rule`` (family, hidden) gives each shard graph its layer's
    lane."""
    if axis.size != pg["n_shards"]:
        raise ValueError(f"the buffers hold {pg['n_shards']} shards, the "
                         f"graph axis {axis.size}")
    halo = "halo_idx" in pg
    return PartitionedGraph(
        shards=[_shard_graph(pg, g, halo, device, lane_rule)
                for g in axis.shards],
        axis=axis, n_shards=pg["n_shards"], n_node=pg["n_node"],
        ns=pg["n_node_pad"] // pg["n_shards"], batch=pg["senders"].shape[0],
        halo=halo)


# ---- device side: the processors ----------------------------------------


def node_blocks(x: torch.Tensor, part: PartitionedGraph) -> list:
    """(B * n_node, C) node rows -> each held shard's (B * ns, C) block,
    the samples padded with zero rows to G * ns nodes."""
    B, n, ns = part.batch, part.n_node, part.ns
    xp = F.pad(x.reshape(B, n, -1), (0, 0, 0, part.n_shards * ns - n))
    return [xp[:, g * ns:(g + 1) * ns].reshape(B * ns, -1)
            for g in part.axis.shards]


def gather_nodes(xs: list, part: PartitionedGraph) -> torch.Tensor:
    """The held blocks (B * ns, C) -> every node's row, (B * n_node, C):
    the processor's output all-gathered."""
    B, ns = part.batch, part.ns
    blocks = part.axis.all_gather(xs)
    full = torch.stack([b.reshape(B, ns, -1) for b in blocks], dim=1)
    return full.reshape(B, part.n_shards * ns, -1)[:, :part.n_node].reshape(
        B * part.n_node, -1)


def sender_tables(xs: list, part: PartitionedGraph) -> list:
    """Each held shard's sender table from the held blocks ``xs``: the
    all-gathered blocks rotated to its own first, or its own block and the
    halo rows the all-to-all brings."""
    if part.halo:
        sends = [[x.index_select(0, idx) for idx in sg.send_idx]
                 for x, sg in zip(xs, part.shards)]
        recvs = part.axis.all_to_all(sends)
        return [torch.cat([x, *recv]) for x, recv in zip(xs, recvs)]
    blocks = part.axis.all_gather(xs)
    return [torch.cat(blocks[g:] + blocks[:g])
            for g in (sg.shard for sg in part.shards)]


def graphnet_processor(processor, nf: torch.Tensor, efs: list,
                       part: PartitionedGraph, impl: str = "kernel"):
    """``nn.graphnet.GraphProcessor`` partitioned: nf (B * n_node, C) every
    node's latents, efs each held shard's (E, C) edge latents in its graph's
    order.  Each step brings the sender rows (``sender_tables``) and runs
    the port's ``InteractionNetwork`` on each held shard graph, its
    receivers the local rows; the result, (B * n_node, C), is gathered."""
    if processor.dtype is not None:
        nf = nf.to(processor.dtype)
        efs = [e.to(processor.dtype).contiguous() for e in efs]
    xs = node_blocks(nf, part)
    scale = 1.0
    for step in processor.gnn_stacks:
        tables = sender_tables(xs, part)
        xs = [step(t, e, sg.graph, e_scale=scale, impl=impl,
                   n_recv=sg.n_recv)
              for t, e, sg in zip(tables, efs, part.shards)]
        scale *= 2.0
    return gather_nodes(xs, part)


def mpnn_processor(layers, h, u, pos, variables, part: PartitionedGraph,
                   impl: str = "kernel", eps: float = 1e-5):
    """The MPNN layer stack partitioned (all-gather layout, as the JAX
    package's ``make_partitioned_mpnn_processor``): per layer the node
    projections on the local rows, the sender side all-gathered and read by
    the shard graph's message kernel, the update on the local rows, then
    the InstanceNorm with each sample's statistics summed over the graph
    axis (biased variance E[x^2] - mean^2 over the n_node real rows, eps
    1e-5; padded rows zeroed).  h, u, pos, variables (B * n_node, ·)."""
    B, ns, G = part.batch, part.ns, part.n_shards
    xs, us, ps, vs = (node_blocks(a, part) for a in (h, u, pos, variables))
    masks = [((g * ns + torch.arange(ns, device=h.device)) < part.n_node)
             .to(h.dtype).repeat(B)[:, None] for g in part.axis.shards]
    for layer in layers:
        sides = [layer.project(x, uu, p, v)
                 for x, uu, p, v in zip(xs, us, ps, vs)]
        tables = sender_tables([send for _, send in sides], part)
        outs = []
        for (recv, _), tab, sg, x, v in zip(sides, tables, part.shards, xs,
                                           vs):
            pr = F.pad(recv, (0, 0, 0, tab.shape[0] - sg.n_recv))
            sums = layer.messages(tab, pr, sg.graph, impl)[:sg.n_recv]
            deg = torch.clamp(sg.graph.degree[:sg.n_recv], min=1.0)
            outs.append(layer.update(x, sums / deg[:, None], v))
        stats = [torch.cat([(o * m).reshape(B, ns, -1).sum(1),
                            (o * o * m).reshape(B, ns, -1).sum(1)], dim=-1)
                 for o, m in zip(outs, masks)]
        totals = part.axis.all_reduce(stats)
        xs = []
        for o, m, tot in zip(outs, masks, totals):
            s, ss = tot.chunk(2, dim=-1)
            mean = s / part.n_node
            var = ss / part.n_node - mean * mean
            o = o.reshape(B, ns, -1)
            xs.append(((o - mean[:, None]) / torch.sqrt(var[:, None] + eps))
                      .reshape(B * ns, -1) * m)
    return gather_nodes(xs, part)
