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
``"overlap"`` is the halo exchange with each shard's edges split into an
interior region (local senders) and a boundary region (halo senders,
``partition_graph_halo_overlap``, ``:304-439, 980-1027``); ``"ring"`` is
the same split with the all-to-all decomposed into G - 1 rotations (the
JAX package's ``MAGNET_TPU_HALO_RING=1``, ``_halo_exchange_ring``) and
builds the same buffers.

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
rank, or all of them on one device).  Under ``overlap`` / ``ring`` a shard
has two CSR region graphs: the interior one, square over its own block,
and the boundary one over its own block and the halo rows; each step
starts the exchange, runs the interior edges' kernel while it is in
flight, finishes it and runs the boundary edges' kernel, then divides the
two regions' sums by the total in-degree (``interaction_step_halo_overlap``).

A GraphNet model's partitioned steps compute in f32 whatever its
``graph_dtype``: the JAX package builds the partitioned processor's
``InteractionNetwork`` with no dtype (``magnet_tpu/models/
partitioned_mixin.py:46-49, 73-76``), so flax promotes the bf16 latents
against the f32 parameters.  ``graphnet_processor`` casts the latents up at
its entry and runs ``GraphProcessor.f32_steps`` (the f32 kernels' lane on
each shard graph).
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

#: the ``graph_halo`` values: all-gather, halo, the JAX package's blocked
#: layout of the halo exchange (run as ``True``), the interior/boundary
#: overlap split, and that split with the exchange as a ring of rotations
HALO_MODES = (False, True, "fused", "overlap", "ring")
#: the modes that build the overlap buffers
OVERLAP_MODES = ("overlap", "ring")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def check_halo(halo):
    """``halo`` if it is one of ``HALO_MODES``, else raise."""
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


@dataclasses.dataclass
class HaloOverlapGraph(HaloGraph):
    """HaloGraph with the edge buffer repacked [interior | boundary].

    e_int:  static split: edges [0, e_int) have local senders
            (senders_remap < ns), edges [e_int, E) reference halo rows.
    t_int:  (G, ns, K_i) int32, ids into the interior region (pad e_int).
    t_bnd:  (G, ns, K_b) int32, ids into the boundary region, 0-based
            within it (pad E - e_int).
    degree: (G, ns, 1) float32, TOTAL in-degree over both regions.
    """

    e_int: int = 0
    t_int: np.ndarray | None = None
    t_bnd: np.ndarray | None = None
    degree: np.ndarray | None = None


def _region_table(recv_loc, ns, e_pad, k_max=None):
    """Receiver table for one shard region: local receiver ids (E,) ->
    (ns, K) ids; padded slots = e_pad."""
    e = len(recv_loc)
    k_req = int(np.bincount(recv_loc, minlength=ns).max()) if e else 0
    if k_max is None:
        k_max = max(k_req, 1)
    assert k_req <= k_max
    tbl = np.full((ns, k_max), e_pad, np.int32)
    if e:
        order = np.argsort(recv_loc, kind="stable")
        rs = recv_loc[order]
        starts = np.zeros(ns + 1, np.int64)
        np.cumsum(np.bincount(rs, minlength=ns), out=starts[1:])
        slot = np.arange(e) - starts[rs]
        tbl[rs, slot] = order
    return tbl, k_req


def partition_graph_halo_overlap(senders: np.ndarray, receivers: np.ndarray,
                                 n_node: int, n_shards: int,
                                 e_int: int | None = None,
                                 e_bnd: int | None = None,
                                 k_int: int | None = None,
                                 k_bnd: int | None = None,
                                 h_pad: int | None = None) -> HaloOverlapGraph:
    """``partition_graph_halo`` with each shard's edges repacked into an
    interior region (local senders) and a boundary region (halo senders),
    each padded to a multiple of 8 edges, at least 8."""
    hg = partition_graph_halo(senders, receivers, n_node, n_shards,
                              h_pad=h_pad)
    g = n_shards
    ns = hg.n_node_pad // g

    sel_int, sel_bnd = [], []
    for d in range(g):
        m = hg.edge_mask[d] > 0
        rem = hg.senders_remap[d]
        sel_int.append(np.nonzero(m & (rem < ns))[0])
        sel_bnd.append(np.nonzero(m & (rem >= ns))[0])
    if e_int is None:
        e_int = max(8, max(len(s) for s in sel_int))
        e_int = ((e_int + 7) // 8) * 8
    if e_bnd is None:
        e_bnd = max(8, max(len(s) for s in sel_bnd))
        e_bnd = ((e_bnd + 7) // 8) * 8
    assert max(len(s) for s in sel_int) <= e_int
    assert max(len(s) for s in sel_bnd) <= e_bnd
    e_tot = e_int + e_bnd

    S = np.zeros((g, e_tot), np.int32)        # global sender (edge feats)
    R = np.zeros((g, e_tot), np.int32)        # local receiver
    M = np.zeros((g, e_tot), np.float32)
    REM = np.zeros((g, e_tot), np.int32)      # remapped sender index
    ti_list, tb_list = [], []
    ki_req = kb_req = 1
    for d in range(g):
        si, sb = sel_int[d], sel_bnd[d]
        ni, nb = len(si), len(sb)
        S[d, :ni] = hg.senders[d, si]
        R[d, :ni] = hg.receivers_loc[d, si]
        M[d, :ni] = 1.0
        REM[d, :ni] = hg.senders_remap[d, si]
        S[d, e_int:e_int + nb] = hg.senders[d, sb]
        R[d, e_int:e_int + nb] = hg.receivers_loc[d, sb]
        M[d, e_int:e_int + nb] = 1.0
        REM[d, e_int:e_int + nb] = hg.senders_remap[d, sb] - ns
        ti, ki = _region_table(hg.receivers_loc[d, si], ns, e_int, None)
        tb, kb = _region_table(hg.receivers_loc[d, sb], ns, e_bnd, None)
        ti_list.append(ti)
        tb_list.append(tb)
        ki_req = max(ki_req, ki)
        kb_req = max(kb_req, kb)
    if k_int is None:
        k_int = ki_req
    if k_bnd is None:
        k_bnd = kb_req
    assert ki_req <= k_int and kb_req <= k_bnd
    TI = np.stack([
        np.pad(t, ((0, 0), (0, k_int - t.shape[1])), constant_values=e_int)
        for t in ti_list])
    TB = np.stack([
        np.pad(t, ((0, 0), (0, k_bnd - t.shape[1])), constant_values=e_bnd)
        for t in tb_list])
    deg = np.zeros((g, ns, 1), np.float32)
    for d in range(g):
        real = M[d] > 0
        deg[d, :, 0] = np.bincount(R[d][real], minlength=ns)

    return HaloOverlapGraph(
        senders=S, receivers_loc=R, edge_mask=M,
        recv_edge_ids=hg.recv_edge_ids, n_node_pad=hg.n_node_pad,
        n_node=hg.n_node, halo_idx=hg.halo_idx, senders_remap=REM,
        e_int=int(e_int), t_int=TI, t_bnd=TB, degree=deg)


def build_partition_buffers(raw, n_node: int, n_shards: int, halo=False):
    """Batch a list of per-sample raw edge lists [(senders, receivers),
    ...] into batch-uniform fixed-shape partition buffers (numpy; the JAX
    package's ``pg`` dict, key for key).  ``halo``: False = all-gather;
    True = halo all-to-all; "fused" = the JAX package's blocked layout of
    the halo exchange, built here as True (the port's shard graphs are CSR
    whatever the layout); "overlap" and "ring" = the interior/boundary
    split (``_build_overlap_buffers``)."""
    halo = check_halo(halo)
    bsz = len(raw)
    if halo in OVERLAP_MODES:
        return _build_overlap_buffers(raw, n_node, n_shards, bsz)
    halo = bool(halo)
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


def _build_overlap_buffers(raw, n_node, n_shards, bsz):
    """Two-pass [interior | boundary] partition: measure per-sample sizes,
    then rebuild batch-uniform."""
    part = partition_graph_halo_overlap
    probe = [part(s, t, n_node, n_shards) for s, t in raw]
    e_int = max(g.e_int for g in probe)
    e_bnd = max(g.senders.shape[1] - g.e_int for g in probe)
    k_int = max(g.t_int.shape[2] for g in probe)
    k_bnd = max(g.t_bnd.shape[2] for g in probe)
    h_pad = max(g.halo_idx.shape[2] for g in probe)
    sgs = [part(s, t, n_node, n_shards, e_int=e_int, e_bnd=e_bnd,
                k_int=k_int, k_bnd=k_bnd, h_pad=h_pad)
           for s, t in raw]
    ns = sgs[0].n_node_pad // n_shards
    shard_off = (np.arange(n_shards, dtype=np.int32) * ns)[None, :, None]
    senders = np.stack([g.senders for g in sgs])      # (B, G, Ei+Eb)
    recv_loc = np.stack([g.receivers_loc for g in sgs])
    remap = np.stack([g.senders_remap for g in sgs])
    mask = np.stack([g.edge_mask for g in sgs])
    recv_glob = recv_loc + shard_off
    c = e_int
    return {
        "remap_int": remap[:, :, :c],
        "recv_int": recv_loc[:, :, :c],
        "mask_int": mask[:, :, :c],
        "t_int": np.stack([g.t_int for g in sgs]),
        "remap_bnd": remap[:, :, c:],
        "recv_bnd": recv_loc[:, :, c:],
        "mask_bnd": mask[:, :, c:],
        "t_bnd": np.stack([g.t_bnd for g in sgs]),
        "degree": np.stack([g.degree for g in sgs]),
        "halo_idx": np.stack([g.halo_idx for g in sgs]),
        # per-region GLOBAL edge endpoints for edge-feature builds
        "senders_flat_int": senders[:, :, :c].reshape(bsz, -1),
        "receivers_flat_int": recv_glob[:, :, :c].reshape(bsz, -1),
        "senders_flat_bnd": senders[:, :, c:].reshape(bsz, -1),
        "receivers_flat_bnd": recv_glob[:, :, c:].reshape(bsz, -1),
        "n_node": n_node,
        "n_node_pad": sgs[0].n_node_pad,
        "n_shards": n_shards,
    }


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
class Region:
    """A region graph of an overlap shard: its CSR graph, and each edge's
    endpoints as rows b * n_node + node of the batch-flattened nodes."""

    graph: CSRGraph
    senders_glob: torch.Tensor
    receivers_glob: torch.Tensor


@dataclasses.dataclass
class ShardGraph:
    """One shard's graph flattened over the batch.

    graph: CSR over the shard's sender table (all-gather: the G blocks of
      B * ns rows, its own first, then the next shards in order; halo: its
      own block, then B * h_pad rows from each source shard; overlap: the
      interior region, square over its own block), square over it; the
      receivers are its first ``n_recv`` = B * ns rows.
    senders_glob, receivers_glob: (E,) int64, each edge's endpoints as rows
      b * n_node + node of the batch-flattened nodes (for edge features).
    send_idx: halo and overlap, for each destination shard the (B * h_pad,)
      rows of the local block it is sent.
    boundary: overlap only, the boundary region: CSR over the halo
      layout's table (own block, then the halo rows), its receivers the
      first B * ns rows.
    """

    shard: int
    graph: CSRGraph
    n_recv: int
    senders_glob: torch.Tensor
    receivers_glob: torch.Tensor
    send_idx: Optional[list] = None
    boundary: Optional[Region] = None

    def edge_endpoints(self) -> tuple:
        """(senders, receivers) of every edge in the order of the edge
        latents the processor takes: the interior edges, then the
        boundary's."""
        if self.boundary is None:
            return self.senders_glob, self.receivers_glob
        return (torch.cat([self.senders_glob, self.boundary.senders_glob]),
                torch.cat([self.receivers_glob,
                           self.boundary.receivers_glob]))


@dataclasses.dataclass
class PartitionedGraph:
    """A batch's graph partitioned over ``axis`` (``parallel.mesh``): the
    shards this process holds, the sizes every shard shares, and the
    exchange of sender rows (``all_gather``, ``halo``, ``overlap`` or
    ``ring``)."""

    shards: list
    axis: object
    n_shards: int
    n_node: int
    ns: int
    batch: int
    exchange: str

    @property
    def halo(self) -> bool:
        return self.exchange != "all_gather"

    def lanes(self) -> list:
        """Each held shard graph's lane; overlap: (interior, boundary)."""
        return [sg.graph.lane if sg.boundary is None
                else (sg.graph.lane, sg.boundary.graph.lane)
                for sg in self.shards]

    def edge_counts(self) -> list:
        """Each held shard graph's edges; overlap: (interior, boundary)."""
        return [sg.graph.n_edge if sg.boundary is None
                else (sg.graph.n_edge, sg.boundary.graph.n_edge)
                for sg in self.shards]


def _region(snd, rcv, sglob, rglob, samples, n_tab: int, n_local: int,
            device, lane_rule) -> Region:
    """A CSR region graph over a table of ``n_tab`` rows from per-sample
    lists of table rows (senders ``snd``, receivers ``rcv``) and global
    endpoints, grouped by receiver, each receiver's edges in the buffers'
    order; its tile layout from ``samples`` over ``n_local`` nodes a sample,
    its lane from ``lane_rule``."""
    order = np.argsort(np.concatenate(rcv), kind="stable")
    snd, rcv, sglob, rglob = (np.concatenate(a)[order]
                              for a in (snd, rcv, sglob, rglob))
    graph = csr_from_edges(torch.from_numpy(snd), torch.from_numpy(rcv),
                           n_tab, layout=tile_layout(samples, n_local))
    if lane_rule is not None:
        graph.lane = lane_of(graph, *lane_rule)
    return Region(graph.to(device), torch.from_numpy(sglob).to(device),
                  torch.from_numpy(rglob).to(device))


def _send_idx(pg: dict, g: int, device) -> list:
    """For each destination shard, the rows of shard g's block (B * ns) it
    is sent: (B * h_pad,) int64 each."""
    bsz = pg["halo_idx"].shape[0]
    ns = pg["n_node_pad"] // pg["n_shards"]
    base = (np.arange(bsz) * ns)[:, None]
    return [torch.from_numpy((base + pg["halo_idx"][:, g, d])
                             .reshape(-1).astype(np.int64)).to(device)
            for d in range(pg["n_shards"])]


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
    reg = _region(snd, rcv, sglob, rglob, samples, n_tab,
                  ns + G * h_pad if halo else G * ns, device, lane_rule)
    return ShardGraph(g, reg.graph, bsz * ns, reg.senders_glob,
                      reg.receivers_glob,
                      _send_idx(pg, g, device) if halo else None)


def _overlap_shard_graph(pg: dict, g: int, device, lane_rule) -> ShardGraph:
    """Shard ``g``'s interior and boundary region graphs from the overlap
    buffers ``pg``: the interior over its own block (B * ns rows), the
    boundary over the halo layout's table (own block, then B * h_pad rows
    from each source shard)."""
    G, n_node = pg["n_shards"], pg["n_node"]
    bsz = pg["remap_int"].shape[0]
    ns = pg["n_node_pad"] // G
    h_pad = pg["halo_idx"].shape[-1]
    regions = []
    for key in ("int", "bnd"):
        snd, rcv, sglob, rglob, samples = [], [], [], [], []
        glob = pg[f"senders_flat_{key}"].reshape(bsz, G, -1)
        for b in range(bsz):
            sel = pg[f"mask_{key}"][b, g] > 0
            rem = pg[f"remap_{key}"][b, g, sel].astype(np.int64)
            r = pg[f"recv_{key}"][b, g, sel].astype(np.int64)
            if key == "int":
                snd.append(b * ns + rem)
                samples.append((rem, r))
            else:
                src, slot = np.divmod(rem, h_pad)
                snd.append(bsz * ns + src * bsz * h_pad + b * h_pad + slot)
                samples.append((ns + rem, r))
            rcv.append(b * ns + r)
            sglob.append(b * n_node + glob[b, g, sel].astype(np.int64))
            rglob.append(b * n_node + g * ns + r)
        n_tab, n_local = ((bsz * ns, ns) if key == "int" else
                          (bsz * ns + G * bsz * h_pad, ns + G * h_pad))
        regions.append(_region(snd, rcv, sglob, rglob, samples, n_tab,
                               n_local, device, lane_rule))
    interior, boundary = regions
    return ShardGraph(g, interior.graph, bsz * ns, interior.senders_glob,
                      interior.receivers_glob, _send_idx(pg, g, device),
                      boundary)


def partitioned_graph(pg: dict, axis, device="cpu", lane_rule=None,
                      ring: bool = False) -> PartitionedGraph:
    """The shards of the buffers ``pg`` that ``axis`` holds, on ``device``;
    ``lane_rule`` (family, hidden) gives each shard graph (each region
    graph) its layer's lane; ``ring``: overlap buffers whose exchange runs
    as the ring of rotations."""
    if axis.size != pg["n_shards"]:
        raise ValueError(f"the buffers hold {pg['n_shards']} shards, the "
                         f"graph axis {axis.size}")
    overlap = "t_int" in pg
    if ring and not overlap:
        raise ValueError("the ring exchange runs on the overlap buffers "
                         "(graph_halo='ring')")
    if overlap:
        exchange = "ring" if ring else "overlap"
        shards = [_overlap_shard_graph(pg, g, device, lane_rule)
                  for g in axis.shards]
    else:
        halo = "halo_idx" in pg
        exchange = "halo" if halo else "all_gather"
        shards = [_shard_graph(pg, g, halo, device, lane_rule)
                  for g in axis.shards]
    return PartitionedGraph(
        shards=shards, axis=axis, n_shards=pg["n_shards"],
        n_node=pg["n_node"], ns=pg["n_node_pad"] // pg["n_shards"],
        batch=pg["halo_idx" if overlap else "senders"].shape[0],
        exchange=exchange)


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


def overlap_step(step, xs: list, efs: list, part: PartitionedGraph,
                 e_scale: float, impl: str) -> list:
    """One ``InteractionNetwork`` step on each held shard under the overlap
    split (``interaction_step_halo_overlap``): the send rows gathered, the
    exchange started, the interior edges' kernel run while it is in flight,
    the exchange finished, then the boundary edges' kernel on the own block
    and the halo rows; the node update from the two regions' sums over the
    total in-degree.  xs the held blocks (B * ns, C), efs each shard's edge
    latents, interior then boundary."""
    sends = [[x.index_select(0, idx) for idx in sg.send_idx]
             for x, sg in zip(xs, part.shards)]
    exchange = part.axis.start_all_to_all(sends,
                                          ring=part.exchange == "ring")
    sums = [step.edge_sums(x, e[:sg.graph.n_edge], sg.graph, e_scale, impl,
                           sg.n_recv)
            for x, e, sg in zip(xs, efs, part.shards)]
    out = []
    for x, e, sg, recv, s_int in zip(xs, efs, part.shards, exchange.wait(),
                                     sums):
        bnd, n = sg.boundary.graph, sg.n_recv
        s_bnd = step.edge_sums(torch.cat([x, *recv]), e[sg.graph.n_edge:],
                               bnd, e_scale, impl, n)
        out.append(step.node_update(x, s_int + s_bnd,
                                    sg.graph.degree[:n] + bnd.degree[:n]))
    return out


def graphnet_processor(processor, nf: torch.Tensor, efs: list,
                       part: PartitionedGraph, impl: str = "kernel"):
    """``nn.graphnet.GraphProcessor`` partitioned: nf (B * n_node, C) every
    node's latents, efs each held shard's (E, C) edge latents in its graph's
    order (overlap: interior, then boundary).  The steps are the processor's
    f32 steps on the latents cast up to f32, as the JAX package's
    partitioned processor computes them (module docstring).  Each step
    brings the sender rows (``sender_tables``) and runs the port's
    ``InteractionNetwork`` on each held shard graph, its receivers the local
    rows, or, overlap and ring, runs ``overlap_step``; the result,
    (B * n_node, C), is gathered.  The processor's ``remat`` is not read:
    the JAX package's partitioned processor
    (``magnet_tpu/models/partitioned_mixin.py``) keeps every step's
    activations too."""
    nf = nf.float()
    efs = [e.float().contiguous() for e in efs]
    xs = node_blocks(nf, part)
    scale = 1.0
    for step in processor.f32_steps():
        if part.exchange in OVERLAP_MODES:
            xs = overlap_step(step, xs, efs, part, scale, impl)
        else:
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
