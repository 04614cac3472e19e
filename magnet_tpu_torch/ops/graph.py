"""Host graph building: radius graphs, k nearest neighbours and the
batched CSR layout.

``radius_graph`` has the semantics of ``magnet_tpu/ops/graph.py:43-79``
(torch_cluster's): float64 positions, inclusive ``<= r``, optional self
loops, and at most ``max_num_neighbors`` senders per receiver, the
lowest-indexed ones.  Edges come out receiver-grouped with senders
ascending, which is already CSR order.

``radius_graph_batch`` flattens a batch of B graphs into one graph by node
offsets, so one kernel launch covers the whole batch with no padding or
edge mask.  It takes the place of the TPU's tile packing
(``block_graph``, ``_chunk_list``), which exists only for the TPU's tiling.
``GraphCache`` keeps the finished graphs of identical coordinate batches
(``magnet_tpu/models/common.py:152-160``): a regular grid asks for the
same graph at every step.

Every graph also carries its sender CSR (``snd_ptr``, ``snd_perm``: the
edges stably sorted by sender), which the backward of a sender gather
reduces over, and, when built from coordinates, its ``TileLayout``: what
the JAX package's host builder (``build_radius_graph_batch``,
``block_graph``, ``_snd2_layout``) would find for the same batch.  The
kernel lane a layer takes is decided from that layout with a copy of the
JAX package's gates (``lane_of``), so the port runs the kernel the JAX
package runs on the same graph.  The lane decides which kernel runs, never
what is computed.

A captured training step (``train.trainer``) fixes its graph's shapes.
``pad_edges`` extends a graph's edge rows to a bucket (``EdgeBuckets``,
sticky, as the JAX package's edge buckets are) past the end of its CSR,
and ``graph_signature`` says which graphs can share one capture.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch


@dataclass(frozen=True)
class TileLayout:
    """The JAX package's tile layout of a batch, reduced to what its kernel
    gates read: ``n_pad``, a sample's node count rounded up to the 128-row
    tile; ``snd2``, whether the sender-tile layout of the in-kernel sender
    gather exists (every edge chunk of every sample draws its senders from
    at most ``SND2_K_CAP`` node tiles); ``snd_transpose``, whether the
    sender-transpose layout is built (the out-degree skew rule)."""

    n_pad: int
    snd2: bool
    snd_transpose: bool


@dataclass
class CSRGraph:
    """One (possibly batch-flattened) receiver-grouped graph.

    senders, receivers: (E,) int32, edge j -> i is senders[e] -> receivers[e];
    rowptr: (N+1,) int32, the edges of receiver i are rowptr[i]:rowptr[i+1];
    degree: (N,) float32 in-degree;
    snd_ptr (N+1,), snd_perm (E,) int32: the sender CSR, the edges of
    sender j being snd_perm[snd_ptr[j]:snd_ptr[j+1]] in ascending order;
    layout: the JAX package's tile layout of the batch (None for a graph
    not built from coordinates); lane: the kernel lane of the model that
    built it (``fold``, ``pregathered`` or ``gather``), or None.

    ``n_edge`` is the edge rows; a graph padded by ``pad_edges`` has dead
    rows past rowptr[-1], its live edges, which the fold, pe and
    pre-gathered kernels in f32 at either width and in bf16 at width 64,
    their plain versions and the segment sum over the sender CSR take (the
    trainer pads a chunk's graphs where its steps run those kernels alone:
    ``train.trainer.takes_padding``).
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    rowptr: torch.Tensor
    degree: torch.Tensor
    snd_ptr: torch.Tensor
    snd_perm: torch.Tensor
    layout: Optional[TileLayout] = None
    lane: Optional[str] = None

    @property
    def n_node(self) -> int:
        return self.rowptr.numel() - 1

    @property
    def n_edge(self) -> int:
        return self.senders.numel()

    def to(self, device) -> "CSRGraph":
        return CSRGraph(*(t.to(device) for t in
                          (self.senders, self.receivers, self.rowptr,
                           self.degree, self.snd_ptr, self.snd_perm)),
                        layout=self.layout, lane=self.lane)


# ---- a copy of the JAX package's layout tests and kernel gates ----------
# (magnet_tpu/ops/graph.py:187-202, 256-313; magnet_tpu/models/common.py:
# 171-194, 225-238; magnet_tpu/ops/pallas_kernels.py:33-40, 64-76;
# magnet_tpu/nn/graphnet.py:200-258, 295-302; magnet_tpu/nn/gnn_layer.py:
# 111-116), without the TPU-only environment knobs.
TILE_N = 128
SND2_K_CAP = 8
_MAX_E_CHUNK = 2048
_MIB = 2 ** 20
_DPXJ_TABLE_BYTES = 6 * _MIB
_DPXJ_H0_BYTES = 9 * _MIB


def _e_chunk(e: int) -> int:
    """Largest multiple of 128 dividing ``e`` (itself a multiple of 128)
    that is at most 2048: the JAX package's ``_e_chunk`` and, with the same
    cap, its ``_chunk2_of``."""
    if e <= _MAX_E_CHUNK:
        return e
    k = e // 128
    for m in range(_MAX_E_CHUNK // 128, 0, -1):
        if k % m == 0:
            return 128 * m
    return 128


def _chunkable_e_tile(e_tile: int) -> int:
    if e_tile <= _MAX_E_CHUNK:
        return e_tile
    while _e_chunk(e_tile) < 512:
        e_tile += 128
    return e_tile


def _bucket(counts: np.ndarray) -> int:
    return max(128, ((int(counts.max()) + 127) // 128) * 128)


def _snd2_k(send: np.ndarray, recv: np.ndarray, n_tiles: int,
            e_tile: int) -> int:
    """The largest number of distinct sender tiles of one edge chunk, edges
    packed by receiver tile, then sender (``_snd2_layout``'s K)."""
    if not len(send):
        return 0
    chunk2 = _e_chunk(e_tile)
    r_tile = recv // TILE_N
    order = np.lexsort((send, r_tile))
    tile = r_tile[order]
    starts = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(np.bincount(tile, minlength=n_tiles), out=starts[1:])
    chunk = (np.arange(len(order)) - starts[tile]) // chunk2
    cell = tile * (e_tile // chunk2) + chunk
    pairs = np.unique(cell * n_tiles + send[order] // TILE_N)
    return int(np.bincount(pairs // n_tiles).max())


def tile_layout(samples, n_node: int) -> TileLayout:
    """The JAX package's tile layout of a batch of per-sample edge lists
    ``samples`` [(send, recv), ...] (numpy, local node ids in
    [0, n_node)): receiver- and sender-tile buckets as batch maxima rounded
    to 128, the skew rule for the sender-transpose layout, and the K of the
    sender-tile layout.  Decided per batch (the JAX package keeps its
    buckets sticky across batches, which changes no result)."""
    n_tiles = -(-n_node // TILE_N)
    e_tile = e_tile_s = 128
    for send, recv in samples:
        if len(recv):
            e_tile = max(e_tile, _bucket(np.bincount(recv // TILE_N,
                                                     minlength=n_tiles)))
            e_tile_s = max(e_tile_s, _bucket(np.bincount(send // TILE_N,
                                                         minlength=n_tiles)))
    e_tile = _chunkable_e_tile(e_tile)
    e_tile_s = _chunkable_e_tile(e_tile_s)
    snd2 = bool(samples)
    prev = None
    for send, recv in samples:
        if prev is None or not (np.array_equal(send, prev[0])
                                and np.array_equal(recv, prev[1])):
            k = _snd2_k(send, recv, n_tiles, e_tile)
            prev = (send, recv)
        snd2 = snd2 and 0 < k <= SND2_K_CAP
    return TileLayout(n_pad=n_tiles * TILE_N, snd2=snd2,
                      snd_transpose=e_tile_s <= max(4 * e_tile, 4096))


def graphnet_lane(layout: TileLayout, hidden: int) -> str:
    """``pregathered`` where the JAX GraphNet's ``_fused2_mode`` is None (it
    then gathers p_xj with XLA and runs ``fused_edge_tail_agg``), else
    ``fold`` (every in-kernel-gather lane of the JAX package, f32).  With
    the sender-tile layout the mode is 'vmem' or 'hbm' (its chunk list
    exists); without the sender-transpose layout it is 'vmem' under the
    5/6/8 MiB table gates, which imply the 'hbm' gate, so that gate alone
    decides."""
    if not layout.snd2:
        return "pregathered"
    if layout.snd_transpose or layout.n_pad * hidden * 4 <= _DPXJ_H0_BYTES:
        return "fold"
    return "pregathered"


def graphnet_pe_lane(layout: TileLayout, hidden: int) -> str:
    """The lane of ``impl="kernel_pe"``, the JAX GraphNet's under
    ``MAGNET_TPU_NO_FUSED2R``: ``pe`` where its ``_fused2_mode`` is not
    None, else ``pregathered``.  Under that flag the mode is None without
    the sender-tile layout and without the sender-transpose layout, and
    'vmem' or 'hbm' (its chunk list exists) where both exist, whatever the
    width."""
    return "pe" if layout.snd2 and layout.snd_transpose else "pregathered"


def mpnn_lane(layout: TileLayout, hidden: int) -> str:
    """``gather`` where the JAX MPNN layer's ``use_v2r`` holds (the
    sender-tile layout exists and the f32 sender table fits its budget),
    else ``pregathered``."""
    if layout.snd2 and layout.n_pad * hidden * 4 <= _DPXJ_TABLE_BYTES:
        return "gather"
    return "pregathered"


LANE_RULES = {"graphnet": graphnet_lane, "graphnet_pe": graphnet_pe_lane,
              "mpnn": mpnn_lane}


def lane_of(graph: "CSRGraph", family: str, hidden: int) -> str:
    """The lane of a ``family`` (``graphnet``, ``graphnet_pe`` for
    ``impl="kernel_pe"``, or ``mpnn``) layer of width ``hidden`` on
    ``graph``: the one cached with the graph, else decided from its layout.
    The cached lane is ``impl="kernel"``'s, so ``graphnet_pe`` is always
    decided from the layout, and raises on a graph without one."""
    if graph.lane is not None and family != "graphnet_pe":
        return graph.lane
    if graph.layout is None:
        raise ValueError("the graph has no tile layout to decide a lane from "
                         "(build it with radius_graph_batch, or force a lane)")
    return LANE_RULES[family](graph.layout, hidden)


#: pair distances formed at a time by ``_radius_edges`` (float64 entries)
_BLOCK_PAIRS = 1 << 22


def _sample_edges(pos: torch.Tensor, r2: float, loop: bool,
                  max_num_neighbors: int):
    """One sample, pos (N, D) float64 -> (receiver, sender) int64, sorted by
    receiver then sender.  Receivers are taken in row blocks, each against
    all N senders, so the memory is O(block·N), not O(N²)."""
    n = pos.shape[0]
    rows = max(1, _BLOCK_PAIRS // max(n, 1))
    recv, send = [], []
    for lo in range(0, n, rows):
        blk = pos[lo:lo + rows]
        adj = ((blk[:, None, :] - pos[None, :, :]) ** 2).sum(-1) <= r2
        if not loop:
            k = torch.arange(blk.shape[0])
            adj[k, lo + k] = False
        # keep the lowest-indexed max_num_neighbors senders of each receiver
        adj &= torch.cumsum(adj, dim=-1) <= max_num_neighbors
        i, j = adj.nonzero(as_tuple=True)
        recv.append(i + lo)
        send.append(j)
    return torch.cat(recv), torch.cat(send)


def _radius_edges(pos: torch.Tensor, r: float, loop: bool,
                  max_num_neighbors: int):
    """pos (B, N, D) -> (b, receiver, sender) int64 index triples, sorted by
    sample, then receiver, then sender.  A sample whose coordinates equal
    its predecessor's (a regular grid) reuses that sample's edges."""
    pos = pos.to(torch.float64).cpu()
    r2 = float(r) ** 2
    bs, recv, send = [], [], []
    for b in range(pos.shape[0]):
        if b == 0 or not torch.equal(pos[b], pos[b - 1]):
            i, j = _sample_edges(pos[b], r2, loop, max_num_neighbors)
        bs.append(torch.full_like(i, b))
        recv.append(i)
        send.append(j)
    if not bs:
        empty = torch.zeros(0, dtype=torch.int64)
        return empty, empty, empty
    return torch.cat(bs), torch.cat(recv), torch.cat(send)


def radius_graph(pos, r: float, loop: bool = False,
                 max_num_neighbors: int = 32):
    """Single-sample radius graph: pos (N, D) -> (senders, receivers), int32."""
    pos = torch.as_tensor(pos)
    _, recv, send = _radius_edges(pos[None], r, loop, max_num_neighbors)
    return send.to(torch.int32), recv.to(torch.int32)


def knn(x, y, k: int) -> torch.Tensor:
    """For each query row of ``y`` (M, D), the indices of the ``k`` nearest
    rows of ``x`` (N, D) in ascending distance: (M, k) int32, the port's
    copy of ``magnet_tpu/ops/graph.py:knn_np``.  Squared distances are
    taken in float64 and ties go to the lower index, as the JAX package's
    native neighbour search breaks them (its numpy fallback, an
    ``argpartition``, may order a tie otherwise)."""
    x = torch.as_tensor(x).to(torch.float64).cpu()
    y = torch.as_tensor(y).to(torch.float64).cpu()
    d2 = ((y[:, None, :] - x[None, :, :]) ** 2).sum(-1)           # (M, N)
    order = torch.sort(d2, dim=1, stable=True).indices
    return order[:, :min(int(k), x.shape[0])].to(torch.int32)


def csr_from_edges(senders, receivers, n_node: int,
                   layout: Optional[TileLayout] = None) -> CSRGraph:
    """Pack receiver-grouped edges (receivers non-decreasing) as CSR, with
    the sender CSR beside it.

    The fused edge kernels trust the CSR they are given, so the checks are
    made here, once per graph: every index lies in [0, n_node), hence
    rowptr starts at 0, never decreases and ends at the edge count.
    """
    senders, receivers = torch.as_tensor(senders), torch.as_tensor(receivers)
    if senders.shape != receivers.shape or senders.dim() != 1:
        raise ValueError(f"senders {tuple(senders.shape)} and receivers "
                         f"{tuple(receivers.shape)} must be equal 1-D shapes")
    if receivers.numel():
        if bool((receivers[1:] < receivers[:-1]).any()):
            raise ValueError("edges must be grouped by receiver")
        lo = min(int(senders.min()), int(receivers[0]))
        hi = max(int(senders.max()), int(receivers[-1]))
        if lo < 0 or hi >= n_node:
            raise ValueError(f"node index {lo if lo < 0 else hi} is outside "
                             f"[0, {n_node})")

    def ptr(index):
        counts = torch.bincount(index.long(), minlength=n_node)
        out = torch.zeros(n_node + 1, dtype=torch.int64)
        torch.cumsum(counts, 0, out=out[1:])
        return counts, out.to(torch.int32)

    counts, rowptr = ptr(receivers)
    _, snd_ptr = ptr(senders)
    snd_perm = torch.sort(senders.long(), stable=True).indices
    return CSRGraph(
        senders=senders.to(torch.int32),
        receivers=receivers.to(torch.int32),
        rowptr=rowptr,
        degree=counts.to(torch.float32),
        snd_ptr=snd_ptr,
        snd_perm=snd_perm.to(torch.int32),
        layout=layout,
    )


def part_rows(n_edges: int, tile: int) -> int:
    """Rows of the partial-sum scratch of a forward kernel that walks a CSR
    graph in tiles of ``tile`` consecutive edges (``csr_tile`` in
    ``csrc/tile_mm.cuh``): two a tile, one for a receiver that crosses into
    the tile (row 2 t) and one for a receiver that crosses out of it (row
    2 t + 1)."""
    return 2 * (-(-n_edges // tile))


def radius_graph_batch(pos, r: float, loop: bool = True,
                       max_num_neighbors: int = 32,
                       lane_rule: Optional[tuple[str, int]] = None) -> CSRGraph:
    """Radius graphs of B samples pos (B, N, D), flattened into one CSR
    graph over B*N nodes: sample b's node k is node b*N + k.  The graph
    carries the batch's ``TileLayout``; with ``lane_rule`` = (family,
    hidden) it also carries that layer's lane."""
    pos = torch.as_tensor(pos)
    b, recv, send = _radius_edges(pos, r, loop, max_num_neighbors)
    n = pos.shape[1]
    cuts = torch.searchsorted(b, torch.arange(1, pos.shape[0])).tolist()
    samples = list(zip(np.split(send.numpy(), cuts),
                       np.split(recv.numpy(), cuts)))
    graph = csr_from_edges(b * n + send, b * n + recv, pos.shape[0] * n,
                           layout=tile_layout(samples, n))
    if lane_rule is not None:
        graph.lane = lane_of(graph, *lane_rule)
    return graph


class GraphCache:
    """The last few batched radius graphs, on their device, keyed by the
    coordinates' bytes and the graph's parameters.  A model owns one, and
    its lane rule with it."""

    def __init__(self, max_entries: int = 8,
                 lane_rule: Optional[tuple[str, int]] = None):
        self.max_entries = max_entries
        self.lane_rule = lane_rule
        self._graphs: dict = {}
        self.hits = 0

    def clear(self) -> None:
        self._graphs.clear()

    def radius_graph_batch(self, pos, r: float, loop: bool = True,
                           max_num_neighbors: int = 32,
                           device="cpu") -> CSRGraph:
        """``radius_graph_batch(...).to(device)``, built once per distinct
        ``pos`` (B, N, D) numpy array."""
        pos = np.ascontiguousarray(pos)
        digest = hashlib.blake2b(pos.tobytes(), digest_size=16).hexdigest()
        key = (digest, pos.shape, str(pos.dtype), round(float(r), 9),
               bool(loop), int(max_num_neighbors), str(device))
        if key in self._graphs:
            self.hits += 1
            return self._graphs[key]
        graph = radius_graph_batch(torch.from_numpy(pos), r, loop,
                                   max_num_neighbors,
                                   self.lane_rule).to(device)
        if len(self._graphs) >= self.max_entries:
            self._graphs.pop(next(iter(self._graphs)))
        self._graphs[key] = graph
        return graph


#: a padded graph's edge rows are a multiple of this: 16 tiles of 64 edges
EDGE_BUCKET = 1024


def pad_edges(graph: CSRGraph, e_pad: int) -> CSRGraph:
    """``graph`` with its edge rows extended to ``e_pad`` past the end of
    its CSR.  ``rowptr``, ``degree`` and ``snd_ptr`` are the graph's own,
    so its edges are still the first rowptr[-1] rows, the only rows the
    fused edge kernels (those that read the live count: ``CSRGraph``) and
    their plain versions read (the dead rows add nothing and get zero
    gradients).  The dead rows' ``senders`` and ``receivers`` are self
    loops of the last node, so that what is formed per edge row before the
    kernel (the edge features, the edge MLP, the pre-gathered lane's sender
    gather) stays finite, and ``snd_perm`` lists them after the live edges,
    outside every sender's range, so that the sender gather's backward
    (``ops.segment.segment_sum`` over the sender CSR) sums none of them.
    The layout and lane are the graph's."""
    n_edge = graph.n_edge
    if e_pad < n_edge:
        raise ValueError(f"cannot pad {n_edge} edges to {e_pad}")
    if e_pad == n_edge:
        return graph
    if graph.n_node == 0:
        raise ValueError("a graph without nodes has no node to pad with")
    dev = graph.senders.device
    loops = torch.full((e_pad - n_edge,), graph.n_node - 1,
                       dtype=torch.int32, device=dev)
    dead = torch.arange(n_edge, e_pad, dtype=torch.int32, device=dev)
    return dataclasses.replace(
        graph, senders=torch.cat([graph.senders, loops]),
        receivers=torch.cat([graph.receivers, loops]),
        snd_perm=torch.cat([graph.snd_perm, dead]))


class EdgeBuckets:
    """The edge rows a padded graph takes, one bucket per graph role (a
    model's ``graph_parts``: ``all``, ``lr``): the most edges a graph of
    that role has had, rounded up to ``EDGE_BUCKET``, never shrinking (the
    JAX host builder's sticky ``_E_TILE_CACHE``,
    ``magnet_tpu/models/common.py:167-190``).  A trainer keeps one a fit;
    a larger bucket means another signature, and so another capture."""

    def __init__(self):
        self.edges: dict[str, int] = {}

    def grow(self, role: str, n_edge: int) -> int:
        """The bucket of ``role`` once it holds ``n_edge`` edges."""
        need = -(-n_edge // EDGE_BUCKET) * EDGE_BUCKET
        self.edges[role] = max(self.edges.get(role, 0), need)
        return self.edges[role]

    def pad(self, role: str, graph: CSRGraph) -> CSRGraph:
        """``graph`` padded to its role's bucket (grown to hold it)."""
        return pad_edges(graph, self.grow(role, graph.n_edge))


def graph_signature(graph, edges: bool = True) -> tuple:
    """What a captured step fixes of a model's graph, so that two graphs
    of one signature can share a capture: of a ``CSRGraph`` its node rows,
    its edge rows (``edges`` False: left out, as two graphs padded to one
    bucket share them), its lane and its layout's gates; of a tensor (the
    k-NN table) its shape and dtype; of a dataclass of them (``GNNGraphs``)
    each field's; of anything else (no graph) its type."""
    if isinstance(graph, CSRGraph):
        return ("csr", graph.n_node, graph.n_edge if edges else None,
                graph.lane, graph.layout)
    if isinstance(graph, torch.Tensor):
        return ("tensor", tuple(graph.shape), str(graph.dtype))
    if dataclasses.is_dataclass(graph) and not isinstance(graph, type):
        return (type(graph).__name__,) + tuple(
            graph_signature(getattr(graph, f.name), edges)
            for f in dataclasses.fields(graph))
    return (type(graph).__name__,)
