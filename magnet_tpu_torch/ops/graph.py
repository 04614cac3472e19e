"""Host graph building: radius graphs and the batched CSR layout.

``radius_graph`` has the semantics of ``magnet_tpu/ops/graph.py:43-79``
(torch_cluster's): float64 positions, inclusive ``<= r``, optional self
loops, and at most ``max_num_neighbors`` senders per receiver, the
lowest-indexed ones.  Edges come out receiver-grouped with senders
ascending, which is already CSR order.

``radius_graph_batch`` flattens a batch of B graphs into one graph by node
offsets, so one kernel launch covers the whole batch with no padding or
edge mask.  It takes the place of the TPU's tile packing
(``block_graph``, ``_chunk_list``), which exists only for the TPU's tiling.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CSRGraph:
    """One (possibly batch-flattened) receiver-grouped graph.

    senders, receivers: (E,) int32, edge j -> i is senders[e] -> receivers[e];
    rowptr: (N+1,) int32, the edges of receiver i are rowptr[i]:rowptr[i+1];
    degree: (N,) float32 in-degree.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    rowptr: torch.Tensor
    degree: torch.Tensor

    @property
    def n_node(self) -> int:
        return self.rowptr.numel() - 1

    @property
    def n_edge(self) -> int:
        return self.senders.numel()

    def to(self, device) -> "CSRGraph":
        return CSRGraph(*(t.to(device) for t in
                          (self.senders, self.receivers, self.rowptr,
                           self.degree)))


def _radius_edges(pos: torch.Tensor, r: float, loop: bool,
                  max_num_neighbors: int):
    """pos (B, N, D) -> (b, receiver, sender) int64 index triples, sorted by
    sample, then receiver, then sender."""
    pos = pos.to(torch.float64)
    d2 = ((pos[:, :, None, :] - pos[:, None, :, :]) ** 2).sum(-1)
    adj = d2 <= float(r) ** 2
    if not loop:
        adj &= ~torch.eye(pos.shape[1], dtype=torch.bool, device=pos.device)
    # keep the lowest-indexed max_num_neighbors senders of each receiver
    adj &= torch.cumsum(adj, dim=-1) <= max_num_neighbors
    return adj.nonzero(as_tuple=True)


def radius_graph(pos, r: float, loop: bool = False,
                 max_num_neighbors: int = 32):
    """Single-sample radius graph: pos (N, D) -> (senders, receivers), int32."""
    pos = torch.as_tensor(pos)
    _, recv, send = _radius_edges(pos[None], r, loop, max_num_neighbors)
    return send.to(torch.int32), recv.to(torch.int32)


def csr_from_edges(senders, receivers, n_node: int) -> CSRGraph:
    """Pack receiver-grouped edges (receivers non-decreasing) as CSR.

    The fused edge kernel trusts the CSR it is given, so the checks are
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
    counts = torch.bincount(receivers.long(), minlength=n_node)
    rowptr = torch.zeros(n_node + 1, dtype=torch.int64)
    torch.cumsum(counts, 0, out=rowptr[1:])
    return CSRGraph(
        senders=senders.to(torch.int32),
        receivers=receivers.to(torch.int32),
        rowptr=rowptr.to(torch.int32),
        degree=counts.to(torch.float32),
    )


def radius_graph_batch(pos, r: float, loop: bool = True,
                       max_num_neighbors: int = 32) -> CSRGraph:
    """Radius graphs of B samples pos (B, N, D), flattened into one CSR
    graph over B*N nodes: sample b's node k is node b*N + k."""
    pos = torch.as_tensor(pos)
    b, recv, send = _radius_edges(pos, r, loop, max_num_neighbors)
    n = pos.shape[1]
    return csr_from_edges(b * n + send, b * n + recv, pos.shape[0] * n)
