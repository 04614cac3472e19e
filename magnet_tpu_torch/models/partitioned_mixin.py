"""The graph-parallel execution path shared by the GraphNet models
(counterpart of ``magnet_tpu/models/partitioned_mixin.py:17-339``).

A model's forward takes its graph as a ``CSRGraph`` or as a
``parallel.graph_partition.PartitionedGraph``; ``encode_process`` is the
one place where the two differ: the node and edge features, the encoder
and the processor over the whole graph, or over the shards this process
holds (the edge features and latents of each shard's own edges, the
processor through ``graphnet_processor``).  So the windowed rollout and
the losses are the model's own whichever graph it is given, and
``loss_partitioned`` keeps ``loss``'s train and validation semantics
exactly as the JAX docstring (``partitioned_mixin.py:304-311``) states
them: train = teacher forcing or the LR feedback, plus the interp term;
val = no teacher forcing, the HR prediction fed back, the HR criterion
alone, no interp term.

Under ``torch.distributed`` every rank of a graph axis computes the parts
outside the processor (front end, encoder, decoder, loss) for the whole
graph; the gradients those ranks compute are summed over the axis and
divided by its size (``train.trainer.Trainer``), which counts each
parameter's gradient once.
"""
from __future__ import annotations

import numpy as np
import torch

from magnet_tpu_torch.ops.graph import CSRGraph
from magnet_tpu_torch.parallel.graph_partition import (
    PartitionedGraph,
    build_partition_buffers,
    graphnet_processor,
    partitioned_graph,
    radius_edges,
)
from magnet_tpu_torch.parallel.mesh import LocalGraphAxis


def edge_features(feats, coords, senders, receivers):
    """[value and coordinate differences, sender minus receiver] of the
    edges (senders, receivers) over the batch-flattened node rows."""
    return torch.cat([feats.index_select(0, senders)
                      - feats.index_select(0, receivers),
                      coords.index_select(0, senders)
                      - coords.index_select(0, receivers)], dim=-1)


def partitioned_edge_feats(feats, coords, part: PartitionedGraph) -> list:
    """Each held shard's edge features, in its graph's edge order (overlap
    and ring: the interior region's, then the boundary's, as the JAX
    package's interior/boundary pair)."""
    return [edge_features(feats, coords, *sg.edge_endpoints())
            for sg in part.shards]


def run_partitioned_processor(processor, nf, efs, part: PartitionedGraph,
                              impl: str = "kernel"):
    """The processor edge-partitioned over ``part``'s graph axis: nf
    (B * n_node, C), efs each held shard's edge latents; returns every
    node's latents (B * n_node, C)."""
    return graphnet_processor(processor, nf, efs, part, impl)


def encode_process(encoder, processor, feats, coords, t_last, graph,
                   impl: str = "kernel"):
    """Node features [values | coords | t] and edge features of the
    batch-flattened node rows (B * M, ·), encoded, then the processor over
    ``graph`` (a ``CSRGraph`` or a ``PartitionedGraph``): (B * M, C)."""
    nodes = torch.cat([feats, coords, t_last], dim=-1)
    if isinstance(graph, PartitionedGraph):
        efs = [encoder.edge_fn(e)
               for e in partitioned_edge_feats(feats, coords, graph)]
        return run_partitioned_processor(processor, encoder.node_fn(nodes),
                                         efs, graph, impl)
    edges = edge_features(feats, coords, graph.senders, graph.receivers)
    nf, ef = encoder(nodes, edges)
    return processor(nf, ef, graph, impl=impl)


def partition(coords: np.ndarray, radius: float, loop: bool, n_shards: int,
              halo, axis, device, lane_rule) -> PartitionedGraph:
    """The radius graphs of coords (B, M, d), partitioned over ``n_shards``
    (``build_partition_buffers``); the shards ``axis`` holds (None: all of
    them, ``LocalGraphAxis``) on ``device``, each with its lane."""
    raw = radius_edges(coords, radius, loop)
    pg = build_partition_buffers(raw, coords.shape[1], n_shards, halo=halo)
    return partitioned_graph(pg, axis or LocalGraphAxis(n_shards), device,
                             lane_rule, ring=halo == "ring")


class PartitionedGraphMixin:
    """Graph parallelism for a model with ``radius``, ``graphs.lane_rule``,
    a ``build_graph`` hook ``_graph_coords(batch)`` (every sample's node
    coordinates, (B, M, d) numpy) and a forward that takes either graph;
    MAgNet[GNN] and MPNN partition their own graphs."""

    def build_graph_partitioned(self, batch, n_shards: int, halo=False,
                                axis=None) -> PartitionedGraph:
        """The batch's radius graph (self loops) partitioned over
        ``n_shards``; ``halo`` False (all-gather), True or "fused" (the
        halo exchange), "overlap" (the halo exchange in flight behind the
        interior edges) or "ring" (overlap, the exchange as rotations);
        ``axis`` the graph axis (``parallel.mesh``; None: all shards
        here)."""
        return partition(self._graph_coords(batch), self.radius, True,
                         n_shards, halo, axis, next(self.parameters()).device,
                         self.graphs.lane_rule)

    def loss_partitioned(self, batch, pg, train: bool = True, **kw):
        """``loss`` over the partitioned graph ``pg``: the same rollout,
        criterion and metrics, train and validation (``kw``: ``loss``'s
        own, MAgNet[GNN]'s ``generator``)."""
        if isinstance(pg, CSRGraph):
            raise TypeError("loss_partitioned takes a PartitionedGraph "
                            "(build_graph_partitioned)")
        return self.loss(batch, pg, train=train, **kw)
