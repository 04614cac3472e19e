"""The (dp, graph) process mesh (counterpart of
``magnet_tpu/parallel/mesh.py:21-37``) and the two forms of its graph axis.

A run of ``dp * graph`` ranks (``torchrun --nproc_per_node=N``) is laid out
as JAX's ``reshape(dp, graph)`` lays out its devices: rank = dp_index *
graph + graph_index.  ``dp`` splits the batch, ``graph`` splits each
sample's graph (``parallel.graph_partition``).  The backend is NCCL for
``cuda`` and gloo only when the caller passes ``device="cpu"``.

The graph axis has two forms with one interface (``shards``, the shards
this process holds; ``all_gather``, ``all_to_all``, ``all_reduce``, each
over a list with one entry per held shard):

* ``DistGraphAxis``: one shard a rank, the collectives autograd Functions
  that carry gradients (the all-gather's backward is a reduce-scatter, the
  all-to-all's the reverse all-to-all, the all-reduce's an all-reduce);
* ``LocalGraphAxis``: all G shards of a sample in one process on one
  device, the collectives index copies there.  It is the counterpart of
  the virtual CPU devices the JAX tests run their mesh on: NCCL refuses two
  ranks on one card, so tests and ``chip_smoke.py`` run G = 2 and 4 on one
  card this way.  ``run.py`` never selects it.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

#: seconds a collective may wait before the process group gives up
TIMEOUT_S = 600

# torch marks the collectives used here deprecated in favour of functional
# collectives that carry no gradient
warnings.filterwarnings("ignore", message=r".*torch\.distributed\..* is "
                        r"deprecated", category=FutureWarning)


def backend_of(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", timeout_s: float = TIMEOUT_S) -> int:
    """Join the process group that torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
    describes, and on ``cuda`` take the card ``LOCAL_RANK``.  Returns the
    world size: 1, with no group, when the process was not started by a
    launcher."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_of(device), init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return world


class LocalGraphAxis:
    """The graph axis of ``size`` shards held by one process; its
    collectives are index copies on the shards' device."""

    def __init__(self, size: int):
        self.size = size
        self.shards = list(range(size))

    def all_gather(self, xs):
        """Every shard's block, in shard order."""
        return list(xs)

    def all_to_all(self, sends):
        """``sends[s][d]`` goes from shard s to shard d: returns, for each
        shard d, the blocks it receives in source order."""
        return [[sends[s][d] for s in self.shards] for d in self.shards]

    def all_reduce(self, xs):
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return [total] * self.size


class _AllGather(torch.autograd.Function):
    """The blocks of every rank of ``group``, stacked in rank order; the
    backward sums each block's gradient over the ranks into its owner (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.contiguous()
        if dist.get_backend(ctx.group) == dist.Backend.NCCL:
            out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=ctx.group)
            return None, out
        # gloo has no reduce-scatter: exchange the blocks, then sum them
        parts = torch.empty_like(g)
        dist.all_to_all_single(parts, g, group=ctx.group)
        return None, parts.view(n, -1, *g.shape[1:]).sum(0)


class _AllToAll(torch.autograd.Function):
    """x's i-th of n equal row blocks goes to rank i of ``group``; the
    result's i-th block comes from rank i.  Its adjoint is itself."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, _AllToAll.apply(ctx.group, g.contiguous())


class DistGraphAxis:
    """The graph axis over the process group ``group``, in which this rank
    holds shard ``index`` of ``size``.  The all-gather and the all-to-all
    are autograd Functions of this module over ``all_gather_into_tensor``
    and ``all_to_all_single``: those of ``torch.distributed.nn.functional``
    go through a gloo scatter whose root is a group rank taken as a global
    one, which fails on a graph axis that is not the whole world (dp > 1).
    The all-reduce is ``torch.distributed.nn.functional``'s."""

    def __init__(self, group, index: int, size: int):
        self.group, self.size = group, size
        self.shards = [index]

    def all_gather(self, xs):
        return list(_AllGather.apply(self.group, xs[0]).chunk(self.size))

    def all_to_all(self, sends):
        recv = _AllToAll.apply(self.group, torch.cat(sends[0]))
        return [list(recv.chunk(self.size))]

    def all_reduce(self, xs):
        from torch.distributed.nn.functional import all_reduce

        return [all_reduce(xs[0], group=self.group)]


@dataclass
class Mesh:
    """This rank's place in the (dp, graph) mesh and its groups (None in a
    world of one process)."""

    dp: int
    graph: int
    rank: int
    device: torch.device
    dp_group: Optional[object] = None
    graph_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.dp * self.graph

    @property
    def dp_index(self) -> int:
        return self.rank // self.graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.graph

    def graph_axis(self) -> DistGraphAxis:
        return DistGraphAxis(self.graph_group, self.graph_index, self.graph)


def make_mesh(dp: int = -1, graph: int = 1, device="cuda") -> Mesh:
    """The (dp, graph) mesh over the process group's ranks; ``dp`` = -1
    takes every rank the graph axis leaves.  Raises when dp * graph is not
    the world size (the JAX ``make_mesh`` likewise needs that many
    devices).  Every rank must call it, in the same order: it makes the
    groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if graph < 1 or world % graph:
        raise ValueError(f"{world} ranks do not split into graph axes of "
                         f"{graph}")
    if dp == -1:
        dp = world // graph
    if dp * graph != world:
        raise ValueError(f"a mesh of dp={dp} x graph={graph} needs "
                         f"{dp * graph} ranks; the world has {world}")
    mesh = Mesh(dp=dp, graph=graph, rank=rank, device=torch.device(device))
    if world == 1:
        return mesh
    for d in range(dp):
        group = dist.new_group([d * graph + g for g in range(graph)])
        if d == mesh.dp_index:
            mesh.graph_group = group
    for g in range(graph):
        group = dist.new_group([d * graph + g for d in range(dp)])
        if g == mesh.graph_index:
            mesh.dp_group = group
    return mesh
