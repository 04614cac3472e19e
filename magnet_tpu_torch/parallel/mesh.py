"""The (dp, graph) process mesh (counterpart of
``magnet_tpu/parallel/mesh.py:21-37``) and the two forms of its graph axis.

A run of ``dp * graph`` ranks (``torchrun --nproc_per_node=N``) is laid out
as JAX's ``reshape(dp, graph)`` lays out its devices: rank = dp_index *
graph + graph_index.  ``dp`` splits the batch, ``graph`` splits each
sample's graph (``parallel.graph_partition``).  The backend is NCCL for
``cuda`` and gloo only when the caller passes ``device="cpu"``.

The graph axis has two forms with one interface (``shards``, the shards
this process holds; ``all_gather``, ``all_to_all``, ``all_reduce``, each
over a list with one entry per held shard; ``start_all_to_all``, the
all-to-all started and finished by the ``Exchange`` it returns, as one
collective or, ``ring=True``, as G - 1 rotations):

* ``DistGraphAxis``: one shard a rank, the collectives autograd Functions
  that carry gradients (the all-gather's backward is a reduce-scatter, the
  all-to-all's the reverse all-to-all, the ring's the rotations reversed,
  the all-reduce's an all-reduce);
* ``LocalGraphAxis``: all G shards of a sample in one process on one
  device, the collectives index copies there (the ring as the
  all-to-all: the same blocks reach the same slots).  It is the counterpart of
  the virtual CPU devices the JAX tests run their mesh on: NCCL refuses two
  ranks on one card, so tests and ``chip_smoke.py`` run G = 2 and 4 on one
  card this way.  ``run.py`` never selects it.

A started exchange is in flight until ``Exchange.wait()``: on NCCL it runs
on NCCL's stream, which the current stream waits for at ``wait()``; on
gloo ``wait()`` blocks the host until it is done.  Its result may be read
only after ``wait()``, and a failed collective raises there.
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

    def start_all_to_all(self, sends, ring: bool = False) -> "Exchange":
        """``all_to_all`` as an exchange to finish.  ``ring`` moves the
        same blocks to the same slots: in one process the order of the
        copies is not observable, so it takes the all-to-all."""
        return Exchange(self.all_to_all(sends))

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


class Exchange:
    """An exchange in flight: ``blocks``, for each shard this process
    holds, the blocks it receives in source order, readable once ``wait()``
    has finished the collective's handles ``works``; ``tensors``, what the
    collective reads and writes, kept alive until then."""

    def __init__(self, blocks=None):
        self.blocks, self.works, self.tensors = blocks, [], ()

    def wait(self) -> list:
        for work in self.works:
            work.wait()
        self.works, self.tensors = [], ()
        return self.blocks


def _ring(group, x, out, backward: bool = False) -> list:
    """x's i-th of n equal row blocks to rank i of ``group``, out's i-th
    block from rank i, as n - 1 rotations: rotation k sends the block for
    rank (r + k) mod n and receives from (r - k) mod n, r this rank; with
    ``backward`` each rotation runs the other way (the adjoint).  Returns
    the rotations' handles, not waited on."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    sign = -1 if backward else 1
    src, dst = x.chunk(n), out.chunk(n)
    dst[r].copy_(src[r])
    works = []
    for k in range(1, n):
        to, frm = (r + sign * k) % n, (r - sign * k) % n
        works += dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src[to], dist.get_global_rank(group, to),
                       group),
            dist.P2POp(dist.irecv, dst[frm],
                       dist.get_global_rank(group, frm), group)])
    return works


class _AllToAllStart(torch.autograd.Function):
    """``_AllToAll`` (``ring``: as ``_ring``'s rotations) started and left in
    flight in ``exchange``: the result may be read only after
    ``exchange.wait()``.  The backward runs the adjoint and waits for it
    before it hands the gradient to the sender block."""

    @staticmethod
    def forward(ctx, group, exchange, ring, x):
        ctx.group, ctx.ring = group, ring
        x = x.contiguous()
        out = torch.empty_like(x)
        if ring:
            exchange.works = _ring(group, x, out)
        else:
            exchange.works = [dist.all_to_all_single(out, x, group=group,
                                                     async_op=True)]
        exchange.tensors = (x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if not ctx.ring:
            return None, None, None, _AllToAll.apply(ctx.group, g)
        out = torch.empty_like(g)
        for work in _ring(ctx.group, g, out, backward=True):
            work.wait()
        return None, None, None, out


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

    def start_all_to_all(self, sends, ring: bool = False) -> Exchange:
        exchange = Exchange()
        recv = _AllToAllStart.apply(self.group, exchange, ring,
                                    torch.cat(sends[0]))
        exchange.blocks = [list(recv.chunk(self.size))]
        return exchange

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
