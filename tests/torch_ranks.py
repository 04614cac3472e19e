"""A rank function for ``tests/test_torch_parallel_dist.py`` that records
the order of the overlap step's exchange and kernels.  It imports torch
and the port alone: every spawned rank imports this module anew (the
tests' directory is on the path the ranks inherit).
"""
import contextlib
import inspect

from magnet_tpu_torch.nn.graphnet import InteractionNetwork
from magnet_tpu_torch.parallel.launch import loss_rank
from magnet_tpu_torch.parallel.mesh import DistGraphAxis, Exchange


@contextlib.contextmanager
def exchange_order(log: list):
    """Within the block, append to ``log`` in the order they happen each
    exchange started on a ``DistGraphAxis`` ("start"), each finished
    ("wait"), and each region graph's edge sums: "interior" where the
    graph's table is its receiver rows alone (square over the shard's own
    block), else "boundary"."""
    start, wait = DistGraphAxis.start_all_to_all, Exchange.wait
    sums = InteractionNetwork.edge_sums
    signature = inspect.signature(sums)

    def logged(name, fn):
        def call(*args, **kw):
            log.append(name)
            return fn(*args, **kw)
        return call

    def edge_sums(*args, **kw):
        bound = signature.bind(*args, **kw)
        bound.apply_defaults()
        graph, n_recv = bound.arguments["graph"], bound.arguments["n_recv"]
        log.append("interior" if graph.n_node == n_recv else "boundary")
        return sums(*args, **kw)

    DistGraphAxis.start_all_to_all = logged("start", start)
    Exchange.wait = logged("wait", wait)
    InteractionNetwork.edge_sums = edge_sums
    try:
        yield log
    finally:
        DistGraphAxis.start_all_to_all, Exchange.wait = start, wait
        InteractionNetwork.edge_sums = sums


def ordered_loss_rank(rank: int, world: int, cases: list) -> list:
    """``loss_rank``'s result for each case, each case run on its own with
    its ``exchange_order`` log (training forward, backward, validation
    forward) under "order"."""
    out = []
    for case in cases:
        log = []
        with exchange_order(log):
            (result,) = loss_rank(rank, world, [case])
        out.append({**result, "order": log})
    return out
