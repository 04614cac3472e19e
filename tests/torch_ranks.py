"""Rank functions of the tests: ``ordered_loss_rank``
(``tests/test_torch_parallel_dist.py``) records the order of the overlap
step's exchange and kernels; ``captured_fit_rank``
(``tests/test_torch_padded_bf16w128.py``) runs a fit as it runs on CUDA
devices, captured chunks and all, on the CPU.  They import torch and the
port alone: every spawned rank imports this module anew (the tests'
directory is on the path the ranks inherit).
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


def captured_fit_rank(rank: int, world: int, specs: list) -> list:
    """``train.capture_checks.grown_bucket_fit_rank`` of each spec
    (``fit_rank``, rank ``spec["grow_rank"]``'s buckets grown before its
    second padded chunk) as the fit runs on CUDA devices, on the CPU: the
    capture rule read as on a CUDA device and ``EagerStep`` for the capture
    (the warm-up runs the step, the capture executes nothing, as a CUDA
    graph's capture does, and a replay runs the step).  Each result also
    holds the rank's calls of ``torch.distributed.all_reduce`` in that
    fit."""
    from unittest import mock

    import torch
    import torch.distributed as dist

    from magnet_tpu_torch.train import trainer as tr
    from magnet_tpu_torch.train.capture_checks import (EagerStep,
                                                        grown_bucket_fit_rank)

    uncaptured = tr.Trainer._uncaptured

    def on_cuda(self, chunk):
        device, self.device = self.device, torch.device("cuda")
        try:
            return uncaptured(self, chunk)
        finally:
            self.device = device

    out = []
    for spec in specs:
        with mock.patch.object(tr.Trainer, "step_capture", EagerStep), \
                mock.patch.object(tr.Trainer, "_uncaptured", on_cuda), \
                mock.patch.object(dist, "all_reduce",
                                  wraps=dist.all_reduce) as all_reduce:
            result = grown_bucket_fit_rank(rank, world, spec)
        out.append({**result, "all_reduces": all_reduce.call_count})
    return out
