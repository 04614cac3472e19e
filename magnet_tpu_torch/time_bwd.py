"""The width-64 GraphNet backward of this checkout against another tree's,
in turns on one card: #9 at width 64 (the fold entry) and #3 (the
pre-gathered entry); or, with ``dtype=bf16``, #9's bf16 build against its
f32 build.

  python -m magnet_tpu_torch.time_bwd [baseline=DIR] [dtype=bf16]

On the card only.  Builds ``csrc/fused_edge_tail_agg_bwd.cu`` of this
checkout and, with ``baseline=DIR``, of the ``csrc/`` directory DIR of
another tree of the repo (a parent commit unpacked with ``git archive``;
its C entry must take the same arguments).  The graphs are those of the
main paths that launch the two: #9 at a MAgNet[CNN] 1D training batch (32
samples of 32 queries), #3 at MAgNet[CNN] 2D training graphs of 32 samples
(the ``chip_smoke.py`` kernel phase's batch) and of 8 (the trainer's batch
there), with operands and g drawn from a seed at ``chip_smoke.py``'s
scales.  Holds each library against the plain version there (the largest
error and relative L2 error over every gradient) and times it with CUDA
events over ``REPS`` launches, in turns: baseline, this, this, baseline.
Prints the card's name and power limit, then one JSON line per kernel and
shape.  With ``dtype=bf16``: #9 at the MAgNet[CNN] 1D training batch, this
checkout's f32 build and its bf16 build (on the same operands rounded to
bf16) in turns, f32, bf16, bf16, f32, each against its own plain version.
Shares its graphs, libraries and timing with ``time_fwd``.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from magnet_tpu_torch.config import MAGNET_CNN, MAGNET_CNN_2D
from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.time_fwd import (
    BF16_PEAK,
    F32_PEAK,
    REPS,
    TF32_PEAK,
    build_graph,
    card,
    cnn_1d_train_graph,
    in_turns,
    libraries,
    operands,
    to_bf16,
)
from magnet_tpu_torch.utils import make_coord_np

#: each entry's TPU kernel (magnet_tpu/ops/pallas_kernels.py)
KERNEL_NUMBER = {"fold": "#9", "pregathered": "#3"}

def cnn_2d_train_graph(batch_size, seed):
    """A MAgNet[CNN] 2D training graph: ``batch_size`` samples, each the
    32 x 32 LR grid and 32 queries drawn from the 64 x 64 mesh."""
    rng = np.random.default_rng(seed)
    full = make_coord_np([64, 64])
    coords = np.stack([full[np.sort(rng.choice(64 * 64, 32, replace=False))]
                       for _ in range(batch_size)])
    return build_graph("magnet_cnn_2d", MAGNET_CNN_2D,
                       {"coords": coords,
                        "lr_frames": np.zeros((1, 1, 1, 32, 32))})


def cases():
    """(label, entry, hyperparameters, graph), on the CPU."""
    return [("cnn_1d_train", "fold", MAGNET_CNN, cnn_1d_train_graph()),
            ("cnn_2d_train_b32", "pregathered", MAGNET_CNN_2D,
             cnn_2d_train_graph(32, seed=7)),
            ("cnn_2d_train_b8", "pregathered", MAGNET_CNN_2D,
             cnn_2d_train_graph(8, seed=8))]


def runner(fn, entry, ops, g, widths):
    """A closure that launches ``fn`` on ``ops`` and g as the wrapper does
    (the node gradients zeroed, a partial row per SM) and returns (d_src,
    d_pxi, the packed weight gradients)."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    ce, h, c = widths
    n, e, l1 = rowptr.numel() - 1, src.shape[0], tail[0].shape[0]
    fold = entry == "fold"
    dev = src.device
    total = (ce * h + h if fold else 0) + l1 * (h * h + h) + h * c + 3 * c
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(blocks, total, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        d_src = torch.empty_like(src)
        d_nodes = torch.zeros(2, n, h, device=dev)
        wgrad = torch.empty(total, device=dev)
        err = fn(src.data_ptr(), ptr(we), ptr(be), ptr(pxj), pxi.data_ptr(),
                 ptr(senders), rowptr.data_ptr(),
                 *(t.data_ptr() for t in tail[:5]), g.data_ptr(),
                 d_src.data_ptr(), d_nodes[0].data_ptr() if fold else None,
                 d_nodes[1].data_ptr(), wgrad.data_ptr(), partial.data_ptr(),
                 None, n, e, ce, h, c, l1, fe.ENTRY[entry], blocks,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return d_src, d_nodes[1], wgrad
    return run


def runner_bf16(ops, g):
    """A closure that launches the bf16 backward's C entry on ``ops``
    (``to_bf16``) and g as its wrapper does and returns (d_e0, d_pxi, the
    packed weight gradients), all in f32."""
    fn = cuda_build.function(fe.BF16, fe._ARGTYPES[fe.BF16_BWD],
                             symbol=fe.BF16_BWD)
    e0, we, _, _, _, _, rowptr, *tail = ops
    ce, h = we.shape
    n, e = rowptr.numel() - 1, e0.shape[0]
    l1, c = tail[0].shape[0], tail[2].shape[1]
    dev = e0.device
    total = ce * h + h + l1 * (h * h + h) + h * c + 3 * c
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(blocks, total, device=dev)

    def run():
        d_e0 = torch.empty_like(e0)
        d_nodes = torch.zeros(2, n, h, device=dev)
        wgrad = torch.empty(total, device=dev)
        err = fn(*(t.data_ptr() for t in ops[:12]), g.data_ptr(),
                 d_e0.data_ptr(), d_nodes[0].data_ptr(),
                 d_nodes[1].data_ptr(), wgrad.data_ptr(), partial.data_ptr(),
                 n, e, ce, h, c, l1, blocks,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return d_e0.float(), d_nodes[1], wgrad
    return run


def plain_grads(entry, ops, g):
    """(d_src, d_pxi, the packed weight gradients) of the plain version."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    if entry == "fold":
        d = fe.fused_edge_tail_agg_bwd_plain(*ops, g)
        d_src, weights, d_pxi, rest = d[0], d[1:3], d[4], d[5:]
    elif entry == "fold_bf16":
        d = [t.float() for t in fe.fused_edge_tail_agg_bf16_bwd_plain(*ops, g)]
        d_src, weights, d_pxi, rest = d[0], d[1:3], d[4], d[5:]
    else:
        d = fe.fused_edge_tail_agg_pregathered_bwd_plain(src, pxi, rowptr,
                                                         *tail, g)
        d_src, weights, d_pxi, rest = d[0], (), d[1], d[2:]
    return d_src, d_pxi, torch.cat([t.reshape(-1) for t in (*weights, *rest)])


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_bwd: no CUDA device", file=sys.stderr)
        return 1
    args = dict(a.split("=", 1) for a in argv)
    card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fns = libraries(fe.BWD, args)
    if args.get("dtype") == "bf16":
        return main_bf16(fns["this"], dev)
    for label, entry, hp, graph in cases():
        h, c = hp["mlp_hidden"], hp["latent_dim"]
        ce = c if entry == "fold" else h
        l1 = hp["mlp_layers"] - 1
        ops = operands(entry, graph, ce, h, c, l1, seed=43, dev=dev)
        g = torch.randn(graph.n_node, c,
                        generator=torch.Generator().manual_seed(44)).to(dev)
        want = plain_grads(entry, ops, g)
        runs = {k: runner(fn, entry, ops, g, (ce, h, c))
                for k, fn in fns.items()}
        err = {}
        for k, run in runs.items():
            got = run()
            err[k] = {name: {"max_abs": float((a - b).abs().max()),
                             "rel_l2": float((a - b).double().norm()
                                             / b.double().norm())}
                      for name, a, b in zip(("d_src", "d_pxi", "weights"),
                                            got, want)}
        order, times, mean = in_turns(runs)
        macs = (ce * h if entry == "fold" else 0) + l1 * h * h + h * c
        flops = 3 * 2.0 * graph.n_edge * macs
        print(json.dumps({
            "kernel": KERNEL_NUMBER[entry], "entry": entry,
            "widths": [ce, h, c] if entry == "fold" else [h, c],
            "shape": label, "n_node": graph.n_node, "n_edge": graph.n_edge,
            "l1": l1, "reps": REPS, "order": order, "ms": times,
            "mean_ms": mean, "baseline": args.get("baseline"),
            "f32_bound_ms": flops / F32_PEAK * 1e3,
            "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
            "vs_plain": err,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del ops, g, want, runs
    return 0


def main_bf16(fn32, dev) -> int:
    """#9's f32 and bf16 builds in turns at the MAgNet[CNN] 1D training
    batch.  The bf16 build's d_pxi and packed weight gradients are held in
    f32 as its kernel sums them (its wrapper then rounds them to bf16)."""
    label, entry, hp, graph = cases()[0]
    h, c = hp["mlp_hidden"], hp["latent_dim"]
    l1 = hp["mlp_layers"] - 1
    ops = operands(entry, graph, c, h, c, l1, seed=43, dev=dev)
    ops_bf = to_bf16(ops)
    g = torch.randn(graph.n_node, c,
                    generator=torch.Generator().manual_seed(44)).to(dev)
    runs = {"f32": runner(fn32, entry, ops, g, (c, h, c)),
            "bf16": runner_bf16(ops_bf, g)}
    want = {"f32": plain_grads(entry, ops, g),
            "bf16": plain_grads("fold_bf16", ops_bf, g)}
    err = {}
    for k, run in runs.items():
        err[k] = {name: {"max_abs": float((a - b).abs().max()),
                         "rel_l2": float((a - b).double().norm()
                                         / b.double().norm())}
                  for name, a, b in zip(("d_src", "d_pxi", "weights"),
                                        run(), want[k])}
    order, times, mean = in_turns(runs, first="f32", then="bf16")
    flops = 3 * 2.0 * graph.n_edge * (c * h + l1 * h * h + h * c)
    print(json.dumps({
        "kernel": "#9", "entry": entry, "widths": [c, h, c], "shape": label,
        "n_node": graph.n_node, "n_edge": graph.n_edge, "l1": l1,
        "reps": REPS, "order": order, "ms": times, "mean_ms": mean,
        "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
        "bf16_bound_ms": flops / BF16_PEAK * 1e3, "vs_plain": err,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
