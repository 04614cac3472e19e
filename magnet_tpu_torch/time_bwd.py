"""The GraphNet backward of this checkout against another tree's, in
turns on one card: #9 at width 64 and 128 (the fold entry) and #3 (the
pre-gathered entry); or, with ``dtype=bf16``, the bf16 builds of #9 (both
widths), #7, #3 and #1 (the segment sum) against their f32 builds.

  python -m magnet_tpu_torch.time_bwd [baseline=DIR] [dtype=bf16] [width=64]

On the card only.  Builds ``csrc/fused_edge_tail_agg_bwd.cu`` of this
checkout and, with ``baseline=DIR``, of the ``csrc/`` directory DIR of
another tree of the repo (a parent commit unpacked with ``git archive``;
its C entry must take the same arguments).  The graphs are those of the
main paths that launch the two: #9 at a MAgNet[CNN] 1D training batch (32
samples of 32 queries) and at width 128 at a MAgNet[GNN] 1D training
batch's LR ∪ HR graph, #3 at MAgNet[CNN] 2D training graphs of 32 samples
(the ``chip_smoke.py`` kernel phase's batch) and of 8 (the trainer's batch
there), with operands and g drawn from a seed at ``chip_smoke.py``'s
scales.  Holds each library against the plain version there (the largest
error and relative L2 error over every gradient), this checkout's d_src
and weight gradients against the baseline's bit for bit (d_pxi adds with
atomics), and times it with CUDA events over ``REPS`` launches, in turns:
baseline, this, this, baseline.
Prints the card's name and power limit, then one JSON line per kernel and
shape.  With ``dtype=bf16``: #9 at the MAgNet[CNN] 1D training batch and
#3 at the two MAgNet[CNN] 2D training graphs, this checkout's f32 build
and its bf16 build (on the same operands rounded to bf16) in turns, f32,
bf16, bf16, f32, each against its own plain version; then #1 over the
32-sample graph's sender CSR on the f32 and the bf16 rows of #3's d_h0,
in turns, with ``index_add_`` (f32, then rounded to bf16: two calls) for
the library's time; then #9 and #7 at width 128 at MAgNet[GNN]'s eval and
training graphs (``time_fwd``'s), the f32 launch sequence
(``csrc/fused_edge_tail_agg_bwd.cu``) against the bf16 one
(``csrc/fused_edge_tail_agg_bf16_w128.cu``) through their launchers (#7
without the segment sum of its d_pxj), in the same turns, the bf16 one
against its plain version by relative L2 per gradient.  With
``baseline=DIR dtype=bf16``: the width-64 bf16 backward (#9 and #7 at
the MAgNet[CNN] 1D training batch, #3 at the 2D training graphs; d_src,
dz and the weight gradients held bit for bit against DIR's; then
MAgNet[CNN] 1D and 2D bf16 steps) of DIR against this checkout's in turns,
then (unless ``width=64``) the width-128 bf16 backward
(``csrc/fused_edge_tail_agg_bf16_w128.cu``, #9 fold, #7 pe without its
segment sum, #3 pre-gathered) of DIR against this checkout's, through
their C entries with the same arguments, in turns (baseline, this, this,
baseline), at MAgNet[GNN]'s 1D training graph, a 2D training graph of the
published 512-node irregular configuration and the 1D eval graph, each
build against the plain version (relative L2 per gradient), with the
plain version's time and the bf16 bound; then MAgNet[GNN] 1D bf16
training steps (``Trainer.train_step`` on one batch of 32 KS trajectories
from the datamodule's synthetic source) on the fold, pe and pre-gathered
lanes, the backward through DIR's build and this one's in the same turns.
Shares its graphs, libraries and timing with ``time_fwd``.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from magnet_tpu_torch.config import (
    DATAMODULE_IMPLICIT,
    DATAMODULE_IMPLICIT_2D,
    DATAMODULE_IMPLICIT_GNN,
    MAGNET_CNN,
    MAGNET_CNN_2D,
    MAGNET_GNN,
)
from magnet_tpu_torch.data.datamodule import build_loaders
from magnet_tpu_torch.data.synthetic import irregular_nodes
from magnet_tpu_torch.models.factory import create_model
from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.ops import segment as seg
from magnet_tpu_torch.time_fwd import (
    BF16_PEAK,
    F32_PEAK,
    HBM_RATE,
    REPS,
    TF32_PEAK,
    card,
    cnn_1d_train_graph,
    cnn_2d_train_graph,
    cuda_ms,
    gnn_train_graph,
    graphs,
    in_turns,
    libraries,
    operands,
    pregathered_bf16,
    to_bf16,
)

#: each entry's TPU kernel (magnet_tpu/ops/pallas_kernels.py)
KERNEL_NUMBER = {"fold": "#9", "pregathered": "#3", "pe": "#7"}


def cases():
    """(label, entry, hyperparameters, graph), on the CPU."""
    return [("cnn_1d_train", "fold", MAGNET_CNN, cnn_1d_train_graph()),
            ("gnn_1d_train", "fold", MAGNET_GNN, gnn_train_graph()),
            ("cnn_2d_train_b32", "pregathered", MAGNET_CNN_2D,
             cnn_2d_train_graph(32, seed=7)),
            ("cnn_2d_train_b8", "pregathered", MAGNET_CNN_2D,
             cnn_2d_train_graph(8, seed=8))]


def runner(fn, entry, ops, g, widths):
    """A closure that launches ``fn`` on ``ops`` and g as the wrapper does
    (the node gradients zeroed, a partial row per SM, width 128's scratch)
    and returns (d_src, d_pxi, the packed weight gradients)."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    ce, h, c = widths
    n, e, l1 = rowptr.numel() - 1, src.shape[0], tail[0].shape[0]
    fold = entry == "fold"
    dev = src.device
    total = (ce * h + h if fold else 0) + l1 * (h * h + h) + h * c + 3 * c
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(blocks, total, device=dev)
    scratch = (torch.empty(fe.bwd_scratch_planes(entry, l1) * e * h
                           + 2 * blocks * 2 * h, device=dev)
               if h == 128 else None)

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
                 ptr(scratch), n, e, ce, h, c, l1, fe.ENTRY[entry], blocks,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return d_src, d_nodes[1], wgrad
    return run


def runner_bf16(ops, g, fn=None):
    """A closure that launches the bf16 backward's C entry ``fn`` (this
    checkout's unless given) on ``ops`` (``to_bf16``) and g as its wrapper
    does and returns (d_e0 bf16, d_pxi and the packed weight gradients
    f32): buffers allocated once and reused by every call (the node
    gradients zeroed before each), so that a timed run of calls is not
    held by the host's allocations."""
    fn = fn or cuda_build.function(fe.BF16, fe._ARGTYPES[fe.BF16_BWD],
                                   symbol=fe.BF16_BWD)
    e0, we, _, _, _, _, rowptr, *tail = ops
    ce, h = we.shape
    n, e = rowptr.numel() - 1, e0.shape[0]
    l1, c = tail[0].shape[0], tail[2].shape[1]
    dev = e0.device
    total = ce * h + h + l1 * (h * h + h) + h * c + 3 * c
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(blocks, total, device=dev)
    d_e0 = torch.empty_like(e0)
    d_nodes = torch.zeros(2, n, h, device=dev)
    wgrad = torch.empty(total, device=dev)
    args = (*(t.data_ptr() for t in ops[:12]), g.data_ptr(),
            d_e0.data_ptr(), d_nodes[0].data_ptr(), d_nodes[1].data_ptr(),
            wgrad.data_ptr(), partial.data_ptr(), n, e, ce, h, c, l1, blocks,
            torch.cuda.current_stream(dev).cuda_stream)

    def run():
        d_nodes.zero_()
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return d_e0, d_nodes[1], wgrad
    return run


def runner_pregathered_bf16(ops, g, fn=None):
    """A closure that launches the bf16 pregathered backward's C entry
    ``fn`` (this checkout's unless given) on ``ops`` (``pregathered_bf16``)
    and g as its wrapper does and returns (d_h0 bf16, d_pxi and the packed
    weight gradients f32), in buffers reused by every call
    (``runner_bf16``)."""
    fn = fn or cuda_build.function(fe.BF16, fe._ARGTYPES[fe.BF16_PRE_BWD],
                                   symbol=fe.BF16_PRE_BWD)
    h0, pxi, rowptr, *tail = ops
    n, e, h = rowptr.numel() - 1, h0.shape[0], h0.shape[1]
    l1, c = tail[0].shape[0], tail[2].shape[1]
    dev = h0.device
    total = l1 * (h * h + h) + h * c + 3 * c
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(blocks, total, device=dev)
    d_h0 = torch.empty_like(h0)
    d_pxi = torch.zeros(n, h, device=dev)
    wgrad = torch.empty(total, device=dev)
    args = (*(t.data_ptr() for t in (h0, pxi, rowptr, *tail[:5])),
            g.data_ptr(), d_h0.data_ptr(), d_pxi.data_ptr(),
            wgrad.data_ptr(), partial.data_ptr(), n, e, h, c, l1, blocks,
            torch.cuda.current_stream(dev).cuda_stream)

    def run():
        d_pxi.zero_()
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return d_h0, d_pxi, wgrad
    return run


def runner_pe64_bf16(ops, g, fn=None):
    """A closure that launches the width-64 bf16 pe backward's C entry
    ``fn`` (#7 alone, without the caller's segment sum; this checkout's
    unless given) on the C-entry operands ``ops`` (``operands("pe", ...)``
    through ``to_bf16``) and g as its wrapper does and returns (d_pe bf16,
    dz, d_pxi and the packed weight gradients f32), in buffers reused by
    every call (``runner_bf16``)."""
    fn = fn or cuda_build.function(fe.BF16, fe._ARGTYPES[fe.BF16_PE_BWD],
                                   symbol=fe.BF16_PE_BWD)
    pe, _, _, pxj, pxi, senders, rowptr, *tail = ops
    n, (e, h) = rowptr.numel() - 1, pe.shape
    l1, c = tail[0].shape[0], tail[2].shape[1]
    dev = pe.device
    total = l1 * (h * h + h) + h * c + 3 * c
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(blocks, total, device=dev)
    d_pe = torch.empty_like(pe)
    dz = torch.empty(e, h, device=dev)
    d_pxi = torch.zeros(n, h, device=dev)
    wgrad = torch.empty(total, device=dev)
    args = (*(t.data_ptr() for t in (pe, pxj, pxi, senders, rowptr,
                                     *tail[:5])),
            g.data_ptr(), d_pe.data_ptr(), dz.data_ptr(), d_pxi.data_ptr(),
            wgrad.data_ptr(), partial.data_ptr(), n, e, h, c, l1, blocks,
            torch.cuda.current_stream(dev).cuda_stream)

    def run():
        d_pxi.zero_()
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return d_pe, dz, d_pxi, wgrad
    return run


def runner_segment(x, ptr, perm):
    """A closure that launches the segment sum's C entry for x's dtype (f32
    or bf16) over the CSR (ptr, perm) and returns the sums."""
    fn = cuda_build.function(seg.NAME, seg._ARGTYPES,
                             symbol=seg.SYMBOLS[x.dtype])
    n_seg, c = ptr.numel() - 1, x.shape[1]

    def run():
        out = torch.empty(n_seg, c, dtype=x.dtype, device=x.device)
        err = fn(x.data_ptr(), ptr.data_ptr(), perm.data_ptr(),
                 out.data_ptr(), n_seg, perm.numel(), c,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def plain_grads(entry, ops, g):
    """(d_src, d_pxi, the packed weight gradients) of the plain version
    (``pregathered_bf16``: ops are ``pregathered_bf16``'s)."""
    if entry == "pregathered_bf16":
        d = [t.float() for t in
             fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(*ops, g)]
        return d[0], d[1], torch.cat([t.reshape(-1) for t in d[2:]])
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
    if args.get("dtype") == "bf16" and "baseline" in args:
        main_bf16_w64_baseline(Path(args["baseline"]), dev)
        if args.get("width") == "64":
            return 0
        return main_bf16_w128_baseline(Path(args["baseline"]), dev)
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
        err, outs = {}, {}
        for k, run in runs.items():
            got = outs[k] = run()
            err[k] = {name: {"max_abs": float((a - b).abs().max()),
                             "rel_l2": float((a - b).double().norm()
                                             / b.double().norm())}
                      for name, a, b in zip(("d_src", "d_pxi", "weights"),
                                            got, want)}
        bits = ({name: bool(torch.equal(outs["this"][i], outs["baseline"][i]))
                 for i, name in ((0, "d_src"), (2, "weights"))}
                if "baseline" in outs else None)
        order, times, mean = in_turns(runs)
        macs = (ce * h if entry == "fold" else 0) + l1 * h * h + h * c
        flops = 3 * 2.0 * graph.n_edge * macs
        print(json.dumps({
            "kernel": KERNEL_NUMBER[entry], "entry": entry,
            "widths": [ce, h, c] if entry == "fold" else [h, c],
            "shape": label, "n_node": graph.n_node, "n_edge": graph.n_edge,
            "l1": l1, "reps": REPS, "order": order, "ms": times,
            "mean_ms": mean, "baseline": args.get("baseline"),
            "bit_equal_to_baseline": bits,
            "f32_bound_ms": flops / F32_PEAK * 1e3,
            "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
            "vs_plain": err,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del ops, g, want, runs, outs
    return 0


def main_bf16(fn32, dev) -> int:
    """#9's f32 and bf16 builds in turns at the MAgNet[CNN] 1D training
    batch, #3's at the two MAgNet[CNN] 2D training graphs, then #1's.  The
    bf16 builds' d_pxi and packed weight gradients are held in f32 as their
    kernels sum them (their wrappers then round them to bf16)."""
    for label, entry, hp, graph in cases():
        h, c = hp["mlp_hidden"], hp["latent_dim"]
        ce = c if entry == "fold" else h
        l1 = hp["mlp_layers"] - 1
        ops = operands(entry, graph, ce, h, c, l1, seed=43, dev=dev)
        g = torch.randn(graph.n_node, c,
                        generator=torch.Generator().manual_seed(44)).to(dev)
        if entry == "fold":
            ops_bf = to_bf16(ops)
            runs = {"f32": runner(fn32, entry, ops, g, (ce, h, c)),
                    "bf16": runner_bf16(ops_bf, g)}
        else:
            ops_bf = pregathered_bf16(ops)
            runs = {"f32": runner(fn32, entry, ops, g, (ce, h, c)),
                    "bf16": runner_pregathered_bf16(ops_bf, g)}
        want = {"f32": plain_grads(entry, ops, g),
                "bf16": plain_grads(f"{entry}_bf16", ops_bf, g)}
        err = {}
        for k, run in runs.items():
            err[k] = {name: {"max_abs": float((a - b).abs().max()),
                             "rel_l2": float((a - b).double().norm()
                                             / b.double().norm())}
                      for name, a, b in zip(("d_src", "d_pxi", "weights"),
                                            run(), want[k])}
        order, times, mean = in_turns(runs, first="f32", then="bf16")
        macs = (ce * h if entry == "fold" else 0) + l1 * h * h + h * c
        flops = 3 * 2.0 * graph.n_edge * macs
        print(json.dumps({
            "kernel": KERNEL_NUMBER[entry], "entry": entry,
            "widths": [ce, h, c] if entry == "fold" else [h, c],
            "shape": label, "n_node": graph.n_node, "n_edge": graph.n_edge,
            "l1": l1, "reps": REPS, "order": order, "ms": times,
            "mean_ms": mean, "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
            "bf16_bound_ms": flops / BF16_PEAK * 1e3, "vs_plain": err,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        if label == "cnn_2d_train_b32":
            rows = runs["f32"]()[0]
            segment = (graph, rows)
        del ops, ops_bf, g, runs, want
    graph, rows = segment
    ptr, perm = graph.snd_ptr.to(dev), graph.snd_perm.to(dev)
    senders = graph.senders.to(dev).long()
    runs = {"f32": runner_segment(rows, ptr, perm),
            "bf16": runner_segment(rows.bfloat16(), ptr, perm)}
    err = {}
    for k, run in runs.items():
        got = run()
        want = seg.segment_sum_plain(rows.to(got.dtype), ptr, perm)
        err[k] = float((got.float() - want.float()).abs().max())
    order, times, mean = in_turns(runs, first="f32", then="bf16")
    rows_bf = rows.bfloat16()
    e, n, h = graph.n_edge, graph.n_node, rows.shape[1]
    print(json.dumps({
        "kernel": "#1", "entry": "segment_sum", "shape": "cnn_2d_train_b32",
        "n_node": n, "n_edge": e, "c": h, "reps": REPS, "order": order,
        "ms": times, "mean_ms": mean,
        "library_ms": {
            "f32": cuda_ms(lambda: torch.zeros(n, h, device=dev).index_add_(
                0, senders, rows)),
            "bf16": cuda_ms(lambda: torch.zeros(n, h, device=dev).index_add_(
                0, senders, rows_bf.float()).bfloat16())},
        "library": "index_add_ (bf16: f32 index_add_, then .bfloat16())",
        "bound_ms": {k: (size * (e * h + n * h) + 4.0 * (e + n + 1))
                     / HBM_RATE * 1e3
                     for k, size in (("f32", 4.0), ("bf16", 2.0))},
        "max_abs_err_vs_plain": err,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return main_bf16_w128(dev)


def bf16_w128_vs_plain(entry, ops_bf, g, graph):
    """The width-128 bf16 backward of ``entry`` on ``ops_bf`` against its
    plain version: {gradient: relative L2} in the plain version's order
    (the pe entry's d_pxj summed by the f32 segment sum from dz)."""
    src, _, _, pxj, pxi, senders, rowptr, *tail = ops_bf
    got = list(fe._launch_bf16_w128_bwd(entry, *ops_bf, g))
    if entry == "fold":
        names, want = fe.GRAD_NAMES, fe.fused_edge_tail_agg_bf16_bwd_plain(
            *ops_bf, g)
    else:
        dev = src.device
        got[1] = seg.segment_sum(got[1], graph.snd_ptr.to(dev),
                                 graph.snd_perm.to(dev)).bfloat16()
        names, want = fe.GRAD_NAMES_PE, fe.fused_edge_tail_agg_pe_bf16_bwd_plain(
            src, pxj, pxi, senders, rowptr, None, None, *tail, g)
    return {name: float((a.double() - b.double()).norm()
                        / b.double().norm().clamp_min(1e-30))
            for name, a, b in zip(names, got, want) if b.numel()}


def main_bf16_w128(dev) -> int:
    """#9's and #7's f32 and bf16 builds at width 128 in turns at
    MAgNet[GNN]'s eval and training graphs, through their launchers."""
    w, l1 = MAGNET_GNN["mlp_hidden"], MAGNET_GNN["mlp_layers"] - 1
    for label, graph in (("gnn_eval_all", graphs()[3][2]),
                         ("gnn_train_all", gnn_train_graph())):
        g = torch.randn(graph.n_node, w,
                        generator=torch.Generator().manual_seed(44)).to(dev)
        for entry in ("fold", "pe"):
            ops = operands(entry, graph, w, w, w, l1, seed=43, dev=dev)
            ops_bf = to_bf16(ops)
            runs = {"f32": lambda: fe._launch_bwd(entry, *ops, g),
                    "bf16": lambda: fe._launch_bf16_w128_bwd(entry, *ops_bf,
                                                             g)}
            err = bf16_w128_vs_plain(entry, ops_bf, g, graph)
            order, times, mean = in_turns(runs, first="f32", then="bf16")
            macs = (w * w if entry == "fold" else 0) + l1 * w * w + w * w
            flops = 3 * 2.0 * graph.n_edge * macs
            print(json.dumps({
                "kernel": KERNEL_NUMBER[entry], "entry": entry,
                "widths": [w, w, w] if entry == "fold" else [w, w],
                "shape": label, "n_node": graph.n_node,
                "n_edge": graph.n_edge, "l1": l1, "reps": REPS,
                "order": order, "ms": times, "mean_ms": mean,
                "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
                "bf16_bound_ms": flops / BF16_PEAK * 1e3,
                "bf16_vs_plain_rel_l2": err,
                "device": torch.cuda.get_device_name(0)}), flush=True)
            del ops, ops_bf, runs
    return 0


def gnn2d_train_graph():
    """A MAgNet[GNN] 2D training batch's LR ∪ HR graph at the published
    512-node irregular configuration (``res_train`` 512, ``samples`` 256):
    32 samples, each 512 nodes of the 64 x 64 grid drawn from a seed as the
    synthetic irregular split draws them (``irregular_nodes``), scaled to
    [-1, 1] per axis; the support every second node, the queries the other
    256 (``DatasetImplicitGNN2D`` in train mode)."""
    rng = np.random.default_rng(0)
    x = np.arange(64, dtype=np.float32)
    lr, hr = [], []
    for _ in range(32):
        coords = irregular_nodes(rng, x, x, 512, concentrated=False)[1]
        coords = 2 * (coords - coords.min(0)) / (coords.max(0)
                                                  - coords.min(0)) - 1
        lr.append(coords[::2])
        hr.append(coords[1::2])
    model = create_model("magnet_gnn", {**MAGNET_GNN, "time_slice": 10},
                         device="cpu", seed=0, kind="h5_implicit_gnn_2d")
    return model.build_graph({"coords_lr": torch.as_tensor(np.stack(lr)),
                              "coords_hr": torch.as_tensor(np.stack(hr))}).all


def bf16_w128_bwd_bound(entry, graph, w, l1) -> dict:
    """Least time on the card for one width-128 bf16 backward call: three
    times the forward's products at the dense bf16 rate, against each input
    read once and each output written once (bf16 operands and gradients at
    2 bytes; g, d_ln, the indices and the pe's dz at 4)."""
    n, e = graph.n_node, graph.n_edge
    fold, pe = entry == "fold", entry == "pe"
    macs = (w * w if fold else 0) + l1 * w * w + w * w
    weights = (w * w + w if fold else 0) + l1 * (w * w + w) + w * w + w
    tables = 2 if entry != "pregathered" else 1   # pxj and pxi, or pxi
    src_in = 2.0 * (e * w + tables * n * w + weights)
    nbytes = (src_in + 4.0 * (2 * w + (e if entry != "pregathered" else 0)
                              + n + 1)
              + 4.0 * n * w                      # g
              + 2.0 * (e * w + tables * n * w + weights) + 4.0 * 2 * w
              + (4.0 * e * w if pe else 0.0))    # dz32
    flops = 3 * 2.0 * e * macs
    t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"bf16_bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def runner_bf16_w128_bwd(fn, entry, ops, g):
    """A closure that launches a width-128 bf16 backward C entry ``fn``
    (this checkout's or another tree's, the same arguments) for ``entry``
    on ``ops`` (``to_bf16``) and g as a wrapper does, with partial rows and
    scratch planes enough for the launch sequence of per-layer planes too
    (``fe.bwd_scratch_planes``; the cluster pipeline reads no scratch), and
    returns (d_src, d_pxi, the packed weight and bias gradients), all in
    f32."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    n, e, l1, h = rowptr.numel() - 1, src.shape[0], tail[0].shape[0], 128
    fold, pe = entry == "fold", entry == "pe"
    dev = src.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_w = int(fold) + l1 + 1
    weights, biases = n_w * h * h, (n_w + 2) * h
    partial = torch.empty(n_sm * weights + 2 * n_sm * biases, device=dev)
    scratch = torch.empty(fe.bwd_scratch_planes(entry, l1) * e * h,
                          dtype=torch.bfloat16, device=dev)
    d_src = torch.empty_like(src)
    dz = torch.empty(e, h, device=dev) if pe else None
    wgrad = torch.empty(weights + biases, device=dev)
    w_rest, b_rest, w_out, b_out, ln_s, _ = tail

    def run():
        d_nodes = torch.zeros(2 if fold else 1, n, h, device=dev)
        err = fn(src.data_ptr(), fe._ptr(we), fe._ptr(be), fe._ptr(pxj),
                 pxi.data_ptr(), fe._ptr(senders),
                 *(t.data_ptr() for t in (rowptr, w_rest, b_rest, w_out,
                                          b_out, ln_s, g, d_src)),
                 fe._ptr(dz), d_nodes[0].data_ptr() if fold else None,
                 d_nodes[-1].data_ptr(), wgrad.data_ptr(), partial.data_ptr(),
                 scratch.data_ptr(), n, e, l1, fe.ENTRY[entry], n_sm,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return d_src.float(), d_nodes[-1].clone(), wgrad.clone()
    return run


def plain_bf16_w128(entry, ops, g):
    """(d_src, d_pxi, the packed weight and bias gradients) of the width-128
    bf16 plain version of ``entry`` on the C entry's ``ops``, in f32."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    if entry == "fold":
        d = fe.fused_edge_tail_agg_bf16_bwd_plain(*ops, g)
        d_src, d_pxi, head, rest = d[0], d[4], (d[1], d[2]), d[5:]
    elif entry == "pe":
        d = fe.fused_edge_tail_agg_pe_bf16_bwd_plain(
            src, pxj, pxi, senders, rowptr, None, None, *tail, g)
        d_src, d_pxi, head, rest = d[0], d[2], (), d[3:]
    else:
        d = fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(
            src, pxi, rowptr, *tail, g)
        d_src, d_pxi, head, rest = d[0], d[1], (), d[2:]
    w_rest, b_rest, w_out, b_out, ln_s, ln_b = rest
    packed = torch.cat([t.float().reshape(-1) for t in (
        *head[:1], w_rest, w_out, *head[1:], b_rest, b_out, ln_s, ln_b)])
    return d_src.float(), d_pxi.float(), packed


def main_bf16_w128_baseline(baseline: Path, dev) -> int:
    """The width-128 bf16 backward of the tree at ``baseline`` (its
    ``csrc/``) against this checkout's, in turns, fold, pe and
    pre-gathered, at the GNN 1D and 2D training graphs and the 1D eval
    graph."""
    fns = {"baseline": cuda_build.build(fe.BF16_W128, csrc=baseline),
           "this": cuda_build.build(fe.BF16_W128)}
    for k, lib in fns.items():
        fn = getattr(ctypes.CDLL(str(lib)), fe.BF16_W128_BWD)
        fn.argtypes = fe._ARGTYPES[fe.BF16_W128_BWD]
        fn.restype = ctypes.c_int
        fns[k] = fn
    w, l1 = MAGNET_GNN["mlp_hidden"], MAGNET_GNN["mlp_layers"] - 1
    for label, graph in (("gnn_train_all", gnn_train_graph()),
                         ("gnn2d_train_all", gnn2d_train_graph()),
                         ("gnn_eval_all", graphs()[3][2])):
        g = torch.randn(graph.n_node, w,
                        generator=torch.Generator().manual_seed(44)).to(dev)
        for entry in ("fold", "pe", "pregathered"):
            ops = to_bf16(operands(entry, graph, w, w, w, l1, seed=43,
                                   dev=dev))
            runs = {k: runner_bf16_w128_bwd(fn, entry, ops, g)
                    for k, fn in fns.items()}
            want = plain_bf16_w128(entry, ops, g)
            err = {}
            for k, run in runs.items():
                err[k] = {name: float((a - b).double().norm()
                                      / b.double().norm().clamp_min(1e-30))
                          for name, a, b in zip(
                              ("d_src", "d_pxi", "packed_weights_biases"),
                              run(), want)}
            order, times, mean = in_turns(runs)
            print(json.dumps({
                "kernel": KERNEL_NUMBER[entry], "entry": entry,
                "widths": [w, w, w] if entry == "fold" else [w, w],
                "shape": label, "n_node": graph.n_node,
                "n_edge": graph.n_edge, "l1": l1, "reps": REPS,
                "order": order, "ms": times, "mean_ms": mean,
                "baseline": str(baseline),
                "plain_ms": cuda_ms(lambda: plain_bf16_w128(entry, ops, g)),
                **bf16_w128_bwd_bound(entry, graph, w, l1),
                "vs_plain_rel_l2": err,
                "device": torch.cuda.get_device_name(0)}), flush=True)
            del ops, runs, want
    train_steps_in_turns(fns["baseline"], dev)
    return 0


#: the width-64 bf16 backward's C entry of each entry
BF16_W64_SYMBOL = {"fold": fe.BF16_BWD, "pe": fe.BF16_PE_BWD,
                   "pregathered": fe.BF16_PRE_BWD}


def bf16_w64_bwd_bound(entry, graph, l1) -> dict:
    """Least time on the card for one width-64 bf16 backward call
    (``chip_smoke.py``'s ``bf16_bound``, ``pregathered_bf16_bound`` and
    ``pe_bf16_bound``): three times the forward's operations at the dense
    bf16 rate, against each input read once and each output written once
    (bf16 operands and gradients at 2 bytes; g, ln_s, ln_b, d_ln, the
    indices and the pe's dz at 4)."""
    n, e = graph.n_node, graph.n_edge
    ce, h, c = 32, 64, 32
    fold = entry == "fold"
    flops = 3 * 2.0 * e * ((ce * h if fold else 0) + l1 * h * h + h * c)
    weights = (ce * h + h if fold else 0) + l1 * (h * h + h) + h * c + c
    src = e * (ce if fold else h)
    tables = 1 if entry == "pregathered" else 2
    ints = e if entry != "pregathered" else 0
    inputs = 2.0 * (src + tables * n * h + weights) \
        + 4.0 * (2 * c + ints + n + 1)
    out = 2.0 * (src + tables * n * h + weights) + 4.0 * 2 * c
    if entry == "pe":
        out = 2.0 * (e * h + n * h + weights) + 4.0 * (e * h + 2 * c)
    elif entry == "pregathered":
        out = 2.0 * (e * h + n * h + weights) + 4.0 * 2 * c
    nbytes = inputs + 4.0 * n * c + out
    t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"bf16_bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def bf16_w64_functions(lib) -> dict:
    """{entry: the width-64 bf16 backward's C entry} of a library built from
    any tree (the same arguments in both)."""
    out = {}
    for entry, symbol in BF16_W64_SYMBOL.items():
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = fe._ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        out[entry] = fn
    return out


def main_bf16_w64_baseline(baseline: Path, dev) -> None:
    """The width-64 bf16 backward of the tree at ``baseline`` (its
    ``csrc/fused_edge_tail_agg_bf16.cu``) against this checkout's, in turns
    (baseline, this, this, baseline): #9 (fold) and #7 (pe, without its
    segment sum) at a MAgNet[CNN] 1D training batch, #3 (pre-gathered) at
    the MAgNet[CNN] 2D training graphs of 32 and 8 samples, each build
    against the plain version (relative L2 of d_src, d_pxi and the packed
    weight and bias gradients), with the plain version's time and the bf16
    bound, and this build's d_src, packed gradients and (pe) dz against the
    baseline's bit for bit (d_pxi adds with atomics); then MAgNet[CNN] 1D
    and 2D bf16 training steps in turns, the backward through either
    build."""
    fns = {"baseline": bf16_w64_functions(
               cuda_build.build(fe.BF16, csrc=baseline)),
           "this": bf16_w64_functions(cuda_build.build(fe.BF16))}
    for label, entry, hp, graph in cases():
        h, c = hp["mlp_hidden"], hp["latent_dim"]
        if h != 64:  # the width-128 cases: main_bf16_w128_baseline's
            continue
        l1 = hp["mlp_layers"] - 1
        g = torch.randn(graph.n_node, c,
                        generator=torch.Generator().manual_seed(44)).to(dev)
        for kind in (("fold", "pe") if entry == "fold" else ("pregathered",)):
            ops = to_bf16(operands(kind, graph, c if kind == "fold" else h,
                                   h, c, l1, seed=43, dev=dev))
            if kind == "fold":
                make, want = runner_bf16, plain_grads("fold_bf16", ops, g)
            elif kind == "pe":
                make = runner_pe64_bf16
                src, _, _, pxj, pxi, senders, rowptr, *tail = ops
                d = fe.fused_edge_tail_agg_pe_bf16_bwd_plain(
                    src, pxj, pxi, senders, rowptr, graph.snd_ptr.to(dev),
                    graph.snd_perm.to(dev), *tail, g)
                want = (d[0].float(), d[2].float(),
                        torch.cat([t.float().reshape(-1) for t in d[3:]]))
            else:
                ops = pregathered_bf16(ops)
                make = runner_pregathered_bf16
                want = plain_grads("pregathered_bf16", ops, g)
            runs = {k: make(ops, g, fn[kind]) for k, fn in fns.items()}

            def exact(got):
                """d_src, dz (pe) and the packed gradients: all but d_pxi
                (atomics), copied out of the reused buffers."""
                return [t.clone() for i, t in enumerate(got)
                        if i != len(got) - 2]

            # each build twice, in turns (its own repeat, and the bits of
            # its last call against the other's)
            calls = {k: [] for k in runs}
            for k in ("baseline", "this", "this", "baseline"):
                calls[k].append(exact(runs[k]()))
            kept = {k: c[-1] for k, c in calls.items()}
            again = {k: c[0] for k, c in calls.items()}
            err = {}
            for k, run in runs.items():
                got = run()
                got = (got[0], got[-2], got[-1])  # d_src, d_pxi, packed
                err[k] = {name: float((a.double() - b.double()).norm()
                                      / b.double().norm().clamp_min(1e-30))
                          for name, a, b in zip(
                              ("d_src", "d_pxi", "packed_weights_biases"),
                              got, want)}
            order, times, mean = in_turns(runs)
            if kind == "fold":
                plain = lambda: plain_grads("fold_bf16", ops, g)  # noqa: E731
            elif kind == "pe":
                plain = lambda: fe.fused_edge_tail_agg_pe_bf16_bwd_plain(  # noqa: E731
                    src, pxj, pxi, senders, rowptr, graph.snd_ptr.to(dev),
                    graph.snd_perm.to(dev), *tail, g)
            else:
                plain = lambda: plain_grads("pregathered_bf16", ops, g)  # noqa: E731
            print(json.dumps({
                "kernel": KERNEL_NUMBER[kind], "entry": kind,
                "widths": [c, h, c] if kind == "fold" else [h, c],
                "shape": label, "n_node": graph.n_node,
                "n_edge": graph.n_edge, "l1": l1, "reps": REPS,
                "order": order, "ms": times, "mean_ms": mean,
                "baseline": str(baseline), "plain_ms": cuda_ms(plain),
                **bf16_w64_bwd_bound(kind, graph, l1),
                "vs_plain_rel_l2": err,
                "bit_equal_run_to_run": {
                    k: all(torch.equal(a, b) for a, b in zip(kept[k],
                                                             again[k]))
                    for k in kept},
                "bit_equal_to_baseline": {
                    name: {"equal": bool(torch.equal(a, b)),
                           "n_differing": int((a != b).sum()),
                           "max_abs_diff": float((a.double() - b.double())
                                                 .abs().max())}
                    for name, a, b in zip(
                        ("d_src", "dz", "packed_weights_biases")
                        if kind == "pe" else ("d_src",
                                              "packed_weights_biases"),
                        kept["this"], kept["baseline"])},
                "device": torch.cuda.get_device_name(0)}), flush=True)
            del ops, runs, want, kept, again
    cnn_train_steps_in_turns(fns["baseline"], dev)


@contextlib.contextmanager
def bf16_w64_backward_of(fns):
    """Inside the block the width-64 bf16 backward's launchers run another
    tree's C entries ``fns`` ({entry: function}, the same arguments): the
    cached C functions are swapped for them."""
    saved = {}
    for entry, symbol in BF16_W64_SYMBOL.items():
        cuda_build.function(fe.BF16, fe._ARGTYPES[symbol], symbol=symbol)
        saved[symbol] = cuda_build._FUNCTIONS[symbol]
        cuda_build._FUNCTIONS[symbol] = (saved[symbol][0], fns[entry])
    try:
        yield
    finally:
        cuda_build._FUNCTIONS.update(saved)


def cnn_train_steps_in_turns(baseline_fns, dev, steps=5) -> None:
    """Seconds a MAgNet[CNN] bf16 training step, the width-64 bf16 backward
    through the baseline's build and this one's in turns (baseline, this,
    this, baseline), each the mean of ``steps`` steps on one batch after two
    steps of warm-up: 1D on one batch of 32 KS trajectories on the fold
    lane (``kernel``: #9) and the pe lane (``kernel_pe``: #7), 2D on one
    batch of 8 Burgers-2D trajectories (``kernel``: the training graph's
    pre-gathered lane, #3), each from the datamodule's synthetic source."""
    from magnet_tpu_torch.train.trainer import Trainer

    one_d = build_loaders({**DATAMODULE_IMPLICIT, "source": "synthetic_ks",
                           "n_train": 32, "n_val": 1, "n_test": 1,
                           "burn_in": 10.0, "data_seed": 0}, seed=0)
    two_d = build_loaders({**DATAMODULE_IMPLICIT_2D,
                           "source": "synthetic_burgers_2d", "n_train": 8,
                           "n_val": 1, "n_test": 1, "batch_size": 8,
                           "data_seed": 0}, seed=0)
    for name, hp, loaders, lane in (
            ("magnet_cnn", MAGNET_CNN, one_d, "kernel"),
            ("magnet_cnn", MAGNET_CNN, one_d, "kernel_pe"),
            ("magnet_cnn_2d", MAGNET_CNN_2D, two_d, "kernel")):
        batch = next(iter(loaders["train"]))
        model = create_model(name, {**hp, "graph_dtype": "bf16"}, device=dev,
                             seed=0)
        model.impl = lane
        with tempfile.TemporaryDirectory() as workdir:
            trainer = Trainer(model, workdir=workdir, device=dev)
            trainer.setup(1)

            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    trainer.train_step(batch)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / steps

            with bf16_w64_backward_of(baseline_fns):
                run()
            run()
            order = ["baseline", "this", "this", "baseline"]
            secs = []
            for k in order:
                if k == "baseline":
                    with bf16_w64_backward_of(baseline_fns):
                        secs.append(run())
                else:
                    secs.append(run())
        print(json.dumps({
            "train_step": f"{name} bf16", "impl": lane,
            "batch_size": len(batch["coords"]) if "coords" in batch else None,
            "steps_a_turn": steps, "order": order, "seconds": secs,
            "mean_s": {k: float(np.mean([t for o, t in zip(order, secs)
                                         if o == k]))
                       for k in ("baseline", "this")},
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del model, trainer


@contextlib.contextmanager
def backward_of(fn):
    """Inside the block the width-128 bf16 backward's launcher runs another
    tree's C entry ``fn`` (the same arguments): its cached C function is
    swapped for a shim that hands ``fn`` partial rows and scratch planes
    enough for the launch sequence of per-layer planes
    (``fe.bwd_scratch_planes``), allocated at the first call of a size."""
    buffers = {}
    names = {v: k for k, v in fe.ENTRY.items()}

    def shim(*args):
        args = list(args)
        n_edges, l1, entry, n_sm = args[21:25]
        n_w = (names[entry] == "fold") + l1 + 1
        key = (n_sm * n_w * 128 * 128 + 2 * n_sm * (n_w + 2) * 128,
               fe.bwd_scratch_planes(names[entry], l1) * n_edges * 128)
        if key not in buffers:
            buffers.clear()
            buffers[key] = (torch.empty(key[0], device="cuda"),
                            torch.empty(max(1, key[1]), dtype=torch.bfloat16,
                                        device="cuda"))
        args[18], args[19] = (t.data_ptr() for t in buffers[key])
        return fn(*args)

    cuda_build.function(fe.BF16_W128, fe._ARGTYPES[fe.BF16_W128_BWD],
                        symbol=fe.BF16_W128_BWD)
    saved = cuda_build._FUNCTIONS[fe.BF16_W128_BWD]
    cuda_build._FUNCTIONS[fe.BF16_W128_BWD] = (saved[0], shim)
    try:
        yield
    finally:
        cuda_build._FUNCTIONS[fe.BF16_W128_BWD] = saved


def train_steps_in_turns(baseline_fn, dev, steps=5) -> None:
    """Seconds a MAgNet[GNN] 1D bf16 training step on each GraphNet lane
    (fold: ``kernel``; pe: ``kernel_pe``; pre-gathered:
    ``kernel_pregathered``), the width-128 bf16 backward through the
    baseline's build and this one's in turns (baseline, this, this,
    baseline), each the mean of ``steps`` steps on one batch of 32 KS
    trajectories after two steps of warm-up."""
    from magnet_tpu_torch.train.trainer import Trainer

    loaders = build_loaders({**DATAMODULE_IMPLICIT_GNN,
                             "source": "synthetic_ks", "n_train": 32,
                             "n_val": 1, "n_test": 1, "burn_in": 10.0,
                             "data_seed": 0}, seed=0)
    batch = next(iter(loaders["train"]))
    for lane in ("kernel", "kernel_pe", "kernel_pregathered"):
        model = create_model("magnet_gnn", {**MAGNET_GNN,
                                            "graph_dtype": "bf16"},
                             device=dev, seed=0)
        model.impl = lane
        with tempfile.TemporaryDirectory() as workdir:
            trainer = Trainer(model, workdir=workdir, device=dev)
            trainer.setup(1)

            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    trainer.train_step(batch)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / steps

            with backward_of(baseline_fn):
                run()
            run()
            order = ["baseline", "this", "this", "baseline"]
            secs = []
            for k in order:
                if k == "baseline":
                    with backward_of(baseline_fn):
                        secs.append(run())
                else:
                    secs.append(run())
        print(json.dumps({
            "train_step": "magnet_gnn 1D bf16", "impl": lane,
            "batch_size": 32, "steps_a_turn": steps, "order": order,
            "seconds": secs,
            "mean_s": {k: float(np.mean([t for o, t in zip(order, secs)
                                         if o == k]))
                       for k in ("baseline", "this")},
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del model, trainer


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
