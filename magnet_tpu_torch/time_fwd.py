"""The fused GraphNet forward of this checkout against another tree's, in
turns on one card: #8 at width 64 and 128, #6, and #2 at width 128; or,
with ``dtype=bf16``, the bf16 builds of #8 (both widths), #6 and #2 against
their f32 builds.

  python -m magnet_tpu_torch.time_fwd [baseline=DIR] [dtype=bf16]

On the card only.  Builds ``csrc/fused_edge_tail_agg.cu`` of this checkout
and, with ``baseline=DIR``, of the ``csrc/`` directory DIR of another tree
of the repo (a parent commit unpacked with ``git archive``, say; its C
entry must take the same arguments).  Makes each main path's graph from
its coordinates: MAgNet[CNN] 1D's eval batch (16 Heat trajectories) and a
training batch (32 samples of 32 queries drawn from a seed), MAgNet[CNN]
2D's eval batch (4 samples at 64²), MAgNet[GNN]'s eval LR ∪ HR graph (16
trajectories; #6 and #2 there too), with operands drawn from a seed at
``chip_smoke.py``'s scales.  Holds each library against the plain version
there (max abs error) and times it with CUDA events over ``REPS``
launches, in turns: baseline, this, this, baseline.  Prints the card's
name and power limit, then one JSON line per kernel and shape: the edge
count, the times, each library's mean, the bounds (f32 CUDA cores and
three TF32 products on the tensor cores) and the errors.  With
``dtype=bf16`` it times, at MAgNet[CNN] 1D's eval and training graphs and
MAgNet[CNN] 2D's eval graph, this checkout's f32 fold build (``f32``) and
its bf16 build (``csrc/fused_edge_tail_agg_bf16.cu``, ``bf16``, on the
same operands rounded to bf16), and at MAgNet[CNN] 2D's training graph
(32 samples) the pregathered entry's two builds (#2), in turns: f32, bf16,
bf16, f32, each against its own plain version, with the bf16 bound (one
product at 989 TFLOP/s; the pregathered forward is bound by bytes); then
at MAgNet[GNN]'s eval LR ∪ HR graph and a training batch's (32 samples of
32 queries from a seed) the fold and pe entries at width 128, the f32
build (``csrc/fused_edge_tail_agg.cu``) against the bf16 one
(``csrc/fused_edge_tail_agg_bf16_w128.cu``) in the same turns.  With
``baseline=DIR dtype=bf16`` it times the bf16 forwards of DIR against this
checkout's instead, in turns baseline, this, this, baseline: #8 and #6 at
width 64 at MAgNet[CNN] 1D's eval and training graphs and 2D's eval
graph, #2 at 2D's training graphs of 32 and 8 samples, #8, #6 and #2 at
width 128 at MAgNet[GNN]'s eval and training graphs, each with the plain
version's time, its bf16 bound and its share of it; then the bf16 eval
batches and training steps of MAgNet[CNN] 1D / 2D and MAgNet[GNN] 1D / 2D
with the forwards through either build.  Its graphs, library binding and
in-turn timing serve ``time_bwd`` too.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
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
    DATAMODULE_IMPLICIT_GNN_2D,
    HEAT_TEST,
    MAGNET_CNN,
    MAGNET_CNN_2D,
    MAGNET_GNN,
)
from magnet_tpu_torch.data.datamodule import synthetic_test_batches
from magnet_tpu_torch.data.heat import heat_batches
from magnet_tpu_torch.models.factory import create_model
from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.ops.graph import part_rows
from magnet_tpu_torch.utils import make_coord_np

# H100 SXM data sheet, FLOP/s: f32 CUDA cores, TF32 and bf16 tensor cores;
# HBM3 bytes/s
F32_PEAK, TF32_PEAK, BF16_PEAK = 67e12, 495e12, 989e12
HBM_RATE = 3.35e12
REPS = 20  # launches a timed run
BUSY_CYCLES = 6_000_000  # ~3 ms of the device: REPS launches' host time
#: each entry's TPU kernel (magnet_tpu/ops/pallas_kernels.py)
KERNEL_NUMBER = {"fold": "#8", "pe": "#6", "pregathered": "#2"}


def build_graph(name, hp, batch):
    """``name``'s graph of one batch, on the CPU."""
    model = create_model(name, dict(hp), device="cpu", seed=0)
    return model.build_graph({k: torch.as_tensor(v) for k, v in batch.items()})


def cnn_1d_train_graph():
    """A MAgNet[CNN] 1D training batch's graph: 32 samples of 32 queries
    drawn from the 256-point mesh from a seed."""
    rng = np.random.default_rng(0)
    grid = make_coord_np([256])
    queries = np.stack([grid[np.sort(rng.choice(256, 32, replace=False))]
                        for _ in range(32)])
    return build_graph("magnet_cnn", MAGNET_CNN,
                       {"coords": queries,
                        "lr_frames": np.zeros((32, 1, 1, 128))})


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


def gnn_train_graph():
    """A MAgNet[GNN] 1D training batch's LR ∪ HR graph: 32 samples, each the
    128 support nodes of the 256-node mesh on [-1, 1] and 32 queries drawn
    from its odd complement from a seed (``DatasetImplicitGNN1D``)."""
    rng = np.random.default_rng(0)
    mesh = np.linspace(-1, 1, 256, dtype=np.float32)[:, None]
    queries = np.stack([mesh[1::2][np.sort(rng.choice(128, 32, replace=False))]
                        for _ in range(32)])
    lr = np.broadcast_to(mesh[::2], (32, 128, 1)).copy()
    return build_graph("magnet_gnn", MAGNET_GNN,
                       {"coords_lr": lr, "coords_hr": queries}).all


def graphs():
    """(label, model name, graph) of each main path's #8 / #6 launches, on
    the CPU."""
    heat = heat_batches(16, 16, nt=HEAT_TEST["nt"], nx=HEAT_TEST["nx"])[0]
    mesh = make_coord_np([64, 64])
    eval_2d = {"coords": np.broadcast_to(mesh, (4, *mesh.shape)).copy(),
               "lr_frames": np.zeros((1, 1, 1, 32, 32))}
    gnn = synthetic_test_batches("magnet_gnn", 16, 16, seed=0)[0]
    g_gnn = build_graph("magnet_gnn", MAGNET_GNN, gnn).all
    return [("cnn_1d_eval", MAGNET_CNN,
             build_graph("magnet_cnn", MAGNET_CNN, heat)),
            ("cnn_1d_train", MAGNET_CNN, cnn_1d_train_graph()),
            ("cnn_2d_eval", MAGNET_CNN_2D,
             build_graph("magnet_cnn_2d", MAGNET_CNN_2D, eval_2d)),
            ("gnn_eval_all", MAGNET_GNN, g_gnn)]


def operands(entry, graph, ce, h, c, l1, seed, dev):
    """The C entry's operands (src, we, be, pxj, pxi, senders, rowptr,
    tail...) at chip_smoke.py's scales; we and be are None but for the
    fold (the pregathered entry reads neither pxj nor senders)."""
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    n, e = graph.n_node, graph.n_edge
    src = f(e, ce if entry == "fold" else h)
    we, be = (f(ce, h), f(h)) if entry == "fold" else (None, None)
    return (src, we, be, f(n, h), f(n, h), graph.senders.to(dev),
            graph.rowptr.to(dev), f(l1, h, h), f(l1, h), f(h, c), f(c),
            1 + f(c, scale=0.1), f(c, scale=0.1))


def bind(lib, name):
    """The C entry ``<name>_f32`` of a library built from any tree."""
    fn = getattr(ctypes.CDLL(str(lib)), f"{name}_f32")
    fn.argtypes = fe._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def libraries(name, args):
    """{"this": this checkout's library ``name``, "baseline": DIR's, when
    args names ``baseline=DIR``}, bound."""
    libs = {"this": cuda_build.build(name)}
    if "baseline" in args:
        libs["baseline"] = cuda_build.build(name, csrc=Path(args["baseline"]))
    return {k: bind(v, name) for k, v in libs.items()}


def card():
    """Prints the card's name and power limit (nvidia-smi)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)


def runner(fn, entry, ops, widths):
    """A closure that launches ``fn`` on ``ops`` as the wrapper does (out
    zeroed, the partial-row scratch) and returns out."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    ce, h, c = widths
    n, e, l1 = rowptr.numel() - 1, src.shape[0], tail[0].shape[0]
    part = torch.empty(part_rows(e, fe.FWD_TILE), c, device=src.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        out = torch.zeros(n, c, device=src.device)
        err = fn(src.data_ptr(), ptr(we), ptr(be), pxj.data_ptr(),
                 pxi.data_ptr(), senders.data_ptr(), rowptr.data_ptr(),
                 *(t.data_ptr() for t in tail), out.data_ptr(),
                 part.data_ptr(), n, e, ce, h, c, l1, fe.ENTRY[entry],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def to_bf16(ops):
    """An entry's operands (``operands``) in the bf16 lane: every float
    operand rounded to bf16 but ln_s and ln_b (the last two)."""
    return tuple(t.bfloat16() if t is not None and t.is_floating_point()
                 and i < len(ops) - 2 else t for i, t in enumerate(ops))


def runner_bf16(ops, fn=None):
    """A closure that launches the bf16 forward's C entry (``fn``, or this
    checkout's) on ``ops`` (bf16, ``to_bf16``) as its wrapper does and
    returns out."""
    fn = fn or cuda_build.function(fe.BF16, fe._ARGTYPES[fe.BF16_FWD],
                                   symbol=fe.BF16_FWD)
    e0, we, _, _, _, _, rowptr, *tail = ops
    n, e, l1 = rowptr.numel() - 1, e0.shape[0], tail[0].shape[0]
    c = tail[2].shape[1]
    part = torch.empty(part_rows(e, fe.FWD_TILE), c, device=e0.device)

    def run():
        out = torch.zeros(n, c, device=e0.device)
        err = fn(*(t.data_ptr() for t in ops), out.data_ptr(),
                 part.data_ptr(), n, e, e0.shape[1], we.shape[1], c, l1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def runner_bf16_w128(entry, ops, fn=None):
    """A closure that launches the width-128 bf16 forward's C entry (``fn``,
    or this checkout's) for ``entry`` (fold, pe or pregathered) on ``ops``
    (``to_bf16``) as its wrapper does and returns out."""
    fn = fn or cuda_build.function(fe.BF16_W128,
                                   fe._ARGTYPES[fe.BF16_W128_FWD],
                                   symbol=fe.BF16_W128_FWD)
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    n, e, l1 = rowptr.numel() - 1, src.shape[0], tail[0].shape[0]
    part = torch.empty(part_rows(e, fe.FWD_TILE), 128, device=src.device)

    def run():
        out = torch.zeros(n, 128, device=src.device)
        err = fn(src.data_ptr(), fe._ptr(we), fe._ptr(be), fe._ptr(pxj),
                 pxi.data_ptr(), fe._ptr(senders),
                 *(t.data_ptr() for t in (rowptr, *tail, out, part)),
                 n, e, l1, fe.ENTRY[entry],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def runner_pe64_bf16(ops, fn=None):
    """A closure that launches the width-64 bf16 pe forward's C entry
    (``fn``, or this checkout's) on the C-entry operands ``ops``
    (``operands("pe", ...)`` through ``to_bf16``) as its wrapper does and
    returns out."""
    fn = fn or cuda_build.function(fe.BF16, fe._ARGTYPES[fe.BF16_PE_FWD],
                                   symbol=fe.BF16_PE_FWD)
    pe, _, _, pxj, pxi, senders, rowptr, *tail = ops
    n, (e, h), l1 = rowptr.numel() - 1, pe.shape, tail[0].shape[0]
    c = tail[2].shape[1]
    part = torch.empty(part_rows(e, fe.FWD_TILE), c, device=pe.device)

    def run():
        out = torch.zeros(n, c, device=pe.device)
        err = fn(*(t.data_ptr() for t in (pe, pxj, pxi, senders, rowptr,
                                          *tail, out, part)),
                 n, e, h, c, l1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def pregathered_bf16(ops):
    """The pregathered entry's operands (h0, pxi, rowptr, tail...) of
    ``operands("pregathered", ...)``, in the bf16 lane (``to_bf16``)."""
    src, _, _, _, pxi, _, rowptr, *tail = ops
    return to_bf16((src, pxi, rowptr, *tail))


def runner_pregathered_bf16(ops, fn=None):
    """A closure that launches the bf16 pregathered forward's C entry
    (``fn``, or this checkout's) on ``ops`` (``pregathered_bf16``) as its
    wrapper does and returns out."""
    fn = fn or cuda_build.function(fe.BF16, fe._ARGTYPES[fe.BF16_PRE_FWD],
                                   symbol=fe.BF16_PRE_FWD)
    h0, _, rowptr, *tail = ops
    n, e, l1 = rowptr.numel() - 1, h0.shape[0], tail[0].shape[0]
    c = tail[2].shape[1]
    part = torch.empty(part_rows(e, fe.FWD_TILE), c, device=h0.device)

    def run():
        out = torch.zeros(n, c, device=h0.device)
        err = fn(*(t.data_ptr() for t in ops), out.data_ptr(),
                 part.data_ptr(), n, e, h0.shape[1], c, l1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def cuda_ms(fn):
    """Device ms of one call of ``fn``, the mean of ``REPS`` calls between
    CUDA events after three of warm-up.  The device sleeps ``BUSY_CYCLES``
    before the first event while the host enqueues the calls, so that a
    call whose launches take the host longer than the device takes to run
    them is timed by the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(BUSY_CYCLES)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def in_turns(runs, first="baseline", then="this"):
    """Times of ``runs`` ({then: fn, first: fn}) in turns, first, then,
    then, first: (order, ms of each, mean ms of each run)."""
    order = ([first, then, then, first] if first in runs else [then, then])
    times = [cuda_ms(runs[k]) for k in order]
    mean = {k: float(np.mean([t for o, t in zip(order, times) if o == k]))
            for k in runs}
    return order, times, mean


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_fwd: no CUDA device", file=sys.stderr)
        return 1
    args = dict(a.split("=", 1) for a in argv)
    card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.get("dtype") == "bf16" and "baseline" in args:
        return main_bf16_baseline(Path(args["baseline"]), dev)
    fns = libraries(fe.FWD, args)
    if args.get("dtype") == "bf16":
        return main_bf16(fns["this"], dev)
    for label, hp, graph in graphs():
        h = hp["mlp_hidden"]
        ce = c = hp["latent_dim"]
        l1 = hp["mlp_layers"] - 1
        entries = ("fold", "pe", "pregathered") if h == 128 else ("fold",)
        for entry in entries:
            ops = operands(entry, graph, ce, h, c, l1, seed=41, dev=dev)
            src, _, _, pxj, pxi, senders, rowptr, *tail = ops
            if entry == "fold":
                want = fe.fused_edge_tail_agg_plain(*ops)
            elif entry == "pe":
                want = fe.fused_edge_tail_agg_pe_plain(
                    src, pxj, pxi, senders, rowptr, None, None, *tail)
            else:
                want = fe.fused_edge_tail_agg_pregathered_plain(
                    src, pxi, rowptr, *tail)
            runs = {k: runner(fn, entry, ops, (ce, h, c))
                    for k, fn in fns.items()}
            err = {k: float((run() - want).abs().max())
                   for k, run in runs.items()}
            order, times, mean = in_turns(runs)
            macs = (ce * h if entry == "fold" else 0) + l1 * h * h + h * c
            flops = 2.0 * graph.n_edge * macs
            print(json.dumps({
                "kernel": KERNEL_NUMBER[entry], "entry": entry,
                "widths": [ce, h, c] if entry == "fold" else [h, c],
                "shape": label, "n_node": graph.n_node,
                "n_edge": graph.n_edge, "l1": l1, "reps": REPS,
                "order": order, "ms": times, "mean_ms": mean,
                "f32_bound_ms": flops / F32_PEAK * 1e3,
                "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
                "max_abs_err_vs_plain": err,
                "device": torch.cuda.get_device_name(0)}), flush=True)
            del ops, want, runs
    return 0


def main_bf16(fn32, dev) -> int:
    """#8's f32 and bf16 builds in turns at MAgNet[CNN] 1D's graphs and
    2D's eval graph, then #2's at 2D's training graph (both models' GraphNet
    widths are (32, 64, 32), L1 = 3), then #8's and #6's at width 128 at
    MAgNet[GNN]'s graphs."""
    ce = c = MAGNET_CNN["latent_dim"]
    h, l1 = MAGNET_CNN["mlp_hidden"], MAGNET_CNN["mlp_layers"] - 1
    main_graphs = graphs()
    for label, _, graph in main_graphs[:3]:
        ops = operands("fold", graph, ce, h, c, l1, seed=41, dev=dev)
        ops_bf = to_bf16(ops)
        runs = {"f32": runner(fn32, "fold", ops, (ce, h, c)),
                "bf16": runner_bf16(ops_bf)}
        err = {"f32": float((runs["f32"]()
                             - fe.fused_edge_tail_agg_plain(*ops)).abs().max()),
               "bf16": float((runs["bf16"]()
                              - fe.fused_edge_tail_agg_bf16_plain(*ops_bf))
                             .abs().max())}
        order, times, mean = in_turns(runs, first="f32", then="bf16")
        flops = 2.0 * graph.n_edge * (ce * h + l1 * h * h + h * c)
        print(json.dumps({
            "kernel": "#8", "entry": "fold", "widths": [ce, h, c],
            "shape": label, "n_node": graph.n_node, "n_edge": graph.n_edge,
            "l1": l1, "reps": REPS, "order": order, "ms": times,
            "mean_ms": mean, "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
            "bf16_bound_ms": flops / BF16_PEAK * 1e3,
            "max_abs_err_vs_plain": err,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del ops, ops_bf, runs
    graph = cnn_2d_train_graph(32, seed=7)
    ops = operands("pregathered", graph, h, h, c, l1, seed=41, dev=dev)
    ops_bf = pregathered_bf16(ops)
    src, _, _, _, pxi, _, rowptr, *tail = ops
    runs = {"f32": runner(fn32, "pregathered", ops, (h, h, c)),
            "bf16": runner_pregathered_bf16(ops_bf)}
    err = {"f32": float((runs["f32"]()
                         - fe.fused_edge_tail_agg_pregathered_plain(
                             src, pxi, rowptr, *tail)).abs().max()),
           "bf16": float((runs["bf16"]()
                          - fe.fused_edge_tail_agg_pregathered_bf16_plain(
                              *ops_bf)).abs().max())}
    order, times, mean = in_turns(runs, first="f32", then="bf16")
    e, n = graph.n_edge, graph.n_node
    flops = 2.0 * e * (l1 * h * h + h * c)
    nbytes = (2.0 * (e * h + n * h + l1 * (h * h + h) + h * c + c)
              + 4.0 * (n + 1 + 2 * c + n * c))
    print(json.dumps({
        "kernel": "#2", "entry": "pregathered", "widths": [h, c],
        "shape": "cnn_2d_train", "n_node": n, "n_edge": e, "l1": l1,
        "reps": REPS, "order": order, "ms": times, "mean_ms": mean,
        "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
        "bf16_bound_ms": max(flops / BF16_PEAK, nbytes / HBM_RATE) * 1e3,
        "max_abs_err_vs_plain": err,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    del ops, ops_bf, runs
    w, l1 = MAGNET_GNN["mlp_hidden"], MAGNET_GNN["mlp_layers"] - 1
    for label, graph in (("gnn_eval_all", main_graphs[3][2]),
                         ("gnn_train_all", gnn_train_graph())):
        for entry in ("fold", "pe"):
            ops = operands(entry, graph, w, w, w, l1, seed=41, dev=dev)
            ops_bf = to_bf16(ops)
            src, _, _, pxj, pxi, senders, rowptr, *tail = ops_bf
            want = (fe.fused_edge_tail_agg_bf16_plain(*ops_bf)
                    if entry == "fold" else fe.fused_edge_tail_agg_pe_bf16_plain(
                        src, pxj, pxi, senders, rowptr, None, None, *tail))
            want32 = (fe.fused_edge_tail_agg_plain(*ops) if entry == "fold"
                      else fe.fused_edge_tail_agg_pe_plain(
                          ops[0], *ops[3:7], None, None, *ops[7:]))
            runs = {"f32": runner(fn32, entry, ops, (w, w, w)),
                    "bf16": runner_bf16_w128(entry, ops_bf)}
            err = {"f32": float((runs["f32"]() - want32).abs().max()),
                   "bf16": float((runs["bf16"]() - want).abs().max())}
            order, times, mean = in_turns(runs, first="f32", then="bf16")
            macs = (w * w if entry == "fold" else 0) + l1 * w * w + w * w
            flops = 2.0 * graph.n_edge * macs
            print(json.dumps({
                "kernel": KERNEL_NUMBER[entry], "entry": entry,
                "widths": [w, w, w] if entry == "fold" else [w, w],
                "shape": label, "n_node": graph.n_node,
                "n_edge": graph.n_edge, "l1": l1, "reps": REPS,
                "order": order, "ms": times, "mean_ms": mean,
                "tc_bound_ms": 3 * flops / TF32_PEAK * 1e3,
                "bf16_bound_ms": flops / BF16_PEAK * 1e3,
                "max_abs_err_vs_plain": err,
                "device": torch.cuda.get_device_name(0)}), flush=True)
            del ops, ops_bf, runs, want, want32
    return 0


#: the bf16 forward's C entry of each entry at width 64 (width 128: one,
#: BF16_W128_FWD, by entry)
BF16_W64_FWD_SYMBOL = {"fold": fe.BF16_FWD, "pe": fe.BF16_PE_FWD,
                       "pregathered": fe.BF16_PRE_FWD}


def bf16_fwd_functions(lib64, lib128) -> dict:
    """{(width, entry): the bf16 forward's C entry} of the libraries of any
    tree (the same arguments in both)."""
    def bound(lib, symbol):
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = fe._ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        return fn
    out = {(64, e): bound(lib64, s) for e, s in BF16_W64_FWD_SYMBOL.items()}
    w128 = bound(lib128, fe.BF16_W128_FWD)
    out.update({(128, e): w128 for e in BF16_W64_FWD_SYMBOL})
    return out


def bf16_fwd_bound(entry, graph, widths, l1) -> dict:
    """Least time on the card for one bf16 forward call of ``entry``
    (``chip_smoke.py``'s ``bf16_bound``, ``pe_bf16_bound`` and
    ``pregathered_bf16_bound``): 2 E (Ce H (fold) + L1 H^2 + H C)
    operations at the dense bf16 rate, against each input read once and the
    output written once (e0 / pe / h0, the node tables and the weights at
    2 bytes; ln_s, ln_b, the indices and out at 4)."""
    n, e = graph.n_node, graph.n_edge
    ce, h, c = widths
    fold = entry == "fold"
    flops = 2.0 * e * ((ce * h if fold else 0) + l1 * h * h + h * c)
    weights = (ce * h + h if fold else 0) + l1 * (h * h + h) + h * c + c
    tables = 1 if entry == "pregathered" else 2
    ints = 0 if entry == "pregathered" else e
    nbytes = (2.0 * (e * (ce if fold else h) + tables * n * h + weights)
              + 4.0 * (2 * c + ints + n + 1 + n * c))
    t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"bf16_bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def bf16_fwd_cases():
    """(label, width, entries, graph) of the bf16 forwards' main paths:
    MAgNet[CNN] 1D's eval and training graphs and 2D's eval graph (fold and
    pe at width 64), 2D's training graphs of 32 and 8 samples (pre-gathered
    at width 64), MAgNet[GNN]'s eval LR ∪ HR and training graphs (all three
    at width 128)."""
    main_graphs = graphs()
    cases = [(label, 64, ("fold", "pe"), graph)
             for label, _, graph in main_graphs[:3]]
    cases += [("cnn_2d_train_b32", 64, ("pregathered",),
               cnn_2d_train_graph(32, seed=7)),
              ("cnn_2d_train_b8", 64, ("pregathered",),
               cnn_2d_train_graph(8, seed=7))]
    cases += [(label, 128, ("fold", "pe", "pregathered"), graph)
              for label, graph in (("gnn_eval_all", main_graphs[3][2]),
                                   ("gnn_train_all", gnn_train_graph()))]
    return cases


def bf16_fwd_run(entry, width, ops, fn):
    """A closure of the bf16 forward of ``entry`` at ``width`` through the
    C entry ``fn``, on the C-entry operands ``ops`` (``to_bf16``)."""
    if width == 128:
        return runner_bf16_w128(entry, ops, fn)
    if entry == "fold":
        return runner_bf16(ops, fn)
    if entry == "pe":
        return runner_pe64_bf16(ops, fn)
    return runner_pregathered_bf16(pregathered_bf16(ops), fn)


def bf16_fwd_plain(entry, ops):
    """The bf16 plain version of ``entry`` on the C-entry operands ``ops``."""
    src, _, _, pxj, pxi, senders, rowptr, *tail = ops
    if entry == "fold":
        return fe.fused_edge_tail_agg_bf16_plain(*ops)
    if entry == "pe":
        return fe.fused_edge_tail_agg_pe_bf16_plain(
            src, pxj, pxi, senders, rowptr, None, None, *tail)
    return fe.fused_edge_tail_agg_pregathered_bf16_plain(src, pxi, rowptr,
                                                         *tail)


def main_bf16_baseline(baseline: Path, dev) -> int:
    """The bf16 forwards of the tree at ``baseline`` (its ``csrc/``) against
    this checkout's, in turns (baseline, this, this, baseline): #8 and #6 at
    width 64 at MAgNet[CNN] 1D's eval and training graphs and 2D's eval
    graph, #2 at width 64 at 2D's training graphs (32 and 8 samples), #8,
    #6 and #2 at width 128 at MAgNet[GNN]'s eval and training graphs (L1 =
    3 everywhere), each build against the plain version (max abs error),
    with the plain version's time and the bf16 bound; then the MAgNet[CNN]
    and MAgNet[GNN] bf16 eval batches and training steps in turns, the
    forwards through either build."""
    fns = {"baseline": bf16_fwd_functions(
               cuda_build.build(fe.BF16, csrc=baseline),
               cuda_build.build(fe.BF16_W128, csrc=baseline)),
           "this": bf16_fwd_functions(cuda_build.build(fe.BF16),
                                      cuda_build.build(fe.BF16_W128))}
    hps = {64: MAGNET_CNN, 128: MAGNET_GNN}
    for label, width, entries, graph in bf16_fwd_cases():
        hp = hps[width]
        h, l1 = hp["mlp_hidden"], hp["mlp_layers"] - 1
        c = hp["latent_dim"]
        for entry in entries:
            widths = (c, h, c) if entry == "fold" else (h, h, c)
            ops = to_bf16(operands(entry, graph, *widths, l1, seed=41,
                                   dev=dev))
            want = bf16_fwd_plain(entry, ops)
            runs = {k: bf16_fwd_run(entry, width, ops, fn[(width, entry)])
                    for k, fn in fns.items()}
            err = {k: float((run() - want).abs().max())
                   for k, run in runs.items()}
            order, times, mean = in_turns(runs)
            print(json.dumps({
                "kernel": KERNEL_NUMBER[entry], "entry": entry,
                "widths": list(widths) if entry == "fold" else [h, c],
                "shape": label, "n_node": graph.n_node,
                "n_edge": graph.n_edge, "l1": l1, "reps": REPS,
                "order": order, "ms": times, "mean_ms": mean,
                "speedup": mean["baseline"] / mean["this"],
                "baseline": str(baseline),
                "plain_ms": cuda_ms(lambda: bf16_fwd_plain(entry, ops)),
                **bf16_fwd_bound(entry, graph, widths, l1),
                "share_of_bound": bf16_fwd_bound(
                    entry, graph, widths, l1)["bf16_bound_ms"] / mean["this"],
                "max_abs_err_vs_plain": err,
                "device": torch.cuda.get_device_name(0)}), flush=True)
            del ops, runs, want
    end_to_end_in_turns(fns["baseline"], dev)
    return 0


@contextlib.contextmanager
def bf16_forward_of(fns):
    """Inside the block the bf16 forwards' launchers run another tree's C
    entries ``fns`` (``bf16_fwd_functions``: the same arguments): the cached
    C functions are swapped for them."""
    swap = {fe.BF16_FWD: (fe.BF16, fns[(64, "fold")]),
            fe.BF16_PE_FWD: (fe.BF16, fns[(64, "pe")]),
            fe.BF16_PRE_FWD: (fe.BF16, fns[(64, "pregathered")]),
            fe.BF16_W128_FWD: (fe.BF16_W128, fns[(128, "fold")])}
    saved = {}
    for symbol, (name, fn) in swap.items():
        cuda_build.function(name, fe._ARGTYPES[symbol], symbol=symbol)
        saved[symbol] = cuda_build._FUNCTIONS[symbol]
        cuda_build._FUNCTIONS[symbol] = (saved[symbol][0], fn)
    try:
        yield
    finally:
        cuda_build._FUNCTIONS.update(saved)


def end_to_end_cells():
    """(label, model name, hp, lane, datamodule config) of the bf16 lanes
    whose eval batches and training steps run the bf16 forwards: MAgNet[CNN]
    1D on the fold and pe lanes, 2D (eval fold, training pre-gathered),
    MAgNet[GNN] 1D on the fold, pe and pre-gathered lanes, 2D (the
    published 512-node script's training graph, the 32 x 32 eval grid),
    each from the datamodule's synthetic source."""
    one_d = {**DATAMODULE_IMPLICIT, "source": "synthetic_ks", "n_train": 32,
             "n_val": 1, "n_test": 16, "burn_in": 10.0, "data_seed": 0}
    two_d = {**DATAMODULE_IMPLICIT_2D, "source": "synthetic_burgers_2d",
             "n_train": 8, "n_val": 1, "n_test": 4, "batch_size": 8,
             "data_seed": 0}
    gnn = {**DATAMODULE_IMPLICIT_GNN, "source": "synthetic_ks",
           "n_train": 32, "n_val": 1, "n_test": 16, "burn_in": 10.0,
           "data_seed": 0}
    gnn_2d = {**DATAMODULE_IMPLICIT_GNN_2D, "source": "synthetic_burgers_2d",
              "n_train": 8, "n_val": 1, "n_test": 8, "batch_size": 8,
              "res_train": 512, "samples": 256, "data_seed": 0}
    gnn_2d_hp = {**MAGNET_GNN, "time_slice": 10}
    return [("magnet_cnn 1D", "magnet_cnn", MAGNET_CNN, "kernel", one_d),
            ("magnet_cnn 1D", "magnet_cnn", MAGNET_CNN, "kernel_pe", one_d),
            ("magnet_cnn 2D", "magnet_cnn_2d", MAGNET_CNN_2D, "kernel",
             two_d),
            ("magnet_gnn 1D", "magnet_gnn", MAGNET_GNN, "kernel", gnn),
            ("magnet_gnn 1D", "magnet_gnn", MAGNET_GNN, "kernel_pe", gnn),
            ("magnet_gnn 1D", "magnet_gnn", MAGNET_GNN,
             "kernel_pregathered", gnn),
            ("magnet_gnn 2D", "magnet_gnn", gnn_2d_hp, "kernel", gnn_2d)]


def end_to_end_in_turns(baseline_fns, dev, reps=5) -> None:
    """Seconds a bf16 eval batch (``evaluate`` on one test batch) and a bf16
    training step of each ``end_to_end_cells`` cell, the forwards through
    the baseline's build and this one's in turns (baseline, this, this,
    baseline), each the mean of ``reps`` after two of warm-up."""
    from magnet_tpu_torch.data.datamodule import build_loaders
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.train.trainer import Trainer

    loaders = {}
    for label, name, hp, lane, dm in end_to_end_cells():
        key = id(dm)
        if key not in loaders:
            loaders[key] = build_loaders(dm, seed=0)
        batch = next(iter(loaders[key]["train"]))
        test = [next(iter(loaders[key]["test"]))]
        model = create_model(name, {**hp, "graph_dtype": "bf16"}, device=dev,
                             seed=0, kind=dm["kind"])
        model.impl = lane
        with tempfile.TemporaryDirectory() as workdir:
            trainer = Trainer(model, workdir=workdir, device=dev)
            trainer.setup(1)
            for what, fn in (("eval_batch", lambda: evaluate(model, test,
                                                             device=dev)),
                             ("train_step",
                              lambda: trainer.train_step(batch))):
                def run():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) / reps

                with bf16_forward_of(baseline_fns):
                    run()
                run()
                order = ["baseline", "this", "this", "baseline"]
                secs = []
                for k in order:
                    if k == "baseline":
                        with bf16_forward_of(baseline_fns):
                            secs.append(run())
                    else:
                        secs.append(run())
                print(json.dumps({
                    what: f"{label} bf16", "impl": lane,
                    "reps_a_turn": reps, "order": order, "seconds": secs,
                    "mean_s": {k: float(np.mean([t for o, t in zip(order, secs)
                                                 if o == k]))
                               for k in ("baseline", "this")},
                    "device": torch.cuda.get_device_name(0)}), flush=True)
        del model, trainer


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
