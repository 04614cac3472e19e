"""Where the time of the bf16 GraphNet forwards goes (both widths).

  python -m magnet_tpu_torch.probe_fwd_bf16 [csrc=DIR]

On the card only.  Copies ``csrc/`` (or DIR) into
``_build/probe_fwd_bf16_phases/``, adds ``clock64()`` reads around the parts
of a tile of ``fwd::wgmma_fwd_kernel`` in ``fused_edge_tail_agg_bf16.cu``
(width 64) and ``fused_edge_tail_agg_bf16_w128.cu`` (width 128), builds the
copies and runs each entry once at its main path's graph: at width 64 the
fold (#8) and pe (#6) entries at MAgNet[CNN] 1D's eval and training graphs
and the pre-gathered entry (#2) at the 2D training graph of 32 samples; at
width 128 all three at MAgNet[GNN]'s eval LR ∪ HR graph.  The first thread
of each warpgroup sums, over its tiles, the cycles of each part, of its
waits at the warpgroup's barriers and of its waits for its products, and
writes them past the partial rows; it prints their mean a tile over the
warpgroups that walked one, the prologue (weights and first rows) a
warpgroup, then, from the unaltered build under ``torch.profiler``, the
device time of each kernel of a call (the walk and the partial rows' sum,
``cross_tile_sum_kernel``).  Only the clocks are added.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

import torch

from magnet_tpu_torch.config import MAGNET_CNN, MAGNET_CNN_2D, MAGNET_GNN
from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.ops.graph import part_rows
from magnet_tpu_torch.time_fwd import (
    BF16_W64_FWD_SYMBOL,
    card,
    cnn_1d_train_graph,
    cnn_2d_train_graph,
    graphs,
    operands,
    pregathered_bf16,
    to_bf16,
)

#: slots a recording thread writes: the parts, the waits, its tiles
SLOTS = 16
PARTS = ("prologue", "rows_wait_and_index_issue", "h0_and_first_product",
         "next_indices_and_staging", "tail_layers", "y_and_layer_norm",
         "receiver_sums")
BARRIER, PRODUCT, TILES = 10, 11, 15


def phase_source(text: str, width: int) -> str:
    """The forward kernel of a source with clocks: ph(k) adds the cycles
    since the last mark to part k; the warpgroup's barriers their waits to
    slot 10, the product waits to slot 11; thread 0 of each warpgroup
    writes its sums past the partial rows."""
    beg = text.index("wgmma_fwd_kernel(")
    end = text.index("// kernels the last call launched", beg)
    body = text[beg:end]
    commit = ("      tf32x3::cp_async_commit();\n    };\n" if width == 64
              else "      cp_async_commit();\n    };\n")
    edits = [
        ("  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127, "
         "w = t >> 5;\n",
         "  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127, "
         "w = t >> 5;\n  unsigned ph_sum[16] = {};\n"
         "  long long ph_t = clock64();\n"
         "  auto ph = [&](int k) { const long long t_ = clock64(); "
         "ph_sum[k] += (unsigned)(t_ - ph_t); ph_t = t_; };\n"),
        ("  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {\n",
         "  ph(0);\n"
         "  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {\n"),
        (commit, commit + "    ph(1);\n"),
        ("if (k == 1) advance();",
         "if (k == 1) { ph(2); advance(); ph(3); }"),
        ("if (l1 == 0) advance();",
         "if (l1 == 0) { ph(2); advance(); ph(3); }"),
        ("    // y = h_L1 . W_out + b_out; LayerNorm in the accumulators",
         "    ph(4);\n    // y = h_L1 . W_out + b_out; LayerNorm in the "
         "accumulators"),
        ("    group_sync(grp);  // bf16(y) written\n",
         "    ph(5);\n    group_sync(grp);  // bf16(y) written\n"),
    ]
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f"probe: {old!r} is not once in the kernel")
        body = body.replace(old, new)
    body = body.replace(
        "group_sync(grp);",
        "{ const long long t0_ = clock64(); group_sync(grp); "
        f"ph_sum[{BARRIER}] += (unsigned)(clock64() - t0_); }}").replace(
        "wg::wait<0>();",
        "{ const long long t0_ = clock64(); wg::wait<0>(); "
        f"ph_sum[{PRODUCT}] += (unsigned)(clock64() - t0_); }}")
    c = "kC" if width == 64 else "kW"
    tail = body.rindex("  }\n}\n")
    body = body[:tail] + (
        f"    ph(6);\n    ++ph_sum[{TILES}];\n  }}\n"
        "  if (t == 0) {\n"
        f"    float* dbg = part + (size_t)2 * n_tiles * {c} + "
        f"(blockIdx.x * 2 + grp) * {SLOTS};\n"
        f"    for (int k = 0; k < {SLOTS}; ++k) dbg[k] = (float)ph_sum[k];\n"
        "  }\n}\n") + body[tail + len("  }\n}\n"):]
    return text[:beg] + body + text[end:]


def probe_libraries(csrc: Path) -> dict:
    """{width: the altered copy's library}."""
    probe_dir = cuda_build._BUILD_DIR / "probe_fwd_bf16_phases"
    shutil.rmtree(probe_dir, ignore_errors=True)
    shutil.copytree(csrc, probe_dir)
    for width, name in ((64, fe.BF16), (128, fe.BF16_W128)):
        src = probe_dir / f"{name}.cu"
        src.write_text(phase_source(src.read_text(), width))
    return {64: cuda_build.build(fe.BF16, csrc=probe_dir),
            128: cuda_build.build(fe.BF16_W128, csrc=probe_dir)}


def bind(lib, width, entry):
    symbol = fe.BF16_W128_FWD if width == 128 else BF16_W64_FWD_SYMBOL[entry]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = fe._ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def caller(fn, width, entry, ops, extra):
    """A closure that calls the bf16 forward's C entry ``fn`` on the C-entry
    operands ``ops`` (``to_bf16``) with ``extra`` floats past the partial
    rows; returns (out, part, the partial rows' floats)."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    n, e, l1 = rowptr.numel() - 1, src.shape[0], tail[0].shape[0]
    h, c = pxi.shape[1], tail[2].shape[1]
    rows = part_rows(e, fe.FWD_TILE) * c
    part = torch.zeros(rows + extra, device=src.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.zeros(n, c, device=src.device)
        tail_p = [t.data_ptr() for t in (rowptr, *tail, out, part)]
        if width == 128:
            err = fn(src.data_ptr(), fe._ptr(we), fe._ptr(be), fe._ptr(pxj),
                     pxi.data_ptr(), fe._ptr(senders), *tail_p, n, e, l1,
                     fe.ENTRY[entry], stream)
        elif entry == "fold":
            err = fn(src.data_ptr(), we.data_ptr(), be.data_ptr(),
                     pxj.data_ptr(), pxi.data_ptr(), senders.data_ptr(),
                     *tail_p, n, e, src.shape[1], h, c, l1, stream)
        elif entry == "pe":
            err = fn(src.data_ptr(), pxj.data_ptr(), pxi.data_ptr(),
                     senders.data_ptr(), *tail_p, n, e, h, c, l1, stream)
        else:
            err = fn(src.data_ptr(), pxi.data_ptr(), *tail_p, n, e, h, c, l1,
                     stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out, part, rows
    return run


def kernel_times(run) -> dict:
    """Device ms of each kernel of one call (the mean of five calls under
    torch.profiler), by the kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                "(anonymous namespace)::" in ev.name:
            key = re.sub(r"\(anonymous namespace\)::", "", ev.name)[:60]
            us = getattr(ev, "device_time", None)
            if us is None:
                us = ev.cuda_time
            times[key] = times.get(key, 0.0) + us / 5e3
    return times


def cases():
    """(width, entry, label, hyperparameters, graph) of each main path."""
    main = graphs()
    eval_1d, eval_gnn = main[0][2], main[3][2]
    train_1d = cnn_1d_train_graph()
    out = [(64, e, label, MAGNET_CNN, g) for e in ("fold", "pe")
           for label, g in (("cnn_1d_eval", eval_1d),
                            ("cnn_1d_train", train_1d))]
    out.append((64, "pregathered", "cnn_2d_train_b32", MAGNET_CNN_2D,
                cnn_2d_train_graph(32, seed=7)))
    out += [(128, e, "gnn_eval_all", MAGNET_GNN, eval_gnn)
            for e in ("fold", "pe", "pregathered")]
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_fwd_bf16: no CUDA device", file=sys.stderr)
        return 1
    args = dict(a.split("=", 1) for a in argv)
    card()
    csrc = Path(args["csrc"]) if "csrc" in args else cuda_build._CSRC
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    probes = probe_libraries(csrc)
    plain = {64: cuda_build.build(fe.BF16, csrc=csrc),
             128: cuda_build.build(fe.BF16_W128, csrc=csrc)}
    for width, entry, label, hp, graph in cases():
        h, c = hp["mlp_hidden"], hp["latent_dim"]
        l1 = hp["mlp_layers"] - 1
        ops = to_bf16(operands(entry, graph, c if entry == "fold" else h, h,
                               c, l1, seed=45, dev=dev))
        if width == 64 and entry == "pregathered":
            h0, pxi, rowptr, *tail = pregathered_bf16(ops)
            ops = (h0, None, None, None, pxi, None, rowptr, *tail)
        extra = 4 * n_sm * 2 * SLOTS  # room for four blocks an SM
        _, part, rows = caller(bind(probes[width], width, entry), width,
                               entry, ops, extra)()
        torch.cuda.synchronize()
        dbg = part[rows:].view(-1, SLOTS)
        live = dbg[dbg[:, TILES] > 0]
        tiles = live[:, TILES:TILES + 1]
        mean = (live / tiles).mean(0).tolist()
        print(json.dumps({
            "width": width, "entry": entry,
            "kernel": {"fold": "#8", "pe": "#6", "pregathered": "#2"}[entry],
            "shape": label, "n_edge": graph.n_edge, "l1": l1,
            "n_tiles": -(-graph.n_edge // fe.FWD_TILE),
            "warpgroups_walking": int(live.shape[0]),
            "tiles_a_warpgroup": float(tiles.mean()),
            "cycles_a_tile": {
                **dict(zip(PARTS[1:], mean[1:len(PARTS)])),
                "barrier_wait": mean[BARRIER], "product_wait": mean[PRODUCT],
                "a_tile": sum(mean[1:len(PARTS)])},
            "prologue_cycles_a_warpgroup": float(live[:, 0].mean()),
            "kernel_ms": kernel_times(caller(bind(plain[width], width,
                                                  entry), width, entry, ops,
                                             0)),
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del ops
    for width, lib in plain.items():
        report = cuda_build._BUILD_DIR / f"{lib.stem}.ptxas.txt"
        print(width, report.read_text() if report.exists() else "no ptxas",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
