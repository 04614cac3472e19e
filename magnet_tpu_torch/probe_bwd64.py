"""Where the time of the width-64 bf16 GraphNet backward goes.

  python -m magnet_tpu_torch.probe_bwd64 [csrc=DIR]

On the card only.  Copies ``csrc/`` (or another tree's ``csrc/`` DIR, a
parent commit unpacked with ``git archive``) into
``_build/probe_bwd64_phases/``, adds ``clock64()`` reads around the parts of
a tile of the backward kernel of ``fused_edge_tail_agg_bf16.cu`` (the
source's own design decides which parts: the one-block walk of
``edge_tail_bwd_kernel`` or the two-warpgroup walk of ``wgmma_bwd_kernel``),
builds the copy and runs each entry once at its main path's graph: the fold
(#9) and pe (#7) entries at a MAgNet[CNN] 1D training batch (67,680 edges),
the pre-gathered entry (#3) at the 2D training graph of 32 samples (299,894
edges).  Per tile, the cycles of each part and the waits at the barriers
are summed by the first thread of two warps of every block (of each
warpgroup) and written past the blocks' partial rows; it prints their mean
a tile over the blocks, then, from the unaltered build under
``torch.profiler``, the device time of each kernel of a call (the walk and
the fixed-order sum of the partial rows, ``reduce_partials_kernel``) and the
walk's active blocks.  The phase build's results are the kernel's; only the
clocks are added.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import sys

import torch

from magnet_tpu_torch.config import MAGNET_CNN, MAGNET_CNN_2D
from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.time_fwd import (
    card,
    cnn_1d_train_graph,
    cnn_2d_train_graph,
    operands,
    to_bf16,
)

NAME = fe.BF16
#: slots a recording thread writes: the phases, the barrier waits, tiles
SLOTS = 16

# ---- the one-block walk of earlier trees (edge_tail_bwd_kernel) ----------
OLD_PHASES = ("h0", "forward", "y_and_g", "layer_norm_bwd",
              "output_layer_bwd", "tail_layers_bwd", "first_layer_bwd",
              "d_pxj_atomics_or_d_src", "d_pxi")
OLD_LOOP = "  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {\n"
OLD_END = ("  tf32x3::cp_async_wait<0>();\n  __syncthreads();  // every tile "
           "is done")
OLD_EDITS = [
    ("    // h_1 .. h_L1\n", "    ph(0);\n    // h_1 .. h_L1\n"),
    ("    // y = h_L1 . W_out + b_out; bf16(g[i])",
     "    ph(1);\n    // y = h_L1 . W_out + b_out; bf16(g[i])"),
    ("    layer_norm_bwd(s_y, s_ls, gv, s_ln);  // dy over y\n",
     "    ph(2);\n    layer_norm_bwd(s_y, s_ls, gv, s_ln);  // dy over y\n"),
    ("    // the output layer: dW_out", "    ph(3);\n    // the output "
     "layer: dW_out"),
    ("    // the tail layers, last to first", "    ph(4);\n    // the tail "
     "layers, last to first"),
    ("    const float* dz = grad(L1 & 1);\n",
     "    ph(5);\n    const float* dz = grad(L1 & 1);\n"),
    ("      for (int k = tid; k < n_valid * kH; k += kThreads) {\n",
     "      ph(6);\n      for (int k = tid; k < n_valid * kH; k += kThreads) "
     "{\n"),
    ("    {  // d_pxi[i] += bf16(dz), a sum a run of equal receivers\n",
     "    ph(7);\n    {  // d_pxi[i] += bf16(dz), a sum a run of equal "
     "receivers\n"),
]


def old_source(text: str, n_sm: int) -> str:
    """The one-block walk with clocks: ph(k) adds the cycles since the last
    mark to part k, every barrier of the tile loop its wait to the barrier
    slot; threads 0 and 511 write their sums past n_sm partial rows."""
    beg = text.index(OLD_LOOP, text.index("edge_tail_bwd_kernel("))
    end = text.index(OLD_END, beg)
    loop = text[beg:end]
    for old, new in OLD_EDITS:
        if loop.count(old) != 1:
            raise RuntimeError(f"probe: {old!r} is not once in the loop")
        loop = loop.replace(old, new)
    loop = loop.replace("__syncthreads();", "PSYNC();")
    n = len(OLD_PHASES)
    head = (
        "  long long ph_sum[16] = {}, ph_t = clock64();\n"
        "  auto ph = [&](int k) { const long long t = clock64(); "
        "ph_sum[k] += t - ph_t; ph_t = t; };\n"
        "#define PSYNC() do { const long long t0_ = clock64(); "
        f"__syncthreads(); ph_sum[{n}] += clock64() - t0_; }} while (0)\n")
    # the last part (d_pxi) ends where the tile does
    loop = loop[:loop.rstrip().rindex("}")] + (
        f"    ph({n - 1});\n    ++ph_sum[15];\n  }}\n")
    tail = (
        "  if (tid == 0 || tid == kThreads - 1) {\n"
        f"    float* dbg = partial + (size_t){n_sm} * L::g_total +"
        f" (blockIdx.x * 2 + (tid != 0)) * {SLOTS};\n"
        f"    for (int k = 0; k < {SLOTS}; ++k) dbg[k] = (float)ph_sum[k];\n"
        "  }\n#undef PSYNC\n")
    return text[:beg] + head + loop + tail + text[end:]


def phase_source(csrc, n_sm: int) -> object:
    """The altered copy's directory."""
    probe_dir = cuda_build._BUILD_DIR / "probe_bwd64_phases"
    shutil.rmtree(probe_dir, ignore_errors=True)
    shutil.copytree(csrc, probe_dir)
    src = probe_dir / f"{NAME}.cu"
    text = src.read_text()
    if "edge_tail_bwd_kernel(" in text:
        text, names, recorders = old_source(text, n_sm), OLD_PHASES, 2
    else:
        text, names, recorders = new_source(text, n_sm)
    src.write_text(text)
    return probe_dir, names, recorders


# ---- the two-warpgroup walk (wgmma_bwd_kernel) ---------------------------
NEW_PHASES = ("prologue", "rows_wait", "h0_and_indices", "stage_next",
              "forward", "y_and_layer_norm", "output_layer_bwd",
              "tail_layers_bwd", "dz", "epilogue")
NEW_EDITS = [
    ("  // the weights by cp.async,",
     "  unsigned ph_sum[16] = {};\n  long long ph_t = clock64();\n"
     "  auto ph = [&](int k) { const long long t = clock64(); "
     "ph_sum[k] += (unsigned)(t - ph_t); ph_t = t; };\n"
     "  // the weights by cp.async,"),
    ("  const int r0 = acc_row0(), c0 = acc_col0();\n  for (int tile = t_beg",
     "  ph(0);\n  const int r0 = acc_row0(), c0 = acc_col0();\n"
     "  for (int tile = t_beg"),
    ("    // h_0: fold bf16(relu(", "    ph(1);\n    // h_0: fold bf16(relu("),
    ("    if (more)  // into the buffers this tile has read\n",
     "    ph(2);\n    if (more)  // into the buffers this tile has read\n"),
    ("    // h_k = bf16(relu(h_{k-1} . W_k + b_k)), k = 1 .. L1",
     "    ph(3);\n    // h_k = bf16(relu(h_{k-1} . W_k + b_k)), k = 1 .. L1"),
    ("    // y = h_L1 . W_out + b_out; LayerNorm's backward in its "
     "accumulators:\n",
     "    ph(4);\n    // y = h_L1 . W_out + b_out; LayerNorm's backward in "
     "its accumulators:\n"),
    ("    // dW_out += h_L1^T . bf16(dy), a group",
     "    ph(5);\n    // dW_out += h_L1^T . bf16(dy), a group"),
    ("    // the tail layers, last to first: dW_k",
     "    ph(6);\n    // the tail layers, last to first: dW_k"),
    ("    // dz = da_0: acc (f32, masked) and bf16(dz) in da(L1 & 1)\n",
     "    ph(7);\n    // dz = da_0: acc (f32, masked) and bf16(dz) in da(L1 "
     "& 1)\n"),
    ("    wg::wait<0>();  // the weight-gradient products: their tiles are "
     "reused\n  }\n",
     "    wg::wait<0>();  // the weight-gradient products: their tiles are "
     "reused\n    ph(8);\n    ++ph_sum[15];\n  }\n"),
]


def new_source(text: str, n_sm: int):
    """The two-warpgroup walk with clocks, 32-bit sums a thread: ph(k) adds
    the cycles since the last mark to part k, the warpgroup's barriers
    their waits to slot 10, the waits for its products to slot 11; the
    first thread of each warpgroup writes its sums past n_sm partial
    rows."""
    kernel = text.index("namespace bwd {")  # the forward shares comments
    head, text = text[:kernel], text[kernel:]
    for old, new in NEW_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"probe: {old!r} is not once in the backward")
        text = text.replace(old, new)
    text = head + text
    beg = text.index("  for (int tile = t_beg, it = 0;",
                     text.index("wgmma_bwd_kernel("))
    end = text.index("  __syncthreads();  // both warpgroups are done", beg)
    loop = text[beg:end].replace(
        "group_sync(grp);",
        "{ const long long t0_ = clock64(); group_sync(grp); "
        "ph_sum[10] += (unsigned)(clock64() - t0_); }").replace(
        "wg::wait<0>();",
        "{ const long long t0_ = clock64(); wg::wait<0>(); "
        "ph_sum[11] += (unsigned)(clock64() - t0_); }").replace(
        "wg::wait<1>();",
        "{ const long long t0_ = clock64(); wg::wait<1>(); "
        "ph_sum[11] += (unsigned)(clock64() - t0_); }")
    text = text[:beg] + loop + text[end:]
    tail = "    p[at] = s;\n  }\n}\n"
    at = text.index(tail, end)
    text = text[:at] + (
        "    p[at] = s;\n  }\n  ph(9);\n"
        "  if ((tid & 127) == 0) {\n"
        f"    float* dbg = partial + (size_t){n_sm} * L::g_total +"
        f" (blockIdx.x * 2 + grp) * {SLOTS};\n"
        f"    for (int k = 0; k < {SLOTS}; ++k) dbg[k] = (float)ph_sum[k];\n"
        "  }\n}\n") + text[at + len(tail):]
    return text, NEW_PHASES, 2


# ---- the runs ----------------------------------------------------------------

def cases():
    """(entry, label, hyperparameters, graph) of each entry's main path."""
    one_d = cnn_1d_train_graph()
    return [("fold", "cnn_1d_train", MAGNET_CNN, one_d),
            ("pe", "cnn_1d_train", MAGNET_CNN, one_d),
            ("pregathered", "cnn_2d_train_b32", MAGNET_CNN_2D,
             cnn_2d_train_graph(32, seed=7))]


SYMBOL = {"fold": fe.BF16_BWD, "pe": fe.BF16_PE_BWD,
          "pregathered": fe.BF16_PRE_BWD}


def bind(lib, entry):
    fn = getattr(ctypes.CDLL(str(lib)), SYMBOL[entry])
    fn.argtypes = fe._ARGTYPES[SYMBOL[entry]]
    fn.restype = ctypes.c_int
    return fn


def caller(fn, entry, ops, g, extra):
    """A closure that calls the C entry ``fn`` of ``entry`` on the C-entry
    operands ``ops`` (``to_bf16``) and g as its launcher does, with
    ``extra`` floats past the blocks' partial rows; returns the partial
    buffer."""
    src, we, be, pxj, pxi, senders, rowptr, *tail = ops
    n, (e, w) = rowptr.numel() - 1, src.shape
    h, l1, c = pxi.shape[1], tail[0].shape[0], tail[2].shape[1]
    dev = src.device
    total = (w * h + h if entry == "fold" else 0) + l1 * (h * h + h) \
        + h * c + 3 * c
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.zeros(blocks * total + extra, device=dev)
    wgrad = torch.empty(total, device=dev)
    d_src = torch.empty_like(src)
    d_nodes = torch.zeros(2, n, h, device=dev)
    dz = torch.empty(e, h, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (rowptr, *tail[:5], g, d_src)]

    def run():
        if entry == "fold":
            err = fn(src.data_ptr(), we.data_ptr(), be.data_ptr(),
                     pxj.data_ptr(), pxi.data_ptr(), senders.data_ptr(),
                     *ptrs, d_nodes[0].data_ptr(), d_nodes[1].data_ptr(),
                     wgrad.data_ptr(), partial.data_ptr(), n, e, w, h, c, l1,
                     blocks, stream)
        elif entry == "pe":
            err = fn(src.data_ptr(), pxj.data_ptr(), pxi.data_ptr(),
                     senders.data_ptr(), *ptrs, dz.data_ptr(),
                     d_nodes[1].data_ptr(), wgrad.data_ptr(),
                     partial.data_ptr(), n, e, h, c, l1, blocks, stream)
        else:
            err = fn(src.data_ptr(), pxi.data_ptr(), *ptrs,
                     d_nodes[1].data_ptr(), wgrad.data_ptr(),
                     partial.data_ptr(), n, e, h, c, l1, blocks, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return partial, total, blocks
    return run


def kernel_times(fn, entry, ops, g) -> dict:
    """Device ms of each kernel of one call (the mean of five calls under
    torch.profiler), by the kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    run = caller(fn, entry, ops, g, 0)
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_bwd64: no CUDA device", file=sys.stderr)
        return 1
    args = dict(a.split("=", 1) for a in argv)
    card()
    from pathlib import Path

    csrc = Path(args["csrc"]) if "csrc" in args else cuda_build._CSRC
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    probe_dir, names, recorders = phase_source(csrc, n_sm)
    lib = cuda_build.build(NAME, csrc=probe_dir)
    plain_lib = cuda_build.build(NAME, csrc=csrc)
    ptxas = (cuda_build._BUILD_DIR / f"{plain_lib.stem}.ptxas.txt")
    for entry, label, hp, graph in cases():
        h, c = hp["mlp_hidden"], hp["latent_dim"]
        ce = c if entry == "fold" else h
        l1 = hp["mlp_layers"] - 1
        ops = to_bf16(operands(entry, graph, ce, h, c, l1, seed=43, dev=dev))
        g = torch.randn(graph.n_node, c,
                        generator=torch.Generator().manual_seed(44)).to(dev)
        extra = n_sm * recorders * SLOTS
        partial, total, blocks = caller(bind(lib, entry), entry, ops, g,
                                        extra)()
        torch.cuda.synchronize()
        dbg = partial[blocks * total:].view(n_sm, recorders, SLOTS)
        # blocks that walked a tile (a block's debug row is written by every
        # block the grid launched)
        tiles = dbg[..., 15]
        live = tiles > 0
        per_tile = {}
        for r in range(recorders):
            rows = dbg[:, r][live[:, r]]
            t = rows[:, 15:16]
            mean = (rows / t).mean(0).tolist()
            waits = ({"barrier_wait": mean[len(names)]}
                     if names is OLD_PHASES else
                     {"barrier_wait": mean[10], "product_wait": mean[11],
                      "prologue_per_block": float(rows[:, 0].mean()),
                      "epilogue_per_block": float(rows[:, 9].mean())})
            per_tile[f"recorder_{r}"] = {
                **dict(zip(names, mean[:len(names)])), **waits,
                "blocks": int(live[:, r].sum()),
                "tiles_a_block": float(t.mean())}
        print(json.dumps({
            "entry": entry, "kernel": {"fold": "#9", "pe": "#7",
                                       "pregathered": "#3"}[entry],
            "shape": label, "n_edge": graph.n_edge, "l1": l1,
            "n_tiles": -(-graph.n_edge // 64),
            "cycles_a_tile": per_tile,
            "kernel_ms": kernel_times(bind(plain_lib, entry), entry, ops, g),
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del ops, g
    print(ptxas.read_text() if ptxas.exists() else "no ptxas report",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
