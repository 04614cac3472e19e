"""Where the time of the width-128 bf16 GraphNet backward goes.

  python -m magnet_tpu_torch.probe_bwd128

On the card only.  Copies ``csrc/`` into ``_build/probe_bwd128_<name>/``
once per probe, removes one part of the cluster pipeline of
``fused_edge_tail_agg_bf16_w128.cu`` from the copy, builds every library in
parallel, and times each against the unaltered build at MAgNet[GNN]'s 1D
training graph (67,572 edges) with CUDA events, in turns: kernel, probe,
probe, kernel, for the fold and the pre-gathered entries.  A probe's
results are wrong by design; only its time is read.  The probes:

  * ``local_stores``: every store into another CTA's shared memory lands
    in the CTA's own (``mapa`` replaced by the local address): the cost of
    the distributed shared-memory traffic;
  * ``no_cluster_barrier``: as ``local_stores``, and the step's cluster
    barrier a block barrier: the cost of the lockstep (the wait for the
    slowest CTA of the cluster and the barrier itself);
  * ``no_backward_products``: no weight-gradient and no data-gradient
    product (the forward's product alone a step);
  * ``no_layer_norm``: the output CTA skips LayerNorm's backward (bf16(y)
    for bf16(dy));
  * ``no_scatter``: the first CTA adds nothing into d_pxi and d_pxj;
  * ``no_first_staging``: the first CTA stages no rows for its next step
    (e0, the node rows, the pre-gathered entry's pxi rows);
  * ``no_g_staging``: the output CTA stages no g rows;
  * ``no_d_src_stores``: the first CTA writes no d_src.

Prints the card's name and power limit, then one JSON line per entry and
probe: both times and the probe's saving.

  python -m magnet_tpu_torch.probe_bwd128 phases

builds one more copy, unaltered but for clock64() reads around the parts of
a step (its preparation, the forward, the backward, the next tile's
indices, the cluster barrier), summed over the steps by threads 0 and 255
of every CTA and written past the clusters' partial rows, and prints the
mean cycles a step of each part for each CTA of a cluster (CTA 0 the first,
the last the output CTA), fold and pre-gathered.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from magnet_tpu_torch.config import MAGNET_GNN
from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.time_bwd import runner_bf16_w128_bwd
from magnet_tpu_torch.time_fwd import (
    REPS,
    cuda_ms,
    gnn_train_graph,
    operands,
    to_bf16,
)

NAME = fe.BF16_W128
MAPA = "mapa.shared::cluster.u32 %0, %1, %2;\\n"
CLUSTER_SYNC = ('"barrier.cluster.arrive.release.aligned;\\n"\n'
                '      "barrier.cluster.wait.acquire.aligned;\\n" '
                '::: "memory");')
LN = re.compile(r"// LayerNorm's row statistics.*?__syncthreads\(\);  "
                r"// bf16\(dy\) written", re.S)
LN_PROBE = """{
          const int col = tid & (kW - 1);
          for (int e = 0; e < kTE; ++e)
            s_in[e * kLd + col] = __float2bfloat16_rn(s_y[e * kLdF + col]);
        }
        __syncthreads();"""
PROBES = {
    "local_stores": [(MAPA, "mov.u32 %0, %1;\\n")],
    "no_cluster_barrier": [(MAPA, "mov.u32 %0, %1;\\n"),
                           (CLUSTER_SYNC, '"" ::: "memory");\n'
                            "  __syncthreads();")],
    "no_backward_products": [("wgrad_tile(dw, x, d);", ""),
                             ("mm_tile<kW, true>(acc, d, s_w);", "")],
    "no_layer_norm": [(LN, LN_PROBE)],
    "no_scatter": [("scatter(d, tb, nv);", "")],
    "no_first_staging": [
        ("    if (tf >= 0 && tf + 1 < cnt) stage_forward(tf + 1);\n"
         "    if (FOLD && first && tb + 1 >= 0 && tb + 1 < cnt)\n"
         "      stage(e0_bwd(tb + 1), tb + 1);",
         "    if (out && tf >= 0 && tf + 1 < cnt) stage_g(tf + 1);"),
        ("      if (first && E == kPregathered && tf + 1 < cnt)\n"
         "        stage_nodes(s_stage, a.pxi, rcv_of(tf + 1), tf + 1);", "")],
    "no_g_staging": [("    if (out) stage_g(t);\n", "")],
    "no_d_src_stores": [
        ("            *reinterpret_cast<uint32_t*>(a.d_src + (base + r) * "
         "kW + col) =\n                pack_rn(v0, v1);",
         "            (void)v0;"),
        ("              *reinterpret_cast<uint4*>(a.d_src + (base + r) * kW + "
         "col) =\n                  *reinterpret_cast<const uint4*>(d + r * "
         "kLd + col);", "              (void)col;")],
}


def probe_source(name, edits) -> object:
    """The altered copy's directory for probe ``name``."""
    probe_dir = cuda_build._BUILD_DIR / f"probe_bwd128_{name}"
    shutil.rmtree(probe_dir, ignore_errors=True)
    shutil.copytree(cuda_build._CSRC, probe_dir)
    src = probe_dir / f"{NAME}.cu"
    text = src.read_text()
    for old, new in edits:
        if isinstance(old, re.Pattern):
            text, count = old.subn(lambda _: new, text)
        else:
            count = text.count(old)
            text = text.replace(old, new)
        if count == 0:
            raise RuntimeError(f"probe {name}: {old!r} is not in {NAME}.cu")
    src.write_text(text)
    return probe_dir


# the parts of a step, and where each ends in the kernel's step loop
PHASES = ("prepare", "forward_product", "layer_norm_stats", "forward_rest",
          "backward", "indices", "barrier")
PHASE_EDITS = [
    ("  for (int s = 0; s < n_steps; ++s) {\n    const int tf = s - p, "
     "tb = s - (lag - p);",
     "  unsigned long long ph_sum[7] = {}, ph_t = clock64();\n"
     "  auto ph = [&](int k) { const unsigned long long t = clock64(); "
     "ph_sum[k] += t - ph_t; ph_t = t; };\n"
     "  for (int s = 0; s < n_steps; ++s) {\n    const int tf = s - p, "
     "tb = s - (lag - p);"),
    ("    // ---- the forward of tile tf\n",
     "    ph(0);\n    // ---- the forward of tile tf\n"),
    ("      mm_tile<kW, false>(acc, FOLD && first ? e0_fwd(tf) : ring(tf), "
     "s_w);\n",
     "      mm_tile<kW, false>(acc, FOLD && first ? e0_fwd(tf) : ring(tf), "
     "s_w);\n      ph(1);\n"),
    ("        __syncthreads();\n        // dy = rstd (dx - m1 - xhat m2)",
     "        __syncthreads();\n        ph(2);\n"
     "        // dy = rstd (dx - m1 - xhat m2)"),
    ("    // ---- the backward of tile tb\n",
     "    ph(3);\n    // ---- the backward of tile tb\n"),
    ("    if (next_idx)\n      next.finish",
     "    ph(4);\n    if (next_idx)\n      next.finish"),
    ("    cluster_sync();\n  }\n",
     "    ph(5);\n    cluster_sync();\n    ph(6);\n  }\n"
     "  if (tid == 0 || tid == kThreads - 1) {\n"
     "    float* dbg = a.partial + (size_t)(gridDim.x / n) * a.total +"
     " (blockIdx.x * 2 + (tid != 0)) * 8;\n"
     "    for (int k = 0; k < 7; ++k) dbg[k] = (float)ph_sum[k];\n"
     "    dbg[7] = (float)n_steps;\n  }\n"),
]


def phases(dev) -> int:
    """The mean cycles a step of each part, per CTA of a cluster."""
    import ctypes

    probe_dir = probe_source("phases", PHASE_EDITS)
    lib = ctypes.CDLL(str(cuda_build.build(NAME, csrc=probe_dir)))
    fn = getattr(lib, fe.BF16_W128_BWD)
    fn.argtypes = fe._ARGTYPES[fe.BF16_W128_BWD]
    fn.restype = ctypes.c_int
    clusters = lib.fused_edge_tail_agg_bf16_w128_bwd_clusters
    clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p]
    graph = gnn_train_graph()
    w, l1 = MAGNET_GNN["mlp_hidden"], MAGNET_GNN["mlp_layers"] - 1
    g = torch.randn(graph.n_node, w,
                    generator=torch.Generator().manual_seed(44)).to(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for entry in ("fold", "pregathered"):
        ops = to_bf16(operands(entry, graph, w, w, w, l1, seed=43, dev=dev))
        ctas, nc = ctypes.c_int(), ctypes.c_int()
        clusters(fe.ENTRY[entry], l1, ctypes.addressof(ctas),
                 ctypes.addressof(nc))
        n, n_tiles = ctas.value, -(-graph.n_edge // 64)
        nc = min(nc.value, n_tiles, n_sm)
        total = n * w * w + (n + 2) * w
        src, we, be, pxj, pxi, senders, rowptr, *tail = ops
        partial = torch.zeros(nc * total + n * nc * 16 + 64, device=dev)
        d_src = torch.empty_like(src)
        d_nodes = torch.zeros(2, graph.n_node, w, device=dev)
        wgrad = torch.empty(total, device=dev)
        for _ in range(2):
            err = fn(src.data_ptr(), fe._ptr(we), fe._ptr(be), fe._ptr(pxj),
                     pxi.data_ptr(), fe._ptr(senders),
                     *(t.data_ptr() for t in (rowptr, *tail[:5], g, d_src)),
                     None, d_nodes[0].data_ptr(), d_nodes[1].data_ptr(),
                     wgrad.data_ptr(), partial.data_ptr(), None,
                     graph.n_node, graph.n_edge, l1, fe.ENTRY[entry], n_sm,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        torch.cuda.synchronize()
        dbg = partial[nc * total:nc * total + n * nc * 16].view(nc, n, 2, 8)
        steps = dbg[..., 7:8].clamp_min(1)
        per_step = (dbg[..., :7] / steps).mean(0).cpu()  # (n, 2, 7)
        for p in range(n):
            print(json.dumps({
                "entry": entry, "cta": p, "ctas": n, "clusters": nc,
                "steps": float(dbg[0, p, 0, 7]),
                "cycles_a_step": {
                    f"thread_{t}": dict(zip(PHASES, per_step[p, i].tolist()))
                    for i, t in enumerate((0, 255))},
                "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def bind(lib):
    import ctypes

    fn = getattr(ctypes.CDLL(str(lib)), fe.BF16_W128_BWD)
    fn.argtypes = fe._ARGTYPES[fe.BF16_W128_BWD]
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_bwd128: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if argv[:1] == ["phases"]:
        return phases(torch.device("cuda"))
    dirs = {name: probe_source(name, edits) for name, edits in PROBES.items()}
    with ThreadPoolExecutor(max_workers=len(dirs) + 1) as pool:
        kernel = pool.submit(cuda_build.build, NAME)
        probes = {name: pool.submit(cuda_build.build, NAME, d)
                  for name, d in dirs.items()}
        kernel = bind(kernel.result())
        probes = {name: bind(f.result()) for name, f in probes.items()}
    dev = torch.device("cuda")
    graph = gnn_train_graph()
    w, l1 = MAGNET_GNN["mlp_hidden"], MAGNET_GNN["mlp_layers"] - 1
    g = torch.randn(graph.n_node, w,
                    generator=torch.Generator().manual_seed(44)).to(dev)
    for entry in ("fold", "pregathered"):
        ops = to_bf16(operands(entry, graph, w, w, w, l1, seed=43, dev=dev))
        run = runner_bf16_w128_bwd(kernel, entry, ops, g)
        for name, fn in probes.items():
            probe = runner_bf16_w128_bwd(fn, entry, ops, g)
            order = ["kernel", "probe", "probe", "kernel"]
            times = [cuda_ms(run if k == "kernel" else probe) for k in order]
            mean = {k: sum(t for o, t in zip(order, times) if o == k) / 2
                    for k in ("kernel", "probe")}
            print(json.dumps({
                "entry": entry, "probe": name, "n_edge": graph.n_edge,
                "l1": l1, "reps": REPS, "order": order, "ms": times,
                "mean_ms": mean,
                "saving_ms": mean["kernel"] - mean["probe"],
                "device": torch.cuda.get_device_name(0)}), flush=True)
        del ops
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
