#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout, holds it against its plain
PyTorch version at the slice's shapes, drives the MAgNet[CNN] 1D eval
rollout at full width through ``magnet_tpu_torch.eval.evaluate`` and checks
that it went through the kernel.  Prints one JSON line per phase, the
card's name and power limit, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero, and
with no CUDA device it exits 1 before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_PEAK = 67e12    # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
# kernel vs plain at one call: f32 on both sides, the matmuls and the
# ~30-edge receiver sums of LayerNorm outputs (|y| ~ 1) taken in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# the whole rollout: 15 autoregressive windows of 10 steps carry those
# differences forward
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(got, want, rtol, atol) -> dict:
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-30)).max()),
        "rtol": rtol, "atol": atol,
        "ok": bool((err <= atol + rtol * want.abs()).all()),
    }


def kernel_operands(graph, ce, h, c, l1, seed, dev):
    g = torch.Generator().manual_seed(seed)

    def f(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    n, e = graph.n_node, graph.n_edge
    return (f(e, ce), f(ce, h), f(h), f(n, h), f(n, h),
            graph.senders.to(dev), graph.rowptr.to(dev), f(l1, h, h),
            f(l1, h), f(h, c), f(c), 1 + f(c, scale=0.1), f(c, scale=0.1))


def bound(graph, ce, h, c, l1) -> dict:
    """Least time on the card for one call: 2·(multiply-adds of the four
    matrix products) over the f32 peak, and each input read once plus the
    output written once over the HBM rate."""
    n, e = graph.n_node, graph.n_edge
    flops = 2.0 * e * (ce * h + l1 * h * h + h * c)
    weights = ce * h + h + l1 * (h * h + h) + h * c + 3 * c
    nbytes = 4.0 * (e * ce + e + (n + 1) + 2 * n * h + weights + n * c)
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from magnet_tpu_torch.config import HEAT_TEST, MAGNET_CNN
    from magnet_tpu_torch.data.heat import heat_batches
    from magnet_tpu_torch.eval import evaluate
    from magnet_tpu_torch.models.factory import create_model
    from magnet_tpu_torch.ops import fused_edge as fe
    from magnet_tpu_torch.ops.graph import csr_from_edges, radius_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": "off (matmul and cudnn)"})

    # 2. build
    t0 = time.perf_counter()
    lib = fe.build()
    ptxas = lib.parent / f"{lib.stem}.ptxas.txt"
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name,
          "ptxas": [ln.strip() for ln in ptxas.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernel vs plain at the slice's shapes: B=16 LR∪HR graphs flattened
    hp = dict(MAGNET_CNN)
    batches = heat_batches(16, 16, nt=HEAT_TEST["nt"], nx=HEAT_TEST["nx"])
    model = create_model("magnet_cnn", hp, device=dev, seed=0)
    graph = model.build_graph(
        {k: torch.as_tensor(v) for k, v in batches[0].items()})
    ce, h, c = hp["latent_dim"], hp["mlp_hidden"], hp["latent_dim"]
    l1 = hp["mlp_layers"] - 1
    ops = kernel_operands(graph, ce, h, c, l1, seed=1, dev=dev)
    got = fe.fused_edge_tail_agg(*ops)
    torch.cuda.synchronize()
    want = fe.fused_edge_tail_agg_plain(*ops)
    big = compare(got, want, KERNEL_RTOL, KERNEL_ATOL)
    # a small graph with a node of degree 0 (isolated, no self loop) and
    # receivers of up to 64 edges (two 32-edge rounds of a warp), with one
    # tail layer: the L1=3 launches timed after it check that a launch
    # for another L1 leaves the kernel's shared-memory opt-in large enough
    pos = np.linspace(-1, 1, 200, dtype=np.float32)[:, None]
    pos[17, 0] = 9.0
    s, r = radius_graph(torch.from_numpy(pos), 0.4, loop=False,
                        max_num_neighbors=64)
    small_graph = csr_from_edges(s, r, 200)
    ops_s = kernel_operands(small_graph, ce, h, c, 1, seed=2, dev=dev)
    got_s = fe.fused_edge_tail_agg(*ops_s)
    want_s = fe.fused_edge_tail_agg_plain(*ops_s)
    small = compare(got_s, want_s, KERNEL_RTOL, KERNEL_ATOL)
    small["degree0_row_zero"] = bool((got_s[17] == 0).all())
    small["max_degree"] = int(small_graph.degree.max())
    small["l1"] = 1
    ms = cuda_ms(lambda: fe.fused_edge_tail_agg(*ops), reps=50)
    plain_ms = cuda_ms(lambda: fe.fused_edge_tail_agg_plain(*ops), reps=20)
    bnd = bound(graph, ce, h, c, l1)
    kernel_ok = big["ok"] and small["ok"] and small["degree0_row_zero"]
    emit({"phase": "kernel", "n_node": graph.n_node, "n_edge": graph.n_edge,
          "ce": ce, "h": h, "c": c, "l1": l1, "slice_shape": big,
          "small_case": small, "ms": ms, "plain_ms": plain_ms,
          "library_ms": None, **bnd, "ok": kernel_ok})
    if not kernel_ok:
        return 2

    # 4. the slice: evaluate() at full width on 16 Heat trajectories
    fe.launches = 0
    t0 = time.perf_counter()
    metrics, preds = evaluate(model, batches, dev, return_predictions=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fe.launches
    want_launches = 150 * len(batches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    evaluate(model, batches, dev)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model.impl = "plain"
    t0 = time.perf_counter()
    metrics_plain, preds_plain = evaluate(model, batches, dev,
                                          return_predictions=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    model.impl = "kernel"
    cmp = compare(torch.cat(preds), torch.cat(preds_plain), SLICE_RTOL,
                  SLICE_ATOL)
    finite = all(bool(torch.isfinite(p).all()) for p in preds) and all(
        np.isfinite(v) for v in metrics.values())
    shape_ok = all(tuple(p.shape) == (b["hr_points"].shape[0], 240, 256, 1)
                   for p, b in zip(preds, batches))
    slice_ok = (launches == want_launches and finite and shape_ok
                and cmp["ok"])
    emit({"phase": "slice", "batches": len(batches), "batch_size": 16,
          "nt": HEAT_TEST["nt"], "nx": HEAT_TEST["nx"], "L": 128, "N": 256,
          "kernel_launches": launches, "expected_launches": want_launches,
          "finite": finite, "shape_ok": shape_ok, **metrics,
          "plain_metrics": metrics_plain, "vs_plain": cmp,
          "seconds_per_batch_first": first_s / len(batches),
          "seconds_per_batch": steady_s / len(batches),
          "seconds_per_batch_plain": plain_s / len(batches),
          "peak_mem_bytes": peak, "ok": slice_ok})

    # 5. kernels
    emit({"kernels": [{
        "name": "fused_edge_tail_agg", "route": "cuda",
        "source": "magnet_tpu_torch/csrc/fused_edge_tail_agg.cu",
        "replaces": "magnet_tpu/ops/pallas_kernels.py:1356",
        "launches": launches, "max_abs_err": max(big["max_abs_err"],
                                                 small["max_abs_err"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
        "bound_by": bnd["bound_by"], "library_ms": None,
        "ok": kernel_ok and slice_ok}]})
    if not slice_ok:
        return 3
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
