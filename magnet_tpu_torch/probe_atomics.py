"""Share of the d_pxj atomics in the MPNN gather backward (kernel #11).

  python -m magnet_tpu_torch.probe_atomics [reps=20]

On the card only.  Copies ``csrc/`` into ``_build/probe_atomics/``, removes
from the copy the sender-side scatter of ``fused_mpnn_edge_agg_bwd.cu`` (the
f32 ``atomicAdd`` of d_z1 into d_pxj), builds both libraries, and times
each at MPNN-2D's training batch (4 x 64², 524,256 edges, H = 128) with
CUDA events, in turns: kernel, probe, probe, kernel.  Prints the card's name
and power limit, then one JSON line: both times, the atomics' share of the
kernel's time, and whether the probe's weight gradient equals the kernel's
(the scatter is the only change).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from magnet_tpu_torch.config import DATAMODULE_GRAPH_2D, MPNN_2D
from magnet_tpu_torch.models.factory import create_model
from magnet_tpu_torch.ops import cuda_build
from magnet_tpu_torch.ops import mpnn_edge as me

NAME = me.BWD
SCATTER = "atomicAdd(d_src + (size_t)snd[e] * kH + n, s_z1[swz_at(e, n)]);"


def probe_library():
    """The kernel's library and the probe's, built from the package's
    sources and from the altered copy."""
    probe_dir = cuda_build._BUILD_DIR / "probe_atomics"
    shutil.rmtree(probe_dir, ignore_errors=True)
    shutil.copytree(cuda_build._CSRC, probe_dir)
    src = probe_dir / f"{NAME}.cu"
    text = src.read_text()
    if text.count(SCATTER) != 1:
        raise RuntimeError(f"the d_pxj scatter is not in {NAME}.cu as expected")
    src.write_text(text.replace(SCATTER, "(void)e;"))
    return cuda_build.build(NAME), cuda_build.build(NAME, csrc=probe_dir)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_atomics: no CUDA device", file=sys.stderr)
        return 1
    reps = int(dict(a.split("=", 1) for a in argv).get("reps", 20))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda")
    kernel_lib, probe_lib = probe_library()

    bs, res = DATAMODULE_GRAPH_2D["batch_size"], DATAMODULE_GRAPH_2D["res_train"]
    x = (np.arange(res) * (1.0 / res)).astype(np.float32)
    grid = np.stack(np.meshgrid(x, x, indexing="ij"), -1).reshape(-1, 2)
    coords = np.broadcast_to(grid, (bs, *grid.shape)).copy()
    model = create_model("mpnn_2d", dict(MPNN_2D), device=dev, seed=0)
    graph = model.build_graph({"x": torch.from_numpy(coords)})
    n, e, h = graph.n_node, graph.n_edge, MPNN_2D["hidden_features"]
    gen = torch.Generator().manual_seed(11)
    pxj, pr = (torch.randn(n, h, generator=gen) * 0.5).to(dev), (
        torch.randn(n, h, generator=gen) * 0.5).to(dev)
    w = (torch.randn(h, h, generator=gen) * 0.15).to(dev)
    b = (torch.randn(h, generator=gen) * 0.1).to(dev)
    g = torch.randn(n, h, generator=torch.Generator().manual_seed(13)).to(dev)
    n_blocks = me.bwd_blocks(dev)
    d_pxj, d_pr = torch.zeros(n, h, device=dev), torch.zeros(n, h, device=dev)
    wgrad = torch.empty(h * h + h, device=dev)
    partial = torch.empty(n_blocks, h * h + h, device=dev)

    def bind(lib):
        import ctypes
        fn = getattr(ctypes.CDLL(str(lib)), f"{NAME}_f32")
        fn.argtypes = me._ARGTYPES[NAME]
        fn.restype = ctypes.c_int

        def run():
            d_pxj.zero_()
            d_pr.zero_()
            err = fn(pxj.data_ptr(), pr.data_ptr(), w.data_ptr(), b.data_ptr(),
                     graph.senders.data_ptr(), graph.rowptr.data_ptr(),
                     g.data_ptr(), d_pxj.data_ptr(), d_pr.data_ptr(),
                     wgrad.data_ptr(), partial.data_ptr(), n, e, h, 1,
                     n_blocks, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        return run

    def ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    graph = graph.to(dev)
    kernel, probe = bind(kernel_lib), bind(probe_lib)
    kernel()
    torch.cuda.synchronize()
    dw_kernel = wgrad.clone()
    probe()
    torch.cuda.synchronize()
    same_dw = bool(torch.equal(wgrad, dw_kernel))
    # the zero fills are timed with both, as the wrapper pays them
    fill = ms(lambda: (d_pxj.zero_(), d_pr.zero_()))
    t = [ms(kernel), ms(probe), ms(probe), ms(kernel)]
    t_kernel, t_probe = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(json.dumps({
        "probe": "d_pxj atomics of fused_mpnn_edge_agg_bwd (gather)",
        "n_node": n, "n_edge": e, "h": h, "reps": reps,
        "ms_kernel_probe_probe_kernel": t, "ms_zero_fills": fill,
        "ms_kernel": t_kernel, "ms_without_d_pxj_scatter": t_probe,
        "atomics_share": (t_kernel - t_probe) / t_kernel,
        "dw_equal": same_dw,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
