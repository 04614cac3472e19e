"""Where the eval slice's time goes on the card.

  python -m magnet_tpu_torch.trace_eval [n_traj=16] [batch_size=16] [seed=0]
      [out=PATH]

Runs ``evaluate`` once to warm up, once timed with no profiler, then once
under ``torch.profiler`` (CPU and CUDA activities).  Prints one JSON line:
wall seconds per batch of both timed runs, the device's busy time (the sum
of device-side events: kernels and copies) and its idle share against each
wall time, the kernels that took the most device time, and the host ops
that took the most CPU time.  With ``out=PATH`` the profiler's full table
is written there too.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from magnet_tpu_torch.config import HEAT_TEST, MAGNET_CNN, parse_overrides
from magnet_tpu_torch.data.heat import heat_batches
from magnet_tpu_torch.eval import evaluate
from magnet_tpu_torch.models.factory import create_model


def main(argv=None) -> dict:
    run = parse_overrides(list(sys.argv[1:] if argv is None else argv),
                          {"n_traj": 16, "batch_size": 16, "seed": 0,
                           "out": ""})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = create_model("magnet_cnn", MAGNET_CNN, device="cuda",
                         seed=run["seed"])
    batches = heat_batches(run["n_traj"], run["batch_size"],
                           nt=HEAT_TEST["nt"], nx=HEAT_TEST["nx"],
                           seed=run["seed"])
    evaluate(model, batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate(model, batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate(model, batches)
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side events only: a host op's own device column repeats the
    # time of the kernels it launched
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in dev)
    if run["out"]:
        out = Path(run["out"])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(events.table(sort_by="self_device_time_total",
                                    row_limit=60))
    result = {
        "device": torch.cuda.get_device_name(0),
        "batches": len(batches), "batch_size": run["batch_size"],
        "wall_s_per_batch": wall / len(batches),
        "wall_s_per_batch_traced": wall_traced / len(batches),
        "device_busy_ms_per_batch": busy_ms / len(batches),
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
        "device_idle_share_traced": 1.0 - busy_ms / 1e3 / wall_traced,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_batch": ms / len(batches),
             "calls_per_batch": n / len(batches)} for k, ms, n in dev[:12]],
        "cpu_ops_by_self_time": [
            {"name": e.key[:60], "self_cpu_ms_per_batch":
             e.self_cpu_time_total / 1e3 / len(batches),
             "calls_per_batch": e.count / len(batches)}
            for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
