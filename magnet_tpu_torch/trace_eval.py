"""Where the eval slice's time goes on the card.

  python -m magnet_tpu_torch.trace_eval [model=magnet_cnn] [datamodule=NAME]
      [n_traj=16] [batch_size=16] [seed=0] [impl=kernel] [out=PATH]
      [model.params.key=value ...] [datamodule.key=value ...]

Evaluates ``model`` at full width on test batches made from the seed at the
shape of its datamodule's test split (the model's own unless
``datamodule=`` names another; for ``mpnn_2d`` and ``magnet_cnn_2d`` pass
``batch_size=4``); ``impl`` sets the model's kernel lane (``kernel_pe``
for the pe lane of ``magnet_cnn``, ``magnet_cnn_2d`` or ``magnet_gnn``).  Runs ``evaluate`` once to warm up, once
timed with no profiler, then once under ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON line: wall seconds per batch of both timed
runs, the device's busy time (the sum of device-side events: kernels and
copies) and its idle share against each wall time, the port's own
kernels' launches per batch, the kernels that took the most device time,
and the host ops that took the most CPU time.  With ``out=PATH`` the
profiler's full table is written there too.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from magnet_tpu_torch.config import (
    model_overrides,
    parse_overrides,
    split_datamodule,
    split_model,
    take_prefixed,
)
from magnet_tpu_torch.data.datamodule import synthetic_test_batches
from magnet_tpu_torch.eval import evaluate
from magnet_tpu_torch.models.factory import create_model
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.ops import mpnn_edge as me
from magnet_tpu_torch.ops import segment as seg


def main(argv=None) -> dict:
    name, argv = split_model(list(sys.argv[1:] if argv is None else argv))
    dm, argv = split_datamodule(name, argv)
    dm_args, argv = take_prefixed(argv, "datamodule.")
    hp_args, argv = take_prefixed(argv, "model.params.")
    dm = parse_overrides(dm_args, dm)
    hp = model_overrides(name, hp_args)
    run = parse_overrides(argv, {"n_traj": 16, "batch_size": 16, "seed": 0,
                                 "impl": "kernel", "out": ""})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = create_model(name, hp, device="cuda", seed=run["seed"],
                         kind=dm["kind"])
    model.impl = run["impl"]
    batches = synthetic_test_batches(name, run["n_traj"], run["batch_size"],
                                     seed=run["seed"], datamodule=dm)
    evaluate(model, batches)
    torch.cuda.synchronize()
    fe.reset_launches()
    me.reset_launches()
    seg.launches = seg.launches_bf16 = 0
    t0 = time.perf_counter()
    evaluate(model, batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fe.launch_counts(), "segment_sum": seg.launches,
                "segment_sum_bf16": seg.launches_bf16,
                **me.launches}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate(model, batches)
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side kernels and copies only: a host op's own device column
    # and an annotated region on the device (the optimizer's step) repeat
    # the time of the kernels under them
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in dev)
    if run["out"]:
        out = Path(run["out"])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(events.table(sort_by="self_device_time_total",
                                    row_limit=60))
    result = {
        "device": torch.cuda.get_device_name(0), "model": name,
        "datamodule": dm["name"], "impl": run["impl"],
        "batches": len(batches), "batch_size": run["batch_size"],
        "wall_s_per_batch": wall / len(batches),
        "wall_s_per_batch_traced": wall_traced / len(batches),
        "device_busy_ms_per_batch": busy_ms / len(batches),
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
        "device_idle_share_traced": 1.0 - busy_ms / 1e3 / wall_traced,
        "device_events_per_batch": sum(n for _, _, n in dev) / len(batches),
        "kernel_launches_per_batch": {k: v / len(batches)
                                      for k, v in launches.items()},
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
