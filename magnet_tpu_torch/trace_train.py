"""Where a training step's time goes on the card.

  python -m magnet_tpu_torch.trace_train [steps=3] [batch_size=32] [seed=0]
      [burn_in=10.0] [out=PATH]

Makes ``steps`` batches of KS training data from the seed, takes two
optimizer steps to warm up, then ``steps`` steps timed with no profiler and
``steps`` more under ``torch.profiler`` (CPU and CUDA activities), all
through ``Trainer.train_step`` at the full width of ``magnet_cnn``.  Prints
one JSON line: wall seconds per step of both timed runs, the device's busy
time per step (the sum of device-side events: kernels and copies) and its
idle share against each wall time, device kernels launched per step, the
fused edge kernels' launches per step, the kernels that took the most
device time, and the host ops that took the most CPU time.  With
``out=PATH`` the profiler's full table is written there too.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from magnet_tpu_torch.config import (
    DATAMODULE_IMPLICIT,
    MAGNET_CNN,
    parse_overrides,
)
from magnet_tpu_torch.data.datasets import DatasetImplicit1D
from magnet_tpu_torch.data.loader import DataLoader
from magnet_tpu_torch.data.synthetic import make_split
from magnet_tpu_torch.models.factory import create_model
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    run = parse_overrides(list(sys.argv[1:] if argv is None else argv),
                          {"steps": 3, "batch_size": 32, "seed": 0,
                           "burn_in": 10.0, "out": ""})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp, dm = MAGNET_CNN, DATAMODULE_IMPLICIT
    steps = run["steps"]
    model = create_model("magnet_cnn", hp, device="cuda", seed=run["seed"])
    dataset = DatasetImplicit1D(
        make_split("KS", steps * run["batch_size"], dm["nt_train"],
                   dm["nx_train"], seed=run["seed"], burn_in=run["burn_in"]),
        "train", nt=dm["nt_train"], nx=dm["nx_train"], sampling=dm["sampling"],
        samples=dm["samples"])
    loader = DataLoader(dataset, run["batch_size"], seed=run["seed"])
    loader.set_epoch(0)
    batches = list(loader)
    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer(model, lr=hp["lr"], weight_decay=hp["weight_decay"],
                          factor=hp["factor"], step_size=hp["step_size"],
                          workdir=workdir, device="cuda")
    trainer.setup(steps)

    def run_steps():
        losses = [trainer.train_step(b)["loss"] for b in batches]
        torch.cuda.synchronize()
        return losses

    for b in batches[:2]:
        trainer.train_step(b)
    torch.cuda.synchronize()
    fe.launches = fe.launches_bwd = 0
    t0 = time.perf_counter()
    run_steps()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = fe.launches, fe.launches_bwd
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = run_steps()
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
                                    row_limit=80))
    result = {
        "device": torch.cuda.get_device_name(0),
        "steps": steps, "batch_size": run["batch_size"],
        "loss_last_step": float(losses[-1]),
        "wall_s_per_step": wall / steps,
        "wall_s_per_step_traced": wall_traced / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
        "device_idle_share_traced": 1.0 - busy_ms / 1e3 / wall_traced,
        "device_events_per_step": sum(n for _, _, n in dev) / steps,
        "fused_edge_launches_per_step": {"fwd": fwd_launches / steps,
                                         "bwd": bwd_launches / steps},
        "top_device_kernels": [
            {"name": k[:80], "ms_per_step": ms / steps,
             "calls_per_step": n / steps} for k, ms, n in dev[:16]],
        "cpu_ops_by_self_time": [
            {"name": e.key[:60], "self_cpu_ms_per_step":
             e.self_cpu_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
