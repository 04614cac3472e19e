"""Where a training step's time goes on the card.

  python -m magnet_tpu_torch.trace_train [model=magnet_cnn] [datamodule=NAME]
      [steps=3] [seed=0] [impl=kernel] [datamodule_key=value ...]
      [model.params.key=value ...] [out=PATH]

Makes ``steps`` batches of ``model``'s training data from the seed with its
datamodule's synthetic source (the model's own datamodule unless
``datamodule=`` names another; ``datamodule_key=value`` replaces a key of
the datamodule's defaults, for example ``burn_in=10.0`` to shorten the KS
burn-in, ``n_steps=2000`` for the combined equation's solver or
``batch_size=8`` for ``magnet_cnn_2d``; ``model.params.key=value`` one of
the model's; ``impl`` sets the model's kernel lane, ``kernel_pe`` for
the pe lane of ``magnet_cnn`` or ``magnet_gnn`` (``magnet_cnn_2d`` trains
on the pre-gathered lane there, as the JAX package does),
``kernel_pregathered`` for the pre-gathered lane), takes two
optimizer steps to warm up, then ``steps`` steps timed with no profiler and
``steps`` more under ``torch.profiler`` (CPU and CUDA activities), all
through ``Trainer.train_step`` at the model's full width.  Prints
one JSON line: wall seconds per step of both timed runs, the device's busy
time per step (the sum of device-side events: kernels and copies) and its
idle share against each wall time, device kernels launched per step, the
port's own kernels' launches per step, the kernels that took the most
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
    model_overrides,
    SYNTHETIC_SOURCE,
    parse_overrides,
    split_datamodule,
    split_model,
    take_prefixed,
)
from magnet_tpu_torch.data.datamodule import build_loaders
from magnet_tpu_torch.models.factory import create_model
from magnet_tpu_torch.ops import fused_edge as fe
from magnet_tpu_torch.ops import mpnn_edge as me
from magnet_tpu_torch.ops import segment as seg
from magnet_tpu_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    name, argv = split_model(list(sys.argv[1:] if argv is None else argv))
    dm, argv = split_datamodule(name, argv)
    hp_args, argv = take_prefixed(argv, "model.params.")
    hp = model_overrides(name, hp_args)
    run_keys = {"steps": 3, "seed": 0, "impl": "kernel", "out": ""}
    run = parse_overrides(
        [a for a in argv if a.split("=")[0] in run_keys], run_keys)
    dm = parse_overrides(
        [a for a in argv if a.split("=")[0] not in run_keys], dm)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = run["steps"]
    model = create_model(name, hp, device="cuda", seed=run["seed"],
                         kind=dm["kind"])
    model.impl = run["impl"]
    loader = build_loaders(
        {**dm, "source": SYNTHETIC_SOURCE[dm["kind"]],
         "n_train": steps * dm["batch_size"], "n_val": 1, "n_test": 1,
         "data_seed": run["seed"]}, seed=run["seed"])["train"]
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
    fe.reset_launches()
    me.reset_launches()
    seg.launches = seg.launches_bf16 = 0
    t0 = time.perf_counter()
    run_steps()
    wall = time.perf_counter() - t0
    launches = {**fe.launch_counts(), "segment_sum": seg.launches,
                "segment_sum_bf16": seg.launches_bf16,
                **me.launches}
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
        "device": torch.cuda.get_device_name(0), "model": name,
        "datamodule": dm["name"], "impl": run["impl"], "steps": steps,
        "batch_size": dm["batch_size"],
        "loss_last_step": float(losses[-1]),
        "wall_s_per_step": wall / steps,
        "wall_s_per_step_traced": wall_traced / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
        "device_idle_share_traced": 1.0 - busy_ms / 1e3 / wall_traced,
        "device_events_per_step": sum(n for _, _, n in dev) / steps,
        "kernel_launches_per_step": {k: v / steps
                                     for k, v in launches.items()},
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
