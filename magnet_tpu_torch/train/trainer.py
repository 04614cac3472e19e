"""Training engine (counterpart of ``magnet_tpu/train/trainer.py``): the
train and validation steps, the epoch loop, early stopping, checkpoints
and the metric log, on one device or over a (dp, graph) mesh of ranks
(``parallel.mesh``).

A train step is ``loss(train=True)`` -> backward -> global-norm clip ->
optimizer, with the model in training mode (cuDNN's LSTM takes its
backward only there); validation puts it back in eval mode.  Metrics stay
on the device and are read once per epoch.

Over a mesh (JAX ``trainer.py:65-93, 139-240``): every rank reads the same
global batch and takes its dp block (contiguous, as ``P("dp")`` splits
it; a batch that does not divide raises); with ``graph_shards`` > 1 the
ranks of a graph axis partition their block's graph
(``build_graph_partitioned``) and run the processor a shard each.  The
gradients are summed over all ranks and divided by their number (an
explicit all-reduce): the mean over dp blocks, each graph axis's ranks
counting their shared loss once.  Metrics are averaged over the ranks.
Rank 0 alone writes ``metrics.jsonl`` and the checkpoints, in the
single-process format, so a run saved on any mesh resumes on any other.

``steps_per_call`` = k (JAX ``trainer.py:98-114, 186-193, 256-327,
388-401``, a ``lax.scan`` over k stacked batches and graphs a jit call)
buffers k (batch, graph) pairs an epoch, the graphs built on the host from
the host batches.  On one CUDA device, a full chunk whose batches share
shapes runs as replays of a CUDA graph of one training step when its pairs
share one graph object (the JAX ``train_scan_shared`` condition: the
models' graph caches return one object a coordinate set), or when its
graphs differ but pad to one signature (the JAX ``train_scan`` over
stacked graphs, which share a static shape because the JAX host builder
pads edges to sticky buckets): a model with ``graph_parts``
(``models.common.PaddedGraphMixin``: MAgNet[CNN] 1D and 2D, MAgNet[GNN]
1D and 2D) whose processors take, on the chunk's graphs, lanes whose
kernels read the live edge count on the card (``takes_padding``: the
fold, pe and pre-gathered entries in f32 at either width and in bf16 at
width 64) gets them padded to the trainer's edge buckets
(``ops.graph.EdgeBuckets``: one a graph role, the most edges seen in the
fit rounded up to 1,024, never shrinking), past the end of their CSR, so
a padded graph computes what it would unpadded.  A step is
captured once per (batch signature, graph signature) (``ops.graph.
graph_signature``: node and edge rows, lane and layout of each CSR graph,
the k-NN table's shape) after one eager step of warm-up on a side stream,
over static copies of the batch and of the graph; each replay is preceded
by the copy of its batch, and of its graph where it is another, into them
and followed by a copy of its metrics, with no read from the device
between them.  The step reads nothing back (``train.optim``: the optimizer
decides on the device), so a replay is the eager step, and the trajectory,
the draws of a model's own generator (registered with the graph) and the
checkpoints are the same whatever k.  Any other chunk (short, on the CPU,
over a mesh of ranks, of graphs that differ on the plain versions or the
width-128 bf16 lanes or in another signature, or of a model without
``graph_parts``) runs its steps one by one on its unpadded graphs, as the
JAX package runs a chunk it cannot scan, and says why once a fit, naming
the lane, its dtype and its width where those are the reason.  With
``graph_shards`` > 1, k falls back to 1, with the JAX trainer's
warning.  ``host_graph`` counts the host's
seconds building and padding graphs.  ``log_every`` is stored and read
nowhere, as in the JAX trainer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from magnet_tpu_torch.models.factory import resolve_device
from magnet_tpu_torch.ops.fused_edge import reads_live_edges
from magnet_tpu_torch.ops.graph import EdgeBuckets, graph_signature
from magnet_tpu_torch.parallel.graph_partition import check_halo
from magnet_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint
from magnet_tpu_torch.train.optim import clip_grad_global_norm, make_optimizer
from magnet_tpu_torch.utils import to_device


def all_reduce_mean(tensors: list, n: int) -> None:
    """Each tensor replaced in place by its mean over the ``n`` ranks of
    the world, in one all-reduce (complex tensors as real pairs)."""
    views = [torch.view_as_real(t) if t.is_complex() else t for t in tensors]
    flat = torch.cat([v.reshape(-1) for v in views])
    dist.all_reduce(flat)
    flat /= n
    for v, part in zip(views, flat.split([v.numel() for v in views])):
        v.copy_(part.view_as(v))


def mean_metrics(pending: list[dict]) -> dict[str, float]:
    """Means over a list of per-step metric dicts of device scalars, with
    one read from the device."""
    if not pending:
        return {}
    keys = list(pending[0])
    table = torch.stack([torch.stack([m[k] for k in keys]) for m in pending])
    return dict(zip(keys, table.double().mean(0).tolist()))


class EarlyStopping:
    def __init__(self, patience: int = 35, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.patience


#: captured steps a trainer keeps (each holds its graph and a memory pool
#: of the step's activations); the oldest goes first
MAX_CAPTURED = 4


#: the GraphNet lanes whose kernels can read a padded graph's live edge
#: count on the card (``ops.graph.pad_edges``); the plain versions read it
#: on the host, which a capture refuses
PADDED_LANES = ("fold", "pe", "pregathered")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def takes_padding(lane: str, dtype: str, width: int) -> bool:
    """Whether a processor step of ``lane`` in ``dtype`` at ``width`` (a
    model's ``graph_lanes``) computes on a padded graph what it computes on
    the graph unpadded, inside a captured step: a lane of ``PADDED_LANES``
    whose build ``reads_live_edges``."""
    return lane in PADDED_LANES and reads_live_edges(DTYPES[dtype], width)


def batch_signature(batch: dict) -> tuple:
    """The keys, shapes and dtypes of a batch's arrays."""
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items())


def graph_tensors(graph) -> list:
    """A model's graph's tensors in field order (a tensor, a dataclass of
    them such as ``CSRGraph`` or ``GNNGraphs``; anything else has none)."""
    if isinstance(graph, torch.Tensor):
        return [graph]
    if dataclasses.is_dataclass(graph) and not isinstance(graph, type):
        return [t for f in dataclasses.fields(graph)
                for t in graph_tensors(getattr(graph, f.name))]
    return []


def clone_graph(graph):
    """A model's graph with every tensor of it copied."""
    if isinstance(graph, torch.Tensor):
        return graph.clone()
    if dataclasses.is_dataclass(graph) and not isinstance(graph, type):
        return dataclasses.replace(graph, **{
            f.name: clone_graph(getattr(graph, f.name))
            for f in dataclasses.fields(graph)})
    return graph


class CapturedStep:
    """A training step (``Trainer.device_step``) captured as a CUDA graph
    over static copies of one batch and one graph of their signatures;
    ``replay(batch, graph)`` is that step on ``batch`` and ``graph``.  The
    model's own generator, where it has one (``models.common.
    OwnGenerator``), is registered with the graph, so a replay draws what
    the eager step would."""

    def __init__(self, trainer: "Trainer", batch: dict, graph):
        self.inputs = {k: v.clone() for k, v in batch.items()}
        self.graph = clone_graph(graph)
        self.source = graph     # the graph whose tensors self.graph holds
        self.cuda_graph = torch.cuda.CUDAGraph()
        if hasattr(trainer.model, "default_generator"):
            self.cuda_graph.register_generator_state(
                trainer.model.default_generator())
        with torch.cuda.graph(self.cuda_graph):
            self.metrics = trainer.device_step(self.inputs, self.graph)
        self.params = trainer.optimizer.params
        self.grads = [p.grad for p in self.params]

    def replay(self, batch: dict, graph) -> dict:
        """Enqueue the step on ``batch`` and ``graph`` (device tensors of
        the captured signatures); its metrics, copied out of the graph's
        tensors.  The graph is copied in unless it is the one already
        there.  The parameters' ``.grad`` are the graph's gradients again,
        as after the eager step."""
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        if graph is not self.source:
            for dst, src in zip(graph_tensors(self.graph),
                                graph_tensors(graph)):
                dst.copy_(src)
            self.source = graph
        self.cuda_graph.replay()
        for p, g in zip(self.params, self.grads):
            p.grad = g
        return {k: v.clone() for k, v in self.metrics.items()}


class Trainer:
    def __init__(self, model, max_epochs: int = 100, lr: float = 1e-3,
                 weight_decay: float = 0.0, factor: float = 0.3,
                 step_size: int = 50, patience: int = 35,
                 workdir: str = "runs/default", device="cuda",
                 check_val_every: int = 1, skip_nonfinite: bool = False,
                 grad_clip: float = 0.0, save_last_every: int = 1,
                 best_weights_only: bool = False, mesh=None,
                 graph_shards: int = 1, graph_halo=False,
                 steps_per_call: int = 1, log_every: int = 10):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh = mesh
        self.graph_shards = int(graph_shards)
        self.graph_halo = check_halo(graph_halo)
        if self.graph_shards > 1 and (mesh is None
                                      or mesh.graph != self.graph_shards):
            raise ValueError(f"graph_shards={self.graph_shards} needs a mesh "
                             f"with a graph axis of that size")
        if self.graph_shards > 1 and not hasattr(model,
                                                 "build_graph_partitioned"):
            raise ValueError(f"{type(model).__name__} has no graph-parallel "
                             f"execution path")
        self.world = 1 if mesh is None else mesh.world
        self.writer = mesh is None or mesh.rank == 0
        if mesh is not None and hasattr(model, "batch_block"):
            model.batch_block = (mesh.dp_index, mesh.dp)
        self.max_epochs = max_epochs
        self.lr, self.weight_decay = lr, weight_decay
        self.factor, self.step_size = factor, step_size
        self.workdir = workdir
        self.check_val_every = check_val_every
        self.skip_nonfinite = bool(skip_nonfinite)
        self.grad_clip = float(grad_clip)
        self.log_every = int(log_every)
        self.steps_per_call = max(1, int(steps_per_call))
        if self.steps_per_call > 1 and self.graph_shards > 1:
            warnings.warn("steps_per_call > 1 unsupported with graph_shards "
                          "> 1; using 1")
            self.steps_per_call = 1
        #: the captured steps of this trainer's fit, by (batch signature,
        #: graph signature), the edge buckets of its padded graphs, and the
        #: training steps run eagerly, captured and replayed
        self.captured: dict = {}
        self.buckets = EdgeBuckets()
        self.step_counts = {"eager": 0, "captured": 0, "replayed": 0}
        #: the host's graphs: built (batches) and padded (graphs), seconds
        self.host_graph = {"built": 0, "build_s": 0.0, "padded": 0,
                           "pad_s": 0.0}
        self._noted: set = set()
        self.ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"),
                                      last_every=save_last_every,
                                      best_weights_only=best_weights_only)
        self.early = EarlyStopping(patience=patience)
        self.optimizer = None
        self._last_val: Optional[float] = None
        if self.writer:
            os.makedirs(workdir, exist_ok=True)

    def state(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.optimizer.step_count}

    def _host_pair(self, batch):
        """This rank's dp block of a batch, as tensors where they were
        given (host arrays as host tensors), and the block's graph built
        from them (partitioned over the mesh's graph axis when
        ``graph_shards`` > 1)."""
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self.mesh is not None and self.mesh.dp > 1:
            n, i = self.mesh.dp, self.mesh.dp_index
            size = len(next(iter(batch.values())))
            if size % n:
                raise ValueError(f"a batch of {size} does not split over "
                                 f"dp={n}")
            b = size // n
            batch = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        t0 = time.perf_counter()
        if self.graph_shards > 1:
            graph = self.model.build_graph_partitioned(
                batch, self.graph_shards, halo=self.graph_halo,
                axis=self.mesh.graph_axis())
        else:
            graph = self.model.build_graph(batch)
        self.host_graph["built"] += 1
        self.host_graph["build_s"] += time.perf_counter() - t0
        return batch, graph

    def _local(self, batch):
        """``_host_pair``'s block on this rank's device, and its graph."""
        batch, graph = self._host_pair(batch)
        return to_device(batch, self.device), graph

    def _world_mean(self, metrics: dict) -> dict:
        """Host metrics averaged over the ranks."""
        if self.world == 1 or not metrics:
            return metrics
        t = torch.tensor(list(metrics.values()), dtype=torch.float64,
                         device=self.device)
        all_reduce_mean([t], self.world)
        return dict(zip(metrics, t.tolist()))

    def train_step(self, batch) -> dict:
        """One optimizer step on a host batch; the metrics, on the device."""
        return self.device_step(*self._local(batch))

    def device_step(self, batch, graph) -> dict:
        """One optimizer step on a device batch and its graph, reading
        nothing back from the device (over a mesh: with the gradients'
        all-reduce); the metrics, on the device."""
        self.model.train()
        self.optimizer.zero_grad()
        loss, metrics = self.model.loss(batch, graph, train=True)
        loss.backward()
        if self.world > 1:
            for p in self.optimizer.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_mean([p.grad for p in self.optimizer.params],
                            self.world)
        clip_grad_global_norm(self.optimizer.params, self.grad_clip)
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def setup(self, steps_per_epoch: int) -> None:
        """Make the optimizer; its learning rate decays by epochs of
        ``steps_per_epoch`` steps."""
        self.optimizer = make_optimizer(
            self.model.parameters(), self.lr, self.weight_decay, self.factor,
            self.step_size, steps_per_epoch,
            skip_nonfinite=self.skip_nonfinite, max_epochs=self.max_epochs)
        self.captured, self._noted = {}, set()
        self.buckets = EdgeBuckets()

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            resume: Optional[str] = None):
        self.setup(len(train_loader))
        start_epoch = 0
        if resume:
            state, meta = load_checkpoint(resume, require=("model", "optimizer"))
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            start_epoch = int(meta.get("epoch", -1)) + 1
            self._print(f"resumed from {resume} at epoch {start_epoch}")

        stop = False
        epoch = start_epoch - 1
        for epoch in range(start_epoch, self.max_epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            pending, chunk = [], []
            for batch in train_loader:
                chunk.append(self._host_pair(batch))
                if len(chunk) == self.steps_per_call:
                    pending += self._run_chunk(chunk)
                    chunk = []
            if chunk:
                pending += self._run_chunk(chunk)
            tm = self._world_mean(mean_metrics(pending))  # waits for the device
            train_time = time.time() - t0
            row = {"epoch": epoch, "time": train_time,
                   "steps_per_s": len(pending) / max(train_time, 1e-9),
                   **{f"train_{k}": v for k, v in tm.items()}}

            if val_loader is not None and (epoch + 1) % self.check_val_every == 0:
                vm = self.evaluate(val_loader)
                row.update({f"val_{k}": v for k, v in vm.items()})
                monitored = row.get("val_mae_loss", row.get("val_loss"))
                if monitored is not None:
                    self._last_val = float(monitored)
                    if self.writer:
                        self.ckpt.update(self.state(), epoch,
                                         {"val_mae_loss": monitored})
                    stop = self.early.update(monitored)
                else:
                    self._print("val loader produced no batches; no "
                                "checkpoint or early-stop update this epoch")

            if self.writer:
                with open(os.path.join(self.workdir, "metrics.jsonl"),
                          "a") as f:
                    f.write(json.dumps(row) + "\n")
            self._print(" ".join([f"epoch {epoch}"] + [
                f"{k}={v:.5f}" for k, v in row.items() if k != "epoch"]))
            if stop:
                self._print(f"early stopping at epoch {epoch}")
                break

        # a final rolling checkpoint for resume even when save_last_every
        # skipped the last epoch's write; its sidecar carries that epoch's
        # metric, and none when no validation ran
        if (self.writer and epoch >= start_epoch
                and self.ckpt.last_epoch != epoch):
            meta = ({"val_mae_loss": self._last_val}
                    if self._last_val is not None else {})
            self.ckpt.save_last(self.state(), epoch, meta)
        return self.model

    def _uncaptured(self, chunk: list) -> Optional[str]:
        """Why ``chunk`` cannot run as replays of a captured step (None: it
        can)."""
        k = len(chunk)
        if k < self.steps_per_call or k == 1:
            return "a short chunk" if k > 1 else "one step a call"
        if self.device.type != "cuda":
            return f"no CUDA graph on {self.device.type}"
        if self.world > 1:
            return f"the gradients' all-reduce over {self.world} ranks"
        graphs = [g for _, g in chunk]
        if any(g is not graphs[0] for g in graphs[1:]):
            why = self._unpadded(graphs)
            if why is not None:
                return why
        sig = batch_signature(chunk[0][0])
        if any(batch_signature(b) != sig for b, _ in chunk[1:]):
            return "the chunk's batch shapes differ"
        return None

    def _unpadded(self, graphs: list) -> Optional[str]:
        """Why a chunk's graphs, which differ, cannot be padded to one
        signature (None: they can): every processor step on them must
        ``takes_padding``."""
        if not hasattr(self.model, "graph_parts"):
            return "the chunk's graphs differ"
        lanes = set().union(*map(self.model.graph_lanes, graphs))
        for lane, dtype, width in sorted(lanes):
            if not takes_padding(lane, dtype, width):
                return (f"the chunk's graphs differ, on the {lane} lane in "
                        f"{dtype} at width {width}")
        sig = graph_signature(graphs[0], edges=False)
        if any(graph_signature(g, edges=False) != sig for g in graphs[1:]):
            return "the chunk's graph signatures differ"
        return None

    def _padded(self, graphs: list) -> list:
        """The chunk's graphs, each of their parts padded to its role's
        bucket, the buckets grown first to hold every one of them."""
        t0 = time.perf_counter()
        parts = [self.model.graph_parts(g) for g in graphs]
        for p in parts:
            for role, csr in p.items():
                self.buckets.grow(role, csr.n_edge)
        out = [self.model.with_graph_parts(
            g, {role: self.buckets.pad(role, csr) for role, csr in p.items()})
            for g, p in zip(graphs, parts)]
        self.host_graph["padded"] += len(graphs)
        self.host_graph["pad_s"] += time.perf_counter() - t0
        return out

    def _run_chunk(self, chunk: list) -> list:
        """Train on the buffered (host batch, graph) pairs: as replays of a
        captured step where ``_uncaptured`` finds no reason against it (the
        graphs padded where they differ), else one eager step each on its
        own graph (noted once a fit per reason).  Returns each step's
        metrics, on the device."""
        why = self._uncaptured(chunk)
        if why is not None:
            if len(chunk) > 1 and why not in self._noted:
                self._noted.add(why)
                self._print(f"steps_per_call={self.steps_per_call}: a chunk "
                            f"of {len(chunk)} steps runs step by step ({why})")
            self.step_counts["eager"] += len(chunk)
            return [self.device_step(to_device(b, self.device), g)
                    for b, g in chunk]
        batches = [to_device(b, self.device) for b, _ in chunk]
        graphs = [g for _, g in chunk]
        if any(g is not graphs[0] for g in graphs[1:]):
            graphs = self._padded(graphs)
        key = (batch_signature(chunk[0][0]), graph_signature(graphs[0]))
        out = []
        if key not in self.captured:
            # warm-up: the chunk's first step runs eagerly on a side stream
            # (kernel builds, lazy state, workspaces), then the capture
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                out.append(self.device_step(batches.pop(0), graphs.pop(0)))
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.step_counts["eager"] += 1
            if len(self.captured) >= MAX_CAPTURED:
                self.captured.pop(next(iter(self.captured)))
            self.captured[key] = CapturedStep(self, batches[0], graphs[0])
            self.step_counts["captured"] += 1
        step = self.captured[key]
        out += [step.replay(b, g) for b, g in zip(batches, graphs)]
        self.step_counts["replayed"] += len(batches)
        return out

    def _print(self, text: str) -> None:
        if self.writer:
            print(text, flush=True)

    def evaluate(self, loader) -> dict[str, float]:
        """Means of ``loss(train=False)``'s metrics over the loader (and
        the ranks)."""
        self.model.eval()
        pending = []
        for batch in loader:
            batch, graph = self._local(batch)
            _, metrics = self.model.loss(batch, graph, train=False)
            pending.append(metrics)
        return self._world_mean(mean_metrics(pending))
