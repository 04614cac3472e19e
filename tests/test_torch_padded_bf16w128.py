"""Captured chunks on the last two paths that ran step by step, on the CPU:
MAgNet[GNN]'s bf16 lanes at width 128, whose kernels now read a padded
graph's live edge count on the card, and chunks over dp ranks, whose
gradient all-reduce is captured with the step.

(a) The plain bf16 fold entry at (Ce, H, C) = (128, 128, 128) and the pe
    and pre-gathered entries at (H, C) = (128, 128) on dead tails of 1, 64
    and 65 rows: output, every gradient and d_src's live rows bit-equal to
    the graph unpadded, d_src's dead rows (and the pe entry's dz) exactly 0;
    the row check takes the dead tail at width 128 in bf16 and still raises
    for rows short of the CSR.
(b) bf16 MAgNet[GNN] at width 128 (1D on the fold, pe and pre-gathered
    lanes, 2D on the fold lane): training steps on graphs padded by the
    trainer against the same steps unpadded, loss and every gradient within
    1e-6 relative L2 (the encoders' edge MLPs run over more rows); the 1D
    fold step against the JAX bf16 model on its own graph at
    ``tests/test_torch_bf16_gnn.py``'s bounds (loss 1e-3 relative, every
    gradient 5e-2 relative L2 over all parameters, each 0.15 or twice the
    JAX package's own bf16-to-f32 distance where that is larger).
(c) A chunk of 4 bf16 MAgNet[GNN] 1D steps on padded graphs with new
    queries a batch, run eagerly through the trainer: each step's loss and
    gradients within 1e-6 relative L2 of the same chunk on unpadded graphs;
    at each step's weights, the loss within 1e-3 relative of the JAX bf16
    model's on the same batch and every gradient at
    ``tests/test_torch_bf16_gnn.py``'s bounds, all gradients together
    nearer the JAX bf16 model's than the JAX f32 model's; and the chunk's
    losses against the JAX trainer's ``steps_per_call=4`` chunk
    (``train_scan`` over the stacked graphs, asserted taken) from the same
    weights: the first within 1e-3 relative, every one within 1e-3 or
    twice the distance of the JAX bf16 chunk's loss from the JAX f32
    chunk's where that is larger (see below).
(d) ``Trainer.fit`` over two gloo ranks (dp = 2) of MAgNet[CNN] 1D with 4
    steps a call, under a CPU stand-in for the capture
    (``train.capture_checks.EagerStep``: the warm-up step runs, a capture
    executes nothing, a replay runs the step) and the capture rule read as
    on a CUDA device, one rank's edge buckets grown before its second
    chunk so that it re-keys its capture while the other replays: each
    rank calls ``all_reduce`` once a training step (and once an epoch for
    the metrics), the ranks end bit-equal, and the fit equals the same fit
    at one step a call (per-epoch losses within 1e-6 relative, the weights'
    update within 1e-4 relative L2: the padded steps' edge MLPs sum over
    more rows).
(e) The rule: chunks of bf16 MAgNet[GNN] 1D on the fold, pe and
    pre-gathered lanes at width 128 are padded on a CUDA device, over a
    mesh of ranks too (no reason).

The chunk's losses: both sides round to bf16 at the same points and sum
in f32 in another order, so a value can round to its neighbouring bf16
number (2^-8 relative); ``tests/test_torch_bf16_gnn.py`` holds one bf16
training loss at 1e-3 relative of JAX's, and each parameter gradient at
0.15 relative L2 or twice the JAX package's own bf16-to-f32 distance.
Adam's first update moves each weight by about the rate times the sign of
its gradient, so gradients that differ in bf16 move the later steps' loss
by far more than 1e-3: at this size the JAX bf16 chunk's second to fourth
losses lie 0.9%, 8% and 17% from the JAX f32 chunk's, the port's 0.8%,
3.6% and 2.8% from the JAX bf16 chunk's.  So each step is checked at its
own weights against the JAX model, and the chunk's later losses are held
at twice that bf16-to-f32 distance, as the gradients are (the f32
chunk's bound, 1e-5 absolute, ``tests/test_train.py``'s
``test_steps_per_call_parity``, holds in f32:
``tests/test_torch_padded_graph.py``).

Small trajectories made with numpy from a seed; the port's wrappers take
their plain versions on CPU tensors, the JAX models their plain
references.  One torch thread a module.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.train.import_torch import import_state_dict  # noqa: E402
from magnet_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from magnet_tpu_torch.data.datasets import (  # noqa: E402
    DatasetImplicit1D,
    DatasetImplicitGNN1D,
    DatasetImplicitGNN2D,
)
from magnet_tpu_torch.data.loader import DataLoader, collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    csr_from_edges,
    graph_signature,
    pad_edges,
)
from magnet_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from magnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402
from test_torch_bf16_gnn import _model_grads_close  # noqa: E402
from torch_ranks import captured_fit_rank  # noqa: E402

TAILS = (1, 64, 65)
W = 128
STEP_L2 = 1e-6
LOSS_RTOL = 1e-3
VS_JAX_BF16_TO_F32 = 2.0
DP_LOSS_RTOL, DP_UPDATE_L2 = 1e-6, 1e-4
K = 4
LR, FACTOR, STEP_SIZE = 1e-3, 0.3, 2
GNN_HP = dict(time_slice=8, latent_dim=W, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=W, n_chan=16, radius=0.15,
              codec_neighbors=4, noise=0.0, interpolation="area",
              teacher_forcing=True, loss="l1", graph_dtype="bf16")
GNN2D_HP = dict(GNN_HP, time_slice=4, radius=0.3)
CNN_HP = dict(time_slice=8, latent_dim=8, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=8, res_layers=1,
              kernel_size=3, res_scale=1, radius=0.15)
NT1, NX1 = 24, 64        # 1D: 2 windows of 8, 8 queries a sample
NT2, NODES2 = 16, 64     # 2D: 3 windows of 4, 16 queries a sample


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its ops are small, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


# ---- (a) the plain versions at width 128 on padded graphs ----------------

def _graph(seed, n=60):
    """A receiver-grouped graph of n nodes, degrees 0..8 (a few of 0)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, size=n)
    recv = np.repeat(np.arange(n), deg)
    send = rng.integers(0, n, size=len(recv))
    return csr_from_edges(torch.from_numpy(send), torch.from_numpy(recv), n)


def _operands(entry, graph, rows, seed):
    """The bf16 wrapper's operands of ``entry`` at width 128 (L1 = 2) with
    ``rows`` edge rows, NaN in the rows past the graph's edges, its
    integer operands those of ``graph``; and a cotangent g."""
    rng = np.random.default_rng(seed)
    n = graph.n_node

    def f(*shape, scale=0.3):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).bfloat16()

    src = f(rows, W)
    src[graph.n_edge:] = float("nan")
    tail = [f(2, W, W, scale=0.15), f(2, W), f(W, W, scale=0.15), f(W)]
    ln = [1 + f(W, scale=0.1).float(), f(W, scale=0.1).float()]
    if entry == "fold":
        ops = [src, f(W, W), f(W), f(n, W), f(n, W), graph.senders,
               graph.rowptr]
    elif entry == "pe":
        ops = [src, f(n, W), f(n, W), graph.senders, graph.rowptr,
               graph.snd_ptr, graph.snd_perm]
    else:
        ops = [src, f(n, W), graph.rowptr]
    g = torch.from_numpy(rng.normal(size=(n, W)).astype(np.float32))
    return ops + tail + ln, g


def _entry(entry):
    stem = {"fold": "fused_edge_tail_agg",
            "pregathered": "fused_edge_tail_agg_pregathered",
            "pe": "fused_edge_tail_agg_pe"}[entry] + "_bf16"
    return getattr(fe, stem), getattr(fe, f"{stem}_bwd")


@pytest.mark.parametrize("tail", TAILS)
def test_plain_bf16_width_128_entries_on_a_dead_tail_equal_unpadded(tail):
    graph = _graph(tail)
    E = graph.n_edge
    padded = pad_edges(graph, E + tail)
    for entry in ("fold", "pe", "pregathered"):
        fwd, bwd = _entry(entry)
        ops_p, g = _operands(entry, padded, E + tail, seed=tail)
        ops, _ = _operands(entry, graph, E + tail, seed=tail)
        ops[0] = ops_p[0][:E]
        assert torch.equal(fwd(*ops_p), fwd(*ops)), entry
        got, want = bwd(*ops_p, g), bwd(*ops, g)
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape[0] == E + tail:       # d_src, and the pe entry's dz
                assert torch.equal(a[:E], b), (entry, i)
                assert torch.equal(a[E:], torch.zeros_like(a[E:])), (entry, i)
            else:
                assert torch.equal(a, b), (entry, i)


def test_row_check_takes_a_bf16_width_128_dead_tail():
    graph = _graph(7)
    E = graph.n_edge
    padded = pad_edges(graph, E + 3)
    for entry in ("fold", "pe", "pregathered"):
        fwd, bwd = _entry(entry)
        ops, g = _operands(entry, padded, E + 3, seed=0)
        fwd(*ops)
        bwd(*ops, g)
        # rows short of the CSR: as many senders (and pe: sender CSR items)
        short = list(ops)
        for at in {"fold": (0, 5), "pe": (0, 3, 6),
                   "pregathered": (0,)}[entry]:
            short[at] = short[at][:E - 1]
        with pytest.raises(ValueError, match="edge rows"):
            fwd(*short)
        with pytest.raises(ValueError, match="edge rows"):
            bwd(*short, g)


# ---- (b), (c) bf16 MAgNet[GNN] steps at width 128 ------------------------

def _batches(case, n_batches, seed=3):
    """``n_batches`` training batches of 2 samples of ``case``'s model, new
    queries each (the dataset's epoch draws them)."""
    if case.startswith("gnn_2d"):
        rng = np.random.default_rng(seed)
        arrays = {
            "t": np.tile(np.linspace(0, 1, NT2, endpoint=False,
                                     dtype=np.float32), (2, 1)),
            "coords": rng.random(size=(2, NODES2, 2)).astype(np.float32),
            f"pde_{NT2}-{NODES2}": rng.normal(size=(2, NT2, NODES2))
            .astype(np.float32)}
        ds = DatasetImplicitGNN2D(arrays, "train", nt=NT2, res=8,
                                  regular=False, samples=16, n_nodes=NODES2)
    else:
        ds = DatasetImplicitGNN1D(make_split("Heat", 2, NT1, NX1, seed=seed),
                                  "train", nt=NT1, nx=NX1, samples=8)
    out = []
    for i in range(n_batches):
        ds.set_epoch(seed + i)
        out.append(collate([ds[0], ds[1]]))
    return out


#: (hyperparameters, datamodule kind, lane) by case
CASES = {"gnn_1d_fold": (GNN_HP, None, "kernel"),
         "gnn_1d_pe": (GNN_HP, None, "kernel_pe"),
         "gnn_1d_pregathered": (GNN_HP, None, "kernel_pregathered"),
         "gnn_2d_fold": (GNN2D_HP, "h5_implicit_gnn_2d", "kernel")}
_JAX: dict = {}


def _jax_model(dtype="bf16"):
    """The JAX MAgNet[GNN] 1D in ``dtype``, its parameters (the port's
    seeded init read by the JAX package's importer) and its jitted training
    loss and gradients."""
    if dtype not in _JAX:
        hp = dict(GNN_HP, graph_dtype=dtype if dtype == "bf16" else None)
        sd = create_model("magnet_gnn", GNN_HP, device="cpu",
                          seed=1).state_dict()
        params = import_state_dict("magnet_gnn", {k: v.numpy() for k, v in
                                                  sd.items()}, hp)
        jm = jax_create_model("magnet_gnn", hp)
        grads = jax.jit(jax.value_and_grad(
            lambda q, b, g: jm.loss(q, b, g, train=True), has_aux=True))
        _JAX[dtype] = jm, jax.tree.map(np.asarray, params), grads
    return _JAX[dtype]


def _trainer(case, tmp_path, k=K):
    """The port's bf16 MAgNet[GNN] of ``case`` (seed 1, the JAX model's
    weights in 1D) on its lane, in a CPU trainer whose optimizer is set up
    for 4 steps an epoch."""
    hp, kind, impl = CASES[case]
    model = create_model("magnet_gnn", hp, device="cpu", seed=1, kind=kind)
    model.impl = impl
    tr = Trainer(model, max_epochs=2, lr=LR, factor=FACTOR,
                 step_size=STEP_SIZE, workdir=str(tmp_path), device="cpu",
                 steps_per_call=k)
    tr.setup(K)
    return tr


def _loss_and_grads(model, batch, graph):
    model.train()
    model.zero_grad()
    loss, _ = model.loss(batch, graph, train=True)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_bf16_step_equals_unpadded_and_jax(case, tmp_path):
    """(b): two batches with new queries, padded in one chunk, against
    unpadded; the first 1D fold step against the JAX bf16 model."""
    tr = _trainer(case, tmp_path)
    model = tr.model
    pairs = [tr._host_pair(b) for b in _batches(case, 2)]
    padded = tr._padded([g for _, g in pairs])
    lane = {"kernel": "fold", "kernel_pe": "pe",
            "kernel_pregathered": "pregathered"}[CASES[case][2]]
    for i, ((batch, graph), pgraph) in enumerate(zip(pairs, padded)):
        for role, part in model.graph_parts(pgraph).items():
            assert int(part.rowptr[-1]) == model.graph_parts(
                graph)[role].n_edge < part.n_edge
        assert model.graph_lanes(pgraph) == {(lane, "bf16", W)}
        want_loss, want = _loss_and_grads(model, batch, graph)
        loss, grads = _loss_and_grads(model, batch, pgraph)
        assert _rel_l2(loss, want_loss) <= STEP_L2
        for n in want:
            assert _rel_l2(grads[n], want[n]) <= STEP_L2, n
        if i or case != "gnn_1d_fold":
            continue
        jm, params, jax_grads = _jax_model()
        host = {k: v.numpy() for k, v in batch.items()}
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        (jloss, _), jgrads = jax_grads(params, jb, jm.build_graph(host))
        assert abs(float(loss) - float(jloss)) < LOSS_RTOL * float(jloss)
        for n, p in model.named_parameters():
            p.grad = grads[n]

        def f32_grads():
            jm32, params32, grads32 = _jax_model("f32")
            return grads32(params32, jb, jm32.build_graph(host))[1]

        _model_grads_close(model, jgrads, f32_grads, GNN_HP, 1)


def _jax_chunk(batches, dtype, tmp_path):
    """The per-step losses of the JAX trainer's ``steps_per_call=K`` chunk
    of MAgNet[GNN] 1D in ``dtype`` over ``batches`` (``train_scan`` over
    the stacked graphs, asserted taken)."""
    jm, params, _ = _jax_model(dtype)
    jt = JaxTrainer(jm, max_epochs=2, lr=LR, factor=FACTOR,
                    step_size=STEP_SIZE, workdir=str(tmp_path / dtype),
                    steps_per_call=K)
    jt._build_steps(K)
    buf = [(b, jt._build_graph(b)) for b in batches]
    assert all(jt._sig(p) == jt._sig(buf[0]) for p in buf[1:])
    scans = []
    scan = jt._train_scan
    jt._train_scan = lambda *a: scans.append(1) or scan(*a)
    pending = []
    p = jax.tree.map(jnp.asarray, params)
    jt._run_chunk(buf, p, jt._tx.init(p), jax.random.PRNGKey(0), pending)
    assert scans == [1] and len(pending) == 1
    losses = np.asarray(pending[0]["loss"], np.float64)
    assert losses.shape == (K,)
    return losses


def _jax_step(dtype, model, batch):
    """The JAX MAgNet[GNN] 1D's training loss and gradients in ``dtype``
    on ``batch`` (its own graph) at the port model's current weights, as
    a port state dict."""
    jm, _, grads = _jax_model(dtype)
    hp = dict(GNN_HP, graph_dtype=dtype if dtype == "bf16" else None)
    params = import_state_dict("magnet_gnn", {
        k: v.numpy() for k, v in model.state_dict().items()}, hp)
    host = {k: v.numpy() for k, v in batch.items()}
    (loss, _), d_p = grads(params, {k: jnp.asarray(v) for k, v in
                                    host.items()}, jm.build_graph(host))
    return float(loss), d_p


def _flat_l2(grads, want, names):
    got = np.concatenate([grads[n].numpy().ravel() for n in names])
    ref = np.concatenate([want[n].numpy().ravel() for n in names])
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_chunk_of_padded_bf16_steps_equals_the_jax_scan(tmp_path):
    """(c): one chunk of K bf16 MAgNet[GNN] 1D batches with new queries
    each, on the fold lane at width 128: padded against the same chunk
    unpadded, each step against the JAX bf16 model at the chunk's weights,
    and the chunk's losses against the JAX ``train_scan``."""
    batches = _batches("gnn_1d_fold", K, seed=5)
    trainers = {run: _trainer("gnn_1d_fold", tmp_path / run)
                for run in ("padded", "unpadded")}
    pairs = [trainers["padded"]._host_pair(b) for b in batches]
    graphs = {"unpadded": [g for _, g in pairs],
              "padded": trainers["padded"]._padded([g for _, g in pairs])}
    assert len({graph_signature(g) for g in graphs["padded"]}) == 1
    assert len({g.all.n_edge for _, g in pairs}) > 1   # the graphs differ
    model = trainers["padded"].model
    names = [n for n, _ in model.named_parameters()]
    losses = []
    for i, (batch, _) in enumerate(pairs):
        jloss, d_p = _jax_step("bf16", model, batch)
        _, d_p32 = _jax_step("f32", model, batch)
        step = {}
        for run, tr in trainers.items():
            step[run] = _loss_and_grads(tr.model, batch, graphs[run][i])
            tr.device_step(batch, graphs[run][i])
        (loss, grads), (want_loss, want) = step["padded"], step["unpadded"]
        assert _rel_l2(loss, want_loss) <= STEP_L2, i
        for n in names:
            assert _rel_l2(grads[n], want[n]) <= STEP_L2, (i, n)
        losses.append(float(loss))
        # the port's step against the JAX bf16 model's at the same weights
        # and batch: the loss at LOSS_RTOL, every gradient at
        # test_torch_bf16_gnn's bounds, and all of them nearer the JAX bf16
        # model's than the JAX f32 model's
        assert abs(losses[-1] - jloss) < LOSS_RTOL * abs(jloss), i
        for n, p in model.named_parameters():
            p.grad = grads[n]
        _model_grads_close(model, d_p, lambda: d_p32, GNN_HP, 1)
        jax_grads = {dt: state_dict_from_jax(
            jax.tree.map(np.asarray, d), GNN_HP, "magnet_gnn", pos_dim=1)
            for dt, d in (("bf16", d_p), ("f32", d_p32))}
        assert (_flat_l2(grads, jax_grads["bf16"], names)
                < _flat_l2(grads, jax_grads["f32"], names)), i
    # the chunk's losses against the JAX train_scan's: the first (the same
    # weights) at LOSS_RTOL, every one within twice the JAX bf16 chunk's
    # distance from its f32 chunk (Adam's sign flips, module docstring)
    losses = np.array(losses)
    want = _jax_chunk(batches, "bf16", tmp_path)
    f32 = _jax_chunk(batches, "f32", tmp_path)
    assert abs(losses[0] - want[0]) < LOSS_RTOL * abs(want[0])
    bound = np.maximum(LOSS_RTOL * np.abs(want),
                       VS_JAX_BF16_TO_F32 * np.abs(want - f32))
    assert (np.abs(losses - want) < bound).all(), (losses, want, f32)


# ---- (d) a captured dp fit over two gloo ranks ----------------------------

def _cnn_loaders():
    """16 Heat trajectories in global batches of 4: 4 steps an epoch, new
    queries every batch."""
    ds = DatasetImplicit1D(make_split("Heat", 16, NT1, NX1, seed=9),
                           "train", nt=NT1, nx=NX1, samples=8)
    return {"train": DataLoader(ds, batch_size=4, shuffle=False)}


def test_captured_dp_fit_keeps_one_all_reduce_a_step(tmp_path):
    state = {k: v.clone() for k, v in
             create_model("magnet_cnn", CNN_HP, device="cpu",
                          seed=4).state_dict().items()}
    loaders = _cnn_loaders()
    steps = 2 * len(loaders["train"])
    assert steps == 8
    base = {"model": "magnet_cnn", "hp": CNN_HP, "state": state, "dp": 2,
            "loaders": loaders, "max_epochs": 2, "lr": LR, "device": "cpu",
            "grow_rank": 1}
    specs = [dict(base, workdir=str(tmp_path / "k1")),
             dict(base, workdir=str(tmp_path / "k4"), steps_per_call=K)]
    out = run_ranks(captured_fit_rank, 2, (specs,), device="cpu")
    (k1_r0, k4_r0), (k1_r1, k4_r1) = out
    for fit in (k1_r0, k4_r0, k1_r1, k4_r1):
        # one all-reduce a training step, one an epoch for the metrics
        assert fit["all_reduces"] == steps + 2
    assert k1_r0["step_counts"] == k1_r1["step_counts"] == {
        "eager": steps, "captured": 0, "replayed": 0}
    # rank 0 warms up and captures once and replays the rest; rank 1's
    # grown bucket re-keys its capture at its second chunk
    assert k4_r0["step_counts"] == {"eager": 1, "captured": 1,
                                    "replayed": steps - 1}
    assert k4_r1["step_counts"] == {"eager": 2, "captured": 2,
                                    "replayed": steps - 2}
    for a, b in ((k1_r0, k1_r1), (k4_r0, k4_r1)):
        for k in a["state"]:
            np.testing.assert_array_equal(a["state"][k], b["state"][k])
    rows = {}
    for run in ("k1", "k4"):
        with open(os.path.join(tmp_path, run, "metrics.jsonl")) as f:
            rows[run] = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows["k4"]] == [0, 1]
    for a, b in zip(rows["k4"], rows["k1"]):
        assert abs(a["train_loss"] - b["train_loss"]) <= (
            DP_LOSS_RTOL * abs(b["train_loss"]))
    keys = sorted(state)
    flat = lambda d: np.concatenate([np.ravel(d[k]) for k in keys])  # noqa: E731
    init = flat({k: v.numpy() for k, v in state.items()})
    got, want = flat(k4_r0["state"]), flat(k1_r0["state"])
    assert np.linalg.norm(got - want) <= DP_UPDATE_L2 * np.linalg.norm(
        want - init)


# ---- (e) the rule ----------------------------------------------------------

def test_bf16_width_128_chunks_are_padded_over_ranks_too(tmp_path):
    """On a CUDA device (the rule reads nothing else of it), alone and in a
    world of 2 ranks."""
    for case in ("gnn_1d_fold", "gnn_1d_pe", "gnn_1d_pregathered"):
        tr = _trainer(case, tmp_path / case)
        pairs = [tr._host_pair(b) for b in _batches(case, K)]
        assert len({g.all.n_edge for _, g in pairs}) > 1
        tr.device = torch.device("cuda")
        assert tr._uncaptured(pairs) is None, case
        tr.world = 2
        assert tr._uncaptured(pairs) is None, case
