"""Captured chunks over graphs that differ (``steps_per_call`` with new
query points a batch, the JAX trainer's ``train_scan`` over stacked
graphs): graphs padded past the end of their CSR (``ops.graph.pad_edges``)
to sticky edge buckets (``EdgeBuckets``), on the CPU.

(a) The plain #8/#9 (``fused_edge_tail_agg`` and its backward) at both
    kernel widths on graphs with dead tails of 1, 63, 64, 65 and 130 rows
    against the same graphs unpadded: output, weight and node gradients
    and d_e0's live rows bit-equal, d_e0's dead rows exactly 0 (the plain
    versions read the first rowptr[-1] rows, as the kernels do on the
    card); the row check takes rowptr[-1] <= E and still raises past E,
    in every build (the bf16 ones at both widths too).
(b) A MAgNet[CNN] 1D and a MAgNet[GNN] 1D training step on graphs padded
    by the trainer against the same step unpadded: loss and every gradient
    within 1e-6 relative L2 (the encoders' edge MLPs run over more rows,
    the one difference).
(c) The padded steps against the JAX models on their own graphs for the
    same batches and weights: ``tests/test_torch_train.py``'s step bounds
    (loss rtol 1e-4, atol 1e-5; gradients rtol 2e-3, atol 1e-5 of each
    leaf's largest entry).
(d) A chunk of 4 padded steps with new queries a batch, run eagerly
    through the trainer, against the JAX trainer's ``steps_per_call=4``
    chunk (``train_scan`` over the stacked graphs, asserted taken): each
    step's loss within 1e-5, the fit bound of ``tests/test_train.py``'s
    ``test_steps_per_call_parity``.
(e) The bucket rule (sticky, multiples of 1,024, a larger bucket another
    signature and so another capture key), the graph signature (what
    shares a capture; a lane that differs is another signature, the plain
    lane a reason) and k = 1 leaving graphs unpadded.

Small widths; the port's wrappers take their plain versions on CPU
tensors, the JAX models their plain references.
"""
import dataclasses

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
)
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    EDGE_BUCKET,
    EdgeBuckets,
    csr_from_edges,
    graph_signature,
    pad_edges,
)
from magnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

TAILS = (1, 63, 64, 65, 130)
WIDTHS = ((32, 64, 32), (128, 128, 128))
NT, NX = 24, 64      # 2 windows of 8; 4 samples a batch, 8 queries each
CNN_HP = dict(time_slice=8, latent_dim=8, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=8, res_layers=1,
              kernel_size=3, res_scale=1, radius=0.15)
GNN_HP = dict(time_slice=8, latent_dim=16, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=16, radius=0.15,
              codec_neighbors=4, noise=0.0, interpolation="area",
              teacher_forcing=True, loss="l1")
MODELS = {"magnet_cnn": (CNN_HP, DatasetImplicit1D),
          "magnet_gnn": (GNN_HP, DatasetImplicitGNN1D)}
STEP_L2 = 1e-6
LOSS = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 2e-3, 1e-5
FIT_ATOL = 1e-5
K = 4
LR, FACTOR, STEP_SIZE = 1e-3, 0.3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its ops are small, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- (a) the plain #8/#9 on padded graphs ---------------------------------

def _graph(seed=0, n=60):
    """A receiver-grouped graph of n nodes, degrees 0..8 (a few of 0)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, size=n)
    recv = np.repeat(np.arange(n), deg)
    send = rng.integers(0, n, size=len(recv))
    return csr_from_edges(torch.from_numpy(send), torch.from_numpy(recv), n)


def _operands(graph, ce, h, c, e_rows, seed):
    """The fold entry's float operands (L1 = 2) with e0 of ``e_rows`` rows
    (the rows past the graph's edges random too) and a cotangent g."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.3):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    n = graph.n_node
    e0 = t(e_rows, ce)
    floats = [e0, t(ce, h), t(h), t(n, h), t(n, h), t(2, h, h, scale=0.15),
              t(2, h), t(h, c, scale=0.15), t(c), 1 + t(c), t(c)]
    return floats, t(n, c, scale=1.0)


def _fold(floats, graph):
    e0, we, be, pxj, pxi, *tail = floats
    return (e0, we, be, pxj, pxi, graph.senders, graph.rowptr, *tail)


@pytest.mark.parametrize("widths", WIDTHS, ids=["w64", "w128"])
@pytest.mark.parametrize("tail", TAILS)
def test_plain_fold_on_a_dead_tail_equals_the_graph_unpadded(widths, tail):
    graph = _graph()
    padded = pad_edges(graph, graph.n_edge + tail)
    E = graph.n_edge
    assert padded.n_edge == E + tail and int(padded.rowptr[-1]) == E
    floats, g = _operands(padded, *widths, E + tail, seed=tail)
    e0 = floats[0]
    want_out = fe.fused_edge_tail_agg(*_fold([e0[:E]] + floats[1:], graph))
    got_out = fe.fused_edge_tail_agg(*_fold(floats, padded))
    assert torch.equal(got_out, want_out)
    want = fe.fused_edge_tail_agg_bwd(*_fold([e0[:E]] + floats[1:], graph), g)
    got = fe.fused_edge_tail_agg_bwd(*_fold(floats, padded), g)
    for name, a, b in zip(fe.GRAD_NAMES, got, want):
        if name == "e0":
            assert torch.equal(a[:E], b), name
            assert torch.equal(a[E:], torch.zeros_like(a[E:])), name
        else:
            assert torch.equal(a, b), name


def test_row_check_takes_a_dead_tail_and_raises_past_the_rows():
    graph = _graph(1)
    E = graph.n_edge
    padded = pad_edges(graph, E + 5)
    floats, _ = _operands(padded, 32, 64, 32, E + 5, seed=0)
    fe.fused_edge_tail_agg(*_fold(floats, padded))           # E + 5 rows
    h0 = floats[0].new_zeros(E + 5, 64)
    tail = floats[5:]
    fe.fused_edge_tail_agg_pregathered(h0, floats[4], padded.rowptr, *tail)
    short = [floats[0][:E - 1]] + floats[1:]
    with pytest.raises(ValueError, match="edge rows"):
        fe.fused_edge_tail_agg(short[0], *short[1:5],
                               padded.senders[:E - 1], padded.rowptr,
                               *short[5:])
    with pytest.raises(ValueError, match="edge rows"):
        fe.fused_edge_tail_agg_pregathered(h0[:E - 1], floats[4],
                                           padded.rowptr, *tail)
    # the bf16 builds read the live count too, at both widths
    bf = [t.bfloat16() if i not in (9, 10) else t
          for i, t in enumerate(floats)]
    fe.fused_edge_tail_agg_bf16(*_fold(bf, padded))
    wide, _ = _operands(padded, 128, 128, 128, E + 5, seed=0)
    wide = [t.bfloat16() if i not in (9, 10) else t
            for i, t in enumerate(wide)]
    fe.fused_edge_tail_agg_bf16(*_fold(wide, padded))
    with pytest.raises(ValueError, match="edge rows"):
        fe.fused_edge_tail_agg_bf16(wide[0][:E - 1], *_fold(wide, padded)[1:5],
                                    padded.senders[:E - 1], padded.rowptr,
                                    *wide[5:])


def test_pad_edges_keeps_the_csr_and_pads_with_self_loops():
    graph = _graph(2)
    E, n = graph.n_edge, graph.n_node
    padded = pad_edges(graph, E + 7)
    for name in ("rowptr", "degree", "snd_ptr"):
        assert torch.equal(getattr(padded, name), getattr(graph, name))
    for name in ("senders", "receivers", "snd_perm"):
        assert torch.equal(getattr(padded, name)[:E], getattr(graph, name))
    assert torch.equal(padded.senders[E:], torch.full((7,), n - 1,
                                                      dtype=torch.int32))
    assert torch.equal(padded.receivers[E:], padded.senders[E:])
    assert torch.equal(padded.snd_perm[E:],
                       torch.arange(E, E + 7, dtype=torch.int32))
    assert pad_edges(graph, E) is graph
    with pytest.raises(ValueError):
        pad_edges(graph, E - 1)


# ---- (b)-(d) the models' training steps -----------------------------------

def _batches(name, n_batches, seed=3):
    """``n_batches`` training batches of 4 samples, new queries each (the
    dataset's epoch draws them)."""
    hp, dataset = MODELS[name]
    ds = dataset(make_split("Heat", 4, NT, NX, seed=seed), "train", nt=NT,
                 nx=NX, samples=8)
    out = []
    for i in range(n_batches):
        ds.set_epoch(seed + i)
        out.append(collate([ds[j] for j in range(4)]))
    return out


_JAX: dict = {}


def _jax_model(name):
    """The JAX model, its parameters and its jitted training loss and
    gradients.  The parameters are the port's seeded init read by the JAX
    package's importer (no JAX init to compile); the port's models load
    them back through ``state_dict_from_jax``."""
    if name not in _JAX:
        hp = MODELS[name][0]
        sd = create_model(name, hp, device="cpu", seed=1).state_dict()
        params = import_state_dict(name, {k: v.numpy() for k, v in
                                          sd.items()}, hp)
        jm = jax_create_model(name, hp)
        grads = jax.jit(jax.value_and_grad(
            lambda q, b, g: jm.loss(q, b, g, train=True), has_aux=True))
        _JAX[name] = jm, jax.tree.map(np.asarray, params), grads
    return _JAX[name]


def _trainer(name, tmp_path, k=K):
    """The port's model with the JAX model's weights, in a CPU trainer
    whose optimizer is set up for 4 steps an epoch."""
    hp = MODELS[name][0]
    params = _jax_model(name)[1]
    model = create_model(name, hp, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, hp, name))
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


def _rel_l2(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_padded_step_equals_unpadded_and_jax(name, tmp_path):
    """(b) on two batches with new queries, padded in one chunk, and (c) on
    the first."""
    tr = _trainer(name, tmp_path)
    model = tr.model
    pairs = [tr._host_pair(b) for b in _batches(name, 2)]
    padded = tr._padded([g for _, g in pairs])
    jm, params, jax_grads = _jax_model(name)
    hp = MODELS[name][0]
    for i, ((batch, graph), pgraph) in enumerate(zip(pairs, padded)):
        parts, pparts = model.graph_parts(graph), model.graph_parts(pgraph)
        assert set(parts) == ({"all"} if name == "magnet_cnn"
                              else {"lr", "all"})
        for role in parts:
            g, p = parts[role], pparts[role]
            assert p.n_edge % EDGE_BUCKET == 0
            assert int(p.rowptr[-1]) == g.n_edge < p.n_edge
            assert p.n_edge == tr.buckets.edges[role]
        assert model.graph_lanes(pgraph) == {("fold", "f32", 16)}
        want_loss, want = _loss_and_grads(model, batch, graph)
        loss, grads = _loss_and_grads(model, batch, pgraph)
        assert _rel_l2(loss, want_loss) <= STEP_L2
        for n in want:
            assert _rel_l2(grads[n], want[n]) <= STEP_L2, n
        if i:
            continue
        # (c) against the JAX model on its own graph
        host = {k: v.numpy() for k, v in batch.items()}
        (jloss, _), jgrads = jax_grads(
            params, {k: jnp.asarray(v) for k, v in host.items()},
            jm.build_graph(host))
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
        got = import_state_dict(name, {n: g.numpy() for n, g in
                                       grads.items()}, hp)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves_with_path(jgrads)):
            b = np.asarray(b)
            np.testing.assert_allclose(
                np.asarray(a), b, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_REL * max(float(np.abs(b).max()), 1.0),
                err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chunk_of_padded_steps_equals_the_jax_scan(name, tmp_path):
    """(d): one chunk of K batches with new queries each."""
    batches = _batches(name, K, seed=5)
    tr = _trainer(name, tmp_path / "port")
    pairs = [tr._host_pair(b) for b in batches]
    graphs = tr._padded([g for _, g in pairs])
    assert len({graph_signature(g) for g in graphs}) == 1
    losses = [float(tr.device_step(b, g)["loss"])
              for (b, _), g in zip(pairs, graphs)]

    jm, params, _ = _jax_model(name)
    jt = JaxTrainer(jm, max_epochs=2, lr=LR, factor=FACTOR,
                    step_size=STEP_SIZE, workdir=str(tmp_path / "jax"),
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
    want = np.asarray(pending[0]["loss"])
    assert want.shape == (K,)
    np.testing.assert_allclose(losses, want, rtol=0, atol=FIT_ATOL)


# ---- (e) buckets, signatures, the rule ------------------------------------

def test_edge_buckets_are_sticky_multiples_that_rekey():
    b = EdgeBuckets()
    assert b.grow("all", 1) == EDGE_BUCKET
    assert b.grow("all", 3000) == 3 * EDGE_BUCKET
    assert b.grow("all", 100) == 3 * EDGE_BUCKET          # never shrinks
    assert b.grow("all", 3 * EDGE_BUCKET) == 3 * EDGE_BUCKET
    assert b.grow("lr", 5) == EDGE_BUCKET                 # its own role
    graph = _graph(3)
    small = b.pad("lr", graph)
    assert small.n_edge == EDGE_BUCKET
    bigger = pad_edges(graph, 2 * EDGE_BUCKET)
    assert graph_signature(small) != graph_signature(bigger)
    assert (graph_signature(small, edges=False)
            == graph_signature(bigger, edges=False))


def test_graphs_on_another_lane_or_signature_give_a_reason(tmp_path):
    """A chunk of MAgNet[CNN] 1D graphs with new queries, on a CUDA device
    (``tests/test_torch_steps_per_call.py`` holds the rule's other
    reasons): a graph on another lane (another signature), or with other
    node rows, and a model on the plain versions, each give their
    reason."""
    tr = _trainer("magnet_cnn", tmp_path)
    pairs = [tr._host_pair(b) for b in _batches("magnet_cnn", K)]
    tr.device = torch.device("cuda")      # the rule reads nothing else of it
    assert tr._uncaptured(pairs) is None
    batch, graph = pairs[1]
    other = dataclasses.replace(graph, lane="pregathered")
    # a lane that reads the live count too, but another signature
    assert tr._uncaptured(pairs[:1] + [(batch, other)] + pairs[2:]) == (
        "the chunk's graph signatures differ")
    wide = tr._host_pair(_batches("magnet_cnn", 1, seed=9)[0])
    wide = (wide[0], dataclasses.replace(
        csr_from_edges(wide[1].senders, wide[1].receivers,
                       wide[1].n_node + 1, layout=wide[1].layout),
        lane="fold"))
    assert tr._uncaptured(pairs[:3] + [wide]) == (
        "the chunk's graph signatures differ")
    tr.model.impl = "plain"
    assert tr._uncaptured(pairs) == (
        "the chunk's graphs differ, on the plain lane in f32 at width 16")


@pytest.mark.parametrize("k", [1, K])
def test_steps_on_the_cpu_keep_their_graphs_unpadded(k, tmp_path):
    tr = _trainer("magnet_cnn", tmp_path, k=k)
    seen = []
    step = tr.device_step
    tr.device_step = lambda b, g: seen.append(g) or step(b, g)
    tr._run_chunk([tr._host_pair(b) for b in _batches("magnet_cnn", k)])
    assert len(seen) == k and tr.host_graph["padded"] == 0
    assert all(int(g.rowptr[-1]) == g.n_edge for g in seen)
    assert tr.host_graph["built"] == k
