"""Captured chunks over graphs that differ on every lane whose kernels read
a padded graph's live edge count: the f32 fold, pe and pre-gathered
entries at either width and the bf16 ones at width 64, with the segment sum
#1 under the pre-gathered lane's sender gather and the pe lane's d_pxj, on
the CPU.

(a) ``segment_sum`` and ``gather_rows``' backward over a padded sender CSR
    (``snd_ptr`` ending at the live edges, ``snd_perm`` listing the dead
    rows after them) against the graph unpadded, bit for bit, in f32 and
    bf16; ``ptr[-1]`` past the items still raises.
(b) The plain f32 pre-gathered and pe entries at (H, C) = (64, 32) and
    (128, 128) and the plain bf16 fold, pre-gathered and pe entries at
    width 64 on dead tails of 1, 64 and 65 rows: output, every gradient and
    d_src's live rows bit-equal to the graph unpadded, d_src's dead rows
    exactly 0; a bf16 width-128 entry takes a dead tail too (its kernels
    read the live count) and still raises past the rows.
(c) Training steps on graphs padded by the trainer against the same steps
    unpadded (loss and every gradient within 1e-6 relative L2: the edge
    MLPs run over more rows) and against the JAX model on its own graph at
    ``tests/test_torch_train.py``'s step bounds (loss rtol 1e-4, atol 1e-5;
    gradients rtol 2e-3, atol 1e-5 of each leaf's largest entry): MAgNet[CNN]
    2D in f32 on the pre-gathered lane (its published training graph's;
    forced at this size, where the JAX model takes the fold lane: the same
    sums in another order, ``tests/test_torch_cnn2d.py``) and MAgNet[GNN]
    2D (P = 2, the fold lane); MAgNet[CNN] 1D in bf16 at
    ``tests/test_torch_bf16.py``'s bounds (loss 1e-3 relative, each
    gradient 0.15 and all of them 5e-2 relative L2); MAgNet[CNN] 1D on
    ``kernel_pe`` and MAgNet[GNN] 1D on ``kernel_pregathered`` padded
    against unpadded.
(d) A chunk of 4 MAgNet[CNN] 2D steps on padded graphs with new queries a
    batch, run eagerly through the trainer, against the JAX trainer's
    ``steps_per_call=4`` chunk (``train_scan`` over the stacked graphs,
    asserted taken): each step's loss within atol 1e-5, the fit bound of
    ``tests/test_train.py``'s ``test_steps_per_call_parity``.
(e) The rule: chunks on the f32 fold, pe and pre-gathered lanes and on the
    bf16 lanes at widths 64 and 128 are padded (no reason); the plain
    versions give a reason naming lane, dtype and width.

Small widths, a few trajectories made with numpy from a seed; the port's
wrappers take their plain versions on CPU tensors, the JAX models their
plain references.  One torch thread a module.
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
    DatasetImplicit2D,
    DatasetImplicitGNN1D,
    DatasetImplicitGNN2D,
)
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    csr_from_edges,
    graph_signature,
    pad_edges,
)
from magnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

TAILS = (1, 64, 65)
STEP_L2 = 1e-6
LOSS = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 2e-3, 1e-5
BF16_LOSS_RTOL, BF16_PARAM_L2, BF16_MODEL_L2 = 1e-3, 0.15, 5e-2
FIT_ATOL = 1e-5
K = 4
LR, FACTOR, STEP_SIZE = 1e-3, 0.3, 2
GNN2D_KIND = "h5_implicit_gnn_2d"
CNN_HP = dict(time_slice=8, latent_dim=8, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=8, res_layers=1,
              kernel_size=3, res_scale=1, radius=0.15)
CNN2D_HP = dict(time_slice=4, latent_dim=8, num_message_passing_steps=2,
                mlp_layers=2, mlp_hidden=16, n_chan=8, res_layers=1,
                radius=0.5, teacher_forcing=True, loss="l1")
GNN_HP = dict(time_slice=8, latent_dim=16, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=16, radius=0.15,
              codec_neighbors=4, noise=0.0, interpolation="area",
              teacher_forcing=True, loss="l1")
GNN2D_HP = dict(GNN_HP, time_slice=4, radius=0.3)
NT1, NX1 = 24, 64        # 1D: 2 windows of 8, 8 queries a sample
NT2, RES2 = 12, 8        # MAgNet[CNN] 2D: 2 windows of 4, 6 queries
NT3, NODES3 = 16, 64     # MAgNet[GNN] 2D: 3 windows of 4, 16 queries


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


# ---- (a), (b) the kernels' plain versions on padded graphs ---------------

def _graph(seed=0, n=60):
    """A receiver-grouped graph of n nodes, degrees 0..8 (a few of 0)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, size=n)
    recv = np.repeat(np.arange(n), deg)
    send = rng.integers(0, n, size=len(recv))
    return csr_from_edges(torch.from_numpy(send), torch.from_numpy(recv), n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_segment_sum_on_a_padded_sender_csr_equals_unpadded(dtype):
    graph = _graph(4)
    E = graph.n_edge
    padded = pad_edges(graph, E + 70)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(E, 24)).astype(np.float32)).to(dtype)
    x_p = torch.cat([x, torch.full((70, 24), float("nan"), dtype=dtype)])
    want = seg.segment_sum(x, graph.snd_ptr, graph.snd_perm)
    got = seg.segment_sum(x_p, padded.snd_ptr, padded.snd_perm)
    assert torch.equal(got, want)
    # the sender gather's backward, through autograd
    p = torch.from_numpy(rng.normal(size=(graph.n_node, 24))
                         .astype(np.float32)).to(dtype)
    grads = []
    for g, rows in ((graph, x), (padded, x_p.nan_to_num(0.0))):
        leaf = p.clone().requires_grad_()
        out = seg.gather_rows(leaf, g)
        assert out.shape[0] == g.n_edge
        out.backward(rows)
        grads.append(leaf.grad)
    assert torch.equal(grads[1], grads[0])
    with pytest.raises(ValueError, match="items"):
        seg.segment_sum(x[:E - 1], graph.snd_ptr, graph.snd_perm[:E - 1])


def _floats(rng, shapes, scale=0.3):
    return [torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
            for s in shapes]


def _entry_operands(entry, graph, h, c, rows, seed, bf16):
    """The wrapper's operands of ``entry`` (fold at (Ce, H, C) = (32, H,
    C), pe, pre-gathered at (H, C); L1 = 2) with ``rows`` edge rows, its
    integer operands those of ``graph``; and a cotangent g."""
    rng = np.random.default_rng(seed)
    n, ce = graph.n_node, 32
    tail = _floats(rng, [(2, h, h), (2, h), (h, c), (c,)], 0.15)
    ln = [1 + _floats(rng, [(c,)], 0.1)[0], _floats(rng, [(c,)], 0.1)[0]]
    if entry == "fold":
        e0, we, be, pxj, pxi = _floats(rng, [(rows, ce), (ce, h), (h,),
                                             (n, h), (n, h)])
        ops = [e0, we, be, pxj, pxi, graph.senders, graph.rowptr]
    elif entry == "pe":
        pe, pxj, pxi = _floats(rng, [(rows, h), (n, h), (n, h)])
        ops = [pe, pxj, pxi, graph.senders, graph.rowptr, graph.snd_ptr,
               graph.snd_perm]
    else:
        h0, pxi = _floats(rng, [(rows, h), (n, h)])
        ops = [h0, pxi, graph.rowptr]
    ops += tail + ln
    if bf16:
        ops = [t.bfloat16() if t.is_floating_point() and i < len(ops) - 2
               else t for i, t in enumerate(ops)]
    g = _floats(rng, [(n, c)], 1.0)[0]
    return ops, g


#: (entry, bf16, (H, C)) of the forms (b) holds
PLAIN_FORMS = [("pregathered", False, (64, 32)), ("pe", False, (64, 32)),
               ("pregathered", False, (128, 128)), ("pe", False, (128, 128)),
               ("fold", True, (64, 32)), ("pregathered", True, (64, 32)),
               ("pe", True, (64, 32))]


def _pair(entry, bf16):
    stem = {"fold": "fused_edge_tail_agg",
            "pregathered": "fused_edge_tail_agg_pregathered",
            "pe": "fused_edge_tail_agg_pe"}[entry] + ("_bf16" if bf16 else "")
    return getattr(fe, stem), getattr(fe, f"{stem}_bwd")


@pytest.mark.parametrize("tail", TAILS)
def test_plain_entries_on_a_dead_tail_equal_the_graph_unpadded(tail):
    graph = _graph(tail)
    E = graph.n_edge
    padded = pad_edges(graph, E + tail)
    for entry, bf16, (h, c) in PLAIN_FORMS:
        fwd, bwd = _pair(entry, bf16)
        ops_p, g = _entry_operands(entry, padded, h, c, E + tail, tail, bf16)
        ops, _ = _entry_operands(entry, graph, h, c, E + tail, tail, bf16)
        ops[0] = ops_p[0][:E]
        form = f"{entry} {'bf16' if bf16 else 'f32'} {h}"
        assert torch.equal(fwd(*ops_p), fwd(*ops)), form
        got, want = bwd(*ops_p, g), bwd(*ops, g)
        assert torch.equal(got[0][:E], want[0]), form
        assert torch.equal(got[0][E:], torch.zeros_like(got[0][E:])), form
        for i, (a, b) in enumerate(zip(got[1:], want[1:])):
            assert torch.equal(a, b), (form, i)


def test_a_bf16_width_128_entry_refuses_a_dead_tail():
    """Since the width-128 bf16 kernels read the live count, their entries
    take a dead tail (the plain versions' bits on it: ``tests/
    test_torch_padded_bf16w128.py``) and refuse only rows short of the
    CSR."""
    graph = _graph(7)
    E = graph.n_edge
    padded = pad_edges(graph, E + 3)
    for entry in ("fold", "pregathered", "pe"):
        fwd, bwd = _pair(entry, True)
        ops, g = _entry_operands(entry, padded, 128, 128, E + 3, 0, True)
        if entry == "fold":
            ops[0] = ops[0].new_zeros(E + 3, 128)
            ops[1] = ops[1].new_zeros(128, 128)
        fwd(*ops)
        bwd(*ops, g)
        # as many senders (and pe: sender CSR items) as rows
        short = list(ops)
        for at in {"fold": (0, 5), "pe": (0, 3, 6), "pregathered": (0,)}[entry]:
            short[at] = short[at][:E - 1]
        with pytest.raises(ValueError, match="edge rows"):
            fwd(*short)
        with pytest.raises(ValueError, match="edge rows"):
            bwd(*short, g)
        unpadded, g = _entry_operands(entry, graph, 64, 32, E, 0, True)
        fwd(*unpadded)                       # width 64: live count read


# ---- (c), (d) the models' training steps ---------------------------------

def _gnn2d_arrays(n, seed):
    """An irregular MAgNet[GNN] 2D split: NODES3 random nodes a sample (no
    equidistant neighbours), random fields."""
    rng = np.random.default_rng(seed)
    return {"t": np.tile(np.linspace(0, 1, NT3, endpoint=False,
                                     dtype=np.float32), (n, 1)),
            "coords": rng.random(size=(n, NODES3, 2)).astype(np.float32),
            f"pde_{NT3}-{NODES3}": rng.normal(size=(n, NT3, NODES3))
            .astype(np.float32)}


def _cnn2d_arrays(n, seed):
    rng = np.random.default_rng(seed)
    g = np.tile((np.arange(RES2) / RES2).astype(np.float32), (n, 1))
    t = np.tile(np.linspace(0, 1, NT2, endpoint=False, dtype=np.float32),
                (n, 1))
    return {"t": t, "x": g, "y": g.copy(),
            f"pde_{NT2}-{RES2}": rng.normal(size=(n, NT2, RES2, RES2))
            .astype(np.float32)}


#: (port model, JAX model, hyperparameters, datamodule kind, lane) by case
MODELS = {
    "cnn_2d": ("magnet_cnn_2d", "magnet_cnn_2d", CNN2D_HP, None,
               "kernel_pregathered"),
    "gnn_2d": ("magnet_gnn", "magnet_gnn", GNN2D_HP, GNN2D_KIND, "kernel"),
    "cnn_1d_bf16": ("magnet_cnn", "magnet_cnn",
                    dict(CNN_HP, graph_dtype="bf16"), None, "kernel"),
    "cnn_1d_pe": ("magnet_cnn", None, CNN_HP, None, "kernel_pe"),
    "gnn_1d_pregathered": ("magnet_gnn", None, GNN_HP, None,
                           "kernel_pregathered")}


def _batches(case, n_batches, seed=3):
    """``n_batches`` training batches of 4 samples of ``case``'s model,
    new queries each (the dataset's epoch draws them)."""
    if case == "cnn_2d":
        ds = DatasetImplicit2D(_cnn2d_arrays(4, seed), "train", nt=NT2,
                               res=RES2, samples=6)
    elif case == "gnn_2d":
        ds = DatasetImplicitGNN2D(_gnn2d_arrays(4, seed), "train", nt=NT3,
                                  res=RES2, regular=False, samples=16,
                                  n_nodes=NODES3)
    else:
        data = DatasetImplicitGNN1D if case.startswith("gnn") else \
            DatasetImplicit1D
        ds = data(make_split("Heat", 4, NT1, NX1, seed=seed), "train",
                  nt=NT1, nx=NX1, samples=8)
    out = []
    for i in range(n_batches):
        ds.set_epoch(seed + i)
        out.append(collate([ds[j] for j in range(4)]))
    return out


_JAX: dict = {}


def _jax_model(case):
    """The JAX model, its parameters (the port's seeded init read by the
    JAX package's importer) and its jitted training loss and gradients."""
    if case not in _JAX:
        name, jax_name, hp, kind, _ = MODELS[case]
        sd = create_model(name, hp, device="cpu", seed=1,
                          kind=kind).state_dict()
        params = import_state_dict(jax_name, {k: v.numpy() for k, v in
                                              sd.items()}, hp)
        jm = jax_create_model(jax_name, hp)
        grads = jax.jit(jax.value_and_grad(
            lambda q, b, g: jm.loss(q, b, g, train=True), has_aux=True))
        _JAX[case] = jm, jax.tree.map(np.asarray, params), grads
    return _JAX[case]


def _trainer(case, tmp_path, k=K):
    """The port's model (the JAX model's weights where there is one), in a
    CPU trainer whose optimizer is set up for 4 steps an epoch."""
    name, jax_name, hp, kind, impl = MODELS[case]
    model = create_model(name, hp, device="cpu", seed=1, kind=kind)
    if jax_name is not None:
        params = _jax_model(case)[1]
        model.load_state_dict(state_dict_from_jax(
            params, hp, jax_name, pos_dim=2 if kind else None))
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


@pytest.mark.parametrize("case", sorted(MODELS))
def test_padded_step_equals_unpadded_and_jax(case, tmp_path):
    """(c): two batches with new queries, padded in one chunk, against
    unpadded; the first against the JAX model where the case has one."""
    tr = _trainer(case, tmp_path)
    model = tr.model
    pairs = [tr._host_pair(b) for b in _batches(case, 2)]
    padded = tr._padded([g for _, g in pairs])
    for i, ((batch, graph), pgraph) in enumerate(zip(pairs, padded)):
        for role, part in model.graph_parts(pgraph).items():
            assert int(part.rowptr[-1]) == model.graph_parts(
                graph)[role].n_edge < part.n_edge
        lanes = model.graph_lanes(pgraph)
        assert all(lane in ("fold", "pe", "pregathered")
                   for lane, _, _ in lanes), lanes
        if case == "cnn_2d":
            assert {lane for lane, _, _ in lanes} == {"pregathered"}
        want_loss, want = _loss_and_grads(model, batch, graph)
        loss, grads = _loss_and_grads(model, batch, pgraph)
        assert _rel_l2(loss, want_loss) <= STEP_L2
        for n in want:
            assert _rel_l2(grads[n], want[n]) <= STEP_L2, n
        if i or MODELS[case][1] is None:
            continue
        # against the JAX model on its own graph
        name, jax_name, hp, _, _ = MODELS[case]
        jm, params, jax_grads = _jax_model(case)
        host = {k: v.numpy() for k, v in batch.items()}
        (jloss, _), jgrads = jax_grads(
            params, {k: jnp.asarray(v) for k, v in host.items()},
            jm.build_graph(host))
        got = import_state_dict(jax_name, {n: g.numpy() for n, g in
                                           grads.items()}, hp)
        pairs_ = list(zip(jax.tree_util.tree_leaves_with_path(got),
                          jax.tree_util.tree_leaves_with_path(jgrads)))
        if case == "cnn_1d_bf16":
            assert abs(float(loss) - float(jloss)) < BF16_LOSS_RTOL * float(
                jloss)
            for (path, a), (_, b) in pairs_:
                assert _rel_l2(torch.from_numpy(np.array(a)),
                               torch.from_numpy(np.array(b))) \
                    < BF16_PARAM_L2, jax.tree_util.keystr(path)
            flat = [np.concatenate([np.array(x).ravel() for _, x in side])
                    for side in zip(*pairs_)]
            assert _rel_l2(*map(torch.from_numpy, flat)) < BF16_MODEL_L2
            continue
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
        for (path, a), (_, b) in pairs_:
            b = np.asarray(b)
            np.testing.assert_allclose(
                np.asarray(a), b, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_REL * max(float(np.abs(b).max()), 1.0),
                err_msg=jax.tree_util.keystr(path))


def test_chunk_of_padded_2d_steps_equals_the_jax_scan(tmp_path):
    """(d): one chunk of K MAgNet[CNN] 2D batches with new queries each."""
    batches = _batches("cnn_2d", K, seed=5)
    tr = _trainer("cnn_2d", tmp_path / "port")
    pairs = [tr._host_pair(b) for b in batches]
    graphs = tr._padded([g for _, g in pairs])
    assert len({graph_signature(g) for g in graphs}) == 1
    losses = [float(tr.device_step(b, g)["loss"])
              for (b, _), g in zip(pairs, graphs)]

    jm, params, _ = _jax_model("cnn_2d")
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


# ---- (e) the rule ----------------------------------------------------------

def test_the_lanes_a_chunk_is_padded_on(tmp_path):
    """On a CUDA device (the rule reads nothing else of it): chunks of
    MAgNet[CNN] 2D (pre-gathered), MAgNet[CNN] 1D on kernel_pe and
    MAgNet[GNN] 1D on kernel_pregathered in f32, of MAgNet[CNN] 1D in bf16
    at width 64 and of MAgNet[GNN] 1D in bf16 at width 128 are padded; the
    plain versions give their reason."""
    cases = {"cnn_2d": None, "cnn_1d_pe": None, "gnn_1d_pregathered": None}
    for case in cases:
        tr = _trainer(case, tmp_path / case)
        pairs = [tr._host_pair(b) for b in _batches(case, K)]
        tr.device = torch.device("cuda")
        assert tr._uncaptured(pairs) is None, case
        cases[case] = tr, pairs
    # bf16 at width 64 (MAgNet[CNN]'s build) and at width 128 (MAgNet[GNN]'s)
    for name, hp, width, why in (
            ("magnet_cnn", dict(CNN_HP, mlp_hidden=64), 64, None),
            ("magnet_gnn", dict(GNN_HP, mlp_hidden=128), 128, None)):
        model = create_model(name, dict(hp, graph_dtype="bf16"),
                             device="cpu", seed=0)
        tr = Trainer(model, max_epochs=1, workdir=str(tmp_path / name),
                     device="cpu", steps_per_call=K)
        data = DatasetImplicitGNN1D if name == "magnet_gnn" else \
            DatasetImplicit1D
        ds = data(make_split("Heat", 2, NT1, NX1, seed=1), "train", nt=NT1,
                  nx=NX1, samples=8)
        pairs = []
        for i in range(K):
            ds.set_epoch(i)
            pairs.append(tr._host_pair(collate([ds[0], ds[1]])))
        tr.device = torch.device("cuda")
        assert {(d, w) for _, d, w in model.graph_lanes(pairs[0][1])} == {
            ("bf16", width)}
        assert tr._uncaptured(pairs) == why, name
    tr, pairs = cases["cnn_1d_pe"]
    tr.model.impl = "plain"
    assert tr._uncaptured(pairs) == (
        "the chunk's graphs differ, on the plain lane in f32 at width 16")
    # a lane that reads the live count but is another signature
    batch, graph = pairs[1]
    other = dataclasses.replace(graph, lane="pregathered")
    tr.model.impl = "kernel"
    assert tr._uncaptured([pairs[0], (batch, other), *pairs[2:]]) == (
        "the chunk's graph signatures differ")
