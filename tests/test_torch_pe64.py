"""MAgNet[CNN]'s pe lane (``impl="kernel_pe"``) at the width-64 form of the
pe entry, (H, C) = (64, 32), against the JAX package on the CPU, in f32 and
in bf16 (``graph_dtype=bf16``).

The JAX package runs this lane under ``MAGNET_TPU_NO_FUSED2R``: its
GraphNet step then takes ``fused_edge_tail_agg2`` (``_fused2_fwd_pallas``
/ ``_fused2_bwd_pallas``, #6 / #7, with d_pxj reduced outside the kernel)
wherever ``_fused2_mode`` finds the sender-tile layout.  The references:

  * the pe entry's f32 pair (the wrapper on CPU tensors) and its bf16
    plain pair at (64, 32) against the VJP of ``fused_edge_tail_agg2`` in
    Pallas interpret mode (``MAGNET_TPU_PALLAS_INTERPRET=1``, as
    ``tests/test_torch_pe_edge.py`` runs it), on its radius graph;
  * one width-64 ``InteractionNetwork`` step (latent 32, hidden 64, L1 = 3)
    on ``impl="kernel_pe"`` against the JAX step under
    ``MAGNET_TPU_NO_FUSED2R`` in interpret mode, f32 and bf16;
  * the JAX step's own lane (``graphnet.LAST_FUSED_LANE``, from a trace at
    MAgNet[CNN]'s widths) on MAgNet[CNN] 1D's eval and training graphs and
    2D's eval graph (mode ``vmem``, not ragged, not fold) and 2D's training
    graph (mode None: no fused2 lane), the coordinates of
    ``tests/test_torch_lane.py``;
  * MAgNet[CNN] 1D and 2D at the published GraphNet widths (latent 32,
    hidden 64, four MLP layers) on small data, weights carried by
    ``weights.state_dict_from_jax``, on ``impl="kernel_pe"`` against the
    JAX models under ``MAGNET_TPU_NO_FUSED2R``: f32 through the JAX
    package's plain reference of the kernels (its CPU path), bf16 in
    interpret mode (the TPU kernels' rounding points).

Inputs come from seeds with numpy.  Tolerances:
  * f32 pair: forward rtol 1e-4, atol 1e-5; gradients rtol 1e-3, atol 1e-4
    (``tests/test_torch_pe_edge.py``'s: f32 on both sides, sums in another
    order);
  * bf16 pair: forward rtol 1e-2, atol 1e-2, gradients by relative L2 per
    operand 1e-2, and d_pxj, one rounding of the f32 sum of dz, no further
    from the JAX package than half the distance of the fold lane's rounding
    (a sum of bf16(dz)) (``tests/test_torch_bf16_gnn.py``'s: both sides
    round at the same points, f32 sums in another order, 2^-8 relative);
  * the f32 step: node latents rtol 1e-4, atol 1e-5, parameter gradients
    rtol 2e-3, atol 1e-5 of each leaf's largest entry; the bf16 step: node
    latents rtol 2e-2, atol 2e-2, gradients by relative L2 per leaf 5e-2
    (``tests/test_torch_bf16.py``'s);
  * f32 models: rollout and losses rtol 1e-3, atol 1e-4
    (``tests/test_torch_slice.py``'s: two autoregressive windows carry the
    reordering forward), parameter gradients rtol 2e-3, atol 1e-5 of each
    leaf's largest entry (``tests/test_torch_cnn2d.py``'s);
  * bf16 models: rollout by relative L2 1e-2, eval loss within 1e-2 and
    training loss within 1e-3 relative, parameter gradients by relative L2
    0.15 per parameter and 5e-2 over all (``tests/test_torch_bf16.py``'s);
  * the lanes: exact (a lane is a name).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import batch_vmap  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.nn import graphnet as jax_graphnet  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicit2D  # noqa: E402
from magnet_tpu_torch.data.heat import heat_batches  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.graphnet import InteractionNetwork  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    GraphCache,
    TileLayout,
    csr_from_edges,
    lane_of,
)
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import _processor, state_dict_from_jax  # noqa: E402
from test_torch_bf16_gnn import LANE_CASES as GNN_GRAPHS  # noqa: E402
from test_torch_cnn2d import HP as CNN2D_HP  # noqa: E402
from test_torch_cnn2d import NT as CNN2D_NT  # noqa: E402
from test_torch_cnn2d import _arrays as cnn2d_arrays  # noqa: E402
from test_torch_cnn2d import _batch as cnn2d_batch  # noqa: E402
from test_torch_lane import _cnn_coords, _jax_graph  # noqa: E402
from test_torch_modules import _graph_pair  # noqa: E402
from test_torch_pe_edge import _graphs as pe_graphs  # noqa: E402

BF = jnp.bfloat16
H, C = 64, 32  # the kernels' width-64 form
FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=1e-3, atol=1e-4)
BF16_FWD, BF16_GRAD_L2 = dict(rtol=1e-2, atol=1e-2), 1e-2
STEP_F32, STEP_GRAD_RTOL, STEP_GRAD_ATOL_REL = FWD, 2e-3, 1e-5
STEP_BF16, STEP_BF16_GRAD_L2 = dict(rtol=2e-2, atol=2e-2), 5e-2
MODEL_F32, GRAD_RTOL, GRAD_ATOL_REL = dict(rtol=1e-3, atol=1e-4), 2e-3, 1e-5
LOSS_RTOL, PRED_L2, MODEL_GRAD_L2, PARAM_GRAD_L2 = 1e-3, 1e-2, 5e-2, 0.15
TAIL = ("w_rest", "b_rest", "w_out", "b_out", "ln_s", "ln_b")
# the published GraphNet widths (magnet_cnn*.yaml), so that the port's pe
# lane is the width-64 form the card builds
WIDE = dict(latent_dim=C, mlp_hidden=H, mlp_layers=4)
# MAgNet[CNN] 1D: B=2, L=32, N=64, nt=48 (two windows), as
# tests/test_torch_slice.py, at those widths
HP_1D = dict(time_slice=16, num_message_passing_steps=2, n_chan=16,
             res_layers=1, kernel_size=3, res_scale=1, radius=0.08, **WIDE)
HP_2D = {**CNN2D_HP, **WIDE}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _bf16(a):
    """a rounded to bf16, kept as an f32 array."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _pe_case(L1, seed, bf16):
    """The pe entry's operands at (64, 32) on ``test_torch_pe_edge``'s
    radius graph (self loops, one node far off), as f32 arrays (holding
    bf16 values but ln_s and ln_b when ``bf16``), with the graph in both
    layouts."""
    gs, graph, e_idx, live = pe_graphs(seed=seed)
    rng = np.random.default_rng(seed)
    n, e = graph.n_node, graph.n_edge

    def f(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    p = dict(pe=f(e, H), pxj=f(n, H), pxi=f(n, H), w_rest=f(L1, H, H),
             b_rest=f(L1, H), w_out=f(H, C), b_out=f(C),
             ln_s=1 + f(C, scale=0.1), ln_b=f(C, scale=0.1))
    if bf16:
        for k in ("pe", "pxj", "pxi", *TAIL[:4]):
            p[k] = _bf16(p[k])
    return p, gs, graph, e_idx, live


def _fused2_vjp(p, gs, graph, e_idx, live, g, dtype):
    """``fused_edge_tail_agg2`` on the blocked layout in interpret mode
    (the caller sets it), its operands in ``dtype`` but ln_s and ln_b:
    (the per-node sums, the gradients in ``GRAD_NAMES_PE`` order on the
    port's CSR rows), all as f32 arrays."""
    n = graph.n_node
    T, et = gs.blk_recv_local.shape
    pe_blk = np.zeros((T * et, H), np.float32)
    pe_blk[live] = p["pe"][e_idx]

    def pad(a):
        out = np.zeros((T * 128, a.shape[1]), np.float32)
        out[:n] = a
        return out

    cast = (lambda a: jnp.asarray(a).astype(dtype))  # noqa: E731
    out, vjp = jax.vjp(
        lambda pe_, pxj_, pxi_, *tail: pk.fused_edge_tail_agg2(
            pe_, pxj_, pxi_, *tail, gs.blk_snd2_tids, gs.blk_snd2_local,
            gs.blk_recv_local, gs.edge_mask.reshape(T, et),
            gs.blk_snd_edge_ids, gs.blk_snd_local),
        cast(pe_blk.reshape(T, et, H)), cast(pad(p["pxj"])),
        cast(pad(p["pxi"]).reshape(T, 128, H)),
        *(cast(p[k]) for k in TAIL[:4]), *(jnp.asarray(p[k]) for k in TAIL[4:]))
    assert out.dtype == jnp.float32
    d = [np.asarray(a, np.float32)
         for a in vjp(jnp.asarray(pad(g).reshape(T, 128, C)))]
    return (np.asarray(out).reshape(-1, C)[:n],
            [d[0].reshape(T * et, H)[live][np.argsort(e_idx)], d[1][:n],
             d[2].reshape(-1, H)[:n], *d[3:]])


def _port_ops(p, graph, dtype):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    nodes = [t[k].to(dtype) for k in ("pe", "pxj", "pxi")]
    return (*nodes, graph.senders, graph.rowptr, graph.snd_ptr,
            graph.snd_perm, *(t[k].to(dtype) for k in TAIL[:4]), t["ln_s"],
            t["ln_b"])


# ---- the pe entry at (64, 32) ----------------------------------------------

@pytest.mark.parametrize("L1", [0, 3])
def test_pe_entry_at_width_64_matches_fused2_pallas_interpret(monkeypatch,
                                                              L1):
    """The f32 wrapper on CPU tensors (the plain pair of #6 / #7 with d_pxj
    by the segment sum over the sender CSR) at (H, C) = (64, 32), a width
    the card now builds, against ``fused_edge_tail_agg2``'s VJP: the sums
    and all nine gradients; nothing is launched."""
    p, gs, graph, e_idx, live = _pe_case(L1, seed=60 + L1, bf16=False)
    g = np.random.default_rng(L1).normal(size=(graph.n_node, C)).astype(
        np.float32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want, want_grads = _fused2_vjp(p, gs, graph, e_idx, live, g, jnp.float32)
    assert (H, C) in fe.KERNEL_WIDTHS["pe"]
    ops = _port_ops(p, graph, torch.float32)
    before = (fe.launch_counts(), seg.launches)
    np.testing.assert_allclose(fe.fused_edge_tail_agg_pe(*ops).numpy(), want,
                               **FWD)
    grads = fe.fused_edge_tail_agg_pe_bwd(*ops, torch.from_numpy(g))
    assert (fe.launch_counts(), seg.launches) == before
    assert len(grads) == len(fe.GRAD_NAMES_PE) == len(want_grads)
    for name, a, b in zip(fe.GRAD_NAMES_PE, grads, want_grads):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, **BWD, err_msg=name)


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_pe_bf16_pair_at_width_64_matches_fused2_pallas_interpret(
        monkeypatch, L1):
    """``fused_edge_tail_agg_pe_bf16_plain`` / ``_bwd_plain`` at (64, 32)
    against the VJP of ``fused_edge_tail_agg2`` on bf16 operands: the sums,
    every gradient in its operand's dtype, and d_pxj rounded once from the
    f32 sum of the unrounded dz, not summed from bf16(dz) as the fold lane
    does; the wrapper on CPU tensors is that pair."""
    p, gs, graph, e_idx, live = _pe_case(L1, seed=70 + L1, bf16=True)
    n = graph.n_node
    g = np.random.default_rng(30 + L1).normal(size=(n, C)).astype(np.float32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want, want_grads = _fused2_vjp(p, gs, graph, e_idx, live, g, BF)
    assert (H, C) in fe.KERNEL_WIDTHS["pe_bf16"]
    ops = _port_ops(p, graph, torch.bfloat16)
    got = fe.fused_edge_tail_agg_pe_bf16_plain(*ops)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_FWD)
    grads = fe.fused_edge_tail_agg_pe_bf16_bwd_plain(*ops, torch.from_numpy(g))
    for name, a, b in zip(fe.GRAD_NAMES_PE, grads, want_grads):
        assert a.dtype == (torch.float32 if name in ("ln_s", "ln_b")
                           else torch.bfloat16), name
        assert tuple(a.shape) == b.shape, name
        if a.numel():
            assert rel_l2(a.float().numpy(), b) < BF16_GRAD_L2, name
    other = torch.zeros(n, H).index_add_(0, graph.senders.long(),
                                         torch.from_numpy(want_grads[0]))
    other = other.bfloat16().float().numpy()
    assert not np.array_equal(other, want_grads[1])
    assert (rel_l2(grads[1].float().numpy(), want_grads[1])
            < 0.5 * rel_l2(other, want_grads[1]))
    # the wrapper on CPU tensors: the same pair, nothing launched
    before = (fe.launch_counts(), seg.launches)
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in ops]
    out = fe.fused_edge_tail_agg_pe_bf16(*leaves)
    assert torch.equal(out.detach(), got)
    out.backward(torch.from_numpy(g))
    assert (fe.launch_counts(), seg.launches) == before
    floats = [t for t in leaves if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES_PE, floats, grads):
        assert torch.equal(leaf.grad, w), name


# ---- one width-64 step on the pe lane ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_interaction_step_kernel_pe_at_width_64_matches_jax(monkeypatch,
                                                            dtype):
    """One step at latent 32, hidden 64, four MLP layers (the edge scale 4,
    a bf16 scalar in bf16, as the JAX processor carries it): node latents
    and the gradients of sum(x' * G) in every parameter and in x, against
    the JAX step on ``fused_edge_tail_agg2`` (mode 'vmem', not ragged, not
    fold) under ``MAGNET_TPU_NO_FUSED2R`` in interpret mode."""
    bf16 = dtype == "bf16"
    jdt, tdt = (BF, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jg, tg, x, e_blk, e_csr = _graph_pair(B=1, n=100, r=0.05, C=C, seed=23)
    net = batch_vmap(jax_graphnet.InteractionNetwork, in_axes=(0, 0, 0, None),
                     node_out=C, edge_out=C, mlp_layers=4, mlp_hidden=H,
                     dtype=BF if bf16 else None)
    xb, eb = jnp.asarray(x).astype(jdt), jnp.asarray(e_blk).astype(jdt)
    scale = jnp.asarray(4.0, jdt)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    rng = np.random.default_rng(24)
    one = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32),
        jax.jit(net.init)(jax.random.PRNGKey(6), xb, eb, jg, scale)["params"])
    G = rng.normal(size=x.shape).astype(np.float32)

    def inet(p, xv):
        return net.apply({"params": p}, xv, eb, jg, scale)[0]

    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    want = jax.jit(inet)(one, xb)
    lane = dict(jax_graphnet.LAST_FUSED_LANE)
    assert lane["mode"] == "vmem" and not lane["ragged"] and not lane["fold"]
    d_p, d_x = jax.jit(jax.grad(
        lambda p, xv: jnp.sum(inet(p, xv).astype(jnp.float32) * G),
        argnums=(0, 1)))(one, xb)
    step = InteractionNetwork(C, 4, H, dtype=tdt if bf16 else None)
    sd = {}
    _processor(sd, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], one)}}, 1, 4)
    step.load_state_dict({k.removeprefix("p.gnn_stacks.0."): v
                          for k, v in sd.items()})
    xt = torch.from_numpy(x.reshape(-1, C)).to(tdt).requires_grad_()
    before = (fe.launch_counts(), seg.launches)
    got = step(xt, torch.from_numpy(e_csr).to(tdt), tg, e_scale=4.0,
               impl="kernel_pe")
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32).reshape(-1, C),
                               **(STEP_BF16 if bf16 else STEP_F32))
    (got.float() * torch.from_numpy(G.reshape(-1, C))).sum().backward()
    assert (fe.launch_counts(), seg.launches) == before  # CPU: plain pair
    sd_grad = {}
    _processor(sd_grad, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], d_p)}}, 1, 4)
    pairs = [("x", xt.grad.float().numpy(),
              np.asarray(d_x, np.float32).reshape(-1, C))]
    pairs += [(name, prm.grad.numpy(),
               sd_grad[f"p.gnn_stacks.0.{name}"].numpy())
              for name, prm in step.named_parameters()]
    for name, a, b in pairs:
        if bf16:
            assert rel_l2(a, b) < STEP_BF16_GRAD_L2, name
        else:
            np.testing.assert_allclose(
                a, b, rtol=STEP_GRAD_RTOL,
                atol=STEP_GRAD_ATOL_REL * max(float(np.abs(b).max()), 1.0),
                err_msg=name)


# ---- the JAX lane on MAgNet[CNN]'s graphs ------------------------------------

# (support grid, queries a sample, samples, radius, the lane): MAgNet[CNN]
# 1D's eval graph (the 128-point support ∪ the whole 256-point mesh) and
# training graph (32 queries, 32 samples), 2D's eval graph (32² ∪ 64²) and
# training graph (32 queries, 32 samples)
CNN_GRAPHS = {
    "1d_eval": ([128], None, 1, 0.08, "vmem"),
    "1d_train": ([128], 32, 32, 0.08, "vmem"),
    "2d_eval": ([32, 32], None, 1, 0.1, "vmem"),
    "2d_train": ([32, 32], 32, 32, 0.1, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("case", sorted(CNN_GRAPHS))
def test_jax_step_under_no_fused2r_takes_fused2_on_cnn_graphs(monkeypatch,
                                                              case, dtype):
    """The JAX GraphNet step at MAgNet[CNN]'s widths under
    ``MAGNET_TPU_NO_FUSED2R`` (a trace of its init, ``LAST_FUSED_LANE``):
    ``fused_edge_tail_agg2`` (mode 'vmem', not ragged, not fold) on 1D's
    eval and training graphs and 2D's eval graph, which the port's
    ``impl="kernel_pe"`` runs on #6 / #7 at (64, 32); no fused2 lane on
    2D's training graph, which has no sender-tile layout."""
    support, queries, batch, r, mode = CNN_GRAPHS[case]
    coords = np.ascontiguousarray(_cnn_coords(support, queries, batch, seed=5),
                                  np.float32)
    gs = _jax_graph(coords, r, loop=True)
    t, et = gs.blk_recv_local.shape
    jdt = BF if dtype == "bf16" else jnp.float32
    net = jax_graphnet.InteractionNetwork(node_out=C, edge_out=C,
                                          mlp_layers=4, mlp_hidden=H,
                                          dtype=BF if dtype == "bf16" else None)
    x = jax.ShapeDtypeStruct((coords.shape[1], C), jdt)
    e = jax.ShapeDtypeStruct((t * et, C), jdt)
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    jax.eval_shape(lambda a, b: net.init(jax.random.PRNGKey(0), a, b, gs,
                                         jnp.asarray(2.0, jdt)), x, e)
    lane = dict(jax_graphnet.LAST_FUSED_LANE)
    assert lane["mode"] == mode
    assert not lane["ragged"] and not lane["fold"]
    if mode is None:
        assert gs.blk_snd2_tids is None


def _jax_lane_no_fused2r(coords, r, hidden, c, dtype):
    """The JAX step's mode under ``MAGNET_TPU_NO_FUSED2R`` on ``coords`` (an
    ``eval_shape`` of its init on one sample of the graph, width ``hidden``
    and latent ``c``)."""
    gs = _jax_graph(coords, r, loop=True)
    t, et = gs.blk_recv_local.shape
    jdt = BF if dtype == "bf16" else jnp.float32
    net = jax_graphnet.InteractionNetwork(
        node_out=c, edge_out=c, mlp_layers=4, mlp_hidden=hidden,
        dtype=BF if dtype == "bf16" else None)
    x = jax.ShapeDtypeStruct((coords.shape[1], c), jdt)
    e = jax.ShapeDtypeStruct((t * et, c), jdt)
    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    jax.eval_shape(lambda a, b: net.init(jax.random.PRNGKey(0), a, b, gs,
                                         jnp.asarray(2.0, jdt)), x, e)
    return dict(jax_graphnet.LAST_FUSED_LANE)


def _lane_case(case):
    """(coordinates, radius, width, latent) of a MAgNet[CNN] graph
    (``CNN_GRAPHS``) or a MAgNet[GNN] one (``tests/test_torch_bf16_gnn.py``
    ``LANE_CASES``: 1D eval, training and LR graphs, 2D training and eval
    graphs)."""
    if case in CNN_GRAPHS:
        support, queries, batch, r, _ = CNN_GRAPHS[case]
        return _cnn_coords(support, queries, batch, seed=5), r, H, C
    coords, r = GNN_GRAPHS[case]()
    return coords, r, 128, 128


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("case", sorted(CNN_GRAPHS) + sorted(GNN_GRAPHS))
def test_pe_lane_rule_names_the_jax_lane_under_no_fused2r(monkeypatch, case,
                                                         dtype):
    """The port's lane for ``impl="kernel_pe"`` (``lane_of(graph,
    "graphnet_pe", H)``) is the JAX step's under ``MAGNET_TPU_NO_FUSED2R``
    on every MAgNet[CNN] and MAgNet[GNN] graph: ``pe`` where its
    ``_fused2_mode`` is not None (the sender-tile and sender-transpose
    layouts both exist), ``pregathered`` where it is None (MAgNet[CNN] 2D's
    training graph, no sender-tile layout); from the layout alone, whatever
    lane the graph carries for ``impl="kernel"``."""
    coords, r, hidden, c = _lane_case(case)
    coords = np.ascontiguousarray(coords, np.float32)
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    mode = _jax_lane_no_fused2r(coords, r, hidden, c, dtype)["mode"]
    assert mode != "unset"
    graph = GraphCache(lane_rule=("graphnet", hidden)).radius_graph_batch(
        coords, r, loop=True)
    want = "pregathered" if mode is None else "pe"
    assert lane_of(graph, "graphnet_pe", hidden) == want
    assert want == ("pe" if graph.layout.snd2 and graph.layout.snd_transpose
                    else "pregathered")
    assert (case == "2d_train") is (want == "pregathered")
    bare = csr_from_edges(graph.senders, graph.receivers, graph.n_node,
                          layout=graph.layout)
    assert lane_of(bare, "graphnet_pe", hidden) == want


def test_pe_lane_rule_refuses_a_graph_without_a_layout():
    """A graph that carries a cached lane but no tile layout cannot answer
    for the pe lane (its cached lane is ``impl="kernel"``'s): the rule
    raises, as it does for a bare graph, and never falls back."""
    graph = csr_from_edges(torch.tensor([0, 1]), torch.tensor([0, 1]), 2)
    graph.lane = "fold"
    assert lane_of(graph, "graphnet", H) == "fold"
    with pytest.raises(ValueError, match="layout"):
        lane_of(graph, "graphnet_pe", H)
    for snd2, snd_t, want in ((True, True, "pe"), (True, False, "pregathered"),
                              (False, True, "pregathered"),
                              (False, False, "pregathered")):
        graph.layout = TileLayout(n_pad=256, snd2=snd2, snd_transpose=snd_t)
        assert lane_of(graph, "graphnet_pe", H) == want


# ---- the models ---------------------------------------------------------------

def _perturbed(params, seed):
    """``params`` with noise, so that no LayerNorm affine is ones and
    zeros."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32), params)


def _jax_call(fn):
    """``fn()`` traced anew (a fresh closure under ``jax.jit``), with the
    JAX step's lane of that trace."""
    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    out = jax.jit(fn)()
    lane = dict(jax_graphnet.LAST_FUSED_LANE)
    assert lane["mode"] == "vmem" and not lane["ragged"] and not lane["fold"]
    return out


def _grads_close(tm, d_p, hp, model, bf16):
    """Every parameter gradient of ``tm`` against the JAX gradients ``d_p``
    carried to the port's names."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, d_p), hp, model=model)
    got_all, want_all = [], []
    for name, prm in tm.named_parameters():
        g, w = prm.grad.numpy(), want[name].numpy()
        assert np.isfinite(g).all(), name
        if bf16:
            assert rel_l2(g, w) < PARAM_GRAD_L2, name
        else:
            np.testing.assert_allclose(
                g, w, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_REL * max(float(np.abs(w).max()), 1.0),
                err_msg=name)
        got_all.append(g.ravel())
        want_all.append(w.ravel())
    if bf16:
        assert rel_l2(np.concatenate(got_all),
                      np.concatenate(want_all)) < MODEL_GRAD_L2


def _close(got, want, bf16, loss=False):
    if not bf16:
        np.testing.assert_allclose(got, want, **MODEL_F32)
    elif loss:
        assert abs(float(got) - float(want)) < PRED_L2 * abs(float(want))
    else:
        assert rel_l2(got, want) < PRED_L2


def _train_loss_and_grads(tm, tb):
    tm.impl = "kernel_pe"
    tm.zero_grad(set_to_none=True)
    try:
        loss, _ = tm.loss(tb, tm.build_graph(tb), train=True)
        loss.backward()
    finally:
        tm.impl = "kernel"
    return loss.item()


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_magnet_cnn_1d_kernel_pe_matches_jax_no_fused2r(monkeypatch, dtype):
    """MAgNet[CNN] 1D at the published GraphNet widths on
    ``impl="kernel_pe"`` against the JAX model under
    ``MAGNET_TPU_NO_FUSED2R``: the rollout, the eval and training losses
    and every parameter's gradient."""
    bf16 = dtype == "bf16"
    hp = dict(HP_1D, graph_dtype=dtype)
    batch = heat_batches(2, 2, nt=48, nx=64, seed=12)[0]
    jm = jax_create_model("magnet_cnn", hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(3), jb, jg), 7)
    tm = create_model("magnet_cnn", hp, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP_1D))
    tb = to_device(batch, "cpu")
    tg = tm.build_graph(tb)
    if bf16:
        monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    want_hr, _ = _jax_call(lambda: jm.predict(params, jb, jg))
    want_eval, _ = _jax_call(lambda: jm.loss(params, jb, jg, train=False))
    rng = jax.random.PRNGKey(0)
    want_loss, d_p = _jax_call(lambda: jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, rng=rng, train=True)[0])(params))
    tm.impl = "kernel_pe"
    try:
        got_hr, _ = tm.predict(tb, tg)
        got_eval, _ = tm.loss(tb, tg, train=False)
    finally:
        tm.impl = "kernel"
    _close(got_hr.numpy(), np.asarray(want_hr), bf16)
    _close(float(got_eval), float(want_eval), bf16, loss=True)
    loss = _train_loss_and_grads(tm, tb)
    if bf16:
        assert abs(loss - float(want_loss)) < LOSS_RTOL * float(want_loss)
    else:
        np.testing.assert_allclose(loss, float(want_loss), **MODEL_F32)
    _grads_close(tm, d_p, HP_1D, "magnet_cnn", bf16)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_magnet_cnn_2d_kernel_pe_matches_jax_no_fused2r(monkeypatch, dtype):
    """MAgNet[CNN] 2D at the published GraphNet widths on
    ``impl="kernel_pe"`` against the JAX model under
    ``MAGNET_TPU_NO_FUSED2R``: the eval rollout and loss on the test
    split's graph and the teacher-forcing training loss (on this small mesh
    the training graph has the sender-transpose layout, so the JAX model
    trains on ``fused_edge_tail_agg2`` too)."""
    bf16 = dtype == "bf16"
    hp = dict(HP_2D, graph_dtype=dtype)
    jm = jax_create_model("magnet_cnn_2d", hp)
    train, test = cnn2d_batch("train", seed=9), cnn2d_batch("test", seed=10)
    jb = {k: jnp.asarray(v) for k, v in train.items()}
    jg = jm.build_graph(train)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(4), jb, jg), 8)
    tm = create_model("magnet_cnn_2d", hp, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP_2D,
                                           model="magnet_cnn_2d"))
    jt = {k: jnp.asarray(v) for k, v in test.items()}
    jgt = jm.build_graph(test)
    tb, tt = to_device(train, "cpu"), to_device(test, "cpu")
    if bf16:
        monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    want_hr, _ = _jax_call(lambda: jm.predict(params, jt, jgt))
    want_eval, _ = _jax_call(lambda: jm.loss(params, jt, jgt, train=False))
    want_loss, _ = _jax_call(lambda: jm.loss(params, jb, jg, train=True))
    tm.impl = "kernel_pe"
    try:
        tg = tm.build_graph(tt)
        got_hr, _ = tm.predict(tt, tg)
        got_eval, _ = tm.loss(tt, tg, train=False)
    finally:
        tm.impl = "kernel"
    _close(got_hr.numpy(), np.asarray(want_hr), bf16)
    _close(float(got_eval), float(want_eval), bf16, loss=True)
    loss = _train_loss_and_grads(tm, tb)
    if bf16:
        assert abs(loss - float(want_loss)) < LOSS_RTOL * float(want_loss)
    else:
        np.testing.assert_allclose(loss, float(want_loss), **MODEL_F32)
    for name, prm in tm.named_parameters():
        assert torch.isfinite(prm.grad).all(), name


# ---- C.6: impl="kernel_pe" on MAgNet[CNN] 2D's training graph ----------------

# MAgNet[CNN] 2D at the published GraphNet widths and radius (0.1), two
# samples of a 64² mesh: the 32² support ∪ 32 queries of "2d_train"
HP_2D_TRAIN = dict(HP_2D, radius=0.1)


def _cnn2d_train_batch(seed):
    ds = DatasetImplicit2D(cnn2d_arrays(2, seed, nt=CNN2D_NT, res=64),
                           "train", nt=CNN2D_NT, res=64, samples=32)
    ds.set_epoch(seed)
    return collate([ds[0], ds[1]])


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_magnet_cnn_2d_kernel_pe_training_step_on_its_training_graph(
        monkeypatch, dtype):
    """C.6: one MAgNet[CNN] 2D training step on ``impl="kernel_pe"`` at the
    ``"2d_train"`` node set (no sender-tile layout, so the JAX step under
    ``MAGNET_TPU_NO_FUSED2R`` has mode None and runs the pre-gathered lane:
    h0 = bf16(p_xj[s] + pe), d_p_xj from ``gather_nodes``' VJP, which sums
    in f32 here since the graph has the sender-transpose layout) against
    that JAX step, in interpret mode in bf16: the training loss and every
    parameter's gradient, the weights carried by
    ``weights.state_dict_from_jax``.  The port names the same lane."""
    bf16 = dtype == "bf16"
    hp = dict(HP_2D_TRAIN, graph_dtype=dtype)
    batch = _cnn2d_train_batch(seed=11)
    jm = jax_create_model("magnet_cnn_2d", hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(4), jb, jg), 9)
    tm = create_model("magnet_cnn_2d", hp, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP_2D_TRAIN,
                                           model="magnet_cnn_2d"))
    tb = to_device(batch, "cpu")
    tg = tm.build_graph(tb)
    assert not tg.layout.snd2 and tg.layout.snd_transpose
    assert tg.lane == lane_of(tg, "graphnet_pe", H) == "pregathered"
    if bf16:
        monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    want_loss, d_p = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True)[0]))(params)
    assert jax_graphnet.LAST_FUSED_LANE["mode"] is None
    before = (fe.launch_counts(), seg.launches)
    loss = _train_loss_and_grads(tm, tb)
    assert (fe.launch_counts(), seg.launches) == before  # CPU: plain pairs
    if bf16:
        assert abs(loss - float(want_loss)) < LOSS_RTOL * float(want_loss)
    else:
        np.testing.assert_allclose(loss, float(want_loss), **MODEL_F32)
    _grads_close(tm, d_p, HP_2D_TRAIN, "magnet_cnn_2d", bf16)
