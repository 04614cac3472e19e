"""MAgNet[GNN]'s bf16 GraphNet lane (``graph_dtype=bf16``) against the JAX
package on the CPU: the width-128 bf16 forms of the fold entry (#8/#9) and
of the pe entry (#6/#7, with #1 for d_pxj), one width-128 step on each
lane, the lanes the JAX package takes on the GNN graphs, and MAgNet[GNN]
1D and 2D as a whole.

The kernel-level references are the Pallas kernels in interpret mode
(``MAGNET_TPU_PALLAS_INTERPRET=1``, as ``tests/test_ops.py`` runs them):
the VJP of ``fused_edge_tail_agg2rf`` (``_fused2r_fwd_pallas`` /
``_fused2r_bwd_pallas(dpxj_in_kernel=True)``) on the graph of
``test_torch_fused_edge.py`` (a receiver of degree 0) at (Ce, H, C) =
(128, 128, 128), and the VJP of ``fused_edge_tail_agg2``
(``_fused2_fwd_pallas`` / ``_fused2_bwd_pallas``, d_pxj by
``blocked_segment_sum`` of the f32 dz) on the radius graph of
``test_torch_pe_edge.py`` at (H, C) = (128, 128).  Every reference casts
each gradient to its operand's dtype, as the JAX VJPs do.  The steps and
the models run the JAX side in interpret mode too, its pe lane forced by
``MAGNET_TPU_NO_FUSED2R`` as ``tests/test_torch_pe_edge.py`` forces it.

Tolerances (both sides bf16 with the same rounding points, f32 sums taken
in another order, so a value can round to the neighbouring bf16 number,
2^-8 relative), those of ``tests/test_torch_bf16.py``:
  * the forwards elementwise, rtol 1e-2, atol 1e-2; their gradients by
    relative L2 per operand, 1e-2 (a neighbouring rounding of an
    activation also flips relu ties);
  * d_pxj of the pe entry, the bf16 rounding of one f32 sum: relative L2
    1e-2 against the JAX package, and no further from it than half the
    distance of the other rounding (a sum of bf16(dz)), which the test
    also forms;
  * one InteractionNetwork step at width 128: node latents rtol 2e-2, atol
    2e-2; parameter and input gradients by relative L2 per leaf, 5e-2;
  * MAgNet[GNN] 1D and 2D: the rollout's predictions at relative L2 1e-2,
    the eval loss within 1e-2 and the training loss within 1e-3 relative;
    parameter gradients by relative L2 over all parameters, 5e-2, and per
    parameter 0.15 (``tests/test_torch_bf16.py``'s, for the same reason:
    LayerNorm and bias gradients are sums of many terms of either sign), or
    twice the JAX package's own bf16-to-f32 distance for that parameter
    where that is larger: the first GraphNet stage's gradients reach it
    only through the k-NN head (norms ~1e-4 at this size), and there the
    JAX bf16 gradient itself lies 0.1-0.2 from the JAX f32 one, so the
    bf16 roundings, not the algorithm, set the distance (the port's is
    1.4-1.6 times the JAX package's there);
  * against the f32 lane, ``tests/test_models.py``'s bound: the loss within
    5e-2 relative;
  * the lanes: exact (a lane is a name).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import batch_vmap  # noqa: E402
from magnet_tpu.nn import graphnet as jax_graphnet  # noqa: E402
from magnet_tpu.ops import graph as jax_graph  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu.ops.graph import block_graph  # noqa: E402
from magnet_tpu.train.import_torch import import_state_dict  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicitGNN2D  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.graphnet import InteractionNetwork  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.graph import GraphCache, csr_from_edges  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import _processor, state_dict_from_jax  # noqa: E402
from test_torch_fused_edge import _jax_side, _port_args, _problem  # noqa: E402
from test_torch_gnn import HP as GNN_HP  # noqa: E402
from test_torch_lane import _gnn_coords, _jax_graph  # noqa: E402
from test_torch_modules import _graph_pair  # noqa: E402
from test_torch_pe_edge import _graphs as pe_graphs  # noqa: E402
from test_torch_gnn2d import load_native_neighbours  # noqa: E402

BF = jnp.bfloat16
W = 128  # the width of the kernels under test
FWD_RTOL, FWD_ATOL, GRAD_L2 = 1e-2, 1e-2, 1e-2
STEP_RTOL, STEP_ATOL, STEP_GRAD_L2 = 2e-2, 2e-2, 5e-2
LOSS_RTOL, PRED_L2, MODEL_GRAD_L2, PARAM_GRAD_L2 = 1e-3, 1e-2, 5e-2, 0.15
# a parameter's bound against the JAX bf16 gradient, in multiples of the
# JAX package's own bf16-to-f32 distance, where that exceeds PARAM_GRAD_L2
VS_JAX_BF16_TO_F32 = 2.0
VS_F32_RTOL = 5e-2
# the fold kernel's operands in bf16 (ln_s and ln_b stay f32)
FOLD_BF16 = ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest", "w_out",
             "b_out")
TAIL = ("w_rest", "b_rest", "w_out", "b_out", "ln_s", "ln_b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its ops are small, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def native_neighbours():
    """The JAX side's MAgNet[GNN] 2D graphs take their k-NN tables from the
    native neighbour search (``test_torch_gnn2d.load_native_neighbours``)."""
    return load_native_neighbours()


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _bf16(a):
    """a rounded to bf16, kept as an f32 array."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


# ---- the fold entry's bf16 pair at (128, 128, 128) -------------------------

@pytest.mark.parametrize("L1", [1, 3])
def test_plain_fold_bf16_at_width_128_matches_fused2rf_vjp(monkeypatch, L1):
    """``fused_edge_tail_agg_bf16_plain`` / ``_bwd_plain`` (the width-64
    pair, which takes any width) at MAgNet[GNN]'s widths against the VJP of
    ``fused_edge_tail_agg2rf`` on bf16 operands in interpret mode: the
    per-node sums and every gradient in its operand's dtype."""
    p = _problem(L1, n=120, Ce=W, H=W, C=W, seed=90 + L1)
    for k in FOLD_BF16:
        p[k] = _bf16(p[k])
    args, chunks, n = _jax_side(p)
    a = [x.astype(BF) if i < 9 else x for i, x in enumerate(args)]
    blk = block_graph(p["s"], p["r"], n)
    T, et = blk.senders.shape
    key = p["r"].astype(np.int64) * n + p["s"]
    slot_key = blk.receivers.reshape(T, et).astype(np.int64) * n + blk.senders
    live = blk.mask > 0
    e_idx = np.searchsorted(key, slot_key[live])
    g = np.random.default_rng(L1).normal(size=(n, W)).astype(np.float32)
    g_pad = np.zeros((T * 128, W), np.float32)
    g_pad[:n] = g
    dummy = jnp.zeros((1, 128), jnp.int32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    out, vjp = jax.vjp(
        lambda *f: pk.fused_edge_tail_agg2rf(*f, *a[11:], *chunks, dummy,
                                             dummy), *a[:11])
    assert out.dtype == jnp.float32
    d = vjp(jnp.asarray(g_pad.reshape(T, 128, W)))
    want = dict(zip(fe.GRAD_NAMES, (
        np.asarray(d[0], np.float32)[live][np.argsort(e_idx)], d[1], d[2],
        np.asarray(d[3])[:n], np.asarray(d[4]).reshape(-1, W)[:n], *d[5:])))

    port, _ = _port_args(p)
    port = [t.bfloat16() if t.is_floating_point() and i < 11 else t
            for i, t in enumerate(port)]
    got = fe.fused_edge_tail_agg_bf16_plain(*port)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(out).reshape(-1, W)[:n], FWD_RTOL,
                               FWD_ATOL)
    np.testing.assert_array_equal(got[n // 2].numpy(), 0.0)  # degree 0
    grads = fe.fused_edge_tail_agg_bf16_bwd_plain(*port, torch.from_numpy(g))
    for name, d in zip(fe.GRAD_NAMES, grads):
        w = np.asarray(want[name], np.float32)
        assert d.dtype == (torch.bfloat16 if name in FOLD_BF16
                           else torch.float32), name
        assert tuple(d.shape) == w.shape, name
        assert rel_l2(d.float().numpy(), w) < GRAD_L2, name


# ---- the pe entry's bf16 pair at (128, 128) --------------------------------

def _pe_case(L1, seed):
    """The pe entry's bf16 operands on ``test_torch_pe_edge``'s radius graph
    (a receiver of degree 1, far off), as f32 arrays holding bf16 values
    (ln_s, ln_b f32), with the graph in both layouts."""
    gs, graph, e_idx, live = pe_graphs(seed=seed)
    rng = np.random.default_rng(seed)
    n, e = graph.n_node, graph.n_edge

    def f(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    p = dict(pe=f(e, W), pxj=f(n, W), pxi=f(n, W), w_rest=f(L1, W, W),
             b_rest=f(L1, W), w_out=f(W, W), b_out=f(W),
             ln_s=1 + f(W, scale=0.1), ln_b=f(W, scale=0.1))
    for k in ("pe", "pxj", "pxi", "w_rest", "b_rest", "w_out", "b_out"):
        p[k] = _bf16(p[k])
    return p, gs, graph, e_idx, live


def _pe_port(p, graph):
    """The port's operands of the pe entry's bf16 build."""
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    bf = [t[k].bfloat16() for k in ("pe", "pxj", "pxi")]
    return (*bf, graph.senders, graph.rowptr, graph.snd_ptr, graph.snd_perm,
            *(t[k].bfloat16() for k in TAIL[:4]), t["ln_s"], t["ln_b"])


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_plain_pe_bf16_matches_fused2_pallas_interpret(monkeypatch, L1):
    """``fused_edge_tail_agg_pe_bf16_plain`` / ``_bwd_plain`` against the
    VJP of ``fused_edge_tail_agg2`` on bf16 operands in interpret mode
    (``_fused2_fwd_pallas``; ``_fused2_bwd_pallas`` with d_pxj reduced from
    its f32 dz outside the kernel): the sums, every gradient in its
    operand's dtype, and d_pxj rounded once from the f32 sum of the
    unrounded dz, not summed from bf16(dz) as the fold lane does."""
    p, gs, graph, e_idx, live = _pe_case(L1, seed=4 + L1)
    n = graph.n_node
    T, et = gs.blk_recv_local.shape
    pe_blk = np.zeros((T * et, W), np.float32)
    pe_blk[live] = p["pe"][e_idx]

    def pad(a):
        out = np.zeros((T * 128, W), np.float32)
        out[:n] = a
        return out

    g = np.random.default_rng(20 + L1).normal(size=(n, W)).astype(np.float32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    out, vjp = jax.vjp(
        lambda pe_, pxj_, pxi_, *tail: pk.fused_edge_tail_agg2(
            pe_, pxj_, pxi_, *tail, gs.blk_snd2_tids, gs.blk_snd2_local,
            gs.blk_recv_local, gs.edge_mask.reshape(T, et),
            gs.blk_snd_edge_ids, gs.blk_snd_local),
        jnp.asarray(pe_blk.reshape(T, et, W)).astype(BF),
        jnp.asarray(pad(p["pxj"])).astype(BF),
        jnp.asarray(pad(p["pxi"]).reshape(T, 128, W)).astype(BF),
        *(jnp.asarray(p[k]).astype(BF) for k in TAIL[:4]),
        *(jnp.asarray(p[k]) for k in TAIL[4:]))
    assert out.dtype == jnp.float32
    d = [np.asarray(a, np.float32) for a in vjp(
        jnp.asarray(pad(g).reshape(T, 128, W)))]
    want = [d[0].reshape(T * et, W)[live][np.argsort(e_idx)], d[1][:n],
            d[2].reshape(-1, W)[:n], *d[3:]]

    ops = _pe_port(p, graph)
    got = fe.fused_edge_tail_agg_pe_bf16_plain(*ops)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out).reshape(-1, W)[:n],
                               FWD_RTOL, FWD_ATOL)
    grads = fe.fused_edge_tail_agg_pe_bf16_bwd_plain(*ops, torch.from_numpy(g))
    assert len(grads) == len(fe.GRAD_NAMES_PE) == len(want)
    for name, a, b in zip(fe.GRAD_NAMES_PE, grads, want):
        assert a.dtype == (torch.float32 if name in ("ln_s", "ln_b")
                           else torch.bfloat16), name
        assert tuple(a.shape) == b.shape, name
        if a.numel():
            assert rel_l2(a.float().numpy(), b) < GRAD_L2, name
    # d_pxj: one rounding of the f32 sum of dz, on both sides; the sum of
    # bf16(dz) (the JAX package's own d_pe, summed over each sender) is
    # the other rounding, further off
    s = graph.senders.long()
    other = torch.zeros(n, W).index_add_(0, s, torch.from_numpy(want[0]))
    other = other.bfloat16().float().numpy()
    assert not np.array_equal(other, want[1])
    assert rel_l2(grads[1].float().numpy(), want[1]) < 0.5 * rel_l2(other,
                                                                    want[1])


@pytest.mark.parametrize("L1", [0, 3])
def test_pe_bf16_wrapper_on_cpu_is_the_plain_pair(L1):
    """On CPU tensors ``fused_edge_tail_agg_pe_bf16`` is the plain forward
    and, under autograd, the plain step-by-step backward, each gradient in
    its operand's dtype; nothing is launched, and the autograd Function
    refuses CPU tensors on its kernel path."""
    p, _, graph, _, _ = _pe_case(L1, seed=40 + L1)
    ops = _pe_port(p, graph)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(graph.n_node, W)).astype(np.float32))
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in ops]
    before = (fe.launch_counts(), seg.launches)
    out = fe.fused_edge_tail_agg_pe_bf16(*leaves)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    np.testing.assert_array_equal(
        out.detach().numpy(), fe.fused_edge_tail_agg_pe_bf16_plain(*ops).numpy())
    out.backward(g)
    assert (fe.launch_counts(), seg.launches) == before
    want = fe.fused_edge_tail_agg_pe_bf16_bwd(*ops, g)
    floats = [t for t in leaves if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES_PE, floats, want):
        assert leaf.grad.dtype == leaf.dtype == w.dtype, name
        assert torch.equal(leaf.grad, w), name
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe.FusedEdgeTailAggPeBf16.apply(False, *ops)


def test_bf16_builds_at_width_128_and_the_widths_still_refused():
    """The bf16 launchers take the width-128 fold and pe builds and the
    width-64 pe build (a CPU tensor then stops at the device) and refuse
    every other unbuilt width and depth with ``NotImplementedError``, and
    operands outside the lane's dtypes."""
    bf, z = torch.bfloat16, torch.zeros
    graph = csr_from_edges(torch.tensor([1, 2, 0]), torch.tensor([0, 1, 2]),
                           3)

    def fold(ce, h, c, l1):
        return (z(3, ce, dtype=bf), z(ce, h, dtype=bf), z(h, dtype=bf),
                z(3, h, dtype=bf), z(3, h, dtype=bf), graph.senders,
                graph.rowptr, z(l1, h, h, dtype=bf), z(l1, h, dtype=bf),
                z(h, c, dtype=bf), z(c, dtype=bf), z(c), z(c))

    def pe(h, c, l1):
        return (z(3, h, dtype=bf), z(3, h, dtype=bf), z(3, h, dtype=bf),
                graph.senders, graph.rowptr, graph.snd_ptr, graph.snd_perm,
                z(l1, h, h, dtype=bf), z(l1, h, dtype=bf), z(h, c, dtype=bf),
                z(c, dtype=bf), z(c), z(c))

    assert (128, 128, 128) in fe.KERNEL_WIDTHS["fold_bf16"]
    assert fe.KERNEL_WIDTHS["pe_bf16"] == {(64, 32), (128, 128)}
    for launch, ops in ((fe._launch_bf16_fwd, fold(128, 128, 128, 3)),
                        (fe._launch_pe_bf16_fwd, pe(128, 128, 3)),
                        (fe._launch_pe_bf16_fwd, pe(64, 32, 3))):
        with pytest.raises(ValueError, match="no fused edge kernel"):
            launch(*ops)
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe._launch_bf16_bwd(*fold(128, 128, 128, 3), z(3, 128))
    for h, c in ((128, 128), (64, 32)):
        with pytest.raises(ValueError, match="no fused edge kernel"):
            fe._launch_pe_bf16_bwd(*pe(h, c, 3), z(3, c))
    for ops in (pe(64, 32, 4), pe(128, 128, 4), pe(128, 64, 1)):
        with pytest.raises(NotImplementedError, match="no bf16 build"):
            fe._launch_pe_bf16_fwd(*ops)
    for ops in (fold(128, 128, 128, 4), fold(64, 128, 128, 3)):
        with pytest.raises(NotImplementedError, match="no bf16 build"):
            fe._launch_bf16_fwd(*ops)
    mixed = list(pe(128, 128, 3))
    mixed[1] = mixed[1].float()
    with pytest.raises(TypeError, match="pxj must be torch.bfloat16"):
        fe.fused_edge_tail_agg_pe_bf16(*mixed)
    with pytest.raises(TypeError, match="must be torch.float32"):
        fe.fused_edge_tail_agg_pe(*pe(128, 128, 3))


# ---- one width-128 step on each lane ---------------------------------------

@pytest.mark.parametrize("impl", ["kernel_fold", "kernel_pe"])
def test_interaction_network_step_bf16_at_width_128_matches_jax(monkeypatch,
                                                               impl):
    """One bf16 step at latent = hidden = 128 (the edge scale 4 a bf16
    scalar, as the JAX processor carries it): its node latents and the
    gradients of sum(x' * G) in every parameter and in x, against the JAX
    step in interpret mode on the fold lane (``fused_edge_tail_agg2rf``) or,
    under ``MAGNET_TPU_NO_FUSED2R``, the pe lane (``fused_edge_tail_agg2``
    on the bf16 pe of ``_project_edges``)."""
    jg, tg, x, e_blk, e_csr = _graph_pair(B=1, n=100, r=0.05, C=W, seed=21)
    net = batch_vmap(jax_graphnet.InteractionNetwork, in_axes=(0, 0, 0, None),
                     node_out=W, edge_out=W, mlp_layers=2, mlp_hidden=W,
                     dtype=BF)
    xb, eb = jnp.asarray(x).astype(BF), jnp.asarray(e_blk).astype(BF)
    scale = jnp.asarray(4.0, BF)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    if impl == "kernel_pe":
        monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    rng = np.random.default_rng(22)
    one = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32),
        jax.jit(net.init)(jax.random.PRNGKey(5), xb, eb, jg, scale)["params"])
    G = rng.normal(size=x.shape).astype(np.float32)

    def inet(p, xv):
        return net.apply({"params": p}, xv, eb, jg, scale)[0]

    want = jax.jit(inet)(one, xb)
    lane = dict(jax_graphnet.LAST_FUSED_LANE)
    assert want.dtype == BF and lane["mode"] == "vmem"
    assert lane["fold"] is (impl == "kernel_fold")
    d_p, d_x = jax.jit(jax.grad(
        lambda p, xv: jnp.sum(inet(p, xv).astype(jnp.float32) * G),
        argnums=(0, 1)))(one, xb)
    step = InteractionNetwork(W, 2, W, dtype=torch.bfloat16)
    sd = {}
    _processor(sd, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], one)}}, 1, 2)
    step.load_state_dict({k.removeprefix("p.gnn_stacks.0."): v
                          for k, v in sd.items()})
    xt = torch.from_numpy(x.reshape(-1, W)).bfloat16().requires_grad_()
    got = step(xt, torch.from_numpy(e_csr).bfloat16(), tg, e_scale=4.0,
               impl=impl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32).reshape(-1, W),
                               STEP_RTOL, STEP_ATOL)
    (got.float() * torch.from_numpy(G.reshape(-1, W))).sum().backward()
    assert rel_l2(xt.grad.float().numpy(),
                  np.asarray(d_x, np.float32).reshape(-1, W)) < STEP_GRAD_L2
    sd_grad = {}
    _processor(sd_grad, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], d_p)}}, 1, 2)
    for name, prm in step.named_parameters():
        assert prm.grad.dtype == torch.float32
        assert rel_l2(prm.grad.numpy(),
                      sd_grad[f"p.gnn_stacks.0.{name}"].numpy()
                      ) < STEP_GRAD_L2, name


# ---- the lanes of the GNN graphs in bf16 -----------------------------------

def _gnn2d_coords(regular, seed):
    """MAgNet[GNN] 2D's node sets (support ∪ queries) of two samples at the
    published configuration: the 512-node irregular training mesh with 256
    queries, or the regular 32 x 32 eval grid (support every second node,
    queries the rest)."""
    res, nt = (32, 4) if regular else (64, 4)
    arrays = make_split("B2D", 2, nt, res, seed=seed,
                        n_nodes=None if regular else 512)
    ds = DatasetImplicitGNN2D(arrays, "test" if regular else "train", nt=nt,
                              res=res, regular=regular, samples=256,
                              n_nodes=None if regular else 512)
    ds.set_epoch(0)
    b = collate([ds[0], ds[1]])
    return np.concatenate([b["coords_lr"], b["coords_hr"]], axis=1)


# (coordinates of the LR ∪ HR node set, radius): MAgNet[GNN] 1D's eval (all
# odd queries) and training (32 queries) graphs and its LR graph, 2D's
# training and eval graphs at the published configuration
LANE_CASES = {
    "gnn_1d_eval": lambda: (_gnn_coords(None, 2, 2), 0.08),
    "gnn_1d_train": lambda: (_gnn_coords(32, 2, 2), 0.08),
    "gnn_1d_lr": lambda: (_gnn_coords(0, 2, 2), 0.08),
    "gnn_2d_train": lambda: (_gnn2d_coords(False, seed=7), 0.08),
    "gnn_2d_eval": lambda: (_gnn2d_coords(True, seed=8), 0.08),
}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_jax_bf16_step_takes_the_fold_lane_on_the_gnn_graphs(case):
    """The JAX bf16 step at MAgNet[GNN]'s width (``LAST_FUSED_LANE``, from
    an ``eval_shape`` of its init on one sample of the graph) takes the
    fold-e lane (``fused_edge_tail_agg2rf``) on every MAgNet[GNN] graph,
    the lane the port's ``graphnet_lane`` gives: the JAX no-fold ragged
    lanes, which round pe elsewhere in bf16, are never taken there, so the
    port's mapping of them to ``fold`` computes nothing else."""
    coords, r = LANE_CASES[case]()
    coords = np.ascontiguousarray(coords, np.float32)
    gs = _jax_graph(coords, r, loop=True)
    t, et = gs.blk_recv_local.shape
    net = jax_graphnet.InteractionNetwork(node_out=W, edge_out=W,
                                          mlp_layers=4, mlp_hidden=W,
                                          dtype=BF)
    x = jax.ShapeDtypeStruct((coords.shape[1], W), BF)
    e = jax.ShapeDtypeStruct((t * et, W), BF)
    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    jax.eval_shape(lambda a, b: net.init(jax.random.PRNGKey(0), a, b, gs,
                                         jnp.asarray(1.0, BF)), x, e)
    lane = dict(jax_graphnet.LAST_FUSED_LANE)
    assert lane["mode"] == "vmem" and lane["ragged"] and lane["fold"], lane
    graph = GraphCache(lane_rule=("graphnet", W)).radius_graph_batch(
        coords, r, loop=True)
    assert graph.lane == "fold"


# ---- MAgNet[GNN] 1D and 2D -------------------------------------------------

def _model_grads_close(tm, d_p, f32_grads, hp, pos_dim):
    """Every parameter gradient of ``tm`` against the JAX bf16 tree
    ``d_p``, each within PARAM_GRAD_L2 or else VS_JAX_BF16_TO_F32 times the
    distance of ``d_p`` from ``f32_grads()``, the JAX f32 model's tree."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, d_p), hp,
                               "magnet_gnn", pos_dim=pos_dim)
    want32 = {}
    got_all, want_all = [], []
    for name, prm in tm.named_parameters():
        w = want[name].numpy()
        assert prm.grad.dtype == torch.float32, name
        assert np.isfinite(prm.grad.numpy()).all(), name
        err = rel_l2(prm.grad.numpy(), w)
        if err >= PARAM_GRAD_L2:
            if not want32:
                want32.update(state_dict_from_jax(
                    jax.tree.map(np.asarray, f32_grads()), hp, "magnet_gnn",
                    pos_dim=pos_dim))
            assert err < VS_JAX_BF16_TO_F32 * rel_l2(
                w, want32[name].numpy()), name
        got_all.append(prm.grad.numpy().ravel())
        want_all.append(w.ravel())
    assert rel_l2(np.concatenate(got_all),
                  np.concatenate(want_all)) < MODEL_GRAD_L2


# two samples on each side, two windows: 1D on a 64-node Heat mesh (32
# support nodes, 8 training queries), 2D on a seeded 64-node irregular
# Burgers mesh (32 support nodes, 16 queries), at test_torch_gnn's widths
MODEL_HP = {1: dict(GNN_HP, time_slice=8), 2: dict(GNN_HP, time_slice=4,
                                                   radius=0.3)}
_PARAMS: dict = {}
_F32_GRADS: dict = {}


def _model_pair(pos_dim, graph_dtype="bf16"):
    """The JAX MAgNet[GNN] (P = ``pos_dim``; in 2D its native neighbour
    search) and the port's, both with ``graph_dtype``, on the same f32
    weights (one JAX init per P), and one training batch on both sides."""
    from magnet_tpu.models.factory import create_model as jax_create_model
    from magnet_tpu_torch.data.datasets import DatasetImplicitGNN1D

    hp = dict(MODEL_HP[pos_dim], graph_dtype=graph_dtype)
    if pos_dim == 1:
        ds = DatasetImplicitGNN1D(make_split("Heat", 2, 24, 64, seed=3),
                                  "train", nt=24, nx=64, samples=8)
    else:
        ds = DatasetImplicitGNN2D(
            make_split("B2D", 2, 12, 16, seed=12, n_nodes=64), "train",
            nt=12, res=16, regular=False, samples=16, n_nodes=64)
    ds.set_epoch(5)
    batch = collate([ds[0], ds[1]])
    jm = jax_create_model("magnet_gnn", hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    if pos_dim not in _PARAMS:
        _PARAMS[pos_dim] = jax.tree.map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), jb, jg))
    params = _PARAMS[pos_dim]
    tm = create_model("magnet_gnn", hp, device="cpu",
                      kind=f"h5_implicit_gnn_{pos_dim}d")
    tm.load_state_dict(state_dict_from_jax(params, hp, "magnet_gnn",
                                           pos_dim=pos_dim))
    return jm, params, jb, jg, tm, to_device(batch, "cpu")


def _jax_loss_and_grads(jm, params, jb, jg):
    """A JAX MAgNet[GNN]'s teacher-forcing training loss and its gradient
    tree."""
    return jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True)[0]))(params)


def _f32_grads(pos_dim, monkeypatch):
    """The gradient tree of the JAX f32 model on ``_model_pair``'s
    parameters and batch, by its plain references (the f32 kernels compute
    the same function): the scale of each parameter's bf16 sensitivity."""
    if pos_dim not in _F32_GRADS:
        with monkeypatch.context() as m:
            m.delenv("MAGNET_TPU_PALLAS_INTERPRET", raising=False)
            m.delenv("MAGNET_TPU_NO_FUSED2R", raising=False)
            jm, params, jb, jg, *_ = _model_pair(pos_dim, None)
            _F32_GRADS[pos_dim] = _jax_loss_and_grads(jm, params, jb, jg)[1]
    return _F32_GRADS[pos_dim]


@pytest.mark.parametrize("pos_dim", [1, 2])
def test_magnet_gnn_bf16_matches_jax(monkeypatch, pos_dim):
    """MAgNet[GNN] with graph_dtype=bf16 against the JAX bf16 model on the
    same f32 parameters, its GraphNet stages on the bf16 fold kernels in
    interpret mode: the GraphNet modules in bf16, the parameter tree
    unchanged and f32, the rollout and eval loss, the teacher-forcing
    training loss and every parameter gradient; in 2D (P = 2) on the JAX
    package's native neighbour search."""
    assert pos_dim == 1 or jax_graph._native is not None
    jm, params, jb, jg, tm, tb = _model_pair(pos_dim)
    assert tm.pos_dim == pos_dim
    assert tm.processor.dtype == tm._processor.dtype == (
        tm._encoder.node_fn[0].dtype) == tm._decoder.node_fn.dtype == (
        torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    graphs = tm.build_graph(tb)
    assert graphs.lr.lane == graphs.all.lane == "fold"
    want_pred, want_eval, (want_loss, d_p) = jax.jit(lambda p: (
        jm.predict(p, jb, jg), jm.loss(p, jb, jg, train=False)[0],
        jax.value_and_grad(lambda q: jm.loss(q, jb, jg, train=True)[0])(p)
    ))(params)
    assert jax_graphnet.LAST_FUSED_LANE["fold"]
    got_pred = tm.predict(tb, graphs)
    for g, w in zip(got_pred, want_pred):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert rel_l2(g.numpy(), w) < PRED_L2
    got_eval, _ = tm.loss(tb, graphs, train=False)
    assert abs(float(got_eval) - float(want_eval)) < PRED_L2 * float(want_eval)

    tm.zero_grad(set_to_none=True)
    loss, _ = tm.loss(tb, graphs, train=True)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LOSS_RTOL * float(want_loss)
    _model_grads_close(tm, d_p, lambda: _f32_grads(pos_dim, monkeypatch),
                       MODEL_HP[pos_dim], pos_dim)


def test_magnet_gnn_bf16_kernel_pe_lane_matches_jax_no_fused2r(monkeypatch):
    """MAgNet[GNN] 1D's training loss and gradients on the pe lane's bf16
    build (``impl="kernel_pe"``) against the JAX bf16 model under
    ``MAGNET_TPU_NO_FUSED2R`` (its ``fused_edge_tail_agg2`` lane) in
    interpret mode."""
    jm, params, jb, jg, tm, tb = _model_pair(1)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    want_loss, d_p = _jax_loss_and_grads(jm, params, jb, jg)
    lane = dict(jax_graphnet.LAST_FUSED_LANE)
    assert lane["mode"] == "vmem" and not lane["ragged"] and not lane["fold"]
    tm.impl = "kernel_pe"
    tm.zero_grad(set_to_none=True)
    try:
        loss, _ = tm.loss(tb, tm.build_graph(tb), train=True)
        loss.backward()
    finally:
        tm.impl = "kernel"
    assert abs(loss.item() - float(want_loss)) < LOSS_RTOL * float(want_loss)
    _model_grads_close(tm, d_p, lambda: _f32_grads(1, monkeypatch),
                       MODEL_HP[1], 1)


def test_magnet_gnn_bf16_stays_near_f32_and_trains():
    """The bf16 lane's training and eval losses within 5e-2 of the f32
    lane's on the same parameters (``tests/test_models.py``'s bound), every
    parameter gradient finite and not all zero, and the weights' round trip
    through ``import_torch`` unchanged by the dtype."""
    _, params, _, _, tm, tb = _model_pair(1)
    hp = dict(MODEL_HP[1], graph_dtype="bf16")
    t32 = create_model("magnet_gnn", MODEL_HP[1], device="cpu")
    t32.load_state_dict(tm.state_dict())
    losses = {}
    for name, m in (("bf16", tm), ("float32", t32)):
        graphs = m.build_graph(tb)
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss(tb, graphs, train=True)
        loss.backward()
        losses[name] = loss.item(), m.loss(tb, graphs, train=False)[0].item()
        for pname, prm in m.named_parameters():
            assert torch.isfinite(prm.grad).all(), pname
            assert prm.grad.abs().max() > 0, pname
    for bf, f32 in zip(losses["bf16"], losses["float32"]):
        assert bf != f32
        assert abs(bf - f32) < VS_F32_RTOL * max(1.0, abs(f32))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = import_state_dict("magnet_gnn", sd, hp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_run_and_eval_take_graph_dtype_for_magnet_gnn(tmp_path):
    """``model=magnet_gnn model.graph_dtype=bf16`` through ``run.py``
    (``Trainer.fit``, one epoch, on the seeded KS source) and ``eval.py``
    (the seeded Heat test split), on the CPU at a cut width: the model
    built in bf16, a finite training loss, and a test loss within the f32
    lane's 5e-2 (``tests/test_models.py``'s bound)."""
    from magnet_tpu_torch import eval as port_eval
    from magnet_tpu_torch import run as port_run

    small = ["model.latent_dim=16", "model.num_message_passing_steps=1",
             "model.mlp_layers=2", "model.mlp_hidden=16", "model.n_chan=16",
             "model.time_slice=8"]
    trainer = port_run.main(
        ["model=magnet_gnn", "model.graph_dtype=bf16", "device=cpu",
         "trainer.max_epochs=1", f"workdir={tmp_path}/${{name}}",
         "datamodule.source=synthetic_ks", "datamodule.n_train=2",
         "datamodule.n_val=2", "datamodule.n_test=2",
         "datamodule.burn_in=0.5", "datamodule.nt_train=32",
         "datamodule.nt_val=32", "datamodule.nx_train=64",
         "datamodule.nx_val=64", "datamodule.batch_size=2",
         "datamodule.samples=8", *small])
    assert trainer.model._processor.dtype == torch.bfloat16
    assert np.isfinite(trainer.ckpt.best)
    out = {}
    for dtype in ("bf16", "float32"):
        out[dtype] = port_eval.main(
            ["model=magnet_gnn", f"model.graph_dtype={dtype}", "device=cpu",
             "n_traj=2", "batch_size=2", "datamodule.source=synthetic_ks",
             "datamodule.nt_test=32", *small])
    assert out["bf16"]["test_loss"] != out["float32"]["test_loss"]
    assert abs(out["bf16"]["test_loss"] - out["float32"]["test_loss"]) < (
        VS_F32_RTOL * out["float32"]["test_loss"])
