"""MAgNet[CNN] 2D's bf16 GraphNet lane (``graph_dtype=bf16``) against the
JAX package on the CPU: the pre-gathered lane's bf16 kernels (#2, #3, and
#1 as the backward of the bf16 sender gather) and the model.

The kernel-level references are the Pallas kernels in interpret mode
(``MAGNET_TPU_PALLAS_INTERPRET=1``, as ``tests/test_ops.py`` runs them):
``fused_edge_tail_agg`` (``_fused_fwd_pallas`` / ``_fused_bwd_pallas``)
through its VJP, which casts every gradient to its operand's dtype, on the
graph of ``test_torch_pregathered_edge.py`` (a receiver of degree 0)
packed twice; ``gather_sender``'s VJP (``blocked_segment_sum`` over the
sender-transpose layout) on bf16 cotangents.  Then one
``InteractionNetwork`` step on the pre-gathered lane (the JAX step forced
there by ``MAGNET_TPU_NO_FUSED2``, as its 2D training graphs take it by
themselves), the lane of each 2D graph in bf16, and MAgNet[CNN] 2D as a
whole on the same f32 parameters, on the small mesh's own lane (fold) and
on the pre-gathered lane forced on both sides.

Tolerances (both sides bf16 with the same rounding points, f32 sums taken
in another order, so a value can round to the neighbouring bf16 number,
2^-8 relative), those of ``tests/test_torch_bf16.py``:
  * the pre-gathered forward elementwise, rtol 1e-2, atol 1e-2; its
    gradients by relative L2 per operand, 1e-2;
  * the bf16 segment sum elementwise, rtol 1e-2 (one bf16 rounding of an
    f32 sum in another order), atol 1e-5;
  * one InteractionNetwork step: node latents rtol 2e-2, atol 2e-2;
    parameter and input gradients by relative L2 per leaf, 5e-2;
  * MAgNet[CNN] 2D: the training loss within 1e-3 relative; the rollout's
    predictions at relative L2 1e-2; parameter gradients by relative L2
    over all parameters, 5e-2, and per parameter 0.15;
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
from magnet_tpu.ops.graph import block_graph  # noqa: E402
from magnet_tpu.ops.segment import (  # noqa: E402
    _transpose_sum_by_sender,
    gather_sender,
)
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.graphnet import InteractionNetwork  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    GraphCache,
    csr_from_edges,
    lane_of,
)
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import _processor, state_dict_from_jax  # noqa: E402
from test_torch_cnn2d import HP, _batch  # noqa: E402
from test_torch_lane import _cnn_coords, _jax_graph  # noqa: E402
from test_torch_modules import _graph_pair  # noqa: E402
from test_torch_pregathered_edge import (  # noqa: E402
    _pregathered_problem,
    _sender_case,
    _slots,
    _tail,
)

BF = jnp.bfloat16
FWD_RTOL, FWD_ATOL, GRAD_L2 = 1e-2, 1e-2, 1e-2
SEG_RTOL, SEG_ATOL = 1e-2, 1e-5
STEP_RTOL, STEP_ATOL, STEP_GRAD_L2 = 2e-2, 2e-2, 5e-2
LOSS_RTOL, PRED_L2, MODEL_GRAD_L2, PARAM_GRAD_L2 = 1e-3, 1e-2, 5e-2, 0.15
# the pregathered kernel's operands in bf16 (ln_s and ln_b stay f32)
BF16_OPERANDS = ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out")


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _bf16_case(L1, seed):
    """``_pregathered_problem`` with its bf16 operands rounded to bf16 (f32
    arrays holding bf16 values), its CSR graph and the port's operands."""
    p = _pregathered_problem(L1, seed=seed)
    for k in ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out"):
        p[k] = torch.from_numpy(p[k]).bfloat16().float().numpy()
    graph = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]),
                           p["n"])
    ops = [torch.from_numpy(p["h0"]).bfloat16(),
           torch.from_numpy(p["pxi"]).bfloat16(), graph.rowptr,
           *(torch.from_numpy(a).bfloat16() for a in _tail(p)[:4]),
           *(torch.from_numpy(a) for a in _tail(p)[4:])]
    return p, graph, ops


def _pallas_fwd_bwd(p, g, monkeypatch):
    """``fused_edge_tail_agg`` (``_fused_fwd_pallas``) on the bf16 operands
    in interpret mode and its VJP (``_fused_bwd_pallas`` with the VJP's
    casts) for the cotangent g (N, C): the per-node sums and the eight
    gradients, in the port's layout (d_h0 per raw edge, node rows)."""
    n, H, C = p["n"], p["pxi"].shape[1], p["w_out"].shape[1]
    blk = block_graph(p["s"], p["r"], n)
    T, et = blk.senders.shape
    e_idx, live = _slots(p["s"], p["r"], n, blk)
    h0 = np.zeros((T, et, H), np.float32)
    h0[live] = p["h0"][e_idx]
    pxi = np.zeros((T * 128, H), np.float32)
    pxi[:n] = p["pxi"]
    g_pad = np.zeros((T * 128, C), np.float32)
    g_pad[:n] = g
    recv, mask = jnp.asarray(blk.recv_local), jnp.asarray(blk.mask)
    tail = [jnp.asarray(a).astype(BF) for a in _tail(p)[:4]] + [
        jnp.asarray(a) for a in _tail(p)[4:]]
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    out, vjp = jax.vjp(
        lambda *a: pk.fused_edge_tail_agg(*a, recv, mask),
        jnp.asarray(h0).astype(BF),
        jnp.asarray(pxi.reshape(T, 128, H)).astype(BF), *tail)
    assert out.dtype == jnp.float32
    d = vjp(jnp.asarray(g_pad.reshape(T, 128, C)))
    grads = [d[0][live][np.argsort(e_idx)], d[1].reshape(-1, H)[:n], *d[2:]]
    return np.asarray(out).reshape(-1, C)[:n], grads


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_plain_bf16_pregathered_forward_matches_pallas_interpret(
        monkeypatch, L1):
    p, _, ops = _bf16_case(L1, seed=90 + L1)
    g = np.zeros((p["n"], p["w_out"].shape[1]), np.float32)
    want, _ = _pallas_fwd_bwd(p, g, monkeypatch)
    got = fe.fused_edge_tail_agg_pregathered_bf16_plain(*ops)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, FWD_RTOL, FWD_ATOL)
    np.testing.assert_array_equal(got[p["n"] // 2].numpy(), 0.0)  # degree 0


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_plain_bf16_pregathered_backward_matches_pallas_interpret(
        monkeypatch, L1):
    p, _, ops = _bf16_case(L1, seed=95 + L1)
    g = np.random.default_rng(L1).normal(
        size=(p["n"], p["w_out"].shape[1])).astype(np.float32)
    _, want = _pallas_fwd_bwd(p, g, monkeypatch)
    got = fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(
        *ops, torch.from_numpy(g))
    assert len(got) == len(fe.GRAD_NAMES_PREGATHERED) == len(want)
    for name, a, b in zip(fe.GRAD_NAMES_PREGATHERED, got, want):
        want_dtype = BF if name in BF16_OPERANDS else jnp.float32
        assert b.dtype == want_dtype, name
        assert a.dtype == (torch.bfloat16 if name in BF16_OPERANDS
                           else torch.float32), name
        assert tuple(a.shape) == b.shape, name
        if a.numel():
            assert rel_l2(a.float().numpy(),
                          np.asarray(b, np.float32)) < GRAD_L2, name
    np.testing.assert_array_equal(got[1][p["n"] // 2].float().numpy(), 0.0)


@pytest.mark.parametrize("L1", [0, 3])
def test_pregathered_bf16_wrapper_on_cpu_is_the_plain_pair(L1):
    """On CPU tensors ``fused_edge_tail_agg_pregathered_bf16`` is the plain
    forward and, under autograd, the plain backward, each gradient in its
    operand's dtype; nothing is launched, and neither does the bf16
    segment sum of the sender gather's backward."""
    p, graph, ops = _bf16_case(L1, seed=100 + L1)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(p["n"], p["w_out"].shape[1])).astype(np.float32))
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in ops]
    before = (fe.launch_counts(), seg.launches, seg.launches_bf16)
    out = fe.fused_edge_tail_agg_pregathered_bf16(*leaves)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    np.testing.assert_array_equal(
        out.detach().numpy(),
        fe.fused_edge_tail_agg_pregathered_bf16_plain(*ops).numpy())
    out.backward(g)
    want = fe.fused_edge_tail_agg_pregathered_bf16_bwd(*ops, g)
    floats = [t for t in leaves if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES_PREGATHERED, floats, want):
        assert leaf.grad.dtype == leaf.dtype == w.dtype, name
        assert torch.equal(leaf.grad, w), name
    pxj = ops[1].clone().requires_grad_()
    seg.gather_rows(pxj, graph).sum().backward()
    assert pxj.grad.dtype == torch.bfloat16
    assert (fe.launch_counts(), seg.launches, seg.launches_bf16) == before
    # the kernel path refuses these widths (no build) before any device
    with pytest.raises(NotImplementedError, match="no bf16 build"):
        fe.FusedEdgeTailAggPregatheredBf16.apply(False, *ops)


def test_bf16_segment_sum_matches_gather_sender_vjp(monkeypatch):
    """``segment_sum_plain`` on bf16 rows (an f32 sum rounded once) and
    ``GatherRows``' bf16 gradient against ``_transpose_sum_by_sender`` and
    ``gather_sender``'s VJP on the same bf16 cotangents."""
    gs, graph, d_csr, d_blk = _sender_case(seed=7, C=64)
    d_csr = torch.from_numpy(d_csr).bfloat16()
    d_blk = jnp.asarray(d_blk).astype(BF)
    p = torch.from_numpy(np.random.default_rng(2).normal(
        size=(graph.n_node, 64)).astype(np.float32)).bfloat16()
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want_sum = _transpose_sum_by_sender(d_blk, gs)
    _, vjp = jax.vjp(lambda a: gather_sender(a, gs),
                     jnp.asarray(p.float().numpy()).astype(BF))
    want = vjp(d_blk)[0]
    assert want_sum.dtype == want.dtype == BF
    got_sum = seg.segment_sum_plain(d_csr, graph.snd_ptr, graph.snd_perm)
    assert got_sum.dtype == torch.bfloat16
    np.testing.assert_allclose(got_sum.float().numpy(),
                               np.asarray(want_sum, np.float32), SEG_RTOL,
                               SEG_ATOL)
    np.testing.assert_array_equal(got_sum[7].float().numpy(), 0.0)
    # rounded once: the f32 sum's bf16 neighbour, not a sum of bf16 adds
    f32 = seg.segment_sum_plain(d_csr.float(), graph.snd_ptr, graph.snd_perm)
    assert torch.equal(got_sum, f32.bfloat16())
    leaf = p.clone().requires_grad_()
    rows = seg.gather_rows(leaf, graph)
    assert rows.dtype == torch.bfloat16
    rows.backward(d_csr)
    assert leaf.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(leaf.grad.float().numpy(),
                               np.asarray(want, np.float32), SEG_RTOL,
                               SEG_ATOL)


def test_interaction_network_step_bf16_pregathered_matches_jax(monkeypatch):
    """One bf16 step on the pre-gathered lane (the edge scale 4 a bf16
    scalar, as the JAX processor carries it): its node latents and the
    gradients of sum(x' * G) in every parameter and in x, against the JAX
    step on its pre-gathered lane in interpret mode (``_project_edges``,
    the bf16 sender gather with #1 as its backward, #2/#3)."""
    jg, tg, x, e_blk, e_csr = _graph_pair(n=100, seed=15)
    net = batch_vmap(jax_graphnet.InteractionNetwork, in_axes=(0, 0, 0, None),
                     node_out=8, edge_out=8, mlp_layers=HP["mlp_layers"],
                     mlp_hidden=HP["mlp_hidden"], dtype=BF)
    xb, eb = jnp.asarray(x).astype(BF), jnp.asarray(e_blk).astype(BF)
    scale = jnp.asarray(4.0, BF)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2", "1")
    rng = np.random.default_rng(16)
    one = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32),
        jax.jit(net.init)(jax.random.PRNGKey(3), xb, eb, jg, scale)["params"])
    G = rng.normal(size=x.shape).astype(np.float32)

    def inet(p, xv):
        return net.apply({"params": p}, xv, eb, jg, scale)[0]

    want = jax.jit(inet)(one, xb)
    assert want.dtype == BF
    assert jax_graphnet.LAST_FUSED_LANE["mode"] is None  # pre-gathered
    d_p, d_x = jax.jit(jax.grad(
        lambda p, xv: jnp.sum(inet(p, xv).astype(jnp.float32) * G),
        argnums=(0, 1)))(one, xb)
    step = InteractionNetwork(8, HP["mlp_layers"], HP["mlp_hidden"],
                              dtype=torch.bfloat16)
    sd = {}
    _processor(sd, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], one)}}, 1, HP["mlp_layers"])
    step.load_state_dict({k.removeprefix("p.gnn_stacks.0."): v
                          for k, v in sd.items()})
    xt = torch.from_numpy(x.reshape(-1, 8)).bfloat16().requires_grad_()
    got = step(xt, torch.from_numpy(e_csr).bfloat16(), tg, e_scale=4.0,
               impl="kernel_pregathered")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32).reshape(-1, 8),
                               STEP_RTOL, STEP_ATOL)
    (got.float() * torch.from_numpy(G.reshape(-1, 8))).sum().backward()
    assert rel_l2(xt.grad.float().numpy(),
                  np.asarray(d_x, np.float32).reshape(-1, 8)) < STEP_GRAD_L2
    sd_grad = {}
    _processor(sd_grad, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], d_p)}}, 1, HP["mlp_layers"])
    for name, prm in step.named_parameters():
        assert prm.grad.dtype == torch.float32
        assert rel_l2(prm.grad.numpy(),
                      sd_grad[f"p.gnn_stacks.0.{name}"].numpy()
                      ) < STEP_GRAD_L2, name


@pytest.mark.parametrize("scale,frozen", [(256.0, False), (512.0, True)])
def test_edge_bias_gradient_where_one_minus_s_rounds_to_minus_s(
        monkeypatch, scale, frozen):
    """The JAX step's bf16 pe = s·pe + (1 − s)·b_e: at s = 2^9, 1 − s
    rounds to −s in bf16, so b_e's two paths cancel and its gradient is
    exactly zero in both packages (MAgNet[CNN] 2D's tenth step); at s = 2^8
    (1 − s exact) both give it a nonzero gradient.  Its value there is the
    difference of two bf16 sums 2^8 times larger, which the two packages
    round in another order, so it is not compared (the step at s = 4 is,
    above).  The JAX side runs its jnp reference (``MAGNET_TPU_NO_PALLAS``):
    the kernels do not touch pe."""
    jg, tg, x, e_blk, e_csr = _graph_pair(B=1, n=60, seed=17)
    net = batch_vmap(jax_graphnet.InteractionNetwork, in_axes=(0, 0, 0, None),
                     node_out=8, edge_out=8, mlp_layers=HP["mlp_layers"],
                     mlp_hidden=HP["mlp_hidden"], dtype=BF)
    xb, eb = jnp.asarray(x).astype(BF), jnp.asarray(e_blk).astype(BF)
    s = jnp.asarray(scale, BF)
    monkeypatch.setenv("MAGNET_TPU_NO_PALLAS", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2", "1")
    one = jax.jit(net.init)(jax.random.PRNGKey(4), xb, eb, jg, s)["params"]
    G = np.random.default_rng(18).normal(size=x.shape).astype(np.float32)
    d_p = jax.jit(jax.grad(lambda p: jnp.sum(
        net.apply({"params": p}, xb, eb, jg, s)[0].astype(jnp.float32)
        * G)))(one)
    want = np.asarray(d_p["e_w_e"]["bias"])
    step = InteractionNetwork(8, HP["mlp_layers"], HP["mlp_hidden"],
                              dtype=torch.bfloat16)
    sd = {}
    _processor(sd, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], one)}}, 1, HP["mlp_layers"])
    step.load_state_dict({k.removeprefix("p.gnn_stacks.0."): v
                          for k, v in sd.items()})
    got = step(torch.from_numpy(x.reshape(-1, 8)).bfloat16(),
               torch.from_numpy(e_csr).bfloat16(), tg, e_scale=scale,
               impl="kernel_pregathered")
    (got.float() * torch.from_numpy(G.reshape(-1, 8))).sum().backward()
    bias = step.edge_fn[0].linears[0].bias.grad.numpy()
    assert (not want.any()) == (not bias.any()) == frozen


@pytest.mark.parametrize("case,batch,queries,expected", [
    ("train", 8, 32, "pregathered"), ("eval", 1, None, "fold")])
def test_lane_of_2d_graphs_in_bf16_is_the_jax_steps(case, batch, queries,
                                                    expected):
    """The JAX bf16 step's lane (``LAST_FUSED_LANE``, from a trace of the
    step at MAgNet[CNN] 2D's widths on one sample of the graph) against the
    port's ``lane_of`` on the same coordinates: the 2D training graph (32²
    LR grid ∪ 32 queries) takes the pre-gathered lane, the eval graph (∪
    the whole 64² mesh) the fold lane, in bf16 as in f32."""
    coords = np.ascontiguousarray(
        _cnn_coords([32, 32], queries, batch, seed=3), np.float32)
    gs = _jax_graph(coords, 0.1, loop=True)
    t, et = gs.blk_recv_local.shape
    net = jax_graphnet.InteractionNetwork(node_out=32, edge_out=32,
                                          mlp_layers=4, mlp_hidden=64,
                                          dtype=BF)
    x = jax.ShapeDtypeStruct((coords.shape[1], 32), BF)
    e = jax.ShapeDtypeStruct((t * et, 32), BF)
    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    jax.eval_shape(lambda a, b: net.init(jax.random.PRNGKey(0), a, b, gs,
                                         jnp.asarray(1.0, BF)), x, e)
    mode = jax_graphnet.LAST_FUSED_LANE["mode"]
    assert mode != "unset"
    want = "pregathered" if mode is None else "fold"
    graph = GraphCache(lane_rule=("graphnet", 64)).radius_graph_batch(
        coords, 0.1, loop=True)
    assert graph.lane == lane_of(graph, "graphnet", 64) == want == expected


@pytest.fixture(scope="module")
def models():
    """The JAX MAgNet[CNN] 2D with graph_dtype=bf16 (f32 params, perturbed
    so that the LayerNorm affines are not ones and zeros) and the port's
    bf16 and f32 models loaded with them."""
    batch = _batch("train", seed=5)
    jm = jax_create_model("magnet_cnn_2d", dict(HP, graph_dtype="bf16"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jb, jm.build_graph(batch))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), params)
    sd = state_dict_from_jax(params, HP, model="magnet_cnn_2d")
    ports = {}
    for dtype in ("bf16", "float32"):
        tm = create_model("magnet_cnn_2d", dict(HP, graph_dtype=dtype),
                          device="cpu")
        tm.load_state_dict(sd)
        ports[dtype] = tm
    return jm, params, ports


def test_magnet_cnn_2d_bf16_parameter_tree_and_rollout_match_jax(
        models, monkeypatch):
    """The bf16 model's parameters are the f32 model's tree, all f32
    (``state_dict_from_jax`` carries the JAX bf16 model's params as they
    are); its GraphNet stage runs in bf16; the eval rollout and loss on the
    test split's graph (the fold lane on this mesh) match the JAX model's
    in interpret mode."""
    jm, params, ports = models
    tm = ports["bf16"]
    assert tm._processor.dtype == tm._encoder.node_fn[0].dtype == (
        tm._decoder.node_fn.dtype) == torch.bfloat16
    assert ports["float32"]._processor.dtype is None
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert tm.state_dict().keys() == ports["float32"].state_dict().keys()
    batch = _batch("test", seed=6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = to_device(batch, "cpu")
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    jg = jm.build_graph(batch)
    want_hr, _ = jax.jit(jm.predict)(params, jb, jg)
    assert jax_graphnet.LAST_FUSED_LANE["fold"]
    tg = tm.build_graph(tb)
    assert tg.lane == "fold"
    got_hr, _ = tm.predict(tb, tg)
    assert got_hr.dtype == torch.float32
    assert rel_l2(got_hr.numpy(), want_hr) < PRED_L2
    want_loss, _ = jax.jit(lambda p: jm.loss(p, jb, jg, train=False))(params)
    got_loss, _ = tm.loss(tb, tg, train=False)
    assert abs(float(got_loss) - float(want_loss)) < PRED_L2 * float(want_loss)


def test_magnet_cnn_2d_bf16_training_loss_and_grads_match_jax(
        models, monkeypatch):
    """The teacher-forcing training loss (with the interp loss) and every
    parameter gradient of the bf16 model against the JAX bf16 model in
    interpret mode, on the pre-gathered lane, where MAgNet[CNN] 2D trains
    (forced on both sides on this small mesh: the JAX package by
    ``MAGNET_TPU_NO_FUSED2``, the port by ``impl="kernel_pregathered"``);
    the fold lane's bf16 build is the rollout's, above."""
    jm, params, ports = models
    tm = ports["bf16"]
    batch = _batch("train", seed=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    tb = to_device(batch, "cpu")
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2", "1")
    want_loss, d_p = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True)[0]))(params)
    assert jax_graphnet.LAST_FUSED_LANE["mode"] is None
    tm.impl = "kernel_pregathered"
    tm.zero_grad(set_to_none=True)
    try:
        loss, _ = tm.loss(tb, tm.build_graph(tb), train=True)
        loss.backward()
    finally:
        tm.impl = "kernel"
    assert abs(loss.item() - float(want_loss)) < LOSS_RTOL * float(want_loss)
    want = state_dict_from_jax(jax.tree.map(np.asarray, d_p), HP,
                               model="magnet_cnn_2d")
    got_all, want_all = [], []
    for name, prm in tm.named_parameters():
        w = want[name].numpy()
        assert prm.grad.dtype == torch.float32, name
        assert np.isfinite(prm.grad.numpy()).all(), name
        assert rel_l2(prm.grad.numpy(), w) < PARAM_GRAD_L2, name
        got_all.append(prm.grad.numpy().ravel())
        want_all.append(w.ravel())
    assert rel_l2(np.concatenate(got_all),
                  np.concatenate(want_all)) < MODEL_GRAD_L2


def test_run_and_eval_take_graph_dtype_for_magnet_cnn_2d(tmp_path):
    """``model.graph_dtype=bf16`` through ``run.py`` (``Trainer.fit``, one
    epoch) and ``eval.py`` for MAgNet[CNN] 2D, on the CPU at a cut width on
    the synthetic Burgers-2D source: the model built in bf16, a finite
    training loss, and a test loss within the f32 lane's 5e-2
    (``tests/test_models.py``'s bound)."""
    from magnet_tpu_torch import eval as port_eval
    from magnet_tpu_torch import run as port_run

    small = ["model.latent_dim=8", "model.num_message_passing_steps=2",
             "model.mlp_layers=2", "model.mlp_hidden=16", "model.n_chan=8",
             "model.res_layers=1", "model.time_slice=16"]
    data = ["datamodule.source=synthetic_burgers_2d", "datamodule.n_train=2",
            "datamodule.n_val=2", "datamodule.n_test=2",
            "datamodule.batch_size=2", "datamodule.samples=8"]
    trainer = port_run.main(
        ["model=magnet_cnn_2d", "model.graph_dtype=bf16", "device=cpu",
         "trainer.max_epochs=1", f"workdir={tmp_path}/${{name}}", *small,
         *data])
    assert trainer.model._processor.dtype == torch.bfloat16
    assert np.isfinite(trainer.ckpt.best)
    out = {}
    for dtype in ("bf16", "float32"):
        out[dtype] = port_eval.main(
            ["model=magnet_cnn_2d", f"model.graph_dtype={dtype}",
             "device=cpu", "n_traj=2", "batch_size=2",
             "datamodule.source=synthetic_burgers_2d", *small])
    assert out["bf16"]["test_loss"] != out["float32"]["test_loss"]
    assert abs(out["bf16"]["test_loss"] - out["float32"]["test_loss"]) < (
        5e-2 * out["float32"]["test_loss"])
