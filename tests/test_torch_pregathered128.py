"""MAgNet[GNN]'s pre-gathered lane (``impl="kernel_pregathered"``) at the
width-128 form of the pregathered entry, (H, C) = (128, 128), against the
JAX package on the CPU, in f32 and in bf16 (``graph_dtype=bf16``).

The JAX package runs this lane under ``MAGNET_TPU_NO_FUSED2``: its
GraphNet step then has no fused2 mode and takes ``fused_edge_tail_agg``
(``_fused_fwd_pallas`` / ``_fused_bwd_pallas``, #2 / #3) on h0 =
p_xj[s] + pe, formed outside the kernel, whose sender gather sums its
cotangent over the sender-transpose layout in f32 (``gather_sender``) on
every MAgNet[GNN] graph, as the port's #1 does.  The references:

  * the bf16 plain pair at (128, 128) (``fused_edge_tail_agg_pregathered_
    bf16_plain`` / ``_bwd_plain``) against ``fused_edge_tail_agg`` and its
    VJP in Pallas interpret mode (``MAGNET_TPU_PALLAS_INTERPRET=1``), on
    ``tests/test_torch_fused_edge.py``'s graph (a receiver of degree 0) in
    the JAX blocked layout, L1 = 1 and 3; the wrapper on CPU tensors is
    that pair and launches nothing;
  * one ``InteractionNetwork`` step at latent = hidden = 128 (L1 = 1) on
    ``impl="kernel_pregathered"`` against the JAX step under
    ``MAGNET_TPU_NO_FUSED2`` in interpret mode, f32 and bf16;
  * MAgNet[GNN] 1D and 2D at the published GraphNet widths (latent and
    hidden 128, four MLP layers: L1 = 3; two message-passing steps of the
    published five) on small data (``tests/test_torch_bf16_gnn.py``'s), the
    weights carried by ``weights.state_dict_from_jax``: the training loss
    and every parameter's gradient on ``impl="kernel_pregathered"`` against
    the JAX model under ``MAGNET_TPU_NO_FUSED2``, f32 through the JAX
    package's plain reference of the kernels (its CPU path), bf16 in
    interpret mode.

Inputs come from seeds with numpy.  Tolerances:
  * bf16 pair: forward rtol 1e-2, atol 1e-2; gradients by relative L2 per
    operand 1e-2 (``tests/test_torch_bf16_2d.py``'s: both sides round at
    the same points, f32 sums in another order, 2^-8 relative);
  * the f32 step: node latents rtol 1e-4, atol 1e-5, parameter and input
    gradients rtol 2e-3, atol 1e-5 of each leaf's largest entry; the bf16
    step: node latents rtol 2e-2, atol 2e-2, gradients by relative L2 per
    leaf 5e-2 (``tests/test_torch_pe64.py``'s);
  * f32 models: the loss rtol 1e-3, atol 1e-4 (``MODEL_F32``), parameter
    gradients rtol 2e-3, atol 1e-5 of each leaf's largest entry;
  * bf16 models: the training loss within 1e-3 relative (``LOSS_RTOL``),
    parameter gradients by ``tests/test_torch_bf16_gnn.py``'s
    ``_model_grads_close`` (relative L2 5e-2 over all parameters, 0.15 per
    parameter, or twice the JAX package's own bf16-to-f32 distance where
    that is larger).
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
from magnet_tpu_torch.data.datasets import (  # noqa: E402
    DatasetImplicitGNN1D,
    DatasetImplicitGNN2D,
)
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.graphnet import InteractionNetwork  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.graph import csr_from_edges  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import _processor, state_dict_from_jax  # noqa: E402
from test_torch_bf16_gnn import MODEL_HP, _model_grads_close  # noqa: E402
from test_torch_fused_edge import _problem  # noqa: E402
from test_torch_gnn2d import load_native_neighbours  # noqa: E402
from test_torch_modules import _graph_pair  # noqa: E402
from test_torch_pregathered_edge import _slots, _tail  # noqa: E402

BF = jnp.bfloat16
W = 128  # the width of the kernels under test
FWD_RTOL, FWD_ATOL, GRAD_L2 = 1e-2, 1e-2, 1e-2
STEP_F32, STEP_GRAD_RTOL, STEP_GRAD_ATOL_REL = dict(rtol=1e-4, atol=1e-5), \
    2e-3, 1e-5
STEP_BF16, STEP_BF16_GRAD_L2 = dict(rtol=2e-2, atol=2e-2), 5e-2
MODEL_F32, GRAD_RTOL, GRAD_ATOL_REL = dict(rtol=1e-3, atol=1e-4), 2e-3, 1e-5
LOSS_RTOL = 1e-3
# the pregathered kernel's operands in bf16 (ln_s and ln_b stay f32)
BF16_OPERANDS = ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out")
# MAgNet[GNN] at the published GraphNet widths (magnet_gnn.yaml: latent and
# hidden 128, four MLP layers), two message-passing steps
WIDE = dict(latent_dim=W, mlp_hidden=W, mlp_layers=4,
            num_message_passing_steps=2)
HP = {pos_dim: dict(hp, **WIDE) for pos_dim, hp in MODEL_HP.items()}


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


def _bf16_case(L1, seed):
    """The pregathered entry's operands at (128, 128) on
    ``test_torch_fused_edge``'s graph (a receiver of degree 0), the bf16
    ones rounded to bf16 (f32 arrays holding bf16 values), its CSR graph
    and the port's operands."""
    p = _problem(L1, n=120, Ce=W, H=W, C=W, seed=seed)
    rng = np.random.default_rng(seed + 100)
    p["h0"] = (rng.normal(size=(len(p["s"]), W)) * 0.3).astype(np.float32)
    for k in BF16_OPERANDS:
        p[k] = torch.from_numpy(p[k]).bfloat16().float().numpy()
    graph = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]),
                           p["n"])
    ops = [torch.from_numpy(p["h0"]).bfloat16(),
           torch.from_numpy(p["pxi"]).bfloat16(), graph.rowptr,
           *(torch.from_numpy(a).bfloat16() for a in _tail(p)[:4]),
           *(torch.from_numpy(a) for a in _tail(p)[4:])]
    return p, graph, ops


def _pallas_fwd_bwd(p, g, monkeypatch):
    """``fused_edge_tail_agg`` on the bf16 operands in interpret mode and
    its VJP for the cotangent g (N, C): the per-node sums and the eight
    gradients, in the port's layout (d_h0 per raw edge, node rows)."""
    n = p["n"]
    blk = block_graph(p["s"], p["r"], n)
    T, et = blk.senders.shape
    e_idx, live = _slots(p["s"], p["r"], n, blk)
    h0 = np.zeros((T, et, W), np.float32)
    h0[live] = p["h0"][e_idx]
    pxi = np.zeros((T * 128, W), np.float32)
    pxi[:n] = p["pxi"]
    g_pad = np.zeros((T * 128, W), np.float32)
    g_pad[:n] = g
    recv, mask = jnp.asarray(blk.recv_local), jnp.asarray(blk.mask)
    tail = [jnp.asarray(a).astype(BF) for a in _tail(p)[:4]] + [
        jnp.asarray(a) for a in _tail(p)[4:]]
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    out, vjp = jax.vjp(
        lambda *a: pk.fused_edge_tail_agg(*a, recv, mask),
        jnp.asarray(h0).astype(BF),
        jnp.asarray(pxi.reshape(T, 128, W)).astype(BF), *tail)
    assert out.dtype == jnp.float32
    d = vjp(jnp.asarray(g_pad.reshape(T, 128, W)))
    grads = [d[0][live][np.argsort(e_idx)], d[1].reshape(-1, W)[:n], *d[2:]]
    return np.asarray(out).reshape(-1, W)[:n], grads


# ---- the pregathered entry's bf16 pair at (128, 128) -----------------------

@pytest.mark.parametrize("L1", [1, 3])
def test_plain_bf16_pregathered_at_width_128_matches_pallas_interpret(
        monkeypatch, L1):
    """``fused_edge_tail_agg_pregathered_bf16_plain`` / ``_bwd_plain`` at
    (H, C) = (128, 128), a width the card now builds, against
    ``fused_edge_tail_agg`` (``_fused_fwd_pallas``) and its VJP
    (``_fused_bwd_pallas`` with the VJP's casts) on bf16 operands: the
    per-node sums (zero at the degree-0 receiver) and every gradient in its
    operand's dtype."""
    assert (W, W) in fe.KERNEL_WIDTHS["pregathered_bf16"]
    fe._check_build_bf16("pregathered", (W, W), L1)
    p, _, ops = _bf16_case(L1, seed=110 + L1)
    n = p["n"]
    g = np.random.default_rng(40 + L1).normal(size=(n, W)).astype(np.float32)
    want, want_grads = _pallas_fwd_bwd(p, g, monkeypatch)
    got = fe.fused_edge_tail_agg_pregathered_bf16_plain(*ops)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, FWD_RTOL, FWD_ATOL)
    np.testing.assert_array_equal(got[n // 2].numpy(), 0.0)  # degree 0
    grads = fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(
        *ops, torch.from_numpy(g))
    assert len(grads) == len(fe.GRAD_NAMES_PREGATHERED) == len(want_grads)
    for name, a, b in zip(fe.GRAD_NAMES_PREGATHERED, grads, want_grads):
        assert b.dtype == (BF if name in BF16_OPERANDS else jnp.float32), name
        assert a.dtype == (torch.bfloat16 if name in BF16_OPERANDS
                           else torch.float32), name
        assert tuple(a.shape) == b.shape, name
        assert rel_l2(a.float().numpy(), np.asarray(b, np.float32)) < GRAD_L2, \
            name
    np.testing.assert_array_equal(grads[1][n // 2].float().numpy(), 0.0)


@pytest.mark.parametrize("L1", [0, 3])
def test_pregathered_bf16_wrapper_at_width_128_on_cpu_is_the_plain_pair(L1):
    """On CPU tensors ``fused_edge_tail_agg_pregathered_bf16`` at (128, 128)
    is the plain forward and, under autograd, the plain backward, each
    gradient in its operand's dtype, and nothing is launched; the kernel
    path takes the width now (it refuses the CPU device, not the width)."""
    p, _, ops = _bf16_case(L1, seed=120 + L1)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(p["n"], W)).astype(np.float32))
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in ops]
    before = fe.launch_counts()
    out = fe.fused_edge_tail_agg_pregathered_bf16(*leaves)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    assert torch.equal(out.detach(),
                       fe.fused_edge_tail_agg_pregathered_bf16_plain(*ops))
    out.backward(g)
    want = fe.fused_edge_tail_agg_pregathered_bf16_bwd(*ops, g)
    floats = [t for t in leaves if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES_PREGATHERED, floats, want):
        assert leaf.grad.dtype == leaf.dtype == w.dtype, name
        assert torch.equal(leaf.grad, w), name
    assert fe.launch_counts() == before
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe.FusedEdgeTailAggPregatheredBf16.apply(False, *ops)
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe._launch_pregathered_bf16_bwd(*ops, g)


def test_each_build_counts_its_own_launches():
    """The pregathered entry's width-128 builds count apart from its
    width-64 ones and from the pe entry's width-128 ones, in f32 and bf16,
    so that a run can tell which build its path launched."""
    cases = (("pregathered", (128, 128), "fused_edge_pregathered128"),
             ("pregathered", (64, 32), "fused_edge_pregathered"),
             ("pe", (128, 128), "fused_edge_pe"),
             ("pe", (64, 32), "fused_edge_pe64"),
             ("fold", (128, 128, 128), "fused_edge_fold128"),
             ("fold", (32, 64, 32), "fused_edge"))
    try:
        for entry, widths, key in cases:
            for bwd in (False, True):
                before = fe.launch_counts()
                fe._count(entry, widths, bwd=bwd)
                after = fe.launch_counts()
                assert [k for k in after if after[k] != before[k]] == [
                    f"{key}_{'bwd' if bwd else 'fwd'}"], (entry, widths)
        w128 = {entry: fe._COUNTERS[name]
                for entry, name in fe._W128_COUNTER.items()}
        assert w128 == {"fold": "fused_edge_fold128_bf16_fwd",
                        "pe": "fused_edge_pe_bf16_fwd",
                        "pregathered": "fused_edge_pregathered128_bf16_fwd"}
        assert all(fe._COUNTERS[name + "_bwd"] == key[:-3] + "bwd"
                   for name, key in zip(fe._W128_COUNTER.values(),
                                        w128.values()))
    finally:
        fe.reset_launches()


# ---- one width-128 step on the pre-gathered lane ---------------------------

def _step_grads_close(a, b, bf16, name):
    if bf16:
        assert rel_l2(a, b) < STEP_BF16_GRAD_L2, name
    else:
        np.testing.assert_allclose(
            a, b, rtol=STEP_GRAD_RTOL,
            atol=STEP_GRAD_ATOL_REL * max(float(np.abs(b).max()), 1.0),
            err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_interaction_step_kernel_pregathered_at_width_128_matches_jax(
        monkeypatch, dtype):
    """One step at latent = hidden = 128 (the edge scale 4, a bf16 scalar in
    bf16, as the JAX processor carries it): node latents and the gradients
    of sum(x' * G) in every parameter and in x, against the JAX step under
    ``MAGNET_TPU_NO_FUSED2`` (no fused2 mode: ``fused_edge_tail_agg`` on the
    gathered h0) in interpret mode."""
    bf16 = dtype == "bf16"
    jdt, tdt = (BF, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jg, tg, x, e_blk, e_csr = _graph_pair(B=1, n=100, r=0.05, C=W, seed=25)
    net = batch_vmap(jax_graphnet.InteractionNetwork, in_axes=(0, 0, 0, None),
                     node_out=W, edge_out=W, mlp_layers=2, mlp_hidden=W,
                     dtype=BF if bf16 else None)
    xb, eb = jnp.asarray(x).astype(jdt), jnp.asarray(e_blk).astype(jdt)
    scale = jnp.asarray(4.0, jdt)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2", "1")
    rng = np.random.default_rng(26)
    one = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32),
        jax.jit(net.init)(jax.random.PRNGKey(7), xb, eb, jg, scale)["params"])
    G = rng.normal(size=x.shape).astype(np.float32)

    def inet(p, xv):
        return net.apply({"params": p}, xv, eb, jg, scale)[0]

    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    want = jax.jit(inet)(one, xb)
    assert jax_graphnet.LAST_FUSED_LANE["mode"] is None  # pre-gathered
    assert tg.layout.snd_transpose  # the JAX gather sums d_p_xj in f32
    d_p, d_x = jax.jit(jax.grad(
        lambda p, xv: jnp.sum(inet(p, xv).astype(jnp.float32) * G),
        argnums=(0, 1)))(one, xb)
    step = InteractionNetwork(W, 2, W, dtype=tdt if bf16 else None)
    sd = {}
    _processor(sd, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], one)}}, 1, 2)
    step.load_state_dict({k.removeprefix("p.gnn_stacks.0."): v
                          for k, v in sd.items()})
    xt = torch.from_numpy(x.reshape(-1, W)).to(tdt).requires_grad_()
    before = (fe.launch_counts(), seg.launches, seg.launches_bf16)
    got = step(xt, torch.from_numpy(e_csr).to(tdt), tg, e_scale=4.0,
               impl="kernel_pregathered")
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32).reshape(-1, W),
                               **(STEP_BF16 if bf16 else STEP_F32))
    (got.float() * torch.from_numpy(G.reshape(-1, W))).sum().backward()
    assert (fe.launch_counts(), seg.launches, seg.launches_bf16) == before
    _step_grads_close(xt.grad.float().numpy(),
                      np.asarray(d_x, np.float32).reshape(-1, W), bf16, "x")
    sd_grad = {}
    _processor(sd_grad, "p", {"steps": {"step": jax.tree.map(
        lambda a: np.asarray(a)[None], d_p)}}, 1, 2)
    for name, prm in step.named_parameters():
        assert prm.grad.dtype == torch.float32, name
        _step_grads_close(prm.grad.numpy(),
                          sd_grad[f"p.gnn_stacks.0.{name}"].numpy(), bf16,
                          name)


# ---- MAgNet[GNN] 1D and 2D --------------------------------------------------

_PARAMS: dict = {}
_F32_GRADS: dict = {}


def _model_pair(pos_dim, graph_dtype):
    """The JAX MAgNet[GNN] (P = ``pos_dim``; in 2D its native neighbour
    search) and the port's at ``HP[pos_dim]``, both with ``graph_dtype``,
    on the same f32 weights (one JAX init per P, perturbed so that no
    LayerNorm affine is ones and zeros), and one training batch on both
    sides (``tests/test_torch_bf16_gnn.py``'s data)."""
    hp = dict(HP[pos_dim], graph_dtype=graph_dtype)
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
        rng = np.random.default_rng(30 + pos_dim)
        _PARAMS[pos_dim] = jax.tree.map(
            lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
            .astype(np.float32),
            jax.jit(jm.init)(jax.random.PRNGKey(2), jb, jg))
    params = _PARAMS[pos_dim]
    tm = create_model("magnet_gnn", hp, device="cpu",
                      kind=f"h5_implicit_gnn_{pos_dim}d")
    tm.load_state_dict(state_dict_from_jax(params, hp, "magnet_gnn",
                                           pos_dim=pos_dim))
    return jm, params, jb, jg, tm, to_device(batch, "cpu")


def _jax_loss_and_grads(jm, params, jb, jg):
    return jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True)[0]))(params)


def _f32_grads(pos_dim, monkeypatch):
    """The JAX f32 model's gradient tree on ``_model_pair``'s parameters and
    batch, by its plain references: the scale of each parameter's bf16
    sensitivity."""
    if pos_dim not in _F32_GRADS:
        with monkeypatch.context() as m:
            m.delenv("MAGNET_TPU_PALLAS_INTERPRET", raising=False)
            jm, params, jb, jg, *_ = _model_pair(pos_dim, None)
            _F32_GRADS[pos_dim] = _jax_loss_and_grads(jm, params, jb, jg)[1]
    return _F32_GRADS[pos_dim]


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("pos_dim", [1, 2])
def test_magnet_gnn_kernel_pregathered_matches_jax_no_fused2(monkeypatch,
                                                             pos_dim, dtype):
    """MAgNet[GNN] 1D and 2D at the published GraphNet widths on
    ``impl="kernel_pregathered"`` against the JAX model under
    ``MAGNET_TPU_NO_FUSED2`` (its pre-gathered lane on both GraphNet
    stages): the teacher-forcing training loss and every parameter's
    gradient; on the CPU the port's wrappers run their plain versions and
    launch nothing."""
    bf16 = dtype == "bf16"
    jm, params, jb, jg, tm, tb = _model_pair(pos_dim, dtype)
    graphs = tm.build_graph(tb)
    for gr in (graphs.lr, graphs.all):  # both layouts: f32 sender sums in JAX
        assert gr.lane == "fold"
        assert gr.layout.snd2 and gr.layout.snd_transpose
    if bf16:
        monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2", "1")
    jax_graphnet.LAST_FUSED_LANE.update(mode="unset")
    want_loss, d_p = _jax_loss_and_grads(jm, params, jb, jg)
    assert jax_graphnet.LAST_FUSED_LANE["mode"] is None
    before = (fe.launch_counts(), seg.launches, seg.launches_bf16)
    tm.impl = "kernel_pregathered"
    tm.zero_grad(set_to_none=True)
    try:
        loss, _ = tm.loss(tb, graphs, train=True)
        loss.backward()
    finally:
        tm.impl = "kernel"
    assert (fe.launch_counts(), seg.launches, seg.launches_bf16) == before
    if bf16:
        assert abs(loss.item() - float(want_loss)) < LOSS_RTOL * float(
            want_loss)
        _model_grads_close(tm, d_p, lambda: _f32_grads(pos_dim, monkeypatch),
                           HP[pos_dim], pos_dim)
        return
    np.testing.assert_allclose(loss.item(), float(want_loss), **MODEL_F32)
    want = state_dict_from_jax(jax.tree.map(np.asarray, d_p), HP[pos_dim],
                               "magnet_gnn", pos_dim=pos_dim)
    for name, prm in tm.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(
            prm.grad.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * max(float(np.abs(w).max()), 1.0),
            err_msg=name)
