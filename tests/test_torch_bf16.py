"""The port's bf16 GraphNet lane (``graph_dtype=bf16``) against the JAX
package on the CPU.

The JAX models engage their bf16 fused kernels with ``graph_dtype=bf16``
(``magnet_tpu/models/common.py:parse_dtype``).  The port computes what the
TPU kernels compute there, so the kernel-level references are the Pallas
kernels themselves in interpret mode (``MAGNET_TPU_PALLAS_INTERPRET=1``, as
``tests/test_ops.py`` runs them): ``_fused2r_fwd_pallas`` and
``_fused2r_bwd_pallas(dpxj_in_kernel=True)`` with ``we``/``be``, on the
graph of ``test_torch_fused_edge.py`` (a receiver of degree 0), packed
twice.  Then flax's ``Dense``/``LayerNorm`` with ``dtype=bf16``, one
``InteractionNetwork`` step and MAgNet[CNN] 1D as a whole against the JAX
modules in interpret mode on the same parameters, the model's training
loss and gradients, the models, lanes and widths without a bf16 build,
and the ``graph_dtype`` override through the entry points.

Tolerances (both sides bf16 with the same rounding points, f32 sums taken
in another order, so a value can round to the neighbouring bf16 number,
2^-8 relative):
  * the fold forward elementwise, rtol 1e-2, atol 1e-2; its gradients by
    relative L2 per operand, 1e-2 (a neighbouring rounding of an
    activation also flips relu ties);
  * bf16 Dense / LayerNorm elementwise, rtol 1e-2, atol 1e-2;
  * one InteractionNetwork step: node latents rtol 2e-2, atol 2e-2
    (the step adds a bf16 node MLP and a bf16 residual); parameter
    gradients by relative L2 per leaf, 5e-2;
  * MAgNet[CNN] 1D: the training loss within 1e-3 relative; the rollout's
    predictions at relative L2 1e-2 (two windows carry the roundings
    forward); parameter gradients by relative L2 over all parameters,
    5e-2, and per parameter 0.15: the JAX package's own two bf16 paths
    (interpret mode and its CPU oracle) differ by up to 5.2e-2 per
    parameter on this problem, the LayerNorm and bias gradients being sums
    of many terms of either sign;
  * against the f32 lane, the bound of ``tests/test_models.py``: the loss
    within 5e-2 relative.
MAgNet[CNN] 2D's bf16 lane (the pregathered entry's bf16 build) is
``tests/test_torch_bf16_2d.py``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import batch_vmap  # noqa: E402
from magnet_tpu.models.common import parse_dtype as jax_parse_dtype  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.nn import graphnet as jax_graphnet  # noqa: E402
from magnet_tpu.nn.core import MLP as JaxMLP  # noqa: E402
from magnet_tpu.nn.core import LayerNorm as JaxLayerNorm  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu.ops.graph import block_graph  # noqa: E402
from magnet_tpu_torch.config import compose  # noqa: E402
from magnet_tpu_torch.data.heat import heat_batches  # noqa: E402
from magnet_tpu_torch.models.common import parse_dtype  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.core import MLP, LayerNorm  # noqa: E402
from magnet_tpu_torch.nn.graphnet import InteractionNetwork  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops.graph import csr_from_edges  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import _processor, state_dict_from_jax  # noqa: E402
from test_torch_fused_edge import _jax_side, _port_args, _problem  # noqa: E402
from test_torch_modules import _graph_pair  # noqa: E402

BF = jnp.bfloat16
FWD_RTOL, FWD_ATOL, GRAD_L2 = 1e-2, 1e-2, 1e-2
DENSE_RTOL, DENSE_ATOL = 1e-2, 1e-2
STEP_RTOL, STEP_ATOL, STEP_GRAD_L2 = 2e-2, 2e-2, 5e-2
LOSS_RTOL, PRED_L2, MODEL_GRAD_L2, PARAM_GRAD_L2 = 1e-3, 1e-2, 5e-2, 0.15
VS_F32_RTOL = 5e-2
# the fold kernel's operands in bf16 (ln_s and ln_b stay f32)
BF16_OPERANDS = ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest",
                 "w_out", "b_out")
# B=2, L=32, N=64, nt=48 (2 windows), as tests/test_torch_slice.py
HP = dict(time_slice=16, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, res_layers=1,
          kernel_size=3, res_scale=1, radius=0.08)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_parse_dtype_is_the_jax_packages():
    for name in (None, "none", "float32", "fp32"):
        assert parse_dtype(name) is None and jax_parse_dtype(name) is None
    for name in ("bf16", "bfloat16"):
        assert parse_dtype(name) is torch.bfloat16
        assert jax_parse_dtype(name) == jnp.bfloat16
    for bad in ("fp16", "float64"):
        with pytest.raises(ValueError, match="unknown dtype"):
            parse_dtype(bad)
        with pytest.raises(ValueError, match="unknown dtype"):
            jax_parse_dtype(bad)


def test_bf16_mlp_and_layernorm_match_flax():
    """``MLP`` and ``LayerNorm`` with dtype bf16 against flax's ``Dense`` and
    ``LayerNorm`` with dtype=bf16, on f32 parameters and inputs."""
    rng = np.random.default_rng(70)
    x = rng.normal(size=(40, 12)).astype(np.float32)
    jmlp = JaxMLP([16, 16], 8, dtype=BF)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape))
        .astype(np.float32),
        jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jmlp.apply(params, jnp.asarray(x))
    assert want.dtype == BF
    mlp = MLP(12, [16, 16], 8, dtype=torch.bfloat16)
    with torch.no_grad():
        for lin, (_, d) in zip(mlp.linears, sorted(params["params"].items())):
            lin.weight.copy_(torch.from_numpy(np.asarray(d["Dense_0"]["kernel"]).T))
            lin.bias.copy_(torch.from_numpy(np.asarray(d["Dense_0"]["bias"])))
    got = mlp(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and mlp.layers[0].weight.dtype == torch.float32
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), DENSE_RTOL,
                               DENSE_ATOL)
    # large offset, small spread: statistics in f32, two-pass variance
    y = (100.0 + rng.normal(size=(30, 8))).astype(np.float32)
    yb = np.asarray(jnp.asarray(y).astype(BF), np.float32)
    scale, bias = 1 + 0.1 * rng.normal(size=8), 0.1 * rng.normal(size=8)
    ln_params = {"params": {"LayerNorm_0": {
        "scale": scale.astype(np.float32), "bias": bias.astype(np.float32)}}}
    want = JaxLayerNorm(dtype=BF).apply(ln_params, jnp.asarray(yb).astype(BF))
    ln = LayerNorm(8, dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale.astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(bias.astype(np.float32)))
    got = ln(torch.from_numpy(yb).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), DENSE_RTOL,
                               DENSE_ATOL)


def _bf16_problem(L1, seed):
    """``test_torch_fused_edge._problem`` with its bf16 operands rounded to
    bf16 (kept as f32 arrays holding bf16 values)."""
    p = _problem(L1, seed=seed)
    for k in BF16_OPERANDS:
        p[k] = torch.from_numpy(p[k]).bfloat16().float().numpy()
    return p


def _port_bf16(p):
    """The port's operands of ``p``: the bf16 ones in bf16."""
    args, _ = _port_args(p)
    return [t.bfloat16() if t.is_floating_point() and i < 11 else t
            for i, t in enumerate(args)]


def _pallas_args(p):
    """``_jax_side`` operands with the bf16 ones in bf16, as the keyword
    form of ``_fused2r_fwd_pallas`` / ``_fused2r_bwd_pallas`` takes them:
    (positional, we, be), and the chunk list and node count."""
    args, chunks, n = _jax_side(p)
    a = [x.astype(BF) if i < 9 else x for i, x in enumerate(args)]
    return [a[0], a[3], a[4], *a[5:15], *chunks], a[1], a[2], n


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_plain_bf16_forward_matches_pallas_interpret(monkeypatch, L1):
    p = _bf16_problem(L1, seed=60 + L1)
    pos, we, be, n = _pallas_args(p)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want = pk._fused2r_fwd_pallas(*pos, we=we, be=be)
    assert want.dtype == jnp.float32
    want = np.asarray(want).reshape(-1, p["w_out"].shape[1])[:n]
    got = fe.fused_edge_tail_agg_bf16_plain(*_port_bf16(p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, FWD_RTOL, FWD_ATOL)
    np.testing.assert_array_equal(got[n // 2].numpy(), 0.0)  # degree 0


def _pallas_grads(p, g, monkeypatch):
    """``_fused2r_bwd_pallas(dpxj_in_kernel=True)``'s eleven gradients in
    interpret mode, cast to their operands' dtypes as the JAX VJP casts
    them, mapped to the port's layout (d_e0 per raw edge, node rows)."""
    pos, we, be, n = _pallas_args(p)
    T = pos[0].shape[0]
    C, H = p["w_out"].shape[1], p["we"].shape[1]
    L1 = p["w_rest"].shape[0]
    g_pad = np.zeros((T * 128, C), np.float32)
    g_pad[:n] = g
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    (dz, dpxi, dwr, dbr, dwo, dbo, dls, dlb, dpxj, dwe,
     dbe) = pk._fused2r_bwd_pallas(*pos, jnp.asarray(g_pad.reshape(T, 128, C)),
                                   dpxj_in_kernel=True, we=we, be=be)
    assert dz.dtype == BF
    blk = block_graph(p["s"], p["r"], n)
    et = blk.senders.shape[1]
    key = p["r"].astype(np.int64) * n + p["s"]
    slot_key = blk.receivers.reshape(T, et).astype(np.int64) * n + blk.senders
    live = blk.mask > 0
    d_e0 = np.zeros_like(p["e0"])
    d_e0[np.searchsorted(key, slot_key[live])] = np.asarray(dz, np.float32)[live]
    grads = dict(e0=d_e0, we=dwe, be=dbe, pxj=np.asarray(dpxj)[:n],
                 pxi=np.asarray(dpxi).reshape(-1, H)[:n],
                 w_rest=np.asarray(dwr)[:L1], b_rest=np.asarray(dbr)[:L1],
                 w_out=dwo, b_out=dbo, ln_s=dls, ln_b=dlb)
    return {k: np.asarray(jnp.asarray(v).astype(
        BF if k in BF16_OPERANDS else jnp.float32), np.float32)
        for k, v in grads.items()}


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_plain_bf16_backward_matches_pallas_interpret(monkeypatch, L1):
    p = _bf16_problem(L1, seed=70 + L1)
    g = np.random.default_rng(9).normal(
        size=(p["n"], p["w_out"].shape[1])).astype(np.float32)
    want = _pallas_grads(p, g, monkeypatch)
    got = fe.fused_edge_tail_agg_bf16_bwd_plain(*_port_bf16(p),
                                                torch.from_numpy(g))
    for name, d in zip(fe.GRAD_NAMES, got):
        assert d.dtype == (torch.bfloat16 if name in BF16_OPERANDS
                           else torch.float32), name
        assert tuple(d.shape) == want[name].shape, name
        if d.numel():
            assert rel_l2(d.float().numpy(), want[name]) < GRAD_L2, name
    # the degree-0 node receives nothing
    np.testing.assert_array_equal(got[4][p["n"] // 2].float().numpy(), 0.0)


@pytest.mark.parametrize("L1", [0, 3])
def test_wrapper_on_cpu_is_the_plain_pair_with_operand_dtypes(L1):
    """On CPU tensors ``fused_edge_tail_agg_bf16`` is the plain forward and,
    under autograd, the plain step-by-step backward, each gradient in its
    operand's dtype; nothing is launched."""
    p = _bf16_problem(L1, seed=80 + L1)
    args = _port_bf16(p)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(p["n"], p["w_out"].shape[1])).astype(np.float32))
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in args]
    before = fe.launch_counts()
    out = fe.fused_edge_tail_agg_bf16(*leaves)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    np.testing.assert_array_equal(
        out.detach().numpy(), fe.fused_edge_tail_agg_bf16_plain(*args).numpy())
    out.backward(g)
    assert fe.launch_counts() == before
    want = fe.fused_edge_tail_agg_bf16_bwd(*args, g)
    floats = [t for t in leaves if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES, floats, want):
        assert leaf.grad.dtype == leaf.dtype == w.dtype, name
        assert torch.equal(leaf.grad, w), name


def test_kernels_refuse_cpu_tensors_unbuilt_widths_and_mixed_dtypes():
    """The bf16 launches take CUDA tensors only (a CPU tensor is refused,
    as by the f32 kernels), at the compiled builds (32, 64, 32) and (128,
    128, 128): another width raises ``NotImplementedError`` naming the
    missing build; every operand must be in the lane's dtype."""
    z = torch.zeros
    graph = csr_from_edges(torch.tensor([1, 2, 0]), torch.tensor([0, 1, 2]),
                           3)

    def operands(ce, h, c, l1):
        bf = torch.bfloat16
        return (z(3, ce, dtype=bf), z(ce, h, dtype=bf), z(h, dtype=bf),
                z(3, h, dtype=bf), z(3, h, dtype=bf), graph.senders,
                graph.rowptr, z(l1, h, h, dtype=bf), z(l1, h, dtype=bf),
                z(h, c, dtype=bf), z(c, dtype=bf), z(c), z(c))

    built = operands(32, 64, 32, 3)
    assert (32, 64, 32) in fe.KERNEL_WIDTHS["fold_bf16"]
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe._launch_bf16_fwd(*built)
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe._launch_bf16_bwd(*built, z(3, 32))
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe.FusedEdgeTailAggBf16.apply(False, *built)
    # MAgNet[GNN]'s width is built: its launches stop at the device too
    assert (128, 128, 128) in fe.KERNEL_WIDTHS["fold_bf16"]
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe._launch_bf16_fwd(*operands(128, 128, 128, 3))
    for unbuilt in (operands(16, 32, 8, 1), operands(32, 64, 32, 4),
                    operands(128, 128, 128, 4)):
        with pytest.raises(NotImplementedError, match="no bf16 build"):
            fe._launch_bf16_fwd(*unbuilt)
    mixed = list(built)
    mixed[3] = mixed[3].float()
    with pytest.raises(TypeError, match="pxj must be torch.bfloat16"):
        fe.fused_edge_tail_agg_bf16(*mixed)
    mixed = list(built)
    mixed[11] = mixed[11].bfloat16()
    with pytest.raises(TypeError, match="ln_s must be torch.float32"):
        fe.fused_edge_tail_agg_bf16(*mixed)
    # and the f32 entry refuses bf16 operands
    with pytest.raises(TypeError, match="must be torch.float32"):
        fe.fused_edge_tail_agg(*built)


@pytest.fixture(scope="module")
def models():
    """The JAX MAgNet[CNN] 1D (f32 params, perturbed so that the LayerNorm
    affines are not ones and zeros) and the port's bf16 and f32 models
    loaded with them; the batch and both graphs."""
    batch = heat_batches(2, 2, nt=48, nx=64, seed=11)[0]
    jm = jax_create_model("magnet_cnn", dict(HP, graph_dtype="bf16"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jb, jg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), params)
    sd = state_dict_from_jax(params, HP)
    ports = {}
    for dtype in ("bf16", "float32"):
        tm = create_model("magnet_cnn", dict(HP, graph_dtype=dtype),
                          device="cpu")
        tm.load_state_dict(sd)
        ports[dtype] = tm
    tb = to_device(batch, "cpu")
    return jm, params, jb, jg, ports, tb, ports["bf16"].build_graph(tb)


def test_interaction_network_step_bf16_matches_jax(models, monkeypatch):
    """One step in bf16 (x and e in bf16, the edge scale 4 a bf16 scalar,
    as the JAX processor carries them), its node latents and the gradients
    of sum(x' * G) in every parameter and in x, against the JAX step on the
    fold lane in interpret mode."""
    _, params, *_ = models
    jg, tg, x, e_blk, e_csr = _graph_pair(seed=12)
    step0 = jax.tree.map(lambda a: a[:1],
                         params["params"]["_processor"]["steps"]["step"])
    one = jax.tree.map(lambda a: a[0], step0)
    G = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)
    net = batch_vmap(jax_graphnet.InteractionNetwork, in_axes=(0, 0, 0, None),
                     node_out=8, edge_out=8, mlp_layers=HP["mlp_layers"],
                     mlp_hidden=HP["mlp_hidden"], dtype=BF)
    xb, eb = jnp.asarray(x).astype(BF), jnp.asarray(e_blk).astype(BF)

    def inet(p, xv):
        return net.apply({"params": p}, xv, eb, jg, jnp.asarray(4.0, BF))[0]

    def loss(p, xv):
        return jnp.sum(inet(p, xv).astype(jnp.float32) * G)

    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want = inet(one, xb)
    assert want.dtype == BF and jax_graphnet.LAST_FUSED_LANE["fold"]
    d_p, d_x = jax.grad(loss, argnums=(0, 1))(one, xb)
    step = InteractionNetwork(8, HP["mlp_layers"], HP["mlp_hidden"],
                              dtype=torch.bfloat16)
    sd = {}
    _processor(sd, "p", {"steps": {"step": step0}}, 1, HP["mlp_layers"])
    step.load_state_dict({k.removeprefix("p.gnn_stacks.0."): v
                          for k, v in sd.items()})
    xt = torch.from_numpy(x.reshape(-1, 8)).bfloat16().requires_grad_()
    got = step(xt, torch.from_numpy(e_csr).bfloat16(), tg, e_scale=4.0)
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
        want_g = sd_grad[f"p.gnn_stacks.0.{name}"].numpy()
        assert prm.grad.dtype == torch.float32
        assert rel_l2(prm.grad.numpy(), want_g) < STEP_GRAD_L2, name


def test_magnet_cnn_1d_bf16_matches_jax(models, monkeypatch):
    """MAgNet[CNN] 1D with graph_dtype=bf16 against the JAX model on the
    same f32 parameters, its GraphNet stage on the bf16 fold kernels in
    interpret mode: the parameter tree is unchanged, the rollout, the
    eval and training losses, and every parameter's gradient."""
    jm, params, jb, jg, ports, tb, tg = models
    tm = ports["bf16"]
    assert tm._processor.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert tm.state_dict().keys() == ports["float32"].state_dict().keys()
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want_hr, _ = jm.predict(params, jb, jg)
    assert jax_graphnet.LAST_FUSED_LANE["fold"]
    got_hr, _ = tm.predict(tb, tg)
    assert got_hr.dtype == torch.float32
    assert rel_l2(got_hr.numpy(), want_hr) < PRED_L2
    want_eval, _ = jm.loss(params, jb, jg, train=False)
    got_eval, _ = tm.loss(tb, tg, train=False)
    assert abs(float(got_eval) - float(want_eval)) < PRED_L2 * float(want_eval)

    rng = jax.random.PRNGKey(0)
    want_loss, d_p = jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, rng=rng, train=True)[0])(params)
    tm.zero_grad(set_to_none=True)
    loss, _ = tm.loss(tb, tg, train=True)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LOSS_RTOL * float(want_loss)
    want = state_dict_from_jax(jax.tree.map(np.asarray, d_p), HP)
    got_all, want_all = [], []
    for name, prm in tm.named_parameters():
        w = want[name].numpy()
        assert rel_l2(prm.grad.numpy(), w) < PARAM_GRAD_L2, name
        got_all.append(prm.grad.numpy().ravel())
        want_all.append(w.ravel())
    assert rel_l2(np.concatenate(got_all),
                  np.concatenate(want_all)) < MODEL_GRAD_L2


def test_bf16_training_loss_trains_and_stays_near_f32(models):
    """The bf16 lane's training loss: every parameter gradient finite and
    not all zero, the loss within 5e-2 of the f32 lane's on the same
    parameters (``tests/test_models.py``'s bound), and so the eval loss."""
    *_, ports, tb, tg = models
    losses = {}
    for dtype, tm in ports.items():
        tm.zero_grad(set_to_none=True)
        loss, _ = tm.loss(tb, tg, train=True)
        loss.backward()
        losses[dtype] = loss.item(), tm.loss(tb, tg, train=False)[0].item()
        for name, prm in tm.named_parameters():
            assert torch.isfinite(prm.grad).all(), name
            assert prm.grad.abs().max() > 0, name
    for bf, f32 in zip(losses["bf16"], losses["float32"]):
        assert abs(bf - f32) < VS_F32_RTOL * max(1.0, abs(f32))


def test_bf16_raises_where_there_is_no_bf16_build():
    """MAgNet[GNN] and MAgNet[CNN] 2D build in bf16; a step runs it on the
    fold, pregathered and pe lanes (on CPU tensors their plain versions);
    the pe entry's bf16 kernels are built at width 64 and refuse L1 = 4 and
    an unbuilt width there, the pregathered entry's are built at (64, 32)
    and (128, 128) and refuse an unbuilt width ((128, 64)) and L1 = 4,
    which have no build, and CPU tensors at the built ones."""
    for name in ("magnet_cnn_2d", "magnet_gnn"):
        assert create_model(name, {"graph_dtype": "float32"}, device="cpu")
        model = create_model(name, {"graph_dtype": "bf16"}, device="cpu")
        assert model._processor.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown dtype"):
        create_model("magnet_cnn", {"graph_dtype": "fp16"}, device="cpu")
    _, tg, x, _, e_csr = _graph_pair(seed=14)
    step = InteractionNetwork(8, 2, 16, dtype=torch.bfloat16)
    xb = torch.from_numpy(x.reshape(-1, 8)).bfloat16()
    eb = torch.from_numpy(e_csr).bfloat16()
    for impl in ("kernel_fold", "kernel_pregathered", "kernel_pe"):
        assert step(xb, eb, tg, impl=impl).dtype == torch.bfloat16
    assert (64, 32) in fe.KERNEL_WIDTHS["pe_bf16"]
    fe._check_build_bf16("pe", (64, 32), 3)
    for widths, l1 in (((64, 32), 4), ((64, 64), 3)):
        with pytest.raises(NotImplementedError, match="no bf16 build"):
            fe._check_build_bf16("pe", widths, l1)
    for widths in ((64, 32), (128, 128)):
        assert widths in fe.KERNEL_WIDTHS["pregathered_bf16"]
        fe._check_build_bf16("pregathered", widths, 3)
    for widths, l1 in (((128, 64), 3), ((64, 32), 4), ((128, 128), 4)):
        with pytest.raises(NotImplementedError, match="no bf16 build"):
            fe._check_build_bf16("pregathered", widths, l1)
    bf, z = torch.bfloat16, torch.zeros
    graph = csr_from_edges(torch.tensor([1, 2, 0]), torch.tensor([0, 1, 2]),
                           3)
    for h, c in ((64, 32), (128, 128)):
        ops = (z(3, h, dtype=bf), z(3, h, dtype=bf), graph.rowptr,
               z(3, h, h, dtype=bf), z(3, h, dtype=bf), z(h, c, dtype=bf),
               z(c, dtype=bf), z(c), z(c))
        with pytest.raises(ValueError, match="no fused edge kernel"):
            fe._launch_pregathered_bf16_fwd(*ops)
        with pytest.raises(ValueError, match="no fused edge kernel"):
            fe._launch_pregathered_bf16_bwd(*ops, z(3, c))
    ops = (z(3, 128, dtype=bf), z(3, 128, dtype=bf), graph.rowptr,
           z(1, 128, 128, dtype=bf), z(1, 128, dtype=bf),
           z(128, 64, dtype=bf), z(64, dtype=bf), z(64), z(64))
    with pytest.raises(NotImplementedError, match="no bf16 build"):
        fe._launch_pregathered_bf16_fwd(*ops)


def test_graph_dtype_override_through_the_entry_points(tmp_path):
    """``model.graph_dtype=bf16`` is taken by ``compose`` (``run.py``) and
    ``eval.py`` for the three GraphNet models and by no other, and reaches
    the model; without it the model config is the YAML's."""
    from magnet_tpu_torch import eval as port_eval
    from magnet_tpu_torch.config import MAGNET_CNN, model_overrides

    for name in ("magnet_cnn", "magnet_cnn_2d", "magnet_gnn"):
        for arg in ("model.graph_dtype=bf16", "model.params.graph_dtype=bf16"):
            cfg = compose([f"model={name}", arg])
            assert cfg["model"]["graph_dtype"] == "bf16"
    assert compose([])["model"] == MAGNET_CNN
    with pytest.raises(ValueError, match="unknown override"):
        compose(["model=mpnn", "model.graph_dtype=bf16"])
    hp = model_overrides("magnet_cnn", ["graph_dtype=bf16", "latent_dim=8"])
    assert hp == {**MAGNET_CNN, "latent_dim": 8, "graph_dtype": "bf16"}
    small = ["latent_dim=8", "num_message_passing_steps=1", "mlp_layers=2",
             "mlp_hidden=16", "n_chan=16", "res_layers=1"]
    out = {}
    for dtype in ("bf16", "float32"):
        out[dtype] = port_eval.main(
            ["datamodule.source=synthetic_ks", "device=cpu", "n_traj=2",
             "batch_size=2", "datamodule.nt_test=48",
             f"model.graph_dtype={dtype}", *small])
    assert out["bf16"]["test_loss"] != out["float32"]["test_loss"]
    assert abs(out["bf16"]["test_loss"] - out["float32"]["test_loss"]) < (
        VS_F32_RTOL * out["float32"]["test_loss"])
