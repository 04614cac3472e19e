"""``remat`` on the GraphNet processors (``nn.graphnet.GraphProcessor``):
MAgNet[CNN] 1D and MAgNet[GNN] 1D with ``remat=True``, in f32 and bf16,
against the JAX models with ``remat=True`` (``fnn.remat`` of each
processor step); the port with ``remat`` on against off on every lane;
each step's forward run again in the backward; the hp key.

The JAX side runs as the existing training-step parity tests run it: f32
on its plain references, bf16 on the Pallas kernels in interpret mode.
Tolerances are those tests' own:
  * f32 MAgNet[CNN] 1D (``tests/test_torch_train.py``): loss and metrics
    rtol 1e-4, atol 1e-5; gradients rtol 2e-3, atol 1e-5 relative to each
    leaf's largest entry;
  * f32 MAgNet[GNN] 1D (``tests/test_torch_gnn.py``): loss and metrics
    rtol 1e-3, atol 1e-4; gradients as above;
  * bf16 (``tests/test_torch_bf16.py``, ``tests/test_torch_bf16_gnn.py``):
    the loss within 1e-3 relative; gradients by relative L2 per parameter
    0.15 (MAgNet[GNN]: or twice the JAX package's own bf16-to-f32
    distance) and over all parameters 5e-2.
The port with ``remat`` on against off: loss and every gradient bit for
bit (the CPU runs the same plain versions in the same order both times).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.train.import_torch import import_magnet_cnn  # noqa: E402
from magnet_tpu_torch.config import compose  # noqa: E402
from magnet_tpu_torch.data.heat import heat_batches  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn import graphnet  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402
from test_torch_bf16 import HP as CNN_BF16_HP  # noqa: E402
from test_torch_bf16_gnn import MODEL_HP as GNN_BF16_HP  # noqa: E402
from test_torch_bf16_gnn import _model_grads_close, _model_pair  # noqa: E402
from test_torch_gnn import HP as GNN_HP  # noqa: E402
from test_torch_gnn import _dataset as gnn_dataset  # noqa: E402
from test_torch_gnn import _torch_grads_as_jax_tree  # noqa: E402
from test_torch_train import HP as CNN_HP  # noqa: E402
from test_torch_train import _assert_tree_close, _train_batch  # noqa: E402

CNN_LOSS = dict(rtol=1e-4, atol=1e-5)
GNN_LOSS = dict(rtol=1e-3, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_REL = 2e-3, 1e-5
BF16_LOSS_RTOL, BF16_PARAM_L2, BF16_MODEL_L2 = 1e-3, 0.15, 5e-2
CASES = [("magnet_cnn", "float32"), ("magnet_cnn", "bf16"),
         ("magnet_gnn", "float32"), ("magnet_gnn", "bf16")]
# the lane functions a processor step calls, by lane
LANE_FUNCTIONS = ("fused_edge_tail_agg", "fused_edge_tail_agg_plain",
                  "fused_edge_tail_agg_pe", "fused_edge_tail_agg_pregathered",
                  "fused_edge_tail_agg_bf16", "fused_edge_tail_agg_pe_bf16",
                  "fused_edge_tail_agg_pregathered_bf16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its ops are small, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _cnn_pair(dtype):
    """The JAX MAgNet[CNN] 1D with ``remat=True`` and the port's with and
    without it, on the same weights and batch: f32 on
    ``tests/test_torch_train.py``'s training batch and weights, bf16 on
    ``tests/test_torch_bf16.py``'s (perturbed weights, its batch)."""
    if dtype == "float32":
        hp, batch = dict(CNN_HP), _train_batch()
    else:
        hp = dict(CNN_BF16_HP, graph_dtype="bf16")
        batch = heat_batches(2, 2, nt=48, nx=64, seed=11)[0]
    jm = jax_create_model("magnet_cnn", dict(hp, remat=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(1), jb, jg))
    if dtype == "bf16":
        rng = np.random.default_rng(0)
        params = jax.tree.map(
            lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(
                np.float32), params)
    sd = state_dict_from_jax(params, hp)
    ports = {}
    for remat in (True, False):
        tm = create_model("magnet_cnn", dict(hp, remat=remat), device="cpu")
        tm.load_state_dict(sd)
        ports[remat] = tm
    return jm, params, jb, jg, ports, to_device(batch, "cpu")


def _gnn_pair(dtype):
    """The JAX MAgNet[GNN] 1D with ``remat=True`` and the port's with and
    without it: f32 on ``tests/test_torch_gnn.py``'s batch and weights,
    bf16 on ``tests/test_torch_bf16_gnn.py``'s."""
    if dtype == "float32":
        hp = dict(GNN_HP)
        ds = gnn_dataset("train")
        batch = {k: np.stack([ds[0][k], ds[1][k]]) for k in ds[0]}
        jm = jax_create_model("magnet_gnn", dict(hp, remat=True))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jg = jm.build_graph(batch)
        params = jax.tree.map(np.asarray,
                              jax.jit(jm.init)(jax.random.PRNGKey(1), jb, jg))
        tb = to_device(batch, "cpu")
    else:
        hp = dict(GNN_BF16_HP[1], graph_dtype="bf16")
        _, params, jb, jg, _, tb = _model_pair(1)
        jm = jax_create_model("magnet_gnn", dict(hp, remat=True))
    sd = state_dict_from_jax(params, hp, "magnet_gnn")
    ports = {}
    for remat in (True, False):
        tm = create_model("magnet_gnn", dict(hp, remat=remat), device="cpu")
        tm.load_state_dict(sd)
        ports[remat] = tm
    return jm, params, jb, jg, ports, tb


_PAIRS: dict = {}


def pair(model, dtype):
    """``_cnn_pair`` / ``_gnn_pair``, made once a module."""
    if (model, dtype) not in _PAIRS:
        make = _cnn_pair if model == "magnet_cnn" else _gnn_pair
        _PAIRS[model, dtype] = make(dtype)
    return _PAIRS[model, dtype]


def _loss_and_grads(tm, tb, impl="kernel"):
    tm.impl = impl
    tm.zero_grad(set_to_none=True)
    try:
        loss, metrics = tm.loss(tb, tm.build_graph(tb), train=True)
        loss.backward()
    finally:
        tm.impl = "kernel"
    return loss, metrics, {k: p.grad.clone() for k, p in
                           tm.named_parameters()}


@pytest.mark.parametrize("model,dtype", CASES)
def test_remat_training_step_matches_jax_remat(monkeypatch, model, dtype):
    """The port's training loss, metrics and every parameter gradient with
    ``remat=True`` against the JAX model with ``remat=True``."""
    jm, params, jb, jg, ports, tb = pair(model, dtype)
    tm = ports[True]
    procs = ((tm._processor,) if model == "magnet_cnn"
             else (tm.processor, tm._processor))
    assert all(p.remat for p in procs)
    if dtype == "bf16":
        monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    (want_loss, want_m), d_p = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True), has_aux=True))(params)
    loss, metrics, grads = _loss_and_grads(tm, tb)
    if dtype == "bf16":
        assert abs(loss.item() - float(want_loss)) < (
            BF16_LOSS_RTOL * float(want_loss))
        if model == "magnet_gnn":
            from test_torch_bf16_gnn import _f32_grads
            _model_grads_close(tm, d_p, lambda: _f32_grads(1, monkeypatch),
                               GNN_BF16_HP[1], 1)
            return
        want = state_dict_from_jax(jax.tree.map(np.asarray, d_p),
                                   CNN_BF16_HP)
        for name, g in grads.items():
            assert rel_l2(g.numpy(), want[name].numpy()) < BF16_PARAM_L2, name
        assert rel_l2(np.concatenate([g.numpy().ravel()
                                      for g in grads.values()]),
                      np.concatenate([want[n].numpy().ravel()
                                      for n in grads])) < BF16_MODEL_L2
        return
    bound = CNN_LOSS if model == "magnet_cnn" else GNN_LOSS
    assert set(metrics) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]), err_msg=k, **bound)
    got = (import_magnet_cnn({k: g.numpy() for k, g in grads.items()},
                             CNN_HP)
           if model == "magnet_cnn" else _torch_grads_as_jax_tree(tm, GNN_HP))
    _assert_tree_close(got, d_p, rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL)


@pytest.mark.parametrize("model,dtype", CASES)
def test_remat_on_equals_off_bit_for_bit(model, dtype):
    """On the fold (``kernel`` here), pe and pre-gathered lanes: the
    training loss and every gradient with ``remat`` on equal those with it
    off, and each processor step's lane function runs twice a training
    step with it on (the recompute), once with it off and once in an
    evaluation either way."""
    for impl in ("kernel", "kernel_pe", "kernel_pregathered"):
        _on_equals_off(model, dtype, impl)


def _on_equals_off(model, dtype, impl):
    *_, ports, tb = pair(model, dtype)
    calls = {}
    got = {}
    for remat, tm in ports.items():
        with pytest.MonkeyPatch.context() as m:
            counts = {name: 0 for name in LANE_FUNCTIONS}
            for name in LANE_FUNCTIONS:
                def counted(*a, _name=name, _fn=getattr(graphnet, name),
                            **kw):
                    counts[_name] += 1
                    return _fn(*a, **kw)
                m.setattr(graphnet, name, counted)
            got[remat] = _loss_and_grads(tm, tb, impl)
            calls[remat] = dict(counts)
            tm.impl = impl
            try:
                with torch.no_grad():
                    tm.loss(tb, tm.build_graph(tb), train=False)
            finally:
                tm.impl = "kernel"
            calls[remat, "eval"] = {k: v - calls[remat][k]
                                    for k, v in counts.items()}
    assert torch.equal(got[True][0], got[False][0]), impl
    for name, g in got[False][2].items():
        assert torch.equal(got[True][2][name], g), (impl, name)
    assert sum(calls[False].values()) > 0, impl
    assert {k: 2 * v for k, v in calls[False].items()} == calls[True], impl
    assert calls[True, "eval"] == calls[False, "eval"], impl


def test_remat_hp_key_reaches_every_processor():
    """``model.params.remat`` through the config reaches MAgNet[CNN] 1D's
    and 2D's processor and both of MAgNet[GNN]'s; it is off by default."""
    for name, procs in (("magnet_cnn", ("_processor",)),
                        ("magnet_cnn_2d", ("_processor",)),
                        ("magnet_gnn", ("processor", "_processor"))):
        for argv, want in (([], False), (["model.params.remat=true"], True)):
            cfg = compose([f"model={name}", *argv])
            assert cfg["model"].get("remat", False) is want
            hp = dict(cfg["model"], latent_dim=8, mlp_hidden=16,
                      num_message_passing_steps=1, n_chan=8)
            tm = create_model(name, hp, device="cpu")
            assert all(getattr(tm, p).remat is want for p in procs), name
