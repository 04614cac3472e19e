"""The port's MPNN family against magnet_tpu with carried-over weights:
``segment_instance_norm``, ``TemporalBundlingDecoder``, ``MPNNLayer``, and
``MPNN`` / ``MPNN2D`` (``predict``, ``loss`` in train and eval mode, both
``teacher_forcing`` values, every parameter gradient), the weight bridge's
round trip, and ``Trainer.fit`` / ``evaluate`` on the CPU.

Inputs are made with numpy from a seed.  The whole models run at
hidden_features 128: the temporal-bundling decoder's kernel sizes and
strides are hand-picked for that width, so no other gives ``time_window``
outputs.  Tolerances: rtol 1e-4, atol 1e-5 per module (f32 on both sides,
sums in another order); rtol 1e-3, atol 1e-4 for rollouts, losses and
gradients, where each window's output is the next window's input and an
InstanceNorm follows every layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.models.common import (  # noqa: E402
    batch_vmap,
    build_radius_graph_batch,
)
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.nn import gnn_layer as jax_gnn  # noqa: E402
from magnet_tpu.ops.segment import segment_instance_norm as jax_instance_norm  # noqa: E402
from magnet_tpu.train.import_torch import import_mpnn  # noqa: E402
from magnet_tpu_torch.eval import evaluate  # noqa: E402
from magnet_tpu_torch.data.datamodule import build_loaders  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.gnn_layer import (  # noqa: E402
    IMPLS,
    MPNNLayer,
    TemporalBundlingDecoder,
)
from magnet_tpu_torch.nn.segment import segment_instance_norm  # noqa: E402
from magnet_tpu_torch.ops.graph import radius_graph_batch  # noqa: E402
from magnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import (  # noqa: E402
    decoder_state_dict,
    mpnn_layer_state_dict,
    state_dict_from_jax,
)

MOD = dict(rtol=1e-4, atol=1e-5)
ROLL = dict(rtol=1e-3, atol=1e-4)


def test_segment_instance_norm_matches_jax():
    rng = np.random.default_rng(0)
    B, N, C = 3, 37, 16
    x = (rng.normal(size=(B, N, C)) * rng.uniform(0.1, 5, (B, 1, C))
         + rng.normal(size=(B, 1, C))).astype(np.float32)
    want = np.asarray(jax.vmap(jax_instance_norm)(jnp.asarray(x)))
    got = segment_instance_norm(torch.from_numpy(x).reshape(B * N, C), B)
    np.testing.assert_allclose(got.numpy().reshape(B, N, C), want, **MOD)
    # each sample is normalised on its own
    np.testing.assert_allclose(got.view(B, N, C).mean(1).numpy(), 0, atol=1e-5)
    with pytest.raises(ValueError):
        segment_instance_norm(torch.zeros(10, 4), 3)


@pytest.mark.parametrize("with_mid_swish", [True, False])
@pytest.mark.parametrize("tw", sorted(TemporalBundlingDecoder.TABLE))
def test_temporal_bundling_decoder_matches_jax(tw, with_mid_swish):
    rng = np.random.default_rng(tw)
    h = rng.normal(size=(23, 128)).astype(np.float32)
    jm = jax_gnn.TemporalBundlingDecoder(time_window=tw,
                                         with_mid_swish=with_mid_swish)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(tw), jnp.asarray(h)))
    want = np.asarray(jm.apply(params, jnp.asarray(h)))
    tm = TemporalBundlingDecoder(tw, with_mid_swish)
    tm.load_state_dict(decoder_state_dict(params["params"], with_mid_swish))
    got = tm(torch.from_numpy(h))
    assert got.shape == (23, tw)
    np.testing.assert_allclose(got.detach().numpy(), want, **MOD)


def test_decoder_rejects_an_unknown_time_window():
    with pytest.raises(ValueError, match="time_window"):
        TemporalBundlingDecoder(12)


@pytest.mark.parametrize("pos_dim", [1, 2])
def test_mpnn_layer_matches_jax_with_every_impl(pos_dim):
    rng = np.random.default_rng(48 + pos_dim)
    B, n, hidden, tw = 2, 150, 32, 8
    coords = np.sort(rng.uniform(-1, 1, (B, n, pos_dim)), axis=1).astype(np.float32)
    coords[1, 7] = 5.0  # isolated: a node of degree 0
    r = 0.05 if pos_dim == 1 else 0.25
    jg = build_radius_graph_batch(coords, r, loop=False)
    x, u, var = (rng.normal(size=(B, n, c)).astype(np.float32)
                 for c in (hidden, tw, 1))
    layer = batch_vmap(jax_gnn.MPNNLayer, in_axes=(0, 0, 0, 0, 0),
                       hidden_features=hidden, out_features=hidden,
                       pos_dim=pos_dim, time_window=tw)
    args = [jnp.asarray(a) for a in (x, u, coords, var)]
    params = jax.tree.map(np.asarray,
                          layer.init(jax.random.PRNGKey(3), *args, jg))
    want = np.asarray(layer.apply(params, *args, jg))

    tm = MPNNLayer(hidden, hidden, pos_dim=pos_dim, time_window=tw)
    tm.load_state_dict(mpnn_layer_state_dict(params["params"]))
    tg = radius_graph_batch(torch.from_numpy(coords), r, loop=False)
    assert tg.degree[n + 7] == 0
    flat = [torch.from_numpy(a).reshape(B * n, -1) for a in (x, u, coords, var)]
    outs = {impl: tm(*flat, tg, B, impl=impl).detach().numpy()
            for impl in IMPLS}
    for impl, got in outs.items():
        np.testing.assert_allclose(got.reshape(B, n, hidden), want,
                                   err_msg=impl, **MOD)
    # on CPU tensors every impl is the plain version
    np.testing.assert_array_equal(outs["kernel"], outs["plain"])
    np.testing.assert_allclose(outs["kernel_pregathered"], outs["plain"],
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        tm(*flat, tg, B, impl="fast")


def _batch(name, rng, B=2):
    if name == "mpnn":
        N, nt = 40, 50
        x = np.tile((np.arange(N) * 0.4).astype(np.float32)[None, :, None],
                    (B, 1, 1))
    else:
        W, nt = 8, 40
        g = (np.arange(W) / W).astype(np.float32)
        x = np.tile(np.stack(np.meshgrid(g, g, indexing="ij"), -1)
                    .reshape(1, W * W, 2), (B, 1, 1))
    t = np.tile(np.linspace(0, 1, nt, endpoint=False, dtype=np.float32), (B, 1))
    t[1] += 0.125  # the samples' time variables differ
    u = rng.normal(size=(B, x.shape[1], nt)).astype(np.float32)
    return dict(u=u, x=x, t=t)


HP = {"mpnn": dict(hidden_features=128, hidden_layer=2, time_window=16,
                   neighbors=3),
      "mpnn_2d": dict(hidden_features=128, hidden_layer=2, time_window=10,
                      neighbors=2)}


@pytest.fixture(scope="module", params=["mpnn", "mpnn_2d"])
def pair(request):
    name = request.param
    hp = HP[name]
    batch = _batch(name, np.random.default_rng(5))
    jm = jax_create_model(name, hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(1), jb, jg))
    tm = create_model(name, hp, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, hp, model=name))
    tb = to_device(batch, "cpu")
    return name, hp, jm, params, jb, jg, tm, tb, tm.build_graph(tb)


def test_core_single_window_matches_jax(pair):
    """``MPNNCore``: embed, the layers, decode with the cumulative-dt Euler
    update, on one window."""
    name, hp, jm, params, jb, jg, tm, tb, tg = pair
    rng = np.random.default_rng(6)
    B, N, tw = 2, tb["x"].shape[1], hp["time_window"]
    u = rng.normal(size=(B, N, tw)).astype(np.float32)
    pos = np.asarray(tb["x"]) / 3.0
    var = rng.uniform(size=(B, N, 1)).astype(np.float32)
    want = np.asarray(jm.core.apply(
        params, jnp.asarray(u), jnp.asarray(pos), jnp.asarray(var),
        jnp.float32(0.02), jg))
    with torch.no_grad():
        got = tm(torch.from_numpy(u), torch.from_numpy(pos),
                 torch.from_numpy(var), torch.tensor(0.02), tg)
    assert got.shape == (B, N, tw)
    np.testing.assert_allclose(got.numpy(), want, **MOD)
    # decode alone: u_last + cumsum(dt) * diff
    h = torch.from_numpy(rng.normal(size=(5, 128)).astype(np.float32))
    u5 = torch.from_numpy(u[0, :5])
    with torch.no_grad():
        dec = tm.decode(h, u5, torch.tensor(0.5))
        diff = tm.output_mlp(h)
    steps = 0.5 * torch.arange(1, tw + 1)
    np.testing.assert_allclose(dec.numpy(),
                               (u5[:, -1:] + steps * diff).numpy(), **MOD)


def test_predict_and_eval_loss_match_jax(pair):
    name, hp, jm, params, jb, jg, tm, tb, tg = pair
    want = np.asarray(jax.jit(jm.predict)(params, jb, jg))
    got = tm.predict(tb, tg)
    n_win = (tb["u"].shape[2] - hp["time_window"]) // hp["time_window"]
    assert n_win >= 2
    assert got.shape == (2, n_win * hp["time_window"], tb["u"].shape[1])
    np.testing.assert_allclose(got.numpy(), want, **ROLL)
    np.testing.assert_array_equal(
        tm.rollout_target(tb, got.shape[1]).numpy(),
        np.asarray(jm.rollout_target(jb, got.shape[1])))
    loss, m = jax.jit(lambda p: jm.loss(p, jb, jg, train=False))(params)
    got_loss, got_m = tm.loss(tb, tg, train=False)
    assert not got_loss.requires_grad
    np.testing.assert_allclose(float(got_loss), float(loss), **ROLL)
    np.testing.assert_allclose(float(got_m["mae_loss"]), float(m["mae_loss"]),
                               **ROLL)
    out = evaluate(tm, [tb], "cpu")
    np.testing.assert_allclose(out["test_mae_loss"], float(m["mae_loss"]),
                               **ROLL)


@pytest.mark.parametrize("teacher_forcing", [False, True])
def test_train_loss_and_grads_match_jax(pair, teacher_forcing):
    name, hp, jm, params, jb, jg, tm, tb, tg = pair
    jm.teacher_forcing = tm.teacher_forcing = teacher_forcing
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True), has_aux=True))(params)
    tm.zero_grad()
    got_loss, got_m = tm.loss(tb, tg, train=True)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), **ROLL)
    np.testing.assert_allclose(float(got_m["mae_loss"]), float(m["mae_loss"]),
                               **ROLL)
    # the port's gradients, carried to the JAX tree by the repo's importer
    got = import_mpnn({k: p.grad.numpy() for k, p in tm.named_parameters()},
                      hp, pos_dim=tm.pos_dim)
    want_leaves = jax.tree_util.tree_leaves_with_path(grads)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), **ROLL,
                                   err_msg=jax.tree_util.keystr(path))


def test_teacher_forcing_changes_the_rollout(pair):
    name, hp, jm, params, jb, jg, tm, tb, tg = pair
    with torch.no_grad():
        free = tm._rollout(tb, tg, teacher_forcing=False)
        forced = tm._rollout(tb, tg, teacher_forcing=True)
    tw = hp["time_window"]
    np.testing.assert_array_equal(free[:, :tw].numpy(), forced[:, :tw].numpy())
    assert not np.allclose(free[:, tw:].numpy(), forced[:, tw:].numpy())


def test_import_mpnn_inverts_state_dict_from_jax(pair):
    name, hp, jm, params, jb, jg, tm, tb, tg = pair
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = import_mpnn(sd, hp, pos_dim=tm.pos_dim)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_graph_is_cached_for_identical_coordinates(pair):
    name, hp, jm, params, jb, jg, tm, tb, tg = pair
    hits = tm.graphs.hits
    again = tm.build_graph(tb)
    assert again is tg and tm.graphs.hits == hits + 1
    moved = dict(tb, x=tb["x"] * 1.5)
    assert tm.build_graph(moved) is not tg


def test_1d_time_window_10_has_no_mid_swish():
    one = create_model("mpnn", dict(HP["mpnn"], time_window=10), device="cpu")
    two = create_model("mpnn_2d", HP["mpnn_2d"], device="cpu")
    assert [type(m).__name__ for m in one.output_mlp] == ["Conv1d", "Conv1d"]
    assert [type(m).__name__ for m in two.output_mlp] == ["Conv1d", "SiLU",
                                                          "Conv1d"]


def _memory_split(name, rng, n):
    """One split's arrays, in memory, in the HDF5 schema."""
    if name == "mpnn":
        nt, nx = 50, 20
        return {"t": np.tile(np.linspace(0, 1, nt, dtype=np.float32), (n, 1)),
                "x": np.tile((np.arange(nx) * 0.8).astype(np.float32), (n, 1)),
                f"pde_{nt}-{nx}": rng.normal(size=(n, nt, nx)).astype(np.float32)}
    nt, res = 30, 6
    g = np.tile((np.arange(res) / res).astype(np.float32), (n, 1))
    return {"t": np.tile(np.linspace(0, 1, nt, dtype=np.float32), (n, 1)),
            "x": g, "y": g.copy(),
            f"pde_{nt}-{res}": rng.normal(size=(n, nt, res, res)).astype(np.float32)}


@pytest.mark.parametrize("name", ["mpnn", "mpnn_2d"])
def test_trainer_fit_and_evaluate_on_cpu(tmp_path, name):
    rng = np.random.default_rng(9)
    kind, res_key, nt, res = (("h5_graph_1d", "nx", 50, 20) if name == "mpnn"
                              else ("h5_graph_2d", "res", 30, 6))
    cfg = {"kind": kind, "batch_size": 2}
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        cfg.update({f"{split}_path": _memory_split(name, rng, n),
                    f"nt_{split}": nt, f"{res_key}_{split}": res})
    loaders = build_loaders(cfg, seed=0)
    hp = dict(HP[name], time_window=10)
    model = create_model(name, hp, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, max_epochs=1, lr=1e-3, workdir=str(tmp_path),
                      device="cpu")
    trainer.fit(loaders["train"], loaders["val"])
    assert trainer.optimizer.step_count == 2
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert (tmp_path / "checkpoints" / "last.pt").exists()
    out = evaluate(model, list(loaders["test"]), "cpu")
    assert set(out) == {"test_loss", "test_mae_loss", "test_nrmse"}
    assert all(np.isfinite(v) for v in out.values())
