"""The port's MAgNet[GNN] 1D against magnet_tpu at a small size: the k-NN
table, the k-NN INR decoder, the core's forward, the rollout, the
training loss with every parameter gradient on both kernel lanes, the
training noise, the dataset and the weights' round trip.

The JAX side runs on the CPU with its plain references (no Pallas), its
GraphNet on the fold lane, and on the pe lane (``fused_edge_tail_agg2``)
under ``MAGNET_TPU_NO_FUSED2R``; the port's kernel wrappers take their
plain versions on CPU tensors.

Tolerances: a module rtol 1e-4, atol 1e-5; a rollout or loss rtol 1e-3,
atol 1e-4 (f32 on both sides, sums in another order, carried over three
windows); gradients rtol 2e-3, atol 1e-5 relative to each leaf's largest
entry (two processors of two steps and LayerNorms between).  The k-NN
indices and the dataset's arrays are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.nn.inr import KNNDecoder as JaxKNNDecoder  # noqa: E402
from magnet_tpu.ops.graph import knn_np  # noqa: E402
from magnet_tpu.train.import_torch import import_state_dict  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicitGNN1D  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.inr import KNNDecoder  # noqa: E402
from magnet_tpu_torch.ops.graph import knn  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

MODULE = dict(rtol=1e-4, atol=1e-5)
ROLLOUT = dict(rtol=1e-3, atol=1e-4)
# B=2, nt=32 (3 windows of 8), L=32 support nodes, 8 training queries
HP = dict(time_slice=8, latent_dim=16, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, radius=0.15,
          codec_neighbors=4, noise=0.0, interpolation="area",
          teacher_forcing=True, loss="l1")
NT, NX = 32, 64


def _dataset(mode="train", eval_support="lr", seed=3):
    arrays = make_split("Heat", 2, NT, NX, seed=seed)
    ds = DatasetImplicitGNN1D(arrays, mode, nt=NT, nx=NX, samples=8,
                              eval_support=eval_support)
    ds.set_epoch(seed)
    return ds


_PARAMS: dict = {}


def _pair(hp, mode="train", eval_support="lr", seed=1):
    """The JAX model and the port's with the same weights (one JAX init
    per seed: every ``hp`` here has ``HP``'s widths), and one batch of
    ``mode`` on both sides."""
    ds = _dataset(mode, eval_support)
    batch = collate([ds[0], ds[1]])
    jm = jax_create_model("magnet_gnn", hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    if seed not in _PARAMS:
        _PARAMS[seed] = jax.tree.map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), jb, jg))
    params = _PARAMS[seed]
    tm = create_model("magnet_gnn", hp, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, hp, "magnet_gnn"))
    tb = to_device(batch, "cpu")
    return jm, params, jb, jg, tm, tb


@pytest.fixture(scope="module")
def pair():
    return _pair(HP)


def _assert_tree_close(got, want, rtol, atol_rel):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=rtol,
            atol=atol_rel * max(float(np.abs(w).max()), 1.0),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("support", ["lr", "full", "random_2d"])
def test_knn_matches_knn_np(support):
    """The slice's 1D meshes, where every odd query is equidistant from
    two support nodes (``lr``) or its 2nd and 3rd neighbours tie
    (``full``), and random 2D points with a duplicate."""
    if support == "random_2d":
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, (60, 2)).astype(np.float32)
        x[7] = x[3]
        y = rng.uniform(-1, 1, (40, 2)).astype(np.float32)
    else:
        mesh = np.linspace(0, 1, 256, dtype=np.float32)
        mesh = 2 * (mesh - mesh.min()) / (mesh.max() - mesh.min()) - 1
        x = (mesh if support == "full" else mesh[::2])[:, None]
        y = mesh[1::2, None]
    got = knn(x, y, 4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(y), 4)
    np.testing.assert_array_equal(got.numpy(), knn_np(x, y, 4))
    if support != "random_2d":
        d2 = ((y[:, None, 0].astype(np.float64) - x[None, :, 0]) ** 2)
        ties = np.sort(d2, axis=1)
        tied = ties[:, 0] == ties[:, 1] if support == "lr" \
            else ties[:, 1] == ties[:, 2]
        assert tied.sum() > 100          # the ties are there


@pytest.mark.parametrize("interpolation,full", [
    ("area", False), ("knn", False), ("sph", False), ("area", True),
    ("knn", True)])
def test_knn_decoder_matches_jax(interpolation, full):
    """``full``: every query coincides with a support node (d2 = 0), where
    the blend takes the coincident node's latent; its gradients stay
    finite."""
    rng = np.random.default_rng(5)
    B, T, C, L, latent, nc = 2, 4, 1, 24, 6, 5
    lr = np.sort(rng.uniform(-1, 1, (B, L, 1)), axis=1).astype(np.float32)
    hr = (lr[:, ::2] if full else np.sort(
        rng.uniform(-1, 1, (B, 10, 1)), axis=1)).astype(np.float32)
    hr = np.ascontiguousarray(hr)
    nbr = np.stack([knn_np(lr[b], hr[b], 4) for b in range(B)])
    x_lr = rng.normal(size=(B, T, C, L)).astype(np.float32)
    enc = rng.normal(size=(B, L, latent)).astype(np.float32)
    t = rng.uniform(0, 1, (B, 2 * T)).astype(np.float32)
    jdec = JaxKNNDecoder(n_chan=nc, codec_neighbors=4,
                         interpolation=interpolation)
    args = [jnp.asarray(a) for a in (x_lr[0], enc[0], lr[0], hr[0], t[0],
                                     nbr[0])]
    params = jdec.init(jax.random.PRNGKey(0), *args)
    want = np.stack([np.asarray(jdec.apply(params, *[
        jnp.asarray(a[b]) for a in (x_lr, enc, lr, hr, t, nbr)]))
        for b in range(B)])
    dense = params["params"]["Linear_0"]["Dense_0"]
    dec = KNNDecoder(latent + C + 1 + 1, nc, interpolation)
    dec.load_state_dict({"weight": torch.tensor(np.asarray(dense["kernel"]).T),
                         "bias": torch.tensor(np.asarray(dense["bias"]))})
    enc_t = torch.from_numpy(enc).requires_grad_()
    got = dec(torch.from_numpy(x_lr), enc_t, torch.from_numpy(lr),
              torch.from_numpy(hr), torch.from_numpy(t),
              torch.from_numpy(nbr))
    np.testing.assert_allclose(got.detach().numpy(), want, **MODULE)
    got.sum().backward()
    assert torch.isfinite(enc_t.grad).all()
    with pytest.raises(ValueError, match="interpolation"):
        KNNDecoder(4, 4, "linear")


def test_core_forward_matches_jax(pair):
    jm, params, jb, jg, tm, tb = pair
    ts = HP["time_slice"]
    args = (jb["lr_frames"][:, :ts], jb["coords_lr"], jb["coords_hr"],
            jb["t"][:, :2 * ts], jb["hr_points"][:, ts - 1])
    want = jax.jit(jm.core.apply)(params, *args, *jg)
    graphs = tm.build_graph(tb)
    got = tm(tb["lr_frames"][:, :ts], tb["coords_lr"], tb["coords_hr"],
             tb["t"][:, :2 * ts], tb["hr_points"][:, ts - 1], graphs)
    assert graphs.lr.lane == graphs.all.lane == "fold"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **MODULE)


@pytest.mark.parametrize("eval_support", ["lr", "full"])
def test_predict_and_eval_loss_match_jax(eval_support):
    jm, params, jb, jg, tm, tb = _pair(HP, mode="test",
                                       eval_support=eval_support)
    want, want_m = jax.jit(lambda p: (jm.predict(p, jb, jg),
                                      jm.loss(p, jb, jg, train=False)[1]))(
        params)
    graphs = tm.build_graph(tb)
    got = tm.predict(tb, graphs)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ROLLOUT)
    _, got_m = tm.loss(tb, graphs, train=False)
    assert set(got_m) == set(want_m) == {"loss", "mae_loss"}
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   **ROLLOUT)
    target = tm.rollout_target(tb, got[0].shape[1])
    np.testing.assert_array_equal(
        target.numpy(), np.asarray(jm.rollout_target(jb, got[0].shape[1])))


def _torch_grads_as_jax_tree(tm, hp):
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for k, p in tm.named_parameters()}
    return import_state_dict("magnet_gnn", sd, hp)


@pytest.mark.parametrize("impl", ["kernel", "kernel_pe"])
@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_train_loss_metrics_and_grads_match_jax(monkeypatch, impl,
                                                teacher_forcing):
    """``kernel`` takes the fold lane on both sides; ``kernel_pe`` is held
    against the JAX GraphNet under ``MAGNET_TPU_NO_FUSED2R`` (its
    ``fused_edge_tail_agg2`` lane)."""
    from magnet_tpu.nn import graphnet as jax_graphnet

    if impl == "kernel_pe":
        monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")
    hp = dict(HP, teacher_forcing=teacher_forcing)
    jm, params, jb, jg, tm, tb = _pair(hp)
    (want_loss, want_m), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True), has_aux=True))(params)
    lane = dict(jax_graphnet.LAST_FUSED_LANE)
    assert lane["fold"] is (impl == "kernel") and lane["mode"] == "vmem"
    tm.impl = impl
    graphs = tm.build_graph(tb)
    loss, metrics = tm.loss(tb, graphs, train=True)
    assert set(metrics) == set(want_m) == {"loss", "mae_loss", "interp_loss"}
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   **ROLLOUT)
    loss.backward()
    _assert_tree_close(_torch_grads_as_jax_tree(tm, hp), want_grads,
                       rtol=2e-3, atol_rel=1e-5)


def _jax_noise_draws(key, n_win, inp_shape, hr_shape):
    """The normal draws of the JAX rollout's noise, in its order: per
    window the input frames', then the last HR values'."""
    draws = []
    for _ in range(n_win):
        key, k1, k2 = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.normal(k1, inp_shape)))
        draws.append(np.asarray(jax.random.normal(k2, hr_shape)))
    return draws


def test_noisy_training_loss_replays_jax_draws():
    hp = dict(HP, noise=0.05)
    jm, params, jb, jg, tm, tb = _pair(hp)
    key = jax.random.PRNGKey(11)
    want, _ = jm.loss(params, jb, jg, rng=key, train=True)
    ts = hp["time_slice"]
    n_win = (NT - ts) // ts
    B, _, C, L = tb["lr_frames"].shape
    draws = _jax_noise_draws(key, n_win, (B, ts, C, L),
                             tuple(tb["hr_points"][:, 0].shape))
    shapes = []

    def replay(shape, generator):
        shapes.append(tuple(shape))
        return torch.from_numpy(draws[len(shapes) - 1])

    tm.draw_noise = replay
    graphs = tm.build_graph(tb)
    got, _ = tm.loss(tb, graphs, train=True,
                     generator=torch.Generator().manual_seed(0))
    assert len(shapes) == 2 * n_win
    np.testing.assert_allclose(float(got), float(want), **ROLLOUT)
    del tm.draw_noise
    # a seeded generator gives the same loss twice, and noise moves it
    first = tm.loss(tb, graphs, generator=torch.Generator().manual_seed(4))[0]
    again = tm.loss(tb, graphs, generator=torch.Generator().manual_seed(4))[0]
    clean, _ = _pair(HP)[4].loss(tb, graphs)
    assert float(first) == float(again) != float(clean)


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    pytest.importorskip("h5py")
    path = tmp_path_factory.mktemp("data") / "gnn.h5"
    return jax_synthetic.generate_1d_file(
        str(path), n_train=3, n_valid=2, n_test=2, nt=NT, nx=NX, seed=6)


@pytest.mark.parametrize("mode,eval_support", [
    ("train", "lr"), ("valid", "lr"), ("test", "lr"), ("test", "full")])
def test_dataset_samples_equal_magnet_tpu(h5_file, mode, eval_support):
    from magnet_tpu.data.datasets import DatasetImplicitGNN1D as JaxDataset

    kw = dict(nt=NT, nx=NX, samples=8, eval_support=eval_support)
    got_ds = DatasetImplicitGNN1D(h5_file, mode, **kw)
    want_ds = JaxDataset(h5_file, mode, load_all=True, **kw)
    assert len(got_ds) == len(want_ds)
    for epoch_seed in (0, 77):
        got_ds.set_epoch(epoch_seed)
        want_ds.set_epoch(epoch_seed)
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mode != "train":
        sample = got_ds[0]
        n_q = NX if eval_support == "full" else NX // 2
        assert sample["coords_hr"].shape == (n_q, 1)


def test_datamodule_and_test_batches_from_a_seed():
    """The implicit-GNN datamodule on ``synthetic_ks`` (KS train and
    valid, Heat test) and ``synthetic_test_batches('magnet_gnn')`` give
    the model's batch keys at the configured shapes."""
    from magnet_tpu_torch.config import DATAMODULE_IMPLICIT_GNN
    from magnet_tpu_torch.data.datamodule import (
        build_loaders,
        synthetic_test_batches,
    )

    cfg = {**DATAMODULE_IMPLICIT_GNN, "source": "synthetic_ks", "n_train": 2,
           "n_val": 1, "n_test": 1, "batch_size": 2, "samples": 8,
           "nt_train": 16, "nt_val": 16, "nt_test": 16, "nx_train": 32,
           "nx_val": 32, "nx_test": 32, "burn_in": 0.5}
    loaders = build_loaders(cfg, seed=0)
    batch = next(iter(loaders["train"]))
    assert batch["lr_frames"].shape == (2, 16, 1, 16)
    assert batch["coords_lr"].shape == (2, 16, 1)
    assert batch["coords_hr"].shape == batch["sample_idx"].shape + (1,)
    assert (batch["sample_idx"] % 2 == 1).all()
    assert next(iter(loaders["val"]))["coords_hr"].shape == (1, 16, 1)
    (test,) = synthetic_test_batches("magnet_gnn", 2, 2)
    assert test["hr_points"].shape == (2, 256, 128, 1)
    np.testing.assert_allclose(test["coords_lr"][0, :, 0],
                               np.linspace(-1, 1, 256)[::2], atol=1e-6)


def test_weights_round_trip_through_import_torch(pair):
    """The port's state_dict, read by ``import_state_dict('magnet_gnn')``,
    gives back the JAX params leaf for leaf."""
    _, params, _, _, tm, _ = pair
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = import_state_dict("magnet_gnn", sd, HP)
    _assert_tree_close(back, params, rtol=0, atol_rel=0)
    assert set(sd) == set(state_dict_from_jax(params, HP, "magnet_gnn"))
