"""The port's MAgNet[CNN] 2D against magnet_tpu at a small size, with the
weights carried over by ``state_dict_from_jax``: the modules (EDSR 2D,
``INRDecoder2D``, bilinear resize, nearest 2D sample), ``DatasetImplicit2D``
and the ``h5_implicit_2d`` datamodule, the eval rollout, the train and val
losses with their metrics, every parameter gradient of a training loss on
the ``pregathered`` lane, on the ``fold`` lane forced and on the graph's
own lane, the three feedback branches, the weight round trip, and
``Trainer.fit`` / ``evaluate`` on the CPU.

Inputs are made with numpy from a seed.  Tolerances: modules rtol 1e-4,
atol 1e-5 (f32 on both sides, sums in another order); rollouts, losses and
metrics rtol 1e-4, atol 1e-5; gradients rtol 2e-3, atol 1e-5 relative to
each leaf's largest entry, as ``test_torch_train.py`` holds the 1D model
(two windows, two message-passing steps and LayerNorms in between).  On
the ``pregathered`` lane the edge scale 2^k is folded into W_e, where the
JAX lane forms s·(e0·W_e + b) + (1 − s)·b: exact for a power of two up to
one rounding of the bias, well inside those bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.data import datamodule as jax_datamodule  # noqa: E402
from magnet_tpu.models.common import batch_vmap  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.nn.edsr import EDSR as JaxEDSR  # noqa: E402
from magnet_tpu.nn.inr import INRDecoder2D as JaxINR2D  # noqa: E402
from magnet_tpu.ops import interp as jax_interp  # noqa: E402
from magnet_tpu.train.import_torch import import_state_dict  # noqa: E402
from magnet_tpu_torch.data.datamodule import build_loaders  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicit2D  # noqa: E402
from magnet_tpu_torch.data.loader import DataLoader, collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.eval import evaluate  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.edsr import EDSR  # noqa: E402
from magnet_tpu_torch.nn.inr import INRDecoder2D  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.interp import (  # noqa: E402
    grid_sample_nearest_2d,
    interpolate_bilinear_2d,
)
from magnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import (  # noqa: E402
    edsr_state_dict,
    state_dict_from_jax,
)

MOD = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 2e-3, 1e-5
# B=2, nt=12 (two windows of 4), an 8 x 8 mesh: a 4 x 4 support, 6 train
# queries, all 64 in eval
HP = dict(time_slice=4, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=8, res_layers=1, radius=0.5,
          teacher_forcing=True, loss="l1")
NT, RES = 12, 8


def _arrays(n, seed, nt=NT, res=RES):
    """One split in the HDF5 schema, random values made from a seed."""
    rng = np.random.default_rng(seed)
    g = np.tile((np.arange(res) / res).astype(np.float32), (n, 1))
    t = np.tile(np.linspace(0, 1, nt, endpoint=False, dtype=np.float32),
                (n, 1))
    return {"t": t, "x": g, "y": g.copy(),
            f"pde_{nt}-{res}": rng.normal(size=(n, nt, res, res))
            .astype(np.float32)}


def _batch(mode, seed=3):
    ds = DatasetImplicit2D(_arrays(2, seed), mode, nt=NT, res=RES, samples=6)
    ds.set_epoch(seed)
    return collate([ds[0], ds[1]])


@pytest.fixture(scope="module")
def pair():
    batch = _batch("train")
    jm = jax_create_model("magnet_cnn_2d", HP)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jb, jm.build_graph(batch))
    params = jax.tree.map(np.asarray, params)
    tm = create_model("magnet_cnn_2d", HP, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP, model="magnet_cnn_2d"))
    return jm, params, tm


def _both(jm, batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            jm.build_graph(batch), to_device(batch, "cpu"))


def test_edsr_2d_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 6, 5)).astype(np.float32)       # (B, H, W, C)
    jm = JaxEDSR(n_chan=8, res_layers=2, kernel_size=3, ndim=2)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                              jnp.asarray(x)))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = EDSR(5, n_chan=8, res_layers=2, kernel_size=3, ndim=2)
    tm.load_state_dict(edsr_state_dict(params["params"], 2))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), want,
                               **MOD)


def test_inr_decoder_2d_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    B, T, W, N, cf = 2, 4, 5, 7, 8
    x_t = rng.normal(size=(B, T, 1, W, W)).astype(np.float32)
    feat = rng.normal(size=(B, cf, W, W)).astype(np.float32)
    coords = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
    coords[0, 0] = (-1.0, 1.0)               # corners clip into the mesh
    cell = np.full((B, N, 2), 2.0 / W, np.float32)
    t = rng.uniform(size=(B, 2 * T)).astype(np.float32)
    dec = batch_vmap(JaxINR2D, in_axes=(0, 0, 0, 0, 0), n_chan=cf,
                     mlp_layers=HP["mlp_layers"], mlp_hidden=HP["mlp_hidden"])
    want = dec.apply({"params": params["params"]["continuous_decoder"]},
                     *map(jnp.asarray, (x_t, feat, cell, coords, t)))
    got = tm.proj_head(*map(torch.from_numpy, (x_t, feat, cell, coords, t)))
    assert got.shape == (B, N, T, cf)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MOD)


def test_resampling_2d_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 8, 8)).astype(np.float32)
    for size in ((16, 16), (4, 4), (5, 11)):
        want = np.asarray(jax_interp.interpolate_bilinear_2d(jnp.asarray(x),
                                                             size))
        got = interpolate_bilinear_2d(torch.from_numpy(x), size)
        np.testing.assert_allclose(got.numpy(), want, **MOD)
    feat = rng.normal(size=(3, 6, 7)).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, (2, 40)).astype(np.float32)
    want = np.asarray(jax_interp.grid_sample_nearest_2d(
        jnp.asarray(feat), jnp.asarray(g[0]), jnp.asarray(g[1])))
    got = grid_sample_nearest_2d(torch.from_numpy(feat),
                                 torch.from_numpy(g[0]), torch.from_numpy(g[1]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def h5_splits(tmp_path_factory):
    """Three files in the HDF5 schema (the 2D val and test splits read the
    group ``test``), from the arrays ``synthetic_burgers_2d`` makes."""
    h5py = pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("b2d")
    paths, arrays = {}, {}
    for i, (split, group, n) in enumerate((("train", "train", 2),
                                           ("val", "test", 1),
                                           ("test", "test", 1))):
        arrays[split] = make_split("B2D", n, NT, RES, seed=3 + i)
        paths[split] = str(root / f"{split}.h5")
        with h5py.File(paths[split], "w") as f:
            for k, v in arrays[split].items():
                f.create_dataset(f"{group}/{k}", data=v)
    return paths, arrays


def _assert_sample_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k == "lr_frames":  # the bilinear resize: one formula, two libraries
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode,eval_support", [
    ("train", "lr"), ("test", "lr"), ("test", "full")])
def test_dataset_implicit_2d_equals_magnet_tpu(h5_splits, mode, eval_support):
    from magnet_tpu.data.datasets import DatasetImplicit2D as JaxDataset

    paths, arrays = h5_splits
    split = "train" if mode == "train" else "test"
    kw = dict(nt=NT, res=RES, samples=5, eval_support=eval_support)
    want_ds = JaxDataset(paths[split], mode, load_all=True, **kw)
    got_ds = DatasetImplicit2D(arrays[split], mode, **kw)
    assert len(got_ds) == len(want_ds)
    for epoch_seed in (0, 777):
        got_ds.set_epoch(epoch_seed)
        want_ds.set_epoch(epoch_seed)
        for i in range(len(want_ds)):
            _assert_sample_equal(got_ds[i], want_ds[i])
    w = RES if eval_support == "full" and mode != "train" else RES // 2
    assert got_ds[0]["lr_frames"].shape == (NT, 1, w, w)


def test_implicit_2d_datamodule_on_the_synthetic_source(h5_splits):
    """``synthetic_burgers_2d`` makes the splits ``build_loaders`` reads;
    the JAX datamodule on the same arrays in files gives the same batches."""
    paths, _ = h5_splits
    cfg = {"kind": "h5_implicit_2d", "samples": 5, "batch_size": 2}
    for split in ("train", "val", "test"):
        cfg.update({f"nt_{split}": NT, f"res_{split}": RES})
    got = build_loaders({**cfg, "source": "synthetic_burgers_2d", "n_train": 2,
                         "n_val": 1, "n_test": 1, "data_seed": 1}, seed=4)
    want = jax_datamodule.build_loaders(
        {**cfg, **{f"{s}_path": paths[s] for s in paths}}, seed=4)
    assert got["val"].dataset.mode == "test"
    for split in ("train", "val", "test"):
        got[split].set_epoch(1)
        want[split].set_epoch(1)
        gb, wb = next(iter(got[split])), next(iter(want[split]))
        _assert_sample_equal(gb, wb)
    assert gb["coords"].shape == (1, RES * RES, 2)


def test_predict_and_val_loss_match_jax(pair):
    """The eval rollout (the validation feedback: the HR prediction on its
    8 x 8 grid resized to the 4 x 4 support) and ``loss(train=False)``."""
    jm, params, tm = pair
    jb, jg, tb = _both(jm, _batch("test"))
    want_hr, want_lr = jax.jit(jm.predict)(params, jb, jg)
    tg = tm.build_graph(tb)
    got_hr, got_lr = tm.predict(tb, tg)
    assert got_hr.shape == (2, 8, RES * RES, 1)
    assert got_lr.shape == (2, 8, 1, RES // 2, RES // 2)
    np.testing.assert_allclose(got_hr.numpy(), np.asarray(want_hr), **MOD)
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(want_lr), **MOD)
    loss, m = jax.jit(lambda p: jm.loss(p, jb, jg, train=False))(params)
    got_loss, got_m = tm.loss(tb, tg, train=False)
    assert set(got_m) == set(m) == {"loss", "mae_loss"}
    np.testing.assert_allclose(float(got_loss), float(loss), **MOD)
    np.testing.assert_allclose(float(got_m["mae_loss"]), float(m["mae_loss"]),
                               **MOD)
    out = evaluate(tm, [tb], "cpu")
    np.testing.assert_allclose(out["test_mae_loss"], float(m["mae_loss"]),
                               **MOD)


def _assert_tree_close(got, want):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * max(float(np.abs(w).max()), 1.0),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("teacher_forcing,impl", [
    (True, "kernel"), (True, "kernel_pregathered"), (True, "kernel_fold"),
    (False, "kernel_pregathered")])
def test_train_loss_metrics_and_grads_match_jax(pair, impl, teacher_forcing):
    """The teacher-forcing and the plain-feedback branches, with the
    interp loss; every parameter gradient, carried to the JAX tree by the
    repo's importer (which is linear, so it carries gradients too).  On
    CPU tensors every lane runs its kernels' plain versions: the lane's
    wiring (the segment-sum backward of the sender gather, the
    pregathered tail) is what differs."""
    jm, params, tm = pair
    jm.teacher_forcing = tm.teacher_forcing = teacher_forcing
    jb, jg, tb = _both(jm, _batch("train"))
    (want_loss, want_m), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True), has_aux=True))(params)
    tm.impl = impl
    tm.zero_grad()
    seg_before = seg.launches
    loss, metrics = tm.loss(tb, tm.build_graph(tb), train=True)
    assert set(metrics) == {"loss", "mae_loss", "interp_loss"} == set(want_m)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **MOD)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]), **MOD, err_msg=k)
    loss.backward()
    tm.impl = "kernel"
    assert seg.launches == seg_before          # CPU tensors: no kernel
    grads = {k: v.grad.numpy() for k, v in tm.named_parameters()}
    assert all(np.isfinite(g).all() for g in grads.values())
    _assert_tree_close(import_state_dict("magnet_cnn_2d", grads, HP),
                       want_grads)


def test_rollout_branches_differ(pair):
    """Teacher forcing, plain feedback and validation feedback share the
    first window and differ after it."""
    jm, params, tm = pair
    tb = to_device(_batch("test"), "cpu")
    tg = tm.build_graph(tb)
    ts = HP["time_slice"]
    with torch.no_grad():
        runs = [tm._rollout(tb, tg, teacher_forcing=tf, val_feedback=vf)[0]
                for tf, vf in ((True, False), (False, False), (False, True))]
    for a in runs[1:]:
        np.testing.assert_array_equal(a[:, :ts].numpy(), runs[0][:, :ts].numpy())
        assert not np.allclose(a[:, ts:].numpy(), runs[0][:, ts:].numpy())
    assert not np.allclose(runs[1][:, ts:].numpy(), runs[2][:, ts:].numpy())


def test_graph_lanes_of_the_two_splits(pair):
    """On this small mesh (one 128-row tile per sample) both graphs take
    the fold lane, as the JAX package does (``test_torch_lane.py`` holds
    the full-size graphs); the sender CSR lists every edge once, by
    sender."""
    jm, params, tm = pair
    for mode in ("train", "test"):
        tg = tm.build_graph(to_device(_batch(mode), "cpu"))
        assert tg.lane == "fold"
        assert tm.build_graph(to_device(_batch(mode), "cpu")) is tg
        order = tg.senders[tg.snd_perm.long()]
        assert bool((order[1:] >= order[:-1]).all())
        assert int(tg.snd_ptr[-1]) == tg.n_edge


def test_import_state_dict_inverts_state_dict_from_jax(pair):
    jm, params, tm = pair
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = import_state_dict("magnet_cnn_2d", sd, HP)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_trainer_fit_and_evaluate_on_cpu(tmp_path):
    cfg = {"kind": "h5_implicit_2d", "batch_size": 2, "samples": 6}
    for i, (split, n) in enumerate((("train", 4), ("val", 2), ("test", 2))):
        cfg.update({f"{split}_path": _arrays(n, 20 + i), f"nt_{split}": NT,
                    f"res_{split}": RES})
    loaders = build_loaders(cfg, seed=0)
    model = create_model("magnet_cnn_2d", HP, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = (fe.launches, fe.launches_pregathered, seg.launches)
    trainer = Trainer(model, max_epochs=1, lr=1e-3, workdir=str(tmp_path),
                      device="cpu")
    trainer.fit(loaders["train"], loaders["val"])
    assert (fe.launches, fe.launches_pregathered, seg.launches) == launches
    assert trainer.optimizer.step_count == 2
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert (tmp_path / "checkpoints" / "last.pt").exists()
    out = evaluate(model, list(DataLoader(loaders["test"].dataset, 2,
                                          shuffle=False, drop_last=False)),
                   "cpu")
    assert set(out) == {"test_loss", "test_mae_loss", "test_nrmse"}
    assert all(np.isfinite(v) for v in out.values())
