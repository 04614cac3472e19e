"""The port's FNO 1D/2D against magnet_tpu at a small size: both spectral
convolutions (odd and even lengths, the 2D corner blocks), the forward,
the rollout, the eval loss, the training loss with every parameter
gradient (the complex weights' as real/imaginary pairs), one Adam step
with coupled L2, the datasets and seeded sources against the JAX
package's files, and the weights' round trip.

Tolerances: a module rtol 1e-4, atol 1e-5 (f32 FFTs on both sides, pocketfft
and XLA's DUCC summing in another order); a rollout or loss rtol 1e-3,
atol 1e-4 (three windows carry those differences); gradients rtol 2e-3,
atol 1e-5 relative to each leaf's largest entry; parameters after one
Adam step rtol 1e-4, atol 1e-6 (Adam's first step is lr·g/|g| per entry,
so a gradient entry near 0 can move a parameter by up to lr·2: those are
held to atol 2·lr on the few entries whose gradient is within 1e-6 of
its leaf's largest).  Datasets and the seeded sources are compared
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from magnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from magnet_tpu.data.datasets import Dataset1D as JaxDataset1D  # noqa: E402
from magnet_tpu.data.datasets import Dataset2D as JaxDataset2D  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.nn.spectral import SpectralConv1d as JaxSpectral1d  # noqa: E402
from magnet_tpu.nn.spectral import SpectralConv2d as JaxSpectral2d  # noqa: E402
from magnet_tpu.train.import_torch import import_state_dict  # noqa: E402
from magnet_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from magnet_tpu_torch.data.datasets import Dataset1D, Dataset2D, read_h5_split  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.nn.spectral import SpectralConv1d, SpectralConv2d  # noqa: E402
from magnet_tpu_torch.train.optim import make_optimizer  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

MODULE = dict(rtol=1e-4, atol=1e-5)
ROLLOUT = dict(rtol=1e-3, atol=1e-4)
HP = {"fno_1d": dict(modes=5, width=16, num_layers=2, time_history=4,
                     time_future=4, teacher_forcing=True, loss="l1"),
      "fno_2d": dict(modes_1=3, modes_2=3, width=8, num_layers=2,
                     time_history=3, time_future=3, teacher_forcing=True,
                     loss="l1")}
# B=2; 1D: nt 16 (3 windows of 4), L 20; 2D: nt 12 (3 windows of 3), 8 x 9
SHAPE = {"fno_1d": (16, 20), "fno_2d": (12, 8, 9)}


def _batch(name, seed=0):
    rng = np.random.default_rng(seed)
    b = {"u": rng.normal(size=(2, *SHAPE[name])).astype(np.float32),
         "dx": rng.uniform(0.01, 0.3, 2).astype(np.float32),
         "dt": rng.uniform(0.01, 0.1, 2).astype(np.float32)}
    if name == "fno_2d":
        b["dy"] = rng.uniform(0.01, 0.3, 2).astype(np.float32)
    return b


_PARAMS: dict = {}


def _pair(name, hp=None, seed=1):
    """The JAX model and the port's with the same weights, and one batch
    on both sides."""
    hp = HP[name] if hp is None else hp
    batch = _batch(name)
    jm = jax_create_model(name, hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if (name, seed) not in _PARAMS:
        _PARAMS[name, seed] = jax.tree.map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), jb))
    params = _PARAMS[name, seed]
    tm = create_model(name, hp, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, hp, name))
    return jm, params, jb, tm, to_device(batch, "cpu")


_GRADS: dict = {}


def _jax_loss_and_grads(name, hp, jm, params, jb):
    key = (name, hp["teacher_forcing"])
    if key not in _GRADS:
        _GRADS[key] = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb, train=True), has_aux=True))(params)
    return _GRADS[key]


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


def _as_jax_tree(name, tm, hp, grads=False):
    """The port's parameters (or their gradients) as the JAX tree, through
    ``import_torch``; a complex gradient goes as its real/imaginary pair."""
    sd = {k: (p.grad if grads else p).detach().numpy()
          for k, p in tm.named_parameters()}
    return import_state_dict(name, sd, hp)


@pytest.mark.parametrize("length", [20, 21])
def test_spectral_conv1d_matches_jax(length):
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, 6, length)).astype(np.float32)
    jconv = JaxSpectral1d(6, 5, 7)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = params["params"]
    conv = SpectralConv1d(6, 5, 7)
    conv.load_state_dict({"weights": torch.complex(
        torch.tensor(np.asarray(p["weights_real"])),
        torch.tensor(np.asarray(p["weights_imag"])))})
    want, vjp = jax.vjp(lambda q, v: jconv.apply(q, v), params,
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = conv(xt)
    assert got.shape == (2, 5, length)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODULE)
    g = np.random.default_rng(1).normal(size=got.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    dparams, dx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **MODULE)
    dw = torch.view_as_real(conv.weights.grad).numpy()
    for part, want_g in ((0, dparams["params"]["weights_real"]),
                         (1, dparams["params"]["weights_imag"])):
        np.testing.assert_allclose(dw[..., part], np.asarray(want_g),
                                   rtol=1e-4,
                                   atol=1e-5 * np.abs(want_g).max())


@pytest.mark.parametrize("hw", [(8, 9), (9, 8), (7, 7)])
def test_spectral_conv2d_matches_jax_and_keeps_the_corner_blocks(hw):
    H, W = hw
    m1, m2 = 3, 3
    rng = np.random.default_rng(H * W)
    x = rng.normal(size=(2, 4, H, W)).astype(np.float32)
    jconv = JaxSpectral2d(4, 5, m1, m2)
    params = jconv.init(jax.random.PRNGKey(2), jnp.asarray(x))
    p = params["params"]
    conv = SpectralConv2d(4, 5, m1, m2)
    conv.load_state_dict({f"weights{i}": torch.complex(
        torch.tensor(np.asarray(p[f"weights{i}_real"])),
        torch.tensor(np.asarray(p[f"weights{i}_imag"]))) for i in (1, 2)})
    want, vjp = jax.vjp(lambda q, v: jconv.apply(q, v), params,
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = conv(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODULE)
    # only the +-modes1 x modes2 corner blocks of the spectrum are nonzero
    # (and in column 0 their mirror rows, where irfft2 keeps the Hermitian
    # part)
    spec = np.abs(np.fft.rfft2(got.detach().numpy().astype(np.float64)))
    keep = np.zeros(spec.shape[-2:], bool)
    keep[:m1, :m2] = keep[H - m1:, :m2] = True
    keep[(-np.flatnonzero(keep[:, 0])) % H, 0] = True
    assert spec[..., ~keep].max() < 1e-4 * spec.max()
    assert spec[..., :m1, :m2].min() > 0 and spec[..., H - m1:, :m2].min() > 0
    g = np.random.default_rng(3).normal(size=got.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    dparams, dx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **MODULE)
    for i in (1, 2):
        dw = torch.view_as_real(getattr(conv, f"weights{i}").grad).numpy()
        for part, key in ((0, "real"), (1, "imag")):
            want_g = np.asarray(dparams["params"][f"weights{i}_{key}"])
            np.testing.assert_allclose(dw[..., part], want_g, rtol=1e-4,
                                       atol=1e-5 * np.abs(want_g).max())


@pytest.mark.parametrize("name", ["fno_1d", "fno_2d"])
def test_forward_matches_jax(name):
    jm, params, jb, tm, tb = _pair(name)
    th = HP[name]["time_history"]
    spacing = ("dx", "dy", "dt") if name == "fno_2d" else ("dx", "dt")
    inp = jnp.moveaxis(jb["u"][:, :th], 1, -1)
    want = jm.core.apply(params, inp, *[jb[k] for k in spacing])
    got = tm(tb["u"][:, :th].movedim(1, -1), *[tb[k] for k in spacing])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODULE)


@pytest.mark.parametrize("name", ["fno_1d", "fno_2d"])
def test_predict_and_eval_loss_match_jax(name):
    from magnet_tpu_torch.eval import evaluate

    jm, params, jb, tm, tb = _pair(name)
    want = jax.jit(jm.predict)(params, jb)
    _, want_m = jax.jit(lambda p: jm.loss(p, jb, train=False))(params)
    got = tm.predict(tb, tm.build_graph(tb))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROLLOUT)
    _, got_m = tm.loss(tb, None, train=False)
    assert set(got_m) == set(want_m) == {"loss", "mae_loss"}
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   **ROLLOUT)
    np.testing.assert_array_equal(
        tm.rollout_target(tb, got.shape[1]).numpy(),
        np.asarray(jm.rollout_target(jb, got.shape[1])))
    out = evaluate(tm, [_batch(name)], "cpu")
    np.testing.assert_allclose(out["test_loss"], float(want_m["loss"]),
                               **ROLLOUT)


@pytest.mark.parametrize("teacher_forcing", [True, False])
@pytest.mark.parametrize("name", ["fno_1d", "fno_2d"])
def test_training_loss_and_gradients_match_jax(name, teacher_forcing):
    """Every gradient, the complex weights' as (d/d real, d/d imag) pairs:
    torch's gradient of a real loss by a complex parameter is d/d re + i
    d/d im, the pair the JAX package differentiates."""
    hp = {**HP[name], "teacher_forcing": teacher_forcing}
    jm, params, jb, tm, tb = _pair(name, hp)
    (want, want_m), grads = _jax_loss_and_grads(name, hp, jm, params, jb)
    tm.zero_grad()
    got, got_m = tm.loss(tb, None, train=True)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **ROLLOUT)
    assert set(got_m) == set(want_m)
    assert all(p.grad is not None for p in tm.parameters())
    _assert_tree_close(_as_jax_tree(name, tm, hp, grads=True), grads,
                       rtol=2e-3, atol_rel=1e-5)


@pytest.mark.parametrize("name", ["fno_1d", "fno_2d"])
def test_one_adam_step_with_coupled_l2_matches_optax(name):
    lr, wd = 1e-3, 0.01
    hp = HP[name]
    jm, params, jb, tm, tb = _pair(name)
    tx = jax_make_optimizer(lr, wd, steps_per_epoch=1)
    _, grads = _jax_loss_and_grads(name, hp, jm, params, jb)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, updates)
    opt = make_optimizer(tm.parameters(), lr, wd, steps_per_epoch=1)
    assert any(p.is_complex() for p in opt.params)
    opt.zero_grad()
    tm.loss(tb, None, train=True)[0].backward()
    opt.step()
    got = _as_jax_tree(name, tm, hp)
    leaves = zip(*(jax.tree_util.tree_leaves_with_path(t)
                   for t in (got, want, grads, params)))
    for (path, g), (_, w), (_, d), (_, p) in leaves:
        g, w = np.asarray(g), np.asarray(w)
        d = np.abs(np.asarray(d) + wd * np.asarray(p))   # the coupled L2
        tiny = d <= 1e-6 * d.max()
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(g[~tiny], w[~tiny], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(g[tiny], w[tiny], atol=2 * lr,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["fno_1d", "fno_2d"])
def test_weights_round_trip_through_import_torch(name):
    _, params, _, tm, _ = _pair(name)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sum(v.dtype == np.complex64 for v in sd.values()) == (
        2 if name == "fno_1d" else 4)
    _assert_tree_close(import_state_dict(name, sd, HP[name]), params,
                       rtol=0, atol_rel=0)
    assert set(sd) == set(state_dict_from_jax(params, HP[name], name))


def test_time_history_must_equal_time_future():
    with pytest.raises(ValueError, match="time_history == time_future"):
        create_model("fno_1d", {**HP["fno_1d"], "time_future": 5},
                     device="cpu")
    model = create_model("fno_2d", {"width": 8, "num_layers": 1},
                         device="cpu")
    assert model.time_history == model.time_future == 10
    assert model.fc0.in_features == 13


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("fno_data")
    return {
        "1d": jax_synthetic.generate_1d_file(
            str(root / "ce.h5"), n_train=2, n_valid=1, n_test=1, nt=12,
            nx=16, seed=4, eq="E2", n_steps=480),
        "2d": jax_synthetic.generate_2d_file(
            str(root / "b2d.h5"), n_train=2, n_valid=1, n_test=1, nt=6,
            res=16, seed=5)}


@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_dataset1d_matches_magnet_tpu(files, mode):
    want = JaxDataset1D(files["1d"], mode, nt=12, nx=16)
    got = Dataset1D(files["1d"], mode, nt=12, nx=16)
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w) == {"u", "dx", "dt"}
        for k in w:
            assert np.asarray(g[k]).dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_dataset2d_matches_magnet_tpu(files, mode):
    want = JaxDataset2D(files["2d"], mode, nt=6, res=16)
    got = Dataset2D(files["2d"], mode, nt=6, res=16)
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w) == {"u", "dx", "dy", "dt"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_seeded_sources_equal_the_writers_files(files):
    """``make_split`` from the writers' seed gives their train group:
    the combined equation (E2) and 2D Burgers with its dx/dy/dt."""
    got = make_split("E2", 2, 12, 16, seed=4, n_steps=480)
    assert np.isfinite(got["pde_12-16"]).all()
    want = read_h5_split(files["1d"], "train")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = make_split("B2D", 2, 6, 16, seed=5)
    want = read_h5_split(files["2d"], "train")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_datamodules_and_entry_points(files):
    """The kinds ``h5_1d`` and ``h5_2d`` read the writers' files into the
    FNO batches; ``compose`` takes both models with their datamodules;
    ``eval`` runs FNO-1D on the CPU on its seeded source (``synthetic_ce``)."""
    from magnet_tpu_torch import eval as port_eval
    from magnet_tpu_torch.config import DATAMODULE_1D, DATAMODULE_2D, compose
    from magnet_tpu_torch.data.datamodule import build_loaders

    splits = ("train", "val", "test")
    cfg = {**DATAMODULE_1D, "batch_size": 2,
           **{f"{s}_path": files["1d"] for s in splits},
           **{f"nt_{s}": 12 for s in splits}, **{f"nx_{s}": 16 for s in splits}}
    batch = next(iter(build_loaders(cfg)["train"]))
    assert batch["u"].shape == (2, 12, 16) and batch["dx"].shape == (2,)
    np.testing.assert_allclose(batch["dx"], 1.0, rtol=1e-6)
    cfg = {**DATAMODULE_2D, "batch_size": 2,
           **{f"{s}_path": files["2d"] for s in splits},
           **{f"nt_{s}": 6 for s in splits}, **{f"res_{s}": 16 for s in splits}}
    loaders = build_loaders(cfg)
    batch = next(iter(loaders["train"]))
    assert batch["u"].shape == (2, 6, 16, 16)
    assert {k: batch[k].shape for k in ("dx", "dy", "dt")} == {
        "dx": (2,), "dy": (2,), "dt": (2,)}
    assert loaders["val"].dataset.mode == "test"
    for name, dm in (("fno_1d", "h5_1d"), ("fno_2d", "h5_2d")):
        c = compose([f"model={name}", "model.params.width=8"])
        assert c["datamodule"]["kind"] == dm and c["model"]["width"] == 8
        assert c["datamodule"]["source"] == "h5"
    out = port_eval.main(["model=fno_1d", "datamodule.source=synthetic_ce",
                          "device=cpu", "n_traj=2",
                          "batch_size=2", "width=8", "num_layers=1",
                          "modes=5", "datamodule.nt_test=60",
                          "datamodule.nx_test=16", "datamodule.eq=E2",
                          "datamodule.n_steps=600"])
    assert set(out) == {"test_loss", "test_mae_loss", "test_nrmse"}
    assert all(np.isfinite(v) for v in out.values())


def test_trainer_fits_fno_on_the_cpu(tmp_path):
    """Two epochs of ``Trainer.fit`` on complex parameters: finite losses,
    a checkpoint whose complex weights read back, and a resume."""
    from magnet_tpu_torch.data.loader import DataLoader
    from magnet_tpu_torch.train.checkpoint import load_checkpoint
    from magnet_tpu_torch.train.trainer import Trainer

    class _Items:
        def __init__(self, seed):
            b = _batch("fno_1d", seed)
            self.items = [{k: v[i] for k, v in b.items()} for i in range(2)]

        def __len__(self):
            return 2

        def __getitem__(self, i):
            return self.items[i]

        def set_epoch(self, seed):
            pass

    train, val = DataLoader(_Items(0), 2), DataLoader(_Items(1), 2)
    model = create_model("fno_1d", HP["fno_1d"], device="cpu")
    trainer = Trainer(model, max_epochs=2, workdir=str(tmp_path),
                      device="cpu")
    trainer.fit(train, val)
    state, meta = load_checkpoint(str(tmp_path / "checkpoints" / "last.pt"),
                                  require=("model", "optimizer"))
    assert meta["epoch"] == 1 and state["step"] == 2
    assert all(torch.equal(v, state["model"][k])
               for k, v in model.state_dict().items())
    assert state["model"]["fourier_layers.0.weights"].is_complex()
    resumed = Trainer(create_model("fno_1d", HP["fno_1d"], device="cpu"),
                      max_epochs=3, workdir=str(tmp_path), device="cpu")
    resumed.fit(train, val, resume=str(tmp_path / "checkpoints" / "last.pt"))
    assert resumed.optimizer.step_count == 3
    assert collate([train.dataset[0]])["u"].shape == (1, 16, 20)
