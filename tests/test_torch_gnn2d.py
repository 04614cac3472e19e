"""The port's MAgNet[GNN] 2D against magnet_tpu at a small size: the
dataset on the JAX package's irregular (uniform and concentrated) and
regular files, the seeded irregular source against those files, the k-NN
table on a regular grid against the native ``mt_knn``, the core's forward,
``predict``, the eval loss and the training loss with every parameter
gradient at P = 2, the weights' round trip, the datamodule and the entry
points; and the eval batches of both packages on a test split that is not
a multiple of the batch.

The JAX side runs on the CPU with its plain references (no Pallas) and its
native neighbour search (``magnet_tpu/runtime/neighbors.cpp``), whose tie
order the port's ``knn`` copies: on the regular grids every query has
equidistant support nodes.  The port's kernel wrappers take their plain
versions on CPU tensors.

Tolerances are ``tests/test_torch_gnn.py``'s: a module rtol 1e-4, atol
1e-5; a rollout or loss rtol 1e-3, atol 1e-4; gradients rtol 2e-3, atol
1e-5 relative to each leaf's largest entry.  The k-NN indices, the
datasets' and the sources' arrays and the eval batches are compared
exactly.
"""
import fcntl
import importlib
import os
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from magnet_tpu.data.datasets import DatasetImplicitGNN2D as JaxDataset  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.ops import graph as jax_graph  # noqa: E402
from magnet_tpu.train.import_torch import import_magnet_gnn  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicitGNN2D, read_h5_split  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.ops.graph import knn  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import gnn_pos_dim, state_dict_from_jax  # noqa: E402

MODULE = dict(rtol=1e-4, atol=1e-5)
ROLLOUT = dict(rtol=1e-3, atol=1e-4)
# nt 16 (3 windows of 4); a 16 x 16 grid: 64 irregular nodes (32 support,
# 16 training queries) or the regular grid (128 support, 128 queries)
HP = dict(time_slice=4, latent_dim=16, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, radius=0.3,
          codec_neighbors=4, noise=0.0, interpolation="area",
          teacher_forcing=True, loss="l1")
NT, RES, N_NODES, SAMPLES = 16, 16, 64, 16
KIND = "h5_implicit_gnn_2d"


def load_native_neighbours():
    """``magnet_tpu.ops.graph``'s native neighbour search, loaded.  Its
    module rebuilds ``libneighbors.so`` with ``make`` when the library is
    older than ``neighbors.cpp`` (a fresh checkout); pytest-xdist's workers
    import it at once, and an import that meets another worker's rebuild
    fails and leaves ``_native`` None: the numpy k-NN then takes its place,
    whose ties go another way.  Such a worker imports it again here, one
    process at a time (a file lock), after every worker's collection, so
    after the rebuilds; a library left unloadable is rebuilt under the
    lock."""
    if jax_graph._native is None:
        path = os.path.join(tempfile.gettempdir(),
                            "magnet_tpu_libneighbors.lock")
        with open(path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            name = "magnet_tpu.runtime.neighbors"
            sys.modules.pop(name, None)
            try:
                native = importlib.import_module(name)
            except Exception:
                so = os.path.join(os.path.dirname(jax_graph.__file__),
                                  os.pardir, "runtime", "libneighbors.so")
                if os.path.exists(so):
                    os.remove(so)
                sys.modules.pop(name, None)
                native = importlib.import_module(name)
            jax_graph._native = native
    return jax_graph._native


@pytest.fixture(scope="module", autouse=True)
def native_neighbours():
    """Every test here compares k-NN tables, or what follows from them,
    with the native search's tie order."""
    return load_native_neighbours()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("gnn2d")
    kw = dict(nt=NT, res=RES)
    return {
        "regular": jax_synthetic.generate_2d_file(
            str(root / "regular.h5"), n_train=2, n_valid=1, n_test=2,
            seed=11, **kw),
        "uniform": jax_synthetic.generate_2d_file(
            str(root / "uniform.h5"), n_train=2, n_valid=1, n_test=1,
            seed=12, irregular=True, n_nodes=N_NODES, **kw),
        "concentrated": jax_synthetic.generate_2d_file(
            str(root / "concentrated.h5"), n_train=1, n_valid=1, n_test=1,
            seed=13, irregular=True, n_nodes=N_NODES, concentrated=True,
            **kw)}


def test_native_neighbour_search_is_loaded():
    assert jax_graph._native is not None


@pytest.mark.parametrize("mesh,mode,eval_support", [
    ("uniform", "train", "lr"), ("uniform", "test", "lr"),
    ("concentrated", "train", "lr"), ("concentrated", "valid", "full"),
    ("regular", "train", "lr"), ("regular", "test", "lr"),
    ("regular", "test", "full")])
def test_dataset_samples_equal_magnet_tpu(files, mesh, mode, eval_support):
    regular = mesh == "regular"
    kw = dict(nt=NT, res=RES, regular=regular, samples=SAMPLES,
              eval_support=eval_support,
              n_nodes=None if regular else N_NODES)
    got_ds = DatasetImplicitGNN2D(files[mesh], mode, **kw)
    want_ds = JaxDataset(files[mesh], mode, load_all=True, **kw)
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
    sample = got_ds[0]
    n = RES * RES if regular else N_NODES
    assert sample["coords_lr"].shape[1] == 2
    assert sample["coords_lr"].min() == -1 and sample["coords_lr"].max() <= 1
    if mode != "train":
        n_q = n if eval_support == "full" else n // 2
        assert sample["coords_hr"].shape == (n_q, 2)


@pytest.mark.parametrize("mesh", ["uniform", "concentrated"])
def test_seeded_irregular_source_equals_the_file(files, mesh):
    """``make_split('B2D', n_nodes=...)`` from the writer's seed gives its
    train group: the same solves, the same node draws after each."""
    n = 2 if mesh == "uniform" else 1
    got = make_split("B2D", n, NT, RES, seed={"uniform": 12,
                                              "concentrated": 13}[mesh],
                     n_nodes=N_NODES, concentrated=mesh == "concentrated")
    want = read_h5_split(files[mesh], "train")
    assert set(got) == set(want)
    assert got[f"pde_{NT}-{N_NODES}"].shape == (n, NT, N_NODES)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_knn_equals_native_knn_np_on_a_regular_grid():
    """The regular 32 x 32 eval grid of the published configuration: most
    queries' two nearest support nodes tie (left and right), and so do
    their 3rd and 4th (diagonal); ties go to the lower index on both
    sides."""
    g = np.arange(32, dtype=np.float32)
    coords = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    coords = (2 * (coords - coords.min(0)) / (coords.max(0) - coords.min(0))
              - 1).astype(np.float32)
    lr, hr = coords[::2], coords[1::2]
    got = knn(lr, hr, 4).numpy()
    want = jax_graph.knn_np(lr, hr, 4)
    np.testing.assert_array_equal(got, want)
    d2 = ((hr[:, None].astype(np.float64) - lr[None]) ** 2).sum(-1)
    ranked = np.sort(d2, axis=1)
    # the ties are there: 256 and 361 of the 512 queries
    assert (ranked[:, 0] == ranked[:, 1]).sum() > 200
    assert (ranked[:, 2] == ranked[:, 3]).sum() > 300


_PARAMS: dict = {}


def _pair(files, hp, mesh, mode, eval_support="lr", seed=1):
    """The JAX model and the port's (P = 2) with the same weights, and one
    batch of 2 samples of ``mesh``'s ``mode`` split on both sides."""
    regular = mesh == "regular"
    arrays = read_h5_split(files[mesh], mode)
    ds = DatasetImplicitGNN2D(arrays, mode, nt=NT, res=RES, regular=regular,
                              samples=SAMPLES, eval_support=eval_support,
                              n_nodes=None if regular else N_NODES)
    ds.set_epoch(5)
    batch = collate([ds[i] for i in range(2)])
    jm = jax_create_model("magnet_gnn", hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    if seed not in _PARAMS:
        _PARAMS[seed] = jax.tree.map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), jb, jg))
    params = _PARAMS[seed]
    tm = create_model("magnet_gnn", hp, device="cpu", kind=KIND)
    tm.load_state_dict(state_dict_from_jax(params, hp, "magnet_gnn",
                                           pos_dim=2))
    return jm, params, jb, jg, tm, to_device(batch, "cpu")


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


def test_core_forward_matches_jax(files):
    jm, params, jb, jg, tm, tb = _pair(files, HP, "uniform", "train")
    assert tm.pos_dim == 2 and gnn_pos_dim(params, HP) == 2
    ts = HP["time_slice"]
    args = (jb["lr_frames"][:, :ts], jb["coords_lr"], jb["coords_hr"],
            jb["t"][:, :2 * ts], jb["hr_points"][:, ts - 1])
    want = jax.jit(jm.core.apply)(params, *args, *jg)
    graphs = tm.build_graph(tb)
    np.testing.assert_array_equal(graphs.nbr.numpy(), np.asarray(jg[2]))
    got = tm(tb["lr_frames"][:, :ts], tb["coords_lr"], tb["coords_hr"],
             tb["t"][:, :2 * ts], tb["hr_points"][:, ts - 1], graphs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **MODULE)


@pytest.mark.parametrize("mesh,eval_support", [
    ("regular", "lr"), ("regular", "full"), ("uniform", "lr")])
def test_predict_and_eval_loss_match_jax(files, mesh, eval_support):
    from magnet_tpu_torch.eval import evaluate

    jm, params, jb, jg, tm, tb = _pair(
        files, HP, mesh, "test" if mesh == "regular" else "train",
        eval_support)
    want, want_m = jax.jit(lambda p: (jm.predict(p, jb, jg),
                                      jm.loss(p, jb, jg, train=False)[1]))(
        params)
    graphs = tm.build_graph(tb)
    np.testing.assert_array_equal(graphs.nbr.numpy(), np.asarray(jg[2]))
    got = tm.predict(tb, graphs)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ROLLOUT)
    _, got_m = tm.loss(tb, graphs, train=False)
    assert set(got_m) == set(want_m) == {"loss", "mae_loss"}
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   **ROLLOUT)
    out = evaluate(tm, [{k: v.numpy() for k, v in tb.items()}], "cpu")
    np.testing.assert_allclose(out["test_loss"], float(want_m["loss"]),
                               **ROLLOUT)


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_train_loss_metrics_and_grads_match_jax(files, teacher_forcing):
    hp = dict(HP, teacher_forcing=teacher_forcing)
    jm, params, jb, jg, tm, tb = _pair(files, hp, "uniform", "train")
    (_, want_m), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True), has_aux=True))(params)
    loss, metrics = tm.loss(tb, tm.build_graph(tb), train=True)
    assert set(metrics) == set(want_m) == {"loss", "mae_loss", "interp_loss"}
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]), **ROLLOUT)
    loss.backward()
    sd = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    _assert_tree_close(import_magnet_gnn(sd, hp), want_grads,
                       rtol=2e-3, atol_rel=1e-5)


def test_weights_round_trip_through_import_magnet_gnn(files):
    _, params, _, _, tm, _ = _pair(files, HP, "uniform", "train")
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sd["encoder.node_fn.0.layers.0.weight"].shape[1] == (
        HP["time_slice"] + 2 + 1)
    _assert_tree_close(import_magnet_gnn(sd, HP), params, rtol=0,
                       atol_rel=0)
    with pytest.raises(ValueError, match="P = 2, the model at P = 1"):
        state_dict_from_jax(params, HP, "magnet_gnn", pos_dim=1)
    one_d = create_model("magnet_gnn", HP, device="cpu")
    assert one_d.pos_dim == 1
    with pytest.raises(RuntimeError, match="size mismatch"):
        one_d.load_state_dict(state_dict_from_jax(params, HP, "magnet_gnn"))


def test_datamodule_compose_and_eval():
    """``datamodule=h5_datamodule_implicit_gnn_2d`` reaches the kind (no
    model's default) through ``compose`` and ``eval``; its seeded source
    makes an irregular training split and regular val/test grids."""
    from magnet_tpu_torch import eval as port_eval
    from magnet_tpu_torch.config import DATAMODULE_IMPLICIT_GNN_2D, compose
    from magnet_tpu_torch.data.datamodule import build_loaders

    cfg = compose(["model=magnet_gnn",
                   "datamodule=h5_datamodule_implicit_gnn_2d",
                   "datamodule.res_train=512", "datamodule.samples=256",
                   "model.params.time_slice=10",
                   "datamodule.source=synthetic_burgers_2d",
                   "datamodule.n_nodes_train=null"])
    assert cfg["datamodule"] == {**DATAMODULE_IMPLICIT_GNN_2D,
                                 "res_train": 512, "samples": 256,
                                 "source": "synthetic_burgers_2d"}
    assert cfg["model"]["time_slice"] == 10
    cfg = {**cfg["datamodule"], "n_train": 2, "n_val": 1, "n_test": 1,
           "batch_size": 2, "nt_train": 6, "nt_val": 6, "nt_test": 6,
           "res_train": 24, "samples": 8, "res_val": 8, "res_test": 8}
    loaders = build_loaders(cfg)
    batch = next(iter(loaders["train"]))
    assert batch["coords_lr"].shape == (2, 12, 2)
    assert batch["coords_hr"].shape == (2, 8, 2)
    assert batch["lr_frames"].shape == (2, 6, 1, 12)
    assert loaders["train"].dataset.key == "pde_6-24"
    val = next(iter(loaders["val"]))
    assert val["coords_lr"].shape == val["coords_hr"].shape == (1, 32, 2)
    out = port_eval.main(["model=magnet_gnn", f"datamodule={cfg['name']}",
                          "datamodule.source=synthetic_burgers_2d",
                          "device=cpu", "n_traj=2", "batch_size=2",
                          "datamodule.nt_test=12", "datamodule.res_test=8",
                          *[f"{k}={v}" for k, v in HP.items()]])
    assert set(out) == {"test_loss", "test_mae_loss", "test_nrmse"}
    assert all(np.isfinite(v) for v in out.values())


def test_eval_batches_drop_the_partial_batch_as_magnet_tpu(tmp_path):
    """5 test trajectories at batch 2: the port's eval batches and the
    repo's ``eval.py`` loader (``build_loaders(...)['test']`` with
    ``shuffle_eval=False``) over the same arrays give the same 2 batches;
    the fifth trajectory is left out by both."""
    from magnet_tpu.data.datamodule import build_loaders as jax_build_loaders
    from magnet_tpu_torch.config import DATAMODULE_IMPLICIT_GNN_2D
    from magnet_tpu_torch.data.datamodule import synthetic_test_batches

    dm = {**DATAMODULE_IMPLICIT_GNN_2D, "nt_test": 6, "res_test": 8}
    got = synthetic_test_batches("magnet_gnn", 5, 2, seed=3, datamodule=dm)
    arrays = make_split("B2D", 5, 6, 8, seed=3)
    path = str(tmp_path / "odd.h5")
    with h5py.File(path, "w") as f:
        for mode in ("train", "test"):
            g = f.create_group(mode)
            for k, v in arrays.items():
                g.create_dataset(k, data=v)
    cfg = {**dm, "test_path": path, "val_path": path, "train_path": path,
           "nt_train": 6, "res_train": 8, "nt_val": 6, "res_val": 8,
           "train_regular": True, "num_workers": 0, "batch_size": 2}
    want = list(jax_build_loaders(cfg, seed=0, shuffle_eval=False)["test"])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape[0] == 2
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
