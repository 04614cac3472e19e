"""The port's data path against magnet_tpu's: the solver copies (KS, the
combined equation, 2D Burgers), the implicit-1D and the graph datasets on
HDF5 files read by both packages and on the same arrays in memory, and the
loader's order and batch counts.

Everything is compared exactly except ``lr_frames``: the linear resize is
the same formula in torch and in jnp, so rtol 1e-6, atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from magnet_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from magnet_tpu_torch.data import synthetic  # noqa: E402
from magnet_tpu_torch.data.datamodule import build_loaders  # noqa: E402
from magnet_tpu_torch.data.datasets import (  # noqa: E402
    DatasetGraph1D,
    DatasetGraph2D,
    DatasetImplicit1D,
    read_h5_split,
)
from magnet_tpu_torch.data.loader import DataLoader  # noqa: E402

NT, NX = 32, 64


def test_solve_ks_1d_copy_equals_magnet_tpu():
    kw = dict(nx_fine=64, nt_out=16, nx_out=32, t_end=1.0, burn_in=0.5)
    got = synthetic.solve_ks_1d(np.random.default_rng(7), **kw)
    want = jax_synthetic.solve_ks_1d(np.random.default_rng(7), **kw)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("eq", ["E1", "E2", "E3"])
def test_solve_combined_1d_copy_equals_magnet_tpu(eq):
    kw = dict(eq=eq, nx_fine=64, nt_out=10, nx_out=16, n_steps=400)
    got = synthetic.solve_combined_1d(np.random.default_rng(3), **kw)
    want = jax_synthetic.solve_combined_1d(np.random.default_rng(3), **kw)
    assert np.isfinite(got[0]).all() and np.abs(got[0]).max() > 0.1
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="preset"):
        synthetic.solve_combined_1d(np.random.default_rng(3), eq="E4")


def test_solve_burgers_2d_copy_equals_magnet_tpu():
    kw = dict(w_fine=16, nt_out=5, w_out=8)
    got = synthetic.solve_burgers_2d(np.random.default_rng(8), **kw)
    want = jax_synthetic.solve_burgers_2d(np.random.default_rng(8), **kw)
    assert got[0].shape == (5, 8, 8)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_make_split_of_the_graph_sources():
    ce = synthetic.make_split("E2", 2, 10, 16, seed=1, n_steps=400)
    assert ce["pde_10-16"].shape == (2, 10, 16)
    assert ce["x"].shape == (2, 16) and ce["t"].shape == (2, 10)
    b2 = synthetic.make_split("B2D", 2, 5, 64, seed=1)
    assert b2["pde_5-64"].shape == (2, 5, 64, 64)
    assert b2["x"].shape == b2["y"].shape == (2, 64)
    again = synthetic.make_split("B2D", 2, 5, 64, seed=1)
    np.testing.assert_array_equal(b2["pde_5-64"], again["pde_5-64"])


def test_make_split_has_the_file_schema():
    split = synthetic.make_split("KS", 2, 16, 32, seed=1, t_end=1.0,
                                 burn_in=0.2)
    assert split["t"].shape == (2, 16) and split["pde_16-32"].shape == (2, 16, 32)
    with pytest.raises(ValueError):
        synthetic.make_split("Burgers", 1, 16, 32)


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    pytest.importorskip("h5py")
    path = tmp_path_factory.mktemp("data") / "small.h5"
    return jax_synthetic.generate_1d_file(
        str(path), n_train=5, n_valid=3, n_test=2, nt=NT, nx=NX, seed=4)


def _assert_sample_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k == "lr_frames":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode,sampling,eval_support", [
    ("train", "uniform", "lr"), ("train", "boundary", "lr"),
    ("valid", "uniform", "lr"), ("test", "uniform", "full")])
def test_dataset_samples_equal_magnet_tpu(h5_file, mode, sampling,
                                          eval_support):
    from magnet_tpu.data.datasets import DatasetImplicit1D as JaxDataset

    kw = dict(nt=NT, nx=NX, sampling=sampling, samples=16,
              eval_support=eval_support)
    got_ds = DatasetImplicit1D(h5_file, mode, **kw)
    want_ds = JaxDataset(h5_file, mode, load_all=True, **kw)
    assert len(got_ds) == len(want_ds)
    for epoch_seed in (0, 12345):
        got_ds.set_epoch(epoch_seed)
        want_ds.set_epoch(epoch_seed)
        for i in range(len(want_ds)):
            _assert_sample_equal(got_ds[i], want_ds[i])
    if mode == "train":
        assert got_ds[0]["coords"].shape == (16, 1)
    else:
        L = NX if eval_support == "full" else NX // 2
        assert got_ds[0]["lr_frames"].shape == (NT, 1, L)
        assert got_ds[0]["coords"].shape == (NX, 1)


def _assert_items_equal(got_ds, want_ds):
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want) == {"u", "x", "t"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_graph_1d_items_equal_magnet_tpu(h5_file, mode):
    from magnet_tpu.data.datasets import DatasetGraph1D as JaxDataset

    want_ds = JaxDataset(h5_file, mode, nt=NT, nx=NX, load_all=True)
    _assert_items_equal(DatasetGraph1D(h5_file, mode, nt=NT, nx=NX), want_ds)
    in_memory = DatasetGraph1D(read_h5_split(h5_file, mode), mode, nt=NT, nx=NX)
    _assert_items_equal(in_memory, want_ds)
    assert in_memory[0]["u"].shape == (NX, NT)
    assert in_memory[0]["x"].shape == (NX, 1)


@pytest.mark.parametrize("regular", [True, False])
def test_graph_2d_items_equal_magnet_tpu(tmp_path, regular):
    pytest.importorskip("h5py")
    from magnet_tpu.data.datasets import DatasetGraph2D as JaxDataset

    res, n_nodes = 8, 20
    path = jax_synthetic.generate_2d_file(
        str(tmp_path / "b.h5"), n_train=2, n_valid=1, n_test=2, nt=6, res=res,
        seed=3, irregular=not regular, n_nodes=None if regular else n_nodes)
    key_res = res if regular else n_nodes
    for mode in ("train", "test"):
        want_ds = JaxDataset(path, mode, nt=6, res=key_res, regular=regular,
                             load_all=True)
        _assert_items_equal(
            DatasetGraph2D(path, mode, nt=6, res=key_res, regular=regular),
            want_ds)
        in_memory = DatasetGraph2D(read_h5_split(path, mode), mode, nt=6,
                                   res=key_res, regular=regular)
        _assert_items_equal(in_memory, want_ds)
        n = res * res if regular else n_nodes
        assert in_memory[0]["u"].shape == (n, 6)
        assert in_memory[0]["x"].shape == (n, 2)


def test_graph_datamodules_from_a_seed():
    """``synthetic_ce`` and ``synthetic_burgers_2d`` make the three splits;
    the 2D val split is the group ``test``, the 1D one ``valid``."""
    ce = dict(kind="h5_graph_1d", source="synthetic_ce", eq="E1", n_steps=400,
              n_train=3, n_val=2, n_test=1, batch_size=2, data_seed=1)
    b2 = dict(kind="h5_graph_2d", source="synthetic_burgers_2d", n_train=2,
              n_val=1, n_test=1, batch_size=2, data_seed=1)
    for split in ("train", "val", "test"):
        ce.update({f"nt_{split}": 10, f"nx_{split}": 16})
        b2.update({f"nt_{split}": 5, f"res_{split}": 64})
    loaders = build_loaders(ce, seed=0)
    assert [len(loaders[k]) for k in ("train", "val", "test")] == [1, 1, 1]
    assert loaders["val"].dataset.mode == "valid"
    loaders["train"].set_epoch(0)
    batch = next(iter(loaders["train"]))
    assert batch["u"].shape == (2, 16, 10) and batch["x"].shape == (2, 16, 1)
    loaders2 = build_loaders(b2, seed=0)
    assert loaders2["val"].dataset.mode == "test"
    loaders2["train"].set_epoch(0)
    batch2 = next(iter(loaders2["train"]))
    assert batch2["u"].shape == (2, 64 * 64, 5)
    assert batch2["x"].shape == (2, 64 * 64, 2)
    with pytest.raises(ValueError, match="source"):
        build_loaders(dict(ce, source="synthetic_ks"))


def test_dataset_rejects_a_wrong_key_and_mode(h5_file):
    with pytest.raises(KeyError, match="pde_99-64"):
        DatasetImplicit1D(h5_file, "train", nt=99, nx=NX)
    with pytest.raises(ValueError):
        DatasetImplicit1D(h5_file, "val", nt=NT, nx=NX)


class _Counting:
    """A dataset whose samples name their index and the epoch seed."""

    def __init__(self, n):
        self.n, self.seed = n, None

    def set_epoch(self, seed):
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "seed": np.int64(self.seed)}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_and_drop_last_equal_magnet_tpu(shuffle, drop_last):
    got_l = DataLoader(_Counting(11), 4, shuffle=shuffle, seed=5,
                       drop_last=drop_last)
    want_l = JaxDataLoader(_Counting(11), 4, shuffle=shuffle, seed=5,
                           prefetch=0, drop_last=drop_last)
    assert len(got_l) == len(want_l) == (2 if drop_last else 3)
    for epoch in (0, 3):
        got_l.set_epoch(epoch)
        want_l.set_epoch(epoch)
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) == len(got_l)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["i"], w["i"])
            np.testing.assert_array_equal(g["seed"], w["seed"])
        assert got[0]["seed"][0] == 5 * 100003 + epoch


def test_build_loaders_from_files_and_from_a_seed(h5_file):
    cfg = dict(kind="h5_implicit_1d", train_path=h5_file, val_path=h5_file,
               test_path=h5_file, nt_train=NT, nx_train=NX, nt_val=NT,
               nx_val=NX, nt_test=NT, nx_test=NX, samples=16, batch_size=2)
    loaders = build_loaders(cfg, seed=1)
    # 5 / 3 / 2 trajectories at batch 2; every split drops its partial batch
    assert [len(loaders[k]) for k in ("train", "val", "test")] == [2, 1, 1]
    assert loaders["val"].dataset.mode == "valid"  # the 1D val split
    loaders["train"].set_epoch(0)
    batch = next(iter(loaders["train"]))
    assert batch["hr_points"].shape == (2, NT, 16, 1)
    syn = dict(cfg, source="synthetic_ks", n_train=3, n_val=2, n_test=1,
               burn_in=0.2, data_seed=2)
    a, b = build_loaders(syn, seed=1), build_loaders(syn, seed=1)
    assert len(a["train"]) == 1 and len(a["test"]) == 1
    np.testing.assert_array_equal(a["val"].dataset.data[f"pde_{NT}-{NX}"],
                                  b["val"].dataset.data[f"pde_{NT}-{NX}"])
    with pytest.raises(ValueError):
        build_loaders(dict(cfg, kind="h5_2d"))
