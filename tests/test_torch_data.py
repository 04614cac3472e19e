"""The port's data path against magnet_tpu's: the KS solver copy, the
implicit-1D dataset on one HDF5 file read by both packages, and the
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
from magnet_tpu_torch.data.datasets import DatasetImplicit1D  # noqa: E402
from magnet_tpu_torch.data.loader import DataLoader  # noqa: E402

NT, NX = 32, 64


def test_solve_ks_1d_copy_equals_magnet_tpu():
    kw = dict(nx_fine=64, nt_out=16, nx_out=32, t_end=1.0, burn_in=0.5)
    got = synthetic.solve_ks_1d(np.random.default_rng(7), **kw)
    want = jax_synthetic.solve_ks_1d(np.random.default_rng(7), **kw)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_make_split_has_the_file_schema():
    split = synthetic.make_split("KS", 2, 16, 32, seed=1, t_end=1.0,
                                 burn_in=0.2)
    assert split["t"].shape == (2, 16) and split["pde_16-32"].shape == (2, 16, 32)
    with pytest.raises(ValueError):
        synthetic.make_split("E1", 1, 16, 32)


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
    assert [len(loaders[k]) for k in ("train", "val", "test")] == [2, 2, 1]
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
