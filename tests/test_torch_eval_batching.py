"""The port's val and test loaders batch as magnet_tpu's do: on one HDF5
file whose splits are not a multiple of the batch size (5 trajectories at
batch 2), ``build_loaders`` of both packages gives the same number of
batches per split, the same trajectory indices per batch and the same
batches, for one epoch seed.  Both drop the trailing partial batch.

Arrays are compared exactly except ``lr_frames`` (the linear resize is the
same formula in torch and in jnp: rtol 1e-6, atol 1e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from magnet_tpu.data.datamodule import (  # noqa: E402
    build_loaders as jax_build_loaders,
)
from magnet_tpu_torch.data.datamodule import build_loaders  # noqa: E402

NT, NX, N_TRAJ, BATCH = 32, 64, 5, 2


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    pytest.importorskip("h5py")
    path = tmp_path_factory.mktemp("data") / "odd.h5"
    return jax_synthetic.generate_1d_file(
        str(path), n_train=N_TRAJ, n_valid=N_TRAJ, n_test=N_TRAJ, nt=NT,
        nx=NX, seed=7)


def _cfg(kind, path):
    return dict(kind=kind, train_path=path, val_path=path, test_path=path,
                nt_train=NT, nx_train=NX, nt_val=NT, nx_val=NX, nt_test=NT,
                nx_test=NX, samples=16, batch_size=BATCH)


@pytest.mark.parametrize("shuffle_eval", [True, False])
@pytest.mark.parametrize("kind", ["h5_implicit_1d", "h5_graph_1d"])
def test_eval_splits_batch_as_magnet_tpu(h5_file, kind, shuffle_eval):
    cfg = _cfg(kind, h5_file)
    got = build_loaders(cfg, seed=3, shuffle_eval=shuffle_eval)
    want = jax_build_loaders({**cfg, "num_workers": 0}, seed=3,
                             shuffle_eval=shuffle_eval)
    for split in ("val", "test"):
        got_l, want_l = got[split], want[split]
        assert len(got_l) == len(want_l) == N_TRAJ // BATCH, split
        got_l.set_epoch(1)
        want_l.set_epoch(1)
        got_idx, want_idx = got_l._indices(), want_l._indices()
        got_b, want_b = list(got_l), list(want_l)
        assert len(got_b) == len(want_b) == N_TRAJ // BATCH
        for b, (g, w) in enumerate(zip(got_b, want_b)):
            rows = slice(b * BATCH, (b + 1) * BATCH)
            np.testing.assert_array_equal(got_idx[rows], want_idx[rows])
            assert set(g) == set(w)
            for k in w:
                assert np.asarray(g[k]).shape[0] == BATCH, (split, k)
                if k == "lr_frames":
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                               atol=1e-6)
                else:
                    np.testing.assert_array_equal(g[k], w[k],
                                                  err_msg=f"{split} {k}")
        # the trajectory left out is the same one in both
        left = got_idx[(N_TRAJ // BATCH) * BATCH:]
        np.testing.assert_array_equal(
            left, want_idx[(N_TRAJ // BATCH) * BATCH:])
        assert left.size == N_TRAJ % BATCH
