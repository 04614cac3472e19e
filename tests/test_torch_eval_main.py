"""``magnet_tpu_torch.eval.main`` as the repo's ``eval.py``: it evaluates in
f32 (both TF32 flags off, whatever they were before), and with
``datamodule.source=h5`` it scores the test split of the file at
``datamodule.test_path``, in order, in the batches of
``magnet_tpu.data.datamodule.build_loaders(...)["test"]`` with
``shuffle_eval=False`` (5 trajectories at batch 2: the fifth is dropped by
both).

Batches are compared exactly except ``lr_frames`` (the linear resize is
the same formula in torch and in jnp: rtol 1e-6, atol 1e-6); the metrics
of ``main`` and of ``evaluate`` on those batches with the same model are
the same computation and are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from magnet_tpu.data.datamodule import (  # noqa: E402
    build_loaders as jax_build_loaders,
)
from magnet_tpu_torch import eval as port_eval  # noqa: E402
from magnet_tpu_torch.config import (  # noqa: E402
    DATAMODULE_IMPLICIT,
    MAGNET_CNN_NO_INTERACTION,
)
from magnet_tpu_torch.data.datamodule import eval_batches  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402

NAME = "magnet_cnn_no_interaction"
HP = {"lstm_hidden": 8, "lstm_layers": 1, "n_chan": 4, "res_layers": 1,
      "mlp_hidden": 4}
NT, NX, N_TRAJ, BATCH, SEED = 48, 32, 5, 2, 3


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    pytest.importorskip("h5py")
    path = tmp_path_factory.mktemp("data") / "test_split.h5"
    return jax_synthetic.generate_1d_file(
        str(path), n_train=2, n_valid=2, n_test=N_TRAJ, nt=NT, nx=NX, seed=11)


def _args(path):
    return ([f"model={NAME}", "device=cpu", f"seed={SEED}",
             f"batch_size={BATCH}", f"datamodule.test_path={path}",
             f"datamodule.nt_test={NT}", f"datamodule.nx_test={NX}"]
            + [f"{k}={v}" for k, v in HP.items()])


def test_main_scores_the_test_file_in_the_batches_of_magnet_tpu(h5_file):
    dm = {**DATAMODULE_IMPLICIT, "batch_size": BATCH,
          **{f"{split}_path": h5_file for split in ("train", "val", "test")},
          **{f"{key}_{split}": size for split in ("train", "val", "test")
             for key, size in (("nt", NT), ("nx", NX))}}
    got = eval_batches(NAME, n_traj=16, batch_size=BATCH, seed=SEED,
                       datamodule=dm)
    want = list(jax_build_loaders({**dm, "num_workers": 0}, seed=SEED,
                                  shuffle_eval=False)["test"])
    assert len(got) == len(want) == N_TRAJ // BATCH
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "lr_frames":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)

    out = port_eval.main(_args(h5_file))
    model = create_model(NAME, {**MAGNET_CNN_NO_INTERACTION, **HP},
                         device="cpu", seed=SEED)
    assert out == port_eval.evaluate(model, want, "cpu")
    assert set(out) == {"test_loss", "test_mae_loss", "test_nrmse"}


def test_main_needs_the_file_where_the_source_is_h5(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_eval.main(_args(tmp_path / "missing.h5"))


@pytest.mark.parametrize("before", [True, False])
def test_main_turns_tf32_off(h5_file, before):
    torch.backends.cuda.matmul.allow_tf32 = before
    torch.backends.cudnn.allow_tf32 = before
    port_eval.main(_args(h5_file))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
