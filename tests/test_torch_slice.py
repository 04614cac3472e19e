"""The port's whole eval slice against magnet_tpu at a small size: the
no-teacher-forcing ``predict``, ``loss(train=False)`` and the eval metrics
(incl. nRMSE); the weight bridge; and the port's import hygiene and device
default.

Tolerance rtol 1e-3, atol 1e-4: f32 on both sides, and each window's
output is the next window's input, so the per-module reordering error
(rtol 1e-4) is carried through the autoregressive rollout.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import nrmse as jax_nrmse  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.train.import_torch import import_magnet_cnn  # noqa: E402
from magnet_tpu_torch.data.heat import heat_batches  # noqa: E402
from magnet_tpu_torch.eval import evaluate, to_device  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4
# B=2, L=32, N=64, nt=48 (2 windows)
HP = dict(time_slice=16, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, res_layers=1,
          kernel_size=3, res_scale=1, radius=0.08)


@pytest.fixture(scope="module")
def pair():
    batch = heat_batches(2, 2, nt=48, nx=64, seed=11)[0]
    jm = jax_create_model("magnet_cnn", HP)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jb, jg)
    params = jax.tree.map(np.asarray, params)
    tm = create_model("magnet_cnn", HP, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP))
    return jm, params, jb, jg, tm, batch


def test_predict_matches_jax(pair):
    jm, params, jb, jg, tm, batch = pair
    want_hr, want_lr = jax.jit(jm.predict)(params, jb, jg)
    tb = to_device(batch, "cpu")
    got_hr, got_lr = tm.predict(tb, tm.build_graph(tb))
    assert got_hr.shape == (2, 32, 64, 1) and got_lr.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got_hr.numpy(), np.asarray(want_hr), RTOL, ATOL)
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(want_lr), RTOL, ATOL)


def test_eval_loss_and_nrmse_match_jax(pair):
    jm, params, jb, jg, tm, batch = pair
    loss, m = jax.jit(lambda p: jm.loss(p, jb, jg, train=False))(params)
    hr, _ = jax.jit(jm.predict)(params, jb, jg)
    want_nrmse = float(jax_nrmse(hr, jm.rollout_target(jb, hr.shape[1])))
    tb = to_device(batch, "cpu")
    got_loss, got_m = tm.loss(tb, tm.build_graph(tb), train=False)
    np.testing.assert_allclose(float(got_loss), float(loss), RTOL, ATOL)
    np.testing.assert_allclose(float(got_m["mae_loss"]), float(m["mae_loss"]),
                               RTOL, ATOL)
    out = evaluate(tm, [batch], "cpu")
    np.testing.assert_allclose(out["test_loss"], float(loss), RTOL, ATOL)
    np.testing.assert_allclose(out["test_mae_loss"], float(m["mae_loss"]),
                               RTOL, ATOL)
    np.testing.assert_allclose(out["test_nrmse"], want_nrmse, RTOL, ATOL)


def test_import_magnet_cnn_inverts_state_dict_from_jax(pair):
    _, params, _, _, tm, _ = pair
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = import_magnet_cnn(sd, HP)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_port_imports_no_jax_and_nothing_of_magnet_tpu():
    code = (
        "import sys, pkgutil, importlib, magnet_tpu_torch, chip_smoke\n"
        "import magnet_tpu_torch.eval, magnet_tpu_torch.run\n"
        "import magnet_tpu_torch.trace_train, magnet_tpu_torch.trace_eval\n"
        "import magnet_tpu_torch.models.mpnn, magnet_tpu_torch.ops.mpnn_edge\n"
        "import magnet_tpu_torch.models.fno, magnet_tpu_torch.nn.spectral\n"
        "import magnet_tpu_torch.models.magnet_gnn, magnet_tpu_torch.weights\n"
        "import magnet_tpu_torch.parallel.mesh, magnet_tpu_torch.parallel.launch\n"
        "import magnet_tpu_torch.parallel.graph_partition\n"
        "import magnet_tpu_torch.models.partitioned_mixin\n"
        "import magnet_tpu_torch.tune\n"
        "for m in pkgutil.walk_packages(magnet_tpu_torch.__path__, 'magnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'h5py', 'magnet_tpu', 'tune', 'run')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('magnet_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def test_evaluate_takes_a_predict_that_returns_a_tensor(pair):
    """``evaluate`` reads the first output of a tuple (magnet_cnn) and a
    bare tensor (the MPNN family) alike."""
    _, _, _, _, tm, batch = pair

    class TensorPredict:
        def __getattr__(self, name):
            return getattr(tm, name)

        def predict(self, b, graph):
            return tm.predict(b, graph)[0]

    assert evaluate(TensorPredict(), [batch], "cpu") == evaluate(
        tm, [batch], "cpu")


def test_compose_takes_the_model_and_its_datamodule():
    from magnet_tpu_torch.config import (
        DATAMODULE_GRAPH_2D, MAGNET_CNN, MPNN_2D, compose)

    cfg = compose(["trainer.max_epochs=3"])
    assert cfg["model_name"] == "magnet_cnn" and cfg["model"] == MAGNET_CNN
    assert cfg["datamodule"]["kind"] == "h5_implicit_1d"
    cfg = compose(["model=mpnn_2d", "model.params.hidden_layer=2",
                   "datamodule.source=synthetic_burgers_2d", "seed=3"])
    assert cfg["model_name"] == "mpnn_2d" and cfg["seed"] == 3
    assert cfg["model"] == {**MPNN_2D, "hidden_layer": 2}
    assert cfg["datamodule"] == {**DATAMODULE_GRAPH_2D,
                                 "source": "synthetic_burgers_2d"}
    cfg = compose(["model=mpnn", "datamodule=h5_datamodule_graph"])
    assert cfg["datamodule"]["kind"] == "h5_graph_1d"
    assert cfg["model"]["time_window"] == 16
    for bad in (["model=not_a_model"], ["datamodule=h5_datamodule_none"],
                ["model=mpnn", "model.params.latent_dim=8"]):
        with pytest.raises(ValueError):
            compose(bad)


def test_create_model_defaults_to_cuda():
    if torch.cuda.is_available():
        model = create_model("magnet_cnn", HP)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("magnet_cnn", HP)


def test_trainer_and_run_default_to_cuda():
    from magnet_tpu_torch import run as port_run
    from magnet_tpu_torch.train.trainer import Trainer

    model = create_model("magnet_cnn", HP, device="cpu")
    if torch.cuda.is_available():
        assert Trainer(model, workdir="runs/test_default").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_run.main(["trainer.max_epochs=1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_run.main(["model=mpnn_2d", "trainer.max_epochs=1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("mpnn_2d", {})
