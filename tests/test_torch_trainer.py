"""The port's training engine on the CPU at a small size: early stopping,
atomic best/last checkpoints with their sidecars, resume (2 + 2 epochs
equal 4), the weights-only ``best``, the final ``last``, the saved config
of ``run.main`` and ``eval``'s ``ckpt=``.

Resume tolerance: the same arithmetic on the same machine, but Adam's
moments pass through a file as f32 like the weights, so rtol 1e-6.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu_torch import eval as port_eval  # noqa: E402
from magnet_tpu_torch import run as port_run  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicit1D  # noqa: E402
from magnet_tpu_torch.data.loader import DataLoader  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from magnet_tpu_torch.train.trainer import EarlyStopping, Trainer  # noqa: E402

HP = dict(time_slice=16, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, res_layers=1,
          kernel_size=3, res_scale=1, radius=0.08)


def _loaders(seed=0):
    train = DatasetImplicit1D(make_split("Heat", 5, 48, 64, seed=1), "train",
                              nt=48, nx=64, samples=16)
    val = DatasetImplicit1D(make_split("Heat", 3, 48, 64, seed=2), "valid",
                            nt=48, nx=64)
    return (DataLoader(train, 2, shuffle=True, seed=seed),
            DataLoader(val, 2, shuffle=True, seed=seed + 1, drop_last=False))


def _trainer(workdir, max_epochs, **kw):
    model = create_model("magnet_cnn", HP, device="cpu", seed=0)
    return Trainer(model, max_epochs=max_epochs, lr=1e-3, weight_decay=1e-7,
                   factor=0.3, step_size=1, workdir=str(workdir),
                   device="cpu", **kw)


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_early_stopping_stops_at_patience():
    es = EarlyStopping(patience=3)
    assert [es.update(v) for v in (1.0, 0.5, 0.6, 0.5, 0.7)] == \
        [False, False, False, False, True]
    es = EarlyStopping(patience=2, min_delta=0.1)
    assert [es.update(v) for v in (1.0, 0.95, 0.95)] == [False, False, True]


def test_fit_stops_early_and_logs_rows(tmp_path):
    tr = _trainer(tmp_path, max_epochs=6, patience=1)
    tr.early.best = -1.0  # nothing improves on this: stop after one epoch
    train, val = _loaders()
    tr.fit(train, val)
    rows = _rows(tmp_path)
    assert len(rows) == 1 and rows[0]["epoch"] == 0
    assert set(rows[0]) == {"epoch", "time", "steps_per_s", "train_loss",
                            "train_mae_loss", "train_interp_loss", "val_loss",
                            "val_mae_loss"}
    assert all(np.isfinite(v) for v in rows[0].values())


def test_checkpoints_are_atomic_with_sidecars(tmp_path):
    tr = _trainer(tmp_path, max_epochs=2)
    train, val = _loaders()
    tr.fit(train, val)
    ckdir = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckdir)) == ["best.pt", "best.pt.json", "last.pt",
                                         "last.pt.json"]  # no .tmp left
    state, meta = load_checkpoint(str(ckdir / "last.pt"),
                                  require=("model", "optimizer"))
    assert set(state) == {"model", "optimizer", "step"}
    assert state["step"] == 2 * len(train) and meta["epoch"] == 1
    assert set(meta) == {"epoch", "val_mae_loss"}
    _, best_meta = load_checkpoint(str(ckdir / "best.pt"))
    assert best_meta["val_mae_loss"] == tr.ckpt.best == \
        min(r["val_mae_loss"] for r in _rows(tmp_path))
    # a truncated sidecar does not poison the checkpoint
    (ckdir / "last.pt.json").write_text('{"epoch": 1, "val_')
    _, meta = load_checkpoint(str(ckdir / "last.pt"))
    assert meta == {}


def test_resume_two_plus_two_equals_four(tmp_path):
    full = _trainer(tmp_path / "full", max_epochs=4)
    full.fit(*_loaders())
    first = _trainer(tmp_path / "split", max_epochs=2)
    first.fit(*_loaders())
    second = _trainer(tmp_path / "split", max_epochs=4)
    second.fit(*_loaders(), resume=str(tmp_path / "split" / "checkpoints"
                                       / "last.pt"))
    assert second.optimizer.step_count == full.optimizer.step_count == 8
    for (k, a), (_, b) in zip(second.model.state_dict().items(),
                              full.model.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    rows_a, rows_b = _rows(tmp_path / "split"), _rows(tmp_path / "full")
    assert [r["epoch"] for r in rows_a] == [0, 1, 2, 3]
    for ra, rb in zip(rows_a, rows_b):
        for k in ra:
            if k not in ("time", "steps_per_s"):
                np.testing.assert_allclose(ra[k], rb[k], rtol=1e-6, err_msg=k)


def test_weights_only_best_refuses_to_resume(tmp_path):
    tr = _trainer(tmp_path, max_epochs=1, best_weights_only=True)
    tr.fit(*_loaders())
    best = str(tmp_path / "checkpoints" / "best.pt")
    state, _ = load_checkpoint(best, require=("model",))
    assert set(state) == {"model"}
    again = _trainer(tmp_path, max_epochs=2)
    with pytest.raises(ValueError, match="best_weights_only.*last.pt"):
        again.fit(*_loaders(), resume=best)


def test_last_every_and_final_last(tmp_path):
    """With last_every=2 over 3 epochs ``last`` is written at epoch 1 and,
    on exit, at epoch 2; best improving on a due epoch is copied to last."""
    mgr = CheckpointManager(str(tmp_path / "m"), last_every=2)
    s = {"model": {"w": torch.ones(2)}, "optimizer": {}, "step": 0}
    assert mgr.update(s, 0, {"val_mae_loss": 1.0}) is True
    assert not os.path.exists(mgr.last_path)
    assert mgr.update(s, 1, {"val_mae_loss": 0.5}) is True
    assert load_checkpoint(mgr.last_path)[1] == {"epoch": 1,
                                                 "val_mae_loss": 0.5}
    assert mgr.update(s, 2, {"val_mae_loss": 0.7}) is False
    assert mgr.last_epoch == 1
    mgr.save_last(s, 2, {"val_mae_loss": 0.7})
    assert load_checkpoint(mgr.last_path)[1]["epoch"] == 2
    assert load_checkpoint(mgr.best_path)[1]["epoch"] == 1


def test_save_checkpoint_replaces_whole_files(tmp_path):
    path = str(tmp_path / "c" / "x.pt")
    save_checkpoint(path, {"model": {"w": torch.zeros(3)}}, {"epoch": 0})
    save_checkpoint(path, {"model": {"w": torch.ones(3)}}, {"epoch": 1})
    state, meta = load_checkpoint(path)
    assert torch.equal(state["model"]["w"], torch.ones(3)) and meta["epoch"] == 1
    assert sorted(os.listdir(tmp_path / "c")) == ["x.pt", "x.pt.json"]


def test_run_main_trains_and_eval_loads_the_checkpoint(tmp_path, capsys):
    overrides = [f"model.params.{k}={v}" for k, v in HP.items()]
    trainer = port_run.main(overrides + [
        "model=magnet_cnn", "datamodule.source=synthetic_ks",
        "datamodule.n_train=4", "datamodule.n_val=2", "datamodule.n_test=2",
        "datamodule.burn_in=0.5", "datamodule.nt_train=48",
        "datamodule.nt_val=48", "datamodule.nx_train=64",
        "datamodule.nx_val=64", "datamodule.batch_size=2",
        "datamodule.samples=16", "trainer.max_epochs=1", "device=cpu",
        "seed=3", "name=t", f"workdir={tmp_path}/${{name}}",
        "callbacks.early_stopping.patience=5"])
    assert trainer.early.patience == 5
    with open(os.path.join(trainer.workdir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["model"]["latent_dim"] == 8 and cfg["seed"] == 3
    assert cfg["datamodule"]["source"] == "synthetic_ks"
    assert os.path.dirname(trainer.workdir) == str(tmp_path / "t")
    assert "best checkpoint at" in capsys.readouterr().out
    # eval with ckpt= differs from eval of the fresh initialisation
    hp_args = [f"{k}={v}" for k, v in HP.items()]
    common = hp_args + ["datamodule.source=synthetic_ks", "n_traj=2",
                        "batch_size=2", "device=cpu", "seed=3"]
    fresh = port_eval.main(common)
    loaded = port_eval.main(common + [f"ckpt={trainer.ckpt.best_path}"])
    assert np.isfinite(loaded["test_nrmse"])
    assert loaded["test_mae_loss"] != fresh["test_mae_loss"]
