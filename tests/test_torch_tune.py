"""The port's sweep (``magnet_tpu_torch/tune.py``) against the repo's
``tune.py``: its TPE sampler gives the repo's suggestions exactly for the
same space, seed and observations; the three properties of
``tests/test_tune.py`` hold for the copy; a two-trial sweep runs through
the port's ``run.main`` on the CPU; on the card a space over a kernel width
outside the compiled builds raises before the first trial.  Tolerance:
equal (the same numpy calls in the same order), the properties' own
bounds.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tune as repo_tune  # noqa: E402

from magnet_tpu_torch import tune  # noqa: E402
from magnet_tpu_torch.config import compose  # noqa: E402

SPACE = ["lr=1e-5:1e-1:log", "width=16:512:int", "drop=0:0.5"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its ops are small, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(params):
    # the bowl of tests/test_tune.py: optimum at lr=1e-3, width=128
    lr, width = params["lr"], params["width"]
    return (np.log10(lr) + 3.0) ** 2 + ((width - 128) / 64.0) ** 2


def test_tpe_suggestions_equal_the_repos():
    """20 observations, then 8 more suggestions: every one equal, type
    included; the first 5 are the random start-up draws, the rest TPE's."""
    ours = tune.TPESampler(tune.parse_space(SPACE), seed=3)
    theirs = repo_tune.TPESampler(repo_tune.parse_space(SPACE), seed=3)
    assert tune.parse_space(SPACE) == repo_tune.parse_space(SPACE)
    for i in range(28):
        got, want = ours.suggest(), theirs.suggest()
        assert got == want, i
        assert [type(v) for v in got.values()] == [type(v) for v in
                                                   want.values()]
        if i < 20:
            y = _toy(got) + got["drop"]
            ours.observe(y)
            theirs.observe(y)


class _RandomSampler(tune.TPESampler):
    def __init__(self, space, seed):
        super().__init__(space, seed, n_startup=10**9)  # never adapts


def _run(sampler_cls, seed, space, n_trials=40):
    s = sampler_cls(space, seed=seed)
    best = np.inf
    for _ in range(n_trials):
        p = s.suggest()
        y = _toy(p)
        s.observe(y)
        best = min(best, y)
    return best


@pytest.mark.parametrize("prop", ["types_and_bounds", "beats_random",
                                  "concentrates"])
def test_repo_properties_hold_for_the_copy(prop):
    """``tests/test_tune.py``'s three properties, on the port's sampler."""
    space = tune.parse_space(["lr=1e-5:1e-1:log", "width=16:512:int"])
    if prop == "types_and_bounds":
        s = tune.TPESampler(space, seed=0)
        for _ in range(12):
            p = s.suggest()
            assert 1e-5 <= p["lr"] <= 1e-1
            assert isinstance(p["width"], int) and 16 <= p["width"] <= 512
            s.observe(_toy(p))
    elif prop == "beats_random":
        tpe = np.mean([_run(tune.TPESampler, s, space) for s in range(5)])
        rnd = np.mean([_run(_RandomSampler, s, space) for s in range(5)])
        assert tpe < rnd, (tpe, rnd)
        assert tpe < 0.25, tpe
    else:
        s = tune.TPESampler(space, seed=1)
        for _ in range(30):
            p = s.suggest()
            s.observe(_toy(p))
        late = [s.suggest() for _ in range(8)]
        frac = np.mean([abs(np.log10(p["lr"]) + 3.0) < 1.0 for p in late])
        assert frac >= 0.5, late


def test_two_trial_sweep_through_run_main(tmp_path, capsys):
    """Two trials of a tiny MAgNet[CNN] 1D on the seeded KS source, one
    epoch each: two finite trial lines, the best their minimum, a work
    directory each; the sweep keys come from the config."""
    argv = ["model=magnet_cnn", "device=cpu", "seed=5",
            "datamodule.source=synthetic_ks", "datamodule.n_train=2",
            "datamodule.n_val=2", "datamodule.n_test=1",
            "datamodule.nt_train=48", "datamodule.nx_train=64",
            "datamodule.nt_val=48", "datamodule.nx_val=64",
            "datamodule.samples=16", "datamodule.batch_size=2",
            "datamodule.burn_in=1.0", "model.params.latent_dim=8",
            "model.params.num_message_passing_steps=1",
            "model.params.mlp_layers=1", "model.params.mlp_hidden=8",
            "model.params.n_chan=8", "model.params.res_layers=1",
            "trainer.max_epochs=1", "sweep.n_trials=2", "name=sw",
            f"workdir={tmp_path}/${{name}}",
            "--space", "model.params.lr=1e-4:1e-2:log"]
    assert compose([])["sweep"] == {"n_trials": 15, "direction": "minimize",
                                    "metric": "val_mae_loss"}
    out = tune.main(argv)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines == [*out["trials"], out["best"]]
    vals = [t["val_mae_loss"] for t in out["trials"]]
    assert [t["trial"] for t in out["trials"]] == [0, 1]
    assert all(np.isfinite(vals))
    assert out["best"]["best_value"] == min(vals)
    assert all(1e-4 <= t["overrides"]["model.params.lr"] <= 1e-2
               for t in out["trials"])
    dirs = out["workdirs"]
    assert len(set(dirs)) == 2
    assert [Path(d).parent.name for d in dirs] == ["sw_trial0", "sw_trial1"]
    assert all((Path(d) / "metrics.jsonl").exists() for d in dirs)


def test_width_sweep_outside_the_builds_raises_on_the_card():
    """A range over a kernel width holds values that no build serves, and a
    single width outside the builds is refused: both before any trial, the
    builds named.  The CPU takes any width."""
    cfg = compose(["model=magnet_cnn"])
    assert tune.kernel_builds("magnet_cnn") == {(32, 64), (128, 128)}
    assert tune.kernel_builds("mpnn_2d") == {(128,)}
    tune.check_widths(cfg, tune.parse_space(["model.params.lr=1e-4:1e-2"]))
    tune.check_widths(cfg, tune.parse_space(
        ["model.params.latent_dim=128:128:int",
         "model.params.mlp_hidden=128:128:int"]))
    with pytest.raises(ValueError, match=r"\(32, 64\), \(128, 128\)"):
        tune.check_widths(cfg, tune.parse_space(
            ["model.params.mlp_hidden=32:128:int"]))
    with pytest.raises(ValueError, match="not \\(32, 96\\)"):
        tune.check_widths(cfg, tune.parse_space(
            ["model.params.mlp_hidden=96:96:int"]))
    with pytest.raises(ValueError, match=r"\[\(128,\)\]"):
        tune.check_widths(compose(["model=mpnn"]), tune.parse_space(
            ["model.params.hidden_features=64:256:int"]))
    tune.check_widths(compose(["model=magnet_cnn", "device=cpu"]),
                      tune.parse_space(["model.params.mlp_hidden=8:96:int"]))
    with pytest.raises(ValueError, match="compiled for"):
        tune.main(["model=magnet_cnn", "sweep.n_trials=1", "--space",
                   "model.params.mlp_hidden=16:32:int"])
