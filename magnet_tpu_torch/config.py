"""Model, data, trainer and callback defaults as Python data, copied from
``magnet_tpu/config/defaults``: ``MAGNET_CNN`` is ``model/magnet_cnn.yaml``,
``DATAMODULE_IMPLICIT`` is ``datamodule/h5_datamodule_implicit.yaml`` (plus
the keys of the ``synthetic_ks`` source, which stands in for the files),
``TRAINER`` is ``trainer/default.yaml`` without the keys of what is not
ported (``devices``, ``steps_per_call``, ``precision``, ``log_every``),
``CALLBACKS`` the early-stopping patience of ``callbacks/default.yaml``.
``HEAT_TEST`` is the datamodule's test split (Heat).
"""
from __future__ import annotations

MAGNET_CNN = {
    "time_slice": 16,
    "latent_dim": 32,
    "num_message_passing_steps": 10,
    "mlp_layers": 4,
    "mlp_hidden": 64,
    "radius": 0.08,
    "scales": 1,
    "n_chan": 128,
    "kernel_size": 3,
    "res_scale": 1,
    "res_layers": 4,
    "teacher_forcing": True,
    "interpolation": "area",
    "factor": 0.3,
    "step_size": 40,
    "loss": "l1",
    "lr": 0.001,
    "weight_decay": 0.0000001,
}

DATAMODULE_IMPLICIT = {
    "kind": "h5_implicit_1d",
    "name": "h5_datamodule_implicit",
    "source": "h5",          # or synthetic_ks: made from data_seed, no file
    "train_path": "data/KS_train.h5",
    "val_path": "data/KS_valid.h5",
    "test_path": "data/Heat_test.h5",
    "nt_train": 128,
    "nx_train": 256,
    "nt_val": 128,
    "nx_val": 256,
    "nt_test": 256,
    "nx_test": 256,
    "sampling": "uniform",
    "samples": 32,
    "batch_size": 32,
    "eval_support": "lr",
    # synthetic_ks only: trajectories per split, their seed, KS burn-in
    "n_train": 64,
    "n_val": 32,
    "n_test": 16,
    "data_seed": 0,
    "burn_in": 40.0,
}

HEAT_TEST = {"nt": DATAMODULE_IMPLICIT["nt_test"],
             "nx": DATAMODULE_IMPLICIT["nx_test"]}

TRAINER = {
    "max_epochs": 100,
    "check_val_every": 1,
    "skip_nonfinite": False,
    "grad_clip": 0.0,
    "best_weights_only": False,
    "save_last_every": 1,
}

CALLBACKS = {"patience": 35}

RUN = {"seed": 42, "name": "run", "ckpt_path": "", "workdir": "runs/${name}",
       "device": "cuda"}


def parse_overrides(argv: list[str], defaults: dict) -> dict:
    """``key=value`` strings over ``defaults``; each value takes the type
    of the default it replaces (bool from true/false)."""
    out = dict(defaults)
    for arg in argv:
        key, sep, val = arg.partition("=")
        if not sep or key not in defaults:
            raise ValueError(f"unknown override {arg!r} (keys: {sorted(defaults)})")
        old = defaults[key]
        if isinstance(old, bool):
            if val.lower() not in ("true", "false"):
                raise ValueError(f"{key} takes true or false, got {val!r}")
            out[key] = val.lower() == "true"
        else:
            out[key] = type(old)(val)
    return out


def compose(argv: list[str]) -> dict:
    """The run's config from ``key=value`` overrides: ``model.params.<k>``
    (or ``model.<k>``), ``datamodule.<k>``, ``trainer.<k>``,
    ``callbacks.early_stopping.patience`` and the top-level ``seed``,
    ``name``, ``ckpt_path``, ``workdir``, ``device``.  ``model=magnet_cnn``
    and ``datamodule=h5_datamodule_implicit`` are accepted as the one
    choice there is."""
    sections = {"model": MAGNET_CNN, "datamodule": DATAMODULE_IMPLICIT,
                "trainer": TRAINER, "callbacks": CALLBACKS}
    names = {"model": "magnet_cnn", "datamodule": DATAMODULE_IMPLICIT["name"]}
    split: dict[str, list[str]] = {k: [] for k in (*sections, "run")}
    for arg in argv:
        key, _, val = arg.partition("=")
        if key in names:
            if val != names[key]:
                raise ValueError(f"{key} must be {names[key]!r}, got {val!r}")
            continue
        head, _, rest = key.partition(".")
        if head in sections and rest:
            for prefix in ("params.", "early_stopping."):
                rest = rest.removeprefix(prefix)
            split[head].append(f"{rest}={val}")
        else:
            split["run"].append(arg)
    cfg = parse_overrides(split["run"], RUN)
    for head, defaults in sections.items():
        cfg[head] = parse_overrides(split[head], defaults)
    return cfg
