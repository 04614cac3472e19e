"""Model and data defaults as Python data.

``MAGNET_CNN`` copies ``magnet_tpu/config/defaults/model/magnet_cnn.yaml``;
``HEAT_TEST`` is the test split of
``magnet_tpu/config/defaults/datamodule/h5_datamodule_implicit.yaml``
(Heat, ``nt_test``/``nx_test``).
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

HEAT_TEST = {"nt": 256, "nx": 256}


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
