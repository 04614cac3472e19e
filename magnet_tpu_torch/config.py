"""Model, data, trainer and callback defaults as Python data, copied from
``magnet_tpu/config/defaults``: ``MAGNET_CNN``, ``MAGNET_CNN_2D``, ``MPNN``,
``MPNN_2D``, ``MAGNET_GNN``, ``FNO_1D``, ``FNO_2D`` and
``MAGNET_CNN_NO_INTERACTION`` are ``model/{magnet_cnn,magnet_cnn_2d,mpnn,
mpnn_2d,magnet_gnn,fno_1d,fno_2d,magnet_cnn_no_interaction}.yaml`` (the
last one's ``use_lstm`` and ``interpolation`` are kept but not read, as in
the JAX model);
``DATAMODULE_IMPLICIT``, ``DATAMODULE_IMPLICIT_2D``, ``DATAMODULE_GRAPH``,
``DATAMODULE_GRAPH_2D``, ``DATAMODULE_IMPLICIT_GNN``,
``DATAMODULE_IMPLICIT_GNN_2D``, ``DATAMODULE_1D`` and ``DATAMODULE_2D`` are
``datamodule/h5_datamodule_{implicit,implicit_2d,graph,graph_2d,
implicit_gnn,implicit_gnn_2d}.yaml``, ``h5_datamodule.yaml`` and
``h5_datamodule_2d.yaml`` (each plus the keys of its synthetic source,
which stands in for the files; ``num_workers`` > 0 collates on a prefetch
thread, ``data.loader``), ``TRAINER`` is ``trainer/default.yaml``
(``steps_per_call``: captured CUDA graphs of training steps, ``precision``:
TF32 or not for cuBLAS and cuDNN, ``log_every``: read nowhere, as in the
JAX trainer), with the JAX ``run.py``'s ``graph_shards`` and
``graph_halo`` (``magnet_tpu_torch.run`` launches the mesh),
``CALLBACKS`` the early-stopping patience of ``callbacks/default.yaml``,
``SWEEP`` the root config's ``sweep`` keys.
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

MAGNET_CNN_2D = {**MAGNET_CNN, "radius": 0.1, "res_layers": 16}

MPNN = {
    "hidden_features": 128,
    "hidden_layer": 5,
    "time_window": 16,
    "teacher_forcing": False,
    "neighbors": 3,
    "factor": 0.3,
    "step_size": 50,
    "loss": "l1",
    "lr": 0.001,
    "weight_decay": 0.0,
}

MPNN_2D = {**MPNN, "time_window": 10, "neighbors": 4}

MAGNET_GNN = {
    "time_slice": 25,
    "latent_dim": 128,
    "num_message_passing_steps": 5,
    "mlp_layers": 4,
    "mlp_hidden": 128,
    "radius": 0.08,
    "n_chan": 128,
    "teacher_forcing": True,
    "codec_neighbors": 4,
    "noise": 0.0,
    "interpolation": "area",
    "factor": 0.3,
    "step_size": 50,
    "loss": "l1",
    "lr": 0.001,
    "weight_decay": 0.0,
}

FNO_1D = {
    "modes": 12,
    "width": 256,
    "num_layers": 5,
    "time_history": 25,
    "time_future": 25,
    "teacher_forcing": True,
    "factor": 0.3,
    "step_size": 50,
    "loss": "l1",
    "lr": 0.001,
    "weight_decay": 0.0,
}

FNO_2D = {
    "modes_1": 12,
    "modes_2": 12,
    "width": 256,
    "num_layers": 5,
    "time_history": 10,
    "time_future": 10,
    "teacher_forcing": True,
    "factor": 0.3,
    "step_size": 50,
    "loss": "l1",
    "lr": 0.001,
    "weight_decay": 0.0,
}

MAGNET_CNN_NO_INTERACTION = {
    "time_slice": 16,
    "use_lstm": True,
    "lstm_hidden": 256,
    "lstm_layers": 4,
    "mlp_layers": 1,
    "mlp_hidden": 32,
    "scales": 1,
    "n_chan": 128,
    "kernel_size": 3,
    "teacher_forcing": False,
    "res_scale": 1,
    "res_layers": 16,
    "interpolation": "area",
    "factor": 0.6,
    "step_size": 50,
    "loss": "l1",
    "lr": 0.0005,
    "weight_decay": 0.0001,
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
    "num_workers": 0,
    "eval_support": "lr",
    # synthetic_ks only: trajectories per split, their seed, KS burn-in
    "n_train": 64,
    "n_val": 32,
    "n_test": 16,
    "data_seed": 0,
    "burn_in": 40.0,
}

DATAMODULE_IMPLICIT_GNN = {
    **DATAMODULE_IMPLICIT,
    "kind": "h5_implicit_gnn_1d",
    "name": "h5_datamodule_implicit_gnn",
}

DATAMODULE_IMPLICIT_2D = {
    "kind": "h5_implicit_2d",
    "name": "h5_datamodule_implicit_2d",
    "source": "h5",          # or synthetic_burgers_2d: from data_seed
    "train_path": "data/B1/burgers_train_B1_64.h5",
    "val_path": "data/B1/burgers_test_B1_64.h5",
    "test_path": "data/B1/burgers_test_B1_64.h5",
    "nt_train": 50,
    "res_train": 64,
    "nt_val": 50,
    "res_val": 64,
    "nt_test": 50,
    "res_test": 64,
    "samples": 32,
    "batch_size": 32,
    "num_workers": 3,
    # synthetic_burgers_2d only: trajectories per split and their seed
    "n_train": 64,
    "n_val": 8,
    "n_test": 8,
    "data_seed": 0,
}

DATAMODULE_GRAPH = {
    "kind": "h5_graph_1d",
    "name": "h5_datamodule_graph",
    "source": "h5",          # or synthetic_ce: made from data_seed, no file
    "train_path": "data/CE_train_E3.h5",
    "val_path": "data/CE_valid_E3.h5",
    "test_path": "data/CE_test_E3.h5",
    "nt_train": 250,
    "nx_train": 50,
    "nt_val": 250,
    "nx_val": 50,
    "nt_test": 250,
    "nx_test": 50,
    "batch_size": 32,
    "num_workers": 0,
    # synthetic_ce only: trajectories per split, their seed, the combined
    # equation's preset and its solver's time steps
    "n_train": 64,
    "n_val": 32,
    "n_test": 32,
    "data_seed": 0,
    "eq": "E3",
    "n_steps": 4000,
}

DATAMODULE_GRAPH_2D = {
    "kind": "h5_graph_2d",
    "name": "h5_datamodule_graph_2d",
    "source": "h5",          # or synthetic_burgers_2d: from data_seed
    "train_path": "data/B1/burgers_train_B1_64.h5",
    "val_path": "data/B1/burgers_test_B1_64.h5",
    "test_path": "data/B1/burgers_test_B1_64.h5",
    "nt_train": 50,
    "res_train": 64,
    "nt_val": 50,
    "res_val": 64,
    "nt_test": 50,
    "res_test": 64,
    "train_regular": True,
    "val_regular": True,
    "test_regular": True,
    "batch_size": 4,
    "num_workers": 3,
    # synthetic_burgers_2d only: trajectories per split and their seed
    "n_train": 16,
    "n_val": 4,
    "n_test": 4,
    "data_seed": 0,
}

DATAMODULE_IMPLICIT_GNN_2D = {
    "kind": "h5_implicit_gnn_2d",
    "name": "h5_datamodule_implicit_gnn_2d",
    "source": "h5",          # or synthetic_burgers_2d: from data_seed
    "train_path": "data/B1/uniform/burgers_train_irregular_B1_512.h5",
    "val_path": "data/B1/burgers_test_B1_32.h5",
    "test_path": "data/B1/burgers_test_B1_32.h5",
    "nt_train": 50,
    "res_train": 64,
    "nt_val": 50,
    "res_val": 32,
    "nt_test": 50,
    "res_test": 32,
    "samples": 32,
    "train_regular": False,
    "val_regular": True,
    "test_regular": True,
    # an irregular split's key is pde_<nt>-<n_nodes_train>, else
    # pde_<nt>-<res_train> (the published 512-node script sets
    # res_train=512)
    "n_nodes_train": None,
    "batch_size": 32,
    "num_workers": 3,
    # synthetic_burgers_2d only: trajectories per split and their seed; an
    # irregular split's nodes are drawn from a 64 x 64 grid, uniform or
    # concentrated around a random point
    "n_train": 64,
    "n_val": 8,
    "n_test": 8,
    "data_seed": 0,
    "concentrated": False,
}

DATAMODULE_1D = {
    **DATAMODULE_GRAPH,
    "kind": "h5_1d",
    "name": "h5_datamodule",
}

DATAMODULE_2D = {
    "kind": "h5_2d",
    "name": "h5_datamodule_2d",
    "source": "h5",          # or synthetic_burgers_2d: from data_seed
    "train_path": "data/B1/burgers_train_B1_64.h5",
    "val_path": "data/B1/burgers_test_B1_64.h5",
    "test_path": "data/B1/burgers_test_B1_64.h5",
    "nt_train": 50,
    "res_train": 64,
    "nt_val": 50,
    "res_val": 64,
    "nt_test": 50,
    "res_test": 64,
    "batch_size": 32,
    "num_workers": 3,
    # synthetic_burgers_2d only: trajectories per split and their seed
    "n_train": 64,
    "n_val": 8,
    "n_test": 8,
    "data_seed": 0,
}

#: model name -> (its defaults, its datamodule's defaults)
MODELS = {
    "magnet_cnn": (MAGNET_CNN, DATAMODULE_IMPLICIT),
    "magnet_cnn_2d": (MAGNET_CNN_2D, DATAMODULE_IMPLICIT_2D),
    "mpnn": (MPNN, DATAMODULE_GRAPH),
    "mpnn_2d": (MPNN_2D, DATAMODULE_GRAPH_2D),
    "magnet_gnn": (MAGNET_GNN, DATAMODULE_IMPLICIT_GNN),
    "fno_1d": (FNO_1D, DATAMODULE_1D),
    "fno_2d": (FNO_2D, DATAMODULE_2D),
    "magnet_cnn_no_interaction": (MAGNET_CNN_NO_INTERACTION,
                                  DATAMODULE_IMPLICIT),
}
#: hp keys a model reads beyond its YAML, with their defaults (the JAX
#: ``run.py`` takes any dotted key, ``magnet_tpu/config/core.py``): the
#: GraphNet models' compute dtype ``graph_dtype`` (float32 or bf16,
#: ``models.common.parse_dtype``) and ``remat`` (each processor step
#: recomputed in the backward).  A run's model config holds such a key only
#: where it was given.
MODEL_EXTRAS = {name: {"graph_dtype": "float32", "remat": False}
                for name in ("magnet_cnn", "magnet_cnn_2d", "magnet_gnn")}
#: every datamodule ``datamodule=<name>`` reaches, the models' own and
#: MAgNet[GNN]'s 2D one
DATAMODULES = {d["name"]: d for d in (
    *(dm for _, dm in MODELS.values()), DATAMODULE_IMPLICIT_GNN_2D)}
#: the source that makes each datamodule's data from a seed
SYNTHETIC_SOURCE = {"h5_implicit_1d": "synthetic_ks",
                    "h5_implicit_gnn_1d": "synthetic_ks",
                    "h5_implicit_gnn_2d": "synthetic_burgers_2d",
                    "h5_implicit_2d": "synthetic_burgers_2d",
                    "h5_graph_1d": "synthetic_ce",
                    "h5_graph_2d": "synthetic_burgers_2d",
                    "h5_1d": "synthetic_ce",
                    "h5_2d": "synthetic_burgers_2d"}

HEAT_TEST = {"nt": DATAMODULE_IMPLICIT["nt_test"],
             "nx": DATAMODULE_IMPLICIT["nx_test"]}

TRAINER = {
    "max_epochs": 100,
    "precision": "default",  # tensorfloat32 | high: TF32 in cuBLAS / cuDNN
    "devices": 1,           # dp size; -1: every rank the graph axis leaves
    "graph_shards": 1,      # graph axis size: each sample's graph split
    "graph_halo": False,    # false: all-gather; true / fused: halo exchange;
                            # overlap: halo behind the interior edges; ring:
                            # overlap, the exchange as G - 1 rotations
    "log_every": 10,
    "check_val_every": 1,
    "steps_per_call": 1,    # k > 1: chunks of k steps, as replays of a
                            # captured CUDA graph where the chunk allows it
    "skip_nonfinite": False,
    "grad_clip": 0.0,
    "best_weights_only": False,
    "save_last_every": 1,
}

CALLBACKS = {"patience": 35}

#: ``magnet_tpu_torch.tune``'s sweep (``magnet_tpu/config/defaults/
#: config.yaml:11-14``): trials, and the checkpoint metric it minimizes
SWEEP = {"n_trials": 15, "direction": "minimize", "metric": "val_mae_loss"}

RUN = {"seed": 42, "name": "run", "ckpt_path": "", "workdir": "runs/${name}",
       "device": "cuda"}


#: bool keys that also take a word (``graph_halo=fused``)
BOOL_OR_WORD = ("graph_halo",)


def parse_overrides(argv: list[str], defaults: dict) -> dict:
    """``key=value`` strings over ``defaults``; each value takes the type
    of the default it replaces (bool from true/false; a ``BOOL_OR_WORD``
    key also any other word); a default of None takes null or an int."""
    out = dict(defaults)
    for arg in argv:
        key, sep, val = arg.partition("=")
        if not sep or key not in defaults:
            raise ValueError(f"unknown override {arg!r} (keys: {sorted(defaults)})")
        old = defaults[key]
        if isinstance(old, bool):
            if val.lower() in ("true", "false"):
                out[key] = val.lower() == "true"
            elif key in BOOL_OR_WORD:
                out[key] = val
            else:
                raise ValueError(f"{key} takes true or false, got {val!r}")
        elif old is None:
            out[key] = None if val.lower() in ("null", "none") else int(val)
        else:
            out[key] = type(old)(val)
    return out


def model_overrides(name: str, argv: list[str]) -> dict:
    """Model ``name``'s hyperparameters: its defaults under the ``key=value``
    overrides ``argv``, which may also set its ``MODEL_EXTRAS``."""
    defaults = MODELS[name][0]
    given = {arg.partition("=")[0] for arg in argv}
    hp = parse_overrides(argv, {**defaults, **MODEL_EXTRAS.get(name, {})})
    return {k: v for k, v in hp.items() if k in defaults or k in given}


def split_model(argv: list[str]) -> tuple[str, list[str]]:
    """Take ``model=<name>`` (default ``magnet_cnn``) out of ``argv``."""
    name, rest = "magnet_cnn", []
    for arg in argv:
        key, _, val = arg.partition("=")
        if key == "model":
            name = val
        else:
            rest.append(arg)
    if name not in MODELS:
        raise ValueError(f"model must be one of {sorted(MODELS)}, got {name!r}")
    return name, rest


def split_datamodule(model_name: str,
                     argv: list[str]) -> tuple[dict, list[str]]:
    """Take ``datamodule=<name>`` out of ``argv``: that datamodule's
    defaults (``model_name``'s own without it) and the other arguments."""
    dm, rest = MODELS[model_name][1], []
    for arg in argv:
        key, _, val = arg.partition("=")
        if key == "datamodule":
            if val not in DATAMODULES:
                raise ValueError(f"datamodule must be one of "
                                 f"{sorted(DATAMODULES)}, got {val!r}")
            dm = DATAMODULES[val]
        else:
            rest.append(arg)
    return dm, rest


def take_prefixed(argv: list[str], prefix: str) -> tuple[list[str], list[str]]:
    """The arguments of ``argv`` that start with ``prefix``, without it,
    and the others."""
    return ([a.removeprefix(prefix) for a in argv if a.startswith(prefix)],
            [a for a in argv if not a.startswith(prefix)])


def compose(argv: list[str]) -> dict:
    """The run's config from ``key=value`` overrides: ``model=<name>``
    (``magnet_cnn`` by default) and ``datamodule=<name>`` (the model's own
    by default) choose the defaults; then ``model.params.<k>`` (or
    ``model.<k>``), ``datamodule.<k>``, ``trainer.<k>``,
    ``callbacks.early_stopping.patience``, ``sweep.<k>`` and the top-level
    ``seed``, ``name``, ``ckpt_path``, ``workdir``, ``device``.  The
    model's name is returned as ``model_name``."""
    model_name, argv = split_model(argv)
    dm_defaults, rest = split_datamodule(model_name, argv)
    sections = {"model": MODELS[model_name][0], "datamodule": dm_defaults,
                "trainer": TRAINER, "callbacks": CALLBACKS, "sweep": SWEEP}
    split: dict[str, list[str]] = {k: [] for k in (*sections, "run")}
    for arg in rest:
        key, _, val = arg.partition("=")
        head, _, rest_key = key.partition(".")
        if head in sections and rest_key:
            for prefix in ("params.", "early_stopping."):
                rest_key = rest_key.removeprefix(prefix)
            split[head].append(f"{rest_key}={val}")
        else:
            split["run"].append(arg)
    cfg = parse_overrides(split["run"], RUN)
    cfg["model_name"] = model_name
    for head, defaults in sections.items():
        cfg[head] = (model_overrides(model_name, split[head])
                     if head == "model" else
                     parse_overrides(split[head], defaults))
    return cfg
