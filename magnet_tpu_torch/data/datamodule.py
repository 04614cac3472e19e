"""Datamodule assembly: config -> train/val/test loaders (counterpart of
``magnet_tpu/data/datamodule.py``), for every kind: ``h5_implicit_1d``,
``h5_implicit_2d``, ``h5_graph_1d``, ``h5_graph_2d``,
``h5_implicit_gnn_1d``, ``h5_implicit_gnn_2d``, ``h5_1d`` and ``h5_2d``.

The 1D val split reads the group ``valid``, the 2D one ``test``.  Every
split is shuffled, as in the reference, unless ``shuffle_eval`` is false.
Where there are no files a synthetic ``source`` makes the three splits
from ``data_seed``: ``synthetic_ks`` (KS train and valid, Heat test) for
the implicit-1D kinds, ``synthetic_ce`` (the combined equation's preset
``eq``) for the 1D graphs and FNO-1D, ``synthetic_burgers_2d`` for the
other 2D kinds; a split of the implicit-GNN-2D kind that is not regular is
the irregular subsample of an ``IRREGULAR_GRID``-square grid, as
``generate_2d_file`` writes it.
"""
from __future__ import annotations

from typing import Any

from magnet_tpu_torch.config import MODELS, SYNTHETIC_SOURCE
from magnet_tpu_torch.data.datasets import (
    Dataset1D,
    Dataset2D,
    DatasetGraph1D,
    DatasetGraph2D,
    DatasetImplicit1D,
    DatasetImplicit2D,
    DatasetImplicitGNN1D,
    DatasetImplicitGNN2D,
)
from magnet_tpu_torch.data.loader import DataLoader
from magnet_tpu_torch.data.synthetic import make_split

SPLITS = ("train", "val", "test")
# the fine grid an irregular synthetic split's nodes are drawn from
IRREGULAR_GRID = 64


def _synthetic(cfg, split: str, seed: int) -> dict:
    """The arrays of one split of ``cfg``'s kind, made from ``seed``."""
    kind = cfg["kind"]
    n, (nt, res) = int(cfg[f"n_{split}"]), _shape(cfg, split)
    if kind in ("h5_implicit_1d", "h5_implicit_gnn_1d"):
        if split == "test":
            return make_split("Heat", n, nt, res, seed=seed)
        return make_split("KS", n, nt, res, seed=seed,
                          burn_in=cfg.get("burn_in", 40.0))
    if kind in ("h5_graph_1d", "h5_1d"):
        return make_split(cfg.get("eq", "E3"), n, nt, res, seed=seed,
                          n_steps=int(cfg.get("n_steps", 4000)))
    if kind == "h5_implicit_gnn_2d" and not cfg.get(f"{split}_regular", True):
        return make_split("B2D", n, nt, IRREGULAR_GRID,
                          seed=seed, n_nodes=_n_nodes(cfg, split),
                          concentrated=bool(cfg.get("concentrated", False)))
    return make_split("B2D", n, nt, res, seed=seed)


def _n_nodes(cfg, split: str) -> int:
    """The node count of an irregular implicit-GNN-2D split, its key's
    (``magnet_tpu/data/datasets.py:292-293``: every split reads
    ``n_nodes_train``)."""
    n_nodes = cfg.get("n_nodes_train")
    return int(cfg[f"res_{split}"] if n_nodes is None else n_nodes)


def _shape(cfg, split: str) -> tuple[int, int]:
    res_key = "res" if cfg["kind"].endswith("2d") else "nx"
    return cfg[f"nt_{split}"], cfg[f"{res_key}_{split}"]


def _dataset(cfg, split: str, data):
    """The dataset of one split over ``data`` (a file's path or arrays)."""
    kind = cfg["kind"]
    mode = {"train": "train", "test": "test",
            "val": "valid" if kind.endswith("1d") else "test"}[split]
    nt, res = _shape(cfg, split)
    if kind in ("h5_implicit_1d", "h5_implicit_gnn_1d"):
        cls = (DatasetImplicit1D if kind == "h5_implicit_1d"
               else DatasetImplicitGNN1D)
        return cls(
            data, mode, nt=nt, nx=res, sampling=cfg.get("sampling", "uniform"),
            samples=cfg.get("samples", 32),
            eval_support=cfg.get("eval_support", "lr"))
    if kind == "h5_implicit_2d":
        return DatasetImplicit2D(
            data, mode, nt=nt, res=res, samples=cfg.get("samples", 32),
            eval_support=cfg.get("eval_support", "lr"))
    if kind == "h5_implicit_gnn_2d":
        return DatasetImplicitGNN2D(
            data, mode, nt=nt, res=res,
            regular=cfg.get(f"{split}_regular", True),
            samples=cfg.get("samples", 32),
            eval_support=cfg.get("eval_support", "lr"),
            n_nodes=cfg.get("n_nodes_train"))
    if kind == "h5_graph_1d":
        return DatasetGraph1D(data, mode, nt=nt, nx=res)
    if kind == "h5_1d":
        return Dataset1D(data, mode, nt=nt, nx=res)
    if kind == "h5_2d":
        return Dataset2D(data, mode, nt=nt, res=res)
    return DatasetGraph2D(data, mode, nt=nt, res=res,
                          regular=cfg.get(f"{split}_regular", True))


def synthetic_split(cfg: dict[str, Any], split: str) -> dict:
    """The arrays ``cfg``'s synthetic source makes for ``split``: the
    three splits take seeds ``3 * data_seed`` + 0, 1, 2."""
    seed = int(cfg.get("data_seed", 0)) * 3 + SPLITS.index(split)
    return _synthetic(cfg, split, seed)


def build_datasets(cfg: dict[str, Any]) -> dict:
    kind = cfg["kind"]
    if kind not in SYNTHETIC_SOURCE:
        raise ValueError(f"unknown datamodule kind {kind!r}")
    source = cfg.get("source", "h5")
    if source not in ("h5", SYNTHETIC_SOURCE[kind]):
        raise ValueError(f"unknown source {source!r} for datamodule kind "
                         f"{kind!r} (h5 or {SYNTHETIC_SOURCE[kind]})")
    return {split: _dataset(cfg, split, cfg[f"{split}_path"] if source == "h5"
                            else synthetic_split(cfg, split))
            for split in SPLITS}


def build_loaders(cfg: dict[str, Any], seed: int = 0,
                  shuffle_eval: bool = True) -> dict:
    ds = build_datasets(cfg)
    bs = int(cfg.get("batch_size", 32))
    # num_workers > 0: a prefetch thread, as the JAX datamodule's
    prefetch = 2 if cfg.get("num_workers", 0) else 0
    return {
        "train": DataLoader(ds["train"], bs, shuffle=True, seed=seed,
                            prefetch=prefetch),
        "val": DataLoader(ds["val"], min(bs, len(ds["val"])),
                          shuffle=shuffle_eval, seed=seed + 1,
                          prefetch=prefetch),
        "test": DataLoader(ds["test"], min(bs, len(ds["test"])),
                           shuffle=shuffle_eval, seed=seed + 2,
                           prefetch=prefetch),
    }


def synthetic_test_batches(model_name: str, n_traj: int, batch_size: int,
                           seed: int = 0,
                           datamodule: dict | None = None) -> list[dict]:
    """``n_traj`` test trajectories of the datamodule config ``datamodule``
    (by default ``model_name``'s own), made from ``seed`` at the test
    split's shape, as eval batches of numpy arrays in order.  The batch is
    ``min(batch_size, n_traj)`` and the trailing partial batch is dropped,
    as the repo's ``eval.py`` batches its test split."""
    dm = MODELS[model_name][1] if datamodule is None else datamodule
    cfg = {**dm, "n_test": n_traj}
    dataset = _dataset(cfg, "test", _synthetic(cfg, "test", seed))
    return list(DataLoader(dataset, min(batch_size, n_traj), shuffle=False))


def eval_batches(model_name: str, n_traj: int, batch_size: int,
                 seed: int = 0, datamodule: dict | None = None) -> list[dict]:
    """The eval batches of the datamodule config ``datamodule``'s (by
    default ``model_name``'s own) test split, as the repo's ``eval.py``
    reads it: the file at ``test_path`` in order where ``source`` is
    ``h5``, else ``synthetic_test_batches``; the batch is ``min(batch_size,
    n)`` and the trailing partial batch is dropped."""
    dm = MODELS[model_name][1] if datamodule is None else datamodule
    if dm.get("source", "h5") != "h5":
        return synthetic_test_batches(model_name, n_traj, batch_size,
                                      seed=seed, datamodule=dm)
    dataset = _dataset(dm, "test", dm["test_path"])
    return list(DataLoader(dataset, min(batch_size, len(dataset)),
                           shuffle=False))
