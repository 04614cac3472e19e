"""Datamodule assembly: config -> train/val/test loaders (counterpart of
``magnet_tpu/data/datamodule.py``), for ``kind: h5_implicit_1d``.

The 1D val split reads the group ``valid``.  Every split is shuffled, as
in the reference, unless ``shuffle_eval`` is false.  ``source:
synthetic_ks`` takes the place of the three files where there are none: KS
train and valid trajectories and Heat test trajectories made from
``data_seed``.
"""
from __future__ import annotations

from typing import Any

from magnet_tpu_torch.data.datasets import DatasetImplicit1D
from magnet_tpu_torch.data.loader import DataLoader
from magnet_tpu_torch.data.synthetic import make_split

SPLITS = (("train", "train"), ("val", "valid"), ("test", "test"))


def build_datasets(cfg: dict[str, Any]) -> dict:
    if cfg["kind"] != "h5_implicit_1d":
        raise ValueError(f"unknown datamodule kind {cfg['kind']!r}")
    source = cfg.get("source", "h5")
    if source not in ("h5", "synthetic_ks"):
        raise ValueError(f"unknown datamodule source {source!r}")
    out = {}
    for i, (split, mode) in enumerate(SPLITS):
        nt, nx = cfg[f"nt_{split}"], cfg[f"nx_{split}"]
        if source == "h5":
            data = cfg[f"{split}_path"]
        else:
            kw = {} if split == "test" else {"burn_in": cfg.get("burn_in", 40.0)}
            data = make_split("Heat" if split == "test" else "KS",
                              int(cfg[f"n_{split}"]), nt, nx,
                              seed=int(cfg.get("data_seed", 0)) * 3 + i, **kw)
        out[split] = DatasetImplicit1D(
            data, mode, nt=nt, nx=nx, sampling=cfg.get("sampling", "uniform"),
            samples=cfg.get("samples", 32),
            eval_support=cfg.get("eval_support", "lr"))
    return out


def build_loaders(cfg: dict[str, Any], seed: int = 0,
                  shuffle_eval: bool = True) -> dict:
    ds = build_datasets(cfg)
    bs = int(cfg.get("batch_size", 32))
    return {
        "train": DataLoader(ds["train"], bs, shuffle=True, seed=seed),
        "val": DataLoader(ds["val"], min(bs, len(ds["val"])),
                          shuffle=shuffle_eval, seed=seed + 1,
                          drop_last=False),
        "test": DataLoader(ds["test"], min(bs, len(ds["test"])),
                           shuffle=shuffle_eval, seed=seed + 2,
                           drop_last=False),
    }
