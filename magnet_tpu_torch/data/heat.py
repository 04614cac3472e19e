"""Heat test batches made from a seed, with no file and no ``h5py``: the
eval-mode samples of ``DatasetImplicit1D`` (half-resolution support, every
point of the full mesh queried) over ``data.synthetic.solve_heat_1d``
trajectories."""
from __future__ import annotations

from magnet_tpu_torch.data.datasets import DatasetImplicit1D
from magnet_tpu_torch.data.loader import DataLoader
from magnet_tpu_torch.data.synthetic import make_split
from magnet_tpu_torch.data.synthetic import solve_heat_1d  # noqa: F401


def implicit_eval_sample(u, t) -> dict:
    """One eval sample from a trajectory u (nt, L): the model's batch keys."""
    nt, nx = u.shape
    return DatasetImplicit1D({"t": t[None], f"pde_{nt}-{nx}": u[None]},
                             "test", nt=nt, nx=nx)[0]


def heat_batches(n_traj: int, batch_size: int, nt: int = 256, nx: int = 256,
                 seed: int = 0) -> list[dict]:
    """``n_traj`` Heat trajectories from ``seed``, as eval batches of numpy
    arrays in order (the last batch may be smaller)."""
    dataset = DatasetImplicit1D(make_split("Heat", n_traj, nt, nx, seed=seed),
                                "test", nt=nt, nx=nx)
    return list(DataLoader(dataset, batch_size, shuffle=False,
                           drop_last=False))
