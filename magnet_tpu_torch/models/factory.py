"""Model registry (counterpart of ``magnet_tpu/models/factory.py``): all
8 of its models, MAgNet[CNN] 1D/2D, MPNN 1D/2D, MAgNet[GNN] 1D/2D, FNO
1D/2D and the MAgNet[CNN] no-interaction ablation."""
from __future__ import annotations

import torch

from magnet_tpu_torch.models.fno import FNO1D, FNO2D
from magnet_tpu_torch.models.magnet_cnn_1d import MAgNetCNN1D
from magnet_tpu_torch.models.magnet_cnn_2d import MAgNetCNN2D
from magnet_tpu_torch.models.magnet_cnn_no_interaction import (
    MAgNetCNNNoInteraction,
)
from magnet_tpu_torch.models.magnet_gnn import MAgNetGNN
from magnet_tpu_torch.models.mpnn import MPNN, MPNN2D
from magnet_tpu_torch.nn.core import init_torch_default

FACTORY = {"magnet_cnn": MAgNetCNN1D, "magnet_cnn_2d": MAgNetCNN2D,
           "mpnn": MPNN, "mpnn_2d": MPNN2D, "magnet_gnn": MAgNetGNN,
           "fno_1d": FNO1D, "fno_2d": FNO2D,
           "magnet_cnn_no_interaction": MAgNetCNNNoInteraction}
#: MAgNet[GNN]'s position dimension by datamodule kind (1 for any other)
POS_DIM = {"h5_implicit_gnn_2d": 2}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port
    never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless device='cpu' "
            "is passed")
    return device


def create_model(name: str, hparams: dict, device="cuda", seed: int = 0,
                 kind: str | None = None):
    """Build model ``name`` with torch-default init drawn from a generator
    seeded with ``seed``, on ``device``, in eval mode.  ``kind`` is the
    datamodule's kind, which sets MAgNet[GNN]'s position dimension
    (``POS_DIM``); the JAX model reads it off the coordinates."""
    device = resolve_device(device)
    if name not in FACTORY:
        raise ValueError(f"unknown model {name!r} (ported: {sorted(FACTORY)})")
    if name == "magnet_gnn":
        model = MAgNetGNN(hparams, pos_dim=POS_DIM.get(kind, 1))
    else:
        model = FACTORY[name](hparams)
    init_torch_default(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
