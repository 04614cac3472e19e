"""Model registry (counterpart of ``magnet_tpu/models/factory.py``); the
port has MAgNet[CNN] 1D/2D, MPNN 1D/2D and MAgNet[GNN] 1D so far."""
from __future__ import annotations

import torch

from magnet_tpu_torch.models.magnet_cnn_1d import MAgNetCNN1D
from magnet_tpu_torch.models.magnet_cnn_2d import MAgNetCNN2D
from magnet_tpu_torch.models.magnet_gnn import MAgNetGNN
from magnet_tpu_torch.models.mpnn import MPNN, MPNN2D
from magnet_tpu_torch.nn.core import init_torch_default

FACTORY = {"magnet_cnn": MAgNetCNN1D, "magnet_cnn_2d": MAgNetCNN2D,
           "mpnn": MPNN, "mpnn_2d": MPNN2D, "magnet_gnn": MAgNetGNN}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port
    never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless device='cpu' "
            "is passed")
    return device


def create_model(name: str, hparams: dict, device="cuda", seed: int = 0):
    """Build model ``name`` with torch-default init drawn from a generator
    seeded with ``seed``, on ``device``, in eval mode."""
    device = resolve_device(device)
    if name not in FACTORY:
        raise ValueError(f"unknown model {name!r} (ported: {sorted(FACTORY)})")
    model = FACTORY[name](hparams)
    init_torch_default(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
