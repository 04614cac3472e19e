"""JAX ``magnet_cnn`` params -> the port's ``state_dict``.

The inverse of ``magnet_tpu/train/import_torch.py:import_magnet_cnn``: the
port's modules carry the reference's torch key names, so that importer
maps a port ``state_dict`` back onto the JAX tree leaf for leaf.

Conventions (the importer's, read backwards):
  * flax Dense kernel (in, out) -> torch Linear weight (out, in);
  * flax Conv kernel (k, in, out) -> torch Conv1d weight (out, in, k);
  * flax LayerNorm scale/bias -> torch weight/bias;
  * MLP Linears sit at even indices of ``layers``;
  * scanned stacks (processor steps, EDSR blocks) are split on axis 0;
  * the processor's split first edge layer ``e_w_xi | e_w_xj | e_w_e`` is
    joined back into the unsplit (H, 3C) Linear, in that chunk order.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _lin(sd, prefix, dense):
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(dense["bias"])


def _ln(sd, prefix, ln):
    sd[f"{prefix}.weight"] = _t(ln["scale"])
    sd[f"{prefix}.bias"] = _t(ln["bias"])


def _conv(sd, prefix, conv):
    sd[f"{prefix}.weight"] = _t(np.asarray(conv["Conv_0"]["kernel"]).transpose(2, 1, 0))
    sd[f"{prefix}.bias"] = _t(conv["Conv_0"]["bias"])


def _mlp(sd, prefix, tree):
    j = 0
    while f"Linear_{j}" in tree:
        _lin(sd, f"{prefix}.layers.{2 * j}", tree[f"Linear_{j}"]["Dense_0"])
        j += 1


def _index(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax(params: Mapping[str, Any],
                        hp: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``params`` is the JAX model's variables (``{'params': ...}``) or the
    inner tree, leaves numpy arrays; returns a ``state_dict`` for
    ``magnet_tpu_torch.models.magnet_cnn_1d.MAgNetCNN1D``."""
    p = params.get("params", params)
    mlp_layers = int(hp.get("mlp_layers", 4))
    res_layers = int(hp.get("res_layers", 4))
    mp = int(hp.get("num_message_passing_steps", 10))
    sd: dict[str, torch.Tensor] = {}

    enc = p["encoder"]
    _conv(sd, "encoder.head_conv", enc["Conv_0"])
    _conv(sd, "encoder.tail_conv", enc["Conv_1"])
    blocks = enc["res_layers"]["ResBlock_0"]
    for i in range(res_layers):
        blk = _index(blocks, i)
        _conv(sd, f"encoder.res_layers.{i}.conv_1", blk["Conv_0"])
        _conv(sd, f"encoder.res_layers.{i}.conv_2", blk["Conv_1"])

    cd = p["continuous_decoder"]
    _mlp(sd, "proj_head.0", cd["MLP_0"])
    _ln(sd, "proj_head.1", cd["LayerNorm_0"]["LayerNorm_0"])
    _mlp(sd, "projector", p["projector"])

    ge = p["_encoder"]
    _mlp(sd, "_encoder.node_fn.0", ge["MLP_0"])
    _ln(sd, "_encoder.node_fn.1", ge["LayerNorm_0"]["LayerNorm_0"])
    _mlp(sd, "_encoder.edge_fn.0", ge["MLP_1"])
    _ln(sd, "_encoder.edge_fn.1", ge["LayerNorm_1"]["LayerNorm_0"])

    steps = p["_processor"]["steps"]["step"]
    for i in range(mp):
        st = _index(steps, i)
        pre = f"_processor.gnn_stacks.{i}"
        w0 = np.concatenate([st["e_w_xi"]["kernel"], st["e_w_xj"]["kernel"],
                             st["e_w_e"]["kernel"]], axis=0)  # (3C, H)
        _lin(sd, f"{pre}.edge_fn.0.layers.0",
             {"kernel": w0, "bias": st["e_w_e"]["bias"]})
        for j in range(1, mlp_layers):
            _lin(sd, f"{pre}.edge_fn.0.layers.{2 * j}",
                 {"kernel": st["w_rest"][j - 1], "bias": st["b_rest"][j - 1]})
        _lin(sd, f"{pre}.edge_fn.0.layers.{2 * mlp_layers}",
             {"kernel": st["w_out"], "bias": st["b_out"]})
        _ln(sd, f"{pre}.edge_fn.1",
            {"scale": st["ln_scale"], "bias": st["ln_bias"]})
        _mlp(sd, f"{pre}.node_fn.0", st["node_fn"]["layers_0"])
        _ln(sd, f"{pre}.node_fn.1", st["node_fn"]["layers_1"]["LayerNorm_0"])

    _mlp(sd, "_decoder.node_fn", p["_decoder"]["MLP_0"])
    return sd
