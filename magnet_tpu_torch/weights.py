"""JAX params -> the port's ``state_dict``, for ``magnet_cnn``,
``magnet_cnn_2d``, ``mpnn``, ``mpnn_2d`` and ``magnet_gnn``.

The inverse of ``magnet_tpu/train/import_torch.py`` (``import_magnet_cnn``,
``import_mpnn``, ``import_magnet_gnn``): the port's modules carry the
reference's torch key names,
so those importers map a port ``state_dict`` back onto the JAX tree leaf
for leaf.

Conventions (the importer's, read backwards):
  * flax Dense kernel (in, out) -> torch Linear weight (out, in);
  * flax Conv kernel (k, in, out) -> torch Conv1d weight (out, in, k),
    (kh, kw, in, out) -> torch Conv2d weight (out, in, kh, kw);
  * flax LayerNorm scale/bias -> torch weight/bias;
  * MLP Linears sit at even indices of ``layers``;
  * scanned stacks (processor steps, EDSR blocks) are split on axis 0;
  * the processor's split first edge layer ``e_w_xi | e_w_xj | e_w_e`` is
    joined back into the unsplit (H, 3C) Linear, in that chunk order, and
    the MPNN layer's ``msg1_xi | msg1_xj | msg1_u | msg1_pos | msg1_var``
    into ``message_net_1.0``, whose bias is ``msg1_var``'s.
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
    k = np.asarray(conv["Conv_0"]["kernel"])
    nd = k.ndim - 2
    sd[f"{prefix}.weight"] = _t(k.transpose(nd + 1, nd, *range(nd)))
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


def edsr_state_dict(enc: Mapping[str, Any], res_layers: int,
                    prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX ``EDSR``'s params (1D or 2D) as the ``state_dict`` of the
    port's ``nn.edsr.EDSR``, keys starting with ``prefix``."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}head_conv", enc["Conv_0"])
    _conv(sd, f"{prefix}tail_conv", enc["Conv_1"])
    blocks = enc["res_layers"]["ResBlock_0"]
    for i in range(res_layers):
        blk = _index(blocks, i)
        _conv(sd, f"{prefix}res_layers.{i}.conv_1", blk["Conv_0"])
        _conv(sd, f"{prefix}res_layers.{i}.conv_2", blk["Conv_1"])
    return sd


MSG1_CHUNKS = ("msg1_xi", "msg1_xj", "msg1_u", "msg1_pos", "msg1_var")


def mpnn_layer_state_dict(layer: Mapping[str, Any],
                          prefix: str = "") -> dict[str, torch.Tensor]:
    """One JAX ``MPNNLayer``'s params as the ``state_dict`` of the port's
    ``nn.gnn_layer.MPNNLayer``, keys starting with ``prefix``."""
    sd: dict[str, torch.Tensor] = {}
    w1 = np.concatenate([layer[k]["kernel"] for k in MSG1_CHUNKS], axis=0)
    _lin(sd, f"{prefix}message_net_1.0",
         {"kernel": w1, "bias": layer["msg1_var"]["bias"]})
    _lin(sd, f"{prefix}message_net_2.0",
         {"kernel": layer["msg2_w"], "bias": layer["msg2_b"]})
    _lin(sd, f"{prefix}update_net_1.0", layer["upd1"]["Dense_0"])
    _lin(sd, f"{prefix}update_net_2.0", layer["upd2"]["Dense_0"])
    return sd


def decoder_state_dict(dec: Mapping[str, Any], with_mid_swish: bool,
                       prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX ``TemporalBundlingDecoder``'s params as the ``state_dict`` of
    the port's: the second Conv1d sits at index 2 behind the mid Swish, at
    index 1 without it."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}0", dec["Conv_0"])
    _conv(sd, f"{prefix}{2 if with_mid_swish else 1}", dec["Conv_1"])
    return sd


def _mpnn_state_dict(p, hp, is_2d: bool) -> dict[str, torch.Tensor]:
    n_layers = int(hp.get("hidden_layer", 5))
    tw = int(hp.get("time_window", 10 if is_2d else 16))
    sd: dict[str, torch.Tensor] = {}
    _lin(sd, "embedding_mlp.0", p["embed_0"]["Dense_0"])
    _lin(sd, "embedding_mlp.2", p["embed_1"]["Dense_0"])
    for i in range(n_layers):
        sd.update(mpnn_layer_state_dict(_index(p["gnn_layers"]["layer"], i),
                                        f"gnn_layers.{i}."))
    # the 1D time_window == 10 decoder has no Swish between its convolutions
    sd.update(decoder_state_dict(p["output_mlp"], is_2d or tw != 10,
                                 "output_mlp."))
    return sd


def _graph_encoder(sd, prefix, ge):
    _mlp(sd, f"{prefix}.node_fn.0", ge["MLP_0"])
    _ln(sd, f"{prefix}.node_fn.1", ge["LayerNorm_0"]["LayerNorm_0"])
    _mlp(sd, f"{prefix}.edge_fn.0", ge["MLP_1"])
    _ln(sd, f"{prefix}.edge_fn.1", ge["LayerNorm_1"]["LayerNorm_0"])


def _processor(sd, prefix, proc, mp, mlp_layers):
    steps = proc["steps"]["step"]
    for i in range(mp):
        st = _index(steps, i)
        pre = f"{prefix}.gnn_stacks.{i}"
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


def state_dict_from_jax(params: Mapping[str, Any], hp: Mapping[str, Any],
                        model: str = "magnet_cnn") -> dict[str, torch.Tensor]:
    """``params`` is the JAX model's variables (``{'params': ...}``) or the
    inner tree, leaves numpy arrays; returns a ``state_dict`` for the
    port's model ``model`` (``magnet_cnn``, ``magnet_cnn_2d``, ``mpnn``,
    ``mpnn_2d`` or ``magnet_gnn``); the two MAgNet[CNN] models share one
    layout, the 2D one with Conv2d kernels.  MAgNet[GNN] has two
    encoder / processor pairs (``encoder``, ``processor`` over the LR nodes;
    ``_encoder``, ``_processor`` over LR ∪ HR) and its ``proj_head`` is one
    Linear."""
    p = params.get("params", params)
    if model in ("mpnn", "mpnn_2d"):
        return _mpnn_state_dict(p, hp, is_2d=model == "mpnn_2d")
    if model not in ("magnet_cnn", "magnet_cnn_2d", "magnet_gnn"):
        raise ValueError(f"no weight bridge for model {model!r}")
    gnn = model == "magnet_gnn"
    mlp_layers = int(hp.get("mlp_layers", 4))
    mp = int(hp.get("num_message_passing_steps", 5 if gnn else 10))
    sd: dict[str, torch.Tensor] = {}

    if gnn:
        _graph_encoder(sd, "encoder", p["encoder"])
        _processor(sd, "processor", p["processor"], mp, mlp_layers)
        _lin(sd, "proj_head", p["continuous_decoder"]["Linear_0"]["Dense_0"])
    else:
        res_layers = int(hp.get("res_layers",
                                4 if model == "magnet_cnn" else 16))
        sd.update(edsr_state_dict(p["encoder"], res_layers, "encoder."))
        cd = p["continuous_decoder"]
        _mlp(sd, "proj_head.0", cd["MLP_0"])
        _ln(sd, "proj_head.1", cd["LayerNorm_0"]["LayerNorm_0"])
    _mlp(sd, "projector", p["projector"])
    _graph_encoder(sd, "_encoder", p["_encoder"])
    _processor(sd, "_processor", p["_processor"], mp, mlp_layers)
    _mlp(sd, "_decoder.node_fn", p["_decoder"]["MLP_0"])
    return sd
