"""The port's pe entry (kernels #6 and #7, through their plain versions and
the wrappers' CPU path) against the JAX package's ``fused_edge_tail_agg2``
run in Pallas interpret mode as ``tests/test_ops.py`` runs it: the forward
is ``_fused2_fwd_pallas``, the gradients ``_fused2_bwd_pallas`` with d_pxj
reduced by ``blocked_segment_sum`` (``_pallas_impl``) over the
sender-transpose layout.  Then one ``InteractionNetwork`` step with
``impl="kernel_pe"`` against the JAX step under ``MAGNET_TPU_NO_FUSED2R``,
which takes the same lane; and the width dispatch of the kernel wrappers.

One radius graph is built twice: by ``build_radius_graph_batch`` for the
JAX side (its blocked and sender-tile layouts) and by the port's CSR.
Tolerances: forward rtol 1e-4, atol 1e-5; gradients rtol 1e-3, atol 1e-4
(those of ``test_torch_pregathered_edge.py``: f32 on both sides, sums in
another order); the step's node latents rtol 1e-4, atol 1e-5 and its
parameter gradients rtol 2e-3, atol 1e-5 relative to each leaf's largest
entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import build_radius_graph_batch  # noqa: E402
from magnet_tpu.nn import graphnet as jax_graphnet  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu_torch.nn.graphnet import InteractionNetwork  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.graph import radius_graph_batch  # noqa: E402

FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=1e-3, atol=1e-4)
H, C = 32, 16


def _graphs(n=60, r=0.1, seed=2):
    """A sorted 1D point set with self loops, one node far off (a receiver
    of degree 1: its loop), in the JAX blocked layout and the port's CSR;
    and the raw (CSR) edge of every live blocked slot."""
    rng = np.random.default_rng(seed)
    coords = np.sort(rng.uniform(-1, 1, (1, n, 1)), axis=1).astype(np.float32)
    coords[0, -1] = 5.0
    gs = jax.tree.map(lambda a: a[0],
                      build_radius_graph_batch(coords, r, loop=True))
    assert gs.blk_snd2_tids is not None and gs.blk_snd_edge_ids is not None
    graph = radius_graph_batch(torch.from_numpy(coords), r, loop=True)
    s, rv = graph.senders.numpy(), graph.receivers.numpy()
    key = rv.astype(np.int64) * n + s
    flat_key = (np.asarray(gs.receivers).astype(np.int64) * n
                + np.asarray(gs.senders))
    live = np.asarray(gs.edge_mask) > 0
    e_idx = np.searchsorted(key, flat_key[live])
    assert (key[e_idx] == flat_key[live]).all()
    return gs, graph, e_idx, live


def _operands(graph, L1, seed):
    rng = np.random.default_rng(seed)
    n, e = graph.n_node, graph.n_edge

    def f(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(pe=f(e, H), pxj=f(n, H), pxi=f(n, H), w_rest=f(L1, H, H),
                b_rest=f(L1, H), w_out=f(H, C), b_out=f(C),
                ln_s=1 + f(C, scale=0.1), ln_b=f(C, scale=0.1))


TAIL = ("w_rest", "b_rest", "w_out", "b_out", "ln_s", "ln_b")


@pytest.mark.parametrize("L1", [0, 2])
def test_pe_entry_matches_fused2_pallas_interpret(monkeypatch, L1):
    gs, graph, e_idx, live = _graphs()
    p = _operands(graph, L1, seed=90 + L1)
    n = graph.n_node
    T, et = gs.blk_recv_local.shape
    n_pad = T * 128
    pe_blk = np.zeros((T * et, H), np.float32)
    pe_blk[live] = p["pe"][e_idx]

    def pad(a):
        out = np.zeros((n_pad, a.shape[1]), np.float32)
        out[:n] = a
        return out

    g = np.random.default_rng(L1).normal(size=(n, C)).astype(np.float32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    out, vjp = jax.vjp(
        lambda pe_, pxj_, pxi_, *tail: pk.fused_edge_tail_agg2(
            pe_, pxj_, pxi_, *tail, gs.blk_snd2_tids, gs.blk_snd2_local,
            gs.blk_recv_local, gs.edge_mask.reshape(T, et),
            gs.blk_snd_edge_ids, gs.blk_snd_local),
        jnp.asarray(pe_blk.reshape(T, et, H)), jnp.asarray(pad(p["pxj"])),
        jnp.asarray(pad(p["pxi"]).reshape(T, 128, H)),
        *(jnp.asarray(p[k]) for k in TAIL))
    want = np.asarray(out).reshape(-1, C)[:n]
    d = [np.asarray(a) for a in vjp(jnp.asarray(pad(g).reshape(T, 128, C)))]
    want_grads = [d[0].reshape(T * et, H)[live][np.argsort(e_idx)],
                  d[1][:n], d[2].reshape(-1, H)[:n], *d[3:]]

    ops = (torch.from_numpy(p["pe"]), torch.from_numpy(p["pxj"]),
           torch.from_numpy(p["pxi"]), graph.senders, graph.rowptr,
           graph.snd_ptr, graph.snd_perm,
           *(torch.from_numpy(p[k]) for k in TAIL))
    before = (fe.launches_pe, fe.launches_pe_bwd, seg.launches)
    got = fe.fused_edge_tail_agg_pe(*ops)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    got_grads = fe.fused_edge_tail_agg_pe_bwd(*ops, torch.from_numpy(g))
    assert (fe.launches_pe, fe.launches_pe_bwd, seg.launches) == before
    assert len(got_grads) == len(fe.GRAD_NAMES_PE) == len(want_grads)
    for name, a, b in zip(fe.GRAD_NAMES_PE, got_grads, want_grads):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, **BWD, err_msg=name)
    # the wrapper on CPU tensors is ordinary autograd through the plain
    # version; the autograd Function refuses a CPU tensor
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in ops]
    fe.fused_edge_tail_agg_pe(*leaves).backward(torch.from_numpy(g))
    floats = [t for t in leaves if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES_PE, floats, got_grads):
        if leaf.numel():
            np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy(),
                                          err_msg=name)
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe.FusedEdgeTailAggPe.apply(*ops)


def test_interaction_step_kernel_pe_matches_jax_no_fused2r(monkeypatch):
    """The JAX step takes ``fused_edge_tail_agg2`` (mode 'vmem', not
    ragged, no fold-e) under ``MAGNET_TPU_NO_FUSED2R``; the port's step
    with ``impl='kernel_pe'`` is held to it, node latents and every
    parameter gradient, at an edge scale of 2 (step 1 of a processor)."""
    from magnet_tpu.nn.graphnet import InteractionNetwork as JaxInteraction

    gs, graph, e_idx, live = _graphs(seed=3)
    n, latent = graph.n_node, 16
    T, et = gs.blk_recv_local.shape
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, latent)).astype(np.float32)
    e0 = rng.normal(size=(graph.n_edge, latent)).astype(np.float32)
    e_blk = np.zeros((T * et, latent), np.float32)
    e_blk[live] = e0[e_idx]
    w_out = rng.normal(size=(n, latent)).astype(np.float32)
    step = JaxInteraction(node_out=latent, edge_out=latent, mlp_layers=2,
                          mlp_hidden=latent)
    params = step.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(e_blk), gs, e_scale=2.0)
    monkeypatch.setenv("MAGNET_TPU_NO_FUSED2R", "1")

    def loss(p):
        out, _ = step.apply(p, jnp.asarray(x), jnp.asarray(e_blk), gs,
                            e_scale=2.0)
        return jnp.sum(out * w_out), out

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    assert jax_graphnet.LAST_FUSED_LANE["mode"] == "vmem"
    assert jax_graphnet.LAST_FUSED_LANE["ragged"] is False
    assert jax_graphnet.LAST_FUSED_LANE["fold"] is False

    sp = jax.tree.map(np.asarray, params["params"])
    mod = InteractionNetwork(latent, 2, latent)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    w0 = np.concatenate([sp["e_w_xi"]["kernel"], sp["e_w_xj"]["kernel"],
                         sp["e_w_e"]["kernel"]], axis=0).T
    sd = {"edge_fn.0.layers.0.weight": t(w0),
          "edge_fn.0.layers.0.bias": t(sp["e_w_e"]["bias"]),
          "edge_fn.0.layers.2.weight": t(sp["w_rest"][0].T),
          "edge_fn.0.layers.2.bias": t(sp["b_rest"][0]),
          "edge_fn.0.layers.4.weight": t(sp["w_out"].T),
          "edge_fn.0.layers.4.bias": t(sp["b_out"]),
          "edge_fn.1.weight": t(sp["ln_scale"]),
          "edge_fn.1.bias": t(sp["ln_bias"]),
          "node_fn.1.weight": t(sp["node_fn"]["layers_1"]["LayerNorm_0"]["scale"]),
          "node_fn.1.bias": t(sp["node_fn"]["layers_1"]["LayerNorm_0"]["bias"])}
    for j in range(3):
        dense = sp["node_fn"]["layers_0"][f"Linear_{j}"]["Dense_0"]
        sd[f"node_fn.0.layers.{2 * j}.weight"] = t(dense["kernel"].T)
        sd[f"node_fn.0.layers.{2 * j}.bias"] = t(dense["bias"])
    mod.load_state_dict(sd)
    before = (fe.launches_pe, fe.launches_pe_bwd)
    got = mod(torch.from_numpy(x), torch.from_numpy(e0), graph, e_scale=2.0,
              impl="kernel_pe")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    (got * torch.from_numpy(w_out)).sum().backward()
    assert (fe.launches_pe, fe.launches_pe_bwd) == before
    gp = jax.tree.map(np.asarray, want_g["params"])
    lin0 = mod.edge_fn[0].linears[0].weight.grad.numpy().T
    pairs = {
        "e_w_xi": (lin0[:latent], gp["e_w_xi"]["kernel"]),
        "e_w_xj": (lin0[latent:2 * latent], gp["e_w_xj"]["kernel"]),
        "e_w_e": (lin0[2 * latent:], gp["e_w_e"]["kernel"]),
        "b_e": (mod.edge_fn[0].linears[0].bias.grad.numpy(),
                gp["e_w_e"]["bias"]),
        "w_rest": (mod.edge_fn[0].linears[1].weight.grad.numpy().T,
                   gp["w_rest"][0]),
        "w_out": (mod.edge_fn[0].linears[2].weight.grad.numpy().T,
                  gp["w_out"]),
        "ln_scale": (mod.edge_fn[1].weight.grad.numpy(), gp["ln_scale"]),
        "node_fn_out": (
            mod.node_fn[0].layers[4].weight.grad.numpy().T,
            gp["node_fn"]["layers_0"]["Linear_2"]["Dense_0"]["kernel"]),
    }
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(
            a, b, rtol=2e-3, atol=1e-5 * max(float(np.abs(b).max()), 1.0),
            err_msg=name)


@pytest.mark.parametrize("entry,widths", [
    ("fold", (128, 128, 128)), ("fold", (32, 64, 32)),
    ("pregathered", (128, 128)), ("pregathered", (64, 32)),
    ("pe", (128, 128)), ("pe", (64, 32))])
def test_width_dispatch_keys_each_entry_by_what_it_reads(entry, widths):
    """Every compiled build passes the width check and the launch stops
    only at the device (there is no CUDA device here); a width-128
    pregathered call is no longer checked against a fold build's Ce."""
    gs, graph, _, _ = _graphs()
    n, e = graph.n_node, graph.n_edge
    h, c = widths[-2:]
    z = torch.zeros
    tail = (z(3, h, h), z(3, h), z(h, c), z(c), z(c), z(c))
    src = z(e, widths[0]) if entry == "fold" else z(e, h)
    fold = entry == "fold"
    args = (src, z(widths[0], h) if fold else None, z(h) if fold else None,
            None if entry == "pregathered" else z(n, h), z(n, h),
            None if entry == "pregathered" else graph.senders, graph.rowptr,
            *tail)
    assert widths in fe.KERNEL_WIDTHS[entry]
    for launch in (fe._launch_fwd, fe._launch_bwd):
        extra = (z(n, c),) if launch is fe._launch_bwd else ()
        with pytest.raises(ValueError, match="no fused edge kernel"):
            launch(entry, *args, *extra)
    # an uncompiled width is refused by the width check itself
    wide = (z(e, 96), None, None, None, z(n, 96), None, graph.rowptr,
            z(3, 96, 96), z(3, 96), z(96, 96), z(96), z(96), z(96))
    with pytest.raises(ValueError, match="compiled for"):
        fe._launch_fwd("pregathered", *wide)
