"""The port's fused MPNN message path (plain forward and backward of both
entries, and the wrappers' CPU paths) against the JAX package: the jnp
oracles ``_mpnn_ref_impl`` / ``_mpnn2r_ref_impl``, and
``fused_mpnn_edge_agg`` / ``fused_mpnn_edge_agg2r`` in Pallas interpret
mode, with ``jax.grad`` for the four gradients of each.

One raw radius graph (with a node of degree 0) is packed by magnet_tpu's
blocked tile layout (``build_radius_graph_batch``) for the JAX side and by
the port's CSR for the port; per-node results are compared directly, the
pre-gathered entry's per-edge ``d_h0`` through the slot -> raw edge map.
Tolerances: outputs rtol 1e-4, atol 1e-4; gradients rtol 1e-3, atol 1e-4
(those of the JAX package's own tests of these kernels): f32 on both
sides, the H-wide products and the sums over up to ~500 edges per weight
column taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.models.common import build_radius_graph_batch  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu.ops.graph import radius_graph_np  # noqa: E402
from magnet_tpu_torch.ops import mpnn_edge as me  # noqa: E402
from magnet_tpu_torch.ops.graph import csr_from_edges  # noqa: E402

OUT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
N, RADIUS = 260, 0.04


def _problem(H, seed):
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.uniform(-1, 1, (N, 1)), axis=0).astype(np.float32)
    pos[N // 2, 0] = 9.0  # isolated, and loop=False: a node of degree 0
    s, r = radius_graph_np(pos, RADIUS, loop=False)

    def f(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(pos=pos, s=s, r=r, pxj=f(N, H, scale=0.5),
                pr=f(N, H, scale=0.5), w=f(H, H, scale=1 / np.sqrt(H)),
                b=f(H, scale=0.1), g=f(N, H, scale=1.0))


def _jax_side(p):
    """The blocked graph of the one sample, the padded node tables, the
    cotangent in tile layout, and the slot -> raw edge map."""
    H = p["pxj"].shape[1]
    g = jax.tree.map(lambda a: a[0], build_radius_graph_batch(
        p["pos"][None], RADIUS, loop=False))
    T, et = g.blk_recv_local.shape
    n_pad = T * 128

    def pad(a):
        out = np.zeros((n_pad, H), np.float32)
        out[:N] = a
        return jnp.asarray(out)

    key = p["r"].astype(np.int64) * N + p["s"]       # raw edges: sorted keys
    slot_key = (np.asarray(g.receivers).astype(np.int64) * N
                + np.asarray(g.senders))
    live = np.asarray(g.edge_mask) > 0
    e_idx = np.searchsorted(key, slot_key[live])
    assert (key[e_idx] == slot_key[live]).all() and live.sum() == len(key)
    return dict(g=g, T=T, et=et, pxj=pad(p["pxj"]),
                pr=pad(p["pr"]).reshape(T, 128, H), w=jnp.asarray(p["w"]),
                b=jnp.asarray(p["b"]), cot=pad(p["g"]).reshape(T, 128, H),
                live=live, e_idx=e_idx)


def _jax_2r(p, fn, interpret_tail):
    """Output and gradients of the in-kernel-gather entry on the JAX side,
    in the port's layout."""
    j = _jax_side(p)
    g = j["g"]
    tail = (g.blk_snd2_tids, g.blk_snd2_local, g.blk_recv_local,
            g.edge_mask.reshape(j["T"], j["et"]))
    if interpret_tail:
        tail += (g.blk_chunk_ct, g.blk_chunk_cc, g.blk_chunk_flag)
    ops = (j["pxj"], j["pr"], j["w"], j["b"])
    out = np.asarray(fn(*ops, *tail)).reshape(-1, p["w"].shape[0])[:N]
    d = jax.grad(lambda *o: jnp.sum(fn(*o, *tail) * j["cot"]),
                 argnums=(0, 1, 2, 3))(*ops)
    d = [np.asarray(a) for a in d]
    return out, (d[0][:N], d[1].reshape(-1, d[1].shape[-1])[:N], d[2], d[3])


def _jax_pregathered(p, fn):
    """The same for the pre-gathered entry; d_h0 comes back per raw edge."""
    j = _jax_side(p)
    g = j["g"]
    H = p["w"].shape[0]
    h0 = jnp.take(j["pxj"], g.senders, axis=0).reshape(j["T"], j["et"], H)
    tail = (g.blk_recv_local, g.edge_mask.reshape(j["T"], j["et"]))
    ops = (h0, j["pr"], j["w"], j["b"])
    out = np.asarray(fn(*ops, *tail)).reshape(-1, H)[:N]
    d = jax.grad(lambda *o: jnp.sum(fn(*o, *tail) * j["cot"]),
                 argnums=(0, 1, 2, 3))(*ops)
    d = [np.asarray(a) for a in d]
    d_h0 = np.zeros((len(p["s"]), H), np.float32)
    d_h0[j["e_idx"]] = d[0].reshape(-1, H)[j["live"]]
    return out, (d_h0, d[1].reshape(-1, H)[:N], d[2], d[3])


def _port_2r(p):
    graph = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]), N)
    ops = tuple(torch.from_numpy(p[k]) for k in ("pxj", "pr", "w", "b"))
    return (*ops, graph.senders, graph.rowptr), graph


def _port_pregathered(p):
    args, graph = _port_2r(p)
    h0 = args[0].index_select(0, graph.senders.long())
    return (h0, *args[1:4], graph.rowptr), graph


def _assert_all(got_out, got_grads, want_out, want_grads, names):
    np.testing.assert_allclose(got_out.numpy(), want_out, **OUT_TOL)
    np.testing.assert_array_equal(got_out[N // 2].numpy(), 0.0)
    assert len(got_grads) == len(names)
    for name, d, w in zip(names, got_grads, want_grads):
        assert d.dtype == torch.float32 and tuple(d.shape) == w.shape, name
        np.testing.assert_allclose(d.numpy(), w, err_msg=name, **GRAD_TOL)
    # the degree-0 node receives nothing
    np.testing.assert_array_equal(got_grads[1][N // 2].numpy(), 0.0)


@pytest.mark.parametrize("H", [16, 64])
def test_plain_2r_matches_jax_oracle(H):
    p = _problem(H, seed=H)
    want_out, want_grads = _jax_2r(p, pk._mpnn2r_ref_impl, False)
    args, graph = _port_2r(p)
    assert graph.degree[N // 2] == 0
    got = me.fused_mpnn_edge_agg2r_plain(*args)
    grads = me.fused_mpnn_edge_agg2r_bwd_plain(*args, torch.from_numpy(p["g"]))
    _assert_all(got, grads, want_out, want_grads, me.GRAD_NAMES_2R)


@pytest.mark.parametrize("H", [16, 64])
def test_plain_pregathered_matches_jax_oracle(H):
    p = _problem(H, seed=H + 1)
    want_out, want_grads = _jax_pregathered(p, pk._mpnn_ref_impl)
    args, _ = _port_pregathered(p)
    got = me.fused_mpnn_edge_agg_plain(*args)
    grads = me.fused_mpnn_edge_agg_bwd_plain(*args, torch.from_numpy(p["g"]))
    _assert_all(got, grads, want_out, want_grads, me.GRAD_NAMES)


@pytest.mark.parametrize("H", [16, 64])
def test_wrapper_cpu_2r_matches_pallas_interpret(monkeypatch, H):
    p = _problem(H, seed=H + 2)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want_out, want_grads = _jax_2r(p, pk.fused_mpnn_edge_agg2r, True)
    args, _ = _port_2r(p)
    before = dict(me.launches)
    got = me.fused_mpnn_edge_agg2r(*args)
    grads = me.fused_mpnn_edge_agg2r_bwd(*args, torch.from_numpy(p["g"]))
    assert me.launches == before  # CPU tensors launch no kernel
    _assert_all(got, grads, want_out, want_grads, me.GRAD_NAMES_2R)


@pytest.mark.parametrize("H", [16, 64])
def test_wrapper_cpu_pregathered_matches_pallas_interpret(monkeypatch, H):
    p = _problem(H, seed=H + 3)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want_out, want_grads = _jax_pregathered(p, pk.fused_mpnn_edge_agg)
    args, _ = _port_pregathered(p)
    before = dict(me.launches)
    got = me.fused_mpnn_edge_agg(*args)
    grads = me.fused_mpnn_edge_agg_bwd(*args, torch.from_numpy(p["g"]))
    assert me.launches == before
    _assert_all(got, grads, want_out, want_grads, me.GRAD_NAMES)


@pytest.mark.parametrize("entry", ["gather", "pregathered"])
def test_differentiable_wrappers_on_cpu_are_plain_autograd(entry):
    """On CPU tensors the wrappers are differentiable by ordinary autograd,
    give the plain backward's gradients and launch nothing; the autograd
    Functions themselves refuse a CPU tensor."""
    p = _problem(16, seed=5)
    g = torch.from_numpy(p["g"])
    if entry == "gather":
        args, _ = _port_2r(p)
        fn, bwd, func = (me.fused_mpnn_edge_agg2r,
                         me.fused_mpnn_edge_agg2r_bwd_plain,
                         me.FusedMPNNEdgeAgg2R)
    else:
        args, _ = _port_pregathered(p)
        fn, bwd, func = (me.fused_mpnn_edge_agg,
                         me.fused_mpnn_edge_agg_bwd_plain, me.FusedMPNNEdgeAgg)
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in args]
    before = dict(me.launches)
    out = fn(*leaves)
    assert out.grad_fn is not None
    out.backward(g)
    assert me.launches == before
    for leaf, w in zip(leaves[:4], bwd(*args, g)):
        np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy())
    with pytest.raises(ValueError, match="no fused MPNN kernel"):
        func.apply(*args)


def test_wrappers_reject_bad_operands():
    args, _ = _port_2r(_problem(16, seed=6))
    bad_dtype = list(args)
    bad_dtype[0] = args[0].double()
    with pytest.raises(TypeError):
        me.fused_mpnn_edge_agg2r(*bad_dtype)
    bad_shape = list(args)
    bad_shape[2] = args[2][:, :-1].contiguous()
    with pytest.raises(ValueError):
        me.fused_mpnn_edge_agg2r(*bad_shape)
    non_contig = list(args)
    non_contig[1] = torch.cat([args[1], args[1]], 1)[:, ::2]
    with pytest.raises(ValueError):
        me.fused_mpnn_edge_agg2r(*non_contig)
    bad_index = list(args)
    bad_index[4] = args[4].long()
    with pytest.raises(TypeError):
        me.fused_mpnn_edge_agg2r(*bad_index)
    pre, _ = _port_pregathered(_problem(16, seed=6))
    short = list(pre)
    short[0] = pre[0][:-1].contiguous()  # one edge row short of rowptr's end
    with pytest.raises(ValueError):
        me.fused_mpnn_edge_agg(*short)


def test_gradcheck_plain_forward_float64():
    """Finite differences of the plain forward in float64 on a tiny graph
    (one node of degree 0) agree with its autograd gradients."""
    rng = np.random.default_rng(7)
    pos = np.sort(rng.uniform(-1, 1, (12, 1)), axis=0)
    pos[5, 0] = 9.0
    s, r = radius_graph_np(pos, 0.4, loop=False)
    graph = csr_from_edges(torch.from_numpy(s), torch.from_numpy(r), 12)
    assert graph.n_edge > 0 and graph.degree[5] == 0
    ops = [torch.from_numpy(rng.normal(size=sh) * 0.5).requires_grad_()
           for sh in ((12, 8), (12, 8), (8, 8), (8,))]
    assert torch.autograd.gradcheck(
        me.fused_mpnn_edge_agg2r_plain, (*ops, graph.senders, graph.rowptr),
        eps=1e-6, atol=1e-5, rtol=1e-4)
