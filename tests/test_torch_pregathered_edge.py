"""The port's pregathered edge pipeline (kernels #2 and #3, through their
plain versions and the wrappers' CPU path) and its segment sum (kernel #1,
with the row gather whose backward it is) against the JAX package, run in
Pallas interpret mode as ``tests/test_ops.py`` runs it:

* ``fused_edge_tail_agg_pregathered`` against ``fused_edge_tail_agg``
  (``_fused_fwd_pallas``), the per-node sums and all eight gradients
  through ``jax.vjp`` (``_fused_bwd_pallas``);
* ``segment_sum`` over the port's sender CSR against ``blocked_segment_sum``
  (``_pallas_impl``) over the JAX package's sender-transpose layout
  (``snd_edge_ids`` / ``snd_local``), and ``GatherRows``' gradient against
  ``gather_sender``'s VJP.

One raw radius graph with a node of degree 0 is packed twice: by
``block_graph`` for the JAX side and by the port's CSR.  Tolerances:
forward rtol 1e-4, atol 1e-5; gradients rtol 1e-3, atol 1e-4 (those of
``test_torch_fused_edge*.py``: f32 on both sides, sums in another order);
the segment sums rtol 1e-5, atol 1e-6 (a few adds per row).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import build_radius_graph_batch  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu.ops.graph import block_graph  # noqa: E402
from magnet_tpu.ops.segment import (  # noqa: E402
    _transpose_sum_by_sender,
    gather_sender,
)
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops import segment as seg  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    csr_from_edges,
    radius_graph_batch,
)
from test_torch_fused_edge import _problem  # noqa: E402

FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=1e-3, atol=1e-4)
SEG = dict(rtol=1e-5, atol=1e-6)


def _slots(s, r, n, blk):
    """Raw edge (CSR order) of every live blocked slot, and the live mask."""
    T, et = blk.senders.shape
    key = r.astype(np.int64) * n + s
    slot_key = blk.receivers.reshape(T, et).astype(np.int64) * n + blk.senders
    live = blk.mask > 0
    e_idx = np.searchsorted(key, slot_key[live])
    assert (key[e_idx] == slot_key[live]).all()
    return e_idx, live


def _pregathered_problem(L1, seed):
    p = _problem(L1, seed=seed)
    rng = np.random.default_rng(seed + 100)
    p["h0"] = (rng.normal(size=(len(p["s"]), p["pxi"].shape[1])) * 0.3
               ).astype(np.float32)
    return p


def _tail(p):
    return [p[k] for k in ("w_rest", "b_rest", "w_out", "b_out", "ln_s",
                           "ln_b")]


@pytest.mark.parametrize("L1", [0, 3])
def test_pregathered_matches_pallas_interpret(monkeypatch, L1):
    p = _pregathered_problem(L1, seed=60 + L1)
    n, H = p["n"], p["pxi"].shape[1]
    blk = block_graph(p["s"], p["r"], n)
    T, et = blk.senders.shape
    e_idx, live = _slots(p["s"], p["r"], n, blk)
    h0 = np.zeros((T, et, H), np.float32)
    h0[live] = p["h0"][e_idx]
    pxi = np.zeros((T * 128, H), np.float32)
    pxi[:n] = p["pxi"]
    C = p["w_out"].shape[1]
    g = np.random.default_rng(L1).normal(size=(n, C)).astype(np.float32)
    g_pad = np.zeros((T * 128, C), np.float32)
    g_pad[:n] = g
    recv, mask = jnp.asarray(blk.recv_local), jnp.asarray(blk.mask)

    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    out, vjp = jax.vjp(
        lambda *a: pk.fused_edge_tail_agg(*a, recv, mask),
        jnp.asarray(h0), jnp.asarray(pxi.reshape(T, 128, H)),
        *map(jnp.asarray, _tail(p)))
    want = np.asarray(out).reshape(-1, C)[:n]
    d = [np.asarray(a) for a in vjp(jnp.asarray(g_pad.reshape(T, 128, C)))]
    want_grads = [d[0][live][np.argsort(e_idx)],
                  d[1].reshape(-1, H)[:n], *d[2:]]

    graph = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]), n)
    assert graph.degree[n // 2] == 0
    ops = (torch.from_numpy(p["h0"]), torch.from_numpy(p["pxi"]),
           graph.rowptr, *map(torch.from_numpy, _tail(p)))
    before = (fe.launches_pregathered, fe.launches_pregathered_bwd)
    got = fe.fused_edge_tail_agg_pregathered(*ops)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    np.testing.assert_array_equal(got[n // 2].numpy(), 0.0)
    got_grads = fe.fused_edge_tail_agg_pregathered_bwd(*ops, torch.from_numpy(g))
    assert (fe.launches_pregathered, fe.launches_pregathered_bwd) == before
    assert len(got_grads) == len(fe.GRAD_NAMES_PREGATHERED) == len(want_grads)
    for name, a, b in zip(fe.GRAD_NAMES_PREGATHERED, got_grads, want_grads):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, **BWD, err_msg=name)
    np.testing.assert_array_equal(got_grads[1][n // 2].numpy(), 0.0)


def test_pregathered_wrapper_on_cpu_is_plain_autograd():
    """On CPU tensors the wrapper is differentiable by ordinary autograd
    and launches nothing; the autograd Function refuses a CPU tensor, and
    a short h0 is refused before any kernel could read past it."""
    p = _pregathered_problem(1, seed=70)
    graph = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]),
                           p["n"])
    ops = [torch.from_numpy(p["h0"]).requires_grad_(),
           torch.from_numpy(p["pxi"]).requires_grad_(), graph.rowptr,
           *(torch.from_numpy(a).requires_grad_() for a in _tail(p))]
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(p["n"], p["w_out"].shape[1])).astype(np.float32))
    fe.fused_edge_tail_agg_pregathered(*ops).backward(g)
    want = fe.fused_edge_tail_agg_pregathered_bwd_plain(
        *(t.detach() for t in ops), g)
    floats = [t for t in ops if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES_PREGATHERED, floats, want):
        np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy(),
                                      err_msg=name)
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe.FusedEdgeTailAggPregathered.apply(*(t.detach() for t in ops))
    short = [t.detach() for t in ops]
    short[0] = short[0][:-1].contiguous()
    with pytest.raises(ValueError, match="edge rows"):
        fe.fused_edge_tail_agg_pregathered(*short)


def test_gradcheck_pregathered_plain_float64():
    """Finite differences of the plain forward in float64 on a tiny graph
    (12 nodes, one of degree 0) agree with its autograd gradients."""
    p = _problem(1, n=12, Ce=4, H=8, C=4, seed=80)
    graph = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]),
                           p["n"])
    assert graph.n_edge > 0
    h0 = np.random.default_rng(81).normal(size=(graph.n_edge, 8))
    args = [torch.from_numpy(h0).requires_grad_(),
            torch.from_numpy(p["pxi"]).double().requires_grad_(),
            graph.rowptr,
            *(torch.from_numpy(a).double().requires_grad_()
              for a in _tail(p))]
    assert torch.autograd.gradcheck(fe.fused_edge_tail_agg_pregathered_plain,
                                    args, eps=1e-6, atol=1e-5, rtol=1e-4)


def _sender_case(seed=5, n=300, C=24):
    """A 2D radius graph whose out-degrees range widely, in both layouts,
    and an edge cotangent per raw edge (CSR order)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (1, n, 2)).astype(np.float32)
    coords[0, 7] = (5.0, 5.0)      # isolated: sends and receives nothing
    gs = jax.tree.map(lambda a: a[0],
                      build_radius_graph_batch(coords, 0.3, loop=False))
    assert gs.blk_snd_edge_ids is not None
    graph = radius_graph_batch(torch.from_numpy(coords), 0.3, loop=False)
    s, r = graph.senders.numpy(), graph.receivers.numpy()
    T, et = gs.blk_recv_local.shape
    key = r.astype(np.int64) * n + s
    flat_key = (np.asarray(gs.receivers).astype(np.int64) * n
                + np.asarray(gs.senders))
    live = np.asarray(gs.edge_mask) > 0
    e_idx = np.searchsorted(key, flat_key[live])
    assert (key[e_idx] == flat_key[live]).all()
    d_csr = rng.normal(size=(graph.n_edge, C)).astype(np.float32)
    d_blk = np.zeros((T * et, C), np.float32)
    d_blk[live] = d_csr[e_idx]
    return gs, graph, d_csr, d_blk


def test_segment_sum_over_the_sender_csr_matches_blocked_segment_sum(
        monkeypatch):
    gs, graph, d_csr, d_blk = _sender_case()
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want = np.asarray(_transpose_sum_by_sender(jnp.asarray(d_blk), gs))
    before = seg.launches
    got = seg.segment_sum(torch.from_numpy(d_csr), graph.snd_ptr,
                          graph.snd_perm)
    assert seg.launches == before
    assert got.shape == (graph.n_node, d_csr.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **SEG)
    np.testing.assert_array_equal(got[7].numpy(), 0.0)
    out_deg = np.bincount(graph.senders.numpy(), minlength=graph.n_node)
    assert out_deg.max() >= 3 * max(out_deg.min(), 1)
    # without perm: the segments of x's own rows (the receiver CSR)
    by_recv = seg.segment_sum(torch.from_numpy(d_csr), graph.rowptr)
    recv = graph.receivers.numpy()
    want_r = np.zeros_like(got.numpy())
    np.add.at(want_r, recv, d_csr)
    np.testing.assert_allclose(by_recv.numpy(), want_r, **SEG)
    with pytest.raises(ValueError, match="items"):
        seg.segment_sum(torch.from_numpy(d_csr[:-1]), graph.rowptr)


def test_gather_rows_gradient_matches_gather_sender_vjp(monkeypatch):
    gs, graph, d_csr, d_blk = _sender_case(seed=6, C=16)
    rng = np.random.default_rng(0)
    p = rng.normal(size=(graph.n_node, 16)).astype(np.float32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    _, vjp = jax.vjp(lambda a: gather_sender(a, gs), jnp.asarray(p))
    want = np.asarray(vjp(jnp.asarray(d_blk))[0])
    leaf = torch.from_numpy(p).requires_grad_()
    rows = seg.gather_rows(leaf, graph)
    np.testing.assert_array_equal(rows.detach().numpy(),
                                  p[graph.senders.numpy()])
    rows.backward(torch.from_numpy(d_csr))
    np.testing.assert_allclose(leaf.grad.numpy(), want, **SEG)
