"""The backward of the port's fused edge pipeline (its plain version, and
the wrapper's CPU path) against the JAX package: ``jax.grad`` of the jnp
oracle ``_fused2re_ref_impl`` and of ``fused_edge_tail_agg2rf`` in Pallas
interpret mode, all eleven gradients by name.

One raw radius graph (with a node of degree 0) is packed twice, as in
``test_torch_fused_edge.py``; the JAX side's blocked gradients are mapped
back to raw edges and nodes.  Tolerance rtol 1e-3, atol 1e-4 (that of the
JAX package's own backward test): f32 on both sides, sums over ~1,700
edges taken in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu.ops.graph import block_graph  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from test_torch_fused_edge import _jax_side, _port_args, _problem  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4


def _g(p, seed=9):
    return np.random.default_rng(seed).normal(
        size=(p["n"], p["w_out"].shape[1])).astype(np.float32)


def _jax_grads(p, g, fn, extra=()):
    """Gradients of sum(fn(...) * g) on the JAX side, mapped to the port's
    layout: d_e0 per raw edge, d_pxj and d_pxi per node."""
    args, chunks, n = _jax_side(p)
    T = args[0].shape[0]
    C = g.shape[1]
    g_pad = np.zeros((T * 128, C), np.float32)
    g_pad[:n] = g
    gj = jnp.asarray(g_pad.reshape(T, 128, C))
    tail = args[11:] + list(extra(chunks) if extra else ())

    def loss(*w):
        return jnp.sum(fn(*w, *tail) * gj)

    grads = [np.asarray(d) for d in
             jax.grad(loss, argnums=tuple(range(11)))(*args[:11])]
    # blocked (T, et, Ce) -> raw edges, by the slot -> edge map of _jax_side
    blk = block_graph(p["s"], p["r"], n)
    et = blk.senders.shape[1]
    key = p["r"].astype(np.int64) * n + p["s"]
    slot_key = blk.receivers.reshape(T, et).astype(np.int64) * n + blk.senders
    live = blk.mask > 0
    d_e0 = np.zeros_like(p["e0"])
    d_e0[np.searchsorted(key, slot_key[live])] = grads[0][live]
    grads[0] = d_e0
    grads[3] = grads[3][:n]
    grads[4] = grads[4].reshape(-1, grads[4].shape[-1])[:n]
    return dict(zip(fe.GRAD_NAMES, grads))


def _assert_grads(got, want, p):
    assert len(got) == len(fe.GRAD_NAMES)
    for name, d in zip(fe.GRAD_NAMES, got):
        assert d.dtype == torch.float32 and tuple(d.shape) == want[name].shape
        np.testing.assert_allclose(d.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the degree-0 node receives nothing
    np.testing.assert_array_equal(got[4][p["n"] // 2].numpy(), 0.0)


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_plain_bwd_matches_jax_grad_of_oracle(L1):
    p = _problem(L1, seed=20 + L1)
    g = _g(p)
    want = _jax_grads(p, g, pk._fused2re_ref_impl)
    port_args, _ = _port_args(p)
    got = fe.fused_edge_tail_agg_bwd_plain(*port_args, torch.from_numpy(g))
    _assert_grads(got, want, p)


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_wrapper_cpu_bwd_matches_pallas_interpret(monkeypatch, L1):
    p = _problem(L1, seed=30 + L1)
    g = _g(p)
    dummy = jnp.zeros((1, 128), jnp.int32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want = _jax_grads(p, g, pk.fused_edge_tail_agg2rf,
                      extra=lambda chunks: (*chunks, dummy, dummy))
    port_args, _ = _port_args(p)
    before = fe.launches, fe.launches_bwd
    got = fe.fused_edge_tail_agg_bwd(*port_args, torch.from_numpy(g))
    assert (fe.launches, fe.launches_bwd) == before  # CPU: no kernel
    _assert_grads(got, want, p)


@pytest.mark.parametrize("L1", [0, 3])
def test_differentiable_wrapper_on_cpu_is_plain_autograd(L1):
    """On CPU tensors ``fused_edge_tail_agg`` is differentiable by ordinary
    autograd, gives the plain backward's gradients and launches nothing;
    the autograd Function itself refuses a CPU tensor."""
    p = _problem(L1, seed=40 + L1)
    g = torch.from_numpy(_g(p))
    port_args, _ = _port_args(p)
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in port_args]
    before = fe.launches, fe.launches_bwd
    out = fe.fused_edge_tail_agg(*leaves)
    assert out.grad_fn is not None
    out.backward(g)
    assert (fe.launches, fe.launches_bwd) == before
    want = fe.fused_edge_tail_agg_bwd_plain(*port_args, g)
    floats = [t for t in leaves if t.is_floating_point()]
    for name, leaf, w in zip(fe.GRAD_NAMES, floats, want):
        if leaf.numel():
            np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy(),
                                          err_msg=name)
    with pytest.raises(ValueError, match="no fused edge kernel"):
        fe.FusedEdgeTailAgg.apply(*port_args)


def test_gradcheck_plain_forward_float64():
    """Finite differences of the plain forward in float64 on a tiny graph
    (12 nodes, one of degree 0) agree with its autograd gradients."""
    p = _problem(1, n=12, Ce=4, H=8, C=4, seed=50)
    port_args, graph = _port_args(p)
    assert graph.n_edge > 0
    args = [t.double().requires_grad_() if t.is_floating_point() else t
            for t in port_args]
    assert torch.autograd.gradcheck(fe.fused_edge_tail_agg_plain, args,
                                    eps=1e-6, atol=1e-5, rtol=1e-4)
