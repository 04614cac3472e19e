"""The port's fused edge pipeline (plain version, and the wrapper's CPU path)
vs the JAX package's fold-e kernel: its jnp oracle ``_fused2re_ref_impl``
and ``fused_edge_tail_agg2rf`` run in Pallas interpret mode.

One raw radius graph is packed twice: by magnet_tpu's blocked tile layout
for the JAX side and by the port's CSR for the port; the per-node sums are
compared.  Tolerance rtol 1e-4, atol 1e-5: both sides are f32, with the
matmuls and the per-receiver sums taken in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import _chunk_list  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu.ops.graph import block_graph, radius_graph_np  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops.graph import csr_from_edges  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _problem(L1, n=200, Ce=16, H=32, C=8, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.uniform(-1, 1, (n, 1)), axis=0).astype(np.float32)
    pos[n // 2, 0] = 9.0  # isolated, and loop=False: a node of degree 0
    s, r = radius_graph_np(pos, 0.04, loop=False)

    def f(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    w = dict(we=f(Ce, H), be=f(H), w_rest=f(L1, H, H), b_rest=f(L1, H),
             w_out=f(H, C), b_out=f(C), ln_s=1 + f(C, scale=0.1),
             ln_b=f(C, scale=0.1))
    return dict(n=n, s=s, r=r, e0=f(len(s), Ce), pxj=f(n, H), pxi=f(n, H), **w)


def _jax_side(p):
    """Blocked-layout operands for the JAX kernel, e0 scattered into the
    tile slots of its raw edges."""
    n, H = p["n"], p["pxj"].shape[1]
    g = block_graph(p["s"], p["r"], n)
    T, et = g.senders.shape
    n_pad = T * 128
    key = p["r"].astype(np.int64) * n + p["s"]          # raw edges: sorted keys
    slot_key = g.receivers.reshape(T, et).astype(np.int64) * n + g.senders
    live = g.mask > 0
    e_idx = np.searchsorted(key, slot_key[live])
    assert (key[e_idx] == slot_key[live]).all()
    e0 = np.zeros((T, et, p["e0"].shape[1]), np.float32)
    e0[live] = p["e0"][e_idx]
    pxj = np.zeros((n_pad, H), np.float32)
    pxj[:n] = p["pxj"]
    pxi = np.zeros((n_pad, H), np.float32)
    pxi[:n] = p["pxi"]
    ct, cc, fl = _chunk_list(g.snd2_tids)
    args = [jnp.asarray(a) for a in (
        e0, p["we"], p["be"], pxj, pxi.reshape(T, 128, H), p["w_rest"],
        p["b_rest"], p["w_out"], p["b_out"], p["ln_s"], p["ln_b"],
        g.snd2_tids, g.snd2_local, g.recv_local, g.mask)]
    return args, [jnp.asarray(a) for a in (ct, cc, fl)], n


def _port_args(p):
    g = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]), p["n"])
    t = {k: torch.from_numpy(p[k]) for k in
         ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest", "w_out",
          "b_out", "ln_s", "ln_b")}
    return (t["e0"], t["we"], t["be"], t["pxj"], t["pxi"], g.senders,
            g.rowptr, t["w_rest"], t["b_rest"], t["w_out"], t["b_out"],
            t["ln_s"], t["ln_b"]), g


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_plain_matches_jax_oracle(L1):
    p = _problem(L1)
    args, _, n = _jax_side(p)
    want = np.asarray(pk._fused2re_ref_impl(*args)).reshape(-1, p["w_out"].shape[1])[:n]
    port_args, g = _port_args(p)
    got = fe.fused_edge_tail_agg_plain(*port_args).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert g.degree[n // 2] == 0
    np.testing.assert_array_equal(got[n // 2], 0.0)


@pytest.mark.parametrize("L1", [0, 1, 3])
def test_wrapper_cpu_matches_pallas_interpret(monkeypatch, L1):
    p = _problem(L1, seed=L1 + 1)
    args, chunks, n = _jax_side(p)
    dummy = jnp.zeros((1, 128), jnp.int32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want = np.asarray(pk.fused_edge_tail_agg2rf(*args, *chunks, dummy, dummy))
    want = want.reshape(-1, p["w_out"].shape[1])[:n]
    port_args, _ = _port_args(p)
    before = fe.launches
    got = fe.fused_edge_tail_agg(*port_args).numpy()
    assert fe.launches == before  # the CPU path launches no kernel
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_bad_operands():
    port_args, _ = _port_args(_problem(1))
    args = list(port_args)
    bad_dtype = list(args)
    bad_dtype[0] = args[0].double()
    with pytest.raises(TypeError):
        fe.fused_edge_tail_agg(*bad_dtype)
    bad_shape = list(args)
    bad_shape[1] = args[1][:, :-1].contiguous()
    with pytest.raises(ValueError):
        fe.fused_edge_tail_agg(*bad_shape)
    non_contig = list(args)
    non_contig[3] = torch.cat([args[3], args[3]], 1)[:, ::2]
    with pytest.raises(ValueError):
        fe.fused_edge_tail_agg(*non_contig)
    bad_index = list(args)
    bad_index[5] = args[5].long()
    with pytest.raises(TypeError):
        fe.fused_edge_tail_agg(*bad_index)
