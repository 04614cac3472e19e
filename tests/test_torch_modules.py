"""Each module of the port's MAgNet[CNN] 1D path against its magnet_tpu
counterpart, with the JAX weights carried over by
``magnet_tpu_torch.weights.state_dict_from_jax``.

Tolerance rtol 1e-4, atol 1e-5: f32 on both sides, with sums (matmuls,
convolutions, per-receiver aggregation) taken in another order.  Index
computations (nearest-neighbour taps) must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from magnet_tpu.models.common import batch_vmap  # noqa: E402
from magnet_tpu.models.common import build_radius_graph_batch as jax_graph  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.nn.core import MLP as JaxMLP  # noqa: E402
from magnet_tpu.nn.core import LayerNorm as JaxLayerNorm  # noqa: E402
from magnet_tpu.nn.edsr import EDSR as JaxEDSR  # noqa: E402
from magnet_tpu.nn.graphnet import GraphEncoder as JaxGraphEncoder  # noqa: E402
from magnet_tpu.nn.graphnet import GraphProcessor as JaxGraphProcessor  # noqa: E402
from magnet_tpu.nn.graphnet import InteractionNetwork as JaxInteraction  # noqa: E402
from magnet_tpu.nn.inr import INRDecoder1D as JaxINR  # noqa: E402
from magnet_tpu.ops import interp as jax_interp  # noqa: E402
from magnet_tpu.utils import make_coord_np as jax_make_coord_np  # noqa: E402
from magnet_tpu_torch.data import heat  # noqa: E402
from magnet_tpu_torch.data.heat import heat_batches  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.ops import interp  # noqa: E402
from magnet_tpu_torch.ops.graph import radius_graph_batch  # noqa: E402
from magnet_tpu_torch.utils import make_coord_np  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
HP = dict(time_slice=16, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, res_layers=1,
          kernel_size=3, res_scale=1, radius=0.08)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def models():
    """The JAX model's params (perturbed, so LayerNorm affines are not
    ones/zeros) and the port model loaded with them."""
    batch = heat_batches(2, 2, nt=48, nx=64, seed=3)[0]
    jm = jax_create_model("magnet_cnn", HP)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb, jm.build_graph(batch))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    tm = create_model("magnet_cnn", HP, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP))
    return params["params"], tm


def test_nearest_index_matches_jax_with_ties():
    n = 8
    # (2k+2)/n - 1 lands exactly on k + 0.5: ties round half to even
    ties = np.array([(2 * k + 2) / n - 1 for k in range(n - 1)], np.float32)
    rng = np.random.default_rng(1)
    gx = np.concatenate([ties, rng.uniform(-1.2, 1.2, 200).astype(np.float32),
                         np.float32([-1, 1])])
    want = np.asarray(jax_interp._nearest_index(jnp.asarray(gx), n))
    got = interp._nearest_index(torch.from_numpy(gx), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] == 2 and got[3] == 4  # 2.5 -> 2, 3.5 -> 4


@pytest.mark.parametrize("size", [16, 37, 74])
def test_interpolate_linear_1d_matches_jax(size):
    x = np.random.default_rng(2).normal(size=(3, 5, 37)).astype(np.float32)
    want = jax_interp.interpolate_linear_1d(jnp.asarray(x), size)
    close(interp.interpolate_linear_1d(torch.from_numpy(x), size), want)


def test_heat_eval_sample_matches_jax():
    """Same seed, same trajectory; the eval sample's LR support is the JAX
    dataset's linear resize of it."""
    from magnet_tpu.data import synthetic
    from magnet_tpu.data.datasets import _np_linear_resize_1d

    u, x, t = heat.solve_heat_1d(np.random.default_rng(5), nx=64, nt_out=48)
    u_j, x_j, t_j = synthetic.solve_heat_1d(np.random.default_rng(5), nx=64,
                                            nt_out=48)
    for a, b in ((u, u_j), (x, x_j), (t, t_j)):
        np.testing.assert_array_equal(a, b)
    s = heat.implicit_eval_sample(u, t)
    close(s["lr_frames"], _np_linear_resize_1d(u[:, None, :], 32))
    np.testing.assert_array_equal(s["hr_points"][:, :, 0], u)
    np.testing.assert_array_equal(s["coords"], jax_make_coord_np([64]))


def test_mlp_and_layernorm_match_jax(models):
    p, tm = models
    x = np.random.default_rng(3).normal(size=(5, 7, HP["n_chan"])).astype(np.float32)
    want = JaxMLP([HP["mlp_hidden"]] * HP["mlp_layers"], 1).apply(
        {"params": p["projector"]}, jnp.asarray(x))
    close(tm.projector(torch.from_numpy(x)).detach(), want)
    # large offset, small spread: the variance must be the two-pass one
    y = (100.0 + np.random.default_rng(4).normal(size=(6, HP["n_chan"]))).astype(np.float32)
    want = JaxLayerNorm().apply(
        {"params": p["continuous_decoder"]["LayerNorm_0"]}, jnp.asarray(y))
    close(tm.proj_head[1](torch.from_numpy(y)).detach(), want)


def test_edsr_matches_jax(models):
    p, tm = models
    x = np.random.default_rng(5).normal(size=(2, 32, 16)).astype(np.float32)
    want = JaxEDSR(n_chan=HP["n_chan"], res_layers=HP["res_layers"],
                   kernel_size=3, res_scale=1.0, ndim=1).apply(
        {"params": p["encoder"]}, jnp.asarray(x))                 # (B, L, Cf)
    got = tm.encoder(torch.from_numpy(x).transpose(1, 2)).detach()
    close(got.transpose(1, 2), want)


def test_inr_decoder_matches_jax(models):
    p, tm = models
    rng = np.random.default_rng(6)
    B, T, L, N = 2, 16, 32, 12
    x_t = rng.normal(size=(B, T, 1, L)).astype(np.float32)
    feat = rng.normal(size=(B, HP["n_chan"], L)).astype(np.float32)
    coords = rng.uniform(-1, 1, size=(B, N, 1)).astype(np.float32)
    # the last LR cell centre: both taps clip into that cell, den == 0
    coords[:, 0, 0] = make_coord_np([L])[-1, 0]
    coords[:, 1, 0] = make_coord_np([L])[0, 0]
    cell = np.full((B, N, 1), 2.0 / 64, np.float32)
    t = np.linspace(0, 1, 2 * T, dtype=np.float32)[None].repeat(B, 0)
    dec = JaxINR(n_chan=HP["n_chan"], mlp_layers=HP["mlp_layers"],
                 mlp_hidden=HP["mlp_hidden"])
    want = np.stack([np.asarray(dec.apply(
        {"params": p["continuous_decoder"]}, *map(jnp.asarray, (
            x_t[b], feat[b], cell[b], coords[b], t[b])))) for b in range(B)])
    got = tm.proj_head(*map(torch.from_numpy, (x_t, feat, cell, coords, t)))
    close(got.detach(), want)


def test_graph_encoder_matches_jax(models):
    p, tm = models
    rng = np.random.default_rng(7)
    nf = rng.normal(size=(40, 18)).astype(np.float32)
    ef = rng.normal(size=(90, 17)).astype(np.float32)
    want_n, want_e = JaxGraphEncoder(8, 8, HP["mlp_layers"], HP["mlp_hidden"]).apply(
        {"params": p["_encoder"]}, jnp.asarray(nf), jnp.asarray(ef))
    got_n, got_e = tm._encoder(torch.from_numpy(nf), torch.from_numpy(ef))
    close(got_n.detach(), want_n)
    close(got_e.detach(), want_e)


def _graph_pair(B=2, n=150, r=0.05, C=8, seed=8):
    """One radius graph per sample in magnet_tpu's blocked layout and in the
    port's flattened CSR, node latents x and edge latents e laid out for
    each (e scattered into the blocked slots of its raw edge)."""
    rng = np.random.default_rng(seed)
    coords = np.sort(rng.uniform(-1, 1, (B, n, 1)), axis=1).astype(np.float32)
    jg = jax_graph(coords, r, loop=True)
    tg = radius_graph_batch(torch.from_numpy(coords), r, loop=True)
    x = rng.normal(size=(B, n, C)).astype(np.float32)
    e_csr = rng.normal(size=(tg.n_edge, C)).astype(np.float32)
    send, recv = tg.senders.numpy(), tg.receivers.numpy()
    snd_b, rcv_b = np.asarray(jg.senders), np.asarray(jg.receivers)
    mask = np.asarray(jg.edge_mask) > 0
    e_blk = np.zeros(snd_b.shape + (C,), np.float32)
    for b in range(B):
        lo, hi = tg.rowptr[b * n].item(), tg.rowptr[(b + 1) * n].item()
        key = (recv[lo:hi] - b * n).astype(np.int64) * n + (send[lo:hi] - b * n)
        slot = rcv_b[b][mask[b]].astype(np.int64) * n + snd_b[b][mask[b]]
        idx = np.searchsorted(key, slot)
        assert (key[idx] == slot).all()
        e_blk[b][mask[b]] = e_csr[lo:hi][idx]
    return jg, tg, x, e_blk, e_csr


def test_interaction_network_step_matches_jax(models):
    p, tm = models
    jg, tg, x, e_blk, e_csr = _graph_pair()
    inet = batch_vmap(JaxInteraction, in_axes=(0, 0, 0, None), node_out=8,
                      edge_out=8, mlp_layers=HP["mlp_layers"],
                      mlp_hidden=HP["mlp_hidden"])
    step0 = jax.tree.map(lambda a: a[0], p["_processor"]["steps"]["step"])
    want, _ = inet.apply({"params": step0}, jnp.asarray(x), jnp.asarray(e_blk),
                         jg, 4.0)
    got = tm._processor.gnn_stacks[0](
        torch.from_numpy(x.reshape(-1, 8)), torch.from_numpy(e_csr), tg,
        e_scale=4.0)
    close(got.detach(), np.asarray(want).reshape(-1, 8))


def test_graph_processor_matches_jax(models):
    p, tm = models
    jg, tg, x, e_blk, e_csr = _graph_pair(seed=9)
    proc = batch_vmap(JaxGraphProcessor, in_axes=(0, 0, 0), latent_dim=8,
                      num_steps=HP["num_message_passing_steps"],
                      mlp_layers=HP["mlp_layers"], mlp_hidden=HP["mlp_hidden"])
    want, _ = proc.apply({"params": p["_processor"]}, jnp.asarray(x),
                         jnp.asarray(e_blk), jg)
    got = tm._processor(torch.from_numpy(x.reshape(-1, 8)),
                        torch.from_numpy(e_csr), tg)
    close(got.detach(), np.asarray(want).reshape(-1, 8))
