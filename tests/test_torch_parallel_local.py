"""The port's graph parallelism in one process: the all-gather and halo
processors on the single-process graph axis (``parallel.mesh.
LocalGraphAxis``) against the JAX package's ``make_partitioned_processor``
/ ``make_partitioned_processor_halo`` on its virtual-device mesh, and every
partitioned model against its unpartitioned self (the buffers are
``tests/test_torch_parallel_buffers.py``'s).

Tolerances.  Processor against JAX: rtol 1e-4, atol 1e-5 (a module, f32 on
both sides, sums in another order: the port's module parity tests'
bound).  Partitioned against unpartitioned in the port (the same kernels'
plain versions; only the order of the sums differs): loss rtol 1e-5,
every gradient rtol 1e-4 with atol 1e-4 of its leaf's largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from magnet_tpu.models.partitioned_mixin import (  # noqa: E402
    run_partitioned_processor as jax_run_processor,
)
from magnet_tpu.parallel import graph_partition as jgp  # noqa: E402
from magnet_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from magnet_tpu.train.import_torch import import_magnet_cnn  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicit1D  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.parallel import graph_partition as tgp  # noqa: E402
from magnet_tpu_torch.parallel.mesh import LocalGraphAxis  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

MOD = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4, 1e-4
HP = dict(time_slice=16, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, res_layers=1,
          kernel_size=3, res_scale=1, radius=0.08)


def _batch(seed=3, n=2):
    ds = DatasetImplicit1D(make_split("Heat", n, 64, 64, seed=seed), "train",
                           nt=64, nx=64, samples=16)
    ds.set_epoch(seed)
    return collate([ds[i] for i in range(n)])


@pytest.fixture(scope="module")
def cnn_pair():
    """JAX params (a seeded port model's weights, mapped by
    ``import_magnet_cnn``: no JAX init to compile) and the port's model
    with them, by ``state_dict_from_jax``; a batch."""
    params = import_magnet_cnn(
        {k: v.numpy().copy() for k, v in create_model(
            "magnet_cnn", HP, device="cpu", seed=1).state_dict().items()}, HP)
    tm = create_model("magnet_cnn", HP, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP))
    return params, tm, _batch()


@pytest.mark.parametrize("shards,halo", [(2, False), (2, True), (4, False),
                                         (4, True)])
def test_local_processor_matches_jax(cnn_pair, shards, halo):
    """The processor over the single-process graph axis against the JAX
    package's all-gather / halo processor on a (1, G) virtual-device mesh,
    the same node latents, edge latents and weights."""
    params, tm, batch = cnn_pair
    coords = tm._graph_coords(to_device(batch, "cpu"))
    bsz, n = coords.shape[:2]
    raw = tgp.radius_edges(coords, HP["radius"], True)
    rng = np.random.default_rng(7)
    c = HP["latent_dim"]
    nf = rng.normal(size=(bsz, n, c)).astype(np.float32)
    p_tab, q_tab = (rng.normal(size=(bsz, n, c)).astype(np.float32)
                    for _ in range(2))

    jpg = jgp.build_partition_buffers(raw, n, shards, halo=halo)
    mesh = jax_make_mesh(dp=1, graph=shards, devices=jax.devices()[:shards])
    eg = NamedSharding(mesh, P("dp", "graph"))
    for k in ("senders", "recv_loc", "mask", "table", "senders_remap",
              "halo_idx"):
        if k in jpg:
            jpg[k] = jax.device_put(jpg[k], eg)
    take = jax.vmap(lambda a, i: a[i])
    ef = (take(jnp.asarray(p_tab), jpg["senders_flat"])
          - take(jnp.asarray(q_tab), jpg["receivers_flat"]))
    want = jax.jit(lambda x, e, w: jax_run_processor(
        x, e, jpg, mesh, w, HP["num_message_passing_steps"],
        HP["mlp_layers"], HP["mlp_hidden"]))(
        jnp.asarray(nf), ef, params["params"]["_processor"]["steps"]["step"])

    pg = tgp.build_partition_buffers(raw, n, shards, halo=halo)
    part = tgp.partitioned_graph(pg, LocalGraphAxis(shards))
    assert len(part.shards) == shards and part.halo is halo
    flat = lambda a: torch.from_numpy(a).reshape(bsz * n, c)  # noqa: E731
    efs = [flat(p_tab)[sg.senders_glob] - flat(q_tab)[sg.receivers_glob]
           for sg in part.shards]
    with torch.no_grad():
        got = tgp.graphnet_processor(tm._processor, flat(nf), efs, part)
    np.testing.assert_allclose(got.reshape(bsz, n, c).numpy(),
                               np.asarray(want), **MOD)


def _loss_and_grads(model, batch, graph, **kw):
    model.zero_grad()
    model.train()
    loss, metrics = model.loss(batch, graph, train=True, **kw)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.eval()
    val, _ = model.loss(batch, graph, train=False)
    return loss.item(), val.item(), grads


def _assert_partitioned_matches(model, batch, graph, part, **kw):
    loss, val, grads = _loss_and_grads(model, batch, graph, **kw)
    p_loss, p_val, p_grads = _loss_and_grads(model, batch, part, **kw)
    np.testing.assert_allclose(p_loss, loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(p_val, val, rtol=LOSS_RTOL)
    assert sorted(p_grads) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(
            p_grads[k].numpy(), g.numpy(), rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * float(g.abs().max()), err_msg=k)


@pytest.mark.parametrize("shards,halo", [(2, False), (3, True), (4, "fused")])
def test_cnn1d_partitioned_matches_unpartitioned(cnn_pair, shards, halo):
    _, tm, batch = cnn_pair
    tb = to_device(batch, "cpu")
    part = tm.build_graph_partitioned(tb, shards, halo=halo)
    assert part.lanes() == ["fold"] * shards
    assert sum(part.edge_counts()) == tm.build_graph(tb).n_edge
    _assert_partitioned_matches(tm, tb, tm.build_graph(tb), part)


def _model(name, hp, kind=None):
    return create_model(name, hp, device="cpu", seed=2, kind=kind)


def test_cnn2d_partitioned_matches_unpartitioned():
    from magnet_tpu_torch.data.datasets import DatasetImplicit2D

    arrays = make_split("B2D", 2, 20, 16, seed=4)
    ds = DatasetImplicit2D(arrays, "train", nt=20, res=16, samples=16)
    ds.set_epoch(0)
    tb = to_device(collate([ds[0], ds[1]]), "cpu")
    hp = dict(HP, time_slice=4, radius=0.3)
    tm = _model("magnet_cnn_2d", hp)
    part = tm.build_graph_partitioned(tb, 2, halo=True)
    _assert_partitioned_matches(tm, tb, tm.build_graph(tb), part)


def test_gnn_partitioned_matches_unpartitioned_with_noise():
    """Both radius graphs partitioned; the noise drawn from the model's own
    generator in the same sequence on both paths."""
    rng = np.random.default_rng(17)
    B, nt, L, N, ts = 2, 12, 24, 10, 4
    tb = {"t": torch.linspace(0, 1, nt).repeat(B, 1),
          "lr_frames": torch.from_numpy(
              rng.normal(size=(B, nt, 1, L)).astype(np.float32)),
          "hr_points": torch.from_numpy(
              rng.normal(size=(B, nt, N, 1)).astype(np.float32)),
          "coords_lr": torch.from_numpy(
              rng.uniform(-1, 1, (B, L, 2)).astype(np.float32)),
          "coords_hr": torch.from_numpy(
              rng.uniform(-1, 1, (B, N, 2)).astype(np.float32))}
    hp = dict(time_slice=ts, latent_dim=8, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=8, radius=0.7,
              codec_neighbors=2, noise=0.01)
    tm = _model("magnet_gnn", hp, kind="h5_implicit_gnn_2d")
    part = tm.build_graph_partitioned(tb, 2, halo=True)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    loss, _, grads = _loss_and_grads(tm, tb, tm.build_graph(tb),
                                     generator=gens[0])
    p_loss, _, p_grads = _loss_and_grads(tm, tb, part, generator=gens[1])
    np.testing.assert_allclose(p_loss, loss, rtol=LOSS_RTOL)
    for k, g in grads.items():
        np.testing.assert_allclose(
            p_grads[k].numpy(), g.numpy(), rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * float(g.abs().max()), err_msg=k)


@pytest.mark.parametrize("name", ["mpnn", "mpnn_2d"])
def test_mpnn_partitioned_matches_unpartitioned(name):
    """The global InstanceNorm: each sample's statistics summed over the
    shards (a one-pass variance against the unpartitioned two-pass one)."""
    rng = np.random.default_rng(19)
    tw = 10
    if name == "mpnn":
        B, N, nt = 2, 30, 2 * tw
        x = np.linspace(0, 16, N, dtype=np.float32)[None, :, None].repeat(B, 0)
        hp = dict(hidden_features=128, hidden_layer=2, time_window=tw,
                  neighbors=2)
    else:
        W = 6
        B, N, nt = 2, W * W, 2 * tw
        gx, gy = np.meshgrid(np.linspace(0, 2, W), np.linspace(0, 2, W),
                             indexing="ij")
        x = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)[
            None].repeat(B, 0)
        hp = dict(hidden_features=128, hidden_layer=2, time_window=tw,
                  neighbors=1)
    tb = {"u": torch.from_numpy(rng.normal(size=(B, N, nt)).astype(np.float32)),
          "x": torch.from_numpy(x),
          "t": torch.linspace(0, 2, nt).repeat(B, 1)}
    tm = _model(name, hp)
    part = tm.build_graph_partitioned(tb, 3)
    assert not part.halo and part.lanes() == [tm.build_graph(tb).lane] * 3
    _assert_partitioned_matches(tm, tb, tm.build_graph(tb), part)
