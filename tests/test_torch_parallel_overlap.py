"""The interior/boundary overlap split of the port's graph parallelism
(``graph_halo="overlap"``) and its ring (``"ring"``) in one process, and
the repairs that came with them (the overlap buffers are
``tests/test_torch_overlap_buffers.py``'s; the ring, which differs from
the all-to-all only across processes, is held to it over gloo ranks in
``tests/test_torch_parallel_dist.py``).

* The processor on the single-process graph axis (``LocalGraphAxis``)
  against the JAX package's overlap processor on its (1, G) virtual mesh,
  G = 2 and 4, and against its ring (``MAGNET_TPU_HALO_RING=1``) at G = 4.
* Partitioned against whole: MAgNet[CNN] 1D (G = 2, 4), 2D and MAgNet[GNN]
  (noise on) with ``overlap``; a shard whose boundary has no edge and a
  shard with no edge at all; MPNN takes its all-gather whatever the mode,
  as in the JAX package.
* MAgNet[CNN] 1D with ``graph_dtype=bf16`` partitioned against the JAX
  package's partitioned bf16 step, whose processor computes in f32: the
  processor alone on bf16 latents, and the losses.
* The launcher's rank functions default to the card.

Tolerances.  Processor against JAX: rtol 1e-4, atol 1e-5 (a module, f32 on
both sides, sums in another order), on bf16 latents too.  Partitioned
against whole in the port (only the order of the sums differs): loss rtol
1e-5, every gradient rtol 1e-4 with atol 1e-4 of its leaf's largest
entry.  The partitioned bf16 losses against JAX: rtol 3e-4 (f32 processors
on both sides, the bf16 encoder and decoder's sums in another order: the
validation loss reads 1.1e-4; a bf16 processor puts it 1.2e-3 away).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.models.partitioned_mixin import (  # noqa: E402
    run_partitioned_processor as jax_run_processor,
)
from magnet_tpu.parallel import graph_partition as jgp  # noqa: E402
from magnet_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from magnet_tpu.train.import_torch import import_magnet_cnn  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicit2D  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.parallel import graph_partition as tgp  # noqa: E402
from magnet_tpu_torch.parallel import launch  # noqa: E402
from magnet_tpu_torch.parallel.mesh import LocalGraphAxis  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from test_torch_parallel_local import (  # noqa: E402,F401
    HP,
    MOD,
    _assert_partitioned_matches,
    _batch,
    _loss_and_grads,
    _model,
    cnn_pair,
)

BF16_LOSS_RTOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its ops are small, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERLAP_KEYS = ("remap_int", "recv_int", "mask_int", "t_int", "remap_bnd",
                "recv_bnd", "mask_bnd", "t_bnd", "degree", "halo_idx")


def _latents(bsz, n, c, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bsz, n, c)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("shards,ring", [(2, False), (4, False), (4, True)])
def test_overlap_processor_matches_jax(cnn_pair, monkeypatch, shards, ring):
    """The overlap processor over the single-process graph axis against the
    JAX package's on a (1, G) virtual-device mesh (its ring under
    ``MAGNET_TPU_HALO_RING=1``), the same node latents, edge latents and
    weights."""
    params, tm, batch = cnn_pair
    coords = tm._graph_coords(to_device(batch, "cpu"))
    bsz, n = coords.shape[:2]
    c = HP["latent_dim"]
    raw = tgp.radius_edges(coords, HP["radius"], True)
    nf, p_tab, q_tab = _latents(bsz, n, c)

    monkeypatch.setenv("MAGNET_TPU_HALO_RING", "1" if ring else "0")
    jpg = jgp.build_partition_buffers(raw, n, shards, halo="overlap")
    mesh = jax_make_mesh(dp=1, graph=shards, devices=jax.devices()[:shards])
    eg = NamedSharding(mesh, P("dp", "graph"))
    for k in OVERLAP_KEYS:
        jpg[k] = jax.device_put(jpg[k], eg)
    take = jax.vmap(lambda a, i: a[i])
    ef = jnp.concatenate(
        [take(jnp.asarray(p_tab), jpg[f"senders_flat_{r}"])
         - take(jnp.asarray(q_tab), jpg[f"receivers_flat_{r}"])
         for r in ("int", "bnd")], axis=1)
    want = jax.jit(lambda x, e, w: jax_run_processor(
        x, e, jpg, mesh, w, HP["num_message_passing_steps"],
        HP["mlp_layers"], HP["mlp_hidden"]))(
        jnp.asarray(nf), ef, params["params"]["_processor"]["steps"]["step"])

    pg = tgp.build_partition_buffers(raw, n, shards,
                                     halo="ring" if ring else "overlap")
    part = tgp.partitioned_graph(pg, LocalGraphAxis(shards), ring=ring)
    assert part.exchange == ("ring" if ring else "overlap") and part.halo
    assert all(len(lane) == 2 for lane in part.lanes())
    flat = lambda a: torch.from_numpy(a).reshape(bsz * n, c)  # noqa: E731
    efs = []
    for sg in part.shards:
        s, r = sg.edge_endpoints()
        efs.append(flat(p_tab)[s] - flat(q_tab)[r])
    with torch.no_grad():
        got = tgp.graphnet_processor(tm._processor, flat(nf), efs, part)
    np.testing.assert_allclose(got.reshape(bsz, n, c).numpy(),
                               np.asarray(want), **MOD)


@pytest.mark.parametrize("shards", [2, 4])
def test_cnn1d_overlap_matches_whole(cnn_pair, shards):
    """MAgNet[CNN] 1D over the overlap split against the whole graph; the
    two regions hold every edge once."""
    _, tm, batch = cnn_pair
    tb = to_device(batch, "cpu")
    whole = tm.build_graph(tb)
    part = tm.build_graph_partitioned(tb, shards, halo="overlap")
    assert part.lanes() == [("fold", "fold")] * shards
    assert sum(sum(c) for c in part.edge_counts()) == whole.n_edge
    assert all(b > 0 for _, b in part.edge_counts())
    _assert_partitioned_matches(tm, tb, whole, part)


def test_cnn2d_overlap_matches_whole():
    arrays = make_split("B2D", 2, 20, 16, seed=4)
    ds = DatasetImplicit2D(arrays, "train", nt=20, res=16, samples=16)
    ds.set_epoch(0)
    tb = to_device(collate([ds[0], ds[1]]), "cpu")
    tm = _model("magnet_cnn_2d", dict(HP, time_slice=4, radius=0.3))
    part = tm.build_graph_partitioned(tb, 2, halo="overlap")
    _assert_partitioned_matches(tm, tb, tm.build_graph(tb), part)


def _gnn_batch():
    rng = np.random.default_rng(17)
    B, nt, L, N = 2, 12, 24, 10
    return {"t": torch.linspace(0, 1, nt).repeat(B, 1),
            "lr_frames": torch.from_numpy(
                rng.normal(size=(B, nt, 1, L)).astype(np.float32)),
            "hr_points": torch.from_numpy(
                rng.normal(size=(B, nt, N, 1)).astype(np.float32)),
            "coords_lr": torch.from_numpy(
                rng.uniform(-1, 1, (B, L, 2)).astype(np.float32)),
            "coords_hr": torch.from_numpy(
                rng.uniform(-1, 1, (B, N, 2)).astype(np.float32))}


def test_gnn_overlap_matches_whole_with_noise():
    """Both radius graphs of MAgNet[GNN] over the overlap split, the noise
    drawn in the same sequence on both paths."""
    tb = _gnn_batch()
    hp = dict(time_slice=4, latent_dim=8, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=8, radius=0.7,
              codec_neighbors=2, noise=0.01)
    tm = _model("magnet_gnn", hp, kind="h5_implicit_gnn_2d")
    part = tm.build_graph_partitioned(tb, 2, halo="overlap")
    assert part.lr.exchange == part.all.exchange == "overlap"
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    loss, _, grads = _loss_and_grads(tm, tb, tm.build_graph(tb),
                                     generator=gens[0])
    p_loss, _, p_grads = _loss_and_grads(tm, tb, part, generator=gens[1])
    np.testing.assert_allclose(p_loss, loss, rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(
            p_grads[k].numpy(), g.numpy(), rtol=1e-4,
            atol=1e-4 * float(g.abs().max()), err_msg=k)


def _clusters(n_isolated, n_joined, gap=1.0, dx=0.01):
    """1D nodes: ``n_isolated`` points, then ``n_joined`` points ``gap``
    away, each spaced ``dx``; radius graph of 1.5 dx with self loops."""
    x = np.concatenate([np.arange(n_isolated) * dx,
                        gap + np.arange(n_joined) * dx])
    pos = np.stack([x, np.zeros_like(x)], -1)[None]
    return tgp.radius_edges(pos, 1.5 * dx, True), len(x)


@pytest.mark.parametrize("n_isolated,n_joined,shards",
                         [(8, 14, 3), (3, 2, 4)],
                         ids=["empty_boundary", "empty_shard"])
def test_empty_regions(cnn_pair, n_isolated, n_joined, shards):
    """A shard whose nodes have no halo sender (its boundary region has no
    edge: 8 isolated nodes, shard 0 of G = 3), and a shard with no node at
    all (5 nodes over G = 4: ns = 2): the overlap processor, forward and
    gradients, against the halo processor on the same buffers."""
    _, tm, _ = cnn_pair
    raw, n = _clusters(n_isolated, n_joined)
    c = HP["latent_dim"]
    nf, p_tab, q_tab = (torch.from_numpy(a[0]) for a in _latents(1, n, c))
    outs = []
    for mode in ("overlap", True):
        pg = tgp.build_partition_buffers(raw, n, shards, halo=mode)
        part = tgp.partitioned_graph(pg, LocalGraphAxis(shards),
                                     lane_rule=tm.graphs.lane_rule)
        if mode == "overlap":
            counts = part.edge_counts()
            empty = counts[0][1] if n_isolated == 8 else sum(counts[-1])
            assert empty == 0, counts
            assert all(isinstance(lane, tuple) for lane in part.lanes())
        x = nf.clone().requires_grad_()
        efs = []
        for sg in part.shards:
            s, r = sg.edge_endpoints()
            efs.append(p_tab[s] - q_tab[r])
        tm.zero_grad()
        y = tgp.graphnet_processor(tm._processor, x, efs, part)
        (y * torch.cos(y)).sum().backward()
        outs.append((y.detach(), x.grad,
                     {k: p.grad.clone() for k, p in
                      tm._processor.named_parameters()}))
    (y, dx, grads), (y_h, dx_h, grads_h) = outs
    np.testing.assert_allclose(y.numpy(), y_h.numpy(), **MOD)
    np.testing.assert_allclose(dx.numpy(), dx_h.numpy(), **MOD)
    for k, g in grads_h.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), **MOD,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["overlap", "ring"])
def test_mpnn_takes_its_all_gather_whatever_the_mode(mode):
    """As the JAX package builds MPNN's all-gather buffers whatever ``halo``
    is, the port's ``overlap`` and ``ring`` give its all-gather step, bit
    for bit."""
    rng = np.random.default_rng(19)
    W, tw = 6, 10
    gx, gy = np.meshgrid(np.linspace(0, 2, W), np.linspace(0, 2, W),
                         indexing="ij")
    x = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    tb = {"u": torch.from_numpy(
              rng.normal(size=(2, W * W, 2 * tw)).astype(np.float32)),
          "x": torch.from_numpy(x[None].repeat(2, 0)),
          "t": torch.linspace(0, 2, 2 * tw).repeat(2, 1)}
    tm = _model("mpnn_2d", dict(hidden_features=128, hidden_layer=2,
                                time_window=tw, neighbors=1))
    part = tm.build_graph_partitioned(tb, 2, halo=mode)
    assert part.exchange == "all_gather"
    got = _loss_and_grads(tm, tb, part)
    want = _loss_and_grads(tm, tb, tm.build_graph_partitioned(tb, 2))
    assert got[:2] == want[:2]
    for k, g in want[2].items():
        assert torch.equal(got[2][k], g), k


def test_partitioned_bf16_step_matches_jax(capsys):
    """MAgNet[CNN] 1D with graph_dtype=bf16, G = 2 (halo), against the JAX
    package on its (1, 2) virtual mesh, the same weights.  The JAX
    partitioned processor builds its steps with no dtype, so it computes in
    f32 on the bf16 latents; the port runs its f32 steps there
    (``GraphProcessor.f32_steps``), which share the model's parameters.
    First the processor alone on the same bf16 node and edge latents, at
    the module bound; then ``loss_partitioned``, train and validation.
    The distance to the port's whole-graph bf16 step is printed for
    context."""
    hp = dict(HP, graph_dtype="bf16")
    tm = create_model("magnet_cnn", hp, device="cpu", seed=1)
    params = import_magnet_cnn(
        {k: v.numpy().copy() for k, v in tm.state_dict().items()}, hp)
    batch = _batch()
    jm = jax_create_model("magnet_cnn", hp)
    mesh = jax_make_mesh(dp=1, graph=2, devices=jax.devices()[:2])
    jpg = jm.build_graph_partitioned(batch, n_shards=2, halo=True)
    eg = NamedSharding(mesh, P("dp", "graph"))
    for k in ("senders", "recv_loc", "mask", "table", "senders_remap",
              "halo_idx"):
        jpg[k] = jax.device_put(jpg[k], eg)

    tb = to_device(batch, "cpu")
    part = tm.build_graph_partitioned(tb, 2, halo=True)
    bsz, n = tm._graph_coords(tb).shape[:2]
    c = hp["latent_dim"]
    nf, p_tab, q_tab = _latents(bsz, n, c)
    take = jax.vmap(lambda a, i: a[i])
    ef = (take(jnp.asarray(p_tab), jnp.asarray(jpg["senders_flat"]))
          - take(jnp.asarray(q_tab), jnp.asarray(jpg["receivers_flat"])))
    want_y = jax.jit(lambda x, e, w: jax_run_processor(
        x, e, jpg, mesh, w, hp["num_message_passing_steps"],
        hp["mlp_layers"], hp["mlp_hidden"]))(
        jnp.asarray(nf, jnp.bfloat16), ef.astype(jnp.bfloat16),
        params["params"]["_processor"]["steps"]["step"])
    flat = lambda a: torch.from_numpy(a).reshape(bsz * n, c)  # noqa: E731
    efs = [(flat(p_tab)[sg.senders_glob] - flat(q_tab)[sg.receivers_glob])
           .bfloat16() for sg in part.shards]
    with torch.no_grad():
        y = tgp.graphnet_processor(tm._processor, flat(nf).bfloat16(), efs,
                                   part)
    assert want_y.dtype == jnp.float32 and y.dtype == torch.float32
    np.testing.assert_allclose(y.reshape(bsz, n, c).numpy(),
                               np.asarray(want_y), **MOD)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(lambda p, train: jm.loss_partitioned(p, jb, jpg, mesh,
                                                      train=train)[0],
                 static_argnums=1)
    want = {train: float(fn(params, train)) for train in (True, False)}

    steps = tm._processor.f32_steps()
    assert steps is tm._processor.f32_steps()
    assert all(s.dtype is None and set(map(id, s.parameters()))
               <= set(map(id, tm.parameters())) for s in steps)
    tm.train()
    tm.zero_grad()
    loss = tm.loss(tb, part, train=True)[0]
    loss.backward()
    for k, p in tm._processor.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k
    tm.eval()
    got = {True: loss.item(), False: tm.loss(tb, part, train=False)[0].item()}
    tm.train()
    whole = tm.loss(tb, tm.build_graph(tb), train=True)[0].item()
    with capsys.disabled():
        print(f"\npartitioned bf16 train loss {got[True]!r} (JAX "
              f"{want[True]!r}), whole-graph bf16 {whole!r}: "
              f"{abs(got[True] - whole) / abs(whole):.3e} relative")
    for train in (True, False):
        np.testing.assert_allclose(got[train], want[train],
                                   rtol=BF16_LOSS_RTOL)


def test_launcher_defaults_are_cuda():
    """``run_ranks`` and the rank functions take the card unless the caller
    asks for the CPU: a case with no device runs on cuda, which this box
    does not have."""
    assert inspect.signature(launch.run_ranks).parameters[
        "device"].default == "cuda"
    assert launch._rank_device({}, 1) == torch.device("cuda", 1)
    assert launch._rank_device({"device": "cpu"}, 1) == torch.device("cpu")
    if not torch.cuda.is_available():
        case = {"model": "magnet_cnn", "hp": HP, "batch": _batch(),
                "halo": True}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.loss_rank(0, 1, [case])
