"""The port's data and graph parallelism over gloo ranks on the CPU, each
launch a group of spawned processes (``parallel.launch.run_ranks``, whose
rank functions import torch alone): MAgNet[CNN] 1D's ``loss_partitioned``
over 2 and 4 ranks (all-gather, halo, and the overlap split with its
all-to-all or its ring), train and validation, against the JAX package's
``loss_partitioned`` on a (1, 2) mesh (its all-gather layout, the same
function as its halo one) and against the port's unpartitioned
loss, with every parameter's gradient (summed over the ranks and divided
by their number, as the trainer reduces them) against the unpartitioned
one; the ring equal to the all-to-all bit for bit; the overlap step's
order (the exchange started before the interior edges' kernel, waited on
only before the boundary's); one MAgNet[GNN] and one MPNN partitioned
step; ``Trainer`` steps over dp = 2 and over dp = 2 x graph = 2 against
one process on the global batch; a checkpoint written by 2 ranks resumed
by 1.  Every launch passes ``device="cpu"`` (gloo): the launcher's
default is the card.

Tolerances.  Against JAX: loss rtol 1e-4, atol 1e-5 (the port's MAgNet[CNN]
1D training parity test, ``tests/test_torch_train.py``).  Partitioned
against unpartitioned in the port (only the order of the sums differs):
loss rtol 1e-5, every gradient rtol 1e-4 with atol 1e-4 of its leaf's
largest entry.  Weights after one Adam step over ranks against one
process: the reduced gradients as above, and the weights within atol 1e-5
(1% of lr 1e-3, the most Adam's first step lr g / (|g| + 1e-8) moves a
weight: where |g| is near 1e-8 a difference in the order of the sums
moves that step by up to this much).  Each launch has a 60 s timeout.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.train.import_torch import import_magnet_cnn  # noqa: E402
from magnet_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicit1D  # noqa: E402
from magnet_tpu_torch.data.loader import DataLoader, collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.parallel.launch import (  # noqa: E402
    fit_rank,
    loss_rank,
    run_ranks,
)
from magnet_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402
from magnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from torch_ranks import ordered_loss_rank  # noqa: E402

JAX_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4, 1e-4
STEP_ATOL = 1e-5
HP = dict(time_slice=16, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, res_layers=1,
          kernel_size=3, res_scale=1, radius=0.08)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this process too, as in each rank: the models
    are small, and the suite runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _heat(n, seed=3):
    return make_split("Heat", n, 64, 64, seed=seed)


@pytest.fixture(scope="module")
def cnn():
    """The port's model, the JAX model with its weights (mapped by
    ``import_magnet_cnn``), a batch of 2 and the port's unpartitioned loss,
    validation loss and gradients on it."""
    ds = DatasetImplicit1D(_heat(2), "train", nt=64, nx=64, samples=16)
    ds.set_epoch(3)
    batch = collate([ds[0], ds[1]])
    tm = create_model("magnet_cnn", HP, device="cpu", seed=1)
    jm = jax_create_model("magnet_cnn", HP)
    params = import_magnet_cnn(
        {k: v.numpy().copy() for k, v in tm.state_dict().items()}, HP)
    ref = _unpartitioned(tm, to_device(batch, "cpu"))
    return jm, params, tm, batch, ref


def _state(model):
    """A copy of the model's weights to hand to the ranks (spawning moves
    the tensors it pickles into shared memory)."""
    return {k: v.clone() for k, v in model.state_dict().items()}


def _unpartitioned(tm, tb, **kw):
    tm.train()
    tm.zero_grad()
    loss, metrics = tm.loss(tb, tm.build_graph(tb), train=True, **kw)
    loss.backward()
    tm.eval()
    val, _ = tm.loss(tb, tm.build_graph(tb), train=False)
    return {"loss": loss.item(), "val_loss": val.item(),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in tm.named_parameters()}}


def _assert_matches(got: dict, want: dict):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                               rtol=LOSS_RTOL)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(
            got["grads"][k], g, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * float(np.abs(g).max()), err_msg=k)


@pytest.fixture(scope="module")
def jax_losses(cnn):
    """The JAX package's ``loss_partitioned`` on a (1, 2) mesh, train and
    validation, in its all-gather layout (its halo layout computes the
    same function; its processor is held against the port's halo one in
    ``tests/test_torch_parallel_local.py``)."""
    jm, params, _, batch, _ = cnn
    mesh = jax_make_mesh(dp=1, graph=2, devices=jax.devices()[:2])
    pg = jm.build_graph_partitioned(batch, n_shards=2)
    eg = NamedSharding(mesh, P("dp", "graph"))
    for k in ("senders", "recv_loc", "mask", "table", "senders_remap",
              "halo_idx"):
        if k in pg:
            pg[k] = jax.device_put(pg[k], eg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(lambda p, b, train: jm.loss_partitioned(p, b, pg, mesh,
                                                         train=train)[0],
                 static_argnums=2)
    return float(fn(params, jb, True)), float(fn(params, jb, False))


HALOS = (False, True, "overlap", "ring")


def _cases(tm, batch, halos=HALOS):
    """One ``loss_rank`` case a mode of ``halos``."""
    return [{"model": "magnet_cnn", "hp": HP, "state": _state(tm),
             "batch": batch, "halo": halo, "device": "cpu"}
            for halo in halos]


@pytest.fixture(scope="module")
def cnn_two_ranks(cnn):
    """MAgNet[CNN] 1D over 2 ranks in every mode of ``HALOS``, in one
    launch, each case with its order of exchanges and kernels
    (``tests/torch_ranks.py``)."""
    *_, tm, batch, _ = cnn
    return run_ranks(ordered_loss_rank, 2, (_cases(tm, batch),),
                     device="cpu")


@pytest.mark.parametrize("halo", HALOS)
def test_cnn1d_two_ranks_match_jax_and_unpartitioned(cnn, cnn_two_ranks,
                                                     jax_losses, halo):
    *_, tm, batch, ref = cnn
    out = [r[HALOS.index(halo)] for r in cnn_two_ranks]
    overlap = halo in ("overlap", "ring")
    for rank in out:
        _assert_matches(rank, ref)
        assert rank["lanes"] == [[("fold", "fold") if overlap else "fold"]]
    edges = [r["edges"][0][0] for r in out]
    assert sum(sum(e) if overlap else e for e in edges) == tm.build_graph(
        to_device(batch, "cpu")).n_edge
    want_train, want_val = jax_losses
    np.testing.assert_allclose(out[0]["loss"], want_train, **JAX_TOL)
    np.testing.assert_allclose(out[0]["val_loss"], want_val, **JAX_TOL)


def _assert_ring_equals_overlap(ranks, halos=HALOS):
    """Each rank's ring case equals its overlap case bit for bit: losses
    and reduced gradients."""
    for rank in ranks:
        ring, overlap = (rank[halos.index(h)] for h in ("ring", "overlap"))
        for k in ("loss", "val_loss", "mae_loss", "val_mae_loss"):
            assert ring[k] == overlap[k], k
        for k, g in overlap["grads"].items():
            np.testing.assert_array_equal(ring["grads"][k], g, err_msg=k)


def test_ring_equals_overlap_over_two_ranks(cnn_two_ranks):
    _assert_ring_equals_overlap(cnn_two_ranks)


def test_overlap_starts_the_exchange_before_the_interior_kernel(
        cnn_two_ranks):
    """On each rank every message-passing step of the training and the
    validation forward starts the all-to-all, runs the interior edges'
    sums while it is in flight, waits on it, then runs the boundary
    edges' sums."""
    for rank in cnn_two_ranks:
        order = rank[HALOS.index("overlap")]["order"]
        steps = len(order) // 4
        assert steps >= HP["num_message_passing_steps"]
        assert order == ["start", "interior", "wait", "boundary"] * steps


def test_cnn1d_four_ranks_halo(cnn):
    """Four ranks: halo, overlap and ring against the unpartitioned step,
    ring equal to overlap bit for bit."""
    *_, tm, batch, ref = cnn
    halos = HALOS[1:]
    out = run_ranks(loss_rank, 4, (_cases(tm, batch, halos),), device="cpu")
    for rank in out:
        for case in rank:
            _assert_matches(case, ref)
    _assert_ring_equals_overlap(out, halos)


def _gnn_case():
    rng = np.random.default_rng(17)
    B, nt, L, N, ts = 2, 12, 24, 10, 4
    batch = {"t": np.linspace(0, 1, nt, dtype=np.float32)[None].repeat(B, 0),
             "lr_frames": rng.normal(size=(B, nt, 1, L)).astype(np.float32),
             "hr_points": rng.normal(size=(B, nt, N, 1)).astype(np.float32),
             "coords_lr": rng.uniform(-1, 1, (B, L, 2)).astype(np.float32),
             "coords_hr": rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)}
    hp = dict(time_slice=ts, latent_dim=8, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=8, radius=0.7,
              codec_neighbors=2, noise=0.01)
    return "magnet_gnn", hp, "h5_implicit_gnn_2d", batch, True


def _mpnn_case():
    rng = np.random.default_rng(19)
    W, tw = 6, 10
    gx, gy = np.meshgrid(np.linspace(0, 2, W), np.linspace(0, 2, W),
                         indexing="ij")
    x = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    batch = {"u": rng.normal(size=(2, W * W, 2 * tw)).astype(np.float32),
             "x": x[None].repeat(2, 0),
             "t": np.linspace(0, 2, 2 * tw, dtype=np.float32)[None].repeat(
                 2, 0)}
    hp = dict(hidden_features=128, hidden_layer=2, time_window=tw,
              neighbors=1)
    return "mpnn_2d", hp, None, batch, False


@pytest.fixture(scope="module")
def gnn_and_mpnn_steps():
    """Both models' steps over one launch of 2 ranks, and each model's
    unpartitioned step."""
    cases, refs = [], []
    for name, hp, kind, batch, halo in (_gnn_case(), _mpnn_case()):
        tm = create_model(name, hp, device="cpu", seed=2, kind=kind)
        state = _state(tm)
        refs.append(_unpartitioned(tm, to_device(batch, "cpu")))
        cases.append({"model": name, "hp": hp, "kind": kind, "state": state,
                      "batch": batch, "halo": halo, "device": "cpu"})
    return run_ranks(loss_rank, 2, (cases,), device="cpu"), refs


@pytest.mark.parametrize("case", [0, 1], ids=["magnet_gnn_halo", "mpnn_2d"])
def test_partitioned_step_over_two_ranks(gnn_and_mpnn_steps, case):
    """MAgNet[GNN] (both radius graphs partitioned, noise on: every rank
    draws the model generator's sequence) and MPNN-2D (the InstanceNorm's
    statistics summed over the ranks) against the port's unpartitioned
    step."""
    out, refs = gnn_and_mpnn_steps
    for rank in out:
        _assert_matches(rank[case], refs[case])


def _loaders():
    train = DatasetImplicit1D(_heat(4, seed=5), "train", nt=64, nx=64,
                              samples=16)
    val = DatasetImplicit1D(_heat(2, seed=6), "valid", nt=64, nx=64,
                            samples=16)
    return {"train": DataLoader(train, batch_size=4, shuffle=False),
            "val": DataLoader(val, batch_size=2, shuffle=False)}


TRAIN_STATE_SEED = 4


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """One process's ``Trainer.fit`` step on the global batch of 4, from
    the weights every mesh starts from."""
    state = _state(create_model("magnet_cnn", HP, device="cpu",
                                seed=TRAIN_STATE_SEED))
    tm = create_model("magnet_cnn", HP, device="cpu")
    tm.load_state_dict(state)
    loaders = _loaders()
    Trainer(tm, max_epochs=1, workdir=str(tmp_path_factory.mktemp("one")),
            device="cpu").fit(loaders["train"], loaders["val"])
    return state, tm


@pytest.mark.parametrize("world,dp,halo,resume",
                         [(2, 2, False, True), (4, 2, True, False)],
                         ids=["dp2", "dp2_graph2"])
def test_trainer_step_over_ranks_equals_one_process(tmp_path, one_process,
                                                    world, dp, halo, resume):
    """One Adam step of ``Trainer.fit`` over the mesh equals one process's
    step on the global batch of 4; rank 0 alone writes; with ``resume``,
    its checkpoint (of 2 ranks) resumes in one process."""
    state, want = one_process
    workdir = str(tmp_path / "ranks")
    spec = {"model": "magnet_cnn", "hp": HP, "state": state, "dp": dp,
            "halo": halo, "loaders": _loaders(), "max_epochs": 1,
            "workdir": workdir, "device": "cpu"}
    out = run_ranks(fit_rank, world, (spec,), device="cpu")
    assert [r["metrics_written"] for r in out] == [True] + [False] * (
        world - 1)
    for rank in out:
        for k, p in want.named_parameters():
            g = p.grad.numpy()
            np.testing.assert_allclose(
                rank["grads"][k], g, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_REL * float(np.abs(g).max()), err_msg=k)
        for k, w in want.state_dict().items():
            np.testing.assert_allclose(rank["state"][k], w.numpy(), rtol=0,
                                       atol=STEP_ATOL, err_msg=k)
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0]

    if not resume:
        return
    # the checkpoint of the ranks, in one process
    last = os.path.join(workdir, "checkpoints", "last.pt")
    saved, meta = load_checkpoint(last, require=("model", "optimizer"))
    assert meta["epoch"] == 0
    for k, v in saved["model"].items():
        np.testing.assert_array_equal(v.numpy(), out[0]["state"][k])
    tm = create_model("magnet_cnn", HP, device="cpu")
    loaders = _loaders()
    trainer = Trainer(tm, max_epochs=2, workdir=str(tmp_path / "resumed"),
                      device="cpu")
    trainer.fit(loaders["train"], loaders["val"], resume=last)
    assert trainer.optimizer.step_count == 2
    with open(tmp_path / "resumed" / "metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [1]


def test_a_rank_that_fails_fails_the_launch():
    """A rank's exception is raised again in the caller (here a case with
    no batch: KeyError in each rank)."""
    with pytest.raises(Exception, match="KeyError"):
        run_ranks(loss_rank, 2, ([{"model": "magnet_cnn", "hp": HP,
                                    "halo": False, "device": "cpu"}],),
                  device="cpu", timeout_s=30)
