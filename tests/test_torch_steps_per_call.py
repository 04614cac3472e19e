"""``trainer.steps_per_call`` and the other trainer keys of the port:
``Trainer.fit`` with chunks of k = 3 steps against k = 1, bit for bit (a
short last chunk, a resume across k either way, ``skip_nonfinite`` with a
planted NaN); the rule that picks a captured chunk (graphs that differ
included, where the model pads them to one signature: MAgNet[CNN] 1D and
2D, in f32 and in bf16 at widths 64 and 128; over a mesh of ranks too);
``graph_shards`` >
1 falling back to k = 1 with the JAX trainer's warning; the optimizer,
which decides in tensors (what a captured step runs), against a plain
Adam whose rate is a float and whose skip is read back, bit for bit, with
non-finite gradients; ``precision`` mapped to the cuBLAS / cuDNN TF32
flags; ``log_every`` accepted.

Every comparison is exact: on the CPU a chunk runs its steps one by one,
the same arithmetic in the same order as k = 1, and the optimizer computes
the plain Adam's update with the rate and the skip decided in tensors.  The captured CUDA graphs themselves run on the card
only (``chip_smoke.py spc``, ``spc_graph``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu_torch import run as port_run  # noqa: E402
from magnet_tpu_torch.config import compose  # noqa: E402
from magnet_tpu_torch.data.datamodule import build_loaders  # noqa: E402
from magnet_tpu_torch.data.datasets import (  # noqa: E402
    DatasetImplicit1D,
    DatasetImplicit2D,
)
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.parallel import launch  # noqa: E402
from magnet_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from magnet_tpu_torch.train import optim  # noqa: E402
from magnet_tpu_torch.train.trainer import Trainer  # noqa: E402
from magnet_tpu_torch.utils import set_precision  # noqa: E402

HP = dict(hidden_features=128, hidden_layer=2, time_window=10, neighbors=3)
NT, NX, STEPS = 50, 20, 5   # 10 training samples in batches of 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its ops are small, and the suite
    runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(rng, n, nan_sample=None):
    u = rng.normal(size=(n, NT, NX)).astype(np.float32)
    if nan_sample is not None:
        u[nan_sample, 3, 4] = np.nan
    return {"t": np.tile(np.linspace(0, 1, NT, dtype=np.float32), (n, 1)),
            "x": np.tile((np.arange(NX) * 0.8).astype(np.float32), (n, 1)),
            f"pde_{NT}-{NX}": u}


def _loaders(nan_sample=None):
    """MPNN 1D's loaders over in-memory random splits (one graph for every
    batch: the same grid), ``STEPS`` steps an epoch."""
    rng = np.random.default_rng(9)
    cfg = {"kind": "h5_graph_1d", "batch_size": 2}
    for split, n in (("train", 2 * STEPS), ("val", 2), ("test", 2)):
        cfg.update({f"{split}_path": _split(rng, n, nan_sample
                                            if split == "train" else None),
                    f"nt_{split}": NT, f"nx_{split}": NX})
    return build_loaders(cfg, seed=0)


def _fit(workdir, k, max_epochs, resume=None, nan_sample=None, **kw):
    """``Trainer.fit`` of MPNN 1D (seed 0) with k steps a call, the rate
    halved every epoch."""
    model = create_model("mpnn", HP, device="cpu", seed=0)
    trainer = Trainer(model, max_epochs=max_epochs, lr=1e-3, factor=0.5,
                      step_size=1, workdir=str(workdir), device="cpu",
                      steps_per_call=k, **kw)
    loaders = _loaders(nan_sample)
    trainer.fit(loaders["train"], loaders["val"], resume=resume)
    return trainer


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("time", "steps_per_s")} for line in f]


def _assert_same(a: Trainer, b: Trainer):
    assert a.optimizer.step_count == b.optimizer.step_count
    for (k, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["adam"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["adam"]["state"][i][k]), (i, k)


def test_chunks_of_three_equal_single_steps(tmp_path, capsys):
    """Two epochs of 5 steps: a chunk of 3 and a short chunk of 2 an
    epoch, both run step by step on the CPU (and said so once each), equal
    to k = 1 in every weight, moment, metric row and the checkpoint."""
    one = _fit(tmp_path / "k1", 1, 2)
    three = _fit(tmp_path / "k3", 3, 2)
    out = capsys.readouterr().out
    assert three.steps_per_call == 3 and one.steps_per_call == 1
    assert three.step_counts == {"eager": 2 * STEPS, "captured": 0,
                                 "replayed": 0}
    assert out.count("runs step by step (no CUDA graph on cpu)") == 1
    assert out.count("runs step by step (a short chunk)") == 1
    _assert_same(three, one)
    assert _rows(tmp_path / "k3") == _rows(tmp_path / "k1")
    for ckpt in ("last.pt", "best.pt"):
        a = torch.load(tmp_path / "k3" / "checkpoints" / ckpt,
                       weights_only=True)
        b = torch.load(tmp_path / "k1" / "checkpoints" / ckpt,
                       weights_only=True)
        assert a["step"] == b["step"] == 2 * STEPS
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), k


def test_resume_across_k_either_way(tmp_path):
    """A run saved with k = 3 resumes with k = 1, and one saved with k = 1
    resumes with k = 3: the same weights, moments and step count, and the
    same as three epochs straight."""
    straight = _fit(tmp_path / "straight", 1, 3)
    got = []
    for first, then in ((3, 1), (1, 3)):
        d = tmp_path / f"k{first}_then_k{then}"
        _fit(d, first, 2)
        got.append(_fit(d, then, 3,
                        resume=str(d / "checkpoints" / "last.pt")))
        assert [r["epoch"] for r in _rows(d)] == [0, 1, 2]
    _assert_same(got[0], got[1])
    _assert_same(got[0], straight)


def test_skip_nonfinite_with_a_planted_nan(tmp_path):
    """A NaN in one training sample: its batch's update is dropped each
    epoch (the step count one short of the steps), the weights stay
    finite, and k = 3 equals k = 1."""
    one = _fit(tmp_path / "k1", 1, 2, nan_sample=7, skip_nonfinite=True)
    three = _fit(tmp_path / "k3", 3, 2, nan_sample=7, skip_nonfinite=True)
    assert one.optimizer.step_count == 2 * (STEPS - 1)
    assert all(torch.isfinite(p).all() for p in one.model.parameters())
    _assert_same(three, one)


def _bits(t):
    """A tensor's bits (NaN equal to itself)."""
    t = t.detach()
    return (torch.view_as_real(t) if t.is_complex() else t).view(torch.int32)


class _HostAdam:
    """The plain reference: ``torch.optim.Adam`` with the rate set as a
    Python float before each update and the finite check read back to the
    host, a dropped update not reaching Adam at all."""

    def __init__(self, params, lr, weight_decay, factor, step_size,
                 steps_per_epoch, skip_nonfinite=False):
        self.params, self.skip = params, skip_nonfinite
        self.rate = lambda s: lr * factor ** (s // steps_per_epoch
                                              // step_size)
        self.adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.step_count = self.notfinite_count = 0

    def step(self):
        if self.skip:
            finite = all(bool(torch.isfinite(p.grad).all())
                         for p in self.params if p.grad is not None)
            if (not finite and self.notfinite_count
                    < optim.MAX_CONSECUTIVE_NONFINITE):
                self.notfinite_count += 1
                return False
            self.notfinite_count = 0
        for group in self.adam.param_groups:
            group["lr"] = self.rate(self.step_count)
        self.adam.step()
        self.step_count += 1
        return True

    def state_dict(self):
        return {"adam": self.adam.state_dict(), "step": self.step_count,
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state):
        self.adam.load_state_dict(state["adam"])
        self.step_count = int(state["step"])
        self.notfinite_count = int(state["notfinite_count"])


def _run_optimizer(host, grads, **kw):
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(5, dtype=torch.complex64)),
              torch.nn.Parameter(torch.randn(4, 3))]
    args = (params, 1e-2, 0.1, 0.5, 1, 2)
    opt = (_HostAdam(*args, **kw) if host
           else optim.make_optimizer(*args, max_epochs=20, **kw))
    for g in grads:
        for p, gg in zip(params, g):
            p.grad = None if gg is None else gg.clone()
        opt.step()
    return params, opt


@pytest.mark.parametrize("skip", [True, False])
def test_on_device_optimizer_equals_the_host_path(monkeypatch, skip):
    """The optimizer, which decides in tensors (a captured step's), against
    the plain reference that decides on the host, over 14 updates across
    rate decays: finite gradients, non-finite ones (dropped, then applied
    once the consecutive limit is reached: 3 here), a parameter without a
    gradient; every weight, moment and count, and the checkpoint state
    either way, loaded by the other."""
    monkeypatch.setattr(optim, "MAX_CONSECUTIVE_NONFINITE", 3)
    gen = torch.Generator().manual_seed(3)
    grads = []
    for i in range(14):
        a = torch.randn(5, generator=gen, dtype=torch.complex64)
        b = torch.randn(4, 3, generator=gen)
        if i in (0, 4, 6, 7, 8, 9):
            b[1, 2] = float("nan") if i % 2 else float("inf")
        grads.append((None if i == 2 else a, b))
    (p_host, host), (p_dev, dev) = (
        _run_optimizer(h, grads, skip_nonfinite=skip) for h in (True, False))
    # dropped: 0, 4, 6, 7, 8; the fourth in a row (9) is applied
    assert host.step_count == dev.step_count == (9 if skip else 14)
    assert host.notfinite_count == dev.notfinite_count
    for a, b in zip(p_host, p_dev):
        assert torch.equal(_bits(a), _bits(b))
    sh, sd = host.state_dict(), dev.state_dict()
    assert sh["step"] == sd["step"]
    assert sh["adam"]["param_groups"] == sd["adam"]["param_groups"]
    for i, st in sh["adam"]["state"].items():
        for k, v in st.items():
            assert torch.equal(_bits(v), _bits(sd["adam"]["state"][i][k])), (
                i, k)
    # each state loads into the other kind and steps on alike
    (q_host, h2), (q_dev, d2) = (_run_optimizer(h, grads[:2])
                                 for h in (True, False))
    h2.load_state_dict(sd)
    d2.load_state_dict(sh)
    for q, opt in ((q_host, h2), (q_dev, d2)):
        with torch.no_grad():
            for a, b in zip(q, p_host):
                a.copy_(b)
        for a, g in zip(q, grads[1]):
            a.grad = g.clone()
        opt.step()
    assert h2.step_count == d2.step_count == host.step_count + 1
    for a, b in zip(q_host, q_dev):
        assert torch.equal(_bits(a), _bits(b))


def _magnet_cnn_chunk(k):
    """A tiny MAgNet[CNN] 1D trainer and a chunk of ``k`` (batch, graph)
    pairs with new queries a batch: graphs that differ, on its fold lane."""
    hp = dict(time_slice=8, latent_dim=8, num_message_passing_steps=2,
              mlp_layers=2, mlp_hidden=16, n_chan=8, res_layers=1)
    tr = Trainer(create_model("magnet_cnn", hp, device="cpu", seed=0),
                 max_epochs=1, workdir="unused", device="cpu",
                 steps_per_call=k)
    ds = DatasetImplicit1D(make_split("Heat", 2, 24, 64, seed=1), "train",
                           nt=24, nx=64, samples=8)
    chunk = []
    for i in range(k):
        ds.set_epoch(i)
        chunk.append(tr._host_pair(collate([ds[0], ds[1]])))
    return tr, chunk


def _magnet_cnn_2d_chunk(k, hp=None):
    """A tiny MAgNet[CNN] 2D trainer and a chunk of ``k`` pairs with new
    queries a batch (its graphs' lane forced to the pre-gathered one, its
    published training graph's)."""
    hp = hp or dict(time_slice=4, latent_dim=8, num_message_passing_steps=2,
                    mlp_layers=2, mlp_hidden=16, n_chan=8, res_layers=1,
                    radius=0.5)
    model = create_model("magnet_cnn_2d", hp, device="cpu", seed=0)
    model.impl = "kernel_pregathered"
    tr = Trainer(model, max_epochs=1, workdir="unused", device="cpu",
                 steps_per_call=k)
    rng = np.random.default_rng(2)
    g = np.tile((np.arange(8) / 8).astype(np.float32), (2, 1))
    ds = DatasetImplicit2D(
        {"t": np.tile(np.linspace(0, 1, 12, dtype=np.float32), (2, 1)),
         "x": g, "y": g.copy(),
         "pde_12-8": rng.normal(size=(2, 12, 8, 8)).astype(np.float32)},
        "train", nt=12, res=8, samples=6)
    chunk = []
    for i in range(k):
        ds.set_epoch(i)
        chunk.append(tr._host_pair(collate([ds[0], ds[1]])))
    return tr, chunk


def test_the_rule_that_captures_a_chunk():
    """A full chunk of batches of one shape on one graph object, or on
    graphs that differ but pad to one signature (new queries a batch:
    MAgNet[CNN] 1D on its f32 fold lane, MAgNet[CNN] 2D on the pre-gathered
    lane, in f32 and in bf16 at widths 64 and 128), on a CUDA device, is
    captured, over a mesh of ranks too (the gradients' all-reduce is
    captured with the step); a short chunk, a CPU device, graphs that
    differ of a model that pads none (MPNN) and shapes that differ are
    not."""
    model = create_model("mpnn", HP, device="cpu", seed=0)
    tr = Trainer(model, max_epochs=1, workdir="unused", device="cpu",
                 steps_per_call=3)
    batch = {k: torch.as_tensor(v[:2]) for k, v in
             {"u": np.zeros((2, NX, NT), np.float32),
              "x": np.zeros((2, NX, 1), np.float32)}.items()}
    graph, other = object(), object()
    full = [(batch, graph)] * 3
    assert tr._uncaptured(full) == "no CUDA graph on cpu"
    tr.device = torch.device("cuda")      # the rule reads nothing else of it
    assert tr._uncaptured(full) is None
    assert tr._uncaptured(full[:2]) == "a short chunk"
    assert tr._uncaptured([(batch, graph), (batch, other), (batch, graph)]) \
        == "the chunk's graphs differ"
    wide = {k: torch.cat([v, v]) for k, v in batch.items()}
    assert tr._uncaptured([(batch, graph), (wide, graph), (batch, graph)]) \
        == "the chunk's batch shapes differ"
    tr.world = 2
    assert tr._uncaptured(full) is None

    tr, chunk = _magnet_cnn_chunk(3)
    assert len({g.n_edge for _, g in chunk}) == 3    # the graphs differ
    assert tr._uncaptured(chunk) == "no CUDA graph on cpu"
    tr.device = torch.device("cuda")
    assert tr._uncaptured(chunk) is None
    assert tr._uncaptured(chunk[:2]) == "a short chunk"
    b, g = chunk[1]
    wide = {k: torch.cat([v, v]) for k, v in b.items()}
    assert tr._uncaptured([chunk[0], (wide, g), chunk[2]]) \
        == "the chunk's batch shapes differ"
    tr.world = 2
    assert tr._uncaptured(chunk) is None

    tr, chunk = _magnet_cnn_2d_chunk(3)
    assert len({g.n_edge for _, g in chunk}) == 3
    assert tr._uncaptured(chunk) == "no CUDA graph on cpu"
    tr.device = torch.device("cuda")
    assert tr._uncaptured(chunk) is None
    assert tr._uncaptured(chunk[:2]) == "a short chunk"

    # bf16: the builds of both widths read the live count
    for width, why in ((64, None), (128, None)):
        tr, chunk = _magnet_cnn_2d_chunk(3, dict(
            time_slice=4, latent_dim=8, num_message_passing_steps=2,
            mlp_layers=2, mlp_hidden=width, n_chan=8, res_layers=1,
            radius=0.5, graph_dtype="bf16"))
        tr.device = torch.device("cuda")
        assert tr._uncaptured(chunk) == why, width


def test_graph_shards_fall_back_to_one_step_a_call():
    """The JAX trainer's rule and warning: k > 1 with graph_shards > 1
    runs k = 1."""
    model = create_model("mpnn", HP, device="cpu", seed=0)
    mesh = Mesh(dp=1, graph=2, rank=0, device=torch.device("cpu"))
    with pytest.warns(UserWarning, match=r"steps_per_call > 1 unsupported "
                      r"with graph_shards > 1; using 1"):
        tr = Trainer(model, max_epochs=1, workdir="unused", device="cpu",
                     mesh=mesh, graph_shards=2, steps_per_call=4)
    assert tr.steps_per_call == 1


@pytest.mark.parametrize("precision,tf32", [
    ("default", False), ("float32", False), ("highest", False),
    ("tensorfloat32", True), ("high", True), ("bfloat16", False)])
def test_precision_maps_to_the_tf32_flags(precision, tf32):
    """``tensorfloat32`` / ``high`` turn TF32 on for cuBLAS and cuDNN; the
    f32 words and any other value leave both off."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        torch.backends.cudnn.allow_tf32 = not tf32
        set_precision(precision)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def _flags(rank, world):
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_run_main_and_the_rank_launcher_take_the_trainer_keys(
        tmp_path, monkeypatch):
    """``run.main`` passes ``steps_per_call`` and ``log_every`` to the
    trainer and sets ``precision``'s flags first; a rank of
    ``parallel.launch`` sets them from its ``precision``; the defaults
    are the JAX trainer's (1, default, 10)."""
    cfg = compose([])["trainer"]
    assert (cfg["steps_per_call"], cfg["precision"], cfg["log_every"]) == (
        1, "default", 10)
    seen = {}

    class Recorder(Trainer):
        def fit(self, *a, **kw):
            seen.update(steps_per_call=self.steps_per_call,
                        log_every=self.log_every,
                        flags=_flags(0, 1))
            self.ckpt.best_path, self.ckpt.best = "none", 0.0
            return self.model

    monkeypatch.setattr(port_run, "Trainer", Recorder)
    monkeypatch.setattr(port_run, "build_loaders",
                        lambda cfg, seed: {"train": [], "val": []})
    before = _flags(0, 1)
    try:
        port_run.main(["model=mpnn", "device=cpu", "trainer.steps_per_call=4",
                       "trainer.log_every=25",
                       "trainer.precision=tensorfloat32",
                       f"workdir={tmp_path}"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    assert seen == {"steps_per_call": 4, "log_every": 25,
                    "flags": (True, True)}
    d = tmp_path / "ranks"
    d.mkdir()
    try:
        launch._rank_main(0, _flags, 1, (), "cpu", str(d), 30, "high")
        assert torch.load(d / "rank0.pt", weights_only=False) == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
