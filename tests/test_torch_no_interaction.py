"""The port's MAgNet[CNN] no-interaction ablation against magnet_tpu at a
small size (LSTM hidden 16 in 2 layers, EDSR 8 channels and 1 block, a
decoder MLP of width 8; L 64, 8 queries, batch 2, nt 48: 2 windows of
16): the LSTM stack (outputs and (h, c), from zero and from a given
state), the attention seq2seq over 4 future steps, the recurrent INR on
given latents, the core on distinct per-sample latents, the task wrapper's
training loss with and without teacher forcing with every parameter
gradient, its eval loss and predict on a full-grid batch, the weights'
round trip, the LSTM init, the eval latents, the config and the device
rule.

Both sides take the same latents: the JAX instance's ``_latent0`` and the
port's ``draw_latent`` are replaced by one fixed array (the JAX package
is not edited).

Tolerances, f32 on both sides (the products and the LSTM's gate sums
taken in another order): a module rtol 1e-5, atol 1e-6; a rollout or a
loss rtol 1e-4, atol 1e-5 (two windows of 16 + 16 recurrent steps carry
those differences); a gradient's relative L2 error per parameter 1e-4,
relative to the larger of its own norm and 1e-6 of the whole gradient's
(the first attention layer's bias gets a gradient ~1e-8 of the whole,
what is left after the softmax cancels nearly all of it: there both
packages' f32 sums differ by ~1e-4 of that remainder).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from magnet_tpu.models.factory import FACTORY as JAX_FACTORY  # noqa: E402
from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.models.magnet_cnn_no_interaction import (  # noqa: E402
    RecurrentINR as JaxRecurrentINR,
)
from magnet_tpu.nn.lstm import LSTM as JaxLSTM  # noqa: E402
from magnet_tpu.nn.lstm import AttnSeq2Seq as JaxAttnSeq2Seq  # noqa: E402
from magnet_tpu.train.import_torch import import_no_interaction  # noqa: E402
from magnet_tpu_torch.config import (  # noqa: E402
    DATAMODULE_IMPLICIT,
    MAGNET_CNN_NO_INTERACTION,
    MODELS,
)
from magnet_tpu_torch.data.datasets import DatasetImplicit1D  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.models.factory import FACTORY, create_model  # noqa: E402
from magnet_tpu_torch.models.magnet_cnn_no_interaction import (  # noqa: E402
    recurrent_inr,
)
from magnet_tpu_torch.nn.lstm import AttnSeq2Seq  # noqa: E402
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import (  # noqa: E402
    lstm_state_dict,
    seq2seq_state_dict,
    state_dict_from_jax,
)

NAME = "magnet_cnn_no_interaction"
MODULE = dict(rtol=1e-5, atol=1e-6)
ROLLOUT = dict(rtol=1e-4, atol=1e-5)
GRAD_L2 = 1e-4
H, LAYERS = 16, 2
HP = {**MAGNET_CNN_NO_INTERACTION, "lstm_hidden": H, "lstm_layers": LAYERS,
      "n_chan": 8, "res_layers": 1, "mlp_hidden": 8}
NT, L, N, B = 48, 64, 8, 2


def _arrays(seed=0) -> dict:
    """B trajectories of a few decaying Fourier modes on L points."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 2 * np.pi, L, endpoint=False)
    t = np.sort(rng.uniform(0, 2, (B, NT)), axis=1)
    k = np.arange(1, 5)
    amp = rng.normal(size=(B, 1, 4, 1))
    phase = rng.uniform(0, 2 * np.pi, (B, 1, 4, 1))
    u = (amp * np.exp(-0.3 * k[:, None] ** 2 * t[:, :, None, None] / 4)
         * np.sin(k[:, None] * x + phase)).sum(2)
    return {"t": t.astype(np.float32),
            f"pde_{NT}-{L}": u.astype(np.float32)}


def _batch(mode: str) -> dict:
    """A batch of the implicit-1D dataset: ``train`` draws N sorted queries
    (with ``sample_idx``), ``test`` queries all L points."""
    ds = DatasetImplicit1D(_arrays(), mode, nt=NT, nx=L, samples=N)
    return collate([ds[i] for i in range(B)])


def _latent(n, seed) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, n, H)).astype(
        np.float32)


@pytest.fixture(scope="module")
def pair():
    """The JAX model's params (initialised on the training batch) and the
    port's model with those weights."""
    jm = jax_create_model(NAME, HP)
    jb = {k: jnp.asarray(v) for k, v in _batch("train").items()}
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(1), jb))
    tm = create_model(NAME, HP, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, HP, NAME))
    return params, tm


def _models(pair, teacher_forcing, latent):
    """Both task wrappers with ``teacher_forcing`` and the same fixed
    latent for every window."""
    params, tm = pair
    jm = jax_create_model(NAME, {**HP, "teacher_forcing": teacher_forcing})
    jm._latent0 = lambda rng, b, n: jnp.asarray(latent)
    tm.teacher_forcing = teacher_forcing
    tm.draw_latent = lambda shape, generator: torch.from_numpy(latent)
    return jm, params, tm


def _rel_l2(got, want, floor: float = 0.0) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), floor))


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_stack_matches_jax(with_state):
    rng = np.random.default_rng(3)
    m, t, d = 5, 7, 6
    x = rng.normal(size=(m, t, d)).astype(np.float32)
    state = (rng.normal(size=(m, LAYERS, H)).astype(np.float32),
             rng.normal(size=(m, LAYERS, H)).astype(np.float32))
    jl = JaxLSTM(hidden=H, num_layers=LAYERS)
    p = jl.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    if with_state:
        out, (h, c) = jax.vmap(lambda xx, s: jl.apply(p, xx, s))(x, state)
    else:
        out, (h, c) = jax.vmap(lambda xx: jl.apply(p, xx))(x)
    tl = torch.nn.LSTM(d, H, LAYERS, batch_first=True)
    tl.load_state_dict(lstm_state_dict(p["params"], LAYERS))
    with torch.no_grad():
        if with_state:
            got, (gh, gc) = tl(torch.from_numpy(x), tuple(
                torch.from_numpy(s).transpose(0, 1).contiguous()
                for s in state))
        else:
            got, (gh, gc) = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), out, **MODULE)
    np.testing.assert_allclose(gh.transpose(0, 1).numpy(), h, **MODULE)
    np.testing.assert_allclose(gc.transpose(0, 1).numpy(), c, **MODULE)


def test_attn_seq2seq_matches_jax():
    rng = np.random.default_rng(4)
    m, t, d, future = 6, 5, H + 2, 4
    x = rng.normal(size=(m, t, d)).astype(np.float32)
    js = JaxAttnSeq2Seq(hidden=H, num_layers=LAYERS)
    p = js.init(jax.random.PRNGKey(2), jnp.asarray(x[0]), future)
    out, (h, c) = jax.vmap(lambda xx: js.apply(p, xx, future))(x)
    ts = AttnSeq2Seq(d, H, LAYERS)
    ts.load_state_dict(seq2seq_state_dict(p["params"], LAYERS))
    with torch.no_grad():
        got, (gh, gc) = ts(torch.from_numpy(x), future)
    assert got.shape == (m, future, H)
    np.testing.assert_allclose(got.numpy(), out, **MODULE)
    np.testing.assert_allclose(gh.transpose(0, 1).numpy(), h, **MODULE)
    np.testing.assert_allclose(gc.transpose(0, 1).numpy(), c, **MODULE)


def test_recurrent_inr_matches_jax():
    """Both taps, the latent threaded through them and through time, the
    area blend; queries near both ends of the mesh and in between."""
    rng = np.random.default_rng(5)
    t_len, c, l2, cf = 4, 1, 16, 8
    x_t = rng.normal(size=(B, t_len, c, l2)).astype(np.float32)
    feat = rng.normal(size=(B, cf, l2)).astype(np.float32)
    coords = np.sort(rng.uniform(-1, 1, (B, N, 1)), axis=1).astype(np.float32)
    coords[:, 0], coords[:, -1] = -0.999, 0.999
    cell = np.full_like(coords, 2.0 / 32)
    t = np.sort(rng.uniform(0, 1, (B, 2 * t_len)), axis=1).astype(np.float32)
    latent0 = _latent(N, 6)
    jr = JaxRecurrentINR(lstm_hidden=H)
    args = (x_t, feat, cell, coords, t, latent0)
    p = jr.init(jax.random.PRNGKey(3), *(a[0] for a in args))
    want = jax.vmap(lambda *a: jr.apply(p, *a))(*args)             # (B,T,N,H)
    dense = p["params"]["rec_step"]["proj_head"]["Dense_0"]
    proj_head = torch.nn.Linear(cf + c + 3 + H, H)
    proj_head.load_state_dict({
        "weight": torch.from_numpy(np.asarray(dense["kernel"]).T.copy()),
        "bias": torch.from_numpy(np.array(dense["bias"]))})
    with torch.no_grad():
        got = recurrent_inr(proj_head, *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, **MODULE)


def test_core_matches_jax_with_distinct_latents(pair):
    params, tm = pair
    jm = jax_create_model(NAME, HP)
    b = _batch("train")
    ts = HP["time_slice"]
    args = (b["hr_frames"][:, :ts], b["coords"], b["cells"],
            b["t"][:, :2 * ts], b["hr_points"][:, ts - 1], _latent(N, 7))
    assert not np.allclose(args[-1][0], args[-1][1])
    want = jm.core.apply(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args))
    assert got.shape == (B, ts, N, 1)
    np.testing.assert_allclose(got.numpy(), want, **ROLLOUT)


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_training_loss_and_grads_match_jax(pair, teacher_forcing):
    """Teacher forcing feeds the ground truth; without it the predictions
    are written into the ground-truth frames at ``sample_idx`` and the
    gradient flows through them into the earlier window."""
    latent = _latent(N, 8)
    jm, params, tm = _models(pair, teacher_forcing, latent)
    batch = _batch("train")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, train=True), has_aux=True))(params)
    tm.zero_grad()
    got, got_m = tm.loss(to_device(batch, "cpu"), None, train=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **ROLLOUT)
    np.testing.assert_allclose(got_m["mae_loss"].item(), float(m["mae_loss"]),
                               **ROLLOUT)
    got_grads = import_no_interaction(
        {k: p.grad.numpy() for k, p in tm.named_parameters()}, HP)
    want_leaves = jax.tree_util.tree_leaves_with_path(grads)
    got_leaves = jax.tree_util.tree_leaves_with_path(got_grads)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    floor = 1e-6 * np.sqrt(sum(float(np.sum(np.square(w)))
                               for _, w in want_leaves))
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert _rel_l2(g, w, floor) <= GRAD_L2, jax.tree_util.keystr(path)


def test_eval_loss_and_predict_match_jax(pair):
    """The eval rollout feeds each window's predictions on the full grid
    (N == L) to the next."""
    latent = _latent(L, 9)
    jm, params, tm = _models(pair, False, latent)
    batch = _batch("test")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, m = jax.jit(lambda p: jm.loss(p, jb, train=False))(params)
    pred = jax.jit(jm.predict)(params, jb)
    tb = to_device(batch, "cpu")
    got_loss, got_m = tm.loss(tb, None, train=False)
    got_pred = tm.predict(tb)
    assert got_pred.shape == (B, NT - HP["time_slice"], L, 1)
    np.testing.assert_allclose(got_pred.numpy(), pred, **ROLLOUT)
    np.testing.assert_allclose(float(got_loss), float(loss), **ROLLOUT)
    np.testing.assert_allclose(float(got_m["mae_loss"]), float(m["mae_loss"]),
                               **ROLLOUT)


def test_import_no_interaction_inverts_state_dict_from_jax(pair):
    params, tm = pair
    back = import_no_interaction(
        {k: v.numpy() for k, v in tm.state_dict().items()}, HP)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_init_draws_the_lstm_from_the_generator():
    """The same seed gives the same model whatever torch's global RNG
    holds; every LSTM weight and bias lies within ±1/sqrt(H)."""
    torch.manual_seed(1)
    a = create_model(NAME, HP, device="cpu", seed=5).state_dict()
    torch.manual_seed(2)
    b = create_model(NAME, HP, device="cpu", seed=5).state_dict()
    c = create_model(NAME, HP, device="cpu", seed=6).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    lstm = [k for k in a if k.startswith(("lstm_encoder.", "lstm_decoder."))]
    assert len(lstm) == 2 * 4 * LAYERS
    for k in lstm:
        assert float(a[k].abs().max()) <= 1 / H ** 0.5, k
        assert not torch.equal(a[k], c[k]), k


def test_eval_latents_repeat_and_training_latents_move():
    """``predict`` draws from a generator seeded 0 anew on every call;
    training draws from the model's own generator, which moves on."""
    tm = create_model(NAME, HP, device="cpu", seed=0)
    tb = to_device(_batch("test"), "cpu")
    assert torch.equal(tm.predict(tb), tm.predict(tb))
    train = to_device(_batch("train"), "cpu")
    with torch.no_grad():
        first = tm.loss(train, None, train=True)[0]
        second = tm.loss(train, None, train=True)[0]
    assert float(first) != float(second)


def test_prediction_feedback_needs_every_mesh_point():
    tm = create_model(NAME, HP, device="cpu", seed=0)
    with pytest.raises(ValueError, match="N = 8, L = 64"):
        tm.predict(to_device(_batch("train"), "cpu"))


def test_config_is_the_yaml_and_every_model_is_ported():
    with open(Path(__file__).parents[1] / "magnet_tpu/config/defaults/model"
              / "magnet_cnn_no_interaction.yaml") as f:
        want = yaml.safe_load(f)
    assert want["name"] == NAME
    assert MAGNET_CNN_NO_INTERACTION == want["params"]
    assert MODELS[NAME] == (MAGNET_CNN_NO_INTERACTION, DATAMODULE_IMPLICIT)
    assert sorted(FACTORY) == sorted(JAX_FACTORY)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from magnet_tpu_torch import eval as port_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(NAME, HP)
    assert create_model(NAME, HP, device="cpu") is not None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main([f"model={NAME}", "datamodule.source=synthetic_ks",
                        "n_traj=2", "batch_size=2"])
