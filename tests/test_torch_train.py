"""The port's training step against magnet_tpu at a small size:
``loss(train=True)`` with its metrics and every parameter gradient, for
teacher forcing on and off; an Adam + step-decay trajectory with weight
decay across a decay boundary; the gradient clip; ``skip_nonfinite``.

Tolerances.  Loss and metrics rtol 1e-4, atol 1e-5 (f32 on both sides, sums
in another order).  Gradients rtol 2e-3, atol 1e-5 relative to each leaf's
largest entry: they pass through three windows, two message-passing steps
and LayerNorms.  The trajectory carries those differences through Adam's
normalisation for 6 steps: losses rtol 2e-3, atol 1e-5, final weights rtol
5e-3, atol 2e-4, the bounds of ``tests/test_trajectory_parity.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from magnet_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from magnet_tpu.train.import_torch import import_magnet_cnn  # noqa: E402
from magnet_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from magnet_tpu_torch.data.datasets import DatasetImplicit1D  # noqa: E402
from magnet_tpu_torch.data.loader import collate  # noqa: E402
from magnet_tpu_torch.data.synthetic import make_split  # noqa: E402
from magnet_tpu_torch.models.factory import create_model  # noqa: E402
from magnet_tpu_torch.train.optim import (  # noqa: E402
    clip_grad_global_norm,
    make_optimizer,
)
from magnet_tpu_torch.utils import to_device  # noqa: E402
from magnet_tpu_torch.weights import state_dict_from_jax  # noqa: E402

# B=2, nt=64 (3 windows of 16), L=32, 16 HR queries
HP = dict(time_slice=16, latent_dim=8, num_message_passing_steps=2,
          mlp_layers=2, mlp_hidden=16, n_chan=16, res_layers=1,
          kernel_size=3, res_scale=1, radius=0.08)


def _train_batch(seed=3):
    ds = DatasetImplicit1D(make_split("Heat", 2, 64, 64, seed=seed), "train",
                           nt=64, nx=64, samples=16)
    ds.set_epoch(seed)
    return collate([ds[0], ds[1]])


def _pair(hp, seed=1):
    batch = _train_batch()
    jm = jax_create_model("magnet_cnn", hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jm.build_graph(batch)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jb, jg)
    params = jax.tree.map(np.asarray, params)
    tm = create_model("magnet_cnn", hp, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, hp))
    tb = to_device(batch, "cpu")
    return jm, params, jb, jg, tm, tb


def _assert_tree_close(got, want, rtol, atol_rel):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=rtol,
            atol=atol_rel * max(float(np.abs(w).max()), 1.0),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_train_loss_metrics_and_grads_match_jax(teacher_forcing):
    hp = dict(HP, teacher_forcing=teacher_forcing)
    jm, params, jb, jg, tm, tb = _pair(hp)
    assert tm.teacher_forcing is teacher_forcing
    (want_loss, want_m), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jg, train=True), has_aux=True))(params)
    loss, metrics = tm.loss(tb, tm.build_graph(tb), train=True)
    assert set(metrics) == {"loss", "mae_loss", "interp_loss"} == set(want_m)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), 1e-4, 1e-5)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]),
                                   1e-4, 1e-5, err_msg=k)
    loss.backward()
    grads = {k: v.grad.numpy() for k, v in tm.named_parameters()}
    assert all(np.isfinite(g).all() for g in grads.values())
    # the importer is linear, so it carries gradients like weights
    _assert_tree_close(import_magnet_cnn(grads, hp), want_grads,
                       rtol=2e-3, atol_rel=1e-5)


@pytest.mark.parametrize("loss_name", ["l2", "smooth_l1"])
def test_other_losses_match_jax(loss_name):
    hp = dict(HP, loss=loss_name)
    jm, params, jb, jg, tm, tb = _pair(hp)
    want, _ = jax.jit(lambda p: jm.loss(p, jb, jg, train=True))(params)
    got, _ = tm.loss(tb, tm.build_graph(tb), train=True)
    np.testing.assert_allclose(float(got.detach()), float(want), 1e-4, 1e-5)


def test_optimizer_trajectory_matches_optax():
    """6 steps, one step per epoch, a decay every 2 epochs (two boundaries
    crossed), weight decay 0.01: losses and final weights."""
    lr, wd, factor, step_size, k_steps = 1e-3, 0.01, 0.3, 2, 6
    jm, params, jb, jg, tm, tb = _pair(HP)
    tx = jax_make_optimizer(lr, wd, factor, step_size, steps_per_epoch=1)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(p, s):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jm.loss(q, jb, jg, train=True), has_aux=True)(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    want_losses = []
    for _ in range(k_steps):
        params, opt_state, loss = jax_step(params, opt_state)
        want_losses.append(float(loss))

    opt = make_optimizer(tm.parameters(), lr, wd, factor, step_size,
                         steps_per_epoch=1)
    graph = tm.build_graph(tb)
    got_losses, lrs = [], []
    for _ in range(k_steps):
        opt.zero_grad()
        loss, _ = tm.loss(tb, graph, train=True)
        loss.backward()
        opt.step()
        got_losses.append(float(loss.detach()))
        lrs.append(opt.adam.param_groups[0]["lr"])
    np.testing.assert_allclose(
        lrs, [lr * factor ** (s // step_size) for s in range(k_steps)])
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-3, atol=1e-5)
    got = import_magnet_cnn(
        {k: v.detach().numpy() for k, v in tm.state_dict().items()}, HP)
    want_leaves = jax.tree.leaves(params)
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=5e-3,
                                   atol=2e-4)


def test_learning_rate_follows_the_global_step():
    """A partial epoch and a restored step count give the rate of the
    epoch the step lies in."""
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = make_optimizer(p, 1e-2, factor=0.5, step_size=2, steps_per_epoch=3)
    assert [opt.lr_at(s) for s in (0, 5, 6, 11, 12)] == \
        [1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3]
    state = opt.state_dict()
    state["step"] = 7
    fresh = make_optimizer(p, 1e-2, factor=0.5, step_size=2, steps_per_epoch=3)
    fresh.load_state_dict(state)
    p[0].grad = torch.ones(3)
    fresh.step()
    assert fresh.adam.param_groups[0]["lr"] == 5e-3 and fresh.step_count == 8


@pytest.mark.parametrize("clip,scale_up", [(0.5, 1.0), (0.5, 1e-3), (0.0, 1.0)])
def test_grad_clip_is_the_global_norm_formula(clip, scale_up):
    rng = np.random.default_rng(0)
    raw = [rng.normal(size=s).astype(np.float32) * scale_up
           for s in ((4, 3), (5,), (2, 2, 2))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in raw]
    for p, g in zip(params, raw):
        p.grad = torch.from_numpy(g.copy())
    clip_grad_global_norm(params, clip)
    tree = [jnp.asarray(g) for g in raw]
    if clip > 0:
        s = jnp.minimum(1.0, clip / jnp.maximum(optax.global_norm(tree), 1e-12))
        tree = [g * s for g in tree]
    for p, w in zip(params, tree):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_skip_nonfinite_leaves_weights_moments_and_step_untouched():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    opt = make_optimizer([w], 1e-2, weight_decay=0.1, skip_nonfinite=True)
    w.grad = torch.tensor([0.5, 0.1, -0.2])
    assert opt.step() is True
    before_w = w.detach().clone()
    before = {k: v.clone() for k, v in opt.adam.state[w].items()}
    w.grad = torch.tensor([0.5, float("inf"), -0.2])
    assert opt.step() is False
    assert torch.equal(w.detach(), before_w) and opt.step_count == 1
    for k, v in opt.adam.state[w].items():
        assert torch.equal(v, before[k]), k
    assert opt.notfinite_count == 1
    w.grad = torch.tensor([0.5, 0.1, -0.2])
    assert opt.step() is True and opt.notfinite_count == 0
    assert opt.step_count == 2 and not torch.equal(w.detach(), before_w)
    # without the option the inf goes into the weights
    v = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    plain = make_optimizer([v], 1e-2)
    v.grad = torch.tensor([0.5, float("nan"), -0.2])
    plain.step()
    assert not torch.isfinite(v).all()
