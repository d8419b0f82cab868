"""The port's PPO math against the JAX package's, on the same seeded numpy
inputs in float32: GAE, masked whitening, the clipped PPO loss with every
statistic and its gradients, the learning-rate schedule, and one clip +
AdamW update with a freeze mask against the optax transform of
``build_optimizer``.

Tolerance 1e-5 (absolute and relative): float32 on both sides; what remains
is the order of the sums (a Python loop vs ``lax.scan``, torch vs XLA
reductions)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trlx_tpu.ops import modeling as jax_modeling
from trlx_tpu.ops import rl_losses as jax_losses
from trlx_tpu.trainer.base import build_optimizer as jax_build_optimizer
from trlx_tpu.trainer.base import lr_schedule as jax_lr_schedule
from trlx_tpu_torch.ops import modeling, rl_losses
from trlx_tpu_torch.trainer.base import build_optimizer, lr_schedule

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_KW = dict(gamma=0.99, lam=0.95, cliprange=0.2, cliprange_value=0.2, vf_coef=0.7)


def _ppo_inputs(seed=0, b=4, R=9):
    rng = np.random.default_rng(seed)
    f = lambda scale=1.0: (rng.normal(size=(b, R)) * scale).astype(np.float32)  # noqa: E731
    mask = np.ones((b, R), np.float32)
    for i, L in enumerate((R, R - 3, 2, R - 1)[:b]):
        mask[i, L:] = 0
    return dict(logprobs=f(0.3) - 1.0, vpred=f(), old_logprobs=f(0.3) - 1.0, old_values=f(), rewards=f(),
                mask=mask)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_gae_matches_jax():
    d = _ppo_inputs(1)
    ref = jax_losses.gae_advantages(jnp.asarray(d["rewards"]), jnp.asarray(d["old_values"]), jnp.asarray(d["mask"]),
                                    0.99, 0.95)
    got = rl_losses.gae_advantages(_t(d["rewards"]), _t(d["old_values"]), _t(d["mask"]), 0.99, 0.95)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert np.all(got[0].numpy()[d["mask"] == 0] == 0)


def test_masked_whiten_matches_jax():
    d = _ppo_inputs(2)
    for shift in (True, False):
        ref = jax_modeling.masked_whiten(jnp.asarray(d["rewards"]), jnp.asarray(d["mask"]), shift_mean=shift)
        got = modeling.masked_whiten(_t(d["rewards"]), _t(d["mask"]), shift_mean=shift)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_ppo_loss_stats_and_grads_match_jax(seed):
    """Every statistic, and the gradients with respect to the policy
    logprobs and the value predictions."""
    d = _ppo_inputs(seed)

    def jax_loss(lp, vp):
        return jax_losses.ppo_loss(lp, vp, *(jnp.asarray(d[k]) for k in ("old_logprobs", "old_values", "rewards",
                                                                         "mask")), **LOSS_KW)

    (ref_loss, ref_stats), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(d["logprobs"]), jnp.asarray(d["vpred"])
    )
    lp, vp = _t(d["logprobs"]).requires_grad_(), _t(d["vpred"]).requires_grad_()
    loss, stats = rl_losses.ppo_loss(lp, vp, *(_t(d[k]) for k in ("old_logprobs", "old_values", "rewards", "mask")),
                                     **LOSS_KW)
    loss.backward()
    assert set(stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(float(stats[k]), float(ref_stats[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), **TOL)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(ref_grads[0]), **TOL)
    np.testing.assert_allclose(vp.grad.numpy(), np.asarray(ref_grads[1]), **TOL)


def _train_cfg(**kw):
    base = dict(learning_rate_init=2e-3, learning_rate_target=2e-4, lr_ramp_steps=5, lr_decay_steps=20,
                weight_decay=1e-2, opt_betas=(0.9, 0.95), grad_clip=1.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("ramp", [0, 5])
def test_lr_schedule_matches_optax(ramp):
    cfg = _train_cfg(lr_ramp_steps=ramp)
    ref, got = jax_lr_schedule(cfg), lr_schedule(cfg)
    for step in (0, 1, 2, 4, 5, 6, 11, 24, 25, 26, 40):
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-12)


def test_clip_adamw_update_with_freeze_mask_matches_optax():
    """Three updates on random parameters and gradients: the first with a
    gradient norm far above the clip, the others below it; the frozen
    parameter gets no update and no moments."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (7,), "frozen": (4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mask = {"a": True, "b": True, "frozen": False}
    cfg = _train_cfg(lr_ramp_steps=1)
    opt, _ = jax_build_optimizer(cfg, mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)

    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    trainable = [tp["a"], tp["b"]]
    topt, _ = build_optimizer(cfg, trainable, ["a", "b"])
    for step, scale in enumerate((30.0, 0.05, 0.1)):
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step(trainable, [torch.from_numpy(grads["a"]), torch.from_numpy(grads["b"])])
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} after update {step}")
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])
