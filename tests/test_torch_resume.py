"""Resume against the JAX package: a run of k steps, then a second run with
``train.resume_from_checkpoint`` to 2k, through ``trlx_tpu.train`` and
through ``trlx_tpu_torch.train`` (the port starting from the JAX trainer's
initial weights, ``params_from_jax``), on the CPU in float32.

Both packages restart the prompt schedule at chunk 0 in a resumed run (the
JAX package saves no chunk position) and restore the parameters, the
optimizer's moments and count, the step, the extras and the KL coefficient,
so the resumed steps k+1..2k agree as an uninterrupted run's later steps
do: step 1 within 1e-5, every later step within 2e-4 (the tolerances of
``tests/test_torch_train.py::test_train_matches_jax``), and the KL
controller's final value within 1e-6 relative. PPO runs on the einsum
route and on the kernel route (flash attention and the fused head: the JAX
package's Pallas kernels in interpret mode, the port's plain versions);
ILQL on its dense and fused routes, with equal greedy eval tokens.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.trainer.ilql import ILQLTrainer as JaxILQLTrainer
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.ilql import ILQLTrainer
from trlx_tpu_torch.trainer.ppo import PPOTrainer

torch.set_num_threads(1)

V, P, R, T = 31, 10, 6, 12
_JAX_INIT = {}


class _FromJaxInitUnlessResumed:
    """A trainer that starts from the JAX trainer's initial parameters and
    extras, unless it has just resumed from a checkpoint."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        if not self._resumed:
            self.load_params(params_from_jax(_JAX_INIT["params"], self.model),
                             params_from_jax(_JAX_INIT["extras"], self.model))


@register_model("PPOResumeFromJaxInit")
class _PPO(_FromJaxInitUnlessResumed, PPOTrainer):
    pass


@register_model("ILQLResumeFromJaxInit")
class _ILQL(_FromJaxInitUnlessResumed, ILQLTrainer):
    pass


def _arch(kernels: bool):
    extra = {"lm_head_bias": True}
    arch = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64,
                pos_type="rotary", rotary_dim=4, parallel_residual=True, fused_qkv=False, qkv_bias=False,
                out_bias=False, tie_word_embeddings=False, extra=extra)
    if kernels:
        arch["attn_impl"] = "flash"
        extra["fused_logprob"] = "force"
    return arch


def _ppo_config(ckpt_dir, kernels: bool, total_steps: int, resume: bool):
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1,
                      model_arch=_arch(kernels), dtype="float32", param_dtype="float32", remat=kernels),
        "train": dict(total_steps=total_steps, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=2,
                      lr_decay_steps=12, weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                      checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(ckpt_dir), seed=11,
                      resume_from_checkpoint=resume),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }


def _ilql_config(ckpt_dir, kernels: bool, total_steps: int, resume: bool):
    arch = dict(_arch(kernels), n_layer=2, eos_token_id=0)
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ilql", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32", remat=kernels),
        "train": dict(total_steps=total_steps, seq_length=T, epochs=2, batch_size=8, lr_ramp_steps=2,
                      lr_decay_steps=12, weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                      checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(ckpt_dir), seed=11,
                      orchestrator="OfflineOrchestrator", resume_from_checkpoint=resume),
        "method": dict(name="ilqlconfig", tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, alpha=0.1,
                       steps_for_target_q_sync=1, betas=[2.0], two_qs=True,
                       gen_kwargs=dict(prompt_length=5, max_new_tokens=6, top_k=8, do_sample=False)),
    }


def _step_stats(path, key):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec
    return out


def _assert_steps_match(ts, js, keys, steps):
    assert sorted(ts) == sorted(js) == list(range(1, steps + 1))
    for step in range(1, steps + 1):
        tol = 1e-5 if step == 1 else 2e-4
        for k in keys:
            np.testing.assert_allclose(ts[step][k], js[step][k], rtol=tol, atol=tol, err_msg=f"step {step} {k}")
        assert ts[step]["resilience/nonfinite"] == 0.0


PPO_KEYS = ("loss", "pg_loss", "vf_loss", "pg_clipfrac", "vf_clipfrac", "mean_kl", "mean_ratio", "mean_return",
            "mean_advantage", "mean_entropy", "explained_variance", "grad_norm", "learning_rate")


@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "kernel-route"])
def test_ppo_resume_matches_jax(tmp_path, kernels):
    """4 steps (one rollout phase), saved at total_steps; a resumed run to 8
    (a fresh rollout from the restored policy, 4 more steps); in both
    packages, on the same forced-bigram task as the uninterrupted parity
    test, so sampling follows one path though the random streams differ."""
    rng = np.random.default_rng(0)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]

    def reward_fn(samples):
        return [float(np.sum(s) % 7) - 3.0 for s in samples]

    runs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        for total, resume in ((4, False), (8, True)):
            cfg = _ppo_config(d, kernels, total, resume)
            if name == "jax":
                if not resume:
                    init = JaxPPOTrainer(JaxTRLConfig.from_dict(cfg))
                    _JAX_INIT["params"] = jax.device_get(init.state.params)
                    _JAX_INIT["extras"] = jax.device_get(init.state.extras)
                    del init
                model = trlx_tpu.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                       config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
                assert model._resumed == resume
            else:
                cfg["model"]["model_type"] = "PPOResumeFromJaxInit"
                model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                             config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
                assert model._resumed == resume and model.step == model.iter_count == total
        runs[name] = (model, _step_stats(os.path.join(d, "metrics.jsonl"), "loss"))

    (jm, js), (tm, ts) = runs["jax"], runs["torch"]
    assert tm.iter_count == jm.iter_count == 8
    _assert_steps_match(ts, js, PPO_KEYS, 8)
    np.testing.assert_allclose(tm.kl_ctl.value, jm.kl_ctl.value, rtol=1e-6)
    assert tm.kl_ctl.value != 0.3  # the controller moved


ILQL_KEYS = ("losses/loss", "losses/loss_q", "losses/loss_v", "losses/loss_cql", "losses/loss_awac", "grad_norm",
             "learning_rate")


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel-route"])
def test_ilql_resume_matches_jax(tmp_path, kernels):
    """2 steps, saved; a resumed run to 4; in both packages. The target Q
    heads are part of the saved state; the resumed steps, the final heads
    and the greedy eval tokens (steered by the restored-then-synced target
    heads) agree."""
    rng = np.random.default_rng(0)
    samples = [rng.integers(1, V, size=int(rng.integers(3, T + 4))).astype(np.int32) for _ in range(16)]
    rewards = rng.normal(size=(16,)).astype(np.float32).tolist()
    rng = np.random.default_rng(9)
    logit_mask = rng.random((V, V)) < 0.3
    eval_prompts = [rng.integers(1, V, size=int(rng.integers(1, 6))).tolist() for _ in range(6)]
    runs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        for total, resume in ((2, False), (4, True)):
            cfg = _ilql_config(d, kernels, total, resume)
            evals = []

            def metric_fn(samples_, evals=evals):
                evals.append([np.asarray(s).astype(np.int64).tolist() for s in samples_])
                return {"length": [float(len(s)) for s in samples_]}

            if name == "jax":
                if not resume:
                    init = JaxILQLTrainer(JaxTRLConfig.from_dict(cfg))
                    _JAX_INIT["params"] = jax.device_get(init.state.params)
                    _JAX_INIT["extras"] = jax.device_get(init.state.extras)
                    del init
                model = trlx_tpu.train(dataset=(samples, rewards), eval_prompts=eval_prompts, metric_fn=metric_fn,
                                       config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
                assert model._resumed == resume
                heads = params_from_jax(jax.device_get(model.state.extras))
            else:
                cfg["model"]["model_type"] = "ILQLResumeFromJaxInit"
                model = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=eval_prompts,
                                             metric_fn=metric_fn, config=TRLConfig.from_dict(cfg),
                                             logit_mask=logit_mask, device="cpu")
                assert model._resumed == resume and model.step == model.iter_count == total
                heads = {k: v.detach() for k, v in model.extras.items()}
        runs[name] = (model, _step_stats(os.path.join(d, "metrics.jsonl"), "losses/loss"), heads, evals)

    (jm, js, jh, je), (tm, ts, th, te) = runs["jax"], runs["torch"]
    assert tm.iter_count == jm.iter_count == 4
    _assert_steps_match(ts, js, ILQL_KEYS, 4)
    assert sorted(th) == sorted(jh) and len(th) == 8
    for k in th:
        np.testing.assert_allclose(np.asarray(th[k]), np.asarray(jh[k]), rtol=2e-4, atol=2e-4, err_msg=k)
    assert len(te) == len(je) == 1 and te == je
