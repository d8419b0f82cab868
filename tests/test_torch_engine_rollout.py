"""The engine slice as a whole, against the JAX package.

- ``make_experience`` through the continuous-batching engine
  (``method.rollout_engine``), paged with prefix caching and an int8 KV
  cache, greedy: the same tiny config, weights and token prompts go through
  both packages' ``PPOTrainer`` + ``PromptPipeline`` +
  ``PPOOrchestrator``. The stores hold the same rows in the same
  (completion) order, token for token; logprobs, values and rewards (scored
  unfused, by a float32 re-forward on both sides) agree within 1e-4; the
  engine counters (prefix hits, saved tokens, decode steps) are equal.
- The chunked sampler with ``kv_cache_quant``: the fused rollout statistics
  are the int8 decode's own on both sides. Tokens follow a forced bigram
  mask (one successor per token), so sampling takes the same path in both
  packages though their random streams differ. An int8 code can land one
  apart where float32 rounding differs by an ulp at a code boundary, which
  moves a logprob by ~1e-3, hence 2e-3 there.
- A tiny ``trlx_tpu_torch.train`` through the paged int8 engine runs its
  steps with finite losses, logs the engine's gauges and tears the engine
  down (the JAX package's ``test_ppo_with_rollout_engine_trains_and_tears_down``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.orchestrator.ppo_orchestrator import PPOOrchestrator as JaxPPOOrchestrator
from trlx_tpu.pipeline.prompt_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo import PPOTrainer

# Tiny shapes: one intra-op thread, so torch's thread pool does not compete
# with the other test files' workers for the cores.
torch.set_num_threads(1)

V, P, R = 31, 10, 6
N_ROLLOUTS = 8


def _config(tmp_path, engine: bool, quant: bool, sample: bool):
    arch = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True})
    method = dict(name="ppoconfig", num_rollouts=N_ROLLOUTS, chunk_size=8, init_kl_coef=0.3, ppo_epochs=2,
                  gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                  temperature=0.7, do_sample=sample))
    if engine:
        method.update(rollout_engine=True, engine_slots=3, prefill_batch=2, engine_steps_per_sync=2, paged_kv=True,
                      kv_block_size=4)
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32", kv_cache_quant=quant),
        "train": dict(total_steps=4, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=1, lr_decay_steps=8,
                      weight_decay=0.0, learning_rate_init=1e-4, learning_rate_target=1e-4,
                      checkpoint_interval=10**6, eval_interval=10**6, checkpoint_dir=str(tmp_path), seed=11),
        "method": method,
    }


def _reward_fn(samples):
    return [float(np.sum(s) % 7) - 3.0 for s in samples]


def _prompts(rng):
    """Random lengths (so left padding), plus three full-width prompts that
    share their first 8 tokens: two 4-token blocks a later admission hits."""
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(5)]
    head = rng.integers(1, V, size=8).tolist()
    prompts += [head + rng.integers(1, V, size=2).tolist() for _ in range(3)]
    return prompts


def _both(tmp_path, cfg, prompts, logit_mask=None):
    """make_experience(8) in both packages from the JAX trainer's weights:
    (JAX trainer, port trainer, the port's phase stats)."""
    jt = JaxPPOTrainer(JaxTRLConfig.from_dict(cfg), reward_fn=_reward_fn, logit_mask=logit_mask)
    jorch = JaxPPOOrchestrator(jt, JaxPromptPipeline(prompts, None, max_prompt_length=P), reward_fn=_reward_fn,
                               chunk_size=8)
    jorch.make_experience(N_ROLLOUTS)
    tt = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu", reward_fn=_reward_fn, logit_mask=logit_mask)
    tt.load_params(params_from_jax(jax.device_get(jt.state.params), tt.model),
                   params_from_jax(jax.device_get(jt.state.extras), tt.model))
    torch_orch = PPOOrchestrator(tt, PromptPipeline(prompts, None, max_prompt_length=P), reward_fn=_reward_fn,
                                 chunk_size=8)
    stats = torch_orch.make_experience(N_ROLLOUTS)
    assert len(tt.store) == len(jt.store) == N_ROLLOUTS
    return jt, tt, stats


def test_engine_make_experience_matches_jax(tmp_path):
    """Paged + int8 engine, greedy: identical stores and engine counters."""
    prompts = _prompts(np.random.default_rng(0))
    cfg = _config(tmp_path, engine=True, quant=True, sample=False)
    jt, tt, stats = _both(tmp_path, cfg, prompts)
    ref, got = jt.store.columns(), tt.store.columns()
    for key in ("query_tensors", "query_mask", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-4, err_msg=key)
    assert tt.rollout_engine().pool.hits_total >= 1
    js = {k: v for k, v in _last_exp_record(jt).items() if k.startswith("engine/")}
    for key in ("engine/prefix_hits_total", "engine/prefill_tokens_saved_total", "engine/decode_steps",
                "engine/gen_tokens", "engine/refills", "engine/prefill_batches", "engine/slot_occupancy"):
        assert stats[key] == js[key], key
    assert stats["exp_decode_steps_per_episode"] == R


def _last_exp_record(jt):
    with open(os.path.join(jt.config.train.checkpoint_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "exp_time" in r][-1]


def test_chunked_int8_make_experience_matches_jax(tmp_path):
    """The whole-batch sampler over the int8 cache, fused statistics from
    the int8 decode itself on both sides."""
    rng = np.random.default_rng(1)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(12)]
    cfg = _config(tmp_path, engine=False, quant=True, sample=True)
    jt, tt, _ = _both(tmp_path, cfg, prompts, logit_mask)
    assert jt.fused_rollout and tt.fused_rollout
    ref, got = jt.store.columns(), tt.store.columns()
    for key in ("query_tensors", "query_mask", "response_tensors", "response_mask"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(got[key], ref[key], rtol=2e-3, atol=2e-3, err_msg=key)
    # The fused logprobs are the int8 decode's: they differ from a
    # full-precision re-forward, by about what the JAX package measured.
    tokens, mask = (tt.put(np.concatenate([got[f"query_{k}"], got[f"response_{k}"]], 1))
                    for k in ("tensors", "mask"))
    lp = tt.to_host(tt.rollout_score(tokens, mask, np.zeros(N_ROLLOUTS, np.float32))[0])
    delta = np.abs(lp - got["logprobs"])
    assert 0.0 < delta.max() < 0.05


@pytest.mark.parametrize("paged", [True, False], ids=["paged-int8", "fixed-int8"])
def test_train_through_the_engine_runs_and_tears_down(tmp_path, paged):
    cfg = _config(tmp_path, engine=True, quant=True, sample=True)
    cfg["method"]["paged_kv"] = paged
    prompts = _prompts(np.random.default_rng(2)) * 2
    trainer = trlx_tpu_torch.train(reward_fn=_reward_fn, prompts=prompts, eval_prompts=prompts[:4],
                                   config=TRLConfig.from_dict(cfg), device="cpu")
    assert trainer.iter_count == 4 and trainer._rollout_engine is None
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    exp = [r for r in records if "exp_time" in r]
    assert len(exp) == 2  # the first phase and the one after epoch 1
    for r in exp:
        assert 0.0 < r["engine/slot_occupancy"] <= 1.0 and r["engine/completed"] == N_ROLLOUTS
        assert r["exp_decode_steps_per_episode"] == R
        if paged:
            assert r["engine/pool_used_blocks"] == 0  # the phase drained
    step1 = [r for r in records if r.get("step") == 1 and "mean_ratio" in r]
    assert step1 and abs(step1[0]["mean_ratio"] - 1.0) < 1e-4
