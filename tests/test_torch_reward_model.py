"""The on-device reward model against the JAX package.

- The reward model's scores (``reward_model_scores``, JAX ``_rm_scores``)
  and ``rollout_score_rm`` on the JAX trainer's policy and
  reward-model weights equal the JAX package's within 1e-5 (f32), an
  all-padding row (score 0) and a response cut short by EOS included; the
  eval scores are the same function.
- A twin of ``tests/test_e2e.py::test_ppo_with_on_device_reward_model``:
  PPO on randomwalks scored by the reward model alone (no ``reward_fn``),
  with reward-model rewards in ``evaluate()``.
- The engine path scores its chunks with the reward model.
- ``reward_fn`` together with a reward model raises JAX's ValueError.
- The reward model is frozen, outside the optimizer and the checkpoint; it
  loads from ``reward_model_path`` (an HF directory) with a seeded value
  head.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.hf_export import export_hf
from trlx_tpu_torch.models.hf_import import load_hf_trunk, params_from_jax
from trlx_tpu_torch.trainer.ppo import PPOTrainer, reward_model_scores

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
from randomwalks import base_config, generate_random_walks  # noqa: E402

torch.set_num_threads(1)

V, P, R = 31, 10, 6
ARCH = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
            parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
            extra={"lm_head_bias": True}, eos_token_id=1)


def _config(tmp_path, **method):
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=ARCH,
                      reward_model_arch=dict(ARCH, n_layer=2), dtype="float32", param_dtype="float32"),
        "train": dict(total_steps=2, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                      weight_decay=1e-4,
                      learning_rate_init=3e-3, learning_rate_target=3e-4, checkpoint_interval=10**6,
                      eval_interval=100, checkpoint_dir=str(tmp_path), seed=11),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=1, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, top_k=0, top_p=0.9, temperature=0.7,
                                       do_sample=True), **method),
    }


def _batch():
    """Left-padded prompts and responses: a row cut short by EOS, a row of
    one prompt token, and a row that is all padding."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, V, size=(5, P + R)).astype(np.int32)
    mask = np.ones_like(tokens)
    for i, n_pad in enumerate((0, 3, 7, P - 1, P + R)):
        mask[i, :n_pad] = 0
        tokens[i, :n_pad] = 0
    mask[0, P + 2:] = 0  # EOS after two response tokens, then padding
    tokens[0, P + 2:] = 0
    return tokens, mask


def test_rm_scores_and_rollout_score_rm_match_jax(tmp_path):
    """The same policy, reference and reward-model weights: the port's RM
    scores, eval scores and RM rollout scoring equal JAX's within 1e-5."""
    cfg = _config(tmp_path)
    jm = JaxPPOTrainer(JaxTRLConfig.from_dict(cfg))
    tm = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    tm.load_params(params_from_jax(jax.device_get(jm.state.params), tm.model),
                   params_from_jax(jax.device_get(jm.state.extras), tm.model))
    rm_params = params_from_jax(jax.device_get(jm.rm_params), tm.rm_model)
    assert set(rm_params) == {n for n, _ in tm.rm_model.named_parameters()}
    with torch.no_grad():
        for n, p in tm.rm_model.named_parameters():
            p.copy_(rm_params[n])

    tokens, mask = _batch()
    want = np.asarray(jm._rm_scores(jm.rm_params, tokens, mask))
    got = reward_model_scores(tm.rm_model, torch.as_tensor(tokens), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[-1] == 0.0 and np.all(got[:-1] != 0.0)
    np.testing.assert_array_equal(tm.rm_eval_scores(tokens, mask).numpy(), got)

    jout = [np.asarray(x) for x in jm.rollout_score_rm(tokens, mask)]
    tout = [x.numpy() for x in tm.rollout_score_rm(tokens, mask)]
    for name, a, b in zip(("logprobs", "values", "rewards", "kl", "scores"), tout, jout, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_ppo_with_on_device_reward_model(tmp_path):
    """PPO driven by the reward model alone: rollouts are scored on the
    device, ``evaluate()`` reports the reward model's mean, and the eval
    scores are one finite scalar per sequence."""
    walks, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps, config.train.epochs, config.train.batch_size = 2, 2, 16
    config.train.eval_interval = 4
    config.train.checkpoint_dir = str(tmp_path)
    config.method.num_rollouts, config.method.chunk_size = 16, 16
    config.model.reward_model_arch = dict(config.model.model_arch)
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    model = trlx_tpu_torch.train(prompts=prompts, eval_prompts=[[i] for i in range(1, 15)], metric_fn=metric_fn,
                                 config=config, logit_mask=logit_mask, device="cpu")
    assert model.has_reward_model and model.reward_fn is None
    assert model.iter_count >= 2 and len(model.store) > 0
    stats = model.evaluate()
    assert "mean_reward" in stats and "reward_time" not in stats
    batch, _ = next(iter(model.eval_dataloader.iter_with_valid()))
    tokens, mask = model.rollout_generate(batch["input_ids"], batch["attention_mask"])
    scores = model.rm_eval_scores(tokens, mask).numpy()
    assert scores.shape == (batch["input_ids"].shape[0],) and np.isfinite(scores).all()
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        exp = [r for r in map(json.loads, f) if "exp_time" in r]
    assert exp and all(r["exp_reward_s"] == 0.0 and r["exp_rm_score_device_s"] > 0.0 for r in exp)


def test_engine_path_scores_with_reward_model(tmp_path, monkeypatch):
    """Through the rollout engine, every harvested chunk is scored by
    ``rollout_score_rm``, whose scores are the reward model's on exactly
    the stored rows; training runs and the engine shuts down."""
    cfg = _config(tmp_path, rollout_engine=True, engine_slots=4, prefill_batch=2, engine_steps_per_sync=2)
    calls = []
    orig = PPOTrainer.rollout_score_rm

    def recording(self, tokens, mask, timings=None):
        out = orig(self, tokens, mask, timings)
        calls.append((np.asarray(tokens), np.asarray(mask), out[-1].numpy()))
        return out

    monkeypatch.setattr(PPOTrainer, "rollout_score_rm", recording)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]
    model = trlx_tpu_torch.train(prompts=prompts, config=TRLConfig.from_dict(cfg), device="cpu")
    assert model.iter_count == 2 and model.reward_fn is None and model._rollout_engine is None
    assert sum(len(t) for t, _, _ in calls) >= 16
    for tokens, mask, scores in calls:
        want = reward_model_scores(model.rm_model, torch.as_tensor(tokens), torch.as_tensor(mask))
        np.testing.assert_array_equal(scores, want.numpy())
    cols = model.store.columns()
    stored = {tuple(np.concatenate([q, r])) for q, r in zip(cols["query_tensors"], cols["response_tensors"])}
    last = calls[-2:] if len(calls) > 1 else calls
    assert stored == {tuple(row) for t, _, _ in last for row in t}


def test_reward_fn_with_reward_model_raises(tmp_path):
    config = TRLConfig.from_dict(_config(tmp_path))
    with pytest.raises(ValueError, match="Both reward_fn and an on-device reward model"):
        trlx_tpu_torch.train(reward_fn=lambda s: [0.0] * len(s), prompts=[[2, 3]], config=config, device="cpu")


def test_reward_model_frozen_outside_state_and_loaded_from_hf(tmp_path):
    """The reward model trains nothing, is outside the optimizer and the
    saved state, and loads its trunk from ``reward_model_path``; its value
    head is seeded from the config (two trainers agree)."""
    cfg = _config(tmp_path)
    trainer = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    assert all(not p.requires_grad for p in trainer.rm_model.parameters())
    assert not any(n.startswith("rm") for n in trainer.optimizer.names)
    rm_ids = {id(p) for p in trainer.rm_model.parameters()}
    state = trainer.state_tensors()
    assert not any(id(t) in rm_ids for group in ("params", "extras") for t in state[group].values())

    rm_dir = export_hf(dict(trainer.rm_model.named_parameters()), trainer.rm_model.cfg, str(tmp_path / "rm"))
    cfg2 = _config(tmp_path)
    cfg2["model"]["reward_model_arch"], cfg2["model"]["reward_model_path"] = {}, rm_dir
    loaded = [PPOTrainer(TRLConfig.from_dict(cfg2), device="cpu") for _ in range(2)]
    trunk = load_hf_trunk(rm_dir, loaded[0].rm_model.cfg)
    for k, v in loaded[0].rm_model.transformer.state_dict().items():
        assert torch.equal(v, trunk[k]), k
    assert loaded[0].load_log["reward_model"]["bytes"] > 0 and loaded[0].load_log["policy"] is None
    for a, b in zip(loaded[0].rm_model.v_head.parameters(), loaded[1].rm_model.v_head.parameters()):
        assert torch.equal(a, b)
    tokens, mask = _batch()
    scores = reward_model_scores(loaded[0].rm_model, torch.as_tensor(tokens), torch.as_tensor(mask)).numpy()
    assert np.isfinite(scores).all() and np.all(scores[:-1] != 0) and scores[-1] == 0
