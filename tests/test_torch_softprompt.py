"""Soft-prompt PPO in the port against the JAX package's (twins of
``tests/test_softprompt.py``, and of its trainer).

- The model: the learned prefix changes the outputs and is sliced back out
  (the port's logits and values equal the JAX model's on the same weights,
  float32, within 1e-5); cached decode with the prefix equals the no-cache
  forward and the JAX sampler, token for token, with bf16 and int8 KV.
- The trainer: only ``transformer.soft_prompt`` and ``v_head`` train;
  ``initialize_from_vocab`` starts the prefix as the first rows of the
  embedding; the reference shares the policy's frozen tensors and owns only
  the initial prefix, and its logprobs are bit-equal to those of a full
  frozen copy of every parameter (the JAX package's layout); a hydra branch
  is refused; ``save_pretrained`` carries the prefix in the heads file.
- ``train()`` through ``PPOSoftpromptTrainer`` against ``trlx_tpu.train`` over
  4 PPO steps from the same initial weights, on the einsum route and on the
  kernel route (the JAX side's Pallas kernels in interpret mode, the port's
  plain versions through its autograd Functions), at the PPO twin's
  tolerances (tests/test_torch_train.py): step 1 within 1e-5, later steps
  within 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.models import LMConfig as JaxLMConfig
from trlx_tpu.models import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.ops.generate import make_generate_fn as jax_make_generate_fn
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig
from trlx_tpu.trainer.ppo_softprompt import PPOSoftpromptTrainer as JaxPPOSoftpromptTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithValueHead, swapped_params
from trlx_tpu_torch.models.hf_export import HEADS_FILE
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.models.lm import LMConfig
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.sampling import GenerateConfig
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.ppo_softprompt import PPOSoftpromptTrainer

torch.set_num_threads(1)


def _build(n_soft=4, **kw):
    """The JAX test's model: (JAX module, JAX params, the port's module on
    the same weights, ids [2, 6] with row 0 left-padded, mask)."""
    arch = dict(vocab_size=29, n_layer=2, n_head=2, d_model=32, max_position=64, dtype="float32",
                n_soft_tokens=n_soft, **kw)
    jmodel = JaxLMWithValueHead(JaxLMConfig(**arch))
    rng = jax.random.PRNGKey(0)
    ids = jax.random.randint(rng, (2, 6), 1, 29)
    mask = jnp.ones((2, 6), jnp.int32).at[0, :2].set(0)
    params = jax.device_get(jmodel.init(rng, ids, mask)["params"])
    model = LMWithValueHead(LMConfig(**arch), device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    model.requires_grad_(False)
    return jmodel, params, model, np.asarray(ids), np.asarray(mask)


def test_soft_prompt_changes_logits_and_preserves_shape():
    jmodel, params, model, ids, mask = _build()
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    jout = jmodel.apply({"params": params}, ids, mask)
    assert out["logits"].shape == (2, 6, 29)  # the prefix is sliced out
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["values"].numpy(), np.asarray(jout["values"]), rtol=1e-5, atol=1e-5)
    # A random (not constant) perturbation: LayerNorm cancels uniform shifts.
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), params["transformer"]["soft_prompt"].shape))
    with torch.no_grad():
        model.transformer.soft_prompt.add_(torch.from_numpy(noise))
        out2 = model(torch.from_numpy(ids), torch.from_numpy(mask))
        model.transformer.soft_prompt.sub_(torch.from_numpy(noise))
    assert float((out2["logits"] - out["logits"]).abs().max()) > 1e-3


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_soft_prompt_generate_cache_consistency(quant):
    """Cached decode with the prefix (cache rows [0, n_soft), steps at
    P + step + n_soft without re-prepending) equals the no-cache forward
    (float32 cache) and the JAX sampler token for token."""
    jmodel, params, model, ids, mask = _build(kv_cache_quant=quant)
    gkw = dict(max_new_tokens=4, do_sample=False, pad_token_id=0)
    toks, m = make_generate_fn(model, GenerateConfig(**gkw))(ids, mask, None)
    jt, jm = jax_make_generate_fn(jmodel, JaxGenerateConfig(**gkw))({"params": params}, ids, mask,
                                                                   jax.random.PRNGKey(1))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    if quant:
        return
    cur_ids, cur_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        for _ in range(4):
            nxt = model(cur_ids, cur_mask)["logits"][:, -1].float().argmax(-1)[:, None]
            cur_ids = torch.cat([cur_ids, nxt.to(cur_ids.dtype)], 1)
            cur_mask = torch.cat([cur_mask, torch.ones((2, 1), dtype=cur_mask.dtype)], 1)
    np.testing.assert_array_equal(toks.numpy(), cur_ids.numpy())


V, P, R = 31, 10, 6


def _config(tmp_path, kernels: bool, steps: int = 4):
    extra = {"lm_head_bias": True}
    arch = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra=extra)
    if kernels:
        arch["attn_impl"] = "flash"
        extra["fused_logprob"] = "force"
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo_softprompt", num_layers_unfrozen=-1,
                      model_arch=arch, dtype="float32", param_dtype="float32", remat=kernels),
        "train": dict(total_steps=steps, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=2,
                      lr_decay_steps=12, weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                      checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(tmp_path), seed=11),
        "method": dict(name="pposoftpromptconfig", n_soft_tokens=4, initialize_from_vocab=True, num_rollouts=16,
                       chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0, horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }


def test_softprompt_trainable_mask_and_vocab_init(tmp_path):
    trainer = PPOSoftpromptTrainer(TRLConfig.from_dict(_config(tmp_path, kernels=False)), device="cpu")
    model = trainer.model
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trained == trainer.opt_mask
    assert "transformer.soft_prompt" in trained
    assert {"v_head.layers_0.kernel", "v_head.layers_1.bias"} <= trained
    assert not any(n.startswith(("transformer.h_", "transformer.wte", "transformer.lm_head", "transformer.ln_f"))
                   for n in trained)
    assert model.branch_layer == -1 and not trainer.fused_rollout
    torch.testing.assert_close(model.transformer.soft_prompt, model.transformer.wte.embedding[:4], rtol=0, atol=0)
    with pytest.raises(ValueError, match="hydra"):
        LMWithValueHead(model.cfg, branch_layer=1, device="cpu")


def test_shared_trunk_reference_equals_full_clone(tmp_path):
    """The reference owns only the initial prefix (no copy of the trunk);
    after the prefix and the value head moved, its logprobs are bit-equal
    to those of a full frozen copy of every initial parameter, and the
    policy's differ."""
    trainer = PPOSoftpromptTrainer(TRLConfig.from_dict(_config(tmp_path, kernels=False)), device="cpu")
    model = trainer.model
    assert set(trainer.extras) == {"transformer.soft_prompt"}
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        g = torch.Generator().manual_seed(0)
        for p in model.parameters():
            if p.requires_grad:
                p.add_(torch.randn(p.shape, generator=g) * 0.5)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, V, size=(4, P + R)).astype(np.int64))
    mask = torch.ones_like(tokens)
    mask[0, :3] = 0
    scores = torch.zeros((4,))
    trainer.kl_ctl.value = 1.0
    lp, _, _, kl = trainer.rollout_score(tokens, mask, scores)
    shared_ref = lp - kl
    trainer.extras = full
    lp2, _, _, kl2 = trainer.rollout_score(tokens, mask, scores)
    assert torch.equal(lp, lp2)
    assert torch.equal(shared_ref, lp2 - kl2)
    with torch.no_grad(), swapped_params(model, full):
        ref = model(tokens, mask)["logits"]
    with torch.no_grad():
        pol = model(tokens, mask)["logits"]
    assert not torch.equal(ref, pol)


def test_save_pretrained_carries_the_soft_prompt(tmp_path):
    trainer = PPOSoftpromptTrainer(TRLConfig.from_dict(_config(tmp_path / "run", kernels=False)), device="cpu")
    out = trainer.save_pretrained(str(tmp_path / "hf"))
    heads = np.load(os.path.join(out, HEADS_FILE))
    np.testing.assert_array_equal(heads["soft_prompt"], trainer.model.transformer.soft_prompt.detach().numpy())
    assert "v_head/layers_0/kernel" in heads


_JAX_INIT = {}


@register_model("PPOSoftpromptFromJaxInit")
class _SoftFromJaxInit(PPOSoftpromptTrainer):
    """The port's soft-prompt trainer starting from the JAX trainer's
    initial parameters; of the JAX package's full frozen reference it keeps
    only what the port's layout owns."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        own = set(self.extras)
        extras = {k: v for k, v in params_from_jax(_JAX_INIT["extras"], self.model).items() if k in own}
        self.load_params(params_from_jax(_JAX_INIT["params"], self.model), extras)


STAT_KEYS = ("loss", "pg_loss", "vf_loss", "pg_clipfrac", "vf_clipfrac", "mean_kl", "mean_ratio", "mean_return",
             "mean_advantage", "mean_entropy", "explained_variance", "grad_norm", "learning_rate")


@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "kernel-route"])
def test_softprompt_train_matches_jax(tmp_path, kernels):
    import json

    rng = np.random.default_rng(0)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]

    def reward_fn(samples):
        return [float(np.sum(s) % 7) - 3.0 for s in samples]

    stats = {}
    for name in ("jax", "torch"):
        cfg = _config(tmp_path / name, kernels)
        if name == "jax":
            init = JaxPPOSoftpromptTrainer(JaxTRLConfig.from_dict(cfg))
            _JAX_INIT["params"] = jax.device_get(init.state.params)
            _JAX_INIT["extras"] = jax.device_get(init.state.extras)
            del init
            trlx_tpu.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                           config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
        else:
            cfg["model"]["model_type"] = "PPOSoftpromptFromJaxInit"
            trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                           config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
        with open(os.path.join(tmp_path, name, "metrics.jsonl")) as f:
            stats[name] = {r["step"]: r for r in map(json.loads, f) if "loss" in r}
    assert sorted(stats["torch"]) == sorted(stats["jax"]) == [1, 2, 3, 4]
    for step in range(1, 5):
        tol = 1e-5 if step == 1 else 2e-4
        for k in STAT_KEYS:
            np.testing.assert_allclose(stats["torch"][step][k], stats["jax"][step][k], rtol=tol, atol=tol,
                                       err_msg=f"step {step} {k}")
    # Only the prefix and the value head moved.
    init = params_from_jax(_JAX_INIT["params"], trainer.model)
    for n, p in trainer.model.named_parameters():
        moved = not torch.equal(p.detach(), init[n])
        assert moved == (n in trainer.opt_mask), n
