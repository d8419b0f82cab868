"""The training slice against the JAX package.

- remat: gradients with ``remat=True`` equal those without it, exactly, in
  float32.
- The whole slice: the same tiny config, token prompts and forced-bigram
  logit mask (one allowed successor per token, so sampling follows the same
  path in both packages though their random streams differ) go through
  ``trlx_tpu.train`` and ``trlx_tpu_torch.train``; the port's trainer starts
  from the JAX trainer's initial weights. Both run 8 PPO steps (2 epochs of
  2 batches × 2 PPO epochs, a second ``make_experience`` in between) and a
  final ``evaluate()``. Once on the einsum route, once with
  ``attn_impl="flash"`` + ``fused_logprob="force"`` (and remat), where the
  JAX side runs its Pallas kernels and their VJPs in interpret mode and the
  port its plain versions through the autograd Functions. Step 1's loss and
  statistics agree within 1e-5; every later step within 2e-4 (the two runs'
  float32 differences compound over the updates and the second rollout); the
  KL controller's final value within 1e-6 relative.
- The non-finite guard (state untouched on a skipped step, the stop after
  ``train.max_bad_steps``), the refused knobs and ``train()``'s dispatch.
- A torch twin of ``tests/test_e2e.py::test_ppo_learns_randomwalks``
  (marked slow, like its JAX twin).
"""

import dataclasses
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import init_params, params_from_jax
from trlx_tpu_torch.models.lm import LMConfig
from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
from trlx_tpu_torch.resilience.guard import TrainingDiverged, guarded_update
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.base import build_optimizer
from trlx_tpu_torch.trainer.ppo import PPOTrainer

torch.set_num_threads(1)

V, P, R = 31, 10, 6


def test_remat_grads_equal_no_remat_grads():
    cfg = LMConfig(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                   parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, dtype="float32", extra={"lm_head_bias": True})
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, V, size=(2, 12)).astype(np.int32))
    mask = torch.ones_like(ids)
    mask[1, :4] = 0
    grads = []
    for remat in (False, True):
        model = LMWithValueHead(cfg.replace(remat=remat), branch_layer=2, device="cpu")
        init_params(model, torch.Generator().manual_seed(0))
        out = model(ids, mask, labels=ids[:, 5:], logits_start=4)
        (out["logprobs"].sum() + out["values"].sum()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_remat_dots_grads_equal_full_and_no_remat(monkeypatch):
    """remat policy "dots" (save the weight products, recompute the rest)
    gives exactly the gradients of policy "full" and of no remat, in
    float32; its policy saves every block's weight products (mm: 6 a block
    here) and recomputes attention's batched products (bmm)."""
    from functools import partial

    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    from trlx_tpu_torch.models import lm

    decided = {}

    def spy(ctx, op, *args, **kwargs):
        policy = lm._save_dots(ctx, op, *args, **kwargs)
        decided[(str(op), policy)] = decided.get((str(op), policy), 0) + 1
        return policy

    monkeypatch.setattr(lm, "_save_dots_context", partial(create_selective_checkpoint_contexts, spy))
    cfg = LMConfig(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                   parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, dtype="float32", extra={"lm_head_bias": True})
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, V, size=(2, 12)).astype(np.int32))
    mask = torch.ones_like(ids)
    mask[1, :4] = 0
    grads = {}
    for name, kw in (("none", dict(remat=False)), ("full", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        model = LMWithValueHead(cfg.replace(**kw), branch_layer=2, device="cpu")
        init_params(model, torch.Generator().manual_seed(0))
        out = model(ids, mask, labels=ids[:, 5:], logits_start=4)
        (out["logprobs"].sum() + out["values"].sum()).backward()
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for other in ("full", "dots"):
        assert grads[other].keys() == grads["none"].keys()
        for n in grads["none"]:
            assert torch.equal(grads[other][n], grads["none"][n]), (other, n)
    assert decided[("aten.mm.default", CheckpointPolicy.MUST_SAVE)] == 6 * cfg.n_layer
    assert decided[("aten.bmm.default", CheckpointPolicy.PREFER_RECOMPUTE)] == 2 * cfg.n_layer


_JAX_INIT = {}


@register_model("PPOFromJaxInit")
class _PPOFromJaxInit(PPOTrainer):
    """The port's PPO trainer starting from the JAX trainer's initial
    parameters and frozen reference."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.load_params(params_from_jax(_JAX_INIT["params"], self.model),
                         params_from_jax(_JAX_INIT["extras"], self.model))


def _config(tmp_path, kernels: bool):
    extra = {"lm_head_bias": True}
    arch = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra=extra)
    if kernels:
        arch["attn_impl"] = "flash"
        extra["fused_logprob"] = "force"
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32", remat=kernels),
        "train": dict(total_steps=8, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                      weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4, checkpoint_interval=10**6,
                      eval_interval=100, checkpoint_dir=str(tmp_path), seed=11),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }


def _step_stats(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                out[rec["step"]] = rec
    return out


STAT_KEYS = ("loss", "pg_loss", "vf_loss", "pg_clipfrac", "vf_clipfrac", "mean_kl", "mean_ratio", "mean_return",
             "mean_advantage", "mean_entropy", "explained_variance", "grad_norm", "learning_rate")


@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "kernel-route"])
def test_train_matches_jax(tmp_path, kernels):
    rng = np.random.default_rng(0)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]
    eval_prompts = prompts[:5]

    def reward_fn(samples):
        return [float(np.sum(s) % 7) - 3.0 for s in samples]

    runs = {}
    for name in ("jax", "torch"):
        cfg = _config(tmp_path / name, kernels)
        if name == "jax":
            init = JaxPPOTrainer(JaxTRLConfig.from_dict(cfg))
            _JAX_INIT["params"] = jax.device_get(init.state.params)
            _JAX_INIT["extras"] = jax.device_get(init.state.extras)
            del init
            model = trlx_tpu.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=eval_prompts,
                                   config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
        else:
            cfg["model"]["model_type"] = "PPOFromJaxInit"
            model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=eval_prompts,
                                         config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
        runs[name] = (model, _step_stats(os.path.join(tmp_path, name, "metrics.jsonl")))

    (jm, js), (tm, ts) = runs["jax"], runs["torch"]
    assert tm.iter_count == jm.iter_count == 8
    assert sorted(ts) == sorted(js) == list(range(1, 9))
    for step in range(1, 9):
        tol = 1e-5 if step == 1 else 2e-4
        for k in STAT_KEYS:
            np.testing.assert_allclose(ts[step][k], js[step][k], rtol=tol, atol=tol, err_msg=f"step {step} {k}")
        assert ts[step]["resilience/nonfinite"] == 0.0
    np.testing.assert_allclose(tm.kl_ctl.value, jm.kl_ctl.value, rtol=1e-6)
    assert tm.kl_ctl.value != 0.3  # the controller moved


def test_guarded_update_skips_nonfinite_steps():
    """A non-finite loss or gradient leaves parameters, moments and the
    applied-update count untouched and bumps the skip count; a finite step
    applies and resets it."""
    rng = np.random.default_rng(5)
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((4, 3), (5,))]
    opt, _ = build_optimizer(_guard_train_cfg(), params, ["w", "b"])
    grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) for p in params]
    bad_steps, applied = guarded_update(opt, params, grads, torch.tensor(1.0), 0)
    assert (bad_steps, applied, opt.count) == (0, True, 1)
    before = [t.clone() for t in (*params, *opt.mu, *opt.nu)]
    nan_grads = [grads[0], torch.full_like(grads[1], float("nan"))]
    for i, (g, loss) in enumerate(((nan_grads, torch.tensor(1.0)), (grads, torch.tensor(float("inf"))))):
        bad_steps, applied = guarded_update(opt, params, g, loss, bad_steps)
        assert (bad_steps, applied, opt.count) == (i + 1, False, 1)
        for a, b in zip(before, (*params, *opt.mu, *opt.nu)):
            assert torch.equal(a, b)
    bad_steps, applied = guarded_update(opt, params, grads, torch.tensor(1.0), bad_steps)
    assert (bad_steps, applied, opt.count) == (0, True, 2)
    assert not torch.equal(before[0], params[0])


def _guard_train_cfg():
    return types.SimpleNamespace(learning_rate_init=1e-3, learning_rate_target=1e-4, lr_ramp_steps=0,
                                 lr_decay_steps=10, weight_decay=1e-2, opt_betas=(0.9, 0.95), grad_clip=1.0)


def _tiny_prompts(n=8):
    rng = np.random.default_rng(1)
    return [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(n)]


def test_learn_stops_after_max_bad_steps(tmp_path):
    """NaN rewards make every loss non-finite: each step is skipped with the
    parameters untouched, and learn() stops after train.max_bad_steps."""
    cfg = _config(tmp_path, kernels=False)
    cfg["train"]["max_bad_steps"] = 3
    config = TRLConfig.from_dict(cfg)
    trainer = PPOTrainer(config, device="cpu", reward_fn=lambda s: [float("nan")] * len(s))
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    pipeline = PromptPipeline(_tiny_prompts(16), None, max_prompt_length=trainer.prompt_length)
    trainer.orch = PPOOrchestrator(trainer, pipeline, reward_fn=trainer.reward_fn, chunk_size=8)
    trainer.orch.make_experience(config.method.num_rollouts)
    trainer.add_eval_pipeline(pipeline)
    with pytest.raises(TrainingDiverged, match="3 consecutive"):
        trainer.learn()
    assert trainer.iter_count == 3 and trainer.bad_steps == 3 and trainer.optimizer.count == 0
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, start[n]), n


def _ilql_config(tmp_path):
    cfg = _config(tmp_path, kernels=False)
    cfg["model"]["model_type"] = "ilql"
    cfg["train"]["orchestrator"] = "OfflineOrchestrator"
    cfg["method"] = dict(name="ilqlconfig", gen_kwargs=dict(prompt_length=P, max_new_tokens=R))
    return cfg


# The cases keep the ids they had while these knobs were refused: the fleet's
# since PR 20 and the observability knobs (device telemetry, graftscope,
# graftnum, watch_interval, profile_dir) since their features were ported
# now pin that each knob is accepted and arms its feature. The PPO trainer
# arms the fleet; the ILQL trainer ignores ``train.fleet_*`` as the JAX
# package's ILQL trainer does (``tests/test_torch_ilql.py`` runs such a
# config through both packages).
_KNOBS = [("method", "fleet_disaggregate", True), ("train", "watch_interval", 10), ("train", "graftnum", True),
          ("train", "device_telemetry", True), ("train", "fault_plan", "rollout_host_kill@2")]
_ILQL_KNOBS = [("train", "graftscope", True), ("train", "watch_interval", 10),
               ("train", "fleet_dir", "fleet"), ("train", "fleet_role", "rollout"),
               ("train", "profile_dir", "profiles"), ("train", "graftnum", True)]
_FLEET_KNOBS = {"fleet_disaggregate", "fault_plan", "fleet_dir", "fleet_role"}


def _arms_observability_knob(built, knob, tmp_path):
    """The knob's feature is armed on the built trainer (its cheapest
    observable effect)."""
    from trlx_tpu_torch.observability import graftscope, numerics

    if knob == "graftnum":
        assert built._graftnum is not None and numerics.enabled() and built._incidents is not None
    elif knob == "device_telemetry":
        assert built._devicemon is not None and built._graftscope is None
    elif knob == "graftscope":
        assert built._graftscope is graftscope.scope() and built._devicemon.ledger is built._graftscope
    elif knob == "watch_interval":
        built.iter_count = 10
        built.log_param_watch()
        with open(os.path.join(built.config.train.checkpoint_dir, "metrics.jsonl")) as f:
            hists = {json.loads(line).get("histogram") for line in f}
        assert "watch/params/transformer" in hists
    else:
        built.config.train.profile_dir = str(tmp_path / "profiles")
        built._learn_start, built.iter_count = 0, 2
        built._profile_tick()
        assert built._profiling is not None
        built._profile_stop()
        assert (tmp_path / "profiles" / "trace.json").exists()
    graftscope.shutdown()
    numerics.shutdown()


@pytest.mark.parametrize("trainer,section,knob,value", [
    pytest.param("ppo", *case, id="-".join(map(str, case))) for case in _KNOBS] + [
    pytest.param("ilql", *case, id="ilql-" + "-".join(map(str, case))) for case in _ILQL_KNOBS])
def test_unported_knobs_are_refused(tmp_path, trainer, section, knob, value):
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    cfg = _config(tmp_path, kernels=False) if trainer == "ppo" else _ilql_config(tmp_path)
    cfg[section][knob] = value
    cls = PPOTrainer if trainer == "ppo" else ILQLTrainer
    built = cls(TRLConfig.from_dict(cfg), device="cpu")
    if knob not in _FLEET_KNOBS:
        _arms_observability_knob(built, knob, tmp_path)
    elif trainer == "ilql":
        assert not hasattr(built, "fleet_role") and not os.path.exists(tmp_path / "fleet")
    elif knob == "fleet_disaggregate":
        assert built.fleet_role == "colocated" and not built.overlap_rollouts and built.store.record_staleness
    else:
        # A fleet fault kind is armed (the fleet's sites fire it) and no
        # fleet runs without method.fleet_disaggregate.
        assert [(f.kind, f.at) for f in built.fault_plan.faults] == [("rollout_host_kill", 2)]
        assert built.fleet_role is None and built.fault_plan.unfired_kinds() == []


def test_train_dispatch_refuses_ilql_and_needs_reward_fn(tmp_path, monkeypatch):
    """``train()``'s dispatch: a ``dataset`` reaches the ILQL trainer
    through the offline orchestrator (stopped at ``learn()`` here; the
    whole path is ``tests/test_torch_ilql.py``); text samples need a
    tokenizer (ValueError without one); with ``model.tokenizer_path`` the
    trainer builds its tokenizer (``_build_tokenizer``) and text samples
    reach the store; with neither a ``reward_fn`` nor a ``dataset`` it
    raises ValueError."""
    from trlx_tpu_torch.trainer.base import BaseTrainer
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    config = TRLConfig.from_dict(_ilql_config(tmp_path))
    reached = []
    monkeypatch.setattr(ILQLTrainer, "learn", lambda self: reached.append(self))
    samples = [np.arange(1, 9) % V, np.arange(3, 12) % V]
    model = trlx_tpu_torch.train(dataset=(samples, [1.0, -1.0]), config=config, device="cpu")
    assert reached == [model] and type(model) is ILQLTrainer and len(model.store) == 2
    assert model.eval_pipeline is not None
    with pytest.raises(ValueError, match="text samples need a tokenizer"):
        trlx_tpu_torch.train(dataset=(["a walk"], [1.0]), config=config, device="cpu")
    cfg = _ilql_config(tmp_path)
    cfg["model"]["tokenizer_path"] = "char-tokenizer"
    built = []

    class ByteTokenizer:
        bos_token_id, eos_token_id, pad_token_id, bos_token = 2, 1, 1, "\x02"

        def __call__(self, text, add_special_tokens=False):
            return {"input_ids": [3 + b % (V - 3) for b in text.encode()]}

    monkeypatch.setattr(BaseTrainer, "_build_tokenizer", lambda self, path: built.append(path) or ByteTokenizer())
    model = trlx_tpu_torch.train(dataset=(["a walk", "ab"], [1.0, -1.0]), config=TRLConfig.from_dict(cfg),
                                 device="cpu")
    assert built == ["char-tokenizer"] and reached[-1] is model and len(model.store) == 2
    np.testing.assert_array_equal(model.store.input_ids[1, :4], [2, 3 + 97 % (V - 3), 3 + 98 % (V - 3), 1])
    with pytest.raises(ValueError, match="reward_fn or dataset"):
        trlx_tpu_torch.train(config=config, device="cpu")


@pytest.mark.slow
def test_ppo_learns_randomwalks(tmp_path):
    """Learning-quality gate, the torch twin of the JAX package's: PPO on
    randomwalks reaches >= 0.8 eval optimality, with the example config and
    the JAX test's sizes."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    from randomwalks import base_config, generate_random_walks

    n_nodes, max_length = 21, 10
    walks, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=n_nodes, max_length=max_length)
    jcfg = base_config("ppo", n_nodes, max_length)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = 48
    config.train.eval_interval = 16
    config.train.checkpoint_interval = 10**6
    config.train.checkpoint_dir = str(tmp_path)
    config.train.batch_size = 48
    config.method.num_rollouts = 96
    config.method.chunk_size = 48

    history = []
    n_eval_prompts = n_nodes - 1

    def recording_metric(samples):
        assert len(samples) == n_eval_prompts
        m = metric_fn(samples)
        history.append(float(np.mean(m["optimality"])))
        return m

    prompts = [[int(np.random.default_rng(i).integers(1, n_nodes))] for i in range(200)]
    trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[i] for i in range(1, n_nodes)],
                         metric_fn=recording_metric, config=config, logit_mask=logit_mask, device="cpu")
    assert history, "evaluate() never ran"
    assert max(history) >= 0.8, f"PPO failed to learn: optimality history {history}"
