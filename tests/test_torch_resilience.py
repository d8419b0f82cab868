"""Resilience of the port (``trlx_tpu_torch.resilience`` and the trainer's
flush, rollback and drills) against the JAX package, on the CPU.

- Twins of the single-process tests of ``tests/test_resilience.py``: the
  fault plan (parse, fire once, the environment's override, the multi-host
  kinds' parse), ``poison_nan``, the watchdog, ``call_with_retries``, the
  rollback with its LR decay, compound rollbacks and the abort, the reward
  faults retried, the SIGTERM drill's resume and the full drill.
- Pure host math held exactly (tolerance 0): the same seeded numpy
  sequences through both packages' ``DivergenceWatchdog`` and ``FaultPlan``.
- The drills on shared weights (``params_from_jax``, the forced-bigram
  logit mask of ``tests/test_torch_train.py``): a watchdog rollback and the
  full drill through ``trlx_tpu.train`` and ``trlx_tpu_torch.train``. Equal:
  the rollback's step, ``resilience/lr_scale``, every logged
  ``learning_rate`` (rel 1e-6), ``skipped_steps``, ``iter_count`` and the
  fired set; the final parameters within 2e-4, the step tolerance
  ``tests/test_torch_train.py`` states for a PPO run.
- The repairs: with the default config a ``reward_fn`` that raises once
  finishes ``train()`` in both packages, and in the port (serial and
  overlapped) its store equals a run's whose ``reward_fn`` never raised;
  ``TRLX_TPU_FAULTS=nan_grad@3`` skips step 3 in both; the one unported
  environment switch (``TRLX_TPU_SANITIZE``) raises NotImplementedError
  naming it, and the ported ones (the fleet's, device telemetry's,
  graftscope's, graftnum's) and every fault kind are accepted and arm their
  features.
"""

import dataclasses
import json
import os
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu  # noqa: E402
import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig  # noqa: E402
from trlx_tpu.resilience import DivergenceWatchdog as JaxWatchdog  # noqa: E402
from trlx_tpu.resilience import FaultPlan as JaxFaultPlan  # noqa: E402
from trlx_tpu.resilience import poison_nan as jax_poison_nan  # noqa: E402
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.models.hf_import import params_from_jax  # noqa: E402
from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator  # noqa: E402
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline  # noqa: E402
from trlx_tpu_torch.resilience import (  # noqa: E402
    DivergenceWatchdog,
    FaultInjected,
    FaultPlan,
    TrainingDiverged,
    call_with_retries,
    poison_nan,
)
from trlx_tpu_torch.resilience import checkpoint as ckpt_util  # noqa: E402
from trlx_tpu_torch.observability.spans import enabled as spans_enabled  # noqa: E402
from trlx_tpu_torch.resilience.faults import FLEET_KINDS, SINGLE_PROCESS_KINDS, UNFIRED_KINDS  # noqa: E402
from trlx_tpu_torch.trainer import register_model  # noqa: E402
from trlx_tpu_torch.trainer.base import lr_schedule  # noqa: E402
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _observability_isolation():
    """The span tracer and the emergency hook are process globals a trainer
    arms: disarm them after every test."""
    from trlx_tpu_torch.observability import anomaly, spans

    yield
    spans.shutdown()
    anomaly.register_emergency(None)


# ----------------------------------------------------------------- fault plan


def test_fault_plan_parse_fire_once_and_env_override(monkeypatch):
    for cls in (FaultPlan, JaxFaultPlan):
        plan = cls.parse("nan_grad@3,reward_exc@2, sigterm@5")
        assert bool(plan)
        assert not plan.fire("nan_grad", 2)
        assert plan.fire("nan_grad", 3)
        assert not plan.fire("nan_grad", 3)  # fires exactly once
        assert plan.fire("reward_exc", 2) and plan.fire("sigterm", 5)
        assert not cls.parse("")
        with pytest.raises(ValueError, match="bad fault spec"):
            cls.parse("nan_grad")
        with pytest.raises(ValueError, match="bad fault spec"):
            cls.parse("bogus@1")
        monkeypatch.setenv("TRLX_TPU_FAULTS", "sigterm@9")
        env_plan = cls.from_env_or_config("nan_grad@1")  # the environment wins
        assert [(f.kind, f.at) for f in env_plan.faults] == [("sigterm", 9)]
        monkeypatch.delenv("TRLX_TPU_FAULTS")
        assert [(f.kind, f.at) for f in cls.from_env_or_config("nan_grad@1").faults] == [("nan_grad", 1)]


def test_multihost_fault_kinds_parse_and_fire_once():
    from trlx_tpu.resilience.faults import KINDS as JAX_KINDS
    from trlx_tpu_torch.resilience.faults import KINDS

    from trlx_tpu_torch.resilience.faults import MULTI_PROCESS_KINDS

    assert set(KINDS) == set(JAX_KINDS)
    plan = FaultPlan.parse("host_hang@2,host_kill@3,slow_host@1,host_desync@4")
    assert plan.fire("slow_host", 1) and not plan.fire("slow_host", 1)
    assert plan.fire("host_desync", 4) and plan.fire("host_kill", 3) and plan.fire("host_hang", 2)
    # The multi-process kinds fire in the port's trainer and its engine loop
    # now: none is refused.
    assert set(MULTI_PROCESS_KINDS) == {"host_desync", "host_hang", "host_kill", "slow_host", "mid_decode_host_kill"}
    assert plan.unfired_kinds() == []
    # The fleet's kinds fire in the port's fleet, and nan_layer in the learn
    # loop (graftnum's drill): every kind fires now.
    assert FaultPlan.parse("nan_grad@1,slow_step@2,rollout_host_kill@3").unfired_kinds() == []
    assert FaultPlan.parse("nan_grad@1,nan_layer@3").unfired_kinds() == [] and UNFIRED_KINDS == {}


@pytest.mark.parametrize("seed", range(4))
def test_fault_plan_decisions_equal_jax_exactly(seed):
    """Seeded specs and tick sequences through both plans: every fire,
    fire_at_or_after and pending_at answer is the same."""
    from trlx_tpu_torch.resilience.faults import KINDS

    rng = np.random.default_rng(seed)
    kinds = list(KINDS)
    spec = ",".join(f"{kinds[int(rng.integers(len(kinds)))]}@{int(rng.integers(0, 6))}" for _ in range(12))
    port, ref = FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    assert repr(port) == repr(ref)
    for _ in range(200):
        kind, tick = kinds[int(rng.integers(len(kinds)))], int(rng.integers(0, 7))
        op = ("fire", "fire_at_or_after", "pending_at")[int(rng.integers(3))]
        if op == "pending_at":
            assert port.pending_at(kind) == ref.pending_at(kind)
        else:
            assert getattr(port, op)(kind, tick) == getattr(ref, op)(kind, tick), (op, kind, tick)
    assert [f.fired for f in port.faults] == [f.fired for f in ref.faults]


def test_poison_nan_floats_only():
    from trlx_tpu_torch.data import PPORLBatch

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    ids = rng.integers(0, 9, size=(3, 4)).astype(np.int32)
    ref = jax.device_get(jax_poison_nan({"x": jnp.asarray(x), "ids": jnp.asarray(ids)}))
    got = poison_nan({"x": torch.from_numpy(x), "ids": torch.from_numpy(ids), "note": "kept"})
    assert np.isnan(got["x"].numpy()).all() and np.isnan(ref["x"]).all()
    assert torch.equal(got["ids"], torch.from_numpy(ids)) and np.array_equal(ref["ids"], ids)
    assert got["note"] == "kept"
    # A batch dataclass: its float fields poisoned, its token ids kept.
    fields = {"query_tensors": torch.from_numpy(ids), "response_tensors": torch.from_numpy(ids),
              "logprobs": torch.from_numpy(x), "values": torch.from_numpy(x), "rewards": torch.from_numpy(x)}
    batch = PPORLBatch(**{f: fields.get(f) for f in PPORLBatch.__dataclass_fields__})
    poisoned = poison_nan(batch)
    assert torch.isnan(poisoned.logprobs).all() and torch.isnan(poisoned.rewards).all()
    assert torch.equal(poisoned.query_tensors, batch.query_tensors)


# ------------------------------------------------------------------- watchdog


def test_watchdog_requires_positive_threshold():
    with pytest.raises(ValueError):
        DivergenceWatchdog(0.0)


def test_watchdog_triggers_on_sustained_divergence_only():
    wd = DivergenceWatchdog(threshold=0.5, patience=2, ema_alpha=0.5, warmup=2)
    assert not wd.observe(1.0) and not wd.observe(1.0)  # warmup
    assert not wd.observe(float("nan"))  # one breach: not sustained
    assert not wd.observe(1.0)  # resets the streak
    assert not wd.observe(10.0)
    assert wd.observe(10.0)  # two consecutive breaches
    wd.reset()
    assert wd.ema is None and wd.breaches == 0
    # non-finite during warmup neither triggers nor learns
    assert not wd.observe(float("inf")) and wd.ema is None
    # negative losses: the max(|ema|, 1) floor keeps the band meaningful
    neg = DivergenceWatchdog(threshold=0.5, patience=1, warmup=1)
    assert not neg.observe(-3.0)
    assert not neg.observe(-2.0)  # within ema + 0.5 * 3
    assert neg.observe(5.0)


@pytest.mark.parametrize("seed", range(6))
def test_watchdog_decisions_equal_jax_exactly(seed):
    """A seeded loss walk with spikes, NaNs and resets through both
    watchdogs: decisions, EMA, breach counts and warmup state are equal."""
    rng = np.random.default_rng(seed)
    kw = dict(threshold=float(rng.uniform(0.1, 2.0)), patience=int(rng.integers(1, 5)),
              ema_alpha=float(rng.uniform(0.5, 0.99)), warmup=int(rng.integers(0, 6)))
    port, ref = DivergenceWatchdog(**kw), JaxWatchdog(**kw)
    loss = 1.0
    for i in range(400):
        loss = loss + float(rng.normal(0, 0.05))
        u = rng.uniform()
        v = float("nan") if u < 0.03 else (loss * float(rng.uniform(3, 20)) if u < 0.15 else loss)
        v = -v if rng.uniform() < 0.1 else v
        assert port.observe(v) == ref.observe(v), i
        assert (port.ema, port.breaches, port._seen) == (ref.ema, ref.breaches, ref._seen), i
        if rng.uniform() < 0.02:
            port.reset()
            ref.reset()


# -------------------------------------------------------------------- retries


def test_call_with_retries_recovers_exhausts_and_times_out():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert call_with_retries(flaky, retries=2, backoff=0.0) == "ok" and len(calls) == 3
    calls.clear()
    with pytest.raises(RuntimeError, match="transient"):
        call_with_retries(flaky, retries=1, backoff=0.0)
    assert len(calls) == 2

    t0 = time.time()
    with pytest.raises(TimeoutError):
        call_with_retries(lambda: time.sleep(5), retries=0, timeout=0.2)
    assert time.time() - t0 < 2.0  # the hung call is abandoned, not waited on

    hung = []

    def hang_then_ok():
        hung.append(1)
        if len(hung) == 1:
            time.sleep(1.0)
        return 42

    assert call_with_retries(hang_then_ok, retries=1, backoff=0.0, timeout=0.2) == 42
    assert len(hung) == 2


# ------------------------------------------------------------- trainer level


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


def _walk_config(ckpt_dir, **train):
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = 8
    config.train.epochs = 4
    config.train.batch_size = 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = str(ckpt_dir)
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    for k, v in train.items():
        setattr(config.train, k, v)
    return config


def _trainer(task, ckpt_dir, **train):
    _, logit_mask, metric_fn, reward_fn = task
    return PPOTrainer(_walk_config(ckpt_dir, **train), device="cpu", reward_fn=reward_fn, metric_fn=metric_fn,
                      logit_mask=logit_mask)


_WATCHDOG = dict(watchdog_threshold=0.5, watchdog_patience=2, watchdog_warmup=1, watchdog_lr_decay=0.5,
                 max_rollbacks=2)


def test_max_bad_steps_aborts_with_clear_error(task, tmp_path):
    trainer = _trainer(task, tmp_path / "ck", max_bad_steps=3)
    trainer._res_pending = [(torch.tensor(float("nan")), torch.tensor(1.0), torch.tensor(3.0))]
    with pytest.raises(TrainingDiverged, match="max_bad_steps"):
        trainer._flush_resilience()
    assert trainer.skipped_steps == 1


def _advance(trainer, n):
    trainer.step += n
    trainer.iter_count = trainer.step


def test_watchdog_rollback_restores_and_decays_lr(task, tmp_path):
    d = str(tmp_path / "ck")
    trainer = _trainer(task, d, **_WATCHDOG)
    trainer.save(d)  # the good state at step 0
    good = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
    _advance(trainer, 5)

    trainer._res_pending = [(torch.tensor(v), None, None) for v in (1.0, 1.0, 100.0, 100.0)]
    trainer._flush_resilience()

    assert trainer.step == 0 and trainer.iter_count == 0  # rolled back
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, good[n]), n  # restored in place
    assert trainer._rollbacks == 1
    assert trainer._lr_scale == pytest.approx(0.5)
    assert trainer.watchdog.breaches == 0
    base_lr = float(lr_schedule(trainer.config.train)(10))
    assert base_lr > 0
    assert trainer.schedule(10) == pytest.approx(0.5 * base_lr)
    assert trainer.optimizer.schedule is trainer.schedule  # the step uses it
    # a restored (pre-rollback) host state must not reset the safety budget
    trainer.load_host_state({"resilience": {"rollbacks": 0, "lr_scale": 1.0}})
    assert trainer._rollbacks == 1 and trainer._lr_scale == pytest.approx(0.5)
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    rb = [r for r in recs if "resilience/rollbacks" in r]
    assert rb and rb[-1]["resilience/rollback_to_step"] == 0.0 and rb[-1]["resilience/lr_scale"] == 0.5

    trainer._rollbacks = trainer.config.train.max_rollbacks
    with pytest.raises(TrainingDiverged, match="max_rollbacks"):
        trainer._rollback()


def test_watchdog_multiple_rollbacks_compound_lr_and_abort(task, tmp_path):
    d = str(tmp_path / "ck")
    trainer = _trainer(task, d, **_WATCHDOG)
    trainer.save(d)
    base_lr = float(lr_schedule(trainer.config.train)(10))

    def diverge():
        _advance(trainer, 5)
        trainer._res_pending = [(torch.tensor(v), None, None) for v in (1.0, 1.0, 100.0, 100.0)]
        trainer._flush_resilience()

    diverge()
    assert trainer._rollbacks == 1 and trainer._lr_scale == pytest.approx(0.5)
    assert trainer.schedule(10) == pytest.approx(0.5 * base_lr)
    diverge()
    assert trainer._rollbacks == 2 and trainer._lr_scale == pytest.approx(0.25)
    assert trainer.schedule(10) == pytest.approx(0.25 * base_lr)
    assert trainer.step == 0 and trainer.iter_count == 0
    with pytest.raises(TrainingDiverged, match="max_rollbacks"):
        diverge()
    assert trainer._rollbacks == 3 and trainer._lr_scale == pytest.approx(0.25)


def test_rollback_without_a_checkpoint_is_training_diverged(task, tmp_path):
    trainer = _trainer(task, tmp_path / "empty", **_WATCHDOG)
    _advance(trainer, 3)
    trainer._res_pending = [(torch.tensor(v), None, None) for v in (1.0, 100.0, 100.0)]
    with pytest.raises(TrainingDiverged, match="no restorable checkpoint"):
        trainer._flush_resilience()


def test_load_host_state_applies_lr_scale_as_jax(task, tmp_path):
    """A checkpoint's ``lr_scale < 1`` is taken by the monotone merge and
    swapped into the optimizer's schedule (moments kept), as in the JAX
    package: the two schedules agree within rel 1e-6 at every step."""
    _, logit_mask, metric_fn, reward_fn = task
    trainer = _trainer(task, tmp_path / "t")
    mu = [m.clone() for m in trainer.optimizer.mu]
    jcfg = base_config("ppo", 15, 8)
    jcfg.train.checkpoint_dir = str(tmp_path / "j")
    jcfg.train.batch_size = 16
    jcfg.method.num_rollouts = jcfg.method.chunk_size = 16
    jtrainer = JaxPPOTrainer(jcfg, reward_fn=reward_fn, metric_fn=metric_fn, logit_mask=logit_mask)
    for d in ({"resilience": {"lr_scale": 0.25, "rollbacks": 1}}, {"resilience": {"lr_scale": 0.5}}):
        trainer.load_host_state(d)
        jtrainer.load_host_state(d)
    assert trainer._lr_scale == jtrainer._lr_scale == 0.25 and trainer._rollbacks == jtrainer._rollbacks == 1
    assert trainer.optimizer.schedule is trainer.schedule
    for k in (0, 1, 50, 500, 5000):
        np.testing.assert_allclose(trainer.schedule(k), float(jtrainer.schedule(k)), rtol=1e-6, atol=0)
        np.testing.assert_allclose(trainer.schedule(k), 0.25 * lr_schedule(trainer.config.train)(k), rtol=1e-12)
    for a, b in zip(mu, trainer.optimizer.mu):
        assert torch.equal(a, b)


def test_reward_fn_faults_are_retried(task, tmp_path):
    """reward_exc / reward_hang fire through the orchestrator's score():
    one bounded retry each, training never sees the failure; with no
    retries left the injected error surfaces."""
    trainer = _trainer(task, tmp_path / "ck", fault_plan="reward_exc@1,reward_hang@2", reward_fn_timeout=0.2,
                       reward_fn_retries=2, reward_fn_backoff=0.0)
    calls = {"n": 0}
    real_reward_fn = trainer.reward_fn

    def counting_reward(texts):
        calls["n"] += 1
        return real_reward_fn(texts)

    orch = PPOOrchestrator(trainer, PromptPipeline([[1]] * 16, None, max_prompt_length=1), counting_reward,
                           chunk_size=16)
    assert np.asarray(orch.score([np.asarray([1, 2, 0])] * 16)).shape == (16,)  # exception, then retry
    assert np.asarray(orch.score([np.asarray([1, 2, 0])] * 16)).shape == (16,)  # hang, timeout, retry
    assert all(f.fired for f in trainer.fault_plan.faults)
    assert [r["attempts"] for r in orch.reward_log] == [2, 2]
    assert orch.reward_log[1]["wall_s"] - orch.reward_log[1]["last_attempt_s"] >= 0.2  # the timeout's cost
    trainer.fault_plan = FaultPlan.parse("reward_exc@3")
    trainer.config.train.reward_fn_retries = 0
    with pytest.raises(FaultInjected):
        orch.score([np.asarray([1, 2, 0])] * 16)
    time.sleep(0.7)  # the hung attempt's abandoned thread finishes its call
    assert calls["n"] == 3


def test_preemption_resume_restores_step_and_host_state(task, tmp_path):
    """sigterm@2 mid-run: the checkpoint lands, and a trainer with
    resume_from_checkpoint continues from the saved step with its host
    state."""
    _, logit_mask, metric_fn, reward_fn = task
    d = str(tmp_path / "ck")
    config = _walk_config(d, total_steps=50, epochs=100, fault_plan="sigterm@2")
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=[[int(np.random.default_rng(i).integers(1, 15))]
                                                               for i in range(32)],
                                 eval_prompts=[[1]], metric_fn=metric_fn, config=config, logit_mask=logit_mask,
                                 device="cpu")
    assert model.iter_count == 2
    assert ckpt_util.latest_pointer(d) == "state_2"
    with open(os.path.join(d, "state_2.host.json")) as f:
        saved = json.load(f)
    resumed = _trainer(task, d, resume_from_checkpoint=True)
    assert resumed._resumed and resumed.step == 2
    assert resumed.host_state_dict() == saved


def _prompts():
    return [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]


def test_fault_drill_full_recovery(task, tmp_path):
    """One run absorbs a reward_fn exception, a NaN-grad step, a corrupted
    checkpoint and a SIGTERM; the next falls back past the corrupted
    checkpoint and finishes with a finite loss."""
    _, logit_mask, metric_fn, reward_fn = task
    d = str(tmp_path / "ck")

    def run(fault_plan, resume):
        config = _walk_config(d, checkpoint_interval=2, fault_plan=fault_plan, resume_from_checkpoint=resume,
                              reward_fn_backoff=0.0)
        return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(), eval_prompts=[[1]], metric_fn=metric_fn,
                                    config=config, logit_mask=logit_mask, device="cpu")

    first = run("reward_exc@1,nan_grad@3,ckpt_corrupt@3,sigterm@5", resume=False)
    assert first.iter_count == 5 and first.skipped_steps == 1
    assert all(f.fired for f in first.fault_plan.faults)
    assert ckpt_util.latest_pointer(d) == "state_5"
    assert not ckpt_util.verify_checkpoint(d, "state_5")[0]
    second = run("", resume=True)
    assert second.last_restore_fallback is True
    assert second.iter_count == 8 and second.step == 8
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert losses and np.isfinite(losses[-1])
    assert any(r.get("resilience/skipped_steps") == 1.0 for r in recs)


# ----------------------------------------------- drills on shared weights

V, P, R = 31, 10, 6
_JAX_INIT = {}


class _FromJaxInitUnlessResumed:
    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        if not self._resumed:
            self.load_params(params_from_jax(_JAX_INIT["params"], self.model),
                             params_from_jax(_JAX_INIT["extras"], self.model))


@register_model("PPODrillFromJaxInit")
class _PPODrill(_FromJaxInitUnlessResumed, PPOTrainer):
    pass


def _bigram_config(ckpt_dir, **train):
    arch = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
                extra={"lm_head_bias": True})
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32"),
        "train": {**dict(total_steps=8, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                         weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                         checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(ckpt_dir), seed=11), **train},
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }


def _bigram_task():
    rng = np.random.default_rng(0)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]

    def reward_fn(samples):
        return [float(np.sum(s) % 7) - 3.0 for s in samples]

    return prompts, logit_mask, reward_fn


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_both(tmp_path, runs):
    """``runs``: [(train overrides, resume)] run in order, each through both
    packages (the port from the JAX trainer's initial weights). Returns
    {package: (the last model, metrics.jsonl records)}."""
    prompts, logit_mask, reward_fn = _bigram_task()
    out = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        for train, resume in runs:
            cfg = _bigram_config(d, resume_from_checkpoint=resume, **train)
            if name == "jax":
                if "params" not in _JAX_INIT:
                    init = JaxPPOTrainer(JaxTRLConfig.from_dict(_bigram_config(tmp_path / "init")))
                    _JAX_INIT["params"] = jax.device_get(init.state.params)
                    _JAX_INIT["extras"] = jax.device_get(init.state.extras)
                    del init
                model = trlx_tpu.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                       config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
            else:
                cfg["model"]["model_type"] = "PPODrillFromJaxInit"
                model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                             config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
        out[name] = (model, _records(os.path.join(d, "metrics.jsonl")))
    return out


def _assert_params_close(tm, jm):
    own = dict(tm.model.named_parameters())
    ref = params_from_jax(jax.device_get(jm.state.params), tm.model)
    assert set(own) == set(ref)
    for n, p in own.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[n]), rtol=2e-4, atol=2e-4, err_msg=n)


def _step_records(recs):
    return [(r["step"], r["learning_rate"], r["resilience/nonfinite"]) for r in recs if "loss" in r]


def test_watchdog_drill_matches_jax(tmp_path):
    """nan_grad@4,nan_grad@5 with the watchdog (threshold 0.5, patience 2,
    warmup 1, decay 0.5) and saves every 3 steps: both packages skip steps
    4 and 5, roll back at step 5's flush to state_3 with lr_scale 0.5, log
    the same steps with the same learning rates, and end alike. (A save's
    host state flushes the buffer without the watchdog, in both packages,
    so the poisoned steps avoid the save steps.)"""
    runs = _run_both(tmp_path, [(dict(checkpoint_interval=3, fault_plan="nan_grad@4,nan_grad@5", **_WATCHDOG),
                                 False)])
    (jm, jrecs), (tm, trecs) = runs["jax"], runs["torch"]
    rb = {k: [r for r in recs if "resilience/rollbacks" in r] for k, recs in (("jax", jrecs), ("torch", trecs))}
    assert len(rb["jax"]) == len(rb["torch"]) == 1
    for key in ("step", "resilience/rollback_to_step", "resilience/rollbacks", "resilience/lr_scale"):
        assert rb["torch"][0][key] == rb["jax"][0][key], key
    assert rb["torch"][0]["resilience/rollback_to_step"] == 3.0 and rb["torch"][0]["resilience/lr_scale"] == 0.5
    ts, js = _step_records(trecs), _step_records(jrecs)
    assert [s for s, _, _ in ts] == [s for s, _, _ in js] == [1, 2, 3, 4, 3, 4, 5, 6]
    assert [n for _, _, n in ts] == [n for _, _, n in js] == [0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0]
    np.testing.assert_allclose([lr for _, lr, _ in ts], [lr for _, lr, _ in js], rtol=1e-6, atol=0)
    after = [lr for s, lr, _ in ts][5]  # the first step after the rollback: step 4 at half the schedule
    np.testing.assert_allclose(after, 0.5 * lr_schedule(tm.config.train)(3), rtol=1e-6)
    assert tm._lr_scale == jm._lr_scale == 0.5 and tm._rollbacks == jm._rollbacks == 1
    assert tm.skipped_steps == jm.skipped_steps
    assert tm.iter_count == jm.iter_count == 6
    assert [(f.kind, f.at, f.fired) for f in tm.fault_plan.faults] == \
        [(f.kind, f.at, f.fired) for f in jm.fault_plan.faults]
    _assert_params_close(tm, jm)


def test_fault_drill_full_recovery_matches_jax(tmp_path):
    """The full drill on shared weights: run 1 (reward_exc@1, nan_grad@3,
    ckpt_corrupt@3, sigterm@5, saves every 2 steps) and the resumed run 2
    through both packages: the same preemption step, skips, fired set and
    fallback, and final parameters within the PPO run's tolerance."""
    run1 = dict(checkpoint_interval=2, fault_plan="reward_exc@1,nan_grad@3,ckpt_corrupt@3,sigterm@5",
                reward_fn_backoff=0.0)
    prompts, logit_mask, reward_fn = _bigram_task()
    first = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        cfg = _bigram_config(d, **run1)
        if name == "jax":
            if "params" not in _JAX_INIT:
                init = JaxPPOTrainer(JaxTRLConfig.from_dict(_bigram_config(tmp_path / "init")))
                _JAX_INIT["params"] = jax.device_get(init.state.params)
                _JAX_INIT["extras"] = jax.device_get(init.state.extras)
                del init
            m = trlx_tpu.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                               config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
        else:
            cfg["model"]["model_type"] = "PPODrillFromJaxInit"
            m = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                     config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
        first[name] = (m.iter_count, m.skipped_steps, [(f.kind, f.at, f.fired) for f in m.fault_plan.faults])
        with open(os.path.join(d, "latest.txt")) as f:
            assert f.read().strip() == "state_5"
    assert first["torch"] == first["jax"]
    assert first["torch"][:2] == (5, 1) and all(fired for _, _, fired in first["torch"][2])
    assert not ckpt_util.verify_checkpoint(str(tmp_path / "torch"), "state_5")[0]

    second = {}
    for name in ("jax", "torch"):
        cfg = _bigram_config(tmp_path / name, resume_from_checkpoint=True)
        if name == "jax":
            m = trlx_tpu.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                               config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
        else:
            cfg["model"]["model_type"] = "PPODrillFromJaxInit"
            m = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                     config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
        second[name] = m
    tm, jm = second["torch"], second["jax"]
    assert tm.last_restore_fallback is jm.last_restore_fallback is True
    assert tm.iter_count == jm.iter_count == 8 and tm.skipped_steps == jm.skipped_steps == 1
    _assert_params_close(tm, jm)


# ------------------------------------------------------------------ the repairs


@pytest.mark.parametrize("route", ["jax", "torch-serial", "torch-overlap"])
def test_once_failing_reward_fn_finishes_under_default_config(task, tmp_path, route):
    """The default config (reward_fn_retries 2, backoff 0.5 s) retries a
    reward_fn that raises on its first call, so train() finishes; in the
    port its store equals that of a run whose reward_fn never raised."""
    _, logit_mask, metric_fn, reward_fn = task
    calls = []

    def flaky(samples):
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionError("reward service unavailable")
        return reward_fn(samples)

    if route == "jax":
        config = base_config("ppo", 15, 8)
        config.train.total_steps, config.train.epochs, config.train.batch_size = 4, 2, 16
        config.train.checkpoint_dir = str(tmp_path / "jax")
        config.method.num_rollouts = config.method.chunk_size = 16
        model = trlx_tpu.train(reward_fn=flaky, prompts=_prompts(), eval_prompts=[[1]], metric_fn=metric_fn,
                               config=config, logit_mask=logit_mask)
        assert model.iter_count == 4 and len(calls) >= 2
        return
    overlap = route == "torch-overlap"
    stores = []
    for fn, d in ((flaky, "flaky"), (reward_fn, "steady")):
        config = _walk_config(tmp_path / d, total_steps=4, epochs=2)
        config.method.rollout_overlap = overlap
        model = trlx_tpu_torch.train(reward_fn=fn, prompts=_prompts(), eval_prompts=[[1]], metric_fn=metric_fn,
                                     config=config, logit_mask=logit_mask, device="cpu")
        assert model.iter_count == 4
        stores.append(model.store.columns())
    assert len(calls) >= 2
    assert stores[0].keys() == stores[1].keys()
    for k in stores[0]:
        np.testing.assert_array_equal(stores[0][k], stores[1][k], err_msg=k)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_env_fault_plan_nan_grad_skips_step_3(task, tmp_path, monkeypatch, package):
    """TRLX_TPU_FAULTS=nan_grad@3 (no fault_plan in the config) poisons step
    3: the guard skips it, in the port as in the JAX package."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "nan_grad@3")
    _, logit_mask, metric_fn, reward_fn = task
    kw = dict(reward_fn=reward_fn, prompts=_prompts(), eval_prompts=[[1]], metric_fn=metric_fn,
              logit_mask=logit_mask)
    if package == "jax":
        config = base_config("ppo", 15, 8)
        config.train.total_steps, config.train.epochs, config.train.batch_size = 4, 4, 16
        config.train.checkpoint_dir = str(tmp_path)
        config.method.num_rollouts = config.method.chunk_size = 16
        model = trlx_tpu.train(config=config, **kw)
    else:
        model = trlx_tpu_torch.train(config=_walk_config(tmp_path, total_steps=4), device="cpu", **kw)
    assert model.skipped_steps == 1 and model.fault_plan.faults[0].fired
    steps = {r["step"]: r for r in _records(os.path.join(tmp_path, "metrics.jsonl")) if "loss" in r}
    assert [steps[s]["resilience/nonfinite"] for s in (1, 2, 3, 4)] == [0.0, 0.0, 1.0, 0.0]


# The fleet's switches and fault kinds were refused until the fleet was
# ported, device telemetry's, graftscope's and graftnum's until theirs were,
# and TRLX_TPU_SANITIZE until its race mode was: their cases keep their ids
# and now pin that each is accepted and arms its feature (the sanitizer's
# dispatch mode is refused by name).
_FLEET_ENV_SWITCHES = {"TRLX_TPU_FLEET_ROLE": "learner", "TRLX_TPU_FLEET_WORKER": "1",
                       "TRLX_TPU_FLEET_LEAVE_AFTER": "1"}
_OBS_ENV_SWITCHES = {"TRLX_TPU_DEVICE_TELEMETRY": "_devicemon", "TRLX_TPU_GRAFTSCOPE": "_graftscope",
                     "TRLX_TPU_GRAFTNUM": "_graftnum"}


@pytest.mark.parametrize("var", sorted(set(_FLEET_ENV_SWITCHES) | set(_OBS_ENV_SWITCHES) | {"TRLX_TPU_SANITIZE"}))
def test_unported_env_switch_is_refused(task, tmp_path, monkeypatch, var):
    if var == "TRLX_TPU_SANITIZE":
        from trlx_tpu_torch.utils import sanitize

        try:
            monkeypatch.setenv(var, "race")
            _trainer(task, tmp_path)
            assert sanitize.armed("race")
            monkeypatch.setenv(var, "race,dispatch")
            with pytest.raises(ValueError, match="'dispatch'"):
                _trainer(task, tmp_path)
        finally:
            monkeypatch.delenv(var)
            sanitize.refresh()
            sanitize.clear_races()
        return
    if var in _OBS_ENV_SWITCHES:
        from trlx_tpu_torch.observability import graftscope, numerics

        monkeypatch.setenv(var, "1")
        trainer = _trainer(task, tmp_path)
        assert getattr(trainer, _OBS_ENV_SWITCHES[var]) is not None
        if var == "TRLX_TPU_GRAFTSCOPE":  # arms the monitor and the span file with it
            assert trainer._devicemon.ledger is trainer._graftscope and spans_enabled()
        graftscope.shutdown()
        numerics.shutdown()
        return
    monkeypatch.setenv(var, _FLEET_ENV_SWITCHES[var])
    config = _walk_config(tmp_path)
    config.method.fleet_disaggregate = True
    config.method.fleet_elastic = var != "TRLX_TPU_FLEET_ROLE"
    _, logit_mask, metric_fn, reward_fn = task
    trainer = PPOTrainer(config, device="cpu", reward_fn=reward_fn, metric_fn=metric_fn, logit_mask=logit_mask)
    assert trainer.fleet_role == ("learner" if var == "TRLX_TPU_FLEET_ROLE" else "colocated")
    # Without the fleet a role switch is a config error, as in the JAX
    # package; the worker switches are read only by an elastic worker's loop.
    config.method.fleet_disaggregate = config.method.fleet_elastic = False
    if var == "TRLX_TPU_FLEET_ROLE":
        with pytest.raises(ValueError, match=var):
            PPOTrainer(config, device="cpu", reward_fn=reward_fn)
    else:
        assert PPOTrainer(config, device="cpu", reward_fn=reward_fn).fleet_role is None


@pytest.mark.parametrize("kind", ["nan_layer", "episode_stream_stall", "rollout_host_kill", "worker_join_mid_run"])
def test_unported_fault_kind_is_refused(task, tmp_path, monkeypatch, kind):
    """Every kind is accepted now (nan_layer since graftnum was ported: its
    drill is ``tests/test_torch_numerics.py``'s)."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", f"nan_grad@1,{kind}@2")
    if kind == "nan_layer":
        assert kind in SINGLE_PROCESS_KINDS and kind not in UNFIRED_KINDS
        trainer = _trainer(task, tmp_path)
        assert [(f.kind, f.at) for f in trainer.fault_plan.faults] == [("nan_grad", 1), (kind, 2)]
        return
    assert kind in FLEET_KINDS and kind not in UNFIRED_KINDS
    trainer = _trainer(task, tmp_path)
    assert [(f.kind, f.at) for f in trainer.fault_plan.faults] == [("nan_grad", 1), (kind, 2)]
    assert trainer.fault_plan.unfired_kinds() == []


def test_ported_env_switches_arm_their_features(task, tmp_path, monkeypatch):
    """TRLX_TPU_SPANS / _HEALTH / _ANOMALY_FACTOR / _METRICS_PORT arm what
    their config knobs arm, over a config that leaves them off."""
    from trlx_tpu_torch.observability import spans

    monkeypatch.setenv("TRLX_TPU_SPANS", "1")
    monkeypatch.setenv("TRLX_TPU_HEALTH", "1")
    monkeypatch.setenv("TRLX_TPU_ANOMALY_FACTOR", "2.5")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("TRLX_TPU_METRICS_PORT", str(port))
    trainer = _trainer(task, tmp_path)
    try:
        assert spans.enabled() and trainer._health is not None and trainer._anomaly.factor == 2.5
        assert trainer._incidents is not None and trainer._metrics_exporter.requested_port == port
    finally:
        trainer._metrics_exporter.close()


def test_verify_checkpoint_checks_sizes_before_any_crc(tmp_path, monkeypatch):
    """A truncated file fails verification by its size, before any file's
    checksum is read (a corrupt 14 GB checkpoint costs a load no crc pass)."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "state_1"))
    for name in ("a.pt", "b.pt"):
        with open(os.path.join(d, "state_1", name), "wb") as f:
            f.write(os.urandom(1000))
    ckpt_util.write_manifest(d, "state_1", 1)
    assert ckpt_util.verify_checkpoint(d, "state_1") == (True, "manifest verified")
    with open(os.path.join(d, "state_1", "b.pt"), "r+b") as f:
        f.truncate(10)
    read = []
    monkeypatch.setattr(ckpt_util, "_file_digest", lambda path: read.append(path))
    ok, reason = ckpt_util.verify_checkpoint(d, "state_1")
    assert not ok and reason == "b.pt: size 10 != manifest 1000 (truncated?)" and read == []
