"""Speculative decoding in the port's rollout engine, against the JAX
package's (twins of ``tests/test_spec_decode.py``).

The same tiny model (float32, the einsum path on both sides, weights from
the JAX init through ``params_from_jax``) and the same prompts go through
both engines. Greedy: the port's speculative engine equals its own
non-speculative engine and the JAX speculative engine token for token and
mask bit for mask bit (int8 KV on and off, soft prompts on and off, fixed
and paged slots). The accounting (dispatches, accepted tokens, the accept
rate), a perfect drafter's accept rate of 1.0, version spans across an
in-flight weight switch, exact rejection sampling against a point-mass
target, and the soft-prompt and reward-model trainers through a speculative
engine end to end. Sampled streams are compared in their invariants only:
the two packages draw different random numbers.

The slot schedule crc of a speculative engine (its accepted totals folded
in) is deterministic and equals the JAX engine's.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.engine import NgramDrafter as JaxNgramDrafter  # noqa: E402
from trlx_tpu.engine import RolloutEngine as JaxRolloutEngine  # noqa: E402
from trlx_tpu.models import LMConfig as JaxLMConfig  # noqa: E402
from trlx_tpu.models import LMWithValueHead as JaxLMWithValueHead  # noqa: E402
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.engine import NgramDrafter, RolloutEngine, make_drafter  # noqa: E402
from trlx_tpu_torch.models.heads import LMWithValueHead  # noqa: E402
from trlx_tpu_torch.models.hf_import import params_from_jax  # noqa: E402
from trlx_tpu_torch.models.lm import LMConfig  # noqa: E402
from trlx_tpu_torch.ops.generate import make_generate_fn  # noqa: E402
from trlx_tpu_torch.ops.sampling import GenerateConfig  # noqa: E402

torch.set_num_threads(1)

V = 23
_MODELS = {}


def _tiny_model(**overrides):
    """(JAX module, JAX variables, the port's module on the same weights,
    prompts [3, 6] with row 0 left-padded, their mask)."""
    key = tuple(sorted(overrides.items()))
    if key not in _MODELS:
        kw = dict(vocab_size=V, n_layer=2, n_head=2, d_model=32, max_position=64, dtype="float32", **overrides)
        jmodel = JaxLMWithValueHead(JaxLMConfig(**kw))
        rng = jax.random.PRNGKey(0)
        ids = jax.random.randint(rng, (3, 6), 2, V)
        ids = ids.at[0, :2].set(0)
        mask = jnp.ones((3, 6), jnp.int32).at[0, :2].set(0)
        params = jax.device_get(jmodel.init(rng, ids, mask)["params"])
        model = LMWithValueHead(LMConfig(**kw), device="cpu")
        model.load_state_dict(params_from_jax(params, model))
        model.requires_grad_(False)
        _MODELS[key] = (jmodel, {"params": params}, model, np.asarray(ids), np.asarray(mask))
    return _MODELS[key]


def _drain(engine):
    episodes = []
    for _ in range(300):
        episodes.extend(engine.step())
        if engine.idle:
            break
    return episodes


def _by_prompt(episodes):
    return {tuple(e.prompt_ids.tolist()): e for e in episodes}


def _run_engine(model, groups, gcfg, **kw):
    engine = RolloutEngine(model, gcfg, n_slots=kw.pop("n_slots", 2), prompt_width=6, prefill_batch=2,
                           steps_per_sync=3, **kw)
    engine.update_weights(model, version=1)
    for ids, msk in groups:
        engine.submit(ids, msk)
    episodes = _drain(engine)
    return engine, episodes, engine.stats(reset=False)


def _run_jax_engine(jmodel, params, groups, gcfg, **kw):
    engine = JaxRolloutEngine(jmodel, JaxGenerateConfig(**gcfg), n_slots=kw.pop("n_slots", 2), prompt_width=6,
                              prefill_batch=2, steps_per_sync=3, rng=jax.random.PRNGKey(2), **kw)
    engine.update_weights(params, version=1)
    for ids, msk in groups:
        engine.submit(ids, msk)
    episodes = []
    for _ in range(300):
        episodes.extend(engine.step())
        if engine.idle:
            break
    engine.shutdown()
    return episodes


class OracleDrafter:
    """A perfect drafter: replays a known continuation per (unpadded)
    prompt, tracking each slot's frontier from the accepted tokens only."""

    def __init__(self, ref, pad=0):
        self.ref = {k: [int(t) for t in v] for k, v in ref.items()}
        self.pad = int(pad)
        self.pos = {}
        self.rows = {}

    def reset_slot(self, slot, prompt_tokens):
        self.rows[slot] = self.ref[tuple(int(t) for t in prompt_tokens)]
        self.pos[slot] = 0

    def observe(self, slot, tokens):
        self.pos[slot] = self.pos.get(slot, 0) + max(0, len(tokens) - 1)

    def propose(self, slot, last_token, k):
        row = self.rows.get(slot, [])
        p = self.pos.get(slot, 0)
        out = row[p: p + k]
        return out + [self.pad] * (k - len(out))


def _no_decode_call(monkeypatch):
    """A speculative engine must never run the one-token decode call."""
    def refuse(self):
        raise AssertionError("a speculative engine ran the one-token decode call")

    monkeypatch.setattr(RolloutEngine, "_decode_call", refuse)


# -------------------------------------------------------------- greedy parity


@pytest.mark.parametrize("quant", [None, "int8"])
def test_spec_greedy_parity_token_for_token(quant, monkeypatch):
    """spec_decode="ngram" greedy equals the non-speculative engine and the
    JAX speculative engine token for token and mask bit for mask bit, with
    a discovered eos (mixed lengths) and refills; the dispatch/token split
    and the accept rate tie together."""
    jmodel, jparams, model, ids, msk = _tiny_model(kv_cache_quant=quant == "int8")
    free = GenerateConfig(max_new_tokens=8, do_sample=False, eos_token_id=None, pad_token_id=0)
    toks, _ = make_generate_fn(model, free)(ids, msk, None)
    first_at = {}
    for row in toks.numpy()[:, ids.shape[1]:]:
        seen = {}
        for step, t in enumerate(row.tolist()):
            seen.setdefault(int(t), step)
        for t, step in seen.items():
            first_at.setdefault(t, set()).add(step)
    eos = max(first_at, key=lambda t: len(first_at[t]))
    gkw = dict(max_new_tokens=8, do_sample=False, eos_token_id=eos, pad_token_id=0)
    gcfg = GenerateConfig(**gkw)

    e0, ref_eps, _ = _run_engine(model, [(ids, msk)], gcfg)
    e0.shutdown()
    ref = _by_prompt(ref_eps)
    jax_spec = _by_prompt(_run_jax_engine(jmodel, jparams, [(ids, msk)], gkw, spec_decode="ngram", spec_k=4))

    _no_decode_call(monkeypatch)
    e1, eps, stats = _run_engine(model, [(ids, msk)], gcfg, spec_decode="ngram", spec_k=4)
    assert len(eps) == 3
    for ep in eps:
        for r in (ref[tuple(ep.prompt_ids.tolist())], jax_spec[tuple(ep.prompt_ids.tolist())]):
            np.testing.assert_array_equal(ep.response_ids, r.response_ids)
            np.testing.assert_array_equal(ep.response_mask, r.response_mask)
            assert ep.decode_steps == r.decode_steps
    total = sum(ep.decode_steps for ep in eps)
    assert stats["engine/decode_tokens"] == stats["engine/gen_tokens"] == total
    assert stats["engine/decode_dispatches"] < total  # speculation paid off
    assert 0.0 < stats["engine/spec_accept_rate"] <= 1.0
    assert stats["engine/spec_accepted"] == total
    e1.shutdown()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_spec_greedy_parity_paged(quant, monkeypatch):
    """The verify window goes through the block tables on the paged engine:
    its greedy tokens equal the paged non-speculative engine's and the JAX
    paged speculative engine's."""
    jmodel, jparams, model, ids, msk = _tiny_model(kv_cache_quant=quant)
    gkw = dict(max_new_tokens=8, do_sample=False, eos_token_id=None, pad_token_id=0)
    gcfg = GenerateConfig(**gkw)
    paged = dict(paged_kv=True, kv_block_size=4)
    e0, ref_eps, _ = _run_engine(model, [(ids, msk)], gcfg, **paged)
    e0.shutdown()
    jax_spec = _by_prompt(_run_jax_engine(jmodel, jparams, [(ids, msk)], gkw, spec_decode="ngram", spec_k=3,
                                          **paged))
    _no_decode_call(monkeypatch)
    e1, eps, stats = _run_engine(model, [(ids, msk)], gcfg, spec_decode="ngram", spec_k=3, **paged)
    assert e1.paged and e1.kv_len % 4 == 0 and e1.cache_len == 6 + 8 + 2
    ref = _by_prompt(ref_eps)
    assert len(eps) == 3
    for ep in eps:
        for r in (ref[tuple(ep.prompt_ids.tolist())], jax_spec[tuple(ep.prompt_ids.tolist())]):
            np.testing.assert_array_equal(ep.response_ids, r.response_ids)
            np.testing.assert_array_equal(ep.response_mask, r.response_mask)
    assert stats["engine/decode_tokens"] == 3 * 8
    e1.pool.leak_audit(expect_idle=True)
    e1.shutdown()


def test_spec_with_int8_decode_weights(monkeypatch):
    """With W8A16 decode weights the verify window's products read the int8
    copies too (8 products a forward: c_qkv, attention out, c_fc and MLP
    out in each of 2 layers; the head is tied, so not quantized): speculative greedy
    tokens equal the non-speculative engine's on the same quantized model,
    and the layers read their kernels again outside the engine's calls."""
    import trlx_tpu_torch.models.lm as lm
    from trlx_tpu_torch.ops.w8a16 import quantize_weights, w8a16_matmul

    _, _, base, ids, msk = _tiny_model()
    model = LMWithValueHead(base.cfg, device="cpu")
    model.load_state_dict(base.state_dict())
    model.requires_grad_(False)
    assert quantize_weights(model) == 2 * 4
    calls = []
    monkeypatch.setattr(lm, "w8a16_matmul", lambda *a, **k: calls.append(1) or w8a16_matmul(*a, **k))
    gcfg = GenerateConfig(max_new_tokens=8, do_sample=False, eos_token_id=None, pad_token_id=0)
    e0, ref_eps, _ = _run_engine(model, [(ids, msk)], gcfg)
    e0.shutdown()
    ref = _by_prompt(ref_eps)
    _no_decode_call(monkeypatch)
    n0 = len(calls)
    e1, eps, stats = _run_engine(model, [(ids, msk)], gcfg, spec_decode="ngram", spec_k=3)
    assert len(eps) == 3
    for ep in eps:
        np.testing.assert_array_equal(ep.response_ids, ref[tuple(ep.prompt_ids.tolist())].response_ids)
    assert len(calls) - n0 == 8 * (stats["engine/prefill_batches"] + stats["engine/decode_dispatches"])
    assert not any(getattr(m, "w8_on", False) for m in model.modules())
    e1.shutdown()


def test_spec_off_path_is_cold_and_config_defaults_off():
    """spec_decode off arms nothing (no drafter, no verify call, no
    spec_resid state, no spec stats, no scratch tail); the method config
    defaults keep it off; "off" normalizes; junk and spec_k < 2 raise; the
    "model" drafter is reserved."""
    from trlx_tpu_torch.data.method_configs import PPOConfig

    assert PPOConfig.spec_decode == "" and PPOConfig.spec_k == 0

    _, _, model, ids, msk = _tiny_model()
    gcfg = GenerateConfig(max_new_tokens=4, do_sample=False, eos_token_id=None, pad_token_id=0)
    engine = RolloutEngine(model, gcfg, n_slots=2, prompt_width=6, prefill_batch=2)
    assert engine._verify is None and engine.drafter is None
    assert engine.cache_len == 6 + 4  # no spec_k - 1 scratch tail
    engine.update_weights(model)
    engine.submit(ids, msk)
    _drain(engine)
    assert "spec_resid" not in engine._state
    stats = engine.stats(reset=False)
    assert "engine/spec_accept_rate" not in stats
    assert stats["engine/decode_tokens"] == stats["engine/gen_tokens"]
    assert stats["engine/decode_dispatches"] == stats["engine/decode_calls"]
    engine.shutdown()

    e2 = RolloutEngine(model, gcfg, n_slots=2, prompt_width=6, spec_decode="off")
    assert e2._verify is None
    e2.shutdown()
    with pytest.raises(ValueError, match="spec_decode"):
        RolloutEngine(model, gcfg, n_slots=2, prompt_width=6, spec_decode="beam")
    with pytest.raises(ValueError, match="spec_k"):
        RolloutEngine(model, gcfg, n_slots=2, prompt_width=6, spec_decode="ngram", spec_k=1)
    with pytest.raises(NotImplementedError):
        make_drafter("model", 0)


def test_oracle_drafter_reaches_accept_rate_one():
    """A drafter that replays the model's own greedy continuation is
    accepted in full: accept rate 1.0 and R / K dispatches for one wave."""
    _, _, model, ids, msk = _tiny_model()
    R, K = 8, 4
    gcfg = GenerateConfig(max_new_tokens=R, do_sample=False, eos_token_id=None, pad_token_id=0)
    e0, ref_eps, _ = _run_engine(model, [(ids, msk)], gcfg, n_slots=3)
    e0.shutdown()
    ref = {tuple(e.prompt_ids[e.prompt_mask > 0].tolist()): e.response_ids[: e.decode_steps] for e in ref_eps}
    e1, eps, stats = _run_engine(model, [(ids, msk)], gcfg, n_slots=3, spec_decode="ngram", spec_k=K,
                                 drafter=OracleDrafter(ref, pad=0))
    assert len(eps) == 3
    assert stats["engine/spec_accept_rate"] == 1.0
    assert stats["engine/decode_tokens"] == 3 * R
    assert stats["engine/decode_dispatches"] == R // K
    for ep in eps:
        np.testing.assert_array_equal(ep.response_ids[:R], ref[tuple(ep.prompt_ids[ep.prompt_mask > 0].tolist())])
    e1.shutdown()


# ----------------------------------------------- speculation x in-flight push


def test_spec_version_spans_straddle_inflight_switch():
    """A weight push between two verify calls splits the episodes' version
    spans at the ACCEPTED-token position."""
    _, _, model, ids, msk = _tiny_model()
    R, K = 6, 3
    gcfg = GenerateConfig(max_new_tokens=R, do_sample=False, eos_token_id=None, pad_token_id=0)
    e0, ref_eps, _ = _run_engine(model, [(ids, msk)], gcfg, n_slots=3)
    e0.shutdown()
    ref = {tuple(e.prompt_ids[e.prompt_mask > 0].tolist()): e.response_ids[: e.decode_steps] for e in ref_eps}
    engine = RolloutEngine(model, gcfg, n_slots=3, prompt_width=6, prefill_batch=3, steps_per_sync=3,
                           spec_decode="ngram", spec_k=K, drafter=OracleDrafter(ref, pad=0))
    engine.update_weights(model, version=1)
    engine.submit(ids, msk)
    assert engine.step() == []  # one verify call: K of R tokens accepted
    assert [s["n_gen"] for s in engine.slot_states()] == [K, K, K]
    engine.update_weights(model, version=2)
    eps = _drain(engine)
    assert len(eps) == 3
    for ep in eps:
        assert ep.version_spans == [(1, K), (2, R - K)]
        assert ep.weight_version == 2
        np.testing.assert_array_equal(ep.response_ids[:R], ref[tuple(ep.prompt_ids[ep.prompt_mask > 0].tolist())])
    stats = engine.stats(reset=False)
    assert stats["engine/decode_tokens"] == 3 * R
    assert stats["engine/weight_switches"] == 1
    engine.shutdown()


def test_spec_schedule_fingerprint_deterministic():
    """Speculation folds each verify call's accepted-token total into the
    slot schedule crc: two identical runs fingerprint identically, and equal
    the JAX speculative engine's crc on the same weights (the two-rank
    drills of tests/test_torch_dist_engine.py check the crc across ranks)."""
    jmodel, jparams, model, ids, msk = _tiny_model()
    gkw = dict(max_new_tokens=6, do_sample=False, eos_token_id=None, pad_token_id=0)
    gcfg = GenerateConfig(**gkw)

    def fingerprint():
        e, _, _ = _run_engine(model, [(ids, msk)], gcfg, spec_decode="ngram", spec_k=3)
        fp = e.schedule_fingerprint()
        e.shutdown()
        return fp

    fp1, fp2 = fingerprint(), fingerprint()
    assert fp1 == fp2 != 0
    jeng = JaxRolloutEngine(jmodel, JaxGenerateConfig(**gkw), n_slots=2, prompt_width=6, prefill_batch=2,
                            steps_per_sync=3, rng=jax.random.PRNGKey(2), spec_decode="ngram", spec_k=3)
    jeng.update_weights(jparams, version=1)
    jeng.submit(ids, msk)
    for _ in range(300):
        jeng.step()
        if jeng.idle:
            break
    assert jeng.schedule_fingerprint() == fp1
    jeng.shutdown()


# -------------------------------------------------------- rejection sampling


def _forced_bigram():
    allow = torch.from_numpy(np.stack([np.eye(V, dtype=np.float32)[(t + 1) % V] for t in range(V)]))

    def forced_bigram(logits, ctx):
        gate = allow[ctx["last_token"].long()]
        return torch.where(gate > 0, 0.0, -1e9)

    return forced_bigram


def test_spec_sampled_point_mass_bigram_is_exact():
    """Against a point-mass target (a forced-bigram processor) the matching
    drafter is accepted with probability exactly 1, and the speculative
    sampled stream equals the non-speculative one, and the JAX engine's."""
    jmodel, jparams, model, ids, msk = _tiny_model()
    eos = 22
    gkw = dict(max_new_tokens=8, do_sample=True, temperature=1.0, eos_token_id=eos, pad_token_id=0)
    gcfg = GenerateConfig(**gkw)
    ids = np.array(ids)
    for b in range(3):
        ids[b, -1] = eos - 5 + b  # response lengths 5, 4, 3
    e0, ref_eps, _ = _run_engine(model, [(ids, msk)], gcfg, processor=_forced_bigram())
    e0.shutdown()
    ref = _by_prompt(ref_eps)
    for key, ep in ref.items():
        assert ep.decode_steps == eos - key[-1]
    e1, eps, stats = _run_engine(model, [(ids, msk)], gcfg, processor=_forced_bigram(), spec_decode="ngram",
                                 spec_k=4, drafter=NgramDrafter(0, transition=lambda t: (t + 1) % V))
    for ep in eps:
        r = ref[tuple(ep.prompt_ids.tolist())]
        np.testing.assert_array_equal(ep.response_ids, r.response_ids)
        np.testing.assert_array_equal(ep.response_mask, r.response_mask)
    assert stats["engine/spec_accept_rate"] > 0.5
    assert stats["engine/decode_dispatches"] < stats["engine/decode_tokens"]
    e1.shutdown()

    jallow = jnp.asarray(np.stack([np.eye(V, dtype=np.float32)[(t + 1) % V] for t in range(V)]))
    jeps = _by_prompt(_run_jax_engine(
        jmodel, jparams, [(ids, msk)], gkw, processor=lambda lg, ctx: jnp.where(jallow[ctx["last_token"]] > 0, 0.0,
                                                                                -1e9),
        spec_decode="ngram", spec_k=4, drafter=JaxNgramDrafter(0, transition=lambda t: (t + 1) % V)))
    for ep in eps:
        np.testing.assert_array_equal(ep.response_ids, jeps[tuple(ep.prompt_ids.tolist())].response_ids)


def test_spec_sampled_free_distribution_runs_clean(monkeypatch):
    """Unconstrained sampled speculation: episodes complete with well-formed
    masks, the gauges stay in range, and the forced position 0 keeps
    progress at >= 1 token a dispatch."""
    _, _, model, ids, msk = _tiny_model()
    gcfg = GenerateConfig(max_new_tokens=8, do_sample=True, temperature=1.0, eos_token_id=None, pad_token_id=0)
    _no_decode_call(monkeypatch)
    engine, eps, stats = _run_engine(model, [(ids, msk)], gcfg, spec_decode="ngram", spec_k=4,
                                     generator=torch.Generator().manual_seed(3))
    assert len(eps) == 3
    for ep in eps:
        assert ep.decode_steps == 8
        assert ep.response_mask.sum() == 8
        assert (ep.response_ids >= 0).all() and (ep.response_ids < V).all()
    assert 0.0 < stats["engine/spec_accept_rate"] <= 1.0
    assert stats["engine/decode_dispatches"] <= stats["engine/decode_tokens"]
    engine.shutdown()


# ------------------------------------------------------ lifted engine guards


def test_soft_prompt_engine_parity_with_and_without_spec():
    """A soft-prompt model decodes through the engine (the prefill replays
    the prefix into cache rows [0, n_soft)): the plain and speculative
    engines equal whole-batch generate() and the JAX engine token for token;
    the paged pool refuses soft prompts."""
    jmodel, jparams, model, ids, msk = _tiny_model(n_soft_tokens=3)
    gkw = dict(max_new_tokens=8, do_sample=False, eos_token_id=None, pad_token_id=0)
    gcfg = GenerateConfig(**gkw)
    toks, m = make_generate_fn(model, gcfg)(ids, msk, None)
    toks, m = toks.numpy(), m.numpy()
    P = ids.shape[1]
    ref = {tuple(ids[b].tolist()): (toks[b, P:], m[b, P:]) for b in range(3)}
    for kw in ({}, dict(spec_decode="ngram", spec_k=4)):
        engine, eps, _ = _run_engine(model, [(ids, msk)], gcfg, **kw)
        assert engine.cache_len == 3 + 6 + 8 + (3 if kw else 0)
        jeps = _by_prompt(_run_jax_engine(jmodel, jparams, [(ids, msk)], gkw, **kw))
        assert len(eps) == 3
        for ep in eps:
            rt, rm = ref[tuple(ep.prompt_ids.tolist())]
            np.testing.assert_array_equal(ep.response_ids, rt)
            np.testing.assert_array_equal(ep.response_mask, rm)
            np.testing.assert_array_equal(ep.response_ids, jeps[tuple(ep.prompt_ids.tolist())].response_ids)
        engine.shutdown()
    with pytest.raises(ValueError, match="soft prompts"):
        RolloutEngine(model, gcfg, n_slots=2, prompt_width=6, paged_kv=True, kv_block_size=4)


# ------------------------------------------------------------ e2e acceptance


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


def _lean(config, tmp_path, total_steps=3):
    """The JAX test's lean engine config, as a dict of the port's sections."""
    d = {k: dataclasses.asdict(getattr(config, k)) for k in ("model", "train", "method")}
    d["train"].update(total_steps=total_steps, epochs=2, batch_size=16, eval_interval=100,
                      checkpoint_dir=str(tmp_path))
    d["method"].update(num_rollouts=16, chunk_size=16, rollout_engine=True, engine_slots=8, prefill_batch=4,
                       engine_steps_per_sync=4)
    return d


def _train(task, cfg):
    _, logit_mask, metric_fn, reward_fn = task
    config = TRLConfig.from_dict(cfg)
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    model = trlx_tpu_torch.train(reward_fn=None if config.model.has_reward_model else reward_fn, prompts=prompts,
                                 eval_prompts=[[1]], metric_fn=metric_fn, config=config, logit_mask=logit_mask,
                                 device="cpu")
    with open(os.path.join(cfg["train"]["checkpoint_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return model, records


def test_ppo_engine_spec_with_on_device_rm_trains(task, tmp_path):
    """PPO through the engine with spec_decode armed and rollouts scored by
    an on-device reward model: trains, exports the dispatch/token split and
    the accept rate, and tears the engine down."""
    cfg = _lean(base_config("ppo", 15, 8), tmp_path)
    cfg["model"]["reward_model_arch"] = dict(cfg["model"]["model_arch"])
    cfg["method"].update(spec_decode="ngram", spec_k=3)
    model, records = _train(task, cfg)
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert model.has_reward_model and model.reward_fn is None
    split = [r for r in records if "exp_decode_dispatches" in r]
    assert split, "exp_decode_dispatches never exported"
    for r in split:
        assert r["exp_decode_dispatches"] <= r["exp_decode_tokens"]
    rates = [r["engine/spec_accept_rate"] for r in records if "engine/spec_accept_rate" in r]
    assert rates and all(0.0 < x <= 1.0 for x in rates)
    occ = [r["engine/slot_occupancy"] for r in records if "engine/slot_occupancy" in r]
    assert occ and all(0.0 < o <= 1.0 for o in occ)
    assert model._rollout_engine is None


def test_ppo_softprompt_trains_through_engine(task, tmp_path):
    """The soft-prompt trainer (frozen trunk, learned prefix) routes its
    experience through the engine, whose prefill replays the prefix."""
    cfg = _lean(base_config("ppo", 15, 8), tmp_path, total_steps=2)
    cfg["model"]["model_type"] = "ppo_softprompt"
    cfg["method"].update(name="pposoftpromptconfig", n_soft_tokens=4)
    model, records = _train(task, cfg)
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert model.model.cfg.n_soft_tokens == 4
    occ = [r["engine/slot_occupancy"] for r in records if "engine/slot_occupancy" in r]
    assert occ and all(0.0 < o <= 1.0 for o in occ)
    assert model._rollout_engine is None


def test_ngram_drafter_chains_and_learns_from_accepted_tokens():
    """The n-gram drafter matches the JAX package's on the same calls."""
    ours, theirs = NgramDrafter(0), JaxNgramDrafter(0)
    for d in (ours, theirs):
        d.reset_slot(1, [3, 4, 5, 3])
        d.observe(1, [3, 7, 8])
    for last in (3, 4, 7, 9):
        assert ours.propose(1, last, 4) == theirs.propose(1, last, 4)
    assert ours.propose(1, 3, 3) == [7, 8, 0]
    assert ours.propose(2, 3, 2) == [0, 0]  # a slot with no table drafts pad
    fixed = NgramDrafter(0, transition=lambda t: t + 1)
    assert fixed.propose(0, 5, 3) == [6, 7, 8]
