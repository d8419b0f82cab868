"""The port's continuous-batching rollout engine (``trlx_tpu_torch.engine``)
against the JAX package's, and against the port's own whole-batch sampler.

Mirrors ``tests/test_engine.py``: the width-grouped admission queue; the
model's vector ``cache_index`` (per-row scatter writes, per-row positions
and causal frontier) against the scalar path, int8 KV on and off; greedy
slot decode token for token against whole-batch ``generate`` with mixed
widths, mixed response lengths and refills; the straggler accounting; the
weight handoff and its version spans; the paged engine with prefix hits
against the fixed-slot engine; an undersized pool; abort. And the port's
engine against the JAX engine on the same weights, greedy, token for token,
for paged / fixed x int8 / bf16 with prefix hits.

Models are float32 on the CPU, so attention takes the einsum path on both
sides (the JAX package routes to its kernels on a TPU only, the port on a
CUDA device only); greedy tokens must be equal, which float32 summation
order (~1e-6) does not disturb at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.engine import RolloutEngine as JaxRolloutEngine
from trlx_tpu.models import LMConfig as JaxLMConfig
from trlx_tpu.models import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig
from trlx_tpu_torch.engine import Episode, RolloutEngine
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.models.lm import LMConfig, init_cache
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.sampling import GenerateConfig
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptSlotQueue
from trlx_tpu_torch.trainer.base import BaseTrainer

# Tiny shapes: one intra-op thread, so torch's thread pool does not compete
# with the other test files' workers for the cores.
torch.set_num_threads(1)

VOCAB = 23
_MODELS = {}


def _models(quant=False):
    """(JAX module, JAX params, the port's module on the same weights) of a
    2-layer GPT-2-style model, int8 KV cache when ``quant``."""
    if quant not in _MODELS:
        kw = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, max_position=96, dtype="float32",
                  kv_cache_quant=quant)
        jmodel = JaxLMWithValueHead(JaxLMConfig(**kw))
        rng = jax.random.PRNGKey(0)
        ids = jax.random.randint(rng, (3, 6), 2, VOCAB)
        params = jax.device_get(jmodel.init(rng, ids, jnp.ones((3, 6), jnp.int32))["params"])
        tmodel = LMWithValueHead(LMConfig(**kw), device="cpu")
        tmodel.load_state_dict(params_from_jax(params, tmodel))
        tmodel.requires_grad_(False)
        _MODELS[quant] = (jmodel, {"params": params}, tmodel)
    return _MODELS[quant]


def _drain(engine):
    episodes = []
    for _ in range(200):
        episodes.extend(engine.step())
        if engine.idle:
            break
    return episodes


def _by_prompt(episodes):
    return {(tuple(e.prompt_ids.tolist()), tuple(e.prompt_mask.tolist())): e for e in episodes}


# ------------------------------------------------------------ admission queue


def test_prompt_slot_queue_groups_by_width_fifo():
    q = PromptSlotQueue()
    q.push_rows(np.arange(8).reshape(2, 4), np.ones((2, 4), np.int32))
    q.push_rows(np.arange(18).reshape(3, 6), np.ones((3, 6), np.int32))
    assert len(q) == 5
    width, ids, msk = q.pop_group(2)  # the fullest width first
    assert width == 6 and ids.shape == (2, 6)
    np.testing.assert_array_equal(ids[0], np.arange(6))  # FIFO within a width
    width, ids, _ = q.pop_group(10)
    assert width in (4, 6)
    assert len(q) + ids.shape[0] == 3
    while q.pop_group(10) is not None:
        pass
    assert len(q) == 0 and q.pop_group(1) is None


# ------------------------------------------------------- vector cache_index


def _staggered(model):
    """Prompts [3, 6] with row 0 left-padded, and row b's sequence ending b
    positions early, so each row appends at its own offset P - b."""
    rng = np.random.default_rng(0)
    ids = rng.integers(2, VOCAB, size=(3, 6)).astype(np.int32)
    mask = np.ones((3, 6), np.int32)
    ids[0, :2] = 0
    mask[0, :2] = 0
    for b in range(3):
        mask[b, 6 - b:] = 0
    return ids, mask


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_vector_cache_index_matches_scalar_per_row(quant):
    """One decode step with a [b] cache_index at different per-row offsets
    equals each row alone through the int offset, the scatter lands at
    each row's offset and nowhere past it, and the logits equal the JAX
    model's vector step on the same weights."""
    jmodel, jparams, model = _models(quant)
    ids, row_mask = _staggered(model)
    B, P = ids.shape
    T = P + 4
    vec = np.asarray([P - b for b in range(B)], np.int32)
    tok = np.asarray([[5], [7], [9]], np.int32)
    cm = np.zeros((B, T), np.int32)
    cm[:, :P] = row_mask
    cm[np.arange(B), vec] = 1

    with torch.no_grad():
        cache = init_cache(model.cfg, B, T, "cpu")
        pre_cm = np.zeros((B, T), np.int32)
        pre_cm[:, :P] = row_mask
        model(torch.from_numpy(ids), torch.from_numpy(row_mask), cache=cache, cache_index=0,
              cache_mask=torch.from_numpy(pre_cm))
        before = [leaf.clone() for leaf in cache[0]]
        out_vec = model(torch.from_numpy(tok), torch.ones((B, 1), dtype=torch.int32), cache=cache,
                        cache_index=torch.from_numpy(vec), cache_mask=torch.from_numpy(cm))
        for b in range(B):
            cache_b = init_cache(model.cfg, 1, T, "cpu")
            model(torch.from_numpy(ids[b:b + 1]), torch.from_numpy(row_mask[b:b + 1]), cache=cache_b, cache_index=0,
                  cache_mask=torch.from_numpy(pre_cm[b:b + 1]))
            out_b = model(torch.from_numpy(tok[b:b + 1]), torch.ones((1, 1), dtype=torch.int32), cache=cache_b,
                          cache_index=int(vec[b]), cache_mask=torch.from_numpy(cm[b:b + 1]))
            np.testing.assert_allclose(out_vec["logits"][b].numpy(), out_b["logits"][0].numpy(), rtol=1e-5,
                                       atol=1e-5)
    for leaf, old in zip(cache[0], before):
        for b in range(B):
            w = int(vec[b])
            assert not torch.equal(leaf[b, w], old[b, w]), f"row {b}: nothing written at offset {w}"
            assert torch.equal(leaf[b, w + 1:], old[b, w + 1:])

    from trlx_tpu.models.lm import init_cache as jax_init_cache

    jcache = jax_init_cache(jmodel.cfg, B, T)
    pre = jmodel.apply(jparams, jnp.asarray(ids), jnp.asarray(row_mask), cache=jcache, cache_index=0,
                       cache_mask=jnp.asarray(pre_cm))
    jout = jmodel.apply(jparams, jnp.asarray(tok), jnp.ones((B, 1), jnp.int32), cache=pre["cache"],
                        cache_index=jnp.asarray(vec), cache_mask=jnp.asarray(cm))
    # float32 rounding differs between the frameworks by ~1e-7, which can put
    # one value on the other side of a code's rounding boundary: an int8 code
    # one apart moves that key by absmax / 127 and the logits by ~1e-3.
    tol = 2e-3 if quant else 1e-4
    np.testing.assert_allclose(out_vec["logits"].numpy(), np.asarray(jout["logits"]), rtol=tol, atol=tol)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_vector_cache_index_multi_token_window_matches_sequential(quant):
    """A 3-token query at staggered [b] offsets equals the same tokens one
    at a time through the single-token vector path: logits at every window
    position, and the cache writes (int8 codes within one step, where a
    scale computed over a different reduction order may move a code)."""
    _, _, model = _models(quant)
    ids, row_mask = _staggered(model)
    B, P = ids.shape
    K = 3
    T = P + K + 2
    wp = np.array([P - b for b in range(B)], np.int64)
    window = np.array([[5, 7, 9], [9, 5, 7], [7, 9, 5]], np.int32)

    def prefilled():
        cache = init_cache(model.cfg, B, T, "cpu")
        cm = np.zeros((B, T), np.int32)
        cm[:, :P] = row_mask
        model(torch.from_numpy(ids), torch.from_numpy(row_mask), cache=cache, cache_index=0,
              cache_mask=torch.from_numpy(cm))
        return cache

    def cm_for(extent):
        cm = np.zeros((B, T), np.int32)
        cm[:, :P] = row_mask
        for b in range(B):
            cm[b, int(wp[b]): int(wp[b]) + int(extent)] = 1
        return torch.from_numpy(cm)

    with torch.no_grad():
        cache_w = prefilled()
        out_w = model(torch.from_numpy(window), torch.ones((B, K), dtype=torch.int32), cache=cache_w,
                      cache_index=torch.from_numpy(wp), cache_mask=cm_for(K))
        cache_s = prefilled()
        for j in range(K):
            out_j = model(torch.from_numpy(window[:, j:j + 1]), torch.ones((B, 1), dtype=torch.int32), cache=cache_s,
                          cache_index=torch.from_numpy(wp + j), cache_mask=cm_for(j + 1))
            np.testing.assert_allclose(out_w["logits"][:, j].numpy(), out_j["logits"][:, 0].numpy(), rtol=1e-5,
                                       atol=1e-5)
    for lw, ls in zip((x for layer in cache_w for x in layer), (x for layer in cache_s for x in layer)):
        if lw.dtype == torch.int8:
            assert (lw.int() - ls.int()).abs().max() <= 1
        else:
            np.testing.assert_allclose(lw.numpy(), ls.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- greedy parity


def _mixed_prompts(seed=3):
    """Unique prompts at two widths, one row left-padded."""
    rng = np.random.default_rng(seed)
    w6 = rng.integers(2, VOCAB, size=(3, 6)).astype(np.int32)
    m6 = np.ones((3, 6), np.int32)
    w6[0, :2] = 0
    m6[0, :2] = 0
    w4 = rng.integers(2, VOCAB, size=(3, 4)).astype(np.int32)
    m4 = np.ones((3, 4), np.int32)
    return (w6, m6), (w4, m4)


def _reference_episodes(model, gcfg, groups):
    """Whole-batch greedy decode per width group → prompt-keyed responses."""
    ref = {}
    for ids, msk in groups:
        toks, m = make_generate_fn(model, gcfg)(torch.from_numpy(ids), torch.from_numpy(msk), torch.Generator())
        P = ids.shape[1]
        for b in range(ids.shape[0]):
            ref[(tuple(ids[b].tolist()), tuple(msk[b].tolist()))] = (toks[b, P:].numpy(), m[b, P:].numpy())
    return ref


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_engine_greedy_parity_token_for_token(quant):
    """Per-slot decode equals whole-batch decode token for token and mask
    bit for mask bit, across two widths and natural mixed response lengths
    (an eos the greedy decode emits at different depths), with fewer slots
    than prompts so refills happen mid-run."""
    _, _, model = _models(quant)
    (w6, m6), (w4, m4) = _mixed_prompts()
    free = GenerateConfig(max_new_tokens=8, do_sample=False, eos_token_id=None, pad_token_id=0)
    first_at = {}
    for ids, msk in ((w6, m6), (w4, m4)):
        toks, _ = make_generate_fn(model, free)(torch.from_numpy(ids), torch.from_numpy(msk), torch.Generator())
        for row in toks[:, ids.shape[1]:].tolist():
            seen = {}
            for step, t in enumerate(row):
                seen.setdefault(int(t), step)
            for t, step in seen.items():
                first_at.setdefault(t, set()).add(step)
    eos = max(first_at, key=lambda t: len(first_at[t]))
    assert len(first_at[eos]) >= 2, "the tiny model emitted no repeated token: reseed"
    gcfg = GenerateConfig(max_new_tokens=8, do_sample=False, eos_token_id=eos, pad_token_id=0)
    ref = _reference_episodes(model, gcfg, [(w6, m6), (w4, m4)])

    engine = RolloutEngine(model, gcfg, n_slots=4, prompt_width=6, prefill_batch=2, steps_per_sync=3)
    engine.update_weights(model, version=7)
    engine.submit(w6, m6)
    engine.submit(w4, m4)
    assert engine.pending == 6
    episodes = _drain(engine)
    assert len(episodes) == 6
    for key, ep in _by_prompt(episodes).items():
        assert isinstance(ep, Episode) and ep.weight_version == 7 and ep.version_spans == [(7, ep.decode_steps)]
        rtoks, rmask = ref[key]
        np.testing.assert_array_equal(ep.response_ids, rtoks)
        np.testing.assert_array_equal(ep.response_mask, rmask)
        assert ep.decode_steps == int(rmask.sum())
    lens = sorted(ep.decode_steps for ep in episodes)
    assert lens[0] < lens[-1], "no mixed lengths: the test proves nothing"

    stats = engine.stats(reset=False)
    assert 0.0 < stats["engine/slot_occupancy"] <= 1.0
    assert stats["engine/refills"] == 6 and stats["engine/completed"] == 6
    assert stats["engine/gen_tokens"] == sum(lens)
    assert stats["engine/decode_tokens_per_s"] > 0
    engine.stats(reset=True)
    assert engine.stats(reset=False)["engine/completed"] == 0
    engine.shutdown()
    assert engine.idle


def test_engine_straggler_accounting_under_early_exit():
    """Per-episode decode_steps sum to the engine's generated tokens, and
    the chunked path's helper reconciles per-episode steps with the steps
    the whole batch paid."""
    mask_h = np.zeros((3, 5 + 6), np.int32)
    mask_h[:, :5] = 1
    mask_h[0, 5:7] = 1
    mask_h[1, 5:9] = 1
    mask_h[2, 5:6] = 1
    ds = BaseTrainer.rollout_decode_stats(mask_h, 5)
    assert ds["episode_steps"].tolist() == [2, 4, 1]
    assert int(ds["episode_steps"].sum()) == ds["gen_tokens"] == 7
    assert ds["decode_steps"] == 4 and ds["decode_step_budget"] == 6

    _, _, model = _models()
    gcfg = GenerateConfig(max_new_tokens=6, do_sample=False, eos_token_id=None, pad_token_id=0)
    engine = RolloutEngine(model, gcfg, n_slots=2, prompt_width=4, prefill_batch=2)
    engine.update_weights(model)
    engine.submit(np.random.default_rng(0).integers(2, VOCAB, size=(4, 4)).astype(np.int32), np.ones((4, 4), np.int32))
    eps = []
    while not engine.idle:
        eps.extend(engine.step())
    assert sum(e.decode_steps for e in eps) == engine.stats()["engine/gen_tokens"] == 4 * 6
    engine.shutdown()


def test_mid_decode_update_splits_episodes_at_the_sync_boundary():
    """update_weights while slots are mid-decode is adopted at the next
    step(): with steps_per_sync 3 and 6 tokens and no eos, every episode
    splits [(1, 3), (2, 3)]; the same module under a new version leaves the
    tokens unchanged. A push storm adopts once, at the latest version, and
    re-pushing the held version records no switch."""
    _, _, model = _models()
    gcfg = GenerateConfig(max_new_tokens=6, do_sample=False, eos_token_id=None, pad_token_id=0)
    prompts = np.random.default_rng(5).integers(2, VOCAB, size=(2, 4)).astype(np.int32)
    pmask = np.ones((2, 4), np.int32)
    kw = dict(n_slots=2, prompt_width=4, prefill_batch=2, steps_per_sync=3)
    ref_engine = RolloutEngine(model, gcfg, **kw)
    ref_engine.update_weights(model, version=1)
    ref_engine.submit(prompts, pmask)
    ref = _by_prompt(_drain(ref_engine))

    engine = RolloutEngine(model, gcfg, **kw)
    engine.update_weights(model, version=1)
    engine.submit(prompts, pmask)
    assert engine.step() == []
    engine.update_weights(model, version=2)
    episodes = _drain(engine)
    assert len(episodes) == 2
    for key, ep in _by_prompt(episodes).items():
        assert ep.version_spans == [(1, 3), (2, 3)] and ep.weight_version == 2 and ep.decode_steps == 6
        np.testing.assert_array_equal(ep.response_ids, ref[key].response_ids)
    assert engine.stats(reset=False)["engine/weight_switches"] == 1

    engine.submit(np.full((2, 4), 3, np.int32), pmask)
    engine.step()
    for v in (3, 4, 5):
        engine.update_weights(model, version=v)
    assert all(ep.version_spans == [(2, 3), (5, 3)] for ep in _drain(engine))
    stats = engine.stats(reset=False)
    assert stats["engine/weight_switches"] == 2 and stats["engine/switches_coalesced"] == 2
    engine.submit(np.full((2, 4), 5, np.int32), pmask)
    engine.step()
    engine.update_weights(model, version=5)
    assert all(ep.version_spans == [(5, 6)] for ep in _drain(engine))
    assert engine.stats(reset=False)["engine/weight_switches"] == 2
    engine.shutdown()


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_engine_int8_decode_parity(kv_quant):
    """The engine adds no numeric skew on top of the int8 KV cache: three
    slots, two steps per sync, no eos, token for token against whole-batch
    decode on the same cache layout. (The JAX test also runs int8 decode
    weights, which the port has not ported.)"""
    _, _, model = _models(kv_quant)
    (w6, m6), (w4, m4) = _mixed_prompts()
    gcfg = GenerateConfig(max_new_tokens=6, do_sample=False, eos_token_id=None, pad_token_id=0)
    ref = _reference_episodes(model, gcfg, [(w6, m6), (w4, m4)])
    engine = RolloutEngine(model, gcfg, n_slots=3, prompt_width=6, prefill_batch=3, steps_per_sync=2)
    engine.update_weights(model, version=1)
    engine.submit(w6, m6)
    engine.submit(w4, m4)
    episodes = _drain(engine)
    assert len(episodes) == 6
    for key, ep in _by_prompt(episodes).items():
        np.testing.assert_array_equal(ep.response_ids, ref[key][0])
        np.testing.assert_array_equal(ep.response_mask, ref[key][1])
    engine.shutdown()


def test_engine_requires_weight_handoff_and_bounds_prompt_width():
    _, _, model = _models()
    gcfg = GenerateConfig(max_new_tokens=4, do_sample=False, pad_token_id=0)
    engine = RolloutEngine(model, gcfg, n_slots=2, prompt_width=4)
    with pytest.raises(RuntimeError, match="update_weights"):
        engine.step()
    with pytest.raises(ValueError, match="prompt width"):
        engine.submit(np.ones((1, 9), np.int32), np.ones((1, 9), np.int32))
    engine.update_weights(model)
    assert engine.step() == []  # an empty queue is a no-op, not an error
    engine.shutdown()


def test_rollout_engine_config_validation(tmp_path):
    """method.rollout_engine builds the engine (slots from engine_slots, the
    live module as the handoff); paged_kv without the engine raises, as in
    the JAX package; spec decoding arms the engine's drafter and scratch
    tail, and int8 decode weights ride on the handed-over module."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    def cfg(**method):
        return TRLConfig.from_dict({
            "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1,
                          model_arch=dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=16, max_position=32),
                          dtype="float32"),
            "train": dict(total_steps=1, seq_length=12, epochs=1, batch_size=4, lr_ramp_steps=1, lr_decay_steps=1,
                          weight_decay=0.0, learning_rate_init=1e-4, learning_rate_target=1e-4,
                          checkpoint_dir=str(tmp_path)),
            "method": dict(name="ppoconfig", num_rollouts=4, chunk_size=4,
                           gen_kwargs=dict(prompt_length=6, max_length=12), **method),
        })

    trainer = PPOTrainer(cfg(rollout_engine=True, engine_slots=3, paged_kv=True, kv_block_size=4), device="cpu")
    assert trainer.rollout_engine_enabled
    engine = trainer.rollout_engine()
    assert trainer.rollout_engine() is engine and trainer.rollout_engine_variables() is trainer.model
    assert engine.n_slots == 3 and engine.paged and engine.blocks_per_slot == 3 and engine.n_blocks == 10
    trainer._shutdown_rollout_engine()
    assert trainer._rollout_engine is None
    with pytest.raises(ValueError, match="paged_kv requires method.rollout_engine"):
        PPOTrainer(cfg(paged_kv=True), device="cpu")
    spec = PPOTrainer(cfg(rollout_engine=True, spec_decode="ngram", spec_k=3), device="cpu").rollout_engine()
    assert spec.spec_k == 3 and spec.drafter is not None and spec.cache_len == 6 + 6 + 2
    c = cfg(rollout_engine=True)
    c.model.decode_weight_quant = True
    w8 = PPOTrainer(c, device="cpu")
    assert w8.rollout_engine_variables().transformer.h_0.attn.c_qkv.w8[1].dtype == torch.int8


# --------------------------------------------------------- paged KV cache


def _paged_prompts():
    """7 width-6 rows, two of which repeat row 0 exactly (ids and mask):
    the prefix-cache hit candidates at kv_block_size 4."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, VOCAB, size=(7, 6)).astype(np.int32)
    pmask = np.ones((7, 6), np.int32)
    prompts[1, :2] = 0
    pmask[1, :2] = 0
    prompts[5] = prompts[0]
    prompts[6] = prompts[0]
    return prompts, pmask


GCFG_PAGED = dict(max_new_tokens=7, do_sample=False, pad_token_id=0, eos_token_id=1)
KW_PAGED = dict(n_slots=3, prompt_width=6, prefill_batch=2, steps_per_sync=3)


def _paged_pair(quant, paged_kwargs=None):
    """A (fixed, paged) pair of the port's engines over the same model."""
    _, _, model = _models(quant)
    gcfg = GenerateConfig(**GCFG_PAGED)
    fixed = RolloutEngine(model, gcfg, **KW_PAGED)
    paged = RolloutEngine(model, gcfg, **KW_PAGED, paged_kv=True, **(paged_kwargs or {"kv_block_size": 4}))
    for e in (fixed, paged):
        e.update_weights(model, version=1)
    return fixed, paged


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_paged_engine_token_parity_with_prefix_hits(quant):
    """The paged engine with prefix caching equals the fixed-slot engine
    token for token, hits (the repeated rows skip their shared block's
    prefill) and leaves a clean pool."""
    prompts, pmask = _paged_prompts()
    fixed, paged = _paged_pair(quant)
    for e in (fixed, paged):
        e.submit(prompts, pmask)
    ref, got = _by_prompt(_drain(fixed)), _by_prompt(_drain(paged))
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(ref[k].response_ids, got[k].response_ids)
        np.testing.assert_array_equal(ref[k].response_mask, got[k].response_mask)
    st = paged.stats()
    assert st["engine/prefix_hits_total"] >= 1 and st["engine/prefill_tokens_saved_total"] >= 4
    assert 0.0 <= st["engine/pool_frag_frac"] <= 1.0
    paged.pool.leak_audit(expect_idle=True)
    fixed.shutdown()
    paged.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_engine_matches_jax_engine(paged, quant):
    """The port's engine against the JAX package's on the same weights and
    prompts, greedy: the same episodes token for token and mask bit for
    mask bit, in the same completion order, and (paged) the same prefix
    hits, saved tokens and pool counters."""
    jmodel, jparams, model = _models(quant)
    prompts, pmask = _paged_prompts()
    extra = {"paged_kv": True, "kv_block_size": 4} if paged else {}
    jeng = JaxRolloutEngine(jmodel, JaxGenerateConfig(**GCFG_PAGED), **KW_PAGED, rng=jax.random.PRNGKey(2), **extra)
    jeng.update_weights(jparams, version=1)
    teng = RolloutEngine(model, GenerateConfig(**GCFG_PAGED), **KW_PAGED, **extra)
    teng.update_weights(model, version=1)
    for e in (jeng, teng):
        e.submit(prompts, pmask)
    ref, got = _drain(jeng), _drain(teng)
    assert len(got) == len(ref) == 7
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.prompt_ids, r.prompt_ids)
        np.testing.assert_array_equal(g.response_ids, np.asarray(r.response_ids))
        np.testing.assert_array_equal(g.response_mask, r.response_mask)
        assert g.decode_steps == r.decode_steps and g.version_spans == r.version_spans
    js, ts = jeng.stats(), teng.stats()
    keys = ["engine/decode_steps", "engine/gen_tokens", "engine/refills", "engine/prefill_batches",
            "engine/completed", "engine/slot_occupancy"]
    if paged:
        keys += ["engine/prefix_hits_total", "engine/prefill_tokens_saved_total", "engine/pool_evictions_total",
                 "engine/pool_cached_blocks", "engine/pool_free_blocks"]
        assert ts["engine/prefix_hits_total"] >= 1
        np.testing.assert_array_equal(teng.pool.tables, jeng.pool.tables)
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    jeng.shutdown()
    teng.shutdown()


def test_paged_engine_undersized_pool_requeues_and_drains():
    """A pool of two spans for three slots requeues pool-bound admissions
    and still drains the workload, with no leak."""
    prompts, pmask = _paged_prompts()
    _, paged = _paged_pair(False, paged_kwargs={"kv_block_size": 4, "kv_pool_blocks": 1 + 2 * 4})
    paged.submit(prompts, pmask)
    assert len(_drain(paged)) == 7
    paged.pool.leak_audit(expect_idle=True)
    paged.shutdown()


def test_paged_engine_abort_releases_all_blocks():
    """abort() mid-decode releases every pinned and private block (its leak
    audit raises otherwise) and points the device tables at the trash
    block."""
    prompts, pmask = _paged_prompts()
    _, paged = _paged_pair(False)
    paged.submit(prompts, pmask)
    paged.step()
    assert paged.pool.used_blocks() > 0
    paged.abort()
    assert paged.pool.used_blocks() == 0
    assert not paged._state["block_tables"].any()
    paged.shutdown()


def test_paged_kv_off_has_no_pool_and_no_tables():
    """paged_kv off: no pool, kv_len == cache_len, no block tables in the
    slot state, whatever the paged knobs say."""
    _, _, model = _models()
    off = RolloutEngine(model, GenerateConfig(**GCFG_PAGED), **KW_PAGED, paged_kv=False, kv_block_size=4,
                        kv_pool_blocks=99)
    assert off.pool is None and off.kv_len == off.cache_len
    off.update_weights(model, version=1)
    off._adopt_staged()
    off._ensure_state()
    assert "block_tables" not in off._state
    off.shutdown()
