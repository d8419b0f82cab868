"""The port's sampler against the JAX package's ``generate``, on the same
weights and prompts. The two frameworks draw different random numbers, so
the path is forced: a bigram logit mask that allows exactly one successor
per token leaves one finite logit, which even ``do_sample=True`` picks in
both. The rollout statistics read the raw logits, so they still test the
model: tokens must be equal, and the logprob / value / branch-hidden stats
and the prefill extras agree within 1e-4 (float32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.heads import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.models.lm import LMConfig as JaxLMConfig
from trlx_tpu.ops.generate import make_generate_fn as jax_make_generate_fn
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig
from trlx_tpu.ops.sampling import make_bigram_mask_processor as jax_bigram
from trlx_tpu.ops.sampling import process_logits_default as jax_process
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.models.lm import LMConfig
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.sampling import GenerateConfig, make_bigram_mask_processor, process_logits_default

# Tiny shapes: one intra-op thread, so torch's thread pool does not compete
# with the other test files' workers for the cores.
torch.set_num_threads(1)

V = 29
ARCH = dict(
    vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
    parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
    extra={"lm_head_bias": True}, dtype="float32", param_dtype="float32",
)
GEN_KWARGS = dict(max_new_tokens=6, do_sample=True, temperature=0.7, top_p=0.9, top_k=0)


def forced_bigram_mask(vocab: int, seed: int) -> np.ndarray:
    """[vocab, vocab] bool, True = forbidden: each token has exactly one
    allowed successor."""
    succ = np.random.default_rng(seed).permutation(vocab)
    mask = np.ones((vocab, vocab), dtype=bool)
    mask[np.arange(vocab), succ] = False
    return mask


def _stats_fn_jax(tok, s):
    lp = jax.nn.log_softmax(s["last_logits"], axis=-1)
    return {"logprob": jnp.take_along_axis(lp, tok[:, None].astype(jnp.int32), axis=-1)[:, 0],
            "value": s["carry"]["values"], "branch_hidden": s["carry"]["branch_hidden"]}


def _stats_fn_torch(tok, s):
    lp = torch.log_softmax(s["last_logits"], dim=-1)
    return {"logprob": torch.gather(lp, -1, tok[:, None].long())[:, 0],
            "value": s["carry"]["values"], "branch_hidden": s["carry"]["branch_hidden"]}


@pytest.mark.parametrize("with_eos", [False, True], ids=["no-eos", "eos"])
def test_generate_fused_stats_match(with_eos):
    branch_layer = 2
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(ARCH), branch_layer=branch_layer)
    ids0 = jnp.ones((1, 4), dtype=jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids0, jnp.ones_like(ids0))["params"])
    tmodel = LMWithValueHead(LMConfig.from_dict(ARCH), branch_layer=branch_layer, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tmodel))
    tmodel.requires_grad_(False)

    logit_mask = forced_bigram_mask(V, seed=1)
    rng = np.random.default_rng(2)
    B, P = 3, 9
    ids = rng.integers(1, V, size=(B, P)).astype(np.int32)
    pmask = np.ones((B, P), dtype=np.int32)
    pmask[1, :4] = 0
    ids[1, :4] = 0
    # With eos: the forced path of row 0 reaches it two steps in, so the
    # row finishes early while the others run on.
    succ = np.argmin(logit_mask, axis=1)
    eos = int(succ[succ[ids[0, -1]]]) if with_eos else None

    jg = JaxGenerateConfig.from_gen_kwargs(GEN_KWARGS, prompt_len=P, eos_token_id=eos)
    jb = jax_bigram(jnp.asarray(logit_mask))
    jfn = jax_make_generate_fn(
        jmodel, jg, lambda lg, st: jax_process(jb(lg, st), jg, st["step"]),
        carry_keys=("values", "branch_hidden"), step_stats_fn=_stats_fn_jax,
        apply_kwargs={"collect_branch_hidden": True}, prefill_collect=("branch_hidden",),
    )
    j_tokens, j_mask, j_stats, j_pre = jfn({"params": params}, jnp.asarray(ids), jnp.asarray(pmask),
                                           jax.random.PRNGKey(5))

    tg = GenerateConfig.from_gen_kwargs(GEN_KWARGS, prompt_len=P, eos_token_id=eos)
    assert tg == GenerateConfig(**jg.__dict__)
    tb = make_bigram_mask_processor(logit_mask)
    tfn = make_generate_fn(
        tmodel, tg, lambda lg, st: process_logits_default(tb(lg, st), tg, st["step"]),
        carry_keys=("values", "branch_hidden"), step_stats_fn=_stats_fn_torch,
        apply_kwargs={"collect_branch_hidden": True}, prefill_collect=("branch_hidden",),
    )
    t_tokens, t_mask, t_stats, t_pre = tfn(torch.from_numpy(ids), torch.from_numpy(pmask),
                                           torch.Generator().manual_seed(5))

    np.testing.assert_array_equal(t_tokens.numpy(), np.asarray(j_tokens))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    if with_eos:
        assert (np.asarray(j_mask)[:, P:] == 0).any(), "eos never sampled: the early-finish path went untested"
    for key in ("logprob", "value", "branch_hidden"):
        np.testing.assert_allclose(t_stats[key].numpy(), np.asarray(j_stats[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    rows = pmask.astype(bool)
    np.testing.assert_allclose(t_pre["branch_hidden"].numpy()[rows], np.asarray(j_pre["branch_hidden"])[rows],
                               rtol=1e-4, atol=1e-4)


def test_gen_kwargs_translation_matches():
    for kw, P in ((dict(max_length=48, min_length=48, top_p=0.7, temperature=0.5), 16),
                  (dict(max_new_tokens=7, min_new_tokens=2, do_sample=False, top_k=3), 5),
                  (dict(max_length=10), 20)):
        j = JaxGenerateConfig.from_gen_kwargs(kw, prompt_len=P, eos_token_id=3)
        t = GenerateConfig.from_gen_kwargs(kw, prompt_len=P, eos_token_id=3)
        assert j.__dict__ == t.__dict__


def test_logit_processors_match():
    """min-length EOS suppression → temperature → top-k → top-p, and the
    bigram mask, on random logits."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, V)).astype(np.float32) * 3
    for kw in (dict(top_k=5, top_p=1.0), dict(top_k=0, top_p=0.8, temperature=0.6),
               dict(top_k=7, top_p=0.5, min_new_tokens=3)):
        j = JaxGenerateConfig(eos_token_id=2, **kw)
        t = GenerateConfig(eos_token_id=2, **kw)
        for step in (0, 5):
            ref = np.asarray(jax_process(jnp.asarray(logits), j, jnp.asarray(step)))
            got = process_logits_default(torch.from_numpy(logits), t, step).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    lm = forced_bigram_mask(V, 3)
    last = rng.integers(0, V, size=(4,)).astype(np.int32)
    ref = np.asarray(jax_bigram(jnp.asarray(lm))(jnp.asarray(logits), {"last_token": jnp.asarray(last)}))
    got = make_bigram_mask_processor(lm)(torch.from_numpy(logits), {"last_token": torch.from_numpy(last)}).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# Compute-dtype weight copies (lm.frozen_copy): cast once per weight version
# where no gradient flows, with outputs bit-equal to the per-call cast.
# ---------------------------------------------------------------------------

BF16_ARCH = dict(ARCH, dtype="bfloat16", param_dtype="float32")


def _bf16_model(tied: bool, unfrozen: int, seed: int = 0, remat: bool = False):
    """A bf16-compute model over f32 masters, seeded; the bottom blocks
    frozen as the trainer freezes them (``trainable_mask``)."""
    from trlx_tpu_torch.models.heads import trainable_mask
    from trlx_tpu_torch.models.hf_import import init_params

    arch = dict(BF16_ARCH, tie_word_embeddings=tied, extra={} if tied else {"lm_head_bias": True}, remat=remat)
    cfg = LMConfig.from_dict(arch)
    model = LMWithValueHead(cfg, branch_layer=cfg.n_layer - unfrozen, device="cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    keep = trainable_mask(model, cfg, unfrozen)
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)
    return model


def _no_weight_cache(monkeypatch):
    """Every weight cast per call, as before the cache."""
    from trlx_tpu_torch.models import lm as lm_mod

    monkeypatch.setattr(lm_mod, "frozen_copy", lambda w, dtype: None)


def _greedy(model, ids, pmask):
    gcfg = GenerateConfig.from_gen_kwargs(dict(max_new_tokens=6, do_sample=False), prompt_len=ids.shape[1])
    with torch.no_grad():
        return make_generate_fn(model, gcfg, step_stats_fn=_stats_fn_torch, carry_keys=("values", "branch_hidden"),
                                apply_kwargs={"collect_branch_hidden": True})(ids, pmask, None)


def _prompts(seed=2, B=3, P=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, size=(B, P)).astype(np.int32)
    pmask = np.ones((B, P), dtype=np.int32)
    pmask[1, :4] = 0
    ids[1, :4] = 0
    return torch.from_numpy(ids), torch.from_numpy(pmask)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_weight_cache_greedy_bit_equal(tied, monkeypatch):
    """Greedy tokens, logprobs, values and the full-pass logits with the
    cached bf16 copies equal, bit for bit, those of the per-call cast; the
    copies are made once and reused while the weights do not change."""
    model = _bf16_model(tied, unfrozen=1)
    ids, pmask = _prompts()
    with_cache = _greedy(model, ids, pmask)
    q = model.transformer.h_0.attn.q_proj.kernel
    held = q._frozen_copy[1]
    assert held.dtype == torch.bfloat16
    with torch.no_grad():
        logits = model(ids, pmask)["logits"]
    assert q._frozen_copy[1] is held  # not cast again
    monkeypatch.setattr(q, "_frozen_copy", None)
    _no_weight_cache(monkeypatch)
    without = _greedy(model, ids, pmask)
    with torch.no_grad():
        ref_logits = model(ids, pmask)["logits"]
    assert q._frozen_copy is None
    assert torch.equal(logits, ref_logits)
    for a, b in zip(with_cache[:2], without[:2]):
        assert torch.equal(a, b)
    for key in ("logprob", "value", "branch_hidden"):
        assert torch.equal(with_cache[2][key], without[2][key]), key


def _ppo_like_loss(model, ids, pmask):
    """A loss through the whole model: the fused head's label logprobs (and
    entropy) of the response and the value head."""
    P = 5
    out = model(ids, pmask, logits_start=P - 1, labels=ids[:, P:], labels_mask=pmask[:, P:])
    return -(out["logprobs"].sum() + 0.1 * out["entropy"].sum()) + out["values"].float().pow(2).sum()


def test_weight_cache_refreshed_after_optimizer_step():
    """After one ClippedAdamW step, a no-grad pass equals a fresh module's
    on the updated weights: the step bumps each trained weight's version,
    which drops its stale copy."""
    from trlx_tpu_torch.trainer.base import ClippedAdamW

    model = _bf16_model(tied=False, unfrozen=1)
    ids, pmask = _prompts()
    with torch.no_grad():
        before = model(ids, pmask)["logits"]  # caches every weight, trained ones too
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(_ppo_like_loss(model, ids, pmask), params)
    opt = ClippedAdamW(params, lambda k: 1e-2, 0.9, 0.95, 1e-6, 1.0)
    opt.step(params, grads)
    with torch.no_grad():
        after = model(ids, pmask)["logits"]
    fresh = _bf16_model(tied=False, unfrozen=1, seed=1)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = fresh(ids, pmask)["logits"]
    assert not torch.equal(after, before)
    assert torch.equal(after, ref)


@pytest.mark.parametrize("tied,remat", [(False, False), (True, False), (False, True)],
                         ids=["untied", "tied", "untied-remat"])
def test_weight_cache_train_step_grads_unchanged(tied, remat, monkeypatch):
    """The gradients of a train step, with grad mode on: the frozen blocks
    take their cached copies (in the remat recompute too) and still pass the
    gradient through to the embeddings below them; the trained blocks and
    head take the differentiable per-call cast. Every gradient equals the
    uncached run's, bit for bit."""
    ids, pmask = _prompts(seed=4)

    def grads():
        model = _bf16_model(tied, unfrozen=1, remat=remat)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        loss = _ppo_like_loss(model, ids, pmask)
        loss2 = _ppo_like_loss(model, ids, pmask)  # a second pass reuses the frozen copies
        return names, torch.autograd.grad(loss + loss2, [p for p in model.parameters() if p.requires_grad]), model

    names, cached, model = grads()
    frozen = model.transformer.h_0.mlp.c_fc.kernel
    assert not frozen.requires_grad and frozen._frozen_copy is not None
    assert getattr(model.transformer.h_2.mlp.c_fc.kernel, "_frozen_copy", None) is None  # trained: per call
    _no_weight_cache(monkeypatch)
    names2, plain, _ = grads()
    assert names == names2 and "transformer.wte.embedding" in names
    for n, a, b in zip(names, cached, plain):
        assert torch.equal(a, b), n
