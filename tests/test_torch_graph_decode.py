"""The decode step that the port captures as a CUDA graph, run here eagerly on
the CPU: the same step function a graph replays on the card.

- The chunked sampler's static-buffer step (a [1] device step counter, the
  vector ``cache_index`` P + step, device-indexed token, mask and stats
  writes) against the JAX package's ``generate`` on the same weights
  (``params_from_jax``, float32, greedy and forced-bigram sampling): tokens
  and masks equal, stats within 1e-4 as ``test_torch_generate.py`` holds
  them, and the stats bit-equal to a re-forward of the same tokens through
  the integer-offset cache path. A second call reuses the buffers.
- The engine's in-place decode call against the JAX engine, greedy: the
  same episodes, while the slot state keeps its addresses across calls.
- ``frozen_copy`` refreshes a stale copy in place after an optimizer step.
- ``StepGraph``'s replay accounting with a fake graph object.
- ``sample_categorical`` draws multinomial's tokens from the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.engine import RolloutEngine as JaxRolloutEngine
from trlx_tpu.models.heads import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.models.lm import LMConfig as JaxLMConfig
from trlx_tpu.ops.generate import make_generate_fn as jax_make_generate_fn
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig
from trlx_tpu.ops.sampling import make_bigram_mask_processor as jax_bigram
from trlx_tpu.ops.sampling import process_logits_default as jax_process
from trlx_tpu_torch.engine import RolloutEngine
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import init_params, params_from_jax
from trlx_tpu_torch.models.lm import LMConfig, init_cache, refresh_weight_copies
from trlx_tpu_torch.ops import decode_attention as dec
from trlx_tpu_torch.ops import flash_attention as fa
from trlx_tpu_torch.ops.cuda_graph import StepGraph, launch_counters
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.sampling import (
    GenerateConfig, make_bigram_mask_processor, process_logits_default, sample_categorical,
)
from trlx_tpu_torch.trainer.base import ClippedAdamW

# Tiny shapes: one intra-op thread, so torch's thread pool does not compete
# with the other test files' workers for the cores.
torch.set_num_threads(1)

V = 29
ARCH = dict(
    vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
    parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
    extra={"lm_head_bias": True}, dtype="float32", param_dtype="float32",
)
BRANCH = 2


def _pair(arch=ARCH, branch=BRANCH):
    """The JAX hydra model, its params, and the port's model on them."""
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(arch), branch_layer=branch)
    ids0 = jnp.ones((1, 4), dtype=jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids0, jnp.ones_like(ids0))["params"])
    tmodel = LMWithValueHead(LMConfig.from_dict(arch), branch_layer=branch, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tmodel))
    tmodel.requires_grad_(False)
    return jmodel, params, tmodel


def _stats_fn_jax(tok, s):
    lp = jax.nn.log_softmax(s["last_logits"], axis=-1)
    return {"logprob": jnp.take_along_axis(lp, tok[:, None].astype(jnp.int32), axis=-1)[:, 0],
            "value": s["carry"]["values"], "branch_hidden": s["carry"]["branch_hidden"]}


def _stats_fn_torch(tok, s):
    lp = torch.log_softmax(s["last_logits"], dim=-1)
    return {"logprob": torch.gather(lp, -1, tok[:, None].long())[:, 0],
            "value": s["carry"]["values"], "branch_hidden": s["carry"]["branch_hidden"]}


def _prompts(B=3, P=9, seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, size=(B, P)).astype(np.int32)
    pmask = np.ones((B, P), dtype=np.int32)
    pmask[1, :4] = 0
    ids[1, :4] = 0
    return ids, pmask


def _int_path_stats(model, ids, pmask, tokens, mask, N):
    """The per-step logprob and value of ``tokens`` re-forwarded through the
    model one step at a time at an INTEGER cache offset (the model's scalar
    ``cache_index`` path, against the sampler's vector one)."""
    B, P = ids.shape
    cache = init_cache(model.cfg, B, P + N, torch.device("cpu"))
    cmask = mask.clone()
    cmask[:, P:] = 0
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(pmask), cache=cache,
                    cache_index=0, cache_mask=cmask, logits_start=P - 1)
        lps, vals = [], []
        for step in range(N):
            tok = tokens[:, P + step]
            logp = torch.log_softmax(out["logits"][:, -1].float(), -1)
            lps.append(torch.gather(logp, -1, tok[:, None].long())[:, 0])
            vals.append(out["values"][:, -1])
            cmask[:, P + step] = mask[:, P + step]
            out = model(input_ids=tok[:, None], attention_mask=torch.ones((B, 1), dtype=torch.int32), cache=cache,
                        cache_index=P + step, cache_mask=cmask)
    live = mask[:, P:].float()
    return torch.stack(lps, 1) * live, torch.stack(vals, 1).float() * live


@pytest.mark.parametrize("sampling", ["greedy", "forced-bigram"])
def test_static_step_matches_jax_generate(sampling):
    """Tokens and masks of the static-buffer step equal JAX ``generate``'s;
    the fused stats agree within 1e-4 and equal, bit for bit, a re-forward
    through the integer-offset cache path; a second call of the same
    function, which reuses every buffer, returns the same."""
    jmodel, params, tmodel = _pair()
    ids, pmask = _prompts()
    B, P = ids.shape
    kw = dict(max_new_tokens=6, do_sample=sampling != "greedy", temperature=0.7, top_p=0.9, top_k=0)
    jg, tg = JaxGenerateConfig.from_gen_kwargs(kw, prompt_len=P), GenerateConfig.from_gen_kwargs(kw, prompt_len=P)
    jproc = tproc = None
    if sampling == "forced-bigram":
        succ = np.random.default_rng(1).permutation(V)
        mask = np.ones((V, V), dtype=bool)
        mask[np.arange(V), succ] = False
        jb, tb = jax_bigram(jnp.asarray(mask)), make_bigram_mask_processor(mask)

        def jproc(lg, st):
            return jax_process(jb(lg, st), jg, st["step"])

        def tproc(lg, st):
            return process_logits_default(tb(lg, st), tg, st["step"])

    common = dict(carry_keys=("values", "branch_hidden"), apply_kwargs={"collect_branch_hidden": True},
                  prefill_collect=("branch_hidden",))
    jfn = jax_make_generate_fn(jmodel, jg, jproc, step_stats_fn=_stats_fn_jax, **common)
    j_tokens, j_mask, j_stats, _ = jfn({"params": params}, jnp.asarray(ids), jnp.asarray(pmask),
                                       jax.random.PRNGKey(5))
    tfn = make_generate_fn(tmodel, tg, tproc, step_stats_fn=_stats_fn_torch, **common)
    runs = [tfn(torch.from_numpy(ids), torch.from_numpy(pmask), torch.Generator().manual_seed(5)) for _ in range(2)]
    keep = tfn.keywords["_keep"]["buffers"]
    assert keep["tokens"].shape == (B, P + 6) and int(keep["step"]) == 6
    for tokens, mask, stats, _ in runs:
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        for key in ("logprob", "value", "branch_hidden"):
            np.testing.assert_allclose(stats[key].numpy(), np.asarray(j_stats[key]), rtol=1e-4, atol=1e-4,
                                       err_msg=key)
        lp, val = _int_path_stats(tmodel, ids, pmask, tokens, mask, 6)
        assert torch.equal(stats["logprob"], lp) and torch.equal(stats["value"], val)
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()  # the outputs are copies of the buffers


def test_engine_in_place_decode_matches_jax_engine():
    """The engine's decode call, in place on its slot state, against the JAX
    engine, greedy, with refills and an eos exit: the same episodes token
    for token, and every state tensor keeps its address across calls (what a
    captured graph reads and writes)."""
    kw = dict(vocab_size=23, n_layer=2, n_head=2, d_model=32, max_position=96, dtype="float32")
    jmodel = JaxLMWithValueHead(JaxLMConfig(**kw))
    rng = jax.random.PRNGKey(0)
    ids0 = jax.random.randint(rng, (3, 6), 2, 23)
    params = jax.device_get(jmodel.init(rng, ids0, jnp.ones((3, 6), jnp.int32))["params"])
    model = LMWithValueHead(LMConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    model.requires_grad_(False)
    gk = dict(max_new_tokens=7, do_sample=False, pad_token_id=0, eos_token_id=1)
    ek = dict(n_slots=3, prompt_width=6, prefill_batch=2, steps_per_sync=3)
    prompts = np.random.default_rng(0).integers(2, 23, size=(7, 6)).astype(np.int32)
    pmask = np.ones((7, 6), np.int32)
    prompts[1, :2] = 0
    pmask[1, :2] = 0
    jeng = JaxRolloutEngine(jmodel, JaxGenerateConfig(**gk), **ek, rng=jax.random.PRNGKey(2))
    jeng.update_weights({"params": params}, version=1)
    teng = RolloutEngine(model, GenerateConfig(**gk), **ek)
    teng.update_weights(model, version=1)
    for e in (jeng, teng):
        e.submit(prompts, pmask)
    ref, got, ptrs = [], [], None
    for _ in range(100):
        ref.extend(jeng.step())
        if jeng.idle:
            break
    for _ in range(100):
        got.extend(teng.step())
        now = {k: v.data_ptr() for k, v in teng._state.items() if torch.is_tensor(v)}
        assert ptrs is None or now == ptrs
        ptrs = now
        if teng.idle:
            break
    assert len(got) == len(ref) == 7
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.prompt_ids, r.prompt_ids)
        np.testing.assert_array_equal(g.response_ids, np.asarray(r.response_ids))
        np.testing.assert_array_equal(g.response_mask, r.response_mask)
    jeng.shutdown()
    teng.shutdown()


def test_frozen_copy_refreshed_in_place_after_optimizer_step():
    """A trained weight's bf16 copy keeps its address across an optimizer
    step and takes the new values: ``refresh_weight_copies`` casts them in,
    and a no-grad pass then equals a fresh module's on the updated weights."""
    arch = dict(ARCH, dtype="bfloat16", param_dtype="float32")
    model = LMWithValueHead(LMConfig.from_dict(arch), branch_layer=BRANCH, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    ids, pmask = (torch.from_numpy(a) for a in _prompts())
    with torch.no_grad():
        model(ids, pmask)  # makes a copy of every weight
    w = model.transformer.h_2.mlp.c_fc.kernel  # a trained weight
    held = w._frozen_copy[1]
    ptr, before = held.data_ptr(), held.clone()
    params = list(model.parameters())
    out = model(ids, pmask)
    grads = torch.autograd.grad(out["logits"].float().pow(2).mean() + out["values"].float().mean(), params)
    ClippedAdamW(params, lambda k: 1e-2, 0.9, 0.95, 0.0, 1.0).step(params, grads)
    assert torch.equal(held, before)  # stale until refreshed
    assert refresh_weight_copies(model) > 0
    assert w._frozen_copy[1] is held and held.data_ptr() == ptr
    assert torch.equal(held, w.detach().to(torch.bfloat16)) and not torch.equal(held, before)
    assert refresh_weight_copies(model) == 0
    with torch.no_grad():
        after = model(ids, pmask)["logits"]
    fresh = LMWithValueHead(LMConfig.from_dict(arch), branch_layer=BRANCH, device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(after, fresh(ids, pmask)["logits"])


class FakeGraph:
    """Stands in for ``CudaGraph`` on the CPU: the capture runs the step's
    Python (which counts launches, as on the card), a replay runs nothing."""

    def __init__(self):
        self.replays = 0
        self.captured = False

    def capture(self):
        graph = self

        class _Ctx:
            def __enter__(self):
                return None

            def __exit__(self, *exc):
                graph.captured = True
                return False

        return _Ctx()

    def replay(self):
        self.replays += 1


def test_replay_adds_the_captured_launch_counts():
    """The capture's counts are taken back (a capture launches nothing) and
    every replay adds them; counters the step does not touch stay."""
    counted = launch_counters()
    assert dec.decode_attention in counted and fa.flash_fwd in counted and len(counted) == len(set(counted))

    def step():
        dec.decode_attention.launches += 28
        dec.paged_decode_attention_int8.launches += 3

    start = {f: f.launches for f in counted}
    graph = FakeGraph()
    sg = StepGraph(step, graph)
    assert graph.captured and {f: f.launches for f in counted} == start
    for _ in range(5):
        sg.replay()
    assert graph.replays == 5
    got = {f: f.launches - start[f] for f in counted}
    assert got[dec.decode_attention] == 140 and got[dec.paged_decode_attention_int8] == 15
    assert all(v == 0 for f, v in got.items() if f not in (dec.decode_attention, dec.paged_decode_attention_int8))
    for f, v in start.items():
        f.launches = v


def test_sample_categorical_draws_multinomials_tokens():
    """The graph-capturable race gives ``torch.multinomial``'s tokens and
    leaves the generator in the same state."""
    probs = torch.softmax(torch.randn((5, 40), generator=torch.Generator().manual_seed(0)) * 2, dim=-1)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for _ in range(10):
        assert torch.equal(sample_categorical(probs, g1), torch.multinomial(probs, 1, generator=g2)[:, 0])
    assert torch.equal(g1.get_state(), g2.get_state())
