"""The port's model against the JAX package's, on the same weights
(``params_from_jax`` of a JAX init) and the same numpy inputs, in float32:
logits, values and the branch hidden states of a full pass, the hydra
branch replay through the fused head, and prefill followed by cache decode
steps. Four layouts: GPT-J-style (interleaved rotary, parallel residual,
untied head with bias), GPT-2-style (learned positions, fused qkv, tied
head), NeoX-style (half-split rotary, two LNs in the parallel block) and
GPT-Neo-style (alternating global and local attention layers with a window
shorter than the sequence, unscaled scores).

Only mask-1 positions are compared: a left-pad query row has every key
masked, and what it attends to differs between attention paths.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.heads import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.models.heads import extract_branch_params as jax_extract_branch_params
from trlx_tpu.models.lm import LMConfig as JaxLMConfig
from trlx_tpu.models.lm import init_cache as jax_init_cache
from trlx_tpu_torch.models.heads import LMWithValueHead, extract_branch_params
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.models.lm import LMConfig, init_cache

# Tiny shapes: one intra-op thread, so torch's thread pool does not compete
# with the other test files' workers for the cores.
torch.set_num_threads(1)

# float32 on both sides; differences are summation order only.
TOL = dict(rtol=2e-4, atol=2e-4)

FAMILIES = {
    "gptj": dict(
        vocab_size=61, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
        parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
        activation="gelu_new", extra={"lm_head_bias": True},
    ),
    "gpt2": dict(
        vocab_size=61, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="learned",
        parallel_residual=False, fused_qkv=True, qkv_bias=True, tie_word_embeddings=True, activation="gelu_new",
    ),
    "neox": dict(
        vocab_size=61, n_layer=2, n_head=4, d_model=32, d_ff=48, max_position=64, pos_type="rotary", rotary_dim=4,
        parallel_residual=True, use_parallel_ln=True, fused_qkv=True, qkv_bias=True, tie_word_embeddings=False,
        activation="gelu", extra={"neox_rotary": True},
    ),
    # GPT-Neo: learned positions, sequential residual, q/k/v without bias,
    # tied head, no 1/sqrt(head_dim) scaling, global and local layers in
    # turn; the window (5) is shorter than the 12-token prompt plus 5 steps.
    "neo": dict(
        vocab_size=61, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="learned",
        parallel_residual=False, fused_qkv=False, qkv_bias=False, out_bias=True, scale_attn=False,
        attention_layers=("global", "local", "global"), window_size=5, tie_word_embeddings=True,
        activation="gelu_new",
    ),
}


def _arch(family, **over):
    arch = dict(FAMILIES[family], dtype="float32", param_dtype="float32")
    arch["extra"] = dict(arch.get("extra", {}), **over.pop("extra", {}))
    arch.update(over)
    return arch


@functools.lru_cache(maxsize=None)
def _params(family):
    """One JAX init per family: routing options and the branch point do not
    change the parameter tree."""
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(_arch(family)), branch_layer=-1)
    ids0 = jnp.ones((1, 8), dtype=jnp.int32)
    return jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(3), ids0, jnp.ones_like(ids0))["params"])


def _pair(family, branch_layer, **over):
    arch = _arch(family, **over)
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(arch), branch_layer=branch_layer)
    params = _params(family)
    tmodel = LMWithValueHead(LMConfig.from_dict(arch), branch_layer=branch_layer, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tmodel))
    tmodel.requires_grad_(False)
    return jmodel, params, tmodel


def _inputs(seed, b=2, T=24, V=61, pads=(0, 7)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, size=(b, T)).astype(np.int32)
    mask = np.ones((b, T), dtype=np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
        ids[i, :p] = 0
    return ids, mask


@pytest.mark.parametrize("family", list(FAMILIES))
def test_full_pass_logits_values_branch_hidden(family):
    jmodel, params, tmodel = _pair(family, branch_layer=1)
    ids, mask = _inputs(0)
    ref = jax.jit(lambda i, m: jmodel.apply({"params": params}, i, m, collect_branch_hidden=True))(
        jnp.asarray(ids), jnp.asarray(mask))
    got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask), collect_branch_hidden=True)
    rows = mask.astype(bool)
    for key in ("logits", "values", "branch_hidden"):
        np.testing.assert_allclose(got[key].numpy()[rows], np.asarray(ref[key])[rows], **TOL, err_msg=key)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flash_path_matches(family):
    """attn_impl="flash": the JAX Pallas kernel (interpret mode) against the
    port's flash wrapper, which takes its plain version on the CPU."""
    jmodel, params, tmodel = _pair(family, branch_layer=-1, attn_impl="flash")
    ids, mask = _inputs(1, T=32)
    ref = jax.jit(lambda i, m: jmodel.apply({"params": params}, i, m))(jnp.asarray(ids), jnp.asarray(mask))
    got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    rows = mask.astype(bool)
    np.testing.assert_allclose(got["logits"].numpy()[rows], np.asarray(ref["logits"])[rows], **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_branch_fused_head_logprobs(family):
    """The hydra replay from the branch point with the frozen branch copy,
    its head forced onto the fused-logprob path (the Pallas kernel in
    interpret mode; the port's plain version), from logits_start = P - 1."""
    jmodel, params, tmodel = _pair(family, branch_layer=1, extra={"fused_logprob": "force"})
    ids, mask = _inputs(2)
    P = 10
    labels, lmask = ids[:, P:], mask[:, P:]
    jextras = jax.device_get(jax_extract_branch_params(params, jmodel.cfg, 1))

    @jax.jit
    def ref_fn(i, m, y, ym):
        bh = jmodel.apply({"params": params}, i, m, collect_branch_hidden=True)["branch_hidden"]
        return jmodel.apply({"params": jextras}, bh, m, method="forward_branch", logits_start=P - 1, labels=y,
                            labels_mask=ym)

    ref = ref_fn(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels), jnp.asarray(lmask))
    textras = params_from_jax(jextras, tmodel)
    assert sorted(textras) == sorted(extract_branch_params(tmodel, 1))
    tbh = tmodel(torch.from_numpy(ids), torch.from_numpy(mask), collect_branch_hidden=True)["branch_hidden"]
    got = tmodel.forward_branch(tbh, torch.from_numpy(mask), logits_start=P - 1, labels=torch.from_numpy(labels),
                                labels_mask=torch.from_numpy(lmask), params=textras)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.all(got.numpy()[lmask == 0] == 0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_then_cache_decode_steps(family):
    """Left-padded prefill at cache index 0, then single-token steps that
    write the cache before they read it."""
    jmodel, params, tmodel = _pair(family, branch_layer=-1)
    ids, pmask = _inputs(3, T=12, pads=(3, 0))
    B, P = ids.shape
    n_steps = 5
    T = P + n_steps
    rng = np.random.default_rng(4)
    steps = rng.integers(1, 61, size=(n_steps, B)).astype(np.int32)
    cmask = np.concatenate([pmask, np.zeros((B, n_steps), dtype=np.int32)], axis=1)

    jcache = jax_init_cache(jmodel.cfg, B, T)
    tcache = init_cache(tmodel.cfg, B, T, "cpu")
    # One jitted JAX step program for every decode step (a traced
    # cache_index, as the JAX sampler runs it); prefill keeps the static 0.
    jstep = jax.jit(lambda c, tok, i, m: jmodel.apply({"params": params}, tok, jnp.ones_like(tok), cache=c,
                                                      cache_index=i, cache_mask=m))
    jprefill = jax.jit(lambda c, i, m, cm: jmodel.apply({"params": params}, i, m, cache=c, cache_index=0,
                                                        cache_mask=cm))
    jout = jprefill(jcache, jnp.asarray(ids), jnp.asarray(pmask), jnp.asarray(cmask))
    tout = tmodel(torch.from_numpy(ids), torch.from_numpy(pmask), cache=tcache, cache_index=0,
                  cache_mask=torch.from_numpy(cmask))
    np.testing.assert_allclose(tout["logits"].numpy()[:, -1], np.asarray(jout["logits"])[:, -1], **TOL)
    jcache, tcache = jout["cache"], tout["cache"]
    for s in range(n_steps):
        cmask[:, P + s] = 1
        tok = steps[s][:, None]
        jout = jstep(jcache, jnp.asarray(tok), jnp.int32(P + s), jnp.asarray(cmask))
        tout = tmodel(torch.from_numpy(tok), torch.ones((B, 1), dtype=torch.int32), cache=tcache,
                      cache_index=P + s, cache_mask=torch.from_numpy(cmask))
        jcache, tcache = jout["cache"], tout["cache"]
        np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), **TOL, err_msg=f"step {s}")
        np.testing.assert_allclose(tout["values"].numpy(), np.asarray(jout["values"]), **TOL)
    for (tk, tv), (jk, jv) in zip(tcache, jcache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
