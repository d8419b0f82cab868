"""GPT-NeoX-20B's layout at head_dim 96 (fault C8): the port against the JAX
package on the CPU.

NeoX-20B has d_model 6144 over 64 heads, so head_dim 96: the JAX package
sends its long full-sequence passes and prefills to the Pallas flash kernel
(``auto_flash_ok`` has no head-dim condition), and the port's routing copies
that rule, so its kernels must take d = 96 (``KERNEL_HEAD_DIMS``). Here a
small model with that layout (2 layers, 2 heads x 96 = d_model 192,
rotary_dim 24 with ``neox_rotary``, fused qkv in the port's q|k|v blocks,
parallel residual with two LayerNorms, untied head, T = 256) runs with
``attn_impl="flash"``: the JAX Pallas kernel in interpret mode, the port's
plain versions of rows 1-3 (its wrappers on CPU tensors), on the same
weights (``params_from_jax``) and numpy inputs from a seed.

Tolerances, all float32 on both sides where only the summation order
differs: flash forward and backward within 1e-5 (rtol 1e-4 on dq / dk /
dv, whose values reach ~10); the model's logits and values within 2e-4 (as
``tests/test_torch_model.py`` holds every layout); one PPO step's loss
within 1e-5 and its gradients within 1e-4 of each leaf's max; the reward
model's scores within 1e-5 (as ``tests/test_torch_reward_model.py``).

Also a static pin for C8: for every shipped recipe's model and every
``hf_import`` preset, each head_dim that ``flash_eligible`` can send to the
kernels is in ``KERNEL_HEAD_DIMS``, and the C entries are instantiated for
exactly those and refuse every other d.
"""

import functools
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from trlx_tpu.data import PPORLBatch as JaxPPORLBatch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.models.heads import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.models.lm import LMConfig as JaxLMConfig
from trlx_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import HF_CONFIG_DEFAULTS, lm_config_from_hf, params_from_jax
from trlx_tpu_torch.models.lm import LMConfig, flash_eligible
from trlx_tpu_torch.ops import cuda_lib
from trlx_tpu_torch.ops import flash_attention as flash_mod
from trlx_tpu_torch.trainer.ppo import PPOTrainer, reward_model_scores

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, T, P = 101, 256, 192  # vocabulary, sequence, prompt width (64 new tokens)
HEAD_DIM = 96
# NeoX-20B's layout at 2 layers, 2 heads: d_model 192, d_ff 4 x 192,
# rotary over a quarter of each head (24 of 96, rotary_pct 0.25).
ARCH = dict(vocab_size=V, n_layer=2, n_head=2, d_model=2 * HEAD_DIM, d_ff=8 * HEAD_DIM, max_position=T,
            pos_type="rotary", rotary_dim=24, parallel_residual=True, use_parallel_ln=True, fused_qkv=True,
            qkv_bias=True, tie_word_embeddings=False, activation="gelu", extra={"neox_rotary": True},
            attn_impl="flash", dtype="float32", param_dtype="float32")
FLASH_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------ the kernels' function


def _flash_inputs(seed, pads):
    """[2, 256, 2, 96] float32 q/k/v, a key mask with ``pads[i]`` left-padded
    slots in row i, and cotangents that vanish on the padded rows (no later
    position reads them in the model)."""
    rng = np.random.default_rng(seed)
    shape = (len(pads), T, 2, HEAD_DIM)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = np.ones(shape[:2], np.float32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0.0
    rows = mask.astype(bool)
    do = (rng.normal(size=shape) * rows[:, :, None, None]).astype(np.float32)
    dlse = (rng.normal(size=(shape[0], shape[2], T)) * rows[:, None, :]).astype(np.float32)
    return q, k, v, mask, do, dlse


@pytest.mark.parametrize("window,pads", [(0, (0, 0)), (0, (0, 77)), (48, (0, 130))],
                         ids=["causal", "left-padded", "window48"])
def test_flash_at_head_dim_96_matches_pallas(window, pads):
    """Rows 1-3 at [2, 256, 2, 96]: the port's flash forward (o, lse) and,
    through ``FlashAttentionFn``, dq / dk / dv against the Pallas kernel
    (interpret mode, blocks of 128, so it walks and skips tiles) and its
    VJP, on every row with a valid key (dk / dv on every row)."""
    q, k, v, mask, do, dlse = _flash_inputs(96 + window + pads[1], pads)
    scale = HEAD_DIM ** -0.5

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, jnp.asarray(mask), scale=scale, causal=True, window=window,
                                   block_q=128, block_k=128, interpret=True, return_lse=True)

    (jo, jlse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = (np.asarray(x) for x in vjp((jnp.asarray(do), jnp.asarray(dlse))))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = flash_mod.flash_attention(tq, tk, tv, torch.from_numpy(mask), scale=scale, window=window,
                                       return_lse=True)
    dq, dk, dv = torch.autograd.grad((o, lse), (tq, tk, tv), (torch.from_numpy(do), torch.from_numpy(dlse)))
    rows = mask.astype(bool)
    np.testing.assert_allclose(o.detach().numpy()[rows], np.asarray(jo)[rows], **FLASH_TOL)
    np.testing.assert_allclose(lse.detach().numpy().transpose(0, 2, 1)[rows],
                               np.asarray(jlse).transpose(0, 2, 1)[rows], **FLASH_TOL)
    np.testing.assert_allclose(dq.numpy()[rows], jdq[rows], **GRAD_TOL)
    np.testing.assert_allclose(dk.numpy(), jdk, **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), jdv, **GRAD_TOL)


# ------------------------------------------------------------ the model


@functools.lru_cache(maxsize=None)
def _jax_params():
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(ARCH), branch_layer=-1)
    ids0 = jnp.ones((1, 8), dtype=jnp.int32)
    return jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(7), ids0, jnp.ones_like(ids0))["params"])


def _tokens(seed, b=2, pads=(0, 70)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, size=(b, T)).astype(np.int32)
    mask = np.ones((b, T), dtype=np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
        ids[i, :p] = 0
    return ids, mask


def test_model_logits_and_values_match_jax():
    """A full pass on the flash route (T = 256 takes it in both packages):
    logits and values on every valid position."""
    params = _jax_params()
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(ARCH), branch_layer=-1)
    tmodel = LMWithValueHead(LMConfig.from_dict(ARCH), branch_layer=-1, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tmodel))
    tmodel.requires_grad_(False)
    assert tmodel.cfg.head_dim == HEAD_DIM and flash_eligible(tmodel.cfg, T, False, False, False)
    ids, mask = _tokens(0)
    ref = jax.jit(lambda i, m: jmodel.apply({"params": params}, i, m))(jnp.asarray(ids), jnp.asarray(mask))
    got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    rows = mask.astype(bool)
    for key in ("logits", "values"):
        np.testing.assert_allclose(got[key].numpy()[rows], np.asarray(ref[key])[rows], **MODEL_TOL, err_msg=key)


def _config(tmp_path, **model):
    """ppo_neox20b_rm_config.yml's method and optimizer values (read from the
    port's copy) at the small NeoX layout: 1 unfrozen layer of 2, the
    recipe's sampling, T = 256 from 192-token prompts, batch 8 on a data
    parallel mesh (the JAX package's CPU devices; one process here)."""
    with open(os.path.join(ROOT, "trlx_tpu_torch", "configs", "ppo_neox20b_rm_config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(model_path="", tokenizer_path="", reward_model_path="", num_layers_unfrozen=1,
                        model_arch=dict(ARCH), dtype="float32", **model)
    cfg["train"].update(seq_length=T, batch_size=8, total_steps=1, mesh=[-1, 1, 1, 1], resume_from_checkpoint=False,
                        checkpoint_dir=str(tmp_path))
    cfg["method"].update(num_rollouts=8, chunk_size=8)
    cfg["method"]["gen_kwargs"].update(prompt_length=P, max_length=T, min_length=T)
    return cfg


def _trainers(cfg):
    """The JAX trainer and the port's on the JAX trainer's weights (policy,
    hydra extras and, where the config has one, the reward model)."""
    jm = JaxPPOTrainer(JaxTRLConfig.from_dict(cfg))
    tm = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    tm.load_params(params_from_jax(jax.device_get(jm.state.params), tm.model),
                   params_from_jax(jax.device_get(jm.state.extras), tm.model))
    if tm.rm_model is not None:
        with torch.no_grad():
            for n, p in params_from_jax(jax.device_get(jm.rm_params), tm.rm_model).items():
                dict(tm.rm_model.named_parameters())[n].copy_(p)
    return jm, tm


def _ppo_batch(seed):
    rng = np.random.default_rng(seed)
    ids, mask = _tokens(seed)
    R = T - P
    cols = dict(query_tensors=ids[:, :P], response_tensors=ids[:, P:], query_mask=mask[:, :P],
                response_mask=mask[:, P:].astype(np.float32),
                logprobs=(rng.normal(size=(2, R)) * 0.3 - 4.6).astype(np.float32),
                values=rng.normal(size=(2, R)).astype(np.float32),
                rewards=(rng.normal(size=(2, R)) * 0.1).astype(np.float32))
    return cols


def test_ppo_step_loss_and_grads_match_jax(tmp_path):
    """One PPO step's loss, statistics and the gradients of every trainable
    leaf (the top block, ln_f, the head, the value head), from the same
    weights and batch: the JAX step's loss function under ``jax.value_and_grad``
    against the port's ``_loss_fn`` and autograd, both through rows 1-3's
    function at d = 96."""
    jm, tm = _trainers(_config(tmp_path))
    cols = _ppo_batch(3)
    jm.build_train_step()
    jb = JaxPPORLBatch(**{k: jnp.asarray(v) for k, v in cols.items()})
    (jloss, jstats), jgrads = jax.value_and_grad(jm._numerics_loss_fn, has_aux=True)(jm.state.params, jb)
    tm.build_train_step()
    tb = PPORLBatch(**{k: torch.from_numpy(v) for k, v in cols.items()})
    loss, stats = tm._loss_fn(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    for key in ("pg_loss", "vf_loss"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]), rtol=1e-5, atol=1e-5, err_msg=key)
    want = params_from_jax(jax.device_get(jgrads), tm.model)
    trainable = [(n, p) for n, p in tm.model.named_parameters() if p.requires_grad]
    assert any(n.startswith("transformer.h_1.attn.c_qkv") for n, _ in trainable)
    for name, p in trainable:
        ref = want[name].numpy()
        scale = float(np.abs(ref).max()) + 1e-12
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy() / scale, ref / scale, **GRAD_TOL, err_msg=name)


def test_reward_model_scores_match_jax(tmp_path):
    """The on-device reward model with NeoX-20B's layout (its own 2-layer
    trunk and scalar head), scored at T = 256 on the flash route in both
    packages: the port's ``reward_model_scores`` against the JAX trainer's
    ``_rm_scores``, an all-padding row scoring 0."""
    jm, tm = _trainers(_config(tmp_path, reward_model_arch=dict(ARCH)))
    assert tm.rm_model.cfg.head_dim == HEAD_DIM
    ids, mask = _tokens(5, b=3, pads=(0, 70, T))
    want = np.asarray(jm._rm_scores(jm.rm_params, ids, mask))
    got = reward_model_scores(tm.rm_model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[-1] == 0.0 and np.all(got[:-1] != 0.0)


# ------------------------------------------------------------ the static pin


# The published checkpoints the shipped recipes name, by HF model type: the
# config class defaults of hf_import are those checkpoints' config.json
# (gpt2: gpt2 and its fine-tunes; gptj: EleutherAI/gpt-j-6B; gpt_neox:
# EleutherAI/gpt-neox-20b; gpt_neo: EleutherAI/gpt-neo-1.3B).
RECIPE_MODELS = {"gpt2": "gpt2", "lvwerra/gpt2-imdb": "gpt2", "EleutherAI/gpt-j-6B": "gptj",
                 "EleutherAI/gpt-neox-20b": "gpt_neox"}


def _preset_config(model_type):
    return lm_config_from_hf(SimpleNamespace(model_type=model_type, **HF_CONFIG_DEFAULTS[model_type]))


def _recipes():
    out = {}
    for name in sorted(os.listdir(os.path.join(ROOT, "trlx_tpu_torch", "configs"))):
        cfg = TRLConfig.load_yaml(os.path.join(ROOT, "trlx_tpu_torch", "configs", name))
        out[name] = cfg
    return out


@pytest.mark.parametrize("source", sorted(HF_CONFIG_DEFAULTS) + ["recipes"])
def test_every_flash_routed_head_dim_has_a_kernel(source):
    """C8's pin: for each ``hf_import`` preset, and for each shipped recipe's
    model (and reward model) at its own sequence and prompt lengths, every
    head_dim that ``flash_eligible`` sends to the flash kernels on a CUDA
    device, at any length it admits (auto: T >= 256 with T % 128 == 0;
    prefill at cache index 0 too), is one the kernels take."""
    if source == "recipes":
        cases = []
        for name, cfg in _recipes().items():
            paths = [cfg.model.model_path] + ([cfg.model.reward_model_path] if cfg.model.reward_model_path else [])
            for path in paths:
                lm = _preset_config(RECIPE_MODELS[path])
                prompt = (getattr(cfg.method, "gen_kwargs", None) or {}).get("prompt_length")  # ILQL has none
                lengths = {cfg.train.seq_length} | ({prompt} if prompt else set())
                cases += [(f"{name}:{path}", lm, n) for n in lengths]
        assert {c[0].split(":")[1] for c in cases} == set(RECIPE_MODELS)
    else:
        lm = _preset_config(source)
        cases = [(source, lm, n) for n in range(1, 4097)]
    routed = set()
    for label, lm, n in cases:
        for has_cache, prefill_at_zero in ((False, False), (True, True)):
            if flash_eligible(lm, n, has_cache, prefill_at_zero, True):
                routed.add(lm.head_dim)
                assert lm.head_dim in flash_mod.KERNEL_HEAD_DIMS, (label, n, lm.head_dim)
    if source == "gpt_neox":
        assert routed == {HEAD_DIM}
    if source == "recipes":  # ppo_long's 4096 and 3072 reach the kernels at GPT-J's 256
        assert routed == {256}


def test_c_entries_take_exactly_the_kernel_head_dims():
    """The C side of ``KERNEL_HEAD_DIMS``: ``flash_head_dim_ok`` (the check
    every entry of rows 1-3 makes first) names exactly those dims, and each
    entry's dispatch instantiates a template for each and returns an error
    for any other d."""
    with open(os.path.join(cuda_lib._CSRC, "common.cuh")) as f:
        ok = re.search(r"bool flash_head_dim_ok\(int d\) \{ return ([^;]+); \}", f.read()).group(1)
    assert sorted(int(x) for x in re.findall(r"d == (\d+)", ok)) == list(flash_mod.KERNEL_HEAD_DIMS)
    assert ok.count("||") == len(flash_mod.KERNEL_HEAD_DIMS) - 1 and "&&" not in ok
    entries = 0
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        with open(os.path.join(cuda_lib._CSRC, src)) as f:
            text = f.read()
        for body in re.findall(r'extern "C" int \w+\(.*?\n\}', text, flags=re.S):
            entries += 1
            assert "if (!flash_head_dim_ok(d)) return (int)cudaErrorInvalidValue;" in body
            switch = body[body.index("switch (d)"):]
            pairs = re.findall(r"case (\d+): return \(int\)launch\w*<(\d+)>", switch)
            assert [int(a) for a, _ in pairs] == list(flash_mod.KERNEL_HEAD_DIMS)
            assert all(a == b for a, b in pairs)
            assert "default: return (int)cudaErrorInvalidValue;" in switch
    assert entries == 3
