"""W8A16 decode weights in the port against the JAX package's QDense with
the ``qw`` collection (twins of ``tests/test_weight_quant.py``).

- ``quantize_weights`` gives the same int8 codes and f32 scales as the JAX
  package's on the same f32 weights, bit for bit (the same division and
  round-half-to-even).
- ``w8a16_plain`` equals QDense with ``qw`` on the same inputs: exactly in
  float32 up to the sum's order (1e-6 relative), and in bfloat16 within one
  bf16 ulp of each output (the two frameworks may round one f32 sum
  differently).
- Whole models: the port's logits inside ``decode_weights`` against the
  JAX model applied with ``qw`` (float32 within 1e-4, bfloat16 within 2e-2
  of max |logit|: bf16 rounding differs by an ulp and compounds over two
  layers), near-lossless against full precision (< 5%), and greedy decode
  with int8 weights token for token equal to the JAX package's.
- The trainer: W8 refused without the fused statistics (unless the engine
  is on), re-quantized in place by the next rollout phase, the fused reference's
  quantization bias bounded, and the learning gate (marked slow, like its
  JAX twin).
- A model of the W8 kernel's tile walk (``csrc/w8a16_gemm.cu``): the tile
  sizes read from the source, the K splits of ``ops.w8a16.plan``, the
  interleaved column map of the four m16n8 tiles and the masked edges, at
  N = 50400 and M not a multiple of 16, against ``w8a16_plain``.
"""

import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.models import TransformerLM as JaxTransformerLM  # noqa: E402
from trlx_tpu.models.lm import LMConfig as JaxLMConfig  # noqa: E402
from trlx_tpu.models.lm import QDense  # noqa: E402
from trlx_tpu.models.lm import quantize_weights as jax_quantize_weights  # noqa: E402
from trlx_tpu.ops.generate import make_generate_fn as jax_make_generate_fn  # noqa: E402
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.models.hf_import import params_from_jax  # noqa: E402
from trlx_tpu_torch.models.lm import LMConfig, TransformerLM, decode_weights  # noqa: E402
from trlx_tpu_torch.ops import w8a16  # noqa: E402
from trlx_tpu_torch.ops.generate import make_generate_fn  # noqa: E402
from trlx_tpu_torch.ops.sampling import GenerateConfig  # noqa: E402
from trlx_tpu_torch.ops.w8a16 import quantize_weights, quantized_weights, w8a16_plain  # noqa: E402
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: E402

torch.set_num_threads(1)

ARCH = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_position=64, pos_type="rotary", rotary_dim=8,
            parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
            activation="gelu_new", extra={"lm_head_bias": True})
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "trlx_tpu_torch", "csrc")


def _models(dtype: str):
    """(JAX module, JAX params, the port's module on the same weights) of the
    JAX test's tiny GPT-J-style trunk (a biased LM head, so the epilogue's
    bias is held too)."""
    arch = dict(ARCH, dtype=dtype)
    jmodel = JaxTransformerLM(JaxLMConfig.from_dict(arch))
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 97, size=(2, 12)))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"])
    model = TransformerLM(LMConfig.from_dict(arch), device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    model.requires_grad_(False)
    return jmodel, params, model, np.asarray(ids)


def _port_config(tmp_path, **model):
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.checkpoint_dir = str(tmp_path)
    config.train.batch_size = 16
    config.method.chunk_size = 16
    config.model.decode_weight_quant = True
    for k, v in model.items():
        setattr(config.model, k, v)
    return config


# ------------------------------------------------------------------ quantizer


def test_quantize_weights_bit_equal_to_jax():
    """Every quantized kernel's codes and scales equal the JAX package's
    bit for bit, with the same structure: the trunk's products and the
    untied LM head, never the embeddings or the norms."""
    _, params, model, _ = _models("float32")
    assert quantize_weights(model) == 2 * 6 + 1
    ours = quantized_weights(model)
    theirs = jax.device_get(jax_quantize_weights(params))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if "kernel_q" in v:
                flat[prefix + k] = v
            else:
                walk(v, prefix + k + ".")

    walk(theirs, "")
    assert set(ours) == set(flat)
    assert "lm_head" in ours and not any(k.startswith(("wte", "ln_f")) for k in ours)
    for name, (kq, scale) in ours.items():
        assert kq.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(kq.numpy(), np.asarray(flat[name]["kernel_q"]), err_msg=name)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(flat[name]["scale"]), err_msg=name)
    assert ours["h_0.mlp.c_fc"][1].shape == (4 * 64,)
    assert quantize_weights(model) == 0  # nothing changed: nothing re-quantized


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_w8a16_plain_matches_qdense(dtype, bias):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.125).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    layer = QDense(48, dtype=jdt, use_bias=bias)
    kq, scale = w8a16.quantize_channels(torch.from_numpy(w))
    variables = {"params": {"kernel": w, **({"bias": b} if bias else {})},
                 "qw": {"kernel_q": kq.numpy(), "scale": scale.numpy()}}
    ref = np.asarray(layer.apply(variables, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = w8a16_plain(torch.from_numpy(x).to(tdt), kq, scale, torch.from_numpy(b) if bias else None).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:  # one bf16 ulp of each output
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)


# -------------------------------------------------------------- whole models


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_logits_match_jax_and_stay_close(dtype):
    """The port's logits with int8 decode weights against the JAX model's
    with ``qw``; the int8 path really ran; near-lossless against full
    precision; outside ``decode_weights`` the model is unchanged."""
    jmodel, params, model, ids = _models(dtype)
    quantize_weights(model)
    qw = jax_quantize_weights(params)
    jq = np.asarray(jmodel.apply({"params": params, "qw": qw}, ids, jnp.ones_like(ids))["logits"], np.float32)
    t_ids = torch.from_numpy(ids)
    with torch.no_grad():
        full = model(t_ids, torch.ones_like(t_ids))["logits"].float().numpy()
        with decode_weights(model):
            quant = model(t_ids, torch.ones_like(t_ids))["logits"].float().numpy()
        again = model(t_ids, torch.ones_like(t_ids))["logits"].float().numpy()
    np.testing.assert_array_equal(full, again)
    assert not np.array_equal(full, quant)
    denom = np.abs(jq).max()
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.abs(quant - jq).max() / denom < tol, (np.abs(quant - jq).max(), denom)
    assert np.abs(quant - full).max() / np.abs(full).max() < 0.05


def test_w8_greedy_decode_matches_jax():
    """Greedy decode with int8 decode weights (prefill and every step) equals
    the JAX sampler applied with ``qw``, token for token (float32)."""
    jmodel, params, model, ids = _models("float32")
    quantize_weights(model)
    gkw = dict(max_new_tokens=8, do_sample=False, pad_token_id=0)
    mask = np.ones_like(ids)
    mask[0, :3] = 0
    jt, _ = jax_make_generate_fn(jmodel, JaxGenerateConfig(**gkw))(
        {"params": params, "qw": jax_quantize_weights(params)}, jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(0))
    tt, _ = make_generate_fn(model, GenerateConfig(**gkw))(ids, mask, None)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    full, _ = make_generate_fn(model, GenerateConfig(**gkw))(ids, mask, None)
    assert all(not getattr(m, "w8_on", False) for m in model.modules())  # detached after the call
    assert full.shape == tt.shape


# --------------------------------------------------------------- the trainer


def test_w8_refused_without_fused_path(tmp_path):
    """decode_weight_quant without the fused statistics (fully unfrozen, no
    hydra branch) is refused; the engine path is exempt."""
    config = _port_config(tmp_path, num_layers_unfrozen=-1)
    with pytest.raises(ValueError, match="fused"):
        PPOTrainer(config, device="cpu")
    config.method.rollout_engine = True
    assert PPOTrainer(config, device="cpu").decode_weight_quant


def test_w8_requantizes_after_policy_update(tmp_path):
    """The int8 copies follow the live policy: after train steps and the
    next rollout phase (whose sampler re-quantizes stale copies before its
    call), a trained layer's codes differ from the initial ones, in the same
    buffers, and a frozen layer's do not."""
    walks, logit_mask, metric_fn, reward_fn = generate_random_walks(15, 8, 60, seed=1000)
    config = _port_config(tmp_path, num_layers_unfrozen=1)
    config.train.total_steps, config.train.epochs, config.train.eval_interval = 6, 2, 100
    config.method.num_rollouts = 16
    seen = {}
    orig = PPOTrainer.post_epoch_callback

    def spy(self):
        if not seen:  # the codes the first rollout phase decoded with
            seen.update({k: (v[0].data_ptr(), v[0].clone()) for k, v in quantized_weights(self.model).items()})
        orig(self)

    PPOTrainer.post_epoch_callback = spy
    try:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=[[int(np.random.default_rng(i).integers(1, 15))]
                                                                      for i in range(32)],
                                       eval_prompts=[[1]], metric_fn=metric_fn, config=config, logit_mask=logit_mask,
                                       device="cpu")
    finally:
        PPOTrainer.post_epoch_callback = orig
    assert seen, "no second rollout phase ran"
    qw = quantized_weights(trainer.model)
    assert qw["transformer.h_1.mlp.c_fc"][0].data_ptr() == seen["transformer.h_1.mlp.c_fc"][0]
    assert not torch.equal(qw["transformer.h_1.mlp.c_fc"][0], seen["transformer.h_1.mlp.c_fc"][1])
    assert torch.equal(qw["transformer.h_0.mlp.c_fc"][0], seen["transformer.h_0.mlp.c_fc"][1])


def test_w8_ref_branch_bias_bounded(tmp_path):
    """The fused scorer replays the frozen branch from hidden states the
    int8 trunk produced, so its reference logprobs carry a small bias
    against a full-precision reference forward on the same tokens: < 0.05."""
    trainer = PPOTrainer(_port_config(tmp_path, num_layers_unfrozen=1), device="cpu")
    assert trainer.decode_weight_quant and trainer.fused_rollout
    B, P = 16, trainer.prompt_length
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 15, size=(B, P)).astype(np.int32)
    tokens, mask, stats, prefill = trainer.rollout_generate_fused(prompts, np.ones((B, P), np.int32))
    scores = rng.normal(size=(B,)).astype(np.float32)
    lp_f, _, _, kl_f = trainer.rollout_score_fused(tokens, mask, scores, (stats, prefill))
    lp_u, _, _, kl_u = trainer.rollout_score(tokens, mask, scores)
    rmask = mask[:, P:].bool()
    delta = ((lp_f - kl_f) - (lp_u - kl_u)).abs()[rmask]
    assert 0 < delta.max() < 0.05, delta.max()


@pytest.mark.slow
def test_w8_decode_learning_gate(tmp_path):
    """Learning gate with W8A16 decode on (and fused stats and an int8 KV
    cache): randomwalks still reaches >= 0.8 optimality."""
    n_nodes, max_length = 21, 10
    walks, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=n_nodes, max_length=max_length)
    jcfg = base_config("ppo", n_nodes, max_length)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps, config.train.eval_interval = 48, 16
    config.train.checkpoint_interval, config.train.checkpoint_dir = 10**6, str(tmp_path)
    config.train.batch_size = 48
    config.model.num_layers_unfrozen = 1
    config.model.kv_cache_quant = True
    config.model.decode_weight_quant = True
    config.method.num_rollouts, config.method.chunk_size = 96, 48
    history = []

    def gated_metric(samples):
        m = metric_fn(samples)
        history.append(float(np.mean(m["optimality"])))
        return m

    prompts = [[int(np.random.default_rng(i).integers(1, n_nodes))] for i in range(96)]
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[i] for i in range(1, n_nodes)],
                                   metric_fn=gated_metric, config=config, logit_mask=logit_mask, device="cpu")
    assert trainer.decode_weight_quant
    assert history and max(history) >= 0.8, f"W8-decode optimality history: {history}"


# ------------------------------------------------------ the kernel's tile walk


def _source_constants():
    src = open(os.path.join(CSRC, "w8a16_gemm.cu")).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    tilings = [tuple(int(a) for a in m) for m in re.findall(r"launch<(\d+), (\d+)>\(p, s\)", src)]
    return const, tilings


def _kernel_walk(x, kq, scale, bias, bm, warps_m, splits, per, const):
    """The kernel's arithmetic in its own order of tiles: grid (n tiles, m
    tiles, splits), each CTA over its BK chunks, four warps along N of 32
    columns, each warp's four m16n8 tiles interleaved (tile u, fragment
    column j is physical column 4j + u), zero-filled loads past M, N and K,
    partials summed in split order, then the epilogue; stores past M and N
    dropped. Returns y and the count of stores to each output."""
    BN, BK = const["BN"], const["BK"]
    M, K = x.shape
    N = kq.shape[1]
    kchunks = -(-K // BK)
    mt = bm // warps_m // 16
    part = torch.zeros((splits, M, N), dtype=torch.float64)
    written = torch.zeros((M, N), dtype=torch.int64)
    xf, wf = x.double(), kq.double()
    for z in range(splits):
        k0, k1 = z * per * BK, min(kchunks, (z + 1) * per) * BK
        for nt in range(-(-N // BN)):
            for mtile in range(-(-M // bm)):
                for warp in range(warps_m * 4):
                    wn, wm = warp % 4, warp // 4
                    for i in range(mt):
                        for h in range(2):
                            for g in range(8):
                                m = mtile * bm + wm * mt * 16 + i * 16 + g + 8 * h
                                if m >= M:
                                    continue
                                for t in range(4):
                                    for j in range(2):
                                        for u in range(4):
                                            n = nt * BN + wn * 32 + 4 * (2 * t + j) + u
                                            if n >= N:
                                                continue
                                            kk = slice(k0, min(k1, K))
                                            part[z, m, n] = (xf[m, kk] * wf[kk, n]).sum()
                                            written[m, n] += 1
    acc = part.sum(0).float()
    dt = x.dtype
    y = acc.to(dt) * scale.to(dt)
    if bias is not None:
        y = y + bias.to(dt)
    return y, written


def test_w8a16_kernel_tile_walk_matches_plain():
    """Both tilings of the source at M = 13 (decode; K split at N = 4096)
    and M = 40 (BM = 128), N = 50400 (a partial last column tile of 96) and
    K = 200 (a partial last BK chunk): every output stored once a split,
    and the walk's result equals ``w8a16_plain``. Each case walks the last
    full column tile and the one after it, with the launch's plan at the
    full N."""
    const, tilings = _source_constants()
    assert (const["BN"], const["BK"]) == (w8a16.BN, w8a16.BK)
    assert {bm for bm, _ in tilings} == {w8a16.BM_DECODE, w8a16.BM_LARGE}
    warps = dict(tilings)
    rng = np.random.default_rng(2)
    for M, N in ((13, 50400), (13, 4096), (40, 50400)):
        K = 200
        bm, splits, per = w8a16.plan(M, N, K, sms=132)
        assert bm == (w8a16.BM_DECODE if M <= w8a16.DECODE_MAX_M else w8a16.BM_LARGE)
        assert (splits - 1) * per < -(-K // const["BK"]) <= splits * per
        lo = (N // const["BN"]) * const["BN"] - const["BN"]  # the last full tile and the partial one
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
        kq = torch.from_numpy(rng.integers(-127, 128, size=(K, N - lo)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, size=(N - lo,)).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=(N - lo,)).astype(np.float32))
        y, written = _kernel_walk(x, kq, scale, bias, bm, warps[bm], splits, per, const)
        assert (written == splits).all()  # one store a split (a partial when K is split)
        np.testing.assert_allclose(y.numpy(), w8a16_plain(x, kq, scale, bias).numpy(), rtol=1e-5, atol=1e-5)


def test_w8a16_plan_splits_small_m_to_fill_the_card():
    """Decode shapes of GPT-J-6B get at least two CTAs a SM where K allows;
    prefill shapes are not split."""
    sms = 132
    for K, N in ((4096, 4096), (4096, 16384), (16384, 4096), (4096, 50400)):
        bm, splits, per = w8a16.plan(8, N, K, sms)
        ctas = -(-N // w8a16.BN) * splits
        assert bm == w8a16.BM_DECODE and ctas >= 2 * sms and splits * per >= K // w8a16.BK
    assert w8a16.plan(6144, 16384, 4096, sms)[1:] == (1, 4096 // w8a16.BK)
