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
  sizes, tilings, A-fragment load table and epilogue column order read from
  the source; the persistent grid (grouped row tiles) and the K-split
  cluster launch of ``ops.w8a16.plan``, split partials summed in rank order,
  the masked edges at N = 50400, K = 200 and M not a multiple of the tile,
  against ``w8a16_plain``; and ``plan``'s even share of weight bytes per SM
  at GPT-J-6B's decode shapes.
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

GPTJ_DECODE_KN = ((4096, 4096), (4096, 16384), (16384, 4096), (4096, 50400))
# Clusters of s CTAs that an H100 SXM (132 SMs) runs at once for every swap
# tiling, as the card's cudaOccupancyMaxActiveClusters reports them
# (``w8a16_max_clusters``; the ``[clusters]`` line of ``probe_w8a16.py``):
# its GPCs hold whole clusters, so 30 of 4, not 132 // 4 = 33.
H100_SMS = 132
H100_CLUSTERS = {(c, s): n for c in (64, 128) for s, n in {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}.items()}
# (M, K, N): ragged decode and small-M shapes at N = 4096 and at
# N = 50400 (a partial last column tile of 96), K = 200 (a partial last chunk),
# and a walk of 14 row tiles (a full group of GROUP_ROWS and a partial one)
# on the wide kernel's persistent grid, with 154 tiles for 132 CTAs; then
# K = 4096 at M = 8 and 40 (narrow tiles split 2 ways; 128-column tiles on a
# persistent grid at N = 50400).
WALK_CASES = ([(m, 200, n) for m in (13, 40, 200) for n in (4096, 50400)] + [(3333, 200, 1296)]
              + [(8, 4096, 4096), (40, 4096, 1040)])


def _source_constants():
    """The tile constants, the launched tilings (bx, cols, wgs, kwg: x rows
    a tile, weight columns a tile, column warpgroups (2: the wide kernel), K
    lanes), the A-fragment load table and the epilogue's column order (for
    column c0 + c of a pair, the A tile and accumulator offset), read from
    the source."""
    src = open(os.path.join(CSRC, "w8a16_gemm.cu")).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for k, v in re.findall(r"constexpr int ((?:WIDE_)?\w+) = (\d+), ", src):  # WIDE_BX = 256, WIDE_STAGES = 5
        const[k] = int(v)
    const.update({k: int(v) for k, v in re.findall(r", (WIDE_\w+) = (\d+)", src)})
    tilings = {(int(bx), const[cols], 1, int(kwg)) for bx, kwg, cols in
               re.findall(r"launch_swap<(\d+), (\d+), (WG_COLS|NARROW_COLS)>\(tx, tw, p, grid, s\)", src)}
    if "if (wgs == 2) return launch_wide(tx, tw, p, grid, s);" in src:
        tilings.add((const["WIDE_BX"], const["WG_COLS"], 2, 1))
    # a[u][i] = i8_pair_bf16<byte>(w[lo], w[hi]): register i of A tile u
    # holds byte `byte` of the words w[lo] (low half) and w[hi]; tile 1 only
    # where a warpgroup has two (NA == 2).
    load = {(int(u), int(i)): (int(b), int(lo), int(hi)) for u, i, b, lo, hi in
            re.findall(r"a\[(\d)\]\[(\d)\] = i8_pair_bf16<(\d)>\(w\[(\d)\], w\[(\d)\]\);", src)}
    assert src.index("if constexpr (NA == 2) {") < src.index("a[1][0] = i8_pair_bf16")
    assert "const int r = 16 * kk + 2 * t + (i & 1) + 8 * (i >> 1);" in src  # word i's K row
    # the swizzles: 128-byte rows, chunk ^ (r % 8); 64-byte rows, chunk ^ (r / 2 % 4)
    assert "const int sw = PITCH == 128 ? r : r >> 1;" in src
    assert "box + r * PITCH + ((((c0 >> 4) ^ sw) & (PITCH / 16 - 1)) << 4) + (c0 & 15)" in src
    assert "const int c0 = WC / 4 * ((threadIdx.x / 32) & 3) + 2 * NA * g;" in src
    assert "load_a<C::NA, WC>(box, kk, c0, t, a[kk]);" in src  # a swap tile's rows are WC bytes
    # The 2 NA columns c0 .. of x row 8 j + 2 t + q take, pair element e of A
    # tile u, acc[u][4 j + off_e + q] (row_sums), and K lane 1's sums come
    # back into them in the same order.
    sums = re.findall(r"v\[2 \* u( \+ 1)?\] = acc\[u\]\[4 \* j \+ (?:(\d) \+ )?q\];", src)
    offs = {int(e == " + 1"): int(off or 0) for e, off in sums}
    assert len(sums) == 2 and set(offs) == {0, 1}, sums
    back = {int(e == " + 1"): int(off or 0) for off, e in
            re.findall(r"acc\[u\]\[4 \* j \+ (?:(\d) \+ )?q\] \+= v\[2 \* u( \+ 1)?\];", src)}
    assert back == offs
    assert src.count("row_sums(acc, j, q, v);") == 3  # K lane 1's store, the epilogue, the split partial
    assert "const int n = ct * WC + c0;" in src
    # The wide kernel: warpgroup wg's one A tile (load_a<1, WG_COLS>: tile 0's
    # table), fragment rows g and g + 8 of warp w are columns c0 and c0 + 1;
    # x row 8 j + 2 t + q takes acc[4 j + q], acc[4 j + 2 + q].
    assert "const int n = ct * WG_COLS + c0;" in src
    assert "const int c0 = 64 * wg + 16 * ((threadIdx.x / 32) & 3) + 2 * g;" in src
    assert "load_a<1, WG_COLS>(box, kk, c0, t, a[kk]);" in src
    assert "const float v[2] = {acc[4 * j + q], acc[4 * j + 2 + q]};" in src
    return const, tilings, load, offs


def _store(offs, na):
    """(A tile, accumulator offset) of column c0 + c, c < 2 na."""
    return [(c // 2, offs[c % 2]) for c in range(2 * na)]


def _column_map(load, na):
    """col[u][r]: the column of a swap tile (of 64 na columns) that row r of
    A tile u holds, from the load table and wgmma's A-fragment layout
    (register i of lane 4 g + t of warp w: row 16 w + g + 8 (i & 1), K 2 t +
    8 (i >> 1) and + 1; a thread's first column 16 na w + 2 na g), checking
    that the K rows the loads read are the fragment's K."""
    col = -np.ones((na, 64), np.int64)
    for (u, i), (byte, lo, hi) in load.items():
        if u >= na:
            continue
        # word l of the load is K row 2 t + (l & 1) + 8 (l >> 1)
        assert (lo & 1, lo >> 1) == (0, i >> 1) and hi == lo + 1, (u, i, lo, hi)
        assert byte < 2 * na  # a load holds 2 na columns
        for w in range(4):
            for g in range(8):
                r, c = 16 * w + g + 8 * (i & 1), 16 * na * w + 2 * na * g + byte
                assert col[u, r] in (-1, c), (u, r, col[u, r], c)
                col[u, r] = c
    return col


def _tile_at(tile, row_tiles, col_tiles, group):
    per_group = group * col_tiles
    grp, r = divmod(tile, per_group)
    rows = min(group, row_tiles - grp * group)
    return grp * group + r % rows, r // rows


def _kernel_walk(x, kq, scale, bias, plan, const, tilings, load, offs):
    """The kernel's arithmetic in its own walk: the CTAs of the grid (x
    splits) over their tiles and K chunks, chunk i of a CTA's range taken by
    K lane i % kwg, each consumer warpgroup's A tiles built from the load
    table, each thread's accumulators read through wgmma's layout and
    stored through the epilogue's column order; the K lanes' sums added in
    lane order, split partials summed by the rank that owns their quads in
    rank order. Returns y, the stores to each output, the (tile, chunk)
    coverage and the order of each output's parts, as (rank, lane)."""
    bx, cols, wgs, splits, grid = plan
    kwg = {t[:3]: t[3] for t in tilings}[bx, cols, wgs]
    if wgs == 2:
        return _wide_walk(x, kq, scale, bias, plan, const)
    BK, na = const["BK"], cols // 64
    M, K = x.shape
    N = kq.shape[1]
    kchunks = -(-K // BK)
    row_tiles, col_tiles = -(-M // bx), -(-N // cols)
    tiles = row_tiles * col_tiles
    xp = np.zeros((row_tiles * bx, kchunks * BK))  # TMA's zero fill past M and K
    xp[:M, :K] = x.double().numpy()
    wp = np.zeros((kchunks * BK, col_tiles * cols))  # and past N
    wp[:K, :N] = kq.double().numpy()
    col = _column_map(load, na)
    store = _store(offs, na)
    W, G, T = (a.reshape(-1) for a in np.meshgrid(np.arange(4), np.arange(8), np.arange(4), indexing="ij"))
    J, Q, C = np.arange(bx // 8), np.arange(2), np.arange(2 * na)
    # [thread, j, q, c]: x row, accumulator row of A tile u, output column
    xrow = 8 * J[None, :, None, None] + 2 * T[:, None, None, None] + Q[None, None, :, None]
    u = np.array([store[c][0] for c in C])[None, None, None, :]
    arow = 16 * W[:, None, None, None] + G[:, None, None, None] + 8 * (np.array([store[c][1] for c in C]) // 2)
    ocol = (16 * na * W + 2 * na * G)[:, None, None, None] + C[None, None, None, :]
    xrow, u, arow, ocol = np.broadcast_arrays(xrow, u, arow, ocol)
    acc = np.zeros((M, N))
    stores = np.zeros((M, N), np.int64)
    covered = np.zeros((row_tiles, col_tiles, kchunks), np.int64)
    partials, order = {}, {}
    for cta in range(grid):
        for rank in range(splits):
            kc0, kc1 = rank * kchunks // splits, (rank + 1) * kchunks // splits
            for tile in range(cta, tiles, grid):
                rt, ct = _tile_at(tile, row_tiles, col_tiles, const["GROUP_ROWS"])
                covered[rt, ct, kc0:kc1] += 1
                xt = xp[rt * bx:(rt + 1) * bx]
                n0 = ct * cols
                out = np.zeros((bx, cols))
                for lane in range(kwg):
                    ks = np.concatenate([np.arange(kc * BK, (kc + 1) * BK) for kc in range(kc0 + lane, kc1, kwg)]
                                        + [np.zeros(0, np.int64)])
                    # D_u[r, n] = sum_k A_u[r, k] B[k, n]: A_u row r = weight column col[u, r], B = x^T
                    wk, xk = wp[ks, n0:n0 + cols], xt[:, ks]
                    d = np.stack([wk[:, col[uu]].T @ xk.T for uu in range(na)])
                    out[xrow, ocol] += d[u, arow, xrow]  # lane 0's sums, then lane 1's
                if splits == 1:
                    m, n = rt * bx + xrow, n0 + ocol
                    ok = (m < M) & (n < N)
                    acc[m[ok], n[ok]] = out[xrow[ok], ocol[ok]]
                    np.add.at(stores, (m[ok], n[ok]), 1)
                    order[tile, rank] = [(rank, lane) for lane in range(kwg)]
                else:
                    partials[tile, rank] = out
    if splits > 1:
        quads = bx * cols // 4
        for tile in range(tiles):
            rt, ct = _tile_at(tile, row_tiles, col_tiles, const["GROUP_ROWS"])
            for rank in range(splits):  # the owner of quads [rank U / S, (rank + 1) U / S)
                qd = np.arange(rank * quads // splits, (rank + 1) * quads // splits)
                row, cq = np.repeat(qd // (cols // 4), 4), (qd % (cols // 4))[:, None] * 4 + np.arange(4)[None, :]
                cq = cq.reshape(-1)
                total = partials[tile, 0][row, cq].copy()
                adds = [(0, lane) for lane in range(kwg)]
                for r in range(1, splits):
                    total += partials[tile, r][row, cq]
                    adds += [(r, lane) for lane in range(kwg)]
                m, n = rt * bx + row, ct * cols + cq
                ok = (m < M) & (n < N)
                acc[m[ok], n[ok]] = total[ok]
                np.add.at(stores, (m[ok], n[ok]), 1)
                order[tile, rank] = adds
    dt = x.dtype
    y = torch.from_numpy(acc).to(dt) * scale.to(dt)
    if bias is not None:
        y = y + bias.to(dt)
    return y, stores, covered, order


def _wide_walk(x, kq, scale, bias, plan, const):
    """The wide kernel's walk: CTAs over their tiles of WIDE_BX x rows x 128
    columns and every K chunk; warpgroup wg's A tile row 16 w + g + 8 h is
    column 64 wg + 16 w + 2 g + h, its accumulator 4 j + 2 h + e (x row 8 j +
    2 t + e) stored to that column."""
    bx, cols, wgs, splits, grid = plan
    BK, WG = const["BK"], const["WG_COLS"]
    assert cols == WG
    M, K = x.shape
    N = kq.shape[1]
    kchunks = -(-K // BK)
    row_tiles, col_tiles = -(-M // bx), -(-N // WG)
    xp = np.zeros((row_tiles * bx, kchunks * BK))
    xp[:M, :K] = x.double().numpy()
    wp = np.zeros((kchunks * BK, col_tiles * WG))
    wp[:K, :N] = kq.double().numpy()
    CW, W, G, T, H, J, Q = np.meshgrid(np.arange(2), np.arange(4), np.arange(8), np.arange(4), np.arange(2),
                                       np.arange(bx // 8), np.arange(2), indexing="ij")
    arow = 64 * CW + 16 * W + G + 8 * H  # the tile's A row (both warpgroups' tiles stacked)
    col = 64 * CW + 16 * W + 2 * G + H  # its column
    xrow = 8 * J + 2 * T + Q
    cw, w, g, h = (v.reshape(-1) for v in np.meshgrid(np.arange(2), np.arange(4), np.arange(8), np.arange(2),
                                                      indexing="ij"))
    arow_u, col_u = 64 * cw + 16 * w + g + 8 * h, 64 * cw + 16 * w + 2 * g + h
    assert sorted(arow_u) == list(range(128)) and sorted(col_u) == list(range(128))
    acc = np.zeros((M, N))
    stores = np.zeros((M, N), np.int64)
    covered = np.zeros((row_tiles, col_tiles, kchunks), np.int64)
    order = {}
    for cta in range(grid):
        for tile in range(cta, row_tiles * col_tiles, grid):
            rt, ct = _tile_at(tile, row_tiles, col_tiles, const["GROUP_ROWS"])
            covered[rt, ct, :] += 1
            a = np.zeros((128, kchunks * BK))
            a[arow_u] = wp[:, ct * WG + col_u].T  # A row r holds its column's weights
            d = a @ xp[rt * bx:(rt + 1) * bx].T  # D[A row, x row]
            m, n = rt * bx + xrow, ct * WG + col
            ok = (m < M) & (n < N)
            acc[m[ok], n[ok]] = d[arow[ok], xrow[ok]]
            np.add.at(stores, (m[ok], n[ok]), 1)
            order[tile, 0] = [(0, 0)]
    dt = x.dtype
    y = torch.from_numpy(acc).to(dt) * scale.to(dt)
    if bias is not None:
        y = y + bias.to(dt)
    return y, stores, covered, order


def _walk_inputs(M, K, N, seed):
    # x in eighths: every product and every partial sum is exact in f32, so
    # the walk's result equals the plain version's whatever the sum's order.
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.integers(-64, 65, size=(M, K)) / 8).astype(np.float32))
    kq = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, size=(N,)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    return x, kq, scale, bias


def _check_walk(M, K, N, seed):
    const, tilings, load, offs = _source_constants()
    plan = w8a16.plan(M, N, K, H100_SMS, H100_CLUSTERS)
    assert plan[:3] in {t[:3] for t in tilings}, (plan, tilings)
    x, kq, scale, bias = _walk_inputs(M, K, N, seed)
    y, stores, covered, order = _kernel_walk(x, kq, scale, bias, plan, const, tilings, load, offs)
    kwg = {t[:3]: t[3] for t in tilings}[plan[:3]]
    assert (covered == 1).all()  # every (output tile, K chunk) once
    assert (stores == 1).all()  # every output stored once, by one CTA
    # parts added K lane by K lane, split by split, in rank order
    want = [(r, lane) for r in range(plan[3]) for lane in range(kwg)]
    assert all(adds == (want if plan[3] > 1 else want[:kwg]) for adds in order.values())
    np.testing.assert_array_equal(y.numpy(), w8a16_plain(x, kq, scale, bias).numpy())
    return plan


def test_w8a16_kernel_tile_walk_matches_plain():
    """The tile constants and tilings of the source match ``ops.w8a16``;
    at M = 13, 40 and 200, N = 4096 and 50400 (a partial last column tile)
    and K = 200 (a partial last chunk), the walk of the launch ``plan``
    chooses on an H100 covers every (output tile, K chunk) once, stores every
    output once, sums split partials in rank order, and equals
    ``w8a16_plain``. Narrow and 128-column tiles, the K-split cluster launch
    and the persistent grid are all walked."""
    const, tilings, _, _ = _source_constants()
    assert (const["BK"], const["WG_COLS"], const["NARROW_COLS"], const["MAX_SPLITS"]) == (
        w8a16.BK, w8a16.WG_COLS, w8a16.NARROW_COLS, w8a16.SPLITS[-1])
    swap = {t[:2] for t in tilings if t[2] == 1}
    assert swap == {(bx, c) for bx in w8a16.BX_SIZES for c in w8a16.tile_cols(bx)}, swap
    assert (w8a16.WIDE_BX, w8a16.WG_COLS, 2, 1) in tilings
    assert all(kwg == (2 if bx <= 64 else 1) for bx, _, _, kwg in tilings)  # K lanes where M <= 64
    assert const["WIDE_BX"] == w8a16.WIDE_BX
    plans = [_check_walk(M, K, N, seed=2) for M, K, N in WALK_CASES[:6]]
    assert any(p[3] > 1 for p in plans) and any(p[3] == 1 and p[4] < -(-50400 // 128) for p in plans)
    assert {p[1] for p in plans} == {64, 128}


@pytest.mark.parametrize("M,K,N", WALK_CASES, ids=[f"M{m}-K{k}-N{n}" for m, k, n in WALK_CASES])
def test_w8a16_walk_case_matches_plain(M, K, N):
    """One case of the walk above on its own (the seventh is the wide
    kernel's grouped persistent walk over 14 row tiles)."""
    plan = _check_walk(M, K, N, seed=M + N)
    if M > 1000:
        assert plan == (w8a16.WIDE_BX, w8a16.WG_COLS, 2, 1, H100_SMS)


@pytest.mark.parametrize("na,pitch", [(2, 128), (1, 64), (1, 128)], ids=["swap128", "swap64", "wide"])
def test_w8a16_fragment_maps_from_source(na, pitch):
    """The load table of the source gives every row of a warpgroup's A
    tiles a column, each of its 64 na columns once; a thread's 2 na columns
    are neighbours (one load a K row); each load of a warp (fixed kk and
    word) hits distinct banks (or one word for two lanes) of the swizzled
    int8 box, of 128-byte rows (a 128-column tile, and the wide kernel's
    warpgroups at columns 64 wg ..) or 64-byte rows (a narrow tile); and the
    epilogue's column order reads, for column c0 + c, the accumulator whose
    A-tile row holds that column."""
    _, _, load, offs = _source_constants()
    assert len(load) == 8
    col = _column_map(load, na)
    store = _store(offs, na)
    assert sorted(col.reshape(-1).tolist()) == list(range(64 * na))
    for w in range(4):
        for g in range(8):
            c0 = 16 * na * w + 2 * na * g
            held = {int(col[u, 16 * w + g + 8 * h]) for u in range(na) for h in range(2)}
            assert held == set(range(c0, c0 + 2 * na))
            for c, (u, off) in enumerate(store):
                assert col[u, 16 * w + g + 8 * (off // 2)] == c0 + c
    for base in ((0, 64) if pitch == 128 and na == 1 else (0,)):  # the wide kernel's two warpgroups
        for w in range(4):
            for kk in range(4):
                for i in range(4):
                    words = set()
                    for g in range(8):
                        for t in range(4):
                            r, c0 = 16 * kk + 2 * t + (i & 1) + 8 * (i >> 1), base + 16 * na * w + 2 * na * g
                            sw = r if pitch == 128 else r >> 1
                            words.add((r * pitch + ((((c0 >> 4) ^ sw) & (pitch // 16 - 1)) << 4) + (c0 & 15)) // 4)
                    assert len({wd % 32 for wd in words}) == len(words) == 32 * na // 2, (w, kk, i, words)


def _sm_bytes(M, K, N, sms, clusters):
    """(the most weight bytes an SM streams, the even share) under ``plan``:
    CTA (tile walk, split) reads its tiles' columns over its K chunks, and
    the CTAs spread over the SMs so that none holds more than ceil(ctas /
    sms) of them (the most loaded take the largest)."""
    bx, cols, wgs, splits, grid = w8a16.plan(M, N, K, sms, clusters)
    kchunks = -(-K // w8a16.BK)
    tiles = -(-M // bx) * -(-N // cols)
    per_cta = []
    for cta in range(grid):
        for rank in range(splits):
            k0, k1 = rank * kchunks // splits * w8a16.BK, min(K, (rank + 1) * kchunks // splits * w8a16.BK)
            per_cta.append(sum(max(0, k1 - k0) * min(cols, N - (t % -(-N // cols)) * cols)
                               for t in range(cta, tiles, grid)))
    per_cta.sort(reverse=True)
    return sum(per_cta[:-(-len(per_cta) // sms)]), K * N / sms


@pytest.mark.parametrize("K,N", GPTJ_DECODE_KN, ids=[f"{k}x{n}" for k, n in GPTJ_DECODE_KN])
def test_w8a16_plan_even_weight_bytes_per_sm(K, N):
    """At GPT-J-6B's decode shapes (M = 8) on an H100 (132 SMs and the
    clusters its GPCs hold) ``plan`` gives the busiest SM at most 5% more
    weight bytes than an even share (the parent's fixed two CTAs an SM gave
    one SM 25% more at 4096 x 4096; 128-column tiles alone, 40%), in one
    launch whose clusters all run at once."""
    most, even = _sm_bytes(8, K, N, H100_SMS, H100_CLUSTERS)
    bx, cols, wgs, splits, grid = w8a16.plan(8, N, K, H100_SMS, H100_CLUSTERS)
    assert (bx, wgs) == (w8a16.BX_SIZES[0], 1) and splits in w8a16.SPLITS
    assert splits == 1 or grid <= H100_CLUSTERS[cols, splits]
    assert most <= 1.05 * even, (most, even)


def test_w8a16_plan_splits_small_m_to_fill_the_card():
    """On an H100, decode shapes of GPT-J-6B whose 128-column tiles leave SMs
    idle (4096 x 4096 and 16384 x 4096: 32 tiles, and only 30 clusters of 4
    fit) take 64 narrow tiles split 2 ways, 128 CTAs; those whose tiles fill
    the card (4096 x 16384: 128 tiles; lm_head: 394 tiles on a persistent
    grid of 132) are not split; prefill shapes are not split and run two
    warpgroups on a persistent grid of one CTA an SM."""
    sms, card = H100_SMS, H100_CLUSTERS
    assert w8a16.plan(8, 4096, 4096, sms, card) == (8, 64, 1, 2, 64)
    assert w8a16.plan(8, 4096, 16384, sms, card) == (8, 64, 1, 2, 64)
    assert w8a16.plan(8, 16384, 4096, sms, card) == (8, 128, 1, 1, 128)
    assert w8a16.plan(8, 50400, 4096, sms, card) == (8, 128, 1, 1, sms)
    for N, K in ((16384, 4096), (4096, 4096), (4096, 16384)):
        assert w8a16.plan(6144, N, K, sms, card) == (w8a16.WIDE_BX, w8a16.WG_COLS, 2, 1, sms)


def test_w8a16_plan_follows_the_cards_clusters():
    """``plan`` reads the card's cluster counts: where every cluster of 4 of
    the 32 tiles at 4096 x 4096 would fit at once (33 of 4 on 132 SMs), the
    128-column tiles split 4 ways stream the same bytes an SM as narrow tiles
    split 2 ways, and the wider tile wins the tie."""
    fits_all = {(c, s): H100_SMS // s for c in (64, 128) for s in range(2, 9)}
    assert w8a16.plan(8, 4096, 4096, H100_SMS, fits_all) == (8, 128, 1, 4, 32)
    assert w8a16.plan(8, 4096, 4096, H100_SMS, H100_CLUSTERS) == (8, 64, 1, 2, 64)
