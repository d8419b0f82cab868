#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``trlx_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``trlx_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main paths
give it, then drives

1. the PPO experience phase (PPOTrainer → PromptPipeline →
   PPOOrchestrator.make_experience) at GPT-J-6B width;
2. a gradient-consistency check at GPT-J-6B width and 4 layers: one PPO
   batch's gradients on the kernel route against the plain route;
3. the training path, ``trlx_tpu_torch.train(reward_fn=...)``, at GPT-J-6B
   full width and depth (random weights): 16 PPO steps with a second
   ``make_experience`` in between and a final ``evaluate()``;

and checks that each path went through every kernel it runs, exactly as
often as its config says.

    python3 chip_smoke.py

Exits non-zero, printing no result, when no CUDA device is visible or any
phase fails. Output, in order: one line per phase; the device's name and
power limit as ``nvidia-smi`` reports them; one JSON line of per-kernel
numbers; and last, one JSON line ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

# H100 SXM published dense peaks (NVIDIA data sheet): bf16 tensor cores and
# HBM3 bandwidth. Bounds below are the larger of bytes / BW and ops / peak.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

# GPT-J-6B (EleutherAI/gpt-j-6B config.json), full width and depth.
GPTJ_6B_ARCH = dict(
    vocab_size=50400, n_layer=28, n_head=16, d_model=4096, d_ff=16384, max_position=2048, pos_type="rotary",
    rotary_dim=64, parallel_residual=True, use_parallel_ln=False, fused_qkv=False, qkv_bias=False,
    out_bias=False, tie_word_embeddings=False, activation="gelu_new", ln_eps=1e-5, extra={"lm_head_bias": True},
    eos_token_id=50256,
)
PROMPT_LEN, MAX_LEN = 768, 1024
MIN_PROMPT = 600  # prompts have seeded lengths in [MIN_PROMPT, PROMPT_LEN]
CHUNK, N_ROLLOUTS = 8, 16
LOGPROB_BWD_SEED = 5
ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "ckpts", "chip_smoke")  # metrics.jsonl of each path (gitignored)


def log(msg: str):
    print(msg, flush=True)


def free():
    """Release a finished path's device memory: a trainer and its
    orchestrator refer to each other, so only the cycle collector frees
    them, at a time that depends on the allocations before."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, by CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profiled_kernel_ms(fn, groups, iters: int = 5):
    """Mean device milliseconds per ``fn()`` call spent in each group of
    kernels (substrings of the kernel names), from torch.profiler's CUDA
    kernel times after one warm-up call. Raises when a group shows none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for group, names in groups.items():
        us = sum(e.self_device_time_total for e in events if any(n in e.key for n in names))
        if not us > 0:
            raise AssertionError(f"the profile shows no device time in {names}")
        out[group] = us / 1e3 / iters
    return out


def check(name: str, got, ref, tol: float) -> float:
    """Max abs difference of ``got`` vs ``ref`` (f32); raise above ``tol``
    or on any non-finite value."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - ref).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} > tol {tol:.1e}")
    return err


def check_rel(name: str, got, ref, rel: float):
    """``check`` with the tolerance ``rel`` times max |ref| (outputs whose
    scale depends on the shape). Returns (max_abs_err, tol)."""
    tol = rel * float(ref.float().abs().max())
    return check(name, got, ref, tol), tol


def phase_flash(gen, T: int, ragged: bool):
    """Flash attention forward at [8, T, 16, 256] bf16, causal; with
    ``ragged`` the rows are left-padded to seeded prompt lengths."""
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    b, h, d = 8, 16, 256
    dev = "cuda"
    q, k, v = (torch.randn((b, T, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    if ragged:
        lens = torch.randint(MIN_PROMPT, T + 1, (b,), generator=gen, device=dev)
        mask = (torch.arange(T, device=dev)[None, :] >= (T - lens)[:, None]).float()
    scale = d ** -0.5
    out = flash_attention(q, k, v, mask, scale=scale)
    ref = flash_attention_plain(q, k, v, mask, scale=scale)
    rows = mask.bool()  # query rows with a valid own key; pad rows differ by design
    # bf16 output (ulp 2^-8 near 1) and bf16 P in the P.V product on both
    # sides; summation order differs (64-key tiles vs one einsum).
    tol = 2e-2
    err = check(f"flash[T={T}]", out[rows], ref[rows], tol)
    ms = time_ms(lambda: flash_attention(q, k, v, mask, scale=scale))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, mask, scale=scale), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    amask = causal[None, None] & mask.bool()[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=scale))
    nbytes = 4 * b * T * h * d * 2 + b * h * T * 4 + b * T * 4  # q k v o, lse, key mask
    flops = 4 * d * b * h * T * (T + 1) / 2  # QK^T and PV over the causal pairs
    bound_ms, by = bound(nbytes, flops)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, shape=[b, T, h, d])


def phase_decode(gen):
    """Decode attention: q [8, 16, 256] over a bf16 cache of T = 1024 at
    decode step 128 after a 768-wide left-padded prompt; the bias row masks
    the left padding and the unwritten tail."""
    from trlx_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

    B, T, h, d = 8, MAX_LEN, 16, 256
    dev = "cuda"
    q = torch.randn((B, h, d), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((B, T, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    lens = torch.randint(MIN_PROMPT, PROMPT_LEN + 1, (B,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    valid = (pos >= (PROMPT_LEN - lens)[:, None]) & (pos <= PROMPT_LEN + 128)
    bias = torch.where(valid, 0.0, -1e9).float()
    scale = d ** -0.5
    out = decode_attention(q, kc, vc, bias, scale=scale)
    ref = decode_attention_plain(q, kc, vc, bias, scale=scale)
    tol = 1e-2  # bf16 output; f32 softmax on both sides, other summation order
    err = check("decode", out, ref, tol)
    ms = time_ms(lambda: decode_attention(q, kc, vc, bias, scale=scale), iters=50)
    plain_ms = time_ms(lambda: decode_attention_plain(q, kc, vc, bias, scale=scale), iters=10)
    q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    b4 = bias[:, None, None, :].to(torch.bfloat16)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=b4, scale=scale), iters=50)
    live = int(valid.sum())  # keys the bias leaves visible: the K/V rows this step needs
    nbytes = 2 * live * h * d * 2 + 2 * B * h * d * 2 + B * T * 4
    flops = 4 * live * h * d
    bound_ms, by = bound(nbytes, flops)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, shape=[B, T, h, d], live_keys=live)


def phase_logprob(gen):
    """Fused logprob head: N = 2048 rows (8 x 256 responses), D = 4096,
    V = 50400, untied f32 head weight with bias, as the branch replay calls
    it."""
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob, naive_logprob

    N, D, V = CHUNK * (MAX_LEN - PROMPT_LEN), 4096, 50400
    dev = "cuda"
    x = torch.randn((N, D), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((D, V), generator=gen, device=dev) * D ** -0.5
    b = torch.randn((V,), generator=gen, device=dev) * 0.1
    y = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    got = fused_logprob(x, w, y, b)
    ref = naive_logprob(x, w, y, b)
    # The plain version rounds every logit to bf16 twice (product, then
    # bias add) and the kernel keeps them in f32; logits reach |5| here,
    # where half a bf16 ulp is 2^-6.
    tol = 5e-2
    err = max(check(f"logprob.{n}", g, r, tol) for n, g, r in zip(("lp", "lse", "ent"), got, ref))
    ms = time_ms(lambda: fused_logprob(x, w, y, b), iters=5)
    plain_ms = time_ms(lambda: naive_logprob(x, w, y, b), iters=3, warmup=1)
    nbytes = N * D * 2 + D * V * 4 + V * 4 + N * 4 + 3 * N * 4
    flops = 2 * N * D * V
    bound_ms, by = bound(nbytes, flops)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=by, shape=[N, D, V])


def phase_flash_bwd(gen):
    """Flash attention backward (dq, then dk/dv) at the train shape
    [8, 1024, 16, 256] bf16, rows left-padded to seeded prompt lengths,
    with nonzero dO and lse cotangents on the valid rows (padded rows carry
    none in the model: no later position reads them)."""
    from trlx_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
    )

    b, T, h, d = 8, MAX_LEN, 16, 256
    dev = "cuda"
    scale = d ** -0.5
    q, k, v = (torch.randn((b, T, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(MIN_PROMPT + 256, T + 1, (b,), generator=gen, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] >= (T - lens)[:, None]).float()
    rows = mask.bool()
    o, lse = flash_fwd(q, k, v, mask, scale=scale)
    do = (torch.randn((b, T, h, d), generator=gen, device=dev) * rows[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=gen, device=dev) * rows[:, None, :]
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2) - dlse).contiguous()
    dq = flash_bwd_dq(q, k, v, mask, do, lse, delta, scale=scale, window=0)
    dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, scale=scale, window=0)
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale)
    # bf16 outputs and bf16 P / dS in the products on both sides; 64-wide
    # tiles vs one einsum sum in another order.
    rel = 2e-2
    err_q, tol_q = check_rel("flash_bwd.dq", dq[rows], rq[rows], rel)
    err_k, tol_k = check_rel("flash_bwd.dk", dk, rk, rel)
    err_v, tol_v = check_rel("flash_bwd.dv", dv, rv, rel)
    del rq, rk, rv
    ms_dq = time_ms(lambda: flash_bwd_dq(q, k, v, mask, do, lse, delta, scale=scale, window=0))
    ms_dkv = time_ms(lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, scale=scale, window=0))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale),
                       iters=3, warmup=1)
    # Library yardstick: SDPA's backward with the same boolean mask (autograd
    # forward + backward less the forward), rows 2 and 3 together.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    amask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None, None] & rows[:, None, None, :]
    backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(qt, kt, vt, amask, 0.0, False,
                                                                     scale=scale)).name

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=scale).backward(dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=scale)

    lib_ms = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
    pairs = b * h * T * (T + 1) / 2
    one = b * T * h * d * 2  # one bf16 [b, T, h, d] tensor
    rowvec = b * h * T * 4
    bdq = bound(5 * one + 2 * rowvec + b * T * 4, 6 * d * pairs)
    bdkv = bound(6 * one + 2 * rowvec + b * T * 4, 8 * d * pairs)
    common = dict(plain_ms=plain_ms, library_ms=lib_ms, library=f"SDPA backward ({backend}), dq+dk+dv together",
                  shape=[b, T, h, d])
    return {
        "flash_attention_bwd_dq": dict(max_abs_err=err_q, tol=tol_q, ms=ms_dq, bound_ms=bdq[0], bound_by=bdq[1],
                                       **common),
        "flash_attention_bwd_dkv": dict(max_abs_err=max(err_k, err_v), tol=max(tol_k, tol_v), ms=ms_dkv,
                                        bound_ms=bdkv[0], bound_by=bdkv[1], **common),
    }


def check_head_grads(got, ref, labels):
    """(dx, dW, db) of the fused head against the plain backward, each
    within a share of its own max |ref|. dW and db are held apart on the
    columns some label hits and on the rest: there ds is only the softmax
    terms p·(dlse − dlp − dent·(s − E)), far smaller than the label term,
    so one tolerance over all columns would not see them. Returns
    {name: (max_abs_err, tol)}."""
    (dx, dw, db), (rdx, rdw, rdb) = got, ref
    hit = torch.zeros(rdw.shape[1], dtype=torch.bool, device=rdw.device)
    hit[labels.long()] = True
    # ds is rounded to bf16 on both sides before the products, and a sum in
    # another order can flip that rounding; dx comes back in bf16 (one ulp
    # is 2^-8 of max |dx|). db sums the f32 ds on both sides.
    out = {"dx": check_rel("logprob_bwd.dx", dx, rdx, 2e-2)}
    for part, cols in (("hit", hit), ("unhit", ~hit)):
        out[f"dw_{part}"] = check_rel(f"logprob_bwd.dw[{part}]", dw[:, cols], rdw[:, cols], 1e-2)
        out[f"db_{part}"] = check_rel(f"logprob_bwd.db[{part}]", db[cols], rdb[cols], 1e-3)
    return out


def logprob_bwd_inputs(seed: int):
    """The fused-logprob backward at the train shape: N = 2048 (8 x 256
    responses), D = 4096, V = 50400, f32 head weight with bias, all three
    cotangents nonzero, logits spread as a trained head's (std ~3.5), so
    the softmax terms of ds carry weight. Returns the wrapper's arguments."""
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_fwd

    N, D, V = CHUNK * (MAX_LEN - PROMPT_LEN), 4096, 50400
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((D, V), generator=gen, device="cuda") * (3.5 * D ** -0.5)
    b = torch.randn((V,), generator=gen, device="cuda") * 0.1
    y = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)
    _, lse, ent = fused_logprob_fwd(x, w, y, b)
    cts = [torch.randn((N,), generator=gen, device="cuda") * 0.1 for _ in range(3)]
    return (x, w, b, y, lse, ent, *cts)


def phase_logprob_bwd(seed: int):
    """The fused-logprob backward against its plain version; the whole
    call timed by CUDA events. Its rows' ``ms`` come from
    ``logprob_bwd_split`` at the end of the run."""
    from trlx_tpu_torch.ops.fused_logprob import BWD_CHUNK_ROWS, fused_logprob_bwd, fused_logprob_bwd_plain

    args = logprob_bwd_inputs(seed)
    x, w, y = args[0], args[1], args[3]
    (N, D), V = x.shape, w.shape[1]
    ref = fused_logprob_bwd_plain(*args)
    errs = check_head_grads(fused_logprob_bwd(*args), ref, y)
    del ref
    plain_ms = time_ms(lambda: fused_logprob_bwd_plain(*args), iters=3, warmup=1)
    ms_all = time_ms(lambda: fused_logprob_bwd(*args), iters=5)
    flops = 2 * N * D * V
    small = N * 4 * 6 + V * 4  # labels, lse, ent, three cotangents; bias or db
    bdx = bound(N * D * 2 + D * V * 4 + small + N * V * 2 + N * D * 2, 2 * flops)  # x, W in; ds, dx out
    bdw = bound(N * D * 2 + N * V * 2 + D * V * 4 + V * 4, flops)  # x, ds in; dW, db out
    common = dict(plain_ms=plain_ms, library_ms=None, library="none: no single PyTorch call computes it",
                  whole_backward_ms=ms_all, ms_from="profiler kernel times of one fused_logprob_bwd call",
                  shape=[N, D, V], chunks=-(-N // BWD_CHUNK_ROWS), checks=errs)
    # dW/db's row shows the partition nearest its tolerance.
    dw_err, dw_tol = max((errs[k] for k in errs if k != "dx"), key=lambda et: et[0] / et[1])
    return {
        "fused_logprob_bwd_dx": dict(max_abs_err=errs["dx"][0], tol=errs["dx"][1], bound_ms=bdx[0],
                                     bound_by=bdx[1], **common),
        "fused_logprob_bwd_dw": dict(max_abs_err=dw_err, tol=dw_tol, bound_ms=bdw[0], bound_by=bdw[1], **common),
    }


def logprob_bwd_split(seed: int):
    """Device ms of the ds + dx kernels and of the dW/db kernels inside one
    ``fused_logprob_bwd`` call, from the profiler. Run last: no profiler
    session precedes the paths."""
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd

    args = logprob_bwd_inputs(seed)
    return profiled_kernel_ms(lambda: fused_logprob_bwd(*args), {
        "fused_logprob_bwd_dx": ("logprob_ds_kernel", "logprob_dx_kernel"),
        "fused_logprob_bwd_dw": ("logprob_dw_kernel", "logprob_db_kernel")})


def smoke_config():
    """The rollout path's config: GPT-J-6B, experience only."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=2,
                      model_arch=dict(GPTJ_6B_ARCH), dtype="bfloat16", param_dtype="float32"),
        "train": dict(total_steps=1, seq_length=MAX_LEN, epochs=1, batch_size=CHUNK, lr_ramp_steps=1,
                      lr_decay_steps=1, weight_decay=1e-6, learning_rate_init=1.412e-4,
                      learning_rate_target=1.412e-4, seed=1000, checkpoint_dir=os.path.join(RUN_DIR, "rollout")),
        "method": dict(name="ppoconfig", num_rollouts=N_ROLLOUTS, chunk_size=CHUNK, init_kl_coef=0.2, target=6,
                       horizon=10000, gen_kwargs=dict(prompt_length=PROMPT_LEN, max_length=MAX_LEN,
                                                      min_length=MAX_LEN, top_k=0, top_p=0.7, temperature=0.5,
                                                      do_sample=True)),
    })


def train_config(n_layer: int, model_type: str, run_dir: str, **arch):
    """The training path's config: GPT-J-6B (depth ``n_layer``) with the
    method and optimizer values of trlx_tpu/configs/ppo_gptj_config.yml
    (remat, 2 unfrozen layers, vf_coef 0.2, betas (0.9, 0.95), lr 1.412e-4
    with a 100-step ramp, 4 PPO epochs, adaptive KL 0.2 → 6), the smoke's
    768 + 256 lengths, 16 rollouts in chunks of 8, batch 8, 2 epochs and 16
    steps."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type=model_type, num_layers_unfrozen=2,
                      model_arch=dict(GPTJ_6B_ARCH, n_layer=n_layer, **arch), dtype="bfloat16",
                      param_dtype="float32", remat=True),
        "train": dict(total_steps=16, seq_length=MAX_LEN, epochs=2, batch_size=CHUNK, lr_ramp_steps=100,
                      lr_decay_steps=79000, weight_decay=1e-6, learning_rate_init=1.412e-4,
                      learning_rate_target=1.412e-4, opt_betas=[0.9, 0.95], grad_clip=1.0,
                      checkpoint_interval=10**6, eval_interval=10**6, checkpoint_dir=run_dir, seed=1000),
        "method": dict(name="ppoconfig", num_rollouts=N_ROLLOUTS, chunk_size=CHUNK, ppo_epochs=4, init_kl_coef=0.2,
                       target=6, horizon=10000, gamma=1.0, lam=0.95, cliprange=0.2, cliprange_value=0.2,
                       vf_coef=0.2, gen_kwargs=dict(prompt_length=PROMPT_LEN, max_length=MAX_LEN,
                                                    min_length=MAX_LEN, top_k=0, top_p=0.7, temperature=0.5,
                                                    do_sample=True)),
    })


def seeded_prompts(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50400, size=int(rng.integers(MIN_PROMPT, PROMPT_LEN + 1))).tolist() for _ in range(n)]


def param_groups(model, n_layer: int):
    """Parameter name → group: wte, each unfrozen block, the LM head with its
    bias, the value head; the frozen blocks together."""
    def group(name):
        if name.startswith("transformer.wte."):
            return "wte"
        if name.startswith("transformer.lm_head."):
            return "lm_head"
        if name.startswith("v_head."):
            return "v_head"
        if name.startswith("transformer.ln_f."):
            return "ln_f"
        blk = int(name.split(".")[1][2:])
        return f"h_{blk}" if blk >= n_layer - 2 else "frozen_blocks"
    return {n: group(n) for n, _ in model.named_parameters()}


def phase_grad_consistency():
    """One PPO batch's gradients of the trainable parameters at GPT-J-6B
    width and 4 layers (2 unfrozen), on the kernel route (flash autograd
    Function, fused head) and on the plain route (einsum attention,
    materialized logits), from the same seeded weights and batch."""
    from trlx_tpu_torch.data import PPORLBatch
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    n_layer = 4
    routes = {"kernel": {}, "plain": {"attn_impl": "xla", "extra": dict(GPTJ_6B_ARCH["extra"], fused_logprob="off")}}
    out = {}
    batch = None
    for route, arch in routes.items():
        trainer = PPOTrainer(train_config(n_layer, "ppo", os.path.join(RUN_DIR, "grad_" + route), **arch))
        if batch is None:
            # A PPO batch from this policy: seeded prompts and responses, the
            # policy's own logprobs and values, KL-penalized rewards.
            pipe = PromptPipeline(seeded_prompts(CHUNK, 3), None, max_prompt_length=PROMPT_LEN)
            prompt = next(iter(pipe.create_loader(CHUNK)))
            rng = np.random.default_rng(4)
            resp = rng.integers(0, 50400, size=(CHUNK, MAX_LEN - PROMPT_LEN)).astype(np.int32)
            tokens = trainer.put(np.concatenate([prompt["input_ids"], resp], 1))
            mask = trainer.put(np.concatenate([prompt["attention_mask"], np.ones_like(resp)], 1))
            scores = rng.normal(size=(CHUNK,)).astype(np.float32)
            lp, values, rewards, _ = trainer.rollout_score(tokens, mask, scores)
            batch = PPORLBatch(query_tensors=tokens[:, :PROMPT_LEN], response_tensors=tokens[:, PROMPT_LEN:],
                               logprobs=lp.float(), values=values.float(), rewards=rewards.float(),
                               response_mask=mask[:, PROMPT_LEN:], query_mask=mask[:, :PROMPT_LEN])
        trainer.build_train_step()
        loss, _ = trainer._loss_fn(batch)
        loss.backward()
        groups = param_groups(trainer.model, n_layer)
        grads = {}
        for name, p in trainer.model.named_parameters():
            if p.requires_grad:
                grads.setdefault(groups[name], []).append(p.grad.float().reshape(-1))
        out[route] = (float(loss.detach()), {g: torch.cat(v) for g, v in grads.items()})
        del trainer, loss, grads
        free()
    (lk, gk), (lp_, gp) = out["kernel"], out["plain"]
    cos = {g: float(torch.nn.functional.cosine_similarity(gk[g].double(), gp[g].double(), dim=0)) for g in gk}
    rel_loss = abs(lk - lp_) / max(abs(lp_), 1e-12)
    res = {"loss_kernel": lk, "loss_plain": lp_, "loss_rel_diff": rel_loss, "cosine": cos}
    log(f"[grad] kernel vs plain route, GPT-J-6B width, {n_layer} layers: {json.dumps(res)}")
    if not rel_loss <= 1e-2:
        raise AssertionError(f"losses differ by {rel_loss:.3e} relative (> 1e-2)")
    low = {g: c for g, c in cos.items() if not c >= 0.99}
    if low:
        raise AssertionError(f"gradient cosine below 0.99: {low}")
    return res


def fingerprint(tensors) -> int:
    """Bit-level fingerprint: the sum of the tensors' 32-bit words (any
    changed bit moves it, barring an exact cancellation)."""
    return sum(int(t.detach().contiguous().view(torch.int32).sum(dtype=torch.int64)) for t in tensors)


def group_fingerprints(trainer, n_layer: int):
    groups = param_groups(trainer.model, n_layer)
    by = {}
    for name, p in trainer.model.named_parameters():
        by.setdefault(groups[name], []).append(p)
    fps = {g: fingerprint(ts) for g, ts in by.items()}
    fps["extras"] = fingerprint(trainer.extras.values())
    return fps


def make_timed_trainer(kernels, n_layer: int):
    """A PPOTrainer, registered under its own name and picked by the
    config's ``model_type``, that records per train step its device time
    (CUDA events), its kernel launches and its stats; parameter fingerprints
    at the start, after step 2 and at the end; and each evaluate()'s stats."""
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    @register_model("SmokeTimedPPOTrainer")
    class SmokeTimedPPOTrainer(PPOTrainer):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            self.step_log, self.eval_log = [], []
            self.fp = {"start": group_fingerprints(self, n_layer)}

        def train_step(self, batch):
            before = {n: f.launches for n, f in kernels.items()}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            stats = super().train_step(batch)
            end.record()
            torch.cuda.synchronize()
            rec = {k: float(v) for k, v in stats.items()}
            rec["device_s"] = start.elapsed_time(end) / 1e3
            rec["launches"] = {n: f.launches - before[n] for n, f in kernels.items()}
            self.step_log.append(rec)
            if self.step == 2:
                self.fp["step2"] = group_fingerprints(self, n_layer)
            return stats

        def evaluate(self):
            stats = super().evaluate()
            self.eval_log.append(stats)
            return stats

    return SmokeTimedPPOTrainer


def train_path(kernels):
    """``trlx_tpu_torch.train(reward_fn=...)`` at GPT-J-6B full width and
    depth; returns its numbers and the launches of the whole run."""
    import trlx_tpu_torch

    n_layer, k = GPTJ_6B_ARCH["n_layer"], 2
    cls = make_timed_trainer(kernels, n_layer)
    run_dir = os.path.join(RUN_DIR, "train")
    config = train_config(n_layer, cls.__name__, run_dir)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=seeded_prompts(N_ROLLOUTS, 0),
                                   eval_prompts=seeded_prompts(CHUNK, 1), config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.fp["end"] = group_fingerprints(trainer, n_layer)

    steps = config.train.total_steps
    R = MAX_LEN - PROMPT_LEN
    chunks = 2 * N_ROLLOUTS // CHUNK  # two make_experience calls
    bwd_chunks = -(-CHUNK * R // 1024)
    per_step = {"flash_attention_fwd": 2 * n_layer, "flash_attention_bwd_dq": n_layer,
                "flash_attention_bwd_dkv": n_layer, "fused_logprob_fwd": 1, "fused_logprob_bwd_dx": bwd_chunks,
                "fused_logprob_bwd_dw": bwd_chunks, "decode_attention": 0}
    expected = {
        "flash_attention_fwd": chunks * (n_layer + k) + steps * 2 * n_layer + n_layer,
        "decode_attention": (chunks + 1) * n_layer * R,
        "fused_logprob_fwd": chunks + steps,
        "flash_attention_bwd_dq": steps * n_layer, "flash_attention_bwd_dkv": steps * n_layer,
        "fused_logprob_bwd_dx": steps * bwd_chunks, "fused_logprob_bwd_dw": steps * bwd_chunks,
    }
    log(f"[train] launches {launches} expected {expected} (rollouts: {chunks} chunks x flash {n_layer + k}, "
        f"decode {n_layer}x{R}, fused logprob 1; per train step {per_step}; eval: flash {n_layer}, "
        f"decode {n_layer}x{R})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    log_ = trainer.step_log
    if len(log_) != steps or trainer.iter_count != steps:
        raise AssertionError(f"{len(log_)} train steps recorded, iter_count {trainer.iter_count}, expected {steps}")
    for i, rec in enumerate(log_):
        if rec["launches"] != per_step:
            raise AssertionError(f"step {i + 1} launched {rec['launches']}, expected {per_step}")
        bad = [k for k, v in rec.items() if k not in ("launches",) and not np.isfinite(v)]
        if bad or rec["resilience/nonfinite"] != 0.0:
            raise AssertionError(f"step {i + 1}: non-finite {bad} or a guard skip ({rec['resilience/nonfinite']})")
    # Steps 1 and 9 are the first on fresh rollouts (the second
    # make_experience ran with the updated weights), where the policy is the
    # rollout policy: the training forward must reproduce the rollout's
    # fused statistics.
    first = steps // config.train.epochs
    for i in (0, first):
        if not abs(log_[i]["mean_ratio"] - 1.0) <= 0.05:
            raise AssertionError(f"step {i + 1} mean_ratio {log_[i]['mean_ratio']} is not within 1 +- 0.05")

    fp = trainer.fp
    trained = ["wte", f"h_{n_layer - 2}", f"h_{n_layer - 1}", "lm_head", "v_head"]
    for when in ("step2", "end"):
        same = [g for g in trained if fp[when][g] == fp["start"][g]]
        if same:
            raise AssertionError(f"trainable groups {same} unchanged at {when}")
    for g in ("frozen_blocks", "extras"):
        if fp["end"][g] != fp["start"][g]:
            raise AssertionError(f"{g} changed during training")
    if len(trainer.store) != N_ROLLOUTS:
        raise AssertionError(f"store holds {len(trainer.store)} rows after the second make_experience")
    if len(trainer.eval_log) != 1 or not np.isfinite(trainer.eval_log[0]["mean_reward"]):
        raise AssertionError(f"expected one evaluate() with a finite mean_reward, got {trainer.eval_log}")

    exp = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "exp_time" in rec:
                exp.append({k: v for k, v in rec.items() if k.startswith("exp_") or k.startswith("rollout_")})
    if len(exp) != 2:
        raise AssertionError(f"expected 2 make_experience records, found {len(exp)}")
    dev_s = [r["device_s"] for r in log_]
    tokens = CHUNK * MAX_LEN
    out = {
        "wall_s": wall,
        "step_device_s": dev_s,
        "step_device_s_median": float(np.median(dev_s)),
        "train_tokens_per_s_median": tokens / float(np.median(dev_s)),
        "train_tokens_per_s_steps_2_16": tokens * (steps - 1) / float(np.sum(dev_s[1:])),
        "peak_mem_gb": peak_gb,
        "mean_ratio_per_step": [r["mean_ratio"] for r in log_],
        "mean_kl_per_step": [r["mean_kl"] for r in log_],
        "stats_step1": {k: v for k, v in log_[0].items() if k != "launches"},
        "stats_step16": {k: v for k, v in log_[-1].items() if k != "launches"},
        "kl_coef_end": float(trainer.kl_ctl.value),
        "experience": exp,
        "eval": {k: v for k, v in trainer.eval_log[0].items()},
        "launches": launches,
    }
    log(f"[train] trlx_tpu_torch.train at GPT-J-6B ({n_layer} layers), {steps} steps: {json.dumps(out)}")
    del trainer
    free()
    return out, launches


def reward_fn(samples):
    """A cheap host reward of the tokens: the share of even token ids."""
    return [float(np.mean(np.asarray(s) % 2 == 0)) for s in samples]


def main_path(kernels):
    """The PPO experience phase at GPT-J-6B width (the rollout path);
    returns its numbers."""
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    config = smoke_config()
    t0 = time.perf_counter()
    trainer = PPOTrainer(config)
    torch.cuda.synchronize()
    log(f"[main] PPOTrainer built in {time.perf_counter() - t0:.1f}s: {config.model.model_arch['n_layer']} layers, "
        f"branch at layer {trainer.model.branch_layer}, fused rollout {trainer.fused_rollout}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50400, size=int(rng.integers(MIN_PROMPT, PROMPT_LEN + 1))).tolist()
               for _ in range(N_ROLLOUTS)]
    pipeline = PromptPipeline(prompts, None, max_prompt_length=trainer.prompt_length)
    orch = PPOOrchestrator(trainer, pipeline, reward_fn=reward_fn, chunk_size=config.method.chunk_size)

    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = orch.make_experience(config.method.num_rollouts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_chunks = N_ROLLOUTS // CHUNK
    n_layer, k = GPTJ_6B_ARCH["n_layer"], config.model.num_layers_unfrozen
    steps = MAX_LEN - PROMPT_LEN
    expected = {name: 0 for name in kernels}  # no backward kernel runs on the rollout path
    expected.update({"flash_attention_fwd": n_chunks * (n_layer + k), "decode_attention": n_chunks * n_layer * steps,
                     "fused_logprob_fwd": n_chunks})
    log(f"[main] launches {launches} expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")

    cols = trainer.store.columns()
    if len(trainer.store) != N_ROLLOUTS:
        raise AssertionError(f"store holds {len(trainer.store)} rows, expected {N_ROLLOUTS}")
    for key in ("logprobs", "values", "rewards"):
        if cols[key].shape != (N_ROLLOUTS, steps) or not np.isfinite(cols[key]).all():
            raise AssertionError(f"store {key}: shape {cols[key].shape} or non-finite values")
    if not (cols["response_mask"] == 1).all():
        raise AssertionError("min_length = max_length, yet some response position is masked")

    # The repo's own consistency check (tests/test_fused_rollout.py): the
    # fused scorer's decode-collected logprobs/values against a full policy
    # re-forward of the last chunk's tokens. bf16 end to end over 28 layers,
    # KV-cache decode vs one full pass: a small spread is expected; a
    # misaligned position or a wrong kernel gives errors of order 1.
    last = slice(N_ROLLOUTS - CHUNK, N_ROLLOUTS)
    tokens = torch.as_tensor(np.concatenate([cols["query_tensors"][last], cols["response_tensors"][last]], 1),
                             device="cuda")
    mask = torch.as_tensor(np.concatenate([cols["query_mask"][last], cols["response_mask"][last]], 1),
                           device="cuda")
    scores = np.asarray(reward_fn(trainer.decode(tokens, mask)), dtype=np.float32)
    lp, values, rewards, _ = trainer.to_host(trainer.rollout_score(tokens, mask, scores))
    consistency = {}
    for key, ref in (("logprobs", lp), ("values", values), ("rewards", rewards)):
        diff = np.abs(cols[key][last] - ref)
        consistency[key] = {"mean_abs": float(diff.mean()), "max_abs": float(diff.max())}
    log(f"[main] fused vs re-forward scoring: {json.dumps(consistency)}")
    if consistency["logprobs"]["mean_abs"] > 0.1 or consistency["values"]["mean_abs"] > 0.1:
        raise AssertionError("fused rollout statistics disagree with the re-forward scorer")

    out = {
        "wall_s": wall,
        "prefill_device_s": stats["exp_prefill_device_s"],
        "decode_device_s": stats["exp_decode_device_s"],
        "score_device_s": stats["exp_score_device_s"],
        "decode_tokens": stats["exp_decode_tokens"],
        "decode_tokens_per_s": stats["exp_decode_tokens_per_s"],
        "reward_s": stats["exp_reward_s"],
        "peak_mem_gb": peak_gb,
        "launches": launches,
        "consistency": consistency,
    }
    log(f"[main] make_experience({N_ROLLOUTS}) at GPT-J-6B width: {json.dumps(out)}")
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trlx_tpu_torch.ops import cuda_lib
    from trlx_tpu_torch.ops.decode_attention import decode_attention
    from trlx_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd_dw, fused_logprob_bwd_dx, fused_logprob_fwd

    t_start = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    shutil.rmtree(RUN_DIR, ignore_errors=True)

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f}s")
    for ln in cuda_lib.build_log().splitlines():
        if "Compiling entry function" in ln or "registers" in ln or "spill" in ln:
            log(f"[build] {ln.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    phases = {}
    for name, fn in (("flash_prefill", lambda: phase_flash(gen, PROMPT_LEN, ragged=True)),
                     ("flash_branch_replay", lambda: phase_flash(gen, MAX_LEN, ragged=False)),
                     ("decode", lambda: phase_decode(gen)),
                     ("fused_logprob", lambda: phase_logprob(gen)),
                     ("flash_bwd", lambda: phase_flash_bwd(gen)),
                     ("fused_logprob_bwd", lambda: phase_logprob_bwd(LOGPROB_BWD_SEED))):
        t0 = time.perf_counter()
        phases[name] = fn()
        free()
        log(f"[kernel] {name} ({time.perf_counter() - t0:.1f}s): {json.dumps(phases[name])}")
    for name in ("flash_bwd", "fused_logprob_bwd"):
        phases.update(phases.pop(name))

    kernels = {"flash_attention_fwd": flash_fwd, "flash_attention_bwd_dq": flash_bwd_dq,
               "flash_attention_bwd_dkv": flash_bwd_dkv, "decode_attention": decode_attention,
               "fused_logprob_fwd": fused_logprob_fwd, "fused_logprob_bwd_dx": fused_logprob_bwd_dx,
               "fused_logprob_bwd_dw": fused_logprob_bwd_dw}
    t0 = time.perf_counter()
    _, rollout_launches = main_path(kernels)
    free()
    log(f"[main] rollout path done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_grad_consistency()
    log(f"[grad] done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    _, launches = train_path(kernels)
    log(f"[train] training path done in {time.perf_counter() - t0:.1f}s")
    for name, ms in logprob_bwd_split(LOGPROB_BWD_SEED).items():
        phases[name]["ms"] = ms
        log(f"[kernel] {name}: {ms:.4f} ms of kernels per fused_logprob_bwd call (profiler)")

    rows = []
    for name, phase, src, replaces in (
        ("flash_attention_fwd", "flash_prefill", "trlx_tpu_torch/csrc/flash_fwd.cu",
         "trlx_tpu/ops/flash_attention.py:155"),
        ("flash_attention_bwd_dq", "flash_attention_bwd_dq", "trlx_tpu_torch/csrc/flash_bwd.cu",
         "trlx_tpu/ops/flash_attention.py:249"),
        ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv", "trlx_tpu_torch/csrc/flash_bwd.cu",
         "trlx_tpu/ops/flash_attention.py:281"),
        ("fused_logprob_fwd", "fused_logprob", "trlx_tpu_torch/csrc/fused_logprob.cu",
         "trlx_tpu/ops/fused_logprob.py:126"),
        ("fused_logprob_bwd_dx", "fused_logprob_bwd_dx", "trlx_tpu_torch/csrc/fused_logprob_bwd.cu",
         "trlx_tpu/ops/fused_logprob.py:190"),
        ("fused_logprob_bwd_dw", "fused_logprob_bwd_dw", "trlx_tpu_torch/csrc/fused_logprob_bwd.cu",
         "trlx_tpu/ops/fused_logprob.py:237"),
        ("decode_attention", "decode", "trlx_tpu_torch/csrc/decode_attn.cu", "trlx_tpu/ops/decode_attention.py:193"),
    ):
        p = phases[phase]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": launches[name],
               "launches_rollout_path": rollout_launches[name], "max_abs_err": p["max_abs_err"], "tol": p["tol"],
               "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
               "library_ms": p["library_ms"], "shape": p["shape"]}
        if "library" in p:
            row["library"] = p["library"]
        if name == "flash_attention_fwd":
            row["branch_replay"] = phases["flash_branch_replay"]
        rows.append(row)
    log(f"[done] total {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
