#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``trlx_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``trlx_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main paths
give it (the paged decode kernels over scrambled block tables with a shared
prefix, a dead slot on the trash block and a fully masked row), then drives

1. the PPO experience phase (PPOTrainer → PromptPipeline →
   PPOOrchestrator.make_experience) at GPT-J-6B full width and depth on the
   chunked sampler, over a bf16 KV cache and again over an int8 one;
2. ``make_experience`` through the continuous-batching rollout engine,
   greedy, bf16 cache, GPT-J-6B width and 4 layers, paged and with fixed
   slots, and the share of identical tokens between the two;
3. a gradient-consistency check at GPT-J-6B width and 4 layers: one PPO
   batch's gradients on the kernel route against the plain route;
4. the training path, ``trlx_tpu_torch.train(reward_fn=...)``, at GPT-J-6B
   full width and depth (random weights): 16 PPO steps with a second
   ``make_experience`` in between and a final ``evaluate()``;
5. the main path: the same ``train`` through the paged engine with an int8
   KV cache (``method.rollout_engine``, ``method.paged_kv``,
   ``model.kv_cache_quant``), 16 prompts of which 8 share a 512-token
   prefix; prefix hits are held against a count reckoned from the
   admission order, the pool's leak audit runs after each phase, and the
   int8 block-table kernel is held against its plain version on the
   engine's own live pool;
6. offline ILQL, ``trlx_tpu_torch.train(dataset=...)``, at GPT-J-6B full
   width and depth (run first): 16 seeded token-array samples of 1024
   tokens, batch 4, 4 steps each followed by a Polyak sync held against
   alpha·online + (1 − alpha)·target, the last step profiled for the Q
   heads' share, then evaluate() steered by the target heads; and the ILQL
   kernel-route-versus-plain-route gradient check at 2 layers. The Q heads
   run the f32 mode of the fused head (rows 4-6 on f32 activations, held
   against their plain versions at N = 4092, D = 8192, V = 50400);

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
BWD_TURNS = 6  # alternating timing turns of the flash backward pair and SDPA's backward
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


def graph_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls captured in
    one CUDA graph, timed by CUDA events over ``replays`` replays after one
    warm-up replay. The decode paths replay their steps, so a decode row's
    kernel runs there without the host's launch time between calls; timed
    eagerly, a call whose wrapper takes the host longer than its kernel takes
    the card would measure the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def graph_pool_gb():
    """GB the caching allocator holds in CUDA graphs' private pools (its
    segments outside the default pool), or None where its snapshot does not
    say which pool a segment is in."""
    segments = torch.cuda.memory._snapshot()["segments"]
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) != (0, 0)) / 1e9


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def split_edge_bias(valid):
    """The bias of ``valid`` with row 1's keys 384-639 masked (two whole
    splits of 128 in the middle of a visible row, which the split-T walk
    skips) and row 2 fully masked (no visible key: every split is read and
    the row attends uniformly)."""
    valid = valid.clone()
    valid[1, 384:640] = False
    valid[2] = False
    return torch.where(valid, 0.0, -1e9).float()


DECODE_PAIRS = 10  # alternating turns of row 7 and SDPA


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
    edge = split_edge_bias(valid)
    err_edge = check("decode[split edges]", decode_attention(q, kc, vc, edge, scale=scale),
                     decode_attention_plain(q, kc, vc, edge, scale=scale), tol)
    plain_ms = time_ms(lambda: decode_attention_plain(q, kc, vc, bias, scale=scale), iters=10)
    q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    b4 = bias[:, None, None, :].to(torch.bfloat16)
    # The kernel and SDPA in DECODE_PAIRS alternating turns, each of graph
    # replays (``graph_ms``); each row's time is the median of its turns.
    fns = {"kernel": lambda: decode_attention(q, kc, vc, bias, scale=scale),
           "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=b4, scale=scale)}
    turns = {"kernel": [], "sdpa": []}
    for t in range(DECODE_PAIRS):
        for name in (("kernel", "sdpa") if t % 2 == 0 else ("sdpa", "kernel")):
            turns[name].append(graph_ms(fns[name]))
    ms, lib_ms = float(np.median(turns["kernel"])), float(np.median(turns["sdpa"]))
    # The same calls launched eagerly: what the host adds to a call.
    eager_ms = {name: time_ms(fn, iters=50) for name, fn in fns.items()}
    live = int(valid.sum())  # keys the bias leaves visible: the K/V rows this step needs
    nbytes = 2 * live * h * d * 2 + 2 * B * h * d * 2 + B * T * 4
    flops = 4 * live * h * d
    bound_ms, by = bound(nbytes, flops)
    return dict(max_abs_err=err, max_abs_err_split_edges=err_edge, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=by, shape=[B, T, h, d], live_keys=live, valid=valid,
                turns_vs_library=turns, eager_ms=eager_ms)


NO_LIBRARY = "null: no single PyTorch call reads an int8 cache with per-key scales or a block table"


def int8_kv(shape, gen):
    """int8 codes and f32 per-(key, head) scales, as the model's cache write
    makes them (``quantize_kv``) from bf16-range activations."""
    from trlx_tpu_torch.models.lm import quantize_kv

    return quantize_kv(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))


def phase_decode_int8(gen, valid):
    """Row 8: q [8, 16, 256] over an int8 cache of T = 1024 with f32 per-key
    scales, under the bias of row 7's phase (the same live keys)."""
    from trlx_tpu_torch.ops.decode_attention import decode_attention_int8, decode_attention_plain

    B, T, h, d = 8, MAX_LEN, 16, 256
    q = torch.randn((B, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    (kq, ks), (vq, vs) = int8_kv((B, T, h, d), gen), int8_kv((B, T, h, d), gen)
    bias = torch.where(valid, 0.0, -1e9).float()
    scale = d ** -0.5
    out = decode_attention_int8(q, kq, vq, ks, vs, bias, scale=scale)
    ref = decode_attention_plain(q, kq, vq, bias, scale=scale, ks=ks, vs=vs)
    tol = 1e-2  # row 7's: bf16 output, f32 softmax and scale folding on both sides
    err = check("decode_int8", out, ref, tol)
    edge = split_edge_bias(valid)
    err_edge = check("decode_int8[split edges]", decode_attention_int8(q, kq, vq, ks, vs, edge, scale=scale),
                     decode_attention_plain(q, kq, vq, edge, scale=scale, ks=ks, vs=vs), tol)
    ms = graph_ms(lambda: decode_attention_int8(q, kq, vq, ks, vs, bias, scale=scale))
    plain_ms = time_ms(lambda: decode_attention_plain(q, kq, vq, bias, scale=scale, ks=ks, vs=vs), iters=10)
    live = int(valid.sum())
    nbytes = 2 * live * h * d + 2 * live * h * 4 + 2 * B * h * d * 2 + B * T * 4  # int8 K/V, scales, q/o, bias
    bound_ms, by = bound(nbytes, 4 * live * h * d)
    return dict(max_abs_err=err, max_abs_err_split_edges=err_edge, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=None, library=NO_LIBRARY, bound_ms=bound_ms, bound_by=by, shape=[B, T, h, d],
                live_keys=live)


def paged_case(gen, quant: bool):
    """The engine's default pool at the smoke's shape: S = 8 slots of
    bps = 8 blocks of bs = 128 over n_blocks = 65 (trash block 0 + every
    slot's span). Tables are scrambled (a seeded permutation of blocks
    1..64); slots 0 and 1 share their first 4 blocks, as a prefix hit does;
    slot 7 is dead, its table all trash block 0 under a stale mask; slot 6
    is fully masked; the rest are left-padded prompts of 600-768 tokens at
    decode step 128."""
    S, bs, bps, h, d = 8, 128, 8, 16, 256
    n_blocks = 1 + S * bps
    T = bs * bps
    q = torch.randn((S, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    shape = (n_blocks, bs, h, d)
    if quant:
        (kp, ks), (vp, vs) = int8_kv(shape, gen), int8_kv(shape, gen)
    else:
        kp, vp = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1)[: S * bps].reshape(S, bps)
    tables = tables.to(torch.int32)
    tables[1, :4] = tables[0, :4]
    tables[S - 1] = 0
    lens = torch.randint(MIN_PROMPT, PROMPT_LEN + 1, (S,), generator=gen, device="cuda")
    pos = torch.arange(T, device="cuda")[None, :]
    valid = (pos >= (PROMPT_LEN - lens)[:, None]) & (pos <= PROMPT_LEN + 128)
    valid[1] = valid[0]  # a prefix hit: the same width and padding, content diverging after block 3
    valid[S - 2] = False
    bias = torch.where(valid, 0.0, -1e9).float()
    return q, kp, vp, ks, vs, tables, bias, valid


def phase_paged(gen, quant: bool):
    """Rows 9 (bf16 pool) and 10 (int8 pool) against the plain version over
    the gathered view pool[tbl]."""
    from trlx_tpu_torch.ops.decode_attention import (
        paged_decode_attention, paged_decode_attention_int8, paged_decode_attention_plain,
    )

    q, kp, vp, ks, vs, tables, bias, valid = paged_case(gen, quant)
    (S, h, d), bs = q.shape, kp.shape[1]
    scale = d ** -0.5
    if quant:
        def run(b=bias):
            return paged_decode_attention_int8(q, kp, vp, ks, vs, tables, b, scale=scale)
    else:
        def run(b=bias):
            return paged_decode_attention(q, kp, vp, tables, b, scale=scale)

    def plain(b=bias):
        return paged_decode_attention_plain(q, kp, vp, tables, b, scale=scale, ks=ks, vs=vs)

    tol = 1e-2  # row 7's
    name = "paged_decode_int8" if quant else "paged_decode"
    err = check(name, run(), plain(), tol)
    edge = split_edge_bias(valid)
    err_edge = check(f"{name}[split edges]", run(edge), plain(edge), tol)
    ms = graph_ms(run)
    plain_ms = time_ms(plain, iters=10)
    # The bytes this data needs: each physical K/V row some slot's bias
    # leaves visible, once (shared blocks and the dead slot's trash block
    # are the same memory), plus q/o, bias and tables.
    t = torch.arange(valid.shape[1], device="cuda")
    phys = (tables.long().gather(1, (t // bs)[None].expand_as(valid)) * bs + t % bs)[valid]
    live = int(torch.unique(phys).numel())
    per_key = h * d * (1 if quant else 2) * 2 + (2 * h * 4 if quant else 0)
    nbytes = live * per_key + 2 * S * h * d * 2 + valid.numel() * 4 + tables.numel() * 4
    bound_ms, by = bound(nbytes, 4 * int(valid.sum()) * h * d)
    return dict(max_abs_err=err, max_abs_err_split_edges=err_edge, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=None, library=NO_LIBRARY, bound_ms=bound_ms, bound_by=by,
                shape=[S, int(kp.shape[0]), bs, int(tables.shape[1]), h, d], live_keys=int(valid.sum()),
                unique_live_rows=live)


def phase_logprob(gen):
    """Fused logprob head: N = 2048 rows (8 x 256 responses), D = 4096,
    V = 50400, untied f32 head weight with bias, as the branch replay calls
    it. The row's time includes the wrapper's bf16 cast of the f32 weight;
    the same call on a bf16 weight (a frozen head's cached copy), the cast
    alone and ``torch.matmul`` of the same bf16 [N, D] x [D, V] product
    (the yardstick of the GEMM mainloop, not a port) are timed beside it."""
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob, kernel_weight, naive_logprob

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
    wb = kernel_weight(w)
    err_bf16 = max(check(f"logprob.{n}[bf16 w]", g, r, tol)
                   for n, g, r in zip(("lp", "lse", "ent"), fused_logprob(x, wb, y, b), ref))
    ms = time_ms(lambda: fused_logprob(x, w, y, b), iters=5)
    ms_bf16 = time_ms(lambda: fused_logprob(x, wb, y, b), iters=5)
    cast_ms = time_ms(lambda: kernel_weight(w), iters=5)
    matmul_ms = time_ms(lambda: torch.matmul(x, wb), iters=5)
    plain_ms = time_ms(lambda: naive_logprob(x, w, y, b), iters=3, warmup=1)
    nbytes = N * D * 2 + D * V * 4 + V * 4 + N * 4 + 3 * N * 4
    flops = 2 * N * D * V
    bound_ms, by = bound(nbytes, flops)
    log(f"[fused_logprob] {ms:.4f} ms with the f32 weight ({cast_ms:.4f} of it the cast), {ms_bf16:.4f} ms on a "
        f"bf16 weight; torch.matmul of the bf16 product {matmul_ms:.4f} ms; bound {bound_ms:.4f} ms")
    return dict(max_abs_err=max(err, err_bf16), tol=tol, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=by, shape=[N, D, V], ms_bf16_weight=ms_bf16, cast_ms=cast_ms,
                matmul_ms=matmul_ms, matmul="torch.matmul bf16 [N, D] x [D, V], the yardstick of the mainloop")


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

    def pair():
        return (flash_bwd_dq(q, k, v, mask, do, lse, delta, scale=scale, window=0),
                *flash_bwd_dkv(q, k, v, mask, do, lse, delta, scale=scale, window=0))

    dq, dk, dv = pair()
    # No atomics: a second call gives the same bits.
    if not all(torch.equal(x, y) for x, y in zip(pair(), (dq, dk, dv))):
        raise AssertionError("flash_bwd: a second call of dq / dk / dv differs from the first")
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale)
    # bf16 outputs and bf16 P / dS in the products on both sides; tiles vs
    # one einsum sum in another order.
    rel = 2e-2
    err_q, tol_q = check_rel("flash_bwd.dq", dq[rows], rq[rows], rel)
    err_k, tol_k = check_rel("flash_bwd.dk", dk, rk, rel)
    err_v, tol_v = check_rel("flash_bwd.dv", dv, rv, rel)
    del rq, rk, rv
    ms_dq = time_ms(lambda: flash_bwd_dq(q, k, v, mask, do, lse, delta, scale=scale, window=0))
    ms_dkv = time_ms(lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, scale=scale, window=0))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale),
                       iters=3, warmup=1)
    # Library yardstick: SDPA's backward with the same boolean mask, dq, dk
    # and dv together (autograd.grad over one retained forward), timed in
    # alternating turns with the pair of kernels.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    amask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None, None] & rows[:, None, None, :]
    backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(qt, kt, vt, amask, 0.0, False,
                                                                     scale=scale)).name
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=scale)

    def sdpa_bwd():
        torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True)

    turns = {"pair": [], "sdpa_bwd": []}
    for t in range(BWD_TURNS):
        for name in (("pair", "sdpa_bwd") if t % 2 == 0 else ("sdpa_bwd", "pair")):
            turns[name].append(time_ms(pair if name == "pair" else sdpa_bwd, iters=10, warmup=1))
    del sdpa_out
    pair_ms, lib_ms = float(np.median(turns["pair"])), float(np.median(turns["sdpa_bwd"]))
    log(f"[flash_bwd] pair (dq + dk/dv) {pair_ms:.4f} ms vs SDPA backward ({backend}) {lib_ms:.4f} ms, medians of "
        f"{BWD_TURNS} alternating turns: ratio {pair_ms / lib_ms:.3f}; turns {json.dumps(turns)}")
    pairs = b * h * T * (T + 1) / 2
    one = b * T * h * d * 2  # one bf16 [b, T, h, d] tensor
    rowvec = b * h * T * 4
    bdq = bound(5 * one + 2 * rowvec + b * T * 4, 6 * d * pairs)
    bdkv = bound(6 * one + 2 * rowvec + b * T * 4, 8 * d * pairs)
    common = dict(plain_ms=plain_ms, library_ms=lib_ms, library=f"SDPA backward ({backend}), dq+dk+dv together",
                  pair_ms=pair_ms, pair_over_library=pair_ms / lib_ms,
                  shape=[b, T, h, d])
    return {
        "flash_attention_bwd_dq": dict(max_abs_err=err_q, tol=tol_q, ms=ms_dq, bound_ms=bdq[0], bound_by=bdq[1],
                                       **common),
        "flash_attention_bwd_dkv": dict(max_abs_err=max(err_k, err_v), tol=max(tol_k, tol_v), ms=ms_dkv,
                                        bound_ms=bdkv[0], bound_by=bdkv[1], **common),
    }


def check_head_grads(got, ref, labels, rel_dx=2e-2, rel_dw=1e-2, rel_db=1e-3, name="logprob_bwd"):
    """(dx, dW, db) of the fused head against the plain backward, each
    within a share of its own max |ref|. dW and db are held apart on the
    columns some label hits and on the rest: there ds is only the softmax
    terms p·(dlse − dlp − dent·(s − E)), far smaller than the label term,
    so one tolerance over all columns would not see them. The default
    shares are the bf16 mode's: ds is rounded to bf16 on both sides before
    the products, and a sum in another order can flip that rounding; dx
    comes back in bf16 (one ulp is 2^-8 of max |dx|); db sums the f32 ds on
    both sides. Returns {name: (max_abs_err, tol)}."""
    (dx, dw, db), (rdx, rdw, rdb) = got, ref
    hit = torch.zeros(rdw.shape[1], dtype=torch.bool, device=rdw.device)
    hit[labels.long()] = True
    out = {"dx": check_rel(f"{name}.dx", dx, rdx, rel_dx)}
    for part, cols in (("hit", hit), ("unhit", ~hit)):
        out[f"dw_{part}"] = check_rel(f"{name}.dw[{part}]", dw[:, cols], rdw[:, cols], rel_dw)
        out[f"db_{part}"] = check_rel(f"{name}.db[{part}]", db[cols], rdb[cols], rel_db)
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
    """The fused-logprob backward against its plain version (``check_head_grads``),
    bit-equal on a second call, with its ds buffer's bytes and the call's
    peak; the whole call timed by CUDA events, the rows' ``ms`` from
    ``logprob_bwd_rows`` at the end of the run. The yardstick of row 6 is
    ``torch.matmul`` of the same bf16 product xᵀ·ds, ds given (bf16 out,
    half of dW's f32 bytes): not a port, and not ``library_ms``."""
    from trlx_tpu_torch.ops.fused_logprob import BWD_CHUNK_ROWS, _DS_LD, fused_logprob_bwd, fused_logprob_bwd_plain

    args = logprob_bwd_inputs(seed)
    x, w, y = args[0], args[1], args[3]
    (N, D), V = x.shape, w.shape[1]
    ref = fused_logprob_bwd_plain(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = fused_logprob_bwd(*args)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    errs = check_head_grads(got, ref, y)
    # No atomics: a second call gives the same bits.
    if not all(torch.equal(a, b) for a, b in zip(fused_logprob_bwd(*args), got)):
        raise AssertionError("fused_logprob_bwd: a second call of dx / dW / db differs from the first")
    del got, ref
    plain_ms = time_ms(lambda: fused_logprob_bwd_plain(*args), iters=3, warmup=1)
    ms_all = time_ms(lambda: fused_logprob_bwd(*args), iters=5, warmup=1)
    ldv = -(-V // _DS_LD) * _DS_LD
    ds = torch.randn((N, V), generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    ds = ds.to(torch.bfloat16)
    matmul_ms = time_ms(lambda: torch.matmul(x.t(), ds), iters=5)
    del ds
    flops = 2 * N * D * V
    small = N * 4 * 6 + V * 4  # labels, lse, ent, three cotangents; bias or db
    bdx = bound(N * D * 2 + D * V * 4 + small + N * V * 2 + N * D * 2, 2 * flops)  # x, W in; ds, dx out
    bdw = bound(N * D * 2 + N * V * 2 + D * V * 4 + V * 4, flops)  # x, ds in; dW, db out
    common = dict(plain_ms=plain_ms, library_ms=None, library="none: no single PyTorch call computes it",
                  whole_backward_ms=ms_all, ms_from="CUDA events over the wrapper calls of one fused_logprob_bwd call on the "
                  "f32 weight; the ds + dx row counts the wrapper's bf16 cast of it",
                  shape=[N, D, V], chunks=-(-N // BWD_CHUNK_ROWS), checks=errs,
                  ds_buffer_bytes=-(-N // 128) * 128 * ldv * 2, call_peak_gb=peak_gb)
    # dW/db's row shows the partition nearest its tolerance.
    dw_err, dw_tol = max((e for k, e in errs.items() if k != "dx"), key=lambda et: et[0] / et[1])
    return {
        "fused_logprob_bwd_dx": dict(max_abs_err=errs["dx"][0], tol=errs["dx"][1], bound_ms=bdx[0],
                                     bound_by=bdx[1], **common),
        "fused_logprob_bwd_dw": dict(max_abs_err=dw_err, tol=dw_tol, bound_ms=bdw[0], bound_by=bdw[1],
                                     matmul_ms=matmul_ms, matmul="torch.matmul bf16 x^T [D, N] x ds [N, V], ds "
                                     "given: the yardstick of the dW product", **common),
    }


def logprob_bwd_rows(args, iters: int):
    """Device ms of rows 5 and 6 (5f and 6f on f32 inputs) as one
    ``fused_logprob_bwd`` call on ``args`` runs them: every chunk's ds + dx
    wrapper call (in the bf16 mode after the wrapper's bf16 cast of the f32
    weight, which the row counts, and again without it), then the dW/db
    call, each timed by CUDA events over the wrapper calls on the buffers
    the backward uses. A profiler split of the same call read the f32 rows
    2.7x and 2x low in one run of this script against another on the same
    card: it dropped kernels, so the rows are not taken from it."""
    from trlx_tpu_torch.ops.fused_logprob import (
        BWD_CHUNK_ROWS, _DS_LD, fused_logprob_bwd_dw, fused_logprob_bwd_dw_f32, fused_logprob_bwd_dx,
        fused_logprob_bwd_dx_f32, kernel_weight,
    )

    x, w, b, y, *vecs = args
    f32 = x.dtype == torch.float32
    (N, D), V = x.shape, w.shape[1]
    ldv = -(-V // _DS_LD) * _DS_LD
    n_tiles = -(-N // 128)
    C = min(BWD_CHUNK_ROWS, n_tiles * 128)
    ds = torch.empty((n_tiles * 128, ldv), dtype=x.dtype, device="cuda")
    dx = torch.empty((N, D), dtype=x.dtype, device="cuda")
    dbpart, dw, db = (torch.empty(s, device="cuda") for s in ((n_tiles, V), (D, V), (V,)))
    y = y.to(torch.int32)
    dx_fn, dw_fn = (fused_logprob_bwd_dx_f32, fused_logprob_bwd_dw_f32) if f32 else (
        fused_logprob_bwd_dx, fused_logprob_bwd_dw)
    wk = w if f32 else kernel_weight(w)

    def ds_dx(cast: bool):
        wc = kernel_weight(w) if cast else wk
        for c0 in range(0, N, C):
            dx_fn(x[c0:], wc, b, y[c0:], [v[c0:] for v in vecs], ds[c0:], dbpart[c0 // 128:], dx[c0:],
                  rows=min(C, N - c0), C=C, ldv=ldv, tied=False)

    def dw_db():
        dw_fn(x, ds, dw, rows=N, V=V, ldv=ldv, tied=False, dbpart=dbpart, db=db)

    suffix = "_f32" if f32 else ""
    out = {f"fused_logprob_bwd_dx{suffix}": time_ms(lambda: ds_dx(not f32), iters=iters, warmup=1),
           f"fused_logprob_bwd_dw{suffix}": time_ms(dw_db, iters=iters, warmup=1)}
    if not f32:
        out["fused_logprob_bwd_dx_kernels_only"] = time_ms(lambda: ds_dx(False), iters=iters, warmup=1)
    return out


# The f32 mode of rows 4-6 as ILQL's Q heads call it on ``ilql_train``:
# N = 4 x 1023 action rows, D = 2 * d_model (the heads' hidden), the
# vocabulary; f32 activations and weight, with bias.
ILQL_BATCH = 4
F32_SHAPE = (ILQL_BATCH * (MAX_LEN - 1), 2 * GPTJ_6B_ARCH["d_model"], GPTJ_6B_ARCH["vocab_size"])
F32_SEED = 17
# H100 SXM published dense peaks at its 1.98 GHz boost clock (NVIDIA data
# sheet): f32 on the CUDA cores, TF32 on the tensor cores.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
F32_REL = 1e-4  # the f32 mode's tolerance (see check_scaled and check_head_grads)


def bound_f32(nbytes: float, flops: float):
    """The least time of an f32-accurate product: the bytes over the HBM
    rate, against the lesser of the f32 CUDA-core time and three TF32
    tensor-core passes (the 3xTF32 split keeps f32 accuracy)."""
    t_bytes = nbytes / PEAK_HBM_BYTES_S
    t_ops = min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_scaled(name: str, got, ref, rel: float = F32_REL):
    """max |got - ref| / max(1, |ref|), elementwise, within ``rel``; raise
    otherwise or on a non-finite value. Returns (max_abs_err, max_scaled_err)."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - ref).abs()
    scaled = float((diff / ref.abs().clamp(min=1.0)).max())
    if not scaled <= rel:
        raise AssertionError(f"{name}: max |d| / max(1, |ref|) = {scaled:.3e} > {rel:.1e}")
    return float(diff.max()), scaled


def f32_head_inputs(seed: int):
    """A Q head's fused-head inputs at ``F32_SHAPE``: x a ReLU hidden, W with
    the logit spread of a trained head (std ~2.5), a bias, labels."""
    N, D, V = F32_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.relu(torch.randn((N, D), generator=gen, device="cuda"))
    w = torch.randn((D, V), generator=gen, device="cuda") * (3.5 * D ** -0.5)
    b = torch.randn((V,), generator=gen, device="cuda") * 0.1
    y = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)
    return x, w, b, y


def phase_logprob_f32(seed: int):
    """Row 4's f32 mode: the forward kernel pair on f32 x and W against
    ``naive_logprob`` (an f32 product with TF32 off), lp, lse and entropy
    each within 1e-4 · max(1, |ref|). The yardstick is ``torch.matmul`` of
    the same f32 product (TF32 off): not a port, and not ``library_ms``."""
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_fwd_f32, naive_logprob

    x, w, b, y = f32_head_inputs(seed)
    N, D, V = F32_SHAPE
    got = fused_logprob_fwd_f32(x, w, y, b)
    ref = naive_logprob(x, w, y, b)
    errs = {n: check_scaled(f"logprob_f32.{n}", g, r) for n, g, r in zip(("lp", "lse", "ent"), got, ref)}
    del got, ref
    ms = time_ms(lambda: fused_logprob_fwd_f32(x, w, y, b), iters=3, warmup=1)
    plain_ms = time_ms(lambda: naive_logprob(x, w, y, b), iters=2, warmup=1)
    matmul_ms = time_ms(lambda: torch.matmul(x, w), iters=3, warmup=1)
    flops = 2 * N * D * V
    bound_ms, by = bound_f32(N * D * 4 + D * V * 4 + V * 4 + N * 4 + 3 * N * 4, flops)
    log(f"[fused_logprob_f32] {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s); torch.matmul of the f32 product "
        f"{matmul_ms:.3f} ms; plain {plain_ms:.3f} ms; bound {bound_ms:.3f} ms")
    return dict(max_abs_err=max(e[0] for e in errs.values()), max_scaled_err=max(e[1] for e in errs.values()),
                tol=F32_REL, tol_rule="|d| <= 1e-4 * max(1, |ref|) elementwise on lp, lse, entropy",
                ms=ms, plain_ms=plain_ms, library_ms=None, library="none: no single PyTorch call computes it",
                matmul_ms=matmul_ms, matmul="torch.matmul f32 [N, D] x [D, V], TF32 off: the yardstick",
                bound_ms=bound_ms, bound_by=by, shape=[N, D, V], checks=errs)


def logprob_bwd_f32_inputs(seed: int):
    """The f32 backward's arguments: ``f32_head_inputs``, the f32 forward's
    lse and entropy, three nonzero cotangents."""
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_fwd_f32

    x, w, b, y = f32_head_inputs(seed)
    _, lse, ent = fused_logprob_fwd_f32(x, w, y, b)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    cts = [torch.randn((x.shape[0],), generator=gen, device="cuda") * 0.1 for _ in range(3)]
    return (x, w, b, y, lse, ent, *cts)


def phase_logprob_bwd_f32(seed: int):
    """Rows 5-6's f32 mode: ``fused_logprob_bwd`` on f32 x and W against the
    plain backward, dx, dW and db each within 1e-4 of the reference's max
    (on the hit and unhit columns apart), f32 outputs, bit-equal on a second
    call. The rows' ``ms`` come from ``logprob_bwd_rows``; the
    yardsticks are ``torch.matmul`` of the f32 products ds·Wᵀ and xᵀ·ds,
    ds given (TF32 off)."""
    from trlx_tpu_torch.ops.fused_logprob import BWD_CHUNK_ROWS, _DS_LD, fused_logprob_bwd, fused_logprob_bwd_plain

    args = logprob_bwd_f32_inputs(seed)
    x, w, y = args[0], args[1], args[3]
    N, D, V = F32_SHAPE
    ref = fused_logprob_bwd_plain(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = fused_logprob_bwd(*args)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    if any(t.dtype != torch.float32 for t in got):
        raise AssertionError(f"fused_logprob_bwd f32: outputs {[t.dtype for t in got]}")
    errs = check_head_grads(got, ref, y, F32_REL, F32_REL, F32_REL, name="logprob_bwd_f32")
    if not all(torch.equal(a, c) for a, c in zip(fused_logprob_bwd(*args), got)):
        raise AssertionError("fused_logprob_bwd f32: a second call of dx / dW / db differs from the first")
    del got, ref
    plain_ms = time_ms(lambda: fused_logprob_bwd_plain(*args), iters=2, warmup=1)
    ms_all = time_ms(lambda: fused_logprob_bwd(*args), iters=2, warmup=1)
    ds = torch.randn((N, V), generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    dx_matmul_ms = time_ms(lambda: torch.matmul(ds, w.t()), iters=3, warmup=1)
    dw_matmul_ms = time_ms(lambda: torch.matmul(x.t(), ds), iters=3, warmup=1)
    del ds
    flops = 2 * N * D * V
    small = N * 4 * 6 + V * 4  # labels, lse, ent, three cotangents; bias or db
    bdx = bound_f32(N * D * 4 + D * V * 4 + small + N * V * 4 + N * D * 4, 2 * flops)  # x, W in; ds, dx out
    bdw = bound_f32(N * D * 4 + N * V * 4 + D * V * 4 + V * 4, flops)  # x, ds in; dW, db out
    ldv = -(-V // _DS_LD) * _DS_LD
    common = dict(plain_ms=plain_ms, library_ms=None, library="none: no single PyTorch call computes it",
                  whole_backward_ms=ms_all, tol_rule="max |d| <= 1e-4 * max |ref| (hit and unhit columns apart)",
                  ms_from="CUDA events over the wrapper calls of one fused_logprob_bwd call on f32 x and W",
                  shape=[N, D, V], chunks=-(-N // BWD_CHUNK_ROWS), checks=errs,
                  ds_buffer_bytes=-(-N // 128) * 128 * ldv * 4, call_peak_gb=peak_gb)
    dw_err, dw_tol = max((e for k, e in errs.items() if k != "dx"), key=lambda et: et[0] / et[1])
    log(f"[fused_logprob_bwd_f32] whole backward {ms_all:.3f} ms; torch.matmul of ds·Wᵀ {dx_matmul_ms:.3f} ms, "
        f"of xᵀ·ds {dw_matmul_ms:.3f} ms; plain {plain_ms:.3f} ms; call peak {peak_gb:.2f} GB")
    return {
        "fused_logprob_bwd_dx_f32": dict(max_abs_err=errs["dx"][0], tol=errs["dx"][1], bound_ms=bdx[0],
                                         bound_by=bdx[1], matmul_ms=dx_matmul_ms,
                                         matmul="torch.matmul f32 ds [N, V] x W^T [V, D], ds given, TF32 off",
                                         **common),
        "fused_logprob_bwd_dw_f32": dict(max_abs_err=dw_err, tol=dw_tol, bound_ms=bdw[0], bound_by=bdw[1],
                                         matmul_ms=dw_matmul_ms,
                                         matmul="torch.matmul f32 x^T [D, N] x ds [N, V], ds given, TF32 off",
                                         **common),
    }


def smoke_config(quant: bool = False, n_layer: int = GPTJ_6B_ARCH["n_layer"], run: str = "rollout",
                 greedy: bool = False, **method):
    """The rollout path's config: GPT-J-6B, experience only. ``quant`` sets
    model.kv_cache_quant, ``greedy`` turns sampling off, ``method`` adds
    method fields (the engine's)."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=2,
                      model_arch=dict(GPTJ_6B_ARCH, n_layer=n_layer), dtype="bfloat16", param_dtype="float32",
                      kv_cache_quant=quant),
        "train": dict(total_steps=1, seq_length=MAX_LEN, epochs=1, batch_size=CHUNK, lr_ramp_steps=1,
                      lr_decay_steps=1, weight_decay=1e-6, learning_rate_init=1.412e-4,
                      learning_rate_target=1.412e-4, seed=1000, checkpoint_dir=os.path.join(RUN_DIR, run)),
        "method": dict(name="ppoconfig", num_rollouts=N_ROLLOUTS, chunk_size=CHUNK, init_kl_coef=0.2, target=6,
                       horizon=10000, gen_kwargs=dict(prompt_length=PROMPT_LEN, max_length=MAX_LEN,
                                                      min_length=MAX_LEN, top_k=0, top_p=0.7, temperature=0.5,
                                                      do_sample=not greedy), **method),
    })


def train_config(n_layer: int, model_type: str, run_dir: str, method=None, quant: bool = False, **arch):
    """The training path's config: GPT-J-6B (depth ``n_layer``) with the
    method and optimizer values of trlx_tpu/configs/ppo_gptj_config.yml
    (remat, 2 unfrozen layers, vf_coef 0.2, betas (0.9, 0.95), lr 1.412e-4
    with a 100-step ramp, 4 PPO epochs, adaptive KL 0.2 → 6), the smoke's
    768 + 256 lengths, 16 rollouts in chunks of 8, batch 8, 2 epochs and 16
    steps. ``method`` adds method fields, ``quant`` sets
    model.kv_cache_quant."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type=model_type, num_layers_unfrozen=2,
                      model_arch=dict(GPTJ_6B_ARCH, n_layer=n_layer, **arch), dtype="bfloat16",
                      param_dtype="float32", remat=True, kv_cache_quant=quant),
        "train": dict(total_steps=16, seq_length=MAX_LEN, epochs=2, batch_size=CHUNK, lr_ramp_steps=100,
                      lr_decay_steps=79000, weight_decay=1e-6, learning_rate_init=1.412e-4,
                      learning_rate_target=1.412e-4, opt_betas=[0.9, 0.95], grad_clip=1.0,
                      checkpoint_interval=10**6, eval_interval=10**6, checkpoint_dir=run_dir, seed=1000),
        "method": dict(name="ppoconfig", num_rollouts=N_ROLLOUTS, chunk_size=CHUNK, ppo_epochs=4, init_kl_coef=0.2,
                       target=6, horizon=10000, gamma=1.0, lam=0.95, cliprange=0.2, cliprange_value=0.2,
                       vf_coef=0.2, gen_kwargs=dict(prompt_length=PROMPT_LEN, max_length=MAX_LEN,
                                                    min_length=MAX_LEN, top_k=0, top_p=0.7, temperature=0.5,
                                                    do_sample=True), **(method or {})),
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


def make_timed_trainer(kernels, n_layer: int, on_engine=None):
    """A PPOTrainer, registered under its own name and picked by the
    config's ``model_type``, that records per train step its device time
    (CUDA events), its kernel launches and its stats; parameter fingerprints
    at the start, after step 2 and at the end; the launches so far when
    evaluate() starts, and each evaluate()'s stats. ``on_engine(engine)``
    runs once, when the rollout engine is built."""
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    @register_model("SmokeTimedPPOTrainer")
    class SmokeTimedPPOTrainer(PPOTrainer):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            self.step_log, self.eval_log = [], []
            self.launches_before_eval = None
            self.fp = {"start": group_fingerprints(self, n_layer)}

        def rollout_engine(self):
            fresh = self._rollout_engine is None
            engine = super().rollout_engine()
            if fresh and on_engine is not None:
                on_engine(engine)
            return engine

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
            self.launches_before_eval = {n: f.launches for n, f in kernels.items()}
            stats = super().evaluate()
            self.eval_log.append(stats)
            return stats

    return SmokeTimedPPOTrainer


def train_step_launches(kernels, n_layer: int):
    """Kernel launches of one train step at the smoke's batch: the flash
    forward twice per layer (the forward, then its recompute under remat),
    the flash backward once per layer, the fused head forward once, its
    ds + dx once per 1024-row chunk and its dW once over all rows; no decode
    kernel."""
    bwd_chunks = -(-CHUNK * (MAX_LEN - PROMPT_LEN) // 1024)
    out = dict.fromkeys(kernels, 0)
    out.update({"flash_attention_fwd": 2 * n_layer, "flash_attention_bwd_dq": n_layer,
                "flash_attention_bwd_dkv": n_layer, "fused_logprob_fwd": 1, "fused_logprob_bwd_dx": bwd_chunks,
                "fused_logprob_bwd_dw": 1})
    return out


def check_train_steps(trainer, config, per_step):
    """Every train step recorded by the timed trainer launched exactly
    ``per_step``, has finite stats and no guard skip; steps 1 and 9, the
    first on fresh rollouts (the second make_experience ran with the
    updated weights), have mean_ratio within 1 +- 0.05: the training
    forward reproduces the rollout policy's statistics. Returns the log."""
    log_, steps = trainer.step_log, config.train.total_steps
    if len(log_) != steps or trainer.iter_count != steps:
        raise AssertionError(f"{len(log_)} train steps recorded, iter_count {trainer.iter_count}, expected {steps}")
    for i, rec in enumerate(log_):
        if rec["launches"] != per_step:
            raise AssertionError(f"step {i + 1} launched {rec['launches']}, expected {per_step}")
        bad = [k for k, v in rec.items() if k != "launches" and not np.isfinite(v)]
        if bad or rec["resilience/nonfinite"] != 0.0:
            raise AssertionError(f"step {i + 1}: non-finite {bad} or a guard skip ({rec['resilience/nonfinite']})")
    for i in (0, steps // config.train.epochs):
        if not abs(log_[i]["mean_ratio"] - 1.0) <= 0.05:
            raise AssertionError(f"step {i + 1} mean_ratio {log_[i]['mean_ratio']} is not within 1 +- 0.05")
    return log_


def train_path(kernels):
    """``trlx_tpu_torch.train(reward_fn=...)`` at GPT-J-6B full width and
    depth on the chunked sampler with a bf16 cache; returns its numbers and
    the launches of the whole run."""
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
    per_step = train_step_launches(kernels, n_layer)
    expected = dict.fromkeys(kernels, 0)
    expected.update({
        "flash_attention_fwd": chunks * (n_layer + k) + steps * 2 * n_layer + n_layer,
        "decode_attention": (chunks + 1) * n_layer * R,
        "fused_logprob_fwd": chunks + steps,
        "flash_attention_bwd_dq": steps * n_layer, "flash_attention_bwd_dkv": steps * n_layer,
        "fused_logprob_bwd_dx": steps * bwd_chunks, "fused_logprob_bwd_dw": steps,
    })
    log(f"[train] launches {launches} expected {expected} (rollouts: {chunks} chunks x flash {n_layer + k}, "
        f"decode {n_layer}x{R}, fused logprob 1; per train step {per_step}; eval: flash {n_layer}, "
        f"decode {n_layer}x{R})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    log_ = check_train_steps(trainer, config, per_step)

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


def main_path(kernels, quant: bool = False):
    """The PPO experience phase at GPT-J-6B width (the rollout path) on the
    chunked sampler, over a bf16 cache or, with ``quant``, an int8 one (the
    decode steps then run row 8); returns its numbers."""
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    tag = "[rollout-int8]" if quant else "[main]"
    decode = "decode_attention_int8" if quant else "decode_attention"
    config = smoke_config(quant=quant, run="rollout_int8" if quant else "rollout")
    t0 = time.perf_counter()
    trainer = PPOTrainer(config)
    torch.cuda.synchronize()
    log(f"{tag} PPOTrainer built in {time.perf_counter() - t0:.1f}s: {config.model.model_arch['n_layer']} layers, "
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
    pool_gb = graph_pool_gb()

    n_chunks = N_ROLLOUTS // CHUNK
    n_layer, k = GPTJ_6B_ARCH["n_layer"], config.model.num_layers_unfrozen
    steps = MAX_LEN - PROMPT_LEN
    expected = dict.fromkeys(kernels, 0)  # no backward kernel runs on the rollout path
    expected.update({"flash_attention_fwd": n_chunks * (n_layer + k), decode: n_chunks * n_layer * steps,
                     "fused_logprob_fwd": n_chunks})
    log(f"{tag} launches {launches} expected {expected}")
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
    # KV-cache decode vs one full pass: a small spread is expected (with an
    # int8 cache the JAX package measured |dlogprob| <= ~0.008 against the
    # full-precision re-forward); a misaligned position or a wrong kernel
    # gives errors of order 1.
    last = slice(N_ROLLOUTS - CHUNK, N_ROLLOUTS)
    tokens = trainer.put(np.concatenate([cols["query_tensors"][last], cols["response_tensors"][last]], 1))
    mask = trainer.put(np.concatenate([cols["query_mask"][last], cols["response_mask"][last]], 1))
    scores = np.asarray(reward_fn(trainer.decode(tokens, mask)), dtype=np.float32)
    lp, values, rewards, _ = trainer.to_host(trainer.rollout_score(tokens, mask, scores))
    consistency = {}
    for key, ref in (("logprobs", lp), ("values", values), ("rewards", rewards)):
        diff = np.abs(cols[key][last] - ref)
        consistency[key] = {"mean_abs": float(diff.mean()), "max_abs": float(diff.max())}
    log(f"{tag} fused vs re-forward scoring: {json.dumps(consistency)}")
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
        "graph_pool_gb": pool_gb,
        "launches": launches,
        "consistency": consistency,
    }
    log(f"{tag} make_experience({N_ROLLOUTS}) at GPT-J-6B width: {json.dumps(out)}")
    return out, launches


ENGINE = dict(rollout_engine=True, kv_block_size=128, engine_slots=8, prefill_batch=4, engine_steps_per_sync=8)


def engine_prompts():
    """16 token prompts: 8 of 768 tokens that share their first 512 (four
    128-token blocks a later admission hits), and 8 of seeded lengths in
    600-768, left-padded to 768."""
    rng = np.random.default_rng(7)
    head = rng.integers(1, 50400, size=512)
    shared = [np.concatenate([head, rng.integers(1, 50400, size=PROMPT_LEN - 512)]).tolist() for _ in range(8)]
    return shared + seeded_prompts(8, 8)


def record_pool_events(pool):
    """Log the engine pool's calls in order: admit (with the hit tokens it
    returned), register_prefix, release and flush_registry."""
    events = []
    admit, register, release, flush = pool.admit, pool.register_prefix, pool.release, pool.flush_registry

    def admit_(slot, version, ids, mask):
        row, hit = admit(slot, version, ids, mask)
        events.append(("admit", slot, version, np.asarray(ids), np.asarray(mask), hit))
        return row, hit

    def register_(slot, version, ids, mask):
        register(slot, version, ids, mask)
        events.append(("register", slot, version, np.asarray(ids), np.asarray(mask)))

    def release_(slot):
        release(slot)
        events.append(("release", slot))

    def flush_():
        flush()
        events.append(("flush",))

    pool.admit, pool.register_prefix, pool.release, pool.flush_registry = admit_, register_, release_, flush_
    return events


def reckon_prefix_hits(events, bs: int, bps: int, n_blocks: int):
    """The prefix hit (in tokens) each admission should get, from the order
    of admissions, registrations, releases and flushes alone: a content
    model of the pool's documented policy, keyed by the prompt tokens and
    mask of each leading run of blocks (not by the pool's digests). A
    prompt hits the longest registered run, at most (width - 1) // bs
    blocks; registered blocks that no slot holds stay warm until the free
    blocks run out, then go oldest first; a flush forgets every
    registration."""
    free, ids_next = n_blocks - 1, 0
    owner, key_of, ref, held = {}, {}, {}, {}
    warm = {}  # warm registered blocks, oldest first (dicts keep insertion order)
    expected = []

    def key(ver, ids, mask, j):
        return ver, ids[: (j + 1) * bs].tobytes(), mask[: (j + 1) * bs].tobytes()

    for ev in events:
        if ev[0] == "flush":
            free += len(warm)
            warm.clear()
            owner.clear()
            key_of.clear()
        elif ev[0] == "admit":
            _, slot, ver, ids, mask, _ = ev
            hits = []
            for j in range(min(bps, (len(ids) - 1) // bs)):
                b = owner.get(key(ver, ids, mask, j))
                if b is None:
                    break
                hits.append(b)
            for b in hits:
                warm.pop(b, None)
                ref[b] += 1
            private = []
            for _ in range(bps - len(hits)):
                if free:
                    free -= 1
                    b, ids_next = ids_next, ids_next + 1
                else:
                    b = next(iter(warm))
                    del warm[b], owner[key_of.pop(b)]
                ref[b] = 1
                private.append(b)
            held[slot] = hits + private
            expected.append(len(hits) * bs)
        elif ev[0] == "register":
            _, slot, ver, ids, mask = ev
            for j in range(len(ids) // bs):
                k, b = key(ver, ids, mask, j), held[slot][j]
                if k not in owner and b not in key_of:
                    owner[k], key_of[b] = b, k
        else:  # release
            for b in held.pop(ev[1]):
                ref[b] -= 1
                if ref[b] == 0:
                    if b in key_of:
                        warm[b] = None
                    else:
                        free += 1
    return expected


def check_live_pool(engine):
    """Row 10 against its plain version on the engine's own layer-0 int8
    pool, device block tables and cache mask, with a seeded query. The
    comparison's launch does not count as the path's."""
    from trlx_tpu_torch.ops.decode_attention import (
        paged_decode_attention_int8, paged_decode_attention_plain, paged_slot_decode_attention,
    )

    st, cfg = engine._state, engine.cfg
    kp, vp, ks, vs = st["cache"][0]
    tables, mask = st["block_tables"], st["cache_mask"]
    gen = torch.Generator(device=kp.device).manual_seed(11)
    q = torch.randn((engine.n_slots, cfg.n_head, cfg.head_dim), generator=gen, device=kp.device).to(torch.bfloat16)
    scale = cfg.head_dim ** -0.5
    n = paged_decode_attention_int8.launches
    out = paged_slot_decode_attention(q, kp, vp, tables, mask, scale=scale, ks=ks, vs=vs)
    paged_decode_attention_int8.launches = n
    ref = paged_decode_attention_plain(q, kp, vp, tables, torch.where(mask.bool(), 0.0, -1e9).float(), scale=scale,
                                       ks=ks, vs=vs)
    live = [i for i, m in enumerate(engine._slot_meta) if m is not None]
    blocks = engine.pool.tables[live].ravel()
    return {"max_abs_err": check("paged_decode_int8[live pool]", out, ref, 1e-2), "tol": 1e-2,
            "decode_call": engine._decode_calls + 1, "live_slots": len(live),
            "blocks_shared": int(blocks.size - np.unique(blocks).size)}


def engine_train_path(kernels):
    """The main path: ``trlx_tpu_torch.train(reward_fn=...)`` at GPT-J-6B
    full width and depth through the continuous-batching engine, paged
    (block 128, 8 slots, prefill batch 4, 8 steps per sync, the default pool
    of 65 blocks) with an int8 KV cache, on 16 prompts of which 8 share a
    512-token prefix, with ``train_config``'s method and optimizer values:
    16 PPO steps, two experience phases, a final evaluate(). Returns its
    numbers and the launches of the whole run."""
    import trlx_tpu_torch

    n_layer, k, R = GPTJ_6B_ARCH["n_layer"], 2, MAX_LEN - PROMPT_LEN
    spc = ENGINE["engine_steps_per_sync"]
    eng = {}

    def on_engine(engine):
        eng["engine"] = engine
        eng["events"] = record_pool_events(engine.pool)
        decode, stats = engine._decode, engine.stats

        def decode_():
            out = decode()
            if "live_pool" not in eng:
                live = [i for i, m in enumerate(engine._slot_meta) if m is not None]
                blocks = engine.pool.tables[live].ravel()
                if np.unique(blocks).size < blocks.size:  # two live slots share a prefix block
                    eng["live_pool"] = check_live_pool(engine)
            return out

        def stats_(reset=True):
            # The orchestrator reads the gauges once, when a phase has drained.
            engine.pool.leak_audit(expect_idle=True)
            eng["audits"] = eng.get("audits", 0) + 1
            return stats(reset)

        engine._decode, engine.stats = decode_, stats_

    cls = make_timed_trainer(kernels, n_layer, on_engine)
    run_dir = os.path.join(RUN_DIR, "engine_train")
    config = train_config(n_layer, cls.__name__, run_dir, method=dict(ENGINE, paged_kv=True), quant=True)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=engine_prompts(),
                                   eval_prompts=seeded_prompts(CHUNK, 1), config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if trainer._rollout_engine is not None:
        raise AssertionError("learn() did not shut the rollout engine down")

    exp = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "exp_time" in rec:
                exp.append({k_: v for k_, v in rec.items() if k_.startswith(("exp_", "rollout_", "engine/"))})
    if len(exp) != 2 or eng.get("audits") != 2:
        raise AssertionError(f"expected 2 experience phases and 2 leak audits, got {len(exp)} and {eng.get('audits')}")
    calls = sum(int(r["engine/decode_calls"]) for r in exp)
    # Each phase: 8 slots admitted at once, every episode 256 tokens (eos is
    # suppressed up to max_length), so two waves of R / steps_per_sync calls.
    if calls != 2 * 2 * R // spc:
        raise AssertionError(f"{calls} engine decode calls, reckoned {2 * 2 * R // spc}")

    steps = config.train.total_steps
    chunks = 2 * N_ROLLOUTS // CHUNK
    bwd_chunks = train_step_launches(kernels, n_layer)["fused_logprob_bwd_dx"]
    expected = dict.fromkeys(kernels, 0)
    expected.update({
        # Every decode step of every engine call, in every layer.
        "paged_decode_attention_int8": n_layer * spc * calls,
        # Unfused scoring (policy forward + branch replay) per chunk; the
        # train steps; the eval prefill. The paged suffix prefill is einsum.
        "flash_attention_fwd": chunks * (n_layer + k) + steps * 2 * n_layer + n_layer,
        "fused_logprob_fwd": chunks * 2 + steps,
        # evaluate() samples with the whole-batch sampler over the int8 cache.
        "decode_attention_int8": n_layer * R,
        "flash_attention_bwd_dq": steps * n_layer, "flash_attention_bwd_dkv": steps * n_layer,
        "fused_logprob_bwd_dx": steps * bwd_chunks, "fused_logprob_bwd_dw": steps,
    })
    got = [ev[5] for ev in eng["events"] if ev[0] == "admit"]
    pool = eng["engine"].pool
    want = reckon_prefix_hits(eng["events"], pool.block_size, pool.blocks_per_slot, pool.n_blocks)
    hits = {"hits": sum(1 for h in want if h), "tokens_saved": sum(want),
            "engine_hits": exp[-1]["engine/prefix_hits_total"],
            "engine_tokens_saved": exp[-1]["engine/prefill_tokens_saved_total"], "per_admission": got}
    log(f"[engine] prefix hits {json.dumps(hits)}")
    if got != want or (hits["hits"], hits["tokens_saved"]) != (hits["engine_hits"], hits["engine_tokens_saved"]):
        raise AssertionError(f"prefix hits per admission {got} (engine totals {hits['engine_hits']}, "
                             f"{hits['engine_tokens_saved']}) != reckoned {want}")
    if not hits["hits"]:
        raise AssertionError("no prefix hit on prompts that share a 512-token prefix")
    if "live_pool" not in eng:
        raise AssertionError("no decode call ran with two live slots sharing a block: the live-pool check never ran")

    log_ = check_train_steps(trainer, config, train_step_launches(kernels, n_layer))
    cols = trainer.store.columns()
    if len(trainer.store) != N_ROLLOUTS:
        raise AssertionError(f"store holds {len(trainer.store)} rows, expected {N_ROLLOUTS}")
    for key_, col in cols.items():
        if col.shape[0] != N_ROLLOUTS or not np.isfinite(col).all():
            raise AssertionError(f"store {key_}: shape {col.shape} or non-finite values")

    engine = eng["engine"]
    cfg = trainer.model.cfg
    per_token = 2 * cfg.n_head * cfg.head_dim + 2 * cfg.n_head * 4  # int8 K and V, f32 scales, per layer
    dev_s = [r["device_s"] for r in log_]
    out = {
        "wall_s": wall,
        "peak_mem_gb": peak_gb,
        "decode_tokens_per_s": [r["engine/decode_tokens_per_s"] for r in exp],
        "slot_occupancy": [r["engine/slot_occupancy"] for r in exp],
        "decode_calls": calls,
        "prefix_hits": hits["hits"],
        "prefill_tokens_saved": hits["tokens_saved"],
        "pool_bytes": engine.n_blocks * engine.block_size * per_token * cfg.n_layer,
        "fixed_layout_bytes": engine.n_slots * engine.cache_len * per_token * cfg.n_layer,
        "live_pool_check": eng["live_pool"],
        "step_device_s_median": float(np.median(dev_s)),
        "mean_ratio_per_step": [r["mean_ratio"] for r in log_],
        "experience": exp,
        "eval": dict(trainer.eval_log[0]),
        "launches": launches,
    }
    log(f"[engine] trlx_tpu_torch.train through the paged int8 engine at GPT-J-6B ({n_layer} layers), "
        f"{steps} steps: {json.dumps(out)}")
    log(f"[engine] launches {launches} expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    before_eval = trainer.launches_before_eval
    if any(before_eval[n] for n in ("decode_attention", "decode_attention_int8", "paged_decode_attention")):
        raise AssertionError(f"rows 7-9 launched before evaluate(): {before_eval}")

    del trainer, engine, eng
    free()
    return out, launches


def engine_rollout_path(kernels, paged: bool):
    """``make_experience(16)`` through the engine with a bf16 cache, greedy,
    at GPT-J-6B width and 4 layers, on the engine path's prompts: paged
    (row 9, einsum suffix prefill) or fixed slots (row 7, flash prefill at
    offset 0). Returns the responses by prompt, its numbers and launches."""
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    n_layer, k, R = 4, 2, MAX_LEN - PROMPT_LEN
    spc = ENGINE["engine_steps_per_sync"]
    name = "engine_paged_bf16" if paged else "engine_fixed_bf16"
    trainer = PPOTrainer(smoke_config(n_layer=n_layer, run=name, greedy=True, paged_kv=paged, **ENGINE))
    orch = PPOOrchestrator(trainer, PromptPipeline(engine_prompts(), None, max_prompt_length=PROMPT_LEN),
                           reward_fn=reward_fn, chunk_size=CHUNK)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = orch.make_experience(N_ROLLOUTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    calls, prefills = int(stats["engine/decode_calls"]), int(stats["engine/prefill_batches"])
    if calls != 2 * R // spc:
        raise AssertionError(f"{name}: {calls} decode calls, reckoned {2 * R // spc}")
    chunks = N_ROLLOUTS // CHUNK
    expected = dict.fromkeys(kernels, 0)
    expected.update({
        "paged_decode_attention" if paged else "decode_attention": n_layer * spc * calls,
        "flash_attention_fwd": (0 if paged else prefills * n_layer) + chunks * (n_layer + k),
        "fused_logprob_fwd": chunks * 2,
    })
    cols = trainer.store.columns()
    responses = {tuple(q.tolist()): r for q, r in zip(cols["query_tensors"], cols["response_tensors"])}
    out = {"wall_s": wall, "decode_tokens_per_s": stats["engine/decode_tokens_per_s"],
           "slot_occupancy": stats["engine/slot_occupancy"], "prefill_calls": prefills,
           "prefix_hits": stats.get("engine/prefix_hits_total"), "launches": launches}
    log(f"[{name}] make_experience({N_ROLLOUTS}) at GPT-J-6B width, {n_layer} layers: {json.dumps(out)}")
    log(f"[{name}] launches {launches} expected {expected} ({prefills} prefill calls)")
    if launches != expected:
        raise AssertionError(f"{name}: kernel launches {launches} != {expected}")
    del trainer, orch
    free()
    return responses, out, launches


ILQL_STEPS = 4
ILQL_SAMPLES = 16
F32_HEAD_KERNELS = ("logprob_fwd_f32_kernel", "logprob_ds_f32_kernel", "logprob_dx_f32_kernel",
                    "logprob_dw_f32_kernel")


def ilql_config(n_layer: int, model_type: str, run_dir: str, **arch):
    """The ILQL path's config: GPT-J-6B (depth ``n_layer``), remat, 2
    unfrozen layers, bf16 over f32 masters, with the method and optimizer
    values of trlx_tpu/configs/ilql_config.yml (tau 0.7, gamma 0.99, CQL
    0.1, AWAC 1, alpha 0.005, a target sync every step, beta 16, two Q
    heads; lr 1e-4 with a 100-step ramp), the smoke's 768 + 256 lengths for
    eval (eos off), batch 4, one epoch of ``ILQL_STEPS`` steps."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type=model_type, num_layers_unfrozen=2,
                      model_arch=dict(GPTJ_6B_ARCH, n_layer=n_layer, **arch), dtype="bfloat16",
                      param_dtype="float32", remat=True),
        "train": dict(total_steps=ILQL_STEPS, seq_length=MAX_LEN, epochs=1, batch_size=ILQL_BATCH,
                      lr_ramp_steps=100, lr_decay_steps=3366, weight_decay=1e-6, learning_rate_init=1e-4,
                      learning_rate_target=1e-4, opt_betas=[0.9, 0.95], grad_clip=1.0, checkpoint_interval=10**6,
                      eval_interval=10**6, checkpoint_dir=run_dir, seed=1000, orchestrator="OfflineOrchestrator"),
        "method": dict(name="ilqlconfig", tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, alpha=0.005,
                       steps_for_target_q_sync=1, betas=[16], two_qs=True,
                       gen_kwargs=dict(prompt_length=PROMPT_LEN, max_new_tokens=MAX_LEN - PROMPT_LEN,
                                       eos_token_id=None)),
    })


def ilql_dataset(n: int, seed: int):
    """``n`` seeded token-array samples of MAX_LEN tokens and seeded rewards."""
    rng = np.random.default_rng(seed)
    V = GPTJ_6B_ARCH["vocab_size"]
    return ([rng.integers(0, V, size=MAX_LEN).astype(np.int32) for _ in range(n)],
            rng.normal(size=(n,)).astype(np.float32).tolist())


def ilql_groups(model):
    """Parameter name → group: wte, each block, ln_f, lm_head, v_head and
    each Q head."""
    def group(name):
        parts = name.split(".")
        return parts[1] if parts[0] == "transformer" else parts[0]
    return {n: group(n) for n, _ in model.named_parameters()}


def phase_ilql_grad_consistency(kernels):
    """One ILQL batch's loss and gradients at GPT-J-6B width and 2 layers
    (b = 4, T = 1024), on the kernel route (flash attention, the fused LM
    head for AWAC, the f32 fused head for each online Q head) and on the
    plain route (einsum attention, materialized logits and Q tensors), from
    the same seeded weights, targets and batch. The kernel route must run
    the f32 kernels (2 heads x (1 forward, 4 ds + dx chunks, 1 dW))."""
    from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    n_layer = 2
    routes = {"kernel": {}, "plain": {"attn_impl": "xla", "extra": dict(GPTJ_6B_ARCH["extra"], fused_logprob="off")}}
    samples, rewards = ilql_dataset(ILQL_BATCH, seed=8)
    chunks = -(-F32_SHAPE[0] // 1024)
    want_f32 = {"fused_logprob_fwd_f32": 2, "fused_logprob_bwd_dx_f32": 2 * chunks, "fused_logprob_bwd_dw_f32": 2}
    out = {}
    for route, arch in routes.items():
        trainer = ILQLTrainer(ilql_config(n_layer, "ilql", os.path.join(RUN_DIR, "ilql_grad_" + route), **arch))
        if trainer.use_fused() != (route == "kernel"):
            raise AssertionError(f"ILQL {route} route: use_fused() is {trainer.use_fused()}")
        OfflineOrchestrator(trainer).make_experience(samples, rewards)
        batch = trainer.put_batch(next(iter(trainer.store.create_loader(ILQL_BATCH, shuffle=False))))
        trainer.build_train_step()

        def loss_and_backward():
            loss, stats = trainer._loss_fn(batch)
            loss.backward()
            return loss, stats

        (loss, stats), launches = launches_of(kernels, loss_and_backward)
        f32 = {k: launches.get(k, 0) for k in want_f32}
        if f32 != (want_f32 if route == "kernel" else dict.fromkeys(want_f32, 0)):
            raise AssertionError(f"ILQL {route} route launched the f32 kernels {f32}")
        groups = ilql_groups(trainer.model)
        grads = {}
        for name, p in trainer.model.named_parameters():
            if p.requires_grad:
                grads.setdefault(groups[name], []).append(p.grad.float().reshape(-1))
        out[route] = ({k: float(v) for k, v in stats.items()}, {g: torch.cat(v) for g, v in grads.items()})
        del trainer, loss, stats, grads, batch
        free()
    (sk, gk), (sp, gp) = out["kernel"], out["plain"]
    cos = {g: float(torch.nn.functional.cosine_similarity(gk[g].double(), gp[g].double(), dim=0)) for g in gk}
    rel = {k: abs(sk[k] - sp[k]) / max(abs(sp[k]), 1e-12) for k in sk}
    res = {"stats_kernel": sk, "stats_plain": sp, "rel_diff": rel, "cosine": cos}
    log(f"[ilql-grad] kernel vs plain route, GPT-J-6B width, {n_layer} layers, b = {ILQL_BATCH}: {json.dumps(res)}")
    bad = {k: v for k, v in rel.items() if not v <= 1e-2}
    if bad:
        raise AssertionError(f"ILQL loss terms differ by more than 1e-2 relative: {bad}")
    low = {g: c for g, c in cos.items() if not c >= 0.99}
    if low:
        raise AssertionError(f"ILQL gradient cosine below 0.99: {low}")
    return res


def make_timed_ilql_trainer(kernels):
    """An ILQLTrainer, registered under its own name, that records per train
    step its device time (CUDA events), launches and stats, profiles the
    last step (kernel time by class, the Q heads' f32 kernels apart, and
    the traced launches held against the counters), holds a fixed sampled
    slice of every target tensor against alpha·online + (1 − alpha)·target
    after each Polyak sync, and fingerprints the heads at the start."""
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    @register_model("SmokeTimedILQLTrainer")
    class SmokeTimedILQLTrainer(ILQLTrainer):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            self.step_log, self.syncs, self.eval_log = [], [], []
            self.profiled = None
            self.fp = {"start": self.head_fingerprints()}
            gen = torch.Generator(device=self.device).manual_seed(13)
            self.slice_ix = {n: torch.randint(0, t.numel(), (4096,), generator=gen, device=self.device)
                             for n, t in self.extras.items()}

        def head_fingerprints(self):
            own = dict(self.model.named_parameters())
            return {"online": fingerprint([own[n] for n in self.extras]), "target": fingerprint(self.extras.values())}

        def train_step(self, batch):
            before = {n: f.launches for n, f in kernels.items()}
            last = self.step == ILQL_STEPS - 1
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if last else None
            if prof is not None:
                torch.cuda.synchronize()
                prof.__enter__()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            stats = super().train_step(batch)
            end.record()
            torch.cuda.synchronize()
            rec = {k: float(v) for k, v in stats.items()}
            rec["device_s"] = start.elapsed_time(end) / 1e3
            rec["launches"] = {n: f.launches - before[n] for n, f in kernels.items()}
            if prof is not None:
                prof.__exit__(None, None, None)
                events, traced = trace_launches(prof, rec["launches"])
                total = sum(e.self_device_time_total for e in events) / 1e3
                q_heads = sum(e.self_device_time_total for e in events
                              if any(k in e.key for k in F32_HEAD_KERNELS)) / 1e3
                self.profiled = {"step": self.step, "device_s": rec["device_s"], "kernel_ms": total,
                                 "q_head_f32_kernel_ms": q_heads, "q_head_share_of_kernels": q_heads / total,
                                 "q_head_share_of_step": q_heads / (rec["device_s"] * 1e3),
                                 "busy_share": total / (rec["device_s"] * 1e3),
                                 "traced": traced}
            self.step_log.append(rec)
            return stats

        def _polyak_sync(self):
            own = dict(self.model.named_parameters())
            prev = {n: self.extras[n].reshape(-1)[ix].double() for n, ix in self.slice_ix.items()}
            online = {n: own[n].detach().reshape(-1)[ix].double() for n, ix in self.slice_ix.items()}
            super()._polyak_sync()
            alpha = float(self.config.method.alpha)
            worst = 0.0
            for n, ix in self.slice_ix.items():
                got = self.extras[n].reshape(-1)[ix].double()
                want = alpha * online[n] + (1 - alpha) * prev[n]
                # f32 rounding: a few ulps of the larger operand.
                tol = 4 * 2.0 ** -23 * (online[n].abs() + prev[n].abs()) + 1e-45
                ratio = float(((got - want).abs() / tol).max())
                if not ratio <= 1.0:
                    raise AssertionError(f"Polyak sync after step {self.iter_count}: {n} is "
                                         f"{ratio:.2f} x its f32 tolerance from alpha·online + (1 − alpha)·target")
                worst = max(worst, ratio)
            self.syncs.append({"step": self.iter_count, "worst_error_over_tol": worst})

        def evaluate(self):
            self.launches_before_eval = {n: f.launches for n, f in kernels.items()}
            stats = super().evaluate()
            self.eval_log.append(stats)
            return stats

    return SmokeTimedILQLTrainer


def ilql_step_launches(kernels, n_layer: int):
    """Kernel launches of one ILQL train step at b = 4, T = 1024: the flash
    forward twice per layer (remat), its backward once per layer (wte
    trains, so the backward runs through every block), the bf16 fused LM
    head for AWAC (forward once, ds + dx once per 1024-row chunk of the 4092
    rows, dW once), and per Q head the f32 fused head (the same counts)."""
    chunks = -(-F32_SHAPE[0] // 1024)
    out = dict.fromkeys(kernels, 0)
    out.update({"flash_attention_fwd": 2 * n_layer, "flash_attention_bwd_dq": n_layer,
                "flash_attention_bwd_dkv": n_layer, "fused_logprob_fwd": 1, "fused_logprob_bwd_dx": chunks,
                "fused_logprob_bwd_dw": 1, "fused_logprob_fwd_f32": 2, "fused_logprob_bwd_dx_f32": 2 * chunks,
                "fused_logprob_bwd_dw_f32": 2})
    return out


def ilql_train_path(kernels):
    """``trlx_tpu_torch.train(dataset=...)`` at GPT-J-6B full width and
    depth: 16 seeded token-array samples of 1024 tokens with seeded rewards,
    batch 4, one epoch of 4 steps with a Polyak sync after each, then
    ``evaluate()`` of 4 prompts of 768 tokens, 256 new tokens (eos off)
    steered by the target heads on the chunked sampler's graph. Returns its
    numbers and the launches of the whole run."""
    import trlx_tpu_torch

    n_layer, R = GPTJ_6B_ARCH["n_layer"], MAX_LEN - PROMPT_LEN
    cls = make_timed_ilql_trainer(kernels)
    run_dir = os.path.join(RUN_DIR, "ilql_train")
    config = ilql_config(n_layer, cls.__name__, run_dir)
    samples, rewards = ilql_dataset(ILQL_SAMPLES, seed=7)
    rng = np.random.default_rng(12)
    eval_prompts = [rng.integers(0, GPTJ_6B_ARCH["vocab_size"], size=PROMPT_LEN).tolist() for _ in range(ILQL_BATCH)]
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=eval_prompts, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_step = ilql_step_launches(kernels, n_layer)
    expected = {k: ILQL_STEPS * v for k, v in per_step.items()}
    expected["flash_attention_fwd"] += n_layer  # the eval prefill
    expected["decode_attention"] += n_layer * R  # the eval decode, replayed as a graph
    log(f"[ilql] launches {launches} expected {expected} (per train step {per_step}; eval: flash {n_layer}, "
        f"decode {n_layer}x{R})")
    if launches != expected:
        raise AssertionError(f"ILQL kernel launches {launches} != {expected}")
    log_ = trainer.step_log
    if len(log_) != ILQL_STEPS or trainer.iter_count != ILQL_STEPS:
        raise AssertionError(f"{len(log_)} ILQL steps recorded, iter_count {trainer.iter_count}")
    for i, rec in enumerate(log_):
        if rec["launches"] != per_step:
            raise AssertionError(f"ILQL step {i + 1} launched {rec['launches']}, expected {per_step}")
        bad = [k for k, v in rec.items() if k != "launches" and not np.isfinite(v)]
        if bad or rec["resilience/nonfinite"] != 0.0:
            raise AssertionError(f"ILQL step {i + 1}: non-finite {bad} or a guard skip")
    if [x["step"] for x in trainer.syncs] != list(range(1, ILQL_STEPS + 1)):
        raise AssertionError(f"Polyak syncs after steps {[x['step'] for x in trainer.syncs]}, expected every step")
    end = trainer.head_fingerprints()
    moved = {k: end[k] != trainer.fp["start"][k] for k in end}
    if not all(moved.values()):
        raise AssertionError(f"heads unchanged by training: {moved}")
    if len(trainer.eval_log) != 1:
        raise AssertionError(f"expected one evaluate(), got {len(trainer.eval_log)}")
    hist = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "histogram" in rec:
                hist.append(rec)
    if sorted(r["histogram"] for r in hist) != ["decode/adv", "decode/qs", "decode/vs"] or any(
            r["count"] != ILQL_BATCH * R or not np.isfinite(r["mean"]) for r in hist):
        raise AssertionError(f"decode statistics: {hist}")
    dev_s = [r["device_s"] for r in log_]
    out = {
        "wall_s": wall,
        "step_device_s": dev_s,
        "step_device_s_median_unprofiled": float(np.median(dev_s[:-1])),
        "train_tokens_per_s": ILQL_BATCH * MAX_LEN / float(np.median(dev_s[:-1])),
        "peak_mem_gb": peak_gb,
        "profiled_step": trainer.profiled,
        "stats_per_step": [{k: v for k, v in r.items() if k.startswith("losses/") or k == "grad_norm"}
                           for r in log_],
        "polyak_syncs": trainer.syncs,
        "decode_stats": {r["histogram"]: {k: r[k] for k in ("count", "mean", "std")} for r in hist},
        "eval": trainer.eval_log[0],
        "launches": launches,
    }
    log(f"[ilql] trlx_tpu_torch.train(dataset=...) at GPT-J-6B ({n_layer} layers), {ILQL_STEPS} steps: "
        f"{json.dumps(out)}")
    prof = trainer.profiled
    log(f"[ilql] step device time {out['step_device_s_median_unprofiled']:.4f} s (median of steps 1-"
        f"{ILQL_STEPS - 1}), peak {peak_gb:.2f} GB, Q-head f32 kernels {prof['q_head_f32_kernel_ms']:.1f} ms "
        f"= {prof['q_head_share_of_step']:.3f} of the profiled step ({prof['device_s']:.4f} s)")
    del trainer
    free()
    return out, launches


GRAPH_LAYERS = 4  # depth of the graph-versus-eager phase, at GPT-J-6B width


# The port's device kernels, by a substring of their names, and the wrappers
# each counted launch of which launches that kernel once (the four decode
# wrappers share one kernel template).
DECODE_WRAPPERS = ("decode_attention", "decode_attention_int8", "paged_decode_attention",
                   "paged_decode_attention_int8")
DEVICE_KERNELS = {
    "flash_fwd_kernel": ("flash_attention_fwd",),
    "flash_bwd_dq_kernel": ("flash_attention_bwd_dq",),
    "flash_bwd_dkv_kernel": ("flash_attention_bwd_dkv",),
    "logprob_fwd_kernel": ("fused_logprob_fwd",),
    "logprob_ds_kernel": ("fused_logprob_bwd_dx",),
    "logprob_dx_kernel": ("fused_logprob_bwd_dx",),
    "logprob_dw_kernel": ("fused_logprob_bwd_dw",),
    "logprob_fwd_f32_kernel": ("fused_logprob_fwd_f32",),
    "logprob_ds_f32_kernel": ("fused_logprob_bwd_dx_f32",),
    "logprob_dx_f32_kernel": ("fused_logprob_bwd_dx_f32",),
    "logprob_dw_f32_kernel": ("fused_logprob_bwd_dw_f32",),
    "decode_split_kernel": DECODE_WRAPPERS,
    "decode_merge_kernel": DECODE_WRAPPERS,
}


def port_kernels():
    """The kernel wrappers of the thirteen rows, by row name."""
    from trlx_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_int8, paged_decode_attention, paged_decode_attention_int8,
    )
    from trlx_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from trlx_tpu_torch.ops.fused_logprob import (
        fused_logprob_bwd_dw, fused_logprob_bwd_dw_f32, fused_logprob_bwd_dx, fused_logprob_bwd_dx_f32,
        fused_logprob_fwd, fused_logprob_fwd_f32,
    )

    return {"flash_attention_fwd": flash_fwd, "flash_attention_bwd_dq": flash_bwd_dq,
            "flash_attention_bwd_dkv": flash_bwd_dkv, "decode_attention": decode_attention,
            "fused_logprob_fwd": fused_logprob_fwd, "fused_logprob_bwd_dx": fused_logprob_bwd_dx,
            "fused_logprob_bwd_dw": fused_logprob_bwd_dw, "decode_attention_int8": decode_attention_int8,
            "paged_decode_attention": paged_decode_attention,
            "paged_decode_attention_int8": paged_decode_attention_int8,
            "fused_logprob_fwd_f32": fused_logprob_fwd_f32, "fused_logprob_bwd_dx_f32": fused_logprob_bwd_dx_f32,
            "fused_logprob_bwd_dw_f32": fused_logprob_bwd_dw_f32}


def traced_kernel_ms(kernels, fn):
    """fn()'s result, the CUDA kernel milliseconds it ran and what the trace
    shows of the port's launches (torch.profiler): the launches by kernel
    and the device records the trace proves it lost (``trace_launches``).
    The traced launches must equal what the wrappers' counters added in the
    same run, short of no more than those lost records, so a count that a
    graph replay adds is one the card really ran; raises otherwise, or when
    the trace shows none of the port's kernels."""
    before = {n: f.launches for n, f in kernels.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counted = {n: f.launches - before[n] for n, f in kernels.items()}
    events, traced = trace_launches(prof, counted)
    us = sum(e.self_device_time_total for e in events)
    return out, us / 1e3, traced


def trace_launches(prof, counted):
    """The device events of a finished profile (``key_averages``) and what
    it shows of the port's launches: ``traced_launches`` held against the
    wrappers' ``counted`` launches, with the records the trace proves lost
    (``lost_device_records``) beside them."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    lost = lost_device_records(prof.profiler.kineto_results.events())
    return events, {"launches": traced_launches(events, counted, lost["lost"]), **lost}


def lost_device_records(raw):
    """The device records that a trace's own API records prove missing, from
    kineto's raw events (each with ``name()``, ``device_type()`` and
    ``correlation_id()``). The profiler on the card drops device records,
    a few or a burst of them, in most long traces while it keeps every host
    API record: a kernel launch whose correlation id has no device record
    lost its kernel, and a graph launch lost as many as it has fewer than
    the fullest launch of the trace (each trace this script takes replays
    one graph)."""
    device = {}
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device[e.correlation_id()] = device.get(e.correlation_id(), 0) + 1
    kernel_launches, graph_launches = [], []
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        if "GraphLaunch" in e.name():
            graph_launches.append(device.get(e.correlation_id(), 0))
        elif "LaunchKernel" in e.name() or "LaunchCooperativeKernel" in e.name():
            kernel_launches.append(device.get(e.correlation_id(), 0))
    full = max(graph_launches, default=0)
    lost = sum(n == 0 for n in kernel_launches) + sum(full - n for n in graph_launches)
    return {"lost": lost, "kernel_launch_records": len(kernel_launches), "graph_launch_records": len(graph_launches),
            "device_records_per_graph_launch": [min(graph_launches, default=0), full]}


def traced_launches(events, counted, lost: int = 0):
    """The launches of the port's kernels among profiler ``events`` (each
    with a ``key``, the kernel's name, and a ``count``), by device kernel;
    raises unless they equal what the wrapper ``counted`` launches give, or
    when there are none. A trace that proves ``lost`` device records missing
    may fall short of the counts by no more than those in all, and may
    exceed none. PyTorch's own flash kernels share a name and are left
    out."""
    traced = {k: sum(e.count for e in events if k in e.key and "pytorch" not in e.key) for k in DEVICE_KERNELS}
    want = {k: sum(counted.get(n, 0) for n in names) for k, names in DEVICE_KERNELS.items()}
    short = sum(want[k] - traced[k] for k in want)
    if any(traced[k] > want[k] for k in want) or short > lost or not any(traced.values()):
        raise AssertionError(f"kernel launches in the trace {traced} != the wrappers' counts {want} "
                             f"(the trace proves {lost} device records lost)")
    return {k: v for k, v in traced.items() if v}


def wall_ms_of(fn):
    """fn()'s result and its host milliseconds, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def launches_of(kernels, fn):
    """fn()'s result and the kernel launches it counted."""
    before = {n: f.launches for n, f in kernels.items()}
    out = fn()
    return out, {n: f.launches - before[n] for n, f in kernels.items() if f.launches != before[n]}


def optimizer_step(trainer, seed: int):
    """One ClippedAdamW step (lr 1e-2, large enough that greedy tokens
    change) of the trainer's trainable weights with seeded gradients: every
    trained weight (two blocks, embeddings, the heads) changes in place, as
    after a PPO step."""
    from trlx_tpu_torch.trainer.base import ClippedAdamW

    dev = trainer.trainable[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen, device=dev) for p in trainer.trainable]
    ClippedAdamW(trainer.trainable, lambda k: 1e-2, 0.9, 0.95, 0.0, 1.0).step(trainer.trainable, grads)


def graph_chunked(kernels):
    """The chunked sampler, eager against graph replay, at GPT-J-6B width
    and ``GRAPH_LAYERS`` layers: one chunk of 8 prompts through the fused
    rollout generation (256 new tokens), greedy, then again after an
    optimizer step, then sampled from equal generator states. Tokens, masks
    and stats must be bit-equal and the launches equal; each route's wall
    and kernel ms per call (prefill included) give its busy share."""
    from dataclasses import replace
    from functools import partial

    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    trainer = PPOTrainer(smoke_config(n_layer=GRAPH_LAYERS, run="graph_chunked", greedy=True))
    pipe = PromptPipeline(seeded_prompts(CHUNK, 9), None, max_prompt_length=trainer.prompt_length)
    ids, mask = trainer.put(pipe.input_ids), trainer.put(pipe.attention_mask)
    base = trainer._generate_fused_fn

    def bound_fn(eager, **kw):
        return partial(base.func, *base.args, **{**base.keywords, "_keep": {}, "_eager": eager, **kw})

    fns = {"eager": bound_fn(True), "graph": base}

    def same(a, b):
        (ta, ma, sa, _), (tb, mb, sb, _) = a, b
        return torch.equal(ta, tb) and torch.equal(ma, mb) and all(torch.equal(sa[k], sb[k]) for k in sa)

    out, res = {}, {}
    for route, fn in fns.items():
        # The graph route captures in its first call.
        (res[route], launches), first = wall_ms_of(lambda: launches_of(kernels, lambda: fn(ids, mask, None)))
        _, wall = wall_ms_of(lambda: fn(ids, mask, None))
        _, kern, traced = traced_kernel_ms(kernels, lambda: fn(ids, mask, None))
        out[route] = {"launches": launches, "first_call_wall_ms": first, "wall_ms": wall, "kernel_ms": kern,
                      "busy_share": kern / wall, "traced": traced}
    if not same(res["eager"], res["graph"]):
        raise AssertionError("chunked sampler: graph tokens / masks / stats differ from eager")
    if out["eager"]["launches"] != out["graph"]["launches"]:
        raise AssertionError(f"chunked sampler launches: eager {out['eager']['launches']} != graph "
                             f"{out['graph']['launches']}")
    optimizer_step(trainer, 21)
    after = {route: fn(ids, mask, None) for route, fn in fns.items()}
    if not same(after["eager"], after["graph"]):
        raise AssertionError("chunked sampler: after an optimizer step, graph tokens differ from eager")
    out["after_step_rows_changed"] = int((after["graph"][0] != res["graph"][0]).any(1).sum())
    if not out["after_step_rows_changed"]:
        raise AssertionError("chunked sampler: no token changed after the optimizer step: the check sees nothing")
    sampled = replace(trainer.gen_cfg, do_sample=True)
    gens = {route: trainer.chunk_rng(5) for route in fns}
    drawn = {route: bound_fn(route == "eager", gcfg=sampled)(ids, mask, gens[route]) for route in fns}
    if not same(drawn["eager"], drawn["graph"]):
        raise AssertionError("chunked sampler: sampled graph tokens differ from eager from the same generator state")
    if not torch.equal(gens["eager"].get_state(), gens["graph"].get_state()):
        raise AssertionError("chunked sampler: the graph route left the caller's generator in another state")
    del trainer, base, fns, res, after, drawn
    free()
    return out


def graph_engine(kernels):
    """The paged int8 engine (the main path's: 8 slots, block 128, 8 steps a
    call), eager against graph replay, at GPT-J-6B width and
    ``GRAPH_LAYERS`` layers: 8 prompts of the engine path filling the slots,
    drained, greedy; then again after an optimizer step (a new weight
    version); then sampled from equal generator states. Episodes must be
    bit-equal and the launches equal. Each route's wall ms per decode call
    (host clock, ending in its sync) and kernel ms per call (profiler, 2
    calls) give its busy share."""
    from dataclasses import replace

    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    trainer = PPOTrainer(smoke_config(quant=True, n_layer=GRAPH_LAYERS, run="graph_engine", greedy=True,
                                      paged_kv=True, **ENGINE))
    pipe = PromptPipeline(engine_prompts()[:ENGINE["engine_slots"]], None, max_prompt_length=trainer.prompt_length)

    def make(route, gcfg):
        return RolloutEngine(trainer.model, gcfg, n_slots=ENGINE["engine_slots"], prompt_width=PROMPT_LEN,
                             processor=trainer._gen_processor, prefill_batch=ENGINE["prefill_batch"],
                             steps_per_sync=ENGINE["engine_steps_per_sync"], paged_kv=True,
                             kv_block_size=ENGINE["kv_block_size"], generator=trainer.seeded_generator(3),
                             _eager=route == "eager")

    def drain(engine, version, timed=False):
        engine.update_weights(trainer.model, version=version)
        engine.submit(pipe.input_ids, pipe.attention_mask)
        eps, first = wall_ms_of(engine.step)  # admission, and the first call (the graph captures here)
        t = {"first_step_wall_ms": first}
        if timed:
            walls = [wall_ms_of(lambda: eps.extend(engine.step()))[1] for _ in range(3)]
            _, kern, traced = traced_kernel_ms(kernels, lambda: [eps.extend(engine.step()) for _ in range(2)])
            if eps:
                raise AssertionError("engine: an episode finished inside the measured calls")
            t.update(wall_ms_per_call=float(np.median(walls)), wall_ms_runs=walls, kernel_ms_per_call=kern / 2,
                     traced_two_calls=traced)
            t["busy_share"] = t["kernel_ms_per_call"] / t["wall_ms_per_call"]
        while not engine.idle:
            eps.extend(engine.step())
        return {tuple(e.prompt_ids.tolist()): e.response_ids for e in eps}, t

    def same(a, b):
        return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)

    out, first, second = {}, {}, {}
    engines = {route: make(route, trainer.gen_cfg) for route in ("eager", "graph")}
    for route, engine in engines.items():
        (first[route], t), launches = launches_of(kernels, lambda: drain(engine, 0, timed=True))
        out[route] = {"launches": launches, **t}
    if not same(first["eager"], first["graph"]):
        raise AssertionError("engine: graph episodes differ from eager")
    if out["eager"]["launches"] != out["graph"]["launches"]:
        raise AssertionError(f"engine launches: eager {out['eager']['launches']} != graph {out['graph']['launches']}")
    optimizer_step(trainer, 22)
    for route, engine in engines.items():
        second[route], _ = drain(engine, 1)
        engine.shutdown()
    if not same(second["eager"], second["graph"]):
        raise AssertionError("engine: after an optimizer step, graph episodes differ from eager")
    out["after_step_rows_changed"] = sum(not np.array_equal(second["graph"][k], first["graph"][k])
                                         for k in first["graph"])
    if not out["after_step_rows_changed"]:
        raise AssertionError("engine: no token changed after the optimizer step: the check sees nothing")
    sampled = replace(trainer.gen_cfg, do_sample=True)
    drawn = {}
    for route in ("eager", "graph"):
        engine = make(route, sampled)
        drawn[route], _ = drain(engine, 2)
        engine.shutdown()
    if not same(drawn["eager"], drawn["graph"]):
        raise AssertionError("engine: sampled graph episodes differ from eager from the same generator state")
    del trainer, engines
    free()
    return out


def phase_graph(kernels):
    """Decode replayed as a CUDA graph against eager launches, through the
    chunked sampler and the paged int8 engine."""
    out = {"chunked": graph_chunked(kernels), "engine": graph_engine(kernels)}
    for path, r in out.items():
        for route in ("eager", "graph"):
            x = r[route]
            wall = x.get("wall_ms", x.get("wall_ms_per_call"))
            kern = x.get("kernel_ms", x.get("kernel_ms_per_call"))
            log(f"[graph] {path} ({GRAPH_LAYERS} layers) {route}: wall {wall:.2f} ms, kernels {kern:.2f} ms per "
                f"{'call' if path == 'chunked' else 'decode call'}, busy {x['busy_share']:.3f}")
    log(f"[graph] graph vs eager, bit-equal tokens and equal launches: {json.dumps(out)}")
    return out


def compare_greedy(paged, fixed):
    """Share of identical response tokens between the paged and fixed-slot
    engines, and each row's first divergence (reported, not gated: their
    prefills take einsum and flash)."""
    if set(paged) != set(fixed):
        raise AssertionError("the paged and fixed engines returned different prompts")
    same = [paged[q] == fixed[q] for q in sorted(fixed)]
    first = [int(np.argmin(s)) if not s.all() else None for s in same]
    return {"identical_token_share": float(np.mean(np.concatenate(same))), "first_divergence_per_row": first}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trlx_tpu_torch.ops import cuda_lib

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
        if any(w in ln for w in ("Compiling entry function", "registers", "spill", "Performance Loss")):
            log(f"[build] {ln.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    phases = {}
    for name, fn in (("flash_prefill", lambda: phase_flash(gen, PROMPT_LEN, ragged=True)),
                     ("flash_branch_replay", lambda: phase_flash(gen, MAX_LEN, ragged=False)),
                     ("decode", lambda: phase_decode(gen)),
                     ("decode_int8", lambda: phase_decode_int8(gen, phases["decode"].pop("valid"))),
                     ("paged_decode", lambda: phase_paged(gen, quant=False)),
                     ("paged_decode_int8", lambda: phase_paged(gen, quant=True)),
                     ("fused_logprob", lambda: phase_logprob(gen)),
                     ("flash_bwd", lambda: phase_flash_bwd(gen)),
                     ("fused_logprob_bwd", lambda: phase_logprob_bwd(LOGPROB_BWD_SEED)),
                     ("fused_logprob_f32", lambda: phase_logprob_f32(F32_SEED)),
                     ("fused_logprob_bwd_f32", lambda: phase_logprob_bwd_f32(F32_SEED))):
        t0 = time.perf_counter()
        phases[name] = fn()
        free()
        shown = {k: v for k, v in phases[name].items() if k != "valid"}
        log(f"[kernel] {name} ({time.perf_counter() - t0:.1f}s): {json.dumps(shown)}")
    for name in ("flash_bwd", "fused_logprob_bwd", "fused_logprob_bwd_f32"):
        phases.update(phases.pop(name))

    kernels = port_kernels()
    by_path = {}

    def run(path, fn):
        t0 = time.perf_counter()
        out = fn()
        by_path[path] = out[-1]
        free()
        log(f"[{path}] done in {time.perf_counter() - t0:.1f}s")
        return out

    # ILQL first: its step nears the card's memory, so it gets the allocator fresh.
    run("ilql_train", lambda: ilql_train_path(kernels))
    run("rollout_bf16", lambda: main_path(kernels))
    run("rollout_int8", lambda: main_path(kernels, quant=True))
    paged, _, _ = run("engine_paged_bf16", lambda: engine_rollout_path(kernels, paged=True))
    fixed, _, _ = run("engine_fixed_bf16", lambda: engine_rollout_path(kernels, paged=False))
    log(f"[engine] greedy tokens, paged vs fixed slots (bf16, 4 layers): {json.dumps(compare_greedy(paged, fixed))}")
    t0 = time.perf_counter()
    phase_grad_consistency()
    log(f"[grad] done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_ilql_grad_consistency(kernels)
    log(f"[ilql-grad] done in {time.perf_counter() - t0:.1f}s")
    run("train_bf16", lambda: train_path(kernels))
    run("engine_train", lambda: engine_train_path(kernels))
    t0 = time.perf_counter()
    phase_graph(kernels)
    log(f"[graph] done in {time.perf_counter() - t0:.1f}s")
    split = logprob_bwd_rows(logprob_bwd_inputs(LOGPROB_BWD_SEED), iters=10)
    phases["fused_logprob_bwd_dx"]["kernels_only_ms"] = split.pop("fused_logprob_bwd_dx_kernels_only")
    free()
    split.update(logprob_bwd_rows(logprob_bwd_f32_inputs(F32_SEED), iters=3))
    for name, ms in split.items():
        phases[name]["ms"] = ms
        log(f"[kernel] {name}: {ms:.4f} ms per fused_logprob_bwd call (CUDA events over its wrapper calls)")

    # Each row's launches are those of the main path (engine_train), except
    # for the kernels it does not run: row 7 counts on the training path
    # over the chunked bf16 sampler, row 9 on the paged bf16 engine, and the
    # f32 mode of rows 4-6 on the ILQL path.
    rows = []
    for name, phase, src, replaces, path in (
        ("flash_attention_fwd", "flash_prefill", "trlx_tpu_torch/csrc/flash_fwd.cu",
         "trlx_tpu/ops/flash_attention.py:155", "engine_train"),
        ("flash_attention_bwd_dq", "flash_attention_bwd_dq", "trlx_tpu_torch/csrc/flash_bwd.cu",
         "trlx_tpu/ops/flash_attention.py:249", "engine_train"),
        ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv", "trlx_tpu_torch/csrc/flash_bwd.cu",
         "trlx_tpu/ops/flash_attention.py:281", "engine_train"),
        ("fused_logprob_fwd", "fused_logprob", "trlx_tpu_torch/csrc/fused_logprob.cu",
         "trlx_tpu/ops/fused_logprob.py:126", "engine_train"),
        ("fused_logprob_bwd_dx", "fused_logprob_bwd_dx", "trlx_tpu_torch/csrc/fused_logprob_bwd.cu",
         "trlx_tpu/ops/fused_logprob.py:190", "engine_train"),
        ("fused_logprob_bwd_dw", "fused_logprob_bwd_dw", "trlx_tpu_torch/csrc/fused_logprob_bwd.cu",
         "trlx_tpu/ops/fused_logprob.py:237", "engine_train"),
        ("decode_attention", "decode", "trlx_tpu_torch/csrc/decode_attn.cu", "trlx_tpu/ops/decode_attention.py:193",
         "train_bf16"),
        ("decode_attention_int8", "decode_int8", "trlx_tpu_torch/csrc/decode_attn.cu",
         "trlx_tpu/ops/decode_attention.py:161", "engine_train"),
        ("paged_decode_attention", "paged_decode", "trlx_tpu_torch/csrc/decode_attn.cu",
         "trlx_tpu/ops/decode_attention.py:236", "engine_paged_bf16"),
        ("paged_decode_attention_int8", "paged_decode_int8", "trlx_tpu_torch/csrc/decode_attn.cu",
         "trlx_tpu/ops/decode_attention.py:225", "engine_train"),
        ("fused_logprob_fwd_f32", "fused_logprob_f32", "trlx_tpu_torch/csrc/fused_logprob.cu",
         "trlx_tpu/ops/fused_logprob.py:126", "ilql_train"),
        ("fused_logprob_bwd_dx_f32", "fused_logprob_bwd_dx_f32", "trlx_tpu_torch/csrc/fused_logprob_bwd.cu",
         "trlx_tpu/ops/fused_logprob.py:190", "ilql_train"),
        ("fused_logprob_bwd_dw_f32", "fused_logprob_bwd_dw_f32", "trlx_tpu_torch/csrc/fused_logprob_bwd.cu",
         "trlx_tpu/ops/fused_logprob.py:237", "ilql_train"),
    ):
        p = phases[phase]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": by_path[path][name],
               "launches_path": path, "launches_by_path": {k: v[name] for k, v in by_path.items()},
               "max_abs_err": p["max_abs_err"], "tol": p["tol"], "ms": p["ms"], "plain_ms": p["plain_ms"],
               "bound_ms": p["bound_ms"], "bound_by": p["bound_by"], "library_ms": p["library_ms"],
               "shape": p["shape"]}
        for key in ("library", "max_abs_err_split_edges", "matmul_ms", "ms_bf16_weight", "cast_ms",
                    "kernels_only_ms", "turns_vs_library", "eager_ms", "max_scaled_err", "tol_rule"):
            if key in p:
                row[key] = p[key]
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
