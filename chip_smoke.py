#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``trlx_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``trlx_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main paths
give it (the paged decode kernels over scrambled block tables with a shared
prefix, a dead slot on the trash block and a fully masked row), then drives

1. the PPO experience phase (PPOTrainer → PromptPipeline →
   PPOOrchestrator.make_experience) at GPT-J-6B full width and depth on the
   chunked sampler over a bf16 KV cache, again with int8 decode weights
   (``rollout_w8``: every product of prefill and decode through the W8A16
   kernel, then an optimizer step's in-place re-quantize read by the
   replayed graph, whose launches a trace holds against the counters), and
   over an int8 cache;
2. ``make_experience`` through the continuous-batching rollout engine,
   greedy, bf16 cache, GPT-J-6B width and 4 layers, paged and with fixed
   slots, and the share of identical tokens between the two;
3. a gradient-consistency check at GPT-J-6B width and 4 layers: one PPO
   batch's gradients on the kernel route against the plain route;
4. the training path, ``trlx_tpu_torch.train(reward_fn=...)``, at GPT-J-6B
   width and 4 layers (random weights; 8 runs the same call at full depth):
   16 PPO steps with a second ``make_experience`` in between and a final
   ``evaluate()``;
5. the main path: the same ``train`` through the paged engine with an int8
   KV cache (``method.rollout_engine``, ``method.paged_kv``,
   ``model.kv_cache_quant``), 16 prompts of which 8 share a 512-token
   prefix; prefix hits are held against a count reckoned from the
   admission order, the pool's leak audit runs after each phase, and the
   int8 block-table kernel is held against its plain version on the
   engine's own live pool;
6. offline ILQL, ``trlx_tpu_torch.train(dataset=...)``, at GPT-J-6B full
   width and 6 layers (run first): 16 seeded token-array samples of 1024
   tokens, batch 4, 4 steps each followed by a Polyak sync held against
   alpha·online + (1 − alpha)·target, the last step profiled for the Q
   heads' share, then evaluate() steered by the target heads; and the ILQL
   kernel-route-versus-plain-route gradient check at 2 layers. The Q heads
   run the f32 mode of the fused head (rows 4-6 on f32 activations, held
   against their plain versions at N = 4092, D = 8192, V = 50400);
7. checkpoints: the end of every ``learn()`` saves (``[ckpt]`` lines: bytes,
   device-to-host, write, crc, manifest and load seconds, GB/s, beside the
   card), verified against its manifest and deleted when its path is done,
   but where another path saves the same state (the ILQL resume,
   ``text_ppo``, ``train_bf16``, ``engine_train``: the smoke's time);
   ``[resume]``: ILQL at 6 layers from ``ilql_train``'s end save (2 more
   steps); PPO's
   resume, and a load into a trainer whose decode graphs are captured, are
   ``resilience_drill``'s run 2 (13.);
8. HF checkpoints, text and the reward model (``hf_rm_train``, run second):
   the policy written as a GPT-J-6B HF directory (the published config.json,
   seeded bf16 safetensors in 5 GB shards with an index) and an 8-layer
   reward model beside it, ``train(model_path=..., prompts=[str],
   eval_prompts=[str], metric_fn=<over text>)`` with ``reward_model_path``
   and a byte-level tokenizer: every loaded tensor held against what was
   written, both directories deleted before ``learn()``, the rollouts scored
   by the reward model, 16 steps, ``evaluate()`` on its scores, the end
   save checked and deleted; ``text_ppo``: ``train(reward_fn=<over str>,
   prompts=[str])`` at 4 layers, then ``save_pretrained`` read back in part;
   ``[rm-route]``: the reward model's score on the kernel route against the
   plain route (2 layers);
9. soft-prompt PPO (``softprompt_train``): ``train(reward_fn=...)`` through
   ``PPOSoftpromptTrainer`` at GPT-J-6B width and 8 layers, 8 prefix rows,
   760-token prompts, 4 steps: the trunk and head bit-equal, the prefix
   moved, the flash backward in every layer and no dW launch (frozen head);
10. speculative decoding in the engine (``engine_spec``, 4 layers): the
   n-gram drafter with spec_k 4 against spec off, fixed and paged, bf16
   (accept rate, rate, identical-token share) and float32 with a soft-prompt
   model too (tokens identical);
11. sequence parallelism: ``[flash_ring]`` holds rows 1-3 in the key-offset
   and non-causal modes (a ring chunk of ppo_long's T = 4096 over sp = 4:
   [2, 1024, 16, 256], offsets -2048, -1024, 0, +1024, one ragged mask, one
   window) against their plain versions; ``[ring]`` holds
   ``ring_attention_sharded`` on a ``LocalSpGroup(4)`` (the four ranks on
   this card) at [2, 4096, 16, 256], zig-zag, contiguous and non-causal,
   forward and backward, against single-device flash, launches as the
   schedule says; ``sp_train`` runs ``train(reward_fn=...)`` with
   ``ppo_long_config.yml``'s values at GPT-J-6B width, 4 layers, T = 4096
   and int8 KV on that mesh (every full-sequence pass through the ring, rows
   1-3 in the offset mode in every layer, row 8 on decode), then the same
   run at sp = 1: token-identical rollouts, step 1 within 2e-2;
12. the overlapped pipeline (``overlap_train``, 4 layers): serial, overlapped
   at staleness 0 (bit-equal to serial) and staleness 1 with packed batches
   and prompt buckets;
13. resilience and the incident path (``resilience_drill``, 4 layers, the
   paged int8 engine): a run with a reward_fn exception and hang (retried),
   a NaN-poisoned step (skipped, parameters and moments bit-equal, its
   gradients non-finite through the backward kernels), a corrupted
   checkpoint and a SIGTERM; its resume past the corrupt checkpoint with the
   watchdog rolling back in place at a decayed LR, a slow step's and a
   reward-drift CRIT's incident bundles, ``/healthz`` and ``/metrics``
   scraped live; and the live engine's greedy tokens after the rollback
   against a fresh trainer's on the restored checkpoint;
14. data, fully sharded and tensor parallelism with the rollout engine, the
   overlapped pipeline and int8 decode weights on the mesh (``dist_train``
   and its ``dist_engine`` leg): 4 processes on this card over gloo,
   train.mesh [1, 2, 2, 1] (fsdp 2 x tp 2), GPT-J-6B width at 2 layers with
   ppo_gptj_config.yml's values (1 PPO epoch an iteration), against one
   process with the same seeded weights: teacher-forced logprobs and values,
   step 1's statistics and the parameters after 2 steps from the one
   process's store (replicas bit-equal under the consistency guard every
   step), each rank's launches of rows 1-3, 8 and 10 at 8 heads, 4-6 and
   W8, the greedy tokens' identical share (printed); the mesh's own rollouts
   come from the paged int8 engine (engine_train's settings and prompts)
   with W8A16 decode weights at the tp-local shapes, the second iteration's
   from the rollout producer at staleness 1 with graftfleet armed: every
   rank's schedule crc of each engine phase (equal, or the phase raised),
   the W8 shapes launched, the recorded staleness, and the engine store's
   logprobs against a one-process model on the same tokens;
15. the disaggregated and elastic fleet (``fleet_train``, GPT-J-6B width, 2
   layers, the paged int8 engine with W8A16 decode weights): serial; the
   colocated fleet at staleness 0 through the real transports (every store
   and the end weights bit-equal to serial); a learner and a rollout-worker
   process at staleness 1 with in-flight weight updates and a torn push
   (staleness at most 1, the torn ordinal rejected, a push adopted
   mid-phase); a learner and two elastic workers, one killed holding a
   lease (reclaimed, every unit once, the stores bit-equal to serial);
16. the port's own example, ``trlx_tpu_torch.examples.randomwalks``, on the
   card (``randomwalks``): PPO and then ILQL at the sizes of the CPU learning
   gates, each held to the JAX package's optimality floor (0.8 and 0.70); a
   tiny model (d_head 36, vocab 21) that no kernel's shape gate admits, so
   the phase checks learning and logs the wrappers it launched. The
   trainer's progress line is read from its stderr there and on the main
   path (one line a logged step), and ``train_bf16`` runs under
   ``TRLX_TPU_NO_PROGRESS=1`` (no line);
17. GPT-NeoX-20B (``neox_rm_train``, run third): ``ppo_neox20b_rm_config.yml``
   as ``default_config`` loads it, at NeoX-20B's published width (64 heads of
   96) and 4 layers, the policy and an on-device reward model written as NeoX
   HF directories from seeded weights, mesh [1, 1, 1, 1]: leg (a) at the
   recipe's 32 + 32 tokens, 2 PPO iterations (einsum attention, the fused
   head at D = 6144, V = 50432); leg (b) at 768 + 256, one iteration of 8
   steps and ``evaluate()``, every train and scoring pass and prefill through
   rows 1-3 at head_dim 96 (rows 1h-3h, held against their plain versions at
   [8, 1024, 64, 96] beside rows 1-3);

and checks that each path went through every kernel it runs, exactly as
often as its config says.

    python3 chip_smoke.py
    python3 chip_smoke.py --race-overhead   # only overlap_train's (c): a warm-up,
                                            # then unarmed and armed (A B B A)

The W8A16 product (``[w8a16]``) is held against its plain version at
GPT-J-6B's decode shapes (timed with the weight L2-warm and cold), one
prefill shape, and the tp-local shapes of tp 2 that ``dist_train``'s ranks
launch (decode, and one engine prefill); it has no Pallas counterpart (XLA
fuses QDense's int8 convert on the TPU).

Exits non-zero, printing no result, when no CUDA device is visible or any
phase fails. Output, in order: one line per phase; the device's name and
power limit as ``nvidia-smi`` reports them; one JSON line of per-kernel
numbers; and last, one JSON line ``{"ok": true, "device": {...}}``.
"""

import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

# The port's Tracker logs to wandb whenever wandb imports, as the JAX
# package's does. The smoke records to metrics.jsonl only: wandb stays out
# of this process even where the card machine's Python has it installed, so
# no run reaches for a wandb login or the network.
sys.modules.setdefault("wandb", None)

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
    from trlx_tpu_torch.ops import cuda_lib
    from trlx_tpu_torch.ops.cuda_graph import CudaGraph

    graph = CudaGraph()  # the port's one capture home: thread_local, under the launch lock
    with cuda_lib.launch_lock, graph.capture():
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


def phase_flash(gen, T: int, ragged: bool, h: int = 16, d: int = 256):
    """Flash attention forward at [8, T, h, d] bf16, causal (GPT-J-6B's
    heads by default; NeoX-20B's are h = 64, d = 96); with ``ragged`` the
    rows are left-padded to seeded prompt lengths."""
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    b = 8
    dev = "cuda"
    q, k, v = (torch.randn((b, T, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    if ragged:
        lens = torch.randint(MIN_PROMPT, T + 1, (b,), generator=gen, device=dev)
        mask = (torch.arange(T, device=dev)[None, :] >= (T - lens)[:, None]).float()
    scale = d ** -0.5
    out = flash_attention(q, k, v, mask, scale=scale)
    if not torch.equal(flash_attention(q, k, v, mask, scale=scale), out):
        raise AssertionError(f"flash[{b},{T},{h},{d}]: a second call differs from the first")
    ref = flash_attention_plain(q, k, v, mask, scale=scale)
    rows = mask.bool()  # query rows with a valid own key; pad rows differ by design
    # bf16 output (ulp 2^-8 near 1) and bf16 P in the P.V product on both
    # sides; summation order differs (64-key tiles vs one einsum).
    tol = 2e-2
    err = check(f"flash[{b},{T},{h},{d}]", out[rows], ref[rows], tol)
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


def phase_flash_bwd(gen, h: int = 16, d: int = 256, suffix: str = ""):
    """Flash attention backward (dq, then dk/dv) at the train shape
    [8, 1024, h, d] bf16 (GPT-J-6B's heads by default; ``suffix`` names the
    rows of other heads), rows left-padded to seeded prompt lengths, with
    nonzero dO and lse cotangents on the valid rows (padded rows carry none
    in the model: no later position reads them)."""
    from trlx_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
    )

    b, T = 8, MAX_LEN
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
        raise AssertionError(f"flash_bwd{suffix}: a second call of dq / dk / dv differs from the first")
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale)
    # bf16 outputs and bf16 P / dS in the products on both sides; tiles vs
    # one einsum sum in another order.
    rel = 2e-2
    err_q, tol_q = check_rel(f"flash_bwd{suffix}.dq", dq[rows], rq[rows], rel)
    err_k, tol_k = check_rel(f"flash_bwd{suffix}.dk", dk, rk, rel)
    err_v, tol_v = check_rel(f"flash_bwd{suffix}.dv", dv, rv, rel)
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
    log(f"[flash_bwd{suffix}] pair (dq + dk/dv) at {[b, T, h, d]} {pair_ms:.4f} ms vs SDPA backward ({backend}) "
        f"{lib_ms:.4f} ms, medians of "
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
        f"flash_attention_bwd_dq{suffix}": dict(max_abs_err=err_q, tol=tol_q, ms=ms_dq, bound_ms=bdq[0],
                                                bound_by=bdq[1], **common),
        f"flash_attention_bwd_dkv{suffix}": dict(max_abs_err=max(err_k, err_v), tol=max(tol_k, tol_v), ms=ms_dkv,
                                                 bound_ms=bdkv[0], bound_by=bdkv[1], **common),
    }


# Rows 1h-3h in every mode at head_dim 96, small shapes (b = 3: no padding,
# a third left-padded, a wholly masked row; h = 4): (name, T, causal,
# offset, window). Ragged T cuts the 128-key tiles of the forward and of a
# dk/dv CTA (T = 65 and 130: the upper warpgroup's keys past T, or some).
H96_MODES = (("causal-T1", 1, True, 0, 0), ("causal-T65", 65, True, 0, 0), ("causal-T130", 130, True, 0, 0),
             ("causal-T1000", 1000, True, 0, 0), ("noncausal", 1000, False, 0, 0), ("window100", 1000, True, 0, 100),
             ("window48-noncausal", 300, False, 0, 48), ("offset-past", 1000, True, -1000, 0),
             ("offset37", 1000, True, 37, 0), ("offset-future", 300, True, 300, 0),
             ("offset-64-window48", 300, True, -64, 48))


def flash_h96_case(gen, T: int, causal: bool, offset: int, window: int, b: int = 3, h: int = 4):
    """Rows 1h-3h at [b, T, h, 96] in one mode against the plain versions,
    as ``tests/test_torch_gpu.py`` holds the modes: o and lse on the rows
    with a valid reachable key (0.02 / 0.01 absolute), rows that reach no key
    exactly 0 and M_INIT; dq on those rows and every row of dk / dv within
    2e-2 of each output's max, with cotangents on the rows that carry them in
    the model (a valid reachable key, or none reachable). Two calls of the
    forward and of the backward give the same bits. Returns the errors."""
    from trlx_tpu_torch.ops.flash_attention import (
        M_INIT, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_plain, flash_fwd, reachable,
    )

    d, dev = NEOX_HEAD_DIM, "cuda"
    q, k, v = (torch.randn((b, T, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    mask[1, : T // 3] = 0
    mask[2] = 0
    reach = reachable(T, T, dev, causal=causal, window=window, offset=offset)
    good = (reach[None] & mask.bool()[:, None, :]).any(-1)
    dead = ~reach.any(-1)
    keep = good | dead[None]
    do = (torch.randn((b, T, h, d), generator=gen, device=dev) * keep[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=gen, device=dev) * keep[:, None, :]
    modes = dict(scale=d ** -0.5, causal=causal, window=window, offset=offset)
    o, lse = flash_fwd(q, k, v, mask, **modes)
    grads = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, **modes)
    again = flash_fwd(q, k, v, mask, **modes)
    if not (torch.equal(again[0], o) and torch.equal(again[1], lse)):
        raise AssertionError(f"flash_h96 T={T} {modes}: a second forward differs from the first")
    if not all(torch.equal(x, y) for x, y in zip(flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, **modes), grads)):
        raise AssertionError(f"flash_h96 T={T} {modes}: a second backward differs from the first")
    ro, rlse = flash_attention_plain(q, k, v, mask, return_lse=True, **modes)
    errs = {}
    if good.any():
        errs["o"] = check(f"flash_h96 T={T} {modes} o", o[good], ro[good], 2e-2)
        lg = good[:, None, :].expand_as(lse)
        errs["lse"] = check(f"flash_h96 T={T} {modes} lse", lse[lg], rlse[lg], 1e-2)
    if not ((o[:, dead] == 0).all() and (lse[:, :, dead] == M_INIT).all()):
        raise AssertionError(f"flash_h96 T={T} {modes}: a row that reaches no key is not 0 / M_INIT")
    ref = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, **modes)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        if name == "dq":
            got, want = got[good], want[good]
        if want.numel():
            errs[name] = check_rel(f"flash_h96 T={T} {modes} {name}", got, want, 2e-2)[0]
    return errs


def phase_flash_h96_modes(gen):
    """``flash_h96_case`` over ``H96_MODES``: the modes 1h-3h take beside
    the main path's causal one."""
    return {name: flash_h96_case(gen, T, causal, offset, window) for name, T, causal, offset, window in H96_MODES}


def ptxas_report(build_log: str, kernel: str) -> dict:
    """ptxas's registers and spill bytes of the entry function whose mangled
    name holds ``kernel`` (the build's ``-Xptxas -v`` lines)."""
    lines = build_log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            rest = lines[i + 1:i + 8]
            text = " ".join(rest[:next((j for j, x in enumerate(rest) if "Compiling entry" in x), len(rest))])
            nums = {key: int(m.group(1)) for key, pat in (
                ("registers", r"Used (\d+) registers"), ("spill_stores", r"(\d+) bytes spill stores"),
                ("spill_loads", r"(\d+) bytes spill loads")) if (m := re.search(pat, text))}
            loss = [x.strip() for x in lines if "Performance Loss" in x and kernel in x]
            return dict(kernel=kernel, **nums, performance_loss=loss)
    raise AssertionError(f"ptxas reported no entry function {kernel}")


# [flash_ring]: rows 1-3 in the ring's modes at a local chunk of ppo_long's
# T = 4096 over sp = 4, GPT-J-6B's heads. (name, causal, offset, window,
# ragged): wholly past chunks, the diagonal, a wholly future chunk, the
# non-causal mode, a window that reaches into the previous chunk.
RING_T, RING_SP = 4096, 4
FLASH_RING_CASES = (
    ("causal_off-2048", True, -2048, 0, False),
    ("causal_off-1024_ragged", True, -1024, 0, True),
    ("causal_off0", True, 0, 0, False),
    ("causal_off+1024", True, 1024, 0, False),
    ("noncausal_off0", False, 0, 0, False),
    ("causal_off-1024_window1280", True, -1024, 1280, False),
)


def phase_flash_ring(gen):
    """The flash forward, dq and dk/dv kernels in their offset and
    non-causal modes at [2, 1024, 16, 256] bf16, each against its plain
    version with nonzero dO and dlse on every row that has a valid reachable
    key and on every row that reaches none (those must get o = 0, lse =
    -1e30 and dq = 0, and add nothing to dk/dv); rows that reach only masked
    keys carry no cotangent (their combine weight is 0 in the ring). Per case
    the kernels' times, the plain versions', SDPA's with the equivalent
    boolean mask (forward, and its backward for dq + dk + dv), and the
    bounds over the case's reachable pairs only."""
    from trlx_tpu_torch.ops.flash_attention import (
        M_INIT, flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv, flash_bwd_dq, flash_fwd, reachable,
    )

    b, t, h, d = 2, RING_T // RING_SP, 16, 256
    dev = "cuda"
    scale = d ** -0.5
    one, rowvec, maskb = b * t * h * d * 2, b * h * t * 4, b * t * 4
    out = {}
    for name, causal, offset, window, ragged in FLASH_RING_CASES:
        modes = dict(scale=scale, causal=causal, window=window, offset=offset)
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        mask = torch.ones((b, t), device=dev)
        if ragged:
            mask[1, :300] = 0
        reach = reachable(t, t, dev, causal=causal, window=window, offset=offset)
        good = (reach[None] & mask.bool()[:, None, :]).any(-1)
        dead = ~reach.any(-1)
        keep = good | dead[None]
        do = (torch.randn((b, t, h, d), generator=gen, device=dev) * keep[:, :, None, None]).to(torch.bfloat16)
        dlse = torch.randn((b, h, t), generator=gen, device=dev) * keep[:, None, :]
        o, lse = flash_fwd(q, k, v, mask, **modes)
        ro, rlse = flash_attention_plain(q, k, v, mask, return_lse=True, **modes)
        rec = {"causal": causal, "offset": offset, "window": window, "ragged": ragged,
               "good_rows": int(good.sum()), "dead_rows": int(dead.sum()) * b}
        if bool((o[:, dead] != 0).any()) or bool((lse[:, :, dead] != M_INIT).any()):
            raise AssertionError(f"flash_ring[{name}]: a row that reaches no key has o != 0 or lse != -1e30")
        rec["err_o"] = check(f"flash_ring[{name}].o", o[good], ro[good], 2e-2) if good.any() else 0.0
        lg = good[:, None, :].expand_as(lse)
        rec["err_lse"] = check(f"flash_ring[{name}].lse", lse[lg], rlse[lg], 1e-2) if good.any() else 0.0
        delta = ((do.float() * o.float()).sum(-1).transpose(1, 2) - dlse).contiguous()
        bw = dict(scale=scale, window=window, causal=causal, offset=offset)
        dq = flash_bwd_dq(q, k, v, mask, do, lse, delta, **bw)
        dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, **bw)
        rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, **modes)
        if bool((dq[:, dead] != 0).any()):
            raise AssertionError(f"flash_ring[{name}]: dq of a row that reaches no key is not 0")
        rec["err_dq"], rec["tol_dq"] = check_rel(f"flash_ring[{name}].dq", dq[good], rq[good], 2e-2) \
            if good.any() else (0.0, 0.0)
        err_k, tol_k = check_rel(f"flash_ring[{name}].dk", dk, rk, 2e-2)
        err_v, tol_v = check_rel(f"flash_ring[{name}].dv", dv, rv, 2e-2)
        rec["err_dkv"], rec["tol_dkv"] = max(err_k, err_v), max(tol_k, tol_v)
        del rq, rk, rv, ro, rlse
        rec["ms_fwd"] = time_ms(lambda: flash_fwd(q, k, v, mask, **modes))
        rec["ms_dq"] = time_ms(lambda: flash_bwd_dq(q, k, v, mask, do, lse, delta, **bw))
        rec["ms_dkv"] = time_ms(lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, **bw))
        rec["plain_ms_fwd"] = time_ms(lambda: flash_attention_plain(q, k, v, mask, **modes), iters=3, warmup=1)
        rec["plain_ms_bwd"] = time_ms(lambda: flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, **modes),
                                      iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        amask = reach[None, None] & mask.bool()[:, None, None, :]
        rec["library_ms_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                                                scale=scale))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=scale)
        dot = do.transpose(1, 2)
        rec["library_ms_bwd"] = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        del sdpa_out
        pairs = b * h * int(reach.sum())  # reachable (query, key) pairs: the work this case's data needs
        rec["bound_fwd"] = bound(4 * one + rowvec + maskb, 4 * d * pairs)
        rec["bound_dq"] = bound(5 * one + 2 * rowvec + maskb, 6 * d * pairs)
        rec["bound_dkv"] = bound(6 * one + 2 * rowvec + maskb, 8 * d * pairs)
        rec["reachable_pairs"] = pairs
        out[name] = rec
        log(f"[flash_ring] {name}: {json.dumps(rec)}")
        free()
    return out


def flash_ring_rows(cases, names, shape):
    """The kernels line's phase entries of the modes: each kernel's numbers
    at the case ``names[0]`` (its row's figures), every named case beside."""
    rows = {}
    for kernel, key, err, tol in (("flash_attention_fwd", "fwd", "err_o", None), ("flash_attention_bwd_dq", "dq",
                                  "err_dq", "tol_dq"), ("flash_attention_bwd_dkv", "dkv", "err_dkv", "tol_dkv")):
        c = cases[names[0]]
        plain = c["plain_ms_fwd"] if key == "fwd" else c["plain_ms_bwd"]
        lib = c["library_ms_fwd"] if key == "fwd" else c["library_ms_bwd"]
        rows[kernel] = dict(
            max_abs_err=max(cases[n][err] for n in names), tol=2e-2 if tol is None else max(cases[n][tol] for n in names),
            ms=c[f"ms_{key}"], plain_ms=plain, library_ms=lib, bound_ms=c[f"bound_{key}"][0],
            bound_by=c[f"bound_{key}"][1], shape=shape, case=names[0],
            library="SDPA with the boolean mask" + ("" if key == "fwd" else ", backward: dq + dk + dv together"),
            cases={n: {"ms": cases[n][f"ms_{key}"], "bound_ms": cases[n][f"bound_{key}"][0],
                       "max_abs_err": cases[n][err]} for n in names})
    return rows


def ring_mode_rows(cases, ring, sp_by_mode):
    """The kernels line's rows of rows 1-3 in the ring's modes: the offset
    mode's figures at a wholly past chunk (offset -1024, ragged), its
    launches on sp_train (every ring chunk off the diagonal); the
    non-causal mode's at offset 0, its launches on [ring]'s contiguous
    non-causal variant (it has no trainer path)."""
    shape = [2, RING_T // RING_SP, 16, 256]
    offset = ["causal_off-1024_ragged"] + [n for n, c in cases.items()
                                           if c["causal"] and c["offset"] != 0 and n != "causal_off-1024_ragged"]
    noncausal = [n for n, c in cases.items() if not c["causal"]]
    counts_ring = {k: {"noncausal": v} for k, v in ring["contiguous_noncausal"]["launches"].items()}
    rows = []
    for mode, names, path, counts in (("offset", offset, "sp_train", sp_by_mode),
                                      ("noncausal", noncausal, "ring", counts_ring)):
        mode_rows = flash_ring_rows(cases, names, shape)
        for name, src, replaces in (
                ("flash_attention_fwd", "trlx_tpu_torch/csrc/flash_fwd.cu", "trlx_tpu/ops/flash_attention.py:155"),
                ("flash_attention_bwd_dq", "trlx_tpu_torch/csrc/flash_bwd.cu", "trlx_tpu/ops/flash_attention.py:249"),
                ("flash_attention_bwd_dkv", "trlx_tpu_torch/csrc/flash_bwd.cu",
                 "trlx_tpu/ops/flash_attention.py:281")):
            rows.append({"name": f"{name}_{mode}", "route": "cuda", "source": src, "replaces": replaces,
                         "launches": counts[name][mode], "launches_path": path, **mode_rows[name]})
    return rows


def phase_ring(gen, kernels):
    """``ring_attention_sharded`` on a ``LocalSpGroup(4)`` mesh (the four sp
    ranks of ppo_long's T = 4096 played on this card) at [2, 4096, 16, 256]
    bf16, forward and backward, zig-zag, contiguous and contiguous
    non-causal, against single-device ``flash_attention`` over the whole
    sequence (row 1 left-padded by 700 keys). The kernels' launches per
    variant must be the schedule's: zig-zag attends the live half-pairs
    (``causal_live_half_pairs``: 2n + 1 a rank), the contiguous flash ring
    every chunk (n a rank; a wholly future one walks no tile); each forward
    launch has its dq and dk/dv in the backward."""
    from trlx_tpu_torch.ops.flash_attention import flash_attention
    from trlx_tpu_torch.parallel.mesh import LocalSpGroup, make_mesh
    from trlx_tpu_torch.parallel.ring_attention import causal_live_half_pairs, ring_attention_sharded

    b, T, h, d, n = 2, RING_T, 16, 256, RING_SP
    dev = "cuda"
    scale = d ** -0.5
    mesh = make_mesh((1, 1, 1, n), sp_group=LocalSpGroup(n))
    q, k, v = (torch.randn((b, T, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    mask[1, :700] = 0
    do = torch.randn((b, T, h, d), generator=gen, device=dev).to(torch.bfloat16)
    flash_names = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    out = {}
    for name, causal, layout in (("zigzag", True, "zigzag"), ("contiguous", True, "contiguous"),
                                 ("contiguous_noncausal", False, "contiguous")):
        rows = mask.bool() if causal else torch.ones_like(mask, dtype=torch.bool)
        do_v = do * rows[:, :, None, None].to(do.dtype)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]

        def ring():
            o = ring_attention_sharded(*leaves, mask, scale=scale, causal=causal, mesh=mesh, layout=layout)
            return (o, *torch.autograd.grad(o, leaves, do_v))

        def single():
            o = flash_attention(*leaves, mask, scale=scale, causal=causal)
            return (o, *torch.autograd.grad(o, leaves, do_v))

        (got, launches) = launches_of(kernels, ring)
        per = sum(causal_live_half_pairs(n, "zigzag")) if layout == "zigzag" else n * n
        expected = {k_: per for k_ in flash_names}
        if {k_: launches.get(k_, 0) for k_ in flash_names} != expected or set(launches) - set(flash_names):
            raise AssertionError(f"ring[{name}]: launches {launches}, expected {expected}")
        ref = single()
        rec = {"launches": launches, "expected": expected}
        rec["err_o"] = check(f"ring[{name}].o", got[0][rows], ref[0][rows], 2e-2)
        rec["err_dq"], rec["tol_dq"] = check_rel(f"ring[{name}].dq", got[1][rows], ref[1][rows], 2e-2)
        err_k, tol_k = check_rel(f"ring[{name}].dk", got[2], ref[2], 2e-2)
        err_v, tol_v = check_rel(f"ring[{name}].dv", got[3], ref[3], 2e-2)
        rec.update(err_dkv=max(err_k, err_v), tol_dkv=max(tol_k, tol_v))
        del got, ref
        rec["ring_ms"] = time_ms(ring, iters=3, warmup=1)
        rec["single_ms"] = time_ms(single, iters=3, warmup=1)
        out[name] = rec
        log(f"[ring] {name} (sp = {n} on one card, fwd + bwd): {json.dumps(rec)}")
        free()
    return out


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
    # Row 5's two products as torch.matmul computes them in bf16: the scores
    # x·W recomputed, then ds·Wᵀ.
    wb = w.to(torch.bfloat16)
    dx_matmul_ms = time_ms(lambda: torch.matmul(x, wb), iters=5) + time_ms(lambda: torch.matmul(ds, wb.t()), iters=5)
    del ds, wb
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
                                     bound_by=bdx[1], matmul_ms=dx_matmul_ms,
                                     matmul="torch.matmul bf16 x [N, D] x W [D, V], then ds [N, V] x W^T: the "
                                     "yardstick of the ds + dx products", **common),
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
    wk = kernel_weight(w, x.dtype)

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


def log_f32_row(name: str, ms: float, flops: float, bound_ms: float, matmul_ms: float, matmul: str):
    """One f32 row's time beside its rate, its share of the bound (three
    TF32 passes) and its torch.matmul yardstick."""
    log(f"[{name}] {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the 3xTF32 bound "
        f"{bound_ms:.3f} ms; {matmul} {matmul_ms:.3f} ms ({ms / matmul_ms:.2f}x)")


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
    log_f32_row("fused_logprob_f32", ms, flops, bound_ms, matmul_ms, "torch.matmul of the f32 product x·W")
    log(f"[fused_logprob_f32] plain {plain_ms:.3f} ms")
    return dict(max_abs_err=max(e[0] for e in errs.values()), max_scaled_err=max(e[1] for e in errs.values()),
                tol=F32_REL, tol_rule="|d| <= 1e-4 * max(1, |ref|) elementwise on lp, lse, entropy",
                ms=ms, plain_ms=plain_ms, library_ms=None, library="none: no single PyTorch call computes it",
                matmul_ms=matmul_ms, matmul="torch.matmul f32 [N, D] x [D, V], TF32 off: the yardstick",
                bound_ms=bound_ms, bound_by=by, shape=[N, D, V], checks=errs, flops=flops)


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
    # Row 5f's products as torch.matmul computes them: x·W recomputed, then ds·Wᵀ.
    scores_matmul_ms = time_ms(lambda: torch.matmul(x, w), iters=3, warmup=1)
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
                  ds_buffer_bytes=-(-N // 128) * 128 * ldv * 4, dw_xt_scratch_bytes=D * -(-N // 4) * 4 * 4,
                  call_peak_gb=peak_gb)
    dw_err, dw_tol = max((e for k, e in errs.items() if k != "dx"), key=lambda et: et[0] / et[1])
    log(f"[fused_logprob_bwd_f32] whole backward {ms_all:.3f} ms; torch.matmul of x·W {scores_matmul_ms:.3f} ms, "
        f"of ds·Wᵀ {dx_matmul_ms:.3f} ms, of xᵀ·ds {dw_matmul_ms:.3f} ms; plain {plain_ms:.3f} ms; call peak "
        f"{peak_gb:.2f} GB")
    return {
        "fused_logprob_bwd_dx_f32": dict(max_abs_err=errs["dx"][0], tol=errs["dx"][1], bound_ms=bdx[0],
                                         bound_by=bdx[1], matmul_ms=scores_matmul_ms + dx_matmul_ms,
                                         matmul="torch.matmul f32 x [N, D] x W [D, V], then ds [N, V] x W^T, TF32 "
                                         "off: the yardstick of the ds + dx products", flops=2 * flops, **common),
        "fused_logprob_bwd_dw_f32": dict(max_abs_err=dw_err, tol=dw_tol, bound_ms=bdw[0], bound_by=bdw[1],
                                         matmul_ms=dw_matmul_ms,
                                         matmul="torch.matmul f32 x^T [D, N] x ds [N, V], ds given, TF32 off",
                                         flops=flops, **common),
    }


def smoke_config(quant: bool = False, n_layer: int = GPTJ_6B_ARCH["n_layer"], run: str = "rollout",
                 greedy: bool = False, method_name: str = "ppoconfig", **method):
    """The rollout path's config: GPT-J-6B, experience only. ``quant`` sets
    model.kv_cache_quant, ``greedy`` turns sampling off, ``method`` adds
    method fields (the engine's, the soft prompt's with ``method_name``)."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=2,
                      model_arch=dict(GPTJ_6B_ARCH, n_layer=n_layer), dtype="bfloat16", param_dtype="float32",
                      kv_cache_quant=quant),
        "train": dict(total_steps=1, seq_length=MAX_LEN, epochs=1, batch_size=CHUNK, lr_ramp_steps=1,
                      lr_decay_steps=1, weight_decay=1e-6, learning_rate_init=1.412e-4,
                      learning_rate_target=1.412e-4, seed=1000, checkpoint_dir=os.path.join(RUN_DIR, run)),
        "method": dict(name=method_name, num_rollouts=N_ROLLOUTS, chunk_size=CHUNK, init_kl_coef=0.2, target=6,
                       horizon=10000, gen_kwargs=dict(prompt_length=PROMPT_LEN, max_length=MAX_LEN,
                                                      min_length=MAX_LEN, top_k=0, top_p=0.7, temperature=0.5,
                                                      do_sample=not greedy), **method),
    })


def recipe(name: str, model=None, train=None, method=None, gen_kwargs=None):
    """The port's recipe ``name`` as its user loads it (``default_config``:
    ``trlx_tpu_torch/configs/<name>_config.yml``), with the fields of each
    section that a path changes against the recipe as written overridden
    (``gen_kwargs`` merged into the recipe's)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.api import default_config

    base = default_config(name)
    sections = {sec: dict(getattr(base, sec).__dict__, **(over or {}))
                for sec, over in (("model", model), ("train", train), ("method", method))}
    sections["method"]["gen_kwargs"] = dict(sections["method"]["gen_kwargs"], **(gen_kwargs or {}))
    return TRLConfig.from_dict(sections)


def train_config(n_layer: int, model_type: str, run_dir: str, method=None, quant: bool = False,
                 method_name: str = "ppoconfig", prompt_len: int = PROMPT_LEN, **arch):
    """The training path's config: ``ppo_gptj_config.yml``'s recipe (remat,
    2 unfrozen layers, vf_coef 0.2, betas (0.9, 0.95), lr 1.412e-4 with a
    100-step ramp, 4 PPO epochs, adaptive KL 0.2 → 6, top_p 0.7 at
    temperature 0.5) at GPT-J-6B width and depth ``n_layer`` from seeded
    weights, changed to the smoke's 768 + 256 lengths, 16 rollouts in chunks
    of 8, 2 epochs and 16 steps, mesh [-1, 1, 1, 1] (data parallel over the
    processes: one but on the mesh paths, which set their own), no save or
    eval interval inside the run. ``method`` adds method fields (of
    ``method_name``'s config), ``quant`` sets model.kv_cache_quant,
    ``prompt_len`` is the prompt width (256 new tokens after it)."""
    T = prompt_len + MAX_LEN - PROMPT_LEN
    return recipe(
        "ppo_gptj",
        model=dict(model_path="", tokenizer_path="", model_type=model_type,
                   model_arch=dict(GPTJ_6B_ARCH, n_layer=n_layer, **arch), kv_cache_quant=quant),
        train=dict(total_steps=16, seq_length=T, epochs=2, eval_interval=10**6, checkpoint_dir=run_dir,
                   mesh=[-1, 1, 1, 1]),
        method=dict(name=method_name, num_rollouts=N_ROLLOUTS, **(method or {})),
        gen_kwargs=dict(prompt_length=prompt_len, max_length=T, min_length=T))


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
        if name == "transformer.soft_prompt":
            return "soft_prompt"
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


def state_fingerprints(trainer, n_layer: int):
    """The parameter groups' and extras' fingerprints, the optimizer's
    moments', and the train state's scalars: what a checkpoint holds."""
    fps = group_fingerprints(trainer, n_layer)
    fps.update(mu=fingerprint(trainer.optimizer.mu), nu=fingerprint(trainer.optimizer.nu),
               count=trainer.optimizer.count, step=trainer.step, bad_steps=trainer.bad_steps,
               host=trainer.host_state_dict())
    return fps


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def log_ckpt(path: str, trainer):
    """One ``[ckpt]`` line per save and load the trainer made: bytes on
    disk, the device-to-host copy, write (the crc overlapped, and what the
    writes waited for it), manifest and finalize seconds, whether the save was async, the load's verify, read
    and in-place copy seconds, and GB/s over the disk part; beside the
    card's name and power limit. Returns the records."""
    card = card_line()
    for rec in trainer.checkpoint_log:
        rec = dict(rec, gb=rec["bytes"] / 1e9)
        if rec["op"] == "save":
            rec["write_gb_per_s"] = rec["bytes"] / 1e9 / rec["write_s"]
            rec["host_gb"] = rec["host_bytes"] / 1e9
        else:
            rec["verify_gb_per_s"] = rec["bytes"] / 1e9 / rec["verify_s"]
            rec["read_copy_gb_per_s"] = rec["bytes"] / 1e9 / (rec["read_s"] + rec["copy_s"])
        log(f"[ckpt] {path} {rec['op']} {rec['name']}: {json.dumps(rec)} on {card}")
    return list(trainer.checkpoint_log)


def state_bytes(trainer) -> int:
    """Bytes of the tensors a checkpoint holds: every parameter, the
    extras and both moments."""
    ts = [*trainer.model.parameters(), *trainer.extras.values(), *trainer.optimizer.mu, *trainer.optimizer.nu]
    return sum(t.numel() * t.element_size() for t in ts)


def check_end_save(path: str, trainer, run_dir: str, verify: bool = True):
    """The end of learn() saved ``state_<step>``: ``latest.txt`` names it,
    its manifest verifies, and its host copy held every byte of the state.
    ``verify=False`` where the next path loads the checkpoint, whose load
    verifies the same manifest (``check_loaded_from``). Logs the trainer's
    ``[ckpt]`` lines; returns them."""
    from trlx_tpu_torch.resilience import checkpoint as ckpt_util

    name = f"state_{trainer.step}"
    saves = [r for r in trainer.checkpoint_log if r["op"] == "save"]
    if not saves or saves[-1]["name"] != name or ckpt_util.latest_pointer(run_dir) != name:
        raise AssertionError(f"{path}: the last save is {saves[-1:]}, latest.txt {ckpt_util.latest_pointer(run_dir)}, "
                             f"expected {name}")
    if saves[-1]["host_bytes"] != state_bytes(trainer):
        raise AssertionError(f"{path}: the save copied {saves[-1]['host_bytes']} bytes of a "
                             f"{state_bytes(trainer)}-byte state")
    if verify:
        ok, reason = ckpt_util.verify_checkpoint(run_dir, name)
        if not ok:
            raise AssertionError(f"{path}: {name} does not verify: {reason}")
    return log_ckpt(path, trainer)


def check_loaded_from(path: str, trainer, name: str):
    """The trainer's resume loaded ``name`` itself (its manifest verified
    by the load), not an older checkpoint it fell back to."""
    loads = [r for r in trainer.checkpoint_log if r["op"] == "load"]
    if not loads or loads[0]["name"] != name or loads[0]["fallback"]:
        raise AssertionError(f"{path}: the resume loaded {loads[:1]}, expected {name} without a fallback")


def make_timed_trainer(kernels, n_layer: int, on_engine=None, tokenizer=None, on_built=None, base=None):
    """A PPOTrainer (or ``base``, a subclass), registered under its own name and picked by the
    config's ``model_type``, that records per train step its device time
    (CUDA events), its kernel launches and its stats; parameter fingerprints
    at the start (after a resume: the loaded state, moments and scalars
    too), after step 2 and at the end; the launches so far when evaluate()
    starts, and each evaluate()'s stats. ``on_engine(engine)`` runs once,
    when the rollout engine is built; ``tokenizer`` is what its
    ``_build_tokenizer`` returns (the smoke needs no ``transformers``);
    ``on_built(trainer)`` runs at the end of its construction."""
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    @register_model("SmokeTimedPPOTrainer")
    class SmokeTimedPPOTrainer(base or PPOTrainer):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            self.step_log, self.eval_log = [], []
            self.launches_before_eval = None
            self.fp = {"start": state_fingerprints(self, n_layer)}
            if on_built is not None:
                on_built(self)

        def _build_tokenizer(self, tokenizer_path):
            return tokenizer if tokenizer is not None else super()._build_tokenizer(tokenizer_path)

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
    ``per_step``, has finite stats and no guard skip; step 1 and the first
    step of the second epoch (9 at 16 steps and 2 epochs), the first on
    fresh rollouts (the second make_experience ran with the updated
    weights), have mean_ratio within 1 +- 0.05: the training
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
    for i in sorted({0, steps // config.train.epochs} & set(range(steps))):  # one epoch: step 1 alone
        if not abs(log_[i]["mean_ratio"] - 1.0) <= 0.05:
            raise AssertionError(f"step {i + 1} mean_ratio {log_[i]['mean_ratio']} is not within 1 +- 0.05")
    return log_


TRAIN_LAYERS = 4  # depth of the training path; hf_rm_train runs the same train() at full depth


def no_save_trainer():
    """A PPOTrainer whose saves count (``saves_skipped``) and write nothing:
    a path whose end state another path saves and checks in the same format
    (the smoke's time)."""
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    class NoSavePPOTrainer(PPOTrainer):
        saves_skipped = 0

        def save(self, directory=None, block=True):
            self.saves_skipped += 1

    return NoSavePPOTrainer


def train_path(kernels):
    """``trlx_tpu_torch.train(reward_fn=...)`` at GPT-J-6B width and
    ``TRAIN_LAYERS`` layers on the chunked sampler with a bf16 cache (the
    same call at full depth is ``hf_rm_train``'s); returns its numbers and
    the launches of the whole run. Its end save is not written (since the
    engine, the overlap and W8 on the mesh came, the smoke's time): the same
    4-layer PPO state is saved, verified and loaded by ``resilience_drill``,
    and ``hf_rm_train`` checks a PPO end save at full depth."""
    import trlx_tpu_torch

    n_layer, k = TRAIN_LAYERS, 2
    cls = make_timed_trainer(kernels, n_layer, base=no_save_trainer())
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
    trainer.fp["end"] = state_fingerprints(trainer, n_layer)

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
    log(f"[train] trlx_tpu_torch.train at GPT-J-6B width ({n_layer} layers), {steps} steps: {json.dumps(out)}")
    if trainer.saves_skipped != 1:
        raise AssertionError(f"train_bf16 asked for {trainer.saves_skipped} saves, expected its end save")
    del trainer
    free()
    shutil.rmtree(run_dir)
    return out, launches


def reward_fn(samples):
    """A cheap host reward of the tokens: the share of even token ids."""
    return [float(np.mean(np.asarray(s) % 2 == 0)) for s in samples]


def main_path(kernels, quant: bool = False, w8: bool = False, n_layer: int = GPTJ_6B_ARCH["n_layer"]):
    """The PPO experience phase at GPT-J-6B width (the rollout path) on the
    chunked sampler, over a bf16 cache or, with ``quant``, an int8 one (the
    decode steps then run row 8), at depth ``n_layer``; with ``w8``, int8
    decode weights (``model.decode_weight_quant``): every product of prefill
    and decode goes through the W8 kernel, and after the phase an optimizer
    step's re-quantize is checked (``check_w8_requantize``). Returns its
    numbers."""
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    tag = "[rollout-w8]" if w8 else ("[rollout-int8]" if quant else "[main]")
    decode = "decode_attention_int8" if quant else "decode_attention"
    config = smoke_config(quant=quant, n_layer=n_layer, run="rollout_w8" if w8 else
                          ("rollout_int8" if quant else "rollout"))
    config.model.decode_weight_quant = w8
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
    k = config.model.num_layers_unfrozen
    steps = MAX_LEN - PROMPT_LEN
    expected = dict.fromkeys(kernels, 0)  # no backward kernel runs on the rollout path
    expected.update({"flash_attention_fwd": n_chunks * (n_layer + k), decode: n_chunks * n_layer * steps,
                     "fused_logprob_fwd": n_chunks})
    if w8:
        # q, k, v, the attention output, c_fc and the MLP output in every
        # layer, and the LM head, once in the prefill and in every step.
        expected["w8a16_matmul"] = n_chunks * (1 + steps) * (W8_PRODUCTS * n_layer + 1)
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
        "n_layer": n_layer,
    }
    log(f"{tag} make_experience({N_ROLLOUTS}) at GPT-J-6B width, {n_layer} layers: {json.dumps(out)}")
    if w8:
        out["requantize"] = check_w8_requantize(trainer, prompts[:CHUNK], n_layer, kernels)
    del trainer, orch
    free()
    return out, launches


W8_PRODUCTS = 6  # Dense products a GPT-J block runs: q, k, v, attention out, c_fc, MLP out


def check_w8_requantize(trainer, prompts, n_layer: int, kernels):
    """After an optimizer step the int8 decode copies are re-quantized in
    place (every buffer keeps its address; a trained layer's codes move, a
    frozen layer's do not), and the sampler's replayed graph reads them: one
    chunk through the fused rollout generation, graph route against the
    eager route from equal generator states, bit-equal tokens and stats.
    The graph route runs once more under the profiler: the traced launches
    of every kernel, the W8 product's among them, equal the counters short
    of the records the trace proves lost, and every decode step's graph
    launch that the trace holds whole shows exactly the step's W8 launches
    (6 a layer and the LM head)."""
    from functools import partial

    from trlx_tpu_torch.ops.w8a16 import quantize_weights, quantized_weights

    top, bottom = f"transformer.h_{n_layer - 1}.mlp.c_fc", "transformer.h_0.mlp.c_fc"
    before = {name: (kq.data_ptr(), sc.data_ptr()) for name, (kq, sc) in quantized_weights(trainer.model).items()}
    codes = {name: quantized_weights(trainer.model)[name][0].clone() for name in (top, bottom)}
    optimizer_step(trainer, seed=21)
    n = quantize_weights(trainer.model)  # what the sampler's refresh_weight_copies runs before its call
    if n != 2 * W8_PRODUCTS + 1:  # the two trained blocks and the LM head
        raise AssertionError(f"re-quantize after an optimizer step touched {n} kernels, expected 13")
    qw = quantized_weights(trainer.model)
    moved = [name for name, (kq, sc) in qw.items() if (kq.data_ptr(), sc.data_ptr()) != before[name]]
    if moved or set(qw) != set(before):
        raise AssertionError(f"re-quantize moved the int8 buffers of {moved[:4]}")
    if torch.equal(qw[top][0], codes[top]) or not torch.equal(qw[bottom][0], codes[bottom]):
        raise AssertionError("re-quantize: the trained layer's codes did not move, or a frozen layer's did")
    pipe_ids = np.zeros((CHUNK, PROMPT_LEN), np.int64)
    pipe_mask = np.zeros((CHUNK, PROMPT_LEN), np.int64)
    for i, p in enumerate(prompts):
        pipe_ids[i, PROMPT_LEN - len(p):], pipe_mask[i, PROMPT_LEN - len(p):] = p, 1
    graph = trainer._generate_fused_fn
    eager = partial(graph.func, *graph.args, **{**graph.keywords, "_keep": {}, "_eager": True})
    runs = {}
    for name, fn in (("graph", graph), ("eager", eager)):
        out, ms = wall_ms_of(lambda: fn(trainer.put(pipe_ids), trainer.put(pipe_mask),
                                        torch.Generator(device="cuda").manual_seed(5)))
        runs[name] = (out, ms)
    (g_out, g_ms), (e_out, e_ms) = runs["graph"], runs["eager"]
    same = torch.equal(g_out[0], e_out[0]) and all(torch.equal(g_out[2][key], e_out[2][key]) for key in g_out[2])
    if not same:
        raise AssertionError("W8: the replayed graph after a re-quantize differs from the eager route")
    _, kern_ms, traced = traced_kernel_ms(kernels, lambda: graph(trainer.put(pipe_ids), trainer.put(pipe_mask),
                                                                 torch.Generator(device="cuda").manual_seed(5)))
    # Every decode step's graph launch that the trace holds whole ran each W8
    # product of the step on the card: 6 a layer and the LM head.
    step = W8_PRODUCTS * n_layer + 1
    per_step = traced["kernels_per_complete_graph_launch"].get("w8a16_")
    if traced["complete_graph_launches"] < 1 or per_step != [step]:
        raise AssertionError(f"W8 launches in the trace's whole decode-step graph launches {per_step} "
                             f"(of {traced['complete_graph_launches']}) != {step} a step")
    rec = {"buffers": len(qw), "requantized": n, "addresses_kept": True, "graph_equals_eager": True,
           "graph_wall_ms": g_ms, "eager_wall_ms": e_ms, "traced_kernel_ms": kern_ms, "traced": traced}
    log(f"[rollout-w8] after an optimizer step: {json.dumps(rec)}")
    return rec


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


# The main path's unarmed figures PERF.md holds (one H100 80GB HBM3 at
# 700.00 W, other calls): a PPO step at 28 layers (PR 13 calls 4 and 6).
UNARMED_STEP_DEVICE_S = 0.6209
MFU_REL_TOL = 0.10  # the monitor's MFU against the smoke's own reckoning
LEDGER_ERROR_MAX = 0.01  # |device_busy + host + bubble - wall| as a share of the wall
# Device kernels the profile_dir trace of train steps must name.
ARMED_TRACE_KERNELS = {"flash_fwd_kernel", "flash_bwd_dq_kernel", "logprob_fwd_kernel", "logprob_dw_kernel"}


def reckon_ppo_step_flops(n_layer: int, k: int, rows: int, T: int, R: int, arch=GPTJ_6B_ARCH) -> float:
    """The FLOPs of one remat PPO train step, from the shapes alone: every
    block's products (q, k, v, out: 4 d^2; the MLP: 2 d d_ff) run forward,
    again in the remat recompute but for the MLP's output product (the
    recompute stops early, once the last tensor the backward saved, that
    product's input, is made again: ``set_checkpoint_early_stop``), and
    backward for dX (the embedding trains, so the gradient crosses every
    block), and for dW in the top ``k``; attention over the causal pairs
    (the flash kernels: forward twice, 4 a pair and head dim; dq 6; dk/dv
    8); the fused head over the ``R`` response rows of each sequence
    (forward 2, ds + dx 4, dW 2, times D V); the value head (d -> 2d -> 1)
    forward, dX and dW."""
    d, d_ff, V, h = arch["d_model"], arch["d_ff"], arch["vocab_size"], arch["n_head"]
    tokens = rows * T
    per_block = 4 * d * d + 2 * d * d_ff
    dense = 2 * tokens * (per_block * (3 * n_layer + k) - d * d_ff * n_layer)
    pairs = rows * h * T * (T + 1) / 2
    attn = (2 * 4 + 6 + 8) * (d // h) * pairs * n_layer
    head = (2 + 4 + 2) * rows * R * d * V
    v_head = 3 * 2 * tokens * (d * 2 * d + 2 * d)
    return dense + attn + head + v_head


def check_armed_run(trainer, run_dir: str, config, prof_rec: dict, n_layer: int, k: int, card: str):
    """graftnum, device telemetry, graftscope, watch_interval and profile_dir
    armed on the main path: each window's ``obs/train_mfu_pct`` against the
    smoke's reckoning (``reckon_ppo_step_flops`` over the window's steps'
    CUDA-event device seconds, within ``MFU_REL_TOL``) and the counted FLOPs
    of a train step against the reckoned; each window's ledger error within
    ``LEDGER_ERROR_MAX`` of the wall, with its dropped fences; every
    ``num/*`` and ``obs/*`` value finite; the profile's trace file naming
    the hand kernels, its launches against the wrappers' counts short of the
    records the trace proves lost; the report's numerics, graftscope and
    telemetry sections. Returns the numbers it printed."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(run_dir, "programs.json")) as f:
        programs = json.load(f)
    R = MAX_LEN - PROMPT_LEN
    reckoned = reckon_ppo_step_flops(n_layer, k, config.train.batch_size, MAX_LEN, R)
    counted = programs["train/step"]["variants"][0]["flops"]
    log_, done, windows = trainer.step_log, 0, []
    for r in recs:
        if "obs/train_mfu_pct" not in r:
            continue
        steps = log_[done:int(r["step"])]
        done = int(r["step"])
        dev_s = sum(s["device_s"] for s in steps)
        want = 100.0 * reckoned * len(steps) / dev_s / PEAK_BF16_FLOPS
        err = abs(r["obs/ledger_device_busy_s"] + r["obs/ledger_host_s"] + r["obs/ledger_bubble_s"]
                  - r["obs/ledger_wall_s"]) / r["obs/ledger_wall_s"]
        windows.append({"step": r["step"], "train_mfu_pct": r["obs/train_mfu_pct"], "reckoned_mfu_pct": want,
                        "train_device_s": r.get("obs/train_device_s"), "steps_device_s": dev_s, "steps": len(steps),
                        "iter_mfu_pct": r.get("obs/iter_mfu_pct"), "ledger_error_frac": err,
                        "ledger_wall_s": r["obs/ledger_wall_s"], "device_busy_s": r["obs/ledger_device_busy_s"],
                        "host_s": r["obs/ledger_host_s"], "bubble_s": r["obs/ledger_bubble_s"],
                        "fences_dropped": r["obs/graftscope_fences_dropped_total"]})
    bad = sorted({k_ for r in recs for k_, v in r.items() if k_.startswith(("num/", "obs/", "watch/"))
                  and isinstance(v, float) and not np.isfinite(v)})
    num_keys = sorted({k_ for r in recs for k_ in r if k_.startswith("num/")})
    trace = os.path.join(config.train.profile_dir, "trace.json")
    with open(trace, "rb") as f:
        raw = f.read()
    named = sorted(k_ for k_ in DEVICE_KERNELS if k_.encode() in raw)
    with open(os.path.join(run_dir, "report.md")) as f:
        md = f.read()
    sections = {s: s in md for s in ("## Numerics (graftnum)", "## Device-time attribution (graftscope)",
                                      "- train MFU:", "### Monitored programs")}
    empty = [s for s in ("No numerics records", "No graftscope snapshot", "No FLOP gauges") if s in md]
    out = {"windows": windows, "reckoned_step_tflop": reckoned / 1e12, "counted_step_tflop": counted / 1e12,
           "num_keys": len(num_keys), "nonfinite": bad, "trace_bytes": os.path.getsize(trace),
           "trace_kernels": named, "profile_launches": prof_rec.get("traced"),
           "report_sections": sections, "report_bytes": len(md)}
    log(f"[engine-armed] graftnum, telemetry, graftscope, watch_interval 4, profile_dir on the main path on {card}: "
        f"{json.dumps(out)}")
    for w in windows:
        log(f"[engine-armed] window at step {w['step']}: obs/train_mfu_pct {w['train_mfu_pct']:.3f} against the "
            f"reckoning {w['reckoned_mfu_pct']:.3f} ({w['steps']} steps, {w['steps_device_s']:.4f} device s); ledger "
            f"|device + host + bubble - wall| / wall {w['ledger_error_frac']:.2e}, fences dropped "
            f"{w['fences_dropped']:.0f}")
    if not windows:
        raise AssertionError("the armed main path logged no MFU window")
    for w in windows:
        if abs(w["train_mfu_pct"] / w["reckoned_mfu_pct"] - 1) > MFU_REL_TOL:
            raise AssertionError(f"obs/train_mfu_pct {w['train_mfu_pct']} against the reckoning "
                                 f"{w['reckoned_mfu_pct']} (tolerance {MFU_REL_TOL})")
        if w["ledger_error_frac"] > LEDGER_ERROR_MAX or w["fences_dropped"]:
            raise AssertionError(f"the ledger's error {w['ledger_error_frac']} or dropped fences {w['fences_dropped']}")
    if abs(counted / reckoned - 1) > MFU_REL_TOL:
        raise AssertionError(f"counted train-step FLOPs {counted} against the reckoned {reckoned}")
    if bad or not num_keys:
        raise AssertionError(f"non-finite telemetry {bad}, num/* keys {len(num_keys)}")
    if not ARMED_TRACE_KERNELS <= set(named):
        raise AssertionError(f"the profile_dir trace names only {named} of the hand kernels")
    if not all(sections.values()) or empty:
        raise AssertionError(f"report sections {sections}, empty ones {empty}")
    return out


EARLIER_STEP_DEVICE_S = 0.62  # engine_train's armed train step before the progress line (PERF.md section 5)


@contextlib.contextmanager
def progress_env(value):
    """``TRLX_TPU_NO_PROGRESS`` set to ``value`` (None: unset) inside the
    block, restored after."""
    old = os.environ.pop("TRLX_TPU_NO_PROGRESS", None)
    if value is not None:
        os.environ["TRLX_TPU_NO_PROGRESS"] = value
    try:
        yield
    finally:
        os.environ.pop("TRLX_TPU_NO_PROGRESS", None)
        if old is not None:
            os.environ["TRLX_TPU_NO_PROGRESS"] = old


def progress_lines(err_path: str):
    """The trainer's progress lines in a captured stderr (a file: one line a
    logged step)."""
    with open(err_path) as f:
        return [ln.rstrip("\n") for ln in f if ln.startswith("step ")]


def check_progress_lines(err_path: str, steps: int, log_interval: int, name: str, need=("loss=", "samples/s=")):
    """One progress line at each logged step k, reading ``step k/steps`` and
    each of ``need`` (ILQL's step stats have no ``loss``, in both packages).
    Returns the lines."""
    lines = progress_lines(err_path)
    want = [f"step {k}/{steps}" for k in range(log_interval, steps + 1, log_interval)]
    got = [" ".join(ln.split()[:2]) for ln in lines]
    if got != want:
        raise AssertionError(f"{name}: progress lines {got}, expected {want}")
    bad = [ln for ln in lines if any(f"  {w}" not in ln for w in need)]
    if bad:
        raise AssertionError(f"{name}: progress lines without {need}: {bad[:3]}")
    return lines


def engine_train_path(kernels):
    """The main path: ``trlx_tpu_torch.train(reward_fn=...)`` at GPT-J-6B
    full width and depth through the continuous-batching engine, paged
    (block 128, 8 slots, prefill batch 4, 8 steps per sync, the default pool
    of 65 blocks) with an int8 KV cache, on 16 prompts of which 8 share a
    512-token prefix, with ``train_config``'s method and optimizer values:
    16 PPO steps, two experience phases, a final evaluate(). Its end save
    is not written (since dist_train, the smoke's time): ``hf_rm_train``'s
    end save of the same 33.6 GB state is written and checked. Since PR 21
    it runs with graftnum, device telemetry, graftscope, ``watch_interval``
    and ``profile_dir`` armed (``check_armed_run``): none of them changes a
    launch the run holds. Returns its numbers and the launches of the whole
    run."""
    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    n_layer, k, R = GPTJ_6B_ARCH["n_layer"], 2, MAX_LEN - PROMPT_LEN
    spc = ENGINE["engine_steps_per_sync"]
    eng = {}
    prof_rec = {}

    def on_built(trainer):
        # The profile_dir window's profiler, kept past its stop so its trace
        # is held against the wrappers' counts of the same window.
        tick, stop = trainer._profile_tick, trainer._profile_stop

        def tick_():
            was = trainer._profiling
            tick()
            if was is None and trainer._profiling is not None:
                prof_rec["before"] = {n: f.launches for n, f in kernels.items()}

        def stop_():
            prof = trainer._profiling
            if prof is not None:
                prof_rec["counted"] = {n: f.launches - prof_rec["before"][n] for n, f in kernels.items()}
                prof_rec["prof"] = prof
            stop()

        trainer._profile_tick, trainer._profile_stop = tick_, stop_

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

    progress_s = []  # host seconds of each progress_line call

    def on_built_(trainer):
        on_built(trainer)
        line = trainer.progress_line

        def progress_line(stats_host):
            t = time.perf_counter()
            line(stats_host)
            progress_s.append(time.perf_counter() - t)

        trainer.progress_line = progress_line

    cls = make_timed_trainer(kernels, n_layer, on_engine, base=no_save_trainer(), on_built=on_built_)
    run_dir = os.path.join(RUN_DIR, "engine_train")
    config = train_config(n_layer, cls.__name__, run_dir, method=dict(ENGINE, paged_kv=True), quant=True)
    config.train.graftnum = config.train.device_telemetry = config.train.graftscope = True
    config.train.watch_interval = 4
    config.train.profile_dir = os.path.join(run_dir, "profile")
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    os.makedirs(run_dir, exist_ok=True)
    err_path = os.path.join(run_dir, "stderr.txt")
    t0 = time.perf_counter()
    with progress_env(None), open(err_path, "w") as err, contextlib.redirect_stderr(err):
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
    lines = check_progress_lines(err_path, steps, config.train.log_interval, "engine_train")
    # The first phase window is logged at the second rollout boundary, after
    # the first iteration's steps: every later line folds it in.
    per_iter = steps // config.train.epochs
    late = [ln for ln in lines[per_iter:] if "exp/s=" not in ln or "phases r/s/t=" not in ln]
    if late:
        raise AssertionError(f"engine_train progress lines after step {per_iter} without the phase window: {late}")
    dev_med = float(np.median([r["device_s"] for r in log_]))
    progress = {"lines": len(lines), "first": lines[0], "last": lines[-1],
                "line_host_s_total": sum(progress_s), "line_host_us_median": 1e6 * float(np.median(progress_s)),
                "step_device_s_median": dev_med, "earlier_step_device_s": EARLIER_STEP_DEVICE_S}
    log(f"[progress] engine_train: one progress line a logged step on {card_line()}: {json.dumps(progress)}")
    log(f"[progress] engine_train step device s median {dev_med:.4f} beside the earlier {EARLIER_STEP_DEVICE_S} "
        f"(the line runs on the host after the step's stats are fetched: "
        f"{1e6 * float(np.median(progress_s)):.1f} us a call, {sum(progress_s):.4f} s in all)")
    prof = prof_rec.pop("prof", None)
    if prof is None:
        raise AssertionError("train.profile_dir opened no profiling window")
    _, prof_rec["traced"] = trace_launches(prof, prof_rec["counted"])
    del prof
    armed = check_armed_run(trainer, run_dir, config, prof_rec, n_layer, k, card_line())
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
        "unarmed_step_device_s": UNARMED_STEP_DEVICE_S,
        "armed": armed,
        "progress": progress,
        "mean_ratio_per_step": [r["mean_ratio"] for r in log_],
        "experience": exp,
        "eval": dict(trainer.eval_log[0]),
        "launches": launches,
    }
    log(f"[engine] trlx_tpu_torch.train through the paged int8 engine at GPT-J-6B ({n_layer} layers), "
        f"{steps} steps: {json.dumps(out)}")
    log(f"[engine-armed] armed run: wall {wall:.1f} s, step device s median {float(np.median(dev_s)):.4f} (step 1, "
        f"counted under FlopCount: {dev_s[0]:.4f}; each step: {[round(x, 4) for x in dev_s]}); unarmed, from PERF.md "
        f"(PR 13, other calls): step {UNARMED_STEP_DEVICE_S} s, no engine_train wall recorded")
    log(f"[engine] launches {launches} expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    before_eval = trainer.launches_before_eval
    if any(before_eval[n] for n in ("decode_attention", "decode_attention_int8", "paged_decode_attention")):
        raise AssertionError(f"rows 7-9 launched before evaluate(): {before_eval}")
    if trainer.saves_skipped != 1:
        raise AssertionError(f"engine_train asked for {trainer.saves_skipped} saves, expected its end save")

    del trainer, engine, eng
    free()
    shutil.rmtree(run_dir)
    return out, launches


def without_progress(fn, name: str):
    """``fn()`` under ``TRLX_TPU_NO_PROGRESS=1`` with stderr captured:
    fails if the trainer wrote a progress line."""
    os.makedirs(RUN_DIR, exist_ok=True)
    err_path = os.path.join(RUN_DIR, f"{name}.stderr.txt")
    with progress_env("1"), open(err_path, "w") as err, contextlib.redirect_stderr(err):
        out = fn()
    lines = progress_lines(err_path)
    if lines:
        raise AssertionError(f"{name} under TRLX_TPU_NO_PROGRESS=1 wrote progress lines: {lines[:3]}")
    log(f"[progress] {name} under TRLX_TPU_NO_PROGRESS=1: no progress line ({os.path.getsize(err_path)} bytes of "
        "stderr)")
    return out


# The CPU learning gates' sizes (tests/test_torch_train.py, tests/test_torch_ilql.py) and the JAX package's
# optimality floors (tests/test_e2e.py:319,353).
RANDOMWALKS = (
    ("ppo", dict(total_steps=48, eval_interval=16, batch_size=48), dict(num_rollouts=96, chunk_size=48), 0.8),
    ("ilql", dict(total_steps=100, eval_interval=25, batch_size=48), {}, 0.70),
)


def randomwalks_path(kernels):
    """The port's own example on the card: ``trlx_tpu_torch.examples
    .randomwalks`` PPO and then ILQL (the example's config, the learning
    gates' sizes), each failing unless its best eval optimality reaches the
    JAX package's floor. Its model (2 layers, d_head 36, vocab 21) is below
    every kernel's shape gate, so it checks learning, not kernels: it logs
    the wrappers each run launched. The PPO run's stderr holds one progress
    line a step, with the eval reward and optimality at the eval steps."""
    from trlx_tpu_torch.examples import randomwalks

    out, total = {}, dict.fromkeys(kernels, 0)
    for method, train_kw, method_kw, floor in RANDOMWALKS:
        run_dir = os.path.join(RUN_DIR, f"randomwalks_{method}")
        config = randomwalks.base_config(method, 21, 10)
        for k, v in dict(train_kw, checkpoint_interval=10**6, checkpoint_dir=run_dir).items():
            setattr(config.train, k, v)
        for k, v in method_kw.items():
            setattr(config.method, k, v)
        history = []

        def recording(task_metric):
            def metric(samples):
                m = task_metric(samples)
                history.append(float(np.mean(m["optimality"])))
                return m
            return metric

        for fn in kernels.values():
            fn.launches = 0
        os.makedirs(run_dir, exist_ok=True)
        err_path = os.path.join(run_dir, "stderr.txt")
        t0 = time.perf_counter()
        with progress_env(None), open(err_path, "w") as err, contextlib.redirect_stderr(err):
            trainer = randomwalks.main(method, config=config, metric_fn=recording)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for n, f in kernels.items():
            total[n] += f.launches
        steps = config.train.total_steps
        lines = check_progress_lines(err_path, steps, config.train.log_interval, f"randomwalks {method}",
                                     need=("loss=", "samples/s=") if method == "ppo" else ("samples/s=",))
        at_eval = [ln for k, ln in zip(range(1, steps + 1), lines) if k % config.train.eval_interval == 0]
        want = ("reward=", "optimality=") if method == "ppo" else ("optimality=",)
        if not at_eval or any(w not in ln for ln in at_eval for w in want):
            raise AssertionError(f"randomwalks {method}: eval-step progress lines without {want}: {at_eval}")
        out[method] = {"wall_s": wall, "steps": trainer.iter_count, "optimality": history, "best": max(history),
                       "floor": floor, "launched": {n: f.launches for n, f in kernels.items() if f.launches},
                       "device": str(trainer.device), "eval_lines": at_eval}
        log(f"[randomwalks] {method} on {card_line()}: {json.dumps(out[method])}")
        if trainer.iter_count != steps or max(history) < floor:
            raise AssertionError(f"randomwalks {method}: {trainer.iter_count} steps, best eval optimality "
                                 f"{max(history)} (history {history}) below the floor {floor}")
        del trainer
        free()
        shutil.rmtree(run_dir)
    return out, total


OVERLAP_LAYERS = 4  # depth of the overlapped-pipeline path, at GPT-J-6B width
OVERLAP_BUCKETS = [704, 768]  # the engine prompts' lengths fill both (6 and 10 prompts)
REWARD_HOST_S = 0.2  # host wall time the overlap path's reward_fn spends per chunk, in every run alike


# The race sanitizer's cost (``--race-overhead``): (c) unarmed and armed,
# in the order A B B A, one process, after an unarmed warm-up run (a first
# run pays the process's one-time costs: on an H100 80GB HBM3 at 700 W it
# took 19.1 s, the runs after it 12.1-12.5 s).
RACE_AB_PLAN = (("warmup", "stale1_packed", False), ("stale1_unarmed_1", "stale1_packed", False), ("stale1_armed_1", "stale1_packed", True),
                ("stale1_armed_2", "stale1_packed", True), ("stale1_unarmed_2", "stale1_packed", False))


def overlap_train_path(kernels, plan=None):
    """The overlapped rollout/train pipeline (``method.rollout_overlap``,
    ``max_staleness``, ``pack_train_batch``, ``prompt_buckets``) on the main
    path: ``trlx_tpu_torch.train(reward_fn=...)`` through the paged int8
    engine with ``engine_train``'s settings at GPT-J-6B width and ``OVERLAP_LAYERS`` layers,
    24 steps (three rollout iterations), a reward_fn that spends 0.2 s of
    host time per chunk. Three runs: (a) serial; (b) rollout_overlap at
    staleness 0 with prefetch, whose every store, step statistic and final
    parameter must equal (a)'s bit for bit; (c) staleness 1 with packed
    train batches and two prompt buckets, whose producer stores must read
    the boundary snapshot (the engine's weight_version is the snapshot's),
    run with ``TRLX_TPU_SANITIZE=race`` (``utils.sanitize``): no race
    violation, and some tracked field shared by two threads.
    (a) must launch rows 2-3 (the unpacked backward); (c) rows 1, 4-6, 8
    and 10. The runs' end saves are not written (since fleet_train, the
    smoke's time): ``resilience_drill`` saves, verifies and loads the same
    4-layer state. Returns the three runs' numbers and their summed
    launches. ``plan`` ((label, run, armed), ...) runs those instead and
    checks each alone (``RACE_AB_PLAN``)."""
    import trlx_tpu_torch
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.utils import sanitize

    register_model("OverlapNoSavePPOTrainer")(no_save_trainer())

    n_layer = OVERLAP_LAYERS
    runs_cfg = {
        "serial": {},
        "overlap_s0": {"rollout_overlap": True, "max_staleness": 0, "prefetch_depth": 1},
        "stale1_packed": {"max_staleness": 1, "pack_train_batch": True, "prefetch_depth": 1},
    }

    def slow_reward(samples):
        # 0.2 s of host wall time that leaves the interpreter free, as a call
        # out to a reward service does.
        time.sleep(REWARD_HOST_S)
        return reward_fn(samples)

    orig_make = PPOOrchestrator.make_experience
    stores = []

    def recorded_make(self, num_rollouts=1024, iter_count=0, store=None, snapshot=None, staleness=0, stop=None):
        out = orig_make(self, num_rollouts, iter_count, store=store, snapshot=snapshot, staleness=staleness,
                        stop=stop)
        if out is not None:
            rl = self.rl_model
            st = store if store is not None else rl.store
            stores.append({"columns": st.columns(), "staleness": staleness,
                           "snapshot_version": None if snapshot is None else snapshot["weights"].version,
                           "engine_version": rl._rollout_engine.weight_version})
        return out

    results, launches_sum = {}, dict.fromkeys(kernels, 0)
    # (c) is the run the race sanitizer watches.
    default_plan = tuple((name, name, name == "stale1_packed") for name in runs_cfg)
    PPOOrchestrator.make_experience = recorded_make
    try:
        for name, run_name, armed in plan or default_plan:
            method = runs_cfg[run_name]
            run_dir = os.path.join(RUN_DIR, f"overlap_{name}")
            gen_kwargs = dict(prompt_length=PROMPT_LEN, max_length=MAX_LEN, min_length=MAX_LEN, top_k=0, top_p=0.7,
                              temperature=0.5, do_sample=True)
            if method.get("pack_train_batch"):
                gen_kwargs["prompt_buckets"] = OVERLAP_BUCKETS
            config = train_config(n_layer, "OverlapNoSavePPOTrainer", run_dir,
                                  method=dict(ENGINE, paged_kv=True, **method), quant=True)
            config.method.gen_kwargs = gen_kwargs
            config.train.epochs, config.train.total_steps = 3, 24
            stores.clear()
            free()
            torch.cuda.reset_peak_memory_stats()
            if armed:
                os.environ[sanitize.ENV_VAR] = "race"
                sanitize.refresh()
                sanitize.clear_races()
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            try:
                trainer = trlx_tpu_torch.train(reward_fn=slow_reward, prompts=engine_prompts(),
                                               eval_prompts=seeded_prompts(CHUNK, 1), config=config)
                torch.cuda.synchronize()
            finally:
                race = {"shared_fields": sanitize.shared_fields(), "violations": sanitize.violations()}
                if armed:
                    os.environ.pop(sanitize.ENV_VAR, None)
                    sanitize.refresh()
                    sanitize.clear_races()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in kernels.items()}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if [t.name for t in threading.enumerate() if t.name.startswith("trlx-")]:
                raise AssertionError(f"{name}: trlx-* threads outlived learn()")
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            steps = [r for r in recs if "loss" in r]
            windows = [r for r in recs if "time/overlap_fraction" in r]
            if trainer.iter_count != 24 or len(steps) != 24 or len(windows) != 2 or trainer.saves_skipped != 1:
                raise AssertionError(f"{name}: {trainer.iter_count} steps, {len(steps)} step records, "
                                     f"{len(windows)} phase windows, {trainer.saves_skipped} end saves (expected "
                                     "24, 24, 2, 1)")
            bad = [r["step"] for r in steps if not np.isfinite(r["loss"]) or r["resilience/nonfinite"] != 0.0]
            if bad:
                raise AssertionError(f"{name}: non-finite or skipped steps {bad}")
            snap = trainer._snapshot_weights
            out = {
                "wall_s": wall,
                "iteration_wall_s": [w["time/window_wall_s"] for w in windows],
                "time/rollout_s": [w["time/rollout_s"] for w in windows],
                "time/score_s": [w["time/score_s"] for w in windows],
                "time/train_s": [w["time/train_s"] for w in windows],
                "time/overlap_fraction": [w["time/overlap_fraction"] for w in windows],
                "train_tokens_per_s": [w.get("train_tokens_per_s") for w in windows],
                "pack_fill": [w.get("train_batch_fill") for w in windows],
                "staleness/mean": [r["staleness/mean"] for r in steps if "staleness/mean" in r],
                "stores": [(s["staleness"], s["snapshot_version"], s["engine_version"]) for s in stores],
                "snapshot_bytes": None if snap is None else snap.nbytes(),
                "peak_mem_gb": peak_gb,
                "launches": launches,
            }
            if armed:
                out["sanitize_race"] = {"shared_field_count": len(race["shared_fields"]),
                                        "shared_fields": race["shared_fields"], "violations": race["violations"]}
                if race["violations"] or not race["shared_fields"]:
                    raise AssertionError(f"{name} under TRLX_TPU_SANITIZE=race: {race}")
            log(f"[overlap_train] {name} ({n_layer} layers, {json.dumps(method)}) on {card_line()}: "
                f"{json.dumps({k: v for k, v in out.items() if k != 'staleness/mean'})}")
            log(f"[overlap_train] {name} staleness/mean per logged step {out['staleness/mean']}")
            results[name] = dict(out, steps=[{k: r[k] for k in ("loss", "pg_loss", "vf_loss", "mean_kl", "grad_norm")}
                                             for r in steps], store_columns=[s["columns"] for s in stores],
                                 params={n: fingerprint([p]) for n, p in trainer.model.named_parameters()})
            for k, v in launches.items():
                launches_sum[k] += v
            del trainer
            free()
            shutil.rmtree(run_dir)
    finally:
        PPOOrchestrator.make_experience = orig_make

    if plan:
        return results, launches_sum
    a, b, c = results["serial"], results["overlap_s0"], results["stale1_packed"]
    if b["steps"] != a["steps"] or b["params"] != a["params"] or len(b["store_columns"]) != 3:
        raise AssertionError("(b) rollout_overlap at staleness 0: step stats or final parameters differ from (a)")
    for i, (sa, sb) in enumerate(zip(a["store_columns"], b["store_columns"])):
        for key in sa:
            if not np.array_equal(sa[key], sb[key]):
                raise AssertionError(f"(b) store {i} column {key} differs from (a)'s")
    if b["launches"] != a["launches"]:
        raise AssertionError(f"(b) launched {b['launches']}, (a) {a['launches']}")
    stale_stores = [s for s in c["stores"] if s[0] == 1]
    if len(stale_stores) < 2 or any(v is None or e != v for _, v, e in stale_stores):
        raise AssertionError(f"(c) producer stores (staleness, snapshot version, engine version): {c['stores']}")
    if not max(c["staleness/mean"]) > 0 or not all(f is not None and 0 < f <= 1 for f in c["pack_fill"]):
        raise AssertionError(f"(c) staleness/mean {c['staleness/mean']}, pack_fill {c['pack_fill']}")
    need_c = ("flash_attention_fwd", "fused_logprob_fwd", "fused_logprob_bwd_dx", "fused_logprob_bwd_dw",
              "decode_attention_int8", "paged_decode_attention_int8")
    if any(c["launches"][k] == 0 for k in need_c) or any(a["launches"][k] == 0 for k in (
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        raise AssertionError(f"rows not launched: (a) {a['launches']}, (c) {c['launches']}")
    if c["launches"]["flash_attention_bwd_dq"] or c["launches"]["flash_attention_bwd_dkv"]:
        raise AssertionError(f"(c)'s packed steps launched the flash backward: {c['launches']}")
    return {k: {kk: vv for kk, vv in v.items() if kk not in ("store_columns", "params", "steps")}
            for k, v in results.items()}, launches_sum


DRILL_LAYERS = 4  # depth of the resilience drill, at GPT-J-6B width
DRILL_STEPS = 12
DRILL_RUN1_FAULTS = "reward_exc@1,reward_hang@2,nan_grad@3,ckpt_corrupt@2,sigterm@5"
DRILL_SAVE_INTERVAL = 4  # run 1 saves state_4, then the preemption's state_5: a 4-layer save is 14.2 GB, ~28 s
# nan_layer@9: past the rollback to step 4, graftnum's drill (run 2 arms it);
# its bundle's bisect must name block_3, the last block (9 clamped to the depth).
DRILL_RUN2_FAULTS = "reward_drift@2,nan_grad@6,nan_grad@7,nan_layer@9,slow_step@10"
DRILL_SLOW_STEP_S = 2.0
DRILL_REWARD_TIMEOUT_S = 1.0
# Only the poisoned steps may trip the watchdog: at 0.5 a new store's loss
# jump after a rollout tripped it a second time on random weights, and at
# an unramped LR the loss reached 98.8 by step 12.
DRILL_WATCHDOG_THRESHOLD = 1e6


def drill_fingerprints(trainer, n_layer: int):
    """``state_fingerprints`` without the host state (reading it flushes
    the trainer's resilience buffer, which would change what the watchdog
    sees)."""
    fps = group_fingerprints(trainer, n_layer)
    fps.update(mu=fingerprint(trainer.optimizer.mu), nu=fingerprint(trainer.optimizer.nu),
               count=trainer.optimizer.count, step=trainer.step, bad_steps=trainer.bad_steps)
    return fps


def free_local_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def scrape(port: int, path: str) -> str:
    """GET a path of the trainer's metrics endpoint on this machine."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def incident_bundles(run_dir: str):
    """{reason: [(step directory, incident.json)]} of a run's bundles."""
    root = os.path.join(run_dir, "incidents")
    out = {}
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        with open(os.path.join(root, name, "incident.json")) as f:
            rec = json.load(f)
        out.setdefault(rec["reason"], []).append((name, rec))
    return out


def engine_greedy_tokens(trainer, prompts):
    """Drain the trainer's rollout engine over ``prompts`` under the live
    weights (version ``step``): {prompt ids: response ids}."""
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline

    engine = trainer.rollout_engine()
    pipe = PromptPipeline(prompts, None, max_prompt_length=trainer.prompt_length)
    engine.update_weights(trainer.model, version=trainer.step)
    engine.submit(pipe.input_ids, pipe.attention_mask)
    eps = []
    while True:
        eps.extend(engine.step())
        if engine.idle:
            break
    engine.stats(reset=True)  # the next phase's gauges count only its own calls
    return {tuple(e.prompt_ids.tolist()): e.response_ids.copy() for e in eps}


def chunked_greedy_tokens(trainer, prompts):
    """The chunked sampler's greedy tokens [b, P + R] (host) over
    ``prompts`` under the live weights."""
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline

    pipe = PromptPipeline(prompts, None, max_prompt_length=trainer.prompt_length)
    return trainer.to_host(trainer.rollout_generate(pipe.input_ids, pipe.attention_mask)[0])


def chunked_graph(trainer):
    """The chunked sampler's captured decode graph (None before a capture)."""
    return trainer._generate_fn.keywords["_keep"].get("buffers", {}).get("graph")


def resilience_drill_path(kernels):
    """The resilience layer and the single-process incident path on the main
    path: ``trlx_tpu_torch.train(reward_fn=...)`` through the paged int8
    engine with ``engine_train``'s settings at GPT-J-6B width and
    ``DRILL_LAYERS`` layers (16 prompts, batch 8, 4 PPO epochs, 12 steps),
    reward_fn_timeout 1 s, backoff 0.

    (a) Run 1: ``DRILL_RUN1_FAULTS``, a save every ``DRILL_SAVE_INTERVAL``
    steps (a 4-layer checkpoint is 14.2 GB), spans, the anomaly detector
    (factor 3). It must stop at step 5, preempted, with every fault fired:
    the score wrapper makes 2 more attempts than the chunks it scored (the
    raised one never reaches reward_fn; the hung one's call finishes on its
    abandoned thread, so reward_fn runs chunks + 1 times); one skipped step,
    whose gradients through the hand-written backward kernels are wholly
    non-finite (the kernels hand the NaN on) while parameters and moments
    stay bit-equal and it launches what a step launches; the second
    completed save, the preemption's state_5, named by latest.txt and
    failing verification; a guard_skip bundle at step 3 (threads, the card's
    memory); spans of the train step, the engine and the checkpoints and
    the guard_skip instant.

    (b) Run 2 resumes (greedy decode; its end save, never read, is not
    written since PR 21: the smoke's time), and holds what
    the resumed PPO run of earlier smokes held: the loaded state bit-equal,
    the first resumed step at schedule(step) with mean_ratio within 1 +-
    0.05, every step's launches. It arms the health
    monitor (warmup 1, streaks 1 and 2) with the metrics endpoint on a local
    port and reward_drift@2; the anomaly detector with slow_step@10 (2 s);
    the watchdog (``DRILL_WATCHDOG_THRESHOLD``, patience 2, warmup 1, decay
    0.5, 2 rollbacks) with nan_grad@6 and @7. The resume falls back past state_5 to
    state_4, bit-equal to run 1's state there; step 7's flush rolls back to
    state_4 again, in place, at lr_scale 0.5 (the next step's learning rate
    half the schedule's); a slow_step bundle at step 10; the reward-drift
    detector at CRIT with its bundle; /healthz critical and /metrics serving
    health/* while the run is live; step 12 with a finite loss.

    Since PR 21 the guard-skip bundles carry graftnum's ``numerics.json``:
    run 1's at step 3 (graftnum off) a census naming every trainable leaf
    (the step's gradients are wholly non-finite); run 2 arms graftnum, its
    step-6 bundle's bisect finds the forward clean (the poison reaches the
    loss, not the activations) and ``nan_layer@9``'s names block_3, through
    the hand kernels.

    (c) Run 2's trainer, fresh off its resume load of state_4, decodes 8
    prompts greedily through its engine and its chunked sampler (each
    captures its decode graph); just before the rollback the tokens must
    differ (step 5 moved the weights, at an unramped LR), and right after it,
    replaying the same graphs, they must be equal again. With run 1's async
    save of state_4 (step 5 trains before it is finalized) and run 2's
    bit-equal load, this is the smoke's check of a load into a trainer whose
    decode graphs are captured.

    Returns the runs' numbers and the launches of runs 1 and 2."""
    import trlx_tpu_torch
    from trlx_tpu_torch.observability.spans import read_spans
    from trlx_tpu_torch.resilience import checkpoint as ckpt_util
    from trlx_tpu_torch.trainer import base as trainer_base
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.base import lr_schedule

    if os.environ.get("TRLX_TPU_FAULTS"):
        raise AssertionError("TRLX_TPU_FAULTS is set: it would replace the drill's fault plans")
    n_layer = DRILL_LAYERS
    run_dir = os.path.join(RUN_DIR, "resilience_drill")
    card = card_line()
    check_prompts = engine_prompts()[:ENGINE["engine_slots"]]
    lock = threading.Lock()
    drill = {"reward_fn": 0, "fp": {}, "nan_grads": [], "record_fp": True}

    def counted_reward(samples):
        with lock:  # an abandoned timed-out attempt may call it from its own thread
            drill["reward_fn"] += 1
        return reward_fn(samples)

    orig_guard = trainer_base.guarded_update

    def spy_guard(optimizer, params, grads, loss, bad_steps, **kw):
        out = orig_guard(optimizer, params, grads, loss, bad_steps, **kw)
        if not out[1]:  # a skipped step: the finite elements left in each gradient
            drill["nan_grads"].append([(int(torch.isfinite(g).sum()), g.numel()) for g in grads])
        return out

    def finite_by_name(trainer, counts):
        names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
        return dict(zip(names, counts))

    def on_built(trainer):
        # Run 2's trainer, fresh off its resume load of state_4 and before any
        # rollout: its engine's greedy tokens, the reference the rollback
        # check holds the live engine to (a second trainer would cost another
        # 14.2 GB load the smoke's time limit has no room for).
        if trainer._resumed:
            t0 = time.perf_counter()
            drill["tokens_fresh"] = engine_greedy_tokens(trainer, check_prompts)
            drill["chunked_fresh"] = chunked_greedy_tokens(trainer, check_prompts)
            drill["fresh_s"] = time.perf_counter() - t0
            graph = trainer._rollout_engine._graph
            drill["graph_fresh"] = graph[1] if graph is not None else None
            drill["chunked_graph_fresh"] = chunked_graph(trainer)

    @register_model("SmokeDrillPPOTrainer")
    class SmokeDrillPPOTrainer(make_timed_trainer(kernels, n_layer, on_built=on_built)):
        def train_step(self, batch):
            stats = super().train_step(batch)  # synced, its launches recorded
            if drill["record_fp"]:
                drill["fp"][self.step] = drill_fingerprints(self, n_layer)
            return stats

        def _rollback(self):
            engine = self._rollout_engine
            graph = engine._graph[1] if engine is not None and engine._graph is not None else None
            # The weights the rollback replaces decode otherwise, or the
            # check below would see nothing.
            drill["tokens_pre"] = engine_greedy_tokens(self, check_prompts)
            drill["chunked_pre"] = chunked_greedy_tokens(self, check_prompts)
            ptrs = [t.data_ptr() for t in (*self.model.parameters(), *self.optimizer.mu, *self.optimizer.nu)]
            loads = len(self.checkpoint_log)
            t0 = time.perf_counter()
            super()._rollback()
            rb = {"wall_s": time.perf_counter() - t0, "iter_count": self.iter_count, "lr_scale": self._lr_scale,
                  "rollbacks": self._rollbacks, "load": self.checkpoint_log[loads:],
                  "in_place": ptrs == [t.data_ptr() for t in (*self.model.parameters(), *self.optimizer.mu,
                                                              *self.optimizer.nu)],
                  "graph_before": graph is not None}
            t0 = time.perf_counter()
            drill["tokens_live"] = engine_greedy_tokens(self, check_prompts)
            drill["chunked_live"] = chunked_greedy_tokens(self, check_prompts)
            rb["check_s"] = time.perf_counter() - t0
            rb["chunked_graph_fresh"] = (drill.get("chunked_graph_fresh") is not None
                                         and chunked_graph(self) is drill["chunked_graph_fresh"])
            rb["graph_kept"] = graph is not None and engine._graph is not None and engine._graph[1] is graph
            rb["graph_fresh"] = rb["graph_kept"] and graph is drill.get("graph_fresh")
            rb["engine_version"] = engine.weight_version
            drill["rollback"] = rb

        def save(self, directory=None, block=True):
            if self._resumed:  # run 2's end save: nothing reads it
                drill["end_saves_skipped"] = drill.get("end_saves_skipped", 0) + 1
                return None
            return super().save(directory, block)

        def evaluate(self):
            if self._metrics_exporter is not None:  # run 2's end, with the endpoint still live
                port = self._metrics_exporter.port
                drill["healthz"] = json.loads(scrape(port, "/healthz"))
                drill["metrics_text"] = scrape(port, "/metrics")
            return super().evaluate()

    def config_for(**train):
        config = train_config(n_layer, SmokeDrillPPOTrainer.__name__, run_dir, method=dict(ENGINE, paged_kv=True),
                              quant=True)
        config.train.total_steps = DRILL_STEPS
        config.train.reward_fn_timeout, config.train.reward_fn_backoff = DRILL_REWARD_TIMEOUT_S, 0.0
        config.train.max_incidents = 16  # a detector's own trip must not spend the drill's budget
        # No LR ramp: step 5's update must move the greedy tokens the rollback check compares.
        config.train.lr_ramp_steps = 1
        for key, v in train.items():
            setattr(config.train, key, v)
        return config

    def run(config):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = trlx_tpu_torch.train(reward_fn=counted_reward, prompts=engine_prompts(),
                                       eval_prompts=seeded_prompts(CHUNK, 1), config=config)
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t0

    def records():
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def ckpt_summary(trainer):
        return [{k: rec.get(k) for k in ("op", "name", "fallback", "bytes", "save_s", "write_s", "load_s",
                                         "verify_s", "read_s", "copy_s")} for rec in trainer.checkpoint_log]

    per_step = train_step_launches(kernels, n_layer)
    need = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "fused_logprob_fwd",
            "fused_logprob_bwd_dx", "fused_logprob_bwd_dw", "decode_attention_int8", "paged_decode_attention_int8")
    shutil.rmtree(run_dir, ignore_errors=True)
    trainer_base.guarded_update = spy_guard
    slow_env = os.environ.get("TRLX_TPU_SLOW_STEP_SECONDS")
    for fn in kernels.values():
        fn.launches = 0
    try:
        # ------------------------------------------------------------ run 1
        trainer, wall1 = run(config_for(fault_plan=DRILL_RUN1_FAULTS, checkpoint_interval=DRILL_SAVE_INTERVAL,
                                        trace_spans=True, anomaly_factor=3.0))
        orch = trainer.orch
        deadline = time.time() + 3 * DRILL_REWARD_TIMEOUT_S + 10
        while any(t.name == "call-with-timeout" for t in threading.enumerate()) and time.time() < deadline:
            time.sleep(0.1)
        chunks = len(orch.reward_log)
        recs1 = records()
        step3 = [r for r in recs1 if r.get("step") == 3 and "loss" in r]
        saves = [r["name"] for r in trainer.checkpoint_log if r["op"] == "save"]
        bundles1 = incident_bundles(run_dir)
        events = read_spans(os.path.join(run_dir, "spans.jsonl"))
        span_names = {e["name"] for e in events if e["ph"] == "X"}
        guard3 = [(d, rec) for d, rec in bundles1.get("guard_skip", []) if d == "3"]
        run1 = {
            "wall_s": wall1, "iter_count": trainer.iter_count, "skipped_steps": trainer.skipped_steps,
            "fired": [(f.kind, f.at, f.fired) for f in trainer.fault_plan.faults],
            "reward_calls": orch.reward_log, "reward_fn_runs": drill["reward_fn"], "chunks_scored": chunks,
            "retry_cost_s": [c["wall_s"] - c["last_attempt_s"] for c in orch.reward_log if c["attempts"] > 1],
            "saves": saves, "latest": ckpt_util.latest_pointer(run_dir),
            "state_5_verifies": ckpt_util.verify_checkpoint(run_dir, "state_5")[0],
            "nan_step_finite_grad_elements": [finite_by_name(trainer, c) for c in drill["nan_grads"]],
            "nan_step_launches": trainer.step_log[2]["launches"] if len(trainer.step_log) > 2 else None,
            "incidents": {k: [d for d, _ in v] for k, v in bundles1.items()},
            "incident_capture_s": [(b["step"], b["reason"], b["capture_s"]) for b in trainer._incidents.bundles],
            "ckpt": ckpt_summary(trainer),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        log(f"[resilience_drill] run 1 ({n_layer} layers, {DRILL_RUN1_FAULTS}) on {card}: {json.dumps(run1)}")
        fp = drill["fp"]
        if trainer.iter_count != 5 or not any(r.get("preempted_at_step") == 5 for r in recs1):
            raise AssertionError(f"run 1 stopped at {trainer.iter_count}, not preempted at step 5")
        if not all(f for _, _, f in run1["fired"]):
            raise AssertionError(f"run 1: faults not fired {run1['fired']}")
        if [c["attempts"] for c in orch.reward_log] != [2, 2] or drill["reward_fn"] != chunks + 1:
            raise AssertionError(f"run 1: reward attempts {[c['attempts'] for c in orch.reward_log]} (expected 2, 2: "
                                 f"{chunks} chunks + 2), reward_fn ran {drill['reward_fn']} times (expected "
                                 f"{chunks + 1}: the hung attempt's call finishes on its own thread)")
        if trainer.skipped_steps != 1 or not step3 or step3[0]["resilience/nonfinite"] != 1.0 or \
                step3[0]["resilience/bad_steps"] != 1.0:
            raise AssertionError(f"run 1: skipped {trainer.skipped_steps}, step 3's record {step3}")
        keys = [k for k in fp[2] if k not in ("step", "bad_steps")]
        if any(fp[2][k] != fp[3][k] for k in keys):
            raise AssertionError(f"run 1: the poisoned step 3 changed {[k for k in keys if fp[2][k] != fp[3][k]]}")
        # Every gradient that comes through a hand-written backward kernel
        # (the blocks: rows 2-3 and 5; ln_f: row 5's dx; the LM head: row 6)
        # is wholly non-finite. The embedding's rows of tokens absent from
        # the batch get no gradient, and the value head's first layer keeps
        # zeros for ReLU units dead on every position (PyTorch's ReLU
        # backward selects 0): those two are reported, not held.
        counts = run1["nan_step_finite_grad_elements"]
        kernel_fed = ("transformer.h_", "transformer.ln_f.", "transformer.lm_head.")
        bad = {n: c for n, c in (counts[0] if len(counts) == 1 else {}).items() if n.startswith(kernel_fed) and c[0]}
        if len(counts) != 1 or bad or not any(n.startswith(kernel_fed) for n in counts[0]):
            raise AssertionError(f"run 1: step 3's kernel-fed gradients kept finite values: {bad or counts}")
        if any(rec["launches"] != per_step for rec in trainer.step_log):
            raise AssertionError(f"run 1: step launches {[rec['launches'] for rec in trainer.step_log]} != {per_step}")
        if saves != ["state_4", "state_5"] or run1["latest"] != "state_5" or run1["state_5_verifies"]:
            raise AssertionError(f"run 1: saves {saves}, latest {run1['latest']}, state_5 verifies "
                                 f"{run1['state_5_verifies']}")
        if not guard3:
            raise AssertionError(f"run 1: no guard_skip bundle at step 3: {run1['incidents']}")
        with open(os.path.join(run_dir, "incidents", "3", "numerics.json")) as f:
            census = json.load(f)
        trainable = sorted(n.replace(".", "/") for n, p in trainer.model.named_parameters() if p.requires_grad)
        run1["census"] = {k: census["grad_census"].get(k) for k in ("total_nonfinite_leaves",)}
        log(f"[resilience_drill] run 1's step-3 numerics.json (graftnum off): census of "
            f"{census['grad_census'].get('total_nonfinite_leaves')} non-finite leaves of {len(trainable)} trainable, "
            f"bisect {'forward_bisect' in census}")
        if census["grad_census"].get("total_nonfinite_leaves") != len(trainable) or "forward_bisect" in census or \
                [e["path"] for e in census["grad_census"]["nonfinite_leaves"]] != trainable[:32]:
            raise AssertionError(f"run 1: step 3's census {census['grad_census']} does not name the {len(trainable)} "
                                 "trainable leaves, or a bisect ran with graftnum off")
        with open(os.path.join(run_dir, "incidents", "3", "threads.txt")) as f:
            threads_txt = f.read()
        with open(os.path.join(run_dir, "incidents", "3", "memory.json")) as f:
            mem = json.load(f)["gauges"]
        if "MainThread" not in threads_txt or mem.get("name") != torch.cuda.get_device_name(0) or \
                not mem.get("allocated_bytes"):
            raise AssertionError(f"run 1: the guard_skip bundle's threads ({len(threads_txt)} chars) or memory {mem}")
        want_spans = {"train/step", "engine/prefill", "engine/decode", "rollout/reward_fn", "ckpt/save",
                      "ckpt/finalize"}
        if not want_spans <= span_names or not any(e["ph"] == "i" and e["name"] == "guard_skip" for e in events):
            raise AssertionError(f"run 1 spans: missing {want_spans - span_names} or the guard_skip instant")
        saved4 = fp[4]
        del trainer, orch
        free()

        # ------------------------------------------------------------ run 2
        drill["record_fp"] = False
        os.environ["TRLX_TPU_SLOW_STEP_SECONDS"] = str(DRILL_SLOW_STEP_S)
        config = config_for(resume_from_checkpoint=True, fault_plan=DRILL_RUN2_FAULTS, trace_spans=True,
                            anomaly_factor=3.0, health_monitor=True, health_warmup=1, health_warn_streak=1,
                            health_crit_streak=2, metrics_port=free_local_port(),
                            watchdog_patience=2, watchdog_warmup=1, watchdog_lr_decay=0.5, max_rollbacks=2,
                            watchdog_threshold=DRILL_WATCHDOG_THRESHOLD, graftnum=True)
        config.method.gen_kwargs = dict(config.method.gen_kwargs, do_sample=False)
        trainer, wall2 = run(config)
        launches = {name: fn.launches for name, fn in kernels.items()}
        recs2 = records()
        loads = [r for r in trainer.checkpoint_log if r["op"] == "load"]
        loaded = trainer.fp["start"]
        rb = drill.get("rollback") or {}
        rb_i = next((i for i, r in enumerate(recs2) if "resilience/rollbacks" in r), None)
        after = ([r for r in recs2[rb_i + 1:] if "loss" in r and r["resilience/nonfinite"] == 0.0]
                 if rb_i is not None else [])
        unscaled = float(np.float32(lr_schedule(config.train)(saved4["step"])))  # before the LR decay
        bundles2 = incident_bundles(run_dir)
        steps2 = [r for r in recs2 if "loss" in r]
        health_states = [r["health/reward_drift_state"] for r in recs2 if "health/reward_drift_state" in r]
        run2 = {
            "wall_s": wall2, "iter_count": trainer.iter_count, "skipped_steps": trainer.skipped_steps,
            "fired": [(f.kind, f.at, f.fired) for f in trainer.fault_plan.faults],
            "loads": [(r["name"], r["fallback"], r["load_s"]) for r in loads],
            "rollback": {k: v for k, v in rb.items() if k != "load"},
            "rollback_load_s": [r.get("load_s") for r in rb.get("load", [])],
            "lr_after_rollback": after[0]["learning_rate"] if after else None, "lr_unscaled": unscaled,
            "incidents": {k: [d for d, _ in v] for k, v in bundles2.items()},
            "incident_capture_s": [(b["step"], b["reason"], b["capture_s"]) for b in trainer._incidents.bundles],
            "slow_step_detail": [rec["detail"] for d, rec in bundles2.get("slow_step", []) if d == "10"],
            "healthz_status": drill.get("healthz", {}).get("status"),
            "reward_drift_states": health_states,
            "last_loss": steps2[-1]["loss"] if steps2 else None,
            "ckpt": ckpt_summary(trainer),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
        }
        log(f"[resilience_drill] run 2 (resumed; {DRILL_RUN2_FAULTS}, watchdog, health, /metrics) on {card}: "
            f"{json.dumps(run2)}")
        diff = {k: (loaded.get(k), v) for k, v in saved4.items() if loaded.get(k) != v}
        if not trainer._resumed or diff:
            raise AssertionError(f"run 2: resumed {trainer._resumed}; the loaded state differs from run 1's at step 4: "
                                 f"{diff}")
        if [(r["name"], r["fallback"]) for r in loads] != [("state_4", True), ("state_4", True)] or \
                not trainer.last_restore_fallback:
            raise AssertionError(f"run 2: loads {run2['loads']} (expected the resume and the rollback, each falling "
                                 "back past state_5 to state_4)")
        if (rb.get("iter_count"), rb.get("lr_scale"), rb.get("rollbacks"), rb.get("in_place"), rb.get("graph_kept"),
                rb.get("engine_version")) != (4, 0.5, 1, True, True, 4):
            raise AssertionError(f"run 2: the rollback {run2['rollback']}")
        rb_rec = recs2[rb_i] if rb_i is not None else {}
        if rb_rec.get("step") != 4 or rb_rec.get("resilience/lr_scale") != 0.5:
            raise AssertionError(f"run 2: the rollback record {rb_rec}")
        if not after or abs(after[0]["learning_rate"] - 0.5 * unscaled) > 1e-6 * unscaled:
            raise AssertionError(f"run 2: learning rate after the rollback {run2['lr_after_rollback']}, expected "
                                 f"0.5 x {unscaled}")
        bisects = {}
        for step_dir in ("6", "9"):
            with open(os.path.join(run_dir, "incidents", step_dir, "numerics.json")) as f:
                payload = json.load(f)
            b = payload.get("forward_bisect", {})
            bisects[step_dir] = {"first_nonfinite": b.get("first_nonfinite"), "injected": b.get("injected"),
                                 "taps": [(t.get("tap"), t.get("nan")) for t in b.get("taps", [])],
                                 "census_leaves": payload["grad_census"].get("total_nonfinite_leaves")}
        run2["bisects"] = bisects
        log(f"[resilience_drill] run 2's numerics.json (graftnum armed): {json.dumps(bisects)}")
        taps9 = [t for t, _ in bisects["9"]["taps"]]
        if bisects["6"]["first_nonfinite"] is not None or bisects["6"]["injected"] is not None or \
                (bisects["9"]["first_nonfinite"], bisects["9"]["injected"]) != ("block_3", "block_3") or \
                taps9 != ["embed", "block_0", "block_1", "block_2", "block_3", "ln_f"] or \
                any(n for t, n in bisects["9"]["taps"][:4]):
            raise AssertionError(f"run 2: the bisects {bisects} (step 6 clean, step 9 block_3 first)")
        if not any(d == "10" for d, _ in bundles2.get("slow_step", [])):
            raise AssertionError(f"run 2: no slow_step bundle at step 10: {run2['incidents']}")
        if not health_states or max(health_states) != 2.0 or "health_reward_drift" not in bundles2:
            raise AssertionError(f"run 2: reward drift states {health_states}, bundles {run2['incidents']}")
        healthz, metrics_text = drill.get("healthz", {}), drill.get("metrics_text", "")
        if healthz.get("status") != "critical" or healthz["detectors"]["reward_drift"]["state"] != "crit" or \
                "trlx_tpu_health_reward_drift_state 2.0" not in metrics_text:
            raise AssertionError(f"run 2: /healthz {healthz}, /metrics health gauges "
                                 f"{[ln for ln in metrics_text.splitlines() if 'health_' in ln][:6]}")
        if drill.get("end_saves_skipped") != 1:
            raise AssertionError(f"run 2 asked for {drill.get('end_saves_skipped')} saves, expected its end save")
        if trainer.iter_count != DRILL_STEPS or not steps2 or not np.isfinite(steps2[-1]["loss"]):
            raise AssertionError(f"run 2 ended at {trainer.iter_count} with loss {run2['last_loss']}")
        if any(rec["launches"] != per_step for rec in trainer.step_log):
            raise AssertionError(f"run 2: step launches {[rec['launches'] for rec in trainer.step_log]}")
        first = trainer.step_log[0]
        if first["learning_rate"] != unscaled or \
                not abs(first["mean_ratio"] - 1.0) <= 0.05:
            raise AssertionError(f"run 2's first resumed step: learning_rate {first['learning_rate']}, mean_ratio "
                                 f"{first['mean_ratio']}")
        missing = [k for k in need if not launches[k]]
        if missing:
            raise AssertionError(f"the drill launched no {missing}: {launches}")
        if [t.name for t in threading.enumerate() if t.name.startswith("trlx-")]:
            raise AssertionError("trlx-* threads outlived run 2")
        del trainer
        free()

        # ------------------------------------------------- (c) the rollback check
        live, fresh, pre = drill["tokens_live"], drill["tokens_fresh"], drill["tokens_pre"]
        same = set(live) == set(fresh) and all(np.array_equal(live[k], fresh[k]) for k in live)
        chunked_same = bool(np.array_equal(drill["chunked_live"], drill["chunked_fresh"]))
        check = {"prompts": len(live), "engine_tokens_bit_equal": bool(same), "chunked_tokens_bit_equal": chunked_same,
                 "engine_rows_changed_before_the_rollback": sum(not np.array_equal(pre[k], fresh[k]) for k in fresh),
                 "chunked_rows_changed_before_the_rollback": int(
                     (drill["chunked_pre"] != drill["chunked_fresh"]).any(1).sum()),
                 "fresh_drain_s": drill["fresh_s"], "live_drain_s": rb.get("check_s"),
                 "engine_graph_of_the_fresh_drain_replayed": rb.get("graph_fresh"),
                 "chunked_graph_of_the_fresh_drain_replayed": rb.get("chunked_graph_fresh")}
        log(f"[resilience_drill] rollback check ({n_layer} layers, greedy engine and chunked sampler after the "
            f"rollback vs the same trainer fresh off its state_4 load) on {card}: {json.dumps(check)}")
        if not (same and chunked_same and len(live) == len(check_prompts) and rb.get("graph_fresh")
                and rb.get("chunked_graph_fresh")):
            raise AssertionError("greedy tokens after the rollback differ from the freshly loaded trainer's on "
                                 f"state_4, or a graph is not the one captured then: {check}")
        if not (check["engine_rows_changed_before_the_rollback"] and check["chunked_rows_changed_before_the_rollback"]):
            raise AssertionError(f"no token changed between state_4 and the weights the rollback replaced: the check "
                                 f"sees nothing: {check}")
    finally:
        trainer_base.guarded_update = orig_guard
        if slow_env is None:
            os.environ.pop("TRLX_TPU_SLOW_STEP_SECONDS", None)
        else:
            os.environ["TRLX_TPU_SLOW_STEP_SECONDS"] = slow_env
    shutil.rmtree(run_dir)
    return {"run1": run1, "run2": run2, "rollback_check": check}, launches


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
# The ILQL path's depth, cut from 28 to keep the smoke near 1000 s: the Q
# heads' f32 rows run as at full depth, and rows 1-7 count at full depth on
# hf_rm_train and engine_train.
ILQL_TRAIN_LAYERS = 6  # 8 until dist_train came (the smoke's time limit)
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
    ``ILQL_TRAIN_LAYERS`` layers: 16 seeded token-array samples of 1024
    tokens with seeded rewards, batch 4, one epoch of 4 steps with a
    Polyak sync after each, then ``evaluate()`` of 4 prompts of 768 tokens, 256 new tokens (eos off)
    steered by the target heads on the chunked sampler's graph. Returns its
    numbers and the launches of the whole run."""
    import trlx_tpu_torch

    n_layer, R = ILQL_TRAIN_LAYERS, MAX_LEN - PROMPT_LEN
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
    # The end save stays on disk for ilql_resume, whose load verifies it.
    out["ckpt"] = check_end_save("ilql_train", trainer, run_dir, verify=False)
    out["saved_state"], out["run_dir"] = ilql_state_fingerprints(trainer), run_dir
    del trainer
    free()
    return out, launches


def ilql_state_fingerprints(trainer):
    """ILQL's checkpointed state: the parameter groups' fingerprints (each
    Q head apart), the target heads', the moments', and the scalars."""
    groups = ilql_groups(trainer.model)
    by = {}
    for name, p in trainer.model.named_parameters():
        by.setdefault(groups[name], []).append(p)
    fps = {g: fingerprint(ts) for g, ts in by.items()}
    fps.update(target=fingerprint(trainer.extras.values()), mu=fingerprint(trainer.optimizer.mu),
               nu=fingerprint(trainer.optimizer.nu), count=trainer.optimizer.count, step=trainer.step,
               bad_steps=trainer.bad_steps, host=trainer.host_state_dict())
    return fps


ILQL_RESUME_STEPS = 2  # the resumed ILQL run's steps after ilql_train's ILQL_STEPS


def ilql_resume_path(kernels, saved, run_dir):
    """ILQL through ``train(dataset=...)`` with ``train.resume_from_checkpoint``
    at GPT-J-6B width and ``ILQL_TRAIN_LAYERS`` layers (Q heads N = 4092,
    D = 8192, V = 50400), from ``ilql_train``'s end checkpoint in
    ``run_dir`` into a fresh trainer: its loaded state, target heads
    included, must be bit-equal to the saver's, and ``ILQL_RESUME_STEPS``
    more steps each launch what an ILQL step must (rows 4f-6f among them).
    The saved checkpoint is deleted once loaded: the disk holds one
    checkpoint at a time. Its own end save is not written (since
    dist_train, the smoke's time): ``ilql_train``'s end save of the same
    27.7 GB state is written, checked and loaded here."""
    import trlx_tpu_torch
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    n_layer = ILQL_TRAIN_LAYERS
    total = ILQL_STEPS + ILQL_RESUME_STEPS

    @register_model("SmokeResumedILQLTrainer")
    class SmokeResumedILQLTrainer(ILQLTrainer):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            self.loaded = ilql_state_fingerprints(self)
            self.step_launches = []
            self.saves_skipped = 0
            shutil.rmtree(os.path.join(run_dir, f"state_{saved['step']}"))  # one checkpoint on disk at a time

        def save(self, directory=None, block=True):
            self.saves_skipped += 1

        def train_step(self, batch):
            before = {n: f.launches for n, f in kernels.items()}
            stats = super().train_step(batch)
            torch.cuda.synchronize()
            self.step_launches.append({n: f.launches - before[n] for n, f in kernels.items()})
            return stats

    samples, rewards = ilql_dataset(ILQL_SAMPLES, seed=7)  # ilql_train's
    rng = np.random.default_rng(12)
    eval_prompts = [rng.integers(0, GPTJ_6B_ARCH["vocab_size"], size=PROMPT_LEN).tolist() for _ in range(ILQL_BATCH)]
    config = ilql_config(n_layer, SmokeResumedILQLTrainer.__name__, run_dir)
    config.train.total_steps, config.train.epochs = total, 2
    config.train.resume_from_checkpoint = True
    t0 = time.perf_counter()
    resumed = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=eval_prompts, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    diff = {key: (resumed.loaded.get(key), v) for key, v in saved.items() if resumed.loaded.get(key) != v}
    log(f"[resume] ILQL loaded state vs the saver's: {len(saved) - len(diff)} of {len(saved)} entries equal "
        f"(step {resumed.loaded['step']}, count {resumed.loaded['count']}, target heads {resumed.loaded['target']})")
    if not resumed._resumed or diff:
        raise AssertionError(f"ILQL resumed {resumed._resumed}; loaded state differs from the saved one: {diff}")
    check_loaded_from("ilql_resume", resumed, f"state_{saved['step']}")
    per_step = ilql_step_launches(kernels, n_layer)
    if (resumed.iter_count, resumed.step) != (total, total) or resumed.step_launches != [per_step] * (
            total - saved["step"]):
        raise AssertionError(f"ILQL resumed run: iter_count {resumed.iter_count}, step {resumed.step}, per-step "
                             f"launches {resumed.step_launches}, expected {per_step} each")
    out = {"wall_s": wall, "resumed_step_launches": resumed.step_launches[0], "saves_skipped": resumed.saves_skipped}
    if resumed.saves_skipped != 1:
        raise AssertionError(f"ILQL resumed run asked for {resumed.saves_skipped} saves, expected its end save")
    log(f"[resume] ILQL at GPT-J-6B width ({n_layer} layers): steps {saved['step'] + 1}-{total} after the "
        f"load, each launching {per_step}; {wall:.1f} s")
    del resumed
    free()
    shutil.rmtree(run_dir)
    return out


# ---------------------------------------------------------------------------
# HF checkpoints in and out, text mode and the on-device reward model
# ---------------------------------------------------------------------------

RM_LAYERS = 8  # the reward model's depth at GPT-J-6B width: 2.02 B parameters beside the 6.05 B policy
RM_ROUTE_LAYERS = 2  # depth of the reward model's kernel-versus-plain check
TEXT_LAYERS = 4  # depth of the text-mode PPO path
HF_INIT_STD = 0.02  # the seeded HF weights: N(0, 0.02), LayerNorm weights 1 + N(0, 0.02)

# EleutherAI/gpt-j-6B's published config.json, field for field.
GPTJ_6B_HF_CONFIG = {
    "activation_function": "gelu_new", "architectures": ["GPTJForCausalLM"], "attn_pdrop": 0.0,
    "bos_token_id": 50256, "embd_pdrop": 0.0, "eos_token_id": 50256, "gradient_checkpointing": False,
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "model_type": "gptj", "n_embd": 4096, "n_head": 16,
    "n_inner": None, "n_layer": 28, "n_positions": 2048, "resid_pdrop": 0.0, "rotary": True, "rotary_dim": 64,
    "scale_attn_weights": True, "summary_activation": None, "summary_first_dropout": 0.1,
    "summary_proj_to_labels": True, "summary_type": "cls_index", "summary_use_proj": True,
    "task_specific_params": {"text-generation": {"do_sample": True, "max_length": 50, "temperature": 1.0}},
    "tie_word_embeddings": False, "tokenizer_class": "GPT2Tokenizer", "transformers_version": "4.18.0.dev0",
    "use_cache": True, "vocab_size": 50400,
}


class ByteTokenizer:
    """A byte-level tokenizer for GPT-J's vocabulary (so the smoke needs no
    ``transformers``): a text's UTF-8 bytes are its token ids, 50256 is BOS,
    EOS and pad; decoding maps every other id to the byte id % 256, so a
    sampled row decodes to one character a token."""

    bos_token_id = eos_token_id = pad_token_id = 50256
    bos_token = eos_token = pad_token = "<|endoftext|>"
    padding_side = "left"

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": list(text.encode("utf-8"))}

    def batch_decode(self, tokens, skip_special_tokens=True):
        return [bytes(int(t) % 256 for t in row if int(t) != self.eos_token_id).decode("latin-1")
                for row in np.asarray(tokens)]


def seeded_texts(n: int, seed: int, lo: int = MIN_PROMPT, hi: int = PROMPT_LEN):
    """``n`` printable ASCII strings of seeded lengths in [lo, hi] bytes."""
    rng = np.random.default_rng(seed)
    return ["".join(map(chr, rng.integers(32, 127, size=int(rng.integers(lo, hi + 1))))) for _ in range(n)]


# EleutherAI/gpt-neox-20b's published config.json, field for field.
NEOX_20B_HF_CONFIG = {
    "architectures": ["GPTNeoXForCausalLM"], "attention_probs_dropout_prob": 0, "bos_token_id": 0, "eos_token_id": 0,
    "hidden_act": "gelu_fast", "hidden_dropout_prob": 0, "hidden_size": 6144, "initializer_range": 0.02,
    "intermediate_size": 24576, "layer_norm_eps": 1e-05, "max_position_embeddings": 2048, "model_type": "gpt_neox",
    "num_attention_heads": 64, "num_hidden_layers": 44, "rotary_emb_base": 10000, "rotary_pct": 0.25,
    "tie_word_embeddings": False, "torch_dtype": "float16", "transformers_version": "4.24.0.dev0", "use_cache": True,
    "use_parallel_residual": True, "vocab_size": 50432,
}


def gptj_hf_shapes(n_layer: int):
    """The HF GPT-J state dict's names and shapes at GPT-J-6B width."""
    V, D, F_ = GPTJ_6B_ARCH["vocab_size"], GPTJ_6B_ARCH["d_model"], GPTJ_6B_ARCH["d_ff"]
    shapes = {"transformer.wte.weight": (V, D), "transformer.ln_f.weight": (D,), "transformer.ln_f.bias": (D,),
              "lm_head.weight": (V, D), "lm_head.bias": (V,)}
    for i in range(n_layer):
        h = f"transformer.h.{i}"
        shapes.update({f"{h}.ln_1.weight": (D,), f"{h}.ln_1.bias": (D,), f"{h}.mlp.fc_in.weight": (F_, D),
                       f"{h}.mlp.fc_in.bias": (F_,), f"{h}.mlp.fc_out.weight": (D, F_), f"{h}.mlp.fc_out.bias": (D,)})
        shapes.update({f"{h}.attn.{p}.weight": (D, D) for p in ("q_proj", "k_proj", "v_proj", "out_proj")})
    return shapes


def neox_hf_shapes(n_layer: int):
    """The HF GPT-NeoX state dict's names and shapes at GPT-NeoX-20B width
    (the fused query_key_value in NeoX's [n_head, 3, head_dim] row order)."""
    c = NEOX_20B_HF_CONFIG
    V, D, F_ = c["vocab_size"], c["hidden_size"], c["intermediate_size"]
    shapes = {"gpt_neox.embed_in.weight": (V, D), "gpt_neox.final_layer_norm.weight": (D,),
              "gpt_neox.final_layer_norm.bias": (D,), "embed_out.weight": (V, D)}
    for i in range(n_layer):
        h = f"gpt_neox.layers.{i}"
        for ln in ("input_layernorm", "post_attention_layernorm"):
            shapes.update({f"{h}.{ln}.weight": (D,), f"{h}.{ln}.bias": (D,)})
        shapes.update({f"{h}.attention.query_key_value.weight": (3 * D, D),
                       f"{h}.attention.query_key_value.bias": (3 * D,), f"{h}.attention.dense.weight": (D, D),
                       f"{h}.attention.dense.bias": (D,), f"{h}.mlp.dense_h_to_4h.weight": (F_, D),
                       f"{h}.mlp.dense_h_to_4h.bias": (F_,), f"{h}.mlp.dense_4h_to_h.weight": (D, F_),
                       f"{h}.mlp.dense_4h_to_h.bias": (D,)})
    return shapes


# Each family's published config, the key of its depth there, and its state dict's shapes.
HF_FAMILIES = {"gptj": (GPTJ_6B_HF_CONFIG, "n_layer", gptj_hf_shapes),
               "gpt_neox": (NEOX_20B_HF_CONFIG, "num_hidden_layers", neox_hf_shapes)}


class SeededHF:
    """An HF state dict of ``family`` (``HF_FAMILIES``) of seeded bf16
    values, each made on the card when it is looked up (a pure function of
    the seed and the name), so the checkpoint is written one tensor at a
    time and each loaded parameter can be held against the tensor it was
    written from."""

    LN_WEIGHTS = ("ln_1.weight", "ln_f.weight", "input_layernorm.weight", "post_attention_layernorm.weight",
                  "final_layer_norm.weight")

    def __init__(self, family: str, n_layer: int, seed: int):
        self.shapes, self.seed = HF_FAMILIES[family][2](n_layer), seed

    def __iter__(self):
        return iter(self.shapes)

    def __contains__(self, name):
        return name in self.shapes

    def __getitem__(self, name):
        import zlib

        g = torch.Generator(device="cuda").manual_seed(self.seed * 1_000_003 + zlib.crc32(name.encode()))
        x = torch.randn(self.shapes[name], generator=g, device="cuda") * HF_INIT_STD
        if name.endswith(self.LN_WEIGHTS):
            x += 1.0
        return x.to(torch.bfloat16)

    def nbytes(self) -> int:
        return sum(2 * int(np.prod(s)) for s in self.shapes.values())


def write_hf_checkpoint(path: str, family: str, n_layer: int, seed: int):
    """An HF checkpoint directory of ``family``: the published config.json
    (depth ``n_layer``) and bf16 safetensors of ``SeededHF`` in 5 GB shards
    with an index, written by the port's writer. Returns its record."""
    from trlx_tpu_torch.models.safetensors_io import LazyTensor, write_safetensors

    sd = SeededHF(family, n_layer, seed)
    hf_config, depth_key, _ = HF_FAMILIES[family]
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(hf_config, **{depth_key: n_layer}), f, indent=2)
    t0 = time.perf_counter()
    files = write_safetensors(path, {n: LazyTensor(sd.shapes[n], torch.bfloat16, lambda n=n: sd[n]) for n in sd})
    write_s = time.perf_counter() - t0
    params = sum(int(np.prod(s)) for s in sd.shapes.values())
    return {"path": os.path.basename(path), "family": family, "n_layer": n_layer, "params_b": params / 1e9,
            "gb": sd.nbytes() / 1e9, "files": len(files), "write_s": write_s,
            "write_gb_per_s": sd.nbytes() / 1e9 / write_s}


def check_loaded_trunk(model, n_layer: int, seed: int, name: str, family: str = "gptj"):
    """Every trunk parameter of ``model`` equals, bit for bit, the bf16
    tensor it was written from, converted (transposed; NeoX's fused qkv
    permuted from [n_head, 3, head_dim]) and cast to f32."""
    from trlx_tpu_torch.models.hf_import import trunk_spec

    sd = SeededHF(family, n_layer, seed)
    params = dict(model.transformer.named_parameters())
    spec = trunk_spec(family, model.transformer.cfg)
    if set(spec) != set(params):
        raise AssertionError(f"{name}: the spec names {len(spec)} tensors, the trunk has {len(params)}")
    bad = [n for n, thunk in spec.items() if not torch.equal(params[n], thunk(sd).to(params[n].dtype))]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} loaded tensors differ from what was written: {bad[:4]}")
    return len(spec)


def text_metric(texts):
    if not texts or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"metric_fn got {[type(t).__name__ for t in texts][:4]}, expected strings")
    return {"text_len": np.asarray([float(len(t)) for t in texts])}


def hf_rm_train_path(kernels):
    """The slice's path at GPT-J-6B width and depth: ``train(model_path=<HF
    dir>, prompts=[str], eval_prompts=[str], metric_fn=<over text>,
    config=<reward_model_path = HF dir>)`` with the byte-level tokenizer,
    then ``save_pretrained``. The policy (28 layers, 12.1 GB bf16) and the
    reward model (``RM_LAYERS`` layers) are written as HF directories from
    seeded weights; every loaded trunk tensor is held against what was
    written; both directories are deleted before ``learn()``; the rollouts
    are scored by the reward model, 16 steps run with ``train_config``'s
    values, ``evaluate()`` reports the reward model's mean. The end save
    is checked and deleted (``resilience_drill`` resumes a 4-layer
    checkpoint, whose load verifies a manifest written by the same save).
    Returns its numbers and the launches of the whole run."""
    import trlx_tpu_torch

    n_layer, k, R = GPTJ_6B_ARCH["n_layer"], 2, MAX_LEN - PROMPT_LEN
    run_dir = os.path.join(RUN_DIR, "hf_rm_train")
    pol_dir, rm_dir = os.path.join(RUN_DIR, "hf_policy"), os.path.join(RUN_DIR, "hf_reward_model")
    card = card_line()
    written = [write_hf_checkpoint(pol_dir, "gptj", n_layer, seed=1),
               write_hf_checkpoint(rm_dir, "gptj", RM_LAYERS, seed=2)]
    for rec in written:
        log(f"[hf] wrote {json.dumps(rec)} on {card}")
    built = {}

    def on_built(trainer):
        # Before learn(), before any rollout: the loads held against the
        # written tensors, then the directories deleted.
        built["policy_tensors"] = check_loaded_trunk(trainer.model, n_layer, 1, "policy")
        built["rm_tensors"] = check_loaded_trunk(trainer.rm_model, RM_LAYERS, 2, "reward model")
        built["rm_fp"] = fingerprint(trainer.rm_model.parameters())
        built["load"] = trainer.load_log
        shutil.rmtree(pol_dir)
        shutil.rmtree(rm_dir)

    cls = make_timed_trainer(kernels, n_layer, tokenizer=ByteTokenizer(), on_built=on_built)
    config = train_config(n_layer, cls.__name__, run_dir)
    config.model.model_arch = {}
    config.model.tokenizer_path = "byte-level"
    config.model.reward_model_path = rm_dir
    eval_texts = []

    def metric_fn(texts):
        eval_texts.extend(texts)
        return text_metric(texts)

    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(model_path=pol_dir, prompts=seeded_texts(N_ROLLOUTS, 10),
                                   eval_prompts=seeded_texts(CHUNK, 11), metric_fn=metric_fn, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if os.path.exists(pol_dir) or os.path.exists(rm_dir) or "load" not in built:
        raise AssertionError("the HF directories were not checked and deleted before learn()")

    steps = config.train.total_steps
    chunks = 2 * N_ROLLOUTS // CHUNK  # two make_experience calls
    eval_batches = 1
    bwd_chunks = -(-CHUNK * R // 1024)
    per_step = train_step_launches(kernels, n_layer)
    expected = dict.fromkeys(kernels, 0)
    # A rollout chunk: prefill (n_layer), the policy re-forward (n_layer) and
    # the reference branch (k) with the fused head once each, and the reward
    # model (RM_LAYERS, no LM head); eval: prefill and the reward model.
    expected.update({
        "flash_attention_fwd": (chunks * (2 * n_layer + k + RM_LAYERS) + steps * 2 * n_layer
                                + eval_batches * (n_layer + RM_LAYERS)),
        "decode_attention": (chunks + eval_batches) * n_layer * R,
        "fused_logprob_fwd": 2 * chunks + steps,
        "flash_attention_bwd_dq": steps * n_layer, "flash_attention_bwd_dkv": steps * n_layer,
        "fused_logprob_bwd_dx": steps * bwd_chunks, "fused_logprob_bwd_dw": steps,
    })
    log(f"[hf_rm_train] launches {launches} expected {expected} (a rollout chunk: flash {2 * n_layer + k} policy + "
        f"{RM_LAYERS} reward model, fused head 2; eval: flash {n_layer} + {RM_LAYERS})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    log_ = check_train_steps(trainer, config, per_step)
    if fingerprint(trainer.rm_model.parameters()) != built["rm_fp"]:
        raise AssertionError("the reward model changed during training")
    if not trainer.has_reward_model or trainer.reward_fn is not None or trainer.fused_rollout:
        raise AssertionError("the path did not score with the reward model alone, unfused")
    ev = trainer.eval_log
    if len(ev) != 1 or not np.isfinite(ev[0]["mean_reward"]) or "reward_time" in ev[0]:
        raise AssertionError(f"expected one evaluate() with the reward model's finite mean_reward, got {ev}")
    if len(eval_texts) != CHUNK:
        raise AssertionError(f"metric_fn saw {len(eval_texts)} eval texts, expected {CHUNK}")
    exp = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "exp_time" in rec:
                exp.append({k_: v for k_, v in rec.items() if k_.startswith("exp_") or k_.startswith("rollout_")})
    if len(exp) != 2 or any(r["exp_reward_s"] != 0.0 for r in exp):
        raise AssertionError(f"expected 2 experience phases scored on the device, got {exp}")
    dev_s = [r["device_s"] for r in log_]
    out = {
        "wall_s": wall,
        "load": built["load"],
        "load_gb_per_s": {m: r["bytes"] / 1e9 / r["load_s"] for m, r in built["load"].items()},
        "checked_tensors": {"policy": built["policy_tensors"], "reward_model": built["rm_tensors"]},
        "rm_score_ms_per_chunk": [1e3 * r["exp_rm_score_device_s"] / (N_ROLLOUTS // CHUNK) for r in exp],
        "score_device_s": [r["exp_score_device_s"] for r in exp],
        "step_device_s_median": float(np.median(dev_s)),
        "train_tokens_per_s_median": CHUNK * MAX_LEN / float(np.median(dev_s)),
        "peak_mem_gb": peak_gb,
        "mean_ratio_per_step": [r["mean_ratio"] for r in log_],
        "rollout_mean_score": [r["rollout_mean_score"] for r in exp],
        "eval": {k_: v for k_, v in ev[0].items()},
        "launches": launches,
    }
    log(f"[hf_rm_train] train(model_path=HF dir, reward model {RM_LAYERS} layers, text prompts) at GPT-J-6B "
        f"({n_layer} layers), {steps} steps: {json.dumps(out)} on {card}")
    out["ckpt"] = check_end_save("hf_rm_train", trainer, run_dir, verify=False)
    del trainer
    free()
    shutil.rmtree(run_dir)
    return out, launches


# neox_rm_train: ppo_neox20b_rm_config.yml at GPT-NeoX-20B's width, 4 layers.
NEOX_LAYERS = 4  # the policy's and the reward model's depth (the recipe's model has 44)
NEOX_HEAD_DIM = 96  # 6144 / 64 heads
# Row → the entry function of its head_dim-96 kernel (2h is the template's instance).
H96_KERNELS = {"flash_attention_fwd": "flash_fwd_d96_kernel", "flash_attention_bwd_dkv": "flash_bwd_dkv_d96_kernel"}
H96_ERRS = {"flash_attention_fwd": ("o", "lse"), "flash_attention_bwd_dq": ("dq",), "flash_attention_bwd_dkv": ("dk", "dv")}
# The two legs of one launch: (a) the recipe's own lengths, 2 PPO iterations;
# (b) the smoke's 768 + 256, 1 iteration of 8 steps, then evaluate().
NEOX_LEGS = {
    "a": dict(prompt=32, T=64, num_rollouts=32, epochs=2, total_steps=32, min_prompt=16),
    "b": dict(prompt=PROMPT_LEN, T=MAX_LEN, num_rollouts=16, epochs=1, total_steps=8, min_prompt=MIN_PROMPT),
}
NEOX_FLASH_ROWS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


class NeoXByteTokenizer(ByteTokenizer):
    """``ByteTokenizer`` with GPT-NeoX-20B's special token: its tokenizer's
    ``<|endoftext|>`` is id 0 (bos, eos and pad); printable text bytes
    (32-126) never collide with it."""

    bos_token_id = eos_token_id = pad_token_id = 0


def neox_config(leg: dict, model_type: str, run_dir: str, rm_dir: str):
    """``default_config("ppo_neox20b_rm")`` with the path's changes against
    the recipe as written: the policy and reward model from local HF
    directories of seeded weights (model_path is ``train``'s argument) with
    the byte tokenizer; mesh [1, 1, 1, 1] (the recipe's [-1, 8, 4, 1] is 32
    ranks); the leg's lengths (leg a: the recipe's own), rollouts, epochs and
    steps. Every other value is the recipe's (remat, 2 unfrozen layers,
    batch 8, chunks of 16, lr 8e-5 → 8e-6, 4 PPO epochs, KL 0.05, top_p 0.9
    at temperature 0.7, resume_from_checkpoint on a fresh directory)."""
    return recipe(
        "ppo_neox20b_rm",
        model=dict(model_type=model_type, tokenizer_path="byte-level", reward_model_path=rm_dir),
        train=dict(seq_length=leg["T"], epochs=leg["epochs"], total_steps=leg["total_steps"], mesh=[1, 1, 1, 1],
                   checkpoint_dir=run_dir),
        method=dict(num_rollouts=leg["num_rollouts"]),
        gen_kwargs=dict(prompt_length=leg["prompt"], max_length=leg["T"], min_length=leg["T"]))


def neox_expected_launches(kernels, leg: dict, n_layer: int, k: int, chunk: int, batch: int):
    """The launches of a leg, reckoned from its config: one make_experience
    an epoch (the first in ``train()``, then one after each epoch but the
    last, where ``total_steps`` ends the run); a rollout chunk runs
    the prefill at cache index 0, the policy's re-forward, the reference
    branch (k blocks) and the reward model, the fused head twice; a train
    step runs the flash forward twice a layer (remat), its backward once,
    the fused head's forward once, ds + dx once a 1024-row chunk and dW once;
    eval runs the prefill and the reward model. Flash only where the JAX
    routing admits the length (T >= 256, T % 128 == 0); decode attention is
    the einsum path at head_dim 96 (``decode_attn_eligible`` asks
    head_dim % 128 == 0), so rows 7-10 launch nothing."""
    from trlx_tpu_torch.ops.flash_attention import auto_flash_ok

    R = leg["T"] - leg["prompt"]
    chunks = leg["epochs"] * leg["num_rollouts"] // chunk
    steps = leg["total_steps"]
    flash = auto_flash_ok(leg["T"])
    prefill = n_layer if auto_flash_ok(leg["prompt"]) else 0
    per_step = dict.fromkeys(kernels, 0)
    per_step.update({"fused_logprob_fwd": 1, "fused_logprob_bwd_dx": -(-batch * R // 1024), "fused_logprob_bwd_dw": 1,
                     "flash_attention_fwd": 2 * n_layer if flash else 0,
                     "flash_attention_bwd_dq": n_layer if flash else 0,
                     "flash_attention_bwd_dkv": n_layer if flash else 0})
    total = {name: steps * n for name, n in per_step.items()}
    total["fused_logprob_fwd"] += 2 * chunks
    total["flash_attention_fwd"] += chunks * (prefill + ((2 * n_layer + k) if flash else 0)) + prefill \
        + (n_layer if flash else 0)  # eval: the prefill and the reward model
    return total, per_step, chunks


def neox_leg(kernels, name: str, leg: dict, pol_dir: str, rm_dir: str, card: str):
    """One leg of ``neox_rm_train``: ``trlx_tpu_torch.train(model_path=<HF
    dir>, prompts=[str], eval_prompts=[str], metric_fn=<over text>,
    config=neox_config(...))``, scored by the reward model alone (no
    reward_fn), through the timed trainer whose end save writes nothing (a
    4-layer NeoX-20B state is ~27 GB: the smoke's time). Holds the loads
    against the written tensors, the launches against the reckoning, every
    step's launches and statistics, the reward model frozen and evaluate()'s
    reward-model mean finite. Returns its numbers."""
    import trlx_tpu_torch

    n_layer, k = NEOX_LAYERS, 2
    run_dir = os.path.join(RUN_DIR, f"neox_rm_train_{name}")
    shutil.rmtree(run_dir, ignore_errors=True)
    built = {}

    def on_built(trainer):
        for m in (trainer.model, trainer.rm_model):
            if m.cfg.head_dim != NEOX_HEAD_DIM or m.cfg.d_model != NEOX_20B_HF_CONFIG["hidden_size"]:
                raise AssertionError(f"loaded {m.cfg.d_model} / {m.cfg.head_dim}, not NeoX-20B's width")
        built["policy_tensors"] = check_loaded_trunk(trainer.model, n_layer, 21, "policy", "gpt_neox")
        built["rm_tensors"] = check_loaded_trunk(trainer.rm_model, n_layer, 22, "reward model", "gpt_neox")
        built["rm_fp"] = fingerprint(trainer.rm_model.parameters())
        built["load"] = trainer.load_log

    cls = make_timed_trainer(kernels, n_layer, tokenizer=NeoXByteTokenizer(), on_built=on_built,
                             base=no_save_trainer())
    config = neox_config(leg, cls.__name__, run_dir, rm_dir)
    chunk, batch = config.method.chunk_size, config.train.batch_size
    if leg["total_steps"] != leg["epochs"] * leg["num_rollouts"] // batch * config.method.ppo_epochs:
        raise AssertionError(f"leg ({name}): total_steps must end the run at the last epoch's end")
    eval_texts = []

    def metric_fn(texts):
        eval_texts.extend(texts)
        return text_metric(texts)

    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(
        model_path=pol_dir, prompts=seeded_texts(leg["num_rollouts"], 30, leg["min_prompt"], leg["prompt"]),
        eval_prompts=seeded_texts(batch, 31, leg["min_prompt"], leg["prompt"]), metric_fn=metric_fn,
        config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected, per_step, chunks = neox_expected_launches(kernels, leg, n_layer, k, chunk, batch)
    log(f"[neox_rm_train] leg ({name}) launches {launches} expected {expected}")
    if launches != expected:
        raise AssertionError(f"leg ({name}): kernel launches {launches} != {expected}")
    log_ = check_train_steps(trainer, config, per_step)
    if fingerprint(trainer.rm_model.parameters()) != built["rm_fp"]:
        raise AssertionError("the reward model changed during training")
    if not trainer.has_reward_model or trainer.reward_fn is not None or trainer.fused_rollout:
        raise AssertionError("the path did not score with the reward model alone, unfused")
    if trainer.saves_skipped != 1:
        raise AssertionError(f"expected the end save alone (skipped), got {trainer.saves_skipped}")
    ev = trainer.eval_log
    if len(ev) != 1 or not np.isfinite(ev[0]["mean_reward"]) or len(eval_texts) != batch:
        raise AssertionError(f"expected one evaluate() over {batch} texts with a finite mean_reward, got {ev}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        exp = [r for r in map(json.loads, f) if "exp_time" in r]
    if len(exp) * leg["num_rollouts"] // chunk != chunks or any(r["exp_reward_s"] != 0.0 for r in exp):
        raise AssertionError(f"expected {chunks} chunks scored on the device, got {exp}")
    dev_s = [r["device_s"] for r in log_]
    out = {
        "card": card, "wall_s": wall, "peak_mem_gb": peak_gb, "lengths": [leg["prompt"], leg["T"]],
        "steps": len(log_), "step_device_s_median": float(np.median(dev_s)), "step_device_s": dev_s,
        "rollout_rows_per_s": [r["exp_per_sec"] for r in exp],
        "decode_tokens_per_s": [r["exp_decode_tokens_per_s"] for r in exp],
        "rm_score_ms_per_chunk": [1e3 * r["exp_rm_score_device_s"] / (leg["num_rollouts"] // chunk) for r in exp],
        "load": built["load"], "checked_tensors": {"policy": built["policy_tensors"], "reward_model": built["rm_tensors"]},
        "mean_ratio_step1": log_[0]["mean_ratio"], "eval_mean_reward": ev[0]["mean_reward"],
        "launches_by_row": launches,
    }
    log(f"[neox_rm_train] leg ({name}) at GPT-NeoX-20B width ({n_layer} layers, 64 heads x {NEOX_HEAD_DIM}), "
        f"{leg['prompt']} + {leg['T'] - leg['prompt']} tokens: {json.dumps(out)}")
    del trainer
    free()
    shutil.rmtree(run_dir)
    return out


def neox_rm_train_path(kernels):
    """``ppo_neox20b_rm_config.yml`` on the card at GPT-NeoX-20B's published
    width (d_model 6144, 64 heads x 96, d_ff 24576, rotary_dim 24 with NeoX's
    rotary, parallel residual with two LayerNorms, fused qkv, untied head,
    vocab 50432) and ``NEOX_LAYERS`` layers: the policy and the reward model
    written as NeoX HF directories from seeded bf16 weights, then the two
    legs of ``NEOX_LEGS`` from the same directories (deleted at the end).
    Leg (b) runs every train and scoring pass and every prefill at cache
    index 0 through rows 1-3 at head_dim 96; the smoke fails unless each of
    the three launched. Returns its numbers and leg (b)'s launches."""
    card = card_line()
    pol_dir, rm_dir = os.path.join(RUN_DIR, "neox_policy"), os.path.join(RUN_DIR, "neox_reward_model")
    written = [write_hf_checkpoint(pol_dir, "gpt_neox", NEOX_LAYERS, seed=21),
               write_hf_checkpoint(rm_dir, "gpt_neox", NEOX_LAYERS, seed=22)]
    for rec in written:
        log(f"[hf] wrote {json.dumps(rec)} on {card}")
    legs = {name: neox_leg(kernels, name, leg, pol_dir, rm_dir, card) for name, leg in NEOX_LEGS.items()}
    shutil.rmtree(pol_dir)
    shutil.rmtree(rm_dir)
    launches = legs["b"]["launches_by_row"]
    if not all(launches[n] > 0 for n in NEOX_FLASH_ROWS):
        raise AssertionError(f"leg (b) did not launch rows 1-3 at head_dim {NEOX_HEAD_DIM}: {launches}")
    return {"written": written, "legs": legs}, launches


def text_ppo_path(kernels):
    """Text mode at GPT-J-6B width and ``TEXT_LAYERS`` layers:
    ``train(reward_fn=<over str>, prompts=[str], eval_prompts=[str],
    metric_fn=<over str>)`` with the byte-level tokenizer (random init, 8
    steps). ``reward_fn`` must see only strings, the eval samples must be
    strings. Then ``save_pretrained``: the export read back in part through
    the port's reader must equal the live parameters, bit for bit, and the
    value head its sidecar. Its end save is not written (since dist_train,
    the smoke's time): ``resilience_drill`` saves, verifies and loads the
    same 14.2 GB state, and ``softprompt_train``'s end save is verified
    against its manifest. Returns its numbers and launches."""
    import trlx_tpu_torch
    from trlx_tpu_torch.models.hf_import import trunk_spec
    from trlx_tpu_torch.trainer.ppo import PPOTrainer
    from trlx_tpu_torch.models.safetensors_io import SafetensorsReader

    seen = []

    def text_reward(texts):
        if not texts or not all(isinstance(t, str) for t in texts):
            raise AssertionError(f"reward_fn got {[type(t).__name__ for t in texts][:4]}, expected strings")
        seen.extend(texts)
        return [t.count("e") / max(len(t), 1) for t in texts]

    evals = []

    def metric_fn(texts):
        evals.append(list(texts))
        return text_metric(texts)

    class NoSavePPOTrainer(PPOTrainer):
        saves_skipped = 0

        def save(self, directory=None, block=True):
            self.saves_skipped += 1

    cls = make_timed_trainer(kernels, TEXT_LAYERS, tokenizer=ByteTokenizer(), base=NoSavePPOTrainer)
    run_dir = os.path.join(RUN_DIR, "text_ppo")
    config = train_config(TEXT_LAYERS, cls.__name__, run_dir)
    config.model.tokenizer_path = "byte-level"
    config.train.total_steps, config.train.epochs = 8, 1
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(reward_fn=text_reward, prompts=seeded_texts(N_ROLLOUTS, 12),
                                   eval_prompts=seeded_texts(CHUNK, 13), metric_fn=metric_fn, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    # reward_fn scores the rollouts and the eval samples.
    if trainer.iter_count != 8 or len(seen) != N_ROLLOUTS + CHUNK or len(evals) != 1 or len(evals[0]) != CHUNK:
        raise AssertionError(f"{trainer.iter_count} steps, reward_fn saw {len(seen)} texts, eval {len(evals)} calls")
    # A row decodes to its prompt's bytes (pad and BOS dropped) and one
    # character per response token (EOS is suppressed to the full length).
    lens = sorted(len(t) for t in seen)
    if lens[0] < MIN_PROMPT + MAX_LEN - PROMPT_LEN or lens[-1] > MAX_LEN:
        raise AssertionError(f"decoded rollouts of {lens[0]}..{lens[-1]} characters")
    out = {"wall_s": wall, "steps": trainer.iter_count, "texts": len(seen), "text_chars": [len(t) for t in seen[:4]],
           "eval_sample": evals[0][0][-32:], "step_device_s_median": float(np.median(
               [r["device_s"] for r in trainer.step_log])), "launches": launches}
    log(f"[text_ppo] train(reward_fn=<over str>, prompts=[str]) at GPT-J-6B width, {TEXT_LAYERS} layers: "
        f"{json.dumps(out)}")
    if trainer.saves_skipped != 1:
        raise AssertionError(f"text_ppo asked for {trainer.saves_skipped} saves, expected its end save")
    shutil.rmtree(run_dir)

    out_dir = os.path.join(RUN_DIR, "hf_export")
    t0 = time.perf_counter()
    trainer.save_pretrained(out_dir)
    export_s = time.perf_counter() - t0
    export_gb = sum(os.path.getsize(os.path.join(out_dir, f)) for f in os.listdir(out_dir)) / 1e9
    reader = SafetensorsReader(out_dir)
    spec = trunk_spec("gptj", trainer.model.cfg)
    params = dict(trainer.model.transformer.named_parameters())
    last = TEXT_LAYERS - 1
    subset = ["wte.embedding", "h_0.attn.q_proj.kernel", f"h_{last}.mlp.c_proj.kernel", f"h_{last}.mlp.c_fc.bias",
              f"h_{last}.ln_1.scale", "ln_f.bias", "lm_head.kernel", "lm_head.bias"]
    bad = [n for n in subset if not torch.equal(spec[n](reader).to("cuda"), params[n])]
    heads = np.load(os.path.join(out_dir, "trlx_tpu_heads.npz"))
    v_ok = np.array_equal(heads["v_head/layers_1/kernel"], trainer.model.v_head.layers_1.kernel.detach().cpu().numpy())
    with open(os.path.join(out_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    del reader, heads
    shutil.rmtree(out_dir)
    out["export"] = {"gb": export_gb, "export_s": export_s, "gb_per_s": export_gb / export_s, "checked": subset,
                     "n_layer": hf_cfg["n_layer"]}
    log(f"[text_ppo] save_pretrained: {json.dumps(out['export'])} on {card_line()}")
    if bad or not v_ok or hf_cfg["n_layer"] != TEXT_LAYERS or hf_cfg["architectures"] != ["GPTJForCausalLM"]:
        raise AssertionError(f"the export read back differs: {bad}, value head equal {v_ok}, config {hf_cfg}")
    del trainer
    free()
    return out, launches


def phase_rm_route(kernels):
    """The reward model's score on the kernel route (flash forward) against
    the plain route (einsum attention) on one chunk of 8 × 1024 tokens
    (seeded left-padded prompts, full responses), GPT-J-6B width and
    ``RM_ROUTE_LAYERS`` layers, the same seeded weights; each route's time
    by CUDA events. Tolerance: 2e-2 of max |score|."""
    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import reward_model_scores

    arch = {k_: v for k_, v in GPTJ_6B_ARCH.items() if k_ != "eos_token_id"}
    cfg = LMConfig.from_dict(dict(arch, n_layer=RM_ROUTE_LAYERS))
    rms = {}
    for route, c in (("kernel", cfg), ("plain", cfg.replace(attn_impl="xla"))):
        rm = LMWithValueHead(c, branch_layer=-1, device="cuda")
        init_params(rm, torch.Generator(device="cuda").manual_seed(7))
        rm.requires_grad_(False)
        rms[route] = rm
    prompt = next(iter(PromptPipeline(seeded_prompts(CHUNK, 14), None, max_prompt_length=PROMPT_LEN).create_loader(
        CHUNK)))
    resp = np.random.default_rng(15).integers(0, 50400, size=(CHUNK, MAX_LEN - PROMPT_LEN))
    tokens = torch.as_tensor(np.concatenate([prompt["input_ids"], resp], 1), dtype=torch.int32, device="cuda")
    mask = torch.as_tensor(np.concatenate([prompt["attention_mask"], np.ones_like(resp)], 1), dtype=torch.int32,
                           device="cuda")
    flash = kernels["flash_attention_fwd"]
    before = flash.launches
    got = reward_model_scores(rms["kernel"], tokens, mask)
    n_kernel = flash.launches - before
    ref = reward_model_scores(rms["plain"], tokens, mask)
    n_plain = flash.launches - before - n_kernel
    if (n_kernel, n_plain) != (RM_ROUTE_LAYERS, 0):
        raise AssertionError(f"flash launches: kernel route {n_kernel}, plain route {n_plain}")
    err, tol = check_rel("rm_scores", got, ref, 2e-2)
    out = {"layers": RM_ROUTE_LAYERS, "shape": [CHUNK, MAX_LEN], "max_abs_err": err, "tol": tol,
           "max_abs_score": float(ref.abs().max()),
           "kernel_ms": time_ms(lambda: reward_model_scores(rms["kernel"], tokens, mask), iters=5),
           "plain_ms": time_ms(lambda: reward_model_scores(rms["plain"], tokens, mask), iters=5)}
    log(f"[rm-route] reward model score, kernel vs plain route: {json.dumps(out)} on {card_line()}")
    del rms
    free()
    return out


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
    "w8a16_": ("w8a16_matmul",),  # w8a16_swap_kernel and w8a16_wide_kernel: one launch a product
}


def port_kernels():
    """The kernel wrappers of the fourteen rows, by row name."""
    from trlx_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_int8, paged_decode_attention, paged_decode_attention_int8,
    )
    from trlx_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from trlx_tpu_torch.ops.fused_logprob import (
        fused_logprob_bwd_dw, fused_logprob_bwd_dw_f32, fused_logprob_bwd_dx, fused_logprob_bwd_dx_f32,
        fused_logprob_fwd, fused_logprob_fwd_f32,
    )
    from trlx_tpu_torch.ops.w8a16 import w8a16_matmul

    return {"w8a16_matmul": w8a16_matmul, "flash_attention_fwd": flash_fwd, "flash_attention_bwd_dq": flash_bwd_dq,
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


def device_events(raw):
    """A trace's device records grouped by name, as ``key_averages`` groups
    them (``key``, ``count``, ``self_device_time_total`` in us), read from
    kineto's raw events in one pass: ``key_averages`` first builds the tree
    of every host op, which takes seconds on a long trace (12-13 s on
    ``engine_train``'s three profiled steps at 28 layers, PR 21 call 5)."""
    by_name = {}
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            rec = by_name.get(e.name())
            if rec is None:
                rec = by_name[e.name()] = SimpleNamespace(key=e.name(), count=0, self_device_time_total=0.0)
            rec.count += 1
            rec.self_device_time_total += e.duration_ns() / 1e3
    return list(by_name.values())


def trace_launches(prof, counted):
    """The device events of a finished profile (``device_events``) and what
    it shows of the port's launches: ``traced_launches`` held against the
    wrappers' ``counted`` launches, with the records the trace proves lost
    (``lost_device_records``) beside them."""
    raw = prof.profiler.kineto_results.events()
    events = device_events(raw)
    lost = lost_device_records(raw)
    return events, {"launches": traced_launches(events, counted, lost["lost"]), **lost}


def lost_device_records(raw):
    """The device records that a trace's own API records prove missing, from
    kineto's raw events (each with ``name()``, ``device_type()`` and
    ``correlation_id()``). The profiler on the card drops device records,
    a few or a burst of them, in most long traces while it keeps every host
    API record: a kernel launch whose correlation id has no device record
    lost its kernel, and a graph launch lost as many as it has fewer than
    the fullest launch of the trace (each trace this script takes replays
    one graph). Beside them, the port's kernels in each complete graph
    launch (one with the fullest count): by ``DEVICE_KERNELS`` key, the
    counts the complete launches show (one count where every replay runs
    the same kernels)."""
    device, ours = {}, {}
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            cid = e.correlation_id()
            device[cid] = device.get(cid, 0) + 1
            for k in DEVICE_KERNELS:
                if k in e.name() and "pytorch" not in e.name():
                    ours.setdefault(cid, {})[k] = ours.get(cid, {}).get(k, 0) + 1
    kernel_launches, graph_launches = [], []
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        if "GraphLaunch" in e.name():
            graph_launches.append(e.correlation_id())
        elif "LaunchKernel" in e.name() or "LaunchCooperativeKernel" in e.name():
            kernel_launches.append(device.get(e.correlation_id(), 0))
    records = [device.get(cid, 0) for cid in graph_launches]
    full = max(records, default=0)
    lost = sum(n == 0 for n in kernel_launches) + sum(full - n for n in records)
    complete = [cid for cid, n in zip(graph_launches, records) if n == full and n > 0]
    per_launch = {k: sorted({ours.get(cid, {}).get(k, 0) for cid in complete}) for k in DEVICE_KERNELS}
    return {"lost": lost, "kernel_launch_records": len(kernel_launches), "graph_launch_records": len(records),
            "device_records_per_graph_launch": [min(records, default=0), full],
            "complete_graph_launches": len(complete),
            "kernels_per_complete_graph_launch": {k: v for k, v in per_launch.items() if v != [0]}}


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


W8_SHAPES = ((4096, 4096), (4096, 16384), (16384, 4096), (4096, 50400))  # GPT-J-6B's (K, N): q/k/v/out, c_fc, MLP out, lm_head
# GPT-J-6B's tp-local (K, N) at tp 2: q / k / v, out_proj, fc_in, fc_out (the
# head's int8 copy is whole on every tp rank: W8_SHAPES' last).
W8_TP_SHAPES = ((4096, 2048), (2048, 4096), (4096, 8192), (8192, 4096))


W8_COLD_BYTES = 150_000_000  # int8 weight bytes a cold-weight time rotates through: three times the 50 MB L2


def w8_tolerance(ref) -> float:
    """The W8 product's tolerance on the plain version's ``ref``: 1e-2 of
    max |y|, and never less than three bf16 ulps of max |y| (why: see
    ``phase_w8a16``)."""
    top = float(ref.float().abs().max())
    return max(1e-2 * top, 3 * 2.0 ** (np.floor(np.log2(top)) - 7))  # 2^(e - 7): one bf16 ulp at 2^e


def w8_cold_copies(K: int, N: int) -> int:
    """Distinct int8 weights a cold-weight time rotates through: at least 4
    and ``W8_COLD_BYTES``, so the L2 holds none of the next call's."""
    return max(4, -(-W8_COLD_BYTES // (K * N)))


def w8_inputs(M: int, K: int, N: int, gen, copies: int = 1):
    """x [M, K] bf16, ``copies`` int8 weights [(codes [K, N], f32 scales
    [N])] of N(0, 1/K) kernels and a bias [N], from ``gen``, on the card."""
    from trlx_tpu_torch.ops.w8a16 import quantize_channels

    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    weights = [quantize_channels(torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5) for _ in range(copies)]
    bias = torch.randn((N,), generator=gen, device="cuda") * 0.1
    return x, weights, bias


def rotating(fn, args):
    """A call of ``fn`` over args[1], args[2], ... in turn, one a call."""
    state = {"i": 0}

    def call():
        state["i"] += 1
        return fn(*args[state["i"] % len(args)])

    return call


def phase_w8a16(gen):
    """The W8A16 product against ``w8a16_plain`` at GPT-J-6B's decode shapes
    (M = the chunk's rows; each (K, N) of ``W8_SHAPES``) and one prefill shape
    (M = B * P, c_fc's K and N), within 1e-2 of max |y|, and never less than
    three bf16 ulps of max |y|: the kernel's f32 sums run in another order,
    a sum that lands near a bf16 boundary rounds to the other neighbour, and
    QDense's scale and bias round twice more, so an output may move by two
    ulps (seen at the prefill shape: 0.0625 at |y| in [4, 8), where 1e-2 of
    max |y| = 5.69 allowed 0.057). Times: decode shapes as replays of a graph of 50
    calls (the wrapper's host time would hide the kernel), with the weight
    L2-warm (``ms``: one weight) and cold (``cold_ms``: the calls rotate
    through ``cold_copies`` distinct weights, at least 4 and 150 MB, so the
    50 MB L2 holds none of the next call's, as on the decode path, where every
    weight comes from HBM once a step); prefill by events over back-to-back
    calls; beside each, ``plan``'s launch (x rows a tile, weight columns a
    tile, warpgroups, K splits, grid), the bound (bytes: x, the int8 weight, scale, bias read
    once, y written once; operations: 2 M K N at the bf16 peak), the plain
    version and ``torch.matmul`` of x and the weight in bf16 (warm and cold),
    the yardstick (no PyTorch call reads int8 weights). The row's numbers are
    those of c_fc at decode (M = 8, K = 4096, N = 16384)."""
    from trlx_tpu_torch.ops.w8a16 import launch_plan, w8a16_matmul, w8a16_plain

    # The engine's prefill rows at tp 2: a group of prefill_batch prompts.
    tp_prefill = ENGINE["prefill_batch"] * PROMPT_LEN
    cases = ([(CHUNK, k, n) for k, n in W8_SHAPES] + [(CHUNK * PROMPT_LEN, 4096, 16384)]
             + [(CHUNK, k, n) for k, n in W8_TP_SHAPES] + [(tp_prefill, 4096, 8192)])
    tp_cases = {(CHUNK, k, n) for k, n in W8_TP_SHAPES} | {(tp_prefill, 4096, 8192)}
    shapes = []
    for M, K, N in cases:
        decode = M <= 32
        copies = w8_cold_copies(K, N) if decode else 1
        x, weights, bias = w8_inputs(M, K, N, gen, copies)
        kq, scale = weights[0]
        y = w8a16_matmul(x, kq, scale, bias)
        torch.cuda.synchronize()
        ref = w8a16_plain(x, kq, scale, bias)
        tol = w8_tolerance(ref)
        err = check(f"w8a16 M={M} K={K} N={N}", y, ref, tol)
        if not torch.equal(y, w8a16_matmul(x, kq, scale, bias)):
            raise AssertionError(f"w8a16 M={M} K={K} N={N}: two calls differ")
        timer = graph_ms if decode else time_ms
        wb = [w.to(torch.bfloat16) for w, _ in weights]
        ms = timer(lambda: w8a16_matmul(x, kq, scale, bias))
        mm = timer(lambda: torch.matmul(x, wb[0]))
        plain = time_ms(lambda: w8a16_plain(x, kq, scale, bias), iters=3, warmup=1)
        b_ms, by = bound(M * K * 2 + K * N + 8 * N + M * N * 2, 2 * M * K * N)
        rec = {"M": M, "K": K, "N": N, "tp_local": (M, K, N) in tp_cases, "plan": list(launch_plan(M, N, K, x.device)),
               "max_abs_err": err, "tol": tol, "ms": ms, "timed": "graph" if decode else "events", "plain_ms": plain,
               "matmul_ms": mm, "bound_ms": b_ms, "bound_by": by, "share_of_bound": b_ms / ms}
        if decode:
            rec["cold_ms"] = timer(rotating(w8a16_matmul, [(x, w, s, bias) for w, s in weights]))
            rec["matmul_cold_ms"] = timer(rotating(torch.matmul, [(x, w) for w in wb]))
            rec["cold_copies"] = copies
            rec["cold_share_of_bound"] = b_ms / rec["cold_ms"]
        log(f"[w8a16] {json.dumps(rec)}")
        shapes.append(rec)
        del x, weights, kq, scale, bias, y, ref, wb
        free()
    row = next(r for r in shapes if (r["M"], r["K"], r["N"]) == (CHUNK, 4096, 16384))
    worst = max(shapes, key=lambda r: r["max_abs_err"] / r["tol"])  # the error nearest its tolerance
    return {"max_abs_err": worst["max_abs_err"], "tol": worst["tol"], "err_shape": [worst["M"], worst["K"], worst["N"]],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "matmul_ms": row["matmul_ms"],
            "matmul": "torch.matmul of x and the weight in bf16 (the bf16 decode path's product)",
            "shape": [CHUNK, 4096, 16384], "shapes": shapes}


SOFT_PROMPT_LEN, N_SOFT, SOFT_STEPS = 760, 8, 4
SOFT_LAYERS = 8  # GPT-J-6B width; full depth until the sp phases came (the smoke's time limit)


def softprompt_train_path(kernels):
    """Soft-prompt PPO: ``trlx_tpu_torch.train(reward_fn=...)`` through
    ``PPOSoftpromptTrainer`` at GPT-J-6B width and ``SOFT_LAYERS`` layers with ``N_SOFT``
    prefix rows, prompts of width ``SOFT_PROMPT_LEN`` (prefill 760 + 8 = 768
    and the train sequence 760 + 8 + 256 = 1024 both take flash, by the JAX
    rule), ``SOFT_STEPS`` steps of ``train_config``'s values. No branch: a
    rollout chunk scores by a policy forward and a reference forward (the
    policy's frozen trunk with the initial prefix swapped in); the gradient
    reaches the prefix through every layer, so every layer's flash backward
    runs, and the frozen LM head launches no dW (row 6 at 0). Checks the
    launches, that the trunk, the LM head and the reference stayed bit-equal
    and the prefix and the value head moved. Returns its numbers."""
    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.ppo_softprompt import PPOSoftpromptTrainer

    n_layer, R = SOFT_LAYERS, MAX_LEN - PROMPT_LEN
    cls = make_timed_trainer(kernels, n_layer, base=PPOSoftpromptTrainer)
    run_dir = os.path.join(RUN_DIR, "softprompt_train")
    config = train_config(n_layer, cls.__name__, run_dir, method=dict(n_soft_tokens=N_SOFT),
                          method_name="pposoftpromptconfig", prompt_len=SOFT_PROMPT_LEN)
    config.train.total_steps = SOFT_STEPS
    rng = np.random.default_rng(30)
    prompts = [rng.integers(0, 50400, size=int(rng.integers(MIN_PROMPT, SOFT_PROMPT_LEN + 1))).tolist()
               for _ in range(N_ROLLOUTS + CHUNK)]
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts[:N_ROLLOUTS], eval_prompts=prompts[N_ROLLOUTS:],
                                   config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.fp["end"] = state_fingerprints(trainer, n_layer)

    chunks = N_ROLLOUTS // CHUNK  # one experience phase: the 4 steps end inside the first epoch
    bwd_chunks = -(-CHUNK * R // 1024)
    per_step = dict.fromkeys(kernels, 0)
    per_step.update({"flash_attention_fwd": 2 * n_layer, "flash_attention_bwd_dq": n_layer,
                     "flash_attention_bwd_dkv": n_layer, "fused_logprob_fwd": 1, "fused_logprob_bwd_dx": bwd_chunks})
    expected = dict.fromkeys(kernels, 0)
    # A rollout chunk: prefill (n_layer), the policy and the reference
    # forwards (n_layer each) with the fused head once each; eval: prefill.
    expected.update({
        "flash_attention_fwd": chunks * 3 * n_layer + SOFT_STEPS * 2 * n_layer + n_layer,
        "decode_attention": (chunks + 1) * n_layer * R,
        "fused_logprob_fwd": 2 * chunks + SOFT_STEPS,
        "flash_attention_bwd_dq": SOFT_STEPS * n_layer, "flash_attention_bwd_dkv": SOFT_STEPS * n_layer,
        "fused_logprob_bwd_dx": SOFT_STEPS * bwd_chunks,
    })
    log(f"[softprompt_train] launches {launches} expected {expected} (a rollout chunk: flash {3 * n_layer}, fused "
        f"head 2; per step {per_step}; eval: flash {n_layer}, decode {n_layer}x{R}; no dW: the head is frozen)")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    log_ = trainer.step_log
    if len(log_) != SOFT_STEPS or trainer.iter_count != SOFT_STEPS:
        raise AssertionError(f"{len(log_)} train steps recorded, iter_count {trainer.iter_count}")
    for i, rec in enumerate(log_):
        bad = [k for k, v in rec.items() if k != "launches" and not np.isfinite(v)]
        if rec["launches"] != per_step or bad or rec["resilience/nonfinite"] != 0.0:
            raise AssertionError(f"step {i + 1}: launched {rec['launches']} (expected {per_step}), non-finite {bad}")
    if not abs(log_[0]["mean_ratio"] - 1.0) <= 0.05:
        raise AssertionError(f"step 1 mean_ratio {log_[0]['mean_ratio']} is not within 1 +- 0.05")
    fp = trainer.fp
    moved = [g for g in ("soft_prompt", "v_head") if fp["end"][g] == fp["start"][g]]
    kept = [g for g in ("wte", "frozen_blocks", f"h_{n_layer - 2}", f"h_{n_layer - 1}", "ln_f", "lm_head", "extras")
            if fp["end"][g] != fp["start"][g]]
    if moved or kept:
        raise AssertionError(f"soft prompt PPO: {moved} did not move, {kept} changed")
    if set(trainer.extras) != {"transformer.soft_prompt"}:
        raise AssertionError(f"the reference owns {sorted(trainer.extras)}, expected the initial prefix only")
    dev_s = [r["device_s"] for r in log_]
    params = sum(p.numel() for p in trainer.model.parameters())
    out = {
        "wall_s": wall, "n_layer": n_layer, "n_soft": N_SOFT, "prompt_len": SOFT_PROMPT_LEN,
        "step_device_s": dev_s, "step_device_s_median": float(np.median(dev_s)),
        "train_tokens_per_s_median": CHUNK * (SOFT_PROMPT_LEN + R) / float(np.median(dev_s)),
        "peak_mem_gb": peak_gb, "params": params,
        "reference_bytes": sum(t.numel() * t.element_size() for t in trainer.extras.values()),
        "full_copy_bytes_avoided": params * 4,
        "mean_ratio_per_step": [r["mean_ratio"] for r in log_],
        "eval": {k: v for k, v in trainer.eval_log[0].items()}, "launches": launches,
    }
    log(f"[softprompt_train] train() through PPOSoftpromptTrainer at GPT-J-6B ({n_layer} layers), {SOFT_STEPS} "
        f"steps: {json.dumps(out)} on {card_line()}")
    out["ckpt"] = check_end_save("softprompt_train", trainer, run_dir)
    shutil.rmtree(run_dir)
    del trainer
    free()
    return out, launches


SPEC_K, SPEC_LAYERS, SPEC_SUCCESSORS = 4, 4, 32


SP_LAYERS, SP_STEPS = 4, 4
SP_PROMPT, SP_MAX = 3072, 4096  # ppo_long_config.yml's gen_kwargs
# Step 1 at sp = 4 against sp = 1: |a - b| <= SP_STAT_TOL * max(1, |b|) for the per-token statistics.
# The ring combines four chunks' bf16 outputs in f32 where one kernel rounds once, so per-token
# logprobs differ by bf16 rounding (~1e-2 at most); means over 8 x 1024 tokens stay well inside
# 2e-2. The token-summed mean_kl and mean_return (sums over 1024 tokens of such differences) are
# reported, not held.
SP_STAT_TOL = 2e-2
SP_STAT_KEYS = ("loss", "pg_loss", "vf_loss", "mean_ratio", "mean_entropy", "grad_norm")
SP_REPORTED_KEYS = ("mean_kl", "mean_return", "mean_advantage", "explained_variance")


def sp_config(run_dir: str, mesh, total_steps: int):
    """``ppo_long_config.yml``'s recipe (remat, int8 KV, 2 unfrozen layers,
    seq 4096 from 3072-token prompts, batch 8, 8 rollouts, 4 PPO epochs, its
    optimizer and sampling) at GPT-J-6B width and ``SP_LAYERS`` layers from
    seeded weights, ``total_steps`` steps, no save or eval inside the run,
    with ``mesh`` for train.mesh."""
    return recipe("ppo_long",
                  model=dict(model_path="", tokenizer_path="", model_arch=dict(GPTJ_6B_ARCH, n_layer=SP_LAYERS)),
                  train=dict(total_steps=total_steps, checkpoint_interval=10**6, eval_interval=10**6,
                             mesh=list(mesh), checkpoint_dir=run_dir))


def sp_run(kernels, mesh, total_steps: int, tag: str):
    """``trlx_tpu_torch.train(reward_fn=...)`` on ``sp_config`` through the
    timed trainer, with ``mesh`` handed to the trainer (None: built from
    train.mesh [1, 1, 1, 1]); no checkpoint is written (the smoke's time
    limit). Returns (trainer, wall s, launches, launches by flash mode,
    peak GB)."""
    import trlx_tpu_torch
    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    class SpPPOTrainer(PPOTrainer):
        def __init__(self, config, **kw):
            super().__init__(config, mesh=mesh, **kw)

        def save(self, directory=None, block=True):
            self.saves_skipped = getattr(self, "saves_skipped", 0) + 1

    cls = make_timed_trainer(kernels, SP_LAYERS, base=SpPPOTrainer)
    run_dir = os.path.join(RUN_DIR, tag)
    config = sp_config(run_dir, (1, 1, 1, mesh.shape["sp"] if mesh is not None else 1), total_steps)
    config.model.model_type = cls.__name__
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, GPTJ_6B_ARCH["vocab_size"], size=int(rng.integers(SP_PROMPT * 2 // 3, SP_PROMPT + 1)))
               .tolist() for _ in range(16)]
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    fa.reset_launches()
    t0 = time.perf_counter()
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts[:8], eval_prompts=prompts[8:], config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    by_mode = {name: dict(getattr(fa, w).launches_by_mode) for name, w in (
        ("flash_attention_fwd", "flash_fwd"), ("flash_attention_bwd_dq", "flash_bwd_dq"),
        ("flash_attention_bwd_dkv", "flash_bwd_dkv"))}
    for name, modes in by_mode.items():
        if sum(modes.values()) != launches[name]:
            raise AssertionError(f"[{tag}] {name}: launches by mode {modes} do not sum to {launches[name]}")
    return trainer, wall, launches, by_mode, torch.cuda.max_memory_allocated() / 1e9


def sp_train_path(kernels):
    """Sequence parallelism on the PPO path of ``ppo_long_config.yml``:
    ``train(reward_fn=...)`` at GPT-J-6B width, ``SP_LAYERS`` layers, 3072 +
    1024 tokens, int8 KV, remat, 8 rollouts and ``SP_STEPS`` steps, on a
    ``LocalSpGroup(4)`` mesh (train.mesh [1, 1, 1, 4], the four sp ranks
    played on this card). Every full-sequence pass (the reference branch's
    replay, each train step's forward, its remat recompute and backward)
    runs the zig-zag ring: 4 ranks x 9 live half-pairs a layer, 8 of them
    on a diagonal (offset 0), 28 in the offset mode; prefill and decode stay
    local (the flash kernel at offset 0, row 8 on the int8 cache). Then the
    same run at sp = 1 for one step: the rollouts must be token-identical
    and step 1's statistics within ``SP_STAT_TOL``. Returns its numbers."""
    from trlx_tpu_torch.parallel.mesh import LocalSpGroup, make_mesh
    from trlx_tpu_torch.parallel.ring_attention import causal_live_half_pairs

    n_layer, k, n, R = SP_LAYERS, 2, RING_SP, SP_MAX - SP_PROMPT
    mesh = make_mesh((1, 1, 1, n), sp_group=LocalSpGroup(n))
    trainer, wall, launches, by_mode, peak = sp_run(kernels, mesh, SP_STEPS, "sp_train")
    ring = sum(causal_live_half_pairs(n, "zigzag"))  # flash launches of one ring pass over one layer
    diag = 2 * n  # of which on a diagonal: each rank's two q halves meet their own half once
    passes_fwd = k + SP_STEPS * 2 * n_layer  # the branch replay; each step's forward and remat recompute
    passes_bwd = SP_STEPS * n_layer
    local = 2 * n_layer  # prefill of the rollout chunk and of the eval chunk
    bwd_chunks = -(-8 * R // 1024)
    expected = dict.fromkeys(kernels, 0)
    expected.update({
        "flash_attention_fwd": local + passes_fwd * ring, "flash_attention_bwd_dq": passes_bwd * ring,
        "flash_attention_bwd_dkv": passes_bwd * ring, "decode_attention_int8": 2 * n_layer * R,
        "fused_logprob_fwd": 1 + SP_STEPS, "fused_logprob_bwd_dx": SP_STEPS * bwd_chunks,
        "fused_logprob_bwd_dw": SP_STEPS,
    })
    expected_modes = {
        "flash_attention_fwd": {"causal": local + passes_fwd * diag, "offset": passes_fwd * (ring - diag),
                                "noncausal": 0},
        "flash_attention_bwd_dq": {"causal": passes_bwd * diag, "offset": passes_bwd * (ring - diag), "noncausal": 0},
    }
    expected_modes["flash_attention_bwd_dkv"] = expected_modes["flash_attention_bwd_dq"]
    log(f"[sp_train] launches {launches} expected {expected}; by flash mode {by_mode} expected {expected_modes} "
        f"(a ring pass over a layer: {ring} launches, {diag} on a diagonal; {passes_fwd} forward passes, "
        f"{passes_bwd} backward; prefill {local} local; decode {n_layer}x{R} a chunk, rollout and eval)")
    if launches != expected or by_mode != expected_modes:
        raise AssertionError(f"sp_train launches {launches} / {by_mode} != {expected} / {expected_modes}")
    log_ = trainer.step_log
    if len(log_) != SP_STEPS or trainer.iter_count != SP_STEPS:
        raise AssertionError(f"{len(log_)} train steps recorded, iter_count {trainer.iter_count}")
    for i, rec in enumerate(log_):
        bad = [k_ for k_, v in rec.items() if k_ != "launches" and not np.isfinite(v)]
        if bad or rec["resilience/nonfinite"] != 0.0:
            raise AssertionError(f"sp_train step {i + 1}: non-finite {bad} or a guard skip")
    fp = trainer.fp
    fp["end"] = state_fingerprints(trainer, n_layer)
    trained = ("wte", f"h_{n_layer - 2}", f"h_{n_layer - 1}", "lm_head", "v_head")
    same = [g for g in trained if fp["end"][g] == fp["start"][g]]
    if same or fp["end"]["frozen_blocks"] != fp["start"]["frozen_blocks"]:
        raise AssertionError(f"sp_train: trainable groups {same} unchanged, or the frozen blocks moved")
    tokens_sp = trainer.store.columns()["response_tensors"]
    sp4 = {"wall_s": wall, "peak_mem_gb": peak, "step_device_s": [r["device_s"] for r in log_],
           "stats_step1": {k_: log_[0][k_] for k_ in SP_STAT_KEYS + SP_REPORTED_KEYS}, "eval": trainer.eval_log[0],
           "saves_skipped": trainer.saves_skipped}
    del trainer
    free()

    ref, wall1, launches1, _, peak1 = sp_run(kernels, None, 1, "sp_train_sp1")
    same_tokens = bool(np.array_equal(tokens_sp, ref.store.columns()["response_tensors"]))
    if not same_tokens:
        raise AssertionError("sp_train: the sp = 4 rollouts differ from the sp = 1 rollouts (decode is local)")
    s1 = {k_: ref.step_log[0][k_] for k_ in SP_STAT_KEYS + SP_REPORTED_KEYS}
    diffs = {k_: abs(sp4["stats_step1"][k_] - s1[k_]) for k_ in SP_STAT_KEYS + SP_REPORTED_KEYS}
    off = {k_: diffs[k_] for k_ in SP_STAT_KEYS if not diffs[k_] <= SP_STAT_TOL * max(1.0, abs(s1[k_]))}
    sp1 = {"wall_s": wall1, "peak_mem_gb": peak1, "step_device_s": [r["device_s"] for r in ref.step_log],
           "stats_step1": s1, "launches": launches1}
    del ref
    free()
    out = {"n_layer": n_layer, "sp": n, "sp4": sp4, "sp1": sp1, "step1_abs_diff": diffs, "tol": SP_STAT_TOL,
           "rollouts_token_identical": same_tokens, "launches": launches, "launches_by_mode": by_mode}
    log(f"[sp_train] train() at GPT-J-6B width ({n_layer} layers), T = {SP_MAX}, sp = {n} on a LocalSpGroup mesh "
        f"against sp = 1: {json.dumps(out)} on {card_line()}")
    if off:
        raise AssertionError(f"sp_train: step 1 statistics off beyond {SP_STAT_TOL}: {off}")
    shutil.rmtree(os.path.join(RUN_DIR, "sp_train"), ignore_errors=True)
    shutil.rmtree(os.path.join(RUN_DIR, "sp_train_sp1"), ignore_errors=True)
    return out, launches


DIST_LAYERS = 2  # GPT-J-6B width; the whole model is 0.82 B parameters at this depth
DIST_MESH = (1, 2, 2, 1)  # fsdp 2 x tp 2: 8 local heads, half of every split piece
DIST_WORLD = 4  # processes sharing this one card over gloo (NCCL refuses two ranks on one device)
DIST_PPO_EPOCHS = 1  # 16 rollouts in batches of 8: 2 steps an iteration
DIST_REF_STEPS = 2  # the one process's steps; (b) and (c) hold the mesh's first 2 against them
DIST_STEPS = 4  # the mesh's: iteration 0 from the one process's store, iteration 1 from its producer's
# The dist_engine leg: the mesh's own rollouts through engine_train's paged
# int8 engine with W8A16 decode weights, the producer at staleness 1.
DIST_ENGINE = dict(ENGINE, paged_kv=True, max_staleness=1)
DIST_TIMEOUT_S = 480  # the workers' wall limit, build load and gloo start included
DIST_LP_TOL = 0.25  # (a) max |logprob| difference, teacher-forced: tp reorders every bf16 sum
DIST_LP_MEAN_TOL = 2e-2  # (a) mean |logprob| difference
DIST_VALUE_TOL = 0.1  # (a) max |value| difference
DIST_STAT_TOL = 2e-2  # (b) step 1's statistics from the same store, per token, as sp_train
# (c) after DIST_STEPS steps: each Adam step moves a weight by at most about
# its learning rate (1.412e-4 x count / 100 on the 100-step ramp: 0, 1.4e-6,
# 2.8e-6, 4.2e-6), so two runs that differ only in the order of their sums
# differ by at most twice the sum of those: 1.7e-5. Adam's first steps move
# each weight by about its rate whatever the gradient's size, so the bound
# is reached where a tiny gradient's sign differs; the share of weights that
# moved the reference's way is the finer check.
DIST_PARAM_TOL = 2e-5
DIST_SIGN_AGREE = 0.9
DIST_GREEDY_PROMPTS = 8
DIST_GREEDY_TOKENS = 64  # (e)'s greedy decode: enough tokens to show where tp's bf16 sums split near ties


def dist_config(run_dir: str, mesh, model_type: str = "DistSmokeTrainer"):
    """``train_path``'s config (ppo_gptj_config.yml's values at GPT-J-6B
    width, 768 + 256 tokens, 16 rollouts in chunks of 8, batch 8, one PPO
    epoch an iteration) at ``DIST_LAYERS`` layers on train.mesh ``mesh``:
    ``DIST_REF_STEPS`` steps for one process; on a mesh ``DIST_STEPS`` over
    two iterations with the consistency guard every step, the rollouts
    through ``DIST_ENGINE`` (the paged int8 engine, the producer at
    staleness 1) with int8 decode weights, and graftfleet armed."""
    # An int8 KV cache on both: the engine's, and (e)'s greedy decode reads
    # the same cache kind on both sides (row 8).
    config = train_config(DIST_LAYERS, model_type, run_dir, quant=True)
    config.method.ppo_epochs = DIST_PPO_EPOCHS
    config.train.total_steps = DIST_REF_STEPS
    config.train.mesh = list(mesh)
    if any(a > 1 for a in mesh):
        config.train.total_steps = DIST_STEPS
        config.train.desync_check_interval = 1
        config.train.graftfleet = True
        config.model.decode_weight_quant = True
        for k, v in DIST_ENGINE.items():
            setattr(config.method, k, v)
    return config


def dist_trainer_class(kernels, ref):
    """The trainer of ``dist_train``: before ``learn()`` it scores the fixed
    sequences teacher-forced (a), decodes greedily (e) and, on the mesh,
    takes the reference's store; it records each step's device time, stats
    and the flash and decode kernels' head counts."""
    import dataclasses

    from trlx_tpu_torch.models import lm as lm_mod
    from trlx_tpu_torch.ops.generate import make_generate_fn
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    heads = {"flash": set(), "decode": set(), "paged": set(), "w8": set()}
    flash, decode, paged, w8 = lm_mod.flash_attention, lm_mod.decode_attention, lm_mod.paged_decode_attention, \
        lm_mod.w8a16_matmul

    def flash_spy(q, *a, **kw):
        heads["flash"].add(int(q.shape[2]))
        return flash(q, *a, **kw)

    def decode_spy(q, *a, **kw):
        heads["decode"].add(int(q.shape[1]))
        return decode(q, *a, **kw)

    def paged_spy(q, *a, **kw):
        heads["paged"].add(int(q.shape[1]))
        return paged(q, *a, **kw)

    def w8_spy(x, kq, *a, **kw):
        heads["w8"].add(tuple(int(d) for d in kq.shape))  # the (K, N) each W8 product reads
        return w8(x, kq, *a, **kw)

    lm_mod.flash_attention, lm_mod.decode_attention = flash_spy, decode_spy
    lm_mod.paged_decode_attention, lm_mod.w8a16_matmul = paged_spy, w8_spy

    @register_model("DistSmokeTrainer")
    class DistSmokeTrainer(PPOTrainer):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            self.step_log, self.report, self.heads = [], {}, heads
            # The seeded initial weights (pieces on the mesh: every rank
            # draws the whole tensors, so they are the one process's).
            self.init_params = {n: p.detach().float().cpu().clone() for n, p in self.model.named_parameters()}

        def learn(self):
            self.report["own_store"] = self.store.columns()  # the mesh's: the engine's rollouts
            store = ref["store"] if ref is not None else self.store.columns()
            rows = {k: v[:CHUNK] for k, v in store.items()}
            tokens = np.concatenate([rows["query_tensors"], rows["response_tensors"]], axis=1)
            mask = np.concatenate([rows["query_mask"], rows["response_mask"]], axis=1)
            with torch.no_grad():
                lp, values, _, _ = self.rollout_score(self.put(self.local_rows(tokens)), self.put(self.local_rows(mask)),
                                                      np.zeros(tokens.shape[0] // self.mesh.data_size, np.float32))
            rmask = mask[:, self.prompt_length:]
            self.report["teacher_forced"] = {"logprobs": self.gather_rows(self.to_host(lp)) * rmask,
                                             "values": self.gather_rows(self.to_host(values)) * rmask}
            greedy = make_generate_fn(self.model, dataclasses.replace(self.gen_cfg, do_sample=False,
                                                                      max_new_tokens=DIST_GREEDY_TOKENS))
            prompts = {k: v[:DIST_GREEDY_PROMPTS] for k, v in ref["prompts"].items()} if ref is not None else None
            if prompts is None:
                prompts = {"input_ids": rows["query_tensors"][:DIST_GREEDY_PROMPTS],
                           "attention_mask": rows["query_mask"][:DIST_GREEDY_PROMPTS]}
                self.report["prompts"] = prompts
            toks, _ = greedy(self.put(self.local_rows(prompts["input_ids"])),
                             self.put(self.local_rows(prompts["attention_mask"])), None)
            self.report["greedy"] = self.gather_rows(self.to_host(toks))
            self.report["store"] = store
            if ref is not None:
                # (b): train from the reference's store.
                self.store.clear_history()
                self.store.push_batch(ref["store"])
            coll.reset_traffic()
            torch.cuda.synchronize()
            return super().learn()

        def train_step(self, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            stats = super().train_step(batch)
            end.record()
            torch.cuda.synchronize()
            rec = {k: float(v) for k, v in stats.items()}
            rec["device_s"] = start.elapsed_time(end) / 1e3
            rec["wall_s"] = time.perf_counter() - t0
            self.step_log.append(rec)
            if len(self.step_log) == DIST_REF_STEPS:
                # (c): the pieces after the steps the one process took.
                self.params_at_ref = {n: p.detach().float().cpu().clone() for n, p in self.model.named_parameters()}
                if self.decode_weight_quant:
                    # The int8 copies after an optimizer step: every product of
                    # the two trained blocks and the head re-quantized from the
                    # pieces (collective, the same on every rank), in place.
                    from trlx_tpu_torch.ops.w8a16 import quantize_weights, quantized_weights

                    before = {n: (kq.data_ptr(), sc.data_ptr()) for n, (kq, sc) in quantized_weights(self.model).items()}
                    n = quantize_weights(self.model)
                    after = {n_: (kq.data_ptr(), sc.data_ptr()) for n_, (kq, sc) in quantized_weights(self.model).items()}
                    self.report["requantized"] = {"kernels": n, "in_place": after == before}
            return stats

        def save(self, directory=None, block=True):
            self.saves_skipped = getattr(self, "saves_skipped", 0) + 1

    return DistSmokeTrainer


def dist_run(kernels, mesh, ref, tag: str):
    """``train(reward_fn=...)`` through ``dist_trainer_class`` on
    train.mesh ``mesh`` (every rank of the mesh calls it). Returns the
    trainer, its wall seconds, its launches and its peak memory."""
    import trlx_tpu_torch

    from trlx_tpu_torch.models import lm as lm_mod

    spied = lm_mod.flash_attention, lm_mod.decode_attention, lm_mod.paged_decode_attention, lm_mod.w8a16_matmul
    dist_trainer_class(kernels, ref)
    config = dist_config(os.path.join(RUN_DIR, tag), mesh)
    prompts = engine_prompts() if config.method.rollout_engine else seeded_prompts(N_ROLLOUTS, 0)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=seeded_prompts(CHUNK, 1),
                                       config=config)
    finally:
        lm_mod.flash_attention, lm_mod.decode_attention, lm_mod.paged_decode_attention, lm_mod.w8a16_matmul = spied
    torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0, {n: f.launches for n, f in kernels.items()}, \
        torch.cuda.max_memory_allocated() / 1e9


def dist_worker_cmd(rank: int, run_dir: str):
    """The command of one ``dist_train`` rank: this script in worker mode."""
    return [sys.executable, os.path.abspath(__file__), "--dist-rank", str(rank), "--dist-world", str(DIST_WORLD),
            "--dist-dir", run_dir]


def dist_worker(rank: int, world: int, run_dir: str) -> int:
    """One rank of ``dist_train``: joins the gloo group through a file
    store, trains on ``DIST_MESH`` against the reference's file, checks (a),
    (b) and (c) on its pieces and writes its numbers to
    ``<run_dir>/rank<r>.json``."""
    import torch.distributed as dist
    from trlx_tpu_torch.models.lm import placement_of
    from trlx_tpu_torch.ops import cuda_lib
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel.mesh import barrier

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(run_dir, 'store')}", rank=rank,
                            world_size=world)
    cuda_lib.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = port_kernels()
    ref = torch.load(os.path.join(run_dir, "ref.pt"), weights_only=False)
    # One checkpoint directory for the ranks: graftfleet joins their files.
    trainer, wall, launches, peak = dist_run(kernels, DIST_MESH, ref, "dist_mesh")
    out = {"rank": rank, "coords": trainer.mesh.coords, "wall_s": wall, "peak_mem_gb": peak, "launches": launches,
           "heads": {k: sorted(v) for k, v in trainer.heads.items()}, "steps": trainer.step_log,
           "iter_count": trainer.iter_count, "traffic": coll.traffic(),
           "local_heads": trainer.model.cfg.local_heads, "schedule_crcs": trainer.orch.schedule_crcs,
           "requantized": trainer.report.get("requantized")}
    own = trainer.report["own_store"]
    torch.save({k: own[k] for k in ("query_tensors", "query_mask", "response_tensors", "response_mask", "logprobs")},
               os.path.join(run_dir, f"own_store{rank}.pt"))
    tf, rtf = trainer.report["teacher_forced"], ref["teacher_forced"]
    rmask = ref["store"]["response_mask"][:CHUNK].astype(bool)
    dlp = np.abs(tf["logprobs"] - rtf["logprobs"])[rmask]
    out["a"] = {"logprob_max_abs": float(dlp.max()), "logprob_mean_abs": float(dlp.mean()),
                "value_max_abs": float(np.abs(tf["values"] - rtf["values"])[rmask].max())}
    g, rg = trainer.report["greedy"], ref["greedy"]
    P = trainer.prompt_length
    out["e_greedy_share"] = float((g[:, P:] == rg[:, P:]).mean())
    s1, r1 = trainer.step_log[0], ref["steps"][0]
    out["b"] = {k: abs(s1[k] - r1[k]) / max(1.0, abs(r1[k])) for k in SP_STAT_KEYS + SP_REPORTED_KEYS}
    worst, moved, agree, counted = 0.0, 0.0, 0, 0
    fsdp_rank, tp_rank = trainer.mesh.coords["fsdp"], trainer.mesh.coords["tp"]
    ref_update = torch.load(os.path.join(run_dir, "ref_update.pt"), mmap=True, weights_only=True)
    for name, _ in trainer.model.named_parameters():
        pl = placement_of(trainer.model, name)
        update = ref_update[name] if pl is None else pl.shard(ref_update[name], fsdp_rank, tp_rank)
        start = trainer.init_params[name]
        want = start + update.float()
        mine = trainer.params_at_ref[name]
        worst = max(worst, float((mine - want).abs().max()))
        moved = max(moved, float((mine - start).abs().max()))
        ref_moved = want != start
        agree += int(((mine - start).sign() == (want - start).sign())[ref_moved].sum())
        counted += int(ref_moved.sum())
    out["c"] = {"param_max_abs": worst, "moved_max_abs": moved, "update_sign_agreement": agree / max(counted, 1)}
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    barrier("dist_worker_end")
    dist.destroy_process_group()
    return 0


def dist_engine_logprobs(run_dir: str, ranks):
    """The dist_engine leg's logprob check: the rollouts of the mesh's first
    iteration (the engine's tokens, from W8A16 decode weights; the same node
    rows on every rank) scored by a one-process model with the same seeded
    weights, against the logprobs each rank stored for them (its scoring at
    8 local heads). Returns the differences over the response tokens."""
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    stores = [torch.load(os.path.join(run_dir, f"own_store{r['rank']}.pt"), weights_only=False) for r in ranks]
    for st in stores[1:]:
        for k in ("query_tensors", "response_tensors", "logprobs"):
            if not np.array_equal(st[k], stores[0][k]):
                raise AssertionError(f"dist_engine: the ranks' stores differ in {k}")
    st = stores[0]
    tokens = np.concatenate([st["query_tensors"], st["response_tensors"]], axis=1)
    mask = np.concatenate([st["query_mask"], st["response_mask"]], axis=1)
    trainer = PPOTrainer(dist_config(os.path.join(RUN_DIR, "dist_engine_ref"), (1, 1, 1, 1), model_type="ppo"))
    lps = []
    with torch.no_grad():
        for i in range(0, tokens.shape[0], CHUNK):
            lp, _, _, _ = trainer.rollout_score(trainer.put(tokens[i:i + CHUNK]), trainer.put(mask[i:i + CHUNK]),
                                                np.zeros(min(CHUNK, tokens.shape[0] - i), np.float32))
            lps.append(trainer.to_host(lp))
    del trainer
    free()
    rmask = st["response_mask"].astype(bool)
    d = np.abs(np.concatenate(lps) - st["logprobs"])[rmask]
    return {"rows": int(tokens.shape[0]), "logprob_max_abs": float(d.max()), "logprob_mean_abs": float(d.mean())}


DIST_TP_W8 = {tuple(s) for s in W8_TP_SHAPES} | {W8_SHAPES[-1]}  # the (K, N) a tp-2 rank's W8 products read
# The kernels the dist_engine leg prints by rank: rows 1-6 and row 10.
DIST_ENGINE_ROWS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "fused_logprob_fwd",
                    "fused_logprob_bwd_dx", "fused_logprob_bwd_dw", "paged_decode_attention_int8")


def dist_train_path(kernels):
    """Data, fully sharded and tensor parallelism on the card: ``DIST_WORLD``
    processes share it over gloo on train.mesh ``DIST_MESH`` (fsdp 2 x tp 2)
    at GPT-J-6B width and ``DIST_LAYERS`` layers with ppo_gptj_config.yml's
    values (768 + 256 tokens), held against one process on the same card
    with the same seeded weights, run here first for ``DIST_REF_STEPS``
    steps on ``train_path``'s prompts. Checks: (a) teacher-forced policy
    logprobs and values on the one process's rows (rows 1 and 4 on 8 local
    heads); (b) step 1's statistics from the one process's store within
    ``DIST_STAT_TOL``; (c) after ``DIST_REF_STEPS`` steps the replicated
    parameters bit-equal across ranks (the consistency guard every step) and
    every rank's pieces within ``DIST_PARAM_TOL`` of the one process's; (d)
    every rank launched rows 1-3, 8 and 10 at 8 heads, 4-6 and W8 at every
    tp-local shape; (e), the share of greedy tokens equal to the one
    process's, is printed, not gated. The ``dist_engine`` leg, in the same
    launch: the mesh's own rollouts come from the paged int8 engine with
    W8A16 decode weights (iteration 0 on the main thread, iteration 1 from
    the producer at staleness 1, graftfleet armed); every rank's schedule
    crc of each phase equal (else ``verify_engine_schedule`` raised), the
    staleness recorded at most 1, the rank files graftfleet writes, and the
    engine store's logprobs within (a)'s tolerance of a one-process model on
    the same tokens. No checkpoint is written."""
    run_dir = os.path.join(RUN_DIR, "dist")
    os.makedirs(run_dir, exist_ok=True)
    trainer, wall, launches, peak = dist_run(kernels, (1, 1, 1, 1), None, "dist_single")
    ref = {"store": trainer.report["store"], "teacher_forced": trainer.report["teacher_forced"],
           "greedy": trainer.report["greedy"], "prompts": trainer.report["prompts"], "steps": trainer.step_log}
    torch.save(ref, os.path.join(run_dir, "ref.pt"))
    # The one-process run's update (trained less initial weights) in bf16:
    # ~1e-5 a weight, kept to 3 significant digits, half the bytes to write.
    torch.save({n: (p.detach().float().cpu() - trainer.init_params[n]).to(torch.bfloat16)
                for n, p in trainer.model.named_parameters()}, os.path.join(run_dir, "ref_update.pt"))
    single = {"wall_s": wall, "peak_mem_gb": peak, "launches": launches, "heads": {k: sorted(v) for k, v in
                                                                                   trainer.heads.items()},
              "step_device_s": [r["device_s"] for r in trainer.step_log]}
    del trainer
    free()

    t0 = time.perf_counter()
    procs = []
    for r in range(DIST_WORLD):
        logf = open(os.path.join(run_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(dist_worker_cmd(r, run_dir), stdout=logf, stderr=subprocess.STDOUT), logf))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    failed = []
    for r, (p, logf) in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            failed.append(f"rank {r} timed out")
        if p.returncode:
            failed.append(f"rank {r} exit {p.returncode}")
    for p, logf in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        logf.close()
    mesh_wall = time.perf_counter() - t0
    if failed:
        for r in range(DIST_WORLD):
            with open(os.path.join(run_dir, f"rank{r}.log")) as f:
                log(f"[dist_train] rank {r} output (tail):\n{f.read()[-4000:]}")
        raise AssertionError(f"dist_train: {failed}")
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(run_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    t1 = time.perf_counter()
    engine_lp = dist_engine_logprobs(run_dir, ranks)
    mesh_dir = os.path.join(RUN_DIR, "dist_mesh")
    with open(os.path.join(mesh_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    staleness = [r[k] for r in records for k in ("exp_staleness", "staleness/max") if k in r]
    fleet_files = sorted(n for n in os.listdir(mesh_dir) if n.startswith(("spans.host", "fleet_")))
    from trlx_tpu_torch.observability.fleet import collective_skew_table

    skew = sorted(collective_skew_table(mesh_dir), key=lambda row: -row["p95_ms"])[:6]
    per_step_bytes = {op: v["bytes"] / DIST_STEPS for op, v in ranks[0]["traffic"].items()}
    out = {"mesh": DIST_MESH, "n_layer": DIST_LAYERS, "single": single, "mesh_wall_s": mesh_wall,
           "ranks": [{k: r[k] for k in ("rank", "coords", "wall_s", "peak_mem_gb", "launches", "heads", "a", "b",
                                        "c", "e_greedy_share", "traffic", "local_heads", "schedule_crcs",
                                        "requantized")}
                     | {"step_device_s": [s["device_s"] for s in r["steps"]],
                        "step_wall_s": [s["wall_s"] for s in r["steps"]]} for r in ranks],
           "rank0_traffic_bytes_per_step": per_step_bytes,
           "dist_engine": {"engine_logprobs": engine_lp, "staleness": staleness, "fleet_files": fleet_files,
                           "collective_skew_top": skew, "check_s": time.perf_counter() - t1},
           "tol": {"a_logprob_max": DIST_LP_TOL, "a_logprob_mean": DIST_LP_MEAN_TOL, "a_value": DIST_VALUE_TOL,
                   "b": DIST_STAT_TOL, "c": DIST_PARAM_TOL, "c_sign": DIST_SIGN_AGREE}}
    log(f"[dist_train] {DIST_WORLD} processes on one card over gloo, train.mesh {list(DIST_MESH)} at GPT-J-6B width "
        f"({DIST_LAYERS} layers), against one process: {json.dumps(out)} on {card_line()}")
    for r in ranks:
        log(f"[dist_engine] rank {r['rank']}: schedule crcs {r['schedule_crcs']}, W8 launches "
            f"{r['launches']['w8a16_matmul']} at (K, N) {r['heads']['w8']}, rows 1-6 and 10 launches "
            f"{ {k: r['launches'][k] for k in DIST_ENGINE_ROWS} }, peak {r['peak_mem_gb']:.2f} GB, "
            f"engine logprobs max {engine_lp['logprob_max_abs']:.4f} mean {engine_lp['logprob_mean_abs']:.5f}, "
            f"staleness {staleness} on {card_line()}")
    errors = []
    need = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "fused_logprob_fwd",
            "fused_logprob_bwd_dx", "fused_logprob_bwd_dw", "decode_attention_int8", "paged_decode_attention_int8",
            "w8a16_matmul")
    for r in ranks:
        a, b, c = r["a"], r["b"], r["c"]
        if not (a["logprob_max_abs"] <= DIST_LP_TOL and a["logprob_mean_abs"] <= DIST_LP_MEAN_TOL
                and a["value_max_abs"] <= DIST_VALUE_TOL):
            errors.append(f"rank {r['rank']} (a) {a}")
        off = {k: v for k, v in b.items() if k in SP_STAT_KEYS and not v <= DIST_STAT_TOL}
        if off:
            errors.append(f"rank {r['rank']} (b) {off}")
        if not (c["param_max_abs"] <= DIST_PARAM_TOL and c["moved_max_abs"] > 0
                and c["update_sign_agreement"] >= DIST_SIGN_AGREE):
            errors.append(f"rank {r['rank']} (c) {c}")
        zero = [n for n in need if r["launches"][n] == 0]
        heads = r["heads"]
        if (zero or heads["flash"] != [8] or heads["decode"] != [8] or heads["paged"] != [8]
                or r["local_heads"] != 8 or not DIST_TP_W8 <= {tuple(s) for s in heads["w8"]}):
            errors.append(f"rank {r['rank']} (d) no launches of {zero}, heads and W8 shapes {heads}")
        if r["iter_count"] != DIST_STEPS:
            errors.append(f"rank {r['rank']} stopped at step {r['iter_count']}")
        if r["requantized"] != {"kernels": 2 * W8_PRODUCTS + 1, "in_place": True}:
            errors.append(f"rank {r['rank']} re-quantize after step {DIST_REF_STEPS}: {r['requantized']} (13 kernels "
                          "in place expected: the two trained blocks' products and the head)")
        if r["schedule_crcs"] != ranks[0]["schedule_crcs"] or len(r["schedule_crcs"]) < 2:
            errors.append(f"rank {r['rank']} engine schedule crcs {r['schedule_crcs']} against rank 0's "
                          f"{ranks[0]['schedule_crcs']}")
    if not (engine_lp["logprob_max_abs"] <= DIST_LP_TOL and engine_lp["logprob_mean_abs"] <= DIST_LP_MEAN_TOL):
        errors.append(f"dist_engine: the engine store's logprobs against one process {engine_lp}")
    if not staleness or max(staleness) > 1 or 1.0 not in staleness:
        errors.append(f"dist_engine: recorded staleness {staleness} (a store at staleness 1 expected, none above)")
    want_files = {f"spans.host{r}.jsonl" for r in range(DIST_WORLD)} | {
        f"fleet_collectives.host{r}.jsonl" for r in range(DIST_WORLD)} | {"fleet_clock.jsonl"}
    if not want_files <= set(fleet_files):
        errors.append(f"dist_engine: graftfleet files {fleet_files}")
    if errors:
        raise AssertionError(f"dist_train: {errors}")
    shutil.rmtree(run_dir, ignore_errors=True)
    return out, ranks[0]["launches"]



FLEET_LAYERS = 2  # GPT-J-6B width at dist_train's depth: a publish is the 0.848 G f32 masters, ~3.39 GB
FLEET_ITERS = 2  # iterations of (a), (b) and (d): 2 pay for (c)'s second rollout rank in the smoke's wall
FLEET_C_ITERS = 3  # (c)'s: it adopts ordinal 1 mid-phase and meets the torn ordinal 2, published after iteration 2
FLEET_ROLE_RANKS = 2  # (c)'s rollout role: a gloo world of dp ranks, its fleet I/O on rank 0
FLEET_TIMEOUT_S = 420  # each leg's role processes' wall limit, start and kernel load included
FLEET_LEASE_TTL = 5.0  # (d): the dead worker's lease is reclaimable after this
FLEET_HOOK_STEP = 8  # (c): the engine step of a phase at which the worker waits for the learner's next publish
FLEET_NEED = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "fused_logprob_fwd",
              "fused_logprob_bwd_dx", "fused_logprob_bwd_dw", "decode_attention_int8", "paged_decode_attention_int8",
              "w8a16_matmul")
FLEET_LEARNER_NEED = tuple(k for k in FLEET_NEED if k != "paged_decode_attention_int8")  # no engine: evaluate() only
FLEET_WORKER_NEED = ("flash_attention_fwd", "fused_logprob_fwd", "paged_decode_attention_int8", "w8a16_matmul")


def fleet_config(run_dir: str, iters: int, model_type: str = "FleetSmokeTrainer"):
    """The fleet path's config: ``train_config``'s (ppo_gptj_config.yml's
    values, 768 + 256 tokens, 16 rollouts in chunks of 8, batch 8) at
    ``FLEET_LAYERS`` layers with one PPO epoch an iteration (dist_train's),
    ``iters`` iterations, the rollouts through ``engine_train``'s paged int8
    engine with W8A16 decode weights."""
    config = train_config(FLEET_LAYERS, model_type, run_dir, method=dict(ENGINE, paged_kv=True), quant=True)
    config.model.decode_weight_quant = True
    config.method.ppo_epochs = 1
    config.train.epochs, config.train.total_steps = iters, 2 * iters
    return config


def fleet_wait_publish(trainer, log_to: list):
    """(c)'s hook, in the worker at its phase's ``FLEET_HOOK_STEP``-th engine
    step: when the learner has not yet published the ordinal that follows
    the one this phase may start from (so it will publish without waiting
    for this phase's batch), wait for that publish (or the abort marker, at
    most 120 s), so the next engine sync's weight poll meets it mid-decode."""
    from trlx_tpu_torch.fleet import WeightSubscriber, fleet_paths
    from trlx_tpu_torch.fleet.topology import read_jsonl_or_empty

    paths = fleet_paths(trainer.config.train)
    sub = WeightSubscriber(paths)
    seq = len(read_jsonl_or_empty(paths.stream_index))  # the batch this phase produces
    latest = sub.latest()
    if latest is None or int(latest["ordinal"]) >= seq:
        return
    t0, start = time.perf_counter(), int(latest["ordinal"])
    while time.perf_counter() - t0 < 120 and paths.read_abort() is None:
        latest = sub.latest()
        if latest is not None and int(latest["ordinal"]) > start:
            break
        time.sleep(0.05)
    log_to.append({"seq": seq, "from_ordinal": start, "to": None if latest is None else int(latest["ordinal"]),
                   "waited_s": time.perf_counter() - t0})


def fleet_trainer_class(kernels, hook: bool):
    """The fleet path's trainer: no checkpoint (``resilience_drill`` saves
    and loads a PPO state of this format), a record of each train step's device time and of the
    iteration boundaries; with ``hook`` (leg (c)'s worker) its engine waits
    mid-phase for the learner's next publish."""
    from trlx_tpu_torch.trainer import register_model
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    @register_model("FleetSmokeTrainer")
    class FleetSmokeTrainer(PPOTrainer):
        def __init__(self, config, **kwargs):
            super().__init__(config, **kwargs)
            self.step_log, self.marks, self.hook_log = [], [], []
            self._phase_steps = 0

        def save(self, directory=None, block=True):
            pass

        def learn(self):
            self.marks.append(time.perf_counter())
            try:
                return super().learn()
            finally:
                self.marks.append(time.perf_counter())

        def post_epoch_callback(self):
            self.marks.append(time.perf_counter())
            return super().post_epoch_callback()

        def train_step(self, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            stats = super().train_step(batch)
            end.record()
            torch.cuda.synchronize()
            self.step_log.append({"device_s": start.elapsed_time(end) / 1e3, "loss": float(stats["loss"])})
            return stats

        def _adopt_snapshot(self, snapshot=None):
            self._phase_steps = 0  # a phase starts
            return super()._adopt_snapshot(snapshot)

        def rollout_engine(self):
            fresh = self._rollout_engine is None
            engine = super().rollout_engine()
            if fresh and hook:
                step = engine.step

                def hooked_step():
                    self._phase_steps += 1
                    if self._phase_steps == FLEET_HOOK_STEP:
                        fleet_wait_publish(self, self.hook_log)
                    return step()

                engine.step = hooked_step
            return engine

    return FleetSmokeTrainer


def fleet_scrape(port: int, seen: dict, stop: threading.Event):
    """The learner's own ``/metrics``, scraped while it runs: the largest
    value of each unlabelled ``trlx_tpu_fleet_*`` gauge."""
    import urllib.request

    while not stop.is_set():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                for line in r.read().decode().splitlines():
                    if line.startswith("trlx_tpu_fleet_") and "{" not in line:
                        name, value = line.rsplit(" ", 1)
                        seen[name] = max(seen.get(name, float("-inf")), float(value))
        except Exception:  # noqa: BLE001 — not up yet, or tearing down
            pass
        stop.wait(0.2)


def fleet_run(kernels, config, hook: bool = False, record_stores: bool = False, scrape_port: int = 0):
    """``trlx_tpu_torch.train(reward_fn=...)`` through ``fleet_trainer_class``
    with ``engine_train``'s prompts, the counters set to 0 just before.
    Returns a result dict: wall, launches, peak GB, step and iteration walls,
    parameter fingerprints, the stores make_experience filled (with
    ``record_stores``) and the scraped fleet gauges."""
    import trlx_tpu_torch
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator

    fleet_trainer_class(kernels, hook)
    orig_make, stores = PPOOrchestrator.make_experience, []

    def recorded_make(self, num_rollouts=1024, iter_count=0, store=None, **kw):
        out = orig_make(self, num_rollouts, iter_count, store=store, **kw)
        if out is not None:
            cols = (store if store is not None else self.rl_model.store).columns()
            stores.append({k: v for k, v in cols.items() if k != "staleness"})
        return out

    seen, stop, scraper = {}, threading.Event(), None
    if scrape_port:
        scraper = threading.Thread(target=fleet_scrape, args=(scrape_port, seen, stop), daemon=True)
        scraper.start()
    if record_stores:
        PPOOrchestrator.make_experience = recorded_make
    free()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=engine_prompts(),
                                       eval_prompts=seeded_prompts(CHUNK, 1), config=config)
        torch.cuda.synchronize()
    finally:
        PPOOrchestrator.make_experience = orig_make
        stop.set()
        if scraper is not None:
            scraper.join(timeout=5)
    out = {"wall_s": time.perf_counter() - t0, "launches": {n: f.launches for n, f in kernels.items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "iter_count": trainer.iter_count,
           "step_device_s": [r["device_s"] for r in trainer.step_log],
           "iteration_wall_s": list(np.diff(trainer.marks)), "hook": trainer.hook_log,
           "params": {n: fingerprint([p]) for n, p in trainer.model.named_parameters()}, "gauges": seen,
           "stores": stores, "schedule_crcs": list(trainer.orch.schedule_crcs),
           "weight_pushes": [[list(p) for p in phase] for phase in trainer.orch.weight_pushes]}
    if trainer._fleet_weights is not None:
        out["fleet_modules"] = len(trainer._fleet_weights.modules)
        out["fleet_module_is_live"] = any(m is trainer.model for m in trainer._fleet_weights.modules)
    del trainer
    free()
    return out


def fleet_role_cmd(role: str, leg_dir: str, tag: str, iters: int, staleness: int, extra=()):
    """The command of one role process of a fleet leg: this script in fleet
    worker mode."""
    return [sys.executable, os.path.abspath(__file__), "--fleet-role", role, "--fleet-leg-dir", leg_dir,
            "--fleet-tag", tag, "--fleet-iters", str(iters), "--fleet-staleness", str(staleness), *extra]


def fleet_role_config(role: str, leg_dir: str, tag: str, iters: int, staleness: int):
    config = fleet_config(os.path.join(leg_dir, tag), iters)
    config.method.fleet_disaggregate = True
    config.method.max_staleness = staleness
    config.train.fleet_dir = os.path.join(leg_dir, "fleet")
    config.train.heartbeat_interval = 0.5
    config.train.fleet_episode_timeout = 60.0
    config.train.fleet_stream_retries = 2
    config.train.fleet_stream_backoff = 1.0
    config.train.fleet_heartbeat_timeout = 60.0
    config.train.fleet_broadcast_deadline = 300.0
    return config


def fleet_worker(args) -> int:
    """One role process of a fleet leg (``--fleet-role`` rollout or learner,
    the fleet's own switches in its environment): trains or serves through
    ``fleet_run`` and writes its numbers to ``<leg dir>/<tag>.json``. A
    ``--fleet-wait-claim W:U`` process waits, set up, until worker W has
    claimed a unit >= U before it joins. ``--fleet-rank R --fleet-world N``:
    rank R of a role world of N dp ranks (gloo through a file store in the
    leg's directory; the hook runs on rank 0 only, the others follow its
    decisions)."""
    from trlx_tpu_torch.fleet.topology import read_jsonl_or_empty
    from trlx_tpu_torch.ops import cuda_lib

    role, leg_dir, tag = args["--fleet-role"], args["--fleet-leg-dir"], args["--fleet-tag"]
    iters, staleness = int(args["--fleet-iters"]), int(args["--fleet-staleness"])
    rank, world = int(args.get("--fleet-rank", 0)), int(args.get("--fleet-world", 1))
    torch.cuda.set_device(0)
    if world > 1:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{os.path.join(leg_dir, 'store_' + role)}", rank=rank,
                                world_size=world)
    cuda_lib.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = port_kernels()
    config = fleet_role_config(role, leg_dir, tag, iters, staleness)
    config.train.mesh = (world, 1, 1, 1)
    config.method.fleet_elastic = "--fleet-elastic" in args
    config.method.fleet_inflight_weights = "--fleet-inflight" in args
    if config.method.fleet_elastic:
        config.train.fleet_lease_ttl = FLEET_LEASE_TTL
    if "--fleet-wait-claim" in args:
        w, u = (int(x) for x in args["--fleet-wait-claim"].split(":"))
        events = os.path.join(config.train.fleet_dir, "fleet_events.jsonl")
        t0 = time.perf_counter()
        while not any(e["event"] == "lease_claimed" and e.get("worker") == w and e["unit"] >= u
                      for e in read_jsonl_or_empty(events)):
            if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
                raise AssertionError(f"fleet_train: worker {w} never claimed a unit >= {u}")
            time.sleep(0.1)
    port = int(os.environ.get("TRLX_TPU_METRICS_PORT", "0") or 0)
    out = fleet_run(kernels, config, hook="--fleet-hook" in args and rank == 0, scrape_port=port)
    out.pop("stores")
    out["role"], out["tag"], out["rank"] = role, tag, rank
    with open(os.path.join(leg_dir, f"{tag}.json"), "w") as f:
        json.dump(out, f)
    return 0


def fleet_leg(name: str, leg_dir: str, roles):
    """Start every role process of a leg (``roles``: (tag, command, extra
    environment, expected exit code), started in order), wait for all under
    ``FLEET_TIMEOUT_S``, and return each tag's result (None for a process
    that ends without writing one) and the leg's wall."""
    os.makedirs(leg_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for tag, cmd, env, want in roles:
        logf = open(os.path.join(leg_dir, f"{tag}.log"), "w")
        full_env = dict(os.environ)
        for var in ("TRLX_TPU_FAULTS", "TRLX_TPU_FLEET_ROLE", "TRLX_TPU_FLEET_WORKER", "TRLX_TPU_METRICS_PORT"):
            full_env.pop(var, None)
        full_env.update(env)
        procs.append((tag, subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, env=full_env), logf, want))
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    failed = []
    for tag, p, logf, want in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            failed.append(f"{tag} timed out")
        if p.returncode != want:
            failed.append(f"{tag} exit {p.returncode} (expected {want})")
    for tag, p, logf, want in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        logf.close()
    wall = time.perf_counter() - t0
    if failed:
        for tag, *_ in procs:
            with open(os.path.join(leg_dir, f"{tag}.log")) as f:
                log(f"[fleet_train] {name} {tag} output (tail):\n{f.read()[-4000:]}")
        raise AssertionError(f"fleet_train {name}: {failed}")
    results = {}
    for tag, *_ in procs:
        path = os.path.join(leg_dir, f"{tag}.json")
        results[tag] = json.load(open(path)) if os.path.exists(path) else None
    return results, wall


def fleet_stream_stores(fleet_dir: str, elastic: bool):
    """The consumed batches of a fleet directory, in consume order: the
    stream's (single-worker) records, or each unit's chosen record."""
    from trlx_tpu_torch.fleet import ElasticStreamReader, EpisodeStreamReader, FleetPaths

    paths = FleetPaths(fleet_dir)
    reader = ElasticStreamReader(paths) if elastic else EpisodeStreamReader(paths)
    recs = [r for _, r in sorted((reader.chosen() if elastic else reader.index()).items())]
    return recs, [{k: v for k, v in reader.load(r).items() if k != "staleness"} for r in recs]


def fleet_stores_equal(name: str, got, ref, errors: list):
    if len(got) < len(ref):
        errors.append(f"{name}: {len(got)} consumed stores, (a) has {len(ref)}")
        return
    for i, (g, r) in enumerate(zip(got, ref)):
        for key in r:
            if key not in g or g[key].dtype != r[key].dtype or not np.array_equal(g[key], r[key]):
                errors.append(f"{name}: store {i} column {key} differs from (a)'s")
                return


def fleet_publish_stats(events):
    pub = [e for e in events if e["event"] == "weights_published"]
    loads = [e for e in events if e["event"] in ("weights_fetched", "weights_adopted_inflight")]
    return {"publishes": len(pub), "bytes": pub[0]["bytes"] if pub else None,
            "d2h_s": [round(e["d2h_s"], 3) for e in pub], "write_s": [round(e["write_s"], 3) for e in pub],
            "load_s": [round(e["load_s"], 3) for e in loads], "h2d_s": [round(e["h2d_s"], 3) for e in loads]}


def fleet_train_path(kernels):
    """The disaggregated and elastic fleet (``trlx_tpu_torch.fleet``) on the
    engine main path at GPT-J-6B width and ``FLEET_LAYERS`` layers
    (``fleet_config``): (a) serial, ``FLEET_ITERS`` iterations, no fleet;
    (b) the colocated fleet at staleness 0 in this process, through the real
    npz transports: every consumed store and the end weights bit-equal to
    (a)'s; (c) a learner process and a rollout role of ``FLEET_ROLE_RANKS``
    gloo ranks (dp; rank 0 does the role's fleet I/O and sends each publish's
    leaves to the others) at staleness 1, ``FLEET_C_ITERS`` iterations, with
    in-flight weight updates and ``weight_push_torn@2`` on the learner: every
    consumed batch at staleness <= 1, every streamed version (and span)
    published, the torn ordinal rejected by the role, a push adopted
    mid-phase (an episode of two spans; the learner's
    ``fleet/mixed_version_tokens`` gauge nonzero) by every rank at the same
    engine sync (equal push logs) with equal engine schedule crcs, every
    adoption timed on every rank, the role out with exit 0 on the abort
    marker; (d) a learner and two
    elastic workers at staleness 0, ``worker_kill_mid_lease@1`` in worker 1
    (worker 0 joins once worker 1 claimed unit 1): worker 0 reclaims the
    unit at the next lease generation, every unit consumed once
    (``fleet/units_reclaimed_total`` 1, ``fleet/episodes_deduped_total`` 0),
    the consumed stores and the learner's end weights bit-equal to (a)'s.
    Logs a publish's bytes and seconds, each process's peak, the legs' and
    iterations' walls, the staleness per consumed batch, the workers'
    W8 and rows 8 / 10 launches. The fleet directories are removed."""
    from trlx_tpu_torch.fleet.topology import read_jsonl_or_empty

    root = os.path.join(RUN_DIR, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    errors, legs = [], {}
    smi = card_line()

    # (a) serial.
    a = fleet_run(kernels, fleet_config(os.path.join(root, "a"), FLEET_ITERS), record_stores=True)
    legs["a"] = {k: a[k] for k in ("wall_s", "peak_gb", "iteration_wall_s", "step_device_s", "launches")}
    if a["iter_count"] != 2 * FLEET_ITERS or len(a["stores"]) != FLEET_ITERS:
        errors.append(f"(a) {a['iter_count']} steps, {len(a['stores'])} stores")

    # (b) colocated at staleness 0, this process.
    config = fleet_config(os.path.join(root, "b"), FLEET_ITERS)
    config.method.fleet_disaggregate, config.method.max_staleness = True, 0
    config.train.fleet_dir = os.path.join(root, "b", "fleet")
    b = fleet_run(kernels, config)
    b_events = read_jsonl_or_empty(os.path.join(config.train.fleet_dir, "fleet_events.jsonl"))
    _, b_stores = fleet_stream_stores(config.train.fleet_dir, elastic=False)
    fleet_stores_equal("(b)", b_stores, a["stores"], errors)
    if b["params"] != a["params"]:
        errors.append("(b): the end weights differ from (a)'s: " + ", ".join(
            n for n in a["params"] if b["params"][n] != a["params"][n])[:400])
    if b.get("fleet_modules") != 1 or b.get("fleet_module_is_live"):
        errors.append(f"(b): rollout-side modules {b.get('fleet_modules')}, the live one among them "
                      f"{b.get('fleet_module_is_live')}")
    legs["b"] = {k: b[k] for k in ("wall_s", "peak_gb", "iteration_wall_s", "launches")} | {
        "publish": fleet_publish_stats(b_events),
        "staleness": [e["staleness"] for e in b_events if e["event"] == "episode_consumed"]}
    shutil.rmtree(os.path.join(root, "b"), ignore_errors=True)

    # (c) learner + a rollout role of FLEET_ROLE_RANKS ranks at staleness 1,
    # in-flight weights, a torn push.
    leg_dir = os.path.join(root, "c")
    port = free_local_port()
    role_ranks = [(("worker" if r == 0 else f"worker{r}"),
                   fleet_role_cmd("rollout", leg_dir, "worker" if r == 0 else f"worker{r}", FLEET_C_ITERS, 1,
                                  ("--fleet-inflight", "--fleet-hook", "--fleet-rank", str(r), "--fleet-world",
                                   str(FLEET_ROLE_RANKS))), {"TRLX_TPU_FLEET_ROLE": "rollout"}, 0)
                  for r in range(FLEET_ROLE_RANKS)]
    res, wall = fleet_leg("(c)", leg_dir, [
        ("learner", fleet_role_cmd("learner", leg_dir, "learner", FLEET_C_ITERS, 1, ("--fleet-inflight",)),
         {"TRLX_TPU_FLEET_ROLE": "learner", "TRLX_TPU_FAULTS": "weight_push_torn@2",
          "TRLX_TPU_METRICS_PORT": str(port)}, 0),
        *role_ranks,
    ])
    ranks = [res[tag] for tag, *_ in role_ranks]
    fdir = os.path.join(leg_dir, "fleet")
    events = read_jsonl_or_empty(os.path.join(fdir, "fleet_events.jsonl"))
    broadcast = read_jsonl_or_empty(os.path.join(fdir, "broadcast.jsonl"))
    stream = read_jsonl_or_empty(os.path.join(fdir, "stream.jsonl"))
    published = {r["version"] for r in broadcast if r["status"] == "published"}
    torn = {r["ordinal"] for r in broadcast if r["status"] == "injected_torn"}
    consumed = [e for e in events if e["event"] == "episode_consumed"]
    c_stal = [e["staleness"] for e in consumed]
    rejected = [e for e in events if e["event"] == "weights_torn"]
    adopted = [e for e in events if e["event"] == "weights_adopted_inflight"]
    spans = [r.get("version_spans") or [] for r in stream]
    mixed = res["learner"]["gauges"].get("trlx_tpu_fleet_mixed_version_tokens", 0.0)
    if len(consumed) != FLEET_C_ITERS or not all(0 <= s <= 1 for s in c_stal):
        errors.append(f"(c) consumed {len(consumed)} batches at staleness {c_stal}")
    if not stream or not all(r["weight_version"] in published for r in stream) or not all(
            v in published for sp in spans for v, _ in sp):
        errors.append(f"(c) streamed versions {[(r['weight_version'], r.get('version_spans')) for r in stream]} "
                      f"against published {sorted(published)}")
    if torn != {2} or not rejected or not all(e["ordinal"] == 2 and e["held"] < 2 for e in rejected):
        errors.append(f"(c) torn ordinals {torn}, rejections {rejected[:3]}")
    if 2 in {e["ordinal"] for e in events if e["event"] in ("weights_fetched", "weights_adopted_inflight")}:
        errors.append("(c) the worker adopted the torn ordinal 2")
    if not adopted or not any(len(sp) >= 2 for sp in spans) or not mixed > 0:
        errors.append(f"(c) no push adopted mid-phase: adoptions {adopted}, spans {spans}, mixed-version gauge "
                      f"{mixed}")
    if not any(e["event"] == "worker_exit" and e["reason"] == "abort" for e in events):
        errors.append("(c) the worker never left on the abort marker")
    crcs = [r["schedule_crcs"] for r in ranks]
    pushes = [r["weight_pushes"] for r in ranks]
    if not crcs[0] or any(c != crcs[0] for c in crcs) or any(p != pushes[0] for p in pushes) or not any(pushes[0]):
        errors.append(f"(c) the role's ranks: engine schedule crcs {crcs}, in-flight pushes (sync, version) {pushes}")
    loads = [e for e in events if e["event"] in ("weights_fetched", "weights_adopted_inflight")]
    if not loads or any(len(e.get("rank_load_s") or ()) != FLEET_ROLE_RANKS for e in loads):
        errors.append(f"(c) adoptions without every rank's seconds: {loads}")
    for name_, n in (("worker_start", 1), ("worker_exit", 1)):
        if sum(e["event"] == name_ for e in events) != n:
            errors.append(f"(c) {name_} logged {sum(e['event'] == name_ for e in events)} times (rank 0 alone: {n})")
    legs["c"] = {"wall_s": wall, "staleness": c_stal, "spans": spans, "rejected_torn": len(rejected),
                 "adopted_inflight": [e["ordinal"] for e in adopted], "mixed_version_tokens_gauge": mixed,
                 "hook": res["worker"]["hook"], "publish": fleet_publish_stats(events),
                 "role_ranks": FLEET_ROLE_RANKS, "schedule_crcs": crcs[0], "weight_pushes": pushes[0],
                 "adoptions": [{"event": e["event"], "ordinal": e["ordinal"], "read_s": e.get("read_s"),
                                "rank_load_s": e.get("rank_load_s"), "rank_h2d_s": e.get("rank_h2d_s")}
                               for e in loads]} | {
        tag: {k: r[k] for k in ("wall_s", "peak_gb", "iteration_wall_s", "launches", "iter_count")}
        for tag, r in res.items()}
    with open(os.path.join(leg_dir, "worker", "metrics.jsonl")) as f:
        switches = sum(int(json.loads(line).get("engine/weight_switches", 0)) for line in f)
    if not switches:
        errors.append("(c) the worker's engine recorded no version switch of a live slot")
    legs["c"]["engine_weight_switches"] = switches
    for tag, r in res.items():
        need = FLEET_WORKER_NEED if tag.startswith("worker") else FLEET_LEARNER_NEED
        if any(r["launches"][k] == 0 for k in need):
            errors.append(f"(c) {tag} launched none of {[k for k in need if r['launches'][k] == 0]}")
    shutil.rmtree(leg_dir, ignore_errors=True)

    # (d) learner + two elastic workers at staleness 0, worker 1 killed holding a lease.
    leg_dir = os.path.join(root, "d")
    port = free_local_port()
    elastic = ("--fleet-elastic",)
    res_d, wall_d = fleet_leg("(d)", leg_dir, [
        ("learner", fleet_role_cmd("learner", leg_dir, "learner", FLEET_ITERS, 0, elastic),
         {"TRLX_TPU_FLEET_ROLE": "learner", "TRLX_TPU_METRICS_PORT": str(port)}, 0),
        ("worker1", fleet_role_cmd("rollout", leg_dir, "worker1", FLEET_ITERS, 0, elastic),
         {"TRLX_TPU_FLEET_ROLE": "rollout", "TRLX_TPU_FLEET_WORKER": "1",
          "TRLX_TPU_FAULTS": "worker_kill_mid_lease@1"}, 1),
        ("worker0", fleet_role_cmd("rollout", leg_dir, "worker0", FLEET_ITERS, 0,
                                   elastic + ("--fleet-wait-claim", "1:1")),
         {"TRLX_TPU_FLEET_ROLE": "rollout", "TRLX_TPU_FLEET_WORKER": "0"}, 0),
    ])
    from trlx_tpu_torch.fleet import ElasticStreamReader, FleetPaths, LeaseLedger

    fdir = os.path.join(leg_dir, "fleet")
    events = read_jsonl_or_empty(os.path.join(fdir, "fleet_events.jsonl"))
    consumed = [e for e in events if e["event"] == "episode_consumed"]
    reclaims = [e for e in events if e["event"] == "lease_reclaimed"]
    reclaimed = LeaseLedger(FleetPaths(fdir).leases_dir, ttl=60.0).reclaimed_units()
    deduped = ElasticStreamReader(FleetPaths(fdir)).duplicates()
    gauges = res_d["learner"]["gauges"]
    _, d_stores = fleet_stream_stores(fdir, elastic=True)
    fleet_stores_equal("(d)", d_stores, a["stores"], errors)
    if res_d["learner"]["params"] != a["params"]:
        errors.append("(d): the learner's end weights differ from (a)'s")
    if [e["unit"] for e in consumed] != list(range(FLEET_ITERS)) or not all(e["staleness"] == 0 for e in consumed):
        errors.append(f"(d) consumed units {[(e['unit'], e['staleness']) for e in consumed]}")
    if (reclaimed != [1] or not reclaims or reclaims[0]["worker"] != 0 or reclaims[0]["gen"] < 1 or deduped != 0
            or gauges.get("trlx_tpu_fleet_units_reclaimed_total") != 1.0
            or gauges.get("trlx_tpu_fleet_episodes_deduped_total") != 0.0):
        errors.append(f"(d) reclaimed units {reclaimed}, reclaims {reclaims}, deduplicated {deduped}, gauges "
                      f"{gauges}")
    legs["d"] = {"wall_s": wall_d, "staleness": [e["staleness"] for e in consumed],
                 "producers": [e["worker"] for e in consumed], "reclaims": reclaims, "gauges": gauges,
                 "publish": fleet_publish_stats(events)} | {
        tag: (None if r is None else {k: r[k] for k in ("wall_s", "peak_gb", "iteration_wall_s", "launches")})
        for tag, r in res_d.items()}
    if any(res_d["worker0"]["launches"][k] == 0 for k in FLEET_WORKER_NEED) or any(
            res_d["learner"]["launches"][k] == 0 for k in FLEET_LEARNER_NEED):
        errors.append(f"(d) launches: worker 0 {res_d['worker0']['launches']}, learner {res_d['learner']['launches']}")
    for name, leg in (("(a)", a), ("(b)", b)):
        if any(leg["launches"][k] == 0 for k in FLEET_NEED):
            errors.append(f"{name} launched none of {[k for k in FLEET_NEED if leg['launches'][k] == 0]}")
    shutil.rmtree(root, ignore_errors=True)

    for name, leg in legs.items():
        log(f"[fleet_train] ({name}) {json.dumps(leg)} on {smi}")
    for tag, r in ([(f"(c) rollout rank {i}", legs["c"][t]) for i, (t, *_) in enumerate(role_ranks)]
                   + [("(d) worker 0", legs["d"]["worker0"])]):
        log(f"[fleet_train] {tag}: W8 {r['launches']['w8a16_matmul']}, row 8 {r['launches']['decode_attention_int8']}, "
            f"row 10 {r['launches']['paged_decode_attention_int8']} launches, peak {r['peak_gb']:.2f} GB on {smi}")
    if errors:
        raise AssertionError(f"fleet_train: {errors}")
    launches = dict.fromkeys(kernels, 0)
    for leg in (legs["a"], legs["b"], legs["c"]["learner"], *[legs["c"][t] for t, *_ in role_ranks],
                legs["d"]["learner"], legs["d"]["worker0"]):
        for k, v in leg["launches"].items():
            launches[k] += v
    return legs, launches


def successor_processor(gcfg, vocab: int):
    """A logit processor that allows ``SPEC_SUCCESSORS`` successors of each
    token (a seeded hash of it), then the default chain: constrained
    decoding, as a logit mask does, without a [V, V] table on the card."""
    from trlx_tpu_torch.ops.sampling import process_logits_default

    def processor(logits, state):
        last = state["last_token"].long()[:, None]
        cand = (last * 7919 + torch.arange(SPEC_SUCCESSORS, device=logits.device)[None, :] * 1543 + 11) % vocab
        allowed = torch.full_like(logits, -1e9).scatter(1, cand, logits.gather(1, cand))
        return process_logits_default(allowed, gcfg, state["step"])

    return processor


GREEDY_GAP = 0.25  # logits: a random head's are ~N(0, 1), a wrongly placed token's gap ~4


@torch.no_grad()
def greedy_gap(trainer):
    """The largest gap, over the store's response tokens, between the best
    logit of a position and the chosen token's, from one teacher-forced
    forward of the stored sequences (8 rows at a time). Greedy decoding
    makes it 0 up to the rounding that tells the forward's path from the
    decode path's; a token placed at the wrong position or chosen from the
    wrong logits shows a gap of the logits' scale."""
    cols = trainer.store.columns()
    P = cols["query_tensors"].shape[1]
    worst = 0.0
    for i in range(0, len(trainer.store), CHUNK):
        tokens = trainer.put(np.concatenate([cols["query_tensors"][i:i + CHUNK], cols["response_tensors"][i:i + CHUNK]], 1))
        mask = trainer.put(np.concatenate([cols["query_mask"][i:i + CHUNK], cols["response_mask"][i:i + CHUNK]], 1))
        logits = trainer.model(tokens, mask, logits_start=P - 1)["logits"][:, :-1].float()
        chosen = logits.gather(-1, tokens[:, P:, None].long())[..., 0]
        worst = max(worst, float((logits.amax(-1) - chosen).max()))
    return worst


def engine_spec_path(kernels):
    """Speculative decoding in the engine: ``make_experience`` at GPT-J-6B
    width and ``SPEC_LAYERS`` layers, greedy, the engine's settings
    (``ENGINE``), with ``method.spec_decode = "ngram"`` and ``spec_k =
    SPEC_K`` against spec off, on fixed slots and paged.

    - bf16 (the rollout configuration, 16 rollouts): accept rate, decode
      rate and launches (spec runs launch no decode kernel: the window
      attends by einsum), and the share of identical tokens, reported: the
      one-token steps attend through the decode kernels and the window by
      einsum (its probabilities in bf16), the two round differently, and a
      random head's logits (~N(0, 1), their top two ~0.2 apart) come
      within that rounding often enough to pick another token, from which
      the row diverges. Both runs' tokens must be greedy up to rounding:
      each within ``GREEDY_GAP`` of its position's best logit in a
      teacher-forced forward (``greedy_gap``).
    - float32 compute (8 rollouts; einsum attention on both sides, logits in
      f32), fixed, paged and a soft-prompt model (``N_SOFT`` rows, fixed),
      decoding constrained to ``SPEC_SUCCESSORS`` successors a token
      (``successor_processor``) so no two candidates tie: tokens identical
      with spec on and off.
    Returns its numbers and launches."""
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo import PPOTrainer
    from trlx_tpu_torch.trainer.ppo_softprompt import PPOSoftpromptTrainer

    n_layer, k, spc = SPEC_LAYERS, 2, ENGINE["engine_steps_per_sync"]
    out, total = {}, dict.fromkeys(kernels, 0)
    for dtype, soft in (("bfloat16", False), ("float32", False), ("float32", True)):
        n_roll = N_ROLLOUTS if dtype == "bfloat16" else CHUNK
        run_name = f"engine_spec_{dtype}" + ("_soft" if soft else "")
        if soft:
            config = smoke_config(n_layer=n_layer, run=run_name, greedy=True, method_name="pposoftpromptconfig",
                                  n_soft_tokens=N_SOFT, **ENGINE)
        else:
            config = smoke_config(n_layer=n_layer, run=run_name, greedy=True, **ENGINE)
        config.model.dtype = dtype
        trainer = (PPOSoftpromptTrainer if soft else PPOTrainer)(config)
        if dtype == "float32":
            trainer._gen_processor = successor_processor(trainer.gen_cfg, GPTJ_6B_ARCH["vocab_size"])
        for paged in ((False,) if soft else (False, True)):
            name = ("soft_" if soft else "") + ("paged" if paged else "fixed") + ("_bf16" if dtype == "bfloat16" else
                                                                                  "_f32")
            runs = {}
            for spec in (False, True):
                m = trainer.config.method
                m.paged_kv, m.spec_decode, m.spec_k = paged, "ngram" if spec else "", SPEC_K if spec else 0
                trainer._shutdown_rollout_engine()
                trainer.store.clear_history()
                # A fresh orchestrator: the same prompt order (the loader's
                # seeded shuffle), so both runs admit alike.
                orch = PPOOrchestrator(trainer, PromptPipeline(engine_prompts(), None, max_prompt_length=PROMPT_LEN),
                                       reward_fn=reward_fn, chunk_size=CHUNK)
                for fn in kernels.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                stats = orch.make_experience(n_roll)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {n: fn.launches for n, fn in kernels.items()}
                for n_, v in launches.items():
                    total[n_] += v
                calls, prefills = int(stats["engine/decode_calls"]), int(stats["engine/prefill_batches"])
                expected = dict.fromkeys(kernels, 0)
                if dtype == "bfloat16":
                    # Flash: the fixed engine's prefill at offset 0, then the
                    # scoring forwards (the policy and the branch), each with
                    # the fused head; the decode kernel in spec-off calls only.
                    chunks = n_roll // CHUNK
                    expected["paged_decode_attention" if paged else "decode_attention"] = (
                        0 if spec else n_layer * spc * calls)
                    expected["flash_attention_fwd"] = (0 if paged else prefills * n_layer) + chunks * (n_layer + k)
                    expected["fused_logprob_fwd"] = chunks * 2
                if launches != expected:
                    raise AssertionError(f"engine_spec {name} spec={spec}: launches {launches} != {expected}")
                cols = trainer.store.columns()
                responses = {tuple(q.tolist()): r for q, r in zip(cols["query_tensors"], cols["response_tensors"])}
                gap = greedy_gap(trainer) if dtype == "bfloat16" else None
                if gap is not None and not gap <= GREEDY_GAP:
                    raise AssertionError(f"engine_spec {name} spec={spec}: a token {gap:.4f} below its position's "
                                         f"best logit (greedy allows {GREEDY_GAP})")
                runs[spec] = (responses, stats, wall, calls, gap)
            (off, s_off, w_off, c_off, g_off), (on, s_on, w_on, c_on, g_on) = runs[False], runs[True]
            if set(off) != set(on):
                raise AssertionError(f"engine_spec {name}: the spec on and off runs decoded other prompts")
            same = [off[q] == on[q] for q in sorted(off)]
            share = float(np.mean(np.concatenate(same)))
            rec = {"rollouts": n_roll, "identical_token_share": share,
                   "first_divergence_per_row": [int(np.argmin(x)) if not x.all() else None for x in same],
                   "spec_accept_rate": s_on["engine/spec_accept_rate"], "spec_proposed": s_on["engine/spec_proposed"],
                   "spec_accepted": s_on["engine/spec_accepted"], "decode_calls": {"off": c_off, "on": c_on},
                   "decode_tokens_per_s": {"off": s_off["engine/decode_tokens_per_s"],
                                           "on": s_on["engine/decode_tokens_per_s"]},
                   "decode_wall_s": {"off": s_off["engine/decode_wall_s"], "on": s_on["engine/decode_wall_s"]},
                   "wall_s": {"off": w_off, "on": w_on}, "greedy_gap": {"off": g_off, "on": g_on}}
            log(f"[engine_spec] {name} ({n_layer} layers, spec_k {SPEC_K}): {json.dumps(rec)}")
            if dtype == "float32" and share < 1.0:
                raise AssertionError(f"engine_spec {name}: identical token share {share:.4f} with spec on and off")
            out[name] = rec
        trainer._shutdown_rollout_engine()
        del trainer, orch
        free()
    return out, total


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
    if "--dist-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        sys.path.insert(0, ROOT)
        return dist_worker(int(args["--dist-rank"]), int(args["--dist-world"]), args["--dist-dir"])
    if "--fleet-role" in sys.argv:
        args, argv = {}, sys.argv[1:]
        while argv:
            key = argv.pop(0)
            args[key] = argv.pop(0) if argv and not argv[0].startswith("--") else True
        sys.path.insert(0, ROOT)
        return fleet_worker(args)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trlx_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = card_line()
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    disk = shutil.disk_usage(RUN_DIR)
    log(f"[device] disk under {RUN_DIR}: {disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} GB "
        f"(the largest checkpoint ~45 GB, ILQL's; each is deleted once read or when its path is done)")

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f}s")
    for ln in cuda_lib.build_log().splitlines():
        if any(w in ln for w in ("Compiling entry function", "registers", "spill", "Performance Loss")):
            log(f"[build] {ln.strip()}")
    h96_ptxas = [ptxas_report(cuda_lib.build_log(), name) for name in H96_KERNELS.values()]
    log(f"[build] head_dim 96 (rows 1h, 3h): {json.dumps(h96_ptxas)}")
    if any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in h96_ptxas):
        raise AssertionError(f"a head_dim 96 kernel spills: {h96_ptxas}")

    torch.backends.cuda.matmul.allow_tf32 = False
    if "--race-overhead" in sys.argv:
        # Only the race sanitizer's cost on overlap_train's (c): unarmed,
        # armed, armed, unarmed.
        results, _ = overlap_train_path(port_kernels(), plan=RACE_AB_PLAN)
        walls = {k: v["wall_s"] for k, v in results.items()}
        log(f"[race-overhead] overlap_train (c) walls in s, unarmed and armed, on {smi}: {json.dumps(walls)}")
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = port_kernels()
    phases = {}
    for name, fn in (("flash_prefill", lambda: phase_flash(gen, PROMPT_LEN, ragged=True)),
                     ("flash_branch_replay", lambda: phase_flash(gen, MAX_LEN, ragged=False)),
                     ("flash_neox20b", lambda: phase_flash(gen, MAX_LEN, ragged=True, h=64, d=NEOX_HEAD_DIM)),
                     ("decode", lambda: phase_decode(gen)),
                     ("decode_int8", lambda: phase_decode_int8(gen, phases["decode"].pop("valid"))),
                     ("paged_decode", lambda: phase_paged(gen, quant=False)),
                     ("paged_decode_int8", lambda: phase_paged(gen, quant=True)),
                     ("fused_logprob", lambda: phase_logprob(gen)),
                     ("flash_bwd", lambda: phase_flash_bwd(gen)),
                     ("flash_bwd_neox20b", lambda: phase_flash_bwd(gen, h=64, d=NEOX_HEAD_DIM, suffix="_h96")),
                     ("flash_h96_modes", lambda: phase_flash_h96_modes(gen)),
                     ("fused_logprob_bwd", lambda: phase_logprob_bwd(LOGPROB_BWD_SEED)),
                     ("fused_logprob_f32", lambda: phase_logprob_f32(F32_SEED)),
                     ("fused_logprob_bwd_f32", lambda: phase_logprob_bwd_f32(F32_SEED)),
                     ("w8a16", lambda: phase_w8a16(gen)),
                     ("flash_ring", lambda: phase_flash_ring(gen)),
                     ("ring", lambda: phase_ring(gen, kernels))):
        t0 = time.perf_counter()
        phases[name] = fn()
        free()
        shown = {k: v for k, v in phases[name].items() if k != "valid"}
        log(f"[kernel] {name} ({time.perf_counter() - t0:.1f}s): {json.dumps(shown)}")
    for name in ("flash_bwd", "flash_bwd_neox20b", "fused_logprob_bwd", "fused_logprob_bwd_f32"):
        phases.update(phases.pop(name))

    by_path = {}

    def run(path, fn):
        t0 = time.perf_counter()
        out = fn()
        by_path[path] = out[-1]
        free()
        log(f"[{path}] done in {time.perf_counter() - t0:.1f}s")
        return out

    # ILQL first: its step nears the card's memory, so it gets the allocator
    # fresh; the HF + reward-model path (~69 GB) next.
    ilql_out, _ = run("ilql_train", lambda: ilql_train_path(kernels))
    # ILQL's resume reads ilql_train's end checkpoint, so nothing else is
    # saved while it is on disk.
    t0 = time.perf_counter()
    ilql_resume_path(kernels, ilql_out["saved_state"], ilql_out["run_dir"])
    free()
    log(f"[resume] ILQL done in {time.perf_counter() - t0:.1f}s")
    run("hf_rm_train", lambda: hf_rm_train_path(kernels))
    run("neox_rm_train", lambda: neox_rm_train_path(kernels))
    bf16_out, _ = run("rollout_bf16", lambda: main_path(kernels))
    w8_out, _ = run("rollout_w8", lambda: main_path(kernels, w8=True))
    log(f"[rollout-w8] decode tokens/s at GPT-J-6B full depth: W8A16 {w8_out['decode_tokens_per_s']:.1f} against "
        f"bf16 weights {bf16_out['decode_tokens_per_s']:.1f} (decode device s {w8_out['decode_device_s']:.4f} against "
        f"{bf16_out['decode_device_s']:.4f}, prefill {w8_out['prefill_device_s']:.4f} against "
        f"{bf16_out['prefill_device_s']:.4f}) on {smi}")
    run("softprompt_train", lambda: softprompt_train_path(kernels))
    run("rollout_int8", lambda: main_path(kernels, quant=True))
    paged, _, _ = run("engine_paged_bf16", lambda: engine_rollout_path(kernels, paged=True))
    fixed, _, _ = run("engine_fixed_bf16", lambda: engine_rollout_path(kernels, paged=False))
    log(f"[engine] greedy tokens, paged vs fixed slots (bf16, 4 layers): {json.dumps(compare_greedy(paged, fixed))}")
    run("engine_spec", lambda: engine_spec_path(kernels))
    sp_out, _ = run("sp_train", lambda: sp_train_path(kernels))
    run("dist_train", lambda: dist_train_path(kernels))
    run("fleet_train", lambda: fleet_train_path(kernels))
    t0 = time.perf_counter()
    phase_grad_consistency()
    log(f"[grad] done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_ilql_grad_consistency(kernels)
    log(f"[ilql-grad] done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_rm_route(kernels)
    log(f"[rm-route] done in {time.perf_counter() - t0:.1f}s")
    run("text_ppo", lambda: text_ppo_path(kernels))
    run("train_bf16", lambda: without_progress(lambda: train_path(kernels), "train_bf16"))
    run("engine_train", lambda: engine_train_path(kernels))
    run("overlap_train", lambda: overlap_train_path(kernels))
    run("resilience_drill", lambda: resilience_drill_path(kernels))
    run("randomwalks", lambda: randomwalks_path(kernels))
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
        p = phases[name]
        if name.endswith("_f32"):
            log_f32_row(name, ms, p["flops"], p["bound_ms"], p["matmul_ms"], "its torch.matmul yardstick")

    # Each row's launches are those of the main path (engine_train), except
    # for the kernels it does not run: row 7 counts on the full-depth
    # training path over the chunked bf16 sampler (hf_rm_train), row 9 on
    # the paged bf16 engine, the f32 mode of rows 4-6 on the ILQL path, and
    # the W8A16 product on the full-depth W8 rollout.
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
         "hf_rm_train"),
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
        # No Pallas kernel: on the TPU XLA fuses QDense's int8 convert into the dot.
        ("w8a16_matmul", "w8a16", "trlx_tpu_torch/csrc/w8a16_gemm.cu", "trlx_tpu/models/lm.py:226", "rollout_w8"),
    ):
        p = phases[phase]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": by_path[path][name],
               "launches_path": path, "launches_by_path": {k: v[name] for k, v in by_path.items()},
               "max_abs_err": p["max_abs_err"], "tol": p["tol"], "ms": p["ms"], "plain_ms": p["plain_ms"],
               "bound_ms": p["bound_ms"], "bound_by": p["bound_by"], "library_ms": p["library_ms"],
               "shape": p["shape"]}
        for key in ("library", "max_abs_err_split_edges", "matmul_ms", "matmul", "ms_bf16_weight", "cast_ms",
                    "kernels_only_ms", "turns_vs_library", "eager_ms", "max_scaled_err", "tol_rule", "shapes",
                    "err_shape"):
            if key in p:
                row[key] = p[key]
        if name.endswith("_f32"):  # as log_f32_row prints them
            row["tflops"] = p["flops"] / p["ms"] / 1e9
            row["share_of_bound"] = p["bound_ms"] / p["ms"]
        if name == "flash_attention_fwd":
            row["branch_replay"] = phases["flash_branch_replay"]
        rows.append(row)
    # Rows 1h-3h: rows 1-3 at GPT-NeoX-20B's heads, their launches those of
    # neox_rm_train's leg (b), every flash pass of which is at head_dim 96.
    for kernel, phase in (("flash_attention_fwd", "flash_neox20b"), ("flash_attention_bwd_dq", "flash_attention_bwd_dq_h96"),
                          ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv_h96")):
        p = phases[phase]
        base_row = next(r for r in rows if r["name"] == kernel)
        rows.append({"name": f"{kernel}_h96", "route": "cuda", "source": base_row["source"],
                     "replaces": base_row["replaces"], "launches": by_path["neox_rm_train"][kernel],
                     "launches_path": "neox_rm_train (leg b)", "max_abs_err": p["max_abs_err"], "tol": p["tol"],
                     "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
                     "library_ms": p["library_ms"], "library": p.get("library", "SDPA with the boolean mask"),
                     "shape": p["shape"], "share_of_bound": p["bound_ms"] / p["ms"],
                     "modes_max_err": {m: max(e.get(x, 0.0) for x in H96_ERRS[kernel])
                                       for m, e in phases["flash_h96_modes"].items()},
                     "ptxas": next((r for r in h96_ptxas if r["kernel"] == H96_KERNELS.get(kernel)), None)})
    rows += ring_mode_rows(phases["flash_ring"], phases["ring"], sp_out["launches_by_mode"])
    log(f"[done] total {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
