#!/usr/bin/env python3
"""Where a decode step, or a train step, of the PyTorch port goes, on one
GPU.

Builds the same GPT-J-6B trainer as ``chip_smoke.py`` (full width and depth,
random weights from the seed) and runs its fused rollout generation on one
chunk of prompts, as ``make_experience`` does, with a short and a long
response:

- without the profiler, the decode window's device time per step, read from
  the CUDA events the generator records (prefill done → last step done),
  in each of ``REPEATS`` long runs;
- under ``torch.profiler``, the CUDA kernel time of each run. The long run's
  kernel time less the short run's, over the extra steps, is the kernel
  time of one decode step, prefill excluded.

The kernel time of a step over the median unprofiled step time is the share
of the step the card is busy; the rest it waits for the host to launch work.
The host shares its CPU cores with other work, so the unprofiled step time
is read several times.
Kernel times are taken under the profiler, which slows the host but not the
kernels. Prints one JSON line.

With ``--train`` it does the same for a PPO train step of the training
path's trainer (``chip_smoke.train_config``: GPT-J-6B, remat, batch 8 of
768 + 256 tokens) on one chunk of its own rollouts: ``REPEATS`` unprofiled
steps timed by CUDA events, then ``PROFILED_STEPS`` steps under the
profiler, whose kernel time per step over the median unprofiled step time
is the card's busy share of a step.

    python3 profile_torch_decode.py [--train]
"""

import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo import PPOTrainer

SHORT, LONG = 8, 40  # new tokens of the short and the long run
REPEATS = 5  # unprofiled long runs (decode) or steps (train)
PROFILED_STEPS = 2  # train steps under the profiler
# Kernel classes of a train step's profile, by substrings of the kernel's
# name (first match wins): the library GEMMs, the port's own kernels, the
# f32 -> bf16 weight and activation casts; the rest is "other".
KERNEL_CLASSES = (
    ("gemm (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("flash fwd", ("flash_fwd_kernel",)),
    ("flash bwd", ("flash_bwd_",)),
    ("fused logprob fwd", ("logprob_partial_kernel", "logprob_combine_kernel")),
    ("fused logprob bwd", ("logprob_ds_kernel", "logprob_dx_kernel", "logprob_dw_kernel", "logprob_db_kernel")),
    ("bf16 casts", ("bfloat16_copy_kernel",)),
)


def cuda_kernels(prof):
    """The profile's CUDA kernel events, largest self device time first."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(events, key=lambda e: e.self_device_time_total, reverse=True)


def total_us(evts):
    return sum(e.self_device_time_total for e in evts)


def top_kernels(evts, n=12):
    return [{"name": e.key[:90], "calls": e.count, "total_ms": e.self_device_time_total / 1e3,
             "share": e.self_device_time_total / max(total_us(evts), 1e-9)} for e in evts[:n]]


def train_main(smi):
    n_layer = chip_smoke.GPTJ_6B_ARCH["n_layer"]
    config = chip_smoke.train_config(n_layer, "ppo", os.path.join(chip_smoke.RUN_DIR, "profile_train"))
    trainer = PPOTrainer(config)
    pipe = PromptPipeline(chip_smoke.seeded_prompts(chip_smoke.CHUNK, 0), None,
                          max_prompt_length=trainer.prompt_length)
    PPOOrchestrator(trainer, pipe, reward_fn=chip_smoke.reward_fn,
                    chunk_size=chip_smoke.CHUNK).make_experience(chip_smoke.CHUNK)
    batch = trainer.put_batch(next(iter(trainer.store.create_loader(chip_smoke.CHUNK))))

    def step():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    step()  # warm-up
    steps_s = [step() for _ in range(REPEATS)]
    step_s = float(np.median(steps_s))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_steps_s = [step() for _ in range(PROFILED_STEPS)]
    evts = cuda_kernels(prof)
    kernel_ms = total_us(evts) / 1e3 / PROFILED_STEPS
    classes = {}
    for e in evts:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + e.self_device_time_total / 1e3 / PROFILED_STEPS
    print(json.dumps({
        "device": smi, "layers": n_layer, "batch": chip_smoke.CHUNK, "tokens_per_step": chip_smoke.CHUNK
        * chip_smoke.MAX_LEN, "train_step_ms": step_s * 1e3, "train_step_ms_runs": [t * 1e3 for t in steps_s],
        "train_step_ms_profiled": [t * 1e3 for t in prof_steps_s], "kernel_ms_per_step": kernel_ms,
        "device_busy_share": kernel_ms / (step_s * 1e3), "train_tokens_per_s": chip_smoke.CHUNK
        * chip_smoke.MAX_LEN / step_s, "kernel_ms_per_step_by_class": classes,
        "top_kernels_per_step": [dict(k, total_ms=k["total_ms"] / PROFILED_STEPS) for k in top_kernels(evts, 15)],
    }))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if "--train" in sys.argv[1:]:
        return train_main(smi)

    trainer = PPOTrainer(chip_smoke.smoke_config())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50400, size=int(rng.integers(chip_smoke.MIN_PROMPT, chip_smoke.PROMPT_LEN + 1)))
               for _ in range(chip_smoke.CHUNK)]
    pipe = PromptPipeline(prompts, None, max_prompt_length=trainer.prompt_length)
    ids, mask = trainer.put(pipe.input_ids), trainer.put(pipe.attention_mask)

    def rollout_fn(n_new):
        """The trainer's fused rollout generation with ``n_new`` new tokens."""
        fn = trainer._generate_fused_fn
        gcfg = type(trainer.gen_cfg)(**{**trainer.gen_cfg.__dict__, "max_new_tokens": n_new,
                                        "min_new_tokens": n_new})
        return partial(fn.func, *fn.args, **{**fn.keywords, "gcfg": gcfg})

    def run(n_new, chunk):
        """One generation; its decode window's device seconds per step."""
        timings = {}
        rollout_fn(n_new)(ids, mask, trainer.chunk_rng(chunk), timings=timings)
        torch.cuda.synchronize()
        return timings["prefill"].elapsed_time(timings["end"]) / 1e3 / n_new

    def kernels(n_new, chunk):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_s = run(n_new, chunk)
        return step_s, cuda_kernels(prof)

    run(SHORT, 0)  # warm-up
    steps_s = [run(LONG, 1 + i) for i in range(REPEATS)]
    step_s = float(np.median(steps_s))
    _, short_k = kernels(SHORT, 1 + REPEATS)
    prof_step_s, long_k = kernels(LONG, 2 + REPEATS)

    kernel_ms = (total_us(long_k) - total_us(short_k)) / 1e3 / (LONG - SHORT)
    top = top_kernels(long_k)
    out = {
        "device": smi, "layers": chip_smoke.GPTJ_6B_ARCH["n_layer"], "batch": chip_smoke.CHUNK,
        "prompt_length": trainer.prompt_length, "short_steps": SHORT, "long_steps": LONG,
        "decode_ms_per_step": step_s * 1e3,
        "decode_ms_per_step_runs": [t * 1e3 for t in steps_s],
        "decode_ms_per_step_profiled": prof_step_s * 1e3,
        "kernel_ms_per_step": kernel_ms,
        "device_busy_share": kernel_ms / (step_s * 1e3),
        "device_busy_share_profiled": kernel_ms / (prof_step_s * 1e3),
        "long_run_kernel_ms": total_us(long_k) / 1e3,
        "top_kernels_long_run": top,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
