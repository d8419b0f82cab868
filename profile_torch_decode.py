#!/usr/bin/env python3
"""Where a decode step, or a train step, of the PyTorch port goes, on one
GPU.

Builds the same GPT-J-6B trainer as ``chip_smoke.py`` (full width and depth,
random weights from the seed) and runs its fused rollout generation on one
chunk of prompts, as ``make_experience`` does, with a short and a long
response, on each decode route in turn: the CUDA graph replay (the default
route) and, for comparison in the same process, eager launches (the
sampler's private ``_eager``). Per route:

- without the profiler, the decode window's device time per step, read from
  the CUDA events the generator records (prefill done → last step done),
  in each of ``REPEATS`` long runs;
- under ``torch.profiler``, the CUDA kernel time of each run. The long run's
  kernel time less the short run's, over the extra steps, is the kernel
  time of one decode step, prefill excluded.

The same difference, by kernel class (``KERNEL_CLASSES``), splits the step's
kernel time. The kernel time of a step over the median unprofiled step time is the share
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

With ``--engine`` it does the same for a decode call of the rollout engine
as the smoke's main path runs it (paged, int8 KV cache, 8 slots, 8 steps
per call, GPT-J-6B), on the graph route and on an eager engine beside it:
8 prompts fill the slots, then ``REPEATS`` unprofiled ``engine.step()``
calls, each ending in its one host sync, are timed by the host clock and
``PROFILED_STEPS`` more run under the profiler; kernel time per call over
the median call time is the card's busy share.

With ``--capture`` it measures what capturing the chunked sampler's
decode step costs a 256-step call at full depth (``capture_main``).

    python3 profile_torch_decode.py [--train | --engine | --capture]
"""

import json
import os
import subprocess
import sys
import time
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
CAPTURE_CALLS = 3  # alternating pairs of the capture measurement
# Kernel classes of a train step's profile, by substrings of the kernel's
# name (first match wins): the library GEMMs, the port's own kernels, the
# f32 -> bf16 weight and activation casts; the rest is "other".
KERNEL_CLASSES = (
    ("gemm (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("flash fwd", ("flash_fwd_kernel",)),
    ("flash bwd", ("flash_bwd_",)),
    ("fused logprob fwd", ("logprob_fwd_kernel", "logprob_combine_kernel")),
    ("fused logprob bwd", ("logprob_ds_kernel", "logprob_dx_kernel", "logprob_dw_kernel", "logprob_db_kernel")),
    ("bf16 casts", ("bfloat16_copy_kernel",)),
    ("decode attention", ("decode_split_kernel", "decode_merge_kernel")),
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
    classes = kernel_classes(evts, PROFILED_STEPS)
    print(json.dumps({
        "device": smi, "layers": n_layer, "batch": chip_smoke.CHUNK, "tokens_per_step": chip_smoke.CHUNK
        * chip_smoke.MAX_LEN, "train_step_ms": step_s * 1e3, "train_step_ms_runs": [t * 1e3 for t in steps_s],
        "train_step_ms_profiled": [t * 1e3 for t in prof_steps_s], "kernel_ms_per_step": kernel_ms,
        "device_busy_share": kernel_ms / (step_s * 1e3), "train_tokens_per_s": chip_smoke.CHUNK
        * chip_smoke.MAX_LEN / step_s, "kernel_ms_per_step_by_class": classes,
        "top_kernels_per_step": [dict(k, total_ms=k["total_ms"] / PROFILED_STEPS) for k in top_kernels(evts, 15)],
    }))


def kernel_classes(evts, per):
    """Kernel milliseconds by ``KERNEL_CLASSES`` over ``per`` runs."""
    classes = {}
    for e in evts:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + e.self_device_time_total / 1e3 / per
    return classes


def engine_main(smi):
    from trlx_tpu_torch.engine import RolloutEngine

    config = chip_smoke.smoke_config(quant=True, run="profile_engine", paged_kv=True, **chip_smoke.ENGINE)
    trainer = PPOTrainer(config)
    graph_engine = trainer.rollout_engine()
    m = config.method
    eager_engine = RolloutEngine(
        trainer.model, trainer.gen_cfg, n_slots=graph_engine.n_slots, prompt_width=trainer.prompt_length,
        processor=trainer._gen_processor, prefill_batch=m.prefill_batch, steps_per_sync=m.engine_steps_per_sync,
        paged_kv=True, kv_block_size=m.kv_block_size, generator=trainer.seeded_generator(3), _eager=True)
    pipe = PromptPipeline(chip_smoke.engine_prompts()[: graph_engine.n_slots], None,
                          max_prompt_length=trainer.prompt_length)
    out = {"device": smi, "layers": chip_smoke.GPTJ_6B_ARCH["n_layer"], "slots": graph_engine.n_slots,
           "steps_per_call": graph_engine.steps_per_sync}
    for route, engine in (("graph", graph_engine), ("eager", eager_engine)):
        engine.update_weights(trainer.model, version=0)
        engine.submit(pipe.input_ids, pipe.attention_mask)
        engine.step()  # admission (prefill) and a first decode call (the graph route captures it)

        def call():
            t0 = time.perf_counter()
            if engine.step():
                raise RuntimeError("an episode finished inside the measured window")
            return time.perf_counter() - t0

        call()  # warm-up
        calls_s = [call() for _ in range(REPEATS)]
        call_s = float(np.median(calls_s))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_calls_s = [call() for _ in range(PROFILED_STEPS)]
        evts = cuda_kernels(prof)
        kernel_ms = total_us(evts) / 1e3 / PROFILED_STEPS
        spc = engine.steps_per_sync
        rec = {
            "call_ms": call_s * 1e3, "call_ms_runs": [t * 1e3 for t in calls_s],
            "call_ms_profiled": [t * 1e3 for t in prof_calls_s], "decode_ms_per_step": call_s * 1e3 / spc,
            "decode_tokens_per_s": engine.n_slots * spc / call_s, "kernel_ms_per_call": kernel_ms,
            "device_busy_share": kernel_ms / (call_s * 1e3),
            "kernel_ms_per_call_by_class": kernel_classes(evts, PROFILED_STEPS),
            "top_kernels_per_call": [dict(k, total_ms=k["total_ms"] / PROFILED_STEPS) for k in top_kernels(evts, 15)],
        }
        if route == "graph":
            rec["graph_pool_gb"] = chip_smoke.graph_pool_gb()
            out.update(rec)
        else:
            out["eager"] = rec
        engine.shutdown()
    print(json.dumps(out))


def rollout_setup():
    """The smoke's rollout trainer (28 layers, chunked sampler, bf16 cache)
    and one chunk of seeded prompts on the device."""
    trainer = PPOTrainer(chip_smoke.smoke_config())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50400, size=int(rng.integers(chip_smoke.MIN_PROMPT, chip_smoke.PROMPT_LEN + 1)))
               for _ in range(chip_smoke.CHUNK)]
    pipe = PromptPipeline(prompts, None, max_prompt_length=trainer.prompt_length)
    return trainer, trainer.put(pipe.input_ids), trainer.put(pipe.attention_mask)


def capture_main(smi):
    """What capturing the decode step costs a call of the chunked sampler at
    full depth: ``CAPTURE_CALLS`` alternating pairs of 256-step calls of the
    trainer's rollout generation, one through a function with no graph yet
    (it runs step 0 eagerly and captures) and one through a function that
    keeps its graph (replays only), each timed by the host clock from a
    synchronize to a synchronize; the capture alone is timed the same way
    around ``StepGraph``. Then one capturing call runs under the profiler,
    whose traced launches of the port's kernels must equal the counters'."""
    from trlx_tpu_torch.ops import generate as gen_mod

    captures = []

    class TimedStepGraph(gen_mod.StepGraph):
        def __init__(self, fn, graph):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().__init__(fn, graph)
            torch.cuda.synchronize()
            captures.append((time.perf_counter() - t0) * 1e3)

    gen_mod.StepGraph = TimedStepGraph
    trainer, ids, mask = rollout_setup()
    kept = trainer._generate_fused_fn

    def fresh():
        return partial(kept.func, *kept.args, **{**kept.keywords, "_keep": {}})

    def call(fn, chunk):
        n = len(captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(ids, mask, trainer.chunk_rng(chunk))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, sum(captures[n:])

    call(kept, 0)  # warm-up: the kept function captures here
    runs = {"captures": [], "keeps": []}
    for t in range(CAPTURE_CALLS):
        for route in (("captures", "keeps") if t % 2 == 0 else ("keeps", "captures")):
            runs[route].append(call(fresh() if route == "captures" else kept, 1 + t))
    walls = {r: [w for w, _ in v] for r, v in runs.items()}
    capture_ms = [c for _, c in runs["captures"]]
    _, kernel_ms, traced = chip_smoke.traced_kernel_ms(chip_smoke.port_kernels(),
                                                       lambda: fresh()(ids, mask, trainer.chunk_rng(9)))
    med = {r: float(np.median(v)) for r, v in walls.items()}
    print(json.dumps({
        "device": smi, "layers": chip_smoke.GPTJ_6B_ARCH["n_layer"], "batch": chip_smoke.CHUNK,
        "new_tokens": trainer.gen_cfg.max_new_tokens, "call_wall_ms_runs": walls, "call_wall_ms_median": med,
        "per_call_cost_ms": med["captures"] - med["keeps"], "per_call_cost_share": (med["captures"] - med["keeps"])
        / med["keeps"], "capture_ms_runs": capture_ms, "capture_ms_median": float(np.median(capture_ms)),
        "profiled_capturing_call": {"kernel_ms": kernel_ms, "traced": traced},
        "allocated_gb_after": torch.cuda.memory_allocated() / 1e9, "graph_pool_gb": chip_smoke.graph_pool_gb(),
    }))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if "--train" in sys.argv[1:]:
        return train_main(smi)
    if "--engine" in sys.argv[1:]:
        return engine_main(smi)

    if "--capture" in sys.argv[1:]:
        return capture_main(smi)
    trainer, ids, mask = rollout_setup()

    def rollout_fn(n_new, eager):
        """The trainer's fused rollout generation with ``n_new`` new tokens
        on one route, with buffers (and graph) of its own."""
        fn = trainer._generate_fused_fn
        gcfg = type(trainer.gen_cfg)(**{**trainer.gen_cfg.__dict__, "max_new_tokens": n_new,
                                        "min_new_tokens": n_new})
        return partial(fn.func, *fn.args, **{**fn.keywords, "gcfg": gcfg, "_keep": {}, "_eager": eager})

    def measure(eager):
        fns = {n: rollout_fn(n, eager) for n in (SHORT, LONG)}

        def run(n_new, chunk):
            """One generation; its decode window's device seconds per step."""
            timings = {}
            fns[n_new](ids, mask, trainer.chunk_rng(chunk), timings=timings)
            torch.cuda.synchronize()
            return timings["prefill"].elapsed_time(timings["end"]) / 1e3 / n_new

        def kernels(n_new, chunk):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step_s = run(n_new, chunk)
            return step_s, cuda_kernels(prof)

        run(SHORT, 0)  # warm-up (the graph route captures each length's step here)
        run(LONG, 0)
        steps_s = [run(LONG, 1 + i) for i in range(REPEATS)]
        step_s = float(np.median(steps_s))
        _, short_k = kernels(SHORT, 1 + REPEATS)
        prof_step_s, long_k = kernels(LONG, 2 + REPEATS)

        kernel_ms = (total_us(long_k) - total_us(short_k)) / 1e3 / (LONG - SHORT)
        short_cls = kernel_classes(short_k, 1)
        return {
            "decode_ms_per_step": step_s * 1e3,
            "decode_ms_per_step_runs": [t * 1e3 for t in steps_s],
            "decode_ms_per_step_profiled": prof_step_s * 1e3,
            "decode_tokens_per_s": chip_smoke.CHUNK / step_s,
            "kernel_ms_per_step": kernel_ms,
            "device_busy_share": kernel_ms / (step_s * 1e3),
            "device_busy_share_profiled": kernel_ms / (prof_step_s * 1e3),
            "long_run_kernel_ms": total_us(long_k) / 1e3,
            "kernel_ms_per_step_by_class": {
                c: (ms - short_cls.get(c, 0.0)) / (LONG - SHORT) for c, ms in kernel_classes(long_k, 1).items()},
            "top_kernels_long_run": top_kernels(long_k),
        }

    out = {
        "device": smi, "layers": chip_smoke.GPTJ_6B_ARCH["n_layer"], "batch": chip_smoke.CHUNK,
        "prompt_length": trainer.prompt_length, "short_steps": SHORT, "long_steps": LONG,
        **measure(eager=False), "graph_pool_gb": chip_smoke.graph_pool_gb(),
    }
    out["eager"] = measure(eager=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
