"""Autoregressive decode: prefill + a KV-cache token loop (the counterpart
of ``trlx_tpu.ops.generate``).

The JAX package compiles prefill and a ``while_loop`` into one program.
Here prefill runs eagerly and every decode step is one call of a step
function that reads and writes only static buffers (tokens, mask, KV cache,
the sampler's state, the stats, a device step counter): the step is written
at the vector ``cache_index`` P + step, the token and the stats land by
device-indexed copies. On a CUDA device the first step runs eagerly, the
step is then captured once as a CUDA graph (``ops.cuda_graph``) and
replayed for every later step; the buffers and the graph are kept for the
next call of the same shape. On the CPU the same step function runs
eagerly, so the CPU tests run the code that is captured. Prompts are
left-padded to a fixed width, so the last prompt position is always the
sampling position.

A soft-prompt model (``n_soft_tokens``) prefills its prefix into cache rows
[0, n_soft): the cache holds T + n_soft rows, the model sees the
cache-space mask (ones for the prefix, then the token mask), and a decode
step writes at P + step + n_soft with ``prepend_soft=False``. A model with
int8 decode weights (``ops.w8a16.quantize_weights``) prefills and decodes
inside ``models.lm.decode_weights``; its copies are re-quantized in place
before the loop when the weights changed.
"""

import sys
from functools import partial
from typing import Callable, Optional, Tuple

import torch

from trlx_tpu_torch.device import stamp
from trlx_tpu_torch.models.lm import decode_weights, init_cache, refresh_weight_copies
from trlx_tpu_torch.ops.cuda_graph import CudaGraph, StepGraph
from trlx_tpu_torch.ops.sampling import GenerateConfig, process_logits_default, sample_categorical
from trlx_tpu_torch.parallel.mesh import AXIS_TP, peek_mesh

# Decode steps the host may queue on the card past an unread "every row
# finished" flag: enough to keep the card fed while the host waits for the
# flag, few enough that an early finish wastes at most about twice as many.
POLL_AHEAD = 8


def _last_position(out):
    """A fresh copy of the last position of a [B, L, ...] model output, or of
    each tensor of a tuple of them (ILQL's Q heads)."""
    if isinstance(out, (tuple, list)):
        return tuple(t[:, -1].clone() for t in out)
    return out[:, -1].clone()


def _copy_last_position(dst, out):
    """Write the last position of ``out`` into ``dst`` (``_last_position``'s
    buffers), in place."""
    if isinstance(dst, tuple):
        for d, t in zip(dst, out):
            d.copy_(t[:, -1])
    else:
        dst.copy_(out[:, -1])


def _static_buffers(cache, B: int, P: int, N: int, n_soft: int, prompt_dtype, device, out, carry_keys,
                    step_stats_fn):
    """The decode loop's buffers for one (B, P, N): tokens and mask
    [B, P + N], the cache-space mask [B, n_soft + P + N] (ones over the soft
    prefix; the mask itself without one), the KV cache the prefill wrote, the sampler's state, a [1]
    step counter and, with ``step_stats_fn``, the [B, N, ...] stats (their
    shapes read from one call on the prefill state)."""
    T = P + N
    st = {
        "finished": torch.zeros((B,), dtype=torch.bool, device=device),
        "last_logits": out["logits"][:, -1].float().clone(),
        "last_hidden": out["hidden"][:, -1].clone(),
        "carry": {k: _last_position(out[k]) for k in carry_keys},
    }
    buf = {
        "tokens": torch.empty((B, T), dtype=prompt_dtype, device=device),
        "mask": torch.empty((B, T), dtype=torch.int32, device=device),
        "cache": cache,
        "state": st,
        "step": torch.zeros((1,), dtype=torch.long, device=device),
        "ones": torch.ones((B, 1), dtype=torch.int32, device=device),
        "stats": None,
        "graph": None,
    }
    buf["cache_mask"] = torch.ones((B, n_soft + T), dtype=torch.int32, device=device) if n_soft else buf["mask"]
    if step_stats_fn is not None:
        probe = step_stats_fn(torch.zeros((B,), dtype=prompt_dtype, device=device), st)
        buf["stats"] = {
            k: torch.zeros((B, N) + tuple(v.shape[1:]), dtype=torch.float32 if v.ndim == 1 else v.dtype,
                           device=device)
            for k, v in probe.items()
        }
    return buf


def _make_step(model, buf, gcfg: GenerateConfig, P: int, processor, carry_keys, step_stats_fn, extra, generator,
               rows=None):
    """The decode step over ``buf``: sample from the carried logits, write
    the token and its mask bit at P + step, run the model over the cache at
    that offset, collect the stats of the PRE-step state, carry the new
    logits, and advance the step counter. Everything in place."""
    tokens, mask, cache, st, step = buf["tokens"], buf["mask"], buf["cache"], buf["state"], buf["step"]
    B = tokens.shape[0]
    eos = gcfg.eos_token_id
    n_soft = model.cfg.n_soft_tokens
    # The cache-space mask: the token mask behind the soft prefix's ones.
    cache_mask = buf["cache_mask"]
    step_kw = {"prepend_soft": False} if n_soft else {}

    def step_fn():
        pos = step + P  # [1] write position
        step_col = step.expand(B)[:, None]
        last_token = tokens.index_select(1, pos - 1)[:, 0]
        if processor is not None:
            logits = processor(st["last_logits"], {"last_token": last_token, "hidden": st["last_hidden"],
                                                   "step": step_col, "carry": st["carry"]})
        else:
            logits = process_logits_default(st["last_logits"], gcfg, step_col)
        if gcfg.do_sample:
            tok = sample_categorical(torch.softmax(logits.float(), dim=-1), generator, rows)
        else:
            tok = torch.argmax(logits, dim=-1)
        was_finished = st["finished"]
        live = ~was_finished
        tok = torch.where(was_finished, gcfg.pad_token_id, tok.to(tokens.dtype))
        finished = was_finished | (tok == eos) if eos is not None else was_finished

        tokens.index_copy_(1, pos, tok[:, None])
        mask.index_copy_(1, pos, live.to(torch.int32)[:, None])
        if n_soft:
            cache_mask.index_copy_(1, pos + n_soft, live.to(torch.int32)[:, None])
        out = model(input_ids=tok[:, None], attention_mask=buf["ones"], cache=cache,
                    cache_index=(pos + n_soft).expand(B), cache_mask=cache_mask, **step_kw, **extra)
        if step_stats_fn is not None:
            for k, v in step_stats_fn(tok, st).items():
                keep = live.reshape((-1,) + (1,) * (v.ndim - 1)).to(v.dtype)
                dst = buf["stats"][k]
                dst.index_copy_(1, step, (v * keep).to(dst.dtype)[:, None])
        st["finished"].copy_(finished)
        st["last_logits"].copy_(out["logits"][:, 0])
        st["last_hidden"].copy_(out["hidden"][:, 0])
        for k in carry_keys:
            _copy_last_position(st["carry"][k], out[k])
        step.add_(1)

    return step_fn


@torch.no_grad()
def generate(
    model,
    prompt_ids: torch.Tensor,
    prompt_mask: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    gcfg: GenerateConfig,
    processor: Optional[Callable] = None,
    carry_keys: Tuple[str, ...] = (),
    step_stats_fn: Optional[Callable] = None,
    apply_kwargs: Optional[dict] = None,
    prefill_collect: Tuple[str, ...] = (),
    timings: Optional[dict] = None,
    rows=None,
    _keep: Optional[dict] = None,
    _eager: bool = False,
):
    """Decode ``gcfg.max_new_tokens`` tokens after left-padded prompts.

    prompt_ids/prompt_mask: [b, P] (tensors or arrays; they are moved to
    the model's device, where everything runs). Returns (tokens,
    mask) [b, P + max_new_tokens]; positions after a row finishes hold
    pad_token_id with mask 0.

    The loop stops early once every row has finished (only possible with an
    eos token). The check starts at step ``min_new_tokens``, before which
    the default logits chain suppresses eos. On the CPU it reads the flag at
    once. On a GPU a step copies the flag to pinned host memory behind an
    event, and a later step reads it once the event has passed, or waits for
    it once ``POLL_AHEAD`` steps are queued behind it (a replayed step costs
    the host far less than the card, so the host would otherwise run ahead
    by the whole loop); the loop may run up to about 2 * POLL_AHEAD steps
    past the point where every row finished. Those steps write pad tokens,
    mask 0 and zero stats, which the finished rows hold already, so the
    outputs do not change. ``carry_keys``
    names model outputs whose last-position values are carried to the
    processor under state["carry"] (an output that is a tuple of tensors,
    as ILQL's Q heads, is carried as a tuple); the processor's state["step"] is the
    decode step as a [b, 1] device tensor. ``step_stats_fn(tok, state) ->
    {name: [b, ...]}`` reduces each step's PRE-step state to per-step values,
    collected into [b, max_new_tokens, ...] buffers (scalars f32, vectors in
    their dtype; exact zeros once a row has finished) and returned as a third
    output. ``apply_kwargs`` is merged into every model call;
    ``prefill_collect`` names prefill outputs returned as a fourth output.
    Sampling draws from ``generator`` (the default generator when None) and
    advances it as an eager loop would; ``rows`` = (first, total) marks the
    prompts as rows first.. of a batch of ``total`` (a data rank's share:
    ``sampling.sample_categorical``). ``timings``, when given, receives
    device ``stamp``s at "start", "prefill" (prefill done) and "end".

    On a CUDA device the decode steps after the first replay a CUDA graph of
    the step, where ``graphs_allowed`` says a graph may hold the step's
    collectives. ``_keep`` is a dict that keeps the static buffers and the
    graph of every shape for its next call (``make_generate_fn`` passes
    one); ``_eager`` (tests and the chip smoke's comparison only) launches
    every step eagerly instead."""
    if prefill_collect and step_stats_fn is None:
        raise ValueError("prefill_collect requires step_stats_fn")
    with decode_weights(model):
        return _generate(model, prompt_ids, prompt_mask, generator, gcfg, processor, carry_keys, step_stats_fn,
                         apply_kwargs, prefill_collect, timings, _keep, _eager, rows)


_ANNOUNCED = set()


def graphs_allowed(device: torch.device) -> bool:
    """The one rule for capturing decode steps: a CUDA device, and every
    collective inside a step capturable. A decode step issues tp's
    all-reduces (fsdp's weights are gathered before the loop, the data
    ranks decode apart); on an NCCL tp group they are captured with the
    step, on a gloo one (staged through host memory:
    ``parallel.collectives``) they cannot be, and the sampler runs its steps
    eagerly. The process prints which mode it took, once."""
    if device.type != "cuda":
        return False
    mesh = peek_mesh()
    tp = mesh.group(AXIS_TP) if mesh is not None else None
    ok = tp is None or tp.capturable
    mode = "graphs" if ok else f"eager (tp over {tp.backend} cannot be captured)"
    if mode not in _ANNOUNCED:
        _ANNOUNCED.add(mode)
        print(f"[trlx_tpu_torch] decode steps: {mode}", file=sys.stderr, flush=True)
    return ok


def _generate(model, prompt_ids, prompt_mask, generator, gcfg, processor, carry_keys, step_stats_fn, apply_kwargs,
              prefill_collect, timings, _keep, _eager, rows=None):
    cfg = model.cfg
    device = next(model.parameters()).device
    prompt_ids = torch.as_tensor(prompt_ids, device=device)
    prompt_mask = torch.as_tensor(prompt_mask, device=device)
    B, P = prompt_ids.shape
    N = gcfg.max_new_tokens
    n_soft = cfg.n_soft_tokens
    eos = gcfg.eos_token_id
    extra = apply_kwargs or {}
    use_graph = not _eager and graphs_allowed(device)
    # Replays read the bf16 weight copies and the int8 decode copies without
    # making them: bring stale ones (an optimizer step since the last call)
    # up to date in place.
    refresh_weight_copies(model)
    w8 = any(getattr(m, "w8_on", False) for m in model.modules())

    # What the buffers and the captured step depend on, besides the weights.
    key = (B, P, prompt_ids.dtype, gcfg, use_graph, model, processor, carry_keys, step_stats_fn,
           tuple(sorted(extra.items())), generator is None, w8, rows)
    # One set of buffers (and one graph) per prompt width, so prompt buckets
    # keep one each; a change of anything else frees them all first, as a
    # change of shape did before buckets. ``_keep["buffers"]`` is the set
    # last used.
    buf = None
    if _keep is not None:
        kept = _keep.setdefault("by_key", {})
        for k in [k for k in kept if k[:1] + k[2:] != key[:1] + key[2:]]:
            del kept[k]
        buf = kept.get(key)
    if timings is not None:
        timings["start"] = stamp(device)
    cache = buf["cache"] if buf is not None else init_cache(cfg, B, n_soft + P + N, device)
    mask0 = torch.cat([prompt_mask.to(torch.int32), torch.zeros((B, N), dtype=torch.int32, device=device)], dim=1)
    soft_mask0 = mask0
    if n_soft:
        soft_mask0 = torch.cat([torch.ones((B, n_soft), dtype=torch.int32, device=device), mask0], dim=1)
    # Only the last prompt position's logits are sampled from.
    out = model(
        input_ids=prompt_ids, attention_mask=prompt_mask, cache=cache, cache_index=0, cache_mask=soft_mask0,
        logits_start=P - 1, **extra,
    )
    prefill_extras = {k: out[k] for k in prefill_collect}
    if buf is None:
        buf = _static_buffers(cache, B, P, N, n_soft, prompt_ids.dtype, device, out, carry_keys, step_stats_fn)
        buf["key"] = key
        if _keep is not None:
            _keep["by_key"][key] = buf
    if _keep is not None:
        _keep["buffers"] = buf
    st = buf["state"]
    buf["tokens"][:, :P] = prompt_ids
    buf["tokens"][:, P:] = gcfg.pad_token_id
    buf["mask"].copy_(mask0)
    if n_soft:
        buf["cache_mask"].copy_(soft_mask0)
    buf["step"].zero_()
    st["finished"].zero_()
    st["last_logits"].copy_(out["logits"][:, -1])
    st["last_hidden"].copy_(out["hidden"][:, -1])
    for k in carry_keys:
        _copy_last_position(st["carry"][k], out[k])
    if buf["stats"] is not None:
        for v in buf["stats"].values():
            v.zero_()
    if timings is not None:
        timings["prefill"] = stamp(device)

    # The graph draws from a generator of its own, registered at capture;
    # the caller's state is copied in here and back after the loop.
    sampler = generator
    if use_graph and generator is not None:
        if "generator" not in buf:
            buf["generator"] = torch.Generator(device=device)
        sampler = buf["generator"]
        sampler.set_state(generator.get_state())
    if buf.get("step_fn") is None or not use_graph:
        buf["step_fn"] = _make_step(model, buf, gcfg, P, processor, carry_keys, step_stats_fn, extra, sampler, rows)

    poll = None  # GPU: (event, pinned flag, step) of an in-flight "every row finished" copy
    for step in range(N):
        if eos is not None and step >= gcfg.min_new_tokens:
            if device.type != "cuda":
                if bool(st["finished"].all()):
                    break
            else:
                if poll is not None and (step - poll[2] >= POLL_AHEAD or poll[0].query()):
                    poll[0].synchronize()
                    if bool(poll[1]):
                        break
                    poll = None
                if poll is None:
                    flag = torch.empty((), dtype=torch.bool, pin_memory=True)
                    flag.copy_(st["finished"].all(), non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    poll = (event, flag, step)
        if not use_graph:
            buf["step_fn"]()
        elif buf["graph"] is not None:
            buf["graph"].replay()
        else:
            # First call of this shape: one eager step (it makes the weight
            # copies, loads the kernels and any table a processor moves to
            # the device), then the capture, which launches nothing.
            buf["step_fn"]()
            buf["graph"] = StepGraph(buf["step_fn"], CudaGraph(sampler))

    if use_graph and generator is not None:
        generator.set_state(sampler.get_state())
    if timings is not None:
        timings["end"] = stamp(device)
    tokens, mask, stats = buf["tokens"], buf["mask"], buf["stats"]
    if _keep is not None:  # the buffers serve the next call
        tokens, mask = tokens.clone(), mask.clone()
        stats = None if stats is None else {k: v.clone() for k, v in stats.items()}
    if step_stats_fn is not None and prefill_collect:
        return tokens, mask, stats, prefill_extras
    if step_stats_fn is not None:
        return tokens, mask, stats
    return tokens, mask


def make_generate_fn(model, gcfg: GenerateConfig, processor: Optional[Callable] = None,
                     carry_keys: Tuple[str, ...] = (), step_stats_fn: Optional[Callable] = None,
                     apply_kwargs: Optional[dict] = None, prefill_collect: Tuple[str, ...] = ()):
    """Bind everything but the data: returns fn(prompt_ids, prompt_mask,
    generator, timings=None). The function keeps its decode step's static
    buffers and CUDA graph for the next call of the same shape."""
    return partial(
        generate,
        model,
        gcfg=gcfg,
        processor=processor,
        carry_keys=carry_keys,
        step_stats_fn=step_stats_fn,
        apply_kwargs=apply_kwargs,
        prefill_collect=prefill_collect,
        _keep={},
    )
