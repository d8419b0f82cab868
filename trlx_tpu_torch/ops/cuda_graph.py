"""Capture one decode step as a CUDA graph and replay it.

The JAX package compiles its decode loop into one program (a
``lax.while_loop`` in ``generate``, a ``lax.scan`` of ``steps_per_sync``
steps in the engine). The port's step is a Python function that launches
every op on the stream, and at GPT-J width the host takes longer to launch
a step than the card takes to run it. ``StepGraph`` captures one call of
such a function, which reads and writes only buffers that outlive the
graph, and replays it; the kernels inside are the port's own, launched by
their wrappers during the capture.

Three things a replay does not do by itself, and what stands in for them:

- the kernel wrappers count their launches in Python, which a replay does
  not run: the counts the capture added are taken back (a capture launches
  nothing) and added again on every replay;
- sampling reads a generator: the graph registers it (``CudaGraph``), so
  each replay reads its seed and offset then and advances it, drawing the
  numbers an eager step would;
- the model's bf16 weight copies (``models.lm.frozen_copy``) are read at
  fixed addresses: ``models.lm.refresh_weight_copies`` brings stale ones up
  to date in place before a replay.

Captures and threads. With the overlapped pipeline (``pipeline.overlap``)
one thread may capture while another issues CUDA work: the rollout
producer captures a decode graph while the main thread trains, or the main
thread captures the eval sampler's while the producer decodes. Under
``capture_error_mode="global"`` (``torch.cuda.graph``'s default) the other
thread's allocator ``cudaMalloc``, host syncs and event queries would be
refused and would invalidate the capture. Captures here run in
``"thread_local"`` mode, which keeps that refusal for the capturing thread
only, and that suffices because of three facts the port keeps:

- a capture runs on the graph's own side stream, which PyTorch creates
  non-blocking, and no other thread's work waits on that stream or on an
  event recorded in it; every other thread enqueues on the device's
  default stream;
- the caching allocator routes into the graph's private pool only the
  allocations of the stream under capture, so another thread's
  allocations come from, and go back to, the ordinary pool;
- the capturing thread itself still makes no unsafe call: a captured step
  has no host sync and no host-to-device copy (its first call runs
  eagerly and makes what it needs);
- ``torch.cuda.graph`` registers the device's default generator with the
  capture, so a draw from it on another thread during a capture raises;
  the port draws only from generators of its own (every sampler's, the
  engine's).

The launch counts a capture takes back are guarded by ``cuda_lib.launch_lock``,
held across the capture, so another thread's launches in that window are
neither taken back nor replayed, and two captures never overlap.
"""

import torch

from trlx_tpu_torch.observability import devicemon
from trlx_tpu_torch.ops import cuda_lib


def launch_counters():
    """Every kernel wrapper that counts its launches."""
    from trlx_tpu_torch.ops import decode_attention, flash_attention, fused_logprob, w8a16

    found = {}
    for mod in (decode_attention, flash_attention, fused_logprob, w8a16):
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                found[id(fn)] = fn
    return list(found.values())


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` with ``generator`` (if any) registered,
    behind the two calls ``StepGraph`` makes. The capture runs on the
    graph's side stream, from the graph's private memory pool, in
    ``thread_local`` mode (see the module docstring)."""

    def __init__(self, generator=None):
        self._graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self._graph.register_generator_state(generator)

    def capture(self):
        return torch.cuda.graph(self._graph, capture_error_mode="thread_local")

    def replay(self):
        self._graph.replay()


class StepGraph:
    """``fn`` captured once into ``graph`` (a ``CudaGraph``, or any object
    with ``capture()`` and ``replay()``). Each ``replay()`` runs the
    captured work and adds the capture's launch counts to the wrappers'
    counters. A failed capture raises; nothing runs eagerly instead.

    Captured inside a dispatch that device telemetry counts
    (``observability.devicemon.FlopCount``), the graph keeps the FLOPs its
    capture issued (``flops``) and reports them at each replay made while a
    dispatch is counted: a replay is charged what the step it replays
    costs."""

    def __init__(self, fn, graph):
        self.graph = graph
        counters = launch_counters()
        modes = devicemon._active_counts()
        flops0 = modes[-1].captured_flops if modes else None
        with cuda_lib.launch_lock:
            before = [c.launches for c in counters]
            with graph.capture():
                fn()
            self.deltas = [(c, c.launches - b) for c, b in zip(counters, before) if c.launches != b]
            for c, b in zip(counters, before):
                c.launches = b
        self.flops = None if flops0 is None else modes[-1].captured_flops - flops0

    def replay(self):
        self.graph.replay()
        for c, d in self.deltas:
            cuda_lib.count_launch(c, d)
        if self.flops and devicemon.counting():
            devicemon.add_kernel_cost(self.flops)
