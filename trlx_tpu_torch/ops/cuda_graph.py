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
"""

import torch


def launch_counters():
    """Every kernel wrapper that counts its launches."""
    from trlx_tpu_torch.ops import decode_attention, flash_attention, fused_logprob

    found = {}
    for mod in (decode_attention, flash_attention, fused_logprob):
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                found[id(fn)] = fn
    return list(found.values())


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` with ``generator`` (if any) registered,
    behind the two calls ``StepGraph`` makes. The capture runs on the
    graph's side stream, from the graph's private memory pool."""

    def __init__(self, generator=None):
        self._graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self._graph.register_generator_state(generator)

    def capture(self):
        return torch.cuda.graph(self._graph)

    def replay(self):
        self._graph.replay()


class StepGraph:
    """``fn`` captured once into ``graph`` (a ``CudaGraph``, or any object
    with ``capture()`` and ``replay()``). Each ``replay()`` runs the
    captured work and adds the capture's launch counts to the wrappers'
    counters. A failed capture raises; nothing runs eagerly instead."""

    def __init__(self, fn, graph):
        self.graph = graph
        counters = launch_counters()
        before = [c.launches for c in counters]
        with graph.capture():
            fn()
        self.deltas = [(c, c.launches - b) for c, b in zip(counters, before) if c.launches != b]
        for c, b in zip(counters, before):
            c.launches = b

    def replay(self):
        self.graph.replay()
        for c, d in self.deltas:
            c.launches += d
