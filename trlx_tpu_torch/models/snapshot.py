"""The rollout producer's boundary weights (the counterpart of the JAX
trainer's ``_rollout_snapshot``).

At ``method.max_staleness > 0`` the rollout producer decodes on its own
thread while the main thread trains. The JAX package copies the whole
TrainState at each iteration boundary because its train step donates the
state's buffers. The port's hazard is another one: the live module's bf16
weight copies are refreshed lazily, in place (``models.lm.frozen_copy``),
so the first forward after an optimizer step, on either thread, would
rewrite a copy that a replayed decode graph may be reading. So the
producer decodes from a module of its own, ``RolloutSnapshot.module``,
whose weights only the boundary handoff writes:

- the tensors train steps write (``trainable``) are the snapshot's own:
  in the compute dtype where every reader casts them to it (the Dense
  kernels, the embedding tables, the soft prompt; the same values the live
  module's bf16 copies hold), in the parameter dtype where a reader takes
  them as they are (the LayerNorms, the biases, the value head's f32
  output layer), so the snapshot computes what the live module computed
  at the boundary, bit for bit;
- the frozen tensors (the frozen trunk; the reference branch lives in the
  trainer's extras) are shared, not copied: nothing writes them;
- with int8 decode weights the snapshot holds its own int8 copies of its
  trainable products, quantized from the live f32 masters at the boundary
  (the JAX package re-quantizes its f32 snapshot), and shares the frozen
  ones.

The handoff is staged. ``take(version)`` (main thread, at the boundary,
when no train step is in flight) writes the live values into a staging
copy; ``adopt()`` (producer thread, between stores only) copies the stage
into the module's tensors in place, so they keep their addresses and a
decode graph captured on the snapshot reads the new weights. Both enqueue
their copies on the device's default stream, which both threads use, under
one lock, so the card runs them in the order the lock let them in: a take
never overwrites a stage that an adopt in progress reads, and an adopt
reads a whole stage.
"""

import copy
import threading
from typing import Dict, Optional, Set

import torch
from torch import nn

from trlx_tpu_torch.models.lm import Dense, Embed
from trlx_tpu_torch.ops.w8a16 import quantize_channels


def _compute_dtype_names(model: nn.Module) -> Set[str]:
    """Parameters every reader casts to the compute dtype first: Dense
    kernels (but the value head's output layer, read in f32 by
    ``heads.MLPHead``), embedding tables and the soft prompt."""
    from trlx_tpu_torch.models.heads import MLPHead

    f32_layers = {id(m.layers_1) for m in model.modules() if isinstance(m, MLPHead)}
    names = set()
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, Dense) and id(mod) not in f32_layers:
            names.add(prefix + "kernel")
        elif isinstance(mod, Embed):
            names.add(prefix + "embedding")
    names.update(n for n, _ in model.named_parameters() if n.endswith("soft_prompt"))
    return names


class RolloutSnapshot:
    """A copy of ``model`` for the rollout producer: own tensors for the
    parameters named in ``trainable``, shared ones for the rest (see the
    module docstring). ``version`` is the boundary the module holds (None
    before the first ``adopt``)."""

    def __init__(self, model: nn.Module, trainable: Set[str]):
        self.live = model
        dtype = model.cfg.compute_dtype
        in_compute = _compute_dtype_names(model)
        self.names = [n for n, _ in model.named_parameters() if n in trainable]
        live = dict(model.named_parameters())
        memo = {}
        for n, p in live.items():
            if n in trainable:
                dt = dtype if n in in_compute else p.dtype
                memo[id(p)] = nn.Parameter(torch.empty(p.shape, dtype=dt, device=p.device), requires_grad=False)
            else:
                memo[id(p)] = p
        # Int8 decode copies: the frozen products' are shared; the trainable
        # products' are the snapshot's own (made by the deep copy).
        self._quant = []  # (live Dense, snapshot Dense) of trainable quantized products
        for _, mod in model.named_modules():
            if getattr(mod, "w8", None) is not None and not mod.kernel.requires_grad:
                memo[id(mod.w8)] = mod.w8
        self.module = copy.deepcopy(model, memo)
        own = dict(self.module.named_parameters())
        self.params = {n: own[n] for n in self.names}
        snap_mods = dict(self.module.named_modules())
        for name, mod in model.named_modules():
            if getattr(mod, "w8", None) is not None and mod.kernel.requires_grad:
                self._quant.append((mod, snap_mods[name]))
        self._stage = {n: torch.empty_like(t) for n, t in self.params.items()}
        self._stage_w8 = [(torch.empty_like(s.w8[1]), torch.empty_like(s.w8[2])) for _, s in self._quant]
        self._lock = threading.Lock()
        self.staged_version: Optional[int] = None
        self.version: Optional[int] = None

    def nbytes(self) -> Dict[str, int]:
        """Device bytes the snapshot owns: the module's own tensors (and
        int8 copies) and the stage, each."""
        own = sum(t.numel() * t.element_size() for t in self.params.values())
        own += sum(s.w8[1].numel() + s.w8[2].numel() * 4 for _, s in self._quant)
        return {"module": own, "stage": own}

    @torch.no_grad()
    def take(self, version: int):
        """Stage the live values under ``version`` (main thread, at an
        iteration boundary)."""
        with self._lock:
            for n, p in self.live.named_parameters():
                if n in self._stage:
                    self._stage[n].copy_(p.detach())
            for (mod, _), (kq, sc) in zip(self._quant, self._stage_w8):
                q, s = quantize_channels(mod.kernel)
                kq.copy_(q)
                sc.copy_(s)
            self.staged_version = version

    @torch.no_grad()
    def adopt(self) -> Optional[int]:
        """Copy the newest stage into the module in place (producer thread,
        between stores) and return the version it holds."""
        with self._lock:
            if self.staged_version is not None and self.staged_version != self.version:
                for n, t in self.params.items():
                    t.copy_(self._stage[n])
                for (_, snap), (kq, sc) in zip(self._quant, self._stage_w8):
                    snap.w8[1].copy_(kq)
                    snap.w8[2].copy_(sc)
                    # Made from the live master, not from the snapshot's own
                    # (compute-dtype) kernel: mark the copy current.
                    snap.w8[0] = (snap.kernel._version, snap.kernel.data_ptr())
                self.version = self.staged_version
            return self.version
