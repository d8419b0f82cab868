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

On a sharded mesh (fsdp or tp above 1) the live module reads an fsdp
piece through its held compute copy, whole over fsdp (``fsdp_weight``), and
the LM head through its held whole (``full_weight``). The snapshot copies
those held copies, not the pieces: the take refreshes each one on the main
thread (a gather on the main group set, in parameter order, the same on
every rank) and stages it, the adopt copies it into the snapshot
parameter's own held copy, whose key stays current because nothing writes
the snapshot's piece. So the producer's rollouts issue no fsdp gather; its
only collectives are the tp all-reduces of its forwards, on the producer's
own groups (``parallel.mesh``). The int8 copies of a sharded model are the
decode shapes' (``ops.w8a16.quantize_dense``, collective on the main
thread at the take).

The handoff is staged. ``take(version)`` (main thread, at the boundary,
when no train step is in flight) writes the live values into a staging
copy; ``adopt()`` (producer thread, between stores only) copies the stage
into the module's tensors in place, so they keep their addresses and a
decode graph captured on the snapshot reads the new weights. Both run
under one lock. On one stream (the default stream both threads use) the
card runs their copies in the order the lock let them in. When the producer
enqueues on a stream of its own (several processes over NCCL), an event
recorded after each take is waited on by the next adopt's stream, and one
recorded after each adopt by the next take's: a take never overwrites a
stage that an adopt in progress reads, and an adopt reads a whole stage.
"""

import copy
import threading
from typing import Dict, Optional, Set

import torch
from torch import nn

from trlx_tpu_torch.models.lm import Dense, Embed, fsdp_weight, full_weight, placement_of
from trlx_tpu_torch.ops.w8a16 import quantize_dense


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


def _held_reads(model: nn.Module) -> Dict[str, list]:
    """{parameter name: [(attribute, how), ...]}: the held copies through
    which a sharded module reads a parameter (``_fsdp_copy`` with its fsdp
    dim, ``_full_copy`` with its placement for the LM head's weight and
    bias). Empty for an unsharded module."""
    out = {}
    tied = bool(model.cfg.tie_word_embeddings)
    for name, _ in model.named_parameters():
        pl = placement_of(model, name)
        if pl is None or (pl.fsdp_dim is None and pl.tp_dim is None):
            continue
        parts = name.split(".")
        lm_head = "lm_head" in parts
        reads = []
        if lm_head or (tied and parts[-2:] == ["wte", "embedding"]):
            reads.append(("_full_copy", pl))  # the sharded head reads its whole
        if pl.fsdp_dim is not None and not lm_head:
            reads.append(("_fsdp_copy", pl.fsdp_dim))  # every other reader gathers over fsdp
        if reads:
            out[name] = reads
    return out


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
        # A sharded module's trainable parameters read through held copies:
        # those are the snapshot's, with keys fixed to its untouched pieces.
        held = {n: h for n, h in _held_reads(model).items() if n in trainable}
        self._held = []  # (name, attribute, how, the snapshot's held buffer)
        for n, reads in held.items():
            p = own[n]
            for attr, how in reads:
                shape = tuple(how.full_shape) if attr == "_full_copy" else _gathered_shape(p.shape, how, model)
                buf = torch.empty(shape, dtype=dtype, device=p.device)
                setattr(p, attr, [(p._version, p.data_ptr()), buf, how])
                self._held.append((n, attr, how, buf))
        # A piece is copied too where a reader takes it as it is (an
        # fsdp-whole parameter split over tp only, outside the head).
        self.params = {n: own[n] for n in self.names if n not in held or _read_as_piece(model, n)}
        snap_mods = dict(self.module.named_modules())
        for name, mod in model.named_modules():
            if getattr(mod, "w8", None) is not None and mod.kernel.requires_grad:
                self._quant.append((name, mod, snap_mods[name]))
        self._stage = {n: torch.empty_like(t) for n, t in self.params.items()}
        self._stage_held = [torch.empty_like(buf) for _, _, _, buf in self._held]
        self._stage_w8 = [(torch.empty_like(s.w8[1]), torch.empty_like(s.w8[2])) for _, _, s in self._quant]
        self._lock = threading.Lock()
        self._taken = self._adopted = None  # CUDA events ordering takes and adopts across streams
        self.staged_version: Optional[int] = None
        self.version: Optional[int] = None

    def nbytes(self) -> Dict[str, int]:
        """Device bytes the snapshot owns: the module's own tensors (its
        held copies, its int8 copies) and the stage, each."""
        own = sum(t.numel() * t.element_size() for t in self.params.values())
        own += sum(buf.numel() * buf.element_size() for _, _, _, buf in self._held)
        own += sum(s.w8[1].numel() + s.w8[2].numel() * 4 for _, _, s in self._quant)
        return {"module": own, "stage": own}

    @staticmethod
    def _wait(event):
        """Order the current stream after ``event`` (another stream's copies)."""
        if event is not None:
            torch.cuda.current_stream().wait_event(event)

    def _record(self):
        """An event after the copies just enqueued (None off the card)."""
        if not next(self.module.parameters()).is_cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    @torch.no_grad()
    def take(self, version: int):
        """Stage the live values under ``version`` (main thread, at an
        iteration boundary)."""
        with self._lock:
            self._wait(self._adopted)
            live = dict(self.live.named_parameters())
            for n, p in live.items():
                if n in self._stage:
                    self._stage[n].copy_(p.detach())
            dtype = self.live.cfg.compute_dtype
            for (n, attr, how, _), st in zip(self._held, self._stage_held):
                w = live[n]
                st.copy_(full_weight(w, dtype, how) if attr == "_full_copy" else fsdp_weight(w, dtype, how))
            for (name, mod, _), (kq, sc) in zip(self._quant, self._stage_w8):
                q, s = quantize_dense(name, mod)
                kq.copy_(q)
                sc.copy_(s)
            self._taken = self._record()
            self.staged_version = version

    @torch.no_grad()
    def adopt(self) -> Optional[int]:
        """Copy the newest stage into the module in place (producer thread,
        between stores) and return the version it holds."""
        with self._lock:
            if self.staged_version is not None and self.staged_version != self.version:
                self._wait(self._taken)
                for n, t in self.params.items():
                    t.copy_(self._stage[n])
                own = dict(self.module.named_parameters())
                for (n, attr, _, buf), st in zip(self._held, self._stage_held):
                    buf.copy_(st)
                    # Current for the snapshot's piece as it now is: the
                    # forward reads the copy and gathers nothing.
                    getattr(own[n], attr)[0] = (own[n]._version, own[n].data_ptr())
                for (_, _, snap), (kq, sc) in zip(self._quant, self._stage_w8):
                    snap.w8[1].copy_(kq)
                    snap.w8[2].copy_(sc)
                    # Made from the live master, not from the snapshot's own
                    # (compute-dtype) kernel: mark the copy current.
                    snap.w8[0] = (snap.kernel._version, snap.kernel.data_ptr())
                self._adopted = self._record()
                self.version = self.staged_version
            return self.version


def _read_as_piece(model: nn.Module, name: str) -> bool:
    """A reader takes parameter ``name`` as its piece (no fsdp split, and
    not the untied LM head's, which the sharded head reads whole)."""
    pl = placement_of(model, name)
    return pl is None or (pl.fsdp_dim is None and "lm_head" not in name.split("."))


def _gathered_shape(piece_shape, fsdp_dim: int, model: nn.Module):
    """The shape of a piece gathered over the mesh's fsdp axis."""
    shape = list(piece_shape)
    shape[fsdp_dim] *= max(1, model.cfg.fsdp_size)
    return tuple(shape)
