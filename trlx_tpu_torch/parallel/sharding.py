"""Partition rules: parameter names → the dims split over fsdp and tp (the
counterpart of ``trlx_tpu.parallel.sharding``, whose rules are copied here as
data).

``lm_partition_rules`` is the JAX package's list, in its order, each entry a
regex over the '/'-joined parameter path and the per-dimension axes of its
``PartitionSpec`` (``("fsdp", "tp")`` is ``P(fsdp, tp)``); the first match
wins. The port's parameter names are the JAX paths with '.' for '/'
(``models/hf_import.py`` ``params_from_jax``), so the rules apply to them as
they are. Megatron's layout: column-parallel qkv and mlp-up (output dim on
tp), row-parallel attn-out and mlp-down (input dim on tp), the vocabulary on
tp, and fsdp on the complementary dim, so the f32 masters and both Adam
moments spread over both axes. ``sanitize`` replicates a dim that its axis
size does not divide, with the JAX package's warning.

A ``Placement`` is one parameter's split: its full shape, the dim over fsdp
and the dim over tp (or None), and whether its tp dim is a fused
``[q | k | v]`` (``c_qkv``): a tp rank takes ITS HEADS' columns of each of
q, k and v, not a contiguous third of the fused matrix. ``shard`` cuts a
full tensor to a rank's piece; ``assemble`` puts the pieces of every
(fsdp, tp) coordinate back together. A checkpoint stores the pieces and a
load reassembles them by these rules onto any mesh.
"""

import re
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXIS_FSDP = "fsdp"
AXIS_TP = "tp"

Spec = Tuple[Optional[str], ...]


def lm_partition_rules() -> List[Tuple[str, Spec]]:
    """The JAX package's ``lm_partition_rules``
    (``trlx_tpu/parallel/sharding.py``): token embedding vocab on tp and
    d_model on fsdp; qkv and mlp-up column-parallel; attn-out and mlp-down
    row-parallel; the untied LM head column-parallel; layer norms
    replicated; the value and Q heads' wide hidden dim on tp; the soft
    prompt's d_model on fsdp; everything else replicated."""
    heads = r"(v_head|q1_head|q2_head|target_q1_head|target_q2_head)"
    return [
        (r"wte/embedding$", (AXIS_TP, AXIS_FSDP)),
        (r"wpe/embedding$", (None, AXIS_FSDP)),
        (r"attn/c_qkv/kernel$", (AXIS_FSDP, AXIS_TP)),
        (r"attn/c_qkv/bias$", (AXIS_TP,)),
        (r"attn/(q_proj|k_proj|v_proj)/kernel$", (AXIS_FSDP, AXIS_TP)),
        (r"attn/(q_proj|k_proj|v_proj)/bias$", (AXIS_TP,)),
        (r"attn/c_proj/kernel$", (AXIS_TP, AXIS_FSDP)),
        (r"attn/c_proj/bias$", (None,)),
        (r"mlp/c_fc/kernel$", (AXIS_FSDP, AXIS_TP)),
        (r"mlp/c_fc/bias$", (AXIS_TP,)),
        (r"mlp/c_proj/kernel$", (AXIS_TP, AXIS_FSDP)),
        (r"mlp/c_proj/bias$", (None,)),
        (r"lm_head/kernel$", (AXIS_FSDP, AXIS_TP)),
        (r"lm_head/bias$", (AXIS_TP,)),
        (r"(ln_1|ln_2|ln_f|layernorm.*)/(scale|bias)$", ()),
        (heads + r"/layers_0/kernel$", (AXIS_FSDP, AXIS_TP)),
        (heads + r"/layers_0/bias$", (AXIS_TP,)),
        (heads + r"/layers_1/kernel$", (AXIS_TP, None)),
        (r"soft_prompt$", (None, AXIS_FSDP)),
        (r".*", ()),
    ]


def match_rule(name: str, rules: Optional[Sequence[Tuple[str, Spec]]] = None) -> Spec:
    """The spec of the first rule whose regex matches ``name`` ('.' or '/'
    separated)."""
    path = name.replace(".", "/")
    for pattern, spec in rules if rules is not None else lm_partition_rules():
        if re.search(pattern, path):
            return spec
    return ()


def sanitize(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    """Replicate every dim its axis size does not divide (a tiny or odd
    vocabulary or head count on a large mesh), with the JAX package's
    warning; an axis of size 1 splits nothing."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None or sizes.get(axis, 1) == 1:
            out.append(None)
            continue
        size = sizes[axis]
        if i < len(shape) and shape[i] % size == 0:
            out.append(axis)
        else:
            warnings.warn(
                f"replicating dim {i} of a {tuple(shape)} param: not divisible by mesh axes ({axis!r},) "
                f"(size {size}) — expect higher per-chip memory for this tensor"
            )
            out.append(None)
    return tuple(out)


@dataclass(frozen=True)
class Placement:
    """One parameter's split over (fsdp, tp): ``full_shape``, ``fsdp_dim``
    and ``tp_dim`` (None: not split over that axis), ``qkv`` (the tp dim is
    a fused [q | k | v], split per head of each), and the axis sizes."""

    full_shape: Tuple[int, ...]
    fsdp_dim: Optional[int] = None
    tp_dim: Optional[int] = None
    qkv: bool = False
    fsdp: int = 1
    tp: int = 1

    @property
    def local_shape(self) -> Tuple[int, ...]:
        shape = list(self.full_shape)
        if self.tp_dim is not None:
            shape[self.tp_dim] //= self.tp
        if self.fsdp_dim is not None:
            shape[self.fsdp_dim] //= self.fsdp
        return tuple(shape)

    @property
    def replicas(self) -> int:
        """How many (fsdp, tp) coordinates hold the same piece."""
        return (self.fsdp if self.fsdp_dim is None else 1) * (self.tp if self.tp_dim is None else 1)

    def tp_piece(self, full: torch.Tensor, tp_rank: int) -> torch.Tensor:
        """``full``'s columns (or rows) of tp rank ``tp_rank``."""
        if self.tp_dim is None:
            return full
        d = self.tp_dim
        if self.qkv:
            shape = list(full.shape)
            third = shape[d] // 3
            x = full.reshape(shape[:d] + [3, self.tp, third // self.tp] + shape[d + 1:])
            x = x.select(d + 1, tp_rank)
            return x.reshape(shape[:d] + [3 * third // self.tp] + shape[d + 1:])
        n = full.shape[d] // self.tp
        return full.narrow(d, tp_rank * n, n)

    def fsdp_piece(self, t: torch.Tensor, fsdp_rank: int) -> torch.Tensor:
        if self.fsdp_dim is None:
            return t
        n = t.shape[self.fsdp_dim] // self.fsdp
        return t.narrow(self.fsdp_dim, fsdp_rank * n, n)

    def shard(self, full: torch.Tensor, fsdp_rank: int, tp_rank: int) -> torch.Tensor:
        """The piece of ``full`` that (fsdp_rank, tp_rank) holds."""
        if tuple(full.shape) != self.full_shape:
            raise ValueError(f"shape {tuple(full.shape)} != the parameter's {self.full_shape}")
        return self.fsdp_piece(self.tp_piece(full, tp_rank), fsdp_rank)

    def join_tp(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """The tp pieces (in tp order) back into the whole along tp_dim."""
        if self.tp_dim is None:
            return pieces[0]
        d = self.tp_dim
        if self.qkv:
            shape = list(pieces[0].shape)
            per = shape[d] // 3
            parts = [p.reshape(shape[:d] + [3, per] + shape[d + 1:]) for p in pieces]
            x = torch.stack(parts, dim=d + 1)  # [.., 3, T, per, ..]
            return x.reshape(shape[:d] + [3 * per * len(pieces)] + shape[d + 1:])
        return torch.cat(list(pieces), dim=d)

    def assemble(self, pieces: Dict[Tuple[int, int], torch.Tensor]) -> torch.Tensor:
        """The full tensor from the pieces of every (fsdp_rank, tp_rank)
        coordinate (the replicas of an unsplit axis: any one of them)."""
        fs = range(self.fsdp) if self.fsdp_dim is not None else [0]
        ts = range(self.tp) if self.tp_dim is not None else [0]
        cols = []
        for t in ts:
            rows = [pieces[(f, t)] for f in fs]
            cols.append(torch.cat(rows, dim=self.fsdp_dim) if self.fsdp_dim is not None else rows[0])
        return self.join_tp(cols)


def placement(name: str, full_shape: Sequence[int], sizes: Dict[str, int], tp_split: bool = True,
              qkv: bool = False) -> Placement:
    """A parameter's placement by the rules, sanitized against its full
    shape. ``tp_split`` False replicates it over tp (its module computes
    whole: the model's decision for a head count, width or vocabulary that
    tp does not divide)."""
    spec = sanitize(match_rule(name), full_shape, sizes)
    fsdp_dim = spec.index(AXIS_FSDP) if AXIS_FSDP in spec else None
    tp_dim = spec.index(AXIS_TP) if (AXIS_TP in spec and tp_split) else None
    return Placement(tuple(int(s) for s in full_shape), fsdp_dim, tp_dim, qkv and tp_dim is not None,
                     int(sizes.get(AXIS_FSDP, 1)), int(sizes.get(AXIS_TP, 1)))


def tp_divides(name: str, full_shape: Sequence[int], tp: int) -> bool:
    """Whether the rules split ``name`` over tp at this size (quietly: the
    model asks before it builds, ``placement`` warns later)."""
    spec = match_rule(name)
    if AXIS_TP not in spec or tp <= 1:
        return False
    return full_shape[spec.index(AXIS_TP)] % tp == 0
