"""Causal transformer LM (PyTorch), the counterpart of ``trlx_tpu.models.lm``.

One module covers GPT-2 (learned positions, sequential residual, fused qkv,
tied head), GPT-J (rotary, parallel residual with one LN, untied head with
bias) and NeoX-style layouts. Parameters keep the JAX package's names and
layouts (``transformer.h_{i}.attn.q_proj.kernel`` is ``[in, out]``), so a
Flax parameter tree carries over one to one (``hf_import.params_from_jax``).

Parameters are stored in ``param_dtype`` and cast to the compute dtype at
use, as the JAX package does. The KV cache is a tuple of per-layer leaves
written IN PLACE: (k, v) [b, T, h, d], or (k_i8, v_i8, k_scale, v_scale)
with ``kv_cache_quant`` (``quantize_kv``: per-(token, head) absmax scales
[b, T, h]). ``cache_index`` is the write offset: an int for the whole batch,
or a [b] tensor with each row's own offset (the rollout engine's slots).
With ``block_tables`` [b, bps] the per-layer leaves are ONE shared pool
[n_blocks, bs, h, d] (``init_paged_cache``) and each row's virtual cache of
bps * bs keys lives in the pool blocks its table names; offsets, masks,
positions and biases address the virtual cache unchanged.

Attention routes through four paths, by the JAX package's static rules:

- ring attention over the mesh's sp group for full-sequence passes of a
  model built for sp > 1 (``ring_eligible``: no cache, the length divides
  the ring; ``parallel.ring_attention.ring_attention_sharded``, whose
  chunks take the flash kernels' offset mode on a CUDA device);
- the flash kernel for full-sequence passes and for prefill at a static
  cache index 0 (``flash_eligible``; "auto" needs a CUDA device, bf16 and a
  long 128-aligned sequence);
- the decode kernels for single-token steps over the cache
  (``decode_attn_eligible`` / ``paged_decode_eligible``; CUDA device and
  bf16): bf16 or int8, direct or through the block tables;
- the einsum path with an additive [b, 1, q, kv] bias otherwise, over the
  cache dequantised in the compute dtype and gathered to the virtual view.

``n_soft_tokens`` prepends a learned prefix (``soft_prompt``
[n_soft, d_model]) to the embeddings and ones to the mask, shifts the
positions, and slices the outputs back to the caller's length;
``prepend_soft=False`` on decode and verify steps, whose cache already
holds the prefix. Int8 decode weights (W8A16): ``ops.w8a16.quantize_weights``
gives each quantized Dense an int8 copy, which it reads instead of its
kernel inside ``decode_weights(module)`` (the decode paths), as QDense
reads the ``qw`` collection; training and scoring never enter it.

On a mesh with fsdp or tp above 1 (``LMConfig.with_mesh``) each module
builds its tp-local shapes (Megatron: qkv and mlp-up column-parallel, each
rank its heads' columns of q, k and v; attn-out and mlp-down row-parallel
with one all-reduce; the vocabulary's rows over tp) and ``place_model``
makes every parameter this rank's piece by ``parallel.sharding``'s rules.
Forwards read bf16 compute copies gathered over fsdp once per weight
version (``fsdp_weight``; the LM head's whole, ``full_weight``), whose
gradient is reduce-scattered back to the piece in f32. The kernel gates read
the model's head count, not the rank's.

``remat`` checkpoints every block under grad: policy "full" keeps only the
block's input, policy "dots" also keeps the outputs of the weight products
(``aten.mm`` / ``addmm``, the JAX package's ``dots_with_no_batch_dims_saveable``)
and recomputes the rest. ``segment_ids`` (packed train batches, full-sequence
passes only) makes the attention block-diagonal per packed episode; such a
pass takes the einsum path, since the flash and ring kernels take no
segments (the JAX package's rule).
"""

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, set_checkpoint_early_stop,
)

from trlx_tpu_torch.device import resolve_device, torch_dtype
from trlx_tpu_torch.observability.numerics import probe_tap
from trlx_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attn_eligible,
    gather_pool,
    paged_decode_attention,
    paged_decode_eligible,
)
from trlx_tpu_torch.ops.flash_attention import auto_flash_ok, flash_attention
from trlx_tpu_torch.ops.fused_logprob import routed_logprob
from trlx_tpu_torch.ops.w8a16 import quantize_weights, w8a16_matmul
from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel.mesh import AXIS_FSDP, AXIS_SP, AXIS_TP, get_mesh, peek_mesh
from trlx_tpu_torch.parallel.ring_attention import ring_attention_sharded
from trlx_tpu_torch.parallel.sharding import Placement, match_rule, placement, tp_divides


@dataclass(frozen=True)
class LMConfig:
    """Architecture config — the fields of ``trlx_tpu.models.lm.LMConfig``."""

    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 → 4*d_model
    max_position: int = 1024
    pos_type: str = "learned"  # "learned" | "rotary"
    rotary_dim: int = 0  # 0 with rotary → full head dim
    parallel_residual: bool = False
    use_parallel_ln: bool = False
    fused_qkv: bool = True
    qkv_bias: bool = True
    out_bias: bool = True
    scale_attn: bool = True
    attention_layers: Tuple[str, ...] = ()
    window_size: int = 0
    tie_word_embeddings: bool = True
    activation: str = "gelu_new"
    ln_eps: float = 1e-5
    embd_pdrop: float = 0.0
    n_soft_tokens: int = 0
    attn_impl: str = "auto"  # "auto" | "flash" | "xla" (einsum)
    sp_size: int = 0
    onehot_embed: bool = False
    kv_cache_quant: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "full"
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} (expected 'full' or 'dots')")
        if self.attn_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"attn_impl must be auto|flash|xla, got {self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff else 4 * self.d_model

    @property
    def tp_size(self) -> int:
        """The mesh's tp (``extra["tp_size"]``, set by the trainer; 0 or 1:
        none): modules split by ``parallel.sharding``'s rules."""
        return int(self.extra.get("tp_size", 0))

    @property
    def fsdp_size(self) -> int:
        """The mesh's fsdp (``extra["fsdp_size"]``): masters split, compute
        copies gathered."""
        return int(self.extra.get("fsdp_size", 0))

    def with_mesh(self, tp: int = 1, fsdp: int = 1) -> "LMConfig":
        """This config on a mesh with ``tp`` and ``fsdp`` (kept in
        ``extra``, so the fields stay the JAX package's)."""
        extra = {k: v for k, v in self.extra.items() if k not in ("tp_size", "fsdp_size")}
        extra.update({k: v for k, v in (("tp_size", tp), ("fsdp_size", fsdp)) if v > 1})
        return replace(self, extra=extra)

    def _tp_if(self, name: str, shape) -> int:
        tp = max(1, self.tp_size)
        return tp if tp_divides(name, shape, tp) else 1

    @property
    def tp_attn(self) -> int:
        """The tp ranks attention splits over: its heads (and the rules'
        qkv / attn-out dims) divide among them, else 1 (every rank computes
        every head)."""
        tp = self._tp_if("attn/c_proj/kernel", (self.d_model, self.d_model))
        return tp if self.n_head % tp == 0 and self._tp_if("attn/c_qkv/kernel", (self.d_model, 3 * self.d_model)) == tp \
            else 1

    @property
    def tp_mlp(self) -> int:
        return self._tp_if("mlp/c_fc/kernel", (self.d_model, self.ff_dim))

    @property
    def tp_vocab(self) -> int:
        """The tp ranks the vocabulary (embedding rows, LM head columns)
        splits over."""
        return self._tp_if("wte/embedding", (self.vocab_size, self.d_model))

    @property
    def tp_heads(self) -> int:
        """The tp ranks the value and Q heads' hidden width splits over."""
        return self._tp_if("v_head/layers_0/kernel", (self.d_model, 2 * self.d_model))

    @property
    def local_heads(self) -> int:
        """Attention heads this rank computes (and caches)."""
        return self.n_head // self.tp_attn

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw):
        return replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        if "attention_layers" in known:
            known["attention_layers"] = tuple(known["attention_layers"])
        return cls(**known)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rotary_inv_freq(rotary_dim: int, device, base: float = 10000.0) -> torch.Tensor:
    """The rotary inverse frequencies [rd/2], f32."""
    inv_freq = 1.0 / (base ** (np.arange(0, rotary_dim, 2) / rotary_dim))
    return torch.tensor(inv_freq, dtype=torch.float32, device=device)


def rotary_sincos(positions: torch.Tensor, inv_freq: torch.Tensor):
    """sin/cos tables for rotary positions. positions: [b, t] → [b, t, rd/2]."""
    freqs = positions[..., None].float() * inv_freq[None, None, :]
    return torch.sin(freqs), torch.cos(freqs)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, rotary_dim: int, neox_style: bool = False):
    """Rotate the first ``rotary_dim`` features of q or k [b, t, h, d]. GPT-J
    rotates interleaved (even, odd) pairs; NeoX rotates the two halves."""
    rot = x[..., :rotary_dim].float()
    rest = x[..., rotary_dim:]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    if neox_style:
        half = rotary_dim // 2
        x1, x2 = rot[..., :half], rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1 = rot[..., ::2]
        x2 = rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(rot.shape)
    if rotary_dim < x.shape[-1]:
        return torch.cat([out.to(x.dtype), rest], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Layers with the Flax parameter names
# ---------------------------------------------------------------------------


def frozen_copy(w: torch.Tensor, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``w`` in ``dtype`` when no gradient can flow to it (grad mode off, or
    a parameter that does not require grad), else None.

    The copy is made once and kept on ``w``. An in-place update of ``w``
    (an optimizer step, ``load_state_dict``, ``copy_``) bumps its
    ``_version``, and the next call (or ``refresh_weight_copies``) casts the
    new values INTO the same buffer, so the copy keeps its address: a CUDA
    graph that read it reads the new weights. It holds the same values as
    ``w.to(dtype)``, so outputs do not change. Where gradient flows, the
    caller keeps the differentiable per-call cast."""
    if w.dtype == dtype:
        return w
    if torch.is_grad_enabled() and w.requires_grad:
        return None
    if torch.is_inference_mode_enabled():
        return w.to(dtype)  # an inference tensor must not outlive the mode
    held = getattr(w, "_frozen_copy", None)
    if held is None or held[1].dtype != dtype or held[1].shape != w.shape:
        w._frozen_copy = None  # free a copy of another dtype or shape first
        w._frozen_copy = held = [None, torch.empty(w.shape, dtype=dtype, device=w.device)]
    _refresh(w, held)
    return held[1]


def _refresh(w: torch.Tensor, held: list):
    key = (w._version, w.data_ptr())
    if held[0] != key:
        held[1].copy_(w.detach())
        held[0] = key


def refresh_weight_copies(module: nn.Module) -> int:
    """Cast, in place, every stale ``frozen_copy`` of ``module``'s
    parameters (the frozen-branch tensors too while ``swapped_params`` has
    them in), gather again every stale fsdp or whole-parameter copy
    (``fsdp_weight``, ``full_weight``: collectives, in parameter order, so
    every rank issues the same ones), and re-quantize, in place, every stale
    int8 decode copy (``ops.w8a16.quantize_weights``). A replayed CUDA graph
    reads the copies without making them: call this before replaying one
    after the weights may have changed. Returns the number of copies
    refreshed."""
    n = 0
    for w in module.parameters():
        key = (w._version, w.data_ptr())
        held = getattr(w, "_frozen_copy", None)
        if held is not None and held[0] != key:
            _refresh(w, held)
            n += 1
        for attr, gather in (("_fsdp_copy", _gather_fsdp), ("_full_copy", _gather_full)):
            held = getattr(w, attr, None)
            if held is not None and held[0] != key:
                held[1].copy_(gather(w, held[1].dtype, held[2]))
                held[0] = key
                n += 1
    if any(getattr(m, "w8", None) is not None for m in module.modules()):
        n += quantize_weights(module)
    return n


# ---------------------------------------------------------------------------
# Sharded parameters: the compute copies of fsdp / tp pieces
# ---------------------------------------------------------------------------


def _coords():
    mesh = get_mesh()
    return mesh.group(AXIS_FSDP), mesh.group(AXIS_TP)


def _gather_fsdp(w: torch.Tensor, dtype: torch.dtype, dim: int) -> torch.Tensor:
    fsdp, _ = _coords()
    return coll.all_gather(w.detach().to(dtype), fsdp, dim)


def _gather_full(w: torch.Tensor, dtype: torch.dtype, pl: Placement) -> torch.Tensor:
    fsdp, tp = _coords()
    piece = w.detach().to(dtype)
    if pl.fsdp_dim is not None:
        piece = coll.all_gather(piece, fsdp, pl.fsdp_dim)
    if pl.tp_dim is None:
        return piece
    return pl.join_tp(coll.all_gather(piece, tp, pl.tp_dim).chunk(tp.size, dim=pl.tp_dim))


def _held(w: torch.Tensor, attr: str, dtype: torch.dtype, how, gather) -> torch.Tensor:
    """The gathered copy of ``w`` kept on it under ``attr``, gathered again
    (into the same buffer) when ``w`` changed."""
    if torch.is_inference_mode_enabled():
        return gather(w, dtype, how)
    key = (w._version, w.data_ptr())
    held = getattr(w, attr, None)
    if held is None or held[1].dtype != dtype:
        setattr(w, attr, None)
        held = [key, gather(w, dtype, how), how]
        setattr(w, attr, held)
    elif held[0] != key:
        held[1].copy_(gather(w, dtype, how))
        held[0] = key
    return held[1]


class _ShardGrad(torch.autograd.Function):
    """The gathered copy forward; backward, the gradient of the whole
    reduced to this rank's piece in f32: its tp piece (every tp rank holds
    the same gradient of replicated compute) then the sum over fsdp of its
    fsdp piece (each fsdp rank's rows contributed)."""

    @staticmethod
    def forward(ctx, w, copy, tp_piece, fsdp_dim):
        ctx.tp_piece, ctx.fsdp_dim, ctx.dtype = tp_piece, fsdp_dim, w.dtype
        return copy.detach()

    @staticmethod
    def backward(ctx, g):
        fsdp, tp = _coords()
        g = g.float()
        if ctx.tp_piece is not None:
            g = ctx.tp_piece(g, tp.rank)
        if ctx.fsdp_dim is not None:
            g = coll.reduce_scatter(g, fsdp, ctx.fsdp_dim)
        return g.to(ctx.dtype), None, None, None


def fsdp_weight(w: torch.Tensor, dtype: torch.dtype, dim: int) -> torch.Tensor:
    """This rank's fsdp piece ``w`` (split along ``dim``) as the whole over
    fsdp in ``dtype``: all-gathered once per weight version and held (the
    compute copy decode and every forward read; its address stays, so a
    captured decode graph reads new weights). Where gradient flows to ``w``
    the copy is differentiable: its gradient is reduce-scattered over fsdp
    in f32."""
    copy = _held(w, "_fsdp_copy", dtype, dim, _gather_fsdp)
    if torch.is_grad_enabled() and w.requires_grad:
        return _ShardGrad.apply(w, copy, None, dim)
    return copy


def full_weight(w: torch.Tensor, dtype: torch.dtype, pl: Placement) -> torch.Tensor:
    """The whole parameter (gathered over fsdp and tp by its placement) in
    ``dtype``, held per weight version: what replicated compute reads (the
    LM head, whose fused kernels need the whole vocabulary). Differentiable
    as ``fsdp_weight``, keeping this rank's tp piece of the gradient."""
    if pl.fsdp_dim is None and pl.tp_dim is None:
        return compute_weight(w, dtype)
    copy = _held(w, "_full_copy", dtype, pl, _gather_full)
    if torch.is_grad_enabled() and w.requires_grad:
        return _ShardGrad.apply(w, copy, pl.tp_piece if pl.tp_dim is not None else None, pl.fsdp_dim)
    return copy


class FullParam:
    """A sharded parameter as its whole, for the fused head's wrapper
    (``ops.fused_logprob``): ``shape``, ``copy(dtype)`` (the held whole, no
    gradient) and ``piece(g)`` (the whole's f32 gradient reduced to this
    rank's piece)."""

    def __init__(self, w: torch.Tensor, pl: Placement):
        self.w, self.pl = w, pl
        self.shape = pl.full_shape

    def copy(self, dtype: torch.dtype) -> torch.Tensor:
        with torch.no_grad():
            return full_weight(self.w, dtype, self.pl)

    def whole(self, dtype: torch.dtype) -> torch.Tensor:
        """The whole in ``dtype``, differentiable to the piece."""
        return full_weight(self.w, dtype, self.pl)

    def piece(self, g: torch.Tensor) -> torch.Tensor:
        fsdp, tp = _coords()
        g = g.float()
        if self.pl.tp_dim is not None:
            g = self.pl.tp_piece(g, tp.rank)
        if self.pl.fsdp_dim is not None:
            g = coll.reduce_scatter(g, fsdp, self.pl.fsdp_dim)
        return g.to(self.w.dtype)


def tp_group():
    return get_mesh().group(AXIS_TP)


@contextmanager
def decode_weights(module: nn.Module):
    """Within, every Dense of ``module`` that holds an int8 decode copy
    (``ops.w8a16.quantize_weights``) reads it instead of its kernel: the
    decode paths' counterpart of applying with the ``qw`` collection. A
    module without copies is unchanged."""
    held = [m for m in module.modules() if getattr(m, "w8", None) is not None]
    for m in held:
        m.w8_on = True
    try:
        yield module
    finally:
        for m in held:
            m.w8_on = False


def compute_weight(w: torch.Tensor, dtype: torch.dtype, fsdp_dim: Optional[int] = None) -> torch.Tensor:
    """``w`` cast to the compute dtype: the cached ``frozen_copy`` where no
    gradient flows to it, else the differentiable ``w.to(dtype)``; for an
    fsdp piece (``fsdp_dim``), its gathered ``fsdp_weight``."""
    if fsdp_dim is not None:
        return fsdp_weight(w, dtype, fsdp_dim)
    copy = frozen_copy(w, dtype)
    return w.to(dtype) if copy is None else copy


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)`` with kernel [in, out] stored in the param
    dtype and cast, like the input, to the compute dtype at use (once per
    weight version where no gradient flows to it: ``compute_weight``).
    On a sharded mesh the kernel is this rank's piece (``placement``: the
    whole's split by ``parallel.sharding``'s rules); ``in_features`` and
    ``features`` are the tp-local sizes the product computes, and
    ``kernel_fsdp`` the dim gathered over fsdp at use.

    ``w8`` ([key, int8 codes [in, out], f32 scales [out]]) is the int8 decode
    copy ``quantize_weights`` attaches; inside ``decode_weights`` the layer
    reads it through ``w8a16_matmul`` (QDense with ``qw``) and makes no
    compute-dtype copy of its kernel."""

    w8 = None
    w8_on = False
    kernel_fsdp = None

    def __init__(self, in_features: int, features: int, use_bias: bool, param_dtype, device, tp_split: bool = False,
                 qkv: bool = False):
        super().__init__()
        self.tp_split, self.qkv = tp_split, qkv
        self.placement = {}
        self.kernel = nn.Parameter(torch.empty((in_features, features), dtype=param_dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty((features,), dtype=param_dtype, device=device)) if use_bias else None
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype, add_bias: bool = True) -> torch.Tensor:
        if self.w8_on:
            return w8a16_matmul(x.to(dtype), self.w8[1], self.w8[2], self.bias if add_bias else None)
        y = x.to(dtype) @ compute_weight(self.kernel, dtype, self.kernel_fsdp)
        if add_bias and self.bias is not None:
            y = y + compute_weight(self.bias, dtype)
        return y

    def row_parallel(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A row-parallel product (its input dim split over tp): each rank's
        partial sum, summed over tp (Megatron's g), then the bias once."""
        if not self.tp_split:
            return self(x, dtype)
        y = coll.reduce_from(self(x, dtype, add_bias=False), tp_group())
        if self.bias is not None:
            y = y + compute_weight(self.bias, dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm with statistics in f32, output in the compute dtype."""

    def __init__(self, features: int, eps: float, param_dtype, device):
        super().__init__()
        self.eps = eps
        self.placement = {}
        self.scale = nn.Parameter(torch.empty((features,), dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty((features,), dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(), self.bias.float(), self.eps)
        return y.to(dtype)


class Embed(nn.Module):
    """A lookup table [num, features]. On a sharded mesh it is this rank's
    piece: ``fsdp_dim`` gathered at use, and with ``tp_split`` the
    vocabulary's rows over tp: each rank looks up the rows it owns, writes
    zero elsewhere, and the tp group sums (exact: one nonzero term per
    token, as the JAX package's ``onehot_embed``)."""

    fsdp_dim = None

    def __init__(self, num: int, features: int, param_dtype, device, tp_split: bool = False):
        super().__init__()
        self.tp_split = tp_split
        self.placement = {}
        self.embedding = nn.Parameter(torch.empty((num, features), dtype=param_dtype, device=device))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ids = ids.long()
        if self.fsdp_dim is None and not self.tp_split:
            # Gather, then cast: the same values as casting the table first.
            return self.embedding[ids].to(dtype)
        table = compute_weight(self.embedding, dtype, self.fsdp_dim)
        if not self.tp_split:
            return table[ids]
        tp = tp_group()
        n = table.shape[0]
        local = ids - tp.rank * n
        own = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)] * own[..., None].to(dtype)
        return coll.reduce_from(rows, tp)


def ring_eligible(cfg: LMConfig, q_len: int, has_cache: bool) -> bool:
    """Sequence-parallel ring attention applies to full-sequence passes of a
    model built for an sp > 1 mesh whose shapes divide the mesh: sequence
    over sp, heads over tp (the batch is this data rank's rows already).
    Decode and prefill with a cache stay local (the JAX package's rule)."""
    if cfg.sp_size <= 1 or has_cache or q_len % cfg.sp_size:
        return False
    mesh = get_mesh()
    if mesh.shape[AXIS_SP] != cfg.sp_size:
        raise ValueError(f"the model was built for sp = {cfg.sp_size}, the mesh has {mesh.shape}")
    return cfg.n_head % mesh.shape[AXIS_TP] == 0


def flash_eligible(cfg: LMConfig, q_len: int, has_cache: bool, prefill_at_zero: bool, kernel_device: bool) -> bool:
    """Static routing between the flash kernel and the einsum path (the JAX
    package's rule). Flash applies to full-sequence passes and to prefill at
    cache index 0, where every cache slot past the prompt is still invalid,
    so attention over the local block is exact. ``kernel_device`` is "a CUDA
    device with bf16 compute": "auto" needs it and a long aligned sequence;
    "flash" forces the kernel path (its plain version on the CPU)."""
    if cfg.attn_impl == "xla":
        return False
    if has_cache and not (q_len > 1 and prefill_at_zero):
        return False
    if cfg.attn_impl == "auto":
        return kernel_device and auto_flash_ok(q_len)
    return True


class Attention(nn.Module):
    """Multi-head causal attention with an in-place KV cache. Under tp
    (``cfg.tp_attn`` > 1) Megatron's layout: qkv column-parallel (each rank
    its heads' columns of q, k and v), the rank's ``cfg.local_heads`` heads
    attended (and cached) locally, attn-out row-parallel with one all-reduce.
    The kernel gates read the MODEL's head count, as the JAX package routes
    on its unsharded config."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.params_dtype
        split = cfg.tp_attn > 1
        d = cfg.d_model // cfg.tp_attn
        if cfg.fused_qkv:
            self.c_qkv = Dense(cfg.d_model, 3 * d, cfg.qkv_bias, pd, device, tp_split=split, qkv=True)
        else:
            self.q_proj = Dense(cfg.d_model, d, cfg.qkv_bias, pd, device, tp_split=split)
            self.k_proj = Dense(cfg.d_model, d, cfg.qkv_bias, pd, device, tp_split=split)
            self.v_proj = Dense(cfg.d_model, d, cfg.qkv_bias, pd, device, tp_split=split)
        self.c_proj = Dense(d, cfg.d_model, cfg.out_bias, pd, device, tp_split=split)
        if cfg.pos_type == "rotary":
            # Made once on the device (not per step), so a captured decode
            # step copies nothing from the host; not part of the state dict.
            self.register_buffer("inv_freq", rotary_inv_freq(cfg.rotary_dim or cfg.head_dim, device),
                                 persistent=False)

    def forward(self, x, attn_bias, positions, cache=None, cache_index=None, flash_mask=None, window=0,
                block_tables=None, ring=False):
        cfg = self.cfg
        dtype = cfg.compute_dtype
        b, q_len, _ = x.shape
        hd = cfg.head_dim
        h = cfg.local_heads
        if cfg.tp_attn > 1:
            x = coll.copy_to(x, tp_group())
        if cfg.fused_qkv:
            q, k, v = self.c_qkv(x, dtype).split(h * hd, dim=-1)
        else:
            q, k, v = self.q_proj(x, dtype), self.k_proj(x, dtype), self.v_proj(x, dtype)
        q = q.reshape(b, q_len, h, hd)
        k = k.reshape(b, q_len, h, hd)
        v = v.reshape(b, q_len, h, hd)
        if cfg.pos_type == "rotary":
            rd = cfg.rotary_dim or hd
            sin, cos = rotary_sincos(positions, self.inv_freq)
            neox = cfg.extra.get("neox_rotary", False)
            q = apply_rotary(q, sin, cos, rd, neox)
            k = apply_rotary(k, sin, cos, rd, neox)

        new_cache = None
        decode_kv = None  # (k, v, ks, vs) of a single-token step that takes a decode kernel
        if cache is not None:
            write, gather_virt = cache_ops(cache[0], b, q_len, cache_index, block_tables)
            single_step = q_len == 1 and attn_bias is not None
            if block_tables is not None:
                shape_ok = paged_decode_eligible(cfg.n_head, hd, cache[0].shape[1], block_tables.shape[1],
                                                 cfg.kv_cache_quant)
            else:
                shape_ok = decode_attn_eligible(cfg.n_head, hd)
            kernel_ok = single_step and x.device.type == "cuda" and dtype == torch.bfloat16 and shape_ok
            if cfg.kv_cache_quant:
                k_cache, v_cache, ks_cache, vs_cache = cache
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                for buf, upd in ((k_cache, kq), (v_cache, vq), (ks_cache, ks), (vs_cache, vs)):
                    write(buf, upd)
                new_cache = (k_cache, v_cache, ks_cache, vs_cache)
                if flash_mask is None:
                    if kernel_ok:
                        # The kernel reads the int8 cache and folds the
                        # scales into the attention algebra in f32.
                        decode_kv = new_cache
                    else:
                        # Dequantise on read in the compute dtype (paged:
                        # gather the virtual view first), as the JAX einsum
                        # path does. Flash prefill keeps the local k/v.
                        k = gather_virt(k_cache).to(dtype) * gather_virt(ks_cache)[..., None].to(dtype)
                        v = gather_virt(v_cache).to(dtype) * gather_virt(vs_cache)[..., None].to(dtype)
            else:
                k_cache, v_cache = cache
                write(k_cache, k)
                write(v_cache, v)
                new_cache = (k_cache, v_cache)
                if flash_mask is None:
                    if kernel_ok:
                        decode_kv = (k_cache, v_cache, None, None)
                    else:
                        k, v = gather_virt(k_cache), gather_virt(v_cache)

        scale = 1.0 / np.sqrt(hd) if cfg.scale_attn else 1.0
        if flash_mask is not None:
            attend = ring_attention_sharded if ring else flash_attention
            out = attend(q, k, v, flash_mask, scale=scale, causal=True, window=window).to(dtype)
        elif decode_kv is not None:
            # The single-token step's bias row carries causality, validity
            # and any window at once.
            kc, vc, ksc, vsc = decode_kv
            bias_row = attn_bias[:, 0, 0, :]
            if block_tables is not None:
                out = paged_decode_attention(q[:, 0], kc, vc, block_tables, bias_row, scale=scale, ks=ksc, vs=vsc)
            else:
                out = decode_attention(q[:, 0], kc, vc, bias_row, scale=scale, ks=ksc, vs=vsc)
            out = out.to(dtype)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
            scores = scores + attn_bias
            probs = torch.softmax(scores, dim=-1).to(dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))
        out = out.reshape(b, q_len, h * hd)
        return self.c_proj.row_parallel(out, dtype), new_cache


class MLP(nn.Module):
    """Dense → activation → Dense; under tp (``cfg.tp_mlp`` > 1) mlp-up
    column-parallel and mlp-down row-parallel with one all-reduce."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.params_dtype
        split = cfg.tp_mlp > 1
        ff = cfg.ff_dim // cfg.tp_mlp
        self.c_fc = Dense(cfg.d_model, ff, True, pd, device, tp_split=split)
        self.c_proj = Dense(ff, cfg.d_model, True, pd, device, tp_split=split)

    def forward(self, x):
        cfg = self.cfg
        if cfg.tp_mlp > 1:
            x = coll.copy_to(x, tp_group())
        h = self.c_fc(x, cfg.compute_dtype)
        if cfg.activation == "gelu_new":
            h = F.gelu(h, approximate="tanh")
        elif cfg.activation == "gelu":
            h = F.gelu(h)
        elif cfg.activation == "relu":
            h = F.relu(h)
        else:
            raise ValueError(f"unknown activation {cfg.activation}")
        return self.c_proj.row_parallel(h, cfg.compute_dtype)


class Block(nn.Module):
    """One transformer block; sequential (gpt2) or parallel (gptj/neox) residual."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm(cfg.d_model, cfg.ln_eps, cfg.params_dtype, device)
        self.attn = Attention(cfg, device)
        if not cfg.parallel_residual or cfg.use_parallel_ln:
            self.ln_2 = LayerNorm(cfg.d_model, cfg.ln_eps, cfg.params_dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, attn_bias, positions, cache=None, cache_index=None, flash_mask=None, window=0,
                block_tables=None, ring=False):
        cfg = self.cfg
        dtype = cfg.compute_dtype
        if cfg.parallel_residual:
            h = self.ln_1(x, dtype)
            attn_out, new_cache = self.attn(h, attn_bias, positions, cache, cache_index, flash_mask, window,
                                            block_tables, ring)
            mlp_in = self.ln_2(x, dtype) if cfg.use_parallel_ln else h
            x = x + attn_out + self.mlp(mlp_in)
        else:
            attn_out, new_cache = self.attn(self.ln_1(x, dtype), attn_bias, positions, cache, cache_index,
                                            flash_mask, window, block_tables, ring)
            x = x + attn_out
            x = x + self.mlp(self.ln_2(x, dtype))
        return x, new_cache


def make_attn_bias(attn_mask_kv: torch.Tensor, q_len: int, q_offset, window: int = 0,
                   segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive attention bias [b, 1, q_len, kv_len]: key j is visible to
    query i iff its slot is valid and j <= q_offset + i (and, with a window,
    j > q_offset + i − window); 0 where visible, −1e9 elsewhere. A [b]
    tensor ``q_offset`` gives every row its own causal frontier.
    ``segment_ids`` [b, q_len] (full-sequence passes, q_len == kv_len) also
    hides every key of another packed segment."""
    kv_len = attn_mask_kv.shape[-1]
    device = attn_mask_kv.device
    k_idx = torch.arange(kv_len, device=device)
    if is_vector_index(q_offset):
        q_idx = q_offset.long()[:, None, None] + torch.arange(q_len, device=device)[None, :, None]  # [b, q, 1]
        k_idx = k_idx[None, None, :]
    else:
        q_idx = q_offset + torch.arange(q_len, device=device)[:, None]
        k_idx = k_idx[None, :]
    causal = k_idx <= q_idx
    if window > 0:
        causal = causal & (k_idx > q_idx - window)
    causal = causal[:, None] if causal.ndim == 3 else causal[None, None]
    valid = attn_mask_kv.bool()[:, None, None, :] & causal
    if segment_ids is not None:
        valid = valid & (segment_ids[:, None, None, :] == segment_ids[:, None, :, None])
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(valid, zero, torch.full((), -1e9, dtype=torch.float32, device=device))


class TransformerLM(nn.Module):
    """Embeddings + N blocks + final LN (+ untied head), and with
    ``n_soft_tokens`` the learned prefix ``soft_prompt``.

    ``start_layer=k`` with ``inputs_embeds`` = the hidden states entering
    block k replays blocks [k..N) + ln_f + head: the hydra reference branch.
    Parameters live on ``device``: CUDA unless the caller names another
    (raises where there is no CUDA device).
    """

    soft_fsdp = None

    def __init__(self, cfg: LMConfig, device=None, place: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.placement = {}  # the soft prompt's, on a sharded mesh
        pd = cfg.params_dtype
        vocab_split = cfg.tp_vocab > 1
        self.wte = Embed(cfg.vocab_size // cfg.tp_vocab, cfg.d_model, pd, device, tp_split=vocab_split)
        if cfg.pos_type == "learned":
            self.wpe = Embed(cfg.max_position, cfg.d_model, pd, device)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, device))
        self.ln_f = LayerNorm(cfg.d_model, cfg.ln_eps, pd, device)
        if not cfg.tie_word_embeddings:
            # Stored split by the rules; computed whole (``head``).
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size // cfg.tp_vocab, cfg.extra.get("lm_head_bias", False),
                                 pd, device, tp_split=vocab_split)
        if cfg.n_soft_tokens > 0:
            self.soft_prompt = nn.Parameter(torch.empty((cfg.n_soft_tokens, cfg.d_model), dtype=pd, device=device))
        if place:
            place_model(self)

    def head(self) -> Tuple[torch.Tensor, Optional[torch.Tensor], bool, Optional["FullParam"], Optional["FullParam"]]:
        """The LM head as (weight, bias, tied, whole weight, whole bias):
        the tied embedding or the untied kernel; on a sharded mesh the
        pieces and their ``FullParam`` wholes (else None)."""
        if self.cfg.tie_word_embeddings:
            w, b, tied, mod = self.wte.embedding, None, True, self.wte
            pw, pb = mod.placement.get("embedding"), None
        else:
            mod = self.lm_head
            w, b, tied = mod.kernel, mod.bias, False
            pw, pb = mod.placement.get("kernel"), mod.placement.get("bias")
        if pw is None:
            return w, b, tied, None, None
        return w, b, tied, FullParam(w, pw), (None if b is None else FullParam(b, pb))

    def block(self, i: int) -> Block:
        return getattr(self, f"h_{i}")

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        cache: Optional[Tuple] = None,
        cache_index=None,
        cache_mask: Optional[torch.Tensor] = None,
        block_tables: Optional[torch.Tensor] = None,
        start_layer: int = 0,
        stop_layer: Optional[int] = None,
        collect_hidden_at: Optional[int] = None,
        compute_logits: bool = True,
        logits_start: int = 0,
        labels: Optional[torch.Tensor] = None,
        labels_mask: Optional[torch.Tensor] = None,
        prepend_soft: bool = True,
        segment_ids: Optional[torch.Tensor] = None,
    ):
        """Returns dict(logits, hidden, branch_hidden, cache, logprobs, lse,
        entropy), as the JAX module does.

        - Full-sequence / prefill: attention over the q_len itself.
        - Decode: ``cache`` (per-layer leaves, see ``init_cache``),
          ``cache_mask`` [b, kv_len] valid key slots, ``cache_index`` the
          write offset: an int, or a [b] tensor of per-row offsets.
        - Paged: ``block_tables`` [b, bps] switches the cache leaves to the
          shared pool (``init_paged_cache``); ``cache_mask`` and
          ``cache_index`` address each row's virtual cache of bps * bs keys.
        - ``collect_hidden_at=k`` also returns the hidden state entering
          block k (the hydra branch point).
        - ``labels`` [b, S] switches the head to fused-logprob mode: f32
          ``logprobs``/``lse``/``entropy`` [b, S] at positions
          logits_start.. instead of logits (``extra['fused_logprob']`` ∈
          auto|force|off); ``labels_mask`` zeros masked rows.
        - Soft prompt (``n_soft_tokens``, ``start_layer`` 0): the prefix is
          prepended ahead of the left-padded sequence, its mask ones and
          its positions 0..n_soft-1 (the tokens' shifted by n_soft), and the
          outputs are sliced back to the caller's length. With a cache, the
          caller's ``cache_mask`` and ``cache_index`` are in cache space
          (the prefix in rows [0, n_soft)). ``prepend_soft=False`` on
          decode and verify steps: the prefix is in the cache already.
        - ``segment_ids`` [b, q_len] (packed train batches, no cache, with
          per-segment ``position_ids``): attention is block-diagonal per
          segment, on the einsum path.
        """
        cfg = self.cfg
        if segment_ids is not None and (cache is not None or cfg.n_soft_tokens):
            raise ValueError("segment packing is a full-sequence train-batch layout: no cache, no soft prompt")
        dtype = cfg.compute_dtype
        stop_layer = cfg.n_layer if stop_layer is None else stop_layer
        vector_index = is_vector_index(cache_index)
        if cache_index is not None and not vector_index:
            cache_index = int(cache_index)

        if inputs_embeds is None:
            x = self.wte(input_ids, dtype)
        else:
            x = inputs_embeds.to(dtype)
        b, q_len = x.shape[:2]
        device = x.device
        if attention_mask is None:
            attention_mask = torch.ones((b, q_len), dtype=torch.int32, device=device)

        n_soft = cfg.n_soft_tokens if (cfg.n_soft_tokens > 0 and start_layer == 0 and prepend_soft) else 0
        if n_soft:
            soft = compute_weight(self.soft_prompt, dtype, self.soft_fsdp)
            x = torch.cat([soft[None].expand(b, -1, -1), x], dim=1)
            attention_mask = torch.cat(
                [torch.ones((b, n_soft), dtype=attention_mask.dtype, device=device), attention_mask], dim=1)
            if position_ids is not None:
                position_ids = torch.cat(
                    [torch.arange(n_soft, device=device)[None].expand(b, -1), position_ids + n_soft], dim=1)
            q_len += n_soft

        if position_ids is None:
            if cache is not None and cache_mask is not None:
                # Decode: absolute positions from the cache occupancy mask,
                # read at the write offset.
                full_pos = torch.clamp(torch.cumsum(cache_mask, dim=-1) - 1, min=0)
                if vector_index:
                    # Per-row offsets: positions offset..offset+q_len-1 of
                    # each row, clamped so rows near the end gather in bounds
                    # (their extra slots are masked).
                    ix = cache_index.long()[:, None] + torch.arange(q_len, device=device)[None, :]
                    position_ids = torch.gather(full_pos, 1, torch.clamp(ix, max=full_pos.shape[1] - 1))
                else:
                    position_ids = full_pos[:, cache_index : cache_index + q_len]
            else:
                # Left-pad aware positions: cumsum over valid tokens.
                position_ids = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)

        if start_layer == 0 and cfg.pos_type == "learned":
            x = x + self.wpe(position_ids, dtype)
        if start_layer == 0:
            # graftnum's probe tap: x itself unless the NaN-provenance
            # bisector's eager re-forward is live on this thread.
            x = probe_tap("embed", x)

        # Flash prefill needs a STATIC zero write offset (a vector offset,
        # as the paged suffix prefill passes, takes the einsum path).
        prefill_at_zero = cache is not None and not vector_index and cache_index == 0
        kernel_device = device.type == "cuda" and dtype == torch.bfloat16
        use_ring = ring_eligible(cfg, q_len, cache is not None)
        use_flash = use_ring or flash_eligible(cfg, q_len, cache is not None, prefill_at_zero, kernel_device)
        if segment_ids is not None:
            # The flash and ring kernels' masks (causal x key validity)
            # cannot express segments.
            use_ring = use_flash = False
        attn_bias = local_bias = flash_mask = None
        if use_flash:
            flash_mask = attention_mask.float()
        else:
            if cache is not None:
                kv_mask = cache_mask if cache_mask is not None else attention_mask
                bias_mask, bias_offset = kv_mask, cache_index
            else:
                bias_mask, bias_offset = attention_mask, 0
            attn_bias = make_attn_bias(bias_mask, q_len, bias_offset, segment_ids=segment_ids)
            if any(t == "local" for t in cfg.attention_layers):
                local_bias = make_attn_bias(bias_mask, q_len, bias_offset, window=cfg.window_size,
                                            segment_ids=segment_ids)

        branch_hidden = None
        new_cache = [] if cache is not None else None
        # remat: under grad, each block keeps only its input (policy "full")
        # and, with "dots", its weight products' outputs, and recomputes the
        # rest in the backward, as the JAX package's nn.remat does. Cache
        # passes run without grad, so the rollout path is unchanged. Under
        # the ring the recompute re-issues the block's collectives, so it
        # always runs the whole block on every rank (no early stop at the
        # last saved tensor).
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        remat_kw = {"context_fn": _save_dots_context} if cfg.remat_policy == "dots" else {}
        for i in range(start_layer, stop_layer):
            if collect_hidden_at is not None and i == collect_hidden_at:
                branch_hidden = x
            is_local = bool(cfg.attention_layers) and cfg.attention_layers[i] == "local"
            args = (
                x,
                local_bias if is_local else attn_bias,
                position_ids,
                cache[i] if cache is not None else None,
                cache_index,
                flash_mask,
                cfg.window_size if is_local else 0,
                block_tables,
                use_ring,
            )
            if remat:
                with set_checkpoint_early_stop(not use_ring):
                    x, layer_cache = checkpoint(self.block(i), *args, use_reentrant=False, **remat_kw)
            else:
                x, layer_cache = self.block(i)(*args)
            x = probe_tap(f"block_{i}", x)
            if cache is not None:
                new_cache.append(layer_cache)

        x = self.ln_f(x, dtype)
        x = probe_tap("ln_f", x)
        if collect_hidden_at is not None and collect_hidden_at == cfg.n_layer:
            branch_hidden = x
        if n_soft:
            # Callers see their own length; a hydra branch cannot replay a
            # prefix, so soft-prompt models have none (``heads``).
            x = x[:, n_soft:]
            if branch_hidden is not None:
                branch_hidden = branch_hidden[:, n_soft:]

        logits = logprobs = lse = entropy = None
        w_head, b_head, tied, full_w, full_b = self.head()
        if labels is not None:
            S = labels.shape[1]
            x_head = x[:, logits_start:][:, :S]
            if full_w is None:
                # A head no gradient reaches goes in as its cached bf16 copy
                # (the same values as the per-tile cast); a trained one as
                # the f32 master, so its gradient stays f32.
                w_frozen = frozen_copy(w_head, dtype)
                w_head = w_head if w_frozen is None else w_frozen
            logprobs, lse, entropy = routed_logprob(
                x_head, w_head, labels, b_head, tied=tied,
                mode=cfg.extra.get("fused_logprob", "auto"), mask=labels_mask, whole=(full_w, full_b),
            )
        elif compute_logits:
            x_head = x[:, logits_start:] if logits_start else x
            if full_w is not None and not tied and self.lm_head.w8_on:
                # Sharded, int8 decode weights: the head's whole int8 copy.
                bias = None if b_head is None else full_weight(b_head, dtype, full_b.pl)
                logits = w8a16_matmul(x_head.to(dtype), self.lm_head.w8[1], self.lm_head.w8[2], bias)
            elif full_w is not None:
                # Sharded: every rank computes the whole vocabulary from the
                # gathered head (its gradient keeps this rank's piece).
                w = full_weight(w_head, dtype, full_w.pl)
                logits = x_head.to(dtype) @ (w.t() if tied else w)
                if b_head is not None:
                    logits = logits + full_weight(b_head, dtype, full_b.pl)
            elif tied:
                logits = x_head.to(dtype) @ compute_weight(self.wte.embedding, dtype).t()
            else:
                logits = self.lm_head(x_head, dtype)

        return {
            "logits": logits,
            "hidden": x,
            "branch_hidden": branch_hidden,
            "cache": tuple(new_cache) if new_cache is not None else None,
            "logprobs": logprobs,
            "lse": lse,
            "entropy": entropy,
        }


# The products with no batch dimension: x [.., d] @ kernel [d, o] lowers to
# mm / addmm (attention's batched einsums lower to bmm and are recomputed).
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


_save_dots_context = partial(create_selective_checkpoint_contexts, _save_dots)


def is_vector_index(cache_index) -> bool:
    """A [b] tensor of per-row write offsets (else an int for the batch)."""
    return torch.is_tensor(cache_index) and cache_index.ndim == 1


def cache_ops(leaf, b: int, q_len: int, cache_index, block_tables=None):
    """(write(buf, upd), gather_virt(buf)) for one layer's cache leaves, of
    which ``leaf`` is the first. ``write`` stores this step's [b, q_len, ...]
    update IN PLACE; ``gather_virt`` returns the [b, kv_len, ...] virtual
    view the einsum path attends over.

    - Paged: rows write at (physical block, in-block offset) of their
      virtual positions, clamped to the last virtual key (dead rows' writes
      land on their own masked columns; the engine points dead rows at the
      trash block 0). Dead rows may collide on the same pool entry; which
      write wins is arbitrary, and harmless because those entries are
      masked.
    - Vector offset: each row writes at its own offset, the start clamped
      so the update fits (``dynamic_update_slice``'s rule).
    - Int offset: one slice write for the batch."""
    device = leaf.device
    if block_tables is not None:
        blk = leaf.shape[1]
        tables = block_tables.long()
        t_virt = tables.shape[1] * blk
        if is_vector_index(cache_index):
            base = cache_index.long()[:, None]
        else:
            base = torch.full((b, 1), int(cache_index), dtype=torch.long, device=device)
        voff = torch.clamp(base + torch.arange(q_len, device=device)[None, :], max=t_virt - 1)
        phys = torch.gather(tables, 1, voff // blk)
        off = voff % blk

        def write(pool, upd):
            pool[phys, off] = upd.to(pool.dtype)

        return write, lambda pool: gather_pool(pool, tables)

    if is_vector_index(cache_index):
        start = torch.clamp(cache_index.long(), min=0, max=max(leaf.shape[1] - q_len, 0))
        cols = start[:, None] + torch.arange(q_len, device=device)[None, :]
        rows = torch.arange(b, device=device)[:, None]

        def write(buf, upd):
            buf[rows, cols] = upd.to(buf.dtype)

    else:
        i = int(cache_index)

        def write(buf, upd):
            buf[:, i : i + q_len] = upd.to(buf.dtype)

    return write, lambda buf: buf


def quantize_kv(x: torch.Tensor):
    """[b, t, h, d] → (int8 values, [b, t, h] f32 absmax scales): round half
    to even and clip at ±127, the JAX package's codes bit for bit."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _cache_leaves(cfg: LMConfig, lead: Tuple[int, int], device, dtype):
    """Zeroed per-layer leaves over the leading dims ``lead``: (k, v), or
    (k_i8, v_i8, k_scale, v_scale) with unit scales under kv_cache_quant;
    this rank's heads (``cfg.local_heads``) under tp."""
    shape = lead + (cfg.local_heads, cfg.head_dim)
    if cfg.kv_cache_quant:
        if dtype is not None:
            raise ValueError("kv_cache_quant caches are int8; a dtype is not honoured")
        return tuple(
            (
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(shape[:3], dtype=torch.float32, device=device),
                torch.ones(shape[:3], dtype=torch.float32, device=device),
            )
            for _ in range(cfg.n_layer)
        )
    dtype = dtype or cfg.compute_dtype
    return tuple(
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_layer)
    )


def init_cache(cfg: LMConfig, batch: int, max_len: int, device, dtype=None):
    """Allocate an empty KV cache: per-layer (k, v) [b, T, local heads, hd], or
    (k_i8, v_i8, k_scale, v_scale) with kv_cache_quant."""
    return _cache_leaves(cfg, (batch, max_len), device, dtype)


def init_paged_cache(cfg: LMConfig, n_blocks: int, block_size: int, device, dtype=None):
    """Allocate the shared paged KV pool: per-layer leaves over
    [n_blocks, block_size, n_head, hd], the paged twin of ``init_cache``.
    Zeros with unit scales, never ``torch.empty``: freed blocks are never
    scrubbed and the trash block 0 absorbs dead rows' writes, and masked
    keys are still read and weighted by an exact zero, which stays zero
    only if what it weighs is finite."""
    return _cache_leaves(cfg, (n_blocks, block_size), device, dtype)


# ---------------------------------------------------------------------------
# Placement on a sharded mesh
# ---------------------------------------------------------------------------


def _sharded_leaves(module: nn.Module):
    """(qualified name, owning module, attribute, parameter) of every
    parameter of ``module``, in ``named_parameters`` order."""
    for name, p in module.named_parameters():
        mod_name, _, attr = name.rpartition(".")
        yield name, module.get_submodule(mod_name) if mod_name else module, attr, p


def place_model(module: nn.Module):
    """Split ``module``'s parameters over the mesh (its config's
    ``fsdp_size`` and ``tp_size``) by ``parallel.sharding``'s rules: each
    module built its tp-local shapes; here every parameter gets its
    ``Placement`` (on its module's ``placement`` dict: ``placement_of``)
    and, where fsdp splits it, becomes this rank's fsdp
    piece (uninitialised: ``hf_import.init_params`` and the loaders fill
    the pieces from whole tensors). A no-op on an unsharded mesh."""
    cfg = module.cfg
    fsdp, tp = max(1, cfg.fsdp_size), max(1, cfg.tp_size)
    if fsdp == 1 and tp == 1:
        return module
    sizes = {AXIS_FSDP: fsdp, AXIS_TP: tp}
    for name, mod, attr, p in _sharded_leaves(module):
        split = tp > 1 and bool(getattr(mod, "tp_split", False))
        full = list(p.shape)
        spec = match_rule(name)
        rule_tp = spec.index(AXIS_TP) if AXIS_TP in spec else None
        if split and rule_tp is not None:
            full[rule_tp] *= tp
        pl = placement(name, full, sizes, tp_split=split, qkv=bool(getattr(mod, "qkv", False)))
        if split and rule_tp is not None and pl.tp_dim != rule_tp:
            raise ValueError(f"{name}: its module splits over tp but the rules replicate it")
        if pl.fsdp_dim is not None:
            piece = nn.Parameter(torch.empty(pl.local_shape, dtype=p.dtype, device=p.device),
                                 requires_grad=p.requires_grad)
            setattr(mod, attr, piece)
        if isinstance(mod, Dense) and attr == "kernel":
            mod.kernel_fsdp = pl.fsdp_dim
        elif isinstance(mod, Embed):
            mod.fsdp_dim = pl.fsdp_dim
        elif attr == "soft_prompt":
            mod.soft_fsdp = pl.fsdp_dim
        elif pl.fsdp_dim is not None:
            raise ValueError(f"{name}: split over fsdp, but its module reads it whole")
        mod.placement[attr] = pl
    return module


def placement_of(module: nn.Module, name: str) -> Optional[Placement]:
    """The ``Placement`` of parameter ``name`` (relative to ``module``), or
    None where it is not split."""
    mod_name, _, attr = name.rpartition(".")
    sub = module.get_submodule(mod_name) if mod_name else module
    return getattr(sub, "placement", {}).get(attr)


def mesh_coords():
    """(fsdp rank, tp rank) of this process on the current mesh."""
    mesh = peek_mesh()
    if mesh is None:
        return 0, 0
    return mesh.coords[AXIS_FSDP], mesh.coords[AXIS_TP]


def shard_tensor(module: nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the whole tensor ``full`` of parameter ``name``
    (``full`` itself where it is not split)."""
    pl = placement_of(module, name)
    return full if pl is None else pl.shard(full, *mesh_coords())


def gather_tensor(module: nn.Module, name: str, piece: torch.Tensor) -> torch.Tensor:
    """The whole of parameter ``name`` from every rank's piece (a
    collective over fsdp and tp; ``piece`` itself where it is not split)."""
    pl = placement_of(module, name)
    return piece if pl is None else _gather_full(piece, piece.dtype, pl)
