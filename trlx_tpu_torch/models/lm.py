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

Attention routes through three paths, by the JAX package's static rules:

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

``remat`` with policy "full" checkpoints every block under grad; policy
"dots" raises. Not in this slice: ring attention and packed segments; the
config fields exist and raise when set.
"""

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from trlx_tpu_torch.device import resolve_device, torch_dtype
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
        if self.sp_size > 1:
            raise NotImplementedError("ring attention (sp_size > 1) is not ported yet")
        if self.remat and self.remat_policy == "dots":
            raise NotImplementedError("remat_policy='dots' is not ported yet")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff else 4 * self.d_model

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
    them in), and re-quantize, in place, every stale int8 decode copy
    (``ops.w8a16.quantize_weights``). A replayed CUDA graph reads the copies
    without making them: call this before replaying one after the weights
    may have changed. Returns the number of copies refreshed."""
    n = 0
    for w in module.parameters():
        held = getattr(w, "_frozen_copy", None)
        if held is not None and held[0] != (w._version, w.data_ptr()):
            _refresh(w, held)
            n += 1
    if any(getattr(m, "w8", None) is not None for m in module.modules()):
        n += quantize_weights(module)
    return n


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


def compute_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` cast to the compute dtype: the cached ``frozen_copy`` where no
    gradient flows to it, else the differentiable ``w.to(dtype)``."""
    copy = frozen_copy(w, dtype)
    return w.to(dtype) if copy is None else copy


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)`` with kernel [in, out] stored in the param
    dtype and cast, like the input, to the compute dtype at use (once per
    weight version where no gradient flows to it: ``compute_weight``).

    ``w8`` ([key, int8 codes [in, out], f32 scales [out]]) is the int8 decode
    copy ``quantize_weights`` attaches; inside ``decode_weights`` the layer
    reads it through ``w8a16_matmul`` (QDense with ``qw``) and makes no
    compute-dtype copy of its kernel."""

    w8 = None
    w8_on = False

    def __init__(self, in_features: int, features: int, use_bias: bool, param_dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((in_features, features), dtype=param_dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty((features,), dtype=param_dtype, device=device)) if use_bias else None
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.w8_on:
            return w8a16_matmul(x.to(dtype), self.w8[1], self.w8[2], self.bias)
        y = x.to(dtype) @ compute_weight(self.kernel, dtype)
        if self.bias is not None:
            y = y + compute_weight(self.bias, dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm with statistics in f32, output in the compute dtype."""

    def __init__(self, features: int, eps: float, param_dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty((features,), dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty((features,), dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(), self.bias.float(), self.eps)
        return y.to(dtype)


class Embed(nn.Module):
    def __init__(self, num: int, features: int, param_dtype, device):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty((num, features), dtype=param_dtype, device=device))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # Gather, then cast: the same values as casting the table first.
        return self.embedding[ids.long()].to(dtype)


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
    """Multi-head causal attention with an in-place KV cache."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.params_dtype
        if cfg.fused_qkv:
            self.c_qkv = Dense(cfg.d_model, 3 * cfg.d_model, cfg.qkv_bias, pd, device)
        else:
            self.q_proj = Dense(cfg.d_model, cfg.d_model, cfg.qkv_bias, pd, device)
            self.k_proj = Dense(cfg.d_model, cfg.d_model, cfg.qkv_bias, pd, device)
            self.v_proj = Dense(cfg.d_model, cfg.d_model, cfg.qkv_bias, pd, device)
        self.c_proj = Dense(cfg.d_model, cfg.d_model, cfg.out_bias, pd, device)
        if cfg.pos_type == "rotary":
            # Made once on the device (not per step), so a captured decode
            # step copies nothing from the host; not part of the state dict.
            self.register_buffer("inv_freq", rotary_inv_freq(cfg.rotary_dim or cfg.head_dim, device),
                                 persistent=False)

    def forward(self, x, attn_bias, positions, cache=None, cache_index=None, flash_mask=None, window=0,
                block_tables=None):
        cfg = self.cfg
        dtype = cfg.compute_dtype
        b, q_len, _ = x.shape
        hd = cfg.head_dim
        if cfg.fused_qkv:
            q, k, v = self.c_qkv(x, dtype).split(cfg.d_model, dim=-1)
        else:
            q, k, v = self.q_proj(x, dtype), self.k_proj(x, dtype), self.v_proj(x, dtype)
        q = q.reshape(b, q_len, cfg.n_head, hd)
        k = k.reshape(b, q_len, cfg.n_head, hd)
        v = v.reshape(b, q_len, cfg.n_head, hd)
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
            out = flash_attention(q, k, v, flash_mask, scale=scale, window=window).to(dtype)
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
        out = out.reshape(b, q_len, cfg.d_model)
        return self.c_proj(out, dtype), new_cache


class MLP(nn.Module):
    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.params_dtype
        self.c_fc = Dense(cfg.d_model, cfg.ff_dim, True, pd, device)
        self.c_proj = Dense(cfg.ff_dim, cfg.d_model, True, pd, device)

    def forward(self, x):
        cfg = self.cfg
        h = self.c_fc(x, cfg.compute_dtype)
        if cfg.activation == "gelu_new":
            h = F.gelu(h, approximate="tanh")
        elif cfg.activation == "gelu":
            h = F.gelu(h)
        elif cfg.activation == "relu":
            h = F.relu(h)
        else:
            raise ValueError(f"unknown activation {cfg.activation}")
        return self.c_proj(h, cfg.compute_dtype)


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
                block_tables=None):
        cfg = self.cfg
        dtype = cfg.compute_dtype
        if cfg.parallel_residual:
            h = self.ln_1(x, dtype)
            attn_out, new_cache = self.attn(h, attn_bias, positions, cache, cache_index, flash_mask, window,
                                            block_tables)
            mlp_in = self.ln_2(x, dtype) if cfg.use_parallel_ln else h
            x = x + attn_out + self.mlp(mlp_in)
        else:
            attn_out, new_cache = self.attn(self.ln_1(x, dtype), attn_bias, positions, cache, cache_index,
                                            flash_mask, window, block_tables)
            x = x + attn_out
            x = x + self.mlp(self.ln_2(x, dtype))
        return x, new_cache


def make_attn_bias(attn_mask_kv: torch.Tensor, q_len: int, q_offset, window: int = 0) -> torch.Tensor:
    """Additive attention bias [b, 1, q_len, kv_len]: key j is visible to
    query i iff its slot is valid and j <= q_offset + i (and, with a window,
    j > q_offset + i − window); 0 where visible, −1e9 elsewhere. A [b]
    tensor ``q_offset`` gives every row its own causal frontier."""
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

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        pd = cfg.params_dtype
        self.wte = Embed(cfg.vocab_size, cfg.d_model, pd, device)
        if cfg.pos_type == "learned":
            self.wpe = Embed(cfg.max_position, cfg.d_model, pd, device)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, device))
        self.ln_f = LayerNorm(cfg.d_model, cfg.ln_eps, pd, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.extra.get("lm_head_bias", False), pd, device)
        if cfg.n_soft_tokens > 0:
            self.soft_prompt = nn.Parameter(torch.empty((cfg.n_soft_tokens, cfg.d_model), dtype=pd, device=device))

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
        """
        cfg = self.cfg
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
            soft = compute_weight(self.soft_prompt, dtype)
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

        # Flash prefill needs a STATIC zero write offset (a vector offset,
        # as the paged suffix prefill passes, takes the einsum path).
        prefill_at_zero = cache is not None and not vector_index and cache_index == 0
        kernel_device = device.type == "cuda" and dtype == torch.bfloat16
        use_flash = flash_eligible(cfg, q_len, cache is not None, prefill_at_zero, kernel_device)
        attn_bias = local_bias = flash_mask = None
        if use_flash:
            flash_mask = attention_mask.float()
        else:
            if cache is not None:
                kv_mask = cache_mask if cache_mask is not None else attention_mask
                bias_mask, bias_offset = kv_mask, cache_index
            else:
                bias_mask, bias_offset = attention_mask, 0
            attn_bias = make_attn_bias(bias_mask, q_len, bias_offset)
            if any(t == "local" for t in cfg.attention_layers):
                local_bias = make_attn_bias(bias_mask, q_len, bias_offset, window=cfg.window_size)

        branch_hidden = None
        new_cache = [] if cache is not None else None
        # remat (policy "full"): under grad, each block keeps only its input
        # and recomputes its activations in the backward, as the JAX
        # package's nn.remat does. Cache passes run without grad, so the
        # rollout path is unchanged.
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
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
            )
            if remat:
                x, layer_cache = checkpoint(self.block(i), *args, use_reentrant=False)
            else:
                x, layer_cache = self.block(i)(*args)
            if cache is not None:
                new_cache.append(layer_cache)

        x = self.ln_f(x, dtype)
        if collect_hidden_at is not None and collect_hidden_at == cfg.n_layer:
            branch_hidden = x
        if n_soft:
            # Callers see their own length; a hydra branch cannot replay a
            # prefix, so soft-prompt models have none (``heads``).
            x = x[:, n_soft:]
            if branch_hidden is not None:
                branch_hidden = branch_hidden[:, n_soft:]

        logits = logprobs = lse = entropy = None
        if labels is not None:
            S = labels.shape[1]
            x_head = x[:, logits_start:][:, :S]
            if cfg.tie_word_embeddings:
                w_head, b_head, tied = self.wte.embedding, None, True
            else:
                w_head, b_head, tied = self.lm_head.kernel, self.lm_head.bias, False
            # A head no gradient reaches goes in as its cached bf16 copy
            # (the same values as the per-tile cast); a trained one as the
            # f32 master, so its gradient stays f32.
            w_frozen = frozen_copy(w_head, dtype)
            w_head = w_head if w_frozen is None else w_frozen
            logprobs, lse, entropy = routed_logprob(
                x_head, w_head, labels, b_head, tied=tied,
                mode=cfg.extra.get("fused_logprob", "auto"), mask=labels_mask,
            )
        elif compute_logits:
            x_head = x[:, logits_start:] if logits_start else x
            if cfg.tie_word_embeddings:
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
    (k_i8, v_i8, k_scale, v_scale) with unit scales under kv_cache_quant."""
    shape = lead + (cfg.n_head, cfg.head_dim)
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
    """Allocate an empty KV cache: per-layer (k, v) [b, T, n_head, hd], or
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
