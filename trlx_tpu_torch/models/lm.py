"""Causal transformer LM (PyTorch), the counterpart of ``trlx_tpu.models.lm``.

One module covers GPT-2 (learned positions, sequential residual, fused qkv,
tied head), GPT-J (rotary, parallel residual with one LN, untied head with
bias) and NeoX-style layouts. Parameters keep the JAX package's names and
layouts (``transformer.h_{i}.attn.q_proj.kernel`` is ``[in, out]``), so a
Flax parameter tree carries over one to one (``hf_import.params_from_jax``).

Parameters are stored in ``param_dtype`` and cast to the compute dtype at
use, as the JAX package does. The KV cache is a tuple of per-layer (k, v)
tensors [b, T, h, d] written IN PLACE at ``cache_index``.

Attention routes through three paths, by the JAX package's static rules:

- the flash kernel for full-sequence passes and for prefill at cache index
  0 (``flash_eligible``; "auto" needs a CUDA device, bf16 and a long
  128-aligned sequence);
- the decode kernel for single-token steps over the cache
  (``decode_attn_eligible``; CUDA device and bf16);
- the einsum path with an additive [b, 1, q, kv] bias otherwise.

``remat`` with policy "full" checkpoints every block under grad; policy
"dots" raises. Not in this slice: the int8 KV cache, int8 decode weights,
paged caches, multi-token verify windows, ring attention, soft prompts and
packed segments; the config fields exist and raise when set.
"""

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from trlx_tpu_torch.device import resolve_device, torch_dtype
from trlx_tpu_torch.ops.decode_attention import decode_attention, decode_attn_eligible
from trlx_tpu_torch.ops.flash_attention import auto_flash_ok, flash_attention
from trlx_tpu_torch.ops.fused_logprob import routed_logprob


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
        if self.kv_cache_quant:
            raise NotImplementedError("the int8 KV cache (kv_cache_quant) is not ported yet")
        if self.n_soft_tokens:
            raise NotImplementedError("soft prompts (n_soft_tokens) are not ported yet")
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


def rotary_sincos(positions: torch.Tensor, rotary_dim: int, base: float = 10000.0):
    """sin/cos tables for rotary positions. positions: [b, t] → [b, t, rd/2]."""
    inv_freq = 1.0 / (base ** (np.arange(0, rotary_dim, 2) / rotary_dim))
    inv = torch.tensor(inv_freq, dtype=torch.float32, device=positions.device)
    freqs = positions[..., None].float() * inv[None, None, :]
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


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)`` with kernel [in, out] stored in the param
    dtype and cast, like the input, to the compute dtype at use."""

    def __init__(self, in_features: int, features: int, use_bias: bool, param_dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((in_features, features), dtype=param_dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty((features,), dtype=param_dtype, device=device)) if use_bias else None
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
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

    def forward(self, x, attn_bias, positions, cache=None, cache_index=None, flash_mask=None, window=0):
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
            sin, cos = rotary_sincos(positions, rd)
            neox = cfg.extra.get("neox_rotary", False)
            q = apply_rotary(q, sin, cos, rd, neox)
            k = apply_rotary(k, sin, cos, rd, neox)

        new_cache = None
        decode_kv = None
        if cache is not None:
            k_cache, v_cache = cache
            k_cache[:, cache_index : cache_index + q_len] = k.to(k_cache.dtype)
            v_cache[:, cache_index : cache_index + q_len] = v.to(v_cache.dtype)
            new_cache = (k_cache, v_cache)
            if flash_mask is None:
                single_step = q_len == 1 and attn_bias is not None
                if (
                    single_step
                    and x.device.type == "cuda"
                    and dtype == torch.bfloat16
                    and decode_attn_eligible(cfg.n_head, hd)
                ):
                    decode_kv = (k_cache, v_cache)
                else:
                    k, v = k_cache, v_cache

        scale = 1.0 / np.sqrt(hd) if cfg.scale_attn else 1.0
        if flash_mask is not None:
            out = flash_attention(q, k, v, flash_mask, scale=scale, window=window).to(dtype)
        elif decode_kv is not None:
            # The single-token step's bias row carries causality, validity
            # and any window at once.
            out = decode_attention(q[:, 0], decode_kv[0], decode_kv[1], attn_bias[:, 0, 0, :], scale=scale).to(dtype)
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

    def forward(self, x, attn_bias, positions, cache=None, cache_index=None, flash_mask=None, window=0):
        cfg = self.cfg
        dtype = cfg.compute_dtype
        if cfg.parallel_residual:
            h = self.ln_1(x, dtype)
            attn_out, new_cache = self.attn(h, attn_bias, positions, cache, cache_index, flash_mask, window)
            mlp_in = self.ln_2(x, dtype) if cfg.use_parallel_ln else h
            x = x + attn_out + self.mlp(mlp_in)
        else:
            attn_out, new_cache = self.attn(self.ln_1(x, dtype), attn_bias, positions, cache, cache_index,
                                            flash_mask, window)
            x = x + attn_out
            x = x + self.mlp(self.ln_2(x, dtype))
        return x, new_cache


def make_attn_bias(attn_mask_kv: torch.Tensor, q_len: int, q_offset: int, window: int = 0) -> torch.Tensor:
    """Additive attention bias [b, 1, q_len, kv_len]: key j is visible to
    query i iff its slot is valid and j <= q_offset + i (and, with a window,
    j > q_offset + i − window); 0 where visible, −1e9 elsewhere."""
    kv_len = attn_mask_kv.shape[-1]
    device = attn_mask_kv.device
    q_idx = q_offset + torch.arange(q_len, device=device)[:, None]
    k_idx = torch.arange(kv_len, device=device)[None, :]
    causal = k_idx <= q_idx
    if window > 0:
        causal = causal & (k_idx > q_idx - window)
    valid = attn_mask_kv.bool()[:, None, None, :] & causal[None, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(valid, zero, torch.full((), -1e9, dtype=torch.float32, device=device))


class TransformerLM(nn.Module):
    """Embeddings + N blocks + final LN (+ untied head).

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

    def block(self, i: int) -> Block:
        return getattr(self, f"h_{i}")

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        cache: Optional[Tuple] = None,
        cache_index: Optional[int] = None,
        cache_mask: Optional[torch.Tensor] = None,
        start_layer: int = 0,
        stop_layer: Optional[int] = None,
        collect_hidden_at: Optional[int] = None,
        compute_logits: bool = True,
        logits_start: int = 0,
        labels: Optional[torch.Tensor] = None,
        labels_mask: Optional[torch.Tensor] = None,
    ):
        """Returns dict(logits, hidden, branch_hidden, cache, logprobs, lse,
        entropy), as the JAX module does.

        - Full-sequence / prefill: attention over the q_len itself.
        - Decode: ``cache`` (per-layer (k, v)), ``cache_mask`` [b, kv_len]
          valid key slots, ``cache_index`` the (integer) write offset.
        - ``collect_hidden_at=k`` also returns the hidden state entering
          block k (the hydra branch point).
        - ``labels`` [b, S] switches the head to fused-logprob mode: f32
          ``logprobs``/``lse``/``entropy`` [b, S] at positions
          logits_start.. instead of logits (``extra['fused_logprob']`` ∈
          auto|force|off); ``labels_mask`` zeros masked rows.
        """
        cfg = self.cfg
        dtype = cfg.compute_dtype
        stop_layer = cfg.n_layer if stop_layer is None else stop_layer
        if cache_index is not None:
            cache_index = int(cache_index)

        if inputs_embeds is None:
            x = self.wte(input_ids, dtype)
        else:
            x = inputs_embeds.to(dtype)
        b, q_len = x.shape[:2]
        device = x.device
        if attention_mask is None:
            attention_mask = torch.ones((b, q_len), dtype=torch.int32, device=device)

        if position_ids is None:
            if cache is not None and cache_mask is not None:
                # Decode: absolute positions from the cache occupancy mask,
                # read at the write offset.
                full_pos = torch.clamp(torch.cumsum(cache_mask, dim=-1) - 1, min=0)
                position_ids = full_pos[:, cache_index : cache_index + q_len]
            else:
                # Left-pad aware positions: cumsum over valid tokens.
                position_ids = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)

        if start_layer == 0 and cfg.pos_type == "learned":
            x = x + self.wpe(position_ids, dtype)

        prefill_at_zero = cache is not None and cache_index == 0
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

        logits = logprobs = lse = entropy = None
        if labels is not None:
            S = labels.shape[1]
            x_head = x[:, logits_start:][:, :S]
            if cfg.tie_word_embeddings:
                w_head, b_head, tied = self.wte.embedding, None, True
            else:
                w_head, b_head, tied = self.lm_head.kernel, self.lm_head.bias, False
            logprobs, lse, entropy = routed_logprob(
                x_head, w_head, labels, b_head, tied=tied,
                mode=cfg.extra.get("fused_logprob", "auto"), mask=labels_mask,
            )
        elif compute_logits:
            x_head = x[:, logits_start:] if logits_start else x
            if cfg.tie_word_embeddings:
                logits = x_head.to(dtype) @ self.wte.embedding.to(dtype).t()
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


def init_cache(cfg: LMConfig, batch: int, max_len: int, device, dtype=None):
    """Allocate an empty KV cache: per-layer (k, v) [b, T, n_head, hd]."""
    shape = (batch, max_len, cfg.n_head, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return tuple(
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_layer)
    )
