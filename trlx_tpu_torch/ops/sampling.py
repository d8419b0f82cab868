"""Logit processors for the decode loop (the counterparts of
``trlx_tpu.ops.sampling``): min-length EOS suppression → temperature →
top-k → top-p, and bigram transition masking."""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from trlx_tpu_torch.ops.modeling import topk_mask

NEG_INF = -1e9


@dataclass(frozen=True)
class GenerateConfig:
    """Decode parameters, with explicit token counts instead of the
    reference-style total lengths."""

    max_new_tokens: int = 32
    min_new_tokens: int = 0
    do_sample: bool = True
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0

    @classmethod
    def from_gen_kwargs(cls, gen_kwargs: dict, prompt_len: int = 0, pad_token_id: int = 0, eos_token_id=None):
        """Translate reference-style gen_kwargs (max_length = prompt + gen)."""
        kw = dict(gen_kwargs)
        if "max_new_tokens" in kw:
            max_new = kw["max_new_tokens"]
        elif "max_length" in kw:
            max_new = max(kw["max_length"] - prompt_len, 1)
        else:
            max_new = 32
        if "min_new_tokens" in kw:
            min_new = kw["min_new_tokens"]
        elif "min_length" in kw:
            min_new = max(kw["min_length"] - prompt_len, 0)
        else:
            min_new = 0
        return cls(
            max_new_tokens=int(max_new),
            min_new_tokens=int(min_new),
            do_sample=bool(kw.get("do_sample", True)),
            temperature=float(kw.get("temperature", 1.0)),
            top_k=int(kw.get("top_k", 0)),
            top_p=float(kw.get("top_p", 1.0)),
            eos_token_id=kw.get("eos_token_id", eos_token_id),
            pad_token_id=int(kw.get("pad_token_id", pad_token_id)),
        )


def process_logits_default(logits: torch.Tensor, gcfg: GenerateConfig, step) -> torch.Tensor:
    """The HF-equivalent chain over [b, vocab] logits, in float32. ``step``
    is the decode step: an int for the batch, or a per-row [b, 1] tensor
    (the engine's slots), which suppresses eos row by row."""
    logits = logits.float()
    if gcfg.eos_token_id is not None and gcfg.min_new_tokens > 0:
        if torch.is_tensor(step):
            eos_col = torch.zeros_like(logits[:1])
            eos_col[:, gcfg.eos_token_id] = NEG_INF
            logits = torch.where(step < gcfg.min_new_tokens, logits + eos_col, logits)
        elif step < gcfg.min_new_tokens:
            logits = logits.clone()
            logits[:, gcfg.eos_token_id] += NEG_INF
    if gcfg.temperature != 1.0:
        logits = logits / gcfg.temperature
    if gcfg.top_k > 0:
        logits = torch.clamp(topk_mask(logits, gcfg.top_k), min=NEG_INF)
    if gcfg.top_p < 1.0:
        logits = top_p_mask(logits, gcfg.top_p)
    return logits


def sample_categorical(probs: torch.Tensor, generator: Optional[torch.Generator], rows=None) -> torch.Tensor:
    """One token per row of ``probs`` [b, vocab]: argmax of probs / q with
    q ~ Exp(1), the race ``torch.multinomial(probs, 1)`` runs, drawing the
    same numbers from ``generator``, so its tokens equal multinomial's. It
    has none of multinomial's host-side checks, so a CUDA graph can capture
    it. ``rows`` = (first, total): these are rows first.. of a batch of
    ``total`` (a data rank's share): the whole batch's noise is drawn and
    these rows' kept, so the tokens equal the whole batch's."""
    if rows is None:
        q = torch.empty_like(probs).exponential_(1, generator=generator)
    else:
        first, total = rows
        q = torch.empty((total, probs.shape[-1]), dtype=probs.dtype, device=probs.device)
        q = q.exponential_(1, generator=generator)[first:first + probs.shape[0]]
    return torch.argmax(probs / q, dim=-1)


def top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the tokens whose preceding cumulative
    probability (in descending order) is below ``top_p``."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    inf = torch.full_like(sorted_logits, float("inf"))
    threshold = torch.where(keep_sorted, sorted_logits, inf).min(dim=-1, keepdim=True).values
    return torch.where(logits >= threshold, logits, torch.full_like(logits, NEG_INF))


def make_bigram_mask_processor(logit_mask) -> Callable:
    """Forbid token j after token i where ``logit_mask[i, j]`` is True.
    ``logit_mask`` is a [vocab, vocab] bool array or tensor; it is moved to
    the logits' device on first use."""
    table = {"mask": torch.as_tensor(logit_mask, dtype=torch.bool)}

    def processor(logits: torch.Tensor, state: dict) -> torch.Tensor:
        if table["mask"].device != logits.device:
            table["mask"] = table["mask"].to(logits.device)
        forbidden = table["mask"][state["last_token"].long()]
        return torch.where(forbidden, torch.full_like(logits, NEG_INF), logits)

    return processor
