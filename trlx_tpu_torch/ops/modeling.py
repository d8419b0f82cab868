"""Math primitives used by the RL losses and the sampler (the counterparts
of ``trlx_tpu.ops.modeling``). All functions are mask-aware: everything is
padded to fixed shapes, so the masked variants carry the semantics."""

from typing import Optional

import torch


def whiten(values: torch.Tensor, shift_mean: bool = True) -> torch.Tensor:
    """Normalize to zero mean / unit variance (unbiased variance)."""
    mean = values.mean()
    var = values.var(unbiased=True)
    whitened = (values - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean over positions where mask == 1."""
    mask = mask.to(values.dtype)
    if dim is None:
        return (values * mask).sum() / torch.clamp(mask.sum(), min=1e-8)
    return (values * mask).sum(dim) / torch.clamp(mask.sum(dim), min=1e-8)


def masked_var(values: torch.Tensor, mask: torch.Tensor, ddof: int = 1) -> torch.Tensor:
    """Variance over positions where mask == 1 (unbiased by default)."""
    mask = mask.to(values.dtype)
    mean = masked_mean(values, mask)
    sq = ((values - mean) ** 2 * mask).sum()
    return sq / torch.clamp(mask.sum() - ddof, min=1e-8)


def masked_whiten(values: torch.Tensor, mask: torch.Tensor, shift_mean: bool = True) -> torch.Tensor:
    """Whiten over the valid (mask == 1) positions only; padded positions
    come back as 0."""
    mean = masked_mean(values, mask)
    var = masked_var(values, mask)
    whitened = (values - mean) * torch.reciprocal(torch.sqrt(var + 1e-8))
    if not shift_mean:
        whitened = whitened + mean
    return whitened * mask.to(values.dtype)


def logprobs_from_logits(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-token log-probabilities of ``labels`` under ``logits`` [..., V],
    with the softmax in float32. With ``mask``, rows where mask == 0 have
    their logits zeroed before the softmax and return exactly 0."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask.bool()[..., None], logits, torch.zeros((), device=logits.device))
    logp = torch.log_softmax(logits, dim=-1)
    out = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        out = out * mask.float()
    return out


def topk_mask(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Set all but the top-k values along the last axis to -inf."""
    kth = torch.sort(xs, dim=-1).values[..., -k][..., None]
    return torch.where(xs < kth, torch.full_like(xs, float("-inf")), xs)
