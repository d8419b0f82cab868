"""Math primitives used by the RL losses and the sampler (the counterparts
of ``trlx_tpu.ops.modeling``). All functions are mask-aware: everything is
padded to fixed shapes, so the masked variants carry the semantics.

Reductions over a whole batch are global in the JAX program (one array over
every data shard) and local by default in a split one. On a mesh whose data
axes exceed 1 the trainer sets the data group (``set_loss_group``) and the
masked reductions take ``group=loss_group()``: their sums and counts are
summed over the data ranks, so every rank sees the global mean, and a loss
term's gradient is this rank's share of the global mean's (its own sum over
the global count: the gradients' sum over the data ranks is the global
one)."""

from typing import Optional

import torch

from trlx_tpu_torch.parallel.collectives import all_reduce

_LOSS_GROUP = [None]


def set_loss_group(group):
    """The data group the batch reductions sum over (None: this process's
    rows are the whole batch)."""
    _LOSS_GROUP[0] = group if group is not None and group.size > 1 else None


def loss_group():
    return _LOSS_GROUP[0]


def global_ratio(num: torch.Tensor, den: torch.Tensor, group=None, min_den: float = 1e-8) -> torch.Tensor:
    """num / max(den, min_den) with both summed over ``group``: the forward
    value is the global ratio, the gradient that of this rank's ``num`` over
    the global ``den`` (one all-reduce of the pair)."""
    den = torch.as_tensor(den, dtype=num.dtype, device=num.device)
    if group is None:
        return num / torch.clamp(den, min=min_den)
    tot = all_reduce(torch.stack([num.detach(), den.detach()]), group)
    return (num + (tot[0] - num.detach())) / torch.clamp(tot[1], min=min_den)


def whiten(values: torch.Tensor, shift_mean: bool = True) -> torch.Tensor:
    """Normalize to zero mean / unit variance (unbiased variance)."""
    mean = values.mean()
    var = values.var(unbiased=True)
    whitened = (values - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim=None, group=None) -> torch.Tensor:
    """Mean over positions where mask == 1 (over every data rank's
    positions with ``group``)."""
    mask = mask.to(values.dtype)
    if dim is None:
        return global_ratio((values * mask).sum(), mask.sum(), group)
    return (values * mask).sum(dim) / torch.clamp(mask.sum(dim), min=1e-8)


def masked_var(values: torch.Tensor, mask: torch.Tensor, ddof: int = 1, group=None) -> torch.Tensor:
    """Variance over positions where mask == 1 (unbiased by default; over
    every data rank's positions with ``group``)."""
    mask = mask.to(values.dtype)
    mean = masked_mean(values, mask, group=group)
    sq = ((values - mean) ** 2 * mask).sum()
    count = mask.sum()
    if group is not None:
        tot = all_reduce(torch.stack([sq.detach(), count.detach()]), group)
        sq, count = sq + (tot[0] - sq.detach()), tot[1]
    return sq / torch.clamp(count - ddof, min=1e-8)


def masked_whiten(values: torch.Tensor, mask: torch.Tensor, shift_mean: bool = True, group=None) -> torch.Tensor:
    """Whiten over the valid (mask == 1) positions only (every data rank's
    with ``group``); padded positions come back as 0."""
    mean = masked_mean(values, mask, group=group)
    var = masked_var(values, mask, group=group)
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
