"""RL losses (the counterpart of ``trlx_tpu.ops.rl_losses``): GAE, the
clipped PPO objective and the KL-penalty rewards, in f32 over fixed padded
shapes.

The JAX package's conventions are kept: values are indexed
state-before-token ([P-1, P+R-1)) by both the rollout and the loss, and the
terminal score lands on the last VALID response token. Packed train batches
(``segment_ids`` / ``n_seqs``) are not ported; the trainer refuses
``method.pack_train_batch``.
"""

from typing import Dict, Tuple

import torch

from trlx_tpu_torch.ops.modeling import masked_mean, masked_whiten


def gae_advantages(
    rewards: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, gamma: float, lam: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over the response region.

    rewards/values/mask: [b, R] right-padded. Returns (advantages, returns),
    both zeroed at padded positions. The reversed recurrence
    A_t = delta_t + gamma*lam*A_{t+1} runs as a loop over reversed time
    (the JAX package's ``lax.scan``)."""
    mask = mask.float()
    r = rewards.float() * mask
    v = values.float() * mask
    next_v = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
    deltas = r + gamma * next_v - v  # zero at the padded tail: a clean boundary
    carry = torch.zeros_like(deltas[:, 0])
    advs = []
    for t in range(deltas.shape[1] - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * carry
        advs.append(carry)
    advantages = torch.stack(advs[::-1], dim=1) * mask
    returns = (advantages + v) * mask
    return advantages, returns


def ppo_loss(
    logprobs: torch.Tensor,
    vpred: torch.Tensor,
    old_logprobs: torch.Tensor,
    old_values: torch.Tensor,
    rewards: torch.Tensor,
    mask: torch.Tensor,
    *,
    gamma: float,
    lam: float,
    cliprange: float,
    cliprange_value: float,
    vf_coef: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped PPO objective over the response region. All args [b, R]
    (right-padded; ``mask`` marks valid response tokens). GAE and whitening
    run inside, without gradient. Returns (loss, stats); ``stats["mean_kl"]``
    is the policy-vs-rollout sum-over-tokens KL the adaptive controller
    reads."""
    mask = mask.float()
    with torch.no_grad():
        advantages, returns = gae_advantages(rewards, old_values, mask, gamma, lam)
        advantages = masked_whiten(advantages, mask)

    vpred = vpred.float()
    vpredclipped = torch.clamp(vpred, old_values - cliprange_value, old_values + cliprange_value)
    vf_losses1 = (vpred - returns) ** 2
    vf_losses2 = (vpredclipped - returns) ** 2
    vf_loss = 0.5 * masked_mean(torch.maximum(vf_losses1, vf_losses2), mask)
    vf_clipfrac = masked_mean((vf_losses2 > vf_losses1).float(), mask)

    log_ratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(log_ratio)
    pg_losses = -advantages * ratio
    pg_losses2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
    pg_loss = masked_mean(torch.maximum(pg_losses, pg_losses2), mask)
    pg_clipfrac = masked_mean((pg_losses2 > pg_losses).float(), mask)

    loss = pg_loss + vf_coef * vf_loss
    with torch.no_grad():
        ret_mean = masked_mean(returns, mask)
        ret_var = masked_mean((returns - ret_mean) ** 2, mask)
        err_var = masked_mean((returns - vpred) ** 2, mask)
        stats = {
            "loss": loss,
            "pg_loss": pg_loss,
            "vf_loss": vf_loss,
            "pg_clipfrac": pg_clipfrac,
            "vf_clipfrac": vf_clipfrac,
            "mean_kl": log_ratio.sum(-1).mean(),
            "mean_ratio": masked_mean(ratio, mask),
            "mean_return": (rewards * mask).sum(-1).mean(),
            "mean_advantage": masked_mean(advantages, mask),
            "mean_entropy": masked_mean(-logprobs, mask),
            "explained_variance": 1.0 - err_var / (ret_var + 1e-8),
        }
        stats = {k: v.detach() for k, v in stats.items()}
    return loss, stats


def kl_penalty_rewards(
    logprobs: torch.Tensor,
    ref_logprobs: torch.Tensor,
    response_mask: torch.Tensor,
    scores: torch.Tensor,
    kl_coef: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token reward = −kl_coef·(logp − ref_logp), with the scalar score
    added at the last VALID response token. Returns (rewards [b, R],
    kl [b, R])."""
    mask = response_mask.float()
    kl = (logprobs - ref_logprobs) * mask
    non_score = -kl_coef * kl
    lengths = mask.sum(-1).long()
    last_ix = torch.clamp(lengths - 1, min=0)
    terminal = torch.nn.functional.one_hot(last_ix, logprobs.shape[-1]).float() * mask
    rewards = non_score + terminal * scores.float()[:, None]
    return rewards, kl
