"""ILQL losses: double-Q TD + expectile V + CQL + AWAC (the counterpart of
``trlx_tpu.ops.ilql_loss``), over fixed-shape padded batches: zero-padded
``dones`` make the terminal mask drop padded actions, and AWAC is masked by
attention.

- ``ilql_loss_terms``: the objective over per-action GATHERED values (the
  online Q at the dataset action, which the fused head gives as logprob +
  logsumexp; the target Q there; the CQL NLL = -logprob) and the AWAC term
  as a scalar, so the fused route never forms a [b, A, V] or [b, T, V]
  tensor.
- ``ilql_loss``: the dense entry over full Q and logit tensors; it gathers
  and calls ``ilql_loss_terms``.
"""

from typing import Dict, Sequence, Tuple

import torch

from trlx_tpu_torch.ops.modeling import global_ratio, logprobs_from_logits, loss_group


def action_tokens(input_ids: torch.Tensor, actions_ixs: torch.Tensor) -> torch.Tensor:
    """The token following each action position: [b, T], [b, A] → [b, A]."""
    return torch.gather(input_ids[:, 1:], 1, actions_ixs.long())


def ilql_loss_terms(
    Qs: Sequence[torch.Tensor],
    targetQs: Sequence[torch.Tensor],
    cql_nlls: Sequence[torch.Tensor],
    vs: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    loss_awac: torch.Tensor,
    *,
    gamma: float,
    tau: float,
    cql_scale: float,
    awac_scale: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ILQL objective. ``Qs``, ``targetQs`` and ``cql_nlls`` are [b, A]
    f32 each (one per Q head), ``vs`` [b, A + 1] the V head at the states,
    ``rewards`` [b, A], ``dones`` [b, A + 1] (1 while alive, 0 at the
    terminal and in padding), ``loss_awac`` a scalar. The target Qs and
    V(s') carry no gradient. On a mesh with data axes each mean runs over
    the whole batch (``ops.modeling.loss_group``)."""
    g = loss_group()
    targetQs = [q.detach() for q in targetQs]
    targetQ = torch.minimum(*targetQs) if len(targetQs) > 1 else targetQs[0]

    dones = dones.float()
    terminal_mask = dones[:, :-1]
    n_local = terminal_mask.sum()

    def over_nonterminal(t):
        return global_ratio((t * terminal_mask).sum(), n_local, g, min_den=1.0)

    vs = vs.float()
    V = vs[:, :-1]
    Vnext = vs[:, 1:].detach() * dones[:, 1:]
    Q_target_value = rewards.float() + gamma * Vnext

    loss_q = sum(over_nonterminal((Q - Q_target_value).square()) for Q in Qs)

    # Expectile regression of V toward the target Q.
    diff = targetQ - V
    weight = torch.where(diff >= 0, torch.full_like(diff, tau), torch.full_like(diff, 1.0 - tau))
    loss_v = over_nonterminal(weight * diff.square())

    # CQL: cross-entropy of the Q heads at the dataset actions.
    loss_cql = sum(over_nonterminal(nll) for nll in cql_nlls)

    loss = loss_q + loss_v + cql_scale * loss_cql + awac_scale * loss_awac
    stats = {
        "losses/loss": loss,
        "losses/loss_q": loss_q,
        "losses/loss_v": loss_v,
        "losses/loss_cql": loss_cql,
        "losses/loss_awac": loss_awac,
    }
    return loss, {k: v.detach() for k, v in stats.items()}


def ilql_loss(
    logits: torch.Tensor,
    qs: Tuple[torch.Tensor, ...],
    target_qs: Tuple[torch.Tensor, ...],
    vs: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    actions_ixs: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    *,
    gamma: float,
    tau: float,
    cql_scale: float,
    awac_scale: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The dense entry: ``logits`` [b, T, V], ``qs`` / ``target_qs`` each
    [b, A, V]; the rest as ``ilql_loss_terms``. AWAC is the LM's mean NLL
    over the attended next tokens."""
    actions = action_tokens(input_ids, actions_ixs)

    def gather_a(q):
        return torch.gather(q.float(), -1, actions.long()[..., None])[..., 0]

    Qs = [gather_a(q) for q in qs]
    targetQs = [gather_a(q) for q in target_qs]
    cql_nlls = [-logprobs_from_logits(q, actions) for q in qs]

    attn = attention_mask.float()
    nll = -logprobs_from_logits(logits[:, :-1], input_ids[:, 1:])
    loss_awac = global_ratio((nll * attn[:, 1:]).sum(), attn[:, 1:].sum(), loss_group(), min_den=1.0)

    return ilql_loss_terms(
        Qs, targetQs, cql_nlls, vs, rewards, dones, loss_awac,
        gamma=gamma, tau=tau, cql_scale=cql_scale, awac_scale=awac_scale,
    )
