"""RL heads, the hydra value-head model and the ILQL heads model (the
counterparts of ``trlx_tpu.models.heads``).

The frozen reference branch is the SAME module applied from the branch layer
up with a frozen copy of that layer range's parameters swapped in
(``forward_branch(..., params=extras)``); ``extract_branch_params`` takes
that copy. No module is duplicated.
"""

from contextlib import contextmanager
from typing import Dict, Optional, Set, Tuple

import torch
from torch import nn

from trlx_tpu_torch.device import resolve_device
from trlx_tpu_torch.models.lm import Dense, LMConfig, TransformerLM


class MLPHead(nn.Module):
    """Dense(2*d) → ReLU → Dense(out); the output layer runs in f32."""

    def __init__(self, out_features: int, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers_0 = Dense(cfg.d_model, 2 * cfg.d_model, True, cfg.params_dtype, device)
        self.layers_1 = Dense(2 * cfg.d_model, out_features, True, cfg.params_dtype, device)

    def forward(self, x):
        h = torch.relu(self.layers_0(x, self.cfg.compute_dtype))
        return self.layers_1(h, torch.float32)


@contextmanager
def swapped_params(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """Temporarily replace the named parameters of ``module`` by
    ``tensors`` (same names as ``named_parameters()``), restoring them on
    exit. Not thread-safe: the module is shared state while swapped.

    Each tensor is wrapped in one frozen Parameter for its lifetime (kept on
    the tensor), so the compute-dtype copy the model caches on a frozen
    weight (``lm.frozen_copy``) serves every swap, not only one."""
    saved = []
    try:
        for name, t in tensors.items():
            mod_name, _, attr = name.rpartition(".")
            sub = module.get_submodule(mod_name)
            if attr not in sub._parameters:
                raise KeyError(f"no parameter named {name!r}")
            saved.append((sub, attr, sub._parameters[attr]))
            wrapped = getattr(t, "_frozen_param", None)
            if wrapped is None:
                wrapped = t._frozen_param = nn.Parameter(t, requires_grad=False)
            sub._parameters[attr] = wrapped
        yield module
    finally:
        for sub, attr, p in reversed(saved):
            sub._parameters[attr] = p


class LMWithValueHead(nn.Module):
    """Policy LM + scalar value head (+ hydra frozen-branch support).

    ``branch_layer`` is the block where the frozen reference branch starts
    (n_layer - num_layers_unfrozen); -1 disables branch collection. A
    soft-prompt model has no branch: the branch could not replay a prefix it
    never saw, so its reference is a whole frozen model."""

    def __init__(self, cfg: LMConfig, branch_layer: int = -1, device=None):
        super().__init__()
        if cfg.n_soft_tokens > 0 and branch_layer >= 0:
            raise ValueError("soft-prompt models use a full frozen ref copy, not the hydra branch")
        self.cfg = cfg
        self.branch_layer = branch_layer
        device = resolve_device(device)
        self.transformer = TransformerLM(cfg, device)
        self.v_head = MLPHead(1, cfg, device)

    def forward(
        self,
        input_ids=None,
        attention_mask=None,
        position_ids=None,
        inputs_embeds=None,
        cache=None,
        cache_index=None,
        cache_mask=None,
        block_tables=None,
        collect_branch_hidden: bool = False,
        logits_start: int = 0,
        compute_logits: bool = True,
        labels=None,
        labels_mask=None,
        prepend_soft: bool = True,
    ):
        out = self.transformer(
            input_ids=input_ids,
            attention_mask=attention_mask,
            position_ids=position_ids,
            inputs_embeds=inputs_embeds,
            cache=cache,
            cache_index=cache_index,
            cache_mask=cache_mask,
            block_tables=block_tables,
            collect_hidden_at=self.branch_layer if (collect_branch_hidden and self.branch_layer >= 0) else None,
            logits_start=logits_start,
            compute_logits=compute_logits,
            labels=labels,
            labels_mask=labels_mask,
            prepend_soft=prepend_soft,
        )
        values = self.v_head(out["hidden"])[..., 0]
        return {
            "logits": out["logits"],
            "values": values,
            "hidden": out["hidden"],
            "branch_hidden": out["branch_hidden"],
            "cache": out["cache"],
            "logprobs": out["logprobs"],
            "lse": out["lse"],
            "entropy": out["entropy"],
        }

    def forward_branch(self, branch_hidden, attention_mask=None, position_ids=None, logits_start: int = 0,
                       labels=None, labels_mask=None, params: Optional[Dict[str, torch.Tensor]] = None):
        """Replay blocks [branch_layer..N) + ln_f + LM head from the
        branch-point hidden states, with ``params`` (the frozen branch copy
        from ``extract_branch_params``) in place of the live parameters.
        With ``labels`` it returns the f32 label logprobs [b, S] from the
        fused head; without, the logits."""
        with swapped_params(self, params or {}):
            out = self.transformer(
                inputs_embeds=branch_hidden,
                attention_mask=attention_mask,
                position_ids=position_ids,
                start_layer=self.branch_layer,
                logits_start=logits_start,
                labels=labels,
                labels_mask=labels_mask,
            )
        if labels is not None:
            return out["logprobs"]
        return out["logits"]


class LMWithILQLHeads(nn.Module):
    """LM + vocabulary-wide Q head(s) + scalar V head for ILQL.

    The target Q heads are not modules: the trainer keeps a frozen copy of
    the Q heads' parameters and applies ``compute_qs`` with it swapped in
    (``swapped_params``), so the Polyak sync is an in-place blend of
    tensors."""

    def __init__(self, cfg: LMConfig, two_qs: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.two_qs = two_qs
        device = resolve_device(device)
        self.transformer = TransformerLM(cfg, device)
        self.v_head = MLPHead(1, cfg, device)
        self.q1_head = MLPHead(cfg.vocab_size, cfg, device)
        if two_qs:
            self.q2_head = MLPHead(cfg.vocab_size, cfg, device)

    def head_names(self):
        return ("q1_head", "q2_head") if self.two_qs else ("q1_head",)

    def forward(
        self,
        input_ids=None,
        attention_mask=None,
        position_ids=None,
        states_ixs=None,
        actions_ixs=None,
        cache=None,
        cache_index=None,
        cache_mask=None,
        logits_start: int = 0,
        labels=None,
        labels_mask=None,
        compute_q_heads: bool = True,
        prepend_soft: bool = True,
    ):
        """Returns dict(logits, qs, vs, hidden, cache, logprobs).

        With ``states_ixs`` / ``actions_ixs`` [b, n] the Q heads run on the
        action positions' hidden states and the V head on the states'; without,
        on every position from ``logits_start`` on (the sampler's prefill
        reads only the last). ``labels`` switches the LM head to the fused
        logprob mode (``logprobs`` [b, S], no logits: the AWAC term);
        ``compute_q_heads=False`` leaves ``qs`` None (the fused train route
        evaluates the Q heads through the fused head itself)."""
        out = self.transformer(
            input_ids=input_ids,
            attention_mask=attention_mask,
            position_ids=position_ids,
            cache=cache,
            cache_index=cache_index,
            cache_mask=cache_mask,
            logits_start=logits_start,
            labels=labels,
            labels_mask=labels_mask,
            prepend_soft=prepend_soft,
        )
        hs = out["hidden"]
        tail = hs[:, logits_start:] if logits_start else hs
        hs_actions = tail if actions_ixs is None else torch.gather(
            hs, 1, actions_ixs.long()[..., None].expand(-1, -1, hs.shape[-1]))
        hs_states = tail if states_ixs is None else torch.gather(
            hs, 1, states_ixs.long()[..., None].expand(-1, -1, hs.shape[-1]))
        return {
            "logits": out["logits"],
            "qs": self.compute_qs(hs_actions) if compute_q_heads else None,
            "vs": self.v_head(hs_states)[..., 0],
            "hidden": hs,
            "cache": out["cache"],
            "logprobs": out["logprobs"],
        }

    def compute_qs(self, hidden) -> Tuple[torch.Tensor, ...]:
        """The Q heads on ``hidden``: a tuple of f32 [..., V], one per head.
        With the target copy swapped in, the target Qs."""
        return tuple(getattr(self, name)(hidden) for name in self.head_names())


def extract_branch_params(model: LMWithValueHead, branch_layer: int) -> Dict[str, torch.Tensor]:
    """A frozen copy (not an alias) of the branch parameters — blocks
    [branch_layer..N), ln_f, and the LM head (wte when tied): the entire
    reference model of the hydra trick."""
    cfg = model.cfg
    prefixes = [f"transformer.h_{i}." for i in range(branch_layer, cfg.n_layer)]
    prefixes.append("transformer.ln_f.")
    prefixes.append("transformer.wte." if cfg.tie_word_embeddings else "transformer.lm_head.")
    return {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith(tuple(prefixes))}


def trainable_mask(model: nn.Module, cfg: LMConfig, num_layers_unfrozen: int) -> Set[str]:
    """The names of the parameters that train: with num_layers_unfrozen =
    k > 0 the bottom N-k blocks are frozen; embeddings, ln_f, the LM head
    and the value head stay trainable. k <= 0 trains everything (the JAX
    package's ``trainable_mask``)."""
    names = [n for n, _ in model.named_parameters()]
    if num_layers_unfrozen <= 0:
        return set(names)
    frozen = tuple(f"transformer.h_{i}." for i in range(cfg.n_layer - num_layers_unfrozen))
    return {n for n in names if not n.startswith(frozen)}
