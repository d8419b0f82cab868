"""Data elements passed between the pipeline, orchestrator and trainer.

The PPO and ILQL element and batch types of ``trlx_tpu.data`` as plain
dataclasses: fields hold numpy arrays on the host or tensors on the device,
with fixed padded shapes (queries left-padded, responses right-padded).
"""

from dataclasses import dataclass
from typing import Any, Callable, Iterable


@dataclass
class PromptElement:
    """A single tokenized prompt."""

    text: str
    tokens: Any


@dataclass
class PromptBatch:
    """A batch of tokenized prompts."""

    text: Iterable[str]
    tokens: Any


@dataclass
class PPORLElement:
    """One PPO rollout: query/response tokens and per-token logprobs, values
    and KL-penalized rewards over the response."""

    query_tensor: Any
    response_tensor: Any
    logprobs: Any
    values: Any
    rewards: Any
    response_mask: Any = None
    query_mask: Any = None


@dataclass
class PPORLBatch:
    """Batched PPO rollouts with fixed padded shapes.

    query_tensors:    [batch, query_len]    (left-padded)
    response_tensors: [batch, response_len] (right-padded)
    logprobs/values/rewards: [batch, response_len]
    response_mask/query_mask: explicit validity masks.
    extras: optional host-side per-sample metadata.
    """

    query_tensors: Any
    response_tensors: Any
    logprobs: Any
    values: Any
    rewards: Any
    response_mask: Any = None
    query_mask: Any = None
    extras: Any = None


@dataclass
class PackedPPOBatch:
    """A PPO train batch with its episodes packed into dense rows
    (``pipeline.ppo_pipeline.pack_ppo_batch``, ``method.pack_train_batch``).

    All arrays [rows, W] with W = query_len + response_len and rows at most
    the batch size (bucketed, so the step sees few shapes):

    input_ids/attention_mask: the packed valid tokens, right-padded.
    segment_ids: 1-based episode id per token, 0 at padding (the
       block-diagonal attention and the GAE reset).
    position_ids: per-episode positions (restarting at 0 each segment).
    labels: the next token at every state position (0 elsewhere).
    loss_mask: 1 exactly at the response STATE positions.
    old_logprobs/old_values/rewards: the rollout stats at the state
       positions (zero elsewhere).
    n_seqs: unused (the trainer's train.batch_size is the episode count).
    extras: host-side metadata (fill fraction, token counts, staleness),
       left on the host by ``put_batch``.
    """

    input_ids: Any
    attention_mask: Any
    segment_ids: Any
    position_ids: Any
    labels: Any
    loss_mask: Any
    old_logprobs: Any
    old_values: Any
    rewards: Any
    n_seqs: Any = None
    extras: Any = None


@dataclass
class ILQLElement:
    """One offline ILQL sample."""

    input_ids: Any
    attention_mask: Any
    rewards: Any
    states_ixs: Any
    actions_ixs: Any
    dones: Any


@dataclass
class ILQLBatch:
    """Batched ILQL samples: input_ids / attention_mask [b, T], rewards and
    actions_ixs [b, T - 1], states_ixs and dones [b, T] (zero-padded)."""

    input_ids: Any
    attention_mask: Any
    rewards: Any
    states_ixs: Any
    actions_ixs: Any
    dones: Any


RewardFn = Callable[[Iterable[Any]], Iterable[float]]
MetricFn = Callable[[Iterable[Any]], dict]

__all__ = [
    "PromptElement",
    "PromptBatch",
    "PPORLElement",
    "PPORLBatch",
    "PackedPPOBatch",
    "ILQLElement",
    "ILQLBatch",
    "RewardFn",
    "MetricFn",
]
