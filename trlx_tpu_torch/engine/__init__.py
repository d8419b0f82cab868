"""Continuous-batching rollout engine: slot-based decode over the KV cache,
optionally paged with prefix caching (the counterpart of
``trlx_tpu.engine``). ``PPOOrchestrator.make_experience`` streams its
episodes when ``method.rollout_engine`` is on."""

from trlx_tpu_torch.engine.drafters import NgramDrafter, make_drafter
from trlx_tpu_torch.engine.paged_pool import BlockPool, PoolExhausted, prefix_block_digests
from trlx_tpu_torch.engine.rollout_engine import Episode, RolloutEngine

__all__ = ["BlockPool", "Episode", "NgramDrafter", "PoolExhausted", "RolloutEngine", "make_drafter",
           "prefix_block_digests"]
