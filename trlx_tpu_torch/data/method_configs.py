"""Per-method hyperparameter dataclasses and their registry.

The PPO and ILQL configs of ``trlx_tpu.data.method_configs``, field for
field, so the same YAML ``method`` section loads into either package. Knobs of features the
port does not run yet are kept as fields; the trainer refuses them when set.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_METHODS: Dict[str, type] = {}


def register_method(name=None):
    """Decorator registering a method config class by (lowercased) name."""

    def register_class(cls, registered_name):
        _METHODS[registered_name.lower()] = cls
        return cls

    if isinstance(name, str):
        return lambda cls: register_class(cls, name)
    if name is None:
        return lambda cls: register_class(cls, cls.__name__)
    cls = name
    return register_class(cls, cls.__name__)


def get_method(name: str) -> type:
    name = name.lower()
    if name in _METHODS:
        return _METHODS[name]
    raise ValueError(f"no method config registered under {name!r}")


@dataclass
@register_method
class MethodConfig:
    """Base method config."""

    name: str = "MethodConfig"

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
@register_method
class PPOConfig(MethodConfig):
    """PPO hyperparameters. ``gen_kwargs`` holds reference-style generation
    lengths (``max_length`` = prompt + response); see
    ``trlx_tpu.data.method_configs.PPOConfig`` for every knob's meaning."""

    name: str = "ppoconfig"
    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    init_kl_coef: float = 0.2
    target: Optional[float] = 6.0
    horizon: int = 10000
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 1.0
    gen_kwargs: dict = field(default_factory=dict)
    fused_rollout_stats: bool = True
    max_staleness: int = 0
    rollout_overlap: bool = False
    score_queue_depth: int = 2
    prefetch_depth: int = 1
    pack_train_batch: bool = False
    rollout_engine: bool = False
    engine_slots: int = 0
    prefill_batch: int = 4
    engine_steps_per_sync: int = 8
    spec_decode: str = ""
    spec_k: int = 0
    paged_kv: bool = False
    kv_block_size: int = 128
    kv_pool_blocks: int = 0
    fleet_disaggregate: bool = False
    fleet_inflight_weights: bool = False
    fleet_elastic: bool = False


@dataclass
@register_method
class ILQLConfig(MethodConfig):
    """ILQL hyperparameters. ``gen_kwargs`` holds the eval decode's lengths
    and its ``beta``, ``top_k`` and ``temperature``; see
    ``trlx_tpu.data.method_configs.ILQLConfig``."""

    name: str = "ilqlconfig"
    tau: float = 0.7
    gamma: float = 0.99
    cql_scale: float = 0.1
    awac_scale: float = 1.0
    alpha: float = 0.005
    steps_for_target_q_sync: int = 5
    betas: List[float] = field(default_factory=lambda: [4.0])
    two_qs: bool = True
    gen_kwargs: dict = field(default_factory=dict)


@dataclass
@register_method
class PPOSoftpromptConfig(PPOConfig):
    """Soft-prompt PPO: learned prefix embeddings, frozen LM."""

    name: str = "pposoftpromptconfig"
    n_soft_tokens: int = 8
    initialize_from_vocab: bool = True
