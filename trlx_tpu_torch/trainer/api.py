"""``train()`` dispatch (the counterpart of ``trlx_tpu.trainer.api``): a
``reward_fn`` or an on-device reward model in the config runs online PPO —
trainer, ``PromptPipeline``, orchestrator, the first ``make_experience``,
the eval pipeline, ``learn()``; a ``dataset`` of (samples, rewards) runs
offline ILQL — trainer, ``OfflineOrchestrator.make_experience``, the eval
pipeline, ``learn()``. Prompts and samples are strings (with the config's
tokenizer) or token ids. With the fleet (``method.fleet_disaggregate``) a
learner or colocated PPO trainer takes its first store through the episode
stream (``_fleet_bootstrap``) and a rollout trainer runs
``fleet.run_rollout_worker`` in place of ``learn()``. Without a config, the port's copies of the JAX
package's default configs are read (``trlx_tpu_torch/configs``)."""

import os
from typing import Callable, List, Optional, Tuple

# Importing these modules populates the registries.
import trlx_tpu_torch.orchestrator.offline_orchestrator  # noqa: F401
import trlx_tpu_torch.orchestrator.ppo_orchestrator  # noqa: F401
import trlx_tpu_torch.pipeline.prompt_pipeline  # noqa: F401
import trlx_tpu_torch.trainer.ilql  # noqa: F401
import trlx_tpu_torch.trainer.ppo  # noqa: F401
import trlx_tpu_torch.trainer.ppo_softprompt  # noqa: F401
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.orchestrator import get_orchestrator
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
from trlx_tpu_torch.trainer import get_model

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def default_config(name: str) -> TRLConfig:
    """The default config of method ``name`` ("ppo" or "ilql")."""
    return TRLConfig.load_yaml(os.path.join(_CONFIG_DIR, f"{name}_config.yml"))


def train(
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable] = None,
    dataset: Optional[Tuple[List, List[float]]] = None,
    prompts: Optional[List] = None,
    eval_prompts: Optional[List] = None,
    metric_fn: Optional[Callable] = None,
    config: Optional[TRLConfig] = None,
    split_token: Optional[str] = None,
    logit_mask=None,
    device=None,
):
    """Train a model and return its trainer. ``device`` is the port's
    explicit device: CUDA unless the caller names another ("cpu" in the
    tests). Without prompts, PPO starts from BOS × ``train.batch_size``,
    which needs a tokenizer; ILQL's eval prompts default to the same (token
    0 without a tokenizer)."""
    has_rm = config is not None and config.model.has_reward_model
    if reward_fn is not None and has_rm:
        raise ValueError(
            "Both reward_fn and an on-device reward model "
            "(model.reward_model_path/reward_model_arch) are set — rollouts "
            "would optimize the RM while eval reports reward_fn. Pick one "
            "reward source."
        )
    if reward_fn is not None or has_rm:
        if config is None:
            config = default_config("ppo")
        if model_path:
            config.model.model_path = model_path
        model = get_model(config.model.model_type)(
            config, device=device, reward_fn=reward_fn, metric_fn=metric_fn, logit_mask=logit_mask
        )
        if prompts is None:
            if model.tokenizer is None:
                raise ValueError("default prompts need a tokenizer: pass prompts or set model.tokenizer_path")
            prompts = [model.tokenizer.bos_token] * config.train.batch_size
        # Prompt buckets (method.gen_kwargs) shape the rollout loader only;
        # the eval pipeline stays single-width, as in the JAX package.
        pipeline = PromptPipeline(prompts, model.tokenizer, max_prompt_length=model.prompt_length,
                                  bucket_widths=model.prompt_buckets)
        orch = get_orchestrator(config.train.orchestrator)(
            model, pipeline, reward_fn=reward_fn, metric_fn=metric_fn, chunk_size=config.method.chunk_size
        )
        fleet_role = getattr(model, "fleet_role", None)
        if fleet_role is None:
            orch.make_experience(config.method.num_rollouts)
        elif fleet_role != "rollout":
            # The fleet's learner or colocated role: iteration 0's experience
            # arrives through the stream, after the v0 weight publish. A
            # rollout role produces on demand in its worker loop.
            model._fleet_bootstrap()
        eval_prompts = eval_prompts if eval_prompts is not None else prompts
    elif dataset is not None:
        samples, rewards = dataset
        if config is None:
            config = default_config("ilql")
        if model_path:
            config.model.model_path = model_path
        if len(samples) != len(rewards):
            raise ValueError(f"Number of samples {len(samples)} should match the number of rewards {len(rewards)}")
        model = get_model(config.model.model_type)(config, device=device, metric_fn=metric_fn, logit_mask=logit_mask)
        orch = get_orchestrator(config.train.orchestrator)(model, split_token=split_token)
        orch.make_experience(samples, rewards)
        if eval_prompts is None:
            bs = config.train.batch_size
            eval_prompts = [model.tokenizer.bos_token] * bs if model.tokenizer is not None else [[0]] * bs
    else:
        raise ValueError("Either reward_fn or dataset must be given")
    model.add_eval_pipeline(PromptPipeline(eval_prompts, model.tokenizer, max_prompt_length=model.prompt_length))
    if getattr(model, "fleet_role", None) == "rollout":
        # The rollout job: the persistent worker loop in place of learn().
        from trlx_tpu_torch.fleet import run_rollout_worker

        run_rollout_worker(model, orch)
        return model
    model.learn()
    return model
