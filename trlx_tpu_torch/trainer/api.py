"""``train()`` dispatch (the counterpart of ``trlx_tpu.trainer.api``): a
``reward_fn`` runs online PPO — trainer, ``PromptPipeline``, orchestrator,
the first ``make_experience``, the eval pipeline, ``learn()``; a ``dataset``
of (token-array samples, rewards) runs offline ILQL — trainer,
``OfflineOrchestrator.make_experience``, the eval pipeline, ``learn()``. The
on-device reward model and text samples (a tokenizer) are not ported yet and
raise."""

from typing import Callable, List, Optional, Tuple

# Importing these modules populates the registries.
import trlx_tpu_torch.orchestrator.offline_orchestrator  # noqa: F401
import trlx_tpu_torch.orchestrator.ppo_orchestrator  # noqa: F401
import trlx_tpu_torch.pipeline.prompt_pipeline  # noqa: F401
import trlx_tpu_torch.trainer.ilql  # noqa: F401
import trlx_tpu_torch.trainer.ppo  # noqa: F401
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.orchestrator import get_orchestrator
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
from trlx_tpu_torch.trainer import get_model


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
    tests). Prompts and samples are token-id lists or arrays (tokenizers are
    not ported), and a ``config`` is required: the JAX package's default
    configs name a tokenizer."""
    if config is not None and config.model.has_reward_model:
        raise NotImplementedError("the on-device reward model is not ported yet")
    if reward_fn is None and dataset is None:
        raise ValueError("Either reward_fn or dataset must be given")
    if reward_fn is None:
        samples, rewards = dataset
        if any(isinstance(s, str) for s in samples):
            raise NotImplementedError("text samples need a tokenizer (text mode is not ported yet): "
                                      "pass token-id arrays")
    if config is None:
        raise ValueError("train() needs a config: the default configs name a tokenizer, which is not ported yet")
    if model_path:
        config.model.model_path = model_path

    if reward_fn is not None:
        if prompts is None:
            raise ValueError("train() needs token-id prompts: default prompts need a tokenizer")
        model = get_model(config.model.model_type)(
            config, device=device, reward_fn=reward_fn, metric_fn=metric_fn, logit_mask=logit_mask
        )
        pipeline = PromptPipeline(prompts, None, max_prompt_length=model.prompt_length)
        orch = get_orchestrator(config.train.orchestrator)(
            model, pipeline, reward_fn=reward_fn, metric_fn=metric_fn, chunk_size=config.method.chunk_size
        )
        orch.make_experience(config.method.num_rollouts)
        eval_prompts = eval_prompts if eval_prompts is not None else prompts
    else:
        if len(samples) != len(rewards):
            raise ValueError(f"Number of samples {len(samples)} should match the number of rewards {len(rewards)}")
        model = get_model(config.model.model_type)(config, device=device, metric_fn=metric_fn, logit_mask=logit_mask)
        orch = get_orchestrator(config.train.orchestrator)(model, split_token=split_token)
        orch.make_experience(samples, rewards)
        eval_prompts = eval_prompts if eval_prompts is not None else [[0]] * config.train.batch_size
    model.add_eval_pipeline(PromptPipeline(eval_prompts, None, max_prompt_length=model.prompt_length))
    model.learn()
    return model
