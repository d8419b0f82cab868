"""Soft-prompt PPO (the counterpart of ``trlx_tpu.trainer.ppo_softprompt``):
prompt tuning under PPO.

- The prefix is ``transformer.soft_prompt`` [n_soft_tokens, d_model],
  prepended inside ``TransformerLM`` and sliced back out, so callers see
  their own lengths; with ``initialize_from_vocab`` it starts as the first
  n rows of the token embedding.
- Only the soft prompt and the value head train: the trunk and the LM head
  are frozen by construction (no moments, no gradient into them).
- There is no hydra branch (it could not replay a prefix it never saw): the
  KL reference is the whole model with its INITIAL prefix. The JAX package
  keeps a full frozen copy of every parameter; here the reference shares the
  policy's frozen tensors, which never change, and owns only the initial
  prefix: the same numbers without a second copy of the model (24.2 GB of
  f32 and its 12.1 GB of bf16 copies at GPT-J-6B).
"""

from typing import Dict

import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import build_lm_config, load_or_init_params
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.ppo import PPOTrainer


@register_model("ppo_softprompt")
@register_model("AcceleratePPOSoftpromptModel")
class PPOSoftpromptTrainer(PPOTrainer):
    def get_arch(self, config: TRLConfig) -> LMWithValueHead:
        """The value-head model with ``method.n_soft_tokens`` prefix rows
        and no branch; only ``transformer.soft_prompt`` and ``v_head`` train."""
        m = config.method
        lm_cfg = self.finalize_lm_config(build_lm_config(config).replace(n_soft_tokens=m.n_soft_tokens))
        model = LMWithValueHead(lm_cfg, branch_layer=-1, device=self.device)
        self.load_log["policy"] = load_or_init_params(model, config, self.seeded_generator(1))
        if m.initialize_from_vocab:
            with torch.no_grad():
                model.transformer.soft_prompt.copy_(model.transformer.wte.embedding[: m.n_soft_tokens])
        self.opt_mask = {n for n, _ in model.named_parameters()
                         if n == "transformer.soft_prompt" or n.startswith("v_head.")}
        for name, p in model.named_parameters():
            p.requires_grad_(name in self.opt_mask)
        return model

    def make_extras(self) -> Dict[str, torch.Tensor]:
        """The reference's own tensors: a copy of the initial prefix. Every
        other tensor the reference's logprobs read is frozen and shared with
        the policy (``swapped_params`` swaps in only these)."""
        return {n: p.detach().clone() for n, p in self.model.named_parameters()
                if n in self.opt_mask and not n.startswith("v_head.")}
