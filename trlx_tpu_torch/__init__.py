"""trlx_tpu_torch: the PyTorch/CUDA port of trlx_tpu.

The package mirrors ``trlx_tpu``'s module layout (``data``, ``models``,
``ops``, ``pipeline``, ``orchestrator``, ``trainer``) and imports neither JAX
nor anything of ``trlx_tpu``. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; the hand-written Hopper kernels live under
``csrc/`` and are built with ``nvcc`` at first use.

Online PPO runs end to end through ``trlx_tpu_torch.train(reward_fn=...)``:
prompts → prefill + KV-cache decode → host reward → frozen-branch scoring →
rollout store → ``learn()`` (PPO loss, backward through the flash and
fused-logprob kernels, AdamW) → the next rollouts → ``evaluate()``.
"""

__version__ = "0.2.0"

from trlx_tpu_torch.trainer.api import train  # noqa: E402,F401
