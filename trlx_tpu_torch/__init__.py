"""trlx_tpu_torch: the PyTorch/CUDA port of trlx_tpu.

The package mirrors ``trlx_tpu``'s module layout (``data``, ``models``,
``ops``, ``pipeline``, ``orchestrator``, ``trainer``) and imports neither JAX
nor anything of ``trlx_tpu``. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; the hand-written Hopper kernels live under
``csrc/`` and are built with ``nvcc`` at first use.

Online PPO runs end to end through ``trlx_tpu_torch.train(reward_fn=...)``:
prompts → prefill + KV-cache decode → host reward → frozen-branch scoring →
rollout store → ``learn()`` (PPO loss, backward through the flash and
fused-logprob kernels, AdamW) → the next rollouts → ``evaluate()``. The model
may come from a local HF directory (``model_path``) and go back to one
(``save_pretrained``), prompts may be text (``model.tokenizer_path``), and
an on-device reward model (``model.reward_model_path``) may score the
rollouts in place of ``reward_fn``.
"""

__version__ = "0.2.0"



def __getattr__(name):
    # ``train`` is imported on first use, so a subpackage that needs no
    # torch (``analysis``, the linter) imports without it.
    if name == "train":
        from trlx_tpu_torch.trainer.api import train

        return train
    raise AttributeError(f"module 'trlx_tpu_torch' has no attribute {name!r}")
