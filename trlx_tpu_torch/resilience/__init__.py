"""Resilience (the counterpart of ``trlx_tpu.resilience``): the train
step's non-finite guard and checkpoint hardening (``checkpoint``). The
watchdog, heartbeats and fault plans are not ported yet; the trainer
refuses their knobs."""

from trlx_tpu_torch.resilience.checkpoint import CheckpointError  # noqa: F401
