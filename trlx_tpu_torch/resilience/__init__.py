"""Resilience (the counterpart of ``trlx_tpu.resilience``): the train
step's non-finite guard (``guard``), checkpoint hardening (``checkpoint``),
the divergence watchdog with checkpoint rollback (``watchdog``; the
trainer restores, decays the LR and resumes), the reward call's retry and
timeout (``retry``), the fault drills (``faults``), and across processes
the heartbeats, the collective guard and the consistency guard
(``distributed``). The fleet's fault kinds wait for the fleet."""

from trlx_tpu_torch.resilience.checkpoint import CheckpointError, corrupt_checkpoint, verify_checkpoint  # noqa: F401
from trlx_tpu_torch.resilience.faults import FaultInjected, FaultPlan, poison_nan  # noqa: F401
from trlx_tpu_torch.resilience.guard import TrainingDiverged, all_finite, guarded_update  # noqa: F401
from trlx_tpu_torch.resilience.retry import call_with_retries  # noqa: F401
from trlx_tpu_torch.resilience.watchdog import DivergenceWatchdog  # noqa: F401
