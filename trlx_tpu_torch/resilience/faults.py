"""Config/env-driven fault injection (the counterpart of
``trlx_tpu.resilience.faults``): the drills that make the resilience
layer verifiable without a real eviction.

A ``FaultPlan`` is parsed from ``train.fault_plan`` (or the
``TRLX_TPU_FAULTS`` environment variable, which wins) as a comma-separated
list of ``kind@tick`` entries, e.g.
``TRLX_TPU_FAULTS="nan_grad@3,reward_exc@2,ckpt_corrupt@1,sigterm@5"``.
Each entry fires exactly once when its site reaches the tick. The kinds
this package fires in one process (``SINGLE_PROCESS_KINDS``):

- ``nan_grad@N``: the Nth train step's batch is NaN-poisoned (its float
  tensors; token ids stay) → the non-finite guard skips the update;
- ``reward_exc@N`` / ``reward_hang@N``: the Nth ``reward_fn`` call raises /
  sleeps three times ``train.reward_fn_timeout`` → the retry wrapper;
- ``ckpt_corrupt@N``: the Nth completed save has its largest file
  truncated after ``latest.txt`` names it → restore falls back;
- ``sigterm@N``: SIGTERM is sent to this process after step N → the
  preemption save;
- ``slow_step@N``: the host stalls ``TRLX_TPU_SLOW_STEP_SECONDS`` (default
  1) between step N's dispatch and its log-boundary sync → the anomaly
  detector's incident;
- ``reward_drift@N`` / ``entropy_collapse@N``: from reward call / train
  step N on, the health monitor OBSERVES shifted rewards / scaled entropy
  (training never sees them) → the health detectors' WARN → CRIT path;
- ``nan_layer@N``: the Nth train step's batch is NaN-poisoned as for
  ``nan_grad`` AND the tap ``block_{min(N, n_layer - 1)}`` is latched for
  graftnum's bisector (``observability.numerics``), whose re-forward must
  name that block first.

The multi-process kinds (``MULTI_PROCESS_KINDS``) fire per PROCESS, each
rank reading its own ``TRLX_TPU_FAULTS``, after the train step N:

- ``host_hang@N``: this rank sleeps ``TRLX_TPU_HANG_SECONDS`` (default
  3600), its heartbeat thread still writing → the others' collective guard
  ends them with ``CollectiveTimeout`` (exit 117), naming this rank;
- ``host_kill@N``: this rank dies at once (``os._exit(1)``) → the same, and
  torn-file tolerance on resume;
- ``slow_host@N``: this rank stalls ``TRLX_TPU_SLOW_SECONDS`` (default 2)
  → a straggler in the heartbeat files, under the deadline;
- ``host_desync@N``: this rank's copy of a replicated parameter is skewed
  → the consistency guard's ``HostDesync`` on every rank;
- ``mid_decode_host_kill@N``: this rank dies at once (``os._exit(1)``) at
  the Nth sync tick of the rollout engine's loop, with slots mid-decode
  (``PPOOrchestrator``'s engine path) → the others' guarded decode sync
  ends them with exit 117 and their slot states in the incident bundle.

The fleet kinds (``FLEET_KINDS``, the disaggregated rollout/learner jobs
of ``trlx_tpu_torch.fleet``) fire per PROCESS, each role reading its own
``TRLX_TPU_FAULTS``:

- ``rollout_host_kill@N``: the rollout worker dies (``os._exit(1)``) right
  after streaming episode batch N → the learner triages the role DEAD,
  drains the queued batches at elevated staleness under ``fleet/degraded``
  and exits cleanly;
- ``episode_stream_stall@N``: the stream writer sleeps
  ``TRLX_TPU_STREAM_STALL_SECONDS`` (default 3600) INSTEAD of writing batch
  N, its heartbeat thread still beating → triaged STALLED, not dead;
- ``broadcast_timeout@N``: the learner SKIPS publishing ordinal N → a
  worker waiting for it outlives ``train.fleet_broadcast_deadline`` and
  exits 117;
- ``weight_push_torn@N``: ordinal N's pointer flips but its file is
  truncated → subscribers reject it and keep the version they hold;
- ``version_switch_storm@N``: from the worker's Nth in-flight weight poll
  on, the held latest is re-pushed into the running engine every sync for
  ``TRLX_TPU_SWITCH_STORM_PUSHES`` (default 8) polls → the engine coalesces;
- ``worker_kill_mid_lease@N`` / ``slow_worker_reclaim@N`` /
  ``worker_join_mid_run@N`` (elastic workers, keyed on the unit or cursor
  THRESHOLD: each fires once, at the first opportunity at or past N): die
  holding a lease, oversleep the lease TTL holding one and produce anyway,
  or defer registration until the learner's cursor reaches N.

A kind this package parses but does not fire would be listed in
``UNFIRED_KINDS``, which the trainer refuses; every kind fires now.
"""

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import List

import torch

SINGLE_PROCESS_KINDS = ("nan_grad", "reward_exc", "reward_hang", "ckpt_corrupt", "sigterm", "slow_step",
                        "reward_drift", "entropy_collapse", "nan_layer")
MULTI_PROCESS_KINDS = ("host_hang", "host_kill", "slow_host", "host_desync", "mid_decode_host_kill")
FLEET_KINDS = ("rollout_host_kill", "episode_stream_stall", "broadcast_timeout", "weight_push_torn",
               "version_switch_storm", "worker_kill_mid_lease", "slow_worker_reclaim", "worker_join_mid_run")
UNFIRED_KINDS = {}
KINDS = SINGLE_PROCESS_KINDS + MULTI_PROCESS_KINDS + FLEET_KINDS + tuple(UNFIRED_KINDS)

_ENTRY_RE = re.compile(r"^([a-z_]+)@(\d+)$")


class FaultInjected(RuntimeError):
    """Raised by an injected fault (distinguishable from organic failures)."""


@dataclass
class _Fault:
    kind: str
    at: int
    fired: bool = False


@dataclass
class FaultPlan:
    faults: List[_Fault] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults = []
        for entry in filter(None, (p.strip() for p in (spec or "").split(","))):
            m = _ENTRY_RE.match(entry)
            if not m or m.group(1) not in KINDS:
                raise ValueError(f"bad fault spec entry {entry!r} — expected kind@step with kind one of {KINDS}")
            faults.append(_Fault(m.group(1), int(m.group(2))))
        return cls(faults)

    @classmethod
    def from_env_or_config(cls, config_spec: str = "") -> "FaultPlan":
        """The environment wins over the config, so a drill can be bolted
        onto any run command."""
        return cls.parse(os.environ.get("TRLX_TPU_FAULTS", config_spec or ""))

    def fire(self, kind: str, tick) -> bool:
        """True exactly once per matching ``kind@tick`` entry."""
        for f in self.faults:
            if not f.fired and f.kind == kind and f.at == int(tick):
                f.fired = True
                return True
        return False

    def fire_at_or_after(self, kind: str, tick) -> bool:
        """True exactly once per entry, on the first call whose tick is >=
        the entry's ``@N``."""
        for f in self.faults:
            if not f.fired and f.kind == kind and int(tick) >= f.at:
                f.fired = True
                return True
        return False

    def pending_at(self, kind: str):
        """The ``@N`` of the first unfired entry of ``kind``, or None."""
        for f in self.faults:
            if not f.fired and f.kind == kind:
                return f.at
        return None

    def unfired_kinds(self) -> List[str]:
        """The kinds of this plan that this package does not fire."""
        return sorted({f.kind for f in self.faults if f.kind in UNFIRED_KINDS})

    def __bool__(self) -> bool:
        return bool(self.faults)

    def __repr__(self) -> str:
        entries = ",".join(f"{f.kind}@{f.at}{'(fired)' if f.fired else ''}" for f in self.faults)
        return f"FaultPlan({entries})"


def poison_nan(batch):
    """NaN-poison every floating tensor of a batch (a tensor, a dict, a
    list / tuple, or a dataclass of them): each is multiplied by NaN.
    Integer tensors (token ids, masks) and anything else pass through."""
    if torch.is_tensor(batch):
        return batch * float("nan") if batch.is_floating_point() else batch
    if isinstance(batch, dict):
        return {k: poison_nan(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(poison_nan(v) for v in batch)
    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return dataclasses.replace(batch, **{f.name: poison_nan(getattr(batch, f.name))
                                             for f in dataclasses.fields(batch) if f.init})
    return batch
