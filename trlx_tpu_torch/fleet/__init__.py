"""Disaggregated rollout/learner fleet (the counterpart of
``trlx_tpu.fleet``).

Dedicated rollout and learner JOBS, each its own process or world of
processes (rank 0 of a role does its fleet I/O, ``runner.RoleWorld``),
coupled only through ``train.fleet_dir``: a fault-tolerant episode stream (``stream``), a
versioned weight broadcast (``broadcast``), and per-role heartbeats driving
a degradation ladder (``runner``). Armed by ``method.fleet_disaggregate``;
the per-process role comes from ``TRLX_TPU_FLEET_ROLE`` or
``train.fleet_role``; no role = colocated single-process mode, the bitwise
staleness-0 parity configuration.

``method.fleet_elastic`` generalizes the rollout side to N workers: work is
partitioned into prompt-shard WORK UNITS claimed through an atomic lease
ledger (``leases``), each worker appends to its own stream index, and the
learner's exactly-once intake (``stream.ElasticStreamReader``) dedupes
reclaim races by (work_unit, episode_key). Membership is dynamic: mid-run
join, clean leave and kill are handled.

The rollout side runs the trainer's rollout paths (the engine with its
paged int8 decode and, with ``model.decode_weight_quant``, the W8A16
product) on weights loaded from the broadcast; the learner runs the train
step. The fleet itself is host and filesystem code.
"""

from .broadcast import WeightPublisher, WeightSubscriber, put_leaves
from .leases import Lease, LeaseLedger, WorkerRegistry
from .runner import FleetDegradedExit, FleetLearnerFeed, RoleWorld, fleet_snapshot, run_rollout_worker
from .stream import (
    ElasticStreamReader,
    EpisodeStreamReader,
    EpisodeStreamTimeout,
    EpisodeStreamWriter,
    episode_key,
)
from .topology import (
    FLEET_TRAIN_KNOBS,
    LEARNER_HOST,
    ROLE_COLOCATED,
    ROLE_ENV,
    ROLE_LEARNER,
    ROLE_ROLLOUT,
    ROLLOUT_HOST,
    WORKER_ENV,
    FleetPaths,
    fleet_paths,
    resolve_role,
    role_timeouts,
    validate_fleet_config,
)

__all__ = [
    "ElasticStreamReader",
    "EpisodeStreamReader",
    "EpisodeStreamTimeout",
    "EpisodeStreamWriter",
    "FLEET_TRAIN_KNOBS",
    "FleetDegradedExit",
    "FleetLearnerFeed",
    "FleetPaths",
    "LEARNER_HOST",
    "Lease",
    "LeaseLedger",
    "ROLE_COLOCATED",
    "ROLE_ENV",
    "ROLE_LEARNER",
    "ROLE_ROLLOUT",
    "ROLLOUT_HOST",
    "RoleWorld",
    "WORKER_ENV",
    "WeightPublisher",
    "WeightSubscriber",
    "WorkerRegistry",
    "episode_key",
    "fleet_paths",
    "fleet_snapshot",
    "put_leaves",
    "resolve_role",
    "role_timeouts",
    "run_rollout_worker",
    "validate_fleet_config",
]
