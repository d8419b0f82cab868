"""Fleet topology: role resolution, construction-time validation, and the
shared-directory layout that couples the disaggregated jobs (the
counterpart of ``trlx_tpu.fleet.topology``).

The disaggregation model (the LlamaRL / PipelineRL shape): the rollout side
and the learner side run as SEPARATE processes, each with its own card (or
its own torch.distributed world), never sharing a process group. Coupling
is entirely through ``train.fleet_dir``:

- episodes stream learner-ward through a bounded queue of atomic ``.npz``
  batches + a line-atomic index (``stream``);
- versioned weights broadcast rollout-ward through atomic ``.npz``
  snapshots + an append-only broadcast log (``broadcast``);
- liveness flows both ways through per-role heartbeat files (the
  ``resilience.distributed.Heartbeat`` wire format the collective guard's
  stall report reads).

Two worlds have no shared collectives at all, so each side may freely use
threads, pipelining and the continuous-batching engine, and a dead peer can
never wedge a collective, only starve a queue, which is detectable and
drainable (``runner``'s degradation ladder).

Role resolution: ``TRLX_TPU_FLEET_ROLE`` wins over ``train.fleet_role`` so
one config file can serve both jobs of a drill. No role with
``method.fleet_disaggregate`` set = COLOCATED mode: both roles run serially
in one process through the real transports (the bitwise staleness-0 parity
path).

A role world of several processes (JAX's multi-host role submeshes) is not
ported: the transports would have to be limited to one process of the role.
``validate_fleet_config`` refuses it by name (ROADMAP §A12b).
"""

import json
import os
from dataclasses import dataclass
from typing import Optional

from trlx_tpu_torch.parallel.mesh import world_size
from trlx_tpu_torch.utils.jsonl import read_jsonl


def read_jsonl_or_empty(path: str) -> list:
    """Torn-tail-tolerant jsonl read that also tolerates ABSENCE: every
    fleet log starts empty and appears on first append."""
    return read_jsonl(path) if os.path.exists(path) else []


ROLE_ENV = "TRLX_TPU_FLEET_ROLE"
# Elastic fleet: this worker's stable id (int). Unset = auto-assign the
# lowest free slot in <fleet_dir>/workers via O_EXCL registration.
WORKER_ENV = "TRLX_TPU_FLEET_WORKER"
ROLE_ROLLOUT = "rollout"
ROLE_LEARNER = "learner"
ROLE_COLOCATED = "colocated"  # internal: fleet on, no per-process role

# Heartbeat file indices inside <fleet_dir>/heartbeats/. Each role is rank 0
# of its own world, so the rank would collide both roles onto one file: the
# fleet heartbeat directory keys files by role instead.
LEARNER_HOST = 0
ROLLOUT_HOST = 1
ROLE_HOSTS = {ROLE_LEARNER: LEARNER_HOST, ROLE_COLOCATED: LEARNER_HOST, ROLE_ROLLOUT: ROLLOUT_HOST}

# Every train.* fleet knob, for the construction-time validation sweep.
FLEET_TRAIN_KNOBS = (
    "fleet_role",
    "fleet_dir",
    "fleet_episode_timeout",
    "fleet_stream_retries",
    "fleet_stream_backoff",
    "fleet_heartbeat_timeout",
    "fleet_broadcast_deadline",
    "fleet_lease_ttl",
)


@dataclass(frozen=True)
class FleetPaths:
    """The on-disk contract between the jobs, derived from one root.

    Everything under the root is either written atomically (tmp + rename:
    episode batches, weight snapshots, latest pointer, cursor, abort) or
    append-only line-atomic jsonl (stream index, broadcast log, event log),
    so a reader never observes a torn artifact."""

    root: str

    @property
    def episodes_dir(self) -> str:
        return os.path.join(self.root, "episodes")

    @property
    def weights_dir(self) -> str:
        return os.path.join(self.root, "weights")

    @property
    def heartbeats_dir(self) -> str:
        return os.path.join(self.root, "heartbeats")

    @property
    def leases_dir(self) -> str:
        # Elastic work-unit lease ledger (leases.py): one O_EXCL-created
        # generation file per (unit, claim generation).
        return os.path.join(self.root, "leases")

    @property
    def workers_dir(self) -> str:
        # Elastic worker registry (leases.py): worker_<k>.json membership
        # records, O_EXCL-claimed ids, status active/left.
        return os.path.join(self.root, "workers")

    @property
    def stream_index(self) -> str:
        # Append-only episode index: {seq, file, n, weight_version, t}.
        # Worker 0's index (and the single-worker index); elastic peers
        # write stream.w<k>.jsonl (stream_index_for).
        return os.path.join(self.root, "stream.jsonl")

    def stream_index_for(self, worker: int) -> str:
        """Per-worker episode index. Worker 0 keeps the single-worker name
        ``stream.jsonl``, so the elastic layout's N=1 case is the
        single-worker layout."""
        if int(worker) == 0:
            return self.stream_index
        return os.path.join(self.root, f"stream.w{int(worker):03d}.jsonl")

    def stream_indexes(self) -> dict:
        """Every stream index present on disk, keyed by worker id: the
        elastic learner's scan set (workers may appear mid-run, so this is
        re-globbed per scan, not cached)."""
        out = {}
        if os.path.exists(self.stream_index):
            out[0] = self.stream_index
        try:
            names = os.listdir(self.root)
        except OSError:
            names = []
        for name in names:
            if name.startswith("stream.w") and name.endswith(".jsonl"):
                try:
                    out[int(name[len("stream.w"):-len(".jsonl")])] = os.path.join(self.root, name)
                except ValueError:
                    continue
        return out

    @property
    def broadcast_log(self) -> str:
        # Append-only weight-publish log: {ordinal, version, file, status, t}.
        return os.path.join(self.root, "broadcast.jsonl")

    @property
    def latest_pointer(self) -> str:
        # Atomic pointer to the freshest published snapshot.
        return os.path.join(self.root, "weights_latest.json")

    @property
    def cursor(self) -> str:
        # Learner's consume cursor: the staleness gate's denominator.
        return os.path.join(self.root, "learner_cursor.json")

    @property
    def abort(self) -> str:
        # Coordinated-shutdown marker: the learner writes it on completion or
        # degraded exit (NOT on preemption); the worker polls it and exits 0.
        return os.path.join(self.root, "abort.json")

    @property
    def events(self) -> str:
        # Authoritative fleet event log (degradation transitions, drains,
        # staleness-cap exits): what the drills assert on.
        return os.path.join(self.root, "fleet_events.jsonl")

    def ensure(self) -> "FleetPaths":
        for d in (self.root, self.episodes_dir, self.weights_dir, self.heartbeats_dir):
            os.makedirs(d, exist_ok=True)
        return self

    def ensure_elastic(self) -> "FleetPaths":
        """Elastic additions on top of ensure(): the lease ledger and the
        worker registry. Kept separate so a non-elastic fleet_dir keeps the
        single-worker layout."""
        self.ensure()
        for d in (self.leases_dir, self.workers_dir):
            os.makedirs(d, exist_ok=True)
        return self

    def episode_file(self, seq: int, worker: int = 0) -> str:
        # Worker 0 keeps the single-worker name (batch_<seq>.npz); elastic
        # peers prefix their id so N writers never collide on a basename.
        if int(worker) == 0:
            return os.path.join(self.episodes_dir, f"batch_{int(seq):06d}.npz")
        return os.path.join(self.episodes_dir, f"w{int(worker):03d}_batch_{int(seq):06d}.npz")

    def weight_file(self, ordinal: int) -> str:
        # Keyed by ordinal, not version: a resumed learner re-publishes its
        # restored iter_count as a fresh ordinal, and versions may repeat.
        return os.path.join(self.weights_dir, f"weights_{int(ordinal):08d}.npz")

    def read_abort(self) -> Optional[dict]:
        """The abort record, or None. Torn-read tolerant (atomic writer, but
        the file may appear between existence check and open)."""
        try:
            with open(self.abort, "r") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


def fleet_paths(train_cfg) -> FleetPaths:
    """Resolve the shared fleet directory: ``train.fleet_dir`` or
    ``<checkpoint_dir>/fleet``. Disaggregated jobs keep PRIVATE
    checkpoint_dirs (each world checkpoints alone) and share only this."""
    root = train_cfg.fleet_dir or os.path.join(train_cfg.checkpoint_dir, "fleet")
    return FleetPaths(root=root)


def resolve_role(config) -> Optional[str]:
    """This process's fleet role, or None when fleet mode is off entirely.

    ``TRLX_TPU_FLEET_ROLE`` wins over ``train.fleet_role`` (the same
    env-over-config convention as TRLX_TPU_FAULTS) so a drill launches both
    jobs from one config. Fleet armed with no role = COLOCATED."""
    if not getattr(config.method, "fleet_disaggregate", False):
        return None
    role = os.environ.get(ROLE_ENV, "") or config.train.fleet_role or ROLE_COLOCATED
    return role


def validate_fleet_config(config) -> Optional[str]:
    """Construction-time fleet validation, called from PPOTrainer.__init__
    so every misconfiguration is a ValueError at trainer construction, never
    a mid-run raise. The messages are the JAX package's, word for word.

    Returns the resolved role (None / 'rollout' / 'learner' / 'colocated').
    A role world of several processes raises NotImplementedError (§A12b)."""
    t = config.train
    env_role = os.environ.get(ROLE_ENV, "")
    set_knobs = [k for k in FLEET_TRAIN_KNOBS if getattr(t, k, None)]
    if not getattr(config.method, "fleet_disaggregate", False):
        if getattr(config.method, "fleet_elastic", False):
            raise ValueError(
                "method.fleet_elastic requires method.fleet_disaggregate: "
                "the elastic N-worker fleet generalizes the disaggregated "
                "rollout side — there is no elastic mode without the "
                "episode-stream/weight-broadcast transports."
            )
        if set_knobs or env_role:
            knobs = [f"train.{k}" for k in set_knobs]
            if env_role:
                knobs.append(f"{ROLE_ENV}={env_role!r}")
            raise ValueError(
                "fleet knobs are set but method.fleet_disaggregate is off: "
                + ", ".join(knobs)
                + ". Set method.fleet_disaggregate=true to run the "
                "disaggregated rollout/learner fleet (trlx_tpu/fleet), or "
                "clear these knobs — they are ignored otherwise, which is "
                "never what a fleet drill wants."
            )
        return None

    role = resolve_role(config)
    if role not in (ROLE_ROLLOUT, ROLE_LEARNER, ROLE_COLOCATED):
        raise ValueError(
            f"unknown fleet role {role!r} (from {ROLE_ENV} or "
            f"train.fleet_role) — expected '{ROLE_ROLLOUT}', "
            f"'{ROLE_LEARNER}', or unset (colocated single-process mode)."
        )
    if world_size() > 1 and not env_role and not getattr(t, "fleet_role", None):
        raise ValueError(
            "method.fleet_disaggregate in a multi-process world needs an "
            f"explicit role ({ROLE_ENV} or train.fleet_role): every process "
            "in one jax.distributed world must run the SAME role — the "
            "colocated default would make this world both producer and "
            "consumer. Give each role its own world (possibly multi-host) "
            "and set the role explicitly."
        )
    if world_size() > 1:
        raise NotImplementedError(
            f"not ported yet: a fleet role ({role!r}) over a world of {world_size()} processes (ROADMAP §A12b): "
            "the transports would run on every rank of the role. Run each role as one process."
        )
    if getattr(config.method, "rollout_overlap", False):
        raise ValueError(
            "method.rollout_overlap (in-process producer thread) and "
            "method.fleet_disaggregate (cross-job episode stream) are "
            "mutually exclusive — the fleet already overlaps rollouts with "
            "training across jobs; method.max_staleness is the coupling "
            "knob for both. Disable one."
        )
    env_worker = os.environ.get(WORKER_ENV, "")
    if not getattr(config.method, "fleet_elastic", False):
        if env_worker:
            raise ValueError(
                f"{WORKER_ENV}={env_worker!r} is set but method.fleet_elastic "
                "is off — worker ids only exist in the elastic N-worker "
                "fleet. Set method.fleet_elastic=true or unset the env var."
            )
        if getattr(t, "fleet_lease_ttl", 0):
            raise ValueError(
                "train.fleet_lease_ttl is set but method.fleet_elastic is "
                "off — the lease ledger only exists in the elastic N-worker "
                "fleet. Set method.fleet_elastic=true or clear the knob."
            )
    if env_worker:
        try:
            if int(env_worker) < 0:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"{WORKER_ENV}={env_worker!r} must be a non-negative "
                "integer worker id (or unset for auto-assignment)."
            ) from None
    return role


def role_timeouts(t) -> dict:
    """Effective fleet timing knobs with the documented 0-defaults resolved
    (the config keeps raw zeros)."""
    heartbeat_interval = float(t.heartbeat_interval or 0.5)
    return {
        "heartbeat_interval": heartbeat_interval,
        "episode_timeout": float(t.fleet_episode_timeout or 60.0),
        "stream_retries": int(t.fleet_stream_retries or 2),
        "stream_backoff": float(t.fleet_stream_backoff or 0.5),
        "heartbeat_timeout": float(t.fleet_heartbeat_timeout or max(10.0 * heartbeat_interval, 10.0)),
        "broadcast_deadline": float(t.fleet_broadcast_deadline or t.collective_deadline or 60.0),
        # Elastic work-unit leases: unrenewed past this, a peer may reclaim.
        "lease_ttl": float(getattr(t, "fleet_lease_ttl", 0.0) or max(6.0 * heartbeat_interval, 3.0)),
    }
