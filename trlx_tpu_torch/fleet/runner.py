"""Fleet roles: the persistent rollout worker and the learner's episode feed
(the counterpart of ``trlx_tpu.fleet.runner``).

Two independent worlds (``topology``), three transports (episode stream,
weight broadcast, heartbeats), one coupling knob (``method.max_staleness``).
The schedule both sides enforce:

- the worker may produce stream batch ``seq`` only when the learner's
  cursor allows it (``staleness_gate_open(seq, consumed, S)``, the
  predicate the in-process RolloutProducer gates on), and only from a
  weight snapshot with publish ordinal >= ``seq - S``;
- the learner publishes the post-train weights BEFORE advancing its cursor,
  and the worker reads cursor-then-latest, so a just-opened gate always
  sees the version that opened it.

At S=0 this is the serial schedule (produce n from weights n, train on n,
publish n+1, ...), which is why the staleness-0 run equals the serial run
bit for bit. At S>0 the worker runs ahead and every consumed batch's
realized staleness (publish ordinals elapsed since its version) is written
into the store's staleness column.

The rollout side's weights (``fleet_snapshot``): broadcast bytes are loaded
into a rollout-side module, never into the learner's live module. In the
colocated learner that is a copy of the policy module made at the first
load; a rollout worker, which never trains, loads into its own policy
module. The module's bf16 compute copies and, with
``model.decode_weight_quant``, its int8 decode copies are rebuilt from the
loaded masters once per version (``models.lm.refresh_weight_copies``). With
in-flight updates a push never loads into the module the running phase
scores with (its start snapshot): a second module is made at the first
such push, and the two alternate, so a phase's scoring reads the weights
it started from, as the JAX package's phase snapshot does.

Degradation ladder: a learner whose episode wait exhausts its
timeout/retry/backoff budget triages the rollout role by heartbeat: DEAD
(file age), STALLED (file fresh, progress frozen), or merely slow (keep
waiting). Dead or stalled flips the feed to ``degraded``: the /healthz fleet
block and the ``fleet/degraded`` gauge flip at ENTRY, queued batches are
drained at their elevated staleness, and when the stream runs dry (or a
batch exceeds the staleness cap) the feed raises ``FleetDegradedExit``: the
trainer checkpoints (the rollback point), writes ``abort.json``
(coordinated shutdown: a stalled-but-alive worker reads it and exits 0),
and winds down instead of hanging.

With graftnum armed (``observability.numerics``) each publish records the
published weights' int8 round-trip error, and each adoption on the rollout
side records the handoff's (``record_weight_handoff``), tagged with the
version.
"""

import copy
import json
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from trlx_tpu_torch.models.lm import refresh_weight_copies
from trlx_tpu_torch.observability import numerics as obs_numerics
from trlx_tpu_torch.pipeline.overlap import staleness_gate_open
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.resilience.checkpoint import atomic_write_json
from trlx_tpu_torch.resilience.distributed import Heartbeat, read_heartbeats
from trlx_tpu_torch.utils.jsonl import append_record

from .broadcast import WeightPublisher, WeightSubscriber, put_leaves
from .leases import LeaseLedger, WorkerRegistry
from .stream import ElasticStreamReader, EpisodeStreamReader, EpisodeStreamTimeout, EpisodeStreamWriter
from .topology import (
    LEARNER_HOST,
    ROLE_COLOCATED,
    ROLE_ROLLOUT,
    ROLLOUT_HOST,
    WORKER_ENV,
    FleetPaths,
    fleet_paths,
    read_jsonl_or_empty,
    role_timeouts,
)


class FleetDegradedExit(RuntimeError):
    """Coordinated fleet shutdown: the learner has drained what it can and
    must stop consuming. Carries the triage verdict for the event log."""

    def __init__(self, reason: str, triage: str = "", detail: str = ""):
        super().__init__(f"fleet degraded exit: {reason}" + (f" ({detail})" if detail else ""))
        self.reason = reason
        self.triage = triage
        self.detail = detail


# ------------------------------------------------------- rollout-side weights


def published_params(module: nn.Module):
    """The broadcast's leaves, in their fixed order: every parameter of the
    policy module (trunk masters, trainable or frozen, and the heads)."""
    return list(module.named_parameters())


class _FleetModule:
    """One version held by a rollout-side module: the ``snapshot["weights"]``
    the trainer's rollout paths read (``.module``, ``adopt()``)."""

    def __init__(self, module: nn.Module, version: int):
        self.module = module
        self.version = int(version)

    def adopt(self) -> int:
        return self.version


class FleetWeightSet:
    """The modules broadcast bytes load into (see the module docstring).
    ``last_h2d_s`` is the last load's host-to-device seconds (with the
    copies' rebuild)."""

    def __init__(self, trainer, own_module: bool):
        self.live = trainer.model
        self.modules = [trainer.model] if own_module else []
        self.last_h2d_s = 0.0

    def _new_module(self) -> nn.Module:
        """A copy of the policy module with tensors of its own. Each
        parameter keeps the live one's ``requires_grad``: no optimizer holds
        them and rollouts run without grad, but the flag picks the
        algorithm of some products (ATen folds a batched product into one
        matrix product depending on it), so the copy computes what the live
        module computes, bit for bit."""
        memo = {}
        for p in self.live.parameters():
            memo[id(p)] = nn.Parameter(torch.empty_like(p, memory_format=torch.contiguous_format),
                                       requires_grad=p.requires_grad)
        return copy.deepcopy(self.live, memo)

    @torch.no_grad()
    def load(self, host_leaves, version: int, avoid: Optional[nn.Module] = None) -> _FleetModule:
        target = next((m for m in self.modules if m is not avoid), None)
        if target is None:
            target = self._new_module()
            self.modules.append(target)
        t0 = time.perf_counter()
        put_leaves(published_params(target), host_leaves)
        refresh_weight_copies(target)
        if next(target.parameters()).is_cuda:
            torch.cuda.synchronize()
        self.last_h2d_s = time.perf_counter() - t0
        return _FleetModule(target, version)


def fleet_snapshot(trainer, host_leaves, version: int, avoid: Optional[dict] = None) -> dict:
    """A rollout snapshot (the ``_rollout_snapshot`` contract: ``{"version",
    "weights"}``) from broadcast byte-leaves, loaded into a rollout-side
    module other than ``avoid``'s (the running phase's snapshot). The frozen
    reference branch is the trainer's own ``extras`` (it never trains, and
    both worlds build it identically from the same seed). Bitwise: npz
    bytes → device is a pure transfer."""
    weights = trainer._fleet_weights
    if weights is None:
        weights = trainer._fleet_weights = FleetWeightSet(trainer, own_module=trainer.fleet_role == ROLE_ROLLOUT)
    held = weights.load(host_leaves, version, avoid=None if avoid is None else avoid["weights"].module)
    if obs_numerics.enabled():
        obs_numerics.record_weight_handoff(held.module, version=version)
    return {"version": int(version), "weights": held}


def _read_cursor(paths: FleetPaths) -> int:
    """The learner's consume cursor (count of consumed seqs).

    MISSING file = fresh fleet: 0. A PRESENT-but-unparseable file (a torn
    write or read) must NOT read as 0: a restarted learner would silently
    re-train on every streamed batch. Fall back to the highest indexed unit
    or seq + 1 instead, over every stream index: at-most-once rather than
    at-least-once."""
    try:
        with open(paths.cursor, "r") as f:
            raw = f.read()
    except OSError:
        return 0
    try:
        return int(json.loads(raw)["consumed"])
    except (ValueError, KeyError, TypeError):
        best = -1
        for index_path in paths.stream_indexes().values() or [paths.stream_index]:
            for r in read_jsonl_or_empty(index_path):
                best = max(best, int(r.get("unit", r["seq"])))
        return 1 + best


def _event(paths: FleetPaths, role: str, event: str, **fields):
    rec = {"t": time.time(), "role": role, "event": event}
    rec.update(fields)
    append_record(paths.events, rec)


def _hold(trainer, paths, subscriber, latest: dict, leaves, event: str, avoid=None, **fields) -> dict:
    """A worker takes a loaded broadcast: the snapshot (``fleet_snapshot``),
    the learner's adaptive KL coefficient in lockstep with the weights (it
    shapes rollout rewards), and an event with the load's seconds."""
    snapshot = fleet_snapshot(trainer, leaves, latest["version"], avoid=avoid)
    if "kl_coef" in latest:
        trainer.kl_ctl.value = float(latest["kl_coef"])
    _event(paths, ROLE_ROLLOUT, event, ordinal=int(latest["ordinal"]), version=snapshot["version"], **fields,
           load_s=subscriber.last_load_s, h2d_s=trainer._fleet_weights.last_h2d_s)
    return snapshot


def _stop_heartbeats(heartbeat, trainer):
    heartbeat.stop()
    if trainer.heartbeat is not None:
        # The worker path never runs learn(): the trainer's own heartbeat
        # thread is joined here instead.
        trainer.heartbeat.stop()


# --------------------------------------------------------- rollout worker


def run_rollout_worker(trainer, orch, num_rollouts: Optional[int] = None):
    """The persistent rollout job: wait at the staleness gate, hold the
    newest eligible weights, generate one experience phase, stream it.

    Runs INSTEAD of ``learn()`` when this process's fleet role is
    ``rollout`` (``trainer.api``). Exits 0 on ``abort.json``, 117 through
    the collective guard if the broadcast starves past
    ``train.fleet_broadcast_deadline``, and abruptly (``os._exit(1)``) on
    the ``rollout_host_kill`` fault. With ``method.fleet_elastic`` the worker
    joins the N-worker lease-claiming loop instead."""
    if trainer.config.method.fleet_elastic:
        return _run_elastic_worker(trainer, orch, num_rollouts)
    t = trainer.config.train
    knobs = role_timeouts(t)
    paths = fleet_paths(t).ensure()
    S = trainer.max_staleness
    n_roll = int(num_rollouts or trainer.config.method.num_rollouts)
    heartbeat = Heartbeat(paths.heartbeats_dir, knobs["heartbeat_interval"], rank=ROLLOUT_HOST)
    heartbeat.start()
    writer = EpisodeStreamWriter(paths, fault_plan=trainer.fault_plan)
    subscriber = WeightSubscriber(paths)
    _event(paths, ROLE_ROLLOUT, "worker_start", next_seq=writer.next_seq)

    def aborted() -> bool:
        return paths.read_abort() is not None

    current_ordinal = -1
    snapshot = None
    phase_snapshot = None  # the running phase's start snapshot: pushes load elsewhere
    # In-flight weight updates (method.fleet_inflight_weights + the engine):
    # poll the latest pointer between engine syncs and push a fresher version
    # into the running engine, instead of only at phase boundaries.
    inflight = bool(trainer.config.method.fleet_inflight_weights) and bool(trainer.rollout_engine_enabled)
    poll_state = {"tick": 0, "storm": 0}

    def torn_once(latest):
        """A torn latest pointer met outside the in-flight poll: one event
        per torn ordinal."""
        if poll_state.get("torn_seen") != int(latest["ordinal"]):
            poll_state["torn_seen"] = int(latest["ordinal"])
            _event(paths, ROLE_ROLLOUT, "weights_torn", ordinal=int(latest["ordinal"]), held=current_ordinal)

    def weight_poll():
        """Once per engine sync: adopt a fresher broadcast ordinal into the
        RUNNING phase. Returns (decode module, version) to push, or None.
        Torn snapshots are rejected (keep decoding on the held version); the
        ``version_switch_storm`` fault re-pushes the held latest every sync
        for a window, which the engine must coalesce, never queue."""
        nonlocal current_ordinal, snapshot
        poll_state["tick"] += 1
        if trainer.fault_plan.fire("version_switch_storm", poll_state["tick"]):
            poll_state["storm"] = int(os.environ.get("TRLX_TPU_SWITCH_STORM_PUSHES", "8"))
        latest = subscriber.latest()
        if latest is None:
            return None
        fresh = int(latest["ordinal"]) > current_ordinal
        storm = poll_state["storm"] > 0
        if storm:
            poll_state["storm"] -= 1
        if not fresh and not storm:
            return None
        if fresh:
            leaves = subscriber.try_load(latest)
            if leaves is None:
                # Torn push: the pointer flipped but the file is truncated.
                # The engine keeps the old version; the next sync retries.
                _event(paths, ROLE_ROLLOUT, "weights_torn", ordinal=int(latest["ordinal"]), held=current_ordinal)
                return None
            snapshot = _hold(trainer, paths, subscriber, latest, leaves, "weights_adopted_inflight",
                             avoid=phase_snapshot)
            current_ordinal = int(latest["ordinal"])
        if snapshot is None:
            return None
        return trainer.rollout_engine_variables(snapshot), snapshot["version"]

    try:
        while not aborted():
            seq = writer.next_seq
            heartbeat.beat(step=seq, phase="fleet:gate")
            if not staleness_gate_open(seq, _read_cursor(paths), S):
                time.sleep(0.05)
                continue
            # Gate open: cursor read BEFORE the latest pointer, so the
            # version whose publish opened the gate is already visible.
            need = max(0, seq - S)
            latest = subscriber.latest()
            if latest is None or int(latest["ordinal"]) < need:
                heartbeat.beat(step=seq, phase="fleet:wait_weights")
                got = subscriber.fetch(need, deadline=knobs["broadcast_deadline"], abort_check=aborted,
                                       heartbeat=heartbeat, on_torn=torn_once)
                if got is None:
                    break  # coordinated shutdown while waiting
                latest, leaves = got
            elif int(latest["ordinal"]) != current_ordinal:
                leaves = subscriber.try_load(latest)
                if leaves is None:
                    # Torn latest pointer at the phase boundary: reject it
                    # like the in-flight poller, keep the held version when it
                    # still satisfies the gate, else spin at the gate until the
                    # next intact ordinal lands.
                    torn_once(latest)
                    if current_ordinal < need or snapshot is None:
                        time.sleep(0.05)
                        continue
            else:
                leaves = None
            if leaves is not None:
                snapshot = _hold(trainer, paths, subscriber, latest, leaves, "weights_fetched", seq=seq)
                current_ordinal = int(latest["ordinal"])

            store = PPORolloutStorage(trainer.pad_token_id, record_staleness=True)

            def produce_stop():
                heartbeat.beat(step=seq, phase="fleet:produce")
                return aborted()

            phase_snapshot = snapshot
            info = orch.make_experience(n_roll, iter_count=snapshot["version"], store=store, snapshot=snapshot,
                                        staleness=0,  # realized staleness is stamped at consume time
                                        stop=produce_stop, weight_poll=weight_poll if inflight else None)
            phase_snapshot = None
            if aborted():
                break  # the phase was cut short; drop the partial store
            heartbeat.beat(step=seq, phase="fleet:stream")
            writer.append(
                store.columns(),
                # In-flight adoption may have advanced the snapshot mid-phase:
                # the tag is the LAST version that decoded, and the span
                # aggregate carries the per-token mix.
                weight_version=snapshot["version"],
                version_spans=(info or {}).get("version_spans") if inflight else None,
            )
            _event(paths, ROLE_ROLLOUT, "episode_streamed", seq=seq, version=snapshot["version"], n=len(store))
            if trainer.fault_plan.fire("rollout_host_kill", seq):
                os._exit(1)  # abrupt: no cleanup, no final heartbeat
        _event(paths, ROLE_ROLLOUT, "worker_exit", reason="abort", next_seq=writer.next_seq)
    finally:
        _stop_heartbeats(heartbeat, trainer)


# --------------------------------------------------------- elastic worker


def _run_elastic_worker(trainer, orch, num_rollouts: Optional[int] = None):
    """One of N elastic rollout workers: register, then loop claim a unit →
    hold eligible weights → seek the unit's prompt shard → produce → stream
    → complete, with the lease renewed off the produce heartbeat.

    Membership dynamics: ``worker_join_mid_run@N`` defers registration until
    the learner's cursor reaches N (the joiner then adopts the LATEST
    broadcast); ``TRLX_TPU_FLEET_LEAVE_AFTER=k`` makes the worker deregister
    cleanly after producing k units (releasing any held lease);
    ``worker_kill_mid_lease`` / ``slow_worker_reclaim`` die or oversleep
    while HOLDING a lease, which the peers' reclaim path and the learner's
    dedup intake must absorb."""
    t = trainer.config.train
    knobs = role_timeouts(t)
    paths = fleet_paths(t).ensure_elastic()
    S = trainer.max_staleness
    n_roll = int(num_rollouts or trainer.config.method.num_rollouts)
    plan = trainer.fault_plan
    cpu = orch.chunks_per_unit(n_roll)

    def aborted() -> bool:
        return paths.read_abort() is not None

    # Dynamic join: hold registration (and the heartbeat: an unregistered
    # worker must not look like a dead one) until the run reaches the cursor.
    join_at = plan.pending_at("worker_join_mid_run")
    if join_at is not None:
        while _read_cursor(paths) < join_at and not aborted():
            time.sleep(0.05)
        plan.fire_at_or_after("worker_join_mid_run", join_at)
        if aborted():
            if trainer.heartbeat is not None:
                trainer.heartbeat.stop()
            return

    registry = WorkerRegistry(paths.workers_dir)
    ledger = LeaseLedger(paths.leases_dir, ttl=knobs["lease_ttl"])
    env_worker = os.environ.get(WORKER_ENV, "")
    wid = registry.register(int(env_worker) if env_worker else None)
    heartbeat = Heartbeat(paths.heartbeats_dir, knobs["heartbeat_interval"], rank=ROLLOUT_HOST + wid)
    heartbeat.start()
    writer = EpisodeStreamWriter(paths, fault_plan=plan, worker=wid)
    subscriber = WeightSubscriber(paths)
    _event(paths, ROLE_ROLLOUT, "worker_registered", worker=wid, cursor=_read_cursor(paths),
           **({"joined_at": join_at} if join_at is not None else {}))
    leave_after = int(os.environ.get("TRLX_TPU_FLEET_LEAVE_AFTER", "0") or 0)
    produced = 0
    current_ordinal = -1
    snapshot = None
    lease = None
    reason = "abort"
    try:
        # Bootstrap: hold SOME broadcast before claiming anything, so no lease
        # expires across the learner's first publish. A mid-run joiner gets
        # the LATEST ordinal here, never a historical one.
        heartbeat.beat(step=0, phase="fleet:wait_weights")
        boot = subscriber.fetch(0, deadline=knobs["broadcast_deadline"], abort_check=aborted, heartbeat=heartbeat)
        if boot is not None:
            latest, leaves = boot
            snapshot = _hold(trainer, paths, subscriber, latest, leaves, "weights_fetched", worker=wid)
            current_ordinal = int(latest["ordinal"])
        while boot is not None and not aborted():
            if leave_after and produced >= leave_after:
                reason = "left"
                break
            consumed = _read_cursor(paths)
            heartbeat.beat(step=consumed, phase="fleet:claim")
            # Lowest claimable gate-open unit: [cursor, cursor + S] are the
            # only units the staleness gate admits; done or fresh-held units
            # are skipped inside try_claim.
            lease = None
            for unit in range(consumed, consumed + S + 1):
                got = ledger.try_claim(unit, wid)
                if got is not None:
                    lease = got
                    break
            if lease is None:
                time.sleep(0.05)
                continue
            unit = lease.unit
            _event(paths, ROLE_ROLLOUT, "lease_reclaimed" if lease.gen > 0 else "lease_claimed", unit=unit,
                   worker=wid, gen=lease.gen)
            if plan.fire_at_or_after("worker_kill_mid_lease", unit):
                os._exit(1)  # lease held, nothing streamed: peers must reclaim
            if plan.fire_at_or_after("slow_worker_reclaim", unit):
                # Outlive the TTL mid-hold, then produce anyway: the double
                # production the learner's dedup must suppress.
                time.sleep(float(os.environ.get("TRLX_TPU_SLOW_WORKER_SECONDS", "") or 3.0 * knobs["lease_ttl"]))
            # Weight eligibility for this unit (the single-worker gate).
            need = max(0, unit - S)
            latest = subscriber.latest()
            leaves = None
            if latest is None or int(latest["ordinal"]) < need:
                heartbeat.beat(step=unit, phase="fleet:wait_weights")
                got = subscriber.fetch(need, deadline=knobs["broadcast_deadline"], abort_check=aborted,
                                       heartbeat=heartbeat)
                if got is None:
                    break  # coordinated shutdown while waiting
                latest, leaves = got
            elif int(latest["ordinal"]) != current_ordinal:
                leaves = subscriber.try_load(latest)
                if leaves is None and (current_ordinal < need or snapshot is None):
                    # Torn pointer and the held version is ineligible: spin
                    # until the next intact ordinal (the lease stays renewed).
                    ledger.renew(lease)
                    time.sleep(0.05)
                    continue
            if leaves is not None:
                snapshot = _hold(trainer, paths, subscriber, latest, leaves, "weights_fetched", unit=unit, worker=wid)
                current_ordinal = int(latest["ordinal"])

            # The unit's prompt shard: every worker derives the same
            # deterministic chunk schedule, so a reclaimed unit reproduces the
            # dead owner's exact prompts.
            orch.seek_chunks(unit * cpu)
            store = PPORolloutStorage(trainer.pad_token_id, record_staleness=True)
            renew_state = {"last": time.monotonic(), "owned": True}

            def produce_stop():
                heartbeat.beat(step=unit, phase="fleet:produce")
                now = time.monotonic()
                if renew_state["owned"] and now - renew_state["last"] >= max(0.2, knobs["lease_ttl"] / 3.0):
                    renew_state["last"] = now
                    if ledger.renew(lease) is None:
                        # A peer reclaimed us mid-produce. Keep producing (the
                        # intake dedupes) but say so once.
                        renew_state["owned"] = False
                        _event(paths, ROLE_ROLLOUT, "lease_lost", unit=unit, worker=wid, gen=lease.gen)
                return aborted()

            # In-flight spans are a single-worker engine contract: no poller.
            orch.make_experience(n_roll, iter_count=snapshot["version"], store=store, snapshot=snapshot,
                                 staleness=0, stop=produce_stop, weight_poll=None)
            if aborted():
                break  # the phase was cut short; drop the partial store
            heartbeat.beat(step=unit, phase="fleet:stream")
            seq = writer.append(store.columns(), weight_version=snapshot["version"], unit=unit)
            kept = ledger.complete(lease)
            produced += 1
            _event(paths, ROLE_ROLLOUT, "episode_streamed", unit=unit, seq=seq, version=snapshot["version"],
                   n=len(store), worker=wid, lease_kept=bool(kept))
            lease = None
        _event(paths, ROLE_ROLLOUT, "worker_exit", reason=reason, worker=wid, produced=produced)
        if reason == "left":
            _event(paths, ROLE_ROLLOUT, "worker_left", worker=wid, produced=produced)
    finally:
        if lease is not None:
            ledger.release(lease)
        registry.leave(wid)
        _stop_heartbeats(heartbeat, trainer)


# ----------------------------------------------------------- learner feed


class FleetLearnerFeed:
    """The learner's store source: one consumed stream batch per call.

    Drives the publish-before-advance schedule, stamps realized staleness,
    and owns the degradation ladder. In COLOCATED mode (fleet armed, no
    role) it also runs the worker inline at each boundary: both roles in one
    process, episodes still crossing the real npz transports, the bitwise
    staleness-0 parity configuration. Each publish's bytes and seconds go
    to its ``weights_published`` event."""

    def __init__(self, trainer, orch=None):
        self.trainer = trainer
        self.orch = orch
        t = trainer.config.train
        self.role = trainer.fleet_role
        self.max_staleness = trainer.max_staleness
        self.knobs = role_timeouts(t)
        self.elastic = bool(trainer.config.method.fleet_elastic)
        self.paths = fleet_paths(t).ensure_elastic() if self.elastic else fleet_paths(t).ensure()
        # Elastic: exactly-once unit intake across N per-worker indexes, else
        # the single-stream sequential reader. Same wait/queued_from/load.
        self.reader = ElasticStreamReader(self.paths) if self.elastic else EpisodeStreamReader(self.paths)
        self._registry = WorkerRegistry(self.paths.workers_dir) if self.elastic else None
        self._ledger = LeaseLedger(self.paths.leases_dir, ttl=self.knobs["lease_ttl"]) if self.elastic else None
        self.publisher = WeightPublisher(self.paths, fault_plan=trainer.fault_plan)
        # version -> publish ordinal, for realized-staleness stamping
        # (resume-aware: rebuilt from the log, injected entries included).
        self._version_ordinal = {int(r["version"]): int(r["ordinal"])
                                 for r in read_jsonl_or_empty(self.paths.broadcast_log)}
        self.consumed = _read_cursor(self.paths)
        # Elastic resume: the per-stream consume marks ride the unit cursor
        # (forensic; the unit cursor is the authority).
        self._stream_marks = {}
        if self.elastic:
            try:
                with open(self.paths.cursor, "r") as f:
                    marks = json.load(f).get("streams") or {}
                self._stream_marks = {str(k): int(v) for k, v in marks.items()}
            except (OSError, ValueError, TypeError, AttributeError):
                pass
        self.state = "ok"
        self.triage = ""
        self._abort_written = False
        self._t0 = time.monotonic()
        self.heartbeat = Heartbeat(self.paths.heartbeats_dir, self.knobs["heartbeat_interval"], rank=LEARNER_HOST)
        self.heartbeat.start()
        # Colocated inline worker state.
        colocated = self.role == ROLE_COLOCATED
        self._writer = EpisodeStreamWriter(self.paths, fault_plan=trainer.fault_plan) if colocated else None
        self._subscriber = WeightSubscriber(self.paths) if colocated else None
        self._colo_ordinal = -1
        self._colo_snapshot = None
        if self.elastic and self._writer is not None:
            # Colocated elastic: the inline producer IS worker 0: it
            # registers, claims leases and tags units like any peer.
            self._registry.register(0)
        # Token-granularity staleness watch (in-flight weight updates): rides
        # the trainer's health monitor when one is armed.
        self._mixed_detector = None
        monitor = trainer._health
        if monitor is not None:
            from trlx_tpu_torch.observability.health import MixedVersionDetector

            self._mixed_detector = monitor.register_detector(MixedVersionDetector())
        _event(self.paths, self.role, "learner_start", consumed=self.consumed)
        self._export(staleness=0.0)

    # ------------------------------------------------------------- publish

    def _publish(self):
        tr = self.trainer
        version = int(tr.iter_count)
        # The adaptive KL coefficient travels WITH the weights: a worker on
        # version-n weights must also hold version-n's coefficient.
        ordinal = self.publisher.publish(published_params(tr.model), version=version,
                                         meta={"kl_coef": float(tr.kl_ctl.value)})
        self._version_ordinal[version] = ordinal
        if obs_numerics.enabled():
            obs_numerics.record_weight_quant(tr.model, version=version)
        _event(self.paths, self.role, "weights_published", ordinal=ordinal, version=version,
               **self.publisher.last_stats)
        return ordinal

    def bootstrap(self) -> PPORolloutStorage:
        """Iteration-0 fill: publish v0, then consume the first batch (the
        colocated inline worker produces it; a disaggregated worker's gate
        opens the moment the v0 pointer lands)."""
        self._publish()
        self.heartbeat.beat(step=self.trainer.iter_count, phase="fleet:bootstrap")
        return self.next_store()

    def consume_done(self):
        """One train iteration fully consumed: publish the post-train
        weights. Publish-BEFORE-advance is the ordering the staleness gate's
        visibility argument rests on (the cursor only moves in ``_consume``,
        after this)."""
        self._publish()

    # ------------------------------------------------------------- consume

    def next_store(self) -> PPORolloutStorage:
        if self.state == "degraded":
            return self._drain_one()
        if self._writer is not None:
            self._inline_produce()
        while True:
            self.heartbeat.beat(step=self.trainer.iter_count, phase="fleet:wait_episode")
            try:
                rec = self.reader.wait(self.consumed, timeout=self.knobs["episode_timeout"],
                                       retries=self.knobs["stream_retries"], backoff=self.knobs["stream_backoff"])
            except EpisodeStreamTimeout:
                verdict = self._triage_rollout()
                if verdict in ("alive", "starting"):
                    # Slow but live (or still building): keep waiting.
                    _event(self.paths, self.role, "stream_slow", seq=self.consumed, triage=verdict)
                    continue
                self._enter_degraded(verdict)
                return self._drain_one()
            return self._consume(rec)

    def _consume(self, rec: dict) -> PPORolloutStorage:
        seq = int(rec["seq"])
        # Elastic records advance the cursor by WORK UNIT; the single-worker
        # stream's seq IS its unit.
        unit = int(rec.get("unit", rec["seq"]))
        worker = int(rec.get("worker", 0))
        version = int(rec["weight_version"])
        latest_ordinal = self.publisher.next_ordinal - 1
        v_ordinal = self._version_ordinal.get(version)
        if v_ordinal is None:
            # Lineage violation: an episode tagged with a version this learner
            # never published. Surfaced loudly.
            _event(self.paths, self.role, "unknown_version", seq=seq, version=version)
            v_ordinal = latest_ordinal
        staleness = max(0, latest_ordinal - v_ordinal)
        # Token granularity (in-flight updates): the cap gates on the
        # FRESHEST span; the older-token mix feeds fleet/mixed_version_tokens
        # and its health detector instead of tripping the cap.
        spans = rec.get("version_spans")
        mixed_tokens = 0
        total_tokens = 0
        if spans:
            span_stal = []
            for v, k in spans:
                vo = self._version_ordinal.get(int(v))
                if vo is None:
                    _event(self.paths, self.role, "unknown_version", seq=seq, version=int(v))
                    vo = latest_ordinal
                span_stal.append((max(0, latest_ordinal - vo), int(k)))
            freshest = min(s for s, _ in span_stal)
            staleness = freshest
            mixed_tokens = sum(k for s, k in span_stal if s > freshest)
            total_tokens = sum(k for _, k in span_stal)
        if staleness > self.max_staleness:
            self._enter_degraded(self.triage or "staleness_cap")
            raise FleetDegradedExit("staleness_cap", triage=self.triage,
                                    detail=f"seq={seq} staleness={staleness} > cap={self.max_staleness}")
        if self._mixed_detector is not None and total_tokens:
            self._mixed_detector.observe({"mixed_tokens": mixed_tokens, "total_tokens": total_tokens})
        cols = dict(self.reader.load(rec))
        n = int(rec.get("n", 0))
        cols["staleness"] = np.full((n, 1), float(staleness), dtype=np.float32)
        store = PPORolloutStorage(self.trainer.pad_token_id, record_staleness=True)
        store.push_batch(cols)
        self.consumed = unit + 1
        cursor_payload = {"consumed": self.consumed, "ordinal": latest_ordinal, "t": time.time()}
        if self.elastic:
            # Per-stream consume marks: the resume forensics of interleaved
            # multi-stream cursors (consumed alone is the authority).
            self._stream_marks[str(worker)] = seq + 1
            cursor_payload["streams"] = dict(self._stream_marks)
        atomic_write_json(self.paths.cursor, cursor_payload)
        _event(self.paths, self.role, "episode_consumed", seq=seq, version=version, staleness=staleness, n=n,
               state=self.state, **({"unit": unit, "worker": worker} if self.elastic else {}),
               **({"mixed_version_tokens": mixed_tokens} if spans else {}))
        self._export(staleness=float(staleness), version=version,
                     mixed_tokens=float(mixed_tokens) if spans else None,
                     worker=worker if self.elastic else None)
        return store

    # ---------------------------------------------------------- colocated

    def _inline_produce(self):
        """Colocated mode: run the worker's loop body inline until the gate
        closes: same transports, same schedule, one process. With
        ``method.fleet_elastic`` the inline producer is WORKER 0: it claims
        each unit's lease, seeks the unit's prompt shard and tags its
        records."""
        tr = self.trainer
        cpu = self.orch.chunks_per_unit(tr.config.method.num_rollouts) if self.elastic else 0
        # Colocated, no publish can land mid-phase (one process, publish only
        # at the boundary): with the knob on every record carries one span.
        inflight = bool(tr.config.method.fleet_inflight_weights) and bool(tr.rollout_engine_enabled)
        while staleness_gate_open(self._writer.next_seq, self.consumed, self.max_staleness):
            seq = self._writer.next_seq
            lease = None
            if self.elastic:
                lease = self._ledger.try_claim(seq, 0)
                if lease is None:
                    # Unit already done (produced before a learner restart):
                    # nothing to produce until consuming reopens the gate.
                    break
                _event(self.paths, self.role, "lease_reclaimed" if lease.gen > 0 else "lease_claimed", unit=seq,
                       worker=0, gen=lease.gen)
                self.orch.seek_chunks(seq * cpu)
            latest = self._subscriber.latest()
            if latest is None or int(latest["ordinal"]) < max(0, seq - self.max_staleness):
                raise RuntimeError("colocated fleet invariant broken: gate open but no eligible weight snapshot "
                                   "published")
            if int(latest["ordinal"]) != self._colo_ordinal:
                leaves = self._subscriber.load(latest)
                self._colo_snapshot = fleet_snapshot(tr, leaves, latest["version"])
                self._colo_ordinal = int(latest["ordinal"])
            store = PPORolloutStorage(tr.pad_token_id, record_staleness=True)
            info = self.orch.make_experience(tr.config.method.num_rollouts, iter_count=self._colo_snapshot["version"],
                                             store=store, snapshot=self._colo_snapshot, staleness=0, stop=None)
            self._writer.append(store.columns(), weight_version=self._colo_snapshot["version"],
                                version_spans=(info or {}).get("version_spans") if inflight else None,
                                unit=seq if self.elastic else None)
            if lease is not None:
                self._ledger.complete(lease)
            _event(self.paths, self.role, "episode_streamed", seq=seq, version=self._colo_snapshot["version"],
                   n=len(store), **({"unit": seq, "worker": 0} if self.elastic else {}))

    # --------------------------------------------------------- degradation

    def _classify_heartbeat(self, rec) -> str:
        """dead / stalled / alive / starting from one heartbeat record: the
        same written_t-vs-progress_t distinction for every role."""
        timeout = self.knobs["heartbeat_timeout"]
        now = time.time()
        if rec is None:
            grace = max(120.0, 10.0 * timeout)
            return "starting" if time.monotonic() - self._t0 < grace else "dead"
        if now - float(rec.get("written_t", 0.0)) > timeout:
            return "dead"
        if now - float(rec.get("progress_t", 0.0)) > timeout:
            return "stalled"
        return "alive"

    def _triage_workers(self) -> dict:
        """Per-worker triage (elastic only): worker id -> {state,
        heartbeat_age, leases_held, incarnation}. A worker that wrote a clean
        ``left`` record is 'left' whatever its heartbeat's age. Heartbeats
        live at rank ROLLOUT_HOST + worker id."""
        recs = read_heartbeats(self.paths.heartbeats_dir)
        now = time.time()
        workers = {}
        for wid, wrec in sorted(self._registry.workers().items()):
            hb = recs.get(ROLLOUT_HOST + wid)
            state = "left" if wrec.get("status") == "left" else self._classify_heartbeat(hb)
            workers[wid] = {
                "state": state,
                "heartbeat_age": round(now - float(hb.get("written_t", 0.0)), 3) if hb else None,
                "leases_held": len(self._ledger.held_by(wid)),
                "incarnation": int(wrec.get("incarnation", 0)),
            }
        return workers

    def _triage_rollout(self) -> str:
        """Classify the rollout side from its fleet heartbeat(s): 'dead',
        'stalled', 'alive' or 'starting' (no heartbeat yet, within the
        startup grace). Elastic aggregate over the registry: ANY progressing
        worker keeps the fleet alive, any starting one keeps it starting, a
        wedged-but-present one reads stalled, and only an empty set of live
        workers is dead."""
        recs = read_heartbeats(self.paths.heartbeats_dir)
        if not self.elastic:
            return self._classify_heartbeat(recs.get(ROLLOUT_HOST))
        states = [w["state"] for w in self._triage_workers().values() if w["state"] != "left"]
        if any(s == "alive" for s in states):
            return "alive"
        if any(s == "starting" for s in states):
            return "starting"
        if any(s == "stalled" for s in states):
            return "stalled"
        if states:
            return "dead"
        # Empty registry: nobody joined yet (startup grace) or everyone left.
        grace = max(120.0, 10.0 * self.knobs["heartbeat_timeout"])
        return "starting" if time.monotonic() - self._t0 < grace else "dead"

    def _enter_degraded(self, triage: str):
        if self.state == "degraded":
            return
        self.state = "degraded"
        self.triage = triage
        # Flip the health surface FIRST: every scrape during the drain (and
        # the trainer's checkpoint after it) sees fleet/degraded.
        self._export(staleness=None)
        _event(self.paths, self.role, "degraded", triage=triage, consumed=self.consumed,
               queued=len(self.reader.queued_from(self.consumed)))

    def _drain_one(self) -> PPORolloutStorage:
        """Degraded: hand over the next queued batch (tagged with its
        elevated staleness), or raise when the stream is dry."""
        queued = self.reader.queued_from(self.consumed)
        if not queued:
            raise FleetDegradedExit("stream_dry", triage=self.triage)
        _event(self.paths, self.role, "drain", seq=int(queued[0]["seq"]), remaining=len(queued), triage=self.triage)
        return self._consume(queued[0])

    # ------------------------------------------------------------ teardown

    def shutdown(self, reason: str = "complete"):
        """Learner-side teardown. Writes ``abort.json`` (the coordinated
        shutdown signal the worker polls) EXCEPT on preemption: a preempted
        learner resumes into the same fleet_dir, and the worker keeps
        serving it."""
        if reason != "preempted" and not self._abort_written:
            atomic_write_json(self.paths.abort, {"reason": reason, "triage": self.triage, "consumed": self.consumed,
                                                 "t": time.time()})
            self._abort_written = True
        _event(self.paths, self.role, "learner_exit", reason=reason, consumed=self.consumed)
        self.heartbeat.stop()

    # --------------------------------------------------------- observability

    def _export(self, staleness=None, version=None, mixed_tokens=None, worker=None):
        exporter = self.trainer._metrics_exporter
        if exporter is None:
            return
        payload = {
            "state": self.state,
            "role": self.role,
            "triage": self.triage,
            "consumed": self.consumed,
            "published": self.publisher.next_ordinal,
            "max_staleness": self.max_staleness,
        }
        gauges = {"fleet/degraded": 1.0 if self.state == "degraded" else 0.0}
        if staleness is not None:
            gauges["fleet/staleness"] = float(staleness)
        if version is not None:
            gauges["fleet/weight_version"] = float(version)
        if mixed_tokens is not None:
            # Tokens of the last consumed batch NOT produced by its freshest
            # weight version: the in-flight update mix the detector watches.
            gauges["fleet/mixed_version_tokens"] = float(mixed_tokens)
        fleet_payload = {"disaggregated": payload}
        if self.elastic:
            workers = self._triage_workers()
            gauges["fleet/episodes_deduped_total"] = float(self.reader.duplicates())
            gauges["fleet/units_reclaimed_total"] = float(len(self._ledger.reclaimed_units()))
            gauges["fleet/workers_active"] = float(sum(1 for w in workers.values()
                                                       if w["state"] in ("alive", "starting")))
            # Every per-consume fleet/* gauge carries the producing worker as
            # a label; the per-worker liveness trio is labelled by triaged id.
            if worker is not None:
                labels = {"worker": str(int(worker))}
                if staleness is not None:
                    exporter.set_gauge("fleet/staleness", float(staleness), labels)
                if version is not None:
                    exporter.set_gauge("fleet/weight_version", float(version), labels)
            state_code = {"alive": 0, "starting": 1, "stalled": 2, "dead": 3, "left": 4}
            for wid, w in workers.items():
                labels = {"worker": str(wid)}
                if w["heartbeat_age"] is not None:
                    exporter.set_gauge("fleet/worker_heartbeat_age", float(w["heartbeat_age"]), labels)
                exporter.set_gauge("fleet/worker_leases_held", float(w["leases_held"]), labels)
                exporter.set_gauge("fleet/worker_state", float(state_code.get(w["state"], 3)), labels)
            fleet_payload["workers"] = {str(k): v for k, v in workers.items()}
        exporter.update(gauges)
        exporter.set_fleet(fleet_payload)
