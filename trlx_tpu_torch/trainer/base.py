"""The trainer base (the counterpart of ``trlx_tpu.trainer.base``): the
learning-rate schedule, the optimizer, evaluation, checkpointing and the
``learn()`` loop, plus what every trainer shares on the rollout side.

A trainer owns one device, the model and its parameters, the seeded
generators, the optimizer state (its step counts and moments), the
consecutive-skip count of the non-finite guard, the tokenizer, and the host
hooks (``reward_fn``, ``metric_fn``, ``logit_mask``). It builds its mesh from
``train.mesh`` (``parallel.mesh``) over the processes ``torchrun`` starts (one
a card), or over a prebuilt mesh (``mesh=``, e.g. a ``LocalSpGroup`` that
plays every sp rank in this process). fsdp and tp split the parameters, the
optimizer's moments and the gradients by ``parallel.sharding``'s rules
(``models.lm.place_model``); the data axes (dp × fsdp) split each batch, whose
rows are a node's (a node is a JAX host) and whose reductions are global
(``ops.modeling.loss_group``); gradients are summed over the data ranks in
f32 (``reduce_gradients``) and the clip reads the whole gradient's norm. The
main process alone writes the tracker's records and exports, with a barrier
after each, and alone calls ``reward_fn`` and ``metric_fn``, whose results it
broadcasts. Across processes: heartbeats (``train.heartbeat_interval``), the
collective deadline (``train.collective_deadline``, exit 117), the
consistency guard (``train.desync_check_interval``), the preemption
agreement (``train.preempt_check_interval``) and the host fault drills
(``resilience.distributed``). With
``model.tokenizer_path`` the trainer runs in text mode (``_build_tokenizer``:
``transformers.AutoTokenizer``, imported when called, or any object with the
same interface a subclass returns): prompts are strings, ``decode`` gives
text to ``reward_fn`` and ``metric_fn``; without one, prompts and samples
are token ids. ``save_pretrained`` exports the trunk as an HF checkpoint
(``models/hf_export.py``). Every knob whose feature is missing is refused
by ``refuse_unported``.

Checkpoints (``save`` / ``load``) are the port's own format, not the JAX
package's orbax directory: ``<train.checkpoint_dir>/state_<step>/`` holds
``torch.save`` files of every named parameter (f32 masters, frozen ones
included), the frozen extras (PPO's reference branch, ILQL's target Q
heads), the optimizer's moments by parameter name with its applied-update
count, and the step with the guard's skip count; beside it sit
``state_<step>.host.json`` (host state), ``state_<step>.manifest.json``
(every file's size and crc32) and, written last, ``latest.txt``. A sharded
mesh writes each distinct piece once (``params.f<i>t<j>.pt``, ...) beside
``layout.json``; ``load`` reassembles either form onto the current mesh.

Resilience beyond the guard: each step's (loss, nonfinite, bad_steps) is
buffered and flushed at every log or eval boundary and every
``max(log_interval, 8)`` steps (the JAX package's cadence): the flush counts
guard skips, stops after ``train.max_bad_steps``, and feeds the divergence
watchdog (``train.watchdog_threshold``), whose trip rolls back to the last
intact checkpoint in place, decays the LR (``_lr_scale``, saved with the host
state) and goes on. The fault plan (``train.fault_plan`` /
``TRLX_TPU_FAULTS``) fires its step, save and host drills here and its
reward drills in the PPO orchestrator. Observability: span tracing, the
step-time anomaly detector with incident bundles, the health monitor, the
live ``/metrics`` endpoint and graftfleet (``observability.fleet``: a span
file and an arrival file a rank, the clock estimate at start and every
``train.fleet_resync_interval`` steps, rank 0's skew gauges at log
boundaries, the bundle of a desync), device telemetry
(``observability.devicemon``: the monitored programs' counted FLOPs, MFU per
window, routing and memory gauges, ``programs.json``), graftscope
(``observability.graftscope``: the device/host/bubble ledger,
``graftscope.json``) and graftnum (``observability.numerics``: the ``num/*``
step statistics, the NaN census and bisect in guard-skip bundles, the
quantization error at weight handoffs) arm from the config or the
environment (``_setup_observability``); a run with any of the three armed
ends with ``<checkpoint_dir>/report.md`` (``observability.report``).
``train.profile_dir`` traces local steps [2, 5) with ``torch.profiler``;
``train.watch_interval`` logs per-group gradient norms and parameter
histograms. The non-finite guard's bundle always carries the gradient
census (``numerics.json``) when incidents are armed.
"""

import dataclasses
import json
import math
import os
import shutil
import signal
import sys
import threading
import time
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.device import resolve_device
from trlx_tpu_torch.models.hf_export import export_hf
from trlx_tpu_torch.models.lm import LMConfig, gather_tensor, placement_of, refresh_weight_copies, shard_tensor
from trlx_tpu_torch.ops.modeling import set_loss_group
from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel.mesh import (
    AXIS_DP, AXIS_FSDP, AXIS_SP, AXIS_TP, allgather_host, barrier, broadcast_host, init_distributed, is_main_process,
    make_mesh, node_count, resolve_mesh_shape, process_rank, set_mesh, world_size,
)
from trlx_tpu_torch.resilience import distributed as dist_res
from trlx_tpu_torch.observability import env_flag
from trlx_tpu_torch.observability import fleet as obs_fleet
from trlx_tpu_torch.observability import graftscope as obs_graftscope
from trlx_tpu_torch.observability import numerics as obs_numerics
from trlx_tpu_torch.observability import spans as obs_spans
from trlx_tpu_torch.observability.devicemon import PROGRAMS_FILENAME, DeviceMonitor
from trlx_tpu_torch.observability.anomaly import AnomalyDetector, IncidentCapture, register_emergency
from trlx_tpu_torch.observability.health import HealthMonitor
from trlx_tpu_torch.pipeline.overlap import PrefetchIterator, SerialFeed
from trlx_tpu_torch.resilience import checkpoint as ckpt_util
from trlx_tpu_torch.resilience.checkpoint import CheckpointError
from trlx_tpu_torch.resilience.faults import FaultPlan, poison_nan
from trlx_tpu_torch.resilience.guard import TrainingDiverged, guarded_update
from trlx_tpu_torch.resilience.watchdog import DivergenceWatchdog
from trlx_tpu_torch.trainer import BaseRLTrainer
from trlx_tpu_torch.utils.logging import Tracker


def lr_schedule(train_cfg) -> Callable[[int], float]:
    """Linear warmup from 0 over ``lr_ramp_steps``, then cosine decay from
    ``learning_rate_init`` to ``learning_rate_target`` over
    ``lr_decay_steps`` (optax's ``join_schedules`` of a linear and a cosine
    schedule, written out)."""
    init, target = float(train_cfg.learning_rate_init), float(train_cfg.learning_rate_target)
    decay_steps = max(train_cfg.lr_decay_steps, 1)
    alpha = target / max(init, 1e-12)
    ramp = int(train_cfg.lr_ramp_steps)

    def cosine(count: int) -> float:
        count = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * decay + alpha)

    def schedule(count: int) -> float:
        if ramp > 0:
            if count < ramp:
                frac = 1 - min(max(count, 0), ramp) / ramp
                return (0.0 - init) * frac + init
            return cosine(count - ramp)
        return cosine(count)

    return schedule


def global_norm(tensors: List[torch.Tensor], weights: Optional[List[float]] = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (0-dim). On a
    sharded mesh each tensor is this rank's piece: its sum of squares
    counts ``weights[i]`` (one over the ranks holding the same piece) and
    the sum runs over ``group`` (every process), so the norm is that of
    every parameter's whole gradient."""
    if weights is None:
        return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))
    sq = sum(t.float().pow(2).sum() * w for t, w in zip(tensors, weights))
    return torch.sqrt(coll.all_reduce(sq, group))


def reduce_gradients(model, mesh, names: List[str], grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each named parameter's gradient over the data ranks, in f32: a
    piece split over fsdp arrives reduce-scattered over fsdp already (the
    backward of its gathered copy) and is summed over dp; every other one
    over dp × fsdp. One all-reduce per group over the flattened gradients;
    every sp and tp rank of a data rank holds the same sum."""
    if mesh.data_size == 1:
        return grads
    buckets = {}
    for i, name in enumerate(names):
        pl = placement_of(model, name)
        buckets.setdefault("dp" if pl is not None and pl.fsdp_dim is not None else "data", []).append(i)
    out = list(grads)
    for gname, idx in buckets.items():
        group = mesh.group(gname)
        if group.size == 1:
            continue
        flat = coll.all_reduce(torch.cat([grads[i].float().reshape(-1) for i in idx]), group)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i]).to(grads[i].dtype)
    return out


class ClippedAdamW:
    """Global-norm clip, then AdamW with a schedule: optax's
    ``chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    weight_decay=wd))`` over the trainable parameters, written out.

    - The clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
      (no ``+1e-6``, unlike ``torch.nn.utils.clip_grad_norm_``).
    - Adam: eps 1e-8 outside the square root, bias correction by the applied
      step count; decoupled weight decay on every trainable parameter, then
      ``-schedule(k)`` times the update, where k counts APPLIED updates (a
      skipped step does not advance it).

    Moments are kept in the parameters' dtype (f32 masters) and updated in
    place; on a sharded mesh parameters, gradients and moments are this
    rank's pieces, the clip reads the norm of the whole gradient
    (``norm_fn``) and each rank updates its pieces (ZeRO: the moments shard
    like the parameters). ``step`` clips the gradients it is given in
    place. ``names``
    (the parameters' names) key the moments in ``state_dict``; an optimizer
    built without them steps, but has no state to save or load."""

    def __init__(self, params: List[torch.Tensor], schedule: Callable[[int], float], b1: float, b2: float,
                 weight_decay: float, max_norm: float, eps: float = 1e-8, names: Optional[List[str]] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay, self.max_norm = float(weight_decay), float(max_norm)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.names = None if names is None else list(names)
        if self.names is not None and len(self.names) != len(params):
            raise ValueError(f"{len(self.names)} names for {len(params)} parameters")
        self.count = 0  # applied updates: Adam's bias-correction count and the schedule's
        self.norm_fn = global_norm  # a sharded mesh's trainer sets the global one
        # graftnum: with record_deltas a step leaves each parameter's realized
        # update's sum of squares in last_deltas (device scalars).
        self.record_deltas = False
        self.last_deltas = None

    def _require_names(self):
        if self.names is None:
            raise ValueError("this optimizer was built without parameter names: its moments cannot be saved or "
                             "loaded (give build_optimizer the names)")

    def state_dict(self) -> Dict:
        """The live moments by parameter name, and the applied-update
        count."""
        self._require_names()
        return {"mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu)), "count": self.count}

    def check_state_dict(self, state: Dict):
        """Raise ValueError unless ``state`` has exactly this optimizer's
        names, each moment of its shape."""
        self._require_names()
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            got = state[key]
            if set(got) != set(self.names):
                missing, extra = sorted(set(self.names) - set(got)), sorted(set(got) - set(self.names))
                raise ValueError(f"optimizer {key}: missing {missing[:4]}, unexpected {extra[:4]}")
            for name, m in zip(self.names, own):
                if tuple(got[name].shape) != tuple(m.shape):
                    raise ValueError(f"optimizer {key} {name}: shape {tuple(got[name].shape)} != {tuple(m.shape)}")

    @torch.no_grad()
    def load_state_dict(self, state: Dict):
        """Copy ``state`` (``state_dict``'s layout) into the existing moment
        tensors, in place, after checking its names and shapes."""
        self.check_state_dict(state)
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            for name, m in zip(self.names, own):
                m.copy_(state[key][name])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        norm = self.norm_fn(grads)
        clip = norm >= self.max_norm
        for g in grads:  # clipped in place: no second copy of every gradient at once
            g.copy_(torch.where(clip, g / norm * self.max_norm, g))
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        deltas = [] if self.record_deltas else None
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd.add_(p, alpha=self.weight_decay)
            old = p.detach().clone() if deltas is not None else None
            p.add_(upd, alpha=-lr)
            if deltas is not None:
                deltas.append((p.detach() - old).float().pow(2).sum())
        self.last_deltas = deltas


def build_optimizer(train_cfg, params: List[torch.Tensor], names: List[str]):
    """(optimizer, schedule): global-norm clip then AdamW over ``params``
    (the trainable parameters only; frozen ones get no moments), keyed by
    ``names``."""
    schedule = lr_schedule(train_cfg)
    opt = ClippedAdamW(params, schedule, train_cfg.opt_betas[0], train_cfg.opt_betas[1],
                       train_cfg.weight_decay, train_cfg.grad_clip, names=names)
    return opt, schedule


# Environment switches of the JAX package whose features are not ported:
# each raises by name (every other switch is read where its feature arms,
# the environment winning over the config as in the JAX package).
UNPORTED_ENV_SWITCHES = {
    "TRLX_TPU_SANITIZE": "the dispatch sanitizer (the port has no dispatch lock)",
}


def refuse_unported(config: TRLConfig):
    """Raise on every environment switch whose feature is not ported
    (``UNPORTED_ENV_SWITCHES``), so no config silently runs a different
    algorithm, or records less, than it asks for. Int8 decode weights and
    the fleet (``train.fleet_*``, its environment switches and fault kinds)
    are PPO's rollout features: other trainers accept and ignore them, as
    the JAX package's do."""
    on = [f"{var} ({feature})" for var, feature in UNPORTED_ENV_SWITCHES.items() if env_flag(var)]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


class BaseTrainer(BaseRLTrainer):
    def __init__(self, config: TRLConfig, device: Optional[Union[str, torch.device]] = None, **kwargs):
        super().__init__(config)
        refuse_unported(config)
        init_distributed()
        self.device = resolve_device(device)
        mesh = kwargs.pop("mesh", None)
        if mesh is None:
            # The overlapped pipeline's threads get a second group set.
            m = config.method
            mesh = make_mesh(config.train.mesh, producer_groups=bool(getattr(m, "rollout_overlap", False))
                             or int(getattr(m, "max_staleness", 0) or 0) > 0)
        elif tuple(mesh.shape.values()) != resolve_mesh_shape(config.train.mesh, mesh.size):
            raise ValueError(f"the mesh {mesh} is not train.mesh {tuple(config.train.mesh)}")
        self.mesh = mesh
        set_mesh(mesh)
        # Multi-process resilience: the heartbeat file of this rank, and the
        # deadline of every guarded collective (train.collective_deadline).
        t = config.train
        self.heartbeat = None
        if t.heartbeat_interval > 0:
            self.heartbeat = dist_res.Heartbeat(os.path.join(os.path.abspath(t.checkpoint_dir), "heartbeats"),
                                                t.heartbeat_interval, process_rank()).start()
        # A weak reference: the process-global guard must not keep a finished
        # trainer (and its device memory) alive.
        me = weakref.ref(self)
        dist_res.configure(deadline=t.collective_deadline, heartbeat=self.heartbeat,
                           step_provider=lambda: getattr(me(), "iter_count", 0))
        barrier("init")
        # The batch reductions (whitening, loss means, statistics) run over
        # the data ranks.
        set_loss_group(mesh.group("data") if mesh.data_size > 1 else None)
        # Rows are per node (a JAX host): they must split evenly over the
        # node's data ranks.
        self._validate_data_sharding(t.batch_size, "train.batch_size")
        chunk = getattr(config.method, "chunk_size", None)
        if chunk is not None:
            self._validate_data_sharding(chunk, "method.chunk_size (rollout chunk)")
        self.tokenizer = self._build_tokenizer(config.model.tokenizer_path)
        self.reward_fn = kwargs.pop("reward_fn", None)
        self.metric_fn = kwargs.pop("metric_fn", None)
        self.logit_mask = kwargs.pop("logit_mask", None)
        if kwargs:
            raise TypeError(f"unexpected trainer arguments: {sorted(kwargs)}")
        self.orch = None
        self.iter_count = 0
        self._tracker = None
        # Checkpoint and resilience host state: at most one save in flight
        # and the count of completed saves (the ckpt_corrupt drill's tick);
        # the guard's total skips; the watchdog's rollback count and LR
        # scale (saved under the JAX package's names); the fault plan; the
        # per-step (loss, nonfinite, bad_steps) scalars buffered until the
        # next flush.
        self.fault_plan = FaultPlan.from_env_or_config(t.fault_plan)
        self._pending_save = None
        self._save_count = 0
        self._saved = None  # (directory, name, host state) of the last finalized save, while the state is unchanged
        self.skipped_steps = 0
        self._rollbacks = 0
        self._lr_scale = 1.0
        self._res_pending = []
        self.watchdog = (DivergenceWatchdog(t.watchdog_threshold, patience=t.watchdog_patience,
                                            ema_alpha=t.watchdog_ema_alpha, warmup=t.watchdog_warmup)
                         if t.watchdog_threshold > 0 else None)
        self._res_batch_refs = []  # each buffered step's device batch (a reference) while incidents are armed
        self._profiling = None  # the torch.profiler of train.profile_dir while its window is open
        self._resumed = False
        self._preempted = False
        self.last_restore_fallback = False  # load() fell past latest.txt
        self.checkpoint_log: List[Dict] = []  # one record per save and per load: bytes and seconds
        self._setup_observability()

    def _setup_observability(self):
        """Arm what the config and the environment ask for (the environment
        wins, as in the JAX package): span tracing into
        ``<checkpoint_dir>/spans.jsonl``, device telemetry, graftscope, the
        step-time anomaly detector with incident bundles, the health monitor
        (whose CRIT escalates into an incident, and whose lineage lands in
        ``lineage.jsonl``), graftnum, and the live ``/metrics`` endpoint on
        the main process. The trainer's construction owns the process's
        tracer, scope, observatory and emergency hook: an earlier trainer's
        are replaced, or disarmed when this one arms none."""
        t = self.config.train
        ckpt_dir = os.path.abspath(t.checkpoint_dir)
        # graftscope needs the monitor's dispatch hook and the span file for
        # its timeline rows: arming it arms both.
        graftscope_on = t.graftscope or env_flag("TRLX_TPU_GRAFTSCOPE")
        # graftfleet owns the span file's name when armed (one file a rank,
        # spans.host<k>.jsonl) and implies span tracing.
        fleet_on = t.graftfleet or env_flag("TRLX_TPU_GRAFTFLEET")
        if t.trace_spans or fleet_on or graftscope_on or env_flag("TRLX_TPU_SPANS"):
            name = obs_spans.host_spans_filename(process_rank()) if fleet_on else obs_spans.SPANS_FILENAME
            obs_spans.configure(os.path.join(ckpt_dir, name), process_index=process_rank())
        else:
            obs_spans.shutdown()
        self._devicemon = None
        if t.device_telemetry or graftscope_on or env_flag("TRLX_TPU_DEVICE_TELEMETRY"):
            self._devicemon = DeviceMonitor(
                programs_path=os.path.join(ckpt_dir, PROGRAMS_FILENAME) if is_main_process() else None,
                device=self.device, census=self._state_census)
        self._graftscope = None
        if graftscope_on:
            self._graftscope = obs_graftscope.configure(
                os.path.join(ckpt_dir, obs_graftscope.SNAPSHOT_FILENAME) if is_main_process() else None)
            self._devicemon.ledger = self._graftscope
        else:
            obs_graftscope.shutdown()
        anomaly_factor = float(os.environ.get("TRLX_TPU_ANOMALY_FACTOR", "") or t.anomaly_factor)
        self._anomaly = self._incidents = self._health = None
        if anomaly_factor > 0:
            self._anomaly = AnomalyDetector(anomaly_factor, window=t.anomaly_window)
            self._incidents = self._build_incident_capture(ckpt_dir)
        if t.health_monitor or env_flag("TRLX_TPU_HEALTH"):
            if self._incidents is None:
                self._incidents = self._build_incident_capture(ckpt_dir)
            self._health = HealthMonitor(
                warmup=t.health_warmup, warn_streak=t.health_warn_streak, crit_streak=t.health_crit_streak,
                lineage_path=os.path.join(ckpt_dir, "lineage.jsonl") if is_main_process() else None)
        # graftnum: the num/* step statistics (gated when the loss is built),
        # the NaN provenance in guard-skip bundles (so it arms incidents) and
        # the quantization error at handoffs. Its detectors join the health
        # monitor, or escalate through the emergency hook without one.
        self._graftnum = None
        if obs_numerics.armed(t):
            self._graftnum = obs_numerics.configure()
            if self._incidents is None:
                self._incidents = self._build_incident_capture(ckpt_dir)
            for det in self._graftnum.detectors:
                if self._health is not None:
                    self._health.register_detector(det)
                else:
                    det.on_crit = obs_numerics.escalate
        else:
            obs_numerics.shutdown()
        if self._incidents is None:
            register_emergency(None)
        # graftfleet: this rank's collective arrivals, the clock estimate
        # (its first sync is collective: the knob is the same on every rank)
        # and, on rank 0, the skew gauges and /healthz block at log
        # boundaries.
        self._fleet = None
        if fleet_on:
            os.makedirs(ckpt_dir, exist_ok=True)
            self._fleet = obs_fleet.configure(ckpt_dir, process_index=process_rank(), process_count=world_size(),
                                              resync_interval=t.fleet_resync_interval)
            self._fleet.clock_sync(step=0)
            if self._health is not None:
                self._health.register_detector(self._fleet.straggler)
        else:
            obs_fleet.shutdown()
        self._metrics_port = int(os.environ.get("TRLX_TPU_METRICS_PORT", "") or t.metrics_port)
        self._metrics_exporter = None
        if self._metrics_port > 0 and is_main_process():
            from trlx_tpu_torch.observability.export import MetricsExporter

            os.makedirs(ckpt_dir, exist_ok=True)
            # port_file: where a scraper finds the port actually bound when
            # the requested one was busy.
            self._metrics_exporter = MetricsExporter(self._metrics_port,
                                                     port_file=os.path.join(ckpt_dir, "metrics_port"))

    def _build_incident_capture(self, ckpt_dir: str) -> IncidentCapture:
        """The run's IncidentCapture, registered as the emergency hook (the
        health monitor's CRIT escalation runs with no trainer in scope). The
        hook holds the trainer weakly: the process-global registration must
        not keep a finished trainer (and its device memory) alive."""
        me = weakref.ref(self)
        incidents = IncidentCapture(ckpt_dir, device=self.device, metrics_path=os.path.join(ckpt_dir, "metrics.jsonl"),
                                    max_incidents=self.config.train.max_incidents,
                                    profiling_active=lambda: getattr(me(), "_profiling", None) is not None)
        register_emergency(incidents, lambda: getattr(me(), "iter_count", 0))
        return incidents

    def _state_census(self):
        """The tensors of the train state (the CPU memory gauge's census):
        parameters, the optimizer's moments and the frozen extras."""
        model, opt = getattr(self, "model", None), getattr(self, "optimizer", None)
        out = list(model.parameters()) if model is not None else []
        if opt is not None:
            out += list(opt.mu) + list(opt.nu)
        return out + list(getattr(self, "extras", {}).values())

    def _wrap_monitored(self, name: str, fn, phase: str = "train"):
        """``fn`` through the device monitor (``DeviceMonitor.wrap``), or
        ``fn`` itself when device telemetry is off."""
        monitor = getattr(self, "_devicemon", None)
        return fn if monitor is None else monitor.wrap(name, fn, phase=phase)

    def _flush_device_telemetry(self, phase_seconds: dict) -> dict:
        """The window boundary's telemetry: the monitor's FLOP counters into
        MFU and throughput gauges, the routing and memory gauges, and the
        graftscope ledger with its samples and snapshot. {} when off."""
        monitor = getattr(self, "_devicemon", None)
        if monitor is None:
            return {}
        out = monitor.window(phase_seconds)
        out.update(monitor.kernel_routing_gauges())
        out.update(monitor.device_memory_gauges())
        gs = getattr(self, "_graftscope", None)
        if gs is not None:
            out.update(gs.window())
            self._flush_graftscope_samples(gs)
            gs.flush()
        return out

    def _flush_graftscope_samples(self, gs):
        """The window's raw graftscope samples (lane gaps, refill waits,
        straggler steps and accept rates by prompt width) to the tracker's
        histogram records and, when serving, the ``/metrics`` histograms."""
        samples = gs.drain_samples()
        if not samples:
            return
        exporter = self._metrics_exporter
        for lane, gaps in sorted(samples.get("lane_gaps", {}).items()):
            if gaps:
                self.tracker.log_histogram("obs/lane_gap_" + lane + "_s", gaps, step=self.iter_count)
                if exporter is not None:
                    exporter.observe("obs/lane_gap_s", gaps, buckets=obs_graftscope.LANE_GAP_S_BUCKETS,
                                     labels={"lane": lane})
        waits = samples.get("refill_wait_ms") or []
        if waits:
            self.tracker.log_histogram("engine/refill_wait_ms", waits, step=self.iter_count)
            if exporter is not None:
                exporter.observe("engine/refill_wait_ms", waits, buckets=obs_graftscope.REFILL_WAIT_MS_BUCKETS)
        for width, steps in sorted((samples.get("straggler_steps") or {}).items()):
            if steps and exporter is not None:
                exporter.observe("engine/straggler_steps", steps, buckets=obs_graftscope.STRAGGLER_STEPS_BUCKETS,
                                 labels={"width": str(width)})
        for width, rates in sorted((samples.get("spec_accept") or {}).items()):
            if rates:
                self.tracker.log_histogram("engine/spec_accept_rate", rates, step=self.iter_count)
                if exporter is not None:
                    exporter.observe("engine/spec_accept_rate", rates, buckets=obs_graftscope.SPEC_ACCEPT_RATE_BUCKETS,
                                     labels={"width": str(width)})

    def _export_metrics(self, stats_host: dict):
        """The freshest log-boundary scalars (health gauges included) to the
        live /metrics, and the health status to /healthz. With several
        processes the main one serves its own numbers: the port's ranks are
        sp ranks, which train on the same batch."""
        if self._metrics_exporter is not None:
            health = self._health
            self._metrics_exporter.update(stats_host, step=self.iter_count,
                                          health=health.healthz() if health is not None else None)

    def build_train_state(self):
        """The train state beside the model: the trainable parameters (and
        their names), the optimizer over them, the step count and the
        guard's consecutive skips."""
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.trainable = [p for _, p in named]
        self.trainable_names = [n for n, _ in named]
        self.optimizer, self.schedule = build_optimizer(self._scaled_train_cfg(), self.trainable,
                                                        [n for n, _ in named])
        if self._distributed_grads():
            self.optimizer.norm_fn = self.grad_norm
        self.step = 0
        self.bad_steps = 0

    def _distributed_grads(self) -> bool:
        """Gradients need a reduction across processes: a mesh whose data
        axes or parameter splits exceed 1 (every sp rank of an unsplit mesh
        holds the whole gradient already)."""
        return self.mesh.data_size > 1 or self.mesh.sharded

    def _piece_weights(self) -> List[float]:
        """Per trainable parameter, one over the processes that hold the
        same piece of its gradient after ``reduce_gradients``."""
        if getattr(self, "_norm_weights", None) is None:
            self._norm_weights = [self._piece_weight(n) for n in self.trainable_names]
        return self._norm_weights

    def _piece_weight(self, name: str) -> float:
        """One over the processes that hold the same piece of parameter
        ``name``."""
        shape = self.mesh.shape
        pl = placement_of(self.model, name)
        rep = shape[AXIS_DP] * shape[AXIS_SP]
        rep *= shape[AXIS_FSDP] if pl is None or pl.fsdp_dim is None else 1
        rep *= shape[AXIS_TP] if pl is None or pl.tp_dim is None else 1
        return 1.0 / rep

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradient (``global_norm`` over every
        process's pieces)."""
        if not self._distributed_grads():
            return global_norm(grads)
        return global_norm(grads, self._piece_weights(), self.mesh.group("world"))

    def reduce_gradients(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The trainable gradients summed over the data ranks
        (``reduce_gradients``)."""
        if not self._distributed_grads():
            return grads
        return reduce_gradients(self.model, self.mesh, self.trainable_names, grads)

    def _scaled_train_cfg(self):
        """The train config with the watchdog's LR decay folded into the
        schedule's endpoints (the config itself while no rollback fired)."""
        if self._lr_scale == 1.0:
            return self.config.train
        t = self.config.train
        return dataclasses.replace(t, learning_rate_init=t.learning_rate_init * self._lr_scale,
                                   learning_rate_target=t.learning_rate_target * self._lr_scale)

    def _rebuild_for_lr_scale(self):
        """Swap the scaled schedule into the optimizer after ``_lr_scale``
        changed; its moments and applied-update count stay."""
        self.schedule = lr_schedule(self._scaled_train_cfg())
        self.optimizer.schedule = self.schedule

    def finalize_lm_config(self, lm_cfg: LMConfig) -> LMConfig:
        """The mesh's settings the architecture needs: sp > 1 turns on ring
        attention; fsdp and tp above 1 split the parameters by
        ``parallel.sharding``'s rules (``models.lm.place_model``). The JAX
        package also switches a sharded mesh's embedding to a one-hot matmul
        (``onehot_embed``) for XLA's SPMD partitioner; the port looks up the
        rows each tp rank owns and sums over tp, which gives the same
        numbers."""
        shape = self.mesh.shape
        if shape[AXIS_SP] > 1:
            lm_cfg = lm_cfg.replace(sp_size=shape[AXIS_SP])
        return lm_cfg.with_mesh(tp=shape[AXIS_TP], fsdp=shape[AXIS_FSDP]) if self.mesh.sharded else lm_cfg

    def _validate_data_sharding(self, rows_per_node: int, name: str):
        """Rows are per node (the JAX package's per-process rows: a node is
        one JAX host) and split evenly over the node's data ranks; each node
        holds whole tp × sp groups."""
        mesh, nodes = self.mesh, node_count()
        per_node_ranks = world_size() // nodes
        inner = mesh.shape[AXIS_TP] * mesh.shape[AXIS_SP]
        if world_size() > 1 and (per_node_ranks % inner or mesh.data_size % nodes):
            raise ValueError(f"{nodes} node(s) of {per_node_ranks} ranks cannot hold whole tp x sp groups of "
                             f"{inner} on the mesh {mesh.shape}")
        data = mesh.data_size // nodes
        if rows_per_node % data:
            raise ValueError(
                f"{name}={rows_per_node} rows per node do not divide over the node's {data} data rank(s) of the "
                f"mesh {mesh.shape} — pick a size that shards evenly")

    def node_rows(self, n: int) -> slice:
        """This data rank's rows of a node's ``n`` (dp slowest, then fsdp):
        every tp and sp rank of a data rank holds the same rows."""
        per = self.mesh.data_size // node_count()
        b = n // per
        i = self.mesh.data_index % per
        return slice(i * b, (i + 1) * b)

    def sample_rows(self, n_local: int):
        """(first row, node rows) of this data rank's ``n_local`` rows: the
        sampler draws the node's noise and keeps its rows, so a rank samples
        the tokens a single process would (None on one data rank)."""
        if self.mesh.data_size == 1:
            return None
        per = self.mesh.data_size // node_count()
        return ((self.mesh.data_index % per) * n_local, n_local * per)

    def local_rows(self, x):
        """This data rank's rows of a node's host array (or tensor)."""
        if self.mesh.data_size == 1 or x is None:
            return x
        return x[self.node_rows(x.shape[0])]

    def gather_rows(self, x, every_node: bool = False) -> np.ndarray:
        """Every data rank's host rows of this node (or, ``every_node``, of
        every node, node by node), in row order: the inverse of
        ``local_rows``, a collective over the data ranks."""
        if self.mesh.data_size == 1:
            return np.asarray(x)
        rows = allgather_host(np.asarray(x), self.mesh.group("data"))
        if every_node or node_count() == 1:
            return rows
        per = self.mesh.data_size // node_count()
        b = np.asarray(x).shape[0]
        first = (self.mesh.data_index // per) * per * b
        return rows[first:first + per * b]

    def gather_node_rows(self, x) -> np.ndarray:
        """Every node's copy of a node-wide host array (one each node's
        ranks hold alike, e.g. its prompt batch), node by node: a collective
        over the data ranks; ``x`` itself with one node."""
        n = node_count()
        if n == 1:
            return np.asarray(x)
        per = self.mesh.data_size // n
        b = np.asarray(x).shape[0]
        rows = allgather_host(np.asarray(x), self.mesh.group("data"))
        return np.concatenate([rows[k * per * b:k * per * b + b] for k in range(n)], axis=0)

    def node_slice(self, rows_every_node: np.ndarray) -> np.ndarray:
        """This node's rows of a ``gather_rows(..., every_node=True)``."""
        n = node_count()
        if n == 1:
            return rows_every_node
        b = rows_every_node.shape[0] // n
        per = self.mesh.data_size // n
        first = (self.mesh.data_index // per) * b
        return rows_every_node[first:first + b]

    @property
    def tracker(self) -> Tracker:
        """The run's tracker (``<train.checkpoint_dir>/metrics.jsonl``),
        opened at first use; it writes on the main process only."""
        if self._tracker is None:
            c = self.config
            self._tracker = Tracker(c.train.checkpoint_dir, config=c.to_dict(), project_name=c.train.project_name,
                                    run_name=c.model.model_path or "from-scratch", entity_name=c.train.entity_name)
        return self._tracker

    def host_reward(self, samples, call: Optional[Callable] = None) -> np.ndarray:
        """``reward_fn(samples)`` (or ``call()``, e.g. the orchestrator's
        retrying wrapper of it) on the main process, its f32 scores
        broadcast to every rank, so every rank trains on the same rewards."""
        if is_main_process():
            scores = np.asarray(call() if call is not None else self.reward_fn(samples), dtype=np.float32)
        else:
            scores = None
        return broadcast_host(scores)

    def seed_of(self, *key: int) -> int:
        """The seed of (train.seed, *key) through numpy's SeedSequence, so
        distinct keys give unrelated streams."""
        seed = np.random.SeedSequence([int(self.config.train.seed), *[int(k) for k in key]])
        return int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def seeded_generator(self, *key: int) -> torch.Generator:
        """A generator on the trainer's device seeded with ``seed_of(*key)``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed_of(*key))
        return g

    def chunk_rng(self, chunk: int) -> torch.Generator:
        """Sampling generator for absolute prompt chunk ``chunk``: a pure
        function of (train.seed, chunk), so chunk c samples the same tokens
        whatever was drawn before it."""
        return self.seeded_generator(0, chunk)

    def put(self, x, dtype=None) -> torch.Tensor:
        """A host array (or tensor) on the trainer's device."""
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=dtype, device=self.device)

    def put_batch(self, batch):
        """A batch dataclass of a node's host arrays → the same dataclass of
        this data rank's rows as device tensors (the one place a train batch
        crosses to the device); the host-only ``extras`` stay behind."""
        fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
        return dataclasses.replace(
            batch, **{k: (None if k == "extras" or v is None else self.put(self.local_rows(v)))
                      for k, v in fields.items()}
        )

    @staticmethod
    def to_host(tree):
        """Tensors (or a tuple / list / dict of them) → numpy. Reading a CUDA
        tensor waits for the work that produces it."""
        if torch.is_tensor(tree):
            return tree.detach().cpu().numpy()
        if isinstance(tree, (tuple, list)):
            return type(tree)(BaseTrainer.to_host(t) for t in tree)
        if isinstance(tree, dict):
            return {k: BaseTrainer.to_host(v) for k, v in tree.items()}
        return tree

    def _build_tokenizer(self, tokenizer_path: str):
        """The tokenizer at ``tokenizer_path`` (None for ""): pad = eos, left
        padding, as the JAX package sets them. ``transformers`` is imported
        here, only when a path is given; a subclass may return any object
        with the same interface (``__call__``, ``batch_decode``,
        ``bos_token_id``, ``eos_token_id``, ``pad_token_id``)."""
        if not tokenizer_path:
            return None
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)
        tokenizer.pad_token = tokenizer.eos_token
        tokenizer.padding_side = "left"
        return tokenizer

    def tokenize(self, texts):
        """BOS + text, truncated to ``train.seq_length`` keeping the trailing
        tokens (the prompts' keep-last rule)."""
        assert self.tokenizer is not None, "tokenize() requires a tokenizer"
        out = []
        for text in texts:
            ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
            if self.tokenizer.bos_token_id is not None:
                ids = [self.tokenizer.bos_token_id] + ids
            out.append(ids[-self.config.train.seq_length:])
        return out

    def decode(self, tokens, mask=None):
        """Token grids → text with a tokenizer (special tokens skipped), else
        per-row token arrays trimmed to the mask."""
        tokens = self.to_host(tokens)
        if self.tokenizer is not None:
            return self.tokenizer.batch_decode(tokens, skip_special_tokens=True)
        if mask is None:
            return [t for t in tokens]
        mask = self.to_host(mask)
        return [t[m.astype(bool)] for t, m in zip(tokens, mask)]

    @staticmethod
    def rollout_decode_stats(mask_h, prompt_length: int):
        """Decode-loop counts for one rollout chunk from the host mask:
        generated tokens, the decode steps the loop ran (the highest response
        position any row was live at), the step budget, and each row's
        steps."""
        resp = np.asarray(mask_h)[:, prompt_length:]
        return {
            "gen_tokens": int(resp.sum()),
            "decode_steps": int(resp.any(axis=0).sum()),
            "decode_step_budget": int(resp.shape[1]),
            "episode_steps": resp.sum(axis=1).astype(np.int64),
        }

    # ------------------------------------------------------------ training

    def prepare_learning(self):
        """Build the train/eval loaders; set n_updates_per_batch and
        total_steps."""
        raise NotImplementedError

    def make_extras(self) -> Dict[str, torch.Tensor]:
        """The trainer's frozen tensors beside the model (PPO: the reference;
        ILQL: the target Q heads), fresh copies of the model's."""
        raise NotImplementedError

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor], extras: Optional[Dict[str, torch.Tensor]] = None):
        """Copy a full state dict into the model (every parameter must be
        given) and set the frozen extras to ``extras``, or to a fresh
        ``make_extras()`` of the loaded parameters."""
        own = dict(self.model.named_parameters())
        missing = sorted(set(own) - set(params))
        extra = sorted(set(params) - set(own))
        if missing or extra:
            raise KeyError(f"load_params: missing {missing[:4]}, unexpected {extra[:4]}")
        for name, t in params.items():
            own[name].copy_(shard_tensor(self.model, name, torch.as_tensor(t)))
        self._saved = None
        if extras is None:
            self.extras = self.make_extras()
        else:
            self.extras = {
                n: shard_tensor(self.model, n, torch.as_tensor(t)).to(device=own[n].device, dtype=own[n].dtype).clone()
                for n, t in extras.items()
            }

    def full_params(self, tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The whole of every named parameter (or of ``tensors``, by
        parameter name: the extras, the moments), gathered from every rank's
        piece: a collective on a sharded mesh, every rank calls it."""
        tensors = dict(self.model.named_parameters()) if tensors is None else tensors
        with torch.no_grad():
            return {n: gather_tensor(self.model, n, t.detach()) for n, t in tensors.items()}

    def build_train_step(self):
        """Set ``self._loss_fn(batch) -> (loss, stats)`` for this trainer's
        model and config; returns ``train_step``."""
        raise NotImplementedError

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One update on a device batch: loss, backward, the non-finite
        guard, clip + AdamW over the trainable parameters. Returns the loss
        stats plus ``grad_norm`` (before clipping), ``learning_rate`` (the
        schedule at this step) and the guard's ``resilience/*`` counters, as
        device scalars. With ``train.watch_interval`` it adds
        ``watch/grad_norm/<group>`` per top-level parameter group; with
        graftnum armed the ``num/*`` statistics (``_numerics_stats``). Both
        gates are resolved when the loss is built: disarmed, the step issues
        what it issued without them."""
        if getattr(self, "_loss_fn", None) is None:
            self.build_train_step()
            t = self.config.train
            self._step_gates = (obs_numerics.armed(t), t.watch_interval > 0)
        num_on, watch_on = getattr(self, "_step_gates", (False, False))
        params = self.trainable
        for p in params:
            p.grad = None
        with dist_res.collective_guard("train_step", only_collectives=False):
            loss, stats = self._loss_fn(batch)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            for p in params:
                p.grad = None
            grads = self.reduce_gradients(grads)
        stats = dict(stats)
        stats["grad_norm"] = self.grad_norm(grads)
        pre = None
        if num_on or watch_on:
            # Before the update: the optimizer clips the gradients in place.
            names, weights, group = self._all_param_layout()
            g_sq = obs_numerics.tensor_sq(self._by_all_names(grads), self.device)
            if watch_on:
                stats.update(self._watch_grad_norms(names, g_sq, weights, group))
            if num_on:
                pre = (g_sq, self._param_sq())
                self.optimizer.record_deltas, self.optimizer.last_deltas = True, None
        if self.config.train.nonfinite_guard:
            group = self.mesh.group("world") if self._distributed_grads() else None
            self.bad_steps, applied = guarded_update(self.optimizer, params, grads, loss.detach(), self.bad_steps,
                                                     group=group)
            stats["resilience/nonfinite"] = torch.tensor(0.0 if applied else 1.0)
            stats["resilience/bad_steps"] = torch.tensor(float(self.bad_steps))
        else:
            self.optimizer.step(params, grads)
        if pre is not None:
            stats.update(self._numerics_stats(*pre))
        stats["learning_rate"] = torch.tensor(self.schedule(self.step), dtype=torch.float32)
        self.step += 1
        self._saved = None
        return stats

    # ------------------------------------------------------- step telemetry

    def _all_param_layout(self):
        """(every parameter's name, the per-name weights and the group a
        sharded mesh's sums run over, or None and None on one process)."""
        if getattr(self, "_param_layout", None) is None:
            names = [n for n, _ in self.model.named_parameters()]
            weights = group = None
            if self._distributed_grads():
                weights = [self._piece_weight(n) for n in names]
                group = self.mesh.group("world")
            self._param_layout = (names, weights, group)
        return self._param_layout

    def _by_all_names(self, tensors) -> list:
        """``tensors`` (one per trainable parameter) spread over every
        parameter's name, None where a parameter is frozen."""
        by_name = dict(zip(self.trainable_names, tensors))
        return [by_name.get(n) for n in self._all_param_layout()[0]]

    def _param_sq(self) -> torch.Tensor:
        """Every parameter's sum of squares (device vector, no host sync);
        the frozen ones' are kept while their values are unchanged."""
        names = self._all_param_layout()[0]
        named = dict(self.model.named_parameters())
        trainable = set(self.trainable_names)
        frozen = [named[n] for n in names if n not in trainable]
        key = tuple((p._version, p.data_ptr()) for p in frozen)
        cached = getattr(self, "_frozen_sq", None)
        if cached is None or cached[0] != key:
            cached = self._frozen_sq = (key, obs_numerics.tensor_sq(
                [None if n in trainable else named[n] for n in names], self.device))
        return obs_numerics.tensor_sq([named[n] if n in trainable else None for n in names], self.device) + cached[1]

    def _numerics_stats(self, g_sq, p_sq) -> Dict[str, torch.Tensor]:
        """graftnum's ``num/*`` statistics of the step just taken, from the
        gradients' and the old parameters' sums of squares and the
        optimizer's realized updates (none on a skipped step: ratio 0)."""
        names, weights, group = self._all_param_layout()
        deltas, self.optimizer.last_deltas = self.optimizer.last_deltas, None
        self.optimizer.record_deltas = False
        zero = torch.zeros((), device=self.device)
        by_name = dict(zip(self.trainable_names, deltas)) if deltas is not None else {}
        d_sq = torch.stack([by_name.get(n, zero) for n in names])
        return obs_numerics.train_step_stats(names, g_sq, p_sq, d_sq, weights=weights, group=group)

    def _watch_grad_norms(self, names, g_sq, weights, group) -> Dict[str, torch.Tensor]:
        """``watch/grad_norm/<group>``: the gradient norm of each top-level
        parameter group (device scalars)."""
        groups, norms = obs_numerics.grouped_norms(names, g_sq[None], key=obs_numerics.top_group, weights=weights,
                                                   group=group)
        return {f"watch/grad_norm/{g}": norms[0, j] for j, g in enumerate(groups)}

    def log_param_watch(self, limit_per_leaf: int = 4096):
        """Parameter distributions per top-level group (``wandb.watch``'s
        counterpart): a strided subsample of at most ``limit_per_leaf``
        elements of each floating parameter, taken on the device, is the only
        host transfer. Skipped on several processes (a piece is not the
        parameter), as the JAX package skips it on a pod."""
        if not self.tracker.enabled or world_size() > 1:
            return
        pieces = {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if not p.is_floating_point():
                    continue
                flat = p.detach().reshape(-1)
                stride = max(1, flat.shape[0] // limit_per_leaf)
                pieces.setdefault(obs_numerics.top_group(name), []).append(flat[::stride][:limit_per_leaf].float())
        for group, parts in sorted(pieces.items()):
            self.tracker.log_histogram(f"watch/params/{group}", torch.cat(parts).cpu().numpy(), step=self.iter_count)

    def post_backward_callback(self, stats=None):
        """Called with every step's stats (device scalars)."""

    def post_epoch_callback(self):
        """Called after every epoch of the train loader."""

    def add_eval_pipeline(self, eval_pipeline):
        self.eval_pipeline = eval_pipeline

    def eval_generate(self, input_ids, attention_mask, batch_index: int):
        """(tokens, mask) for one eval batch; the trainer defines how."""
        raise NotImplementedError

    def evaluate(self):
        """Sample the eval prompts, score them with ``reward_fn`` and
        ``metric_fn``, and log a table. Statistics run over exactly the valid
        eval rows: the loader's fixed-shape wrap-around duplicates are
        dropped first. With an on-device reward model and no ``reward_fn``,
        the rewards are the reward model's scores."""
        eval_t0 = time.time()
        stats = {}
        all_texts = []
        rm_scores = []
        use_rm = self.reward_fn is None and getattr(self, "has_reward_model", False)
        t0 = time.time()
        for i, (batch, n_valid) in enumerate(self.eval_dataloader.iter_with_valid()):
            # Each data rank samples its rows of the node's batch; the rows
            # are gathered back in order before anything is scored.
            tokens, mask = self.eval_generate(self.local_rows(batch["input_ids"]),
                                              self.local_rows(batch["attention_mask"]), i)
            if use_rm:
                rm_scores.append(self.gather_rows(self.to_host(self.rm_eval_scores(tokens, mask)))[:n_valid])
            t, m = (self.gather_rows(a) for a in self.to_host((tokens, mask)))
            all_texts.extend(self.decode(t[:n_valid], m[:n_valid]))
        stats["generate_time"] = time.time() - t0

        columns = ["sample"]
        rows = [[t] for t in all_texts]
        rewards = None
        if use_rm:
            rewards = np.concatenate(rm_scores).astype(np.float32)
        elif self.reward_fn is not None:
            t0 = time.time()
            rewards = self.host_reward(all_texts)
            stats["reward_time"] = time.time() - t0
        if rewards is not None:
            stats["mean_reward"] = float(np.mean(rewards))
            columns.append("reward")
            for row, r in zip(rows, rewards):
                row.append(float(r))
        if self.metric_fn is not None:
            t0 = time.time()
            metrics = broadcast_host(self.metric_fn(all_texts) if is_main_process() else None)
            stats["metric_time"] = time.time() - t0
            for k, v in metrics.items():
                v = np.asarray(v)
                stats[f"metrics/{k}"] = float(np.mean(v))
                if v.ndim > 0 and len(v) == len(rows):
                    columns.append(k)
                    for row, item in zip(rows, v):
                        row.append(float(item))
        self.tracker.log_table("samples", columns, rows, step=self.iter_count)
        stats["eval_wall_time"] = time.time() - eval_t0
        return stats

    # ------------------------------------------------------------ resilience

    def _flush_resilience(self, allow_rollback: bool = True):
        """Drain the buffered per-step (loss, nonfinite, bad_steps) scalars.

        Per buffered step: count a skipped (non-finite) update, stop after
        ``train.max_bad_steps`` consecutive skips, and feed the loss to the
        divergence watchdog, which may roll back to the last intact
        checkpoint (not with ``allow_rollback=False``: from inside a save,
        where a rollback would recurse). A flush that counted skips records
        a ``guard_skip`` span instant, an incident bundle (when incidents are
        armed) with the first skipped step's numerics (``_capture_numerics``)
        and ``resilience/skipped_steps``."""
        if not self._res_pending:
            return
        pending, self._res_pending = self._res_pending, []
        batch_refs, self._res_batch_refs = self._res_batch_refs, []
        batch_refs += [None] * (len(pending) - len(batch_refs))
        max_bad = self.config.train.max_bad_steps
        skips_before = self.skipped_steps
        offending_batch = None
        for (loss, nonfinite, bad), batch in zip(pending, batch_refs):
            if nonfinite is not None and float(nonfinite) > 0:
                self.skipped_steps += 1
                if offending_batch is None:
                    offending_batch = batch
            if bad is not None and max_bad > 0 and int(bad) >= max_bad:
                raise TrainingDiverged(
                    f"{int(bad)} consecutive non-finite train steps (>= train.max_bad_steps={max_bad}) around step "
                    f"{self.iter_count} — persistent numeric blow-up, not a one-off bad batch. Lower the learning "
                    "rate, tighten train.grad_clip, or inspect the data; raise train.max_bad_steps only if skips "
                    "are expected."
                )
            if allow_rollback and self.watchdog is not None and loss is not None and self.watchdog.observe(float(loss)):
                self._rollback()  # the remaining observations predate the rollback: dropped
                return
        if self.skipped_steps != skips_before:
            obs_spans.instant("guard_skip", step=self.iter_count, skipped=int(self.skipped_steps))
            if self._incidents is not None:
                bundle = self._incidents.capture(self.iter_count, "guard_skip",
                                                 detail={"skipped_steps": int(self.skipped_steps)})
                if bundle and offending_batch is not None:
                    self._capture_numerics(bundle, offending_batch)
            self.tracker.log({"resilience/skipped_steps": float(self.skipped_steps)}, step=self.iter_count)

    def _capture_numerics(self, bundle_dir: str, batch):
        """The NaN provenance of a guard-skip bundle
        (``incidents/<step>/numerics.json``), on the incident path only:

        - the gradient census: the gradient re-derived by autograd through
          ``_loss_fn`` on the offending batch, every non-finite trainable
          leaf named by its JAX-form path; it runs whenever incidents are
          armed, graftnum on or off;
        - the forward bisect (graftnum armed): one eager re-forward of the
          batch (``_numerics_forward``) with the probe taps live, naming the
          first block whose activations go non-finite, with the
          ``nan_layer`` drill's latched injection."""
        payload = {"step": int(self.iter_count), "reason": "guard_skip"}
        try:
            for p in self.trainable:
                p.grad = None
            with torch.enable_grad():
                loss, _ = self._loss_fn(batch)
                loss.backward()
            payload["grad_census"] = obs_numerics.nonfinite_census(
                [(n, p.grad) for n, p in zip(self.trainable_names, self.trainable)])
        except Exception as e:  # noqa: BLE001 — the incident path never ends the run
            payload["grad_census"] = {"error": repr(e)}
        finally:
            for p in self.trainable:
                p.grad = None
        if obs_numerics.enabled():
            with torch.no_grad():
                payload["forward_bisect"] = obs_numerics.bisect_forward(
                    lambda: self._numerics_forward(batch), inject=obs_numerics.consume_injection())
        obs_numerics.write_incident(bundle_dir, payload)

    def _numerics_forward(self, batch):
        """An eager forward of the model over a train batch for graftnum's
        bisector (outputs discarded); each trainer defines it."""
        raise NotImplementedError

    def _rollback(self):
        """The watchdog's response: restore the last intact checkpoint (in
        place: the bf16 and int8 weight copies refresh, so captured decode
        graphs read the restored weights), decay the LR, reset the watchdog
        and go on from the restored step; past ``train.max_rollbacks``
        raise TrainingDiverged."""
        self._rollbacks += 1
        # Before the restore (and the abort): the bundle shows the run at the divergence.
        obs_spans.instant("watchdog_rollback", step=self.iter_count)
        if self._incidents is not None:
            self._incidents.capture(self.iter_count, "watchdog_rollback", detail={"rollbacks": int(self._rollbacks)})
        t = self.config.train
        if self._rollbacks > t.max_rollbacks:
            raise TrainingDiverged(
                f"divergence watchdog fired after {t.max_rollbacks} rollback(s) already spent — training is not "
                "recovering. Lower the learning rate / tighten train.grad_clip, or raise train.max_rollbacks if the "
                "loss spikes are believed transient."
            )
        if is_main_process():
            print(f"[trlx_tpu_torch.resilience] divergence watchdog fired at step {self.iter_count} — rolling back "
                  f"({self._rollbacks}/{t.max_rollbacks})", file=sys.stderr, flush=True)
        try:
            self.load()
        except CheckpointError as e:
            raise TrainingDiverged(f"divergence watchdog fired at step {self.iter_count} but no restorable "
                                   f"checkpoint exists to roll back to: {e}") from e
        if t.watchdog_lr_decay < 1.0:
            self._lr_scale *= t.watchdog_lr_decay
            self._rebuild_for_lr_scale()
        self.watchdog.reset()
        self._res_pending = []
        self._res_batch_refs = []
        self.iter_count = int(self.step)
        self.tracker.log({"resilience/rollback_to_step": float(self.iter_count),
                          "resilience/rollbacks": float(self._rollbacks),
                          "resilience/lr_scale": float(self._lr_scale)}, step=self.iter_count)

    def _fire_host_faults(self):
        """The host-side drills of a step, each rank reading its own plan:
        ``slow_step@N`` stalls ``TRLX_TPU_SLOW_STEP_SECONDS`` (default 1)
        between step N's dispatch and its log-boundary sync, so the measured
        step time trips the anomaly detector; ``slow_host@N`` stalls
        ``TRLX_TPU_SLOW_SECONDS`` (default 2), a straggler under the
        deadline; ``host_desync@N`` skews this rank's copy of a replicated
        parameter (no collective) for the consistency guard; ``host_hang@N``
        sleeps ``TRLX_TPU_HANG_SECONDS`` (default 3600) with the heartbeat
        thread still writing, for the peers' collective guard; ``host_kill@N``
        ends the process at once (``os._exit(1)``)."""
        plan, step = self.fault_plan, self.iter_count
        if not plan:
            return
        if plan.fire("slow_step", step):
            time.sleep(float(os.environ.get("TRLX_TPU_SLOW_STEP_SECONDS", "1")))
        if plan.fire("slow_host", step):
            time.sleep(float(os.environ.get("TRLX_TPU_SLOW_SECONDS", "2")))
        if plan.fire("host_desync", step):
            dist_res.perturb_local_replicas(self.model)
        if plan.fire("host_hang", step):
            if self.heartbeat is not None:
                self.heartbeat.beat(step=step, phase="fault:host_hang")
            time.sleep(float(os.environ.get("TRLX_TPU_HANG_SECONDS", "3600")))
        if plan.fire("host_kill", step):
            os._exit(1)

    def _check_desync(self):
        """The consistency guard: all-gather and compare every rank's
        [step, replicated-parameter crc32, key crc32] fingerprint; every rank
        sees the same matrix and raises the same ``HostDesync``."""
        if world_size() == 1:
            return
        fingerprint = dist_res.host_fingerprint(self.iter_count, self.model, self.config.train.seed)
        fleet = self._fleet
        if fleet is not None:
            # Kept before the check: a desync's bundle shows what this rank brought.
            fleet.note_fingerprint(self.iter_count, fingerprint)
        try:
            dist_res.verify_fingerprints(fingerprint)
        except dist_res.HostDesync as e:
            if fleet is not None:
                fleet.incident_bundle(self.iter_count, "host_desync", detail=str(e))
            raise
        if fleet is not None:
            fleet.note_desync(self.iter_count, ok=True)

    # ----------------------------------------------------------------- learn

    def learn(self):
        """The training loop: epochs × store batches × n_updates_per_batch
        steps, ``post_backward_callback`` after every step, the checkpoint,
        log and eval cadence of ``train.checkpoint_interval`` /
        ``train.log_interval`` / ``train.eval_interval``,
        ``post_epoch_callback`` after every epoch (PPO: the next rollout
        phase), and a stop at ``total_steps``: a save, then ``evaluate()``.

        A resumed trainer counts on from its restored step; one that has
        already reached ``total_steps`` only evaluates. Interval saves
        follow ``train.async_checkpointing``; the one in flight is
        finalized on the way out. A SIGTERM (a preemption notice) is acted
        on after the current step, or at the next batch boundary: a save,
        a ``preempted_at_step`` record, and ``None`` is returned without
        evaluating. Otherwise returns the final ``evaluate()`` stats. The
        metrics endpoint closes on the way out; with device telemetry,
        graftscope or graftnum armed, ``<checkpoint_dir>/report.md`` is
        written last (``observability.report``)."""
        self.prepare_learning()
        self.iter_count = self.step if self._resumed else 0
        if self.iter_count >= self.total_steps:
            return self.evaluate()
        self._preempted = False
        # The telemetry window's anchor for trainers without a phase timer
        # (ILQL): the first window spans from here.
        self._telemetry_t0 = time.time()
        self._learn_start = self.iter_count

        def on_sigterm(signum, frame):
            self._preempted = True

        old_handler, installed = None, False
        try:
            old_handler = signal.signal(signal.SIGTERM, on_sigterm)
            installed = True
        except ValueError:  # not in the main thread
            pass
        try:
            return self._learn_loop()
        finally:
            # The pipeline's threads first (a prefetch feed, a rollout
            # producer): an early return (SIGTERM, total_steps mid-epoch) or
            # an exception leaves them running otherwise. Then the save in
            # flight: its sidecars (manifest, latest.txt) land only at
            # finalize.
            self._close_batch_feed()
            self._shutdown_experience_pipeline()
            self._finalize_pending_save()
            self._profile_stop()
            report = self._devicemon is not None or self._graftnum is not None
            if self._devicemon is not None:
                # programs.json with the dispatches since the last window.
                self._devicemon.flush()
            if self._graftscope is not None:
                # Joins the drain thread and writes the final snapshot.
                self._devicemon.ledger = None
                obs_graftscope.shutdown()
                self._graftscope = None
            if self._graftnum is not None:
                # Clears the instance and any latched injection.
                obs_numerics.shutdown()
                self._graftnum = None
            if self.heartbeat is not None:
                self.heartbeat.beat(step=self.iter_count, phase="exited")
                self.heartbeat.stop()
            if self._fleet is not None:
                # Closes the arrival file; the fleet's files stay for
                # read_fleet_spans and the skew table.
                obs_fleet.shutdown()
                self._fleet = None
            if self._metrics_exporter is not None:
                # Last: it serves the final gauges right up to teardown.
                self._metrics_exporter.close()
                self._metrics_exporter = None
            if installed:
                signal.signal(signal.SIGTERM, old_handler if old_handler is not None else signal.SIG_DFL)
            if report:
                self._write_report()

    def _write_report(self):
        """``<checkpoint_dir>/report.md`` on the main process (best-effort)."""
        if not is_main_process():
            return
        try:
            from trlx_tpu_torch.observability.report import build_report

            ckpt_dir = os.path.abspath(self.config.train.checkpoint_dir)
            ckpt_util.atomic_write_text(os.path.join(ckpt_dir, "report.md"), build_report(ckpt_dir))
        except Exception as e:  # noqa: BLE001 — a report never fails the run
            print(f"[trlx_tpu_torch.observability] report.md not written: {type(e).__name__}: {e}", file=sys.stderr)

    def _profile_tick(self):
        """``train.profile_dir``: ``torch.profiler`` (CPU and CUDA activities)
        over local steps [2, 5) of this ``learn()`` (past the first steps'
        captures and builds), on the main process; the trace goes to
        ``<profile_dir>/trace.json``."""
        profile_dir = self.config.train.profile_dir
        if not profile_dir or not is_main_process():
            return
        local = self.iter_count - self._learn_start
        if local == 2 and self._profiling is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._profiling = profile(activities=activities)
            self._profiling.start()
        elif self._profiling is not None and local >= 5:
            self._profile_stop()

    def _profile_stop(self):
        prof, self._profiling = self._profiling, None
        if prof is None:
            return
        prof.stop()
        os.makedirs(self.config.train.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.config.train.profile_dir, "trace.json"))

    def _prepare_batch(self, batch):
        """Host batch → (device batch, host extras): the host-only
        ``extras`` (the staleness column, a packed batch's fill) stay on
        the host."""
        return self.put_batch(batch), getattr(batch, "extras", None)

    def _train_batch_feed(self):
        """One epoch's feed of (device batch, host extras): inline
        (``SerialFeed``) by default; with the overlapped pipeline
        (``overlap_rollouts``) and ``method.prefetch_depth`` > 0 a
        ``PrefetchIterator`` stages batch k+1 while step k runs. Its copies
        are blocking copies from pageable host memory on the device's
        default stream, which the train steps use too: a staged batch is
        whole when it is handed over, and the card orders it with the
        steps."""
        depth = 0
        if getattr(self, "overlap_rollouts", False):
            depth = max(0, int(getattr(self.config.method, "prefetch_depth", 0) or 0))
        if depth > 0:
            feed = PrefetchIterator(self.train_dataloader, self._prepare_batch, depth=depth)
        else:
            feed = SerialFeed(self.train_dataloader, self._prepare_batch)
        self._active_feed = feed
        return feed

    def _close_batch_feed(self):
        feed, self._active_feed = getattr(self, "_active_feed", None), None
        if feed is not None:
            feed.close()

    def _shutdown_experience_pipeline(self):
        """Stop background experience machinery; PPO's override stops its
        rollout producer."""

    def _learn_loop(self):
        train = self.config.train
        timer = getattr(self, "_phase_timer", None)
        step_fn = self._wrap_monitored("train/step", self.train_step)
        for _ in range(train.epochs):
            feed = self._train_batch_feed()
            while True:
                try:
                    device_batch, host_extras = next(feed)
                except StopIteration:
                    break
                # A SIGTERM may land during the (long) rollout phase that
                # built this loader: save before spending a step on it.
                if self._any_preempted():
                    self._save_on_preemption()
                    return None
                train_t0 = time.time()
                phase_exclude_s = 0.0  # eval wall inside the train window
                for _ in range(self.n_updates_per_batch):
                    self._profile_tick()
                    if self.heartbeat is not None:
                        self.heartbeat.beat(step=self.iter_count, phase="train")
                    forward_t0 = time.time()
                    step_batch = device_batch
                    if self.fault_plan and self.fault_plan.fire("nan_grad", self.iter_count + 1):
                        # The drill: this step's float tensors NaN-poisoned;
                        # the non-finite guard must skip the update.
                        step_batch = poison_nan(device_batch)
                    if self.fault_plan and self.fault_plan.fire("nan_layer", self.iter_count + 1):
                        # graftnum's drill: the same poison (the guard trips)
                        # and a latched tap injection, so the bisector's
                        # re-forward must name that block first.
                        step_batch = poison_nan(device_batch)
                        n_layer = int(self.model.cfg.n_layer)
                        obs_numerics.latch_injection(f"block_{min(self.iter_count + 1, n_layer - 1)}")
                    stats = step_fn(step_batch)
                    self.iter_count += 1
                    self._fire_host_faults()
                    self.post_backward_callback(stats)
                    if self.watchdog is not None or "resilience/bad_steps" in stats:
                        self._res_pending.append((stats.get("loss"), stats.get("resilience/nonfinite"),
                                                  stats.get("resilience/bad_steps")))
                        # The step's device batch (a reference), for the
                        # guard-skip census; kept only while incidents are armed.
                        self._res_batch_refs.append(step_batch if self._incidents is not None else None)
                        if len(self._res_pending) >= max(train.log_interval, 8):
                            self._flush_resilience()
                    if self.fault_plan and self.fault_plan.fire("sigterm", self.iter_count):
                        # A real signal, so the installed handler acts on it.
                        os.kill(os.getpid(), signal.SIGTERM)
                    # The consistency guard: every rank enters at the same
                    # step (keyed on iter_count).
                    di = train.desync_check_interval
                    if di and self.iter_count % di == 0:
                        self._check_desync()
                    if self._fleet is not None:
                        # The clock resync: collective, keyed on iter_count.
                        self._fleet.maybe_resync(self.iter_count)
                    iv = self.intervals(self.iter_count)
                    if iv["do_checkpoint"]:
                        self.save(block=not train.async_checkpointing)
                    if iv["do_log"] or iv["do_eval"]:
                        self._flush_resilience()
                        stats_host = {k: float(v) for k, v in stats.items()}
                        stats_host["step_time"] = time.time() - forward_t0
                        obs_spans.complete("train/step", forward_t0, step=self.iter_count)
                        if self._anomaly is not None and self._anomaly.observe(stats_host["step_time"]):
                            self._incidents.capture(self.iter_count, "slow_step", detail={
                                "step_time": stats_host["step_time"], "p50": self._anomaly.p50(),
                                "factor": self._anomaly.factor})
                        if self._devicemon is not None and timer is None:
                            # Trainers without a phase timer (ILQL) close the
                            # telemetry window here; PPO at its rollout
                            # boundary (_log_phase_window).
                            now = time.time()
                            since = now - self._telemetry_t0
                            self._telemetry_t0 = now
                            obs_graftscope.host_interval("train", now - since, now)
                            stats_host.update(self._flush_device_telemetry({"train": since, "wall": since}))
                        stats_host["samples_per_sec"] = train.batch_size / max(stats_host["step_time"], 1e-9)
                        if iv["do_eval"]:
                            stats_host.update(self.evaluate())
                            phase_exclude_s += stats_host["eval_wall_time"]
                        # Host-side batch metadata (the producer's staleness
                        # column, a packed batch's fill), at log boundaries.
                        for k, v in (host_extras or {}).items():
                            v = np.asarray(v)
                            stats_host[f"{k}/mean"] = float(v.mean())
                            stats_host[f"{k}/max"] = float(v.max())
                        if self._graftnum is not None:
                            # Before the health gauges merge: the detectors
                            # judge this record's num/* values.
                            self._graftnum.observe_train(stats_host)
                        if self._health is not None:
                            self._observe_health(stats_host)
                        if self._graftnum is not None:
                            # The latest handoff's quantization gauges; the
                            # detectors' states only without a health monitor.
                            stats_host.update(self._graftnum.gauges(include_states=self._health is None))
                        self._export_metrics(stats_host)
                        if self._fleet is not None:
                            # Rank 0's fleet rollup (empty on the others).
                            stats_host.update(self._fleet.on_log_boundary(self.iter_count,
                                                                          exporter=self._metrics_exporter))
                        self.tracker.log(stats_host, step=self.iter_count)
                    # Independent of the log cadence.
                    wi = train.watch_interval
                    if wi and self.iter_count % wi == 0:
                        self.log_param_watch()
                    if self._preempted_mid_batch():
                        self._save_on_preemption()
                        return None
                    if self.iter_count >= self.total_steps:
                        self.save()
                        return self.evaluate()
                if timer is not None:
                    train_dt = max(0.0, time.time() - train_t0 - phase_exclude_s)
                    timer.add("train", train_dt)
                    obs_graftscope.host_interval("train", train_t0, train_t0 + train_dt)
            self._close_batch_feed()
            self.post_epoch_callback()
        self.save()
        return self.evaluate()

    def _observe_health(self, stats_host: dict):
        """The health feed at a log boundary: the ``entropy_collapse``
        drill's latch, the step's stats with the KL controller's state, then
        the ``health/*`` gauges ride along in the same record, and the
        lineage staleness histogram of the chunks since the last flush."""
        if self.fault_plan and self.fault_plan.fire("entropy_collapse", self.iter_count):
            self._health.inject_entropy_collapse()
        kl_ctl = getattr(self, "kl_ctl", None)
        self._health.observe_train(stats_host, self.iter_count, kl_coef=getattr(kl_ctl, "value", None),
                                   kl_target=getattr(kl_ctl, "target", None),
                                   kl_init_coef=getattr(self.config.method, "init_kl_coef", None))
        stats_host.update(self._health.gauges())
        self._health.maybe_log_lineage(self.tracker, self.iter_count)

    def _any_preempted(self) -> bool:
        """A SIGTERM reached some rank: every rank stops at the same step
        (an any-reduce over the ranks' flags, so the coordinated save is
        entered by all or by none)."""
        if world_size() == 1:
            return self._preempted
        return bool(allgather_host(np.asarray([self._preempted])).any())

    def _preempted_mid_batch(self) -> bool:
        """The check between the steps of a batch: the local flag for one
        process; with several, the agreement every
        ``train.preempt_check_interval`` steps (0: at batch boundaries
        only, keeping the collective off the step loop), as the JAX
        package."""
        if world_size() == 1:
            return self._preempted
        pi = self.config.train.preempt_check_interval
        return bool(pi) and self.iter_count % pi == 0 and self._any_preempted()

    def _save_on_preemption(self):
        self.save()
        self.tracker.log({"preempted_at_step": self.iter_count}, step=self.iter_count)

    # ------------------------------------------------------------ checkpoint

    def state_tensors(self) -> Dict[str, Dict]:
        """The live train state, by file: every named parameter, the
        extras, the optimizer state, and the step with the guard's
        consecutive skips."""
        return {
            "params": dict(self.model.named_parameters()),
            "extras": dict(self.extras),
            "optimizer": self.optimizer.state_dict(),
            "train_state": {"step": int(self.step), "bad_steps": int(self.bad_steps)},
        }

    def host_state_dict(self) -> dict:
        """Host-side state a resume restores besides the tensors
        (subclasses extend: PPO adds the KL coefficient). The port has no
        counterpart of the JAX package's ``next_rng`` key: every generator
        is a pure function of (train.seed, its key), so no ``rng`` is
        saved. The buffered resilience scalars are flushed first, so the
        counts are current."""
        self._flush_resilience(allow_rollback=False)
        return {
            "resilience": {
                "skipped_steps": int(self.skipped_steps),
                "rollbacks": int(self._rollbacks),
                "lr_scale": float(self._lr_scale),
            },
        }

    def load_host_state(self, d: dict):
        res = d.get("resilience", {})
        if res:
            self.skipped_steps = int(res.get("skipped_steps", self.skipped_steps))
            # Monotone merges, as in the JAX package: a restored older host
            # state never lowers the rollback count nor raises the LR scale.
            self._rollbacks = max(self._rollbacks, int(res.get("rollbacks", 0)))
            scale = min(self._lr_scale, float(res.get("lr_scale", 1.0)))
            if scale != self._lr_scale:
                self._lr_scale = scale
                self._rebuild_for_lr_scale()

    def save(self, directory: Optional[str] = None, block: bool = True):
        """Checkpoint the whole train state and the host state to
        ``<directory>/state_<step>`` (``train.checkpoint_dir`` by default).

        The state is copied to host memory now, so later steps cannot
        change what is written. ``block=False`` writes the files on one
        background thread and returns; the sidecars (host state, manifest,
        then ``latest.txt``) land at ``_finalize_pending_save``, which the
        next save, ``load()`` and the exit from ``learn()`` call first. At
        most one save is in flight. The files are written under
        ``state_<step>.tmp`` and renamed at finalize, so a crash before
        ``latest.txt`` is rewritten leaves the previous checkpoint as the
        resume point. A save of the state the last save already holds (the
        interval save of the step ``learn()`` stops at) writes nothing.

        With several processes the save blocks. On an unsplit mesh the main
        process writes and every rank leaves after the files are in place
        (a barrier). On a sharded mesh every rank that holds a distinct piece
        (dp and sp coordinate 0) writes its pieces, ``<group>.f<i>t<j>.pt``,
        beside ``layout.json`` (each parameter's placement); the main
        process then writes the manifest over every rank's files and flips
        ``latest.txt`` only after every rank has committed (``_write_shards``).
        ``load`` reassembles the pieces by the rules onto any mesh."""
        save_t0 = time.time()
        self._finalize_pending_save()
        directory = os.path.abspath(directory or self.config.train.checkpoint_dir)
        name = f"state_{int(self.step)}"
        host_state = self.host_state_dict()  # captured now: the KL coefficient moves on
        if self._saved == (directory, name, host_state):
            return
        if self.mesh.sharded:
            self._write_shards(directory, name, host_state)
        elif world_size() > 1:
            if is_main_process():
                self._write(directory, name, host_state, block=True)
            else:
                self._saved = (directory, name, host_state)
            barrier("save")
        else:
            self._write(directory, name, host_state, block)
        # The wall the train loop paid: through finalize when blocking, the
        # host copy alone when async (its finalize is a span of its own).
        obs_spans.complete("ckpt/save", save_t0, ckpt=name, blocking=bool(block))

    def _write(self, directory: str, name: str, host_state: dict, block: bool):
        t0 = time.perf_counter()
        snapshot = _host_copy(self.state_tensors())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        record = {"name": name, "async": not block, "d2h_s": time.perf_counter() - t0,
                  "host_bytes": _nbytes(snapshot)}
        pending = {"directory": directory, "name": name, "host_state": host_state, "record": record,
                   "t0": t0, "result": {}}
        path = os.path.join(directory, f"{name}.tmp")
        if block:
            _write_state(path, snapshot, pending["result"])
        else:
            pending["thread"] = threading.Thread(target=_write_state, args=(path, snapshot, pending["result"]),
                                                 name="trlx-ckpt-writer")
            pending["thread"].start()
        self._pending_save = pending
        if block:
            self._finalize_pending_save()

    def _write_shards(self, directory: str, name: str, host_state: dict):
        """The sharded save: the main process makes ``<name>.tmp``, each
        writer rank writes its pieces there, the (size, crc32) digests are
        all-gathered, and the main process finalizes (rename, host state,
        manifest over every file, then ``latest.txt``); a barrier ends it."""
        t0 = time.perf_counter()
        mesh = self.mesh
        path = os.path.join(directory, f"{name}.tmp")
        if is_main_process():
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path)
        barrier("save_shards")
        result = {"digests": {}, "bytes": 0, "write_s": 0.0, "crc_wait_s": 0.0}
        writer = mesh.coords[AXIS_DP] == 0 and mesh.coords[AXIS_SP] == 0
        record = {"name": name, "async": False, "d2h_s": 0.0, "host_bytes": 0, "sharded": True}
        if writer:
            state = self.state_tensors()
            suffix = f".f{mesh.coords[AXIS_FSDP]}t{mesh.coords[AXIS_TP]}"
            snapshot = {f"{f}{suffix}": _host_copy(state[f]) for f in ("params", "extras", "optimizer")}
            if is_main_process():
                snapshot["train_state"] = state["train_state"]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            record.update(d2h_s=time.perf_counter() - t0, host_bytes=_nbytes(snapshot))
            _write_state(path, snapshot, result, fresh=False)
            if "error" in result:
                raise CheckpointError(f"writing {name} failed") from result["error"]
            if is_main_process():
                layout = {n: _placement_json(placement_of(self.model, n)) for n in state["params"]}
                with ckpt_util.DigestWriter(os.path.join(path, "layout.json")) as w:
                    w.write(json.dumps({"mesh": list(mesh.shape.values()), "params": layout}).encode())
                result["digests"]["layout.json"] = (w.size, w.crc)
        gathered = coll.all_gather_object(result, mesh.group("world"))
        if is_main_process():
            merged = {"digests": {}, "bytes": 0, "write_s": 0.0, "crc_wait_s": 0.0}
            for r in gathered:
                merged["digests"].update(r["digests"])
                merged["bytes"] += sum(sz for sz, _ in r["digests"].values())
                merged["write_s"] = max(merged["write_s"], r["write_s"])
                merged["crc_wait_s"] = max(merged["crc_wait_s"], r["crc_wait_s"])
            self._pending_save = {"directory": directory, "name": name, "host_state": host_state, "record": record,
                                  "t0": t0, "result": merged}
            self._finalize_pending_save()
        else:
            self._saved = (directory, name, host_state)
        barrier("save_commit")

    def _finalize_pending_save(self) -> Optional[str]:
        """Drain the save in flight: join its writer, then atomically write
        host state, manifest and ``latest.txt`` (in that order — the pointer
        flips last), fire a ``ckpt_corrupt`` drill keyed by this completed
        save's index, and apply ``train.keep_checkpoints``. Returns the
        checkpoint's name, or None when no save was pending."""
        pending, self._pending_save = self._pending_save, None
        if pending is None:
            return None
        fin_t0 = time.time()
        t0 = time.perf_counter()
        if "thread" in pending:
            pending["thread"].join()
        result, record = pending["result"], pending["record"]
        if "error" in result:
            raise CheckpointError(f"writing {pending['name']} failed") from result["error"]
        record["join_s"] = time.perf_counter() - t0
        directory, name = pending["directory"], pending["name"]
        t1 = time.perf_counter()
        path = os.path.join(directory, name)
        if os.path.isdir(path):  # torn by a crash, or an older state of this step (reloaded, then changed)
            shutil.rmtree(path)
        os.replace(f"{path}.tmp", path)
        ckpt_util.atomic_write_json(os.path.join(directory, f"{name}.host.json"), pending["host_state"])
        ckpt_util.write_manifest(directory, name, ckpt_util.checkpoint_step(name), result["digests"])
        # basename, not abspath: checkpoint dirs move between machines.
        # Written LAST and atomically: a crash above leaves the old pointer.
        ckpt_util.atomic_write_text(os.path.join(directory, "latest.txt"), name)
        self._save_count += 1
        if self.fault_plan and self.fault_plan.fire("ckpt_corrupt", self._save_count):
            rel = ckpt_util.corrupt_checkpoint(directory, name)
            print(f"[trlx_tpu_torch.resilience] injected checkpoint corruption: truncated {name}/{rel}",
                  file=sys.stderr)
        ckpt_util.gc_checkpoints(directory, self.config.train.keep_checkpoints, protect=(name,))
        record.update(bytes=result["bytes"], write_s=result["write_s"], crc_wait_s=result["crc_wait_s"],
                      manifest_s=time.perf_counter() - t1, finalize_s=time.perf_counter() - t0,
                      save_s=time.perf_counter() - pending["t0"])
        self.checkpoint_log.append({"op": "save", **record})
        self.tracker.log({"save_time": record["save_s"]}, step=self.iter_count)
        self._saved = (directory, name, pending["host_state"])
        obs_spans.complete("ckpt/finalize", fin_t0, ckpt=name)
        return name

    def _maybe_resume(self):
        """With ``train.resume_from_checkpoint``, restore the latest
        checkpoint if ``latest.txt`` exists (a trainer calls this at the end
        of its build, before any rollout, so PPO's first experience comes
        from the restored policy)."""
        if not self.config.train.resume_from_checkpoint:
            return
        path = os.path.join(os.path.abspath(self.config.train.checkpoint_dir), "latest.txt")
        if not broadcast_host(os.path.exists(path)):  # every rank takes the main process's answer
            return
        self.load()
        self._resumed = True
        print(f"[trlx_tpu_torch] resumed from step {self.step}", file=sys.stderr)

    def load(self, directory: Optional[str] = None):
        """Restore the train state and host state saved by ``save``.

        Candidates are tried from the ``latest.txt`` pointer, then every
        other ``state_*`` newest first; each is manifest-verified before it
        is read, and one that fails verification, reading or the
        name-and-shape check falls back to the previous intact checkpoint
        (``last_restore_fallback``). The values are copied in place into
        the existing parameters, moments and extras, so the bf16 weight
        copies and a captured decode graph read them. Raises
        CheckpointError with every attempt when nothing is restorable."""
        t_load = time.perf_counter()
        load_t0 = time.time()
        self._finalize_pending_save()  # a pending async save IS the latest
        self._saved = None
        directory = os.path.abspath(directory or self.config.train.checkpoint_dir)
        latest_path = os.path.join(directory, "latest.txt")
        latest = None
        if os.path.exists(latest_path):
            with open(latest_path) as f:
                latest = f.read().strip() or None
        candidates = [] if latest is None else [os.path.basename(latest)]
        candidates += [n for n in ckpt_util.list_checkpoints(directory) if n not in candidates]
        if not candidates:
            raise CheckpointError(
                f"no checkpoint found in {directory}: "
                + ("latest.txt is empty" if os.path.exists(latest_path) else "latest.txt is missing")
                + " and no state_* directories exist — nothing to resume from "
                "(set train.resume_from_checkpoint=False to start fresh, or "
                "point train.checkpoint_dir at the directory that holds the run)"
            )
        attempts = []
        for i, name in enumerate(candidates):
            path = os.path.join(directory, name)
            with ckpt_util.mark_in_use(directory, name):
                t0 = time.perf_counter()
                # The main process verifies; every rank takes its answer.
                ok, reason = broadcast_host(ckpt_util.verify_checkpoint(directory, name) if is_main_process()
                                            else None)
                if not ok:
                    attempts.append(f"{name}: {reason}")
                    continue
                t1 = time.perf_counter()
                try:
                    # Mapped from the files on the host, then copied into the
                    # live tensors: a load onto the device would hold a second
                    # copy of the whole state on the card. Sharded files are
                    # reassembled a tensor at a time.
                    state = _StateReader(path)
                    self._check_state(state)
                    error = None
                except (OSError, RuntimeError, ValueError, KeyError, EOFError) as e:
                    error = f"{name}: read failed ({type(e).__name__}: {e})"
                if world_size() > 1:
                    errors = [e for e in allgather_host(np.asarray([error or ""], dtype=object)) if e]
                    error = errors[0] if errors else None
                if error is not None:
                    attempts.append(error)
                    continue
                t2 = time.perf_counter()
                self._copy_state(state)
                del state
                t3 = time.perf_counter()
                self.last_restore_fallback = i > 0
                if i > 0:
                    print(f"[trlx_tpu_torch.resilience] latest checkpoint unusable ({'; '.join(attempts)}) "
                          f"— fell back to {name}", file=sys.stderr)
                host_file = f"{path}.host.json"
                if os.path.exists(host_file):
                    with open(host_file) as f:
                        self.load_host_state(json.load(f))
                self.checkpoint_log.append({
                    "op": "load", "name": name, "fallback": i > 0, "verify_s": t1 - t0, "read_s": t2 - t1,
                    "copy_s": t3 - t2, "load_s": time.perf_counter() - t_load,
                    "bytes": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
                })
                obs_spans.complete("ckpt/load", load_t0, ckpt=name, fallback=bool(i > 0))
                return name
        raise CheckpointError(
            f"no restorable checkpoint in {directory} — every candidate failed verification or reading: "
            f"{'; '.join(attempts)}. If the data is gone, set train.resume_from_checkpoint=False to start fresh."
        )

    def _check_state(self, state: "_StateReader"):
        """Raise ValueError unless a read checkpoint names exactly this
        trainer's parameters and extras, each of its whole shape, and this
        optimizer's moments."""
        whole = {n: tuple(placement_of(self.model, n).full_shape) if placement_of(self.model, n) else tuple(p.shape)
                 for n, p in self.model.named_parameters()}
        for f, names in (("params", list(whole)), ("extras", list(self.extras)),
                         ("optimizer:mu", self.optimizer.names or []), ("optimizer:nu", self.optimizer.names or [])):
            got = state.names(f)
            if set(got) != set(names):
                missing, extra = sorted(set(names) - set(got)), sorted(set(got) - set(names))
                raise ValueError(f"{f}: missing {missing[:4]}, unexpected {extra[:4]}")
            for n in names:
                if state.shape(f, n) != whole[n]:
                    raise ValueError(f"{f} {n}: shape {state.shape(f, n)} != {whole[n]}")

    @torch.no_grad()
    def _copy_state(self, state: "_StateReader"):
        """Copy a checked state into the live tensors, in place (each whole
        tensor cut to this rank's piece by the current mesh's rules), and
        bring the model's bf16 weight copies up to date."""
        def piece(f, n):
            return shard_tensor(self.model, n, state.whole(f, n))

        for n, p in self.model.named_parameters():
            p.copy_(piece("params", n))
        for n, t in self.extras.items():
            t.copy_(piece("extras", n))
        opt = self.optimizer
        opt._require_names()
        for key, own in (("mu", opt.mu), ("nu", opt.nu)):
            for n, m in zip(opt.names, own):
                m.copy_(piece(f"optimizer:{key}", n))
        opt.count = int(state.optimizer_count())
        ts = state.train_state()
        self.step = int(ts["step"])
        self.bad_steps = int(ts["bad_steps"])
        refresh_weight_copies(self.model)

    # ------------------------------------------------------------ HF export

    def save_pretrained(self, out_dir: str, family: Optional[str] = None) -> str:
        """Export the trained trunk as an HF checkpoint directory
        (``config.json``, f32 safetensors) and every other parameter (value
        head, ILQL's Q and V heads) beside it in ``trlx_tpu_heads.npz``. The
        frozen extras (the reference branch, the target Q heads) are not
        exported. Streams one tensor at a time from the device. Returns
        ``out_dir``."""
        params = self.full_params()  # every rank: a collective on a sharded mesh
        if is_main_process():
            heads = {k: v for k, v in params.items() if not k.startswith("transformer.")}
            export_hf(params, self.model.cfg, out_dir, family=family, head_params=heads)
        del params
        barrier("save_pretrained")  # the other ranks wait for the export to land
        return out_dir

    # ------------------------------------------------------- BaseRL protocol

    def act(self, data):
        """(tokens, mask) of one rollout of ``data``'s prompts."""
        return self.rollout_generate(data["input_ids"], data["attention_mask"])

    def sample(self, prompts, length: int = None, n_samples: int = None):
        """Sample continuations: ``n_samples`` rows by tiling or truncating
        the prompt batch, the response clipped to ``length`` tokens, at most
        the configured response length (a longer request warns once).
        Returns the tokens [n_samples, P + min(length, R)] on the host."""
        ids = np.asarray(prompts["input_ids"])
        mask = np.asarray(prompts["attention_mask"])
        n = n_samples if n_samples is not None else ids.shape[0]
        reps = -(-n // ids.shape[0])
        ids, mask = np.tile(ids, (reps, 1))[:n], np.tile(mask, (reps, 1))[:n]
        tokens, _ = self.rollout_generate(ids, mask)
        tokens = self.to_host(tokens)
        if length is not None:
            P = ids.shape[1]
            configured = tokens.shape[1] - P
            if int(length) > configured and not getattr(self, "_warned_sample_clip", False):
                self._warned_sample_clip = True
                warnings.warn(
                    f"sample(length={int(length)}) exceeds the configured response length {configured}; output is "
                    f"clipped to {configured} new tokens (raise method.gen_kwargs max tokens to generate more)",
                    stacklevel=2,
                )
            tokens = tokens[:, : P + min(int(length), configured)]
        return tokens


_STATE_FILES = ("params", "extras", "optimizer", "train_state")


def _host_copy(tree):
    """A host copy of every tensor in a nest of dicts (a copy on the CPU
    too: the snapshot must not follow the live tensors)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return tree


def _nbytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return 0


def _placement_json(pl) -> Optional[dict]:
    if pl is None:
        return None
    return {"full_shape": list(pl.full_shape), "fsdp_dim": pl.fsdp_dim, "tp_dim": pl.tp_dim, "qkv": pl.qkv,
            "fsdp": pl.fsdp, "tp": pl.tp}


class _StateReader:
    """A checkpoint's tensors as WHOLE tensors by (group, name), whatever
    the mesh that wrote it: the single-file groups (``params.pt``, ...), or
    a sharded save's pieces (``params.f<i>t<j>.pt``, ...) reassembled by
    ``layout.json``'s placements a tensor at a time. Groups: "params",
    "extras", "optimizer:mu", "optimizer:nu"."""

    def __init__(self, path: str):
        def load(f):
            return torch.load(os.path.join(path, f), map_location="cpu", mmap=True, weights_only=True)

        layout_path = os.path.join(path, "layout.json")
        self.layout = None
        if os.path.exists(layout_path):
            from trlx_tpu_torch.parallel.sharding import Placement

            with open(layout_path) as fh:
                spec = json.load(fh)
            self.layout = {n: None if d is None else Placement(tuple(d["full_shape"]), d["fsdp_dim"], d["tp_dim"],
                                                                d["qkv"], d["fsdp"], d["tp"])
                           for n, d in spec["params"].items()}
            pieces = {}
            for fname in os.listdir(path):
                stem, _, _ = fname.rpartition(".")
                group, _, coord = stem.partition(".")
                if coord.startswith("f") and group in ("params", "extras", "optimizer"):
                    fi, ti = coord[1:].split("t")
                    pieces.setdefault(group, {})[(int(fi), int(ti))] = load(fname)
            self._pieces = pieces
            self._train_state = load("train_state.pt")
        else:
            self._groups = {f: load(f"{f}.pt") for f in _STATE_FILES}

    def _table(self, group: str, coord=None):
        top, _, key = group.partition(":")
        if self.layout is None:
            t = self._groups[top]
        else:
            t = self._pieces[top][coord if coord is not None else next(iter(self._pieces[top]))]
        return t[key] if key else t

    def names(self, group: str):
        return list(self._table(group))

    def shape(self, group: str, name: str):
        pl = None if self.layout is None else self.layout.get(name)
        return tuple(pl.full_shape) if pl is not None else tuple(self._table(group)[name].shape)

    def whole(self, group: str, name: str) -> torch.Tensor:
        pl = None if self.layout is None else self.layout.get(name)
        if pl is None:
            return self._table(group)[name]
        top = group.partition(":")[0]
        return pl.assemble({c: self._table(group, c)[name] for c in self._pieces[top]})

    def optimizer_count(self) -> int:
        return int(self._table("optimizer")["count"])

    def train_state(self) -> dict:
        return self._train_state if self.layout is not None else self._groups["train_state"]


def _write_state(path: str, snapshot: Dict[str, Dict], result: Dict, fresh: bool = True):
    """Write one ``torch.save`` file per state group into ``path`` (made
    anew: a temporary directory the finalize renames), fsynced, with each file's (size, crc32) taken as it is written.
    Fills ``result`` with the digests, the bytes and the seconds, or with
    the error (this runs on the async save's writer thread too). With
    ``fresh`` False the directory exists already (a sharded save's, shared
    by its writer ranks)."""
    try:
        t0 = time.perf_counter()
        if fresh:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path)
        digests, crc_wait_s = {}, 0.0
        for f, group in snapshot.items():
            with ckpt_util.DigestWriter(os.path.join(path, f"{f}.pt")) as w:
                torch.save(group, w)
            digests[f"{f}.pt"] = (w.size, w.crc)
            crc_wait_s += w.crc_wait_s
        result.update(digests=digests, bytes=sum(s for s, _ in digests.values()), crc_wait_s=crc_wait_s,
                      write_s=time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 — re-raised by _finalize_pending_save
        result["error"] = e
