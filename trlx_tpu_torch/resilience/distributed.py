"""Multi-process resilience: heartbeats, the collective hang guard and the
cross-rank consistency guard (the counterpart of
``trlx_tpu.resilience.distributed``).

A JAX process is a host; a port process is one card, and can die alone, so
every check here counts per RANK:

- **Heartbeats**: each rank's ``Heartbeat`` thread writes an atomic
  ``heartbeats/rank_<r>.json`` (last step, phase, progress stamp) every
  ``train.heartbeat_interval`` seconds. Progress is stamped by ``beat()``
  from the train loop and the orchestrator, so a rank that is alive but
  stuck (``written_t`` advancing, ``progress_t`` frozen) is told from one
  that makes progress.
- **Collective hang guard**: ``collective_guard(name)`` wraps every blocking
  collective between processes: the host collectives of ``parallel.mesh``
  (``allgather_host``, ``broadcast_host``, ``barrier``) and each train
  step, whose tensor collectives block in the calling thread. One that
  outlives ``train.collective_deadline`` seconds means a peer died or
  wedged: the guard's timer prints a ``CollectiveTimeout`` naming the step
  and the slowest rank (from the heartbeat files) and ends the process with
  ``EXIT_COLLECTIVE_TIMEOUT`` (117), an exit every supervisor can restart.
  A collective blocks its thread inside the backend, so no exception can be
  raised into it: the abort comes from the timer thread. A backend error
  inside an armed guard (gloo sees a dead peer's socket close at once) ends
  the process the same way. The deadline must exceed a train step's time.
- **Consistency guard**: ``host_fingerprint`` condenses a rank's view
  (step counter, crc32 of its copy of a replicated parameter, a key crc)
  into three ints; ``verify_fingerprints`` all-gathers and compares them
  every ``train.desync_check_interval`` steps and raises the same
  ``HostDesync`` on every rank, naming the ranks that differ from rank 0.
- **Engine schedule check**: ``verify_engine_schedule`` all-gathers each
  rank's rolling crc of its slot manager's decisions (the rollout engine's
  ``schedule_fingerprint``) at the end of an engine phase and raises the
  same ``HostDesync`` on every rank, naming the ranks whose schedule
  differs from rank 0's. ``TRLX_TPU_ENGINE_SCHEDULE_SKEW`` (a nonzero int)
  XORs this rank's reported crc: the drill of a desynced slot manager.
- **Drills**: ``perturb_local_replicas`` skews one rank's copy of a
  replicated parameter (``host_desync``); ``host_hang``, ``host_kill`` and
  ``slow_host`` fire in the trainer, ``mid_decode_host_kill`` in the
  orchestrator's engine loop (``resilience/faults.py``).

A guard's ``detail`` (a callable, e.g. the engine's slot states) is
evaluated only when the guard fires and lands in the emergency incident
capture's ``detail``; with graftfleet armed (``observability.fleet``) every
guarded collective also leaves this rank's arrival record, and a firing
guard writes the cross-rank incident bundle.
"""

import json
import os
import sys
import threading
import time
import traceback
import zlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from trlx_tpu_torch.resilience.checkpoint import atomic_write_text
from trlx_tpu_torch.utils import sanitize

EXIT_COLLECTIVE_TIMEOUT = 117


class CollectiveTimeout(RuntimeError):
    """A collective between processes exceeded train.collective_deadline:
    some rank died or wedged inside it. The message names the collective,
    the step and the slowest rank (from the heartbeat files)."""


class HostDesync(RuntimeError):
    """Ranks disagree on the run state (step counter, replicated parameter
    crc, key): training would go on with diverged replicas. The message
    names the ranks and the component."""


# ------------------------------------------------------------------ heartbeat


class Heartbeat:
    """A rank's liveness and progress file. ``beat(step, phase)`` stores
    under a lock (no I/O); a daemon thread writes the latest beat to
    ``<directory>/rank_<r>.json`` (atomically) every ``interval`` seconds."""

    def __init__(self, directory: str, interval: float, rank: int = 0):
        self.directory = directory
        self.interval = float(interval)
        self.rank = int(rank)
        # beat() runs on whichever thread makes progress and _write() on the
        # writer thread: the lock keeps a record from tearing across step,
        # phase and stamps (tracked under TRLX_TPU_SANITIZE=race).
        self._lock = sanitize.make_lock("Heartbeat._lock")
        self.step = 0
        self.phase = "init"
        self.progress_t = time.time()
        self.progress_mono = time.monotonic()
        self._stop = threading.Event()
        self._thread = None

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"rank_{self.rank}.json")

    def beat(self, step: Optional[int] = None, phase: Optional[str] = None):
        with self._lock:
            sanitize.race_access(self, "beat_state", write=True)
            if step is not None:
                self.step = int(step)
            if phase is not None:
                self.phase = phase
            self.progress_t = time.time()
            self.progress_mono = time.monotonic()

    def _write(self):
        with self._lock:
            sanitize.race_access(self, "beat_state")
            payload = json.dumps({"rank": self.rank, "step": self.step, "phase": self.phase,
                                  "progress_t": self.progress_t, "progress_mono": self.progress_mono,
                                  "written_t": time.time(), "written_mono": time.monotonic()})
        atomic_write_text(self.path, payload)

    def start(self):
        os.makedirs(self.directory, exist_ok=True)
        self._write()
        if self.interval <= 0:
            return self

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self._write()
                except OSError:
                    pass  # the heartbeat must never end the run it watches

        self._thread = threading.Thread(target=run, name="trlx-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 1.0)
            self._thread = None
        try:
            self._write()
        except OSError:
            pass


def read_heartbeats(directory: str) -> Dict[int, dict]:
    """Every rank's heartbeat record, by rank; unreadable files skipped."""
    out = {}
    if not os.path.isdir(directory):
        return out
    for fname in os.listdir(directory):
        if not (fname.startswith("rank_") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fname)) as f:
                rec = json.load(f)
            out[int(rec["rank"])] = rec
        except (OSError, ValueError, KeyError):
            continue
    return out


def stall_report(directory: str, collective: str, now: Optional[float] = None) -> str:
    """Name the slowest rank from the heartbeat files: among the ranks whose
    phase is not inside the timed-out collective (the waiters are), the one
    with the oldest progress stamp (then the lowest step); over every rank
    when all look inside."""
    now = time.time() if now is None else now
    beats = read_heartbeats(directory)
    if not beats:
        return "no heartbeat files found — enable train.heartbeat_interval for rank-level diagnostics"
    stragglers = {i: r for i, r in beats.items() if r.get("phase") != f"collective:{collective}"} or beats
    culprit = min(stragglers.values(), key=lambda r: (r.get("progress_t", 0), r.get("step", 0)))
    age = now - culprit.get("progress_t", now)
    lines = ", ".join(f"rank {i}: step {r.get('step')} phase {r.get('phase')!r} "
                      f"({now - r.get('progress_t', now):.1f}s since progress)" for i, r in sorted(beats.items()))
    return (f"slowest rank: rank {culprit.get('rank')} (last progress at step {culprit.get('step')}, phase "
            f"{culprit.get('phase')!r}, {age:.1f}s ago) — [{lines}]")


# ----------------------------------------------------------- collective guard

# Set by the trainer from train.*; deadline <= 0 leaves every guard a no-op.
_CONFIG = {"deadline": 0.0, "heartbeat": None, "step_provider": None, "on_timeout": None}


def configure(deadline: float = 0.0, heartbeat: Optional[Heartbeat] = None,
              step_provider: Optional[Callable[[], int]] = None, on_timeout: Optional[Callable] = None):
    """Arm (or disarm, deadline 0) the process-global collective guard."""
    _CONFIG.update(deadline=float(deadline), heartbeat=heartbeat, step_provider=step_provider,
                   on_timeout=on_timeout)


def _default_on_timeout(exc: CollectiveTimeout):
    """Print the diagnostic and end the process: ``os._exit``, since the
    main thread is blocked inside the backend and would never unwind."""
    print(f"[trlx_tpu_torch.resilience] FATAL: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
    traceback.print_stack(file=sys.stderr)
    sys.stderr.flush()
    os._exit(EXIT_COLLECTIVE_TIMEOUT)


# The guards this thread is inside, outermost first: a guard that fires
# inside another (the host all-gather of the engine's schedule check) names
# the outer site and carries its detail too.
_ACTIVE = threading.local()


class collective_guard:
    """A deadline around one blocking collective: ``with
    collective_guard("allgather_host"): ...``. Past the deadline the timer
    thread raises the alarm (default: diagnostic, then exit 117); so does a
    backend error raised inside (``only_collectives`` False: a body that
    also computes, where only ``torch.distributed.DistError`` counts). An
    explicit ``deadline`` / ``on_timeout`` overrides the process-global
    configuration (tests)."""

    def __init__(self, name: str, deadline: Optional[float] = None, on_timeout: Optional[Callable] = None,
                 only_collectives: bool = True, detail: Optional[Callable[[], dict]] = None):
        self.name = name
        self.only_collectives = only_collectives
        self.deadline = _CONFIG["deadline"] if deadline is None else float(deadline)
        self.on_timeout = on_timeout or _CONFIG["on_timeout"] or _default_on_timeout
        # Extra forensic fields for the incident bundle (the engine's slot
        # states), evaluated only on the abort path.
        self.detail = detail
        self._timer = None
        self._fleet_t0 = None
        self._outer = []

    def _fire(self, cause: Optional[BaseException] = None):
        step = None
        provider = _CONFIG["step_provider"]
        if provider is not None:
            try:
                step = provider()
            except Exception:  # noqa: BLE001 — the abort path must still abort
                step = None
        extra = {}
        for guard in self._outer + [self]:
            if guard.detail is not None:
                try:
                    extra.update(guard.detail())
                except Exception:  # noqa: BLE001 — forensics must not block the abort
                    pass
        site = self._outer[0].name if self._outer else self.name
        if site != self.name:
            extra["op"] = self.name
        try:
            from trlx_tpu_torch.observability import anomaly as obs_anomaly
            from trlx_tpu_torch.observability import spans as obs_spans

            obs_spans.instant("collective_timeout", collective=self.name, deadline_s=self.deadline)
            obs_anomaly.emergency_capture("collective_timeout", detail={"collective": site, **extra})
        except Exception:  # noqa: BLE001 — the abort path must still abort
            pass
        try:
            # graftfleet: every reachable rank's span tail and heartbeat into
            # incidents/<step>/ (the wedged peer cannot dump its own).
            from trlx_tpu_torch.observability import fleet as obs_fleet

            obs_fleet.incident_bundle(step, "collective_timeout",
                                      detail={"collective": site, "deadline_s": self.deadline, **extra})
        except Exception:  # noqa: BLE001 — the abort path must still abort
            pass
        hb = _CONFIG["heartbeat"]
        if hb is not None:
            try:
                hb._write()  # this rank's own file shows it inside the collective now
            except OSError:
                pass
        detail = (stall_report(hb.directory, self.name) if hb is not None
                  else "no heartbeat configured — set train.heartbeat_interval to name the slow rank")
        what = (f"exceeded train.collective_deadline={self.deadline:g}s" if cause is None else
                f"failed ({type(cause).__name__}: {str(cause).splitlines()[0][:200]}) under "
                f"train.collective_deadline={self.deadline:g}s")
        self.on_timeout(CollectiveTimeout(
            f"collective {self.name!r} {what} at step {step} — a peer rank died or hung; {detail}. Aborting so the "
            "supervisor can restart and resume from the last coordinated checkpoint."))

    def __enter__(self):
        from trlx_tpu_torch.observability import fleet as obs_fleet

        # graftfleet's arrival stamp, before the deadline gate: straggler
        # attribution also covers guards left at deadline 0.
        if obs_fleet.armed():
            self._fleet_t0 = time.time()
        stack = getattr(_ACTIVE, "stack", None)
        if stack is None:
            stack = _ACTIVE.stack = []
        # Written before the timer thread starts (Thread.start orders the
        # write before _fire's read) and never again.
        self._outer = list(stack)  # graftlint: disable=GL008 -- set before the timer starts, never rewritten
        stack.append(self)
        if self.deadline <= 0:
            return self
        hb = _CONFIG["heartbeat"]
        if hb is not None:
            hb.beat(phase=f"collective:{self.name}")
        self._timer = threading.Timer(self.deadline, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _ACTIVE.stack
        if stack and stack[-1] is self:
            stack.pop()
        if self._fleet_t0 is not None:
            from trlx_tpu_torch.observability import fleet as obs_fleet

            obs_fleet.collective_complete(self.name, self._fleet_t0, time.time())
            self._fleet_t0 = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
            if isinstance(exc, HostDesync):
                return False  # the checks' coordinated, named abort: raised as it is on every rank
            if isinstance(exc, dist.DistError) or (self.only_collectives and isinstance(exc, RuntimeError)):
                # gloo notices a dead peer's closed socket at once, where NCCL
                # would wait: the same diagnostic and exit as a deadline. A
                # guard whose body also computes (a train step) converts only
                # the backend's own error class.
                self._fire(cause=exc)
        return False


# ---------------------------------------------------------- consistency guard


def _crc_of(t) -> int:
    arr = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def replicated_parameter(module: torch.nn.Module):
    """The first float parameter every rank holds whole (a layer norm's
    scale under the rules; anything on a pure-dp mesh): its copies must be
    bit-equal across ranks. None when every float parameter is split."""
    from trlx_tpu_torch.models.lm import placement_of

    for name, p in module.named_parameters():
        if not p.is_floating_point():
            continue
        pl = placement_of(module, name)
        if pl is None or (pl.fsdp_dim is None and pl.tp_dim is None):
            return p
    return None


def host_fingerprint(step: int, module: torch.nn.Module, key: int = 0) -> np.ndarray:
    """This rank's view of the run as int64[3]: [step, crc32 of its copy of
    the first replicated parameter, ``key``'s crc32] (the port's generators
    are pure functions of the seed, so the key is the seed)."""
    p = replicated_parameter(module)
    return np.asarray([int(step), 0 if p is None else _crc_of(p), zlib.crc32(str(int(key)).encode())],
                      dtype=np.int64)


_FINGERPRINT_FIELDS = ("step counter", "param replica crc32", "rng key crc32")


def compare_fingerprints(gathered: np.ndarray) -> None:
    """Raise HostDesync when any rank's row of the all-gathered (ranks, 3)
    matrix differs from rank 0's. Every rank holds the same matrix, so every
    rank raises the same error."""
    gathered = np.asarray(gathered).reshape(-1, len(_FINGERPRINT_FIELDS))
    ref = gathered[0]
    problems = []
    for r in range(1, gathered.shape[0]):
        bad = [f"{_FINGERPRINT_FIELDS[j]} {gathered[r, j]} != {ref[j]}" for j in range(gathered.shape[1])
               if gathered[r, j] != ref[j]]
        if bad:
            problems.append(f"rank {r}: " + ", ".join(bad))
    if problems:
        raise HostDesync("cross-rank consistency check failed vs rank 0 — " + "; ".join(problems)
                         + ". Replicas have silently diverged (a flaky card or host, a torn restore, or "
                         "non-deterministic host code); restart every rank from the last coordinated checkpoint.")


def verify_fingerprints(fingerprint: np.ndarray) -> None:
    """All-gather this rank's fingerprint (guarded) and compare; a single
    process is trivially consistent."""
    from trlx_tpu_torch.parallel.mesh import allgather_host, world_size

    if world_size() == 1:
        return
    compare_fingerprints(allgather_host(np.asarray(fingerprint)[None, :]))


def verify_engine_schedule(schedule_crc: int, phase: Optional[int] = None) -> None:
    """Check that every rank's slot manager made the same admission, pool
    and harvest decisions this engine phase: all-gather [phase, crc] (the
    engine's ``schedule_fingerprint``) and raise the same ``HostDesync`` on
    every rank, naming the ranks that differ from rank 0. A rank whose
    schedule diverged would launch decode steps with other live rows and
    hang its tp peers inside a collective; the check names it at the phase
    boundary instead. A single process is trivially consistent.

    Drill hook: ``TRLX_TPU_ENGINE_SCHEDULE_SKEW`` (a nonzero int) XORs THIS
    rank's reported crc, the signature of a desynced slot manager (a real
    divergence would wedge in a decode collective before any check ran, so
    the drill skews the report, not the schedule)."""
    from trlx_tpu_torch.parallel.mesh import allgather_host, world_size

    if world_size() == 1:
        return
    crc = int(schedule_crc) & 0xFFFFFFFF
    skew = int(os.environ.get("TRLX_TPU_ENGINE_SCHEDULE_SKEW", "0") or "0")
    if skew:
        crc ^= skew & 0xFFFFFFFF
    _same_as_rank0(allgather_host(np.asarray([[int(phase or 0), crc]], dtype=np.int64)),
                   ("engine phase counter", "slot schedule crc32"), "engine slot-schedule check",
                   "The slot managers made different admission/harvest decisions (non-deterministic host code or "
                   "skewed prompt data); the next decode step would hang the ranks in a collective. Restart the "
                   "phase with identical inputs on every rank.")


def _same_as_rank0(gathered, fields, check: str, consequence: str) -> None:
    """Raise the same ``HostDesync`` on every rank when any rank's row of
    the all-gathered matrix differs from rank 0's, naming the ranks and
    fields."""
    gathered = np.asarray(gathered).reshape(-1, len(fields))
    problems = []
    for r in range(1, gathered.shape[0]):
        bad = [f"{fields[j]} {gathered[r, j]} != {gathered[0, j]}" for j in range(len(fields))
               if gathered[r, j] != gathered[0, j]]
        if bad:
            problems.append(f"rank {r}: " + ", ".join(bad))
    if problems:
        raise HostDesync(f"{check} failed vs rank 0 — " + "; ".join(problems) + ". " + consequence)


def verify_weight_pushes(pushes, phase: Optional[int] = None) -> None:
    """Check that every rank adopted the same in-flight weight pushes at the
    same engine syncs this phase: all-gather [phase, count, crc32 of the
    (sync, version) list] and raise the same ``HostDesync`` on every rank,
    naming the ranks that differ from rank 0 (a rollout role whose ranks
    decoded with different weights). A single process is trivially
    consistent."""
    from trlx_tpu_torch.parallel.mesh import allgather_host, world_size

    if world_size() == 1:
        return
    crc = zlib.crc32(json.dumps([[int(t), None if v is None else int(v)] for t, v in pushes]).encode())
    _same_as_rank0(allgather_host(np.asarray([[int(phase or 0), len(pushes), crc]], dtype=np.int64)),
                   ("engine phase counter", "weight pushes", "push schedule crc32"), "in-flight weight push check",
                   "The ranks adopted different weight versions at different decode steps, so they decoded with "
                   "different weights; every rank must take rank 0's adoption decision.")


@torch.no_grad()
def perturb_local_replicas(module: torch.nn.Module, scale: float = 1e-3):
    """Skew THIS rank's copy of the first replicated parameter in place
    (the ``host_desync`` drill); no collective runs, the other ranks keep
    theirs."""
    p = replicated_parameter(module)
    if p is not None:
        p.mul_(1.0 + scale)
