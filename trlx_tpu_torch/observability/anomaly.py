"""Anomaly detection and one-shot incident bundles (the counterpart of
``trlx_tpu.observability.anomaly``).

The trainer feeds the per-step wall time it measures at log boundaries to
``AnomalyDetector``; a step over ``factor × rolling p50``, or a resilience
event (a guard skip, a watchdog rollback, a health detector's CRIT), writes
an incident bundle under ``<checkpoint_dir>/incidents/<step>/`` (a second
one at the same step under ``<step>.1/``, where the JAX package overwrites
the first):

- ``incident.json``: reason, step, trigger measurements, wall time, each
  section's outcome and the capture's own seconds;
- ``threads.txt``: the stack of every live Python thread, by name;
- ``memory.json``: the device's memory gauges (on a CUDA device
  ``torch.cuda.memory_stats()`` with the allocated, reserved and peak
  bytes);
- ``last_metrics.json``: the tail of ``metrics.jsonl``;
- ``profile/``: a short ``torch.profiler`` window around a probe launch.
  It holds ``ops.cuda_lib.launch_lock`` so it never overlaps a CUDA graph
  capture on another thread, and it reads no device record back (the
  profiler may drop some). It is skipped while the trainer's own profiling
  window (``train.profile_dir``) is open (``profiling_active``): two
  profilers cannot run at once.

Capture is bounded (``max_incidents`` per run) and best-effort: each
section is guarded, because an observability crash must not turn a slow
step into a dead run. ``TRLX_TPU_FAULTS=slow_step@N`` drills it.
"""

import json
import os
import sys
import threading
import time
import traceback
from collections import deque

import torch

__all__ = ["AnomalyDetector", "IncidentCapture", "register_emergency", "emergency_capture", "dump_all_threads",
           "device_memory_gauges"]


class AnomalyDetector:
    """Rolling-median step-time breach detector: ``observe(seconds)`` is
    True when the observation exceeds ``factor × p50`` of the trailing
    window, after ``min_samples`` observations. A breaching observation is
    not added to the window."""

    def __init__(self, factor: float, window: int = 64, min_samples: int = 5):
        self.factor = float(factor)
        self.min_samples = max(2, int(min_samples))
        self._times = deque(maxlen=max(self.min_samples, int(window)))

    def p50(self):
        if not self._times:
            return None
        ordered = sorted(self._times)
        return ordered[len(ordered) // 2]

    def observe(self, seconds: float) -> bool:
        seconds = float(seconds)
        if self.factor <= 0:
            return False
        if len(self._times) >= self.min_samples:
            p50 = self.p50()
            if p50 is not None and seconds > self.factor * p50:
                return True
        self._times.append(seconds)
        return False


def dump_all_threads() -> str:
    """The stack of every live Python thread, with the thread names."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for ident, frame in sorted(sys._current_frames().items()):
        lines.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        lines.extend(line.rstrip("\n") for line in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)


def device_memory_gauges(device=None) -> dict:
    """Memory gauges of ``device``: on a CUDA device its name, the
    allocated, reserved and peak bytes and ``torch.cuda.memory_stats()``;
    on another device only its name."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return {"device": str(device)}
    return {
        "device": str(device),
        "name": torch.cuda.get_device_name(device),
        "total_bytes": int(torch.cuda.get_device_properties(device).total_memory),
        "allocated_bytes": int(torch.cuda.memory_allocated(device)),
        "reserved_bytes": int(torch.cuda.memory_reserved(device)),
        "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(device)),
        "peak_reserved_bytes": int(torch.cuda.max_memory_reserved(device)),
        "memory_stats": {k: int(v) for k, v in torch.cuda.memory_stats(device).items()},
    }


class IncidentCapture:
    """Writes bounded, best-effort incident bundles for one run.
    ``bundles`` keeps one record per bundle written (step, reason,
    directory, capture seconds)."""

    def __init__(self, checkpoint_dir: str, device=None, metrics_path=None, max_incidents: int = 4,
                 last_n_metrics: int = 50, profiling_active=None):
        self.directory = os.path.join(os.path.abspath(checkpoint_dir), "incidents")
        self.device = torch.device(device if device is not None else "cpu")
        self.metrics_path = metrics_path
        self.max_incidents = int(max_incidents)
        self.last_n_metrics = int(last_n_metrics)
        self.profiling_active = profiling_active
        self.captured = 0
        self.bundles = []
        self._taken = set()
        self._lock = threading.Lock()

    def capture(self, step: int, reason: str, detail=None) -> str:
        """Capture one bundle; returns its directory ('' when over budget).
        Concurrent triggers serialize on the lock and spend the budget once
        each."""
        with self._lock:
            if self.captured >= self.max_incidents:
                return ""
            self.captured += 1
            # A second bundle at the same step lands beside the first
            # (<step>.1, ...) instead of overwriting it.
            bundle = os.path.join(self.directory, str(int(step)))
            k = 0
            while bundle in self._taken or os.path.exists(os.path.join(bundle, "incident.json")):
                k += 1
                bundle = os.path.join(self.directory, f"{int(step)}.{k}")
            self._taken.add(bundle)
        os.makedirs(bundle, exist_ok=True)
        t0 = time.time()
        sections = {}

        def guard(name, fn):
            try:
                fn()
                sections[name] = "ok"
            except Exception as e:  # noqa: BLE001 — best-effort by design
                sections[name] = f"{type(e).__name__}: {e}"[:300]

        def write_threads():
            with open(os.path.join(bundle, "threads.txt"), "w") as f:
                f.write(dump_all_threads())

        def write_memory():
            with open(os.path.join(bundle, "memory.json"), "w") as f:
                json.dump({"gauges": device_memory_gauges(self.device)}, f, indent=1)

        def write_metrics_tail():
            if not self.metrics_path or not os.path.exists(self.metrics_path):
                return
            import warnings

            from trlx_tpu_torch.utils.jsonl import read_jsonl

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # a torn tail is fine here
                records = read_jsonl(self.metrics_path)
            with open(os.path.join(bundle, "last_metrics.json"), "w") as f:
                json.dump(records[-self.last_n_metrics:], f, indent=1)

        def write_profile():
            from torch.profiler import ProfilerActivity, profile

            from trlx_tpu_torch.ops import cuda_lib

            on_card = self.device.type == "cuda"
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            with cuda_lib.launch_lock:  # no graph capture on another thread meanwhile
                with profile(activities=activities) as prof:
                    probe = torch.zeros(8, device=self.device) + 1
                    if on_card:
                        torch.cuda.synchronize(self.device)
                    del probe
            os.makedirs(os.path.join(bundle, "profile"), exist_ok=True)
            prof.export_chrome_trace(os.path.join(bundle, "profile", "trace.json"))

        guard("threads", write_threads)
        guard("memory", write_memory)
        guard("metrics_tail", write_metrics_tail)
        if self.profiling_active is not None and self.profiling_active():
            sections["profile"] = "skipped: the trainer's profiling window is open"
        else:
            guard("profile", write_profile)

        seconds = time.time() - t0
        manifest = {"step": int(step), "reason": reason, "detail": detail, "time": t0,
                    "capture_seconds": round(seconds, 3), "sections": sections}
        try:
            with open(os.path.join(bundle, "incident.json"), "w") as f:
                json.dump(manifest, f, indent=1)
        except OSError:
            return ""
        self.bundles.append({"step": int(step), "reason": reason, "dir": bundle, "capture_s": seconds})

        from trlx_tpu_torch.observability import spans

        spans.instant("incident", step=int(step), reason=reason)
        print(f"[trlx_tpu_torch.observability] incident captured at step {step} ({reason}) -> {bundle}",
              file=sys.stderr, flush=True)
        return bundle


# Emergency hook: the health monitor's CRIT escalation runs on whichever
# thread scored the chunk, with no trainer in scope, so the trainer
# registers its IncidentCapture here.
_EMERGENCY = {"capture": None, "step_provider": None}


def register_emergency(capture, step_provider=None):
    _EMERGENCY["capture"] = capture
    _EMERGENCY["step_provider"] = step_provider


def emergency_capture(reason: str, detail=None):
    """Best-effort capture from a context with no trainer reference; a
    no-op when nothing is registered."""
    capture = _EMERGENCY["capture"]
    if capture is None:
        return
    step = 0
    provider = _EMERGENCY["step_provider"]
    if provider is not None:
        try:
            step = int(provider())
        except Exception:  # noqa: BLE001
            step = 0
    try:
        capture.capture(step, reason, detail=detail)
    except Exception:  # noqa: BLE001 — the caller must go on
        pass
