"""Device telemetry: FLOPs counted at the first dispatch, MFU per window,
kernel-routing and device-memory gauges (the counterpart of
``trlx_tpu.observability.devicemon``).

The JAX package asks XLA for each jitted program's ``cost_analysis()``. The
port has no compiled program to ask, so a ``DeviceMonitor`` proxy counts
the work while the FIRST dispatch of each (program, input signature) runs,
and charges every later dispatch of that signature the same:

- ``FlopCount``, a ``TorchDispatchMode``, counts the aten ops' FLOPs by
  ``torch.utils.flop_counter``'s table and their bytes (each non-view op's
  tensor inputs read once and outputs written once);
- the hand-kernel wrappers add their own FLOPs and bytes from the shapes
  they check (``add_kernel_cost``; a ``ctypes`` launch is invisible to the
  dispatcher), reckoned as PERF.md's bounds reckon them;
- work issued while the calling stream captures a CUDA graph is counted
  apart (``captured_flops``): a capture launches nothing. The
  ``ops.cuda_graph.StepGraph`` it builds keeps those FLOPs and charges them
  again at each replay inside a counted dispatch, so a first dispatch that
  replays (the sampler's decode loop) counts every step.

A counting error is recorded in the signature's record and the dispatch
runs on; a dispatch's own exception propagates. Nothing routes any kernel
to its plain version.

Per-window gauges (``window``):

    obs/train_mfu_pct = 100 * (train FLOPs dispatched in the window)
                        / train seconds / peak FLOP/s

On a CUDA device the train seconds are the train dispatches' device time,
read from a pair of CUDA events recorded around each monitored dispatch
(``device.stamp`` / ``elapsed_s``, read at the window boundary), and
reported as ``obs/train_device_s``; on the CPU they are the phase timer's.
``obs/iter_mfu_pct`` divides every phase's FLOPs by the window's wall.

``detect_peak_flops`` honours ``TRLX_TPU_PEAK_TFLOPS``; otherwise it looks
the card's ``torch.cuda.get_device_name()`` up in ``PEAK_TFLOPS`` (one
entry: the H100 SXM's 989 TFLOP/s of dense bf16) and gives None for a card
it does not know (no MFU gauge).

The routing gauges read the wrappers' launch counters: ``*_active`` is 1
once a kernel of the family has launched, ``*_fallback`` is 0 by
construction (a wrapper launches its kernel or raises).
"""

import json
import os
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["DeviceMonitor", "FlopCount", "PEAK_TFLOPS", "detect_peak_flops", "add_kernel_cost", "counting",
           "kernel_routing_gauges", "device_memory_gauges", "PROGRAMS_FILENAME"]

PROGRAMS_FILENAME = "programs.json"

# Peak dense bf16 TFLOP/s by device-name prefix (chip_smoke.py's
# PEAK_BF16_FLOPS, the figure PERF.md's bounds use).
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


def detect_peak_flops():
    """Peak FLOP/s of the card, or None when unknown (the CPU, a card not in
    the table). ``TRLX_TPU_PEAK_TFLOPS`` overrides the table."""
    env = os.environ.get("TRLX_TPU_PEAK_TFLOPS")
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            pass
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name()
    for prefix, tflops in PEAK_TFLOPS.items():
        if name.startswith(prefix):
            return tflops * 1e12
    return None


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# FlopCount modes entered and not yet left, in any thread: the kernel
# wrappers reckon their cost only while it is non-zero.
_COUNTING = [0]
_COUNTING_LOCK = threading.Lock()


def counting() -> bool:
    return _COUNTING[0] > 0


class FlopCount(TorchDispatchMode):
    """Counts the FLOPs and bytes of the aten ops dispatched inside it, and
    (``add_kernel_cost``) those the hand-kernel wrappers report. Work under
    a graph capture lands in ``captured_flops`` only. The first counting
    error is kept in ``error``; the op itself always runs."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.captured_flops = 0.0
        self.error = None

    @property
    def total_flops(self) -> float:
        return self.flops + self.kernel_flops

    def __enter__(self):
        with _COUNTING_LOCK:
            _COUNTING[0] += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            with _COUNTING_LOCK:
                _COUNTING[0] -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        try:
            count = flop_registry.get(func._overloadpacket)
            flops = float(count(*args, **kwargs, out_val=out)) if count is not None else 0.0
            if _capturing():
                self.captured_flops += flops
            else:
                self.flops += flops
                if not func.is_view:
                    self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        except Exception as e:  # noqa: BLE001 — counting must not fail the op
            if self.error is None:
                self.error = f"{func}: {type(e).__name__}: {e}"[:300]
        return out


def _active_counts():
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, FlopCount)]


def add_kernel_cost(flops: float, nbytes: float = 0.0):
    """A hand kernel's launch reports its FLOPs and bytes to every counting
    ``FlopCount`` on this thread (the autograd engine carries the modes onto
    its device threads): to ``captured_flops`` while the stream captures a
    graph. Free when nothing counts."""
    modes = _active_counts()
    if not modes:
        return
    capturing = _capturing()
    for m in modes:
        if capturing:
            m.captured_flops += flops
        else:
            m.kernel_flops += flops
            m.kernel_bytes += nbytes


def _leaf_signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype))
    if x is None or isinstance(x, (bool, int, float, str)):
        return (type(x).__name__, x)
    return (type(x).__name__,)


def _signature(args, kwargs) -> tuple:
    """Hashable (shape, dtype) signature of the tensors (and batch
    dataclasses' tensors) among the arguments; scalars by value, other
    objects by type."""
    out = []

    def walk(x):
        if isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif hasattr(x, "__dataclass_fields__") and not isinstance(x, type):
            for k in x.__dataclass_fields__:
                walk(getattr(x, k))
        else:
            out.append(_leaf_signature(x))

    walk((args, kwargs))
    return tuple(out)


class _MonitoredFn:
    """Transparent callable proxy: counts dispatches, counts the work of the
    first dispatch of each input signature, times each dispatch on the
    device with CUDA events, then returns the call's result."""

    def __init__(self, monitor, name, fn):
        self._monitor = monitor
        self._name = name
        self._fn = fn

    def __call__(self, *args, **kwargs):
        mon = self._monitor
        rec, capture = mon._on_dispatch(self._name, args, kwargs)
        t0 = time.time()
        events = None
        if mon.timed:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = mon._capture(self._fn, args, kwargs, rec) if capture else self._fn(*args, **kwargs)
        if events is not None:
            events[1].record()
        mon._after_dispatch(self._name, rec, t0, events)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


class DeviceMonitor:
    """Registry of monitored programs and the per-window FLOP and device-time
    accounting. ``wrap(name, fn, phase=...)`` puts a program in a phase
    ("train", "rollout", "score"); ``window()`` drains the counters."""

    # Signatures counted per program (prompt buckets are one each).
    MAX_SIGNATURES_PER_PROGRAM = 8

    def __init__(self, peak_flops=None, programs_path=None, device=None, census=None):
        self.peak_flops = peak_flops if peak_flops is not None else detect_peak_flops()
        self.census = census  # () -> the tensors the CPU memory gauge counts
        self.programs_path = programs_path
        self.device = torch.device(device if device is not None else "cpu")
        self.timed = self.device.type == "cuda"
        self.programs = {}  # name -> {phase, dispatches, signatures: {sig -> rec}}
        self._lock = threading.Lock()
        self._window_flops = {}  # phase -> FLOPs dispatched since the last window()
        self._window_events = []  # (phase, start, end) of the window's timed dispatches
        self._dirty = False
        # graftscope's ledger, attached by the trainer when armed.
        self.ledger = None

    def wrap(self, name, fn, phase: str = "train"):
        with self._lock:
            self.programs.setdefault(name, {"phase": phase, "dispatches": 0, "signatures": {}})
        return _MonitoredFn(self, name, fn)

    # ------------------------------------------------------------- dispatch

    def _on_dispatch(self, name, args, kwargs):
        prog = self.programs[name]
        sig = _signature(args, kwargs)
        with self._lock:
            prog["dispatches"] += 1
            rec = prog["signatures"].get(sig)
            capture = rec is None and len(prog["signatures"]) < self.MAX_SIGNATURES_PER_PROGRAM
            if capture:
                rec = prog["signatures"][sig] = {"flops": None}
        return rec, capture

    def _capture(self, fn, args, kwargs, rec):
        """Run the first dispatch of a signature under ``FlopCount``."""
        peak0 = torch.cuda.max_memory_allocated(self.device) if self.timed else 0
        mode = FlopCount()
        try:
            with mode:
                return fn(*args, **kwargs)
        finally:
            rec.update(flops=mode.total_flops, aten_flops=mode.flops, kernel_flops=mode.kernel_flops,
                       bytes_accessed=mode.bytes + mode.kernel_bytes)
            if self.timed:
                rec["peak_bytes_delta"] = max(0, torch.cuda.max_memory_allocated(self.device) - peak0)
            if mode.error is not None:
                rec["error"] = mode.error
            self._dirty = True
            self._persist()

    def _after_dispatch(self, name, rec, t0, events):
        prog = self.programs[name]
        with self._lock:
            if rec is not None and rec.get("flops"):
                self._window_flops[prog["phase"]] = self._window_flops.get(prog["phase"], 0.0) + rec["flops"]
            if events is not None:
                self._window_events.append((prog["phase"], events[0], events[1]))
        ledger = self.ledger
        if ledger is not None:
            ledger.track_dispatch(name, prog["phase"], t0, events)

    def _persist(self):
        """Write the registry to ``programs.json`` (atomic overwrite) for the
        report's program table."""
        if not self.programs_path or not self._dirty:
            return
        try:
            from trlx_tpu_torch.resilience.checkpoint import atomic_write_text

            atomic_write_text(self.programs_path, json.dumps(self.snapshot(), indent=1))
            self._dirty = False
        except OSError:
            pass

    # -------------------------------------------------------------- reading

    def snapshot(self) -> dict:
        """Per program: its phase, dispatch count and each counted
        signature's record."""
        with self._lock:
            return {
                name: {
                    "phase": prog["phase"],
                    "dispatches": prog["dispatches"],
                    "variants": [{"signature": [list(map(str, s)) for s in sig], **rec}
                                 for sig, rec in prog["signatures"].items()],
                }
                for name, prog in self.programs.items()
            }

    def window(self, phase_seconds: dict) -> dict:
        """Drain the per-window counters into gauges. ``phase_seconds``: the
        phase timer's seconds (``{"train": ..., "wall": ...}``); on a CUDA
        device the train seconds are the train dispatches' device time."""
        with self._lock:
            flops, self._window_flops = self._window_flops, {}
            events, self._window_events = self._window_events, []
        device_s = {}
        for phase, start, end in events:
            end.synchronize()
            device_s[phase] = device_s.get(phase, 0.0) + start.elapsed_time(end) / 1000.0
        stats = {}
        train_flops = flops.get("train", 0.0)
        total_flops = sum(flops.values())
        train_s = float(phase_seconds.get("train", 0.0) or 0.0)
        if self.timed and device_s.get("train"):
            train_s = device_s["train"]
            stats["obs/train_device_s"] = train_s
        wall_s = float(phase_seconds.get("wall", 0.0) or 0.0)
        if train_flops > 0 and train_s > 0:
            tflops = train_flops / train_s / 1e12
            stats["obs/train_tflops_per_chip"] = tflops
            if self.peak_flops:
                stats["obs/train_mfu_pct"] = 100.0 * tflops * 1e12 / self.peak_flops
        if total_flops > 0 and wall_s > 0:
            tflops = total_flops / wall_s / 1e12
            stats["obs/iter_tflops_per_chip"] = tflops
            if self.peak_flops:
                stats["obs/iter_mfu_pct"] = 100.0 * tflops * 1e12 / self.peak_flops
        self._dirty = bool(self.programs)
        self._persist()
        return stats

    def flush(self):
        """Persist the registry (the run's exit)."""
        self._dirty = bool(self.programs)
        self._persist()

    def kernel_routing_gauges(self) -> dict:
        return kernel_routing_gauges()

    def device_memory_gauges(self) -> dict:
        return device_memory_gauges(self.device, self.census() if self.census is not None else ())


# ------------------------------------------------------------------- gauges


def kernel_routing_gauges() -> dict:
    """The kernel families' routing from their wrappers' launch counters
    (``ops.cuda_graph.launch_counters``): ``*_active`` 1 once a kernel of
    the family launched; ``*_fallback`` 0, as a wrapper has no fallback."""
    from trlx_tpu_torch.ops import decode_attention, flash_attention, fused_logprob, w8a16
    from trlx_tpu_torch.ops.cuda_graph import launch_counters

    families = {"decode_attn": decode_attention, "fused_logprob": fused_logprob, "flash_attn": flash_attention,
                "w8a16": w8a16}
    counters = launch_counters()
    out = {}
    for family, mod in families.items():
        launched = any(c.launches > 0 for c in counters if c.__module__ == mod.__name__)
        out[f"obs/{family}_active"] = 1.0 if launched else 0.0
        out[f"obs/{family}_fallback"] = 0.0
    return out


def device_memory_gauges(device=None, tensors=()) -> dict:
    """Device-memory occupancy in GiB: on a CUDA device the allocator's
    current, peak and reserved bytes; on the CPU the bytes of the distinct
    storages of ``tensors`` (``obs/live_array_gib``: the trainer passes its
    state, the parameters, the optimizer's moments and the frozen extras;
    the JAX package's CPU branch counts ``jax.live_arrays()``, which torch
    has no counterpart of)."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        return {
            "obs/device_mem_gib": torch.cuda.memory_allocated(device) / 2**30,
            "obs/device_mem_peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "obs/device_mem_reserved_gib": torch.cuda.memory_reserved(device) / 2**30,
        }
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return {"obs/live_array_gib": sum(storages.values()) / 2**30}
