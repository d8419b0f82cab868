"""graftscope: the device-time attribution ledger and run forensics (the
counterpart of ``trlx_tpu.observability.graftscope``).

- **The attribution ledger.** Every ``DeviceMonitor``-wrapped dispatch
  reports here (``track_dispatch``). On a CUDA device the monitor records a
  CUDA event before and after the dispatch; a drain thread synchronizes the
  end events in order and places each dispatch's device interval on the
  host clock through a reference event whose completion time was read once
  at construction (elapsed times between events are the card's own clock),
  so nothing blocks the dispatching thread and a drain that falls behind
  still places intervals where the card ran them. On the CPU, where the
  work is synchronous, the fence is the host clock: the dispatch's start
  and return. Host lanes (train, producer, score, prefetch) report busy
  intervals through ``host_interval`` / ``lane_span``. ``window()`` folds
  both sets into ``device_busy + host + bubble == wall`` by interval-union
  arithmetic (device time is the union of device intervals clipped to the
  window, host time the union of lane intervals minus the device union, the
  bubble the residual), so the identity holds by construction and
  ``obs/ledger_error_frac`` measures only clipping faults. A fence that
  fails is counted (``obs/graftscope_fences_dropped_total``) and dropped.
- **Pipeline bubbles.** Per-lane idle gaps between busy intervals feed
  ``obs/bubble_fraction`` and per-lane gap histograms.
- **The engine's slot timeline.** ``record_refill`` / ``record_harvest`` /
  ``record_spec_accept`` / ``record_pool`` (from ``engine.rollout_engine``)
  roll into refill-wait quantiles, straggler and accept-rate samples per
  prompt width and the pool row.
- **Run forensics.** ``RunManifest`` is a line-atomic run journal: a killed
  run tears at most its last line, and ``RunManifest.read`` says when and
  during what it died.

Armed by ``train.graftscope`` / ``TRLX_TPU_GRAFTSCOPE``, off by default;
disarmed every hook is one module-dict load. The lock is a plain
``threading`` lock, tracked under ``TRLX_TPU_SANITIZE=race``.
"""

import contextlib
import json
import os
import queue
import threading
import time
import warnings

from trlx_tpu_torch.utils import jsonl, sanitize

__all__ = ["GraftScope", "RunManifest", "configure", "shutdown", "armed", "scope", "host_interval", "lane_span",
           "SNAPSHOT_FILENAME", "LANES", "MANIFEST_FILENAME"]

SNAPSHOT_FILENAME = "graftscope.json"
MANIFEST_FILENAME = "BENCH_MANIFEST.jsonl"
DRAIN_THREAD_NAME = "trlx-graftscope-drain"

#: host lanes of the overlapped pipeline, in ledger order.
LANES = ("train", "producer", "score", "prefetch")

#: histogram bucket edges (exporter ``le`` labels) for ``/metrics``.
REFILL_WAIT_MS_BUCKETS = (1.0, 5.0, 20.0, 50.0, 100.0, 250.0, 1000.0, 5000.0)
LANE_GAP_S_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 5.0)
STRAGGLER_STEPS_BUCKETS = (4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
SPEC_ACCEPT_RATE_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)

# How long window() waits for the drain to place the fences already queued.
DRAIN_WAIT_S = 5.0


def _merge_intervals(intervals):
    """Union of ``(t0, t1)`` intervals → sorted disjoint list."""
    out = []
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _clip(intervals, lo, hi):
    """Clip ``(t0, t1, *tail)`` tuples to ``[lo, hi]``, dropping empties."""
    out = []
    for item in intervals:
        t0, t1 = max(item[0], lo), min(item[1], hi)
        if t1 > t0:
            out.append((t0, t1) + tuple(item[2:]))
    return out


def _subtract(intervals, cover):
    """Total length of ``intervals`` (disjoint) not covered by ``cover``
    (disjoint, sorted): the host-minus-device term of the ledger."""
    total = 0.0
    for a, b in intervals:
        cursor = a
        for c0, c1 in cover:
            if c1 <= cursor:
                continue
            if c0 >= b:
                break
            if c0 > cursor:
                total += c0 - cursor
            cursor = max(cursor, c1)
            if cursor >= b:
                break
        if cursor < b:
            total += b - cursor
    return total


def _pct(values, q):
    """Percentile with linear interpolation (stdlib only)."""
    vals = sorted(values)
    if not vals:
        return 0.0
    pos = (len(vals) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


class _EventClock:
    """Host times of CUDA events: a reference event recorded and waited for
    once gives (event, host time); another event's host time is the
    reference's plus the card's elapsed time between the two."""

    def __init__(self):
        import torch

        torch.cuda.synchronize()
        self.ref = torch.cuda.Event(enable_timing=True)
        self.ref.record()
        self.ref.synchronize()
        self.t_ref = time.time()

    def host_time(self, event) -> float:
        return self.t_ref + self.ref.elapsed_time(event) / 1000.0


class GraftScope:
    """Per-process attribution ledger: device intervals, host lane
    intervals and engine slot rollups, folded per phase window."""

    def __init__(self, snapshot_path=None, top_k=8, max_windows=64):
        self.snapshot_path = snapshot_path
        self.top_k = int(top_k)
        self.max_windows = int(max_windows)
        self._lock = sanitize.make_lock("GraftScope._lock")
        self._device = []  # (t0, t1, name) placed device intervals
        self._host = []  # (t0, t1, lane)
        self._refill_wait_ms = []
        self._straggler = {}  # width -> [steps, ...] this window
        self._spec_accept = {}  # width -> [accept rates, ...] this window
        self._pool_used = []  # paged pool used-block fractions this window
        self._pool_last = None  # latest paged pool occupancy
        self._slot_rows = {}  # slot -> {"busy_s", "episodes", "last_width"}
        self._fences_dropped = 0
        self._queued = 0  # fences handed to the drain
        self._placed = 0  # fences the drain finished (placed or dropped)
        self._pending = queue.SimpleQueue()
        self._drain = None
        self._clock = None
        self._win_t0 = time.time()
        self._windows = []
        self._programs_s = {}
        self._lane_busy_s = {lane: 0.0 for lane in LANES}
        self._lane_gap_s = {lane: 0.0 for lane in LANES}
        self._totals = {"wall_s": 0.0, "device_busy_s": 0.0, "host_s": 0.0, "bubble_s": 0.0}
        self._refill_wait_total_ms = 0.0
        self._last_samples = None
        self._snapshot_failed = False

    # ------------------------------------------------------------ ingestion

    def track_dispatch(self, name, phase, t0, events=None):
        """Called by ``DeviceMonitor`` right after a wrapped dispatch
        returns. ``events`` (start, end CUDA events) go to the drain thread;
        without them (the CPU) the interval is the dispatch's host span."""
        if events is None:
            t1 = time.time()
            with self._lock:
                sanitize.race_access(self, "_device", write=True)
                self._device.append((t0, t1, name))
            return
        with self._lock:
            if self._drain is None:
                if self._clock is None:
                    self._clock = _EventClock()
                t = threading.Thread(target=self._drain_loop, name=DRAIN_THREAD_NAME, daemon=True)
                self._drain = t
                t.start()
            self._queued += 1
        self._pending.put((name, events))

    def _drain_loop(self):
        while True:
            item = self._pending.get()
            if item is None:
                return
            name, (start, end) = item
            try:
                end.synchronize()
                t0, t1 = self._clock.host_time(start), self._clock.host_time(end)
            except Exception:  # noqa: BLE001 — drop the sample, never the run
                with self._lock:
                    sanitize.race_access(self, "_fences_dropped", write=True)
                    self._fences_dropped += 1
                    self._placed += 1
                continue
            with self._lock:
                sanitize.race_access(self, "_device", write=True)
                self._device.append((t0, t1, name))
                self._placed += 1

    def _wait_drained(self, timeout: float = DRAIN_WAIT_S):
        """Wait (bounded) until the fences queued so far are placed, so a
        window holds the device time of its own dispatches."""
        deadline = time.time() + timeout
        with self._lock:
            target = self._queued
        while time.time() < deadline:
            with self._lock:
                if self._placed >= target or self._drain is None:
                    return
            time.sleep(0.001)

    def host_interval(self, lane, t0, t1):
        if t1 > t0:
            with self._lock:
                sanitize.race_access(self, "_host", write=True)
                self._host.append((t0, t1, lane))

    # --------------------------------------------------------- engine slots

    def record_refill(self, slot, width, wait_s):
        """A slot was (re)admitted; ``wait_s`` is how long it sat free (None
        for its first admission)."""
        with self._lock:
            row = self._slot_rows.setdefault(int(slot), {"busy_s": 0.0, "episodes": 0, "last_width": 0})
            row["last_width"] = int(width)
            if wait_s is not None:
                self._refill_wait_ms.append(max(0.0, wait_s) * 1e3)

    def record_harvest(self, slot, width, steps, busy_s):
        """A slot finished an episode after ``steps`` decode steps over
        ``busy_s`` of wall clock: the occupancy row and the straggler sample
        (keyed by prompt width)."""
        with self._lock:
            row = self._slot_rows.setdefault(int(slot), {"busy_s": 0.0, "episodes": 0, "last_width": 0})
            row["busy_s"] += max(0.0, busy_s)
            row["episodes"] += 1
            row["last_width"] = int(width)
            self._straggler.setdefault(int(width), []).append(int(steps))

    def record_spec_accept(self, slot, width, rate):
        """A spec-decode slot finished an episode with ``rate`` of its window
        positions accepted."""
        with self._lock:
            self._spec_accept.setdefault(int(width), []).append(max(0.0, min(1.0, float(rate))))

    def record_pool(self, used, cached, free, total, frag, hits_total, saved_total):
        """Paged pool occupancy at an engine sync boundary (host bookkeeping
        only): blocks used by live slots, warm prefix blocks, free ones, the
        total (trash block included), the fragmentation and the lifetime
        prefix counters. A window's last sample is its pool row."""
        with self._lock:
            denom = max(1, int(total) - 1)  # the trash block is never allocatable
            self._pool_used.append(min(1.0, int(used) / denom))
            self._pool_last = {
                "used_blocks": int(used), "cached_blocks": int(cached), "free_blocks": int(free),
                "total_blocks": int(total), "frag_frac": float(frag), "prefix_hits_total": int(hits_total),
                "prefill_tokens_saved_total": int(saved_total),
            }

    # -------------------------------------------------------------- windows

    def window(self):
        """Close the current window: drain both interval sets, compute the
        conservation ledger, and return the gauges (the raw histogram
        samples go to ``drain_samples``)."""
        self._wait_drained()
        t1w = time.time()
        with self._lock:
            t0w = self._win_t0
            self._win_t0 = t1w
            sanitize.race_access(self, "_device", write=True)
            sanitize.race_access(self, "_host", write=True)
            sanitize.race_access(self, "_fences_dropped")
            device, self._device = self._device, []
            host, self._host = self._host, []
            refill, self._refill_wait_ms = self._refill_wait_ms, []
            straggler, self._straggler = self._straggler, {}
            spec_accept, self._spec_accept = self._spec_accept, {}
            pool_used, self._pool_used = self._pool_used, []
            pool_last = self._pool_last
            fences_dropped = self._fences_dropped
        wall = max(t1w - t0w, 1e-9)

        # Intervals past the window's end (a fence placed later than the
        # window closed) belong to the next window: keep them.
        later = [iv for iv in device if iv[1] > t1w]
        device = _clip(device, t0w, t1w)
        host = _clip(host, t0w, t1w)
        dev_union = _merge_intervals([(a, b) for a, b, _ in device])
        dev_s = float(sum(b - a for a, b in dev_union))
        host_union = _merge_intervals([(a, b) for a, b, _ in host])
        host_s = _subtract(host_union, dev_union)
        bubble_s = max(0.0, wall - dev_s - host_s)
        err = abs(dev_s + host_s + bubble_s - wall) / wall

        programs = {}
        for a, b, name in device:
            programs[name] = programs.get(name, 0.0) + (b - a)
        lane_busy = {lane: 0.0 for lane in LANES}
        lane_ivs = {lane: [] for lane in LANES}
        for a, b, lane in host:
            if lane in lane_busy:
                lane_busy[lane] += b - a
                lane_ivs[lane].append((a, b))
        lane_gaps = {}
        for lane, ivs in lane_ivs.items():
            if not ivs:
                continue
            merged = _merge_intervals(ivs)
            gaps = [merged[0][0] - t0w] if merged[0][0] > t0w else []
            gaps += [n0 - p1 for (_, p1), (n0, _) in zip(merged, merged[1:])]
            if t1w > merged[-1][1]:
                gaps.append(t1w - merged[-1][1])
            lane_gaps[lane] = [g for g in gaps if g > 0.0]

        gauges = {
            "obs/ledger_device_busy_s": dev_s,
            "obs/ledger_host_s": host_s,
            "obs/ledger_bubble_s": bubble_s,
            "obs/ledger_wall_s": wall,
            "obs/ledger_error_frac": err,
            "obs/bubble_fraction": bubble_s / wall,
            "obs/graftscope_fences_dropped_total": float(fences_dropped),
        }
        for lane in LANES:
            gauges["obs/lane_busy_" + lane + "_s"] = lane_busy[lane]
        if refill:
            gauges["engine/refill_wait_ms_p50"] = _pct(refill, 0.50)
            gauges["engine/refill_wait_ms_p95"] = _pct(refill, 0.95)
            gauges["engine/refill_wait_ms_max"] = max(refill)
        if pool_used:
            gauges["engine/pool_used_frac_p50"] = _pct(pool_used, 0.50)
            gauges["engine/pool_used_frac_max"] = max(pool_used)

        top = sorted(programs.items(), key=lambda kv: -kv[1])[: self.top_k]
        record = {
            "t0": t0w, "t1": t1w, "wall_s": wall, "device_busy_s": dev_s, "host_s": host_s, "bubble_s": bubble_s,
            "bubble_fraction": bubble_s / wall, "error_frac": err, "lane_busy_s": lane_busy,
            "top_programs": [[name, round(sec, 6)] for name, sec in top],
        }
        if pool_last is not None:
            record["pool"] = dict(pool_last)
        with self._lock:
            self._device = [(max(a, t1w), b, n) for a, b, n in later] + self._device
            self._windows.append(record)
            del self._windows[: -self.max_windows]
            for name, sec in programs.items():
                self._programs_s[name] = self._programs_s.get(name, 0.0) + sec
            for lane in LANES:
                self._lane_busy_s[lane] += lane_busy[lane]
                self._lane_gap_s[lane] += sum(lane_gaps.get(lane, []))
            self._totals["wall_s"] += wall
            self._totals["device_busy_s"] += dev_s
            self._totals["host_s"] += host_s
            self._totals["bubble_s"] += bubble_s
            self._refill_wait_total_ms += sum(refill)
            self._last_samples = {"lane_gaps": lane_gaps, "refill_wait_ms": refill, "straggler_steps": straggler,
                                  "spec_accept": spec_accept, "pool_used_frac": pool_used}
        return gauges

    def drain_samples(self):
        """The last closed window's raw samples, consumed once."""
        with self._lock:
            samples, self._last_samples = self._last_samples, None
        return samples

    # ---------------------------------------------------------- persistence

    def snapshot(self):
        with self._lock:
            slots = [{"slot": slot, **row} for slot, row in sorted(self._slot_rows.items())]
            top = sorted(self._programs_s.items(), key=lambda kv: -kv[1])
            return {
                "totals": dict(self._totals),
                "bubble_fraction": self._totals["bubble_s"] / self._totals["wall_s"] if self._totals["wall_s"] else 0.0,
                "programs_s": {k: round(v, 6) for k, v in top[: self.top_k]},
                "lane_busy_s": {k: round(v, 6) for k, v in self._lane_busy_s.items()},
                "lane_gap_s": {k: round(v, 6) for k, v in self._lane_gap_s.items()},
                "slots": slots,
                "pool": dict(self._pool_last) if self._pool_last else None,
                "refill_wait_total_ms": round(self._refill_wait_total_ms, 3),
                "fences_dropped": self._fences_dropped,
                "windows": list(self._windows),
            }

    def flush(self):
        """Write the snapshot atomically; an I/O failure warns once and stops
        persisting, never the run."""
        if not self.snapshot_path or self._snapshot_failed:
            return
        try:
            tmp = self.snapshot_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f, indent=1)
            os.replace(tmp, self.snapshot_path)
        except OSError:
            self._snapshot_failed = True
            warnings.warn(f"graftscope: writing {self.snapshot_path} failed — the run continues without ledger "
                          "snapshots", stacklevel=2)

    def close(self):
        """Stop the drain thread (after what is queued) and write the final
        snapshot."""
        with self._lock:
            drain, self._drain = self._drain, None
        if drain is not None:
            self._pending.put(None)
            drain.join(timeout=30.0)
            if not drain.is_alive():
                # Joined: the drain's fields pass to this thread.
                sanitize.race_forget(self)
        self.flush()


# The process-global scope, armed by the trainer: the reporting sites (the
# pipeline's threads, the engine, the monitor) hold no trainer reference.
_STATE = {"scope": None}


def configure(snapshot_path=None):
    """Arm the process-global scope (closing an earlier one). Pass the
    ``graftscope.json`` path on the main process, None elsewhere."""
    old, _STATE["scope"] = _STATE["scope"], None
    if old is not None:
        old.close()
    _STATE["scope"] = GraftScope(snapshot_path=snapshot_path)
    return _STATE["scope"]


def shutdown():
    old, _STATE["scope"] = _STATE["scope"], None
    if old is not None:
        old.close()


def armed() -> bool:
    return _STATE["scope"] is not None


def scope():
    return _STATE["scope"]


def host_interval(lane, t0, t1):
    """A host-busy interval on ``lane``; one dict load when disarmed."""
    s = _STATE["scope"]
    if s is not None:
        s.host_interval(lane, t0, t1)


@contextlib.contextmanager
def lane_span(lane):
    """``with lane_span("score"):`` over ``host_interval``."""
    s = _STATE["scope"]
    if s is None:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        s.host_interval(lane, t0, time.time())


# ---------------------------------------------------------------- forensics


class RunManifest:
    """A line-atomic run journal (``utils.jsonl``): a run killed at any
    instant leaves a parseable journal that says when and during what it
    died. Records (``event``): ``begin``, ``heartbeat``, ``child`` (a
    subprocess's rc and stderr tail), ``partial``, ``end``."""

    STDERR_TAIL_CHARS = 2000

    def __init__(self, path, cmd=None, **meta):
        self.path = path
        self._finished = False
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self._append({"event": "begin", "pid": os.getpid(), "cmd": cmd, **meta})

    def _append(self, record):
        record.setdefault("t", time.time())
        try:
            jsonl.append_record(self.path, record)
        except OSError:
            pass  # forensics never take the run down

    def heartbeat(self, phase, **fields):
        self._append({"event": "heartbeat", "phase": phase, **fields})

    def child(self, label, rc, stderr_tail=""):
        self._append({"event": "child", "label": label, "rc": rc,
                      "stderr_tail": (stderr_tail or "")[-self.STDERR_TAIL_CHARS:]})

    def partial(self, metrics):
        self._append({"event": "partial", "metrics": metrics})

    def finish(self, rc, reason=None, **fields):
        # Idempotent: the first verdict stands.
        if self._finished:
            return
        self._finished = True
        self._append({"event": "end", "rc": rc, "reason": reason, **fields})

    @staticmethod
    def read(path):
        """Fold a manifest (possibly torn, possibly without an end) into
        ``{"valid", "complete", "rc", "reason", "last_heartbeat", "partial",
        "children", "events"}``."""
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # a torn tail is what this reads through
                records = jsonl.read_jsonl(path)
        except (OSError, ValueError):
            records = []
        begin = next((r for r in records if r.get("event") == "begin"), None)
        if begin is None:
            return {"valid": False, "complete": False, "rc": None, "reason": "unreadable manifest",
                    "events": len(records)}
        end = next((r for r in reversed(records) if r.get("event") == "end"), None)
        heartbeats = [r for r in records if r.get("event") == "heartbeat"]
        children = [r for r in records if r.get("event") == "child"]
        partial = next((r.get("metrics") for r in reversed(records) if r.get("event") == "partial"), None)
        if end is not None:
            reason = end.get("reason") or f"completed rc={end.get('rc')}"
            rc = end.get("rc")
        else:
            rc = None
            if heartbeats:
                last = heartbeats[-1]
                cand = last.get("candidate")
                reason = f"run killed mid-flight during {last.get('phase', '?')}" + (
                    f" (candidate {cand})" if cand else "")
            else:
                reason = "run killed before first heartbeat"
            failed = [c for c in children if c.get("rc") not in (0, None)]
            if failed:
                tail = (failed[-1].get("stderr_tail") or "").strip().splitlines()
                last_line = tail[-1][:160] if tail else ""
                reason += (f"; last child failure {failed[-1].get('label')} rc={failed[-1].get('rc')}"
                           + (f": {last_line}" if last_line else ""))
        return {
            "valid": True, "complete": end is not None, "rc": rc, "reason": reason,
            "last_heartbeat": heartbeats[-1] if heartbeats else None, "partial": partial,
            "children": [{"label": c.get("label"), "rc": c.get("rc")} for c in children], "events": len(records),
        }
