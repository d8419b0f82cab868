"""graftfleet: cross-rank trace federation, collective straggler attribution
and the fleet's health block (the counterpart of
``trlx_tpu.observability.fleet``).

A JAX host is a port rank here: "host k" in the files and keys below is
rank k. Armed by ``train.graftfleet`` (``TRLX_TPU_GRAFTFLEET`` wins), off by
default; a disarmed hook costs one dict load.

- **Span federation.** Each rank writes ``spans.host<k>.jsonl``
  (``spans.host_spans_filename``). ``clock_sync`` estimates each rank's
  wall-clock offset around a guarded all-gather (the collective is the
  shared instant; each rank brackets it with its own clock) at start and
  every ``train.fleet_resync_interval`` steps, and rank 0 appends the
  estimate and a drift bound to ``fleet_clock.jsonl``;
  ``spans.read_fleet_spans`` merges the files with that alignment.
- **Collective straggler attribution.** ``collective_guard``
  (``resilience/distributed.py``) records this rank's entry and exit wall
  time of every guarded collective into ``fleet_collectives.host<k>.jsonl``,
  with no extra collective: the join across ranks happens at read time over
  the shared checkpoint directory. Occurrences align by (site, seq): ranks
  run their guarded collectives in one program order, so the i-th at a site
  on one rank is the i-th on every other. At log boundaries rank 0 folds the
  new occurrences into ``fleet/collective_skew_ms_{p50,p95,max}``, per-site
  skew histograms on ``/metrics`` and ``FleetStragglerDetector``, whose
  hysteresis tells a persistent straggler from a one-off hiccup.
- **Health.** ``health_block()`` is ``/healthz``'s ``fleet`` block: each
  rank's heartbeat age, the desync check's status, the straggler verdict,
  the clock estimate.
- **Incident forensics.** ``incident_bundle`` copies every reachable rank's
  span tail and heartbeat record (and this rank's last fingerprint) into
  ``incidents/<step>/host<k>/`` with a ``fleet_incident.json`` manifest,
  when a ``CollectiveTimeout`` aborts the run: the wedged peer cannot dump,
  so the aborting rank collects every rank's files.

The report renders these files as its fleet section
(``observability/report.py`` ``_fleet_section``). Imports are stdlib and
numpy (the mesh's host collectives load inside ``clock_sync``), so tooling
can read the files offline.
"""

import json
import os
import re
import time
import warnings

import numpy as np

from trlx_tpu_torch.observability import spans as obs_spans
from trlx_tpu_torch.observability.health import HysteresisDetector
from trlx_tpu_torch.utils import jsonl, sanitize

__all__ = ["configure", "shutdown", "armed", "fleet", "collective_complete", "incident_bundle",
           "read_collective_arrivals", "collective_skew_table", "FleetMonitor", "FleetStragglerDetector",
           "host_collectives_filename", "SKEW_MS_BUCKETS"]

# The per-site skew histograms' edges: sub-ms alignment noise up to a rank
# that slept for seconds.
SKEW_MS_BUCKETS = (1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000)

# An occurrence below this skew counts as balanced: with 2 ranks one is
# always last, and attributing noise would show a straggler in every run.
DEFAULT_MIN_SKEW_MS = 10.0

# Incident bundles are a crash-path artifact: capped, so a flapping guard
# cannot fill the disk.
MAX_FLEET_BUNDLES = 4

_SPAN_TAIL_BYTES = 65536

_HOST_COLLECTIVES_RE = re.compile(r"^fleet_collectives\.host(\d+)\.jsonl$")


def host_collectives_filename(process_index: int) -> str:
    return f"fleet_collectives.host{int(process_index)}.jsonl"


# --------------------------------------------------------------- file readers


def read_collective_arrivals(checkpoint_dir: str) -> dict:
    """Every rank's guarded-collective arrival records,
    ``{(site, seq): {rank: (t0, t1)}}``; torn tails tolerated per file."""
    out = {}
    try:
        names = sorted(os.listdir(checkpoint_dir))
    except OSError:
        return out
    for name in names:
        m = _HOST_COLLECTIVES_RE.match(name)
        if not m:
            continue
        host = int(m.group(1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                records = jsonl.read_jsonl(os.path.join(checkpoint_dir, name))
            except (OSError, ValueError):
                continue
        for rec in records:
            try:
                out.setdefault((str(rec["site"]), int(rec["seq"])), {})[host] = (float(rec["t0"]), float(rec["t1"]))
            except (KeyError, TypeError, ValueError):
                continue
    return out


def _aligned_skew(by_host: dict, offsets) -> tuple:
    """One occurrence's (skew in s, last rank): the spread of the ranks'
    clock-aligned entry times."""
    aligned = {host: t0 - (offsets[host] if host < len(offsets) else 0.0) for host, (t0, _t1) in by_host.items()}
    worst = max(aligned, key=aligned.get)
    return aligned[worst] - min(aligned.values()), worst


def collective_skew_table(checkpoint_dir: str, offsets=None, min_skew_ms: float = DEFAULT_MIN_SKEW_MS) -> list:
    """Per collective site over every recorded occurrence: count, p50 / p95
    / max skew in ms, and the rank that arrived last most often (counting
    occurrences above the noise floor) with its share."""
    if offsets is None:
        clock = obs_spans._last_clock_record(checkpoint_dir)
        offsets = list(clock.get("offsets_s", [])) if clock else []
    sites = {}
    for (site, _seq), by_host in read_collective_arrivals(checkpoint_dir).items():
        if len(by_host) < 2:
            continue
        skew, worst = _aligned_skew(by_host, offsets)
        entry = sites.setdefault(site, {"skews": [], "worst": {}})
        entry["skews"].append(skew)
        if skew * 1e3 >= min_skew_ms:
            entry["worst"][worst] = entry["worst"].get(worst, 0) + 1
    rows = []
    for site in sorted(sites):
        skews = np.asarray(sites[site]["skews"], dtype=np.float64) * 1e3
        worst = sites[site]["worst"]
        worst_host = max(worst, key=worst.get) if worst else None
        rows.append({"site": site, "count": int(skews.size), "p50_ms": float(np.percentile(skews, 50)),
                     "p95_ms": float(np.percentile(skews, 95)), "max_ms": float(skews.max()),
                     "worst_host": worst_host, "worst_share": (worst[worst_host] / skews.size) if worst else 0.0})
    return rows


# ------------------------------------------------------------------ detector


class FleetStragglerDetector(HysteresisDetector):
    """Hysteresis on a rank whose arrival STAYS last. One observation a log
    window, ``{"host": k or None, "share": frac, "samples": n}``: which rank
    arrived last most often, over what share of the window's occurrences
    above the floor. A window whose last rank differs from the candidate
    resets the judgment (a hiccup moves between ranks; a straggler keeps the
    crown), so only the same rank, window after window, escalates."""

    name = "fleet_straggler"

    def __init__(self, warn_share: float = 0.5, crit_share: float = 0.9, min_samples: int = 2, **kw):
        super().__init__(**kw)
        self.warn_share = float(warn_share)
        self.crit_share = float(crit_share)
        self.min_samples = max(1, int(min_samples))
        self.host = None  # the current last-arrival candidate
        self.share = 0.0

    def severity(self, obs) -> int:
        host = obs.get("host")
        self.share = float(obs.get("share", 0.0))
        if host is None or int(obs.get("samples", 0)) < self.min_samples:
            return 0
        if host != self.host:
            self.host = host  # a new candidate: its persistence starts now
            return 0
        if self.share >= self.crit_share:
            return 2
        if self.share >= self.warn_share:
            return 1
        return 0


# ------------------------------------------------------------------- monitor


class FleetMonitor:
    """This rank's half of the federation: records its collective arrivals
    and clock samples, and (on rank 0) joins every rank's files into the
    skew gauges and the ``/healthz`` block at log boundaries."""

    def __init__(self, checkpoint_dir: str, process_index: int = 0, process_count: int = 1,
                 resync_interval: int = 0, min_skew_ms: float = DEFAULT_MIN_SKEW_MS):
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))
        self.resync_interval = max(0, int(resync_interval))
        self.min_skew_ms = float(min_skew_ms)
        # Shared by the guard's threads (the producer's and score worker's
        # collectives are guarded too) and the main thread's rollup.
        self._lock = sanitize.make_lock("FleetMonitor._lock")
        self._seq = {}  # site -> the next occurrence index on THIS rank
        self._file = jsonl.open_line_atomic(os.path.join(self.checkpoint_dir, host_collectives_filename(process_index)))
        self.clock = {"offsets_s": [0.0] * self.process_count, "uncertainty_s": 0.0, "drift_s": 0.0, "step": 0}
        # Rank 0's window rollup: per-site watermark of complete occurrences,
        # cumulative last-arrival counts, the last skew read.
        self._seen = {}
        self._worst_total = {}
        self.last_skew_ms = 0.0
        self._desync = None  # {"step", "ok"} from the trainer's consistency check
        self._fingerprint = None
        self._bundles = 0
        self.straggler = FleetStragglerDetector()

    # ------------------------------------------------------------ recording

    def collective_complete(self, name: str, t0: float, t1: float):
        """One guarded collective ended on this rank: append its arrival
        record (from ``collective_guard.__exit__``, on the thread that ran
        it; line-atomic, never raises into the caller)."""
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            if self._file is None:
                return
            seq = self._seq.get(name, 0)
            self._seq[name] = seq + 1
            try:
                jsonl.write_record(self._file, {"site": name, "seq": seq, "host": self.process_index, "t0": t0,
                                                "t1": t1})
            except (OSError, ValueError):
                self._file = None  # a full disk or a closed file at teardown: stop quietly

    def note_fingerprint(self, step: int, fingerprint):
        """Keep this rank's latest consistency fingerprint for a bundle."""
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            self._fingerprint = {"step": int(step), "fingerprint": [int(v) for v in np.asarray(fingerprint).ravel()]}

    def note_desync(self, step: int, ok: bool):
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            self._desync = {"step": int(step), "ok": bool(ok)}

    # ------------------------------------------------------------ clock sync

    def clock_sync(self, step: int = 0):
        """Estimate each rank's wall-clock offset around a guarded
        all-gather: round 1 is the shared instant (every rank is inside it
        at some common moment), which each rank brackets with its own clock;
        round 2 gathers the brackets. Rank k's offset is its bracket's
        midpoint less rank 0's; the uncertainty is the widest bracket; the
        drift bound is how far the offsets moved since the last estimate.
        Collective: every rank calls it at the same step."""
        if self.process_count <= 1:
            rows = np.asarray([[time.time(), time.time(), time.monotonic()]])
        else:
            from trlx_tpu_torch.parallel.mesh import allgather_host

            pre = time.time()
            allgather_host(np.zeros((1, 1), dtype=np.float64))
            post = time.time()
            rows = np.asarray(allgather_host(np.asarray([[pre, post, time.monotonic()]], dtype=np.float64)))
            rows = rows.reshape(-1, 3)
        mids = (rows[:, 0] + rows[:, 1]) / 2.0
        offsets = [float(v) for v in (mids - mids[0])]
        uncertainty = float((rows[:, 1] - rows[:, 0]).max())
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            prev = self.clock.get("offsets_s", [])
            drift = (float(np.max(np.abs(np.asarray(offsets) - np.asarray(prev))))
                     if len(prev) == len(offsets) and self.clock.get("step", 0) != 0 else 0.0)
            self.clock = {"offsets_s": offsets, "uncertainty_s": uncertainty, "drift_s": drift, "step": int(step)}
            record = dict(self.clock)
        record["t"] = time.time()
        record["hosts"] = self.process_count
        record["mono_s"] = [float(v) for v in rows[:, 2]]
        if self.process_index == 0:
            try:
                jsonl.append_record(os.path.join(self.checkpoint_dir, obs_spans.FLEET_CLOCK_FILENAME), record)
            except OSError:
                pass  # the estimate still serves this rank's gauges
        return dict(record)

    def maybe_resync(self, step: int):
        """Collective: every rank calls it at the same step; a no-op unless
        ``fleet_resync_interval`` divides ``step``."""
        if self.resync_interval and step and step % self.resync_interval == 0:
            self.clock_sync(step)

    # --------------------------------------------------------- window rollup

    def _window_skews(self):
        """The occurrences completed since the last boundary, by site. One is
        complete when every rank recorded it; a site's watermark stops at the
        first incomplete seq, so a lagging writer's occurrences count next
        window instead of being dropped."""
        arrivals = read_collective_arrivals(self.checkpoint_dir)
        with self._lock:
            sanitize.race_access(self, "fleet_state")
            offsets = list(self.clock.get("offsets_s", []))
            seen = dict(self._seen)
        by_site = {}
        for (site, seq), _ in arrivals.items():
            by_site.setdefault(site, []).append(seq)
        out = {}
        for site, seqs in by_site.items():
            watermark = seen.get(site, -1)
            for seq in range(watermark + 1, max(seqs) + 1):
                by_host = arrivals.get((site, seq))
                if not by_host or len(by_host) < self.process_count:
                    break
                out.setdefault(site, []).append(_aligned_skew(by_host, offsets))
                watermark = seq
            seen[site] = watermark
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            self._seen = seen
        return out

    def on_log_boundary(self, step: int, exporter=None) -> dict:
        """Rank 0's window rollup: the window's new occurrences into the
        ``fleet/*`` gauges, the per-site skew histograms, the straggler
        detector and the exporter's ``/healthz`` block. Returns the gauges
        (empty on other ranks)."""
        if self.process_index != 0:
            return {}
        window = self._window_skews()
        with self._lock:
            sanitize.race_access(self, "fleet_state")
            clock = dict(self.clock)
        gauges = {"fleet/hosts": float(self.process_count),
                  "fleet/clock_uncertainty_ms": float(clock.get("uncertainty_s", 0.0)) * 1e3,
                  "fleet/clock_drift_ms": float(clock.get("drift_s", 0.0)) * 1e3}
        all_skews, worst_counts, samples = [], {}, 0
        for site, pairs in window.items():
            skews_ms = [s * 1e3 for s, _ in pairs]
            all_skews.extend(skews_ms)
            samples += len(pairs)
            for skew, worst in pairs:
                if skew * 1e3 >= self.min_skew_ms:
                    worst_counts[worst] = worst_counts.get(worst, 0) + 1
            if exporter is not None and skews_ms:
                exporter.observe("fleet/collective_skew_ms", skews_ms, SKEW_MS_BUCKETS, labels={"site": site})
        if all_skews:
            arr = np.asarray(all_skews, dtype=np.float64)
            gauges["fleet/collective_skew_ms_p50"] = float(np.percentile(arr, 50))
            gauges["fleet/collective_skew_ms_p95"] = float(np.percentile(arr, 95))
            gauges["fleet/collective_skew_ms_max"] = float(arr.max())
            self.last_skew_ms = float(arr.max())
        worst_host = max(worst_counts, key=worst_counts.get) if worst_counts else None
        share = (worst_counts[worst_host] / samples) if worst_host is not None else 0.0
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            for host, n in worst_counts.items():
                self._worst_total[host] = self._worst_total.get(host, 0) + n
            worst_total = dict(self._worst_total)
        for host, n in sorted(worst_total.items()):
            gauges[f"fleet/host{host}_worst_arrivals_total"] = float(n)
        if worst_host is not None:
            gauges["fleet/slowest_host"] = float(worst_host)
            gauges["fleet/slowest_host_share"] = float(share)
        if samples:
            # Only windows that saw collectives are judged: an idle one says
            # nothing about straggling.
            self.straggler.observe({"host": worst_host, "share": share, "samples": samples})
        gauges["fleet/straggler_state"] = {"ok": 0.0, "warn": 1.0, "crit": 2.0}[self.straggler.state]
        if exporter is not None:
            exporter.update(gauges, step=step)
            exporter.set_fleet(self.health_block())
        return gauges

    # -------------------------------------------------------------- healthz

    def health_block(self, now=None) -> dict:
        """``/healthz``'s ``fleet`` block: each rank's heartbeat age, the
        desync check's status, the straggler verdict, the clock estimate."""
        from trlx_tpu_torch.resilience.distributed import read_heartbeats

        now = time.time() if now is None else now
        beats = read_heartbeats(os.path.join(self.checkpoint_dir, "heartbeats"))
        with self._lock:
            sanitize.race_access(self, "fleet_state")
            clock = dict(self.clock)
            desync = dict(self._desync) if self._desync else {"status": "unchecked"}
        return {
            "hosts": self.process_count,
            "heartbeats": {str(host): {"age_s": round(now - rec.get("written_t", now), 3),
                                       "progress_age_s": round(now - rec.get("progress_t", now), 3),
                                       "step": rec.get("step"), "phase": rec.get("phase")}
                           for host, rec in sorted(beats.items())},
            "desync": desync,
            "straggler": {"state": self.straggler.state, "host": self.straggler.host,
                          "share": round(self.straggler.share, 4)},
            "clock": clock,
        }

    # ------------------------------------------------------------- forensics

    def incident_bundle(self, step, reason: str, detail=None):
        """Every reachable rank's span tail and heartbeat record into
        ``incidents/<step>/host<k>/`` and a ``fleet_incident.json`` manifest
        (reason, detail, collector, ranks, clock). Runs on the guard's timer
        thread just before the process exits: every step is best-effort and
        never blocks the abort."""
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            if self._bundles >= MAX_FLEET_BUNDLES:
                return None
            self._bundles += 1
            fingerprint = dict(self._fingerprint) if self._fingerprint else None
        base = os.path.join(self.checkpoint_dir, "incidents", str(int(step or 0)))
        try:
            from trlx_tpu_torch.resilience.distributed import read_heartbeats

            beats = read_heartbeats(os.path.join(self.checkpoint_dir, "heartbeats"))
        except Exception:  # noqa: BLE001 — forensics must not block the abort
            beats = {}
        span_files = {}
        try:
            for name in sorted(os.listdir(self.checkpoint_dir)):
                m = obs_spans._HOST_SPANS_RE.match(name)
                if m:
                    span_files[int(m.group(1))] = os.path.join(self.checkpoint_dir, name)
        except OSError:
            pass
        written = []
        for host in sorted(set(span_files) | set(beats) | {self.process_index}):
            host_dir = os.path.join(base, f"host{host}")
            try:
                os.makedirs(host_dir, exist_ok=True)
            except OSError:
                continue
            if host in span_files:
                try:
                    with open(os.path.join(host_dir, "spans_tail.jsonl"), "wb") as out:
                        out.write(_tail_whole_lines(span_files[host]))
                except OSError:
                    pass
            try:
                payload = {"heartbeat": beats.get(host), "collected_t": time.time()}
                if host == self.process_index and fingerprint is not None:
                    payload["last_fingerprint"] = fingerprint
                with open(os.path.join(host_dir, "heartbeat.json"), "w") as out:
                    json.dump(payload, out)
            except OSError:
                pass
            written.append(host)
        try:
            os.makedirs(base, exist_ok=True)
            with open(os.path.join(base, "fleet_incident.json"), "w") as out:
                json.dump({"reason": reason, "detail": detail, "step": int(step or 0),
                           "collected_by": self.process_index, "hosts": written, "clock": self.clock,
                           "time": time.time()}, out)
        except OSError:
            pass
        return base

    def close(self):
        with self._lock:
            sanitize.race_access(self, "fleet_state", write=True)
            f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        sanitize.race_forget(self)


def _tail_whole_lines(path: str, max_bytes: int = _SPAN_TAIL_BYTES) -> bytes:
    """The last ``max_bytes`` of a JSONL file, trimmed to whole lines."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size > max_bytes:
            f.seek(size - max_bytes)
            f.readline()  # the partial line the seek landed in
        return f.read()


# ----------------------------------------------------------- module arming
# A module global the trainer arms, so the guard's hooks (which hold no
# trainer) reach it; disarmed, a hook costs one dict load.

_STATE = {"fleet": None}


def configure(checkpoint_dir=None, process_index: int = 0, process_count: int = 1, resync_interval: int = 0):
    """Arm (``checkpoint_dir`` given) or disarm (None) the process's fleet
    monitor. Returns the monitor, or None."""
    old, _STATE["fleet"] = _STATE["fleet"], None
    if old is not None:
        old.close()
    if checkpoint_dir:
        _STATE["fleet"] = FleetMonitor(checkpoint_dir, process_index=process_index, process_count=process_count,
                                       resync_interval=resync_interval)
    return _STATE["fleet"]


def shutdown():
    configure(None)


def armed() -> bool:
    return _STATE["fleet"] is not None


def fleet():
    return _STATE["fleet"]


def collective_complete(name: str, t0: float, t1: float):
    """``collective_guard``'s exit hook."""
    monitor = _STATE["fleet"]
    if monitor is not None:
        monitor.collective_complete(name, t0, t1)


def incident_bundle(step, reason: str, detail=None):
    """The abort path's hook (``collective_guard._fire``)."""
    monitor = _STATE["fleet"]
    if monitor is None:
        return None
    return monitor.incident_bundle(step, reason, detail=detail)
