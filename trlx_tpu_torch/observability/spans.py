"""Cross-thread span tracing: Chrome-trace-event JSONL with thread lanes
(the counterpart of ``trlx_tpu.observability.spans``, single-process part).

Host code wraps its phases in ``with trace_span(name):`` and each span lands
as one Chrome trace event (``ph:"X"``) in ``<checkpoint_dir>/spans.jsonl``,
``pid`` = the process's rank and ``tid`` = a synthetic per-thread lane, so
Perfetto (https://ui.perfetto.dev) shows one lane per thread: the train
loop, ``trlx-rollout-producer``, ``trlx-score-worker``, ``trlx-prefetch``.
The spans are host spans: they time dispatch and host waits, never device
work, and no site adds a device sync.

- Off by default: ``trace_span`` returns a shared no-op until
  ``configure(path=...)`` arms the module's tracer.
- Crash-tolerant: one unbuffered O_APPEND write per event (``utils.jsonl``),
  so a killed process tears at most the last line, which ``read_spans``
  drops.
- Never kills the run it observes: an I/O error disarms the tracer with one
  warning.

Events: ``ph:"X"`` complete spans (``ts``/``dur`` in microseconds of wall
clock), ``ph:"i"`` instants (guard skip, watchdog rollback, incident), and
``ph:"M"`` ``thread_name`` metadata at a lane's first event.

With graftfleet armed (``observability.fleet``) each rank writes its own
``spans.host<k>.jsonl`` (k its rank; one file a rank survives a torn tail
per rank), and ``read_fleet_spans`` merges them into one trace with a lane
per rank, shifted into rank 0's clock by the last ``fleet_clock.jsonl``
estimate, with its alignment bound stated.
"""

import os
import re
import threading
import time
import warnings

from trlx_tpu_torch.utils import jsonl

__all__ = ["configure", "shutdown", "enabled", "trace_span", "complete", "instant", "read_spans", "SPANS_FILENAME",
           "FLEET_CLOCK_FILENAME", "TID_STRIDE", "host_spans_filename", "read_fleet_spans"]

SPANS_FILENAME = "spans.jsonl"
# graftfleet's clock-offset history (observability/fleet.py appends one
# record an estimate); read_fleet_spans applies the last one.
FLEET_CLOCK_FILENAME = "fleet_clock.jsonl"
# Rank k's lane t becomes k * TID_STRIDE + t in the merged trace, so the
# small per-rank thread counters never collide.
TID_STRIDE = 1000

_HOST_SPANS_RE = re.compile(r"^spans\.host(\d+)\.jsonl$")


def host_spans_filename(process_index: int) -> str:
    """Rank ``process_index``'s spans file under graftfleet:
    ``spans.host<k>.jsonl``."""
    return f"spans.host{int(process_index)}.jsonl"


class _NullSpan:
    """Shared, reentrant no-op context manager: the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        return False


_NULL_SPAN = _NullSpan()


class SpanTracer:
    """Appends Chrome trace events to one JSONL file, line-atomically."""

    def __init__(self, path: str, process_index: int = 0):
        self.path = path
        self.pid = int(process_index)
        self._file = jsonl.open_line_atomic(path)
        # Lane ids per thread OBJECT, kept thread-locally: the OS reuses
        # thread idents, and a reused ident would merge two threads' lanes.
        self._local = threading.local()
        self._next_tid = 0
        self._name_lock = threading.Lock()

    def _emit(self, event: dict):
        try:
            jsonl.write_record(self._file, event)
        except (OSError, ValueError):  # ValueError: a write on a closed file
            _disarm_on_error(self)

    def _tid(self) -> int:
        tid = getattr(self._local, "tid", None)
        if tid is None:
            with self._name_lock:
                self._next_tid += 1
                tid = self._local.tid = self._next_tid
            self._emit({"name": "thread_name", "ph": "M", "pid": self.pid, "tid": tid,
                        "args": {"name": threading.current_thread().name}})
        return tid

    def complete(self, name: str, t0: float, t1: float, args: dict):
        self._emit({"name": name, "ph": "X", "pid": self.pid, "tid": self._tid(), "ts": int(t0 * 1e6),
                    "dur": max(0, int((t1 - t0) * 1e6)), **({"args": args} if args else {})})

    def instant(self, name: str, args: dict):
        self._emit({"name": name, "ph": "i", "s": "t", "pid": self.pid, "tid": self._tid(),
                    "ts": int(time.time() * 1e6), **({"args": args} if args else {})})

    def close(self):
        try:
            self._file.close()
        except OSError:
            pass


# The process's tracer, armed by the trainer; a module global because the
# sites span orchestrators, pipeline threads and the engine.
_STATE = {"tracer": None}


def _disarm_on_error(tracer):
    if _STATE["tracer"] is tracer:
        _STATE["tracer"] = None
        warnings.warn(f"span tracing disabled: writing {tracer.path} failed (disk full / closed file?) — the run "
                      "continues untraced", stacklevel=3)


def configure(path=None, process_index: int = 0):
    """Arm (``path`` given) or disarm (None) the process's tracer."""
    old, _STATE["tracer"] = _STATE["tracer"], None
    if old is not None:
        old.close()
    if path:
        _STATE["tracer"] = SpanTracer(path, process_index=process_index)


def shutdown():
    configure(None)


def enabled() -> bool:
    return _STATE["tracer"] is not None


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._args = dict(self._args or {})
            self._args["error"] = exc_type.__name__
        self._tracer.complete(self._name, self._t0, time.time(), self._args)
        return False


def trace_span(name: str, **args):
    """``with trace_span("rollout/decode", step=n):`` records one complete
    span on the calling thread's lane; a shared no-op when tracing is off."""
    tracer = _STATE["tracer"]
    if tracer is None:
        return _NULL_SPAN
    return _Span(tracer, name, args)


def complete(name: str, t0: float, **args):
    """A span that started at ``t0`` (``time.time()`` seconds) and ends now."""
    tracer = _STATE["tracer"]
    if tracer is not None:
        tracer.complete(name, t0, time.time(), args)


def instant(name: str, **args):
    """A point event (guard skip, watchdog rollback, incident)."""
    tracer = _STATE["tracer"]
    if tracer is not None:
        tracer.instant(name, args)


def read_spans(path: str):
    """Parse a spans.jsonl, tolerating a torn final line."""
    return jsonl.read_jsonl(path)


def _last_clock_record(checkpoint_dir: str):
    """The newest clock-offset record of ``fleet_clock.jsonl`` (None
    without one); a torn tail is routine after a kill."""
    path = os.path.join(checkpoint_dir, FLEET_CLOCK_FILENAME)
    if not os.path.exists(path):
        return None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        records = jsonl.read_jsonl(path)
    return records[-1] if records else None


def read_fleet_spans(checkpoint_dir: str) -> dict:
    """Every rank's span file merged into ONE Chrome trace: rank k's events
    on pid k, their tids remapped to ``k * TID_STRIDE + tid`` and their
    timestamps shifted by −offset_k into rank 0's clock when a
    ``fleet_clock.jsonl`` estimate exists (each rank's process_name states
    its offset and the bound: uncertainty plus drift). Each file's torn tail
    is tolerated; a plain ``spans.jsonl`` (graftfleet off) merges as the
    pids it carries. Returns ``{"traceEvents", "hosts", "clock",
    "alignment_error_s"}``."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    try:
        names = sorted(os.listdir(checkpoint_dir))
    except OSError:
        names = []
    files = [(int(m.group(1)), os.path.join(checkpoint_dir, n)) for n in names for m in [_HOST_SPANS_RE.match(n)] if m]
    if not files and SPANS_FILENAME in names:
        files.append((None, os.path.join(checkpoint_dir, SPANS_FILENAME)))
    clock = _last_clock_record(checkpoint_dir)
    offsets = list(clock.get("offsets_s", [])) if clock else []
    bound = float(clock.get("uncertainty_s", 0.0)) + float(clock.get("drift_s", 0.0)) if clock else 0.0
    events, hosts = [], []
    for host, path in sorted(files, key=lambda kv: (kv[0] is None, kv[0])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # torn tails, per file
            try:
                host_events = jsonl.read_jsonl(path)
            except (OSError, ValueError):
                continue
        if host is None:
            events.extend(host_events)
            hosts.extend(sorted({e.get("pid", 0) for e in host_events}))
            continue
        hosts.append(host)
        shift_us = int(offsets[host] * 1e6) if host < len(offsets) else 0
        for event in host_events:
            event = dict(event)
            event["pid"] = host
            if "tid" in event:
                event["tid"] = host * TID_STRIDE + int(event["tid"])
            if shift_us and "ts" in event:
                event["ts"] = int(event["ts"]) - shift_us
            events.append(event)
        label = f"host{host}"
        if host < len(offsets):
            label += f" (clock offset {offsets[host] * 1e3:+.3f}ms ± {bound * 1e3:.3f}ms)"
        events.append({"name": "process_name", "ph": "M", "pid": host, "args": {"name": label}})
    return {"traceEvents": events, "hosts": sorted(set(hosts)), "clock": clock, "alignment_error_s": bound}
