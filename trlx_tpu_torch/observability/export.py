"""Live metrics endpoint: stdlib-HTTP Prometheus ``/metrics`` and
``/healthz`` (the counterpart of ``trlx_tpu.observability.export``).

A zero-dependency ``http.server`` daemon thread on the main process, armed
by ``train.metrics_port`` (``TRLX_TPU_METRICS_PORT`` wins) and off by
default:

- ``GET /metrics``: Prometheus text exposition (version 0.0.4) of the
  freshest log-boundary scalars and ``health/*`` gauges, keys sanitized and
  prefixed ``trlx_tpu_``; keys ending ``_total`` are counters, the rest
  gauges; labelled gauge series (``set_gauge``: the elastic fleet's
  per-worker gauges); cumulative histograms (``observe``) with optional
  labels.
- ``GET /healthz``: the HealthMonitor's JSON status (``ok`` / ``degraded``
  / ``critical`` and each detector's state), with the ``fleet`` block
  (``set_fleet``: graftfleet's and the disaggregated fleet's, merged) when
  one is armed.

The handler reads a snapshot under a lock and never touches trainer state,
so a scrape never stalls a train step.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from trlx_tpu_torch.utils import sanitize


__all__ = ["sanitize_metric_name", "MetricsExporter"]

# Prometheus metric names must match [a-zA-Z_:][a-zA-Z0-9_:]* — the tracker's
# slash-namespaced keys (health/kl_ratio, time/train_s, obs/train_mfu_pct)
# and dash-bearing keys are all illegal until sanitized.
_ILLEGAL = re.compile(r"[^a-zA-Z0-9_:]")
_VALID = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def sanitize_metric_name(key: str) -> str:
    """Map an arbitrary tracker key to a legal Prometheus metric name:
    every illegal character (``/``, ``-``, ``.``, spaces, ...) becomes
    ``_``, and a leading digit gets a ``_`` prefix."""
    name = _ILLEGAL.sub("_", str(key))
    if not name or not _VALID.match(name):
        name = "_" + name
    return name


def _fmt_value(v: float) -> str:
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(v)


class MetricsExporter:
    """Threaded HTTP server publishing the latest gauge snapshot.

    ``port=0`` binds an ephemeral port (tests); the trainer only constructs
    one when the configured port is > 0. ``update()`` replaces nothing —
    it merges, so gauges logged at different cadences (per-step stats,
    per-window phase stats) coexist in one scrape."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0", prefix: str = "trlx_tpu_",
                 port_file=None):
        self.prefix = prefix
        self._lock = sanitize.make_lock("MetricsExporter._lock")
        self._gauges = {}
        # (key, labels-tuple) -> float: labelled gauge series (set_gauge),
        # rendered with the flat gauge of the same name.
        self._labeled_gauges = {}
        # (key, labels-tuple) -> {"buckets": (edges...), "counts": [..],
        # "sum": float, "count": int} — cumulative, Prometheus-style.
        self._histograms = {}
        self._health = None
        self._fleet = None  # graftfleet's /healthz block (set_fleet)
        self._step = 0
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 — silence per-request spam
                pass

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = exporter.render_metrics().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    body = (json.dumps(exporter.render_healthz()) + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.requested_port = int(port)
        try:
            self._server = ThreadingHTTPServer((host, int(port)), Handler)
        except OSError:
            # Port busy (two hosts on one box, a stale run's exporter): bind
            # an ephemeral port instead of crashing the trainer. The actual
            # port is logged, exposed as the obs/metrics_port gauge, and
            # written to port_file — a scraper can always find it.
            self._server = ThreadingHTTPServer((host, 0), Handler)
        # ThreadingHTTPServer daemonizes handler threads but still JOINS
        # them in server_close() (block_on_close) — one wedged scrape
        # connection would hang trainer teardown forever.
        self._server.block_on_close = False
        self.port = int(self._server.server_address[1])
        if self.requested_port and self.port != self.requested_port:
            import sys

            print(
                f"[trlx_tpu_torch.observability] metrics port {self.requested_port} "
                f"busy — serving /metrics on port {self.port} instead "
                "(see the obs/metrics_port gauge / metrics_port file)",
                file=sys.stderr,
                flush=True,
            )
        with self._lock:
            self._gauges["obs/metrics_port"] = float(self.port)
        self.port_file = port_file
        if port_file:
            try:
                with open(port_file, "w") as f:
                    f.write(f"{self.port}\n")
            except OSError:
                pass  # advisory breadcrumb only
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="trlx-metrics-exporter",
            daemon=True,
        )
        self._thread.start()

    def update(self, gauges: dict, step=None, health=None):
        """Merge the freshest scalar gauges (and optionally the health
        payload for ``/healthz``). Non-numeric values are dropped here so a
        stray string in a stats dict can never corrupt the exposition."""
        numeric = {
            k: float(v) for k, v in (gauges or {}).items() if isinstance(v, (int, float))
        }
        with self._lock:
            sanitize.race_access(self, "_gauges", write=True)
            self._gauges.update(numeric)
            if step is not None:
                self._step = int(step)
            if health is not None:
                self._health = health

    def set_fleet(self, payload):
        """Attach a fleet block to ``/healthz``: graftfleet's (per-rank
        heartbeat ages, the desync check's status, the straggler verdict,
        the clock estimate) or the disaggregated fleet feed's
        (``disaggregated``, ``workers``). Dict payloads MERGE key-wise: the
        two feeds own disjoint top-level keys."""
        with self._lock:
            if isinstance(payload, dict) and isinstance(self._fleet, dict):
                merged = dict(self._fleet)
                merged.update(payload)
                self._fleet = merged
            else:
                self._fleet = payload

    def set_gauge(self, key: str, value, labels: dict = None):
        """Set one LABELLED gauge series (``labels`` distinguishes series
        under one metric name, e.g. ``worker="1"`` on the elastic fleet's
        per-worker gauges). Without labels it is ``update({key: value})``.
        A labelled series renders beside the flat gauge of the same name
        under one HELP/TYPE block."""
        if not isinstance(value, (int, float)):
            return
        if not labels:
            self.update({key: value})
            return
        label_key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            sanitize.race_access(self, "_gauges", write=True)
            self._labeled_gauges[(key, label_key)] = float(value)

    def observe(self, key: str, values, buckets, labels: dict = None):
        """Fold ``values`` into the cumulative histogram ``key`` (creating
        it with ``buckets`` as its ``le`` edges on first sight). ``labels``
        distinguishes series under one metric name (``lane="score"``,
        ``width="64"``) the Prometheus way."""
        label_key = tuple(sorted((labels or {}).items()))
        edges = tuple(float(b) for b in buckets)
        with self._lock:
            hist = self._histograms.get((key, label_key))
            if hist is None or hist["buckets"] != edges:
                hist = self._histograms[(key, label_key)] = {
                    "buckets": edges,
                    "counts": [0] * (len(edges) + 1),  # +Inf bucket last
                    "sum": 0.0,
                    "count": 0,
                }
            for v in values:
                v = float(v)
                if v != v:
                    continue
                idx = len(edges)
                for i, edge in enumerate(edges):
                    if v <= edge:
                        idx = i
                        break
                hist["counts"][idx] += 1
                hist["sum"] += v
                hist["count"] += 1

    @staticmethod
    def _render_labels(label_key, extra=None):
        pairs = list(label_key) + (extra or [])
        if not pairs:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"

    def render_metrics(self) -> str:
        with self._lock:
            sanitize.race_access(self, "_gauges")
            gauges = dict(self._gauges)
            labeled = dict(self._labeled_gauges)
            histograms = {
                k: {
                    "buckets": h["buckets"],
                    "counts": list(h["counts"]),
                    "sum": h["sum"],
                    "count": h["count"],
                }
                for k, h in self._histograms.items()
            }
            step = self._step
        # Sanitized-name collisions (a/b vs a_b) keep the last writer —
        # exposition must never emit a duplicate metric name.
        by_name = {}
        for key in sorted(gauges):
            by_name[sanitize_metric_name(self.prefix + key)] = (key, gauges[key])
        # A name's flat sample and its labelled series share one HELP/TYPE
        # block (the label set keeps labelled samples distinct).
        labeled_by_name = {}
        for (key, label_key), value in sorted(labeled.items()):
            name = sanitize_metric_name(self.prefix + key)
            labeled_by_name.setdefault(name, (key, []))[1].append((label_key, value))
            by_name.setdefault(name, (key, None))
        lines = []
        for name in sorted(by_name):
            key, value = by_name[name]
            kind = "counter" if key.endswith("_total") else "gauge"
            lines.append(f"# HELP {name} trlx_tpu tracker key {key!r}")
            lines.append(f"# TYPE {name} {kind}")
            if value is not None:
                lines.append(f"{name} {_fmt_value(value)}")
            for label_key, lvalue in labeled_by_name.get(name, ("", []))[1]:
                lines.append(f"{name}{self._render_labels(label_key)} {_fmt_value(lvalue)}")
        hist_by_name = {}
        for (key, label_key), hist in sorted(histograms.items()):
            hist_by_name.setdefault(
                sanitize_metric_name(self.prefix + key), (key, [])
            )[1].append((label_key, hist))
        for name in sorted(hist_by_name):
            key, series = hist_by_name[name]
            lines.append(f"# HELP {name} trlx_tpu tracker key {key!r}")
            lines.append(f"# TYPE {name} histogram")
            for label_key, hist in series:
                cumulative = 0
                for edge, n in zip(hist["buckets"], hist["counts"]):
                    cumulative += n
                    labels = self._render_labels(label_key, [("le", _fmt_value(edge))])
                    lines.append(f"{name}_bucket{labels} {cumulative}")
                labels = self._render_labels(label_key, [("le", "+Inf")])
                lines.append(f"{name}_bucket{labels} {hist['count']}")
                labels = self._render_labels(label_key)
                lines.append(f"{name}_sum{labels} {_fmt_value(hist['sum'])}")
                lines.append(f"{name}_count{labels} {hist['count']}")
        name = sanitize_metric_name(self.prefix + "last_step")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {step}")
        return "\n".join(lines) + "\n"

    def render_healthz(self) -> dict:
        with self._lock:
            health = self._health
            fleet = self._fleet
            step = self._step
        payload = {"status": "unknown", "detectors": {}}
        if health:
            payload.update(health)
        if fleet is not None:
            payload["fleet"] = fleet
        payload["step"] = step
        return payload

    def close(self):
        self._server.shutdown()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # serve_forever never returned (wedged handler holding the
            # poll loop) — closing the listener socket under it would
            # race; leak the daemon thread and let exit reap it.
            return
        self._server.server_close()
        # Closed: no request reads the gauges after this.
        sanitize.race_forget(self)
