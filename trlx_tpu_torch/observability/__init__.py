"""Observability (the counterpart of ``trlx_tpu.observability``, its
single-process core), all off the hot path and off by default:

- ``spans``: Chrome-trace span tracing into ``<ckpt_dir>/spans.jsonl``
  (``train.trace_spans`` / ``TRLX_TPU_SPANS=1``);
- ``anomaly``: a rolling-median step-time detector and one-shot incident
  bundles under ``<ckpt_dir>/incidents/<step>/`` (``train.anomaly_factor``
  / ``TRLX_TPU_ANOMALY_FACTOR``; a guard skip, a watchdog rollback and a
  health CRIT capture one too);
- ``health``: streaming RLHF health detectors with OK/WARN/CRIT
  hysteresis, ``health/*`` gauges and per-chunk lineage records in
  ``<ckpt_dir>/lineage.jsonl`` (``train.health_monitor`` /
  ``TRLX_TPU_HEALTH=1``);
- ``export``: a live Prometheus ``/metrics`` and JSON ``/healthz`` from the
  main process (``train.metrics_port`` / ``TRLX_TPU_METRICS_PORT``);
- ``fleet``: graftfleet, the cross-rank arrivals, clock and skew table
  (``train.graftfleet`` / ``TRLX_TPU_GRAFTFLEET``);
- ``numerics``: graftnum, the ``num/*`` step statistics, NaN provenance in
  guard-skip bundles and the quantization error at handoffs
  (``train.graftnum`` / ``TRLX_TPU_GRAFTNUM``);
- ``devicemon``: FLOPs counted at each monitored program's first dispatch,
  MFU per window, routing and memory gauges, ``programs.json``
  (``train.device_telemetry`` / ``TRLX_TPU_DEVICE_TELEMETRY``);
- ``graftscope``: the device/host/bubble ledger, the engine's slot timeline
  and ``RunManifest`` (``train.graftscope`` / ``TRLX_TPU_GRAFTSCOPE``);
- ``report``: the markdown report of a run's directory.
"""

import os

from trlx_tpu_torch.observability import spans  # noqa: F401
from trlx_tpu_torch.observability.anomaly import AnomalyDetector, IncidentCapture  # noqa: F401
from trlx_tpu_torch.observability.health import HealthMonitor, LineageRecord  # noqa: F401
from trlx_tpu_torch.observability.spans import instant, trace_span  # noqa: F401


def env_flag(name: str) -> bool:
    """True when the environment variable is set to anything but '' / '0'."""
    return os.environ.get(name, "") not in ("", "0")
