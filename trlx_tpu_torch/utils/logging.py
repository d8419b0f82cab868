"""Experiment tracking: ``<checkpoint_dir>/metrics.jsonl`` (the JSONL
fallback of ``trlx_tpu.utils.logging.Tracker``; wandb is not ported).
Setting ``TRLX_TPU_DISABLE_TRACKER`` disables it, as in the JAX package."""

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, log_dir: str, config: Optional[Dict[str, Any]] = None):
        self.enabled = os.environ.get("TRLX_TPU_DISABLE_TRACKER", "") in ("", "0")
        self._file = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a")
        if config:
            self._write_record({"_config": {k: str(v) for k, v in config.items()}})

    def _write_record(self, record: Dict[str, Any]):
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log(self, stats: Dict[str, Any], step: Optional[int] = None):
        """One record of scalars (non-numeric values are stored as str)."""
        if not self.enabled:
            return
        scalars = {}
        for k, v in stats.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                scalars[k] = str(v)
        self._write_record({"step": step, "t": round(time.time(), 3), **scalars})

    def log_table(self, name: str, columns, rows, step: Optional[int] = None):
        """A sample table: a preview on stderr, the first 32 rows on file."""
        if not self.enabled:
            return
        print(f"[{name}] step={step}", file=sys.stderr)
        for row in rows[:4]:
            print("  " + " | ".join(str(c)[:60] for c in row), file=sys.stderr)
        self._write_record({"table": name, "step": step, "columns": list(columns),
                            "rows": [[str(c) for c in r] for r in rows[:32]]})

    def log_histogram(self, name: str, values, step: Optional[int] = None):
        """A distribution (ILQL's decode-time Q, V and advantage) as summary
        statistics: count, mean, std, min, p5, p50, p95, max."""
        if not self.enabled:
            return
        import numpy as np

        values = np.asarray(values, dtype=np.float32).reshape(-1)
        if values.size == 0:
            return
        self._write_record({
            "histogram": name,
            "step": step,
            "count": int(values.size),
            "mean": float(values.mean()),
            "std": float(values.std()),
            "min": float(values.min()),
            "p5": float(np.percentile(values, 5)),
            "p50": float(np.median(values)),
            "p95": float(np.percentile(values, 95)),
            "max": float(values.max()),
        })
