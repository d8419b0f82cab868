"""Experiment tracking (the counterpart of ``trlx_tpu.utils.logging``):
wandb when it is importable, and always ``<checkpoint_dir>/metrics.jsonl``
(line-atomic appends, ``utils.jsonl``). It writes on the main process only;
setting ``TRLX_TPU_DISABLE_TRACKER`` disables it, as in the JAX package."""

import os
import sys
import threading
import time
from typing import Any, Dict, Optional

try:
    import wandb  # type: ignore

    _HAS_WANDB = True
except Exception:  # noqa: BLE001 — absent, or broken on import: the JSONL record stays
    wandb = None
    _HAS_WANDB = False

from trlx_tpu_torch.parallel.mesh import is_main_process
from trlx_tpu_torch.utils import jsonl


class Tracker:
    def __init__(self, log_dir: str, config: Optional[Dict[str, Any]] = None, project_name: Optional[str] = None,
                 run_name: Optional[str] = None, entity_name: Optional[str] = None):
        self.enabled = is_main_process() and os.environ.get("TRLX_TPU_DISABLE_TRACKER", "") in ("", "0")
        self._file = None
        self._wandb = None
        self._lock = threading.Lock()  # the rollout producer logs from its own thread
        if not self.enabled:
            return
        if _HAS_WANDB:
            self._wandb = wandb.init(project=project_name, name=run_name, entity=entity_name, config=config)
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = jsonl.open_line_atomic(self.path)
        if config:
            self._write_record({"_config": {k: str(v) for k, v in config.items()}})

    def _write_record(self, record: Dict[str, Any]):
        with self._lock:
            jsonl.write_record(self._file, record)

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
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        self._write_record({"step": step, "t": round(time.time(), 3), **scalars})

    def log_table(self, name: str, columns, rows, step: Optional[int] = None):
        """A sample table: a preview on stderr, the first 32 rows on file."""
        if not self.enabled:
            return
        if self._wandb is not None:
            self._wandb.log({name: wandb.Table(columns=list(columns), data=list(rows))}, step=step)
        print(f"[{name}] step={step}", file=sys.stderr)
        for row in rows[:4]:
            print("  " + " | ".join(str(c)[:60] for c in row), file=sys.stderr)
        self._write_record({"table": name, "step": step, "columns": list(columns),
                            "rows": [[str(c) for c in r] for r in rows[:32]]})

    def log_histogram(self, name: str, values, step: Optional[int] = None):
        """A distribution (ILQL's decode-time Q, V and advantage; the health
        monitor's lineage staleness) as summary statistics: count, mean,
        std, min, p5, p50, p95, max."""
        if not self.enabled:
            return
        import numpy as np

        values = np.asarray(values, dtype=np.float32).reshape(-1)
        if values.size == 0:
            return
        if self._wandb is not None:
            self._wandb.log({name: wandb.Histogram(values)}, step=step)
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

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
