"""Host-side divergence watchdog over per-step loss scalars (the
counterpart of ``trlx_tpu.resilience.watchdog``).

The non-finite guard (``guard.py``) catches outright NaN/inf; this catches
the slower failure mode where the loss is finite but running away. The
trainer buffers each step's loss and feeds the host values through
``observe()`` at its flush cadence; ``True`` means "sustained divergence —
roll back": the trainer restores the last intact checkpoint, decays the LR
by ``train.watchdog_lr_decay`` and resumes.
"""

import math


class DivergenceWatchdog:
    """EMA + threshold breach counter.

    A step *breaches* when its loss is non-finite or exceeds
    ``ema + threshold * max(|ema|, 1)``. Breaching steps do not update the
    EMA; ``patience`` consecutive breaches trigger. The first ``warmup``
    finite observations only build the EMA."""

    def __init__(self, threshold: float, patience: int = 4, ema_alpha: float = 0.9, warmup: int = 5):
        if threshold <= 0:
            raise ValueError(f"watchdog threshold must be > 0, got {threshold}")
        self.threshold = float(threshold)
        self.patience = max(int(patience), 1)
        self.ema_alpha = float(ema_alpha)
        self.warmup = max(int(warmup), 0)
        self.reset()

    def reset(self):
        """Forget all history (after a rollback the restored losses rebuild
        a fresh baseline)."""
        self.ema = None
        self.breaches = 0
        self._seen = 0

    def _limit(self) -> float:
        return self.ema + self.threshold * max(abs(self.ema), 1.0)

    def observe(self, value) -> bool:
        """Feed one per-step loss; True when divergence is sustained."""
        v = float(value)
        warmed = self._seen >= self.warmup
        if not math.isfinite(v):
            breach = warmed  # non-finite during warmup: don't trigger, don't learn
        else:
            breach = warmed and self.ema is not None and v > self._limit()
            if not breach:
                self.ema = v if self.ema is None else self.ema_alpha * self.ema + (1.0 - self.ema_alpha) * v
                self._seen += 1
        self.breaches = self.breaches + 1 if breach else 0
        return self.breaches >= self.patience
