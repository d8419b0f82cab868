"""Training-health monitor: streaming RLHF drift detection (the
counterpart of ``trlx_tpu.observability.health``).

RLHF fails silently in several ways: reward hacking shifts the score
distribution, a saturated KL controller stops constraining the policy,
entropy collapse precedes mode collapse, a value head that explains no
variance starves PPO of advantage signal, and degenerate generations
(truncation walls, n-gram loops) poison the store. ``HealthMonitor`` holds
one streaming detector per failure mode, fed from what the trainer already
has on the host (the log-boundary stats, the scored rollout chunks). Each
detector maps an observation to a severity (0/1/2) through a shared
hysteresis machine: WARN after ``warn_streak`` consecutive bad observations,
CRIT after ``crit_streak`` consecutive severity-2 ones, and de-escalation one
level per ``warn_streak`` clean observations.

Outputs, all off the hot path: ``health/*`` gauges merged into the
Tracker's log-boundary record, a monotonic ``health/state_changes_total``;
per-chunk ``LineageRecord``s appended to ``<ckpt_dir>/lineage.jsonl``; a CRIT
transition escalates into an incident bundle through
``anomaly.register_emergency``; the live ``/metrics`` and ``/healthz``
(``export.py``) serve the same gauges.

Armed by ``train.health_monitor`` (or ``TRLX_TPU_HEALTH=1``), off by
default. ``TRLX_TPU_FAULTS=reward_drift@N`` / ``entropy_collapse@N`` latch a
perturbation of the OBSERVED stats only (training is untouched).
"""

import json
import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass

import numpy as np

from trlx_tpu_torch.utils import jsonl

__all__ = [
    "OK",
    "WARN",
    "CRIT",
    "HysteresisDetector",
    "RewardDriftDetector",
    "KLHealthDetector",
    "EntropyCollapseDetector",
    "ExplainedVarianceDetector",
    "RolloutSentinel",
    "MixedVersionDetector",
    "LineageRecord",
    "HealthMonitor",
    "truncation_rate",
    "degenerate_rate",
]

OK, WARN, CRIT = "ok", "warn", "crit"
_LEVEL = {OK: 0, WARN: 1, CRIT: 2}
_STATE = {0: OK, 1: WARN, 2: CRIT}


class HysteresisDetector:
    """Severity stream -> OK/WARN/CRIT state machine with hysteresis.

    Subclasses implement ``severity(obs) -> 0|1|2`` (pure judgment, no state
    transitions). ``observe(obs)`` runs the shared transition rules:

    - OK -> WARN after ``warn_streak`` consecutive observations with
      severity >= 1;
    - -> CRIT after ``crit_streak`` consecutive severity-2 observations
      (a CRIT always passes through WARN on the way up, so consumers see
      the full OK -> WARN -> CRIT trajectory);
    - de-escalation is ONE level per ``clear_streak`` consecutive clean
      observations (CRIT -> WARN -> OK needs two full clean streaks), so a
      brief recovery inside an incident never silently clears it.

    Every transition increments ``state_changes`` (the monotonic counter the
    Tracker/exporter surface); a transition INTO crit invokes ``on_crit``
    (the monitor routes it to the incident machinery) behind a guard — the
    escalation path must never take the training loop down."""

    name = "detector"

    def __init__(self, warn_streak: int = 2, crit_streak: int = 4, clear_streak=None):
        self.warn_streak = max(1, int(warn_streak))
        self.crit_streak = max(1, int(crit_streak))
        self.clear_streak = max(
            1, int(clear_streak if clear_streak is not None else warn_streak)
        )
        self.state = OK
        self.state_changes = 0
        self.last_severity = 0
        self.observations = 0
        self.on_crit = None  # set by HealthMonitor
        self._bad = 0  # consecutive severity >= 1
        self._crit = 0  # consecutive severity == 2
        self._clean = 0  # consecutive severity == 0

    def severity(self, obs) -> int:
        raise NotImplementedError

    def observe(self, obs) -> str:
        sev = int(self.severity(obs))
        self.last_severity = sev
        self.observations += 1
        if sev >= 1:
            self._clean = 0
            self._bad += 1
            self._crit = self._crit + 1 if sev == 2 else 0
        else:
            self._bad = self._crit = 0
            self._clean += 1
        level = _LEVEL[self.state]
        new = level
        if self._crit >= self.crit_streak:
            new = 2
        elif self._bad >= self.warn_streak:
            # Escalate to WARN; never knocks an established CRIT back down —
            # only a clean streak de-escalates.
            new = max(level, 1)
        elif self._clean >= self.clear_streak and level > 0:
            new = level - 1
            self._clean = 0  # the next level down costs another full streak
        if new != level:
            self.state = _STATE[new]
            self.state_changes += 1
            if new == 2 and self.on_crit is not None:
                try:
                    self.on_crit(self, obs)
                except Exception:  # noqa: BLE001 — escalation is best-effort
                    pass
        return self.state


class RewardDriftDetector(HysteresisDetector):
    """Reward-distribution drift: rolling mean of recent chunk scores vs a
    frozen warmup baseline, judged as a z-score. The sigma floor
    (``max(sigma0, 0.1|mu0|)``) keeps a freakishly-quiet warmup from turning
    ordinary fluctuation into WARNs."""

    name = "reward_drift"

    def __init__(self, warmup: int = 5, warn_z: float = 3.0, crit_z: float = 6.0,
                 recent_window: int = 4, **kw):
        super().__init__(**kw)
        self.warmup = max(1, int(warmup))
        self.warn_z = float(warn_z)
        self.crit_z = float(crit_z)
        self._baseline = []
        self._recent = deque(maxlen=max(1, int(recent_window)))
        self.mu0 = self.sigma0 = None
        self.z = 0.0

    def severity(self, x) -> int:
        x = float(x)
        if len(self._baseline) < self.warmup:
            self._baseline.append(x)
            return 0
        if self.mu0 is None:
            base = np.asarray(self._baseline, dtype=np.float64)
            self.mu0 = float(base.mean())
            self.sigma0 = max(float(base.std()), 0.1 * abs(self.mu0), 1e-3)
        self._recent.append(x)
        self.z = abs(float(np.mean(self._recent)) - self.mu0) / self.sigma0
        if self.z >= self.crit_z:
            return 2
        if self.z >= self.warn_z:
            return 1
        return 0


class KLHealthDetector(HysteresisDetector):
    """KL-controller health, judged only when an adaptive target exists:

    - sustained ``mean_kl`` ABOVE target (ratio >= warn_ratio WARNs,
      >= crit_ratio CRITs) — the policy is escaping the trust region faster
      than the controller reins it in;
    - sustained ``mean_kl`` far BELOW target WARNs only — an over-tight
      leash wastes the KL budget but is not dangerous;
    - coefficient saturation (kl_coef pinned ``sat_factor``x away from its
      init) WARNs — the controller has run out of authority, commonly a
      staleness symptom on the pipelined schedules."""

    name = "kl"

    def __init__(self, warmup: int = 5, warn_ratio: float = 2.0, crit_ratio: float = 4.0,
                 sat_factor: float = 10.0, **kw):
        super().__init__(**kw)
        self.warmup = max(0, int(warmup))
        self.warn_ratio = float(warn_ratio)
        self.crit_ratio = float(crit_ratio)
        self.sat_factor = float(sat_factor)
        self.ratio = 0.0
        self.coef = 0.0
        self._seen = 0

    def severity(self, obs) -> int:
        kl, target = obs.get("kl"), obs.get("target")
        coef, init = obs.get("coef"), obs.get("init_coef")
        if coef is not None:
            self.coef = float(coef)
        if kl is None or target is None or float(target) <= 0:
            return 0  # fixed controller / no KL stats: nothing to judge
        self._seen += 1
        self.ratio = float(kl) / float(target)
        if self._seen <= self.warmup:
            return 0  # early KL is legitimately far from target
        sev = 0
        if self.ratio >= self.crit_ratio:
            sev = 2
        elif self.ratio >= self.warn_ratio or self.ratio <= 1.0 / self.warn_ratio:
            sev = 1
        if (
            coef is not None
            and init
            and (float(coef) >= self.sat_factor * float(init)
                 or float(coef) <= float(init) / self.sat_factor)
        ):
            sev = max(sev, 1)
        return sev


class EntropyCollapseDetector(HysteresisDetector):
    """Sampled-token entropy vs a warmup baseline: a policy whose entropy
    drops to a small fraction of where it started is converging on a narrow
    mode (often right before degenerate output)."""

    name = "entropy"

    def __init__(self, warmup: int = 5, warn_frac: float = 0.5, crit_frac: float = 0.2, **kw):
        super().__init__(**kw)
        self.warmup = max(1, int(warmup))
        self.warn_frac = float(warn_frac)
        self.crit_frac = float(crit_frac)
        self._baseline = []
        self.base = None
        self.value = 0.0

    def severity(self, e) -> int:
        self.value = float(e)
        if len(self._baseline) < self.warmup:
            self._baseline.append(self.value)
            return 0
        if self.base is None:
            self.base = float(np.mean(self._baseline))
        if self.base <= 1e-9:
            return 0  # degenerate baseline: fractions are meaningless
        if self.value < self.crit_frac * self.base:
            return 2
        if self.value < self.warn_frac * self.base:
            return 1
        return 0


class ExplainedVarianceDetector(HysteresisDetector):
    """Value-head explained variance (1 - Var(returns - vpred)/Var(returns)).
    Negative EV means the critic is WORSE than predicting the mean return —
    GAE advantages are then mostly noise. Early training is exempt
    (``warmup``): a fresh value head always starts there."""

    name = "value_ev"

    def __init__(self, warmup: int = 5, warn_ev: float = 0.0, crit_ev: float = -0.5, **kw):
        super().__init__(**kw)
        self.warmup = max(0, int(warmup))
        self.warn_ev = float(warn_ev)
        self.crit_ev = float(crit_ev)
        self.value = 0.0
        self._seen = 0

    def severity(self, ev) -> int:
        self.value = float(ev)
        self._seen += 1
        if self._seen <= self.warmup:
            return 0
        if self.value < self.crit_ev:
            return 2
        if self.value < self.warn_ev:
            return 1
        return 0


def truncation_rate(mask_h, prompt_length: int) -> float:
    """Fraction of rows whose response fills the whole decode budget — no
    EOS inside the window. High sustained truncation means the budget is
    clipping the task (or the policy stopped emitting EOS)."""
    mask = np.asarray(mask_h)
    budget = mask.shape[1] - int(prompt_length)
    if budget <= 0 or mask.shape[0] == 0:
        return 0.0
    lengths = mask[:, prompt_length:].astype(np.int64).sum(axis=1)
    return float(np.mean(lengths >= budget))


def degenerate_rate(tokens_h, mask_h, prompt_length: int, n: int = 3) -> float:
    """Fraction of rows whose response repeats an n-gram — the loop/stutter
    signature of a collapsing sampler. Rows shorter than 2n tokens cannot
    exhibit a repeat and count as clean."""
    tokens = np.asarray(tokens_h)
    mask = np.asarray(mask_h)
    if tokens.shape[0] == 0:
        return 0.0
    hits = 0
    for i in range(tokens.shape[0]):
        row = tokens[i, prompt_length:][mask[i, prompt_length:] > 0]
        if row.size < 2 * n:
            continue
        seen = set()
        for j in range(row.size - n + 1):
            gram = tuple(int(t) for t in row[j : j + n])
            if gram in seen:
                hits += 1
                break
            seen.add(gram)
    return float(hits) / float(tokens.shape[0])


class RolloutSentinel(HysteresisDetector):
    """Host-side degenerate-sample sentinel over each rollout chunk:
    truncation rate and repeated-n-gram rate. Degeneracy drives CRIT;
    a truncation wall alone WARNs (long-answer tasks legitimately live
    near the budget)."""

    name = "rollout"

    def __init__(self, warn_trunc: float = 0.95, warn_degen: float = 0.3,
                 crit_degen: float = 0.7, **kw):
        super().__init__(**kw)
        self.warn_trunc = float(warn_trunc)
        self.warn_degen = float(warn_degen)
        self.crit_degen = float(crit_degen)
        self.trunc = 0.0
        self.degen = 0.0

    def severity(self, obs) -> int:
        self.trunc = float(obs.get("trunc", 0.0))
        self.degen = float(obs.get("degen", 0.0))
        if self.degen >= self.crit_degen:
            return 2
        if self.trunc >= self.warn_trunc or self.degen >= self.warn_degen:
            return 1
        return 0


class MixedVersionDetector(HysteresisDetector):
    """Token-granularity staleness watch for in-flight weight updates: the
    fraction of a consumed batch's response tokens NOT produced by its
    freshest weight version. Some mix is the whole point of pushing weights
    mid-decode (episodes straddle a version switch); a batch that is MOSTLY
    old tokens means pushes outpace decode and the learner is training on
    yesterday's policy — WARN at ``warn_frac``, CRIT at ``crit_frac``.
    In the JAX package the fleet's learner feeds it; here it is ported for
    the fleet to come (ROADMAP §A12) and held against the JAX detector."""

    name = "mixed_version"

    def __init__(self, warn_frac: float = 0.5, crit_frac: float = 0.9, **kw):
        super().__init__(**kw)
        self.warn_frac = float(warn_frac)
        self.crit_frac = float(crit_frac)
        self.frac = 0.0

    def severity(self, obs) -> int:
        mixed = float(obs.get("mixed_tokens", 0.0))
        total = float(obs.get("total_tokens", 0.0))
        self.frac = mixed / total if total > 0 else 0.0
        if self.frac >= self.crit_frac:
            return 2
        if self.frac >= self.warn_frac:
            return 1
        return 0


@dataclass
class LineageRecord:
    """Per-chunk provenance: which weights produced these rows, how stale
    they were by the time they train, and how degenerate they looked at the
    host boundary. One JSON line per chunk in ``<ckpt_dir>/lineage.jsonl``.

    ``version_spans`` extends the scalar ``weight_version`` tag to span
    form for in-flight weight updates: ``[[version, n_tokens],
    ...]`` aggregated over the chunk's episodes — which versions produced
    HOW MANY of the chunk's tokens, not just which version finished it.
    None on the phase-boundary paths, so pre-span lineage files load
    unchanged (``from_json`` defaults missing fields)."""

    step: int
    weight_version: int
    staleness: float
    rows: int
    truncation_rate: float
    degenerate_rate: float
    mean_score: float
    time: float
    version_spans: list = None

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, line: str) -> "LineageRecord":
        d = json.loads(line)
        return cls(
            **{k: d[k] for k in cls.__dataclass_fields__ if k in d}
        )


class HealthMonitor:
    """Thread-safe front door for the detectors.

    ``observe_train`` runs on the main thread at the trainer's log boundary;
    ``observe_chunk`` runs on whichever thread the orchestrator scores
    rollouts on (the producer thread under the overlapped schedules);
    ``gauges``/``healthz`` are read by the Tracker merge and the live
    exporter. One lock serializes everything — the work per call is a few
    scalar comparisons, nowhere near the dispatch path."""

    def __init__(self, *, warmup: int = 5, warn_streak: int = 2, crit_streak: int = 4,
                 lineage_path=None):
        streaks = dict(warn_streak=warn_streak, crit_streak=crit_streak)
        self.reward = RewardDriftDetector(warmup=warmup, **streaks)
        self.kl = KLHealthDetector(warmup=warmup, **streaks)
        self.entropy = EntropyCollapseDetector(warmup=warmup, **streaks)
        self.value_ev = ExplainedVarianceDetector(warmup=warmup, **streaks)
        self.rollout = RolloutSentinel(**streaks)
        self.detectors = {
            d.name: d
            for d in (self.reward, self.kl, self.entropy, self.value_ev, self.rollout)
        }
        for d in self.detectors.values():
            d.on_crit = self._escalate
        self.lineage_path = lineage_path
        self.lineage = deque(maxlen=256)
        self._staleness_since_hist = []
        self._lock = threading.Lock()
        # Drill latches (TRLX_TPU_FAULTS=reward_drift@N / entropy_collapse@N):
        # perturb the OBSERVED stats only — training never sees them.
        self.reward_offset = 0.0
        self.entropy_scale = 1.0
        self._drift_from_call = None

    def register_detector(self, detector: HysteresisDetector):
        """Adopt a detector another module feeds (graftfleet's
        ``FleetStragglerDetector``): its state rides the ``health/*`` gauges
        and ``/healthz``, and its CRIT escalates like the built-ins'."""
        with self._lock:
            self.detectors[detector.name] = detector
            detector.on_crit = self._escalate
        return detector

    # ------------------------------------------------------------ drills

    def inject_reward_drift(self, from_call=None):
        """``from_call`` keys the offset to a reward-call index: with the
        overlapped schedules the drill fires on the score-worker thread while
        EARLIER calls' observations are still in flight on another thread, so
        a bare wall-clock latch would contaminate the warmup baseline and
        suppress the very z-score the drill exists to trip."""
        self.reward_offset = float(
            os.environ.get("TRLX_TPU_REWARD_DRIFT_DELTA", "") or 1e3
        )
        self._drift_from_call = None if from_call is None else int(from_call)

    def _reward_offset_for(self, call) -> float:
        if not self.reward_offset:
            return 0.0
        if self._drift_from_call is None or call is None:
            return self.reward_offset
        return self.reward_offset if int(call) >= self._drift_from_call else 0.0

    def inject_entropy_collapse(self):
        self.entropy_scale = float(
            os.environ.get("TRLX_TPU_ENTROPY_COLLAPSE_SCALE", "") or 0.01
        )

    # ------------------------------------------------------------ escalation

    def _escalate(self, detector, obs):
        """CRIT -> incident bundle, through the emergency hook
        (anomaly.register_emergency): the trainer registered its
        IncidentCapture there when any observability feature armed, and this
        may run on a producer thread with no trainer reference in scope."""
        from trlx_tpu_torch.observability.anomaly import emergency_capture

        detail = {"detector": detector.name, "severity": detector.last_severity}
        if isinstance(obs, dict):
            detail.update({k: v for k, v in obs.items() if isinstance(v, (int, float))})
        else:
            try:
                detail["observation"] = float(obs)
            except (TypeError, ValueError):
                pass
        emergency_capture(f"health_{detector.name}", detail=detail)

    # ------------------------------------------------------------ feeds

    def observe_train(self, stats, step: int, *, kl_coef=None, kl_target=None,
                      kl_init_coef=None):
        """Log-boundary feed: judge the per-step stats the trainer already
        synced to host. Missing keys are skipped (ILQL has no mean_kl)."""
        with self._lock:
            entropy = stats.get("mean_entropy")
            if entropy is not None:
                self.entropy.observe(float(entropy) * self.entropy_scale)
            ev = stats.get("explained_variance")
            if ev is not None:
                self.value_ev.observe(float(ev))
            kl = stats.get("mean_kl")
            if kl is not None or kl_coef is not None:
                self.kl.observe(
                    {"kl": kl, "target": kl_target, "coef": kl_coef,
                     "init_coef": kl_init_coef}
                )

    def observe_chunk(self, tokens_h, mask_h, prompt_length: int, *, scores,
                      weight_version: int, staleness, step: int,
                      reward_call=None, version_spans=None):
        """Rollout-boundary feed, one call per scored chunk: reward drift
        over the chunk's mean score, the degenerate-sample sentinels over
        its token grid, and the chunk's lineage record. ``reward_call`` is
        the chunk's reward-call index (drill offset keying);
        ``version_spans`` is the chunk's per-token weight-version aggregate
        (``[[version, n_tokens], ...]``, engine in-flight updates) — None
        keeps the record byte-compatible with the scalar-tag paths."""
        scores = np.asarray(scores, dtype=np.float64)
        offset = self._reward_offset_for(reward_call)
        mean_score = float(scores.mean()) + offset if scores.size else 0.0
        trunc = truncation_rate(mask_h, prompt_length)
        degen = degenerate_rate(tokens_h, mask_h, prompt_length)
        record = LineageRecord(
            step=int(step),
            weight_version=int(weight_version),
            staleness=float(staleness),
            rows=int(np.asarray(mask_h).shape[0]),
            truncation_rate=trunc,
            degenerate_rate=degen,
            mean_score=mean_score,
            time=time.time(),
            version_spans=(
                [[None if v is None else int(v), int(k)] for v, k in version_spans]
                if version_spans
                else None
            ),
        )
        with self._lock:
            self.reward.observe(mean_score)
            self.rollout.observe({"trunc": trunc, "degen": degen})
            self.lineage.append(record)
            self._staleness_since_hist.append(float(staleness))
            if self.lineage_path:
                try:
                    # Line-atomic single-write append (utils/jsonl contract):
                    # a killed host tears at most the final lineage record.
                    # The spans field is span-form-only: scalar-tag records
                    # stay byte-identical to pre-span lineage files.
                    rec_d = asdict(record)
                    if rec_d.get("version_spans") is None:
                        rec_d.pop("version_spans", None)
                    jsonl.append_record(self.lineage_path, rec_d)
                except OSError:
                    pass  # lineage is an audit trail, never a crash source

    def observe_reward(self, mean_reward: float, step: int = 0):
        """Offline (ILQL) feed: one reward-distribution observation per
        make_experience batch."""
        with self._lock:
            self.reward.observe(float(mean_reward) + self.reward_offset)

    # ------------------------------------------------------------ outputs

    def gauges(self) -> dict:
        """``health/*`` scalars for the Tracker merge and the exporter: each
        detector's state (0/1/2) + the quantity it judges, and the monotonic
        transition counter."""
        with self._lock:
            g = {
                f"health/{name}_state": float(_LEVEL[d.state])
                for name, d in self.detectors.items()
            }
            g["health/state_changes_total"] = float(
                sum(d.state_changes for d in self.detectors.values())
            )
            g["health/reward_drift_z"] = float(self.reward.z)
            g["health/kl_ratio"] = float(self.kl.ratio)
            g["health/kl_coef"] = float(self.kl.coef)
            g["health/entropy"] = float(self.entropy.value)
            g["health/explained_variance"] = float(self.value_ev.value)
            g["health/truncation_rate"] = float(self.rollout.trunc)
            g["health/degenerate_rate"] = float(self.rollout.degen)
            return g

    def status(self) -> str:
        with self._lock:
            worst = max(_LEVEL[d.state] for d in self.detectors.values())
        return {0: "ok", 1: "degraded", 2: "critical"}[worst]

    def healthz(self) -> dict:
        """JSON payload for the live ``/healthz`` endpoint."""
        status = self.status()
        with self._lock:
            detectors = {
                name: {
                    "state": d.state,
                    "last_severity": d.last_severity,
                    "state_changes": d.state_changes,
                    "observations": d.observations,
                }
                for name, d in self.detectors.items()
            }
        return {"status": status, "detectors": detectors}

    def maybe_log_lineage(self, tracker, step: int):
        """Flush a ``health/lineage_staleness`` histogram covering the chunks
        since the previous flush (no-op when no new chunks landed — keeps
        metrics.jsonl free of empty histogram spam)."""
        with self._lock:
            values, self._staleness_since_hist = self._staleness_since_hist, []
        if values:
            tracker.log_histogram("health/lineage_staleness", values, step=step)
