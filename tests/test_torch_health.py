"""The port's training-health monitor and metrics endpoint
(``trlx_tpu_torch.observability.health`` and ``export``), twin of
``tests/test_health.py``.

- Unit tier, the JAX tests' bodies on the port's classes: the hysteresis
  machine, each detector's judgment, lineage records, the CRIT escalation
  through the emergency hook, the drill latches, metric-name sanitization
  and a live MetricsExporter scraped over HTTP.
- Exact equality with the JAX package (tolerance 0): the same seeded numpy
  streams through both packages' detectors and ``HealthMonitor`` give the
  same states, severities, transition counts and gauges, and
  ``truncation_rate`` / ``degenerate_rate`` the same values.
- Integration (CPU): an overlapped PPO run (``max_staleness: 1``) through
  ``trlx_tpu_torch.train`` with the health monitor and live exporter armed
  and the ``reward_drift`` drill walks OK -> WARN -> CRIT, escalates a
  ``health_reward_drift`` incident, serves the degraded ``/healthz`` and the
  ``health/*`` gauges DURING the run and leaves ``lineage.jsonl``; with the
  knobs off there is no monitor, endpoint or lineage; ILQL feeds its mean
  reward.
"""

import dataclasses
import json
import os
import socket
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.observability import health as jax_health  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.observability import anomaly as obs_anomaly  # noqa: E402
from trlx_tpu_torch.observability import spans as obs_spans  # noqa: E402
from trlx_tpu_torch.observability.export import (  # noqa: E402
    MetricsExporter,
    _VALID,
    sanitize_metric_name,
)
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: E402
from trlx_tpu_torch.observability.health import (  # noqa: E402
    CRIT,
    OK,
    WARN,
    EntropyCollapseDetector,
    ExplainedVarianceDetector,
    HealthMonitor,
    HysteresisDetector,
    KLHealthDetector,
    LineageRecord,
    MixedVersionDetector,
    RewardDriftDetector,
    RolloutSentinel,
    degenerate_rate,
    truncation_rate,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _emergency_isolation():
    """The emergency hook and the span tracer are process globals: disarm
    them after every test."""
    yield
    obs_spans.shutdown()
    obs_anomaly.register_emergency(None)


class _Direct(HysteresisDetector):
    """Severity passthrough: observe(0|1|2) exercises ONLY the state machine."""

    name = "direct"

    def severity(self, obs):
        return int(obs)


# ------------------------------------------------------------- hysteresis


def test_hysteresis_escalates_through_warn_with_streaks():
    d = _Direct(warn_streak=2, crit_streak=3)
    crits = []
    d.on_crit = lambda det, obs: crits.append((det.name, obs))
    assert d.observe(2) == OK  # streak 1 < warn_streak
    assert d.observe(2) == WARN  # streak 2: WARN, not CRIT — passes through
    assert d.observe(2) == CRIT  # crit streak 3
    assert d.state_changes == 2
    assert crits == [("direct", 2)]  # fired exactly once, on the transition
    assert d.observe(2) == CRIT  # steady state: no further transitions
    assert d.state_changes == 2 and len(crits) == 1


def test_hysteresis_single_bad_window_never_flips_state():
    d = _Direct(warn_streak=2, crit_streak=4)
    for sev in (1, 0, 2, 0, 1, 0):  # isolated spikes, never consecutive
        d.observe(sev)
    assert d.state == OK and d.state_changes == 0


def test_hysteresis_deescalates_one_level_per_clean_streak():
    d = _Direct(warn_streak=1, crit_streak=2, clear_streak=2)
    d.observe(2), d.observe(2)
    assert d.state == CRIT
    assert d.observe(0) == CRIT  # clean streak 1 < clear_streak
    assert d.observe(0) == WARN  # one level down...
    assert d.observe(0) == WARN  # ...and the next level costs a FULL streak
    assert d.observe(0) == OK
    assert d.state_changes == 4  # ok->warn->crit->warn->ok


def test_hysteresis_warn_resurgence_never_demotes_crit():
    d = _Direct(warn_streak=1, crit_streak=1, clear_streak=3)
    d.observe(2)
    assert d.state == CRIT
    for _ in range(5):  # sustained sev-1: bad streak says "WARN", state holds
        assert d.observe(1) == CRIT


def test_hysteresis_on_crit_exception_is_swallowed():
    d = _Direct(warn_streak=1, crit_streak=1)

    def boom(det, obs):
        raise RuntimeError("escalation must never take the loop down")

    d.on_crit = boom
    assert d.observe(2) == CRIT  # no raise


# --------------------------------------------------------------- detectors


def test_reward_drift_baseline_frozen_then_z_scored():
    d = RewardDriftDetector(warmup=3, warn_z=3.0, crit_z=6.0, warn_streak=1, crit_streak=2)
    for x in (1.0, 1.2, 0.8):  # warmup: builds the baseline, judges nothing
        assert d.severity(x) == 0
    assert d.severity(1.1) == 0  # in-distribution stays clean
    assert d.mu0 == pytest.approx(1.0) and d.sigma0 > 0
    assert d.severity(1000.0) == 2  # the drill's offset: z >> crit_z
    assert d.z > 6.0


def test_reward_drift_sigma_floor_absorbs_quiet_warmup():
    # identical warmup samples -> std 0; the 0.1*|mu| floor keeps ordinary
    # fluctuation around a mean of 10 from registering as drift
    d = RewardDriftDetector(warmup=2, recent_window=1)
    d.severity(10.0), d.severity(10.0)
    assert d.severity(11.0) == 0  # z = 1/1.0 with the floored sigma
    assert d.sigma0 == pytest.approx(1.0)


def test_kl_detector_ratio_bands_and_saturation():
    d = KLHealthDetector(warmup=0, warn_ratio=2.0, crit_ratio=4.0, sat_factor=10.0)
    base = {"target": 0.1, "coef": 0.05, "init_coef": 0.05}
    assert d.severity({**base, "kl": 0.1}) == 0  # on target
    assert d.severity({**base, "kl": 0.25}) == 1  # 2.5x above
    assert d.severity({**base, "kl": 0.5}) == 2  # 5x above
    assert d.severity({**base, "kl": 0.01}) == 1  # over-tight leash: WARN only
    # coefficient pinned 10x from init WARNs even with KL on target
    assert d.severity({"kl": 0.1, "target": 0.1, "coef": 0.5, "init_coef": 0.05}) == 1
    assert d.severity({"kl": 0.1, "target": 0.1, "coef": 0.005, "init_coef": 0.05}) == 1


def test_kl_detector_silent_without_adaptive_target():
    d = KLHealthDetector(warmup=0)
    assert d.severity({"kl": 99.0, "target": None, "coef": 1.0}) == 0
    assert d.severity({"kl": 99.0, "target": 0.0}) == 0  # fixed controller
    assert d.severity({"kl": None, "target": 0.1}) == 0


def test_kl_detector_warmup_exempts_early_kl():
    d = KLHealthDetector(warmup=2, warn_ratio=2.0)
    obs = {"kl": 1.0, "target": 0.1}  # 10x above target
    assert d.severity(obs) == 0 and d.severity(obs) == 0  # warmup
    assert d.severity(obs) == 2


def test_entropy_collapse_fractions_of_warmup_baseline():
    d = EntropyCollapseDetector(warmup=2, warn_frac=0.5, crit_frac=0.2)
    d.severity(2.0), d.severity(2.0)  # baseline mean 2.0
    assert d.severity(1.9) == 0
    assert d.severity(0.8) == 1  # < 0.5 * base
    assert d.severity(0.3) == 2  # < 0.2 * base
    zero = EntropyCollapseDetector(warmup=1)
    zero.severity(0.0)
    assert zero.severity(0.0) == 0  # degenerate baseline judges nothing


def test_explained_variance_negative_means_critic_worse_than_mean():
    d = ExplainedVarianceDetector(warmup=1, warn_ev=0.0, crit_ev=-0.5)
    assert d.severity(-5.0) == 0  # warmup: fresh value heads start here
    assert d.severity(0.4) == 0
    assert d.severity(-0.2) == 1
    assert d.severity(-0.9) == 2


def test_truncation_and_degenerate_rates():
    P, T = 2, 8
    mask = np.ones((4, T), dtype=np.int32)
    mask[0, 5:] = 0  # row 0: EOS inside the budget
    mask[1, 3:] = 0  # row 1: short response
    assert truncation_rate(mask, P) == pytest.approx(0.5)  # rows 2,3 fill it
    assert truncation_rate(np.ones((0, T), dtype=np.int32), P) == 0.0
    assert truncation_rate(mask, T) == 0.0  # no decode budget -> no signal

    loop = np.tile([7, 8, 9], 4)[: T - P]  # repeats its 3-gram
    fresh = np.arange(T - P) + 100
    tokens = np.zeros((3, T), dtype=np.int32)
    tokens[0, P:] = loop
    tokens[1, P:] = fresh
    tokens[2, P:] = fresh  # row 2 masked short: < 2n tokens counts clean
    m = np.ones((3, T), dtype=np.int32)
    m[2, P + 4 :] = 0
    assert degenerate_rate(tokens, m, P, n=3) == pytest.approx(1 / 3)


def test_rollout_sentinel_degeneracy_drives_crit():
    d = RolloutSentinel(warn_trunc=0.95, warn_degen=0.3, crit_degen=0.7)
    assert d.severity({"trunc": 0.5, "degen": 0.1}) == 0
    assert d.severity({"trunc": 1.0, "degen": 0.0}) == 1  # truncation wall
    assert d.severity({"trunc": 0.0, "degen": 0.4}) == 1
    assert d.severity({"trunc": 0.0, "degen": 0.9}) == 2


def test_mixed_version_detector_fraction_bands():
    """Token-granularity staleness watch (in-flight weight updates): the
    fraction of a batch's tokens NOT at its freshest version drives the
    severity — some mix is normal, a mostly-old batch is the problem."""
    d = MixedVersionDetector(warn_frac=0.5, crit_frac=0.9, warn_streak=1, crit_streak=2)
    assert d.severity({"mixed_tokens": 0.0, "total_tokens": 128.0}) == 0
    assert d.severity({"mixed_tokens": 40.0, "total_tokens": 128.0}) == 0
    assert d.severity({"mixed_tokens": 64.0, "total_tokens": 128.0}) == 1
    assert d.severity({"mixed_tokens": 120.0, "total_tokens": 128.0}) == 2
    assert d.frac == pytest.approx(120.0 / 128.0)
    # An empty window (no tokens consumed) is OK, not a zero-division.
    assert d.severity({"mixed_tokens": 0.0, "total_tokens": 0.0}) == 0
    # Through the hysteresis machine: a single mostly-old batch only WARNs
    # (crit needs a streak), sustained mix escalates.
    assert d.observe({"mixed_tokens": 127.0, "total_tokens": 128.0}) == WARN
    assert d.observe({"mixed_tokens": 127.0, "total_tokens": 128.0}) == CRIT


# ----------------------------------------------------- lineage + monitor


def test_lineage_record_roundtrip():
    r = LineageRecord(step=3, weight_version=2, staleness=1.0, rows=16,
                      truncation_rate=0.25, degenerate_rate=0.0,
                      mean_score=-1.5, time=123.0)
    assert LineageRecord.from_json(r.to_json()) == r
    # extra keys from a newer writer are ignored, not fatal
    line = json.dumps({**json.loads(r.to_json()), "future_field": 1})
    assert LineageRecord.from_json(line) == r


def test_lineage_record_version_spans_roundtrip_and_back_compat():
    """Span-form lineage (in-flight weight updates) round-trips; PRE-span
    lineage lines (no version_spans key) still load, defaulting to None —
    old lineage.jsonl files stay readable."""
    r = LineageRecord(step=9, weight_version=4, staleness=0.5, rows=8,
                      truncation_rate=0.0, degenerate_rate=0.0,
                      mean_score=2.0, time=9.0,
                      version_spans=[[3, 40], [4, 24]])
    got = LineageRecord.from_json(r.to_json())
    assert got == r and got.version_spans == [[3, 40], [4, 24]]
    old = {k: v for k, v in json.loads(r.to_json()).items() if k != "version_spans"}
    loaded = LineageRecord.from_json(json.dumps(old))
    assert loaded.version_spans is None
    assert loaded.weight_version == 4


def test_monitor_observe_chunk_writes_lineage_and_sentinels(tmp_path):
    path = str(tmp_path / "lineage.jsonl")
    m = HealthMonitor(warmup=1, lineage_path=path)
    tokens = np.zeros((4, 6), dtype=np.int32)
    mask = np.ones((4, 6), dtype=np.int32)
    for step in range(2):
        m.observe_chunk(tokens, mask, 2, scores=[1.0, 2.0, 3.0, 2.0],
                        weight_version=step, staleness=1, step=step)
    with open(path) as f:
        records = [LineageRecord.from_json(line) for line in f]
    assert [r.weight_version for r in records] == [0, 1]
    assert records[0].mean_score == pytest.approx(2.0)
    assert records[0].rows == 4 and records[0].staleness == 1.0
    g = m.gauges()
    assert g["health/truncation_rate"] == 1.0  # all-ones mask: budget filled
    assert g["health/reward_drift_state"] == 0.0


def test_monitor_crit_escalates_through_emergency_hook():
    captured = []

    class FakeCapture:
        def capture(self, step, reason, detail=None):
            captured.append((step, reason, detail))

    obs_anomaly.register_emergency(FakeCapture(), step_provider=lambda: 7)
    m = HealthMonitor(warmup=1, warn_streak=1, crit_streak=2)
    m.observe_reward(1.0)  # baseline
    m.observe_reward(1000.0)  # WARN
    assert m.status() == "degraded"
    m.observe_reward(1000.0)  # CRIT -> incident
    assert m.status() == "critical"
    assert len(captured) == 1
    step, reason, detail = captured[0]
    assert step == 7 and reason == "health_reward_drift"
    assert detail["detector"] == "reward_drift" and detail["severity"] == 2
    hz = m.healthz()
    assert hz["status"] == "critical"
    assert hz["detectors"]["reward_drift"]["state"] == CRIT
    assert hz["detectors"]["reward_drift"]["state_changes"] == 2


def test_monitor_drill_latches_shift_observed_stats_only(monkeypatch):
    monkeypatch.setenv("TRLX_TPU_REWARD_DRIFT_DELTA", "50")
    monkeypatch.setenv("TRLX_TPU_ENTROPY_COLLAPSE_SCALE", "0.5")
    m = HealthMonitor(warmup=1)
    m.inject_reward_drift()
    m.inject_entropy_collapse()
    assert m.reward_offset == 50.0 and m.entropy_scale == 0.5
    m.observe_reward(1.0)
    assert m.reward._baseline == [51.0]  # offset applied at the observation
    m.observe_train({"mean_entropy": 2.0}, step=0)
    assert m.entropy._baseline == [1.0]


def test_monitor_drift_offset_keyed_by_reward_call():
    """The drill fires on the score-worker thread while EARLIER calls'
    observations are still in flight — keying by call index keeps those
    baseline observations clean no matter the thread interleaving."""
    m = HealthMonitor(warmup=1)
    m.inject_reward_drift(from_call=2)
    assert m._reward_offset_for(1) == 0.0  # pre-drill call: clean baseline
    assert m._reward_offset_for(2) == m.reward_offset
    assert m._reward_offset_for(3) == m.reward_offset
    assert m._reward_offset_for(None) == m.reward_offset  # unknown: drifted
    tokens = np.zeros((2, 4), dtype=np.int32)
    mask = np.ones((2, 4), dtype=np.int32)
    m.observe_chunk(tokens, mask, 1, scores=[1.0, 1.0], weight_version=0,
                    staleness=0, step=0, reward_call=1)
    m.observe_chunk(tokens, mask, 1, scores=[1.0, 1.0], weight_version=0,
                    staleness=0, step=0, reward_call=2)
    assert [r.mean_score for r in m.lineage] == [1.0, 1001.0]


def test_monitor_gauges_and_state_change_counter_are_monotonic():
    m = HealthMonitor(warmup=1, warn_streak=1, crit_streak=2)
    totals = []
    for x in (1.0, 999.0, 999.0, 999.0):
        m.observe_reward(x)
        totals.append(m.gauges()["health/state_changes_total"])
    assert totals == sorted(totals) and totals[-1] == 2.0
    g = m.gauges()
    assert g["health/reward_drift_state"] == 2.0
    for key in g:
        assert _VALID.match(sanitize_metric_name("trlx_tpu_" + key)), key


# ---------------------------------------------------------------- exporter


def test_sanitize_metric_name_makes_every_key_legal():
    cases = {
        "health/reward_drift_state": "health_reward_drift_state",
        "time/overlap-fraction": "time_overlap_fraction",
        "obs/train_mfu_pct": "obs_train_mfu_pct",
        "9starts_with_digit": "_9starts_with_digit",
        "weird key.v2": "weird_key_v2",
        "": "_",
    }
    for key, expected in cases.items():
        got = sanitize_metric_name(key)
        assert got == expected and _VALID.match(got), key


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.headers.get("Content-Type"), r.read().decode()


def test_exporter_serves_prometheus_text_and_healthz():
    ex = MetricsExporter(port=0)  # ephemeral port: parallel-safe tests
    try:
        ex.update(
            {"health/reward_drift_state": 2.0,
             "health/state_changes_total": 3.0,
             "time/overlap_fraction": float("nan"),
             "loss": float("inf"),
             "note": "dropped — not numeric"},
            step=7,
            health={"status": "critical", "detectors": {}},
        )
        ctype, body = _get(ex.port, "/metrics")
        assert ctype.startswith("text/plain") and "version=0.0.4" in ctype
        assert "# TYPE trlx_tpu_health_reward_drift_state gauge" in body
        assert "trlx_tpu_health_reward_drift_state 2.0" in body
        assert "# TYPE trlx_tpu_health_state_changes_total counter" in body
        assert "trlx_tpu_time_overlap_fraction NaN" in body
        assert "trlx_tpu_loss +Inf" in body
        assert "trlx_tpu_last_step 7" in body
        assert "note" not in body
        # text-format conformance: every sample line's name is legal and has
        # exactly one HELP + one TYPE line above it
        samples = [ln for ln in body.splitlines() if ln and not ln.startswith("#")]
        for line in samples:
            assert _VALID.match(line.split()[0]), line
        names = [ln.split()[0] for ln in samples]
        assert len(names) == len(set(names))  # no duplicate metric names

        ctype, body = _get(ex.port, "/healthz")
        payload = json.loads(body)
        assert ctype == "application/json"
        assert payload["status"] == "critical" and payload["step"] == 7

        with pytest.raises(urllib.error.HTTPError) as err:
            _get(ex.port, "/nope")
        assert err.value.code == 404
    finally:
        ex.close()


def test_exporter_update_merges_and_collisions_keep_last_writer():
    ex = MetricsExporter(port=0)
    try:
        ex.update({"a/b": 1.0})
        ex.update({"c": 2.0})  # different cadence: both survive the merge
        _, body = _get(ex.port, "/metrics")
        assert "trlx_tpu_a_b 1.0" in body and "trlx_tpu_c 2.0" in body
        ex.update({"a_b": 9.0})  # sanitizes to the same name as a/b
        _, body = _get(ex.port, "/metrics")
        samples = [ln for ln in body.splitlines()
                   if ln.startswith("trlx_tpu_a_b ")]
        assert samples == ["trlx_tpu_a_b 9.0"]  # never a duplicate exposition
    finally:
        ex.close()


def test_exporter_histogram_exposition_cumulative_with_labels():
    """Distribution feeds render as conformant Prometheus histograms:
    cumulative buckets, an explicit +Inf bucket, _sum/_count, labels
    splitting series under one metric name, NaN samples dropped."""
    ex = MetricsExporter(port=0)
    try:
        ex.observe("obs/lane_gap_s", [0.004, 0.004, 0.8, float("nan")],
                   buckets=(0.005, 0.1, 1.0), labels={"lane": "score"})
        ex.observe("obs/lane_gap_s", [2.5], buckets=(0.005, 0.1, 1.0),
                   labels={"lane": "producer"})
        ex.observe("engine/refill_wait_ms", [3.0, 40.0], buckets=(5.0, 50.0))
        ex.observe("engine/refill_wait_ms", [4.0], buckets=(5.0, 50.0))  # folds
        _, body = _get(ex.port, "/metrics")
        assert "# TYPE trlx_tpu_obs_lane_gap_s histogram" in body
        assert 'trlx_tpu_obs_lane_gap_s_bucket{lane="score",le="0.005"} 2' in body
        assert 'trlx_tpu_obs_lane_gap_s_bucket{lane="score",le="1.0"} 3' in body
        assert 'trlx_tpu_obs_lane_gap_s_bucket{lane="score",le="+Inf"} 3' in body
        assert 'trlx_tpu_obs_lane_gap_s_count{lane="score"} 3' in body  # NaN gone
        assert 'trlx_tpu_obs_lane_gap_s_bucket{lane="producer",le="1.0"} 0' in body
        assert 'trlx_tpu_obs_lane_gap_s_bucket{lane="producer",le="+Inf"} 1' in body
        assert 'trlx_tpu_engine_refill_wait_ms_bucket{le="5.0"} 2' in body
        assert 'trlx_tpu_engine_refill_wait_ms_bucket{le="+Inf"} 3' in body
        assert "trlx_tpu_engine_refill_wait_ms_sum 47.0" in body
        assert "trlx_tpu_engine_refill_wait_ms_count 3" in body
        # every non-comment line still carries a legal metric name
        for line in body.splitlines():
            if line and not line.startswith("#"):
                assert _VALID.match(line.split("{")[0].split()[0]), line
    finally:
        ex.close()


# ------------------------------------------------------------ e2e acceptance


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]



# ------------------------------------------------ exact equality with JAX


def _streams(rng, n):
    """Seeded observation streams with quiet stretches, spikes and dips."""
    base = rng.normal(0.0, 1.0, size=n).cumsum() * 0.1 + 1.0
    spikes = rng.uniform(size=n) < 0.15
    return np.where(spikes, base * rng.uniform(-20, 20, size=n), base)


def _detector_cases(rng):
    streaks = dict(warn_streak=int(rng.integers(1, 4)), crit_streak=int(rng.integers(1, 5)),
                   clear_streak=int(rng.integers(1, 4)))
    warm = int(rng.integers(1, 6))
    return [
        ("RewardDriftDetector", dict(warmup=warm, warn_z=float(rng.uniform(1, 4)), crit_z=float(rng.uniform(4, 8)),
                                     recent_window=int(rng.integers(1, 6)), **streaks), "scalar"),
        ("EntropyCollapseDetector", dict(warmup=warm, **streaks), "scalar"),
        ("ExplainedVarianceDetector", dict(warmup=warm, **streaks), "scalar"),
        ("KLHealthDetector", dict(warmup=warm, **streaks), "kl"),
        ("RolloutSentinel", dict(**streaks), "rollout"),
        ("MixedVersionDetector", dict(**streaks), "mixed"),
    ]


@pytest.mark.parametrize("seed", range(5))
def test_detectors_equal_jax_exactly(seed):
    """Each detector kind, seeded parameters and a seeded stream: states,
    severities, transition counts and judged quantities equal the JAX
    detector's at every observation."""
    from trlx_tpu_torch.observability import health as port_health

    rng = np.random.default_rng(seed)
    for cls_name, kw, kind in _detector_cases(rng):
        port, ref = getattr(port_health, cls_name)(**kw), getattr(jax_health, cls_name)(**kw)
        xs = _streams(rng, 120)
        for i, x in enumerate(xs):
            if kind == "scalar":
                obs = float(x)
            elif kind == "kl":
                obs = {"kl": abs(float(x)), "target": [None, 1.0, 6.0][i % 3], "coef": abs(float(x)) * 0.1,
                       "init_coef": 0.2}
            elif kind == "rollout":
                obs = {"trunc": float(rng.uniform()), "degen": float(rng.uniform())}
            else:
                obs = {"mixed_tokens": float(rng.integers(0, 50)), "total_tokens": float(rng.integers(0, 50))}
            assert port.observe(obs) == ref.observe(obs), (cls_name, i)
            for attr in ("state", "state_changes", "last_severity", "observations", "_bad", "_crit", "_clean"):
                assert getattr(port, attr) == getattr(ref, attr), (cls_name, i, attr)
            for attr in ("z", "ratio", "coef", "value", "trunc", "degen", "frac"):
                if hasattr(ref, attr):
                    assert getattr(port, attr) == getattr(ref, attr), (cls_name, i, attr)


@pytest.mark.parametrize("seed", range(4))
def test_rates_equal_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        b, t, p = int(rng.integers(0, 9)), int(rng.integers(2, 24)), int(rng.integers(0, 6))
        tokens = rng.integers(0, int(rng.integers(2, 9)), size=(b, t)).astype(np.int32)
        lengths = rng.integers(0, t + 1, size=b)
        mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
        n = int(rng.integers(1, 4))
        assert truncation_rate(mask, p) == jax_health.truncation_rate(mask, p)
        assert degenerate_rate(tokens, mask, p, n=n) == jax_health.degenerate_rate(tokens, mask, p, n=n)


@pytest.mark.parametrize("seed", range(3))
def test_monitor_gauges_and_healthz_equal_jax_exactly(seed, monkeypatch):
    """Both HealthMonitors fed the same seeded chunks, train stats and
    drills: gauges, healthz and lineage records equal at every step."""
    monkeypatch.setenv("TRLX_TPU_REWARD_DRIFT_DELTA", "25")
    rng = np.random.default_rng(seed)
    kw = dict(warmup=int(rng.integers(1, 4)), warn_streak=int(rng.integers(1, 3)), crit_streak=int(rng.integers(1, 4)))
    port, ref = HealthMonitor(**kw), jax_health.HealthMonitor(**kw)
    for step in range(40):
        if step == 15:
            for m in (port, ref):
                m.inject_reward_drift(from_call=17)
        if step == 25:
            for m in (port, ref):
                m.inject_entropy_collapse()
        tokens = rng.integers(0, 5, size=(4, 12)).astype(np.int32)
        mask = (np.arange(12)[None, :] < rng.integers(3, 13, size=4)[:, None]).astype(np.int32)
        scores = rng.normal(1.0, 0.5, size=4)
        stats = {"mean_entropy": float(rng.uniform(0.5, 2.0)), "explained_variance": float(rng.uniform(-1, 1)),
                 "mean_kl": float(rng.uniform(0, 3))}
        for m in (port, ref):
            m.observe_chunk(tokens, mask, 2, scores=scores, weight_version=step, staleness=step % 2, step=step,
                            reward_call=step)
            m.observe_train(stats, step, kl_coef=0.2 + step * 0.01, kl_target=1.0, kl_init_coef=0.2)
        assert port.gauges() == ref.gauges(), step
        assert port.healthz() == ref.healthz(), step
        a, b = dataclasses.asdict(port.lineage[-1]), dataclasses.asdict(ref.lineage[-1])
        a.pop("time"), b.pop("time")
        assert a == b, step


# ------------------------------------------------------------ e2e acceptance


def _walk_config(ckpt_dir, **train):
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = 8
    config.train.epochs = 4
    config.train.batch_size = 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = str(ckpt_dir)
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    for k, v in train.items():
        setattr(config.train, k, v)
    return config


PROMPTS = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]


def test_e2e_reward_drift_drill_trips_crit_incident_and_live_endpoint(tmp_path, monkeypatch):
    """Overlapped PPO (max_staleness 1) with the health monitor and the live
    exporter armed and the reward_drift drill latched from reward call 2:
    chunk_size 8 gives two reward calls a store, so the walk is a clean
    baseline (warmup 1) -> WARN (warn_streak 1) -> CRIT (crit_streak 2),
    early enough that the endpoint serves the degraded state for most of
    the run."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "reward_drift@2")
    port = _free_port()
    _, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    config = _walk_config(tmp_path, health_monitor=True, health_warmup=1, health_warn_streak=1,
                          health_crit_streak=2, metrics_port=port)
    config.method.chunk_size = 8
    config.method.max_staleness = 1

    # Scraped from inside the run (the final evaluate(), before learn()'s
    # teardown closes the endpoint), so no timing decides what is seen.
    scraped = {"metrics": "", "statuses": set(), "n": 0}
    orig_evaluate = PPOTrainer.evaluate

    def evaluate(self):
        _, scraped["metrics"] = _get(port, "/metrics")
        scraped["statuses"].add(json.loads(_get(port, "/healthz")[1])["status"])
        scraped["n"] += 1
        return orig_evaluate(self)

    monkeypatch.setattr(PPOTrainer, "evaluate", evaluate)
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=[[1]], metric_fn=metric_fn,
                                 config=config, logit_mask=logit_mask, device="cpu")
    assert model.iter_count >= 8
    assert not any(t.name.startswith("trlx-") for t in threading.enumerate())

    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    states = [r["health/reward_drift_state"] for r in records if "health/reward_drift_state" in r]
    assert states and max(states) == 2.0, states
    changes = [r["health/state_changes_total"] for r in records if "health/state_changes_total" in r]
    assert changes == sorted(changes) and changes[-1] >= 2.0
    hists = [r for r in records if r.get("histogram") == "health/lineage_staleness"]
    assert hists and hists[-1]["count"] > 0
    # The phase-window records carry the gauges too.
    assert any("time/overlap_fraction" in r and "health/reward_drift_state" in r for r in records)

    incidents_dir = os.path.join(str(tmp_path), "incidents")
    reasons = {}
    for b in os.listdir(incidents_dir):
        with open(os.path.join(incidents_dir, b, "incident.json")) as f:
            reasons[json.load(f)["reason"]] = b
    assert "health_reward_drift" in reasons, reasons
    with open(os.path.join(incidents_dir, reasons["health_reward_drift"], "incident.json")) as f:
        manifest = json.load(f)
    assert manifest["detail"]["detector"] == "reward_drift"
    assert manifest["sections"]["threads"] == "ok" and manifest["sections"]["memory"] == "ok"

    assert scraped["n"] > 0, "never scraped the live endpoint"
    assert "# TYPE trlx_tpu_health_reward_drift_state gauge" in scraped["metrics"]
    assert "# TYPE trlx_tpu_health_state_changes_total counter" in scraped["metrics"]
    assert scraped["statuses"] & {"degraded", "critical"}, scraped["statuses"]

    with open(os.path.join(str(tmp_path), "lineage.jsonl")) as f:
        lineage = [LineageRecord.from_json(line) for line in f]
    assert lineage and all(r.rows == 8 for r in lineage)
    assert {r.staleness for r in lineage} <= {0.0, 1.0}
    assert lineage[1].mean_score - lineage[0].mean_score > 500  # the drill's offset from call 2 on


def test_engine_chunks_feed_lineage_with_version_spans(tmp_path):
    """The engine path feeds the monitor too: one lineage record a chunk,
    its weight version the store's, its version spans summing to the
    chunk's decode steps."""
    _, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    config = _walk_config(tmp_path, health_monitor=True, total_steps=8, epochs=2)
    config.method.rollout_engine = True
    config.method.chunk_size = 8
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=[[1]], metric_fn=metric_fn,
                                 config=config, logit_mask=logit_mask, device="cpu")
    with open(os.path.join(str(tmp_path), "lineage.jsonl")) as f:
        lineage = [json.loads(line) for line in f]
    assert len(lineage) == 4 and all(r["rows"] == 8 for r in lineage)
    assert [r["weight_version"] for r in lineage] == [0, 0, 4, 4]
    for r in lineage:
        assert [v for v, _ in r["version_spans"]] == [r["weight_version"]]
    assert model._health.gauges()["health/rollout_state"] in (0.0, 1.0, 2.0)


def test_health_off_means_no_monitor_no_endpoint_no_lineage(tmp_path):
    _, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    config = _walk_config(tmp_path, total_steps=2, epochs=1)
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=[[1]], metric_fn=metric_fn,
                                 config=config, logit_mask=logit_mask, device="cpu")
    assert model._health is None and model._metrics_exporter is None and model._incidents is None
    assert not os.path.exists(os.path.join(str(tmp_path), "lineage.jsonl"))
    assert not os.path.exists(os.path.join(str(tmp_path), "incidents"))
    assert not any(t.name == "trlx-metrics-exporter" for t in threading.enumerate())
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        assert not any("health/" in line for line in f)


def test_ilql_feeds_its_mean_reward(tmp_path, monkeypatch):
    """ILQL's offline orchestrator gives the monitor one reward observation
    per experience batch (the raw rewards' mean)."""
    from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    arch = dict(vocab_size=31, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
                eos_token_id=0, extra={"lm_head_bias": True})
    config = TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ilql", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32"),
        "train": dict(total_steps=2, seq_length=12, epochs=1, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                      weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                      checkpoint_dir=str(tmp_path), orchestrator="OfflineOrchestrator", health_monitor=True,
                      health_warmup=1),
        "method": dict(name="ilqlconfig", gen_kwargs=dict(prompt_length=5, max_new_tokens=6)),
    })
    trainer = ILQLTrainer(config, device="cpu")
    rng = np.random.default_rng(3)
    samples = [rng.integers(1, 31, size=int(rng.integers(3, 12))).astype(np.int32) for _ in range(16)]
    rewards = rng.normal(size=16)
    OfflineOrchestrator(trainer).make_experience(samples, rewards)
    assert trainer._health.reward.observations == 1
    assert trainer._health.reward._baseline == [pytest.approx(float(np.mean(rewards.astype(np.float32))))]
