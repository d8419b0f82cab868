"""graftfleet in the port (``trlx_tpu_torch/observability/fleet.py``): twins of
``tests/test_fleet.py``, its report case included (the port's
``observability/report.py`` renders the same section from the same files as
the JAX package's, line for line).

The pure readers (``read_fleet_spans``, the per-collective skew table, the
arrival reader) take the same files as the JAX package's and must give the
same answers; the straggler detector's hysteresis, the single-process
monitor (a one-rank fleet), the guard's arrival hook, the rollup
watermark, the incident bundle, the exporter's ``/healthz`` block, and an
armed ``train()`` on one process end to end. The multi-rank join is held by
the engine drills of ``tests/test_torch_dist_engine.py``.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.observability import fleet as jax_fleet  # noqa: E402
from trlx_tpu.observability import spans as jax_spans  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.observability import fleet as obs_fleet  # noqa: E402
from trlx_tpu_torch.observability import spans as obs_spans  # noqa: E402
from trlx_tpu_torch.observability.export import MetricsExporter, sanitize_metric_name  # noqa: E402
from trlx_tpu_torch.resilience.distributed import collective_guard  # noqa: E402
from trlx_tpu_torch.utils import jsonl  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fleet_isolation():
    """The monitor and the tracer are process globals: disarm after each
    test so no test's files leak into the next."""
    yield
    obs_fleet.shutdown()
    obs_spans.shutdown()


def _write_host_spans(d, host, events):
    path = os.path.join(d, obs_spans.host_spans_filename(host))
    for e in events:
        jsonl.append_record(path, e)
    return path


def _clock_record(d, offsets_s, uncertainty_s=0.001, drift_s=0.0005, step=0):
    jsonl.append_record(os.path.join(d, obs_spans.FLEET_CLOCK_FILENAME),
                        {"offsets_s": offsets_s, "uncertainty_s": uncertainty_s, "drift_s": drift_s, "step": step})


def _write_arrivals(d, host, records):
    path = os.path.join(d, obs_fleet.host_collectives_filename(host))
    for r in records:
        jsonl.append_record(path, r)


def test_file_names_are_the_jax_packages():
    assert obs_spans.host_spans_filename(3) == jax_spans.host_spans_filename(3)
    assert obs_spans.FLEET_CLOCK_FILENAME == jax_spans.FLEET_CLOCK_FILENAME
    assert obs_spans.TID_STRIDE == jax_spans.TID_STRIDE
    assert obs_fleet.host_collectives_filename(2) == jax_fleet.host_collectives_filename(2)
    assert obs_fleet.SKEW_MS_BUCKETS == jax_fleet.SKEW_MS_BUCKETS
    assert obs_fleet.MAX_FLEET_BUNDLES == jax_fleet.MAX_FLEET_BUNDLES


# ----------------------------------------------------------- span federation


def test_read_fleet_spans_merges_host_lanes_with_clock_alignment(tmp_path):
    d = str(tmp_path)
    _write_host_spans(d, 0, [{"name": "train/step", "ph": "X", "ts": 1_000_000, "dur": 10, "pid": 9, "tid": 1},
                             {"name": "producer", "ph": "X", "ts": 1_000_050, "dur": 5, "pid": 9, "tid": 2}])
    _write_host_spans(d, 1, [{"name": "train/step", "ph": "X", "ts": 2_000_000, "dur": 10, "pid": 9, "tid": 1}])
    _clock_record(d, [0.0, 1.0], uncertainty_s=0.002, drift_s=0.001)  # rank 1's clock runs 1 s ahead
    merged = obs_spans.read_fleet_spans(d)
    assert merged == jax_spans.read_fleet_spans(d)
    assert merged["hosts"] == [0, 1] and merged["alignment_error_s"] == pytest.approx(0.003)
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    by_host = {h: [e for e in spans if e["pid"] == h] for h in (0, 1)}
    assert {e["tid"] for e in by_host[0]} == {1, 2}
    assert {e["tid"] for e in by_host[1]} == {obs_spans.TID_STRIDE + 1}
    assert by_host[1][0]["ts"] == 1_000_000 and by_host[0][0]["ts"] == 1_000_000
    lanes = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert "host0" in lanes[0] and "+1000.000ms" in lanes[1] and "3.000ms" in lanes[1]


def test_read_fleet_spans_tolerates_torn_tail_per_file(tmp_path):
    d = str(tmp_path)
    _write_host_spans(d, 0, [{"name": "a", "ph": "X", "ts": 1, "dur": 1, "tid": 1}])
    path1 = _write_host_spans(d, 1, [{"name": "b", "ph": "X", "ts": 2, "dur": 1, "tid": 1}])
    with open(path1, "a") as f:
        f.write('{"name": "torn')
    merged = obs_spans.read_fleet_spans(d)
    assert {e["name"] for e in merged["traceEvents"] if e.get("ph") == "X"} == {"a", "b"}
    assert merged["hosts"] == [0, 1]


def test_read_fleet_spans_falls_back_to_plain_spans_jsonl(tmp_path):
    d = str(tmp_path)
    jsonl.append_record(os.path.join(d, obs_spans.SPANS_FILENAME),
                        {"name": "solo", "ph": "X", "ts": 5, "dur": 1, "pid": 0, "tid": 7})
    merged = obs_spans.read_fleet_spans(d)
    [event] = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert event["tid"] == 7 and event["ts"] == 5
    assert merged["clock"] is None and merged["alignment_error_s"] == 0.0
    assert obs_spans.read_fleet_spans(str(tmp_path / "nope"))["traceEvents"] == []


# ----------------------------------------------------- straggler attribution


def test_collective_skew_table_names_the_laggard(tmp_path):
    d = str(tmp_path)
    rec0, rec1 = [], []
    for seq in range(10):
        t = 1000.0 + seq
        rec0.append({"site": "allgather_host", "seq": seq, "host": 0, "t0": t, "t1": t + 0.01})
        rec1.append({"site": "allgather_host", "seq": seq, "host": 1, "t0": t + 0.05, "t1": t + 0.06})  # 50 ms late
        rec0.append({"site": "barrier", "seq": seq, "host": 0, "t0": t, "t1": t + 0.001})
        rec1.append({"site": "barrier", "seq": seq, "host": 1, "t0": t + 0.002, "t1": t + 0.003})  # under the floor
    _write_arrivals(d, 0, rec0)
    _write_arrivals(d, 1, rec1)
    table = obs_fleet.collective_skew_table(d, offsets=[0.0, 0.0])
    assert table == jax_fleet.collective_skew_table(d, offsets=[0.0, 0.0])
    rows = {r["site"]: r for r in table}
    lag = rows["allgather_host"]
    assert lag["count"] == 10 and lag["worst_host"] == 1 and lag["worst_share"] == pytest.approx(1.0)
    assert lag["p50_ms"] == pytest.approx(50.0, abs=1.0) and lag["max_ms"] == pytest.approx(50.0, abs=1.0)
    assert rows["barrier"]["worst_host"] is None and rows["barrier"]["p50_ms"] == pytest.approx(2.0, abs=0.5)


def test_collective_skew_table_applies_clock_offsets(tmp_path):
    d = str(tmp_path)
    _write_arrivals(d, 0, [{"site": "s", "seq": 0, "host": 0, "t0": 10.0, "t1": 10.1}])
    _write_arrivals(d, 1, [{"site": "s", "seq": 0, "host": 1, "t0": 11.0, "t1": 11.1}])
    _clock_record(d, [0.0, 1.0])
    [row] = obs_fleet.collective_skew_table(d)
    assert row["max_ms"] == pytest.approx(0.0, abs=1e-6) and row["worst_host"] is None
    assert [row] == jax_fleet.collective_skew_table(d)


def test_read_collective_arrivals_tolerates_torn_and_garbage(tmp_path):
    d = str(tmp_path)
    _write_arrivals(d, 0, [{"site": "s", "seq": 0, "host": 0, "t0": 1.0, "t1": 2.0}])
    path = os.path.join(d, obs_fleet.host_collectives_filename(1))
    jsonl.append_record(path, {"site": "s", "seq": "not-an-int", "t0": 1, "t1": 2})
    with open(path, "a") as f:
        f.write('{"site": "s", "se')
    assert obs_fleet.read_collective_arrivals(d) == {("s", 0): {0: (1.0, 2.0)}}
    assert obs_fleet.read_collective_arrivals(d) == jax_fleet.read_collective_arrivals(d)


def test_fleet_straggler_detector_persistence_and_reset():
    def obs(host, share):
        return {"host": host, "share": share, "samples": 5}

    det = obs_fleet.FleetStragglerDetector(warn_streak=2, crit_streak=4)
    for host in (0, 1, 0, 1, 0, 1):  # a hiccup that moves between ranks never escalates
        assert det.observe(obs(host, 1.0)) == "ok"
    det, ref = (cls(warn_streak=2, crit_streak=4) for cls in (obs_fleet.FleetStragglerDetector,
                                                               jax_fleet.FleetStragglerDetector))
    assert det.observe(obs(1, 0.95)) == ref.observe(obs(1, 0.95)) == "ok"
    states = [det.observe(obs(1, 0.95)) for _ in range(5)]
    assert states == [ref.observe(obs(1, 0.95)) for _ in range(5)]
    assert states[1] == "warn" and states[-1] == "crit" and det.host == 1 and det.share == pytest.approx(0.95)
    det = obs_fleet.FleetStragglerDetector(min_samples=3)
    assert det.observe({"host": 1, "share": 1.0, "samples": 2}) == "ok"
    assert det.observe({"host": None, "share": 0.0, "samples": 0}) == "ok"


# ------------------------------------------------------------- FleetMonitor


def test_single_process_monitor_degrades_to_one_host_fleet(tmp_path):
    d = str(tmp_path)
    monitor = obs_fleet.configure(d, process_index=0, process_count=1)
    assert obs_fleet.armed() and obs_fleet.fleet() is monitor
    rec = monitor.clock_sync(step=0)
    assert rec["offsets_s"] == [0.0] and rec["hosts"] == 1
    assert obs_spans._last_clock_record(d)["offsets_s"] == [0.0]
    t = time.time()
    obs_fleet.collective_complete("allgather_host", t, t + 0.01)
    obs_fleet.collective_complete("allgather_host", t + 1, t + 1.01)
    arrivals = obs_fleet.read_collective_arrivals(d)
    assert set(arrivals) == {("allgather_host", 0), ("allgather_host", 1)}
    assert arrivals[("allgather_host", 0)][0] == (pytest.approx(t), pytest.approx(t + 0.01))
    gauges = monitor.on_log_boundary(step=3)
    assert gauges["fleet/hosts"] == 1.0 and gauges["fleet/straggler_state"] == 0.0
    assert gauges["fleet/collective_skew_ms_max"] == pytest.approx(0.0)
    block = monitor.health_block()
    assert block["hosts"] == 1 and block["desync"] == {"status": "unchecked"} and block["straggler"]["state"] == "ok"
    monitor.note_desync(3, ok=True)
    assert monitor.health_block()["desync"] == {"step": 3, "ok": True}


def test_disarmed_hooks_are_noops_and_write_no_files(tmp_path):
    obs_fleet.shutdown()
    assert not obs_fleet.armed()
    obs_fleet.collective_complete("x", 1.0, 2.0)
    assert obs_fleet.incident_bundle(0, "collective_timeout") is None
    with collective_guard("site", deadline=30.0, on_timeout=lambda e: None):
        pass
    assert os.listdir(str(tmp_path)) == []


def test_collective_guard_records_arrival_when_armed(tmp_path):
    obs_fleet.configure(str(tmp_path), process_index=0, process_count=1)
    with collective_guard("drill_site", deadline=30.0, on_timeout=lambda e: None):
        pass
    with collective_guard("drill_site", deadline=0.0, on_timeout=lambda e: None):  # a deadline-0 guard stamps too
        pass
    assert set(obs_fleet.read_collective_arrivals(str(tmp_path))) == {("drill_site", 0), ("drill_site", 1)}


def test_firing_guard_bundles_the_outer_sites_detail(tmp_path):
    """A guard that fires inside another (the schedule check's host
    all-gather) names the outer site, carries both details, and writes the
    fleet bundle before its handler runs."""
    from trlx_tpu_torch.resilience import distributed as dist_res

    # No trainer's step provider: an earlier test's trainer, not yet
    # collected, would name the bundle's step directory.
    dist_res.configure()
    d = str(tmp_path)
    obs_fleet.configure(d, process_index=0, process_count=2)
    _write_host_spans(d, 1, [{"name": "peer", "ph": "X", "ts": 1, "dur": 1, "tid": 1}])
    fired = []
    with collective_guard("engine/schedule_verify", deadline=30.0, detail=lambda: {"slot_states": [{"slot": 0}]}):
        inner = collective_guard("allgather_host", deadline=30.0, on_timeout=fired.append)
        with inner:
            inner._fire()
    assert len(fired) == 1 and "allgather_host" in str(fired[0])
    with open(os.path.join(d, "incidents", "0", "fleet_incident.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == "collective_timeout" and manifest["hosts"] == [0, 1]
    assert manifest["detail"]["collective"] == "engine/schedule_verify"
    assert manifest["detail"]["op"] == "allgather_host" and manifest["detail"]["slot_states"] == [{"slot": 0}]


def test_window_rollup_watermark_defers_incomplete_occurrences(tmp_path):
    d = str(tmp_path)
    monitor = obs_fleet.configure(d, process_index=0, process_count=2)
    base = 100.0
    _write_arrivals(d, 0, [{"site": "s", "seq": 0, "host": 0, "t0": base, "t1": base + 0.01},
                           {"site": "s", "seq": 1, "host": 0, "t0": base + 1, "t1": base + 1.01}])
    _write_arrivals(d, 1, [{"site": "s", "seq": 0, "host": 1, "t0": base + 0.05, "t1": base + 0.06}])
    gauges = monitor.on_log_boundary(step=1)
    assert gauges["fleet/collective_skew_ms_max"] == pytest.approx(50.0, abs=1.0)
    assert gauges["fleet/slowest_host"] == 1.0 and gauges["fleet/host1_worst_arrivals_total"] == 1.0
    _write_arrivals(d, 1, [{"site": "s", "seq": 1, "host": 1, "t0": base + 1.05, "t1": base + 1.06}])
    assert monitor.on_log_boundary(step=2)["fleet/host1_worst_arrivals_total"] == 2.0


def test_incident_bundle_collects_all_hosts_span_tails(tmp_path):
    d = str(tmp_path)
    monitor = obs_fleet.configure(d, process_index=0, process_count=2)
    _write_host_spans(d, 0, [{"name": "a", "ph": "X", "ts": 1, "dur": 1, "tid": 1}])
    _write_host_spans(d, 1, [{"name": "b", "ph": "X", "ts": 2, "dur": 1, "tid": 1}])
    monitor.note_fingerprint(7, np.asarray([7, 123, 456]))
    base = monitor.incident_bundle(7, "collective_timeout", detail={"collective": "s"})
    assert base == os.path.join(d, "incidents", "7")
    for host, name in ((0, "a"), (1, "b")):
        records = jsonl.read_jsonl(os.path.join(base, f"host{host}", "spans_tail.jsonl"))
        assert records and records[0]["name"] == name
    with open(os.path.join(base, "host0", "heartbeat.json")) as f:
        assert json.load(f)["last_fingerprint"]["step"] == 7
    with open(os.path.join(base, "fleet_incident.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == "collective_timeout" and manifest["hosts"] == [0, 1] and manifest["collected_by"] == 0
    for step in range(8, 8 + 2 * obs_fleet.MAX_FLEET_BUNDLES):
        monitor.incident_bundle(step, "collective_timeout")
    assert len(os.listdir(os.path.join(d, "incidents"))) == obs_fleet.MAX_FLEET_BUNDLES


def test_tail_whole_lines_trims_partial_first_line(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(json.dumps({"i": i, "pad": "x" * 100}) for i in range(50)) + "\n")
    tail = obs_fleet._tail_whole_lines(path, max_bytes=500)
    assert tail == jax_fleet._tail_whole_lines(path, max_bytes=500)
    parsed = [json.loads(ln) for ln in tail.decode().splitlines()]
    assert parsed and parsed[-1]["i"] == 49 and all(p["i"] > 40 for p in parsed)


# ---------------------------------------------------------- exporter pieces


def test_exporter_healthz_fleet_block(tmp_path):
    exporter = MetricsExporter(0)
    try:
        assert "fleet" not in exporter.render_healthz()
        monitor = obs_fleet.configure(str(tmp_path), process_index=0, process_count=1)
        monitor.on_log_boundary(step=5, exporter=exporter)
        payload = exporter.render_healthz()
        assert payload["fleet"]["hosts"] == 1 and payload["fleet"]["straggler"]["state"] == "ok"
        assert "clock" in payload["fleet"]
        assert sanitize_metric_name("trlx_tpu_fleet/hosts") + " 1.0" in exporter.render_metrics()
    finally:
        exporter.close()


# ------------------------------------------------------------ e2e (1 rank)


def _walk_config(tmp_path):
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps, config.train.epochs, config.train.batch_size = 6, 4, 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = str(tmp_path)
    config.train.fleet_resync_interval = 2
    config.method.num_rollouts = config.method.chunk_size = 16
    return config


@pytest.mark.parametrize("arm", ["env", "config"])
def test_e2e_single_process_armed_run_degrades_to_one_host_fleet(tmp_path, monkeypatch, arm):
    """graftfleet armed on ONE process (by ``TRLX_TPU_GRAFTFLEET`` or by
    ``train.graftfleet``): a rank-suffixed span file and no plain one, the
    clock history (start and every ``fleet_resync_interval`` steps, trivial
    offsets), the merged trace, and ``fleet/*`` gauges in metrics.jsonl;
    the monitor is disarmed when ``learn()`` ends."""
    _, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    config = _walk_config(tmp_path)
    if arm == "env":
        monkeypatch.setenv("TRLX_TPU_GRAFTFLEET", "1")
    else:
        config.train.graftfleet = True
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1]], metric_fn=metric_fn,
                         config=config, logit_mask=logit_mask, device="cpu")
    assert not obs_fleet.armed()
    d = str(tmp_path)
    assert os.path.exists(os.path.join(d, obs_spans.host_spans_filename(0)))
    assert not os.path.exists(os.path.join(d, obs_spans.SPANS_FILENAME))
    clock_records = jsonl.read_jsonl(os.path.join(d, obs_spans.FLEET_CLOCK_FILENAME))
    assert len(clock_records) >= 3 and all(r["offsets_s"] == [0.0] and r["hosts"] == 1 for r in clock_records)
    assert {r["step"] for r in clock_records} >= {0, 2, 4}
    merged = obs_spans.read_fleet_spans(d)
    assert merged["hosts"] == [0] and any(e.get("ph") == "X" for e in merged["traceEvents"])
    with open(os.path.join(d, "metrics.jsonl")) as f:
        fleet_rows = [r for r in map(json.loads, f) if "fleet/hosts" in r]
    assert fleet_rows and all(r["fleet/hosts"] == 1.0 and "fleet/straggler_state" in r for r in fleet_rows)


@pytest.mark.parametrize("switch", ["TRLX_TPU_GRAFTFLEET", "TRLX_TPU_ENGINE_SCHEDULE_SKEW"])
def test_ported_switches_are_accepted(tmp_path, monkeypatch, switch):
    """The two switches this slice ports are no longer refused: a trainer
    builds with each set (the skew acts only on a multi-process engine's
    schedule check)."""
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    monkeypatch.setenv(switch, "1")
    trainer = PPOTrainer(_walk_config(tmp_path), device="cpu")
    assert trainer._fleet is not None if switch == "TRLX_TPU_GRAFTFLEET" else trainer._fleet is None


def test_report_fleet_section_renders_artifacts(tmp_path):
    """The report's Fleet section: the actionable fallback when nothing is
    armed, then the merged-trace line, the clock offsets and the skew table
    naming the laggard; the same lines as the JAX package's section over the
    same files."""
    from trlx_tpu.observability.report import _fleet_section as jax_fleet_section
    from trlx_tpu_torch.observability.report import _fleet_section

    d = str(tmp_path)
    lines = _fleet_section(d)
    assert any("train.graftfleet off" in ln for ln in lines) and lines == jax_fleet_section(d)

    _write_host_spans(d, 0, [{"name": "a", "ph": "X", "ts": 1, "dur": 1, "tid": 1}])
    _write_host_spans(d, 1, [{"name": "b", "ph": "X", "ts": 2, "dur": 1, "tid": 1}])
    _clock_record(d, [0.0, 0.25])
    base = 50.0
    _write_arrivals(d, 0, [{"site": "s", "seq": 0, "host": 0, "t0": base, "t1": base + 0.1}])
    _write_arrivals(d, 1, [{"site": "s", "seq": 0, "host": 1, "t0": base + 0.3, "t1": base + 0.4}])
    lines = _fleet_section(d)
    text = "\n".join(lines)
    assert "clock-alignment error" in text
    assert "| s |" in text and "host 1" in text
    assert "host1 +250.000ms" in text
    assert lines == jax_fleet_section(d)
