"""Device telemetry in the port (``trlx_tpu_torch.observability.devicemon``),
the report (``observability.report``) and the profiling knobs, against the
JAX package, on the CPU.

Twins of ``tests/test_observability.py``'s devicemon cases: the peak
override, the MFU arithmetic from counted FLOPs (and the FLOPs the port
counts for ``x @ x`` equal to XLA's ``cost_analysis`` of the same product),
the proxy's attribute delegation and a counting failure recorded while the
call goes through, the routing and memory gauges' keys, the single-process
rollup, and the overlapped end-to-end run with spans, telemetry, the
``slow_step`` incident and the report (its markdown file and its trace).
Twins of ``tests/test_protocol.py``'s ``watch_interval`` case and
``tests/test_e2e.py``'s ``profile_dir`` case. Beyond the twins: the
monitor's signatures walk batch dataclasses, a graph replay made inside a
counted dispatch is charged its capture's FLOPs, the kernel wrappers'
reckoned costs reach a counting dispatch only, and every ``num/*``,
``obs/*`` and ``watch/*`` key a telemetry run logs is finite.
"""

import contextlib
import dataclasses
import json
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.observability import anomaly as obs_anomaly  # noqa: E402
from trlx_tpu_torch.observability import devicemon, report  # noqa: E402
from trlx_tpu_torch.observability import graftscope as obs_graftscope  # noqa: E402
from trlx_tpu_torch.observability import spans as obs_spans  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolation():
    yield
    obs_spans.shutdown()
    obs_graftscope.shutdown()
    obs_anomaly.register_emergency(None)


# ---------------------------------------------------------------- devicemon


def test_peak_flops_env_override_and_unknown_device(monkeypatch):
    monkeypatch.setenv("TRLX_TPU_PEAK_TFLOPS", "0.5")
    assert devicemon.detect_peak_flops() == pytest.approx(0.5e12)
    monkeypatch.delenv("TRLX_TPU_PEAK_TFLOPS")
    assert devicemon.detect_peak_flops() is None  # the CPU: no MFU gauge
    assert devicemon.PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.0}


def test_device_monitor_capture_dispatch_accounting_and_mfu():
    """The MFU gauge equals 100 * flops / seconds / peak from the FLOPs the
    first dispatch counted (rel 2%, the JAX test's), and ``x @ x`` counts
    the FLOPs XLA's ``cost_analysis`` gives the same product."""
    import jax
    import jax.numpy as jnp

    peak = 1e9
    mon = devicemon.DeviceMonitor(peak_flops=peak)
    step = mon.wrap("train/step", lambda x: x @ x, phase="train")
    x = torch.ones((64, 64))
    for _ in range(3):
        step(x)
    prog = mon.snapshot()["train/step"]
    assert prog["phase"] == "train" and prog["dispatches"] == 3
    assert len(prog["variants"]) == 1
    flops = prog["variants"][0]["flops"]
    cost = jax.jit(lambda a: a @ a).lower(jnp.ones((64, 64), jnp.float32)).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    assert flops == float(cost["flops"]) == 2 * 64 ** 3

    train_s = 2.0
    stats = mon.window({"train": train_s, "wall": train_s})
    expected = 100.0 * (3 * flops) / train_s / peak
    assert stats["obs/train_mfu_pct"] == pytest.approx(expected, rel=0.02)
    assert stats["obs/iter_mfu_pct"] == pytest.approx(expected, rel=0.02)
    assert stats["obs/train_tflops_per_chip"] == pytest.approx(3 * flops / train_s / 1e12, rel=0.02)
    assert mon.window({"train": 1.0, "wall": 1.0}) == {}  # drained
    step(torch.ones((32, 32)))  # a new shape: a second counted signature
    assert len(mon.snapshot()["train/step"]["variants"]) == 2


def test_monitored_fn_delegates_attributes_and_survives_counting_failure(monkeypatch):
    mon = devicemon.DeviceMonitor(peak_flops=None)

    def fn(x):
        return x @ x + 1

    fn.num_traces = 7
    wrapped = mon.wrap("rollout/generate", fn, phase="rollout")
    assert wrapped.num_traces == 7

    def broken(*a, **k):
        raise RuntimeError("no formula")

    monkeypatch.setitem(devicemon.flop_registry, torch.ops.aten.mm, broken)
    out = wrapped(torch.ones((2, 2)))  # the call goes through
    assert torch.equal(out, torch.full((2, 2), 3.0))
    variant = mon.snapshot()["rollout/generate"]["variants"][0]
    assert variant["flops"] == 0.0 and "no formula" in variant["error"]

    def raises(x):
        raise ValueError("the dispatch's own error")

    with pytest.raises(ValueError, match="own error"):
        mon.wrap("train/step", raises)(torch.ones(1))


def test_routing_and_memory_gauges_have_stable_keys():
    routing = devicemon.kernel_routing_gauges()
    assert set(routing) == {f"obs/{f}_{s}" for f in ("decode_attn", "fused_logprob", "flash_attn", "w8a16")
                            for s in ("active", "fallback")}
    assert all(v in (0.0, 1.0) for v in routing.values())
    assert all(routing[k] == 0.0 for k in routing if k.endswith("_fallback"))  # no fallback exists
    a = torch.zeros((256, 1024))
    memory = devicemon.device_memory_gauges(tensors=[a, a[:10], torch.zeros(256)])
    assert set(memory) == {"obs/live_array_gib"}
    assert memory["obs/live_array_gib"] == pytest.approx((256 * 1024 + 256) * 4 / 2**30)  # storages once each


def test_rollup_is_identity_valued_on_single_process():
    stats = {"obs/train_mfu_pct": 12.5, "time/train_s": 3.0, "skip_me": "str"}
    assert report.rollup_window_stats(stats) == {
        "obs/train_mfu_pct/hostmean": 12.5, "obs/train_mfu_pct/hostmax": 12.5,
        "time/train_s/hostmean": 3.0, "time/train_s/hostmax": 3.0,
    }
    assert report.rollup_window_stats({}) == {}


def test_signature_walks_batches_and_graph_replays_are_charged():
    """A batch dataclass's tensors make the signature; a ``StepGraph``
    replayed inside a counted dispatch reports the FLOPs its capture
    counted (the capture itself is not charged)."""
    from trlx_tpu_torch.data import PPORLBatch
    from trlx_tpu_torch.ops.cuda_graph import StepGraph

    fields = {f: torch.zeros((2, 3)) for f in PPORLBatch.__dataclass_fields__}
    sig = devicemon._signature((PPORLBatch(**fields),), {})
    assert sig == tuple(((2, 3), "torch.float32") for _ in fields)

    class FakeGraph:
        """A stand-in for ``CudaGraph`` on the CPU: its capture is a stream
        under capture as far as the counting sees."""

        @contextlib.contextmanager
        def capture(self):
            real = devicemon._capturing
            devicemon._capturing = lambda: True
            try:
                yield
            finally:
                devicemon._capturing = real

        def replay(self):
            pass

    a = torch.ones((8, 8))
    with devicemon.FlopCount() as mode:
        graph = StepGraph(lambda: a @ a, FakeGraph())
    assert graph.flops == 2 * 8 ** 3 and mode.captured_flops == graph.flops and mode.total_flops == 0
    with devicemon.FlopCount() as mode:
        for _ in range(3):
            graph.replay()
    assert mode.kernel_flops == 3 * graph.flops
    outside = StepGraph(lambda: a @ a, FakeGraph())
    assert outside.flops is None  # built outside a counted dispatch


def test_kernel_costs_reach_a_counting_dispatch_only():
    """The wrappers' reckoned cost (``cuda_lib.count_launch(cost=...)``) is
    evaluated only while a dispatch is counted."""
    from trlx_tpu_torch.ops import cuda_lib
    from trlx_tpu_torch.ops.flash_attention import reachable, reachable_pairs

    def fake():
        pass

    fake.launches = 0
    calls = []

    def cost():
        calls.append(1)
        return 100.0, 8.0

    cuda_lib.count_launch(fake, cost=cost)
    assert calls == [] and fake.launches == 1
    with devicemon.FlopCount() as mode:
        cuda_lib.count_launch(fake, cost=cost)
    assert calls == [1] and mode.kernel_flops == 100.0 and mode.kernel_bytes == 8.0 and fake.launches == 2
    for kw in (dict(), dict(window=5), dict(causal=False), dict(offset=3), dict(offset=-4, window=6)):
        assert reachable_pairs(12, 12, **kw) == int(reachable(12, 12, "cpu", **kw).sum()), kw


# ------------------------------------------------------------ e2e acceptance


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


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


def _train(task, config):
    _, logit_mask, metric_fn, reward_fn = task
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1]], metric_fn=metric_fn,
                                config=config, logit_mask=logit_mask, device="cpu")


def _records(d):
    with open(os.path.join(str(d), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_e2e_overlapped_run_spans_telemetry_incident_report(task, tmp_path, monkeypatch):
    """Overlapped PPO (max_staleness=1) with spans, telemetry and the anomaly
    detector armed, and the slow_step drill: MFU and routing gauges in
    metrics.jsonl, programs.json, the incident bundle, and a report with
    every section (written by learn(); main() writes it and its trace)."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "slow_step@6")
    monkeypatch.setenv("TRLX_TPU_SLOW_STEP_SECONDS", "1.5")
    monkeypatch.setenv("TRLX_TPU_PEAK_TFLOPS", "0.01")
    config = _walk_config(tmp_path, trace_spans=True, device_telemetry=True, anomaly_factor=3.0)
    config.method.max_staleness = 1
    _train(task, config)
    assert not any(t.name.startswith("trlx-") for t in threading.enumerate())

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        events = obs_spans.read_spans(os.path.join(str(tmp_path), "spans.jsonl"))
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"MainThread", "trlx-rollout-producer", "trlx-score-worker"} <= lanes

    records = _records(tmp_path)
    mfu = [r["obs/train_mfu_pct"] for r in records if "obs/train_mfu_pct" in r]
    assert mfu and all(m > 0 for m in mfu)
    routed = [r for r in records if "obs/fused_logprob_active" in r]
    assert routed
    for key in ("obs/decode_attn_active", "obs/decode_attn_fallback", "obs/fused_logprob_fallback"):
        assert key in routed[-1]
    stale = [r["staleness/mean"] for r in records if "staleness/mean" in r]
    assert stale and stale[-1] == 1.0

    with open(os.path.join(str(tmp_path), "programs.json")) as f:
        programs = json.load(f)
    assert programs["train/step"]["dispatches"] >= 8
    assert programs["train/step"]["variants"][0]["flops"] > 0
    assert programs["rollout/generate"]["variants"][0]["flops"] > 0

    incidents_dir = os.path.join(str(tmp_path), "incidents")
    (bundle,) = [b for b in os.listdir(incidents_dir)]
    with open(os.path.join(incidents_dir, bundle, "incident.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == "slow_step" and manifest["detail"]["step_time"] > 1.0
    assert manifest["sections"]["threads"] == "ok"

    with open(os.path.join(str(tmp_path), "report.md")) as f:
        written = f.read()
    md = report.build_report(str(tmp_path))
    for text in (written, md):
        for heading in ("# Performance report", "## Phase breakdown (per window)", "## MFU / FLOP throughput",
                        "## Kernel routing", "### Monitored programs", "## Span lanes", "## Incidents"):
            assert heading in text
        assert "slow_step" in text and "trlx-rollout-producer" in text
    out_md, trace_out = tmp_path / "r.md", tmp_path / "trace.json"
    assert report.main([str(tmp_path), "-o", str(out_md), "--trace-out", str(trace_out)]) == 0
    assert "slow_step" in out_md.read_text()
    assert json.loads(trace_out.read_text())["traceEvents"]


def test_watch_interval_logs_grad_norms_and_histograms(task, tmp_path):
    """watch_interval=1: every logged step carries per-group
    watch/grad_norm/* scalars (frozen groups too), and parameter histograms
    land in metrics.jsonl."""
    config = _walk_config(tmp_path, total_steps=3, watch_interval=1)
    config.model.num_layers_unfrozen = 1
    _train(task, config)
    records = _records(tmp_path)
    grads = [r for r in records if any(k.startswith("watch/grad_norm/") for k in r)]
    assert len(grads) == 3
    assert {"watch/grad_norm/transformer", "watch/grad_norm/v_head"} <= set(grads[-1])
    hists = {r["histogram"] for r in records if r.get("histogram", "").startswith("watch/params/")}
    assert hists == {"watch/params/transformer", "watch/params/v_head"}


def test_profile_dir_captures_trace(task, tmp_path):
    """train.profile_dir: local steps [2, 5) are traced with torch.profiler
    and the trace lands on disk, naming the train step's operators."""
    config = _walk_config(tmp_path, total_steps=6, profile_dir=str(tmp_path / "trace"))
    _train(task, config)
    path = tmp_path / "trace" / "trace.json"
    assert path.exists()
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_armed_run_logs_finite_telemetry(task, tmp_path, monkeypatch):
    """Device telemetry, graftscope and graftnum armed by the environment on
    one run: every obs/*, num/* and watch/* value logged is finite (the
    guard never trips here), MFU and the ledger show up per window."""
    for var in ("TRLX_TPU_DEVICE_TELEMETRY", "TRLX_TPU_GRAFTSCOPE", "TRLX_TPU_GRAFTNUM"):
        monkeypatch.setenv(var, "1")
    monkeypatch.setenv("TRLX_TPU_PEAK_TFLOPS", "0.01")
    model = _train(task, _walk_config(tmp_path, total_steps=6, watch_interval=2))
    assert model._devicemon is not None and model._graftnum is None  # torn down by learn()
    records = _records(tmp_path)
    values = [(k, v) for r in records for k, v in r.items() if k.startswith(("obs/", "num/", "watch/"))]
    assert values and all(np.isfinite(v) for _, v in values)
    assert any(k == "obs/train_mfu_pct" for k, _ in values) and any(k == "obs/ledger_wall_s" for k, _ in values)
    assert any(k.startswith("num/update_ratio/") for k, _ in values)
