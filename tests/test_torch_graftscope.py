"""graftscope in the port (``trlx_tpu_torch.observability.graftscope``)
against the JAX package's, on the CPU.

Twins of ``tests/test_observability.py``'s graftscope and ``RunManifest``
cases: the conservation identity on hand-built intervals (every gauge equal
to the JAX ledger's on the same intervals), the fence drain with a dropped
fence (the port's drain places CUDA event pairs on the host clock through a
reference event; here stand-in events and clock, as the CPU has no CUDA
events, plus the CPU's own host-clock fence), the armed overlapped run
keeping ``|device + host + bubble - wall| / wall <= 0.05`` in every window
with the snapshot and the report section, the manifest's lifecycle with a
torn tail (its summary equal to the JAX reader's) and a SIGKILLed writer
whose journal names the phase. Beyond the twins: the paged engine's slot
timeline (refills, harvests, the pool row) under an armed scope.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.observability import graftscope as jax_graftscope  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.observability import anomaly as obs_anomaly  # noqa: E402
from trlx_tpu_torch.observability import graftscope as obs_graftscope  # noqa: E402
from trlx_tpu_torch.observability import report  # noqa: E402
from trlx_tpu_torch.observability import spans as obs_spans  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolation():
    yield
    obs_spans.shutdown()
    obs_graftscope.shutdown()
    obs_anomaly.register_emergency(None)


# ---------------------------------------------------------------- the ledger


def _synthetic(module, monkeypatch):
    gs = module.GraftScope()
    now = 1000.0
    gs._win_t0 = now
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda: now + 10.0, sleep=time.sleep))
    gs._device = [
        (now - 2.0, now + 0.5, "warmup"),  # straddles the window start
        (now - 5.0, now - 4.0, "ancient"),  # before the window: clipped away
        (now + 1.0, now + 3.0, "train/step"),
        (now + 2.0, now + 4.0, "rollout/generate"),  # overlaps train/step
    ]
    gs._host = [
        (now + 0.0, now + 5.0, "train"),
        (now + 4.5, now + 6.0, "producer"),
        (now + 20.0, now + 30.0, "score"),  # after the window: clipped away
    ]
    return gs


def test_graftscope_ledger_conservation_on_synthetic_intervals(monkeypatch):
    gs = _synthetic(obs_graftscope, monkeypatch)
    ref_gs = _synthetic(jax_graftscope, monkeypatch)
    gauges, ref = gs.window(), ref_gs.window()
    assert gauges == pytest.approx(ref)
    assert gauges["obs/ledger_wall_s"] == pytest.approx(10.0)
    assert gauges["obs/ledger_device_busy_s"] == pytest.approx(3.5)
    assert gauges["obs/ledger_host_s"] == pytest.approx(2.5)
    assert gauges["obs/ledger_bubble_s"] == pytest.approx(4.0)
    assert gauges["obs/bubble_fraction"] == pytest.approx(0.4)
    assert gauges["obs/ledger_error_frac"] <= 1e-9
    assert gauges["obs/lane_busy_train_s"] == pytest.approx(5.0)
    assert gauges["obs/lane_busy_producer_s"] == pytest.approx(1.5)
    assert gauges["obs/lane_busy_score_s"] == 0.0

    samples = gs.drain_samples()
    assert samples["lane_gaps"]["train"] == pytest.approx([5.0])
    assert samples["lane_gaps"]["producer"] == pytest.approx([4.5, 4.0])
    assert gs.drain_samples() is None

    snap, ref_snap = gs.snapshot(), ref_gs.snapshot()
    assert snap["totals"] == pytest.approx(ref_snap["totals"])
    assert snap["bubble_fraction"] == pytest.approx(0.4)
    assert dict(snap["windows"][-1]["top_programs"]) == pytest.approx(
        {"train/step": 2.0, "rollout/generate": 2.0, "warmup": 0.5})


class _Event:
    """A stand-in CUDA event: ``t`` is where the card ran it (host clock)."""

    def __init__(self, t, fail=False):
        self.t, self.fail = t, fail

    def synchronize(self):
        if self.fail:
            raise RuntimeError("event lost with its stream")


class _Clock:
    def host_time(self, event):
        return event.t


def _wait(gs, cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with gs._lock:
            if cond():
                return True
        time.sleep(0.005)
    return False


def test_graftscope_fence_drain_and_dropped_fences():
    """Event pairs go to the drain thread, which places each dispatch's
    device interval where the card ran it; a fence that fails is counted and
    dropped, never raised; on the CPU the fence is the host clock; close()
    joins the thread."""
    gs = obs_graftscope.GraftScope()
    t0 = time.time()
    gs.track_dispatch("cpu/step", "train", t0 - 0.01)  # no events: the host clock
    assert gs._device and gs._device[0][0] == t0 - 0.01 and gs._device[0][1] >= t0
    gs._clock = _Clock()
    gs.track_dispatch("train/step", "train", t0, (_Event(t0 + 0.1), _Event(t0 + 0.3)))
    assert _wait(gs, lambda: len(gs._device) == 2), "the drain thread placed nothing"
    assert gs._device[1] == (t0 + 0.1, t0 + 0.3, "train/step")
    gs.track_dispatch("rollout/generate", "rollout", t0, (_Event(t0), _Event(t0 + 1, fail=True)))
    assert _wait(gs, lambda: gs._fences_dropped == 1)
    gauges = gs.window()
    assert gauges["obs/graftscope_fences_dropped_total"] == 1.0
    assert "rollout/generate" not in dict(gs.snapshot()["windows"][-1]["top_programs"])
    gs.close()
    assert not any(t.name == obs_graftscope.DRAIN_THREAD_NAME for t in threading.enumerate())


# ------------------------------------------------------------------- e2e


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


def test_e2e_graftscope_armed_run_conserves_ledger(task, tmp_path, monkeypatch):
    """An armed overlapped CPU run keeps |device + host + bubble - wall| /
    wall <= 0.05 in every window (the JAX test's bar), attributes device
    time to programs, writes graftscope.json, and the report renders the
    attribution section with its time sinks. Armed by the environment."""
    monkeypatch.setenv("TRLX_TPU_GRAFTSCOPE", "1")
    monkeypatch.setenv("TRLX_TPU_PEAK_TFLOPS", "0.01")
    _, logit_mask, metric_fn, reward_fn = task
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps, config.train.epochs, config.train.batch_size = 8, 4, 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = str(tmp_path)
    config.method.num_rollouts = config.method.chunk_size = 16
    config.method.max_staleness = 1
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1]], metric_fn=metric_fn,
                         config=config, logit_mask=logit_mask, device="cpu")
    assert not any(t.name.startswith("trlx-") for t in threading.enumerate())
    assert not obs_graftscope.armed()  # learn() tears the scope down

    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    windows = [r for r in records if "obs/ledger_wall_s" in r]
    assert windows
    for r in windows:
        wall = r["obs/ledger_wall_s"]
        err = abs(r["obs/ledger_device_busy_s"] + r["obs/ledger_host_s"] + r["obs/ledger_bubble_s"] - wall) / wall
        assert err <= 0.05, (err, r)
        assert r["obs/ledger_error_frac"] <= 0.05
        assert 0.0 <= r["obs/bubble_fraction"] <= 1.0
    assert any(r["obs/ledger_device_busy_s"] > 0 for r in windows)
    assert any(r["obs/lane_busy_producer_s"] > 0 for r in windows)

    with open(os.path.join(str(tmp_path), obs_graftscope.SNAPSHOT_FILENAME)) as f:
        snap = json.load(f)
    assert snap["windows"] and snap["totals"]["wall_s"] > 0 and snap["programs_s"]
    md = report.build_report(str(tmp_path))
    assert "## Device-time attribution (graftscope)" in md and "Top-3 time sinks" in md


def test_engine_slot_timeline_under_an_armed_scope():
    """The paged engine's refills, harvests and pool samples reach the
    armed scope: every slot row counts its episodes, refill waits are
    sampled once a slot is reused, and the window carries the pool row."""
    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.lm import LMConfig
    from trlx_tpu_torch.ops.sampling import GenerateConfig

    torch.manual_seed(0)
    model = LMWithValueHead(LMConfig(vocab_size=23, n_layer=2, n_head=2, d_model=32, max_position=96,
                                     dtype="float32"), device="cpu")
    model.requires_grad_(False)
    engine = RolloutEngine(model, GenerateConfig(max_new_tokens=4, do_sample=False, pad_token_id=0), n_slots=2,
                           prompt_width=4, prefill_batch=1, steps_per_sync=2, paged_kv=True, kv_block_size=4)
    gs = obs_graftscope.configure()
    engine.update_weights(model, version=0)
    rng = np.random.default_rng(0)
    engine.submit(rng.integers(1, 23, size=(6, 4)), np.ones((6, 4), np.int64))
    episodes = []
    while not engine.idle:
        episodes += engine.step()
    engine.shutdown()
    assert len(episodes) == 6
    snap = gs.snapshot()
    assert sum(row["episodes"] for row in snap["slots"]) == 6
    assert snap["pool"] is not None and snap["pool"]["total_blocks"] == engine.n_blocks
    gauges = gs.window()
    assert "engine/refill_wait_ms_p50" in gauges and "engine/pool_used_frac_max" in gauges
    assert gs.drain_samples()["straggler_steps"][4] == [4] * 6


# ------------------------------------------------------------ RunManifest


def test_run_manifest_lifecycle_torn_tail_and_idempotent_finish(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = obs_graftscope.RunManifest(path, cmd="bench.py", backend="cpu")
    m.heartbeat("size_ladder", candidate="a")
    m.child("a", 0, "")
    m.partial({"metric": "x", "value": 1.5})
    m.finish(rc=0, metric="x", value=1.5)
    m.finish(rc=1, reason="late duplicate")  # the first end wins
    with open(path, "ab") as f:
        f.write(b'{"event": "heartbeat", "pha')  # a kill tears the tail
    s = obs_graftscope.RunManifest.read(path)
    assert s == jax_graftscope.RunManifest.read(path)
    assert s["valid"] and s["complete"] and s["rc"] == 0 and s["reason"] == "completed rc=0"
    assert s["partial"] == {"metric": "x", "value": 1.5}
    assert s["children"] == [{"label": "a", "rc": 0}]
    with open(path, "rb") as f:
        assert f.read().count(b'"event": "end"') == 1


def test_run_manifest_survives_sigkill_and_names_the_phase(tmp_path):
    """A writer SIGKILLed mid-ladder leaves a journal that says when and
    during what it died, with the last child failure's rc and stderr tail."""
    path = str(tmp_path / "m.jsonl")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child_src = (
        "import sys, time\n"
        "sys.path.insert(0, %r)\n"
        "from trlx_tpu_torch.observability.graftscope import RunManifest\n"
        "m = RunManifest(%r, cmd='bench drill')\n"
        "m.heartbeat('size_ladder', candidate='big')\n"
        "m.child('big', 1, 'Traceback...\\nValueError: kernel build failed')\n"
        "m.heartbeat('size_ladder', candidate='small')\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n"
    ) % (repo, path)
    proc = subprocess.Popen([sys.executable, "-c", child_src], stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    s = obs_graftscope.RunManifest.read(path)
    assert s["valid"] and not s["complete"] and s["rc"] is None
    assert "killed mid-flight during size_ladder" in s["reason"] and "(candidate small)" in s["reason"]
    assert "last child failure big rc=1" in s["reason"] and "ValueError: kernel build failed" in s["reason"]
    assert s == jax_graftscope.RunManifest.read(path)
