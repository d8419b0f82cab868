"""The port's observability core (``trlx_tpu_torch.observability``: spans,
the anomaly detector, incident bundles, the emergency hook) and its
Tracker, twin of ``tests/test_observability.py`` and
``tests/test_logging.py``.

- The JAX tests' bodies on the port's modules: span lanes that survive an
  OS thread ident's reuse, the error annotation, the torn tail, concurrent
  writers, the disarm on an I/O error; the detector's baseline and breach;
  the incident bundle's sections and budget; the emergency hook.
- Exact equality with the JAX ``AnomalyDetector`` on seeded step-time
  streams (tolerance 0).
- The bundle on this package: ``memory.json`` names the device's bytes,
  ``profile/`` holds a torch.profiler trace, and the capture waits for a
  CUDA-graph capture's lock (``cuda_lib.launch_lock``) held on another
  thread.
- Integration (CPU): an overlapped PPO run (``max_staleness: 1``) with
  span tracing and the anomaly detector armed and the ``slow_step`` drill:
  Chrome-trace lanes per thread, the JAX package's span names, producer and
  train spans that overlap, and a ``slow_step`` bundle whose thread dump
  shows the pipeline threads; the engine path's spans; a guard skip and a
  rollback leave their instants and bundles.
- The Tracker's wandb branch with a stub module, and its JSONL fallback.
"""

import dataclasses
import json
import os
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
import trlx_tpu_torch.utils.logging as tlog  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.observability.anomaly import AnomalyDetector as JaxAnomalyDetector  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.observability import anomaly as obs_anomaly  # noqa: E402
from trlx_tpu_torch.observability import spans as obs_spans  # noqa: E402
from trlx_tpu_torch.utils.logging import Tracker  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _span_isolation():
    """The tracer and the emergency hook are process globals armed by
    trainers and tests: disarm them after every test."""
    yield
    obs_spans.shutdown()
    obs_anomaly.register_emergency(None)


# ------------------------------------------------------------------- spans


def test_trace_span_disabled_is_shared_noop():
    obs_spans.shutdown()
    assert not obs_spans.enabled()
    a = obs_spans.trace_span("x", step=1)
    b = obs_spans.trace_span("y")
    assert a is b  # shared singleton: no per-call allocation on the off path
    with a:
        pass
    obs_spans.complete("z", time.time())  # no-ops, no file appears
    obs_spans.instant("w")


def test_span_lanes_survive_os_thread_ident_reuse(tmp_path):
    """Sequential threads commonly REUSE the OS thread ident; lanes are keyed
    by synthetic per-thread-object tids so each thread still gets its own
    lane + thread_name metadata (the bug this guards: a rollout producer
    inheriting a dead prefetch thread's ident and lane label)."""
    path = str(tmp_path / "spans.jsonl")
    obs_spans.configure(path)
    with obs_spans.trace_span("main/work", step=1):
        pass

    def worker():
        with obs_spans.trace_span("bg/work"):
            time.sleep(0.01)

    for name in ("lane-a", "lane-b"):  # b starts only after a exits
        t = threading.Thread(target=worker, name=name)
        t.start()
        t.join()
    obs_spans.instant("tick", step=2)
    obs_spans.shutdown()

    events = obs_spans.read_spans(path)
    meta = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert len(meta) == 3  # three threads -> three lanes, no merging
    assert {"MainThread", "lane-a", "lane-b"} <= set(meta.values())
    xs = [e for e in events if e["ph"] == "X"]
    assert len({e["tid"] for e in xs if e["name"] == "bg/work"}) == 2
    main_span = next(e for e in xs if e["name"] == "main/work")
    assert main_span["args"] == {"step": 1}
    assert meta[main_span["tid"]] == "MainThread"
    instant = next(e for e in events if e["ph"] == "i")
    assert instant["s"] == "t" and instant["tid"] == main_span["tid"]


def test_span_exit_on_exception_annotates_error(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    obs_spans.configure(path)
    with pytest.raises(ValueError):
        with obs_spans.trace_span("rollout/decode", step=3):
            raise ValueError("boom")
    obs_spans.shutdown()
    span = next(e for e in obs_spans.read_spans(path) if e["ph"] == "X")
    assert span["args"] == {"step": 3, "error": "ValueError"}


def test_span_file_torn_tail_tolerated_like_metrics(tmp_path):
    """Both JSONL writers (Tracker's metrics.jsonl, SpanTracer's spans.jsonl)
    share one reader contract: a writer killed mid-append tears at most the
    final line, which readers drop with a warning; mid-file garbage raises."""
    path = str(tmp_path / "spans.jsonl")
    obs_spans.configure(path)
    for i in range(3):
        obs_spans.complete("train/step", time.time() - 0.01, step=i)
    obs_spans.shutdown()
    with open(path, "ab") as f:
        f.write(b'{"name": "train/step", "ph": "X", "ts": 12')  # torn mid-record
    with pytest.warns(UserWarning, match="torn final record"):
        events = obs_spans.read_spans(path)
    assert sum(e["ph"] == "X" for e in events) == 3

    # the SAME torn file mid-stream is corruption, not a tear
    with open(path, "ab") as f:
        f.write(b'\n{"name": "later", "ph": "i", "ts": 13}\n')
    with pytest.raises(json.JSONDecodeError):
        obs_spans.read_spans(path)


def test_concurrent_span_writers_never_interleave(tmp_path):
    """Line-atomicity under contention: many threads hammering one tracer
    (unbuffered O_APPEND, one write(2) per record) must yield a file where
    EVERY line parses — no interleaved or split records."""
    path = str(tmp_path / "spans.jsonl")
    obs_spans.configure(path)
    n_threads, n_spans = 8, 200

    def hammer(k):
        for i in range(n_spans):
            obs_spans.complete("stress/span", time.time(), writer=k, i=i)

    threads = [threading.Thread(target=hammer, args=(k,), name=f"stress-{k}") for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    obs_spans.shutdown()

    with open(path, "rb") as f:
        lines = [ln for ln in f.read().split(b"\n") if ln.strip()]
    events = [json.loads(ln) for ln in lines]  # raises if any line tore
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == n_threads * n_spans
    assert len({e["tid"] for e in xs}) == n_threads


def test_span_writer_disarms_on_io_error_instead_of_raising(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    obs_spans.configure(path)
    # simulate the disk going away mid-run: close the fd under the tracer
    obs_spans._STATE["tracer"]._file.close()
    with pytest.warns(UserWarning, match="span tracing disabled"):
        obs_spans.instant("after_close")
    assert not obs_spans.enabled()
    obs_spans.instant("noop")  # disarmed: silent no-op, run continues


# ------------------------------------------------------------------ anomaly


def test_anomaly_detector_baseline_seed_and_breach():
    det = obs_anomaly.AnomalyDetector(factor=3.0, window=16, min_samples=5)
    # seeding: nothing may trip before min_samples observations, even spikes
    for _ in range(4):
        assert not det.observe(1.0)
    assert not det.observe(50.0)  # 5th observation still seeds
    assert det.p50() == 1.0
    # breach: > factor * p50 trips, and is NOT absorbed into the baseline
    assert det.observe(4.0)
    assert det.p50() == 1.0
    assert not det.observe(2.9)  # under 3x median: normal


def test_anomaly_detector_factor_zero_disables():
    det = obs_anomaly.AnomalyDetector(factor=0.0)
    assert not any(det.observe(x) for x in [0.1] * 10 + [1000.0])


def test_incident_capture_bundle_contents_and_budget(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text('{"loss": 1.0, "step": 1}\n{"loss": 0.5, "step": 2}\n')
    cap = obs_anomaly.IncidentCapture(
        str(tmp_path), metrics_path=str(metrics), max_incidents=2, last_n_metrics=1
    )
    bundle = cap.capture(7, "unit_drill", detail={"step_time": 9.9})
    assert bundle.endswith(os.path.join("incidents", "7"))

    with open(os.path.join(bundle, "incident.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and manifest["reason"] == "unit_drill"
    assert manifest["detail"] == {"step_time": 9.9}
    assert manifest["sections"]["threads"] == "ok"
    assert manifest["sections"]["memory"] == "ok"
    with open(os.path.join(bundle, "threads.txt")) as f:
        assert "MainThread" in f.read()
    with open(os.path.join(bundle, "memory.json")) as f:
        assert "gauges" in json.load(f)
    with open(os.path.join(bundle, "last_metrics.json")) as f:
        assert json.load(f) == [{"loss": 0.5, "step": 2}]  # tail only

    assert cap.capture(8, "unit_drill")
    assert cap.capture(9, "unit_drill") == ""  # budget spent: rate-limited


def test_emergency_capture_hook_roundtrip(tmp_path):
    cap = obs_anomaly.IncidentCapture(str(tmp_path), max_incidents=1)
    obs_anomaly.emergency_capture("collective_timeout")  # nothing registered: no-op
    obs_anomaly.register_emergency(cap, step_provider=lambda: 42)
    obs_anomaly.emergency_capture("collective_timeout", detail={"op": "psum"})
    with open(os.path.join(str(tmp_path), "incidents", "42", "incident.json")) as f:
        assert json.load(f)["reason"] == "collective_timeout"


@pytest.mark.parametrize("seed", range(5))
def test_anomaly_detector_equals_jax_exactly(seed):
    """Seeded step-time streams with stalls: breach decisions and p50 equal
    the JAX detector's at every observation."""
    rng = np.random.default_rng(seed)
    kw = dict(factor=float(rng.uniform(1.5, 5.0)), window=int(rng.integers(2, 40)),
              min_samples=int(rng.integers(1, 8)))
    port, ref = obs_anomaly.AnomalyDetector(**kw), JaxAnomalyDetector(**kw)
    for i in range(300):
        x = float(rng.lognormal(-1.0, 0.3)) * (float(rng.uniform(3, 30)) if rng.uniform() < 0.08 else 1.0)
        assert port.observe(x) == ref.observe(x), i
        assert port.p50() == ref.p50(), i


def test_incident_bundle_memory_profile_and_launch_lock(tmp_path):
    """The port's bundle: memory.json names the device, profile/ holds a
    torch.profiler trace, and the profile window waits while another thread
    holds the graph-capture lock."""
    from trlx_tpu_torch.ops import cuda_lib

    cap = obs_anomaly.IncidentCapture(str(tmp_path), device="cpu", max_incidents=2)
    held, release = threading.Event(), threading.Event()

    def capture_in_progress():
        with cuda_lib.launch_lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=capture_in_progress, name="capturer")
    t.start()
    held.wait(10)
    done = []
    worker = threading.Thread(target=lambda: done.append(cap.capture(3, "unit_drill", detail={"x": 1})))
    worker.start()
    time.sleep(0.3)
    assert not done  # the profile window waits for the capture's lock
    release.set()
    worker.join(20)
    t.join(10)
    bundle = done[0]
    with open(os.path.join(bundle, "incident.json")) as f:
        manifest = json.load(f)
    assert manifest["sections"] == {"threads": "ok", "memory": "ok", "metrics_tail": "ok", "profile": "ok"}
    assert manifest["capture_seconds"] >= 0.3
    with open(os.path.join(bundle, "memory.json")) as f:
        assert json.load(f)["gauges"]["device"] == "cpu"
    with open(os.path.join(bundle, "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert cap.bundles == [{"step": 3, "reason": "unit_drill", "dir": bundle, "capture_s": cap.bundles[0]["capture_s"]}]
    with open(os.path.join(bundle, "threads.txt")) as f:
        assert "--- thread capturer" in f.read()  # dumped first, while the capture held its lock


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


PROMPTS = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]


def _train(task, config):
    _, logit_mask, metric_fn, reward_fn = task
    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=[[1]], metric_fn=metric_fn,
                                config=config, logit_mask=logit_mask, device="cpu")


def _events(ckpt_dir):
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no torn tail on a clean shutdown
        return obs_spans.read_spans(os.path.join(str(ckpt_dir), "spans.jsonl"))


def _bundles(ckpt_dir):
    d = os.path.join(str(ckpt_dir), "incidents")
    out = {}
    for b in sorted(os.listdir(d)):
        with open(os.path.join(d, b, "incident.json")) as f:
            out.setdefault(json.load(f)["reason"], []).append(os.path.join(d, b))
    return out


def test_e2e_overlapped_run_spans_and_incident(task, tmp_path, monkeypatch):
    """Overlapped PPO (max_staleness 1) with spans and the anomaly detector
    armed and the slow_step drill at step 6."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "slow_step@6")
    monkeypatch.setenv("TRLX_TPU_SLOW_STEP_SECONDS", "1.5")
    config = _walk_config(tmp_path, trace_spans=True, anomaly_factor=3.0)
    config.method.max_staleness = 1
    _train(task, config)
    assert not any(t.name.startswith("trlx-") for t in threading.enumerate())

    events = _events(tmp_path)
    assert events and {e["ph"] for e in events} <= {"X", "i", "M"}
    lanes = {e["args"]["name"]: e["tid"] for e in events if e["ph"] == "M"}
    assert {"MainThread", "trlx-rollout-producer", "trlx-score-worker"} <= set(lanes)
    xs = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"train/step", "rollout/produce", "rollout/generate", "rollout/decode", "rollout/reward_fn",
            "rollout/score_device", "rollout/push", "score/host", "ckpt/save", "ckpt/finalize"} <= names
    producer = [e for e in xs if e["name"] == "rollout/produce"]
    train = [e for e in xs if e["name"] == "train/step"]
    lane_names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {lane_names[e["tid"]] for e in producer} == {"trlx-rollout-producer"}
    assert {lane_names[e["tid"]] for e in train} == {"MainThread"}
    assert {lane_names[e["tid"]] for e in xs if e["name"] == "score/host"} == {"trlx-score-worker"}

    def overlap_us(a, b):
        return min(a["ts"] + a["dur"], b["ts"] + b["dur"]) - max(a["ts"], b["ts"])

    assert any(overlap_us(p, t) > 0 for p in producer for t in train)  # staleness 1 runs ahead

    bundles = _bundles(tmp_path)
    assert list(bundles) == ["slow_step"], bundles
    with open(os.path.join(bundles["slow_step"][0], "incident.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 6 and manifest["detail"]["step_time"] > 1.5
    assert manifest["sections"]["threads"] == "ok"
    with open(os.path.join(bundles["slow_step"][0], "threads.txt")) as f:
        assert "trlx-" in f.read()
    assert any(e["ph"] == "i" and e["name"] == "incident" for e in events)


def test_engine_path_spans(task, tmp_path):
    config = _walk_config(tmp_path, trace_spans=True, total_steps=4, checkpoint_interval=2)
    config.method.rollout_engine = True
    config.method.chunk_size = 8
    _train(task, config)
    names = {e["name"] for e in _events(tmp_path) if e["ph"] == "X"}
    assert {"engine/prefill", "engine/decode", "rollout/decode", "rollout/reward_fn", "rollout/score_device",
            "rollout/push", "train/step", "ckpt/save", "ckpt/finalize"} <= names


def test_guard_skip_and_rollback_leave_instants_and_bundles(task, tmp_path, monkeypatch):
    """nan_grad@2 and @3 with the watchdog (patience 2) and a save at step 1:
    a guard_skip instant and bundle at step 2, then the rollback's instant
    and bundle at step 3, and a ckpt/load span of the restore."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "nan_grad@2,nan_grad@3")
    config = _walk_config(tmp_path, trace_spans=True, anomaly_factor=100.0, checkpoint_interval=1, total_steps=6,
                          watchdog_threshold=0.5, watchdog_patience=2, watchdog_warmup=1)
    # Saves every step would swallow the watchdog's observations (a save's
    # host state flushes without it, as in the JAX package): save once.
    config.train.checkpoint_interval = 10**6
    trainer_cls = trlx_tpu_torch.trainer.ppo.PPOTrainer
    orig = trainer_cls.post_backward_callback

    def save_after_step_1(self, stats=None):
        orig(self, stats)
        if self.iter_count == 1:
            self.save()

    monkeypatch.setattr(trainer_cls, "post_backward_callback", save_after_step_1)
    model = _train(task, config)
    assert model._rollbacks == 1 and model.skipped_steps == 0  # the restored host state's count
    events = _events(tmp_path)
    instants = [(e["name"], e["args"].get("step")) for e in events if e["ph"] == "i"]
    assert ("guard_skip", 2) in instants and ("watchdog_rollback", 3) in instants
    assert any(e["name"] == "ckpt/load" and e["args"]["ckpt"] == "state_1" for e in events if e["ph"] == "X")
    bundles = _bundles(tmp_path)
    assert [os.path.basename(b) for b in bundles["guard_skip"]] == ["2"]
    assert [os.path.basename(b) for b in bundles["watchdog_rollback"]] == ["3"]


# --------------------------------------------------------------------- Tracker


class _StubRun:
    def __init__(self):
        self.logged = []
        self.finished = False

    def log(self, payload, step=None):
        self.logged.append((payload, step))

    def finish(self):
        self.finished = True


class _StubTable:
    def __init__(self, columns, data):
        self.columns = columns
        self.data = data


class _StubHistogram:
    def __init__(self, values):
        self.values = np.asarray(values)


class _StubWandb:
    Table = _StubTable
    Histogram = _StubHistogram

    def __init__(self):
        self.run = _StubRun()
        self.init_kwargs = None

    def init(self, **kwargs):
        self.init_kwargs = kwargs
        return self.run


def _drive(tracker):
    tracker.log({"loss": 1.5, "tag": "x"}, step=3)
    tracker.log_table("samples", ["prompt", "output"], [["a", "b"], ["c", "d"]], step=3)
    tracker.log_histogram("qs", np.arange(8, dtype=np.float32), step=3)
    tracker.finish()


def test_jsonl_fallback_branch(tmp_path, monkeypatch):
    monkeypatch.delenv("TRLX_TPU_DISABLE_TRACKER", raising=False)
    monkeypatch.setattr(tlog, "_HAS_WANDB", False)
    tracker = Tracker(str(tmp_path), config={"lr": 1e-4}, project_name="proj")
    assert tracker.enabled and tracker._wandb is None
    _drive(tracker)
    lines = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [next(iter(rec)) for rec in lines] == ["_config", "step", "table", "histogram"]
    assert lines[1]["loss"] == 1.5 and lines[1]["step"] == 3
    assert lines[2]["rows"] == [["a", "b"], ["c", "d"]]
    assert lines[3]["count"] == 8 and lines[3]["mean"] == pytest.approx(3.5)


def test_wandb_branch_with_stub(tmp_path, monkeypatch):
    monkeypatch.delenv("TRLX_TPU_DISABLE_TRACKER", raising=False)
    stub = _StubWandb()
    monkeypatch.setattr(tlog, "wandb", stub)
    monkeypatch.setattr(tlog, "_HAS_WANDB", True)
    tracker = Tracker(str(tmp_path), config={"lr": 1e-4}, project_name="proj", run_name="run", entity_name="ent")
    assert tracker._wandb is stub.run
    assert (stub.init_kwargs["project"], stub.init_kwargs["name"], stub.init_kwargs["entity"]) == ("proj", "run", "ent")
    assert stub.init_kwargs["config"] == {"lr": 1e-4}
    _drive(tracker)
    assert len(stub.run.logged) == 3
    scalars, step = stub.run.logged[0]
    assert scalars["loss"] == 1.5 and step == 3
    table_payload, _ = stub.run.logged[1]
    assert isinstance(table_payload["samples"], _StubTable)
    assert table_payload["samples"].data == [["a", "b"], ["c", "d"]]
    hist_payload, _ = stub.run.logged[2]
    assert isinstance(hist_payload["qs"], _StubHistogram)
    assert stub.run.finished
    assert (tmp_path / "metrics.jsonl").exists()


def test_trainer_tracker_names_the_run(task, tmp_path, monkeypatch):
    """The trainer opens its Tracker with the config's project and entity
    and the run name the JAX trainer gives (the model path, or
    "from-scratch")."""
    monkeypatch.delenv("TRLX_TPU_DISABLE_TRACKER", raising=False)
    stub = _StubWandb()
    monkeypatch.setattr(tlog, "wandb", stub)
    monkeypatch.setattr(tlog, "_HAS_WANDB", True)
    _, logit_mask, metric_fn, reward_fn = task
    config = _walk_config(tmp_path)
    config.train.entity_name = "team"
    trainer = trlx_tpu_torch.trainer.ppo.PPOTrainer(config, device="cpu", reward_fn=reward_fn)
    trainer.tracker.log({"x": 1.0}, step=0)
    assert (stub.init_kwargs["project"], stub.init_kwargs["name"], stub.init_kwargs["entity"]) == \
        (config.train.project_name, "from-scratch", "team")
    assert stub.run.logged == [({"x": 1.0}, 0)]


def test_second_bundle_at_a_step_lands_beside_the_first(tmp_path):
    cap = obs_anomaly.IncidentCapture(str(tmp_path), max_incidents=3)
    first, second = cap.capture(5, "guard_skip"), cap.capture(5, "health_value_ev")
    assert first.endswith(os.path.join("incidents", "5")) and second.endswith(os.path.join("incidents", "5.1"))
    for bundle, reason in ((first, "guard_skip"), (second, "health_value_ev")):
        with open(os.path.join(bundle, "incident.json")) as f:
            assert json.load(f)["reason"] == reason
