"""The disaggregated fleet in the port (``trlx_tpu_torch.fleet``): parity with
the port's serial run and with the JAX package's fleet, and the
two-process drills (twins of ``tests/test_fleet_disagg.py``).

In-process:

- a COLOCATED fleet at max_staleness 0 pushes every episode through the real
  transports (episode npz, versioned weight broadcast, loaded into a
  rollout-side module) and is bit-equal to the serial run: every consumed
  store (the staleness column aside), every loss and the end parameters,
  for the randomwalks task and the forced-bigram task of
  ``tests/test_torch_train.py``;
- the in-flight knob at staleness 0 (engine path): bitwise equal to knob
  off, each stream record one span naming its own version;
- the port's colocated fleet against the JAX package's on the same initial
  weights (``params_from_jax``, the bigram task): every streamed batch's
  tokens and masks equal, its float columns within 1e-4 (the rollout
  twin's tolerance), the losses within the serial PPO twin's (step 1 1e-5,
  later steps 2e-4).

Two processes (the rollout job and the learner job, coupled only through
``train.fleet_dir``; each process under a hard wall limit): the
rollout-host kill with a preempted and resumed learner, the broadcast
timeout (the starved worker exits 117), the episode-stream stall (triaged
stalled, not dead), and staleness 0 bitwise against a serial process.
"""

import dataclasses
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import torch_fleet_drill as drill  # noqa: E402
import trlx_tpu  # noqa: E402
import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig  # noqa: E402
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.fleet.topology import read_jsonl_or_empty  # noqa: E402
from trlx_tpu_torch.models.hf_import import params_from_jax  # noqa: E402
from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator  # noqa: E402
from trlx_tpu_torch.resilience.distributed import EXIT_COLLECTIVE_TIMEOUT  # noqa: E402
from trlx_tpu_torch.trainer import register_model  # noqa: E402
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


# ------------------------------------------------ colocated parity (in-process)

V, P, R = 31, 10, 6


def _walk_config(ckpt_dir, steps=8, fleet=False, **method):
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = steps
    config.train.epochs = 4
    config.train.batch_size = 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = str(ckpt_dir)
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    if fleet:
        config.method.fleet_disaggregate = True
        config.train.fleet_dir = str(ckpt_dir) + "_fleet"
    for k, v in method.items():
        setattr(config.method, k, v)
    return config


def _bigram_dict(ckpt_dir, fleet=False, **method):
    """``tests/test_torch_train.py``'s forced-bigram config (einsum route)."""
    arch = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
                extra={"lm_head_bias": True})
    cfg = {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32"),
        "train": dict(total_steps=8, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                      weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4, checkpoint_interval=10**6,
                      eval_interval=100, checkpoint_dir=str(ckpt_dir), seed=11),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }
    if fleet:
        cfg["method"].update(fleet_disaggregate=True, max_staleness=0)
        cfg["train"]["fleet_dir"] = str(ckpt_dir) + "_fleet"
    cfg["method"].update(method)
    return cfg


def _bigram_task():
    rng = np.random.default_rng(0)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]

    def reward_fn(samples):
        return [float(np.sum(s) % 7) - 3.0 for s in samples]

    return prompts, logit_mask, reward_fn


def _records(ckpt_dir):
    with open(os.path.join(str(ckpt_dir), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run_recording(monkeypatch, run):
    """Run ``run()`` with every experience phase's store recorded (its
    columns, the staleness column aside) as make_experience fills it."""
    stores = []
    real = PPOOrchestrator.make_experience

    def recording(self, num_rollouts=1024, iter_count=0, store=None, **kw):
        out = real(self, num_rollouts, iter_count, store=store, **kw)
        cols = (store if store is not None else self.rl_model.store).columns()
        stores.append({k: v.copy() for k, v in cols.items() if k != "staleness"})
        return out

    monkeypatch.setattr(PPOOrchestrator, "make_experience", recording)
    model = run()
    monkeypatch.setattr(PPOOrchestrator, "make_experience", real)
    return model, stores


def _assert_stores_equal(got, ref):
    assert len(got) == len(ref) >= 2
    for i, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]), f"store {i} column {k}"


def _assert_params_equal(a, b):
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert pa.keys() == pb.keys()
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


@pytest.mark.parametrize("which", ["randomwalks", "bigram"])
def test_colocated_staleness0_matches_serial_bitwise(task, tmp_path, monkeypatch, which):
    """Every batch round-trips episodes/batch_*.npz and every weight handoff
    round-trips weights_*.npz into the rollout-side module, and the run is
    still bit-equal to the serial one."""
    if which == "randomwalks":
        _, logit_mask, metric_fn, reward_fn = task
        prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
        kw = dict(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1]], metric_fn=metric_fn,
                  logit_mask=logit_mask, device="cpu")

        def run(d, fleet):
            cfg = _walk_config(d, fleet=fleet, max_staleness=0) if fleet else _walk_config(d)
            return trlx_tpu_torch.train(config=cfg, **kw)
    else:
        prompts, logit_mask, reward_fn = _bigram_task()
        kw = dict(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5], logit_mask=logit_mask,
                  device="cpu")

        def run(d, fleet):
            return trlx_tpu_torch.train(config=TRLConfig.from_dict(_bigram_dict(d, fleet=fleet)), **kw)

    serial, stores_serial = _run_recording(monkeypatch, lambda: run(tmp_path / "serial", False))
    fleet, stores_fleet = _run_recording(monkeypatch, lambda: run(tmp_path / "colo", True))
    _assert_stores_equal(stores_fleet, stores_serial)
    losses_serial = [r["loss"] for r in _records(tmp_path / "serial") if "loss" in r]
    losses_fleet = [r["loss"] for r in _records(tmp_path / "colo") if "loss" in r]
    assert len(losses_serial) == 8 and losses_fleet == losses_serial
    _assert_params_equal(fleet, serial)
    assert fleet.kl_ctl.value == serial.kl_ctl.value

    # The run really went through the transports, all on-policy, and the
    # rollouts read a rollout-side module, never the live one.
    fleet_dir = str(tmp_path / "colo") + "_fleet"
    stream = read_jsonl_or_empty(os.path.join(fleet_dir, "stream.jsonl"))
    broadcast = read_jsonl_or_empty(os.path.join(fleet_dir, "broadcast.jsonl"))
    assert len(stream) == len(stores_fleet)
    published = {r["version"] for r in broadcast if r["status"] == "published"}
    assert {r["weight_version"] for r in stream} <= published
    for rec, cols in zip(stream, stores_fleet):
        with np.load(os.path.join(fleet_dir, "episodes", rec["file"])) as z:
            assert all(np.array_equal(z[k], cols[k]) for k in cols)
    stale = [r["staleness/mean"] for r in _records(tmp_path / "colo") if "staleness/mean" in r]
    assert stale and all(s == 0.0 for s in stale)
    modules = fleet._fleet_weights.modules
    assert len(modules) == 1 and modules[0] is not fleet.model
    # Clean teardown: the feed shut down and detached, no leaked threads,
    # and the coordinated completion marker landed.
    assert fleet._fleet_feed is None
    assert not any(t.name.startswith("trlx-") for t in threading.enumerate())
    with open(os.path.join(fleet_dir, "abort.json")) as f:
        assert json.load(f)["reason"] == "complete"


def test_colocated_inflight_knob_staleness0_is_bitwise_with_span_records(task, tmp_path):
    """At staleness 0 no push can land mid-phase, so the in-flight knob
    changes the run by nothing (bitwise, on the engine path); the stream
    index then carries one span per record naming its own version, with no
    mixed-version tokens at consume time."""
    _, logit_mask, metric_fn, reward_fn = task
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    engine = dict(max_staleness=0, rollout_engine=True, engine_steps_per_sync=2)
    out = {}
    for tag, inflight in (("off", False), ("on", True)):
        cfg = _walk_config(tmp_path / tag, steps=4, fleet=True, fleet_inflight_weights=inflight, **engine)
        model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1]], metric_fn=metric_fn,
                                     config=cfg, logit_mask=logit_mask, device="cpu")
        out[tag] = (model, [r["loss"] for r in _records(tmp_path / tag) if "loss" in r])
    assert len(out["off"][1]) == 4 and out["on"][1] == out["off"][1]
    _assert_params_equal(out["on"][0], out["off"][0])
    stream_off = read_jsonl_or_empty(os.path.join(str(tmp_path / "off") + "_fleet", "stream.jsonl"))
    stream_on = read_jsonl_or_empty(os.path.join(str(tmp_path / "on") + "_fleet", "stream.jsonl"))
    assert stream_off and all("version_spans" not in r for r in stream_off)
    assert stream_on
    for r in stream_on:
        assert r["version_spans"] == [[r["weight_version"], r["version_spans"][0][1]]]
        assert r["version_spans"][0][1] > 0
    events = read_jsonl_or_empty(os.path.join(str(tmp_path / "on") + "_fleet", "fleet_events.jsonl"))
    consumed = [e for e in events if e["event"] == "episode_consumed"]
    assert consumed and all(e["mixed_version_tokens"] == 0 for e in consumed)
    assert all(e["staleness"] == 0 for e in consumed)


_JAX_INIT = {}


@register_model("PPOFleetFromJaxInit")
class _PPOFleetFromJaxInit(PPOTrainer):
    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.load_params(params_from_jax(_JAX_INIT["params"], self.model),
                         params_from_jax(_JAX_INIT["extras"], self.model))


def test_colocated_fleet_store_matches_jax(tmp_path):
    """The same colocated staleness-0 fleet config through ``trlx_tpu.train``
    and ``trlx_tpu_torch.train``, the port from the JAX trainer's initial
    weights: every streamed batch (the wire format both packages share)
    has equal tokens and masks and float columns within 1e-4, and the
    losses agree within the serial PPO twin's tolerance."""
    prompts, logit_mask, reward_fn = _bigram_task()
    init = JaxPPOTrainer(JaxTRLConfig.from_dict(_bigram_dict(tmp_path / "init")))
    _JAX_INIT["params"] = jax.device_get(init.state.params)
    _JAX_INIT["extras"] = jax.device_get(init.state.extras)
    del init
    kw = dict(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5], logit_mask=logit_mask)
    jm = trlx_tpu.train(config=JaxTRLConfig.from_dict(_bigram_dict(tmp_path / "jax", fleet=True)), **kw)
    cfg = _bigram_dict(tmp_path / "torch", fleet=True)
    cfg["model"]["model_type"] = "PPOFleetFromJaxInit"
    tm = trlx_tpu_torch.train(config=TRLConfig.from_dict(cfg), device="cpu", **kw)
    assert tm.iter_count == jm.iter_count == 8

    streams = {}
    for name in ("jax", "torch"):
        fleet_dir = str(tmp_path / name) + "_fleet"
        recs = read_jsonl_or_empty(os.path.join(fleet_dir, "stream.jsonl"))
        streams[name] = [(r, dict(np.load(os.path.join(fleet_dir, "episodes", r["file"])))) for r in recs]
    assert len(streams["torch"]) == len(streams["jax"]) >= 2
    for (tr, tc), (jr, jc) in zip(streams["torch"], streams["jax"]):
        assert (tr["seq"], tr["n"], tr["weight_version"]) == (jr["seq"], jr["n"], jr["weight_version"])
        assert set(tc) == set(jc)
        for k in ("query_tensors", "query_mask", "response_tensors", "response_mask"):
            assert np.array_equal(tc[k], jc[k]), (tr["seq"], k)
        for k in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(tc[k], jc[k], rtol=1e-4, atol=1e-4, err_msg=f"seq {tr['seq']} {k}")
    ts = {r["step"]: r for r in _records(tmp_path / "torch") if "loss" in r}
    js = {r["step"]: r for r in _records(tmp_path / "jax") if "loss" in r}
    assert sorted(ts) == sorted(js) == list(range(1, 9))
    for step in ts:
        tol = 1e-5 if step == 1 else 2e-4
        np.testing.assert_allclose(ts[step]["loss"], js[step]["loss"], rtol=tol, atol=tol, err_msg=f"step {step}")
        assert ts[step]["staleness/mean"] == js[step]["staleness/mean"] == 0.0
    np.testing.assert_allclose(tm.kl_ctl.value, jm.kl_ctl.value, rtol=1e-6)


# ------------------------------------------------------- two-process drills


def test_fleet_drill_rollout_host_kill_with_preemption_and_resume(tmp_path):
    """Three legs against ONE persistent worker: learner leg 1 is preempted
    (sigterm@12) → exits 0, writes NO abort marker, the worker keeps
    serving; leg 2 resumes from the checkpoint, republishes its restored
    version and keeps consuming from the cursor; the worker is killed
    mid-run (rollout_host_kill@6) → leg 2 drains the queued episodes at
    staleness <= the cap, reports fleet/degraded on a live /healthz scrape,
    triages the peer DEAD and exits cleanly."""
    fleet_dir = tmp_path / "fleet"
    env = {"TOTAL": "100", "EPOCHS": "100"}
    worker = drill.launch("rollout", tmp_path / "ckpt_w", fleet_dir, 2,
                          {**env, "TRLX_TPU_FAULTS": "rollout_host_kill@6"})
    try:
        learner_env = {**env, "TRLX_TPU_METRICS_PORT": str(drill.free_port())}
        leg1 = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 2,
                            {**learner_env, "TRLX_TPU_FAULTS": "sigterm@12"})
        out1 = drill.finish(leg1)
        assert leg1.returncode == 0, out1[-4000:]
        assert not os.path.exists(fleet_dir / "abort.json")  # preemption is not a shutdown
        assert worker.poll() is None, "the worker died during the learner's preemption"
        drill.assert_clean_threads(out1, "learner leg 1")

        leg2 = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 2, {**learner_env, "RESUME": "1"})
        out2 = drill.finish(leg2)
        out_w = drill.finish(worker, timeout=60)
        assert leg2.returncode == 0, out2[-4000:]
        assert worker.returncode == 1, out_w[-4000:]  # rollout_host_kill is os._exit(1)
        assert "[fleet] learner stopped cleanly" in out2
        assert "resumed from step" in out2
        drill.assert_clean_threads(out2, "learner leg 2")

        events = drill.events(fleet_dir)
        assert [e["reason"] for e in events if e["event"] == "learner_exit"] == ["preempted", "degraded"]
        degraded = [e for e in events if e["event"] == "degraded"]
        assert degraded and degraded[0]["triage"] == "dead"
        # The resumed leg republished its restored step as a fresh DENSE
        # ordinal before consuming anything.
        starts = [i for i, e in enumerate(events) if e["event"] == "learner_start"]
        assert len(starts) == 2
        pre = [e["version"] for i, e in enumerate(events) if i < starts[1] and e["event"] == "weights_published"]
        post = [e["version"] for i, e in enumerate(events) if i > starts[1] and e["event"] == "weights_published"]
        assert pre and post and post[0] >= max(pre) and post[0] == 12
        ordinals = [e["ordinal"] for e in events if e["event"] == "weights_published"]
        assert ordinals == list(range(len(ordinals)))
        consumed = [e for e in events if e["event"] == "episode_consumed"]
        staleness = [e["staleness"] for e in consumed]
        assert all(s <= 2 for s in staleness) and staleness[-1] == 2
        assert [e["seq"] for e in consumed] == list(range(len(consumed)))
        with open(fleet_dir / "abort.json") as f:
            abort = json.load(f)
        assert abort["reason"] == "degraded" and abort["triage"] == "dead"
        stream = drill.read_jsonl(fleet_dir / "stream.jsonl")
        broadcast = drill.read_jsonl(fleet_dir / "broadcast.jsonl")
        published = {r["version"] for r in broadcast if r["status"] == "published"}
        assert stream and {r["weight_version"] for r in stream} <= published
        with open(tmp_path / "ckpt_l" / "scrape_degraded.json") as f:
            block = json.load(f)["fleet"]["disaggregated"]
        assert block["state"] == "degraded" and block["triage"] == "dead" and block["role"] == "learner"
    finally:
        drill.kill_all(worker)


def test_fleet_drill_broadcast_timeout_aborts_starved_worker(tmp_path):
    """broadcast_timeout@2 on the learner: ordinal 2 is skipped, so the
    staleness-0 worker's wait for it outlives its deadline under the
    collective guard and exits 117, while the learner triages it dead and
    stops cleanly."""
    fleet_dir = tmp_path / "fleet"
    env = {"TOTAL": "100", "EPOCHS": "100", "BDEADLINE": "8"}
    worker = drill.launch("rollout", tmp_path / "ckpt_w", fleet_dir, 0, env)
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 0,
                               {**env, "TRLX_TPU_FAULTS": "broadcast_timeout@2"})
        out_l = drill.finish(learner)
        out_w = drill.finish(worker)
        assert worker.returncode == EXIT_COLLECTIVE_TIMEOUT, out_w[-4000:]
        assert "fleet/weight_broadcast" in out_w  # the starved worker's guard names the site
        assert learner.returncode == 0, out_l[-4000:]
        assert "[fleet] learner stopped cleanly" in out_l
        events = drill.events(fleet_dir)
        degraded = [e for e in events if e["event"] == "degraded"]
        assert degraded and degraded[0]["triage"] == "dead"
        broadcast = drill.read_jsonl(fleet_dir / "broadcast.jsonl")
        assert any(r["status"] == "injected_timeout" and r["ordinal"] == 2 for r in broadcast)
        # The worker streamed against the published ordinals 0 and 1.
        assert len(drill.read_jsonl(fleet_dir / "stream.jsonl")) >= 2
        drill.assert_clean_threads(out_l, "learner")
    finally:
        drill.kill_all(worker)


def test_fleet_drill_episode_stream_stall_triages_stalled_not_dead(tmp_path):
    """episode_stream_stall@2 on the worker: batch 2 never lands but the
    worker's heartbeat thread keeps beating, so the learner's triage says
    STALLED. The stall is finite, so the woken worker observes the abort
    marker and exits 0."""
    fleet_dir = tmp_path / "fleet"
    env = {"TOTAL": "100", "EPOCHS": "100"}
    worker = drill.launch("rollout", tmp_path / "ckpt_w", fleet_dir, 1,
                          {**env, "TRLX_TPU_FAULTS": "episode_stream_stall@2", "TRLX_TPU_STREAM_STALL_SECONDS": "12"})
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 1, env)
        out_l = drill.finish(learner)
        out_w = drill.finish(worker, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert worker.returncode == 0, out_w[-4000:]
        events = drill.events(fleet_dir)
        degraded = [e for e in events if e["event"] == "degraded"]
        assert degraded and degraded[0]["triage"] == "stalled"
        with open(fleet_dir / "abort.json") as f:
            assert json.load(f)["triage"] == "stalled"
        assert "episode stream wait" in out_l  # the retry wrapper fired before triage escalated
        drill.assert_clean_threads(out_l, "learner")
        drill.assert_clean_threads(out_w, "worker")
    finally:
        drill.kill_all(worker)


def test_two_process_staleness0_matches_serial_bitwise(tmp_path):
    """A learner process and a worker process at staleness 0 (episodes
    crossing as npz, weights as byte leaves, the KL coefficient riding the
    pointer) reproduce a serial process's losses bitwise."""
    serial = drill.launch("serial", tmp_path / "ckpt_s", tmp_path / "unused", 0)
    out_s = drill.finish(serial)
    assert serial.returncode == 0, out_s[-4000:]
    fleet_dir = tmp_path / "fleet"
    worker = drill.launch("rollout", tmp_path / "ckpt_w", fleet_dir, 0)
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 0)
        out_l = drill.finish(learner)
        out_w = drill.finish(worker, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert worker.returncode == 0, out_w[-4000:]
        assert drill.losses(out_s) == drill.losses(out_l) and len(drill.losses(out_s)) == 8
        consumed = [e for e in drill.events(fleet_dir) if e["event"] == "episode_consumed"]
        assert consumed and all(e["staleness"] == 0 for e in consumed)
        stream = drill.read_jsonl(fleet_dir / "stream.jsonl")
        broadcast = drill.read_jsonl(fleet_dir / "broadcast.jsonl")
        published = {r["version"] for r in broadcast if r["status"] == "published"}
        assert {r["weight_version"] for r in stream} <= published
        with open(fleet_dir / "abort.json") as f:
            assert json.load(f)["reason"] == "complete"
        drill.assert_clean_threads(out_l, "learner")
        drill.assert_clean_threads(out_w, "worker")
    finally:
        drill.kill_all(worker)
