"""The elastic N-worker fleet in the port (``trlx_tpu_torch.fleet`` with
``method.fleet_elastic``): twins of ``tests/test_fleet_elastic.py``.

In-process, held to the JAX package on the same inputs where it has the
function: the lease ledger's claim / renew / expire / reclaim generations
(the port's ledger and the JAX ledger read one directory alike), the O_EXCL
worker registry, the validation of the elastic knobs (the JAX outcome, role
or exception, for each config), ``lease_ttl``'s resolution, and
``seek_chunks``: any worker rebuilds any unit's prompt shard, and the
port's shards are the JAX orchestrator's for the same pipeline and seed.
The colocated elastic run (the inline producer is worker 0, claiming
leases and tagging units) at staleness 0 is bit-equal to the non-elastic
colocated run.

Multi-process drills (a learner and one or two workers, each its own
process under a hard wall limit): ``worker_kill_mid_lease`` (the survivor
reclaims, every unit consumed exactly once), ``slow_worker_reclaim`` (two
records land for one unit, one is consumed), a worker leaving cleanly
while another joins mid-run, all workers dead (the learner degrades and
exits 0), and two workers at staleness 0 bitwise against a serial process.
"""

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import torch_fleet_drill as drill  # noqa: E402
import trlx_tpu.fleet as jfleet  # noqa: E402
import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.fleet import (  # noqa: E402
    ElasticStreamReader,
    FleetPaths,
    LeaseLedger,
    WorkerRegistry,
    role_timeouts,
    validate_fleet_config,
)
from trlx_tpu_torch.fleet.topology import WORKER_ENV, read_jsonl_or_empty  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


# ----------------------------------------------------------- lease ledger


def _ledger(tmp_path, ttl=60.0):
    paths = FleetPaths(root=str(tmp_path / "fleet")).ensure_elastic()
    return LeaseLedger(paths.leases_dir, ttl=ttl), paths


def _units(ledger):
    return {u: (l.gen, l.worker, l.status) for u, l in ledger.units().items()}


def test_lease_claim_is_exclusive_and_renewable(tmp_path):
    led, paths = _ledger(tmp_path)
    lease = led.try_claim(0, worker=0)
    assert lease is not None and lease.gen == 0 and lease.worker == 0
    # A fresh-held unit is unclaimable by a peer; the owner re-adopts it.
    assert led.try_claim(0, worker=1) is None
    again = led.try_claim(0, worker=0)
    assert again is not None and again.gen == 0
    renewed = led.renew(lease)
    assert renewed is not None and renewed.expires >= lease.expires
    assert [x.unit for x in led.held_by(0)] == [0]
    assert led.reclaimed_units() == []
    ref = jfleet.LeaseLedger(paths.leases_dir, ttl=60.0)
    assert _units(led) == _units(ref) and [x.unit for x in ref.held_by(0)] == [0]


def test_expired_lease_reclaims_at_next_generation(tmp_path):
    led, paths = _ledger(tmp_path, ttl=0.2)
    l0 = led.try_claim(3, worker=0)
    assert l0.gen == 0
    time.sleep(0.3)
    l1 = led.try_claim(3, worker=1)
    assert l1 is not None and l1.gen == 1 and l1.worker == 1
    # The dead owner's stale handle lost: renew / complete refuse quietly.
    assert led.renew(l0) is None
    assert led.complete(l0) is False
    assert led.complete(l1) is True
    assert led.reclaimed_units() == [3] == jfleet.LeaseLedger(paths.leases_dir, ttl=0.2).reclaimed_units()
    # A done unit is never claimable again, by any worker.
    assert led.try_claim(3, worker=0) is None
    assert led.try_claim(3, worker=1) is None


def test_released_lease_reclaims_without_waiting_for_ttl(tmp_path):
    led, paths = _ledger(tmp_path, ttl=60.0)
    l0 = led.try_claim(1, worker=0)
    assert led.release(l0)
    l1 = led.try_claim(1, worker=1)  # at once: a clean leave needs no TTL wait
    assert l1 is not None and l1.gen == 1
    assert led.reclaimed_units() == [1]
    # The JAX ledger on the same directory takes the port's leases as its own.
    ref = jfleet.LeaseLedger(paths.leases_dir, ttl=60.0)
    assert _units(ref) == _units(led) == {1: (1, 1, "held")}
    assert ref.try_claim(1, worker=0) is None


def test_torn_claim_file_reads_as_fresh_hold_not_free(tmp_path):
    """A lease file caught mid-write reads HELD (claimable only after the
    mtime + ttl grace), never free."""
    led, paths = _ledger(tmp_path, ttl=0.3)
    with open(os.path.join(paths.leases_dir, "unit_000007.gen000.json"), "w") as f:
        f.write('{"unit": 7, "wor')
    assert led.try_claim(7, worker=1) is None  # a fresh torn file: held
    assert jfleet.LeaseLedger(paths.leases_dir, ttl=0.3).try_claim(7, worker=2) is None
    time.sleep(0.4)
    got = led.try_claim(7, worker=1)  # the grace elapsed: reclaim at the next generation
    assert got is not None and got.gen == 1


def test_worker_registry_auto_ids_leave_and_incarnation(tmp_path):
    paths = FleetPaths(root=str(tmp_path / "fleet")).ensure_elastic()
    reg = WorkerRegistry(paths.workers_dir)
    assert reg.register() == 0
    assert reg.register() == 1  # the lowest free slot via O_EXCL
    assert sorted(reg.active()) == [0, 1]
    reg.leave(0)
    assert reg.active() == [1] == jfleet.WorkerRegistry(paths.workers_dir).active()
    assert reg.workers()[0]["status"] == "left"
    # A left slot is NOT reused by auto-assignment (by either package)...
    assert jfleet.WorkerRegistry(paths.workers_dir).register() == 2
    # ...but an explicit re-register of the same id bumps its incarnation.
    assert reg.register(0) == 0
    assert reg.workers()[0]["status"] == "active"
    assert reg.workers()[0]["incarnation"] == 1


# ------------------------------------------------------------- validation


def _configs(**train):
    jcfg = base_config("ppo", 15, 8)
    for k, v in train.items():
        setattr(jcfg.train, k, v)
    pcfg = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    return jcfg, pcfg


def _outcome(fn, config):
    try:
        return ("ok", fn(config))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e))


def _both(jcfg, pcfg):
    got, ref = _outcome(validate_fleet_config, pcfg), _outcome(jfleet.validate_fleet_config, jcfg)
    assert got == ref
    return got


def test_fleet_elastic_requires_disaggregate(monkeypatch):
    monkeypatch.delenv(WORKER_ENV, raising=False)
    jcfg, pcfg = _configs()
    jcfg.method.fleet_elastic = pcfg.method.fleet_elastic = True
    kind, msg = _both(jcfg, pcfg)
    assert kind == "ValueError" and "fleet_disaggregate" in msg


def test_worker_env_and_lease_ttl_require_elastic(monkeypatch):
    jcfg, pcfg = _configs()
    jcfg.method.fleet_disaggregate = pcfg.method.fleet_disaggregate = True
    monkeypatch.setenv(WORKER_ENV, "1")
    kind, msg = _both(jcfg, pcfg)
    assert kind == "ValueError" and WORKER_ENV in msg
    monkeypatch.delenv(WORKER_ENV, raising=False)
    jcfg.train.fleet_lease_ttl = pcfg.train.fleet_lease_ttl = 5.0
    kind, msg = _both(jcfg, pcfg)
    assert kind == "ValueError" and "fleet_lease_ttl" in msg
    jcfg.method.fleet_elastic = pcfg.method.fleet_elastic = True
    assert _both(jcfg, pcfg) == ("ok", "colocated")
    monkeypatch.setenv(WORKER_ENV, "banana")
    kind, msg = _both(jcfg, pcfg)
    assert kind == "ValueError" and "non-negative" in msg


def test_lease_ttl_resolution_defaults_from_heartbeat():
    for train, ttl in (({}, 3.0), ({"heartbeat_interval": 2.0}, 12.0), ({"fleet_lease_ttl": 7.5}, 7.5)):
        jcfg, pcfg = _configs(**train)
        assert role_timeouts(pcfg.train)["lease_ttl"] == ttl == jfleet.role_timeouts(jcfg.train)["lease_ttl"]


# ---------------------------------------------- deterministic prompt seek


def _orchestrators(chunk_size=8):
    """The port's and the JAX package's prompt streams over one prompt set
    (only the prompt-stream half of each orchestrator)."""
    from trlx_tpu.orchestrator.ppo_orchestrator import PPOOrchestrator as JaxOrch
    from trlx_tpu.pipeline.prompt_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline

    prompts = [[i % 13 + 1] for i in range(32)]
    out = []
    for orch_cls, pipeline in ((PPOOrchestrator, PromptPipeline(prompts, None, max_prompt_length=1)),
                               (JaxOrch, JaxPipeline(prompts, max_prompt_length=1))):
        cls = type("_Stream", (), {"chunks_per_unit": orch_cls.chunks_per_unit, "seek_chunks": orch_cls.seek_chunks,
                                   "_next_prompt_batch": orch_cls._next_prompt_batch})
        orch = cls()
        orch.pipeline, orch.chunk_size = pipeline, chunk_size
        orch.pipeline_loader = pipeline.create_loader(chunk_size, shuffle=True)
        orch.pipeline_iterator = iter(orch.pipeline_loader)
        orch._chunks_consumed = 0
        out.append(orch)
    return out


def _next_ids(orch):
    return np.asarray(orch._next_prompt_batch()["input_ids"]).copy()


def test_seek_chunks_reproduces_any_units_prompt_shard():
    """Any worker, at any time, rebuilds the exact prompt chunks of any unit
    (forward from scratch, backward by rebuilding the seeded loader, past an
    epoch wrap), and the port's schedule is the JAX orchestrator's."""
    a, ref = _orchestrators()
    schedule = [_next_ids(a) for _ in range(10)]
    assert all(np.array_equal(s, _next_ids(ref)) for s in schedule)
    assert a.chunks_per_unit(16) == 2 == ref.chunks_per_unit(16)  # ceil(16 rollouts / 8 a chunk)
    assert [a.chunks_per_unit(n) for n in (1, 8, 9, 17)] == [ref.chunks_per_unit(n) for n in (1, 8, 9, 17)]

    b, _ = _orchestrators()
    b.seek_chunks(3 * 2)  # a joiner seeks forward to unit 3's shard
    assert np.array_equal(_next_ids(b), schedule[6]) and np.array_equal(_next_ids(b), schedule[7])
    b.seek_chunks(1 * 2)  # a reclaimer seeks BACKWARD to unit 1's shard
    assert np.array_equal(_next_ids(b), schedule[2])
    a.seek_chunks(4)  # the original, past an epoch wrap, stays on the schedule
    assert np.array_equal(_next_ids(a), schedule[4])
    rng = np.random.default_rng(0)
    port, jax_orch = _orchestrators()
    for target in rng.integers(0, 12, size=20):
        port.seek_chunks(int(target))
        jax_orch.seek_chunks(int(target))
        assert np.array_equal(_next_ids(port), _next_ids(jax_orch))
        assert port._chunks_consumed == jax_orch._chunks_consumed


# ------------------------------------------------ colocated parity (fast)


def _run_ppo(task, ckpt_dir, fleet=False, elastic=False, steps=4, **method):
    _, logit_mask, metric_fn, reward_fn = task
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
    config.method.fleet_elastic = elastic
    for k, v in method.items():
        setattr(config.method, k, v)
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1]], metric_fn=metric_fn,
                                 config=config, logit_mask=logit_mask, device="cpu")
    with open(os.path.join(str(ckpt_dir), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return model, records


def test_colocated_elastic_staleness0_matches_non_elastic_bitwise(task, tmp_path):
    """Flipping method.fleet_elastic on the colocated staleness-0 fleet (every
    unit lease-claimed, seek-scheduled and unit-tagged) changes the run by
    nothing; the elastic records carry unit / worker / episode_key, the
    non-elastic ones keep the single-worker shape."""
    plain_model, plain = _run_ppo(task, tmp_path / "plain", fleet=True, max_staleness=0)
    model, elastic = _run_ppo(task, tmp_path / "elastic", fleet=True, elastic=True, max_staleness=0)
    losses_plain = [r["loss"] for r in plain if "loss" in r]
    assert len(losses_plain) == 4 and [r["loss"] for r in elastic if "loss" in r] == losses_plain
    for (n, p), (_, q) in zip(model.model.named_parameters(), plain_model.model.named_parameters()):
        assert torch.equal(p, q), n

    plain_dir = str(tmp_path / "plain") + "_fleet"
    elastic_dir = str(tmp_path / "elastic") + "_fleet"
    assert not os.path.exists(os.path.join(plain_dir, "leases"))
    stream_plain = read_jsonl_or_empty(os.path.join(plain_dir, "stream.jsonl"))
    assert stream_plain and all("unit" not in r for r in stream_plain)
    stream = read_jsonl_or_empty(os.path.join(elastic_dir, "stream.jsonl"))
    assert stream and [r["unit"] for r in stream] == [r["seq"] for r in stream]
    assert all(r["worker"] == 0 and r["episode_key"] for r in stream)
    paths = FleetPaths(root=elastic_dir)
    states = LeaseLedger(paths.leases_dir, ttl=60.0).units()
    assert sorted(states) == [r["unit"] for r in stream]
    assert all(x.status == "done" and x.gen == 0 for x in states.values())
    assert WorkerRegistry(paths.workers_dir).workers()[0]["status"] == "active"
    events = read_jsonl_or_empty(os.path.join(elastic_dir, "fleet_events.jsonl"))
    consumed = [e for e in events if e["event"] == "episode_consumed"]
    assert consumed and [e["unit"] for e in consumed] == sorted({e["unit"] for e in consumed})
    with open(os.path.join(elastic_dir, "learner_cursor.json")) as f:
        cursor = json.load(f)
    assert cursor["streams"]["0"] == cursor["consumed"]
    assert model._fleet_feed is None
    assert not any(t.name.startswith("trlx-") for t in threading.enumerate())


# --------------------------------------------------- multi-process drills


def _elastic_env(**extra):
    return {"ELASTIC": "1", **extra}


def _consumed_units(fleet_dir):
    return [e["unit"] for e in drill.events(fleet_dir) if e["event"] == "episode_consumed"]


def test_fleet_drill_worker_kill_mid_lease_exactly_once(tmp_path):
    """A learner and two workers; worker 0 dies right after claiming its first
    unit (lease held, nothing streamed; the JAX drill's @1 waits out its
    first compile, which the port's CPU run does not have, and with @1 the
    faster peer may take every unit the run needs). The survivor reclaims
    it at the next lease generation, and the learner consumes every unit
    exactly once, completes, and shuts the fleet down; the per-worker
    gauges and the /healthz workers block were scraped while it ran."""
    fleet_dir = tmp_path / "fleet"
    env = _elastic_env(TOTAL="16", EPOCHS="4", LEASE_TTL="1.0", HB_TIMEOUT="10")
    w0 = drill.launch("rollout", tmp_path / "ckpt_w0", fleet_dir, 1,
                      {**env, WORKER_ENV: "0", "TRLX_TPU_FAULTS": "worker_kill_mid_lease@0"})
    w1 = drill.launch("rollout", tmp_path / "ckpt_w1", fleet_dir, 1, {**env, WORKER_ENV: "1"})
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 1,
                               {**env, "TRLX_TPU_METRICS_PORT": str(drill.free_port())})
        out_l = drill.finish(learner)
        out_w0 = drill.finish(w0, timeout=60)
        out_w1 = drill.finish(w1, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert w0.returncode == 1, out_w0[-4000:]
        assert w1.returncode == 0, out_w1[-4000:]
        assert _consumed_units(fleet_dir) == [0, 1, 2, 3]
        events = drill.events(fleet_dir)
        reclaims = [e for e in events if e["event"] == "lease_reclaimed"]
        assert reclaims and all(e["gen"] >= 1 for e in reclaims) and any(e["worker"] == 1 for e in reclaims)
        ledger = LeaseLedger(FleetPaths(root=str(fleet_dir)).leases_dir, ttl=60.0)
        assert ledger.reclaimed_units()
        assert {e["worker"] for e in events if e["event"] == "worker_registered"} == {0, 1}
        producers = {e["worker"] for e in events if e["event"] == "episode_consumed"}
        assert producers <= {0, 1} and 1 in producers
        with open(fleet_dir / "abort.json") as f:
            assert json.load(f)["reason"] == "complete"
        with open(tmp_path / "ckpt_l" / "scrape_metrics.txt") as f:
            body = f.read()
        assert 'trlx_tpu_fleet_worker_state{worker="0"}' in body
        assert 'trlx_tpu_fleet_worker_state{worker="1"}' in body
        assert 'trlx_tpu_fleet_worker_heartbeat_age{worker="' in body
        assert "trlx_tpu_fleet_units_reclaimed_total" in body
        with open(tmp_path / "ckpt_l" / "scrape_workers.json") as f:
            block = json.load(f)
        for wid, w in block["workers"].items():
            assert wid in ("0", "1")
            assert {"state", "heartbeat_age", "leases_held", "incarnation"} <= set(w)
        drill.assert_clean_threads(out_l, "learner")
        drill.assert_clean_threads(out_w1, "worker1")
    finally:
        drill.kill_all(w0, w1)


def test_fleet_drill_slow_worker_reclaim_dedups_exactly_once(tmp_path):
    """Worker 0 outsleeps its lease TTL holding its first unit (@0: the
    run's units are all needed, so the peer must reclaim it); the peer
    reclaims and produces it, then the sleeper produces it AGAIN. Two
    records land for one unit with one prompt-shard key, and the learner
    consumes exactly one."""
    fleet_dir = tmp_path / "fleet"
    env = _elastic_env(TOTAL="24", EPOCHS="6", LEASE_TTL="1.0", HB_TIMEOUT="10", REWARD_SLEEP="0.2")
    w0 = drill.launch("rollout", tmp_path / "ckpt_w0", fleet_dir, 1,
                      {**env, WORKER_ENV: "0", "TRLX_TPU_FAULTS": "slow_worker_reclaim@0",
                       "TRLX_TPU_SLOW_WORKER_SECONDS": "1.8"})
    w1 = drill.launch("rollout", tmp_path / "ckpt_w1", fleet_dir, 1, {**env, WORKER_ENV: "1"})
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 1, env)
        out_l = drill.finish(learner)
        out_w0 = drill.finish(w0, timeout=60)
        out_w1 = drill.finish(w1, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert w0.returncode == 0, out_w0[-4000:]
        assert w1.returncode == 0, out_w1[-4000:]
        assert _consumed_units(fleet_dir) == list(range(6))
        reader = ElasticStreamReader(FleetPaths(root=str(fleet_dir)))
        assert reader.duplicates() >= 1
        dup_units = [u for u, recs in reader.by_unit().items() if len(recs) > 1]
        assert dup_units
        for u in dup_units:
            recs = reader.by_unit()[u]
            assert {r["worker"] for r in recs} == {0, 1}
            assert len({r["episode_key"] for r in recs}) == 1
        ledger = LeaseLedger(FleetPaths(root=str(fleet_dir)).leases_dir, ttl=60.0)
        assert set(dup_units) <= set(ledger.reclaimed_units())
        with open(fleet_dir / "abort.json") as f:
            assert json.load(f)["reason"] == "complete"
        drill.assert_clean_threads(out_l, "learner")
    finally:
        drill.kill_all(w0, w1)


def test_fleet_drill_worker_join_and_leave_mid_run(tmp_path):
    """Worker 0 produces two units, then deregisters cleanly; worker 1 defers
    registration until the learner's cursor reaches 2 (a mid-run join that
    adopts the LATEST broadcast) and carries the run to its end. Every unit
    is consumed exactly once across the membership change."""
    fleet_dir = tmp_path / "fleet"
    env = _elastic_env(TOTAL="24", EPOCHS="6", LEASE_TTL="5.0", HB_TIMEOUT="15")
    w0 = drill.launch("rollout", tmp_path / "ckpt_w0", fleet_dir, 1,
                      {**env, WORKER_ENV: "0", "TRLX_TPU_FLEET_LEAVE_AFTER": "2"})
    w1 = drill.launch("rollout", tmp_path / "ckpt_w1", fleet_dir, 1,
                      {**env, "TRLX_TPU_FAULTS": "worker_join_mid_run@2"})  # an auto-assigned id
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 1, env)
        out_l = drill.finish(learner)
        out_w0 = drill.finish(w0, timeout=60)
        out_w1 = drill.finish(w1, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert w0.returncode == 0, out_w0[-4000:]
        assert w1.returncode == 0, out_w1[-4000:]
        assert _consumed_units(fleet_dir) == list(range(6))
        events = drill.events(fleet_dir)
        left = [e for e in events if e["event"] == "worker_left"]
        assert len(left) == 1 and left[0]["worker"] == 0 and left[0]["produced"] == 2
        joins = [e for e in events if e["event"] == "worker_registered" and e["worker"] != 0]
        assert len(joins) == 1 and joins[0]["joined_at"] == 2 and joins[0]["cursor"] >= 2
        joiner = joins[0]["worker"]
        fetched = [e for e in events if e["event"] == "weights_fetched" and e.get("worker") == joiner]
        assert fetched and fetched[0]["ordinal"] >= 1  # the latest, not a historical one
        producers = {}
        for e in events:
            if e["event"] == "episode_consumed":
                producers[e["worker"]] = producers.get(e["worker"], 0) + 1
        assert producers == {0: 2, joiner: 4}
        reg = WorkerRegistry(FleetPaths(root=str(fleet_dir)).workers_dir).workers()
        assert reg[0]["status"] == "left" and reg[joiner]["status"] == "left"
        with open(fleet_dir / "abort.json") as f:
            assert json.load(f)["reason"] == "complete"
        drill.assert_clean_threads(out_l, "learner")
        drill.assert_clean_threads(out_w0, "worker0")
        drill.assert_clean_threads(out_w1, "worker1")
    finally:
        drill.kill_all(w0, w1)


def test_fleet_drill_all_workers_dead_degrades_cleanly(tmp_path):
    """The only worker dies holding a lease: the per-worker triage reads
    dead, the learner drains what landed, flips fleet/degraded on a live
    scrape, and exits 0, never a hang."""
    fleet_dir = tmp_path / "fleet"
    env = _elastic_env(TOTAL="100", EPOCHS="100", LEASE_TTL="1.0")
    w0 = drill.launch("rollout", tmp_path / "ckpt_w0", fleet_dir, 2,
                      {**env, WORKER_ENV: "0", "TRLX_TPU_FAULTS": "worker_kill_mid_lease@1"})
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 2,
                               {**env, "TRLX_TPU_METRICS_PORT": str(drill.free_port())})
        out_l = drill.finish(learner)
        drill.finish(w0, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert w0.returncode == 1
        assert "[fleet] learner stopped cleanly" in out_l
        degraded = [e for e in drill.events(fleet_dir) if e["event"] == "degraded"]
        assert degraded and degraded[0]["triage"] == "dead"
        with open(fleet_dir / "abort.json") as f:
            assert json.load(f)["reason"] in ("degraded", "stream_dry")
        with open(tmp_path / "ckpt_l" / "scrape_degraded.json") as f:
            scrape = json.load(f)
        assert scrape["fleet"]["disaggregated"]["state"] == "degraded"
        assert scrape["fleet"]["workers"]["0"]["state"] == "dead"
        drill.assert_clean_threads(out_l, "learner")
    finally:
        drill.kill_all(w0)


@pytest.mark.parametrize("route", ["chunked", "engine"])
def test_two_worker_staleness0_matches_serial_bitwise(tmp_path, route):
    """Two elastic workers at staleness 0 (units lease-serialized across two
    processes, episodes as npz, weights as byte leaves) reproduce the serial
    losses bitwise, on the chunked sampler and on the rollout engine (whose
    phase's sampling stream derives from the unit's absolute chunk index, so
    a unit samples alike on any worker)."""
    env = {"TOTAL": "12", "EPOCHS": "3", **({"ENGINE": "1"} if route == "engine" else {})}
    serial = drill.launch("serial", tmp_path / "ckpt_s", tmp_path / "unused", 0, env)
    out_s = drill.finish(serial)
    assert serial.returncode == 0, out_s[-4000:]
    fleet_dir = tmp_path / "fleet"
    env = _elastic_env(**env, LEASE_TTL="30", HB_TIMEOUT="10")
    w0 = drill.launch("rollout", tmp_path / "ckpt_w0", fleet_dir, 0, {**env, WORKER_ENV: "0"})
    w1 = drill.launch("rollout", tmp_path / "ckpt_w1", fleet_dir, 0, {**env, WORKER_ENV: "1"})
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 0, env)
        out_l = drill.finish(learner)
        out_w0 = drill.finish(w0, timeout=60)
        out_w1 = drill.finish(w1, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert w0.returncode == 0, out_w0[-4000:]
        assert w1.returncode == 0, out_w1[-4000:]
        assert drill.losses(out_s) == drill.losses(out_l) and len(drill.losses(out_s)) == 12
        consumed = [e for e in drill.events(fleet_dir) if e["event"] == "episode_consumed"]
        assert consumed and all(e["staleness"] == 0 for e in consumed)
        assert [e["unit"] for e in consumed] == list(range(len(consumed)))
        with open(fleet_dir / "abort.json") as f:
            assert json.load(f)["reason"] == "complete"
        drill.assert_clean_threads(out_l, "learner")
        drill.assert_clean_threads(out_w0, "worker0")
        drill.assert_clean_threads(out_w1, "worker1")
    finally:
        drill.kill_all(w0, w1)
