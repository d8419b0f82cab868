"""The fleet's transports and host logic in the port (``trlx_tpu_torch.fleet``)
against the JAX package (``trlx_tpu.fleet``): twins of the 30 tests of
``tests/test_fleet_stream.py``, each held to the JAX function on the same
inputs where one exists.

- Host logic held EQUAL (tolerance 0): ``validate_fleet_config``'s outcome
  (the role, or the exception type and message) for each config,
  ``resolve_role``, ``role_timeouts`` dicts, ``episode_key`` strings, the
  cursor fallbacks (``_read_cursor`` of both packages on one directory),
  ``staleness_gate_open`` and the fault plan's fleet kinds.
- The on-disk format is shared: what the port writes, the JAX package
  reads, bit for bit, and the other way round (episode batches, weight
  snapshots of bf16 and f32 leaves).
- The weight broadcast's round trip is bitwise for f32 and bf16 torch
  tensors; a count, size or dtype mismatch raises naming the first leaf.
"""

import dataclasses
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu.fleet as jfleet  # noqa: E402
import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.fleet.runner import _read_cursor as jax_read_cursor  # noqa: E402
from trlx_tpu.pipeline.overlap import staleness_gate_open as jax_gate  # noqa: E402
from trlx_tpu.resilience.faults import FaultPlan as JaxFaultPlan  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.fleet import (  # noqa: E402
    ElasticStreamReader,
    EpisodeStreamReader,
    EpisodeStreamTimeout,
    EpisodeStreamWriter,
    FleetPaths,
    WeightPublisher,
    WeightSubscriber,
    episode_key,
    fleet_paths,
    put_leaves,
    resolve_role,
    role_timeouts,
    validate_fleet_config,
)
from trlx_tpu_torch.fleet.runner import _read_cursor  # noqa: E402
from trlx_tpu_torch.fleet.topology import ROLE_ENV, WORKER_ENV, read_jsonl_or_empty  # noqa: E402
from trlx_tpu_torch.pipeline.overlap import staleness_gate_open  # noqa: E402
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage  # noqa: E402
from trlx_tpu_torch.resilience.faults import FaultPlan  # noqa: E402


def _configs(**train):
    """(JAX config, port config) of the randomwalks PPO task, train knobs
    overridden on both."""
    jcfg = base_config("ppo", 15, 8)
    for k, v in train.items():
        setattr(jcfg.train, k, v)
    pcfg = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    return jcfg, pcfg


def _config(**train):
    return _configs(**train)[1]


def _set_method(cfgs, **method):
    for c in cfgs:
        for k, v in method.items():
            setattr(c.method, k, v)
    return cfgs


def _outcome(fn, config):
    try:
        return ("ok", fn(config))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e))


def _same_outcome(jcfg, pcfg):
    """Both validators on the same config: equal role, or equal exception
    type and message. Returns the outcome."""
    got, ref = _outcome(validate_fleet_config, pcfg), _outcome(jfleet.validate_fleet_config, jcfg)
    assert got == ref
    return got


# ------------------------------------------------- construction-time checks


def test_stray_fleet_knob_without_disaggregate_is_a_config_error():
    jcfg, pcfg = _configs(fleet_episode_timeout=30.0)
    kind, msg = _same_outcome(jcfg, pcfg)
    assert kind == "ValueError" and "fleet_episode_timeout" in msg and "fleet_disaggregate" in msg


def test_stray_role_env_without_disaggregate_is_a_config_error(monkeypatch):
    monkeypatch.setenv(ROLE_ENV, "rollout")
    kind, msg = _same_outcome(*_configs())
    assert kind == "ValueError" and ROLE_ENV in msg


def test_no_fleet_config_validates_to_none(monkeypatch):
    monkeypatch.delenv(ROLE_ENV, raising=False)
    assert _same_outcome(*_configs()) == ("ok", None)


def test_role_resolution_env_wins_over_config(monkeypatch):
    jcfg, pcfg = _set_method(_configs(fleet_role="learner"), fleet_disaggregate=True)
    monkeypatch.delenv(ROLE_ENV, raising=False)
    assert resolve_role(pcfg) == jfleet.resolve_role(jcfg) == "learner"
    assert _same_outcome(jcfg, pcfg) == ("ok", "learner")
    monkeypatch.setenv(ROLE_ENV, "rollout")
    assert resolve_role(pcfg) == jfleet.resolve_role(jcfg) == "rollout"
    assert _same_outcome(jcfg, pcfg) == ("ok", "rollout")


def test_fleet_without_role_is_colocated(monkeypatch):
    monkeypatch.delenv(ROLE_ENV, raising=False)
    assert _same_outcome(*_set_method(_configs(), fleet_disaggregate=True)) == ("ok", "colocated")


def test_unknown_role_rejected(monkeypatch):
    monkeypatch.delenv(ROLE_ENV, raising=False)
    kind, msg = _same_outcome(*_set_method(_configs(fleet_role="replayer"), fleet_disaggregate=True))
    assert kind == "ValueError" and "replayer" in msg


def test_fleet_and_rollout_overlap_are_mutually_exclusive(monkeypatch):
    monkeypatch.delenv(ROLE_ENV, raising=False)
    kind, msg = _same_outcome(*_set_method(_configs(), fleet_disaggregate=True, rollout_overlap=True))
    assert kind == "ValueError" and "mutually exclusive" in msg


_SWEEP_TRAIN = [{}, {"fleet_dir": "f"}, {"fleet_role": "learner"}, {"fleet_role": "rollout"},
                {"fleet_role": "bogus"}, {"fleet_lease_ttl": 2.0}, {"fleet_broadcast_deadline": 9.0}]
_SWEEP_METHOD = [{}, {"fleet_disaggregate": True}, {"fleet_elastic": True},
                 {"fleet_disaggregate": True, "fleet_elastic": True},
                 {"fleet_disaggregate": True, "rollout_overlap": True}]
_SWEEP_ENV = [{}, {ROLE_ENV: "learner"}, {ROLE_ENV: "x"}, {WORKER_ENV: "2"}, {WORKER_ENV: "-1"},
              {ROLE_ENV: "rollout", WORKER_ENV: "0"}]


@pytest.mark.parametrize("env", range(len(_SWEEP_ENV)))
def test_validation_sweep_equals_jax(monkeypatch, env):
    """Every (train knobs × method knobs) pair under one environment: the
    port's validation has the JAX package's outcome, role or exception
    type and message."""
    for var in (ROLE_ENV, WORKER_ENV):
        monkeypatch.delenv(var, raising=False)
    for var, value in _SWEEP_ENV[env].items():
        monkeypatch.setenv(var, value)
    seen = set()
    for train in _SWEEP_TRAIN:
        for method in _SWEEP_METHOD:
            seen.add(_same_outcome(*_set_method(_configs(**train), **method))[0])
    assert "ValueError" in seen


def test_role_world_of_several_processes(monkeypatch):
    """A fleet over a world of several processes: without an explicit role
    the JAX package's ValueError, word for word; with one, the role world is
    accepted as the JAX package accepts it (its transports on rank 0)."""
    import jax

    import trlx_tpu_torch.fleet.topology as topology

    monkeypatch.delenv(ROLE_ENV, raising=False)
    monkeypatch.setattr(topology, "world_size", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    kind, msg = _same_outcome(*_set_method(_configs(), fleet_disaggregate=True))
    assert kind == "ValueError" and "explicit role" in msg
    jcfg, pcfg = _set_method(_configs(fleet_role="learner"), fleet_disaggregate=True)
    assert jfleet.validate_fleet_config(jcfg) == validate_fleet_config(pcfg) == "learner"


def test_trainer_constructor_rejects_stray_fleet_knobs(tmp_path):
    """The error surfaces from trainer construction inside
    ``trlx_tpu_torch.train``, before any training work."""
    _, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=10, seed=1000)
    config = _config(fleet_dir=str(tmp_path / "fleet"), checkpoint_dir=str(tmp_path / "ckpt"))
    config.train.batch_size = 16
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    with pytest.raises(ValueError, match="fleet_dir"):
        trlx_tpu_torch.train(reward_fn=reward_fn, prompts=[[1], [2]], eval_prompts=[[1]], metric_fn=metric_fn,
                             config=config, logit_mask=logit_mask, device="cpu")
    assert not os.path.exists(tmp_path / "fleet")


# ------------------------------------------------------------ path contract


def test_fleet_paths_layout_and_abort(tmp_path):
    paths = FleetPaths(root=str(tmp_path / "fleet")).ensure()
    ref = jfleet.FleetPaths(root=str(tmp_path / "fleet"))
    assert os.path.isdir(paths.episodes_dir)
    assert os.path.isdir(paths.weights_dir)
    assert os.path.isdir(paths.heartbeats_dir)
    for name in ("episodes_dir", "weights_dir", "heartbeats_dir", "leases_dir", "workers_dir", "stream_index",
                 "broadcast_log", "latest_pointer", "cursor", "abort", "events"):
        assert getattr(paths, name) == getattr(ref, name), name
    for seq, worker in ((3, 0), (3, 2), (117, 12)):
        assert paths.episode_file(seq, worker) == ref.episode_file(seq, worker)
        assert paths.stream_index_for(worker) == ref.stream_index_for(worker)
    assert paths.episode_file(3).endswith("batch_000003.npz")
    assert paths.weight_file(7).endswith("weights_00000007.npz") and paths.weight_file(7) == ref.weight_file(7)
    assert paths.read_abort() is None
    with open(paths.abort, "w") as f:
        f.write('{"reason": "compl')  # torn write mid-flight
    assert paths.read_abort() is None and ref.read_abort() is None
    with open(paths.abort, "w") as f:
        json.dump({"reason": "complete"}, f)
    assert paths.read_abort()["reason"] == "complete" == ref.read_abort()["reason"]


def test_fleet_paths_default_root_is_under_checkpoint_dir(tmp_path):
    jcfg, pcfg = _configs(checkpoint_dir=str(tmp_path / "ckpt"))
    assert fleet_paths(pcfg.train).root == str(tmp_path / "ckpt" / "fleet") == jfleet.fleet_paths(jcfg.train).root
    jcfg, pcfg = _configs(fleet_dir=str(tmp_path / "shared"))
    assert fleet_paths(pcfg.train).root == str(tmp_path / "shared") == jfleet.fleet_paths(jcfg.train).root


def test_read_jsonl_or_empty_tolerates_absence_and_torn_tail(tmp_path):
    from trlx_tpu.fleet.topology import read_jsonl_or_empty as jax_read

    path = str(tmp_path / "log.jsonl")
    assert read_jsonl_or_empty(path) == [] == jax_read(path)
    with open(path, "w") as f:
        f.write('{"seq": 0}\n{"seq": 1}\n{"seq": 2')  # torn tail
    assert [r["seq"] for r in read_jsonl_or_empty(path)] == [0, 1] == [r["seq"] for r in jax_read(path)]


# ---------------------------------------------------------- episode stream


def _columns(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "query_tensors": rng.integers(0, 15, (n, 3)).astype(np.int32),
        "query_mask": np.ones((n, 3), np.int32),
        "response_tensors": rng.integers(0, 15, (n, 5)).astype(np.int32),
        "response_mask": np.ones((n, 5), np.int32),
        "logprobs": rng.standard_normal((n, 5)).astype(np.float32),
        "values": rng.standard_normal((n, 5)).astype(np.float32),
        "rewards": rng.standard_normal((n, 5)).astype(np.float32),
    }


def test_stream_roundtrip_is_bitwise_and_indexed(tmp_path):
    """The port's writer → the port's and the JAX package's readers, and the
    JAX writer → the port's reader: every column bitwise, same dtype."""
    cols = _columns()
    for writer_pkg in ("torch", "jax"):
        root = str(tmp_path / writer_pkg)
        if writer_pkg == "torch":
            assert EpisodeStreamWriter(FleetPaths(root=root).ensure()).append(cols, weight_version=12) == 0
        else:
            jwriter = jfleet.EpisodeStreamWriter(jfleet.FleetPaths(root=root).ensure())
            assert jwriter.append(cols, weight_version=12) == 0
        for reader in (EpisodeStreamReader(FleetPaths(root=root)),
                       jfleet.EpisodeStreamReader(jfleet.FleetPaths(root=root))):
            rec = reader.poll(0)
            assert rec["n"] == 4 and rec["weight_version"] == 12
            got = reader.load(rec)
            assert set(got) == set(cols)
            for k in cols:
                assert got[k].dtype == cols[k].dtype
                assert np.array_equal(got[k], cols[k])


def test_stream_columns_rebuild_a_storage_bitwise(tmp_path):
    """The wire format IS ``PPORolloutStorage.columns()``: round-tripping it
    through the stream and ``push_batch`` rebuilds an identical store,
    staleness column included."""
    store = PPORolloutStorage(pad_token_id=0, record_staleness=True)
    store.push_batch(_columns(seed=3))
    cols = store.columns()
    paths = FleetPaths(root=str(tmp_path)).ensure()
    EpisodeStreamWriter(paths).append(cols, weight_version=0)
    reader = EpisodeStreamReader(paths)
    rebuilt = PPORolloutStorage(pad_token_id=0, record_staleness=True)
    rebuilt.push_batch(reader.load(reader.poll(0)))
    got = rebuilt.columns()
    assert set(got) == set(cols) and "staleness" in got
    for k in cols:
        assert np.array_equal(got[k], cols[k])


def test_stream_writer_resumes_seq_numbering(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure()
    writer = EpisodeStreamWriter(paths)
    writer.append(_columns(), weight_version=0)
    writer.append(_columns(), weight_version=0)
    # A restarted worker continues from the index, never clobbers.
    ref = jfleet.EpisodeStreamWriter(jfleet.FleetPaths(str(tmp_path)))
    assert EpisodeStreamWriter(paths).next_seq == 2 == ref.next_seq


def test_stream_reader_queued_from_cursor(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure()
    writer = EpisodeStreamWriter(paths)
    for _ in range(4):
        writer.append(_columns(), weight_version=0)
    reader = EpisodeStreamReader(paths)
    ref = jfleet.EpisodeStreamReader(jfleet.FleetPaths(str(tmp_path)))
    assert [r["seq"] for r in reader.queued_from(2)] == [2, 3] == [r["seq"] for r in ref.queued_from(2)]
    assert reader.queued_from(9) == [] == ref.queued_from(9)


def test_stream_wait_times_out_through_retry_wrapper(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure()
    reader = EpisodeStreamReader(paths)
    start = time.monotonic()
    with pytest.raises(EpisodeStreamTimeout, match="seq=5"):
        reader.wait(5, timeout=0.15, retries=1, backoff=0.01)
    # 2 attempts x ~0.15 s + backoff, bounded: no hang, no watchdog thread.
    assert time.monotonic() - start < 5.0


def test_stream_wait_returns_when_batch_lands(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure()
    EpisodeStreamWriter(paths).append(_columns(), weight_version=7)
    rec = EpisodeStreamReader(paths).wait(0, timeout=1.0, retries=0, backoff=0.0)
    assert rec["weight_version"] == 7


# --------------------------------------------------------- weight broadcast


def _params():
    return {
        "w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4) / 7,
        "b": torch.linspace(-1.0, 1.0, 5, dtype=torch.float32),
    }


def _raw(t) -> np.ndarray:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def test_broadcast_roundtrip_is_bitwise_even_for_bfloat16(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure()
    params = _params()
    pub = WeightPublisher(paths)
    assert pub.publish(params, version=4, meta={"kl_coef": 0.125}) == 0
    assert pub.last_stats["bytes"] == 12 * 2 + 5 * 4 and pub.last_stats["leaves"] == 2
    sub = WeightSubscriber(paths)
    latest = sub.latest()
    assert latest["ordinal"] == 0 and latest["version"] == 4
    # Lockstep scalars ride the pointer with the weights.
    assert latest["kl_coef"] == 0.125
    # In place: the template's own tensors take the bytes (addresses kept).
    dest = {k: torch.zeros_like(v) for k, v in params.items()}
    ptrs = {k: v.data_ptr() for k, v in dest.items()}
    got = put_leaves(dest, sub.load(latest))
    for k in params:
        assert got[k] is dest[k] and dest[k].data_ptr() == ptrs[k]
        assert got[k].dtype == params[k].dtype and got[k].shape == params[k].shape
        assert np.array_equal(_raw(got[k]), _raw(params[k])), f"leaf {k} not bitwise"


def test_broadcast_bytes_cross_packages_bitwise(tmp_path):
    """A JAX publish of bf16 and f32 leaves loads into torch tensors bit for
    bit, and a port publish into the JAX package's parameter tree."""
    jparams = {"b": jnp.linspace(-1.0, 1.0, 5, dtype=jnp.float32),
               "w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7}
    jfleet.WeightPublisher(jfleet.FleetPaths(str(tmp_path / "j")).ensure()).publish(jparams, version=1)
    sub = WeightSubscriber(FleetPaths(str(tmp_path / "j")))
    # tree_leaves order is sorted by key: "b" then "w".
    template = [("b", torch.zeros(5, dtype=torch.float32)), ("w", torch.zeros(3, 4, dtype=torch.bfloat16))]
    got = put_leaves(template, sub.load(sub.latest()))
    for k in ("b", "w"):
        assert np.array_equal(_raw(got[k]), np.asarray(jparams[k]).reshape(-1).view(np.uint8))
    WeightPublisher(FleetPaths(str(tmp_path / "t")).ensure()).publish([("b", got["b"]), ("w", got["w"])], version=2)
    jsub = jfleet.WeightSubscriber(jfleet.FleetPaths(str(tmp_path / "t")))
    back = jfleet.put_leaves(jparams, jsub.load(jsub.latest()))
    for k in ("b", "w"):
        assert np.array_equal(np.asarray(back[k]).view(np.uint8), np.asarray(jparams[k]).view(np.uint8))


def test_put_leaves_rejects_mismatched_trees(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure()
    params = _params()
    WeightPublisher(paths).publish(params, version=0)
    sub = WeightSubscriber(paths)
    leaves = sub.load(sub.latest())
    with pytest.raises(ValueError, match="leaf-count mismatch"):
        put_leaves({"w": params["w"]}, leaves)
    wrong = {"w": torch.zeros_like(params["w"]), "b": torch.zeros(9, dtype=torch.float32)}
    with pytest.raises(ValueError, match="size mismatch"):
        put_leaves(wrong, leaves)
    assert not wrong["w"].any()  # nothing written before the mismatch was found


def test_broadcast_timeout_fault_skips_snapshot_but_logs_ordinal(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure()
    plan = FaultPlan.parse("broadcast_timeout@1")
    pub = WeightPublisher(paths, fault_plan=plan)
    params = _params()
    pub.publish(params, version=0)
    pub.publish(params, version=1)  # injected: no file, the pointer stays put
    pub.publish(params, version=2)
    records = read_jsonl_or_empty(paths.broadcast_log)
    assert [r["status"] for r in records] == ["published", "injected_timeout", "published"]
    assert [r["ordinal"] for r in records] == [0, 1, 2]
    assert not os.path.exists(paths.weight_file(1))
    assert WeightSubscriber(paths).latest()["ordinal"] == 2
    assert [r["ordinal"] for r in pub.published()] == [0, 2]
    # Dense resume: injected ordinals still consumed a slot, in both packages.
    ref = jfleet.WeightPublisher(jfleet.FleetPaths(str(tmp_path)))
    assert WeightPublisher(paths).next_ordinal == 3 == ref.next_ordinal


# ------------------------------------------------- gate / faults / timeouts


def test_staleness_gate_predicate_is_shared_and_exact():
    # seq - consumed <= S: the same predicate gates the in-process producer
    # and the fleet's worker, in both packages.
    assert staleness_gate_open(0, 0, 0)
    assert not staleness_gate_open(1, 0, 0)
    assert staleness_gate_open(3, 1, 2)
    assert not staleness_gate_open(4, 1, 2)
    assert staleness_gate_open(5, 5, -3)  # negative caps clamp to 0
    rng = np.random.default_rng(0)
    for _ in range(500):
        seq, consumed, cap = (int(x) for x in rng.integers(-4, 12, size=3))
        assert staleness_gate_open(seq, consumed, cap) == jax_gate(seq, consumed, cap)


def test_fault_plan_parses_fleet_kinds():
    spec = "rollout_host_kill@3,broadcast_timeout@1,episode_stream_stall@2"
    for cls in (FaultPlan, JaxFaultPlan):
        plan = cls.parse(spec)
        assert plan.fire("rollout_host_kill", 3)
        assert not plan.fire("rollout_host_kill", 3)  # one-shot
        assert plan.fire("broadcast_timeout", 1)
        assert plan.fire("episode_stream_stall", 2)
        with pytest.raises(ValueError):
            cls.parse("rollout_host_explode@1")
    # Fired by the port's fleet now: none of the eight is left unfired.
    assert FaultPlan.parse(spec + ",weight_push_torn@1,version_switch_storm@1,worker_kill_mid_lease@1,"
                                  "slow_worker_reclaim@1,worker_join_mid_run@1").unfired_kinds() == []


def test_role_timeouts_resolve_documented_defaults():
    jcfg, pcfg = _configs()
    got = role_timeouts(pcfg.train)
    assert got == jfleet.role_timeouts(jcfg.train)
    assert got["heartbeat_interval"] == 0.5
    assert got["episode_timeout"] == 60.0
    assert got["stream_retries"] == 2
    assert got["stream_backoff"] == 0.5
    assert got["heartbeat_timeout"] == 10.0
    assert got["broadcast_deadline"] == 60.0
    knobs = dict(heartbeat_interval=2.0, fleet_episode_timeout=5.0, fleet_stream_retries=4, fleet_stream_backoff=0.1,
                 fleet_heartbeat_timeout=9.0, collective_deadline=45.0)
    jcfg, pcfg = _configs(**knobs)
    got = role_timeouts(pcfg.train)
    assert got == jfleet.role_timeouts(jcfg.train)
    assert got["heartbeat_interval"] == 2.0
    assert got["episode_timeout"] == 5.0
    assert got["stream_retries"] == 4
    assert got["stream_backoff"] == 0.1
    assert got["heartbeat_timeout"] == 9.0
    # The fleet deadline falls back to the collective deadline before 60 s.
    assert got["broadcast_deadline"] == 45.0
    rng = np.random.default_rng(1)
    for _ in range(50):
        knobs = {k: float(rng.choice([0.0, rng.uniform(0.1, 30)])) for k in (
            "heartbeat_interval", "fleet_episode_timeout", "fleet_stream_backoff", "fleet_heartbeat_timeout",
            "fleet_broadcast_deadline", "collective_deadline", "fleet_lease_ttl")}
        knobs["fleet_stream_retries"] = int(rng.integers(0, 5))
        jcfg, pcfg = _configs(**knobs)
        assert role_timeouts(pcfg.train) == jfleet.role_timeouts(jcfg.train), knobs


# -------------------------------------- in-flight weight updates, cursors


def test_cursor_torn_read_falls_back_to_last_indexed_seq(tmp_path):
    """A PRESENT-but-garbage cursor must NOT read as 0; the fallback is 1 +
    the last indexed seq (at-most-once); a MISSING cursor is 0. Both
    packages read one directory alike."""
    paths = FleetPaths(root=str(tmp_path)).ensure()
    ref = jfleet.FleetPaths(root=str(tmp_path))
    assert _read_cursor(paths) == 0 == jax_read_cursor(ref)  # missing = fresh fleet
    writer = EpisodeStreamWriter(paths)
    for _ in range(3):
        writer.append(_columns(), weight_version=0)
    with open(paths.cursor, "w") as f:
        f.write('{"consu')  # torn write mid-flight
    assert _read_cursor(paths) == 3 == jax_read_cursor(ref)  # 1 + max indexed seq (2)
    with open(paths.cursor, "w") as f:
        json.dump({"consumed": 1}, f)
    assert _read_cursor(paths) == 1 == jax_read_cursor(ref)  # an intact cursor wins over the index


def test_elastic_cursor_resumes_over_interleaved_stream_files(tmp_path):
    """The unit cursor is the single authority across N interleaved
    per-worker stream files."""
    paths = FleetPaths(root=str(tmp_path)).ensure_elastic()
    w0 = EpisodeStreamWriter(paths, worker=0)
    w1 = EpisodeStreamWriter(paths, worker=1)
    w0.append(_columns(seed=0), weight_version=0, unit=0)
    w1.append(_columns(seed=1), weight_version=0, unit=1)
    w0.append(_columns(seed=2), weight_version=1, unit=2)
    w1.append(_columns(seed=3), weight_version=1, unit=3)
    reader = ElasticStreamReader(paths)
    ref = jfleet.ElasticStreamReader(jfleet.FleetPaths(str(tmp_path)))
    assert sorted(reader.chosen()) == [0, 1, 2, 3] == sorted(ref.chosen())
    assert reader.duplicates() == 0 == ref.duplicates()
    assert reader.by_unit() == ref.by_unit()
    # Per-worker seqs restart at 0 in each file; units stay globally unique.
    assert [r["seq"] for r in reader.indexes()[1]] == [0, 1]
    with open(paths.cursor, "w") as f:
        json.dump({"consumed": 3, "ordinal": 2, "streams": {"0": 2, "1": 1}}, f)
    assert _read_cursor(paths) == 3 == jax_read_cursor(jfleet.FleetPaths(str(tmp_path)))


def test_elastic_cursor_torn_read_falls_back_over_all_stream_files(tmp_path):
    paths = FleetPaths(root=str(tmp_path)).ensure_elastic()
    ref = jfleet.FleetPaths(root=str(tmp_path))
    w0 = EpisodeStreamWriter(paths, worker=0)
    w1 = EpisodeStreamWriter(paths, worker=1)
    w0.append(_columns(seed=0), weight_version=0, unit=0)
    w1.append(_columns(seed=1), weight_version=0, unit=1)
    w1.append(_columns(seed=2), weight_version=1, unit=4)  # the peer holds the max
    with open(paths.cursor, "w") as f:
        f.write('{"consumed": 2, "stre')  # torn write mid-flight
    assert _read_cursor(paths) == 5 == jax_read_cursor(ref)  # 1 + max unit over ALL indexes
    os.remove(paths.cursor)
    assert _read_cursor(paths) == 0 == jax_read_cursor(ref)


def test_elastic_reader_dedupes_reclaim_races_by_unit(tmp_path):
    """Two records of one unit: chosen() keeps the first to land,
    duplicates() counts the loser, and both carry the same prompt-shard
    key, the JAX package's key for the same columns."""
    paths = FleetPaths(root=str(tmp_path)).ensure_elastic()
    cols = _columns(seed=7)
    w0 = EpisodeStreamWriter(paths, worker=0)
    w1 = EpisodeStreamWriter(paths, worker=1)
    w1.append(cols, weight_version=0, unit=0)  # the reclaimer lands first
    time.sleep(0.01)
    w0.append(cols, weight_version=1, unit=0)  # the slow owner lands late
    reader = ElasticStreamReader(paths)
    assert reader.duplicates() == 1
    chosen = reader.chosen()[0]
    assert chosen["worker"] == 1
    records = reader.by_unit()[0]
    assert {r["episode_key"] for r in records} == {episode_key(cols)} == {jfleet.episode_key(cols)}
    got = reader.load(chosen)
    assert all(np.array_equal(got[k], cols[k]) for k in cols)
    rng = np.random.default_rng(2)
    for seed in range(20):
        c = _columns(n=int(rng.integers(1, 9)), seed=seed)
        assert episode_key(c) == jfleet.episode_key(c)


def test_put_leaves_names_first_dtype_mismatched_leaf(tmp_path):
    """A same-shape dtype misconfig (f32 learner to a bf16 rollout world)
    fails NAMING the first mismatched leaf."""
    paths = FleetPaths(root=str(tmp_path)).ensure()
    params = _params()
    WeightPublisher(paths).publish(params, version=0)
    sub = WeightSubscriber(paths)
    leaves = sub.load(sub.latest())
    wrong = {"w": params["w"], "b": params["b"].to(torch.bfloat16)}
    with pytest.raises(ValueError, match=r"leaf size mismatch at param leaf") as e:
        put_leaves(wrong, leaves)
    assert "'b'" in str(e.value)
    assert "dtype mismatch" in str(e.value)


def test_torn_publish_is_rejected_by_try_load_but_raises_from_load(tmp_path):
    """weight_push_torn: the latest pointer names the torn ordinal,
    ``try_load`` treats it as not there, ``load`` raises, and the previous
    intact ordinal still loads."""
    paths = FleetPaths(root=str(tmp_path)).ensure()
    params = _params()
    pub = WeightPublisher(paths, fault_plan=FaultPlan.parse("weight_push_torn@1"))
    pub.publish(params, version=0)
    pub.publish(params, version=1)  # injected: the pointer flips, the file is truncated
    statuses = [r["status"] for r in read_jsonl_or_empty(paths.broadcast_log)]
    assert statuses == ["published", "published", "injected_torn"]
    sub = WeightSubscriber(paths)
    latest = sub.latest()
    assert latest["ordinal"] == 1  # the pointer DID flip before the tear
    assert sub.try_load(latest) is None
    assert jfleet.WeightSubscriber(jfleet.FleetPaths(str(tmp_path))).try_load(latest) is None
    with pytest.raises(Exception):
        sub.load(latest)
    intact = [r for r in pub.published() if r["ordinal"] == 0][0]
    got = sub.try_load(intact)
    assert got is not None and len(got) == 2


def test_stream_index_records_version_spans_only_when_given(tmp_path):
    """No spans argument → no key at all; spans given → [[v, n], ...] of
    plain ints."""
    paths = FleetPaths(root=str(tmp_path)).ensure()
    writer = EpisodeStreamWriter(paths)
    writer.append(_columns(), weight_version=5)
    writer.append(_columns(), weight_version=7, version_spans=[(np.int64(6), 5), (7, 2)])
    recs = read_jsonl_or_empty(paths.stream_index)
    assert "version_spans" not in recs[0]
    assert recs[1]["version_spans"] == [[6, 5], [7, 2]]
    assert all(isinstance(v, int) for span in recs[1]["version_spans"] for v in span)
