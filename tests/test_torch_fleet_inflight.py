"""In-flight weight updates of the port's fleet (``trlx_tpu_torch.fleet`` with
``method.fleet_inflight_weights`` on the rollout engine): twins of the
in-flight drills of ``tests/test_fleet_disagg.py``, each a learner process
and a rollout-worker process under a hard wall limit.

- ``weight_push_torn@2`` on the learner: the worker rejects the torn ordinal
  (in flight and at the phase boundary), keeps decoding on the version it
  holds and moves past it onto a later intact ordinal; every streamed
  version, and every version span, is a published one.
- ``version_switch_storm@3`` on the worker: re-pushes of the held version
  record no switch, so the engine's switch count stays bounded by the
  distinct versions adopted in flight, and spans stay strictly increasing.
- Two processes at staleness 0: with the knob on, the learner's losses
  equal the knob-off run's bitwise, and every stream record carries one
  span naming its own version.
- The engine's coalescing, in process: a burst of pushes between two syncs
  keeps only the newest, same-version re-pushes record no switch, and the
  spans of an episode that straddles a push are clamped to its tokens, as
  the JAX engine's are (the same spans for seeded switch lists).
"""

import os
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_fleet_drill as drill  # noqa: E402
from trlx_tpu.engine.rollout_engine import RolloutEngine as JaxRolloutEngine  # noqa: E402
from trlx_tpu_torch.engine.rollout_engine import RolloutEngine  # noqa: E402

torch.set_num_threads(1)

_ENGINE_ENV = {"ENGINE": "1", "ENGINE_SYNC": "2", "INFLIGHT": "1"}


def test_fleet_drill_weight_push_torn_rejects_and_holds_old_version(tmp_path):
    fleet_dir = tmp_path / "fleet"
    # Six iterations: ordinals 0-5 are published, so the worker has intact
    # ordinals after the torn one to move onto.
    env = {"TOTAL": "24", "EPOCHS": "6", **_ENGINE_ENV}
    # A slow reward keeps the worker behind the learner, so it meets the
    # torn pointer at a phase boundary or mid-phase, not inside a wait.
    worker = drill.launch("rollout", tmp_path / "ckpt_w", fleet_dir, 2, {**env, "REWARD_SLEEP": "0.3"})
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 2,
                               {**env, "TRLX_TPU_FAULTS": "weight_push_torn@2"})
        out_l = drill.finish(learner)
        out_w = drill.finish(worker, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert worker.returncode == 0, out_w[-4000:]
        broadcast = drill.read_jsonl(fleet_dir / "broadcast.jsonl")
        assert [r["ordinal"] for r in broadcast if r["status"] == "injected_torn"] == [2]
        events = drill.events(fleet_dir)
        rejected = [e for e in events if e["event"] == "weights_torn"]
        assert rejected, "the torn snapshot was never observed and rejected by the worker"
        assert all(e["ordinal"] == 2 and e["held"] < 2 for e in rejected)
        adopted = [e["ordinal"] for e in events if e["event"] in ("weights_adopted_inflight", "weights_fetched")]
        assert adopted and max(adopted) >= 3 and 2 not in adopted
        stream = drill.read_jsonl(fleet_dir / "stream.jsonl")
        published = {r["version"] for r in broadcast if r["status"] == "published"}
        assert stream and {r["weight_version"] for r in stream} <= published
        for r in stream:
            for v, k in r.get("version_spans") or []:
                assert v in published and k > 0
        drill.assert_clean_threads(out_l, "learner")
        drill.assert_clean_threads(out_w, "worker")
    finally:
        drill.kill_all(worker)


def test_fleet_drill_version_switch_storm_coalesces_never_queues(tmp_path):
    fleet_dir = tmp_path / "fleet"
    env = {"TOTAL": "8", "EPOCHS": "4", **_ENGINE_ENV}
    worker = drill.launch("rollout", tmp_path / "ckpt_w", fleet_dir, 2,
                          {**env, "TRLX_TPU_FAULTS": "version_switch_storm@3", "TRLX_TPU_SWITCH_STORM_PUSHES": "6",
                           "REWARD_SLEEP": "0.3"})
    try:
        learner = drill.launch("learner", tmp_path / "ckpt_l", fleet_dir, 2, env)
        out_l = drill.finish(learner)
        out_w = drill.finish(worker, timeout=60)
        assert learner.returncode == 0, out_l[-4000:]
        assert worker.returncode == 0, out_w[-4000:]
        events = drill.events(fleet_dir)
        adoptions = [e for e in events if e["event"] == "weights_adopted_inflight"]
        metrics = drill.read_jsonl(tmp_path / "ckpt_w" / "metrics.jsonl")
        assert any("engine/weight_switches" in r for r in metrics)
        switches = sum(int(r.get("engine/weight_switches", 0)) for r in metrics)
        assert switches <= len(adoptions)
        stream = drill.read_jsonl(fleet_dir / "stream.jsonl")
        assert stream
        for r in stream:
            versions = [v for v, _ in r.get("version_spans") or []]
            assert versions == sorted(set(versions)), f"span thrash in {r}"
        drill.assert_clean_threads(out_l, "learner")
        drill.assert_clean_threads(out_w, "worker")
    finally:
        drill.kill_all(worker)


def test_two_process_inflight_knob_staleness0_matches_knob_off_bitwise(tmp_path):
    def leg(tag, inflight):
        fleet_dir = tmp_path / f"fleet_{tag}"
        env = {"TOTAL": "8", "EPOCHS": "4", "ENGINE": "1", "ENGINE_SYNC": "2", "INFLIGHT": "1" if inflight else "0"}
        worker = drill.launch("rollout", tmp_path / f"ckpt_w_{tag}", fleet_dir, 0, env)
        try:
            learner = drill.launch("learner", tmp_path / f"ckpt_l_{tag}", fleet_dir, 0, env)
            out_l = drill.finish(learner)
            out_w = drill.finish(worker, timeout=60)
            assert learner.returncode == 0, out_l[-4000:]
            assert worker.returncode == 0, out_w[-4000:]
            drill.assert_clean_threads(out_l, f"{tag} learner")
            drill.assert_clean_threads(out_w, f"{tag} worker")
            return drill.losses(out_l), fleet_dir
        finally:
            drill.kill_all(worker)

    losses_off, dir_off = leg("off", inflight=False)
    losses_on, dir_on = leg("on", inflight=True)
    assert len(losses_off) == 8 and losses_on == losses_off
    stream_off = drill.read_jsonl(dir_off / "stream.jsonl")
    stream_on = drill.read_jsonl(dir_on / "stream.jsonl")
    assert stream_off and all("version_spans" not in r for r in stream_off)
    assert stream_on and all(len(r["version_spans"]) == 1 and r["version_spans"][0][0] == r["weight_version"]
                             for r in stream_on)
    consumed = [e for e in drill.events(dir_on) if e["event"] == "episode_consumed"]
    assert consumed and all(e["staleness"] == 0 and e["mixed_version_tokens"] == 0 for e in consumed)


def test_engine_coalesces_pushes_and_clamps_spans():
    """``update_weights`` between two syncs keeps only the newest push
    (``_switches_coalesced`` counts each superseded version), a re-push of
    the held version records nothing, and an episode's spans are clamped to
    its tokens: the JAX engine's contract, on the port's engine."""
    eng = RolloutEngine.__new__(RolloutEngine)
    eng._staged, eng._switches_coalesced, eng._staged_lock = None, 0, threading.Lock()
    for v in (3, 4, 5):
        eng.update_weights(object(), version=v)
    assert eng._staged[1] == 5 and eng._switches_coalesced == 2
    eng.update_weights(object(), version=5)  # the same version again: nothing superseded
    assert eng._switches_coalesced == 2
    meta = {"version": 1, "switches": [(0, 1), (4, 2), (4, 3), (9, 4), (30, 5)]}
    spans = RolloutEngine._build_spans(meta, 12)
    assert spans == [(1, 4), (3, 5), (4, 3)] and sum(k for _, k in spans) == 12
    assert RolloutEngine._build_spans({"version": 7}, 0) == [(7, 0)]
    rng = np.random.default_rng(0)
    for _ in range(200):
        steps = int(rng.integers(0, 20))
        switches = [(int(p), int(v)) for p, v in zip(rng.integers(-3, 25, 4), np.sort(rng.integers(1, 9, 4)))]
        meta = {"version": 0, "switches": switches}
        spans = RolloutEngine._build_spans(meta, steps)
        assert spans == [tuple(s) for s in JaxRolloutEngine._build_spans(meta, steps)]
        assert sum(k for _, k in spans) == steps and all(k >= 0 for _, k in spans)
