"""Multi-process fault drills of ``trlx_tpu_torch.resilience.distributed``:
twins of ``tests/test_distributed_resilience.py``'s three drills, and a
case each for ``slow_host`` and ``host_kill``.

Two gloo ranks train PPO on ``train.mesh [1, 2, 1, 1]`` (fsdp 2: each rank
holds half of every split parameter), with heartbeats every 0.2 s, a
collective deadline, the consistency guard and the preemption agreement
every step; each rank reads its own ``TRLX_TPU_FAULTS``
(``tests/torch_dist_case.py`` ``case_drill``). A port process is a card, and
can die alone: every check counts ranks.
"""

import torch

import torch_sp_train_case as case
import torch_sp_worker
from trlx_tpu_torch.resilience.distributed import EXIT_COLLECTIVE_TIMEOUT

torch.set_num_threads(1)

TIMEOUT = 240.0


def _drill(tmp_path, mode, faults, env=None, deadline=20.0, first=None):
    t = case.task(vocab=32)
    arch = dict(case._arch(), vocab_size=32)
    data = dict(case="drill", mode=mode, task=t, config=case.ppo_config("unused", (1, 2, 1, 1), arch=arch),
                shape=(1, 2, 1, 1), dir=str(tmp_path / "ckpt"), deadline=deadline)
    env_by_rank = {r: dict(env or {}, **({"TRLX_TPU_FAULTS": f} if f else {})) for r, f in faults.items()}
    return torch_sp_worker.launch("dist", 2, data, str(tmp_path / "w"), TIMEOUT, env_by_rank=env_by_rank, tag=mode,
                                  first=first)


def test_drill_host_hang_aborts_with_collective_timeout(tmp_path):
    """Rank 1 wedges after step 2 (its heartbeat thread still writing): rank
    0's guarded fingerprint all-gather hits the deadline and ends with exit
    117 and a CollectiveTimeout naming rank 1 from the heartbeat files."""
    (c0, out0, _), (c1, _, _) = _drill(tmp_path, "hang", {1: "host_hang@2"}, {"TRLX_TPU_HANG_SECONDS": "120"},
                                       deadline=10.0, first=0)
    assert c0 == EXIT_COLLECTIVE_TIMEOUT, out0[-4000:]
    assert "CollectiveTimeout" in out0 and "collective_deadline" in out0
    assert "slowest rank: rank 1" in out0, out0[-3000:]
    assert "FINISHED WITHOUT ABORT" not in out0
    assert c1 is None  # still asleep when rank 0 ended: killed


def test_drill_preemption_coordinated_save_and_resume(tmp_path):
    """SIGTERM on rank 1 only: both ranks agree, write ONE sharded
    checkpoint at the same step (latest.txt after both committed), and a
    two-rank resume runs to its end with bit-equal replicas (the per-step
    consistency guard is the witness) and finite losses."""
    runs = _drill(tmp_path, "preempt", {1: "sigterm@2"})
    for r, (code, out, _) in enumerate(runs):
        assert code == 0, out[-4000:]
        assert f"preempt rank {r} SAVED state_2" in out and f"preempt rank {r} OK" in out


def test_drill_host_desync_caught_by_fingerprint_guard(tmp_path):
    """Rank 1's copy of a replicated parameter is skewed after step 1: the
    step-2 check raises the same HostDesync, naming rank 1 and the
    parameter crc, on BOTH ranks."""
    runs = _drill(tmp_path, "desync", {1: "host_desync@1"})
    for r, (code, out, _) in enumerate(runs):
        assert code == 0, out[-4000:]
        assert f"desync rank {r} OK" in out and "GUARD MISSED" not in out


def test_drill_slow_host_is_a_straggler_not_a_failure(tmp_path):
    """Rank 1 stalls 1 s after step 1, under the deadline: the run ends
    normally and both ranks' heartbeat files record their exit."""
    runs = _drill(tmp_path, "slow", {1: "slow_host@1"}, {"TRLX_TPU_SLOW_SECONDS": "1"})
    for r, (code, out, _) in enumerate(runs):
        assert code == 0, out[-4000:]
        assert f"slow rank {r} OK" in out


def test_drill_host_kill_ends_the_peer_with_collective_timeout(tmp_path):
    """Rank 1 dies at once after step 2 (exit 1, no cleanup): rank 0's next
    guarded collective ends it with exit 117, naming rank 1."""
    (c0, out0, _), (c1, out1, _) = _drill(tmp_path, "kill", {1: "host_kill@2"}, deadline=10.0)
    assert c1 == 1, out1[-3000:]
    assert c0 == EXIT_COLLECTIVE_TIMEOUT, out0[-4000:]
    assert "CollectiveTimeout" in out0 and "slowest rank: rank 1" in out0
