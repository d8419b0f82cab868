"""A fleet role over several processes (the port's ``fleet.runner.RoleWorld``;
the contract of ``trlx_tpu/fleet/topology.py``'s multi-host role comment):
every rank of a role computes the same host decisions, rank 0 alone does
the role's fleet I/O.

Six fleets run side by side, each role a process or a gloo world of two
(``tests/torch_fleet_role_case.py``), on the forced-bigram PPO task at 2
layers and d 32 through the rollout engine, at staleness 0, from the same
whole initial weights, the JAX package's (``params_from_jax``); the JAX
package's colocated fleet runs the same config in this process meanwhile:

- ``base``: a one-process rollout role and a one-process learner, held
  against the JAX fleet: the same tokens and masks, the float columns
  within ``JAX_ROW_TOL``, the same consumption, and the end weights within
  ``JAX_WEIGHT_TOL`` (the twins' tolerances of
  ``tests/test_torch_fleet_disagg.py`` and ``tests/test_torch_resilience.py``);
- ``rollout2``: a rollout role of 2 ranks (dp 2, graftfleet armed) beside a
  one-process learner;
- ``learner2``: a one-process rollout role beside a learner of 2 ranks
  (fsdp 2);
- ``inflight2``: a rollout role of 2 ranks at staleness 2 with in-flight
  weight pushes, a slow reward and a torn publish (``weight_push_torn@2``),
  beside a one-process learner, over six iterations;
- ``rollout_tp2``: a rollout role of 2 tp ranks (each loads its pieces of a
  publish's whole leaves) beside a one-process learner;
- ``rollout_nodes2``: a rollout role of 2 ranks on 2 nodes (torchrun's
  ``LOCAL_WORLD_SIZE`` 1), each node producing its own 16 rows, beside a
  one-process learner.

(a) and (b): each consumes the same rows, row for row, as ``base``: the same
tokens and masks exactly, logprobs, values and rewards within
``ROW_RTOL``/``ROW_ATOL``, and the learner's end weights within
``WEIGHT_RTOL``/``WEIGHT_ATOL`` (the ranks' forwards run on other batch
sizes, so the sums differ by float rounding).
(c): only rank 0's path appears in the event log, the stream index, the
publishes and the fleet heartbeats: each record once.
In-flight: both ranks adopt each push at the same engine sync (the
orchestrator's ``verify_weight_pushes`` ends a rank that did not), every
consumed batch is within the staleness, and the torn ordinal is rejected.
(d): the refusals, by their messages.
A learner rank other than 0 waits for rank 0's word under a finite
deadline: a rank 0 that hangs ends it with exit 117.
"""

import gc
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(ROOT, "tests", "torch_fleet_role_case.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_fleet_drill as drill  # noqa: E402
import torch_fleet_role_case as case  # noqa: E402
import trlx_tpu  # noqa: E402
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig  # noqa: E402
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer  # noqa: E402
from trlx_tpu_torch.fleet import topology  # noqa: E402
from trlx_tpu_torch.fleet.runner import follow_deadline  # noqa: E402
from trlx_tpu_torch.fleet.topology import ROLE_ENV, role_timeouts, validate_fleet_config  # noqa: E402
from trlx_tpu_torch.models.hf_import import params_from_jax  # noqa: E402
from trlx_tpu_torch.resilience.distributed import EXIT_COLLECTIVE_TIMEOUT  # noqa: E402

ROW_RTOL, ROW_ATOL = 1e-5, 1e-6
WEIGHT_RTOL, WEIGHT_ATOL = 1e-4, 1e-6
JAX_ROW_TOL = 1e-4
JAX_WEIGHT_TOL = 2e-4
WALL_S = 240  # the hard limit on one fleet's processes


def _launch(role, ckpt, fleet_dir, rank, world, mesh, init_weights, tag, extra_env=None):
    env = dict(os.environ)
    for var in drill.FLEET_ENV:
        env.pop(var, None)
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **(extra_env or {}))
    log_path = os.path.join(str(ckpt) + f".{tag}.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "wb") as log:
        proc = subprocess.Popen([sys.executable, CASE, role, str(ckpt), str(fleet_dir), str(rank), str(world),
                                 str(ckpt) + ".store", mesh, str(init_weights)], env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    proc.log_path = log_path
    return proc


@pytest.fixture(scope="module")
def init_weights(tmp_path_factory):
    """The whole initial weights every process starts from: the JAX
    package's trainer's, under the port's names."""
    base = tmp_path_factory.mktemp("role_init")
    jax_init = JaxPPOTrainer(JaxTRLConfig.from_dict(_jax_dict(base / "jax_init")))
    params, extras = jax.device_get(jax_init.state.params), jax.device_get(jax_init.state.extras)
    del jax_init
    trainer = case.PPOTrainer(case.role_config(base / "init", model_type="PPOTrainer"), device="cpu")
    params, extras = params_from_jax(params, trainer.model), params_from_jax(extras, trainer.model)
    assert set(params) == {n for n, _ in trainer.model.named_parameters()} and set(extras) == set(trainer.extras)
    init = base / "init.pt"
    torch.save({"params": {n: t.numpy() for n, t in params.items()},
                "extras": {n: t.numpy() for n, t in extras.items()}}, init)
    del trainer
    gc.collect()  # the process-global collective guard reads a live trainer's step
    return init


def _jax_dict(ckpt, fleet_dir=None):
    """The task's config for the JAX package, on its default mesh (every
    device of this process on the data axis)."""
    config = case.role_dict(ckpt, fleet_dir, model_type="ppo")
    del config["train"]["mesh"]
    return config


def _jax_fleet(root):
    """The JAX package's colocated fleet on the task, at staleness 0, from
    the same initial weights: its fleet directory at ``root/fleet`` and its
    end weights at ``root/learner/final.pt``, as the port's roles write
    them."""
    mask, prompts, reward_fn = case.bigram_task()
    config = _jax_dict(root / "learner", root / "fleet")
    with pytest.MonkeyPatch.context() as mp:
        for var in drill.FLEET_ENV:
            mp.delenv(var, raising=False)
        model = trlx_tpu.train(config=JaxTRLConfig.from_dict(config), reward_fn=reward_fn, prompts=prompts,
                               eval_prompts=prompts[:4], logit_mask=mask)
    params = params_from_jax(jax.device_get(model.state.params))
    torch.save({n: t.numpy() for n, t in params.items()}, root / "learner" / "final.pt")


@pytest.fixture(scope="module")
def fleets(tmp_path_factory, init_weights):
    """The six fleets, run at once, and the JAX package's fleet beside
    them; {name: fleet root}."""
    base = tmp_path_factory.mktemp("role_world")
    init = init_weights
    layouts = {
        "base": {"rollout": (1, "1,1,1,1"), "learner": (1, "1,1,1,1")},
        "rollout2": {"rollout": (2, "2,1,1,1"), "learner": (1, "1,1,1,1")},
        "learner2": {"rollout": (1, "1,1,1,1"), "learner": (2, "1,2,1,1")},
        "inflight2": {"rollout": (2, "2,1,1,1"), "learner": (1, "1,1,1,1")},
        "rollout_tp2": {"rollout": (2, "1,1,2,1"), "learner": (1, "1,1,1,1")},
        "rollout_nodes2": {"rollout": (2, "2,1,1,1"), "learner": (1, "1,1,1,1")},
    }
    inflight = {"STALENESS": "2", "INFLIGHT": "1", "TOTAL": "24", "EPOCHS": "6"}
    envs = {("rollout2", "rollout"): {"GRAFTFLEET": "1"},
            ("inflight2", "rollout"): {**inflight, "REWARD_SLEEP": "0.3"},
            ("inflight2", "learner"): {**inflight, "TRLX_TPU_FAULTS": "weight_push_torn@2"}}
    procs = []
    for name, roles in layouts.items():
        root = base / name
        for role, (world, mesh) in roles.items():
            for rank in range(world):
                env = dict(envs.get((name, role), {}))
                if (name, role) == ("rollout_nodes2", "rollout"):
                    env.update(LOCAL_WORLD_SIZE="1", GROUP_RANK=str(rank))
                procs.append(_launch(role, root / role, root / "fleet", rank, world, mesh, init, f"r{rank}", env))
    try:
        _jax_fleet(base / "jax")
        for p in procs:
            out = drill.finish(p, timeout=WALL_S)
            assert p.returncode == 0 and "DONE" in out, out[-4000:]
            drill.assert_clean_threads(out, p.log_path)
    finally:
        drill.kill_all(*procs)
    return {name: base / name for name in (*layouts, "jax")}


def _stream(root):
    """The consumed batches' columns, in seq order."""
    index = drill.read_jsonl(os.path.join(root, "fleet", "stream.jsonl"))
    out = []
    for rec in sorted(index, key=lambda r: r["seq"]):
        with np.load(os.path.join(root, "fleet", "episodes", rec["file"])) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _assert_same_rows(root, ref_root, rtol=ROW_RTOL, atol=ROW_ATOL):
    got, ref = _stream(root), _stream(ref_root)
    assert len(got) == len(ref) >= 2
    for b, (g, r) in enumerate(zip(got, ref)):
        assert sorted(g) == sorted(r)
        assert g["query_tensors"].shape[0] == 16
        for k in ("query_tensors", "query_mask", "response_tensors", "response_mask"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"batch {b} {k}")
        for k in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(g[k], r[k], rtol=rtol, atol=atol, err_msg=f"batch {b} {k}")
    consumed = [e for e in drill.events(os.path.join(root, "fleet")) if e["event"] == "episode_consumed"]
    ref_consumed = [e for e in drill.events(os.path.join(ref_root, "fleet")) if e["event"] == "episode_consumed"]
    assert [(e["seq"], e["version"], e["staleness"], e["n"]) for e in consumed] == \
        [(e["seq"], e["version"], e["staleness"], e["n"]) for e in ref_consumed]


def _assert_same_end_weights(root, ref_root, rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL):
    got = torch.load(os.path.join(root, "learner", "final.pt"), weights_only=False)
    ref = torch.load(os.path.join(ref_root, "learner", "final.pt"), weights_only=False)
    assert sorted(got) == sorted(ref)
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], rtol=rtol, atol=atol, err_msg=n)


def test_one_process_roles_match_the_jax_fleet(fleets):
    """``base``, the reference of every role world below, against the JAX
    package's colocated fleet from the same initial weights: the same rows
    (tokens and masks exactly, logprobs, values and rewards within
    ``JAX_ROW_TOL``), the same consumption, and the end weights within
    ``JAX_WEIGHT_TOL``."""
    _assert_same_rows(fleets["base"], fleets["jax"], rtol=JAX_ROW_TOL, atol=JAX_ROW_TOL)
    _assert_same_end_weights(fleets["base"], fleets["jax"], rtol=JAX_WEIGHT_TOL, atol=JAX_WEIGHT_TOL)


def test_rollout_role_of_two_ranks_matches_one_process(fleets):
    """(a) A rollout role of 2 dp ranks streams the one-process role's rows:
    the same tokens, the same logprobs and values within the tolerance, the
    same consumption; the learner ends at the same weights. graftfleet's
    arrival records cover the role's own collectives on both ranks."""
    _assert_same_rows(fleets["rollout2"], fleets["base"])
    _assert_same_end_weights(fleets["rollout2"], fleets["base"])
    from trlx_tpu_torch.observability.fleet import read_collective_arrivals

    arrivals = read_collective_arrivals(os.path.join(fleets["rollout2"], "rollout"))
    sites = {site for site, _ in arrivals}
    assert {"broadcast_host", "fleet/role_leaves", "engine/schedule_verify"} <= sites
    assert all(sorted(by_host) == [0, 1] for (site, _), by_host in arrivals.items() if site == "fleet/role_leaves")


def test_rollout_role_of_two_tp_ranks_matches_one_process(fleets):
    """A rollout role of 2 tp ranks: each rank loads its pieces of every
    publish (``put_leaves`` over the module's placements) and the role
    streams the one-process role's rows within the tolerance."""
    _assert_same_rows(fleets["rollout_tp2"], fleets["base"])
    _assert_same_end_weights(fleets["rollout_tp2"], fleets["base"])


def test_rollout_role_over_two_nodes_streams_each_nodes_rows(fleets):
    """On 2 nodes each rank's store holds its node's 16 rows; rank 0 gathers
    them, node by node, into one record of the role's 32 rows, and the
    learner consumes it whole."""
    root = fleets["rollout_nodes2"]
    batches = _stream(root)
    assert batches and all(b["query_tensors"].shape[0] == 32 for b in batches)
    for k, batch in enumerate(batches):
        parts = [dict(np.load(os.path.join(root, "rollout", f"rank{r}_phase{k}.npz"))) for r in range(2)]
        assert all(p["query_tensors"].shape[0] == 16 for p in parts)
        for key in parts[0]:
            np.testing.assert_array_equal(batch[key], np.concatenate([p[key] for p in parts]), err_msg=f"{k} {key}")
    consumed = [e for e in drill.events(os.path.join(root, "fleet")) if e["event"] == "episode_consumed"]
    assert consumed and all(e["n"] == 32 for e in consumed)


def test_learner_of_two_fsdp_ranks_matches_one_process(fleets):
    """(b) A learner of 2 fsdp ranks consumes the one-process learner's rows
    and ends at its weights within the tolerance; it publishes the whole
    leaves, which the one-process rollout role loads."""
    _assert_same_rows(fleets["learner2"], fleets["base"])
    _assert_same_end_weights(fleets["learner2"], fleets["base"])
    pub = [e for e in drill.events(os.path.join(fleets["learner2"], "fleet")) if e["event"] == "weights_published"]
    ref = [e for e in drill.events(os.path.join(fleets["base"], "fleet")) if e["event"] == "weights_published"]
    assert [e["bytes"] for e in pub] == [e["bytes"] for e in ref]


@pytest.mark.parametrize("name", ["rollout2", "learner2"])
def test_only_rank_zero_does_the_role_fleet_io(fleets, name):
    """(c) Every record of the fleet directory once: one worker start and
    exit, one learner start and exit, each seq streamed, indexed and
    consumed once, each ordinal published once, and only the two roles'
    fleet heartbeat files (rank 0 of each role). A second rank's adoption
    seconds ride in rank 0's events."""
    fleet = os.path.join(fleets[name], "fleet")
    ev = drill.events(fleet)
    count = lambda kind: [e for e in ev if e["event"] == kind]  # noqa: E731
    assert len(count("worker_start")) == len(count("worker_exit")) == 1
    assert len(count("learner_start")) == len(count("learner_exit")) == 1
    for kind, key in (("episode_streamed", "seq"), ("episode_consumed", "seq"), ("weights_published", "ordinal"),
                      ("weights_fetched", "ordinal")):
        keys = [e[key] for e in count(kind)]
        assert keys and len(keys) == len(set(keys)), kind
    index = drill.read_jsonl(os.path.join(fleet, "stream.jsonl"))
    assert [r["seq"] for r in index] == sorted({r["seq"] for r in index})
    log = drill.read_jsonl(os.path.join(fleet, "broadcast.jsonl"))
    assert [r["ordinal"] for r in log] == list(range(len(log)))
    assert sorted(os.listdir(os.path.join(fleet, "heartbeats"))) == ["rank_0.json", "rank_1.json"]
    assert not [f for _, _, files in os.walk(fleet) for f in files if ".tmp" in f]
    fetched = count("weights_fetched")
    if name == "rollout2":
        assert all(len(e["rank_load_s"]) == len(e["rank_h2d_s"]) == 2 for e in fetched)
    else:
        assert all("rank_load_s" not in e for e in fetched)


def test_inflight_pushes_in_a_rollout_role_of_two_ranks(fleets):
    """Rank 0 decides at each engine sync whether a fresher publish is
    adopted, and both ranks push it at that sync (each phase's push log is
    checked across the ranks, or the role ends with a HostDesync): pushes
    land mid-phase, each adoption carries both ranks' seconds, the torn
    ordinal is rejected and never adopted, and every consumed batch is
    within staleness 2."""
    fleet = os.path.join(fleets["inflight2"], "fleet")
    ev = drill.events(fleet)
    broadcast = drill.read_jsonl(os.path.join(fleet, "broadcast.jsonl"))
    assert [r["ordinal"] for r in broadcast if r["status"] == "injected_torn"] == [2]
    rejected = [e for e in ev if e["event"] == "weights_torn"]
    assert rejected and all(e["ordinal"] == 2 and e["held"] < 2 for e in rejected)
    inflight = [e for e in ev if e["event"] == "weights_adopted_inflight"]
    assert inflight and all(len(e["rank_load_s"]) == 2 for e in inflight)
    adopted = [e["ordinal"] for e in ev if e["event"] in ("weights_adopted_inflight", "weights_fetched")]
    assert 2 not in adopted and max(adopted) >= 3
    consumed = [e for e in ev if e["event"] == "episode_consumed"]
    assert len(consumed) == 6 and all(e["staleness"] <= 2 for e in consumed)
    assert any(len(r.get("version_spans") or []) > 1 for r in drill.read_jsonl(os.path.join(fleet, "stream.jsonl")))


# ------------------------------------------------------------------ refusals


def _config(tmp_path, **method):
    config = case.role_config(tmp_path / "ckpt", tmp_path / "fleet")
    for k, v in method.items():
        setattr(config.method, k, v)
    return config


@pytest.mark.parametrize("kind", ["implicit_colocated", "explicit_colocated", "elastic_worker", "overlap"])
def test_role_world_refusals(tmp_path, monkeypatch, kind):
    """(d) Each refusal of a role world, by its message: the colocated mode
    (the implicit default, the JAX package's message word for word, or set
    explicitly) is one process; an elastic worker is one process; the
    in-process overlap never runs beside the fleet."""
    monkeypatch.setattr(topology, "world_size", lambda: 2)
    monkeypatch.delenv(ROLE_ENV, raising=False)
    if kind == "implicit_colocated":
        with pytest.raises(ValueError, match="needs an explicit role"):
            validate_fleet_config(_config(tmp_path))
    elif kind == "explicit_colocated":
        monkeypatch.setenv(ROLE_ENV, "colocated")
        with pytest.raises(ValueError, match="colocated mode runs both roles in one process"):
            validate_fleet_config(_config(tmp_path))
    elif kind == "elastic_worker":
        monkeypatch.setenv(ROLE_ENV, "rollout")
        with pytest.raises(ValueError, match="an elastic rollout worker is one process"):
            validate_fleet_config(_config(tmp_path, fleet_elastic=True))
        monkeypatch.setenv(ROLE_ENV, "learner")
        assert validate_fleet_config(_config(tmp_path, fleet_elastic=True)) == "learner"
    else:
        monkeypatch.setenv(ROLE_ENV, "rollout")
        with pytest.raises(ValueError, match="mutually exclusive"):
            validate_fleet_config(_config(tmp_path, rollout_overlap=True))
        assert validate_fleet_config(_config(tmp_path)) == "rollout"


def test_fleet_io_refuses_a_second_rank(tmp_path, monkeypatch):
    """The transports' writers open on rank 0 of a role only."""
    from trlx_tpu_torch.fleet import broadcast, leases, runner, stream

    paths = topology.FleetPaths(root=str(tmp_path / "fleet")).ensure()
    monkeypatch.setattr(topology, "process_rank", lambda: 1)
    for make in (lambda: stream.EpisodeStreamWriter(paths), lambda: broadcast.WeightPublisher(paths),
                 lambda: leases.LeaseLedger(paths.leases_dir, ttl=1.0), lambda: leases.WorkerRegistry(paths.workers_dir),
                 lambda: runner._event(paths, "rollout", "x")):
        with pytest.raises(RuntimeError, match="rank 1 of"):
            make()
    assert not os.path.exists(paths.events) and not os.path.exists(paths.leases_dir)


def test_weight_push_check_names_the_rank_that_differs(monkeypatch):
    """The orchestrator's end-of-phase check of a role's in-flight pushes:
    equal (sync, version) logs pass; a rank that pushed at another sync is
    named, with the same HostDesync on every rank."""
    from trlx_tpu_torch.parallel import mesh
    from trlx_tpu_torch.resilience import distributed as dist_res

    monkeypatch.setattr(mesh, "world_size", lambda: 2)

    def row_of(log):
        """The row a rank with this push log puts into the all-gather."""
        captured = []
        monkeypatch.setattr(mesh, "allgather_host", lambda x: captured.append(x) or x)
        dist_res.verify_weight_pushes(log, phase=3)
        return np.asarray(captured[0]).reshape(-1)

    def check(logs):
        rows = np.stack([row_of(log) for log in logs])
        monkeypatch.setattr(mesh, "allgather_host", lambda x: rows)
        dist_res.verify_weight_pushes(logs[0], phase=3)

    check([[(8, 2)], [(8, 2)]])
    with pytest.raises(dist_res.HostDesync, match=r"rank 1: push schedule crc32"):
        check([[(8, 2)], [(9, 2)]])


def test_learner_rank_ends_when_rank_zero_hangs(tmp_path, init_weights):
    """A learner of 2 ranks whose rank 0 hangs, alive, where it waits for the
    next batch: rank 1's wait for rank 0's word is guarded by
    ``follow_deadline`` (rank 0's publish, one round of its stream wait and
    the triage), so rank 1 exits 117 naming that wait while rank 0 still
    runs."""
    knobs = dict(fleet_broadcast_deadline=2.0, fleet_episode_timeout=0.5, fleet_stream_retries=1,
                 fleet_stream_backoff=0.1, fleet_heartbeat_timeout=1.0)
    deadline = follow_deadline(role_timeouts(case.role_config(tmp_path, tmp_path / "fleet", knobs=knobs).train))
    assert deadline == pytest.approx(2.0 + 2 * 0.5 + 0.1 + 1.0)
    env = {"KNOBS": json.dumps(knobs), "STALL_LEAD": "600"}
    procs = [_launch("learner", tmp_path / "learner", tmp_path / "fleet", rank, 2, "2,1,1,1", init_weights,
                     f"r{rank}", env) for rank in range(2)]
    try:
        t0 = time.monotonic()
        out = drill.finish(procs[1], timeout=WALL_S)
        waited = time.monotonic() - t0
        assert procs[1].returncode == EXIT_COLLECTIVE_TIMEOUT, out[-4000:]
        assert f"collective 'broadcast_host' exceeded train.collective_deadline={deadline:g}s" in out, out[-4000:]
        assert procs[0].poll() is None, "rank 0 was to hang, not to end"
        assert waited < WALL_S
    finally:
        drill.kill_all(*procs)


def test_role_world_shares_decisions_waits_and_leaves_over_gloo(tmp_path):
    """``tests/torch_role_nccl_case.py`` over gloo on the CPU (the two-card
    test of ``tests/test_torch_gpu.py`` runs it over NCCL): rank 0's
    decision after two words that its wait goes on, and a publish's leaves
    of four dtypes and sizes (one empty), reach rank 1 byte for byte."""
    procs = []
    port = drill.free_port()
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        log = open(tmp_path / f"r{rank}.log", "wb")
        procs.append(subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_role_nccl_case.py"), "gloo"],
                                      env=env, stdout=log, stderr=subprocess.STDOUT))
        procs[-1].log_path = str(tmp_path / f"r{rank}.log")
        log.close()
    try:
        for p in procs:
            out = drill.finish(p, timeout=WALL_S)
            assert p.returncode == 0 and "OK gloo" in out, out[-4000:]
    finally:
        drill.kill_all(*procs)
