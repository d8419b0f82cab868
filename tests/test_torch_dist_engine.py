"""The rollout engine, the overlapped pipeline and W8A16 decode weights on the
port's mesh (several processes), against one process and the JAX package:
twins of ``tests/test_engine.py``'s schedule-crc case and of the four engine
drills of ``tests/test_fleet_drill.py``, and the slice's own cases.

Ranks are gloo processes on the CPU (``tests/torch_sp_worker.py dist`` with
the cases of ``tests/torch_dist_case.py``), tiny float32 models, one intra-op
thread. Every multi-process test has its own wall limit (``TIMEOUT``).
Tolerances: greedy tokens and schedule crcs equal; int8 codes and scales bit
for bit; the overlapped run at staleness 0 bit-equal to the serial one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_train_case as case
import torch_sp_worker
from trlx_tpu.engine import RolloutEngine as JaxRolloutEngine
from trlx_tpu.models import LMConfig as JaxLMConfig
from trlx_tpu.models import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.models.lm import quantize_weights as jax_quantize_weights
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig
from trlx_tpu_torch.engine import RolloutEngine
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.models.lm import LMConfig
from trlx_tpu_torch.ops.sampling import GenerateConfig
from trlx_tpu_torch.ops.w8a16 import quantize_weights, quantized_weights
from trlx_tpu_torch.parallel.sharding import Placement
from trlx_tpu_torch.resilience.distributed import EXIT_COLLECTIVE_TIMEOUT

torch.set_num_threads(1)

TIMEOUT = 240.0
V = 32  # divides tp: the vocabulary splits
# GPT-J's layout: separate q / k / v, parallel residual, rotary, an untied
# head with a bias (the products the W8 copies cover, and the whole head).
ARCH = dict(vocab_size=V, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
            parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
            extra={"lm_head_bias": True}, dtype="float32", param_dtype="float32")
GCFG = dict(max_new_tokens=7, do_sample=False, pad_token_id=0, eos_token_id=1)
ENGINE = dict(n_slots=3, prompt_width=6, prefill_batch=2, steps_per_sync=3, paged_kv=True, kv_block_size=4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.fixture(scope="module")
def weights():
    """(JAX module, JAX params) of ARCH, seeded."""
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(ARCH))
    ids = jnp.zeros((1, 4), jnp.int32)
    return jmodel, jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"])


def _port_model(params, arch=ARCH):
    model = LMWithValueHead(LMConfig(**arch), device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    model.requires_grad_(False)
    return model


def _prompts(seed=0):
    """7 width-6 rows, one left-padded, two repeating row 0 (prefix hits at
    block 4)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(2, V, size=(7, 6)).astype(np.int32)
    pmask = np.ones((7, 6), np.int32)
    prompts[1, :2] = 0
    pmask[1, :2] = 0
    prompts[5] = prompts[0]
    prompts[6] = prompts[0]
    return prompts, pmask


def _drain(engine):
    episodes = []
    for _ in range(300):
        episodes.extend(engine.step())
        if engine.idle:
            break
    return episodes


def _episodes(eps):
    return [(e.prompt_ids, e.prompt_mask, e.response_ids, e.response_mask) for e in eps]


def _assert_same_episodes(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------- the schedule crc


def _mixed_prompts(seed=3):
    """Unique prompts at two widths, one row left-padded
    (tests/test_engine.py's)."""
    rng = np.random.default_rng(seed)
    w6 = rng.integers(2, 23, size=(3, 6)).astype(np.int32)
    m6 = np.ones((3, 6), np.int32)
    w6[0, :2] = 0
    m6[0, :2] = 0
    w4 = rng.integers(2, 23, size=(3, 4)).astype(np.int32)
    return (w6, m6), (w4, np.ones((3, 4), np.int32))


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_schedule_fingerprint_is_deterministic_order_sensitive_and_equals_jax(paged):
    """The twin of test_engine.py's: identical submissions give identical
    crcs, a reordered admission stream a different one, and the port's crc
    equals the JAX engine's over the same submissions (the same tags and
    payloads, the pool's table rows included when paged)."""
    kw = dict(vocab_size=23, n_layer=2, n_head=2, d_model=32, max_position=64, dtype="float32")
    jmodel = JaxLMWithValueHead(JaxLMConfig(**kw))
    ids0 = jnp.zeros((1, 6), jnp.int32)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids0, jnp.ones_like(ids0))["params"])
    model = _port_model(jparams, kw)
    gkw = dict(max_new_tokens=4, do_sample=False, eos_token_id=None, pad_token_id=0)
    extra = dict(paged_kv=True, kv_block_size=4) if paged else {}
    (w6, m6), (w4, m4) = _mixed_prompts()

    def run(order, use_jax=False):
        if use_jax:
            engine = JaxRolloutEngine(jmodel, JaxGenerateConfig(**gkw), n_slots=2, prompt_width=6, prefill_batch=2,
                                      steps_per_sync=2, rng=jax.random.PRNGKey(2), **extra)
            engine.update_weights({"params": jparams}, version=1)
        else:
            engine = RolloutEngine(model, GenerateConfig(**gkw), n_slots=2, prompt_width=6, prefill_batch=2,
                                   steps_per_sync=2, **extra)
            engine.update_weights(model, version=1)
        for ids, msk in order:
            engine.submit(ids, msk)
        _drain(engine)
        crc = engine.schedule_fingerprint()
        engine.shutdown()
        return crc

    a, b, c = run([(w6, m6), (w4, m4)]), run([(w6, m6), (w4, m4)]), run([(w4, m4), (w6, m6)])
    assert a == b and a != c and 0 <= a <= 0xFFFFFFFF
    assert a == run([(w6, m6), (w4, m4)], use_jax=True) and c == run([(w4, m4), (w6, m6)], use_jax=True)


@pytest.mark.parametrize("allowed", [False, True])
def test_engine_decode_graph_follows_the_samplers_capture_rule(monkeypatch, allowed):
    """The engine captures its decode call only where the sampler's rule
    allows it (``ops.generate.graphs_allowed``: not where tp's all-reduces
    are staged through the host), and never when asked to run eagerly."""
    from trlx_tpu_torch.engine import rollout_engine

    seen = []
    monkeypatch.setattr(rollout_engine, "graphs_allowed", lambda device: seen.append(device) or allowed)
    model = _port_model(jax.device_get(JaxLMWithValueHead(JaxLMConfig.from_dict(ARCH)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"]))
    assert RolloutEngine(model, GenerateConfig(**GCFG), **ENGINE)._use_graph is allowed
    assert seen == [torch.device("cpu")]
    assert RolloutEngine(model, GenerateConfig(**GCFG), **ENGINE, _eager=True)._use_graph is False


# ------------------------------------------------- the engine on the mesh, W8


@pytest.fixture(scope="module")
def engine_mesh(weights, tmp_path_factory):
    """The paged engine, greedy, on [1, 2, 2, 1] (4 ranks: fsdp 2 x tp 2, 2
    local heads), with bf16-free float32 weights, then again with int8
    decode weights; the same prompts through one process of the port and
    the JAX engine."""
    jmodel, params = weights
    prompts, pmask = _prompts()
    data = dict(case="engine_mesh", shape=(1, 2, 2, 1), arch=ARCH, params=_flat(params), prompts=prompts,
                pmask=pmask, gcfg=GCFG, engine=ENGINE)
    root = tmp_path_factory.mktemp("engine_mesh")
    out = {"mesh": torch_sp_worker.spawn("dist", 4, data, str(root / "w"), TIMEOUT),
           "w8_mesh": torch_sp_worker.spawn("dist", 4, dict(data, w8=True), str(root / "w8"), TIMEOUT, tag="w8")}
    for w8 in (False, True):
        model = _port_model(params)
        if w8:
            quantize_weights(model)
        engine = RolloutEngine(model, GenerateConfig(**GCFG), **ENGINE)
        engine.update_weights(model, version=1)
        engine.submit(prompts, pmask)
        out["single_w8" if w8 else "single"] = (_episodes(_drain(engine)), engine.schedule_fingerprint(), model)
    jeng = JaxRolloutEngine(jmodel, JaxGenerateConfig(**GCFG), **ENGINE, rng=jax.random.PRNGKey(2))
    jeng.update_weights({"params": params}, version=1)
    jeng.submit(prompts, pmask)
    out["jax"] = (_episodes(_drain(jeng)), jeng.schedule_fingerprint())
    return out


def test_engine_on_fsdp_tp_mesh_matches_one_process_and_jax(engine_mesh):
    """Every rank's engine makes the same decisions and emits the same
    greedy episodes, in the same completion order, as one process and as
    the JAX engine on the same weights; the schedule crcs are all equal."""
    ref, jcrc = engine_mesh["jax"]
    single, crc, _ = engine_mesh["single"]
    _assert_same_episodes(single, ref)
    assert crc == jcrc
    for r in engine_mesh["mesh"]:
        _assert_same_episodes(r["episodes"], ref)
        assert r["crc"] == crc


def test_w8_engine_on_mesh_matches_one_process(engine_mesh):
    """With int8 decode weights (row W8 at the tp-local shapes, the head's
    whole copy on every tp rank) every rank decodes the one process's greedy
    episodes, and the schedule crcs agree."""
    single, crc, _ = engine_mesh["single_w8"]
    for r in engine_mesh["w8_mesh"]:
        _assert_same_episodes(r["episodes"], single)
        assert r["crc"] == crc


def test_w8_pieces_are_slices_of_the_whole_masters_quantization(engine_mesh, weights):
    """Each rank's int8 codes and scales (quantized from its f32 pieces: the
    column max all-reduced over the axis that splits K, the codes gathered
    over fsdp) equal, bit for bit, the slice of one process's quantization
    of the whole masters, and of the JAX package's ``quantize_weights``: the
    tp-local columns (per head of q, k and v) of a column-parallel product,
    the tp-local rows of a row-parallel one, the whole LM head."""
    _, params = weights
    single = {n: (kq.numpy(), sc.numpy()) for n, (kq, sc) in quantized_weights(engine_mesh["single_w8"][2]).items()}
    jq = _flat(jax.device_get(jax_quantize_weights(params)))
    seen_split = set()
    for r in engine_mesh["w8_mesh"]:
        assert sorted(r["w8"]) == sorted(single)
        tp_rank = r["coords"]["tp"]
        for name, (kq, sc, pl) in r["w8"].items():
            whole_kq, whole_sc = single[name]
            np.testing.assert_array_equal(whole_kq, np.asarray(jq[f"{name}.kernel_q"]), err_msg=name)
            np.testing.assert_array_equal(whole_sc, np.asarray(jq[f"{name}.scale"]), err_msg=name)
            if pl is None or name.rpartition(".")[2] == "lm_head":
                want_kq, want_sc = whole_kq, whole_sc
            else:
                p = Placement(tuple(pl["full_shape"]), None, pl["tp_dim"], pl["qkv"], 1, pl["tp"])
                want_kq = p.tp_piece(torch.as_tensor(whole_kq), tp_rank).numpy()
                want_sc = (p.tp_piece(torch.as_tensor(whole_sc)[None], tp_rank)[0].numpy() if pl["tp_dim"] == 1
                           else whole_sc)
                seen_split.add(pl["tp_dim"])
            np.testing.assert_array_equal(kq, want_kq, err_msg=f"rank {r['coords']} {name}")
            np.testing.assert_array_equal(sc, want_sc, err_msg=f"rank {r['coords']} {name}")
    assert seen_split == {0, 1}  # row- and column-parallel products both held


# ---------------------------------------------------------- the engine drills


def _drill(tmp_path, mode, shape, env=None, method=None, first=None, deadline=20.0):
    """Two ranks train PPO through the engine on ``shape`` (the port's
    seeded weights: every rank draws the whole tensors), graftfleet armed,
    heartbeats every 0.2 s and a collective deadline; ``env`` by rank."""
    cfg = case.ppo_config("unused", shape, arch=dict(case._arch(), vocab_size=V))
    t = case.task(vocab=V)
    data = dict(case="engine_drill", mode=mode, task=t, config=cfg, shape=shape, dir=str(tmp_path / "ckpt"),
                train=dict(graftfleet=True, heartbeat_interval=0.2, collective_deadline=deadline,
                           desync_check_interval=1, log_interval=10**6),
                method=dict(rollout_engine=True, engine_slots=4, prefill_batch=2, engine_steps_per_sync=2,
                            **(method or {})))
    return torch_sp_worker.launch("dist", 2, data, str(tmp_path / "w"), TIMEOUT, env_by_rank=env or {}, tag=mode,
                                  first=first)


def _fleet_bundles(ckpt):
    incidents = os.path.join(ckpt, "incidents")
    if not os.path.isdir(incidents):
        return []
    return [os.path.join(incidents, d) for d in sorted(os.listdir(incidents))
            if os.path.exists(os.path.join(incidents, d, "fleet_incident.json"))]


@pytest.mark.parametrize("leg", ["clean", "spec", "nodes"])
def test_engine_drill_two_ranks_clean(tmp_path, leg):
    """The engine at two ranks runs to its end: the same admission,
    harvest (and, spec, verify) schedule on both (the phase-end crc check
    passes every phase) and no incident bundle. ``clean`` splits the rows
    over two data ranks of one node (fsdp 2, fixed slots: the same store on
    both); ``spec`` splits the heads over tp 2 with the paged pool and
    n-gram drafts; ``nodes`` runs two nodes of one rank (dp 2): every rank
    submits both nodes' prompts (the same schedule), and each node stores
    its half of each harvested chunk."""
    shape = {"clean": (1, 2, 1, 1), "spec": (1, 1, 2, 1), "nodes": (2, 1, 1, 1)}[leg]
    method = dict(paged_kv=True, kv_block_size=4, spec_decode="ngram", spec_k=3) if leg == "spec" else {}
    env = {r: {"LOCAL_WORLD_SIZE": "1", "GROUP_RANK": str(r)} for r in range(2)} if leg == "nodes" else None
    runs = _drill(tmp_path, leg, shape, method=method, env=env)
    for r, (code, out, _) in enumerate(runs):
        assert code == 0, out[-4000:]
        assert f"engine {leg} rank {r} DONE" in out
    (_, _, r0), (_, _, r1) = runs
    assert r0["crcs"] == r1["crcs"] and len(r0["crcs"]) >= 1 and r0["iter_count"] == r1["iter_count"] == case.STEPS
    if leg == "nodes":
        # Each node stores its num_rollouts rows of the phase's 2 x num_rollouts episodes.
        rows = case.ppo_config("unused", shape)["method"]["num_rollouts"]
        assert len(r0["store"]["query_tensors"]) == len(r1["store"]["query_tensors"]) == rows
    else:
        for k, v in r0["store"].items():
            np.testing.assert_array_equal(r1["store"][k], v, err_msg=k)
    assert not _fleet_bundles(str(tmp_path / "ckpt"))


def test_engine_drill_schedule_skew_is_named_desync(tmp_path):
    """Rank 1 reports a skewed slot-schedule crc
    (``TRLX_TPU_ENGINE_SCHEDULE_SKEW``): the phase-end check raises the same
    HostDesync on both ranks, naming rank 1 and the schedule crc."""
    runs = _drill(tmp_path, "skew", (1, 2, 1, 1), env={1: {"TRLX_TPU_ENGINE_SCHEDULE_SKEW": "1"}})
    for r, (code, out, res) in enumerate(runs):
        assert code == 0, out[-4000:]
        assert f"engine skew rank {r} DESYNC NAMED" in out and "DONE" not in out, out[-3000:]
        assert "rank 1: " in res["desync"] and "slot schedule crc32" in res["desync"]


def test_engine_drill_mid_decode_kill_exits_117_with_slot_states(tmp_path):
    """Rank 1 dies at the engine loop's second sync tick with slots
    mid-decode (``mid_decode_host_kill@2``, paged pool, tp 2): rank 0's
    guarded decode sync ends it with exit 117, and graftfleet's bundle names
    the engine collective and carries rank 0's slot states and span tail."""
    (c0, out0, _), (c1, out1, _) = _drill(tmp_path, "kill", (1, 1, 2, 1), first=0,
                                           env={1: {"TRLX_TPU_FAULTS": "mid_decode_host_kill@2"}},
                                           method=dict(paged_kv=True, kv_block_size=4))
    assert c1 == 1, out1[-3000:]
    assert c0 == EXIT_COLLECTIVE_TIMEOUT, out0[-4000:]
    assert "CollectiveTimeout" in out0 and "DONE" not in out0
    bundles = _fleet_bundles(str(tmp_path / "ckpt"))
    assert bundles, out0[-3000:]
    with open(os.path.join(bundles[0], "fleet_incident.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == "collective_timeout" and manifest["collected_by"] == 0
    detail = manifest["detail"]
    assert detail["collective"] in ("engine/schedule_verify", "engine/decode_sync"), detail
    assert isinstance(detail["slot_states"], list) and detail["slot_states"], detail
    for slot in detail["slot_states"]:
        assert "slot" in slot and "n_gen" in slot and "version" in slot, slot
    tail = os.path.join(bundles[0], "host0", "spans_tail.jsonl")
    assert os.path.exists(tail) and os.path.getsize(tail) > 0


def test_engine_chunk_must_divide_over_the_data_ranks(tmp_path):
    """An engine chunk that does not divide over the node's data ranks (the
    last one of 5 rollouts in chunks of 4) raises the JAX package's error
    on every rank, before any decode."""
    runs = _drill(tmp_path, "baddiv", (1, 2, 1, 1), method=dict(chunk_size=4, num_rollouts=5))
    for code, out, _ in runs:
        assert code != 0 and "rollout chunk of 1 rows does not divide evenly over 2 processes" in out, out[-3000:]


# ------------------------------------------------- the overlap on the mesh


def test_collective_producer_reads_boundary_n_minus_s():
    """On several processes a store's weights must not depend on timing:
    with ``prepare`` adopting before a store counts as started and the
    boundary staged only after ``wait_due_started``, store n reads boundary
    n - S at staleness S = 2 (the initial weights for n <= 2), however slow
    the producer is against the train loop."""
    import threading

    from trlx_tpu_torch.pipeline.overlap import RolloutProducer

    stage = {"version": 0}
    adopted, read = {}, {}

    def prepare(snapshot):
        adopted["version"] = stage["version"]

    def produce(store, index, snapshot, staleness, stop):
        read[index] = adopted["version"]
        threading.Event().wait(0.05 * (index % 2))  # an uneven producer
        store.append(index)

    producer = RolloutProducer(produce, list, max_staleness=2, collective=True, prepare=prepare).start()
    for boundary in range(1, 6):
        assert producer.next_store(timeout=10) == [boundary]
        producer.wait_due_started()
        stage["version"] = boundary  # the take at this boundary
        producer.consume_done()
    producer.shutdown()
    assert read == {n: max(0, n - 2) for n in range(1, 8)}


@pytest.mark.parametrize("collective", [False, True])
def test_producer_stops_at_the_same_point_on_every_rank(collective):
    """A stop poll's answer depends on a rank's timing, so on several
    processes (``collective``) the producer never stops a phase, and after
    shutdown it finishes exactly the stores whose gate the final consumed
    count opens (here 2 and 3 at staleness 2 after one consumed iteration),
    the same on every rank; one process stops mid-phase at once."""
    import threading

    from trlx_tpu_torch.pipeline.overlap import RolloutProducer

    started, stops, release = [], [], threading.Event()

    def produce(store, index, snapshot, staleness, stop):
        started.append(index)
        release.wait(5)
        stops.append(stop())

    producer = RolloutProducer(produce, list, max_staleness=2, collective=collective).start()
    producer.consume_done()  # the gate opens for stores up to 3
    for _ in range(100):
        if started:
            break
        threading.Event().wait(0.01)
    threading.Timer(0.2, release.set).start()
    producer.shutdown(timeout=5)
    assert not producer.alive
    if collective:
        assert started == [1, 2, 3] and stops == [False, False, False]
    else:
        assert started == [1] and stops == [True]


def test_overlap_on_mesh_staleness_0_equals_serial_and_staleness_1_runs(tmp_path):
    """On [1, 2, 2, 1] (4 ranks) with the engine: the overlapped pipeline at
    staleness 0 (the producer and its score worker on the second group set)
    is bit-equal to the serial run, step statistics and parameters; at
    staleness 1, with int8 decode weights and the sharded boundary snapshot,
    it runs two rollout iterations to its end with the consistency guard on
    every step and records staleness at most 1."""
    cfg = case.ppo_config("unused", (1, 2, 2, 1), arch=dict(case._arch(), vocab_size=V))
    runs = {"serial": {}, "overlap0": {"method": dict(rollout_overlap=True)},
            "stale1": {"method": dict(max_staleness=1, prefetch_depth=1), "model": dict(decode_weight_quant=True)}}
    data = dict(case="overlap_mesh", task=case.task(vocab=V), config=cfg, shape=(1, 2, 2, 1), dir=str(tmp_path),
                runs=runs, train=dict(total_steps=4, epochs=2, desync_check_interval=1),
                method=dict(rollout_engine=True, engine_slots=4, prefill_batch=2, engine_steps_per_sync=2))
    got = torch_sp_worker.spawn("dist", 4, data, str(tmp_path / "w"), TIMEOUT)
    r0 = got[0]
    assert r0["serial"]["iter_count"] == r0["overlap0"]["iter_count"] == r0["stale1"]["iter_count"] == 4
    assert r0["overlap0"]["stats"] == r0["serial"]["stats"]
    for rank in got:
        for name, p in rank["serial"]["params"].items():
            np.testing.assert_array_equal(rank["overlap0"]["params"][name], p, err_msg=name)
            np.testing.assert_array_equal(rank["stale1"]["params"][name], r0["stale1"]["params"][name], err_msg=name)
    assert r0["stale1"]["staleness"] and max(r0["stale1"]["staleness"]) <= 1.0
    assert not r0["serial"]["producer_groups"] and r0["overlap0"]["producer_groups"] and r0["stale1"]["producer_groups"]
    # The producer decoded from the snapshot's fsdp-gathered copies and its
    # own int8 copies; every rank's engine made the same decisions in each
    # of the two phases.
    assert r0["stale1"]["snapshot_held"] > 0 and r0["stale1"]["snapshot_w8"] > 0
    assert len(r0["stale1"]["crcs"]) >= 2 and all(r["stale1"]["crcs"] == r0["stale1"]["crcs"] for r in got)
    assert all(np.isfinite(v).all() for v in r0["stale1"]["params"].values())
