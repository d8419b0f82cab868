"""The overlapped rollout/train pipeline of the port
(``trlx_tpu_torch.pipeline.overlap``, the trainer's producer and the
boundary snapshot), twin of ``tests/test_overlap.py``.

- The threading pieces (PrefetchIterator, SerialFeed, ScoreWorker,
  PhaseTimer, RolloutProducer) and the store's staleness column, as the JAX
  tests hold them; the producer's ``history`` equals the JAX producer's for
  the same schedule.
- ``trlx_tpu_torch.train`` on randomwalks: at ``rollout_overlap: true,
  max_staleness: 0`` the run is bit-equal to the port's serial run (tokens,
  step stats, final parameters); at ``max_staleness: 1`` it trains and
  reports ``staleness/mean``; a reward_fn that hangs and raises inside the
  score worker drains cleanly.
- The boundary snapshot: a store produced from a snapshot while the live
  weights were moved (a large learning rate) equals, bit for bit, a serial
  rollout from the boundary weights, with and without int8 decode weights.
- No ``trlx-*`` thread outlives ``learn()``: after a normal return, an
  exception raised in the producer, and a SIGTERM.

Every wait here is bounded (``timeout=`` on every result, next_store, join
and wait_until), so a hang fails a test instead of the run.
"""

import dataclasses
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.pipeline.overlap import RolloutProducer as JaxRolloutProducer  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator  # noqa: E402
from trlx_tpu_torch.pipeline.overlap import (  # noqa: E402
    PhaseTimer,
    PrefetchIterator,
    RolloutProducer,
    ScoreWorker,
    SerialFeed,
)
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage  # noqa: E402
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline  # noqa: E402
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: E402

torch.set_num_threads(1)
WAIT = 30.0  # seconds: the bound on every wait in this file


def wait_until(cond, timeout=10.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def trlx_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("trlx-")]


# ------------------------------------------------------------- batch prefetch


def test_prefetch_iterator_ordering_and_exhaustion():
    feed = PrefetchIterator(range(10), transform=lambda x: x * 2, depth=3)
    assert list(feed) == [x * 2 for x in range(10)]
    with pytest.raises(StopIteration):
        next(feed)
    with pytest.raises(StopIteration):
        next(feed)
    feed.close()


def test_prefetch_iterator_transform_error_reraises_in_order():
    def transform(x):
        if x == 3:
            raise RuntimeError("boom at 3")
        return x

    feed = PrefetchIterator(range(6), transform=transform, depth=2)
    assert [next(feed), next(feed), next(feed)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="boom at 3"):
        while True:
            next(feed)
    feed.close()


def test_prefetch_iterator_close_unblocks_full_queue():
    feed = PrefetchIterator(range(1000), depth=1)
    assert next(feed) == 0
    feed.close()
    assert not feed._thread.is_alive()
    with pytest.raises(StopIteration):
        next(feed)


def test_serial_feed_is_lazy_and_inline():
    calls = []

    def transform(x):
        calls.append(x)
        return x + 1

    feed = SerialFeed([1, 2, 3], transform=transform)
    assert calls == []
    assert next(feed) == 2
    assert calls == [1]
    assert list(feed) == [3, 4]
    feed.close()


# --------------------------------------------------------------- score worker


def test_score_worker_fifo_results_and_busy_accounting():
    def fn(x):
        time.sleep(0.01)
        return x * 10

    w = ScoreWorker(fn, depth=2)
    for i in range(5):
        w.submit(i)
    assert [w.result(timeout=WAIT) for _ in range(5)] == [0, 10, 20, 30, 40]
    w.close()
    assert not w.alive
    assert w.busy_s > 0.0


def test_score_worker_error_propagates_and_close_never_deadlocks():
    def fn(x):
        if x == 1:
            raise ValueError("bad chunk")
        return x

    w = ScoreWorker(fn, depth=2)
    w.submit(0)
    w.submit(1)
    w.submit(2)
    assert w.result(timeout=WAIT) == 0
    with pytest.raises(ValueError, match="bad chunk"):
        w.result(timeout=WAIT)
    w.close()
    assert not w.alive


# ---------------------------------------------------------------- phase timer


def test_phase_timer_window_keys_and_overlap_fraction():
    timer = PhaseTimer()
    timer.add("rollout", 1.0)
    timer.add("score", 1.0)
    with timer.timed("train"):
        time.sleep(0.01)
    w = timer.window()
    for k in ("time/rollout_s", "time/score_s", "time/train_s", "time/window_wall_s", "time/overlap_fraction"):
        assert k in w
    assert w["time/rollout_s"] == pytest.approx(1.0)
    assert 0.0 < w["time/overlap_fraction"] <= 1.0
    w2 = timer.window()
    assert w2["time/rollout_s"] == 0.0
    assert w2["time/overlap_fraction"] == 0.0


def test_phase_timer_serial_phases_report_no_overlap():
    timer = PhaseTimer()
    with timer.timed("rollout"):
        time.sleep(0.02)
    with timer.timed("train"):
        time.sleep(0.02)
    assert timer.window()["time/overlap_fraction"] == pytest.approx(0.0, abs=0.05)


# ----------------------------------------------------------- rollout producer


def _producer(max_staleness, log, chunk_sleep=0.0, cls=RolloutProducer):
    def produce(store, index, snapshot, staleness, stop):
        if chunk_sleep:
            for _ in range(50):
                if stop():
                    return
                time.sleep(chunk_sleep / 50)
        log.append((index, staleness, snapshot))
        store.append(index)

    return cls(produce, new_store=list, max_staleness=max_staleness)


def test_producer_staleness_zero_blocks_until_consume():
    log = []
    p = _producer(0, log).start()
    try:
        time.sleep(0.3)
        assert log == [] and p.pending == 0
        p.consume_done()
        assert p.next_store(timeout=WAIT) == [1]
        assert log[0][:2] == (1, 0)
        time.sleep(0.3)
        assert len(log) == 1
    finally:
        p.shutdown(timeout=WAIT)
    assert not p.alive


def test_producer_staleness_one_runs_ahead_and_records_staleness():
    log = []
    p = _producer(1, log).start(snapshot="snap0")
    try:
        assert wait_until(lambda: p.pending == 1)
        assert log[0] == (1, 1, "snap0")
        time.sleep(0.3)
        assert len(log) == 1
        p.consume_done(snapshot="snap1")
        assert p.next_store(timeout=WAIT) == [1]
        assert wait_until(lambda: len(log) == 2)
        assert log[1] == (2, 1, "snap1")
    finally:
        p.shutdown(timeout=WAIT)


def test_producer_error_reraises_from_next_store():
    err = RuntimeError("producer died")

    def produce(store, index, snapshot, staleness, stop):
        raise err

    p = RolloutProducer(produce, new_store=list, max_staleness=0).start()
    p.consume_done()
    with pytest.raises(RuntimeError) as ei:
        p.next_store(timeout=WAIT)
    assert ei.value is err
    p.shutdown(timeout=WAIT)


def test_producer_shutdown_drains_mid_phase():
    log = []
    p = _producer(1, log, chunk_sleep=30.0).start()
    assert wait_until(lambda: p.alive)
    t0 = time.time()
    p.shutdown(timeout=WAIT)
    assert time.time() - t0 < 10
    assert not p.alive
    assert p.pending == 0


@pytest.mark.parametrize("max_staleness", [0, 1, 2])
def test_producer_history_matches_jax_schedule(max_staleness):
    """The same consume schedule, with versioned dict snapshots, through the
    port's producer and the JAX package's: equal ``history`` (index,
    staleness, version of every store)."""
    histories = []
    for cls in (RolloutProducer, JaxRolloutProducer):
        p = _producer(max_staleness, [], cls=cls).start(snapshot={"version": 0} if max_staleness else None)
        try:
            for it in range(1, 6):
                if max_staleness:
                    # Let the producer run as far ahead as the gate allows.
                    assert wait_until(lambda: p.pending >= min(max_staleness, 6 - it), timeout=WAIT)
                p.consume_done(snapshot={"version": it} if max_staleness else None)
                p.next_store(timeout=WAIT)
        finally:
            p.shutdown(timeout=WAIT)
        histories.append(list(p.history))
    assert histories[0] == histories[1]
    assert [h["index"] for h in histories[0]][:5] == [1, 2, 3, 4, 5]


# ------------------------------------------------------- store staleness column


def _rows(n, val=0.0, staleness=None):
    rows = {
        "query_tensors": np.ones((n, 3), np.int32),
        "query_mask": np.ones((n, 3), np.int32),
        "response_tensors": np.ones((n, 5), np.int32),
        "response_mask": np.ones((n, 5), np.int32),
        "logprobs": np.full((n, 5), val, np.float32),
        "values": np.zeros((n, 5), np.float32),
        "rewards": np.zeros((n, 5), np.float32),
    }
    if staleness is not None:
        rows["staleness"] = np.full((n, 1), staleness, np.float32)
    return rows


def test_store_staleness_column_surfaces_in_batch_extras():
    store = PPORolloutStorage(pad_token_id=0, record_staleness=True)
    store.push_batch(_rows(8))
    store.push_batch(_rows(8, staleness=2.0))
    batch = next(iter(store.create_loader(16, shuffle=False)))
    assert batch.extras is not None
    st = np.asarray(batch.extras["staleness"])
    assert st.shape == (16,)
    assert st[:8].tolist() == [0.0] * 8
    assert st[8:].tolist() == [2.0] * 8


def test_store_without_staleness_keeps_serial_layout():
    store = PPORolloutStorage(pad_token_id=0)
    store.push_batch(_rows(8))
    assert next(iter(store.create_loader(8, shuffle=False))).extras is None


# ------------------------------------------------------------ e2e acceptance


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


def _port_config(ckpt_dir, **method):
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = 8
    config.train.epochs = 4
    config.train.batch_size = 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = str(ckpt_dir)
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    for k, v in method.items():
        setattr(config.method, k, v)
    return config


PROMPTS = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]


def _run_ppo(task, ckpt_dir, **method):
    _, logit_mask, metric_fn, reward_fn = task
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=[[1]], metric_fn=metric_fn,
                                 config=_port_config(ckpt_dir, **method), logit_mask=logit_mask, device="cpu")
    with open(os.path.join(str(ckpt_dir), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return model, records


STEP_KEYS = ("loss", "pg_loss", "vf_loss", "mean_kl", "mean_return", "grad_norm", "learning_rate")


def test_overlap_at_staleness_zero_matches_serial_exactly(task, tmp_path):
    """rollout_overlap at max_staleness 0 runs the producer, the score
    worker and the prefetch feed, yet gives the serial run's step stats,
    rollouts and final parameters bit for bit."""
    serial_model, serial = _run_ppo(task, tmp_path / "serial")
    model, overlap = _run_ppo(task, tmp_path / "overlap", rollout_overlap=True)

    steps = lambda recs: [{k: r[k] for k in STEP_KEYS} for r in recs if "loss" in r]  # noqa: E731
    assert len(steps(serial)) == 8
    assert steps(overlap) == steps(serial)
    exp = lambda recs: [r["rollout_mean_score"] for r in recs if "exp_time" in r]  # noqa: E731
    assert exp(overlap) == exp(serial) and len(exp(serial)) >= 2
    # The last store's rows (tokens and stats) are the serial run's.
    a, b = serial_model.store.columns(), model.store.columns()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for (n, p), (_, q) in zip(serial_model.model.named_parameters(), model.model.named_parameters()):
        assert torch.equal(p, q), n

    assert model._rollout_producer is None
    assert trlx_threads() == []
    assert any("time/overlap_fraction" in r for r in overlap)
    assert any("time/rollout_s" in r for r in overlap)
    stale = [r["staleness/mean"] for r in overlap if "staleness/mean" in r]
    assert stale and all(s == 0.0 for s in stale)
    assert not any("staleness/mean" in r for r in serial)
    # The serial schedule logs its phase window too.
    assert any("time/overlap_fraction" in r for r in serial)


def test_max_staleness_one_trains_and_reports_staleness(task, tmp_path):
    model, records = _run_ppo(task, tmp_path / "stale", max_staleness=1)
    assert model.iter_count >= 8
    stale = [r["staleness/mean"] for r in records if "staleness/mean" in r]
    assert stale and stale[0] == 0.0 and stale[-1] == 1.0
    assert any("time/overlap_fraction" in r for r in records)
    # The producer read boundary snapshots: the last one it adopted is a
    # boundary after iteration 0's.
    assert [r["exp_staleness"] for r in records if "exp_staleness" in r][:2] == [0.0, 1.0]
    assert model._snapshot_weights.version > 0
    assert trlx_threads() == []


# ---------------------------------------------------------------- hang drill


def test_reward_hang_inside_score_worker_drains_cleanly(task, tmp_path):
    """A reward_fn that hangs and then raises (the user's own timeout) on the
    background scorer: the error re-raises on the make_experience thread and
    the worker is joined. A reward_fn that hangs and then returns fills the
    store, with its staleness column."""
    _, logit_mask, metric_fn, reward_fn = task
    config = _port_config(tmp_path / "ck", rollout_overlap=True)
    config.method.num_rollouts = 32
    config.train.reward_fn_retries = 0  # as the JAX twin: the error must surface, not be retried away
    calls = []

    def hanging_reward(samples):
        calls.append(len(samples))
        time.sleep(0.3)
        if len(calls) == 1:
            raise TimeoutError("reward_fn still running after 0.3 s")
        return reward_fn(samples)

    trainer = PPOTrainer(config, device="cpu", reward_fn=hanging_reward, metric_fn=metric_fn, logit_mask=logit_mask)
    assert trainer.overlap_rollouts
    orch = PPOOrchestrator(trainer, PromptPipeline([[1]] * 32, None, max_prompt_length=1), hanging_reward,
                           chunk_size=16)
    with pytest.raises(TimeoutError, match="still running"):
        orch.make_experience(num_rollouts=32)
    assert "trlx-score-worker" not in trlx_threads()

    store = PPORolloutStorage(pad_token_id=trainer.pad_token_id, record_staleness=True)
    orch.make_experience(num_rollouts=32, store=store, staleness=1)
    # Four calls: the failed phase's second chunk still drained on close.
    assert len(store) == 32 and len(calls) == 4
    assert np.all(store.columns()["staleness"] == 1.0)
    assert trlx_threads() == []


# ------------------------------------------------------- the boundary snapshot


def _hydra_config(tmp_path, w8: bool):
    config = _port_config(tmp_path, max_staleness=1)
    config.model.num_layers_unfrozen = 1  # a hydra branch: the fused rollout statistics
    config.model.decode_weight_quant = w8
    config.train.learning_rate_init = config.train.learning_rate_target = 0.5
    config.train.lr_ramp_steps = 0
    return config


@pytest.mark.parametrize("w8", [False, True], ids=["bf16-weights", "w8-weights"])
def test_staleness_one_store_equals_serial_rollout_from_boundary(task, tmp_path, w8):
    """A producer store generated from the boundary snapshot while the live
    weights were moved by large train steps equals, row for row and bit for
    bit, a serial rollout from the boundary weights (the same prompt chunks
    and sampling streams), with and without int8 decode weights; a serial
    rollout from the moved weights differs."""
    _, logit_mask, metric_fn, reward_fn = task
    pipe_prompts = PROMPTS[:16]

    def build(sub):
        trainer = PPOTrainer(_hydra_config(tmp_path / sub, w8), device="cpu", reward_fn=reward_fn,
                             logit_mask=logit_mask)
        orch = PPOOrchestrator(trainer, PromptPipeline(pipe_prompts, None, max_prompt_length=1), reward_fn,
                               chunk_size=16)
        return trainer, orch

    def serial_second_store(params, extras):
        ref, ref_orch = build(f"serial{len(os.listdir(tmp_path))}")
        ref.load_params(params, extras)
        ref_orch.make_experience(16)  # chunk 0, as the pipelined trainer's iteration 0
        ref.store.clear_history()
        ref_orch.make_experience(16)  # chunk 1: the chunk the producer's store reads
        return ref.store.columns()

    trainer, orch = build("pipelined")
    assert trainer.fused_rollout and trainer.decode_weight_quant == w8
    orch.make_experience(16)  # iteration 0's store, from the live weights
    boundary = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    snapshot = trainer._rollout_snapshot()  # the boundary handoff, before any step
    batch = trainer.put_batch(next(iter(trainer.store.create_loader(16))))
    for _ in range(3):  # move the live weights far
        trainer.train_step(batch)
    moved = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    assert max(float((moved[n] - boundary[n]).abs().max()) for n in moved) > 1e-2

    # The producer's store, on a thread of its own, as the RolloutProducer runs it.
    store = PPORolloutStorage(trainer.pad_token_id, record_staleness=True)
    worker = threading.Thread(target=orch.make_experience, args=(16, 3),
                              kwargs=dict(store=store, snapshot=snapshot, staleness=1), name="trlx-test-producer")
    worker.start()
    worker.join(timeout=WAIT)
    assert not worker.is_alive() and len(store) == 16
    assert snapshot["weights"].version == 0

    got, want = store.columns(), serial_second_store(boundary, trainer.extras)
    assert np.all(want.pop("staleness") == 0.0)  # the serial store's rows are on-policy
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.all(got["staleness"] == 1.0)
    assert not np.array_equal(serial_second_store(moved, trainer.extras)["logprobs"], want["logprobs"])


# ------------------------------------------------------------------ threads


def _small_run(tmp_path, task, reward_fn=None, **method):
    _, logit_mask, metric_fn, default_reward = task
    config = _port_config(tmp_path, **method)
    return dict(reward_fn=reward_fn or default_reward, prompts=PROMPTS, eval_prompts=[[1]], metric_fn=metric_fn,
                config=config, logit_mask=logit_mask, device="cpu")


@pytest.mark.parametrize("exit_path", ["return", "raise", "sigterm"])
def test_no_trlx_thread_survives_learn(task, tmp_path, monkeypatch, exit_path):
    """learn() at max_staleness 1 with prefetch: after it returns, after the
    producer raises (the error reaches learn()'s caller), and after a
    SIGTERM (a save, then None), no trlx-* thread is alive."""
    _, _, _, reward_fn = task
    calls = []

    def reward(samples):
        calls.append(1)
        if exit_path == "raise" and len(calls) > 1:
            raise RuntimeError("reward_fn failed in the producer")
        return reward_fn(samples)

    if exit_path == "sigterm":
        orig = PPOTrainer.post_backward_callback

        def post_backward(self, stats=None):
            orig(self, stats)
            if self.iter_count == 3:
                os.kill(os.getpid(), signal.SIGTERM)

        monkeypatch.setattr(PPOTrainer, "post_backward_callback", post_backward)
    kw = _small_run(tmp_path, task, reward_fn=reward, max_staleness=1, prefetch_depth=2)
    if exit_path == "raise":
        with pytest.raises(RuntimeError, match="failed in the producer"):
            trlx_tpu_torch.train(**kw)
    else:
        trlx_tpu_torch.train(**kw)
        if exit_path == "sigterm":
            with open(tmp_path / "metrics.jsonl") as f:
                assert any("preempted_at_step" in json.loads(line) for line in f)
    assert trlx_threads() == []
