"""The port's race sanitizer (``trlx_tpu_torch.utils.sanitize``,
``TRLX_TPU_SANITIZE=race``), twin of the race half of
``tests/test_sanitize.py``.

- Unarmed: plain ``threading`` primitives, every hook a no-op, no residue.
- Armed: the Eraser lockset tracker raises ``RaceViolation`` naming both
  sites of a two-thread conflict, and stays quiet under a common tracked
  lock or condition, a queue handoff marked with ``race_forget``, and
  concurrent reads; its registry is capped.
- The parser: an unknown mode raises as the JAX package's does, and the
  JAX package's ``dispatch`` and ``donation`` modes are refused by name.
- End to end: an overlapped port run at staleness 1 with race armed
  finishes with no violation, and its threads shared tracked fields.
"""

import dataclasses
import gc
import json
import os
import queue
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.utils import sanitize as jax_sanitize  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.utils import sanitize  # noqa: E402


@pytest.fixture(autouse=True)
def _sanitize_state(monkeypatch):
    """Each test starts unarmed and leaves no residue (a finished trainer
    is collected: the process-global collective guard reads its step)."""
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    sanitize.refresh()
    yield monkeypatch
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    sanitize.refresh()
    sanitize.clear_races()
    gc.collect()


def _arm(monkeypatch, modes):
    monkeypatch.setenv(sanitize.ENV_VAR, modes)
    sanitize.refresh()


class _Shared:
    pass


def _on_thread(fn, name="trlx-test-worker"):
    err = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            err.append(e)

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    if err:
        raise err[0]


# ------------------------------------------------------------------ parser


def test_unknown_mode_raises():
    os.environ[sanitize.ENV_VAR] = "race,bogus"
    with pytest.raises(ValueError, match="bogus"):
        sanitize.refresh()
    del os.environ[sanitize.ENV_VAR]
    sanitize.refresh()


@pytest.mark.parametrize("mode", ["dispatch", "donation"])
def test_jax_only_modes_are_refused_by_name(mode):
    """The JAX package accepts both; the port has no dispatch lock and no
    buffer donation, so each is refused with its reason."""
    os.environ[sanitize.ENV_VAR] = f"race,{mode}"
    try:
        jax_sanitize.refresh()  # the reference takes it
        with pytest.raises(ValueError, match=f"'{mode}'") as exc:
            sanitize.refresh()
        assert {"dispatch": "dispatch lock", "donation": "donation"}[mode] in str(exc.value)
    finally:
        del os.environ[sanitize.ENV_VAR]
        jax_sanitize.refresh()
        sanitize.refresh()


# ------------------------------------------------------------------- race


def test_unarmed_race_factories_are_plain_and_access_is_noop():
    lock = sanitize.make_lock("X.lock")
    cond = sanitize.make_condition("X.cv")
    assert type(lock) is type(threading.Lock())
    assert type(cond) is threading.Condition
    obj = _Shared()
    sanitize.race_access(obj, "f", write=True)
    _on_thread(lambda: sanitize.race_access(obj, "f", write=True))
    sanitize.race_forget(obj)
    assert len(sanitize._RACE_FIELDS) == 0 and sanitize.shared_fields() == []  # zero residue


def test_race_two_thread_conflict_names_both_sites(_sanitize_state):
    _arm(_sanitize_state, "race")
    obj = _Shared()
    _on_thread(lambda: sanitize.race_access(obj, "count", write=True))
    with pytest.raises(sanitize.RaceViolation) as exc:
        sanitize.race_access(obj, "count", write=True)
    msg = str(exc.value)
    assert "'count'" in msg and "_Shared" in msg
    assert "trlx-test-worker" in msg and "MainThread" in msg
    assert msg.count("test_torch_sanitize.py") >= 2  # both stacks point here
    assert sanitize.shared_fields() == ["_Shared.count"] and sanitize.violations() == [msg]
    # The raise resets the field to the current thread: no raise storm.
    sanitize.race_access(obj, "count", write=True)
    sanitize.clear_races()
    assert sanitize.violations() == [] and sanitize.shared_fields() == []


def test_race_common_tracked_lock_is_clean(_sanitize_state):
    _arm(_sanitize_state, "race")
    obj = _Shared()
    lock = sanitize.make_lock("Shared.lock")
    assert isinstance(lock, sanitize.TrackedLock)

    def locked_write():
        with lock:
            sanitize.race_access(obj, "count", write=True)

    _on_thread(locked_write)
    locked_write()  # the same lock on the main thread: the lockset stays non-empty


def test_race_tracked_condition_counts_as_held(_sanitize_state):
    _arm(_sanitize_state, "race")
    obj = _Shared()
    cv = sanitize.make_condition("Shared.cv")
    assert isinstance(cv, sanitize.TrackedCondition)

    def guarded():
        with cv:
            sanitize.race_access(obj, "ready", write=True)
            cv.notify_all()

    _on_thread(guarded)
    guarded()


def test_race_queue_handoff_with_forget_is_clean(_sanitize_state):
    """The handoff pattern: the worker builds the object and ships it
    through a Queue (a happens-before edge); the consumer marks the
    ownership transfer with race_forget before touching it."""
    _arm(_sanitize_state, "race")
    box = queue.Queue()

    def producer():
        obj = _Shared()
        sanitize.race_access(obj, "payload", write=True)
        obj.payload = 1
        box.put(obj)

    _on_thread(producer)
    obj = box.get(timeout=5)
    sanitize.race_forget(obj)
    sanitize.race_access(obj, "payload", write=True)  # no raise: new owner


def test_race_read_read_never_raises(_sanitize_state):
    _arm(_sanitize_state, "race")
    obj = _Shared()
    _on_thread(lambda: sanitize.race_access(obj, "cfg"))
    sanitize.race_access(obj, "cfg")  # concurrent reads are fine


def test_race_registry_is_capped(_sanitize_state):
    _arm(_sanitize_state, "race")
    keep = [_Shared() for _ in range(sanitize._RACE_CAP + 16)]
    for obj in keep:
        sanitize.race_access(obj, "f", write=True)
    assert len(sanitize._RACE_FIELDS) <= sanitize._RACE_CAP


def test_unarmed_port_run_leaves_no_residue(tmp_path):
    """Unarmed, a trainer's threads (heartbeat, producer, score worker,
    prefetch) leave nothing in the registry, and their locks are plain."""
    model, _ = _run_ppo(tmp_path, max_staleness=1, total_steps=2)
    assert model._rollout_producer_cv_type is threading.Condition
    assert type(model.heartbeat._lock) is type(threading.Lock())
    assert len(sanitize._RACE_FIELDS) == 0 and sanitize.shared_fields() == []


# -------------------------------------------------------------- end to end


PROMPTS = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]


def _run_ppo(ckpt_dir, total_steps=8, **method):
    """The overlap tests' randomwalks run (``tests/test_torch_overlap.py``),
    with a heartbeat; it also records the producer condition's type."""
    _, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = total_steps
    config.train.epochs = 4
    config.train.batch_size = 16
    config.train.eval_interval = 100
    config.train.heartbeat_interval = 0.05
    config.train.checkpoint_dir = str(ckpt_dir)
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    for k, v in method.items():
        setattr(config.method, k, v)
    from trlx_tpu_torch.pipeline import overlap

    seen = []
    real = overlap.RolloutProducer.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(type(self._cv))

    overlap.RolloutProducer.__init__ = spy
    try:
        model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=[[1]], metric_fn=metric_fn,
                                     config=config, logit_mask=logit_mask, device="cpu")
    finally:
        overlap.RolloutProducer.__init__ = real
    model._rollout_producer_cv_type = seen[0] if seen else None
    with open(os.path.join(str(ckpt_dir), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return model, records


def test_race_armed_overlap_run_is_clean(_sanitize_state, tmp_path):
    """Twin of ``tests/test_overlap.py::test_max_staleness_one_trains_and_reports_staleness``
    armed (race only: the port refuses the other two modes): the producer,
    score worker, prefetch and heartbeat threads run against the train loop
    with every declared shared field tracked, and the run ends with no
    RaceViolation and with fields that two threads touched."""
    _arm(_sanitize_state, "race")
    sanitize.clear_races()
    model, records = _run_ppo(tmp_path, max_staleness=1)
    assert model.iter_count >= 8
    assert model._rollout_producer_cv_type is sanitize.TrackedCondition
    stale = [r["staleness/mean"] for r in records if "staleness/mean" in r]
    assert stale and stale[0] == 0.0 and stale[-1] == 1.0
    shared = sanitize.shared_fields()
    assert len(shared) > 0 and sanitize.violations() == [], shared
    assert "RolloutProducer._consumed" in shared and "Heartbeat.beat_state" in shared
