"""Checkpointing and resume in the port (``trlx_tpu_torch.resilience.checkpoint``
and ``BaseTrainer.save`` / ``load`` / ``learn``), and the BaseRL protocol.

- The checkpoint utilities: torch twins of the JAX package's
  ``tests/test_resilience.py`` checkpoint-hardening tests (atomic writes,
  manifests, retention GC), plus the crc taken while a file is written.
- The trainer: twins of ``tests/test_resilience.py``'s trainer-level
  checkpoint tests and of ``tests/test_e2e.py``'s save/load, preemption and
  resume tests (the SIGTERM comes from a patched ``post_backward_callback``:
  fault plans are not ported), on a tiny f32 PPO config.
- A bit-exact round trip (parameters, moments, the applied-update count,
  extras, step, host state) for PPO and ILQL, copied in place into the live
  tensors; a load refreshes the model's bf16 weight copies; interval saves
  with ``keep_checkpoints`` retention; async saves.
- Twins of ``tests/test_protocol.py``'s ``sample`` and ``act`` tests.

The resumed runs against the JAX package's are ``tests/test_torch_resume.py``.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.resilience import CheckpointError
from trlx_tpu_torch.resilience import checkpoint as ckpt_util
from trlx_tpu_torch.trainer.ilql import ILQLTrainer
from trlx_tpu_torch.trainer.ppo import PPOTrainer

torch.set_num_threads(1)

V, P, R = 31, 6, 4


# ------------------------------------------------------- checkpoint hardening


def _fake_checkpoint(directory, step, payload=b"x" * 4096):
    name = f"state_{step}"
    path = os.path.join(directory, name, "shard")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "data.bin"), "wb") as f:
        f.write(payload)
    with open(os.path.join(directory, name, "meta.json"), "w") as f:
        f.write("{}")
    ckpt_util.write_manifest(directory, name, step)
    return name


def test_atomic_write_replaces_not_appends(tmp_path):
    p = str(tmp_path / "latest.txt")
    ckpt_util.atomic_write_text(p, "state_1")
    ckpt_util.atomic_write_text(p, "state_22")
    with open(p) as f:
        assert f.read() == "state_22"
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]  # no litter


def test_manifest_verifies_and_catches_truncation(tmp_path):
    d = str(tmp_path)
    name = _fake_checkpoint(d, 3)
    ok, reason = ckpt_util.verify_checkpoint(d, name)
    assert ok, reason
    with open(ckpt_util.manifest_path(d, name)) as f:
        assert json.load(f)["versions"] == {"torch": torch.__version__}

    rel = ckpt_util.corrupt_checkpoint(d, name)  # truncates the largest file
    assert rel is not None
    ok, reason = ckpt_util.verify_checkpoint(d, name)
    assert not ok and "truncated" in reason

    # a missing manifest (pre-manifest checkpoint) passes with a note
    os.remove(ckpt_util.manifest_path(d, name))
    ok, reason = ckpt_util.verify_checkpoint(d, name)
    assert ok and "no manifest" in reason

    # a missing directory never verifies
    ok, _ = ckpt_util.verify_checkpoint(d, "state_404")
    assert not ok


def test_gc_keeps_newest_and_protected(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        _fake_checkpoint(d, step)
        ckpt_util.atomic_write_json(os.path.join(d, f"state_{step}.host.json"), {})

    assert ckpt_util.gc_checkpoints(d, keep=0) == []  # 0 disables retention
    removed = ckpt_util.gc_checkpoints(d, keep=2, protect=("state_1",))
    assert removed == ["state_2"]  # state_1 protected, 3+4 newest
    assert ckpt_util.list_checkpoints(d) == ["state_4", "state_3", "state_1"]
    # sidecars of the removed checkpoint are gone too
    assert not os.path.exists(os.path.join(d, "state_2.host.json"))
    assert not os.path.exists(ckpt_util.manifest_path(d, "state_2"))


def test_gc_never_deletes_latest_pointer_or_in_use(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        _fake_checkpoint(d, step)
    ckpt_util.atomic_write_text(os.path.join(d, "latest.txt"), "state_1")

    with ckpt_util.mark_in_use(d, "state_2"):
        # keep=2 would normally drop state_3/2/1 — but 1 is the latest
        # pointer and 2 is mid-restore.
        assert ckpt_util.gc_checkpoints(d, keep=2) == ["state_3"]
        assert sorted(ckpt_util.list_checkpoints(d)) == ["state_1", "state_2", "state_4", "state_5"]
    # marker gone on clean exit: the next GC may collect state_2, but the
    # latest pointer stays protected
    assert ckpt_util.gc_checkpoints(d, keep=2) == ["state_2"]
    assert ckpt_util.latest_pointer(d) == "state_1"
    assert "state_1" in ckpt_util.list_checkpoints(d)

    # a stale marker (killed reader) ages out instead of pinning forever
    marker = os.path.join(d, "state_4.inuse.99999")
    ckpt_util.atomic_write_json(marker, {})
    old = time.time() - 2 * ckpt_util.IN_USE_MAX_AGE
    os.utime(marker, (old, old))
    assert "state_4" not in ckpt_util._names_in_use(d)


def test_digest_writer_matches_a_read_of_the_file(tmp_path):
    """The (size, crc32) taken while ``torch.save`` writes equals a read of
    the file, so the manifest built from it verifies."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "state_7"))
    rng = np.random.default_rng(0)
    obj = {"a": torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32)), "count": 3,
           "b": {"c": torch.arange(11, dtype=torch.int64)[::2]}}
    path = os.path.join(d, "state_7", "params.pt")
    with ckpt_util.DigestWriter(path) as w:
        torch.save(obj, w)
    assert (w.size, w.crc) == ckpt_util._file_digest(path)
    ckpt_util.write_manifest(d, "state_7", 7, {"params.pt": (w.size, w.crc)})
    assert ckpt_util.verify_checkpoint(d, "state_7") == (True, "manifest verified")
    got = torch.load(path, weights_only=True)
    assert torch.equal(got["a"], obj["a"]) and torch.equal(got["b"]["c"], obj["b"]["c"]) and got["count"] == 3


# ------------------------------------------------------------- trainer level


def _config(ckpt_dir, model_type="ppo", **train):
    arch = dict(vocab_size=V, n_layer=2, n_head=2, d_model=16, max_position=32, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True})
    cfg = {
        "model": dict(model_path="", tokenizer_path="", model_type=model_type, num_layers_unfrozen=1,
                      model_arch=arch, dtype="float32", param_dtype="float32"),
        "train": dict(dict(total_steps=8, seq_length=P + R, epochs=4, batch_size=8, lr_ramp_steps=2,
                           lr_decay_steps=12, weight_decay=1e-4, learning_rate_init=3e-3,
                           learning_rate_target=3e-4, checkpoint_interval=10**6, eval_interval=100,
                           checkpoint_dir=str(ckpt_dir), seed=11), **train),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3,
                       target=1.0, horizon=50,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }
    if model_type == "ilql":
        cfg["train"]["orchestrator"] = "OfflineOrchestrator"
        cfg["method"] = dict(name="ilqlconfig", alpha=0.1, steps_for_target_q_sync=1, two_qs=True,
                             gen_kwargs=dict(prompt_length=P, max_new_tokens=R, top_k=8, do_sample=False))
    return cfg


def _prompts(n=16):
    rng = np.random.default_rng(1)
    return [rng.integers(1, V, size=int(rng.integers(2, P + 1))).tolist() for _ in range(n)]


def _reward_fn(samples):
    return [float(np.sum(s) % 7) - 3.0 for s in samples]


def _train(ckpt_dir, **train):
    return trlx_tpu_torch.train(reward_fn=_reward_fn, prompts=_prompts(), eval_prompts=_prompts(4),
                                config=TRLConfig.from_dict(_config(ckpt_dir, **train)), device="cpu")


def _trainer(ckpt_dir, seed=11, **train):
    return PPOTrainer(TRLConfig.from_dict(_config(ckpt_dir, seed=seed, **train)), device="cpu",
                      reward_fn=_reward_fn)


def _sigterm_at(monkeypatch, step):
    """Deliver a real SIGTERM from the trainer's post_backward_callback once
    ``iter_count`` reaches ``step``."""
    fired = {"done": False}
    orig = PPOTrainer.post_backward_callback

    def fire_once(self, stats=None):
        orig(self, stats)
        if not fired["done"] and self.iter_count >= step:
            fired["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(PPOTrainer, "post_backward_callback", fire_once)
    return fired


def _state(trainer):
    """Every tensor of the train state by name, and the scalars."""
    out = {f"param/{n}": p.detach().clone() for n, p in trainer.model.named_parameters()}
    out.update({f"extra/{n}": t.clone() for n, t in trainer.extras.items()})
    opt = trainer.optimizer.state_dict()
    out.update({f"{k}/{n}": t.clone() for k in ("mu", "nu") for n, t in opt[k].items()})
    scalars = {"count": opt["count"], "step": trainer.step, "bad_steps": trainer.bad_steps,
               "host": trainer.host_state_dict()}
    return out, scalars


def _assert_state_equal(a, b):
    (ta, sa), (tb, sb) = a, b
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert sa == sb


def test_load_without_any_checkpoint_is_actionable(tmp_path):
    trainer = _trainer(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="resume_from_checkpoint"):
        trainer.load(str(tmp_path / "empty"))

    # latest.txt pointing at a checkpoint that no longer exists: a clear
    # CheckpointError naming the candidate, not a raw FileNotFoundError
    d = tmp_path / "dangling"
    os.makedirs(d)
    ckpt_util.atomic_write_text(str(d / "latest.txt"), "state_99")
    with pytest.raises(CheckpointError, match="state_99"):
        trainer.load(str(d))


def test_async_save_defers_sidecars_until_finalize(tmp_path):
    d = str(tmp_path / "ck")
    trainer = _trainer(d, async_checkpointing=True)
    trainer.save(d, block=False)
    # the pointer flips only at finalize: a crash mid-save leaves the
    # previous checkpoint as the resume point
    assert not os.path.exists(os.path.join(d, "latest.txt"))
    name = trainer._finalize_pending_save()
    assert name == "state_0"
    with open(os.path.join(d, "latest.txt")) as f:
        assert f.read().strip() == "state_0"
    ok, reason = ckpt_util.verify_checkpoint(d, "state_0")
    assert ok, reason
    assert os.path.exists(os.path.join(d, "state_0.host.json"))
    rec = trainer.checkpoint_log[-1]
    assert rec["op"] == "save" and rec["async"] and rec["bytes"] == sum(
        os.path.getsize(os.path.join(d, "state_0", f)) for f in os.listdir(os.path.join(d, "state_0")))


def test_async_save_writes_the_state_at_save_time(tmp_path):
    """The state is copied at ``save(block=False)``: changes to the live
    tensors while the writer runs do not reach the checkpoint."""
    d = str(tmp_path / "ck")
    trainer = _trainer(d)
    want = _state(trainer)
    trainer.save(d, block=False)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
        for m in trainer.optimizer.mu:
            m.add_(1.0)
    trainer.step = 5
    assert trainer.load(d) == "state_0"  # load() finalizes the pending save first
    _assert_state_equal(_state(trainer), want)


def test_save_retention_and_fallback_restore(tmp_path):
    d = str(tmp_path / "ck")
    trainer = _trainer(d, keep_checkpoints=2)
    for _ in range(3):  # saves state_0, state_1, state_2
        trainer.save(d)
        trainer.step += 1
    assert ckpt_util.list_checkpoints(d) == ["state_2", "state_1"]  # GC'd state_0

    # corrupt the latest: load() must fall back to the previous intact one
    ckpt_util.corrupt_checkpoint(d, "state_2")
    assert trainer.load(d) == "state_1"
    assert trainer.last_restore_fallback is True
    assert trainer.step == 1


def test_preemption_resume_restores_step_and_host_state(tmp_path, monkeypatch):
    """SIGTERM mid-run: the checkpoint lands after the current step, learn()
    returns without evaluating, and a fresh trainer with
    resume_from_checkpoint continues from the saved step with the saved
    host state (the port keeps no RNG key: its generators are pure functions
    of the seed and their keys)."""
    d = str(tmp_path / "ck")
    fired = _sigterm_at(monkeypatch, 2)
    evals = []
    monkeypatch.setattr(PPOTrainer, "evaluate", lambda self: evals.append(self.iter_count) or {})
    model = _train(d, total_steps=50, epochs=100)
    assert fired["done"] and model.iter_count == 2 and evals == []  # preempted, not finished
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # the handler was restored
    with open(os.path.join(d, "latest.txt")) as f:
        assert f.read().strip() == "state_2"
    with open(os.path.join(d, "state_2.host.json")) as f:
        saved = json.load(f)
    assert set(saved) == {"resilience", "kl_coef"} and saved["kl_coef"] == model.kl_ctl.value
    with open(os.path.join(d, "metrics.jsonl")) as f:
        assert {"preempted_at_step": 2.0} in [{k: v for k, v in r.items() if k == "preempted_at_step"}
                                              for r in map(json.loads, f)]

    resumed = _trainer(d, resume_from_checkpoint=True)
    assert resumed._resumed and resumed.step == 2
    assert resumed.host_state_dict() == saved
    _assert_state_equal(_state(resumed), _state(model))


def test_checkpoint_save_load(tmp_path):
    d = str(tmp_path / "ck")
    model = _train(d, total_steps=2)
    assert model.step == 2
    want = _state(model)
    assert model.load() == "state_2"
    _assert_state_equal(_state(model), want)


def test_preemption_checkpoints_and_stops(tmp_path, monkeypatch):
    """SIGTERM mid-training saves a resumable checkpoint at the next step
    boundary and stops cleanly."""
    fired = _sigterm_at(monkeypatch, 2)
    model = _train(tmp_path, total_steps=50, epochs=100)
    assert fired["done"]
    assert model.iter_count < 50  # stopped at the preemption boundary
    with open(os.path.join(str(tmp_path), "latest.txt")) as f:
        assert f.read().strip()
    model.load()  # the checkpoint restores


def test_sigterm_during_rollout_saves_at_the_batch_boundary(tmp_path, monkeypatch):
    """A SIGTERM that lands in the rollout phase (post_epoch_callback) is
    acted on at the next batch boundary, before another step."""
    orig = PPOTrainer.post_epoch_callback

    def rollout_then_sigterm(self):
        orig(self)
        os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(PPOTrainer, "post_epoch_callback", rollout_then_sigterm)
    model = _train(tmp_path, total_steps=50, epochs=100)
    assert model.iter_count == 4 and ckpt_util.latest_pointer(str(tmp_path)) == "state_4"


def test_resume_from_checkpoint_continues_training(tmp_path):
    """train.resume_from_checkpoint restores the full state and continues
    counting from the saved step."""
    d = tmp_path / "ck"
    first = _train(d, total_steps=2)
    assert first.step == 2
    second = _train(d, total_steps=5, resume_from_checkpoint=True)
    # picked up at step 2 and trained only the remaining 3 steps
    assert second.step == 5 and second.iter_count == 5
    assert second.optimizer.count == 5


def test_resume_restores_host_state(tmp_path):
    """The adaptive KL coefficient is host-side Python state; a resume
    restores it."""
    d = tmp_path / "ck"
    first = _train(d, total_steps=2)
    first.kl_ctl.value = 0.0123  # pretend the controller adapted
    first.save()
    second = _train(d, total_steps=4, resume_from_checkpoint=True)
    # restored at construction, then adapted during the 2 resumed steps,
    # but never reset to init_kl_coef (0.3 in this config)
    assert second.kl_ctl.value != first.config.method.init_kl_coef
    assert second.kl_ctl.value == pytest.approx(0.0123, rel=0.2)


def test_resumed_run_that_already_finished_only_evaluates(tmp_path, monkeypatch):
    d = tmp_path / "ck"
    _train(d, total_steps=2)
    steps = []
    monkeypatch.setattr(PPOTrainer, "train_step", lambda self, b: steps.append(1))
    model = _train(d, total_steps=2, resume_from_checkpoint=True)
    assert model.iter_count == 2 and steps == []


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    trainer = _trainer(tmp_path / "none", resume_from_checkpoint=True)
    assert not trainer._resumed and trainer.step == 0


def test_kl_coef_restored_only_when_finite(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.load_host_state({"kl_coef": float("nan")})
    assert trainer.kl_ctl.value == 0.3
    trainer.load_host_state({"kl_coef": 0.25, "resilience": {"skipped_steps": 3, "rollbacks": 0, "lr_scale": 1.0}})
    assert trainer.kl_ctl.value == 0.25 and trainer.skipped_steps == 3


@pytest.mark.parametrize("method", ["ppo", "ilql"])
def test_round_trip_is_bit_exact_and_in_place(tmp_path, method):
    """Train 2 steps, save, and load into a trainer built from another seed:
    every parameter, moment and extra, the applied-update count, the step,
    the guard's counts and the host state equal the saver's bit for bit,
    and every live tensor keeps its address (a captured graph reads it)."""
    d = str(tmp_path / "ck")
    if method == "ppo":
        saver = _train(d, total_steps=2)
        fresh = _trainer(tmp_path / "other", seed=12)
    else:
        rng = np.random.default_rng(3)
        samples = [rng.integers(1, V, size=int(rng.integers(3, P + R + 3))).astype(np.int32) for _ in range(16)]
        rewards = rng.normal(size=16).tolist()
        saver = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=_prompts(4),
                                     config=TRLConfig.from_dict(_config(d, "ilql", total_steps=2)), device="cpu")
        fresh = ILQLTrainer(TRLConfig.from_dict(_config(tmp_path / "other", "ilql", seed=12)), device="cpu")
        assert sorted(saver.extras) == sorted(n for n, _ in saver.model.named_parameters()
                                              if n.startswith(("q1_head.", "q2_head.")))
    saver.skipped_steps = 1  # a guard skip to carry over
    saver.save()
    want = _state(saver)
    assert want[1]["step"] == 2 and want[1]["count"] == 2
    before = _state(fresh)
    addresses = [t.data_ptr() for t in (*fresh.model.parameters(), *fresh.extras.values(), *fresh.optimizer.mu,
                                        *fresh.optimizer.nu)]
    assert fresh.load(d) == "state_2"
    _assert_state_equal(_state(fresh), want)
    assert not torch.equal(before[0]["param/transformer.wte.embedding"], want[0]["param/transformer.wte.embedding"])
    assert addresses == [t.data_ptr() for t in (*fresh.model.parameters(), *fresh.extras.values(),
                                                *fresh.optimizer.mu, *fresh.optimizer.nu)]


def test_load_refuses_a_checkpoint_of_another_shape(tmp_path):
    d = str(tmp_path / "ck")
    _trainer(d).save()
    cfg = _config(tmp_path / "wide")
    cfg["model"]["model_arch"]["d_model"] = 32
    wide = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    with pytest.raises(CheckpointError, match="shape"):
        wide.load(d)


def test_load_refreshes_the_bf16_weight_copies(tmp_path):
    """The twin of ``test_torch_generate.py``'s optimizer-step refresh, with
    a load: after ``load()`` a no-grad pass, which reads the cached bf16
    copies, equals the saver's own pass on the loaded weights."""
    cfg = _config(tmp_path / "a")
    cfg["model"]["dtype"] = "bfloat16"
    a = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    cfg = _config(tmp_path / "b", seed=12)
    cfg["model"]["dtype"] = "bfloat16"
    b = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, V, size=(3, P + R)).astype(np.int32))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        before = a.model(ids, mask)["logits"]  # caches a bf16 copy of every weight
        ref = b.model(ids, mask)["logits"]
    b.save()
    a.load(str(tmp_path / "b"))
    with torch.no_grad():
        after = a.model(ids, mask)["logits"]
    assert not torch.equal(after, before)
    assert torch.equal(after, ref)


def test_interval_saves_with_retention(tmp_path):
    """``checkpoint_interval`` saves every 2 steps (async by default, each
    finalized by the next save or the exit), plus the final save;
    ``keep_checkpoints=2`` keeps the two newest."""
    d = str(tmp_path)
    model = _train(d, total_steps=8, checkpoint_interval=2, keep_checkpoints=2)
    saves = [r for r in model.checkpoint_log if r["op"] == "save"]
    # state_8 once: the stop at total_steps finds the interval save holding
    # this very state and writes nothing
    assert [r["name"] for r in saves] == ["state_2", "state_4", "state_6", "state_8"]
    assert [r["async"] for r in saves] == [True] * 4
    assert ckpt_util.list_checkpoints(d) == ["state_8", "state_6"]
    assert ckpt_util.latest_pointer(d) == "state_8"
    for name in ("state_8", "state_6"):
        assert ckpt_util.verify_checkpoint(d, name)[0]
    sync = _train(tmp_path / "sync", total_steps=4, checkpoint_interval=2, async_checkpointing=False)
    assert [(r["name"], r["async"]) for r in sync.checkpoint_log] == [("state_2", False), ("state_4", False)]


def _crash_on_rewrite(monkeypatch):
    """Patch the writer: the first write of a checkpoint name goes through;
    a later write of the same name leaves a torn file and fails, as a crash
    part way would. Returns the count of writes by name."""
    from trlx_tpu_torch.trainer import base

    orig, writes = base._write_state, {}

    def write(path, snapshot, result):
        name = os.path.basename(path).removesuffix(".tmp")
        writes[name] = writes.get(name, 0) + 1
        if writes[name] == 1:
            return orig(path, snapshot, result)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.pt"), "wb") as f:
            f.write(b"torn")
        result["error"] = OSError("writer died")

    monkeypatch.setattr(base, "_write_state", write)
    return writes


def test_final_save_at_an_interval_step_writes_once(tmp_path, monkeypatch):
    """``checkpoint_interval`` dividing ``total_steps`` (as the default
    configs have it), one checkpoint kept: the stop at ``total_steps`` does
    not write the interval save's checkpoint again, so the one checkpoint
    there is never torn down, and a resume restores it."""
    writes = _crash_on_rewrite(monkeypatch)
    d = str(tmp_path / "ck")
    model = _train(d, total_steps=4, epochs=100, checkpoint_interval=4, keep_checkpoints=1)
    assert writes == {"state_4": 1}
    assert ckpt_util.list_checkpoints(d) == ["state_4"] and ckpt_util.latest_pointer(d) == "state_4"
    assert ckpt_util.verify_checkpoint(d, "state_4")[0]
    resumed = _trainer(d, resume_from_checkpoint=True, keep_checkpoints=1)
    assert resumed.step == 4
    _assert_state_equal(_state(resumed), _state(model))


def test_a_failed_rewrite_leaves_the_named_checkpoint_intact(tmp_path, monkeypatch):
    """A second save of a step whose state changed (here the KL
    coefficient) is written beside the checkpoint ``latest.txt`` names: a
    writer that dies part way leaves that checkpoint whole and loadable."""
    writes = _crash_on_rewrite(monkeypatch)
    d = str(tmp_path / "ck")
    trainer = _trainer(d, keep_checkpoints=1)
    want = _state(trainer)
    trainer.save(d)
    trainer.kl_ctl.value = 0.0123
    with pytest.raises(CheckpointError, match="state_0"):
        trainer.save(d)
    assert writes == {"state_0": 2}
    assert ckpt_util.latest_pointer(d) == "state_0" and ckpt_util.verify_checkpoint(d, "state_0")[0]
    fresh = _trainer(d, seed=12)
    assert fresh.load(d) == "state_0" and not fresh.last_restore_fallback
    _assert_state_equal(_state(fresh), want)


def test_unnamed_optimizer_has_no_state_to_save():
    """Moments are keyed by parameter name: an optimizer built without names
    steps, but refuses to give or take a state."""
    from trlx_tpu_torch.trainer.base import ClippedAdamW

    params = [torch.zeros(3), torch.zeros(2)]
    opt = ClippedAdamW(params, lambda k: 1e-2, 0.9, 0.95, 0.0, 1.0)
    opt.step(params, [torch.ones(3), torch.ones(2)])
    with pytest.raises(ValueError, match="names"):
        opt.state_dict()
    named = ClippedAdamW(params, lambda k: 1e-2, 0.9, 0.95, 0.0, 1.0, names=["a", "b"])
    with pytest.raises(ValueError, match="names"):
        opt.load_state_dict(named.state_dict())


def test_intervals_fire_checkpoint_at_the_interval(tmp_path):
    trainer = _trainer(tmp_path, checkpoint_interval=3, log_interval=2)
    assert trainer.intervals(3) == {"do_checkpoint": True, "do_eval": False, "do_log": False}
    assert trainer.intervals(4)["do_checkpoint"] is False


# ---------------------------------------------------------- BaseRL protocol


def test_sample_honors_n_samples_and_length(tmp_path):
    trainer = _trainer(tmp_path)
    P_, R_ = trainer.prompt_length, trainer.response_length
    rng = np.random.default_rng(0)
    prompts = {"input_ids": rng.integers(1, V, size=(4, P_)).astype(np.int32),
               "attention_mask": np.ones((4, P_), np.int32)}
    # n_samples > batch: tiled
    out = trainer.sample(prompts, length=None, n_samples=6)
    assert np.asarray(out).shape[0] == 6
    # n_samples < batch: truncated
    out = trainer.sample(prompts, length=None, n_samples=2)
    assert np.asarray(out).shape[0] == 2
    # length clips the response region (never exceeds the configured R)
    out = trainer.sample(prompts, length=3, n_samples=4)
    assert np.asarray(out).shape[1] == P_ + min(3, R_)
    with pytest.warns(UserWarning, match="exceeds the configured response length"):
        out = trainer.sample(prompts, length=10 * R_, n_samples=4)
    assert np.asarray(out).shape[1] == P_ + R_


def test_act_returns_tokens_and_mask(tmp_path):
    trainer = _trainer(tmp_path)
    P_ = trainer.prompt_length
    rng = np.random.default_rng(1)
    data = {"input_ids": rng.integers(1, V, size=(8, P_)).astype(np.int32),
            "attention_mask": np.ones((8, P_), np.int32)}
    tokens, mask = trainer.act(data)
    assert np.asarray(tokens).shape == np.asarray(mask).shape
    assert np.asarray(tokens).shape == (8, P_ + trainer.response_length)


def test_trainers_derive_from_the_protocol(tmp_path):
    from trlx_tpu_torch.trainer import BaseRLTrainer

    trainer = _trainer(tmp_path)
    assert isinstance(trainer, BaseRLTrainer)
    trainer.push_to_store([])  # the store's push

    class ActOnly(BaseRLTrainer):  # learn, sample, save and load left out
        def act(self, data):
            return data

    with pytest.raises(TypeError, match="abstract"):
        ActOnly(trainer.config)
