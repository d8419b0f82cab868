"""Packed PPO train batches in the port (``method.pack_train_batch``) against
the JAX package.

- ``pack_ppo_batch`` and ``_pack_row_buckets`` give the JAX package's
  arrays, exactly, on the same numpy store columns.
- ``gae_advantages`` and ``ppo_loss`` with ``segment_ids`` / ``n_seqs`` give
  the JAX functions' values on the same inputs within 1e-6 (float32;
  summation order only), and the packed layout reproduces the unpacked
  per-episode values (twins of ``tests/test_losses.py``'s packed cases).
- The segment-masked forward of ``LMWithValueHead`` equals the JAX model's
  on the same weights (``params_from_jax``) within 2e-4, and packed rows
  reproduce separate rows (twin of
  ``tests/test_model.py::test_segment_ids_block_diagonal_attention``).
- ``trlx_tpu_torch.train`` with packing on trains and logs the throughput
  metrics; its step-1 loss equals the unpacked run's up to reassociation
  (twins of ``tests/test_e2e.py::test_ppo_e2e_packed_train_batch`` and
  ``::test_ppo_packed_losses_match_unpacked``).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.models.heads import LMWithValueHead as JaxLMWithValueHead  # noqa: E402
from trlx_tpu.models.lm import LMConfig as JaxLMConfig  # noqa: E402
from trlx_tpu.ops.rl_losses import gae_advantages as jax_gae  # noqa: E402
from trlx_tpu.ops.rl_losses import ppo_loss as jax_ppo_loss  # noqa: E402
from trlx_tpu.pipeline.ppo_pipeline import _pack_row_buckets as jax_pack_row_buckets  # noqa: E402
from trlx_tpu.pipeline.ppo_pipeline import pack_ppo_batch as jax_pack_ppo_batch  # noqa: E402
from trlx_tpu_torch.data import PackedPPOBatch, PPORLBatch  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.models.heads import LMWithValueHead  # noqa: E402
from trlx_tpu_torch.models.hf_import import params_from_jax  # noqa: E402
from trlx_tpu_torch.models.lm import LMConfig  # noqa: E402
from trlx_tpu_torch.ops.rl_losses import gae_advantages, ppo_loss  # noqa: E402
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage, _pack_row_buckets, pack_ppo_batch  # noqa: E402

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
KW = dict(gamma=0.95, lam=0.9, cliprange=0.2, cliprange_value=0.2, vf_coef=1.0)


def _store_columns(rng, B=12, P=6, R=7, staleness=False):
    """Store columns of B episodes: ragged left-padded queries, ragged
    right-padded responses (one empty), random stats."""
    q_lens = rng.integers(1, P + 1, size=B)
    r_lens = rng.integers(0, R + 1, size=B)
    r_lens[3] = 0
    g = {"query_tensors": np.zeros((B, P), np.int32), "query_mask": np.zeros((B, P), np.int32),
         "response_tensors": np.zeros((B, R), np.int32), "response_mask": np.zeros((B, R), np.int32)}
    for i in range(B):
        g["query_tensors"][i, P - q_lens[i]:] = rng.integers(1, 50, size=q_lens[i])
        g["query_mask"][i, P - q_lens[i]:] = 1
        g["response_tensors"][i, :r_lens[i]] = rng.integers(1, 50, size=r_lens[i])
        g["response_mask"][i, :r_lens[i]] = 1
    for k in ("logprobs", "values", "rewards"):
        g[k] = (rng.normal(size=(B, R)) * g["response_mask"]).astype(np.float32)
    if staleness:
        g["staleness"] = rng.integers(0, 3, size=(B, 1)).astype(np.float32)
    return g


@pytest.mark.parametrize("batch_size,rows_multiple", [(1, 1), (7, 1), (16, 1), (16, 4), (50, 3)])
def test_pack_row_buckets_equal_jax(batch_size, rows_multiple):
    assert _pack_row_buckets(batch_size, rows_multiple) == jax_pack_row_buckets(batch_size, rows_multiple)


@pytest.mark.parametrize("seed,rows_multiple,staleness", [(0, 1, False), (1, 2, True), (2, 1, True)])
def test_pack_ppo_batch_equal_jax(seed, rows_multiple, staleness):
    g = _store_columns(np.random.default_rng(seed), staleness=staleness)
    ours, theirs = pack_ppo_batch(g, 0, rows_multiple), jax_pack_ppo_batch(g, 0, rows_multiple)
    assert isinstance(ours, PackedPPOBatch)
    for f in dataclasses.fields(ours):
        if f.name != "extras":
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            assert (a is None and b is None) or np.array_equal(a, b), f.name
    assert ours.extras.keys() == theirs.extras.keys()
    for k in ours.extras:
        np.testing.assert_array_equal(ours.extras[k], theirs.extras[k], err_msg=k)
    assert ours.input_ids.shape[0] % rows_multiple == 0
    assert int(ours.loss_mask.sum()) == int(g["response_mask"][g["query_mask"].sum(1) > 0].sum())


def test_store_loader_packs_and_keeps_staleness():
    g = _store_columns(np.random.default_rng(5), B=16, staleness=True)
    store = PPORolloutStorage(pad_token_id=0, record_staleness=True)
    store.push_batch(g)
    packed = next(iter(store.create_loader(16, shuffle=False, pack=True)))
    plain = next(iter(store.create_loader(16, shuffle=False)))
    assert isinstance(packed, PackedPPOBatch) and isinstance(plain, PPORLBatch)
    np.testing.assert_array_equal(packed.extras["staleness"], g["staleness"][:, 0])
    np.testing.assert_array_equal(plain.extras["staleness"], g["staleness"][:, 0])
    assert 0 < packed.extras["pack_fill"] <= 1


def _segment_case(rng, rows=3, W=11):
    """Packed rows of several episodes each (segment ids 1.., 0 at padding)
    with rollout stats on their tokens."""
    seg = np.zeros((rows, W), np.int32)
    sid = 1
    for r in range(rows):
        o = 0
        while o < W - 1:
            L = int(rng.integers(1, 5))
            L = min(L, W - o - int(rng.integers(0, 2)))
            if L <= 0:
                break
            seg[r, o:o + L] = sid
            sid += 1
            o += L
    mask = (seg > 0).astype(np.float32)
    f = lambda: (rng.normal(size=(rows, W)) * mask).astype(np.float32)  # noqa: E731
    return seg, mask, f(), f(), f(), f(), f(), sid - 1


def test_gae_with_segments_equal_jax():
    seg, mask, r, v, *_ = _segment_case(np.random.default_rng(0))
    a, ret = gae_advantages(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(mask), 0.95, 0.9,
                            segment_ids=torch.from_numpy(seg))
    ja, jret = jax_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(mask), 0.95, 0.9, segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **LOSS_TOL)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), **LOSS_TOL)


def test_ppo_loss_with_segments_equal_jax():
    seg, mask, lp, v, olp, ov, r, n_seqs = _segment_case(np.random.default_rng(1))
    lp, olp = lp * 0.1, olp * 0.1
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    loss, stats = ppo_loss(t(lp), t(v), t(olp), t(ov), t(r), t(mask), segment_ids=t(seg), n_seqs=n_seqs, **KW)
    jloss, jstats = jax_ppo_loss(jnp.asarray(lp), jnp.asarray(v), jnp.asarray(olp), jnp.asarray(ov), jnp.asarray(r),
                                 jnp.asarray(mask), segment_ids=jnp.asarray(seg), n_seqs=n_seqs, **KW)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert stats.keys() == jstats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), err_msg=k, **LOSS_TOL)


def test_gae_segment_ids_match_unpacked():
    """Two episodes packed into one row == the same episodes in separate
    rows: the segment-gated recurrence resets the bootstrap and the carry."""
    rng = np.random.default_rng(4)
    r = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
    m = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], dtype=torch.float32)
    a_u, ret_u = gae_advantages(r, v, m, 0.95, 0.9)
    rp = torch.cat([r[0, :3], r[1, :4]])[None]
    vp = torch.cat([v[0, :3], v[1, :4]])[None]
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2]])
    a_p, ret_p = gae_advantages(rp, vp, torch.ones((1, 7)), 0.95, 0.9, segment_ids=seg)
    np.testing.assert_allclose(a_p[0].numpy(), torch.cat([a_u[0, :3], a_u[1, :4]]).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ret_p[0].numpy(), torch.cat([ret_u[0, :3], ret_u[1, :4]]).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_ppo_loss_packed_per_sequence_stats():
    """mean_kl / mean_return divide by the episode count (n_seqs) in the
    packed layout, matching the unpacked per-row means."""
    rng = np.random.default_rng(5)
    m = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], dtype=torch.float32)
    rnd = lambda: torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))  # noqa: E731
    lp = rnd() * 0.01 * m
    olp = lp + rnd() * 0.01 * m
    v = rnd() * m
    r = rnd() * m
    _, st_u = ppo_loss(lp, v, olp, v, r, m, **KW)

    def packrow(a):
        return torch.cat([a[0, :3], a[1, :4]])[None]

    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2]])
    _, st_p = ppo_loss(packrow(lp), packrow(v), packrow(olp), packrow(v), packrow(r), torch.ones((1, 7)),
                       segment_ids=seg, n_seqs=2, **KW)
    for k in ("mean_kl", "mean_return"):
        np.testing.assert_allclose(float(st_u[k]), float(st_p[k]), rtol=1e-4, atol=1e-6)


ARCH = dict(vocab_size=29, n_layer=3, n_head=2, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
            parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
            dtype="float32", param_dtype="float32", extra={"lm_head_bias": True})


def _models():
    jmodel = JaxLMWithValueHead(JaxLMConfig.from_dict(ARCH), branch_layer=2)
    ids0 = jnp.ones((1, 8), dtype=jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(2), ids0, jnp.ones_like(ids0))["params"])
    model = LMWithValueHead(LMConfig.from_dict(ARCH), branch_layer=2, device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    return jmodel, params, model


def test_segment_masked_forward_equal_jax():
    """A packed batch through both models: values, labels-mode logprobs and
    logits agree on every valid position."""
    g = _store_columns(np.random.default_rng(7), B=10, P=5, R=6)
    g["query_tensors"] %= ARCH["vocab_size"]
    g["response_tensors"] %= ARCH["vocab_size"]
    b = pack_ppo_batch(g)
    jmodel, params, model = _models()
    jkw = dict(position_ids=jnp.asarray(b.position_ids), segment_ids=jnp.asarray(b.segment_ids))
    tkw = dict(position_ids=torch.from_numpy(b.position_ids), segment_ids=torch.from_numpy(b.segment_ids))
    ids, msk = b.input_ids, b.attention_mask
    jout = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(msk), labels=jnp.asarray(b.labels),
                        labels_mask=jnp.asarray(b.loss_mask), **jkw)
    jlog = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(msk), **jkw)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(msk), labels=torch.from_numpy(b.labels),
                    labels_mask=torch.from_numpy(b.loss_mask), **tkw)
        log = model(torch.from_numpy(ids), torch.from_numpy(msk), **tkw)
    valid = msk.astype(bool)
    np.testing.assert_allclose(out["values"].numpy()[valid], np.asarray(jout["values"])[valid], **MODEL_TOL)
    np.testing.assert_allclose(out["logprobs"].numpy(), np.asarray(jout["logprobs"]), **MODEL_TOL)
    np.testing.assert_allclose(log["logits"].numpy()[valid], np.asarray(jlog["logits"])[valid], **MODEL_TOL)


def test_segment_ids_block_diagonal_attention():
    """Two episodes packed into one row with segment_ids and per-segment
    positions reproduce the separate rows' logits: no cross-episode
    attention."""
    _, _, model = _models()
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(0, 29, size=6).astype(np.int32))
    c = torch.from_numpy(rng.integers(0, 29, size=4).astype(np.int32))
    ids = torch.zeros((2, 6), dtype=torch.int32)
    ids[0], ids[1, :4] = a, c
    mask = torch.tensor([[1] * 6, [1] * 4 + [0] * 2], dtype=torch.int32)
    with torch.no_grad():
        sep = model(ids, mask)["logits"]
        out = model(torch.cat([a, c])[None], torch.ones((1, 10), dtype=torch.int32),
                    position_ids=torch.tensor([list(range(6)) + list(range(4))]),
                    segment_ids=torch.tensor([[1] * 6 + [2] * 4]))["logits"]
    np.testing.assert_allclose(out[0, :6].numpy(), sep[0, :6].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[0, 6:].numpy(), sep[1, :4].numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ e2e twins


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


def _train(task, ckpt_dir, packed, total_steps=6):
    walks, logit_mask, metric_fn, reward_fn = task
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = total_steps
    config.train.epochs = 2
    config.train.batch_size = 16
    config.train.eval_interval = 4
    config.train.checkpoint_dir = str(ckpt_dir)
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    config.method.pack_train_batch = packed
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[i] for i in range(1, 15)],
                                 metric_fn=metric_fn, config=config, logit_mask=logit_mask, device="cpu")
    with open(os.path.join(str(ckpt_dir), "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return model, recs


def test_ppo_e2e_packed_train_batch(task, tmp_path):
    model, recs = _train(task, tmp_path, packed=True)
    assert model.iter_count >= 6
    assert len(model.store) > 0
    batch = next(iter(model.train_dataloader))
    assert isinstance(batch, PackedPPOBatch)
    assert batch.input_ids.shape[0] % model._pack_rows_multiple == 0
    assert any("train_tokens_per_s" in r for r in recs)
    fills = [r["train_batch_fill"] for r in recs if "train_batch_fill" in r]
    assert fills and all(0 < v <= 1 for v in fills)


def test_ppo_packed_losses_match_unpacked(task, tmp_path):
    model_u, recs_u = _train(task, tmp_path / "unpacked", packed=False, total_steps=2)
    model_p, recs_p = _train(task, tmp_path / "packed", packed=True, total_steps=2)
    assert isinstance(next(iter(model_u.train_dataloader)), PPORLBatch)
    assert isinstance(next(iter(model_p.train_dataloader)), PackedPPOBatch)
    logs_u = {r["step"]: r for r in recs_u if "loss" in r}
    logs_p = {r["step"]: r for r in recs_p if "loss" in r}
    assert logs_u[1]["loss"] == pytest.approx(logs_p[1]["loss"], rel=5e-3, abs=1e-5)
    assert logs_u[1]["mean_kl"] == pytest.approx(logs_p[1]["mean_kl"], rel=5e-3, abs=1e-6)
