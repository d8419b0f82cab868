"""Prompt-length bucketing in the port (``method.gen_kwargs.prompt_buckets``),
twin of ``tests/test_bucketing.py``: the pipeline and loader mechanics
(numpy), the decode-loop counts, and the bound the acceptance property
sets: over mixed prompt lengths the sampler keeps at most one set of
buffers (one decode graph on the card) per bucket width. The bucketed
loader yields the JAX loader's batches for the same seed, and a bucketed
``train()`` stores its queries at the full prompt width."""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.pipeline.prompt_pipeline import PromptPipeline as JaxPromptPipeline  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.models.heads import LMWithValueHead  # noqa: E402
from trlx_tpu_torch.models.hf_import import init_params  # noqa: E402
from trlx_tpu_torch.models.lm import LMConfig  # noqa: E402
from trlx_tpu_torch.ops.generate import make_generate_fn  # noqa: E402
from trlx_tpu_torch.ops.sampling import GenerateConfig  # noqa: E402
from trlx_tpu_torch.pipeline import BucketedBatchLoader  # noqa: E402
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline, normalize_buckets  # noqa: E402
from trlx_tpu_torch.trainer.base import BaseTrainer  # noqa: E402

torch.set_num_threads(1)


def test_normalize_buckets():
    assert normalize_buckets(None, 64) is None
    assert normalize_buckets((), 64) is None
    assert normalize_buckets([8, 4, 8], 16) == (4, 8, 16)
    assert normalize_buckets([4, 16], 16) == (4, 16)
    assert normalize_buckets([99, -3, 0], 16) == (16,)


def _tensor_prompts():
    # Lengths 2..9: under widths (4, 8) {2,3,4} -> 4, {5..8} -> 8, and the
    # length-9 prompt truncates into the last bucket (8).
    rng = np.random.default_rng(0)
    return [list(rng.integers(2, 50, size=n)) for n in (2, 3, 4, 5, 6, 7, 8, 9, 3, 6)]


def test_pipeline_buckets_pad_to_smallest_fitting_width():
    prompts = _tensor_prompts()
    pipe = PromptPipeline(prompts, tokenizer=None, max_prompt_length=8, bucket_widths=(4, 8))
    assert pipe.bucket_widths == (4, 8)
    assert sum(len(r) for r in pipe._bucket_rows.values()) == len(prompts)
    for w, ids in pipe._bucket_ids.items():
        assert ids.shape[1] == w
        for m in pipe._bucket_mask[w]:
            n = int(m.sum())
            assert n <= w
            assert (m[w - n:] == 1).all() and (m[: w - n] == 0).all()
    assert pipe.input_ids.shape == (len(prompts), 8)
    jpipe = JaxPromptPipeline(prompts, tokenizer=None, max_prompt_length=8, bucket_widths=(4, 8))
    for w in pipe._bucket_ids:
        np.testing.assert_array_equal(pipe._bucket_rows[w], jpipe._bucket_rows[w])
        np.testing.assert_array_equal(pipe._bucket_ids[w], jpipe._bucket_ids[w])
        np.testing.assert_array_equal(pipe._bucket_mask[w], jpipe._bucket_mask[w])


def test_bucketed_loader_batches_are_bucket_uniform():
    prompts = _tensor_prompts()
    pipe = PromptPipeline(prompts, tokenizer=None, max_prompt_length=8, bucket_widths=(4, 8))
    loader = pipe.create_loader(batch_size=3, shuffle=True, drop_last=False, seed=1)
    assert isinstance(loader, BucketedBatchLoader)
    widths, rows = set(), 0
    for batch, n_valid in loader.iter_with_valid():
        assert batch["input_ids"].shape == batch["attention_mask"].shape
        assert batch["input_ids"].shape[0] == 3
        widths.add(batch["input_ids"].shape[1])
        rows += n_valid
    assert widths <= {4, 8}
    assert rows == len(prompts)
    # The JAX loader's batches, in its order, for the same seed (two epochs:
    # the shuffle stream continues across them).
    jloader = JaxPromptPipeline(prompts, tokenizer=None, max_prompt_length=8, bucket_widths=(4, 8)).create_loader(
        batch_size=3, shuffle=True, drop_last=False, seed=1)
    loader = pipe.create_loader(batch_size=3, shuffle=True, drop_last=False, seed=1)
    for _ in range(2):
        ours, theirs = list(loader.iter_with_valid()), list(jloader.iter_with_valid())
        assert len(ours) == len(theirs)
        for (a, na), (b, nb) in zip(ours, theirs):
            assert na == nb
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])


def test_bucketed_loader_wraps_within_bucket():
    buckets = {"a": [0, 1], "b": [2, 3, 4]}

    def collate(key, ixs):
        return key, np.asarray(ixs)

    loader = BucketedBatchLoader(buckets, 4, collate, drop_last=False)
    batches = list(loader.iter_with_valid())
    assert len(batches) == len(loader) == 2
    for (key, ixs), n_valid in batches:
        member = set(buckets[key])
        assert set(ixs.tolist()) <= member
        assert n_valid == len(member) if len(member) < 4 else 4


def test_rollout_decode_stats():
    mask = np.array([[1, 1, 1, 1, 1, 0, 0], [0, 1, 1, 1, 1, 1, 1]], dtype=np.int32)
    s = BaseTrainer.rollout_decode_stats(mask, 3)
    assert s.pop("episode_steps").tolist() == [2, 4]
    assert s == {"gen_tokens": 6, "decode_steps": 4, "decode_step_budget": 4}


def test_generate_buffers_bounded_by_buckets():
    """Mixed prompt lengths through a bucketed loader: the sampler keeps at
    most one set of buffers (on the card: one decode graph) per bucket
    width, and repeated bucket shapes reuse theirs."""
    cfg = LMConfig(vocab_size=19, n_layer=1, n_head=2, d_model=16, max_position=32, dtype="float32")
    model = LMWithValueHead(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    gen = make_generate_fn(model, GenerateConfig(max_new_tokens=2, do_sample=False, eos_token_id=None,
                                                 pad_token_id=0))
    keep = gen.keywords["_keep"]
    pipe = PromptPipeline(_tensor_prompts(), tokenizer=None, max_prompt_length=8, bucket_widths=(4, 8))
    n_batches, seen = 0, []
    for batch in pipe.create_loader(batch_size=2, shuffle=True, drop_last=False, seed=3):
        ids = torch.from_numpy(batch["input_ids"] % cfg.vocab_size)
        toks, _ = gen(ids, torch.from_numpy(batch["attention_mask"]), None)
        assert toks.shape == (2, ids.shape[1] + 2)
        seen.append(id(keep["buffers"]))
        n_batches += 1
    assert n_batches > len(pipe.bucket_widths)
    assert len(keep["by_key"]) <= len(pipe.bucket_widths)
    assert {k[1] for k in keep["by_key"]} <= {4, 8}
    assert len(set(seen)) <= len(pipe.bucket_widths)


def test_bucketed_train_stores_full_width_queries(tmp_path):
    """train() with prompt_buckets: chunks decode at their bucket's width
    (the live sampler keeps one buffer set per width), the stored queries
    are left-padded to prompt_length, and training runs."""
    walks, logit_mask, metric_fn, reward_fn = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps, config.train.epochs, config.train.batch_size = 4, 2, 8
    config.train.eval_interval, config.train.checkpoint_dir = 100, str(tmp_path)
    config.train.seq_length = 10
    config.method.num_rollouts, config.method.chunk_size = 16, 8
    config.method.gen_kwargs = dict(config.method.gen_kwargs, prompt_length=3, max_new_tokens=7,
                                    prompt_buckets=[1])
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 15, size=int(rng.integers(1, 4)))] for _ in range(32)]
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1, 2, 3]],
                                 metric_fn=metric_fn, config=config, logit_mask=logit_mask, device="cpu")
    assert model.prompt_buckets == (1, 3) and model.iter_count == 4
    cols = model.store.columns()
    assert cols["query_tensors"].shape[1] == 3
    widths = {k[1] for k in model._generate_fn.keywords["_keep"]["by_key"]}
    assert widths <= {1, 3}
