"""Text mode against the JAX package, with ``tests/test_text_mode.py``'s
``CharTokenizer`` injected through ``_build_tokenizer`` in both packages (no
download).

- PPO end to end on string prompts (twin of
  ``test_text_mode_ppo_end_to_end``): the same config, JAX initial weights
  and a forced-bigram logit mask (one allowed successor per token, so both
  packages sample the same path) go through ``trlx_tpu.train`` and
  ``trlx_tpu_torch.train``; ``reward_fn`` and ``metric_fn`` see the same
  strings in both, the step statistics agree within 1e-5 at step 1 and 2e-4
  after, and the eval samples are strings.
- Default prompts are BOS × batch_size (twin of
  ``test_text_mode_default_prompts_are_bos``), and ``train(config=None)``
  reads the port's default configs.
- ``tokenize``, ``decode`` and the prompt pipeline's arrays equal JAX's.
- An ILQL text dataset with ``split_token`` builds the store JAX builds,
  array for array, and ``tokenize_ilql`` equals JAX's.
- ``_build_tokenizer`` builds a tokenizer from a local directory (pad = eos,
  left padding).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from test_text_mode import CharTokenizer, text_config

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.orchestrator.offline_orchestrator import OfflineOrchestrator as JaxOfflineOrchestrator
from trlx_tpu.pipeline.prompt_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.base import JaxBaseTrainer
from trlx_tpu.trainer.ilql import ILQLTrainer as JaxILQLTrainer
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.api import default_config
from trlx_tpu_torch.trainer.base import BaseTrainer
from trlx_tpu_torch.trainer.ilql import ILQLTrainer
from trlx_tpu_torch.trainer.ppo import PPOTrainer

torch.set_num_threads(1)

STAT_KEYS = ("loss", "pg_loss", "vf_loss", "mean_kl", "mean_ratio", "mean_return", "mean_advantage", "grad_norm",
             "learning_rate")
PROMPTS = ["abc", "bca", "cab", "aa", "bb", "cc", "abca", "baab"] * 4
EVAL_PROMPTS = ["ab", "ba", "ca"]


@pytest.fixture
def char_tokenizer(monkeypatch):
    """Both packages' trainers build the CharTokenizer whatever their path."""
    monkeypatch.setattr(JaxBaseTrainer, "_build_tokenizer", lambda self, path: CharTokenizer())
    monkeypatch.setattr(BaseTrainer, "_build_tokenizer", lambda self, path: CharTokenizer())


def _cfg_dict(tmp_path, **train):
    jcfg = text_config(tmp_path)
    d = {k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")}
    d["train"].update(train)
    return json.loads(json.dumps(d))


_JAX_INIT = {}


@register_model("TextPPOFromJaxInit")
class _TextPPOFromJaxInit(PPOTrainer):
    """The port's PPO trainer starting from the JAX trainer's weights."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.load_params(params_from_jax(_JAX_INIT["params"], self.model),
                         params_from_jax(_JAX_INIT["extras"], self.model))


def _step_stats(path):
    with open(path) as f:
        return {r["step"]: r for r in map(json.loads, f) if "loss" in r}


def test_text_mode_ppo_matches_jax(tmp_path, char_tokenizer):
    """String prompts → tokenize → generate → decode → reward_fn(texts) →
    learn, in both packages from the same weights: the same texts, the same
    step statistics; eval samples are strings."""
    V = 32
    succ = np.random.default_rng(0).permutation(np.arange(3, V))
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), np.resize(succ, V)] = False  # one successor each, never pad/eos/bos

    seen = {}
    runs = {}
    for name in ("jax", "torch"):
        texts = seen.setdefault(name, {"reward": [], "metric": []})

        def reward_fn(samples, texts=texts):
            assert all(isinstance(t, str) for t in samples)
            texts["reward"].extend(samples)
            return np.asarray([t.count("a") / max(len(t), 1) for t in samples], dtype=np.float32)

        def metric_fn(samples, texts=texts):
            assert all(isinstance(t, str) for t in samples)
            texts["metric"].extend(samples)
            return {"len": np.asarray([float(len(t)) for t in samples])}

        cfg = _cfg_dict(tmp_path / name, eval_interval=100)
        if name == "jax":
            init = JaxPPOTrainer(JaxTRLConfig.from_dict(cfg))
            _JAX_INIT["params"] = jax.device_get(init.state.params)
            _JAX_INIT["extras"] = jax.device_get(init.state.extras)
            del init
            model = trlx_tpu.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=EVAL_PROMPTS,
                                   metric_fn=metric_fn, config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
        else:
            cfg["model"]["model_type"] = "TextPPOFromJaxInit"
            model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=EVAL_PROMPTS,
                                         metric_fn=metric_fn, config=TRLConfig.from_dict(cfg),
                                         logit_mask=logit_mask, device="cpu")
        runs[name] = (model, _step_stats(os.path.join(tmp_path, name, "metrics.jsonl")))

    (jm, js), (tm, ts) = runs["jax"], runs["torch"]
    assert tm.iter_count == jm.iter_count == 4 and len(tm.store) > 0
    assert seen["torch"]["reward"] == seen["jax"]["reward"] and seen["torch"]["reward"]
    assert any(c in t for t in seen["torch"]["reward"] for c in "abc")  # decoded rollouts carry the prompts
    assert seen["torch"]["metric"] == seen["jax"]["metric"] and len(seen["torch"]["metric"]) == 3
    for step in range(1, 5):
        tol = 1e-5 if step == 1 else 2e-4
        for k in STAT_KEYS:
            np.testing.assert_allclose(ts[step][k], js[step][k], rtol=tol, atol=tol, err_msg=f"step {step} {k}")
    stats = tm.evaluate()
    assert "mean_reward" in stats and np.isfinite(stats["mean_reward"])


def test_text_mode_default_prompts_are_bos(tmp_path, monkeypatch):
    """``train()`` without prompts starts from BOS × batch_size, which needs
    a tokenizer; without one it raises."""
    class Tok(CharTokenizer):
        bos_token = "a"  # train() uses tokenizer.bos_token strings

    config = TRLConfig.from_dict(_cfg_dict(tmp_path, total_steps=2))
    with pytest.raises(ValueError, match="default prompts need a tokenizer"):
        trlx_tpu_torch.train(reward_fn=lambda texts: np.zeros(len(texts), np.float32), config=config, device="cpu")
    monkeypatch.setattr(BaseTrainer, "_build_tokenizer", lambda self, path: Tok())
    seen = []
    model = trlx_tpu_torch.train(reward_fn=lambda texts: seen.extend(texts) or np.zeros(len(texts), np.float32),
                                 config=TRLConfig.from_dict(_cfg_dict(tmp_path, total_steps=2)), device="cpu")
    assert model.iter_count >= 2
    assert np.all(model.eval_pipeline.input_ids[:, -2:] == [2, 3])  # BOS, then "a"
    assert all(isinstance(t, str) and t.startswith("a") for t in seen)


def test_default_configs_are_the_jax_defaults():
    """``train(config=None)`` reads the port's copies of the default
    configs: the same values as the JAX package's."""
    from trlx_tpu.trainer.api import default_config as jax_default_config

    for name in ("ppo", "ilql"):
        got, want = default_config(name), jax_default_config(name)
        for section in ("model", "train", "method"):
            g, w = dataclasses.asdict(getattr(got, section)), dataclasses.asdict(getattr(want, section))
            for k, v in g.items():
                if k in w:
                    assert v == w[k] or (isinstance(v, (list, tuple)) and list(v) == list(w[k])), (name, section, k)


def test_tokenize_decode_and_pipeline_match_jax(tmp_path, char_tokenizer):
    """``tokenize`` (BOS, keep-last truncation), ``decode`` (text, special
    tokens skipped), the pad and eos ids and the string prompt pipeline's
    arrays equal the JAX package's."""
    cfg = _cfg_dict(tmp_path)
    tm = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    jm = JaxPPOTrainer(JaxTRLConfig.from_dict(cfg))
    texts = ["abc", "", "the quick brown fox jumps over the lazy dog", "a-b c"]
    assert tm.tokenize(texts) == jm.tokenize(texts)
    assert (tm.pad_token_id, tm.eos_token_id) == (jm.pad_token_id, jm.eos_token_id) == (1, 1)
    grid = np.random.default_rng(0).integers(0, 32, size=(4, 12)).astype(np.int32)
    assert tm.decode(grid) == jm.decode(grid)
    for width in (4, 8):
        a = PromptPipeline(texts, CharTokenizer(), max_prompt_length=width)
        b = JaxPromptPipeline(texts, CharTokenizer(), max_prompt_length=width)
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)


def _ilql_cfg(tmp_path):
    cfg = _cfg_dict(tmp_path)
    cfg["model"]["model_type"] = "ilql"
    cfg["train"]["orchestrator"] = "OfflineOrchestrator"
    cfg["method"] = dict(name="ilqlconfig", gen_kwargs=dict(prompt_length=8, max_new_tokens=8))
    return cfg


class _DecodingCharTokenizer(CharTokenizer):
    """With ``decode``, which the JAX package's offline orchestrator prints
    a sample through."""

    def decode(self, ids):
        return self.batch_decode([ids])[0]


def test_ilql_text_store_matches_jax(tmp_path, monkeypatch):
    """Text samples with ``split_token`` (one whose prompt takes it whole,
    one truncated) build the JAX package's store array for array;
    ``tokenize_ilql`` (BOS + text + EOS, leading tokens kept; a token array
    as it is) equals JAX's."""
    samples = ["abc: ddd", "a: b", "abcdefghijklmnopqrstu: x", "bca: " + "ab" * 12, "c:cc"]
    rewards = [1.0, -1.0, 0.5, 2.0, 1.5]
    monkeypatch.setattr(JaxBaseTrainer, "_build_tokenizer", lambda self, path: _DecodingCharTokenizer())
    monkeypatch.setattr(BaseTrainer, "_build_tokenizer", lambda self, path: CharTokenizer())
    tm = ILQLTrainer(TRLConfig.from_dict(_ilql_cfg(tmp_path)), device="cpu")
    jm = JaxILQLTrainer(JaxTRLConfig.from_dict(_ilql_cfg(tmp_path)))
    mixed = samples + [np.asarray([2, 5, 6, 7])]
    for a, b in zip(tm.tokenize_ilql(mixed), jm.tokenize_ilql(mixed), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.warns(UserWarning, match="no continuation tokens"):
        OfflineOrchestrator(tm, split_token=":").make_experience(samples, rewards)
    with pytest.warns(UserWarning):
        JaxOfflineOrchestrator(jm, split_token=":").make_experience(samples, rewards)
    assert len(tm.store) == len(samples)
    for key in ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones"):
        np.testing.assert_allclose(getattr(tm.store, key), getattr(jm.store, key), rtol=1e-6, err_msg=key)


def test_build_tokenizer_from_a_local_directory(tmp_path, monkeypatch):
    """``model.tokenizer_path`` naming a local tokenizer directory builds it
    through ``AutoTokenizer`` with pad = eos and left padding (the offline
    flags are set: nothing may leave the machine)."""
    transformers = pytest.importorskip("transformers")
    import huggingface_hub.constants

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    tok_dir = str(tmp_path / "tok")
    transformers.GPT2Tokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")).save_pretrained(tok_dir)
    cfg = _cfg_dict(tmp_path)
    cfg["model"]["tokenizer_path"] = tok_dir
    cfg["model"]["model_arch"]["vocab_size"] = 257
    tm = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    assert tm.tokenizer.pad_token == tm.tokenizer.eos_token == "<|endoftext|>"
    assert tm.tokenizer.padding_side == "left" and tm.pad_token_id == 256
    assert tm.decode(np.asarray([tm.tokenize(["hi there"])[0]])) == ["hi there"]
