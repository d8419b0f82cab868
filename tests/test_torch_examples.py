"""The port's examples (``trlx_tpu_torch/examples``) against the JAX
package's (``examples/``), and ``trlx_tpu_torch.utils.sentiment_score``
against ``trlx_tpu.utils``'s.

- randomwalks, for the same seed: the walks, ``logit_mask``, ``metric_fn``
  and ``reward_fn`` outputs and the ``base_config`` dicts are equal, and
  ``main()`` hands ``train()`` the same arguments as the JAX example's.
- ``sentiment_score`` equals the JAX function on both pipeline output
  shapes (top-1 dicts and per-class lists).
- Every example parses its command line and names local paths only.

The learning gates that run the port's randomwalks are in
``tests/test_torch_train.py`` and ``tests/test_torch_ilql.py`` (``slow``).
"""

import dataclasses
import importlib
import importlib.util
import os

import numpy as np
import pytest

from trlx_tpu_torch.examples import randomwalks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_randomwalks():
    spec = importlib.util.spec_from_file_location("jax_example_randomwalks",
                                                  os.path.join(REPO, "examples", "randomwalks.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sections(config):
    return {k: dataclasses.asdict(getattr(config, k)) for k in ("model", "train", "method")}


@pytest.mark.parametrize("kw", [dict(), dict(n_nodes=13, max_length=7, n_walks=200, p_edge=0.2, seed=7)],
                         ids=["example", "other_seed"])
def test_random_walks_task_equals_the_jax_example(jax_randomwalks, kw):
    walks, mask, metric_fn, reward_fn = randomwalks.generate_random_walks(**kw)
    jwalks, jmask, jmetric_fn, jreward_fn = jax_randomwalks.generate_random_walks(**kw)
    assert len(walks) == len(jwalks)
    for a, b in zip(walks, jwalks):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(mask, jmask)
    n_nodes = mask.shape[0]
    rng = np.random.default_rng(3)
    samples = list(walks[:64]) + [rng.integers(0, n_nodes, size=int(rng.integers(1, 12))) for _ in range(64)]
    got, want = metric_fn(samples), jmetric_fn(samples)
    assert sorted(got) == sorted(want) == ["lengths", "optimality"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(reward_fn(samples), jreward_fn(samples))
    assert reward_fn(samples).dtype == np.float32


@pytest.mark.parametrize("method", ["ppo", "ilql"])
def test_base_config_equals_the_jax_example(jax_randomwalks, method):
    assert _sections(randomwalks.base_config(method, 21, 10)) == _sections(
        jax_randomwalks.base_config(method, 21, 10))


@pytest.mark.parametrize("method", ["ppo", "ilql"])
def test_main_hands_train_the_jax_examples_arguments(jax_randomwalks, monkeypatch, method):
    import trlx_tpu

    calls = {}
    monkeypatch.setattr(randomwalks, "train", lambda **kw: calls.setdefault("torch", kw))
    monkeypatch.setattr(trlx_tpu, "train", lambda **kw: calls.setdefault("jax", kw))
    randomwalks.main(method, device="cpu")
    jax_randomwalks.main(method)
    got, want = calls["torch"], calls["jax"]
    assert got.pop("device") == "cpu"
    assert sorted(got) == sorted(want)
    assert _sections(got.pop("config")) == _sections(want.pop("config"))
    np.testing.assert_array_equal(got.pop("logit_mask"), want.pop("logit_mask"))
    samples = [np.array([3, 0]), np.array([5, 2, 9])]
    for k in ("metric_fn", "reward_fn"):
        if k in got:
            a, b = got.pop(k)(samples), want.pop(k)(samples)
            for x, y in zip(a.values() if isinstance(a, dict) else [a], b.values() if isinstance(b, dict) else [b]):
                np.testing.assert_array_equal(x, y)
    if method == "ilql":
        (w, lengths), (jw, jlengths) = got.pop("dataset"), want.pop("dataset")
        assert all(np.array_equal(a, b) for a, b in zip(w, jw)) and len(w) == len(jw)
        np.testing.assert_array_equal(lengths, jlengths)
    assert got == want  # prompts, eval_prompts


def test_main_wraps_the_task_metric_and_takes_a_config(monkeypatch):
    calls = {}
    monkeypatch.setattr(randomwalks, "train", lambda **kw: calls.update(kw))
    config = randomwalks.base_config("ilql", 21, 10)
    config.train.total_steps = 3
    seen = []

    def wrap(task_metric):
        def metric(samples):
            m = task_metric(samples)
            seen.append(float(np.mean(m["optimality"])))
            return m
        return metric

    randomwalks.main("ilql", device="cpu", config=config, metric_fn=wrap)
    assert calls["config"] is config
    calls["metric_fn"]([np.array([1, 0])])
    assert len(seen) == 1


TOP1 = [{"label": "POSITIVE", "score": 0.9}, {"label": "NEGATIVE", "score": 0.8}, {"label": "LABEL_1", "score": 0.3},
        {"label": "label_0", "score": 0.25}]
ALL_SCORES = [[{"label": "NEGATIVE", "score": 0.3}, {"label": "POSITIVE", "score": 0.7}],
              [{"label": "LABEL_0", "score": 0.6}, {"label": "LABEL_1", "score": 0.4}],
              [{"label": "neutral", "score": 1.0}]]


@pytest.mark.parametrize("outputs", [TOP1, ALL_SCORES], ids=["top1", "per_class"])
def test_sentiment_score_equals_the_jax_function(outputs):
    from trlx_tpu.utils import sentiment_score as jax_sentiment_score
    from trlx_tpu_torch.utils import sentiment_score

    assert sentiment_score(outputs) == jax_sentiment_score(outputs)


EXAMPLES = {
    "ppo_sentiments": ["--model", "m", "--sentiment-model", "s", "--imdb", "d"],
    "ilql_sentiments": ["--model", "m", "--sentiment-model", "s", "--imdb", "d"],
    "ppo_softprompt_sentiments": ["--model", "m", "--sentiment-model", "s", "--imdb", "d"],
    "architext": ["--model", "m"],
    "simulacra": ["--model", "m", "--db", "x.sqlite"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_take_local_paths_and_the_device(name, monkeypatch, tmp_path):
    """Each example's ``main`` parses its paths and ``--device`` and hands
    ``train()`` local directories (the data loaders are stubbed: the
    models and datasets are not in the repository)."""
    module = importlib.import_module(f"trlx_tpu_torch.examples.{name}")
    calls = {}
    monkeypatch.setattr(module, "train", lambda *a, **kw: calls.update(kw, args=a))
    for stub, value in (("build_reward_fn", lambda path: ("reward", path)), ("build_metric_fn", lambda path: ("metric", path)),
                        ("load_imdb", lambda path: (["a b c d e"], [1])),
                        ("load_ratings", lambda path: (["p"], [5.0]))):
        if hasattr(module, stub):
            monkeypatch.setattr(module, stub, value)
    module.main(EXAMPLES[name] + ["--device", "cpu"])
    assert calls["device"] == "cpu"
    config = calls["config"]
    assert config.model.tokenizer_path == "m"
    assert calls["args"] == (("m",) if name in ("architext", "simulacra") else ())
    if not calls["args"]:
        assert config.model.model_path == "m"
    if "reward_fn" in calls and name != "architext":
        assert calls["reward_fn"] == ("reward", "s") and calls["prompts"] == ["a b c d"]
    if name == "ppo_softprompt_sentiments":
        assert config.model.model_type == "ppo_softprompt" and config.method.name == "pposoftpromptconfig"


def test_simulacra_refuses_a_missing_database(tmp_path):
    from trlx_tpu_torch.examples import simulacra

    with pytest.raises(FileNotFoundError, match="local copy"):
        simulacra.load_ratings(str(tmp_path / "missing.sqlite"))
