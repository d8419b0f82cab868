"""PPO sentiment tuning: make a GPT-2 fine-tuned on IMDB write positive
reviews (the port's counterpart of ``examples/ppo_sentiments.py``).

A distilbert-imdb sentiment classifier is the reward function, run on the
host through transformers' pipeline; prompts are the first four words of
IMDB reviews. The port reads local files only, so each is a path:

- ``--model``: the policy as an HF directory (``lvwerra/gpt2-imdb`` saved
  with ``save_pretrained``), whose tokenizer files are read too unless
  ``--tokenizer`` names another directory;
- ``--sentiment-model``: the classifier's directory (``lvwerra/distilbert-imdb``);
- ``--imdb``: the IMDB dataset written by ``datasets``' ``save_to_disk``
  (the ``train`` and ``test`` splits are concatenated, as "train+test").

Run:  python -m trlx_tpu_torch.examples.ppo_sentiments --model DIR --sentiment-model DIR --imdb DIR [--device cpu]
"""

import argparse

from trlx_tpu_torch.trainer.api import default_config, train
from trlx_tpu_torch.utils import sentiment_score

EVAL_PROMPTS = ["I don't know much about Hungarian underground"] * 64


def build_reward_fn(sentiment_model: str):
    from transformers import pipeline

    sentiment_fn = pipeline("sentiment-analysis", sentiment_model, device=-1, top_k=2, truncation=True)

    def reward_fn(samples):
        # the POSITIVE class's score, whatever the ranking
        return sentiment_score(sentiment_fn(samples))

    return reward_fn


def load_imdb(path: str):
    """(texts, labels) of the saved IMDB dataset, its splits concatenated."""
    from datasets import DatasetDict, concatenate_datasets, load_from_disk

    data = load_from_disk(path)
    if isinstance(data, DatasetDict):
        data = concatenate_datasets([data[s] for s in ("train", "test") if s in data])
    return list(data["text"]), list(data["label"])


def review_prompts(texts):
    return [" ".join(review.split()[:4]) for review in texts]


def local_config(name: str, args):
    """``default_config(name)`` reading the model and tokenizer from the
    given directories."""
    config = default_config(name)
    config.model.model_path = args.model
    config.model.tokenizer_path = args.tokenizer or args.model
    return config


def parser(prog: str, metric: bool = False):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--model", required=True, help="the policy's HF directory")
    p.add_argument("--tokenizer", default=None, help="the tokenizer's directory (default: --model)")
    p.add_argument("--sentiment-model", required=True,
                   help="the sentiment classifier's HF directory (the " + ("metric)" if metric else "reward)"))
    p.add_argument("--imdb", required=True, help="the IMDB dataset saved with datasets' save_to_disk")
    p.add_argument("--device", default=None, help="torch device (default: CUDA)")
    return p


def main(argv=None):
    args = parser("python -m trlx_tpu_torch.examples.ppo_sentiments").parse_args(argv)
    texts, _ = load_imdb(args.imdb)
    return train(reward_fn=build_reward_fn(args.sentiment_model), prompts=review_prompts(texts),
                 eval_prompts=EVAL_PROMPTS, config=local_config("ppo", args), device=args.device)


if __name__ == "__main__":
    main()
