"""Offline ILQL on sentiment-labeled IMDB: learn positivity from the labels
alone (the port's counterpart of ``examples/ilql_sentiments.py``).

The dataset is (review text, 0/1 label); ILQL learns Q and V heads over the
LM and decodes with advantage-steered sampling. The sentiment classifier is
only a metric here. Paths as in ``ppo_sentiments`` (``--model`` is a GPT-2
HF directory).

Run:  python -m trlx_tpu_torch.examples.ilql_sentiments --model DIR --sentiment-model DIR --imdb DIR [--device cpu]
"""

from trlx_tpu_torch.examples.ppo_sentiments import EVAL_PROMPTS, load_imdb, local_config, parser
from trlx_tpu_torch.trainer.api import train
from trlx_tpu_torch.utils import sentiment_score


def build_metric_fn(sentiment_model: str):
    from transformers import pipeline

    sentiment_fn = pipeline("sentiment-analysis", sentiment_model, device=-1, top_k=2, truncation=True)

    def metric_fn(samples):
        return {"sentiments": sentiment_score(sentiment_fn(samples))}

    return metric_fn


def main(argv=None):
    args = parser("python -m trlx_tpu_torch.examples.ilql_sentiments", metric=True).parse_args(argv)
    texts, labels = load_imdb(args.imdb)
    return train(dataset=(texts, labels), eval_prompts=EVAL_PROMPTS, metric_fn=build_metric_fn(args.sentiment_model),
                 config=local_config("ilql", args), device=args.device)


if __name__ == "__main__":
    main()
