"""Soft-prompt PPO sentiments: tune only a learned prefix (and the value
head) with the LM frozen (the port's counterpart of
``examples/ppo_softprompt_sentiments.py``), with ``ppo_sentiments``' reward,
prompts and paths and the ``ppo_softprompt`` default config.

Run:  python -m trlx_tpu_torch.examples.ppo_softprompt_sentiments --model DIR --sentiment-model DIR --imdb DIR [--device cpu]
"""

from trlx_tpu_torch.examples.ppo_sentiments import EVAL_PROMPTS, build_reward_fn, load_imdb, local_config, parser, \
    review_prompts
from trlx_tpu_torch.trainer.api import train


def main(argv=None):
    args = parser("python -m trlx_tpu_torch.examples.ppo_softprompt_sentiments").parse_args(argv)
    texts, _ = load_imdb(args.imdb)
    return train(reward_fn=build_reward_fn(args.sentiment_model), prompts=review_prompts(texts),
                 eval_prompts=EVAL_PROMPTS, config=local_config("ppo_softprompt", args), device=args.device)


if __name__ == "__main__":
    main()
