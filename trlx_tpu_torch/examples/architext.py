"""Architext: PPO-tune a layout model to draw fewer rooms (the port's
counterpart of ``examples/architext.py``). The reward is the negative count
of ":" in each generated layout: a host reward over decoded text.

``--model`` is the layout model's HF directory (``architext/gptj-162M``
saved with ``save_pretrained``), whose tokenizer files are read too unless
``--tokenizer`` names another directory.

Run:  python -m trlx_tpu_torch.examples.architext --model DIR [--device cpu]
"""

import argparse

from trlx_tpu_torch.trainer.api import default_config, train


def reward_fn(samples):
    """Negative room count (rooms are ':'-delimited in architext layouts)."""
    return [-float(sample.count(":")) for sample in samples]


PROMPTS = [
    "[prompt] the bedroom is adjacent to the living room [layout]",
    "[prompt] a bedroom is adjacent to the living room [layout]",
    "[prompt] the bedroom is adjacent to the kitchen [layout]",
    "[prompt] a bedroom is adjacent to the kitchen [layout]",
    "[prompt] the bedroom is adjacent to the kitchen [layout]",
    "[prompt] the kitchen is adjacent to the bathroom [layout]",
    "[prompt] a bathroom is adjacent to the living room [layout]",
    "[prompt] the bathroom is adjacent to the living room [layout]",
    "[prompt] the bedroom is not adjacent to the living room [layout]",
    "[prompt] a bedroom is not adjacent to the living room [layout]",
    "[prompt] the bedroom is not adjacent to the kitchen [layout]",
    "[prompt] a bedroom is not adjacent to the kitchen [layout]",
    "[prompt] the bedroom is not adjacent to the kitchen [layout]",
    "[prompt] the kitchen is not adjacent to the bathroom [layout]",
]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m trlx_tpu_torch.examples.architext")
    p.add_argument("--model", required=True, help="the layout model's HF directory")
    p.add_argument("--tokenizer", default=None, help="the tokenizer's directory (default: --model)")
    p.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = p.parse_args(argv)
    config = default_config("ppo")
    config.model.tokenizer_path = args.tokenizer or args.model
    return train(args.model, reward_fn=reward_fn, prompts=PROMPTS, config=config, device=args.device)


if __name__ == "__main__":
    main()
