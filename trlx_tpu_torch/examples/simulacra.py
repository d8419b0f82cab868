"""Simulacra: offline ILQL on image-prompt / aesthetic-rating pairs (the
port's counterpart of ``examples/simulacra.py``): GPT-2 learns to write
higher-rated image prompts from the Simulacra Aesthetic Captions database.

The port fetches nothing: ``--db`` is a local copy of
``sac_public_2022_06_29.sqlite`` (published at
https://github.com/JD-P/simulacra-aesthetic-captions), ``--model`` a GPT-2 HF
directory.

Run:  python -m trlx_tpu_torch.examples.simulacra --db FILE --model DIR [--device cpu]
"""

import argparse
import os
import sqlite3

from trlx_tpu_torch.trainer.api import default_config, train

DBNAME = "sac_public_2022_06_29.sqlite"


def load_ratings(dbpath: str):
    """(prompts, ratings) of every rated generation in the database."""
    if not os.path.exists(dbpath):
        raise FileNotFoundError(f"{dbpath}: no such file (a local copy of {DBNAME} is needed)")
    conn = sqlite3.connect(dbpath)
    rows = conn.execute(
        "SELECT prompt, rating FROM ratings "
        "JOIN images ON images.id=ratings.iid "
        "JOIN generations ON images.gid=generations.id "
        "WHERE rating IS NOT NULL;"
    ).fetchall()
    conn.close()
    prompts, ratings = map(list, zip(*rows))
    return prompts, ratings


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m trlx_tpu_torch.examples.simulacra")
    p.add_argument("--db", default=DBNAME, help=f"the local {DBNAME}")
    p.add_argument("--model", required=True, help="GPT-2's HF directory")
    p.add_argument("--tokenizer", default=None, help="the tokenizer's directory (default: --model)")
    p.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = p.parse_args(argv)
    prompts, ratings = load_ratings(args.db)
    config = default_config("ilql")
    config.model.tokenizer_path = args.tokenizer or args.model
    return train(args.model, dataset=(prompts, ratings), eval_prompts=["Hatsune Miku, Red Dress"] * 64,
                 config=config, device=args.device)


if __name__ == "__main__":
    main()
