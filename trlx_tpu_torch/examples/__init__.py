"""The port's examples, the counterparts of the repo's ``examples/``: run
each as ``python -m trlx_tpu_torch.examples.<name>``. They train on the CUDA
device unless given ``--device cpu``.

- ``randomwalks``: shortest paths on a random graph, PPO or ILQL, with no
  tokenizer and no files (the learning check).
- ``ppo_sentiments``, ``ilql_sentiments``, ``ppo_softprompt_sentiments``:
  IMDB sentiment tuning with an HF sentiment classifier as the reward or
  the metric.
- ``architext``: PPO with a reward computed from the decoded text.
- ``simulacra``: offline ILQL on prompt ratings from a SQLite file.

The port reads only local files: every model, tokenizer and dataset an
example names is a path on disk (a hub name would reach for the network).
``transformers`` and ``datasets`` are imported only inside the functions
that use them.
"""
