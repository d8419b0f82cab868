"""Shortest-path toy task (Decision-Transformer random walks), the port's
counterpart of ``examples/randomwalks.py``.

A random directed graph whose node ids are the vocabulary; the model learns
to walk from a start node to node 0 in as few steps as possible. No
tokenizer, no files: a from-scratch tiny GPT-2 config. The graph, the walks,
the metric, the reward and the config are the JAX example's, value for value
(``tests/test_torch_examples.py`` holds them equal for the same seed).

Run:  python -m trlx_tpu_torch.examples.randomwalks [ppo|ilql] [--device cpu]
"""

import argparse
from collections import deque

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.trainer.api import train


def generate_random_walks(n_nodes=21, max_length=10, n_walks=1000, p_edge=0.1, seed=1000):
    rng = np.random.default_rng(seed)

    # random digraph; every node needs an outgoing edge
    while True:
        adj = rng.random((n_nodes, n_nodes)) > (1 - p_edge)
        np.fill_diagonal(adj, False)
        if adj.sum(1).all():
            break

    # node 0 is the absorbing goal
    adj[0, :] = False
    adj[0, 0] = True
    goal = 0

    # sample random walks (the offline dataset)
    walks = []
    for _ in range(n_walks):
        node = int(rng.integers(1, n_nodes))
        walk = [node]
        for _ in range(max_length - 1):
            node = int(rng.choice(np.nonzero(adj[node])[0]))
            walk.append(node)
            if node == goal:
                break
        walks.append(np.asarray(walk, dtype=np.int32))

    # BFS shortest-path length from every node to the goal (walk edges backwards)
    radj = adj.T
    dist = np.full(n_nodes, -1, dtype=np.int64)
    dist[goal] = 0
    queue = deque([goal])
    while queue:
        u = queue.popleft()
        for v in np.nonzero(radj[u])[0]:
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                queue.append(v)

    worstlen = max_length
    # path node-count from each non-goal start, capped at max_length
    best_lengths = np.asarray(
        [min(dist[s] + 1, max_length) if dist[s] >= 0 else max_length for s in range(1, n_nodes)],
        dtype=np.float32,
    )

    def walk_length(s):
        """Node count up to and including the first goal visit; None if never."""
        s = np.asarray(s).reshape(-1)
        hits = np.nonzero(s == goal)[0]
        return int(hits[0]) + 1 if len(hits) else None

    def metric_fn(samples):
        lengths, opt = [], []
        for i, s in enumerate(samples):
            L = walk_length(s)
            lengths.append(-float(L) if L else -100.0)
            bound = float(L) if L else worstlen
            denom = max(worstlen - best_lengths[i % len(best_lengths)], 1.0)
            opt.append(min((worstlen - bound) / denom, 1.0))
        return {"lengths": np.asarray(lengths), "optimality": np.asarray(opt)}

    def reward_fn(samples):
        """PPO reward: negative normalized path length, penalties for invalid
        edges / never reaching the goal."""
        rewards = []
        for s in samples:
            s = np.asarray(s).reshape(-1)
            invalid = sum(1 for a, b in zip(s[:-1], s[1:]) if not adj[a, b])
            L = walk_length(s)
            r = -(L if L else 2 * worstlen) / worstlen - invalid
            rewards.append(r)
        return np.asarray(rewards, dtype=np.float32)

    logit_mask = ~adj
    return walks, logit_mask, metric_fn, reward_fn


def base_config(method: str, n_nodes: int, max_length: int) -> TRLConfig:
    return TRLConfig.from_dict(
        {
            "model": {
                "model_path": "",
                "tokenizer_path": "",
                "model_type": method,
                "num_layers_unfrozen": -1,
                "dtype": "float32",
                "model_arch": {
                    "n_layer": 2,
                    "n_head": 4,
                    "d_model": 144,
                    "vocab_size": n_nodes,
                    "max_position": 2 * max_length,
                    "eos_token_id": 0,
                },
            },
            "train": {
                "seq_length": max_length,
                "epochs": 10 if method == "ppo" else 30,
                "total_steps": 150,
                "batch_size": 50,
                "lr_ramp_steps": 10,
                "lr_decay_steps": 200,
                "weight_decay": 1.0e-6,
                "learning_rate_init": 2.0e-3,
                "learning_rate_target": 2.0e-4,
                "opt_betas": [0.9, 0.95],
                "checkpoint_interval": 1000000,
                "eval_interval": 20,
                "orchestrator": "PPOOrchestrator" if method == "ppo" else "OfflineOrchestrator",
                "mesh": [-1, 1, 1, 1],
                "seed": 1000,
            },
            "method": {
                "name": "ppoconfig",
                "num_rollouts": 100,
                "chunk_size": 50,
                "ppo_epochs": 4,
                "init_kl_coef": 0.05,
                "target": 6,
                "horizon": 10000,
                "gamma": 1.0,
                "lam": 0.95,
                "cliprange": 0.2,
                "cliprange_value": 0.2,
                "vf_coef": 1.2,
                "gen_kwargs": {
                    "prompt_length": 1,
                    "max_new_tokens": max_length - 1,
                    "top_k": 0,
                    "top_p": 1.0,
                    "do_sample": True,
                    "temperature": 1.0,
                },
            }
            if method == "ppo"
            else {
                "name": "ilqlconfig",
                "tau": 0.7,
                "gamma": 0.99,
                "cql_scale": 0.1,
                "awac_scale": 1.0,
                "alpha": 0.1,
                "steps_for_target_q_sync": 5,
                "betas": [100],
                "two_qs": True,
            },
        }
    )


def ppo_prompts(n_nodes: int, n: int = 200):
    """The PPO prompts: one start node each, seeded per prompt."""
    return [[int(np.random.default_rng(i).integers(1, n_nodes))] for i in range(n)]


def main(method: str = "ppo", device=None, config: TRLConfig = None, metric_fn=None):
    """Train on the task and return the trainer. ``config`` replaces
    ``base_config(method, ...)``; ``metric_fn`` wraps the task's metric
    (``metric_fn(task_metric)`` returns the one evaluate() calls)."""
    n_nodes, max_length = 21, 10
    walks, logit_mask, task_metric, reward_fn = generate_random_walks(n_nodes=n_nodes, max_length=max_length)
    eval_prompts = [[i] for i in range(1, n_nodes)]
    config = config if config is not None else base_config(method, n_nodes, max_length)
    metric = metric_fn(task_metric) if metric_fn is not None else task_metric

    if method == "ppo":
        return train(reward_fn=reward_fn, prompts=ppo_prompts(n_nodes), eval_prompts=eval_prompts,
                     metric_fn=metric, config=config, logit_mask=logit_mask, device=device)
    lengths = task_metric(walks)["lengths"]
    return train(dataset=(walks, lengths), eval_prompts=eval_prompts, metric_fn=metric, config=config,
                 logit_mask=logit_mask, device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m trlx_tpu_torch.examples.randomwalks")
    parser.add_argument("method", nargs="?", default="ppo", choices=("ppo", "ilql"))
    parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = parser.parse_args()
    main(args.method, device=args.device)
