"""Offline (ILQL) experience (the counterpart of
``trlx_tpu.orchestrator.offline_orchestrator``): samples (text with a
tokenizer, or token arrays) → action and state indices, z-scored returns
with the terminal reward on the final action → ``ILQLRolloutStorage``; the
raw rewards' mean feeds the health monitor when it is armed.

With several nodes each node feeds its own samples; their counts must
agree (the JAX package's multi-host check), or every rank raises the same
``HostDesync``: per-node loaders of different lengths would leave the ranks
in different train steps."""

import warnings

import numpy as np

from trlx_tpu_torch.orchestrator import Orchestrator, register_orchestrator
from trlx_tpu_torch.parallel.mesh import allgather_host, world_size
from trlx_tpu_torch.resilience.distributed import HostDesync
from trlx_tpu_torch.pipeline.ilql_pipeline import ILQLRolloutStorage


@register_orchestrator
class OfflineOrchestrator(Orchestrator):
    def __init__(self, model, split_token=None):
        self.model = model
        self.split_token = split_token

    def make_experience(self, samples, rewards):
        """Fill ``model.store`` from (samples, rewards). With a tokenizer and
        ``split_token``, the prompt of a text sample runs through the first
        ``split_token``; otherwise it is the first token (BOS for text). The
        states are positions start .. L - 1 and the actions start .. L - 2
        of the (truncated) sample, start being the prompt's last token. A
        sample whose prompt takes it whole has no action: it is stored as a
        padded no-op and left out of the return statistics."""
        model = self.model
        if world_size() > 1:
            counts = allgather_host(np.asarray([len(samples)], dtype=np.int64)).reshape(-1)
            if len(set(int(c) for c in counts)) != 1:
                raise HostDesync(f"offline sample count differs across ranks: {counts.tolist()} (rank ids are the "
                                 "list indices) — every rank must feed the same number of samples to "
                                 "make_experience")
        tokenizer = model.tokenizer
        input_ids = model.tokenize_ilql(samples)

        T = model.config.train.seq_length
        states_ixs, actions_ixs, dones = [], [], []
        for s, s_tok in zip(samples, input_ids):
            if self.split_token and tokenizer is not None:
                prompt_str_len = s.index(self.split_token) + len(self.split_token)
                prompt_tok_len = len(tokenizer(s[:prompt_str_len])["input_ids"])
            else:
                prompt_tok_len = 1
            L = min(len(s_tok), T)
            start = max(0, min(prompt_tok_len - 1, L - 1))
            s_ixs = np.arange(start, L)
            terminals = np.ones_like(s_ixs)
            if len(terminals):
                terminals[-1] = 0
            actions_ixs.append(np.arange(start, L - 1))
            states_ixs.append(s_ixs)
            dones.append(terminals)

        sample_lengths = np.asarray([len(x) for x in input_ids], dtype=np.float32)
        mean_reward = float(np.mean(np.asarray(rewards, dtype=np.float32)))
        print(f"[Mean reward] {mean_reward:.2f}")
        print(f"[Mean sample length] {np.mean(sample_lengths):.2f}")
        if model._health is not None:
            # One reward-distribution observation per experience batch: the
            # raw rewards (z-scored returns would hide the drift).
            model._health.observe_reward(mean_reward)

        # z-score the returns over the samples that train; the terminal
        # reward goes on the final action.
        returns = np.asarray(rewards, dtype=np.float32)
        valid = np.asarray([len(a) > 0 for a in actions_ixs])
        if not valid.all():
            warnings.warn(
                f"{int((~valid).sum())}/{len(valid)} offline samples have no continuation tokens (prompt-only or "
                "over-truncated): they are stored as no-ops and excluded from return normalization"
            )
        base = returns[valid] if valid.any() else returns
        returns = (returns - base.mean()) / (base.std() + 1e-30)
        reward_rows = [np.zeros(len(a), dtype=np.float32) for a in actions_ixs]
        for rs, G in zip(reward_rows, returns):
            if len(rs):
                rs[-1] = G

        attention_mask = [np.ones(min(len(x), T), dtype=np.int32) for x in input_ids]
        model.store = ILQLRolloutStorage(input_ids, attention_mask, reward_rows, states_ixs, actions_ixs, dones,
                                         seq_length=T)
