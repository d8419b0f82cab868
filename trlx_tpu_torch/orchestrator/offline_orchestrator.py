"""Offline (ILQL) experience (the counterpart of
``trlx_tpu.orchestrator.offline_orchestrator``): token-array samples →
action and state indices, z-scored returns with the terminal reward on the
final action → ``ILQLRolloutStorage``.

Samples are token arrays (text samples need a tokenizer: text mode is not
ported). The JAX package's multi-host sample-count check waits for the
distributed stack."""

import warnings

import numpy as np

from trlx_tpu_torch.orchestrator import Orchestrator, register_orchestrator
from trlx_tpu_torch.pipeline.ilql_pipeline import ILQLRolloutStorage


@register_orchestrator
class OfflineOrchestrator(Orchestrator):
    def __init__(self, model, split_token=None):
        self.model = model
        self.split_token = split_token

    def make_experience(self, samples, rewards):
        """Fill ``model.store`` from (samples, rewards). Without a tokenizer
        the prompt is the first token (``split_token`` splits text, which
        needs one), so every later token is an action: the states are
        positions 0 .. L - 1 and the actions 0 .. L - 2 of the (truncated)
        sample. A sample of one token or none has no action: it is stored as
        a padded no-op and left out of the return statistics."""
        model = self.model
        input_ids = model.tokenize_ilql(samples)

        T = model.config.train.seq_length
        states_ixs, actions_ixs, dones = [], [], []
        for s_tok in input_ids:
            L = min(len(s_tok), T)
            s_ixs = np.arange(L)
            terminals = np.ones_like(s_ixs)
            if len(terminals):
                terminals[-1] = 0
            actions_ixs.append(np.arange(max(L - 1, 0)))
            states_ixs.append(s_ixs)
            dones.append(terminals)

        sample_lengths = np.asarray([len(x) for x in input_ids], dtype=np.float32)
        print(f"[Mean reward] {float(np.mean(np.asarray(rewards, dtype=np.float32))):.2f}")
        print(f"[Mean sample length] {np.mean(sample_lengths):.2f}")

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
