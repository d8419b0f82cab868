"""ILQL rollout storage (the counterpart of
``trlx_tpu.pipeline.ilql_pipeline``): the offline dataset padded once at
construction to fixed shapes, input_ids / attention_mask [T], rewards and
actions_ixs [A = T - 1], states_ixs and dones [A + 1], so every batch is a
stack of numpy rows. Indices, dones and rewards are zero-padded: the
zero dones make the loss's terminal mask drop padded actions."""

from typing import Iterable, List

import numpy as np

from trlx_tpu_torch.data import ILQLBatch, ILQLElement
from trlx_tpu_torch.pipeline import BaseRolloutStore, BatchLoader


class ILQLRolloutStorage(BaseRolloutStore):
    def __init__(self, input_ids: List, attention_mask: List, rewards: List, states_ixs: List, actions_ixs: List,
                 dones: List, seq_length: int):
        super().__init__()
        n, T = len(input_ids), seq_length
        A = T - 1
        self.input_ids = np.zeros((n, T), dtype=np.int32)
        self.attention_mask = np.zeros((n, T), dtype=np.int32)
        self.rewards = np.zeros((n, A), dtype=np.float32)
        self.states_ixs = np.zeros((n, A + 1), dtype=np.int32)
        self.actions_ixs = np.zeros((n, A), dtype=np.int32)
        self.dones = np.zeros((n, A + 1), dtype=np.int32)
        for i in range(n):
            ids = np.asarray(input_ids[i]).reshape(-1)[:T]
            L = len(ids)
            self.input_ids[i, :L] = ids
            self.attention_mask[i, :L] = np.asarray(attention_mask[i]).reshape(-1)[:L]
            for dst, src, width in ((self.actions_ixs, actions_ixs, A), (self.states_ixs, states_ixs, A + 1),
                                    (self.dones, dones, A + 1), (self.rewards, rewards, A)):
                row = np.asarray(src[i]).reshape(-1)[:width]
                dst[i, : len(row)] = row

    def push(self, exps: Iterable):
        raise NotImplementedError("ILQL storage is static (built once from the offline dataset)")

    def __len__(self):
        return self.input_ids.shape[0]

    def __getitem__(self, ix: int) -> ILQLElement:
        return ILQLElement(self.input_ids[ix], self.attention_mask[ix], self.rewards[ix], self.states_ixs[ix],
                           self.actions_ixs[ix], self.dones[ix])

    def create_loader(self, batch_size: int, shuffle: bool = True, seed: int = 0) -> BatchLoader:
        def collate(ixs):
            return ILQLBatch(
                input_ids=self.input_ids[ixs],
                attention_mask=self.attention_mask[ixs],
                rewards=self.rewards[ixs],
                states_ixs=self.states_ixs[ixs],
                actions_ixs=self.actions_ixs[ixs],
                dones=self.dones[ixs],
            )

        return BatchLoader(len(self), batch_size, collate, shuffle=shuffle, drop_last=True, seed=seed)
