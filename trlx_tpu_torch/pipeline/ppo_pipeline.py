"""PPO rollout storage: a column store of fixed-width rollout rows (the
counterpart of ``trlx_tpu.pipeline.ppo_pipeline``, on its numpy column
path). Rows arrive already padded: queries left-padded [P], responses
right-padded [R]. A store built with ``record_staleness`` (the overlapped
pipeline's) keeps one more column, each row's staleness, which its batches
carry as host extras. ``create_loader(pack=True)`` packs each train batch's
episodes into dense rows (``pack_ppo_batch``)."""

from typing import Dict, Iterable, List, Optional

import numpy as np

from trlx_tpu_torch.data import PackedPPOBatch, PPORLBatch, PPORLElement
from trlx_tpu_torch.pipeline import BaseRolloutStore, BatchLoader


def _pack_row_buckets(batch_size: int, rows_multiple: int = 1):
    """Allowed packed row counts: the quartiles of the unpacked batch,
    rounded up to a multiple of ``rows_multiple`` (the mesh's data-axis
    size), so the train step sees at most four shapes."""
    m = max(1, rows_multiple)
    return sorted({-(-max(1, (batch_size * k + 3) // 4) // m) * m for k in (1, 2, 3, 4)})


def pack_ppo_batch(g: Dict[str, np.ndarray], pad_token_id: int = 0, rows_multiple: int = 1) -> PackedPPOBatch:
    """Pack B variable-length episodes into dense [rows, P+R] rows.

    ``g`` holds one train batch's gathered store columns (queries
    left-padded [B, P], responses right-padded [B, R], per-token stats
    [B, R]). Each episode's valid tokens (query run, then response run) go
    contiguously into the first row with room (first-fit decreasing, stable
    for ties); all B episodes are packed, empty responses too, so the
    per-sequence stats normalize by exactly B.

    Per-token outputs follow the state-before-token convention: an episode
    at row offset ``o`` with ``q`` query and ``r`` response tokens has its
    states at o+q-1 .. o+q+r-2; ``labels`` there is the response token the
    state predicts, and the rollout stats scatter to the same positions.
    Everything outside ``loss_mask`` is zero."""
    q, qm = np.asarray(g["query_tensors"]), np.asarray(g["query_mask"])
    r, rm = np.asarray(g["response_tensors"]), np.asarray(g["response_mask"])
    B, P = q.shape
    R = r.shape[1]
    W = P + R
    q_lens = qm.astype(np.int64).sum(axis=1)
    r_lens = rm.astype(np.int64).sum(axis=1)
    lens = q_lens + r_lens

    order = np.argsort(-lens, kind="stable")
    row_used = []
    placement = {}  # episode -> (row, offset)
    for i in order:
        L = int(lens[i])
        for ro, used in enumerate(row_used):
            if used + L <= W:
                placement[i] = (ro, used)
                row_used[ro] = used + L
                break
        else:
            placement[i] = (len(row_used), 0)
            row_used.append(L)
    nrows = next(b for b in _pack_row_buckets(B, rows_multiple) if b >= len(row_used))

    input_ids = np.full((nrows, W), pad_token_id, dtype=np.int32)
    attention_mask = np.zeros((nrows, W), dtype=np.int32)
    segment_ids = np.zeros((nrows, W), dtype=np.int32)
    position_ids = np.zeros((nrows, W), dtype=np.int32)
    labels = np.zeros((nrows, W), dtype=np.int32)
    loss_mask = np.zeros((nrows, W), dtype=np.int32)
    old_logprobs = np.zeros((nrows, W), dtype=np.float32)
    old_values = np.zeros((nrows, W), dtype=np.float32)
    rewards = np.zeros((nrows, W), dtype=np.float32)

    for i in range(B):
        ro, o = placement[i]
        ql, rl = int(q_lens[i]), int(r_lens[i])
        toks = np.concatenate([q[i, P - ql:] if ql else q[i, :0], r[i, :rl]])
        L = ql + rl
        input_ids[ro, o:o + L] = toks
        attention_mask[ro, o:o + L] = 1
        segment_ids[ro, o:o + L] = i + 1
        position_ids[ro, o:o + L] = np.arange(L)
        if rl and ql:
            s0 = o + ql - 1  # the first state: it predicts the first response token
            labels[ro, s0:s0 + rl] = toks[ql:ql + rl]
            loss_mask[ro, s0:s0 + rl] = 1
            old_logprobs[ro, s0:s0 + rl] = g["logprobs"][i, :rl]
            old_values[ro, s0:s0 + rl] = g["values"][i, :rl]
            rewards[ro, s0:s0 + rl] = g["rewards"][i, :rl]

    extras = {"pack_fill": float(attention_mask.sum()) / float(nrows * W), "batch_tokens": int(nrows * W),
              "n_seqs": B}
    if "staleness" in g:
        extras["staleness"] = np.asarray(g["staleness"])[:, 0]
    return PackedPPOBatch(
        input_ids=input_ids, attention_mask=attention_mask, segment_ids=segment_ids, position_ids=position_ids,
        labels=labels, loss_mask=loss_mask, old_logprobs=old_logprobs, old_values=old_values, rewards=rewards,
        n_seqs=None, extras=extras,
    )

_FIELD_SPECS = (
    ("query_tensors", "P", np.int32),
    ("query_mask", "P", np.int32),
    ("response_tensors", "R", np.int32),
    ("response_mask", "R", np.int32),
    ("logprobs", "R", np.float32),
    ("values", "R", np.float32),
    ("rewards", "R", np.float32),
)

# Per-row staleness (training iterations between the policy that generated a
# row and the one trained on it), kept only by stores built with
# record_staleness: a serial store keeps the seven-column layout.
_STALENESS_SPEC = ("staleness", 1, np.float32)


class RolloutBuffer:
    """Column store of fixed-width rows: ``push`` appends [n, width] chunks
    per field, ``gather`` returns the rows at arbitrary indices."""

    def __init__(self, fields):
        self.fields = [(n, int(e), np.dtype(d)) for n, e, d in fields]
        self._chunks: Dict[str, List[np.ndarray]] = {n: [] for n, _, _ in self.fields}
        self._consolidated: Optional[Dict[str, np.ndarray]] = None
        self._rows = 0

    def __len__(self) -> int:
        return self._rows

    def clear(self):
        self._chunks = {n: [] for n, _, _ in self.fields}
        self._consolidated = None
        self._rows = 0

    def push(self, arrays: Dict[str, np.ndarray]) -> int:
        prepped = []
        n_rows = None
        for name, elems, dt in self.fields:
            a = np.ascontiguousarray(np.asarray(arrays[name], dtype=dt).reshape(len(arrays[name]), elems))
            if n_rows is not None and a.shape[0] != n_rows:
                raise ValueError(f"field {name} has {a.shape[0]} rows, expected {n_rows}")
            n_rows = a.shape[0]
            prepped.append(a)
        if not n_rows:
            return self._rows
        for (name, _, _), a in zip(self.fields, prepped):
            self._chunks[name].append(a)
        self._consolidated = None
        self._rows += n_rows
        return self._rows

    def gather(self, ixs) -> Dict[str, np.ndarray]:
        ixs = np.asarray(ixs, dtype=np.int64)
        if self._rows == 0:
            if len(ixs):
                raise IndexError("gather from an empty RolloutBuffer")
            return {name: np.empty((0, elems), dtype=dt) for name, elems, dt in self.fields}
        if self._consolidated is None:
            self._consolidated = {name: np.concatenate(self._chunks[name], axis=0) for name, _, _ in self.fields}
        return {name: self._consolidated[name][ixs] for name, _, _ in self.fields}


class PPORolloutStorage(BaseRolloutStore):
    def __init__(self, pad_token_id: int = 0, record_staleness: bool = False):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.record_staleness = bool(record_staleness)
        self._buffer = None  # created at the first push (widths from the data)

    def push_batch(self, arrays: Dict[str, np.ndarray]) -> int:
        """Append a chunk of rollout rows (the orchestrator's path). A store
        that records staleness takes rows without the column as staleness 0."""
        q = np.asarray(arrays["query_tensors"])
        if self._buffer is None:
            widths = {"P": q.shape[1], "R": np.asarray(arrays["response_tensors"]).shape[1]}
            specs = [(n, widths[w], dt) for n, w, dt in _FIELD_SPECS]
            if self.record_staleness:
                specs.append(_STALENESS_SPEC)
            self._buffer = RolloutBuffer(specs)
        if self.record_staleness and "staleness" not in arrays:
            arrays = dict(arrays, staleness=np.zeros((q.shape[0], 1), dtype=np.float32))
        return self._buffer.push(arrays)

    def push(self, exps: Iterable[PPORLElement]):
        """Reference-shaped API: a list of per-sample elements."""
        exps = list(exps)
        if not exps:
            return
        self.push_batch(
            {
                "query_tensors": np.stack([e.query_tensor for e in exps]),
                "query_mask": np.stack([e.query_mask for e in exps]),
                "response_tensors": np.stack([e.response_tensor for e in exps]),
                "response_mask": np.stack([e.response_mask for e in exps]),
                "logprobs": np.stack([e.logprobs for e in exps]),
                "values": np.stack([e.values for e in exps]),
                "rewards": np.stack([e.rewards for e in exps]),
            }
        )

    def clear_history(self):
        if self._buffer is not None:
            self._buffer.clear()

    def columns(self) -> Dict[str, np.ndarray]:
        """All stored rows as one column dict (empty when nothing was pushed)."""
        if self._buffer is None or len(self._buffer) == 0:
            return {}
        return self._buffer.gather(np.arange(len(self._buffer)))

    def __len__(self) -> int:
        return 0 if self._buffer is None else len(self._buffer)

    def __getitem__(self, ix: int) -> PPORLElement:
        g = self._buffer.gather(np.asarray([ix]))
        return PPORLElement(
            query_tensor=g["query_tensors"][0],
            response_tensor=g["response_tensors"][0],
            logprobs=g["logprobs"][0],
            values=g["values"][0],
            rewards=g["rewards"][0],
            response_mask=g["response_mask"][0],
            query_mask=g["query_mask"][0],
        )

    def create_loader(self, batch_size: int, shuffle: bool = False, seed: int = 0, pack: bool = False,
                      rows_multiple: int = 1) -> BatchLoader:
        """Shuffled train batches: ``PPORLBatch`` (with the staleness column
        as ``extras`` when recorded), or with ``pack`` a ``PackedPPOBatch``
        of the same rows."""
        buffer = self._buffer
        record_staleness = self.record_staleness
        pad_token_id = self.pad_token_id

        def collate(ixs):
            g = buffer.gather(np.asarray(ixs))
            if pack:
                return pack_ppo_batch(g, pad_token_id, rows_multiple)
            return PPORLBatch(
                query_tensors=g["query_tensors"],
                response_tensors=g["response_tensors"],
                logprobs=g["logprobs"],
                values=g["values"],
                rewards=g["rewards"],
                response_mask=g["response_mask"],
                query_mask=g["query_mask"],
                extras={"staleness": g["staleness"][:, 0]} if record_staleness else None,
            )

        return BatchLoader(len(self), batch_size, collate, shuffle=shuffle, drop_last=True, seed=seed)
