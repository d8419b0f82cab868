"""Prompt pipeline: text or token-id prompts → fixed-shape left-padded
batches (the counterpart of ``trlx_tpu.pipeline.prompt_pipeline``). Prompts
longer than the width keep their trailing tokens. With ``bucket_widths``
each prompt pads only to the smallest bucket width that holds it, and the
loader's batches are bucket-uniform."""

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from trlx_tpu_torch.pipeline import BasePipeline, BatchLoader, BucketedBatchLoader, register_datapipeline


def normalize_buckets(widths: Optional[Sequence[int]], max_width: int):
    """Sorted, deduplicated bucket widths in (0, max_width], with max_width
    always the last bucket; None for None or an empty input (bucketing
    off)."""
    if not widths:
        return None
    ws = sorted({int(w) for w in widths if 0 < int(w) <= max_width})
    if not ws or ws[-1] != max_width:
        ws.append(max_width)
    return tuple(ws)


def pad_ragged(
    token_lists: Sequence[Sequence[int]], max_len: int, pad_id: int, left_pad: bool = True, keep_last: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged token lists → ([n, max_len] int32 ids, [n, max_len] int32
    mask). Overlong rows keep their trailing (keep_last) or leading tokens."""
    n = len(token_lists)
    out_ids = np.full((n, max_len), pad_id, dtype=np.int32)
    out_mask = np.zeros((n, max_len), dtype=np.int32)
    for i, t in enumerate(token_lists):
        r = np.asarray(t, dtype=np.int32).reshape(-1)
        row = r[-max_len:] if keep_last else r[:max_len]
        L = len(row)
        sl = slice(max_len - L, max_len) if left_pad else slice(0, L)
        out_ids[i, sl] = row
        out_mask[i, sl] = 1
    return out_ids, out_mask


class PromptSlotQueue:
    """Width-grouped FIFO feeding the rollout engine's slot admission
    (``trlx_tpu_torch.engine``). Prompts queue at their width; ``pop_group``
    hands back up to ``limit`` rows of one width, the width with the most
    queued prompts, so prefill batches stay full while every width still
    drains (FIFO within a width)."""

    def __init__(self):
        self._queues = {}  # width -> list of (ids [w], mask [w]) host rows

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def push_rows(self, input_ids, attention_mask) -> int:
        """Queue a [n, width] host batch as n single-prompt rows."""
        ids = np.asarray(input_ids)
        msk = np.asarray(attention_mask)
        q = self._queues.setdefault(int(ids.shape[1]), [])
        q.extend(zip(ids, msk))
        return ids.shape[0]

    def pop_group(self, limit: int):
        """Dequeue up to ``limit`` same-width prompts (the fullest width
        first). Returns (width, ids [j, width], mask [j, width]) or None."""
        if limit <= 0 or len(self) == 0:
            return None
        width = max((w for w, q in self._queues.items() if q), key=lambda w: len(self._queues[w]))
        q = self._queues[width]
        taken, self._queues[width] = q[:limit], q[limit:]
        return width, np.stack([t[0] for t in taken]), np.stack([t[1] for t in taken])

    def clear(self):
        self._queues.clear()


@register_datapipeline
class PromptPipeline(BasePipeline):
    """Tokenizes (or takes token ids) and left-pads a list of prompts.

    :param prompts: strings (with a tokenizer) or int sequences (token-id
        mode, no tokenizer).
    :param tokenizer: HF tokenizer or None.
    :param max_prompt_length: fixed prompt width.
    :param bucket_widths: optional prompt-length buckets (``normalize_buckets``;
        max_prompt_length is always the last). Each prompt is padded to the
        smallest width that holds it, and ``create_loader`` returns a
        ``BucketedBatchLoader``. ``__getitem__`` and the full-width arrays
        keep the single-width layout.
    """

    def __init__(self, prompts: Iterable, tokenizer=None, max_prompt_length: int = 64, add_bos: bool = True,
                 bucket_widths: Optional[Sequence[int]] = None):
        self.tokenizer = tokenizer
        self.max_prompt_length = max_prompt_length
        self.bucket_widths = normalize_buckets(bucket_widths, max_prompt_length)
        if tokenizer is not None:
            bos = [tokenizer.bos_token_id] if (add_bos and tokenizer.bos_token_id is not None) else []
            token_lists = [bos + tokenizer(text, add_special_tokens=False)["input_ids"] for text in prompts]
            pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 0
        else:
            token_lists = [np.asarray(p).reshape(-1) for p in prompts]
            pad_id = 0
        self.input_ids, self.attention_mask = pad_ragged(
            token_lists, max_prompt_length, pad_id, left_pad=True, keep_last=True
        )
        self.pad_id = pad_id

        # Per bucket width, its member rows padded to that width.
        self._bucket_rows, self._bucket_ids, self._bucket_mask = {}, {}, {}
        if self.bucket_widths is not None:
            lengths = [min(len(t), max_prompt_length) for t in token_lists]
            target = [next(w for w in self.bucket_widths if w >= n) for n in lengths]
            for w in self.bucket_widths:
                rows = np.asarray([i for i, t in enumerate(target) if t == w], dtype=np.int64)
                if len(rows) == 0:
                    continue
                self._bucket_rows[w] = rows
                self._bucket_ids[w], self._bucket_mask[w] = pad_ragged(
                    [token_lists[i] for i in rows], w, pad_id, left_pad=True, keep_last=True)

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    def __getitem__(self, ix: int):
        return {"input_ids": self.input_ids[ix], "attention_mask": self.attention_mask[ix]}

    def create_loader(self, batch_size: int, shuffle: bool = False, drop_last: bool = False, seed: int = 0):
        if self.bucket_widths is not None:
            def bucket_collate(width, ixs):
                return {"input_ids": self._bucket_ids[width][ixs], "attention_mask": self._bucket_mask[width][ixs]}

            buckets = {w: np.arange(len(rows)) for w, rows in self._bucket_rows.items()}
            return BucketedBatchLoader(buckets, batch_size, bucket_collate, shuffle=shuffle, drop_last=drop_last,
                                       seed=seed)

        def collate(ixs):
            return {"input_ids": self.input_ids[ixs], "attention_mask": self.attention_mask[ixs]}

        return BatchLoader(len(self), batch_size, collate, shuffle=shuffle, drop_last=drop_last, seed=seed)
