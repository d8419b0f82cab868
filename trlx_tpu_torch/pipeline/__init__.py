"""Data pipelines and rollout storage (the counterparts of
``trlx_tpu.pipeline``): plain-Python loaders over numpy that produce
fixed-shape batches. Train loaders drop ragged final batches; other loaders
pad the final batch by wrapping around and report the valid count."""

from abc import abstractmethod
from typing import Any, Callable, Dict, Iterable, List

import numpy as np

_DATAPIPELINE: Dict[str, type] = {}


def register_datapipeline(name=None):
    """Decorator registering a pipeline class by (lowercased) name."""

    def register_class(cls, registered_name):
        _DATAPIPELINE[registered_name.lower()] = cls
        return cls

    if isinstance(name, str):
        return lambda cls: register_class(cls, name)
    if name is None:
        return lambda cls: register_class(cls, cls.__name__)
    cls = name
    return register_class(cls, cls.__name__)


def get_datapipeline(name: str) -> type:
    name = name.lower()
    if name in _DATAPIPELINE:
        return _DATAPIPELINE[name]
    raise ValueError(f"no pipeline registered under {name!r}")


class BatchLoader:
    """Shuffled fixed-size batches: ``collate(indices) -> batch``. With
    drop_last=False the final batch is padded by wrapping around so every
    batch has the same shape. The shuffle order is a pure function of
    ``seed`` (numpy's default_rng), identical to the JAX package's loader."""

    def __init__(self, n: int, batch_size: int, collate: Callable, shuffle: bool = False, drop_last: bool = True,
                 seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        for batch, _ in self.iter_with_valid():
            yield batch

    def iter_with_valid(self):
        """Yield (batch, n_valid); rows [n_valid:] of a wrapped final batch
        are duplicates kept only for the fixed shape."""
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(len(self)):
            ix = order[b * self.batch_size : (b + 1) * self.batch_size]
            n_valid = len(ix)
            if n_valid < self.batch_size:
                reps = int(np.ceil((self.batch_size - n_valid) / self.n))
                ix = np.concatenate([ix] + [order] * reps)[: self.batch_size]
            yield self.collate(ix), n_valid


class BucketedBatchLoader:
    """Fixed-size batches, each drawn from ONE length bucket.

    ``buckets`` maps a key (a padded prompt width) to the dataset indices
    stored at that width; ``collate(key, indices) -> batch`` builds a batch
    from one bucket, so batch shapes vary only across buckets (a decode
    graph per bucket, not per ragged batch). Short final batches wrap
    around WITHIN their bucket; ``iter_with_valid`` reports the true row
    count. With shuffle, rows shuffle within buckets and the batch order
    interleaves buckets (numpy's default_rng from ``seed``, the JAX
    package's order); otherwise buckets run in key order."""

    def __init__(self, buckets: Dict[Any, Any], batch_size: int, collate: Callable, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0):
        self.buckets = {k: np.asarray(v) for k, v in buckets.items() if len(v) > 0}
        if not self.buckets:
            raise ValueError("BucketedBatchLoader needs at least one non-empty bucket")
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def _n_batches(self, n: int) -> int:
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __len__(self):
        return sum(self._n_batches(len(v)) for v in self.buckets.values())

    def __iter__(self):
        for batch, _ in self.iter_with_valid():
            yield batch

    def iter_with_valid(self):
        """Yield (batch, n_valid); rows [n_valid:] are within-bucket
        wrap-around duplicates kept only for the fixed shape."""
        plan = []
        for key in sorted(self.buckets):
            order = self.buckets[key].copy()
            if self.shuffle:
                self._rng.shuffle(order)
            bs, n = self.batch_size, len(order)
            for b in range(self._n_batches(n)):
                ix = order[b * bs:(b + 1) * bs]
                n_valid = len(ix)
                if n_valid < bs:
                    reps = int(np.ceil((bs - n_valid) / n))
                    ix = np.concatenate([ix] + [order] * reps)[:bs]
                plan.append((key, ix, n_valid))
        if self.shuffle:
            plan = [plan[i] for i in self._rng.permutation(len(plan))]
        for key, ix, n_valid in plan:
            yield self.collate(key, ix), n_valid


class BasePipeline:
    """Dataset of prompts."""

    @abstractmethod
    def __len__(self) -> int: ...

    @abstractmethod
    def __getitem__(self, ix: int) -> Any: ...

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False) -> BatchLoader: ...


class BaseRolloutStore:
    """Rollout storage."""

    def __init__(self, capacity: int = -1):
        self.history: List[Any] = []
        self.capacity = capacity

    @abstractmethod
    def push(self, exps: Iterable[Any]): ...

    def clear_history(self):
        self.history = []

    def __len__(self) -> int:
        return len(self.history)

    def __getitem__(self, ix: int) -> Any:
        return self.history[ix]

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False) -> BatchLoader: ...
