"""Fault-tolerant episode streaming: the rollout→learner transport (the
counterpart of ``trlx_tpu.fleet.stream``).

One stream batch = one finished ``make_experience`` phase, shipped as the
store's raw column dict (``PPORolloutStorage.columns()``, already numpy) in
a single ``.npz`` written atomically (tmp + ``os.replace``), plus one line
in the append-only ``stream.jsonl`` index::

    {"seq": 3, "file": "batch_000003.npz", "n": 64, "weight_version": 12, "t": ...}

The npz round trip is bitwise-lossless for every column dtype (int32
tokens and masks, float32 statistics), which is what lets the staleness-0
colocated run equal the serial run THROUGH the stream rather than around it.

Reader semantics: consume strictly in ``seq`` order; each wait is wrapped in
``resilience.retry.call_with_retries`` (per-episode timeout, bounded
retries, exponential backoff), so a transient filesystem hiccup is retried
and only a persistent stall escalates to the heartbeat triage in
``runner``. Torn index tails (a writer killed mid-line) are tolerated by
``utils.jsonl.read_jsonl``.

The ``episode_stream_stall@N`` fault fires HERE, in the writer: batch N's
append sleeps instead of writing while the worker's heartbeat thread keeps
beating (fresh ``written_t``, frozen ``progress_t``): the signature the
learner's triage must classify as STALLED, not DEAD.
"""

import os
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from trlx_tpu_torch.resilience.retry import call_with_retries
from trlx_tpu_torch.utils.jsonl import append_record

from .topology import FleetPaths, read_jsonl_or_empty, require_role_lead


class EpisodeStreamTimeout(RuntimeError):
    """A stream wait exhausted its per-attempt timeout (retryable; the
    caller's retry wrapper decides when it becomes a triage event)."""


def episode_key(columns: Dict[str, np.ndarray]) -> str:
    """Content key of a streamed batch's PROMPT shard: crc32 over the query
    tokens and mask bytes. Two productions of the same work unit (the
    original owner's and a reclaimer's) decode the same deterministic prompt
    chunks, so they carry the SAME key even when a weight broadcast landed
    between them. The elastic intake dedupes on (work_unit, episode_key)."""
    crc = 0
    for name in ("query_tensors", "query_mask"):
        arr = columns.get(name)
        if arr is not None:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return f"{crc:08x}"


def _atomic_savez(path: str, columns: Dict[str, np.ndarray]):
    # np.savez appends ".npz" to names that lack it, so the tmp name must
    # already end in .npz for os.replace to find what savez wrote.
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **{k: np.asarray(v) for k, v in columns.items()})
    os.replace(tmp, path)


def load_columns(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class EpisodeStreamWriter:
    """Rollout-side appender. Resume-aware: a restarted worker continues
    ``seq`` numbering from the existing index instead of clobbering it.

    Elastic fleets give every worker its OWN writer (``worker=k`` →
    ``stream.w<k>.jsonl`` + ``w<k>_``-prefixed npz names) so N producers
    never contend on an append; worker 0 keeps the single-worker names."""

    def __init__(self, paths: FleetPaths, fault_plan=None, worker: int = 0):
        require_role_lead("the episode stream's writer")
        self.paths = paths
        self.fault_plan = fault_plan
        self.worker = int(worker)
        self.index_path = paths.stream_index_for(self.worker)
        records = read_jsonl_or_empty(self.index_path)
        self.next_seq = 1 + max((int(r["seq"]) for r in records), default=-1)

    def append(self, columns: Dict[str, np.ndarray], weight_version: int, version_spans: Optional[list] = None,
               unit: Optional[int] = None) -> int:
        """Write one episode batch atomically and index it. Returns seq.

        ``version_spans`` is the batch-aggregate per-token weight-version
        provenance, ``[[version, n_tokens], ...]`` (the engine's in-flight
        updates). Omitted (None) for phase-boundary batches, where
        ``weight_version`` alone says everything.

        ``unit`` (elastic fleet only) tags the record with the WORK UNIT it
        produces: the learner's exactly-once intake keys on it (plus the
        content ``episode_key``) across all per-worker indexes."""
        seq = self.next_seq
        if self.fault_plan is not None and self.fault_plan.fire("episode_stream_stall", seq):
            # Stall INSTEAD of writing: the batch never lands, but the
            # worker process (and its heartbeat thread) stays alive.
            time.sleep(float(os.environ.get("TRLX_TPU_STREAM_STALL_SECONDS", "3600")))
        path = self.paths.episode_file(seq, worker=self.worker)
        _atomic_savez(path, columns)
        n = int(next(iter(columns.values())).shape[0]) if columns else 0
        rec = {
            "seq": seq,
            "file": os.path.basename(path),
            "n": n,
            "weight_version": int(weight_version),
            "t": time.time(),
        }
        if version_spans:
            rec["version_spans"] = [[int(v), int(k)] for v, k in version_spans]
        if unit is not None:
            rec["unit"] = int(unit)
            rec["worker"] = self.worker
            rec["episode_key"] = episode_key(columns)
        append_record(self.index_path, rec)
        self.next_seq = seq + 1
        return seq


def _wait_for(poll, message, *, timeout: float, retries: int, backoff: float, poll_interval: float,
              description: str) -> dict:
    """Block until ``poll()`` returns a record. Each ATTEMPT polls for up to
    ``timeout`` seconds then raises EpisodeStreamTimeout; call_with_retries
    re-attempts with doubling backoff. Exhaustion re-raises: the runner's
    triage takes over."""

    def attempt():
        deadline = time.monotonic() + max(0.1, float(timeout))
        while time.monotonic() < deadline:
            rec = poll()
            if rec is not None:
                return rec
            time.sleep(poll_interval)
        raise EpisodeStreamTimeout(message(timeout))

    return call_with_retries(attempt, retries=max(0, int(retries)), backoff=max(0.0, float(backoff)),
                             timeout=0.0, description=description)


class EpisodeStreamReader:
    """Learner-side sequential reader with timeout/retry/backoff waits."""

    def __init__(self, paths: FleetPaths):
        self.paths = paths

    def index(self) -> Dict[int, dict]:
        return {int(r["seq"]): r for r in read_jsonl_or_empty(self.paths.stream_index)}

    def poll(self, seq: int) -> Optional[dict]:
        return self.index().get(int(seq))

    def queued_from(self, seq: int) -> list:
        """Index records for every landed batch with seq >= the cursor: the
        degraded-drain worklist."""
        return [r for s, r in sorted(self.index().items()) if s >= int(seq)]

    def load(self, record: dict) -> Dict[str, np.ndarray]:
        return load_columns(os.path.join(self.paths.episodes_dir, record["file"]))

    def wait(self, seq: int, *, timeout: float, retries: int, backoff: float, poll_interval: float = 0.05) -> dict:
        """Block until batch ``seq`` lands in the index (see ``_wait_for``)."""
        return _wait_for(lambda: self.poll(seq),
                         lambda t: (f"episode batch seq={seq} did not land within {t}s "
                                    f"(index {self.paths.stream_index})"),
                         timeout=timeout, retries=retries, backoff=backoff, poll_interval=poll_interval,
                         description=f"episode stream wait seq={seq}")


class ElasticStreamReader:
    """Exactly-once learner intake over N per-worker stream indexes.

    The elastic learner consumes WORK UNITS in order (unit u = train
    iteration u). Each scan re-globs ``stream*.jsonl`` (workers join mid-run)
    and merges every index into a per-unit record list. The CHOSEN record of
    a unit is the first to land (earliest index timestamp, worker id as the
    tiebreak); every other record of that unit is a duplicate from a lease
    reclaim racing its slow or dead owner and is counted, never consumed.
    The same API as EpisodeStreamReader, with units in place of seqs."""

    def __init__(self, paths: FleetPaths):
        self.paths = paths

    def indexes(self) -> Dict[int, List[dict]]:
        return {worker: read_jsonl_or_empty(path) for worker, path in sorted(self.paths.stream_indexes().items())}

    def by_unit(self) -> Dict[int, List[dict]]:
        """unit -> its records across all workers, in landing order. Records
        without a ``unit`` field (a non-elastic writer) key on their seq."""
        units: Dict[int, List[dict]] = {}
        for worker, records in self.indexes().items():
            for rec in records:
                rec = dict(rec)
                rec.setdefault("worker", worker)
                unit = int(rec.get("unit", rec["seq"]))
                rec["unit"] = unit
                units.setdefault(unit, []).append(rec)
        for recs in units.values():
            recs.sort(key=lambda r: (float(r.get("t", 0.0)), int(r["worker"])))
        return units

    def chosen(self) -> Dict[int, dict]:
        return {unit: recs[0] for unit, recs in self.by_unit().items()}

    def duplicates(self) -> int:
        """Total landed-but-not-chosen records: the monotone
        ``fleet/episodes_deduped_total`` counter."""
        return sum(len(recs) - 1 for recs in self.by_unit().values())

    def max_unit(self) -> int:
        """Highest unit with any landed record, or -1."""
        return max(self.by_unit().keys(), default=-1)

    def poll(self, unit: int) -> Optional[dict]:
        return self.chosen().get(int(unit))

    def queued_from(self, unit: int) -> list:
        """Chosen records of every landed unit >= the cursor: the
        degraded-drain worklist (duplicates never drain twice)."""
        return [r for u, r in sorted(self.chosen().items()) if u >= int(unit)]

    def load(self, record: dict) -> Dict[str, np.ndarray]:
        return load_columns(os.path.join(self.paths.episodes_dir, record["file"]))

    def wait(self, unit: int, *, timeout: float, retries: int, backoff: float, poll_interval: float = 0.05) -> dict:
        """Block until ANY worker's record of ``unit`` lands."""
        return _wait_for(lambda: self.poll(unit),
                         lambda t: (f"episode work unit={unit} did not land in any stream index within {t}s "
                                    f"(root {self.paths.root})"),
                         timeout=timeout, retries=retries, backoff=backoff, poll_interval=poll_interval,
                         description=f"episode stream wait unit={unit}")
