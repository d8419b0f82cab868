"""Versioned weight broadcast: the learner→rollout transport (the
counterpart of ``trlx_tpu.fleet.broadcast``).

The learner publishes a flat-leaf snapshot of its policy at every consume
boundary (and once at bootstrap)::

    weights_<ordinal>.npz          # leaves by position: leaf_000000, ...
    broadcast.jsonl  += {"ordinal": k, "version": v, "file": ..., "status": "published", "t": ...}
    weights_latest.json            # atomic pointer {ordinal, version, file}

``ordinal`` is the dense publish counter (resume-safe: a restarted learner
continues from the log length); ``version`` is the training iter_count the
snapshot was taken at, the tag every episode carries.

What is published: the policy module's parameters in ``named_parameters()``
order, every master (trainable or frozen) and the heads. The frozen
reference branch (the trainer's ``extras``) is not published: each side
builds it locally from the same config and seed. Leaves are matched
POSITIONALLY: both sides build the identical model from the same config, so
a count, size or dtype mismatch is a hard error naming the first leaf at
fault. Each leaf travels as its RAW BYTES (``t.view(torch.uint8)`` copied
to the host) and is restored by viewing the bytes as the receiving
parameter's dtype and shape: bytes in, bytes out, so the transport is
bitwise by construction (bf16 included), which the staleness-0 parity
test leans on.

The rollout side blocks for the version its staleness gate requires under
``collective_guard("fleet/weight_broadcast", deadline=...)``: a worker
starved of weights is treated as a peer stuck in a broadcast (heartbeat
phase tagging, stall report, and exit code 117 at the deadline). The
``broadcast_timeout@N`` fault fires in the publisher: ordinal N's snapshot
is SKIPPED (logged as ``status="injected_timeout"``); ``weight_push_torn@N``
truncates ordinal N's file and flips the pointer to it (the JAX publisher
truncates just after the flip, which leaves a reader a window to load it
whole).
"""

import json
import os
import time
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from trlx_tpu_torch.resilience.checkpoint import atomic_write_json
from trlx_tpu_torch.resilience.distributed import collective_guard
from trlx_tpu_torch.utils.jsonl import append_record

from .topology import FleetPaths, read_jsonl_or_empty, require_role_lead

BROADCAST_GUARD = "fleet/weight_broadcast"

Leaves = Union[Dict[str, torch.Tensor], Sequence[Tuple[str, torch.Tensor]]]


def _leaf_key(i: int) -> str:
    return f"leaf_{i:06d}"


def _named(params: Leaves) -> List[Tuple[str, torch.Tensor]]:
    return list(params.items()) if isinstance(params, dict) else list(params)


def _sync(tensors):
    """Wait for the card's queued work on these tensors (timing only)."""
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()


class WeightPublisher:
    """Learner-side publisher. One ``publish`` per consume boundary.
    ``last_stats`` holds the last publish's bytes and its seconds
    (device-to-host copy, npz write)."""

    def __init__(self, paths: FleetPaths, fault_plan=None):
        require_role_lead("the weight broadcast's publisher")
        self.paths = paths
        self.fault_plan = fault_plan
        records = read_jsonl_or_empty(paths.broadcast_log)
        # Dense resume: injected-timeout records still consumed an ordinal.
        self.next_ordinal = 1 + max((int(r["ordinal"]) for r in records), default=-1)
        self.last_stats: Dict[str, float] = {}

    @torch.no_grad()
    def publish(self, params: Leaves, version: int, meta: Optional[dict] = None) -> int:
        """Snapshot ``params`` (name → tensor, in the fixed publish order)
        to disk and advance the latest pointer. Returns the ordinal it
        landed at.

        ``meta`` rides in the log record AND the latest pointer: small host
        scalars the rollout side must track in lockstep with the weights
        (the adaptive KL coefficient ``kl_coef``, which shapes rollout
        rewards as the weights shape rollout tokens)."""
        ordinal = self.next_ordinal
        self.next_ordinal = ordinal + 1
        if self.fault_plan is not None and self.fault_plan.fire("broadcast_timeout", ordinal):
            # Skip the snapshot entirely: the log records the injection (so
            # lineage checks can filter status=="published") but no file
            # lands and the latest pointer stays put.
            append_record(self.paths.broadcast_log, {"ordinal": ordinal, "version": int(version), "file": None,
                                                     "status": "injected_timeout", "t": time.time()})
            return ordinal
        named = _named(params)
        tensors = [t for _, t in named]
        _sync(tensors)
        t0 = time.perf_counter()
        views = {_leaf_key(i): t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                 for i, t in enumerate(tensors)}
        d2h_s = time.perf_counter() - t0
        path = self.paths.weight_file(ordinal)
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        t0 = time.perf_counter()
        np.savez(tmp, **views)
        os.replace(tmp, path)
        write_s = time.perf_counter() - t0
        torn = self.fault_plan is not None and self.fault_plan.fire("weight_push_torn", ordinal)
        if torn:
            # Torn-push drill: the snapshot file the pointer is about to name
            # is truncated (publisher killed mid-write, full disk).
            # Subscribers must reject the torn load and keep decoding on the
            # version they hold. Truncated before the pointer flips, so no
            # reader can load it whole in between.
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 2))
        self.last_stats = {"bytes": float(sum(v.nbytes for v in views.values())), "d2h_s": d2h_s,
                           "write_s": write_s, "leaves": float(len(views))}
        rec = {
            "ordinal": ordinal,
            "version": int(version),
            "file": os.path.basename(path),
            "n_leaves": len(views),
            "status": "published",
            "t": time.time(),
        }
        pointer = {"ordinal": ordinal, "version": int(version), "file": rec["file"]}
        if meta:
            rec.update(meta)
            pointer.update(meta)
        append_record(self.paths.broadcast_log, rec)
        atomic_write_json(self.paths.latest_pointer, pointer)
        if torn:
            append_record(self.paths.broadcast_log, {"ordinal": ordinal, "version": int(version),
                                                     "file": rec["file"], "status": "injected_torn",
                                                     "t": time.time()})
        return ordinal

    def published(self) -> List[dict]:
        return [r for r in read_jsonl_or_empty(self.paths.broadcast_log) if r.get("status") == "published"]


class WeightSubscriber:
    """Rollout-side subscriber: poll the latest pointer, load host leaves.
    ``last_load_s`` is the last successful load's seconds."""

    def __init__(self, paths: FleetPaths):
        self.paths = paths
        self.last_load_s = 0.0

    def latest(self) -> Optional[dict]:
        """The latest pointer, or None. Torn-read tolerant."""
        try:
            with open(self.paths.latest_pointer, "r") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def load(self, record: dict) -> List[np.ndarray]:
        t0 = time.perf_counter()
        path = os.path.join(self.paths.weights_dir, record["file"])
        with np.load(path, allow_pickle=False) as z:
            leaves = [z[k] for k in sorted(z.files)]
        self.last_load_s = time.perf_counter() - t0
        return leaves

    def try_load(self, record: dict) -> Optional[List[np.ndarray]]:
        """``load`` that treats a torn or truncated snapshot (the
        ``weight_push_torn`` drill) as not there: None instead of a raise,
        so an in-flight poller keeps decoding on the version it holds and
        picks up the next intact ordinal."""
        try:
            return self.load(record)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None

    def fetch(self, min_ordinal: int, *, deadline: float, abort_check: Optional[Callable[[], bool]] = None,
              heartbeat=None, poll_interval: float = 0.05,
              on_torn: Optional[Callable[[dict], None]] = None) -> Optional[Tuple[dict, List[np.ndarray]]]:
        """Block until a snapshot with ordinal >= ``min_ordinal`` is
        published, under the collective guard's deadline. Returns (pointer
        record, host leaves), or None if ``abort_check`` tripped first
        (coordinated shutdown, not a fault). Deadline exceeded = guard
        abort: exit 117, never a hang. ``on_torn(pointer)`` is told of each
        torn snapshot the wait passes over."""
        with collective_guard(BROADCAST_GUARD, deadline=max(0.1, float(deadline)), only_collectives=False):
            while True:
                rec = self.latest()
                if rec is not None and int(rec["ordinal"]) >= int(min_ordinal):
                    # Torn-tolerant: a satisfying pointer whose file is
                    # truncated keeps us polling for the next intact ordinal;
                    # the deadline still bounds a publisher that never recovers.
                    leaves = self.try_load(rec)
                    if leaves is not None:
                        break
                    if on_torn is not None:
                        on_torn(rec)
                if abort_check is not None and abort_check():
                    return None
                if heartbeat is not None:
                    heartbeat.beat(phase=f"collective:{BROADCAST_GUARD}")
                time.sleep(poll_interval)
        return rec, leaves


@torch.no_grad()
def put_leaves(template: Leaves, host_leaves: List[np.ndarray], module=None) -> Dict[str, torch.Tensor]:
    """Copy broadcast byte-leaves into ``template``'s tensors (name → tensor,
    in the publish order), in place: each blob re-viewed with the tensor's
    dtype and shape and copied to its device, the tensor's address kept, so
    a captured graph reads the new values. Bitwise: no cast. A count or
    byte-size mismatch raises, naming the first leaf at fault, before any
    tensor is written. Returns the template as a dict.

    ``module`` (the template's, on an fsdp or tp mesh): a blob holds the
    whole parameter, and this rank's piece of it is copied
    (``models.lm.shard_tensor``)."""
    from trlx_tpu_torch.models.lm import placement_of, shard_tensor

    named = _named(template)
    if len(named) != len(host_leaves):
        raise ValueError(
            f"weight broadcast leaf-count mismatch: snapshot has "
            f"{len(host_leaves)} leaves, this world's param tree has "
            f"{len(named)} — the jobs are not running the same model "
            "config."
        )
    blobs = []
    for raw, (name, ref) in zip(host_leaves, named):
        raw = np.ascontiguousarray(np.asarray(raw)).reshape(-1).view(np.uint8)
        pl = None if module is None else placement_of(module, name)
        shape = tuple(ref.shape) if pl is None else tuple(pl.full_shape)
        expected = int(np.prod(shape)) * ref.element_size()
        if raw.nbytes != expected:
            # A same-shape dtype misconfig (f32 learner → bf16 rollout) looks
            # like a byte-count skew on every leaf: the name tells the
            # operator which config knob diverged.
            raise ValueError(
                f"weight broadcast leaf size mismatch at param leaf "
                f"{name!r}: {raw.nbytes} bytes vs "
                f"expected {expected} for shape {shape} "
                f"{ref.dtype} — the jobs are not running the same model config "
                "(dtype mismatch, e.g. an f32 learner streaming to a bf16 "
                "rollout world, shows up here as a per-leaf byte-count skew)."
            )
        blob = torch.from_numpy(raw).view(ref.dtype).reshape(shape)
        blobs.append(blob if pl is None else shard_tensor(module, name, blob))
    for host, (_, ref) in zip(blobs, named):
        ref.copy_(host)
    return dict(named)
