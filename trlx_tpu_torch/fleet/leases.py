"""Atomic work-unit leases + worker membership for the elastic fleet (the
counterpart of ``trlx_tpu.fleet.leases``: host and filesystem code only).

The elastic fleet partitions rollout work into **work units** — unit ``u``
is train iteration ``u``'s prompt shard (the orchestrator's deterministic
chunk schedule makes any worker able to reproduce it, see
``PPOOrchestrator.seek_chunks``). N workers coordinate WITHOUT any RPC or
shared runtime, through the same filesystem-atomicity discipline as the
rest of the fleet package:

**Lease ledger** (``<fleet_dir>/leases/``). A claim on unit ``u`` at
generation ``g`` is the O_EXCL creation of ``unit_<u>.gen<g>.json`` —
creation either fully succeeds (this worker owns the unit) or raises
(a peer won); there is no rename window, so a reclaim race has exactly one
winner and a worker that dies mid-claim leaves nothing to clean up. The
owner renews its generation file's ``expires`` (atomic rewrite) off its
produce heartbeat; a lease unrenewed past its TTL may be reclaimed by any
peer as generation ``g+1``. The HIGHEST generation present is the unit's
authoritative state. ``status`` transitions: ``held`` → ``done``
(production streamed) or ``released`` (clean leave mid-hold, expiry
zeroed so peers reclaim instantly). The ledger ASSIGNS work; it does not
guarantee uniqueness of production — a slow owner that outlives its TTL
still streams its batch. Exactly-once is the learner intake's job
(``stream.ElasticStreamReader`` dedupes by work unit / episode key).

**Worker registry** (``<fleet_dir>/workers/``). ``worker_<k>.json``
membership records, ids claimed by O_EXCL (auto-assignment = lowest free
slot). Clean leave rewrites ``status: left``; a crashed worker's record
stays ``active`` and its liveness is judged by heartbeat age (the
learner's per-worker triage), never by the registry alone. Re-registering
an existing id (a restarted worker) bumps ``incarnation``.

Torn-read tolerance everywhere: a lease or registry file caught between
O_EXCL creation and payload write parses as invalid — readers treat such
a lease as freshly held (expiry from file mtime + TTL), the conservative
verdict that never steals a just-claimed unit.
"""

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from trlx_tpu_torch.resilience.checkpoint import atomic_write_json

from .topology import require_role_lead

_LEASE_FMT = "unit_{unit:06d}.gen{gen:03d}.json"


@dataclass(frozen=True)
class Lease:
    """One generation file's parsed state. ``gen`` > 0 means the unit was
    reclaimed at least once."""

    unit: int
    gen: int
    worker: int
    status: str  # held | done | released
    expires: float
    path: str

    @property
    def expired(self) -> bool:
        return time.time() > self.expires


def _write_fd_json(fd: int, payload: dict):
    data = json.dumps(payload).encode()
    try:
        os.write(fd, data)
    finally:
        os.close(fd)


class LeaseLedger:
    """O_EXCL/atomic-rename work-unit leases (module docstring)."""

    def __init__(self, directory: str, ttl: float):
        require_role_lead("the lease ledger")
        self.directory = directory
        self.ttl = max(0.1, float(ttl))
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- reading

    def _parse(self, fname: str) -> Optional[Lease]:
        # unit_000003.gen001.json → (3, 1)
        if not (fname.startswith("unit_") and fname.endswith(".json")):
            return None
        stem = fname[len("unit_"):-len(".json")]
        try:
            unit_s, gen_s = stem.split(".gen", 1)
            unit, gen = int(unit_s), int(gen_s)
        except ValueError:
            return None
        path = os.path.join(self.directory, fname)
        try:
            with open(path, "r") as f:
                rec = json.load(f)
            return Lease(
                unit=unit,
                gen=gen,
                worker=int(rec["worker"]),
                status=str(rec.get("status", "held")),
                expires=float(rec.get("expires", 0.0)),
                path=path,
            )
        except (OSError, ValueError, KeyError, TypeError):
            # Caught between O_EXCL create and payload write (or a torn
            # renewal read): freshly held by an unknown owner, expiry
            # conservatively from the file clock.
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                return None
            return Lease(
                unit=unit, gen=gen, worker=-1, status="held",
                expires=mtime + self.ttl, path=path,
            )

    def units(self) -> Dict[int, Lease]:
        """Authoritative per-unit state: the highest generation present."""
        out: Dict[int, Lease] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for fname in names:
            lease = self._parse(fname)
            if lease is None:
                continue
            cur = out.get(lease.unit)
            if cur is None or lease.gen > cur.gen:
                out[lease.unit] = lease
        return out

    def state(self, unit: int) -> Optional[Lease]:
        return self.units().get(int(unit))

    def held_by(self, worker: int) -> List[Lease]:
        """Leases currently owned (held, authoritative-generation) by a
        worker — the /healthz per-worker lease count."""
        return [
            l for l in self.units().values()
            if l.worker == int(worker) and l.status == "held"
        ]

    def reclaimed_units(self) -> List[int]:
        """Units whose authoritative generation is > 0 — each was reclaimed
        from a dead/slow owner at least once (the fleet/units_reclaimed_total
        counter)."""
        return sorted(u for u, l in self.units().items() if l.gen > 0)

    # ------------------------------------------------------------ claiming

    def _create(self, unit: int, gen: int, worker: int) -> Optional[Lease]:
        path = os.path.join(self.directory, _LEASE_FMT.format(unit=unit, gen=gen))
        expires = time.time() + self.ttl
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None  # a peer won this generation
        _write_fd_json(
            fd,
            {"unit": unit, "gen": gen, "worker": int(worker),
             "status": "held", "expires": expires, "t": time.time()},
        )
        return Lease(
            unit=unit, gen=gen, worker=int(worker), status="held",
            expires=expires, path=path,
        )

    def try_claim(self, unit: int, worker: int) -> Optional[Lease]:
        """Claim unit ``unit`` for ``worker``, or return None (unit done,
        held-and-fresh by a peer, or lost the creation race). A lease whose
        TTL lapsed — or that was released — is reclaimed as the next
        generation; ``Lease.gen > 0`` marks the result as a reclaim."""
        unit = int(unit)
        cur = self.state(unit)
        if cur is None:
            return self._create(unit, 0, worker)
        if cur.status == "done":
            return None
        if cur.status == "held" and cur.worker == int(worker):
            # Our own live claim (a crash-restarted worker re-finding its
            # unit): adopt-by-renewal instead of burning a generation.
            return self.renew(cur) or None
        if cur.status == "held" and not cur.expired:
            return None
        return self._create(unit, cur.gen + 1, worker)

    # ----------------------------------------------------- owner lifecycle

    def _rewrite(self, lease: Lease, **changes) -> Lease:
        payload = {
            "unit": lease.unit, "gen": lease.gen, "worker": lease.worker,
            "status": lease.status, "expires": lease.expires, "t": time.time(),
        }
        payload.update(changes)
        atomic_write_json(lease.path, payload)
        return Lease(
            unit=lease.unit, gen=lease.gen, worker=int(payload["worker"]),
            status=str(payload["status"]), expires=float(payload["expires"]),
            path=lease.path,
        )

    def _owns(self, lease: Lease) -> bool:
        cur = self.state(lease.unit)
        return (
            cur is not None
            and cur.gen == lease.gen
            and cur.worker == lease.worker
            and cur.status == "held"
        )

    def renew(self, lease: Lease) -> Optional[Lease]:
        """Extend a held lease's expiry by one TTL. None = ownership lost
        (a peer reclaimed at a higher generation while we were away) — the
        caller keeps producing anyway (the intake dedupes) but must report
        the loss, not the renewal."""
        if not self._owns(lease):
            return None
        return self._rewrite(lease, expires=time.time() + self.ttl)

    def complete(self, lease: Lease) -> bool:
        """Mark a held lease done (advisory: the stream record is the real
        proof of production). False = ownership was lost before completion
        — a duplicate production is now in flight for the intake to dedupe."""
        if not self._owns(lease):
            return False
        self._rewrite(lease, status="done")
        return True

    def release(self, lease: Lease) -> bool:
        """Clean-leave handoff of a still-held unit: expiry zeroed so the
        next peer scan reclaims it immediately instead of out-waiting TTL.
        False when the hold was already lost (expired and reclaimed)."""
        if not self._owns(lease):
            return False
        self._rewrite(lease, status="released", expires=0.0)
        return True


# --------------------------------------------------------------- registry

_WORKER_FMT = "worker_{worker:03d}.json"


class WorkerRegistry:
    """O_EXCL worker-id membership records (module docstring)."""

    def __init__(self, directory: str):
        require_role_lead("the worker registry")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, worker: int) -> str:
        return os.path.join(self.directory, _WORKER_FMT.format(worker=int(worker)))

    def workers(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for fname in names:
            if not (fname.startswith("worker_") and fname.endswith(".json")):
                continue
            try:
                wid = int(fname[len("worker_"):-len(".json")])
                with open(os.path.join(self.directory, fname), "r") as f:
                    out[wid] = json.load(f)
            except (OSError, ValueError):
                continue  # torn mid-registration; next scan sees it whole
        return out

    def active(self) -> List[int]:
        return sorted(
            wid for wid, rec in self.workers().items()
            if rec.get("status") == "active"
        )

    def register(self, worker: Optional[int] = None) -> int:
        """Claim a worker id: the explicit one (re-registration bumps
        ``incarnation`` — same id, same heartbeat slot, a restarted worker)
        or the lowest O_EXCL-winnable free slot."""
        if worker is not None:
            wid = int(worker)
            existing = self.workers().get(wid)
            incarnation = int(existing.get("incarnation", 0)) + 1 if existing else 0
            atomic_write_json(self._path(wid), self._payload(wid, incarnation))
            return wid
        wid = 0
        while True:
            try:
                fd = os.open(self._path(wid), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                wid += 1
                continue
            _write_fd_json(fd, self._payload(wid, 0))
            return wid

    @staticmethod
    def _payload(wid: int, incarnation: int) -> dict:
        return {
            "worker": wid,
            "pid": os.getpid(),
            "status": "active",
            "incarnation": incarnation,
            "t": time.time(),
        }

    def leave(self, worker: int):
        """Clean departure: peers (and the learner's triage) stop counting
        this worker against liveness the moment the rewrite lands."""
        rec = self.workers().get(int(worker)) or self._payload(int(worker), 0)
        rec = dict(rec)
        rec["status"] = "left"
        rec["t"] = time.time()
        atomic_write_json(self._path(int(worker)), rec)
