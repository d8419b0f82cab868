"""The runtime race sanitizer, armed by ``TRLX_TPU_SANITIZE=race`` (the
counterpart of the ``race`` half of ``trlx_tpu.utils.sanitize``).

The static pass (the port's own linter, ``python -m trlx_tpu_torch.analysis
trlx_tpu_torch --select GL008``) checks the lexical lock discipline of the
port's threads; this module checks the dynamic half when armed::

    TRLX_TPU_SANITIZE=race python -m pytest tests/test_torch_overlap.py

``race`` is an Eraser-style per-field lockset tracker. Locks built through
``make_lock`` / ``make_condition`` register in a thread-local held-lock set;
declared shared fields (the producer's counters and stores, the score
worker's busy time, the engine's staged weights and slot state, graftscope's
buffers, the exporter's gauges, graftfleet's state, the heartbeat's beat,
the checkpoint writer's result) report each access through
``race_access``. Once a field has been touched by two
threads with at least one write, the intersection of the held-lock sets at
its accesses must stay non-empty; when it empties, ``RaceViolation`` names
both conflicting sites (thread, stack, locks held). ``race_forget`` marks a
legitimate ownership transfer (a joined worker, a versioned weight handoff):
it drops the owner's history, so the reader after the join is not a false
positive. ``shared_fields()`` names every field that two or more threads
have touched since the last ``clear_races()``, and ``violations()`` every
violation raised since (a thread that dies of one leaves it there too).

The JAX package's other two modes have no counterpart here and are refused
by name: ``dispatch`` asserts ownership of the dispatch lock that serializes
JAX program launches (the port has none: each thread enqueues on its own
CUDA stream), and ``donation`` traps reads of buffers donated to a jitted
program (PyTorch has no buffer donation).

Unarmed the module costs nothing and leaves nothing behind: the factories
return plain ``threading`` primitives and every hook returns after one
global flag test.

stdlib only: the port's modules import it, never the other way round.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

ENV_VAR = "TRLX_TPU_SANITIZE"
_VALID_MODES = ("race",)
# The JAX package's modes that the port refuses, and why.
_REFUSED_MODES = {
    "dispatch": "the port has no dispatch lock to assert: each thread launches on its own CUDA stream",
    "donation": "PyTorch has no buffer donation, so no donated buffer can be read back",
}


class SanitizeError(RuntimeError):
    """Base class for sanitizer violations."""


class RaceViolation(SanitizeError):
    """Two threads accessed a declared shared field (at least one write)
    with an empty held-lock intersection: the Eraser lockset condition."""


def _parse_modes(raw: Optional[str]) -> frozenset:
    if not raw:
        return frozenset()
    modes = {m.strip() for m in raw.split(",") if m.strip()}
    unknown = modes - set(_VALID_MODES) - set(_REFUSED_MODES)
    if unknown:
        raise ValueError(f"{ENV_VAR} has unknown mode(s) {sorted(unknown)}; valid: {','.join(_VALID_MODES)}")
    refused = sorted(modes & set(_REFUSED_MODES))
    if refused:
        raise ValueError(f"{ENV_VAR} mode(s) not ported: "
                         + "; ".join(f"{m!r} ({_REFUSED_MODES[m]})" for m in refused)
                         + f". valid: {','.join(_VALID_MODES)}")
    return frozenset(modes)


_MODES = _parse_modes(os.environ.get(ENV_VAR))
_RACE_ON = "race" in _MODES  # the hot hooks' one flag test


def refresh() -> frozenset:
    """Re-read ``TRLX_TPU_SANITIZE`` (the factories and the trainer's
    construction call it; tests toggle the environment mid-process)."""
    global _MODES, _RACE_ON
    _MODES = _parse_modes(os.environ.get(ENV_VAR))
    _RACE_ON = "race" in _MODES
    return _MODES


def armed(mode: str) -> bool:
    return mode in _MODES


_TLS = threading.local()


def _held_locks() -> list:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


class TrackedLock:
    """A lock that registers itself in the thread-local held-lock set, so
    ``race_access`` can intersect locksets. Built only when race mode is
    armed: ``make_lock`` returns a plain ``threading.Lock`` otherwise."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def __enter__(self) -> "TrackedLock":
        self._lock.acquire()
        _held_locks().append(self)
        return self

    def __exit__(self, *exc_info) -> bool:
        _held_locks().remove(self)
        self._lock.release()
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held_locks().append(self)
        return ok

    def release(self) -> None:
        _held_locks().remove(self)
        self._lock.release()


class TrackedCondition:
    """The condition variable counterpart of ``TrackedLock`` (the rollout
    producer's ``_cv``). ``wait`` releases the underlying lock, but the
    bookkeeping keeps it in the held set: no access by this thread happens
    while it sleeps, and accesses after the wake hold the lock again."""

    def __init__(self, name: str):
        self.name = name
        self._cond = threading.Condition()

    def __enter__(self) -> "TrackedCondition":
        self._cond.acquire()
        _held_locks().append(self)
        return self

    def __exit__(self, *exc_info) -> bool:
        _held_locks().remove(self)
        self._cond.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


def make_lock(name: str):
    """The race-aware lock factory for shared structures. Unarmed: a plain
    ``threading.Lock``."""
    refresh()
    if _RACE_ON:
        return TrackedLock(name)
    return threading.Lock()


def make_condition(name: str):
    """The race-aware condition factory. Unarmed: a plain
    ``threading.Condition``."""
    refresh()
    if _RACE_ON:
        return TrackedCondition(name)
    return threading.Condition()


# (id(owner), field) -> Eraser state, bounded (oldest evicted).
_RACE_FIELDS: "OrderedDict[Tuple[int, str], Dict[str, Any]]" = OrderedDict()
_RACE_CAP = 8192
_RACE_LOCK = threading.Lock()
# "<owner type>.<field>" of every field two or more threads have touched.
_SHARED = set()
_VIOLATIONS = []  # the message of every RaceViolation raised
_THIS_FILE = os.path.abspath(__file__)


def _race_site(skip: int = 2) -> str:
    """The caller's stack in short: up to 3 frames outside this module."""
    parts = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "<unknown>"
    while f is not None and len(parts) < 3:
        fname = f.f_code.co_filename
        if os.path.abspath(fname) != _THIS_FILE:
            parts.append(f"{os.path.basename(fname)}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
    return " <- ".join(parts) if parts else "<unknown>"


def _lock_names(held) -> Tuple[str, ...]:
    return tuple(sorted(getattr(lock, "name", "?") for lock in held))


def race_access(owner: Any, field: str, write: bool = False) -> None:
    """Record one access to a declared shared field.

    The Eraser lockset state machine: the first thread owns the field
    alone (initialization is forgiven); from the second thread on, the
    candidate lockset is intersected with the locks held at each access.
    When the intersection is empty and the history holds a write,
    ``RaceViolation`` names both sites. One flag test unless armed."""
    if not _RACE_ON:
        return
    ident = threading.get_ident()
    held_locks = _held_locks()
    held = frozenset(id(lock) for lock in held_locks)
    record = (threading.current_thread().name, _race_site(), _lock_names(held_locks), write)
    with _RACE_LOCK:
        key = (id(owner), field)
        st = _RACE_FIELDS.get(key)
        if st is None:
            st = _RACE_FIELDS[key] = {"threads": {ident}, "lockset": None, "written": bool(write),
                                      "last": {ident: record}}
            while len(_RACE_FIELDS) > _RACE_CAP:
                _RACE_FIELDS.popitem(last=False)
            return
        st["written"] = st["written"] or bool(write)
        st["last"][ident] = record
        if ident in st["threads"] and len(st["threads"]) == 1:
            return  # still one thread's alone
        st["threads"].add(ident)
        _SHARED.add(f"{type(owner).__name__}.{field}")
        st["lockset"] = held if st["lockset"] is None else (st["lockset"] & held)
        if st["lockset"] or not st["written"]:
            return
        other = next((rec for tid, rec in sorted(st["last"].items(), key=lambda kv: kv[1][3], reverse=True)
                      if tid != ident), None)
        # Back to the current thread alone: one bug raises once per pair of
        # accesses, not at every later access.
        _RACE_FIELDS[key] = {"threads": {ident}, "lockset": None, "written": bool(write), "last": {ident: record}}
    tname, site, locks, _ = record
    o_tname, o_site, o_locks, o_write = other if other else ("?", "?", (), False)
    message = (
        f"field {field!r} of {type(owner).__name__} accessed with an empty lockset intersection: "
        f"{'write' if write else 'read'} at [{site}] on thread {tname!r} holding {list(locks)!r} conflicts with "
        f"{'write' if o_write else 'read'} at [{o_site}] on thread {o_tname!r} holding {list(o_locks)!r} — hold "
        "one common lock at both sites, hand the value off through a queue or an event, or mark the ownership "
        "transfer with sanitize.race_forget()")
    with _RACE_LOCK:
        _VIOLATIONS.append(message)
    raise RaceViolation(message)


def race_forget(owner: Any) -> None:
    """Drop the race history of every field of ``owner``: the
    happens-before edge the lockset model cannot see (after joining a
    worker thread, at a versioned weight handoff). A no-op unless armed."""
    if not _RACE_ON:
        return
    oid = id(owner)
    with _RACE_LOCK:
        for key in [k for k in _RACE_FIELDS if k[0] == oid]:
            del _RACE_FIELDS[key]


def shared_fields() -> list:
    """``"<owner type>.<field>"`` of every tracked field that two or more
    threads touched since the last ``clear_races()``, sorted."""
    with _RACE_LOCK:
        return sorted(_SHARED)


def violations() -> list:
    """The message of every ``RaceViolation`` raised since the last
    ``clear_races()``."""
    with _RACE_LOCK:
        return list(_VIOLATIONS)


def clear_races() -> None:
    """Drop every race record (tests, and a run's start)."""
    with _RACE_LOCK:
        _RACE_FIELDS.clear()
        _SHARED.clear()
        _VIOLATIONS.clear()
