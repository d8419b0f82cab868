"""Checkpoint hardening (the port's own copy of
``trlx_tpu.resilience.checkpoint``): atomic pointer writes, manifests,
retention, GC.

A preempted VM can die mid-write; a half-written ``latest.txt`` or a
truncated state file must never brick the resume. Invariants enforced here:

- every sidecar (``latest.txt``, ``*.host.json``, ``*.manifest.json``) is
  written to a temp file and ``os.replace``d — readers see the old or the
  new content, never a prefix;
- each checkpoint directory gets a manifest recording its step, every file's
  size + crc32, and the framework version that wrote it; ``load()``
  (trainer/base.py) verifies the manifest before reading any file and falls
  back to the previous intact checkpoint on mismatch;
- ``train.keep_checkpoints=N`` garbage-collects all but the N newest
  ``state_*`` directories (the one ``latest.txt`` points at is always kept).

``DigestWriter`` computes a file's (size, crc32) while it is written, so a
manifest needs no second read of what was just written.
"""

import contextlib
import json
import os
import re
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple

MANIFEST_VERSION = 1
_STATE_RE = re.compile(r"^state_(\d+)$")


class CheckpointError(RuntimeError):
    """No restorable checkpoint: missing/corrupt data with no intact
    fallback. The message lists every candidate tried and why it failed."""


# --------------------------------------------------------------- atomic I/O


def atomic_write_text(path: str, text: str):
    """Write-then-rename so a crash mid-write leaves the old file intact
    (POSIX rename atomicity; ``os.replace`` is the portable spelling)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj):
    atomic_write_text(path, json.dumps(obj))


# ---------------------------------------------------------------- manifests


class DigestWriter:
    """A binary file opened for writing that keeps the (size, crc32) of
    every byte written through it: the manifest entry of the file, without
    reading it back. ``torch.save`` writes sequentially, so the running crc
    is the file's. Each buffer's crc runs on a helper thread while the file
    write runs (both release the interpreter lock), so it costs the write
    no time where the disk is the slower of the two."""

    def __init__(self, path: str):
        self._file = open(path, "wb")
        self._crc_thread = ThreadPoolExecutor(1, thread_name_prefix="trlx-ckpt-crc")
        self.size, self.crc = 0, 0
        self.crc_wait_s = 0.0  # seconds the writes waited for their crc after the write

    def write(self, data) -> int:
        view = memoryview(data).cast("B")
        crc = self._crc_thread.submit(zlib.crc32, view, self.crc)
        n = self._file.write(view)
        t0 = time.perf_counter()
        self.crc = crc.result()
        self.crc_wait_s += time.perf_counter() - t0
        self.size += view.nbytes
        return n

    def flush(self):
        self._file.flush()

    def close(self, sync: bool = True):
        """Flush, fsync (the data must be durable before ``latest.txt``
        names it) and close."""
        self._crc_thread.shutdown()
        self._file.flush()
        if sync:
            os.fsync(self._file.fileno())
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._file.closed:
            self.close(sync=exc[0] is None)


def _file_digest(path: str) -> Tuple[int, int]:
    """(size, crc32) streamed in 1 MiB chunks — no full-file buffering."""
    size, crc = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            crc = zlib.crc32(chunk, crc)
    return size, crc


def manifest_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"{name}.manifest.json")


def build_manifest(ckpt_path: str, step: int, digests: Optional[Dict[str, Tuple[int, int]]] = None) -> Dict:
    """The manifest of the checkpoint directory ``ckpt_path``. ``digests``
    gives (size, crc32) by relative path for files whose digest was taken
    while they were written (``DigestWriter``); every other file is read."""
    import torch

    digests = digests or {}
    files = {}
    for root, _, fnames in os.walk(ckpt_path):
        for fname in fnames:
            full = os.path.join(root, fname)
            rel = os.path.relpath(full, ckpt_path)
            size, crc = digests[rel] if rel in digests else _file_digest(full)
            files[rel] = {"size": size, "crc32": crc}
    return {
        "manifest_version": MANIFEST_VERSION,
        "name": os.path.basename(ckpt_path),
        "step": int(step),
        "versions": {"torch": torch.__version__},
        "files": files,
    }


def write_manifest(directory: str, name: str, step: int,
                   digests: Optional[Dict[str, Tuple[int, int]]] = None) -> Dict:
    manifest = build_manifest(os.path.join(directory, name), step, digests)
    atomic_write_json(manifest_path(directory, name), manifest)
    return manifest


def verify_checkpoint(directory: str, name: str) -> Tuple[bool, str]:
    """Check a checkpoint directory against its manifest.

    Returns ``(ok, reason)``. A checkpoint with NO manifest (whose manifest
    write itself was interrupted) passes with a note — reading the state
    files remains the last line of defense for those; manifest-recorded
    checkpoints fail hard on any missing / resized / checksum-mismatched
    file (the truncation signature of a mid-write crash)."""
    path = os.path.join(directory, name)
    if not os.path.isdir(path):
        return False, "checkpoint directory missing"
    mpath = manifest_path(directory, name)
    if not os.path.exists(mpath):
        return True, "no manifest (pre-manifest checkpoint; unverified)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"unreadable manifest: {e}"
    files = manifest.get("files", {})
    # Every file's size before any checksum: a truncated file fails without
    # reading the others.
    for rel, expect in files.items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            return False, f"missing file {rel}"
        size = os.path.getsize(full)
        if size != expect["size"]:
            return False, f"{rel}: size {size} != manifest {expect['size']} (truncated?)"
    for rel, expect in files.items():
        size, crc = _file_digest(os.path.join(path, rel))
        if size != expect["size"]:
            return False, f"{rel}: size {size} != manifest {expect['size']} (truncated?)"
        if crc != expect["crc32"]:
            return False, f"{rel}: crc32 mismatch (corrupted)"
    return True, "manifest verified"


# ------------------------------------------------------ discovery / retention


def checkpoint_step(name: str) -> Optional[int]:
    m = _STATE_RE.match(os.path.basename(name))
    return int(m.group(1)) if m else None


def list_checkpoints(directory: str) -> List[str]:
    """``state_*`` directory names under `directory`, newest step first."""
    if not os.path.isdir(directory):
        return []
    found = []
    for entry in os.listdir(directory):
        step = checkpoint_step(entry)
        if step is not None and os.path.isdir(os.path.join(directory, entry)):
            found.append((step, entry))
    return [name for _, name in sorted(found, reverse=True)]


def _remove_checkpoint(directory: str, name: str):
    shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for entry in os.listdir(directory) if os.path.isdir(directory) else ():
        if entry in (f"{name}.host.json", f"{name}.manifest.json") or entry.startswith(f"{name}.inuse."):
            try:
                os.remove(os.path.join(directory, entry))
            except FileNotFoundError:
                pass


# How long a reader's .inuse marker shields its checkpoint from GC. Markers
# are removed on clean exit; the age cap keeps one killed reader from
# pinning a checkpoint forever.
IN_USE_MAX_AGE = 3600.0


@contextlib.contextmanager
def mark_in_use(directory: str, name: str):
    """Shield `name` from retention GC while a resume verifies/restores it.

    A concurrent writer (another process finalizing its own save into the
    same directory) must not delete the checkpoint a reader is mid-restore
    on. File-based so it works ACROSS processes on a shared filesystem."""
    marker = os.path.join(directory, f"{name}.inuse.{os.getpid()}")
    try:
        atomic_write_json(marker, {"pid": os.getpid(), "t": time.time()})
    except OSError:
        marker = None  # read-only fs: unprotected
    try:
        yield
    finally:
        if marker is not None:
            try:
                os.remove(marker)
            except FileNotFoundError:
                pass


def _names_in_use(directory: str) -> set:
    names = set()
    now = time.time()
    for entry in os.listdir(directory) if os.path.isdir(directory) else ():
        m = re.match(r"^(state_\d+)\.inuse\.\d+$", entry)
        if not m:
            continue
        try:
            if now - os.path.getmtime(os.path.join(directory, entry)) <= IN_USE_MAX_AGE:
                names.add(m.group(1))
        except OSError:
            continue
    return names


def latest_pointer(directory: str) -> Optional[str]:
    """The checkpoint name ``latest.txt`` currently points at, or None."""
    try:
        with open(os.path.join(directory, "latest.txt")) as f:
            content = f.read().strip()
        return os.path.basename(content) if content else None
    except OSError:
        return None


def gc_checkpoints(directory: str, keep: int, protect: Iterable[str] = ()) -> List[str]:
    """Delete all but the `keep` newest checkpoints (plus `protect`d names).

    Never removed, regardless of age: the checkpoint ``latest.txt`` points
    at, and any checkpoint with a fresh ``.inuse`` marker (a concurrent
    resume is reading it, `mark_in_use`). ``keep <= 0`` disables GC
    entirely (the default — retention is opt-in). Returns the removed
    names."""
    if keep <= 0:
        return []
    protected = {os.path.basename(p) for p in protect}
    latest = latest_pointer(directory)
    if latest is not None:
        protected.add(latest)
    protected |= _names_in_use(directory)
    removed = []
    for name in list_checkpoints(directory)[keep:]:
        if name in protected:
            continue
        _remove_checkpoint(directory, name)
        removed.append(name)
    return removed


# ------------------------------------------------------------ fault support


def corrupt_checkpoint(directory: str, name: str) -> Optional[str]:
    """Truncate the largest file of a checkpoint to half its size — the
    on-disk signature of a VM dying mid-write. Fault injection only (the
    tests); returns the relpath truncated."""
    path = os.path.join(directory, name)
    largest, largest_size = None, -1
    for root, _, fnames in os.walk(path):
        for fname in fnames:
            full = os.path.join(root, fname)
            size = os.path.getsize(full)
            if size > largest_size:
                largest, largest_size = full, size
    if largest is None:
        return None
    with open(largest, "r+b") as f:
        f.truncate(largest_size // 2)
    return os.path.relpath(largest, path)
