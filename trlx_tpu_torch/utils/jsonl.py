"""Torn-tail-tolerant JSONL reading and appending (the counterpart of
``trlx_tpu.utils.jsonl``), shared by ``metrics.jsonl`` (``utils.logging``),
``spans.jsonl`` (``observability.spans``) and ``lineage.jsonl``
(``observability.health``).

- Append side: the file is opened unbuffered in O_APPEND mode and each
  record lands as ONE ``write(2)``, so a killed process can tear at most the
  final line, and concurrent appenders never interleave mid-record.
- Read side: a truncated trailing record is dropped with a warning; a
  malformed line in the middle of the file is real corruption and raises.
"""

import json
import os
import warnings
from typing import Any, Dict, List


def read_jsonl(path: str) -> List[Any]:
    """Read a JSONL file written by the line-atomic appenders, tolerating a
    torn final line (and only the final line)."""
    records = []
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if b"".join(lines[i + 1:]).strip():
                raise
            warnings.warn(f"{path}: dropped torn final record ({len(line)} bytes) — the writer was killed "
                          "mid-append", stacklevel=2)
            break
    return records


def open_line_atomic(path: str):
    """Open ``path`` for line-atomic appends: O_APPEND and unbuffered, so each
    ``write_record`` is one ``write(2)``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    return open(path, "ab", buffering=0)


def write_record(f, record: Dict[str, Any]) -> None:
    """Serialize ``record`` and append it as one write call."""
    f.write((json.dumps(record) + "\n").encode("utf-8"))


def append_record(path: str, record: Dict[str, Any]) -> None:
    """One-shot line-atomic append for low-rate streams (lineage.jsonl)."""
    with open(path, "ab", buffering=0) as f:
        write_record(f, record)
