"""Crash-safe artifact writes.

The counterpart of ``atomic_write_text`` / ``atomic_write_json`` in the
JAX package's ``qsm_tpu/resilience/checkpoint.py`` (its ``CellJournal``
is not ported yet): the temporary file lives in the target's directory,
is flushed and synced, then renamed over the target, so a reader never
sees a half-written document and a killed writer never destroys the
previous version.  The steering loop's checkpoints go through these.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def atomic_write_text(path: str, text: str) -> None:
    """Write whole, then rename: crash-safe at every instant.  The
    temporary file sits beside the target so the rename never crosses a
    filesystem; fsync comes before the rename so the rename cannot land
    before the data."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj, indent: Optional[int] = None) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")
