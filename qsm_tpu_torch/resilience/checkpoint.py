"""Crash-safe artifact writes and resumable scan journals.

The counterpart of the JAX package's ``qsm_tpu/resilience/checkpoint.py``:

* :func:`atomic_write_text` / :func:`atomic_write_json`: the temporary
  file lives in the target's directory, is flushed and synced, then
  renamed over the target, so a reader never sees a half-written document
  and a killed writer never destroys the previous version.  The steering
  loop's checkpoints and the verdict cache's compactions go through them;
* :class:`CellJournal`: a resumable JSONL artifact, one header line and
  one row a completed cell, rewritten atomically on every emit.
  ``resume=True`` adopts the completed rows of a compatible earlier file,
  so that the caller skips their cells; a ``skipped`` marker is not a
  completion.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple


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


class CellJournal:
    """One header and one JSON line a completed cell, atomic at every
    emit.

    ``header`` names the scan.  With ``resume=True`` an earlier file at
    ``path`` is adopted iff its header agrees on ``match_keys`` (by
    default the artifact's name and its device provenance: a scan on the
    host must never stand in for a scan on the card).  An earlier file
    that does not agree is moved aside to ``<path>.pre-resume``, never
    overwritten.  The header gains ``resumed_cells``, so the artifact
    says what this run measured and what it inherited.  A truncated
    trailing line (a writer killed mid-line) is dropped: its cell runs
    again."""

    def __init__(self, path: str, header: Dict, resume: bool = False,
                 match_keys: Sequence[str] = ("artifact",
                                              "device_fallback")):
        self.path = path
        self._rows: List[Dict] = []
        self._done: Dict[str, Dict] = {}
        self.resumed_cells = 0
        if resume:
            prev_header, prev_rows = self._load(path)
            if prev_header is not None and all(
                    prev_header.get(k) == header.get(k)
                    for k in match_keys):
                for r in prev_rows:
                    key = r.get("cell")
                    if key and "skipped" not in r:
                        self._done[key] = r
                        self._rows.append(r)
                self.resumed_cells = len(self._done)
            elif prev_header is not None:
                # an incompatible earlier artifact: adopt nothing, but keep
                # it (the first flush below would destroy the one copy)
                try:
                    os.replace(path, f"{path}.pre-resume")
                except OSError:
                    pass
        self.header = {**header, "resumed_cells": self.resumed_cells}
        self._flush()

    @staticmethod
    def _load(path: str) -> Tuple[Optional[Dict], List[Dict]]:
        try:
            with open(path) as f:
                raw = f.read().splitlines()
        except OSError:
            return None, []
        docs = []
        for ln in raw:
            if not ln.strip():
                continue
            try:
                docs.append(json.loads(ln))
            except ValueError:
                break  # truncated or garbled: trust nothing from here on
        if not docs:
            return None, []
        return docs[0], docs[1:]

    def complete(self, key: str) -> Optional[Dict]:
        """The banked row of ``key`` (this run's or a resumed one), or
        None while the cell still needs running."""
        return self._done.get(key)

    def emit(self, key: str, row: Dict) -> Dict:
        """Bank one cell's row (stamped with its key) atomically."""
        row = {"cell": key, **row}
        self._rows.append(row)
        if "skipped" not in row:
            self._done[key] = row
        self._flush()
        return row

    def rows(self) -> List[Dict]:
        """The header and every row, in file order."""
        return [self.header] + list(self._rows)

    def _flush(self) -> None:
        atomic_write_text(
            self.path,
            "\n".join(json.dumps(x) for x in self.rows()) + "\n")
