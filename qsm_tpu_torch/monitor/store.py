"""Durable session substrate — snapshot + bounded journal per session.

The durability contract (docs/MONITOR.md "Durability"): a
monitor session's resumable state splits into two planes with two
different owners —

* the DECIDED PREFIX lives in the serve verdict cache as banked prefix
  rows (monitor/frontier.py ``_bank_put``), which ride the replog's
  segments and therefore its anti-entropy / gossip / subsumption
  machinery for free.  This file never duplicates them;
* the SESSION-LOCAL remainder — open window, frontier state set, hash
  chain state, reorder buffer, seq counter — is one JSON doc
  (``MonitorSession.to_doc``) small in the WINDOW, not the stream.
  That doc plus a bounded tail journal of raw event batches is what
  :class:`SessionStore` keeps, one file per session.

File format (``<root>/<sid>.jsonl``):

* exactly one ``{"kind": "snap", "doc": {...}}`` line (the file is
  atomically REWRITTEN at snapshot time — resilience/checkpoint.py
  ``atomic_write_text`` — so a crash mid-compaction leaves the old
  file, never a torn one);
* zero or more ``{"kind": "ev", "seq": n, "events": [...]}`` lines
  appended after it (append + flush per batch; a torn TRAILING line —
  the only kind a crash can produce — is dropped at load, exactly the
  CellJournal discipline).

**Resume = deserialize, not replay.**  ``load`` hands back the
snapshot doc (``MonitorSession.from_doc`` rebuilds the session in
O(doc) with ZERO engine folds) plus the tail batches, which re-apply
through the normal seq-idempotent ``append`` path; any cut they commit
lands on the already-banked prefix rows (``prefix_hits``), so a node
restart or ring move costs bank lookups, never ``_end_states`` folds
(the durable-resume pin makes the fold unreachable to prove it).

**Compaction.**  When a session's tail grows past ``snap_every``
batches, the owner rewrites the snapshot from the live session and the
tail resets — the file stays O(window + snap_every · batch), never
O(stream).

Thread-safety: one session's appends are serialized by its own
``session.lock`` (the caller holds it); the store's own lock only
guards the cross-session tail-length map and directory scans.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..resilience.checkpoint import atomic_write_text

# journal tail batches a session may accumulate before its owner
# should re-snapshot (MonitorSession.append does this automatically)
DEFAULT_SNAP_EVERY = 64

_SUFFIX = ".session.jsonl"


class SessionStore:
    """One directory of per-session snapshot+journal files (module
    docstring).  sids are sanitized into filenames; anything a sid
    could contain that the filesystem couldn't is hex-escaped, so no
    sid ever escapes ``root`` or collides with another."""

    def __init__(self, root: str, *, snap_every: int = DEFAULT_SNAP_EVERY):
        self.root = str(root)
        self.snap_every = max(1, int(snap_every))
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._tail: Dict[str, int] = {}   # sid -> ev lines since snap

    # -- naming --------------------------------------------------------
    @staticmethod
    def _fname(sid: str) -> str:
        safe = "".join(
            c if c.isalnum() or c in "-_" else f"%{ord(c):02x}"
            for c in str(sid))
        return safe + _SUFFIX

    def path_of(self, sid: str) -> str:
        return os.path.join(self.root, self._fname(sid))

    # -- writes --------------------------------------------------------
    def snapshot(self, sid: str, doc: dict) -> None:
        """(Re)write ``sid``'s file as one fresh snapshot line — the
        compaction step; every journaled batch so far is now inside
        the doc, so the tail resets."""
        atomic_write_text(
            self.path_of(sid),
            json.dumps({"kind": "snap", "doc": doc},
                       separators=(",", ":")) + "\n")
        with self._lock:
            self._tail[sid] = 0

    def append_events(self, sid: str, seq: int, events: list) -> None:
        """Journal one applied batch (its first event's stream index is
        ``seq`` — replay re-appends with it, so overlap is idempotent).
        Append + flush: a crash tears at most the trailing line, which
        ``load`` drops."""
        line = json.dumps({"kind": "ev", "seq": int(seq),
                           "events": events},
                          separators=(",", ":")) + "\n"
        with open(self.path_of(sid), "a") as f:
            f.write(line)
            f.flush()
        with self._lock:
            self._tail[sid] = self._tail.get(sid, 0) + 1

    def drop(self, sid: str) -> None:
        """Forget a session (closed sessions answer their verdict and
        leave nothing to resume)."""
        try:
            os.remove(self.path_of(sid))
        except OSError:
            pass
        with self._lock:
            self._tail.pop(sid, None)

    # -- reads ---------------------------------------------------------
    def tail_len(self, sid: str) -> int:
        with self._lock:
            return self._tail.get(sid, 0)

    def load(self, sid: str) -> Optional[Tuple[dict, List[dict]]]:
        """``(snapshot_doc, tail_batches)`` for ``sid``, or None when
        nothing durable exists.  Garbled files (foreign bytes, no snap
        line) read as absent — durability must never wedge an open; a
        torn trailing line is dropped silently (crash mid-append)."""
        try:
            with open(self.path_of(sid)) as f:
                lines = f.read().splitlines()
        except OSError:
            return None
        doc: Optional[dict] = None
        tail: List[dict] = []
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    continue              # torn trailing line: expected
                return None               # mid-file garble: foreign file
            if not isinstance(rec, dict):
                return None
            if rec.get("kind") == "snap":
                doc = rec.get("doc")
                tail = []                 # batches before a snap are in it
            elif rec.get("kind") == "ev":
                tail.append(rec)
            else:
                return None
        if not isinstance(doc, dict):
            return None
        with self._lock:
            self._tail[sid] = len(tail)
        return doc, tail

    def list_sids(self) -> List[str]:
        """Every sid with a durable file (restart recovery sweeps)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in sorted(names):
            if not name.endswith(_SUFFIX):
                continue
            stem = name[:-len(_SUFFIX)]
            # invert the filename escaping
            sid, i = [], 0
            while i < len(stem):
                if stem[i] == "%" and i + 2 < len(stem) + 1:
                    try:
                        sid.append(chr(int(stem[i + 1:i + 3], 16)))
                        i += 3
                        continue
                    except ValueError:
                        pass
                sid.append(stem[i])
                i += 1
            out.append("".join(sid))
        return out

    def stats(self) -> dict:
        with self._lock:
            tails = dict(self._tail)
        try:
            files = [n for n in os.listdir(self.root)
                     if n.endswith(_SUFFIX)]
        except OSError:
            files = []
        return {"root": self.root, "files": len(files),
                "snap_every": self.snap_every,
                "tail_batches": sum(tails.values())}
