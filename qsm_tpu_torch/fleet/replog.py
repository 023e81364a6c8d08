"""Segmented, replicated verdict log — the fleet's durable memory.

The counterpart of the JAX package's ``qsm_tpu/fleet/replog.py``, with
its on-disk format (segment names, fingerprints, artifact tags), so that
either package reads the other's bank.

The single-file append bank (serve/cache.py) is exactly right for one
node and exactly wrong for a fleet: catch-up would mean shipping (and
rewriting) the whole bank, and two nodes could never exchange "what do
you have that I don't" cheaper than O(everything).  This module
generalizes the bank into SEGMENTS — the unit of durability, identity
and replication:

* **Banking** stays an O(batch) fsync'd append, now into an ``active``
  segment; at ``seal_rows`` rows the active segment SEALS into an
  immutable file whose name carries its origin node, its local
  sequence number, and a **content fingerprint** (sha256 over the row
  lines).  A sealed segment never changes, so its fingerprint IS its
  identity fleet-wide.
* **Anti-entropy** is a digest exchange over that identity: a node
  answers :meth:`digests` (name → fingerprint of every sealed segment
  it holds or has absorbed), a peer diffs with :meth:`missing`, pulls
  whole segments with :meth:`read_segment` and adopts them with
  :meth:`adopt` — fingerprint-verified, atomic, idempotent.  A joining
  or restarted node catches up to the fleet's live verdict set without
  any node rewriting anything.
* **Torn tails stay local.**  Only the ACTIVE segment can tear (a
  SIGKILL mid-append); the loader detects a tail that does not end on
  a clean parseable line, TRUNCATES it in place (atomic rewrite) and
  never replays the torn row as a verdict.  Sealed segments are
  verified against their fingerprint on load — a corrupt one is moved
  aside ``.quarantine``, never adopted, never served.
* **Compaction absorbs, never forgets — boundedly.**  When the row
  count outgrows the live set, every segment folds into one fresh
  local segment holding the post-merge (later-row-wins) live entries —
  and the absorbed segments' names+fingerprints are recorded in
  ``absorbed.json`` so the anti-entropy diff does not re-pull what
  compaction just deduplicated.  The record is HARD-CAPPED
  (``absorbed_cap``, fold-forward: oldest names drop first), so a
  100-compaction lifetime stays O(cap) on disk — safe to forget
  because row-level subsumption (below) protects anything the record
  no longer lists.
* **Row-level subsumption**: a compacted segment is a NEW
  identity holding rows its peers may all hold already.  Before a
  segment ships, the would-be receiver checks the segment's row-key
  coverage (:meth:`row_keys` on the owner, the ``replog.covers`` /
  ``replog.subsumed`` wire ops) against its OWN live set; full
  coverage records the name as *subsumed* (:meth:`note_subsumed` —
  capped like the absorbed record) and the rows never cross the wire.
  Catch-up cost per compaction drops from one full-live-set ship per
  peer to one key-list exchange.

Verdicts are pure functions of (spec, history) — fingerprint-keyed
rows from different nodes can only agree on the verdict — so adoption
order across nodes is free; later-row-wins matters only within a
node's own sequence (witness refreshes), which local seq order
preserves.  Consumed by :class:`~qsm_tpu_torch.serve.cache.VerdictCache`
via its ``store`` parameter, by the device-work queue
(``devq/queue.py``), and by the server's ``replog.*`` ops
(``serve/server.py``), the surface a fleet's anti-entropy reconciles
through.  
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

ACTIVE_NAME = "active.jsonl"
ABSORBED_NAME = "absorbed.json"
_SEG_ARTIFACT = "qsm_tpu_replog_seg"
_ACTIVE_ARTIFACT = "qsm_tpu_replog_active"
_ABSORBED_ARTIFACT = "qsm_tpu_replog_absorbed"
_VERSION = 1
# seg-<node>-<seq>-<fp12>.jsonl — lexicographic sort groups a node's
# segments in sequence order (seq is zero-padded)
_SEG_RE = re.compile(r"^seg-(?P<node>[A-Za-z0-9_.]+)-(?P<seq>\d{6})"
                     r"-(?P<fp>[0-9a-f]{12})\.jsonl$")


def segment_fingerprint(lines: List[str]) -> str:
    """Content identity of a segment: sha256 over its row lines (one
    per row, newline-joined — byte-stable however the file is framed)."""
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


class SegmentedLog:
    """See module docstring.  Implements the VerdictCache ``store``
    contract (``load`` / ``append`` / ``compact`` / ``total_rows``)
    plus the anti-entropy surface (``digests`` / ``missing`` /
    ``read_segment`` / ``adopt``).  Thread-safe: the cache flushes
    under its own lock while anti-entropy ops arrive on server
    connection threads."""

    def __init__(self, dir: str, node_id: str = "n0",
                 seal_rows: int = 256, absorbed_cap: int = 64):
        self.dir = dir
        self.node_id = str(node_id)
        self.seal_rows = max(1, int(seal_rows))
        # hard bound on the absorbed AND subsumed records (fold-forward
        # semantics: oldest names drop first; row-level subsumption
        # protects anything forgotten)
        self.absorbed_cap = max(1, int(absorbed_cap))
        self._lock = threading.RLock()
        self._active_rows = 0        # data rows in the active segment
        self._active_clean = False   # file exists and ends on a clean line
        self._sealed: Dict[str, str] = {}    # name -> fingerprint
        self._absorbed: Dict[str, str] = {}  # compacted-away name -> fp
        self._subsumed: Dict[str, str] = {}  # coverage-skipped name -> fp
        self._next_seq = 1
        self.truncated_tails = 0     # torn active tails dropped on load
        self.quarantined_segments = 0  # fingerprint-mismatch segs set aside
        self.seals = 0
        self.adoptions = 0
        self.subsumptions = 0        # ships skipped: rows already held
        os.makedirs(dir, exist_ok=True)
        self._scan()

    # -- paths ---------------------------------------------------------
    def _seg_path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @property
    def _active_path(self) -> str:
        return os.path.join(self.dir, ACTIVE_NAME)

    # -- startup scan --------------------------------------------------
    def _scan(self) -> None:
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            names = []
        local_seqs = [0]
        for name in names:
            m = _SEG_RE.match(name)
            if m is None:
                continue
            self._sealed[name] = self._verify_or_quarantine(name, m)
            if m.group("node") == self.node_id:
                local_seqs.append(int(m.group("seq")))
        self._sealed = {k: v for k, v in self._sealed.items()
                        if v is not None}
        ab, sub, next_seq = self._read_absorbed()
        self._absorbed = ab
        self._subsumed = sub
        for name in list(ab) + list(sub):
            m = _SEG_RE.match(name)
            if m is not None and m.group("node") == self.node_id:
                local_seqs.append(int(m.group("seq")))
        # the persisted high-water seq survives the capped absorbed
        # record forgetting old local names — a reused (seq, fp) name
        # colliding with a copy a peer still holds must stay impossible
        self._next_seq = max(max(local_seqs) + 1, next_seq)
        self._load_active_counts()

    def _verify_or_quarantine(self, name: str, m) -> Optional[str]:
        """The sealed segment's fingerprint, or None after setting a
        corrupt file aside (a bad replica must never be served OR
        offered to peers — quarantining it also makes the anti-entropy
        diff re-pull a good copy)."""
        try:
            _header, lines = self._read_lines(self._seg_path(name))
        except (OSError, ValueError):
            lines = None
        if (lines is not None
                and segment_fingerprint(lines)[:12] == m.group("fp")):
            return m.group("fp")
        try:
            os.replace(self._seg_path(name),
                       self._seg_path(name) + ".quarantine")
        except OSError:
            pass
        self.quarantined_segments += 1
        return None

    @staticmethod
    def _read_lines(path: str) -> Tuple[dict, List[str]]:
        with open(path) as f:
            text = f.read()
        raw = [ln for ln in text.splitlines() if ln.strip()]
        if not raw:
            return {}, []
        header = json.loads(raw[0])
        return header, raw[1:]

    def _load_active_counts(self) -> None:
        """Count the active segment's clean rows.  A GARBLED tail (the
        SIGKILL landed mid-append) is TRUNCATED on the spot — the torn
        row is never replayed as a verdict, and never left where the
        next append would weld onto it.  A final line that parses but
        lacks its newline is content-complete: kept, but the file is
        rewritten so the boundary is clean again."""
        path = self._active_path
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            self._active_rows = 0
            self._active_clean = False
            return
        clean: List[str] = []
        torn = False
        for ln in text.splitlines():
            if not ln.strip():
                continue
            try:
                json.loads(ln)
            except ValueError:
                torn = True
                break  # trust nothing at or past the tear
            clean.append(ln)
        if torn or (clean and not text.endswith("\n")):
            from ..resilience.checkpoint import atomic_write_text

            if torn:
                self.truncated_tails += 1
            if clean:
                atomic_write_text(path, "\n".join(clean) + "\n")
            else:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        have_header = bool(clean) and clean[0].startswith(
            '{"artifact"')
        self._active_rows = max(0, len(clean) - 1) if have_header \
            else len(clean)
        self._active_clean = bool(clean)

    def _read_absorbed(self) -> Tuple[Dict[str, str], Dict[str, str], int]:
        try:
            with open(os.path.join(self.dir, ABSORBED_NAME)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}, {}, 1
        if doc.get("artifact") != _ABSORBED_ARTIFACT:
            return {}, {}, 1
        names = doc.get("names")
        sub = doc.get("subsumed")
        try:
            next_seq = max(1, int(doc.get("next_seq", 1)))
        except (TypeError, ValueError):
            next_seq = 1
        return (dict(names) if isinstance(names, dict) else {},
                dict(sub) if isinstance(sub, dict) else {},
                next_seq)

    def _cap_record(self, record: Dict[str, str]) -> Dict[str, str]:
        """Fold-forward: keep only the NEWEST ``absorbed_cap`` entries
        (dict insertion order = record order).  Forgotten names stay
        safe — the next offer of one is caught by the row-level
        subsumption check against the live set, which is exactly what
        covered the name when it entered this record."""
        while len(record) > self.absorbed_cap:
            record.pop(next(iter(record)))
        return record

    def _write_absorbed(self) -> None:
        from ..resilience.checkpoint import atomic_write_json

        atomic_write_json(
            os.path.join(self.dir, ABSORBED_NAME),
            {"artifact": _ABSORBED_ARTIFACT, "version": _VERSION,
             # NOT sorted: insertion order is the fold-forward order
             "names": dict(self._absorbed),
             "subsumed": dict(self._subsumed),
             "next_seq": self._next_seq})

    # -- the VerdictCache store contract -------------------------------
    @property
    def total_rows(self) -> int:
        with self._lock:
            return (self._active_rows
                    + sum(self._seg_rows(n) for n in self._sealed))

    def _seg_rows(self, name: str) -> int:
        cache = getattr(self, "_row_counts", None)
        if cache is None:
            cache = self._row_counts = {}
        n = cache.get(name)
        if n is None:
            try:
                _h, lines = self._read_lines(self._seg_path(name))
                n = len(lines)
            except (OSError, ValueError):
                n = 0
            cache[name] = n
        return n

    def load(self) -> List[dict]:
        """Every banked row in merge order: sealed segments (sorted by
        name — a node's own segments ride in sequence order) then the
        active segment.  Later rows supersede earlier ones exactly like
        the single-file bank's load."""
        with self._lock:
            rows: List[dict] = []
            for name in sorted(self._sealed):
                try:
                    _h, lines = self._read_lines(self._seg_path(name))
                except (OSError, ValueError):
                    continue
                rows.extend(self._parse_rows(lines))
            try:
                _h, lines = self._read_lines(self._active_path)
            except (OSError, ValueError):
                lines = []
            rows.extend(self._parse_rows(lines))
            return rows

    @staticmethod
    def _parse_rows(lines: List[str]) -> List[dict]:
        out = []
        for ln in lines:
            try:
                doc = json.loads(ln)
            except ValueError:
                continue
            if isinstance(doc, dict) and "key" in doc:
                out.append(doc)
        return out

    def append(self, lines: List[str]) -> None:
        """One fsync'd append of pre-serialized row lines into the
        active segment; seals it when full.  O(batch), like the bank."""
        if not lines:
            return
        with self._lock:
            header_line = None
            if not self._active_clean:
                header_line = json.dumps(
                    {"artifact": _ACTIVE_ARTIFACT, "version": _VERSION,
                     "node": self.node_id})
            with open(self._active_path, "a") as f:
                body = "\n".join(lines) + "\n"
                if header_line is not None:
                    body = header_line + "\n" + body
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            self._active_clean = True
            self._active_rows += len(lines)
            if self._active_rows >= self.seal_rows:
                self._seal_locked()

    def _seal_locked(self) -> None:
        try:
            _h, lines = self._read_lines(self._active_path)
        except (OSError, ValueError):
            return
        if not lines:
            return
        fp = segment_fingerprint(lines)
        name = f"seg-{self.node_id}-{self._next_seq:06d}-{fp[:12]}.jsonl"
        self._write_segment(name, fp, lines)
        self._sealed[name] = fp[:12]
        self._next_seq += 1
        self.seals += 1
        try:
            os.unlink(self._active_path)
        except OSError:
            pass
        self._active_rows = 0
        self._active_clean = False

    def _write_segment(self, name: str, fp: str, lines: List[str]) -> None:
        from ..resilience.checkpoint import atomic_write_text

        header = json.dumps({"artifact": _SEG_ARTIFACT,
                             "version": _VERSION, "rows": len(lines),
                             "fingerprint": fp})
        atomic_write_text(self._seg_path(name),
                          "\n".join([header] + lines) + "\n")
        rc = getattr(self, "_row_counts", None)
        if rc is not None:
            rc[name] = len(lines)

    def compact(self, lines: List[str]) -> None:
        """Fold everything into ONE fresh local segment holding the
        caller's post-merge live rows; absorbed segment names are
        REMEMBERED (capped, fold-forward — :meth:`_cap_record`) so the
        anti-entropy diff never re-pulls them."""
        with self._lock:
            fp = segment_fingerprint(lines)
            name = (f"seg-{self.node_id}-{self._next_seq:06d}"
                    f"-{fp[:12]}.jsonl")
            self._write_segment(name, fp, lines)
            self._next_seq += 1
            for old, old_fp in list(self._sealed.items()):
                # re-inserted at the record's newest end either way:
                # this compaction is the entry's newest coverage proof
                self._absorbed.pop(old, None)
                self._absorbed[old] = old_fp
                try:
                    os.unlink(self._seg_path(old))
                except OSError:
                    pass
            # a name both subsumed and now absorbed needs one record
            for old in list(self._subsumed):
                if old in self._absorbed:
                    self._subsumed.pop(old)
            self._cap_record(self._absorbed)
            self._cap_record(self._subsumed)
            self._sealed = {name: fp[:12]}
            try:
                os.unlink(self._active_path)
            except OSError:
                pass
            self._active_rows = 0
            self._active_clean = False
            self._write_absorbed()

    # -- the anti-entropy surface --------------------------------------
    def digests(self) -> Dict[str, str]:
        """name → fingerprint of every sealed segment this node HOLDS.
        Absorbed segments ride separately (:meth:`absorbed`): a peer
        must not pull them, but must also not think we lack them."""
        with self._lock:
            return dict(self._sealed)

    def absorbed(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._absorbed)

    def subsumed(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._subsumed)

    def covered(self) -> Dict[str, str]:
        """Everything this node need never be shipped: absorbed by its
        own compactions plus subsumed by row-level coverage — the set
        the ``replog.digests`` wire op advertises beside the held
        segments."""
        with self._lock:
            return {**self._absorbed, **self._subsumed}

    def missing(self, remote: Dict[str, str]) -> List[str]:
        """Remote segment names this node neither holds nor has
        absorbed/subsumed — what a catch-up must consider pulling."""
        with self._lock:
            return sorted(n for n in remote
                          if n not in self._sealed
                          and n not in self._absorbed
                          and n not in self._subsumed)

    @staticmethod
    def row_keys_of(lines: List[str]) -> List[str]:
        """The cache keys of already-read row lines (one parse — the
        push leg has the lines in hand and must not re-read the file
        just for its keys)."""
        return [str(r["key"])
                for r in SegmentedLog._parse_rows(lines)]

    def row_keys(self, name: str) -> Optional[List[str]]:
        """The cache keys of one HELD segment's rows — the coverage a
        peer checks against its live set before asking for the rows
        themselves (the ``replog.covers`` wire op)."""
        with self._lock:
            if name not in self._sealed:
                return None
            try:
                _h, lines = self._read_lines(self._seg_path(name))
            except (OSError, ValueError):
                return None
            return self.row_keys_of(lines)

    def covers(self, names) -> List[dict]:
        """``[{name, fingerprint, keys}]`` for the held segments among
        ``names`` — the ``replog.covers`` wire payload, ONE file read
        per segment (keys parsed from the read, the fingerprint from
        the in-memory sealed map)."""
        out: List[dict] = []
        with self._lock:
            for name in names:
                fp = self._sealed.get(name)
                if fp is None:
                    continue
                try:
                    _h, lines = self._read_lines(self._seg_path(name))
                except (OSError, ValueError):
                    continue
                out.append({"name": name, "fingerprint": fp,
                            "keys": self.row_keys_of(lines)})
        return out

    def note_subsumed(self, name: str, fingerprint: str) -> bool:
        """Record that ``name``'s rows are already fully held locally:
        the segment is treated as covered — never pulled, never
        offered as missing — without its rows ever crossing the wire.
        Same name/fingerprint consistency gate as :meth:`adopt`; the
        record is capped like the absorbed one.  False = already
        held/covered (no-op)."""
        m = _SEG_RE.match(name)
        if m is None:
            raise ValueError(f"bad segment name {name!r}")
        if fingerprint and m.group("fp") != fingerprint[:12]:
            raise ValueError(
                f"segment {name} name does not match its content "
                f"fingerprint {fingerprint[:12]} (refusing to subsume)")
        with self._lock:
            if name in self._sealed or name in self._absorbed \
                    or name in self._subsumed:
                return False
            self._subsumed[name] = m.group("fp")
            self._cap_record(self._subsumed)
            self.subsumptions += 1
            self._write_absorbed()
        return True

    def read_segment(self, name: str) -> Optional[Tuple[str, List[str]]]:
        """(fingerprint, row lines) of one sealed segment, or None —
        the pull side of catch-up."""
        with self._lock:
            if name not in self._sealed:
                return None
            try:
                header, lines = self._read_lines(self._seg_path(name))
            except (OSError, ValueError):
                return None
            return str(header.get("fingerprint", "")), lines

    def adopt(self, name: str, fingerprint: str,
              lines: List[str]) -> List[dict]:
        """Adopt one replicated segment: fingerprint-verified, atomic,
        idempotent (a segment already held or absorbed is a no-op).
        Returns the adopted rows so the caller can fold them into its
        in-memory live set WITHOUT re-banking them — each verdict lands
        on this node's disk exactly once, in exactly this segment."""
        m = _SEG_RE.match(name)
        if m is None:
            raise ValueError(f"bad segment name {name!r}")
        if segment_fingerprint(lines) != fingerprint:
            raise ValueError(
                f"segment {name} fingerprint mismatch (torn or forged "
                "replication payload; refusing to adopt)")
        if m.group("fp") != fingerprint[:12]:
            # an inconsistent name/fingerprint pair would persist now
            # and quarantine on every restart — a permanent
            # quarantine/re-adopt churn loop; refuse it at the door
            raise ValueError(
                f"segment {name} name does not match its content "
                f"fingerprint {fingerprint[:12]} (refusing to adopt)")
        with self._lock:
            if name in self._sealed or name in self._absorbed \
                    or name in self._subsumed:
                return []
            self._write_segment(name, fingerprint, lines)
            self._sealed[name] = fingerprint[:12]
            self.adoptions += 1
        return self._parse_rows(lines)

    # -- observability -------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "node": self.node_id,
                    "sealed_segments": len(self._sealed),
                    "absorbed_segments": len(self._absorbed),
                    "subsumed_segments": len(self._subsumed),
                    "absorbed_cap": self.absorbed_cap,
                    "active_rows": self._active_rows,
                    "seal_rows": self.seal_rows,
                    "seals": self.seals,
                    "adoptions": self.adoptions,
                    "subsumptions": self.subsumptions,
                    "truncated_tails": self.truncated_tails,
                    "quarantined_segments": self.quarantined_segments}
