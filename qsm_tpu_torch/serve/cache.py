"""Verdict cache: a duplicate history answered in O(1), across restarts.

The counterpart of the JAX package's ``qsm_tpu/serve/cache.py``.  A
verdict is a pure function of (spec, history), so it is banked, with its
witness, under the history's canonical identity:

* **Key**: :func:`fingerprint_key`, sha256 over the canonical JSON of
  ``(spec.name, spec_kwargs, history.fingerprint())``, the reference's
  key, so that either package's bank answers the other's histories.
* **Memory**: a bounded LRU (``max_entries``); a hit moves to the front.
* **Disk**: an append-only JSONL bank (a header, then one row a banked
  put; a later row for a key supersedes earlier ones on load).  Each
  flush appends its rows with one fsync; when the log passes twice the
  live set it is compacted through ``resilience.checkpoint.
  atomic_write_text``.  A server killed mid-append tears at most the
  trailing line, which the loader drops; appending after a torn tail
  compacts first.
* **Honesty**: only decided verdicts (VIOLATION / LINEARIZABLE) are
  banked; BUDGET_EXCEEDED says something about an engine, not about the
  history.
* **Store**: ``store=`` takes a segmented bank
  (``fleet/replog.py::SegmentedLog``) in place of the single file: the
  same append / compact discipline, but the bank is content-fingerprinted
  segments a fleet replicates; :meth:`VerdictCache.adopt_rows` folds
  replicated rows into the live set without banking them again.

The shrinker (``shrink/shrinker.py``) keys its memo by
:func:`fingerprint_key` and takes a :class:`VerdictCache` as its bank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import List, Optional

from ..core.history import History

_ARTIFACT = "qsm_tpu_verdict_cache"
_VERSION = 1


def fingerprint_key(spec, history: History) -> str:
    """Canonical cache identity of (spec instance, observable history)."""
    doc = [spec.name, spec.spec_kwargs(), list(history.fingerprint())]
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=list).encode()).hexdigest()


@dataclasses.dataclass
class CacheEntry:
    verdict: int
    witness: Optional[List[tuple]] = None  # [(op_index, resp), ...]
    hits: int = 0


class VerdictCache:
    """Bounded LRU with an atomic persistent JSONL bank (see module
    docstring).  Thread-safe: the server's connection threads and the
    batcher's dispatch thread share one instance."""

    def __init__(self, max_entries: int = 4096, path: Optional[str] = None,
                 persist_every: int = 1, store=None):
        self.max_entries = max_entries
        self.path = path
        # a segmented bank (module docstring): when set, persistence goes
        # through the store's append / compact / load contract instead of
        # the single-file log, and this class still owns what is banked
        # (decided verdicts, merged rows, the later row wins)
        self.store = store
        self.persist_every = max(1, persist_every)
        self._od: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.compactions = 0
        self.bank_appends = 0  # append+fsync flushes (obs metrics feed)
        self.adopted = 0       # rows folded in from replicated segments
        self._puts_since_flush = 0
        self._dirty: List[str] = []   # banked rows awaiting one append
        self._file_rows = 0           # rows in the on-disk log
        self._file_exists = False
        if store is not None:
            self._load_store()
        elif path:
            self._load(path)

    # ------------------------------------------------------------------
    def get(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            e = self._od.get(key)
            if e is None:
                self.misses += 1
                return None
            self._od.move_to_end(key)
            e.hits += 1
            self.hits += 1
            return e

    def put(self, key: str, verdict: int,
            witness: Optional[List[tuple]] = None) -> None:
        with self._lock:
            if not self._put_locked(key, verdict, witness):
                return
            self._puts_since_flush += 1
            if (self._persistent
                    and self._puts_since_flush >= self.persist_every):
                self._flush_locked()

    def put_many(self, items) -> None:
        """Bank ``(key, verdict, witness)`` triples with ONE atomic
        flush for the whole batch: a flush is an O(entries) full-bank
        rewrite, so a 64-lane dispatch must pay it once, not 64 times
        (and every ``get`` on every connection thread blocks on the
        lock meanwhile)."""
        with self._lock:
            wrote = False
            for key, verdict, witness in items:
                wrote = self._put_locked(key, verdict, witness) or wrote
            if wrote and self._persistent:
                self._flush_locked()

    def _put_locked(self, key: str, verdict: int,
                    witness: Optional[List[tuple]]) -> bool:
        if verdict not in (0, 1):
            return False  # never bank BUDGET_EXCEEDED (module docstring)
        e = self._od.get(key)
        if e is not None:
            # keep a banked witness when the refresh has none (a
            # verdict-only re-check must not degrade the bank)
            if witness is not None:
                e.witness = list(witness)
            e.verdict = verdict
            self._od.move_to_end(key)
        else:
            e = self._od[key] = CacheEntry(
                verdict=verdict,
                witness=list(witness) if witness is not None else None)
            while len(self._od) > self.max_entries:
                self._od.popitem(last=False)
        if self._persistent:
            # serialize the POST-merge entry (not the put's arguments):
            # the last row for a key wins on load, so a verdict-only
            # refresh row must still carry the banked witness
            self._dirty.append(json.dumps(
                {"key": key, "verdict": e.verdict,
                 "witness": ([list(p) for p in e.witness]
                             if e.witness is not None else None)}))
        return True

    @property
    def _persistent(self) -> bool:
        return self.store is not None or bool(self.path)

    def adopt_rows(self, rows) -> int:
        """Fold replicated rows (``fleet/replog.py`` segment adoption) into
        the live set WITHOUT re-banking: the rows are already durable in
        the adopted segment, so marking them dirty would bank each
        verdict twice.  An existing entry only gains a witness it was
        missing — local rows stay authoritative (later-row-wins is a
        local ordering; a remote row for the same key can only agree on
        the verdict, verdicts being pure functions of (spec, history)).
        Returns rows actually folded in."""
        n = 0
        with self._lock:
            for row in rows:
                key, verdict = row.get("key"), row.get("verdict")
                if not key or verdict not in (0, 1):
                    continue
                w = row.get("witness")
                e = self._od.get(key)
                if e is not None:
                    if e.witness is None and w is not None:
                        e.witness = [tuple(p) for p in w]
                        n += 1
                    continue
                self._od[key] = CacheEntry(
                    verdict=verdict,
                    witness=[tuple(p) for p in w] if w is not None
                    else None)
                n += 1
                while len(self._od) > self.max_entries:
                    self._od.popitem(last=False)
            self.adopted += n
        return n

    def holds_all(self, keys) -> bool:
        """True iff EVERY key is in the live set — the row-level
        subsumption gate (the ``replog.subsumed`` op): a segment whose keys are all held need not ship its rows.
        Pure containment: no hit/miss accounting, no LRU touch (a
        coverage probe must not keep cold entries artificially hot).
        An empty key list is NOT coverage — there is nothing to
        subsume, so the segment ships and the fingerprint check
        decides."""
        keys = list(keys)
        if not keys:
            return False
        with self._lock:
            return all(k in self._od for k in keys)

    def flush(self) -> None:
        with self._lock:
            if self._persistent:
                self._flush_locked()

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            out = {"entries": len(self._od), "hits": self.hits,
                   "misses": self.misses,
                   "hit_rate": round(self.hits / total, 3) if total else 0.0,
                   "bank_rows": self._file_rows,
                   "bank_appends": self.bank_appends,
                   "compactions": self.compactions,
                   "adopted": self.adopted,
                   "path": self.path}
        if self.store is not None:
            out["replog"] = self.store.snapshot()
        return out

    # ------------------------------------------------------------------
    def _flush_locked(self) -> None:
        """Persist pending rows: ONE append+fsync per call (O(batch)).
        The log compacts to an atomic header+live-entries rewrite when
        it grows past twice the live set — appends must never turn the
        bank into an unbounded file."""
        if not self._dirty:
            self._puts_since_flush = 0
            return
        live = len(self._od)
        if self.store is not None:
            # segmented bank: O(batch) append into the active
            # segment; when the store's row count outgrows the live
            # set, fold into ONE fresh segment (the store remembers
            # what it absorbed)
            if (self.store.total_rows + len(self._dirty)
                    > max(2 * live, self.max_entries)):
                self.store.compact(self._live_lines())
                self.compactions += 1
            else:
                self.store.append(self._dirty)
                self.bank_appends += 1
            self._file_rows = self.store.total_rows
            self._dirty.clear()
            self._puts_since_flush = 0
            return
        if (not self._file_exists
                or self._file_rows + len(self._dirty)
                > max(2 * live, self.max_entries)):
            self._compact_locked()
        else:
            with open(self.path, "a") as f:
                f.write("\n".join(self._dirty) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._file_rows += len(self._dirty)
            self.bank_appends += 1
        self._dirty.clear()
        self._puts_since_flush = 0

    def _live_lines(self) -> List[str]:
        """The live set serialized in LRU order (oldest first — append
        order IS recency order on reload, like the single-file bank)."""
        return [json.dumps({"key": k, "verdict": e.verdict,
                            "witness": ([list(p) for p in e.witness]
                                        if e.witness is not None
                                        else None)})
                for k, e in self._od.items()]

    def _compact_locked(self) -> None:
        from ..resilience.checkpoint import atomic_write_text

        header = {"artifact": _ARTIFACT, "version": _VERSION,
                  "entries": len(self._od)}
        rows = self._live_lines()
        atomic_write_text(self.path,
                          "\n".join([json.dumps(header)] + rows) + "\n")
        self._file_rows = len(rows)
        self._file_exists = True
        self.compactions += 1

    def _load_store(self) -> None:
        """Adopt the segmented bank's merged row stream (the store
        handles torn tails and corrupt segments itself — what arrives
        here is clean).  Later rows supersede earlier ones, exactly
        like the single-file load."""
        for row in self.store.load():
            key, verdict = row.get("key"), row.get("verdict")
            if not key or verdict not in (0, 1):
                continue
            w = row.get("witness")
            self._od[key] = CacheEntry(
                verdict=verdict,
                witness=[tuple(p) for p in w] if w is not None else None)
            self._od.move_to_end(key)
        while len(self._od) > self.max_entries:
            self._od.popitem(last=False)
        self._file_rows = self.store.total_rows

    def _load(self, path: str) -> None:
        """Adopt a prior bank; CellJournal's tolerance rules — a garbled
        or truncated tail is dropped (those entries simply re-check), an
        alien header adopts nothing but is preserved aside.  The bank is
        an append log: a LATER row for a key supersedes earlier ones."""
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            return
        docs = []
        # torn = the file does not END at a clean line boundary: either
        # a garbled/unparsable line, or a final line that parses but
        # has no trailing newline (the kill landed after the payload
        # bytes, before the '\n' — still not appendable-after)
        torn = not text.endswith("\n")
        for ln in text.splitlines():
            if not ln.strip():
                continue
            try:
                docs.append(json.loads(ln))
            except ValueError:
                torn = True
                break  # truncated/garbled: trust nothing at or past it
        if not docs:
            return
        if docs[0].get("artifact") != _ARTIFACT:
            try:  # not ours: preserve, never adopt or clobber
                os.replace(path, f"{path}.pre-resume")
            except OSError:
                pass
            return
        # appending after a torn tail would weld the first new row onto
        # the partial line and poison every later load.  Leaving
        # _file_exists False forces the next flush to COMPACT (atomic
        # full rewrite), which re-establishes a clean line boundary.
        self._file_exists = not torn
        self._file_rows = len(docs) - 1
        for row in docs[1:]:
            key, verdict = row.get("key"), row.get("verdict")
            if not key or verdict not in (0, 1):
                continue
            w = row.get("witness")
            self._od[key] = CacheEntry(
                verdict=verdict,
                witness=[tuple(p) for p in w] if w is not None else None)
            self._od.move_to_end(key)  # append order IS recency order
        while len(self._od) > self.max_entries:
            self._od.popitem(last=False)
