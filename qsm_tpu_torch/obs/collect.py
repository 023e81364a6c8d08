"""Fleet-wide span collection — scrape any process's span log.

Every process keeps its own span log, so the causal story of one
request served by a fleet is scattered across many logs on many hosts.
This module is the collection plane that stitches it (the counterpart
of the JAX package's ``qsm_tpu/obs/collect.py``):

* :func:`read_span_page` — one cursor-paged, bounded, idempotent read
  of a span log (the serve plane exposes it as the ``obs.spans``
  protocol op): the cursor identifies WHERE in WHICH file the last
  page ended, so a re-scrape ships zero duplicate events, a scrape
  across the log's one-file rotation keeps reading from the rotated
  predecessor, and a scrape that outlived two rotations reports an
  honest ``gap`` instead of silently re-shipping or losing order.
* :class:`SpanCollector` — the router-side consumer: per-node cursors
  persisted atomically (a restarted router resumes where it stopped,
  re-shipping nothing), pages bounded per node per sweep, every
  collected event stamped with its source ``node``, appended to ONE
  rotation-bounded collected log that ``trace <id>`` reconstructs
  whole-fleet causal trees from.

Cursor semantics (docs/OBSERVABILITY.md "Fleet"): a cursor is
``{"sig": <first-line fingerprint of the file being read>,
"off": <byte offset past the last complete line consumed>}``.  The
live log's first line is stable for the file's whole life (the tracer
appends, never truncates — restarts keep appending), so ``sig`` is a
rotation-epoch identity that needs no server-side state: when the live
file's sig no longer matches, the cursor's file is either the ``.1``
predecessor (keep draining it, then hop to the live file at offset 0)
or gone (two rotations — the page answers ``gap: true`` and restarts
from the oldest surviving file).  Torn tails (a kill mid-write) are
never consumed: the offset only ever advances past complete lines, so
the next page re-reads the completed line, not half of it.

Clock skew policy: collection NEVER orders events by wall clock across
processes.  Causality comes from the propagated ``trace``/``span``/
``parent`` ids (the router stamps its ``node.dispatch`` span id into
each sub-request's ``parent`` field, so a node's ``request`` root pins
under the router edge that caused it); per-file emit order is kept as
the sibling order.  :func:`~qsm_tpu_torch.obs.trace.trace_closure` then
rebuilds one cross-process tree purely from those edges.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Callable, Dict, List, Optional

# one obs.spans page: hard bound on events however large the caller's
# ask (a scrape must never balloon one response past what a LineChannel
# read comfortably buffers)
MAX_PAGE_EVENTS = 2048
DEFAULT_PAGE_EVENTS = 512
# collected-log rotation bound (one live file + one predecessor, the
# tracer's own discipline): fleet-wide collection is bounded disk
# however long the router lives
DEFAULT_COLLECTED_BYTES = 32 * 1024 * 1024


def _first_line_sig(path: str) -> str:
    """Fingerprint of a span file's first complete line — stable for
    the file's whole life (append-only), changed exactly at rotation.
    "" = no file, or no complete first line yet."""
    try:
        with open(path, "rb") as f:
            head = f.read(4096)
    except OSError:
        return ""
    nl = head.find(b"\n")
    if nl < 0:
        return ""
    return hashlib.sha256(head[:nl]).hexdigest()[:16]


def _read_complete_lines(path: str, off: int, max_events: int):
    """Up to ``max_events`` complete JSON lines from ``path`` past byte
    ``off``.  Returns ``(events, new_off, drained)`` — ``new_off``
    advances only past COMPLETE lines (a torn tail is re-read next
    page, never half-consumed) and ``drained`` says the file holds no
    further complete line right now."""
    events: List[dict] = []
    try:
        with open(path, "rb") as f:
            f.seek(off)
            buf = b""
            new_off = off
            while len(events) < max_events:
                nl = buf.find(b"\n")
                if nl < 0:
                    chunk = f.read(65536)
                    if not chunk:
                        return events, new_off, True
                    buf += chunk
                    continue
                line, buf = buf[:nl], buf[nl + 1:]
                new_off += nl + 1
                if not line.strip():
                    continue
                try:
                    events.append(json.loads(line.decode()))
                except (ValueError, UnicodeDecodeError):
                    continue  # a garbled line is droppable, not fatal
            drained = not buf and not f.read(1)
            return events, new_off, drained
    except OSError:
        return [], off, True


def read_span_page(path: str, cursor: Optional[dict] = None,
                   max_events: int = DEFAULT_PAGE_EVENTS) -> dict:
    """One bounded page of span events from a rotating span log (module
    docstring has the cursor semantics).  Pure function over the files
    — the serving side keeps no per-scraper state, which is what makes
    the op idempotent and restart-safe on BOTH ends."""
    max_events = max(1, min(int(max_events), MAX_PAGE_EVENTS))
    prev = f"{path}.1"
    live_sig = _first_line_sig(path)
    prev_sig = _first_line_sig(prev)
    gap = False
    sig = off = None
    if cursor is not None:
        sig = str(cursor.get("sig") or "")
        off = max(0, int(cursor.get("off") or 0))
    if cursor is not None and not sig:
        # a cursor minted against a live file that had no identity yet
        # (scraped mid-rotation, or before the first event): we are
        # positioned at the live head — restarting from the
        # predecessor here would re-ship everything already consumed
        read_path, sig = path, live_sig
    elif sig and sig == live_sig:
        read_path = path
    elif sig and sig == prev_sig:
        read_path = prev
    else:
        # first scrape (no cursor), or the cursor's file rotated away:
        # start from the oldest surviving file.  A lost file is an
        # honest gap, never a silent re-ship-from-zero of data we may
        # have already consumed elsewhere.
        gap = bool(sig)
        read_path, sig, off = ((prev, prev_sig, 0) if prev_sig
                               else (path, live_sig, 0))
    events, new_off, drained = _read_complete_lines(read_path, off,
                                                    max_events)
    if drained and read_path == prev:
        # predecessor exhausted: the next page starts the live file
        out_cursor = {"sig": live_sig, "off": 0}
        more = bool(live_sig)
    else:
        out_cursor = {"sig": sig, "off": new_off}
        more = not drained
    return {"events": events, "cursor": out_cursor, "more": more,
            "gap": gap}


def span_page_response(tracer, req: dict) -> dict:
    """The ``obs.spans`` op's whole answer over one process's tracer —
    THE shared implementation (serve/server.py and fleet/router.py
    both delegate here, so the cursor semantics cannot drift between
    the two surfaces)."""
    if tracer.path is None:
        return {"id": req.get("id"), "ok": True, "enabled": False,
                "events": [], "cursor": req.get("cursor"),
                "more": False}
    tracer.flush()
    cursor = req.get("cursor")
    page = read_span_page(
        tracer.path, cursor if isinstance(cursor, dict) else None,
        max_events=int(req.get("max_events") or DEFAULT_PAGE_EVENTS))
    return {"id": req.get("id"), "ok": True, "enabled": True, **page}


class _RotatingSink:
    """Pre-serialized JSONL appender with the tracer's one-predecessor
    rotation bound — the collected log's disk is O(2 × max_bytes)
    however long collection runs."""

    def __init__(self, path: str, max_bytes: int):
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self._f = None
        self._bytes = 0
        self._closed = False
        self.rotations = 0

    def write_line(self, line: str) -> None:
        if self._closed:
            # a sweep racing close() (router stop joins threads with a
            # bound shorter than a fetch timeout) must not silently
            # reopen the file and leak the handle past teardown
            return
        try:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._f = open(self.path, "a")
                self._bytes = self._f.tell()
            if self._bytes + len(line) > self.max_bytes:
                self._f.close()
                os.replace(self.path, f"{self.path}.1")
                self._f = open(self.path, "a")
                self._bytes = 0
                self.rotations += 1
            self._f.write(line)
            self._bytes += len(line)
        except OSError:
            self._f = None  # full disk degrades collection only

    def flush(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


class SpanCollector:
    """The fleet-wide collected span log (module docstring).

    ``dir`` holds the collected log (``collected.jsonl`` + its one
    rotation predecessor) and the persisted per-node cursors
    (``cursors.json``, written atomically once per sweep) — a
    restarted router resumes every node exactly where it stopped and
    re-ships zero events.  One sweep is bounded by
    ``max_pages_per_node × page_events`` events per node; a backlog
    drains over beats, it never makes one sweep unbounded."""

    CURSORS = "cursors.json"
    LOG = "collected.jsonl"

    def __init__(self, dir: str, *,
                 max_bytes: int = DEFAULT_COLLECTED_BYTES,
                 page_events: int = DEFAULT_PAGE_EVENTS,
                 max_pages_per_node: int = 8):
        self.dir = dir
        self.page_events = max(1, min(int(page_events), MAX_PAGE_EVENTS))
        self.max_pages_per_node = max(1, int(max_pages_per_node))
        self._lock = threading.Lock()
        self._sink = _RotatingSink(os.path.join(dir, self.LOG),
                                   max_bytes)
        self._cursors: Dict[str, dict] = {}
        self._load_cursors()
        self.sweeps = 0
        self.events_collected = 0
        self.pages = 0
        self.gaps = 0
        self.node_failures = 0

    @property
    def out_path(self) -> str:
        return self._sink.path

    def _load_cursors(self) -> None:
        try:
            with open(os.path.join(self.dir, self.CURSORS)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        if isinstance(doc, dict):
            self._cursors = {str(k): v for k, v in doc.items()
                             if isinstance(v, dict)}

    def _save_cursors(self) -> None:
        from ..resilience.checkpoint import atomic_write_json

        try:
            os.makedirs(self.dir, exist_ok=True)
            atomic_write_json(os.path.join(self.dir, self.CURSORS),
                              self._cursors)
        except OSError:
            pass  # unpersisted cursors cost a re-ship, never the sweep

    # ------------------------------------------------------------------
    def sweep(self, node_ids, fetch: Callable[[str, Optional[dict],
                                               int], dict]) -> dict:
        """One collection sweep: pull bounded pages from each node via
        ``fetch(node_id, cursor, max_events) -> obs.spans response``
        (which may raise — a dead node costs its own bounded fetch,
        never the sweep).  Events are stamped with their source node
        and appended to the collected log; cursors persist once at the
        end.  The lock guards only sink/cursor mutation, never a
        network fetch — a wedged node must not block ``snapshot()``
        (the router's stats op) for a whole fetch timeout."""
        collected = gaps = pages = failures = 0
        for nid in node_ids:
            with self._lock:
                cursor = self._cursors.get(nid)
            for _page in range(self.max_pages_per_node):
                try:
                    resp = fetch(nid, cursor, self.page_events)
                except Exception:  # noqa: BLE001 — scrape, don't die
                    failures += 1
                    break
                if not resp.get("ok", True) or not resp.get(
                        "enabled", True):
                    break
                if resp.get("gap"):
                    gaps += 1
                cursor = resp.get("cursor") or cursor
                with self._lock:
                    for ev in resp.get("events") or []:
                        if not isinstance(ev, dict):
                            continue
                        if "node" not in ev:
                            ev = {**ev, "node": nid}
                        self._sink.write_line(json.dumps(ev) + "\n")
                        collected += 1
                    self._cursors[nid] = cursor
                pages += 1
                if not resp.get("more"):
                    break
        with self._lock:
            self._sink.flush()
            self._save_cursors()
            self.sweeps += 1
            self.events_collected += collected
            self.pages += pages
            self.gaps += gaps
            self.node_failures += failures
        return {"events": collected, "pages": pages, "gaps": gaps,
                "node_failures": failures}

    def close(self) -> None:
        with self._lock:
            self._sink.close()

    def snapshot(self) -> dict:
        with self._lock:
            return {"dir": self.dir,
                    "sweeps": self.sweeps,
                    "events_collected": self.events_collected,
                    "pages": self.pages,
                    "gaps": self.gaps,
                    "node_failures": self.node_failures,
                    "rotations": self._sink.rotations,
                    "nodes": sorted(self._cursors)}
