"""Request-scoped spans — the serving stack's causal record.

Every window into the serve plane before this module was an
after-the-fact aggregate (``SearchStats``, ``stats()``): good for
capacity math, useless for "where did THIS request spend its 400 ms?".
A :class:`Tracer` answers that with the standard distributed-tracing
shape, standard library only:

* a **trace id** is minted once per request at admission
  (:func:`new_trace_id`) and propagated through every stage the request
  touches — micro-batch flushes, pcomp sub-lanes, worker-pool frames,
  shrink frontier rounds, failover degradations, cache put/hit;
* each stage emits a **span event**: one JSON document with
  ``trace`` (the request), ``span`` (this event's own id), ``parent``
  (the span it is causally under), ``name`` (the taxonomy entry —
  docs/OBSERVABILITY.md), ``ts``/``ms`` and free-form attrs;
* events append to a **JSONL log with bounded-size rotation** (the
  ``atomic``-rails discipline: a torn tail is droppable, never
  poisonous) so ``trace <trace_id>`` can reconstruct one
  request's full causal tree offline.

Cost contract: with no sink configured ``enabled`` is False and every
emit site guards on ONE attribute read, so the tracing-off path costs
next to nothing.  With a sink, emission is one
dict → json.dumps → buffered write under a lock; durability comes from
the flight recorder (obs/flight.py), not fsync-per-event.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

# rotation default: one live file + one predecessor (``<path>.1``) —
# bounded disk however long the server lives; readers walk both
DEFAULT_MAX_BYTES = 16 * 1024 * 1024


def new_trace_id() -> str:
    """One request's identity across every stage (16 hex chars)."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """One span event's identity inside its trace (10 hex chars)."""
    return uuid.uuid4().hex[:10]


class Span:
    """One timed stage, context-manager closed.

    ``with tracer.span("lane", trace=t, parent=root, index=0) as sp:``
    emits exactly one event on exit (success or exception — the
    discipline the QSM-OBS-SPAN lint pass gates) with the measured
    ``ms`` and ``status``; ``sp.id`` is the span id children parent
    under, ``sp.add(k=v)`` attaches attrs discovered mid-stage."""

    __slots__ = ("_tracer", "name", "trace", "id", "parent", "attrs",
                 "_t0")

    def __init__(self, tracer: "Tracer", name: str, trace: str,
                 parent: str, attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.trace = trace
        self.id = new_span_id()
        self.parent = parent
        self.attrs = attrs
        self._t0 = 0.0

    def add(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        ms = round((time.monotonic() - self._t0) * 1000.0, 3)
        status = "ok" if exc_type is None else f"error:{exc_type.__name__}"
        self._tracer.emit(self.name, trace=self.trace, span=self.id,
                          parent=self.parent, ms=ms, status=status,
                          **self.attrs)


class _NullSpan:
    """The tracing-off span: every field readable, nothing emitted."""

    __slots__ = ()
    id = ""
    trace = ""
    parent = ""

    def add(self, **_attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *_exc) -> None:
        return None


NULL_SPAN = _NullSpan()


class Tracer:
    """Span-event sink: JSONL file with bounded rotation plus
    subscriber hooks (the flight recorder rides one).  Thread-safe —
    connection threads, dispatcher threads and the pool supervisor all
    emit concurrently."""

    def __init__(self, path: Optional[str] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self.enabled = path is not None
        self._lock = threading.Lock()
        self._f = None
        self._bytes = 0
        self._hooks: List[Callable[[dict], None]] = []
        self.events = 0      # emitted this process (guarded)
        self.rotations = 0

    # ------------------------------------------------------------------
    def add_hook(self, fn: Callable[[dict], None]) -> None:
        """Subscribe to every emitted event (called under the emit
        lock: hooks must be cheap and never re-enter the tracer)."""
        with self._lock:
            self._hooks.append(fn)
            # a hook is a live consumer even with no file sink (the
            # flight recorder works with tracing-to-disk off)
            self.enabled = True

    def span(self, name: str, trace: str, parent: str = "",
             **attrs) -> Span:
        """A timed context-manager span; the no-op singleton when
        tracing is off (callers pay one attribute read + one branch)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, trace, parent, attrs)

    def event(self, name: str, trace: str = "", parent: str = "",
              ms: Optional[float] = None, **attrs) -> str:
        """One instantaneous span event; returns its span id ("" when
        tracing is off) so children can parent under it."""
        if not self.enabled:
            return ""
        span = new_span_id()
        self.emit(name, trace=trace, span=span, parent=parent, ms=ms,
                  **attrs)
        return span

    def emit(self, name: str, trace: str = "", span: str = "",
             parent: str = "", ms: Optional[float] = None,
             status: str = "ok", **attrs) -> None:
        if not self.enabled:
            return
        doc = {"ts": round(time.time(), 4), "name": name,
               "trace": trace, "span": span or new_span_id(),
               "parent": parent, "status": status}
        if ms is not None:
            doc["ms"] = ms
        if attrs:
            doc["attrs"] = attrs
        with self._lock:
            self.events += 1
            hooks = list(self._hooks)
            if self.path is not None:
                self._write_locked(json.dumps(doc) + "\n")
        # hooks run OUTSIDE the emit lock: a trigger-fired flight dump
        # (ring serialization + atomic disk write) must stall only the
        # emitting thread, never every other thread's next emit — the
        # degraded situations that fire dumps are exactly the ones
        # where the disk may be slow (hooks keep their own locking)
        for hook in hooks:
            try:
                hook(doc)
            except Exception:  # noqa: BLE001 — a broken subscriber
                pass           # must never take tracing down

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    # ------------------------------------------------------------------
    def _write_locked(self, line: str) -> None:
        try:
            if self._f is None:
                self._f = open(self.path, "a")
                self._bytes = self._f.tell()
            if self._bytes + len(line) > self.max_bytes:
                # bounded rotation: live file becomes <path>.1 (the one
                # predecessor kept), a fresh live file starts — trace
                # disk is O(2 * max_bytes) however long the server runs
                self._f.close()
                os.replace(self.path, f"{self.path}.1")
                self._f = open(self.path, "a")
                self._bytes = 0
                self.rotations += 1
            self._f.write(line)
            self._f.flush()
            self._bytes += len(line)
        except OSError:
            # a full disk must degrade tracing, never the serving plane
            self._f = None

    def snapshot(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "path": self.path,
                    "events": self.events, "rotations": self.rotations}


# ---------------------------------------------------------------------------
# offline reconstruction — `trace <id>`
# ---------------------------------------------------------------------------

def load_events(path: str, trace_id: Optional[str] = None) -> List[dict]:
    """Events from the live log and its one rotation predecessor, in
    file order; garbled lines (a kill mid-write) are dropped, never
    fatal.  ``trace_id`` filters to one request's events."""
    out: List[dict] = []
    for p in (f"{path}.1", path):
        try:
            with open(p) as f:
                text = f.read()
        except OSError:
            continue
        for ln in text.splitlines():
            if not ln.strip():
                continue
            try:
                doc = json.loads(ln)
            except ValueError:
                continue
            if trace_id is not None and doc.get("trace") != trace_id:
                continue
            out.append(doc)
    return out


def trace_closure(events: List[dict], trace_id: str) -> List[dict]:
    """One trace's events PLUS their causal ancestors — the
    cross-process rule behind a fleet-wide ``trace <id>``: a
    ``router.takeover`` or ``router.elect`` event carries no trace id
    (it belongs to every request of its term), but a request served
    under that term parents its root beneath it, so walking parent
    edges pulls the fleet-level cause into the request's tree.  Pure
    span/parent-edge traversal — wall clocks are never consulted, so
    per-process clock skew cannot reorder the tree.  Deduplicates by
    span id (a collection gap reset may have shipped an event twice);
    returns events in their original merged-file order."""
    by_span: Dict[str, dict] = {}
    for ev in events:
        sp = ev.get("span")
        if sp and sp not in by_span:
            by_span[sp] = ev
    picked: List[dict] = []
    seen: set = set()
    stack: List[str] = []
    for ev in events:
        if ev.get("trace") != trace_id:
            continue
        sp = ev.get("span")
        if sp in seen or by_span.get(sp) is not ev:
            continue  # duplicate shipment of the same span event
        seen.add(sp)
        picked.append(ev)
        if ev.get("parent"):
            stack.append(ev["parent"])
    while stack:
        sp = stack.pop()
        if not sp or sp in seen:
            continue
        seen.add(sp)
        ev = by_span.get(sp)
        if ev is None:
            continue  # rotated away: the child renders as a root
        picked.append(ev)
        if ev.get("parent"):
            stack.append(ev["parent"])
    order = {id(ev): i for i, ev in enumerate(events)}
    picked.sort(key=lambda ev: order[id(ev)])
    return picked


def build_tree(events: List[dict]) -> List[dict]:
    """Causal forest from one trace's events: each node is the event
    dict plus ``children`` (sorted by emit order).  An event whose
    parent span never emitted (dropped line, rotation boundary)
    becomes a root rather than vanishing — an incomplete tree must
    still show everything it has."""
    by_span: Dict[str, dict] = {}
    nodes = []
    for ev in events:
        node = {**ev, "children": []}
        nodes.append(node)
        if ev.get("span"):
            by_span[ev["span"]] = node
    roots = []
    for node in nodes:
        parent = by_span.get(node.get("parent") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


def render_tree(roots: List[dict]) -> str:
    """Human rendering of :func:`build_tree`'s forest (the ``trace``
    command's default output)."""
    lines: List[str] = []

    def _attrs(node: dict) -> str:
        parts = []
        if node.get("ms") is not None:
            parts.append(f"{node['ms']}ms")
        for k, v in (node.get("attrs") or {}).items():
            parts.append(f"{k}={v}")
        if node.get("status", "ok") != "ok":
            parts.append(node["status"])
        return (" [" + " ".join(parts) + "]") if parts else ""

    def _walk(node: dict, prefix: str, last: bool) -> None:
        joint = "`- " if last else "|- "
        lines.append(f"{prefix}{joint}{node['name']}{_attrs(node)}")
        child_prefix = prefix + ("   " if last else "|  ")
        kids = node["children"]
        for i, child in enumerate(kids):
            _walk(child, child_prefix, i == len(kids) - 1)

    for root in roots:
        lines.append(f"{root['name']}{_attrs(root)}")
        for i, child in enumerate(root["children"]):
            _walk(child, "", i == len(root["children"]) - 1)
    return "\n".join(lines)
