"""Crash flight recorder — the last N events, dumped when it matters.

"The pool wedged overnight" used to be a log-archaeology session: the
trace log (when enabled) holds millions of lines, the stats counters
say only *that* something shed, and a SIGKILLed worker leaves no
in-process evidence at all.  The recorder keeps a FIXED-SIZE in-memory
ring of recent span events per component (``serve``, ``pool``,
``admission``, ``cache``, ``failover``, ``fault`` — the prefix before
the first ``.`` in the event name) and dumps the whole ring atomically
to ``FLIGHT_<ts>_<reason>.json`` when one of the trigger conditions
fires:

* a pool worker is shed (crash/wedge/SIGKILL) or a spec is quarantined;
* a SHED storm (``storm_threshold`` sheds inside ``storm_window_s``);
* a fault-plane rule fires (``QSM_TPU_FAULTS`` hits in production mean
  someone is fault-drilling the live server — worth an artifact);
* ``CheckServer.stop()`` (the post-mortem baseline: what was in flight
  at teardown).

Dumps are rate-limited (``min_interval_s``) so a crash loop produces
a bounded number of artifacts, and written through the
``resilience.checkpoint.atomic_write_json`` rails — a dump can never
be torn.  The ring records even when JSONL tracing is off: it is
O(max_events) memory and append-only cheap, and the whole point is
having evidence precisely when nobody thought to enable tracing.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional


class FlightRecorder:
    """See module docstring.  Thread-safe; one instance per server."""

    def __init__(self, dir: str, *, max_events: int = 256,
                 min_interval_s: float = 5.0,
                 storm_threshold: int = 32,
                 storm_window_s: float = 10.0):
        self.dir = dir
        self.max_events = max(8, int(max_events))
        self.min_interval_s = min_interval_s
        self.storm_threshold = max(1, int(storm_threshold))
        self.storm_window_s = storm_window_s
        self._lock = threading.Lock()
        self._rings: Dict[str, Deque[dict]] = {}
        # bounded even before the window prune runs (QSM-SERVE-UNBOUNDED
        # discipline): the threshold is the only length that matters
        self._sheds: Deque[float] = deque(
            maxlen=max(self.storm_threshold * 4, 64))
        # None, not 0.0: ``time.monotonic()`` has an arbitrary epoch
        # (boot time on Linux), so a 0.0 sentinel wrongly suppresses
        # the FIRST dump whenever uptime < min_interval_s
        self._last_dump: Optional[float] = None
        self.recorded = 0
        self.dumps = 0
        self.dumps_suppressed = 0
        self.last_dump_path: Optional[str] = None
        self.last_dump_reason: Optional[str] = None

    # ------------------------------------------------------------------
    def record(self, doc: dict) -> None:
        """Ring-append one span event under its component (the event
        name's prefix).  O(1), bounded, never raises."""
        component = str(doc.get("name", "?")).split(".", 1)[0]
        with self._lock:
            ring = self._rings.get(component)
            if ring is None:
                ring = self._rings[component] = deque(
                    maxlen=self.max_events)
            ring.append(doc)
            self.recorded += 1

    def note_shed(self) -> Optional[str]:
        """Count one SHED toward the storm window; returns the dump
        path when this shed tipped the threshold.  The window clears
        only when a dump actually LANDED: a storm that trips inside
        another dump's rate-limit shadow keeps re-arming on every
        further shed and produces its artifact the moment the limiter
        opens, instead of silently resetting (docs/SERVING.md promises
        "a SHED storm fires a dump by itself")."""
        now = time.monotonic()
        with self._lock:
            self._sheds.append(now)
            while self._sheds and now - self._sheds[0] > self.storm_window_s:
                self._sheds.popleft()
            storm = len(self._sheds) >= self.storm_threshold
        if not storm:
            return None
        path = self.dump("shed_storm")
        if path is not None:
            with self._lock:
                self._sheds.clear()  # one dump per storm, not per shed
        return path

    # ------------------------------------------------------------------
    def dump(self, reason: str, extra: Optional[dict] = None,
             force: bool = False) -> Optional[str]:
        """Write the rings to ``FLIGHT_<unix_ms>_<reason>.json``
        atomically; returns the path, or None when rate-limited (the
        crash-loop bound) or the directory is unwritable."""
        now = time.monotonic()
        with self._lock:
            if (not force and self._last_dump is not None
                    and now - self._last_dump < self.min_interval_s):
                self.dumps_suppressed += 1
                return None
            self._last_dump = now
            rings = {k: list(v) for k, v in self._rings.items()}
            n_dump = self.dumps
        doc = {
            "artifact": "qsm_tpu_flight",
            "version": 1,
            "reason": reason,
            "captured_unix": round(time.time(), 3),
            "events": sum(len(v) for v in rings.values()),
            "components": {k: v for k, v in sorted(rings.items())},
        }
        if extra:
            doc["extra"] = extra
        ts_ms = int(time.time() * 1000)
        path = os.path.join(
            self.dir, f"FLIGHT_{ts_ms}_{n_dump}_{reason}.json")
        try:
            os.makedirs(self.dir, exist_ok=True)
            from ..resilience.checkpoint import atomic_write_json

            atomic_write_json(path, doc, indent=1)
        except OSError:
            return None  # an unwritable dir degrades the recorder only
        with self._lock:
            self.dumps += 1
            self.last_dump_path = path
            self.last_dump_reason = reason
        return path

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "recorded": self.recorded,
                "rings": {k: len(v)
                          for k, v in sorted(self._rings.items())},
                "dumps": self.dumps,
                "dumps_suppressed": self.dumps_suppressed,
                "last_dump": self.last_dump_path,
                "last_reason": self.last_dump_reason,
            }


def load_dump(path: str) -> dict:
    """Read one flight dump (tests and the debugging walkthrough)."""
    import json

    with open(path) as f:
        return json.load(f)


def recent_events(dump: dict, component: Optional[str] = None
                  ) -> List[dict]:
    """Flatten a dump's per-component rings back into one list
    (optionally one component), preserving per-ring order."""
    comps = dump.get("components", {})
    if component is not None:
        return list(comps.get(component, ()))
    out: List[dict] = []
    for _k, ring in sorted(comps.items()):
        out.extend(ring)
    return out
