"""Log tailing — a growing foreign event log as a live session stream.

The ``monitor`` command rides this: each appended line of a
jepsen/porcupine-style log becomes one monitor event
(``{"type": "invoke"|"respond", ...}``, the events
``MonitorSession.append`` takes) the moment it lands, so an unmodified system that only writes a
log file is monitored live, flips included.  Only COMPLETE lines are
consumed (a partially-written tail line stays in the buffer until its
newline arrives — the CellJournal torn-tail discipline, applied
forward), and the tailer is bounded: ``follow=False`` drains what is
there and stops, ``follow=True`` polls until ``stop()`` or
``max_idle_s`` of silence.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

from .adapters import decode_event
from .edn import parse_map_line
from .specmap import IngestError, spec_map_for


class EventTailer:
    """Incremental line→event converter for one (format, model) pair.

    Rides THE shared per-line decode (``adapters.decode_event``) —
    the live-monitor path and the batch ingest path can never
    disagree on the same log — and keeps the per-pid outstanding-op
    table the response mapping needs (a ``:ok`` line names no
    cmd/arg — its invocation does)."""

    def __init__(self, fmt: str, model: str, spec):
        if fmt not in ("jepsen", "porcupine"):
            raise IngestError(f"unknown ingest format {fmt!r}; one of "
                              "['jepsen', 'porcupine']")
        self.keyed_field = "key" if fmt == "porcupine" else None
        self.smap = spec_map_for(model, spec)
        self._open: dict = {}
        self.lines = 0

    def events_for_line(self, line: str) -> list:
        """Monitor events for one log line ([] for blanks/comments/
        nemesis lines/``:info`` — an unknown outcome leaves the op
        pending, which is exactly what NOT sending its response
        does)."""
        line = line.strip()
        if not line or line.startswith(";"):
            return []
        self.lines += 1
        ev = decode_event(parse_map_line(line), self.smap,
                          self.keyed_field, self._open)
        if ev is None or ev[0] == "info":
            return []
        kind, pid, payload = ev
        if kind == "invoke":
            return [{"type": "invoke", "pid": pid, "cmd": payload[0],
                     "arg": payload[1]}]
        return [{"type": "respond", "pid": pid, "resp": payload}]


def tail_file(path: str, *, follow: bool = False, poll_s: float = 0.2,
              max_idle_s: float = 30.0,
              stop: Optional[Callable[[], bool]] = None
              ) -> Iterator[str]:
    """Yield complete lines of a (possibly growing) file.  Bounded by
    contract: non-follow drains once; follow stops on ``stop()`` or
    after ``max_idle_s`` without growth (a dead producer must not hold
    the monitor open forever)."""
    buf = ""
    idle_since = time.monotonic()
    with open(path, "r") as fh:
        while True:
            chunk = fh.read(65536)
            if chunk:
                idle_since = time.monotonic()
                buf += chunk
                while "\n" in buf:
                    line, _, buf = buf.partition("\n")
                    yield line
                continue
            if not follow:
                return
            if stop is not None and stop():
                return
            if time.monotonic() - idle_since >= max_idle_s:
                return
            time.sleep(poll_s)
