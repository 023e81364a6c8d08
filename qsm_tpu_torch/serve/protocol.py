"""JSON-lines wire protocol of the check server.

The counterpart of the JAX package's ``qsm_tpu/serve/protocol.py``, with
its wire format unchanged, so that either package's client talks to
either package's server.  One request or response a line, UTF-8 JSON,
over a local TCP or UNIX socket.  Histories ride the one external
encoding, the ``[pid, cmd, arg, resp, invoke_time, response_time]`` rows
of regression files and the ``check`` trace format
(``utils/report.py::history_from_rows`` decodes them).

Requests::

    {"op": "check", "id": "c0-3", "model": "cas", "histories": [[...]],
     "spec_kwargs": {}, "witness": false, "deadline_s": 30.0}
    {"op": "shrink", "id": "s1", "model": "kv", "history": [...],
     "spec_kwargs": {}, "certificate": false, "deadline_s": 300.0}
    {"op": "session.open" | "session.append" | "session.close", ...}
    {"op": "stats"} {"op": "health"} {"op": "shutdown"}
    {"op": "obs.spans" | "obs.trace" | "obs.metrics", ...}
    {"op": "replog.*" | "devq.*", ...}

Responses (in request order on a connection)::

    {"id": "c0-3", "ok": true, "verdicts": ["LINEARIZABLE", ...],
     "cached": [true, false, ...], "witnesses": [...]?,
     "batches": [{...why stamp...}], "trace": "...", "seconds": 0.012}
    {"id": "c0-3", "ok": false, "shed": true, "reason": "deadline"}
    {"id": "c0-3", "ok": false, "error": "AcceleratorError: ..."}

A ``shed`` response is the load-shedding contract (``admission.py``): the
server refuses work it cannot finish inside the request's deadline,
never by a wrong or partial verdict.  Every ``check`` / ``shrink`` /
``session.*`` response carries the request's ``trace`` id (minted at
admission or adopted from the request), and a shed one the last
flight-recorder dump path (``flight``) when one fired.  A ``shrink``
answers with the 1-minimal history's rows and its round and lane
counters; a deadline firing mid-shrink returns the best history so far
with ``complete: false``.  Session appends carry ``seq`` (the stream
index of their first event), so a resent append applies only unseen
events; the append that makes a violation decidable carries ``flip``
(the minimised ``repro`` and its ``certificate``).

The fleet ops of the reference (``gossip.peers``, ``lease.*``,
``node.join`` / ``node.leave``) are listed in :data:`OPS`, so the wire
contract is the reference's; this package's server answers them with an
error until its fleet tier is ported.
"""

from __future__ import annotations

import json
import socket
import time
from typing import Callable, List, Optional, Sequence

from ..core.history import History
# index == Verdict value; defined once, in ops/backend.py, and re-exported
# here for the wire's users
from ..ops.backend import VERDICT_NAMES  # noqa: F401

# ---------------------------------------------------------------------
# The machine-readable wire contract (docs/PROTOCOL.md).  The protocol
# analyzer (analysis/protocol_model.py, lint family l) parses these
# tuples straight from this file's AST — keep them literal: no
# comprehensions, no computed elements.  Every op a client or router
# path sends and every op a ``_handle`` dispatches must appear in
# ``OPS``; the lint gate fails otherwise (QSM-PROTO-UNHANDLED).
OPS = (
    "check", "shrink", "stats", "shutdown",
    "session.open", "session.append", "session.close",
    "replog.digests", "replog.pull", "replog.push",
    "replog.covers", "replog.subsumed",
    "gossip.peers",
    "obs.spans", "obs.trace", "obs.metrics", "health",
    "lease.acquire", "lease.renew", "lease.release", "lease.read",
    "node.join", "node.leave",
    "devq.put", "devq.digests", "devq.pull", "devq.drain_report",
)

# Ops that MAY legally sit on a retrying call path (CheckClient
# failover, NodeLink fresh-socket retry, router re-dispatch).  Every
# entry's replay-safety argument, in one place:
#   check/shrink      — verdicts bank by history fingerprint; a replay
#                       answers from the bank (docs/SERVE.md)
#   session.*         — open resumes by session id; append carries
#                       ``seq`` so the server applies only unseen
#                       events; close is a no-op on a closed session
#   replog.*/gossip.* — anti-entropy reads + set-union writes
#   stats/obs.*/health— read-only snapshots (spans is cursor-paged)
#   lease.*           — the store transaction is term-gated: a replayed
#                       acquire of an own live record is a renew (same
#                       term), a replayed renew refreshes the same
#                       term, a replayed release re-tombstones the
#                       already-released record, read is read-only
#   node.join/leave   — membership set-union/difference: re-adding a
#                       present node or removing an absent one is a
#                       no-op rebuild of the same ring
#   devq.*            — put dedupes by item fingerprint (a replayed put
#                       of a pending/done key is a no-op), digests/pull
#                       are anti-entropy reads, drain_report banks
#                       fingerprint-keyed verdicts (set-union) + marks
#                       done tombstones (absorbing), so a replay
#                       re-banks identical rows
# ``shutdown`` is deliberately ABSENT: re-sending it after a mid-flight
# failover could stop a *different* process than the one addressed, so
# the client sends it on a single non-retrying attempt
# (QSM-PROTO-RETRY-IDEMPOTENT pins this).
IDEMPOTENT_OPS = (
    "check", "shrink", "stats",
    "session.open", "session.append", "session.close",
    "replog.digests", "replog.pull", "replog.push",
    "replog.covers", "replog.subsumed",
    "gossip.peers",
    "obs.spans", "obs.trace", "obs.metrics", "health",
    "lease.acquire", "lease.renew", "lease.release", "lease.read",
    "node.join", "node.leave",
    "devq.put", "devq.digests", "devq.pull", "devq.drain_report",
)

# Envelope keys: request keys any sender may attach / response keys
# any reply may carry, regardless of op.  ``node``/``term`` are
# stamped by the ONE ``_send`` egress (never by handlers); ``trace``/
# ``flight`` ride on admission and tracing.  The field-conformance
# pass (QSM-PROTO-FIELDS) exempts these from per-op sender/handler
# matching.
REQUEST_ENVELOPE = ("op", "id", "trace", "parent", "deadline_s")
RESPONSE_ENVELOPE = ("ok", "id", "error", "node", "term", "trace",
                     "flight", "shed", "reason", "router")

# recv granularity and the poll slice used while honoring deadlines /
# shutdown flags (a LineChannel read is bounded by BOTH)
_RECV_BYTES = 65536
_POLL_S = 0.5
# send bound: LineChannel leaves its short poll timeout on the socket,
# which sendall would otherwise inherit — a large witness response to a
# client that stalls >0.5 s mid-drain would abort the connection.  A
# send gets its own generous bound instead (a peer that cannot drain in
# this long is wedged, and a bounded drop beats a leaked thread).
SEND_TIMEOUT_S = 30.0


def history_to_rows(h: History) -> List[list]:
    """Inverse of utils/report.py::history_from_rows (pending ops keep
    their sentinel resp/response_time; the decoder canonicalizes)."""
    return [[o.pid, o.cmd, o.arg, o.resp, o.invoke_time, o.response_time]
            for o in h.ops]


def rows_to_history(rows: Sequence[Sequence[int]]) -> History:
    from ..utils.report import history_from_rows

    return history_from_rows(rows)


def send_doc(sock: socket.socket, doc: dict) -> None:
    sock.settimeout(SEND_TIMEOUT_S)
    sock.sendall((json.dumps(doc) + "\n").encode())


class LineChannel:
    """Buffered newline-framed reader over a socket.

    Every read is bounded: ``timeout_s`` is a wall-clock deadline and
    ``stop`` an optional shutdown predicate polled every ``_POLL_S`` —
    the discipline the QSM-SERVE-ACCEPT lint pass gates (an unbounded
    recv loop holds a server thread forever when a peer wedges).
    Returns ``None`` on EOF / closed socket; raises :class:`TimeoutError`
    past the deadline.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = b""

    def read_line(self, timeout_s: Optional[float] = None,
                  stop: Optional[Callable[[], bool]] = None
                  ) -> Optional[str]:
        t0 = time.monotonic()
        while b"\n" not in self._buf:
            if stop is not None and stop():
                return None
            slice_s = _POLL_S
            if timeout_s is not None:
                remaining = timeout_s - (time.monotonic() - t0)
                if remaining <= 0:
                    raise TimeoutError("read_line deadline exceeded")
                slice_s = min(slice_s, remaining)
            self.sock.settimeout(slice_s)
            try:
                chunk = self.sock.recv(_RECV_BYTES)
            except socket.timeout:
                continue
            except OSError:
                return None
            if not chunk:
                return None  # peer closed
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\n")
        return line.decode()


def parse_address(address: str):
    """``host:port`` → ``("tcp", (host, port))``; anything else is a
    UNIX socket path → ``("unix", path)``."""
    if ":" in address:
        host, _, port = address.rpartition(":")
        if port.isdigit():
            return "tcp", (host or "127.0.0.1", int(port))
    return "unix", address


def connect(address: str, timeout_s: float = 10.0) -> socket.socket:
    kind, target = parse_address(address)
    if kind == "tcp":
        return socket.create_connection(target, timeout=timeout_s)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout_s)
    s.connect(target)
    return s
