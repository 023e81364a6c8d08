"""``CheckClient`` — the serving plane's caller side.

The counterpart of the JAX package's ``qsm_tpu/serve/client.py``; either
package's client talks to either package's server.

One instance = one connection; requests on a connection are answered in
order.  Concurrency is per-connection (each concurrent caller opens its
own client — the micro-batcher coalesces ACROSS connections).

Multi-address failover: ``address`` may be a comma-separated
list (``--addr a,b``) naming an HA router pair (or any set of
protocol-identical doors to the same fleet).  The client walks the list
with BOUNDED retries on three signals:

* connect failure / connection death mid-request — the socket layer's
  word that this door is gone;
* a ``SHED`` whose reason is ``router_standby`` / ``router_superseded``
  — the door is alive but not the active brain (the HA refusal
  contract, fleet/router.py), so the answer lives behind another one;
* the ``router`` fault site (``QSM_TPU_FAULTS=partition:router`` /
  ``raise:router`` / ``hang:router``) — the client→router exchange is
  chaos-drillable on the CPU platform like every other link in the
  stack.

Re-asking after a death mid-request is safe because every fleet op is
idempotent: check/shrink/stats are pure functions of the request and
verdicts bank by fingerprint (a duplicate lands on the same cache row).
Retries are bounded by ``len(addresses) + 1`` attempts — a fleet with
no answering door raises ``ConnectionError``, never spins.

Used by the ``submit``, ``health``, ``stats --serve`` and ``--addr`` /
``--submit`` subcommands, ``gen/fleet.py`` and the tests.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import List, Optional, Sequence, Union

from ..core.history import History
from ..obs import new_trace_id
from ..resilience.faults import InjectedFault, inject
from .protocol import (LineChannel, connect, history_to_rows, send_doc)

_ids = itertools.count()

# ops whose retry ladder must ride ONE trace id: the client mints it
# up front (when the caller supplied none), so a request that bounces
# between addresses — a standby's HA shed, a death mid-request —
# reconstructs as ONE cross-door story in the collected span log
_TRACED_OPS = ("check", "shrink", "session.open", "session.append",
               "session.close")

# SHED reasons that mean "alive, but not the brain you want" — the
# client hops to the next address instead of surfacing the refusal
_FAILOVER_SHED_REASONS = ("router_standby", "router_superseded")

# pause between full cycles through a multi-address list: a takeover
# window (lease TTL + grace + one beat) lasts seconds, so burning the
# whole address list once per millisecond would exhaust any attempt
# budget long before the standby promotes.  The retry ladder is
# WALL-CLOCK bounded by the client's own timeout_s instead.
_CYCLE_PAUSE_S = 0.25


class CheckClient:
    """JSON-lines client for a running :class:`~qsm_tpu_torch.serve.server.
    CheckServer` or :class:`~qsm_tpu_torch.fleet.router.FleetRouter`
    (address: ``host:port`` or a UNIX socket path, or a comma list of
    either for multi-address failover — see module docstring)."""

    def __init__(self, address: str, timeout_s: float = 60.0):
        self.address = address
        self.addresses = [a.strip() for a in str(address).split(",")
                          if a.strip()]
        if not self.addresses:
            raise ValueError("CheckClient needs at least one address")
        self.timeout_s = timeout_s
        self.failovers = 0   # address hops taken (death or HA shed)
        self._addr_i = 0
        self._sock = None
        self._chan: Optional[LineChannel] = None
        self._connect_any()

    # ------------------------------------------------------------------
    def check(self, model: str,
              histories: Sequence[Union[History, Sequence[Sequence[int]]]],
              *, spec_kwargs: Optional[dict] = None, witness: bool = False,
              deadline_s: Optional[float] = None,
              req_id: Optional[str] = None,
              trace: Optional[str] = None) -> dict:
        """Submit one corpus; returns the response document (``ok`` with
        per-history verdict names, or ``shed``/``error``).  ``trace``
        propagates a caller-minted trace id (obs) — omitted,
        the server mints one and the response carries it either way."""
        rows: List[list] = [
            history_to_rows(h) if isinstance(h, History) else list(h)
            for h in histories]
        req = {"op": "check", "id": req_id or f"q{next(_ids)}",
               "model": model, "histories": rows}
        if spec_kwargs:
            req["spec_kwargs"] = spec_kwargs
        if witness:
            req["witness"] = True
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if trace:
            req["trace"] = trace
        return self._round_trip(req)

    def shrink(self, model: str,
               history: Union[History, Sequence[Sequence[int]]],
               *, spec_kwargs: Optional[dict] = None,
               certificate: bool = False,
               deadline_s: Optional[float] = None,
               req_id: Optional[str] = None,
               trace: Optional[str] = None) -> dict:
        """Minimize one failing history (the ``shrink`` verb,
        docs/SHRINK.md): the response carries the 1-minimal history's
        rows plus rounds/lanes/memo counters; ``certificate=True`` adds
        the per-neighbor ``verify_witness``-replayable proof."""
        rows = (history_to_rows(history) if isinstance(history, History)
                else list(history))
        req = {"op": "shrink", "id": req_id or f"q{next(_ids)}",
               "model": model, "history": rows}
        if spec_kwargs:
            req["spec_kwargs"] = spec_kwargs
        if certificate:
            req["certificate"] = True
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if trace:
            req["trace"] = trace
        return self._round_trip(req)

    # -- monitor sessions (monitor, docs/MONITOR.md) -----------
    def session_open(self, model: str, *,
                     spec_kwargs: Optional[dict] = None,
                     session: Optional[str] = None,
                     deadline_s: Optional[float] = None,
                     trace: Optional[str] = None) -> dict:
        """Open (or resume) a streaming monitor session; the response
        carries the server-assigned ``session`` id and current
        ``seq``.  :class:`SessionHandle` wraps the three verbs with
        the seq bookkeeping replays need."""
        req = {"op": "session.open", "id": f"q{next(_ids)}",
               "model": model}
        if spec_kwargs:
            req["spec_kwargs"] = spec_kwargs
        if session is not None:
            req["session"] = session
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if trace:
            req["trace"] = trace
        return self._round_trip(req)

    def session_append(self, session: str, events, *,
                       seq: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       trace: Optional[str] = None) -> dict:
        """Stream events into a session.  ``seq`` (the stream index of
        the first event) makes the append IDEMPOTENT: a re-send after
        a failover or reconnect applies only what the server has not
        seen — the same replay-safety contract every fleet op has.
        The response carries the current verdict, and the ``flip``
        payload (minimized repro + certificate) on the append that
        made a violation decidable."""
        req = {"op": "session.append", "id": f"q{next(_ids)}",
               "session": session, "events": list(events)}
        if seq is not None:
            req["seq"] = int(seq)
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if trace:
            req["trace"] = trace
        return self._round_trip(req)

    def session_close(self, session: str, *, witness: bool = False,
                      deadline_s: Optional[float] = None,
                      trace: Optional[str] = None) -> dict:
        req = {"op": "session.close", "id": f"q{next(_ids)}",
               "session": session}
        if witness:
            req["witness"] = True
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if trace:
            req["trace"] = trace
        return self._round_trip(req)

    def stats(self) -> dict:
        return self._round_trip({"op": "stats"})

    # -- elastic membership (a fleet router's ops) ----------------------
    def node_join(self, node: str, address: str) -> dict:
        """Add a node to a router's ring (idempotent): consistent
        hashing moves only the key ranges the newcomer's vnode points
        claim, and the router seeds its replog by anti-entropy before
        answering."""
        return self._round_trip({"op": "node.join",
                                 "id": f"q{next(_ids)}",
                                 "node": str(node),
                                 "address": str(address)})

    def node_leave(self, node: str) -> dict:
        """Retire a node from a router's ring (idempotent): its key
        ranges move to the next points clockwise and every session it
        owned migrates live — the journal replays onto the new owner
        on its next verb, exactly-once by seq."""
        return self._round_trip({"op": "node.leave",
                                 "id": f"q{next(_ids)}",
                                 "node": str(node)})

    # -- the device-work queue (devq, docs/WINDOWS.md) ---------
    def devq_put(self, items) -> dict:
        """Bank device-worthy work items (``devq.put``): any fleet node
        can feed the queue a window host later drains.  Idempotent —
        items dedupe by their fingerprint key."""
        return self._round_trip({"op": "devq.put",
                                 "id": f"q{next(_ids)}",
                                 "items": list(items)})

    def devq_digests(self) -> dict:
        """The queue's anti-entropy advertisement (``devq.digests``):
        segment digests of the devq log plus a queue snapshot."""
        return self._round_trip({"op": "devq.digests",
                                 "id": f"q{next(_ids)}"})

    def devq_pull(self, segments) -> dict:
        """Ship devq segments out (``devq.pull``) — fingerprint-
        verified by the adopting side, like ``replog.pull``."""
        return self._round_trip({"op": "devq.pull",
                                 "id": f"q{next(_ids)}",
                                 "segments": list(segments)})

    def devq_drain_report(self, report: Optional[dict] = None,
                          rows=None, done=None) -> dict:
        """Hand a drained window back (``devq.drain_report``): verdict
        rows bank under their originating fingerprints, drained keys
        tombstone as done, the report feeds the ``window_utilization``
        SLO.  With no arguments, reads the node's last report."""
        req = {"op": "devq.drain_report", "id": f"q{next(_ids)}"}
        if report is not None:
            req["report"] = report
        if rows:
            req["rows"] = [list(r) for r in rows]
        if done:
            req["done"] = list(done)
        return self._round_trip(req)

    # -- fleet observability (docs/OBSERVABILITY.md "Fleet") -----------
    def health(self) -> dict:
        """The ``health`` op: SLO status of the server/router (and,
        through a router, the folded per-node statuses)."""
        return self._round_trip({"op": "health"})

    def metrics(self) -> dict:
        """The ``obs.metrics`` op: the process's live metric samples,
        JSON-shaped (a router answers the federated set)."""
        return self._round_trip({"op": "obs.metrics"})

    def trace_events(self, trace_id: str) -> dict:
        """The ``obs.trace`` op: one trace's events (causal closure);
        a router answers from its collected fleet log merged with its
        own span log — the `qsm-tpu trace <id> --addr` transport."""
        return self._round_trip({"op": "obs.trace",
                                 "trace": str(trace_id)})

    def span_page(self, cursor: Optional[dict] = None,
                  max_events: Optional[int] = None) -> dict:
        """One ``obs.spans`` page of the peer's span log (cursor-paged
        and idempotent — obs/collect.py owns the semantics)."""
        req: dict = {"op": "obs.spans", "cursor": cursor}
        if max_events is not None:
            req["max_events"] = int(max_events)
        return self._round_trip(req)

    def shutdown(self) -> dict:
        # Deliberately single-attempt: ``shutdown`` is the one op the
        # contract excludes from IDEMPOTENT_OPS (serve/protocol.py) —
        # a failover re-send after a mid-flight drop could stop a
        # *different* process than the one that already acked.  A
        # dropped reply after the server acted is indistinguishable
        # from a dropped request, so the caller sees the error rather
        # than the client silently escalating it fleet-wide.
        # (QSM-PROTO-RETRY-IDEMPOTENT pins this shape.)
        return self._ask_once({"op": "shutdown"})

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None
        self._chan = None

    # ------------------------------------------------------------------
    @property
    def connected_address(self) -> str:
        """The address currently (or last) spoken to."""
        return self.addresses[self._addr_i % len(self.addresses)]

    def _connect_any(self, bound_s: Optional[float] = None) -> None:
        """Connect to the first answering address, starting from the
        current position (sticky: a client that failed over stays on
        the working door).  ``bound_s`` caps EACH connect attempt —
        the failover ladder passes its remaining budget so a
        SYN-dropping partition cannot stall one attempt for the whole
        ``timeout_s`` per address."""
        bound_s = self.timeout_s if bound_s is None else bound_s
        last: Optional[BaseException] = None
        for k in range(len(self.addresses)):
            i = (self._addr_i + k) % len(self.addresses)
            try:
                sock = connect(self.addresses[i],
                               timeout_s=max(0.1, bound_s))
            except OSError as e:
                last = e
                continue
            self._addr_i = i
            self._sock = sock
            self._chan = LineChannel(sock)
            return
        raise ConnectionError(
            f"no server answered at {self.addresses}: "
            f"{type(last).__name__}: {last}")

    def _advance(self) -> None:
        self.close()
        self._addr_i = (self._addr_i + 1) % len(self.addresses)
        self.failovers += 1

    def _round_trip(self, req: dict) -> dict:
        """One request under bounded multi-address failover (module
        docstring).  Single-address clients keep one bounded retry on
        a fresh connection — a server restart on the same address must
        not read as server death (the NodeLink lesson one level up).
        Multi-address clients cycle the list with a short pause
        between full cycles, wall-clock bounded by ``timeout_s``: a
        takeover window (the standby still shedding ``router_standby``
        while the lease runs out) lasts seconds, and a count bound
        would burn out in milliseconds against a dead door."""
        if req.get("op") in _TRACED_OPS and not req.get("trace"):
            # mint the trace CLIENT-side so every attempt of this
            # logical request — across doors and takeover windows —
            # shares one id (the server adopts it; _TRACED_OPS note)
            req["trace"] = new_trace_id()
        n = len(self.addresses)
        deadline = time.monotonic() + max(1.0, self.timeout_s)
        # bounded by construction: every attempt either pauses toward
        # the deadline or is one of the first `n + 1` free tries, AND
        # the deadline is re-checked per attempt (a SYN-dropping
        # partition burns connect budget, not just pause budget)
        max_attempts = (n + 1) + n * max(
            1, int(max(1.0, self.timeout_s) / _CYCLE_PAUSE_S) + 1)
        last: Optional[BaseException] = None
        for attempt in range(max_attempts):
            if attempt and time.monotonic() >= deadline:
                break
            try:
                doc = self._ask_once(req, deadline)
            except (OSError, ConnectionError, TimeoutError, ValueError,
                    InjectedFault) as e:
                last = e
                self._advance()
                if not self._pause_between_cycles(attempt, n, deadline):
                    break
                continue
            if (doc.get("shed")
                    and doc.get("reason") in _FAILOVER_SHED_REASONS
                    and n > 1):
                # alive but not the active brain: hop — the active is
                # behind one of the other doors (or about to be, after
                # its lease beat)
                last = None
                self._advance()
                if not self._pause_between_cycles(attempt, n, deadline):
                    return doc  # out of time: surface the honest SHED
                continue
            return doc
        if last is None:
            raise ConnectionError(
                f"no active router at {self.addresses} before the "
                f"{self.timeout_s:.1f}s client bound")
        raise ConnectionError(
            f"server at {self.address} closed the connection "
            f"({type(last).__name__}: {last})")

    def _pause_between_cycles(self, attempt: int, n: int,
                              deadline: float) -> bool:
        """After a full cycle through the address list, wait out a
        short pause (the takeover window is time, not attempts).
        False = the deadline is spent — stop retrying.  Single-address
        clients get their one free fresh-connection retry, then stop."""
        if n == 1:
            return attempt < 1
        if (attempt + 1) % n:
            return True  # mid-cycle: try the next address immediately
        remaining = deadline - time.monotonic()
        if remaining <= _CYCLE_PAUSE_S:
            return False
        time.sleep(_CYCLE_PAUSE_S)
        return True

    def _ask_once(self, req: dict,
                  deadline: Optional[float] = None) -> dict:
        bound = self.timeout_s
        if deadline is not None:
            bound = max(0.1, min(bound, deadline - time.monotonic()))
        if self._sock is None:
            self._connect_any(bound)
        act = inject("router")
        if act in ("partition", "wedge"):
            # the exchange's frames drop both directions: the request
            # never arrives, the answer never comes — the failover
            # loop treats it exactly like a dead door
            self.close()
            raise ConnectionError(
                "injected partition at fault site 'router'")
        send_doc(self._sock, req)
        line = self._chan.read_line(timeout_s=bound)
        if line is None:
            raise ConnectionError(
                f"server at {self.connected_address} closed the "
                "connection")
        return json.loads(line)

    def __enter__(self) -> "CheckClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SessionHandle:
    """One live monitor session, seq-tracked (docs/MONITOR.md).

    Wraps the three ``session.*`` verbs so callers just ``append``
    events: every append carries ``seq``, so the client's bounded
    retry/failover ladder (the ``_round_trip`` machinery, multi-address
    included) can safely re-send — the server applies only what it has
    not seen, and a replay onto a restarted node resumes from the
    banked decided prefix.  ``flips`` collects every pushed flip
    payload (minimized repro + certificate)."""

    def __init__(self, client: CheckClient, model: str, *,
                 spec_kwargs: Optional[dict] = None,
                 session: Optional[str] = None,
                 deadline_s: Optional[float] = None):
        self.client = client
        self.model = model
        self.spec_kwargs = spec_kwargs
        self.deadline_s = deadline_s
        doc = client.session_open(model, spec_kwargs=spec_kwargs,
                                  session=session,
                                  deadline_s=deadline_s)
        if not doc.get("ok"):
            raise RuntimeError(f"session.open refused: {doc}")
        self.sid: str = doc["session"]
        self.seq: int = int(doc.get("seq", 0))
        self.verdict: str = doc.get("verdict", "LINEARIZABLE")
        self.trace: str = doc.get("trace", "")
        self.flips: List[dict] = []
        self.last: dict = doc

    def append(self, events) -> dict:
        """Stream events; returns the response (current verdict, and
        the flip payload on the deciding append)."""
        events = list(events)
        doc = self.client.session_append(
            self.sid, events, seq=self.seq,
            deadline_s=self.deadline_s,
            trace=self.trace or None)
        self.last = doc
        if doc.get("ok"):
            self.seq = int(doc.get("seq", self.seq))
            self.verdict = doc.get("verdict", self.verdict)
            if doc.get("flip"):
                self.flips.append(doc["flip"])
        return doc

    def close(self, witness: bool = False) -> dict:
        doc = self.client.session_close(self.sid, witness=witness,
                                        deadline_s=self.deadline_s,
                                        trace=self.trace or None)
        self.last = doc
        if doc.get("ok"):
            self.verdict = doc.get("verdict", self.verdict)
        return doc
