"""Monitor sessions — a live system's event stream as a first-class
serving object (docs/MONITOR.md).

The counterpart of the JAX package's ``qsm_tpu/monitor/session.py``.
Each :meth:`MonitorSession.decide` re-checks the windows of every
frontier its events touched as ONE device batch a spec
(``frontier.py::WindowEngines``: ``TorchStepper`` with
``init_states``, a lane per window and frontier state), on CUDA unless
``device="cpu"``, which takes the reference's host loop; ``engine=``
(a factory spec -> checker) batches on any checker, e.g.
``functools.partial(TorchStepper, device="cpu")``.  A
:class:`SessionManager` keeps one engine a spec for all its sessions.

A session is opened against one spec, fed invocation/response events as
they happen, and decided INCREMENTALLY by the frontier layer
(monitor/frontier.py): decided prefixes bank under rolling prefix
fingerprints and leave memory, the open window re-checks from the
frontier states only, and the verdict is exact at every step — the
session's answer after event k equals the whole-history ``check``
verdict of the first k events, bit-for-bit.

**Event forms** (``MonitorSession.append``):

* ``{"type": "invoke", "pid": p, "cmd": c, "arg": a, "t": t?}`` /
  ``{"type": "respond", "pid": p, "resp": r, "t": t?}`` — the live
  stream.  Arrival order IS time order (monotonic ``t`` enforced;
  omitted ``t`` is assigned from the arrival counter), so decisions
  fire the moment they are decidable.
* a raw ``[pid, cmd, arg, resp, invoke_time, response_time]`` row — a
  completed op (recorded corpora, ingest adapters).  Rows must arrive
  sorted by invoke time; their response events are held in a small
  reorder buffer until the invoke horizon passes them (a response is
  not *final* until no future op can invoke before it), which keeps
  mid-stream verdicts exact for overlapping recorded traces too.

**Per-key composition.**  A spec with a VALIDATED per-key projection
(core/spec.py ``projection_report``; the exact gate PComp trusts) gets
one frontier per key over the PROJECTED spec: an event touches only its
key's frontier, so a one-key event re-checks one key's window
(``pcomp`` per suffix, the o(n) shape), and per-key prefixes
bank under the projected spec's own fingerprint domain.  Verdicts
recombine by the PComp aggregation rule (VIOLATION beats
BUDGET_EXCEEDED beats LINEARIZABLE).

**Bounds**: the event log is capped (``max_events`` — appends past it are refused
loudly), frontier state sets are capped (frontier.py ``max_states``),
and committed-prefix ops are EVICTED from frontier windows; the
:class:`SessionManager` caps live sessions and refuses opens past the
cap (the server answers SHED).
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..core.history import History
from ..core.spec import Spec
from ..ops.backend import VERDICT_NAMES, Verdict
from ..sched.runner import PENDING_T
from .frontier import (DEFAULT_MAX_STATES, DEFAULT_NODE_BUDGET,
                       IncrementalFrontier, WindowEngines, window_engines)

DEFAULT_MAX_EVENTS = 65_536
DEFAULT_MAX_SESSIONS = 256

# reorder-buffer entry kinds: responses drain before invokes at equal
# times (cuts are strict — resp < inv — so the order is deterministic
# and never manufactures a cut)
_K_RESPOND, _K_INVOKE = 0, 1


class SessionError(ValueError):
    """A malformed event/stream — answered as an error, never applied."""


class SessionLimit(RuntimeError):
    """A bound refused the work (session cap, event cap) — the serve
    layer answers SHED, exactly like admission pressure."""


class MonitorSession:
    """One live session (module docstring).  Not thread-safe by itself
    — callers hold :attr:`lock`.  ``device`` / ``engine`` pick the window
    re-check (:func:`~qsm_tpu_torch.monitor.frontier.window_engines`;
    CUDA by default, raising ``BackendUnavailable`` without a card);
    ``engines`` hands in a shared :class:`WindowEngines` instead."""

    def __init__(self, sid: str, spec: Spec, *,
                 proj_spec: Optional[Spec] = None,
                 bank=None,
                 node_budget: int = DEFAULT_NODE_BUDGET,
                 max_states: int = DEFAULT_MAX_STATES,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 trace: str = "",
                 device=None, engine=None,
                 engines: Optional[WindowEngines] = None):
        # the window re-check first: without a card this raises before
        # anything else is set up
        self.engines = (engines if engines is not None
                        else window_engines(device, engine))
        self.sid = sid
        self.spec = spec
        self.proj = proj_spec
        self.bank = bank
        self.trace = trace           # the session's trace id (obs plane)
        # reentrant: the serve handler holds it across an append/close
        # whose manager bookkeeping re-reads counters under it
        self.lock = threading.RLock()
        self.node_budget = node_budget
        self.max_states = max_states
        self.max_events = max_events
        self.rows: List[list] = []   # canonical 6-rows, invoke order
        self.seq = 0                 # raw events accepted (idempotent replay)
        self.closed = False
        self.flipped = False
        self.last_used = time.monotonic()  # idle-eviction clock
        self.flip_pushed = False     # the flip payload left for a client
        self.flip_rows: Optional[List[list]] = None  # stream at flip time
        # the serve layer stamps the registry identity here at open so
        # failover replay and the flip->shrink path can rebuild engines
        self.model: Optional[str] = None
        self.spec_kwargs: dict = {}
        # durable substrate (monitor/store.py), bound by the manager;
        # None = in-memory only
        self.store = None
        self._row_of_pid: Dict[int, int] = {}   # outstanding invocation row
        self._key_of_pid: Dict[int, Optional[int]] = {}
        self._frontiers: Dict[Optional[int], IncrementalFrontier] = {}
        self._dirty: set = set()
        self._heap: List[tuple] = []  # reorder buffer (rows' responses)
        self._heap_seq = 0
        self._horizon = -1            # latest final time (see module doc)
        self._last_t = -1
        self._auto_t = 0

    # -- event intake ---------------------------------------------------
    def append(self, events, seq: Optional[int] = None) -> int:
        """Apply a batch of events; returns how many were NEW (replays
        carry ``seq`` — the stream index of their first event — so a
        re-sent append after a failover/restart is idempotent)."""
        if self.closed:
            raise SessionError(f"session {self.sid} is closed")
        events = list(events)
        skip = 0
        if seq is not None:
            seq = int(seq)
            if seq > self.seq:
                raise SessionError(
                    f"session {self.sid}: append seq {seq} leaves a gap "
                    f"(next expected {self.seq})")
            skip = min(len(events), self.seq - seq)
        fresh = events[skip:]
        if not fresh:
            return 0
        if len(self.rows) + len(fresh) > self.max_events:
            raise SessionLimit(
                f"session {self.sid}: event cap {self.max_events} "
                "reached — close the session or raise max_events")
        for ev in fresh:
            self._apply(ev)
            self.seq += 1
        self._drain(final=False)
        if self.store is not None:
            # journal the fresh slice under its stream index; replay
            # re-appends with the same seq, so overlap is idempotent.
            # Past the tail cap, compact: rewrite the snapshot from the
            # live session (the journaled batches are now inside it)
            self.store.append_events(self.sid, self.seq - len(fresh),
                                     fresh)
            if self.store.tail_len(self.sid) >= self.store.snap_every:
                self.store.snapshot(self.sid, self.to_doc())
        return len(fresh)

    def _apply(self, ev) -> None:
        if isinstance(ev, dict):
            self._apply_dict(ev)
        elif isinstance(ev, (list, tuple)) and len(ev) == 6:
            self._apply_row([int(v) for v in ev])
        else:
            raise SessionError(
                f"session {self.sid}: event must be an invoke/respond "
                f"dict or a 6-row, got {ev!r}")

    def _next_t(self, t) -> int:
        if t is None:
            t = self._last_t + 1 if self._last_t >= self._auto_t \
                else self._auto_t
        t = int(t)
        if t < self._last_t:
            raise SessionError(
                f"session {self.sid}: event time {t} runs backwards "
                f"(last {self._last_t}) — the monitor's exactness "
                "contract needs real-time-ordered arrival")
        self._last_t = t
        self._auto_t = t + 1
        return t

    def _apply_dict(self, ev: dict) -> None:
        kind = ev.get("type")
        if kind in ("invoke", "call"):
            t = self._next_t(ev.get("t"))
            pid = int(ev["pid"])
            cmd, arg = int(ev["cmd"]), int(ev.get("arg", 0))
            self._push(_K_INVOKE, t, (pid, cmd, arg))
            self._horizon = max(self._horizon, t)
        elif kind in ("respond", "ok", "return"):
            t = self._next_t(ev.get("t"))
            pid = int(ev["pid"])
            self._push(_K_RESPOND, t, (pid, int(ev.get("resp", 0))))
            self._horizon = max(self._horizon, t)
        else:
            raise SessionError(
                f"session {self.sid}: unknown event type {kind!r} "
                "(one of invoke/respond, or a 6-row)")

    def _apply_row(self, row: List[int]) -> None:
        pid, cmd, arg, resp, inv, ret = row
        if inv < self._horizon:
            # rows must arrive in invoke order: an earlier invoke after
            # the horizon advanced would have been decided without it
            raise SessionError(
                f"session {self.sid}: row invokes at {inv} behind the "
                f"stream horizon {self._horizon} — stream rows sorted "
                "by invoke_time")
        pending = resp is None or resp < 0 or ret >= PENDING_T
        if not pending and ret < inv:
            raise SessionError(
                f"session {self.sid}: row responds at {ret} before its "
                f"invocation at {inv}")
        self._push(_K_INVOKE, inv, (pid, cmd, arg))
        if not pending:
            self._push(_K_RESPOND, ret, (pid, resp))
        # only the INVOKE is final-ordered for rows; the response waits
        # in the buffer until the invoke horizon passes it
        self._horizon = max(self._horizon, inv)
        self._last_t = max(self._last_t, inv)
        self._auto_t = max(self._auto_t, inv + 1)

    def _push(self, kind: int, t: int, payload: tuple) -> None:
        heapq.heappush(self._heap, (t, kind, self._heap_seq, payload))
        self._heap_seq += 1

    def _drain(self, final: bool) -> None:
        """Release buffered events up to the horizon (everything, on
        close) into the rows log and the frontiers."""
        while self._heap and (final or self._heap[0][0] <= self._horizon):
            t, kind, _, payload = heapq.heappop(self._heap)
            if kind == _K_INVOKE:
                pid, cmd, arg = payload
                if pid in self._row_of_pid:
                    raise SessionError(
                        f"session {self.sid}: pid {pid} invokes with "
                        "an outstanding op (one op per pid at a time)")
                key = self._key_for(cmd, arg)
                self._row_of_pid[pid] = len(self.rows)
                self._key_of_pid[pid] = key
                self.rows.append([pid, cmd, arg, -1, t, PENDING_T])
                f = self._frontier(key)
                if key is None:
                    f.invoke(pid, cmd, arg, t)
                else:
                    pcmd, parg, _ = self.spec.project_op(cmd, arg, 0)
                    f.invoke(pid, pcmd, parg, t)
                self._dirty.add(key)
            else:
                pid, resp = payload
                i = self._row_of_pid.pop(pid, None)
                if i is None:
                    raise SessionError(
                        f"session {self.sid}: pid {pid} responds with "
                        "no outstanding invocation")
                key = self._key_of_pid.pop(pid, None)
                self.rows[i][3] = resp
                self.rows[i][5] = t
                f = self._frontier(key)
                if key is None:
                    f.respond(pid, resp, t)
                else:
                    cmd, arg = self.rows[i][1], self.rows[i][2]
                    _, _, presp = self.spec.project_op(cmd, arg, resp)
                    f.respond(pid, presp, t)
                self._dirty.add(key)

    # -- per-key plumbing ----------------------------------------------
    def _key_for(self, cmd: int, arg: int) -> Optional[int]:
        if self.proj is None:
            return None
        key = self.spec.partition_key(cmd, arg)
        if key is None:
            raise SessionError(
                f"session {self.sid}: command {cmd} has no partition "
                "key (non-total projection reached a per-key session)")
        return int(key)

    def _frontier(self, key: Optional[int]) -> IncrementalFrontier:
        f = self._frontiers.get(key)
        if f is None:
            f = self._frontiers[key] = IncrementalFrontier(
                self.proj if key is not None else self.spec,
                bank=self.bank, node_budget=self.node_budget,
                max_states=self.max_states)
        return f

    # -- deciding -------------------------------------------------------
    def decide(self) -> int:
        """Advance + re-check every frontier an event touched since the
        last decide; returns the session verdict (worst across
        frontiers — the PComp aggregation rule).  Sets :attr:`flipped`
        (and snapshots the stream) the first time the verdict becomes
        VIOLATION; a flip is terminal (docs/MONITOR.md)."""
        if self.flipped:
            return int(Verdict.VIOLATION)
        batch: List[IncrementalFrontier] = []
        for key in sorted(self._dirty, key=lambda k: (k is None, k)):
            f = self._frontiers[key]
            if f.advance() != int(Verdict.VIOLATION):
                if self.engines is None:
                    f.check_window()
                else:
                    batch.append(f)
        if batch:
            # every touched window, one engine call a spec
            self.engines.check(batch)
        self._dirty.clear()
        verdict = int(Verdict.LINEARIZABLE)
        for f in self._frontiers.values():
            v = f.verdict
            if v == int(Verdict.VIOLATION):
                verdict = v
                break
            if v == int(Verdict.BUDGET_EXCEEDED):
                verdict = v
        if verdict == int(Verdict.VIOLATION) and not self.flipped:
            self.flipped = True
            self.flip_rows = [list(r) for r in self.rows]
            self._bank_recheck()
        return verdict

    def close(self) -> int:
        """Flush the reorder buffer, decide one last time, seal."""
        if not self.closed:
            self._drain(final=True)
            v = self.decide()
            self.closed = True
            return v
        return self.decide()

    # -- durability ------------------------------------------------------
    def to_doc(self) -> dict:
        """The session's COMPLETE resumable state as one JSON-safe doc
        (caller holds :attr:`lock`).  O(window + reorder buffer), not
        O(stream): the rows log rides along for flip repros, but the
        decided prefix itself is only its hash-chain state + frontier
        states — the banked prefix rows stay in the replog where they
        already live."""
        return {
            "sid": self.sid,
            "spec_name": self.spec.name,
            "spec_kwargs": self.spec.spec_kwargs(),
            "model": self.model,
            "model_kwargs": dict(self.spec_kwargs),
            "per_key": self.proj is not None,
            "rows": [list(r) for r in self.rows],
            "seq": self.seq,
            "closed": self.closed,
            "flipped": self.flipped,
            "flip_pushed": self.flip_pushed,
            "flip_rows": self.flip_rows,
            "row_of_pid": {str(p): i
                           for p, i in self._row_of_pid.items()},
            "key_of_pid": {str(p): k
                           for p, k in self._key_of_pid.items()},
            "heap": [[t, k, n, list(payload)]
                     for t, k, n, payload in self._heap],
            "heap_seq": self._heap_seq,
            "horizon": self._horizon,
            "last_t": self._last_t,
            "auto_t": self._auto_t,
            "frontiers": {("" if key is None else str(key)): f.to_doc()
                          for key, f in self._frontiers.items()},
        }

    @classmethod
    def from_doc(cls, doc: dict, spec: Spec, *,
                 proj_spec: Optional[Spec] = None,
                 bank=None,
                 node_budget: int = DEFAULT_NODE_BUDGET,
                 max_states: int = DEFAULT_MAX_STATES,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 trace: str = "", device=None, engine=None,
                 engines: Optional[WindowEngines] = None
                 ) -> "MonitorSession":
        """Inverse of :meth:`to_doc` — O(doc) deserialization, zero
        engine folds.  The caller passes the REBUILT spec (and
        projected spec) and must have checked identity against the
        doc's ``spec_name``/``spec_kwargs`` first; bank/oracle and the
        window re-check are re-bound process-locally."""
        s = cls(doc["sid"], spec, proj_spec=proj_spec, bank=bank,
                node_budget=node_budget, max_states=max_states,
                max_events=max_events, trace=trace, device=device,
                engine=engine, engines=engines)
        s.model = doc.get("model")
        s.spec_kwargs = dict(doc.get("model_kwargs") or {})
        s.rows = [list(r) for r in doc["rows"]]
        s.seq = int(doc["seq"])
        s.closed = bool(doc["closed"])
        s.flipped = bool(doc["flipped"])
        # the one attribute whose post-publication writes are
        # lock-guarded (the flip-push latch): restore it under the
        # same guard, keeping one discipline across every write site
        with s.lock:
            s.flip_pushed = bool(doc.get("flip_pushed", False))
        s.flip_rows = doc.get("flip_rows")
        s._row_of_pid = {int(p): int(i)
                         for p, i in doc["row_of_pid"].items()}
        s._key_of_pid = {int(p): (None if k is None else int(k))
                         for p, k in doc["key_of_pid"].items()}
        s._heap = [(int(t), int(k), int(n), tuple(payload))
                   for t, k, n, payload in doc["heap"]]
        heapq.heapify(s._heap)
        s._heap_seq = int(doc["heap_seq"])
        s._horizon = int(doc["horizon"])
        s._last_t = int(doc["last_t"])
        s._auto_t = int(doc["auto_t"])
        for kstr, fdoc in doc["frontiers"].items():
            key = None if kstr == "" else int(kstr)
            fspec = proj_spec if key is not None else spec
            s._frontiers[key] = IncrementalFrontier.from_doc(
                fdoc, fspec, bank=bank, node_budget=node_budget,
                max_states=max_states)
        return s

    # -- the devq seam --------------------------------------------------
    def _bank_recheck(self) -> None:
        """The device-work queue's monitor seam (``devq/``): a flip is
        terminal but was decided incrementally, so the flipped stream is
        banked for the next drain to re-prove as one whole-history
        check.  One global read when no queue is installed."""
        from ..devq.queue import bank_histories, global_devq

        if global_devq() is None or not self.rows:
            return
        bank_histories(self.spec, [self.history()], plane="monitor")

    # -- introspection --------------------------------------------------
    def history(self) -> History:
        """The stream so far as a canonical History (the ONE decoder,
        utils/report.py — identical rows to what a whole-history
        ``check`` of this stream would decode)."""
        from ..utils.report import history_from_rows

        return history_from_rows([list(r) for r in self.rows])

    def counters(self) -> Dict[str, int]:
        c = {"events": self.seq, "ops": len(self.rows),
             "frontiers": len(self._frontiers),
             "advances": 0, "prefix_hits": 0, "window_checks": 0,
             "committed_ops": 0, "window_ops": 0}
        for f in self._frontiers.values():
            c["advances"] += f.counters.advances
            c["prefix_hits"] += f.counters.prefix_hits
            c["window_checks"] += f.counters.window_checks
            c["committed_ops"] += f.counters.committed_ops
            c["window_ops"] += len(f.window)
        return c

    def window_stats(self) -> Dict[str, float]:
        """The window re-check's counters (:class:`WindowEngines`; shared
        with every session of a manager); empty on the host loop."""
        return self.engines.stats() if self.engines is not None else {}

    def snapshot(self) -> dict:
        v = (int(Verdict.VIOLATION) if self.flipped
             else self._worst_cached())
        return {"session": self.sid, "spec": self.spec.name,
                "per_key": self.proj is not None,
                "verdict": VERDICT_NAMES[v],
                "flipped": self.flipped, "closed": self.closed,
                **self.counters()}

    def _worst_cached(self) -> int:
        worst = int(Verdict.LINEARIZABLE)
        for f in self._frontiers.values():
            if f.verdict == int(Verdict.VIOLATION):
                return int(Verdict.VIOLATION)
            if f.verdict == int(Verdict.BUDGET_EXCEEDED):
                worst = int(Verdict.BUDGET_EXCEEDED)
        return worst


class SessionManager:
    """Bounded registry of live sessions + the monitor plane's running
    totals (the ``stats()`` session block and the SearchStats session
    counters both read here — one source, so metrics reconcile with
    stats by construction)."""

    def __init__(self, *, bank=None,
                 max_sessions: int = DEFAULT_MAX_SESSIONS,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 node_budget: int = DEFAULT_NODE_BUDGET,
                 max_states: int = DEFAULT_MAX_STATES,
                 idle_s: float = 3600.0,
                 store=None, device=None, engine=None):
        # one window re-check for every session: engines built once a
        # spec, so an open builds nothing (CUDA by default: raises
        # BackendUnavailable without a card; device="cpu": host loop)
        self.engines = window_engines(device, engine)
        self.device = device
        self.bank = bank
        # durable substrate (monitor/store.py SessionStore-shaped);
        # None = in-memory sessions only
        self.store = store
        self.max_sessions = max(1, int(max_sessions))
        self.max_events = int(max_events)
        self.node_budget = int(node_budget)
        self.max_states = int(max_states)
        # abandoned-session reclamation: a client that crashed without
        # closing must not pin a slot forever — when the cap is hit,
        # sessions idle past this are evicted LRU-first (their events
        # are replayable by seq and their prefixes stay banked, so an
        # evicted-then-returning client resumes by re-open + replay)
        self.idle_s = float(idle_s)
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, MonitorSession]" = OrderedDict()
        self._n = 0
        # running totals (live sessions' counters are folded in at
        # close so the totals never go backwards)
        self.opened = 0
        self.closed = 0
        self.resumed = 0             # open() calls that found a live sid
        self.restored = 0            # opens resumed from the durable store
        self.evicted = 0             # idle sessions reclaimed at cap
        self.flips_pushed = 0        # flip payloads handed to clients
        self._closed_events = 0
        self._closed_advances = 0
        self._closed_prefix_hits = 0

    # ------------------------------------------------------------------
    def open(self, sid: Optional[str], spec: Spec,
             proj_spec: Optional[Spec], *, trace: str = ""
             ) -> Tuple[MonitorSession, bool]:
        """Open (or resume) a session; ``(session, resumed)``.  A live
        sid re-opened against the SAME spec identity resumes (the
        router's failover replay and client reconnects depend on it);
        a different spec under the same sid is refused loudly."""
        with self._lock:
            if sid is not None and sid in self._sessions:
                s = self._sessions[sid]
                if (s.spec.name, s.spec.spec_kwargs()) != \
                        (spec.name, spec.spec_kwargs()):
                    raise SessionError(
                        f"session {sid} is open against "
                        f"{s.spec.name!r}; close it first")
                self._sessions.move_to_end(sid)
                s.last_used = time.monotonic()
                self.resumed += 1
                return s, True
            stale = self._pop_idle_locked() \
                if len(self._sessions) >= self.max_sessions else []
            full = len(self._sessions) >= self.max_sessions
        # fold evicted counters OUTSIDE the manager lock: the one
        # global order is session.lock BEFORE manager._lock (note_flip
        # runs under a handler-held session lock), so the manager must
        # never reach for a session lock while holding its own
        for s_old in stale:
            self._fold(s_old, evicted=True)
        # durable resume: a sid evicted at cap or lost to a
        # process restart comes back from the store in O(doc) — zero
        # engine folds; the journal tail replays seq-idempotently onto
        # banked prefixes.  Outside both locks: deserialization touches
        # no shared state until the session is registered below
        restored: Optional[MonitorSession] = None
        if sid is not None and self.store is not None:
            restored = self._restore(sid, spec, proj_spec, trace)
        with self._lock:
            if sid is not None and sid in self._sessions:
                # a racing open of the same sid won between our lock
                # holds: resume it (same-identity check as above)
                s = self._sessions[sid]
                if (s.spec.name, s.spec.spec_kwargs()) != \
                        (spec.name, spec.spec_kwargs()):
                    raise SessionError(
                        f"session {sid} is open against "
                        f"{s.spec.name!r}; close it first")
                self.resumed += 1
                return s, True
            if len(self._sessions) >= self.max_sessions:
                raise SessionLimit(
                    f"session cap {self.max_sessions} reached "
                    f"({len(self._sessions)} live) — close sessions "
                    "or raise max_sessions")
            if restored is not None:
                self._sessions[sid] = restored
                self.restored += 1
                return restored, True
            if sid is None:
                self._n += 1
                sid = f"s{self._n:06d}"
                while sid in self._sessions:  # caller-named collision
                    self._n += 1
                    sid = f"s{self._n:06d}"
            s = MonitorSession(sid, spec, proj_spec=proj_spec,
                               bank=self.bank,
                               node_budget=self.node_budget,
                               max_states=self.max_states,
                               max_events=self.max_events, trace=trace,
                               **self._engine_kw())
            s.store = self.store
            self._sessions[sid] = s
            self.opened += 1
        if self.store is not None:
            # seed the durable file before any batch journals against
            # it (an atomic rewrite, so it also resets a file whose
            # restore came back unreplayable).  Session lock, never
            # under the manager's — the one global order
            with s.lock:
                self.store.snapshot(sid, s.to_doc())
        return s, False

    def _restore(self, sid: str, spec: Spec,
                 proj_spec: Optional[Spec], trace: str
                 ) -> Optional[MonitorSession]:
        """Rebuild ``sid`` from the durable store; None on a miss or an
        unreplayable file (the open proceeds fresh and re-seeds it).
        Same identity gate as the live-resume path — a durable doc for
        a DIFFERENT spec is refused loudly, never silently shadowed.
        The store binds only AFTER the tail replays, so the replay
        never re-journals its own batches."""
        loaded = self.store.load(sid)
        if loaded is None:
            return None
        doc, tail = loaded
        if (doc.get("spec_name"), doc.get("spec_kwargs")) != \
                (spec.name, spec.spec_kwargs()):
            raise SessionError(
                f"session {sid} is durable against "
                f"{doc.get('spec_name')!r}; close it first")
        try:
            s = MonitorSession.from_doc(
                doc, spec, proj_spec=proj_spec, bank=self.bank,
                node_budget=self.node_budget,
                max_states=self.max_states,
                max_events=self.max_events, trace=trace,
                **self._engine_kw())
            for batch in tail:
                s.append(batch["events"], seq=batch["seq"])
        except (KeyError, TypeError, ValueError, SessionLimit):
            return None
        s.store = self.store
        return s

    def _engine_kw(self) -> dict:
        # the shared engines, or (host loop) the device that says so
        return ({"engines": self.engines} if self.engines is not None
                else {"device": self.device})

    def _pop_idle_locked(self) -> List[MonitorSession]:
        """Pop sessions idle past ``idle_s``, LRU-first (caller holds
        ``_lock``; no session locks touched here — the fold happens
        outside, in the one global lock order).  An evicted client
        resumes by re-open + seq replay with its banked prefixes
        intact.

        With a durable store the cap bounds MEMORY, not open sessions:
        if nothing is idle, the LRU session is evicted to the store
        anyway (its file is already current — every append journals —
        so a returning client restores in O(doc) with zero folds).
        Without a store the cap stays hard and the open raises
        SessionLimit."""
        now = time.monotonic()
        victims = [k for k, s in self._sessions.items()
                   if now - s.last_used >= self.idle_s]
        if not victims and self.store is not None and self._sessions:
            victims = [next(iter(self._sessions))]  # LRU: oldest entry
        return [self._sessions.pop(sid) for sid in victims]

    def _fold(self, s: MonitorSession, evicted: bool = False) -> None:
        """Fold a departing session's counters into the running totals
        (session lock taken BEFORE the manager lock — the one order)."""
        with s.lock:
            c = s.counters()
        with self._lock:
            if evicted:
                self.evicted += 1
            else:
                self.closed += 1
            self._closed_events += c["events"]
            self._closed_advances += c["advances"]
            self._closed_prefix_hits += c["prefix_hits"]

    def get(self, sid: str) -> Optional[MonitorSession]:
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None:
                self._sessions.move_to_end(sid)
                s.last_used = time.monotonic()
            return s

    def close(self, sid: str) -> Optional[MonitorSession]:
        with self._lock:
            s = self._sessions.pop(sid, None)
        if s is None:
            return None
        self._fold(s)
        if self.store is not None:
            # a closed session answered its verdict; nothing resumes it
            self.store.drop(sid)
        return s

    def note_flip(self) -> None:
        with self._lock:
            self.flips_pushed += 1

    # -- accounting ----------------------------------------------------
    def totals(self) -> Dict[str, int]:
        with self._lock:
            live = list(self._sessions.values())
            out = {"sessions_live": len(live),
                   "opened": self.opened, "closed": self.closed,
                   "resumed": self.resumed, "restored": self.restored,
                   "evicted": self.evicted,
                   "session_events": self._closed_events,
                   "frontier_advances": self._closed_advances,
                   "prefix_hits": self._closed_prefix_hits,
                   "flips_pushed": self.flips_pushed}
        # per-session locks taken OUTSIDE the manager lock (and never
        # the other way around here): note_flip holds a session lock
        # while taking the manager's, so nesting them here would be a
        # lock-order cycle
        for s in live:
            with s.lock:
                c = s.counters()
            out["session_events"] += c["events"]
            out["frontier_advances"] += c["advances"]
            out["prefix_hits"] += c["prefix_hits"]
        return out

    def search_stats(self):
        """The monitor plane's SearchStats record (search/stats.py):
        the four session counters under their compact keys, so bench
        rows carry the same numbers the session block reports."""
        from ..search.stats import SearchStats

        t = self.totals()
        return SearchStats(engine="monitor",
                           session_events=t["session_events"],
                           frontier_advances=t["frontier_advances"],
                           flips_pushed=t["flips_pushed"],
                           prefix_hits=t["prefix_hits"])

    def snapshot(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
        live = []
        for s in sessions:  # session locks outside the manager lock
            with s.lock:
                live.append(s.snapshot())
        return {**self.totals(), "max_sessions": self.max_sessions,
                "max_events": self.max_events, "live": live}
