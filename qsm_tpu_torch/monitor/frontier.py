"""Incremental per-session frontier — linearizability decided as events arrive.

The counterpart of the JAX package's ``qsm_tpu/monitor/frontier.py``,
with the window re-check batched on the card (below).

The decrease-and-conquer monitoring shape (PAPERS.md: arXiv:2410.04581;
the same quiescent-cut algebra ``ops/segdc.py`` uses for batch work,
run FORWARD over a growing event stream instead of backward over a
finished history):

* events append in real-time order (the session layer enforces
  monotonic timestamps), so a **committed quiescent cut stays a cut
  forever** — every later op invokes after every earlier response;
* whenever the open window grows a new quiescent cut, the completed
  segment behind it is folded into the frontier: ``F' = end_states(seg,
  F)`` (ops/segdc.py ``_end_states`` — ALL model states reachable by
  some complete valid linearization; natively, ``CppOracle.end_states``,
  where ``g++`` builds it, as ``SegDC`` folds its middles).  ``F' = ∅``
  is an exact
  VIOLATION of the whole stream so far (segdc's block-decomposition
  iff); a non-empty ``F'`` banks in the verdict cache under the
  prefix's **incremental fingerprint** (:class:`PrefixHasher` — a
  rolling sha256, so a growing prefix never re-hashes from scratch)
  with the frontier states riding the row, and the committed ops leave
  the window (the decided-prefix eviction that keeps a long-lived
  session's memory O(window), not O(stream));
* the open window (pending ops allowed; no internal cuts) is re-checked
  for satisfiability from the frontier states only (segdc's
  final-segment rule), so re-deciding after k appended events costs o(n)
  engine work on an n-event stream.  :meth:`IncrementalFrontier.
  check_window` is the reference's host loop, ``oracle.check_from`` per
  state; :class:`WindowEngines` decides the windows of many frontiers
  as ONE device batch, a lane per (window, frontier state), through
  ``check_histories(spec, windows, init_states=states)``, as ``SegDC``
  decides its final segments.  A lane the card leaves undecided is
  decided again by the same ``oracle.check_from`` the reference calls,
  so the verdict is the reference's, never the stepper's iteration
  budget.

**Verdict exactness.**  LINEARIZABLE ⟺ some frontier chain reaches a
satisfiable window (segdc's iff).  A VIOLATION is *stable under
extension*: every new op invokes after every already-completed op's
response, so any linearization of the extended stream, truncated at its
first new op, is a linearization of the old stream with trailing
pendings pruned — if none existed before, none exists after
(docs/MONITOR.md "Why a flip is final").  The monitor therefore treats
VIOLATION as terminal, and a session's final verdict equals the
whole-history ``check`` verdict bit-for-bit (the parity pins).

**Prefix banking / resume.**  A committed prefix banks
``verdict=LINEARIZABLE`` with the frontier state set encoded in the
row's witness slot (:func:`encode_frontier_states` — prefix keys live
in their own fingerprint domain, disjoint from check rows, so no
``verify_witness`` consumer ever sees one).  Re-feeding the same event
stream — a client resuming after a node restart, a router replaying a
session onto a respawned node — advances cut-by-cut on bank hits with
ZERO engine work (``prefix_hits`` counts them).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.history import History, Op
from ..core.spec import Spec
from ..ops.backend import DeviceDispatchError, Verdict
from ..ops.segdc import _Budget, default_middle_oracle
from ..ops.segdc import _end_states as _walk_end_states
from ..sched.runner import PENDING_T

# the prefix rows' own fingerprint domain: a prefix key can never
# collide with serve.cache.fingerprint_key's (spec, whole-history) doc.
# The reference's string, so that both packages key a prefix alike (v2:
# the hash-chain form)
_PREFIX_DOMAIN = "qsm_tpu_monitor_prefix_v2"
# witness-slot header tag for encoded frontier state sets
_FRONTIER_TAG = -7741

# bounded by contract: a frontier state set past this cap stops cut-committing (the window
# keeps growing toward the session's own event cap instead — honest
# degradation, never an unbounded set)
DEFAULT_MAX_STATES = 64
DEFAULT_NODE_BUDGET = 2_000_000


def _end_states(spec: Spec, seg: Sequence[Op],
                starts: Set[Tuple[int, ...]], budget: _Budget,
                oracle=None) -> Optional[Set[Tuple[int, ...]]]:
    """The engine fold of one committed segment: every end state
    reachable from ``starts``, or None when ``budget`` runs out.
    ``oracle.end_states`` (the native enumerator) first, as ``SegDC``
    folds its middles; a None answer there (outside its domain, its
    output cap or the budget) falls through to the Python walk with the
    charged-down budget."""
    native = getattr(oracle, "end_states", None)
    if native is not None:
        nxt = native(spec, list(seg), starts, budget=budget)
        if nxt is not None:
            return nxt
    return _walk_end_states(spec, list(seg), starts, budget)


class PrefixHasher:
    """Rolling sha256 HASH CHAIN over a spec identity header plus each
    committed op: ``state_{k+1} = sha256(state_k || op_k)``.  ``key()``
    is O(1) (the state IS the key), so the n-th prefix fingerprint
    never re-hashes the n-1 ops before it — and unlike a streaming
    digest object, the chain state is one hex string that round-trips
    through JSON, which is what lets a DURABLE session
    (monitor/store.py) resume its fingerprint mid-stream after a
    process restart without replaying the prefix."""

    def __init__(self, spec: Spec):
        self.state = hashlib.sha256(json.dumps(
            [_PREFIX_DOMAIN, spec.name, spec.spec_kwargs()],
            sort_keys=True).encode()).hexdigest()
        self.ops_hashed = 0

    def push(self, op: Op) -> None:
        self.state = hashlib.sha256(
            (self.state + json.dumps(
                [op.pid, op.cmd, op.arg, op.resp, op.invoke_time,
                 op.response_time])).encode()).hexdigest()
        self.ops_hashed += 1

    def key(self) -> str:
        return self.state

    def copy(self) -> "PrefixHasher":
        return PrefixHasher.from_state(self.state, self.ops_hashed)

    @classmethod
    def from_state(cls, state: str, ops_hashed: int) -> "PrefixHasher":
        """Rebuild a hasher mid-chain (durable-session resume)."""
        h = cls.__new__(cls)
        h.state = str(state)
        h.ops_hashed = int(ops_hashed)
        return h


def encode_frontier_states(states: Sequence[Tuple[int, ...]]) -> List[list]:
    """Frontier state set → the bank row's witness-slot encoding:
    ``[[_FRONTIER_TAG, state_dim], *states]`` (sorted — deterministic
    rows compact/replicate byte-stably)."""
    states = sorted(tuple(int(v) for v in s) for s in states)
    dim = len(states[0]) if states else 0
    return [[_FRONTIER_TAG, dim]] + [list(s) for s in states]


def decode_frontier_states(witness) -> Optional[Set[Tuple[int, ...]]]:
    """Inverse of :func:`encode_frontier_states`; None when the slot
    holds anything else (an alien row must never masquerade as a
    frontier)."""
    if not witness:
        return None
    head = list(witness[0])
    if len(head) != 2 or head[0] != _FRONTIER_TAG:
        return None
    dim = int(head[1])
    out: Set[Tuple[int, ...]] = set()
    for row in list(witness)[1:]:
        s = tuple(int(v) for v in row)
        if len(s) != dim:
            return None
        out.add(s)
    return out if out else None


@dataclasses.dataclass
class FrontierCounters:
    """One frontier's cost/shape record (session + SearchStats feed)."""

    events: int = 0            # ops applied (invokes; responses update)
    advances: int = 0          # quiescent cuts committed
    prefix_hits: int = 0       # cuts committed from the bank, zero engine
    window_checks: int = 0     # satisfiability re-checks of the window
    committed_ops: int = 0     # ops evicted behind the committed cut
    states: int = 0            # current frontier state-set size


class IncrementalFrontier:
    """One spec's incremental frontier (module docstring).  The session
    layer owns event validation and ordering; this class owns the cut
    algebra, the bank hand-off and the window re-check."""

    def __init__(self, spec: Spec, *, bank=None, oracle=None,
                 node_budget: int = DEFAULT_NODE_BUDGET,
                 max_states: int = DEFAULT_MAX_STATES):
        self.spec = spec
        self.bank = bank                     # VerdictCache-shaped get/put
        # the host from-state engine: the native C++ checker when the
        # toolchain is present, else the memoised Python oracle —
        # exactly SegDC's ladder (ops/segdc.py default_middle_oracle)
        self.oracle = oracle or default_middle_oracle(spec)
        self.node_budget = int(node_budget)
        self.max_states = max(1, int(max_states))
        self.window: List[Op] = []           # open ops, invoke order
        self.states: Set[Tuple[int, ...]] = {
            tuple(int(v) for v in spec.initial_state())}
        self.hasher = PrefixHasher(spec)
        self.counters = FrontierCounters(states=1)
        self.verdict = int(Verdict.LINEARIZABLE)  # empty stream: vacuous
        self._saturated = False  # state-set cap hit: stop committing cuts
        # pid -> window index of its one outstanding op.  Pendings block
        # every later cut, so they never commit out of the window; their
        # indices only SHIFT on eviction (adjusted in advance()).
        self._pending: Dict[int, int] = {}

    # -- event application --------------------------------------------
    def invoke(self, pid: int, cmd: int, arg: int, t: int) -> None:
        """One invocation whose time is >= every event already applied
        (the session layer enforces the order and the one-outstanding-
        op-per-pid history model)."""
        self._pending[pid] = len(self.window)
        self.window.append(make_pending_op(pid, cmd, arg, t))
        self.counters.events += 1

    def respond(self, pid: int, resp: int, t: int) -> bool:
        """Complete ``pid``'s outstanding op (Op is frozen — replaced
        in place); False when the pid has none here."""
        i = self._pending.pop(pid, None)
        if i is None:
            return False
        self.window[i] = dataclasses.replace(
            self.window[i], resp=resp, response_time=t)
        return True

    def append_completed(self, op: Op) -> None:
        """One already-completed op (ingested rows, replayed streams)
        whose invoke_time respects the arrival order."""
        self.window.append(op)
        self.counters.events += 1

    # -- the frontier step --------------------------------------------
    def advance(self) -> int:
        """Commit every quiescent cut the window now contains (bank
        hits first, engine folds otherwise); returns the frontier
        verdict — VIOLATION the moment some committed fold empties the
        state set.  Cheap no-op when no new cut exists."""
        if self.verdict == int(Verdict.VIOLATION):
            return self.verdict
        while not self._saturated:
            cut = self._first_cut()
            if cut is None:
                break
            seg = self.window[:cut]
            # key of the prefix INCLUDING this segment, via a peek copy
            # (the live hasher only advances on a successful commit)
            peek = self._peek_hasher(seg)
            key = peek.key()
            nxt = self._bank_get(key)
            if nxt is not None:
                self.counters.prefix_hits += 1
            else:
                budget = _Budget(self.node_budget)
                nxt = _end_states(self.spec, seg, self.states, budget,
                                  self.oracle)
                if nxt is None:
                    # budget blown mid-fold: leave the cut uncommitted
                    # (the window re-check still answers, just from an
                    # older frontier) — never guess, never wedge
                    break
                if not nxt:
                    self.verdict = int(Verdict.VIOLATION)
                    return self.verdict
                if len(nxt) > self.max_states:
                    # bounded by contract: an exploding frontier stops
                    # cut-committing instead of growing without cap
                    self._saturated = True
                    break
                self._bank_put(key, nxt)
            self.hasher = peek
            self.window = self.window[cut:]
            # every pending op sits at index >= cut (a pending blocks
            # all later cuts), so the shift can never go negative
            self._pending = {p: i - cut for p, i in self._pending.items()}
            self.states = nxt
            self.counters.advances += 1
            self.counters.committed_ops += cut
            self.counters.states = len(nxt)
        return self.verdict

    def _peek_hasher(self, seg: Sequence[Op]) -> PrefixHasher:
        peek = self.hasher.copy()
        for op in seg:
            peek.push(op)
        return peek

    def _first_cut(self) -> Optional[int]:
        """Smallest i>0 such that every window op before i responded
        before window op i invoked (pending = sentinel, blocks all
        later cuts)."""
        max_resp = -1
        for i, op in enumerate(self.window):
            if i and max_resp < op.invoke_time:
                return i
            max_resp = max(max_resp, op.response_time)
        return None

    # -- the window re-check ------------------------------------------
    def check_window(self) -> int:
        """Satisfiability of the open window from the frontier states
        (segdc's final-segment rule): LINEARIZABLE from ANY state wins;
        all states VIOLATION is an exact stream violation; any budget
        blow-up stays honestly undecided."""
        if self.verdict == int(Verdict.VIOLATION):
            return self.verdict
        if not self.window:
            self.verdict = int(Verdict.LINEARIZABLE)
            return self.verdict
        self.counters.window_checks += 1
        return self._check_on_host(History(list(self.window)))

    def _check_on_host(self, last: History) -> int:
        saw_budget = False
        # sorted: deterministic state try-order (replayable cost records)
        for state in sorted(self.states):
            v = self.oracle.check_from(self.spec, last,
                                       np.asarray(state, np.int32))
            if v == Verdict.LINEARIZABLE:
                self.verdict = int(Verdict.LINEARIZABLE)
                return self.verdict
            if v == Verdict.BUDGET_EXCEEDED:
                saw_budget = True
        self.verdict = int(Verdict.BUDGET_EXCEEDED if saw_budget
                           else Verdict.VIOLATION)
        return self.verdict

    # -- the window re-check as device lanes (WindowEngines) -----------
    def window_lanes(self) -> Optional[Tuple[History,
                                             List[Tuple[int, ...]]]]:
        """What :meth:`check_window` would search, as lanes: the window
        and the sorted frontier states, counted as one window check;
        None when no search is needed (a VIOLATION stays, an empty
        window is vacuously LINEARIZABLE)."""
        if self.verdict == int(Verdict.VIOLATION):
            return None
        if not self.window:
            self.verdict = int(Verdict.LINEARIZABLE)
            return None
        self.counters.window_checks += 1
        return History(list(self.window)), sorted(self.states)

    def settle_lanes(self, last: History, states: List[Tuple[int, ...]],
                     verdicts: Sequence[int]) -> int:
        """Fold the lanes of :meth:`window_lanes` into the verdict the
        host loop reaches: LINEARIZABLE from any state wins; a lane left
        undecided is decided again by the host oracle's ``check_from``
        (in state order, until one is LINEARIZABLE); then any undecided
        lane leaves BUDGET_EXCEEDED, else VIOLATION.  Returns how many
        lanes the host decided again."""
        verdicts = [int(v) for v in verdicts]
        if int(Verdict.LINEARIZABLE) in verdicts:
            self.verdict = int(Verdict.LINEARIZABLE)
            return 0
        redecided = 0
        saw_budget = False
        for state, v in zip(states, verdicts):
            if v != int(Verdict.BUDGET_EXCEEDED):
                continue
            redecided += 1
            v = int(self.oracle.check_from(self.spec, last,
                                           np.asarray(state, np.int32)))
            if v == int(Verdict.LINEARIZABLE):
                self.verdict = v
                return redecided
            if v == int(Verdict.BUDGET_EXCEEDED):
                saw_budget = True
        self.verdict = int(Verdict.BUDGET_EXCEEDED if saw_budget
                           else Verdict.VIOLATION)
        return redecided

    # -- bank plumbing -------------------------------------------------
    def _bank_get(self, key: str) -> Optional[Set[Tuple[int, ...]]]:
        if self.bank is None:
            return None
        e = self.bank.get(key)
        if e is None or e.verdict != int(Verdict.LINEARIZABLE):
            return None
        return decode_frontier_states(e.witness)

    def _bank_put(self, key: str, states: Set[Tuple[int, ...]]) -> None:
        if self.bank is None:
            return
        self.bank.put(key, int(Verdict.LINEARIZABLE),
                      encode_frontier_states(states))

    # -- durability ----------------------------------------------------
    def to_doc(self) -> dict:
        """The frontier's COMPLETE resumable state as one JSON-safe doc:
        window ops as 6-rows, frontier states, the hash-chain state,
        pending indices, counters, verdict, saturation.  The bank and
        oracle are NOT in the doc — they are process-local substrate the
        restorer re-binds (the banked prefix rows themselves already
        ride the replog)."""
        return {
            "window": [[op.pid, op.cmd, op.arg, op.resp,
                        op.invoke_time, op.response_time]
                       for op in self.window],
            "states": sorted([int(v) for v in s] for s in self.states),
            "hash_state": self.hasher.state,
            "ops_hashed": self.hasher.ops_hashed,
            "pending": {str(p): i for p, i in self._pending.items()},
            "verdict": self.verdict,
            "saturated": self._saturated,
            "counters": dataclasses.asdict(self.counters),
        }

    @classmethod
    def from_doc(cls, doc: dict, spec: Spec, *, bank=None, oracle=None,
                 node_budget: int = DEFAULT_NODE_BUDGET,
                 max_states: int = DEFAULT_MAX_STATES
                 ) -> "IncrementalFrontier":
        """Inverse of :meth:`to_doc`: O(doc) deserialization, ZERO
        engine folds — the committed prefix resumes as its hash-chain
        state plus the frontier state set, never as a replay."""
        f = cls(spec, bank=bank, oracle=oracle,
                node_budget=node_budget, max_states=max_states)
        f.window = [
            Op(pid=int(r[0]), cmd=int(r[1]), arg=int(r[2]),
               resp=int(r[3]), invoke_time=int(r[4]),
               response_time=int(r[5]))
            for r in doc["window"]]
        f.states = {tuple(int(v) for v in s) for s in doc["states"]}
        f.hasher = PrefixHasher.from_state(doc["hash_state"],
                                           doc["ops_hashed"])
        f._pending = {int(p): int(i)
                      for p, i in doc.get("pending", {}).items()}
        f.verdict = int(doc["verdict"])
        f._saturated = bool(doc.get("saturated", False))
        f.counters = FrontierCounters(
            **{k: int(v) for k, v in doc.get("counters", {}).items()})
        return f

    # -- introspection -------------------------------------------------
    def snapshot(self) -> dict:
        c = self.counters
        return {"window_ops": len(self.window),
                "committed_ops": c.committed_ops,
                "advances": c.advances,
                "prefix_hits": c.prefix_hits,
                "window_checks": c.window_checks,
                "states": len(self.states),
                "saturated": self._saturated,
                "verdict": self.verdict}


def make_pending_op(pid: int, cmd: int, arg: int, invoke_time: int) -> Op:
    """A just-invoked op (no response yet) — the monitor's unit of
    arrival; :meth:`IncrementalFrontier.complete_op` fills it in."""
    return Op(pid=pid, cmd=cmd, arg=arg, resp=-1,
              invoke_time=invoke_time, response_time=PENDING_T)


class WindowEngines:
    """The windows of many frontiers re-checked as one device batch.

    One checker per spec identity (``make_engine(spec)``, built at its
    first use and kept for every session that shares this object: a
    :class:`~qsm_tpu_torch.monitor.session.SessionManager` keeps one, so
    opening a session builds nothing).  :meth:`check` takes the
    frontiers one ``decide()`` touched and makes one
    ``check_histories(spec, windows, init_states=states)`` call per spec:
    a lane per (window, frontier state).  Windows longer than
    ``max_ops`` (the engine's op cap) are checked by the host loop.
    Nothing here decides around an engine error: with ``on_card`` (the
    engines run on the card) a failing call raises out of ``decide()`` as
    ``DeviceDispatchError``, so a server answers it as the card's failure;
    otherwise the error raises as it is.

    Counters: ``calls`` (engine calls), ``lanes`` (lanes sent),
    ``redecided`` (undecided lanes decided again on the host),
    ``host_windows`` (windows over the op cap) and ``seconds`` (wall
    time inside :meth:`check`)."""

    def __init__(self, make_engine: Callable, max_ops: Optional[int] = None,
                 on_card: bool = False):
        if max_ops is None:
            from ..ops.stepper_kernel import MAX_OPS

            max_ops = MAX_OPS
        self.max_ops = int(max_ops)
        self._make = make_engine
        self.on_card = on_card
        self._engines: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.calls = 0
        self.lanes = 0
        self.redecided = 0
        self.host_windows = 0
        self.seconds = 0.0

    @staticmethod
    def _identity(spec: Spec) -> str:
        return json.dumps([spec.name, spec.spec_kwargs()], sort_keys=True)

    def engine_for(self, spec: Spec):
        key = self._identity(spec)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = self._make(spec)
        return eng

    def check(self, frontiers: Sequence["IncrementalFrontier"]) -> None:
        """Re-check the windows of ``frontiers`` (none of them at
        VIOLATION after its advance), one engine call per spec.

        The frontiers are the caller's: its session's lock guards them,
        so their windows are read and their verdicts settled outside
        ``_lock``, which guards only what sessions share here — the
        engines, their calls and the counters."""
        t0 = time.perf_counter()
        groups: Dict[str, list] = {}
        host = []
        for f in frontiers:
            lanes = f.window_lanes()
            if lanes is None:
                continue
            last, states = lanes
            if len(last) > self.max_ops:
                host.append((f, last))
                continue
            groups.setdefault(self._identity(f.spec), []).append(
                (f, last, states))
        for f, last in host:
            f._check_on_host(last)
        answered = []
        with self._lock:
            self.host_windows += len(host)
            for items in groups.values():
                eng = self.engine_for(items[0][0].spec)
                windows: List[History] = []
                inits: List[np.ndarray] = []
                for _, last, states in items:
                    windows.extend([last] * len(states))
                    inits.extend(np.asarray(st, np.int32) for st in states)
                try:
                    verdicts = eng.check_histories(eng.spec, windows,
                                                   init_states=inits)
                except Exception as e:
                    if not self.on_card:
                        raise
                    raise DeviceDispatchError(
                        f"{type(e).__name__}: {e}") from e
                self.calls += 1
                self.lanes += len(windows)
                answered.append((items, verdicts))
        redecided = 0
        for items, verdicts in answered:
            at = 0
            for f, last, states in items:
                n = len(states)
                redecided += f.settle_lanes(last, states,
                                            verdicts[at:at + n])
                at += n
        with self._lock:
            self.redecided += redecided
            self.seconds += time.perf_counter() - t0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"calls": self.calls, "lanes": self.lanes,
                    "redecided": self.redecided,
                    "host_windows": self.host_windows,
                    "seconds": self.seconds,
                    "engines": len(self._engines)}


def window_engines(device=None, engine=None) -> Optional[WindowEngines]:
    """The window re-check a session or manager takes: ``engine`` (a
    factory spec -> checker) batched; else
    ``TorchStepper`` on ``device`` (CUDA by default: raises
    ``BackendUnavailable`` without a card) batched; ``device="cpu"``
    gives None, the reference's host loop."""
    if engine is not None:
        return WindowEngines(engine)
    from ..ops.backend import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return None
    from ..ops.stepper import TorchStepper

    return WindowEngines(lambda spec: TorchStepper(spec, device=dev),
                         on_card=True)
