"""Decrease-and-conquer segmentation: long histories split at quiescent
cuts.

The counterpart of the JAX package's ``qsm_tpu/ops/segdc.py``.  The cost
of the interleaving search is exponential in the history's length, so
decompose a history into shorter independent problems wherever its
real-time order allows.

A **quiescent cut** is a position where every earlier operation's
response precedes every later operation's invocation.  Any linearization
orders the two sides as blocks, so for ``H = S1 · S2 · … · Sk``:

    H linearizable from s0
        ⟺  ∃ s1 ∈ endstates(S1, s0): ∃ s2 ∈ endstates(S2, s1): … Sk sat.

Cuts are a property of each history (a concurrency-dense one may have
none: the inner backend then decides it whole).  Segment checking
threads a frontier of model states:

* middle segments (never pending: a pending op forbids every later cut)
  are searched exhaustively per frontier state for their reachable end
  states, natively (``CppOracle.end_states``) when the spec has a native
  route, else by a memoised Python walk;
* the final segment (pending ops allowed) needs satisfiability only:
  ``check_from`` on the host, or, when the inner backend's
  ``check_histories`` takes ``init_states`` (``TorchStepper``), one
  batched device call deciding every (final segment × frontier state)
  pair of the whole input batch at once.

Exactness: verdicts equal the plain oracle's on every history, with
BUDGET_EXCEEDED when the node budget runs out, never a guess.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.history import History, Op
from ..core.spec import Spec
from .backend import LineariseBackend, Verdict
from .wing_gong_cpu import WingGongCPU


def split_at_quiescent_cuts(history: History) -> List[List[Op]]:
    """Invoke-ordered segments; a cut sits before op i iff every earlier
    op's response_time < op i's invoke_time.  Pending ops (sentinel
    response_time) forbid all later cuts, so they always land in the final
    segment."""
    ops = sorted(history.ops, key=lambda o: o.invoke_time)
    segments: List[List[Op]] = []
    current: List[Op] = []
    max_resp = -1
    for op in ops:
        if current and max_resp < op.invoke_time:
            segments.append(current)
            current = []
        current.append(op)
        max_resp = max(max_resp, op.response_time)
    if current:
        segments.append(current)
    return segments


class _Budget:
    __slots__ = ("left",)

    def __init__(self, n: int):
        self.left = n


def _end_states(spec: Spec, ops: List[Op], starts: Set[Tuple[int, ...]],
                budget: _Budget) -> Optional[Set[Tuple[int, ...]]]:
    """All model states reachable by SOME complete valid linearization of
    ``ops`` (no pending ops) from any state in ``starts``; None on budget
    exhaustion.  Memoised on (taken mask, state) per start, so shared
    subtrees are walked once."""
    n = len(ops)
    prec_pairs: List[List[int]] = [
        [i for i in range(n) if ops[i].response_time < ops[j].invoke_time]
        for j in range(n)
    ]
    full = (1 << n) - 1
    out: Set[Tuple[int, ...]] = set()
    for start in starts:
        seen: Set[Tuple[int, Tuple[int, ...]]] = set()

        def dfs(taken: int, state: Tuple[int, ...]) -> bool:
            """Explore; False on budget exhaustion."""
            if taken == full:
                out.add(state)
                return True
            if (taken, state) in seen:
                return True
            seen.add((taken, state))
            for j in range(n):
                if taken & (1 << j):
                    continue
                if any(not taken & (1 << i) for i in prec_pairs[j]):
                    continue
                budget.left -= 1
                if budget.left <= 0:
                    return False
                op = ops[j]
                new_state, ok = spec.step_py(list(state), op.cmd, op.arg,
                                             op.resp)
                if not ok:
                    continue
                if not dfs(taken | (1 << j),
                           tuple(int(v) for v in new_state)):
                    return False
            return True

        if not dfs(0, start):
            return None
    return out


def default_middle_oracle(spec: Spec):
    """SegDC's default middle-segment enumerator: the native checker when
    it builds and has a native route for ``spec``
    (``CppOracle.can_enumerate``), else the memoised Python oracle.  A
    native checker without a route would answer None for every middle
    and send each to the Python walk, while callers (``ops/router.py``)
    set their caps for native costs."""
    from ..native import CppOracle, native_available

    if native_available():
        cpp = CppOracle(spec)
        if cpp.can_enumerate():
            return cpp
    return WingGongCPU(memo=True)


class SegDC:
    """Backend combinator: split each history at quiescent cuts, thread
    the frontier of reachable model states through the segments; a
    history with no cut goes to the inner backend whole (the combinator
    never makes a history harder).

    ``device_final`` (None: detected from whether the inner
    ``check_histories`` takes ``init_states``) decides the final
    segments in one batched inner call; otherwise each goes to the
    middle oracle's ``check_from``.  The combinator catches no error of
    the inner backend."""

    def __init__(self, spec: Spec,
                 make_inner: Optional[Callable] = None,
                 node_budget: int = 10_000_000,
                 oracle=None,
                 device_final: Optional[bool] = None):
        self.spec = spec
        self.inner: LineariseBackend = (
            make_inner(spec) if make_inner is not None
            else WingGongCPU(memo=True))
        self.oracle = oracle or default_middle_oracle(spec)
        if device_final is None:
            try:
                device_final = "init_states" in inspect.signature(
                    self.inner.check_histories).parameters
            except (TypeError, ValueError):
                device_final = False
        self.device_final = bool(device_final)
        self.node_budget = node_budget
        self.name = f"segdc({self.inner.name})"
        self.segments_split = 0    # histories that actually cut
        self.segments_total = 0    # segments across them
        self.final_states_device = 0  # (segment × state) lanes sent inner
        self.segments_native = 0   # middle segments enumerated natively
        self.histories_seen = 0    # inputs (whole + split)
        self.middle_nodes = 0      # host nodes spent enumerating middles

    def check_histories(self, spec: Spec, histories: Sequence[History]
                        ) -> np.ndarray:
        assert spec is self.spec, "SegDC is bound to one spec"
        self.histories_seen += len(histories)
        out = np.empty(len(histories), np.int8)
        whole: List[int] = []   # indices delegated to the inner backend
        # (index, final-segment history, sorted frontier states) of the
        # histories whose middle segments resolved: their finals are
        # decided together below
        finals: List[Tuple[int, History, List[Tuple[int, ...]]]] = []
        native_ends = getattr(self.oracle, "end_states", None)
        for i, h in enumerate(histories):
            segs = split_at_quiescent_cuts(h)
            if len(segs) <= 1:
                whole.append(i)
                continue
            self.segments_split += 1
            self.segments_total += len(segs)
            budget = _Budget(self.node_budget)
            frontier: Set[Tuple[int, ...]] = {
                tuple(int(v) for v in spec.initial_state())}
            verdict: Optional[Verdict] = None
            for seg in segs[:-1]:
                nxt = None
                if native_ends is not None:
                    # a None answer (segment outside the native domain,
                    # budget or output cap) falls through to the Python
                    # walk, which resumes with the charged-down budget
                    nxt = native_ends(spec, seg, frontier, budget=budget)
                    if nxt is not None:
                        self.segments_native += 1
                if nxt is None:
                    nxt = _end_states(spec, seg, frontier, budget)
                if nxt is None:
                    verdict = Verdict.BUDGET_EXCEEDED
                    break
                if not nxt:
                    verdict = Verdict.VIOLATION
                    break
                frontier = nxt
            self.middle_nodes += self.node_budget - budget.left
            if verdict is not None:
                out[i] = int(verdict)
                continue
            last = History(segs[-1], seed=h.seed, program_id=h.program_id)
            # sorted: set order varies from run to run; the device batch
            # layout must not
            finals.append((i, last, sorted(frontier)))
        if finals:
            if self.device_final:
                self._resolve_finals_device(spec, finals, out)
            else:
                for i, last, states in finals:
                    out[i] = int(self._final_on_oracle(spec, last, states))
        if whole:
            sub = self.inner.check_histories(
                spec, [histories[i] for i in whole])
            for i, v in zip(whole, sub):
                out[i] = v
        return out

    def search_stats(self):
        """Segment accounting plus the inner engine's own counters: a
        decomposition's cost is the middles' host nodes and whatever the
        inner backend paid on finals and uncut wholes."""
        from ..search.stats import SearchStats, collect_search_stats

        st = SearchStats(
            engine=self.name,
            histories=self.histories_seen,
            nodes_explored=self.middle_nodes,
            segments_split=self.segments_split,
            segments_total=self.segments_total,
        )
        st.absorb(collect_search_stats(self.inner))
        return st

    def _resolve_finals_device(self, spec: Spec, finals, out) -> None:
        """One batched inner call deciding every (final segment ×
        frontier state) pair: linearizable from any state wins, else any
        undecided pair leaves the history BUDGET_EXCEEDED."""
        flat_h: List[History] = []
        flat_s: List[np.ndarray] = []
        spans: List[Tuple[int, int]] = []
        for _, last, states in finals:
            spans.append((len(flat_h), len(states)))
            flat_h.extend([last] * len(states))
            flat_s.extend(np.asarray(s, np.int32) for s in states)
        verdicts = self.inner.check_histories(spec, flat_h,
                                              init_states=flat_s)
        self.final_states_device += len(flat_h)
        for (i, _, _), (start, count) in zip(finals, spans):
            sub = np.asarray(verdicts[start:start + count])
            if (sub == int(Verdict.LINEARIZABLE)).any():
                out[i] = int(Verdict.LINEARIZABLE)
            elif (sub == int(Verdict.BUDGET_EXCEEDED)).any():
                out[i] = int(Verdict.BUDGET_EXCEEDED)
            else:
                out[i] = int(Verdict.VIOLATION)

    def _final_on_oracle(self, spec: Spec, last: History,
                         states: List[Tuple[int, ...]]) -> Verdict:
        saw_budget = False
        for state in states:
            v = self.oracle.check_from(spec, last, np.asarray(state))
            if v == Verdict.LINEARIZABLE:
                return v
            if v == Verdict.BUDGET_EXCEEDED:
                saw_budget = True
        return (Verdict.BUDGET_EXCEEDED if saw_budget
                else Verdict.VIOLATION)
