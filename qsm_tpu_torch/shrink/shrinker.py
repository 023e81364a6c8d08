"""Greedy frontier-at-once history minimisation.

The counterpart of the JAX package's ``qsm_tpu/shrink/shrinker.py``:

1. decide the input history; anything but a VIOLATION returns unshrunk
   (the shrinker minimises counterexamples, it never makes them);
2. build the whole frontier (``frontier.py``), answer what the memo
   already knows, decide every other candidate in one batched engine call
   (on the card, one ``check_histories`` of a device checker);
3. step to the smallest still-failing candidate (the first VIOLATION in
   the frontier's canonical order) and recurse.  Every accepted round
   lowers ``(n_ops, inversions)`` lexicographically, so the recursion
   terminates without trusting ``max_rounds``;
4. stop when no candidate fails: every single-op drop passes (or is
   counted in ``undecided_neighbors``), so the result is 1-minimal, and
   the certificate turns that claim into proof: one witness a drop-one
   neighbour (stitched through the per-key split when it pays), each
   replayed by ``verify_witness`` with no search trusted.

Every accepted step is a history the engine decided to be a VIOLATION.
The memo keys candidates by the verdict cache's identity
(``serve.cache.fingerprint_key``), so no candidate is checked twice, and
``bank=`` (a ``VerdictCache``) carries verdicts across runs.  The
reference also banks a round's undecided candidates in its device-work
queue; this package has no such queue yet, so its shrinker has the memo
and the bank only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.history import History
from ..core.spec import Spec, projection_report
from ..ops.backend import Verdict, verify_witness
from ..serve.cache import fingerprint_key
from .frontier import Candidate, shrink_frontier

# hard caps — backstops behind the lexicographic termination measure,
# never the primary bound (an n-op history can accept at most n
# size-reducing rounds plus O(n²) inversion-reducing swaps)
DEFAULT_MAX_ROUNDS = 256
DEFAULT_MAX_LANES = 512


@dataclasses.dataclass
class ShrinkResult:
    """The minimized history plus everything needed to audit it."""

    ok: bool                   # input was a VIOLATION; shrinking ran
    verdict: int               # verdict of the INPUT history
    history: History           # minimized (== input when not shrunk)
    initial_ops: int = 0
    final_ops: int = 0
    rounds: int = 0
    engine_calls: int = 0      # batched dispatches issued
    lanes_checked: int = 0     # candidate lanes those dispatches carried
    memo_hits: int = 0         # candidates answered without re-checking
    complete: bool = True      # False: deadline/cap/shed cut the loop
    one_minimal: bool = False  # every single-op drop decided LINEARIZABLE
    undecided_neighbors: int = 0  # drop-one neighbors left BUDGET_EXCEEDED
    why: List[str] = dataclasses.field(default_factory=list)
    # 1-minimality proof: per drop-one neighbor of the minimized history,
    # the witness of ITS linearizability — [{"drop": j, "witness": [...],
    # "stitched": bool, "verifies": bool}]; None when not requested or
    # the input never shrank
    certificate: Optional[List[dict]] = None

    @property
    def ratio(self) -> float:
        return (self.final_ops / self.initial_ops
                if self.initial_ops else 1.0)

    def search_stats(self):
        """The shrink plane's own cost record (search/stats.py):
        shrink_* counters the CLI/bench rows thread through."""
        from ..search.stats import SearchStats

        return SearchStats(
            engine="shrink",
            histories=self.lanes_checked,
            shrink_rounds=self.rounds,
            shrink_lanes=self.lanes_checked,
            shrink_memo_hits=self.memo_hits,
            # clamped to >= 1: 0 is the "never shrank" sentinel
            # (SearchStats.absorb's min-merge guard), and a 1024->2
            # shrink must not round into it
            shrink_ratio_pct=(max(1, round(100.0 * self.ratio))
                              if self.ok and self.initial_ops else 0),
        )


class Shrinker:
    """One shrink run: frontier generation + memoised batched deciding.

    ``decide(histories) -> verdict array | None`` is the ONLY engine
    access — in-process it wraps a planner-built backend
    (:func:`shrink_history`).  ``None`` means the decider shed
    (deadline/overload): the run stops honestly with best-so-far.
    ``bank`` (optional, a ``VerdictCache`` or any get/put of its row
    format) is consulted before dispatch and — when ``bank_put`` — fed
    after, so candidate verdicts persist across runs;
    the per-run memo additionally remembers BUDGET_EXCEEDED, which the
    bank refuses by design.
    """

    def __init__(self, spec: Spec,
                 decide: Callable[[Sequence[History]], Optional[np.ndarray]],
                 bank=None, bank_put: bool = True,
                 max_rounds: int = DEFAULT_MAX_ROUNDS,
                 max_lanes: int = DEFAULT_MAX_LANES,
                 deadline: Optional[float] = None,
                 schedule_shrinks: bool = True):
        self.spec = spec
        self.decide = decide
        self.bank = bank
        self.bank_put = bank_put
        self.max_rounds = max_rounds
        self.max_lanes = max_lanes
        self.deadline = deadline  # absolute time.monotonic() bound
        self.schedule_shrinks = schedule_shrinks
        self._memo: Dict[str, int] = {}   # fingerprint_key -> verdict
        self.rounds = 0
        self.engine_calls = 0
        self.lanes_checked = 0
        self.memo_hits = 0
        self.truncated = 0
        self.why: List[str] = []

    # ------------------------------------------------------------------
    def _timed_out(self) -> bool:
        return (self.deadline is not None
                and time.monotonic() >= self.deadline)

    def _verdicts(self, hists: Sequence[History]) -> Optional[List[int]]:
        """Memo-first batched deciding: one ``decide`` call for all
        misses; decided verdicts memo (and bank) so no fingerprint is
        ever dispatched twice."""
        keys = [fingerprint_key(self.spec, h) for h in hists]
        out: List[Optional[int]] = [None] * len(hists)
        miss_idx: List[int] = []
        for i, key in enumerate(keys):
            v = self._memo.get(key)
            if v is None and self.bank is not None:
                e = self.bank.get(key)
                if e is not None:
                    v = int(e.verdict)
            if v is not None:
                out[i] = v
                self.memo_hits += 1
            else:
                miss_idx.append(i)
        if miss_idx:
            decided = self.decide([hists[i] for i in miss_idx])
            if decided is None:
                return None  # the decider shed: stop with best-so-far
            self.engine_calls += 1
            self.lanes_checked += len(miss_idx)
            for i, v in zip(miss_idx, decided):
                v = int(v)
                out[i] = v
                self._memo[keys[i]] = v
                if self.bank is not None and self.bank_put:
                    self.bank.put(keys[i], v)
        return [int(v) for v in out]

    # ------------------------------------------------------------------
    def _bank_undecided(self, hists: List[History]) -> None:
        """The device-work queue's shrink seam (``devq/``): a round's
        BUDGET_EXCEEDED candidates are banked for the next drain, which
        decides them and banks their verdicts where this memo finds them
        on a retried shrink.  One global read when no queue is
        installed."""
        from ..devq.queue import bank_histories, global_devq

        if global_devq() is None:
            return
        if getattr(self.spec, "spec_kwargs", None) is None:
            return  # not rebuildable from the registry: a dead item
        bank_histories(self.spec, hists, plane="shrink")

    # ------------------------------------------------------------------
    def run(self, history: History) -> ShrinkResult:
        first = self._verdicts([history])
        if first is None:
            return ShrinkResult(ok=False, verdict=int(Verdict.BUDGET_EXCEEDED),
                                history=history, complete=False,
                                why=self.why + ["shed before the input "
                                                "history was decided"])
        verdict = first[0]
        if verdict != int(Verdict.VIOLATION):
            self.why.append(
                "input history is not a VIOLATION "
                f"(verdict {Verdict(verdict).name}); nothing to minimize")
            return ShrinkResult(ok=False, verdict=verdict, history=history,
                                initial_ops=len(history),
                                final_ops=len(history), why=self.why,
                                engine_calls=self.engine_calls,
                                lanes_checked=self.lanes_checked,
                                memo_hits=self.memo_hits)
        best = history
        complete = True
        last_frontier: List[Candidate] = []
        last_verdicts: List[int] = []
        last_trunc = 0
        while self.rounds < self.max_rounds:
            if self._timed_out():
                complete = False
                self.why.append(
                    f"deadline fired after {self.rounds} round(s); "
                    "returning best-so-far")
                break
            cands, trunc = shrink_frontier(
                self.spec, best, max_lanes=self.max_lanes,
                schedule=self.schedule_shrinks)
            self.truncated += trunc
            last_trunc = trunc
            if trunc:
                self.why.append(
                    f"round {self.rounds + 1}: frontier truncated by "
                    f"{trunc} candidate(s) at max_lanes={self.max_lanes}")
            if not cands:
                break
            verdicts = self._verdicts([c.history for c in cands])
            if verdicts is None:
                complete = False
                self.why.append(
                    f"decider shed in round {self.rounds + 1}; "
                    "returning best-so-far")
                break
            self.rounds += 1
            last_frontier, last_verdicts = cands, verdicts
            undecided_now = [c.history for c, v in zip(cands, verdicts)
                             if v == int(Verdict.BUDGET_EXCEEDED)]
            if undecided_now:
                self._bank_undecided(undecided_now)
            fail = next((i for i, v in enumerate(verdicts)
                         if v == int(Verdict.VIOLATION)), None)
            if fail is None:
                break  # 1-minimal (modulo undecided neighbors)
            best = cands[fail].history
        else:
            complete = False
            self.why.append(f"round cap {self.max_rounds} reached; "
                            "returning best-so-far")
        # 1-minimality accounting over EVERY size-(n-1) candidate of the
        # final frontier, whatever axis generated it (a single-op pid's
        # drop-one neighbor dedupes into its drop-pid twin — same
        # history, same obligation); a truncated final frontier may have
        # cut size-(n-1) candidates entirely, so truncation forfeits the
        # claim outright rather than counting only what survived.
        # Counted ONLY on complete runs: an incomplete exit's
        # last_frontier may belong to a PREVIOUS best (the deadline
        # fired after an accepted step), and reporting another
        # history's undecided candidates as this one's neighbors would
        # be wrong data — incomplete runs already forfeit one_minimal.
        undecided = sum(
            1 for c, v in zip(last_frontier, last_verdicts)
            if len(c.history) == len(best) - 1
            and v == int(Verdict.BUDGET_EXCEEDED)) if complete else 0
        one_minimal = complete and undecided == 0 and last_trunc == 0
        if complete and undecided:
            self.why.append(
                f"{undecided} single-op-drop neighbor(s) stayed "
                "undecided (BUDGET_EXCEEDED): 1-minimality is not "
                "claimed")
        if complete and not undecided and last_trunc:
            self.why.append(
                f"final frontier truncated by {last_trunc} candidate(s) "
                f"at max_lanes={self.max_lanes}: some single-op drops "
                "were never checked, so 1-minimality is not claimed")
        return ShrinkResult(
            ok=True, verdict=verdict, history=best,
            initial_ops=len(history), final_ops=len(best),
            rounds=self.rounds, engine_calls=self.engine_calls,
            lanes_checked=self.lanes_checked, memo_hits=self.memo_hits,
            complete=complete, one_minimal=one_minimal,
            undecided_neighbors=undecided, why=self.why)


# ---------------------------------------------------------------------------
# certificates: the 1-minimality proof
# ---------------------------------------------------------------------------

def minimality_certificate(spec: Spec, history: History,
                           oracle=None, pcomp=None,
                           deadline: Optional[float] = None) -> List[dict]:
    """One witness per drop-one neighbor of ``history``: each neighbor is
    LINEARIZABLE (that is what 1-minimal MEANS) and the witness replays
    search-free through ``verify_witness`` — stitched through the
    per-key split when it pays (ops/pcomp.py), plain otherwise.  A
    neighbor the searches cannot decide (or a deadline cut) yields a
    ``{"undecided": True}`` row — the certificate never overstates."""
    from ..ops.pcomp import NotDecomposableError, split_gain
    from ..ops.wing_gong_cpu import WingGongCPU

    if oracle is None:
        oracle = WingGongCPU(memo=True)
    if pcomp is None and not projection_report(spec):
        from ..ops.pcomp import PComp

        try:
            pcomp = PComp(spec)
        except NotDecomposableError:
            pcomp = None
    rows: List[dict] = []
    n = len(history.ops)
    for j in range(n):
        if deadline is not None and time.monotonic() >= deadline:
            rows.append({"drop": j, "undecided": True,
                         "why": "deadline fired mid-certificate"})
            continue
        neighbor = history.subhistory([i for i in range(n) if i != j])
        stitched = False
        if pcomp is not None and split_gain(spec, neighbor):
            v, w = pcomp.check_witness(spec, neighbor)
            stitched = True
        else:
            v, w = oracle.check_witness(spec, neighbor)
        if int(v) != int(Verdict.LINEARIZABLE) or w is None:
            rows.append({"drop": j, "undecided": True,
                         "verdict": Verdict(int(v)).name})
            continue
        rows.append({"drop": j, "witness": [list(p) for p in w],
                     "stitched": stitched,
                     "verifies": verify_witness(spec, neighbor, w)})
    return rows


def verify_certificate(spec: Spec, history: History,
                       certificate: Sequence[dict],
                       reconfirm_violation: bool = True) -> dict:
    """Independent audit of a shrink result: replay every neighbor
    witness through ``verify_witness`` (no search trusted) and — when
    asked — re-find the minimized history's VIOLATION with a FRESH memo
    oracle.  The return block is what bench rows and tests assert on."""
    from ..ops.wing_gong_cpu import WingGongCPU

    n = len(history.ops)
    replayed = 0
    failed = 0
    undecided = 0
    covered = set()
    for row in certificate:
        j = row.get("drop")
        if row.get("undecided"):
            undecided += 1
            continue
        neighbor = history.subhistory([i for i in range(n) if i != j])
        if verify_witness(spec, neighbor, [tuple(p) for p in row["witness"]]):
            replayed += 1
            covered.add(j)
        else:
            failed += 1
    out = {
        "neighbors": n,
        "witnesses_replayed": replayed,
        "witnesses_failed": failed,
        "undecided": undecided,
        "one_minimal_proved": failed == 0 and covered == set(range(n)),
    }
    if reconfirm_violation:
        fresh = WingGongCPU(memo=True)
        out["violation_reconfirmed"] = int(
            fresh.check_histories(spec, [history])[0]
        ) == int(Verdict.VIOLATION)
    return out


# ---------------------------------------------------------------------------
# the in-process entry point
# ---------------------------------------------------------------------------

def shrink_history(spec: Spec, history: History, *,
                   backend=None, bank=None,
                   max_rounds: int = DEFAULT_MAX_ROUNDS,
                   max_lanes: int = DEFAULT_MAX_LANES,
                   deadline_s: Optional[float] = None,
                   certificate: bool = True,
                   schedule_shrinks: bool = True) -> ShrinkResult:
    """Minimize one failing history; the ``shrink`` subcommand drives
    exactly this.

    ``backend=None`` builds the planned host dispatch for THIS history's
    profile (search/planner.py ``build_host_backend``, on the JAX
    package's CPU plan, as the reference builds it): ``PComp``
    outermost when the validated projection pays — every frontier
    candidate then decides as per-key sub-lanes in smaller compile
    buckets — else the ``FailoverBackend``-wrapped cpp→memo host ladder.
    ``bank``, when given, is a ``serve.cache.VerdictCache``(-shaped)
    store the memo rides across runs."""
    from ..search.planner import (build_host_backend, plan_search,
                                  profile_corpus)

    deadline = (time.monotonic() + deadline_s
                if deadline_s is not None else None)
    why: List[str] = []
    if backend is None:
        profile = profile_corpus([history], spec)
        plan = plan_search(spec, profile, platform="cpu")
        backend = build_host_backend(spec, plan)
        why.append(f"engine={getattr(backend, 'name', type(backend).__name__)}"
                   f" (plan {plan.name}: "
                   f"decompose_keys={'on' if plan.decompose_keys else 'off'})")

    def decide(hists: Sequence[History]):
        return backend.check_histories(spec, hists)

    shrinker = Shrinker(spec, decide, bank=bank,
                        max_rounds=max_rounds, max_lanes=max_lanes,
                        deadline=deadline,
                        schedule_shrinks=schedule_shrinks)
    shrinker.why.extend(why)
    res = shrinker.run(history)
    if certificate and res.ok and res.complete:
        res.certificate = minimality_certificate(spec, res.history,
                                                 deadline=deadline)
    # fold the engine's own cost record into the result's so callers
    # (CLI/bench) report one self-describing block
    res._engine = backend  # noqa: SLF001 — kept for stats collection
    return res


def collect_shrink_stats(res: ShrinkResult):
    """``SearchStats`` for a finished in-process run: the shrink_*
    counters plus the engine's absorbed search record."""
    from ..search.stats import collect_search_stats

    st = res.search_stats()
    engine = getattr(res, "_engine", None)
    if engine is not None:
        sub = collect_search_stats(engine)
        if sub is not None:
            st.engine = f"shrink({sub.engine})"
            st.absorb(sub)
    return st
