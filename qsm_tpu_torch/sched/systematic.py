"""Systematic schedule exploration: bounded-exhaustive model checking.

The property layer samples k seeded schedules a program.  This module
enumerates them instead, for small programs: every delivery-order choice
the scheduler can make is explored depth first, every distinct history is
collected, and the set is decided in one batched checker call, which
turns "k random schedules found nothing" into "all N interleavings
explored, none violates".

Delivery choice is the scheduler's only nondeterminism (process step
order is fixed), and ``Scheduler(choices=...)`` replays a scripted prefix,
then takes choice 0, logging the branching factor at every delivery.  So
running prefix ``p`` reveals the factors along ``p``'s leftmost
completion, and lexicographic backtracking over the logged factors walks
the whole tree without storing it.

Fault plans compose when they are deterministic: crash schedules fire on
delivery counts and partitions are a pure (src, dst) predicate, so
scripted replay explores them exactly.  Drop / duplicate / delay rates
draw from the RNG that scripted replay bypasses and are refused.

The union of many programs' trees (:func:`explore_many`) is decided in one
backend call: thousands of small histories, the batch the device
backends exist for.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.history import History
from ..ops.backend import LineariseBackend, Verdict
from .runner import HistoryRecorder, _client, prepare_run
from .scheduler import FaultPlan, Message, PruneRun, Scheduler


@dataclasses.dataclass
class ExploreResult:
    """Outcome of exploring one program's interleaving tree."""

    schedules_run: int
    distinct_histories: int
    exhausted: bool         # the whole tree fit under max_schedules
    violations: int
    undecided: int
    seconds: float
    violating: Optional[History] = None  # first violating history
    # schedules cut short by the state-fingerprint prune (a subset of
    # schedules_run)
    pruned_schedules: int = 0

    @property
    def ok(self) -> bool:
        return self.violations == 0

    @property
    def verified(self) -> bool:
        """Every interleaving explored and decided, none violating.
        False whenever the tree was truncated or a history undecided."""
        return self.exhausted and self.violations == 0 and self.undecided == 0


def schedule_key(choices: Sequence[int]) -> str:
    """A delivery-choice script as a history seed string; the one encode
    site, :func:`parse_schedule_key` its inverse (regression files store
    this string)."""
    return "explore:" + ",".join(map(str, choices))


def parse_schedule_key(seed_key) -> Optional[List[int]]:
    """The choice script of a :func:`schedule_key` stamp, or None when
    ``seed_key`` is not one (an ordinary seeded run)."""
    if not (isinstance(seed_key, str) and seed_key.startswith("explore:")):
        return None
    body = seed_key[len("explore:"):]
    return [int(x) for x in body.split(",") if x != ""]


def _next_prefix(choices: List[int], factors: List[int]
                 ) -> Optional[List[int]]:
    """Lexicographic successor: the deepest position with an untried
    sibling, bumped; None when the tree is exhausted."""
    for i in range(len(factors) - 1, -1, -1):
        c = choices[i] if i < len(choices) else 0
        if c + 1 < factors[i]:
            return (choices[:i] if i < len(choices)
                    else choices + [0] * (i - len(choices))) + [c + 1]
    return None


def _summarize(hists: List[History], verdicts
               ) -> Tuple[int, int, Optional[History]]:
    """(violations, undecided, first violating history)."""
    violations = int((verdicts == int(Verdict.VIOLATION)).sum())
    undecided = int((verdicts == int(Verdict.BUDGET_EXCEEDED)).sum())
    violating = None
    for h, v in zip(hists, verdicts):
        if int(v) == int(Verdict.VIOLATION):
            violating = h
            break
    return violations, undecided, violating


# ---------------------------------------------------------------------------
# State-fingerprint pruning
#
# The scheduler is deterministic, so an identical quiescent state has an
# identical subtree of reachable histories.  Delivery orders of
# independent messages often converge on one state, so the walk
# fingerprints the whole scheduler state at every delivery point and
# prunes a node whose state was first reached under an earlier
# (lexicographically smaller) schedule.  Depth-first lexicographic order
# enumerates the first encounter's subtree before any second one, so the
# prune drops only duplicate work.
#
# The state is everything that shapes behaviour or the history: events
# recorded so far, the in-flight pool (a multiset: children are explored
# exhaustively either way), and each process's mailbox, liveness flags
# and generator continuation (bytecode position and locals, through
# yield-from and object state by value, so two runs' distinct but equal
# SUT objects match).  Anything unfingerprintable answers "don't prune":
# an exotic SUT falls back to the exact unpruned walk, never to an
# unsound skip.  SUT state must be reachable from the SUT object or its
# process generators (module-level globals would be invisible).
# ---------------------------------------------------------------------------

class _Unfingerprintable(Exception):
    pass


_FP_MAX_DEPTH = 24


def _fp_val(v, depth: int = 0, memo: Optional[dict] = None):
    """Hashable value fingerprint of state reachable from process frames.
    Raises _Unfingerprintable rather than guessing: a lossy fingerprint
    could equate distinct states, an unsound prune.

    ``memo`` (one state's fingerprint, during which nothing changes)
    keeps each object's fingerprint by (identity, depth): the SUT and its
    spec sit in every client's frame, and are walked once a depth.  The
    depth is part of the key, so the depth limit acts as without it."""
    if depth > _FP_MAX_DEPTH:
        raise _Unfingerprintable("nesting too deep")
    if v is None or isinstance(v, (int, str, bool, float, bytes)):
        return v
    if isinstance(v, Message):
        # uid is a global send counter, behaviourally inert
        return ("M", v.src, v.dst, _fp_val(v.payload, depth + 1, memo))
    if isinstance(v, dict):
        if all(type(k) is str for k in v):
            # frame locals and object attributes: ordered by name, not by
            # the repr of whole fingerprints (the same identity: names
            # are unique, and no other key's fingerprint is a str)
            return ("D",) + tuple([(k, _fp_val(v[k], depth + 1, memo))
                                   for k in sorted(v)])
        return ("D",) + tuple(sorted(
            ((_fp_val(k, depth + 1, memo), _fp_val(x, depth + 1, memo))
             for k, x in v.items()), key=repr))
    if isinstance(v, (list, tuple)) or type(v).__name__ == "deque":
        return ("L",) + tuple(_fp_val(x, depth + 1, memo) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("S",) + tuple(sorted(
            (_fp_val(x, depth + 1, memo) for x in v), key=repr))
    if isinstance(v, (HistoryRecorder, Scheduler)):
        # fingerprinted at the top level; recursing would cycle
        return type(v).__name__
    if isinstance(v, types.GeneratorType):
        return _fp_gen(v, depth + 1, memo)
    d = getattr(v, "__dict__", None)
    if d is not None:  # SUT objects: by value, not identity
        key = (id(v), depth)
        if memo is not None and key in memo:
            return memo[key]
        fp = ("O", type(v).__name__, _fp_val(d, depth + 1, memo))
        if memo is not None:
            memo[key] = fp
        return fp
    raise _Unfingerprintable(f"opaque value {type(v).__name__}")


# Locals of exactly the runner's client frame that are constant over one
# enumeration (``ops``, the whole per-pid program); the skip is scoped by
# the code object, so a SUT generator's mutating local of the same name
# is still fingerprinted.
_CLIENT_CODE = _client.__code__
_CLIENT_SKIP_LOCALS = frozenset({"ops"})


def _fp_gen(g, depth: int = 0, memo: Optional[dict] = None):
    """Continuation fingerprint: code name, bytecode position and locals,
    following the yield-from chain (clients delegate to ``sut.perform``).
    """
    fr = g.gi_frame
    if fr is None:
        return ("G", g.gi_code.co_name, "done")
    sub = g.gi_yieldfrom
    loc = fr.f_locals
    if fr.f_code is _CLIENT_CODE:
        loc = {k: v for k, v in loc.items()
               if k not in _CLIENT_SKIP_LOCALS}
    return ("G", g.gi_code.co_name, fr.f_lasti,
            _fp_val(loc, depth + 1, memo),
            _fp_gen(sub, depth + 1, memo)
            if isinstance(sub, types.GeneratorType) else None)


def _state_fingerprint(sched: Scheduler, rec: HistoryRecorder):
    """The whole quiescent state's identity (see above)."""
    memo: dict = {}
    events = tuple((r.pid, r.cmd, r.arg, r.resp, r.invoke_time,
                    r.response_time) for r in rec.recs)
    pool = tuple(sorted(
        (_fp_val((f.msg.src, f.msg.dst, f.msg.payload), 0, memo)
         for f in sched.pool), key=repr))
    procs = tuple(
        (name, p.done, p.blocked, p.crashed,
         tuple(_fp_val((m.src, m.payload), 0, memo) for m in p.mailbox),
         _fp_val(p.send_value, 0, memo),
         "done" if p.done else _fp_gen(p.gen, 0, memo))
        for name, p in sorted(sched.procs.items()))
    monitors = tuple(sorted((t, tuple(ws))
                            for t, ws in sched.monitors.items()))
    return (events, pool, procs, monitors)


def deterministic_faults(faults: Optional[FaultPlan]) -> bool:
    """True when ``faults`` never consults the RNG's outcome: the plans
    systematic exploration enumerates exactly."""
    return faults is None or faults.is_deterministic()


def _enumerate(sut_factory, program, max_schedules: int, max_steps: int,
               prune: bool = True, faults: Optional[FaultPlan] = None
               ) -> Tuple[List[History], int, bool, int]:
    """Walk one program's delivery-choice tree depth first: (distinct
    histories, schedules run, whether the whole tree fit under
    ``max_schedules``, schedules cut short by the prune).  Pruned partial
    runs count as schedules run.  ``faults`` must be deterministic."""
    histories: Dict[Tuple, History] = {}
    seen: Dict[tuple, tuple] = {}  # state fingerprint -> first path
    prefix: Optional[List[int]] = []
    schedules = 0
    pruned_n = 0
    exhausted = True
    while prefix is not None:
        if schedules >= max_schedules:
            exhausted = False
            break
        sched, rec = prepare_run(sut_factory(), program, seed=0,
                                 max_steps=max_steps, choices=prefix,
                                 faults=faults)
        if prune:
            # only crash plans depend on the delivery count; a
            # partitions-only plan keeps the whole pruning power
            def hook(s, _script=prefix, _rec=rec,
                     _faulty=bool(faults and faults.crash_at)):
                log = s.choice_log
                try:
                    fp = _state_fingerprint(s, _rec)
                except _Unfingerprintable:
                    return False  # cannot identify it: never skip
                if _faulty:
                    # pending crash points fire on the delivery count, so
                    # the same state at two depths has two futures
                    fp = (fp, s.n_delivered)
                # the path taken so far (scripted choices clamped to the
                # live factor, 0 past the script)
                path = tuple(
                    min(_script[j] if j < len(_script) else 0, log[j] - 1)
                    for j in range(len(log)))
                return seen.setdefault(fp, path) != path

            sched.prune_hook = hook
        try:
            sched.run()
            pruned = False
        except PruneRun:
            pruned = True
            pruned_n += 1
        schedules += 1
        if not pruned:
            h = rec.history(seed=schedule_key(prefix))
            histories.setdefault(h.fingerprint(), h)
        prefix = _next_prefix(prefix, sched.choice_log)
    return list(histories.values()), schedules, exhausted, pruned_n


def _refuse_probabilistic(faults) -> None:
    if not deterministic_faults(faults):
        raise ValueError(
            "systematic exploration is incompatible with PROBABILISTIC "
            "fault injection (drop/duplicate/delay rates are seeded "
            "draws, which scripted replay bypasses); crash schedules and "
            "partitions are deterministic and explore fine — use "
            "prop_concurrent sampling for the probabilistic plans")


def explore_program(
    sut_factory: Callable[[], object],
    program,
    spec,
    backend: Optional[LineariseBackend] = None,
    max_schedules: int = 10_000,
    max_steps: int = 100_000,
    faults: Optional[FaultPlan] = None,
    check: bool = True,
    prune: bool = True,
) -> ExploreResult:
    """Enumerate every delivery schedule of ``program`` (up to
    ``max_schedules``), then decide all distinct histories in one batched
    checker call.

    ``backend`` defaults to the property layer's resolving oracle; a
    fresh SUT is built a schedule from ``sut_factory``.  ``check=False``
    enumerates only: every history reports undecided, so ``verified``
    is never claimed from an unchecked run."""
    _refuse_probabilistic(faults)
    t0 = time.perf_counter()
    hists, schedules, exhausted, pruned_n = _enumerate(
        sut_factory, program, max_schedules, max_steps,
        prune=prune, faults=faults)
    if not check:
        return ExploreResult(
            schedules_run=schedules, distinct_histories=len(hists),
            exhausted=exhausted, violations=0, undecided=len(hists),
            seconds=round(time.perf_counter() - t0, 3),
            pruned_schedules=pruned_n)
    if backend is None:
        from ..core.property import _default_oracle

        backend = _default_oracle(spec)
    verdicts = (np.asarray(backend.check_histories(spec, hists)) if hists
                else np.empty(0, np.int8))
    violations, undecided, violating = _summarize(hists, verdicts)
    return ExploreResult(
        schedules_run=schedules, distinct_histories=len(hists),
        exhausted=exhausted, violations=violations, undecided=undecided,
        seconds=round(time.perf_counter() - t0, 3), violating=violating,
        pruned_schedules=pruned_n)


def enumerate_many(sut_factory, programs: Sequence, max_schedules: int,
                   max_steps: int, prune: bool = True,
                   faults: Optional[FaultPlan] = None, workers: int = 0,
                   pool=None):
    """Walk every program's tree, serially, over ``workers`` spawned
    processes, or over ``pool``, an :class:`~.pool.ExplorePool` the
    caller keeps for many sweeps (``sut_factory`` then picklable, e.g.
    ``models.registry.SutFactory``): [(histories, schedules, exhausted,
    pruned, seconds)] in program order, the same every way."""
    if pool is not None:
        return pool.explore_many(programs, max_schedules, max_steps, prune,
                                 faults, sut_factory=sut_factory)
    if workers > 0:
        from .pool import ExplorePool

        pool = ExplorePool(sut_factory, n_workers=workers)
        try:
            return pool.explore_many(programs, max_schedules, max_steps,
                                     prune, faults)
        finally:
            pool.close()
    out = []
    for prog in programs:
        t0 = time.perf_counter()
        walked = _enumerate(sut_factory, prog, max_schedules, max_steps,
                            prune=prune, faults=faults)
        out.append((*walked, time.perf_counter() - t0))
    return out


def explore_many(
    sut_factory: Callable[[], object],
    programs: Sequence,
    spec,
    backend: Optional[LineariseBackend] = None,
    max_schedules: int = 10_000,
    max_steps: int = 100_000,
    prune: bool = True,
    faults: Optional[FaultPlan] = None,
    workers: int = 0,
    pool=None,
) -> List[ExploreResult]:
    """Explore many programs and decide the union of their distinct
    histories in one batched checker call: the trees enumerate on the
    host, the decisions ride one device dispatch.  One
    :class:`ExploreResult` a program.

    Enumeration is :func:`explore_program`'s, program by program, and
    decided verdicts are the same too; but a budget-bounded device
    backend may defer differently: its memo size depends on the batch's
    bucket, so a history decided in a small batch can come back
    BUDGET_EXCEEDED in the larger union (never a wrong verdict; the
    program's ``undecided`` counts it).

    ``workers`` > 0 walks the trees over that many spawned processes;
    ``pool`` (an :class:`~.pool.ExplorePool`, kept and closed by the
    caller) walks them over an existing one.  The results are the serial
    walk's either way."""
    _refuse_probabilistic(faults)
    if backend is None:
        from ..core.property import _default_oracle

        backend = _default_oracle(spec)
    per_prog = []
    flat: List[History] = []
    for hists, schedules, exhausted, pruned_n, enum_dt in enumerate_many(
            sut_factory, programs, max_schedules, max_steps, prune, faults,
            workers, pool):
        per_prog.append((slice(len(flat), len(flat) + len(hists)),
                         schedules, exhausted, pruned_n, enum_dt))
        flat.extend(hists)
    t0 = time.perf_counter()
    verdicts = (np.asarray(backend.check_histories(spec, flat)) if flat
                else np.empty(0, np.int8))
    check_dt = time.perf_counter() - t0
    out = []
    for sl, schedules, exhausted, pruned_n, enum_dt in per_prog:
        hs = flat[sl]
        violations, undecided, violating = _summarize(hs, verdicts[sl])
        # the program's own enumeration plus its share of the one check
        # call, apportioned by history count
        share = check_dt * (len(hs) / len(flat)) if flat else 0.0
        out.append(ExploreResult(
            schedules_run=schedules, distinct_histories=len(hs),
            exhausted=exhausted, violations=violations,
            undecided=undecided, seconds=round(enum_dt + share, 3),
            violating=violating, pruned_schedules=pruned_n))
    return out


def shrink_explored(
    sut_factory: Callable[[], object],
    program,
    spec,
    backend: Optional[LineariseBackend] = None,
    max_schedules: int = 2_000,
    max_rounds: int = 50,
    initial: Optional[ExploreResult] = None,
    faults: Optional[FaultPlan] = None,
):
    """Minimise a program whose exploration found a violation: a greedy
    shrink whose predicate is exploration (a candidate survives when
    exploring it, up to ``max_schedules``, still finds a violating
    interleaving), so the minimal program violates under some schedule
    found by search, not by one seed's replay.

    Returns ``(program, ExploreResult, shrink_steps)`` for the smallest
    still-violating program.  ``initial`` is the program's own result,
    when the caller has it (exploration is deterministic)."""
    from ..core.generator import dedupe, shrink_candidates

    best_prog = program
    best_res = (initial if initial is not None
                else explore_program(sut_factory, program, spec,
                                     backend=backend,
                                     max_schedules=max_schedules,
                                     faults=faults))
    if best_res.violations == 0:
        return best_prog, best_res, 0
    steps = 0
    for _ in range(max_rounds):
        improved = False
        for cand in dedupe(shrink_candidates(spec, best_prog), limit=256):
            if len(cand) >= len(best_prog):
                continue
            res = explore_program(sut_factory, cand, spec, backend=backend,
                                  max_schedules=max_schedules,
                                  faults=faults)
            if res.violations > 0:
                best_prog, best_res = cand, res
                steps += 1
                improved = True
                break  # greedy: restart from the smaller program
        if not improved:
            return best_prog, best_res, steps
    return best_prog, best_res, steps
