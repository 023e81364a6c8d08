"""Property layer: ``prop_concurrent``, the state-machine property loop.

Per trial: generate a program → execute it under the deterministic
scheduler (k seeded schedules) → check the histories in one backend batch
→ on a violation, shrink.  Every shrink round executes all candidates and
decides them in one backend batch.  BUDGET_EXCEEDED verdicts from a
device backend are resolved by the exact host oracle (the native C++
checker when it builds, else the memoised Python oracle), so the
property's verdicts are always exact.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.backend import LineariseBackend, Verdict
from ..sched.runner import ConcurrentSUT, run_concurrent
from ..sched.scheduler import FaultPlan
from ..search.stats import SearchStats, collect_search_stats, stats_delta
from .generator import Program, dedupe, generate_program, shrink_candidates
from .history import History
from .spec import Spec


@dataclasses.dataclass
class PropertyConfig:
    n_trials: int = 100
    n_pids: int = 2
    max_ops: int = 12
    seed: int = 0
    shrink_rounds: int = 200
    shrink_batch: int = 256  # candidates decided per backend batch
    faults: Optional[FaultPlan] = None
    ramp_sizes: bool = True  # QuickCheck-style size ramp across trials
    max_steps: int = 100_000
    # seeded schedules per generated program, decided in one batch
    schedules_per_program: int = 4
    # trials decided per backend batch; the group ramps 1, 2, 4, ... up
    # to this width, and short groups are padded with empty histories so
    # every batch has the same width.  Verdicts do not depend on it.
    trial_batch: int = 1
    # message transport of the scheduler plane: "memory" or "tcp" (real
    # loopback sockets, sched/transport.py); histories are bit-identical
    # on both
    transport: str = "memory"
    # minimising the failing history itself through the batched history
    # shrinker; that shrinker is not part of this package yet, so
    # prop_concurrent refuses True.  The field keeps the configuration's
    # keys (and so a regression file's) equal to the JAX package's.
    minimize_history: bool = False
    # worker processes executing schedules (sched/pool.py), 0: serial.
    # Histories are bit-identical either way.  Needs a picklable
    # ``sut_factory`` (prop_concurrent's), ignored without one.
    executor_workers: int = 0


@dataclasses.dataclass
class Counterexample:
    program: Program
    history: History
    trial: int
    trial_seed: str  # replay key
    shrink_steps: int


@dataclasses.dataclass
class PropertyResult:
    ok: bool
    trials_run: int
    histories_checked: int
    counterexample: Optional[Counterexample] = None
    # histories neither the backend nor the oracle decided within budget;
    # nonzero means ok=True is not a sound verdict
    undecided: int = 0
    schedules_run: int = 0
    distinct_histories: int = 0
    # wall-clock split (seconds): generate, execute, check, resolve,
    # shrink_execute, shrink_check
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def schedule_diversity(self) -> float:
        return (self.distinct_histories / self.schedules_run
                if self.schedules_run else 0.0)

    def __bool__(self) -> bool:
        return self.ok and self.undecided == 0


def trial_seed(base_seed: int, trial: int) -> str:
    """Stable per-trial seed key (str seeds hash with sha512: stable
    across processes)."""
    return f"{base_seed}:{trial}"


def schedule_seed(trial_seed_key: str, j: int) -> str:
    """Seed key of the j-th schedule of a trial; schedule 0 is the trial
    key itself."""
    return trial_seed_key if j == 0 else f"{trial_seed_key}#{j}"


def program_key(seed_key: str) -> str:
    """The trial key of a schedule key (all schedules share a program)."""
    return seed_key.split("#", 1)[0]


def _trial_ops(cfg: PropertyConfig, trial: int) -> int:
    if not cfg.ramp_sizes or cfg.n_trials <= 1:
        return cfg.max_ops
    frac = (trial + 1) / cfg.n_trials
    return max(2, math.ceil(cfg.max_ops * frac))


def _default_oracle(spec: Spec) -> LineariseBackend:
    """The resolving oracle: ``resilience.failover.host_fallback``, the
    native C++ checker when it builds, else the memoised Python oracle
    (the same verdicts either way)."""
    from ..resilience.failover import host_fallback

    return host_fallback(spec)


def _resolve(spec: Spec, verdicts: np.ndarray, histories: Sequence[History],
             backend: LineariseBackend, oracle: LineariseBackend,
             timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Resolve BUDGET_EXCEEDED verdicts with the host oracle (skipped
    when the backend is the oracle: the same search would repeat)."""
    if backend is oracle:
        return verdicts
    out = verdicts.copy()
    todo = [i for i, v in enumerate(out) if v == Verdict.BUDGET_EXCEEDED]
    if todo:
        t0 = time.perf_counter()
        resolved = oracle.check_histories(spec, [histories[i] for i in todo])
        if timings is not None:
            timings["resolve"] = (timings.get("resolve", 0.0)
                                  + time.perf_counter() - t0)
        for i, v in zip(todo, resolved):
            out[i] = v
    return out


def _execute(sut: ConcurrentSUT, prog: Program, sched_seed: str,
             cfg: PropertyConfig, transport=None) -> History:
    return run_concurrent(sut, prog, seed=sched_seed, faults=cfg.faults,
                          max_steps=cfg.max_steps, transport=transport)


def _execute_many(sut: ConcurrentSUT, jobs, cfg: PropertyConfig,
                  transport=None, executor=None) -> List[History]:
    """Histories of [(program, seed), ...] in job order: serially, or over
    the worker pool (order kept, histories bit-identical)."""
    if executor is not None:
        return executor.run_many(jobs, cfg.faults, cfg.max_steps)
    return [_execute(sut, p, s, cfg, transport) for p, s in jobs]


def shrink_failure(spec: Spec, sut: ConcurrentSUT, backend: LineariseBackend,
                   oracle: LineariseBackend, cfg: PropertyConfig,
                   program: Program, history: History, sched_seed: str,
                   timings: Optional[Dict[str, float]] = None,
                   transport=None, executor=None):
    """Greedy shrink: each round decides all candidates in one backend
    batch and steps to the first (canonical order) still-failing one.
    Returns (min_program, min_history, shrink_steps, histories_checked)."""
    steps = 0
    checked = 0
    timings = timings if timings is not None else {}
    for _ in range(cfg.shrink_rounds):
        cands = dedupe(shrink_candidates(spec, program), cfg.shrink_batch)
        if not cands:
            break
        t0 = time.perf_counter()
        hists = _execute_many(sut, [(c, sched_seed) for c in cands], cfg,
                              transport, executor)
        t1 = time.perf_counter()
        timings["shrink_execute"] = (timings.get("shrink_execute", 0.0)
                                     + t1 - t0)
        raw = backend.check_histories(spec, hists)
        timings["shrink_check"] = (timings.get("shrink_check", 0.0)
                                   + time.perf_counter() - t1)
        verdicts = _resolve(spec, raw, hists, backend, oracle, timings)
        checked += len(hists)
        fail = next((i for i, v in enumerate(verdicts)
                     if v == Verdict.VIOLATION), None)
        if fail is None:
            break
        program, history = cands[fail], hists[fail]
        steps += 1
    return program, history, steps, checked


def prop_concurrent(spec: Spec, sut: ConcurrentSUT,
                    cfg: Optional[PropertyConfig] = None,
                    backend: Optional[LineariseBackend] = None,
                    oracle: Optional[LineariseBackend] = None,
                    sut_factory=None) -> PropertyResult:
    """Generate → execute → linearize → shrink.  ``backend`` defaults to
    the oracle, ``oracle`` to :func:`_default_oracle`.  ``sut_factory``
    (picklable, zero-argument, e.g. ``models.registry.SutFactory``)
    enables the worker pool when ``cfg.executor_workers > 0``."""
    cfg = cfg or PropertyConfig()
    if cfg.minimize_history:
        raise NotImplementedError(
            "minimize_history needs the batched history shrinker, which "
            "this package does not have yet")
    oracle = oracle if oracle is not None else _default_oracle(spec)
    backend = backend or oracle
    transport = executor = None
    # whatever opens a resource sits inside the try, so a failure in any
    # later construction still closes the ones already open
    try:
        use_pool = cfg.executor_workers > 0 and sut_factory is not None
        if cfg.transport != "memory" and not use_pool:
            # one transport for the whole run: its TCP connections last
            # over every trial, schedule and shrink execution.  A pool's
            # workers make their own.
            from ..sched.transport import make_transport

            transport = make_transport(cfg.transport)
        if use_pool:
            from ..sched.pool import PoolExecutor

            executor = PoolExecutor(sut_factory, cfg.executor_workers,
                                    transport=cfg.transport)
        # search-cost accounting rides the timings dict: engines count
        # cumulatively per instance, so the run reports its own delta
        st0 = _run_stats(backend, oracle)
        res = _prop_concurrent_body(spec, sut, cfg, backend, oracle,
                                    transport, executor)
        st = stats_delta(_run_stats(backend, oracle), st0)
        if st is not None:
            res.timings.update(st.to_timings())
        return res
    finally:
        if transport is not None:
            transport.close()
        if executor is not None:
            executor.close()


def _run_stats(backend: LineariseBackend, oracle: LineariseBackend):
    """The backend's search-cost record.  A dispatching backend without
    one reports an empty record, as the JAX package's failover wrapper
    around it does, so that both packages' ``timings`` carry the same
    keys."""
    st = collect_search_stats(backend)
    if st is None and backend is not oracle:
        st = SearchStats()
    return st


def _prop_concurrent_body(spec: Spec, sut: ConcurrentSUT,
                          cfg: PropertyConfig, backend: LineariseBackend,
                          oracle: LineariseBackend, transport=None,
                          executor=None) -> PropertyResult:
    timings: Dict[str, float] = {}

    def _bump(key: str, t0: float) -> None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0

    checked = undecided = schedules_run = distinct = 0
    k = max(1, cfg.schedules_per_program)
    group_target = max(1, cfg.trial_batch)
    group_n = 1
    t = 0
    while t < cfg.n_trials:
        group = list(range(t, min(t + group_n, cfg.n_trials)))
        progs: List[Program] = []
        seeds_all: List[List[str]] = []
        spans: List[int] = []
        jobs: List[tuple] = []
        for ti in group:
            s = trial_seed(cfg.seed, ti)
            t0 = time.perf_counter()
            prog = generate_program(
                spec, seed=random.Random(s).randrange(1 << 62),
                n_pids=cfg.n_pids, max_ops=_trial_ops(cfg, ti))
            _bump("generate", t0)
            seeds = [schedule_seed(s, j) for j in range(k)]
            progs.append(prog)
            seeds_all.append(seeds)
            spans.append(len(jobs))
            jobs.extend((prog, sk) for sk in seeds)
        t0 = time.perf_counter()
        hists_all = _execute_many(sut, jobs, cfg, transport, executor)
        _bump("execute", t0)
        t0 = time.perf_counter()
        pad = group_target * k - len(hists_all)
        check_hists = hists_all + [History([])] * max(pad, 0)
        raw = np.asarray(
            backend.check_histories(spec, check_hists))[:len(hists_all)]
        _bump("check", t0)
        verdicts = _resolve(spec, raw, hists_all, backend, oracle, timings)
        checked += len(hists_all)
        schedules_run += len(hists_all)
        undecided += int(sum(v == Verdict.BUDGET_EXCEEDED for v in verdicts))
        for gi in range(len(group)):
            hists = hists_all[spans[gi]:spans[gi] + k]
            distinct += len({h.fingerprint() for h in hists})
        # the first failing trial in canonical order shrinks
        fail_at = next((i for i, v in enumerate(verdicts)
                        if v == Verdict.VIOLATION), None)
        if fail_at is not None:
            gi = max(i for i, start in enumerate(spans) if start <= fail_at)
            ti = group[gi]
            j = fail_at - spans[gi]
            mp, mh, steps, c2 = shrink_failure(
                spec, sut, backend, oracle, cfg, progs[gi],
                hists_all[fail_at], seeds_all[gi][j], timings, transport,
                executor)
            return PropertyResult(
                ok=False, trials_run=ti + 1,
                histories_checked=checked + c2, undecided=undecided,
                schedules_run=schedules_run, distinct_histories=distinct,
                timings=timings,
                counterexample=Counterexample(
                    program=mp, history=mh, trial=ti,
                    trial_seed=seeds_all[gi][j], shrink_steps=steps))
        t += len(group)
        group_n = min(group_target, group_n * 2)
    return PropertyResult(ok=True, trials_run=cfg.n_trials,
                          histories_checked=checked, undecided=undecided,
                          schedules_run=schedules_run,
                          distinct_histories=distinct, timings=timings)


def replay(spec: Spec, sut: ConcurrentSUT, trial_seed_key: str,
           cfg: Optional[PropertyConfig] = None) -> History:
    """Reproduce a trial's history exactly from its seed key."""
    cfg = cfg or PropertyConfig()
    prog_key = program_key(trial_seed_key)
    _, t = prog_key.rsplit(":", 1)
    prog = generate_program(
        spec, seed=random.Random(prog_key).randrange(1 << 62),
        n_pids=cfg.n_pids, max_ops=_trial_ops(cfg, int(t)))
    # one run: pass the transport's name, so that the run owns and
    # closes it
    return _execute(sut, prog, trial_seed_key, cfg,
                    None if cfg.transport == "memory" else cfg.transport)
