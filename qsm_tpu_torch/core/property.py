"""Property layer: ``prop_concurrent``, the state-machine property loop.

Per trial: generate a program → execute it under the deterministic
scheduler (k seeded schedules) → check the histories in one backend batch
→ on a violation, shrink.  Every shrink round executes all candidates and
decides them in one backend batch.  BUDGET_EXCEEDED verdicts from a
device backend are resolved by the exact host oracle (the native C++
checker when it builds, else the memoised Python oracle), so the
property's verdicts are always exact.

A backend that is not the oracle is wrapped in
``resilience.failover.FailoverBackend`` with the oracle as its fallback,
as in the JAX package: an injected dispatch fault (and on the host any
device error) degrades the run to the oracle instead of ending it; on
the card a real device error raises.  With ``minimize_history`` the
failing history is also minimised by the batched shrinker
(``shrink/``), on the run's own backend.
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
from ..search.stats import collect_search_stats, stats_delta
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
    # after the program-level shrink, minimise the failing history itself
    # through the batched history shrinker (shrink/): a 1-minimal
    # sub-history or reschedule, kept in Counterexample.minimized_history
    # beside the replayable counterexample
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
    # the history shrinker's 1-minimal form of ``history`` (with
    # PropertyConfig.minimize_history; still a VIOLATION, not replayable)
    minimized_history: Optional[History] = None


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
    # shrink_execute, shrink_check, shrink_minimize; and the search-cost
    # and shrink counters
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
    """Resolve BUDGET_EXCEEDED verdicts with the host oracle, except
    where the oracle itself decided them: when the backend is the oracle,
    or on the lanes that a failover wrapper's last call sent to it (its
    ``last_fallback``), the same search would repeat.  The lanes a device
    decided before a degrade in the same batch are still resolved (the
    JAX package skips the whole batch once its wrapper has degraded)."""
    if backend is oracle:
        return verdicts
    out = verdicts.copy()
    skip = np.zeros(len(out), bool)
    if getattr(backend, "fallback", None) is oracle:
        # a padded batch: its real lanes come first
        fell = np.asarray(getattr(backend, "last_fallback", skip), bool)
        skip = fell[:len(out)] if len(fell) >= len(out) else skip
    todo = [i for i, v in enumerate(out)
            if v == Verdict.BUDGET_EXCEEDED and not skip[i]]
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


def _minimize_history(spec: Spec, backend: LineariseBackend,
                      history: History, timings: Dict[str, float]):
    """The history shrinker on the run's own backend (a frontier is one
    more batch to it), its ``shrink_*`` counters merged into the run's
    timings.  Returns (minimised history or None, lanes checked)."""
    from ..shrink.shrinker import shrink_history

    t0 = time.perf_counter()
    res = shrink_history(spec, history, backend=backend, certificate=False)
    timings["shrink_minimize"] = (timings.get("shrink_minimize", 0.0)
                                  + time.perf_counter() - t0)
    if res.ok:
        # only the shrink_* keys merge here: the search_* entries stay the
        # backend's delta that prop_concurrent takes at the end (which
        # counts the frontier dispatches already)
        timings.update({k: v
                        for k, v in res.search_stats().to_timings().items()
                        if k.startswith("shrink_")})
        return res.history, res.lanes_checked
    return None, res.lanes_checked


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
        from ..resilience.failover import FailoverBackend

        # a lost dispatch degrades to the resolving oracle instead of
        # ending the run (the card's rule aside: resilience/failover.py);
        # a backend wrapped already keeps its own fallback
        if backend is not oracle \
                and not isinstance(backend, FailoverBackend):
            backend = FailoverBackend(spec, backend, fallback=oracle)
        # search-cost accounting rides the timings dict: engines count
        # cumulatively per instance, so the run reports its own delta,
        # taken on the wrapper (its resilience counters with it)
        st0 = collect_search_stats(backend)
        res = _prop_concurrent_body(spec, sut, cfg, backend, oracle,
                                    transport, executor)
        st = stats_delta(collect_search_stats(backend), st0)
        if st is not None:
            res.timings.update(st.to_timings())
        return res
    finally:
        if transport is not None:
            transport.close()
        if executor is not None:
            executor.close()


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
            minimized = None
            if cfg.minimize_history:
                minimized, c3 = _minimize_history(spec, backend, mh,
                                                  timings)
                c2 += c3
            return PropertyResult(
                ok=False, trials_run=ti + 1,
                histories_checked=checked + c2, undecided=undecided,
                schedules_run=schedules_run, distinct_histories=distinct,
                timings=timings,
                counterexample=Counterexample(
                    program=mp, history=mh, trial=ti,
                    trial_seed=seeds_all[gi][j], shrink_steps=steps,
                    minimized_history=minimized))
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
