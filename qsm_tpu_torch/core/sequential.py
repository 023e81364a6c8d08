"""The sequential property: ``prop_sequential``.

Runs a generated program one command at a time against a sequential SUT,
checking precondition, execution, postcondition and transition at every
step.  No scheduler and no lineariser: host-only, and the debugging
baseline for every spec / SUT pair.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional, Protocol

from .generator import (Program, dedupe, generate_program,
                        shrink_candidates)
from .history import History, Op
from .spec import Spec


class SequentialSUT(Protocol):
    """A system under test driven one atomic command at a time."""

    def reset(self) -> None: ...
    def apply(self, cmd: int, arg: int) -> int: ...


class ModelSUT:
    """The spec's own model run as an SUT (always linearisable by
    construction) — used to validate specs and the checker itself."""

    def __init__(self, spec: Spec):
        self.spec = spec
        self.reset()

    def reset(self) -> None:
        self.state = [int(v) for v in self.spec.initial_state()]

    def apply(self, cmd: int, arg: int) -> int:
        for resp in self.spec.resp_domain(cmd):
            new_state, ok = self.spec.step_py(list(self.state), cmd, arg, resp)
            if ok:
                self.state = [int(v) for v in new_state]
                return resp
        raise AssertionError(
            f"model has no valid response for cmd={cmd} arg={arg} "
            f"state={self.state}")


@dataclasses.dataclass
class SequentialResult:
    ok: bool
    history: History
    failed_at: Optional[int] = None  # index of first postcondition failure


def run_sequential(spec: Spec, sut: SequentialSUT, program: Program
                   ) -> SequentialResult:
    """Execute ``program`` sequentially; verify each response against the
    model inline.  Returns the (sequential) history for regression dumps."""
    sut.reset()
    state = [int(v) for v in spec.initial_state()]
    t = 0
    ops = []
    for idx, op in enumerate(program.ops):
        resp = sut.apply(op.cmd, op.arg)
        ops.append(Op(pid=op.pid, cmd=op.cmd, arg=op.arg, resp=resp,
                      invoke_time=t, response_time=t + 1))
        t += 2
        new_state, ok = spec.step_py(state, op.cmd, op.arg, resp)
        if not ok:
            return SequentialResult(False, History(ops), failed_at=idx)
        state = [int(v) for v in new_state]
    return SequentialResult(True, History(ops))


@dataclasses.dataclass
class SequentialPropertyResult:
    ok: bool
    trials_run: int
    counterexample: Optional[Program] = None
    history: Optional[History] = None
    failed_at: Optional[int] = None
    trial_seed: Optional[str] = None  # replay key, same contract as the
    # concurrent Counterexample.trial_seed: regenerate the program with
    # random.Random(key).randrange(1 << 62)
    shrink_steps: int = 0


def _shrink_sequential(spec: Spec, sut: SequentialSUT, program: Program,
                       result: SequentialResult, rounds: int = 200):
    """Greedy QC-style shrink for the sequential property: re-run each
    candidate (sequential execution is cheap) and step to the first one
    still failing.  ``result`` is the caller's already-failing run of
    ``program`` (no redundant re-execution)."""
    steps = 0
    for _ in range(rounds):
        nxt = None
        for cand in dedupe(shrink_candidates(spec, program), 256):
            res = run_sequential(spec, sut, cand)
            if not res.ok:
                nxt = (cand, res)
                break
        if nxt is None:
            break
        program, result = nxt
        steps += 1
    return program, result, steps


def prop_sequential(spec: Spec, sut: SequentialSUT, n_trials: int = 100,
                    n_pids: int = 1, max_ops: int = 12, seed: int = 0
                    ) -> SequentialPropertyResult:
    """Generate → run sequentially with inline postcondition checks →
    shrink failures.
    Deterministic from ``seed``; no scheduler, no lineariser.  Seed keys
    come from the SAME per-trial derivation as the concurrent property —
    but programs only coincide across the two paths when the op counts
    do: the concurrent property RAMPS sizes over the trial sequence by
    default (``PropertyConfig.ramp_sizes``) while this path uses
    ``max_ops`` throughout, so cross-referencing a trial seed between
    the two replays the same generator stream at possibly different
    lengths."""
    # function-local: property.py sits above this module (it imports
    # sched/ and ops/)
    from .property import trial_seed

    for t in range(n_trials):
        key = trial_seed(seed, t)
        prog = generate_program(
            spec, seed=random.Random(key).randrange(1 << 62),
            n_pids=n_pids, max_ops=max_ops)
        res = run_sequential(spec, sut, prog)
        if not res.ok:
            mp, mres, steps = _shrink_sequential(spec, sut, prog, res)
            return SequentialPropertyResult(
                ok=False, trials_run=t + 1, counterexample=mp,
                history=mres.history, failed_at=mres.failed_at,
                trial_seed=key, shrink_steps=steps)
    return SequentialPropertyResult(ok=True, trials_run=n_trials)
