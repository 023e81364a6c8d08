"""Schedule-coverage statistics: how many distinct interleavings a set of
seeds explores.  If many seeds collapse onto few schedules, the race
detector is weaker than its trial count suggests.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from ..core.generator import Program
from ..sched.runner import prepare_run
from ..sched.scheduler import FaultPlan


@dataclasses.dataclass
class CoverageStats:
    seeds: int
    distinct_schedules: int  # distinct delivery-order traces
    distinct_histories: int  # distinct (op, resp, interval) sequences

    @property
    def schedule_diversity(self) -> float:
        return self.distinct_schedules / max(self.seeds, 1)


def schedule_coverage(sut_factory, program: Program, seeds: Iterable,
                      faults: Optional[FaultPlan] = None,
                      max_steps: int = 100_000) -> CoverageStats:
    """Run ``program`` under each seed; count distinct schedules/histories.

    ``sut_factory`` must build a fresh SUT a run.  The schedule's
    signature is the scheduler's trace of delivered message uids: exactly
    the nondeterminism the seed controls.
    """
    schedules, histories = set(), set()
    n = 0
    for seed in seeds:
        n += 1
        sched, rec = prepare_run(sut_factory(), program, seed,
                                 faults=faults, max_steps=max_steps)
        sched.run()
        schedules.add(tuple(sched.trace))
        h = rec.history()
        histories.add(h.fingerprint())
    return CoverageStats(seeds=n, distinct_schedules=len(schedules),
                         distinct_histories=len(histories))
