"""Worker pools for the scheduler plane: schedules and whole exploration
trees fanned over processes.

Every history is a pure function of (SUT factory, program, seed,
faults), so fanning executions over worker processes changes wall-clock,
never histories: results are bit-identical to the serial path.  Workers
are spawned (never forked: a parent that initialised CUDA must not fork)
and live for the whole run; each builds its SUT once from a picklable
factory (``qsm_tpu_torch.models.registry.SutFactory`` or any module-level
callable).  The scheduler plane is host-only, and a worker's
initialisation touches neither CUDA nor ``ops.kernels``: device batches
stay in the parent.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from typing import List, Optional, Sequence, Tuple

from ..core.history import History

_STATE: dict = {}


def _init_worker(sut_factory, transport_spec: str) -> None:
    from .transport import make_transport

    _STATE["sut"] = sut_factory()
    _STATE["transport"] = (None if transport_spec == "memory"
                           else make_transport(transport_spec))


def _probe_ok() -> bool:
    """Initialisation probe: returns only once _init_worker succeeded."""
    return "sut" in _STATE


def _run_one(job) -> History:
    from .runner import run_concurrent

    prog, seed, faults, max_steps = job
    return run_concurrent(_STATE["sut"], prog, seed, faults=faults,
                          max_steps=max_steps,
                          transport=_STATE["transport"])


class _SpawnPool:
    """The two pools' shared lifecycle: the spawn context, a bounded
    initialisation probe (``multiprocessing.Pool`` respawns a crashing
    worker forever, so a factory that fails in a fresh interpreter would
    otherwise wedge the first map without a word), and terminate on
    close."""

    PROBE_TIMEOUT_S = 60.0

    def __init__(self, initializer, initargs,
                 n_workers: Optional[int] = None):
        self.n_workers = n_workers or min(8, os.cpu_count() or 2)
        ctx = multiprocessing.get_context("spawn")
        self._pool = ctx.Pool(self.n_workers, initializer=initializer,
                              initargs=initargs)
        self._probed = False

    def _probe_fn(self):  # a picklable callable, True once init ran
        raise NotImplementedError

    def _probe(self) -> None:
        if self._probed:
            return
        try:
            self._pool.apply_async(self._probe_fn()).get(
                self.PROBE_TIMEOUT_S)
        except multiprocessing.TimeoutError:
            self.close()
            raise RuntimeError(
                "worker pool failed to initialize within "
                f"{self.PROBE_TIMEOUT_S:.0f}s — the sut_factory probably "
                "crashes in a fresh interpreter (it must be picklable "
                "and importable under the spawn start method; use "
                "models.registry.SutFactory)") from None
        self._probed = True

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()


def _init_explore_worker(sut_factory) -> None:
    _STATE["sut_factory"] = sut_factory


def _explore_probe_ok() -> bool:
    return "sut_factory" in _STATE


def _explore_one(job):
    """Enumerate one program's delivery tree in this worker (the checker
    batch stays in the parent): (histories, schedules, exhausted,
    pruned, seconds).  A job may carry its own SUT factory."""
    from .systematic import _enumerate

    prog, max_schedules, max_steps, prune, faults, factory = job
    t0 = time.perf_counter()
    hists, schedules, exhausted, pruned_n = _enumerate(
        factory or _STATE["sut_factory"], prog, max_schedules, max_steps,
        prune=prune, faults=faults)
    return hists, schedules, exhausted, pruned_n, time.perf_counter() - t0


class ExplorePool(_SpawnPool):
    """Whole-tree enumerations over a persistent spawn pool.  One tree is
    milliseconds to seconds of replay, coarse enough that dispatch is
    noise; enumeration is deterministic a program, so results equal the
    serial walk's, and the union batch is decided by the caller in one
    backend call.  One pool serves many sweeps: a call may name its own
    factory (``sut_factory=``), which its jobs carry to the workers."""

    def __init__(self, sut_factory=None, n_workers: Optional[int] = None):
        super().__init__(_init_explore_worker, (sut_factory,),
                         n_workers=n_workers)

    def _probe_fn(self):
        return _explore_probe_ok

    def explore_many(self, programs: Sequence, max_schedules: int,
                     max_steps: int, prune: bool, faults,
                     sut_factory=None) -> List[Tuple]:
        """[(histories, schedules, exhausted, pruned, seconds)] in
        program order; ``sut_factory`` (picklable) overrides the pool's
        for this call."""
        self._probe()
        payload = [(p, max_schedules, max_steps, prune, faults, sut_factory)
                   for p in programs]
        # chunksize 1: trees are uneven, pre-chunking would queue a big
        # tree behind small ones
        return self._pool.map(_explore_one, payload, chunksize=1)


class PoolExecutor(_SpawnPool):
    """(program, seed) jobs over a persistent process pool, in input
    order (so every later decision is the serial one)."""

    def __init__(self, sut_factory, n_workers: Optional[int] = None,
                 transport: str = "memory"):
        super().__init__(_init_worker, (sut_factory, transport),
                         n_workers=n_workers)
        self.jobs_run = 0

    def _probe_fn(self):
        return _probe_ok

    def run_many(self, jobs: Sequence[Tuple], faults, max_steps: int
                 ) -> List[History]:
        """Histories of jobs = [(program, seed), ...] in job order,
        bit-identical to serial execution."""
        self._probe()
        payload = [(p, s, faults, max_steps) for p, s in jobs]
        # one chunk a worker: each call is a barrier anyway
        chunk = max(1, -(-len(payload) // self.n_workers))
        out = self._pool.map(_run_one, payload, chunksize=chunk)
        self.jobs_run += len(out)
        return out
