"""Shared corpus construction: seeded programs executed under the
deterministic scheduler, cycling through correct and racy
implementations."""

from __future__ import annotations

from typing import List, Sequence

from ..core.generator import generate_program
from ..core.history import History
from ..sched.runner import run_concurrent


def build_corpus(spec, sut_factories: Sequence, n: int, n_pids: int,
                 max_ops: int, seed_base: int = 0,
                 seed_prefix: str = "corpus",
                 complete: bool = True) -> List[History]:
    """``n`` histories cycling through ``sut_factories`` (callables taking
    the spec), with fully deterministic seeds; ``complete`` drops pending
    ops."""
    hists = []
    for i in range(n):
        sut = sut_factories[i % len(sut_factories)](spec)
        prog = generate_program(spec, seed=seed_base + i, n_pids=n_pids,
                                max_ops=max_ops)
        h = run_concurrent(sut, prog, seed=f"{seed_prefix}:{i}")
        hists.append(h.completed() if complete else h)
    return hists
