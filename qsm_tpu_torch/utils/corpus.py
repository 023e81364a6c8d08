"""Shared corpus construction: seeded programs executed under the
deterministic scheduler, cycling through correct and racy
implementations."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core.generator import generate_program
from ..core.history import History
from ..ops.dfs_kernel import Tables
from ..sched.runner import run_concurrent


def random_lane_tables(n_ops: int, n_states: int, lanes: int, seed: int,
                       device) -> Tables:
    """``dfs_chunk`` tables for ``lanes`` random lanes (numpy, from
    ``seed``): each op an interval (invocations uniform over ``[0,
    n_ops)``, durations exponential with mean 8), so ``prec`` is a
    real-time order with many ops concurrent; each op invalid with
    probability 0.05; ``ok`` set with probability 0.3, which leaves many
    lanes searching for hundreds of iterations; next states uniform in
    ``[0, n_states)`` with one entry in 50 outside it (-1 or
    ``n_states``)."""
    N, S, B = n_ops, n_states, lanes
    rng = np.random.default_rng(seed)
    inv = np.sort(rng.uniform(0, N, (B, N)), axis=1)
    resp = inv + rng.exponential(8.0, (B, N))
    valid = (rng.random((B, N)) >= 0.05).astype(np.int32)
    # bit i of prec[j]: op i responded before op j was invoked
    before = (resp[:, :, None] < inv[:, None, :]) & (valid[:, :, None] == 1)
    pw = (before.astype(np.uint64)
          << np.arange(N, dtype=np.uint64)[None, :, None]).sum(axis=1)
    prec = pw.astype(np.uint32).view(np.int32).T
    ok = (rng.random((S, N, B)) < 0.3).astype(np.int32)
    nxt = rng.integers(0, S, (S, N, B)).astype(np.int32)
    out = rng.random((S, N, B)) < 0.02
    nxt[out] = rng.choice(np.array([-1, S], np.int32), int(out.sum()))
    nreq = valid.sum(axis=1, dtype=np.int32)[None]
    return Tables(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (nxt, ok, prec, valid.T, nreq)))


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
