"""Seeded program generation and shrinking.

A *program* is a parallel program: every op is assigned to a pid, and each
pid executes its ops in order.  All nondeterminism flows from an explicit
seed, so (seed, config) reproduces any program exactly.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator, List, Tuple

from .spec import Spec


@dataclasses.dataclass(frozen=True)
class ProgOp:
    """One generated command, assigned to a logical process."""

    pid: int
    cmd: int
    arg: int


@dataclasses.dataclass(frozen=True)
class Program:
    """Ops in global generation order; per-pid order is the subsequence
    with that pid."""

    ops: Tuple[ProgOp, ...]
    n_pids: int

    def per_pid(self) -> List[List[ProgOp]]:
        out: List[List[ProgOp]] = [[] for _ in range(self.n_pids)]
        for op in self.ops:
            out[op.pid].append(op)
        return out

    def __len__(self) -> int:
        return len(self.ops)


def generate_program(spec: Spec, seed, n_pids: int, max_ops: int,
                     min_ops: int = 1) -> Program:
    """Seeded, precondition-respecting program generation.  An
    approximate model state (advanced with the model's first valid
    response) steers ``spec.gen_cmd``."""
    rng = random.Random(seed)
    n_ops = rng.randint(min_ops, max_ops)
    ops = []
    state = [int(v) for v in spec.initial_state()]
    for _ in range(n_ops):
        pid = rng.randrange(n_pids)
        cmd, arg = spec.gen_cmd(rng, state)
        ops.append(ProgOp(pid=pid, cmd=cmd, arg=arg))
        for resp in spec.resp_domain(cmd):
            new_state, ok = spec.step_py(list(state), cmd, arg, resp)
            if ok:
                state = [int(v) for v in new_state]
                break
    return Program(ops=tuple(ops), n_pids=n_pids)


def shrink_candidates(spec: Spec, prog: Program) -> Iterator[Program]:
    """Smaller candidate programs, most aggressive first: drop halves,
    then single ops; shrink args toward zero; move ops onto fewer pids.
    Per-pid order of the surviving ops is preserved."""
    ops = list(prog.ops)
    n = len(ops)
    k = n // 2
    while k >= 1:
        for start in range(0, n - k + 1, k):
            rest = ops[:start] + ops[start + k:]
            if rest:
                yield Program(tuple(rest), prog.n_pids)
        k //= 2
    for i, op in enumerate(ops):
        for smaller in spec.shrink_arg(op.cmd, op.arg):
            cand = list(ops)
            cand[i] = ProgOp(op.pid, op.cmd, smaller)
            yield Program(tuple(cand), prog.n_pids)
    used = sorted({op.pid for op in ops})
    if len(used) > 1:
        drop = used[-1]
        cand = [ProgOp(0 if op.pid == drop else op.pid, op.cmd, op.arg)
                for op in ops]
        yield Program(tuple(cand), prog.n_pids)


def dedupe(programs: Iterator[Program], limit: int) -> List[Program]:
    """Collect up to ``limit`` distinct candidates preserving order."""
    seen = set()
    out = []
    for p in programs:
        key = (p.n_pids, p.ops)
        if key in seen:
            continue
        seen.add(key)
        out.append(p)
        if len(out) >= limit:
            break
    return out
