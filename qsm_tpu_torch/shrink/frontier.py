"""The shrink frontier: every candidate of one greedy round.

The counterpart of the JAX package's ``qsm_tpu/shrink/frontier.py``.
The shrinker minimises the failing history itself (not the program), so
an external trace shrinks without a scheduler or a system under test.  A
candidate is a transformation of the failing history whose verdict is
decided by checking it again, never assumed:

* **op-subset shrinks** drop ops and keep the original timestamps (the
  survivors' real-time order is a sub-order of the original's,
  ``History.subhistory``):

  - *drop-key*: with a validated per-key projection (``CmdSig.proj``,
    the gate ``ops/pcomp.py`` trusts), every op of one partition key at
    once;
  - *drop-pid*: every op of one pid;
  - *drop-one*: each single op, the axis 1-minimality is defined on.

* **schedule shrinks** commute one adjacent, non-overlapping pair of ops
  toward a canonical order: ops ``i -> j`` adjacent in invocation order
  with ``resp_i < inv_j`` swap their time intervals when ``i`` sorts
  after ``j`` by ``(cmd, arg, pid, resp)``.  The size stays, the count of
  inversions against the canonical order drops by one, so greedy
  acceptance terminates (the shrinker's measure is ``(n_ops,
  inversions)``).

The frontier of an ``n``-op history has at most ``keys + pids + n +
(n - 1)`` candidates before deduplication, and :func:`shrink_frontier`
caps it explicitly (``max_lanes``) and says by how much.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

from ..core.history import History
from ..core.spec import Spec, projection_report


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One frontier member: the transformed history plus provenance.

    ``order`` is the canonical sort key of the whole frontier —
    ``(n_ops, kind_rank, index)`` — so "the smallest still-failing
    candidate" means the same history on every engine, platform and
    serve path (decomposed == undecomposed shrink parity rests on it).
    """

    history: History
    kind: str       # "drop-key" | "drop-pid" | "drop-one" | "swap"
    detail: int     # key / pid / op index / left-op index

    @property
    def order(self) -> Tuple[int, int, int]:
        rank = {"drop-key": 0, "drop-pid": 1, "drop-one": 2,
                "swap": 3}[self.kind]
        return (len(self.history), rank, self.detail)


def _canon_key(op) -> Tuple[int, int, int, int]:
    return (op.cmd, op.arg, op.pid, op.resp)


def inversions(history: History) -> int:
    """Adjacent-comparable inversion count against the canonical op
    order — the schedule-shrink half of the termination measure.  O(n²)
    on histories that are already small by the time swaps matter."""
    keys = [_canon_key(o) for o in history.ops]
    return sum(1 for i in range(len(keys))
               for j in range(i + 1, len(keys)) if keys[i] > keys[j])


def drop_key_candidates(spec: Spec, history: History
                        ) -> Iterator[Candidate]:
    """One candidate per partition key (all that key's ops dropped) —
    only when the spec's projection VALIDATES (an invalid declaration
    must never steer shrinking: the key axis would group ops
    arbitrarily) and the history touches more than one key."""
    if projection_report(spec):
        return
    from ..ops.pcomp import history_keys

    try:
        sorted_keys = history_keys(spec, history)
    except ValueError:
        return  # runtime non-totality: refuse the axis, like pcomp
    if len(sorted_keys) < 2:
        return
    groups: dict = {k: [] for k in sorted_keys}
    for j, op in enumerate(history.ops):
        groups[spec.partition_key(op.cmd, op.arg)].append(j)
    all_idx = set(range(len(history.ops)))
    for key in sorted_keys:
        yield Candidate(history.subhistory(all_idx - set(groups[key])),
                        "drop-key", key)


def drop_pid_candidates(history: History) -> Iterator[Candidate]:
    pids: dict = {}
    for j, op in enumerate(history.ops):
        pids.setdefault(op.pid, []).append(j)
    if len(pids) < 2:
        return
    all_idx = set(range(len(history.ops)))
    for pid in sorted(pids):
        yield Candidate(history.subhistory(all_idx - set(pids[pid])),
                        "drop-pid", pid)


def drop_one_candidates(history: History) -> Iterator[Candidate]:
    n = len(history.ops)
    for j in range(n):
        yield Candidate(
            history.subhistory([i for i in range(n) if i != j]),
            "drop-one", j)


def swap_candidates(history: History) -> Iterator[Candidate]:
    """Commute adjacent non-overlapping pairs toward canonical order
    (module docstring).  The swapped pair exchanges time INTERVALS, so
    the result is a history of the same ops under a different schedule;
    pending ops never swap (a pending op precedes nothing, so there is
    no adjacency to commute)."""
    ops = history.ops
    for i in range(len(ops) - 1):
        a, b = ops[i], ops[i + 1]
        if a.is_pending or b.is_pending:
            continue
        if not a.response_time < b.invoke_time:
            continue  # overlapping: no real-time order to commute
        if _canon_key(a) <= _canon_key(b):
            continue  # already canonical: swapping would not shrink
        swapped = list(ops)
        swapped[i] = dataclasses.replace(
            b, invoke_time=a.invoke_time, response_time=a.response_time)
        swapped[i + 1] = dataclasses.replace(
            a, invoke_time=b.invoke_time, response_time=b.response_time)
        yield Candidate(History(swapped, seed=history.seed,
                                program_id=history.program_id),
                        "swap", i)


def shrink_frontier(spec: Spec, history: History,
                    max_lanes: int = 512,
                    schedule: bool = True,
                    ) -> Tuple[List[Candidate], int]:
    """The whole frontier of one round, deduped by fingerprint and
    sorted by :attr:`Candidate.order` (smallest-first — the greedy
    selection rule), capped at ``max_lanes``.

    Returns ``(candidates, truncated)``: a nonzero ``truncated`` count
    is surfaced in the shrinker's ``why`` — a bounded frontier must say
    it was bounded, never silently narrow the search (the no-silent-caps
    discipline)."""
    seen = {history.fingerprint()}
    out: List[Candidate] = []
    gens = [drop_key_candidates(spec, history),
            drop_pid_candidates(history),
            drop_one_candidates(history)]
    if schedule:
        gens.append(swap_candidates(history))
    for gen in gens:
        for cand in gen:
            fp = cand.history.fingerprint()
            if fp in seen:
                continue
            seen.add(fp)
            out.append(cand)
    out.sort(key=lambda c: c.order)
    truncated = max(0, len(out) - max_lanes)
    return out[:max_lanes], truncated
