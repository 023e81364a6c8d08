"""P-compositionality: per-key decomposition of linearizability checking.

The counterpart of the JAX package's ``qsm_tpu/ops/pcomp.py``.  For a spec
that is a product of independent per-key objects (a KV map, an array of
registers or CAS cells), a history is linearizable iff each key's
sub-history is linearizable against the per-key object (Horn and
Kroening).  Search cost is exponential in history length, so the split
turns one 64-op history over a 16-key map into a dozen short sub-problems
that land in the smallest op bucket and in the table regime of the device
search.

Soundness rests on the spec's declaration, validated once
(``core.spec.projection_report``): every command maps to a key, the
projected spec models one key faithfully, and keys are independent.  An
invalid declaration raises :class:`NotDecomposableError`; the split is
never trusted unchecked.

A LINEARIZABLE verdict of the decomposed path carries a stitched
whole-history witness: the per-key witnesses merged into one order that
respects whole-history real-time precedence, which ``verify_witness``
replays without search.  The merge always exists: a cycle among per-key
witness edges and cross-key real-time edges would collapse, by
transitivity of the timestamps, into a real-time edge within one key,
which that key's witness already respects.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.history import NO_RESP, OP_BUCKETS, History, Op
from ..core.spec import Spec, projection_report
from .backend import LineariseBackend, Verdict


def split_history(spec: Spec, history: History) -> Dict[int, History]:
    """Per-key sub-histories of the projected spec.  Timestamps are kept,
    so real-time precedence within a key is the induced sub-order;
    precedence across keys is dropped, which is what the theorem
    allows."""
    return {k: h for k, (h, _)
            in split_history_indexed(spec, history).items()}


def _key_of(spec: Spec, op: Op) -> int:
    key = spec.partition_key(op.cmd, op.arg)
    if key is None:
        raise ValueError(
            f"{spec.name}: partition_key is not total "
            f"(cmd={op.cmd}, arg={op.arg}); cannot decompose")
    return key


def split_history_indexed(
    spec: Spec, history: History
) -> Dict[int, Tuple[History, List[int]]]:
    """Like :func:`split_history`, with each sub-history's map from sub-op
    position to the op's index in ``history`` (what witness stitching
    needs)."""
    per_key: Dict[int, Tuple[List[Op], List[int]]] = {}
    for j, op in enumerate(history.ops):
        key = _key_of(spec, op)
        if op.is_pending:
            cmd, arg, _ = spec.project_op(op.cmd, op.arg, 0)
            resp = NO_RESP
        else:
            cmd, arg, resp = spec.project_op(op.cmd, op.arg, op.resp)
        ops, idx = per_key.setdefault(key, ([], []))
        ops.append(dataclasses.replace(op, cmd=cmd, arg=arg, resp=resp))
        idx.append(j)
    return {k: (History(ops, seed=history.seed,
                        program_id=history.program_id), idx)
            for k, (ops, idx) in per_key.items()}


class NotDecomposableError(ValueError):
    """The spec declares no per-key projection, or one that the validator
    refuses.  A type of its own, so that a caller (the CLI) turns exactly
    this misconfiguration into a clean refusal."""


# ---------------------------------------------------------------------------
# whether a split buys a smaller op bucket
# ---------------------------------------------------------------------------

def bucket_or_none(n_ops: int) -> Optional[int]:
    """The op bucket ``n_ops`` lands in, or None past the largest."""
    n = max(int(n_ops), 1)
    for b in OP_BUCKETS:
        if n <= b:
            return b
    return None


def longest_sub(spec: Spec, history: History) -> int:
    """Length of the longest per-key sub-history, by counting."""
    counts: Dict[int, int] = {}
    for op in history.ops:
        key = _key_of(spec, op)
        counts[key] = counts.get(key, 0) + 1
    return max(counts.values(), default=0)


def history_keys(spec: Spec, history: History) -> List[int]:
    """Sorted distinct keys a history's ops touch."""
    return sorted({_key_of(spec, op) for op in history.ops})


def split_gain(spec: Spec, history: History) -> bool:
    """True when the split lands in a strictly smaller op bucket (or makes
    a history past the largest bucket checkable at all)."""
    sub = bucket_or_none(longest_sub(spec, history))
    if sub is None:
        return False
    whole = bucket_or_none(len(history))
    return whole is None or sub < whole


class PComp:
    """Backend combinator: split every history of a batch per key, decide
    all sub-histories of the batch in one call of the inner backend, and
    fold them per history: VIOLATION if any key violates, else
    BUDGET_EXCEEDED if any key is undecided, else LINEARIZABLE.

    ``make_inner(projected_spec)`` builds the inner backend (a factory,
    since a device backend binds to one spec); the default is the
    memoised host oracle.  Construction validates the spec's projection
    and raises :class:`NotDecomposableError` on a refused one."""

    def __init__(self, spec: Spec, make_inner=None):
        from .wing_gong_cpu import WingGongCPU

        self.spec = spec
        problems = projection_report(spec)
        if problems:
            raise NotDecomposableError(
                f"spec {spec.name!r} is not per-key decomposable: "
                + "; ".join(problems)
                + " (P-compositionality, PAPERS.md:5; declare CmdSig.proj "
                  "+ projected_spec(), or use a whole-history backend)")
        self.projected = spec.projected_spec()
        self.inner: LineariseBackend = (
            make_inner(self.projected) if make_inner is not None
            else WingGongCPU(memo=True))
        self.name = f"pcomp({self.inner.name})"
        # per-key witness search and BUDGET_EXCEEDED resolution, built on
        # first use
        self._witness_oracle = None
        self.histories_seen = 0
        self.split_histories = 0   # inputs that split into more than 1 key
        self.subs_produced = 0     # per-key sub-histories dispatched
        self.max_sub_len = 0       # longest sub-history seen (ops)
        self.recombine_s = 0.0     # host time: split, fold and stitch

    def _count(self, sub_lens: Sequence[int]) -> None:
        self.subs_produced += len(sub_lens)
        if len(sub_lens) > 1:
            self.split_histories += 1
        self.max_sub_len = max(self.max_sub_len, max(sub_lens, default=0))

    # ------------------------------------------------------------------
    def check_histories(self, spec: Spec, histories: Sequence[History]
                        ) -> np.ndarray:
        assert spec is self.spec, "PComp is bound to one spec"
        t0 = time.perf_counter()
        self.histories_seen += len(histories)
        flat: List[History] = []
        groups: List[slice] = []
        for h in histories:
            start = len(flat)
            subs = split_history(spec, h)
            flat.extend(subs.values())
            groups.append(slice(start, len(flat)))
            self._count([len(s) for s in subs.values()])
        out = np.full(len(histories), int(Verdict.LINEARIZABLE), np.int8)
        if not flat:
            self.recombine_s += time.perf_counter() - t0
            return out
        t1 = time.perf_counter()
        self.recombine_s += t1 - t0
        sub = self.inner.check_histories(self.projected, flat)
        t2 = time.perf_counter()
        for i, g in enumerate(groups):
            v = sub[g]
            if (v == Verdict.VIOLATION).any():
                out[i] = int(Verdict.VIOLATION)
            elif (v == Verdict.BUDGET_EXCEEDED).any():
                out[i] = int(Verdict.BUDGET_EXCEEDED)
        self.recombine_s += time.perf_counter() - t2
        return out

    # ------------------------------------------------------------------
    def check_witness(self, spec: Spec, history: History):
        """(verdict, witness): the per-key witnesses stitched into one
        whole-history linearization, or None when the verdict is not
        LINEARIZABLE."""
        assert spec is self.spec, "PComp is bound to one spec"
        subs = split_history_indexed(spec, history)
        self.histories_seen += 1
        self._count([len(h) for h, _ in subs.values()])
        chains: List[List[Tuple[int, int]]] = []
        for key in sorted(subs):
            sub_h, idx = subs[key]
            v, w = self._sub_witness(sub_h)
            if v != Verdict.LINEARIZABLE:
                return v, None
            chains.append([(idx[j], resp) for j, resp in w])
        t0 = time.perf_counter()
        witness = stitch_witness(history, chains)
        self.recombine_s += time.perf_counter() - t0
        return Verdict.LINEARIZABLE, witness

    def _sub_witness(self, sub_h: History):
        """One key's (verdict, witness): from the inner backend when it
        gives witnesses, with BUDGET_EXCEEDED resolved on the memoised
        host oracle (the property layer's rule)."""
        from .wing_gong_cpu import WingGongCPU

        inner_fn = getattr(self.inner, "check_witness", None)
        if inner_fn is not None:
            v, w = inner_fn(self.projected, sub_h)
            if v != Verdict.BUDGET_EXCEEDED:
                return Verdict(int(v)), w
        if self._witness_oracle is None:
            self._witness_oracle = WingGongCPU(memo=True)
        v, w = self._witness_oracle.check_witness(self.projected, sub_h)
        return Verdict(int(v)), w

    def search_stats(self):
        """The decomposition's own cost and shape record with the inner
        engine's counters absorbed: a decomposed rate says that it
        decomposed, and into what (``search/stats.py``)."""
        from ..search.stats import SearchStats, collect_search_stats

        st = SearchStats(
            engine=self.name,
            histories=self.histories_seen,
            pcomp_split=self.split_histories,
            pcomp_subs=self.subs_produced,
            pcomp_max_sub=self.max_sub_len,
            pcomp_recombine_ms=int(self.recombine_s * 1000),
        )
        st.absorb(collect_search_stats(self.inner))
        if self._witness_oracle is not None:
            # per-key witness searches are host nodes this combinator spent
            st.absorb(collect_search_stats(self._witness_oracle))
        return st


# ---------------------------------------------------------------------------
# witness stitching
# ---------------------------------------------------------------------------

def stitch_witness(history: History,
                   chains: Sequence[Sequence[Tuple[int, int]]]
                   ) -> List[Tuple[int, int]]:
    """Merge per-key linearizations into one whole-history witness.

    ``chains``: per key, ``(op_index, resp)`` pairs in that key's order.
    The merge respects every chain's order and the whole history's
    real-time precedence between listed ops (a pruned pending op is in no
    chain and is left out: it precedes nothing).  Kahn's algorithm with a
    min-heap on the op index makes the result deterministic.  A cycle
    raises: it would mean the split was unsound, and no certificate is
    better than a false one."""
    resp_of: Dict[int, int] = {}
    order: Dict[int, List[int]] = {}
    indeg: Dict[int, int] = {}
    for chain in chains:
        for j, resp in chain:
            resp_of[j] = resp
            order.setdefault(j, [])
            indeg.setdefault(j, 0)
        for (a, _), (b, _) in zip(chain, chain[1:]):
            order[a].append(b)
            indeg[b] += 1
    listed = sorted(resp_of)
    prec = history.precedes_matrix()
    for a in listed:
        for b in listed:
            if prec[a, b]:
                order[a].append(b)
                indeg[b] += 1
    heap = [j for j in listed if indeg[j] == 0]
    heapq.heapify(heap)
    out: List[Tuple[int, int]] = []
    while heap:
        j = heapq.heappop(heap)
        out.append((j, resp_of[j]))
        for b in order[j]:
            indeg[b] -= 1
            if indeg[b] == 0:
                heapq.heappush(heap, b)
    if len(out) != len(listed):
        raise RuntimeError(
            "witness stitch found a precedence cycle — the per-key "
            "split was unsound for this history; refusing to emit a "
            "false certificate")
    return out
