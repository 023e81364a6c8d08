"""Root splitting: parallelism inside one history's search.

The counterpart of the JAX package's ``qsm_tpu/ops/rootsplit.py``.  The
device kernels are data-parallel over histories (one search a lane), so
one pathological history holds one lane while the rest of the batch has
decided.  Root splitting spreads that one search over many lanes.

The set of linearizations of a complete history partitions by which
precedence-minimal operation linearizes first.  For each minimal op
``j`` whose postcondition holds from the current state, the child
problem is the same history without ``j``, checked from ``step(state,
j)``: the per-lane ``init_states`` route that ``TorchStepper`` takes for
``SegDC``'s final segments.  So:

    linearizable(h, s)  ⇔  ∃ j minimal, ok(s, j):
                               linearizable(h − j, step(s, j))

Splitting to ``depth`` d gives up to ``pids^d`` children; children
reached by different orders of the same ops are deduplicated by their
(remaining ops, state) configuration.

Per input history: any child LINEARIZABLE → LINEARIZABLE; else any child
BUDGET_EXCEEDED → BUDGET_EXCEEDED; else VIOLATION.  Histories with
pending ops go to the inner backend whole.
"""

from __future__ import annotations

import inspect
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.history import History
from ..core.spec import Spec
from .backend import LineariseBackend, Verdict


def _split_once(spec: Spec, h: History, state: Tuple[int, ...]
                ) -> List[Tuple[History, Tuple[int, ...]]]:
    """All ok (child history, child state) pairs one root step down."""
    prec = h.precedes_matrix()
    out = []
    for j in range(len(h.ops)):
        if prec[:, j].any():
            continue  # some op precedes j: j cannot linearize first
        o = h.ops[j]
        nxt, ok = spec.step_py(list(state), o.cmd, o.arg, o.resp)
        if not ok:
            continue  # this first choice dies at once
        rest = History([p for i, p in enumerate(h.ops) if i != j],
                       seed=h.seed, program_id=h.program_id)
        out.append((rest, tuple(int(v) for v in nxt)))
    return out


def split_history(spec: Spec, h: History, depth: int = 1,
                  init_state=None, max_children: int = 256
                  ) -> Optional[List[Tuple[History, Tuple[int, ...]]]]:
    """``h`` as root-split children at ``depth``, or None when splitting
    does not apply (pending ops, empty, or more than ``max_children``).

    Children are deduplicated by (remaining-op identity, state): depth
    >= 2 reaches one configuration along every order of the removed ops,
    and deciding it once is enough.  An EMPTY list means every first
    choice failed its postcondition: the history is a VIOLATION.
    (Not to be confused with ``ops/pcomp.py::split_history``, the per-key
    split; each module keeps the JAX package's name.)"""
    if len(h.ops) == 0 or h.n_pending or depth < 1:
        return None
    state = tuple(int(v) for v in (spec.initial_state()
                                   if init_state is None else init_state))
    frontier = [(h, state)]
    for _ in range(depth):
        nxt: List[Tuple[History, Tuple[int, ...]]] = []
        seen = set()
        for hist, st in frontier:
            if len(hist.ops) == 0:
                # fully linearized along this branch: keep it as a
                # trivially LINEARIZABLE child
                key = ((), st)
                if key not in seen:
                    seen.add(key)
                    nxt.append((hist, st))
                continue
            for child, cst in _split_once(spec, hist, st):
                key = (tuple((o.pid, o.invoke_time) for o in child.ops),
                       cst)
                if key in seen:
                    continue
                seen.add(key)
                nxt.append((child, cst))
        frontier = nxt
        if len(frontier) > max_children:
            return None  # splitting would flood the batch
        if not frontier:
            return []  # every branch died: a VIOLATION
    return frontier


def _check_with_inits(inner: LineariseBackend, spec: Spec,
                      hists: Sequence[History],
                      inits: Sequence[Tuple[int, ...]]) -> np.ndarray:
    """One batched call when the inner ``check_histories`` takes
    ``init_states`` (``TorchStepper``, ``CppOracle``), a ``check_from``
    loop otherwise.  Detected from the signature, as ``SegDC`` detects
    it: catching ``TypeError`` around the call would swallow a real one
    raised inside a capable inner."""
    sig = inspect.signature(inner.check_histories)
    if "init_states" in sig.parameters:
        return inner.check_histories(spec, hists, init_states=list(inits))
    return np.asarray(
        [int(inner.check_from(spec, h, np.asarray(s, np.int32)))
         for h, s in zip(hists, inits)], np.int8)


class RootSplit:
    """Backend combinator: spread the hard tail by root splitting.

    * ``eager=False`` (the default, escalation): the inner backend runs
      on the whole histories first; only those it leaves BUDGET_EXCEEDED
      are split and decided as children, each child with a full budget
      for one subtree.
    * ``eager=True``: split every history of at least ``min_ops`` ops up
      front (children forfeit the shared memo and widen the batch: kept
      for experiments).

    ``depth`` is the number of root levels expanded."""

    def __init__(self, spec: Spec, inner: LineariseBackend = None,
                 depth: int = 1, min_ops: int = 8,
                 max_children: int = 256, eager: bool = False):
        from .wing_gong_cpu import WingGongCPU

        self.spec = spec
        self.inner = inner if inner is not None else WingGongCPU(memo=True)
        self.depth = depth
        self.min_ops = min_ops
        self.max_children = max_children
        self.eager = eager
        self.name = f"rootsplit({self.inner.name})"
        self.split_histories = 0   # inputs that were decomposed
        self.children_checked = 0

    def _decide_split(self, spec: Spec, idx: List[int],
                      histories: Sequence[History],
                      verdicts: np.ndarray) -> List[int]:
        """Split ``histories[i]`` for i in ``idx``, write the aggregated
        verdicts, return the indices that could not be split."""
        unsplit: List[int] = []
        flat: List[History] = []
        flat_inits: List[Tuple[int, ...]] = []
        groups: List[Tuple[int, slice]] = []
        for i in idx:
            h = histories[i]
            kids = (split_history(spec, h, depth=self.depth,
                                  max_children=self.max_children)
                    if len(h.ops) >= self.min_ops else None)
            if kids is None:
                unsplit.append(i)
            elif not kids:
                verdicts[i] = int(Verdict.VIOLATION)  # every root died
                self.split_histories += 1
            else:
                groups.append(
                    (i, slice(len(flat), len(flat) + len(kids))))
                flat.extend(k for k, _ in kids)
                flat_inits.extend(s for _, s in kids)
                self.split_histories += 1
        if flat:
            sub = _check_with_inits(self.inner, spec, flat, flat_inits)
            self.children_checked += len(flat)
            for i, g in groups:
                v = sub[g]
                if (v == int(Verdict.LINEARIZABLE)).any():
                    verdicts[i] = int(Verdict.LINEARIZABLE)
                elif (v == int(Verdict.BUDGET_EXCEEDED)).any():
                    verdicts[i] = int(Verdict.BUDGET_EXCEEDED)
                else:
                    verdicts[i] = int(Verdict.VIOLATION)
        return unsplit

    def check_histories(self, spec: Spec, histories: Sequence[History]
                        ) -> np.ndarray:
        assert spec is self.spec, "RootSplit is bound to one spec"
        verdicts = np.full(len(histories), int(Verdict.BUDGET_EXCEEDED),
                           np.int8)
        if self.eager:
            unsplit = self._decide_split(
                spec, list(range(len(histories))), histories, verdicts)
            if unsplit:
                sub = self.inner.check_histories(
                    spec, [histories[i] for i in unsplit])
                for k, i in enumerate(unsplit):
                    verdicts[i] = sub[k]
            return verdicts
        # escalation: the whole pass first, then split the undecided only
        verdicts[:] = self.inner.check_histories(spec, histories)
        hard = [i for i, v in enumerate(verdicts)
                if v == int(Verdict.BUDGET_EXCEEDED)]
        if hard:
            # an unsplittable hard history keeps its BUDGET_EXCEEDED: the
            # property layer resolves it on the oracle
            self._decide_split(spec, hard, histories, verdicts)
        return verdicts

