"""Wing–Gong linearizability checking on the host: the exact oracle.

Builds every real-time-precedence-respecting interleaving of the history
lazily, stepping the model at each node, and succeeds iff some
root-to-leaf path is all-ok.  Worst case O(n!).  ``memo=True`` adds a
Lowe-style cache of configurations (state, taken set) already proven
non-linearizable-from.

Pending operations (invoked, never answered) may be linearized with any
response in their domain (they took effect, the response was lost) or not
at all (they did not take effect).

``ordering=True`` tries candidates in selectivity order
(``search/ordering.py``): verdicts are invariant under the try order,
only ``nodes_explored`` changes.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core.history import History
from ..core.spec import Spec
from .backend import Verdict

_DEFAULT_NODE_BUDGET = 50_000_000


class WingGongCPU:
    """Pure-Python Wing–Gong DFS backend (the oracle)."""

    name = "wing_gong_cpu"

    def __init__(self, node_budget: int = _DEFAULT_NODE_BUDGET,
                 memo: bool = False, ordering: bool = False):
        self.node_budget = node_budget
        self.memo = memo
        # off by default: the canonical index order is what every kernel
        # is pinned against
        self.ordering = ordering
        self._ordering_tables: dict = {}  # (name, kwargs) -> table or None
        self.nodes_explored = 0  # cumulative, for the search-cost record
        self.histories_checked = 0

    def check_histories(self, spec: Spec, histories: Sequence[History]
                        ) -> np.ndarray:
        out = np.empty(len(histories), np.int8)
        for i, h in enumerate(histories):
            out[i] = self._check(spec, h)
        return out

    def check_from(self, spec: Spec, history: History,
                   init_state) -> Verdict:
        """Linearizability from an explicit model state."""
        return self._check(spec, history, init_state=init_state)

    def check_witness(self, spec: Spec, history: History):
        """(verdict, witness): the witness is the successful
        linearization as ``(op_index, resp)`` pairs in order, or None when
        the verdict is not LINEARIZABLE."""
        witness: List[tuple] = []
        v = self._check(spec, history, witness_out=witness)
        return v, (list(reversed(witness))
                   if v == Verdict.LINEARIZABLE else None)

    def search_stats(self):
        """Host-search cost record (``search/stats.py``): oracle nodes
        per history, the denominator a device's iterations per history
        is judged against."""
        from ..search.stats import SearchStats

        return SearchStats(
            engine=self.name + ("_memo" if self.memo else ""),
            histories=self.histories_checked,
            nodes_explored=self.nodes_explored,
            ordering=self.ordering,
        )

    def _try_order(self, spec: Spec, history: History) -> Sequence[int]:
        if not self.ordering:
            return range(len(history.ops))
        # keyed by the constructor kwargs too: two specs of one name
        # (CasSpec(n_values=2) and (8)) must not share a table
        key = (spec.name, repr(spec.spec_kwargs()))
        if key not in self._ordering_tables:
            from ..search.ordering import ordering_table

            self._ordering_tables[key] = ordering_table(spec)
        from ..search.ordering import order_indices

        return order_indices(self._ordering_tables[key], history)

    def _check(self, spec: Spec, history: History,
               init_state=None, witness_out=None) -> Verdict:
        ops = history.ops
        n = len(ops)
        self.histories_checked += 1
        if n == 0:
            return Verdict.LINEARIZABLE
        prec = history.precedes_matrix()
        # blockers[j]: ops that must be linearized before j may be
        blockers: List[List[int]] = [
            [i for i in range(n) if prec[i, j]] for j in range(n)]
        pending = [o.is_pending for o in ops]
        n_required = sum(1 for p in pending if not p)
        init = tuple(int(v) for v in (spec.initial_state()
                                      if init_state is None else init_state))
        taken = [False] * n
        budget = [self.node_budget]
        seen = set() if self.memo else None
        order = self._try_order(spec, history)

        def eligible(j: int) -> bool:
            if taken[j]:
                return False
            return all(taken[i] for i in blockers[j])

        def dfs(state, got_required: int) -> Verdict:
            if got_required == n_required:
                return Verdict.LINEARIZABLE
            if budget[0] <= 0:
                return Verdict.BUDGET_EXCEEDED
            if seen is not None and (state, tuple(taken)) in seen:
                return Verdict.VIOLATION
            saw_budget = False
            for j in order:
                if not eligible(j):
                    continue
                op = ops[j]
                resps = (spec.resp_domain(op.cmd) if pending[j]
                         else (op.resp,))
                for resp in resps:
                    budget[0] -= 1
                    self.nodes_explored += 1
                    if budget[0] <= 0:
                        return Verdict.BUDGET_EXCEEDED
                    new_state, ok = spec.step_py(list(state), op.cmd,
                                                 op.arg, resp)
                    if not ok:
                        continue
                    taken[j] = True
                    sub = dfs(tuple(int(v) for v in new_state),
                              got_required + (0 if pending[j] else 1))
                    taken[j] = False
                    if sub == Verdict.LINEARIZABLE:
                        if witness_out is not None:
                            # unwinds deepest-first; the caller reverses
                            witness_out.append((j, resp))
                        return sub
                    if sub == Verdict.BUDGET_EXCEEDED:
                        saw_budget = True
            if saw_budget:
                return Verdict.BUDGET_EXCEEDED
            if seen is not None:
                seen.add((state, tuple(taken)))
            return Verdict.VIOLATION

        return dfs(init, 0)
