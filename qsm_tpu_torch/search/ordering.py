"""Postcondition-aware candidate ordering.

The counterpart of the JAX package's ``qsm_tpu/search/ordering.py``.

Wing–Gong tries candidate ops in a canonical order (array index, both in
the oracle's ``for j in range(n)`` and the kernels' lowest-index pick
among the candidates).  That order is blind: a branch that linearises an
unconstrained op (a write, whose postcondition holds in every state)
ahead of a constrained one (a read of a specific value) finds the
conflict only deep in the subtree.  Ranking the constrained ops first
makes branches that must fail their postcondition die at depth 1.

The rank is the op's **selectivity**: the fraction of model states in
which its ``step`` postcondition holds, from
``core.spec.compile_selectivity_table``.  For CAS: ``read(v)`` and a
succeeding ``cas`` pass in 1/n_values states (tried first), a failing
``cas`` in (n-1)/n, a ``write`` always (tried last).  Vector specs rank
through their scalarized shadow when they have one; specs with no scalar
domain get no table and keep the canonical order.

It is consumed as a host-side permutation: ops are reordered before
encoding, so the kernels and the oracle's index loop try candidates in
rank order at no cost an iteration.  Linearizability is invariant under
a permutation of the op array (the precedence order rides the ops' own
timestamps), so verdicts cannot change, only iteration counts.  Witness
indices are mapped back through the permutation by the device backends
(``ops/stepper.py``, ``ops/gpu_backend.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.history import History
from ..core.spec import Spec, compile_selectivity_table

# the largest op bucket (core/history.py): specs whose state bound grows
# with history length (the ticket dispenser) are tabulated to there
ORDERING_MAX_OPS = 128


class OrderingTable:
    """Per-spec selectivity ranks over (cmd, arg, resp)."""

    def __init__(self, sel: np.ndarray, spec_name: str):
        self.sel = sel  # float64[n_cmds, max_args, max_resps] in [0, 1]
        self.spec_name = spec_name

    def rank(self, cmd: int, arg: int, resp: int) -> float:
        """Selectivity of one op; lower = more constrained = tried first.

        An out-of-domain cmd, arg or resp ranks 0.0: its postcondition
        holds in no tabulated state, so fronting it surfaces the
        contradiction at once."""
        c, a, r = self.sel.shape
        if not (0 <= cmd < c and 0 <= arg < a):
            return 0.0
        if resp < 0:  # pending: its completion may take any response
            return float(self.sel[cmd, arg].mean())
        if resp >= r:
            return 0.0
        return float(self.sel[cmd, arg, resp])

    def permutation(self, history: History) -> np.ndarray:
        """Stable try-order permutation: ``permuted_ops[k] =
        ops[perm[k]]``.  Ties keep invocation order, so the permutation,
        and every iteration count after it, is deterministic."""
        ops = history.ops
        order = sorted(range(len(ops)),
                       key=lambda j: (self.rank(ops[j].cmd, ops[j].arg,
                                                ops[j].resp), j))
        return np.asarray(order, np.intp)


def permute_history(history: History, perm: Sequence[int]) -> History:
    """Reorder a history's op array (timestamps, and so the precedence
    order, ride along untouched)."""
    return History([history.ops[j] for j in perm],
                   seed=history.seed, program_id=history.program_id)


def ordering_table(spec: Spec) -> Optional[OrderingTable]:
    """The spec's selectivity table, or None when it has no scalar domain
    to tabulate (ordering then stays off).  A vector spec with declared
    element bounds ranks through its scalarized shadow (same commands,
    same step semantics, a scalar domain)."""
    target = spec
    if spec.STATE_DIM != 1:
        from ..ops.scalarize import scalar_shadow

        target = scalar_shadow(spec)
        if target is None:
            return None
    bound = target.scalar_state_bound(ORDERING_MAX_OPS)
    if bound is None or bound <= 0:
        return None
    sel = compile_selectivity_table(target, int(bound))
    return OrderingTable(sel, spec.name)


def order_indices(table: Optional[OrderingTable],
                  history: History) -> List[int]:
    """Try order for a host-side DFS over ``history.ops``: the identity
    without a table.  (The oracle consumes ranks this way; the device
    backends permute the histories before encoding instead.)"""
    if table is None:
        return list(range(len(history.ops)))
    return [int(j) for j in table.permutation(history)]
