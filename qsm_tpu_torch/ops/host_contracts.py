"""The host side that every device checker of the port shares.

Before a batch reaches the device:

* a history whose args fall outside the declared command domains is
  deferred to the oracle (BUDGET_EXCEEDED): a spec's state bound only holds
  for in-domain args, so its table could be wrong for it;
* so is a history whose explicit start state the caller's ``in_bounds``
  refuses (a vector state outside its element bounds would pack onto
  another, valid state);
* pending ops are expanded into every complete/prune variant (at most
  ``max_expansions``, else the history is deferred); a history is
  linearizable iff some variant is.

After it, the lanes' statuses fold back into one verdict per history.
:class:`DeviceChecker` holds the entry points both device backends share.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.history import History
from ..core.spec import Spec
from .backend import Verdict
from .dfs_kernel import BUDGET, FAILURE, SUCCESS


def args_in_domain(spec: Spec, h: History) -> bool:
    cmds = spec.CMDS
    return all(0 <= o.cmd < len(cmds)
               and 0 <= o.arg < cmds[o.cmd].n_args for o in h.ops)


def expand_pending(spec: Spec, h: History, max_expansions: int
                   ) -> Optional[List[History]]:
    """All complete/prune variants of a history's pending ops, or None past
    ``max_expansions``."""
    if h.n_pending == 0:
        return [h]
    pend = [i for i, o in enumerate(h.ops) if o.is_pending]
    n = 1
    choices = []
    for i in pend:
        opts = [None] + list(spec.resp_domain(h.ops[i].cmd))
        n *= len(opts)
        if n > max_expansions:
            return None
        choices.append(opts)
    pend_pos = {i: k for k, i in enumerate(pend)}
    out = []
    for combo in itertools.product(*choices):
        ops = []
        for i, o in enumerate(h.ops):
            if i in pend_pos:
                c = combo[pend_pos[i]]
                if c is None:
                    continue  # pruned: never took effect
                # completed: its response time stays the pending sentinel
                # (unconstrained on the right)
                ops.append(dataclasses.replace(o, resp=int(c)))
            else:
                ops.append(o)
        out.append(History(ops, seed=h.seed, program_id=h.program_id))
    return out


def flatten(spec: Spec, histories: Sequence[History],
            init_states: Optional[Sequence], max_expansions: int,
            in_bounds: Optional[Callable] = None):
    """``(groups, flat, flat_inits, deferred)``: the device lanes of
    ``histories`` (``groups[i] = (start, count)``, count 0 = decided on the
    host as BUDGET_EXCEEDED), their start states (None without
    ``init_states``) and how many histories were deferred as out of
    domain."""
    if init_states is not None and len(init_states) != len(histories):
        raise ValueError(
            f"init_states has {len(init_states)} entries for "
            f"{len(histories)} histories")
    groups: List[Tuple[int, int]] = []
    flat: List[History] = []
    flat_inits: List = []
    deferred = 0
    for idx, h in enumerate(histories):
        if not args_in_domain(spec, h) or (
                in_bounds is not None and init_states is not None
                and not in_bounds(init_states[idx])):
            deferred += 1
            groups.append((len(flat), 0))
            continue
        exp = expand_pending(spec, h, max_expansions)
        if exp is None:
            groups.append((len(flat), 0))
            continue
        groups.append((len(flat), len(exp)))
        flat.extend(exp)
        if init_states is not None:
            flat_inits.extend([init_states[idx]] * len(exp))
    return (groups, flat, flat_inits if init_states is not None else None,
            deferred)


def fold_statuses(groups: Sequence[Tuple[int, int]], statuses: np.ndarray
                  ) -> np.ndarray:
    """One verdict per history from its lanes' statuses: linearizable if
    any variant succeeded, else undecided if any ran out of budget, else a
    violation."""
    out = np.full(len(groups), int(Verdict.BUDGET_EXCEEDED), np.int8)
    for idx, (start, count) in enumerate(groups):
        if count == 0:
            continue
        sub = statuses[start:start + count]
        if (sub == SUCCESS).any():
            out[idx] = int(Verdict.LINEARIZABLE)
        elif (sub == BUDGET).any():
            out[idx] = int(Verdict.BUDGET_EXCEEDED)
        else:
            out[idx] = int(Verdict.VIOLATION)
    return out


class DeviceChecker:
    """The ``LineariseBackend`` entry points of a device backend.  A
    subclass sets ``spec``, ``max_expansions`` and
    ``deferred_out_of_domain``, provides ``_run_device(flat, flat_inits,
    collect_chosen)`` (lane statuses, and with ``collect_chosen`` each
    lane's final ``chosen`` stack) and may refuse explicit start states
    with ``_start_in_bounds``."""

    _start_in_bounds: Optional[Callable] = None

    def check_histories(self, spec: Spec, histories: Sequence[History],
                        init_states: Optional[Sequence] = None
                        ) -> np.ndarray:
        if spec is not self.spec:
            raise ValueError(f"{type(self).__name__} is built per spec; "
                             f"construct one per spec")
        if not histories:
            return np.empty(0, np.int8)
        groups, flat, flat_inits, deferred = flatten(
            spec, histories, init_states, self.max_expansions,
            self._start_in_bounds)
        self.deferred_out_of_domain += deferred
        statuses = self._run_device(flat, flat_inits) if flat else None
        return fold_statuses(groups, statuses)

    def check_from(self, spec: Spec, history: History, init_state
                   ) -> Verdict:
        """Linearizability from an explicit model state (in the spec's
        own representation)."""
        v = self.check_histories(spec, [history], init_states=[init_state])
        return Verdict(int(v[0]))

    def check_witness(self, spec: Spec, history: History):
        """(verdict, witness): the ``chosen`` stack of the same search,
        read back on success, as ``(op_index, resp)`` pairs.  Pending-free,
        in-domain histories only; others get (verdict, None)."""
        if history.n_pending or not args_in_domain(spec, history):
            return Verdict(
                int(self.check_histories(spec, [history])[0])), None
        if not history.ops:
            return Verdict.LINEARIZABLE, []
        statuses, chosen = self._run_device([history], collect_chosen=True)
        v = {SUCCESS: Verdict.LINEARIZABLE, FAILURE: Verdict.VIOLATION,
             BUDGET: Verdict.BUDGET_EXCEEDED}[int(statuses[0])]
        if v != Verdict.LINEARIZABLE:
            return v, None
        order = [int(j) for j in chosen[0][:len(history.ops)]]
        return v, [(j, history.ops[j].resp) for j in order]
