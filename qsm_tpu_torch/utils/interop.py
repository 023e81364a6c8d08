"""Carrying corpora and DFS carries across package boundaries.

This system has no weights: what crosses between a checker and another
tool (a trace file, another implementation, a test) is histories and DFS
carries.  They cross as plain rows and numpy arrays, so nothing here
depends on the other side's types.

* A history is a list of rows ``[pid, cmd, arg, resp, invoke, response]``
  (the ``check`` trace format; ``resp == -1`` marks a pending op).
* A carry is a dict of the lane-minor int32 planes of
  :mod:`qsm_tpu_torch.ops.dfs_kernel` (``taken``, ``chosen``, ``states``,
  ``dsi``, ``ck0``, ``ck1``, ``occ``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.history import History, Op
from ..ops.dfs_kernel import Carry


def history_from_rows(rows: Sequence[Sequence[int]], seed=None,
                      program_id=None) -> History:
    """A :class:`History` from ``[pid, cmd, arg, resp, invoke, response]``
    rows, kept in the given (invocation) order."""
    ops = [Op(pid=int(p), cmd=int(c), arg=int(a), resp=int(r),
              invoke_time=int(i), response_time=int(t))
           for p, c, a, r, i, t in rows]
    return History(ops, seed=seed, program_id=program_id)


def history_to_rows(h) -> List[List[int]]:
    """Rows of any history object with ``ops`` carrying the six fields."""
    return [[int(o.pid), int(o.cmd), int(o.arg), int(o.resp),
             int(o.invoke_time), int(o.response_time)] for o in h.ops]


def carry_from_numpy(planes: Dict[str, np.ndarray], device) -> Carry:
    """A :class:`Carry` on ``device`` from a dict of int32 planes."""
    return Carry(*(torch.from_numpy(
        np.ascontiguousarray(planes[k], dtype=np.int32)).to(device)
        for k in Carry._fields))


def carry_to_numpy(carry: Carry) -> Dict[str, np.ndarray]:
    return {k: t.detach().cpu().numpy()
            for k, t in zip(Carry._fields, carry)}
