"""Carrying corpora and DFS carries across package boundaries.

This system has no weights: what crosses between a checker and another
tool (a trace file, another implementation, a test) is histories and DFS
carries.  They cross as plain rows and numpy arrays, so nothing here
depends on the other side's types.

* A history is a list of rows ``[pid, cmd, arg, resp, invoke, response]``
  (the ``check`` trace format; ``resp == -1`` marks a pending op).
* A ``dfs_chunk`` carry is a dict of the lane-minor int32 planes of
  :mod:`qsm_tpu_torch.ops.dfs_kernel` (``taken``, ``chosen``, ``states``,
  ``dsi``, ``ck0``, ``ck1``, ``occ``).
* A stepper carry crosses in the layout of the JAX package's ``JaxTPU``
  carry, a dict of lane-major numpy arrays: ``taken`` bool ``[B, N]``,
  ``chosen`` ``[B, N+1]``, ``states`` ``[B, N+1, 1]``, ``d``, ``status``,
  ``iters``, ``prunes``, ``inserts`` ``[B]``, and with a memo ``keys``
  uint32 ``[B, slots, kw]`` and ``occ`` ``[B, slots]``.  A mid-search
  carry of that backend resumes in :mod:`qsm_tpu_torch.ops.stepper_kernel`
  and back.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.history import History, Op
from ..ops.dfs_kernel import Carry
from ..ops.stepper_kernel import (D, INSERTS, ITERS, PRUNES, STATUS,
                                  StepperCarry, key_words)

_DSI_KEYS = {D: "d", STATUS: "status", ITERS: "iters", PRUNES: "prunes",
             INSERTS: "inserts"}


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


def stepper_carry_from_jax(planes: Dict[str, np.ndarray], device,
                           rows=None) -> StepperCarry:
    """A :class:`StepperCarry` on ``device`` from a ``JaxTPU`` carry dict;
    lane ``i`` reads table row ``rows[i]`` (default ``i``: that backend's
    lanes are aligned with its argument rows)."""
    taken = np.asarray(planes["taken"])
    B, N = taken.shape
    kw = key_words(N)
    keys = planes.get("keys")
    if keys is None:
        keys = np.zeros((B, 0, kw), np.uint32)
        occ = np.zeros((B, 0), np.int32)
    else:
        occ = planes["occ"]
    dsi = np.stack([np.asarray(planes[_DSI_KEYS[k]], np.int32)
                    for k in range(5)])
    rows = np.arange(B) if rows is None else rows
    host = (taken.T.astype(np.int32), np.asarray(planes["chosen"]).T,
            np.asarray(planes["states"])[:, :, 0].T, dsi,
            np.asarray(keys, np.uint32).view(np.int32), np.asarray(occ),
            np.asarray(rows))
    return StepperCarry(*(torch.from_numpy(np.array(a, np.int32, order="C"))
                          .to(device) for a in host))


def stepper_carry_to_jax(carry: StepperCarry) -> Dict[str, np.ndarray]:
    """The ``JaxTPU`` carry dict of a :class:`StepperCarry` (without the
    lanes' table rows, which that backend does not have); ``keys`` and
    ``occ`` only when the carry has a memo."""
    h = {k: t.detach().cpu().numpy() for k, t in
         zip(StepperCarry._fields, carry)}
    out = {"taken": h["taken"].T == 1,
           "chosen": np.ascontiguousarray(h["chosen"].T),
           "states": np.ascontiguousarray(h["states"].T[:, :, None])}
    for k, name in _DSI_KEYS.items():
        out[name] = h["dsi"][k].copy()
    if h["occ"].shape[1]:
        out["keys"] = h["keys"].view(np.uint32)
        out["occ"] = h["occ"]
    return out
