"""Histories: invocation/response event sequences and their array encoding.

A history is the per-pid sequence of invocations and responses one
concurrent execution produced.  For the device it is encoded into
fixed-shape integer arrays so that thousands of histories batch into one
kernel launch:

    ops[B, N, 4]      = (pid, cmd, arg, resp) per operation
    interval[B, N, 2] = (invoke_time, response_time) logical timestamps
    valid[B, N]       = operation exists (histories are ragged; N is a bucket)
    pending[B, N]     = invoked but never responded (crash/fault injection)

``N`` is rounded up to one of ``OP_BUCKETS``.  The real-time precedence
order the checker needs is derived, not stored: op *i* precedes op *j*
iff ``response_time[i] < invoke_time[j]``; a pending op precedes nothing.

The encoding is numpy on the host: the backend moves it to the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

OP_BUCKETS = (12, 24, 32, 48, 64, 96, 128)

# Sentinel response for pending operations (no response observed).
NO_RESP = -1


@dataclasses.dataclass(frozen=True)
class Op:
    """One completed or pending operation in a concurrent history."""

    pid: int
    cmd: int
    arg: int
    resp: int  # NO_RESP if pending
    invoke_time: int
    response_time: int  # large sentinel (>= any time) if pending

    @property
    def is_pending(self) -> bool:
        return self.resp == NO_RESP


@dataclasses.dataclass
class History:
    """A single concurrent history plus its provenance (``seed`` and
    ``program_id`` make a failure replayable).  ``ops`` are in invocation
    order."""

    ops: List[Op]
    seed: Optional[object] = None
    program_id: Optional[int] = None

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def n_pending(self) -> int:
        return sum(1 for o in self.ops if o.is_pending)

    def completed(self) -> "History":
        """Drop pending ops (prune-all completion)."""
        return History([o for o in self.ops if not o.is_pending],
                       seed=self.seed, program_id=self.program_id)

    def fingerprint(self) -> tuple:
        """Hashable identity of the observable history."""
        return tuple((o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
                      o.response_time) for o in self.ops)

    def subhistory(self, keep: Sequence[int]) -> "History":
        """The history restricted to the op indices ``keep`` (sorted,
        timestamps kept).  Dropping ops can only relax the real-time
        order of the survivors, so a shrink candidate built from this
        (``shrink/frontier.py``) keeps a sub-order of the original's."""
        idx = sorted(set(keep))
        return History([self.ops[i] for i in idx], seed=self.seed,
                       program_id=self.program_id)

    def precedes_matrix(self) -> np.ndarray:
        """bool[n, n]: strict real-time precedence (resp_i < inv_j)."""
        inv = np.array([o.invoke_time for o in self.ops], np.int64)
        ret = np.array([o.response_time for o in self.ops], np.int64)
        pend = np.array([o.is_pending for o in self.ops], bool)
        mat = ret[:, None] < inv[None, :]
        mat[pend, :] = False  # a pending op's response never happened
        np.fill_diagonal(mat, False)
        return mat


def bucket_for(n_ops: int) -> int:
    for b in OP_BUCKETS:
        if n_ops <= b:
            return b
    raise ValueError(f"history of {n_ops} ops exceeds largest bucket "
                     f"{OP_BUCKETS[-1]}")


@dataclasses.dataclass
class EncodedBatch:
    """A batch of histories encoded to fixed-shape host arrays."""

    ops: np.ndarray        # int32[B, N, 4]  (pid, cmd, arg, resp)
    interval: np.ndarray   # int32[B, N, 2]  (invoke_time, response_time)
    valid: np.ndarray      # bool[B, N]
    pending: np.ndarray    # bool[B, N]
    init_state: np.ndarray  # int32[STATE_DIM]  (shared across the batch)

    def precedes(self) -> np.ndarray:
        """bool[B, N, N] strict precedence matrices."""
        inv = self.interval[:, :, 0].astype(np.int64)
        ret = self.interval[:, :, 1].astype(np.int64)
        mat = ret[:, :, None] < inv[:, None, :]
        mat &= self.valid[:, :, None] & self.valid[:, None, :]
        mat &= ~self.pending[:, :, None]  # pending ops precede nothing
        n = mat.shape[1]
        mat[:, np.arange(n), np.arange(n)] = False
        return mat


def encode_batch(histories: Sequence[History], init_state: np.ndarray,
                 max_ops: Optional[int] = None) -> EncodedBatch:
    """Pad a list of histories into one fixed-shape batch.  ``max_ops``
    defaults to the smallest bucket that fits the longest history.  A
    pending op's response encodes as 0."""
    longest = max((len(h) for h in histories), default=1)
    n = max_ops if max_ops is not None else bucket_for(max(longest, 1))
    if longest > n:
        raise ValueError(f"history of {longest} ops does not fit max_ops={n}")
    b = len(histories)
    ops = np.zeros((b, n, 4), np.int32)
    interval = np.zeros((b, n, 2), np.int32)
    valid = np.zeros((b, n), bool)
    pending = np.zeros((b, n), bool)
    for i, h in enumerate(histories):
        for j, o in enumerate(h.ops):
            ops[i, j] = (o.pid, o.cmd, o.arg, max(o.resp, 0))
            interval[i, j] = (o.invoke_time, o.response_time)
            valid[i, j] = True
            pending[i, j] = o.is_pending
    return EncodedBatch(ops=ops, interval=interval, valid=valid,
                        pending=pending,
                        init_state=np.asarray(init_state, np.int32))


def sequential_history(
    steps: Sequence[Tuple[int, int, int, int]],
) -> History:
    """A (trivially sequential) history from ``(pid, cmd, arg, resp)``
    tuples, for hand-written histories."""
    ops = []
    t = 0
    for pid, cmd, arg, resp in steps:
        ops.append(Op(pid=pid, cmd=cmd, arg=arg, resp=resp,
                      invoke_time=t, response_time=t + 1))
        t += 2
    return History(ops)


def overlapping_history(
    spans: Sequence[Tuple[int, int, int, int, int, int]],
) -> History:
    """Build a history from explicit (pid, cmd, arg, resp, inv_t, ret_t)
    tuples, for hand-written concurrent histories."""
    ops = [Op(pid=p, cmd=c, arg=a, resp=r, invoke_time=i, response_time=t)
           for (p, c, a, r, i, t) in spans]
    ops.sort(key=lambda o: o.invoke_time)
    return History(ops)
