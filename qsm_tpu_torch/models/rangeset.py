"""Range-query set: the bitmask set of ``models/set.py`` with an
order-statistics query, ``count_below(k)``, the number of members
strictly below ``k``.

The state stays one membership bitmask (scalar, bound ``2**n_keys``).  The
racy implementation's range scan reads per-key membership in separate
round trips, so adds and removes that land mid-scan give a count no
single linearization point produces.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec
from ..sched.scheduler import Recv, Scheduler, Send

ADD = 0
REMOVE = 1
CONTAINS = 2
COUNT_BELOW = 3


class RangeSetSpec(Spec):
    """Set over keys [0, n_keys) with an order-statistics range query.

    ADD, REMOVE and CONTAINS as in ``SetSpec``.  COUNT_BELOW(k) responds
    ``popcount(mask & ((1 << k) - 1))``; never mutates.  ``k`` ranges over
    [0, n_keys]: ``COUNT_BELOW(n_keys)`` is the cardinality.
    """

    name = "rangeset"
    STATE_DIM = 1

    def __init__(self, n_keys: int = 4):
        if not 1 <= n_keys <= 16:
            raise ValueError(f"n_keys must be in [1, 16], got {n_keys}")
        self.n_keys = n_keys
        self.CMDS = (
            CmdSig("add", n_args=n_keys, n_resps=2),
            CmdSig("remove", n_args=n_keys, n_resps=2),
            CmdSig("contains", n_args=n_keys, n_resps=2),
            CmdSig("count_below", n_args=n_keys + 1, n_resps=n_keys + 1),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(1, np.int32)

    def scalar_state_bound(self, n_ops):
        return 1 << self.n_keys  # state is always a membership mask

    def spec_kwargs(self):
        return {"n_keys": self.n_keys}

    def step_py(self, state, cmd, arg, resp):
        mask = state[0]
        if cmd == COUNT_BELOW:
            below = int(mask) & ((1 << arg) - 1)
            return [mask], resp == bin(below).count("1")
        present = (mask >> arg) & 1
        if cmd == ADD:
            return [mask | (1 << arg)], resp == 1 - present
        if cmd == REMOVE:
            return [mask & ~(1 << arg)], resp == present
        return [mask], resp == present

    def step_torch(self, state, cmd, arg, resp):
        bit = torch.ones_like(arg) << arg
        present = (state >> arg) & 1
        # the popcount of the prefix below arg, summed over the key domain
        iota = torch.arange(self.n_keys, dtype=torch.int32,
                            device=state.device)
        below = (((state[..., None] >> iota) & 1)
                 * (iota < arg[..., None])).sum(-1)
        ok = torch.where(
            cmd == COUNT_BELOW, resp == below,
            torch.where(cmd == ADD, resp == 1 - present, resp == present))
        new = torch.where(cmd == ADD, state | bit,
                          torch.where(cmd == REMOVE, state & ~bit, state))
        return new.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _rangeset_server(store: dict):
    """Server applying add/remove/contains/count atomically per message;
    also answers the racy SUT's per-key probes."""
    while True:
        msg = yield Recv()
        kind, key = msg.payload
        items = store["items"]
        if kind == "add":
            if key in items:
                yield Send(msg.src, 0)
            else:
                items.add(key)
                yield Send(msg.src, 1)
        elif kind == "remove":
            if key in items:
                items.discard(key)
                yield Send(msg.src, 1)
            else:
                yield Send(msg.src, 0)
        elif kind == "contains":
            yield Send(msg.src, 1 if key in items else 0)
        elif kind == "count_below":
            yield Send(msg.src, sum(1 for k in items if k < key))


class AtomicRangeSetSUT:
    """Correct: each op, the range query included, is one atomically
    applied server message."""

    def __init__(self, spec: RangeSetSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"items": set()}
        sched.spawn("server", _rangeset_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        kind = ("add", "remove", "contains", "count_below")[cmd]
        yield Send("server", (kind, arg))
        msg = yield Recv()
        return msg.payload


class ScanningRangeSetSUT:
    """Racy: COUNT_BELOW is a scan of per-key contains round trips, so
    adds and removes that land mid-scan give a torn count."""

    def __init__(self, spec: RangeSetSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"items": set()}
        sched.spawn("server", _rangeset_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd != COUNT_BELOW:
            kind = ("add", "remove", "contains")[cmd]
            yield Send("server", (kind, arg))
            msg = yield Recv()
            return msg.payload
        count = 0
        for key in range(arg):
            yield Send("server", ("contains", key))
            msg = yield Recv()
            count += msg.payload
        return count
