"""Set over keys [0, n_keys) whose model state is one membership bitmask
(scalar, bound ``2**n_keys``).

The racy implementation's add is check-then-act (a contains round trip,
then an unconditional insert): two concurrent adds of the same key can
both observe it absent and both report "inserted", but the second add to
linearize must return 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec
from ..sched.scheduler import Recv, Scheduler, Send

ADD = 0
REMOVE = 1
CONTAINS = 2


class SetSpec(Spec):
    """Set over keys [0, n_keys), model state = membership bitmask.

    ADD(k) responds 1 iff k was absent (and inserts it), else 0.
    REMOVE(k) responds 1 iff k was present (and removes it), else 0.
    CONTAINS(k) responds the membership bit; never mutates.
    """

    name = "set"
    STATE_DIM = 1

    def __init__(self, n_keys: int = 4):
        if not 1 <= n_keys <= 16:
            raise ValueError(f"n_keys must be in [1, 16], got {n_keys}")
        self.n_keys = n_keys
        self.CMDS = (
            CmdSig("add", n_args=n_keys, n_resps=2),
            CmdSig("remove", n_args=n_keys, n_resps=2),
            CmdSig("contains", n_args=n_keys, n_resps=2),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(1, np.int32)

    def scalar_state_bound(self, n_ops):
        return 1 << self.n_keys  # state is always a membership mask

    def spec_kwargs(self):
        return {"n_keys": self.n_keys}

    def step_py(self, state, cmd, arg, resp):
        mask = state[0]
        present = (mask >> arg) & 1
        if cmd == ADD:
            return [mask | (1 << arg)], resp == 1 - present
        if cmd == REMOVE:
            return [mask & ~(1 << arg)], resp == present
        return [mask], resp == present

    def step_torch(self, state, cmd, arg, resp):
        bit = torch.ones_like(arg) << arg
        present = (state >> arg) & 1
        ok = torch.where(cmd == ADD, resp == 1 - present, resp == present)
        new = torch.where(cmd == ADD, state | bit,
                          torch.where(cmd == REMOVE, state & ~bit, state))
        return new.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _set_server(store: dict):
    """Server applying add/remove/contains atomically per message; also
    answers the racy SUT's unconditional-insert protocol."""
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
        elif kind == "insert":
            items.add(key)
            yield Send(msg.src, 0)


class AtomicSetSUT:
    """Correct: each op is one atomically applied server message."""

    def __init__(self, spec: SetSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"items": set()}
        sched.spawn("server", _set_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        kind = ("add", "remove", "contains")[cmd]
        yield Send("server", (kind, arg))
        msg = yield Recv()
        return msg.payload


class RacyCheckThenActSetSUT:
    """Racy: add is contains-then-insert as separate round trips; two
    concurrent adds of the same key both observe it absent and both claim
    the insertion (resp 1)."""

    def __init__(self, spec: SetSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"items": set()}
        sched.spawn("server", _set_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd != ADD:
            kind = ("add", "remove", "contains")[cmd]
            yield Send("server", (kind, arg))
            msg = yield Recv()
            return msg.payload
        yield Send("server", ("contains", arg))
        msg = yield Recv()
        if msg.payload == 1:
            return 0  # observed present
        # the membership check was its own round trip: another pid's add
        # can land before this insert does
        yield Send("server", ("insert", arg))
        yield Recv()
        return 1
