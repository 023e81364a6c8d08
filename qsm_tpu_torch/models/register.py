"""Shared read/write register over values [0, n_values), with a correct
SUT expected to pass ``prop_concurrent`` and two racy ones expected to
fail it."""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec
from ..sched.scheduler import Recv, Scheduler, Send

READ = 0
WRITE = 1


class RegisterSpec(Spec):
    """Model state ``[value]``.  READ must return the current value;
    WRITE always succeeds (resp 0) and sets it."""

    name = "register"
    STATE_DIM = 1

    def __init__(self, n_values: int = 5):
        self.n_values = n_values
        self.CMDS = (
            CmdSig("read", n_args=1, n_resps=n_values),
            CmdSig("write", n_args=n_values, n_resps=1),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(1, np.int32)

    def spec_kwargs(self):
        return {"n_values": self.n_values}

    def scalar_state_bound(self, n_ops):
        return self.n_values  # state is always a stored value

    def step_py(self, state, cmd, arg, resp):
        value = state[0]
        if cmd == READ:
            return [value], resp == value
        return [arg], resp == 0

    def step_torch(self, state, cmd, arg, resp):
        is_read = cmd == READ
        ok = torch.where(is_read, resp == state, resp == 0)
        nxt = torch.where(is_read, state, arg)
        return nxt.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def register_server(store: dict, key: str):
    """Server loop applying ('read', _) / ('write', arg) messages to
    ``store[key]`` atomically."""
    while True:
        msg = yield Recv()
        kind, arg = msg.payload
        if kind == "read":
            yield Send(msg.src, store[key])
        else:
            store[key] = arg
            yield Send(msg.src, 0)


class AtomicRegisterSUT:
    """Correct: one server process applies each message atomically."""

    def setup(self, sched: Scheduler) -> None:
        self.store = {"server": 0}
        sched.spawn("server", register_server(self.store, "server"),
                    daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        yield Send("server", ("read" if cmd == READ else "write", arg))
        msg = yield Recv()
        return msg.payload


class RacyCachedRegisterSUT:
    """Racy: each client caches the value on first read and serves later
    reads from that cache; cross-pid stale reads are not linearizable."""

    def setup(self, sched: Scheduler) -> None:
        self.store = {"server": 0}
        self.cache = {}
        sched.spawn("server", register_server(self.store, "server"),
                    daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == READ:
            if pid in self.cache:
                return self.cache[pid]  # stale: never revalidated
            yield Send("server", ("read", arg))
            msg = yield Recv()
            self.cache[pid] = msg.payload
            return msg.payload
        yield Send("server", ("write", arg))
        yield Recv()
        self.cache[pid] = arg
        return 0


class ReplicatedRegisterSUT:
    """Racy: two replicas, a write goes to both as two messages, reads go
    to the pid's home replica; concurrent writes can apply in different
    orders at the two replicas and leave them divergent."""

    def setup(self, sched: Scheduler) -> None:
        self.store = {"replica:0": 0, "replica:1": 0}
        for name in self.store:
            sched.spawn(name, register_server(self.store, name), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        home = f"replica:{pid % 2}"
        if cmd == READ:
            yield Send(home, ("read", arg))
            msg = yield Recv()
            return msg.payload
        yield Send("replica:0", ("write", arg))
        yield Send("replica:1", ("write", arg))
        yield Recv()
        yield Recv()
        return 0
