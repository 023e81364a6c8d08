"""CAS register: read / write / compare-and-swap over values [0, n_values).

CAS packs ``(old, new)`` into one integer argument ``old * n_values +
new``.  The bug this model exists to catch is the non-atomic CAS (read,
compare on the client, then write): the classic lost update.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec
from ..sched.scheduler import Recv, Scheduler, Send

READ = 0
WRITE = 1
CAS = 2


class CasSpec(Spec):
    """Model state ``[value]``.  CAS(old, new) responds 1 and sets
    ``new`` iff ``value == old``, else responds 0 and leaves the value."""

    name = "cas"
    STATE_DIM = 1

    def __init__(self, n_values: int = 5):
        self.n_values = n_values
        self.CMDS = (
            CmdSig("read", n_args=1, n_resps=n_values),
            CmdSig("write", n_args=n_values, n_resps=1),
            CmdSig("cas", n_args=n_values * n_values, n_resps=2),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(1, np.int32)

    def spec_kwargs(self):
        return {"n_values": self.n_values}

    def cas_arg(self, old: int, new: int) -> int:
        return old * self.n_values + new

    def scalar_state_bound(self, n_ops):
        return self.n_values  # state is always a stored value

    def step_py(self, state, cmd, arg, resp):
        value = state[0]
        if cmd == READ:
            return [value], resp == value
        if cmd == WRITE:
            return [arg], resp == 0
        old, new = divmod(arg, self.n_values)
        if value == old:
            return [new], resp == 1
        return [value], resp == 0

    def step_torch(self, state, cmd, arg, resp):
        # floor division and remainder agree with Python's divmod for any
        # sign, as jnp's // and % do
        old = torch.div(arg, self.n_values, rounding_mode="floor")
        new = torch.remainder(arg, self.n_values)
        succ = state == old
        ok = torch.where(cmd == READ, resp == state,
                         torch.where(cmd == WRITE, resp == 0,
                                     resp == succ.to(resp.dtype)))
        nxt = torch.where(cmd == WRITE, arg,
                          torch.where((cmd == CAS) & succ, new, state))
        return nxt.to(torch.int32), ok

    def gen_cmd(self, rng, state=None):
        """Bias CAS's expected value toward the (approximate) current
        model value half the time, so CASes succeed often enough to
        exercise the lost-update race."""
        cmd = rng.randrange(len(self.CMDS))
        if cmd == CAS:
            new = rng.randrange(self.n_values)
            if state is not None and rng.random() < 0.5:
                old = int(state[0])
            else:
                old = rng.randrange(self.n_values)
            return CAS, self.cas_arg(old, new)
        return cmd, rng.randrange(self.CMDS[cmd].n_args)


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _cas_server(store: dict):
    """Server applying read/write/cas atomically per message."""
    while True:
        msg = yield Recv()
        kind, *rest = msg.payload
        if kind == "read":
            yield Send(msg.src, store["value"])
        elif kind == "write":
            store["value"] = rest[0]
            yield Send(msg.src, 0)
        elif kind == "cas":
            old, new = rest
            if store["value"] == old:
                store["value"] = new
                yield Send(msg.src, 1)
            else:
                yield Send(msg.src, 0)


class AtomicCasSUT:
    """Correct: CAS is one server message, applied atomically."""

    def __init__(self, spec: CasSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"value": 0}
        sched.spawn("server", _cas_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == READ:
            yield Send("server", ("read",))
        elif cmd == WRITE:
            yield Send("server", ("write", arg))
        else:
            old, new = divmod(arg, self.spec.n_values)
            yield Send("server", ("cas", old, new))
        msg = yield Recv()
        return msg.payload


class RacyCasSUT:
    """Racy: CAS is read-compare-write as separate round trips; a
    concurrent write between the read and the write is clobbered and the
    CAS still reports success."""

    def __init__(self, spec: CasSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"value": 0}
        sched.spawn("server", _cas_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == READ:
            yield Send("server", ("read",))
            msg = yield Recv()
            return msg.payload
        if cmd == WRITE:
            yield Send("server", ("write", arg))
            msg = yield Recv()
            return msg.payload
        old, new = divmod(arg, self.spec.n_values)
        yield Send("server", ("read",))
        msg = yield Recv()
        if msg.payload != old:
            return 0
        yield Send("server", ("write", new))
        yield Recv()
        return 1
