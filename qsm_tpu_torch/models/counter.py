"""Ticket dispenser: ``take`` hands out the next ticket number, ``reset``
restarts the sequence.

The bug it exists to catch is the non-atomic read-then-increment: two pids
read the same counter value and both get the same ticket.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec
from ..sched.scheduler import Recv, Scheduler, Send

TAKE = 0
RESET = 1


class TicketSpec(Spec):
    """Atomic ticket dispenser, model state ``[next]``.

    TAKE must return the current ``next`` and advance it; RESET returns 0
    and sets ``next`` to 0.  ``n_tickets`` bounds the response domain;
    keep it above the history length so TAKE always has a valid response
    (preconditions are generation-time only).
    """

    name = "ticket"
    STATE_DIM = 1

    def __init__(self, n_tickets: int = 25):
        self.n_tickets = n_tickets
        self.CMDS = (
            CmdSig("take", n_args=1, n_resps=n_tickets),
            CmdSig("reset", n_args=1, n_resps=1),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(1, np.int32)

    def spec_kwargs(self):
        return {"n_tickets": self.n_tickets}

    def precondition(self, state, cmd, arg) -> bool:
        return cmd != TAKE or state[0] < self.n_tickets

    def scalar_state_bound(self, n_ops):
        # every ok TAKE needs resp == state and moves the state up by one,
        # RESET moves it to 0: n_ops ok steps never pass n_ops, whatever
        # responses the SUT produced
        return n_ops + 1

    def step_py(self, state, cmd, arg, resp):
        nxt = state[0]
        if cmd == TAKE:
            return [nxt + 1], resp == nxt
        return [0], resp == 0

    def step_torch(self, state, cmd, arg, resp):
        is_take = cmd == TAKE
        ok = torch.where(is_take, resp == state, resp == 0)
        new = torch.where(is_take, state + 1, torch.zeros_like(state))
        return new.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _atomic_server(store: dict):
    """Server applying take/reset atomically per message; also answers
    the racy SUT's read/incr protocol."""
    while True:
        msg = yield Recv()
        kind = msg.payload[0]
        if kind == "take":
            yield Send(msg.src, store["next"])
            store["next"] += 1
        elif kind == "reset":
            store["next"] = 0
            yield Send(msg.src, 0)
        elif kind == "read":
            yield Send(msg.src, store["next"])
        elif kind == "incr":
            store["next"] += 1
            yield Send(msg.src, 0)


class AtomicTicketSUT:
    """Correct: one server message per TAKE, read and increment atomic."""

    def setup(self, sched: Scheduler) -> None:
        self.store = {"next": 0}
        sched.spawn("server", _atomic_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        yield Send("server", ("take",) if cmd == TAKE else ("reset",))
        msg = yield Recv()
        return msg.payload


class RacyTicketSUT:
    """Racy: TAKE is read-then-increment as two server round trips; two
    pids can read the same counter and hand out duplicate tickets."""

    def setup(self, sched: Scheduler) -> None:
        self.store = {"next": 0}
        sched.spawn("server", _atomic_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == TAKE:
            yield Send("server", ("read",))
            msg = yield Recv()
            ticket = msg.payload
            yield Send("server", ("incr",))
            yield Recv()
            return ticket
        yield Send("server", ("reset",))
        msg = yield Recv()
        return msg.payload
