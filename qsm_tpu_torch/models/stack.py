"""Bounded LIFO stack: push / pop over values [0, n_values).

The model state has the queue's layout, ``[length, slot0, ...,
slot_{capacity-1}]``, with ``slot_{length-1}`` the top, so the top is a
dynamic slot.  The racy implementation's pop is a top read and a drop as
separate round trips: two concurrent pops can both return the same top,
the LIFO twin of the queue's duplicate-dequeue race.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec, broadcast_vector, take_elem
from ..sched.scheduler import Recv, Scheduler, Send

PUSH = 0
POP = 1

OK = 0
FULL = 1


class StackSpec(Spec):
    """Bounded LIFO stack of capacity ``capacity`` over values [0,
    n_values).

    PUSH(v) responds OK (0) and appends, or FULL (1) at capacity.  POP
    responds the top value, or the sentinel ``n_values`` when empty.
    Vacated slots are zeroed, so equal contents are one state vector.
    """

    name = "stack"

    def __init__(self, capacity: int = 4, n_values: int = 4):
        self.capacity = capacity
        self.n_values = n_values
        self.STATE_DIM = 1 + capacity
        self.EMPTY = n_values  # POP-on-empty response sentinel
        self.CMDS = (
            CmdSig("push", n_args=n_values, n_resps=2),
            CmdSig("pop", n_args=1, n_resps=n_values + 1),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.STATE_DIM, np.int32)

    def spec_kwargs(self):
        return {"capacity": self.capacity, "n_values": self.n_values}

    def sweep_kernel(self):
        return 3, (self.capacity, self.n_values), None

    def native_kernel(self):
        return (3, self.capacity, self.n_values)  # native/wg.cpp kind 3

    def state_elem_bounds(self):
        # length in [0, capacity]; slots in [0, n_values), vacated top
        # zeroed
        return [self.capacity + 1] + [self.n_values] * self.capacity

    def step_py(self, state, cmd, arg, resp):
        length = state[0]
        slots = list(state[1:])
        if cmd == PUSH:
            if length == self.capacity:
                return [length] + slots, resp == FULL
            new = slots.copy()
            new[length] = arg
            return [length + 1] + new, resp == OK
        if length == 0:
            return [0] + slots, resp == self.EMPTY
        top = slots[length - 1]
        new = slots.copy()
        new[length - 1] = 0  # vacated top zeroed
        return [length - 1] + new, resp == top

    def step_torch(self, state, cmd, arg, resp):
        """``state`` is ``[..., 1 + capacity]``; ``cmd``, ``arg`` and
        ``resp`` broadcast with ``state[..., 0]``."""
        state, cmd, arg, resp = broadcast_vector(state, cmd, arg, resp)
        length = state[..., 0]
        slots = state[..., 1:]
        iota = torch.arange(self.capacity, device=state.device)
        is_push = cmd == PUSH
        full = length == self.capacity
        empty = length == 0
        top = take_elem(slots, (length - 1).clamp(min=0))

        push_ok = torch.where(full, resp == FULL, resp == OK)
        pop_ok = torch.where(empty, resp == self.EMPTY, resp == top)
        ok = torch.where(is_push, push_ok, pop_ok)

        push_slots = torch.where(
            (iota == length[..., None]) & ~full[..., None],
            arg[..., None].to(slots.dtype), slots)
        pop_slots = torch.where(
            (iota == length[..., None] - 1) & ~empty[..., None], 0, slots)
        new_slots = torch.where(is_push[..., None], push_slots, pop_slots)
        new_len = torch.where(is_push, length + (~full).to(length.dtype),
                              length - (~empty).to(length.dtype))
        return torch.cat([new_len[..., None], new_slots],
                         dim=-1).to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _stack_server(st: dict, capacity: int, n_values: int):
    """Atomic per-message stack server; also answers the racy SUT's
    two-phase ('top', 'drop') protocol."""
    while True:
        msg = yield Recv()
        kind, *rest = msg.payload
        items = st["items"]
        if kind == "push":
            if len(items) >= capacity:
                yield Send(msg.src, FULL)
            else:
                items.append(rest[0])
                yield Send(msg.src, OK)
        elif kind == "pop":
            yield Send(msg.src, items.pop() if items else n_values)
        elif kind == "top":
            yield Send(msg.src, items[-1] if items else n_values)
        elif kind == "drop":
            if items:
                items.pop()
            yield Send(msg.src, OK)


class AtomicStackSUT:
    """Correct: push and pop are each one atomically applied server
    message."""

    def __init__(self, spec: StackSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.st = {"items": []}
        sched.spawn("server",
                    _stack_server(self.st, self.spec.capacity,
                                  self.spec.n_values), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        yield Send("server", ("push", arg) if cmd == PUSH else ("pop",))
        msg = yield Recv()
        return msg.payload


class RacyTwoPhaseStackSUT:
    """Racy: pop is a top read then a drop, as separate round trips; two
    concurrent pops can both return the same top while two elements are
    dropped."""

    def __init__(self, spec: StackSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.st = {"items": []}
        sched.spawn("server",
                    _stack_server(self.st, self.spec.capacity,
                                  self.spec.n_values), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == PUSH:
            yield Send("server", ("push", arg))
            msg = yield Recv()
            return msg.payload
        yield Send("server", ("top",))
        msg = yield Recv()
        top = msg.payload
        if top == self.spec.n_values:
            return top  # observed empty
        yield Send("server", ("drop",))
        yield Recv()
        return top
