"""Bounded FIFO queue: enqueue / dequeue over values [0, n_values).

The model state is the queue's contents, a vector ``[length, slot0, ...,
slot_{capacity-1}]`` with slot0 the head.  It declares per-element bounds,
so the device search tabulates its packed scalar shadow
(``ops/scalarize.py``): 5 × 4**4 = 1280 packed states at the defaults.

The racy implementation splits dequeue into a front read and a pop, so two
concurrent dequeues can both return the same head: the duplicate-dequeue
race a FIFO linearizability checker must catch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec
from ..sched.scheduler import Recv, Scheduler, Send

ENQ = 0
DEQ = 1

OK = 0
FULL = 1


class QueueSpec(Spec):
    """Bounded FIFO queue of capacity ``capacity`` over values [0,
    n_values).

    ENQ(v) responds OK (0) and appends, or FULL (1) at capacity.  DEQ
    responds the head value, or the sentinel ``n_values`` when empty.
    Vacated slots are zeroed, so equal contents are one state vector.
    """

    name = "queue"

    def __init__(self, capacity: int = 4, n_values: int = 4):
        self.capacity = capacity
        self.n_values = n_values
        self.STATE_DIM = 1 + capacity
        self.EMPTY = n_values  # DEQ-on-empty response sentinel
        self.CMDS = (
            CmdSig("enq", n_args=n_values, n_resps=2),
            CmdSig("deq", n_args=1, n_resps=n_values + 1),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.STATE_DIM, np.int32)

    def spec_kwargs(self):
        return {"capacity": self.capacity, "n_values": self.n_values}

    def sweep_kernel(self):
        return 1, (self.capacity, self.n_values), None

    def state_elem_bounds(self):
        # length in [0, capacity]; slots in [0, n_values), vacated slots
        # zeroed
        return [self.capacity + 1] + [self.n_values] * self.capacity

    def step_py(self, state, cmd, arg, resp):
        length = state[0]
        slots = list(state[1:])
        if cmd == ENQ:
            if length == self.capacity:
                return [length] + slots, resp == FULL
            new = slots.copy()
            new[length] = arg
            return [length + 1] + new, resp == OK
        if length == 0:
            return [0] + slots, resp == self.EMPTY
        head = slots[0]
        new = slots[1:] + [0]
        return [length - 1] + new, resp == head

    def step_torch(self, state, cmd, arg, resp):
        """``state`` is ``[..., 1 + capacity]``; ``cmd``, ``arg`` and
        ``resp`` broadcast with ``state[..., 0]``."""
        length = state[..., 0]
        slots = state[..., 1:]
        iota = torch.arange(self.capacity, device=state.device)
        is_enq = cmd == ENQ
        full = length == self.capacity
        empty = length == 0
        head = slots[..., 0]

        enq_ok = torch.where(full, resp == FULL, resp == OK)
        deq_ok = torch.where(empty, resp == self.EMPTY, resp == head)
        ok = torch.where(is_enq, enq_ok, deq_ok)

        enq_slots = torch.where((iota == length[..., None]) & ~full[..., None],
                                arg[..., None].to(slots.dtype), slots)
        # dequeue: shift left one, zero the vacated tail slot
        deq_slots = torch.where(
            empty[..., None], slots,
            torch.where(iota == self.capacity - 1, 0,
                        torch.roll(slots, -1, dims=-1)))
        new_slots = torch.where(is_enq[..., None], enq_slots, deq_slots)
        new_len = torch.where(is_enq, length + (~full).to(length.dtype),
                              length - (~empty).to(length.dtype))
        shape = torch.broadcast_shapes(new_len.shape, new_slots.shape[:-1])
        new_state = torch.cat([new_len.expand(shape)[..., None],
                               new_slots.expand(*shape, self.capacity)],
                              dim=-1)
        return new_state.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _queue_server(q: dict, capacity: int, n_values: int):
    """Atomic per-message queue server; also answers the racy SUT's
    two-phase ('front', 'pop') protocol."""
    while True:
        msg = yield Recv()
        kind, *rest = msg.payload
        items = q["items"]
        if kind == "enq":
            if len(items) >= capacity:
                yield Send(msg.src, FULL)
            else:
                items.append(rest[0])
                yield Send(msg.src, OK)
        elif kind == "deq":
            yield Send(msg.src, items.pop(0) if items else n_values)
        elif kind == "front":
            yield Send(msg.src, items[0] if items else n_values)
        elif kind == "pop":
            if items:
                items.pop(0)
            yield Send(msg.src, OK)


class AtomicQueueSUT:
    """Correct: enq and deq are each one atomically applied server
    message."""

    def __init__(self, spec: QueueSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.q = {"items": []}
        sched.spawn("server",
                    _queue_server(self.q, self.spec.capacity,
                                  self.spec.n_values), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        yield Send("server", ("enq", arg) if cmd == ENQ else ("deq",))
        msg = yield Recv()
        return msg.payload


class RacyTwoPhaseQueueSUT:
    """Racy: dequeue is a front read then a pop, as separate round trips;
    two concurrent dequeues can both return the same head while two
    elements are popped."""

    def __init__(self, spec: QueueSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.q = {"items": []}
        sched.spawn("server",
                    _queue_server(self.q, self.spec.capacity,
                                  self.spec.n_values), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == ENQ:
            yield Send("server", ("enq", arg))
            msg = yield Recv()
            return msg.payload
        yield Send("server", ("front",))
        msg = yield Recv()
        head = msg.payload
        if head == self.spec.n_values:
            return head  # observed empty
        yield Send("server", ("pop",))
        yield Recv()
        return head
