"""Counting semaphore (a mutex at ``permits=1``).

The model state is the number of permits currently available, a scalar
with bound ``permits + 1``.  The racy implementation's acquire is
check-then-act: a load of the permit count and a decrement in separate
round trips, so two concurrent acquires of the last permit both observe 1
and both report success, which no linearization order admits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import CmdSig, Spec
from ..sched.scheduler import Recv, Scheduler, Send

ACQUIRE = 0
RELEASE = 1
AVAILABLE = 2


class SemaphoreSpec(Spec):
    """Counting semaphore over ``permits`` permits.

    ACQUIRE responds 1 and takes a permit iff one is available, else 0 (a
    non-blocking try-acquire).  RELEASE responds 1 and returns a permit
    iff one is held, else 0 (over-release refused, so the count stays in
    domain).  AVAILABLE responds the current count; never mutates.
    """

    name = "semaphore"
    STATE_DIM = 1

    def __init__(self, permits: int = 2):
        if not 1 <= permits <= 8:
            raise ValueError(f"permits must be in [1, 8], got {permits}")
        self.permits = permits
        self.CMDS = (
            CmdSig("acquire", n_args=1, n_resps=2),
            CmdSig("release", n_args=1, n_resps=2),
            CmdSig("available", n_args=1, n_resps=permits + 1),
        )

    def initial_state(self) -> np.ndarray:
        return np.full(1, self.permits, np.int32)

    def scalar_state_bound(self, n_ops):
        return self.permits + 1  # available count stays in [0, permits]

    def spec_kwargs(self):
        return {"permits": self.permits}

    def step_py(self, state, cmd, arg, resp):
        avail = state[0]
        if cmd == ACQUIRE:
            if avail > 0:
                return [avail - 1], resp == 1
            return [avail], resp == 0
        if cmd == RELEASE:
            if avail < self.permits:
                return [avail + 1], resp == 1
            return [avail], resp == 0
        return [avail], resp == avail

    def step_torch(self, state, cmd, arg, resp):
        can_take = state > 0
        can_give = state < self.permits
        ok = torch.where(
            cmd == ACQUIRE, resp == can_take.to(resp.dtype),
            torch.where(cmd == RELEASE, resp == can_give.to(resp.dtype),
                        resp == state))
        new = torch.where(
            cmd == ACQUIRE, torch.where(can_take, state - 1, state),
            torch.where(cmd == RELEASE,
                        torch.where(can_give, state + 1, state), state))
        return new.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _sem_server(store: dict, permits: int):
    """Server applying acquire/release/available atomically per message;
    also answers the racy SUT's load/decrement protocol."""
    while True:
        msg = yield Recv()
        kind = msg.payload
        if kind == "acquire":
            if store["avail"] > 0:
                store["avail"] -= 1
                yield Send(msg.src, 1)
            else:
                yield Send(msg.src, 0)
        elif kind == "release":
            if store["avail"] < permits:
                store["avail"] += 1
                yield Send(msg.src, 1)
            else:
                yield Send(msg.src, 0)
        elif kind == "available":
            yield Send(msg.src, store["avail"])
        elif kind == "take":
            # the racy client's unconditional decrement, clamped at 0 so
            # later ``available`` replies stay in the response domain
            store["avail"] = max(0, store["avail"] - 1)
            yield Send(msg.src, 0)


class AtomicSemaphoreSUT:
    """Correct: acquire is one atomically applied server message."""

    def __init__(self, spec: SemaphoreSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"avail": self.spec.permits}
        sched.spawn("server", _sem_server(self.store, self.spec.permits),
                    daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        kind = ("acquire", "release", "available")[cmd]
        yield Send("server", kind)
        msg = yield Recv()
        return msg.payload


class RacyCheckThenActSemaphoreSUT:
    """Racy: acquire loads the available count and decrements in separate
    round trips; two concurrent acquires of the last permit both claim
    it."""

    def __init__(self, spec: SemaphoreSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {"avail": self.spec.permits}
        sched.spawn("server", _sem_server(self.store, self.spec.permits),
                    daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd != ACQUIRE:
            kind = ("acquire", "release", "available")[cmd]
            yield Send("server", kind)
            msg = yield Recv()
            return msg.payload
        yield Send("server", "available")
        msg = yield Recv()
        if msg.payload <= 0:
            return 0
        # the availability check was its own round trip: another pid's
        # take can land before this one does
        yield Send("server", "take")
        yield Recv()
        return 1
