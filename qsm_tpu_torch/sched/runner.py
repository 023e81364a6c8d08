"""Concurrent runner: drives a generated program through the deterministic
scheduler against a concurrent SUT and records per-pid invocation and
response events into a :class:`~qsm_tpu_torch.core.history.History`."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol

from ..core.generator import Program
from ..core.history import NO_RESP, History, Op
from .scheduler import FaultPlan, Scheduler

# Response time sentinel for pending ops: later than any real timestamp.
PENDING_T = 1 << 30


class ConcurrentSUT(Protocol):
    """A system under test living inside the scheduler world.

    ``setup(sched)`` spawns server/daemon processes; ``perform`` is a
    generator (it may yield Send/Recv effects) executing one operation on
    behalf of a client pid and returning the response value.
    """

    def setup(self, sched: Scheduler) -> None: ...
    def perform(self, pid: int, cmd: int, arg: int): ...


@dataclasses.dataclass
class _Rec:
    pid: int
    cmd: int
    arg: int
    invoke_time: int
    resp: int = NO_RESP
    response_time: int = PENDING_T


class HistoryRecorder:
    """Collects invoke/response events with scheduler-clock timestamps."""

    def __init__(self, sched: Scheduler):
        self.sched = sched
        self.recs: List[_Rec] = []

    def invoke(self, pid: int, cmd: int, arg: int) -> int:
        self.recs.append(_Rec(pid=pid, cmd=cmd, arg=arg,
                              invoke_time=self.sched.tick()))
        return len(self.recs) - 1

    def respond(self, op_id: int, resp: int) -> None:
        r = self.recs[op_id]
        r.resp = int(resp)
        r.response_time = self.sched.tick()

    def history(self, seed=None, program_id: Optional[int] = None
                ) -> History:
        ops = [Op(pid=r.pid, cmd=r.cmd, arg=r.arg, resp=r.resp,
                  invoke_time=r.invoke_time, response_time=r.response_time)
               for r in self.recs]
        ops.sort(key=lambda o: o.invoke_time)
        return History(ops, seed=seed, program_id=program_id)


def _client(rec: HistoryRecorder, sut: ConcurrentSUT, pid: int, ops):
    for op in ops:
        op_id = rec.invoke(pid, op.cmd, op.arg)
        resp = yield from sut.perform(pid, op.cmd, op.arg)
        rec.respond(op_id, resp)


def prepare_run(sut: ConcurrentSUT, program: Program, seed,
                faults: Optional[FaultPlan] = None,
                max_steps: int = 100_000, transport=None,
                choices=None) -> tuple:
    """(scheduler, recorder) wired up and ready to ``sched.run()``, for
    callers that read the scheduler afterwards (the delivery trace, the
    choice log).

    ``transport`` is None, ``"memory"``, ``"tcp"`` or a transport
    object; one made here from a name is the run's own and closed with
    it, one passed in stays the caller's (the property layer keeps one
    TCP transport for a whole run).  ``choices`` is a scripted delivery
    schedule (``sched/systematic.py``)."""
    owns = isinstance(transport, str)
    if owns:
        from .transport import make_transport

        transport = make_transport(transport)
    try:
        sched = Scheduler(seed=seed, faults=faults, max_steps=max_steps,
                          transport=transport, choices=choices)
        rec = HistoryRecorder(sched)
        sut.setup(sched)
        for pid, ops in enumerate(program.per_pid()):
            if ops:
                sched.spawn(f"client:{pid}", _client(rec, sut, pid, ops))
    except BaseException:
        if owns and transport is not None:
            transport.close()
        raise
    sched.owns_transport = owns
    return sched, rec


def run_concurrent(sut: ConcurrentSUT, program: Program, seed,
                   faults: Optional[FaultPlan] = None,
                   max_steps: int = 100_000, transport=None,
                   choices=None,
                   sched_info: Optional[dict] = None) -> History:
    """Execute ``program`` concurrently and return its history.

    Identical (sut, program, seed, faults) give an identical history, bit
    for bit, on every transport: the transport carries messages, never
    their order.  Unanswered ops come back as pending ops.
    ``sched_info``, when given, receives ``choice_clamped``: a scripted
    choice was past the live branching factor."""
    sched, rec = prepare_run(sut, program, seed, faults, max_steps,
                             transport=transport, choices=choices)
    try:
        sched.run()
    finally:
        if sched.transport is not None and sched.owns_transport:
            sched.transport.close()
        if sched_info is not None:
            sched_info["choice_clamped"] = sched.choice_clamped
    return rec.history(seed=seed)
