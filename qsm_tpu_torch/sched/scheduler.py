"""Deterministic PULSE-style scheduler over an in-memory actor transport.

Processes are Python generators stepped by the scheduler, a user-level
cooperative runtime.  All nondeterminism flows from one seeded RNG that
chooses the order in which in-flight messages are delivered; process step
order is fixed, so (seed, program) gives the same interleaving and the
same history, bit for bit.  Shrinking is sound only because of that.

Processes yield *effects*:

* ``Send(to, payload)`` — asynchronous send into the in-flight pool; the
  sender keeps running.
* ``Recv()`` — pop the oldest mailbox message, or block until one arrives.
* ``Monitor(target)`` — get a ``("DOWN", target, reason)`` message when
  the target terminates.

Everything between two yields is atomic.  Faults (drop, duplicate, delay,
partition, crash) are seeded decisions of a :class:`FaultPlan`, taken at
delivery time with the scheduler's own RNG.
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Any, Dict, Iterator, List, Optional


# ---------------------------------------------------------------------------
# Effects & messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Send:
    to: str
    payload: Any


class Recv:
    """Block until a message is in this process's mailbox; the yield
    evaluates to the delivered :class:`Message`."""


@dataclasses.dataclass(frozen=True)
class Monitor:
    """Watch another process: on its termination the watcher receives
    ``("DOWN", target, reason)``, reason "crashed", "done" or "noproc".
    The notification rides the delivery pool but is exempt from faults."""

    target: str


@dataclasses.dataclass(frozen=True)
class Message:
    src: str
    dst: str
    payload: Any
    uid: int  # global send sequence number


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

class FaultPlan:
    """Seeded fault decisions, consulted by the scheduler at delivery
    time with its own RNG, so faulty runs stay replayable from the seed."""

    DELIVER, DROP, DUPLICATE, DELAY = "deliver", "drop", "duplicate", "delay"

    def __init__(self, p_drop: float = 0.0, p_duplicate: float = 0.0,
                 p_delay: float = 0.0, delay_steps: int = 3,
                 partitions: Optional[List[set]] = None,
                 crash_at: Optional[Dict[str, int]] = None,
                 protected: Optional[set] = None):
        self.p_drop = p_drop
        self.p_duplicate = p_duplicate
        # a delayed message is held out of the deliverable set for the
        # next ``delay_steps`` delivery choices
        self.p_delay = p_delay
        self.delay_steps = delay_steps
        self.partitions = partitions or []
        self.crash_at = dict(crash_at or {})
        self.protected = protected or set()  # never dropped

    def decide(self, msg: Message, rng: random.Random) -> str:
        if msg.src in self.protected or msg.dst in self.protected:
            return self.DELIVER
        for group in self.partitions:
            # a partition blocks traffic crossing the group boundary
            if (msg.src in group) != (msg.dst in group):
                return self.DROP
        r = rng.random()
        if r < self.p_drop:
            return self.DROP
        if r < self.p_drop + self.p_duplicate:
            return self.DUPLICATE
        if r < self.p_drop + self.p_duplicate + self.p_delay:
            return self.DELAY
        return self.DELIVER


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

class DeadlockError(RuntimeError):
    pass


@dataclasses.dataclass
class _InFlight:
    """A pooled message.  ``ready_at`` is the delivery count before which
    a delayed message is ineligible; ``decided`` marks that the fault plan
    already ruled on it (no re-rolls)."""

    msg: Message
    ready_at: int = 0
    decided: bool = False


@dataclasses.dataclass
class _Proc:
    name: str
    gen: Iterator
    daemon: bool
    mailbox: deque = dataclasses.field(default_factory=deque)
    blocked: bool = False  # waiting in Recv with empty mailbox
    done: bool = False
    crashed: bool = False
    send_value: Any = None  # value sent into the generator on next step


class Scheduler:
    """Single-threaded deterministic actor scheduler."""

    def __init__(self, seed, faults: Optional[FaultPlan] = None,
                 max_steps: int = 100_000):
        self.rng = random.Random(seed)
        self.faults = faults
        self.max_steps = max_steps
        self.procs: Dict[str, _Proc] = {}
        self.monitors: Dict[str, List[str]] = {}  # target -> watchers
        self.pool: List[_InFlight] = []
        self.clock = 0  # logical event clock (history timestamps)
        self.n_delivered = 0  # delivery choices made (delays count too)
        self._uid = 0
        self._steps = 0

    # -- process management ------------------------------------------------
    def spawn(self, name: str, gen: Iterator, daemon: bool = False) -> None:
        if name in self.procs:
            raise ValueError(f"duplicate process {name}")
        self.procs[name] = _Proc(name=name, gen=gen, daemon=daemon)

    def crash(self, name: str) -> None:
        """Kill a process: it stops running; messages to it are dropped."""
        p = self.procs.get(name)
        if p and not p.done:
            p.crashed = True
            p.done = True
            p.gen.close()
            self._notify_down(name, "crashed")

    def _pool_down(self, target: str, watcher: str, reason: str) -> None:
        self._uid += 1
        self.pool.append(_InFlight(
            Message(src=target, dst=watcher,
                    payload=("DOWN", target, reason), uid=self._uid),
            decided=True))

    def _notify_down(self, target: str, reason: str) -> None:
        for watcher in self.monitors.pop(target, []):
            self._pool_down(target, watcher, reason)

    def tick(self) -> int:
        """Advance the logical clock (history event timestamps)."""
        self.clock += 1
        return self.clock

    # -- main loop ---------------------------------------------------------
    def _bump_steps(self) -> None:
        self._steps += 1
        if self._steps > self.max_steps:
            raise DeadlockError(
                f"scheduler exceeded max_steps={self.max_steps}")

    def _runnable(self) -> List[_Proc]:
        return [p for p in self.procs.values()
                if not p.done and not p.blocked]

    def _step(self, p: _Proc) -> None:
        """Run one process until it blocks or finishes.  Its sends go to
        the pool, not to mailboxes: delivery order is the seeded choice."""
        while True:
            self._bump_steps()
            try:
                eff = p.gen.send(p.send_value)
            except StopIteration:
                p.done = True
                self._notify_down(p.name, "done")
                return
            p.send_value = None
            if isinstance(eff, Send):
                self._uid += 1
                self.pool.append(_InFlight(Message(
                    src=p.name, dst=eff.to, payload=eff.payload,
                    uid=self._uid)))
                continue
            if isinstance(eff, Recv):
                if p.mailbox:
                    p.send_value = p.mailbox.popleft()
                    continue
                p.blocked = True
                return
            if isinstance(eff, Monitor):
                tgt = self.procs.get(eff.target)
                if tgt is None or tgt.done:
                    reason = ("crashed" if tgt and tgt.crashed
                              else "done" if tgt else "noproc")
                    self._pool_down(eff.target, p.name, reason)
                else:
                    self.monitors.setdefault(eff.target,
                                             []).append(p.name)
                continue
            raise TypeError(f"process {p.name} yielded {eff!r}")

    def _deliver_one(self) -> None:
        """Quiescence point: seeded choice of the next in-flight message."""
        self._bump_steps()
        eligible = [i for i, f in enumerate(self.pool)
                    if f.ready_at <= self.n_delivered]
        if not eligible:
            # every message is held: delivering early is history-equivalent
            eligible = list(range(len(self.pool)))
        pick = eligible[self.rng.randrange(len(eligible))]
        inf = self.pool.pop(pick)
        msg = inf.msg
        action = (self.faults.decide(msg, self.rng)
                  if self.faults and not inf.decided else FaultPlan.DELIVER)
        if action == FaultPlan.DROP:
            return
        if action == FaultPlan.DELAY:
            inf.decided = True
            inf.ready_at = self.n_delivered + self.faults.delay_steps
            self.pool.append(inf)
            return
        if action == FaultPlan.DUPLICATE:
            self._uid += 1
            self.pool.append(
                _InFlight(dataclasses.replace(msg, uid=self._uid)))
        dst = self.procs.get(msg.dst)
        if dst is None or dst.done:
            return  # message to a dead/unknown process: dropped
        dst.mailbox.append(msg)
        if dst.blocked:
            dst.blocked = False
            dst.send_value = dst.mailbox.popleft()

    def run(self) -> None:
        """Run until every non-daemon process finished.  A wedged system
        (clients blocked, nothing in flight) simply ends the run; its
        unanswered operations surface as pending ops in the history."""
        fired_crashes = set()
        self.n_delivered = 0
        self._steps = 0
        self.clock = 0
        self.pool.clear()
        self.monitors.clear()
        while True:
            runnable = self._runnable()
            if runnable:
                # fixed order: interleavings come from delivery choice only
                self._step(runnable[0])
                continue
            if self.faults:
                for name, at in self.faults.crash_at.items():
                    if self.n_delivered >= at and name not in fired_crashes:
                        self.crash(name)
                        fired_crashes.add(name)
            clients_left = [p for p in self.procs.values()
                            if not p.daemon and not p.done]
            if not clients_left or not self.pool:
                return
            self._deliver_one()
            self.n_delivered += 1
