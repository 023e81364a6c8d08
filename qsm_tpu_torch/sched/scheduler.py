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
from typing import Any, Callable, Dict, Iterator, List, Optional


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

    def is_deterministic(self) -> bool:
        """True when this plan never consults the RNG's outcome: crash
        schedules (delivery-count triggers) and partitions (a pure (src,
        dst) predicate) only.  Systematic exploration
        (``sched/systematic.py``) enumerates exactly these plans; a new
        seeded fault knob must make this answer False."""
        return (self.p_drop == 0 and self.p_duplicate == 0
                and self.p_delay == 0)

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


class PruneRun(Exception):
    """Raised out of :meth:`Scheduler.run` when a ``prune_hook`` finds
    the current quiescent state already explored (state-fingerprint
    pruning of ``sched/systematic.py``).  Control flow, not an error."""


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
                 max_steps: int = 100_000, transport=None,
                 choices: Optional[List[int]] = None):
        self.rng = random.Random(seed)
        self.faults = faults
        self.max_steps = max_steps
        # Scripted delivery choices (sched/systematic.py): the k-th
        # delivery takes eligible[choices[k]] instead of a seeded draw,
        # eligible[0] past the script's end, and ``choice_log`` records
        # the branching factor at every delivery.  Delivery choice is the
        # only nondeterminism of a faultless run, so the script is the
        # whole schedule.
        self.choices = choices
        self.choice_log: List[int] = []
        self._choice_pos = 0
        # a scripted choice at or past the live branching factor: the
        # script was recorded against another tree; the pick is clamped
        # so the run completes, and the drift is reported
        self.choice_clamped = False
        # called at every quiescent delivery point before the branching
        # factor is logged; True aborts the run with PruneRun
        self.prune_hook: Optional[Callable[["Scheduler"], bool]] = None
        # the transport carries the messages; the scheduler keeps every
        # ordering decision (None: in memory).  ``owns_transport`` is set
        # by prepare_run when it made the transport from a name and the
        # run must close it.
        self.transport = transport
        self.owns_transport = False
        self.procs: Dict[str, _Proc] = {}
        self.monitors: Dict[str, List[str]] = {}  # target -> watchers
        self.pool: List[_InFlight] = []
        self.clock = 0  # logical event clock (history timestamps)
        self.trace: List[int] = []  # delivered message uids, in order
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
                msg = Message(src=p.name, dst=eff.to, payload=eff.payload,
                              uid=self._uid)
                if self.transport is not None:
                    msg = self.transport.uplink(msg)
                self.pool.append(_InFlight(msg))
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
        """Quiescence point: seeded (or scripted) choice of the next
        in-flight message."""
        if self.prune_hook is not None and self.prune_hook(self):
            raise PruneRun
        self._bump_steps()
        eligible = [i for i, f in enumerate(self.pool)
                    if f.ready_at <= self.n_delivered]
        if not eligible:
            # every message is held: delivering early is history-equivalent
            eligible = list(range(len(self.pool)))
        if self.choices is not None:
            self.choice_log.append(len(eligible))
            k = (self.choices[self._choice_pos]
                 if self._choice_pos < len(self.choices) else 0)
            self._choice_pos += 1
            if k >= len(eligible):
                self.choice_clamped = True
            pick = eligible[min(k, len(eligible) - 1)]
        else:
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
        if self.transport is not None:
            msg = self.transport.downlink(msg)
        self.trace.append(msg.uid)
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
        self.trace.clear()
        self.monitors.clear()
        self.choice_log.clear()
        self._choice_pos = 0
        self.choice_clamped = False
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
