"""Primary/backup register failover, over the plain ``RegisterSpec``.

A router process monitors the primary replica and fails over to the
backup when the scheduler's seeded crash schedule kills it
(``FaultPlan.crash_at``), so a run replays from its seed.

* ``SyncReplFailoverSUT``: a write is acked only after the backup acked
  its replication, and reads serve only the committed value.
  Linearizable through crashes.
* ``AsyncReplFailoverSUT``: writes ack at once and reads serve the
  primary's freshly applied state.  A crash loses acked writes and rolls
  back values that reads already observed.

What the sync design needs, each rule because the checker catches its
absence: acked writes are durable (ack on the backup's repl-ack); reads
never observe unreplicated state (the primary serves the committed
value); replication is ordered (sequence numbers in the primary's apply
order, stale ones ignored, since delivery is not FIFO); a promoted
replica refuses stale replication silently (acking it would let an
undurable write ack, applying it would overwrite post-failover writes).
"""

from __future__ import annotations

from ..sched.scheduler import Monitor, Recv, Scheduler, Send

READ = 0
WRITE = 1


def _primary(sync: bool, backup: str = "backup"):
    """The primary replica: applies writes and replicates them.  Sync:
    stage the write, replicate, ack the router on the backup's repl-ack,
    serve the committed value.  Async: ack at once, replicate behind,
    serve the applied state."""
    committed = 0       # last replication-acked value: what reads see
    committed_seq = 0
    applied = 0         # latest applied value, unreplicated staging too
    seq = 0             # apply-order sequence stamped into replication
    staged = {}         # seq -> (router tag, value) awaiting repl-ack
    while True:
        msg = yield Recv()
        kind, *rest = msg.payload
        if kind == "read":
            value = committed if sync else applied
            yield Send(msg.src, ("resp", rest[0], value))
        elif kind == "write":
            tag, value = rest
            seq += 1
            if sync:
                staged[seq] = (tag, value)
                yield Send(backup, ("repl", value, seq))
            else:
                # acked before durable, and reads serve this unreplicated
                # state
                applied = value
                yield Send(msg.src, ("resp", tag, 0))
                yield Send(backup, ("repl", value, seq))
        elif kind == "repl-ack":
            aseq = rest[0]
            if aseq in staged:  # duplication faults may re-deliver acks
                tag, value = staged.pop(aseq)
                if aseq > committed_seq:
                    committed_seq = aseq
                    committed = value
                yield Send("router", ("resp", tag, 0))


def _backup():
    """The backup: applies ordered replication until promoted (acks go to
    ``msg.src``); serves clients directly afterwards (its first direct op
    is the promotion: the router routes here only after the primary's
    DOWN)."""
    value = 0
    applied = 0     # highest replicated seq applied; then the local
    leader = False  # write order after promotion
    while True:
        msg = yield Recv()
        kind, *rest = msg.payload
        if kind == "repl":
            v, rseq = rest
            if leader:
                continue  # silence, not an ack
            if rseq > applied:  # stale out-of-order replication ignored
                applied = rseq
                value = v
            yield Send(msg.src, ("repl-ack", rseq))
        elif kind == "read":
            leader = True
            yield Send(msg.src, ("resp", rest[0], value))
        elif kind == "write":
            leader = True
            tag, v = rest
            applied += 1
            value = v
            yield Send(msg.src, ("resp", tag, 0))


def _router():
    """Client-facing front: forwards ops to the current leader and fails
    over to the backup on the primary's DOWN notification."""
    leader = "primary"
    yield Monitor("primary")
    pending = {}  # tag -> client
    tag = 0
    while True:
        msg = yield Recv()
        kind, *rest = msg.payload
        if kind == "DOWN":
            leader = "backup"
        elif kind == "read":
            tag += 1
            pending[tag] = msg.src
            yield Send(leader, ("read", tag))
        elif kind == "write":
            tag += 1
            pending[tag] = msg.src
            yield Send(leader, ("write", tag, rest[0]))
        elif kind == "resp":
            t, value = rest
            if t in pending:  # duplication faults: already served
                yield Send(pending.pop(t), value)


class _FailoverBase:
    sync = True

    def __init__(self, spec=None):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        sched.spawn("primary", _primary(self.sync), daemon=True)
        sched.spawn("backup", _backup(), daemon=True)
        sched.spawn("router", _router(), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        yield Send("router", ("read",) if cmd == READ else ("write", arg))
        msg = yield Recv()
        return msg.payload


class SyncReplFailoverSUT(_FailoverBase):
    """Synchronous replication and committed reads: linearizable through
    crashes."""

    sync = True


class AsyncReplFailoverSUT(_FailoverBase):
    """Asynchronous replication and uncommitted reads: a crash loses acked
    writes and rolls back observed values."""

    sync = False
