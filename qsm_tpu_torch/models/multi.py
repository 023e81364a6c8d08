"""Multi-cell objects: ``MultiRegisterSpec``, an array of independent
registers addressed by cell, and ``MultiCasSpec``, an array of CAS
registers, the shape of a sharded store whose lost-update race lives
inside one cell while the history interleaves every cell.

Arg packing: read's arg is the cell; write packs ``cell * n_values + v``;
cas packs ``cell * n_values**2 + old * n_values + new``.  The packing is
declared as each command's ``KeyProj``: the cells are independent, and a
cell's sub-history is a history of a ``RegisterSpec`` or ``CasSpec``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import (CmdSig, KeyProj, Spec, broadcast_vector,
                         floor_div, take_elem)
from ..sched.scheduler import Recv, Scheduler, Send

READ = 0
WRITE = 1
CAS = 2


class MultiRegisterSpec(Spec):
    """``n_cells`` independent registers over values [0, n_values).

    Model state: one value per cell.  READ(cell) returns the cell's
    value; WRITE packs ``cell * n_values + v`` and responds 0.
    """

    name = "multireg"

    def __init__(self, n_cells: int = 4, n_values: int = 4):
        self.n_cells = n_cells
        self.n_values = n_values
        self.STATE_DIM = n_cells
        self.CMDS = (
            CmdSig("read", n_args=n_cells, n_resps=n_values,
                   proj=KeyProj(pcmd=READ, stride=1)),
            CmdSig("write", n_args=n_cells * n_values, n_resps=1,
                   proj=KeyProj(pcmd=WRITE, stride=n_values)),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.n_cells, np.int32)

    def write_arg(self, cell: int, value: int) -> int:
        return cell * self.n_values + value

    def spec_kwargs(self):
        return {"n_cells": self.n_cells, "n_values": self.n_values}

    def sweep_kernel(self):
        return 2, (self.n_cells, self.n_values), None  # the kv step

    def state_elem_bounds(self):
        return [self.n_values] * self.n_cells

    def step_py(self, state, cmd, arg, resp):
        state = list(state)
        if cmd == READ:
            return state, resp == state[arg]
        cell, value = divmod(arg, self.n_values)
        state[cell] = value
        return state, resp == 0

    def step_torch(self, state, cmd, arg, resp):
        state, cmd, arg, resp = broadcast_vector(state, cmd, arg, resp)
        iota = torch.arange(self.n_cells, device=state.device)
        is_read = cmd == READ
        cell = torch.where(is_read, arg, floor_div(arg, self.n_values))
        value = torch.remainder(arg, self.n_values)
        ok = torch.where(is_read, resp == take_elem(state, cell), resp == 0)
        new = torch.where(~is_read[..., None] & (iota == cell[..., None]),
                          value[..., None].to(state.dtype), state)
        return new.to(torch.int32), ok

    def projected_spec(self):
        from .register import RegisterSpec

        return RegisterSpec(n_values=self.n_values)


class MultiCasSpec(Spec):
    """``n_cells`` independent CAS registers over values [0, n_values).

    Per cell: READ returns the value; WRITE sets it (resp 0); CAS(old,
    new) responds 1 and sets ``new`` iff the cell holds ``old``, else
    responds 0.
    """

    name = "multicas"

    def __init__(self, n_cells: int = 4, n_values: int = 4):
        self.n_cells = n_cells
        self.n_values = n_values
        self.STATE_DIM = n_cells
        self.CMDS = (
            CmdSig("read", n_args=n_cells, n_resps=n_values,
                   proj=KeyProj(pcmd=READ, stride=1)),
            CmdSig("write", n_args=n_cells * n_values, n_resps=1,
                   proj=KeyProj(pcmd=WRITE, stride=n_values)),
            CmdSig("cas", n_args=n_cells * n_values * n_values, n_resps=2,
                   proj=KeyProj(pcmd=CAS, stride=n_values * n_values)),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.n_cells, np.int32)

    def write_arg(self, cell: int, value: int) -> int:
        return cell * self.n_values + value

    def cas_arg(self, cell: int, old: int, new: int) -> int:
        return (cell * self.n_values + old) * self.n_values + new

    def spec_kwargs(self):
        return {"n_cells": self.n_cells, "n_values": self.n_values}

    def sweep_kernel(self):
        return 4, (self.n_cells, self.n_values), None

    def state_elem_bounds(self):
        return [self.n_values] * self.n_cells

    def step_py(self, state, cmd, arg, resp):
        state = list(state)
        if cmd == READ:
            return state, resp == state[arg]
        if cmd == WRITE:
            cell, value = divmod(arg, self.n_values)
            state[cell] = value
            return state, resp == 0
        cell, rest = divmod(arg, self.n_values * self.n_values)
        old, new = divmod(rest, self.n_values)
        if state[cell] == old:
            state[cell] = new
            return state, resp == 1
        return state, resp == 0

    def step_torch(self, state, cmd, arg, resp):
        state, cmd, arg, resp = broadcast_vector(state, cmd, arg, resp)
        nv = self.n_values
        iota = torch.arange(self.n_cells, device=state.device)
        is_read = cmd == READ
        is_write = cmd == WRITE
        cell = torch.where(is_read, arg, torch.where(
            is_write, floor_div(arg, nv), floor_div(arg, nv * nv)))
        w_val = torch.remainder(arg, nv)
        old = torch.remainder(floor_div(arg, nv), nv)
        cur = take_elem(state, cell)
        succ = cur == old
        ok = torch.where(is_read, resp == cur,
                         torch.where(is_write, resp == 0,
                                     resp == succ.to(resp.dtype)))
        target = torch.where(is_write, w_val, torch.where(succ, w_val, cur))
        write_it = ~is_read & (is_write | succ)
        new = torch.where(write_it[..., None] & (iota == cell[..., None]),
                          target[..., None].to(state.dtype), state)
        return new.to(torch.int32), ok

    def gen_cmd(self, rng, state=None):
        """Bias CAS's expected value toward the cell's (approximate)
        current value half the time, so generated CASes succeed often
        enough to exercise the per-cell lost-update race."""
        cmd = rng.randrange(len(self.CMDS))
        if cmd == CAS:
            cell = rng.randrange(self.n_cells)
            new = rng.randrange(self.n_values)
            if state is not None and rng.random() < 0.5:
                old = int(state[cell])
            else:
                old = rng.randrange(self.n_values)
            return CAS, self.cas_arg(cell, old, new)
        return cmd, rng.randrange(self.CMDS[cmd].n_args)

    def projected_spec(self):
        from .cas import CasSpec

        return CasSpec(n_values=self.n_values)


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _cell_server(store: dict):
    """One server applying read/write/cas per message, atomically, across
    all cells (the payload carries the cell)."""
    while True:
        msg = yield Recv()
        kind, cell, *rest = msg.payload
        if kind == "read":
            yield Send(msg.src, store.get(cell, 0))
        elif kind == "write":
            store[cell] = rest[0]
            yield Send(msg.src, 0)
        else:  # cas
            old, new = rest
            if store.get(cell, 0) == old:
                store[cell] = new
                yield Send(msg.src, 1)
            else:
                yield Send(msg.src, 0)


class AtomicMultiRegisterSUT:
    """Correct: one server, one atomically applied message per op."""

    def __init__(self, spec: MultiRegisterSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        sched.spawn("server", _cell_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == READ:
            yield Send("server", ("read", arg))
        else:
            cell, value = divmod(arg, self.spec.n_values)
            yield Send("server", ("write", cell, value))
        msg = yield Recv()
        return msg.payload


class ShardedStaleMultiRegisterSUT:
    """Racy: reads are served from a per-pid shard cache that other pids'
    writes never invalidate; the stale reads violate per-cell
    linearizability."""

    def __init__(self, spec: MultiRegisterSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        self.cache = {}  # (pid, cell) -> value
        sched.spawn("server", _cell_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == READ:
            if (pid, arg) in self.cache:
                return self.cache[(pid, arg)]
            yield Send("server", ("read", arg))
            msg = yield Recv()
            self.cache[(pid, arg)] = msg.payload
            return msg.payload
        cell, value = divmod(arg, self.spec.n_values)
        yield Send("server", ("write", cell, value))
        msg = yield Recv()
        self.cache[(pid, cell)] = value
        return 0


class AtomicMultiCasSUT:
    """Correct: each op, CAS included, is one atomically applied server
    message."""

    def __init__(self, spec: MultiCasSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        sched.spawn("server", _cell_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        nv = self.spec.n_values
        if cmd == READ:
            yield Send("server", ("read", arg))
        elif cmd == WRITE:
            cell, value = divmod(arg, nv)
            yield Send("server", ("write", cell, value))
        else:
            cell, rest = divmod(arg, nv * nv)
            old, new = divmod(rest, nv)
            yield Send("server", ("cas", cell, old, new))
        msg = yield Recv()
        return msg.payload


class RacyMultiCasSUT:
    """Racy: CAS is read-compare-write as separate round trips; a
    concurrent write to the same cell between the read and the write is
    silently clobbered while the CAS still reports success."""

    def __init__(self, spec: MultiCasSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        sched.spawn("server", _cell_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        nv = self.spec.n_values
        if cmd == READ:
            yield Send("server", ("read", arg))
            msg = yield Recv()
            return msg.payload
        if cmd == WRITE:
            cell, value = divmod(arg, nv)
            yield Send("server", ("write", cell, value))
            msg = yield Recv()
            return msg.payload
        cell, rest = divmod(arg, nv * nv)
        old, new = divmod(rest, nv)
        yield Send("server", ("read", cell))
        msg = yield Recv()
        if msg.payload != old:
            return 0
        # the compare happened client-side: another pid's write to this
        # cell can land before this write does
        yield Send("server", ("write", cell, new))
        yield Recv()
        return 1
