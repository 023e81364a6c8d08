"""Multi-key transactions: registers over cells with a cross-cell
``copy(src, dst)`` that reads ``src`` and writes its value into ``dst`` in
one atomic step.  A copy couples two keys, so the family does not
decompose per key; its step reads two elements of the state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import (CmdSig, Spec, broadcast_vector, floor_div,
                         take_elem)
from ..sched.scheduler import Recv, Scheduler, Send

READ = 0
WRITE = 1
COPY = 2


class TxnRegisterSpec(Spec):
    """``n_cells`` registers over values [0, n_values) with a cross-cell
    copy.

    READ(cell) responds the cell's value; WRITE packs ``cell * n_values +
    v`` and responds 0; COPY packs the ``src != dst`` pair as ``src *
    (n_cells - 1) + off`` (``off`` skipping the diagonal), sets ``dst :=
    value(src)`` and responds 0.  ``2 <= n_cells <= n_values``.
    """

    name = "txn"

    def __init__(self, n_cells: int = 4, n_values: int = 4):
        if not 2 <= n_cells <= n_values:
            raise ValueError("need 2 <= n_cells <= n_values")
        self.n_cells = n_cells
        self.n_values = n_values
        self.STATE_DIM = n_cells
        self.CMDS = (
            CmdSig("read", n_args=n_cells, n_resps=n_values),
            CmdSig("write", n_args=n_cells * n_values, n_resps=1),
            CmdSig("copy", n_args=n_cells * (n_cells - 1), n_resps=1),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.n_cells, np.int32)

    def write_arg(self, cell: int, value: int) -> int:
        return cell * self.n_values + value

    def copy_arg(self, src: int, dst: int) -> int:
        off = dst - 1 if dst > src else dst  # diagonal excluded
        return src * (self.n_cells - 1) + off

    def copy_pair(self, arg: int):
        src, off = divmod(arg, self.n_cells - 1)
        return src, off + 1 if off >= src else off

    def spec_kwargs(self):
        return {"n_cells": self.n_cells, "n_values": self.n_values}

    def sweep_kernel(self):
        return 5, (self.n_cells, self.n_values), None

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
        src, dst = self.copy_pair(arg)
        state[dst] = state[src]
        return state, resp == 0

    def step_torch(self, state, cmd, arg, resp):
        state, cmd, arg, resp = broadcast_vector(state, cmd, arg, resp)
        iota = torch.arange(self.n_cells, device=state.device)
        is_read = cmd == READ
        is_write = cmd == WRITE
        w_cell = floor_div(arg, self.n_values)
        w_val = torch.remainder(arg, self.n_values)
        src = floor_div(arg, self.n_cells - 1)
        off = torch.remainder(arg, self.n_cells - 1)
        dst = torch.where(off >= src, off + 1, off)
        cell = torch.where(is_read, arg, torch.where(is_write, w_cell, dst))
        value = torch.where(is_write, w_val, take_elem(state, src))
        ok = torch.where(is_read, resp == take_elem(state, arg), resp == 0)
        new = torch.where(~is_read[..., None] & (iota == cell[..., None]),
                          value[..., None].to(state.dtype), state)
        return new.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _txn_server(store: dict):
    """One server applying read/write/copy per message, atomically."""
    while True:
        msg = yield Recv()
        kind, *rest = msg.payload
        if kind == "read":
            yield Send(msg.src, store.get(rest[0], 0))
        elif kind == "write":
            cell, value = rest
            store[cell] = value
            yield Send(msg.src, 0)
        else:  # copy, atomic on the server
            src, dst = rest
            store[dst] = store.get(src, 0)
            yield Send(msg.src, 0)


class AtomicTxnSUT:
    """Correct: the copy is one server message, read and write applied
    atomically."""

    def __init__(self, spec: TxnRegisterSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        sched.spawn("server", _txn_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == READ:
            yield Send("server", ("read", arg))
        elif cmd == WRITE:
            cell, value = divmod(arg, self.spec.n_values)
            yield Send("server", ("write", cell, value))
        else:
            src, dst = self.spec.copy_pair(arg)
            yield Send("server", ("copy", src, dst))
        msg = yield Recv()
        return msg.payload


class TornCopyTxnSUT:
    """Racy: copy is read-src-then-write-dst as separate round trips; a
    write to ``src`` in between makes the copy install a value no atomic
    copy could have observed."""

    def __init__(self, spec: TxnRegisterSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        sched.spawn("server", _txn_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == READ:
            yield Send("server", ("read", arg))
            msg = yield Recv()
            return msg.payload
        if cmd == WRITE:
            cell, value = divmod(arg, self.spec.n_values)
            yield Send("server", ("write", cell, value))
            msg = yield Recv()
            return msg.payload
        src, dst = self.spec.copy_pair(arg)
        yield Send("server", ("read", src))
        msg = yield Recv()
        # the source read was its own round trip: a write to src can land
        # before this dst write does
        yield Send("server", ("write", dst, msg.payload))
        yield Recv()
        return 0
