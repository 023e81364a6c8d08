"""Multi-key KV map: GET / PUT over ``n_keys`` keys with values [0,
n_values).

The model state is one value per key.  At the default size (4 keys, 4
values) its packed domain is 256 states and the device tabulates it; at
16 keys it is 4**16, too many for a table, and the stepper takes its
sweep regime (``ops/sweep_kernel.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import (CmdSig, Spec, broadcast_vector, floor_div,
                         take_elem)
from ..sched.scheduler import Recv, Scheduler, Send

GET = 0
PUT = 1


class KvSpec(Spec):
    """Atomic map over ``n_keys`` keys with values [0, n_values).

    GET(k) returns the key's value; PUT packs ``k * n_values + v`` into its
    integer argument and responds 0.  Model state: one value per key.
    """

    name = "kv"

    def __init__(self, n_keys: int = 4, n_values: int = 4):
        self.n_keys = n_keys
        self.n_values = n_values
        self.STATE_DIM = n_keys
        self.CMDS = (
            CmdSig("get", n_args=n_keys, n_resps=n_values),
            CmdSig("put", n_args=n_keys * n_values, n_resps=1),
        )

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.n_keys, np.int32)

    def put_arg(self, key: int, value: int) -> int:
        return key * self.n_values + value

    def spec_kwargs(self):
        return {"n_keys": self.n_keys, "n_values": self.n_values}

    def sweep_kernel(self):
        return 2, (self.n_keys, self.n_values), None

    def state_elem_bounds(self):
        return [self.n_values] * self.n_keys  # one value per key

    def step_py(self, state, cmd, arg, resp):
        state = list(state)
        if cmd == GET:
            return state, resp == state[arg]
        key, value = divmod(arg, self.n_values)
        state[key] = value
        return state, resp == 0

    def step_torch(self, state, cmd, arg, resp):
        state, cmd, arg, resp = broadcast_vector(state, cmd, arg, resp)
        iota = torch.arange(self.n_keys, device=state.device)
        is_get = cmd == GET
        key = torch.where(is_get, arg, floor_div(arg, self.n_values))
        value = torch.remainder(arg, self.n_values)
        ok = torch.where(is_get, resp == take_elem(state, key), resp == 0)
        new = torch.where(~is_get[..., None] & (iota == key[..., None]),
                          value[..., None].to(state.dtype), state)
        return new.to(torch.int32), ok


# ---------------------------------------------------------------------------
# SUT implementations
# ---------------------------------------------------------------------------

def _kv_server(store: dict):
    while True:
        msg = yield Recv()
        kind, key, *rest = msg.payload
        if kind == "get":
            yield Send(msg.src, store.get(key, 0))
        else:
            store[key] = rest[0]
            yield Send(msg.src, 0)


class AtomicKvSUT:
    """Correct: one server, one atomically applied message per op."""

    def __init__(self, spec: KvSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        sched.spawn("server", _kv_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == GET:
            yield Send("server", ("get", arg))
        else:
            key, value = divmod(arg, self.spec.n_values)
            yield Send("server", ("put", key, value))
        msg = yield Recv()
        return msg.payload


class StaleCacheKvSUT:
    """Racy: each client caches GET results per key and never revalidates;
    other pids' PUTs are invisible to it, and the stale reads violate
    per-key linearizability."""

    def __init__(self, spec: KvSpec):
        self.spec = spec

    def setup(self, sched: Scheduler) -> None:
        self.store = {}
        self.cache = {}  # (pid, key) -> value
        sched.spawn("server", _kv_server(self.store), daemon=True)

    def perform(self, pid: int, cmd: int, arg: int):
        if cmd == GET:
            if (pid, arg) in self.cache:
                return self.cache[(pid, arg)]
            yield Send("server", ("get", arg))
            msg = yield Recv()
            self.cache[(pid, arg)] = msg.payload
            return msg.payload
        key, value = divmod(arg, self.spec.n_values)
        yield Send("server", ("put", key, value))
        msg = yield Recv()
        self.cache[(pid, key)] = value
        return 0
