"""Random specifications and random histories, for differential fuzzing
of the checkers.

A random table has no algebraic structure for a bug to hide behind, so
ordering mistakes in a search (candidate order, memo keys, budget
accounting, precedence masks) part from the oracle almost at once.  Both
spec classes draw their tables from ``np.random.default_rng(seed)`` in the
JAX package's order, so one seed gives the same spec in both packages.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.history import History, Op
from ..core.spec import CmdSig, Spec, jax_index
from ..sched.runner import PENDING_T


def _draw_cmds(rng, n_cmds: int, max_args: int, max_resps: int):
    return tuple(
        CmdSig(f"c{i}", n_args=int(rng.integers(1, max_args + 1)),
               n_resps=int(rng.integers(1, max_resps + 1)))
        for i in range(n_cmds))


def _lookup(table: torch.Tensor, *idx):
    """``table[i0, i1, ...]`` elementwise, each index read as the JAX
    package's array indexing reads it (``core.spec.jax_index``)."""
    flat = torch.zeros((), dtype=torch.int64, device=table.device)
    for i, n in zip(idx, table.shape):
        flat = flat * n + jax_index(i.to(torch.int64), n)
    return table.reshape(-1)[flat]


class _TorchTables:
    """The spec's numpy tables as tensors, made once per device."""

    def _tables(self, device) -> List[torch.Tensor]:
        cache = self.__dict__.setdefault("_torch_tables", {})
        key = str(device)
        if key not in cache:
            cache[key] = [torch.from_numpy(np.ascontiguousarray(t)).to(device)
                          for t in self._numpy_tables()]
        return cache[key]


class RandomTableSpec(_TorchTables, Spec):
    """A spec whose fused step function is a seeded random table.

    ``trans[s, c, a, r]`` is uniform over [0, n_states); ``ok[s, c, a,
    r]`` is true with probability ``ok_bias``.  Scalar state with
    ``scalar_state_bound == n_states`` by construction.
    """

    name = "random_table"
    STATE_DIM = 1

    def __init__(self, seed: int, n_states: int = 8, n_cmds: int = 3,
                 max_args: int = 3, max_resps: int = 3,
                 ok_bias: float = 0.7):
        self.seed = seed
        self.n_states = n_states
        self.ok_bias = ok_bias
        self._max_args_bound = max_args
        self._max_resps_bound = max_resps
        rng = np.random.default_rng(seed)
        self.CMDS = _draw_cmds(rng, n_cmds, max_args, max_resps)
        a = max(c.n_args for c in self.CMDS)
        r = max(c.n_resps for c in self.CMDS)
        self._trans = rng.integers(
            0, n_states, size=(n_states, n_cmds, a, r), dtype=np.int32)
        self._ok = rng.random((n_states, n_cmds, a, r)) < ok_bias

    def _numpy_tables(self):
        return self._trans, self._ok

    def initial_state(self) -> np.ndarray:
        return np.zeros(1, np.int32)

    def scalar_state_bound(self, n_ops):
        return self.n_states

    def spec_kwargs(self):
        return {"seed": self.seed, "n_states": self.n_states,
                "n_cmds": len(self.CMDS),
                "max_args": self._max_args_bound,
                "max_resps": self._max_resps_bound,
                "ok_bias": self.ok_bias}

    def step_py(self, state, cmd, arg, resp):
        s = state[0]
        if not 0 <= s < self.n_states:
            return [s], False  # a failing self-loop outside the table
        return ([int(self._trans[s, cmd, arg, resp])],
                bool(self._ok[s, cmd, arg, resp]))

    def step_torch(self, state, cmd, arg, resp):
        trans, ok = self._tables(state.device)
        return (_lookup(trans, state, cmd, arg, resp).to(torch.int32),
                _lookup(ok, state, cmd, arg, resp))


class RandomVectorSpec(_TorchTables, Spec):
    """A random vector-state spec: each state element evolves by its own
    seeded table (values within its declared bound), ``ok`` by a table
    over (element 0, op).  Small bound products take the scalarized
    shadow, large ones the stepper's sweep regime."""

    name = "random_vector"

    def __init__(self, seed: int, bounds: Tuple[int, ...] = (4, 4, 4),
                 n_cmds: int = 3, max_args: int = 3, max_resps: int = 3,
                 ok_bias: float = 0.7):
        self.seed = seed
        self.bounds = tuple(int(b) for b in bounds)
        self.STATE_DIM = len(self.bounds)
        self.ok_bias = ok_bias
        self._max_args_bound = max_args
        self._max_resps_bound = max_resps
        rng = np.random.default_rng(seed)
        self.CMDS = _draw_cmds(rng, n_cmds, max_args, max_resps)
        a = max(c.n_args for c in self.CMDS)
        r = max(c.n_resps for c in self.CMDS)
        self._trans = [rng.integers(0, b, size=(b, n_cmds, a, r),
                                    dtype=np.int32)
                       for b in self.bounds]
        self._ok = rng.random((self.bounds[0], n_cmds, a, r)) < ok_bias

    def _numpy_tables(self):
        return [self._ok] + self._trans

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.STATE_DIM, np.int32)

    def state_elem_bounds(self):
        return list(self.bounds)

    def spec_kwargs(self):
        return {"seed": self.seed, "bounds": self.bounds,
                "n_cmds": len(self.CMDS),
                "max_args": self._max_args_bound,
                "max_resps": self._max_resps_bound,
                "ok_bias": self.ok_bias}

    def sweep_kernel(self):
        """Kind 6: params ``(n_cmds, A, R)`` (the tables' command, arg and
        resp extents); ``data`` the element bounds, then the ok table,
        then each element's transition table, flattened."""
        c, a, r = self._ok.shape[1:]
        data = np.concatenate(
            [np.asarray(self.bounds, np.int32), self._ok.reshape(-1)]
            + [t.reshape(-1) for t in self._trans]).astype(np.int32)
        return 6, (c, a, r), data

    def step_py(self, state, cmd, arg, resp):
        nxt = [int(t[int(s), cmd, arg, resp])
               for s, t in zip(state, self._trans)]
        return nxt, bool(self._ok[int(state[0]), cmd, arg, resp])

    def step_torch(self, state, cmd, arg, resp):
        ok_tab, *trans = self._tables(state.device)
        shape = torch.broadcast_shapes(state.shape[:-1], cmd.shape,
                                       arg.shape, resp.shape)
        state = state.expand(*shape, state.shape[-1])
        cmd, arg, resp = (x.expand(shape) for x in (cmd, arg, resp))
        nxt = torch.stack([_lookup(t, state[..., i], cmd, arg, resp)
                           for i, t in enumerate(trans)], dim=-1)
        ok = _lookup(ok_tab, state[..., 0], cmd, arg, resp)
        return nxt.to(torch.int32), ok


def random_history(spec: Spec, rng: random.Random, n_pids: int,
                   n_ops: int, p_pending: float = 0.0) -> History:
    """A random well-formed concurrent history against ``spec``.

    Simulated clock: each tick either invokes a fresh op on an idle pid or
    completes an outstanding one, so per-pid ops are sequential while ops
    on different pids overlap arbitrarily.  Responses are drawn uniformly
    from the command's domain."""
    remaining = n_ops
    outstanding: Dict[int, Op] = {}
    dead: set = set()  # pids whose op went pending: blocked forever
    done: List[Op] = []
    t = 0
    while remaining > 0 or outstanding:
        idle = [p for p in range(n_pids)
                if p not in outstanding and p not in dead]
        can_invoke = remaining > 0 and idle
        if not can_invoke and not outstanding:
            break  # every pid is dead
        if can_invoke and (not outstanding or rng.random() < 0.5):
            pid = rng.choice(idle)
            cmd = rng.randrange(len(spec.CMDS))
            arg = rng.randrange(spec.CMDS[cmd].n_args)
            outstanding[pid] = Op(pid=pid, cmd=cmd, arg=arg, resp=-1,
                                  invoke_time=t, response_time=PENDING_T)
            remaining -= 1
        else:
            pid = rng.choice(sorted(outstanding))
            op = outstanding.pop(pid)
            if rng.random() < p_pending:
                done.append(op)  # never responds
                dead.add(pid)
            else:
                resp = rng.randrange(spec.CMDS[op.cmd].n_resps)
                done.append(dataclasses.replace(
                    op, resp=resp, response_time=t))
        t += 1
    done.sort(key=lambda o: o.invoke_time)
    return History(done)


@dataclasses.dataclass
class FuzzReport:
    specs: int
    histories: int
    linearizable: int
    violations: int
    budget_exceeded: int
    # (spec_seed, history_index, backend_name, oracle_verdict, got)
    mismatches: List[Tuple[int, int, str, int, int]]
    # histories the cpp arm decided natively (0: the arm was vacuous,
    # every history fell back to the Python oracle it is compared with)
    cpp_native_histories: int = 0
    # histories the hybrid arm's host tail decided (0: the device budget
    # decided everything and the tail went unexercised)
    hybrid_tail_histories: int = 0

    @property
    def ok(self) -> bool:
        return not self.mismatches


def fuzz_arm(name: str, spec: Spec, device=None):
    """The backend of one fuzz arm.  The names are the JAX package's, so
    that a ``--backends`` string means the same in both packages; the
    device arms run on ``device`` (CUDA unless ``"cpu"``): ``device`` is
    ``TorchStepper`` (its sweep regime when the spec has no scalar
    shadow), ``segdc`` and ``auto`` the combinators over it, ``hybrid``
    ``HybridDevice`` at a device budget of 12 (so that random specs push
    real traffic through both sides), and ``pallas`` ``TorchGPU``, the
    port of the Pallas kernel, at the JAX package's budgets for that
    arm."""
    if name == "memo":
        from ..ops.wing_gong_cpu import WingGongCPU

        return WingGongCPU(memo=True)
    if name == "cpp":
        from ..native import CppOracle

        return CppOracle(spec)
    if name == "device":
        from ..ops.stepper import TorchStepper

        return TorchStepper(spec, device=device)
    if name == "segdc":
        from ..ops.segdc import SegDC
        from ..ops.stepper import TorchStepper

        return SegDC(spec, make_inner=lambda s: TorchStepper(s,
                                                             device=device))
    if name == "auto":
        from ..ops.router import AutoDevice

        return AutoDevice(spec, device=device)
    if name == "hybrid":
        from ..ops.hybrid import HybridDevice

        return HybridDevice(spec, budget=12, device=device)
    if name == "pallas":
        from ..ops.gpu_backend import TorchGPU

        return TorchGPU(spec, budget=4_000, mid_budget=0, rescue_budget=0,
                        device=device)
    raise ValueError(f"unknown fuzz backend {name!r}")


def fuzz_parity(n_specs: int = 10, hists_per_spec: int = 32,
                seed: int = 0, n_pids: int = 4, n_ops: int = 10,
                p_pending: float = 0.1,
                backends: Sequence[str] = ("memo", "cpp", "device"),
                spec_kwargs: Optional[dict] = None,
                vector_bounds: Optional[Tuple[int, ...]] = None,
                device=None, timings: Optional[Dict[str, float]] = None,
                vector_spec: type = RandomVectorSpec) -> FuzzReport:
    """Differential sweep: for each random spec, every requested arm
    (:func:`fuzz_arm`) must agree with the exact memo-free Python oracle
    on every random history.  BUDGET_EXCEEDED on either side is never a
    mismatch by itself; a decided verdict that contradicts the oracle's
    decided verdict always is.

    ``vector_bounds`` switches from scalar random tables to
    :class:`RandomVectorSpec` (or ``vector_spec``, a subclass of it) with
    those element bounds: a small product rides the scalar shadow, one
    past the packed-state cap the sweep regime.  ``timings``, when given, receives each arm's seconds (and
    the oracle's, under ``"oracle"``)."""
    import time

    from ..ops.backend import Verdict
    from ..ops.wing_gong_cpu import WingGongCPU

    oracle = WingGongCPU(memo=False)
    lin = vio = bud = 0
    cpp_native = 0
    hybrid_tail = 0
    undecided = int(Verdict.BUDGET_EXCEEDED)
    mismatches: List[Tuple[int, int, str, int, int]] = []

    def clock(key, t0):
        if timings is not None:
            timings[key] = (timings.get(key, 0.0)
                            + time.perf_counter() - t0)

    for k in range(n_specs):
        spec_seed = seed * 1_000_003 + k
        if vector_bounds is not None:
            spec = vector_spec(spec_seed, bounds=vector_bounds,
                               **(spec_kwargs or {}))
        else:
            spec = RandomTableSpec(spec_seed, **(spec_kwargs or {}))
        rng = random.Random(f"fuzz:{spec_seed}")
        hists = [random_history(spec, rng, n_pids, n_ops,
                                p_pending=p_pending)
                 for _ in range(hists_per_spec)]
        t0 = time.perf_counter()
        want = np.asarray(oracle.check_histories(spec, hists))
        clock("oracle", t0)
        lin += int((want == int(Verdict.LINEARIZABLE)).sum())
        vio += int((want == int(Verdict.VIOLATION)).sum())
        bud += int((want == undecided).sum())
        for name in backends:
            t0 = time.perf_counter()
            backend = fuzz_arm(name, spec, device)
            got = backend.check_histories(spec, hists)
            clock(name, t0)
            if name == "cpp":
                cpp_native += backend.native_histories
            elif name == "hybrid":
                hybrid_tail += backend.tail_histories
            for i, (w, g) in enumerate(zip(want, got)):
                if int(g) == undecided or int(w) == undecided:
                    continue  # a deferral on either side
                if int(w) != int(g):
                    mismatches.append((spec_seed, i, name, int(w), int(g)))
    return FuzzReport(specs=n_specs, histories=n_specs * hists_per_spec,
                      linearizable=lin, violations=vio,
                      budget_exceeded=bud, mismatches=mismatches,
                      cpp_native_histories=cpp_native,
                      hybrid_tail_histories=hybrid_tail)
