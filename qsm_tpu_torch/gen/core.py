"""Batched command-sequence generation (the generation plane's core).

The counterpart of the JAX package's ``qsm_tpu/gen/core.py``.  Two
stages: a **raw draw table** (``uint32[lanes, draws]`` of seeded
randomness) and a **host-side assembly** that spends those draws building
well-formed concurrent histories under a :class:`.GenProfile`.

* ``path="py"``: the pure-Python table (``random.Random`` per lane),
  byte-identical everywhere and to the JAX package's ``"py"`` table;
* ``path="jax"`` (and ``"auto"``): the batched table, one launch of
  ``csrc/threefry_draws.cu`` for every lane (``ops/draws_kernel.py``).
  The path keeps its name because it is the same table, bit for bit, as
  the JAX package's ``"jax"`` path (per-lane ``jax.random`` key splits),
  so a (profile, seed, path) triple names one corpus in both packages.
  It runs on CUDA unless the caller passes ``device="cpu"`` (the kernel's
  plain version); without CUDA it raises ``BackendUnavailable`` and never
  turns into ``"py"``.

The assembly is identical for both tables and consumes a fixed number of
draws per simulated-clock tick, so a lane's history is a pure function of
its draw row.  Each tick either invokes on an idle pid or completes an
outstanding op, with the profile's knobs applied; completions respond
model-consistently along the completion order (the corpus is linearizable
by construction) except with probability ``p_adverse``, where the
response is drawn from the command's domain.  The checker decides which
corpora violate; generation never does.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np

from ..core.history import History, Op, bucket_for
from ..sched.runner import PENDING_T
from .profile import GenProfile

# fixed draw budget per simulated-clock tick (invoke-or-complete coin,
# pid choice, cmd-or-pending, arg, adverse coin, resp): alignment never
# depends on which branch a tick took
_DRAWS_PER_TICK = 6
# a history of n ops takes at most 2n+1 ticks (each op is one invoke
# tick and at most one complete tick); headroom doubles it
_U32 = float(1 << 32)

PATHS = ("py", "jax", "auto")


def _n_draws(n_ops: int) -> int:
    return _DRAWS_PER_TICK * (4 * n_ops + 8)


class DrawStream:
    """A cursor over one lane's raw draws.  Exhaustion raises: the table
    is sized by construction (``_n_draws``), so hitting the end means the
    assembly's draw discipline broke, not bad luck."""

    def __init__(self, row: np.ndarray):
        self._row = row
        self._i = 0

    def unit(self) -> float:
        """Uniform in [0, 1)."""
        if self._i >= len(self._row):
            raise RuntimeError("draw stream exhausted (sizing bug)")
        v = float(self._row[self._i]) / _U32
        self._i += 1
        return v

    def randrange(self, n: int) -> int:
        return min(n - 1, int(self.unit() * n))


def _raw_draws_py(seed: int, n_lanes: int, n_draws: int) -> np.ndarray:
    """The canonical table: one ``random.Random`` per lane, seeded by
    (seed, lane); byte-identical on every platform."""
    out = np.empty((n_lanes, n_draws), np.uint32)
    for lane in range(n_lanes):
        rng = random.Random(f"gen:{seed}:{lane}")
        out[lane] = [rng.getrandbits(32) for _ in range(n_draws)]
    return out


def _raw_draws_device(seed: int, n_lanes: int, n_draws: int,
                      device) -> np.ndarray:
    """The batched table: one ``threefry_draws`` launch on ``device`` (the
    plain version on the CPU), copied to the host for the assembly
    through pinned memory (``table_to_host``)."""
    from ..ops.draws_kernel import raw_draws, table_to_host

    return table_to_host(raw_draws(seed, n_lanes, n_draws, device))


def _pick_weighted(stream: DrawStream, weights) -> int:
    u = stream.unit()
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if u < acc:
            return i
    return len(weights) - 1


def _skewed_arg(stream: DrawStream, n_args: int, skew: float) -> int:
    # u ** (1 + skew) piles mass toward 0 as skew grows; skew 0 is
    # exactly uniform
    u = stream.unit()
    return min(n_args - 1, int(n_args * (u ** (1.0 + skew))))


def _complete(spec, profile: GenProfile, stream: DrawStream, state,
              cmd: int, arg: int):
    """One completion's (resp, next_state): model-consistent along the
    completion-order walk, or (with ``p_adverse``) an off-model draw; the
    walk then advances anyway (first valid resp), so one adversarial
    completion perturbs one op, not every op after it."""
    adverse = stream.unit() < profile.p_adverse
    drawn = stream.randrange(spec.CMDS[cmd].n_resps)
    consistent, nxt = None, state
    for resp in spec.resp_domain(cmd):
        new_state, ok = spec.step_py(list(state), cmd, arg, resp)
        if ok:
            consistent = resp
            nxt = [int(v) for v in new_state]
            break
    if consistent is None or adverse:
        return drawn, nxt
    return consistent, nxt


def generate_history(spec, profile: GenProfile, stream: DrawStream,
                     *, seed: Optional[int] = None,
                     program_id: Optional[int] = None) -> History:
    """Assemble one history from a lane's draws (module docstring)."""
    weights = profile.weights(spec.n_cmds)
    remaining = profile.n_ops
    outstanding = {}
    dead = set()
    done: List[Op] = []
    # the completion-order model walk the consistent responses ride
    state = [int(v) for v in spec.initial_state()]
    t = 0
    while remaining > 0 or outstanding:
        mark = stream._i
        idle = [p for p in range(profile.n_pids)
                if p not in outstanding and p not in dead]
        can_invoke = remaining > 0 and idle
        if not can_invoke and not outstanding:
            break  # every pid is dead; undone ops are simply not issued
        if can_invoke and (not outstanding
                           or stream.unit() < profile.overlap):
            pid = idle[stream.randrange(len(idle))]
            cmd = _pick_weighted(stream, weights)
            arg = _skewed_arg(stream, spec.CMDS[cmd].n_args,
                              profile.key_skew)
            outstanding[pid] = Op(pid=pid, cmd=cmd, arg=arg, resp=-1,
                                  invoke_time=t, response_time=PENDING_T)
            remaining -= 1
        else:
            pids = sorted(outstanding)
            pid = pids[stream.randrange(len(pids))]
            op = outstanding.pop(pid)
            if stream.unit() < profile.p_pending:
                done.append(op)  # never responds (crash/drop shape)
                dead.add(pid)    # a blocked pid can't invoke again
            else:
                resp, state = _complete(spec, profile, stream, state,
                                        op.cmd, op.arg)
                done.append(Op(pid=op.pid, cmd=op.cmd, arg=op.arg,
                               resp=resp, invoke_time=op.invoke_time,
                               response_time=t))
        # fixed spend: burn whatever this tick's branch left over
        while stream._i - mark < _DRAWS_PER_TICK:
            stream.unit()
        t += 1
    done.sort(key=lambda o: o.invoke_time)
    return History(done, seed=seed, program_id=program_id)


def generate_batch(spec, profile: GenProfile, seed: int, n: int,
                   path: str = "auto", device=None) -> List[History]:
    """``n`` histories from one seeded draw table.

    ``path``: ``"py"`` (canonical, host), ``"jax"`` (the threefry table
    on ``device``, CUDA by default) or ``"auto"`` (``"jax"``).
    Provenance rides each history (``seed``/``program_id``) so any lane is
    replayable alone."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path == "py":
        draws = _raw_draws_py(seed, n, _n_draws(profile.n_ops))
    else:
        draws = _raw_draws_device(seed, n, _n_draws(profile.n_ops), device)
    return [generate_history(spec, profile, DrawStream(draws[lane]),
                             seed=seed, program_id=lane)
            for lane in range(n)]


def profile_bucket(profile: GenProfile) -> int:
    """The op bucket this profile's histories land in
    (``core/history.py::OP_BUCKETS``)."""
    return bucket_for(profile.n_ops)
