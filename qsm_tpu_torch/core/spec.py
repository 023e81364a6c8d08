"""State-machine specification protocol.

A spec is a small class over integer domains whose one function,
``step(state, cmd, arg, resp) -> (state', ok)``, fuses the model's
transition with its postcondition.  It comes in two forms:

* ``step_py``    — pure-Python ints, used by the host oracle, the
  generator and witness replay.  This is the parity reference.
* ``step_torch`` — the same function on int32 tensors of any (broadcast)
  batch shape, branchless, used to build the per-history step tables the
  device search gathers from.

Model state is a fixed-length int32 vector (``STATE_DIM``).  A scalar spec
(``STATE_DIM == 1``) declares a bound on its reachable states
(``scalar_state_bound``), which is what lets the device tabulate it; a
vector spec declares per-element bounds (``state_elem_bounds``) and the
device tabulates its packed scalar shadow (``ops/scalarize.py``).  For a
vector spec ``step_torch`` takes and returns the state with its elements
on a trailing axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KeyProj:
    """Per-key projection of one command (P-compositionality).  A command
    whose integer argument packs ``key * stride + projected_arg`` declares
    how to unpack it:

        key           = arg // stride
        projected op  = (pcmd, arg % stride, resp)   (resp passes through)

    ``pcmd`` indexes the projected (per-key) spec's alphabet
    (``projected_spec()``).  :func:`projection_report` validates the
    declarations once, so the split is checked rather than trusted."""

    pcmd: int
    stride: int


@dataclasses.dataclass(frozen=True)
class CmdSig:
    """Signature of one command: args drawn from ``[0, n_args)``,
    responses in ``[0, n_resps)``, and optionally its per-key projection
    (a spec decomposes iff every command declares one and
    :func:`projection_report` finds the projected spec faithful)."""

    name: str
    n_args: int
    n_resps: int
    proj: Optional[KeyProj] = None


class Spec:
    """Base class for state-machine specifications.

    Subclasses define ``CMDS``, ``STATE_DIM``, ``initial_state()``,
    ``step_py`` and ``step_torch``, and optionally ``gen_cmd`` and
    ``scalar_state_bound``.  Preconditions are enforced at generation time
    only.
    """

    name: str = "spec"
    CMDS: Tuple[CmdSig, ...] = ()
    STATE_DIM: int = 1

    # -- model ------------------------------------------------------------
    def initial_state(self) -> np.ndarray:
        raise NotImplementedError

    def step_py(self, state: Sequence[int], cmd: int, arg: int, resp: int
                ) -> Tuple[Sequence[int], bool]:
        raise NotImplementedError

    def step_torch(self, state, cmd, arg, resp):
        """``(next_state, ok)`` for int32 tensors that broadcast together.
        For a scalar spec ``state`` is the state itself and both outputs
        have the broadcast shape; for a vector spec ``state`` is
        ``[..., STATE_DIM]``, ``next_state`` likewise and ``ok`` drops the
        trailing axis.  ``next_state`` is int32, ``ok`` bool."""
        raise NotImplementedError

    # -- generation -------------------------------------------------------
    def precondition(self, state: Sequence[int], cmd: int, arg: int) -> bool:
        return True

    def gen_cmd(self, rng, state: Optional[Sequence[int]] = None
                ) -> Tuple[int, int]:
        """A random (cmd, arg) whose precondition holds in ``state``:
        uniform over the alphabet, rejection-sampled (bounded tries)."""
        cmd = arg = 0
        for _ in range(32):
            cmd = rng.randrange(len(self.CMDS))
            arg = rng.randrange(self.CMDS[cmd].n_args)
            if state is None or self.precondition(state, cmd, arg):
                break
        return cmd, arg

    def shrink_arg(self, cmd: int, arg: int):
        """Candidate smaller args for shrinking (toward 0)."""
        out = []
        if arg > 0:
            out.append(0)
        if arg > 1:
            out.append(arg // 2)
        return out

    # -- device search ----------------------------------------------------
    def scalar_state_bound(self, n_ops: int) -> Optional[int]:
        """Exclusive upper bound on the scalar states reachable through ok
        steps whose ARGS lie in the declared domains (resps arbitrary), or
        None.  The device backend needs one to tabulate the spec."""
        return None

    def state_elem_bounds(self) -> Optional[Sequence[int]]:
        """Per-element exclusive upper bounds on the state vector, or None.

        The contract: the initial state is within bounds, and from any
        state within bounds every ok step whose ARG is in the declared
        command domains (resps arbitrary) yields a state within bounds.
        Declaring it lets the device pack small vector states into one
        scalar (``ops/scalarize.py``) and tabulate the packed spec; the
        packing is a bijection, so verdicts are unchanged."""
        return None

    def sweep_kernel(self):
        """``(kind, params, data)`` selecting the model's step code inside
        the ``stepper_sweep`` kernel (``csrc/stepper_sweep.cu``), or None.
        ``params`` is a tuple of at most three ints, ``data`` None or an
        int32 array the kernel reads from device memory.  A spec without
        one (or wider than the kernel's 28 words) runs the sweep regime by
        its generic route, its own ``step_torch`` beside the
        ``sweep_advance`` kernel (``ops/sweep_generic.py``)."""
        return None

    def native_kernel(self) -> Optional[Tuple[int, int, int]]:
        """``(kind, p0, p1)`` selecting a step function built into the
        native host checker (``native/wg.cpp``), or None.  A scalar spec
        with a state bound needs none (the native checker reads its step
        table); a vector spec opts in with its kind (1 queue, 2 KV map, 3
        stack) and parameters."""
        return None

    # -- decomposition ----------------------------------------------------
    def partition_key(self, cmd: int, arg: int) -> Optional[int]:
        """The op's key for per-key decomposition, derived from the
        command's :class:`KeyProj`; None when it declares none, which
        every consumer reads as "do not decompose"."""
        p = self.CMDS[cmd].proj
        return None if p is None else arg // p.stride

    def project_op(self, cmd: int, arg: int, resp: int
                   ) -> Tuple[int, int, int]:
        """A whole-spec op as the projected spec's ``(cmd, arg, resp)``.
        Responses pass through: the validator pins each projected
        command's response domain to the original's, so a stitched
        witness's completions stay in domain for the whole spec."""
        p = self.CMDS[cmd].proj
        if p is None:
            raise ValueError(
                f"{self.name}: command {cmd} declares no KeyProj; "
                "partition_key is not total")
        return p.pcmd, arg % p.stride, resp

    def project_state(self, state: Sequence[int], key: int) -> list:
        """The component of a whole model state that the projected spec
        sees for ``key``: element ``key`` of the state vector by default
        (every decomposable spec here is a product of scalars)."""
        return [int(state[key])]

    # -- persistence ------------------------------------------------------
    def spec_kwargs(self) -> dict:
        """Constructor kwargs that reproduce this spec exactly."""
        return {}

    # -- derived ----------------------------------------------------------
    @property
    def n_cmds(self) -> int:
        return len(self.CMDS)

    @property
    def max_resps(self) -> int:
        return max(c.n_resps for c in self.CMDS)

    def resp_domain(self, cmd: int) -> range:
        return range(self.CMDS[cmd].n_resps)


@functools.lru_cache(maxsize=None)
def without_sweep_kernel(cls: type) -> type:
    """``cls`` with its kernel model withheld: a subclass whose
    ``sweep_kernel()`` returns None, so that the sweep regime runs it by
    its generic route, as it runs a user's new spec.  One class for each
    ``cls``."""
    return type(f"{cls.__name__}WithoutKernel", (cls,), {
        "__module__": cls.__module__,
        "__doc__": f"{cls.__name__} with its kernel model withheld.",
        "sweep_kernel": lambda self: None})


def broadcast_vector(state, *ops):
    """``state`` ``[..., D]`` and the op tensors broadcast together:
    ``(state [..., D], op [...], ...)``, expanded views."""
    shape = torch.broadcast_shapes(state.shape[:-1], *(o.shape for o in ops))
    return (state.expand(*shape, state.shape[-1]),
            *(o.expand(shape) for o in ops))


def jax_index(idx, n: int):
    """The element a dynamic index reads in an axis of ``n``, as the JAX
    package's array indexing reads it: a negative index counts from the
    end, then the index is clamped into ``[0, n)``."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def take_elem(state, idx):
    """``state[..., idx]`` per batch element, ``idx`` shaped as
    ``state[..., 0]``, read as :func:`jax_index` reads it."""
    i = jax_index(idx, state.shape[-1]).long()
    return torch.gather(state, -1, i[..., None]).squeeze(-1)


def floor_div(x, d: int):
    return torch.div(x, d, rounding_mode="floor")


def compile_step_table(spec: Spec, n_states: int):
    """``step_py`` tabulated for a scalar spec: ``(trans, ok)`` of shape
    ``[n_states, n_cmds, max_args, max_resps]`` over states ``[0,
    n_states)`` and the declared domains (the native checker's table)."""
    assert spec.STATE_DIM == 1, "step tables only for scalar-state specs"
    max_args = max(c.n_args for c in spec.CMDS)
    trans = np.zeros((n_states, spec.n_cmds, max_args, spec.max_resps),
                     np.int32)
    ok = np.zeros(trans.shape, bool)
    for s in range(n_states):
        for c, sig in enumerate(spec.CMDS):
            for a in range(sig.n_args):
                for r in range(sig.n_resps):
                    ns, good = spec.step_py([s], c, a, r)
                    trans[s, c, a, r] = ns[0]
                    ok[s, c, a, r] = good
    return trans, ok


# Selectivity probing caps at this many states: the table is a search
# heuristic, never a soundness input, so a deterministic stride sample of
# a large packed domain estimates the same ranks at a bounded cost.
MAX_SELECTIVITY_PROBE_STATES = 512


def compile_selectivity_table(
    spec: Spec, n_states: int,
    max_probe_states: int = MAX_SELECTIVITY_PROBE_STATES,
) -> np.ndarray:
    """Postcondition selectivity per (cmd, arg, resp): the fraction of
    scalar states in ``[0, n_states)`` whose ``step_py`` accepts the op.

    Same scalar-domain contract and source of truth as
    :func:`compile_step_table`.  Low selectivity means the op's
    postcondition holds almost nowhere (the steering loop's starting op
    mix weights such commands up).  Domains larger than
    ``max_probe_states`` are stride-sampled deterministically: the result
    is a rank estimate, and no verdict depends on it."""
    assert spec.STATE_DIM == 1, \
        "selectivity tables only for scalar-state specs"
    if n_states <= max_probe_states:
        # the step table's ok plane is the selectivity source, so the
        # estimate can never disagree with the tabulation
        _, ok = compile_step_table(spec, n_states)
        return ok.mean(axis=0, dtype=np.float64)
    max_args = max(c.n_args for c in spec.CMDS)
    stride = -(-n_states // max_probe_states)
    sel = np.zeros((spec.n_cmds, max_args, spec.max_resps), np.float64)
    n_probed = 0
    for s in range(0, n_states, stride):
        n_probed += 1
        for c, sig in enumerate(spec.CMDS):
            for a in range(sig.n_args):
                for r in range(sig.n_resps):
                    _, good = spec.step_py([s], c, a, r)
                    if good:
                        sel[c, a, r] += 1.0
    return sel / max(n_probed, 1)


# ---------------------------------------------------------------------------
# Validation of a declared per-key projection (once per spec)
# ---------------------------------------------------------------------------

# Faithfulness is checked over every (cmd, arg, resp) (arg domains sampled
# by stride past the cap) from a seeded sample of reachable states: a
# product state cannot be enumerated, and a projection fault is a
# per-command packing mistake, visible from almost any state.  The caps
# and the seed string are the JAX package's, so both validators walk the
# same states and word their problems alike.
_PROJ_PROBE_STATES = 24
_PROJ_PROBE_ARGS = 64


def projection_report(spec: Spec, seed: int = 0) -> list:
    """Problems with a spec's declared per-key projection; [] means sound.

    Checks, in order: the declaration (``projected_spec()`` exists and
    every command carries a :class:`KeyProj`); the domains (the projected
    command exists, its arg domain holds ``[0, stride)``, its response
    domain equals the original's); then, from seeded reachable states,
    faithfulness and independence (a step changes only its own key's
    component, and the projected spec's step on the projected op from the
    projected state agrees).  Cached on the spec instance."""
    cached = spec.__dict__.get("_projection_report")
    if cached is not None:
        return list(cached)
    report = _projection_report_uncached(spec, seed)
    spec.__dict__["_projection_report"] = tuple(report)
    return report


def _projection_report_uncached(spec: Spec, seed: int) -> list:
    problems: list = []
    if not hasattr(spec, "projected_spec"):
        if any(c.proj is not None for c in spec.CMDS):
            return [f"{spec.name}: CmdSig declares KeyProj but the spec "
                    "has no projected_spec()"]
        return [f"{spec.name}: no per-key projection declared"]
    missing = [c.name for c in spec.CMDS if c.proj is None]
    if missing:
        return [f"{spec.name}: partition_key is not total — commands "
                f"{missing} declare no KeyProj"]
    try:
        proj = spec.projected_spec()
    except Exception as e:  # noqa: BLE001 — a failing factory is a problem
        return [f"{spec.name}: projected_spec() raised "
                f"{type(e).__name__}: {e}"]
    for sig in spec.CMDS:
        p = sig.proj
        if p.stride <= 0:
            problems.append(f"{sig.name}: KeyProj stride {p.stride} <= 0")
            continue
        if not 0 <= p.pcmd < proj.n_cmds:
            problems.append(f"{sig.name}: projected cmd {p.pcmd} outside "
                            f"{proj.name}'s alphabet [0, {proj.n_cmds})")
            continue
        psig = proj.CMDS[p.pcmd]
        if p.stride > psig.n_args:
            problems.append(
                f"{sig.name}: projected args [0, {p.stride}) exceed "
                f"{proj.name}.{psig.name} domain [0, {psig.n_args})")
        if sig.n_resps != psig.n_resps:
            problems.append(
                f"{sig.name}: response domain {sig.n_resps} != projected "
                f"{proj.name}.{psig.name} domain {psig.n_resps} (pending "
                "completions must replay in-domain on both)")
    if problems:
        return problems
    return _check_faithful(spec, proj, seed)


def _probe_states(spec: Spec, rng) -> list:
    """The initial state and seeded ok-walks of 8 steps from states
    already gathered."""
    states = [[int(v) for v in spec.initial_state()]]
    for _ in range(_PROJ_PROBE_STATES - 1):
        st = list(rng.choice(states))
        for _ in range(8):
            cmd = rng.randrange(spec.n_cmds)
            arg = rng.randrange(spec.CMDS[cmd].n_args)
            resp = rng.randrange(spec.CMDS[cmd].n_resps)
            nxt, ok = spec.step_py(list(st), cmd, arg, resp)
            if ok:
                st = [int(v) for v in nxt]
        states.append(st)
    return states


def _op_problem(spec: Spec, proj: Spec, states, n_keys: int, cmd: int,
                arg: int, resp: int) -> Optional[str]:
    """The first problem of one op over the probe states, or None."""
    sig = spec.CMDS[cmd]
    p = sig.proj
    key = arg // p.stride
    for st in states:
        try:
            whole, ok = spec.step_py(list(st), cmd, arg, resp)
            sub_st = spec.project_state(st, key)
            want_sub = spec.project_state(whole, key)
            got_sub, got_ok = proj.step_py(list(sub_st), p.pcmd,
                                           arg % p.stride, resp)
            leaked = [k2 for k2 in range(n_keys) if k2 != key and (
                [int(v) for v in spec.project_state(whole, k2)]
                != [int(v) for v in spec.project_state(st, k2)])]
        except Exception as e:  # noqa: BLE001 — a problem, not a crash
            return (f"{sig.name}(arg={arg}, resp={resp}): "
                    f"{type(e).__name__}: {e}")
        if leaked:
            return (f"{sig.name}(arg={arg}): step leaks into keys {leaked} "
                    f"beyond its own key {key} — keys are not independent")
        if (bool(got_ok) != bool(ok)
                or [int(v) for v in got_sub] != [int(v) for v in want_sub]):
            return (f"{sig.name}(arg={arg}, resp={resp}): projected "
                    f"{proj.name} step disagrees with the whole spec (ok "
                    f"{bool(ok)} vs {bool(got_ok)})")
    return None


def _check_faithful(spec: Spec, proj: Spec, seed: int) -> list:
    """At most one problem a command: the first (arg, resp) that fails."""
    import random

    rng = random.Random(f"pcomp-faithful:{spec.name}:{seed}")
    states = _probe_states(spec, rng)
    # every key an in-domain arg can map to
    n_keys = max((sig.n_args - 1) // sig.proj.stride + 1
                 for sig in spec.CMDS)
    problems: list = []
    for cmd, sig in enumerate(spec.CMDS):
        args = range(sig.n_args)
        if sig.n_args > _PROJ_PROBE_ARGS:
            args = range(0, sig.n_args, -(-sig.n_args // _PROJ_PROBE_ARGS))
        for arg in args:
            key = arg // sig.proj.stride
            got = spec.partition_key(cmd, arg)
            if got != key:
                # an override of partition_key that disagrees with the
                # declaration would split one way and project another
                problems.append(f"{sig.name}(arg={arg}): partition_key() "
                                f"answers {got} but KeyProj derives {key}")
                break
            problem = next(
                (pr for resp in range(sig.n_resps)
                 if (pr := _op_problem(spec, proj, states, n_keys, cmd, arg,
                                       resp)) is not None), None)
            if problem is not None:
                problems.append(problem)
                break
    return problems
