"""Spec soundness passes (pass family *a*; the counterpart of
``qsm_tpu/analysis/spec_passes.py``).

A spec defect is the cheapest possible time-burner on the card:
``step_py`` is the oracle's truth, ``step_torch`` is what builds the step
tables the kernels gather from, and every declared bound
(``scalar_state_bound`` / ``state_elem_bounds``) gates a fast path whose
soundness the kernels TRUST (``stepper_chunk`` gathers a precomputed
step-table row instead of re-evaluating the spec).  Any divergence
survives until the card decides a history differently from the oracle.

All passes are semantic (they execute the spec, they do not parse it);
the parity pass evaluates ``step_torch`` on the lint's device, the card
unless the caller asks for the CPU:

* ``QSM-SPEC-SIG``         — CmdSig domain consistency (positive arg /
  resp domains, unique names, STATE_DIM vs initial_state agreement).
* ``QSM-SPEC-RESP-DOMAIN`` — ``resp_domain(c)`` ⊆ ``[0, n_resps)`` for
  every command (subclasses may override the derived default).
* ``QSM-SPEC-GEN``         — sampled ``gen_cmd`` stays inside the
  declared (cmd, arg) domains and respects its own precondition.
* ``QSM-SPEC-REACH``       — every command is issuable (precondition
  true somewhere) and ok-respondable on sampled reachable states.
* ``QSM-SPEC-BOUND``       — ``scalar_state_bound``/``state_elem_bounds``
  hold along simulated ok-step trajectories whose ARGS are in-domain and
  whose RESPS are arbitrary (the bound's exact contract, core/spec.py).
* ``QSM-SPEC-PARITY``      — ``step_py`` vs ``step_torch`` agreement:
  exhaustive over the declared scalar state space when tabulable, else
  sampled over trajectory-reachable states; resps include out-of-domain
  values (SUTs can return anything).  ``step_torch`` runs once, on int32
  tensors holding the whole sampled grid.
* ``QSM-SPEC-PCOMP``       — a declared per-key projection
  (``CmdSig.proj`` / ``projected_spec``) must VALIDATE: total
  partition_key, in-domain projected ops, faithful + independent per-key
  semantics (``core.spec.projection_report``).  An unsound declaration
  would let the P-compositional checkers split a history they must not
  (unsound verdicts); the planner refuses at plan time, and this pass
  refuses before any corpus is even built.

The sampling is the reference's, draw for draw, so both analyzers report
the same findings at the same locations for the same spec.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.history import OP_BUCKETS
from ..core.spec import Spec
from .findings import ERROR, INFO, WARNING, Finding

# The op-count the bound/parity contracts are checked at: the LARGEST
# history bucket the kernels accept (core/history.py), not some smaller
# convenience size — a growth-shaped bound like the ticket dispenser's
# ``n_ops + 1`` reaches states up to this ceiling on the card, and a
# step_torch divergence that only bites near the top of the range must
# not lint green.
KERNEL_OPS_CEILING = OP_BUCKETS[-1]

# out-of-domain responses every pass mixes in: the kernel sees whatever
# a (buggy) SUT produced, so contracts must hold for arbitrary ints
_EXTRA_RESPS = (-1, 1 << 20)

_MAX_PARITY_STATES = 256   # states fed to the batched step_torch compare
# (> ticket's bound(128) = 129, so every in-tree scalar spec stays
# EXHAUSTIVE at the ops ceiling)
_MAX_PAIR_SAMPLES = 96     # (cmd, arg) pairs per state when not exhaustive


def _pairs(spec: Spec, rng: random.Random) -> List[Tuple[int, int]]:
    """All (cmd, arg) pairs when small, else a deterministic sample."""
    total = sum(c.n_args for c in spec.CMDS)
    if total <= _MAX_PAIR_SAMPLES:
        return [(c, a) for c, sig in enumerate(spec.CMDS)
                for a in range(sig.n_args)]
    out = []
    for _ in range(_MAX_PAIR_SAMPLES):
        c = rng.randrange(spec.n_cmds)
        out.append((c, rng.randrange(spec.CMDS[c].n_args)))
    return out


def _resps_for(spec: Spec, cmd: int, state: Sequence[int]
               ) -> List[int]:
    """In-domain resps (capped) + out-of-domain extras + the state-shaped
    resp a buggy SUT could echo (ticket dispenser: resp == state makes an
    out-of-domain TAKE ok — exactly the case that made bounding by
    n_tickets unsound, models/counter.py)."""
    dom = list(spec.resp_domain(cmd))[:32]
    extras = [int(state[0]), int(state[0]) + 1, *_EXTRA_RESPS]
    seen = set(dom)
    return dom + [r for r in extras if not (r in seen or seen.add(r))]


def check_sigs(spec: Spec, location: str) -> List[Finding]:
    out: List[Finding] = []
    if not spec.CMDS:
        return [Finding(ERROR, "QSM-SPEC-SIG", location,
                        "spec declares an empty command alphabet",
                        "define CMDS with at least one CmdSig")]
    names = [c.name for c in spec.CMDS]
    if len(set(names)) != len(names):
        out.append(Finding(ERROR, "QSM-SPEC-SIG", location,
                           f"duplicate command names in CMDS: {names}",
                           "command names must be unique"))
    for i, sig in enumerate(spec.CMDS):
        if sig.n_args < 1 or sig.n_resps < 1:
            out.append(Finding(
                ERROR, "QSM-SPEC-SIG", location,
                f"command {sig.name!r} (#{i}) has empty domain "
                f"(n_args={sig.n_args}, n_resps={sig.n_resps})",
                "n_args/n_resps must be >= 1 (1 means 'no argument')"))
    init = np.asarray(spec.initial_state())
    if init.shape != (spec.STATE_DIM,):
        out.append(Finding(
            ERROR, "QSM-SPEC-SIG", location,
            f"initial_state() shape {init.shape} != (STATE_DIM,) "
            f"= ({spec.STATE_DIM},)",
            "STATE_DIM and initial_state() must agree — the kernel "
            "pads carries to STATE_DIM"))
    elif init.dtype != np.int32:
        out.append(Finding(
            WARNING, "QSM-SPEC-SIG", location,
            f"initial_state() dtype {init.dtype} is not int32",
            "the device kernel runs int32 state vectors"))
    return out


def check_resp_domain(spec: Spec, location: str) -> List[Finding]:
    out: List[Finding] = []
    for c, sig in enumerate(spec.CMDS):
        dom = list(spec.resp_domain(c))
        bad = [r for r in dom if not 0 <= r < sig.n_resps]
        if bad:
            out.append(Finding(
                ERROR, "QSM-SPEC-RESP-DOMAIN", location,
                f"resp_domain({sig.name!r}) contains {bad[:4]} outside "
                f"[0, {sig.n_resps})",
                "pending-op expansion enumerates resp_domain; values "
                "outside n_resps break the expansion/table contract"))
        if not dom:
            out.append(Finding(
                ERROR, "QSM-SPEC-RESP-DOMAIN", location,
                f"resp_domain({sig.name!r}) is empty",
                "every command needs at least one completion response"))
    return out


def check_gen(spec: Spec, location: str, samples: int = 96,
              seed: int = 0) -> List[Finding]:
    """Sampled generator soundness ALONG A TRAJECTORY (the state
    advances through ok steps between draws — a generator that only
    misbehaves away from the initial state must not lint green):
    every (cmd, arg) stays in the declared domains (error), and the
    precondition holds for most draws (warning past 25% violations —
    ``Spec.gen_cmd``'s documented fallback may legitimately return a
    precondition-violating pair when rejection sampling exhausts its
    tries, so occasional misses are not a defect)."""
    rng = random.Random(seed)
    state = [int(x) for x in np.asarray(spec.initial_state())]
    bad_pre = 0
    for _ in range(samples):
        cmd, arg = spec.gen_cmd(rng, state)
        if not (0 <= cmd < spec.n_cmds
                and 0 <= arg < spec.CMDS[cmd].n_args):
            return [Finding(
                ERROR, "QSM-SPEC-GEN", location,
                f"gen_cmd produced ({cmd}, {arg}) outside the declared "
                f"command/arg domains at state {state}",
                "the device backend trusts generator args to be "
                "in-domain (the host contracts' domain check only gates "
                "replayed histories)")]
        if not spec.precondition(state, cmd, arg):
            bad_pre += 1
        # advance like the real runner would: take any ok step
        for resp in _resps_for(spec, cmd, state):
            ns, ok = spec.step_py(list(state), cmd, arg, resp)
            if ok:
                state = [int(x) for x in ns]
                break
    if bad_pre > samples // 4:
        return [Finding(
            WARNING, "QSM-SPEC-GEN", location,
            f"gen_cmd violated its own precondition on {bad_pre}/"
            f"{samples} sampled draws",
            "rejection sampling that falls back this often means the "
            "precondition is near-unsatisfiable or gen_cmd ignores it "
            "— generated programs would not mean what the spec says")]
    return []


def _walk(spec: Spec, n_ops: int, n_walks: int, seed: int):
    """Simulated ok-step trajectories (args in-domain, resps arbitrary).

    Returns (visited_states, bound_findings_args) where each trajectory
    takes at most ``n_ops`` ok steps from the initial state — matching
    the scalar_state_bound contract exactly (a bound may legitimately
    depend on the history length, e.g. the ticket dispenser's
    ``n_ops + 1``)."""
    rng = random.Random(seed)
    init = [int(x) for x in np.asarray(spec.initial_state())]
    visited = {tuple(init)}
    violations: List[Tuple[List[int], int, int, int, List[int]]] = []
    sbound = spec.scalar_state_bound(n_ops) if spec.STATE_DIM == 1 else None
    ebounds = spec.state_elem_bounds()

    def in_bounds(st: List[int]) -> bool:
        if sbound is not None and not 0 <= st[0] < sbound:
            return False
        if ebounds is not None and any(
                not 0 <= v < b for v, b in zip(st, ebounds)):
            return False
        return True

    for w in range(n_walks):
        state = list(init)
        for _ in range(n_ops):
            steps = []
            for cmd, arg in _pairs(spec, rng):
                for resp in _resps_for(spec, cmd, state):
                    ns, ok = spec.step_py(list(state), cmd, arg, resp)
                    if ok:
                        steps.append((cmd, arg, resp,
                                      [int(x) for x in ns]))
            if not steps:
                break
            cmd, arg, resp, ns = steps[rng.randrange(len(steps))]
            if not in_bounds(ns) and len(violations) < 4:
                violations.append((list(state), cmd, arg, resp, ns))
            state = ns
            visited.add(tuple(state))
    return visited, violations


def check_bounds_and_reach(spec: Spec, location: str,
                           n_ops: int = KERNEL_OPS_CEILING,
                           n_walks: int = 12, seed: int = 0
                           ) -> Tuple[List[Finding], set]:
    """(findings, visited_states) from simulated trajectories."""
    out: List[Finding] = []
    init = [int(x) for x in np.asarray(spec.initial_state())]
    sbound = spec.scalar_state_bound(n_ops) if spec.STATE_DIM == 1 else None
    ebounds = spec.state_elem_bounds()
    if ebounds is not None and len(ebounds) != spec.STATE_DIM:
        out.append(Finding(
            ERROR, "QSM-SPEC-BOUND", location,
            f"state_elem_bounds has {len(ebounds)} entries for "
            f"STATE_DIM={spec.STATE_DIM}",
            "one exclusive bound per state element"))
        ebounds = None
    if sbound is not None and not 0 <= init[0] < sbound:
        out.append(Finding(
            ERROR, "QSM-SPEC-BOUND", location,
            f"initial state {init[0]} outside declared scalar bound "
            f"[0, {sbound})", "the step-table gather would read garbage"))
    if ebounds is not None and any(
            not 0 <= v < b for v, b in zip(init, ebounds)):
        out.append(Finding(
            ERROR, "QSM-SPEC-BOUND", location,
            f"initial state {init} outside state_elem_bounds {ebounds}",
            "scalarized packing (ops/scalarize.py) requires in-bounds "
            "states"))

    visited, violations = _walk(spec, n_ops, n_walks, seed)
    for state, cmd, arg, resp, ns in violations:
        out.append(Finding(
            ERROR, "QSM-SPEC-BOUND", location,
            f"ok step {spec.CMDS[cmd].name}(arg={arg}, resp={resp}) "
            f"from {state} reaches {ns}, outside the declared bound "
            f"(scalar_state_bound({n_ops})="
            f"{sbound if sbound is not None else '-'}, "
            f"state_elem_bounds={ebounds})",
            "the device fast paths trust the bound: a reachable "
            "out-of-bound state makes the table gather/packing unsound"))

    # reachability: every command issuable and ok-respondable somewhere
    sample = list(visited)[:256]
    for c, sig in enumerate(spec.CMDS):
        issuable = respondable = False
        for st in sample:
            st = list(st)
            for a in range(min(sig.n_args, 32)):
                if spec.precondition(st, c, a):
                    issuable = True
                    for r in _resps_for(spec, c, st):
                        _, ok = spec.step_py(list(st), c, a, r)
                        if ok:
                            respondable = True
                            break
                if respondable:
                    break
            if respondable:
                break
        if not issuable:
            out.append(Finding(
                WARNING, "QSM-SPEC-REACH", location,
                f"command {sig.name!r} is never issuable (precondition "
                f"false at every sampled reachable state, "
                f"{len(sample)} states)",
                "dead commands silently shrink the tested alphabet"))
        elif not respondable:
            out.append(Finding(
                WARNING, "QSM-SPEC-REACH", location,
                f"command {sig.name!r} has no ok response at any "
                "sampled reachable state",
                "an un-satisfiable postcondition makes every history "
                "containing the command a violation"))
    return out, visited


def parity_grid(spec: Spec, n_ops: int = KERNEL_OPS_CEILING,
                visited: Optional[set] = None, seed: int = 0):
    """``(states, samples, exhaustive)``: the states the parity pass
    checks and its (state, cmd, arg, resp) tuples over them — every
    state of a tabulable scalar space, else a shuffled sample of the
    trajectory-reachable ones."""
    rng = random.Random(seed)
    sbound = spec.scalar_state_bound(n_ops) if spec.STATE_DIM == 1 else None
    if sbound is not None and sbound <= _MAX_PARITY_STATES:
        states = [[s] for s in range(sbound)]   # exhaustive
        exhaustive = True
    else:
        pool = sorted(visited or {tuple(
            int(x) for x in np.asarray(spec.initial_state()))})
        rng.shuffle(pool)
        states = [list(s) for s in pool[:_MAX_PARITY_STATES]]
        exhaustive = False

    samples: List[Tuple[List[int], int, int, int]] = []
    for st in states:
        for cmd, arg in _pairs(spec, rng):
            for resp in _resps_for(spec, cmd, st):
                samples.append((st, cmd, arg, resp))
    return states, samples, exhaustive


def step_torch_grid(spec: Spec, samples, device):
    """``step_torch`` over every sampled tuple in ONE call on ``device``:
    int32 ``[K, STATE_DIM]`` states (``[K]`` for a scalar spec) and
    ``[K]`` ops.  Returns host arrays ``(states [K, STATE_DIM], ok
    [K])``."""
    import torch

    def col(i):
        return torch.from_numpy(np.asarray(
            [s[i] for s in samples], np.int32)).to(device)

    st = torch.from_numpy(np.asarray([s for s, *_ in samples],
                                     np.int32)).to(device)
    if spec.STATE_DIM == 1:
        st = st[:, 0]
    ns, ok = spec.step_torch(st, col(1), col(2), col(3))
    ns = ns.cpu().numpy().reshape(len(samples), -1)
    return ns, ok.cpu().numpy().reshape(len(samples))


def check_parity(spec: Spec, location: str,
                 n_ops: int = KERNEL_OPS_CEILING,
                 visited: Optional[set] = None, seed: int = 0,
                 device="cpu", stats: Optional[dict] = None
                 ) -> List[Finding]:
    """``step_py`` vs ``step_torch`` — ONE batched evaluation on
    ``device`` over the sampled (state, cmd, arg, resp) grid, compared
    elementwise.  ``stats`` (optional) receives the grid's size."""
    states, samples, exhaustive = parity_grid(spec, n_ops, visited, seed)
    if stats is not None:
        stats.update(states=len(states), tuples=len(samples),
                     exhaustive=exhaustive)
    if not samples:
        return [Finding(INFO, "QSM-SPEC-PARITY", location,
                        "parity pass ran vacuously (no samples)", "")]

    dev_states, dev_oks = step_torch_grid(spec, samples, device)

    out: List[Finding] = []
    for i, (st, cmd, arg, resp) in enumerate(samples):
        py_ns, py_ok = spec.step_py(list(st), cmd, arg, resp)
        py_ns = [int(x) for x in py_ns]
        dv_ns = [int(x) for x in dev_states[i]]
        dv_ok = bool(dev_oks[i])
        if bool(py_ok) != dv_ok or (py_ok and py_ns != dv_ns):
            out.append(Finding(
                ERROR, "QSM-SPEC-PARITY", location,
                f"step_py/step_torch diverge on state={st} "
                f"{spec.CMDS[cmd].name}(arg={arg}, resp={resp}): "
                f"py -> ({py_ns}, ok={bool(py_ok)}), "
                f"torch -> ({dv_ns}, ok={dv_ok})",
                "the oracle checks step_py, the kernels' step tables "
                "come from step_torch — any divergence is a wrong "
                "device verdict"))
            if len(out) >= 4:
                break
    if not out and not exhaustive:
        out.append(Finding(
            INFO, "QSM-SPEC-PARITY", location,
            f"parity sampled ({len(samples)} tuples over "
            f"{len(states)} reachable states), not exhaustive", ""))
    return out


def check_projection(spec: Spec, location: str,
                     seed: int = 0) -> List[Finding]:
    """QSM-SPEC-PCOMP: validate a declared per-key projection.

    A spec that declares nothing is silent (whole-history checking is
    always sound); a spec that DECLARES decomposability — any
    ``CmdSig.proj``, or a ``projected_spec`` attribute — must pass the
    compile-time validator, because every P-compositional consumer
    (ops/pcomp.py, the planner's decompose_keys stage, the serve split
    plane) trusts exactly that report."""
    from ..core.spec import projection_report

    declares = (hasattr(spec, "projected_spec")
                or any(c.proj is not None for c in spec.CMDS))
    if not declares:
        return []
    problems = projection_report(spec, seed=seed)
    return [Finding(ERROR, "QSM-SPEC-PCOMP", location,
                    f"declared per-key projection is unsound: {p}",
                    "fix the KeyProj declaration/projected spec, or "
                    "remove it — the planner refuses to decompose "
                    "(never splits unsoundly), so the declaration only "
                    "misleads")
            for p in problems]


def check_spec(spec: Spec, location: str,
               n_ops: int = KERNEL_OPS_CEILING,
               seed: int = 0, device="cpu",
               stats: Optional[dict] = None) -> List[Finding]:
    """All spec soundness passes for one spec instance; the parity pass
    evaluates ``step_torch`` on ``device`` (``stats``: its grid size)."""
    out = check_sigs(spec, location)
    if any(f.severity == ERROR for f in out):
        return out  # later passes would crash on a malformed alphabet
    out += check_resp_domain(spec, location)
    out += check_gen(spec, location, seed=seed)
    bound_findings, visited = check_bounds_and_reach(
        spec, location, n_ops=n_ops, seed=seed)
    out += bound_findings
    out += check_parity(spec, location, n_ops=n_ops, visited=visited,
                        seed=seed, device=device, stats=stats)
    out += check_projection(spec, location, seed=seed)
    return out
