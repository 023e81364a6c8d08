"""``stepper_sweep``: the lane-compacting stepper's sweep regime.

The counterpart of the JAX package's ``build_stepper`` → ``run_one`` when
the spec has no state bound (``qsm_tpu/ops/jax_kernel.py:190-193``,
``:303-309``): a vector spec whose packed domain is too large for a step
table (a KV map of 16 keys: 4**16 states).  Every iteration evaluates
every op's ``(next_state, ok)`` from the lane's current state vector, and
the memo key is the taken words followed by all D state words.  Chunk,
budget, memo and status semantics are those of the table regime
(``ops/stepper_kernel.py``); a state is never out of bounds here.

Inputs, all int32:

    tables  cmd, arg, resp [R, N]   each history's ops (padding ops: 0)
            prec   [R, W, N]        packed predecessors (as the table regime)
            valid  [R, W]           packed: op exists
            nreq   [R]              ops to linearize
    carry   taken  [N, B], chosen [N+1, B], dsi [5, B], row [B]: as the
            table regime;
            states [B, N+1, D]      each lane's state stack, lane-major
            keys   [B, C, W+D]      memo keys: W taken words, D state words
            occ    [B, C]

On the card the model's step is code inside the kernel, chosen by a kind
and up to three integer parameters that the spec gives
(``Spec.sweep_kernel``): 1 queue, 2 kv and multireg, 3 stack, 4 multicas,
5 txn, 6 a random vector spec whose tables ride a device buffer.  The
kernel takes ``D <= MAX_SWEEP_DIM``: state word i lives in thread i of a
warp, and a memo key holds W + D <= 32 words, W <= 4.  Any other spec (no
kind, or a wider state) takes the regime's generic route
(``ops/sweep_generic.py``), as the reference vmaps any spec's
``step_jax``: each iteration evaluates the spec's own ``step_torch`` on
the card, then ``csrc/sweep_advance.cu`` does the rest of it.  The
model's ``route`` says which: "kernel" or "generic".

``stepper_sweep`` launches ``csrc/stepper_sweep.cu`` for CUDA tensors and
a kernel model, with the shape from :func:`sweep_launch_plan` (over every
lane, or over a list of lanes that holds every RUNNING one, spread evenly
over the SMs), and takes :func:`stepper_sweep_plain` only for CPU
tensors; a generic model goes to ``stepper_sweep_generic`` on either
device.  It counts the kernel's launches (``stepper_sweep.launches``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .dfs_kernel import (BUDGET, FAILURE, RUNNING, SMEM_BLOCK_MAX, SUCCESS,
                         _as_i32)
from .stepper_kernel import (MAX_OPS, MAX_WARPS_PER_BLOCK, StepperCarry, _M32,
                             _check_carry, _check_planes, _pack_np,
                             _unpack_bits, device_sms, hash_slot, key_words,
                             n_words, pack_words, sweep_dim)

# State word i lives in thread i of a warp and a memo key of W + D words
# stays within 32, W up to 4 (N <= 128): the kernel takes state vectors of
# up to 28 words.
MAX_SWEEP_DIM = 32 - n_words(MAX_OPS)


class SweepTables(NamedTuple):
    cmd: torch.Tensor
    arg: torch.Tensor
    resp: torch.Tensor
    prec: torch.Tensor
    valid: torch.Tensor
    nreq: torch.Tensor


class SweepModel(NamedTuple):
    """A spec and its step code on the card: ``kind`` (0 = none: the
    generic route), ``params`` (three ints), ``data`` (int32, at least
    one element; on the device for a kernel model, a host placeholder
    that nothing reads for the generic route)."""

    spec: object
    kind: int
    params: tuple
    data: torch.Tensor

    @property
    def route(self) -> str:
        """"kernel" (``csrc/stepper_sweep.cu`` steps the model) or
        "generic" (``spec.step_torch`` and ``csrc/sweep_advance.cu``)."""
        return "kernel" if self.kind else "generic"


def sweep_model(spec, device) -> SweepModel:
    """The spec's model for the sweep regime on ``device``: its kernel
    model when it has a kind (``Spec.sweep_kernel``) and a state of at
    most ``MAX_SWEEP_DIM`` words, else a model of the generic route (kind
    0), which runs any spec with a ``step_torch``."""
    device = torch.device(device)
    found = spec.sweep_kernel()
    if found is None or not 1 <= spec.STATE_DIM <= MAX_SWEEP_DIM:
        return SweepModel(spec, 0, (0, 0, 0),
                          torch.zeros(1, dtype=torch.int32))
    kind, params, data = found
    params = tuple(int(p) for p in params) + (0,) * (3 - len(params))
    data = np.zeros(1, np.int32) if data is None else np.asarray(data,
                                                                 np.int32)
    if kind == 6:
        # the kernel reads the bounds, then tables of their sizes
        D, car = spec.STATE_DIM, params[0] * params[1] * params[2]
        bounds = data[:D]
        if (car < 1 or len(bounds) != D or (bounds < 1).any()
                or data.size != D + (bounds[0] + bounds.sum()) * car):
            raise ValueError(f"{spec.name}: kind 6 data of {data.size} "
                             f"words does not hold its bounds and tables")
    return SweepModel(spec, int(kind), params,
                      torch.from_numpy(np.ascontiguousarray(data)).to(device))


def sweep_tables(cmd: np.ndarray, arg: np.ndarray, resp: np.ndarray,
                 valid: np.ndarray, prec: np.ndarray, device) -> SweepTables:
    """The read-only inputs for ``R`` histories of ``N`` (bucketed) ops:
    ``cmd``/``arg``/``resp`` int ``[R, N]``, ``valid`` bool ``[R, N]``,
    ``prec`` bool ``[R, N, N]`` (``prec[r, i, j]``: op i precedes op j)."""
    N = np.shape(cmd)[1]
    valid = np.asarray(valid, bool)
    host = [np.asarray(x, np.int32) for x in (cmd, arg, resp)]
    host += [_pack_np(np.asarray(prec, bool), N),
             _pack_np(valid[..., None], N)[..., 0],
             valid.sum(axis=1).astype(np.int32)]
    return SweepTables(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in host))


def fresh_sweep_carry(nreq: torch.Tensor, rows: np.ndarray,
                      init_states: np.ndarray, bucket: int, n_ops: int,
                      slots: int) -> StepperCarry:
    """The carry of searches not yet begun (``init_one``): lane ``i <
    len(rows)`` reads table row ``rows[i]`` and starts at depth 0 in the
    state vector ``init_states[i]``; lanes past them are padding,
    SUCCESS, row 0."""
    init = np.asarray(init_states, np.int32)
    N, B, D, dev = n_ops, bucket, init.shape[1], nreq.device
    m = len(rows)
    if m > B or len(init) != m or (
            m and not 0 <= min(rows) <= max(rows) < nreq.shape[0]):
        raise ValueError(f"fresh_sweep_carry: {m} rows and {len(init)} "
                         f"states in a bucket of {B} must index the "
                         f"{nreq.shape[0]} table rows")
    row = torch.zeros(B, dtype=torch.int32, device=dev)
    row[:m] = torch.from_numpy(np.asarray(rows, np.int32)).to(dev)
    states = torch.zeros((B, N + 1, D), dtype=torch.int32, device=dev)
    states[:m, 0] = torch.from_numpy(init).to(dev)
    dsi = torch.zeros((5, B), dtype=torch.int32, device=dev)
    dsi[1] = SUCCESS
    dsi[1, :m] = torch.where(nreq[row[:m].long()] == 0, SUCCESS,
                             RUNNING).to(torch.int32)
    return StepperCarry(
        torch.zeros((N, B), dtype=torch.int32, device=dev),
        torch.full((N + 1, B), -1, dtype=torch.int32, device=dev),
        states, dsi,
        torch.zeros((B, slots, key_words(N, D)), dtype=torch.int32,
                    device=dev),
        torch.zeros((B, slots), dtype=torch.int32, device=dev), row)


def _check_sweep_args(tables: SweepTables, carry: StepperCarry) -> None:
    R, N = tables.cmd.shape
    if not 1 <= N <= MAX_OPS:
        raise ValueError(f"stepper_sweep covers 1 <= N <= {MAX_OPS} ops; "
                         f"got N={N}")
    if not sweep_dim(carry):
        raise ValueError("stepper_sweep runs sweep-regime carries (states "
                         "[B, N+1, D])")
    dev = tables.cmd.device
    W = n_words(N)
    _check_planes("stepper_sweep", tables._asdict().items(), dict(
        cmd=(R, N), arg=(R, N), resp=(R, N), prec=(R, W, N), valid=(R, W),
        nreq=(R,)), dev)
    _check_carry("stepper_sweep", carry, N, dev)


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------

class SweepPlan(NamedTuple):
    warps_per_block: int
    grid: int
    smem_bytes: int     # dynamic shared memory per block


def sweep_warp_bytes(n_ops: int, state_dim: int, slots: int) -> int:
    """Shared bytes of one warp: its lane's ``[N+1, D]`` state stack and
    ``chosen`` stack and, with the memo, the hash of each level's
    configuration (N + 1 words) and one tag byte a slot (rounded up to a
    word)."""
    memo = n_ops + 1 + -(-slots // 4) if slots else 0
    return 4 * ((n_ops + 1) * (state_dim + 1) + memo)


def sweep_launch_plan(L: int, N: int, D: int, slots: int,
                      sms: int) -> SweepPlan:
    """How ``csrc/stepper_sweep.cu`` runs ``L`` lanes of ``N`` ops over a
    D-word state with ``slots`` memo slots a lane on a card of ``sms``
    SMs: one warp a lane, the lanes spread evenly over every SM.  Each SM
    takes ``ceil(L / sms)`` warps in as few blocks as the cap of a block
    allows (16 warps, and what shared memory holds), and the blocks are
    made equal, so that no SM is handed a block more than another.  The C
    entry re-checks it."""
    per_warp = sweep_warp_bytes(N, D, slots)
    cap = max(1, min(MAX_WARPS_PER_BLOCK, SMEM_BLOCK_MAX // per_warp))
    need = max(1, -(-L // sms))        # warps an SM
    wpb = -(-need // -(-need // cap))  # over ceil(need / cap) blocks
    return SweepPlan(wpb, -(-L // wpb), wpb * per_warp)


# ---------------------------------------------------------------------------
# stepper_sweep
# ---------------------------------------------------------------------------

def lanes_left_out(n: int) -> ValueError:
    """The refusal of a lane list that leaves out ``n`` RUNNING lanes."""
    return ValueError(f"stepper_sweep: the lane list leaves out {n} "
                      f"RUNNING lane(s)")


def _check_lanes(carry: StepperCarry, lanes,
                 missing: torch.Tensor = None) -> torch.Tensor:
    """``lanes`` as an int32 tensor on the carry's device, after checking
    on the host that they are distinct lanes of the carry, and that every
    RUNNING lane is among them: read here (one read of the status plane),
    or, with ``missing``, counted into it on the stream for the caller to
    read later."""
    B, dev = carry.row.shape[0], carry.row.device
    idx = torch.from_numpy(np.array(lanes, np.int64).reshape(-1))
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= B
                        or idx.unique().numel() != idx.numel()):
        raise ValueError(f"stepper_sweep: the lane list must hold distinct "
                         f"lanes of [0, {B})")
    # from pinned memory, not waiting for the stream (a blocking upload
    # would wait for every launch queued before it; so would ``left[idx]
    # = False``, which uploads its Python scalar)
    idx = (idx.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda"
           else idx.to(dev))
    left = (carry.dsi[1] == RUNNING).index_fill_(0, idx, False)
    if missing is not None:
        missing += left.sum(dtype=torch.int32)
    elif bool(left.any()):
        raise lanes_left_out(int(left.sum()))
    return idx.to(torch.int32)


def _check_missing(carry: StepperCarry, lanes, missing) -> None:
    if missing is not None and (
            lanes is None or missing.device != carry.row.device
            or missing.dtype != torch.int32 or missing.shape != (1,)):
        raise ValueError("stepper_sweep: missing must be int32 [1] on the "
                         "carry's device, beside a lane list")


def stepper_sweep(model: SweepModel, tables: SweepTables,
                  carry: StepperCarry, *, chunk: int, budget: int,
                  lanes=None, stats: torch.Tensor = None,
                  missing: torch.Tensor = None) -> StepperCarry:
    """Advance every RUNNING lane by at most ``chunk`` DFS iterations (it
    stops earlier when it decides or its cumulative iterations reach
    ``budget``).  The carry is updated in place and returned.

    ``lanes`` (optional) lists the carry lanes to run, every RUNNING lane
    among them (checked; a list that leaves one out raises): the kernel
    spreads exactly those over the SMs.  The result does not depend on it.
    ``missing`` (optional, int32 ``[1]`` on the carry's device, with
    ``lanes``) defers that check to the caller: the count of RUNNING lanes
    the list leaves out is added to it on the stream, and the launch goes
    ahead without a host read (``TorchStepper`` reads it with the round's
    status and raises :func:`lanes_left_out` there).
    ``stats`` (optional, int64 ``[2]`` on the card) gains the launch's
    memo probes and the probes whose filter tag matched.

    CUDA tensors go to the CUDA kernel (``stepper_sweep.launches`` counts
    each launch); CPU tensors to :func:`stepper_sweep_plain`.  A model of
    the generic route goes to ``sweep_generic.stepper_sweep_generic`` on
    either device (``stats`` is refused there: it counts no probes).  A
    failed build or launch raises; there is no fallback."""
    if model.route == "generic":
        if stats is not None:
            raise ValueError("stepper_sweep: the generic route counts no "
                             "memo probes (stats)")
        from .sweep_generic import stepper_sweep_generic

        return stepper_sweep_generic(model, tables, carry, chunk=chunk,
                                     budget=budget, lanes=lanes,
                                     missing=missing)
    _check_sweep_args(tables, carry)
    _check_missing(carry, lanes, missing)
    idx = (_check_lanes(carry, lanes, missing) if lanes is not None
           else None)
    dev = tables.cmd.device
    if dev.type == "cpu":
        return stepper_sweep_plain(model.spec, tables, carry, chunk=chunk,
                                   budget=budget)
    if dev.type != "cuda":
        raise ValueError(f"stepper_sweep runs on cuda or cpu, not {dev}")
    D = sweep_dim(carry)
    if not 1 <= model.kind <= 6 or D > MAX_SWEEP_DIM:
        raise ValueError(f"stepper_sweep: kind {model.kind} with D={D} is "
                         f"not a kernel model")
    if model.data.device != dev:
        raise ValueError(f"stepper_sweep: model data on {model.data.device}"
                         f", not {dev}")
    if stats is not None and (stats.device != dev or stats.dtype !=
                              torch.int64 or stats.shape != (2,)):
        raise ValueError("stepper_sweep: stats must be int64 [2] on the "
                         "carry's device")
    from .kernels import (KernelLaunchError, launch_device_index,
                          stepper_sweep_lib)

    R, N = tables.cmd.shape
    B, slots = carry.row.shape[0], carry.occ.shape[1]
    L = B if idx is None else idx.numel()
    plan = sweep_launch_plan(L, N, D, slots, device_sms(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = stepper_sweep_lib()
        rc = lib.set_launch_device(launch_device_index(dev))
        if rc == 0:
            rc = lib.stepper_sweep_launch(
                *(t.data_ptr() for t in tables), model.data.data_ptr(),
                carry.row.data_ptr(), *(t.data_ptr() for t in carry[:6]),
                None if idx is None else idx.data_ptr(),
                None if stats is None else stats.data_ptr(),
                B, R, N, n_words(N), D, slots, chunk, budget, model.kind,
                *model.params, L, *(int(x) for x in plan), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"stepper_sweep launch failed: CUDA error {rc}")
    stepper_sweep.launches += 1
    return carry


stepper_sweep.launches = 0


def _step_all(spec, state: torch.Tensor, cmd, arg, resp):
    """``spec.step_torch`` of every op from each lane's state: ``state``
    ``[B, D]``, ops ``[B, N]`` -> next states ``[B, N, D]``, ok ``[B, N]``
    (a scalar spec steps the state itself)."""
    if spec.STATE_DIM == 1:
        nxt, ok = spec.step_torch(state[:, :1], cmd, arg, resp)
        return nxt.expand(cmd.shape)[..., None], ok.expand(cmd.shape)
    nxt, ok = spec.step_torch(state[:, None, :], cmd, arg, resp)
    return nxt, ok


def stepper_sweep_plain(spec, tables: SweepTables, carry: StepperCarry, *,
                        chunk: int, budget: int,
                        early_exit: bool = True) -> StepperCarry:
    """The same function as the CUDA kernel, in plain PyTorch, vectorised
    over lanes: one loop trip per DFS iteration, the JAX package's
    ``run_one`` body in its sweep regime line for line, stepping with
    ``spec.step_torch``.  Updates the carry in place and returns it.
    ``early_exit=False`` drops the host sync that ends the loop once no
    lane runs (the trips after it are no-ops), so that the loop can be
    captured in a CUDA graph."""
    _check_sweep_args(tables, carry)
    cmd, arg, resp, prec, valid, nreq = tables
    N = cmd.shape[1]
    B = carry.row.shape[0]
    dev = cmd.device
    lane = torch.arange(B, device=dev)
    row = carry.row.long()
    c_l, a_l, r_l = cmd[row], arg[row], resp[row]              # [B, N]
    prec_l = prec[row].to(torch.int64) & _M32                  # [B, W, N]
    valid_l = _unpack_bits(valid[row], N)                      # [B, N]
    nreq_l = nreq[row]
    tk = carry.taken.T == 1                                    # [B, N]
    ch = carry.chosen.T.clone()                                # [B, N+1]
    st = carry.states.clone()                                  # [B, N+1, D]
    dsi = tuple(carry.dsi[k].clone() for k in range(5))
    for it in range(chunk):
        # checked every 64 trips: each check syncs
        if early_exit and it % 64 == 0 and not bool(
                (dsi[1] == RUNNING).any()):
            break
        state = st[lane, dsi[0].long()]                        # [B, D]
        nxt, ok = _step_all(spec, state, c_l, a_l, r_l)
        tk, ch, st, dsi = _sweep_trip(
            lane, lane, nxt, ok, state, tk, ch, st, dsi, carry.keys,
            carry.occ, valid_l, prec_l, nreq_l, budget=budget)
    carry.taken.copy_(tk.T.to(torch.int32))
    carry.chosen.copy_(ch.T)
    carry.states.copy_(st)
    carry.dsi.copy_(torch.stack(dsi))
    return carry


def _sweep_trip(pos, lane, nxt, ok, state, tk, ch, st, dsi, keys, occ,
                valid_l, prec_l, nreq_l, *, budget: int):
    """One trip of the sweep regime's loop after its step, over ``L``
    lanes at once: the ``run_one`` body past ``step_jax``.  The lanes'
    own planes are ``[L, ...]``, indexed by ``pos`` (``arange(L)``):
    ``nxt`` ``[L, N, D]`` and ``ok`` bool ``[L, N]`` the step of every op
    from ``state`` ``[L, D]``, ``tk`` bool ``[L, N]``, ``ch`` ``[L,
    N+1]``, ``st`` ``[L, N+1, D]``, ``dsi`` the five ``[L]`` rows, and the
    rows' ``valid_l`` / ``prec_l`` / ``nreq_l``; ``lane`` holds their
    carry lanes, which index the memo ``keys`` / ``occ`` (probed and
    written in place).  Returns the new ``(tk, ch, st, dsi)``."""
    N = tk.shape[1]
    use_cache = occ.shape[1] > 0
    slots = occ.shape[1]
    dev = tk.device
    i32, i64 = torch.int32, torch.int64
    iota = torch.arange(N, device=dev)
    kio = torch.arange(N + 1, device=dev)
    d, status, iters, prunes, inserts = dsi
    act = status == RUNNING
    dl = d.long()
    cur = ch[pos, dl]
    untaken = valid_l & ~tk
    uw = pack_words(untaken)                                   # [L, W]
    blocked = ((prec_l & uw[:, :, None]) != 0).any(1)          # [L, N]
    cand = untaken & ~blocked & ok & (iota > cur[:, None])
    has = cand.any(1)
    j = torch.where(cand, iota, N).amin(1)
    j = torch.where(has, j, torch.zeros_like(j))
    child = nxt[pos, j].to(i32)                                # [L, D]
    success = has & (d + 1 == nreq_l)
    tw = pack_words(tk)
    if use_cache:
        jbit = torch.zeros_like(tw).scatter_(
            1, (j >> 5)[:, None], (1 << (j & 31))[:, None])
        key_child = torch.cat([tw | jbit, child.to(i64) & _M32], dim=1)
        slot_c = hash_slot(key_child, slots)
        hit = ((occ[lane, slot_c] == 1)
               & ((keys[lane, slot_c].to(i64) & _M32)
                  == key_child).all(1))
        prune = has & hit & ~success
    else:
        prune = torch.zeros_like(has)
    descend = has & ~prune
    d_back = (d - 1).clamp(min=0)
    prev = ch[pos, d_back.long()].clamp(min=0)

    desc, pru, exh = act & descend, act & prune, act & ~has
    if use_cache:
        # exhausted: the current configuration is proven
        # non-linearizable-from
        key_cur = torch.cat([tw, state.to(i64) & _M32], dim=1)
        slot_cur = hash_slot(key_cur, slots)
        keys[lane, slot_cur] = torch.where(
            exh[:, None], _as_i32(key_cur), keys[lane, slot_cur])
        occ[lane, slot_cur] = torch.where(exh, 1, occ[lane, slot_cur])
    untake = exh & (d > 0) & (prev < N)
    tk = torch.where(desc[:, None] & (iota == j[:, None]), True, tk)
    tk = torch.where(untake[:, None] & (iota == prev[:, None]), False, tk)
    at_d = kio == dl[:, None]
    at_next = kio == dl[:, None] + 1     # never true past depth N
    ch = torch.where((desc | pru)[:, None] & at_d, j[:, None].to(i32), ch)
    ch = torch.where(desc[:, None] & at_next, -1, ch)
    st = torch.where((desc[:, None] & at_next)[:, :, None],
                     child[:, None, :], st)

    d_new = torch.where(descend, d + 1, torch.where(prune, d, d_back))
    iters_new = iters + 1
    s_new = torch.where(success, SUCCESS, torch.where(
        ~has & (d == 0), FAILURE, RUNNING))
    s_new = torch.where((s_new == RUNNING) & (iters_new >= budget),
                        BUDGET, s_new)
    d = torch.where(act, d_new, d).to(i32)
    iters = torch.where(act, iters_new, iters).to(i32)
    status = torch.where(act, s_new, status).to(i32)
    prunes = prunes + pru.to(i32)
    if use_cache:
        inserts = inserts + exh.to(i32)
    return tk, ch, st, (d, status, iters, prunes, inserts)
