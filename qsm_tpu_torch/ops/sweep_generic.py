"""The sweep regime's generic route: any spec with a ``step_torch``.

The counterpart of the JAX package's ``build_stepper`` → ``run_one`` in
its sweep regime for a spec whose step is not code in
``csrc/stepper_sweep.cu``: one without a ``Spec.sweep_kernel`` kind, or
with a state wider than ``sweep_kernel.MAX_SWEEP_DIM`` words.  The
reference vmaps the spec's own ``step_jax`` inside ``run_one``
(``qsm_tpu/ops/jax_kernel.py:303-309``); here each DFS iteration of a
chunk is two steps on the card:

1. the spec's own ``step_torch`` of every op from each listed lane's
   current state (plain PyTorch on the lanes' ``[L, D]`` states, the
   spec's code: glue, as ``stepper_tables`` is), made contiguous as
   ``nxt`` int32 ``[L, N, D]`` and ``ok`` uint8 ``[L, N]``;
2. ``sweep_advance`` (``csrc/sweep_advance.cu``): the rest of the
   iteration, the candidate choice, the memo probe and insert, descend,
   prune or backtrack, the status and the counters, and each lane's next
   current state, written where step 1 reads it.

:func:`stepper_sweep_generic` runs a chunk of such iterations with the
signature of ``stepper_sweep``, which dispatches to it for a model whose
``route`` is "generic".  On the card a chunk reads nothing back to wait
on: the lane check is counted on the stream (``missing``), and the loop
ends early only once a count of the running lanes, copied to pinned host
memory behind an event (at trips 0, 1, 2, 4, ..., then every
``POLL_TRIPS``), has landed and reads 0: the event is polled, never
waited for, and the trips after every lane decided are no-ops, so where
the loop ends changes nothing.

``sweep_advance`` launches the CUDA kernel for CUDA tensors and takes
:func:`sweep_advance_plain`, one trip of ``stepper_sweep_plain`` after
its step, only for CPU tensors; it counts its launches
(``sweep_advance.launches``).  A failed build or launch raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dfs_kernel import RUNNING
from .stepper_kernel import (StepperCarry, _M32, _check_planes,
                             _unpack_bits, device_sms, n_words, sweep_dim)
from .sweep_kernel import (SweepModel, SweepTables, _check_lanes,
                           _check_missing, _check_sweep_args, _step_all,
                           _sweep_trip)

ADVANCE_WARPS = 8   # warps a block: csrc/sweep_advance.cu's MAX_WARPS
POLL_TRIPS = 64     # trips between two counts of the running lanes


class AdvancePlan(NamedTuple):
    warps_per_block: int
    grid: int


def advance_launch_plan(L: int, sms: int) -> AdvancePlan:
    """How ``csrc/sweep_advance.cu`` runs ``L`` lanes on a card of
    ``sms`` SMs: one warp a lane, no shared memory, at most
    ``ADVANCE_WARPS`` warps a block and as few as spread the lanes over
    every SM.  The C entry re-checks it."""
    wpb = max(1, min(ADVANCE_WARPS, -(-L // sms)))
    return AdvancePlan(wpb, -(-L // wpb))


def _check_step_planes(tables: SweepTables, carry: StepperCarry, lanes,
                       nxt, ok, state_out) -> None:
    """The lane list, the step planes and the next states' buffer against
    the carry (the carry and the tables are ``_check_sweep_args``'s)."""
    N, D = tables.cmd.shape[1], sweep_dim(carry)
    dev = carry.row.device
    L = lanes.shape[0] if lanes.dim() == 1 else -1
    _check_planes("sweep_advance", [("lanes", lanes), ("nxt", nxt),
                                    ("state_out", state_out)],
                  dict(lanes=(L,), nxt=(L, N, D), state_out=(L, D)), dev)
    if (ok.dtype != torch.uint8 or tuple(ok.shape) != (L, N)
            or ok.device != dev or not ok.is_contiguous()):
        raise ValueError(f"sweep_advance: ok must be contiguous uint8 "
                         f"{(L, N)} on {dev}, got {ok.dtype} "
                         f"{tuple(ok.shape)} on {ok.device}")


def sweep_advance(tables: SweepTables, carry: StepperCarry, lanes, nxt,
                  ok, *, budget: int, state_out) -> StepperCarry:
    """One DFS iteration of every listed RUNNING lane, given its step:
    ``lanes`` int32 ``[L]`` (distinct lanes of the carry, as
    :func:`stepper_sweep_generic` checks them), ``nxt`` int32 ``[L, N,
    D]`` and ``ok`` uint8 ``[L, N]`` each op's next state and
    postcondition from the lane's current state.  The carry is updated in
    place and returned; ``state_out`` (int32 ``[L, D]``) receives each
    lane's state after the iteration (a lane not RUNNING keeps what it
    holds).

    CUDA tensors go to the CUDA kernel (``sweep_advance.launches`` counts
    each launch); CPU tensors to :func:`sweep_advance_plain`.  A failed
    build or launch raises; there is no fallback."""
    _check_sweep_args(tables, carry)
    _check_step_planes(tables, carry, lanes, nxt, ok, state_out)
    return advance_unchecked(tables, carry, lanes, nxt, ok, budget, state_out)


def advance_unchecked(tables, carry, lanes, nxt, ok, budget, state_out):
    """:func:`sweep_advance` on arguments already checked: the generic
    loop checks them once a chunk, not every trip."""
    dev = carry.row.device
    if dev.type == "cpu":
        return _advance_plain(tables, carry, lanes, nxt, ok, budget,
                              state_out)
    if dev.type != "cuda":
        raise ValueError(f"sweep_advance runs on cuda or cpu, not {dev}")
    from .kernels import (KernelLaunchError, launch_device_index,
                          sweep_advance_lib)

    R, N = tables.cmd.shape
    B, slots = carry.row.shape[0], carry.occ.shape[1]
    L = lanes.shape[0]
    plan = advance_launch_plan(L, device_sms(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = sweep_advance_lib()
        rc = lib.set_launch_device(launch_device_index(dev))
        if rc == 0:
            rc = lib.sweep_advance_launch(
                tables.prec.data_ptr(), tables.valid.data_ptr(),
                tables.nreq.data_ptr(), carry.row.data_ptr(),
                lanes.data_ptr(), nxt.data_ptr(), ok.data_ptr(),
                *(t.data_ptr() for t in carry[:6]), state_out.data_ptr(),
                B, R, N, n_words(N), sweep_dim(carry), slots, budget, L,
                *plan, stream)
    if rc != 0:
        raise KernelLaunchError(
            f"sweep_advance launch failed: CUDA error {rc}")
    sweep_advance.launches += 1
    return carry


sweep_advance.launches = 0


def sweep_advance_plain(tables: SweepTables, carry: StepperCarry, lanes,
                        nxt, ok, *, budget: int, state_out) -> StepperCarry:
    """The same function as the CUDA kernel, in plain PyTorch: the listed
    lanes' planes gathered, one trip of ``stepper_sweep_plain``'s loop
    after its step (``_sweep_trip``), and the planes written back."""
    _check_sweep_args(tables, carry)
    _check_step_planes(tables, carry, lanes, nxt, ok, state_out)
    return _advance_plain(tables, carry, lanes, nxt, ok, budget, state_out)


def _advance_plain(tables, carry, lanes, nxt, ok, budget, state_out):
    N = tables.cmd.shape[1]
    dev = carry.row.device
    idx = lanes.long()
    pos = torch.arange(idx.shape[0], device=dev)
    row = carry.row[idx].long()
    prec_l = tables.prec[row].to(torch.int64) & _M32           # [L, W, N]
    valid_l = _unpack_bits(tables.valid[row], N)               # [L, N]
    dsi = tuple(carry.dsi[k, idx] for k in range(5))
    st = carry.states[idx]                                     # [L, N+1, D]
    state = st[pos, dsi[0].long()]                             # [L, D]
    tk, ch, st, out = _sweep_trip(
        pos, idx, nxt, ok != 0, state, carry.taken[:, idx].T == 1,
        carry.chosen[:, idx].T, st, dsi, carry.keys, carry.occ, valid_l,
        prec_l, tables.nreq[row], budget=budget)
    carry.taken[:, idx] = tk.T.to(torch.int32)
    carry.chosen[:, idx] = ch.T
    carry.states[idx] = st
    carry.dsi[:, idx] = torch.stack(out)
    act = (dsi[1] == RUNNING)[:, None]
    state_out.copy_(torch.where(act, st[pos, out[0].long()], state_out))
    return carry


def step_planes(spec, state: torch.Tensor, cmd, arg, resp):
    """``spec.step_torch`` of every op from each lane's state (``state``
    ``[L, D]``, ops ``[L, N]``) as the kernel reads it: ``nxt`` int32
    ``[L, N, D]`` and ``ok`` uint8 ``[L, N]``, contiguous (a spec may
    return broadcast views, int64 states or a bool ``ok``)."""
    L, N = cmd.shape
    nxt, ok = _step_all(spec, state, cmd, arg, resp)
    nxt = nxt.expand(L, N, state.shape[1]).to(torch.int32).contiguous()
    return nxt, ok.expand(L, N).to(torch.uint8).contiguous()


class _Drained:
    """Whether every listed lane has decided, learnt without waiting: a
    count of the RUNNING ones is copied into (pinned) host memory, and on
    the card an event is recorded after the copy; :meth:`poll` reads a
    count only once its event has passed, and starts the next one then.
    On the CPU the count is read at once."""

    def __init__(self, status: torch.Tensor, idx: torch.Tensor):
        self.status, self.idx = status, idx
        self.card = status.device.type == "cuda"
        self.host = torch.ones(1, dtype=torch.int32, pin_memory=self.card)
        self.seen = self.host.numpy()   # shares the host buffer
        self.event = None

    def poll(self) -> bool:
        if self.event is not None:
            if not self.event.query():
                return False            # the last count is on its way
            if self.seen[0] == 0:
                return True
        left = (self.status[self.idx] == RUNNING).sum(dtype=torch.int32)
        self.host.copy_(left.reshape(1), non_blocking=self.card)
        if not self.card:
            return self.seen[0] == 0
        self.event = torch.cuda.Event()
        self.event.record()
        return False


def stepper_sweep_generic(model: SweepModel, tables: SweepTables,
                          carry: StepperCarry, *, chunk: int, budget: int,
                          lanes=None, missing: torch.Tensor = None
                          ) -> StepperCarry:
    """Advance every RUNNING lane by at most ``chunk`` DFS iterations of
    the generic route (it stops earlier when it decides or its
    cumulative iterations reach ``budget``), stepping with
    ``model.spec.step_torch``.  The carry is updated in place and
    returned.  ``lanes`` and ``missing`` are ``stepper_sweep``'s: the
    carry lanes to run (every RUNNING lane among them, checked on the
    host, or with ``missing`` counted into it on the stream), and the
    result does not depend on them.

    Each trip steps the listed lanes' current states (gathered once a
    chunk, then kept by the kernel) and launches :func:`sweep_advance`;
    no trip reads the card back (module docstring)."""
    _check_sweep_args(tables, carry)
    _check_missing(carry, lanes, missing)
    dev = carry.row.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"stepper_sweep runs on cuda or cpu, not {dev}")
    idx = (_check_lanes(carry, lanes, missing) if lanes is not None
           else torch.arange(carry.row.shape[0], dtype=torch.int32,
                             device=dev))
    if not idx.shape[0]:
        return carry
    il = idx.long()
    row = carry.row[il].long()
    cmd, arg, resp = (t[row] for t in tables[:3])              # [L, N]
    state = carry.states[il, carry.dsi[0, il].long()]          # [L, D]
    drained = _Drained(carry.dsi[1], il)
    for it in range(chunk):
        # polled at trips 0, 1, 2, 4, ... and then every POLL_TRIPS: a
        # batch of short histories ends within a few trips of its last
        if (it & (it - 1) == 0 or it % POLL_TRIPS == 0) and drained.poll():
            break
        nxt, ok = step_planes(model.spec, state, cmd, arg, resp)
        if it == 0:
            # step_planes gives every trip the same shapes and types
            _check_step_planes(tables, carry, idx, nxt, ok, state)
        advance_unchecked(tables, carry, idx, nxt, ok, budget, state)
    return carry
