"""``dfs_chunk``: advance every lane's Wing–Gong DFS by ``chunk`` iterations.

The counterpart of ``qsm_tpu/ops/pallas_kernel.py::build_pallas_chunk``.
Its arrays keep that kernel's lane-minor layout, all int32:

    tables  nxt, ok [S, N, B]   per-lane step table (next state, postcondition)
            prec    [N, B]      packed predecessor word of op j (bit i: i
                                must be linearized before j)
            valid   [N, B]      0/1 op exists
            nreq    [1, B]      ops to linearize (0 = padding lane)
    carry   taken   [N, B]      0/1 op linearized on the current path
            chosen  [N+1, B]    op chosen at each depth (-1 = none yet);
                                doubles as the sibling cursor
            states  [N+1, B]    model state at each depth
            dsi     [3, B]      depth, status, iterations
            ck0, ck1, occ [CS, B]  per-lane memo: taken word, state,
                                occupancy (CS = max(cache_slots, 1))

with N <= 32 (one-word bitmasks) and S <= 64.  ``dfs_chunk`` launches the
hand-written CUDA kernel (``csrc/dfs_chunk.cu``) for CUDA tensors, with the
shape of the launch from :func:`launch_plan`, and takes the plain PyTorch
version ``dfs_chunk_plain`` only for CPU tensors.  Both return a new carry;
the inputs are left as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

RUNNING = 0
SUCCESS = 1  # == Verdict.LINEARIZABLE
FAILURE = 2
BUDGET = 3

MAX_OPS = 32     # one-word taken / predecessor bitmasks
MAX_STATES = 64  # packed postcondition rows per lane

_M32 = 0xFFFFFFFF

# The kernel's launch shape on an H100 (sm_90a).
LANES_PER_BLOCK = 32        # one warp per block, one thread per lane
SMEM_BLOCK_MAX = 232_448    # dynamic shared bytes a block may opt in to
SMEM_SM = 233_472           # shared bytes of one SM
SMEM_BLOCK_RESERVED = 1_024  # shared bytes the runtime keeps per block
BLOCKS_SM_MAX = 32          # resident blocks per SM
NXT_STAGE_CAP = 32 * 1024   # nxt is staged in shared memory up to this
#                             many bytes a block (S*N rows of 128 B; the
#                             headline's S=5, N=32 is 20,480), else read
#                             from global memory, so that S=64 tables do
#                             not cost the memo its room or the SM its
#                             resident blocks

MEMO_OFF, MEMO_SHARED, MEMO_GLOBAL = 0, 1, 2  # where the memo lives


class LaunchPlan(NamedTuple):
    lanes_per_block: int
    grid: int
    stage_nxt: bool    # nxt table in shared memory (else global)
    memo: int          # MEMO_OFF, MEMO_SHARED or MEMO_GLOBAL
    smem_bytes: int    # dynamic shared memory per block


def launch_plan(B: int, N: int, S: int, cache_slots: int) -> LaunchPlan:
    """How ``csrc/dfs_chunk.cu`` runs ``B`` lanes of ``N`` ops and ``S``
    states: one warp per block; each lane's stacks, packed ok words,
    successor words and (when they fit) memo and ``nxt`` table in shared
    memory, one 32-bit word a lane per row (lane-minor).  The C entry
    re-checks the same sum and refuses a plan it cannot launch."""
    cs = max(cache_slots, 1)
    rows = 2 * (N + 1) + S + N          # chosen, states, okw, succ
    row_bytes = 4 * LANES_PER_BLOCK
    memo = MEMO_OFF
    if cache_slots > 0:
        memo_rows = 2 * cs + -(-cs // 32)  # ck0, ck1, occupancy bits
        if (rows + memo_rows) * row_bytes <= SMEM_BLOCK_MAX:
            memo, rows = MEMO_SHARED, rows + memo_rows
        else:
            memo = MEMO_GLOBAL
    nxt_bytes = S * N * row_bytes
    stage_nxt = (nxt_bytes <= NXT_STAGE_CAP
                 and rows * row_bytes + nxt_bytes <= SMEM_BLOCK_MAX)
    if stage_nxt:
        rows += S * N
    return LaunchPlan(LANES_PER_BLOCK, -(-B // LANES_PER_BLOCK), stage_nxt,
                      memo, rows * row_bytes)


def blocks_per_sm(plan: LaunchPlan) -> int:
    """Blocks of ``plan`` one SM holds at once, by shared memory."""
    return min(BLOCKS_SM_MAX,
               SMEM_SM // (plan.smem_bytes + SMEM_BLOCK_RESERVED))


class Carry(NamedTuple):
    taken: torch.Tensor
    chosen: torch.Tensor
    states: torch.Tensor
    dsi: torch.Tensor
    ck0: torch.Tensor
    ck1: torch.Tensor
    occ: torch.Tensor


class Tables(NamedTuple):
    nxt: torch.Tensor
    ok: torch.Tensor
    prec: torch.Tensor
    valid: torch.Tensor
    nreq: torch.Tensor


def _check_args(tables: Tables, carry: Carry, cache_slots: int) -> None:
    S, N, B = tables.nxt.shape
    if not 1 <= N <= MAX_OPS or not 1 <= S <= MAX_STATES:
        raise ValueError(f"dfs_chunk covers N <= {MAX_OPS} ops and S <= "
                         f"{MAX_STATES} states; got N={N}, S={S}")
    if cache_slots < 0 or cache_slots & (cache_slots - 1):
        raise ValueError(
            f"cache_slots must be 0 or a power of two, got {cache_slots}")
    cs = max(cache_slots, 1)
    want = dict(nxt=(S, N, B), ok=(S, N, B), prec=(N, B), valid=(N, B),
                nreq=(1, B), taken=(N, B), chosen=(N + 1, B),
                states=(N + 1, B), dsi=(3, B), ck0=(cs, B), ck1=(cs, B),
                occ=(cs, B))
    dev = tables.nxt.device
    for name, t in [*tables._asdict().items(), *carry._asdict().items()]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"dfs_chunk: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.dtype != torch.int32:
            raise TypeError(f"dfs_chunk: {name} is {t.dtype}, not int32")
        if t.device != dev:
            raise ValueError(f"dfs_chunk: {name} is on {t.device}, "
                             f"tables on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"dfs_chunk: {name} is not contiguous")


def dfs_chunk(tables: Tables, carry: Carry, *, chunk: int, budget: int,
              cache_slots: int) -> Carry:
    """One chunk of ``chunk`` DFS iterations for every lane.

    CUDA tensors go to the CUDA kernel (``dfs_chunk.launches`` counts each
    launch); CPU tensors to :func:`dfs_chunk_plain`.  A failed build or
    launch raises; there is no fallback."""
    _check_args(tables, carry, cache_slots)
    dev = tables.nxt.device
    if dev.type == "cpu":
        return dfs_chunk_plain(tables, carry, chunk=chunk, budget=budget,
                               cache_slots=cache_slots)
    if dev.type != "cuda":
        raise ValueError(f"dfs_chunk runs on cuda or cpu, not {dev}")
    from .kernels import KernelLaunchError, dfs_chunk_lib

    S, N, B = tables.nxt.shape
    plan = launch_plan(B, N, S, cache_slots)
    out = Carry(*(torch.empty_like(t) for t in carry))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = dfs_chunk_lib().dfs_chunk_launch(
            *(t.data_ptr() for t in tables), *(t.data_ptr() for t in carry),
            *(t.data_ptr() for t in out),
            B, N, S, carry.ck0.shape[0], cache_slots, chunk, budget,
            *(int(x) for x in plan), stream)
    if rc != 0:
        raise KernelLaunchError(f"dfs_chunk launch failed: CUDA error {rc}")
    dfs_chunk.launches += 1
    return out


dfs_chunk.launches = 0


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32), without ever
    leaving the int64 range (16-bit halves)."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def slot_hash(word: torch.Tensor, state: torch.Tensor,
              cache_slots: int) -> torch.Tensor:
    """The kernel's memo slot mixer over the (taken-word, state) key, in
    unsigned 32-bit arithmetic carried in int64."""
    h = (word & _M32) ^ 0x9E3779B9
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 16)
    h = h ^ (state.to(torch.int64) & _M32)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 13)
    return h & (cache_slots - 1)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """An unsigned 32-bit value held in int64, as the int32 with the same
    bit pattern."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _row(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane[idx[b], b] where 0 <= idx < rows, else 0 (the one-hot
    selection of the Pallas kernel)."""
    rows = plane.shape[0]
    inside = (idx >= 0) & (idx < rows)
    got = plane.gather(0, idx.clamp(0, rows - 1).long()[None])[0]
    return torch.where(inside, got, torch.zeros_like(got))


def dfs_chunk_plain(tables: Tables, carry: Carry, *, chunk: int,
                    budget: int, cache_slots: int) -> Carry:
    """The same function as the CUDA kernel, in plain PyTorch, vectorised
    over lanes: one loop trip per DFS iteration.  Bit-identical to the
    kernel and to ``build_pallas_chunk``."""
    _check_args(tables, carry, cache_slots)
    nxt, ok, prec, valid, nreq = tables
    S, N, B = nxt.shape
    dev = nxt.device
    use_cache = cache_slots > 0
    i32, i64 = torch.int32, torch.int64
    shift = torch.arange(N, device=dev, dtype=i64)[:, None]
    nio = torch.arange(N, device=dev, dtype=i32)[:, None]
    kio = torch.arange(N + 1, device=dev, dtype=i32)[:, None]
    cio = torch.arange(max(cache_slots, 1), device=dev, dtype=i64)[:, None]
    prec_w = prec.to(i64) & _M32
    n_req = nreq[0]
    zero = torch.zeros((), dtype=i32, device=dev)

    taken, chosen, states = (carry.taken.clone(), carry.chosen.clone(),
                             carry.states.clone())
    d, status, iters = (carry.dsi[k].clone() for k in range(3))
    ck0, ck1, occ = carry.ck0.clone(), carry.ck1.clone(), carry.occ.clone()

    for it in range(chunk):
        # decided lanes do nothing, so once none runs the rest of the
        # chunk is a no-op (checked every 64 trips: each check syncs)
        if it % 64 == 0 and not bool((status == RUNNING).any()):
            break
        active = status == RUNNING
        state = _row(states, d)
        cur = _row(chosen, d)
        untaken = valid * (1 - taken)                       # [N, B]
        uw = (untaken.to(i64) << shift).sum(0)              # [B]
        blocked = (prec_w & uw) != 0
        ok_row = _row(ok.reshape(S, N * B),
                      state.repeat(N)).reshape(N, B)
        nxt_row = _row(nxt.reshape(S, N * B),
                       state.repeat(N)).reshape(N, B)
        cand = (untaken == 1) & ~blocked & (ok_row == 1) & (nio > cur)
        has = cand.any(0)
        jstar = torch.where(cand, nio, N).amin(0).to(i32)
        child = _row(nxt_row, jstar)
        success = has & (d + 1 == n_req)

        if use_cache:
            taken_word = (taken.to(i64) << shift).sum(0) & _M32
            child_word = taken_word | (
                1 << jstar.clamp(max=N - 1).to(i64))
            slot_c = slot_hash(child_word, child, cache_slots)[None]
            hit = ((occ.gather(0, slot_c)[0] == 1)
                   & (ck0.gather(0, slot_c)[0] == _as_i32(child_word))
                   & (ck1.gather(0, slot_c)[0] == child))
            prune = has & hit & ~success & active
        else:
            prune = torch.zeros_like(has)
        descend = has & active & ~prune
        d_back = (d - 1).clamp(min=0)
        prev = _row(chosen, d_back).clamp(min=0)
        back = active & ~has & (d > 0)

        jm = (nio == jstar).to(i32)
        taken = torch.where(
            descend, torch.maximum(taken, jm),
            torch.where(back & (nio == prev), zero, taken))
        # descend: chosen[d] = j, chosen[d+1] = -1; prune: the cursor
        # moves past j at the same depth
        chosen = torch.where(
            (descend | prune) & (kio == d), jstar,
            torch.where(descend & (kio == d + 1), zero - 1, chosen))
        states = torch.where(descend & (kio == d + 1), child, states)
        d_n = torch.where(descend, d + 1,
                          torch.where(active & ~prune, d_back, d))
        iters = iters + active.to(i32)
        status_n = torch.where(
            active & success, SUCCESS,
            torch.where(active & ~has & (d == 0), FAILURE, status))
        status = torch.where((status_n == RUNNING) & (iters >= budget),
                             BUDGET, status_n).to(i32)
        if use_cache:
            # exhausted: proven non-linearizable-from, insert
            exhausted = active & ~has
            wmask = (cio == slot_hash(taken_word, state, cache_slots)) \
                & exhausted
            ck0 = torch.where(wmask, _as_i32(taken_word), ck0)
            ck1 = torch.where(wmask, state, ck1)
            occ = torch.where(wmask, zero + 1, occ)
        d = d_n.to(i32)

    return Carry(taken, chosen, states, torch.stack([d, status, iters]),
                 ck0, ck1, occ)
