"""``stepper_chunk`` and ``compact_carry``: the lane-compacting stepper's
two kernels.

The counterparts of the JAX package's ``build_stepper`` (``run_one`` with a
static chunk, in its table regime) and ``JaxTPU._compact_fn`` in
``qsm_tpu/ops/jax_kernel.py``.  One lane is one history's resumable
Wing–Gong DFS.  The tables are read-only.  The step table is shared by the
whole device batch: a step depends only on the state and the op's
``(cmd, arg, resp)``, so it is built once over the batch's vocabulary of
distinct triples, and each op carries its index into that vocabulary.  The
per-history tables stay at the rows they were built at; a lane reads them
through its ``row`` (so a compaction never moves a table).  All arrays
int32:

    tables  vocab  [R, N]      vocabulary index of op j (padding ops: 0)
            vnxt   [S, V]      next state of vocabulary entry v from state s
            vok    [S, VW]     packed postconditions (bit v%32 of word v//32)
            prec   [R, W, N]   packed predecessors of op j (bit i%32 of word
                               i//32: op i must be linearized before op j)
            valid  [R, W]      packed: op exists
            nreq   [R]         ops to linearize
    carry   taken  [N, B]      0/1 op linearized on the current path
            chosen [N+1, B]    op chosen at each depth (-1 = none yet);
                               doubles as the sibling cursor
            states [N+1, B]    model state at each depth
            dsi    [5, B]      depth, status, iterations, memo prunes,
                               memo inserts
            keys   [B, C, W+1] per-lane memo keys: W taken words, then the
                               state's bits (C = slots, a power of two or 0)
            occ    [B, C]      1 = slot occupied
            row    [B]         the lane's table row

with ``W = ceil(N / 32)``, N <= 128 and ``VW = ceil(V / 32)``.  So op j of
row r steps from state s to ``vnxt[s, vocab[r, j]]``: the JAX package's
per-row ``[S, N]`` table is ``vnxt[:, vocab[r]]``.  The stacks are
lane-minor (row k of a plane is ``plane[k]``), the memo lane-major (one
lane's slot is one contiguous key).  A carry made by
:func:`fresh_stepper_carry`, :func:`compact_carry` or :func:`stepper_chunk`
keeps ``0 <= depth <= N``, ``taken`` in {0, 1} and every ``row`` inside the
tables (the kernel reads them unchecked).

``stepper_chunk`` launches ``csrc/stepper_chunk.cu`` for CUDA tensors, with
the shape of the launch from :func:`stepper_launch_plan`, and takes
:func:`stepper_chunk_plain` only for CPU tensors; likewise
``compact_carry`` (``csrc/compact_carry.cu``, :func:`compact_carry_plain`).
Each CUDA wrapper counts its launches (``.launches``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .dfs_kernel import (BLOCKS_SM_MAX, BUDGET, FAILURE, RUNNING,
                         SMEM_BLOCK_MAX, SMEM_BLOCK_RESERVED, SMEM_SM,
                         SUCCESS, _as_i32, _mul32)

MAX_OPS = 128   # four-word bitmasks
D, STATUS, ITERS, PRUNES, INSERTS = range(5)   # rows of ``dsi``

_M32 = 0xFFFFFFFF
_HASH_SEED = 0x9E3779B9

# The stepper kernel's launch shape on an H100 (sm_90a): one warp a lane,
# up to MAX_WARPS_PER_BLOCK warps a block sharing one staged table.
MAX_WARPS_PER_BLOCK = 16    # the kernel's __launch_bounds__ is 512 threads
WARPS_SM_MAX = 64           # resident warps per SM (2048 threads)


def n_words(n_ops: int) -> int:
    return (n_ops + 31) // 32


def key_words(n_ops: int, state_dim: int = 1) -> int:
    """Memo key width: the packed taken words, then the state's words
    (one in the table regime, ``STATE_DIM`` in the sweep regime)."""
    return n_words(n_ops) + state_dim


def sweep_dim(carry) -> int:
    """0 for a table-regime carry (``states [N+1, B]``), else the state
    width D of a sweep-regime carry (``states [B, N+1, D]``)."""
    return carry.states.shape[2] if carry.states.dim() == 3 else 0


class StepperTables(NamedTuple):
    vocab: torch.Tensor
    vnxt: torch.Tensor
    vok: torch.Tensor
    prec: torch.Tensor
    valid: torch.Tensor
    nreq: torch.Tensor


class StepperCarry(NamedTuple):
    taken: torch.Tensor
    chosen: torch.Tensor
    states: torch.Tensor
    dsi: torch.Tensor
    keys: torch.Tensor
    occ: torch.Tensor
    row: torch.Tensor


# ---------------------------------------------------------------------------
# Hash, packing, tables, fresh carries
# ---------------------------------------------------------------------------

def hash_slot(key: torch.Tensor, slots: int) -> torch.Tensor:
    """The memo's slot of each key (int64 ``[..., kw]``, words in [0,
    2**32)): the JAX package's ``make_hash_slot`` mixer (seed
    0x9E3779B9, per word xor, multiply, xor-shift 16, multiply, xor-shift
    13), in unsigned 32-bit arithmetic carried in int64."""
    h = torch.full(key.shape[:-1], _HASH_SEED, dtype=torch.int64,
                   device=key.device)
    for i in range(key.shape[-1]):
        h = h ^ (key[..., i] & _M32)
        h = _mul32(h, 0x85EBCA6B)
        h = h ^ (h >> 16)
        h = _mul32(h, 0xC2B2AE35)
        h = h ^ (h >> 13)
    return h & (slots - 1)


def hash_slots_np(keys: np.ndarray, slots: int) -> np.ndarray:
    """Numpy mirror of :func:`hash_slot` over rows of ``keys`` (uint32
    ``[M, kw]`` -> int32 ``[M]``)."""
    keys = np.asarray(keys, np.uint32)
    h = np.full(keys.shape[0], _HASH_SEED, np.uint32)
    for i in range(keys.shape[1]):
        h = h ^ keys[:, i]
        h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
        h = h ^ (h >> np.uint32(13))
    return (h & np.uint32(slots - 1)).astype(np.int32)


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool ``[..., N]`` -> int64 ``[..., W]`` words in [0, 2**32): bit
    j%32 of word j//32 (the JAX package's ``_pack_bool`` layout)."""
    n = bits.shape[-1]
    w = n_words(n)
    pad = torch.zeros((*bits.shape[:-1], w * 32 - n), dtype=torch.bool,
                      device=bits.device)
    full = torch.cat([bits.to(torch.bool), pad], dim=-1)
    shift = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (full.reshape(*bits.shape[:-1], w, 32).to(torch.int64)
            << shift).sum(-1)


def _pack_np(bits: np.ndarray, axis_len: int) -> np.ndarray:
    """bool ``[..., N, X]`` -> int32 ``[..., W, X]`` packed along the N
    axis (bit i%32 of word i//32)."""
    w = n_words(axis_len)
    b = np.moveaxis(np.asarray(bits, bool), -2, -1)           # [..., X, N]
    if w * 32 != axis_len:
        b = np.concatenate([b, np.zeros((*b.shape[:-1], w * 32 - axis_len),
                                        bool)], axis=-1)
    words = np.ascontiguousarray(
        np.packbits(b, axis=-1, bitorder="little")).view("<u4")
    return np.ascontiguousarray(np.moveaxis(words, -1, -2)).view(np.int32)


def op_vocabulary(cmd: np.ndarray, arg: np.ndarray, resp: np.ndarray,
                  valid: np.ndarray):
    """The batch's distinct ``(cmd, arg, resp)`` triples over its valid
    ops (int32 ``[V, 3]``, sorted, at least one) and each op's index into
    them (int32 ``[R, N]``; padding ops get 0).  Each triple becomes one
    int64 key, offset by the columns' minima, in mixed radix of their
    spans; a batch whose key space does not fit 63 bits is refused."""
    ops = np.stack([np.asarray(x, np.int64) for x in (cmd, arg, resp)], -1)
    valid = np.asarray(valid, bool)
    vocab = np.zeros(valid.shape, np.int32)
    trip = ops[valid]
    if not len(trip):
        return np.zeros((1, 3), np.int32), vocab
    lo = trip.min(0)
    span = [int(x) for x in trip.max(0) - lo + 1]
    if span[0] * span[1] * span[2] >= 1 << 63:
        raise ValueError(f"op_vocabulary: (cmd, arg, resp) spans {span} "
                         f"make more than 2**63 keys")
    t = trip - lo
    keys, inv = np.unique((t[:, 0] * span[1] + t[:, 1]) * span[2] + t[:, 2],
                          return_inverse=True)
    uniq = np.stack([keys // (span[1] * span[2]), keys // span[2] % span[1],
                     keys % span[2]], -1) + lo
    vocab[valid] = inv.reshape(-1)
    return uniq.astype(np.int32), vocab


def stepper_tables(spec, cmd: np.ndarray, arg: np.ndarray, resp: np.ndarray,
                   valid: np.ndarray, prec: np.ndarray, device
                   ) -> StepperTables:
    """The read-only inputs for ``R`` histories of ``N`` (bucketed) ops:
    ``cmd``/``arg``/``resp`` int ``[R, N]``, ``valid`` bool ``[R, N]``,
    ``prec`` bool ``[R, N, N]`` (``prec[r, i, j]``: op i precedes op j).
    The step table is one ``step_torch`` call of the scalar spec over
    every state and the batch's op vocabulary (:func:`op_vocabulary`),
    built on ``device``."""
    R, N = np.shape(cmd)
    S = spec.scalar_state_bound(N)
    uniq, vocab = op_vocabulary(cmd, arg, resp, valid)
    st = torch.arange(S, dtype=torch.int32, device=device)[:, None]
    c, a, r = (torch.from_numpy(np.ascontiguousarray(uniq[:, k]))
               .to(device)[None, :] for k in range(3))
    vnxt, ok = spec.step_torch(st, c, a, r)                    # [S, V]
    prec_w = _pack_np(np.asarray(prec, bool), N)              # [R, W, N]
    valid_w = _pack_np(np.asarray(valid, bool)[..., None], N)[..., 0]
    nreq = np.asarray(valid, bool).sum(axis=1).astype(np.int32)
    return StepperTables(
        torch.from_numpy(vocab).to(device), vnxt.to(torch.int32).contiguous(),
        _as_i32(pack_words(ok)).contiguous(), *(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (prec_w, valid_w, nreq)))


def fresh_stepper_carry(nreq: torch.Tensor, rows: np.ndarray,
                        init_states: np.ndarray, bucket: int, n_ops: int,
                        slots: int) -> StepperCarry:
    """The carry of searches not yet begun (the JAX package's
    ``init_one``): lane ``i < len(rows)`` reads table row ``rows[i]`` and
    starts at depth 0 in ``init_states[i]``, SUCCESS at once when its
    history is empty; lanes past them are padding, SUCCESS, row 0."""
    N, B, dev = n_ops, bucket, nreq.device
    m = len(rows)
    if m > B or (m and not 0 <= min(rows) <= max(rows) < nreq.shape[0]):
        raise ValueError(f"fresh_stepper_carry: {m} rows in a bucket of {B}"
                         f" must index the {nreq.shape[0]} table rows")
    row = torch.zeros(B, dtype=torch.int32, device=dev)
    row[:m] = torch.from_numpy(np.asarray(rows, np.int32)).to(dev)
    states = torch.zeros((N + 1, B), dtype=torch.int32, device=dev)
    states[0, :m] = torch.from_numpy(
        np.asarray(init_states, np.int32)).to(dev)
    dsi = torch.zeros((5, B), dtype=torch.int32, device=dev)
    dsi[STATUS] = SUCCESS
    dsi[STATUS, :m] = torch.where(nreq[row[:m].long()] == 0, SUCCESS,
                                  RUNNING).to(torch.int32)
    kw = key_words(N)
    return StepperCarry(
        torch.zeros((N, B), dtype=torch.int32, device=dev),
        torch.full((N + 1, B), -1, dtype=torch.int32, device=dev),
        states, dsi,
        torch.zeros((B, slots, kw), dtype=torch.int32, device=dev),
        torch.zeros((B, slots), dtype=torch.int32, device=dev), row)


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------

def _check_planes(what: str, planes: Sequence, want: dict, dev) -> None:
    for name, t in planes:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} is {t.dtype}, not int32")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _check_carry(what: str, carry: StepperCarry, n_ops: int, dev) -> None:
    """The carry's planes: the table regime's ``states [N+1, B]`` and
    keys of ``W + 1`` words, or the sweep regime's ``states [B, N+1, D]``
    and keys of ``W + D`` words."""
    N, B = n_ops, carry.row.shape[0]
    slots = carry.occ.shape[1] if carry.occ.dim() == 2 else -1
    if slots < 0 or slots & (slots - 1):
        raise ValueError(f"{what}: memo slots must be 0 or a power of two, "
                         f"got {slots}")
    sd = sweep_dim(carry)
    _check_planes(what, carry._asdict().items(), dict(
        taken=(N, B), chosen=(N + 1, B),
        states=(B, N + 1, sd) if sd else (N + 1, B), dsi=(5, B),
        keys=(B, slots, key_words(N, max(sd, 1))), occ=(B, slots),
        row=(B,)), dev)


def _check_chunk_args(tables: StepperTables, carry: StepperCarry) -> None:
    R, N = tables.vocab.shape
    S, V = tables.vnxt.shape
    if not 1 <= N <= MAX_OPS or S < 1 or V < 1:
        raise ValueError(f"stepper_chunk covers 1 <= N <= {MAX_OPS} ops; "
                         f"got N={N}, S={S}, V={V}")
    W = n_words(N)
    dev = tables.vocab.device
    _check_planes("stepper_chunk", tables._asdict().items(), dict(
        vocab=(R, N), vnxt=(S, V), vok=(S, n_words(V)), prec=(R, W, N),
        valid=(R, W), nreq=(R,)), dev)
    _check_carry("stepper_chunk", carry, N, dev)


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------

class StepperPlan(NamedTuple):
    warps_per_block: int
    grid: int
    stage_tables: bool  # vnxt/vok in shared memory (else device memory)
    smem_bytes: int     # dynamic shared memory per block


def table_bytes(n_states: int, vocab_size: int) -> int:
    """Bytes of the shared step table: ``vnxt`` and the packed ``vok``."""
    return 4 * n_states * (vocab_size + n_words(vocab_size))


def warp_stack_bytes(n_ops: int) -> int:
    """Shared bytes of one warp's ``chosen`` and ``states`` stacks."""
    return 8 * (n_ops + 1)


@functools.lru_cache(maxsize=None)
def device_sms(dev) -> int:
    """The SM count of the CUDA device ``dev``."""
    return torch.cuda.get_device_properties(
        torch.device(dev)).multi_processor_count


def stepper_launch_plan(B: int, N: int, S: int, V: int, sms: int
                        ) -> StepperPlan:
    """How ``csrc/stepper_chunk.cu`` runs ``B`` lanes of ``N`` ops over an
    ``S x V`` step table on a card of ``sms`` SMs: one warp a lane; a
    block's warps share one copy of the table in shared memory when it
    fits beside their stacks (else the kernel reads it from device memory,
    where the one batch-wide table mostly stays in L2).  Warps per block:
    enough to put the lanes on every SM (``ceil(B / sms)``), at most 16
    and what shared memory holds.
    The C entry re-checks the bytes and refuses a plan it cannot launch;
    it launches any plan whose bytes add up, staged or not."""
    per_warp = warp_stack_bytes(N)
    tab = table_bytes(S, V)
    stage = tab + per_warp <= SMEM_BLOCK_MAX
    room = SMEM_BLOCK_MAX - (tab if stage else 0)
    wpb = max(1, min(MAX_WARPS_PER_BLOCK, room // per_warp,
                     -(-B // sms)))
    return StepperPlan(wpb, -(-B // wpb), stage,
                       (tab if stage else 0) + wpb * per_warp)


def stepper_blocks_per_sm(plan: StepperPlan) -> int:
    """Blocks of ``plan`` one SM holds at once, by shared memory and
    resident warps (registers aside)."""
    return min(BLOCKS_SM_MAX, WARPS_SM_MAX // plan.warps_per_block,
               SMEM_SM // (plan.smem_bytes + SMEM_BLOCK_RESERVED))


# ---------------------------------------------------------------------------
# stepper_chunk
# ---------------------------------------------------------------------------

def stepper_chunk(tables: StepperTables, carry: StepperCarry, *, chunk: int,
                  budget: int) -> StepperCarry:
    """Advance every RUNNING lane by at most ``chunk`` DFS iterations (it
    stops earlier when it decides or its cumulative iterations reach
    ``budget``).  The carry is updated in place and returned: the input is
    dead once the chunk runs, as the JAX package donates it.

    CUDA tensors go to the CUDA kernel (``stepper_chunk.launches`` counts
    each launch); CPU tensors to :func:`stepper_chunk_plain`.  A failed
    build or launch raises; there is no fallback."""
    _check_chunk_args(tables, carry)
    if sweep_dim(carry):
        raise ValueError("stepper_chunk runs table-regime carries; a "
                         "sweep-regime carry goes to stepper_sweep")
    dev = tables.vocab.device
    if dev.type == "cpu":
        return stepper_chunk_plain(tables, carry, chunk=chunk, budget=budget)
    if dev.type != "cuda":
        raise ValueError(f"stepper_chunk runs on cuda or cpu, not {dev}")
    from .kernels import (KernelLaunchError, launch_device_index,
                          stepper_chunk_lib)

    R, N = tables.vocab.shape
    S, V = tables.vnxt.shape
    B, slots = carry.row.shape[0], carry.occ.shape[1]
    plan = stepper_launch_plan(B, N, S, V, device_sms(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = stepper_chunk_lib()
        # the library's own runtime launches on the tensors' card
        rc = lib.set_launch_device(launch_device_index(dev))
        if rc == 0:
            rc = lib.stepper_chunk_launch(
                *(t.data_ptr() for t in tables), carry.row.data_ptr(),
                *(t.data_ptr() for t in carry[:6]),
                B, R, N, S, V, n_words(N), slots, chunk, budget,
                *(int(x) for x in plan),
                stream)
    if rc != 0:
        raise KernelLaunchError(
            f"stepper_chunk launch failed: CUDA error {rc}")
    stepper_chunk.launches += 1
    return carry


stepper_chunk.launches = 0


def _unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """int ``[..., W]`` words -> bool ``[..., n]``."""
    j = torch.arange(n, device=words.device)
    return ((words.to(torch.int64)[..., j >> 5] >> (j & 31)) & 1) == 1


def stepper_chunk_plain(tables: StepperTables, carry: StepperCarry, *,
                        chunk: int, budget: int,
                        early_exit: bool = True) -> StepperCarry:
    """The same function as the CUDA kernel, in plain PyTorch, vectorised
    over lanes: one loop trip per DFS iteration, the JAX package's
    ``run_one`` body (``jax_kernel.py:281-401``) line for line.  Updates
    the carry in place and returns it.  ``early_exit=False`` drops the
    host sync that ends the loop once no lane runs (the trips after it
    are no-ops), so that the loop can be captured in a CUDA graph."""
    _check_chunk_args(tables, carry)
    if sweep_dim(carry):
        raise ValueError("stepper_chunk_plain runs table-regime carries")
    vocab, vnxt, vok, prec, valid, nreq = tables
    N = vocab.shape[1]
    S = vnxt.shape[0]
    B, slots = carry.row.shape[0], carry.occ.shape[1]
    use_cache = slots > 0
    dev = vocab.device
    i32, i64 = torch.int32, torch.int64
    lane = torch.arange(B, device=dev)
    iota = torch.arange(N, device=dev)
    kio = torch.arange(N + 1, device=dev)
    row = carry.row.long()
    voc = vocab[row].long()                                    # [B, N]
    prec_l = prec[row].to(i64) & _M32                          # [B, W, N]
    valid_l = _unpack_bits(valid[row], N)                      # [B, N]
    nreq_l = nreq[row]
    tk = carry.taken.T == 1                                    # [B, N]
    ch = carry.chosen.T.clone()                                # [B, N+1]
    st = carry.states.T.clone()
    keys, occ = carry.keys, carry.occ
    d, status, iters, prunes, inserts = (carry.dsi[k].clone()
                                         for k in range(5))
    for it in range(chunk):
        # every running lane gains one iteration a trip, so within the
        # chunk a lane runs while its status does; once none runs the
        # rest is a no-op (checked every 64 trips: each check syncs)
        if early_exit and it % 64 == 0 and not bool(
                (status == RUNNING).any()):
            break
        act = status == RUNNING
        dl = d.long()
        state = st[lane, dl]
        cur = ch[lane, dl]
        untaken = valid_l & ~tk
        uw = pack_words(untaken)                               # [B, W]
        blocked = ((prec_l & uw[:, :, None]) != 0).any(1)      # [B, N]
        oob = (state < 0) | (state >= S)
        s0 = state.clamp(0, S - 1).long()
        ok = ((vok[s0[:, None], voc >> 5].to(i64) >> (voc & 31)) & 1) == 1
        cand = untaken & ~blocked & ok & (iota > cur[:, None])
        has = cand.any(1)
        j = torch.where(cand, iota, N).amin(1)
        j = torch.where(has, j, torch.zeros_like(j))
        child = vnxt[s0, voc[lane, j]]
        success = has & (d + 1 == nreq_l)
        tw = pack_words(tk)
        if use_cache:
            jbit = torch.zeros_like(tw).scatter_(
                1, (j >> 5)[:, None], (1 << (j & 31))[:, None])
            key_child = torch.cat([tw | jbit, (child.to(i64) & _M32)[:, None]],
                                  dim=1)
            slot_c = hash_slot(key_child, slots)
            hit = ((occ[lane, slot_c] == 1)
                   & ((keys[lane, slot_c].to(i64) & _M32)
                      == key_child).all(1))
            prune = has & hit & ~success
        else:
            prune = torch.zeros_like(has)
        descend = has & ~prune
        d_back = (d - 1).clamp(min=0)
        prev = ch[lane, d_back.long()].clamp(min=0)

        # every update below is a select over whole planes: no masked
        # indexing, so the loop never waits for the device
        desc, pru, exh = act & descend, act & prune, act & ~has
        if use_cache:
            # exhausted: the current configuration (old taken, unclipped
            # state) is proven non-linearizable-from
            key_cur = torch.cat([tw, (state.to(i64) & _M32)[:, None]], dim=1)
            slot_cur = hash_slot(key_cur, slots)
            keys[lane, slot_cur] = torch.where(
                exh[:, None], _as_i32(key_cur), keys[lane, slot_cur])
            occ[lane, slot_cur] = torch.where(exh, 1, occ[lane, slot_cur])
        untake = exh & (d > 0) & (prev < N)
        tk = torch.where(desc[:, None] & (iota == j[:, None]), True, tk)
        tk = torch.where(untake[:, None] & (iota == prev[:, None]), False,
                         tk)
        at_d = kio == dl[:, None]
        at_next = kio == dl[:, None] + 1     # never true past depth N
        ch = torch.where((desc | pru)[:, None] & at_d, j[:, None].to(i32), ch)
        ch = torch.where(desc[:, None] & at_next, -1, ch)
        st = torch.where(desc[:, None] & at_next, child[:, None], st)

        d_new = torch.where(descend, d + 1, torch.where(prune, d, d_back))
        iters_new = iters + 1
        s_new = torch.where(success, SUCCESS, torch.where(
            ~has & (d == 0), FAILURE, RUNNING))
        s_new = torch.where((s_new == RUNNING) & (iters_new >= budget),
                            BUDGET, s_new)
        s_new = torch.where(oob, BUDGET, s_new)
        d = torch.where(act, d_new, d).to(i32)
        iters = torch.where(act, iters_new, iters).to(i32)
        status = torch.where(act, s_new, status).to(i32)
        prunes = prunes + pru.to(i32)
        if use_cache:
            inserts = inserts + exh.to(i32)
    carry.taken.copy_(tk.T.to(i32))
    carry.chosen.copy_(ch.T)
    carry.states.copy_(st.T)
    carry.dsi.copy_(torch.stack([d, status, iters, prunes, inserts]))
    return carry


# ---------------------------------------------------------------------------
# compact_carry
# ---------------------------------------------------------------------------

def _lanes_tensor(lanes, bucket: int, old_b: int, dev) -> torch.Tensor:
    """``lanes`` as int32 on ``dev``, checked on the host (a tensor on the
    device is read back for it)."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.cpu().numpy()
    idx = np.asarray(lanes, np.int64)
    if idx.ndim != 1 or idx.shape[0] > bucket:
        raise ValueError(f"compact_carry: {idx.size} lanes do not fit "
                         f"a bucket of {bucket}")
    if idx.size and not 0 <= idx.min() <= idx.max() < old_b:
        raise ValueError(f"compact_carry: lanes outside [0, {old_b})")
    return torch.from_numpy(idx.astype(np.int32)).to(dev)


def compact_carry(carry: StepperCarry, lanes, bucket: int, slots: int
                  ) -> StepperCarry:
    """A new carry of ``bucket`` lanes: lane ``i < len(lanes)`` is the old
    lane ``lanes[i]`` (every plane, its table row included); the rest are
    padding, all zero but SUCCESS, with an empty memo.  The memo becomes
    ``slots`` slots a lane: copied when the count is unchanged, else every
    occupied entry is re-hashed into an empty table, a later old slot
    winning a collision (the JAX package's ``_compact_carry_host``).  From
    a ``slots = 0`` carry the survivors get an empty table.

    CUDA tensors go to the CUDA kernel (``compact_carry.launches`` counts
    each launch); CPU tensors to :func:`compact_carry_plain`."""
    dev = carry.row.device
    N = carry.taken.shape[0]
    _check_carry("compact_carry", carry, N, dev)
    if slots < 0 or slots & (slots - 1):
        raise ValueError(
            f"slots must be 0 or a power of two, got {slots}")
    idx = _lanes_tensor(lanes, bucket, carry.row.shape[0], dev)
    if dev.type == "cpu":
        return compact_carry_plain(carry, idx, bucket, slots)
    if dev.type != "cuda":
        raise ValueError(f"compact_carry runs on cuda or cpu, not {dev}")
    from .kernels import (KernelLaunchError, compact_carry_lib,
                          launch_device_index)

    sd = sweep_dim(carry)
    out = _empty_carry(N, bucket, slots, dev, sd)
    old_b, old_slots = carry.row.shape[0], carry.occ.shape[1]
    m = idx.shape[0]
    # scratch of the re-hash: the winning old slot of each new slot
    rehash = m > 0 and old_slots > 0 and slots > 0 and old_slots != slots
    win = torch.empty((m, slots) if rehash else (1,), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = compact_carry_lib()
        rc = lib.set_launch_device(launch_device_index(dev))
        if rc == 0:
            rc = lib.compact_carry_launch(
                *(t.data_ptr() for t in carry), idx.data_ptr(),
                *(t.data_ptr() for t in out), win.data_ptr(),
                old_b, bucket, m, N, sd, key_words(N, max(sd, 1)),
                old_slots, slots, device_sms(dev), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"compact_carry launch failed: CUDA error {rc}")
    compact_carry.launches += 1
    return out


compact_carry.launches = 0


def _empty_carry(n_ops: int, bucket: int, slots: int, dev,
                 sweep: int = 0) -> StepperCarry:
    """Uninitialised planes of a carry: the table regime's layout, or with
    ``sweep = D`` the sweep regime's."""
    N, B = n_ops, bucket
    states = (B, N + 1, sweep) if sweep else (N + 1, B)
    return StepperCarry(*(torch.empty(s, dtype=torch.int32, device=dev)
                          for s in ((N, B), (N + 1, B), states, (5, B),
                                    (B, slots, key_words(N, max(sweep, 1))),
                                    (B, slots), (B,))))


def compact_carry_plain(carry: StepperCarry, lanes, bucket: int, slots: int
                        ) -> StepperCarry:
    """The same function as the CUDA kernel, in plain PyTorch."""
    dev = carry.row.device
    N = carry.taken.shape[0]
    _check_carry("compact_carry", carry, N, dev)
    idx = _lanes_tensor(lanes, bucket, carry.row.shape[0], dev).long()
    m = idx.shape[0]
    sd = sweep_dim(carry)
    out = _empty_carry(N, bucket, slots, dev, sd)
    for name in ("taken", "chosen", "states", "dsi"):
        o, v = getattr(out, name), getattr(carry, name)
        o.zero_()
        if name == "states" and sd:
            o[:m] = v[idx]          # lane-major
        else:
            o[:, :m] = v[:, idx]
    out.dsi[STATUS, m:] = SUCCESS
    out.row.zero_()
    out.row[:m] = carry.row[idx]
    out.keys.zero_()
    out.occ.zero_()
    old_slots = carry.occ.shape[1]
    if slots == 0 or old_slots == 0 or m == 0:
        return out
    if old_slots == slots:
        out.keys[:m] = carry.keys[idx]
        out.occ[:m] = carry.occ[idx]
        return out
    keys = carry.keys[idx]                                  # [m, old, kw]
    filled = carry.occ[idx] == 1
    dest = torch.where(filled, hash_slot(keys.to(torch.int64), slots),
                       slots)                               # [m, old]
    # the winner of each new slot: the last old slot hashing to it
    src = torch.arange(old_slots, device=dev).expand(m, old_slots)
    win = torch.full((m, slots + 1), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(1, dest, src, reduce="amax")
    win = win[:, :slots]
    got = win >= 0
    gathered = keys.gather(1, win.clamp(min=0)[:, :, None].expand(
        m, slots, keys.shape[2]))
    out.keys[:m] = torch.where(got[:, :, None], gathered, 0)
    out.occ[:m] = got.to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# build_kernel: one history decided to completion in one launch
# ---------------------------------------------------------------------------

def build_kernel(spec, n_ops: int, budget: int, cache_slots: int = 0,
                 cache_write: str = "onehot", device=None):
    """The run-to-completion checker of the JAX package's ``build_kernel``
    (``init_one``, then one unchunked ``run_one``).  Returns ``check_one(
    cmd, arg, resp, valid, precedes, init_state)``: the padded planes of a
    batch of ``n_ops``-op histories (``encode_batch``'s: int ``[B, N]``,
    ``valid`` bool ``[B, N]``, ``precedes`` bool ``[B, N, N]``) and the
    spec's start state, giving ``(status, iters)``, int32 numpy ``[B]``:
    one fresh carry and one launch whose chunk is the whole ``budget``
    (``stepper_chunk``, or ``stepper_sweep`` for a spec without a scalar
    state bound, which steps the state itself as the reference's
    ``build_kernel`` does: by its kernel model, or by the generic route
    for any other spec, whose chunk ends once every lane decided), so
    every lane ends SUCCESS, FAILURE or BUDGET.

    ``cache_slots`` (0 or a power of two) is the memo a lane.
    ``cache_write`` exists only for the reference's signature: it is
    validated against the reference's names, "onehot" and "dus", and
    changes nothing, since both name one kernel here (the choice is how
    the reference's memo write lowers on a TPU).  ``device`` (default
    CUDA) holds the tables and the carry; on CPU tensors the plain
    versions run."""
    from .backend import resolve_device
    from .sweep_kernel import (fresh_sweep_carry, stepper_sweep,
                               sweep_model, sweep_tables)

    if cache_slots < 0 or cache_slots & (cache_slots - 1):
        raise ValueError(
            f"cache_slots must be 0 or a power of two, got {cache_slots}")
    if cache_write not in ("onehot", "dus"):
        raise ValueError(
            f"cache_write must be 'onehot' or 'dus', got {cache_write!r}")
    if not 1 <= n_ops <= MAX_OPS:
        raise ValueError(f"build_kernel covers 1 <= n_ops <= {MAX_OPS}")
    dev = resolve_device(device)
    table = (spec.STATE_DIM == 1
             and spec.scalar_state_bound(n_ops) is not None)
    model = None if table else sweep_model(spec, dev)

    def check_one(cmd, arg, resp, valid, precedes, init_state):
        planes = (cmd, arg, resp, valid, precedes)
        B = np.shape(cmd)[0]
        if any(np.shape(p)[:2] != (B, n_ops) for p in planes):
            raise ValueError(f"check_one: planes of [B, {n_ops}] ops "
                             f"expected, got "
                             f"{[np.shape(p) for p in planes]}")
        rows = np.arange(B)
        if table:
            tables = stepper_tables(spec, *planes, dev)
            carry = fresh_stepper_carry(
                tables.nreq, rows,
                np.full(B, int(np.asarray(init_state).reshape(-1)[0]),
                        np.int32), B, n_ops, cache_slots)
            stepper_chunk(tables, carry, chunk=budget, budget=budget)
        else:
            tables = sweep_tables(*planes, dev)
            carry = fresh_sweep_carry(
                tables.nreq, rows,
                np.tile(np.asarray(init_state, np.int32).reshape(1, -1),
                        (B, 1)), B, n_ops, cache_slots)
            stepper_sweep(model, tables, carry, chunk=budget, budget=budget)
        dsi = carry.dsi.cpu().numpy()
        return dsi[STATUS].copy(), dsi[ITERS].copy()

    return check_one
