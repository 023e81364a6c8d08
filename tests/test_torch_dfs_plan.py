"""The launch plan of ``csrc/dfs_chunk.cu`` and a numpy rehearsal of its
incremental blocked-op word, on the CPU.

The kernel runs only on the card, so what can be held here is (a) the
plan it is launched with — one warp per block, what is staged in shared
memory, the bytes, the blocks an SM holds — and (b) its arithmetic: the
bit-sliced counters ``cnt[j]`` (untaken valid ops in ``prec[j]``), moved by
the transposed successor words, must give the same ``unblocked`` word as
the 32-step sweep ``(prec[j] & uw) == 0`` at every step of random DFS
walks (descend, prune, backtrack with an untaken or invalid ``prev``)."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu_torch.ops.dfs_kernel import (H100_SMS, LANES_PER_BLOCK,
                                          MEMO_GLOBAL, MEMO_OFF, MEMO_SHARED,
                                          SMEM_BLOCK_MAX, blocks_per_sm,
                                          launch_plan)

ROW = 4 * LANES_PER_BLOCK  # bytes of one lane-minor row of a block


@pytest.mark.parametrize("N,S,cs,stage_nxt,memo", [
    (32, 5, 64, True, MEMO_SHARED),     # the headline: everything staged
    (32, 5, 0, True, MEMO_OFF),
    (12, 5, 64, True, MEMO_SHARED),     # bucket 12
    (24, 5, 64, True, MEMO_SHARED),     # bucket 24
    (32, 64, 64, False, MEMO_SHARED),   # nxt would be 256 KB: global
    (12, 64, 0, False, MEMO_OFF),
    (32, 5, 512, True, MEMO_SHARED),
    (32, 5, 1024, True, MEMO_GLOBAL),   # memo too large to stage
])
def test_launch_plan_stages_what_fits(N, S, cs, stage_nxt, memo):
    plan = launch_plan(4096, N, S, cs)
    assert plan.lanes_per_block == 32
    assert plan.grid == 128
    assert plan.stage_nxt == stage_nxt
    assert plan.memo == memo
    rows = 2 * (N + 1) + S + N
    if memo == MEMO_SHARED:
        rows += 2 * cs + -(-cs // 32)
    if stage_nxt:
        rows += S * N
    assert plan.smem_bytes == rows * ROW
    assert plan.smem_bytes <= SMEM_BLOCK_MAX  # 227 KB a block


def test_headline_plan_bytes_and_one_wave_at_16384_lanes():
    plan = launch_plan(16384, 32, 5, 64)
    # nxt 20,480 + memo 16,640 + stacks 8,448 + okw 640 + succ 4,096
    assert plan.smem_bytes == 50_304
    assert plan.grid == 512
    assert blocks_per_sm(plan) >= 4
    assert plan.grid <= blocks_per_sm(plan) * H100_SMS  # one wave


def test_launch_plan_grid_covers_a_ragged_edge():
    assert launch_plan(300, 32, 5, 64).grid == 10
    assert launch_plan(0, 32, 5, 64).grid == 0
    assert launch_plan(32, 32, 5, 64).grid == 1


# ---------------------------------------------------------------------------
# numpy rehearsal of the bit-sliced counters (uint32 words, lanes vectorised)
# ---------------------------------------------------------------------------

SLICES = 6
BITS = np.arange(32, dtype=np.uint32)


def sweep_unblocked(prec, uw):
    """The PR-1 kernel's word: bit j set iff prec[j] & uw == 0 (prec[j]
    is 0 for j >= N, so those bits are set)."""
    free = (prec & uw[:, None]) == 0                       # [L, 32]
    return np.bitwise_or.reduce(free.astype(np.uint32) << BITS, axis=1)


def transpose(prec, nmask):
    """succ[i] bit j iff bit i of prec[j] (bits at or above N dropped)."""
    p = prec & nmask[:, None]
    bit = (p[:, None, :] >> BITS[None, :, None]) & 1       # [L, i, j]
    return np.bitwise_or.reduce(bit << BITS[None, None, :], axis=2)


def init_slices(prec, uw):
    n = np.zeros(prec.shape, np.uint32)
    for j in range(32):
        n[:, j] = [bin(int(x)).count("1") for x in prec[:, j] & uw]
    return [np.bitwise_or.reduce(((n >> np.uint32(k)) & 1) << BITS, axis=1)
            for k in range(SLICES)]


def slices_add(c, s, on):
    s = np.where(on, s, np.uint32(0))
    for k in range(SLICES):
        t = c[k] & s
        c[k] = c[k] ^ s
        s = t


def slices_sub(c, s, on):
    s = np.where(on, s, np.uint32(0))
    for k in range(SLICES):
        t = ~c[k] & s
        c[k] = c[k] ^ s
        s = t


def unblocked_of(c):
    return ~(c[0] | c[1] | c[2] | c[3] | c[4] | c[5])


def _random_dag(rng, L, N):
    """Interval orders (real-time precedence) and arbitrary DAGs mixed."""
    inv = np.sort(rng.uniform(0, N, (L, N)), axis=1)
    resp = inv + rng.exponential(rng.uniform(1, 12, (L, 1)), (L, N))
    before = resp[:, :, None] < inv[:, None, :]            # [L, i, j]
    dag = np.triu(rng.random((L, N, N)) < 0.15, k=1)
    rel = np.where((np.arange(L) % 2 == 0)[:, None, None], before, dag)
    prec = np.zeros((L, 32), np.uint32)
    prec[:, :N] = np.bitwise_or.reduce(
        rel.astype(np.uint32) << BITS[:N, None], axis=1)
    return prec


@pytest.mark.parametrize("N", [12, 32])
def test_bitsliced_counters_match_the_sweep_on_random_walks(N):
    rng = np.random.default_rng(N)
    L, steps = 256, 400
    nmask = np.full(L, (1 << N) - 1 if N < 32 else 0xFFFFFFFF, np.uint32)
    prec = _random_dag(rng, L, N)
    valid = np.bitwise_or.reduce(
        (rng.random((L, N)) >= 0.1).astype(np.uint32) << BITS[:N], axis=1)
    # a carry may hold taken bits of invalid ops too
    taken = np.bitwise_or.reduce(
        (rng.random((L, N)) < 0.2).astype(np.uint32) << BITS[:N], axis=1)
    succ = transpose(prec, nmask)
    assert not succ[:, N:].any()  # no successor word for an op >= N
    if N < 32:
        assert not (succ >> np.uint32(N)).any()  # no bit at or above N
    c = init_slices(prec, valid & ~taken)
    moves = {"descend": 0, "prune": 0, "back_gain": 0, "back_none": 0}
    for _ in range(steps):
        uw = valid & ~taken
        got = unblocked_of(c)
        np.testing.assert_array_equal(got, sweep_unblocked(prec, uw))
        if N < 32:  # counters above N stay zero
            for k in range(SLICES):
                assert not (c[k] >> np.uint32(N)).any()
        cand = uw & got
        has = cand != 0
        # descend on a random candidate (the kernel takes the first; the
        # counters do not care which)
        pick = np.zeros(L, np.uint32)
        for lane in np.nonzero(has)[0]:
            bits = [j for j in range(N) if cand[lane] >> j & 1]
            pick[lane] = bits[rng.integers(len(bits))]
        action = rng.integers(0, 3, L)          # 0 descend, 1 prune, 2 back
        descend = has & (action == 0)
        slices_sub(c, succ[np.arange(L), pick], descend)
        taken = np.where(descend, taken | (np.uint32(1) << pick), taken)
        # prune moves a cursor only: uw, and so the counters, stay
        # backtrack: untake any op, taken or not, valid or not; uw gains
        # it only if it was taken and valid
        back = action == 2
        prev = rng.integers(0, N, L).astype(np.uint32)
        bit = np.uint32(1) << prev
        gain = back & ((valid & taken & bit) != 0)
        slices_add(c, succ[np.arange(L), prev], gain)
        taken = np.where(back, taken & ~bit, taken)
        moves["descend"] += int(descend.sum())
        moves["prune"] += int((has & (action == 1)).sum())
        moves["back_gain"] += int(gain.sum())
        moves["back_none"] += int((back & ~gain).sum())
    assert min(moves.values()) > 1000, moves
