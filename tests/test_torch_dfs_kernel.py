"""``dfs_chunk_plain`` against the JAX package's Pallas kernel
(``build_pallas_chunk``, interpret mode on the CPU): all seven output
planes bit-identical (tolerance 0), after 1 and 3 chunks, at N = 12 and
N = 32 (op 31 sets bit 31 of every packed word), with the memo off and
at 64 slots, from fresh carries, from mid-search carries, and from
states outside the table."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qsm_tpu.core.generator import generate_program
from qsm_tpu.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu.ops.pallas_kernel import build_pallas_chunk
from qsm_tpu.sched.runner import run_concurrent
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.models.cas import CasSpec as TCas
from qsm_tpu_torch.ops.dfs_kernel import (RUNNING, Carry, dfs_chunk,
                                          dfs_chunk_plain, slot_hash)
from qsm_tpu_torch.ops.gpu_backend import fresh_carry, lane_tables
from qsm_tpu_torch.utils.interop import (carry_from_numpy, carry_to_numpy,
                                        history_from_rows, history_to_rows)

CHUNK = 64
BUDGET = 4_000
LANES = 256


def _histories(n_ops):
    spec = CasSpec()
    if n_ops == 12:
        hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=16, n_pids=4,
                          max_ops=12, seed_base=77, seed_prefix="pal")
    else:
        # every history exactly 32 ops, so bit 31 is live everywhere
        hs = []
        for i in range(16):
            sut = (AtomicCasSUT, RacyCasSUT)[i % 2](spec)
            prog = generate_program(spec, seed=300 + i, n_pids=4,
                                    max_ops=32, min_ops=32)
            hs.append(run_concurrent(sut, prog, seed=f"k32:{i}"))
        assert all(len(h) == 32 and h.n_pending == 0 for h in hs)
    return [history_from_rows(history_to_rows(h)) for h in hs]


@pytest.fixture(scope="module", params=[12, 32])
def tables(request):
    n = request.param
    return n, lane_tables(TCas(), _histories(n), n, LANES, "cpu")


def _start(tabs, n, cs, start):
    carry = fresh_carry(tabs.nreq, np.zeros(16, np.int32), n, cs)
    if start == "mid":
        # a mid-search carry: half a chunk in, lanes still running
        carry = dfs_chunk_plain(tabs, carry, chunk=CHUNK // 2,
                                budget=BUDGET, cache_slots=cs)
        assert int((carry.dsi[1, :16] == RUNNING).sum()) > 0
    elif start == "oob":
        # lanes starting in states outside [0, S): no table row
        st = carry.states.clone()
        st[0, :16:3] = 7
        st[0, 1:16:5] = -2
        carry = carry._replace(states=st)
    return carry


@pytest.mark.parametrize("start", ["fresh", "mid", "oob"])
@pytest.mark.parametrize("cs", [0, 64])
def test_plain_matches_pallas_kernel(tables, cs, start):
    n, tabs = tables
    fn = build_pallas_chunk(CasSpec(), n, 5, LANES, CHUNK, BUDGET,
                            interpret=True, cache_slots=cs)
    jt = [jnp.asarray(t.numpy()) for t in tabs]
    carry = _start(tabs, n, cs, start)
    jc = [jnp.asarray(t.numpy()) for t in carry]
    for k in range(3):
        jc = fn(*jt, *jc)
        carry = dfs_chunk_plain(tabs, carry, chunk=CHUNK, budget=BUDGET,
                                cache_slots=cs)
        if k in (0, 2):
            for name, a, b in zip(Carry._fields, jc, carry):
                np.testing.assert_array_equal(
                    np.asarray(a), b.numpy(),
                    err_msg=f"{name} after {k + 1} chunk(s)")
    if cs:
        assert int(carry.occ.sum()) > 0  # the memo was exercised


def test_wrapper_routes_cpu_tensors_to_plain_without_counting(tables):
    n, tabs = tables
    carry = fresh_carry(tabs.nreq, np.zeros(16, np.int32), n, 64)
    before = dfs_chunk.launches
    got = dfs_chunk(tabs, carry, chunk=CHUNK, budget=BUDGET, cache_slots=64)
    want = dfs_chunk_plain(tabs, carry, chunk=CHUNK, budget=BUDGET,
                           cache_slots=64)
    assert dfs_chunk.launches == before  # no kernel launch on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the input carry is left as it was
    assert int(carry.dsi[2].sum()) == 0


def test_wrapper_rejects_bad_inputs(tables):
    n, tabs = tables
    carry = fresh_carry(tabs.nreq, np.zeros(16, np.int32), n, 64)
    with pytest.raises(ValueError, match="power of two"):
        dfs_chunk(tabs, fresh_carry(tabs.nreq, np.zeros(16, np.int32), n,
                                    48), chunk=1, budget=1, cache_slots=48)
    with pytest.raises(ValueError, match="shape"):
        dfs_chunk(tabs, carry, chunk=1, budget=1, cache_slots=0)
    with pytest.raises(TypeError, match="int32"):
        dfs_chunk(tabs, carry._replace(taken=carry.taken.long()), chunk=1,
                  budget=1, cache_slots=64)
    with pytest.raises(ValueError, match="contiguous"):
        bad = carry.chosen.T.contiguous().T
        dfs_chunk(tabs, carry._replace(chosen=bad), chunk=1, budget=1,
                  cache_slots=64)


def test_slot_hash_matches_uint32_mirror():
    rng = np.random.default_rng(3)
    word = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    state = rng.integers(-3, 64, 4096).astype(np.int64)
    with np.errstate(over="ignore"):
        h = np.uint32(0x9E3779B9) ^ word.astype(np.uint32)
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(16)
        h ^= state.astype(np.uint32)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(13)
    got = slot_hash(torch.from_numpy(word.astype(np.int64)),
                    torch.from_numpy(state), 64)
    np.testing.assert_array_equal(got.numpy(), (h & np.uint32(63)))


def test_carry_round_trips_through_numpy(tables):
    n, tabs = tables
    carry = fresh_carry(tabs.nreq, np.zeros(16, np.int32), n, 64)
    back = carry_from_numpy(carry_to_numpy(carry), "cpu")
    for a, b in zip(carry, back):
        assert torch.equal(a, b)
