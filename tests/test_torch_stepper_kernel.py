"""``stepper_chunk_plain`` and ``compact_carry_plain`` against the JAX
package's ``build_stepper`` / ``run_one`` and ``JaxTPU._compact_carry_host``
on the same numpy inputs: every carry plane equal (tolerance 0, all
integer), from fresh carries and from mid-search ``JaxTPU`` carries carried
across by ``utils/interop.py``; the memo hash against ``make_hash_slot``
and ``hash_slots_np``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsm_tpu.core.history import encode_batch as j_encode_batch
from qsm_tpu.models.cas import AtomicCasSUT, CasSpec as JCas, RacyCasSUT
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec as JQueue,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.ops.jax_kernel import JaxTPU, build_stepper
from qsm_tpu.ops.jax_kernel import hash_slots_np as j_hash_slots_np
from qsm_tpu.ops.jax_kernel import make_hash_slot
from qsm_tpu.ops.scalarize import scalar_shadow as j_scalar_shadow
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.ops.scalarize import scalar_shadow
from qsm_tpu_torch.ops.stepper_kernel import (
    compact_carry_plain, fresh_stepper_carry, hash_slot, hash_slots_np,
    stepper_chunk_plain, stepper_tables)
from qsm_tpu_torch.utils.interop import (stepper_carry_from_jax,
                                         stepper_carry_to_jax)

BUDGET = 552_000
CHUNK = 61
LANES = 24

# (model, N, pids, histories): every N is its own op bucket
CASES = [("queue", 12, 3), ("queue", 24, 4), ("queue", 48, 8),
         ("cas", 32, 8), ("cas", 64, 8), ("cas", 96, 8)]


def _inputs(model: str, n_ops: int, pids: int):
    """The JAX package's corpus and its kernel inputs (numpy), the two
    scalar specs (the reference's and the port's)."""
    if model == "queue":
        jspec, spec, suts = JQueue(), QueueSpec(), (AtomicQueueSUT,
                                                    RacyTwoPhaseQueueSUT)
    else:
        jspec, spec, suts = JCas(), CasSpec(), (AtomicCasSUT, RacyCasSUT)
    hs = build_corpus(jspec, suts, n=LANES, n_pids=pids, max_ops=n_ops,
                      seed_base=11, seed_prefix="stepper")
    jk = j_scalar_shadow(jspec) or jspec
    tk = scalar_shadow(spec) or spec
    enc = j_encode_batch(hs, jk.initial_state(), max_ops=n_ops)
    arrays = (enc.ops[:, :, 1].astype(np.int32),
              enc.ops[:, :, 2].astype(np.int32),
              enc.ops[:, :, 3].astype(np.int32),
              enc.valid.astype(bool), enc.precedes().astype(bool))
    assert max(len(h) for h in hs) > n_ops // 2  # the bucket is used
    return jk, tk, arrays, int(enc.init_state[0])


def _jax_run(jk, n_ops, slots, arrays, starts, chunks):
    """The reference carry after each of ``chunks`` chunks of CHUNK."""
    init_one, run_one = build_stepper(jk, n_ops, BUDGET, cache_slots=slots)
    carry = jax.vmap(init_one)(jnp.asarray(arrays[3]),
                               jnp.asarray(starts[:, None]))
    fn = jax.jit(jax.vmap(lambda c, *a: run_one(c, *a, chunk=CHUNK)))
    out = []
    for _ in range(chunks):
        carry = fn(carry, *(jnp.asarray(a) for a in arrays))
        out.append({k: np.asarray(v) for k, v in carry.items()})
    return out


def _assert_same(jc: dict, carry, what: str) -> None:
    got = stepper_carry_to_jax(carry)
    assert sorted(got) == sorted(jc), what
    for k in jc:
        assert np.array_equal(jc[k], got[k]), f"{k} differs {what}"


@pytest.mark.parametrize("slots", [0, 8, 64])
@pytest.mark.parametrize("model,n_ops,pids", CASES)
def test_chunk_plain_equals_run_one(model, n_ops, pids, slots):
    jk, tk, arrays, init = _inputs(model, n_ops, pids)
    starts = np.full(LANES, init, np.int32)
    ref = _jax_run(jk, n_ops, slots, arrays, starts, chunks=3)
    tabs = stepper_tables(tk, *arrays, "cpu")
    # from a fresh carry, two chunks in a row
    carry = fresh_stepper_carry(tabs.nreq, np.arange(LANES), starts, LANES,
                                n_ops, slots)
    for k in range(2):
        stepper_chunk_plain(tabs, carry, chunk=CHUNK, budget=BUDGET)
        _assert_same(ref[k], carry, f"after chunk {k + 1}")
    # from the reference's own mid-search carry, carried across
    mid = stepper_carry_from_jax(ref[1], "cpu")
    _assert_same(ref[1], mid, "carried across")
    stepper_chunk_plain(tabs, mid, chunk=CHUNK, budget=BUDGET)
    _assert_same(ref[2], mid, "resumed from the reference's carry")
    if slots:
        assert ref[2]["inserts"].sum() > 0


@pytest.mark.parametrize("model,n_ops,pids,outside",
                         [("cas", 32, 8, (7, -2)),
                          ("queue", 24, 4, (1283, -2))])
def test_start_states_outside_the_table_end_as_budget(model, n_ops, pids,
                                                      outside):
    """The row is read at the clipped state and the whole transition is
    applied; only then is the lane ended as BUDGET (``jax_kernel.py``
    :299-303, :353)."""
    jk, tk, arrays, init = _inputs(model, n_ops, pids)
    starts = np.full(LANES, init, np.int32)
    starts[::3] = outside[0]
    starts[1::3] = outside[1]
    for slots in (0, 8):
        ref = _jax_run(jk, n_ops, slots, arrays, starts, chunks=1)[0]
        tabs = stepper_tables(tk, *arrays, "cpu")
        carry = fresh_stepper_carry(tabs.nreq, np.arange(LANES), starts,
                                    LANES, n_ops, slots)
        stepper_chunk_plain(tabs, carry, chunk=CHUNK, budget=BUDGET)
        _assert_same(ref, carry, f"with start states {outside}")
        out = starts != init
        assert (ref["status"][out] == 3).all()
        assert (ref["iters"][out] == 1).all()
        assert (ref["d"][out] == 1).any()  # a transition was applied


def test_hash_matches_the_reference_mixer():
    g = np.random.default_rng(0)
    for kw in (2, 3, 5):
        keys = g.integers(0, 2**32, (500, kw), dtype=np.uint64).astype(
            np.uint32)
        keys[:100] |= np.uint32(0x80000000)   # high bits set
        keys[100:200] &= np.uint32(0xFFFF0000)  # only high bits
        for slots in (8, 64, 4096):
            want = j_hash_slots_np(keys, slots)
            assert np.array_equal(hash_slots_np(keys, slots), want)
            got = hash_slot(torch.from_numpy(keys.astype(np.int64)), slots)
            assert np.array_equal(got.numpy(), want)
            jfn = jax.vmap(make_hash_slot(kw, slots))
            assert np.array_equal(np.asarray(jfn(jnp.asarray(keys))), want)


@pytest.mark.parametrize("old_slots,slots", [(8, 64), (64, 64), (64, 8),
                                             (0, 64), (64, 0)])
def test_compact_plain_equals_host_reference(old_slots, slots):
    jk, tk, arrays, init = _inputs("queue", 48, 8)
    starts = np.full(LANES, init, np.int32)
    carry = _jax_run(jk, 48, old_slots, arrays, starts, chunks=2)[1]
    running = np.flatnonzero(carry["status"] == 0)
    assert running.size > 4
    lanes = np.random.default_rng(1).permutation(running)
    bucket = 16
    j = JaxTPU(JQueue())
    want = j._compact_carry_host({k: jnp.asarray(v) for k, v in
                                  carry.items()}, lanes, bucket, slots,
                                 old_slots)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = compact_carry_plain(stepper_carry_from_jax(carry, "cpu"), lanes,
                              bucket, slots)
    _assert_same(want, got, f"compacting {old_slots} -> {slots} slots")
    assert np.array_equal(got.row.numpy()[:lanes.size], lanes)
    if old_slots and slots:
        assert want["occ"].sum() > 0
