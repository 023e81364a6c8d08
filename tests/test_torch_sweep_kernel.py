"""``stepper_sweep_plain`` against the JAX package's ``build_stepper`` /
``run_one`` in its sweep regime (a vector spec without a state bound) on
the same numpy inputs: every carry plane equal (tolerance 0, all integer)
after chunks run in a row, and resumed from the reference's own
mid-search carry carried across by ``utils/interop.py``; memo off and on;
on KV, queue, stack, multicas, txn and random vector specs too large for a
table, at one and two taken words.  Also the launch plan, ``sweep_model``,
the wrapper's check of a lane list, and the compaction of sweep-regime
carries against ``JaxTPU._compact_carry_host``."""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsm_tpu.core.history import encode_batch as j_encode_batch
from qsm_tpu.models.kv import AtomicKvSUT, KvSpec as JKv, StaleCacheKvSUT
from qsm_tpu.models.multi import (AtomicMultiCasSUT, MultiCasSpec as JMCas,
                                  RacyMultiCasSUT)
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec as JQueue,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.models.stack import (AtomicStackSUT, RacyTwoPhaseStackSUT,
                                  StackSpec as JStack)
from qsm_tpu.models.txn import (AtomicTxnSUT, TornCopyTxnSUT,
                                TxnRegisterSpec as JTxn)
from qsm_tpu.ops.jax_kernel import JaxTPU, build_stepper
from qsm_tpu.ops.scalarize import scalar_shadow as j_scalar_shadow
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu.utils.fuzz import RandomVectorSpec as JRandomVector
from qsm_tpu.utils.fuzz import random_history as j_random_history
from qsm_tpu_torch.core.spec import CmdSig, Spec
from qsm_tpu_torch.models.kv import KvSpec
from qsm_tpu_torch.models.multi import MultiCasSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.models.stack import StackSpec
from qsm_tpu_torch.models.txn import TxnRegisterSpec
from qsm_tpu_torch.ops.dfs_kernel import (H100_SMS, SMEM_BLOCK_MAX,
                                          SMEM_BLOCK_RESERVED, SMEM_SM)
from qsm_tpu_torch.ops.scalarize import scalar_shadow
from qsm_tpu_torch.ops.stepper_kernel import StepperCarry, compact_carry_plain
from qsm_tpu_torch.ops.sweep_kernel import (
    MAX_SWEEP_DIM, fresh_sweep_carry, stepper_sweep, stepper_sweep_plain,
    sweep_launch_plan, sweep_model, sweep_tables, sweep_warp_bytes)
from qsm_tpu_torch.utils.fuzz import RandomVectorSpec
from qsm_tpu_torch.utils.interop import (stepper_carry_from_jax,
                                         stepper_carry_to_jax)

BUDGET = 552_000
CHUNK = 29
LANES = 16

# name -> (reference spec, port spec, SUTs or None for random histories)
SPECS = {
    "kv9": (lambda: JKv(n_keys=9), lambda: KvSpec(n_keys=9),
            (AtomicKvSUT, StaleCacheKvSUT)),
    "queue8": (lambda: JQueue(capacity=8), lambda: QueueSpec(capacity=8),
               (AtomicQueueSUT, RacyTwoPhaseQueueSUT)),
    "stack8": (lambda: JStack(capacity=8), lambda: StackSpec(capacity=8),
               (AtomicStackSUT, RacyTwoPhaseStackSUT)),
    "multicas9": (lambda: JMCas(n_cells=9), lambda: MultiCasSpec(n_cells=9),
                  (AtomicMultiCasSUT, RacyMultiCasSUT)),
    "txn8": (lambda: JTxn(8, 8), lambda: TxnRegisterSpec(8, 8),
             (AtomicTxnSUT, TornCopyTxnSUT)),
    "random9": (lambda: JRandomVector(7, bounds=(4,) * 9),
                lambda: RandomVectorSpec(7, bounds=(4,) * 9), None),
}
# (spec, ops a history, pids): histories of 12-40 ops, one taken word
# (bucket 24 or 32) and two (bucket 48)
CASES = [("kv9", 24, 6), ("kv9", 40, 8), ("queue8", 24, 4),
         ("stack8", 40, 6), ("multicas9", 40, 8), ("txn8", 24, 6),
         ("random9", 40, 4)]


def _histories(name: str, n_ops: int, pids: int):
    jspec = SPECS[name][0]()
    suts = SPECS[name][2]
    if suts is None:
        rng = random.Random(f"sweep:{name}")
        return jspec, [j_random_history(jspec, rng, pids, n_ops)
                       for _ in range(LANES)]
    return jspec, build_corpus(jspec, suts, n=LANES, n_pids=pids,
                               max_ops=n_ops, seed_base=17,
                               seed_prefix="sweep")


def _inputs(name: str, n_ops: int, pids: int):
    jspec, hs = _histories(name, n_ops, pids)
    spec = SPECS[name][1]()
    assert j_scalar_shadow(jspec) is None and scalar_shadow(spec) is None
    enc = j_encode_batch(hs, jspec.initial_state())
    N = enc.ops.shape[1]
    assert max(len(h) for h in hs) > N // 2   # the bucket is used
    arrays = (enc.ops[:, :, 1].astype(np.int32),
              enc.ops[:, :, 2].astype(np.int32),
              enc.ops[:, :, 3].astype(np.int32),
              enc.valid.astype(bool), enc.precedes().astype(bool))
    starts = np.tile(np.asarray(enc.init_state, np.int32), (LANES, 1))
    return jspec, spec, N, arrays, starts


def _jax_run(jspec, n_ops, slots, arrays, starts, chunks):
    """The reference carry after each of ``chunks`` chunks of CHUNK."""
    init_one, run_one = build_stepper(jspec, n_ops, BUDGET,
                                      cache_slots=slots)
    carry = jax.vmap(init_one)(jnp.asarray(arrays[3]), jnp.asarray(starts))
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


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("name,n_ops,pids", CASES)
def test_sweep_plain_equals_run_one(name, n_ops, pids, slots):
    jspec, spec, N, arrays, starts = _inputs(name, n_ops, pids)
    ref = _jax_run(jspec, N, slots, arrays, starts, chunks=3)
    tabs = sweep_tables(*arrays, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              slots)
    for k in range(2):
        stepper_sweep_plain(spec, tabs, carry, chunk=CHUNK, budget=BUDGET)
        _assert_same(ref[k], carry, f"after chunk {k + 1}")
    mid = stepper_carry_from_jax(ref[1], "cpu")
    _assert_same(ref[1], mid, "carried across")
    # the wrapper takes the plain version for CPU tensors
    stepper_sweep(sweep_model(spec, "cpu"), tabs, mid, chunk=CHUNK,
                  budget=BUDGET)
    _assert_same(ref[2], mid, "resumed from the reference's carry")
    # lanes still searching after a chunk, lanes decided at the end
    assert (ref[0]["status"] == 0).any() and (ref[2]["status"] != 0).any()
    if slots:
        assert ref[2]["inserts"].sum() > 0


def test_sweep_plain_equals_run_one_from_other_start_states():
    """Explicit start states (``check_from``), in and outside the element
    bounds: the sweep regime has no out-of-bounds state, every lane
    searches on."""
    jspec, spec, N, arrays, starts = _inputs("kv9", 24, 6)
    g = np.random.default_rng(2)
    starts = g.integers(0, 4, starts.shape).astype(np.int32)
    starts[::3, 2] = 9
    starts[1::5, 0] = -3
    ref = _jax_run(jspec, N, 64, arrays, starts, chunks=1)[0]
    tabs = sweep_tables(*arrays, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              64)
    stepper_sweep_plain(spec, tabs, carry, chunk=CHUNK, budget=BUDGET)
    _assert_same(ref, carry, "from explicit start states")


@pytest.mark.parametrize("old_slots,slots", [(8, 64), (64, 64), (64, 8),
                                             (0, 64), (64, 0)])
def test_compact_plain_of_a_sweep_carry_equals_host_reference(old_slots,
                                                              slots):
    """``compact_carry_plain`` with D > 1: the lane-major state stacks and
    the W + D-word keys move as ``_compact_carry_host`` moves them."""
    jspec, spec, N, arrays, starts = _inputs("kv9", 40, 8)
    carry = _jax_run(jspec, N, old_slots, arrays, starts, chunks=1)[0]
    running = np.flatnonzero(carry["status"] == 0)
    assert running.size > 3
    lanes = np.random.default_rng(1).permutation(running)
    j = JaxTPU(jspec)
    want = j._compact_carry_host({k: jnp.asarray(v) for k, v in
                                  carry.items()}, lanes, 8, slots,
                                 old_slots)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = compact_carry_plain(stepper_carry_from_jax(carry, "cpu"), lanes,
                              8, slots)
    _assert_same(want, got, f"compacting {old_slots} -> {slots} slots")
    assert got.states.shape == (8, N + 1, 9)
    if old_slots and slots:
        assert want["occ"].sum() > 0


def test_sweep_launch_plan():
    # kv16 at 64 ops, 2048 memo slots: 6728 shared bytes a warp (the
    # stacks, 65 x 17 words; a hash a level, 65 words; one tag byte a
    # slot), 16 warps a block at 4096 lanes, two blocks an SM: one wave
    assert sweep_warp_bytes(64, 16, 2048) == 4 * (65 * 17 + 65) + 2048
    assert sweep_warp_bytes(64, 16, 0) == 4 * (65 * 17)
    assert sweep_warp_bytes(24, 9, 5) == 4 * (25 * 10 + 25 + 2)
    p = sweep_launch_plan(4096, 64, 16, 2048, H100_SMS)
    assert p == (16, 256, 16 * 6728)
    assert 2 * (p.smem_bytes + SMEM_BLOCK_RESERVED) <= SMEM_SM
    # few lanes: spread over the SMs, one warp a block
    assert sweep_launch_plan(100, 64, 16, 2048, H100_SMS) == (1, 100, 6728)
    # the running lanes alone: 1160 -> 9 warps a block, one block an SM;
    # 2144 -> 17 warps an SM, as two blocks of 9 (not 16 + 1)
    assert sweep_launch_plan(1160, 64, 16, 2048, H100_SMS)[:2] == (9, 129)
    assert sweep_launch_plan(2144, 64, 16, 2048, H100_SMS)[:2] == (9, 239)
    # the widest state at 128 ops, or the largest memo: shared memory caps
    # the warps a block, and the blocks an SM are made equal
    for D, slots in ((MAX_SWEEP_DIM, 0), (16, 1 << 16)):
        per = sweep_warp_bytes(128, D, slots)
        cap = SMEM_BLOCK_MAX // per
        p = sweep_launch_plan(4096, 128, D, slots, H100_SMS)
        need = -(-4096 // H100_SMS)
        blocks = -(-need // cap)
        assert cap < 16 and p.warps_per_block == -(-need // blocks) <= cap
        assert p.smem_bytes <= SMEM_BLOCK_MAX


def test_sweep_wrapper_checks_the_lane_list():
    """``stepper_sweep(lanes=...)``: a list holding every RUNNING lane
    gives what the full launch gives; one that leaves a RUNNING lane out,
    names a lane twice or past the carry is refused (on the CPU as on the
    card)."""
    _, spec, N, arrays, starts = _inputs("kv9", 24, 6)
    m = sweep_model(spec, "cpu")
    tabs = sweep_tables(*arrays, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              64)
    stepper_sweep(m, tabs, carry, chunk=8, budget=BUDGET)
    running = np.flatnonzero(carry.dsi[1].numpy() == 0)
    assert 1 < running.size < LANES
    full, listed = (StepperCarry(*(t.clone() for t in carry))
                    for _ in range(2))
    stepper_sweep(m, tabs, full, chunk=CHUNK, budget=BUDGET)
    stepper_sweep(m, tabs, listed, chunk=CHUNK, budget=BUDGET,
                  lanes=running[::-1])
    assert all(torch.equal(x, y) for x, y in zip(full, listed))
    for bad, what in ((running[1:], "leaves out 1 RUNNING"),
                      (np.r_[running, running[:1]], "distinct"),
                      (np.r_[running, LANES], "distinct")):
        with pytest.raises(ValueError, match=what):
            stepper_sweep(m, tabs, carry, chunk=CHUNK, budget=BUDGET,
                          lanes=bad)


def test_sweep_model_refuses_what_the_kernel_cannot_run():
    class Wide(Spec):  # a vector state without a kernel model
        name = "wide"
        STATE_DIM = 3
        CMDS = (CmdSig("noop", 1, 1),)

    # what the kernel cannot run takes the generic route, on either device
    # (its placeholder data stays on the host: nothing reads it)
    for dev in ("cpu", "cuda"):
        for s in (Wide(), KvSpec(n_keys=29)):
            m = sweep_model(s, dev)
            assert (m.kind, m.route) == (0, "generic")
            assert m.data.device.type == "cpu"
    assert KvSpec(n_keys=29).sweep_kernel() is not None   # a kind, too wide
    m = sweep_model(KvSpec(n_keys=16), "cpu")
    assert (m.kind, m.params, m.route) == (2, (16, 4, 0), "kernel")
    assert sweep_model(KvSpec(n_keys=MAX_SWEEP_DIM), "cpu").route == "kernel"
    r = RandomVectorSpec(3, bounds=(3, 5))
    kind, params, data = r.sweep_kernel()
    assert kind == 6 and data[:2].tolist() == [3, 5]
    c, a, rr = params
    assert data.size == 2 + (3 + 3 + 5) * c * a * rr
    # a table-regime carry is refused
    _, spec, N, arrays, starts = _inputs("kv9", 24, 6)
    tabs = sweep_tables(*arrays, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              0)
    with pytest.raises(ValueError, match="runs sweep-regime carries"):
        stepper_sweep(m, tabs, carry._replace(states=torch.zeros(
            (N + 1, LANES), dtype=torch.int32)), chunk=1, budget=BUDGET)
