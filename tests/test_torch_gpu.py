"""On the card only (marker ``gpu``; run with ``pytest --noconftest -m gpu
tests/test_torch_gpu.py`` on a machine with an H100): the ``dfs_chunk``
kernel against its plain version, bit for bit on all seven carry planes,
under every launch plan (``nxt`` staged or read from global memory, the
memo off, in shared memory or in global memory, N = 12 and 32, a ragged
last block, start states outside the table), over 8 consecutive chunks at
the checker's 4096 lanes, and the checker at 256 lanes against the memo
oracle; ``stepper_chunk`` and ``compact_carry`` against their plain
versions on every carry plane (1 to 4 bitmask words, memo off, small and
large, the step table staged in shared memory or too large for it, and
under plans fixed by hand; the memo kept, grown, shrunk, created and
dropped), the stepper's C entry refusing plans it cannot launch, and
``TorchStepper`` on a queue corpus against the memo oracle; and
``stepper_sweep`` against its plain version (KV of 16 keys at 24, 64 and
96 ops, queue, stack, txn and a random vector spec, memo off, small and at
the checker's slot count, a 16-slot memo on every kind, args and start
states off the domains, plans fixed by hand, plans refused, a lane list
that leaves out a running lane refused), the compaction of sweep-regime carries,
and ``TorchStepper``'s sweep regime on KV histories against the memo
oracle per key; per-key decomposition over ``TorchStepper`` (KV of 16
keys, multireg, multicas) and the hybrid plan (CAS, queue) against the
host oracle, nothing undecided.  Without CUDA each test skips in its
fixture."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.dfs_kernel import (MEMO_GLOBAL, MEMO_OFF, MEMO_SHARED,
                                          RUNNING, Carry, dfs_chunk,
                                          dfs_chunk_plain, launch_plan)
from qsm_tpu_torch.ops.gpu_backend import TorchGPU, fresh_carry, lane_tables
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.corpus import build_corpus, random_lane_tables

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corpus():
    spec = CasSpec()
    return spec, build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=256,
                              n_pids=8, max_ops=32, seed_base=1000,
                              seed_prefix="bench")


def _assert_planes_equal(got: Carry, want: Carry, what: str) -> None:
    for name, a, b in zip(Carry._fields, got, want):
        assert torch.equal(a, b), f"{name} differs {what}"


@pytest.mark.parametrize("cs", [0, 64])
def test_kernel_matches_plain_version(cuda, corpus, cs):
    spec, hs = corpus
    tabs = lane_tables(spec, hs, 32, 256, cuda)
    carry = fresh_carry(tabs.nreq, np.zeros(len(hs), np.int32), 32, cs)
    for _ in range(2):
        before = dfs_chunk.launches
        got = dfs_chunk(tabs, carry, chunk=256, budget=552_000,
                        cache_slots=cs)
        torch.cuda.synchronize()
        assert dfs_chunk.launches == before + 1
        want = dfs_chunk_plain(tabs, carry, chunk=256, budget=552_000,
                               cache_slots=cs)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        carry = got


LANES_RAGGED = 300  # not a multiple of 32: the last block is part empty


def _scramble_empty_slots(carry: Carry) -> Carry:
    """Garbage key words and occupancy words other than 1 in the memo's
    empty slots: the kernel must hand them back as they came."""
    g = np.random.default_rng(9)
    occ = carry.occ.cpu().numpy().copy()
    ck0 = carry.ck0.cpu().numpy().copy()
    ck1 = carry.ck1.cpu().numpy().copy()
    empty = occ != 1
    n = int(empty.sum())
    ck0[empty] = g.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    ck1[empty] = g.integers(-5, 70, n).astype(np.int32)
    occ[empty] = g.choice(np.array([0, 2, -1], np.int32), n)
    dev = carry.occ.device
    return carry._replace(ck0=torch.from_numpy(ck0).to(dev),
                          ck1=torch.from_numpy(ck1).to(dev),
                          occ=torch.from_numpy(occ).to(dev))


@pytest.mark.parametrize("cs", [0, 64, 1024])
@pytest.mark.parametrize("n_states", [5, 64])
@pytest.mark.parametrize("n_ops", [12, 32])
def test_kernel_matches_plain_under_every_plan(cuda, n_ops, n_states, cs):
    B = LANES_RAGGED
    if n_states == 5:  # the CAS step tables: nxt staged in shared memory
        spec = CasSpec()
        hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=B,
                          n_pids=4 if n_ops == 12 else 8, max_ops=n_ops,
                          seed_base=77, seed_prefix="plan")
        tabs = lane_tables(spec, hs, n_ops, B, cuda)
        starts = np.zeros(B, np.int32)
    else:  # random tables too large to stage: nxt read from global memory
        tabs = random_lane_tables(n_ops, n_states, B, seed=n_ops,
                                  device=cuda)
        starts = np.random.default_rng(5).integers(0, n_states, B)
    starts[::7] = 7     # outside the CAS table (inside the random one)
    starts[3::11] = -2  # outside every table
    plan = launch_plan(B, n_ops, n_states, cs)
    assert plan.stage_nxt == (n_states == 5)
    want_memo = {0: MEMO_OFF, 64: MEMO_SHARED, 1024: MEMO_GLOBAL}[cs]
    assert plan.memo == want_memo
    carry = fresh_carry(tabs.nreq, starts.astype(np.int32), n_ops, cs)
    for k in range(3):
        if k == 1 and cs:
            carry = _scramble_empty_slots(carry)
        got = dfs_chunk(tabs, carry, chunk=256, budget=552_000,
                        cache_slots=cs)
        want = dfs_chunk_plain(tabs, carry, chunk=256, budget=552_000,
                               cache_slots=cs)
        torch.cuda.synchronize()
        _assert_planes_equal(got, want, f"after chunk {k + 1}")
        carry = got
    if cs:
        assert int((carry.occ == 1).sum()) > 0  # the memo was exercised


@pytest.mark.parametrize("cs", [0, 64])
def test_kernel_matches_plain_over_eight_chunks_at_4096_lanes(cuda, corpus,
                                                              cs):
    spec, hs = corpus
    B = 4096
    lanes = (hs * (B // len(hs)))[:B]
    tabs = lane_tables(spec, lanes, 32, B, cuda)
    got = want = fresh_carry(tabs.nreq, np.zeros(B, np.int32), 32, cs)
    for k in range(8):
        got = dfs_chunk(tabs, got, chunk=TorchGPU.CHUNK, budget=552_000,
                        cache_slots=cs)
        want = dfs_chunk_plain(tabs, want, chunk=TorchGPU.CHUNK,
                               budget=552_000, cache_slots=cs)
        torch.cuda.synchronize()
        _assert_planes_equal(got, want, f"after chunk {k + 1}")


def _launch(tabs, carry, out, cs, chunk, plan) -> int:
    """The C entry called directly: its return code."""
    from qsm_tpu_torch.ops.kernels import dfs_chunk_lib

    S, N, B = tabs.nxt.shape
    stream = torch.cuda.current_stream(tabs.nxt.device).cuda_stream
    return dfs_chunk_lib().dfs_chunk_launch(
        *(t.data_ptr() for t in tabs), *(t.data_ptr() for t in carry),
        *(t.data_ptr() for t in out), B, N, S, carry.ck0.shape[0], cs,
        chunk, 552_000, *(int(x) for x in plan), stream)


def test_kernel_keeps_decided_lanes_and_in_place_memo(cuda, corpus):
    """A lane decided before the launch comes out as it went in (stacks
    and memo included), and the memo planes may be the input's own."""
    spec, hs = corpus
    tabs = lane_tables(spec, hs, 32, 256, cuda)
    carry = fresh_carry(tabs.nreq, np.zeros(len(hs), np.int32), 32, 64)
    carry = dfs_chunk_plain(tabs, carry, chunk=512, budget=552_000,
                            cache_slots=64)
    decided = carry.dsi[1] != RUNNING
    assert 0 < int(decided.sum()) < 256
    want = dfs_chunk_plain(tabs, carry, chunk=256, budget=552_000,
                           cache_slots=64)
    inp = Carry(*(t.clone() for t in carry))
    out = Carry(*(torch.empty_like(t) for t in carry[:4]), *inp[4:])
    plan = launch_plan(256, 32, 5, 64)
    assert _launch(tabs, inp, out, 64, 256, plan) == 0
    torch.cuda.synchronize()
    _assert_planes_equal(out, want, "with decided lanes, memo in place")
    for a, b in zip(out[1:], carry[1:]):
        assert torch.equal(a[:, decided], b[:, decided])


def test_c_entry_refuses_a_plan_it_cannot_launch(cuda, corpus):
    spec, hs = corpus
    tabs = lane_tables(spec, hs, 32, 256, cuda)
    carry = fresh_carry(tabs.nreq, np.zeros(len(hs), np.int32), 32, 64)
    out = Carry(*(torch.empty_like(t) for t in carry))
    plan = launch_plan(256, 32, 5, 64)
    for bad in (plan._replace(smem_bytes=plan.smem_bytes - 4),
                plan._replace(lanes_per_block=64),
                plan._replace(grid=plan.grid + 1),
                plan._replace(memo=MEMO_OFF)):
        # cudaErrorInvalidValue: nothing launched
        assert _launch(tabs, carry, out, 64, 16, bad) == 1, bad
    # a 1024-slot memo staged beside nxt: the right sum, but above what
    # the device grants a block
    big = fresh_carry(tabs.nreq, np.zeros(len(hs), np.int32), 32, 1024)
    plan = launch_plan(256, 32, 5, 1024)
    assert plan.memo == MEMO_GLOBAL
    rows = 2 * 33 + 5 + 32 + 5 * 32 + 2 * 1024 + 1024 // 32
    over = plan._replace(memo=MEMO_SHARED, stage_nxt=True,
                         smem_bytes=rows * 128)
    assert over.smem_bytes > 232_448
    assert _launch(tabs, big, big, 1024, 16, over) == 1


def test_checker_matches_oracle_at_256_lanes(cuda, corpus):
    spec, hs = corpus
    g = TorchGPU(spec)
    before = dfs_chunk.launches
    gv = g.check_histories(spec, hs)
    assert dfs_chunk.launches > before and g.chunk_launches > 0
    ov = WingGongCPU(memo=True).check_histories(spec, hs)
    both = (gv != 2) & (ov != 2)
    assert int(((gv != ov) & both).sum()) == 0
    lin = [h for h, v in zip(hs, gv) if v == Verdict.LINEARIZABLE][:16]
    for h in lin:
        v, wit = g.check_witness(spec, h)
        assert v == Verdict.LINEARIZABLE and verify_witness(spec, h, wit)


# ---------------------------------------------------------------------------
# The lane-compacting stepper: stepper_chunk and compact_carry
# ---------------------------------------------------------------------------

def _stepper_inputs(model: str, n_ops: int, lanes: int, dev):
    from qsm_tpu_torch.core.history import encode_batch
    from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                            RacyTwoPhaseQueueSUT)
    from qsm_tpu_torch.ops.scalarize import scalar_shadow
    from qsm_tpu_torch.ops.stepper_kernel import stepper_tables

    if model == "queue":
        spec, suts = QueueSpec(), (AtomicQueueSUT, RacyTwoPhaseQueueSUT)
    elif model == "cas256":  # 256 values: a table too large to stage
        spec, suts = CasSpec(n_values=256), (AtomicCasSUT, RacyCasSUT)
    else:
        spec, suts = CasSpec(), (AtomicCasSUT, RacyCasSUT)
    hs = build_corpus(spec, suts, n=lanes, n_pids=8, max_ops=n_ops,
                      seed_base=1000, seed_prefix="bench")
    kspec = scalar_shadow(spec) or spec
    enc = encode_batch(hs, kspec.initial_state(), max_ops=n_ops)
    tabs = stepper_tables(kspec, enc.ops[:, :, 1], enc.ops[:, :, 2],
                          enc.ops[:, :, 3], enc.valid, enc.precedes(), dev)
    return tabs, int(enc.init_state[0])


def _clone(carry):
    return type(carry)(*(t.clone() for t in carry))


def _assert_stepper_equal(got, want, what: str) -> None:
    for name, a, b in zip(type(got)._fields, got, want):
        assert torch.equal(a, b), f"{name} differs {what}"


def _stepper_start(tabs, init, B, slots):
    from qsm_tpu_torch.ops.stepper_kernel import fresh_stepper_carry

    starts = np.full(B, init, np.int32)
    starts[::7] = tabs.vnxt.shape[0] + 3  # outside the table
    starts[3::11] = -2
    rows = np.random.default_rng(3).permutation(B)
    return fresh_stepper_carry(tabs.nreq, rows, starts[rows], B,
                               tabs.vocab.shape[1], slots)


def _scramble_stepper_memo(carry):
    """Occupancy words other than 1 on every other filled slot (a probe
    must miss it though its key is where its hash puts it), garbage keys
    in the empty slots."""
    g = np.random.default_rng(4)
    occ = carry.occ.cpu().numpy().copy()
    keys = carry.keys.cpu().numpy().copy()
    filled = np.argwhere(occ == 1)[::2]
    occ[filled[:, 0], filled[:, 1]] = g.choice(np.array([0, 2, -1], np.int32),
                                               len(filled))
    empty = occ == 0
    keys[empty] = g.integers(-2**31, 2**31, (int(empty.sum()), keys.shape[2]),
                             dtype=np.int64).astype(np.int32)
    dev = carry.occ.device
    return carry._replace(occ=torch.from_numpy(occ).to(dev),
                          keys=torch.from_numpy(keys).to(dev))


def _stepper_launch(tabs, carry, chunk, plan) -> int:
    """The stepper's C entry called directly with ``plan``: its return
    code."""
    from qsm_tpu_torch.ops.kernels import stepper_chunk_lib
    from qsm_tpu_torch.ops.stepper_kernel import n_words

    R, N = tabs.vocab.shape
    S, V = tabs.vnxt.shape
    B = carry.row.shape[0]
    stream = torch.cuda.current_stream(tabs.vocab.device).cuda_stream
    return stepper_chunk_lib().stepper_chunk_launch(
        *(t.data_ptr() for t in tabs), carry.row.data_ptr(),
        *(t.data_ptr() for t in carry[:6]), B, R, N, S, V, n_words(N),
        carry.occ.shape[1], chunk, 552_000, *(int(x) for x in plan), stream)


@pytest.mark.parametrize("slots", [0, 64, 8192])
@pytest.mark.parametrize("model,n_ops", [("queue", 48), ("cas", 32),
                                         ("cas", 64), ("cas", 96),
                                         ("cas", 128), ("cas256", 32)])
def test_stepper_chunk_matches_plain_version(cuda, model, n_ops, slots):
    from qsm_tpu_torch.ops.stepper_kernel import (
        device_sms, stepper_chunk, stepper_chunk_plain, stepper_launch_plan)

    B = 300  # a ragged last block
    tabs, init = _stepper_inputs(model, n_ops, B, cuda)
    plan = stepper_launch_plan(B, n_ops, *tabs.vnxt.shape,
                               device_sms(tabs.vocab.device))
    assert plan.stage_tables == (model != "cas256")
    carry = _stepper_start(tabs, init, B, slots)
    for k in range(3):
        if k == 1 and slots:
            carry = _scramble_stepper_memo(carry)
        got, want = _clone(carry), _clone(carry)
        before = stepper_chunk.launches
        stepper_chunk(tabs, got, chunk=512, budget=552_000)
        torch.cuda.synchronize()
        assert stepper_chunk.launches == before + 1
        stepper_chunk_plain(tabs, want, chunk=512, budget=552_000)
        _assert_stepper_equal(got, want, f"after chunk {k + 1}")
        carry = got
    if slots:
        assert int((carry.occ == 1).sum()) > 0


@pytest.mark.parametrize("slots", [0, 8192])
@pytest.mark.parametrize("warps,stage", [(1, True), (3, True), (16, True),
                                         (5, False), (16, False)])
def test_stepper_chunk_matches_plain_under_fixed_plans(cuda, warps, stage,
                                                       slots):
    from qsm_tpu_torch.ops.stepper_kernel import (StepperPlan,
                                                  stepper_chunk_plain,
                                                  table_bytes,
                                                  warp_stack_bytes)

    B = 300
    tabs, init = _stepper_inputs("queue", 48, B, cuda)
    smem = ((table_bytes(*tabs.vnxt.shape) if stage else 0)
            + warps * warp_stack_bytes(48))
    plan = StepperPlan(warps, -(-B // warps), stage, smem)
    carry = _stepper_start(tabs, init, B, slots)
    for k in range(2):
        if k and slots:
            carry = _scramble_stepper_memo(carry)
        got, want = _clone(carry), _clone(carry)
        assert _stepper_launch(tabs, got, 512, plan) == 0
        torch.cuda.synchronize()
        stepper_chunk_plain(tabs, want, chunk=512, budget=552_000)
        _assert_stepper_equal(got, want, f"after chunk {k + 1} under {plan}")
        carry = got


def test_stepper_c_entry_refuses_a_plan_it_cannot_launch(cuda):
    from qsm_tpu_torch.ops.stepper_kernel import (device_sms,
                                                  stepper_launch_plan)

    B = 300
    tabs, init = _stepper_inputs("queue", 48, B, cuda)
    carry = _stepper_start(tabs, init, B, 64)
    plan = stepper_launch_plan(B, 48, *tabs.vnxt.shape,
                               device_sms(tabs.vocab.device))
    for bad in (plan._replace(smem_bytes=plan.smem_bytes - 4),
                plan._replace(grid=plan.grid + 1),
                plan._replace(warps_per_block=plan.warps_per_block + 1),
                plan._replace(stage_tables=False)):
        assert _stepper_launch(tabs, carry, 16, bad) == 1, bad  # invalid
    big, init = _stepper_inputs("cas256", 32, B, cuda)
    carry = _stepper_start(big, init, B, 64)
    plan = stepper_launch_plan(B, 32, *big.vnxt.shape,
                               device_sms(big.vocab.device))
    S, V = big.vnxt.shape
    over = plan._replace(stage_tables=True, smem_bytes=plan.smem_bytes
                         + 4 * S * (V + -(-V // 32)))
    assert over.smem_bytes > 232_448
    assert _stepper_launch(big, carry, 16, over) == 1


@pytest.mark.parametrize("old_slots,slots", [(64, 64), (64, 8192),
                                             (8192, 64), (0, 8192),
                                             (64, 0)])
def test_compact_carry_matches_plain_version(cuda, old_slots, slots):
    from qsm_tpu_torch.ops.stepper_kernel import (
        RUNNING, compact_carry, compact_carry_plain, fresh_stepper_carry,
        stepper_chunk)

    B = 1024
    tabs, init = _stepper_inputs("queue", 48, B, cuda)
    carry = fresh_stepper_carry(tabs.nreq, np.arange(B),
                                np.full(B, init, np.int32), B, 48,
                                old_slots)
    stepper_chunk(tabs, carry, chunk=256, budget=552_000)
    running = torch.nonzero(carry.dsi[1] == RUNNING)[:, 0].cpu().numpy()
    lanes = np.random.default_rng(1).permutation(running)[:200]
    assert lanes.size > 50
    before = compact_carry.launches
    got = compact_carry(carry, lanes, 256, slots)
    torch.cuda.synchronize()
    assert compact_carry.launches == before + 1
    want = compact_carry_plain(carry, lanes, 256, slots)
    _assert_stepper_equal(got, want, f"{old_slots} -> {slots} slots")


def test_stepper_checker_matches_oracle(cuda):
    from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                            RacyTwoPhaseQueueSUT)
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.ops.stepper_kernel import compact_carry, stepper_chunk

    spec = QueueSpec()
    hs = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT), n=600,
                      n_pids=8, max_ops=48, seed_base=1000,
                      seed_prefix="bench")
    t = TorchStepper(spec)
    before = stepper_chunk.launches, compact_carry.launches
    v = t.check_histories(spec, hs)
    assert stepper_chunk.launches > before[0]
    assert compact_carry.launches > before[1] and t.compactions > 0
    ov = WingGongCPU(memo=True).check_histories(spec, hs)
    both = (v != 2) & (ov != 2)
    assert int(both.sum()) > 500
    assert int(((v != ov) & both).sum()) == 0
    lin = [h for h, x in zip(hs, v) if x == Verdict.LINEARIZABLE][:16]
    for h in lin:
        wv, wit = t.check_witness(spec, h)
        assert wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit)


# -- the stepper's sweep regime (stepper_sweep) ----------------------------

def _sweep_inputs(name: str, n_ops: int, B: int, cuda, odd: bool = False):
    """(spec, model, tables, start states) for B lanes of ``name``: the
    KV map of 16 and of 5 keys, queue and stack of capacity 8, txn(8, 8), a
    random vector spec of 9 elements; with ``odd`` args and start states
    outside the declared domains."""
    import random

    from qsm_tpu_torch.core.history import encode_batch
    from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
    from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                            RacyTwoPhaseQueueSUT)
    from qsm_tpu_torch.models.stack import (AtomicStackSUT,
                                            RacyTwoPhaseStackSUT, StackSpec)
    from qsm_tpu_torch.models.txn import (AtomicTxnSUT, TornCopyTxnSUT,
                                          TxnRegisterSpec)
    from qsm_tpu_torch.ops.sweep_kernel import sweep_model, sweep_tables
    from qsm_tpu_torch.utils.fuzz import RandomVectorSpec, random_history

    specs = {"kv16": (KvSpec(n_keys=16), (AtomicKvSUT, StaleCacheKvSUT)),
             # a state width without a hash instantiation of its own
             "kv5": (KvSpec(n_keys=5), (AtomicKvSUT, StaleCacheKvSUT)),
             "queue8": (QueueSpec(capacity=8),
                        (AtomicQueueSUT, RacyTwoPhaseQueueSUT)),
             "stack8": (StackSpec(capacity=8),
                        (AtomicStackSUT, RacyTwoPhaseStackSUT)),
             "txn8": (TxnRegisterSpec(8, 8), (AtomicTxnSUT, TornCopyTxnSUT)),
             "random9": (RandomVectorSpec(5, bounds=(4,) * 9), None)}
    spec, suts = specs[name]
    if suts is None:
        rng = random.Random("gpu-sweep")
        hs = [random_history(spec, rng, 6, n_ops) for _ in range(128)]
    else:
        hs = build_corpus(spec, suts, n=128, n_pids=8, max_ops=n_ops,
                          seed_base=1000, seed_prefix="bench")
    hs = (hs * (-(-B // len(hs))))[:B]
    enc = encode_batch(hs, spec.initial_state(), max_ops=n_ops)
    cmd, arg, resp = (enc.ops[:, :, k].copy() for k in (1, 2, 3))
    starts = np.tile(np.asarray(enc.init_state, np.int32), (B, 1))
    if odd:
        g = np.random.default_rng(8)
        wild = g.random(arg.shape) < 0.05
        arg[wild] = g.integers(-40, 80, int(wild.sum()))
        starts[::7] = g.integers(-3, 12, starts[::7].shape)
    tabs = sweep_tables(cmd, arg, resp, enc.valid, enc.precedes(), cuda)
    return spec, sweep_model(spec, cuda), tabs, starts


@pytest.mark.parametrize("slots", [0, 64, 2048])
@pytest.mark.parametrize("name,n_ops,odd", [
    ("kv16", 64, False), ("kv16", 24, True), ("kv16", 96, False),
    ("queue8", 48, False), ("stack8", 48, True), ("txn8", 32, True),
    ("random9", 48, False), ("kv5", 40, True)])
def test_stepper_sweep_matches_plain_version(cuda, name, n_ops, odd, slots):
    from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry,
                                                stepper_sweep,
                                                stepper_sweep_plain)

    B = 300  # a ragged last block
    spec, model, tabs, starts = _sweep_inputs(name, n_ops, B, cuda, odd)
    rows = np.random.default_rng(3).permutation(B)
    carry = fresh_sweep_carry(tabs.nreq, rows, starts[rows], B, n_ops, slots)
    for k in range(3):
        got, want = _clone(carry), _clone(carry)
        before = stepper_sweep.launches
        stepper_sweep(model, tabs, got, chunk=384, budget=552_000)
        torch.cuda.synchronize()
        assert stepper_sweep.launches == before + 1
        stepper_sweep_plain(spec, tabs, want, chunk=384, budget=552_000)
        _assert_stepper_equal(got, want, f"after chunk {k + 1}")
        carry = got
    if slots:
        assert int((carry.occ == 1).sum()) > 0


def _sweep_launch(cuda, model, tabs, c, p, lanes=None, stats=None):
    """``stepper_sweep``'s C entry under the plan ``p``: 384 iterations;
    ``lanes`` an int32 tensor on the card or None for every lane."""
    from qsm_tpu_torch.ops.kernels import stepper_sweep_lib
    from qsm_tpu_torch.ops.stepper_kernel import n_words

    R, N = tabs.cmd.shape
    B, D = c.row.shape[0], c.states.shape[2]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    return stepper_sweep_lib().stepper_sweep_launch(
        *(t.data_ptr() for t in tabs), model.data.data_ptr(),
        c.row.data_ptr(), *(t.data_ptr() for t in c[:6]),
        None if lanes is None else lanes.data_ptr(),
        None if stats is None else stats.data_ptr(), B, R, N, n_words(N), D,
        c.occ.shape[1], 384, 552_000, model.kind, *model.params,
        B if lanes is None else lanes.numel(), *(int(x) for x in p), stream)


@pytest.mark.parametrize("warps", [1, 5, 16])
def test_stepper_sweep_matches_plain_under_fixed_plans(cuda, warps):
    from qsm_tpu_torch.ops.sweep_kernel import (SweepPlan, fresh_sweep_carry,
                                                stepper_sweep_plain,
                                                sweep_launch_plan,
                                                sweep_warp_bytes)

    B, N = 300, 64
    spec, model, tabs, starts = _sweep_inputs("kv16", N, B, cuda)
    carry = fresh_sweep_carry(tabs.nreq, np.arange(B), starts, B, N, 2048)
    plan = SweepPlan(warps, -(-B // warps),
                     warps * sweep_warp_bytes(N, 16, 2048))
    got, want = _clone(carry), _clone(carry)
    assert _sweep_launch(cuda, model, tabs, got, plan) == 0
    torch.cuda.synchronize()
    stepper_sweep_plain(spec, tabs, want, chunk=384, budget=552_000)
    _assert_stepper_equal(got, want, f"under {plan}")
    good = sweep_launch_plan(B, N, 16, 2048, 132)
    for bad in (good._replace(smem_bytes=good.smem_bytes - 4),
                good._replace(grid=good.grid + 1),
                good._replace(warps_per_block=17)):
        assert _sweep_launch(cuda, model, tabs, _clone(carry), bad) == 1, bad


@pytest.mark.parametrize("name,n_ops", [("kv16", 48), ("queue8", 48),
                                        ("stack8", 48), ("txn8", 32),
                                        ("random9", 48), ("kv5", 40)])
def test_stepper_sweep_matches_plain_with_a_16_slot_memo(cuda, name, n_ops):
    """Every kind, a few chunks at a small width with 16 memo slots a
    lane: slots overwritten and filter tags colliding, the filter rebuilt
    from the carry's memo at every launch; the running lanes alone, as the
    main path launches them."""
    from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry,
                                                stepper_sweep,
                                                stepper_sweep_plain)

    B = 160
    spec, model, tabs, starts = _sweep_inputs(name, n_ops, B, cuda)
    carry = fresh_sweep_carry(tabs.nreq, np.arange(B), starts, B, n_ops, 16)
    for k in range(4):
        got, want = _clone(carry), _clone(carry)
        run = torch.nonzero(got.dsi[1] == RUNNING)[:, 0].cpu().numpy()
        stepper_sweep(model, tabs, got, chunk=384, budget=552_000,
                      lanes=run)
        torch.cuda.synchronize()
        stepper_sweep_plain(spec, tabs, want, chunk=384, budget=552_000)
        _assert_stepper_equal(got, want, f"after chunk {k + 1}")
        carry = got
    assert int(carry.dsi[4].sum()) > int((carry.occ == 1).sum())


def test_stepper_sweep_refuses_a_lane_list_without_a_running_lane(cuda):
    """A lane list that leaves out a RUNNING lane is refused before any
    launch (the carry is left as it was); the full list launches."""
    from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry,
                                                stepper_sweep)

    B = 128
    spec, model, tabs, starts = _sweep_inputs("kv16", 48, B, cuda)
    carry = fresh_sweep_carry(tabs.nreq, np.arange(B), starts, B, 48, 64)
    run = torch.nonzero(carry.dsi[1] == RUNNING)[:, 0].cpu().numpy()
    assert run.size > 2
    before, launches = _clone(carry), stepper_sweep.launches
    with pytest.raises(ValueError, match="leaves out 1 RUNNING"):
        stepper_sweep(model, tabs, carry, chunk=384, budget=552_000,
                      lanes=run[1:])
    assert stepper_sweep.launches == launches
    _assert_stepper_equal(carry, before, "after a refused launch")
    stepper_sweep(model, tabs, carry, chunk=384, budget=552_000, lanes=run)
    assert stepper_sweep.launches == launches + 1


@pytest.mark.parametrize("old_slots,slots", [(2048, 32768), (2048, 2048),
                                             (2048, 64), (0, 2048),
                                             (2048, 0)])
def test_compact_carry_of_a_sweep_carry_matches_plain(cuda, old_slots,
                                                      slots):
    from qsm_tpu_torch.ops.stepper_kernel import (RUNNING, compact_carry,
                                                  compact_carry_plain)
    from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry,
                                                stepper_sweep)

    B = 1024
    spec, model, tabs, starts = _sweep_inputs("kv16", 64, B, cuda)
    carry = fresh_sweep_carry(tabs.nreq, np.arange(B), starts, B, 64,
                              old_slots)
    stepper_sweep(model, tabs, carry, chunk=256, budget=552_000)
    running = torch.nonzero(carry.dsi[1] == RUNNING)[:, 0].cpu().numpy()
    lanes = np.random.default_rng(1).permutation(running)[:200]
    assert lanes.size > 50
    got = compact_carry(carry, lanes, 256, slots)
    torch.cuda.synchronize()
    want = compact_carry_plain(carry, lanes, 256, slots)
    _assert_stepper_equal(got, want, f"{old_slots} -> {slots} slots")


def test_sweep_checker_matches_per_key_oracle(cuda):
    """``TorchStepper`` in its sweep regime on KV histories of 16 keys:
    every verdict it decides is the port's memo oracle's on each key's
    register sub-history (the keys of a KV map are independent)."""
    from qsm_tpu_torch.core.history import History, Op
    from qsm_tpu_torch.models.kv import (GET, AtomicKvSUT, KvSpec,
                                         StaleCacheKvSUT)
    from qsm_tpu_torch.models.register import RegisterSpec
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.ops.sweep_kernel import stepper_sweep

    spec = KvSpec(n_keys=16)
    hs = build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT), n=300,
                      n_pids=16, max_ops=48, seed_base=7,
                      seed_prefix="bench")
    t = TorchStepper(spec, budget=20_000, mid_budget=0, rescue_budget=0)
    assert t.regime == "sweep"
    before = stepper_sweep.launches
    v = t.check_histories(spec, hs)
    assert stepper_sweep.launches > before
    reg, oracle = RegisterSpec(n_values=4), WingGongCPU(memo=True)
    for h, got in zip(hs, v):
        keys = {}
        for o in h.ops:
            key, val = (o.arg, 0) if o.cmd == GET else divmod(o.arg, 4)
            keys.setdefault(key, []).append(Op(
                o.pid, o.cmd, val, o.resp, o.invoke_time, o.response_time))
        sub = oracle.check_histories(reg, [History(ops)
                                           for ops in keys.values()])
        assert (sub != Verdict.BUDGET_EXCEEDED).all()
        want = (Verdict.VIOLATION if (sub == Verdict.VIOLATION).any()
                else Verdict.LINEARIZABLE)
        if got != Verdict.BUDGET_EXCEEDED:
            assert int(got) == int(want)
    assert int((v == Verdict.LINEARIZABLE).sum()) > 100
    lin = [h for h, x in zip(hs, v) if x == Verdict.LINEARIZABLE][:8]
    for h in lin:
        wv, wit = t.check_witness(spec, h)
        assert wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit)


@pytest.mark.parametrize("model,kw", [("kv", {"n_keys": 16}),
                                      ("multireg", None),
                                      ("multicas", None)])
def test_pcomp_over_the_stepper_decides_every_history(cuda, model, kw):
    """``PComp`` over ``TorchStepper`` on CUDA: the sub-histories run in
    the table regime's kernels, no history is left undecided, and the
    verdicts and stitched witnesses are the host path's."""
    from qsm_tpu_torch.models.registry import MODELS, make
    from qsm_tpu_torch.ops.pcomp import PComp
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk

    spec, _ = make(model, "atomic", kw)
    entry = MODELS[model]
    hs = build_corpus(spec, (entry.impls["atomic"], entry.impls["racy"]),
                      n=256, n_pids=16, max_ops=64, seed_base=1000,
                      seed_prefix="bench")
    pc = PComp(spec, lambda p: TorchStepper(p))
    assert pc.inner.regime == "table"
    before = stepper_chunk.launches
    v = pc.check_histories(spec, hs)
    assert stepper_chunk.launches > before
    assert (v != Verdict.BUDGET_EXCEEDED).all()
    np.testing.assert_array_equal(v, PComp(spec).check_histories(spec, hs))
    assert (v == Verdict.VIOLATION).any() and (v == Verdict.LINEARIZABLE).any()
    for h in [h for h, x in zip(hs, v) if x == Verdict.LINEARIZABLE][:4]:
        wv, wit = pc.check_witness(spec, h)
        assert wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit)


@pytest.mark.parametrize("model", ["cas", "queue"])
def test_hybrid_device_matches_host_oracle(cuda, model):
    """``HybridDevice`` on CUDA: the device decides most histories at a
    budget of 2000, the host tail the rest, and the verdicts are the host
    checker's, nothing undecided, no degrade."""
    from qsm_tpu_torch.models.registry import MODELS
    from qsm_tpu_torch.ops.hybrid import HybridDevice
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk
    from qsm_tpu_torch.resilience.failover import host_fallback

    entry = MODELS[model]
    spec = entry.make_spec()
    hs = build_corpus(spec, (entry.impls["atomic"], entry.impls["racy"]),
                      n=256, n_pids=entry.default_pids,
                      max_ops=entry.default_ops, seed_base=1000,
                      seed_prefix="bench")
    hb = HybridDevice(spec)
    before = stepper_chunk.launches
    v = hb.check_histories(spec, hs)
    assert stepper_chunk.launches > before
    assert hb.degradations == 0 and hb.device_decided > 0
    assert hb.device_decided + hb.tail_histories == len(hs)
    assert (v != Verdict.BUDGET_EXCEEDED).all()
    np.testing.assert_array_equal(
        v, host_fallback(spec).check_histories(spec, hs))


def test_hybrid_device_raises_a_device_error_on_the_card(cuda, monkeypatch):
    """On CUDA a device error raises out of ``HybridDevice``: the batch
    never moves to the host tail, and nothing records a degrade."""
    from qsm_tpu_torch.ops.backend import BackendUnavailable
    from qsm_tpu_torch.ops.hybrid import HybridDevice

    spec = CasSpec()
    hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=4, n_pids=4,
                      max_ops=16, seed_base=1000, seed_prefix="bench")
    hb = HybridDevice(spec)

    def lost(*a, **kw):
        raise BackendUnavailable("card lost")

    monkeypatch.setattr(hb.device, "check_histories", lost)
    with pytest.raises(BackendUnavailable):
        hb.check_histories(spec, hs)
    with pytest.raises(BackendUnavailable):
        hb.check_witness(spec, hs[0])
    assert not hb.degraded and hb.degradations == 0
    assert hb.tail_histories == 0
