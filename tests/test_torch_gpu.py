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
host oracle, nothing undecided; ``threefry_draws`` against its plain
version (seven seeds, eight shapes: one word, rows that take 4-byte
stores, the main path's 1024 x 816, more units than the grid; tables off
a 16-byte boundary) and the known answers of the JAX package's table,
``table_to_host``'s pinned copy, ``generate_batch`` on CUDA equal to the
``device="cpu"`` call, and one ``SteeringLoop``
round over ``HybridDevice`` whose verdicts are ``CppOracle``'s; the search
plane: ``SegDC``'s final segments from frontier states other than the
initial one (table and sweep regimes), ordered ``TorchStepper`` and
``TorchGPU`` witnesses, ``AutoDevice`` routing, each first launch held
against the plain version; ``build_kernel``'s ``check_one`` at budget
500,000 with and without the memo, ``FailoverBackend`` degrading on an
injected fault (its launches from the watchdog's thread on the caller's
stream) and raising on a real device error (the card's rule), a
shrinker's frontier batch through ``TorchStepper``, and the ``shrink``
entry point on the card equal to its host run; the monitor's window
re-check batched on the card equal to the host loop (CAS, KV per key),
and ``ingest --check`` on the card; the check server on the card by
default, its answer to a real device error and its degrade on an injected
one, and ``DrainScheduler`` on the card; two nodes on the card behind a
``FleetRouter`` routing with ``CppOracle``'s verdicts, the router's
ladder launching ``stepper_chunk`` once every node is gone, and two nodes
started at once on a cold build directory loading one library; and the
port's static checks on the card: families a and b (parity on the card,
the rebuild guard's backends, the ptxas reports), each kernel's edge launch
counted and bit-identical to its plain version, the seeded rebuilding
backend caught, and ``lint`` on the card by default.  Without CUDA each
test skips in its fixture."""

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


# the known answers of the JAX package's ``_raw_draws_jax`` (seed, shape,
# rows), taken on the CPU with JAX 0.9.0
KNOWN_DRAWS = [
    (7, (3, 5), {0: [3725328165, 2389352394, 1291398195, 1428036129,
                     4260943734]}),
    (-3, (2, 3), {0: [2585318788, 4151447820, 471961339],
                  1: [2707064578, 2513172215, 3288622452]}),
    (2**32 + 5, (2, 3), {0: [2839113055, 3758129494, 1086722469],
                         1: [359975681, 984463424, 482527479]}),
]


@pytest.mark.parametrize("seed", [0, 7, 17, 2**31, 2**32 + 5, -3,
                                  1_000_004])
@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (33, 17), (9, 33),
                                   (3, 4097), (1024, 816), (4096, 624),
                                   (65537, 3)])
def test_threefry_draws_matches_plain_version(cuda, seed, shape):
    """``threefry_draws`` on CUDA against its plain version on the card,
    every word equal (tolerance 0), one launch counted a call: one word,
    rows that are not a multiple of the 16-word unit or of 4 (4-byte
    stores), the main path's 1024 x 816 and 4096 lanes, more units than
    the grid."""
    from qsm_tpu_torch.ops.draws_kernel import (raw_draws, raw_draws_plain,
                                                threefry_draws)

    before = threefry_draws.launches
    got = raw_draws(seed, *shape, device=cuda)
    torch.cuda.synchronize()
    assert threefry_draws.launches == before + 1
    assert torch.equal(got, raw_draws_plain(seed, *shape, device=cuda))


def test_threefry_draws_known_answers(cuda):
    """The kernel's table equals the JAX package's ``_raw_draws_jax``: the
    known rows, and seed 17 at 4096 x 3120 by its corners, XOR and sum."""
    from qsm_tpu_torch.ops.draws_kernel import raw_draws

    for seed, shape, rows in KNOWN_DRAWS:
        t = raw_draws(seed, *shape, device=cuda).cpu().numpy().view(
            np.uint32)
        for i, row in rows.items():
            assert t[i].tolist() == row, (seed, i)
    t = raw_draws(17, 4096, 3120, device=cuda).cpu().numpy().view(np.uint32)
    assert t[0, :4].tolist() == [2639664804, 3479077941, 2518621796,
                                 1267003793]
    assert t[4095, -4:].tolist() == [1348504043, 1475632984, 2031686271,
                                     3777973134]
    assert int(np.bitwise_xor.reduce(t.ravel())) == 3671365389
    assert int(t.astype(np.uint64).sum() % 2**32) == 4283564019


@pytest.mark.parametrize("shape", [(64, 816), (5, 3120), (3, 4)])
def test_threefry_draws_on_a_misaligned_table(cuda, shape):
    """A table 4 bytes off a 16-byte boundary takes the 4-byte-store
    instantiation (an aligned one the 16-byte one), every word right and
    nothing around the table written."""
    from qsm_tpu_torch.ops.draws_kernel import (draws_plan, raw_draws_plain,
                                                threefry_draws)

    n = shape[0] * shape[1]
    buf = torch.full((n + 4,), 12345, dtype=torch.int32, device=cuda)
    out = buf[1:1 + n].view(shape)
    assert not draws_plan(out).vector
    assert draws_plan(torch.empty(shape, dtype=torch.int32,
                                  device=cuda)).vector
    threefry_draws(out, 11)
    torch.cuda.synchronize()
    assert torch.equal(out, raw_draws_plain(11, *shape, device=cuda))
    assert int(buf[0]) == 12345 and (buf[1 + n:] == 12345).all()


def test_table_to_host_copies_through_pinned_memory(cuda):
    """The copy to the host: a pinned array equal to the plain table, and
    a second call leaves the first call's array as it was."""
    from qsm_tpu_torch.ops.draws_kernel import (raw_draws, raw_draws_plain,
                                                table_to_host)

    first = table_to_host(raw_draws(17, 1024, 816, device=cuda))
    kept = first.copy()
    assert first.dtype == np.uint32 and torch.from_numpy(first).is_pinned()
    np.testing.assert_array_equal(
        first, raw_draws_plain(17, 1024, 816).numpy().view(np.uint32))
    for seed in (18, 19):
        other = table_to_host(raw_draws(seed, 1024, 816, device=cuda))
        np.testing.assert_array_equal(
            other, raw_draws_plain(seed, 1024, 816).numpy().view(np.uint32))
        del other  # its pinned block goes back to the allocator's cache
    np.testing.assert_array_equal(first, kept)


def test_reserved_host_block_serves_the_next_copy(cuda):
    """``reserve_host_table`` pins and frees a block; the copy of that
    size that follows is pinned and equal to the plain table."""
    from qsm_tpu_torch.ops.draws_kernel import (raw_draws, raw_draws_plain,
                                                reserve_host_table,
                                                table_to_host)

    assert reserve_host_table(300, 816, cuda) is None
    got = table_to_host(raw_draws(23, 300, 816, device=cuda))
    assert torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(
        got, raw_draws_plain(23, 300, 816).numpy().view(np.uint32))


@pytest.mark.parametrize("model", ["rangeset", "semaphore", "register"])
def test_generate_batch_on_cuda_equals_the_cpu_call(cuda, model):
    """``generate_batch`` on the ``"jax"`` and ``"auto"`` paths launches
    the kernel and gives the histories of the ``device="cpu"`` call."""
    from qsm_tpu_torch.gen import GenProfile, generate_batch
    from qsm_tpu_torch.models.registry import MODELS
    from qsm_tpu_torch.ops.draws_kernel import threefry_draws

    spec = MODELS[model].make_spec()
    profile = GenProfile(n_pids=8, n_ops=32, key_skew=1.0, p_pending=0.05,
                         p_adverse=0.05)
    want = [h.fingerprint() for h in generate_batch(
        spec, profile, 17, 64, path="jax", device="cpu")]
    for path in ("jax", "auto"):
        before = threefry_draws.launches
        got = generate_batch(spec, profile, 17, 64, path=path)
        assert threefry_draws.launches == before + 1
        assert [h.fingerprint() for h in got] == want


def test_steering_round_over_the_hybrid_plan_matches_the_host_oracle(
        cuda, monkeypatch):
    """One ``SteeringLoop`` round over ``HybridDevice`` on the card: the
    table comes from the kernel, the check launches ``stepper_chunk``, and
    the round's verdicts are ``CppOracle``'s, nothing undecided."""
    from qsm_tpu_torch.gen import GenProfile, SteeringLoop
    from qsm_tpu_torch.models.registry import MODELS
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops.draws_kernel import threefry_draws
    from qsm_tpu_torch.ops.hybrid import HybridDevice
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk

    spec = MODELS["rangeset"].make_spec()
    hb = HybridDevice(spec)
    seen = []
    check = hb.check_histories

    def recording(spec_, hs):
        v = check(spec_, hs)
        seen.append((hs, v))
        return v

    monkeypatch.setattr(hb, "check_histories", recording)
    loop = SteeringLoop(spec, hb, profile=GenProfile(n_pids=8, n_ops=32),
                        batch=256, seed=17, path="auto")
    draws, steps = threefry_draws.launches, stepper_chunk.launches
    report = loop.round()
    assert threefry_draws.launches == draws + 1
    assert stepper_chunk.launches > steps
    (hs, v), = seen
    assert (v != Verdict.BUDGET_EXCEEDED).all()
    np.testing.assert_array_equal(v, CppOracle(spec).check_histories(spec,
                                                                     hs))
    assert report["flips"] == int((v == Verdict.VIOLATION).sum())


# ---------------------------------------------------------------------------
# the search plane: SegDC's final segments, ordering, AutoDevice
# ---------------------------------------------------------------------------


class _FirstLaunch:
    """Stands in for a kernel wrapper that a backend module calls by name:
    the inputs of the first launch are kept (the carry cloned before the
    launch), and every launch still goes through the wrapper, which counts
    it once."""

    def __init__(self, monkeypatch, module, name: str):
        self.fn = getattr(module, name)
        self.first = None
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kw):
        if self.first is None:
            self.first = (args[:-1], _clone(args[-1]), dict(kw))
        return self.fn(*args, **kw)

    def hold(self, plain, what: str):
        """One launch of the kernel from the kept inputs against ``plain``
        (called with the same tables, carry and counters), every carry
        plane equal.  Returns the kept fresh carry."""
        args, c0, kw = self.first
        got, want = _clone(c0), _clone(c0)
        self.fn(*args, got, **kw)
        torch.cuda.synchronize()
        plain(got, want, args, kw)
        _assert_stepper_equal(got, want, what)
        return c0


def _hold_stepper_chunk(rec, what):
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk_plain

    return rec.hold(lambda got, want, args, kw: stepper_chunk_plain(
        *args, want, chunk=kw["chunk"], budget=kw["budget"]), what)


def _agree_with_cpp(spec, hs, v):
    """Every verdict decided on the card is ``CppOracle``'s."""
    from qsm_tpu_torch.native import CppOracle

    ref = CppOracle(spec).check_histories(spec, hs)
    both = (v != Verdict.BUDGET_EXCEEDED) & (ref != Verdict.BUDGET_EXCEEDED)
    assert both.sum() > len(hs) // 2
    np.testing.assert_array_equal(v[both], ref[both])


@pytest.mark.parametrize("regime", ["table", "sweep"])
def test_segdc_final_segments_from_frontier_states(cuda, monkeypatch,
                                                   regime):
    """``SegDC`` over ``TorchStepper`` on the card: the final segments of
    the cut histories go to the device in one batch, lanes starting from
    frontier states other than the initial one (CAS in the table regime,
    a queue of capacity 8 in the sweep regime); the first launch is the
    plain version's, bit for bit, and the verdicts are ``CppOracle``'s."""
    from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                            RacyTwoPhaseQueueSUT)
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.ops.segdc import SegDC
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.ops.sweep_kernel import stepper_sweep_plain

    if regime == "table":
        spec = CasSpec()
        hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=256,
                          n_pids=8, max_ops=32, seed_base=1000,
                          seed_prefix="bench")
        name = "stepper_chunk"
    else:
        spec = QueueSpec(capacity=8)
        hs = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=256, n_pids=4, max_ops=48, seed_base=1000,
                          seed_prefix="bench")
        name = "stepper_sweep"
    sd = SegDC(spec, make_inner=lambda q: TorchStepper(q))
    assert sd.device_final and sd.inner.regime == regime
    rec = _FirstLaunch(monkeypatch, stepper_module, name)
    v = sd.check_histories(spec, hs)
    assert sd.final_states_device > 0 and rec.first is not None
    _agree_with_cpp(spec, hs, v)
    what = "on the first batch of final segments"
    if regime == "table":
        c0 = _hold_stepper_chunk(rec, what)
        starts = c0.states[0].cpu().numpy()
        init = int(spec.initial_state()[0])
    else:
        c0 = rec.hold(lambda got, want, args, kw: stepper_sweep_plain(
            spec, args[1], want, chunk=kw["chunk"], budget=kw["budget"]),
            what)
        starts = c0.states[:, 0].cpu().numpy()
        init = np.asarray(spec.initial_state(), np.int32)
    running = (c0.dsi[1] == RUNNING).cpu().numpy()
    assert ((starts != init).reshape(len(running), -1).any(1)
            & running).any()


@pytest.mark.parametrize("engine", ["stepper", "gpu"])
def test_ordered_witnesses_replay_on_the_card(cuda, monkeypatch, corpus,
                                              engine):
    """``TorchStepper(ordering=True)`` and ``TorchGPU(ordering=True)`` on
    the card: each history's ops run in selectivity order, the verdicts
    are the unordered engine's and ``CppOracle``'s, the witnesses map
    back to the original op indices and replay, and the first launch of
    the ordered batch is the plain version's."""
    from qsm_tpu_torch.ops import gpu_backend as gpu_module
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.ops.stepper import TorchStepper

    spec, hs = corpus
    if engine == "stepper":
        make, module, name = TorchStepper, stepper_module, "stepper_chunk"
    else:
        make, module, name = TorchGPU, gpu_module, "dfs_chunk"
    ordered = make(spec, ordering=True)
    rec = _FirstLaunch(monkeypatch, module, name)
    v = ordered.check_histories(spec, hs)
    if engine == "stepper":
        assert ordered.search_stats().ordering
        _hold_stepper_chunk(rec, "on the first ordered batch")
    else:
        rec.hold(lambda got, want, args, kw: dfs_chunk_plain(
            *args, want, **kw), "on the first ordered batch")
    plain = make(spec).check_histories(spec, hs)
    both = (v != Verdict.BUDGET_EXCEEDED) & (plain != Verdict.BUDGET_EXCEEDED)
    np.testing.assert_array_equal(v[both], plain[both])
    _agree_with_cpp(spec, hs, v)
    lin = [h for h, x in zip(hs, v) if x == Verdict.LINEARIZABLE][:8]
    assert lin
    for h in lin:
        wv, wit = ordered.check_witness(spec, h)
        assert wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit)


def test_auto_device_routes_both_ways_on_the_card(cuda, monkeypatch):
    """``AutoDevice`` on the card: a queue corpus of narrow and wide
    middle segments is routed as the plain versions route it (both routes
    taken), one ``TorchStepper`` serves both routes, the verdicts are
    ``CppOracle``'s, and its first launch is the plain version's."""
    from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                            RacyTwoPhaseQueueSUT)
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.ops.router import AutoDevice

    spec = QueueSpec()
    hs = (build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT), n=96,
                       n_pids=2, max_ops=32, seed_base=77,
                       seed_prefix="router")
          + build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                         n=96, n_pids=8, max_ops=32, seed_base=1000,
                         seed_prefix="bench"))
    auto = AutoDevice(spec)
    assert auto.segdc.inner is auto.plain
    rec = _FirstLaunch(monkeypatch, stepper_module, "stepper_chunk")
    v = auto.check_histories(spec, hs)
    _hold_stepper_chunk(rec, "on the router's first batch")
    cpu = AutoDevice(spec, device="cpu")
    assert [cpu._route_segdc(h) for h in hs] == \
        [auto._route_segdc(h) for h in hs]
    assert auto.routed_plain > 0 and auto.routed_segdc > 0
    assert auto.routed_plain + auto.routed_segdc == len(hs)
    assert auto.search_stats().histories == len(hs)
    _agree_with_cpp(spec, hs, v)


@pytest.mark.parametrize("family", ["register", "cas", "set", "queue"])
def test_explore_many_through_the_stepper_equals_cpp(cuda, monkeypatch,
                                                     family):
    """The union of many programs' interleaving trees (racy and atomic,
    2 pids x 5 ops) decided in one ``TorchStepper`` call on the card:
    every decided verdict is ``CppOracle``'s on the same union, every
    atomic tree is verified, racy convicted wherever the host oracle
    convicts, and the first launch is the plain version's."""
    from qsm_tpu_torch.core.generator import generate_program
    from qsm_tpu_torch.models.registry import SutFactory, make
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.sched.systematic import enumerate_many, explore_many

    spec, _ = make(family, "atomic")
    progs = [generate_program(spec, seed=s, n_pids=2, max_ops=5)
             for s in range(24)]
    for impl in ("atomic", "racy"):
        factory = SutFactory(family, impl)
        rec = _FirstLaunch(monkeypatch, stepper_module, "stepper_chunk")
        got = explore_many(factory, progs, spec,
                           backend=TorchStepper(spec), max_schedules=5_000)
        _hold_stepper_chunk(rec, f"on the {family}/{impl} union")
        monkeypatch.undo()
        host = explore_many(factory, progs, spec,
                            backend=CppOracle(spec), max_schedules=5_000)
        flat = [h for walked in enumerate_many(factory, progs, 5_000,
                                               100_000)
                for h in walked[0]]
        v = np.asarray(TorchStepper(spec).check_histories(spec, flat))
        _agree_with_cpp(spec, flat, v)
        for g, h in zip(got, host):
            assert (g.schedules_run, g.distinct_histories, g.exhausted) == \
                (h.schedules_run, h.distinct_histories, h.exhausted)
            if g.undecided == 0:
                assert g.violations == h.violations
            if impl == "atomic":
                assert g.verified
        if impl == "racy":
            assert sum(h.violations > 0 for h in host) == \
                sum(g.violations > 0 for g in got)


@pytest.mark.parametrize("vector", [None, (7,) * 7])
def test_fuzz_parity_on_every_device_arm(cuda, vector):
    """``fuzz_parity`` with every device arm on the card: 0 mismatches
    against the exact oracle, the host tail of the hybrid arm used, and
    the native arm non-vacuous."""
    from qsm_tpu_torch.ops.dfs_kernel import dfs_chunk
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk
    from qsm_tpu_torch.ops.sweep_kernel import stepper_sweep
    from qsm_tpu_torch.utils.fuzz import fuzz_parity

    if vector is None:
        arms = ("memo", "cpp", "device", "pallas", "segdc", "auto",
                "hybrid")
        kw = dict(n_specs=4, hists_per_spec=128, n_pids=4, n_ops=10)
    else:
        arms = ("memo", "device", "hybrid")
        kw = dict(n_specs=2, hists_per_spec=64, n_ops=8,
                  vector_bounds=vector)
    before = (dfs_chunk.launches, stepper_chunk.launches,
              stepper_sweep.launches)
    rep = fuzz_parity(seed=11, p_pending=0.1, backends=arms, **kw)
    assert rep.ok, rep.mismatches[:10]
    assert rep.hybrid_tail_histories > 0
    assert rep.linearizable > 0
    if vector is None:
        assert rep.cpp_native_histories > 0 and rep.violations > 0
        assert dfs_chunk.launches > before[0]
        assert stepper_chunk.launches > before[1]
    else:
        assert stepper_sweep.launches > before[2]


def test_check_batch_trace_through_the_stepper(cuda, tmp_path, capsys):
    """``check --backend stepper`` on a batch trace (the CAS headline's
    512 unique histories) on the card: the verdicts are ``CppOracle``'s
    and the exit code is the one they imply."""
    import json

    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.utils.cli import main
    from qsm_tpu_torch.utils.interop import history_to_rows

    spec = CasSpec()
    hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=512, n_pids=8,
                      max_ops=32, seed_base=1000, seed_prefix="bench")
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"model": "cas", "histories": [
        history_to_rows(h) for h in hs]}))
    rc = main(["check", "--trace", str(path), "--backend", "stepper"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = ("VIOLATION", "LINEARIZABLE", "BUDGET_EXCEEDED")
    ref = [names[int(x)] for x in CppOracle(spec).check_histories(spec, hs)]
    assert out["verdicts"] == ref and out["undecided"] == 0
    assert rc == (1 if out["violations"] else 0)


# ---------------------------------------------------------------------------
# Resilience, the history shrinker and build_kernel
# ---------------------------------------------------------------------------


def _history_35():
    from qsm_tpu_torch.core.history import bucket_for, encode_batch

    spec = CasSpec()
    h = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=36, n_pids=8,
                     max_ops=32, seed_base=1000, seed_prefix="bench")[35]
    n = bucket_for(len(h))
    enc = encode_batch([h], spec.initial_state(), max_ops=n)
    return spec, n, (enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
                     enc.valid, enc.precedes(), enc.init_state)


@pytest.mark.parametrize("slots,status", [(4096, 2), (0, 3)])
def test_check_one_at_the_full_budget(cuda, slots, status):
    """``build_kernel``'s ``check_one`` on bench history #35 at budget
    500,000: one ``stepper_chunk`` launch; FAILURE in under 50,000
    iterations with the memo (the plain version on the card to the same
    carry), BUDGET at exactly 500,000 without (the plain version held
    over the first 5,000 iterations)."""
    from qsm_tpu_torch.ops.stepper_kernel import (build_kernel,
                                                  fresh_stepper_carry,
                                                  stepper_chunk,
                                                  stepper_chunk_plain,
                                                  stepper_tables)

    spec, n, args = _history_35()
    before = stepper_chunk.launches
    s, it = build_kernel(spec, n, 500_000, cache_slots=slots)(*args)
    assert stepper_chunk.launches == before + 1
    assert int(s[0]) == status
    assert (int(it[0]) < 50_000) if slots else int(it[0]) == 500_000
    tabs = stepper_tables(spec, *args[:5], cuda)
    fresh = fresh_stepper_carry(tabs.nreq, np.arange(1),
                                np.full(1, int(args[5][0]), np.int32), 1, n,
                                slots)
    run = 500_000 if slots else 5_000
    got = stepper_chunk(tabs, _clone(fresh), chunk=run, budget=500_000)
    want = stepper_chunk_plain(tabs, _clone(fresh), chunk=run,
                               budget=500_000)
    _assert_stepper_equal(got, want, f"check_one with {slots} slots")


def test_failover_with_an_injected_fault_on_the_card(cuda, monkeypatch):
    """``FailoverBackend(TorchStepper)`` under ``raise:dispatch@2`` on
    2048 headline lanes called from a side stream: the first 1024 lanes
    decided on the card, launched from the watchdog's thread on the
    caller's stream, the rest on the host ladder, every verdict
    ``CppOracle``'s; the first launch held against the plain version."""
    import threading

    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.resilience import faults
    from qsm_tpu_torch.resilience.failover import FailoverBackend

    spec = CasSpec()
    hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=512, n_pids=8,
                      max_ops=32, seed_base=1000, seed_prefix="bench") * 4
    monkeypatch.setenv(faults.ENV_VAR, "raise:dispatch@2")
    monkeypatch.setattr(faults, "_plane", None)
    rec = _FirstLaunch(monkeypatch, stepper_module, "stepper_chunk")
    seen = []
    inner = rec.__call__

    def origin(*a, **kw):
        if not seen:
            seen.append((threading.get_ident(),
                         torch.cuda.current_stream(cuda).cuda_stream))
        return inner(*a, **kw)

    monkeypatch.setattr(stepper_module, "stepper_chunk", origin)
    side = torch.cuda.Stream(cuda)
    fo = FailoverBackend(spec, TorchStepper(spec))
    assert fo.on_card
    with torch.cuda.stream(side):
        v = fo.check_histories(spec, hs)
    torch.cuda.synchronize()
    monkeypatch.setattr(faults, "_plane", None)
    np.testing.assert_array_equal(v, CppOracle(spec).check_histories(spec,
                                                                     hs))
    r = fo.resilience()
    assert (r["device_histories"], r["fallback_histories"],
            r["degradations"]) == (1024, 1024, 1)
    assert seen[0] == (seen[0][0], side.cuda_stream)
    assert seen[0][0] != threading.get_ident()
    _hold_stepper_chunk(rec, "on the failover path")


def test_failover_raises_a_real_device_error_on_the_card(cuda):
    """The card's rule: a ``BackendUnavailable`` the fault plane did not
    inject raises out of ``FailoverBackend`` and out of
    ``prop_concurrent``, and nothing is degraded."""
    from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
    from qsm_tpu_torch.ops.backend import BackendUnavailable
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.resilience.failover import FailoverBackend

    spec = CasSpec()
    hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=16, n_pids=4,
                      max_ops=12, seed_prefix="card_rule")
    st = TorchStepper(spec)

    def lost(*a, **kw):
        raise BackendUnavailable("card lost")

    st._run_device = lost
    fo = FailoverBackend(spec, st)
    with pytest.raises(BackendUnavailable, match="card lost"):
        fo.check_histories(spec, hs)
    with pytest.raises(BackendUnavailable, match="card lost"):
        fo.check_witness(spec, hs[0])
    assert not fo.degraded and fo.degradations == 0 and fo.retries == 0
    with pytest.raises(BackendUnavailable, match="card lost"):
        prop_concurrent(spec, RacyCasSUT(spec),
                        PropertyConfig(n_trials=4, n_pids=2, max_ops=6),
                        backend=st)


def test_frontier_batch_through_the_stepper(cuda, monkeypatch):
    """A frontier batch of the history shrinker through ``TorchStepper``
    on the card: one ``check_histories`` call a round, the minimised
    history and counters equal to the host shrink's, the first launch of
    the first frontier batch held against the plain version."""
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.shrink import shrink_history
    from qsm_tpu_torch.utils.interop import history_to_rows

    spec = CasSpec()
    hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=64, n_pids=8,
                      max_ops=32, seed_base=1000, seed_prefix="bench")
    v = CppOracle(spec).check_histories(spec, hs)
    h = next(x for x, y in zip(hs, v) if y == Verdict.VIOLATION)
    host = shrink_history(spec, h, certificate=False)

    class Counted:
        def __init__(self):
            self.inner, self.calls = TorchStepper(spec), 0

        def check_histories(self, spec, histories):
            self.calls += 1
            if self.calls == 2:  # the first frontier batch
                self.rec = _FirstLaunch(monkeypatch, stepper_module,
                                        "stepper_chunk")
            return self.inner.check_histories(spec, histories)

    eng = Counted()
    res = shrink_history(spec, h, backend=eng, certificate=False)
    assert eng.calls == res.engine_calls
    assert history_to_rows(res.history) == history_to_rows(host.history)
    assert (res.rounds, res.lanes_checked, res.one_minimal) == \
        (host.rounds, host.lanes_checked, host.one_minimal)
    _hold_stepper_chunk(eng.rec, "on a frontier batch")


def test_shrink_entry_point_runs_on_the_card(cuda, tmp_path, capsys):
    """``shrink --trace --certificate`` decides its frontier batches on
    the card by default (the planned checker): the same minimised history,
    rounds and lanes as the host ladder's run (``--device cpu``), the
    certificate audited."""
    import json

    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.utils.cli import main
    from qsm_tpu_torch.utils.interop import history_to_rows

    spec = CasSpec()
    hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=64, n_pids=8,
                      max_ops=32, seed_base=1000, seed_prefix="bench")
    v = CppOracle(spec).check_histories(spec, hs)
    h = next(x for x, y in zip(hs, v) if y == Verdict.VIOLATION)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"model": "cas",
                                "spec_kwargs": spec.spec_kwargs(),
                                "history": history_to_rows(h)}))
    docs = []
    for extra in ([], ["--device", "cpu"]):
        stepper_module.stepper_chunk.launches = 0
        rc = main(["shrink", "--trace", str(path), "--certificate", *extra])
        docs.append((rc, stepper_module.stepper_chunk.launches, json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])))
    (rc, launches, card), (rc_h, launches_h, host) = docs
    assert rc == rc_h == 0 and launches > 0 and launches_h == 0
    assert card["certificate_audit"]["one_minimal_proved"]
    for k in ("verdict", "final_ops", "rounds", "lanes", "one_minimal",
              "undecided_neighbors", "history"):
        assert card[k] == host[k], k


def _streamed(session, hists, chunk):
    """Each history streamed as rows ``chunk`` at a time into a fresh
    session of ``session()``, a decide after each; the verdicts seen and
    the counters."""
    from qsm_tpu_torch.utils.interop import history_to_rows

    out = []
    for h in hists:
        s = session()
        rows = history_to_rows(h)
        seen = []
        for i in range(0, len(rows), chunk):
            s.append(rows[i:i + chunk])
            seen.append(s.decide())
        out.append((seen, s.close(), s.counters()))
    return out


@pytest.mark.parametrize("family", ["cas", "kv"])
def test_batched_window_recheck_on_the_card_equals_the_host_loop(cuda,
                                                                 family):
    """The monitor's window re-check as one stepper batch a decide on the
    card: verdicts after every decide and counters equal to the host
    loop's (``device="cpu"``), final verdicts equal to ``CppOracle``'s,
    ``stepper_chunk`` launched."""
    from qsm_tpu_torch.core.spec import projection_report
    from qsm_tpu_torch.models.registry import MODELS
    from qsm_tpu_torch.monitor import MonitorSession, SessionManager
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops import stepper as stepper_module

    entry = MODELS[family]
    spec = entry.make_spec()
    hists = build_corpus(spec, (entry.impls["atomic"], entry.impls["racy"]),
                         n=24, n_pids=6, max_ops=24, seed_base=1000,
                         seed_prefix="bench")
    proj = None if projection_report(spec) else spec.projected_spec()
    mgr = SessionManager(max_sessions=len(hists) + 1)
    stepper_module.stepper_chunk.launches = 0
    card = _streamed(lambda: mgr.open(None, spec, proj)[0], hists, 4)
    assert stepper_module.stepper_chunk.launches > 0
    assert mgr.engines.stats()["calls"] > 0
    host = _streamed(lambda: MonitorSession("h", spec, proj_spec=proj,
                                            device="cpu"), hists, 4)
    assert card == host
    want = [int(v) for v in CppOracle(spec).check_histories(spec, hists)]
    assert [v for _, v, _ in card] == want


def test_ingest_check_runs_on_the_card(cuda, capsys):
    """``ingest --check`` decides the goldens on the card (the planned
    checker) with the host ladder's JSON line."""
    import json
    import pathlib

    from qsm_tpu_torch.utils.cli import main

    data = pathlib.Path(__file__).resolve().parent / "data"
    for name, fmt, model in (("golden_jepsen_register.edn", "jepsen",
                              "register"),
                             ("golden_porcupine_kv.edn", "porcupine", "kv"),
                             ("golden_porcupine_txn.edn", "porcupine",
                              "txn")):
        argv = ["ingest", str(data / name), "--format", fmt, "--spec",
                model, "--check"]
        rc = main(argv)
        card = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        rc_h = main(argv + ["--device", "cpu"])
        host = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (rc, card) == (rc_h, host)


# --- the check server and the device-work queue on the card ----------------

def test_check_server_serves_on_the_card_by_default(cuda, corpus):
    """``CheckServer()`` serves on the card (the planned checker behind
    ``FailoverBackend``, ``stepper_chunk`` launched) with the host
    oracle's verdicts, and a second request answers cached."""
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk
    from qsm_tpu_torch.serve import CheckClient, CheckServer

    spec, hists = corpus
    want = WingGongCPU(memo=True).check_histories(spec, hists[:64])
    srv = CheckServer(flush_s=0.005, max_lanes=64).start()
    try:
        stepper_chunk.launches = 0
        with CheckClient(srv.address, timeout_s=300) as c:
            res = c.check("cas", hists[:64])
            again = c.check("cas", hists[:64])
        assert res["ok"] and stepper_chunk.launches > 0
        assert [Verdict[v] for v in res["verdicts"]] == list(want)
        assert all(again["cached"])
        assert any("on cuda" in w for w in res["plan_why"])
        st = srv.stats()
        assert st["device"] == "cuda" and st["device_errors"] == 0
    finally:
        srv.stop()


def test_check_server_answers_a_real_device_error(cuda, corpus):
    """The card's rule in the server: a real error of an engine on the
    card answers ``ok: false`` with its name and is never decided on the
    host; an injected one degrades with exact verdicts."""
    import os

    from qsm_tpu_torch.resilience import faults
    from qsm_tpu_torch.serve import CheckClient, CheckServer

    spec, hists = corpus

    class _Broken:
        name = "broken"

        def __init__(self, s):
            self.device = cuda

        def check_histories(self, s, histories):
            torch.zeros(len(histories), device=self.device)
            raise RuntimeError("CUDA error: a stub's failure")

    srv = CheckServer(flush_s=0.005, max_lanes=64,
                      engine_factory=_Broken).start()
    try:
        with CheckClient(srv.address, timeout_s=120) as c:
            res = c.check("cas", hists[:8])
        assert not res["ok"] and res["error"].startswith("RuntimeError")
        st = srv.stats()
        assert st["device_errors"] == 1 and st["cache"]["entries"] == 0
    finally:
        srv.stop()
    os.environ["QSM_TPU_FAULTS"] = "raise:serve"
    faults._plane = None
    srv = CheckServer(flush_s=0.005, max_lanes=64).start()
    try:
        with CheckClient(srv.address, timeout_s=300) as c:
            res = c.check("cas", hists[:16])
        want = WingGongCPU(memo=True).check_histories(spec, hists[:16])
        assert res["ok"] and [Verdict[v] for v in res["verdicts"]] \
            == list(want)
        assert srv.stats()["serve_faults"] >= 1
        assert srv.stats()["device_errors"] == 0
    finally:
        srv.stop()
        os.environ.pop("QSM_TPU_FAULTS")
        faults._plane = None


def test_drain_on_the_card_banks_oracle_verdicts(cuda, corpus):
    """``DrainScheduler`` on the card (its default device): the planned
    checker decides, a fresh memo oracle re-proves, the bank holds every
    lane under its key, ``wrong_verdicts`` 0."""
    from qsm_tpu_torch.devq import DeviceWorkQueue, DrainScheduler
    from qsm_tpu_torch.devq.queue import bank_histories
    from qsm_tpu_torch.serve.cache import VerdictCache, fingerprint_key

    spec, hists = corpus
    q = DeviceWorkQueue()
    bank_histories(spec, hists[:128], plane="check", queue=q)
    bank = VerdictCache(max_entries=1024)
    rep = DrainScheduler(q, cache=bank, window_s=60.0).drain()
    assert rep["wrong_verdicts"] == 0 and rep["drained"] == 1
    assert rep["per_plane"]["check"]["device_items"] == 1
    assert rep["device"].startswith("cuda")
    for h in hists[:128]:
        assert bank.get(fingerprint_key(spec, h)) is not None


def test_fleet_on_the_card_routes_with_cpp_oracle_verdicts(cuda, corpus,
                                                           tmp_path):
    """Two ``CheckServer()`` nodes on the card behind a ``FleetRouter()``
    in one process: the CAS corpus routes across both nodes with 0
    verdicts off ``CppOracle``'s, every lane stamped with the node that
    decided it, and the nodes' planned checkers launch ``stepper_chunk``."""
    from qsm_tpu_torch.fleet import FleetRouter
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk
    from qsm_tpu_torch.serve import CheckClient, CheckServer

    spec, hists = corpus
    want = [int(v) for v in CppOracle(spec).check_histories(spec, hists)]
    nodes = [CheckServer(node_id=f"n{i}", flush_s=0.005, max_lanes=64,
                         replog_dir=str(tmp_path / f"r{i}")).start()
             for i in range(2)]
    router = FleetRouter([(s.node_id, s.address) for s in nodes],
                         anti_entropy_s=0.0).start()
    try:
        stepper_chunk.launches = 0
        with CheckClient(router.address, timeout_s=600) as c:
            res = c.check("cas", hists)
        assert res["ok"], res
        assert [int(Verdict[v]) for v in res["verdicts"]] == want
        assert set(res["nodes"]) == {"n0", "n1"}
        assert sum(res["nodes"].values()) == len(hists)
        assert all(b["node"] in ("n0", "n1") for b in res["batches"])
        assert stepper_chunk.launches > 0
        st = router.stats()
        assert st["ladder_lanes"] == 0 and st["device_errors"] == 0
        assert not router._ladders          # the router touched no CUDA
        for nid in ("n0", "n1"):
            assert st["fleet_nodes"][nid]["device"] == "cuda"
    finally:
        router.stop()
        for s in nodes:
            s.stop()


def test_fleet_router_ladder_launches_on_the_card(cuda, corpus, tmp_path):
    """With every node gone the router's ladder decides in its own
    process on the card: ``stepper_chunk`` launches there, the verdicts
    are ``CppOracle``'s, and the ladder is ``FailoverBackend`` over the
    planned checker."""
    from qsm_tpu_torch.fleet import FleetRouter
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops.stepper_kernel import stepper_chunk
    from qsm_tpu_torch.serve import CheckClient, CheckServer

    spec, hists = corpus
    want = [int(v) for v in CppOracle(spec).check_histories(spec,
                                                            hists[:64])]
    node = CheckServer(node_id="n0", flush_s=0.005).start()
    router = FleetRouter([("n0", node.address)], anti_entropy_s=0.0,
                         heartbeat_s=0.2).start()
    try:
        node.stop()
        router.links["n0"].close_all()
        stepper_chunk.launches = 0
        with CheckClient(router.address, timeout_s=600) as c:
            res = c.check("cas", hists[:64])
        assert res["ok"], res
        assert [int(Verdict[v]) for v in res["verdicts"]] == want
        assert res["nodes"] == {"router": 64}
        assert stepper_chunk.launches > 0
        (entry,) = router._ladders.values()
        assert type(entry[1]).__name__ == "FailoverBackend"
        assert router.stats()["ladder_lanes"] == 64
    finally:
        router.stop()
        node.stop()


def test_two_nodes_on_a_cold_build_directory_load_one_library(cuda,
                                                              tmp_path):
    """Two ``serve`` processes started at once from a copy of the
    package whose build directory is empty: both compile, the atomic
    rename installs one library a kernel and leaves no temporary file,
    and both nodes map the same library path."""
    import json
    import os
    import pathlib
    import shutil
    import subprocess
    import sys

    from qsm_tpu_torch.serve import CheckClient

    repo = pathlib.Path(__file__).resolve().parent.parent
    root = tmp_path / "cold"
    shutil.copytree(repo / "qsm_tpu_torch", root / "qsm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {**os.environ, "PYTHONPATH": str(root)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "qsm_tpu_torch", "serve", "--port", "0",
         "--warm", "cas", "--node-id", f"c{i}"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env) for i in range(2)]
    try:
        addrs = [json.loads(p.stdout.readline())["serving"] for p in procs]
        build = root / "build" / "qsm_tpu_torch"
        libs = sorted(x.name for x in build.glob("*.so"))
        assert not [x for x in libs if ".tmp." in x], libs
        names = [x.rsplit("_", 1)[0] for x in libs]
        assert len(names) == len(set(names)), libs
        assert "stepper_chunk" in names

        def mapped(pid):
            text = pathlib.Path(f"/proc/{pid}/maps").read_text()
            return {line.split(None, 5)[-1].replace(" (deleted)", "")
                    for line in text.splitlines()
                    if "/stepper_chunk_" in line}

        maps = [mapped(p.pid) for p in procs]
        assert maps[0] and maps[0] == maps[1], maps
        assert all(pathlib.Path(m).parent == build for m in maps[0])
        for a in addrs:
            with CheckClient(a, timeout_s=60) as c:
                c.shutdown()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.mark.parametrize("model", ["cas", "queue", "kv16"])
def test_card_shard_mesh_equals_width_one(cuda, model):
    """A logical 4-shard mesh of one card (each shard its own stream)
    answers as one device, lane for lane: verdicts, ``chosen`` and each
    lane's iterations; compactions move lanes across shards, and each
    shard's launches go on its own stream."""
    from qsm_tpu_torch.mesh import batch_sharding, card_shard_mesh
    from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
    from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                            RacyTwoPhaseQueueSUT)
    from qsm_tpu_torch.ops import stepper as stepper_module
    from qsm_tpu_torch.ops.stepper import TorchStepper

    spec, suts, pids, ops = {
        "cas": (CasSpec(), (AtomicCasSUT, RacyCasSUT), 8, 32),
        "queue": (QueueSpec(), (AtomicQueueSUT, RacyTwoPhaseQueueSUT), 8,
                  48),
        "kv16": (KvSpec(n_keys=16), (AtomicKvSUT, StaleCacheKvSUT), 16,
                 64)}[model]
    hs = [h for h in build_corpus(spec, suts, n=256, n_pids=pids,
                                  max_ops=ops, seed_base=1000,
                                  seed_prefix="bench") if h.n_pending == 0]
    plan = dict(chunk_schedule=(256, 2048, 16384), batch_buckets=(32, 256),
                slots_for_batch={32: 4096, 256: 1024})
    if model == "kv16":
        # its hard lanes keep more than 32 running to the end: a ladder
        # of every 32nd width compacts as soon as 32 lanes decide
        buckets = tuple(range(32, 257, 32))
        plan = dict(plan, batch_buckets=buckets, slots_for_batch={
            b: 4096 if b == 32 else 1024 for b in buckets})
    one = TorchStepper(spec, device=cuda, **plan)
    s1, c1 = one._run_device(hs, collect_chosen=True)
    streams = set()
    real = stepper_module.stepper_chunk if one.regime == "table" \
        else stepper_module.stepper_sweep

    def spy(*args, **kw):
        streams.add(torch.cuda.current_stream().cuda_stream)
        return real(*args, **kw)

    name = "stepper_chunk" if one.regime == "table" else "stepper_sweep"
    old = getattr(stepper_module, name)
    setattr(stepper_module, name, spy)
    try:
        four = TorchStepper(spec, sharding=batch_sharding(
            card_shard_mesh(4)), **plan)
        s4, c4 = four._run_device(hs, collect_chosen=True)
    finally:
        setattr(stepper_module, name, old)
    assert np.array_equal(s1, s4)
    assert np.array_equal(c1, c4)
    assert np.array_equal(one.last_iters, four.last_iters)
    assert four.compactions == one.compactions
    assert four.compactions > 0 and four.lanes_crossed > 0
    assert len(streams) == 4


def test_make_mesh_never_spans_more_cards_than_the_machine(cuda):
    from qsm_tpu_torch.mesh import make_mesh
    from qsm_tpu_torch.serve import CheckServer

    k = torch.cuda.device_count()
    assert make_mesh().size == k
    with pytest.raises(ValueError, match=f"requested {k + 1} devices, "
                                         f"have {k}"):
        make_mesh(k + 1)
    with pytest.raises(ValueError, match=f"have {k}"):
        CheckServer(mesh_devices=k + 1).start()


# --- the port's static checks on the card (qsm_tpu_torch/analysis) ---------

def test_lint_semantic_families_run_on_the_card(cuda):
    """Families a and b on the card by default: parity evaluates
    step_torch there, the rebuild guard's warmed backends grow nothing,
    the five ptxas reports are read and every edge launch matches its
    plain version; nothing unwhitelisted but notes."""
    from qsm_tpu_torch.analysis import run_lint
    from qsm_tpu_torch.models.registry import MODELS

    rep = run_lint(families=["a", "b"], cache=False)
    assert rep.device.startswith("cuda")
    assert [f for f in rep.findings if f.severity != "info"] == []
    assert sorted(rep.parity) == sorted(MODELS)
    assert all(st["device"].startswith("cuda")
               for st in rep.parity.values())
    assert len(rep.rebuild) == 3
    for rec in rep.rebuild.values():
        assert rec["warm"] == rec["after"]
    assert [r["registers"] is not None for r in rep.kernels] == [True] * 5
    assert [(e["kernel"], e["max_abs_err"]) for e in rep.edges] == [
        (k, 0) for k in ("dfs_chunk", "stepper_chunk", "compact_carry",
                         "stepper_sweep", "threefry_draws")]


def test_lint_edge_launches_count_and_match(cuda):
    """Each kernel launched once at its largest admitted plan, through
    its wrapper (each count grows), bit-identical to its plain version."""
    from qsm_tpu_torch.analysis.kernel_passes import (edge_plan,
                                                      kernel_plans,
                                                      launch_edge_plans)
    from qsm_tpu_torch.models.registry import MODELS
    from qsm_tpu_torch.ops.draws_kernel import threefry_draws
    from qsm_tpu_torch.ops.stepper_kernel import (compact_carry,
                                                  device_sms, stepper_chunk)
    from qsm_tpu_torch.ops.sweep_kernel import stepper_sweep

    specs = [(n, MODELS[n].make_spec(), f"model:{n}") for n in sorted(MODELS)]
    wrappers = (dfs_chunk, stepper_chunk, compact_carry, stepper_sweep,
                threefry_draws)
    before = [w.launches for w in wrappers]
    found, rows = launch_edge_plans(specs, cuda)
    assert found == []
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1] * 5
    plans = kernel_plans(specs, device_sms(cuda))
    for r in rows:
        assert r["max_abs_err"] == 0
        assert r["smem"] == edge_plan(plans[r["kernel"]]).smem


def test_lint_catches_a_rebuilding_backend_on_the_card(cuda):
    """The seeded RebuildingTorchStepper, its nonce library built by nvcc,
    is caught; the real TorchStepper on the same corpora is not."""
    from qsm_tpu_torch.analysis.engine import _rebuild_corpora
    from qsm_tpu_torch.analysis.fixtures import RebuildingTorchStepper
    from qsm_tpu_torch.analysis.kernel_passes import check_rebuild
    from qsm_tpu_torch.models.registry import MODELS
    from qsm_tpu_torch.ops.stepper import TorchStepper

    spec = MODELS["cas"].make_spec()
    corpora = _rebuild_corpora(MODELS["cas"], spec)
    knobs = dict(budget=2_000, mid_budget=0, rescue_budget=0,
                 chunk_schedule=(512,))
    assert check_rebuild(spec, TorchStepper(spec, **knobs), corpora,
                         "ops/stepper.py") == []
    found = check_rebuild(spec, RebuildingTorchStepper(spec, **knobs),
                          corpora, "fixture:rebuilding")
    assert [f.rule_id for f in found] == ["QSM-KERN-REBUILD"]


def test_lint_subcommand_runs_on_the_card_by_default(cuda, capsys):
    import json

    from qsm_tpu_torch.utils.cli import main

    rc = main(["lint", "--json", "--models", "cas", "--family", "a,b",
               "--no-cache"])
    doc = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and doc["ok"] and doc["device"].startswith("cuda")
