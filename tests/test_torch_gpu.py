"""On the card only (marker ``gpu``; run with ``pytest --noconftest -m gpu
tests/test_torch_gpu.py`` on a machine with an H100): the ``dfs_chunk``
kernel against its plain version, bit for bit on all seven carry planes,
under every launch plan (``nxt`` staged or read from global memory, the
memo off, in shared memory or in global memory, N = 12 and 32, a ragged
last block, start states outside the table), over 8 consecutive chunks at
the checker's 4096 lanes, and the checker at 256 lanes against the memo
oracle; ``stepper_chunk`` and ``compact_carry`` against their plain
versions on every carry plane (1 to 4 bitmask words, memo off, small and
large; the memo kept, grown, shrunk, created and dropped), and
``TorchStepper`` on a queue corpus against the memo oracle.  Without CUDA
each test skips in its fixture."""

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


@pytest.mark.parametrize("slots", [0, 64, 8192])
@pytest.mark.parametrize("model,n_ops", [("queue", 48), ("cas", 32),
                                         ("cas", 64), ("cas", 96),
                                         ("cas", 128)])
def test_stepper_chunk_matches_plain_version(cuda, model, n_ops, slots):
    from qsm_tpu_torch.ops.stepper_kernel import (
        fresh_stepper_carry, stepper_chunk, stepper_chunk_plain)

    B = 300  # a ragged last block
    tabs, init = _stepper_inputs(model, n_ops, B, cuda)
    starts = np.full(B, init, np.int32)
    starts[::7] = tabs.nxt.shape[1] + 3  # outside the table
    starts[3::11] = -2
    rows = np.random.default_rng(3).permutation(B)
    carry = fresh_stepper_carry(tabs.nreq, rows, starts[rows], B, n_ops,
                                slots)
    for k in range(3):
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
