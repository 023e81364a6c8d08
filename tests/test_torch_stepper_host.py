"""The CUDA sources of ``stepper_chunk`` and ``compact_carry`` compiled for
the host and held against their plain versions, bit for bit on every carry
plane, on the CPU.

``compact_carry``'s threads share nothing, so running every thread of a
block one after another gives what the card gives.  ``stepper_chunk``'s
threads meet at warp votes, shuffles and barriers: it runs under
``tests/cuda_host/cuda_warp.h``, which starts each block's threads as
host threads and makes every vote and barrier a meeting point.  The test
rewrites each source's CUDA-only lines (the ``extern __shared__``
declaration, the ``<<<>>>`` launch), compiles it with the host C++
compiler against ``tests/cuda_host/``, and calls its C entry through
ctypes on CPU tensors: ``stepper_chunk`` under all sixteen template
instantiations (1 to 4 bitmask words, memo off and on, table staged in
shared memory or read from device memory) with start states outside the
table and decided lanes, several warps a block, two chunks in a row;
``compact_carry`` with the memo kept, grown, shrunk (collisions), dropped
and created.  What only the card can show (that ``nvcc`` builds them, the
timing) is in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qsm_tpu_torch.core.history import bucket_for, encode_batch
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                        RacyTwoPhaseQueueSUT)
from qsm_tpu_torch.ops.dfs_kernel import H100_SMS
from qsm_tpu_torch.ops.kernels import CSRC_DIR
from qsm_tpu_torch.ops.scalarize import scalar_shadow
from qsm_tpu_torch.ops.stepper_kernel import (
    RUNNING, STATUS, StepperCarry, StepperPlan, compact_carry_plain,
    fresh_stepper_carry, key_words, n_words, stepper_chunk_plain,
    stepper_launch_plan, stepper_tables, table_bytes, warp_stack_bytes)
from qsm_tpu_torch.utils.corpus import build_corpus

SHIM = Path(__file__).resolve().parent / "cuda_host"
LANES = 40  # not a multiple of 32: the last block is part empty
CHUNK = 96
BUDGET = 552_000
_P, _I = ctypes.c_void_p, ctypes.c_int
# each source's CUDA-only lines and their host rewrites
_REWRITES = {
    "stepper_chunk": (
        ("extern __shared__ int32_t smem[];", "int32_t* smem = host_smem;"),
        ("kern<<<grid, warps * WARP, smem_bytes, "
         "static_cast<cudaStream_t>(stream)>>>(a);",
         "host_launch_threads(kern, grid, warps * WARP, smem_bytes, a);")),
    "compact_carry": (
        ("kern<<<grid, THREADS, 0, stream>>>(a);",
         "host_launch(kern, grid, THREADS, 0, a);"),),
}


def _host_lib(name: str, tmp: Path, src: str = None):
    """The host build of ``csrc/<name>.cu`` (or of the text ``src``)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = src if src is not None else (CSRC_DIR / f"{name}.cu").read_text()
    for cuda, host in _REWRITES[name]:
        assert src.count(cuda) == 1, f"{name}.cu no longer has: {cuda}"
        src = src.replace(cuda, host)
    (tmp / f"{name}.cpp").write_text(src)
    lib = tmp / f"{name}.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{SHIM}", "-include", "cuda_warp.h", "-o", str(lib),
                    str(tmp / f"{name}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _bind(name: str, lib):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([_P] * 13 + [_I] * 13 + [_P] if name == "stepper_chunk"
                   else [_P] * 16 + [_I] * 9 + [_P])
    fn.restype = _I
    return fn


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stepper_host")
    return tuple(_bind(name, _host_lib(name, tmp))
                 for name in ("stepper_chunk", "compact_carry"))


def _corpus(model: str, n_ops: int):
    if model == "queue":
        return QueueSpec(), (AtomicQueueSUT, RacyTwoPhaseQueueSUT)
    if model == "cas256":  # 256 values: a table too large to stage
        return CasSpec(n_values=256), (AtomicCasSUT, RacyCasSUT)
    return CasSpec(), (AtomicCasSUT, RacyCasSUT)


def _tables(model: str, n_ops: int):
    spec, suts = _corpus(model, n_ops)
    hs = build_corpus(spec, suts, n=LANES, n_pids=8, max_ops=n_ops,
                      seed_base=31, seed_prefix="host")
    kspec = scalar_shadow(spec) or spec
    N = bucket_for(max(len(h) for h in hs))
    assert N == n_ops, (N, n_ops)
    enc = encode_batch(hs, kspec.initial_state(), max_ops=N)
    tabs = stepper_tables(kspec, enc.ops[:, :, 1], enc.ops[:, :, 2],
                          enc.ops[:, :, 3], enc.valid, enc.precedes(), "cpu")
    return tabs, int(enc.init_state[0]), kspec.scalar_state_bound(N)


def _plan(tabs, B: int, warps: int = 0, stage: bool = True) -> StepperPlan:
    """The wrapper's plan, or (``warps`` > 0) one fixed by hand: ``warps``
    warps a block, the table staged or in device memory."""
    N = tabs.vocab.shape[1]
    if not warps:
        return stepper_launch_plan(B, N, *tabs.vnxt.shape, H100_SMS)
    smem = (table_bytes(*tabs.vnxt.shape) if stage else 0) \
        + warps * warp_stack_bytes(N)
    return StepperPlan(warps, -(-B // warps), stage, smem)


def _step(fn, tabs, carry: StepperCarry, chunk: int, plan=None) -> int:
    R, N = tabs.vocab.shape
    S, V = tabs.vnxt.shape
    B = carry.row.shape[0]
    plan = plan or _plan(tabs, B)
    return fn(*(t.data_ptr() for t in tabs), carry.row.data_ptr(),
              *(t.data_ptr() for t in carry[:6]), B, R, N, S, V,
              n_words(N), carry.occ.shape[1], chunk, BUDGET,
              *(int(x) for x in plan), None)


def _clone(c: StepperCarry) -> StepperCarry:
    return StepperCarry(*(t.clone() for t in c))


def _assert_equal(got: StepperCarry, want: StepperCarry, what: str) -> None:
    for name, a, b in zip(StepperCarry._fields, got, want):
        assert torch.equal(a, b), f"{name} differs {what}"


def _start(tabs, init: int, S: int, slots: int) -> StepperCarry:
    starts = np.full(LANES, init, np.int32)
    starts[::7] = S + 3       # above the table
    starts[3::11] = -2        # below it
    rows = np.random.default_rng(3).permutation(LANES)  # lanes != rows
    return fresh_stepper_carry(tabs.nreq, rows, starts[rows], LANES,
                               tabs.vocab.shape[1], slots)


def _scramble_memo(carry: StepperCarry) -> None:
    """Occupancy words other than 1 on every other filled slot, whose key
    is where its hash puts it (a probe must miss it), and garbage keys in
    the empty slots."""
    g = np.random.default_rng(4)
    filled = torch.nonzero(carry.occ == 1)[::2]
    carry.occ[filled[:, 0], filled[:, 1]] = torch.from_numpy(
        g.choice(np.array([0, 2, -1], np.int32), len(filled)))
    empty = carry.occ == 0
    carry.keys[empty] = torch.from_numpy(g.integers(
        -2**31, 2**31, (int(empty.sum()), carry.keys.shape[2]),
        dtype=np.int64).astype(np.int32))


def _run_both(step, tabs, carry, plan=None, chunks=2) -> StepperCarry:
    for k in range(chunks):
        if k and carry.occ.shape[1]:
            _scramble_memo(carry)
        got, want = _clone(carry), _clone(carry)
        assert _step(step, tabs, got, CHUNK, plan) == 0
        stepper_chunk_plain(tabs, want, chunk=CHUNK, budget=BUDGET)
        _assert_equal(got, want, f"after chunk {k + 1} under {plan}")
        carry = got
    return carry


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("model,n_ops", [("cas", 32), ("queue", 48),
                                         ("cas", 64), ("cas", 96),
                                         ("cas", 128)])
def test_stepper_source_matches_plain(host_libs, model, n_ops, slots):
    step, _ = host_libs
    tabs, init, S = _tables(model, n_ops)
    carry = _run_both(step, tabs, _start(tabs, init, S, slots))
    status = carry.dsi[STATUS]
    assert int((status == RUNNING).sum()) > 0   # lanes still searching
    assert int((status == 3).sum()) >= 6        # the out-of-table starts
    if slots:
        assert int((carry.occ == 1).sum()) > 0  # the memo was exercised


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("model,n_ops,warps,stage", [
    ("queue", 48, 3, True),     # 14 blocks of 3 warps, the last one ragged
    ("queue", 48, 3, False),    # the same lanes, table in device memory
    ("cas", 128, 2, False),
    ("cas256", 32, 0, False),   # the wrapper's plan: too large to stage
])
def test_stepper_source_matches_plain_under_each_plan(host_libs, model,
                                                      n_ops, warps, stage,
                                                      slots):
    step, _ = host_libs
    tabs, init, S = _tables(model, n_ops)
    plan = _plan(tabs, LANES, warps, stage)
    assert plan.stage_tables == stage
    carry = _run_both(step, tabs, _start(tabs, init, S, slots), plan)
    assert int((carry.dsi[STATUS] == RUNNING).sum()) > 0


def test_stepper_entry_refuses_bad_arguments(host_libs):
    step, _ = host_libs
    tabs, init, S = _tables("cas", 32)
    carry = _start(tabs, init, S, 64)
    R, N = tabs.vocab.shape
    S, V = tabs.vnxt.shape
    ptrs = [*(t.data_ptr() for t in tabs), carry.row.data_ptr(),
            *(t.data_ptr() for t in carry[:6])]
    plan = [int(x) for x in _plan(tabs, LANES)]
    for bad in ((LANES, R, N, S, V, 2, 64, CHUNK),    # W does not fit N
                (LANES, R, 129, S, V, 5, 64, CHUNK),  # N past 128
                (LANES, R, N, S, V, 1, 48, CHUNK)):   # slots not a power of 2
        assert step(*ptrs, *bad, BUDGET, *plan, None) == 1
    shape = (LANES, R, N, S, V, 1, 64, CHUNK, BUDGET)
    assert step(*ptrs, *shape, *plan, None) == 0
    warps, grid, stage, smem = plan
    stack = 8 * (N + 1)
    for bad in ((warps + 1, grid, stage, smem),          # grid, bytes stale
                (warps, grid + 1, stage, smem),          # grid too large
                (warps, grid, stage, smem - 4),          # bytes short
                (warps, grid, 1 - stage, smem),          # table elsewhere
                (17, -(-LANES // 17), stage,             # 17 warps a block
                 smem + (17 - warps) * stack)):
        assert step(*ptrs, *shape, *bad, None) == 1, bad
    # a table too large to stage: the right sum, above what a block gets
    big, init, S = _tables("cas256", 32)
    carry = _start(big, init, S, 64)
    R, N = big.vocab.shape
    S, V = big.vnxt.shape
    plan = _plan(big, LANES)
    assert not plan.stage_tables
    over = plan._replace(stage_tables=True, smem_bytes=plan.smem_bytes
                         + 4 * S * (V + n_words(V)))
    assert over.smem_bytes > 232_448
    ptrs = [*(t.data_ptr() for t in big), carry.row.data_ptr(),
            *(t.data_ptr() for t in carry[:6])]
    shape = (LANES, R, N, S, V, 1, 64, CHUNK, BUDGET)
    assert step(*ptrs, *shape, *(int(x) for x in over), None) == 1
    assert step(*ptrs, *shape, *(int(x) for x in plan), None) == 0


def _compact(fn, carry: StepperCarry, lanes: np.ndarray, bucket: int,
             slots: int, sms: int = 1) -> tuple:
    """One host launch; ``sms = 1`` caps each pass at 16 blocks, so the
    grid-stride loops take several trips."""
    N = carry.taken.shape[0]
    out = StepperCarry(*(torch.full(s, 12345, dtype=torch.int32) for s in (
        (N, bucket), (N + 1, bucket), (N + 1, bucket), (5, bucket),
        (bucket, slots, key_words(N)), (bucket, slots), (bucket,))))
    idx = torch.from_numpy(lanes.astype(np.int32))
    win = torch.full((max(len(lanes) * slots, 1),), 777, dtype=torch.int32)
    rc = fn(*(t.data_ptr() for t in carry), idx.data_ptr(),
            *(t.data_ptr() for t in out), win.data_ptr(),
            carry.row.shape[0], bucket, len(lanes), N, 0, key_words(N),
            carry.occ.shape[1], slots, sms, None)
    return rc, out


@pytest.mark.parametrize("old_slots,slots", [(64, 64), (64, 256), (64, 8),
                                             (64, 0), (0, 64), (0, 0)])
def test_compact_source_matches_plain(host_libs, old_slots, slots):
    step, comp = host_libs
    tabs, init, S = _tables("queue", 48)
    carry = _start(tabs, init, S, old_slots)
    for _ in range(3):
        stepper_chunk_plain(tabs, carry, chunk=CHUNK, budget=BUDGET)
    if old_slots:
        # garbage in empty slots, and occupancy words other than 0 and 1:
        # only occ == 1 moves on a re-hash, the rest is copied as it is
        g = np.random.default_rng(4)
        empty = carry.occ == 0
        n = int(empty.sum())
        carry.keys[empty] = torch.from_numpy(g.integers(
            -2**31, 2**31, (n, key_words(48)), dtype=np.int64
        ).astype(np.int32))
        carry.occ[empty] = torch.from_numpy(
            g.choice(np.array([0, 2, -1], np.int32), n))
        assert int((carry.occ == 1).sum()) > 0
    lanes = np.random.default_rng(5).permutation(LANES)[:20]
    rc, got = _compact(comp, carry, lanes, 32, slots)
    assert rc == 0
    want = compact_carry_plain(carry, lanes, 32, slots)
    _assert_equal(got, want, f"compacting {old_slots} -> {slots} slots")
    assert torch.equal(got.dsi[STATUS, 20:], torch.ones(12, dtype=torch.int32))
    if slots and old_slots and slots < old_slots:
        # the shrunk table lost entries to collisions, and kept the rest
        assert 0 < int((got.occ == 1).sum()) < int(
            (carry.occ[torch.from_numpy(lanes)] == 1).sum())


@pytest.mark.parametrize("old_slots,slots", [(64, 256), (64, 64)])
def test_compact_source_matches_plain_on_a_full_card(host_libs, old_slots,
                                                     slots):
    """At an H100's SM count every pass fits its grid: each thread takes
    one trip of its grid-stride loop (the other tests cap the grid at 16
    blocks, so that the loops take several)."""
    step, comp = host_libs
    tabs, init, S = _tables("queue", 48)
    carry = _start(tabs, init, S, old_slots)
    for _ in range(3):
        stepper_chunk_plain(tabs, carry, chunk=CHUNK, budget=BUDGET)
    lanes = np.random.default_rng(6).permutation(LANES)[:25]
    rc, got = _compact(comp, carry, lanes, 32, slots, sms=H100_SMS)
    assert rc == 0
    _assert_equal(got, compact_carry_plain(carry, lanes, 32, slots),
                  f"compacting {old_slots} -> {slots} slots")


def test_compact_entry_refuses_bad_arguments(host_libs):
    step, comp = host_libs
    tabs, init, S = _tables("queue", 48)
    carry = _start(tabs, init, S, 64)
    N, kw = 48, key_words(48)
    lanes = torch.arange(8, dtype=torch.int32)
    out = StepperCarry(*(torch.zeros(s, dtype=torch.int32) for s in (
        (N, 8), (N + 1, 8), (N + 1, 8), (5, 8), (8, 64, kw), (8, 64), (8,))))
    win = torch.zeros(8 * 64, dtype=torch.int32)
    ptrs = [*(t.data_ptr() for t in carry), lanes.data_ptr(),
            *(t.data_ptr() for t in out), win.data_ptr()]
    for bad in ((LANES, 8, 9, N, 0, kw, 64, 64, 1),  # more lanes than bucket
                (LANES, 8, 8, N, 0, kw, 48, 64, 1),  # old slots not 2**k
                (LANES, 8, 8, N, 0, kw, 64, 96, 1),  # new slots not 2**k
                (LANES, 8, 8, N, 0, 1, 64, 64, 1),   # no state word
                (LANES, 8, 8, N, 0, kw, 64, 64, 0)):  # no SM
        assert comp(*ptrs, *bad, None) == 1, bad
    assert comp(*ptrs, LANES, 8, 8, N, 0, kw, 64, 64, 1, None) == 0
