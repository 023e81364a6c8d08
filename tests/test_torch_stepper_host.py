"""The CUDA sources of ``stepper_chunk`` and ``compact_carry`` compiled for
the host and held against their plain versions, bit for bit on every carry
plane, on the CPU.

Both kernels share nothing between threads (one thread owns one lane), so
running every thread of a block one after another gives what the card
gives.  The test rewrites each source's one CUDA-only line (the ``<<<>>>``
launch), compiles it with the host C++ compiler against
``tests/cuda_host/cuda_runtime.h``, and calls its C entry through ctypes
on CPU tensors: ``stepper_chunk`` under all eight template instantiations
(1 to 4 bitmask words, memo off and on) with start states outside the
table and decided lanes, two chunks in a row; ``compact_carry`` with the
memo kept, grown, shrunk (collisions), dropped and created.  What only the
card can show (that ``nvcc`` builds them, the timing) is in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

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
from qsm_tpu_torch.ops.kernels import CSRC_DIR
from qsm_tpu_torch.ops.scalarize import scalar_shadow
from qsm_tpu_torch.ops.stepper_kernel import (
    RUNNING, STATUS, StepperCarry, compact_carry_plain, fresh_stepper_carry,
    key_words, n_words, stepper_chunk_plain, stepper_tables)
from qsm_tpu_torch.utils.corpus import build_corpus

SHIM = Path(__file__).resolve().parent / "cuda_host"
LANES = 40  # not a multiple of 32: the last block is part empty
CHUNK = 96
BUDGET = 552_000
_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = ("kern<<<grid, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a);",
           "host_launch(kern, grid, LANES, 0, a);")


def _host_lib(name: str, tmp: Path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (CSRC_DIR / f"{name}.cu").read_text()
    cuda, host = _LAUNCH
    assert src.count(cuda) == 1, f"{name}.cu no longer has: {cuda}"
    (tmp / f"{name}.cpp").write_text(src.replace(cuda, host))
    lib = tmp / f"{name}.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{SHIM}", "-o", str(lib), str(tmp / f"{name}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stepper_host")
    step = _host_lib("stepper_chunk", tmp).stepper_chunk_launch
    step.argtypes = [_P] * 12 + [_I] * 8 + [_P]
    step.restype = _I
    comp = _host_lib("compact_carry", tmp).compact_carry_launch
    comp.argtypes = [_P] * 15 + [_I] * 7 + [_P]
    comp.restype = _I
    return step, comp


def _tables(model: str, n_ops: int):
    if model == "queue":
        spec, suts, pids = QueueSpec(), (AtomicQueueSUT,
                                         RacyTwoPhaseQueueSUT), 8
    else:
        spec, suts, pids = CasSpec(), (AtomicCasSUT, RacyCasSUT), 8
    hs = build_corpus(spec, suts, n=LANES, n_pids=pids, max_ops=n_ops,
                      seed_base=31, seed_prefix="host")
    kspec = scalar_shadow(spec) or spec
    N = bucket_for(max(len(h) for h in hs))
    assert N == n_ops, (N, n_ops)
    enc = encode_batch(hs, kspec.initial_state(), max_ops=N)
    tabs = stepper_tables(kspec, enc.ops[:, :, 1], enc.ops[:, :, 2],
                          enc.ops[:, :, 3], enc.valid, enc.precedes(), "cpu")
    return tabs, int(enc.init_state[0]), kspec.scalar_state_bound(N)


def _step(fn, tabs, carry: StepperCarry, chunk: int) -> int:
    R, S, N = tabs.nxt.shape
    return fn(*(t.data_ptr() for t in tabs), carry.row.data_ptr(),
              *(t.data_ptr() for t in carry[:6]), carry.row.shape[0], R, N,
              S, n_words(N), carry.occ.shape[1], chunk, BUDGET, None)


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
                               tabs.nxt.shape[2], slots)


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("model,n_ops", [("cas", 32), ("queue", 48),
                                         ("cas", 64), ("cas", 96),
                                         ("cas", 128)])
def test_stepper_source_matches_plain(host_libs, model, n_ops, slots):
    step, _ = host_libs
    tabs, init, S = _tables(model, n_ops)
    carry = _start(tabs, init, S, slots)
    for k in range(2):
        got, want = _clone(carry), _clone(carry)
        assert _step(step, tabs, got, CHUNK) == 0
        stepper_chunk_plain(tabs, want, chunk=CHUNK, budget=BUDGET)
        _assert_equal(got, want, f"after chunk {k + 1}")
        carry = got
    status = carry.dsi[STATUS]
    assert int((status == RUNNING).sum()) > 0   # lanes still searching
    assert int((status == 3).sum()) >= 6        # the out-of-table starts
    if slots:
        assert int((carry.occ == 1).sum()) > 0  # the memo was exercised


def test_stepper_entry_refuses_bad_arguments(host_libs):
    step, _ = host_libs
    tabs, init, S = _tables("cas", 32)
    carry = _start(tabs, init, S, 64)
    R, S, N = tabs.nxt.shape
    ptrs = [*(t.data_ptr() for t in tabs), carry.row.data_ptr(),
            *(t.data_ptr() for t in carry[:6])]
    for bad in ((LANES, R, N, S, 2, 64, CHUNK),    # W does not fit N
                (LANES, R, 129, S, 5, 64, CHUNK),  # N past 128
                (LANES, R, N, S, 1, 48, CHUNK)):   # slots not a power of 2
        assert step(*ptrs, *bad, BUDGET, None) == 1


def _compact(fn, carry: StepperCarry, lanes: np.ndarray, bucket: int,
             slots: int) -> tuple:
    N = carry.taken.shape[0]
    out = StepperCarry(*(torch.full(s, 12345, dtype=torch.int32) for s in (
        (N, bucket), (N + 1, bucket), (N + 1, bucket), (5, bucket),
        (bucket, slots, key_words(N)), (bucket, slots), (bucket,))))
    idx = torch.from_numpy(lanes.astype(np.int32))
    rc = fn(*(t.data_ptr() for t in carry), idx.data_ptr(),
            *(t.data_ptr() for t in out), carry.row.shape[0], bucket,
            len(lanes), N, key_words(N), carry.occ.shape[1], slots, None)
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
