"""The CUDA source of ``dfs_chunk`` compiled for the host and held against
``dfs_chunk_plain``, bit for bit on all seven carry planes, on the CPU.

``csrc/dfs_chunk.cu`` shares nothing between threads (each thread owns one
lane's column of shared memory), so running every thread of a block one
after another gives what the card gives.  The test rewrites the source's
two CUDA-only lines, compiles it with the host C++ compiler against
``tests/cuda_host/cuda_runtime.h``, and calls its C entry through ctypes
on CPU tensors, under every launch plan: ``nxt`` staged or read from the
table, the memo off, in shared memory or in the table, N = 12 and 32, a
ragged last block, start states outside the table, garbage in the memo's
empty slots, two chunks in a row.  What only the card can show (that
``nvcc`` builds it, the timing) is in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.ops.dfs_kernel import (MEMO_GLOBAL, MEMO_OFF, MEMO_SHARED,
                                          Carry, dfs_chunk_plain, launch_plan)
from qsm_tpu_torch.ops.gpu_backend import fresh_carry, lane_tables
from qsm_tpu_torch.ops.kernels import CSRC_DIR
from qsm_tpu_torch.utils.corpus import build_corpus, random_lane_tables

SHIM = Path(__file__).resolve().parent / "cuda_host"
LANES = 40  # not a multiple of 32: the last block is part empty
CHUNK = 128
_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (CSRC_DIR / "dfs_chunk.cu").read_text()
    for cuda, host in (
            ("extern __shared__ int32_t smem[];",
             "int32_t* smem = host_smem;"),
            ("kern<<<grid, LANES, smem_bytes, "
             "static_cast<cudaStream_t>(stream)>>>(a);",
             "host_launch(kern, grid, LANES, smem_bytes, a);")):
        assert src.count(cuda) == 1, f"dfs_chunk.cu no longer has: {cuda}"
        src = src.replace(cuda, host)
    out = tmp_path_factory.mktemp("dfs_host")
    (out / "dfs_chunk_host.cpp").write_text(src)
    lib = out / "dfs_chunk_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{SHIM}", "-o", str(lib),
                    str(out / "dfs_chunk_host.cpp")], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).dfs_chunk_launch
    fn.argtypes = [_P] * 19 + [_I] * 12 + [_P]
    fn.restype = _I
    return fn


def _run(fn, tabs, carry, cs, budget, plan=None) -> tuple:
    S, N, B = tabs.nxt.shape
    plan = plan or launch_plan(B, N, S, cs)
    out = Carry(*(torch.full_like(t, 12345) for t in carry))
    rc = fn(*(t.data_ptr() for t in tabs), *(t.data_ptr() for t in carry),
            *(t.data_ptr() for t in out), B, N, S, carry.ck0.shape[0], cs,
            CHUNK, budget, *(int(x) for x in plan), None)
    return rc, out


def _scramble_empty_slots(carry: Carry) -> Carry:
    g = np.random.default_rng(9)
    occ, ck0, ck1 = (t.numpy().copy() for t in (carry.occ, carry.ck0,
                                                carry.ck1))
    empty = occ != 1
    n = int(empty.sum())
    ck0[empty] = g.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    ck1[empty] = g.integers(-5, 70, n).astype(np.int32)
    occ[empty] = g.choice(np.array([0, 2, -1], np.int32), n)
    return carry._replace(ck0=torch.from_numpy(ck0),
                          ck1=torch.from_numpy(ck1),
                          occ=torch.from_numpy(occ))


@pytest.mark.parametrize("cs", [0, 64, 1024])
@pytest.mark.parametrize("n_states", [5, 64])
@pytest.mark.parametrize("n_ops", [12, 32])
def test_cuda_source_matches_plain_under_every_plan(host_kernel, n_ops,
                                                    n_states, cs):
    if n_states == 5:  # the CAS step tables: nxt staged in shared memory
        spec = CasSpec()
        hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=LANES,
                          n_pids=4 if n_ops == 12 else 8, max_ops=n_ops,
                          seed_base=77, seed_prefix="plan")
        tabs = lane_tables(spec, hs, n_ops, LANES, "cpu")
        starts = np.zeros(LANES, np.int32)
        budget = 552_000
    else:  # random tables too large to stage: nxt read from the table
        tabs = random_lane_tables(n_ops, n_states, LANES, seed=n_ops,
                                  device="cpu")
        starts = np.random.default_rng(5).integers(0, n_states, LANES)
        budget = 300  # some lanes run out of budget
    starts[::7] = 7
    starts[3::11] = -2
    plan = launch_plan(LANES, n_ops, n_states, cs)
    assert plan.stage_nxt == (n_states == 5)
    assert plan.memo == {0: MEMO_OFF, 64: MEMO_SHARED, 1024: MEMO_GLOBAL}[cs]
    carry = fresh_carry(tabs.nreq, starts.astype(np.int32), n_ops, cs)
    for k in range(2):
        if k == 1 and cs:
            carry = _scramble_empty_slots(carry)
        rc, got = _run(host_kernel, tabs, carry, cs, budget, plan)
        assert rc == 0
        want = dfs_chunk_plain(tabs, carry, chunk=CHUNK, budget=budget,
                               cache_slots=cs)
        for name, a, b in zip(Carry._fields, got, want):
            assert torch.equal(a, b), f"{name} differs after chunk {k + 1}"
        carry = got
    if cs:
        assert int((carry.occ == 1).sum()) > 0  # the memo was exercised


def test_c_entry_refuses_plans_it_cannot_launch(host_kernel):
    spec = CasSpec()
    hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=32, n_pids=8,
                      max_ops=32, seed_base=77, seed_prefix="plan")
    tabs = lane_tables(spec, hs, 32, 32, "cpu")
    carry = fresh_carry(tabs.nreq, np.zeros(32, np.int32), 32, 64)
    plan = launch_plan(32, 32, 5, 64)
    assert _run(host_kernel, tabs, carry, 64, 1000, plan)[0] == 0
    for bad in (plan._replace(smem_bytes=plan.smem_bytes - 4),
                plan._replace(lanes_per_block=64),
                plan._replace(grid=2),
                plan._replace(memo=MEMO_OFF),
                plan._replace(stage_nxt=False)):
        assert _run(host_kernel, tabs, carry, 64, 1000, bad)[0] == 1, bad
    # the right sum for a staged 1024-slot memo, above the 227 KB a block
    big = fresh_carry(tabs.nreq, np.zeros(32, np.int32), 32, 1024)
    rows = 2 * 33 + 5 + 32 + 5 * 32 + 2 * 1024 + 1024 // 32
    over = launch_plan(32, 32, 5, 1024)._replace(
        memo=MEMO_SHARED, stage_nxt=True, smem_bytes=rows * 128)
    assert _run(host_kernel, tabs, big, 1024, 1000, over)[0] == 1
