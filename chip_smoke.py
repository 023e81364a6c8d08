#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``qsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OLD.cu   # also time an earlier kernel

Phases, in order; any failure exits non-zero and no result is printed:

1. device: the card's name and power limit (``nvidia-smi``), the torch
   device name and count;
2. build: ``nvcc`` compiles every kernel from the sources in the checkout,
   one process a source, all started together; the ``-Xptxas -v``
   register / stack / spill lines are printed (a spill fails the run),
   beside the launch plans of phase 3 (lanes per block, shared bytes,
   what is staged in shared memory);
3. kernel against plain: ``dfs_chunk`` on the headline CAS corpus' step
   tables (32 ops x 8 pids) with mid-search carries, at 4096 and 16384
   lanes, memo off and at 64 slots, and on random 64-state tables at 4096
   lanes (too large to stage: ``nxt`` read from global memory), after 1
   and 8 chunks of 1024 iterations: every output plane must be
   bit-identical to ``dfs_chunk_plain`` on the same CUDA tensors
   (tolerance 0, all integer).  Then the kernel is timed with CUDA events
   and the plain version once.  With ``--against OLD.cu`` (an earlier
   ``dfs_chunk.cu`` whose C entry takes 19 pointers, 7 ints and the
   stream, without a launch plan), that kernel is built too and timed in
   turns with this one (old, new, new, old) on the same inputs, after
   both are checked equal;
4. checker (main path of ``TorchGPU``): ``TorchGPU.check_histories`` on
   512 unique histories replicated to 4096 lanes; 0 verdict mismatches
   against the memo oracle wherever both decided; witnesses replay
   through ``verify_witness``; one more warm run under ``torch.profiler``
   gives the device's busy time and idle share;
5. property (main path of ``TorchGPU``): ``prop_concurrent`` at 8 pids x
   32 ops, 100 trials, seed 0 — racy CAS convicted with a shrunk
   counterexample, atomic CAS passed — and the same racy run through the
   CLI entry point;
6. stepper kernels against plain: ``stepper_chunk`` on the queue
   headline's tables (48 ops x 8 pids, 512 unique histories at 4096
   lanes), memo off and at the port's slot count for that bucket, from a
   fresh and from a mid-search carry, after 1 and 8 chunks of 2048
   iterations, and on CAS histories of 64 and 128 ops at 1024 lanes after
   1 and 2 chunks;
   ``compact_carry`` from 4096 lanes to 256 with the memo growing, and out
   of a carry without a memo; every plane bit-identical to the plain
   version (tolerance 0).  Then each kernel is timed with CUDA events and
   its plain version once;
7. queue checker (main path of ``TorchStepper``): ``check_histories`` on
   the 512 unique queue histories replicated to 4096 lanes, at the
   default budget; 0 verdict mismatches against the memo oracle,
   witnesses replayed, one warm run profiled (histories/s, device busy
   time and idle share, rounds, compactions, launches of each kernel);
8. queue property (main path of ``TorchStepper``): ``prop_concurrent`` at
   8 pids x 48 ops, 100 trials — racy queue convicted with a shrunk
   counterexample, atomic queue passed — and the racy run again through
   ``python -m qsm_tpu_torch run --model queue --backend stepper``.

Each main path's launch counts are reset just before it and read just
after (``dfs_chunk`` over phases 4-5, ``stepper_chunk`` and
``compact_carry`` over phases 7-8).  The second-to-last stdout line is the
kernels record, the last the device record.  Every number is printed
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qsm_tpu_torch.core.history import encode_batch
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                        RacyTwoPhaseQueueSUT)
from qsm_tpu_torch.ops import kernels
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.dfs_kernel import (MEMO_GLOBAL, MEMO_SHARED, RUNNING,
                                          Carry, blocks_per_sm, dfs_chunk,
                                          dfs_chunk_plain, launch_plan)
from qsm_tpu_torch.ops.gpu_backend import TorchGPU, fresh_carry, lane_tables
from qsm_tpu_torch.ops.host_contracts import flatten
from qsm_tpu_torch.ops.scalarize import scalar_shadow
from qsm_tpu_torch.ops.stepper import TorchStepper, default_slots
from qsm_tpu_torch.ops.stepper_kernel import (StepperCarry, compact_carry,
                                              compact_carry_plain,
                                              fresh_stepper_carry, key_words,
                                              n_words, stepper_chunk,
                                              stepper_chunk_plain,
                                              stepper_tables)
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils import cli
from qsm_tpu_torch.utils.corpus import build_corpus, random_lane_tables

N_PIDS, N_OPS = 8, 32          # the headline configuration
N_UNIQUE, DEVICE_BATCH = 512, 4096
CHUNK = TorchGPU.CHUNK
TOTAL_BUDGET = 552_000         # TorchGPU's default per-lane cap
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# peak for the kernel's 32-bit scalar ALU ops: the "float32 outside the
# tensor cores" rate of the H100 SXM data sheet (no int32 row is
# published); a generous peak keeps the bound a lower bound
SCALAR_OPS_PER_S = 67e12
RANDOM_STATES = 64             # the global-table case: nxt is not staged
Q_PIDS, Q_OPS = 8, 48          # the queue headline (the registry default)
STEP_CHUNK = 2048              # stepper iterations a launch in phase 6
COMPACT_TO = 256               # phase 6's compaction: 4096 lanes -> 256


def ops_per_iteration(n_ops: int) -> int:
    """Integer ops of one DFS iteration, counted from the kernel source:
    the blocked-op sweep costs 5 per op (and, compare, select, shift, or),
    the rest of the iteration (candidate mask, first candidate, memo
    probe, stack update, status, budget) about 40."""
    return 5 * n_ops + 40


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def carry_bytes(c: Carry) -> int:
    return sum(t.numel() * t.element_size() for t in c)


def kernel_bound(tabs, c_in: Carry, c_out: Carry):
    """(bound_ms, bound_by, bytes, ops): each input read once, each
    output written once, against the iterations this run's data needed."""
    nbytes = (sum(t.numel() * t.element_size() for t in tabs)
              + carry_bytes(c_in) + carry_bytes(c_out))
    iters = int((c_out.dsi[2].long() - c_in.dsi[2].long()).sum())
    ops = iters * ops_per_iteration(tabs.nxt.shape[1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def new_kernel(tabs, carry, cs) -> Carry:
    return dfs_chunk(tabs, carry, chunk=CHUNK, budget=TOTAL_BUDGET,
                     cache_slots=cs)


def time_kernel(tabs, carry, cs, launch=new_kernel, reps=20) -> float:
    """Mean ms per launch over ``reps`` warm launches of ``launch`` on the
    same inputs (CUDA events)."""
    for _ in range(3):
        launch(tabs, carry, cs)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        launch(tabs, carry, cs)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_plain(tabs, carry, cs) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dfs_chunk_plain(tabs, carry, chunk=CHUNK, budget=TOTAL_BUDGET,
                    cache_slots=cs)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_device(fn):
    """(wall_s, device_s, top) of ``fn()`` under ``torch.profiler``:
    ``device_s`` sums the CUDA kernels' own time (0.0 if the profiler saw
    none), ``top`` the three kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    top = [dict(name=e.key[:60], calls=e.count,
                device_s=e.self_device_time_total / 1e6) for e in kern[:3]]
    return wall, sum(e.self_device_time_total for e in kern) / 1e6, top


def plan_text(B, S, cs) -> str:
    p = launch_plan(B, N_OPS, S, cs)
    memo = {MEMO_SHARED: "memo in shared", MEMO_GLOBAL: "memo in global"
            }.get(p.memo, "memo off")
    return (f"B={B} S={S} slots={cs}: {p.lanes_per_block} lanes/block, grid "
            f"{p.grid}, {p.smem_bytes} shared bytes/block, "
            f"{blocks_per_sm(p)} blocks/SM; okw, stacks, succ in shared, "
            f"{memo}, nxt in {'shared' if p.stage_nxt else 'global'}")


def kernel_cases(spec, corpus, dev):
    """(name, B, tables, start states) of phase 3: the headline CAS tables
    at 4096 and 16384 lanes, and random 64-state tables at 4096."""
    for B in (4096, 16384):
        lanes = (corpus * math.ceil(B / len(corpus)))[:B]
        yield "cas", B, lane_tables(spec, lanes, N_OPS, B, dev), \
            np.zeros(B, np.int32)
    B = 4096
    starts = np.random.default_rng(0).integers(0, RANDOM_STATES, B)
    yield (f"random{RANDOM_STATES}", B,
           random_lane_tables(N_OPS, RANDOM_STATES, B, seed=0, device=dev),
           starts.astype(np.int32))


def phase_kernel(spec, corpus, dev, tag):
    """Phase 3: dfs_chunk against dfs_chunk_plain, then timings."""
    max_err = 0
    timings = []
    for name, B, tabs, starts in kernel_cases(spec, corpus, dev):
        for cs in (0, 64):
            fresh = fresh_carry(tabs.nreq, starts, N_OPS, cs)
            # mid-search: a quarter chunk in, the hard lanes still running
            mid = dfs_chunk_plain(tabs, fresh, chunk=CHUNK // 4,
                                  budget=TOTAL_BUDGET, cache_slots=cs)
            running = int((mid.dsi[1] == RUNNING).sum())
            require(running > 0, "mid-search carry has no running lane")
            ck, cp = mid, mid
            for i in range(8):
                ck = dfs_chunk(tabs, ck, chunk=CHUNK, budget=TOTAL_BUDGET,
                               cache_slots=cs)
                cp = dfs_chunk_plain(tabs, cp, chunk=CHUNK,
                                     budget=TOTAL_BUDGET, cache_slots=cs)
                if i in (0, 7):
                    torch.cuda.synchronize()
                    for plane, a, b in zip(Carry._fields, ck, cp):
                        err = int((a.long() - b.long()).abs().max())
                        max_err = max(max_err, err)
                        require(err == 0, f"dfs_chunk {plane} differs from "
                                f"plain on {name} at B={B} slots={cs} after "
                                f"{i + 1} chunk(s) (max abs err {err})")
            print(f"{tag} dfs_chunk == plain on {name} tables at B={B} "
                  f"slots={cs}: all 7 planes bit-identical after 1 and 8 "
                  f"chunks ({running} lanes running at the start)",
                  flush=True)
            one = dfs_chunk(tabs, mid, chunk=CHUNK, budget=TOTAL_BUDGET,
                            cache_slots=cs)
            bound_ms, bound_by, nbytes, ops = kernel_bound(tabs, mid, one)
            ms = time_kernel(tabs, mid, cs)
            row = dict(tables=name, B=B, slots=cs, ms=ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=ops,
                       running_lanes=running, tabs=tabs, mid=mid)
            if B == 4096:  # the plain version once, at the headline width
                row["plain_ms"] = time_plain(tabs, mid, cs)
            timings.append(row)
            print(f"{tag} dfs_chunk {name} B={B} slots={cs}: {ms:.4f} "
                  f"ms/launch "
                  f"of {CHUNK} iterations (bound {bound_ms:.6f} ms by "
                  f"{bound_by}: {nbytes} B, {ops} ops; plain "
                  f"{row.get('plain_ms', float('nan')):.1f} ms)",
                  flush=True)
    return max_err, timings


def old_kernel(src: Path):
    """A launcher for the earlier kernel at ``src``, built like this one,
    through its first C entry (19 pointers, 7 ints, the stream)."""
    lib = ctypes.CDLL(str(kernels.build("dfs_chunk_against", src=src)))
    fn = lib.dfs_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(tabs, carry, cs) -> Carry:
        S, N, B = tabs.nxt.shape
        out = Carry(*(torch.empty_like(t) for t in carry))
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in tabs),
                *(t.data_ptr() for t in carry),
                *(t.data_ptr() for t in out), B, N, S, carry.ck0.shape[0],
                cs, CHUNK, TOTAL_BUDGET, stream)
        require(rc == 0, f"the earlier kernel's launch failed ({rc})")
        return out
    return launch


def phase_against(src: Path, timings, tag):
    """The earlier kernel and this one in turns (old, new, new, old) on
    each phase-3 case's mid-search carry, after checking them equal."""
    old = old_kernel(src)
    for line in kernels.ptxas_report("dfs_chunk_against", src).splitlines():
        if any(k in line for k in ("registers", "stack frame")):
            print(f"  ptxas (earlier kernel): {line.strip()}")
    for row in timings:
        tabs, mid, cs = row["tabs"], row["mid"], row["slots"]
        a, b = old(tabs, mid, cs), new_kernel(tabs, mid, cs)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"the earlier kernel differs on {row['tables']} B={row['B']}")
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_kernel(
                tabs, mid, cs, launch=old if who == "old" else new_kernel))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        row["old_ms"] = o
        print(f"{tag} earlier vs this dfs_chunk, {row['tables']} "
              f"B={row['B']} slots={cs} (old, new, new, old): "
              f"old {turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)


def phase_checker(spec, corpus, tag):
    """Phase 4: the checker on the headline corpus."""
    g = TorchGPU(spec)
    device_corpus = (corpus * math.ceil(DEVICE_BATCH / len(corpus))
                     )[:DEVICE_BATCH]
    t0 = time.perf_counter()
    cold = g.check_histories(spec, device_corpus)
    cold_s = time.perf_counter() - t0
    launches0, cost0 = g.chunk_launches, g.lockstep_cost
    t0 = time.perf_counter()
    v = g.check_histories(spec, device_corpus)
    warm_s = time.perf_counter() - t0
    launches, cost = g.chunk_launches - launches0, g.lockstep_cost - cost0
    require(v.tolist() == cold.tolist(), "verdicts differ between runs")
    prof_wall, busy_s, top = profile_device(
        lambda: g.check_histories(spec, device_corpus))
    t0 = time.perf_counter()
    ov = WingGongCPU(memo=True).check_histories(spec, corpus)
    oracle_s = time.perf_counter() - t0
    uv = v[:len(corpus)]
    both = (uv != Verdict.BUDGET_EXCEEDED) & (ov != Verdict.BUDGET_EXCEEDED)
    mismatches = int(((uv != ov) & both).sum())
    require(mismatches == 0, f"{mismatches} verdict mismatches vs oracle")
    lin = [h for h, x in zip(corpus, uv) if x == Verdict.LINEARIZABLE][:32]
    for h in lin:
        wv, wit = g.check_witness(spec, h)
        require(wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit),
                "a LINEARIZABLE witness failed to replay")
    undecided = int((v == Verdict.BUDGET_EXCEEDED).sum())
    print(f"{tag} checker: {len(device_corpus)} histories ({len(corpus)} "
          f"unique) warm {warm_s:.3f} s = "
          f"{len(device_corpus) / warm_s:.1f} histories/s (cold "
          f"{cold_s:.3f} s); chunk_launches {launches}, lockstep_cost "
          f"{cost}, undecided {undecided}; vs memo oracle ({oracle_s:.2f} s "
          f"on the host): 0 mismatches "
          f"({int((uv == Verdict.LINEARIZABLE).sum())} linearizable, "
          f"{int((uv == Verdict.VIOLATION).sum())} violations); "
          f"{len(lin)} witnesses replayed", flush=True)
    idle = f"{1 - busy_s / prof_wall:.3f}" if busy_s else "not measured"
    print(f"{tag} checker profiled: wall {prof_wall:.3f} s, device busy "
          f"{busy_s:.3f} s, idle share {idle}; top kernels {top}",
          flush=True)


def phase_property(spec, tag):
    """Phase 5: the property loop, racy convicted, atomic passed."""
    for impl, sut_cls, want_ok in (("racy", RacyCasSUT, False),
                                   ("atomic", AtomicCasSUT, True)):
        g = TorchGPU(spec)
        cfg = PropertyConfig(n_trials=100, n_pids=N_PIDS, max_ops=N_OPS,
                             seed=0)
        t0 = time.perf_counter()
        res = prop_concurrent(spec, sut_cls(spec), cfg, backend=g)
        dt = time.perf_counter() - t0
        require(res.ok == want_ok and res.undecided == 0,
                f"{impl} CAS: ok={res.ok} undecided={res.undecided}")
        what = ""
        if not want_ok:
            cx = res.counterexample
            require(cx is not None and cx.shrink_steps > 0
                    and len(cx.program) < N_OPS,
                    "racy CAS counterexample was not shrunk")
            what = (f", counterexample {len(cx.program)} ops after "
                    f"{cx.shrink_steps} shrink steps")
        print(f"{tag} property {impl} CAS {N_PIDS} pids x {N_OPS} ops: "
              f"ok={res.ok} after {res.trials_run} trials, "
              f"{res.histories_checked} histories, {dt:.2f} s, "
              f"{g.chunk_launches} chunk launches{what}", flush=True)
    rc = cli.main(["run", "--model", "cas", "--impl", "racy", "--backend",
                   "gpu", "--trials", "100", "--pids", str(N_PIDS),
                   "--ops", str(N_OPS)])
    require(rc == 1, f"the CLI did not convict racy CAS (rc {rc})")


def stepper_ops_per_iteration(n_ops: int, memo: bool) -> int:
    """Integer ops of one stepper iteration, counted from
    ``csrc/stepper_chunk.cu``: the blocked-op sweep costs 2W + 2 per op
    (W ands, W ors, a compare, a clear), the candidate words and the
    lowest one 3W + 4, the stack update, status and budget about 26; the
    memo's two hashes and the key compare 6 kw + 5 more."""
    w = n_words(n_ops)
    ops = n_ops * (2 * w + 2) + 3 * w + 30
    return ops + (6 * key_words(n_ops) + 5 if memo else 0)


def _tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def stepper_bound(tabs, c_in: StepperCarry, c_out: StepperCarry):
    """(bound_ms, bound_by, bytes, ops) of one ``stepper_chunk`` launch:
    every lane's stacks and counters read and written once, the
    predecessor words of the lanes that ran read once (the table entries
    an iteration reads are not counted: a lower bound), against the
    iterations this run's data needed."""
    ran = (c_out.dsi[2] - c_in.dsi[2]) > 0
    iters = int((c_out.dsi[2].long() - c_in.dsi[2].long()).sum())
    n = tabs.nxt.shape[2]
    stacks = _tensor_bytes((c_in.taken, c_in.chosen, c_in.states, c_in.dsi,
                            c_in.row))
    nbytes = 2 * stacks + int(ran.sum()) * 4 * (
        tabs.prec.shape[1] * n + tabs.prec.shape[1] + 1)
    ops = iters * stepper_ops_per_iteration(n, c_in.occ.shape[1] > 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def compact_bound(c_in: StepperCarry, c_out: StepperCarry, m: int):
    """(bound_ms, bytes) of one ``compact_carry``: the ``m`` surviving
    lanes' planes and memo read once, the new carry written once; its few
    operations a word are far below the byte side."""
    B = c_in.row.shape[0]
    per_lane_in = _tensor_bytes(c_in) // B
    nbytes = m * (per_lane_in + 4) + _tensor_bytes(c_out)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def clone_carry(c: StepperCarry) -> StepperCarry:
    return StepperCarry(*(t.clone() for t in c))


def queue_corpus():
    spec = QueueSpec()
    return spec, build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                              n=N_UNIQUE, n_pids=Q_PIDS, max_ops=Q_OPS,
                              seed_base=1000, seed_prefix="bench")


def _replicate(corpus, B):
    return (corpus * math.ceil(B / len(corpus)))[:B]


def stepper_inputs(spec, histories, n_ops, dev):
    kspec = scalar_shadow(spec) or spec
    enc = encode_batch(histories, kspec.initial_state(), max_ops=n_ops)
    tabs = stepper_tables(kspec, enc.ops[:, :, 1], enc.ops[:, :, 2],
                          enc.ops[:, :, 3], enc.valid, enc.precedes(), dev)
    return tabs, np.full(len(histories), int(enc.init_state[0]), np.int32)


def stepper_cases(q_spec, q_corpus, dev):
    """(name, B, tables, start states) of phase 6: the queue headline at
    4096 lanes, and CAS histories of 64 and 128 ops at 1024."""
    B = DEVICE_BATCH
    tabs, starts = stepper_inputs(q_spec, _replicate(q_corpus, B), Q_OPS,
                                  dev)
    yield "queue48", B, tabs, starts
    cas = CasSpec()
    for n_ops in (64, 128):
        hs = build_corpus(cas, (AtomicCasSUT, RacyCasSUT), n=256,
                          n_pids=N_PIDS, max_ops=n_ops, seed_base=1000,
                          seed_prefix="bench")
        tabs, starts = stepper_inputs(cas, _replicate(hs, 1024), n_ops, dev)
        yield f"cas{n_ops}", 1024, tabs, starts


def _compare(name, got, want):
    err = 0
    for plane, a, b in zip(StepperCarry._fields, got, want):
        e = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        err = max(err, e)
        require(e == 0, f"{name}: {plane} differs from plain (max abs err "
                f"{e})")
    return err


def time_launches(launch, inputs, reps: int) -> float:
    """Mean ms per launch of ``launch(x)`` over ``inputs`` (one each),
    CUDA events, after one warm launch on a spare input."""
    launch(inputs[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for x in inputs[1:reps + 1]:
        launch(x)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_stepper(q_spec, q_corpus, dev, tag):
    """Phase 6: stepper_chunk and compact_carry against their plain
    versions, then timings and bounds."""
    max_err, rows, carries = 0, {}, {}
    for name, B, tabs, starts in stepper_cases(q_spec, q_corpus, dev):
        N = tabs.nxt.shape[2]
        for slots in (0, default_slots(B)):
            fresh = fresh_stepper_carry(tabs.nreq, np.arange(B), starts, B,
                                        N, slots)
            begins = {"fresh": fresh}
            if name == "queue48":
                # mid-search: 256 plain iterations in, the hard lanes
                # still running
                begins["mid"] = stepper_chunk_plain(
                    tabs, clone_carry(fresh), chunk=256, budget=TOTAL_BUDGET)
            # the plain version's loop is the phase's cost: the CAS
            # shapes run 2 chunks, the queue headline all 8
            n_chunks = 8 if name == "queue48" else 2
            for start, c0 in begins.items():
                ck, cp = clone_carry(c0), clone_carry(c0)
                running = int((c0.dsi[1] == RUNNING).sum())
                for i in range(n_chunks):
                    stepper_chunk(tabs, ck, chunk=STEP_CHUNK,
                                  budget=TOTAL_BUDGET)
                    stepper_chunk_plain(tabs, cp, chunk=STEP_CHUNK,
                                        budget=TOTAL_BUDGET)
                    if i in (0, n_chunks - 1):
                        torch.cuda.synchronize()
                        max_err = max(max_err, _compare(
                            f"stepper_chunk {name} B={B} slots={slots} "
                            f"{start} chunk {i + 1}", ck, cp))
                print(f"{tag} stepper_chunk == plain on {name} B={B} "
                      f"slots={slots} from a {start} carry ({running} lanes "
                      f"running): all 7 planes bit-identical after 1 and "
                      f"{n_chunks} chunks of {STEP_CHUNK}; "
                      f"{int((ck.dsi[1] == RUNNING).sum())} still running",
                      flush=True)
                carries[(name, slots, start)] = ck
            if name != "queue48":
                continue
            # timing: a chunk from the mid-search carry, each launch on
            # its own copy (the kernel updates the carry in place)
            mid = begins["mid"]
            reps = 5
            copies = [clone_carry(mid) for _ in range(reps + 1)]
            ms = time_launches(lambda c: stepper_chunk(
                tabs, c, chunk=STEP_CHUNK, budget=TOTAL_BUDGET), copies, reps)
            one = stepper_chunk(tabs, clone_carry(mid), chunk=STEP_CHUNK,
                                budget=TOTAL_BUDGET)
            bound_ms, bound_by, nbytes, ops = stepper_bound(tabs, mid, one)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stepper_chunk_plain(tabs, clone_carry(mid), chunk=STEP_CHUNK,
                                budget=TOTAL_BUDGET)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            rows[slots] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
            print(f"{tag} stepper_chunk {name} B={B} slots={slots}: "
                  f"{ms:.4f} ms/launch of {STEP_CHUNK} iterations from the "
                  f"mid-search carry (bound {bound_ms:.6f} ms by {bound_by}: "
                  f"{nbytes} B, {ops} ops; plain {plain_ms:.1f} ms)",
                  flush=True)
            del copies

    # compact_carry: 4096 -> 256 lanes, memo grown; and out of slots = 0
    big = default_slots(DEVICE_BATCH)
    comp = {}
    for old in (big, 0):
        c = carries[("queue48", old, "mid")]
        status = c.dsi[1].cpu().numpy()
        order = np.argsort(status != RUNNING, kind="stable")  # running first
        lanes = order[:COMPACT_TO]
        slots = default_slots(COMPACT_TO)
        got = compact_carry(c, lanes, COMPACT_TO, slots)
        want = compact_carry_plain(c, lanes, COMPACT_TO, slots)
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(
            f"compact_carry {old} -> {slots} slots", got, want))
        filled = int((got.occ == 1).sum())
        reps = 10
        ms = time_launches(lambda x: compact_carry(c, lanes, COMPACT_TO,
                                                   slots), [None] * (reps + 1),
                           reps)
        bound_ms, nbytes = compact_bound(c, got, len(lanes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compact_carry_plain(c, lanes, COMPACT_TO, slots)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        comp[old] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes")
        print(f"{tag} compact_carry == plain, {DEVICE_BATCH} -> "
              f"{COMPACT_TO} lanes, {old} -> {slots} slots ({filled} memo "
              f"entries after the re-hash): all 7 planes bit-identical; "
              f"{ms:.4f} ms/launch (bound {bound_ms:.6f} ms by bytes: "
              f"{nbytes} B; plain {plain_ms:.1f} ms)", flush=True)
    return max_err, rows, comp


def phase_queue_checker(spec, corpus, tag):
    """Phase 7: TorchStepper on the queue headline corpus."""
    t = TorchStepper(spec)
    device_corpus = _replicate(corpus, DEVICE_BATCH)
    t0 = time.perf_counter()
    cold = t.check_histories(spec, device_corpus)
    cold_s = time.perf_counter() - t0
    before = (t.rounds_run, t.compactions, t.lockstep_cost,
              stepper_chunk.launches, compact_carry.launches)
    t0 = time.perf_counter()
    v = t.check_histories(spec, device_corpus)
    warm_s = time.perf_counter() - t0
    rounds, compactions, cost, n_step, n_comp = (
        a - b for a, b in zip((t.rounds_run, t.compactions, t.lockstep_cost,
                               stepper_chunk.launches,
                               compact_carry.launches), before))
    require(v.tolist() == cold.tolist(), "verdicts differ between runs")
    prof_wall, busy_s, top = profile_device(
        lambda: t.check_histories(spec, device_corpus))
    t0 = time.perf_counter()
    ov = WingGongCPU(memo=True).check_histories(spec, corpus)
    oracle_s = time.perf_counter() - t0
    uv = v[:len(corpus)]
    both = (uv != Verdict.BUDGET_EXCEEDED) & (ov != Verdict.BUDGET_EXCEEDED)
    mismatches = int(((uv != ov) & both).sum())
    require(mismatches == 0, f"{mismatches} queue verdict mismatches vs "
            f"the oracle")
    lin = [h for h, x in zip(corpus, uv) if x == Verdict.LINEARIZABLE][:32]
    for h in lin:
        wv, wit = t.check_witness(spec, h)
        require(wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit),
                "a LINEARIZABLE queue witness failed to replay")
    undecided = int((v == Verdict.BUDGET_EXCEEDED).sum())
    print(f"{tag} queue checker: {len(device_corpus)} histories "
          f"({len(corpus)} unique, {Q_PIDS} pids x {Q_OPS} ops) warm "
          f"{warm_s:.3f} s = {len(device_corpus) / warm_s:.1f} histories/s "
          f"(cold {cold_s:.3f} s); rounds {rounds}, compactions "
          f"{compactions}, stepper_chunk launches {n_step}, compact_carry "
          f"launches {n_comp}, lockstep_cost {cost}, undecided {undecided}; "
          f"vs memo oracle ({oracle_s:.2f} s on the host): 0 mismatches "
          f"({int((uv == Verdict.LINEARIZABLE).sum())} linearizable, "
          f"{int((uv == Verdict.VIOLATION).sum())} violations, "
          f"{int(both.sum())} decided by both); {len(lin)} witnesses "
          f"replayed", flush=True)
    idle = f"{1 - busy_s / prof_wall:.3f}" if busy_s else "not measured"
    print(f"{tag} queue checker profiled: wall {prof_wall:.3f} s, device "
          f"busy {busy_s:.3f} s, idle share {idle}; top kernels {top}",
          flush=True)
    # the batch's set-up stages, timed alone on the same 4096 histories
    t0 = time.perf_counter()
    flatten(spec, device_corpus, None, t.max_expansions)
    t_flat = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = encode_batch(device_corpus, t.kspec.initial_state(), max_ops=Q_OPS)
    prec = enc.precedes()
    t_enc = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepper_tables(t.kspec, enc.ops[:, :, 1], enc.ops[:, :, 2],
                   enc.ops[:, :, 3], enc.valid, prec, t.device)
    torch.cuda.synchronize()
    t_tab = time.perf_counter() - t0
    print(f"{tag} queue batch set-up alone: host contracts (domain check, "
          f"pending expansion) {t_flat:.3f} s, encoding and precedence "
          f"{t_enc:.3f} s (host), step tables {t_tab:.3f} s (built on the "
          f"card, synchronised)", flush=True)


def phase_queue_property(spec, tag):
    """Phase 8: the property loop on the queue, racy convicted, atomic
    passed, then the CLI."""
    for impl, sut_cls, want_ok in (("racy", RacyTwoPhaseQueueSUT, False),
                                   ("atomic", AtomicQueueSUT, True)):
        t = TorchStepper(spec)
        cfg = PropertyConfig(n_trials=100, n_pids=Q_PIDS, max_ops=Q_OPS,
                             seed=0)
        t0 = time.perf_counter()
        res = prop_concurrent(spec, sut_cls(spec), cfg, backend=t)
        dt = time.perf_counter() - t0
        require(res.ok == want_ok and res.undecided == 0,
                f"{impl} queue: ok={res.ok} undecided={res.undecided}")
        what = ""
        if not want_ok:
            cx = res.counterexample
            require(cx is not None and cx.shrink_steps > 0
                    and len(cx.program) < Q_OPS,
                    "racy queue counterexample was not shrunk")
            what = (f", counterexample {len(cx.program)} ops after "
                    f"{cx.shrink_steps} shrink steps")
        print(f"{tag} property {impl} queue {Q_PIDS} pids x {Q_OPS} ops: "
              f"ok={res.ok} after {res.trials_run} trials, "
              f"{res.histories_checked} histories, {dt:.2f} s, "
              f"{t.rounds_run} chunk rounds{what}", flush=True)
    rc = cli.main(["run", "--model", "queue", "--impl", "racy",
                   "--backend", "stepper", "--trials", "100", "--pids",
                   str(Q_PIDS), "--ops", str(Q_OPS)])
    require(rc == 1, f"the CLI did not convict racy queue (rc {rc})")
    print(f"{tag} CLI (the entry point of python -m qsm_tpu_torch run "
          f"--model queue --backend stepper): racy queue rc 1", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an earlier dfs_chunk.cu to time in turns with "
                         "this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    tag = f"[{smi}]"
    dev = torch.device("cuda", 0)
    print(f"device: {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"{tag} build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc a source, in "
          f"parallel)")
    for name in libs:
        for line in kernels.ptxas_report(name).splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas {name}: "
                      f"{line.split(name + '_kernel')[-1].strip()}")
            elif any(k in line for k in ("registers", "stack frame")):
                print(f"  ptxas {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            require(m is None or m.groups() == ("0", "0"),
                    f"{name} spills: {line.strip()}")
    for B, S, cs in ((4096, 5, 64), (16384, 5, 64), (4096, 5, 0),
                     (4096, RANDOM_STATES, 64)):
        print(f"  plan: {plan_text(B, S, cs)}")

    spec = CasSpec()
    corpus = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=N_UNIQUE,
                          n_pids=N_PIDS, max_ops=N_OPS, seed_base=1000,
                          seed_prefix="bench")
    t0 = time.perf_counter()
    max_err, timings = phase_kernel(spec, corpus, dev, tag)
    print(f"{tag} phase kernel-vs-plain: {time.perf_counter() - t0:.1f} s")
    if args.against is not None:
        phase_against(args.against, timings, tag)

    # TorchGPU's main path: launch counts from here to the end of phase 5
    dfs_chunk.launches = 0
    t0 = time.perf_counter()
    phase_checker(spec, corpus, tag)
    phase_property(spec, tag)
    launches = dfs_chunk.launches
    print(f"{tag} main path of TorchGPU: {launches} dfs_chunk launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(launches > 0, "the main path launched no dfs_chunk kernel")

    q_spec, q_corpus = queue_corpus()
    t0 = time.perf_counter()
    step_err, step_rows, comp_rows = phase_stepper(q_spec, q_corpus, dev,
                                                   tag)
    print(f"{tag} phase stepper kernels vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # TorchStepper's main path: launch counts from here to the end of
    # phase 8
    stepper_chunk.launches = compact_carry.launches = 0
    t0 = time.perf_counter()
    phase_queue_checker(q_spec, q_corpus, tag)
    phase_queue_property(q_spec, tag)
    step_launches = stepper_chunk.launches
    comp_launches = compact_carry.launches
    print(f"{tag} main path of TorchStepper: {step_launches} stepper_chunk "
          f"launches, {comp_launches} compact_carry launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(step_launches > 0, "the main path launched no stepper_chunk")
    require(comp_launches > 0, "the main path launched no compact_carry")

    head = next(r for r in timings if r["tables"] == "cas"
                and r["B"] == 4096 and r["slots"] == 64)
    kernels_line = {"kernels": [{
        "name": "dfs_chunk", "route": "cuda",
        "source": "qsm_tpu_torch/csrc/dfs_chunk.cu",
        "replaces": "qsm_tpu/ops/pallas_kernel.py:265 (build_pallas_chunk)",
        "launches": launches, "matches_plain": max_err == 0,
        "max_abs_err": max_err, "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None}]}
    step = step_rows[default_slots(DEVICE_BATCH)]
    comp = comp_rows[default_slots(DEVICE_BATCH)]
    kernels_line["kernels"] += [{
        "name": "stepper_chunk", "route": "cuda",
        "source": "qsm_tpu_torch/csrc/stepper_chunk.cu",
        "replaces": "qsm_tpu/ops/jax_kernel.py:255 (build_stepper -> "
                    "run_one, table regime)",
        "launches": step_launches, "matches_plain": step_err == 0,
        "max_abs_err": step_err, **step, "library_ms": None}, {
        "name": "compact_carry", "route": "cuda",
        "source": "qsm_tpu_torch/csrc/compact_carry.cu",
        "replaces": "qsm_tpu/ops/jax_kernel.py:736 (JaxTPU._compact_fn)",
        "launches": comp_launches, "matches_plain": step_err == 0,
        "max_abs_err": step_err, **comp, "library_ms": None}]
    print(f"{tag} total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
