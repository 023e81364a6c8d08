#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``qsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OLD.cu   # also time an earlier kernel
    python3 chip_smoke.py --against-stepper OLD_DIR  # earlier stepper kernels

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
6. stepper kernels against plain (each case's launch plan printed
   first): ``stepper_chunk`` on the queue
   headline's tables (48 ops x 8 pids, 512 unique histories at 4096
   lanes, one batch-shared op-vocabulary table staged in shared memory),
   memo off and at the port's slot count for that bucket, from a fresh and
   from a mid-search carry, after 1 and 3 chunks of 2048 iterations; on
   CAS histories of 64 and 128 ops at 1024 lanes after 1 and 2 chunks; and
   on CAS histories over 256 values (32 ops, 1024 lanes), whose table is
   too large to stage and is read from device memory;
   ``compact_carry`` with the memo grown (4096 -> 256 lanes), kept,
   shrunk with collisions, from a carry without a memo and to one without;
   every plane bit-identical to the plain version (tolerance 0).  Then
   each kernel is timed with CUDA events and its plain version once.  With
   ``--against-stepper DIR`` (a directory holding earlier
   ``stepper_chunk.cu`` and ``compact_carry.cu`` whose C entries take the
   per-history ``[R, S, N]`` tables: 12 pointers, 8 ints and the stream;
   15 pointers, 7 ints and the stream), those kernels are built too and
   timed in turns with these (old, new, new, old) on the same inputs, the
   old stepper fed the per-history tables expanded from the vocabulary,
   after both are checked equal; each compaction is also timed by its C
   entry alone, outputs made beforehand, without the wrappers' host work;
7. queue checker (main path of ``TorchStepper``): ``check_histories`` on
   the 512 unique queue histories replicated to 4096 lanes, at the
   default budget; 0 verdict mismatches against the memo oracle,
   witnesses replayed, one warm run profiled (histories/s, device busy
   time and idle share, rounds, compactions, launches of each kernel);
8. queue property (main path of ``TorchStepper``): ``prop_concurrent`` at
   8 pids x 48 ops, 100 trials — racy queue convicted with a shrunk
   counterexample, atomic queue passed — and the racy run again through
   ``python -m qsm_tpu_torch run --model queue --backend stepper``;
9. sweep kernel against plain: ``stepper_sweep`` on a KV map of 16 keys
   (64 ops x 16 pids, 512 unique histories at 4096 lanes) memo off and at
   the port's slot count, and on queue and stack of capacity 8, txn(8, 8)
   and a random vector spec of 9 elements at 1024 lanes, each from a
   mid-search carry, after 1 and 2 chunks of 1024 iterations (KV) or 1
   (the others): every plane bit-identical to ``stepper_sweep_plain``;
   each case's plan, time per launch, plain time and bound;
   ``compact_carry`` on the KV carry;
10. kv16 checker (main path of the sweep regime): ``TorchStepper`` on the
   512 unique KV histories at 4096 lanes, cold, warm and profiled; 0
   verdict mismatches against the port's memo oracle run on each key's
   register sub-history (``KvKeyOracle``), witnesses replayed;
11. kv16 property: ``prop_concurrent`` at 16 pids x 64 ops, racy
   convicted, atomic passed;
12. milestones: KV at its default size (16 pids x 64 ops, a 256-state
   shadow) through ``TorchStepper``'s table regime, and the ticket
   dispenser (4 pids x 24 ops) through ``TorchGPU`` and ``TorchStepper``:
   each checker against its oracle and ``prop_concurrent`` racy and
   atomic.

Each main path's launch counts are reset just before it and read just
after (``dfs_chunk`` over phases 4-5, ``stepper_chunk`` and
``compact_carry`` over phases 7-8, ``stepper_sweep`` and
``compact_carry`` over phases 10-11, each milestone's kernels over its
own path).  The second-to-last stdout line is the
kernels record, the last the device record.  Every number is printed
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import random
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qsm_tpu_torch.core.history import History, Op, encode_batch
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.counter import (AtomicTicketSUT, RacyTicketSUT,
                                          TicketSpec)
from qsm_tpu_torch.models.kv import GET as KV_GET
from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                        RacyTwoPhaseQueueSUT)
from qsm_tpu_torch.models.register import RegisterSpec
from qsm_tpu_torch.models.stack import (AtomicStackSUT, RacyTwoPhaseStackSUT,
                                        StackSpec)
from qsm_tpu_torch.models.txn import (AtomicTxnSUT, TornCopyTxnSUT,
                                      TxnRegisterSpec)
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
                                              device_sms,
                                              fresh_stepper_carry, key_words,
                                              n_words, pack_words,
                                              stepper_blocks_per_sm,
                                              stepper_chunk,
                                              stepper_chunk_plain,
                                              stepper_launch_plan,
                                              stepper_tables, table_bytes)
from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry, stepper_sweep,
                                            stepper_sweep_plain,
                                            sweep_launch_plan, sweep_model,
                                            sweep_tables)
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils import cli
from qsm_tpu_torch.utils.corpus import build_corpus, random_lane_tables
from qsm_tpu_torch.utils.fuzz import RandomVectorSpec, random_history

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
WIDE_CAS_VALUES = 256          # phase 6's table too large to stage
KV_KEYS, KV_PIDS, KV_OPS = 16, 16, 64   # the sweep regime's KV headline
SWEEP_CHUNK = 1024             # stepper_sweep iterations a launch, phase 9
SWEEP_MID = 256                # plain iterations before phase 9's carries
TICKET_PIDS, TICKET_OPS = 4, 24          # the ticket milestone


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
    n = tabs.prec.shape[2]
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
    4096 lanes; CAS histories of 64 and 128 ops at 1024; CAS histories of
    32 ops over 256 values at 1024, whose table is too large to stage."""
    B = DEVICE_BATCH
    tabs, starts = stepper_inputs(q_spec, _replicate(q_corpus, B), Q_OPS,
                                  dev)
    yield "queue48", B, tabs, starts
    for name, cas, n_ops in (
            ("cas64", CasSpec(), 64), ("cas128", CasSpec(), 128),
            (f"cas32v{WIDE_CAS_VALUES}", CasSpec(n_values=WIDE_CAS_VALUES),
             32)):
        hs = build_corpus(cas, (AtomicCasSUT, RacyCasSUT), n=256,
                          n_pids=N_PIDS, max_ops=n_ops, seed_base=1000,
                          seed_prefix="bench")
        tabs, starts = stepper_inputs(cas, _replicate(hs, 1024), n_ops, dev)
        yield name, 1024, tabs, starts


def stepper_plan_text(name, B, tabs) -> str:
    N = tabs.vocab.shape[1]
    S, V = tabs.vnxt.shape
    p = stepper_launch_plan(B, N, S, V, device_sms(tabs.vocab.device))
    return (f"{name} B={B} N={N} S={S} V={V}: {p.warps_per_block} warps "
            f"a block, grid {p.grid}, {p.smem_bytes} shared bytes a block, "
            f"{stepper_blocks_per_sm(p)} blocks/SM; step table "
            f"({table_bytes(S, V)} B) in "
            f"{'shared' if p.stage_tables else 'device'} memory")


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


def new_stepper(tabs, c):
    return stepper_chunk(tabs, c, chunk=STEP_CHUNK, budget=TOTAL_BUDGET)


def time_stepper(tabs, mid, launch=new_stepper, reps=5) -> float:
    """ms per launch of a chunk from the mid-search carry, each launch on
    its own copy (the kernel updates the carry in place)."""
    copies = [clone_carry(mid) for _ in range(reps + 1)]
    return time_launches(lambda c: launch(tabs, c), copies, reps)


def phase_stepper(q_spec, q_corpus, dev, tag):
    """Phase 6: stepper_chunk and compact_carry against their plain
    versions, then timings and bounds.  Returns the largest error, the
    timing rows, and what ``--against-stepper`` times again."""
    max_err, rows, carries = 0, {}, {}
    for name, B, tabs, starts in stepper_cases(q_spec, q_corpus, dev):
        N = tabs.vocab.shape[1]
        print(f"  plan: {stepper_plan_text(name, B, tabs)}", flush=True)
        staged = stepper_launch_plan(B, N, *tabs.vnxt.shape,
                                     device_sms(dev)).stage_tables
        require(staged == (name != f"cas32v{WIDE_CAS_VALUES}"),
                f"{name}: the step table is staged where it should not be, "
                f"or the other way round")
        if name == "queue48":
            q_tabs = tabs
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
            # shapes run 2 chunks, the queue headline 3 (not 8, so that
            # the script's time limit also holds phases 9-12)
            n_chunks = 3 if name == "queue48" else 2
            for start, c0 in begins.items():
                ck, cp = clone_carry(c0), clone_carry(c0)
                running = int((c0.dsi[1] == RUNNING).sum())
                for i in range(n_chunks):
                    new_stepper(tabs, ck)
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
            mid = begins["mid"]
            ms = time_stepper(tabs, mid)
            one = new_stepper(tabs, clone_carry(mid))
            bound_ms, bound_by, nbytes, ops = stepper_bound(tabs, mid, one)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stepper_chunk_plain(tabs, clone_carry(mid), chunk=STEP_CHUNK,
                                budget=TOTAL_BUDGET)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            rows[slots] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, mid=mid)
            print(f"{tag} stepper_chunk {name} B={B} slots={slots}: "
                  f"{ms:.4f} ms/launch of {STEP_CHUNK} iterations from the "
                  f"mid-search carry (bound {bound_ms:.6f} ms by {bound_by}: "
                  f"{nbytes} B, {ops} ops; plain {plain_ms:.1f} ms)",
                  flush=True)

    # compact_carry out of the queue headline's carries after 3 chunks,
    # running lanes first: (label, old slots, new bucket, new slots)
    big = default_slots(DEVICE_BATCH)
    comp = {}
    for label, old, to, slots in (
            ("grown", big, COMPACT_TO, default_slots(COMPACT_TO)),
            ("kept", big, DEVICE_BATCH // 4, big),
            ("shrunk", big, COMPACT_TO, big // 32),
            ("from no memo", 0, COMPACT_TO, default_slots(COMPACT_TO)),
            ("to no memo", big, COMPACT_TO, 0)):
        c = carries[("queue48", old, "mid")]
        status = c.dsi[1].cpu().numpy()
        order = np.argsort(status != RUNNING, kind="stable")  # running first
        lanes = order[:to]
        got = compact_carry(c, lanes, to, slots)
        want = compact_carry_plain(c, lanes, to, slots)
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(
            f"compact_carry {label}: {old} -> {slots} slots", got, want))
        filled = int((got.occ == 1).sum())
        if label == "shrunk":
            had = int((c.occ[torch.from_numpy(lanes).to(dev)] == 1).sum())
            require(0 < filled < had, f"the shrunk memo kept {filled} of "
                    f"{had} entries: no collision was exercised")
        reps = 10
        ms = time_launches(lambda x: compact_carry(c, lanes, to, slots),
                           [None] * (reps + 1), reps)
        bound_ms, nbytes = compact_bound(c, got, len(lanes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compact_carry_plain(c, lanes, to, slots)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        comp[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by="bytes", args=(c, lanes, to, slots))
        print(f"{tag} compact_carry == plain, memo {label}: "
              f"{c.row.shape[0]} -> {to} lanes, {old} -> {slots} slots "
              f"({filled} memo entries after): all 7 planes bit-identical; "
              f"{ms:.4f} ms/launch (bound {bound_ms:.6f} ms by bytes: "
              f"{nbytes} B; plain {plain_ms:.1f} ms)", flush=True)
    return max_err, rows, comp, q_tabs


def per_history_tables(tabs):
    """The per-history ``[R, S, N]`` next states and ``[R, S, W]`` packed
    ok words that the earlier stepper kernel reads, expanded from the
    vocabulary (op j of row r is entry ``vocab[r, j]``)."""
    voc = tabs.vocab.long()
    nxt = tabs.vnxt[:, voc].permute(1, 0, 2).contiguous()
    bits = (tabs.vok[:, voc >> 5].to(torch.int64) >> (voc & 31)) & 1
    words = pack_words(bits.permute(1, 0, 2) == 1)            # [R, S, W]
    okw = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return nxt, okw.to(torch.int32).contiguous()


def old_stepper_kernels(src_dir: Path):
    """Launchers for the earlier ``stepper_chunk.cu`` and
    ``compact_carry.cu`` in ``src_dir``, built like these."""
    P, I = ctypes.c_void_p, ctypes.c_int
    step = ctypes.CDLL(str(kernels.build(
        "stepper_chunk_against", src=src_dir / "stepper_chunk.cu"))
                       ).stepper_chunk_launch
    step.argtypes = [P] * 12 + [I] * 8 + [P]
    comp = ctypes.CDLL(str(kernels.build(
        "compact_carry_against", src=src_dir / "compact_carry.cu"))
                       ).compact_carry_launch
    comp.argtypes = [P] * 15 + [I] * 7 + [P]

    def old_step(rtabs, c):
        R, S, N = rtabs[0].shape
        rc = step(*(t.data_ptr() for t in rtabs), c.row.data_ptr(),
                  *(t.data_ptr() for t in c[:6]), c.row.shape[0], R, N, S,
                  n_words(N), c.occ.shape[1], STEP_CHUNK, TOTAL_BUDGET,
                  torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"the earlier stepper_chunk failed ({rc})")
        return c

    def old_compact_raw(c, idx, out):
        rc = comp(*(t.data_ptr() for t in c), idx.data_ptr(),
                  *(t.data_ptr() for t in out), c.row.shape[0],
                  out.row.shape[0], idx.shape[0], c.taken.shape[0],
                  key_words(c.taken.shape[0]), c.occ.shape[1],
                  out.occ.shape[1], torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"the earlier compact_carry failed ({rc})")
        return out

    def old_compact(c, lanes, to, slots):
        idx = torch.from_numpy(np.asarray(lanes, np.int32)).to(c.row.device)
        return old_compact_raw(c, idx, compact_outputs(c, to, slots))
    return old_step, old_compact, old_compact_raw


def compact_outputs(c: StepperCarry, to: int, slots: int) -> StepperCarry:
    N, dev = c.taken.shape[0], c.row.device
    return StepperCarry(*(torch.empty(s, dtype=torch.int32, device=dev)
                          for s in ((N, to), (N + 1, to), (N + 1, to),
                                    (5, to), (to, slots, key_words(N)),
                                    (to, slots), (to,))))


def new_compact_raw(c, idx, out, win):
    """This ``compact_carry``'s C entry alone: the lanes on the card, the
    outputs and the re-hash scratch made beforehand, no host checks."""
    rc = kernels.compact_carry_lib().compact_carry_launch(
        *(t.data_ptr() for t in c), idx.data_ptr(),
        *(t.data_ptr() for t in out), win.data_ptr(), c.row.shape[0],
        out.row.shape[0], idx.shape[0], c.taken.shape[0], 0,
        key_words(c.taken.shape[0]), c.occ.shape[1], out.occ.shape[1],
        device_sms(c.row.device), torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"compact_carry's C entry failed ({rc})")
    return out


def phase_against_stepper(src_dir: Path, q_tabs, rows, comp, tag):
    """The earlier stepper kernels and these in turns (old, new, new, old)
    on phase 6's queue inputs, after checking them equal."""
    old_step, old_compact, old_compact_raw = old_stepper_kernels(src_dir)
    for name in ("stepper_chunk_against", "compact_carry_against"):
        src = src_dir / f"{name.split('_against')[0]}.cu"
        for line in kernels.ptxas_report(name, src).splitlines():
            if any(k in line for k in ("registers", "stack frame")):
                print(f"  ptxas (earlier {name}): {line.strip()}")
    rtabs = (*per_history_tables(q_tabs), q_tabs.prec, q_tabs.valid,
             q_tabs.nreq)
    print(f"{tag} earlier stepper_chunk fed per-history tables of "
          f"{sum(t.numel() * 4 for t in rtabs[:2])} B, expanded from a "
          f"{q_tabs.vnxt.numel() * 4 + q_tabs.vok.numel() * 4} B "
          f"vocabulary table", flush=True)
    for slots, row in rows.items():
        mid = row["mid"]
        a = old_step(rtabs, clone_carry(mid))
        b = new_stepper(q_tabs, clone_carry(mid))
        torch.cuda.synchronize()
        _compare(f"earlier stepper_chunk vs this, slots={slots}", a, b)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_stepper(
                rtabs if who == "old" else q_tabs, mid,
                launch=old_step if who == "old" else new_stepper))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        print(f"{tag} earlier vs this stepper_chunk, queue48 B={DEVICE_BATCH}"
              f" slots={slots} (old, new, new, old): old "
              f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)
    del rtabs
    for label, row in comp.items():
        c, lanes, to, slots = row["args"]
        a = old_compact(c, lanes, to, slots)
        b = compact_carry(c, lanes, to, slots)
        torch.cuda.synchronize()
        _compare(f"earlier compact_carry vs this, memo {label}", a, b)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = old_compact if who == "old" else compact_carry
            turns[who].append(time_launches(
                lambda x: fn(c, lanes, to, slots), [None] * 11, 10))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        print(f"{tag} earlier vs this compact_carry, memo {label} "
              f"({c.row.shape[0]} -> {to} lanes, {c.occ.shape[1]} -> "
              f"{slots} slots) (old, new, new, old): old "
              f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)
        # the C entries alone: the wrappers' host work (argument checks,
        # the lanes' copy to the card, allocations) left out
        idx = torch.from_numpy(np.asarray(lanes, np.int32)).to(c.row.device)
        out = compact_outputs(c, to, slots)
        win = torch.empty(max(len(lanes) * slots, 1), dtype=torch.int32,
                          device=c.row.device)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_launches(
                (lambda x: old_compact_raw(c, idx, out)) if who == "old"
                else (lambda x: new_compact_raw(c, idx, out, win)),
                [None] * 11, 10))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        print(f"{tag} earlier vs this compact_carry's C entry alone, memo "
              f"{label} (old, new, new, old): old "
              f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)


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


# ---------------------------------------------------------------------------
# The sweep regime (stepper_sweep) and the registry's milestones
# ---------------------------------------------------------------------------

class KvKeyOracle:
    """The port's memo oracle on each key's register sub-history of a KV
    history: exact, since the keys of a KV map are independent (a history
    is linearizable iff every key's sub-history is), and fast where the
    whole-history search over a 16-word state is not.  GET(k) projects to
    READ, PUT(k, v) to WRITE(v)."""

    def __init__(self, spec):
        self.reg = RegisterSpec(n_values=spec.n_values)
        self.memo = WingGongCPU(memo=True)
        self.n_values = spec.n_values

    def check_histories(self, spec, histories):
        out = np.empty(len(histories), np.int8)
        for i, h in enumerate(histories):
            keys = {}
            for o in h.ops:
                key, val = ((o.arg, 0) if o.cmd == KV_GET
                            else divmod(o.arg, self.n_values))
                keys.setdefault(key, []).append(Op(
                    o.pid, o.cmd, val, o.resp, o.invoke_time,
                    o.response_time))
            sub = self.memo.check_histories(
                self.reg, [History(ops) for ops in keys.values()])
            out[i] = (Verdict.VIOLATION if (sub == Verdict.VIOLATION).any()
                      else Verdict.BUDGET_EXCEEDED
                      if (sub == Verdict.BUDGET_EXCEEDED).any()
                      else Verdict.LINEARIZABLE)
        return out


def sweep_ops_per_iteration(n_ops: int, dim: int, memo: bool) -> int:
    """Integer ops of one sweep iteration, counted from
    ``csrc/stepper_sweep.cu``: the blocked-op sweep 2W + 2 an op and the
    postcondition about 8 (the kind's branch, a clamped index, a load, a
    compare), the candidate words and the lowest one 3W + 4, the child 3
    a state word, the stack update, status and budget about 26; with the
    memo the two hashes and the key compare 6 kw + 5 more."""
    w = n_words(n_ops)
    ops = n_ops * (2 * w + 10) + 3 * w + 30 + 3 * dim
    return ops + (6 * (w + dim) + 5 if memo else 0)


def sweep_bound(tabs, c_in: StepperCarry, c_out: StepperCarry):
    """(bound_ms, bound_by, bytes, ops) of one ``stepper_sweep`` launch:
    every lane's stacks and counters read and written once, the ops and
    predecessor words of the lanes that ran read once, against the
    iterations this run's data needed."""
    ran = (c_out.dsi[2] - c_in.dsi[2]) > 0
    iters = int((c_out.dsi[2].long() - c_in.dsi[2].long()).sum())
    n = tabs.cmd.shape[1]
    w = tabs.prec.shape[1]
    stacks = _tensor_bytes((c_in.taken, c_in.chosen, c_in.states, c_in.dsi,
                            c_in.row))
    nbytes = 2 * stacks + int(ran.sum()) * 4 * (3 * n + w * n + w + 1)
    ops = iters * sweep_ops_per_iteration(n, c_in.states.shape[2],
                                          c_in.occ.shape[1] > 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def kv16_corpus():
    spec = KvSpec(n_keys=KV_KEYS, n_values=4)
    return spec, build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT),
                              n=N_UNIQUE, n_pids=KV_PIDS, max_ops=KV_OPS,
                              seed_base=1000, seed_prefix="bench")


def sweep_inputs(spec, histories, n_ops, dev):
    enc = encode_batch(histories, spec.initial_state(), max_ops=n_ops)
    tabs = sweep_tables(enc.ops[:, :, 1], enc.ops[:, :, 2],
                        enc.ops[:, :, 3], enc.valid, enc.precedes(), dev)
    return tabs, np.tile(np.asarray(enc.init_state, np.int32),
                         (len(histories), 1))


def sweep_cases(kv_spec, kv_corpus, dev):
    """(name, spec, B, N, tables, start states) of the sweep phase: KV of
    16 keys at 4096 lanes of 64 ops; queue and stack of capacity 8, txn(8,
    8) and a random vector spec of 9 elements at 1024 lanes."""
    tabs, starts = sweep_inputs(kv_spec, _replicate(kv_corpus, DEVICE_BATCH),
                                KV_OPS, dev)
    yield "kv16", kv_spec, DEVICE_BATCH, KV_OPS, tabs, starts
    for name, spec, suts, n_ops in (
            ("queue8", QueueSpec(capacity=8),
             (AtomicQueueSUT, RacyTwoPhaseQueueSUT), 48),
            ("stack8", StackSpec(capacity=8),
             (AtomicStackSUT, RacyTwoPhaseStackSUT), 48),
            ("txn8", TxnRegisterSpec(8, 8), (AtomicTxnSUT, TornCopyTxnSUT),
             32),
            ("random9", RandomVectorSpec(5, bounds=(4,) * 9), None, 48)):
        if suts is None:
            rng = random.Random("chip-smoke")
            hs = [random_history(spec, rng, 6, 40) for _ in range(256)]
        else:
            hs = build_corpus(spec, suts, n=256, n_pids=N_PIDS,
                              max_ops=n_ops, seed_base=1000,
                              seed_prefix="bench")
        tabs, starts = sweep_inputs(spec, _replicate(hs, 1024), n_ops, dev)
        yield name, spec, 1024, n_ops, tabs, starts


def new_sweep(model, tabs, c):
    return stepper_sweep(model, tabs, c, chunk=SWEEP_CHUNK,
                         budget=TOTAL_BUDGET)


def phase_sweep(kv_spec, kv_corpus, dev, tag):
    """Phase 9: stepper_sweep against stepper_sweep_plain on every case,
    then timings and bounds; compact_carry on the KV carry.  Returns the
    largest error of each kernel and the headline row."""
    max_err, comp_err, head = 0, 0, None
    for name, spec, B, N, tabs, starts in sweep_cases(kv_spec, kv_corpus,
                                                      dev):
        D = spec.STATE_DIM
        model = sweep_model(spec, dev)
        p = sweep_launch_plan(B, N, D, device_sms(dev))
        print(f"  plan: {name} B={B} N={N} D={D} kind {model.kind}: "
              f"{p.warps_per_block} warps a block, grid {p.grid}, "
              f"{p.smem_bytes} shared bytes a block", flush=True)
        for slots in ((0, default_slots(B, D)) if name == "kv16"
                      else (default_slots(B, D),)):
            fresh = fresh_sweep_carry(tabs.nreq, np.arange(B), starts, B, N,
                                      slots)
            # mid-search: SWEEP_MID plain iterations in
            mid = stepper_sweep_plain(spec, tabs, clone_carry(fresh),
                                      chunk=SWEEP_MID, budget=TOTAL_BUDGET)
            running = int((mid.dsi[1] == RUNNING).sum())
            require(running > 0, f"{name}: no lane running mid-search")
            # the plain version's loop is the phase's cost: the KV
            # headline runs 2 chunks, the other models 1; the first plain
            # chunk is the plain version's time
            n_chunks = 2 if name == "kv16" else 1
            ck, cp = clone_carry(mid), clone_carry(mid)
            for i in range(n_chunks):
                new_sweep(model, tabs, ck)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stepper_sweep_plain(spec, tabs, cp, chunk=SWEEP_CHUNK,
                                    budget=TOTAL_BUDGET)
                torch.cuda.synchronize()
                if i == 0:
                    plain_ms = (time.perf_counter() - t0) * 1e3
                max_err = max(max_err, _compare(
                    f"stepper_sweep {name} B={B} slots={slots} chunk "
                    f"{i + 1}", ck, cp))
            ms = time_launches(lambda c: new_sweep(model, tabs, c),
                               [clone_carry(mid) for _ in range(6)], 5)
            one = new_sweep(model, tabs, clone_carry(mid))
            bound_ms, bound_by, nbytes, ops = sweep_bound(tabs, mid, one)
            print(f"{tag} stepper_sweep == plain on {name} B={B} N={N} D={D}"
                  f" slots={slots} from a mid-search carry ({running} lanes "
                  f"running): all 7 planes bit-identical after "
                  f"{' and '.join(str(k + 1) for k in range(n_chunks))} "
                  f"chunk(s) of {SWEEP_CHUNK}; {ms:.4f} ms/launch (bound "
                  f"{bound_ms:.6f} ms by {bound_by}: {nbytes} B, {ops} ops; "
                  f"plain {plain_ms:.1f} ms); "
                  f"{int((ck.dsi[1] == RUNNING).sum())} still running",
                  flush=True)
            if name == "kv16" and slots:
                head = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
                kv_carry = ck
    # compact_carry on the KV carry: 4096 -> 256 lanes, the memo grown
    status = kv_carry.dsi[1].cpu().numpy()
    lanes = np.argsort(status != RUNNING, kind="stable")[:COMPACT_TO]
    slots = default_slots(COMPACT_TO, KV_KEYS)
    got = compact_carry(kv_carry, lanes, COMPACT_TO, slots)
    want = compact_carry_plain(kv_carry, lanes, COMPACT_TO, slots)
    torch.cuda.synchronize()
    comp_err = _compare("compact_carry of the kv16 sweep carry", got, want)
    ms = time_launches(lambda x: compact_carry(kv_carry, lanes, COMPACT_TO,
                                               slots), [None] * 11, 10)
    print(f"{tag} compact_carry == plain on the kv16 sweep carry: "
          f"{DEVICE_BATCH} -> {COMPACT_TO} lanes, "
          f"{kv_carry.occ.shape[1]} -> {slots} slots "
          f"({int((got.occ == 1).sum())} memo entries after): all 7 planes "
          f"bit-identical; {ms:.4f} ms/launch", flush=True)
    return max_err, comp_err, head


def check_corpus(name, backend, spec, corpus, oracle, tag):
    """``backend.check_histories`` on ``corpus`` replicated to 4096 lanes,
    cold and warm, then profiled; 0 verdict mismatches against ``oracle``
    wherever both decided; LINEARIZABLE witnesses replayed.  Returns the
    warm verdicts."""
    device_corpus = _replicate(corpus, DEVICE_BATCH)
    t0 = time.perf_counter()
    cold = backend.check_histories(spec, device_corpus)
    cold_s = time.perf_counter() - t0
    counters = [k for k in ("rounds_run", "compactions", "chunk_launches")
                if hasattr(backend, k)]
    before = {k: getattr(backend, k) for k in counters}
    t0 = time.perf_counter()
    v = backend.check_histories(spec, device_corpus)
    warm_s = time.perf_counter() - t0
    after = ", ".join(f"{k} {getattr(backend, k) - before[k]}"
                      for k in counters)
    require(v.tolist() == cold.tolist(), f"{name}: verdicts differ between "
            f"runs")
    prof_wall, busy_s, top = profile_device(
        lambda: backend.check_histories(spec, device_corpus))
    t0 = time.perf_counter()
    ov = oracle.check_histories(spec, corpus)
    oracle_s = time.perf_counter() - t0
    uv = v[:len(corpus)]
    both = (uv != Verdict.BUDGET_EXCEEDED) & (ov != Verdict.BUDGET_EXCEEDED)
    mismatches = int(((uv != ov) & both).sum())
    require(mismatches == 0, f"{name}: {mismatches} verdict mismatches vs "
            f"the oracle")
    lin = [h for h, x in zip(corpus, uv) if x == Verdict.LINEARIZABLE][:32]
    for h in lin:
        wv, wit = backend.check_witness(spec, h)
        require(wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit),
                f"{name}: a LINEARIZABLE witness failed to replay")
    idle = f"{1 - busy_s / prof_wall:.3f}" if busy_s else "not measured"
    print(f"{tag} {name} checker: {len(device_corpus)} histories "
          f"({len(corpus)} unique) warm {warm_s:.3f} s = "
          f"{len(device_corpus) / warm_s:.1f} histories/s (cold "
          f"{cold_s:.3f} s); {after}; undecided "
          f"{int((v == Verdict.BUDGET_EXCEEDED).sum())}; vs oracle "
          f"({oracle_s:.2f} s on the host): 0 mismatches "
          f"({int((uv == Verdict.LINEARIZABLE).sum())} linearizable, "
          f"{int((uv == Verdict.VIOLATION).sum())} violations, "
          f"{int(both.sum())} decided by both; the oracle: "
          f"{int((ov == Verdict.VIOLATION).sum())} violations); {len(lin)} "
          f"witnesses replayed; profiled: wall {prof_wall:.3f} s, device "
          f"busy {busy_s:.3f} s, idle share {idle}; top kernels {top}",
          flush=True)
    return v


def check_property(name, make_backend, spec, suts, cfg, tag, oracle=None):
    """``prop_concurrent``: the racy SUT convicted, the atomic one
    passed, nothing undecided on the atomic run."""
    for impl, sut, want_ok in (("racy", suts[1], False),
                               ("atomic", suts[0], True)):
        backend = make_backend()
        t0 = time.perf_counter()
        res = prop_concurrent(spec, sut, PropertyConfig(**cfg),
                              backend=backend, oracle=oracle)
        dt = time.perf_counter() - t0
        require(res.ok == want_ok, f"{name} {impl}: ok={res.ok}")
        require(not want_ok or res.undecided == 0,
                f"{name} {impl}: {res.undecided} undecided")
        what = ""
        if not want_ok:
            cx = res.counterexample
            what = (f", counterexample {len(cx.program)} ops after "
                    f"{cx.shrink_steps} shrink steps")
        print(f"{tag} property {impl} {name} {cfg['n_pids']} pids x "
              f"{cfg['max_ops']} ops ({type(backend).__name__}): "
              f"ok={res.ok} after {res.trials_run} trials, "
              f"{res.histories_checked} histories, undecided "
              f"{res.undecided}, {dt:.2f} s{what}", flush=True)


def phase_kv16(spec, corpus, tag):
    """Phases 10-11 (main path of the sweep regime): TorchStepper on the
    kv16 corpus, then prop_concurrent on kv16."""
    t = TorchStepper(spec)
    require(t.regime == "sweep", f"kv16 took the {t.regime} regime")
    oracle = KvKeyOracle(spec)
    check_corpus("kv16", t, spec, corpus, oracle, tag)
    # the batch's set-up stages, timed alone on the same 4096 histories
    device_corpus = _replicate(corpus, DEVICE_BATCH)
    t0 = time.perf_counter()
    flatten(spec, device_corpus, None, t.max_expansions, uses_table=False)
    t_flat = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = encode_batch(device_corpus, spec.initial_state(), max_ops=KV_OPS)
    prec = enc.precedes()
    t_enc = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep_tables(enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
                 enc.valid, prec, t.device)
    torch.cuda.synchronize()
    t_tab = time.perf_counter() - t0
    print(f"{tag} kv16 batch set-up alone: host contracts {t_flat:.3f} s, "
          f"encoding and precedence {t_enc:.3f} s (host), sweep tables "
          f"{t_tab:.3f} s (to the card, synchronised)", flush=True)
    check_property("kv16", lambda: TorchStepper(spec), spec,
                   (AtomicKvSUT(spec), StaleCacheKvSUT(spec)),
                   dict(n_trials=30, n_pids=KV_PIDS, max_ops=KV_OPS, seed=0),
                   tag, oracle=oracle)


def phase_milestones(tag):
    """Phase 12: the two milestone configurations the port could not
    check before: KV at its default size (4 keys, a 256-state shadow)
    through TorchStepper's table regime; the ticket dispenser through
    TorchGPU and TorchStepper.  Each kernel's launches are counted over
    its path alone."""
    spec = KvSpec()
    corpus = build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT), n=N_UNIQUE,
                          n_pids=KV_PIDS, max_ops=KV_OPS, seed_base=1000,
                          seed_prefix="bench")
    oracle = KvKeyOracle(spec)
    stepper_chunk.launches = compact_carry.launches = 0
    t = TorchStepper(spec)
    require(t.regime == "table" and t.kspec.n_packed == 256,
            "KV at its default size is not on the table regime's shadow")
    check_corpus("kv (4 keys)", t, spec, corpus, oracle, tag)
    check_property("kv (4 keys)", lambda: TorchStepper(spec), spec,
                   (AtomicKvSUT(spec), StaleCacheKvSUT(spec)),
                   dict(n_trials=40, n_pids=KV_PIDS, max_ops=KV_OPS,
                        seed=13), tag, oracle=oracle)
    print(f"{tag} path of the KV milestone: {stepper_chunk.launches} "
          f"stepper_chunk, {compact_carry.launches} compact_carry launches",
          flush=True)
    require(stepper_chunk.launches > 0, "the KV milestone launched no "
            "stepper_chunk")
    tspec = TicketSpec()
    corpus = build_corpus(tspec, (lambda s: AtomicTicketSUT(),
                                  lambda s: RacyTicketSUT()), n=N_UNIQUE,
                          n_pids=TICKET_PIDS, max_ops=TICKET_OPS,
                          seed_base=1000, seed_prefix="bench")
    suts = (AtomicTicketSUT(), RacyTicketSUT())
    cfg = dict(n_trials=60, n_pids=TICKET_PIDS, max_ops=TICKET_OPS, seed=99)
    for label, make, counter in (("TorchGPU", TorchGPU, dfs_chunk),
                                 ("TorchStepper", TorchStepper,
                                  stepper_chunk)):
        counter.launches = 0
        check_corpus(f"ticket via {label}", make(tspec), tspec, corpus,
                     WingGongCPU(memo=True), tag)
        check_property(f"ticket via {label}", lambda: make(tspec), tspec,
                       suts, cfg, tag)
        print(f"{tag} path of the ticket milestone through {label}: "
              f"{counter.launches} {counter.__name__} launches", flush=True)
        require(counter.launches > 0, f"the ticket milestone launched no "
                f"{counter.__name__} through {label}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an earlier dfs_chunk.cu to time in turns with "
                         "this one")
    ap.add_argument("--against-stepper", type=Path, default=None,
                    help="a directory with an earlier stepper_chunk.cu and "
                         "compact_carry.cu to time in turns with these")
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
    step_err, step_rows, comp_rows, q_tabs = phase_stepper(
        q_spec, q_corpus, dev, tag)
    print(f"{tag} phase stepper kernels vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.against_stepper is not None:
        phase_against_stepper(args.against_stepper, q_tabs, step_rows,
                              comp_rows, tag)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    step = {k: step_rows[default_slots(DEVICE_BATCH)][k] for k in keys}
    comp = {k: comp_rows["grown"][k] for k in keys}
    del step_rows, comp_rows, q_tabs  # their carries: free the memory

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

    kv_spec, kv_corpus = kv16_corpus()
    t0 = time.perf_counter()
    sweep_err, sweep_comp_err, sweep = phase_sweep(kv_spec, kv_corpus, dev,
                                                   tag)
    print(f"{tag} phase stepper_sweep vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the sweep regime's main path: launch counts over phases 10-11
    stepper_sweep.launches = compact_carry.launches = 0
    t0 = time.perf_counter()
    phase_kv16(kv_spec, kv_corpus, tag)
    sweep_launches = stepper_sweep.launches
    print(f"{tag} main path of TorchStepper's sweep regime: "
          f"{sweep_launches} stepper_sweep launches, "
          f"{compact_carry.launches} compact_carry launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(sweep_launches > 0, "the sweep regime's main path launched no "
            "stepper_sweep")
    t0 = time.perf_counter()
    phase_milestones(tag)
    print(f"{tag} phase milestones: {time.perf_counter() - t0:.1f} s",
          flush=True)

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
        "launches": comp_launches,
        "matches_plain": max(step_err, sweep_comp_err) == 0,
        "max_abs_err": max(step_err, sweep_comp_err), **comp,
        "library_ms": None}, {
        "name": "stepper_sweep", "route": "cuda",
        "source": "qsm_tpu_torch/csrc/stepper_sweep.cu",
        "replaces": "qsm_tpu/ops/jax_kernel.py:303 (build_stepper -> "
                    "run_one, sweep regime)",
        "launches": sweep_launches, "matches_plain": sweep_err == 0,
        "max_abs_err": sweep_err, **sweep, "library_ms": None}]
    print(f"{tag} total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
