#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``qsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OLD.cu   # also time an earlier kernel
    python3 chip_smoke.py --against-stepper OLD_DIR  # earlier stepper kernels
    python3 chip_smoke.py --against-sweep OLD.cu     # an earlier stepper_sweep
    python3 chip_smoke.py --ablate-sweep   # where a kv16 iteration's cycles go

Phases, in order; any failure exits non-zero and no result is printed:

1. device: the card's name and power limit (``nvidia-smi``), the torch
   device name and count;
2. build: ``nvcc`` compiles every kernel from the sources in the checkout,
   one process a source, all started together; the ``-Xptxas -v``
   register / stack / spill lines are printed (a spill fails the run),
   beside the launch plans of phase 3 (lanes per block, shared bytes,
   what is staged in shared memory); then ``g++`` builds the native host
   oracle (``native/wg.cpp``), which must build: its status and build
   time are printed;
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
   from a mid-search carry, after 1 and 3 chunks of 2048 iterations at
   full width, and from the mid-search carry after each of 8 on a lane
   sample (one lane of every unique history still running, carried to the
   CPU by ``compact_carry_plain`` and advanced there by the plain
   version); on
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
   mid-search carry: launched as the main path launches it (the running
   lanes alone) and over every lane, every plane bit-identical to
   ``stepper_sweep_plain`` at full width after 1 and 2 chunks of 1024
   iterations (KV) or 1 (the others), and on a lane sample (as in phase
   6) after each of 8 chunks (KV) or 2; each case's plan and how its
   running lanes fall on blocks and SMs, time per launch in turns (every
   lane, the running lanes alone), cycles an iteration of the longest
   lane at the SM clock, plain time and bound, and with the memo the
   probes whose filter tag matched; ``compact_carry`` on the KV carry with
   its bound.  With ``--against-sweep OLD.cu`` (an earlier
   ``stepper_sweep.cu`` whose C entry takes 14 pointers, 15 ints and the
   stream, without a lane list), that kernel
   is built too, checked equal, and timed in turns with this one (old,
   new, new, old) on every case's mid-search carry.  With
   ``--ablate-sweep`` the kv16 kernel is also timed against the number of
   running lanes launched and, in turns, against ablation builds of its
   source (``SWEEP_ABLATIONS``), each checked to leave the search as it
   is;
10. kv16 checker (main path of the sweep regime): ``TorchStepper`` on the
   512 unique KV histories at 4096 lanes, cold, warm and profiled; 0
   verdict mismatches against the port's memo oracle run on each key's
   register sub-history (``PComp(spec)``), witnesses replayed;
11. kv16 property: ``prop_concurrent`` at 16 pids x 64 ops, racy
   convicted, atomic passed;
12. milestones: KV at its default size (16 pids x 64 ops, a 256-state
   shadow) through ``TorchStepper``'s table regime, and the ticket
   dispenser (4 pids x 24 ops) through ``TorchGPU`` and ``TorchStepper``:
   each checker against its oracle and ``prop_concurrent`` racy and
   atomic;
13. per-key decomposition (main path of ``PComp`` over ``TorchStepper``):
   the kv16 corpus, the KV milestone's, and the registry defaults of
   multireg and multicas (16 pids x 64 ops), each at 4096 lanes, cold,
   warm and profiled: no lane undecided, 0 mismatches against the memo
   oracle per key, the whole-history checker's verdicts wherever it
   decided (phases 10 and 12; for multireg and multicas ``TorchStepper``
   on the unique corpus, run before the path), 8 stitched witnesses
   replayed; the split timed alone, sub-histories, device batches,
   launches; then ``prop_concurrent`` on kv16 through it, racy
   convicted, atomic passed, nothing undecided;
14. hybrid plan (main path of ``HybridDevice``): the CAS and queue
   headlines at 4096 lanes, budget 2000, the native oracle as the tail:
   verdicts equal to the memo oracle's, nothing undecided, no degrade,
   the device deciding some; then ``CppOracle`` against the memo oracle
   on each headline's 512 unique histories, verdicts equal, both timed.

   After each case of phases 13 and 14 its launches are read, then its
   kernels are held against their plain versions on the path's own
   inputs, recorded as the path ran (``FirstInputs``): one chunk of
   ``stepper_chunk`` from its first batch's fresh carry (its tables,
   bucket, op count, slots, chunk and budget) at full width on the card
   against the plain version on a lane sample on the CPU, and its first
   compaction against ``compact_carry_plain`` at full width (tolerance
   0).

Each main path's launch counts are reset just before it and read just
after (``dfs_chunk`` over phases 4-5, ``stepper_chunk`` and
``compact_carry`` over phases 7-8, ``stepper_sweep`` and
``compact_carry`` over phases 10-11, each milestone's kernels over its
own path, and each case of phases 13 and 14 over its own; the kernels
record lists those of phases 7-8 under ``launches`` and every path's
under ``launches_by_path``).  The second-to-last stdout line is the
kernels record, the last the device record.  Every number is printed
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import random
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from qsm_tpu_torch import native
from qsm_tpu_torch.core.history import encode_batch
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.counter import (AtomicTicketSUT, RacyTicketSUT,
                                          TicketSpec)
from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                        RacyTwoPhaseQueueSUT)
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.models.stack import (AtomicStackSUT, RacyTwoPhaseStackSUT,
                                        StackSpec)
from qsm_tpu_torch.models.txn import (AtomicTxnSUT, TornCopyTxnSUT,
                                      TxnRegisterSpec)
from qsm_tpu_torch.ops import kernels
from qsm_tpu_torch.ops import stepper as stepper_module
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.dfs_kernel import (MEMO_GLOBAL, MEMO_SHARED, RUNNING,
                                          SMEM_BLOCK_MAX,
                                          Carry, blocks_per_sm, dfs_chunk,
                                          dfs_chunk_plain, launch_plan)
from qsm_tpu_torch.ops.gpu_backend import TorchGPU, fresh_carry, lane_tables
from qsm_tpu_torch.ops.host_contracts import flatten
from qsm_tpu_torch.ops.hybrid import HybridDevice
from qsm_tpu_torch.ops.pcomp import PComp, split_history
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
SAMPLE_LANES = 192             # lanes of a sample held on the CPU
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
    return warm_s


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
            cpu_tabs = type(tabs)(*(t.cpu() for t in tabs))
        for slots in (0, default_slots(B)):
            fresh = fresh_stepper_carry(tabs.nreq, np.arange(B), starts, B,
                                        N, slots)
            begins = {"fresh": fresh}
            if name == "queue48":
                # mid-search: 256 plain iterations in, the hard lanes
                # still running
                begins["mid"] = stepper_chunk_plain(
                    tabs, clone_carry(fresh), chunk=256, budget=TOTAL_BUDGET)
            # the plain version's loop on the card is the phase's cost: the
            # CAS shapes run 2 chunks at full width, the queue headline 3,
            # and from its mid-search carry 8 on a lane sample carried on
            # the CPU
            n_full = 3 if name == "queue48" else 2
            for start, c0 in begins.items():
                n_sample = 8 if start == "mid" else 0
                ck, cp = clone_carry(c0), clone_carry(c0)
                running = int((c0.dsi[1] == RUNNING).sum())
                if n_sample:
                    sample = LaneSample(c0, len(q_corpus), functools.partial(
                        stepper_chunk_plain, cpu_tabs, chunk=STEP_CHUNK,
                        budget=TOTAL_BUDGET))
                for i in range(max(n_full, n_sample)):
                    new_stepper(tabs, ck)
                    if i < n_full:
                        stepper_chunk_plain(tabs, cp, chunk=STEP_CHUNK,
                                            budget=TOTAL_BUDGET)
                    if i in (0, n_full - 1):
                        torch.cuda.synchronize()
                        max_err = max(max_err, _compare(
                            f"stepper_chunk {name} B={B} slots={slots} "
                            f"{start} chunk {i + 1}", ck, cp))
                    if i < n_sample:
                        max_err = max(max_err, sample.step_and_check(
                            ck, f"stepper_chunk {name} slots={slots} {start}"
                            f" lane sample chunk {i + 1}"))
                what = (f"; on a sample of {len(sample.lanes)} lanes "
                        f"({sample.unique} unique histories) after each of "
                        f"{n_sample}" if n_sample else "")
                print(f"{tag} stepper_chunk == plain on {name} B={B} "
                      f"slots={slots} from a {start} carry ({running} lanes "
                      f"running): all 7 planes bit-identical after 1 and "
                      f"{n_full} chunks of {STEP_CHUNK} at full width{what}; "
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
    return warm_s


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

def sweep_cases(kv_spec, kv_corpus, dev):
    """(name, spec, B, N, tables, start states, unique histories) of the
    sweep phase: KV of 16 keys at 4096 lanes of 64 ops; queue and stack of
    capacity 8, txn(8, 8) and a random vector spec of 9 elements at 1024
    lanes.  Lane i holds unique history i % unique."""
    tabs, starts = sweep_inputs(kv_spec, _replicate(kv_corpus, DEVICE_BATCH),
                                KV_OPS, dev)
    yield "kv16", kv_spec, DEVICE_BATCH, KV_OPS, tabs, starts, len(kv_corpus)
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
        yield name, spec, 1024, n_ops, tabs, starts, len(hs)


class LaneSample:
    """A seeded sample of a card carry's RUNNING lanes, held on the CPU:
    one lane of every unique history still running (``row % n_unique``
    names it), then others up to ``SAMPLE_LANES``.  Lanes are independent
    (each has its own stacks, counters and memo), so the sample, moved by
    ``compact_carry_plain`` at the same slot count and advanced by the
    plain version on the CPU, evolves exactly as those lanes do in the
    card's carry."""

    def __init__(self, carry: StepperCarry, n_unique: int, plain, seed=0):
        rng = np.random.default_rng(seed)
        status = carry.dsi[1].cpu().numpy()
        rows = carry.row.cpu().numpy()
        order = rng.permutation(np.flatnonzero(status == RUNNING))
        _, first = np.unique(rows[order] % n_unique, return_index=True)
        rest = rng.permutation(np.setdiff1d(order, order[first]))
        self.unique = len(first)
        self.lanes = np.sort(np.concatenate(
            [order[first], rest[:max(SAMPLE_LANES - len(first), 0)]]))
        self.plain = plain
        self.carry = self._cut(carry)

    def _cut(self, carry: StepperCarry) -> StepperCarry:
        c = compact_carry_plain(carry, self.lanes, len(self.lanes),
                                carry.occ.shape[1])
        return StepperCarry(*(t.cpu() for t in c))

    def step_and_check(self, carry: StepperCarry, what: str) -> int:
        """One chunk of the plain version on the sample, then the sampled
        lanes of ``carry`` (the card's, after the same chunk) compared
        plane by plane; the largest error (0, or this raises)."""
        self.plain(self.carry)
        torch.cuda.synchronize()
        return _compare(what, self._cut(carry), self.carry)


def sweep_ops_per_iteration(n_ops: int, dim: int, memo: bool) -> int:
    """Integer ops of one sweep iteration, as counted from the first
    version of ``csrc/stepper_sweep.cu`` and kept, so that every version
    divides by one yardstick: the blocked-op sweep 2W + 2 an op and the postcondition
    about 8 (the kind's branch, a clamped index, a load, a compare), the
    candidate words and the lowest one 3W + 4, the child 3 a state word,
    the stack update, status and budget about 26; with the memo the two
    hashes and the key compare 6 kw + 5 more."""
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


def running_lanes(c: StepperCarry) -> np.ndarray:
    return np.flatnonzero(c.dsi[1].cpu().numpy() == RUNNING)


def new_sweep(model, tabs, c, lanes=None):
    return stepper_sweep(model, tabs, c, chunk=SWEEP_CHUNK,
                         budget=TOTAL_BUDGET, lanes=lanes)


def main_sweep(model, tabs, c):
    """A launch as the sweep regime's main path makes it
    (``TorchStepper._run_device``): the running lanes alone."""
    return new_sweep(model, tabs, c, lanes=running_lanes(c))


def sweep_raw(model, tabs, c, lanes=None, stats=None, fn=None):
    """This ``stepper_sweep``'s C entry alone (``lanes`` an int32 tensor on
    the card, or None for every lane), for timing: no host checks, no
    host sync between launches; ``fn`` another build's entry."""
    R, N = tabs.cmd.shape
    B, D, slots = c.row.shape[0], c.states.shape[2], c.occ.shape[1]
    L = B if lanes is None else lanes.numel()
    plan = sweep_launch_plan(L, N, D, slots, device_sms(c.row.device))
    fn = fn or kernels.stepper_sweep_lib().stepper_sweep_launch
    rc = fn(
        *(t.data_ptr() for t in tabs), model.data.data_ptr(),
        c.row.data_ptr(), *(t.data_ptr() for t in c[:6]),
        None if lanes is None else lanes.data_ptr(),
        None if stats is None else stats.data_ptr(), B, R, N, n_words(N), D,
        slots, SWEEP_CHUNK, TOTAL_BUDGET, model.kind, *model.params, L,
        *(int(x) for x in plan), torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"stepper_sweep's C entry failed ({rc})")
    return c


def old_sweep_kernel(src: Path):
    """A launcher for an earlier ``stepper_sweep.cu`` (the first version's
    C entry: 14 pointers, 15 ints with its own launch plan, the stream),
    built like this one."""
    fn = ctypes.CDLL(str(kernels.build("stepper_sweep_against", src=src))
                     ).stepper_sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(model, tabs, c):
        R, N = tabs.cmd.shape
        B, D, slots = c.row.shape[0], c.states.shape[2], c.occ.shape[1]
        W = n_words(N)
        per_warp = 4 * ((N + 1) * (D + 1) + D + W * (W + 3) * 32)
        wpb = max(1, min(16, SMEM_BLOCK_MAX // per_warp,
                         -(-B // device_sms(c.row.device))))
        rc = fn(*(t.data_ptr() for t in tabs), model.data.data_ptr(),
                c.row.data_ptr(), *(t.data_ptr() for t in c[:6]), B, R, N,
                W, D, slots, SWEEP_CHUNK, TOTAL_BUDGET, model.kind,
                *model.params, wpb, -(-B // wpb), wpb * per_warp,
                torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"the earlier stepper_sweep failed ({rc})")
        return c
    return launch


def sm_clock_mhz() -> float:
    """The SM clock now (``nvidia-smi --query-gpu=clocks.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()
    return float(out[0])


def load_text(mid: StepperCarry, N: int, D: int, slots: int, sms: int,
              listed: bool) -> str:
    """How the running lanes fall on blocks and SMs under the launch plan
    (all B lanes, or the running lanes alone), per SM as if block i runs
    on SM i mod sms in the first wave (the order in which blocks are
    handed out is the hardware's; this reads the plan, not the card)."""
    run = (mid.dsi[1] == RUNNING).cpu().numpy().astype(np.int64)
    if listed:
        run = np.ones(int(run.sum()), np.int64)
    p = sweep_launch_plan(len(run), N, D, slots, sms)
    blocks = np.add.reduceat(run, np.arange(0, len(run), p.warps_per_block))
    per_sm = np.bincount(np.arange(len(blocks)) % sms, weights=blocks,
                         minlength=sms)
    return (f"{'running lanes alone' if listed else 'all lanes'}: "
            f"{p.warps_per_block} warps a block, grid {p.grid}; running "
            f"warps a block mean {blocks.mean():.2f}, max {blocks.max()}; "
            f"an SM mean {per_sm.mean():.2f}, max {per_sm.max():.0f}, min "
            f"{per_sm.min():.0f}")


def time_sweep(launch, mid, reps=5) -> float:
    """ms per launch of ``launch(c)`` from the mid-search carry, each
    launch on its own copy (the kernels update the carry in place)."""
    return time_launches(launch, [clone_carry(mid) for _ in range(reps + 1)],
                         reps)


def phase_sweep(kv_spec, kv_corpus, dev, tag, against=None):
    """Phase 9: stepper_sweep against stepper_sweep_plain on every case,
    at full width after the first chunks and on a lane sample after every
    chunk, then timings, bounds, cycles an iteration; compact_carry on the
    KV carry.  With ``against`` (an earlier stepper_sweep.cu) that kernel
    is checked equal and timed in turns.  Returns the largest error of
    each kernel and the headline row."""
    max_err, comp_err, head = 0, 0, None
    sms = device_sms(dev)
    old = old_sweep_kernel(against) if against is not None else None
    if old is not None:
        for line in kernels.ptxas_report("stepper_sweep_against",
                                         against).splitlines():
            if any(k in line for k in ("registers", "stack frame")):
                print(f"  ptxas (earlier stepper_sweep): {line.strip()}")
    for name, spec, B, N, tabs, starts, n_unique in sweep_cases(
            kv_spec, kv_corpus, dev):
        t_case = time.perf_counter()
        D = spec.STATE_DIM
        model = sweep_model(spec, dev)
        cpu_tabs = type(tabs)(*(t.cpu() for t in tabs))
        for slots in ((0, default_slots(B, D)) if name == "kv16"
                      else (default_slots(B, D),)):
            p = sweep_launch_plan(B, N, D, slots, sms)
            print(f"  plan: {name} B={B} N={N} D={D} slots={slots} kind "
                  f"{model.kind}: {p.warps_per_block} warps a block, grid "
                  f"{p.grid}, {p.smem_bytes} shared bytes a block",
                  flush=True)
            fresh = fresh_sweep_carry(tabs.nreq, np.arange(B), starts, B, N,
                                      slots)
            # mid-search: SWEEP_MID plain iterations in
            mid = stepper_sweep_plain(spec, tabs, clone_carry(fresh),
                                      chunk=SWEEP_MID, budget=TOTAL_BUDGET)
            run_mid = running_lanes(mid)
            running = len(run_mid)
            require(running > 0, f"{name}: no lane running mid-search")
            for listed in (False, True):
                print(f"  load of the {name} slots={slots} mid-search carry, "
                      f"{load_text(mid, N, D, slots, sms, listed)}",
                      flush=True)
            # full width: the kernel as the main path launches it (the
            # running lanes alone) and over every lane, against the plain
            # version on the card; the first plain chunk is its time
            n_full = 2 if name == "kv16" else 1
            ck, cf, cp = (clone_carry(mid) for _ in range(3))
            sample = LaneSample(mid, n_unique, lambda c: stepper_sweep_plain(
                spec, cpu_tabs, c, chunk=SWEEP_CHUNK, budget=TOTAL_BUDGET))
            n_sample = 8 if name == "kv16" else 2
            for i in range(max(n_full, n_sample)):
                main_sweep(model, tabs, ck)
                if i < n_full:
                    new_sweep(model, tabs, cf)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    stepper_sweep_plain(spec, tabs, cp, chunk=SWEEP_CHUNK,
                                        budget=TOTAL_BUDGET)
                    torch.cuda.synchronize()
                    if i == 0:
                        plain_ms = (time.perf_counter() - t0) * 1e3
                    for label, c in (("running lanes", ck), ("all lanes",
                                                             cf)):
                        max_err = max(max_err, _compare(
                            f"stepper_sweep {name} B={B} slots={slots} "
                            f"{label} chunk {i + 1}", c, cp))
                if i < n_sample:
                    max_err = max(max_err, sample.step_and_check(
                        ck, f"stepper_sweep {name} slots={slots} lane "
                        f"sample chunk {i + 1}"))
            # timings through the C entry, in turns: every lane, the
            # running lanes alone
            lanes_t = torch.from_numpy(run_mid.astype(np.int32)).to(dev)
            turns = {"all": [], "running": []}
            for who in ("all", "running", "running", "all"):
                turns[who].append(time_sweep(
                    lambda c: sweep_raw(model, tabs, c,
                                        lanes_t if who == "running"
                                        else None), mid))
            mhz = sm_clock_mhz()
            ms = sum(turns["running"]) / 2
            ms_all = sum(turns["all"]) / 2
            one = sweep_raw(model, tabs, clone_carry(mid), lanes_t)
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            sweep_raw(model, tabs, clone_carry(mid), lanes_t, stats)
            probes, passes = (int(x) for x in stats.cpu())
            hits = int((one.dsi[3] - mid.dsi[3]).sum())
            longest = int((one.dsi[2] - mid.dsi[2]).max())
            bound_ms, bound_by, nbytes, ops = sweep_bound(tabs, mid, one)
            cycles = ms * 1e-3 * mhz * 1e6 / max(longest, 1)
            filt = (f"; memo probes {probes}, tag matched {passes} "
                    f"({passes / max(probes, 1):.4f}), hits {hits}"
                    if slots else "")
            print(f"{tag} stepper_sweep == plain on {name} B={B} N={N} D={D}"
                  f" slots={slots} from a mid-search carry ({running} lanes "
                  f"running): all 7 planes bit-identical after "
                  f"{' and '.join(str(k + 1) for k in range(n_full))} "
                  f"chunk(s) of {SWEEP_CHUNK} at full width (running lanes "
                  f"alone and all lanes), and on a sample of "
                  f"{len(sample.lanes)} lanes ({sample.unique} unique "
                  f"histories) after each of {n_sample}; {ms:.4f} ms/launch "
                  f"running lanes alone, {ms_all:.4f} all lanes (in turns: "
                  f"all {turns['all'][0]:.4f}/{turns['all'][1]:.4f}, running"
                  f" {turns['running'][0]:.4f}/{turns['running'][1]:.4f}); "
                  f"longest lane {longest} iterations, {cycles:.0f} cycles an"
                  f" iteration at {mhz:.0f} MHz (bound {bound_ms:.6f} ms by "
                  f"{bound_by}: {nbytes} B, {ops} ops; plain {plain_ms:.1f} "
                  f"ms){filt}; {int((ck.dsi[1] == RUNNING).sum())} still "
                  f"running; case {time.perf_counter() - t_case:.1f} s",
                  flush=True)
            if old is not None:
                a = old(model, tabs, clone_carry(mid))
                b = sweep_raw(model, tabs, clone_carry(mid), lanes_t)
                torch.cuda.synchronize()
                _compare(f"earlier stepper_sweep vs this, {name} "
                         f"slots={slots}", a, b)
                turns = {"old": [], "new": []}
                for who in ("old", "new", "new", "old"):
                    turns[who].append(time_sweep(
                        (lambda c: old(model, tabs, c)) if who == "old" else
                        (lambda c: sweep_raw(model, tabs, c, lanes_t)), mid))
                o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
                print(f"{tag} earlier vs this stepper_sweep, {name} B={B} "
                      f"slots={slots} (old, new, new, old): old "
                      f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
                      f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per "
                      f"launch; old/new {o / n:.2f}x", flush=True)
            if name == "kv16" and slots:
                head = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
                kv_carry = cf
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
    bound_ms, nbytes = compact_bound(kv_carry, got, len(lanes))
    print(f"{tag} compact_carry == plain on the kv16 sweep carry: "
          f"{DEVICE_BATCH} -> {COMPACT_TO} lanes, "
          f"{kv_carry.occ.shape[1]} -> {slots} slots "
          f"({int((got.occ == 1).sum())} memo entries after): all 7 planes "
          f"bit-identical; {ms:.4f} ms/launch (bound {bound_ms:.6f} ms by "
          f"bytes: {nbytes} B)", flush=True)
    return max_err, comp_err, head


# Ablation builds of stepper_sweep.cu: (name, text replaced, replacement).
# Each keeps the search exactly as it is (the same carries), so a time
# difference is the cost of what the variant adds or takes away.
SWEEP_ABLATIONS = (
    # one more dependent hash on every probe (p2 is 0 for KV: the hash
    # result is unchanged, the compiler cannot know)
    ("extra hash", "        h = mix_words<DH>(h, child, D);\n",
     "        h = mix_words<DH>(h, child, D);\n"
     "        h ^= mix_words<DH>(h, child, D) & static_cast<uint32_t>(a.p2);\n"),
    # one more dependent device-memory load before every key compare
    # (occupancy is 0 or 1: the offset is 0, the compiler cannot know)
    ("extra load",
     "          const int32_t* key = keys + static_cast<size_t>(sl) * kw;\n"
     "          bool eq",
     "          const int32_t* key = keys + static_cast<size_t>(sl) * kw +\n"
     "                               (occ[sl] & 0x40000000);\n"
     "          bool eq"),
    # the hash loop of a width without its own instantiation, at D = 16
    ("hash loop", "    case 16: return stepper_sweep_kernel<W, true, K, 16>;\n",
     ""),
)


def phase_sweep_ablation(kv_spec, kv_corpus, dev, tag):
    """``--ablate-sweep``: where a kv16 iteration's cycles go.  The
    kernel's time against the number of running lanes launched (1 to ~16
    warps an SM: a chain's latency, then the SM's issue), and each
    ablation build in turns with this one (this, variant, variant, this)
    at 1 warp an SM and at every running lane, memo off and on."""
    src = kernels.CSRC_DIR / "stepper_sweep.cu"
    text = src.read_text()
    out = kernels.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    launchers = {}
    for name, old, new in SWEEP_ABLATIONS:
        require(text.count(old) == 1, f"ablation '{name}': the source no "
                f"longer has its text")
        path = out / f"stepper_sweep_{name.replace(' ', '_')}.cu"
        path.write_text(text.replace(old, new))
        launchers[name] = path
    with ThreadPoolExecutor(len(launchers)) as pool:
        libs = dict(zip(launchers, pool.map(
            lambda kv: kernels.build(f"sweep_{kv[0].replace(' ', '_')}",
                                     src=kv[1]), launchers.items())))
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).stepper_sweep_launch
        fn.argtypes = list(kernels.stepper_sweep_lib(
        ).stepper_sweep_launch.argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    fns["this"] = kernels.stepper_sweep_lib().stepper_sweep_launch
    tabs, starts = sweep_inputs(kv_spec, _replicate(kv_corpus, DEVICE_BATCH),
                                KV_OPS, dev)
    model = sweep_model(kv_spec, dev)
    for slots in (0, default_slots(DEVICE_BATCH, KV_KEYS)):
        fresh = fresh_sweep_carry(tabs.nreq, np.arange(DEVICE_BATCH), starts,
                                  DEVICE_BATCH, KV_OPS, slots)
        mid = stepper_sweep_plain(kv_spec, tabs, fresh, chunk=SWEEP_MID,
                                  budget=TOTAL_BUDGET)
        run = running_lanes(mid)
        sms = device_sms(dev)
        for L in sorted({sms, 4 * sms, 8 * sms, len(run)}):
            lanes_t = torch.from_numpy(np.sort(np.random.default_rng(
                0).permutation(run)[:L]).astype(np.int32)).to(dev)
            ms = time_sweep(lambda c: sweep_raw(model, tabs, c, lanes_t),
                            mid)
            mhz = sm_clock_mhz()
            print(f"{tag} ablation kv16 slots={slots}: {L} running lanes "
                  f"({L / sms:.2f} warps an SM): {ms:.4f} ms/launch, "
                  f"{ms * 1e-3 * mhz * 1e6 / SWEEP_CHUNK:.0f} cycles an "
                  f"iteration at {mhz:.0f} MHz", flush=True)
            if L not in (sms, len(run)):
                continue
            want = sweep_raw(model, tabs, clone_carry(mid), lanes_t)
            for name in fns:
                if name == "this" or (not slots and name != "hash loop"):
                    continue
                got = sweep_raw(model, tabs, clone_carry(mid), lanes_t,
                                fn=fns[name])
                require(all(torch.equal(x, y) for x, y in zip(got, want)),
                        f"ablation '{name}' changed the search")
                turns = {"this": [], name: []}
                for who in ("this", name, name, "this"):
                    turns[who].append(time_sweep(
                        lambda c: sweep_raw(model, tabs, c, lanes_t,
                                            fn=fns[who]), mid))
                a, b = (sum(turns[k]) / 2 for k in ("this", name))
                mhz = sm_clock_mhz()
                cyc = (b - a) * 1e-3 * mhz * 1e6 / SWEEP_CHUNK
                print(f"{tag} ablation kv16 slots={slots} L={L}, '{name}' "
                      f"(this, variant, variant, this): this {a:.4f} ms, "
                      f"variant {b:.4f} ms: {cyc:+.0f} cycles an iteration "
                      f"at {mhz:.0f} MHz", flush=True)


# what check_corpus reports of a warm run, where a backend or the device
# engine inside it keeps the counter: the device driver's rounds; the
# stepper's device batches (each its own encoding and tables); the
# per-key split (sub-histories, the longest, host time of split, fold and
# stitch); the hybrid plan's division of the work
RUN_COUNTERS = ("rounds_run", "compactions", "chunk_launches",
                "device_batches", "subs_produced", "max_sub_len",
                "recombine_s", "device_decided", "tail_histories",
                "degradations")


def engine_of(backend):
    """The device engine inside a combinator (the per-key split's inner
    backend, the hybrid plan's device), or the backend itself."""
    if isinstance(backend, PComp):
        return backend.inner
    if isinstance(backend, HybridDevice):
        return backend.device
    return backend


def check_corpus(name, backend, spec, corpus, oracle, tag, witnesses=32):
    """``backend.check_histories`` on ``corpus`` replicated to 4096 lanes,
    cold and warm, then profiled; 0 verdict mismatches against ``oracle``
    wherever both decided; up to ``witnesses`` LINEARIZABLE witnesses
    replayed.  Returns the warm verdicts, the oracle's and both times."""
    device_corpus = _replicate(corpus, DEVICE_BATCH)
    t0 = time.perf_counter()
    cold = backend.check_histories(spec, device_corpus)
    cold_s = time.perf_counter() - t0
    objs = [backend] + ([engine_of(backend)]
                        if engine_of(backend) is not backend else [])
    counters = [(o, k) for o in objs for k in RUN_COUNTERS
                if hasattr(o, k)]
    before = [getattr(o, k) for o, k in counters]
    t0 = time.perf_counter()
    v = backend.check_histories(spec, device_corpus)
    warm_s = time.perf_counter() - t0
    after = ", ".join(
        f"{k} {getattr(o, k)}" if k == "max_sub_len"
        else f"{k} {getattr(o, k) - b:.3f}" if k == "recombine_s"
        else f"{k} {getattr(o, k) - b}"
        for (o, k), b in zip(counters, before))
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
    lin = [h for h, x in zip(corpus, uv)
           if x == Verdict.LINEARIZABLE][:witnesses]
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
    return dict(v=v, ov=ov, warm_s=warm_s, oracle_s=oracle_s)


def check_property(name, make_backend, spec, suts, cfg, tag, oracle=None,
                   all_decided=False):
    """``prop_concurrent``: the racy SUT convicted, the atomic one
    passed, nothing undecided on the atomic run (on both with
    ``all_decided``)."""
    for impl, sut, want_ok in (("racy", suts[1], False),
                               ("atomic", suts[0], True)):
        backend = make_backend()
        t0 = time.perf_counter()
        res = prop_concurrent(spec, sut, PropertyConfig(**cfg),
                              backend=backend, oracle=oracle)
        dt = time.perf_counter() - t0
        require(res.ok == want_ok, f"{name} {impl}: ok={res.ok}")
        require((not want_ok and not all_decided) or res.undecided == 0,
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
    kv16 corpus, then prop_concurrent on kv16.  Returns the checker's
    verdicts."""
    t = TorchStepper(spec)
    require(t.regime == "sweep", f"kv16 took the {t.regime} regime")
    oracle = PComp(spec)  # the memo oracle on each key's sub-history
    v = check_corpus("kv16", t, spec, corpus, oracle, tag)["v"]
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
    return v


def kv4_corpus():
    """The KV milestone: the registry's KV default, 4 keys."""
    spec = KvSpec()
    return spec, build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT),
                              n=N_UNIQUE, n_pids=KV_PIDS, max_ops=KV_OPS,
                              seed_base=1000, seed_prefix="bench")


def phase_milestones(tag):
    """Phase 12: the two milestone configurations the port could not
    check before: KV at its default size (4 keys, a 256-state shadow)
    through TorchStepper's table regime; the ticket dispenser through
    TorchGPU and TorchStepper.  Each kernel's launches are counted over
    its path alone.  Returns the KV milestone checker's verdicts."""
    spec, corpus = kv4_corpus()
    oracle = PComp(spec)
    stepper_chunk.launches = compact_carry.launches = 0
    t = TorchStepper(spec)
    require(t.regime == "table" and t.kspec.n_packed == 256,
            "KV at its default size is not on the table regime's shadow")
    kv4_v = check_corpus("kv (4 keys)", t, spec, corpus, oracle, tag)["v"]
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
    return kv4_v


def registry_corpus(model):
    """A registry model at its default spec and size."""
    entry = MODELS[model]
    spec = entry.make_spec()
    return spec, build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]), n=N_UNIQUE,
        n_pids=entry.default_pids, max_ops=entry.default_ops,
        seed_base=1000, seed_prefix="bench")


def path_launches(name, tag, counters):
    """Print the launches of each kernel in ``counters`` since they were
    set to 0, and require one of the first."""
    print(f"{tag} path of {name}: " + ", ".join(
        f"{c.launches} {c.__name__}" for c in counters) + " launches",
        flush=True)
    require(counters[0].launches > 0,
            f"{name} launched no {counters[0].__name__}")
    return {c.__name__: c.launches for c in counters}


class FirstInputs:
    """Inside ``with``: the inputs of the first ``stepper_chunk`` and the
    first ``compact_carry`` that ``TorchStepper`` runs, cloned before the
    launch, so that a path's own shapes (its tables, bucket, op count,
    slots and chunk) can be held against the plain versions after the
    path's launches are read.  ``TorchStepper``'s module names are
    swapped for pass-through functions: each launch is still counted
    once, by the wrapper it reaches."""

    def __init__(self):
        self.step = self.comp = None

    def _step(self, tabs, carry, **kw):
        if self.step is None:
            self.step = (tabs, clone_carry(carry), kw)
        return stepper_chunk(tabs, carry, **kw)

    def _comp(self, carry, lanes, bucket, slots):
        if self.comp is None:
            self.comp = (clone_carry(carry), np.array(lanes), bucket, slots)
        return compact_carry(carry, lanes, bucket, slots)

    def __enter__(self):
        stepper_module.stepper_chunk = self._step
        stepper_module.compact_carry = self._comp
        return self

    def __exit__(self, *exc):
        stepper_module.stepper_chunk = stepper_chunk
        stepper_module.compact_carry = compact_carry


def hold_path_kernels(name, first, tag):
    """The kernels of a path against their plain versions, on the path's
    own inputs (``first``, a :class:`FirstInputs`): one chunk of
    ``stepper_chunk`` from the first batch's fresh carry at full width
    on the card, the plain version on a lane sample on the CPU (as in
    phase 6), all 7 planes of the sample compared; the path's first
    compaction against ``compact_carry_plain`` at full width.  Called
    after the path's launches are read.  Returns the largest error."""
    tabs, c0, kw = first.step
    B, N, slots = c0.row.shape[0], tabs.vocab.shape[1], c0.occ.shape[1]
    cpu_tabs = type(tabs)(*(t.cpu() for t in tabs))
    sample = LaneSample(c0, min(SAMPLE_LANES, B), functools.partial(
        stepper_chunk_plain, cpu_tabs, **kw))
    ck = clone_carry(c0)
    stepper_chunk(tabs, ck, **kw)
    err = sample.step_and_check(ck, f"stepper_chunk on the path of {name}")
    print(f"{tag} stepper_chunk == plain on the path of {name}: its first "
          f"batch, B={B} N={N} slots={slots}, from the fresh carry, one "
          f"chunk of {kw['chunk']} at budget {kw['budget']}: all 7 planes "
          f"bit-identical on a sample of {len(sample.lanes)} lanes; "
          f"{int((ck.dsi[1] == RUNNING).sum())} of {B} still running",
          flush=True)
    if first.comp is None:
        print(f"{tag} compact_carry on the path of {name}: the path made "
              f"no compaction", flush=True)
        return err
    c, lanes, to, new_slots = first.comp
    got = compact_carry(c, lanes, to, new_slots)
    want = compact_carry_plain(c, lanes, to, new_slots)
    torch.cuda.synchronize()
    err = max(err, _compare(f"compact_carry on the path of {name}", got,
                            want))
    print(f"{tag} compact_carry == plain on the path of {name}: its first "
          f"compaction, {c.row.shape[0]} -> {to} lanes, "
          f"{c.occ.shape[1]} -> {new_slots} slots: all 7 planes "
          f"bit-identical at full width", flush=True)
    return err


def phase_pcomp(cases, tag):
    """Phase 13: per-key decomposition on the card.  ``cases``: (name,
    spec, unique corpus, the whole-history checker's verdicts from an
    earlier phase, or None: then ``TorchStepper``'s on the unique corpus,
    run before the path's counts are reset).  Each corpus goes through
    ``PComp(spec, TorchStepper)`` at 4096 lanes: no lane undecided, 0
    mismatches against the memo oracle per key, the whole-history
    verdicts wherever that checker decided (it shares no split or fold
    with the path), a sample of stitched witnesses replayed; the first
    case's property run too.  Each case is its own main path; its
    kernels are then held against their plain versions on its own first
    inputs.  Returns the launches of each and the largest error."""
    launches, err = {}, 0
    for i, (name, spec, corpus, whole) in enumerate(cases):
        if whole is None:
            whole = TorchStepper(spec).check_histories(spec, corpus)
        stepper_chunk.launches = compact_carry.launches = 0
        pc = PComp(spec, lambda p: TorchStepper(p))
        require(pc.inner.regime == "table",
                f"{name}: the sub-histories are not on the table regime")
        with FirstInputs() as first:
            r = check_corpus(f"{name} per key", pc, spec, corpus,
                             PComp(spec), tag, witnesses=8)
        v = r["v"]
        und = int((v == Verdict.BUDGET_EXCEEDED).sum())
        require(und == 0, f"{name} per key: {und} lanes undecided")
        decided = whole != Verdict.BUDGET_EXCEEDED
        require(decided.any(), f"{name}: the whole-history checker "
                f"decided nothing to compare with")
        require((v[:len(whole)][decided] == whole[decided]).all(),
                f"{name} per key: verdicts differ from the whole-history "
                f"checker's")
        agree = (f"; equal to the whole-history checker's on its "
                 f"{int(decided.sum())} decided of {len(whole)} lanes, "
                 f"decides its {int((~decided).sum())} undecided ones")
        device_corpus = _replicate(corpus, DEVICE_BATCH)
        t0 = time.perf_counter()
        subs = [split_history(spec, h) for h in device_corpus]
        split_s = time.perf_counter() - t0
        print(f"{tag} {name} per key: {len(v)} lanes, 0 undecided{agree}; "
              f"a batch splits into {sum(map(len, subs))} sub-histories "
              f"(the longest {max(len(x) for d in subs for x in d.values())}"
              f" ops) in {split_s:.3f} s on the host, split alone; over all "
              f"runs {pc.subs_produced} sub-histories, "
              f"{pc.inner.device_batches} device batches of the inner "
              f"TorchStepper", flush=True)
        if i == 0:
            suts = tuple(MODELS["kv"].impls[k](spec)
                         for k in ("atomic", "racy"))
            check_property(f"{name} per key",
                           lambda: PComp(spec, lambda p: TorchStepper(p)),
                           spec, suts, dict(n_trials=30, n_pids=KV_PIDS,
                                            max_ops=KV_OPS, seed=0),
                           tag, oracle=PComp(spec), all_decided=True)
        launches[name] = path_launches(f"{name} per key", tag,
                                       (stepper_chunk, compact_carry))
        err = max(err, hold_path_kernels(f"{name} per key", first, tag))
    return launches, err


def phase_hybrid(cases, tag):
    """Phase 14: the hybrid plan on the card, and the native host oracle
    against the memo oracle.  ``cases``: (name, spec, unique corpus, a
    time to set beside, its label).  Each corpus goes through
    ``HybridDevice(spec)`` (budget 2000) at 4096 lanes: verdicts equal to
    the memo oracle's, no lane undecided, no degrade, the device deciding
    some; then ``CppOracle`` and the memo oracle on the unique corpus,
    verdicts equal.  Each case is its own main path; its kernels are then
    held against their plain versions on its own first inputs.  Returns
    the launches of each and the largest error."""
    launches, err = {}, 0
    for name, spec, corpus, beside, label in cases:
        stepper_chunk.launches = compact_carry.launches = 0
        hb = HybridDevice(spec)
        require(isinstance(hb.tail, native.CppOracle),
                f"{name}: the hybrid tail is {hb.tail.name}, not the "
                f"native oracle")
        with FirstInputs() as first:
            r = check_corpus(f"{name} hybrid", hb, spec, corpus,
                             WingGongCPU(memo=True), tag)
        v = r["v"]
        und = int((v == Verdict.BUDGET_EXCEEDED).sum())
        require(und == 0, f"{name} hybrid: {und} lanes undecided")
        require(hb.degradations == 0, f"{name} hybrid: degraded "
                f"({hb.last_error})")
        require(hb.device_decided > 0, f"{name} hybrid: the device "
                f"decided nothing")
        print(f"{tag} {name} hybrid: warm {r['warm_s']:.3f} s for "
              f"{len(v)} lanes (beside {label} {beside:.3f} s), 0 "
              f"undecided; over all its runs the device decided "
              f"{hb.device_decided}, the native tail {hb.tail_histories}",
              flush=True)
        launches[name] = path_launches(f"{name} hybrid", tag,
                                       (stepper_chunk, compact_carry))
        err = max(err, hold_path_kernels(f"{name} hybrid", first, tag))
        cpp = native.CppOracle(spec)
        t0 = time.perf_counter()
        cv = cpp.check_histories(spec, corpus)
        cpp_s = time.perf_counter() - t0
        require(cv.tolist() == r["ov"].tolist(),
                f"{name}: CppOracle and the memo oracle disagree")
        print(f"{tag} {name} host oracles on {len(corpus)} unique "
              f"histories: CppOracle {cpp_s:.3f} s ({cpp.native_histories} "
              f"native, {cpp.fallback_histories} to the fallback), "
              f"WingGongCPU(memo=True) {r['oracle_s']:.3f} s, equal "
              f"verdicts", flush=True)
    return launches, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an earlier dfs_chunk.cu to time in turns with "
                         "this one")
    ap.add_argument("--against-stepper", type=Path, default=None,
                    help="a directory with an earlier stepper_chunk.cu and "
                         "compact_carry.cu to time in turns with these")
    ap.add_argument("--against-sweep", type=Path, default=None,
                    help="an earlier stepper_sweep.cu (a C entry of 14 "
                         "pointers, no lane list) to time in turns with "
                         "this one")
    ap.add_argument("--ablate-sweep", action="store_true",
                    help="after phase 9, time stepper_sweep against the "
                         "running lanes launched and against ablation "
                         "builds of its source (kv16)")
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
    # the native host oracle: g++ must be there (the CUDA toolkit needs a
    # host compiler), so the host ladder must not fall back to Python
    status = native.native_status()
    t0 = time.perf_counter()
    require(native.native_available(), f"the native host oracle did not "
            f"build: {native.native_error()}")
    print(f"{tag} native host oracle: {status} before, g++ build and load "
          f"{time.perf_counter() - t0:.2f} s, now {native.native_status()} "
          f"({native.library_path().name})", flush=True)

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
    gpu_warm_s = phase_checker(spec, corpus, tag)
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
    q_warm_s = phase_queue_checker(q_spec, q_corpus, tag)
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
                                                   tag, args.against_sweep)
    print(f"{tag} phase stepper_sweep vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.ablate_sweep:
        phase_sweep_ablation(kv_spec, kv_corpus, dev, tag)
    # the sweep regime's main path: launch counts over phases 10-11
    stepper_sweep.launches = compact_carry.launches = 0
    t0 = time.perf_counter()
    sweep_v = phase_kv16(kv_spec, kv_corpus, tag)
    sweep_launches = stepper_sweep.launches
    print(f"{tag} main path of TorchStepper's sweep regime: "
          f"{sweep_launches} stepper_sweep launches, "
          f"{compact_carry.launches} compact_carry launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(sweep_launches > 0, "the sweep regime's main path launched no "
            "stepper_sweep")
    t0 = time.perf_counter()
    kv4_v = phase_milestones(tag)
    print(f"{tag} phase milestones: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    pcomp_launches, pcomp_err = phase_pcomp(
        [("kv16", kv_spec, kv_corpus, sweep_v),
         ("kv (4 keys)", *kv4_corpus(), kv4_v),
         ("multireg", *registry_corpus("multireg"), None),
         ("multicas", *registry_corpus("multicas"), None)], tag)
    print(f"{tag} phase per-key decomposition: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    hybrid_launches, hybrid_err = phase_hybrid(
        [("CAS headline", spec, corpus, gpu_warm_s, "TorchGPU"),
         ("queue headline", q_spec, q_corpus, q_warm_s, "TorchStepper")],
        tag)
    print(f"{tag} phase hybrid plan: {time.perf_counter() - t0:.1f} s",
          flush=True)
    by_path = {"queue (phases 7-8)": {"stepper_chunk": step_launches,
                                      "compact_carry": comp_launches},
               **{f"{k} per key": x for k, x in pcomp_launches.items()},
               **{f"{k} hybrid": x for k, x in hybrid_launches.items()}}

    # phase 6 and the paths of phases 13-14, each on its own inputs
    step_err = max(step_err, pcomp_err, hybrid_err)
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
        "max_abs_err": step_err, **step, "library_ms": None,
        "launches_by_path": {k: x["stepper_chunk"]
                             for k, x in by_path.items()}}, {
        "name": "compact_carry", "route": "cuda",
        "source": "qsm_tpu_torch/csrc/compact_carry.cu",
        "replaces": "qsm_tpu/ops/jax_kernel.py:736 (JaxTPU._compact_fn)",
        "launches": comp_launches,
        "matches_plain": max(step_err, sweep_comp_err) == 0,
        "max_abs_err": max(step_err, sweep_comp_err), **comp,
        "library_ms": None,
        "launches_by_path": {k: x["compact_carry"]
                             for k, x in by_path.items()}}, {
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
