#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``qsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OLD.cu   # also time an earlier kernel

Phases, in order; any failure exits non-zero and no result is printed:

1. device: the card's name and power limit (``nvidia-smi``), the torch
   device name and count;
2. build: ``nvcc`` compiles every kernel from the sources in the checkout;
   the ``-Xptxas -v`` register / stack / spill lines are printed (a spill
   fails the run), beside the launch plans of phase 3 (lanes per block,
   shared bytes, what is staged in shared memory);
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
4. checker (main path): ``TorchGPU.check_histories`` on 512 unique
   histories replicated to 4096 lanes; 0 verdict mismatches against the
   memo oracle wherever both decided; witnesses replay through
   ``verify_witness``; one more warm run under ``torch.profiler`` gives
   the device's busy time and idle share;
5. property (main path): ``prop_concurrent`` with ``TorchGPU`` at 8 pids x
   32 ops, 100 trials, seed 0 — racy CAS convicted with a shrunk
   counterexample, atomic CAS passed — and the same racy run through the
   CLI entry point.

The launch counts of the main path (phases 4 and 5) are reset just before
it and read just after.  The second-to-last stdout line is the kernels
record, the last the device record.  Every number is printed beside the
card's name and power limit.
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

from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.ops import kernels
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.dfs_kernel import (MEMO_GLOBAL, MEMO_SHARED, RUNNING,
                                          Carry, blocks_per_sm, dfs_chunk,
                                          dfs_chunk_plain, launch_plan)
from qsm_tpu_torch.ops.gpu_backend import TorchGPU, fresh_carry, lane_tables
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
    lib = kernels.build("dfs_chunk")
    print(f"{tag} build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.ptxas_report("dfs_chunk").splitlines():
        if "Compiling entry" in line:
            print(f"  ptxas: {line.split('dfs_chunk_kernel')[-1].strip()}")
        elif any(k in line for k in ("registers", "stack frame")):
            print(f"  ptxas: {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        require(m is None or m.groups() == ("0", "0"),
                f"the kernel spills: {line.strip()}")
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

    # the main path: launch counts from here to the end of phase 5
    dfs_chunk.launches = 0
    t0 = time.perf_counter()
    phase_checker(spec, corpus, tag)
    phase_property(spec, tag)
    launches = dfs_chunk.launches
    print(f"{tag} main path: {launches} dfs_chunk launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(launches > 0, "the main path launched no dfs_chunk kernel")

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
    print(f"{tag} total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
