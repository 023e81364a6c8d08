"""The property runs of ``chip_smoke.py``'s phases 5 and 8, timed in turns
between two checkouts of ``qsm_tpu_torch`` on one card.

Phase 5 runs ``prop_concurrent`` on the CAS headline (8 pids x 32 ops)
through ``TorchGPU``, phase 8 on the queue headline (8 x 48) through
``TorchStepper``; each racy (convicted and shrunk) and atomic (passed),
100 trials, seed 0, a fresh backend a run.  Each turn is one process whose
``qsm_tpu_torch`` is one checkout's; ``--pairs`` pairs of turns alternate
which side runs first (other, this, this, other, ...).  A turn builds its
kernels, runs each case once to warm up, then times ``--reps`` runs of
each, host clock to the card's completion.

    python3 tools/torch_property_turns.py --other DIR [--reps 5] [--pairs 2]

prints the card's name and power limit, one JSON line a turn and a summary
line: each case's median by checkout, the pairs this checkout's turn won
(a lower median), and the other's own spread (the distance between the
quartiles of its turns' medians).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CASES = ("cas racy", "cas atomic", "queue racy", "queue atomic")


def run_turn(reps: int) -> dict:
    """One turn, in this process: the cases of phases 5 and 8 on the
    ``qsm_tpu_torch`` that ``sys.path`` finds first."""
    import torch

    import qsm_tpu_torch
    from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
    from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
    from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                            RacyTwoPhaseQueueSUT)
    from qsm_tpu_torch.ops import kernels
    from qsm_tpu_torch.ops.gpu_backend import TorchGPU
    from qsm_tpu_torch.ops.stepper import TorchStepper

    kernels.build_all()
    cas, queue = CasSpec(), QueueSpec()
    cases = {
        "cas racy": (cas, RacyCasSUT, TorchGPU, 8, 32, False),
        "cas atomic": (cas, AtomicCasSUT, TorchGPU, 8, 32, True),
        "queue racy": (queue, RacyTwoPhaseQueueSUT, TorchStepper, 8, 48,
                       False),
        "queue atomic": (queue, AtomicQueueSUT, TorchStepper, 8, 48, True),
    }
    out = {"package": str(Path(qsm_tpu_torch.__file__).parent)}
    for name in CASES:
        spec, sut_cls, engine, pids, ops, want_ok = cases[name]
        times = []
        for i in range(reps + 1):
            cfg = PropertyConfig(n_trials=100, n_pids=pids, max_ops=ops,
                                 seed=0)
            backend = engine(spec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = prop_concurrent(spec, sut_cls(spec), cfg, backend=backend)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if res.ok != want_ok or res.undecided:
                raise RuntimeError(f"{name}: ok={res.ok} undecided="
                                   f"{res.undecided}")
            if i:  # the first run warms up
                times.append(dt)
        out[name] = times
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="the root of the other checkout")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--turn", action="store_true",
                    help="run one turn in this process and print its JSON")
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(run_turn(args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_property_turns: no CUDA device", file=sys.stderr)
        return 2
    other = args.other.resolve()
    sys.path.insert(0, str(HERE))
    from qsm_tpu_torch.ops import kernels

    # the kernels' libraries are named by their sources' hash: where the
    # sources agree, the other checkout reuses this one's builds
    kernels.build_all()
    shutil.copytree(kernels.BUILD_DIR, other / "build" / "qsm_tpu_torch",
                    dirs_exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    got = {"other": [], "this": []}
    order = [w for k in range(args.pairs)
             for w in (("other", "this") if k % 2 == 0 else ("this", "other"))]
    for who in order:
        root = other if who == "other" else HERE
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--turn",
             "--reps", str(args.reps)],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": who, **turn}), flush=True)
        got[who].append(turn)
    def med(turn, case):
        return statistics.median(turn[case])

    def spread(xs):
        if len(xs) < 2:
            return 0.0
        q = statistics.quantiles(xs, n=4)
        return q[2] - q[0]

    print(json.dumps({
        "median_s": {who: {c: statistics.median(x for t in turns
                                                for x in t[c])
                           for c in CASES}
                     for who, turns in got.items()},
        "pairs_won_by_this": {c: sum(med(t, c) < med(o, c) for t, o in
                                     zip(got["this"], got["other"]))
                              for c in CASES},
        "pairs": args.pairs,
        "other_spread_s": {c: spread([med(o, c) for o in got["other"]])
                           for c in CASES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
