"""Command line: ``python -m qsm_tpu_torch run|bench``.

Backends: ``gpu`` is :class:`~qsm_tpu_torch.ops.gpu_backend.TorchGPU`
(the ``dfs_chunk`` kernel), ``stepper`` is
:class:`~qsm_tpu_torch.ops.stepper.TorchStepper` (the lane-compacting
``stepper_chunk`` / ``compact_carry`` kernels, and ``stepper_sweep`` for a
spec too large for a table; the counterpart of the reference CLI's
``--backend tpu``), ``--device cpu`` runs either one's
plain versions instead; ``cpu`` is the memoised host oracle.
"""

from __future__ import annotations

import argparse
import json
import time

from ..core.property import PropertyConfig, prop_concurrent
from ..models.registry import MODELS, make
from ..ops.wing_gong_cpu import WingGongCPU

BACKENDS = ("gpu", "stepper", "cpu")


def make_backend(name: str, spec, device=None):
    if name == "gpu":
        from ..ops.gpu_backend import TorchGPU

        return TorchGPU(spec, device=device)
    if name == "stepper":
        from ..ops.stepper import TorchStepper

        return TorchStepper(spec, device=device)
    if name == "cpu":
        return WingGongCPU(memo=True)
    raise SystemExit(f"unknown backend {name!r}")


def format_history(spec, history) -> str:
    """One row per op: pid, command(arg) -> resp, [invoke, response]."""
    if not history.ops:
        return "  (empty history)"
    rows = []
    for o in history.ops:
        resp = "pending" if o.is_pending else str(o.resp)
        ret = "-" if o.is_pending else str(o.response_time)
        rows.append(f"  pid {o.pid}  {spec.CMDS[o.cmd].name}({o.arg}) -> "
                    f"{resp}  [{o.invoke_time}, {ret}]")
    return "\n".join(rows)


def _add_common(p: argparse.ArgumentParser, backend_default: str) -> None:
    p.add_argument("--model", default="cas", choices=sorted(MODELS))
    p.add_argument("--pids", type=int, default=None)
    p.add_argument("--ops", type=int, default=None)
    p.add_argument("--backend", default=backend_default, choices=BACKENDS,
                   help="gpu: the dfs_chunk kernel (scalar specs, <= 32 "
                        "ops); stepper: the lane-compacting stepper, the "
                        "counterpart of the reference's --backend tpu; "
                        "cpu: the host memo oracle")
    p.add_argument("--device", default=None,
                   help="torch device of the gpu and stepper backends "
                        "(default cuda; cpu runs the kernels' plain "
                        "versions)")


def cmd_run(args) -> int:
    entry = MODELS[args.model]
    spec, sut = make(args.model, args.impl)
    cfg = PropertyConfig(n_trials=args.trials,
                         n_pids=args.pids or entry.default_pids,
                         max_ops=args.ops or entry.default_ops,
                         seed=args.seed,
                         schedules_per_program=args.schedules,
                         trial_batch=args.trial_batch)
    t0 = time.perf_counter()
    backend = make_backend(args.backend, spec, args.device)
    oracle = backend if args.backend == "cpu" else None
    res = prop_concurrent(spec, sut, cfg, backend=backend, oracle=oracle)
    dt = time.perf_counter() - t0
    if res.ok:
        print(f"OK: {args.model}/{args.impl} passed {res.trials_run} trials "
              f"({res.histories_checked} histories, {dt:.1f}s)")
        if res.undecided:
            print(f"WARNING: {res.undecided} histories undecided")
            return 2
        return 0
    cx = res.counterexample
    print(f"FAIL: {args.model}/{args.impl} — linearizability violation")
    print(f"counterexample after trial {cx.trial} (seed {cx.trial_seed!r}, "
          f"{cx.shrink_steps} shrink steps, {len(cx.program)} ops):")
    print(format_history(spec, cx.history))
    return 1


def cmd_bench(args) -> int:
    from .corpus import build_corpus

    entry = MODELS[args.model]
    spec = entry.make_spec()
    hists = build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]),
        n=args.corpus, n_pids=args.pids or entry.default_pids,
        max_ops=args.ops or entry.default_ops, seed_prefix="bench")
    backend = make_backend(args.backend, spec, args.device)
    backend.check_histories(spec, hists)  # warm-up (kernel build)
    t0 = time.perf_counter()
    v = backend.check_histories(spec, hists)
    dt = time.perf_counter() - t0
    device = str(getattr(backend, "device", "host"))
    if device.startswith("cuda"):
        import torch

        device = torch.cuda.get_device_name(backend.device)
    print(json.dumps({
        "model": args.model, "backend": args.backend, "device": device,
        "histories": len(hists), "seconds": round(dt, 3),
        "histories_per_sec": round(len(hists) / dt, 1),
        "undecided": int((v == 2).sum())}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="qsm_tpu_torch",
        description="state-machine property testing and linearizability "
                    "checking on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run prop_concurrent on a model/impl")
    _add_common(p, "gpu")
    p.add_argument("--impl", default="racy")
    p.add_argument("--trials", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--schedules", type=int, default=4,
                   help="seeded schedules per generated program")
    p.add_argument("--trial-batch", type=int, default=1,
                   help="trials decided per backend batch (verdicts are "
                        "identical at any value)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="checker throughput on one model")
    _add_common(p, "cpu")
    p.add_argument("--corpus", type=int, default=256)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)
