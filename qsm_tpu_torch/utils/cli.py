"""Command line: ``python -m qsm_tpu_torch run|bench|stats``.

Device backends (``--device cpu`` runs their kernels' plain versions):

* ``gpu``: :class:`~qsm_tpu_torch.ops.gpu_backend.TorchGPU` (the
  ``dfs_chunk`` kernel);
* ``stepper``: :class:`~qsm_tpu_torch.ops.stepper.TorchStepper` (the
  lane-compacting ``stepper_chunk`` / ``compact_carry`` kernels, and
  ``stepper_sweep`` for a spec too large for a table; the counterpart of
  the reference CLI's ``--backend tpu``);
* ``pcomp-stepper``: per-key decomposition with ``TorchStepper`` deciding
  the sub-histories (the reference's ``pcomp-tpu``);
* ``hybrid-stepper``: ``TorchStepper`` under a 2000-iteration budget, the
  rest on the host checker (the reference's ``hybrid-tpu``);
* ``segdc-stepper``: quiescent-cut segmentation, the final segments of a
  batch decided by ``TorchStepper`` from every frontier state in one call
  (the reference's ``segdc-tpu``);
* ``rootsplit-stepper``: ``TorchStepper``, its undecided histories split
  at the first choice point and decided again as children (the
  reference's ``rootsplit-tpu``);
* ``auto-stepper``: per-history routing between ``TorchStepper`` and
  ``segdc-stepper``, per key first for a projected spec (the reference's
  ``auto-tpu``).

Host backends: ``auto`` (the native C++ checker when it builds, else the
memoised oracle: the property layer's resolving oracle), ``cpu`` (the
memoised oracle), ``cpp`` (the native checker), ``pcomp`` and
``pcomp-cpp`` (per-key decomposition over the memoised oracle or the
native checker), ``segdc`` and ``segdc-cpp`` (segmentation over the
memoised oracle or the native checker), ``rootsplit`` (root splitting
over the memoised oracle).

``stats`` prints one JSON document: a backend's search-cost record on one
corpus, the corpus profile and the plan ``plan_search`` picks for it;
``--planned`` runs ``build_backend(spec, plan_search(spec, profile))``,
the port's plan, on the card.
"""

from __future__ import annotations

import argparse
import json
import time

from ..core.property import PropertyConfig, prop_concurrent
from ..models.registry import MODELS, make
from ..ops.wing_gong_cpu import WingGongCPU

BACKENDS = ("auto", "gpu", "stepper", "pcomp-stepper", "hybrid-stepper",
            "segdc-stepper", "rootsplit-stepper", "auto-stepper", "cpu",
            "cpp", "pcomp", "pcomp-cpp", "segdc", "segdc-cpp", "rootsplit")
# host backends that are the resolving oracle themselves: the property
# layer need not search again what they left undecided
_ORACLES = ("auto", "cpu", "cpp")


def make_backend(name: str, spec, device=None):
    from ..ops.pcomp import NotDecomposableError

    try:
        return _make_backend(name, spec, device)
    except NotDecomposableError as e:
        # exactly this misconfiguration exits cleanly; other errors of a
        # backend's construction still raise
        raise SystemExit(str(e)) from e


def _native_oracle_factory(fallback: str):
    from ..native import CppOracle, native_available, native_error

    if not native_available():
        raise SystemExit(f"native backend unavailable: {native_error()}\n"
                         f"use --backend {fallback}")
    return CppOracle


def _make_backend(name: str, spec, device):
    if name == "auto":
        from ..core.property import _default_oracle

        return _default_oracle(spec)
    if name == "gpu":
        from ..ops.gpu_backend import TorchGPU

        return TorchGPU(spec, device=device)
    if name == "stepper":
        from ..ops.stepper import TorchStepper

        return TorchStepper(spec, device=device)
    if name == "pcomp-stepper":
        from ..ops.pcomp import PComp
        from ..ops.stepper import TorchStepper

        return PComp(spec, lambda p: TorchStepper(p, device=device))
    if name == "hybrid-stepper":
        from ..ops.hybrid import HybridDevice

        return HybridDevice(spec, device=device)
    if name == "segdc-stepper":
        from ..ops.segdc import SegDC
        from ..ops.stepper import TorchStepper

        # middles on SegDC's default enumerator (native when it builds),
        # finals batched on the device through init_states
        return SegDC(spec, lambda s: TorchStepper(s, device=device))
    if name == "rootsplit-stepper":
        from ..ops.rootsplit import RootSplit
        from ..ops.stepper import TorchStepper

        return RootSplit(spec, TorchStepper(spec, device=device))
    if name == "auto-stepper":
        from ..ops.router import AutoDevice

        return AutoDevice(spec, device=device)
    if name == "cpu":
        return WingGongCPU(memo=True)
    if name == "cpp":
        return _native_oracle_factory("cpu")(spec)
    if name == "pcomp":
        from ..ops.pcomp import PComp

        return PComp(spec)
    if name == "pcomp-cpp":
        from ..ops.pcomp import PComp

        return PComp(spec, _native_oracle_factory("pcomp"))
    if name == "segdc":
        from ..ops.segdc import SegDC

        return SegDC(spec)
    if name == "segdc-cpp":
        from ..ops.segdc import SegDC

        cpp = _native_oracle_factory("segdc")(spec)
        return SegDC(spec, make_inner=lambda s: cpp, oracle=cpp)
    if name == "rootsplit":
        from ..ops.rootsplit import RootSplit

        return RootSplit(spec)
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
                        "pcomp-stepper: per-key decomposition over the "
                        "stepper; hybrid-stepper: the stepper under a "
                        "tight budget, the rest on the host checker; "
                        "auto: the native checker when it builds, else "
                        "cpu, the host memo oracle; cpp: the native "
                        "checker; pcomp, pcomp-cpp: per-key decomposition "
                        "over the memo oracle or the native checker; "
                        "segdc[-cpp,-stepper]: quiescent-cut segmentation; "
                        "rootsplit[-stepper]: root splitting; "
                        "auto-stepper: per-history routing between the "
                        "stepper and segdc-stepper")
    p.add_argument("--device", default=None,
                   help="torch device of the device backends (default "
                        "cuda; cpu runs the kernels' plain versions)")


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
    oracle = backend if args.backend in _ORACLES else None
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


def _device_name(backend) -> str:
    """The card a backend's device search runs on, or "host".  A
    combinator keeps its engine as ``inner`` (per-key decomposition,
    segmentation, root splitting), ``device`` (the hybrid plan) or
    ``plain`` / ``pcomp`` (the router), possibly nested."""
    import torch

    todo, seen = [backend], set()
    while todo:
        b = todo.pop(0)
        if b is None or id(b) in seen:
            continue
        seen.add(id(b))
        dev = getattr(b, "device", None)
        if isinstance(dev, torch.device):
            return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else str(dev))
        todo += [getattr(b, a, None)
                 for a in ("inner", "device", "plain", "pcomp")]
    return "host"


def cmd_bench(args) -> int:
    from .corpus import build_corpus

    entry = MODELS[args.model]
    spec = entry.make_spec()
    hists = build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]),
        n=args.corpus, n_pids=args.pids or entry.default_pids,
        max_ops=args.ops or entry.default_ops, seed_prefix="bench")
    backend = make_backend(args.backend, spec, args.device)
    device = _device_name(backend)
    backend.check_histories(spec, hists)  # warm-up (kernel build)
    t0 = time.perf_counter()
    v = backend.check_histories(spec, hists)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "model": args.model, "backend": args.backend, "device": device,
        "histories": len(hists), "seconds": round(dt, 3),
        "histories_per_sec": round(len(hists) / dt, 1),
        "undecided": int((v == 2).sum())}))
    return 0


def cmd_stats(args) -> int:
    """Search-cost accounting of one backend on one corpus as ONE JSON
    document (the JAX package's ``stats`` without ``--serve``):
    the backend's ``SearchStats``, the corpus profile and the plan
    ``plan_search`` picks for it.  ``--planned`` runs the planned checker
    (``build_backend``; on the card unless ``--device cpu``) instead of
    ``--backend``."""
    import numpy as np

    from ..resilience.failover import collect_resilience
    from ..search import collect_search_stats, plan_search, profile_corpus
    from .corpus import build_corpus

    entry = MODELS[args.model]
    spec = entry.make_spec()
    hists = build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]),
        n=args.corpus, n_pids=args.pids or entry.default_pids,
        max_ops=args.ops or entry.default_ops, seed_prefix="stats")
    # with the spec the profile measures the per-key shape too, and the
    # printed plan says whether (and why) it splits
    profile = profile_corpus(hists, spec)
    plan = plan_search(spec, profile,
                       platform=None if args.planned else "cpu")
    if args.planned:
        from ..search.planner import build_backend

        backend = build_backend(spec, plan, device=args.device)
        bname = f"planned({plan.name})"
    else:
        backend = make_backend(args.backend, spec, args.device)
        bname = args.backend
    t0 = time.perf_counter()
    v = backend.check_histories(spec, hists)
    dt = time.perf_counter() - t0
    st = collect_search_stats(backend)
    print(json.dumps({
        "model": args.model, "backend": bname,
        "device": _device_name(backend),
        "histories": len(hists), "seconds": round(dt, 3),
        "undecided": int((np.asarray(v) == 2).sum()),
        "resilience": collect_resilience(backend),
        "profile": {
            "max_ops": profile.max_ops,
            "mean_ops": round(profile.mean_ops, 1),
            "pending_fraction": round(profile.pending_fraction, 3),
            "mean_segments": round(profile.mean_segments, 2),
        },
        "plan_for_corpus": plan.describe(),
        "search_stats": st.to_dict() if st is not None else None,
    }))
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

    p = sub.add_parser(
        "stats",
        help="search-cost accounting (SearchStats) of one backend on one "
             "corpus, with the corpus profile and the planner's verdict")
    _add_common(p, "cpu")
    p.add_argument("--planned", action="store_true",
                   help="run the plan_search-built checker (the port's "
                        "plan: TorchStepper, ordering, SegDC / PComp when "
                        "the profile says so) instead of --backend")
    p.add_argument("--corpus", type=int, default=64)
    p.set_defaults(fn=cmd_stats)

    args = ap.parse_args(argv)
    return args.fn(args)
