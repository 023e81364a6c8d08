"""Command line: ``python -m qsm_tpu_torch
run|replay|check|shrink|list|coverage|explore|fuzz|lint|bench|stats|trace|
ingest|monitor|serve|submit|health|fleet|soak``.

* ``run``: ``prop_concurrent`` on a registry model (fault flags, the TCP
  transport, worker processes, a JSONL log and a regression file;
  ``--failover`` wraps the backend in ``FailoverBackend``, ``--minimize``
  minimises the failing history with the history shrinker);
* ``replay``: a failure again, from its seed key or a regression file
  (an exploration finding by its delivery-choice script);
* ``check``: an external trace file, one history or a batch;
* ``shrink``: one failing trace minimised in process to a 1-minimal
  history, with its certificate, its frontier batches decided by the
  planned checker on the card (one JSON line; exit 0 minimised, 1
  incomplete, 2 not a violation, 3 error);
* ``list``: models, backends and the native oracle's status;
* ``coverage``: schedule coverage of seeded runs (``--exact``: against
  the enumerated tree);
* ``explore``: every interleaving of small programs, the union of their
  distinct histories decided in one backend batch;
* ``fuzz``: the checkers against the exact oracle on random specs;
* ``lint``: the port's static analyzer (``analysis/``; exit 0 clean, 1
  findings, 2 usage or no card without ``--device cpu``, 3 analyzer
  trouble);
* ``trace``: one request's causal tree from a span log (``--log``);
* ``ingest``: a Jepsen- or porcupine-style event log decoded into the
  ``check`` trace format (``--emit``: the canonical log text again;
  ``--check``: decided by the planned checker on the card);
* ``monitor``: an event log tailed into a live in-process monitor
  session (its window re-checks batched on the card); a flip prints the
  minimised repro with its certificate;
* ``serve``: the check server (``serve/``) on the card, or with
  ``--device cpu`` the reference's host ladder; ``submit``, ``health``
  and ``stats --serve`` talk to it, as do ``shrink --addr``, ``trace
  --addr``, ``monitor --addr``, ``ingest --submit`` and ``fuzz --addr``
  (the closed loop of ``gen/fleet.py``); ``serve --peers`` gossips a
  node's bank to its peers and ``--lease-host`` serves the routers' HA
  lease;
* ``fleet``: N check servers behind a ``FleetRouter`` (``fleet/``): the
  spawned nodes (``--nodes N``) on the card unless ``--device cpu``, the
  router's last rungs too; ``stats --serve ROUTER --fleet`` renders its
  per-node view;
* ``soak``: the chaos soak of ``gen/soak.py`` against a spawned fleet.

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

The device backends of ``run``, ``check``, ``shrink``, ``explore``,
``fuzz``, ``ingest --check`` and ``monitor`` run on the card unless
``--device cpu``.  ``stats`` prints one
JSON document: a backend's search-cost record on one corpus, the corpus
profile and the plan ``plan_search`` picks for it;
``--planned`` runs ``build_backend(spec, plan_search(spec, profile))``,
the port's plan, on the card; ``--failover`` wraps the backend in
``FailoverBackend`` and its ``resilience`` block reports the wrap's
counters.  The fault plane (``QSM_TPU_FAULTS``, ``resilience/faults.py``)
acts on every device backend's dispatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..core.property import PropertyConfig, prop_concurrent, replay
from ..models.registry import MODELS, SutFactory, make
from ..ops.backend import VERDICT_NAMES
from ..ops.wing_gong_cpu import WingGongCPU
from ..sched.runner import run_concurrent
from ..sched.scheduler import FaultPlan
from .report import (JsonlLogger, format_counterexample, format_history,
                     load_regression, save_regression)
from .stats import schedule_coverage

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
    _add_device(p)


def _add_fault_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--p-drop", type=float, default=0.0)
    p.add_argument("--p-duplicate", type=float, default=0.0)
    p.add_argument("--p-delay", type=float, default=0.0)
    p.add_argument("--delay-steps", type=int, default=3,
                   help="delivery choices a delayed message is held for")
    p.add_argument("--crash-at", action="append", default=[],
                   metavar="NAME:N",
                   help="crash process NAME after N delivery choices "
                        "(repeatable; e.g. --crash-at primary:6)")
    p.add_argument("--partition", action="append", default=[],
                   metavar="A,B,...",
                   help="network partition: messages crossing the named "
                        "group's boundary are dropped (repeatable, one "
                        "group a flag; deterministic, so it composes "
                        "with explore)")


def _faults_from_args(args):
    crash_at = {}
    for spec in args.crash_at:
        name, _, n = spec.rpartition(":")
        if not name or not n.isdigit():
            raise SystemExit(f"--crash-at wants NAME:N, got {spec!r}")
        crash_at[name] = int(n)
    partitions = []
    for group in getattr(args, "partition", []):
        names = {x.strip() for x in group.split(",") if x.strip()}
        if not names:
            raise SystemExit(f"--partition wants A,B,..., got {group!r}")
        partitions.append(names)
    if not (args.p_drop or args.p_duplicate or args.p_delay or crash_at
            or partitions):
        return None
    return FaultPlan(p_drop=args.p_drop, p_duplicate=args.p_duplicate,
                     p_delay=args.p_delay, delay_steps=args.delay_steps,
                     crash_at=crash_at, partitions=partitions)


def _fault_flags(args) -> str:
    """Every fault flag of ``args`` as command-line text: a replay hint
    without one of them replays another fault plan."""
    flags = (f" --p-drop {args.p_drop} --p-duplicate {args.p_duplicate}"
             f" --p-delay {args.p_delay} --delay-steps {args.delay_steps}")
    flags += "".join(f" --crash-at {c}" for c in args.crash_at)
    flags += "".join(f" --partition {g}" for g in args.partition)
    return flags


def cmd_run(args) -> int:
    entry = MODELS[args.model]
    spec, sut = make(args.model, args.impl)
    faults = _faults_from_args(args)
    cfg = PropertyConfig(n_trials=args.trials,
                         n_pids=args.pids or entry.default_pids,
                         max_ops=args.ops or entry.default_ops,
                         seed=args.seed, faults=faults,
                         schedules_per_program=args.schedules,
                         trial_batch=args.trial_batch,
                         transport=args.transport,
                         executor_workers=args.workers,
                         minimize_history=args.minimize)
    log = JsonlLogger(path=args.log) if args.log else JsonlLogger()
    try:
        t0 = time.perf_counter()
        backend = make_backend(args.backend, spec, args.device)
        if args.failover:
            from ..resilience.failover import FailoverBackend

            backend = FailoverBackend(spec, backend)
        # a host backend that is the resolving oracle is passed as the
        # oracle too, so that the property layer does not search again
        # what it left undecided; --failover wraps it, and so forfeits
        # that short cut (the wrap changes nothing for a host backend)
        oracle = (backend if args.backend in _ORACLES and not args.failover
                  else None)
        res = prop_concurrent(
            spec, sut, cfg, backend=backend, oracle=oracle,
            sut_factory=(SutFactory(args.model, args.impl)
                         if args.workers > 0 else None))
        dt = time.perf_counter() - t0
        log.emit("result", model=args.model, impl=args.impl, ok=res.ok,
                 trials=res.trials_run, histories=res.histories_checked,
                 undecided=res.undecided, seconds=round(dt, 3),
                 schedules=res.schedules_run,
                 schedule_diversity=round(res.schedule_diversity, 3),
                 timings={key: round(v, 3)
                          for key, v in sorted(res.timings.items())})
    finally:
        log.close()
    if res.ok:
        print(f"OK: {args.model}/{args.impl} passed {res.trials_run} trials "
              f"({res.histories_checked} histories, {dt:.1f}s)")
        if res.undecided:
            print(f"WARNING: {res.undecided} histories undecided")
            return 2
        return 0
    cx = res.counterexample
    print(f"FAIL: {args.model}/{args.impl} — linearizability violation")
    print(format_counterexample(spec, cx))
    if cx.minimized_history is not None:
        # the history shrinker's 1-minimal form: shorter to read; the
        # (program, schedule) counterexample above is what replays
        print(f"history-minimized to {len(cx.minimized_history)} op(s) "
              "(still a VIOLATION, not replayable):")
        print(format_history(spec, cx.minimized_history))
    hint = _fault_flags(args) if faults is not None else ""
    print(f"replay: python -m qsm_tpu_torch replay --model {args.model} "
          f"--impl {args.impl} --trial-seed '{cx.trial_seed}' "
          f"--pids {cfg.n_pids} --ops {cfg.max_ops} "
          f"--trials {cfg.n_trials}{hint}")
    if args.save_regression:
        save_regression(args.save_regression, args.model, args.impl, spec,
                        cfg, cx)
        print(f"regression saved to {args.save_regression}")
    return 1


def cmd_replay(args) -> int:
    if args.regression:
        model, impl, seed_key, prog, hist, faults, spec_kwargs = \
            load_regression(args.regression)
        spec, sut = make(model, impl, spec_kwargs)
        print(f"replaying {model}/{impl} trial seed {seed_key!r}")
        # an exploration finding replays by its delivery-choice script
        from ..sched.systematic import parse_schedule_key

        info: dict = {}
        h = run_concurrent(sut, prog, seed=seed_key, faults=faults,
                           choices=parse_schedule_key(seed_key),
                           sched_info=info)
        same = h.fingerprint() == hist.fingerprint()
        print(f"history reproduced bit-identically: {same}")
        if info.get("choice_clamped"):
            print("WARNING: schedule script no longer matches the "
                  "interleaving tree (a scripted choice exceeded the live "
                  "branching factor and was clamped) — the model or fault "
                  "plan has drifted since this regression was captured")
    else:
        if not (args.model and args.trial_seed):
            raise SystemExit(
                "replay needs either --regression FILE or both "
                "--model and --trial-seed")
        spec, sut = make(args.model, args.impl)
        entry = MODELS[args.model]
        cfg = PropertyConfig(n_trials=args.trials,
                             n_pids=args.pids or entry.default_pids,
                             max_ops=args.ops or entry.default_ops,
                             faults=_faults_from_args(args))
        h = replay(spec, sut, args.trial_seed, cfg)
    w = None
    if args.witness:
        # one search gives both the verdict and the witness
        verdict, w = WingGongCPU().check_witness(spec, h)
        v = int(verdict)
    else:
        v = int(WingGongCPU().check_histories(spec, [h])[0])
    print(format_history(spec, h))
    print(f"verdict: {VERDICT_NAMES[v]}")
    if w is not None:
        from ..ops.backend import verify_witness

        steps = " -> ".join(
            f"{spec.CMDS[h.ops[j].cmd].name}[op{j}]" for j, _ in w)
        print(f"witness: {steps}")
        print(f"witness verifies (search-free replay): "
              f"{verify_witness(spec, h, w)}")
    return 0 if v == 1 else 1


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


def _spawn_node_cmd(i: int, replog_root: str, args) -> list:
    """The ``serve`` command line of spawned fleet node ``i``: a
    ``python -m qsm_tpu_torch serve`` process with its own CUDA context
    and planned checker, ``--device`` passed through (``cpu`` gives host
    nodes; nothing else does, and nothing hides the card)."""
    import os

    cmd = [sys.executable, "-m", "qsm_tpu_torch", "serve",
           "--port", "0", "--node-id", f"n{i}",
           "--replog-dir", os.path.join(replog_root, f"n{i}")]
    if args.device is not None:
        cmd += ["--device", str(args.device)]
    if args.session_root:
        cmd += ["--session-dir", os.path.join(args.session_root, f"n{i}"),
                "--max-sessions", str(args.max_sessions)]
    if args.devq_root:
        cmd += ["--devq-dir", os.path.join(args.devq_root, f"n{i}")]
    if args.workers:
        cmd += ["--workers", str(args.workers)]
    if args.warm:
        cmd += ["--warm", args.warm]
    if args.collect_dir:
        # fleet-wide collection needs node span logs to scrape: each
        # spawned node traces beside its replog (fronted --addrs nodes
        # bring their own --trace-log)
        cmd += ["--trace-log",
                os.path.join(replog_root, f"n{i}_trace.jsonl")]
    return cmd


def cmd_fleet(args) -> int:
    """Run a fleet (``fleet/``): N CheckServer node processes behind a
    :class:`FleetRouter` that speaks the unchanged client protocol —
    consistent-hash routing by the verdict-cache identity, node-loss
    re-dispatch, segmented replicated verdict logs with anti-entropy
    catch-up.  ``--addrs`` fronts nodes you started yourself; otherwise
    ``--nodes N`` local node processes are spawned (``python -m
    qsm_tpu_torch serve``, each on the card unless ``--device cpu``) and
    torn down with the router.  A node that cannot start prints no
    banner and the fleet exits: it never carries on with fewer nodes or
    on the host.  The router's own last rungs run on the card unless
    ``--device cpu``.  Prints ONE JSON line with the router address +
    node map, then serves until a ``shutdown`` request (or SIGINT)."""
    import subprocess
    import tempfile

    from ..fleet.router import FleetRouter

    if args.workers and (args.device is None or str(args.device) != "cpu"):
        # pool workers are host processes (the serve rule)
        raise SystemExit("--workers needs --device cpu (pool workers run "
                         "the host cpp->memo ladder; a card's engine "
                         "lives in the node process)")
    nodes: list = []
    procs: list = []
    if args.addrs:
        for i, addr in enumerate(a.strip() for a in args.addrs.split(",")
                                 if a.strip()):
            nodes.append((f"n{i}", addr))
    else:
        replog_root = args.replog_root or tempfile.mkdtemp(
            prefix="qsm_fleet_replog_")
        for i in range(args.nodes):
            procs.append(subprocess.Popen(
                _spawn_node_cmd(i, replog_root, args),
                stdout=subprocess.PIPE, text=True))
        for i, proc in enumerate(procs):
            line = proc.stdout.readline()  # the serve banner line
            try:
                nodes.append((f"n{i}", json.loads(line)["serving"]))
            except (ValueError, KeyError):
                for q in procs:
                    q.terminate()
                    try:
                        q.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        q.kill()
                raise SystemExit(
                    f"node {i} failed to start (no serve banner)")
    if args.gossip_s and args.gossip_s > 0:
        # wire node-to-node gossip: each node gets every OTHER node as
        # a peer (the gossip.peers op — addresses are only known now).
        # Replication then no longer depends on any router living.
        from ..serve.protocol import LineChannel, connect, send_doc

        for nid, addr in nodes:
            peers = [[pid, paddr] for pid, paddr in nodes
                     if pid != nid]
            try:
                sock = connect(addr, timeout_s=5.0)
                try:
                    send_doc(sock, {"op": "gossip.peers",
                                    "peers": peers,
                                    "interval_s": args.gossip_s})
                    LineChannel(sock).read_line(timeout_s=5.0)
                finally:
                    sock.close()
            except (OSError, ValueError):
                # a node without a replog (--addrs fronting a plain
                # server) just doesn't gossip; the router sweep still
                # covers it
                pass
    router = FleetRouter(
        nodes, host=args.host, port=args.port, unix_path=args.unix,
        queue_depth=args.queue_depth,
        quarantine_after=args.quarantine_after,
        heartbeat_s=args.heartbeat_s,
        anti_entropy_s=args.anti_entropy_s,
        node_id=args.router_id,
        session_dir=args.session_journal,
        lease_path=args.lease_path,
        lease_ttl_s=args.lease_ttl_s,
        trace_log=args.trace_log, flight_dir=args.flight_dir,
        metrics_port=args.metrics_port,
        collect_dir=args.collect_dir, collect_s=args.collect_s,
        slo=args.slo, slo_window_s=args.slo_window,
        device=args.device)
    router.start()
    try:
        print(json.dumps({"fleet": router.address,
                          "router_id": args.router_id,
                          "role": router.ha_role,
                          "term": router.term,
                          "lease": args.lease_path,
                          "nodes": dict(nodes),
                          "spawned": len(procs),
                          "device": ("cpu" if router.on_cpu else
                                     str(args.device or "cuda")),
                          "anti_entropy_s": args.anti_entropy_s,
                          "gossip_s": args.gossip_s,
                          "trace_log": args.trace_log,
                          "collect_dir": args.collect_dir,
                          "slo": args.slo,
                          "flight_dir": args.flight_dir}), flush=True)
        router.wait()
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
        for proc in procs:
            # deterministic node teardown: terminate → bounded wait →
            # kill escalation (the pool's reap discipline, fleet level)
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5.0)
            except OSError:
                pass
    return 0


def _render_stats_fleet(doc: dict) -> str:
    """The ``stats --serve ROUTER --fleet`` view: the router's own
    counters (the active/standby lease line first — which brain is
    live and under which term) plus one row per node, with the device
    it decides on and the histories its engines searched — fleet health
    at a glance."""
    lines = [
        f"fleet router {doc.get('address', '?')}  uptime "
        f"{doc.get('uptime_s', 0)}s  requests {doc.get('requests', 0)} "
        f"histories {doc.get('histories', 0)}",
    ]
    lease = doc.get("lease") or {}
    if lease.get("enabled"):
        role = lease.get("role", "?")
        bits = [f"lease: {lease.get('holder', '?')} [{role.upper()}] "
                f"term {lease.get('term', 0)}  takeovers "
                f"{lease.get('takeovers', 0)}  ha_sheds "
                f"{lease.get('ha_sheds', 0)}"]
        if role == "active":
            bits.append(f"  expires_in {lease.get('expires_in_s', '?')}s")
        elif lease.get("active_holder"):
            bits.append(f"  active: {lease['active_holder']} term "
                        f"{lease.get('active_term', '?')}")
        lines.append("".join(bits))
    else:
        lines.append("lease: off (single router — no HA standby)")
    lines.append(
        f"node_faults {doc.get('node_faults', 0)}  redispatches "
        f"{doc.get('redispatches', 0)}  ladder_lanes "
        f"{doc.get('ladder_lanes', 0)}  node_sheds "
        f"{doc.get('node_sheds', 0)}  device_errors "
        f"{doc.get('device_errors', 0)}  ladder device "
        f"{doc.get('device', '?')}")
    ae = doc.get("anti_entropy") or {}
    lines.append(f"anti-entropy sweeps {ae.get('sweeps', 0)}  segments "
                 f"{ae.get('segments_shipped', 0)}  subsumed "
                 f"{ae.get('segments_subsumed', 0)}  rows "
                 f"{ae.get('rows_shipped', 0)}")
    fleet_nodes = doc.get("fleet_nodes") or {}
    for n in (doc.get("membership") or {}).get("nodes", []):
        nid = n.get("node")
        state = ("QUARANTINED" if n.get("quarantined")
                 else "up" if n.get("healthy") else "DOWN")
        ns = fleet_nodes.get(nid) or {}
        if "error" in ns:
            detail = f"unreachable ({ns['error']})"
        else:
            cache = ns.get("cache") or {}
            replog = cache.get("replog") or {}
            searched = sum(int(e.get("searched") or 0) for e in
                           (ns.get("engines") or {}).values())
            detail = (f"device {ns.get('device', '?')}  requests "
                      f"{ns.get('requests', 0)}  histories "
                      f"{ns.get('histories', 0)}  searched {searched}  "
                      f"device_errors {ns.get('device_errors', 0)}  bank "
                      f"{cache.get('entries', 0)} rows  segments "
                      f"{replog.get('sealed_segments', '-')}")
        lines.append(f"  {nid} [{state}] {n.get('address', '?')}  "
                     f"{detail}")
    return "\n".join(lines)


def cmd_soak(args) -> int:
    """The chaos soak (``gen/soak.py``): durable sessions held open
    through rolling node restarts, an active-router SIGKILL and one node
    leave/join, with every flip and close verdict re-proved by a fresh
    memo oracle.  Nodes and routers are spawned on the card unless
    ``--device cpu``.  Prints the gate report as one JSON line; exit 0
    only when ``gate_ok`` (zero wrong verdicts, zero lost flips, durable
    resumes banked, SLO health green)."""
    from ..gen.soak import soak_sessions

    rep = soak_sessions(
        sessions=args.sessions, ops_per_session=args.ops,
        model=args.model, seed=args.seed, workers=args.workers,
        max_sessions=args.max_sessions, lease_ttl_s=args.lease_ttl_s,
        fuzz_rounds=args.fuzz_rounds, run_dir=args.run_dir,
        faults=args.faults, log=lambda m: print(m, file=sys.stderr),
        device=args.device)
    print(json.dumps(rep))
    if not rep.get("gate_ok"):
        return 1
    return int(rep.get("exit_code", 0))


def cmd_serve(args) -> int:
    """Run the check server (``serve/``): warm engines, cross-request
    micro-batching, the verdict cache, bounded admission.  It serves on
    the card (the planned checker) unless ``--device cpu``, where
    ``--engine auto`` is the host ladder and ``planned`` the CPU plan;
    without a card and without ``--device cpu`` it raises
    ``BackendUnavailable``.  Prints ONE JSON line with the bound address,
    then serves until a ``shutdown`` request (or SIGINT)."""
    from ..serve.server import CheckServer

    peers = [a.strip() for a in (args.peers or "").split(",")
             if a.strip()]
    if peers and not args.replog_dir:
        raise SystemExit("--peers needs --replog-dir (gossip "
                         "replicates replog segments; a bankless node "
                         "has none to exchange)")
    warm = [m.strip() for m in args.warm.split(",")] if args.warm else []
    warm = [m for m in warm if m]
    unknown = sorted(set(warm) - set(MODELS))
    if unknown:
        # a typo'd --warm must fail loudly, not silently serve cold
        raise SystemExit(f"--warm: unknown models {unknown}; "
                         f"one of {sorted(MODELS)}")
    server = CheckServer(
        host=args.host, port=args.port, unix_path=args.unix,
        engine=args.engine, max_lanes=args.max_lanes,
        mesh_devices=args.mesh_devices,
        flush_s=args.flush_ms / 1000.0, queue_depth=args.queue_depth,
        cache_path=args.cache, cache_entries=args.cache_entries,
        workers=args.workers, quarantine_after=args.quarantine_after,
        pcomp=not args.no_pcomp,
        trace_log=args.trace_log, flight_dir=args.flight_dir,
        metrics_port=args.metrics_port,
        node_id=args.node_id, replog_dir=args.replog_dir,
        replog_seal_rows=args.replog_seal_rows,
        peers=peers or None, gossip_s=args.gossip_s,
        gossip_fanout=args.gossip_fanout,
        max_sessions=args.max_sessions,
        session_dir=args.session_dir,
        lease_path=args.lease_host,
        slo=args.slo, slo_window_s=args.slo_window,
        devq_dir=args.devq_dir, devq_cap=args.devq_cap,
        device=args.device)
    server.start()
    try:
        for model in warm:
            server.warm(model)
        print(json.dumps({"serving": server.address,
                          "engine": args.engine,
                          "node": args.node_id,
                          "replog": args.replog_dir,
                          "devq": args.devq_dir,
                          "peers": peers or None,
                          "workers": args.workers,
                          "max_lanes": server.batcher.max_lanes,
                          "mesh_devices": args.mesh_devices,
                          "flush_ms": args.flush_ms,
                          "queue_depth": args.queue_depth,
                          "cache": args.cache,
                          "trace_log": args.trace_log,
                          "flight_dir": args.flight_dir,
                          "metrics": (f"{args.host}:{server.metrics_port}"
                                      if server.metrics_port is not None
                                      else None)}), flush=True)
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_submit(args) -> int:
    """Submit a trace file (the ``check`` format: a ``history`` or
    ``histories`` rows array) to a running check server.  Exit 0 all
    linearizable, 1 some violation, 2 undecided, 3 shed or error."""
    from ..serve.client import CheckClient

    with open(args.trace) as f:
        doc = json.load(f)
    model = args.model or doc.get("model")
    if not model:
        raise SystemExit("trace has no 'model'; pass --model")
    rows = doc.get("histories")
    if rows is None:
        if "history" not in doc:
            raise SystemExit(
                "trace needs a 'history' (or 'histories') array of "
                "[pid, cmd, arg, resp, invoke_time, response_time] rows")
        rows = [doc["history"]]
    client = CheckClient(args.addr, timeout_s=args.timeout)
    try:
        res = client.check(model, rows,
                           spec_kwargs=doc.get("spec_kwargs") or None,
                           witness=args.witness,
                           deadline_s=args.deadline)
    finally:
        client.close()
    print(json.dumps(res))
    if not res.get("ok"):
        return 3
    if res.get("violations"):
        return 1
    return 2 if res.get("undecided") else 0


def cmd_health(args) -> int:
    """A running server's SLO health (the ``health`` op, ``obs/slo.py``).
    Exit 0 ok, 1 degraded, 2 breach, 3 unreachable or error."""
    from ..obs import HEALTH_EXIT_CODES, HEALTH_EXIT_UNREACHABLE
    from ..serve.client import CheckClient

    try:
        client = CheckClient(args.addr, timeout_s=args.timeout)
    except (OSError, ConnectionError) as e:
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: "
                                                f"{e}"}))
        return HEALTH_EXIT_UNREACHABLE
    try:
        res = client.health()
    except (OSError, ConnectionError) as e:
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: "
                                                f"{e}"}))
        return HEALTH_EXIT_UNREACHABLE
    finally:
        client.close()
    print(json.dumps(res))
    if not res.get("ok"):
        return HEALTH_EXIT_UNREACHABLE
    return HEALTH_EXIT_CODES.get(str(res.get("status")),
                                 HEALTH_EXIT_UNREACHABLE)


def _render_stats_watch(doc: dict) -> str:
    """One refresh frame of ``stats --serve ADDR --watch``: the capacity
    numbers an operator watches, from the server's ``stats`` verb."""
    adm = doc.get("admission") or {}
    bat = doc.get("batcher") or {}
    cache = doc.get("cache") or {}
    pool = doc.get("pool")
    pc = doc.get("pcomp") or {}
    sh = doc.get("shrink") or {}
    obs = doc.get("obs") or {}
    lines = [
        f"qsm_tpu_torch serve {doc.get('address', '?')}  "
        f"up {doc.get('uptime_s', 0):.0f}s  engine "
        f"{doc.get('engine_kind', '?')}  workers "
        f"{doc.get('workers', 0)}",
        f"  requests {doc.get('requests', 0)}  histories "
        f"{doc.get('histories', 0)}  serve_faults "
        f"{doc.get('serve_faults', 0)}  worker_faults "
        f"{doc.get('worker_faults', 0)}",
        f"  admission: in_flight {adm.get('in_flight', 0)}/"
        f"{adm.get('queue_depth', 0)} (peak "
        f"{adm.get('peak_in_flight', 0)})  shed queue="
        f"{adm.get('shed_queue', 0)} deadline="
        f"{adm.get('shed_deadline', 0)}",
        f"  batcher: batches {bat.get('batches', 0)}  lanes "
        f"{bat.get('lanes', 0)}  occupancy "
        f"{bat.get('mean_occupancy', 0.0)}",
        f"  cache: entries {cache.get('entries', 0)}  hit_rate "
        f"{cache.get('hit_rate', 0.0)}  bank_rows "
        f"{cache.get('bank_rows', 0)}",
        f"  pcomp: split {pc.get('split', 0)} -> "
        f"{pc.get('sub_lanes', 0)} sub-lanes ("
        f"{pc.get('sub_cache_hits', 0)} cached)  shrink: "
        f"{sh.get('requests', 0)} req / {sh.get('rounds', 0)} rounds",
    ]
    sess = doc.get("session")
    if sess:
        lines.append(
            f"  session: live {sess.get('sessions_live', 0)}  events "
            f"{sess.get('session_events', 0)}  advances "
            f"{sess.get('frontier_advances', 0)}  prefix_hits "
            f"{sess.get('prefix_hits', 0)}  flips "
            f"{sess.get('flips_pushed', 0)}")
    if pool:
        live = [w for w in pool.get("workers", []) if w.get("alive")]
        lines.append(
            f"  pool: {pool.get('live', 0)}/{pool.get('n_workers', 0)} "
            f"live  dispatches {pool.get('dispatches', 0)}  respawns "
            f"{pool.get('respawns', 0)}  quarantines "
            f"{pool.get('quarantines', 0)}  "
            + " ".join(f"w{w['wid']}:{w['dispatches']}" for w in live))
    tracing = obs.get("tracing") or {}
    flight = obs.get("flight") or {}
    lines.append(
        f"  obs: span_events {tracing.get('events', 0)}  flight_dumps "
        f"{flight.get('dumps', 0) if flight else 0}"
        + (f"  last_dump {flight.get('last_dump')}"
           if flight and flight.get("last_dump") else ""))
    return "\n".join(lines)


def _stats_serve(args) -> int:
    """``stats --serve ADDR``: a running server's aggregate stats as one
    JSON document, or with ``--watch`` a refreshing text view
    (``--watch-count N`` frames, then exit 0)."""
    from ..serve.client import CheckClient

    def fetch() -> dict:
        client = CheckClient(args.serve)
        try:
            return client.stats().get("stats", {})
        finally:
            client.close()

    if not args.watch:
        doc = fetch()
        if args.fleet:
            # the fleet view: a router's per-node health/traffic table
            # (a plain server answers too — it just has no node rows)
            print(_render_stats_fleet(doc))
        else:
            print(json.dumps(doc))
        return 0
    n = 0
    try:
        while True:
            frame = _render_stats_watch(fetch())
            # ANSI clear+home between frames; a pipe still gets
            # line-parseable frames
            sys.stdout.write("\x1b[2J\x1b[H" if n else "")
            print(frame, flush=True)
            n += 1
            if args.watch_count and n >= args.watch_count:
                return 0
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


def cmd_stats(args) -> int:
    """Search-cost accounting of one backend on one corpus as ONE JSON
    document (the JAX package's ``stats`` without ``--serve``):
    the backend's ``SearchStats``, the corpus profile and the plan
    ``plan_search`` picks for it.  ``--planned`` runs the planned checker
    (``build_backend``; on the card unless ``--device cpu``) instead of
    ``--backend``.  ``--serve ADDR`` prints a running server's stats
    instead (``--watch``: a refreshing view; ``--fleet``: a router's
    per-node view)."""
    if args.serve:
        return _stats_serve(args)
    if args.fleet:
        raise SystemExit("--fleet needs --serve ADDR (a running fleet "
                         "router's stats verb is what it renders)")
    if args.watch:
        raise SystemExit("--watch needs --serve ADDR (a running server's "
                         "stats verb is what refreshes)")
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
    if args.failover:
        from ..resilience.failover import FailoverBackend

        backend = FailoverBackend(spec, backend)
        bname = backend.name
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


def _resolve_deferred(name, spec, histories, verdicts):
    """A device backend's BUDGET_EXCEEDED verdicts decided again by the
    host oracle (the property layer's resolving oracle); a host backend
    that is that oracle is left as it answered."""
    from ..core.property import _default_oracle
    from ..ops.backend import Verdict

    und = [i for i, x in enumerate(verdicts)
           if x == int(Verdict.BUDGET_EXCEEDED)]
    if und and name not in _ORACLES:
        res = _default_oracle(spec).check_histories(
            spec, [histories[i] for i in und])
        for i, x in zip(und, res):
            verdicts[i] = int(x)
    return verdicts


def cmd_check(args) -> int:
    """Decide an external trace file, without the scheduler.

    The file is JSON with a ``history`` array of ``[pid, cmd, arg, resp,
    invoke_time, response_time]`` rows (the regression file's encoding,
    so a saved regression checks directly) or a ``histories`` array of
    such arrays (decided in one backend call), and optionally ``model`` /
    ``spec_kwargs``.  stdout is one JSON line; exit 0 all linearizable, 1
    a violation, 2 undecided only."""
    from ..ops.backend import Verdict, verify_witness
    from .report import history_from_rows

    with open(args.trace) as f:
        doc = json.load(f)
    model = args.model or doc.get("model")
    if not model:
        raise SystemExit("trace has no 'model'; pass --model")
    if model not in MODELS:
        raise SystemExit(
            f"unknown model {model!r}; one of {sorted(MODELS)}")
    spec, _ = make(model, "atomic", doc.get("spec_kwargs") or None)
    if "histories" in doc:
        if args.witness:
            raise SystemExit(
                "--witness applies to a single 'history' trace; the "
                "batch 'histories' form reports verdicts only")
        hs = [history_from_rows(rows) for rows in doc["histories"]]
        backend = make_backend(args.backend, spec, args.device)
        vs = _resolve_deferred(
            args.backend, spec, hs,
            [int(x) for x in backend.check_histories(spec, hs)])
        n_vio = sum(x == int(Verdict.VIOLATION) for x in vs)
        n_und = sum(x == int(Verdict.BUDGET_EXCEEDED) for x in vs)
        print(json.dumps({
            "model": model, "histories": len(hs),
            "verdicts": [VERDICT_NAMES[x] for x in vs],
            "violations": n_vio, "undecided": n_und}))
        return 1 if n_vio else (2 if n_und else 0)
    if "history" not in doc:
        raise SystemExit(
            "trace needs a 'history' (or 'histories') array of "
            "[pid, cmd, arg, resp, invoke_time, response_time] rows")
    h = history_from_rows(doc["history"])
    w = None
    if args.witness:
        # one host-oracle search gives both the verdict and the witness
        v, w = WingGongCPU(memo=True).check_witness(spec, h)
        v = int(v)
    else:
        backend = make_backend(args.backend, spec, args.device)
        v = _resolve_deferred(
            args.backend, spec, [h],
            [int(backend.check_histories(spec, [h])[0])])[0]
    # the human rendering goes to stderr: stdout stays one JSON line
    print(format_history(spec, h), file=sys.stderr)
    out = {"model": model, "ops": len(h), "pending": h.n_pending,
           "verdict": VERDICT_NAMES[v]}
    if w is not None:
        out["witness"] = w
        out["witness_verifies"] = verify_witness(spec, h, w)
    print(json.dumps(out))
    if v == int(Verdict.LINEARIZABLE):
        return 0
    return 2 if v == int(Verdict.BUDGET_EXCEEDED) else 1


def cmd_shrink(args) -> int:
    """Minimise one failing external trace in this process
    (``shrink/``): the whole frontier (drop-key, drop-pid, drop-one and
    adjacent-commute shrinks) decided in one planned batch a greedy round,
    down to a 1-minimal history; with ``--certificate`` its certificate
    (one witness a drop-one neighbour) is audited by ``verify_witness``.
    The frontier batches go to the planned checker on the card
    (``plan_search(platform="cuda")`` through ``build_backend``), to
    ``--backend`` when it is given, and to the JAX package's host ladder
    (``build_host_backend``) with ``--device cpu`` and no ``--backend``.
    stdout is one JSON line.  Exit 0 minimised, 1 incomplete (best so far
    returned), 2 the input is not a violation, 3 error."""
    from ..ops.backend import Verdict
    from .interop import history_to_rows
    from .report import history_from_rows

    with open(args.trace) as f:
        doc = json.load(f)
    model = args.model or doc.get("model")
    if not model:
        raise SystemExit("trace has no 'model'; pass --model")
    if model not in MODELS:
        raise SystemExit(
            f"unknown model {model!r}; one of {sorted(MODELS)}")
    if "history" not in doc:
        raise SystemExit(
            "shrink minimizes ONE failing trace: the file needs a "
            "'history' array of [pid, cmd, arg, resp, invoke_time, "
            "response_time] rows")
    h = history_from_rows(doc["history"])
    if args.addr:
        return _shrink_remote(args, model, doc)
    spec, _ = make(model, "atomic", doc.get("spec_kwargs") or None)
    from ..shrink import (collect_shrink_stats, shrink_history,
                          verify_certificate)
    from ..shrink.shrinker import DEFAULT_MAX_LANES, DEFAULT_MAX_ROUNDS

    backend = None   # the host ladder
    if args.backend is not None:
        backend = make_backend(args.backend, spec, args.device)
    elif args.device != "cpu":
        from ..search.planner import (build_backend, plan_search,
                                      profile_corpus)

        plan = plan_search(spec, profile_corpus([h], spec), platform="cuda")
        backend = build_backend(spec, plan, device=args.device)
    res = shrink_history(spec, h, backend=backend,
                         max_rounds=(args.max_rounds
                                     if args.max_rounds is not None
                                     else DEFAULT_MAX_ROUNDS),
                         max_lanes=(args.max_lanes
                                    if args.max_lanes is not None
                                    else DEFAULT_MAX_LANES),
                         deadline_s=args.deadline,
                         certificate=(args.certificate
                                      or args.emit_certificate))
    st = collect_shrink_stats(res)
    out = {
        "model": model,
        "verdict": VERDICT_NAMES[int(res.verdict)],
        "initial_ops": res.initial_ops, "final_ops": res.final_ops,
        "ratio": round(res.ratio, 3), "rounds": res.rounds,
        "engine_calls": res.engine_calls, "lanes": res.lanes_checked,
        "memo_hits": res.memo_hits, "complete": res.complete,
        "one_minimal": res.one_minimal,
        "undecided_neighbors": res.undecided_neighbors,
        "history": history_to_rows(res.history),
        "why": res.why,
        "search": st.to_compact(),
    }
    if res.certificate is not None:
        # replayed here (verify_witness, no search trusted): the line
        # carries the audited claim
        out["certificate_audit"] = verify_certificate(
            spec, res.history, res.certificate)
        if args.emit_certificate:
            out["certificate"] = res.certificate
    # the human rendering goes to stderr: stdout stays one JSON line
    print(format_history(spec, res.history), file=sys.stderr)
    print(json.dumps(out))
    if args.save and res.ok:
        from ..resilience.checkpoint import atomic_write_json

        atomic_write_json(args.save, {
            "model": model, "spec_kwargs": spec.spec_kwargs(),
            "history": history_to_rows(res.history)})
        print(f"minimized trace saved to {args.save}", file=sys.stderr)
    if not res.ok:
        return 2 if res.verdict != int(Verdict.VIOLATION) else 3
    return 0 if res.complete else 1


def _shrink_remote(args, model: str, doc: dict) -> int:
    """``shrink --addr``: the request served by a running check server's
    ``shrink`` verb (its frontier lanes ride the server's micro-batches
    and verdict cache); the reference's exit codes."""
    # the server runs its own loop: the in-process knobs must fail
    # loudly, never be dropped
    if args.max_rounds is not None or args.max_lanes is not None:
        raise SystemExit("--max-rounds/--max-lanes tune the in-process "
                         "shrinker; the server uses its own bounds (drop "
                         "them, or drop --addr)")
    if args.emit_certificate:
        raise SystemExit("--emit-certificate is in-process only; with "
                         "--addr use --certificate (the response carries "
                         "the witnesses)")
    if args.backend is not None:
        raise SystemExit("--backend picks the in-process checker; the "
                         "server decides with its own engines (drop it, "
                         "or drop --addr)")
    from ..serve.client import CheckClient

    client = CheckClient(args.addr, timeout_s=args.timeout)
    try:
        out = client.shrink(model, doc["history"],
                            spec_kwargs=doc.get("spec_kwargs") or None,
                            certificate=args.certificate,
                            deadline_s=args.deadline)
    finally:
        client.close()
    print(json.dumps(out))
    if not out.get("ok"):
        return 3
    if args.save and out.get("verdict") == "VIOLATION":
        from ..resilience.checkpoint import atomic_write_json

        atomic_write_json(args.save, {
            "model": model,
            "spec_kwargs": out.get("spec_kwargs")
            or doc.get("spec_kwargs") or {},
            "history": out["history"]})
        print(f"minimized trace saved to {args.save}", file=sys.stderr)
    if out.get("verdict") != "VIOLATION":
        return 2
    return 0 if out.get("complete") else 1


def _planned_checker(spec, histories, device):
    """The planned checker on ``device`` (``plan_search(platform="cuda")``
    through ``build_backend``), as ``shrink`` builds it."""
    from ..search.planner import build_backend, plan_search, profile_corpus

    plan = plan_search(spec, profile_corpus(histories, spec),
                       platform="cuda")
    return build_backend(spec, plan, device=device)


def _trace_poll_timeout() -> float:
    from ..resilience.policy import preset

    return preset("fleet-probe").timeout_s or 5.0


def _trace_fetch(args, client=None):
    """One fetch of the trace's events: over the wire from a running
    server's ``obs.trace`` op (``--addr``; ``--follow`` reuses one
    client across polls), or from the local span log (``--log``), with
    the causal closure so a fleet log read locally renders the same
    tree."""
    from ..obs import load_events, trace_closure

    if args.addr:
        from ..serve.client import CheckClient

        own = client is None
        if own:
            client = CheckClient(args.addr,
                                 timeout_s=_trace_poll_timeout())
        try:
            res = client.trace_events(args.trace_id)
        finally:
            if own:
                client.close()
        if not res.get("ok"):
            raise SystemExit(f"obs.trace refused: "
                             f"{res.get('error') or res}")
        return res.get("events") or []
    return trace_closure(load_events(args.log), args.trace_id)


def cmd_trace(args) -> int:
    """Reconstruct ONE request's causal tree from a span log (``obs/``,
    docs/OBSERVABILITY.md) as an indented tree (default) or the raw event
    list (``--json``).  ``--follow`` keeps polling the log and prints each
    NEW event of the trace as it lands, stopping after ``--max-idle``
    quiet seconds.  With ``--addr`` the events come from a running
    server's ``obs.trace`` op.  Exit 0 when events were found, 1 when the
    trace id has none in the log.  Host work only: reading and rendering
    a log."""
    from ..obs import build_tree, render_tree

    if not args.addr and not args.log:
        raise SystemExit("trace needs --log PATH or --addr ADDR")
    # in follow mode one client serves the first fetch and every poll
    client = None
    if args.addr and args.follow:
        from ..serve.client import CheckClient

        client = CheckClient(args.addr, timeout_s=_trace_poll_timeout())

    def fetch():
        return _trace_fetch(args, client=client)

    source = args.addr or args.log
    events = fetch()
    if args.json and not args.follow:
        print(json.dumps(events))
    elif args.json:
        # follow mode streams JSONL: the initial events first, then each
        # new one as it lands
        for e in events:
            print(json.dumps(e), flush=True)
    elif events:
        print(f"trace {args.trace_id} ({len(events)} event(s), "
              f"source: {source})")
        print(render_tree(build_tree(events)))
    if args.follow:
        seen = {e.get("span") for e in events}
        idle_since = time.monotonic()
        try:
            while time.monotonic() - idle_since < args.max_idle:
                time.sleep(max(0.1, args.interval))
                fresh = [e for e in fetch() if e.get("span") not in seen]
                if not fresh:
                    continue
                idle_since = time.monotonic()
                for e in fresh:
                    seen.add(e.get("span"))
                    events.append(e)
                    if args.json:
                        print(json.dumps(e), flush=True)
                    else:
                        at = " ".join(
                            f"{k}={v}" for k, v in
                            (e.get("attrs") or {}).items())
                        ms = (f" {e['ms']}ms"
                              if e.get("ms") is not None else "")
                        print(f"+ {e.get('name')}{ms}"
                              + (f" [{at}]" if at else ""), flush=True)
        except KeyboardInterrupt:
            pass
        finally:
            if client is not None:
                client.close()
    if not events:
        print(f"no events for trace {args.trace_id!r} in {source} "
              "(was the sink installed, and has the log rotated twice "
              "since?)", file=sys.stderr)
        return 1
    return 0


def cmd_ingest(args) -> int:
    """Turn a foreign event log (``ingest/``, docs/MONITOR.md) into a
    corpus: Jepsen/Knossos-style (``--format jepsen``) or porcupine-style
    (``--format porcupine``) EDN event lines decode into the ``check``
    trace format.  Default: print (or ``--out``) that JSON document.
    ``--check`` decides it with the planned checker on the card (its
    undecided answer resolved by the host oracle, as ``check`` does; with
    ``--device cpu`` the JAX package's host ladder, ``host_fallback``):
    exit 0 linearizable / 1 violation / 2 undecided.  ``--emit``
    re-renders the canonical log text (the byte-stable round trip).
    Parse and domain errors exit 2, loudly."""
    from ..ingest import EdnError, IngestError, emit_trace, parse_trace
    from .report import history_from_rows

    spec, _ = make(args.spec, "atomic",
                   json.loads(args.spec_kwargs)
                   if args.spec_kwargs else None)
    with open(args.trace) as f:
        text = f.read()
    try:
        rows = parse_trace(args.format, text, args.spec, spec)
    except (EdnError, IngestError) as e:
        print(f"ingest: {e}", file=sys.stderr)
        return 2
    h = history_from_rows(rows)
    if args.emit:
        out_text = emit_trace(args.format, h, args.spec, spec)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out_text)
        else:
            sys.stdout.write(out_text)
        return 0
    doc = {"model": args.spec, "spec_kwargs": spec.spec_kwargs(),
           "format": args.format, "ops": len(h),
           "pending": h.n_pending,
           "history": [[o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
                        o.response_time] for o in h.ops]}
    if args.submit:
        from ..serve.client import CheckClient

        client = CheckClient(args.submit, timeout_s=args.timeout)
        try:
            res = client.check(args.spec, [doc["history"]],
                               spec_kwargs=spec.spec_kwargs() or None,
                               witness=args.witness)
        finally:
            client.close()
        print(json.dumps(res))
        if not res.get("ok"):
            return 3
        return 1 if res.get("violations") else (
            2 if res.get("undecided") else 0)
    if args.check:
        if args.device == "cpu":
            from ..resilience.failover import host_fallback

            v = int(host_fallback(spec).check_histories(spec, [h])[0])
        else:
            backend = _planned_checker(spec, [h], args.device)
            v = _resolve_deferred(
                "planned", spec, [h],
                [int(backend.check_histories(spec, [h])[0])])[0]
        print(json.dumps({**{k: doc[k] for k in
                             ("model", "format", "ops", "pending")},
                          "verdict": VERDICT_NAMES[v]}))
        return 0 if v == 1 else (2 if v == 2 else 1)
    payload = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        print(json.dumps({"out": args.out, "ops": len(h),
                          "pending": h.n_pending}))
    else:
        print(payload)
    return 0


def cmd_monitor(args) -> int:
    """Tail a growing foreign event log into a LIVE in-process monitor
    session (docs/MONITOR.md): each appended line becomes a session
    event, the session's incremental frontier decides it (its window
    re-checks one batch on the card a decide; ``--device cpu``: the
    reference's host loop), and a verdict flip prints the 1-minimal
    repro with its certificate (``shrink_history`` with the planned
    checker on the card; ``--device cpu``: the host ladder) the moment
    it is decidable.  Exit codes: 0 linearizable, 1 violation, 2
    undecided or a parse error."""
    from ..core.spec import projection_report
    from ..ingest import EdnError, EventTailer, IngestError, tail_file
    from ..monitor import MonitorSession

    spec, _ = make(args.spec, "atomic",
                   json.loads(args.spec_kwargs)
                   if args.spec_kwargs else None)
    tailer = EventTailer(args.format, args.spec, spec)
    if args.addr:
        return _monitor_remote(args, spec, tailer)
    proj = None
    if not projection_report(spec):
        p = spec.projected_spec()
        if p.name in MODELS:
            proj = p
    s = MonitorSession(args.session or "local", spec, proj_spec=proj,
                       device=args.device)
    flip_doc = None
    try:
        for line in tail_file(args.trace, follow=args.follow,
                              max_idle_s=args.max_idle):
            events = tailer.events_for_line(line)
            if not events:
                continue
            s.append(events)
            already = s.flip_pushed
            if s.decide() == 0 and not already:
                s.flip_pushed = True
                flip_doc = _flip_doc(spec, s.history(), args)
                print(json.dumps({"event": "session.flip",
                                  "session": s.sid, **flip_doc}),
                      flush=True)
        v = s.close()
    except (EdnError, IngestError) as e:
        print(f"monitor: {e}", file=sys.stderr)
        return 2
    verdict = VERDICT_NAMES[v]
    print(json.dumps({"session": s.sid, "verdict": verdict,
                      **s.counters()}))
    if args.save and flip_doc is not None:
        from ..resilience.checkpoint import atomic_write_json

        atomic_write_json(args.save, {
            "model": args.spec, "spec_kwargs": spec.spec_kwargs(),
            "history": flip_doc["repro"]})
        print(json.dumps({"saved": args.save}), file=sys.stderr)
    if verdict == "VIOLATION":
        return 1
    return 0 if verdict == "LINEARIZABLE" else 2


def _monitor_remote(args, spec, tailer) -> int:
    """``monitor --addr``: the session served by a running check server
    (the ``session.*`` ops, seq-tracked); the reference's exit codes (3:
    shed or error)."""
    from ..ingest import EdnError, IngestError, tail_file
    from ..serve.client import CheckClient, SessionHandle

    flip_doc = None
    verdict = "LINEARIZABLE"
    client = CheckClient(args.addr, timeout_s=args.timeout)
    try:
        handle = SessionHandle(client, args.spec,
                               spec_kwargs=spec.spec_kwargs() or None,
                               session=args.session,
                               deadline_s=args.deadline)
        print(json.dumps({"session": handle.sid,
                          "resumed": handle.last.get("resumed"),
                          "trace": handle.trace}), file=sys.stderr)
        for line in tail_file(args.trace, follow=args.follow,
                              max_idle_s=args.max_idle):
            events = tailer.events_for_line(line)
            if not events:
                continue
            out = handle.append(events)
            if not out.get("ok"):
                print(json.dumps(out))
                return 3
            if out.get("flip"):
                flip_doc = out["flip"]
                print(json.dumps({"event": "session.flip",
                                  "session": handle.sid, **flip_doc}),
                      flush=True)
        fin = handle.close(witness=args.witness)
        if not fin.get("ok"):
            print(json.dumps(fin))
            return 3
        verdict = fin.get("verdict", verdict)
        print(json.dumps(fin))
    except (EdnError, IngestError) as e:
        print(f"monitor: {e}", file=sys.stderr)
        return 2
    finally:
        client.close()
    if args.save and flip_doc is not None:
        from ..resilience.checkpoint import atomic_write_json

        atomic_write_json(args.save, {
            "model": args.spec, "spec_kwargs": spec.spec_kwargs(),
            "history": flip_doc["repro"]})
        print(json.dumps({"saved": args.save}), file=sys.stderr)
    if verdict == "VIOLATION":
        return 1
    return 0 if verdict == "LINEARIZABLE" else 2


def _flip_doc(spec, history, args) -> dict:
    """The pushed flip payload: the stream shrunk to a 1-minimal repro
    with its certificate."""
    from ..shrink.shrinker import shrink_history

    backend = (None if args.device == "cpu"
               else _planned_checker(spec, [history], args.device))
    res = shrink_history(spec, history, backend=backend,
                         deadline_s=args.deadline, certificate=True)
    doc = {"verdict": "VIOLATION",
           "initial_ops": res.initial_ops,
           "final_ops": res.final_ops,
           "one_minimal": res.one_minimal,
           "complete": res.complete,
           "repro": [[o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
                      o.response_time] for o in res.history.ops]}
    if res.certificate is not None:
        doc["certificate"] = res.certificate
    return doc


def cmd_lint(args) -> int:
    """The port's static analysis (``qsm_tpu_torch/analysis``): exit 1 on
    non-whitelisted error-severity findings, 0 otherwise.  Its semantic
    passes (spec parity, the rebuild guard, the edge launches) run on the
    card unless ``--device cpu``; without a card and without that flag it
    exits 2 with ``BackendUnavailable``'s message and runs nothing."""
    # Exit-code contract (the reference's cmd_lint): 0 clean, 1 REAL
    # FINDINGS, 2 usage error (no card without --device cpu included),
    # 3 analyzer trouble.  EVERYTHING — imports, the run itself — sits
    # inside the crash guard: a broken analysis module exiting 1 would
    # read as a real finding.
    import os

    try:
        from ..analysis import FAMILIES, render_text, run_lint
        from ..ops.backend import BackendUnavailable, resolve_device

        wl = args.whitelist
        if wl is not None and not os.path.exists(wl):
            print(f"whitelist file not found: {wl}", file=sys.stderr)
            return 2
        models = args.models.split(",") if args.models else None
        if models:
            # validate HERE, not via a broad except around run_lint: a
            # ValueError from deep inside an analysis pass is analyzer
            # trouble (rc 3 with traceback), not a usage error
            unknown = sorted(set(models) - set(MODELS))
            if unknown:
                print(f"unknown model families {unknown}; one of "
                      f"{sorted(MODELS)}", file=sys.stderr)
                return 2
        families = args.family.split(",") if args.family else None
        if families:
            unknown = sorted(set(families) - set(FAMILIES))
            if unknown:
                print(f"unknown pass families {unknown}; one of "
                      f"{sorted(FAMILIES)}", file=sys.stderr)
                return 2
        try:
            device = resolve_device(args.device)
        except BackendUnavailable as e:
            print(f"BackendUnavailable: {e}", file=sys.stderr)
            return 2
        # default-whitelist resolution (.qsmlint-torch at the repo root
        # when present) happens INSIDE run_lint — one definition; the
        # report carries the resolved path back for the label
        rep = run_lint(models=models, retrace=not args.no_retrace,
                       whitelist=wl, families=families,
                       changed=args.changed, cache=not args.no_cache,
                       device=device)
        doc = rep.to_json()
        if args.out:
            # always the JSON form regardless of what stdout renders;
            # INSIDE the guard: an unwritable --out is analyzer trouble,
            # not findings
            from ..resilience.checkpoint import atomic_write_text

            atomic_write_text(args.out, doc + "\n")
        if args.sarif:
            # the CI diff-annotation form (SARIF 2.1.0), always archived
            # to a file: stdout keeps its one-document contract
            from ..resilience.checkpoint import atomic_write_text

            atomic_write_text(args.sarif, rep.to_sarif() + "\n")
        if args.json:
            print(doc)
        else:
            print(render_text(rep.findings, rep.whitelisted))
            scope = ""
            if rep.changed is not None:
                n = (len(rep.changed["files"])
                     if rep.changed["files"] is not None else "all")
                scope = f"; changed since {rep.changed['ref']}: {n}"
            if rep.cache is not None:
                scope += (f"; cache {rep.cache['hits']} hit(s) / "
                          f"{rep.cache['misses']} miss(es)")
            print(f"({rep.seconds:.1f}s on {rep.device} over models: "
                  f"{', '.join(rep.models)}; families: "
                  f"{','.join(rep.families)};"
                  f" whitelist: {rep.whitelist_path or 'none'}{scope})")
    except Exception as e:  # noqa: BLE001 — analyzer trouble, not findings
        import traceback

        traceback.print_exc()
        print(f"qsmlint crashed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 3
    return 0 if rep.ok else 1


def cmd_list(args) -> int:
    """Every registry model (sizes and impls), every backend and the
    native oracle's status, as one JSON object.  ``native_status`` builds
    nothing."""
    from ..native import native_status

    status = native_status()
    print(json.dumps({
        "models": {
            name: {"pids": e.default_pids, "ops": e.default_ops,
                   "impls": sorted(e.impls)}
            for name, e in sorted(MODELS.items())},
        "backends": list(BACKENDS),
        "native": status,
        "native_available": status in ("loaded", "built"),
    }))
    return 0


def cmd_coverage(args) -> int:
    from ..core.generator import generate_program

    entry = MODELS[args.model]
    spec, _ = make(args.model, args.impl)
    prog = generate_program(spec, seed=args.seed,
                            n_pids=args.pids or entry.default_pids,
                            max_ops=args.ops or entry.default_ops)
    factory = SutFactory(args.model, args.impl)
    stats = schedule_coverage(
        factory, prog, seeds=[f"{args.seed}:{i}" for i in range(args.runs)])
    out = {
        "model": args.model, "ops": len(prog), "runs": stats.seeds,
        "distinct_schedules": stats.distinct_schedules,
        "distinct_histories": stats.distinct_histories,
        "schedule_diversity": round(stats.schedule_diversity, 3)}
    if args.exact:
        # the enumerated tree as ground truth (counts only, no verdicts)
        from ..sched.systematic import explore_program

        res = explore_program(factory, prog, spec,
                              max_schedules=args.max_schedules, check=False)
        out["exact"] = {"schedules": res.schedules_run,
                        "pruned_schedules": res.pruned_schedules,
                        "distinct_histories": res.distinct_histories,
                        "exhausted": res.exhausted}
        if res.exhausted and res.distinct_histories:
            out["sampled_history_coverage"] = round(
                stats.distinct_histories / res.distinct_histories, 3)
    print(json.dumps(out))
    return 0


def _result_line(r) -> dict:
    """The one ExploreResult -> JSON mapping of every explore output."""
    line = {"schedules_run": r.schedules_run,
            "pruned_schedules": r.pruned_schedules,
            "distinct_histories": r.distinct_histories,
            "exhausted": r.exhausted, "violations": r.violations,
            "undecided": r.undecided, "verified": r.verified}
    if r.violating is not None:
        # the replayable delivery-choice script that produced it
        line["violating_schedule"] = r.violating.seed
    return line


def _crash_sweep_arg(args):
    """``--crash-sweep NAME:LO-HI`` as (name, lo, hi), refused with the
    flags it does not combine with."""
    if (args.programs > 1 or args.shrink or args.save_regression
            or args.crash_at):
        raise SystemExit(
            "--crash-sweep explores ONE program under a range of "
            "crash points; combine it only with --seed/--pids/--ops/"
            "--partition (drop --programs/--shrink/"
            "--save-regression/--crash-at)")
    name, _, rng = args.crash_sweep.partition(":")
    lo, _, hi = rng.partition("-")
    if not (name and lo.isdigit() and hi.isdigit()):
        raise SystemExit("--crash-sweep wants NAME:LO-HI "
                         "(e.g. primary:1-12)")
    if int(lo) > int(hi):
        # an empty range would print a vacuous all_verified
        raise SystemExit(f"--crash-sweep range is empty "
                         f"({lo}-{hi}); want LO <= HI")
    return name, int(lo), int(hi)


def cmd_explore(args) -> int:
    """Bounded-exhaustive schedule exploration (sched/systematic.py):
    every interleaving, one batched verdict."""
    from ..core.generator import generate_program
    from ..sched.runner import prepare_run
    from ..sched.systematic import (deterministic_faults, explore_many,
                                    explore_program, shrink_explored)

    # usage errors before any backend is built
    if args.programs > 1 and (args.shrink or args.save_regression):
        raise SystemExit(
            "--programs is a sweep; combine --shrink/--save-regression "
            "with a single program (drop --programs)")
    if args.workers and args.programs <= 1:
        raise SystemExit(
            "--workers fans a --programs sweep over processes; a single "
            "program's tree enumerates serially (add --programs N)")
    cs = _crash_sweep_arg(args) if args.crash_sweep else None
    faults = _faults_from_args(args)
    if not deterministic_faults(faults):
        raise SystemExit(
            "explore enumerates schedules exactly, which only composes "
            "with DETERMINISTIC fault plans (--crash-at/--partition); "
            "probabilistic faults (--p-drop/--p-duplicate/--p-delay) are "
            "seeded draws — use `run` sampling for those")
    spec, _ = make(args.model, args.impl)
    factory = SutFactory(args.model, args.impl)
    if cs is not None:
        # a misspelt process name would crash nothing and certify the
        # fault-free system: check it against what a run spawns
        probe, _ = prepare_run(factory(), generate_program(
            spec, seed=args.seed, n_pids=args.pids, max_ops=args.ops),
            seed=0)
        if cs[0] not in probe.procs:
            raise SystemExit(
                f"--crash-sweep: no process named {cs[0]!r} is spawned "
                f"by {args.model}/{args.impl}; processes: "
                f"{sorted(probe.procs)}")
    backend = make_backend(args.backend, spec, args.device)
    if args.programs > 1:
        # N trees enumerate on the host, all their histories decide in
        # one backend batch
        progs = [generate_program(spec, seed=args.seed + i,
                                  n_pids=args.pids, max_ops=args.ops)
                 for i in range(args.programs)]
        results = explore_many(
            factory, progs, spec, backend=backend,
            max_schedules=args.max_schedules, prune=not args.no_prune,
            faults=faults, workers=args.workers)
        total_vio = sum(r.violations for r in results)
        for i, r in enumerate(results):
            print(json.dumps({"seed": args.seed + i, "ops": len(progs[i]),
                              **_result_line(r)}))
        print(json.dumps({
            "programs": len(results), "total_violations": total_vio,
            "total_undecided": sum(r.undecided for r in results),
            "all_verified": all(r.verified for r in results),
            "seconds": round(sum(r.seconds for r in results), 3)}))
        return 0 if total_vio == 0 else 1
    prog = generate_program(spec, seed=args.seed, n_pids=args.pids,
                            max_ops=args.ops)
    if cs is not None:
        # the program under every crash point of the range: `verified` on
        # every line covers the whole crash point x schedule space
        name, lo, hi = cs
        total_vio = total_und = 0
        all_verified = True
        seconds = 0.0
        for k in range(lo, hi + 1):
            # a co-passed --partition extends every point's plan
            plan = FaultPlan(crash_at={name: k},
                             partitions=faults.partitions if faults
                             else [])
            r = explore_program(factory, prog, spec, backend=backend,
                                max_schedules=args.max_schedules,
                                prune=not args.no_prune, faults=plan)
            print(json.dumps({"crash_at": f"{name}:{k}",
                              **_result_line(r)}))
            total_vio += r.violations
            total_und += r.undecided
            all_verified = all_verified and r.verified
            seconds += r.seconds
        print(json.dumps({"crash_sweep": f"{name}:{lo}-{hi}",
                          "ops": len(prog),
                          "total_violations": total_vio,
                          "total_undecided": total_und,
                          "all_verified": all_verified,
                          "seconds": round(seconds, 3)}))
        # 1: violations; 2: none, but truncated or undecided; 0: verified
        if total_vio:
            return 1
        return 0 if all_verified else 2
    res = explore_program(factory, prog, spec, backend=backend,
                          max_schedules=args.max_schedules,
                          prune=not args.no_prune, faults=faults)
    shrink_steps = 0
    if res.violations and args.shrink:
        prog, res, shrink_steps = shrink_explored(
            factory, prog, spec, backend=backend,
            max_schedules=args.max_schedules, initial=res, faults=faults)
    print(json.dumps({"model": args.model, "impl": args.impl,
                      "ops": len(prog), **_result_line(res),
                      "shrink_steps": shrink_steps,
                      "seconds": res.seconds}))
    if res.violating is not None:
        print(format_history(spec, res.violating), file=sys.stderr)
        if args.save_regression:
            from ..core.property import Counterexample

            cx = Counterexample(program=prog, history=res.violating,
                                trial=0, trial_seed=res.violating.seed,
                                shrink_steps=shrink_steps)
            # the fault plan is part of the finding
            cfg = PropertyConfig(n_pids=args.pids, max_ops=args.ops,
                                 faults=faults)
            save_regression(args.save_regression, args.model, args.impl,
                            spec, cfg, cx)
            print(f"regression saved to {args.save_regression}",
                  file=sys.stderr)
    return 0 if res.ok else 1


def cmd_fuzz(args) -> int:
    if args.addr:
        # the closed loop against a live server (gen/fleet.py): steered
        # corpora as check requests and monitor sessions, every answer
        # re-proved here.  Wrong verdicts trump everything, else the
        # server's own health answer (the `health` exit codes).
        from ..gen.fleet import fuzz_fleet

        rep = fuzz_fleet(
            args.addr, args.models.split(","), rounds=args.rounds,
            batch=args.histories, seed=args.seed,
            session_every=args.session_every,
            deadline_s=args.deadline, timeout_s=args.timeout,
            checkpoint_dir=args.checkpoint_dir,
            log=lambda m: print(m, file=sys.stderr), device=args.device)
        print(json.dumps(rep))
        if rep["wrong_verdicts_total"]:
            return 1
        return int(rep["exit_code"])
    from .fuzz import fuzz_parity

    arms = tuple(args.backends.split(","))
    rep = fuzz_parity(n_specs=args.specs, hists_per_spec=args.histories,
                      seed=args.seed, n_pids=args.pids, n_ops=args.ops,
                      p_pending=args.p_pending, backends=arms,
                      device=args.device)
    out = {
        "specs": rep.specs, "histories": rep.histories,
        "linearizable": rep.linearizable, "violations": rep.violations,
        "budget_exceeded": rep.budget_exceeded,
        "mismatches": rep.mismatches[:20], "ok": rep.ok}
    if "cpp" in arms:
        out["cpp_native_histories"] = rep.cpp_native_histories
        if rep.cpp_native_histories == 0:
            # every history fell back to the oracle it is compared with
            out["cpp_vacuous"] = True
    print(json.dumps(out))
    return 0 if rep.ok else 1


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device of the device backends (default "
                        "cuda; cpu runs the kernels' plain versions)")


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
    p.add_argument("--transport", default="memory",
                   choices=["memory", "tcp"],
                   help="scheduler-plane message transport (tcp: real "
                        "loopback sockets; histories are bit-identical)")
    p.add_argument("--workers", type=int, default=0,
                   help="worker processes for schedule execution "
                        "(0: serial; histories are bit-identical)")
    p.add_argument("--failover", action="store_true",
                   help="wrap the backend in a FailoverBackend: an "
                        "injected dispatch fault (QSM_TPU_FAULTS), and on "
                        "the host any device error, degrades the undecided "
                        "lanes to the exact host ladder with identical "
                        "verdicts; on the card a real device error raises. "
                        "Degradations are in the log's timings")
    p.add_argument("--minimize", action="store_true",
                   help="after the program-level shrink, minimise the "
                        "failing history itself with the batched history "
                        "shrinker: a 1-minimal sub-history or reschedule "
                        "printed beside the replayable counterexample")
    _add_fault_args(p)
    p.add_argument("--log", default=None, help="JSONL log path")
    p.add_argument("--save-regression", default=None,
                   help="write the failing counterexample to this JSON "
                        "file")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("replay", help="reproduce a failure from seed or file")
    p.add_argument("--regression", default=None)
    p.add_argument("--witness", action="store_true",
                   help="on a LINEARIZABLE verdict, print the "
                        "linearization order and its search-free "
                        "verification")
    p.add_argument("--model", default=None, choices=sorted(MODELS))
    p.add_argument("--impl", default="racy")
    p.add_argument("--trial-seed", default=None)
    p.add_argument("--pids", type=int, default=None)
    p.add_argument("--ops", type=int, default=None)
    p.add_argument("--trials", type=int, default=100)
    _add_fault_args(p)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser(
        "check", help="decide an external trace file (no scheduler)")
    p.add_argument("--trace", required=True,
                   help="JSON with a 'history' array of [pid, cmd, arg, "
                        "resp, invoke_time, response_time] rows, or a "
                        "'histories' array of them")
    p.add_argument("--model", default=None, choices=sorted(MODELS),
                   help="overrides the trace's own 'model' field")
    p.add_argument("--backend", default="stepper", choices=BACKENDS)
    _add_device(p)
    p.add_argument("--witness", action="store_true",
                   help="include the verified linearization order (one "
                        "host-oracle search gives verdict and witness; "
                        "--backend is ignored)")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser(
        "shrink",
        help="minimise a failing external trace: frontier-at-once "
             "batched shrinking to a 1-minimal history with a "
             "verify_witness-replayable certificate")
    p.add_argument("--trace", required=True,
                   help="JSON with a 'history' array of [pid, cmd, arg, "
                        "resp, invoke_time, response_time] rows (the "
                        "`check` trace format)")
    p.add_argument("--model", default=None, choices=sorted(MODELS),
                   help="overrides the trace's own 'model' field")
    p.add_argument("--addr", default=None,
                   help="send to a running check server's `shrink` verb "
                        "instead of shrinking in this process (a,b = "
                        "multi-address failover)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="client-side response bound (--addr)")
    p.add_argument("--backend", default=None, choices=BACKENDS,
                   help="the checker of the frontier batches (default: "
                        "the planned checker, TorchStepper inside SegDC / "
                        "PComp as plan_search says; with --device cpu, "
                        "the JAX package's host ladder)")
    _add_device(p)
    p.add_argument("--certificate", action="store_true",
                   help="compute the 1-minimality certificate (one "
                        "witness a drop-one neighbour) and audit it with "
                        "verify_witness")
    p.add_argument("--emit-certificate", action="store_true",
                   help="also put the certificate's witnesses in the JSON "
                        "line (implies the audit of --certificate)")
    p.add_argument("--max-rounds", type=int, default=None,
                   help="greedy round cap (default 256)")
    p.add_argument("--max-lanes", type=int, default=None,
                   help="frontier candidates decided a batch (default "
                        "512); a truncated frontier is reported in `why` "
                        "and forfeits the 1-minimality claim")
    p.add_argument("--deadline", type=float, default=None,
                   help="seconds; past it the best history so far is "
                        "returned with complete=false")
    p.add_argument("--save", default=None,
                   help="write the minimised history as a `check`-format "
                        "trace file (atomic)")
    p.set_defaults(fn=cmd_shrink)

    p = sub.add_parser("list", help="models, impls, and backend choices")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("coverage", help="schedule-coverage stats")
    p.add_argument("--model", required=True, choices=sorted(MODELS))
    p.add_argument("--impl", default="atomic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pids", type=int, default=None)
    p.add_argument("--ops", type=int, default=None)
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--exact", action="store_true",
                   help="also enumerate the interleaving tree (bounded) "
                        "and report what fraction of distinct histories "
                        "the sampled runs reached")
    p.add_argument("--max-schedules", type=int, default=10_000)
    p.set_defaults(fn=cmd_coverage)

    p = sub.add_parser(
        "explore",
        help="bounded-exhaustive schedule exploration of one program")
    p.add_argument("--model", required=True, choices=sorted(MODELS))
    p.add_argument("--impl", default="racy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pids", type=int, default=2)
    p.add_argument("--ops", type=int, default=6)
    p.add_argument("--max-schedules", type=int, default=10_000)
    p.add_argument("--programs", type=int, default=1,
                   help="sweep N generated programs (seeds seed..seed+N-1)"
                        "; all trees' histories decide in ONE batch")
    p.add_argument("--workers", type=int, default=0,
                   help="fan the --programs tree enumerations over N "
                        "worker processes (0: serial; results are "
                        "bit-identical either way)")
    p.add_argument("--backend", default="stepper", choices=BACKENDS)
    _add_device(p)
    p.add_argument("--shrink", action="store_true",
                   help="minimize a violating program by re-exploring "
                        "shrink candidates")
    p.add_argument("--save-regression", default=None,
                   help="persist the violating (program, schedule) as a "
                        "replayable regression file")
    p.add_argument("--no-prune", action="store_true",
                   help="disable state-fingerprint subtree pruning (the "
                        "raw lexicographic enumeration)")
    _add_fault_args(p)  # deterministic plans only, see cmd_explore
    p.add_argument("--crash-sweep", default=None, metavar="NAME:LO-HI",
                   help="explore the program under crash_at={NAME: k} "
                        "for every k in [LO, HI]: one JSON line a crash "
                        "point plus a summary")
    p.set_defaults(fn=cmd_explore)

    p = sub.add_parser(
        "fuzz", help="differential backend fuzzing over random specs")
    p.add_argument("--specs", type=int, default=10)
    p.add_argument("--histories", type=int, default=32,
                   help="histories per spec")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pids", type=int, default=4)
    p.add_argument("--ops", type=int, default=10)
    p.add_argument("--p-pending", type=float, default=0.1)
    p.add_argument("--backends", default="memo,cpp,device",
                   help="comma list from {memo, cpp, device, segdc, auto, "
                        "hybrid, pallas}: device is TorchStepper, pallas "
                        "TorchGPU (the dfs_chunk kernel)")
    # the closed loop against a live server (gen/fleet.py)
    p.add_argument("--addr", default=None,
                   help="soak a live server instead (comma list = "
                        "failover set); --device is where the corpora "
                        "are generated")
    p.add_argument("--models", default="register,cas",
                   help="comma list of registry models to fuzz (--addr)")
    p.add_argument("--rounds", type=int, default=4,
                   help="steering rounds a model (--addr)")
    p.add_argument("--session-every", type=int, default=2,
                   help="stream a monitor session every Nth round; 0 "
                        "disables (--addr)")
    p.add_argument("--deadline", type=float, default=30.0,
                   help="per-request server deadline_s (--addr)")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="client timeout_s (--addr)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for per-model steering checkpoints "
                        "(--addr)")
    _add_device(p)
    p.set_defaults(fn=cmd_fuzz)

    p = sub.add_parser(
        "lint",
        help="the port's static spec/kernel/determinism analysis (exit 1 "
             "on non-whitelisted error findings; its semantic passes run "
             "on the card unless --device cpu)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON document instead of text")
    p.add_argument("--out", default=None,
                   help="also write the JSON findings document to this "
                        "path (CI archive)")
    p.add_argument("--whitelist", default=None,
                   help="accepted-findings file (default: .qsmlint-torch "
                        "at the repo root when present)")
    p.add_argument("--models", default=None,
                   help="comma list of registry families (default: all)")
    p.add_argument("--family", default=None,
                   help="comma list of registered pass-family ids "
                        "(a-o; default: all)")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="lint only modules git-touched since REF "
                        "(default HEAD); whole families run iff their "
                        "scan set or triggers changed")
    p.add_argument("--sarif", default=None, metavar="PATH",
                   help="also write the findings as a SARIF 2.1.0 "
                        "document (CI diff annotation)")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the on-disk per-file result cache "
                        "(.qsmlint-torch-cache.json)")
    p.add_argument("--no-retrace", action="store_true",
                   help="skip the rebuild guard (the dynamic check that "
                        "warms the device backends; the reference's "
                        "retracing check)")
    _add_device(p)
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("bench", help="checker throughput on one model")
    _add_common(p, "cpu")
    p.add_argument("--corpus", type=int, default=256)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "stats",
        help="search-cost accounting (SearchStats) of one backend on one "
             "corpus, with the corpus profile and the planner's verdict")
    _add_common(p, "cpu")
    p.add_argument("--failover", action="store_true",
                   help="wrap the backend in a FailoverBackend and report "
                        "its counters in the resilience block")
    p.add_argument("--planned", action="store_true",
                   help="run the plan_search-built checker (the port's "
                        "plan: TorchStepper, ordering, SegDC / PComp when "
                        "the profile says so) instead of --backend")
    p.add_argument("--corpus", type=int, default=64)
    p.add_argument("--serve", default=None, metavar="ADDR",
                   help="print a running check server's aggregate stats "
                        "instead of running a corpus (a,b = "
                        "multi-address failover)")
    p.add_argument("--watch", action="store_true",
                   help="with --serve: a refreshing view of the live "
                        "counters (Ctrl-C exits)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch refresh interval seconds")
    p.add_argument("--watch-count", type=int, default=0,
                   help="--watch: exit after N frames (0 = forever)")
    p.add_argument("--fleet", action="store_true",
                   help="with --serve ROUTER: the fleet router's "
                        "per-node view (device, traffic, bank)")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser(
        "serve",
        help="run the check server (warm engines on the card, "
             "micro-batching, verdict cache, bounded admission)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = ephemeral; the bound address is "
                        "printed as one JSON line)")
    p.add_argument("--unix", default=None,
                   help="serve on this UNIX socket path instead of TCP")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "planned"],
                   help="on the card both are the planned checker; with "
                        "--device cpu, auto = the host cpp->memo ladder "
                        "and planned = the CPU plan")
    _add_device(p)
    p.add_argument("--workers", type=int, default=0,
                   help="dispatch micro-batches to N supervised host "
                        "worker processes (needs --device cpu)")
    p.add_argument("--quarantine-after", type=int, default=2,
                   help="a spec whose dispatches crashed this many "
                        "workers is quarantined to the in-process engine")
    p.add_argument("--max-lanes", type=int, default=64,
                   help="micro-batch width: lanes coalesced a dispatch")
    p.add_argument("--mesh-devices", type=int, default=1,
                   help="shard the planned engine's lane axis over a mesh "
                        "of N devices (qsm_tpu_torch/mesh): N cards, or N "
                        "logical host devices with --device cpu; plans get "
                        "mesh-divisible buckets and the batcher's flush "
                        "target rounds to mesh multiples so one dispatch "
                        "fills the whole mesh; verdicts are bit-identical "
                        "at any N; more than the machine's cards raises")
    p.add_argument("--flush-ms", type=float, default=20.0,
                   help="micro-batch flush interval (latency floor for "
                        "a lone client)")
    p.add_argument("--queue-depth", type=int, default=1024,
                   help="admission bound on in-flight history lanes; "
                        "past it requests are SHED")
    p.add_argument("--cache", default=None,
                   help="persistent verdict-cache bank path (JSONL; "
                        "survives kill/restart)")
    p.add_argument("--cache-entries", type=int, default=4096)
    p.add_argument("--warm", default=None,
                   help="comma list of models to pre-build engines for")
    p.add_argument("--no-pcomp", action="store_true",
                   help="disable per-key request splitting")
    p.add_argument("--trace-log", default=None, metavar="PATH",
                   help="emit request-scoped span events to this JSONL "
                        "log (`trace <id> --log PATH` renders one)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="enable the flight recorder's dumps under DIR")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="serve Prometheus metrics on GET /metrics at "
                        "this port (0 = ephemeral; printed in the "
                        "serving line)")
    p.add_argument("--node-id", default=None, metavar="ID",
                   help="node id stamped on every response")
    p.add_argument("--replog-dir", default=None, metavar="DIR",
                   help="bank verdicts in the segmented log "
                        "(fleet/replog.py) instead of --cache's single "
                        "file, and serve the replog.* ops")
    p.add_argument("--replog-seal-rows", type=int, default=256,
                   help="rows a sealed replog segment")
    p.add_argument("--peers", default=None, metavar="A,B",
                   help="comma-separated peer node addresses for "
                        "node-to-node gossip anti-entropy "
                        "(fleet/gossip.py; needs --replog-dir): banked "
                        "verdicts keep converging with every router "
                        "dead")
    p.add_argument("--gossip-s", type=float, default=2.0,
                   help="gossip beat seconds (with --peers; 0 = the "
                        "agent exists but only the gossip.peers op "
                        "drives it)")
    p.add_argument("--gossip-fanout", type=int, default=2,
                   help="random peers contacted per gossip beat")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="SLO objectives, e.g. "
                        "'check=250ms:p99,shed_rate<0.01' (obs/slo.py): "
                        "burn-rate gauges, the `health` op, and the "
                        "slo.breach flight trigger")
    p.add_argument("--session-dir", default=None, metavar="DIR",
                   help="durable monitor sessions (monitor/store.py)")
    p.add_argument("--max-sessions", type=int, default=256,
                   help="live monitor-session slots")
    p.add_argument("--lease-host", default=None, metavar="PATH",
                   help="host the fleet HA lease on this node: serve "
                        "the lease.* ops over a FileLeaseStore at "
                        "PATH, so routers on OTHER hosts point "
                        "--lease-store tcp://this-node at it "
                        "(fleet/lease.py)")
    p.add_argument("--slo-window", type=float, default=60.0,
                   help="SLO sliding-window seconds")
    p.add_argument("--devq-dir", default=None, metavar="DIR",
                   help="persistent device-work queue (devq/): every "
                        "plane banks device-worthy work under DIR; a "
                        "DrainScheduler drains it; serves devq.put / "
                        "digests / pull / drain_report")
    p.add_argument("--devq-cap", type=int, default=512,
                   help="pending device-work items kept (lowest-score "
                        "eviction past the cap)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "submit",
        help="submit a trace file (the `check` format) to a running "
             "check server")
    p.add_argument("--addr", required=True,
                   help="server address: host:port or a UNIX socket "
                        "path; a comma list (a,b) fails over")
    p.add_argument("--trace", required=True)
    p.add_argument("--model", default=None, choices=sorted(MODELS),
                   help="overrides the trace's own 'model' field")
    p.add_argument("--witness", action="store_true",
                   help="include verified linearization orders")
    p.add_argument("--deadline", type=float, default=None,
                   help="per-request deadline seconds (default: the "
                        "'serve' policy preset); past it the server "
                        "answers SHED")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="client-side response bound")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser(
        "health",
        help="SLO health of a running server (exit 0 ok / 1 degraded / "
             "2 breach / 3 unreachable)")
    p.add_argument("--addr", required=True,
                   help="server address (a,b = multi-address failover)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="client-side response bound")
    p.set_defaults(fn=cmd_health)

    p = sub.add_parser(
        "fleet",
        help="run a multi-node fleet: N CheckServer nodes behind a "
             "fault-tolerant router (fleet/; nodes and the router's "
             "ladder on the card unless --device cpu)")
    p.add_argument("--nodes", type=int, default=2,
                   help="local node processes to spawn (ignored with "
                        "--addrs)")
    p.add_argument("--addrs", default=None,
                   help="comma-separated addresses of nodes you "
                        "started yourself (host:port or unix paths)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="router TCP port (0 = ephemeral, printed)")
    p.add_argument("--unix", default=None,
                   help="router UNIX socket path instead of TCP")
    _add_device(p)
    p.add_argument("--workers", type=int, default=0,
                   help="worker processes per spawned node "
                        "(serve --workers; needs --device cpu)")
    p.add_argument("--warm", default=None,
                   help="comma-separated models each spawned node "
                        "warms at start")
    p.add_argument("--replog-root", default=None, metavar="DIR",
                   help="root directory for spawned nodes' segmented "
                        "verdict logs (default: a temp dir)")
    p.add_argument("--session-root", default=None, metavar="DIR",
                   help="give each spawned node a durable session "
                        "store under DIR/<node-id> (serve "
                        "--session-dir): sessions survive node "
                        "restarts and cap eviction")
    p.add_argument("--devq-root", default=None, metavar="DIR",
                   help="give each spawned node a persistent device-"
                        "work queue under DIR/<node-id> (serve "
                        "--devq-dir); with gossip on, banked work "
                        "converges fleet-wide")
    p.add_argument("--session-journal", default=None, metavar="DIR",
                   help="durable ROUTER session journals "
                        "(monitor/store.py): point the active and "
                        "standby routers at the SAME dir (like "
                        "--lease-store) and a takeover rehydrates "
                        "sessions the standby never served, replaying "
                        "them onto the ring")
    p.add_argument("--max-sessions", type=int, default=256,
                   help="per-spawned-node live session slots (serve "
                        "--max-sessions; memory bound when "
                        "--session-root is set)")
    p.add_argument("--queue-depth", type=int, default=4096,
                   help="router admission bound (lanes in flight)")
    p.add_argument("--quarantine-after", type=int, default=3,
                   help="consecutive failed probes before a node is "
                        "quarantined one-way (re-admitted on "
                        "sustained health)")
    p.add_argument("--heartbeat-s", type=float, default=1.0,
                   help="membership probe beat seconds")
    p.add_argument("--anti-entropy-s", type=float, default=3.0,
                   help="anti-entropy sweep interval seconds (0 = "
                        "off)")
    p.add_argument("--trace-log", default=None, metavar="PATH",
                   help="router span log (`trace <id>` shows "
                        "router->node hops)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="router flight-recorder dumps (node death/"
                        "quarantine/partition)")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="router Prometheus /metrics port (per-node "
                        "health + traffic series)")
    p.add_argument("--lease-path", "--lease-store", dest="lease_path",
                   default=None, metavar="STORE",
                   help="router-HA lease store (fleet/lease.py): run "
                        "several `fleet` routers with the SAME fleet "
                        "config and lease store — one wins active "
                        "(term-stamped responses), the rest stand by "
                        "and take over on lease expiry; clients ride "
                        "it with a comma --addr list.  A filesystem "
                        "path flocks a local record; tcp://HOST:PORT "
                        "speaks the lease.* ops to a node started "
                        "with --lease-host, so routers span hosts")
    p.add_argument("--lease-ttl-s", type=float, default=3.0,
                   help="lease TTL seconds (renewed each beat; a dead "
                        "active is superseded within ~1.5x this)")
    p.add_argument("--router-id", default="router",
                   help="this router's id (the lease holder name and "
                        "the `node` stamp on router-answered "
                        "responses)")
    p.add_argument("--gossip-s", type=float, default=2.0,
                   help="wire spawned/fronted nodes for node-to-node "
                        "gossip anti-entropy at this beat (0 = off): "
                        "replication then survives every router dying")
    p.add_argument("--collect-dir", default=None, metavar="DIR",
                   help="fleet-wide span collection (obs/collect.py): "
                        "the router's beat scrapes every node's span "
                        "log into DIR/collected.jsonl — `trace <id> "
                        "--addr ROUTER` then renders the full "
                        "cross-process causal tree; spawned nodes get "
                        "--trace-log automatically")
    p.add_argument("--collect-s", type=float, default=1.0,
                   help="span-collection sweep interval seconds")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="router SLO objectives (serve --slo grammar) "
                        "over route latency + sheds; `health --addr "
                        "ROUTER` folds every node's health in")
    p.add_argument("--slo-window", type=float, default=60.0,
                   help="SLO sliding-window seconds")
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "soak",
        help="chaos soak of durable sessions (gen/soak.py): spawn a "
             "3-node fleet + active/standby routers, hold N monitor "
             "sessions open through rolling node restarts, a SIGKILL "
             "of the active router and one node leave/join, every "
             "verdict re-proved by a fresh memo oracle")
    p.add_argument("--sessions", type=int, default=1000,
                   help="concurrent monitor sessions held open "
                        "through the fault schedule")
    p.add_argument("--ops", type=int, default=12,
                   help="events per session stream")
    p.add_argument("--model", default="register", choices=sorted(MODELS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8,
                   help="client threads driving the session verbs")
    p.add_argument("--max-sessions", type=int, default=256,
                   help="per-node live session slots (the memory "
                        "bound; the durable store holds the rest)")
    p.add_argument("--lease-ttl-s", type=float, default=1.0)
    p.add_argument("--fuzz-rounds", type=int, default=2,
                   help="closed-loop fuzz rounds run against the "
                        "surviving router mid-soak (0 = skip)")
    p.add_argument("--run-dir", default=None, metavar="DIR",
                   help="keep the fleet's replogs/session stores/"
                        "lease here (default: a temp dir, removed)")
    p.add_argument("--faults", default=None, metavar="SPEC",
                   help="QSM_TPU_FAULTS grammar injected into every "
                        "spawned node (resilience/faults.py), e.g. "
                        "'raise:serve:0.01' — the rig's retry riders "
                        "must still land every verb exactly once")
    _add_device(p)
    p.set_defaults(fn=cmd_soak)

    p = sub.add_parser(
        "trace",
        help="reconstruct one request's causal tree from a span log "
             "(docs/OBSERVABILITY.md)")
    p.add_argument("trace_id",
                   help="the trace id whose events to render")
    p.add_argument("--log", default=None,
                   help="a local span-log path (its .1 rotation "
                        "predecessor is read too)")
    p.add_argument("--addr", default=None,
                   help="ask a running server for the trace (its "
                        "obs.trace op; a,b = multi-address failover)")
    p.add_argument("--follow", action="store_true",
                   help="keep polling and print each NEW event of the "
                        "trace as it lands (stops after --max-idle quiet "
                        "seconds)")
    p.add_argument("--interval", type=float, default=0.5,
                   help="--follow poll interval seconds")
    p.add_argument("--max-idle", type=float, default=30.0,
                   help="--follow: stop after this many seconds without "
                        "a new event")
    p.add_argument("--json", action="store_true",
                   help="print the raw event list instead of the tree")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "ingest",
        help="decode a Jepsen/Knossos- or porcupine-style event log into "
             "a `check` trace document")
    p.add_argument("trace", help="the event-log file (EDN maps, one "
                                 "event per line)")
    p.add_argument("--format", required=True,
                   choices=("jepsen", "porcupine"))
    p.add_argument("--spec", required=True, choices=sorted(MODELS),
                   help="the model the trace's ops map onto "
                        "(ingest/specmap.py owns the vocabulary)")
    p.add_argument("--spec-kwargs", default=None,
                   help="JSON spec constructor kwargs (e.g. "
                        "'{\"n_keys\": 8}')")
    p.add_argument("--out", default=None,
                   help="write the decoded trace document here "
                        "(default: stdout)")
    p.add_argument("--check", action="store_true",
                   help="decide it (exit 0/1/2 = linearizable/violation/"
                        "undecided): the planned checker on the card, or "
                        "the host ladder with --device cpu")
    p.add_argument("--submit", default=None, metavar="ADDR",
                   help="submit to a running check server instead "
                        "(exit codes as `submit`)")
    p.add_argument("--witness", action="store_true",
                   help="with --submit: ask for the linearization")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="client-side response bound (--submit)")
    p.add_argument("--emit", action="store_true",
                   help="re-render the canonical log text (the "
                        "byte-stable round trip) instead of JSON")
    _add_device(p)
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser(
        "monitor",
        help="tail a growing event log into a live in-process monitor "
             "session: a verdict flip prints the minimised repro the "
             "moment it is decidable (docs/MONITOR.md)")
    p.add_argument("trace", help="the event-log file to tail")
    p.add_argument("--format", required=True,
                   choices=("jepsen", "porcupine"))
    p.add_argument("--spec", required=True, choices=sorted(MODELS))
    p.add_argument("--spec-kwargs", default=None)
    p.add_argument("--addr", default=None,
                   help="a running check server to serve the session "
                        "(the session.* ops; exit 3 on shed or error)")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="client-side response bound (--addr)")
    p.add_argument("--session", default=None,
                   help="the session id (default: local)")
    p.add_argument("--follow", action="store_true",
                   help="keep tailing as the file grows (stops after "
                        "--max-idle quiet seconds)")
    p.add_argument("--max-idle", type=float, default=30.0)
    p.add_argument("--witness", action="store_true",
                   help="with --addr: ask for the whole-stream witness at "
                        "close")
    p.add_argument("--save", default=None,
                   help="write the flip's minimised repro here as a "
                        "`check`-format trace file")
    p.add_argument("--deadline", type=float, default=None,
                   help="seconds for the flip's shrink")
    _add_device(p)
    p.set_defaults(fn=cmd_monitor)

    args = ap.parse_args(argv)
    return args.fn(args)
