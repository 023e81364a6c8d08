"""``CheckServer``: long-lived, warm, batched linearizability checking.

The counterpart of the JAX package's ``qsm_tpu/serve/server.py``, with
its handlers, wire format and counters: admission, cross-request
micro-batching, one warm engine a spec behind ``FailoverBackend``, the
verdict cache (optionally the segmented bank of ``fleet/replog.py``),
the shrink verb, monitor sessions, the observability and SLO surface,
the device-work queue's ops, and an optional pool of host worker
processes (``serve/pool.py``).

Where the card needs another design than the reference's:

* **The engine runs on the card.**  ``device=None`` means CUDA, and both
  engine names build the planned checker
  (``build_backend(spec, plan_search(spec, platform="cuda"))``) behind
  ``FailoverBackend``; ``start()`` raises ``BackendUnavailable`` without
  a card.  With ``device="cpu"``, ``"auto"`` is the reference's host
  ladder and ``"planned"`` the CPU plan, and the responses are the
  reference's.
* **BUDGET resolution** asks whether the engine is the host ladder (its
  searches all run in host checkers), not what the engine is called:
  every BUDGET lane of any other engine is resolved, by the exact host
  ladder (per key where the projection validates) rather than the
  reference's memo oracle; the verdicts are the same.
* **No fallback that hides the card.**  A batch's dispatch degrades to an
  emergency host ladder only on what ``resilience/failover.py::
  degradable_errors`` allows: on the card, an injected fault
  (``raise:serve``, ``hang:serve``, or one injected inside).  A real
  device error answers the batch's requests ``ok: false`` with the
  error's name, is counted in ``serve_faults`` and reported to the
  observability sink, and is never re-decided on the host.
* **One watchdog worker.**  A dispatch runs on the process' one dispatch
  watchdog worker (``failover.watched_call``), on the caller's stream,
  not on a new thread a dispatch.
* **One lock an engine.**  Every launch on an engine holds its entry's
  ``dispatch_lock``; the monitor sessions' window re-checks have their
  own engines and lock (``monitor/frontier.py::WindowEngines``).
* **Pool workers are host processes**: ``workers > 0`` needs
  ``device="cpu"``.
* **A device error says so on the wire.**  A check, shrink or session
  answer that failed on the card carries ``device_error`` beside its
  ``error``, so a fleet router (``fleet/router.py``) answers it and
  never re-decides it on its host ladder.

The fleet tier's node side is the reference's: node-to-node gossip
(``peers=``, ``gossip_s=``, the ``gossip.peers`` op) and lease hosting
(``lease_path=``, the ``lease.*`` ops).  A lane-axis mesh
(``mesh_devices > 1``, ``qsm_tpu_torch/mesh/``) is the reference's: the
planned engine is built by a mesh-sized plan over that many cards (or
logical host devices with ``device="cpu"``), the batcher's flush width
rounds up to a multiple of the mesh, and it is exclusive with
``workers > 0``.  A machine with fewer cards raises at :meth:`start`.

Wire protocol: ``serve/protocol.py`` (JSON lines over TCP or a UNIX
socket).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.history import History
from ..obs import Observability, new_span_id, new_trace_id
from ..obs import global_obs, set_global
from ..ops.backend import DeviceDispatchError, Verdict, resolve_device
from ..resilience.failover import (FailoverBackend, _engine_leaves,
                                   budget_resolver, collect_resilience,
                                   cuda_device, degradable_errors,
                                   host_fallback, host_only,
                                   resolve_budget_lanes, watched_call)
from ..resilience.faults import fired_snapshot, inject
from ..resilience.policy import RetryPolicy, preset
from ..search.stats import collect_search_stats, stats_delta
from .admission import AdmissionController
from .batcher import Lane, MicroBatcher
from .cache import VerdictCache, fingerprint_key
from .protocol import (VERDICT_NAMES, LineChannel, history_to_rows,
                       rows_to_history, send_doc)


def _error_text(e: BaseException) -> str:
    if isinstance(e, DeviceDispatchError):
        return str(e)
    return f"{type(e).__name__}: {e}"


def _answer_device_error(doc: dict, e: BaseException) -> dict:
    """``doc`` (an ``ok: false`` answer) with ``device_error`` when
    ``e`` is a failure on the card, so a router can tell it from a bad
    request."""
    if isinstance(e, DeviceDispatchError):
        return {**doc, "device_error": str(e)}
    return doc


def _batch_error(batches) -> Optional[str]:
    """The device error of the first batch that failed on the card, if
    any (a batch the batcher could not dispatch at all keeps the
    reference's answer: its lanes undecided, ``error`` on its stamp)."""
    return next((b["device_error"] for b in batches
                 if b.get("device_error")), None)


def host_ladder(engine) -> bool:
    """True iff every search under ``engine`` runs in a host checker
    (the native or the memoised oracle), the reference's ``auto``
    engine: re-running its BUDGET lanes on the oracle only repeats the
    search.  A torch engine on the CPU is not the ladder."""
    from ..native import CppOracle
    from ..ops.wing_gong_cpu import WingGongCPU

    return all(isinstance(x, (CppOracle, WingGongCPU))
               for x in _engine_leaves(engine))


class _EngineEntry:
    """One warm spec: engine + witness oracle + planner provenance.

    ``dispatch_lock`` serializes in-process dispatches on this entry:
    engines are stateful (memo tables, search counters) and NOT
    thread-safe — with one batcher thread (workers=0) the lock is
    uncontended, and with a worker pool it guards the fallback path
    (quarantined spec / exhausted pool), where several dispatcher
    threads may otherwise hit the same engine concurrently.

    ``proj`` / ``proj_group_key`` carry the spec's VALIDATED per-key
    projection (ops/pcomp.py): the projected spec instance whose
    fingerprints key the per-sub-history cache rows, and the batcher
    group sub-lanes flatten into (the projected spec's own group — a
    kv-256 request and a plain register request share one engine and
    one micro-batch stream).  None when the spec does not decompose.
    ``pcomp`` is the lazy witness-path combinator."""

    __slots__ = ("spec", "engine", "oracle", "plan_why", "emergency",
                 "dispatch_lock", "proj", "proj_group_key", "pcomp",
                 "on_card", "cuda", "host_ladder", "resolver")

    def __init__(self, spec, engine, oracle, plan_why,
                 proj=None, proj_group_key=None):
        self.spec = spec
        self.engine = engine
        self.oracle = oracle
        self.plan_why = plan_why
        self.emergency = None  # built on first serve-site fault
        self.dispatch_lock = threading.Lock()
        self.proj = proj
        self.proj_group_key = proj_group_key
        self.pcomp = None  # built on first decomposed witness request
        # the card's rule (module docstring), decided once an engine
        self.on_card = not host_only(engine)
        # the stream hand-off and the kernels' prebuild need a card
        self.cuda = cuda_device(engine) if torch.cuda.is_available() \
            else None
        self.host_ladder = host_ladder(engine)
        self.resolver = None  # built on the first BUDGET lane to resolve



class _SubJoin:
    """Recombine per-key sub-lane verdicts into ONE whole-history verdict
    — the PComp aggregation rule (VIOLATION beats BUDGET_EXCEEDED beats
    LINEARIZABLE) — across cache hits, batch dispatches and aborts.
    Thread-safe: feeds arrive from the connection thread (hits) and any
    dispatcher thread (batch resolutions)."""

    def __init__(self, n: int, on_complete):
        self._lock = threading.Lock()
        self._n = n
        self._fed = 0
        self._worst = int(Verdict.LINEARIZABLE)
        self._batch: Optional[dict] = None
        self._on_complete = on_complete

    def feed(self, verdict: int, batch: Optional[dict] = None) -> None:
        with self._lock:
            if batch is not None and not (self._batch or {}).get(
                    "device_error"):
                # a batch that failed on the card wins: the join's
                # request must answer its error
                self._batch = batch
            v = int(verdict)
            if v == int(Verdict.VIOLATION):
                self._worst = v
            elif (v == int(Verdict.BUDGET_EXCEEDED)
                  and self._worst == int(Verdict.LINEARIZABLE)):
                self._worst = v
            self._fed += 1
            fire = self._fed == self._n
            worst, b = self._worst, self._batch
        if fire:
            self._on_complete(worst, b)

    def resolver(self):
        def _resolve(verdict: int, batch: dict) -> None:
            self.feed(verdict, batch)

        return _resolve

    def abort(self, k: int) -> None:
        """Feed BUDGET_EXCEEDED for ``k`` sub-lanes that will never
        dispatch (mid-request shed): the join still completes once the
        in-flight remainder resolves, so the lane's admission slot
        releases and nothing leaks."""
        for _ in range(k):
            self.feed(int(Verdict.BUDGET_EXCEEDED))


class _PendingRequest:
    """Per-request lane accounting: connection thread waits, cache hits
    and batch dispatches resolve."""

    def __init__(self, n: int):
        self._lock = threading.Lock()
        self._remaining = n
        self.verdicts: List[Optional[int]] = [None] * n
        self.cached: List[bool] = [False] * n
        self.witnesses: List[Optional[list]] = [None] * n
        self.lane_submitted: List[bool] = [False] * n  # batcher owns it
        self.batches: List[dict] = []
        self.dead = False  # shed: late resolutions are cache-only
        self._done = threading.Event()
        if n == 0:
            self._done.set()

    def resolve(self, i: int, verdict: int, cached: bool = False,
                witness: Optional[list] = None,
                batch: Optional[dict] = None) -> None:
        with self._lock:
            if self.verdicts[i] is not None:
                return
            self.verdicts[i] = int(verdict)
            self.cached[i] = cached
            self.witnesses[i] = witness
            if batch is not None and batch.get("batch") not in {
                    b.get("batch") for b in self.batches}:
                self.batches.append(batch)
            self._remaining -= 1
            if self._remaining == 0:
                self._done.set()

    def wait(self, timeout_s: float) -> bool:
        return self._done.wait(max(0.0, timeout_s))


class CheckServer:
    """See module docstring.  ``start()`` binds and returns; the accept
    loop, connection readers and the batcher run on daemon threads."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 unix_path: Optional[str] = None, *,
                 engine: str = "auto",
                 max_lanes: int = 64, flush_s: float = 0.02,
                 queue_depth: int = 1024,
                 cache_path: Optional[str] = None,
                 cache_entries: int = 4096,
                 policy: Optional[RetryPolicy] = None,
                 allow_shutdown: bool = True,
                 engine_factory=None,
                 workers: int = 0,
                 worker_policy: Optional[RetryPolicy] = None,
                 quarantine_after: int = 2,
                 pcomp: bool = True,
                 trace_log: Optional[str] = None,
                 flight_dir: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 obs: Optional[Observability] = None,
                 node_id: Optional[str] = None,
                 replog_dir: Optional[str] = None,
                 replog_seal_rows: int = 256,
                 peers: Optional[list] = None,
                 gossip_s: float = 0.0,
                 gossip_fanout: int = 2,
                 max_sessions: int = 256,
                 session_events: int = 65_536,
                 session_states: int = 64,
                 session_budget: int = 2_000_000,
                 session_dir: Optional[str] = None,
                 lease_path: Optional[str] = None,
                 slo: Optional[str] = None,
                 slo_window_s: float = 60.0,
                 devq_dir: Optional[str] = None,
                 devq_cap: int = 512,
                 mesh_devices: int = 1,
                 device=None):
        if engine not in ("auto", "planned"):
            raise ValueError(f"unknown serve engine {engine!r}; "
                             "one of ('auto', 'planned')")
        self.device = device
        self.on_cpu = device is not None and str(device) == "cpu"
        if workers and int(mesh_devices) > 1:
            # two fan-outs that exclude each other: pool workers run host
            # ladders (nothing to shard); the mesh belongs to the planned
            # engine in this process
            raise ValueError("workers>0 and mesh_devices>1 are exclusive "
                             "fan-outs (the pool runs host engines)")
        if workers and not self.on_cpu:
            # pool workers are host processes running the host ladder;
            # a card's engine lives in this process (the reference's
            # parallel rule: workers need engine='auto')
            raise ValueError("workers>0 requires device='cpu' (pool "
                             "workers run the host cpp->memo ladder)")
        if workers and engine != "auto":
            raise ValueError("workers>0 requires engine='auto' (pool "
                             "workers run the host cpp->memo ladder)")
        self.host, self.port, self.unix_path = host, port, unix_path
        self.engine_kind = engine
        # the planned engine's lane-axis mesh width: > 1 plans
        # mesh-divisible buckets with a sharded engine, and the batcher
        # rounds its flush target to mesh multiples so that one flush
        # fills every device
        self.mesh_devices = max(1, int(mesh_devices))
        self.policy = policy or preset("serve")
        self.max_lanes = max_lanes
        self.allow_shutdown = allow_shutdown
        self._engine_factory = engine_factory
        # observability plane (obs, docs/OBSERVABILITY.md):
        # metrics are ALWAYS live; span emission + the flight ring are
        # opt-in via trace_log/flight_dir and every emit site below
        # guards on obs.on — the tracing-off serve path must stay
        # within noise of a no-obs build
        self.obs = obs if obs is not None else Observability(
            trace_log=trace_log, flight_dir=flight_dir)
        self.metrics_port = metrics_port
        self._metrics_server = None
        self._m_request_s = self.obs.metrics.histogram(
            "qsm_serve_request_seconds",
            "end-to-end request latency (admission to response), "
            "labeled by verb")
        self.obs.metrics.register_collector(self._metric_samples)
        # SLO plane (obs/slo.py, docs/OBSERVABILITY.md "Fleet"):
        # declared objectives evaluated over sliding windows of the
        # SAME per-verb latency histogram and shed counters /metrics
        # exposes; the health op reads it and an ok->breach transition
        # emits the slo.breach flight-dump trigger
        self.slo = None
        if slo:
            from ..obs import SloEvaluator, parse_slo

            self.slo = SloEvaluator(
                parse_slo(slo), latency_hist=self._m_request_s,
                requests_fn=lambda: self.requests,
                sheds_fn=self._shed_total, window_s=slo_window_s,
                on_breach=self._on_slo_breach)
            self.obs.metrics.register_collector(self.slo.metric_samples)
        self.n_workers = max(0, int(workers))
        self.pool = None
        if self.n_workers:
            from .pool import WorkerPool

            self.pool = WorkerPool(self.n_workers, policy=worker_policy,
                                   quarantine_after=quarantine_after,
                                   obs=self.obs)
        # fleet tier (fleet): the node id stamps every response
        # (a router-merged answer says which node decided which lanes),
        # and replog_dir swaps the single-file bank for the segmented
        # replicated log so this node can serve the replog.* anti-
        # entropy ops (docs/SERVING.md "Fleet")
        self.node_id = node_id
        self.replog = None
        if replog_dir is not None:
            if cache_path is not None:
                # refuse, don't silently pick: --cache's single file
                # would never be written (or loaded) once the store
                # owns persistence, and prior banked verdicts in it
                # would be silently abandoned
                raise ValueError(
                    "cache_path and replog_dir are mutually exclusive "
                    "banks; the segmented replog replaces the single "
                    "file (migrate by serving once from --cache, then "
                    "re-banking under --replog-dir)")
            from ..fleet.replog import SegmentedLog

            self.replog = SegmentedLog(replog_dir,
                                       node_id=node_id or "n0",
                                       seal_rows=replog_seal_rows)
        self.cache = VerdictCache(max_entries=cache_entries,
                                  path=cache_path, store=self.replog)
        # device-work queue (devq, docs/WINDOWS.md): with a
        # devq_dir this node banks device-worthy work — its own seams
        # (oversize admission, the pcomp split, shrink rounds, monitor
        # appends reach it through the process-global hook) plus the
        # devq.* wire ops, so ANY fleet node can bank work this or some
        # other node's window later drains.  The queue rides its own
        # SegmentedLog (a second replog row domain); gossip grows a
        # devq exchange leg when both are configured.
        self.devq = None
        self.devq_report: Optional[dict] = None  # last drained window
        if devq_dir is not None:
            from ..devq import DeviceWorkQueue, set_global_devq

            self.devq = DeviceWorkQueue(devq_dir,
                                        node_id=node_id or "n0",
                                        cap=devq_cap)
            set_global_devq(self.devq)
        # peer-to-peer anti-entropy (fleet/gossip.py): with peers and
        # a replog, this node keeps its banked verdicts converging
        # with the fleet's NODE-TO-NODE — no router in the loop, so
        # replication survives every router being dead.  Peers come
        # from the ctor (static deploys) or the `gossip.peers` op
        # (`fleet` wires spawned nodes whose addresses are only known
        # after their banners).  Built after the queue, so a node with
        # both gossips its devq leg from the start.
        self.gossip = None
        self._gossip_interval = float(gossip_s)
        self._gossip_fanout = int(gossip_fanout)
        if self.replog is not None and peers:
            self._make_gossip(peers)
        # lease hosting (fleet/lease.py): with a lease_path this node
        # answers the lease.* ops, so routers on OTHER hosts share one
        # record through a TcpLeaseStore — the flock and the clock both
        # live here, keeping the single-authority safety argument of
        # the filesystem lease
        self.lease_store = None
        self.lease_ops = 0
        if lease_path is not None:
            from ..fleet.lease import FileLeaseStore

            self.lease_store = FileLeaseStore(lease_path)
        self.admission = AdmissionController(
            queue_depth=queue_depth, policy=self.policy,
            pool_state=self.pool.shed_state if self.pool else None)
        self.batcher = MicroBatcher(self._dispatch, max_lanes=max_lanes,
                                    flush_s=flush_s,
                                    queue_depth=max(queue_depth * 2, 64),
                                    concurrency=self.n_workers or 1,
                                    mesh_devices=self.mesh_devices)
        self._engines: Dict[str, _EngineEntry] = {}
        self._engines_lock = threading.Lock()
        self._engine_builds: Dict[str, threading.Lock] = {}
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        self._t0 = time.monotonic()
        self.requests = 0
        self.histories = 0
        self.serve_faults = 0       # serve-site degradations (batch level)
        # and real device errors answered ok: false (the card's rule)
        self.device_errors = 0      # of serve_faults: answered, not degraded
        self.padded_lanes = 0       # empty lanes padding flushes to width
        self.budget_resolved = 0    # engine BUDGET_EXCEEDED → oracle-exact
        # P-compositional split plane (ops/pcomp.py): long histories of
        # specs with a VALIDATED projection are split into per-key
        # sub-lanes that ride the projected spec's micro-batches, with
        # per-sub-history cache rows — a one-key change to a 512-op
        # history re-checks that key only (docs/PCOMP.md)
        self.pcomp_enabled = bool(pcomp)
        # counters below are written from concurrent connection threads
        # — guarded, because bench/tests compute per-request DELTAS from
        # stats() (one_key_change.recheck_keys) and a lost increment
        # would corrupt them (the QSM-RACE-UNGUARDED discipline)
        self._pcomp_lock = threading.Lock()
        self.pcomp_split = 0        # request histories decomposed
        self.pcomp_subs = 0         # sub-lanes produced from them
        self.pcomp_sub_hits = 0     # sub-lanes answered from the cache
        # Shrink verb (shrink, docs/SHRINK.md): a failing
        # history submitted as {"op": "shrink"} is minimized with its
        # frontier candidates riding the SAME micro-batch lanes as
        # paying check traffic (and banking in the same verdict cache),
        # and the minimized result banks under the original history's
        # fingerprint so duplicate shrink requests answer O(1)
        self._shrink_lock = threading.Lock()
        self._shrink_bank: "OrderedDict[str, dict]" = OrderedDict()
        self.shrink_bank_entries = 1024
        self.shrink_requests = 0
        self.shrink_bank_hits = 0
        self.shrink_rounds = 0      # frontier rounds across all requests
        self.shrink_lanes = 0      # candidate lanes those rounds carried
        self.shrink_memo_hits = 0  # candidates answered without checking
        # Monitor sessions (monitor, docs/MONITOR.md): clients
        # stream invocation/response events through the session.* ops;
        # per-session incremental frontiers bank decided prefixes in
        # THE verdict cache (prefix fingerprints — a node restart
        # resumes from the bank), and a verdict flip is answered the
        # moment it is decidable with a shrink-plane-minimized repro.
        # the session manager's window re-checks run on their own
        # engines (CUDA unless device="cpu"); built here on the CPU, at
        # start() on the card, after the device resolved
        self._monitor_kw = dict(
            bank=self.cache, max_sessions=max_sessions,
            max_events=session_events, node_budget=session_budget,
            max_states=session_states, session_dir=session_dir)
        self.monitor = self._make_monitor() if self.on_cpu else None

    def _make_monitor(self):
        from ..monitor import SessionManager

        kw = dict(self._monitor_kw)
        session_dir = kw.pop("session_dir")
        # ``session_dir`` makes sessions durable (monitor/store.py):
        # restart-or-evicted sids resume from the snapshot+journal
        # substrate in O(doc) with zero engine folds
        session_store = None
        if session_dir is not None:
            from ..monitor import SessionStore

            session_store = SessionStore(session_dir)
        return SessionManager(store=session_store, device=self.device,
                              **kw)

    def _make_gossip(self, peers) -> None:
        from ..fleet.gossip import GossipAgent

        if self.gossip is None:
            self.gossip = GossipAgent(
                self.node_id or "n0", self.replog, self.cache,
                peers=peers, interval_s=self._gossip_interval,
                fanout=self._gossip_fanout, obs=self.obs,
                devq=self.devq)
        else:
            self.gossip.set_peers(peers)

    # -- lifecycle -----------------------------------------------------
    @property
    def address(self) -> str:
        if self.unix_path:
            return self.unix_path
        return f"{self.host}:{self.port}"

    def start(self) -> "CheckServer":
        # the port runs on the card unless asked for the CPU: no card,
        # no server (BackendUnavailable), never a silent move to the host
        if not self.on_cpu:
            resolve_device(self.device)
            if self.mesh_devices > 1:
                # a mesh wider than the machine's cards raises here, with
                # the count; the server never serves on fewer
                from ..mesh.topology import make_mesh

                make_mesh(self.mesh_devices, device=self.device)
            if self.monitor is None:
                self.monitor = self._make_monitor()
        if self.unix_path:
            try:
                os.unlink(self.unix_path)
            except OSError:
                pass
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(self.unix_path)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((self.host, self.port))
            self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._sock.settimeout(0.2)  # accept loop stays shutdown-checkable
        if self.pool is not None:
            self.pool.start()
        self.batcher.start()
        # install as the process-global obs sink so engine layers
        # without an obs handle (failover/hybrid degradations, the
        # fault plane) report into this server's trace/flight rails
        set_global(self.obs)
        if self.metrics_port is not None:
            from ..obs import MetricsServer

            # bound to the SERVE host (loopback for unix-socket
            # servers): the printed metrics address must be the one a
            # scraper can actually reach
            self._metrics_server = MetricsServer(
                self.obs.metrics,
                host=self.host if not self.unix_path else "127.0.0.1",
                port=self.metrics_port).start()
            self.metrics_port = self._metrics_server.port
        if self.gossip is not None:
            self.gossip.start()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="qsm-serve-accept")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        # the CLI stops twice by design (shutdown handler + finally);
        # teardown below is idempotent, but the post-mortem flight dump
        # must fire exactly once or every clean exit banks duplicates
        first_stop = not self._stop.is_set()
        self._stop.set()
        if not first_stop:
            # the first stop() often runs on a daemon handler thread
            # (the shutdown op); returning before it finishes lets the
            # CLI's finally-stop exit the process and kill that thread
            # MID-flight-dump — a torn FLIGHT .tmp.  Teardown below is
            # bounded (joins/waits all carry timeouts), so this is too.
            self._stopped.wait(15.0)
            return
        # order matters: the batcher drains FIRST (in-flight batches
        # still need the pool), THEN the pool tears down its worker
        # processes deterministically (exit frame → terminate → bounded
        # wait → kill escalation → reap) so no test or caller ever
        # leaks a child process
        self.batcher.stop()
        if self.gossip is not None:
            self.gossip.stop()
        if self.pool is not None:
            self.pool.stop()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self.unix_path:
            try:
                os.unlink(self.unix_path)
            except OSError:
                pass
        # the accept thread is retained, so its teardown is bounded:
        # the loop re-checks _stop every 0.2 s (settimeout) and the
        # closed socket breaks it immediately (QSM-THREAD-LIFECYCLE)
        for t in self._threads:
            t.join(2.0)
        self.cache.flush()
        # the post-mortem baseline dump: what was in flight at teardown
        # (forced — a stop() artifact must not be rate-limited away)
        if first_stop:
            self.obs.dump_flight("server_stop", force=True)
        # a caller-supplied Observability outlives this server: the
        # collector must go with the server or a reused registry
        # double-emits every serve series (and pins the dead server)
        self.obs.metrics.unregister_collector(self._metric_samples)
        if self.slo is not None:
            self.obs.metrics.unregister_collector(
                self.slo.metric_samples)
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if global_obs() is self.obs:
            set_global(None)
        if self.devq is not None:
            from ..devq import global_devq, set_global_devq

            if global_devq() is self.devq:
                set_global_devq(None)
        self.obs.close()
        self._stopped.set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the server stops (shutdown request / stop());
        True when it did."""
        return self._stop.wait(timeout_s)

    # -- engines -------------------------------------------------------
    def warm(self, model: str, spec_kwargs: Optional[dict] = None) -> None:
        """Build (and warm-dispatch) the engine for a spec up front so
        the first request pays nothing — in this process AND in every
        pool worker."""
        entry = self._engine_for(model, spec_kwargs or {})
        pad = [History([])] * self.max_lanes
        with entry.dispatch_lock:
            entry.engine.check_histories(entry.spec, pad)
        if self.pool is not None:
            self.pool.warm(model, spec_kwargs or {})

    def _spec_key(self, model: str, spec_kwargs: dict) -> str:
        return json.dumps([model, spec_kwargs or {}], sort_keys=True)

    def _engine_for(self, model: str, spec_kwargs: dict) -> _EngineEntry:
        key = self._spec_key(model, spec_kwargs)
        with self._engines_lock:
            entry = self._engines.get(key)
            if entry is not None:
                return entry
            build_lock = self._engine_builds.setdefault(
                key, threading.Lock())
        # construction happens OUTSIDE the global map lock (a planned
        # device build can take tens of seconds; warm specs' lookups and
        # the batcher's dispatch must not block behind it) but under a
        # per-key lock so each spec still gets exactly ONE engine — the
        # resilience/search counters aggregate per instance
        with build_lock:
            with self._engines_lock:
                entry = self._engines.get(key)
                if entry is not None:
                    return entry
            entry = self._build_engine(model, spec_kwargs)
            with self._engines_lock:
                self._engines[key] = entry
            return entry

    def _build_engine(self, model: str, spec_kwargs: dict) -> _EngineEntry:
        from ..models.registry import MODELS, make
        from ..ops.wing_gong_cpu import WingGongCPU
        from ..search.planner import plan_search

        spec, _ = make(model, "atomic", spec_kwargs or None)
        if self._engine_factory is not None:
            inner, plan_why = self._engine_factory(spec), ["injected"]
        elif not self.on_cpu:
            # the card: both engine names are the planned checker (a
            # host ladder here would be the fallback that hides the card)
            from ..search.planner import build_backend

            plan = plan_search(spec, platform="cuda",
                               mesh_devices=self.mesh_devices)
            inner = build_backend(spec, plan, device=self.device)
            plan_why = list(plan.why) + [
                f"engine={self.engine_kind} on cuda: the planned checker "
                "(the port serves on the card unless device='cpu')"]
        elif self.engine_kind == "planned":
            # the CPU plan, its kernels' plain versions
            from ..search.planner import build_backend

            plan = plan_search(spec, platform="cpu",
                               mesh_devices=self.mesh_devices)
            inner = build_backend(spec, plan, device="cpu")
            plan_why = list(plan.why)
        else:
            # today's fast path: the exact host ladder (native C++
            # when the toolchain builds, else the memoised oracle),
            # warm and shared.  The plan is still computed for its
            # provenance — the response's `why` says what a device
            # plan WOULD do for this spec.
            plan = plan_search(spec, platform="cpu")
            inner, plan_why = host_fallback(spec), list(plan.why)
        engine = FailoverBackend(spec, inner)
        oracle = WingGongCPU(memo=True)
        proj = proj_group = None
        if self.pcomp_enabled:
            from ..core.spec import projection_report

            problems = projection_report(spec)
            if not problems:
                p = spec.projected_spec()
                if p.name in MODELS:
                    # dispatchable: sub-lanes rebuild this spec from its
                    # registry name in the supervisor AND in every pool
                    # worker, so split traffic rides the pool unchanged
                    proj = p
                    proj_group = self._spec_key(p.name, p.spec_kwargs())
                else:
                    plan_why.append(
                        f"pcomp=off (projected spec {p.name!r} is not a "
                        "registry model; sub-lanes would be "
                        "undispatchable)")
            else:
                # the refusal path, stamped: an invalid projection must
                # never split silently — the whole-history plan serves
                plan_why.append(f"pcomp=off (refused: {problems[0]})")
        return _EngineEntry(spec, engine, oracle, plan_why,
                            proj=proj, proj_group_key=proj_group)

    # -- accept / connection plumbing ----------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # socket closed by stop()
            # daemon, never joined, and NOT retained: a long-lived
            # server accepting one connection per stats poll would
            # otherwise grow an unbounded thread list — the same
            # accumulation hazard the QSM-SERVE-UNBOUNDED lint exists
            # for, at the object level
            threading.Thread(target=self._serve_connection,
                             args=(conn,), daemon=True,
                             name="qsm-serve-conn").start()

    def _serve_connection(self, conn: socket.socket) -> None:
        chan = LineChannel(conn)
        try:
            while not self._stop.is_set():
                line = chan.read_line(stop=self._stop.is_set)
                if line is None:
                    return
                try:
                    req = json.loads(line)
                except ValueError:
                    self._send(conn, {"ok": False, "error": "bad json"})
                    continue
                self._handle(conn, req)
                if req.get("op") == "shutdown" and self.allow_shutdown:
                    return
        except OSError:
            pass  # peer went away mid-response
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, conn: socket.socket, doc: dict) -> None:
        """THE response egress: a fleet node stamps its ``node`` id on
        every response (ok/SHED/error alike) so a router-merged answer
        — and a flight dump, and a trace — can say which node decided
        which lanes (docs/SERVING.md "Fleet")."""
        if self.node_id is not None and "node" not in doc:
            doc = {**doc, "node": self.node_id}
        send_doc(conn, doc)

    def _handle(self, conn: socket.socket, req: dict) -> None:
        op = req.get("op", "check")
        if op == "stats":
            self._send(conn, {"ok": True, "stats": self.stats()})
        elif op in ("obs.spans", "obs.trace", "obs.metrics", "health"):
            try:
                self._handle_obs(conn, op, req)
            except OSError:
                raise
            except Exception as e:  # noqa: BLE001 — answer, don't die
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "error": f"{type(e).__name__}: {e}"})
        elif op in ("replog.digests", "replog.pull", "replog.push",
                    "replog.covers", "replog.subsumed"):
            self._handle_replog(conn, op, req)
        elif op in ("devq.put", "devq.digests", "devq.pull",
                    "devq.drain_report"):
            try:
                self._handle_devq(conn, op, req)
            except OSError:
                raise
            except Exception as e:  # noqa: BLE001 — answer, don't die
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "error": f"{type(e).__name__}: {e}"})
        elif op == "gossip.peers":
            self._handle_gossip_peers(conn, req)
        elif op in ("lease.acquire", "lease.renew", "lease.release",
                    "lease.read"):
            self._handle_lease(conn, op, req)
        elif op in ("session.open", "session.append", "session.close"):
            try:
                self._handle_session(conn, op, req)
            except OSError:
                raise  # peer gone: let the connection close
            except Exception as e:  # noqa: BLE001 — answer, don't die
                # a window re-check that failed on the card raises
                # DeviceDispatchError (monitor/frontier.py): say so for
                # a router
                self._send(conn, _answer_device_error(
                    {"id": req.get("id"), "ok": False,
                     "session": req.get("session"),
                     "error": _error_text(e)}, e))
        elif op == "shutdown":
            if self.allow_shutdown:
                self._send(conn, {"ok": True, "stopping": True})
                self.stop()
            else:
                self._send(conn, {"ok": False,
                                "error": "shutdown disabled"})
        elif op in ("check", "shrink"):
            try:
                if op == "check":
                    self._handle_check(conn, req)
                else:
                    self._handle_shrink(conn, req)
            except OSError:
                raise  # the peer went away: let the connection close
            except Exception as e:  # noqa: BLE001 — a malformed request
                # (bad rows, bad spec_kwargs, a failing engine build)
                # must answer an error, not kill the connection thread;
                # no admission slots are held here (_handle_check admits
                # only after validation and releases on its own errors;
                # _handle_shrink releases in its finally)
                self._send(conn, _answer_device_error(
                    {"id": req.get("id"), "ok": False,
                     "error": _error_text(e)}, e))
        else:
            self._send(conn, {"ok": False, "error": f"unknown op {op!r}"})

    # -- the obs collection / federation / health ops ------------------
    def _handle_obs(self, conn: socket.socket, op: str,
                    req: dict) -> None:
        """The fleet-observability surface every node answers
        (docs/OBSERVABILITY.md "Fleet"):

        * ``obs.spans``   — one cursor-paged, bounded, idempotent page
          of this process's span log (obs/collect.py owns the cursor
          semantics) — what the router's collection sweep scrapes;
        * ``obs.trace``   — one trace's events (causal closure) from
          this process's own span log, for single-node debugging;
        * ``obs.metrics`` — this process's metric samples, JSON-shaped,
          so a router can federate them under a ``node`` label without
          every node needing its own scrape port;
        * ``health``      — the SLO evaluation (obs/slo.py) or plain
          liveness when no objectives are configured.
        """
        if op == "health":
            self._send(conn, {"id": req.get("id"), "ok": True,
                              **self.health_doc()})
            return
        if op == "obs.metrics":
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "samples": [list(s) for s in
                                          self.obs.metrics.collect()]})
            return
        if op == "obs.spans":
            from ..obs.collect import span_page_response

            self._send(conn, span_page_response(self.obs.tracer, req))
            return
        # obs.trace: the trace's events plus causal ancestors from the
        # local log only (a router's handler merges its collected log)
        from ..obs import load_events, trace_closure

        path = self.obs.tracer.path
        if path is None:
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "enabled": False, "events": []})
            return
        self.obs.tracer.flush()
        trace_id = str(req.get("trace") or "")
        events = trace_closure(load_events(path), trace_id)
        self._send(conn, {"id": req.get("id"), "ok": True,
                          "enabled": True, "trace": trace_id,
                          "events": events})

    def _shed_total(self) -> float:
        adm = self.admission.snapshot()
        return float(adm["shed_queue"] + adm["shed_deadline"])

    def _on_slo_breach(self, row: dict) -> None:
        # the configured-objective incident: one event per ok->breach
        # transition; `slo.breach` is a flight-dump trigger
        self.obs.event("slo.breach", objective=row["objective"],
                       burn=row["burn_rate"], value=row["value"],
                       target=row["target"])

    def health_doc(self) -> dict:
        """The ``health`` op payload: per-objective burn rates and an
        overall status (obs/slo.py), or plain liveness when no SLO is
        configured — the status maps to `qsm-tpu health`'s pinned exit
        codes either way.  A node running a device-work queue folds
        ``window_utilization`` in as one more objective: the
        last drained window's utilization against the 0.8 target, with
        no-windows-yet reported as zero samples, NOT a breach — rare
        windows are the premise, their absence is not an incident."""
        if self.slo is None:
            doc = {"status": "ok",
                   "slo": {"configured": False},
                   "uptime_s": round(time.monotonic() - self._t0, 1)}
        else:
            ev = self.slo.evaluate()
            doc = {"status": ev["status"],
                   "slo": {"configured": True,
                           "window_s": ev["window_s"],
                           "window_actual_s": ev["window_actual_s"],
                           "objectives": ev["objectives"]},
                   "uptime_s": round(time.monotonic() - self._t0, 1)}
        if self.devq is not None:
            from ..obs.slo import utilization_objective
            from ..obs.slo import worst_status as _worst

            row = utilization_objective(
                (self.devq_report or {}).get("window_utilization"))
            doc["devq"] = {"pending": len(self.devq),
                           "window_utilization": row}
            doc["status"] = _worst([doc["status"], row["status"]])
            if self.slo is not None:
                doc["slo"]["objectives"] = (
                    list(doc["slo"]["objectives"]) + [row])
        return doc

    # -- the replog anti-entropy ops (fleet/replog.py) -----------------
    def _handle_replog(self, conn: socket.socket, op: str,
                       req: dict) -> None:
        """The segment-exchange surface a fleet router reconciles
        through: ``digests`` advertises what this node holds (and has
        absorbed — a peer must not think compaction lost anything),
        ``pull`` ships whole sealed segments out, ``push`` adopts
        replicated ones — fingerprint-verified, idempotent, and folded
        into the live cache WITHOUT re-banking (each verdict lands on
        this node's disk exactly once)."""
        if self.replog is None:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": "node runs no replicated log "
                                       "(start with replog_dir)"})
            return
        if op == "replog.digests":
            # `absorbed` on the wire = everything covered (absorbed by
            # compaction OR subsumed by row coverage): a peer must not
            # re-offer either kind
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "digests": self.replog.digests(),
                              "absorbed": self.replog.covered(),
                              "active_rows":
                                  self.replog.snapshot()["active_rows"]})
            return
        if op == "replog.covers":
            # the coverage leg of row-level subsumption: the row KEYS
            # of held segments (never the rows), so a peer can decide
            # whether a ship is needed at all — one file read each
            covers = self.replog.covers(
                [str(n) for n in list(req.get("segments") or [])[:64]])
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "covers": covers})
            return
        if op == "replog.subsumed":
            # the decision leg: THIS node's live set says whether it
            # already holds every row of the offered segment — if so
            # the name is recorded as covered and the rows never ship
            name = str(req.get("name") or "")
            fp = str(req.get("fingerprint") or "")
            keys = [str(k) for k in (req.get("keys") or [])]
            held = (name in self.replog.digests()
                    or name in self.replog.covered())
            if held:
                self._send(conn, {"id": req.get("id"), "ok": True,
                                  "subsumed": True, "held": True})
                return
            subsumed = False
            if keys and self.cache.holds_all(keys):
                try:
                    subsumed = self.replog.note_subsumed(name, fp)
                except ValueError as e:
                    self._send(conn, {"id": req.get("id"), "ok": False,
                                      "error": f"{type(e).__name__}: "
                                               f"{e}"[:200]})
                    return
                if subsumed:
                    self.obs.event("replog.subsume", segment=name,
                                   rows=len(keys))
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "subsumed": subsumed})
            return
        if op == "replog.pull":
            segments = []
            for name in list(req.get("segments") or [])[:64]:
                got = self.replog.read_segment(str(name))
                if got is not None:
                    segments.append({"name": str(name),
                                     "fingerprint": got[0],
                                     "lines": got[1]})
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "segments": segments})
            return
        adopted = rows_in = 0
        errors: List[str] = []
        for seg in list(req.get("segments") or []):
            try:
                rows = self.replog.adopt(str(seg.get("name")),
                                         str(seg.get("fingerprint")),
                                         list(seg.get("lines") or []))
            except (ValueError, OSError, AttributeError) as e:
                errors.append(f"{type(e).__name__}: {e}"[:200])
                continue
            if rows:
                adopted += 1
                rows_in += self.cache.adopt_rows(rows)
        self.obs.event("replog.adopt", segments=adopted, rows=rows_in)
        doc = {"id": req.get("id"), "ok": True, "adopted": adopted,
               "rows": rows_in}
        if errors:
            doc["errors"] = errors
        self._send(conn, doc)

    # -- the device-work-queue ops (devq) ----------------------
    def _handle_devq(self, conn: socket.socket, op: str,
                     req: dict) -> None:
        """The window-arbitrage surface (docs/WINDOWS.md): ``put`` banks
        fingerprint-keyed work items (dedup by item key — a replayed put
        is a no-op), ``digests``/``pull`` are the queue's anti-entropy
        legs mirroring ``replog.*`` over the devq segment log, and
        ``drain_report`` is how a window host hands a drained window
        back — verdict rows bank into THIS node's cache under their
        originating fingerprints (set-union), drained item keys
        tombstone as done (absorbing), and the report feeds the
        ``window_utilization`` SLO the ``health`` verb reports.  Sent
        with no body, ``drain_report`` reads the last banked report."""
        if self.devq is None:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": "node runs no device-work queue "
                                       "(start with devq_dir)"})
            return
        if op == "devq.put":
            banked = 0
            errors: List[str] = []
            for doc in list(req.get("items") or [])[:64]:
                try:
                    if self.devq.put_doc(dict(doc)):
                        banked += 1
                except (KeyError, ValueError, TypeError) as e:
                    errors.append(f"{type(e).__name__}: {e}"[:200])
            self.obs.event("devq.put", banked=banked,
                           pending=len(self.devq))
            doc = {"id": req.get("id"), "ok": True, "banked": banked,
                   "pending": len(self.devq)}
            if errors:
                doc["errors"] = errors
            self._send(conn, doc)
            return
        if op == "devq.digests":
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "digests": self.devq.digests(),
                              "queue": self.devq.snapshot()})
            return
        if op == "devq.pull":
            segments = []
            for name in list(req.get("segments") or [])[:64]:
                got = self.devq.read_segment(str(name))
                if got is not None:
                    segments.append({"name": str(name),
                                     "fingerprint": got[0],
                                     "lines": got[1]})
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "segments": segments})
            return
        if op == "devq.drain_report":
            # bank + tombstone (write form) or read the last report
            # back (empty body — what `health`/tools poll)
            report = req.get("report")
            rows_in = req.get("rows") or []
            done_in = req.get("done") or []
            if report is None and not rows_in and not done_in:
                self._send(conn, {"id": req.get("id"), "ok": True,
                                  "report": self.devq_report})
                return
            if report is not None:
                self.devq_report = dict(report)
            self.cache.put_many(
                (str(r[0]), int(r[1]), r[2] if len(r) > 2 else None)
                for r in rows_in)
            done = 0
            for key in done_in:
                if self.devq.mark_done(str(key)):
                    done += 1
            self.obs.event("devq.drain_report", rows=len(rows_in),
                           done=done,
                           utilization=(report or {}).get(
                               "window_utilization"))
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "rows": len(rows_in), "done": done,
                              "pending": len(self.devq)})

    def _handle_gossip_peers(self, conn: socket.socket,
                             req: dict) -> None:
        """(Re)configure this node's gossip peer set at runtime — the
        wiring op ``fleet`` uses after spawned nodes' addresses are
        known.  Idempotent; requires a replog (gossip replicates
        segments, a bankless node has none to exchange)."""
        if self.replog is None:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": "node runs no replicated log "
                                       "(start with replog_dir)"})
            return
        peers = req.get("peers") or []
        if req.get("interval_s") is not None:
            self._gossip_interval = float(req["interval_s"])
        self._make_gossip(peers)
        self.gossip.interval_s = self._gossip_interval
        if not self._stop.is_set():
            # idempotent: also wakes an agent created dormant
            # (interval 0) that this op just gave a real beat
            self.gossip.start()
        self._send(conn, {"id": req.get("id"), "ok": True,
                          "peers": self.gossip.peer_ids(),
                          "interval_s": self.gossip.interval_s})

    # -- the lease service (fleet/lease.py TcpLeaseStore) --------------
    def _handle_lease(self, conn: socket.socket, op: str,
                      req: dict) -> None:
        """The lease-hosting surface: each op runs ONE flock-excluded
        FileLeaseStore transaction on this node's ``lease_path`` —
        the term/expiry semantics routers see over TCP are byte-for-
        byte the single-host semantics, with this host's clock as the
        one authority.  A REFUSED transaction (live foreign term,
        superseded renew, lost flock beat) is an OK response with the
        flag false — only transport failure reads as a lost beat on
        the caller's side, so the two are never conflated."""
        if self.lease_store is None:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": "node hosts no lease record "
                                       "(start with lease_path)"})
            return
        holder = str(req.get("holder", ""))
        self.lease_ops += 1
        if op == "lease.read":
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "record": self.lease_store.read()})
            return
        if op == "lease.acquire":
            rec = self.lease_store.acquire(
                holder, ttl_s=float(req.get("ttl_s", 3.0)),
                grace_s=float(req.get("grace_s", 0.0)))
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "acquired": rec is not None,
                              "record": (rec if rec is not None
                                         else self.lease_store.read())})
            return
        if op == "lease.renew":
            rec = self.lease_store.renew(
                holder, int(req.get("term", -1)),
                ttl_s=float(req.get("ttl_s", 3.0)))
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "renewed": rec is not None,
                              "record": rec})
            return
        self.lease_store.release(holder)  # lease.release
        self._send(conn, {"id": req.get("id"), "ok": True,
                          "released": True})

    # -- the check path ------------------------------------------------
    def _handle_check(self, conn: socket.socket, req: dict) -> None:
        from ..models.registry import MODELS

        t_req = time.perf_counter()
        model = req.get("model")
        if model not in MODELS:
            self._send(conn, {"id": req.get("id"), "ok": False,
                            "error": f"unknown model {model!r}; one of "
                                     f"{sorted(MODELS)}"})
            return
        rows_list = req.get("histories")
        if rows_list is None and "history" in req:
            rows_list = [req["history"]]
        if not isinstance(rows_list, list) or not rows_list:
            self._send(conn, {"id": req.get("id"), "ok": False,
                            "error": "request needs a non-empty "
                                     "'histories' (or 'history') array"})
            return
        hists = [rows_to_history(rows) for rows in rows_list]
        spec_kwargs = req.get("spec_kwargs") or {}
        want_witness = bool(req.get("witness"))
        deadline = self.admission.deadline_for(req.get("deadline_s"))
        self.requests += 1
        # the request-scoped trace id: minted HERE at admission (or
        # adopted from the client), propagated through every stage and
        # carried by every response — docs/OBSERVABILITY.md.  A router
        # sub-request also carries `parent` (its node.dispatch span),
        # so in the COLLECTED fleet log this node's whole subtree pins
        # under the router edge that caused it — causality by edge,
        # never by cross-process wall clocks.
        trace = str(req.get("trace") or "") or new_trace_id()
        root = ""
        if self.obs.on:
            root = new_span_id()
            self.obs.tracer.emit("request", trace=trace, span=root,
                                 parent=str(req.get("parent") or ""),
                                 model=model, lanes=len(hists),
                                 witness=want_witness)

        # engine construction/validation BEFORE admission: bad
        # spec_kwargs (or a failing device build) must never reserve
        # lanes it cannot use
        entry = self._engine_for(model, spec_kwargs)
        spec_key = self._spec_key(model, spec_kwargs)
        if self.devq is not None and len(hists) >= self.max_lanes:
            # the admission seam (devq): an oversize corpus is
            # exactly what a device window pays for — bank a copy for
            # the drain scheduler (side channel; THIS request still
            # serves on the host path right now, shed or not)
            from ..devq import bank_histories

            bank_histories(entry.spec, hists, plane="check",
                           queue=self.devq)
        if not self.admission.try_admit(len(hists)):
            self._respond(conn, self._shed(req, "queue full", trace,
                                           root), trace, root, t_req)
            return
        self.obs.event("admission.admit", trace=trace, parent=root,
                       lanes=len(hists),
                       deadline_s=round(deadline - time.monotonic(), 3))
        pending = _PendingRequest(len(hists))
        self.histories += len(hists)
        # exactly-once release per admitted lane, whatever path resolves
        # it (cache hit, witness search, batch dispatch, mid-request
        # shed, or an unexpected exception below) — a leaked slot would
        # permanently shrink queue_depth until the server sheds all
        # traffic
        released = [False] * len(hists)
        rel_lock = threading.Lock()

        def release_lane(i: int) -> None:
            with rel_lock:
                if released[i]:
                    return
                released[i] = True
            self.admission.release(1)

        try:
            self._check_admitted(conn, req, entry, spec_key, hists,
                                 pending, deadline, want_witness,
                                 release_lane, t_req, model, trace,
                                 root)
        except Exception as e:
            # the request dies, its slots must not: lanes the batcher
            # owns release via their resolvers; everything else here
            pending.dead = True
            for j in range(len(hists)):
                if not pending.lane_submitted[j]:
                    release_lane(j)
            self._respond(conn, _answer_device_error(
                {"id": req.get("id"), "ok": False, "trace": trace,
                 "error": _error_text(e)}, e),
                trace, root, t_req, status="error")

    def _check_admitted(self, conn, req, entry, spec_key, hists, pending,
                        deadline, want_witness, release_lane, t_req,
                        model, trace, root) -> None:
        for i, h in enumerate(hists):
            key = fingerprint_key(entry.spec, h)
            lane_span = self.obs.event("lane", trace=trace, parent=root,
                                       index=i, ops=len(h))
            e = self.cache.get(key)
            if e is not None and not (want_witness and e.witness is None
                                      and e.verdict
                                      == int(Verdict.LINEARIZABLE)):
                # O(1) banked verdict (and witness when asked for one —
                # a hit missing a needed witness falls through to the
                # one-search witness path below)
                self.obs.event("cache.hit", trace=trace,
                               parent=lane_span,
                               verdict=VERDICT_NAMES[e.verdict])
                pending.resolve(i, e.verdict, cached=True,
                                witness=e.witness)
                release_lane(i)
            elif want_witness:
                # ONE host-oracle search serves verdict AND witness
                # (the replay/check CLI rule); bounded by the request
                # deadline between items.  A history whose split pays
                # (smaller buckets) takes the DECOMPOSED witness path:
                # per-key searches + a stitched whole-history witness
                # that verify_witness replays identically (ops/pcomp.py)
                if time.monotonic() >= deadline:
                    pending.dead = True
                    self.admission.shed_late()
                    self._release_unsubmitted(pending, release_lane)
                    self._respond(conn, self._shed(req, "deadline",
                                                   trace, root),
                                  trace, root, t_req)
                    return
                with self.obs.span("witness", trace=trace,
                                   parent=lane_span) as wsp:
                    if self._split_pays(entry, h):
                        with self._pcomp_lock:
                            if entry.pcomp is None:
                                from ..ops.pcomp import PComp

                                entry.pcomp = PComp(entry.spec)
                        before = entry.pcomp.subs_produced
                        v, w = entry.pcomp.check_witness(entry.spec, h)
                        with self._pcomp_lock:
                            self.pcomp_split += 1
                            # witness traffic's sub-histories count
                            # too, or stats() would claim histories
                            # split into zero sub-lanes
                            subs = entry.pcomp.subs_produced - before
                            self.pcomp_subs += subs
                        wsp.add(pcomp_subs=subs)
                    else:
                        v, w = entry.oracle.check_witness(entry.spec, h)
                    wsp.add(verdict=VERDICT_NAMES[int(v)])
                self.cache.put(key, int(v), w)
                self.obs.event("cache.put", trace=trace,
                               parent=lane_span,
                               verdict=VERDICT_NAMES[int(v)])
                pending.resolve(i, int(v), witness=w)
                release_lane(i)
            elif self._split_pays(entry, h):
                if not self._submit_split(entry, h, key, pending, i,
                                          deadline, release_lane,
                                          trace=trace,
                                          parent=lane_span):
                    pending.dead = True
                    self._release_unsubmitted(pending, release_lane)
                    self._respond(conn, self._shed(req, "batcher full",
                                                   trace, root),
                                  trace, root, t_req)
                    return
            else:
                lane = Lane(key=key, history=h, deadline=deadline,
                            resolve=self._lane_resolver(pending, i,
                                                        release_lane),
                            trace=trace, span=lane_span)
                pending.lane_submitted[i] = True
                if not self.batcher.submit(spec_key, lane):
                    pending.lane_submitted[i] = False
                    pending.dead = True
                    self._release_unsubmitted(pending, release_lane)
                    self._respond(conn, self._shed(req, "batcher full",
                                                   trace, root),
                                  trace, root, t_req)
                    return
        if not pending.wait(deadline - time.monotonic()):
            # the deadline fired with lanes still in flight: SHED —
            # never a partial or late answer.  In-flight lanes complete
            # into the cache (their admission slots release there).
            pending.dead = True
            self.admission.shed_late()
            self._respond(conn, self._shed(req, "deadline", trace,
                                           root), trace, root, t_req)
            return
        err = _batch_error(pending.batches)
        if err is not None:
            # a real device error (the card's rule): the request
            # answers the error, never a host re-decision
            raise DeviceDispatchError(err)
        verdicts = [int(v) for v in pending.verdicts]
        doc = {
            "id": req.get("id"), "ok": True,
            "model": model, "trace": trace,
            "verdicts": [VERDICT_NAMES[v] for v in verdicts],
            "cached": list(pending.cached),
            "violations": sum(v == int(Verdict.VIOLATION)
                              for v in verdicts),
            "undecided": sum(v == int(Verdict.BUDGET_EXCEEDED)
                             for v in verdicts),
            "batches": list(pending.batches),
            "plan_why": entry.plan_why,
            "resilience": collect_resilience(entry.engine),
            "seconds": round(time.perf_counter() - t_req, 4),
        }
        if want_witness:
            doc["witnesses"] = [
                [list(p) for p in w] if w is not None else None
                for w in pending.witnesses]
        self._respond(conn, doc, trace, root, t_req)

    def _respond(self, conn, doc: dict, trace: str, root: str,
                 t_req: float, status: str = "ok",
                 verb: str = "check") -> None:
        """The check path's ONE terminal: closes the request's causal
        tree with a ``response`` event and feeds the request-latency
        histogram (labeled by verb — the SLO plane's sliding windows
        read the same series), then sends."""
        dt = time.perf_counter() - t_req
        if self.obs.on:
            self.obs.tracer.emit(
                "response", trace=trace, parent=root,
                ms=round(dt * 1000.0, 3), status=status,
                shed=bool(doc.get("shed")),
                violations=doc.get("violations"),
                cached=sum(bool(c) for c in doc.get("cached", ())))
        self._m_request_s.observe(dt, verb=verb)
        self._send(conn, doc)

    # -- P-compositional split lanes (ops/pcomp.py) --------------------
    def _split_pays(self, entry: _EngineEntry, h: History) -> bool:
        """Decompose iff the spec's projection validated at engine build
        AND this history's per-key sub-histories land in a strictly
        smaller compile bucket (the planner's gate, per history)."""
        if entry.proj is None:
            return False
        from ..ops.pcomp import split_gain

        try:
            return split_gain(entry.spec, h)
        except ValueError:
            return False  # runtime non-totality: refuse, never split

    def _submit_split(self, entry: _EngineEntry, h: History,
                      whole_key: str, pending: _PendingRequest, i: int,
                      deadline: float, release_lane,
                      trace: str = "", parent: str = "") -> bool:
        """Fan one request history out as per-key sub-lanes riding the
        PROJECTED spec's micro-batch group; verdicts recombine through a
        :class:`_SubJoin` whose completion banks the whole-history key
        and resolves lane ``i``.  Each sub-history has its own cache row
        (fingerprint under the projected spec), so a later history that
        changes one key re-checks that key only.  False = batcher full
        (the caller sheds; in-flight sub-lanes drain into the join,
        which still completes and releases the admission slot).  The
        request's ``trace`` rides every sub-lane: the causal tree shows
        the split, each sub-lane's micro-batch, and the recombine."""
        from ..ops.pcomp import split_history

        subs = split_history(entry.spec, h)
        if not subs:
            # empty history: vacuously linearizable (the gate already
            # refuses these, but a zero-lane join would never complete)
            self.cache.put(whole_key, int(Verdict.LINEARIZABLE))
            pending.resolve(i, int(Verdict.LINEARIZABLE))
            release_lane(i)
            return True
        with self._pcomp_lock:
            self.pcomp_split += 1
            self.pcomp_subs += len(subs)
        if self.devq is not None:
            # the pcomp seam (devq): the validated per-key
            # sub-lane group banks under the PROJECTED spec — the same
            # fingerprints the sub-lane cache rows use below, so a
            # window drain pre-answers this exact split next time
            from ..devq import bank_histories

            bank_histories(entry.proj, [subs[k] for k in sorted(subs)],
                           plane="pcomp", queue=self.devq)
        split_span = self.obs.event("pcomp.split", trace=trace,
                                    parent=parent, keys=len(subs),
                                    ops=len(h))

        def finish(worst: int, batch: Optional[dict]) -> None:
            banked = worst in (int(Verdict.VIOLATION),
                               int(Verdict.LINEARIZABLE))
            if banked:
                # the combined verdict banks under the WHOLE history's
                # key too: exact duplicates stay O(1) hits
                self.cache.put(whole_key, worst)
            self.obs.event("pcomp.recombine", trace=trace,
                           parent=split_span, subs=len(subs),
                           verdict=VERDICT_NAMES[worst], banked=banked)
            pending.resolve(i, worst, batch=batch)
            release_lane(i)

        join = _SubJoin(len(subs), finish)
        # the join owns the slot release from here on — including the
        # shed path, where aborted sub-lanes feed BUDGET_EXCEEDED
        pending.lane_submitted[i] = True
        dispatched = 0
        # sorted: deterministic sub-lane order (cache/bench replayability)
        for key in sorted(subs):
            sub_h = subs[key]
            skey = fingerprint_key(entry.proj, sub_h)
            sub_span = self.obs.event("sublane", trace=trace,
                                      parent=split_span, key=key,
                                      ops=len(sub_h))
            e = self.cache.get(skey)
            if e is not None:
                with self._pcomp_lock:
                    self.pcomp_sub_hits += 1
                self.obs.event("cache.hit", trace=trace,
                               parent=sub_span,
                               verdict=VERDICT_NAMES[e.verdict])
                dispatched += 1
                join.feed(e.verdict)
                continue
            lane = Lane(key=skey, history=sub_h, deadline=deadline,
                        resolve=join.resolver(), pcomp=True,
                        trace=trace, span=sub_span)
            if not self.batcher.submit(entry.proj_group_key, lane):
                join.abort(len(subs) - dispatched)
                return False
            dispatched += 1
        return True

    # -- monitor sessions (monitor, docs/MONITOR.md) -----------
    def _handle_session(self, conn: socket.socket, op: str,
                        req: dict) -> None:
        """The streaming verbs: ``session.open`` binds a spec and
        returns a session id (idempotent for a live id — failover
        replay and reconnects resume), ``session.append`` applies
        events and answers the CURRENT verdict — carrying the ``flip``
        payload (1-minimal shrunk repro + certificate) on the append
        that made a violation decidable — and ``session.close`` flushes,
        decides once more, optionally serves the whole-stream witness
        through the exact check-path machinery, and frees the session.
        Admission/SHED semantics match ``check``: a full queue or a
        session/event cap answers SHED, never a wrong or partial
        verdict; engine time is bounded by the frontier node budget and
        the request deadline."""
        from ..monitor import SessionLimit

        t_req = time.perf_counter()
        trace = str(req.get("trace") or "") or new_trace_id()
        root = ""
        if self.obs.on:
            root = new_span_id()
            self.obs.tracer.emit("request", trace=trace, span=root,
                                 parent=str(req.get("parent") or ""),
                                 op=op, session=req.get("session"))
        self.requests += 1
        if op == "session.open":
            self._session_open(conn, req, trace, root, t_req)
            return
        sid = str(req.get("session") or "")
        s = self.monitor.get(sid)
        if s is None:
            # machine-readable: a router reads `unknown_session` as
            # "this node restarted and lost the live object" and
            # replays the journal (fleet/router.py _route_session) —
            # the banked decided prefixes make the replay cheap
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "session": sid, "trace": trace,
                              "unknown_session": True,
                              "error": f"unknown session {sid!r} "
                                       "(open one first; a restarted "
                                       "node resumes by re-open + "
                                       "replay)"})
            return
        if not self.admission.try_admit(1):
            self._respond(conn, {**self._shed(req, "queue full", trace,
                                              root), "session": sid},
                          trace, root, t_req, verb='session')
            return
        try:
            deadline = self.admission.deadline_for(req.get("deadline_s"))
            with s.lock:
                if op == "session.append":
                    doc = self._session_append(s, req, deadline, trace,
                                               root)
                else:
                    doc = self._session_close(s, req, deadline, trace,
                                              root)
        except SessionLimit as e:
            self.admission.release(1)
            self._respond(conn, {**self._shed(req, str(e), trace, root),
                                 "session": sid}, trace, root,
                          t_req, verb='session')
            return
        except Exception:
            self.admission.release(1)
            raise
        self.admission.release(1)
        doc["seconds"] = round(time.perf_counter() - t_req, 4)
        self._respond(conn, doc, trace, root, t_req, verb='session')

    def _session_open(self, conn, req: dict, trace: str, root: str,
                      t_req: float) -> None:
        from ..models.registry import MODELS
        from ..monitor import SessionLimit

        model = req.get("model")
        if model not in MODELS:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "trace": trace,
                              "error": f"unknown model {model!r}; one "
                                       f"of {sorted(MODELS)}"})
            return
        spec_kwargs = req.get("spec_kwargs") or {}
        # engine/projection validation BEFORE admission, like check
        entry = self._engine_for(model, spec_kwargs)
        if not self.admission.try_admit(1):
            self._respond(conn, self._shed(req, "queue full", trace,
                                           root), trace, root,
                          t_req, verb='session')
            return
        try:
            sid = req.get("session")
            try:
                s, resumed = self.monitor.open(
                    str(sid) if sid is not None else None, entry.spec,
                    entry.proj, trace=trace)
            except SessionLimit as e:
                self._respond(conn, self._shed(req, str(e), trace,
                                               root), trace, root,
                              t_req, verb='session')
                return
            with s.lock:
                s.model, s.spec_kwargs = model, spec_kwargs
                verdict = s.decide()
            self.obs.event("session.open", trace=trace, parent=root,
                           session=s.sid, model=model, resumed=resumed)
            self._respond(conn, {
                "id": req.get("id"), "ok": True, "session": s.sid,
                "model": model, "resumed": resumed, "seq": s.seq,
                "per_key": s.proj is not None,
                "verdict": VERDICT_NAMES[verdict], "trace": trace,
                "seconds": round(time.perf_counter() - t_req, 4),
            }, trace, root, t_req, verb='session')
        finally:
            self.admission.release(1)

    def _session_append(self, s: "MonitorSession", req: dict,
                        deadline: float,
                        trace: str, root: str) -> dict:
        events = req.get("events")
        if not isinstance(events, list) or not events:
            raise ValueError("session.append needs a non-empty "
                             "'events' array")
        applied = s.append(events, seq=req.get("seq"))
        already_pushed = s.flip_pushed
        verdict = s.decide()
        c = s.counters()
        self.obs.event("session.append", trace=trace, parent=root,
                       session=s.sid, events=applied,
                       verdict=VERDICT_NAMES[verdict])
        doc = {"id": req.get("id"), "ok": True, "session": s.sid,
               "seq": s.seq, "applied": applied,
               "verdict": VERDICT_NAMES[verdict], "trace": trace,
               "decided_prefix": c["committed_ops"],
               "window_ops": c["window_ops"]}
        if s.flipped and not already_pushed:
            # the flip: pushed on the append that made the violation
            # decidable (a verdict only changes when an event arrives,
            # so this response IS the earliest possible push), carrying
            # the shrink-plane-minimized repro + its certificate.  The
            # session RLock is already held by the dispatching caller;
            # re-acquiring keeps the guard visible at the write.
            with s.lock:
                s.flip_pushed = True
            self.monitor.note_flip()
            doc["flip"] = self._session_flip(s, deadline, trace, root)
        elif s.flipped:
            doc["flipped"] = True  # terminal; repro already delivered
        return doc

    def _session_flip(self, s: "MonitorSession", deadline: float,
                      trace: str,
                      root: str) -> dict:
        """Auto-minimize the violating stream through the shrink
        plane (frontier candidates ride the shared micro-batcher and
        bank in the shared cache) and certify the result; the
        ``session.flip`` event is a flight-recorder dump trigger, so a
        production flip leaves an artifact naming the session's trace
        id even if no client ever reads the response."""
        from ..shrink.shrinker import Shrinker, minimality_certificate

        entry = self._engine_for(s.model, s.spec_kwargs)
        spec_key = self._spec_key(s.model, s.spec_kwargs)
        h = rows_to_history([list(r) for r in (s.flip_rows or s.rows)])

        def decide(hists):
            return self._decide_candidates(entry, spec_key, hists,
                                           deadline, trace=trace,
                                           parent=root)

        shrinker = Shrinker(entry.spec, decide, bank=self.cache,
                            bank_put=False, deadline=deadline)
        res = shrinker.run(h)
        flip = {"verdict": VERDICT_NAMES[int(res.verdict)],
                "initial_ops": res.initial_ops,
                "final_ops": res.final_ops,
                "rounds": res.rounds,
                "one_minimal": res.one_minimal,
                "complete": res.complete,
                "repro": history_to_rows(res.history),
                "why": res.why}
        if res.ok and res.complete:
            cert = minimality_certificate(entry.spec, res.history,
                                          deadline=deadline)
            if cert is not None:
                flip["certificate"] = cert
        with self._shrink_lock:
            self.shrink_rounds += res.rounds
            self.shrink_lanes += res.lanes_checked
            self.shrink_memo_hits += res.memo_hits
        self.obs.event("session.flip", trace=trace, parent=root,
                       session=s.sid, model=s.model,
                       ops=len(s.rows), final_ops=res.final_ops,
                       traces=[trace])
        return flip

    def _session_close(self, s: "MonitorSession", req: dict,
                       deadline: float,
                       trace: str, root: str) -> dict:
        verdict = s.close()
        doc = {"id": req.get("id"), "ok": True, "session": s.sid,
               "seq": s.seq, "verdict": VERDICT_NAMES[verdict],
               "trace": trace, "flipped": s.flipped,
               **{k: v for k, v in s.counters().items()
                  if k != "frontiers"}}
        if bool(req.get("witness")) and s.rows:
            # the whole-stream witness rides the EXACT check-path
            # machinery (cache row under the whole-history fingerprint,
            # decomposed stitching when the split pays), so a streamed
            # session's witness is bit-identical to `check --witness`
            # of the same history (tests/test_monitor.py parity pin)
            entry = self._engine_for(s.model, s.spec_kwargs)
            h = s.history()
            key = fingerprint_key(entry.spec, h)
            e = self.cache.get(key)
            if e is not None and not (e.witness is None and e.verdict
                                      == int(Verdict.LINEARIZABLE)):
                v, w = e.verdict, e.witness
            elif self._split_pays(entry, h):
                with self._pcomp_lock:
                    if entry.pcomp is None:
                        from ..ops.pcomp import PComp

                        entry.pcomp = PComp(entry.spec)
                v, w = entry.pcomp.check_witness(entry.spec, h)
                self.cache.put(key, int(v), w)
            else:
                v, w = entry.oracle.check_witness(entry.spec, h)
                self.cache.put(key, int(v), w)
            doc["verdict"] = VERDICT_NAMES[int(v)]
            doc["witness"] = ([list(p) for p in w]
                              if w is not None else None)
        self.obs.event("session.close", trace=trace, parent=root,
                       session=s.sid, events=s.seq,
                       verdict=doc["verdict"])
        self.monitor.close(s.sid)
        return doc

    # -- the shrink verb (shrink, docs/SHRINK.md) --------------
    def _handle_shrink(self, conn: socket.socket, req: dict) -> None:
        """Minimize one failing history.  Admission/deadline/SHED
        semantics are the check path's: unknown model / bad rows answer
        an error, a full queue answers SHED, a deadline that fires
        BEFORE the first frontier round answers SHED — but a deadline
        (or full batcher) that fires MID-shrink returns the best
        history found so far with ``complete: false`` and an honest
        ``why`` (a partial minimization is still a violation; throwing
        it away would waste every lane already paid for).  Frontier
        candidates ride the shared micro-batcher and bank in the
        verdict cache; the minimized result banks under the ORIGINAL
        history's fingerprint."""
        from ..models.registry import MODELS
        from ..shrink.shrinker import Shrinker, minimality_certificate

        t_req = time.perf_counter()
        model = req.get("model")
        if model not in MODELS:
            self._send(conn, {"id": req.get("id"), "ok": False,
                            "error": f"unknown model {model!r}; one of "
                                     f"{sorted(MODELS)}"})
            return
        rows = req.get("history")
        if rows is None and isinstance(req.get("histories"), list) \
                and len(req["histories"]) == 1:
            rows = req["histories"][0]
        if not isinstance(rows, list) or not rows:
            self._send(conn, {"id": req.get("id"), "ok": False,
                            "error": "shrink needs ONE non-empty "
                                     "'history' rows array"})
            return
        h = rows_to_history(rows)
        spec_kwargs = req.get("spec_kwargs") or {}
        want_cert = bool(req.get("certificate"))
        deadline = self.admission.deadline_for(req.get("deadline_s"))
        self.requests += 1
        # shrink requests are traced like check requests: one root,
        # one `shrink.round` event per greedy frontier round, batch
        # events for the candidate lanes parented under their round
        trace = str(req.get("trace") or "") or new_trace_id()
        root = ""
        if self.obs.on:
            root = new_span_id()
            self.obs.tracer.emit("request", trace=trace, span=root,
                                 parent=str(req.get("parent") or ""),
                                 model=model, op="shrink", ops=len(h))
        entry = self._engine_for(model, spec_kwargs)
        spec_key = self._spec_key(model, spec_kwargs)
        whole_key = fingerprint_key(entry.spec, h)
        with self._shrink_lock:
            self.shrink_requests += 1
            banked = self._shrink_bank.get(whole_key)
            if banked is not None:
                self._shrink_bank.move_to_end(whole_key)
        if banked is not None and not (want_cert
                                       and "certificate" not in banked):
            with self._shrink_lock:
                self.shrink_bank_hits += 1
            doc = {**banked, "id": req.get("id"), "cached": True,
                   "trace": trace,
                   "seconds": round(time.perf_counter() - t_req, 4)}
            if not want_cert:
                # a banked certificate (O(n²) witness payload) must not
                # inflate a duplicate answer that never asked for one
                doc.pop("certificate", None)
            self._respond(conn, doc, trace, root, t_req, verb='shrink')
            return
        if not self.admission.try_admit(1):
            self._respond(conn, self._shed(req, "queue full", trace,
                                           root), trace, root,
                          t_req, verb='shrink')
            return
        try:
            if time.monotonic() >= deadline:
                self.admission.shed_late()
                self._respond(conn, self._shed(req, "deadline", trace,
                                               root), trace, root,
                              t_req, verb='shrink')
                return
            self.obs.event("admission.admit", trace=trace, parent=root,
                           lanes=1)

            def decide(hists):
                rnd = self.obs.event("shrink.round", trace=trace,
                                     parent=root, lanes=len(hists))
                return self._decide_candidates(entry, spec_key, hists,
                                               deadline, trace=trace,
                                               parent=rnd)

            # bank = the verdict cache (candidates the check path — or
            # an earlier shrink — already decided are memo hits, and
            # the dispatch path banks every new verdict itself, so
            # bank_put stays off: no duplicate rows)
            shrinker = Shrinker(entry.spec, decide, bank=self.cache,
                                bank_put=False, deadline=deadline)
            res = shrinker.run(h)
            if res.ok and res.complete and want_cert:
                # a FRESH oracle per request: engines are stateful and
                # not thread-safe (_EngineEntry docstring), and this
                # witness loop runs on the connection thread while the
                # dispatcher may be driving entry.oracle — sharing it
                # here would race the memo and corrupt stats() counters
                res.certificate = minimality_certificate(
                    entry.spec, res.history, deadline=deadline)
            with self._shrink_lock:
                self.shrink_rounds += res.rounds
                self.shrink_lanes += res.lanes_checked
                self.shrink_memo_hits += res.memo_hits
            doc = {
                "id": req.get("id"), "ok": True, "model": model,
                "trace": trace,
                "verdict": VERDICT_NAMES[int(res.verdict)],
                "initial_ops": res.initial_ops,
                "final_ops": res.final_ops,
                "ratio": round(res.ratio, 3),
                "rounds": res.rounds,
                "engine_calls": res.engine_calls,
                "lanes": res.lanes_checked,
                "memo_hits": res.memo_hits,
                "complete": res.complete,
                "one_minimal": res.one_minimal,
                "undecided_neighbors": res.undecided_neighbors,
                "history": history_to_rows(res.history),
                "why": res.why,
                "plan_why": entry.plan_why,
            }
            if res.certificate is not None:
                doc["certificate"] = res.certificate
            if res.ok and res.complete:
                # minimized result banked under the ORIGINAL history's
                # fingerprint: the duplicate-shrink answer is O(1)
                with self._shrink_lock:
                    self._shrink_bank[whole_key] = dict(doc)
                    self._shrink_bank.move_to_end(whole_key)
                    while len(self._shrink_bank) > self.shrink_bank_entries:
                        self._shrink_bank.popitem(last=False)
            doc["seconds"] = round(time.perf_counter() - t_req, 4)
            self._respond(conn, doc, trace, root, t_req, verb='shrink')
        finally:
            self.admission.release(1)

    def _decide_candidates(self, entry: _EngineEntry, spec_key: str,
                           hists, deadline: float, trace: str = "",
                           parent: str = ""):
        """Decide shrink-frontier candidates through the SHARED lanes:
        each candidate is one micro-batch lane (split into per-key
        sub-lanes when that pays, exactly like paying check traffic),
        banked by the dispatch path.  ``None`` = shed (full batcher or
        deadline) — the shrinker stops with best-so-far.  Candidate
        lanes hold no admission slots: the shrink REQUEST holds one,
        and the batcher's bounded queue is the frontier's backstop."""

        def _noop(_i: int) -> None:
            return None

        pending = _PendingRequest(len(hists))
        for i, h in enumerate(hists):
            key = fingerprint_key(entry.spec, h)
            if self._split_pays(entry, h):
                if not self._submit_split(entry, h, key, pending, i,
                                          deadline, _noop, trace=trace,
                                          parent=parent):
                    pending.dead = True
                    return None
            else:
                # candidate lanes parent their batch events directly
                # under the frontier round (one span per candidate
                # would flood the log at 512 lanes/round)
                lane = Lane(key=key, history=h, deadline=deadline,
                            resolve=self._lane_resolver(pending, i,
                                                        _noop),
                            trace=trace, span=parent)
                pending.lane_submitted[i] = True
                if not self.batcher.submit(spec_key, lane):
                    pending.lane_submitted[i] = False
                    pending.dead = True
                    return None
        if not pending.wait(deadline - time.monotonic()):
            pending.dead = True
            return None
        err = _batch_error(pending.batches)
        if err is not None:
            raise DeviceDispatchError(err)
        return [int(v) for v in pending.verdicts]

    @staticmethod
    def _lane_resolver(pending: _PendingRequest, i: int, release_lane):
        def _resolve(verdict: int, batch: dict) -> None:
            pending.resolve(i, verdict, batch=batch)
            release_lane(i)

        return _resolve

    @staticmethod
    def _release_unsubmitted(pending: _PendingRequest,
                             release_lane) -> None:
        """Mid-request shed: slots of lanes the batcher does NOT own
        (submitted lanes release via their resolvers on dispatch)."""
        for j in range(len(pending.verdicts)):
            if not pending.lane_submitted[j]:
                release_lane(j)
                pending.resolve(j, int(Verdict.BUDGET_EXCEEDED))

    def _shed(self, req: dict, reason: str, trace: str = "",
              parent: str = "") -> dict:
        # the admission layer builds the payload so SHED responses gain
        # the pool-state block when a worker pool serves this plane —
        # plus the request's trace id and (when a dump fired) the
        # flight-recorder artifact path, so a shed client hands the
        # operator something actionable instead of a bare SHED
        self.obs.event("admission.shed", trace=trace, parent=parent,
                       reason=reason)
        # a SHED storm (many sheds in a short window) is itself a
        # flight-recorder trigger: "the server shed all night" becomes
        # one artifact, not a grep
        self.obs.note_shed()
        return self.admission.shed_doc(req.get("id"), reason,
                                       trace=trace or None,
                                       flight=self.obs.flight_path())

    # -- batch dispatch (the `serve` fault site / the worker pool) -----
    def _dispatch(self, spec_key: str, lanes: List[Lane],
                  why: dict) -> None:
        model, spec_kwargs = json.loads(spec_key)
        entry = self._engine_for(model, spec_kwargs)
        hists = [lane.history for lane in lanes]
        from ..core.history import bucket_for

        width = why["width"]
        why = {**why, "model": model,
               "bucket": bucket_for(max((len(h) for h in hists),
                                        default=1))}
        verdicts = None
        if self.pool is not None:
            traces = sorted({lane.trace for lane in lanes if lane.trace})
            verdicts, why = self._dispatch_pool(spec_key, model,
                                                spec_kwargs, hists,
                                                width, why, traces)
        if verdicts is None:
            # no pool, a quarantined spec, or a pool that lost every
            # healthy worker for this batch: the supervisor's own
            # engine decides it, in process
            verdicts, why = self._dispatch_host(entry, hists, width, why)
        if why.get("device_error"):
            # a real device error: the lanes resolve undecided with the
            # error on their batch stamp, and their requests answer it;
            # nothing is banked and nothing is re-decided on the host
            for lane in lanes:
                lane.resolve(int(Verdict.BUDGET_EXCEEDED), why)
            return
        # engine-relative BUDGET_EXCEEDED resolves via the witness
        # oracle (the property layer's rule) unless the engine IS the
        # host ladder — re-running an identical search only repeats
        # itself (pool workers run the same ladder, so pooled verdicts
        # follow the same rule).  Whether it is the ladder is read off
        # the engine, not its name: on the card every engine is a
        # device engine.
        verdicts = [int(v) for v in verdicts]
        if int(Verdict.BUDGET_EXCEEDED) in verdicts and not (
                entry.host_ladder or (
                    self.pool is not None and "worker" in why)):
            with entry.dispatch_lock:
                if entry.resolver is None:
                    entry.resolver = budget_resolver(entry.spec)
                self.budget_resolved += resolve_budget_lanes(
                    entry.resolver, entry.spec, hists, verdicts)
        # one bank flush for the whole batch (put_many), then resolve —
        # banking is SUPERVISOR-ONLY by design: a SIGKILLed worker can
        # never leave a torn or wrong bank behind
        self.cache.put_many((lane.key, int(v), None)
                            for lane, v in zip(lanes, verdicts))
        if self.obs.on:
            # the batch lands in every member request's causal tree:
            # one `batch` event per traced lane (flush reason + worker
            # id — "which worker ran which micro-batch and why it
            # flushed"), one `cache.put` per banked verdict, and ONE
            # component-level `serve.dispatch` event carrying the
            # batch's compact SearchStats record (the span<->stats
            # bridge: the flight ring shows recent dispatches WITH
            # their cost records)
            worker = why.get("worker", "in-process")
            # counted LOCALLY, not as a global-counter delta: concurrent
            # dispatcher/connection threads emit through the same
            # tracer, and a delta would book their events to this batch
            n_emitted = 0
            for lane, v in zip(lanes, verdicts):
                if not lane.trace:
                    continue
                self.obs.event("batch", trace=lane.trace,
                               parent=lane.span, batch=why["batch"],
                               flush=why["flush"], lanes=why["lanes"],
                               width=width, worker=worker, model=model)
                n_emitted += 1
                if int(v) in (int(Verdict.VIOLATION),
                              int(Verdict.LINEARIZABLE)):
                    self.obs.event("cache.put", trace=lane.trace,
                                   parent=lane.span,
                                   verdict=VERDICT_NAMES[int(v)])
                    n_emitted += 1
            self.obs.event("serve.dispatch", batch=why["batch"],
                           flush=why["flush"], lanes=why["lanes"],
                           worker=worker, model=model,
                           search=why.get("search"))
            n_emitted += 1
            if why.get("search") is not None:
                # the other bridge direction: the batch's own cost
                # record says how many trace events it emitted
                # (SearchStats.obs_events, compact key "obe")
                why["search"]["obe"] = (why["search"].get("obe", 0)
                                        + n_emitted)
        for lane, v in zip(lanes, verdicts):
            lane.resolve(int(v), why)

    def _dispatch_pool(self, spec_key: str, model: str, spec_kwargs,
                       hists, width: int, why: dict, traces=None):
        """One micro-batch on the worker pool; ``(None, why)`` when the
        pool cannot decide it and the host path must.  ``traces`` (the
        batch's request trace ids) ride the worker frame and the pool's
        dispatch/shed events — a SIGKILLed worker's flight dump names
        the requests it took down."""
        from .protocol import history_to_rows

        pooled = self.pool.dispatch(
            spec_key, model, spec_kwargs,
            [history_to_rows(h) for h in hists], width, traces=traces)
        if pooled is None:
            return None, {**why, "pool": "in-process"}
        why = {**why, "worker": pooled.get("wid")}
        wf = int(pooled.get("batch_worker_faults", 0))
        if wf:
            why["worker_faults"] = wf
        search = pooled.get("search")
        if search is not None:
            # worker faults ride the batch's own cost record: a batch
            # that survived a worker loss must say so (SearchStats
            # worker_faults, compact key "wf")
            why["search"] = {**search, "wf": search.get("wf", 0) + wf}
        return np.asarray(pooled["verdicts"]), why

    def _dispatch_host(self, entry: _EngineEntry, hists, width: int,
                       why: dict):
        """The in-process dispatch (the `serve` fault site), serialized
        per entry — see _EngineEntry.dispatch_lock."""
        with entry.dispatch_lock:
            return self._dispatch_host_locked(entry, hists, width, why)

    def _dispatch_host_locked(self, entry: _EngineEntry, hists,
                              width: int, why: dict):
        # the reference's fixed-width padding (empty histories decide at
        # once), so that ``why`` and the counters stay the reference's
        padded = hists + [History([])] * (width - len(hists))
        self.padded_lanes += width - len(hists)
        st0 = collect_search_stats(entry.engine)

        def work():
            # the CPU-testable request-dispatch fault site
            # (resilience/faults.py): QSM_TPU_FAULTS=hang:serve wedges
            # here and the watchdog abandons it; raise:serve raises
            inject("serve")
            return entry.engine.check_histories(entry.spec, padded)

        try:
            # on the process' one dispatch watchdog worker, from the
            # batcher's stream (FailoverBackend's own watched calls run
            # inline there, under this bound)
            verdicts = np.asarray(watched_call(
                work, self.policy.timeout_s, entry.cuda, entry.on_card,
                hang_sites=("serve", "dispatch")))[:len(hists)]
        except degradable_errors(entry.on_card) as e:
            # server-level degradation: the warm engine (failover
            # ladder included) is gone for this batch — re-dispatch on
            # a dedicated emergency host ladder so the SERVER stays up
            # with exact verdicts, and count it.  On the card only an
            # injected fault gets here.
            self.serve_faults += 1
            self.obs.event("serve.degrade", error=type(e).__name__,
                           engine=getattr(entry.engine, "name",
                                          type(entry.engine).__name__))
            if entry.emergency is None:
                entry.emergency = host_fallback(entry.spec)
            verdicts = np.asarray(entry.emergency.check_histories(
                entry.spec, padded))[:len(hists)]
            why = {**why, "degraded": f"{type(e).__name__}"}
        except Exception as e:  # noqa: BLE001 — answered, not degraded
            if not entry.on_card:
                raise
            # the card's rule: a real device error (a CUDA fault, a real
            # timeout, a kernel that does not build) is answered, counted
            # and reported, never re-decided on the host
            self.serve_faults += 1
            self.device_errors += 1
            text = f"{type(e).__name__}: {e}"[:300]
            self.obs.event("serve.device_error", error=type(e).__name__,
                           detail=text,
                           engine=getattr(entry.engine, "name",
                                          type(entry.engine).__name__))
            return None, {**why, "device_error": text}
        st = stats_delta(collect_search_stats(entry.engine), st0)
        if st is not None:
            why = {**why, "search": st.to_compact()}
        return verdicts, why

    # -- observability -------------------------------------------------
    def _pcomp_snapshot(self) -> dict:
        with self._pcomp_lock:
            return {"enabled": self.pcomp_enabled,
                    "split": self.pcomp_split,
                    "sub_lanes": self.pcomp_subs,
                    "sub_cache_hits": self.pcomp_sub_hits}

    def _shrink_snapshot(self) -> dict:
        with self._shrink_lock:
            return {"requests": self.shrink_requests,
                    "rounds": self.shrink_rounds,
                    "lanes": self.shrink_lanes,
                    "memo_hits": self.shrink_memo_hits,
                    "bank_entries": len(self._shrink_bank),
                    "bank_hits": self.shrink_bank_hits}

    def stats(self) -> dict:
        """The aggregate the ``stats`` op (and ``qsm-tpu stats --serve``)
        returns: every counter a capacity decision needs, self-describing
        about batching, caching, shedding and degradation."""
        engines = {}
        for key, entry in list(self._engines.items()):
            st = collect_search_stats(entry.engine)
            engines[key] = {
                "engine": getattr(entry.engine, "name",
                                  type(entry.engine).__name__),
                "resilience": collect_resilience(entry.engine),
                "search": st.to_compact() if st is not None else None,
                # histories its searches decided (the fleet view's
                # "searched" column)
                "searched": st.histories if st is not None else 0,
            }
        return {
            "address": self.address,
            "node": self.node_id,
            "uptime_s": round(time.monotonic() - self._t0, 1),
            "engine_kind": self.engine_kind,
            "device": "cpu" if self.on_cpu else str(self.device or "cuda"),
            "mesh_devices": self.mesh_devices,
            "workers": self.n_workers,
            "requests": self.requests,
            "histories": self.histories,
            "serve_faults": self.serve_faults,
            # of those, real device errors answered ok: false
            "device_errors": self.device_errors,
            # empty lanes that padded flushes to their width
            "padded_lanes": self.padded_lanes,
            # split-plane accounting: how much traffic decomposed, how
            # many sub-lanes it became, and how many of those the
            # per-sub-history cache rows answered without re-checking
            "pcomp": self._pcomp_snapshot(),
            # shrink-verb accounting: how many minimizations ran, what
            # their frontiers cost in shared lanes, and how much the
            # fingerprint memo + result bank saved (docs/SHRINK.md)
            "shrink": self._shrink_snapshot(),
            # monitor-session accounting (monitor): live
            # sessions, events streamed, frontier advances, prefix-bank
            # hits and flips pushed — the session block `qsm-tpu stats`
            # renders and the metrics collector reads (one source)
            "session": (self.monitor.snapshot()
                        if self.monitor is not None else None),
            "worker_faults": (self.pool.worker_faults
                              if self.pool is not None else 0),
            "budget_resolved": self.budget_resolved,
            "admission": self.admission.snapshot(),
            "batcher": self.batcher.snapshot(),
            "cache": self.cache.stats(),
            # lease hosting (fleet/lease.py): None unless this node
            # answers the lease.* ops
            "lease_host": ({"path": self.lease_store.describe(),
                            "ops": self.lease_ops}
                           if self.lease_store is not None else None),
            # node-to-node anti-entropy accounting (fleet/gossip.py):
            # None unless this node gossips
            "gossip": (self.gossip.snapshot()
                       if self.gossip is not None else None),
            # per-worker rows (dispatches, faults, deaths, respawns,
            # quarantines) — what `qsm-tpu stats --serve` aggregates
            "pool": self.pool.snapshot() if self.pool is not None else None,
            "engines": engines,
            # trace/flight accounting (obs): span events
            # emitted, flight-ring occupancy, dumps fired + last path
            "obs": self.obs.snapshot(),
            # the SLO plane (obs/slo.py): declared objectives + breach
            # count — None unless --slo configured objectives
            "slo": (self.slo.snapshot()
                    if self.slo is not None else None),
            # device-work queue (devq): banked/pending/evicted
            # counts plus the last drained window's headline — None
            # unless --devq-dir configured the queue
            "devq": ({**self.devq.snapshot(),
                      "last_window": (
                          {"window_id": self.devq_report.get(
                              "window_id"),
                           "drained": self.devq_report.get("drained"),
                           "window_utilization": self.devq_report.get(
                               "window_utilization")}
                          if self.devq_report is not None else None)}
                     if self.devq is not None else None),
            # fault-plane hits in THIS process (resilience/faults.py) —
            # zeros/empty unless someone is fault-drilling the server
            "faults": fired_snapshot(),
        }

    def _metric_samples(self):
        """Scrape-time collector (obs/metrics.py): the live-metrics
        surface derives from the SAME counters ``stats()`` reports, so
        the ``/metrics`` endpoint and `qsm-tpu stats` reconcile by
        construction (pinned in tests/test_obs.py)."""
        adm = self.admission.snapshot()
        bat = self.batcher.snapshot()
        cache = self.cache.stats()
        pc = self._pcomp_snapshot()
        sh = self._shrink_snapshot()
        sess = (self.monitor.totals() if self.monitor is not None
                else dict.fromkeys(("sessions_live", "session_events",
                                    "frontier_advances", "prefix_hits",
                                    "flips_pushed"), 0))
        c, g = "counter", "gauge"
        out = [
            ("qsm_serve_requests_total", c, "requests received", {},
             float(self.requests)),
            ("qsm_serve_histories_total", c, "history lanes received",
             {}, float(self.histories)),
            ("qsm_serve_faults_total", c, "serve-site degradations",
             {}, float(self.serve_faults)),
            ("qsm_serve_budget_resolved_total", c,
             "engine BUDGET_EXCEEDED resolved by the oracle", {},
             float(self.budget_resolved)),
            ("qsm_admission_queue_depth", g, "admission lane bound",
             {}, float(adm["queue_depth"])),
            ("qsm_admission_in_flight", g, "admitted lanes in flight",
             {}, float(adm["in_flight"])),
            ("qsm_admission_admitted_lanes_total", c, "lanes admitted",
             {}, float(adm["admitted_lanes"])),
            ("qsm_admission_shed_total", c, "requests shed",
             {"reason": "queue_full"}, float(adm["shed_queue"])),
            ("qsm_admission_shed_total", c, "requests shed",
             {"reason": "deadline"}, float(adm["shed_deadline"])),
            ("qsm_batcher_batches_total", c, "micro-batches dispatched",
             {}, float(bat["batches"])),
            ("qsm_batcher_lanes_total", c, "lanes dispatched", {},
             float(bat["lanes"])),
            ("qsm_batcher_occupancy", g, "mean batch occupancy", {},
             float(bat["mean_occupancy"])),
            ("qsm_cache_entries", g, "verdict-cache live entries", {},
             float(cache["entries"])),
            ("qsm_cache_hits_total", c, "verdict-cache hits", {},
             float(cache["hits"])),
            ("qsm_cache_misses_total", c, "verdict-cache misses", {},
             float(cache["misses"])),
            ("qsm_cache_hit_ratio", g, "verdict-cache hit ratio", {},
             float(cache["hit_rate"])),
            ("qsm_pcomp_split_total", c, "request histories decomposed",
             {}, float(pc["split"])),
            ("qsm_pcomp_sublanes_total", c, "per-key sub-lanes produced",
             {}, float(pc["sub_lanes"])),
            ("qsm_shrink_requests_total", c, "shrink requests", {},
             float(sh["requests"])),
            ("qsm_shrink_rounds_total", c, "shrink frontier rounds",
             {}, float(sh["rounds"])),
            ("qsm_session_live", g, "live monitor sessions", {},
             float(sess["sessions_live"])),
            ("qsm_session_events_total", c, "session events streamed",
             {}, float(sess["session_events"])),
            ("qsm_session_frontier_advances_total", c,
             "quiescent cuts committed", {},
             float(sess["frontier_advances"])),
            ("qsm_session_prefix_hits_total", c,
             "cuts resumed from the prefix bank", {},
             float(sess["prefix_hits"])),
            ("qsm_session_flips_pushed_total", c,
             "verdict flips pushed to clients", {},
             float(sess["flips_pushed"])),
            ("qsm_obs_span_events_total", c, "span events emitted", {},
             float(self.obs.tracer.events)),
        ]
        if self.pool is not None:
            pool = self.pool.snapshot()
            out += [
                ("qsm_pool_workers_live", g, "live pool workers", {},
                 float(pool["live"])),
                ("qsm_pool_dispatches_total", c, "pooled micro-batches",
                 {}, float(pool["dispatches"])),
                ("qsm_pool_worker_faults_total", c,
                 "workers shed (crash/wedge/kill)", {},
                 float(pool["worker_faults"])),
                ("qsm_pool_respawns_total", c, "worker respawns", {},
                 float(pool["respawns"])),
                ("qsm_pool_quarantines_total", c, "specs quarantined",
                 {}, float(pool["quarantines"])),
            ]
            out += [
                ("qsm_pool_worker_dispatches_total", c,
                 "per-worker dispatches", {"wid": str(w["wid"])},
                 float(w["dispatches"]))
                for w in pool["workers"]]
        out += [("qsm_fault_hits_total", c, "fault-plane rules fired",
                 {"site": site}, float(n))
                for site, n in sorted(fired_snapshot().items())]
        if self.obs.flight is not None:
            fl = self.obs.flight.snapshot()
            out += [
                ("qsm_flight_dumps_total", c, "flight-recorder dumps",
                 {}, float(fl["dumps"])),
                ("qsm_flight_events_recorded_total", c,
                 "events through the flight ring", {},
                 float(fl["recorded"])),
            ]
        return out
