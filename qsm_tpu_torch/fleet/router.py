"""Fleet router — N CheckServer nodes behind one protocol-identical door.

The counterpart of the JAX package's ``qsm_tpu/fleet/router.py``, with
its wire documents, counters and span names.  Where the card needs
another design than the reference's:

* **The last rungs run on the card.**  ``device=None`` (the default)
  builds the router's ladder, on its first use only, as the server
  builds its engine: ``FailoverBackend(spec, build_backend(spec,
  plan_search(spec, platform="cuda")))``; the session rung is a
  ``SessionManager(device=None)``.  A healthy fleet's router never
  touches CUDA, and without a card the first ladder use raises
  ``BackendUnavailable``.  ``device="cpu"`` is the reference's host
  ``host_fallback`` ladder, response for response.  The witness oracle
  stays ``WingGongCPU(memo=True)``.  The ladder's BUDGET_EXCEEDED lanes
  are decided again on the exact host checker, by the server's rule
  (``resilience/failover.py::budget_resolver``), so the last rung
  answers what the reference's host ladder answers.  A real device
  error in the ladder answers ``ok: false``
  (``resilience/failover.py::degradable_errors``).
* **A node's device error is not re-decided on the host.**  A node
  answer carrying ``device_error`` (its card failed the batch) is not
  sent to the ladder: the request answers ``ok: false`` with the node's
  error, the router counts it in ``device_errors`` and emits
  ``route.device_error``.  Check, shrink and the session verbs follow
  the same rule; node LOSS (a link fault, a timeout, a partition) still
  re-dispatches across the ring and only then reaches the ladder.

The worker pool scales one host; this tier scales hosts.  The
router speaks the EXISTING client protocol (serve/protocol.py JSON
lines — clients need no changes, ``CheckClient`` points at the router
address) and fronts N :class:`~qsm_tpu_torch.serve.server.CheckServer`
nodes:

* **Routing is the cache identity.**  Each history routes by
  consistent hash over ``serve.cache.fingerprint_key(spec, history)``
  — the same key the verdict bank and the per-sub-history cache
  rows use — so identical traffic keeps landing where its verdicts
  (and its projected-spec sub-rows) are already banked and hot
  (``membership.HashRing``).
* **A lost node is a shed worker.**  A node that crashes, wedges or
  partitions mid-request fails its sub-request; the undecided lanes
  re-dispatch to a surviving node — bounded attempts from the
  ``fleet-route`` :data:`~qsm_tpu_torch.resilience.policy.PRESETS` entry,
  the failed node EXCLUDED (the ``tried`` set; the discipline the
  JAX package's QSM-FLEET-REDISPATCH lint pass gates) — and the
  router's own in-process ladder is the last rung, exactly the
  ``serve/pool.py`` shed ladder one level up.  Nothing a dead node
  banked is lost (banking is per-node, replicated by anti-entropy);
  nothing undecided is ever guessed.
* **SHED, never wrong.**  The router has its own
  ``AdmissionController``; overload, deadline, or a fleet with no
  deciding path left answers ``SHED`` with the per-node health block
  (``admission.shed_doc`` ``fleet`` entry) plus the router's node id
  and flight-dump path.
* **Anti-entropy.**  A background loop exchanges replog segment
  digests between nodes (the ``replog.*`` ops) and ships missing
  segments owner→lacker, so a joining or restarted node catches up to
  the fleet's live verdict set without a full rewrite — the mechanism
  behind zero-verdict-loss rolling restarts (fleet/replog.py).
* **Chaos-testable.**  Every router→node round-trip passes the
  ``node`` fault site (``QSM_TPU_FAULTS=partition:node@5`` etc.), so
  node death, wedge and partition cells run on the CPU platform like
  every other degradation path (tests/test_torch_fleet.py).
* **HA — the router is no longer the tier's last SPOF.**
  Started with ``lease_path=``, N routers race a filesystem lease
  (fleet/lease.py: term + bounded TTL): exactly one wins ACTIVE and
  stamps its ``term`` on every response; the rest run STANDBY —
  membership probing and stats stay live, but check/shrink answer
  ``SHED`` with a ``router`` block (``router_standby``) so a
  multi-address client hops on.  The active renews on the sweep beat;
  a standby promotes only after observing lease expiry PLUS its own
  independent health probe of the nodes, minting term+1 — one-way per
  term, so a router that lost term T sheds ``router_superseded``
  under T forever (split-brain pinned in tests/test_torch_fleet_ha.py).
  Takeover emits the ``router.takeover`` span and fires a flight
  dump.  Clients ride it via ``CheckClient("a,b")`` multi-address
  failover (bounded, safe — all fleet ops are idempotent and verdicts
  bank by fingerprint).

Observability (obs/): the request's trace id rides every
sub-request to the nodes; the router emits ``route.request`` /
``node.dispatch`` / ``node.shed`` / ``route.hop`` / ``route.ladder``
/ ``route.response`` events, so ``qsm-tpu trace <id>`` on the
router's span log shows the hop from a dead node to the surviving
one.  Node death, quarantine and partition are flight-recorder dump
triggers; per-node dispatch counters ride the metrics registry.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..obs import Observability, global_obs, new_span_id, new_trace_id, \
    set_global
from ..ops.backend import Verdict
from ..resilience.faults import InjectedFault, fired_snapshot, inject
from ..resilience.policy import RetryPolicy, preset
from ..serve.admission import AdmissionController
from ..serve.cache import fingerprint_key
from ..serve.protocol import (VERDICT_NAMES, LineChannel, connect,
                              history_to_rows, rows_to_history, send_doc)


class NodeFault(RuntimeError):
    """A sub-request lost to a node; its lanes are undecided and the
    router re-dispatches them (never guesses them)."""


class NodeDead(NodeFault):
    """Connection refused/reset/closed: the node process is gone."""


class NodeTimeout(NodeFault):
    """The node missed its round-trip bound: presumed wedged."""


class NodePartitioned(NodeFault):
    """The fault plane dropped this exchange's frames both directions
    (``partition:node``): the request never arrived, the answer never
    left — indistinguishable from a dead switch, handled the same."""


class NodeDeviceError(RuntimeError):
    """A node answered that its card failed the work (``device_error``
    on its answer): not node loss, so nothing re-dispatches and the
    ladder never re-decides it on the host; the request answers the
    node's error."""


class NodeBusy(RuntimeError):
    """Every pooled link slot to this node is mid-request: router-local
    backpressure, NOT node-health evidence (the WorkerBusy lesson one
    level down — penalizing a hot node's health would chase traffic
    off exactly the node doing the most work).  Callers try another
    node without feeding membership a failure."""


# what a router→node exchange can fail with (InjectedFault covers
# raise:node / hang:node drills)
_LINK_FAULTS = (NodeFault, OSError, ConnectionError, TimeoutError,
                ValueError, InjectedFault)


class NodeLink:
    """Bounded connection pool to ONE node.  Each request borrows a
    pooled (socket, channel) pair — concurrent router connections fan
    into the node's own micro-batcher over parallel sockets — under a
    semaphore bound; a faulted socket is discarded, never reused.

    ``address`` may be a comma-separated list (``a,b``): fresh
    connections try each in order, so a peer reachable on more than
    one door (an HA router pair fronting the same fleet, a node
    re-bound after migration) fails over at connect time.  Safe for
    the same reason the stale-pool retry is: every fleet op is
    idempotent."""

    MAX_CONNS = 16

    def __init__(self, node_id: str, address: str):
        self.node_id = node_id
        self.address = address
        self.addresses = [a.strip() for a in str(address).split(",")
                          if a.strip()]
        if not self.addresses:
            raise ValueError(f"node {node_id}: empty address")
        self._free: List[Tuple[socket.socket, LineChannel]] = []
        self._lock = threading.Lock()
        self._sema = threading.BoundedSemaphore(self.MAX_CONNS)

    def _connect(self, timeout_s: float) -> socket.socket:
        last: Optional[BaseException] = None
        for addr in self.addresses:
            try:
                return connect(addr, timeout_s=timeout_s)
            except (socket.timeout, TimeoutError):
                # a connect TIMEOUT is wedge/partition evidence, not
                # death: propagate so the caller maps it to
                # NodeTimeout (NodeDead would trigger the fresh-
                # connection retry and double the stall per address
                # against a SYN-dropping peer)
                raise
            except OSError as e:
                last = e
        raise NodeDead(f"node {self.node_id}: no address answered "
                       f"({type(last).__name__}: {last})") from last

    def request(self, doc: dict, timeout_s: float) -> dict:
        """One bounded round-trip.  Raises a :class:`NodeFault` family
        member (the caller excludes this node and re-dispatches)."""
        act = inject("node")
        if act == "partition":
            raise NodePartitioned(
                f"node {self.node_id}: frames dropped both directions "
                "(injected partition)")
        if act == "wedge":
            raise NodeTimeout(f"node {self.node_id}: injected wedge")
        timeout_s = max(0.1, float(timeout_s))
        if not self._sema.acquire(timeout=timeout_s):
            raise NodeBusy(
                f"node {self.node_id}: no link slot inside "
                f"{timeout_s:.1f}s (all {self.MAX_CONNS} mid-request)")
        try:
            try:
                return self._round_trip(doc, timeout_s, pooled_ok=True)
            except NodeDead:
                # a POOLED socket dying is expected across a node
                # restart (the peer that owned it is gone; the node at
                # this address may be perfectly healthy) — drop every
                # idle pooled sibling (they died together) and retry
                # ONCE on a FRESH connection before declaring the node
                # lost.  Safe because every fleet op is idempotent:
                # check/shrink/stats are pure and replog.push
                # re-adoption is a no-op, so a request whose response
                # was lost can be re-asked (the same reasoning behind
                # CellJournal resume).  A fresh-connection failure is
                # the real signal and propagates.
                self.close_all()
                return self._round_trip(doc, timeout_s, pooled_ok=False)
        finally:
            self._sema.release()

    def _round_trip(self, doc: dict, timeout_s: float,
                    pooled_ok: bool) -> dict:
        pair: Optional[Tuple[socket.socket, LineChannel]] = None
        try:
            if pooled_ok:
                with self._lock:
                    pair = self._free.pop() if self._free else None
            try:
                if pair is None:
                    sock = self._connect(min(timeout_s, 10.0))
                    pair = (sock, LineChannel(sock))
                sock, chan = pair
                send_doc(sock, doc)
                line = chan.read_line(timeout_s=timeout_s)
            except socket.timeout as e:
                raise NodeTimeout(
                    f"node {self.node_id}: round-trip exceeded "
                    f"{timeout_s:.1f}s") from e
            except TimeoutError as e:
                raise NodeTimeout(f"node {self.node_id}: {e}") from e
            except OSError as e:
                raise NodeDead(
                    f"node {self.node_id}: {type(e).__name__}: {e}"
                ) from e
            if line is None:
                raise NodeDead(f"node {self.node_id}: connection closed")
            try:
                resp = json.loads(line)
            except ValueError as e:
                raise NodeDead(
                    f"node {self.node_id}: undecodable response") from e
            with self._lock:
                if len(self._free) < self.MAX_CONNS:
                    self._free.append(pair)
                    pair = None
            return resp
        finally:
            if pair is not None:
                try:
                    pair[0].close()
                except OSError:
                    pass

    def close_all(self) -> None:
        with self._lock:
            pairs, self._free = self._free, []
        for sock, _chan in pairs:
            try:
                sock.close()
            except OSError:
                pass


class _GroupResult:
    """One node group's decided lanes (or None verdicts = shed)."""

    __slots__ = ("verdicts", "cached", "witnesses", "batches", "node",
                 "faults", "sheds", "device_error")

    def __init__(self, n: int):
        self.verdicts: List[Optional[int]] = [None] * n
        self.cached: List[bool] = [False] * n
        self.witnesses: List[Optional[list]] = [None] * n
        self.batches: List[dict] = []
        self.node: Optional[str] = None
        self.faults = 0
        self.sheds = 0
        # the error of a node whose card failed this group, if any
        self.device_error: Optional[str] = None


class _RoutedSession:
    """One monitor session's router-side journal: the event stream the
    failover replay re-feeds (bounded by the router's event cap) plus
    the node currently owning the live session."""

    __slots__ = ("sid", "model", "spec_kwargs", "events", "node",
                 "lock", "last_used")

    def __init__(self, sid: str, model: str, spec_kwargs: dict):
        self.sid = sid
        self.model = model
        self.spec_kwargs = spec_kwargs or {}
        self.events: List = []
        self.node: Optional[str] = None
        self.lock = threading.Lock()
        self.last_used = time.monotonic()  # idle-eviction clock


class FleetRouter:
    """See module docstring.  ``nodes`` is ``[(node_id, address),
    ...]``; ``start()`` binds and returns like ``CheckServer``."""

    def __init__(self, nodes, host: str = "127.0.0.1", port: int = 0,
                 unix_path: Optional[str] = None, *,
                 policy: Optional[RetryPolicy] = None,
                 probe_policy: Optional[RetryPolicy] = None,
                 serve_policy: Optional[RetryPolicy] = None,
                 ae_policy: Optional[RetryPolicy] = None,
                 queue_depth: int = 4096,
                 quarantine_after: int = 3,
                 readmit_after: int = 2,
                 heartbeat_s: float = 1.0,
                 anti_entropy_s: float = 3.0,
                 ae_max_segments: int = 32,
                 allow_shutdown: bool = True,
                 node_id: str = "router",
                 session_dir: Optional[str] = None,
                 lease_path: Optional[str] = None,
                 lease_ttl_s: float = 3.0,
                 ha_grace_s: Optional[float] = None,
                 ha_beat_s: Optional[float] = None,
                 trace_log: Optional[str] = None,
                 flight_dir: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 obs: Optional[Observability] = None,
                 collect_dir: Optional[str] = None,
                 collect_s: float = 1.0,
                 slo: Optional[str] = None,
                 slo_window_s: float = 60.0,
                 device=None):
        from .membership import Membership

        if not nodes:
            raise ValueError("a fleet needs at least one node")
        # where the last rungs decide: None = the card (built on first
        # ladder use), "cpu" = the reference's host ladder
        self.device = device
        self.on_cpu = device is not None and str(device) == "cpu"
        self.host, self.port, self.unix_path = host, port, unix_path
        self.node_id = node_id
        self.policy = policy or preset("fleet-route")
        self.serve_policy = serve_policy or preset("serve")
        self.ae_policy = ae_policy or preset("anti-entropy")
        self.anti_entropy_s = anti_entropy_s
        self.ae_max_segments = max(1, int(ae_max_segments))
        self.allow_shutdown = allow_shutdown
        self.obs = obs if obs is not None else Observability(
            trace_log=trace_log, flight_dir=flight_dir)
        self.metrics_port = metrics_port
        self._metrics_server = None
        self.membership = Membership(
            nodes, policy=probe_policy,
            quarantine_after=quarantine_after,
            readmit_after=readmit_after,
            heartbeat_s=heartbeat_s, obs=self.obs)
        self.links: Dict[str, NodeLink] = {
            nid: NodeLink(nid, addr) for nid, addr in nodes}
        self.admission = AdmissionController(
            queue_depth=queue_depth, policy=self.serve_policy,
            fleet_state=self.membership.shed_state)
        # the last-rung in-process ladder: one warm host engine +
        # witness oracle per spec, built lazily, dispatch-serialized
        # (engines are stateful — the _EngineEntry discipline)
        self._specs: Dict[str, object] = {}
        self._ladders: Dict[str, tuple] = {}
        # the exact host checker that resolves the card ladder's
        # BUDGET lanes, one a spec, built on the first such lane
        self._ladder_resolvers: Dict[str, object] = {}
        # RLock: _ladder_for's build path re-enters through _spec_for
        self._ladders_lock = threading.RLock()
        # the session verbs' last rung: an in-router
        # SessionManager that takes a session when the fleet is
        # exhausted instead of shedding it — built lazily, like the
        # check path's warm engines above
        self._local_sessions = None
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._t0 = time.monotonic()
        # counters shared across connection threads (QSM-RACE-UNGUARDED)
        self._lock = threading.Lock()
        self.requests = 0
        self.histories = 0
        self.shrink_requests = 0
        self.node_faults = 0     # node exchanges lost (death/wedge/part.)
        self.lease_faults = 0    # lease-store transactions lost (faults)
        self.node_sheds = 0      # node answered SHED (backpressure)
        self.redispatches = 0    # lane groups moved to another node
        self.ladder_batches = 0  # groups the in-process rung decided
        self.ladder_lanes = 0
        self.ladder_resolved = 0  # card-ladder BUDGET lanes made exact
        # answers whose node's card failed (never re-decided here)
        self.device_errors = 0
        self.ae_sweeps = 0
        self.ae_segments_shipped = 0
        self.ae_segments_subsumed = 0  # ships skipped: rows already held
        self.ae_rows_shipped = 0
        # monitor sessions (qsm_tpu_torch/monitor): the router journals each
        # session's event stream (bounded) and routes its ops by the
        # session key; a node lost mid-session is excluded and the
        # journal REPLAYED onto the next ring node — which resumes from
        # the decided prefixes banked under prefix fingerprints (a
        # respawned node reloads them from its replog), so failover
        # costs bank hits, not re-searches (docs/MONITOR.md "Fleet").
        self._sessions_lock = threading.Lock()
        self._sessions: Dict[str, _RoutedSession] = {}
        # durable session journals (monitor/store.py): with
        # ``session_dir`` every journal snapshots/appends behind the
        # live object, so a router restart — or the STANDBY taking the
        # lease, pointed at the same shared store like the lease file —
        # rehydrates a session it never served and replays it onto the
        # ring.  None = journals die with the process.
        self._session_store = None
        if session_dir is not None:
            from ..monitor.store import SessionStore

            self._session_store = SessionStore(session_dir)
        self.max_sessions = 1024
        self.session_event_cap = 65_536   # per-session journal bound
        # a client that crashed without closing must not pin a journal
        # forever: at the cap, journals idle past this are reclaimed
        # (the node-side session evicts on its own clock; a returning
        # client re-opens and replays by seq)
        self.session_idle_s = 3600.0
        self.session_requests = 0
        self.session_replays = 0          # journals replayed onto a node
        self.session_evicted = 0          # idle journals reclaimed at cap
        self.session_ladder = 0           # verbs the in-router rung took
        self.session_migrations = 0       # owners invalidated by a leave
        self.session_rehydrated = 0       # journals loaded from the store
        self._session_n = 0
        # router HA (fleet/lease.py; module docstring).  Without a
        # lease the router is unconditionally active — the single-
        # router deployment.
        self.lease = None
        self.ha_role = "active"      # active | standby | superseded
        self.term = 0                # the term this router last HELD
        self.takeovers = 0
        self.ha_sheds = 0            # check/shrink refused while not active
        self._lease_expires = 0.0    # epoch bound of OUR live term
        self._observed: dict = {}    # last foreign lease record seen
        if lease_path is not None:
            from .lease import Lease

            self.lease = Lease(lease_path, holder=node_id,
                               ttl_s=lease_ttl_s)
            self.ha_role = "standby"  # until the first beat decides
            self.ha_grace_s = (ha_grace_s if ha_grace_s is not None
                               else self.lease.ttl_s * 0.5)
            self._beat_s = (ha_beat_s if ha_beat_s is not None
                            else max(0.05, self.lease.ttl_s / 3.0))
        else:
            self.ha_grace_s = 0.0
            self._beat_s = anti_entropy_s
        # the span id of the event that opened THIS router's current
        # term (router.elect / router.takeover / router.superseded):
        # every route.request roots under it, so `qsm-tpu trace` pulls
        # the fleet-level cause (the takeover) into a request's tree
        # via the causal closure — edges, never cross-process clocks
        self._term_span = ""
        # fleet-wide span collection (obs/collect.py): a dedicated
        # loop pulls every node's span log into ONE collected log with
        # per-node cursors persisted under collect_dir — what `qsm-tpu
        # trace <id> --addr ROUTER` reconstructs cross-process trees
        # from.  Its OWN thread, never the lease beat's: a wedged
        # node's scrape timeout must not delay lease renewal into a
        # spurious takeover.  NOT gated on the lease either: a standby
        # keeps its collected log warm, so a takeover does not lose
        # the old era's node spans.
        self.collector = None
        self.collect_s = max(0.1, float(collect_s))
        if collect_dir is not None:
            from ..obs import SpanCollector

            self.collector = SpanCollector(collect_dir)
        self._m_route_s = self.obs.metrics.histogram(
            "qsm_fleet_route_seconds",
            "router end-to-end request latency, labeled by verb")
        self.obs.metrics.register_collector(self._metric_samples)
        # metrics federation (docs/OBSERVABILITY.md "Fleet"): the
        # router's /metrics scrape fans out obs.metrics to every node
        # at scrape time and re-labels the samples with `node` — down
        # nodes become a staleness gauge, never a hang (bounded
        # round-trips, parallel fan-out)
        self.obs.metrics.register_collector(self._federated_samples)
        # SLO plane (obs/slo.py): same shape as CheckServer's — the
        # router's own per-verb route latency + shed counters under
        # declared objectives, health op + slo.breach flight trigger
        self.slo = None
        if slo:
            from ..obs import SloEvaluator, parse_slo

            self.slo = SloEvaluator(
                parse_slo(slo), latency_hist=self._m_route_s,
                requests_fn=lambda: self.requests,
                sheds_fn=self._shed_total, window_s=slo_window_s,
                on_breach=self._on_slo_breach)
            self.obs.metrics.register_collector(self.slo.metric_samples)

    # -- lifecycle -----------------------------------------------------
    @property
    def address(self) -> str:
        if self.unix_path:
            return self.unix_path
        return f"{self.host}:{self.port}"

    def start(self) -> "FleetRouter":
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
        self._sock.settimeout(0.2)
        self.membership.start()
        # adopt the process-global obs slot only when it is free: a
        # co-resident CheckServer (in-process tests) owns its own —
        # the router must not silently steal its fault/degrade events
        if global_obs() is None:
            set_global(self.obs)
        if self.metrics_port is not None:
            from ..obs import MetricsServer

            self._metrics_server = MetricsServer(
                self.obs.metrics,
                host=self.host if not self.unix_path else "127.0.0.1",
                port=self.metrics_port).start()
            self.metrics_port = self._metrics_server.port
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="qsm-fleet-accept")
        t.start()
        self._threads.append(t)
        if self.lease is not None:
            # the first beat decides the starting role (winner of the
            # lease race goes active; the rest stand by)
            try:
                self.ha_beat()
            except OSError:
                pass
        if self._beat_s and self._beat_s > 0:
            t = threading.Thread(target=self._beat_loop,
                                 daemon=True, name="qsm-fleet-beat")
            t.start()
            self._threads.append(t)
        if self.collector is not None:
            t = threading.Thread(target=self._collect_loop,
                                 daemon=True, name="qsm-fleet-collect")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        first_stop = not self._stop.is_set()
        self._stop.set()
        if first_stop and self.lease is not None \
                and self.ha_role == "active":
            # clean shutdown hands the term over immediately: the
            # standby need not wait out the TTL (a SIGKILLed active
            # can't run this line — that path IS the TTL wait)
            self.lease.release()
        self.membership.stop()
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
        for t in self._threads:
            t.join(2.0)
        for link in self.links.values():
            link.close_all()
        if first_stop:
            self.obs.dump_flight("router_stop", force=True)
        if self.collector is not None:
            self.collector.close()
        self.obs.metrics.unregister_collector(self._metric_samples)
        self.obs.metrics.unregister_collector(self._federated_samples)
        if self.slo is not None:
            self.obs.metrics.unregister_collector(
                self.slo.metric_samples)
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if global_obs() is self.obs:
            set_global(None)
        self.obs.close()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self._stop.wait(timeout_s)

    # -- connection plumbing (the CheckServer shape) -------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_connection,
                             args=(conn,), daemon=True,
                             name="qsm-fleet-conn").start()

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
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, conn: socket.socket, doc: dict) -> None:
        if "node" not in doc:
            doc = {**doc, "node": self.node_id}
        if self.lease is not None and "term" not in doc:
            # the HA contract: every response says which term answered
            # it, so merged logs (and the split-brain pins) can tell a
            # stale brain's answers from the live one's
            doc = {**doc, "term": self.term}
        send_doc(conn, doc)

    _SESSION_OPS = ("session.open", "session.append", "session.close")
    _MEMBER_OPS = ("node.join", "node.leave")

    def _handle(self, conn: socket.socket, req: dict) -> None:
        op = req.get("op", "check")
        if op in ("check", "shrink") + self._SESSION_OPS \
                + self._MEMBER_OPS \
                and not self._active_now():
            # a non-active (or expired-term) router must never answer
            # a verdict: SHED with the router block, client hops on
            trace = str(req.get("trace") or "") or new_trace_id()
            self._send(conn, self._ha_shed(req, trace))
            return
        if op == "stats":
            self._send(conn, {"ok": True, "stats": self.stats()})
        elif op in ("obs.spans", "obs.trace", "obs.metrics", "health"):
            # the observability surface stays up whatever the lease
            # says: a standby's collected log and health answer are
            # exactly what an operator needs mid-takeover
            try:
                self._handle_obs(conn, op, req)
            except OSError:
                raise
            except Exception as e:  # noqa: BLE001 — answer, don't die
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "error": f"{type(e).__name__}: {e}"})
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
                raise
            except Exception as e:  # noqa: BLE001 — answer, don't die
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "error": f"{type(e).__name__}: {e}"})
        elif op in self._SESSION_OPS:
            try:
                self._handle_session(conn, op, req)
            except OSError:
                raise
            except Exception as e:  # noqa: BLE001 — answer, don't die
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "session": req.get("session"),
                                  "error": f"{type(e).__name__}: {e}"})
        elif op in self._MEMBER_OPS:
            try:
                self._handle_membership(conn, op, req)
            except OSError:
                raise
            except Exception as e:  # noqa: BLE001 — answer, don't die
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "error": f"{type(e).__name__}: {e}"})
        else:
            self._send(conn, {"ok": False,
                              "error": f"unknown op {op!r}"})

    # -- spec / ladder plumbing ----------------------------------------
    def _spec_key(self, model: str, spec_kwargs: dict) -> str:
        return json.dumps([model, spec_kwargs or {}], sort_keys=True)

    def _spec_for(self, model: str, spec_kwargs: dict):
        """The spec instance routing fingerprints against — built
        WITHOUT the ladder engines (the healthy path needs only the
        spec; engine/oracle construction waits for the first actual
        ladder rung)."""
        key = self._spec_key(model, spec_kwargs)
        with self._ladders_lock:
            entry = self._specs.get(key)
            if entry is None:
                from ..models.registry import make

                entry = self._specs[key] = make(
                    model, "atomic", spec_kwargs or None)[0]
            return entry

    def _ladder_for(self, model: str, spec_kwargs: dict):
        """(spec, engine, witness oracle, dispatch lock) — the
        in-process last rung, one warm set per spec, built on first
        ladder use only: the planned checker on the card behind
        ``FailoverBackend`` (the server's shape), or the host ladder
        with ``device="cpu"``."""
        spec = self._spec_for(model, spec_kwargs)
        key = self._spec_key(model, spec_kwargs)
        with self._ladders_lock:
            entry = self._ladders.get(key)
            if entry is None:
                from ..ops.wing_gong_cpu import WingGongCPU
                from ..resilience.failover import (FailoverBackend,
                                                   host_fallback)

                if self.on_cpu:
                    engine = host_fallback(spec)
                else:
                    from ..search.planner import build_backend, plan_search

                    engine = FailoverBackend(spec, build_backend(
                        spec, plan_search(spec, platform="cuda"),
                        device=self.device))
                entry = self._ladders[key] = (
                    spec, engine, WingGongCPU(memo=True),
                    threading.Lock())
            return entry

    def _ladder_decide(self, model: str, spec_kwargs, spec, engine,
                       hists) -> List[int]:
        """The ladder engine's verdicts on ``hists``, its BUDGET lanes
        decided again on the exact host checker when the engine is the
        planned checker on the card (the server's rule); the host ladder
        is exact already.  Caller holds the spec's dispatch lock."""
        verdicts = [int(v) for v in engine.check_histories(spec, hists)]
        if self.on_cpu or int(Verdict.BUDGET_EXCEEDED) not in verdicts:
            return verdicts
        from ..resilience.failover import (budget_resolver,
                                           resolve_budget_lanes)

        key = self._spec_key(model, spec_kwargs)
        with self._ladders_lock:
            resolver = self._ladder_resolvers.get(key)
            if resolver is None:
                resolver = self._ladder_resolvers[key] = budget_resolver(
                    spec)
        n = resolve_budget_lanes(resolver, spec, hists, verdicts)
        with self._lock:
            self.ladder_resolved += n
        return verdicts

    def _device_error_doc(self, req: dict, error: str, trace: str,
                          root: str, node: Optional[str],
                          **extra) -> dict:
        """The answer to a request whose node's card failed: ``ok:
        false`` with the node's error, counted and reported, never sent
        to the ladder."""
        with self._lock:
            self.device_errors += 1
        self.obs.event("route.device_error", trace=trace, parent=root,
                       node=node or "", error=error[:200],
                       traces=[trace])
        return {"id": req.get("id"), "ok": False, "trace": trace,
                "error": error, "device_error": error, **extra}

    # -- the one failover step (check AND shrink re-dispatch loops) ----
    def _hop_busy(self, key: str, target: str, tried: Set[str],
                  trace: str, root: str, lanes: int = 0
                  ) -> Optional[str]:
        """Next target after a saturated link: no health feedback (see
        NodeBusy), just the ring walk and its span."""
        nxt = self.membership.node_for(key, exclude=tried)
        self.obs.event("route.hop", trace=trace, parent=root,
                       lanes=lanes, hop_from=target,
                       hop_to=nxt or "ladder", busy=True,
                       traces=[trace])
        return nxt

    def _shed_node(self, key: str, target: str, tried: Set[str],
                   e: BaseException, trace: str, root: str,
                   lanes: int = 0) -> Optional[str]:
        """Account one LOST node exchange and pick the next target:
        the fault counter, membership feedback, the flight-dump
        trigger event (node.shed / node.partition, naming the doomed
        traces) and the route.hop span — ONE implementation for both
        re-dispatch loops, so the safety-critical shape the
        QSM-FLEET-REDISPATCH pass gates cannot diverge between them."""
        with self._lock:
            self.node_faults += 1
        self.membership.note_failure(target, e)
        name = ("node.partition" if isinstance(e, NodePartitioned)
                else "node.shed")
        self.obs.event(name, trace=trace, parent=root, node=target,
                       error=f"{type(e).__name__}: {e}"[:200],
                       traces=[trace])
        nxt = self.membership.node_for(key, exclude=tried)
        with self._lock:
            self.redispatches += 1
        self.obs.event("route.hop", trace=trace, parent=root,
                       lanes=lanes, hop_from=target,
                       hop_to=nxt or "ladder", traces=[trace])
        return nxt

    # -- the check path ------------------------------------------------
    def _handle_check(self, conn: socket.socket, req: dict) -> None:
        from ..models.registry import MODELS

        t_req = time.perf_counter()
        model = req.get("model")
        if model not in MODELS:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": f"unknown model {model!r}; one "
                                       f"of {sorted(MODELS)}"})
            return
        rows_list = req.get("histories")
        if rows_list is None and "history" in req:
            rows_list = [req["history"]]
        if not isinstance(rows_list, list) or not rows_list:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": "request needs a non-empty "
                                       "'histories' (or 'history') "
                                       "array"})
            return
        hists = [rows_to_history(rows) for rows in rows_list]
        spec_kwargs = req.get("spec_kwargs") or {}
        spec = self._spec_for(model, spec_kwargs)
        want_witness = bool(req.get("witness"))
        deadline = self.admission.deadline_for(req.get("deadline_s"))
        trace = str(req.get("trace") or "") or new_trace_id()
        root = ""
        if self.obs.on:
            root = new_span_id()
            self.obs.tracer.emit("route.request", trace=trace,
                                 span=root, parent=self._term_span,
                                 model=model, lanes=len(hists))
        with self._lock:
            self.requests += 1
            self.histories += len(hists)
        if not self.admission.try_admit(len(hists)):
            self._respond(conn, self._shed(req, "queue full", trace,
                                           root), trace, root, t_req)
            return
        try:
            doc = self._route_check(req, model, spec, spec_kwargs,
                                    hists, want_witness, deadline,
                                    trace, root, t_req)
            self._respond(conn, doc, trace, root, t_req,
                          status="shed" if doc.get("shed") else "ok")
        finally:
            self.admission.release(len(hists))

    def _route_check(self, req, model, spec, spec_kwargs, hists,
                     want_witness, deadline, trace, root,
                     t_req) -> dict:
        # route each history by its cache identity; histories sharing a
        # node coalesce into ONE sub-request (the node's micro-batcher
        # takes it from there)
        keys = [fingerprint_key(spec, h) for h in hists]
        routable = self.membership.routable_ids()
        groups: Dict[Optional[str], List[int]] = {}
        for i, key in enumerate(keys):
            nid = self.membership.ring.node_for(key, routable) \
                if routable else None
            groups.setdefault(nid, []).append(i)
        if self.obs.on:
            for nid, idxs in sorted(groups.items(),
                                    key=lambda kv: str(kv[0])):
                self.obs.event("route.assign", trace=trace, parent=root,
                               node=nid or "ladder", lanes=len(idxs))
        results: Dict[Optional[str], _GroupResult] = {}
        group_errors: List[BaseException] = []

        def run_group(nid: Optional[str], idxs: List[int]) -> None:
            try:
                results[nid] = self._dispatch_group(
                    nid, [hists[i] for i in idxs], keys[idxs[0]],
                    model, spec, spec_kwargs, want_witness, deadline,
                    trace, root, req.get("deadline_s"))
            except Exception as e:  # noqa: BLE001 — re-raised below
                # a deterministic error (bad kwargs reaching the
                # ladder, an engine bug) must answer as an ERROR, not
                # masquerade as a retryable SHED — swallow nothing
                group_errors.append(e)

        items = sorted(groups.items(), key=lambda kv: str(kv[0]))
        threads = [threading.Thread(target=run_group, args=(nid, idxs),
                                    daemon=True,
                                    name=f"qsm-fleet-group-{nid}")
                   for nid, idxs in items[1:]]
        for t in threads:
            t.start()
        run_group(*items[0])
        for t in threads:
            t.join(max(0.1, deadline - time.monotonic()) + 5.0)
        if group_errors:
            raise group_errors[0]
        failed = next((results[nid] for nid, _ in items
                       if results.get(nid) is not None
                       and results[nid].device_error), None)
        if failed is not None:
            return self._device_error_doc(req, failed.device_error,
                                          trace, root, failed.node,
                                          model=model)
        verdicts: List[Optional[int]] = [None] * len(hists)
        cached = [False] * len(hists)
        witnesses: List[Optional[list]] = [None] * len(hists)
        batches: List[dict] = []
        nodes_used: Dict[str, int] = {}
        faults = sheds = 0
        for nid, idxs in items:
            res = results.get(nid)
            if res is None:
                return self._shed(req, "fleet exhausted", trace, root)
            faults += res.faults
            sheds += res.sheds
            for j, i in enumerate(idxs):
                verdicts[i] = res.verdicts[j]
                cached[i] = res.cached[j]
                witnesses[i] = res.witnesses[j]
            batches.extend(res.batches)
            if res.node is not None:
                nodes_used[res.node] = (nodes_used.get(res.node, 0)
                                        + len(idxs))
        if any(v is None for v in verdicts):
            # a group shed (deadline / all nodes + ladder refused):
            # never answer partially, never guess
            return self._shed(req, "fleet shed", trace, root)
        doc = {
            "id": req.get("id"), "ok": True, "model": model,
            "trace": trace,
            "verdicts": [VERDICT_NAMES[v] for v in verdicts],
            "cached": cached,
            "violations": sum(v == int(Verdict.VIOLATION)
                              for v in verdicts),
            "undecided": sum(v == int(Verdict.BUDGET_EXCEEDED)
                             for v in verdicts),
            "batches": batches,
            "nodes": nodes_used,
            "seconds": round(time.perf_counter() - t_req, 4),
        }
        if faults:
            doc["node_faults"] = faults
        if sheds:
            doc["node_sheds"] = sheds
        if want_witness:
            doc["witnesses"] = [
                [list(p) for p in w] if w is not None else None
                for w in witnesses]
        return doc

    def _dispatch_group(self, nid: Optional[str], hists, group_key: str,
                        model: str, spec, spec_kwargs, want_witness,
                        deadline: float, trace: str, root: str,
                        deadline_s) -> _GroupResult:
        """Decide one node group: bounded attempts across the ring with
        the failed nodes EXCLUDED, then the in-process ladder.  Lanes
        are all-or-nothing per attempt (a lost node banked nothing the
        router saw), mirroring ``WorkerPool.dispatch``."""
        res = _GroupResult(len(hists))
        subreq = {"op": "check", "id": "fleet-sub", "model": model,
                  "histories": [history_to_rows(h) for h in hists],
                  "trace": trace}
        if spec_kwargs:
            subreq["spec_kwargs"] = spec_kwargs
        if want_witness:
            subreq["witness"] = True
        if deadline_s is not None:
            subreq["deadline_s"] = deadline_s
        tried: Set[str] = set()
        target = nid
        for _attempt in range(max(1, self.policy.attempts)):
            if target is None or self._stop.is_set():
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return res  # deadline: undecided lanes stay None (shed)
            tried.add(target)
            timeout_s = min(self.policy.timeout_s or 30.0, remaining)
            dispatch_span = self.obs.event(
                "node.dispatch", trace=trace, parent=root,
                node=target, lanes=len(hists), traces=[trace])
            if dispatch_span:
                # the node's own `request` root parents under THIS
                # dispatch edge, so the collected fleet tree shows
                # router -> node causally (docs/OBSERVABILITY.md)
                subreq["parent"] = dispatch_span
            try:
                resp = self.links[target].request(subreq, timeout_s)
            except NodeBusy:
                target = self._hop_busy(group_key, target, tried,
                                        trace, root, lanes=len(hists))
                continue
            except _LINK_FAULTS as e:
                res.faults += 1
                target = self._shed_node(group_key, target, tried, e,
                                         trace, root, lanes=len(hists))
                continue
            if resp.get("ok"):
                self.membership.note_success(target)
                res.node = str(resp.get("node") or target)
                names = resp.get("verdicts") or []
                for j, name in enumerate(names[:len(hists)]):
                    res.verdicts[j] = VERDICT_NAMES.index(name)
                res.cached = list(resp.get("cached")
                                  or [False] * len(hists))
                if want_witness:
                    res.witnesses = list(resp.get("witnesses")
                                         or [None] * len(hists))
                for b in resp.get("batches") or []:
                    b = {**b, "node": res.node}
                    if res.faults:
                        # the batch survived a node loss: its own cost
                        # record says so (SearchStats node_faults,
                        # compact "ndf")
                        search = dict(b.get("search") or {})
                        search["ndf"] = (search.get("ndf", 0)
                                         + res.faults)
                        b["search"] = search
                    res.batches.append(b)
                return res
            if resp.get("shed"):
                # cross-fleet backpressure: this node refused honestly;
                # another node (or the ladder) may have room.  NOT a
                # health fault — shedding is the healthy overload answer.
                with self._lock:
                    self.node_sheds += 1
                res.sheds += 1
                prev, target = target, self.membership.node_for(
                    group_key, exclude=tried)
                self.obs.event("route.hop", trace=trace, parent=root,
                               lanes=len(hists), hop_from=prev,
                               hop_to=target or "ladder", shed=True,
                               traces=[trace])
                continue
            if resp.get("device_error"):
                # the node's card failed the batch: answered, never
                # re-decided on the host (module docstring)
                self.membership.note_success(target)
                res.node = str(resp.get("node") or target)
                res.device_error = str(resp["device_error"])
                return res
            # a clean error answer (bad kwargs reach every node the
            # same way): re-dispatching cannot help — fail the group
            # to the ladder, which will raise the same way if it is a
            # request problem
            break
        return self._ladder_group(res, hists, model, spec_kwargs,
                                  want_witness, deadline, trace, root)

    def _ladder_group(self, res: _GroupResult, hists, model: str,
                      spec_kwargs, want_witness, deadline: float,
                      trace: str, root: str) -> _GroupResult:
        """The last rung: the router's own warm ladder (the planned
        checker on the card, or the host cpp→memo ladder) — exact
        verdicts, in-process, serialized per spec."""
        if time.monotonic() >= deadline:
            return res
        spec, engine, oracle, lock = self._ladder_for(model, spec_kwargs)
        self.obs.event("route.ladder", trace=trace, parent=root,
                       lanes=len(hists))
        with lock:
            if want_witness:
                pairs = [oracle.check_witness(spec, h) for h in hists]
                verdicts = [int(v) for v, _w in pairs]
                res.witnesses = [w for _v, w in pairs]
            else:
                verdicts = self._ladder_decide(model, spec_kwargs, spec,
                                               engine, hists)
        res.verdicts = verdicts
        res.node = self.node_id
        with self._lock:
            self.ladder_batches += 1
            self.ladder_lanes += len(hists)
        res.batches.append({
            "batch": f"ladder-{self.ladder_batches}",
            "lanes": len(hists), "width": len(hists),
            "flush": "ladder", "node": self.node_id,
            "search": {"ndf": res.faults}})
        return res

    # -- the shrink verb -----------------------------------------------
    def _handle_shrink(self, conn: socket.socket, req: dict) -> None:
        """Route one minimization to the node owning the ORIGINAL
        history's fingerprint (its verdict bank has the best chance of
        memo hits), bounded re-dispatch on node loss, in-process
        ladder shrink as the last rung."""
        from ..models.registry import MODELS

        t_req = time.perf_counter()
        model = req.get("model")
        if model not in MODELS:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": f"unknown model {model!r}; one "
                                       f"of {sorted(MODELS)}"})
            return
        rows = req.get("history")
        if not isinstance(rows, list) or not rows:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": "shrink needs ONE non-empty "
                                       "'history' rows array"})
            return
        h = rows_to_history(rows)
        spec_kwargs = req.get("spec_kwargs") or {}
        spec = self._spec_for(model, spec_kwargs)
        key = fingerprint_key(spec, h)
        deadline = self.admission.deadline_for(req.get("deadline_s"))
        trace = str(req.get("trace") or "") or new_trace_id()
        root = ""
        if self.obs.on:
            root = new_span_id()
            self.obs.tracer.emit("route.request", trace=trace,
                                 span=root, parent=self._term_span,
                                 model=model, op="shrink", ops=len(h))
        with self._lock:
            self.requests += 1
            self.shrink_requests += 1
        if not self.admission.try_admit(1):
            self._respond(conn, self._shed(req, "queue full", trace,
                                           root), trace, root,
                          t_req, verb='shrink')
            return
        try:
            subreq = {**req, "trace": trace}
            tried: Set[str] = set()
            target = self.membership.node_for(key)
            faults = 0
            for _attempt in range(max(1, self.policy.attempts)):
                if target is None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                tried.add(target)
                # bounded like a check round-trip: a wedged node must
                # cost one link timeout, not the request's whole
                # deadline (a node mid-shrink that outlives the bound
                # still banks its result for the re-ask to hit)
                timeout_s = min(self.policy.timeout_s or 30.0,
                                remaining)
                dispatch_span = self.obs.event(
                    "node.dispatch", trace=trace, parent=root,
                    node=target, op="shrink", traces=[trace])
                if dispatch_span:
                    subreq["parent"] = dispatch_span
                try:
                    resp = self.links[target].request(subreq, timeout_s)
                except NodeBusy:
                    target = self._hop_busy(key, target, tried, trace,
                                            root)
                    continue
                except _LINK_FAULTS as e:
                    faults += 1
                    target = self._shed_node(key, target, tried, e,
                                             trace, root)
                    continue
                if resp.get("ok") or resp.get("shed"):
                    self.membership.note_success(target)
                    doc = {**resp, "id": req.get("id"), "trace": trace}
                    if faults:
                        doc["node_faults"] = faults
                    self._respond(conn, doc, trace, root, t_req,
                                  status=("shed" if resp.get("shed")
                                          else "ok"), verb='shrink')
                    return
                if resp.get("device_error"):
                    self.membership.note_success(target)
                    doc = self._device_error_doc(
                        req, str(resp["device_error"]), trace, root,
                        str(resp.get("node") or target), model=model)
                    self._respond(conn, doc, trace, root, t_req,
                                  status="error", verb='shrink')
                    return
                break  # clean error answer: the ladder will say why
            doc = self._ladder_shrink(req, model, spec_kwargs, h,
                                      deadline, trace, root, faults,
                                      t_req)
            self._respond(conn, doc, trace, root, t_req, verb='shrink')
        finally:
            self.admission.release(1)

    def _ladder_shrink(self, req, model, spec_kwargs, h, deadline,
                       trace, root, faults, t_req) -> dict:
        from ..shrink.shrinker import Shrinker

        spec, engine, _oracle, lock = self._ladder_for(model,
                                                       spec_kwargs)
        self.obs.event("route.ladder", trace=trace, parent=root,
                       op="shrink", ops=len(h))

        def decide(hists):
            if time.monotonic() >= deadline:
                return None
            with lock:
                return np.asarray(self._ladder_decide(
                    model, spec_kwargs, spec, engine, list(hists)))

        shrinker = Shrinker(spec, decide, deadline=deadline)
        res = shrinker.run(h)
        with self._lock:
            self.ladder_batches += 1
        doc = {
            "id": req.get("id"), "ok": True, "model": model,
            "trace": trace, "node": self.node_id,
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
            "why": res.why + ["decided on the router's in-process "
                              "ladder (fleet last rung)"],
            "seconds": round(time.perf_counter() - t_req, 4),
        }
        if faults:
            doc["node_faults"] = faults
        return doc

    # -- monitor sessions (qsm_tpu_torch/monitor; docs/MONITOR.md "Fleet") ---
    def _handle_session(self, conn: socket.socket, op: str,
                        req: dict) -> None:
        """Route one session verb by the session key.  The router
        journals every event it forwards; a node lost mid-session
        (death/wedge/partition) is excluded and the journal replayed
        onto the next ring node — re-open + seq-0 re-append, idempotent
        on both legs, with the decided-prefix bank absorbing the
        engine cost (a respawned node's replog serves the prefixes).
        SHED semantics match ``check``: queue-full, caps and an
        exhausted fleet answer SHED, never a wrong or partial verdict."""
        from ..models.registry import MODELS

        t_req = time.perf_counter()
        trace = str(req.get("trace") or "") or new_trace_id()
        root = ""
        if self.obs.on:
            root = new_span_id()
            self.obs.tracer.emit("route.request", trace=trace,
                                 span=root, parent=self._term_span,
                                 op=op, session=req.get("session"))
        with self._lock:
            self.requests += 1
            self.session_requests += 1
        if op == "session.open":
            model = req.get("model")
            if model not in MODELS:
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "trace": trace,
                                  "error": f"unknown model {model!r}; "
                                           f"one of {sorted(MODELS)}"})
                return
            sid = req.get("session")
            # a named sid that is not live may still be DURABLE (a
            # router restart, or this is the standby post-takeover on
            # the shared store): rehydrate before creating fresh, or
            # the re-open would wipe the journal the client resumes on
            rehydrated = None
            with self._sessions_lock:
                known = sid is not None and str(sid) in self._sessions
            if sid is not None and not known:
                rehydrated = self._rehydrate_session(str(sid))
            created = False
            with self._sessions_lock:
                if sid is not None and str(sid) in self._sessions:
                    sess = self._sessions[str(sid)]
                    if sess.model != model:
                        self._send(conn, {
                            "id": req.get("id"), "ok": False,
                            "trace": trace,
                            "error": f"session {sid} is open against "
                                     f"{sess.model!r}"})
                        return
                else:
                    if len(self._sessions) >= self.max_sessions:
                        now = time.monotonic()
                        for stale in [k for k, v in
                                      self._sessions.items()
                                      if now - v.last_used
                                      >= self.session_idle_s]:
                            self._sessions.pop(stale)
                            self.session_evicted += 1
                    if len(self._sessions) >= self.max_sessions:
                        self._respond(conn, self._shed(
                            req, "session cap", trace, root), trace,
                            root, t_req, verb='session')
                        return
                    if rehydrated is not None:
                        if rehydrated.model != model:
                            self._send(conn, {
                                "id": req.get("id"), "ok": False,
                                "trace": trace,
                                "error": f"session {sid} is durable "
                                         f"against "
                                         f"{rehydrated.model!r}"})
                            return
                        sess = rehydrated
                        self._sessions[sess.sid] = sess
                        self.session_rehydrated += 1
                    else:
                        if sid is None:
                            self._session_n += 1
                            sid = f"{self.node_id}-s{self._session_n:06d}"
                        sess = _RoutedSession(str(sid), model,
                                              req.get("spec_kwargs")
                                              or {})
                        self._sessions[sess.sid] = sess
                        created = True
            if created and self._session_store is not None:
                # seed the durable journal before any events ride it
                # (session lock only — never under _sessions_lock, the
                # one global order; disk IO stays off the registry)
                with sess.lock:
                    self._session_store.snapshot(
                        sess.sid, self._session_doc(sess))
        else:
            sid = str(req.get("session") or "")
            with self._sessions_lock:
                sess = self._sessions.get(sid)
            if sess is None:
                sess = self._rehydrate_session(sid)
                if sess is not None:
                    with self._sessions_lock:
                        raced = self._sessions.get(sid)
                        if raced is not None:
                            sess = raced
                        else:
                            self._sessions[sid] = sess
                            self.session_rehydrated += 1
            if sess is None:
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "session": sid, "trace": trace,
                                  "error": f"unknown session {sid!r}"})
                return
        if not self.admission.try_admit(1):
            self._respond(conn, {**self._shed(req, "queue full", trace,
                                              root), "session":
                                 sess.sid}, trace, root, t_req, verb='session')
            return
        try:
            from ..monitor import SessionLimit

            sess.last_used = time.monotonic()
            deadline = self.admission.deadline_for(req.get("deadline_s"))
            try:
                with sess.lock:
                    doc = self._route_session(sess, op, req, deadline,
                                              trace, root)
                    if doc is None:
                        # the fleet is exhausted: the session verbs'
                        # LAST RUNG is the router's own
                        # in-process SessionManager, exactly the check
                        # path's host ladder — SHED only if that rung
                        # refuses too
                        doc = self._session_ladder(sess, op, req,
                                                   deadline, trace,
                                                   root)
            except SessionLimit as e:
                doc = {**self._shed(req, str(e), trace, root),
                       "session": sess.sid}
            if doc is None:
                doc = {**self._shed(req, "fleet exhausted", trace,
                                    root), "session": sess.sid}
            elif op == "session.close" and doc.get("ok"):
                with self._sessions_lock:
                    self._sessions.pop(sess.sid, None)
                if self._session_store is not None:
                    self._session_store.drop(sess.sid)
            self._respond(conn, doc, trace, root, t_req,
                          status="shed" if doc.get("shed") else "ok",
                          verb='session')
        finally:
            self.admission.release(1)

    @staticmethod
    def _session_doc(sess: _RoutedSession) -> dict:
        """The durable form of one routed session (caller holds
        ``sess.lock``): identity + the full journal.  Small by bound —
        the event cap bounds the journal, snap-every bounds the tail."""
        return {"sid": sess.sid, "model": sess.model,
                "spec_kwargs": dict(sess.spec_kwargs),
                "events": [list(e) for e in sess.events]}

    def _rehydrate_session(self, sid: str
                           ) -> Optional["_RoutedSession"]:
        """Rebuild a routed session from the durable store; None on a
        miss or an unreadable doc.  The caller registers it (and only
        the registered object counts — a racing rehydrate loses).  The
        rebuilt session has ``node=None``, so the next verb replays the
        journal onto the ring owner exactly like a node-loss failover."""
        if self._session_store is None:
            return None
        loaded = self._session_store.load(sid)
        if loaded is None:
            return None
        doc, tail = loaded
        try:
            sess = _RoutedSession(str(doc["sid"]), str(doc["model"]),
                                  dict(doc.get("spec_kwargs") or {}))
            events = [list(e) for e in doc.get("events", [])]
            for batch in tail:
                start = int(batch["seq"])
                if start > len(events):
                    break            # torn tail: stop at the gap
                events.extend(batch["events"]
                              [max(0, len(events) - start):])
            sess.events = events[:self.session_event_cap]
        except (KeyError, TypeError, ValueError):
            return None
        return sess

    def _route_session(self, sess: _RoutedSession, op: str, req: dict,
                       deadline: float, trace: str, root: str
                       ) -> Optional[dict]:
        """One session verb under bounded exclude-and-replay failover;
        None = no node could take it (the caller sheds)."""
        subreq = {**req, "session": sess.sid, "trace": trace}
        if op == "session.append":
            events = req.get("events")
            if not isinstance(events, list) or not events:
                raise ValueError("session.append needs a non-empty "
                                 "'events' array")
            seq = req.get("seq")
            start = int(seq) if seq is not None else len(sess.events)
            if start > len(sess.events):
                raise ValueError(
                    f"session {sess.sid}: append seq {start} leaves a "
                    f"gap (journal holds {len(sess.events)})")
            fresh = events[max(0, len(sess.events) - start):]
            if len(sess.events) + len(fresh) > self.session_event_cap:
                from ..monitor import SessionLimit

                raise SessionLimit(
                    f"session {sess.sid}: router journal cap "
                    f"{self.session_event_cap} reached")
            sess.events.extend(fresh)
            if self._session_store is not None and fresh:
                # journal the fresh suffix behind the live object
                # (caller holds sess.lock; same snap-every compaction
                # contract as MonitorSession.append)
                self._session_store.append_events(sess.sid, start,
                                                  fresh)
                if self._session_store.tail_len(sess.sid) \
                        >= self._session_store.snap_every:
                    self._session_store.snapshot(
                        sess.sid, self._session_doc(sess))
            # the forwarded append is ALWAYS seq-stamped with the
            # batch's journal position: a seq-less client's events
            # were just replayed inside the journal (a fresh/restarted
            # owner), and forwarding them unframed would apply them a
            # second time and desync the node's stream counter
            subreq["seq"] = start
        if op == "session.open":
            subreq.setdefault("spec_kwargs", sess.spec_kwargs)
        key = f"session:{sess.sid}"
        tried: Set[str] = set()
        target = sess.node if sess.node is not None \
            and sess.node in self.membership.routable_ids() \
            else self.membership.node_for(key)
        faults = 0
        for _attempt in range(max(1, self.policy.attempts)):
            if target is None or self._stop.is_set():
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            tried.add(target)
            timeout_s = min(self.policy.timeout_s or 30.0, remaining)
            dispatch_span = self.obs.event(
                "node.dispatch", trace=trace, parent=root,
                node=target, op=op, session=sess.sid, traces=[trace])
            if dispatch_span:
                subreq["parent"] = dispatch_span
            try:
                if target != sess.node:
                    # a fresh owner (first dispatch, or post-failover):
                    # re-establish the session there — open + full
                    # journal replay, both idempotent (seq framing; a
                    # respawned node resumes from its banked prefixes)
                    self._replay_session(sess, target, timeout_s,
                                         trace, root)
                resp = self.links[target].request(subreq, timeout_s)
            except NodeDeviceError as e:
                self.membership.note_success(target)
                sess.node = None
                return self._device_error_doc(
                    req, str(e), trace, root, target, session=sess.sid)
            except NodeBusy:
                target = self._hop_busy(key, target, tried, trace,
                                        root)
                continue
            except _LINK_FAULTS as e:
                faults += 1
                sess.node = None
                target = self._shed_node(key, target, tried, e, trace,
                                         root)
                continue
            if resp.get("unknown_session"):
                # the node restarted and lost the live object (its
                # answer is machine-readable by contract): force a
                # journal replay onto it on the next attempt — NOT a
                # health fault, the node is up and answering
                self.membership.note_success(target)
                sess.node = None
                continue
            if resp.get("ok") or resp.get("shed"):
                self.membership.note_success(target)
                sess.node = target if resp.get("ok") else sess.node
                doc = {**resp, "id": req.get("id"), "trace": trace}
                if faults:
                    doc["node_faults"] = faults
                return doc
            if resp.get("device_error"):
                self.membership.note_success(target)
                return self._device_error_doc(
                    req, str(resp["device_error"]), trace, root,
                    str(resp.get("node") or target), session=sess.sid)
            # a clean error (bad events reach every node the same way):
            # surface it — re-dispatch cannot help
            return {**resp, "id": req.get("id"), "trace": trace}
        return None

    def _replay_session(self, sess: _RoutedSession, target: str,
                        timeout_s: float, trace: str, root: str
                        ) -> None:
        """Re-establish a journaled session on ``target`` (link faults
        propagate to the caller's failover loop)."""
        link = self.links[target]
        open_doc = {"op": "session.open", "id": "fleet-sub",
                    "model": sess.model,
                    "spec_kwargs": sess.spec_kwargs,
                    "session": sess.sid, "trace": trace}
        if root:
            open_doc["parent"] = root
        opened = link.request(open_doc, timeout_s)
        if opened.get("device_error"):
            raise NodeDeviceError(str(opened["device_error"]))
        if not opened.get("ok"):
            raise NodeFault(f"node {target}: session.open refused: "
                            f"{opened.get('error') or opened}")
        if sess.events:
            with self._lock:
                self.session_replays += 1
            replay_span = self.obs.event(
                "session.replay", trace=trace, parent=root,
                session=sess.sid, node=target,
                events=len(sess.events))
            replay_doc = {"op": "session.append", "id": "fleet-sub",
                          "session": sess.sid, "seq": 0,
                          "events": sess.events, "trace": trace}
            if replay_span:
                replay_doc["parent"] = replay_span
            replayed = link.request(replay_doc, timeout_s)
            if replayed.get("device_error"):
                raise NodeDeviceError(str(replayed["device_error"]))
            if not replayed.get("ok"):
                raise NodeFault(
                    f"node {target}: session replay refused: "
                    f"{replayed.get('error') or replayed}")

    def _session_ladder(self, sess: _RoutedSession, op: str, req: dict,
                        deadline: float, trace: str, root: str
                        ) -> Optional[dict]:
        """The session verbs' last in-process rung: with
        every node excluded, the router's own SessionManager takes the
        session — the journal replays into a local MonitorSession
        exactly as it would onto a node (idempotent by seq), and the
        verdict stays exact.  A flip here pushes the UNMINIMIZED
        stream as the repro (the shrink plane lives on the nodes;
        ``complete: false`` says so honestly).  Caller holds
        ``sess.lock``; the local session/manager locks nest inside it
        and never the other way — the one global order."""
        from ..monitor import SessionManager

        with self._ladders_lock:
            if self._local_sessions is None:
                self._local_sessions = SessionManager(
                    max_sessions=self.max_sessions,
                    max_events=self.session_event_cap,
                    device=self.device)
            mgr = self._local_sessions
        spec = self._spec_for(sess.model, sess.spec_kwargs)
        self.obs.event("route.ladder", trace=trace, parent=root,
                       op=op, session=sess.sid)
        with self._lock:
            self.session_ladder += 1
        s, resumed = mgr.open(sess.sid, spec, None, trace=trace)
        with s.lock:
            s.model, s.spec_kwargs = sess.model, dict(sess.spec_kwargs)
            if sess.events:   # idempotent journal replay, like a node
                s.append([list(e) if isinstance(e, (list, tuple))
                          else e for e in sess.events], seq=0)
            if op == "session.close":
                verdict = s.close()
                doc = {"id": req.get("id"), "ok": True,
                       "session": s.sid, "seq": s.seq,
                       "verdict": VERDICT_NAMES[verdict],
                       "trace": trace, "flipped": s.flipped,
                       "ladder": True,
                       **{k: v for k, v in s.counters().items()
                          if k != "frontiers"}}
                mgr.close(s.sid)
                return doc
            already_pushed = s.flip_pushed
            verdict = s.decide()
            c = s.counters()
            doc = {"id": req.get("id"), "ok": True, "session": s.sid,
                   "seq": s.seq, "verdict": VERDICT_NAMES[verdict],
                   "trace": trace, "ladder": True,
                   "decided_prefix": c["committed_ops"],
                   "window_ops": c["window_ops"]}
            if op == "session.open":
                doc.update(model=sess.model, resumed=resumed,
                           per_key=False)
            else:
                # the client's batch was journaled before routing, so
                # its events are inside the replay above; the applied
                # count it expects is its own batch's length
                doc["applied"] = len(req.get("events") or [])
            if s.flipped and not already_pushed:
                s.flip_pushed = True
                mgr.note_flip()
                rows = [list(r) for r in (s.flip_rows or s.rows)]
                doc["flip"] = {
                    "verdict": VERDICT_NAMES[int(Verdict.VIOLATION)],
                    "initial_ops": len(rows), "final_ops": len(rows),
                    "rounds": 0, "one_minimal": False,
                    "complete": False, "repro": rows,
                    "why": "router last rung: shrink plane lives on "
                           "the nodes — unminimized stream repro"}
            elif s.flipped:
                doc["flipped"] = True
        return doc

    # -- elastic membership (docs/SERVING.md) --------------------------
    def _handle_membership(self, conn: socket.socket, op: str,
                           req: dict) -> None:
        """``node.join`` adds a node to the ring (consistent hashing
        moves only the ranges its vnode points claim) and opens its
        link; an anti-entropy sweep runs on the spot so the newcomer
        receives the replog segments its new ranges need (handoff is
        gossip-driven and subsumption-bounded — nodes already holding
        the rows ship nothing).  ``node.leave`` retires the node,
        closes its link, and invalidates it as owner of every routed
        session (each journal replays onto the new ring owner on its
        next verb — live migration, exactly-once by seq).  Both are
        idempotent; both are active-gated like every routing op."""
        nid = str(req.get("node") or "")
        if not nid:
            self._send(conn, {"id": req.get("id"), "ok": False,
                              "error": f"{op} needs 'node'"})
            return
        if op == "node.join":
            addr = str(req.get("address") or "")
            if not addr:
                self._send(conn, {"id": req.get("id"), "ok": False,
                                  "error": "node.join needs 'address'"})
                return
            joined = self.membership.add_node(nid, addr)
            old = self.links.get(nid)
            if old is None or joined:
                self.links[nid] = NodeLink(nid, addr)
                if old is not None:
                    old.close_all()
            swept = {}
            if joined and not self._stop.is_set():
                # seed the newcomer's replog NOW (bounded by the
                # anti-entropy preset; the periodic beat finishes any
                # backlog) so its first routed keys hit warm banks
                swept = self.anti_entropy_sweep()
            self._send(conn, {"id": req.get("id"), "ok": True,
                              "joined": joined, "node": nid,
                              "nodes": len(self.membership.all_ids()),
                              "handoff": swept})
            return
        left = self.membership.remove_node(nid)
        migrated = 0
        if left:
            link = self.links.pop(nid, None)
            if link is not None:
                link.close_all()
            # live session migration: snapshot under the registry lock,
            # invalidate owners under each SESSION lock outside it
            # (session-lock-before-manager-lock — the one global order)
            with self._sessions_lock:
                owned = [s for s in self._sessions.values()
                         if s.node == nid]
            for sess in owned:
                with sess.lock:
                    if sess.node == nid:
                        sess.node = None
                        migrated += 1
            if migrated:
                with self._lock:
                    self.session_migrations += migrated
                self.obs.event("session.migrate", node=nid,
                               sessions=migrated)
        self._send(conn, {"id": req.get("id"), "ok": True,
                          "left": left, "node": nid,
                          "sessions_migrated": migrated,
                          "nodes": len(self.membership.all_ids())})

    # -- shed / respond ------------------------------------------------
    def _shed(self, req: dict, reason: str, trace: str = "",
              parent: str = "") -> dict:
        self.obs.event("admission.shed", trace=trace, parent=parent,
                       reason=reason)
        self.obs.note_shed()
        doc = self.admission.shed_doc(req.get("id"), reason,
                                      trace=trace or None,
                                      flight=self.obs.flight_path())
        # the fleet SHED contract: the shedding node's id + dump path
        # ride the refusal — shed_doc added `flight`; the
        # node id lands via _send's stamp, duplicated here for callers
        # reading the doc without the egress stamp
        doc["node"] = self.node_id
        return doc

    def _respond(self, conn, doc: dict, trace: str, root: str,
                 t_req: float, status: str = "ok",
                 verb: str = "check") -> None:
        if doc.get("shed") and status == "ok":
            # every shed — admission-driven included — must close its
            # causal tree as a shed, or span tooling undercounts them
            status = "shed"
        dt = time.perf_counter() - t_req
        if self.obs.on:
            self.obs.tracer.emit("route.response", trace=trace,
                                 parent=root,
                                 ms=round(dt * 1000.0, 3),
                                 status=status,
                                 shed=bool(doc.get("shed")))
        self._m_route_s.observe(dt, verb=verb)
        self._send(conn, doc)

    # -- the HA lease (fleet/lease.py; module docstring) ---------------
    def _active_now(self) -> bool:
        """May THIS router answer verdicts right now?  Leaseless =
        always; leased = active role AND our term's own expiry still
        ahead (one bounded clock compare on the hot path — the beat
        refreshes the bound; a renewal that cannot land in time makes
        this False before any standby can have promoted)."""
        if self.lease is None:
            return True
        return self.ha_role == "active" \
            and time.time() < self._lease_expires

    def ha_beat(self) -> dict:
        """One lease heartbeat: the active renews its term; everyone
        else walks the gated promotion path — observe the record,
        consult its term and expiry, and only past expiry (plus grace)
        probe the nodes independently and acquire term+1.  Public so
        tests and the split-brain pins drive it synchronously."""
        if self.lease is None:
            return {"role": self.ha_role, "term": self.term}
        if self.ha_role == "active":
            rec = self._lease_call(self.lease.renew, self.term)
            if rec is not None:
                self._lease_expires = rec["expires_at"]
            else:
                self._demote(self.lease.read())
            return {"role": self.ha_role, "term": self.term}
        # standby / superseded: the ONE promotion path (QSM-FLEET-LEASE
        # gates exactly this shape — term/expiry consulted, no loop)
        rec = self.lease.read()
        if rec is not None:
            self._observed = {"term": rec.get("term"),
                              "holder": rec.get("holder"),
                              "expires_at": rec.get("expires_at")}
        if not self.lease.expired(rec, self.ha_grace_s):
            return {"role": self.ha_role, "term": self.term}
        if not self._nodes_reachable():
            # a standby that cannot see the fleet must not grab the
            # term just to answer everything from its own ladder
            return {"role": self.ha_role, "term": self.term,
                    "blocked": "no reachable node"}
        got = self._lease_call(self.lease.acquire, self.ha_grace_s)
        if got is not None:
            self._promote(got, superseded=rec)
        return {"role": self.ha_role, "term": self.term}

    def _lease_call(self, fn, *args):
        """One lease-store transaction under the ``lease`` fault site
        (resilience/faults.py): an injected raise/hang — like any
        transport loss a TcpLeaseStore already maps to None — is a
        LOST BEAT, counted, never a dead beat thread.  Safety is
        preserved by construction: a lost renew demotes (one-way per
        term), a lost acquire just waits for the next beat."""
        try:
            return fn(*args)
        except (InjectedFault, OSError):
            with self._lock:
                self.lease_faults += 1
            return None

    def _nodes_reachable(self) -> bool:
        """The standby's independent pre-promotion health probe: at
        least one fleet node must answer THIS router directly — a
        lease expiry observed from behind a partition is not a mandate
        to serve."""
        return any(self.membership.probe(nid)
                   for nid in self.membership.all_ids())

    def _promote(self, rec: dict, superseded: Optional[dict]) -> None:
        takeover = superseded is not None  # vs. a fresh lease's election
        with self._lock:
            self.ha_role = "active"
            self.term = int(rec["term"])
            if takeover:
                self.takeovers += 1
        self._lease_expires = rec["expires_at"]
        if takeover:
            # the takeover span (the bench/test acceptance: `qsm-tpu
            # trace` shows it with the superseded term) — also a
            # flight-dump trigger (obs._DUMP_TRIGGERS), so a takeover
            # leaves an artifact naming what the new active saw.  Its
            # span id becomes the term's root edge: every request this
            # term serves parents under it, so the causal closure of
            # any post-takeover trace includes the takeover itself.
            self._term_span = self.obs.event(
                "router.takeover", node=self.node_id, term=self.term,
                superseded_term=superseded.get("term"),
                superseded_holder=superseded.get("holder"))
        else:
            self._term_span = self.obs.event(
                "router.elect", node=self.node_id, term=self.term)

    def _demote(self, seen: Optional[dict]) -> None:
        """One-way per term: our term is gone (superseded or expired
        unrenewable).  We keep standing by — re-entry only by WINNING
        a later term through the gated promotion path."""
        if seen is not None:
            self._observed = {"term": seen.get("term"),
                              "holder": seen.get("holder"),
                              "expires_at": seen.get("expires_at")}
        with self._lock:
            self.ha_role = "superseded"
        self._lease_expires = 0.0
        # the supersession becomes this router's term edge: its
        # subsequent router_superseded SHED spans parent under it, so
        # a client's bounce off the stale brain reconstructs with its
        # cause in the collected tree
        self._term_span = self.obs.event(
            "router.superseded", node=self.node_id, term=self.term,
            active_term=(seen or {}).get("term"),
            active_holder=(seen or {}).get("holder"))

    def _ha_shed(self, req: dict, trace: str) -> dict:
        """The non-active refusal: SHED with the ``router`` block — a
        stale-term router must never answer a verdict, and the block
        tells a multi-address client (and the operator) where the
        active brain is."""
        with self._lock:
            self.ha_sheds += 1
            was_active = self.term > 0
        reason = "router_superseded" if was_active else "router_standby"
        # the advisory active_term/active_holder come from the BEAT's
        # cached observation (refreshed every ~TTL/3) — a refused
        # request must not cost a lease-file read on the request
        # thread.  One exception: a just-expired active that has not
        # beaten yet observed nothing; read once so its very first
        # superseded SHED can still name the successor.
        observed = self._observed
        if not observed and self.lease is not None:
            rec = self.lease.read()
            if rec is not None:
                observed = self._observed = {
                    "term": rec.get("term"),
                    "holder": rec.get("holder"),
                    "expires_at": rec.get("expires_at")}
        # the refusal leaves a SPAN, parented under this router's term
        # edge (router.superseded / the standby's last observation):
        # a client bouncing between `--addr a,b` during a takeover
        # window reconstructs in the collected tree — its trace shows
        # the stale door's refusal AND the active door's answer
        # (test-pinned in tests/test_torch_obs_fleet.py)
        self.obs.event("admission.shed", trace=trace,
                       parent=self._term_span, reason=reason,
                       role=self.ha_role, term=self.term)
        doc = {"id": req.get("id"), "ok": False, "shed": True,
               "reason": reason, "node": self.node_id}
        if trace:
            doc["trace"] = trace
        doc["router"] = {
            "role": self.ha_role, "term": self.term,
            "active_term": observed.get("term"),
            "active_holder": observed.get("holder"),
        }
        return doc

    # -- the beat loop (lease renewal + anti-entropy) ------------------
    def _beat_loop(self) -> None:
        next_ae = time.monotonic()
        while not self._stop.wait(self._beat_s):
            if self.lease is not None:
                try:
                    self.ha_beat()
                except Exception:  # noqa: BLE001 — the beat survives
                    pass
            if (self.anti_entropy_s and self.anti_entropy_s > 0
                    and self._active_now()
                    and time.monotonic() >= next_ae):
                next_ae = time.monotonic() + self.anti_entropy_s
                try:
                    self.anti_entropy_sweep()
                except Exception:  # noqa: BLE001 — the loop must survive
                    continue

    def anti_entropy_sweep(self) -> dict:
        """One digest-exchange reconciliation: collect every healthy
        node's sealed-segment digests, ship each node the segments it
        neither holds nor has absorbed (owner → lacker), bounded per
        sweep (``ae_max_segments`` and the ``anti-entropy`` preset's
        deadline) so a big backlog drains over several beats.  Public
        so tests and the rolling-restart bench drive it synchronously."""
        sweep_deadline = time.monotonic() + (
            self.ae_policy.deadline_s or 60.0)
        timeout_s = self.ae_policy.timeout_s or 15.0
        digests: Dict[str, Tuple[dict, dict]] = {}
        for nid in sorted(self.membership.healthy_ids()):
            try:
                resp = self.links[nid].request(
                    {"op": "replog.digests"}, timeout_s)
            except NodeBusy:
                continue  # saturated link: catch up next beat
            except _LINK_FAULTS as e:
                self.membership.note_failure(nid, e)
                continue
            if resp.get("ok") and isinstance(resp.get("digests"), dict):
                digests[nid] = (dict(resp["digests"]),
                                dict(resp.get("absorbed") or {}))
        union: Dict[str, str] = {}   # segment name -> an owner node
        for nid, (dig, _ab) in sorted(digests.items()):
            for name in dig:
                union.setdefault(name, nid)
        shipped = rows = subsumed = 0
        covers_cache: Dict[str, Optional[dict]] = {}
        for nid, (dig, ab) in sorted(digests.items()):
            missing = [n for n in sorted(union)
                       if n not in dig and n not in ab]
            for name in missing[:self.ae_max_segments]:
                if time.monotonic() >= sweep_deadline:
                    break
                owner = union[name]
                # pull and push legs blamed SEPARATELY: a dead lacker
                # must not accrue failures to the healthy owner it was
                # being caught up from (and vice versa)
                try:
                    cov = self._ae_covers(owner, name, covers_cache,
                                          timeout_s)
                except NodeBusy:
                    break  # saturated link: finish this node next beat
                except _LINK_FAULTS as e:
                    self.membership.note_failure(owner, e)
                    break
                if cov is not None and cov.get("keys"):
                    # row-level subsumption: the LACKER's own live set
                    # decides whether the rows need to move at all — a
                    # compacted segment it effectively holds is marked
                    # covered without one row line crossing the wire
                    try:
                        sub = self.links[nid].request(
                            {"op": "replog.subsumed", "name": name,
                             "fingerprint": cov.get("fingerprint"),
                             "keys": cov["keys"]}, timeout_s)
                    except NodeBusy:
                        break
                    except _LINK_FAULTS as e:
                        self.membership.note_failure(nid, e)
                        break
                    if sub.get("subsumed"):
                        subsumed += 1
                        continue
                try:
                    pulled = self.links[owner].request(
                        {"op": "replog.pull", "segments": [name]},
                        timeout_s)
                except NodeBusy:
                    break
                except _LINK_FAULTS as e:
                    self.membership.note_failure(owner, e)
                    break
                segs = pulled.get("segments") or []
                if not segs:
                    continue
                try:
                    pushed = self.links[nid].request(
                        {"op": "replog.push", "segments": segs},
                        timeout_s)
                except NodeBusy:
                    break
                except _LINK_FAULTS as e:
                    self.membership.note_failure(nid, e)
                    break
                shipped += int(pushed.get("adopted", 0))
                rows += int(pushed.get("rows", 0))
        with self._lock:
            self.ae_sweeps += 1
            self.ae_segments_shipped += shipped
            self.ae_segments_subsumed += subsumed
            self.ae_rows_shipped += rows
        if shipped or subsumed:
            self.obs.event("fleet.anti_entropy", nodes=len(digests),
                           segments=shipped, rows=rows,
                           subsumed=subsumed)
        return {"nodes": len(digests), "segments_shipped": shipped,
                "segments_subsumed": subsumed, "rows_shipped": rows}

    def _ae_covers(self, owner: str, name: str,
                   cache: Dict[str, Optional[dict]],
                   timeout_s: float) -> Optional[dict]:
        """One segment's row-key coverage from its owner, fetched once
        per sweep however many lackers need it.  None = the owner
        cannot say (old node, unreadable segment): the ship proceeds —
        subsumption is an optimization, never a correctness gate."""
        if name in cache:
            return cache[name]
        resp = self.links[owner].request(
            {"op": "replog.covers", "segments": [name]}, timeout_s)
        cov = None
        for c in resp.get("covers") or []:
            if c.get("name") == name:
                cov = c
        cache[name] = cov
        return cov

    # -- fleet observability: collection / federation / health ---------
    def collect_sweep(self) -> dict:
        """One span-collection sweep (obs/collect.py): pull bounded
        cursor pages of every reachable node's span log into the
        collected log.  Public so tests and the bench drive it
        synchronously; the beat loop runs it every ``collect_s``."""
        if self.collector is None:
            return {}
        timeout_s = self.membership.policy.timeout_s or 5.0
        routable = self.membership.routable_ids()
        nodes = [nid for nid in self.membership.all_ids()
                 if nid in routable]

        def fetch(nid: str, cursor, max_events: int) -> dict:
            return self.links[nid].request(
                {"op": "obs.spans", "cursor": cursor,
                 "max_events": max_events}, timeout_s)

        res = self.collector.sweep(nodes, fetch)
        if res.get("events") or res.get("gaps"):
            self.obs.event("obs.collect", **res)
        return res

    def _collect_loop(self) -> None:
        while not self._stop.wait(self.collect_s):
            try:
                self.collect_sweep()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    def _handle_obs(self, conn: socket.socket, op: str,
                    req: dict) -> None:
        """The router's observability ops: ``obs.trace`` answers from
        the COLLECTED fleet log merged with the router's own span log
        (causal closure — the cross-process tree `qsm-tpu trace <id>
        --addr ROUTER` renders); ``obs.spans`` pages the router's own
        log; ``obs.metrics`` returns the full federated sample set;
        ``health`` folds the router's SLO with every node's."""
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
        # obs.trace: own log + the collected fleet log, one closure
        from ..obs import load_events, trace_closure

        path = self.obs.tracer.path
        trace_id = str(req.get("trace") or "")
        events: List[dict] = []
        if path is not None:
            self.obs.tracer.flush()
            events.extend(load_events(path))
        if self.collector is not None:
            events.extend(load_events(self.collector.out_path))
        self._send(conn, {"id": req.get("id"), "ok": True,
                          "trace": trace_id,
                          "enabled": path is not None,
                          "collected": self.collector is not None,
                          "events": trace_closure(events, trace_id)})

    def _fan_out_nodes(self, fn, timeout_s: float) -> List[str]:
        """Run ``fn(nid)`` for every ROUTABLE node in parallel daemon
        threads with a bounded join — the one fan-out shape behind
        per-node stats, metrics federation and fleet health (a wedged
        node costs the caller ONE timeout, never one per node).
        Returns the live ids attempted; nodes membership already
        knows are down are skipped (the caller reports the hole)."""
        routable = self.membership.routable_ids()
        live = [nid for nid in self.membership.all_ids()
                if nid in routable]
        threads = [threading.Thread(target=fn, args=(nid,),
                                    daemon=True) for nid in live[1:]]
        for t in threads:
            t.start()
        if live:
            fn(live[0])
        for t in threads:
            t.join(timeout_s + 1.0)
        return live

    def _federated_samples(self):
        """Scrape-time metrics federation: every node's own collectors
        re-labeled with ``node`` (bounded label set — node ids come
        from the fleet config), plus a per-node staleness gauge so a
        down node shows as a hole, never as a hang or silence."""
        timeout_s = self.membership.policy.timeout_s or 5.0
        results: Dict[str, Optional[tuple]] = {}

        def fetch(nid: str) -> None:
            t0 = time.perf_counter()
            try:
                resp = self.links[nid].request({"op": "obs.metrics"},
                                               timeout_s)
            except (NodeBusy, *_LINK_FAULTS):
                results[nid] = None
                return
            if not resp.get("ok"):
                results[nid] = None
                return
            results[nid] = (resp.get("samples") or [],
                            time.perf_counter() - t0)

        self._fan_out_nodes(fetch, timeout_s)
        out = []
        for nid in self.membership.all_ids():
            got = results.get(nid)
            stale = got is None
            out.append(("qsm_fleet_node_scrape_stale", "gauge",
                        "1 when the node's metrics could not be "
                        "scraped (down, busy, or unreachable)",
                        {"node": nid}, 1.0 if stale else 0.0))
            if stale:
                continue
            samples, dt = got
            out.append(("qsm_fleet_node_scrape_seconds", "gauge",
                        "last federated scrape round-trip",
                        {"node": nid}, round(dt, 4)))
            for s in samples:
                try:
                    name, mtype, help_, labels, value = s
                    out.append((str(name), str(mtype), str(help_),
                                {**dict(labels), "node": nid},
                                float(value)))
                except (TypeError, ValueError):
                    continue  # one malformed sample, not the scrape
        return out

    def _shed_total(self) -> float:
        adm = self.admission.snapshot()
        with self._lock:
            ha = self.ha_sheds
        return float(adm["shed_queue"] + adm["shed_deadline"] + ha)

    def _on_slo_breach(self, row: dict) -> None:
        self.obs.event("slo.breach", objective=row["objective"],
                       burn=row["burn_rate"], value=row["value"],
                       target=row["target"])

    def health_doc(self, timeout_s: float = 5.0) -> dict:
        """The fleet ``health`` payload: the router's own SLO status
        folded with every node's health answer (parallel, bounded) —
        an unreachable node degrades the fleet, it never hangs the
        op.  Overall status drives `qsm-tpu health`'s exit code."""
        from ..obs import worst_status

        if self.slo is None:
            own = {"status": "ok", "slo": {"configured": False}}
        else:
            doc = self.slo.evaluate()
            own = {"status": doc["status"],
                   "slo": {"configured": True,
                           "window_s": doc["window_s"],
                           "window_actual_s": doc["window_actual_s"],
                           "objectives": doc["objectives"]}}
        fleet: Dict[str, dict] = {}

        def fetch(nid: str) -> None:
            try:
                resp = self.links[nid].request({"op": "health"},
                                               timeout_s)
            except (NodeBusy, *_LINK_FAULTS) as e:
                fleet[nid] = {"status": "unreachable",
                              "error": f"{type(e).__name__}: {e}"[:200]}
                return
            fleet[nid] = ({"status": str(resp.get("status", "ok")),
                           "slo": resp.get("slo")}
                          if resp.get("ok") else
                          {"status": "unreachable",
                           "error": str(resp.get("error"))[:200]})

        live = self._fan_out_nodes(fetch, timeout_s)
        for nid in self.membership.all_ids():
            if nid not in live and nid not in fleet:
                fleet[nid] = {"status": "unreachable",
                              "error": "down (membership)"}
        overall = worst_status(
            [own["status"]] + [n["status"] for n in fleet.values()])
        return {"status": overall, "router": own, "fleet": fleet,
                "role": self.ha_role, "term": self.term,
                "uptime_s": round(time.monotonic() - self._t0, 1)}

    # -- observability -------------------------------------------------
    def node_stats(self, timeout_s: float = 5.0) -> Dict[str, dict]:
        """Best-effort live per-node ``stats`` blocks (down nodes get
        an ``error`` entry — the fleet view must show the hole, not
        hide it).  Nodes the membership already knows are down are
        answered from that knowledge, and the live fetches run in
        parallel: one wedged node must cost the stats op ONE timeout,
        not one per node."""
        out: Dict[str, dict] = {}

        def fetch(nid: str) -> None:
            try:
                resp = self.links[nid].request({"op": "stats"},
                                               timeout_s)
                out[nid] = (resp.get("stats")
                            if resp.get("ok") else
                            {"error": resp.get("error", "bad answer")})
            except (NodeBusy, *_LINK_FAULTS) as e:
                out[nid] = {"error": f"{type(e).__name__}: {e}"[:200]}

        live = self._fan_out_nodes(fetch, timeout_s)
        for nid in self.membership.all_ids():
            if nid not in live:
                out[nid] = {"error": "down (membership)"}
        return out

    def stats(self) -> dict:
        with self._lock:
            counters = {
                "requests": self.requests,
                "histories": self.histories,
                "shrink_requests": self.shrink_requests,
                "node_faults": self.node_faults,
                "node_sheds": self.node_sheds,
                "redispatches": self.redispatches,
                "ladder_batches": self.ladder_batches,
                "ladder_lanes": self.ladder_lanes,
                "device_errors": self.device_errors,
            }
            with self._sessions_lock:
                sessions = {
                    "live": len(self._sessions),
                    "requests": self.session_requests,
                    "replays": self.session_replays,
                    "evicted": self.session_evicted,
                    "ladder": self.session_ladder,
                    "migrated": self.session_migrations,
                    "rehydrated": self.session_rehydrated,
                    "durable": self._session_store is not None,
                    "max_sessions": self.max_sessions,
                    "event_cap": self.session_event_cap,
                }
            ae = {"sweeps": self.ae_sweeps,
                  "segments_shipped": self.ae_segments_shipped,
                  "segments_subsumed": self.ae_segments_subsumed,
                  "rows_shipped": self.ae_rows_shipped,
                  "interval_s": self.anti_entropy_s,
                  "policy": self.ae_policy.name}
            lease = {"enabled": self.lease is not None,
                     "role": self.ha_role,
                     "term": self.term,
                     "holder": self.node_id,
                     "takeovers": self.takeovers,
                     "ha_sheds": self.ha_sheds,
                     "lease_faults": self.lease_faults}
        if self.lease is not None:
            lease["path"] = self.lease.path
            lease["store"] = type(self.lease.store).__name__
            lease["ttl_s"] = self.lease.ttl_s
            if self.ha_role == "active":
                lease["expires_in_s"] = round(
                    self._lease_expires - time.time(), 2)
            else:
                lease["active_term"] = self._observed.get("term")
                lease["active_holder"] = self._observed.get("holder")
        return {
            "address": self.address,
            "role": "router",
            "node": self.node_id,
            # where the last rungs decide (the card unless "cpu")
            "device": "cpu" if self.on_cpu else str(self.device or "cuda"),
            "uptime_s": round(time.monotonic() - self._t0, 1),
            "lease": lease,
            **counters,
            # routed monitor sessions: live journals, replays performed
            # on failover, and the journal bounds (docs/MONITOR.md)
            "session": sessions,
            "policy": self.policy.name,
            "admission": self.admission.snapshot(),
            "membership": self.membership.snapshot(),
            "anti_entropy": ae,
            "fleet_nodes": self.node_stats(),
            "obs": self.obs.snapshot(),
            # fleet-wide span collection (obs/collect.py): sweeps,
            # events pulled, gaps and per-node cursor inventory —
            # None unless collect_dir configured collection
            "collect": (self.collector.snapshot()
                        if self.collector is not None else None),
            # the SLO plane (obs/slo.py) — None unless --slo declared
            # objectives for this router
            "slo": (self.slo.snapshot()
                    if self.slo is not None else None),
            "faults": fired_snapshot(),
        }

    def _metric_samples(self):
        """Per-node scrape-time collectors: the fleet's live health and
        traffic, labeled by node id (bounded label set — node ids come
        from the static fleet config)."""
        adm = self.admission.snapshot()
        mem = self.membership.snapshot()
        with self._lock:
            c, g = "counter", "gauge"
            out = [
                ("qsm_fleet_requests_total", c, "router requests", {},
                 float(self.requests)),
                ("qsm_fleet_histories_total", c, "router history lanes",
                 {}, float(self.histories)),
                ("qsm_fleet_node_faults_total", c,
                 "node exchanges lost (death/wedge/partition)", {},
                 float(self.node_faults)),
                ("qsm_fleet_redispatches_total", c,
                 "lane groups moved to another node", {},
                 float(self.redispatches)),
                ("qsm_fleet_ladder_lanes_total", c,
                 "lanes decided on the router's in-process ladder", {},
                 float(self.ladder_lanes)),
                ("qsm_fleet_ae_segments_shipped_total", c,
                 "anti-entropy segments replicated", {},
                 float(self.ae_segments_shipped)),
                ("qsm_fleet_ae_segments_subsumed_total", c,
                 "anti-entropy ships skipped (rows already held)", {},
                 float(self.ae_segments_subsumed)),
                ("qsm_fleet_in_flight", g, "router admitted lanes",
                 {}, float(adm["in_flight"])),
                ("qsm_fleet_lease_term", g,
                 "lease term this router last held", {},
                 float(self.term)),
                ("qsm_fleet_takeovers_total", c,
                 "lease takeovers won by this router", {},
                 float(self.takeovers)),
                ("qsm_fleet_ha_sheds_total", c,
                 "check/shrink refused while not the active router",
                 {}, float(self.ha_sheds)),
            ]
        out.append(("qsm_fleet_active", "gauge",
                    "1 while this router's term is live", {},
                    1.0 if self._active_now() else 0.0))
        out += [
            ("qsm_fleet_node_healthy", "gauge",
             "node health (1 healthy, 0 down/quarantined)",
             {"node": n["node"]},
             1.0 if n["healthy"] and not n["quarantined"] else 0.0)
            for n in mem["nodes"]]
        out += [
            ("qsm_fleet_node_probe_failures_total", "counter",
             "membership probe failures", {"node": n["node"]},
             float(n["failures"])) for n in mem["nodes"]]
        return out
