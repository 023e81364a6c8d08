"""Fleet membership — node health, quarantine, and the routing ring.

The counterpart of the JAX package's ``qsm_tpu/fleet/membership.py``,
behaviourally identical: the ring decides which node owns which
fingerprint, so both packages route a key to the same node.

The fleet tier treats a NODE exactly the way ``serve/pool.py`` treats
a worker process and ``resilience/failover.py`` treats a chip: health
is probed with bounded calls, a node that keeps missing its bound is
presumed wedged and QUARANTINED one-way (routing stops; only the
membership's own probes keep visiting), and a quarantined node is
RE-ADMITTED only on sustained health — ``readmit_after`` consecutive
good probes, not one lucky answer.  Both thresholds and every probe
bound come from the ``fleet-probe`` :data:`~qsm_tpu_torch.resilience.policy.
PRESETS` entry, the same one-timeout-table discipline as the rest of
the stack.

Routing identity lives here too: :class:`HashRing` is a consistent
hash over virtual node points.  Keys are the serving plane's ONE cache
identity — ``serve.cache.fingerprint_key(spec, history)`` — so the
same (spec, history) always lands on the same node while it is
healthy, which is what keeps a node's verdict bank and per-sub-history
cache rows hot.  Health is filtered at LOOKUP time against the
full ring, so a node leaving moves only the keys it owned and a node
returning takes back exactly those keys.

Observability: ``node.down`` / ``node.shed`` / ``fleet.quarantine`` /
``fleet.readmit`` events ride the router's obs sink; quarantine and
node death are flight-recorder dump triggers (qsm_tpu_torch/obs)."""

from __future__ import annotations

import bisect
import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..resilience.policy import RetryPolicy, preset
from ..serve.protocol import LineChannel, connect, send_doc


class HashRing:
    """Consistent hash: each node contributes ``vnodes`` points on a
    sha256 ring; a key routes to the first point clockwise whose node
    is allowed (healthy and not excluded).  Deterministic for a given
    node set — the routing table is a pure function, never state."""

    def __init__(self, node_ids: Sequence[str], vnodes: int = 64):
        points: List[Tuple[int, str]] = []
        for nid in node_ids:
            for v in range(vnodes):
                h = hashlib.sha256(f"{nid}:{v}".encode()).hexdigest()
                points.append((int(h[:16], 16), nid))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]
        self.node_ids = list(node_ids)

    def node_for(self, key: str, allowed: Set[str],
                 exclude: Optional[Set[str]] = None) -> Optional[str]:
        """The key's owner among ``allowed - exclude`` (first
        clockwise point; walking the ring keeps non-excluded keys
        where they were).  None when nobody qualifies."""
        if not self._points:
            return None
        exclude = exclude or set()
        pos = int(hashlib.sha256(key.encode()).hexdigest()[:16], 16)
        start = bisect.bisect_right(self._keys, pos)
        seen: Set[str] = set()
        for i in range(len(self._points)):
            nid = self._points[(start + i) % len(self._points)][1]
            if nid in seen:
                continue
            seen.add(nid)
            if nid in allowed and nid not in exclude:
                return nid
        return None


class _Node:
    """One node's health record (all fields guarded by Membership's
    lock — probes, the router's failure feedback and ``stats`` readers
    share it)."""

    __slots__ = ("node_id", "address", "healthy", "quarantined",
                 "consecutive_failures", "consecutive_successes",
                 "probes", "failures", "quarantines", "readmissions",
                 "last_ok", "last_error", "next_probe_at")

    def __init__(self, node_id: str, address: str):
        self.node_id = node_id
        self.address = address
        self.healthy = True          # innocent until a probe says not
        self.quarantined = False
        self.consecutive_failures = 0
        self.consecutive_successes = 0
        self.probes = 0
        self.failures = 0
        self.quarantines = 0
        self.readmissions = 0
        self.last_ok = 0.0
        self.last_error = ""
        self.next_probe_at = 0.0


class Membership:
    """See module docstring.  ``nodes`` is a sequence of
    ``(node_id, address)`` pairs; the probe loop runs on one daemon
    thread between :meth:`start` and :meth:`stop`."""

    def __init__(self, nodes: Sequence[Tuple[str, str]], *,
                 policy: Optional[RetryPolicy] = None,
                 down_after: int = 2,
                 quarantine_after: int = 3,
                 readmit_after: int = 2,
                 heartbeat_s: float = 1.0,
                 vnodes: int = 64,
                 obs=None):
        self.policy = policy or preset("fleet-probe")
        # one missed probe under load is suspicion, not death: a node
        # leaves the healthy set after ``down_after`` CONSECUTIVE
        # failures (flapping every key off a node over one slow stats
        # answer would cost more than it saves — the router's
        # per-request tried-set already excludes a node that just
        # failed THIS request, whatever membership thinks)
        self.down_after = max(1, int(down_after))
        self.quarantine_after = max(self.down_after,
                                    int(quarantine_after))
        self.readmit_after = max(1, int(readmit_after))
        self.heartbeat_s = heartbeat_s
        self._nodes: Dict[str, _Node] = {
            nid: _Node(nid, addr) for nid, addr in nodes}
        self.vnodes = int(vnodes)
        self.ring = HashRing(list(self._nodes), vnodes=self.vnodes)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._obs = obs
        self.probes = 0
        self.probe_failures = 0
        self.quarantines = 0
        self.readmissions = 0
        self.joins = 0
        self.leaves = 0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Membership":
        self._thread = threading.Thread(target=self._probe_loop,
                                        daemon=True,
                                        name="qsm-fleet-membership")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)

    # -- the probe loop ------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            now = time.monotonic()
            for node in list(self._nodes.values()):
                with self._lock:
                    due = now >= node.next_probe_at
                if due:
                    self.probe(node.node_id)

    def probe(self, node_id: str) -> bool:
        """One bounded health round-trip (a ``stats`` request — the
        cheapest op every node answers).  Feeds the same success/
        failure bookkeeping the router's dispatch feedback does."""
        node = self._nodes[node_id]
        with self._lock:
            self.probes += 1
            node.probes += 1
        ok = False
        try:
            sock = connect(node.address,
                           timeout_s=self.policy.timeout_s or 5.0)
            try:
                send_doc(sock, {"op": "stats"})
                line = LineChannel(sock).read_line(
                    timeout_s=self.policy.timeout_s or 5.0,
                    stop=self._stop.is_set)
                ok = bool(line) and bool(json.loads(line).get("ok"))
            finally:
                sock.close()
        except (OSError, ValueError, TimeoutError) as e:
            self.note_failure(node_id, e, probe=True)
            return False
        if ok:
            self.note_success(node_id)
        else:
            self.note_failure(node_id, RuntimeError("bad stats answer"),
                              probe=True)
        return ok

    # -- health feedback (probe loop AND router dispatch) --------------
    def note_failure(self, node_id: str, err: BaseException,
                     probe: bool = False) -> None:
        node = self._nodes.get(node_id)
        if node is None:
            return
        quarantined_now = False
        with self._lock:
            if probe:
                self.probe_failures += 1
            node.failures += 1
            node.consecutive_failures += 1
            node.consecutive_successes = 0
            node.last_error = f"{type(err).__name__}: {err}"[:200]
            was_healthy = node.healthy
            if node.consecutive_failures >= self.down_after:
                node.healthy = False
            # while down, probes back off (bounded by the preset's
            # schedule shape) so a dead node costs beats, not spins
            backoff = (self.policy.backoff_s or 1.0) * min(
                2 ** max(0, node.consecutive_failures - 1), 16)
            node.next_probe_at = time.monotonic() + backoff
            if (node.consecutive_failures >= self.quarantine_after
                    and not node.quarantined):
                node.quarantined = True
                node.quarantines += 1
                self.quarantines += 1
                quarantined_now = True
        if was_healthy and not node.healthy:
            self._emit("node.down", node=node_id,
                       error=node.last_error)
        if quarantined_now:
            self._emit("fleet.quarantine", node=node_id,
                       failures=node.consecutive_failures)

    def note_success(self, node_id: str) -> None:
        node = self._nodes.get(node_id)
        if node is None:
            return
        readmitted = recovered = False
        with self._lock:
            node.consecutive_failures = 0
            node.consecutive_successes += 1
            node.last_ok = time.monotonic()
            node.next_probe_at = 0.0
            if node.quarantined:
                # one good answer is luck; sustained health re-admits
                if node.consecutive_successes >= self.readmit_after:
                    node.quarantined = False
                    node.healthy = True
                    node.readmissions += 1
                    self.readmissions += 1
                    readmitted = True
            elif not node.healthy:
                node.healthy = True
                recovered = True
        if readmitted:
            self._emit("fleet.readmit", node=node_id)
        elif recovered:
            self._emit("node.up", node=node_id)

    def _emit(self, name: str, **attrs) -> None:
        if self._obs is None or not self._obs.on:
            return
        self._obs.event(name, **attrs)

    # -- elastic membership ------------------------------------------
    def add_node(self, node_id: str, address: str) -> bool:
        """JOIN: the node's vnode points enter the ring.  Consistent
        hashing moves ONLY the key ranges those points claim — every
        other key keeps its owner, so the fleet's hot banks stay hot
        through a rebalance.  Idempotent: re-joining a member is a
        no-op (False), except that a member re-joining from a NEW
        address re-addresses in place (a node that moved hosts keeps
        its identity, health record and key ranges)."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                if node.address == address:
                    return False
                node.address = address           # moved hosts, same nid
            else:
                self._nodes[node_id] = _Node(node_id, address)
                self.ring = HashRing(list(self._nodes),
                                     vnodes=self.vnodes)
            self.joins += 1
        self._emit("fleet.join", node=node_id, address=address)
        return True

    def remove_node(self, node_id: str) -> bool:
        """LEAVE: the node's vnode points retire; only the key ranges
        it owned move (to the next point clockwise).  Idempotent —
        removing a non-member is a no-op (False)."""
        with self._lock:
            if node_id not in self._nodes:
                return False
            del self._nodes[node_id]
            self.ring = HashRing(list(self._nodes), vnodes=self.vnodes)
            self.leaves += 1
        self._emit("fleet.leave", node=node_id)
        return True

    # -- routing queries -----------------------------------------------
    def address_of(self, node_id: str) -> str:
        return self._nodes[node_id].address

    def healthy_ids(self) -> Set[str]:
        with self._lock:
            return {nid for nid, n in self._nodes.items()
                    if n.healthy and not n.quarantined}

    def routable_ids(self) -> Set[str]:
        """The set routing draws from: the healthy nodes — or, when a
        probe storm (a slow host, a mass flap) empties that set, every
        non-quarantined node.  Routing to a suspect node is cheap (the
        dispatch path's bounded attempts + tried-set exclusion handle
        a truly dead one); routing EVERYTHING to the in-process ladder
        because probes were slow starves the fleet of its own banks."""
        healthy = self.healthy_ids()
        if healthy:
            return healthy
        with self._lock:
            return {nid for nid, n in self._nodes.items()
                    if not n.quarantined}

    def all_ids(self) -> List[str]:
        return list(self._nodes)

    def node_for(self, key: str,
                 exclude: Optional[Set[str]] = None) -> Optional[str]:
        return self.ring.node_for(key, self.routable_ids(), exclude)

    # -- observability -------------------------------------------------
    def shed_state(self) -> dict:
        """The compact fleet block SHED responses carry
        (admission.shed_doc): enough for a client to tell 'overloaded'
        from 'down to one node'."""
        with self._lock:
            live = sum(1 for n in self._nodes.values()
                       if n.healthy and not n.quarantined)
            return {"nodes": len(self._nodes), "live": live,
                    "quarantined": sum(1 for n in self._nodes.values()
                                       if n.quarantined)}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "nodes": [{
                    "node": n.node_id, "address": n.address,
                    "healthy": n.healthy,
                    "quarantined": n.quarantined,
                    "probes": n.probes, "failures": n.failures,
                    "quarantines": n.quarantines,
                    "readmissions": n.readmissions,
                    "last_error": n.last_error,
                } for n in self._nodes.values()],
                "probes": self.probes,
                "probe_failures": self.probe_failures,
                "quarantines": self.quarantines,
                "readmissions": self.readmissions,
                "joins": self.joins,
                "leaves": self.leaves,
                "policy": self.policy.name,
            }
