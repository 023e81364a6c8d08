"""The port's router HA, peer-to-peer anti-entropy and bounded catch-up
against the JAX package's (twin of the whole of ``tests/test_fleet_ha.py``,
both lease-store params): the lease state machine (term monotonicity,
one-way supersession), split-brain refusal, client multi-address failover
bit-identical to a single router, gossip convergence with NO router
alive, row-level segment subsumption and the capped fold-forward absorbed
record.  Servers and routers run on ``device="cpu"`` (the reference's
host ladder).  A lease record either package writes reads the same in
the other."""

from __future__ import annotations

import functools
import json
import os
import time

import pytest

from qsm_tpu_torch.fleet.gossip import GossipAgent
from qsm_tpu_torch.fleet.lease import (FileLeaseStore, Lease, TCP_SCHEME,
                                 TcpLeaseStore)
from qsm_tpu_torch.fleet.replog import SegmentedLog
from qsm_tpu_torch.fleet.router import FleetRouter as _FleetRouter
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.obs import load_dump, load_events
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.resilience.policy import preset
from qsm_tpu_torch.serve.cache import VerdictCache, fingerprint_key
from qsm_tpu_torch.serve.client import CheckClient
from qsm_tpu_torch.serve.protocol import VERDICT_NAMES
from qsm_tpu_torch.serve.server import CheckServer as _CheckServer

CheckServer = functools.partial(_CheckServer, device="cpu")
FleetRouter = functools.partial(_FleetRouter, device="cpu")
SPEC = CasSpec()
TTL = 0.5


@pytest.fixture(scope="module")
def corpus():
    from qsm_tpu_torch.utils.corpus import build_corpus

    return build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=10,
                        n_pids=4, max_ops=10, seed_base=0,
                        seed_prefix="fleet_ha")


@pytest.fixture(scope="module")
def expected(corpus):
    oracle = WingGongCPU(memo=True)
    return [VERDICT_NAMES[int(v)]
            for v in oracle.check_histories(SPEC, corpus)]


def _nodes(tmp_path, n=2, seal_rows=8):
    return [CheckServer(node_id=f"n{i}",
                        replog_dir=str(tmp_path / f"replog{i}"),
                        replog_seal_rows=seal_rows,
                        flush_s=0.005).start() for i in range(n)]


def _router(nodes, node_id="router", lease_path=None, **kw):
    kw.setdefault("policy", preset("fleet-route").with_(timeout_s=3.0))
    kw.setdefault("probe_policy",
                  preset("fleet-probe").with_(timeout_s=1.0))
    kw.setdefault("heartbeat_s", 0.2)
    kw.setdefault("anti_entropy_s", 0.0)
    if lease_path is not None:
        kw.setdefault("lease_ttl_s", TTL)
        kw.setdefault("ha_beat_s", 0.0)  # tests drive beats by hand
    return FleetRouter([(s.node_id, s.address) for s in nodes],
                       node_id=node_id, lease_path=lease_path,
                       **kw).start()


# --- the lease itself ------------------------------------------------------

@pytest.fixture(params=["file", "tcp"])
def lease_store(request, tmp_path):
    """BOTH lease stores: the raw record path (file) and a
    lease-hosting node's ``tcp://`` address whose own FileLeaseStore
    backs the SAME record file.  Every term/expiry pin must hold
    identically over both — the TCP store is a transport, never a
    different arbitration."""
    path = str(tmp_path / "lease.json")
    if request.param == "file":
        yield path, path
    else:
        host = CheckServer(lease_path=path).start()
        try:
            yield TCP_SCHEME + host.address, path
        finally:
            host.stop()


def test_lease_terms_are_monotonic_and_one_way(lease_store):
    target, path = lease_store
    a = Lease(target, holder="rA", ttl_s=0.3)
    b = Lease(target, holder="rB", ttl_s=0.3)
    rec = a.acquire()
    assert rec["term"] == 1 and rec["holder"] == "rA"
    assert b.acquire() is None          # live foreign term: refused
    assert a.renew(1)["term"] == 1      # renew keeps the term
    assert a.acquire()["term"] == 1     # re-acquire of a live own
    #                                     record is a renew, not a bump
    time.sleep(0.35)
    assert a.renew(1) is None           # expired: one-way, never
    #                                     resurrected under term 1
    rec = b.acquire()
    assert rec["term"] == 2 and rec["holder"] == "rB"
    assert a.acquire() is None          # rA must now WIN a later term
    assert a.renew(1) is None
    time.sleep(0.35)
    assert a.acquire()["term"] == 3     # ...which it can, after expiry
    # a garbled record reads as expired, never crashes (written to the
    # BACKING file — over TCP that is the lease host's own record)
    with open(path, "w") as f:
        f.write("{torn")
    assert Lease.expired(b.read())
    assert b.acquire()["term"] == 1     # fresh history after the wipe


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_lease_record_reads_the_same_in_both_packages(tmp_path, writer):
    """One record, two packages: a lease the one package acquires, renews
    and releases reads the same in the other (artifact name, version,
    term, holder, expiry), and a term the one holds is refused to the
    other's candidate until it expires."""
    import qsm_tpu.fleet.lease as jlease
    import qsm_tpu_torch.fleet.lease as please

    assert (jlease._ARTIFACT, jlease._VERSION, jlease.TCP_SCHEME) == (
        please._ARTIFACT, please._VERSION, please.TCP_SCHEME)
    own, other = (jlease, please) if writer == "ref" else (please, jlease)
    path = str(tmp_path / "lease.json")
    a = own.Lease(path, holder="rA", ttl_s=0.3)
    b = other.Lease(path, holder="rB", ttl_s=0.3)
    rec = a.acquire()
    assert rec["term"] == 1
    assert b.read() == a.read() == rec
    assert b.acquire() is None          # live foreign term: refused
    assert a.renew(1)["term"] == 1
    assert b.read() == a.read()
    time.sleep(0.35)
    assert other.lease_expired(a.read()) and own.lease_expired(b.read())
    rec = b.acquire()
    assert rec["term"] == 2 and a.read() == rec
    b.release()
    assert a.read() == b.read() and a.read().get("released")
    assert a.acquire()["term"] == 3


def test_lease_lock_contention_loses_the_beat_never_blocks(tmp_path):
    """The write-transaction lock is kernel-owned flock: a held lock
    makes a competing transaction LOSE its beat (non-blocking refusal,
    retried next beat), and releasing it — which a SIGKILLed holder
    does implicitly, fd teardown being kernel-side — restores
    acquirability with no stale state to break."""
    import fcntl

    path = str(tmp_path / "lease.json")
    a = Lease(path, holder="rA", ttl_s=0.3)
    # a competitor mid-transaction: flock held on the lock file
    fd = os.open(a._lock_path, os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX)
    assert a.acquire() is None      # lost the beat, did not block
    os.close(fd)                    # the holder dies: lock evaporates
    assert a.acquire()["term"] == 1


def test_tcp_lease_store_transport_loss_is_a_lost_beat():
    """A TcpLeaseStore whose host is unreachable loses every beat —
    None from each transaction, never an exception, never a block
    (the exact contract a lost flock beat has)."""
    dead = Lease("tcp://127.0.0.1:1", holder="rA", ttl_s=0.3)
    assert isinstance(dead.store, TcpLeaseStore)
    assert dead.acquire() is None
    assert dead.renew(1) is None
    assert dead.read() is None
    dead.release()                  # a no-op, not a crash
    assert dead.path == "tcp://127.0.0.1:1"


def test_make_store_dispatches_on_scheme(tmp_path):
    assert isinstance(Lease(str(tmp_path / "l.json"), holder="x").store,
                      FileLeaseStore)
    assert isinstance(Lease("tcp://h:1", holder="x").store,
                      TcpLeaseStore)
    # a pre-built store passes through (routers handed a shared store)
    st = FileLeaseStore(str(tmp_path / "l2.json"))
    assert Lease(st, holder="x").store is st


def test_lease_fault_site_demotes_never_serves_stale(tmp_path,
                                                     monkeypatch):
    """The ``lease`` fault site: an injected
    failure at renew is a LOST BEAT — the active demotes (one-way per
    term) instead of serving under a term it cannot prove live, the
    loss is counted, and the beat thread survives."""
    nodes = _nodes(tmp_path, n=1)
    lease = str(tmp_path / "lease.json")
    ra = _router(nodes, node_id="rA", lease_path=lease)
    try:
        assert ra.ha_role == "active" and ra._active_now()
        monkeypatch.setenv("QSM_TPU_FAULTS", "raise:lease")
        ra.ha_beat()
        assert ra.ha_role == "superseded"
        assert not ra._active_now()
        assert ra.lease_faults >= 1
        assert ra.stats()["lease"]["lease_faults"] >= 1
        from qsm_tpu_torch.resilience.faults import fired_snapshot

        assert fired_snapshot().get("lease", 0) >= 1
        monkeypatch.delenv("QSM_TPU_FAULTS")
        # re-entry only by WINNING a later term (the record expires,
        # the gated path takes term 2)
        time.sleep(TTL + TTL * 0.5 + 0.1)
        ra.ha_beat()
        assert ra.ha_role == "active" and ra.term == 2
    finally:
        ra.stop()
        for s in nodes:
            s.stop()


# --- split brain -----------------------------------------------------------

def test_split_brain_exactly_one_router_serves(tmp_path, corpus,
                                               expected, lease_store):
    """THE split-brain pin: two routers, one lease — over BOTH stores.
    After a takeover the stale-term router answers SHED with a
    ``router_superseded`` block — never a verdict — while the new
    active serves under the bumped term."""
    nodes = _nodes(tmp_path, n=2)
    lease, _path = lease_store
    ra = _router(nodes, node_id="rA", lease_path=lease)
    rb = _router(nodes, node_id="rB", lease_path=lease)
    try:
        assert ra.ha_role == "active" and ra.term == 1
        assert rb.ha_role == "standby" and rb.term == 0
        with CheckClient(ra.address, timeout_s=30.0) as c:
            res = c.check("cas", corpus)
            assert res["verdicts"] == expected
            assert res["term"] == 1 and res["node"] == "rA"
        # the standby refuses while the active's term is live
        with CheckClient(rb.address, timeout_s=30.0) as c:
            res = c.check("cas", corpus[:1])
            assert res.get("shed") and res["reason"] == "router_standby"
            assert res["router"]["role"] == "standby"
        # rA wedges (its beats stop); the lease expires; rB's gated
        # promotion path takes term 2 after its own node health probe
        time.sleep(TTL + TTL * 0.5 + 0.1)
        rb.ha_beat()
        assert rb.ha_role == "active" and rb.term == 2
        assert rb.takeovers == 1
        # the stale-term router can never answer a verdict again:
        # its own expiry check refuses BEFORE it even observes term 2
        with CheckClient(ra.address, timeout_s=30.0) as c:
            res = c.check("cas", corpus)
            assert not res.get("ok") and res.get("shed")
            assert res["reason"] == "router_superseded"
            assert res["router"]["term"] == 1
            assert res["router"]["active_term"] == 2
            assert res["router"]["active_holder"] == "rB"
        ra.ha_beat()
        assert ra.ha_role == "superseded"
        # exactly one serves: the new active answers under term 2
        with CheckClient(rb.address, timeout_s=30.0) as c:
            res = c.check("cas", corpus)
            assert res["verdicts"] == expected
            assert res["term"] == 2 and res["node"] == "rB"
    finally:
        ra.stop()
        rb.stop()
        for s in nodes:
            s.stop()


def test_standby_promotion_requires_node_health(tmp_path):
    """A standby that cannot reach ANY fleet node must not take the
    term (a lease expiry observed from behind a partition is not a
    mandate to serve everything from its own ladder)."""
    dead = str(tmp_path / "nowhere.sock")
    lease = str(tmp_path / "lease.json")
    rb = FleetRouter([("n0", dead)], node_id="rB", lease_path=lease,
                     lease_ttl_s=TTL, ha_beat_s=0.0, heartbeat_s=30.0,
                     anti_entropy_s=0.0,
                     probe_policy=preset("fleet-probe").with_(
                         timeout_s=0.3)).start()
    try:
        beat = rb.ha_beat()
        assert rb.ha_role == "standby" and rb.term == 0
        assert beat.get("blocked") == "no reachable node"
    finally:
        rb.stop()


def test_takeover_emits_span_and_flight_dump(tmp_path, corpus):
    """The takeover acceptance artifacts: a ``router.takeover`` span
    carrying the superseded term (what ``trace`` renders) and
    a flight dump with the ``router_takeover`` reason."""
    nodes = _nodes(tmp_path, n=1)
    lease = str(tmp_path / "lease.json")
    trace_log = str(tmp_path / "rb_trace.jsonl")
    flight_dir = str(tmp_path / "rb_flight")
    ra = _router(nodes, node_id="rA", lease_path=lease)
    rb = _router(nodes, node_id="rB", lease_path=lease,
                 trace_log=trace_log, flight_dir=flight_dir)
    try:
        assert ra.ha_role == "active"
        time.sleep(TTL + TTL * 0.5 + 0.1)
        rb.ha_beat()
        assert rb.ha_role == "active" and rb.term == 2
        rb.obs.tracer.close()
        events = [e for e in load_events(trace_log)
                  if e.get("name") == "router.takeover"]
        assert len(events) == 1
        at = events[0]["attrs"]
        assert at["term"] == 2 and at["superseded_term"] == 1
        assert at["superseded_holder"] == "rA"
        dumps = [f for f in sorted(os.listdir(flight_dir))
                 if "router_takeover" in f]
        assert dumps, os.listdir(flight_dir)
        dump = load_dump(os.path.join(flight_dir, dumps[0]))
        assert dump["reason"] == "router_takeover"
    finally:
        ra.stop()
        rb.stop()
        for s in nodes:
            s.stop()


def test_clean_shutdown_hands_the_term_over_immediately(tmp_path,
                                                        lease_store):
    """stop() on the active releases the lease as an expired TOMBSTONE
    (over BOTH stores): the standby's next beat promotes without
    waiting out the TTL, and the term still advances (monotonic across
    clean handovers — the same term must never come from two
    brains)."""
    nodes = _nodes(tmp_path, n=1)
    lease, _path = lease_store
    ra = _router(nodes, node_id="rA", lease_path=lease)
    rb = _router(nodes, node_id="rB", lease_path=lease)
    try:
        assert ra.ha_role == "active" and ra.term == 1
        ra.stop()
        rec = rb.lease.read()
        assert rec is not None and rec.get("released")  # not unlinked
        rb.ha_beat()
        assert rb.ha_role == "active" and rb.term == 2
    finally:
        ra.stop()
        rb.stop()
        for s in nodes:
            s.stop()


# --- client failover -------------------------------------------------------

def test_client_failover_bit_identical_to_single_router(tmp_path,
                                                        corpus,
                                                        expected):
    """``--addr a,b``: the client rides a router death mid-sequence
    onto the other address; every verdict is bit-identical to the
    single-router answer (idempotent ops, fingerprint-banked
    verdicts)."""
    nodes = _nodes(tmp_path, n=2)
    ra = _router(nodes, node_id="rA")
    rb = _router(nodes, node_id="rB")
    try:
        with CheckClient(f"{ra.address},{rb.address}",
                         timeout_s=30.0) as c:
            first = c.check("cas", corpus)
            assert first["verdicts"] == expected
            assert first["node"] == "rA"
            ra.stop()  # the door the client is connected to dies
            # let rA's connection reader notice the stop flag and
            # close (it polls every 0.5 s) — a half-stopped in-process
            # router answering one last buffered request is fine in
            # production but nondeterministic here
            time.sleep(0.7)
            second = c.check("cas", corpus)
            assert second["verdicts"] == expected
            assert second["node"] == "rB"
            assert c.failovers >= 1
            # the answers are the single-router answers, bit-identical
            assert second["verdicts"] == first["verdicts"]
    finally:
        ra.stop()
        rb.stop()
        for s in nodes:
            s.stop()


def test_client_hops_off_standby_shed(tmp_path, corpus, expected):
    """A standby listed first is transparent: its ``router_standby``
    SHED makes the client hop to the active, not surface the SHED."""
    nodes = _nodes(tmp_path, n=1)
    lease = str(tmp_path / "lease.json")
    ra = _router(nodes, node_id="rA", lease_path=lease)
    rb = _router(nodes, node_id="rB", lease_path=lease)
    try:
        assert rb.ha_role == "standby"
        with CheckClient(f"{rb.address},{ra.address}",
                         timeout_s=30.0) as c:
            res = c.check("cas", corpus)
            assert res["ok"] and res["verdicts"] == expected
            assert res["node"] == "rA" and res["term"] == 1
            assert c.failovers >= 1
        assert rb.ha_sheds >= 1  # the standby did refuse, honestly
    finally:
        ra.stop()
        rb.stop()
        for s in nodes:
            s.stop()


def test_client_failover_is_bounded_under_total_partition(tmp_path,
                                                          monkeypatch,
                                                          corpus):
    """The ``router`` fault site: with EVERY client→router exchange
    partitioned, the client raises ConnectionError after its bounded
    attempts — never a wrong answer, never a spin."""
    nodes = _nodes(tmp_path, n=1)
    ra = _router(nodes, node_id="rA")
    try:
        with CheckClient(ra.address, timeout_s=10.0) as c:
            monkeypatch.setenv("QSM_TPU_FAULTS", "partition:router")
            with pytest.raises(ConnectionError):
                c.check("cas", corpus[:1])
            # the site really fired (drill accounting) — checked while
            # the env var is still set: fired_snapshot() answers {}
            # once the plane is off
            from qsm_tpu_torch.resilience.faults import fired_snapshot

            assert fired_snapshot().get("router", 0) >= 1
            monkeypatch.delenv("QSM_TPU_FAULTS")
        with CheckClient(ra.address, timeout_s=10.0) as c:
            assert c.check("cas", corpus[:1])["ok"]
    finally:
        ra.stop()
        for s in nodes:
            s.stop()


def test_node_link_multi_address_failover(tmp_path):
    from qsm_tpu_torch.fleet.router import NodeLink

    srv = CheckServer(node_id="n0").start()
    try:
        dead = str(tmp_path / "nowhere.sock")
        link = NodeLink("n0", f"{dead},{srv.address}")
        resp = link.request({"op": "stats"}, timeout_s=5.0)
        assert resp["ok"] and resp["node"] == "n0"
    finally:
        srv.stop()


# --- gossip: convergence with the router dead ------------------------------

def _wire_gossip(servers, fanout=None):
    for s in servers:
        peers = [(o.node_id, o.address) for o in servers if o is not s]
        s.gossip = GossipAgent(s.node_id, s.replog, s.cache,
                               peers=peers,
                               fanout=fanout or len(peers),
                               interval_s=0.0)  # beats driven by hand
    return servers


def test_gossip_converges_with_no_router_alive(tmp_path, corpus,
                                               expected):
    """The de-hubbing pin: traffic banked on its owner nodes converges
    to EVERY node's replog through node-to-node gossip alone — the
    router is stopped before the first beat — within a bounded number
    of beats (full fan-out: <= 2 rounds)."""
    nodes = _nodes(tmp_path, n=3, seal_rows=1)
    router = _router(nodes, node_id="rA")
    with CheckClient(router.address, timeout_s=60.0) as c:
        res = c.check("cas", corpus)
        assert res["verdicts"] == expected
    router.stop()  # the router is DEAD for everything that follows
    try:
        for s in nodes:
            s.cache.flush()
        _wire_gossip(nodes)
        for _round in range(2):  # the pinned convergence bound
            for s in nodes:
                s.gossip.sweep()
        digests = [s.replog.digests() for s in nodes]
        assert digests[0] == digests[1] == digests[2]
        assert digests[0], "convergence must be of a non-empty set"
        # every node can now answer the whole corpus from its bank
        for s in nodes:
            for h, want in zip(corpus, expected):
                e = s.cache.get(fingerprint_key(SPEC, h))
                assert e is not None
                assert VERDICT_NAMES[e.verdict] == want
        # a further beat moves nothing (quiescent)
        for s in nodes:
            r = s.gossip.sweep()
            assert r["pulled"] == r["pushed"] == 0
    finally:
        for s in nodes:
            s.stop()


def test_gossip_peer_fault_is_excluded_and_bounded(tmp_path):
    """A dead peer costs one bounded connect failure per beat and is
    excluded for the rest of that sweep — the beat completes and the
    live peer still converges."""
    nodes = _nodes(tmp_path, n=2, seal_rows=1)
    try:
        nodes[0].cache.put_many([(f"k{i}", 1, None) for i in range(4)])
        for s in nodes:
            peers = [(o.node_id, o.address) for o in nodes if o is not s]
            peers.append(("ghost", str(tmp_path / "nowhere.sock")))
            s.gossip = GossipAgent(
                s.node_id, s.replog, s.cache, peers=peers, fanout=2,
                interval_s=0.0,
                policy=preset("gossip").with_(timeout_s=1.0))
        r = nodes[1].gossip.sweep()
        assert r["peers"] == 2           # both contacted, one dead
        assert nodes[1].gossip.peer_faults == 1
        assert nodes[0].replog.digests() == nodes[1].replog.digests()
    finally:
        for s in nodes:
            s.stop()


def test_gossip_peers_op_wires_a_running_node(tmp_path):
    """The ``gossip.peers`` op (what ``fleet`` drives):
    configures a running node's peer set + interval, idempotently;
    refused without a replog."""
    from qsm_tpu_torch.serve.protocol import LineChannel, connect, send_doc

    s0 = CheckServer(node_id="n0",
                     replog_dir=str(tmp_path / "r0")).start()
    s1 = CheckServer(node_id="n1").start()  # no replog
    try:
        sock = connect(s0.address, timeout_s=5.0)
        try:
            send_doc(sock, {"op": "gossip.peers",
                            "peers": [["n1", s1.address]],
                            "interval_s": 0.0})
            resp = json.loads(LineChannel(sock).read_line(timeout_s=5.0))
        finally:
            sock.close()
        assert resp["ok"] and resp["peers"] == ["n1"]
        assert s0.gossip is not None
        assert s0.stats()["gossip"]["peers"] == ["n1"]
        sock = connect(s1.address, timeout_s=5.0)
        try:
            send_doc(sock, {"op": "gossip.peers", "peers": []})
            resp = json.loads(LineChannel(sock).read_line(timeout_s=5.0))
        finally:
            sock.close()
        assert not resp["ok"] and "replog" in resp["error"]
    finally:
        s0.stop()
        s1.stop()


# --- bounded catch-up: row-level subsumption -------------------------------

def test_subsumed_segment_never_reshipped_after_compaction(tmp_path):
    """THE subsumption pin: a compacted segment (new identity, old
    rows) whose rows a peer already holds is marked subsumed on the
    peer — zero row lines cross the wire, the name never re-offers,
    and the record survives a restart."""
    a = CheckServer(node_id="a", replog_dir=str(tmp_path / "ra"),
                    replog_seal_rows=1).start()
    b = CheckServer(node_id="b", replog_dir=str(tmp_path / "rb"),
                    replog_seal_rows=1).start()
    try:
        a.cache.put_many([(f"k{i}", i % 2, None) for i in range(12)])
        _wire_gossip([a, b])
        b.gossip.sweep()  # b replicates everything a holds
        assert a.replog.digests() == b.replog.digests()
        # compaction mints a NEW identity for rows b already holds
        a.replog.compact(a.cache._live_lines())
        r = b.gossip.sweep()
        assert r["subsumed"] >= 1, r
        assert r["pulled"] == 0 and r["rows"] == 0, r
        snap = b.replog.snapshot()
        assert snap["subsumed_segments"] >= 1
        assert snap["subsumptions"] >= 1
        assert b.replog.missing(a.replog.digests()) == []
        # adopting a subsumed segment later is a no-op (idempotent)
        (name,) = [n for n in a.replog.digests()
                   if n in b.replog.covered()]
        fp, lines = a.replog.read_segment(name)
        assert b.replog.adopt(name, fp, lines) == []
        # the record is durable: a restarted replog still covers it
        b2 = SegmentedLog(str(tmp_path / "rb"), node_id="b",
                          seal_rows=1)
        assert name in b2.covered()
        assert b2.missing(a.replog.digests()) == []
    finally:
        a.stop()
        b.stop()


def test_router_sweep_subsumes_instead_of_shipping(tmp_path, corpus,
                                                   expected):
    """The router-driven anti-entropy path takes the same shortcut:
    after compaction on one node, the sweep records subsumption on the
    peer instead of re-shipping the rows."""
    nodes = _nodes(tmp_path, n=2, seal_rows=1)
    router = _router(nodes, node_id="rA")
    try:
        with CheckClient(router.address, timeout_s=60.0) as c:
            assert c.check("cas", corpus)["verdicts"] == expected
        for s in nodes:
            s.cache.flush()
        for _ in range(8):
            if router.anti_entropy_sweep()["segments_shipped"] == 0:
                break
        assert nodes[0].replog.digests() == nodes[1].replog.digests()
        nodes[0].replog.compact(nodes[0].cache._live_lines())
        res = router.anti_entropy_sweep()
        assert res["segments_subsumed"] >= 1, res
        assert res["segments_shipped"] == 0, res
        assert nodes[1].replog.missing(
            nodes[0].replog.digests()) == []
        assert router.stats()["anti_entropy"]["segments_subsumed"] >= 1
    finally:
        router.stop()
        for s in nodes:
            s.stop()


def test_absorbed_record_is_capped_with_fold_forward(tmp_path):
    """100 compactions leave the absorbed
    record O(cap) on disk — oldest names fold forward (dropped from
    the record, still covered by the live set via subsumption) and
    the persisted next_seq keeps names collision-free forever."""
    cap = 8
    log = SegmentedLog(str(tmp_path / "n"), node_id="n", seal_rows=1,
                       absorbed_cap=cap)
    cache = VerdictCache(max_entries=4096, store=log)
    sizes = []
    for i in range(100):
        cache.put(f"k{i}", 1, None)
        cache.flush()
        log.compact(cache._live_lines())
        assert len(log.absorbed()) <= cap
        sizes.append(os.path.getsize(
            os.path.join(str(tmp_path / "n"), "absorbed.json")))
    # O(cap): the record's disk footprint stops growing once capped
    assert max(sizes[cap + 2:]) <= sizes[cap + 1] * 2
    assert len(log.absorbed()) == cap
    # fold-forward kept the NEWEST names
    seqs = sorted(int(n.split("-")[2]) for n in log.absorbed())
    assert seqs[0] >= 100 - cap
    # next_seq survives the forgetting: a restart never reuses a seq
    log2 = SegmentedLog(str(tmp_path / "n"), node_id="n", seal_rows=1,
                        absorbed_cap=cap)
    assert log2._next_seq == log._next_seq
    assert log2._next_seq > 100
    # the subsumed record is capped by the same bound
    for i in range(2 * cap):
        fp = "%012x" % i
        log2.note_subsumed(f"seg-x-{i:06d}-{fp}.jsonl", fp)
    assert len(log2.subsumed()) <= cap


# --- the stats surface -----------------------------------------------------

def test_stats_fleet_renders_lease_table(tmp_path, corpus):
    from qsm_tpu_torch.utils.cli import _render_stats_fleet

    nodes = _nodes(tmp_path, n=1)
    lease = str(tmp_path / "lease.json")
    ra = _router(nodes, node_id="rA", lease_path=lease)
    rb = _router(nodes, node_id="rB", lease_path=lease)
    try:
        text = _render_stats_fleet(ra.stats())
        assert "rA [ACTIVE] term 1" in text
        assert "expires_in" in text
        text = _render_stats_fleet(rb.stats())
        assert "rB [STANDBY] term 0" in text
        assert "active: rA term 1" in text
        # leaseless router renders the off line (no HA standby)
        r2 = _router(nodes, node_id="solo")
        try:
            assert "lease: off" in _render_stats_fleet(r2.stats())
        finally:
            r2.stop()
    finally:
        ra.stop()
        rb.stop()
        for s in nodes:
            s.stop()
