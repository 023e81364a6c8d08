"""The port's fleet tier against the JAX package's (twins of
``tests/test_fleet.py:85-353`` and ``:489-748`` and of
``tests/test_monitor.py:402`` and ``:498``), plus the card's rules.

Routed verdict cases run the same corpus through both packages' fleets
(two in-process nodes and a router each; the port's on ``device="cpu"``:
the host ladder, or ``TorchStepper(device="cpu")`` as each node's
engine), and require the reference's verdicts, node stamps and
witnesses that replay through both packages' ``verify_witness``.
Host-only modules (the ring, membership) run both packages on the same
inputs.  Spawned nodes are ``python -m qsm_tpu_torch serve --device
cpu``.  Waits are on conditions with a deadline, never on fixed counts
of sleeps."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

import qsm_tpu.fleet.membership as jmember
import qsm_tpu.fleet.router as jrouter
import qsm_tpu_torch.fleet.membership as pmember
import qsm_tpu_torch.fleet.router as prouter
from _torch_serve_pkgs import PORT, PORTS, REF

MEMBER = [jmember, pmember]
ROUTER = {REF.root: jrouter, PORT.root: prouter}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus():
    """The reference test's CAS corpus (12 histories, 4 pids x 10 ops),
    built by each package (the same histories)."""
    out = {}
    for pkg in (REF, PORT):
        entry = pkg.MODELS["cas"]
        spec = entry.make_spec()
        out[pkg.root] = (spec, pkg.build_corpus(
            spec, (entry.impls["atomic"], entry.impls["racy"]), n=12,
            n_pids=4, max_ops=10, seed_base=0, seed_prefix="fleet"))
    return out


@pytest.fixture(scope="module")
def expected(corpus):
    spec, hists = corpus[REF.root]
    return REF.names(REF.WingGongCPU(memo=True).check_histories(spec,
                                                                hists))


def _failing_history(pkg):
    entry = pkg.MODELS["cas"]
    spec = entry.make_spec()
    pool = pkg.build_corpus(spec, (entry.impls["atomic"],
                                   entry.impls["racy"]), n=24,
                            n_pids=6, max_ops=16, seed_base=0,
                            seed_prefix="bench_fleet_shrink")
    oracle = pkg.WingGongCPU(memo=True)
    for h in pool:
        if int(oracle.check_histories(spec, [h])[0]) == 0:
            return h
    raise AssertionError("seeded pool produced no violation")


def _fleet(pkg, tmp_path, n_nodes=2, seal_rows=8, router_kw=None,
           node_kw=None):
    """``n_nodes`` in-process nodes with replogs behind a router, built
    as ``pkg`` builds them on the CPU."""
    tag = pkg.id
    nodes = [pkg.server(node_id=f"n{i}",
                        replog_dir=str(tmp_path / f"{tag}_replog{i}"),
                        replog_seal_rows=seal_rows, flush_s=0.005,
                        **(node_kw or {})).start()
             for i in range(n_nodes)]
    router = _router(pkg, [(s.node_id, s.address) for s in nodes],
                     **(router_kw or {}))
    return router, nodes


def _router(pkg, nodes, **kw):
    policy = pkg.m.policy.preset
    kw.setdefault("policy", policy("fleet-route").with_(timeout_s=3.0))
    kw.setdefault("probe_policy",
                  policy("fleet-probe").with_(timeout_s=1.0))
    kw.setdefault("heartbeat_s", 0.2)
    kw.setdefault("anti_entropy_s", 0.0)
    if pkg.port:
        kw.setdefault("device", "cpu")
    return ROUTER[pkg.root].FleetRouter(nodes, **kw).start()


def _teardown(router, nodes):
    router.stop()
    for s in nodes:
        s.stop()


# --- routing identity ------------------------------------------------------

@pytest.mark.parametrize("mod", MEMBER, ids=["ref", "port"])
def test_hash_ring_is_deterministic_and_stable_under_exclusion(mod):
    ring = mod.HashRing(["n0", "n1", "n2"], vnodes=32)
    allowed = {"n0", "n1", "n2"}
    keys = [f"key{i}" for i in range(200)]
    owners = {k: ring.node_for(k, allowed) for k in keys}
    assert owners == {k: ring.node_for(k, allowed) for k in keys}
    assert set(owners.values()) == allowed
    for k in keys:
        moved = ring.node_for(k, allowed, exclude={"n1"})
        if owners[k] != "n1":
            assert moved == owners[k]
        else:
            assert moved in ("n0", "n2")
    assert ring.node_for("x", set()) is None


def test_hash_ring_owner_equals_the_reference(corpus):
    """The ring decides which node owns which fingerprint: for the same
    node ids and keys (fingerprints included) both packages agree."""
    spec, hists = corpus[PORT.root]
    keys = [f"key{i}" for i in range(500)]
    keys += [PORT.fingerprint_key(spec, h) for h in hists]
    jspec, jhists = corpus[REF.root]
    assert keys[500:] == [REF.fingerprint_key(jspec, h) for h in jhists]
    for ids, vnodes in ((["n0", "n1"], 64), (["a", "b", "c", "d"], 8),
                        ([f"node-{i}" for i in range(7)], 64)):
        jr, pr = jmember.HashRing(ids, vnodes), pmember.HashRing(ids,
                                                                 vnodes)
        for allowed in (set(ids), set(ids[1:])):
            for ex in (None, {ids[-1]}):
                assert ([jr.node_for(k, allowed, ex) for k in keys]
                        == [pr.node_for(k, allowed, ex) for k in keys])


@pytest.mark.parametrize("mod", MEMBER, ids=["ref", "port"])
def test_membership_quarantine_and_readmission(mod):
    m = mod.Membership([("n0", "unused:1"), ("n1", "unused:2")],
                       quarantine_after=3, readmit_after=2)
    err = RuntimeError("boom")
    m.note_failure("n0", err)
    assert "n0" in m.healthy_ids()
    m.note_failure("n0", err)
    assert "n0" not in m.healthy_ids()
    assert not m._nodes["n0"].quarantined
    m.note_failure("n1", err)
    m.note_failure("n1", err)
    assert m.healthy_ids() == set()
    assert m.routable_ids() == {"n0", "n1"}
    m.note_success("n1")
    m.note_failure("n0", err)
    assert m._nodes["n0"].quarantined
    assert m.shed_state() == {"nodes": 2, "live": 1, "quarantined": 1}
    m.note_success("n0")
    assert "n0" not in m.healthy_ids()
    m.note_success("n0")
    assert "n0" in m.healthy_ids()
    assert m.readmissions == 1
    m.note_failure("n0", err)
    assert not m._nodes["n0"].quarantined


@pytest.mark.parametrize("mod", MEMBER, ids=["ref", "port"])
def test_membership_join_leave_moves_only_affected_ranges(mod):
    m = mod.Membership([("n0", "unused:1"), ("n1", "unused:2")])
    keys = [f"key{i}" for i in range(300)]
    before = {k: m.ring.node_for(k, {"n0", "n1"}) for k in keys}
    assert m.add_node("n2", "unused:3")
    assert not m.add_node("n2", "unused:3")
    allowed = {"n0", "n1", "n2"}
    after = {k: m.ring.node_for(k, allowed) for k in keys}
    moved = [k for k in keys if after[k] != before[k]]
    assert moved
    assert all(after[k] == "n2" for k in moved)
    assert m.add_node("n1", "moved:9")
    assert m.address_of("n1") == "moved:9"
    assert {k: m.ring.node_for(k, allowed) for k in keys} == after
    assert m.remove_node("n2")
    assert not m.remove_node("n2")
    assert {k: m.ring.node_for(k, {"n0", "n1"}) for k in keys} == before
    snap = m.snapshot()
    assert snap["joins"] == 2 and snap["leaves"] == 1


# --- the routed check path -------------------------------------------------

def _routed(pkg, tmp_path, corpus):
    spec, hists = corpus[pkg.root]
    viol = _failing_history(pkg)
    # a link bound the plain stepper's shrink meets under load (a node
    # that misses it is presumed wedged and the shrink re-dispatched)
    router, nodes = _fleet(pkg, tmp_path, n_nodes=2, router_kw={
        "policy": pkg.m.policy.preset("fleet-route").with_(
            timeout_s=60.0)})
    try:
        with pkg.CheckClient(router.address, timeout_s=60.0) as c:
            res = c.check("cas", hists)
            res2 = c.check("cas", hists)
            resw = c.check("cas", hists[:4], witness=True)
            sres = c.shrink("cas", viol)
            st = c.stats()["stats"]
        return res, res2, resw, sres, st
    finally:
        _teardown(router, nodes)


@pytest.mark.parametrize("pkg", PORTS, ids=lambda p: p.id)
def test_routed_verdicts_match_oracle_and_stamp_nodes(pkg, tmp_path,
                                                      corpus, expected):
    ref = _routed(REF, tmp_path, corpus)
    res, res2, resw, sres, st = _routed(pkg, tmp_path, corpus)
    assert res["ok"] and res["verdicts"] == expected == ref[0]["verdicts"]
    assert res["node"] == "router"
    # the reference's node stamps: the same ring sends the same lanes
    assert res["nodes"] == ref[0]["nodes"]
    assert sum(res["nodes"].values()) == len(expected)
    # (how many flushes a node makes depends on its batcher's clock; the
    # nodes that decided are the ring's)
    assert ({b["node"] for b in res["batches"]}
            == {b["node"] for b in ref[0]["batches"]})
    assert res2["verdicts"] == expected and all(res2["cached"])
    assert res2["cached"] == ref[1]["cached"]
    assert resw["verdicts"] == expected[:4] == ref[2]["verdicts"]
    spec, hists = corpus[PORT.root]
    jspec, jhists = corpus[REF.root]
    for w, h, jh in zip(resw["witnesses"], hists, jhists):
        if w is None:
            continue
        pairs = [tuple(p) for p in w]
        assert PORT.verify_witness(spec, h, pairs)
        assert REF.verify_witness(jspec, jh, pairs)
    assert sres["ok"] and sres["verdict"] == "VIOLATION"
    assert sres["node"] == ref[3]["node"]
    assert sres["final_ops"] == ref[3]["final_ops"]
    assert sres["history"] == ref[3]["history"]
    assert st["role"] == "router" and st["device"] == "cpu"
    assert sorted(st["fleet_nodes"]) == ["n0", "n1"]
    assert st["device_errors"] == 0
    assert all(st["fleet_nodes"][n]["device"] == "cpu"
               for n in ("n0", "n1"))


def test_pcomp_split_traffic_routes_and_matches(tmp_path):
    entry = PORT.MODELS["kv"]
    spec = entry.make_spec()
    hists = PORT.build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]), n=6,
        n_pids=8, max_ops=24, seed_base=100, seed_prefix="fleet_kv")
    want = PORT.names(PORT.WingGongCPU(memo=True).check_histories(
        spec, hists))
    jentry = REF.MODELS["kv"]
    jspec = jentry.make_spec()
    jhists = REF.build_corpus(
        jspec, (jentry.impls["atomic"], jentry.impls["racy"]), n=6,
        n_pids=8, max_ops=24, seed_base=100, seed_prefix="fleet_kv")
    assert want == REF.names(REF.WingGongCPU(memo=True).check_histories(
        jspec, jhists))
    router, nodes = _fleet(PORT, tmp_path, n_nodes=2)
    try:
        with PORT.CheckClient(router.address, timeout_s=120.0) as c:
            res = c.check("kv", hists)
            assert res["ok"] and res["verdicts"] == want
        assert any(s.pcomp_split > 0 for s in nodes)
    finally:
        _teardown(router, nodes)


def test_fleet_shed_carries_node_state_block(tmp_path, corpus):
    _spec, hists = corpus[PORT.root]
    router, nodes = _fleet(PORT, tmp_path, n_nodes=2,
                           router_kw={"queue_depth": 1})
    try:
        with PORT.CheckClient(router.address, timeout_s=30.0) as c:
            res = c.check("cas", hists)
            assert res.get("shed") and not res.get("ok")
            assert res["node"] == "router"
            assert res["fleet"]["nodes"] == 2
            assert res["fleet"]["live"] == 2
            assert "trace" in res
    finally:
        _teardown(router, nodes)


def test_full_partition_degrades_to_ladder(tmp_path, corpus, expected,
                                           monkeypatch):
    _spec, hists = corpus[PORT.root]
    router, nodes = _fleet(PORT, tmp_path, n_nodes=2)
    try:
        monkeypatch.setenv("QSM_TPU_FAULTS", "partition:node@1")
        PORT.reset_faults()
        with PORT.CheckClient(router.address, timeout_s=60.0) as c:
            res = c.check("cas", hists)
            assert res["ok"] and res["verdicts"] == expected
            assert res["node_faults"] >= 1
            assert res["nodes"] == {"router": len(hists)}
            assert any(b["flush"] == "ladder" for b in res["batches"])
            assert any(b.get("search", {}).get("ndf", 0) >= 1
                       for b in res["batches"])
        monkeypatch.delenv("QSM_TPU_FAULTS")
        PORT.reset_faults()
        st = router.stats()
        assert st["node_faults"] >= 1
        assert st["ladder_lanes"] >= len(hists)
        assert st["device_errors"] == 0
    finally:
        _teardown(router, nodes)


def test_partial_partition_redispatches_to_survivor(tmp_path, corpus,
                                                    expected,
                                                    monkeypatch):
    from qsm_tpu_torch.obs import load_events

    _spec, hists = corpus[PORT.root]
    trace_log = str(tmp_path / "trace.jsonl")
    router, nodes = _fleet(PORT, tmp_path, n_nodes=2,
                           router_kw={"trace_log": trace_log})
    try:
        monkeypatch.setenv("QSM_TPU_FAULTS", "partition:node@2")
        PORT.reset_faults()
        with PORT.CheckClient(router.address, timeout_s=60.0) as c:
            res = c.check("cas", hists)
            assert res["ok"] and res["verdicts"] == expected
        monkeypatch.delenv("QSM_TPU_FAULTS")
        PORT.reset_faults()
        router.obs.tracer.close()
        events = load_events(trace_log, trace_id=res["trace"])
        assert [e for e in events if e.get("name") == "route.hop"]
    finally:
        _teardown(router, nodes)


# --- spawned nodes (real SIGKILL) -----------------------------------------

def _spawn_node(nid: str, tmp_path) -> tuple:
    env = dict(os.environ)
    env.pop("QSM_TPU_FAULTS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    unix = str(tmp_path / f"{nid}.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "qsm_tpu_torch", "serve", "--unix", unix,
         "--node-id", nid, "--device", "cpu",
         "--replog-dir", str(tmp_path / f"replog_{nid}")],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    banner = json.loads(proc.stdout.readline())
    assert banner["serving"] == unix
    return proc, unix


def _reap(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5.0)


def test_sigkill_node_mid_soak_redispatches_with_artifacts(tmp_path,
                                                           corpus,
                                                           expected):
    from qsm_tpu_torch.obs import load_dump, load_events, recent_events

    spec, hists = corpus[PORT.root]
    procs = {nid: _spawn_node(nid, tmp_path) for nid in ("n0", "n1")}
    trace_log = str(tmp_path / "router_trace.jsonl")
    flight_dir = str(tmp_path / "flight")
    router = _router(PORT, [(nid, unix) for nid, (_p, unix)
                            in procs.items()],
                     policy=PORT.preset("fleet-route").with_(
                         timeout_s=2.0),
                     heartbeat_s=0.3, trace_log=trace_log,
                     flight_dir=flight_dir)
    try:
        key = PORT.fingerprint_key(spec, hists[0])
        victim = router.membership.node_for(key)
        survivor = "n1" if victim == "n0" else "n0"
        wrong, errors = [], []
        first = threading.Event()

        def drive():
            with PORT.CheckClient(router.address, timeout_s=60.0) as c:
                for _ in range(6):
                    res = c.check("cas", hists)
                    first.set()
                    if not res.get("ok"):
                        errors.append(res)
                    elif res["verdicts"] != expected:
                        wrong.append(res["verdicts"])

        t = threading.Thread(target=drive)
        t.start()
        first.wait(60.0)
        os.kill(procs[victim][0].pid, signal.SIGKILL)
        t.join(120.0)
        assert not wrong and not errors, (wrong, errors)
        if router.stats()["node_faults"] == 0:
            # the burst ended before the kill landed: one more request
            with PORT.CheckClient(router.address, timeout_s=60.0) as c:
                res = c.check("cas", hists)
                assert res["ok"] and res["verdicts"] == expected
        assert router.stats()["node_faults"] >= 1
        router.obs.tracer.close()
        dumps = [f for f in sorted(os.listdir(flight_dir))
                 if "node_death" in f]
        assert dumps, os.listdir(flight_dir)
        doomed = []
        for name in dumps:
            dump = load_dump(os.path.join(flight_dir, name))
            for ev in recent_events(dump, "node"):
                at = ev.get("attrs") or {}
                if (ev.get("name") == "node.shed"
                        and at.get("node") == victim):
                    doomed.extend(at.get("traces") or [])
        assert doomed
        hop = None
        for trace_id in doomed:
            for ev in load_events(trace_log, trace_id=trace_id):
                at = ev.get("attrs") or {}
                if (ev.get("name") == "route.hop"
                        and at.get("hop_from") == victim):
                    hop = at
        assert hop is not None and hop["hop_to"] in (survivor, "ladder")
    finally:
        router.stop()
        for proc, _unix in procs.values():
            _reap(proc)


def test_sigkill_node_mid_session_resumes_from_banked_prefix(tmp_path):
    """Twin of ``tests/test_monitor.py:402``: the owning node is
    SIGKILLed mid-session and respawned on the same replog; the router's
    session rung covers the gap, the journal replays onto the respawned
    node, which resumes from its bank (prefix_hits > 0)."""
    from qsm_tpu_torch.core.history import sequential_history
    from qsm_tpu_torch.serve import SessionHandle

    proc, unix = _spawn_node("n0", tmp_path)
    flight_dir = str(tmp_path / "flight")
    router = _router(PORT, [("n0", unix)],
                     policy=PORT.preset("fleet-route").with_(
                         timeout_s=2.0),
                     heartbeat_s=0.5, trace_log=str(tmp_path / "rt.jsonl"),
                     flight_dir=flight_dir)
    client = None
    try:
        client = PORT.CheckClient(router.address, timeout_s=15.0)
        h = sequential_history([(0, 1, 1, 0), (0, 0, 0, 1),
                                (1, 1, 2, 0), (1, 0, 0, 2)] * 8)
        rows = PORT.history_to_rows(h)
        handle = SessionHandle(client, "register")
        half = len(rows) // 2
        for r in rows[:half]:
            assert handle.append([r])["ok"]
        assert handle.last["decided_prefix"] > 4
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        dead = handle.append([rows[half]])
        assert dead.get("ok") and dead.get("ladder"), dead
        proc, unix2 = _spawn_node("n0", tmp_path)
        assert unix2 == unix
        for r in rows[half + 1:-1]:
            out = handle.append([r])
            assert out.get("ok"), out
        # the last event goes once, after membership has readmitted the
        # respawned node: an append the ladder answered is applied, so
        # sending the same event again would be a second event (the
        # client's seq has moved past it)
        deadline = time.monotonic() + 60.0
        while ("n0" not in router.membership.healthy_ids()
               and time.monotonic() < deadline):
            assert out.get("ok"), out
            time.sleep(0.25)
        out = handle.append([rows[-1]])
        assert out.get("ok") and not out.get("ladder"), out
        fin = handle.close()
        assert fin["ok"] and fin["verdict"] == "LINEARIZABLE"
        assert fin["prefix_hits"] > 0
        assert router.session_replays >= 1
        dumps = sorted(os.listdir(flight_dir))
        assert dumps
        assert any(handle.trace in (tmp_path / "flight" / d).read_text()
                   for d in dumps)
    finally:
        if client is not None:
            client.close()
        router.stop()
        _reap(proc)


def test_router_seqless_append_applies_events_exactly_once():
    """Twin of ``tests/test_monitor.py:498``."""
    from qsm_tpu_torch.core.history import sequential_history

    srv = PORT.server(flush_s=0.005).start()
    router = _router(PORT, [("n0", srv.address)], heartbeat_s=5.0)
    client = None
    try:
        client = PORT.CheckClient(router.address, timeout_s=10.0)
        h = sequential_history([(0, 1, 1, 0), (0, 0, 0, 1)] * 4)
        rows = PORT.history_to_rows(h)
        sid = client.session_open("register")["session"]
        total = 0
        for r in rows:
            out = client.session_append(sid, [r])
            assert out["ok"], out
            total += out["applied"]
            assert out["seq"] == total
        fin = client.session_close(sid)
        assert fin["ok"] and fin["verdict"] == "LINEARIZABLE"
        assert fin["ops"] == len(rows)
    finally:
        if client is not None:
            client.close()
        router.stop()
        srv.stop()


# --- anti-entropy, CLI surfaces, links -------------------------------------

def test_anti_entropy_sweep_converges_fleet(tmp_path, corpus, expected):
    spec, hists = corpus[PORT.root]
    router, nodes = _fleet(PORT, tmp_path, n_nodes=2, seal_rows=1)
    try:
        with PORT.CheckClient(router.address, timeout_s=60.0) as c:
            c.check("cas", hists)
        for s in nodes:
            s.cache.flush()
        for _ in range(8):
            if router.anti_entropy_sweep()["segments_shipped"] == 0:
                break
        d0 = nodes[0].replog.digests()
        d1 = nodes[1].replog.digests()
        assert set(d0) == set(d1) and d0 == d1
        for s in nodes:
            for i, h in enumerate(hists):
                e = s.cache.get(PORT.fingerprint_key(spec, h))
                assert e is not None
                assert PORT.VERDICT_NAMES[e.verdict] == expected[i]
    finally:
        _teardown(router, nodes)


def test_stats_fleet_render(tmp_path, corpus):
    from qsm_tpu_torch.utils.cli import _render_stats_fleet

    _spec, hists = corpus[PORT.root]
    router, nodes = _fleet(PORT, tmp_path, n_nodes=2)
    try:
        with PORT.CheckClient(router.address, timeout_s=60.0) as c:
            c.check("cas", hists)
        text = _render_stats_fleet(router.stats())
        assert "fleet router" in text
        assert "n0 [up]" in text and "n1 [up]" in text
        assert "device cpu" in text and "device_errors 0" in text
        searched = [int(line.split("searched ")[1].split()[0])
                    for line in text.splitlines() if "searched" in line]
        assert len(searched) == 2 and sum(searched) > 0
    finally:
        _teardown(router, nodes)


def test_link_saturation_is_busy_not_node_death():
    srv = PORT.server().start()
    try:
        link = prouter.NodeLink("n0", srv.address)
        link._sema = threading.BoundedSemaphore(1)
        link._sema.acquire()
        with pytest.raises(prouter.NodeBusy) as ei:
            link.request({"op": "stats"}, timeout_s=0.2)
        assert not isinstance(ei.value, prouter.NodeFault)
        link._sema.release()
        assert link.request({"op": "stats"}, timeout_s=5.0)["ok"]
    finally:
        srv.stop()


def test_stale_pooled_socket_retries_on_fresh_connection(tmp_path):
    unix = str(tmp_path / "n.sock")
    srv = PORT.server(unix_path=unix, node_id="n0").start()
    link = prouter.NodeLink("n0", unix)
    try:
        assert link.request({"op": "stats"}, timeout_s=5.0)["ok"]
        assert len(link._free) == 1
        srv.stop()
        srv = PORT.server(unix_path=unix, node_id="n0").start()
        resp = link.request({"op": "stats"}, timeout_s=5.0)
        assert resp["ok"] and resp["node"] == "n0"
        srv.stop()
        link.close_all()
        with pytest.raises(prouter.NodeDead):
            link.request({"op": "stats"}, timeout_s=2.0)
    finally:
        srv.stop()
        link.close_all()


# --- elastic membership and the session rung -------------------------------

def test_node_join_leave_rebalances_and_migrates_sessions(tmp_path):
    from qsm_tpu_torch.core.history import sequential_history

    router, nodes = _fleet(PORT, tmp_path, n_nodes=2)
    extra = PORT.server(node_id="n2",
                        replog_dir=str(tmp_path / "replog_extra"),
                        flush_s=0.005).start()
    client = None
    try:
        client = PORT.CheckClient(router.address, timeout_s=10.0)
        h = sequential_history([(0, 1, 1, 0), (0, 0, 0, 1),
                                (1, 1, 2, 0), (1, 0, 0, 2)] * 6)
        rows = PORT.history_to_rows(h)
        half = len(rows) // 2
        sid = client.session_open("register")["session"]
        for i, r in enumerate(rows[:half]):
            assert client.session_append(sid, [r], seq=i)["ok"]
        joined = client.node_join("n2", extra.address)
        assert joined["ok"] and joined["joined"] and joined["nodes"] == 3
        assert not client.node_join("n2", extra.address)["joined"]
        owner = router._sessions[sid].node
        assert owner is not None
        left = client.node_leave(owner)
        assert left["ok"] and left["left"], left
        assert left["sessions_migrated"] == 1 and left["nodes"] == 2
        assert router._sessions[sid].node is None
        for i, r in enumerate(rows[half:]):
            assert client.session_append(sid, [r], seq=half + i)["ok"]
        fin = client.session_close(sid)
        assert fin["ok"] and fin["verdict"] == "LINEARIZABLE"
        assert fin["ops"] == len(rows)
        assert router.stats()["session"]["migrated"] == 1
    finally:
        if client is not None:
            client.close()
        _teardown(router, nodes)
        extra.stop()


def _session_ladder_answers(pkg, tmp_path):
    router, nodes = _fleet(pkg, tmp_path, n_nodes=1)
    client = None
    try:
        nodes[0].stop()
        client = pkg.CheckClient(router.address, timeout_s=10.0)
        opened = client.session_open("register", session="s-ladder")
        out1 = client.session_append(
            "s-ladder", [[0, 1, 1, 0, 0, 1], [1, 1, 2, 2, 2, 3]], seq=0)
        out2 = client.session_append("s-ladder", [[2, 0, 0, 7, 4, 5]],
                                     seq=2)
        fin = client.session_close("s-ladder")
        return [opened, out1, out2, fin], router.stats()["session"]
    finally:
        if client is not None:
            client.close()
        router.stop()


def test_session_ladder_takes_over_when_fleet_exhausted(tmp_path):
    from _torch_serve_pkgs import strip

    ref, ref_st = _session_ladder_answers(REF, tmp_path)
    got, st = _session_ladder_answers(PORT, tmp_path)
    opened, out1, out2, fin = got
    assert opened["ok"] and opened.get("ladder"), opened
    assert out1["ok"] and out1.get("ladder") and out1["applied"] == 2
    assert out2["ok"] and out2["verdict"] == "VIOLATION"
    assert out2["flip"] and not out2["flip"]["complete"]
    assert fin["ok"] and fin["verdict"] == "VIOLATION" and fin["flipped"]
    assert st["ladder"] >= 3
    # the reference's answers, field for field
    assert [strip(d) for d in got] == [strip(d) for d in ref]
    assert st == ref_st


# --- the card's rules -------------------------------------------------------

class _CardEngine:
    """An engine on CUDA (its torch device) that raises a real,
    non-injected error."""

    name = "card_stub"

    def __init__(self):
        import torch

        self.device = torch.device("cuda", 0)
        self.calls = 0

    def check_histories(self, spec, histories):
        self.calls += 1
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


class _StubNode:
    """A node that answers every session verb as its card failing, and
    ``stats`` healthily (the membership probe)."""

    ERROR = "RuntimeError: CUDA error: device-side assert triggered"

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.address = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.ops = []
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except (socket.timeout, OSError):
                continue
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        f = conn.makefile("r")
        try:
            for line in f:
                req = json.loads(line)
                op = req.get("op", "check")
                self.ops.append(op)
                if op == "stats":
                    doc = {"ok": True, "stats": {"node": "n0"}}
                else:
                    doc = {"id": req.get("id"), "ok": False,
                           "error": self.ERROR,
                           "device_error": self.ERROR, "node": "n0"}
                conn.sendall((json.dumps(doc) + "\n").encode())
        except OSError:
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        self.sock.close()


def test_node_device_error_is_answered_never_laddered(tmp_path, corpus):
    """A node whose card fails answers ``ok: false`` with
    ``device_error``; the router answers the request with the node's
    error, counts ``device_errors``, emits ``route.device_error`` and
    never runs its ladder — for check, shrink and a session."""
    from qsm_tpu_torch.obs import load_events

    _spec, hists = corpus[PORT.root]
    trace_log = str(tmp_path / "rt.jsonl")
    node = PORT.server(node_id="n0", flush_s=0.005,
                       engine_factory=lambda s: _CardEngine()).start()
    stub = _StubNode()
    r1 = _router(PORT, [("n0", node.address)], trace_log=trace_log)
    r2 = _router(PORT, [("n0", stub.address)])
    try:
        with PORT.CheckClient(r1.address, timeout_s=30.0) as c:
            res = c.check("cas", hists[:4])
            assert res["ok"] is False, res
            assert res["error"].startswith("RuntimeError: CUDA error")
            assert res["device_error"] == res["error"]
            assert "verdicts" not in res
            sres = c.shrink("cas", _failing_history(PORT))
            assert sres["ok"] is False and sres.get("device_error"), sres
        with PORT.CheckClient(r2.address, timeout_s=30.0) as c:
            o = c.session_open("register", session="s1")
            assert o["ok"] is False and o["device_error"] == stub.ERROR
            a = c.session_append("s1", [[0, 1, 1, 0, 0, 1]], seq=0)
            assert a["ok"] is False and a["device_error"] == stub.ERROR
        st1, st2 = r1.stats(), r2.stats()
        assert st1["device_errors"] == 2 and st2["device_errors"] == 2
        for st in (st1, st2):
            assert st["ladder_batches"] == 0 and st["ladder_lanes"] == 0
            assert st["session"]["ladder"] == 0
            assert st["node_faults"] == 0 and st["redispatches"] == 0
        assert not r1._ladders and not r2._ladders
        assert r2._local_sessions is None
        assert node.stats()["device_errors"] >= 2
        r1.obs.tracer.close()
        names = [e.get("name") for e in load_events(trace_log)]
        assert names.count("route.device_error") == 2
        assert "route.ladder" not in names
    finally:
        r1.stop()
        r2.stop()
        node.stop()
        stub.stop()


def test_router_ladder_is_built_on_the_card_lazily(corpus):
    """``FleetRouter()`` with no device touches no CUDA until its ladder
    is first used; then it builds the planned checker on the card, and
    without a card that first use raises ``BackendUnavailable``."""
    import torch

    from qsm_tpu_torch.ops.backend import BackendUnavailable

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the ladder would build")
    spec, hists = corpus[PORT.root]
    router = prouter.FleetRouter([("n0", "127.0.0.1:1")])
    assert router.device is None and not router.on_cpu
    assert router.stats()["device"] == "cuda"
    assert not router._ladders
    with pytest.raises(BackendUnavailable):
        router._ladder_for("cas", {})
    res = prouter._GroupResult(2)
    with pytest.raises(BackendUnavailable):
        router._ladder_group(res, hists[:2], "cas", {}, False,
                             time.monotonic() + 30.0, "t", "")
    cpu = prouter.FleetRouter([("n0", "127.0.0.1:1")], device="cpu")
    _spec, engine, _oracle, _lock = cpu._ladder_for("cas", {})
    assert type(engine).__name__ == type(
        PORT.m.server.host_fallback(spec)).__name__


def test_router_ladder_on_a_card_wraps_the_planned_checker(monkeypatch):
    """On the card the ladder is ``FailoverBackend`` over
    ``build_backend(spec, plan_search(spec, platform="cuda"))``."""
    import qsm_tpu_torch.search.planner as planner

    seen = {}

    def fake_build(spec, plan, **kw):
        seen["plan"], seen["kw"] = plan, kw
        return PORT.WingGongCPU(memo=True)

    monkeypatch.setattr(planner, "build_backend", fake_build)
    router = prouter.FleetRouter([("n0", "127.0.0.1:1")])
    _spec, engine, oracle, _lock = router._ladder_for("cas", {})
    assert type(engine).__name__ == "FailoverBackend"
    assert seen["kw"] == {"device": None}
    want = planner.plan_search(_spec, platform="cuda")
    assert seen["plan"].describe() == want.describe()
    assert type(oracle).__name__ == "WingGongCPU" and oracle.memo


@pytest.mark.parametrize("every", [1, 2], ids=["all", "half"])
def test_router_ladder_on_the_card_resolves_budget_lanes(monkeypatch,
                                                         corpus, expected,
                                                         every):
    """The card ladder's BUDGET_EXCEEDED lanes are decided again on the
    exact host checker (the server's rule): with no node alive the router
    answers the reference's verdicts, and its ladder shrink minimizes as
    the host ladder's does, though the planned checker left lanes
    undecided."""
    import numpy as np

    import qsm_tpu_torch.search.planner as planner

    _spec, hists = corpus[PORT.root]
    budget = int(PORT.Verdict.BUDGET_EXCEEDED)

    class Starved:
        """A planned checker that leaves every ``every``-th lane
        undecided and decides the rest exactly."""

        name = "starved"

        def __init__(self, spec):
            self.oracle = PORT.WingGongCPU(memo=True)

        def check_histories(self, spec, hs):
            v = np.asarray(self.oracle.check_histories(spec, hs))
            v[::every] = budget
            return v

    monkeypatch.setattr(planner, "build_backend",
                        lambda spec, plan, **kw: Starved(spec))
    dead = [("n0", "127.0.0.1:1")]
    router = _router(PORT, dead, device=None)
    host = _router(PORT, dead)
    try:
        assert not router.on_cpu and host.on_cpu
        failing = _failing_history(PORT)
        with PORT.CheckClient(router.address, timeout_s=60.0) as c:
            res = c.check("cas", hists)
            shr = c.shrink("cas", failing)
        with PORT.CheckClient(host.address, timeout_s=60.0) as c:
            want_shr = c.shrink("cas", failing)
        assert res["ok"] and res["verdicts"] == expected
        assert res["nodes"] == {"router": len(hists)}
        assert router.ladder_resolved > 0
        assert shr["ok"] and shr["verdict"] == "VIOLATION"
        assert shr["history"] == want_shr["history"]
        assert shr["final_ops"] == want_shr["final_ops"]
        assert host.ladder_resolved == 0
        (entry,) = router._ladders.values()
        assert type(entry[1]).__name__ == "FailoverBackend"
    finally:
        router.stop()
        host.stop()


def test_fleet_workers_without_cpu_device_is_refused(capsys):
    from qsm_tpu_torch.utils.cli import main

    with pytest.raises(SystemExit, match="--device cpu"):
        main(["fleet", "--nodes", "2", "--workers", "2"])
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["fleet", "--nodes", "2", "--workers", "2", "--device",
              "cuda"])


def test_spawned_nodes_pass_the_device_through(monkeypatch, tmp_path):
    """``fleet`` spawns ``python -m qsm_tpu_torch serve`` with
    ``--device`` passed through and this process' environment as it is
    (nothing hides the card); a node that prints no banner stops the
    fleet with "node i failed to start"."""
    import qsm_tpu_torch.utils.cli as cli

    spawned = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            spawned.append((cmd, kw))
            self.stdout = type("O", (), {"readline": lambda s: ""})()

        def terminate(self):
            pass

        def wait(self, timeout=None):
            return 0

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    for device, flag in ((None, []), ("cpu", ["--device", "cpu"])):
        spawned.clear()
        argv = ["fleet", "--nodes", "2", "--replog-root", str(tmp_path)]
        if device:
            argv += ["--device", device]
        with pytest.raises(SystemExit, match="node 0 failed to start"):
            cli.main(argv)
        assert len(spawned) == 2
        for cmd, kw in spawned:
            assert cmd[1:4] == ["-m", "qsm_tpu_torch", "serve"]
            assert ("--device" in cmd) == bool(device)
            if device:
                i = cmd.index("--device")
                assert cmd[i:i + 2] == flag
            env = kw.get("env")
            assert env is None or env.get("CUDA_VISIBLE_DEVICES") == "0"
            assert "JAX_PLATFORMS" not in (env or {})


def test_soak_rig_passes_the_device_through(tmp_path):
    from qsm_tpu_torch.gen import soak

    for device, flag in ((None, []), ("cpu", ["--device", "cpu"])):
        fleet = soak._Fleet(str(tmp_path), lease_ttl_s=1.0,
                            max_sessions=8, faults=None, device=device)
        assert fleet.device_args == flag
    import inspect

    src = inspect.getsource(soak)
    assert "CUDA_VISIBLE_DEVICES" not in src
    assert "JAX_PLATFORMS" not in src


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
def test_node_session_error_says_device_error_only_on_the_card(
        monkeypatch, on_card):
    """The node side of the rule: a session verb whose window re-check
    fails on the card answers ``ok: false`` with ``device_error``; the
    same failure of a host node, and a bad request on either, carry no
    ``device_error`` (a router ladders or surfaces those as the
    reference does).  Whether a failure is the card's is the window
    re-check's to say (``WindowEngines(on_card=)`` raises
    ``DeviceDispatchError``); the server answers it by the rule of its
    check and shrink verbs."""
    from qsm_tpu_torch.core.history import History
    from qsm_tpu_torch.monitor.frontier import WindowEngines
    from qsm_tpu_torch.monitor.session import MonitorSession
    from qsm_tpu_torch.ops.backend import DeviceDispatchError

    text = "CUDA error: an illegal memory access was encountered"

    class Broken:
        def __init__(self, spec):
            self.spec = spec

        def check_histories(self, spec, hists, init_states=None):
            raise RuntimeError(text)

    class Frontier:
        spec = PORT.MODELS["register"].make_spec()

        def window_lanes(self):
            return History([]), [(0,)]

    engines = WindowEngines(Broken, on_card=on_card)
    want = DeviceDispatchError if on_card else RuntimeError
    with pytest.raises(want) as ei:
        engines.check([Frontier()])
    assert str(ei.value) == (f"RuntimeError: {text}" if on_card else text)

    def broken(self):
        engines.check([Frontier()])

    srv = PORT.server(flush_s=0.005).start()
    try:
        with PORT.CheckClient(srv.address, timeout_s=30.0) as c:
            sid = c.session_open("register")["session"]
            bad = c.session_append(sid, [], seq=0)
            assert bad["ok"] is False and "device_error" not in bad
            monkeypatch.setattr(MonitorSession, "decide", broken)
            res = c.session_append(sid, [[0, 1, 1, 0, 0, 1]], seq=0)
        assert res["ok"] is False
        assert res["error"].startswith("RuntimeError: CUDA error")
        assert ("device_error" in res) == on_card
        if on_card:
            assert res["device_error"] == res["error"]
    finally:
        srv.stop()
