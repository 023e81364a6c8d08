"""The port's fleet-wide observability against the JAX package's (twins
of ``tests/test_obs_fleet.py:191``, ``:225``, ``:335``, ``:376``, ``:430``
and ``:487``): the collected cross-process causal tree behind ``trace
<id> --addr ROUTER``, metrics federation reconciling with per-node stats,
the health op and its pinned exit codes, the router's health folding its
nodes', the standby-shed trace pin, and the acceptance soak (a route hop,
an HA takeover and both nodes' sub-lanes in ONE tree).  Servers and
routers run on ``device="cpu"``; spawned nodes are ``python -m
qsm_tpu_torch serve --device cpu``.  Waits are on conditions with a
deadline."""

from __future__ import annotations

import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from qsm_tpu_torch.fleet.membership import HashRing
from qsm_tpu_torch.fleet.router import FleetRouter as _FleetRouter
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.obs import build_tree, load_dump, load_events, render_tree
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.resilience.policy import preset
from qsm_tpu_torch.serve.cache import fingerprint_key
from qsm_tpu_torch.serve.client import CheckClient
from qsm_tpu_torch.serve.protocol import VERDICT_NAMES
from qsm_tpu_torch.serve.server import CheckServer as _CheckServer
from qsm_tpu_torch.utils.corpus import build_corpus

CheckServer = functools.partial(_CheckServer, device="cpu")
FleetRouter = functools.partial(_FleetRouter, device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = CasSpec()


@pytest.fixture(scope="module")
def corpus():
    return build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=8,
                        n_pids=4, max_ops=8, seed_base=0,
                        seed_prefix="obs_fleet")


@pytest.fixture(scope="module")
def expected(corpus):
    oracle = WingGongCPU(memo=True)
    return [VERDICT_NAMES[int(v)]
            for v in oracle.check_histories(SPEC, corpus)]


def _fleet(tmp_path, corpus_dirname="collect", **router_kw):
    nodes = [CheckServer(node_id=f"n{i}",
                         trace_log=str(tmp_path / f"n{i}.jsonl"),
                         flush_s=0.005).start() for i in range(2)]
    router = FleetRouter(
        [(s.node_id, s.address) for s in nodes],
        policy=preset("fleet-route").with_(timeout_s=3.0),
        probe_policy=preset("fleet-probe").with_(timeout_s=1.0),
        heartbeat_s=0.2, anti_entropy_s=0.0,
        trace_log=str(tmp_path / "router.jsonl"),
        collect_dir=str(tmp_path / corpus_dirname),
        **router_kw).start()
    return router, nodes


def test_collected_tree_spans_router_and_both_nodes(tmp_path, corpus,
                                                    expected):
    """The basic fleet-native trace: ONE causal tree, the node's
    ``request`` root a CHILD of the router's ``node.dispatch`` edge
    (cross-process causality by edges, never wall clocks), and a
    re-sweep ships zero duplicates."""
    router, nodes = _fleet(tmp_path)
    try:
        with CheckClient(router.address, timeout_s=60.0) as c:
            res = c.check("cas", corpus)
            assert res["ok"] and res["verdicts"] == expected
            trace = res["trace"]
            assert router.collect_sweep()["events"] > 0
            assert router.collect_sweep()["events"] == 0  # idempotent
            te = c.trace_events(trace)
        events = te["events"]
        by_span = {e["span"]: e for e in events}
        reqs = [e for e in events if e["name"] == "request"]
        assert {e.get("node") for e in reqs} == {"n0", "n1"}
        for r in reqs:
            parent = by_span.get(r.get("parent"))
            assert parent is not None
            assert parent["name"] == "node.dispatch"
        # one connected tree: a single root holding both nodes' lanes
        roots = build_tree(events)
        assert len(roots) == 1 and roots[0]["name"] == "route.request"
        rendered = render_tree(roots)
        assert "node.dispatch" in rendered and "lane" in rendered
    finally:
        router.stop()
        for s in nodes:
            s.stop()


def test_federation_reconciles_with_per_node_stats(tmp_path, corpus):
    """The router's federated ``/metrics`` and
    per-node ``stats()`` answer from the same books — per-node totals
    EQUAL on a quiesced fleet; a stopped node becomes a staleness
    gauge, and the scrape stays bounded (no hang)."""
    router, nodes = _fleet(tmp_path)
    try:
        with CheckClient(router.address, timeout_s=60.0) as c:
            assert c.check("cas", corpus)["ok"]
            m = c.metrics()
        samples = {}
        for name, _t, _h, labels, value in m["samples"]:
            if isinstance(labels, dict):
                key = (name, labels.get("node"),
                       tuple(sorted((k, v) for k, v in labels.items()
                                    if k != "node")))
                samples[key] = value
        per_node = router.node_stats()
        for nid in ("n0", "n1"):
            st = per_node[nid]
            assert "error" not in st
            assert samples[("qsm_serve_requests_total", nid, ())] \
                == st["requests"]
            assert samples[("qsm_serve_histories_total", nid, ())] \
                == st["histories"]
            assert samples[("qsm_cache_hits_total", nid, ())] \
                == st["cache"]["hits"]
            assert samples[("qsm_fleet_node_scrape_stale", nid, ())] \
                == 0.0
        # a dead node is a hole, not a hang: bounded scrape, stale=1.
        # (Drop the pooled links and wait out one LineChannel poll
        # slice: a just-stopped node answers for up to ~0.5 s.)
        nodes[1].stop()
        router.links["n1"].close_all()
        time.sleep(0.7)
        t0 = time.monotonic()
        fed = {(s[0], s[3].get("node")): s[4]
               for s in router._federated_samples()}
        assert time.monotonic() - t0 < 10.0
        assert fed[("qsm_fleet_node_scrape_stale", "n1")] == 1.0
        assert fed[("qsm_fleet_node_scrape_stale", "n0")] == 0.0
        assert ("qsm_serve_requests_total", "n1") not in fed
    finally:
        router.stop()
        for s in nodes:
            s.stop()


def test_health_op_breach_flight_dump_and_cli_exit_codes(tmp_path,
                                                         corpus):
    """End to end: a server under an impossible latency objective
    answers ``health`` with breach, fires the slo_breach flight dump
    (the shed-storm heuristic as a configured objective), and the
    `health` CLI maps statuses to pinned exit codes."""
    from qsm_tpu_torch.utils.cli import main

    flight = str(tmp_path / "flight")
    srv = CheckServer(slo="check=1ms:p50", slo_window_s=30.0,
                      flight_dir=flight,
                      trace_log=str(tmp_path / "t.jsonl")).start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        with CheckClient(addr) as c:
            assert c.health()["status"] == "ok"   # quiet server
            assert c.check("cas", corpus)["ok"]   # >> 1ms p50
            time.sleep(0.05)
            h = c.health()
        assert h["status"] == "breach"
        rows = {r["objective"]: r for r in h["slo"]["objectives"]}
        assert rows["check_p50_ms"]["burn_rate"] > 1.0
        dumps = [f for f in sorted(os.listdir(flight))
                 if "slo_breach" in f]
        assert dumps, os.listdir(flight)
        assert load_dump(os.path.join(flight, dumps[0]))["reason"] \
            == "slo_breach"
        # pinned exit codes: 2 = breach, 3 = unreachable
        assert main(["health", "--addr", addr]) == 2
    finally:
        srv.stop()
    assert main(["health", "--addr", "127.0.0.1:1"]) == 3
    # a healthy (objective-free) server answers 0
    srv2 = CheckServer().start()
    try:
        assert main(["health", "--addr",
                     f"127.0.0.1:{srv2.port}"]) == 0
    finally:
        srv2.stop()


def test_router_health_folds_node_statuses(tmp_path, corpus):
    router, nodes = _fleet(tmp_path, slo="check=10s:p99")
    try:
        with CheckClient(router.address, timeout_s=60.0) as c:
            assert c.check("cas", corpus[:2])["ok"]
            h = c.health()
        assert h["ok"] and h["status"] == "ok"
        assert set(h["fleet"]) == {"n0", "n1"}
        # a dead node degrades the fleet's health, bounded.  (Drop the
        # pooled links and wait out one LineChannel poll slice: a just-
        # stopped node's connection threads answer for up to ~0.5 s.)
        nodes[0].stop()
        router.links["n0"].close_all()
        time.sleep(0.7)
        doc = router.health_doc(timeout_s=2.0)
        assert doc["fleet"]["n0"]["status"] == "unreachable"
        assert doc["status"] == "degraded"
    finally:
        router.stop()
        for s in nodes:
            s.stop()


def test_standby_shed_carries_trace_and_span(tmp_path, corpus):
    """A standby's ``router_standby`` SHED carries the request's trace
    id AND leaves a span in its log, so a client bouncing between
    ``--addr a,b`` during a takeover window is reconstructable."""
    nodes = [CheckServer(node_id="n0",
                         trace_log=str(tmp_path / "n0.jsonl"),
                         flush_s=0.005).start()]
    lease = str(tmp_path / "lease.json")
    kw = dict(policy=preset("fleet-route").with_(timeout_s=3.0),
              probe_policy=preset("fleet-probe").with_(timeout_s=1.0),
              heartbeat_s=0.2, anti_entropy_s=0.0,
              lease_ttl_s=0.5, ha_beat_s=0.0)
    ra = FleetRouter([(s.node_id, s.address) for s in nodes],
                     node_id="rA", lease_path=lease, **kw).start()
    rb_log = str(tmp_path / "rb.jsonl")
    rb = FleetRouter([(s.node_id, s.address) for s in nodes],
                     node_id="rB", lease_path=lease,
                     trace_log=rb_log, **kw).start()
    try:
        assert ra.ha_role == "active" and rb.ha_role == "standby"
        with CheckClient(rb.address, timeout_s=10.0) as c:
            res = c.check("cas", corpus[:1])
        assert res.get("shed") and res["reason"] == "router_standby"
        trace = res.get("trace")
        assert trace, "a standby SHED must carry the trace id"
        rb.obs.tracer.close()
        sheds = [e for e in load_events(rb_log, trace_id=trace)
                 if e.get("name") == "admission.shed"]
        assert sheds, "the refusal must leave a span"
        at = sheds[0].get("attrs") or {}
        assert at.get("reason") == "router_standby"
        assert at.get("role") == "standby"
    finally:
        ra.stop()
        rb.stop()
        for s in nodes:
            s.stop()


def _spawn_node(nid: str, tmp_path, faults=None) -> tuple:
    env = dict(os.environ)
    env.pop("QSM_TPU_FAULTS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if faults:
        env["QSM_TPU_FAULTS"] = faults
    unix = str(tmp_path / f"{nid}.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "qsm_tpu_torch", "serve", "--unix", unix,
         "--node-id", nid, "--workers", "1", "--device", "cpu",
         "--trace-log", str(tmp_path / f"{nid}_trace.jsonl")],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    banner = json.loads(proc.stdout.readline())
    assert banner["serving"] == unix
    return proc, unix


def test_fleet_trace_renders_hop_takeover_and_both_nodes(tmp_path):
    """One soak — a routed pcomp request that
    survives a mid-request node wedge AND an HA router takeover —
    then ``trace <id> --addr`` renders ONE causal tree containing the
    ``router.takeover`` edge, the ``route.hop`` off the lost node,
    and BOTH nodes' pcomp sub-lanes down to the pool worker."""
    from qsm_tpu_torch.models.registry import MODELS

    entry = MODELS["kv"]
    spec = entry.make_spec()
    hists = build_corpus(spec,
                         (entry.impls["atomic"], entry.impls["racy"]),
                         n=6, n_pids=8, max_ops=24, seed_base=100,
                         seed_prefix="obs_fleet_kv")
    oracle = WingGongCPU(memo=True)
    want = [VERDICT_NAMES[int(v)]
            for v in oracle.check_histories(spec, hists)]
    # the ring is a pure function of the node ids: pick the victim
    # (the busiest node) BEFORE spawning, so only IT gets the wedge
    ring = HashRing(["n0", "n1"])
    owners = [ring.node_for(fingerprint_key(spec, h), {"n0", "n1"})
              for h in hists]
    victim = max(("n0", "n1"), key=owners.count)
    survivor = "n1" if victim == "n0" else "n0"
    assert owners.count(survivor) > 0, "need lanes on both nodes"
    procs = {}
    for nid in ("n0", "n1"):
        procs[nid] = _spawn_node(
            nid, tmp_path,
            faults="hang:worker" if nid == victim else None)
    lease = str(tmp_path / "lease.json")
    kw = dict(policy=preset("fleet-route").with_(timeout_s=2.0),
              probe_policy=preset("fleet-probe").with_(timeout_s=1.0),
              heartbeat_s=5.0, anti_entropy_s=0.0,
              lease_ttl_s=0.5, ha_beat_s=0.0)
    ra = FleetRouter([(nid, u) for nid, (_p, u) in procs.items()],
                     node_id="rA", lease_path=lease, **kw).start()
    rb = FleetRouter([(nid, u) for nid, (_p, u) in procs.items()],
                     node_id="rB", lease_path=lease,
                     trace_log=str(tmp_path / "rb_trace.jsonl"),
                     collect_dir=str(tmp_path / "collect"),
                     **kw).start()
    result = {}
    try:
        assert ra.ha_role == "active" and rb.ha_role == "standby"
        # "SIGKILL" rA: socket gone, beats stopped, lease NOT released
        # (a real SIGKILL cannot run the release path)
        ra.lease = None
        ra.stop()

        def drive():
            with CheckClient(f"{ra.address},{rb.address}",
                             timeout_s=60.0) as c:
                result.update(c.check("kv", hists, deadline_s=45.0))

        t = threading.Thread(target=drive)
        t.start()
        # rB promotes only after lease expiry + grace + node probe —
        # until then the client bounces off its router_standby SHEDs
        deadline = time.monotonic() + 60.0
        while rb.ha_role != "active" and time.monotonic() < deadline:
            time.sleep(0.1)
            rb.ha_beat()
        assert rb.ha_role == "active" and rb.takeovers == 1
        # collect while the victim is wedged mid-dispatch: its partial
        # sub-lane spans are scraped BEFORE it would die for real (a
        # deadline, not a count of sleeps: under load the request takes
        # longer)
        deadline = time.monotonic() + 60.0
        while t.is_alive() and time.monotonic() < deadline:
            rb.collect_sweep()
            time.sleep(0.2)
        t.join(90.0)
        assert not t.is_alive()
        assert result.get("ok"), result
        assert result["verdicts"] == want
        trace = result["trace"]
        rb.collect_sweep()  # the post-completion tail
        with CheckClient(rb.address, timeout_s=30.0) as c:
            te = c.trace_events(trace)
        events = te["events"]
        names = {e["name"] for e in events}
        assert "router.takeover" in names
        hops = [e for e in events if e["name"] == "route.hop"]
        assert any((e.get("attrs") or {}).get("hop_from") == victim
                   for e in hops)
        subl = [e for e in events if e["name"] == "sublane"]
        assert {e.get("node") for e in subl} == {"n0", "n1"}, \
            "both nodes' pcomp sub-lanes must be in the tree"
        workers = {(e.get("attrs") or {}).get("worker")
                   for e in events if e["name"] == "batch"}
        assert 0 in workers or "0" in workers, workers
        # ONE tree: the takeover is the root, the request under it,
        # the hop and both nodes' subtrees under the request
        roots = build_tree(events)
        takeover_roots = [r for r in roots
                          if r["name"] == "router.takeover"]
        assert len(takeover_roots) == 1

        def walk(node, acc):
            acc.append(node)
            for ch in node["children"]:
                walk(ch, acc)
            return acc

        in_tree = walk(takeover_roots[0], [])
        tree_names = {e["name"] for e in in_tree}
        assert "route.request" in tree_names
        assert "route.hop" in tree_names
        assert {e.get("node") for e in in_tree
                if e["name"] == "sublane"} == {"n0", "n1"}
        # the standby-era bounce is in the event list too: the client
        # kept ONE trace across doors (client-minted id)
        assert any(e["name"] == "admission.shed"
                   and (e.get("attrs") or {}).get("reason")
                   == "router_standby" for e in events)
        # and the CLI renders it (exit 0 = events found)
        from qsm_tpu_torch.utils.cli import main

        assert main(["trace", trace, "--addr", rb.address]) == 0
    finally:
        ra.stop()
        rb.stop()
        for proc, _unix in procs.values():
            # SIGINT: the node stops its server and reaps its pool's
            # worker (a SIGKILLed node would leave the worker behind)
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.wait(timeout=30.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5.0)
