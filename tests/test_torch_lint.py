"""The port's qsmlint (``qsm_tpu_torch/analysis``) held against the
reference's (``qsm_tpu/analysis``) on the same inputs, and the port's own
twins of tests/test_lint.py for its per-file and semantic families (the
whole-program families g and l are tests/test_torch_lint_program.py's).
CPU only: every semantic pass runs with ``device="cpu"`` (the plain versions);
the card's rebuild guard and edge launches are cases of
tests/test_torch_gpu.py.

Parity with the reference:

* family a — for every registry model, the reference's ``check_spec`` +
  ``check_step_dtypes`` and the port's give the same multiset of
  ``(severity, rule_id, location)``; the broken-parity fixture is caught
  by both, on ``step_jax`` and on ``step_torch``;
* families c, e, f, h, i, j, k, m, n, o — the same source text gives
  the same ``(rule_id, line, severity)`` in both packages; where a rule
  is bound to an idiom (torch's global generator, ``torch.cuda``
  enumeration, a host read in a launch loop, a literal card, a host read
  where shards are placed) the port's torch fixture flags the translated
  line, and the reference's jax-only line is recorded;
* rendering — the same findings and whitelist text render byte for byte
  alike as text and JSON, and as SARIF but for the tool's name.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import textwrap
import time
from collections import Counter

import pytest

import qsm_tpu.analysis as ref_analysis
import qsm_tpu.analysis.fixtures as ref_fixtures
import qsm_tpu_torch.analysis as analysis
import qsm_tpu_torch.analysis.fixtures as fixtures
from qsm_tpu.analysis.kernel_passes import \
    check_step_dtypes as ref_check_step_dtypes
from qsm_tpu.analysis.spec_passes import check_spec as ref_check_spec
from qsm_tpu.models.registry import MODELS as REF_MODELS
from qsm_tpu_torch.analysis import (ERROR, FAMILIES, INFO, WARNING, Finding,
                                    Whitelist, run_lint)
from qsm_tpu_torch.analysis.engine import (DEFAULT_DEVQ_FILES,
                                           DEFAULT_FLEET_FILES,
                                           DEFAULT_GEN_FILES,
                                           DEFAULT_MESH_FILES,
                                           DEFAULT_MONITOR_FILES,
                                           DEFAULT_OBS_FILES,
                                           DEFAULT_OPS_FILES,
                                           DEFAULT_POOL_FILES,
                                           DEFAULT_RESILIENCE_FILES,
                                           DEFAULT_SCHED_FILES,
                                           DEFAULT_SERVE_FILES,
                                           DEFAULT_SHRINK_FILES, REPO_ROOT,
                                           _LintRun, _rebuild_corpora,
                                           _run_family,
                                           default_whitelist_path)
from qsm_tpu_torch.analysis.kernel_passes import (PtxasEntry,
                                                  block_registers,
                                                  check_host_transfers,
                                                  check_kernel_envelope,
                                                  check_rebuild,
                                                  check_step_dtypes,
                                                  edge_plan, kernel_plans,
                                                  parse_ptxas)
from qsm_tpu_torch.analysis.spec_passes import check_spec
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.ops.dfs_kernel import H100_SMS, SMEM_BLOCK_MAX

KERNELS = ("dfs_chunk", "stepper_chunk", "compact_carry", "stepper_sweep",
           "threefry_draws", "sweep_advance")


def _key(findings):
    return Counter((f.severity, f.rule_id, f.location) for f in findings)


def _lines(findings):
    """(rule_id, line, severity) of each finding: the line is the last
    component of the location (``path[:fn]:line``)."""
    return sorted((f.rule_id, int(f.location.rsplit(":", 1)[1]), f.severity)
                  for f in findings)


def _line_of(path, needle):
    with open(path) as f:
        hits = [i for i, ln in enumerate(f, 1) if needle in ln]
    assert len(hits) == 1, (needle, hits)
    return hits[0]


@pytest.fixture(scope="module")
def report():
    t0 = time.perf_counter()
    rep = run_lint(device="cpu", cache=False)
    rep.wall = time.perf_counter() - t0
    return rep


# --- family a: the reference and the port on every registry model --------

@pytest.mark.parametrize("model", sorted(MODELS))
def test_spec_family_matches_the_reference(model):
    assert sorted(MODELS) == sorted(REF_MODELS)
    loc = f"model:{model}"
    ref_spec, spec = REF_MODELS[model].make_spec(), MODELS[model].make_spec()
    ref = ref_check_spec(ref_spec, loc) + ref_check_step_dtypes(ref_spec, loc)
    port = check_spec(spec, loc, device="cpu") + \
        check_step_dtypes(spec, loc, device="cpu")
    assert _key(port) == _key(ref)


def test_parity_broken_spec_is_caught_by_both():
    loc = "fixture:parity_broken_cas"
    ref = [f for f in ref_check_spec(ref_fixtures.ParityBrokenCasSpec(), loc)
           if f.severity == ERROR]
    port = [f for f in check_spec(fixtures.ParityBrokenCasSpec(), loc,
                                  device="cpu") if f.severity == ERROR]
    assert {f.rule_id for f in port} == {"QSM-SPEC-PARITY"}
    assert _key(port) == _key(ref)
    assert all("step_torch" in f.message for f in port)
    assert all("step_jax" in f.message for f in ref)


def test_parity_grid_is_recorded():
    stats = {}
    check_spec(MODELS["ticket"].make_spec(), "model:ticket", device="cpu",
               stats=stats)
    assert stats["exhaustive"] and stats["states"] == 129
    assert stats["tuples"] > stats["states"]


# --- the per-file families: the same source, the same findings ------------

def _ref_pass(fid):
    import importlib

    mod = {"c": "sched", "e": "serve", "f": "pool", "h": "shrink",
           "i": "obs", "j": "fleet", "k": "monitor", "m": "gen",
           "n": "mesh", "o": "devq"}[fid]
    ref = importlib.import_module(f"qsm_tpu.analysis.{mod}_passes")
    port = importlib.import_module(f"qsm_tpu_torch.analysis.{mod}_passes")
    return (getattr(ref, f"check_{mod}_file"),
            getattr(port, f"check_{mod}_file"))


_INLINE = {
    "c": """
        import random, time
        class S:
            def __init__(self, seed):
                self.rng = random.Random(seed)
                self.bad = random.Random()
            def pick(self, xs):
                pending = set(xs)
                for x in pending:
                    if random.random() < 0.5:
                        return x
                return sorted(xs, key=id)[int(time.monotonic()) % 2]
        """,
    "e": """
        import collections, queue
        a = queue.Queue(maxsize=0)
        b = queue.Queue(0)
        c = queue.Queue(maxsize=-1)
        d = queue.Queue(maxsize=8)
        e = collections.deque()
        class S:
            def loop(self, sock):
                while True:
                    sock.accept()
        """,
    "f": """
        import subprocess, sys
        class Unrelated:
            def reap(self, p):
                p.wait(timeout=1.0)
        proc = subprocess.Popen([sys.executable, '-c', 'pass'])
        """,
    "h": """
        def grow(h):
            out = []
            while True:
                out.append(h)
        """,
    "i": """
        class S:
            def __init__(self, tracer, registry):
                self.tracer = tracer
                self.registry = registry
            def opened(self, t):
                sp = self.tracer.span("x", t)
                return sp
            def closed(self, t):
                with self.tracer.span("y", t) as sp:
                    sp.add(ok=True)
                return self.tracer.span("z", t)
            def metrics(self, h, t, wid):
                self.registry.counter(f"hits_{t}").inc()
                self.registry.gauge("depth_" + t)
                self.registry.histogram("lat_total")
                h.observe(1.0, key="k:%s" % t)
                h.inc(wid=str(wid))
                h.set(2, who="{}".format(t))
        """,
    "j": """
        class R:
            def route(self, link, doc):
                while True:
                    try:
                        return link.request(doc, 1.0)
                    except OSError:
                        continue
            def route_some(self, links, doc):
                for link in links:
                    try:
                        return link.dispatch(doc)
                    except OSError:
                        continue
            def route_tried(self, ring, key, doc):
                tried = set()
                for _ in range(3):
                    node = ring.node_for(key, exclude=tried)
                    try:
                        return node.request(doc, 1.0)
                    except OSError:
                        tried.add(node)
                        continue
            def promote(self):
                return self.lease.acquire()
            def promote_gated(self, rec):
                if self.lease.expired(rec, 1.0):
                    return self.lease.acquire()
            def join(self, nid):
                self.ring.add_node(nid)
            def leave(self, nid):
                self.ring.remove_node(nid)
        """,
    "k": """
        import heapq
        class Session:
            def __init__(self):
                self.events = []
                self.heap = []
                self.kept = []
                self.window = []
            def push(self, e):
                self.events.append(e)
                heapq.heappush(self.heap, e)
                self.kept.append(e)
                if len(self.kept) > 8:
                    self.kept.pop(0)
                self.window.insert(0, e)
                self.window = self.window[:4]
        """,
    "m": """
        class Campaign:
            def __init__(self):
                self.pool = SeedPool()
                self.seen = []
            def round(self, entry):
                self.pool.add(entry)
                self.seen.append(entry)
        """,
    "n": """
        import jax
        def build(devs):
            a = make_mesh(8)
            b = make_mesh_2d(2, 4)
            c = Mesh(devs, 2)
            d = make_mesh(len(devs))
            return jax.local_devices()[1], a, b, c, d
        """,
    "o": """
        class Drainer:
            def __init__(self):
                self.done = []
            def drain(self, q):
                while q:
                    self.done.append(q.pop())
        """,
}


# The reference's lines its port does not flag, by family: the reference's
# jax idiom of a rule whose port form is torch's (family n's sharding is
# applied by ``jax.device_put`` there, by the LaneShards methods here).
_REF_ONLY = {
    "n": [("QSM-MESH-TRANSFER", "for s in shards]   # <-- bug: host pull",
           ERROR)],
}


@pytest.mark.parametrize("fid", sorted(_INLINE))
@pytest.mark.parametrize("source", ["reference fixtures", "inline"])
def test_per_file_family_matches_the_reference(fid, source, tmp_path):
    ref_check, port_check = _ref_pass(fid)
    ref_only = []
    if source == "inline":
        path = tmp_path / "stub.py"
        path.write_text(textwrap.dedent(_INLINE[fid]))
        path = str(path)
    else:
        path = ref_fixtures.__file__
        ref_only = [(rule, _line_of(path, needle), sev)
                    for rule, needle, sev in _REF_ONLY.get(fid, ())]
    ref, port = ref_check(path), port_check(path)
    assert ref, "the source must exercise the family"
    assert sorted(_lines(port) + ref_only) == _lines(ref)


@pytest.mark.parametrize("fid", sorted(_INLINE))
def test_port_fixtures_match_the_reference_but_the_torch_lines(fid):
    """On the port's own fixture file the reference's pass and the port's
    agree, but for the lines written in torch's idiom: the port's family
    c also flags the draw from torch's global generator, and its family n
    the literal cards and the host reads where shards are placed."""
    ref_check, port_check = _ref_pass(fid)
    path = fixtures.__file__
    extra = []
    if fid == "c":
        extra = [("QSM-DET-RANDOM",
                  _line_of(path, "torch.rand(()) < 0.5"), ERROR)]
    if fid == "n":
        extra = [("QSM-MESH-HARDCODE", _line_of(path, needle), ERROR)
                 for needle in ("local_devices(device)[0]",
                                'torch.device("cuda", 0)',
                                'carry.to("cuda:1")',
                                "card_shard_mesh(4)")]
        extra += [("QSM-MESH-TRANSFER", _line_of(path, needle), ERROR)
                  for needle in ("carries[0].dsi.cpu()",
                                 "torch.cuda.synchronize()  ")]
    assert _lines(port_check(path)) == sorted(_lines(ref_check(path))
                                              + extra)


# --- the seeded fixtures: every family proves it still fires --------------

def test_nondeterministic_scheduler_stub_is_caught():
    from qsm_tpu_torch.analysis.sched_passes import check_sched_file

    findings = check_sched_file(fixtures.__file__)
    rules = {f.rule_id for f in findings if "deliver_one" in f.location}
    assert {"QSM-DET-SET-ITER", "QSM-DET-RANDOM", "QSM-DET-TIME",
            "QSM-DET-ID"} <= rules
    assert not [f for f in findings if "deliver_seeded" in f.location]


def test_torch_global_generator_draws_are_flagged(tmp_path):
    from qsm_tpu_torch.analysis.sched_passes import check_sched_file

    p = tmp_path / "stub.py"
    p.write_text("import torch\n"
                 "def f(gen):\n"
                 "    torch.manual_seed(0)\n"
                 "    a = torch.rand(3)\n"
                 "    b = torch.randint(0, 5, (3,))\n"
                 "    c = torch.randperm(4)\n"
                 "    d = torch.randn_like(a, generator=gen)\n"
                 "    e = torch.randint(0, 5, (3,), generator=gen)\n"
                 "    return torch.randperm(4, generator=gen)\n")
    findings = check_sched_file(str(p))
    assert _lines(findings) == [("QSM-DET-RANDOM", n, ERROR)
                                for n in (3, 4, 5, 6, 7)]
    assert all(":f:" in f.location for f in findings)


def test_unbounded_device_probe_is_caught():
    """The resilience pass's bulb check in the port's idiom: the bare
    torch.cuda.device_count(), the timeoutless subprocess wait and the
    probe-timeout literal each fire once; the watchdog-bounded twin is
    clean."""
    from qsm_tpu_torch.analysis.resilience_passes import \
        check_resilience_file

    path = fixtures.__file__
    by_rule = {}
    for f in check_resilience_file(path):
        by_rule.setdefault(f.rule_id, []).append(f)
    dev = by_rule.pop("QSM-RES-DEVICES")
    assert _lines(dev) == [("QSM-RES-DEVICES", _line_of(
        path, "torch.cuda.device_count()  # <-- bug"), ERROR)]
    assert "probe_unbounded" in dev[0].location
    assert len(by_rule.pop("QSM-RES-SUBPROC")) == 1
    lit = by_rule.pop("QSM-RES-TIMEOUT-LITERAL")
    assert len(lit) == 1 and lit[0].severity == WARNING
    assert not by_rule


@pytest.mark.parametrize("call", ["init", "device_count",
                                  "get_device_properties", "is_available"])
def test_each_cuda_enumeration_is_flagged_outside_a_watchdog(call,
                                                             tmp_path):
    from qsm_tpu_torch.analysis.resilience_passes import \
        check_resilience_file

    p = tmp_path / "stub.py"
    p.write_text("import torch\n"
                 "from qsm_tpu_torch.resilience.policy import watchdog\n"
                 "def bare():\n"
                 f"    return torch.cuda.{call}()\n"
                 "def bounded():\n"
                 f"    return watchdog(lambda: torch.cuda.{call}(), 5.0)\n")
    findings = check_resilience_file(str(p))
    assert [(f.rule_id, f.location) for f in findings] == [
        ("QSM-RES-DEVICES", f"{p}:bare:4")]


def test_subprocess_with_timeout_is_clean(tmp_path):
    from qsm_tpu_torch.analysis.resilience_passes import \
        check_resilience_file

    p = tmp_path / "stub.py"
    p.write_text("import subprocess, sys\n"
                 "def probe(t):\n"
                 "    return subprocess.run([sys.executable, '-c', "
                 "'pass'], capture_output=True, timeout=t)\n")
    assert check_resilience_file(str(p)) == []


def test_host_read_in_a_launch_loop_is_caught():
    """The port's form of a host transfer in a traced body: the .item()
    in the loop that launches stepper_chunk fires; the twin that reads
    once after its loop is clean."""
    path = fixtures.__file__
    findings = check_host_transfers(path)
    assert _lines(findings) == [("QSM-KERN-HOST-XFER", _line_of(
        path, ".any().item():  # <-- bug"), ERROR)]
    assert "chunks_with_host_read" in findings[0].location


def test_launch_loop_discovery_follows_local_helpers(tmp_path):
    p = tmp_path / "stub.py"
    p.write_text(textwrap.dedent("""
        def status(carry):
            return int(carry.dsi.sum())
        def drive(tabs, carry):
            step = stepper_chunk
            while True:
                carry = step(tabs, carry)
                carry = compact_carry(carry, [0], 32, 0)
                if status(carry) == 0:
                    break
            torch.cuda.synchronize()
        def unrelated(x):
            for i in range(3):
                x.cpu()
    """))
    findings = check_host_transfers(str(p))
    assert [(f.rule_id, f.location.split(":", 1)[1], f.severity)
            for f in findings] == [
        ("QSM-KERN-HOST-XFER", "status:3", WARNING)]


def test_unbounded_serve_loop_is_caught():
    from qsm_tpu_torch.analysis.serve_passes import check_serve_file

    by_rule = {}
    for f in check_serve_file(fixtures.__file__):
        by_rule.setdefault(f.rule_id, []).append(f)
    accept = by_rule.pop("QSM-SERVE-ACCEPT")
    assert len(accept) == 1 and "serve_forever_unbounded" in \
        accept[0].location
    unbounded = by_rule.pop("QSM-SERVE-UNBOUNDED")
    assert len(unbounded) == 1
    assert not by_rule


def test_unreaped_worker_pool_is_caught():
    from qsm_tpu_torch.analysis.pool_passes import check_pool_file

    by_rule = {}
    for f in check_pool_file(fixtures.__file__):
        by_rule.setdefault(f.rule_id, []).append(f)
    reap = by_rule.pop("QSM-POOL-REAP")
    assert len(reap) == 1 and "spawn_unreaped" in reap[0].location
    respawn = by_rule.pop("QSM-POOL-RESPAWN")
    assert len(respawn) == 1 and "respawn_forever" in respawn[0].location
    assert not by_rule


def test_unbounded_frontier_is_caught():
    from qsm_tpu_torch.analysis.shrink_passes import check_shrink_file

    findings = check_shrink_file(fixtures.__file__)
    assert [f.rule_id for f in findings] == ["QSM-SHRINK-UNBOUNDED"]
    assert "frontier_forever" in findings[0].location


def test_unclosed_span_and_unbounded_metric_are_caught():
    """Family i's bulb check: the hand-entered span fires QSM-OBS-SPAN
    once, the fingerprint-minted metric name and the concatenated label
    value fire QSM-OBS-CARDINALITY twice; the with-statement and
    delegating-return spans and the str(wid)-labelled metrics are
    clean."""
    from qsm_tpu_torch.analysis.obs_passes import check_obs_file

    by_rule = {}
    for f in check_obs_file(fixtures.__file__):
        by_rule.setdefault(f.rule_id, []).append(f)
    span = by_rule.pop("QSM-OBS-SPAN")
    assert len(span) == 1 and span[0].severity == ERROR
    assert ":work:" in span[0].location
    card = by_rule.pop("QSM-OBS-CARDINALITY")
    assert len(card) == 2 and {f.severity for f in card} == {ERROR}
    assert not by_rule


def test_fleet_redispatch_is_caught():
    """Family j: the while-True re-dispatch loop and the bounded loop that
    never excludes the failed node each fire QSM-FLEET-REDISPATCH once;
    the tried-set + exclude= twin is clean."""
    from qsm_tpu_torch.analysis.fleet_passes import check_fleet_file

    by_rule = {}
    for f in check_fleet_file(fixtures.__file__):
        by_rule.setdefault(f.rule_id, []).append(f)
    hits = by_rule.pop("QSM-FLEET-REDISPATCH")
    assert len(hits) == 2 and {f.severity for f in hits} == {ERROR}
    assert "no bounded attempt budget" in hits[0].message
    assert "never excludes the failed node" in hits[1].message
    by_rule.pop("QSM-FLEET-LEASE")
    by_rule.pop("QSM-FLEET-HANDOFF")
    assert not by_rule


def test_fleet_lease_is_caught():
    """Family j: the while-True promote loop and the term/expiry-blind
    acquire each fire QSM-FLEET-LEASE once; the beat-driven twin is
    clean."""
    from qsm_tpu_torch.analysis.fleet_passes import check_fleet_file

    found = [f for f in check_fleet_file(fixtures.__file__)
             if f.rule_id == "QSM-FLEET-LEASE"]
    assert len(found) == 2 and {f.severity for f in found} == {ERROR}
    assert "promote_forever" in found[0].location
    assert "unbounded standby-promote loop" in found[0].message
    assert "promote_blind" in found[1].location
    assert "never consults lease term/expiry" in found[1].message
    assert not any("beat" in f.location for f in found)


def test_fleet_handoff_is_caught():
    """Family j: the join that never seeds the newcomer and the leave that
    never migrates the retiree's sessions each fire QSM-FLEET-HANDOFF
    once; the sweep-on-join, invalidate-on-leave twin is clean."""
    from qsm_tpu_torch.analysis.fleet_passes import check_fleet_file

    found = [f for f in check_fleet_file(fixtures.__file__)
             if f.rule_id == "QSM-FLEET-HANDOFF"]
    assert len(found) == 2 and {f.severity for f in found} == {ERROR}
    assert "join_cold" in found[0].location
    assert "without replog handoff" in found[0].message
    assert "leave_sticky" in found[1].location
    assert "without session migration" in found[1].message
    assert not any(":join:" in f.location or ":leave:" in f.location
                   for f in found)


def test_monitor_unbounded_buffer_is_caught():
    """Family k: the session stub whose event buffer and window grow with
    no cap or eviction fires QSM-MON-UNBOUNDED once an attribute; the
    capped / decided-prefix-evicting twin is clean."""
    from qsm_tpu_torch.analysis.monitor_passes import check_monitor_file

    found = [f for f in check_monitor_file(fixtures.__file__)
             if "SessionBufferStub" in f.location]
    assert len(found) == 2 and {f.severity for f in found} == {ERROR}
    assert all("UnboundedSessionBufferStub" in f.location for f in found)
    assert {"self.events", "self.window"} == {
        w for f in found for w in ("self.events", "self.window")
        if w in f.message}


def test_mesh_hardcode_is_caught():
    """Family n in the port's form: the slot pinned by indexing the
    device enumeration, the literal card of a device constructor and of
    a device string, and the literal counts of make_mesh and
    card_shard_mesh each fire QSM-MESH-HARDCODE; the threaded twin (a
    count and a card taken as parameters, the enumeration counted) is
    clean."""
    from qsm_tpu_torch.analysis.mesh_passes import check_mesh_file

    path = fixtures.__file__
    found = [f for f in check_mesh_file(path)
             if f.rule_id == "QSM-MESH-HARDCODE" and "MeshStub" in f.location]
    assert {f.severity for f in found} == {ERROR}
    assert all("HardcodedMeshStub" in f.location for f in found)
    assert _lines(found) == sorted(
        ("QSM-MESH-HARDCODE", _line_of(path, needle), ERROR)
        for needle in ("local_devices(device)[0]", 'torch.device("cuda", 0)',
                       'carry.to("cuda:1")', "make_mesh(8)",
                       "card_shard_mesh(4)"))
    assert not any("ShapePolymorphicMeshStub" in f.location
                   for f in check_mesh_file(path))


def test_mesh_transfer_is_caught():
    """QSM-MESH-TRANSFER fires on each function that both places shards
    (a LaneShards method on a shard-named handle, a per-shard
    ``.to(device)``) and reads to the host (``.cpu()``,
    ``torch.cuda.synchronize``); the split twin, whose index upload
    places nothing, is clean."""
    from qsm_tpu_torch.analysis.mesh_passes import check_mesh_file

    found = [f for f in check_mesh_file(fixtures.__file__)
             if f.rule_id == "QSM-MESH-TRANSFER"]
    assert [f.location.split(":")[-2] for f in found] == [
        "TransferringDispatchStub.step_then_read",
        "TransferringDispatchStub.place_then_sync"]
    assert {f.severity for f in found} == {ERROR}
    assert "shards.step" in found[0].message and ".cpu()" in \
        found[0].message
    assert "torch.cuda.synchronize" in found[1].message


def test_mesh_scope_is_the_function_not_the_module(tmp_path):
    """Placement in one function and the host read in another must not
    co-occur into a finding (the mesh/shards.py step / read_status split);
    a dtype cast and a numpy conversion of host data are no placement
    and no read."""
    from qsm_tpu_torch.analysis.mesh_passes import check_mesh_file

    p = tmp_path / "stub.py"
    p.write_text(textwrap.dedent("""
        import numpy as np
        import torch

        def place(shards, step, tables, carries, lanes):
            return shards.step(step, tables, carries, lanes)

        def read(carries):
            return [c.dsi.cpu().numpy() for c in carries]

        def cast_and_convert(shards, tables, inits):
            tables = shards.replicate(tables)
            rows = np.asarray(inits, np.int32)
            return tables, rows, tables[0].nreq.to(torch.int32)

        def convert_a_tensor(shards, tables):
            copies = shards.replicate(tables)
            return np.asarray(copies[0].nreq.cpu())
    """))
    found = check_mesh_file(str(p))
    assert [(f.rule_id, f.location.split(":")[-2]) for f in found] == [
        ("QSM-MESH-TRANSFER", "convert_a_tensor")]


def test_gen_unbounded_pool_is_caught():
    from qsm_tpu_torch.analysis.gen_passes import check_gen_file

    findings = [f for f in check_gen_file(fixtures.__file__)
                if "SeedPoolStub" in f.location]
    assert len(findings) == 2
    assert all("UnboundedSeedPoolStub" in f.location for f in findings)
    assert {f.severity for f in findings} == {ERROR}


def test_devq_stubs_are_caught():
    from qsm_tpu_torch.analysis.devq_passes import check_devq_file

    findings = check_devq_file(fixtures.__file__)
    unbounded = [f for f in findings if f.rule_id == "QSM-DEVQ-UNBOUNDED"
                 and "DevqStub" in f.location]
    assert len(unbounded) == 2
    assert all("UnboundedDevqStub" in f.location for f in unbounded)
    blind = [f for f in findings if f.rule_id == "QSM-DEVQ-DRAIN"
             and "drain_queue" in f.location]
    assert len(blind) == 1 and "deadline" in blind[0].message


@pytest.mark.parametrize("fid,files", [
    ("c", DEFAULT_SCHED_FILES), ("e", DEFAULT_SERVE_FILES),
    ("f", DEFAULT_POOL_FILES), ("h", DEFAULT_SHRINK_FILES),
    ("i", DEFAULT_OBS_FILES), ("j", DEFAULT_FLEET_FILES),
    ("k", DEFAULT_MONITOR_FILES), ("m", DEFAULT_GEN_FILES),
    ("n", DEFAULT_MESH_FILES), ("o", DEFAULT_DEVQ_FILES)])
def test_live_plane_is_clean(fid, files):
    """Each plane keeps the discipline its family gates (only the one
    pinned timing read of the explore pool is accepted)."""
    fam = FAMILIES[fid]
    wl = Whitelist.load(default_whitelist_path())
    found = []
    for rel in files:
        found += fam.per_file(fam.resolve(rel), REPO_ROOT)
    assert [f for f in found if not wl.allows(f)] == []


def test_dtype_pass_flags_float_state():
    import torch

    class FloatStateCas(fixtures.ParityBrokenCasSpec):
        def step_torch(self, state, cmd, arg, resp):
            ns, ok = super().step_torch(state, cmd, arg, resp)
            return ns.to(torch.float32), ok  # seeded promotion

    class Int64StateCas(fixtures.ParityBrokenCasSpec):
        def step_torch(self, state, cmd, arg, resp):
            ns, ok = super().step_torch(state, cmd, arg, resp)
            return ns + torch.tensor([0]), ok.to(torch.int32)

    for cls, want in ((FloatStateCas, ["float32"]),
                      (Int64StateCas, ["int64", "int32"])):
        findings = check_step_dtypes(cls(), "fixture:dtype", device="cpu")
        assert {f.rule_id for f in findings} == {"QSM-KERN-DTYPE"}
        assert all(f.severity == ERROR for f in findings)
        assert all(any(w in f.message for f in findings) for w in want)


# --- QSM-KERN-SMEM / QSM-KERN-REGS -----------------------------------------

_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z9kernel_aPi' for 'sm_90a'
ptxas info    : Function properties for _Z9kernel_aPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers
ptxas info    : Compile time = 249.195 ms
ptxas info    : Compiling entry function '_Z9kernel_bPi' for 'sm_90a'
ptxas info    : Function properties for _Z9kernel_bPi
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 2048 bytes smem, \
368 bytes cmem[0]
"""


def test_ptxas_parser_reads_each_entry():
    a, b = parse_ptxas(_PTXAS)
    assert a == PtxasEntry("_Z9kernel_aPi", 64, 0, 0, 0, 0)
    assert b == PtxasEntry("_Z9kernel_bPi", 255, 2048, 16, 8, 12)
    assert parse_ptxas("") == []


def _specs():
    return [(n, MODELS[n].make_spec(), f"model:{n}") for n in sorted(MODELS)]


def _clean_reports(regs=64, smem=0):
    return {k: [PtxasEntry(f"_Z{k}", regs, smem, 0, 0, 0)] for k in KERNELS}


def test_spills_and_stack_frames_are_errors():
    reports = _clean_reports()
    reports["stepper_chunk"] = parse_ptxas(_PTXAS)[1:]
    found, rows = check_kernel_envelope(_specs(), reports=reports)
    regs = [f for f in found if f.rule_id == "QSM-KERN-REGS"]
    assert regs and {f.severity for f in regs} == {ERROR}
    assert {f.location for f in regs} == {
        "qsm_tpu_torch/csrc/stepper_chunk.cu"}
    assert any("spills 8 / 12" in f.message for f in regs)
    assert any("registers" in f.message for f in regs)   # 255 x 512


def test_smem_estimator_brackets_the_block_limit():
    """The plans the kernels are given fit SMEM_BLOCK_MAX beside a small
    static footprint; the same plans beside a static footprint that
    leaves less room than the largest plan needs do not."""
    specs = _specs()
    fits, rows = check_kernel_envelope(specs, reports=_clean_reports())
    assert fits == []
    largest = max(r["smem"] for r in rows)
    assert largest <= SMEM_BLOCK_MAX
    over = SMEM_BLOCK_MAX - largest + 1
    blows, _ = check_kernel_envelope(specs,
                                     reports=_clean_reports(smem=over))
    assert {f.rule_id for f in blows} == {"QSM-KERN-SMEM"}
    assert all(f.severity == ERROR for f in blows)


def test_register_check_counts_the_allocation_unit():
    assert block_registers(64, 1024) == 65_536
    assert block_registers(120, 512) == 61_440    # 3840 a warp
    assert block_registers(121, 512) == 65_536    # rounded up
    assert block_registers(33, 32) == 1_280


def test_edge_plans_take_the_largest_registry_plan():
    plans = kernel_plans(_specs(), H100_SMS)
    for kernel in KERNELS:
        assert plans[kernel], kernel
        edge = edge_plan(plans[kernel])
        with_model = [p for p in plans[kernel] if p.model is not None]
        if with_model:
            assert edge.model is not None
            assert edge.smem == max(p.smem for p in with_model)
    # the stepper's edge stages the whole op domain of its spec
    step = edge_plan(plans["stepper_chunk"])
    assert step.plan[2] is True and step.threads == 512


def test_cuda_source_constants_match_the_estimator():
    """The launch shapes the CUDA sources fix themselves, as the
    estimator mirrors them."""
    from qsm_tpu_torch.analysis import kernel_passes as kp

    csrc = os.path.join(REPO_ROOT, "qsm_tpu_torch", "csrc")
    with open(os.path.join(csrc, "compact_carry.cu")) as f:
        assert f"constexpr int THREADS = {kp.COMPACT_THREADS};" in f.read()
    with open(os.path.join(csrc, "threefry_draws.cu")) as f:
        text = f.read()
    assert f"constexpr int SM_WARPS = {kp.DRAWS_SM_WARPS};" in text
    assert "MAX_THREADS = 32 * SM_WARPS;" in text
    assert kp.DRAWS_MAX_THREADS == 32 * kp.DRAWS_SM_WARPS


def test_without_a_build_the_register_half_is_info():
    found, rows = check_kernel_envelope(
        _specs(), reports={k: None for k in KERNELS})
    assert [(f.severity, f.rule_id) for f in found] == \
        [(INFO, "QSM-KERN-REGS")] * len(KERNELS)
    assert all(r["registers"] is None for r in rows)


# --- QSM-KERN-REBUILD ------------------------------------------------------

def _gxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) as the stand-in "
                    "for nvcc")
    return cxx


def test_rebuilding_stepper_is_caught_through_a_stand_in_compiler():
    cas = MODELS["cas"].make_spec()
    backend = fixtures.RebuildingTorchStepper(
        cas, compiler=_gxx(), flags=("-x", "c++", "-shared", "-fPIC"),
        device="cpu", budget=2_000, mid_budget=0, rescue_budget=0,
        chunk_schedule=(512,))
    rec = {}
    findings = check_rebuild(cas, backend, _rebuild_corpora(MODELS["cas"],
                                                            cas),
                             "fixture:rebuilding", record=rec)
    assert [f.rule_id for f in findings] == ["QSM-KERN-REBUILD"]
    assert rec["after"]["compiles"] == rec["warm"]["compiles"] + 1


def test_the_backends_grow_nothing_on_the_cpu(report):
    assert set(report.rebuild) == {
        "TorchGPU cas", "TorchStepper cas (table)",
        "TorchStepper kv16 (sweep)",
        "TorchStepper kindless kv16 (sweep, generic)"}
    for rec in report.rebuild.values():
        assert rec["warm"] == rec["after"]


# --- the live tree, the whitelist, the registry ----------------------------

def test_in_tree_corpus_is_clean(report):
    assert sorted(MODELS) == report.models
    assert len(DEFAULT_OPS_FILES) == 10
    assert len(DEFAULT_SCHED_FILES) == 4
    assert len(DEFAULT_RESILIENCE_FILES) >= 12
    assert len(DEFAULT_SERVE_FILES) == 14
    assert sorted(FAMILIES) == list("abcdefghijklmno")
    assert report.families == list("abcdefghijklmno")
    assert report.device == "cpu"
    assert report.ok, "\n".join(
        f"{f.rule_id} {f.location}: {f.message}" for f in report.errors)
    assert [f for f in report.findings if f.severity != INFO] == []


def test_whitelist_entries_are_all_live_and_pinned(report):
    """Every .qsmlint-torch entry matches a real finding, and each names
    one function (``path:function``), never a whole file."""
    wl = Whitelist.load(default_whitelist_path())
    assert wl.entries
    for rule, prefix in wl.entries:
        assert any(f.rule_id == rule and f.location.startswith(prefix)
                   for f in report.whitelisted), (rule, prefix)
        if not prefix.startswith("model:"):
            path, _, fn = prefix.rpartition(":")
            assert path.endswith(".py") and fn.isidentifier(), prefix
    with open(default_whitelist_path()) as f:
        text = f.read()
    for rule, prefix in wl.entries:
        # each entry carries its reason: a comment right above it
        block = text.split(f"{rule} {prefix}")[0].rstrip().splitlines()
        assert block[-1].startswith("#") or block[-1].startswith(
            "QSM-"), (rule, prefix)


def test_the_ports_own_whitelist_and_cache_files():
    """The port reads and writes its own files, never the reference's
    .qsmlint / .qsmlint-cache.json (the two analyzers run at once under
    xdist)."""
    from qsm_tpu_torch.analysis import incremental

    assert incremental.default_cache_path(REPO_ROOT).endswith(
        ".qsmlint-torch-cache.json")
    assert default_whitelist_path().endswith(".qsmlint-torch")


def test_lint_is_cheap_on_the_cpu(report):
    assert report.wall < 120.0


def test_family_registry_is_declarative():
    for fid, fam in FAMILIES.items():
        assert fam.fid == fid
        assert (fam.per_file is None) != (fam.whole is None)
    rep = run_lint(models=["cas"], retrace=False, families=["c"],
                   cache=False, device="cpu")
    assert rep.families == ["c"] and list(rep.passes) == ["sched"]
    for missing in ("p", "z"):
        with pytest.raises(ValueError):
            run_lint(models=["cas"], retrace=False, families=[missing],
                     device="cpu")


def test_run_lint_without_a_card_refuses(monkeypatch):
    import torch

    from qsm_tpu_torch.ops.backend import BackendUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        run_lint(models=["cas"], families=["c"], cache=False)


# --- --changed, the cache, triggers ----------------------------------------

def test_changed_scope_skips_untouched_families():
    rep = run_lint(models=["cas"], retrace=False, families=["c", "b"],
                   changed="HEAD", cache=False, device="cpu",
                   file_overrides={"c": (), "b": ()})
    assert rep.changed["ref"] == "HEAD" and rep.changed["git_ok"] is True
    assert [f for f in rep.findings if f.rule_id.startswith(
        "QSM-DET")] == []
    bogus = run_lint(models=["cas"], retrace=False, families=["c"],
                     changed="no-such-ref-xyzzy", cache=False,
                     device="cpu")
    assert bogus.changed["git_ok"] is False


def test_result_cache_hits_and_invalidates(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("import queue\nq = queue.Queue()\n")
    cache_path = str(tmp_path / "cache.json")
    kw = dict(models=["cas"], retrace=False, families=["e"],
              cache=cache_path, file_overrides={"e": (str(src),)},
              device="cpu")
    cold = run_lint(**kw)
    assert [f.rule_id for f in cold.findings] == ["QSM-SERVE-UNBOUNDED"]
    assert cold.cache == {"path": cache_path, "hits": 0, "misses": 1}
    warm = run_lint(**kw)
    assert [f.rule_id for f in warm.findings] == ["QSM-SERVE-UNBOUNDED"]
    assert warm.cache["hits"] == 1 and warm.cache["misses"] == 0
    assert json.loads(warm.to_json())["cache"]["hits"] == 1
    src.write_text("import queue\nq = queue.Queue(maxsize=8)\n")
    fixed = run_lint(**kw)
    assert fixed.cache["misses"] == 1 and fixed.findings == []
    with open(cache_path) as f:
        entries = json.load(f)["entries"]
    assert len([k for k in entries if str(src) in k]) == 1


def test_changed_trigger_relints_per_file_family(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("import queue\nq = queue.Queue()\n")
    fam = FAMILIES["e"]
    ctx = _LintRun(["cas"], False, 0)
    overrides = {"e": (str(src),)}
    hit = _run_family(fam, ctx,
                      {"qsm_tpu_torch/analysis/serve_passes.py"}, None,
                      overrides)
    assert [f.rule_id for f in hit] == ["QSM-SERVE-UNBOUNDED"]
    assert _run_family(fam, ctx, {"qsm_tpu/analysis/serve_passes.py"},
                       None, overrides) == []
    assert _run_family(fam, ctx, set(), None, overrides) == []


def test_warm_cache_hits_and_is_faster(tmp_path):
    """The per-file families over the live tree: the second run is all
    cache hits and takes less time than the first."""
    kw = dict(models=["cas"], retrace=False,
              families=["c", "d", "e", "f", "h", "m", "o"],
              cache=str(tmp_path / "cache.json"), device="cpu")
    t0 = time.perf_counter()
    cold = run_lint(**kw)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = run_lint(**kw)
    t_warm = time.perf_counter() - t0
    assert cold.cache["hits"] == 0 and cold.cache["misses"] > 0
    assert warm.cache["misses"] == 0
    assert warm.cache["hits"] == cold.cache["misses"]
    assert _key(warm.findings + warm.whitelisted) == \
        _key(cold.findings + cold.whitelisted)
    assert t_warm < t_cold


# --- rendering: byte for byte with the reference ---------------------------

_FINDINGS = [
    Finding("error", "QSM-KERN-SMEM",
            "qsm_tpu_torch/csrc/stepper_chunk.cu",
            "stepper_chunk plan (16, 256, True, 185472) needs 240000 "
            "shared bytes a block", "shrink the plan"),
    Finding("error", "QSM-RES-SUBPROC", "chip_smoke.py:cli_result:3507",
            "Popen.communicate() without timeout="),
    Finding("warning", "QSM-DET-TIME",
            "qsm_tpu_torch/sched/pool.py:_explore_one:105",
            "wall-clock read in the scheduler plane"),
    Finding("info", "QSM-SPEC-PARITY", "model:kv",
            "parity sampled (24704 tuples), not exhaustive"),
    Finding("warning", "QSM-KERN-HOST-XFER",
            "qsm_tpu_torch/ops/gpu_backend.py:_run_device:176",
            "python bool() cast inside the launch loop"),
]
_WHITELIST = ("# the one status read a launch\n"
              "QSM-KERN-HOST-XFER qsm_tpu_torch/ops/gpu_backend.py:"
              "_run_device\n")

_GOLDEN_SARIF = """{
  "$schema": "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
  "runs": [
    {
      "results": [
        {
          "level": "error",
          "locations": [
            {
              "physicalLocation": {
                "artifactLocation": {
                  "uri": "qsm_tpu_torch/csrc/stepper_chunk.cu"
                }
              }
            }
          ],
          "message": {
            "text": "stepper_chunk plan (16, 256, True, 185472) needs 240000 shared bytes a block (fix: shrink the plan)"
          },
          "ruleId": "QSM-KERN-SMEM"
        },
        {
          "level": "error",
          "locations": [
            {
              "physicalLocation": {
                "artifactLocation": {
                  "uri": "chip_smoke.py"
                },
                "region": {
                  "startLine": 3507
                }
              }
            }
          ],
          "message": {
            "text": "Popen.communicate() without timeout="
          },
          "ruleId": "QSM-RES-SUBPROC"
        },
        {
          "level": "warning",
          "locations": [
            {
              "physicalLocation": {
                "artifactLocation": {
                  "uri": "qsm_tpu_torch/sched/pool.py"
                },
                "region": {
                  "startLine": 105
                }
              }
            }
          ],
          "message": {
            "text": "wall-clock read in the scheduler plane"
          },
          "ruleId": "QSM-DET-TIME"
        },
        {
          "level": "note",
          "locations": [
            {
              "physicalLocation": {
                "artifactLocation": {
                  "uri": "model:kv"
                }
              }
            }
          ],
          "message": {
            "text": "parity sampled (24704 tuples), not exhaustive"
          },
          "ruleId": "QSM-SPEC-PARITY"
        },
        {
          "level": "warning",
          "locations": [
            {
              "physicalLocation": {
                "artifactLocation": {
                  "uri": "qsm_tpu_torch/ops/gpu_backend.py"
                },
                "region": {
                  "startLine": 176
                }
              }
            }
          ],
          "message": {
            "text": "python bool() cast inside the launch loop"
          },
          "ruleId": "QSM-KERN-HOST-XFER",
          "suppressions": [
            {
              "justification": "accepted via the reviewed .qsmlint whitelist (docs/ANALYSIS.md)",
              "kind": "external"
            }
          ]
        }
      ],
      "tool": {
        "driver": {
          "name": "qsmlint-torch",
          "rules": [
            {
              "id": "QSM-DET-TIME"
            },
            {
              "id": "QSM-KERN-HOST-XFER"
            },
            {
              "id": "QSM-KERN-SMEM"
            },
            {
              "id": "QSM-RES-SUBPROC"
            },
            {
              "id": "QSM-SPEC-PARITY"
            }
          ],
          "version": "r17"
        }
      }
    }
  ],
  "version": "2.1.0"
}"""


def _split(pkg, tmp_path):
    path = tmp_path / f"wl_{pkg.__name__}"
    path.write_text(_WHITELIST)
    ref_findings = [pkg.Finding(**f.to_dict()) for f in _FINDINGS]
    return pkg.split_whitelisted(ref_findings, pkg.Whitelist.load(str(path)))


def test_rendering_is_the_references_byte_for_byte(tmp_path):
    kept, allowed = _split(analysis, tmp_path)
    rkept, rallowed = _split(ref_analysis, tmp_path)
    assert [f.to_dict() for f in kept] == [f.to_dict() for f in rkept]
    assert len(allowed) == 1 and len(rallowed) == 1
    assert analysis.render_text(kept, allowed) == \
        ref_analysis.render_text(rkept, rallowed)
    meta = {"ok": False, "models": ["cas"]}
    assert analysis.render_json(kept, allowed, meta=meta) == \
        ref_analysis.render_json(rkept, rallowed, meta=meta)
    sarif = analysis.render_sarif(kept, allowed, meta={"version": "r17"})
    ref_sarif = ref_analysis.render_sarif(rkept, rallowed,
                                          meta={"version": "r17"})
    assert sarif == _GOLDEN_SARIF
    assert sarif.replace('"name": "qsmlint-torch"',
                         '"name": "qsmlint"') == ref_sarif


def test_whitelist_filters_exact_rule_and_prefix():
    wl = Whitelist([("QSM-DET-TIME",
                     "qsm_tpu_torch/sched/pool.py:_explore_one")])
    hit = Finding("warning", "QSM-DET-TIME",
                  "qsm_tpu_torch/sched/pool.py:_explore_one:105", "m")
    other_fn = Finding("warning", "QSM-DET-TIME",
                       "qsm_tpu_torch/sched/pool.py:_worker_init:40", "m")
    other_rule = Finding("error", "QSM-DET-RANDOM",
                         "qsm_tpu_torch/sched/pool.py:_explore_one:105",
                         "m")
    assert wl.allows(hit)
    assert not wl.allows(other_fn) and not wl.allows(other_rule)


def test_report_json_shape(report):
    doc = json.loads(report.to_json())
    assert set(doc) >= {"tool", "errors", "warnings", "findings",
                        "whitelisted", "ok", "seconds", "passes", "models",
                        "families", "device", "parity", "rebuild",
                        "kernels", "protocol"}
    assert doc["tool"] == "qsmlint"
    for f in doc["findings"] + doc["whitelisted"]:
        assert set(f) == {"severity", "rule_id", "location", "message",
                          "fix_hint"}
    assert sorted(doc["parity"]) == sorted(MODELS)
    assert [r["kernel"] for r in doc["kernels"]] == list(KERNELS)


# --- the lint subcommand ---------------------------------------------------

def test_cli_lint_json_and_exit_0(tmp_path, capsys):
    from qsm_tpu_torch.utils.cli import main

    out_path, sarif_path = tmp_path / "lint.json", tmp_path / "lint.sarif"
    rc = main(["lint", "--json", "--models", "cas", "--no-retrace",
               "--device", "cpu", "--no-cache", "--out", str(out_path),
               "--sarif", str(sarif_path)])
    doc = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and doc["ok"] is True and doc["errors"] == 0
    assert doc["models"] == ["cas"] and doc["device"] == "cpu"
    assert json.loads(out_path.read_text())["ok"] is True
    sarif = json.loads(sarif_path.read_text())
    assert sarif["runs"][0]["tool"]["driver"]["name"] == "qsmlint-torch"


def test_cli_lint_findings_exit_1(tmp_path, capsys):
    from qsm_tpu_torch.utils.cli import main

    empty = tmp_path / "empty"
    empty.write_text("# accepts nothing\n")
    rc = main(["lint", "--models", "txn", "--family", "a", "--device",
               "cpu", "--no-cache", "--whitelist", str(empty)])
    out = capsys.readouterr().out
    assert rc == 1 and "QSM-SPEC-PCOMP" in out


@pytest.mark.parametrize("argv,err", [
    (["--models", "nope"], "unknown model"),
    (["--family", "p"], "unknown pass families"),
    (["--whitelist", "/nonexistent/qsmlint"], "whitelist file not found"),
])
def test_cli_lint_usage_errors_exit_2(argv, err, capsys):
    from qsm_tpu_torch.utils.cli import main

    assert main(["lint", "--device", "cpu", *argv]) == 2
    assert err in capsys.readouterr().err


def test_cli_lint_without_a_card_exits_2(monkeypatch, capsys):
    import torch

    from qsm_tpu_torch.utils.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["lint", "--family", "c", "--no-cache"]) == 2
    assert "BackendUnavailable" in capsys.readouterr().err
    assert main(["lint", "--family", "c", "--no-cache", "--device",
                 "cpu", "--json"]) == 0


def test_cli_lint_analyzer_crash_exits_3(monkeypatch):
    from qsm_tpu_torch.utils.cli import main

    monkeypatch.setattr(analysis, "run_lint",
                        lambda **kw: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    assert main(["lint", "--no-retrace", "--models", "cas", "--device",
                 "cpu"]) == 3


def test_cli_lint_changed_stamps_its_scope(capsys):
    from qsm_tpu_torch.utils.cli import main

    rc = main(["lint", "--json", "--models", "cas", "--family", "c",
               "--no-cache", "--changed", "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and doc["changed"]["ref"] == "HEAD"


def test_analysis_imports_no_jax():
    """The analyzer's own modules import neither JAX nor the reference."""
    pkg = os.path.dirname(analysis.__file__)
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(pkg, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 and node.module else [])
            assert not [m for m in mods if m.split(".")[0] in
                        ("jax", "jaxlib", "qsm_tpu")], (name, mods)
