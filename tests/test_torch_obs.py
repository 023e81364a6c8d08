"""The port's observability plane against the JAX package's (twins of the
server-free cases of ``tests/test_obs.py`` and ``tests/test_obs_fleet.py``).

The same events, metrics and span logs go through ``qsm_tpu.obs`` and
``qsm_tpu_torch.obs``; rendered trees, exposition text, pages and dumps
must be equal apart from ids and times.  The port's ``emit_global``
sites (``failover.degrade``, ``fault.hit``) land in an installed sink as
the reference's do."""

from __future__ import annotations

import json
import os
import re
import threading
import time

import numpy as np
import pytest

import qsm_tpu.obs as jobs
import qsm_tpu_torch.obs as pobs
from qsm_tpu.obs.slo import SloEvaluator as JSloEvaluator
from qsm_tpu.obs.slo import worst_status as j_worst_status
from qsm_tpu_torch.obs.metrics import Histogram
from qsm_tpu_torch.obs.slo import SloEvaluator, worst_status

# ids and clocks differ between runs: blank them before comparing
_VOLATILE = re.compile(r'("(?:ts|ms|span|trace|parent|pid|at|t)": )'
                       r'("[^"]*"|[0-9.e+-]+)')


def _norm(obj):
    return _VOLATILE.sub(r"\1_", json.dumps(obj, sort_keys=True))


def _write_log(path, events):
    with open(path, "a") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def _ev(i, trace="T", parent=""):
    return {"ts": i, "name": "ev", "trace": trace, "span": f"s{i:04d}",
            "parent": parent}


# --- units: tracer / tree / metrics / flight -------------------------------

def _rotated_tail(mod, path):
    tracer = mod.Tracer(path=path, max_bytes=4096)
    for i in range(200):
        tracer.event("unit.tick", trace="t1", i=i)
    tracer.close()
    assert tracer.rotations >= 1
    assert os.path.exists(f"{path}.1")
    events = mod.load_events(path, trace_id="t1")
    assert 0 < len(events) <= 200
    assert events[-1]["attrs"]["i"] == 199
    with open(path, "a") as f:
        f.write('{"name": "unit.torn", "trace": "t1"')
    assert mod.load_events(path, trace_id="t1")[-1]["attrs"]["i"] == 199
    return tracer.rotations, [e["attrs"]["i"] for e in events]


def test_tracer_emits_rotates_and_reloads(tmp_path):
    ref = _rotated_tail(jobs, str(tmp_path / "ref.jsonl"))
    got = _rotated_tail(pobs, str(tmp_path / "port.jsonl"))
    assert got == ref


def test_tracer_off_is_free_and_null_span_safe():
    for mod in (jobs, pobs):
        tracer = mod.Tracer()
        assert not tracer.enabled
        assert tracer.event("x", trace="t") == ""
        with tracer.span("x", trace="t") as sp:
            sp.add(k=1)
            assert sp.id == ""
        assert tracer.events == 0


def test_span_context_manager_emits_on_exception(tmp_path):
    docs = []
    for mod in (jobs, pobs):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        tracer = mod.Tracer(path=path)
        with pytest.raises(ValueError):
            with tracer.span("unit.fail", trace="t2"):
                raise ValueError("boom")
        tracer.close()
        ev = mod.load_events(path, trace_id="t2")
        assert len(ev) == 1
        assert ev[0]["status"] == "error:ValueError"
        assert ev[0]["ms"] >= 0
        docs.append(_norm(ev))
    assert docs[0] == docs[1]


def test_tree_reconstruction_and_orphans():
    events = [
        {"name": "request", "trace": "t", "span": "r", "parent": ""},
        {"name": "lane", "trace": "t", "span": "l", "parent": "r"},
        {"name": "batch", "trace": "t", "span": "b", "parent": "l"},
        {"name": "orphan", "trace": "t", "span": "o", "parent": "gone"},
    ]
    roots = pobs.build_tree(events)
    assert [r["name"] for r in roots] == ["request", "orphan"]
    assert roots[0]["children"][0]["children"][0]["name"] == "batch"
    text = pobs.render_tree(roots)
    assert "request" in text and "`- batch" in text and "orphan" in text
    assert roots == jobs.build_tree(events)
    assert text == jobs.render_tree(jobs.build_tree(events))


def _fill_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("unit_total", "help text").inc(3)
    reg.counter("unit_total").inc(2, kind="a")
    reg.gauge("unit_gauge").set(1.5)
    h = reg.histogram("unit_seconds")
    for v in (0.002, 0.002, 0.002, 0.4):
        h.observe(v)
    reg.register_collector(
        lambda: [("unit_collected", "gauge", "", {}, 7.0)])
    return reg, h


def test_metrics_counter_gauge_histogram_and_exposition():
    reg, h = _fill_registry(pobs)
    assert h.count() == 4
    assert 0.001 <= h.quantile(0.5) <= 0.005
    assert 0.25 <= h.quantile(0.99) <= 0.5
    text = reg.render()
    vals = pobs.parse_exposition(text)
    assert vals["unit_total"] == 3
    assert vals['unit_total{kind="a"}'] == 2
    assert vals["unit_gauge"] == 1.5
    assert vals["unit_seconds_count"] == 4
    assert vals["unit_collected"] == 7
    assert "# TYPE unit_seconds histogram" in text
    assert reg.counter("unit_total") is reg.counter("unit_total")
    with pytest.raises(TypeError):
        reg.gauge("unit_total")
    jreg, jh = _fill_registry(jobs)
    # the same exposition text, and each package parses the other's
    assert text == jreg.render()
    assert jobs.parse_exposition(text) == vals
    assert (h.quantile(0.5), h.quantile(0.99)) == \
        (jh.quantile(0.5), jh.quantile(0.99))


def test_flight_ring_is_bounded_and_dump_roundtrips(tmp_path):
    docs = []
    for mod in (jobs, pobs):
        fr = mod.FlightRecorder(str(tmp_path / mod.__name__),
                                max_events=16, min_interval_s=0.0)
        for i in range(100):
            fr.record({"name": "pool.tick", "trace": f"t{i}"})
        snap = fr.snapshot()
        assert snap["rings"]["pool"] == 16
        assert snap["recorded"] == 100
        path = fr.dump("unit_test", extra={"k": 1})
        doc = mod.load_dump(path)
        assert doc["reason"] == "unit_test" and doc["extra"] == {"k": 1}
        evs = mod.recent_events(doc, "pool")
        assert len(evs) == 16 and evs[-1]["trace"] == "t99"
        docs.append((sorted(doc), evs, os.path.basename(path)[:7]))
    assert docs[0] == docs[1]


def test_shed_storm_survives_rate_limit_shadow(tmp_path):
    for mod in (jobs, pobs):
        fr = mod.FlightRecorder(str(tmp_path / mod.__name__),
                                min_interval_s=0.3, storm_threshold=3,
                                storm_window_s=60.0)
        assert fr.dump("unrelated") is not None
        assert [fr.note_shed() for _ in range(4)] == [None] * 4
        time.sleep(0.35)
        path = fr.note_shed()
        assert path is not None
        assert mod.load_dump(path)["reason"] == "shed_storm"


def test_flight_dump_rate_limit_and_shed_storm(tmp_path):
    seen = []
    for mod in (jobs, pobs):
        root = str(tmp_path / mod.__name__)
        fr = mod.FlightRecorder(root, min_interval_s=3600.0,
                                storm_threshold=5, storm_window_s=60.0)
        assert fr.dump("first") is not None
        assert fr.dump("second") is None
        assert fr.dumps_suppressed == 1
        assert fr.dump("forced", force=True) is not None
        fr2 = mod.FlightRecorder(root, min_interval_s=0.0,
                                 storm_threshold=5, storm_window_s=60.0)
        paths = [fr2.note_shed() for _ in range(12)]
        assert paths[:4] == [None] * 4
        seen.append([p is not None for p in paths])
    assert seen[0] == seen[1] and any(seen[1])


# --- the global sink: the port's three emit_global sites --------------------

class _Dying:
    """A device engine on the host whose substrate is gone (the port's
    failover rule degrades a host engine as the reference does)."""

    def __init__(self, exc):
        import torch

        self.exc = exc
        self.device = torch.device("cpu")

    def check_histories(self, *_a, **_k):
        raise self.exc


def _degrade_ring(mod, failover_mod, policy_mod, spec, hists, exc, fallback):
    bundle = mod.Observability(flight_dir="/nonexistent-never-dumped")
    mod.set_global(bundle)
    try:
        fb = failover_mod.FailoverBackend(
            spec, _Dying(exc), fallback=fallback,
            policy=policy_mod.RetryPolicy(name="t", attempts=1,
                                          timeout_s=2.0))
        verdicts = [int(v) for v in fb.check_histories(spec, hists)]
        return bundle.flight.snapshot()["rings"], verdicts
    finally:
        mod.set_global(None)


def test_failover_degrade_reports_into_global_sink():
    import qsm_tpu.resilience.failover as jfo
    import qsm_tpu.resilience.policy as jpol
    import qsm_tpu_torch.resilience.failover as pfo
    import qsm_tpu_torch.resilience.policy as ppol
    from qsm_tpu.models.registry import make as jmake
    from qsm_tpu.ops.backend import BackendUnavailable as JUnavailable
    from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JWG
    from qsm_tpu_torch.models.registry import make
    from qsm_tpu_torch.ops.backend import BackendUnavailable
    from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
    from qsm_tpu_torch.utils.corpus import build_corpus
    from qsm_tpu_torch.utils.interop import history_to_rows
    from qsm_tpu.utils.report import history_from_rows as j_from_rows
    from qsm_tpu_torch.models.registry import MODELS

    spec, _ = make("register", "atomic")
    jspec, _ = jmake("register", "atomic")
    entry = MODELS["register"]
    hists = build_corpus(spec, (entry.impls["atomic"], entry.impls["racy"]),
                         n=1, n_pids=2, max_ops=6, seed_prefix="obs_deg")
    jhists = [j_from_rows(history_to_rows(h)) for h in hists]
    ref = _degrade_ring(jobs, jfo, jpol, jspec, jhists,
                        JUnavailable("chip gone"), JWG())
    got = _degrade_ring(pobs, pfo, ppol, spec, hists,
                        BackendUnavailable("chip gone"), WingGongCPU())
    assert got[0].get("failover") == 1
    assert got == ref


def test_hybrid_degrade_reports_into_global_sink():
    """The hybrid plan's degrade is the third site: the same event."""
    from qsm_tpu_torch.models.registry import make
    from qsm_tpu_torch.ops.backend import BackendUnavailable
    from qsm_tpu_torch.ops.hybrid import HybridDevice
    from qsm_tpu_torch.utils.interop import history_from_rows

    spec, _ = make("register", "atomic")
    bundle = pobs.Observability(flight_dir="/nonexistent-never-dumped")
    events = []
    bundle.tracer.add_hook(events.append)
    pobs.set_global(bundle)
    try:
        hy = HybridDevice(spec, device="cpu")
        hy.device = _Dying(BackendUnavailable("chip gone"))
        h = history_from_rows([[0, 1, 1, 0, 0, 1], [1, 0, 0, 1, 2, 3]])
        assert [int(v) for v in hy.check_histories(spec, [h])] == [1]
        assert hy.degradations == 1
        assert bundle.flight.snapshot()["rings"].get("failover") == 1
    finally:
        pobs.set_global(None)


def test_fault_hit_event_rides_global_sink(tmp_path, monkeypatch):
    """A fired fault-plane rule at the port's ``dispatch`` site (the top
    of ``DeviceChecker.check_histories``) emits ``fault.hit`` into the
    installed sink and dumps the flight ring, as the reference's
    ``inject`` does."""
    import qsm_tpu.resilience.faults as jfaults
    import qsm_tpu_torch.resilience.faults as pfaults
    from qsm_tpu_torch.models.registry import make
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.utils.interop import history_from_rows

    monkeypatch.setenv("QSM_TPU_FAULTS", "raise:dispatch@1")
    hits = []
    for mod, faults in ((jobs, jfaults), (pobs, pfaults)):
        monkeypatch.setattr(faults, "_plane", None)
        log = str(tmp_path / f"{mod.__name__}.jsonl")
        fdir = str(tmp_path / f"{mod.__name__}_flight")
        bundle = mod.Observability(trace_log=log, flight_dir=fdir)
        mod.set_global(bundle)
        try:
            if mod is pobs:
                spec, _ = make("register", "atomic")
                eng = TorchStepper(spec, device="cpu")
                h = history_from_rows([[0, 1, 1, 0, 0, 1]])
                with pytest.raises(faults.InjectedFault):
                    eng.check_histories(spec, [h])
            else:
                with pytest.raises(faults.InjectedFault):
                    faults.inject("dispatch")
        finally:
            mod.set_global(None)
            bundle.close()
        evs = [e for e in mod.load_events(log) if e["name"] == "fault.hit"]
        assert len(evs) == 1
        assert faults.fired_snapshot() == {"dispatch": 1}
        dumps = [f for f in os.listdir(fdir) if f.endswith(
            "fault_plane.json")]
        assert dumps, "a fired fault rule must dump the flight ring"
        hits.append(_norm(evs))
    assert hits[0] == hits[1]


def test_emit_global_without_a_sink_is_a_no_op():
    pobs.set_global(None)
    pobs.emit_global("failover.degrade", engine="x")
    assert pobs.global_obs() is None


# --- the obs.spans cursor (obs/collect.py) ----------------------------------

def _page_walk(mod, log):
    """tests/test_obs_fleet.py:66's scenario through ``mod``; the spans
    of every page in order, and the gap flags."""
    out = []
    _write_log(log, [_ev(i) for i in range(10)])
    p1 = mod.read_span_page(log, None, max_events=4)
    assert len(p1["events"]) == 4 and p1["more"] and not p1["gap"]
    p2 = mod.read_span_page(log, p1["cursor"], max_events=100)
    assert len(p2["events"]) == 6 and not p2["more"]
    p3 = mod.read_span_page(log, p2["cursor"], max_events=100)
    assert p3["events"] == [] and not p3["gap"]
    with open(log, "a") as f:
        f.write('{"ts": 99, "name": "torn"')
    p4 = mod.read_span_page(log, p3["cursor"], max_events=100)
    assert p4["events"] == []
    with open(log, "a") as f:
        f.write(', "span": "s9999"}\n')
    p5 = mod.read_span_page(log, p4["cursor"], max_events=100)
    assert [e["name"] for e in p5["events"]] == ["torn"]
    os.replace(log, log + ".1")
    _write_log(log, [_ev(i) for i in range(20, 23)])
    p6 = mod.read_span_page(log, p5["cursor"], max_events=100)
    p7 = mod.read_span_page(log, p6["cursor"], max_events=100)
    assert [e["span"] for e in p6["events"] + p7["events"]] == \
        ["s0020", "s0021", "s0022"]
    assert not p6["gap"] and not p7["gap"]
    os.replace(log, log + ".1")
    _write_log(log, [_ev(i) for i in range(30, 32)])
    p8 = mod.read_span_page(log, {"sig": "deadbeefdeadbeef", "off": 123},
                            max_events=100)
    assert p8["gap"]
    spans = [e["span"] for e in p8["events"]]
    while p8["more"]:
        p8 = mod.read_span_page(log, p8["cursor"], max_events=100)
        spans += [e["span"] for e in p8["events"]]
    assert spans[-2:] == ["s0030", "s0031"]
    for p in (p1, p2, p3, p4, p5, p6, p7):
        out.append(([e.get("span") for e in p["events"]], p["cursor"],
                    p["more"], p["gap"]))
    return out, spans


def test_span_page_idempotent_rotation_and_gap(tmp_path):
    ref = _page_walk(jobs, str(tmp_path / "ref.jsonl"))
    got = _page_walk(pobs, str(tmp_path / "port.jsonl"))
    assert got == ref


def test_span_page_empty_live_cursor_never_reships(tmp_path):
    for mod in (jobs, pobs):
        log = str(tmp_path / f"{mod.__name__}.jsonl")
        _write_log(log, [_ev(i) for i in range(4)])
        p1 = mod.read_span_page(log, None, max_events=100)
        assert len(p1["events"]) == 4
        os.replace(log, log + ".1")
        open(log, "w").close()
        p2 = mod.read_span_page(log, p1["cursor"], max_events=100)
        assert p2["events"] == [] and not p2["gap"]
        assert p2["cursor"]["sig"] == ""
        _write_log(log, [_ev(i) for i in range(10, 12)])
        p3 = mod.read_span_page(log, p2["cursor"], max_events=100)
        assert [e["span"] for e in p3["events"]] == ["s0010", "s0011"]
        assert not p3["gap"]
        assert mod.read_span_page(log, p3["cursor"],
                                  max_events=100)["events"] == []


def _collector_run(mod, root):
    log = os.path.join(root, "node.jsonl")
    os.makedirs(root)
    _write_log(log, [_ev(i) for i in range(6)])

    def fetch(_nid, cursor, max_events):
        return {"ok": True, "enabled": True,
                **mod.read_span_page(log, cursor, max_events)}

    cdir = os.path.join(root, "collect")
    col = mod.SpanCollector(cdir)
    counts = [col.sweep(["n0"], fetch)["events"],
              col.sweep(["n0"], fetch)["events"]]
    col.close()
    col2 = mod.SpanCollector(cdir)
    counts.append(col2.sweep(["n0"], fetch)["events"])
    _write_log(log, [_ev(9)])
    counts.append(col2.sweep(["n0"], fetch)["events"])
    events = mod.load_events(col2.out_path)
    col2.close()
    assert all(e["node"] == "n0" for e in events)
    return counts, [e["span"] for e in events]


def test_collector_cursors_survive_restart(tmp_path):
    got = _collector_run(pobs, str(tmp_path / "port"))
    assert got == ([6, 0, 0, 1], [f"s{i:04d}" for i in (0, 1, 2, 3, 4, 5, 9)])
    assert got == _collector_run(jobs, str(tmp_path / "ref"))


def test_collector_dead_node_costs_one_bounded_fetch(tmp_path):
    def fetch(_nid, _cursor, _max):
        raise ConnectionError("down")

    res = []
    for mod in (jobs, pobs):
        col = mod.SpanCollector(str(tmp_path / mod.__name__))
        r = col.sweep(["n0"], fetch)
        assert r["node_failures"] == 1 and r["events"] == 0
        col.close()
        res.append(sorted(r))
    assert res[0] == res[1]


# --- the SLO / health plane --------------------------------------------------

def test_slo_grammar_parses_and_refuses():
    for text in ("check=250ms:p99,shed_rate<0.01", "shrink=2s:p50",
                 "check=1ms:p999"):
        got = [(o.name, o.kind, o.target, o.quantile)
               for o in pobs.parse_slo(text)]
        ref = [(o.name, o.kind, o.target, o.quantile)
               for o in jobs.parse_slo(text)]
        assert got == ref
    objs = pobs.parse_slo("check=250ms:p99,shed_rate<0.01")
    assert [(o.name, o.kind) for o in objs] == \
        [("check_p99_ms", "latency"), ("shed_rate", "shed_rate")]
    assert objs[0].target == pytest.approx(0.25)
    for bad in ("check=250ms", "bogus=1ms:p99", "shed_rate<2",
                "shed_rate<0", "", "check=1ms:p0",
                "check=250ms:p99,check=1ms:p99"):
        with pytest.raises(ValueError):
            pobs.parse_slo(bad)
        with pytest.raises(ValueError):
            jobs.parse_slo(bad)
    assert pobs.HEALTH_EXIT_CODES == jobs.HEALTH_EXIT_CODES


def _slo_run(mod, evaluator, hist_cls, worst):
    hist = hist_cls("t_seconds")
    counters = {"requests": 0, "sheds": 0}
    breaches = []
    ev = evaluator(
        mod.parse_slo("check=100ms:p50,shed_rate<0.5"),
        latency_hist=hist,
        requests_fn=lambda: counters["requests"],
        sheds_fn=lambda: counters["sheds"],
        window_s=30.0, min_tick_s=0.01,
        on_breach=breaches.append)
    statuses = [ev.evaluate()["status"]]
    for _ in range(10):
        hist.observe(0.01, verb="check")
        counters["requests"] += 1
    time.sleep(0.02)
    statuses.append(ev.evaluate()["status"])
    for _ in range(50):
        hist.observe(1.0, verb="check")
        counters["requests"] += 1
    time.sleep(0.02)
    doc = ev.evaluate()
    statuses.append(doc["status"])
    rows = {r["objective"]: r for r in doc["objectives"]}
    assert rows["check_p50_ms"]["burn_rate"] > 1.0
    statuses.append(ev.evaluate()["status"])
    assert worst(["ok", "degraded"]) == "degraded"
    assert worst(["ok", "unreachable"]) == "degraded"
    return statuses, [b["objective"] for b in breaches], sorted(rows)


def test_slo_window_breach_and_recovery():
    from qsm_tpu.obs.metrics import Histogram as JHistogram

    got = _slo_run(pobs, SloEvaluator, Histogram, worst_status)
    assert got[0] == ["ok", "ok", "breach", "breach"]
    assert got[1] == ["check_p50_ms"]      # the transition fires once
    assert got == _slo_run(jobs, JSloEvaluator, JHistogram, j_worst_status)


# --- trace --follow (live tail), and the rendered tree ----------------------

def test_trace_follow_prints_new_events(tmp_path, capsys):
    from qsm_tpu_torch.utils.cli import main

    log = str(tmp_path / "t.jsonl")
    _write_log(log, [_ev(0)])

    def feed():
        time.sleep(0.3)
        _write_log(log, [{"ts": 1, "name": "late.event", "trace": "T",
                          "span": "s_late", "parent": "s0000"}])

    t = threading.Thread(target=feed)
    t.start()
    rc = main(["trace", "T", "--log", log, "--follow",
               "--interval", "0.1", "--max-idle", "1.0"])
    t.join()
    out = capsys.readouterr().out
    assert rc == 0
    assert "+ late.event" in out
    with pytest.raises(SystemExit):
        main(["trace", "T"])
    # --addr asks a running server (test_trace_addr_* below); none
    # listens here
    with pytest.raises(ConnectionError):
        main(["trace", "T", "--addr", "127.0.0.1:1"])


def test_trace_cli_renders_the_references_tree(tmp_path, capsys):
    from qsm_tpu.utils.cli import main as jmain
    from qsm_tpu_torch.utils.cli import main

    log = str(tmp_path / "t.jsonl")
    _write_log(log, [_ev(0), _ev(1, parent="s0000"), _ev(2, parent="s0001"),
                     _ev(3, trace="other")])
    outs = []
    for entry in (jmain, main):
        assert entry(["trace", "T", "--log", log]) == 0
        outs.append(capsys.readouterr().out)
        assert entry(["trace", "T", "--log", log, "--json"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
        assert entry(["trace", "nope", "--log", log]) == 1
        capsys.readouterr()
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert len(outs[3]) == 3


def test_observability_bundle_metrics_round_trip():
    """An installed bundle's registry exposition parses back to what was
    counted, in both packages alike."""
    texts = []
    for mod in (jobs, pobs):
        obs = mod.Observability()
        c = obs.metrics.counter("qsm_unit_events_total", "events")
        for kind in ("a", "b", "a"):
            c.inc(1, kind=kind)
        vals = mod.parse_exposition(obs.metrics.render())
        assert vals['qsm_unit_events_total{kind="a"}'] == 2
        texts.append(obs.metrics.render())
        obs.close()
    assert texts[0] == texts[1]
    assert np.isclose(pobs.parse_exposition(texts[1])[
        'qsm_unit_events_total{kind="b"}'], 1)


# ---------------------------------------------------------------------------
# the server-bound cases (twins of tests/test_obs.py:167-486 and :562), on
# the port's CheckServer(device="cpu"); pooled ones with host workers
# ---------------------------------------------------------------------------

import glob  # noqa: E402
import urllib.request  # noqa: E402

from qsm_tpu_torch.models.registry import MODELS  # noqa: E402
from qsm_tpu_torch.obs import (Observability, build_tree,  # noqa: E402
                               load_dump, load_events, parse_exposition,
                               recent_events, render_tree)
from qsm_tpu_torch.serve.client import CheckClient  # noqa: E402
from qsm_tpu_torch.serve.server import CheckServer  # noqa: E402
from qsm_tpu_torch.utils.corpus import build_corpus  # noqa: E402


def _corpus(model, n, pids, ops, prefix):
    entry = MODELS[model]
    spec = entry.make_spec()
    return spec, build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]),
        n=n, n_pids=pids, max_ops=ops, seed_prefix=prefix)


def test_stopped_server_unregisters_its_metrics_collector(tmp_path):
    """A caller-supplied Observability outlives the server: after
    stop(), a reused registry must not double-emit (or pin) the dead
    server's series."""
    obs = Observability()
    s1 = CheckServer(device="cpu", obs=obs).start()
    s1.stop()
    s2 = CheckServer(device="cpu", obs=obs).start()
    try:
        _spec, hists = _corpus("cas", 1, 4, 10, "obs_reuse")
        client = CheckClient(f"127.0.0.1:{s2.port}")
        assert client.check("cas", hists, deadline_s=60)["ok"]
        client.close()
        names = [s[0] for s in obs.metrics.collect()
                 if s[0] == "qsm_serve_requests_total"]
        assert len(names) == 1                  # one live server's books
        assert obs.metrics.values()["qsm_serve_requests_total"] == 1
    finally:
        s2.stop()


def test_trace_tree_pcomp_pool_end_to_end(tmp_path):
    """A kv request fanning out through pcomp
    sub-lanes over a 2-worker pool yields ONE causal tree with
    admission, every micro-batch (flush reason + worker id), every
    sub-lane, every recombine, and the cache bank.  The pool is left
    COLD so the first dispatch holds its worker long enough that the
    second batch deterministically lands on the other worker."""
    log = str(tmp_path / "trace.jsonl")
    # max_lanes=4 < the ~8 sub-lanes: at least two micro-batches are
    # FORCED, so the cold-worker argument pins both workers
    srv = CheckServer(device="cpu", workers=2, max_lanes=4, trace_log=log,
                      flight_dir=str(tmp_path / "flight")).start()
    try:
        # both workers spawned before the first dispatch (a port worker
        # imports torch): the cold-worker argument needs two live ones
        t0 = time.monotonic()
        while (srv.pool.snapshot()["live"] < 2
               and time.monotonic() - t0 < 60):
            time.sleep(0.05)
        _spec, hists = _corpus("kv", 2, 8, 64, "obs_tree")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.check("kv", hists, deadline_s=120)
        assert res["ok"], res
        trace = res["trace"]
        client.close()
    finally:
        srv.stop()
    events = load_events(log, trace_id=trace)
    by_name: dict = {}
    for ev in events:
        by_name.setdefault(ev["name"], []).append(ev)
    # one request root, admission, a lane per history
    assert len(by_name["request"]) == 1
    assert len(by_name["admission.admit"]) == 1
    assert len(by_name["lane"]) == 2
    splits = by_name["pcomp.split"]
    subs = by_name["sublane"]
    assert len(splits) == 2                         # both hists split
    assert len(subs) == sum(s["attrs"]["keys"] for s in splits)
    # every sub-lane resolves through exactly one micro-batch — or a
    # sub-cache hit when two histories share a per-key sub-history —
    # and every batch stamp names its flush reason AND worker id
    batches = by_name["batch"]
    sub_hits = len(by_name.get("cache.hit", ()))
    assert len(batches) + sub_hits == len(subs)
    assert all(b["attrs"]["flush"] in
               ("full", "target", "interval", "deadline", "close")
               for b in batches)
    workers = {b["attrs"]["worker"] for b in batches}
    assert workers == {0, 1}, f"expected both pool workers: {workers}"
    assert len({b["attrs"]["batch"] for b in batches}) >= 2
    # the recombine and the cache bank
    assert len(by_name["pcomp.recombine"]) == 2
    assert len(by_name["cache.put"]) == len(batches)
    assert len(by_name["response"]) == 1
    # the events knit into ONE tree rooted at the request
    roots = build_tree(events)
    assert len(roots) == 1 and roots[0]["name"] == "request"
    rendered = render_tree(roots)
    for needle in ("admission.admit", "pcomp.split", "sublane",
                   "flush=", "worker=", "pcomp.recombine", "cache.put",
                   "response"):
        assert needle in rendered, f"missing {needle!r} in tree"


def test_trace_cli_reconstructs_tree(tmp_path, capsys):
    from qsm_tpu_torch.utils.cli import main as cli_main

    log = str(tmp_path / "trace.jsonl")
    srv = CheckServer(device="cpu", trace_log=log).start()
    try:
        _spec, hists = _corpus("cas", 2, 4, 10, "obs_cli")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.check("cas", hists, deadline_s=60)
        assert res["ok"]
        client.close()
    finally:
        srv.stop()
    rc = cli_main(["trace", res["trace"], "--log", log])
    out = capsys.readouterr().out
    assert rc == 0
    assert "request" in out and "batch" in out and "response" in out
    # --json prints the raw event list
    rc = cli_main(["trace", res["trace"], "--log", log, "--json"])
    events = json.loads(capsys.readouterr().out)
    assert rc == 0 and all(e["trace"] == res["trace"] for e in events)
    # an unknown trace id exits 1 with a hint on stderr
    rc = cli_main(["trace", "feedbeef00000000", "--log", log])
    assert rc == 1


def test_client_supplied_trace_id_is_adopted(tmp_path):
    log = str(tmp_path / "trace.jsonl")
    srv = CheckServer(device="cpu", trace_log=log).start()
    try:
        _spec, hists = _corpus("cas", 1, 4, 10, "obs_adopt")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.check("cas", hists, trace="cafef00d12345678",
                           deadline_s=60)
        assert res["ok"] and res["trace"] == "cafef00d12345678"
        client.close()
    finally:
        srv.stop()
    assert load_events(log, trace_id="cafef00d12345678")


def test_tracing_off_default_still_answers_trace_id():
    srv = CheckServer(device="cpu").start()
    try:
        _spec, hists = _corpus("cas", 1, 4, 10, "obs_off")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.check("cas", hists, deadline_s=60)
        assert res["ok"]
        assert len(res["trace"]) == 16      # minted even with obs off
        st = client.stats()["stats"]
        assert st["obs"]["tracing"]["enabled"] is False
        assert st["obs"]["tracing"]["events"] == 0
        assert st["obs"]["flight"] is None
        client.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# e2e: flight recorder triggers
# ---------------------------------------------------------------------------

def test_sigkilled_worker_dumps_flight_with_doomed_trace(
        tmp_path, monkeypatch):
    """kill:worker SIGKILLs the worker
    mid-batch; the supervisor sheds it, the flight recorder dumps, and
    the dump's last worker events carry the doomed dispatch's trace
    id.  The request itself still answers (re-dispatch/fallback)."""
    monkeypatch.setenv("QSM_TPU_FAULTS", "kill:worker@1")
    fdir = str(tmp_path / "flight")
    srv = CheckServer(device="cpu", workers=1, max_lanes=4, flight_dir=fdir,
                      pcomp=False).start()
    try:
        _spec, hists = _corpus("cas", 2, 4, 10, "obs_kill")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.check("cas", hists, deadline_s=60)
        assert res["ok"], res               # shed + re-dispatch, not lost
        client.close()
    finally:
        srv.stop()
    dumps = [p for p in glob.glob(os.path.join(fdir, "FLIGHT_*.json"))
             if "worker_crash" in p]
    assert dumps, "worker SIGKILL must fire a flight dump"
    doc = load_dump(sorted(dumps)[0])
    worker_evs = recent_events(doc, "worker")
    names = [e["name"] for e in worker_evs]
    assert "worker.dispatch" in names and "worker.shed" in names
    doomed = [t for e in worker_evs
              for t in (e.get("attrs") or {}).get("traces", [])]
    assert res["trace"] in doomed


def test_stop_dumps_flight_baseline(tmp_path):
    fdir = str(tmp_path / "flight")
    srv = CheckServer(device="cpu", flight_dir=fdir).start()
    srv.stop()
    dumps = glob.glob(os.path.join(fdir, "FLIGHT_*server_stop.json"))
    assert len(dumps) == 1                  # forced, never rate-limited


def test_shed_response_carries_trace_and_flight(tmp_path):
    """Satellite pin: a SHED answer is actionable — it names the
    request's trace id, and once a flight dump exists it names the
    artifact path too."""
    fdir = str(tmp_path / "flight")
    srv = CheckServer(device="cpu", queue_depth=1, flight_dir=fdir,
                      trace_log=str(tmp_path / "t.jsonl")).start()
    try:
        _spec, hists = _corpus("cas", 2, 4, 10, "obs_shed")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.check("cas", hists, deadline_s=30)  # 2 > depth 1
        assert res.get("shed") and res["reason"] == "queue full"
        assert len(res["trace"]) == 16
        assert "flight" not in res          # no dump fired yet: honest
        srv.obs.dump_flight("drill", force=True)
        res2 = client.check("cas", hists, deadline_s=30)
        assert res2.get("shed")
        assert res2["flight"] == srv.obs.flight_path()
        assert os.path.exists(res2["flight"])
        client.close()
    finally:
        srv.stop()
    # both sheds landed in the span log under their own trace ids
    evs = load_events(str(tmp_path / "t.jsonl"), trace_id=res["trace"])
    assert any(e["name"] == "admission.shed" for e in evs)


# ---------------------------------------------------------------------------
# e2e: metrics endpoint + reconciliation
# ---------------------------------------------------------------------------

def test_metrics_endpoint_reconciles_with_stats(tmp_path):
    """The Prometheus exposition and the
    ``stats`` verb answer from the same books — totals are EQUAL on a
    quiesced server, not merely close."""
    srv = CheckServer(device="cpu", metrics_port=0,
                      trace_log=str(tmp_path / "t.jsonl")).start()
    try:
        _spec, hists = _corpus("cas", 4, 4, 10, "obs_recon")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        for _ in range(2):                  # second pass: cache hits
            assert client.check("cas", hists, deadline_s=60)["ok"]
        st = client.stats()["stats"]
        client.close()
        url = f"http://127.0.0.1:{srv.metrics_port}/metrics"
        vals = parse_exposition(
            urllib.request.urlopen(url).read().decode())
    finally:
        srv.stop()
    assert vals["qsm_serve_requests_total"] == st["requests"]
    assert vals["qsm_serve_histories_total"] == st["histories"]
    adm = st["admission"]
    assert vals["qsm_admission_admitted_lanes_total"] == \
        adm["admitted_lanes"]
    assert vals['qsm_admission_shed_total{reason="queue_full"}'] == \
        adm["shed_queue"]
    assert vals["qsm_batcher_batches_total"] == st["batcher"]["batches"]
    assert vals["qsm_batcher_lanes_total"] == st["batcher"]["lanes"]
    cache = st["cache"]
    assert vals["qsm_cache_hits_total"] == cache["hits"]
    assert vals["qsm_cache_misses_total"] == cache["misses"]
    assert cache["hits"] > 0                # the second pass hit
    assert vals["qsm_obs_span_events_total"] == \
        st["obs"]["tracing"]["events"] > 0
    # the request-latency histogram is labeled by verb (the SLO plane
    # reads per-verb windows); this run was check traffic only
    assert vals['qsm_serve_request_seconds_count{verb="check"}'] == \
        st["requests"]


def test_pool_dispatch_histogram_and_worker_metrics(tmp_path):
    srv = CheckServer(device="cpu", workers=1, metrics_port=0).start()
    try:
        _spec, hists = _corpus("cas", 2, 4, 10, "obs_poolm")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        assert client.check("cas", hists, deadline_s=60)["ok"]
        st = client.stats()["stats"]
        client.close()
        url = f"http://127.0.0.1:{srv.metrics_port}/metrics"
        vals = parse_exposition(
            urllib.request.urlopen(url).read().decode())
    finally:
        srv.stop()
    pool = st["pool"]
    assert vals["qsm_pool_workers_live"] == pool["live"] == 1
    assert vals["qsm_pool_dispatches_total"] == pool["dispatches"] >= 1
    assert vals['qsm_pool_dispatch_seconds_count{wid="0"}'] >= 1


def test_stats_watch_renders_and_cli_frames(tmp_path, capsys):
    from qsm_tpu_torch.utils.cli import _render_stats_watch
    from qsm_tpu_torch.utils.cli import main as cli_main

    srv = CheckServer(device="cpu", workers=0).start()
    try:
        _spec, hists = _corpus("cas", 2, 4, 10, "obs_watch")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        assert client.check("cas", hists, deadline_s=60)["ok"]
        st = client.stats()["stats"]
        client.close()
        frame = _render_stats_watch(st)
        assert "requests 1" in frame and "cache:" in frame
        assert "admission: in_flight" in frame
        rc = cli_main(["stats", "--serve", f"127.0.0.1:{srv.port}",
                       "--watch", "--watch-count", "2",
                       "--interval", "0.2"])
        out = capsys.readouterr().out
        assert rc == 0 and out.count("qsm_tpu_torch serve") == 2
    finally:
        srv.stop()
    # --watch without --serve is a usage error, not a silent hang
    with pytest.raises(SystemExit):
        cli_main(["stats", "--watch"])


# ---------------------------------------------------------------------------
# the span<->stats bridge and the global sink
# ---------------------------------------------------------------------------

def test_batch_records_carry_obs_event_counts(tmp_path):
    """span->stats: a traced batch's compact search record says how
    many trace events the batch emitted (``obe``); stats->span: the
    serve.dispatch component event carries the compact record."""
    log = str(tmp_path / "trace.jsonl")
    srv = CheckServer(device="cpu", trace_log=log).start()
    try:
        _spec, hists = _corpus("cas", 2, 4, 10, "obs_bridge")
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.check("cas", hists, deadline_s=60)
        assert res["ok"]
        client.close()
    finally:
        srv.stop()
    batches = [b for b in res["batches"] if b.get("search")]
    assert batches and all(b["search"].get("obe", 0) > 0
                           for b in batches)
    dispatch_evs = [e for e in load_events(log)
                    if e["name"] == "serve.dispatch"]
    assert dispatch_evs
    assert dispatch_evs[0]["attrs"]["search"]["nph"] >= 0


def test_shrink_request_traces_frontier_rounds(tmp_path):
    """The shrink verb's tree: a root, shrink.round events (one per
    greedy frontier round), and batch events for candidate lanes."""
    from qsm_tpu_torch.sched.runner import run_concurrent
    from qsm_tpu_torch.models.registry import make

    spec, _ = make("cas", "atomic")
    # a failing history: seeded racy run until a violation shows
    from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
    from qsm_tpu_torch.core.generator import generate_program

    oracle = WingGongCPU(memo=True)
    failing = None
    for seed in range(60):
        _s, sut = make("cas", "racy")
        prog = generate_program(spec, seed=seed, n_pids=4, max_ops=12)
        h = run_concurrent(sut, prog, seed=f"obs_shrink:{seed}")
        if int(oracle.check_histories(spec, [h])[0]) == 0:
            failing = h
            break
    assert failing is not None
    log = str(tmp_path / "trace.jsonl")
    srv = CheckServer(device="cpu", trace_log=log).start()
    try:
        client = CheckClient(f"127.0.0.1:{srv.port}")
        res = client.shrink("cas", failing, deadline_s=120)
        assert res["ok"] and res["verdict"] == "VIOLATION"
        client.close()
    finally:
        srv.stop()
    evs = load_events(log, trace_id=res["trace"])
    names = [e["name"] for e in evs]
    rounds = names.count("shrink.round")
    # one decide per memo-missing round, plus the input-history check;
    # fully-memoized rounds dispatch nothing (and emit nothing)
    assert 1 <= rounds <= res["rounds"] + 1
    assert "request" in names and "response" in names
    roots = build_tree(evs)
    assert len(roots) == 1


def test_trace_addr_renders_the_served_tree(tmp_path, capsys):
    """``trace ID --addr`` asks the running server (its ``obs.trace``
    op) and renders the same tree as ``--log`` on its span log."""
    from qsm_tpu_torch.utils.cli import main as cli_main

    log = str(tmp_path / "trace.jsonl")
    srv = CheckServer(device="cpu", trace_log=log).start()
    try:
        _spec, hists = _corpus("cas", 2, 4, 10, "obs_addr")
        client = CheckClient(srv.address)
        res = client.check("cas", hists, deadline_s=60)
        assert res["ok"]
        client.close()
        rc = cli_main(["trace", res["trace"], "--addr", srv.address,
                       "--json"])
        served = json.loads(capsys.readouterr().out)
        assert rc == 0
        rc = cli_main(["trace", res["trace"], "--addr", srv.address])
        out = capsys.readouterr().out
        assert rc == 0 and "request" in out and "response" in out
        assert cli_main(["trace", "feedbeef00000000", "--addr",
                         srv.address]) == 1
        capsys.readouterr()
    finally:
        srv.stop()
    assert cli_main(["trace", res["trace"], "--log", log, "--json"]) == 0
    local = json.loads(capsys.readouterr().out)
    assert [e["span"] for e in served] == \
        [e["span"] for e in local][:len(served)]
