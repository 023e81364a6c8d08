"""The port's history shrinker against the JAX package's, on the CPU.

Each case runs once with the host default (``backend=None``: the planned
host ladder, as in the reference) and once with ``TorchStepper(spec,
device="cpu")`` (the plain versions of the card's kernels deciding every
frontier batch), on violating histories made by the reference's racy
models and carried over as rows.  Minimised histories equal the
reference's row for row, with its rounds, ``lanes_checked`` and
``one_minimal``; certificates replay through both packages'
``verify_witness``.  The stepper runs the KV cases at 6 pids x 24 ops (the
reference's 8 x 64 takes minutes on the plain versions) and is held
against the reference on the same input.

The serve cases (``test_shrink.py:333``, ``:380``) run on the port's
``CheckServer(device="cpu")`` against the reference's server.  Not
twinned: the lint cases (``:442``, ``:452``; the port has no
static-analysis plane)."""

from __future__ import annotations

import functools
import json

import pytest
import torch

import qsm_tpu.shrink as jshrink
from qsm_tpu.core.generator import generate_program
from qsm_tpu.core.property import PropertyConfig as JConfig
from qsm_tpu.core.property import prop_concurrent as j_prop
from qsm_tpu.models.registry import MODELS as JMODELS
from qsm_tpu.models.registry import make as jmake
from qsm_tpu.ops.backend import verify_witness as j_verify
from qsm_tpu.resilience.failover import host_fallback as j_host
from qsm_tpu.sched.runner import run_concurrent
from qsm_tpu_torch.core.history import History, overlapping_history
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models.register import READ, WRITE
from qsm_tpu_torch.models.registry import make
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.pcomp import PComp
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.resilience.failover import FailoverBackend, host_fallback
from qsm_tpu_torch.search.stats import SearchStats
from qsm_tpu_torch.shrink import (collect_shrink_stats, inversions,
                                  minimality_certificate, shrink_frontier,
                                  shrink_history, verify_certificate)
from qsm_tpu_torch.shrink.frontier import swap_candidates
from qsm_tpu_torch.shrink.shrinker import ShrinkResult
from qsm_tpu_torch.utils.cli import main as cli_main
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

ENGINES = ("host", "stepper")
# (pids, ops) of the KV cases with the plain stepper
KV_STEPPER = (6, 24)


@functools.lru_cache(maxsize=None)
def _failing(model, n=1, pids=None, ops=None, prefix="tshr", scan=60):
    """Seeded VIOLATION histories of the reference's racy impl (its
    ``test_shrink.py::_failing_history``): (reference spec, reference
    histories, port spec, port histories)."""
    entry = JMODELS[model]
    jspec, _ = jmake(model, "racy")
    racy = entry.impls["racy"]
    eng = j_host(jspec)
    out = []
    for seed in range(scan):
        if len(out) >= n:
            break
        prog = generate_program(jspec, seed=seed,
                                n_pids=pids or entry.default_pids,
                                max_ops=ops or entry.default_ops,
                                min_ops=ops or entry.default_ops)
        h = run_concurrent(racy(jspec), prog,
                           seed=f"{prefix}:{model}:{seed}").completed()
        if int(eng.check_histories(jspec, [h])[0]) == int(Verdict.VIOLATION):
            out.append(h)
    assert out, f"no failing {model} history in {scan} seeds"
    spec, _ = make(model, "racy")
    return jspec, tuple(out), spec, tuple(
        history_from_rows(history_to_rows(h)) for h in out)


def _kv(engine):
    return ((8, 64) if engine == "host" else KV_STEPPER)


def _backend(engine, spec):
    return None if engine == "host" else TorchStepper(spec, device="cpu")


def _same_as_reference(res, ref):
    assert history_to_rows(res.history) == history_to_rows(ref.history)
    assert (res.ok, res.verdict, res.initial_ops, res.final_ops, res.rounds,
            res.lanes_checked, res.memo_hits, res.complete,
            res.one_minimal, res.undecided_neighbors) == (
        ref.ok, ref.verdict, ref.initial_ops, ref.final_ops, ref.rounds,
        ref.lanes_checked, ref.memo_hits, ref.complete, ref.one_minimal,
        ref.undecided_neighbors)


# --- 1-minimality ---------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_minimized_is_one_minimal_violation(engine):
    jspec, (jh,), spec, (h,) = _failing("kv", pids=_kv(engine)[0],
                                        ops=_kv(engine)[1])
    res = shrink_history(spec, h, backend=_backend(engine, spec),
                         certificate=False)
    assert res.ok and res.complete and res.one_minimal
    assert res.final_ops < res.initial_ops
    _same_as_reference(res, jshrink.shrink_history(jspec, jh,
                                                   certificate=False))
    oracle = WingGongCPU(memo=True)
    assert int(oracle.check_histories(spec, [res.history])[0]) \
        == int(Verdict.VIOLATION)
    n = len(res.history.ops)
    for j in range(n):
        neighbor = res.history.subhistory([i for i in range(n) if i != j])
        assert int(oracle.check_histories(spec, [neighbor])[0]) \
            == int(Verdict.LINEARIZABLE), f"drop {j} still fails"


@pytest.mark.parametrize("engine", ENGINES)
def test_shrink_not_a_violation_returns_unshrunken(engine):
    from qsm_tpu.core.history import sequential_history as j_seq
    from qsm_tpu_torch.core.history import sequential_history

    spec, _ = make("register", "atomic")
    steps = [(0, 1, 1, 0), (0, 0, 0, 1)]  # W(1); R -> 1
    h = sequential_history(steps)
    res = shrink_history(spec, h, backend=_backend(engine, spec))
    assert not res.ok and res.verdict == int(Verdict.LINEARIZABLE)
    assert res.history.fingerprint() == h.fingerprint()
    assert any("not a VIOLATION" in w for w in res.why)
    ref = jshrink.shrink_history(jmake("register", "atomic")[0],
                                 j_seq(steps))
    assert (res.ok, res.verdict, res.engine_calls, res.lanes_checked) == \
        (ref.ok, ref.verdict, ref.engine_calls, ref.lanes_checked)


# --- determinism ----------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_shrink_is_deterministic(engine):
    jspec, (jh,), spec, (h,) = _failing("cas", pids=4, ops=32)
    a = shrink_history(spec, h, backend=_backend(engine, spec),
                       certificate=False)
    b = shrink_history(spec, h, backend=_backend(engine, spec),
                       certificate=False)
    assert a.history.fingerprint() == b.history.fingerprint()
    assert (a.rounds, a.engine_calls, a.lanes_checked) \
        == (b.rounds, b.engine_calls, b.lanes_checked)
    _same_as_reference(a, jshrink.shrink_history(jspec, jh,
                                                 certificate=False))


# --- decomposed == undecomposed -------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("model", ["multireg", "multicas"])
def test_decomposed_equals_undecomposed_shrink(model, engine):
    jspec, (jh,), spec, (h,) = _failing(model, pids=6, ops=24)
    if engine == "host":
        dec_b = PComp(spec, make_inner=host_fallback)
        whole_b = FailoverBackend(spec, host_fallback(spec))
    else:
        dec_b = PComp(spec, make_inner=lambda s: TorchStepper(
            s, device="cpu"))
        whole_b = TorchStepper(spec, device="cpu")
    dec = shrink_history(spec, h, backend=dec_b, certificate=False)
    whole = shrink_history(spec, h, backend=whole_b, certificate=False)
    assert dec.ok and whole.ok
    assert dec.history.fingerprint() == whole.history.fingerprint()
    assert dec.final_ops == whole.final_ops
    from qsm_tpu.ops.pcomp import PComp as JPComp

    ref = jshrink.shrink_history(jspec, jh,
                                 backend=JPComp(jspec, make_inner=j_host),
                                 certificate=False)
    _same_as_reference(dec, ref)


# --- certificates ---------------------------------------------------------

def _cert_rows(rows):
    return [{k: ([list(p) for p in v] if k == "witness" else v)
             for k, v in r.items()} for r in rows]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("model,pids,ops", [
    ("register", 3, 12), ("cas", 4, 24), ("queue", 4, 16), ("kv", 6, 32),
])
def test_certificate_replays_across_families(model, pids, ops, engine):
    if model == "kv" and engine == "stepper":
        pids, ops = KV_STEPPER
    jspec, (jh,), spec, (h,) = _failing(model, pids=pids, ops=ops)
    res = shrink_history(spec, h, backend=_backend(engine, spec),
                         certificate=True)
    assert res.ok and res.complete
    assert res.certificate is not None
    n = len(res.history.ops)
    assert len(res.certificate) == n
    jres = jshrink.shrink_history(jspec, jh, certificate=True)
    _same_as_reference(res, jres)
    assert _cert_rows(res.certificate) == _cert_rows(jres.certificate)
    jmin = jres.history
    for row in res.certificate:
        assert not row.get("undecided"), row
        keep = [i for i in range(n) if i != row["drop"]]
        w = [tuple(p) for p in row["witness"]]
        assert verify_witness(spec, res.history.subhistory(keep), w)
        assert j_verify(jspec, jmin.subhistory(keep), w)
    audit = verify_certificate(spec, res.history, res.certificate)
    assert audit["one_minimal_proved"] and audit["violation_reconfirmed"]
    assert audit == jshrink.verify_certificate(jspec, jmin,
                                               jres.certificate)


@pytest.mark.parametrize("engine", ENGINES)
def test_kv_certificate_uses_stitched_witness_when_split_pays(engine):
    jspec, (jh,), spec, (h,) = _failing("kv", pids=_kv(engine)[0],
                                        ops=_kv(engine)[1])
    if engine == "host":
        rows = minimality_certificate(spec, h)
    else:
        rows = minimality_certificate(
            spec, h, oracle=TorchStepper(spec, device="cpu"),
            pcomp=PComp(spec, make_inner=lambda s: TorchStepper(
                s, device="cpu")))
    n = len(h.ops)
    for row in rows:
        if row.get("undecided"):
            continue
        keep = [i for i in range(n) if i != row["drop"]]
        w = [tuple(p) for p in row["witness"]]
        assert verify_witness(spec, h.subhistory(keep), w)
        assert j_verify(jspec, jh.subhistory(keep), w)
    assert all("stitched" in r for r in rows if not r.get("undecided"))
    ref = jshrink.minimality_certificate(jspec, jh)
    # the same neighbours decided, the same ones stitched
    assert [(r["drop"], r.get("undecided", False), r.get("stitched"))
            for r in rows] == [(r["drop"], r.get("undecided", False),
                                r.get("stitched")) for r in ref]
    if engine == "host":
        assert _cert_rows(rows) == _cert_rows(ref)


# --- the frontier ---------------------------------------------------------

def test_frontier_sorted_deduped_and_capped():
    jspec, (jh,), spec, (h,) = _failing("kv", pids=8, ops=64)
    cands, trunc = shrink_frontier(spec, h, max_lanes=16)
    assert len(cands) == 16 and trunc > 0
    sizes = [len(c.history) for c in cands]
    assert sizes == sorted(sizes)
    assert len({c.history.fingerprint() for c in cands}) == len(cands)
    for cap in (16, 512):
        mine, t = shrink_frontier(spec, h, max_lanes=cap)
        ref, rt = jshrink.shrink_frontier(jspec, jh, max_lanes=cap)
        assert t == rt
        assert [(c.kind, c.detail, history_to_rows(c.history))
                for c in mine] == [(c.kind, c.detail,
                                    history_to_rows(c.history))
                                   for c in ref]


def test_swap_candidates_reduce_inversions():
    from qsm_tpu.shrink.frontier import swap_candidates as j_swaps

    jspec, (jh,), spec, (h,) = _failing("cas", pids=4, ops=24)
    base = inversions(h)
    assert base == jshrink.inversions(jh)
    swaps = list(swap_candidates(h))
    for c in swaps:
        assert len(c.history) == len(h)
        assert inversions(c.history) == base - 1
    assert [(c.detail, history_to_rows(c.history)) for c in swaps] == \
        [(c.detail, history_to_rows(c.history)) for c in j_swaps(jh)]


@pytest.mark.parametrize("engine", ENGINES)
def test_truncated_final_frontier_forfeits_one_minimality(engine):
    spec, _ = make("register", "atomic")
    spans = [(1, WRITE, 1, 0, 0, 1), (0, READ, 0, 0, 2, 3)]
    h = overlapping_history(spans)
    res = shrink_history(spec, h, backend=_backend(engine, spec),
                         max_lanes=1, certificate=False)
    assert res.ok and res.complete and res.final_ops == 2
    assert not res.one_minimal
    assert any("truncated" in w and "1-minimality" in w for w in res.why)
    full = shrink_history(spec, h, backend=_backend(engine, spec),
                          certificate=False)
    assert full.one_minimal and full.final_ops == 2
    from qsm_tpu.core.history import overlapping_history as j_over

    jspec = jmake("register", "atomic")[0]
    _same_as_reference(res, jshrink.shrink_history(
        jspec, j_over(spans), max_lanes=1, certificate=False))


def test_deep_shrink_ratio_never_reads_as_never_shrank():
    res = ShrinkResult(ok=True, verdict=0, history=History([]),
                       initial_ops=1024, final_ops=2)
    st = res.search_stats()
    assert st.shrink_ratio_pct == 1
    assert SearchStats().absorb(st).shrink_ratio_pct == 1
    from qsm_tpu.core.history import History as JHistory

    ref = jshrink.ShrinkResult(ok=True, verdict=0, history=JHistory([]),
                               initial_ops=1024, final_ops=2)
    assert st.to_timings() == ref.search_stats().to_timings()


# --- stats threading ------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_shrink_stats_thread_through_search_stats(engine):
    jspec, (jh,), spec, (h,) = _failing("cas", pids=4, ops=24)
    res = shrink_history(spec, h, backend=_backend(engine, spec),
                         certificate=False)
    st = collect_shrink_stats(res)
    assert st.shrink_rounds == res.rounds
    assert st.shrink_lanes == res.lanes_checked
    assert 0 < st.shrink_ratio_pct <= 100
    compact = st.to_compact()
    for key in ("shr", "shl", "shm", "sho"):
        assert key in compact
    t = st.to_timings()
    assert t["shrink_rounds"] == float(res.rounds)
    assert "shrink_ratio" in t
    assert "shrink_rounds" not in SearchStats().to_timings()
    ref = jshrink.collect_shrink_stats(
        jshrink.shrink_history(jspec, jh, certificate=False))
    shrink_keys = {k: v for k, v in t.items() if k.startswith("shrink_")}
    assert shrink_keys == {k: v for k, v in ref.to_timings().items()
                           if k.startswith("shrink_")}
    if engine == "host":
        assert st.to_timings() == ref.to_timings()
        assert st.engine == ref.engine


# --- the planner's decomposed-corpus gate ---------------------------------

def test_planner_sub_segment_gate():
    from qsm_tpu.search.planner import plan_search as j_plan
    from qsm_tpu_torch.search.planner import (_DECOMPOSE_MEAN_SEGMENTS,
                                              _DECOMPOSE_MEAN_SEGMENTS_SUB,
                                              CorpusProfile, plan_search,
                                              profile_corpus)

    assert _DECOMPOSE_MEAN_SEGMENTS_SUB == 1.35
    assert _DECOMPOSE_MEAN_SEGMENTS_SUB > _DECOMPOSE_MEAN_SEGMENTS
    jspec, jhs, spec, hs = _failing("kv", n=2, pids=8, ops=64)
    profile = profile_corpus(list(hs), spec)
    assert profile.sub_mean_segments > 0
    from qsm_tpu.search.planner import profile_corpus as j_profile

    assert vars(profile) == vars(j_profile(list(jhs), jspec))
    base = dict(n=4, max_ops=256, mean_ops=256.0, pending_fraction=0.0,
                cut_fraction=1.0, mean_segments=2.0, sub_max_ops=16,
                mean_partitions=8.0)
    rspec, _ = make("register", "atomic")
    jr = jmake("register", "atomic")[0]
    from qsm_tpu.search.planner import CorpusProfile as JProfile

    for s, js, sub, want in ((spec, jspec, 1.2, (True, False)),
                             (spec, jspec, 1.6, (True, True)),
                             (rspec, jr, 0.0, (False, True))):
        plan = plan_search(s, CorpusProfile(**base, sub_mean_segments=sub),
                           platform="cpu")
        ref = j_plan(js, JProfile(**base, sub_mean_segments=sub),
                     platform="cpu")
        assert (plan.decompose_keys, plan.decompose) == want
        assert plan.describe() == ref.describe()
    assert any("sub-history" in w for w in plan_search(
        spec, CorpusProfile(**base, sub_mean_segments=1.2),
        platform="cpu").why)


# --- the property layer ---------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_prop_concurrent_minimize_history_flag(engine):
    spec, sut = make("register", "racy")
    cfg = dict(n_trials=60, n_pids=2, max_ops=12, seed=0)
    res = prop_concurrent(spec, sut, PropertyConfig(**cfg,
                                                    minimize_history=True),
                          backend=_backend(engine, spec))
    assert not res.ok and res.counterexample is not None
    cx = res.counterexample
    assert cx.minimized_history is not None
    assert len(cx.minimized_history) <= len(cx.history)
    oracle = WingGongCPU(memo=True)
    assert int(oracle.check_histories(
        spec, [cx.minimized_history])[0]) == int(Verdict.VIOLATION)
    assert res.timings.get("shrink_rounds", 0) > 0
    assert "shrink_minimize" in res.timings
    base = prop_concurrent(spec, sut, PropertyConfig(**cfg),
                           backend=_backend(engine, spec))
    assert base.counterexample.history.fingerprint() \
        == cx.history.fingerprint()
    assert base.counterexample.minimized_history is None
    assert "shrink_rounds" not in base.timings
    jspec, jsut = jmake("register", "racy")
    ref = j_prop(jspec, jsut, JConfig(**cfg, minimize_history=True))
    rcx = ref.counterexample
    assert history_to_rows(cx.history) == history_to_rows(rcx.history)
    assert history_to_rows(cx.minimized_history) == \
        history_to_rows(rcx.minimized_history)
    assert res.histories_checked == ref.histories_checked
    for k in ("shrink_rounds", "shrink_lanes", "shrink_memo_hits",
              "shrink_ratio"):
        assert res.timings[k] == ref.timings[k], k
    if engine == "host":
        # the same run gives the reference's timings keys
        assert sorted(res.timings) == sorted(ref.timings)


# --- the command line -----------------------------------------------------

def test_shrink_cli_roundtrip(tmp_path, capsys):
    from qsm_tpu.utils.cli import main as j_main

    jspec, _, spec, (h, _) = _failing("kv", n=2, pids=8, ops=64)
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({
        "model": "kv", "spec_kwargs": spec.spec_kwargs(),
        "history": history_to_rows(h)}))
    out_path = tmp_path / "min.json"
    # --device cpu without --backend: the reference's host ladder
    rc = cli_main(["shrink", "--trace", str(trace), "--certificate",
                   "--device", "cpu", "--save", str(out_path)])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert doc["verdict"] == "VIOLATION" and doc["one_minimal"]
    assert doc["final_ops"] < doc["initial_ops"]
    assert doc["certificate_audit"]["one_minimal_proved"]
    assert doc["search"]["shr"] == doc["rounds"]
    saved = json.loads(out_path.read_text())
    assert saved["model"] == "kv" and saved["history"] == doc["history"]
    rc = cli_main(["check", "--trace", str(out_path), "--backend", "cpu"])
    assert rc == 1
    doc2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc2["verdict"] == "VIOLATION"
    # the reference's command on the same trace prints the same result
    assert j_main(["shrink", "--trace", str(trace), "--certificate"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("verdict", "initial_ops", "final_ops", "ratio", "rounds",
              "engine_calls", "lanes", "memo_hits", "complete",
              "one_minimal", "undecided_neighbors", "history",
              "certificate_audit", "search"):
        assert doc[k] == ref[k], k


def test_shrink_cli_runs_on_the_card_unless_device_cpu(tmp_path, capsys):
    """``shrink`` decides its frontier batches on the card by default (no
    card: ``BackendUnavailable``, never a silent host run); ``--backend
    stepper --device cpu`` runs the stepper's plain versions and gives
    the host ladder's shrink."""
    from qsm_tpu_torch.ops.backend import BackendUnavailable

    _, _, spec, (h, _) = _failing("cas", n=2, pids=3, ops=10)
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"model": "cas",
                                 "spec_kwargs": spec.spec_kwargs(),
                                 "history": history_to_rows(h)}))
    if not torch.cuda.is_available():
        with pytest.raises(BackendUnavailable):
            cli_main(["shrink", "--trace", str(trace)])
    docs = []
    for extra in ([], ["--backend", "stepper"]):
        rc = cli_main(["shrink", "--trace", str(trace), "--certificate",
                       "--device", "cpu", *extra])
        assert rc == 0
        docs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    host, stepper = docs
    assert stepper["certificate_audit"]["one_minimal_proved"]
    for k in ("verdict", "final_ops", "rounds", "lanes", "one_minimal",
              "undecided_neighbors", "history"):
        assert stepper[k] == host[k], k
    assert stepper["search"] != host["search"]   # another engine's record


def test_shrink_cli_refuses_addr(tmp_path):
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"model": "register", "history": []}))
    # the server runs its own loop: in-process knobs are refused with
    # --addr, never dropped (the served shrink is pinned in
    # tests/test_torch_serve.py and test_torch_monitor.py)
    for knob in (["--max-rounds", "3"], ["--max-lanes", "8"],
                 ["--emit-certificate"], ["--backend", "stepper"]):
        with pytest.raises(SystemExit):
            cli_main(["shrink", "--trace", str(trace), "--addr",
                      "unix:/x", *knob])
    with pytest.raises(ConnectionError):
        cli_main(["shrink", "--trace", str(trace), "--addr", "unix:/x"])


def test_run_minimize_on_the_stepper_round_trips(tmp_path, capsys):
    """``run --minimize --backend stepper`` (the plain versions): racy
    convicted, the minimised history a VIOLATION no longer than the
    shrunk one and the reference's, the regression file replayed."""
    from qsm_tpu.utils.cli import main as j_main

    reg = tmp_path / "reg.json"
    args = ["run", "--model", "register", "--impl", "racy", "--trials",
            "60", "--pids", "2", "--ops", "12", "--minimize"]
    rc = cli_main(args + ["--backend", "stepper", "--device", "cpu",
                          "--failover", "--save-regression", str(reg)])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1 and out[0].startswith("FAIL: register/racy")
    at = next(i for i, x in enumerate(out) if x.startswith("history-min"))
    assert "history-minimized to 2 op(s)" in out[at]
    assert j_main(args + ["--backend", "cpu"]) == 1
    ref = capsys.readouterr().out.splitlines()
    # the same counterexample and minimised history as the reference's
    # (the headers and replay hints name their own package)
    assert out[1:at] == ref[1:at]
    assert out[at + 1:at + 3] == ref[at + 1:at + 3]
    rc = cli_main(["replay", "--regression", str(reg)])
    assert rc == 1
    assert "history reproduced bit-identically: True" in \
        capsys.readouterr().out


# --- the served shrink verb (twins of tests/test_shrink.py:333, :380) -------

def _served_shrinks(server_cls, client_cls, spec_kwargs, rows_list, tmp,
                    **kw):
    srv = server_cls(unix_path=str(tmp), **kw).start()
    out = []
    try:
        with client_cls(srv.address, timeout_s=120) as c:
            for rows in rows_list:
                r = c.shrink("kv", rows, spec_kwargs=spec_kwargs,
                             certificate=True, deadline_s=120)
                assert r["ok"] and r["complete"] and r["one_minimal"]
                out.append((r["history"], r["rounds"], r["lanes"],
                            r["certificate"]))
            r2 = c.shrink("kv", rows_list[0], spec_kwargs=spec_kwargs,
                          certificate=True)
            assert r2.get("cached") is True
            st = c.stats()["stats"]["shrink"]
            assert st["requests"] == len(rows_list) + 1
            assert st["bank_hits"] == 1 and st["rounds"] > 0
    finally:
        srv.stop()
    return out


def test_serve_shrink_identical_to_inprocess_and_banked(tmp_path):
    from qsm_tpu.serve.client import CheckClient as JClient
    from qsm_tpu.serve.server import CheckServer as JServer
    from qsm_tpu_torch.serve.client import CheckClient
    from qsm_tpu_torch.serve.server import CheckServer

    jspec, jhs, spec, hs = _failing("kv", n=2, pids=8, ops=64)
    rows_list = [history_to_rows(h) for h in hs]
    ref = _served_shrinks(JServer, JClient, jspec.spec_kwargs(), rows_list,
                          tmp_path / "j.sock")
    got = _served_shrinks(CheckServer, CheckClient, spec.spec_kwargs(),
                          rows_list, tmp_path / "p.sock", device="cpu")
    assert got == ref
    for h, (rows, *_rest, cert) in zip(hs, got):
        inproc = shrink_history(spec, h, certificate=False)
        assert rows == history_to_rows(inproc.history)
        assert verify_certificate(spec, history_from_rows(rows),
                                  cert)["one_minimal_proved"]


class _SlowBackend:
    """The memo oracle after a fixed stall a dispatch (mid-shrink
    deadline bait)."""

    name = "slow"

    def __init__(self, stall_s=0.35):
        self.oracle = WingGongCPU(memo=True)
        self.stall_s = stall_s

    def check_histories(self, spec, histories):
        import time

        time.sleep(self.stall_s)
        return self.oracle.check_histories(spec, histories)


def test_serve_shrink_deadline_mid_shrink_returns_best_so_far(tmp_path):
    from qsm_tpu_torch.serve.client import CheckClient
    from qsm_tpu_torch.serve.server import CheckServer

    _jspec, _jhs, spec, hs = _failing("kv", pids=8, ops=64)
    srv = CheckServer(unix_path=str(tmp_path / "sock"), device="cpu",
                      engine_factory=lambda s: _SlowBackend()).start()
    try:
        with CheckClient(srv.address, timeout_s=30) as c:
            r = c.shrink("kv", hs[0], spec_kwargs=spec.spec_kwargs(),
                         deadline_s=0.6)
            assert r["ok"] is True and r["complete"] is False
            assert r["one_minimal"] is False
            assert any("shed" in w or "deadline" in w for w in r["why"])
            assert history_from_rows(r["history"]).fingerprint() \
                == hs[0].fingerprint()
            r0 = c.shrink("kv", hs[0], spec_kwargs=spec.spec_kwargs(),
                          deadline_s=0.0)
            assert r0["ok"] is False and r0.get("shed") is True
    finally:
        srv.stop()
