"""The port's entry points and trace I/O against the JAX package's: the
twins of ``tests/test_utils.py``, ``tests/test_sequential.py``,
``tests/test_check_cli.py`` and ``tests/test_cli_backends.py``.  The
JSON lines of ``check``, ``list``, ``coverage`` and ``fuzz`` equal the
reference's apart from ``seconds`` and the backend names; the printed
counterexample is the reference's text; a regression file saved by
either package loads and replays in the other, key for key; the
sequential property finds, shrinks and replays as the reference's.  The
port's device backends are reached only with ``--device cpu`` /
``device="cpu"``.  Tolerance 0."""

from __future__ import annotations

import io
import json
import pickle

import pytest

import qsm_tpu
from qsm_tpu.models.registry import MODELS as JMODELS
from qsm_tpu.models.registry import make as jmake
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle
from qsm_tpu.utils import report as jreport
from qsm_tpu.utils.cli import main as jmain
from qsm_tpu.utils.stats import schedule_coverage as j_coverage
from qsm_tpu_torch import (ModelSUT, PropertyConfig, prop_concurrent,
                           prop_sequential, run_sequential)
from qsm_tpu_torch.core.generator import generate_program
from qsm_tpu_torch.models.register import (READ, RacyCachedRegisterSUT,
                                           RegisterSpec)
from qsm_tpu_torch.models.registry import MODELS, SutFactory, make
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.utils import cli as cli_mod
from qsm_tpu_torch.utils import report
from qsm_tpu_torch.utils.cli import BACKENDS, main
from qsm_tpu_torch.utils.interop import history_to_rows
from qsm_tpu_torch.utils.stats import schedule_coverage

SPEC = RegisterSpec()
CFG = dict(n_trials=60, n_pids=2, max_ops=12, seed=1234)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _results(spec_kw=None):
    """(port result, reference result) of the racy register property."""
    spec = RegisterSpec(**(spec_kw or {}))
    res = prop_concurrent(spec, RacyCachedRegisterSUT(), PropertyConfig(**CFG))
    jspec = jmake("register", "racy", spec_kw)[0]
    jres = qsm_tpu.prop_concurrent(
        jspec, jmake("register", "racy", spec_kw)[1],
        qsm_tpu.PropertyConfig(**CFG), oracle=JOracle(memo=True))
    assert not res.ok and not jres.ok
    return spec, res, jspec, jres


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return None


# ---------------------------------------------------------------------------
# utils (tests/test_utils.py)
# ---------------------------------------------------------------------------

def test_registry_covers_the_reference_models():
    assert set(MODELS) == set(JMODELS)
    for name, entry in MODELS.items():
        assert sorted(entry.impls) == sorted(JMODELS[name].impls)
        assert (entry.default_pids, entry.default_ops) == \
            (JMODELS[name].default_pids, JMODELS[name].default_ops)
        _, sut = make(name, "racy")
        assert hasattr(sut, "perform") and "atomic" in entry.impls


def test_sut_factory_pickles_and_builds():
    f = pickle.loads(pickle.dumps(SutFactory("kv", "racy", {"n_keys": 4})))
    sut = f()
    assert type(sut).__name__ == type(make("kv", "racy")[1]).__name__
    assert sut is not f()


def test_cli_list_equals_the_reference(capsys):
    from qsm_tpu_torch.native import native_available

    assert native_available()  # built once; `list` itself builds nothing
    assert main(["list"]) == 0
    out = _last_json(capsys)
    assert jmain(["list"]) == 0
    ref = _last_json(capsys)
    assert out["backends"] == list(BACKENDS)
    assert {"stepper", "gpu", "segdc-stepper"} <= set(out["backends"])
    assert out["native"] in ("loaded", "built")
    assert out["native_available"] is True
    for d in (out, ref):
        d.pop("backends")
        d.pop("native")
    assert out == ref


def test_format_counterexample_is_the_reference_text():
    spec, res, jspec, jres = _results()
    cx, jcx = res.counterexample, jres.counterexample
    assert cx.trial_seed == jcx.trial_seed
    text = report.format_counterexample(spec, cx)
    assert text == jreport.format_counterexample(jspec, jcx)
    assert text.count("pid ") == len(cx.history.ops) and "[" in text
    assert report.format_history(spec, cx.history) == \
        jreport.format_history(jspec, jcx.history)
    assert report.format_history(spec, cx.history.__class__([])) == \
        "(empty history)"


def test_jsonl_logger(tmp_path):
    buf = io.StringIO()
    log = report.JsonlLogger(stream=buf)
    log.emit("trial", trial=3, ok=True)
    rec = json.loads(buf.getvalue())
    assert rec["event"] == "trial" and rec["trial"] == 3 and rec["ok"]
    path = tmp_path / "l.jsonl"
    log = report.JsonlLogger(path=str(path))
    log.emit("a", x=1)
    log.emit("b", x=2)
    log.close()
    assert [json.loads(x)["event"] for x in path.read_text().splitlines()] \
        == ["a", "b"]


def test_schedule_coverage_equals_the_reference():
    prog = generate_program(SPEC, seed=3, n_pids=2, max_ops=8)
    jspec = jmake("register", "racy")[0]
    jprog = qsm_tpu.generate_program(jspec, seed=3, n_pids=2, max_ops=8)
    s1 = schedule_coverage(lambda: RacyCachedRegisterSUT(), prog,
                           seeds=range(30))
    s2 = schedule_coverage(lambda: RacyCachedRegisterSUT(), prog,
                           seeds=range(30))
    ref = j_coverage(lambda: jmake("register", "racy")[1], jprog,
                     seeds=range(30))
    assert s1 == s2
    assert (s1.seeds, s1.distinct_schedules, s1.distinct_histories) == \
        (ref.seeds, ref.distinct_schedules, ref.distinct_histories)
    assert s1.distinct_schedules > 1
    s3 = schedule_coverage(lambda: RacyCachedRegisterSUT(), prog,
                           seeds=[0, 0])
    assert s3.distinct_schedules == 1


def test_coverage_cli_equals_the_reference(capsys):
    argv = ["coverage", "--model", "register", "--impl", "racy", "--pids",
            "2", "--ops", "6", "--runs", "40", "--seed", "3"]
    assert main(argv) == 0
    out = _last_json(capsys)
    assert jmain(argv) == 0
    assert out == _last_json(capsys)


# ---------------------------------------------------------------------------
# regression files: the same keys, loaded and replayed by either package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_kw", [None, {"n_values": 9}])
def test_regression_files_cross_load(tmp_path, spec_kw):
    spec, res, jspec, jres = _results(spec_kw)
    cfg = PropertyConfig(**CFG)
    ours, theirs = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    report.save_regression(ours, "register", "racy", spec, cfg,
                           res.counterexample)
    jreport.save_regression(theirs, "register", "racy", jspec,
                            qsm_tpu.PropertyConfig(**CFG),
                            jres.counterexample)
    doc, jdoc = (json.load(open(p)) for p in (ours, theirs))
    assert _keys(doc) == _keys(jdoc)
    assert list(doc["config"]) == list(jdoc["config"])
    assert doc == jdoc  # the same failure, saved the same way
    for path in (ours, theirs):
        for load in (report.load_regression, jreport.load_regression):
            model, impl, key, prog, hist, faults, kw = load(path)
            assert (model, impl, faults) == ("register", "racy", None)
            assert key == res.counterexample.trial_seed
            assert kw == spec.spec_kwargs() and kw
            assert [(o.pid, o.cmd, o.arg) for o in prog.ops] == \
                [(o.pid, o.cmd, o.arg) for o in res.counterexample.program.ops]
            assert history_to_rows(hist) == \
                history_to_rows(res.counterexample.history)
        spec2, _ = make(*report.load_regression(path)[:2],
                        report.load_regression(path)[6])
        assert spec2.n_values == spec.n_values


def test_faults_docs_round_trip_with_the_reference():
    from qsm_tpu_torch.sched.scheduler import FaultPlan

    plan = FaultPlan(p_drop=0.1, p_duplicate=0.05, p_delay=0.2,
                     delay_steps=5, partitions=[{"a", "b"}],
                     crash_at={"primary": 3}, protected={"x"})
    doc = report.faults_to_doc(plan)
    jplan = jreport.faults_from_doc(doc)
    assert jreport.faults_to_doc(jplan) == doc
    back = report.faults_from_doc(jreport.faults_to_doc(jplan))
    assert report.faults_to_doc(back) == doc
    assert report.faults_to_doc(None) is None


def test_history_from_rows_equals_the_reference():
    rows = [[1, 0, 0, 3, 2, 3], [0, 1, 3, 0, 0, 1], [2, 1, 1, -1, 4, 9],
            [3, 0, 0, None, 5, None], [0, 0, 0, 1, 6, (1 << 30) + 5]]
    got = history_to_rows(report.history_from_rows(rows))
    assert got == history_to_rows(jreport.history_from_rows(rows))
    assert got[0][:2] == [0, 1]  # canonical order
    with pytest.raises(ValueError, match="precedes"):
        report.history_from_rows([[0, 0, 0, 1, 5, 2]])


def test_cli_run_save_regression_and_replay_in_both(tmp_path, capsys):
    reg = str(tmp_path / "cx.json")
    rc = main(["run", "--model", "register", "--impl", "racy", "--trials",
               "200", "--seed", "1", "--backend", "stepper", "--device",
               "cpu", "--save-regression", reg])
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL" in out and "replay:" in out
    jreg = str(tmp_path / "jcx.json")
    assert jmain(["run", "--model", "register", "--impl", "racy",
                  "--trials", "200", "--seed", "1", "--save-regression",
                  jreg]) == 1
    assert json.load(open(reg)) == json.load(open(jreg))
    for path in (reg, jreg):
        for fn in (main, jmain):
            assert fn(["replay", "--regression", path]) == 1
            out = capsys.readouterr().out
            assert "bit-identically: True" in out and "VIOLATION" in out


def test_cli_run_atomic_ok(capsys):
    assert main(["run", "--model", "ticket", "--impl", "atomic",
                 "--trials", "20", "--backend", "auto"]) == 0
    assert "OK" in capsys.readouterr().out


def test_replay_by_seed_with_witness_equals_the_reference(capsys):
    argv = ["replay", "--model", "cas", "--impl", "atomic", "--trial-seed",
            "0:3", "--pids", "3", "--ops", "8", "--trials", "10",
            "--witness"]
    rc = main(argv)
    out = capsys.readouterr().out
    jrc = jmain(argv)
    assert (rc, out) == (jrc, capsys.readouterr().out)
    assert rc == 0 and "witness verifies (search-free replay): True" in out


def test_run_with_faults_prints_every_fault_flag_and_replays(tmp_path,
                                                           capsys):
    argv = ["run", "--model", "cas", "--impl", "racy", "--trials", "40",
            "--pids", "4", "--ops", "10", "--p-drop", "0.05",
            "--p-duplicate", "0.02", "--p-delay", "0.03", "--delay-steps",
            "4", "--crash-at", "client:3:7", "--partition", "client:0"]
    reg = str(tmp_path / "f.json")
    rc = main(argv + ["--backend", "stepper", "--device", "cpu",
                      "--save-regression", reg])
    out = capsys.readouterr().out
    assert rc == 1
    hint = next(x for x in out.splitlines() if x.startswith("replay:"))
    for flag in ("--p-drop 0.05", "--p-duplicate 0.02", "--p-delay 0.03",
                 "--delay-steps 4", "--crash-at client:3:7",
                 "--partition client:0"):
        assert flag in hint, flag
    assert jmain(argv) == 1
    jout = capsys.readouterr().out
    jhint = next(x for x in jout.splitlines() if x.startswith("replay:"))
    assert hint.split("replay ", 1)[1] == jhint.split("replay ", 1)[1]
    # the pasted hint replays the trial's (unshrunk) violating history
    # under the same fault plan, as the reference's hint does; the file
    # replays the shrunk one
    args = hint.split("replay ", 1)[1].replace("'", "").split()
    assert main(["replay"] + args) == 1
    by_hint = capsys.readouterr().out
    assert jmain(["replay"] + args) == 1
    assert by_hint == capsys.readouterr().out
    assert "verdict: VIOLATION" in by_hint
    assert main(["replay", "--regression", reg]) == 1
    assert "bit-identically: True" in capsys.readouterr().out


def test_run_over_tcp_with_workers_equals_memory(tmp_path, capsys):
    base = ["run", "--model", "cas", "--impl", "racy", "--trials", "30",
            "--pids", "4", "--ops", "10", "--backend", "stepper",
            "--device", "cpu"]
    log = str(tmp_path / "run.jsonl")
    assert main(base + ["--log", log]) == 1
    mem = capsys.readouterr().out
    assert main(base + ["--transport", "tcp", "--workers", "2"]) == 1
    tcp = capsys.readouterr().out
    # the same counterexample and replay key (the first line carries the
    # wall time)
    assert mem.splitlines()[1:] == tcp.splitlines()[1:]
    rec = json.loads(open(log).read().strip())
    assert rec["event"] == "result" and rec["ok"] is False
    assert rec["schedules"] > 0 and "execute" in rec["timings"]


# ---------------------------------------------------------------------------
# the sequential property (tests/test_sequential.py)
# ---------------------------------------------------------------------------

SEQ_SPEC = RegisterSpec(n_values=5)


def test_model_sut_always_passes():
    for seed in range(25):
        prog = generate_program(SEQ_SPEC, seed=seed, n_pids=1, max_ops=12)
        res = run_sequential(SEQ_SPEC, ModelSUT(SEQ_SPEC), prog)
        assert res.ok, (seed, res.failed_at)
        assert len(res.history) == len(prog)


class StuckRegister:
    """Broken SUT: writes are dropped."""

    def reset(self):
        self.value = 0

    def apply(self, cmd, arg):
        return self.value if cmd == READ else 0


def test_broken_sut_fails_as_in_the_reference():
    jspec = jmake("register", "atomic", {"n_values": 5})[0]
    for seed in range(50):
        prog = generate_program(SEQ_SPEC, seed=seed, n_pids=1, max_ops=12)
        res = run_sequential(SEQ_SPEC, StuckRegister(), prog)
        jprog = qsm_tpu.generate_program(jspec, seed=seed, n_pids=1,
                                         max_ops=12)
        jres = qsm_tpu.run_sequential(jspec, StuckRegister(), jprog)
        assert (res.ok, res.failed_at) == (jres.ok, jres.failed_at)
        assert history_to_rows(res.history) == history_to_rows(jres.history)
        if not res.ok:
            return
    raise AssertionError("write-dropping register was never caught")


def test_prop_sequential_model_self_test_passes():
    res = prop_sequential(SEQ_SPEC, ModelSUT(SEQ_SPEC), n_trials=50,
                          max_ops=12, seed=3)
    assert res.ok and res.trials_run == 50


class DropsSecondWrite:
    """Sequential SUT that ignores every second write."""

    def reset(self):
        self.v = 0
        self.writes = 0

    def apply(self, cmd, arg):
        if cmd == 1:
            self.writes += 1
            if self.writes % 2 == 0:
                return 0
            self.v = arg
            return 0
        return self.v


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_prop_sequential_finds_and_shrinks_like_the_reference(seed):
    res = prop_sequential(SEQ_SPEC, DropsSecondWrite(), n_trials=200,
                          max_ops=12, seed=seed)
    jspec = jmake("register", "atomic", {"n_values": 5})[0]
    jres = qsm_tpu.prop_sequential(jspec, DropsSecondWrite(), n_trials=200,
                                   max_ops=12, seed=seed)
    assert not res.ok and not jres.ok
    assert (res.trials_run, res.trial_seed, res.failed_at,
            res.shrink_steps) == (jres.trials_run, jres.trial_seed,
                                  jres.failed_at, jres.shrink_steps)
    assert [(o.pid, o.cmd, o.arg) for o in res.counterexample.ops] == \
        [(o.pid, o.cmd, o.arg) for o in jres.counterexample.ops]
    assert history_to_rows(res.history) == history_to_rows(jres.history)
    assert len(res.counterexample) <= 4


# ---------------------------------------------------------------------------
# check (tests/test_check_cli.py)
# ---------------------------------------------------------------------------

def _write(tmp_path, doc, name="trace.json"):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def _check_both(capsys, argv, port_extra=("--device", "cpu")):
    rc = main(list(argv) + list(port_extra))
    out = _last_json(capsys)
    jrc = jmain(list(argv))
    assert (rc, out) == (jrc, _last_json(capsys))
    return rc, out


TRACES = {
    "ok": {"model": "register",
           "history": [[0, 1, 3, 0, 0, 1], [1, 0, 0, 3, 2, 3]]},
    "stale": {"model": "register",
              "history": [[0, 1, 3, 0, 0, 1], [1, 0, 0, 0, 2, 3]]},
    "pending": {"history": [[0, 1, 1, -1, 0, 1 << 30], [1, 0, 0, 1, 2, 3]]},
}


@pytest.mark.parametrize("backend", ["stepper", "gpu", "cpu", "cpp"])
def test_check_single_traces_equal_the_reference(tmp_path, capsys,
                                                 backend):
    extra = ("--backend", backend, "--device", "cpu")
    rc, out = _check_both(capsys, ["check", "--trace",
                                   _write(tmp_path, TRACES["ok"]),
                                   "--witness"], extra)
    assert rc == 0 and out["witness_verifies"] is True
    rc, out = _check_both(capsys, ["check", "--trace",
                                   _write(tmp_path, TRACES["stale"])], extra)
    assert rc == 1 and out["verdict"] == "VIOLATION"
    rc, out = _check_both(capsys, ["check", "--trace",
                                   _write(tmp_path, TRACES["pending"]),
                                   "--model", "register"], extra)
    assert rc == 0 and out["pending"] == 1


def test_check_accepts_saved_regression_files(tmp_path, capsys):
    reg = str(tmp_path / "cx.json")
    assert main(["run", "--model", "cas", "--impl", "racy", "--trials",
                 "80", "--seed", "5", "--backend", "cpp",
                 "--save-regression", reg]) == 1
    capsys.readouterr()
    rc, out = _check_both(capsys, ["check", "--trace", reg])
    assert rc == 1 and out["verdict"] == "VIOLATION" and out["model"] == "cas"


@pytest.mark.parametrize("backend", ["stepper", "gpu", "hybrid-stepper"])
def test_check_batch_equals_the_reference(tmp_path, capsys, backend):
    from qsm_tpu_torch.utils.corpus import build_corpus

    entry = MODELS["register"]
    hs = build_corpus(entry.make_spec(), (entry.impls["atomic"],
                                          entry.impls["racy"]), n=24,
                      n_pids=3, max_ops=12, seed_base=7, seed_prefix="e")
    path = _write(tmp_path, {"model": "register",
                             "histories": [history_to_rows(h) for h in hs]})
    rc, out = _check_both(capsys, ["check", "--trace", path],
                          ("--backend", backend, "--device", "cpu"))
    assert out["histories"] == 24 and out["undecided"] == 0
    assert rc == (1 if out["violations"] else 0)
    assert 0 < out["violations"] < 24
    small = _write(tmp_path, {"model": "register", "histories": [
        TRACES["ok"]["history"], TRACES["stale"]["history"],
        [[0, 0, 0, 0, 0, 1]]]}, "small.json")
    rc, out = _check_both(capsys, ["check", "--trace", small],
                          ("--backend", backend, "--device", "cpu"))
    assert rc == 1 and out["verdicts"] == ["LINEARIZABLE", "VIOLATION",
                                           "LINEARIZABLE"]


def test_check_resolves_a_device_deferral_on_the_host(tmp_path, capsys,
                                                      monkeypatch):
    """A device backend's BUDGET_EXCEEDED is decided again by the host
    oracle; a host oracle's answer is left as it is."""
    class Defers:
        def check_histories(self, spec, hs):
            return [int(Verdict.BUDGET_EXCEEDED)] * len(hs)

    monkeypatch.setattr(cli_mod, "make_backend", lambda *a: Defers())
    path = _write(tmp_path, {"model": "register", "histories": [
        TRACES["ok"]["history"], TRACES["stale"]["history"]]})
    assert main(["check", "--trace", path, "--backend", "stepper"]) == 1
    assert _last_json(capsys)["verdicts"] == ["LINEARIZABLE", "VIOLATION"]
    assert main(["check", "--trace", path, "--backend", "cpp"]) == 2
    out = _last_json(capsys)
    assert out["undecided"] == 2 and out["violations"] == 0
    single = _write(tmp_path, TRACES["stale"], "one.json")
    assert main(["check", "--trace", single]) == 1
    assert _last_json(capsys)["verdict"] == "VIOLATION"


def test_check_refusals(tmp_path):
    with pytest.raises(SystemExit, match="no 'model'"):
        main(["check", "--trace", _write(tmp_path, {"history": [
            [0, 0, 0, 0, 0, 1]]})])
    with pytest.raises(SystemExit, match="--witness applies"):
        main(["check", "--trace", _write(tmp_path, {
            "model": "register", "histories": [[[0, 0, 0, 0, 0, 1]]]}),
            "--witness"])
    with pytest.raises(SystemExit, match="needs a 'history'"):
        main(["check", "--trace", _write(tmp_path, {"model": "register"})])


def test_check_on_the_card_by_default_raises_without_cuda(tmp_path):
    """``check`` defaults to the stepper on CUDA: without a card and
    without ``--device cpu`` it raises, never running on the host."""
    import torch

    from qsm_tpu_torch.ops.backend import BackendUnavailable

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(BackendUnavailable):
        main(["check", "--trace", _write(tmp_path, TRACES["ok"])])


# ---------------------------------------------------------------------------
# backends (tests/test_cli_backends.py)
# ---------------------------------------------------------------------------

def test_every_backend_choice_constructs():
    from qsm_tpu_torch.models.cas import CasSpec
    from qsm_tpu_torch.models.kv import KvSpec
    from qsm_tpu_torch.models.queue import QueueSpec
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops.gpu_backend import TorchGPU
    from qsm_tpu_torch.ops.hybrid import HybridDevice
    from qsm_tpu_torch.ops.pcomp import PComp
    from qsm_tpu_torch.ops.rootsplit import RootSplit
    from qsm_tpu_torch.ops.router import AutoDevice
    from qsm_tpu_torch.ops.segdc import SegDC
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU

    want = {
        "auto": (CppOracle, QueueSpec), "cpu": (WingGongCPU, QueueSpec),
        "cpp": (CppOracle, QueueSpec), "gpu": (TorchGPU, CasSpec),
        "stepper": (TorchStepper, QueueSpec),
        "pcomp": (PComp, KvSpec), "pcomp-cpp": (PComp, KvSpec),
        "pcomp-stepper": (PComp, KvSpec),
        "hybrid-stepper": (HybridDevice, QueueSpec),
        "segdc": (SegDC, QueueSpec), "segdc-cpp": (SegDC, QueueSpec),
        "segdc-stepper": (SegDC, QueueSpec),
        "rootsplit": (RootSplit, QueueSpec),
        "rootsplit-stepper": (RootSplit, QueueSpec),
        "auto-stepper": (AutoDevice, QueueSpec),
    }
    assert set(want) == set(BACKENDS)
    for name, (ty, mk) in want.items():
        assert isinstance(cli_mod.make_backend(name, mk(), "cpu"), ty), name
    b = cli_mod.make_backend("segdc-stepper", CasSpec(), "cpu")
    assert isinstance(b.inner, TorchStepper) and b.device_final
    b = cli_mod.make_backend("pcomp-stepper", KvSpec(), "cpu")
    assert isinstance(b.inner, TorchStepper)
    b = cli_mod.make_backend("rootsplit-stepper", CasSpec(), "cpu")
    assert isinstance(b.inner, TorchStepper) and not b.eager
    b = cli_mod.make_backend("hybrid-stepper", CasSpec(), "cpu")
    assert isinstance(b.device, TorchStepper)
    assert isinstance(b.tail, CppOracle)


def test_unknown_backend_refused():
    from qsm_tpu_torch.models.cas import CasSpec

    with pytest.raises(SystemExit):
        cli_mod.make_backend("tpu", CasSpec())


def test_fuzz_cli_equals_the_reference_on_host_arms(capsys):
    argv = ["fuzz", "--specs", "4", "--histories", "8", "--backends",
            "memo,cpp"]
    assert main(argv) == 0
    out = _last_json(capsys)
    assert jmain(argv) == 0
    assert out == _last_json(capsys)
    assert out["ok"] and out["mismatches"] == []
    assert out["cpp_native_histories"] > 0


def test_fuzz_cli_device_arms_on_the_cpu(capsys):
    argv = ["fuzz", "--specs", "2", "--histories", "8", "--seed", "3",
            "--backends", "memo,device,hybrid,pallas"]
    assert main(argv + ["--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert out["ok"] and out["mismatches"] == []
    assert jmain(["fuzz", "--specs", "2", "--histories", "8", "--seed",
                  "3", "--backends", "memo"]) == 0
    ref = _last_json(capsys)
    for k in ("specs", "histories", "linearizable", "violations",
              "budget_exceeded"):
        assert out[k] == ref[k], k
