"""The port's resilience plane against the JAX package's, on the CPU
(``TorchStepper(device="cpu")`` runs its kernels' plain versions where the
reference's tests use ``JaxTPU``): the retry policy and the watchdog, the
fault plane's grammar, ``@nth`` and seeded draws (the same fault string
fires at the same hits in both packages), degradation whose verdicts and
witnesses equal the reference's clean host run bit for bit across the
register, cas, queue and kv families, banked progress after a loss
mid-run, hung dispatches, the hybrid plan, a property run's survival,
``CellJournal`` (a journal of either package resumes in the other), and
the card's rule: with a CUDA engine only an injected fault degrades.

Not twinned: the reference's probe case (``test_resilience.py:188``; the
port has no TPU probe) and its bench-scan case (``:397``; it drives a
reference tool, ``tools/bench_configs.py``)."""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from qsm_tpu.core.property import PropertyConfig as JConfig
from qsm_tpu.core.property import prop_concurrent as j_prop
from qsm_tpu.models.registry import MODELS as JMODELS
from qsm_tpu.resilience import checkpoint as jcheckpoint
from qsm_tpu.resilience import faults as jfaults
from qsm_tpu.resilience import policy as jpolicy
from qsm_tpu.resilience.failover import collect_resilience as j_collect
from qsm_tpu.resilience.failover import host_fallback as j_host
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.ops.backend import (BackendUnavailable, Verdict,
                                       device_error_types)
from qsm_tpu_torch.ops.hybrid import HybridDevice
from qsm_tpu_torch.ops.pcomp import PComp
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.resilience import faults as faults_mod
from qsm_tpu_torch.resilience.checkpoint import (CellJournal,
                                                 atomic_write_json)
from qsm_tpu_torch.resilience.failover import (FailoverBackend,
                                               InjectedHang,
                                               collect_resilience,
                                               host_fallback, host_only)
from qsm_tpu_torch.resilience.faults import FaultPlane, InjectedFault
from qsm_tpu_torch.resilience.policy import (PRESETS, RetryPolicy,
                                             Watchdog, WatchdogTimeout,
                                             preset, watchdog)
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

FAMILIES = ("register", "cas", "queue", "kv")
CPU = dict(device="cpu")


@pytest.fixture
def faultenv(monkeypatch):
    """A fault schedule, parsed afresh in both packages (each plane keeps
    its own hit counts, and an @nth rule must not inherit another
    case's)."""

    def set_faults(spec: str, seed: str = "0", hang_s=None):
        monkeypatch.setenv(faults_mod.ENV_VAR, spec)
        monkeypatch.setenv(faults_mod.SEED_VAR, seed)
        if hang_s is not None:
            monkeypatch.setenv(faults_mod.HANG_VAR, str(hang_s))
        monkeypatch.setattr(faults_mod, "_plane", None)
        monkeypatch.setattr(jfaults, "_plane", None)

    yield set_faults
    monkeypatch.setattr(faults_mod, "_plane", None)
    monkeypatch.setattr(jfaults, "_plane", None)


def _corpus(name, n=6, pids=2, ops=8):
    """The reference's corpus, and the port's spec and histories."""
    entry = JMODELS[name]
    jspec = entry.make_spec()
    hists = build_corpus(jspec, (entry.impls["atomic"], entry.impls["racy"]),
                         n=n, n_pids=pids, max_ops=ops,
                         seed_prefix=f"resil_{name}")
    spec = MODELS[name].make_spec()
    return jspec, hists, spec, [history_from_rows(history_to_rows(h))
                                for h in hists]


def _clean(name, n=6):
    """(port spec, port histories, the reference's clean host verdicts)."""
    jspec, jh, spec, hists = _corpus(name, n=n)
    return spec, hists, np.asarray(j_host(jspec).check_histories(jspec, jh))


def _no_retry(**kw):
    return preset("dispatch").with_(attempts=1, backoff_s=0.0, **kw)


# =====================================================================
# RetryPolicy / watchdog
# =====================================================================

def _flaky_run(policy_cls):
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    pol = policy_cls(attempts=4, backoff_s=1.0, backoff_factor=2.0)
    return pol.run(flaky, sleep=slept.append), len(calls), slept


def test_policy_retries_then_returns_first_success():
    got = _flaky_run(RetryPolicy)
    assert got == ("ok", 3, [1.0, 2.0])
    assert got == _flaky_run(jpolicy.RetryPolicy)


def test_policy_exhausted_ladder_raises_last_error():
    for cls in (RetryPolicy, jpolicy.RetryPolicy):
        with pytest.raises(OSError, match="always"):
            cls(attempts=2, backoff_s=0.0).run(
                lambda: (_ for _ in ()).throw(OSError("always")),
                sleep=lambda d: None)


def test_policy_should_retry_returns_last_rejected_value():
    outs = []
    for cls in (RetryPolicy, jpolicy.RetryPolicy):
        vals = iter([1, 2, 3])
        outs.append(cls(attempts=3, backoff_s=0.0).run(
            lambda: next(vals), should_retry=lambda v: v < 10,
            sleep=lambda d: None))
    assert outs == [3, 3]


def test_policy_deadline_stops_ladder_before_attempts():
    for cls in (RetryPolicy, jpolicy.RetryPolicy):
        calls = []
        pol = cls(attempts=10, backoff_s=100.0, deadline_s=1.0)
        with pytest.raises(OSError):
            pol.run(lambda: calls.append(1) or
                    (_ for _ in ()).throw(OSError("x")),
                    sleep=lambda d: None)
        assert len(calls) == 1


def test_policy_jitter_is_bounded_and_seeded():
    kw = dict(attempts=4, backoff_s=10.0, backoff_factor=1.0,
              jitter_frac=0.5)
    d1 = list(RetryPolicy(**kw).delays(random.Random(7)))
    assert d1 == list(RetryPolicy(**kw).delays(random.Random(7)))
    assert all(5.0 <= d <= 15.0 for d in d1)
    # the same draws as the reference's from the same rng
    assert d1 == list(jpolicy.RetryPolicy(**kw).delays(random.Random(7)))


def test_presets_exist_and_unknown_name_is_a_clean_error():
    for name in ("probe", "watcher-probe", "window-reprobe",
                 "bench-probe", "seize-probe", "dispatch"):
        assert PRESETS[name].name == name
    assert preset("bench-probe").attempts == 3
    with pytest.raises(KeyError, match="bench-probe"):
        preset("nope")
    assert preset("probe").with_(timeout_s=1.0).name == "probe*"
    # the whole table is the reference's, field for field
    assert {k: dataclasses.asdict(v) for k, v in PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jpolicy.PRESETS.items()}


def test_watchdog_abandons_hung_call_and_relays_errors():
    assert watchdog(lambda: 42, None) == 42
    assert watchdog(lambda: 42, 5.0) == 42
    with pytest.raises(WatchdogTimeout, match="abandoned"):
        watchdog(lambda: time.sleep(3.0), 0.05, label="t")
    with pytest.raises(ValueError, match="mine"):
        watchdog(lambda: (_ for _ in ()).throw(ValueError("mine")), 5.0)


def test_watchdog_worker_is_reused_and_replaced_when_abandoned():
    """``Watchdog`` runs its calls on one long-lived thread, abandons it
    on a timeout, starts a fresh one for the next call (a retry never
    queues behind the hung call) and stops its worker when collected."""
    import gc

    wd = Watchdog("t")
    assert wd(threading.get_ident, None) == threading.get_ident()
    first = wd(threading.get_ident, 5.0)
    assert first != threading.get_ident()
    assert wd(threading.get_ident, 5.0) == first
    with pytest.raises(ValueError, match="mine"):
        wd(lambda: (_ for _ in ()).throw(ValueError("mine")), 5.0)
    assert wd(threading.get_ident, 5.0) == first
    release = threading.Event()
    with pytest.raises(WatchdogTimeout, match="abandoned"):
        wd(lambda: release.wait(5.0), 0.05)
    second = wd(threading.get_ident, 5.0)
    assert second != first
    assert wd(threading.get_ident, 5.0) == second
    release.set()
    workers = [t for t in threading.enumerate()
               if t.ident in (first, second)]
    del wd
    gc.collect()
    for t in workers:
        t.join(5.0)
        assert not t.is_alive()


# =====================================================================
# The fault plane
# =====================================================================

def test_fault_rule_parsing_and_errors():
    for spec in ("hang:dispatch:0.3,raise:seize,wedge:probe",
                 "raise:dispatch@2", "kill:worker@3,partition:node:0.5"):
        mine = [dataclasses.astuple(r) for r in FaultPlane.parse(spec).rules]
        ref = [dataclasses.astuple(r)
               for r in jfaults.FaultPlane.parse(spec).rules]
        assert mine == ref
    plane = FaultPlane.parse("hang:dispatch:0.3,raise:seize,wedge:probe")
    assert [(r.action, r.site, r.p) for r in plane.rules] == [
        ("hang", "dispatch", 0.3), ("raise", "seize", 1.0),
        ("wedge", "probe", 1.0)]
    assert FaultPlane.parse("raise:dispatch@2").rules[0].nth == 2
    for bad in ("explode:dispatch", "raise:", "raise:x:2.0",
                "raise:dispatch@0", "raise:dispatch@x", "justasite"):
        with pytest.raises(ValueError):
            FaultPlane.parse(bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlane.parse(bad)


def test_fault_nth_fires_on_nth_hit_and_every_later_one():
    plane = FaultPlane.parse("raise:dispatch@3")
    fires = [plane.action_for("dispatch") for _ in range(5)]
    assert fires == [None, None, "raise", "raise", "raise"]
    ref = jfaults.FaultPlane.parse("raise:dispatch@3")
    assert fires == [ref.action_for("dispatch") for _ in range(5)]
    assert plane.acted == {("dispatch", "raise"): 3}


def test_fault_probability_draws_are_seed_replayable():
    a = FaultPlane.parse("raise:dispatch:0.5", seed="11")
    b = FaultPlane.parse("raise:dispatch:0.5", seed="11")
    fires = [a.action_for("dispatch") for _ in range(32)]
    assert fires == [b.action_for("dispatch") for _ in range(32)]
    assert None in fires and "raise" in fires
    # a fault string fires at the same hits in both packages
    ref = jfaults.FaultPlane.parse("raise:dispatch:0.5", seed="11")
    assert fires == [ref.action_for("dispatch") for _ in range(32)]


def test_inject_is_a_noop_when_plane_is_off(faultenv, monkeypatch):
    monkeypatch.delenv(faults_mod.ENV_VAR, raising=False)
    assert faults_mod.inject("dispatch") is None
    assert faults_mod.fired_snapshot() == {}
    assert faults_mod.acted("dispatch", "raise") == 0


def test_inject_raise_wedge_and_bounded_hang(faultenv):
    faultenv("raise:seize,wedge:probe,hang:dispatch", hang_s=0.01)
    with pytest.raises(InjectedFault, match="seize"):
        faults_mod.inject("seize")
    assert faults_mod.inject("probe") == "wedge"
    with pytest.raises(InjectedFault, match="dispatch"):
        faults_mod.inject("dispatch")
    assert faults_mod.fired_snapshot() == {"seize": 1, "probe": 1,
                                           "dispatch": 1}
    assert faults_mod.acted("dispatch", "hang") == 1


def test_device_entry_points_are_dispatch_sites(faultenv):
    """Both device backends hit the site, as JaxTPU does: once a
    check_histories and once a check_witness (whose pending path goes
    through check_histories again)."""
    from qsm_tpu_torch.core.history import overlapping_history
    from qsm_tpu_torch.models.register import RegisterSpec
    from qsm_tpu_torch.ops.gpu_backend import TorchGPU

    faultenv("wedge:nowhere")
    spec = RegisterSpec(n_values=4)
    h = overlapping_history([(0, 1, 3, 0, 0, 1), (1, 0, 0, 3, 2, 3)])
    for eng in (TorchStepper(spec, **CPU), TorchGPU(spec, **CPU)):
        faultenv("wedge:nowhere")
        eng.check_histories(spec, [h])
        eng.check_histories(spec, [])
        eng.check_witness(spec, h)
        assert faults_mod.active_plane().hits == {"dispatch": 3}


# =====================================================================
# Degraded runs equal to the reference's clean host run
# =====================================================================

@pytest.mark.parametrize("family", FAMILIES)
def test_dead_device_degrades_bit_identical(family, faultenv):
    spec, hists, clean = _clean(family)
    faultenv("raise:dispatch")
    fo = FailoverBackend(spec, TorchStepper(spec, **CPU), policy=_no_retry())
    got = fo.check_histories(spec, hists)
    np.testing.assert_array_equal(np.asarray(got), clean)
    r = fo.resilience()
    assert r["degradations"] == 1
    assert r["fallback_histories"] == len(hists)
    assert r["device_histories"] == 0
    assert r["fallback_engine"]
    assert {int(Verdict.LINEARIZABLE)} <= set(clean.tolist())


def test_midrun_loss_banks_device_verdicts_and_degrades_rest(faultenv):
    spec, hists, clean = _clean("cas", n=8)
    faultenv("raise:dispatch@2")
    fo = FailoverBackend(spec, TorchStepper(spec, **CPU), dispatch_lanes=3,
                         policy=preset("dispatch").with_(attempts=2,
                                                         backoff_s=0.0))
    got = fo.check_histories(spec, hists)
    np.testing.assert_array_equal(np.asarray(got), clean)
    r = fo.resilience()
    assert r["degradations"] == 1
    assert r["device_histories"] == 3
    assert r["fallback_histories"] == 5
    assert r["retries"] == 1
    st = fo.search_stats()
    assert st.degradations == 1 and st.fallback_engine
    assert st.tail_histories == 5


def test_hung_dispatch_is_abandoned_and_degrades(faultenv):
    spec, hists, clean = _clean("cas")
    faultenv("hang:dispatch", hang_s=5)
    fo = FailoverBackend(spec, TorchStepper(spec, **CPU),
                         policy=_no_retry(timeout_s=0.1))
    got = fo.check_histories(spec, hists)
    np.testing.assert_array_equal(np.asarray(got), clean)
    assert fo.degraded and "abandoned" in fo.last_error
    # on the host the reference's own error type is what degrades
    assert fo.last_error.startswith("WatchdogTimeout")


@pytest.mark.parametrize("family", FAMILIES)
def test_degraded_witness_is_bit_identical(family, faultenv):
    jspec, jh, spec, hists = _corpus(family)
    ref = j_host(jspec)
    faultenv("raise:dispatch")
    fo = FailoverBackend(spec, TorchStepper(spec, **CPU), policy=_no_retry())
    for jhist, h in zip(jh[:3], hists[:3]):
        v, w = fo.check_witness(spec, h)
        rv, rw = ref.check_witness(jspec, jhist)
        assert int(v) == int(rv)
        assert (None if w is None else [tuple(p) for p in w]) == \
            (None if rw is None else [tuple(p) for p in rw])
    assert fo.degraded


def test_hybrid_backend_degrades_in_place(faultenv):
    spec, hists, clean = _clean("queue")
    faultenv("raise:dispatch")
    hy = HybridDevice(spec, **CPU)
    got = hy.check_histories(spec, hists)
    np.testing.assert_array_equal(np.asarray(got), clean)
    r = hy.resilience()
    assert r["degradations"] == 1 and r["fallback_engine"]
    assert hy.search_stats().degradations == 1


def test_property_run_survives_midrun_device_loss(faultenv):
    """The wrap in prop_concurrent degrades to the oracle: the run ends
    as the reference's clean host run does, and its timings record the
    degrade under the reference's keys."""
    cfg = dict(n_trials=6, n_pids=2, max_ops=8, seed=5)
    jentry = JMODELS["cas"]
    jspec = jentry.make_spec()
    ref = j_prop(jspec, jentry.impls["atomic"](jspec), JConfig(**cfg))
    entry = MODELS["cas"]
    spec = entry.make_spec()
    faultenv("raise:dispatch")
    res = prop_concurrent(spec, entry.impls["atomic"](spec),
                          PropertyConfig(**cfg),
                          backend=TorchStepper(spec, **CPU))
    assert res.ok, res.counterexample
    assert res.timings.get("resilience_degradations", 0) >= 1
    assert (res.trials_run, res.histories_checked,
            res.distinct_histories) == (ref.trials_run,
                                        ref.histories_checked,
                                        ref.distinct_histories)


def test_property_batch_degraded_midway_resolves_device_budget_lanes(
        faultenv, monkeypatch):
    """A property batch of more than one dispatch slice (1100 lanes) that
    degrades at its second slice: the BUDGET lanes the device left in its
    first slice are still resolved by the oracle, so the run is as exact
    as the reference's clean host run (the JAX package skips resolution
    for the whole batch once its wrapper has degraded)."""
    cfg = dict(n_trials=1, n_pids=2, max_ops=8, seed=3,
               schedules_per_program=1100)
    jentry = JMODELS["cas"]
    jspec = jentry.make_spec()
    ref = j_prop(jspec, jentry.impls["atomic"](jspec), JConfig(**cfg))
    entry = MODELS["cas"]
    spec = entry.make_spec()
    oracle = host_fallback(spec)
    st = TorchStepper(spec, budget=4, mid_budget=0, rescue_budget=0, **CPU)
    left = []
    run = st.check_histories

    def counted(spec_, hists):
        v = np.asarray(run(spec_, hists))
        left.append(int((v == Verdict.BUDGET_EXCEEDED).sum()))
        return v

    monkeypatch.setattr(st, "check_histories", counted)
    fo = FailoverBackend(spec, st, fallback=oracle, policy=_no_retry())
    faultenv("raise:dispatch@2")
    res = prop_concurrent(spec, entry.impls["atomic"](spec),
                          PropertyConfig(**cfg), backend=fo, oracle=oracle)
    assert (fo.degradations, fo.device_histories, fo.fallback_histories) \
        == (1, FailoverBackend.DISPATCH_LANES, 76)
    assert left[0] > 0   # the device's slice left lanes undecided
    assert res.ok and res.undecided == 0 == ref.undecided
    assert (res.trials_run, res.histories_checked,
            res.distinct_histories) == (ref.trials_run,
                                        ref.histories_checked,
                                        ref.distinct_histories)


def test_collect_resilience_zeros_for_plain_backends():
    from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle

    r = collect_resilience(WingGongCPU())
    assert r == {"degradations": 0, "retries": 0, "fallback_engine": None}
    assert r == j_collect(JOracle())


def test_injected_fault_is_in_the_device_error_taxonomy():
    errs = device_error_types()
    assert InjectedFault in errs and WatchdogTimeout in errs
    assert BackendUnavailable in errs


# =====================================================================
# The card's rule
# =====================================================================

def test_engine_device_discovery():
    from qsm_tpu_torch.models.kv import KvSpec
    from qsm_tpu_torch.native import CppOracle

    spec = MODELS["cas"].make_spec()
    kv = KvSpec(n_keys=4)
    assert host_only(WingGongCPU()) and host_only(CppOracle(spec))
    assert host_only(TorchStepper(spec, **CPU))
    assert host_only(PComp(kv, make_inner=lambda s: TorchStepper(s, **CPU)))
    assert host_only(host_fallback(spec))
    assert host_only(HybridDevice(spec, **CPU))

    class Opaque:
        def check_histories(self, spec, histories):
            return np.ones(len(histories), np.int8)

    # a wrapper whose device cannot be found follows the card's rule
    assert not host_only(Opaque())
    st = TorchStepper(spec, **CPU)
    st.device = torch.device("cuda", 0)
    assert not host_only(st)
    assert not host_only(FailoverBackend(spec, st))
    inner = []
    pc = PComp(kv, make_inner=lambda s: inner.append(
        TorchStepper(s, **CPU)) or inner[-1])
    inner[0].device = torch.device("cuda", 0)
    assert not host_only(pc)


def _on_card(spec, **kw):
    """A FailoverBackend over a TorchStepper that it saw on CUDA (so it
    applies the card's rule), whose searches then run the plain versions
    on the CPU."""
    st = TorchStepper(spec, **CPU)
    st.device = torch.device("cuda", 0)
    fo = FailoverBackend(spec, st, **kw)
    st.device = torch.device("cpu")
    assert fo.on_card
    return fo


@pytest.mark.parametrize("entry", ["check_histories", "check_witness"])
def test_card_rule_real_device_error_raises(monkeypatch, entry):
    """With a CUDA engine a device error the plane did not inject raises
    out of the wrapper, unretried, and no degrade is recorded."""
    spec, hists, _ = _clean("cas", n=2)
    fo = _on_card(spec)

    def lost(*a, **kw):
        raise BackendUnavailable("card lost")

    monkeypatch.setattr(fo.device, "_run_device", lost)
    with pytest.raises(BackendUnavailable, match="card lost"):
        if entry == "check_histories":
            fo.check_histories(spec, hists)
        else:
            fo.check_witness(spec, hists[0])
    assert not fo.degraded and fo.degradations == 0 and fo.retries == 0
    assert fo.resilience()["fallback_engine"] is None
    assert (fo.device_histories, fo.fallback_histories) == (0, 0)


def test_card_rule_real_error_raises_out_of_the_property_run(monkeypatch):
    """prop_concurrent wraps a CUDA engine as the reference does, and
    the wrap lets a real device error out."""
    entry = MODELS["cas"]
    spec = entry.make_spec()
    st = TorchStepper(spec, **CPU)
    st.device = torch.device("cuda", 0)

    def lost(*a, **kw):
        raise BackendUnavailable("card lost")

    monkeypatch.setattr(st, "_run_device", lost)
    with pytest.raises(BackendUnavailable, match="card lost"):
        prop_concurrent(spec, entry.impls["racy"](spec),
                        PropertyConfig(n_trials=4, n_pids=2, max_ops=6),
                        backend=st)


def test_card_rule_real_timeout_raises(monkeypatch):
    spec, hists, _ = _clean("cas", n=2)
    fo = _on_card(spec, policy=_no_retry(timeout_s=0.05))
    release = threading.Event()

    def slow(flat, *a, **kw):
        release.wait(5.0)  # a dispatch that outlives its bound
        return np.full(len(flat), 1, np.int32)

    monkeypatch.setattr(fo.device, "_run_device", slow)
    try:
        with pytest.raises(WatchdogTimeout) as err:
            fo.check_histories(spec, hists)
    finally:
        release.set()  # let the abandoned thread end
    assert not isinstance(err.value, InjectedHang)
    assert not fo.degraded and fo.degradations == 0


def test_card_rule_holds_for_the_hybrid_plan(faultenv, monkeypatch):
    """The hybrid plan applies the same rule (one definition,
    ``failover.degradable_errors``): on a CUDA device an injected fault
    still degrades it to the tail, with exact verdicts."""
    spec, hists, clean = _clean("cas")
    hb = HybridDevice(spec, **CPU)
    monkeypatch.setattr(hb.device, "device", torch.device("cuda", 0))
    faultenv("raise:dispatch")
    np.testing.assert_array_equal(hb.check_histories(spec, hists), clean)
    assert hb.degradations == 1 and hb.tail_histories == len(hists)


def test_card_rule_degrades_on_injected_faults(faultenv):
    """On a CUDA engine the plane's own faults still degrade: a raise,
    and a hang that the watchdog abandons."""
    spec, hists, clean = _clean("cas", n=8)
    faultenv("raise:dispatch@2")
    fo = _on_card(spec, dispatch_lanes=3,
                  policy=preset("dispatch").with_(attempts=2,
                                                  backoff_s=0.0))
    np.testing.assert_array_equal(fo.check_histories(spec, hists), clean)
    assert (fo.degradations, fo.retries, fo.device_histories,
            fo.fallback_histories) == (1, 1, 3, 5)
    faultenv("hang:dispatch", hang_s=3)
    fo = _on_card(spec, policy=_no_retry(timeout_s=0.1))
    np.testing.assert_array_equal(fo.check_histories(spec, hists), clean)
    assert fo.degraded and fo.last_error.startswith("InjectedHang")


# =====================================================================
# Checkpoint / resume
# =====================================================================

def test_atomic_write_leaves_no_tmp_and_replaces_whole(tmp_path):
    p = tmp_path / "a.json"
    atomic_write_json(str(p), {"x": 1})
    atomic_write_json(str(p), {"x": 2}, indent=1)
    assert json.loads(p.read_text()) == {"x": 2}
    assert [f.name for f in tmp_path.iterdir()] == ["a.json"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cell_journal_banks_resumes_and_counts(tmp_path, writer):
    """A journal banked by either package resumes in the port, and the
    port's file is the reference's, byte for byte."""
    path = str(tmp_path / "scan.jsonl")
    cls = CellJournal if writer == "port" else jcheckpoint.CellJournal
    j1 = cls(path, {"artifact": "s", "device_fallback": "cpu"})
    j1.emit("b256", {"rate": 1.0})
    j1.emit("b512", {"rate": 2.0})
    j1.emit("b1024", {"skipped": "time box exhausted"})
    banked = open(path).read()

    j2 = CellJournal(path, {"artifact": "s", "device_fallback": "cpu"},
                     resume=True)
    assert j2.complete("b256") == {"cell": "b256", "rate": 1.0}
    assert j2.complete("b512")["rate"] == 2.0
    assert j2.complete("b1024") is None
    assert j2.resumed_cells == 2
    assert j2.header["resumed_cells"] == 2
    ref = str(tmp_path / "ref.jsonl")
    other = tmp_path / "other.jsonl"
    for p, c in ((ref, jcheckpoint.CellJournal), (str(other), CellJournal)):
        j = c(p, {"artifact": "s", "device_fallback": "cpu"})
        j.emit("b256", {"rate": 1.0})
        j.emit("b512", {"rate": 2.0})
        j.emit("b1024", {"skipped": "time box exhausted"})
    assert open(ref).read() == other.read_text() == banked


def test_cell_journal_rejects_mismatched_provenance(tmp_path):
    path = str(tmp_path / "scan.jsonl")
    j1 = CellJournal(path, {"artifact": "s", "device_fallback": "cpu"})
    j1.emit("b256", {"rate": 1.0})
    j2 = CellJournal(path, {"artifact": "s", "device_fallback": None},
                     resume=True)
    assert j2.resumed_cells == 0 and j2.complete("b256") is None
    saved = [json.loads(ln)
             for ln in open(path + ".pre-resume").read().splitlines()]
    assert saved[1]["rate"] == 1.0


def test_cell_journal_drops_truncated_trailing_line(tmp_path):
    path = tmp_path / "scan.jsonl"
    path.write_text(
        json.dumps({"artifact": "s", "device_fallback": "cpu"}) + "\n"
        + json.dumps({"cell": "b256", "rate": 1.0}) + "\n"
        + '{"cell": "b512", "ra')
    j = CellJournal(str(path), {"artifact": "s",
                                "device_fallback": "cpu"}, resume=True)
    assert j.resumed_cells == 1
    assert j.complete("b256") is not None
    assert j.complete("b512") is None
    for ln in path.read_text().splitlines():
        json.loads(ln)
