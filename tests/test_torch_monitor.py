"""The port's streaming monitor against the JAX package's (twins of the
in-process cases of ``tests/test_monitor.py``).

Each history is streamed into a reference ``MonitorSession`` and a port
one, a decide after every row: verdicts after every decide, final
verdicts and counters must be the reference's.  The port's session takes
two window re-checks here: ``device="cpu"`` (the reference's host loop)
and ``engine=`` a ``TorchStepper`` factory on the CPU (every touched
window decided as one batch of lanes through ``init_states``, on the
kernels' plain versions).  Without ``device="cpu"`` or an engine the
session runs on the card, and here raises ``BackendUnavailable``."""

from __future__ import annotations

import functools
import json

import pytest
import torch

from qsm_tpu.core.history import sequential_history as j_sequential
from qsm_tpu.core.spec import projection_report as j_projection_report
from qsm_tpu.models.registry import MODELS as JMODELS
from qsm_tpu.monitor import MonitorSession as JSession
from qsm_tpu.serve import VerdictCache as JVerdictCache
from qsm_tpu.serve.protocol import history_to_rows as j_history_to_rows
from qsm_tpu.utils.corpus import build_corpus as j_build_corpus
from qsm_tpu_torch.core.spec import projection_report
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.monitor import (IncrementalFrontier, MonitorSession,
                                   PrefixHasher, SessionError, SessionLimit,
                                   SessionManager, decode_frontier_states,
                                   encode_frontier_states)
from qsm_tpu_torch.monitor.frontier import WindowEngines
from qsm_tpu_torch.ops.backend import BackendUnavailable, Verdict
from qsm_tpu_torch.ops.stepper import BATCH_BUCKETS, TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.serve.cache import VerdictCache
from qsm_tpu_torch.utils.report import history_from_rows

FAMILIES = ("register", "cas", "queue", "kv")
CPU = {"device": "cpu"}
# the batched window re-check on the CPU: TorchStepper's plain versions,
# with a small memo and short chunks (verdicts depend on neither; the
# plain version's cost grows with both)
CPU_STEPPER = functools.partial(
    TorchStepper, device="cpu", chunk_schedule=(16, 64, 256),
    slots_for_batch={b: 256 for b in BATCH_BUCKETS})
ENGINES = {"host": CPU, "batched": {"engine": CPU_STEPPER}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on tiny tensors, where intra-op
    threads cost more than they give (several times over under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_corpus(family, n, pids, ops, prefix="mon"):
    """The reference's corpus (``tests/test_monitor.py::_corpus``), as
    rows."""
    entry = JMODELS[family]
    spec = entry.make_spec()
    hists = j_build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]), n=n,
        n_pids=pids, max_ops=ops, seed_prefix=f"{prefix}_{family}")
    return spec, [j_history_to_rows(h) for h in hists]


def _j_proj(spec):
    if j_projection_report(spec):
        return None
    p = spec.projected_spec()
    return p if p.name in JMODELS else None


def _proj(spec):
    if projection_report(spec):
        return None
    p = spec.projected_spec()
    return p if p.name in MODELS else None


def _seq_rows():
    h = j_sequential([(0, 1, 1, 0), (0, 0, 0, 1),
                      (1, 1, 2, 0), (1, 0, 0, 2)] * 10)
    return j_history_to_rows(h)


# --- frontier units --------------------------------------------------------

def test_prefix_hasher_is_incremental_and_spec_scoped():
    from qsm_tpu.monitor import PrefixHasher as JHasher

    spec = MODELS["register"].make_spec()
    a, b = PrefixHasher(spec), PrefixHasher(spec)
    j = JHasher(JMODELS["register"].make_spec())
    h = history_from_rows([[0, 1, 1, 0, 0, 1], [0, 0, 0, 1, 2, 3]])
    for op in h.ops:
        a.push(op)
    mid_keys = []
    for op in h.ops:
        b.push(op)
        j.push(op)
        mid_keys.append(b.key())
        assert b.key() == j.key()        # the reference's prefix keys
    assert a.key() == mid_keys[-1]
    assert len(set(mid_keys)) == len(mid_keys)
    c = PrefixHasher(MODELS["cas"].make_spec())
    for op in h.ops:
        c.push(op)
    assert c.key() != a.key()


def test_frontier_states_round_trip_through_witness_slot():
    from qsm_tpu.monitor import encode_frontier_states as j_encode

    states = {(0, 3), (1, 2), (2, 0)}
    enc = encode_frontier_states(states)
    assert enc == j_encode(states)
    assert decode_frontier_states(enc) == states
    assert decode_frontier_states([tuple(r) for r in enc]) == states
    assert decode_frontier_states([(0, 1), (1, 0)]) is None
    assert decode_frontier_states(None) is None


def test_frontier_commits_cuts_and_evicts_window():
    from qsm_tpu.monitor import IncrementalFrontier as JFrontier

    snaps = []
    for frontier, spec in (
            (IncrementalFrontier, MODELS["register"].make_spec()),
            (JFrontier, JMODELS["register"].make_spec())):
        f = frontier(spec)
        f.invoke(0, 1, 1, 0)
        f.respond(0, 0, 1)
        f.invoke(0, 1, 2, 2)
        f.respond(0, 0, 3)
        f.invoke(1, 0, 0, 4)
        assert f.advance() == int(Verdict.LINEARIZABLE)
        assert f.counters.advances >= 1 and f.counters.committed_ops >= 1
        assert len(f.window) < 3
        assert f.check_window() == int(Verdict.LINEARIZABLE)
        snaps.append(f.snapshot())
    assert snaps[0] == snaps[1]


def test_frontier_empty_fold_is_exact_violation():
    f = IncrementalFrontier(MODELS["register"].make_spec())
    f.invoke(0, 1, 1, 0)
    f.respond(0, 0, 1)
    f.invoke(0, 0, 0, 2)
    f.respond(0, 2, 3)
    f.invoke(0, 1, 1, 10)
    assert f.advance() == int(Verdict.VIOLATION)


# --- streaming parity ------------------------------------------------------

_PARITY_SHAPE = {"register": (16, 4, 12), "cas": (24, 4, 14),
                 "queue": (8, 3, 10), "kv": (32, 6, 16)}


@pytest.mark.parametrize("window", sorted(ENGINES))
@pytest.mark.parametrize("family", FAMILIES)
def test_streamed_verdicts_equal_whole_history_check(family, window):
    """THE parity pin: a decide after every row, in both packages; the
    port's verdict after every decide and its counters equal the
    reference session's, and the final verdicts equal the memo oracle's
    whole-history verdicts (a violation among them)."""
    n, pids, ops = _PARITY_SHAPE[family]
    jspec, corpus = _ref_corpus(family, n, pids, ops)
    spec = MODELS[family].make_spec()
    hists = [history_from_rows(rows) for rows in corpus]
    want = [int(v) for v in WingGongCPU(memo=True).check_histories(
        spec, hists)]
    jproj, proj = _j_proj(jspec), _proj(spec)
    assert (proj is not None) == (family == "kv") == (jproj is not None)
    engines = (WindowEngines(CPU_STEPPER) if window == "batched"
               else None)
    wrong = 0
    for k, rows in enumerate(corpus):
        ref = JSession(f"p{k}", jspec, proj_spec=jproj)
        s = MonitorSession(f"p{k}", spec, proj_spec=proj, engines=engines,
                           **ENGINES[window])
        for row in rows:
            ref.append([row])
            s.append([row])
            assert s.decide() == ref.decide()
        v = s.close()
        assert v == ref.close()
        assert s.counters() == ref.counters()
        wrong += v != want[k]
    assert wrong == 0
    assert any(v == int(Verdict.VIOLATION) for v in want)
    if engines is not None:
        st = engines.stats()
        assert st["calls"] > 0 and st["lanes"] >= st["calls"]


def test_session_runs_on_the_card_unless_device_cpu():
    spec = MODELS["register"].make_spec()
    with pytest.raises(BackendUnavailable):
        MonitorSession("c", spec)
    with pytest.raises(BackendUnavailable):
        SessionManager()
    assert MonitorSession("c", spec, device="cpu").engines is None


def test_one_decide_makes_one_engine_call_per_spec():
    """The batching pin: a kv session whose one decide touches several
    keys re-checks all their windows in ONE engine call (a lane per
    window and frontier state), with the reference's counters; a
    manager shares one engine a spec between its sessions."""
    calls = []

    class Counting(TorchStepper):
        def check_histories(self, spec, histories, init_states=None):
            calls.append(len(histories))
            return super().check_histories(spec, histories,
                                           init_states=init_states)

    factory = functools.partial(Counting, device="cpu")
    jspec = JMODELS["kv"].make_spec()
    spec = MODELS["kv"].make_spec()
    nv = spec.n_values
    events = []
    for key in (0, 1, 2):
        events += [{"type": "invoke", "pid": key, "cmd": 1,
                    "arg": key * nv + 1},
                   {"type": "respond", "pid": key, "resp": 0}]
    events += [{"type": "invoke", "pid": 5, "cmd": 0, "arg": 1},
               {"type": "invoke", "pid": 6, "cmd": 0, "arg": 2}]
    mgr = SessionManager(engine=factory)
    s, _ = mgr.open("k", spec, _proj(spec))
    ref = JSession("k", jspec, proj_spec=_j_proj(jspec))
    s.append(events)
    ref.append(events)
    assert s.decide() == ref.decide()
    assert len(calls) == 1                  # three keys, one spec, one call
    assert calls[0] == 3
    assert s.counters() == ref.counters()
    assert s.counters()["window_checks"] == 3
    s2, _ = mgr.open("k2", spec, _proj(spec))
    s2.append(events[:2])
    s2.decide()
    assert len(calls) == 2
    assert s2.engines is s.engines and s.window_stats()["engines"] == 1


def test_an_engine_error_raises_out_of_decide():
    """No fallback: an error of the window engine (a lost card) raises
    out of ``decide()``; nothing carries on on the host."""

    class Lost:
        def __init__(self, spec):
            self.spec = spec

        def check_histories(self, spec, histories, init_states=None):
            raise BackendUnavailable("the card is gone")

    s = MonitorSession("x", MODELS["register"].make_spec(), engine=Lost)
    s.append([[0, 1, 1, 0, 0, 1]])
    with pytest.raises(BackendUnavailable):
        s.decide()


def test_window_over_the_engines_op_cap_is_checked_on_the_host():
    """A window longer than the engine covers goes to the host loop, with
    the same verdict and counters."""
    spec = MODELS["register"].make_spec()
    jspec = JMODELS["register"].make_spec()
    # overlapping writes: no quiescent cut, the window keeps growing
    rows = [[p, 1, 1, 0, p, 100] for p in range(6)]
    engines = WindowEngines(CPU_STEPPER, max_ops=4)
    s = MonitorSession("w", spec, engines=engines)
    ref = JSession("w", jspec)
    for r in rows:
        s.append([r])
        ref.append([r])
        assert s.decide() == ref.decide()
    assert s.close() == ref.close()
    assert s.counters() == ref.counters()
    st = engines.stats()
    assert st["host_windows"] > 0 and st["calls"] > 0


# --- incrementality --------------------------------------------------------

@pytest.mark.parametrize("window", sorted(ENGINES))
def test_resume_replays_from_bank_with_zero_engine_folds(monkeypatch,
                                                         window):
    """Re-feeding a stream into a fresh session that shares the bank
    commits every cut as a bank hit: the port's fold is made
    unreachable, and the counters equal the reference's."""
    import qsm_tpu_torch.monitor.frontier as frontier_mod

    rows = _seq_rows()
    spec = MODELS["register"].make_spec()
    jspec = JMODELS["register"].make_spec()
    bank, jbank = VerdictCache(max_entries=4096), JVerdictCache(
        max_entries=4096)
    s1 = MonitorSession("a", spec, bank=bank, **ENGINES[window])
    j1 = JSession("a", jspec, bank=jbank)
    for r in rows:
        s1.append([r])
        j1.append([r])
        assert s1.decide() == j1.decide()
    assert s1.close() == j1.close() == int(Verdict.LINEARIZABLE)
    c1 = s1.counters()
    assert c1 == j1.counters()
    assert c1["advances"] > 10 and c1["prefix_hits"] == 0

    def _boom(*_a, **_k):
        raise AssertionError("engine fold reached on a banked resume")

    monkeypatch.setattr(frontier_mod, "_end_states", _boom)
    s2 = MonitorSession("b", spec, bank=bank, **ENGINES[window])
    for r in rows:
        s2.append([r])
        s2.decide()
    assert s2.close() == int(Verdict.LINEARIZABLE)
    c2 = s2.counters()
    assert c2["advances"] == c1["advances"]
    assert c2["prefix_hits"] == c2["advances"]


def test_one_key_event_rechecks_one_keys_frontier():
    spec = MODELS["kv"].make_spec()
    proj = _proj(spec)
    assert proj is not None
    nv = spec.n_values
    s = MonitorSession("k", spec, proj_spec=proj, device="cpu")
    for key in (0, 1, 2):
        s.append([{"type": "invoke", "pid": 0, "cmd": 1,
                   "arg": key * nv + 1},
                  {"type": "respond", "pid": 0, "resp": 0}])
        s.decide()
    before = {k: f.counters.window_checks
              for k, f in s._frontiers.items()}
    s.append([{"type": "invoke", "pid": 1, "cmd": 0, "arg": 0},
              {"type": "respond", "pid": 1, "resp": 1}])
    s.decide()
    after = {k: f.counters.window_checks
             for k, f in s._frontiers.items()}
    assert after[0] == before[0] + 1
    for k in (1, 2):
        assert after[k] == before[k]


# --- bounds / refusals -----------------------------------------------------

def test_event_cap_sheds_and_session_cap_sheds():
    mgr = SessionManager(max_sessions=1, max_events=4, device="cpu")
    spec = MODELS["register"].make_spec()
    s, resumed = mgr.open(None, spec, None)
    assert not resumed
    with pytest.raises(SessionLimit):
        mgr.open(None, spec, None)
    s.append([[0, 1, 1, 0, 2 * i, 2 * i + 1] for i in range(4)])
    with pytest.raises(SessionLimit):
        s.append([[0, 1, 1, 0, 10, 11]])


def test_seq_replay_is_idempotent_and_gaps_refuse():
    spec = MODELS["register"].make_spec()
    s = MonitorSession("r", spec, **CPU)
    rows = [[0, 1, 1, 0, 0, 1], [0, 0, 0, 1, 2, 3]]
    assert s.append(rows, seq=0) == 2
    assert s.append(rows, seq=0) == 0
    assert s.append([rows[1], [1, 1, 2, 0, 4, 5]], seq=1) == 1
    with pytest.raises(SessionError, match="gap"):
        s.append([[1, 0, 0, 2, 6, 7]], seq=99)


def test_backwards_time_and_mispaired_events_refuse():
    spec = MODELS["register"].make_spec()
    s = MonitorSession("t", spec, **CPU)
    s.append([{"type": "invoke", "pid": 0, "cmd": 1, "arg": 1,
               "t": 10}])
    with pytest.raises(SessionError, match="runs backwards"):
        s.append([{"type": "respond", "pid": 0, "resp": 0, "t": 5}])
    s2 = MonitorSession("t2", spec, **CPU)
    with pytest.raises(SessionError, match="no outstanding"):
        s2.append([{"type": "respond", "pid": 3, "resp": 0}])
    s3 = MonitorSession("t3", spec, **CPU)
    s3.append([[0, 1, 1, 0, 5, 9]])
    with pytest.raises(SessionError, match="behind the stream"):
        s3.append([[1, 1, 1, 0, 2, 3]])


@pytest.mark.parametrize("window", sorted(ENGINES))
def test_row_responses_wait_for_the_invoke_horizon(window):
    spec = MODELS["register"].make_spec()
    s = MonitorSession("h", spec, **ENGINES[window])
    s.append([[0, 0, 0, 1, 0, 10]])
    assert s.decide() != int(Verdict.VIOLATION)
    s.append([[1, 1, 1, 0, 2, 3]])
    s.decide()
    assert s.close() == int(Verdict.LINEARIZABLE)


def test_idle_sessions_are_evicted_at_the_cap():
    mgr = SessionManager(max_sessions=1, idle_s=0.0, device="cpu")
    spec = MODELS["register"].make_spec()
    s, _ = mgr.open("dead", spec, None)
    s.append([[0, 1, 1, 0, 0, 1]])
    s2, resumed = mgr.open("fresh", spec, None)
    assert not resumed and s2.sid == "fresh"
    assert mgr.get("dead") is None
    t = mgr.totals()
    assert t["evicted"] == 1 and t["session_events"] == 1


# --- manager accounting ----------------------------------------------------

def test_manager_totals_and_search_stats_agree():
    from qsm_tpu.monitor import SessionManager as JManager

    res = []
    for mgr, spec in ((SessionManager(device="cpu"),
                       MODELS["register"].make_spec()),
                      (JManager(), JMODELS["register"].make_spec())):
        s, _ = mgr.open("x", spec, None)
        s.append([[0, 1, 1, 0, 0, 1], [0, 0, 0, 1, 2, 3]])
        s.decide()
        t = mgr.totals()
        st = mgr.search_stats()
        assert st.session_events == t["session_events"] == 2
        assert st.frontier_advances == t["frontier_advances"]
        assert st.prefix_hits == t["prefix_hits"]
        assert st.flips_pushed == t["flips_pushed"] == 0
        mgr.close("x")
        assert mgr.totals()["session_events"] == 2
        c = st.to_compact()
        assert c["sev"] == 2 and "fad" in c and "pfh" in c and "flp" in c
        res.append((t, c, mgr.snapshot()))
    assert res[0] == res[1]


# --- durable sessions -------------------------------------------------------

@pytest.mark.parametrize("window", sorted(ENGINES))
def test_session_doc_round_trip_resumes_identically(window):
    """to_doc / from_doc mid-stream (per key, pending ops, the reorder
    buffer in play): the rebuilt session decides the rest as the
    uninterrupted one does, and its doc is the reference's."""
    jspec, corpus = _ref_corpus("kv", n=4, pids=4, ops=14, prefix="dur")
    spec = MODELS["kv"].make_spec()
    proj, jproj = _proj(spec), _j_proj(jspec)
    assert proj is not None
    for k, rows in enumerate(corpus):
        half = max(1, len(rows) // 2)
        live = MonitorSession(f"l{k}", spec, proj_spec=proj,
                              **ENGINES[window])
        cutover = MonitorSession(f"l{k}", spec, proj_spec=proj,
                                 **ENGINES[window])
        ref = JSession(f"l{k}", jspec, proj_spec=jproj)
        for r in rows[:half]:
            for s in (live, cutover, ref):
                s.append([r])
                s.decide()
        doc = json.loads(json.dumps(cutover.to_doc()))
        assert doc == json.loads(json.dumps(ref.to_doc()))
        rebuilt = MonitorSession.from_doc(doc, spec, proj_spec=proj,
                                          **ENGINES[window])
        assert rebuilt.seq == cutover.seq and rebuilt.rows == cutover.rows
        for r in rows[half:]:
            live.append([r])
            rebuilt.append([r])
        assert rebuilt.close() == live.close()
        assert rebuilt.counters()["ops"] == live.counters()["ops"]


def test_evicted_session_resumes_durably_zero_folds(tmp_path, monkeypatch):
    import qsm_tpu_torch.monitor.frontier as frontier_mod
    from qsm_tpu_torch.monitor import SessionStore

    spec = MODELS["register"].make_spec()
    rows = _seq_rows()
    bank = VerdictCache(max_entries=4096)
    store = SessionStore(str(tmp_path / "sessions"))
    mgr = SessionManager(bank=bank, max_sessions=1, idle_s=0.0,
                         store=store, device="cpu")
    s, resumed = mgr.open("dur", spec, None)
    assert not resumed
    for r in rows:
        s.append([r])
        s.decide()
    folds_banked = s.counters()["advances"]
    assert folds_banked > 10 and s.counters()["prefix_hits"] == 0
    mgr.open("other", spec, None)
    assert mgr.get("dur") is None
    assert mgr.totals()["evicted"] == 1

    def _boom(*_a, **_k):
        raise AssertionError("engine fold reached on a durable resume")

    monkeypatch.setattr(frontier_mod, "_end_states", _boom)
    s2, resumed = mgr.open("dur", spec, None)
    assert resumed and s2 is not s
    assert mgr.totals()["restored"] == 1
    assert s2.seq == len(rows)
    assert s2.append([list(r) for r in rows], seq=0) == 0
    assert s2.close() == int(Verdict.LINEARIZABLE)
    c = s2.counters()
    assert c["advances"] == c["prefix_hits"] == folds_banked


# --- the monitor subcommand ---------------------------------------------------

def test_monitor_cli_flips_and_saves_a_minimal_repro(tmp_path, capsys):
    """``monitor`` on a Jepsen log with a stale read: the flip line's
    repro is a violation whose certificate verifies, ``--save`` writes a
    trace ``check`` convicts, exit 1; the final line is the reference's.
    Without ``--device cpu`` it runs on the card (here: refused)."""
    from qsm_tpu.utils.cli import main as jmain
    from qsm_tpu_torch.shrink import verify_certificate
    from qsm_tpu_torch.utils.cli import main

    log = tmp_path / "run.edn"
    log.write_text(
        "{:process 0, :type :invoke, :f :write, :value 1}\n"
        "{:process 0, :type :ok, :f :write, :value 1}\n"
        "{:process 1, :type :invoke, :f :read, :value nil}\n"
        "{:process 1, :type :ok, :f :read, :value 2}\n"
        "{:process 0, :type :invoke, :f :write, :value 2}\n"
        "{:process 0, :type :ok, :f :write, :value 2}\n")
    save = tmp_path / "repro.json"
    argv = ["monitor", str(log), "--format", "jepsen", "--spec",
            "register"]
    rc = main(argv + ["--save", str(save), "--device", "cpu"])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert rc == 1
    flip, final = lines[0], lines[-1]
    assert flip["event"] == "session.flip" and flip["one_minimal"]
    spec = MODELS["register"].make_spec()
    repro = history_from_rows(flip["repro"])
    assert int(WingGongCPU(memo=True).check_histories(spec, [repro])[0]) \
        == int(Verdict.VIOLATION)
    assert verify_certificate(spec, repro, flip["certificate"])
    assert main(["check", "--trace", str(save), "--device", "cpu"]) == 1
    capsys.readouterr()
    assert jmain(argv) == 1
    jlines = [json.loads(x) for x in
              capsys.readouterr().out.strip().splitlines()]
    assert jlines[-1] == final
    assert jlines[0]["repro"] == flip["repro"]
    with pytest.raises(BackendUnavailable):
        main(argv)
    # --addr goes to a server (the served twins are below); none
    # listens here
    with pytest.raises(ConnectionError):
        main(argv + ["--addr", "127.0.0.1:1"])


# --- served sessions (twins of tests/test_monitor.py:163, :260, :301,
# :323's served half and :634), on CheckServer(device="cpu") beside the
# reference's CheckServer() -------------------------------------------------

def _servers(**kw):
    from qsm_tpu.serve import CheckServer as JServer
    from qsm_tpu_torch.serve import CheckServer

    kw.setdefault("flush_s", 0.005)
    kw.setdefault("max_lanes", 16)
    return JServer(**kw).start(), CheckServer(device="cpu", **kw).start()


def _served_witnesses(client, handle_cls, model, rows_list):
    out = []
    oneshot = client.check(model, rows_list, witness=True)
    assert oneshot["ok"]
    for rows, want_v, want_w in zip(rows_list, oneshot["verdicts"],
                                    oneshot["witnesses"]):
        handle = handle_cls(client, model)
        for row in rows:
            handle.append([row])
        fin = handle.close(witness=True)
        assert fin["ok"] and fin["verdict"] == want_v
        assert fin.get("witness") == want_w
        out.append((fin["verdict"], fin.get("witness")))
    return out


def test_served_session_witness_bit_identical_to_check():
    from qsm_tpu.ops.backend import verify_witness as j_verify
    from qsm_tpu.serve import CheckClient as JClient
    from qsm_tpu.serve import SessionHandle as JHandle
    from qsm_tpu_torch.serve import CheckClient, SessionHandle

    jspec, rows_list = _ref_corpus("cas", 6, 3, 10)
    jsrv, psrv = _servers()
    try:
        with JClient(jsrv.address) as jc:
            ref = _served_witnesses(jc, JHandle, "cas", rows_list)
        with CheckClient(psrv.address) as pc:
            got = _served_witnesses(pc, SessionHandle, "cas", rows_list)
    finally:
        jsrv.stop()
        psrv.stop()
    assert got == ref
    from qsm_tpu.utils.report import history_from_rows as j_from_rows

    for rows, (v, w) in zip(rows_list, got):
        if w is not None:
            assert j_verify(jspec, j_from_rows(rows),
                            [tuple(p) for p in w])


_FLIP_EVENTS = [[{"type": "invoke", "pid": 0, "cmd": 1, "arg": 1},
                 {"type": "respond", "pid": 0, "resp": 0}]] * 5 + [
    [{"type": "invoke", "pid": 1, "cmd": 0, "arg": 0},
     {"type": "respond", "pid": 1, "resp": 2}]]


def _flip_through(client, handle_cls):
    handle = handle_cls(client, "register")
    outs = [handle.append(ev) for ev in _FLIP_EVENTS]
    assert [o["verdict"] for o in outs[:-1]] == ["LINEARIZABLE"] * 5
    out = outs[-1]
    assert out["verdict"] == "VIOLATION"
    flip = out["flip"]
    assert flip["one_minimal"] and flip["complete"]
    out2 = handle.append(_FLIP_EVENTS[0])
    assert out2["verdict"] == "VIOLATION"
    assert "flip" not in out2 and out2.get("flipped")
    fin = handle.close()
    assert fin["verdict"] == "VIOLATION" and fin["flipped"]
    assert len(handle.flips) == 1
    assert client.stats()["stats"]["session"]["flips_pushed"] == 1
    return flip


def test_flip_is_pushed_with_minimal_repro_and_certificate():
    from qsm_tpu.serve import CheckClient as JClient
    from qsm_tpu.serve import SessionHandle as JHandle
    from qsm_tpu_torch.ops.backend import verify_witness
    from qsm_tpu_torch.serve import CheckClient, SessionHandle

    jsrv, psrv = _servers()
    try:
        with JClient(jsrv.address) as jc:
            ref = _flip_through(jc, JHandle)
        with CheckClient(psrv.address) as pc:
            got = _flip_through(pc, SessionHandle)
    finally:
        jsrv.stop()
        psrv.stop()
    assert got == ref       # repro, certificate and counters alike
    spec = MODELS["register"].make_spec()
    repro = history_from_rows(got["repro"])
    assert int(WingGongCPU(memo=True).check_histories(
        spec, [repro])[0]) == int(Verdict.VIOLATION)
    for entry in got["certificate"]:
        keep = [i for i in range(len(repro)) if i != entry["drop"]]
        assert verify_witness(spec, repro.subhistory(keep),
                              [tuple(p) for p in entry["witness"]])


def test_flip_dump_fires_on_session_flip(tmp_path):
    from qsm_tpu_torch.serve import CheckClient, CheckServer, SessionHandle

    srv = CheckServer(flush_s=0.005, device="cpu",
                      trace_log=str(tmp_path / "trace.jsonl"),
                      flight_dir=str(tmp_path / "flight")).start()
    try:
        client = CheckClient(srv.address)
        handle = SessionHandle(client, "register")
        handle.append(_FLIP_EVENTS[-1])
        assert handle.flips
        dumps = [f for f in (tmp_path / "flight").iterdir()
                 if "session_flip" in f.name]
        assert dumps, "no session_flip flight dump"
        assert handle.trace in dumps[0].read_text()
        client.close()
    finally:
        srv.stop()


def test_session_cap_sheds_over_the_wire():
    from qsm_tpu_torch.serve import CheckClient, CheckServer

    srv = CheckServer(flush_s=0.005, max_sessions=1, device="cpu").start()
    try:
        client = CheckClient(srv.address)
        a = client.session_open("register")
        assert a["ok"]
        b = client.session_open("register")
        assert b.get("shed") and "session cap" in b["reason"]
        client.close()
    finally:
        srv.stop()


def test_server_restart_resumes_durable_sessions(tmp_path):
    from qsm_tpu_torch.core.history import sequential_history
    from qsm_tpu_torch.serve import CheckClient, CheckServer
    from qsm_tpu_torch.serve.protocol import history_to_rows

    sdir = str(tmp_path / "sessions")
    h = sequential_history([(0, 1, 1, 0), (0, 0, 0, 1),
                            (1, 1, 2, 0), (1, 0, 0, 2)] * 6)
    rows = history_to_rows(h)
    half = len(rows) // 2
    srv = CheckServer(flush_s=0.005, session_dir=sdir, device="cpu").start()
    client = CheckClient(srv.address)
    try:
        opened = client.session_open("register", session="boot")
        assert opened["ok"] and not opened["resumed"]
        for r in rows[:half]:
            assert client.session_append("boot", [r])["ok"]
    finally:
        client.close()
        srv.stop()
    srv2 = CheckServer(flush_s=0.005, session_dir=sdir,
                       device="cpu").start()
    client2 = CheckClient(srv2.address)
    try:
        opened = client2.session_open("register", session="boot")
        assert opened["ok"] and opened["resumed"], opened
        assert opened["seq"] == half
        for i, r in enumerate(rows[half:]):
            out = client2.session_append("boot", [r], seq=half + i)
            assert out["ok"], out
        fin = client2.session_close("boot")
        assert fin["ok"] and fin["verdict"] == "LINEARIZABLE"
        assert fin["ops"] == len(rows)
    finally:
        client2.close()
        srv2.stop()


def test_monitor_addr_cli_equals_the_in_process_monitor(capsys):
    """``monitor --addr``: the session served by a running server prints
    the in-process monitor's flip (repro and certificate) and verdict."""
    from qsm_tpu_torch.serve import CheckServer
    from qsm_tpu_torch.utils.cli import main

    golden = "tests/data/golden_jepsen_register.edn"
    argv = ["monitor", golden, "--format", "jepsen", "--spec", "register"]
    rc_local = main(argv + ["--device", "cpu"])
    local = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    srv = CheckServer(flush_s=0.005, device="cpu").start()
    try:
        rc = main(argv + ["--addr", srv.address])
    finally:
        srv.stop()
    served = [json.loads(x) for x in
              capsys.readouterr().out.strip().splitlines()]
    assert rc == rc_local
    assert served[-1]["verdict"] == local[-1]["verdict"]
    flips = [d for d in served if d.get("event") == "session.flip"]
    lflips = [d for d in local if d.get("event") == "session.flip"]
    assert len(flips) == len(lflips)
    for a, b in zip(flips, lflips):
        assert a["repro"] == b["repro"] and a["final_ops"] == b["final_ops"]
