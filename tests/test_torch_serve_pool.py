"""The port's worker-pool serving plane against the JAX package's (twins
of ``tests/test_serve_pool.py:72-350``).

``CheckServer(workers=N, device="cpu")``: pooled verdicts and witnesses
equal the JAX package's direct host verdicts on its own copy of each
corpus; a worker SIGKILLed mid-batch, a hung worker and a crash-looping
spec never produce a wrong verdict or a hung client; the bank stays the
supervisor's; ``stop()`` reaps every worker.  Pool workers are host
processes and never touch CUDA.
"""

from __future__ import annotations

import io
import threading
import time

import pytest

from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.ops.backend import verify_witness
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.resilience.policy import preset
from qsm_tpu_torch.serve import (CheckClient, CheckServer, VERDICT_NAMES,
                           WorkerPool)
from qsm_tpu_torch.serve.frames import encode_frame, read_frame
from qsm_tpu_torch.utils.corpus import build_corpus
from qsm_tpu.models.registry import MODELS as J_MODELS
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JWingGongCPU
from qsm_tpu.utils.corpus import build_corpus as j_build_corpus

FAMILIES = ("register", "cas", "queue", "kv")


def _corpus(family, n=8, pids=3, ops=8, prefix="pool"):
    """The port's corpus and the JAX package's direct host verdicts on
    its own copy of it (same seeds, same histories)."""
    out = []
    for registry, corpus in ((MODELS, build_corpus),
                             (J_MODELS, j_build_corpus)):
        entry = registry[family]
        spec = entry.make_spec()
        out.append((spec, corpus(
            spec, (entry.impls["atomic"], entry.impls["racy"]), n=n,
            n_pids=pids, max_ops=ops, seed_prefix=f"{prefix}_{family}")))
    (spec, hists), (jspec, jh) = out
    assert [h.fingerprint() for h in hists] == \
        [h.fingerprint() for h in jh]
    _WANT[id(hists)] = _names(JWingGongCPU(memo=True).check_histories(
        jspec, jh))
    return spec, hists


_WANT = {}


def _direct(spec, hists):
    """The reference's direct verdicts for a corpus of :func:`_corpus`,
    which the port's own oracle must match."""
    want = _WANT[id(hists)]
    assert _names(WingGongCPU(memo=True).check_histories(spec, hists)) \
        == want
    return want


def _names(verdicts):
    return [VERDICT_NAMES[int(v)] for v in verdicts]


def _pooled(tmp_path, workers=2, **kw):
    kw.setdefault("flush_s", 0.005)
    kw.setdefault("max_lanes", 16)
    kw.setdefault("cache_path", str(tmp_path / "bank.jsonl"))
    return CheckServer(workers=workers, device="cpu", **kw).start()


def _worker_procs(srv):
    return [s.handle.proc for s in srv.pool._slots if s.handle is not None]


# --- parity: the pool changes where, never what ---------------------------

def test_pooled_verdicts_bit_identical_across_families(tmp_path):
    """The acceptance pin: across register/cas/queue/kv the pooled path
    answers exactly what the direct host checker answers, and every
    batch stamp names the worker that decided it."""
    srv = _pooled(tmp_path)
    try:
        with CheckClient(srv.address) as client:
            for family in FAMILIES:
                spec, hists = _corpus(family)
                direct = _direct(spec, hists)
                res = client.check(family, hists)
                assert res["ok"], res
                assert res["verdicts"] == direct, family
                assert "LINEARIZABLE" in res["verdicts"], family
                for b in res["batches"]:
                    assert b.get("worker") in (0, 1), b
        assert srv.pool.snapshot()["dispatches"] >= len(FAMILIES)
        assert srv.stats()["worker_faults"] == 0
    finally:
        srv.stop()


def test_pooled_witnesses_bit_identical(tmp_path):
    """Witness requests keep the one-search supervisor-oracle rule on a
    pooled server; witnesses equal the direct oracle's and replay
    search-free."""
    spec, hists = _corpus("cas", n=6)
    oracle = WingGongCPU(memo=True)
    srv = _pooled(tmp_path)
    try:
        with CheckClient(srv.address) as client:
            res = client.check("cas", hists, witness=True)
        assert res["ok"]
        for h, v, w in zip(hists, res["verdicts"], res["witnesses"]):
            dv, dw = oracle.check_witness(spec, h)
            assert v == VERDICT_NAMES[int(dv)]
            if v == "LINEARIZABLE":
                w = [tuple(p) for p in w]
                assert w == dw
                assert verify_witness(spec, h, w)
            else:
                assert w is None
    finally:
        srv.stop()


# --- worker loss: shed, re-dispatch, never wrong, never hung --------------

def test_sigkill_mid_batch_redispatches_to_healthy_worker(
        tmp_path, monkeypatch):
    """kill:worker@2 SIGKILLs a worker on its SECOND dispatch — mid
    batch, mid pipe protocol.  The supervisor sees the crash, sheds the
    worker, and the undecided lanes re-dispatch to the OTHER (healthy)
    worker: verdicts unchanged, one worker fault counted."""
    monkeypatch.setenv("QSM_TPU_FAULTS", "kill:worker@2")
    spec, hists = _corpus("cas", n=6)
    direct = _direct(spec, hists)
    spec2, hists2 = _corpus("cas", n=6, prefix="pool2")
    direct2 = _direct(spec2, hists2)
    srv = _pooled(tmp_path, workers=2, quarantine_after=3)
    try:
        with CheckClient(srv.address, timeout_s=60.0) as client:
            first = client.check("cas", hists)
            assert first["ok"] and first["verdicts"] == direct
            second = client.check("cas", hists2, deadline_s=30.0)
            assert second["ok"], second
            assert second["verdicts"] == direct2
        snap = srv.pool.snapshot()
        assert snap["worker_faults"] >= 1
        # the re-dispatched batch says it survived a worker loss
        wf = [b for b in second["batches"] if b.get("worker_faults")]
        assert wf and wf[0]["search"]["wf"] >= 1
        assert "cas" not in "".join(snap["quarantined_specs"])
    finally:
        srv.stop()


def test_hung_worker_is_shed_inside_watchdog_bound(tmp_path, monkeypatch):
    """hang:worker wedges the dispatch inside the worker; the
    `worker-dispatch` watchdog bound fires, the worker is SIGKILLed
    like a wedged chip, and the lanes resolve on the in-process ladder
    — bounded wall-clock, exact verdicts, no hung client."""
    monkeypatch.setenv("QSM_TPU_FAULTS", "hang:worker")
    monkeypatch.setenv("QSM_TPU_FAULT_HANG_S", "30")
    spec, hists = _corpus("register", n=4)
    direct = _direct(spec, hists)
    srv = _pooled(
        tmp_path, workers=1,
        worker_policy=preset("worker-dispatch").with_(timeout_s=0.5,
                                                      deadline_s=5.0))
    try:
        t0 = time.monotonic()
        with CheckClient(srv.address, timeout_s=60.0) as client:
            res = client.check("register", hists, deadline_s=20.0)
        assert res["ok"]
        assert res["verdicts"] == direct
        assert time.monotonic() - t0 < 10.0  # watchdogged, not slept out
        assert srv.pool.worker_faults >= 1
    finally:
        srv.stop()


def test_crash_loop_spec_is_quarantined_no_respawn_storm(
        tmp_path, monkeypatch):
    """kill:worker (every dispatch) grinds through quarantine_after
    workers exactly once, then the spec is quarantined to the
    in-process ladder: later requests never touch the pool, respawns
    stay bounded, verdicts stay exact."""
    monkeypatch.setenv("QSM_TPU_FAULTS", "kill:worker")
    spec, hists = _corpus("queue", n=5)
    direct = _direct(spec, hists)
    spec2, hists2 = _corpus("queue", n=5, prefix="pool2")
    direct2 = _direct(spec2, hists2)
    srv = _pooled(tmp_path, workers=2, quarantine_after=2)
    try:
        with CheckClient(srv.address, timeout_s=60.0) as client:
            res = client.check("queue", hists, deadline_s=30.0)
            assert res["ok"] and res["verdicts"] == direct
            snap = srv.pool.snapshot()
            assert snap["quarantines"] == 1
            assert snap["quarantined_specs"], snap
            # a fresh corpus for the same spec goes straight in-process
            res2 = client.check("queue", hists2, deadline_s=30.0)
            assert res2["ok"] and res2["verdicts"] == direct2
            assert any(b.get("pool") == "in-process"
                       for b in res2["batches"]), res2["batches"]
        snap = srv.pool.snapshot()
        assert snap["worker_faults"] == 2  # exactly the quarantine budget
        # bounded respawns, not a storm (backoff makes more impossible
        # inside this test's lifetime anyway — this pins the counter)
        assert snap["respawns"] <= 2
    finally:
        srv.stop()


# --- the bank stays supervisor-owned --------------------------------------

def test_pooled_restart_after_kill_serves_persistent_bank(tmp_path):
    """Kill a pooled server (no graceful flush beyond per-batch puts),
    tear a trailing line, restart WITH workers: every banked verdict
    serves cached and bit-identical — workers never touched the bank."""
    bank = str(tmp_path / "bank.jsonl")
    spec, hists = _corpus("cas", n=8)
    direct = _direct(spec, hists)

    srv = _pooled(tmp_path, workers=2, cache_path=bank)
    try:
        with CheckClient(srv.address) as client:
            res = client.check("cas", hists)
            assert res["ok"] and not any(res["cached"])
    finally:
        srv.stop()
    with open(bank, "a") as f:
        f.write('{"key": "torn-mid-wr')  # simulated torn tail

    srv2 = _pooled(tmp_path, workers=2, cache_path=bank)
    try:
        with CheckClient(srv2.address) as client:
            res2 = client.check("cas", hists)
        assert res2["ok"]
        assert all(res2["cached"]), res2["cached"]
        assert res2["verdicts"] == direct
    finally:
        srv2.stop()


# --- lifecycle: deterministic teardown, shed carries pool state -----------

def test_stop_reaps_every_worker_process(tmp_path):
    """stop() must terminate → bounded-join →
    kill-escalate so tier-1 runs never leak a worker process."""
    srv = _pooled(tmp_path, workers=2)
    procs = _worker_procs(srv)
    assert len(procs) == 2
    with CheckClient(srv.address) as client:
        spec, hists = _corpus("register", n=4)
        assert client.check("register", hists)["ok"]
    srv.stop()
    for proc in procs:
        assert proc.poll() is not None, "leaked worker process"


def test_shed_response_carries_pool_state(tmp_path):
    srv = _pooled(tmp_path, workers=2, queue_depth=2)
    try:
        with CheckClient(srv.address) as client:
            spec, hists = _corpus("register", n=5)
            res = client.check("register", hists)
        assert res["ok"] is False and res["shed"] is True
        assert res["reason"] == "queue full"
        assert res["pool"]["workers"] == 2
        assert res["pool"]["live"] in (0, 1, 2)
        assert "quarantined" in res["pool"]
    finally:
        srv.stop()


def test_workers_require_auto_engine():
    with pytest.raises(ValueError):
        CheckServer(workers=2, engine="planned", device="cpu")
    # the port's parallel rule: pool workers are host processes, so a
    # pool needs the CPU engine
    with pytest.raises(ValueError, match="device='cpu'"):
        CheckServer(workers=2)


# --- the CI pool smoke: 2 workers × 2 concurrent clients ------------------

def test_pool_smoke_two_workers_two_clients(tmp_path):
    """Two concurrent
    clients on distinct families against a 2-worker pool — both exact,
    and the stats op exposes per-worker rows."""
    srv = _pooled(tmp_path, workers=2)
    results = {}

    def drive(family):
        spec, hists = _corpus(family, n=6)
        direct = _direct(spec, hists)
        with CheckClient(srv.address) as client:
            res = client.check(family, hists)
        results[family] = (res, direct)

    try:
        threads = [threading.Thread(target=drive, args=(f,))
                   for f in ("register", "cas")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert set(results) == {"register", "cas"}
        for family, (res, direct_names) in results.items():
            assert res["ok"], family
            assert res["verdicts"] == direct_names, family
        st = srv.stats()
        assert st["workers"] == 2
        rows = st["pool"]["workers"]
        assert len(rows) == 2
        for row in rows:
            assert {"wid", "alive", "dispatches", "faults", "deaths",
                    "respawns"} <= set(row)
        assert sum(r["dispatches"] for r in rows) >= 1
        assert st["batcher"]["concurrency"] == 2
    finally:
        srv.stop()


# --- units: frames, preset, counters --------------------------------------

def test_frame_roundtrip_and_torn_frame():
    doc = {"op": "check", "seq": 7, "rows": [[0, 1, 2, 3, 4, 5]]}
    buf = io.BytesIO(encode_frame(doc))
    assert read_frame(buf) == doc
    # a torn frame (killed writer) reads as EOF, never as half a doc
    torn = encode_frame(doc)[:-3]
    assert read_frame(io.BytesIO(torn)) is None
    assert read_frame(io.BytesIO(b"")) is None


def test_worker_dispatch_preset_exists():
    p = preset("worker-dispatch")
    assert p.attempts >= 2          # at least one re-dispatch
    assert p.timeout_s and p.timeout_s > 0
    assert p.deadline_s and p.deadline_s >= p.timeout_s


def test_search_stats_worker_faults_counter():
    from qsm_tpu_torch.search.stats import SearchStats, stats_delta

    a = SearchStats(histories=4, worker_faults=3)
    b = SearchStats(histories=1, worker_faults=1)
    assert a.to_compact()["wf"] == 3
    assert stats_delta(a, b).worker_faults == 2
    merged = SearchStats().absorb(a)
    assert merged.worker_faults == 3
    assert a.to_timings()["resilience_worker_faults"] == 3.0


def test_pool_rejects_zero_workers():
    with pytest.raises(ValueError):
        WorkerPool(0)


def test_quarantine_is_keyed_per_spec(tmp_path, monkeypatch):
    """Quarantining the killer spec must not take healthy specs with
    it: after a cas crash-loop, register still rides the pool."""
    monkeypatch.setenv("QSM_TPU_FAULTS", "kill:worker")
    srv = _pooled(tmp_path, workers=2, quarantine_after=1)
    try:
        with CheckClient(srv.address, timeout_s=60.0) as client:
            spec, hists = _corpus("cas", n=4)
            direct = _direct(spec, hists)
            res = client.check("cas", hists, deadline_s=30.0)
            assert res["ok"] and res["verdicts"] == direct
            quarantined = srv.pool.snapshot()["quarantined_specs"]
            assert any("cas" in q for q in quarantined)
            assert not any("register" in q for q in quarantined)
    finally:
        srv.stop()
