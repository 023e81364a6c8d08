"""The port's device-work queue and drain against the JAX package's
(twins of ``tests/test_devq.py:97-339``).

The queue's items, fingerprints and row shapes are the reference's (the
last cases hold them byte for byte); the drain runs the port's planned
checker on one torch device (the CPU here, the card by default) and banks
only fresh-host-oracle verdicts.  The seams (shrink rounds, monitor
flips, the planner, serve admission) bank through the process-global
queue and cost nothing without one.
"""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu_torch.serve import CheckClient, CheckServer

from qsm_tpu_torch.devq.drain import DrainScheduler
from qsm_tpu_torch.devq.queue import (DeviceWorkQueue, WorkItem,
                                bank_histories, global_devq,
                                note_device_plan, set_global_devq)
from qsm_tpu_torch.models.registry import MODELS, make
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.serve.cache import VerdictCache, fingerprint_key
from qsm_tpu_torch.utils.corpus import build_corpus

# small everywhere: the queue moves checking to a window, it does not
# need big corpora to prove that
PLANE_FAMILIES = (("check", "register"), ("pcomp", "kv"),
                  ("shrink", "cas"), ("monitor", "queue"))


def _corpus(family, n=4, prefix="devq"):
    entry = MODELS[family]
    spec = entry.make_spec()
    hists = build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]), n=n,
        n_pids=entry.default_pids, max_ops=entry.default_ops,
        seed_prefix=f"{prefix}_{family}")
    return spec, hists


def _failing_histories(model, n=1, scan=60, prefix="devq_fail"):
    """Seeded VIOLATION histories from the registry's racy impl (the
    tests/test_shrink.py scan idiom)."""
    from qsm_tpu_torch.core.generator import generate_program
    from qsm_tpu_torch.sched.runner import run_concurrent

    entry = MODELS[model]
    spec, _ = make(model, "racy")
    oracle = WingGongCPU(memo=True)
    out = []
    for seed in range(scan):
        if len(out) >= n:
            break
        prog = generate_program(spec, seed=seed,
                                n_pids=entry.default_pids,
                                max_ops=entry.default_ops)
        h = run_concurrent(entry.impls["racy"](spec), prog,
                           seed=f"{prefix}:{model}:{seed}").completed()
        if int(oracle.check_histories(spec, [h])[0]) \
                == int(Verdict.VIOLATION):
            out.append(h)
    assert out, f"no failing {model} history in {scan} seeds"
    return spec, out


@pytest.fixture(autouse=True)
def _no_global_queue():
    # the seams read the process-global hook: never leak one across
    # tests (or into the rest of the suite)
    set_global_devq(None)
    yield
    set_global_devq(None)


# --- queue semantics ------------------------------------------------------

def test_bank_dedupe_tombstone_and_persistence(tmp_path):
    spec, hists = _corpus("register")
    q = DeviceWorkQueue(str(tmp_path / "q"))
    key = bank_histories(spec, hists, plane="check", queue=q)
    assert key is not None and len(q) == 1
    # idempotent: the same corpus banks under the same fingerprint
    assert bank_histories(spec, hists, plane="check", queue=q) == key
    assert len(q) == 1 and q.banked == 1
    item = q.get(key)
    assert item.plane == "check" and item.model == "register"
    assert item.lane_keys == [fingerprint_key(spec, h) for h in hists]
    # done is absorbing: a re-delivered put after the tombstone no-ops
    assert q.mark_done(key)
    assert len(q) == 0
    assert not q.put(item)
    # the replog replays both row shapes into a fresh instance
    q2 = DeviceWorkQueue(str(tmp_path / "q"))
    assert len(q2) == 0 and not q2.put(item)
    assert q2.snapshot()["done"] >= 1


def test_cap_evicts_lowest_score_only_over_cap():
    q = DeviceWorkQueue(cap=2, now=lambda: 1000.0)
    for i, bucket in enumerate((8, 2, 16)):
        q.put(WorkItem(key=f"k{i}", plane="check", model="register",
                       bucket=bucket, enq_ts=1000.0))
    assert len(q) == 2 and q.evicted == 1
    assert q.get("k1") is None          # smallest bucket went first
    assert [it.key for it in q.pending_items()] == ["k2", "k0"]


def test_drain_order_feeds_plane_starvation():
    q = DeviceWorkQueue(now=lambda: 1000.0)
    q.put(WorkItem(key="a", plane="check", model="register",
                   bucket=4, enq_ts=1000.0))
    q.put(WorkItem(key="b", plane="shrink", model="cas",
                   bucket=4, enq_ts=1000.0))
    # equal scores tie-break on key; draining `check` starves it below
    # the untouched shrink plane on the next ranking
    assert q.pending_items()[0].key == "a"
    q.note_drained("check")
    assert q.pending_items()[0].key == "b"


def test_four_planes_and_warmup_bank_into_one_queue():
    q = DeviceWorkQueue()
    for plane, fam in PLANE_FAMILIES:
        spec, hists = _corpus(fam, n=2)
        bank_histories(spec, hists, plane=plane, queue=q)
    from qsm_tpu_torch.search.planner import plan_search, profile_corpus

    spec, hists = _corpus("kv", n=2)
    # a device plan banks a warm-up: the port's card plan, and a
    # mesh-sized one as in the reference; a CPU plan banks nothing
    assert note_device_plan(spec, plan_search(
        spec, profile_corpus(hists, spec), platform="cpu")) is None
    plan = plan_search(spec, profile_corpus(hists, spec),
                       platform="cuda")
    set_global_devq(q)
    try:
        assert note_device_plan(spec, plan_search(
            spec, profile_corpus(hists, spec), platform="cpu")) is None
        assert note_device_plan(spec, plan) is not None
        mesh = plan_search(spec, profile_corpus(hists, spec),
                           platform="cpu", mesh_devices=8)
        assert note_device_plan(spec, mesh) is not None
    finally:
        set_global_devq(None)
    by_plane = q.snapshot()["pending_by_plane"]
    assert by_plane == {"check": 1, "pcomp": 1, "shrink": 1,
                        "monitor": 1, "warmup": 2}


# --- drain soundness ------------------------------------------------------

def test_drain_banks_oracle_verdicts_bit_identical_to_host(tmp_path):
    """The window's one promise: every banked verdict IS the fresh host
    memo oracle's, landed under the originating fingerprint — the
    device path (the planned checker's plain versions on the CPU here)
    never gets the last word."""
    q = DeviceWorkQueue()
    corpora = []
    for plane, fam in (("check", "register"), ("shrink", "cas")):
        spec, hists = _corpus(fam)
        bank_histories(spec, hists, plane=plane, queue=q)
        corpora.append((spec, hists))
    cache = VerdictCache(max_entries=256)
    report = DrainScheduler(q, cache=cache,
                            devices=["cpu"],
                            window_s=600.0, budget=200_000).drain()
    assert report["drained"] == 2 and report["wrong_verdicts"] == 0
    assert report["key_mismatches"] == 0
    assert 0.0 < report["window_utilization"] <= 1.0
    for plane in ("check", "shrink"):
        stats = report["per_plane"][plane]
        assert stats["items"] == 1 and stats["device_items"] == 1
        assert stats["device_vs_host_ratio"] is not None
    undecided = int(Verdict.BUDGET_EXCEEDED)
    for spec, hists in corpora:
        proofs = WingGongCPU(memo=True).check_histories(spec, hists)
        for h, p in zip(hists, proofs):
            if int(p) == undecided:
                continue  # the bank refuses undecided rows by design
            e = cache.get(fingerprint_key(spec, h))
            assert e is not None and int(e.verdict) == int(p)


def test_drain_refuses_banking_under_mismatched_fingerprint():
    """A corrupted/foreign lane key must not poison the bank: the drain
    re-derives each fingerprint and skips rows that disagree."""
    spec, hists = _corpus("register", n=2)
    q = DeviceWorkQueue()
    key = bank_histories(spec, hists, plane="check", queue=q)
    q.get(key).lane_keys[0] = "sha-of-some-other-history"
    cache = VerdictCache(max_entries=64)
    report = DrainScheduler(q, devices=["cpu"], cache=cache,
                            window_s=600.0, device_dispatch=False).drain()
    assert report["key_mismatches"] == 1
    assert report["banked_rows"] == len(hists) - 1
    assert cache.get(fingerprint_key(spec, hists[1])) is not None
    assert cache.get(fingerprint_key(spec, hists[0])) is None


# --- exactly-once resume --------------------------------------------------

def test_window_close_then_resume_redispatches_nothing(tmp_path):
    """A window that closes mid-drain (clock-driven here; the bench
    SIGKILLs for real) leaves a journal; the successor — handed the
    WHOLE backlog again, as gossip redelivery would — folds every
    journaled completion and re-dispatches zero of them."""
    corpora = [_corpus(f, n=2, prefix="devq_kill")
               for f in ("register", "cas", "queue")]

    def fill(q):
        return [bank_histories(spec, hists, plane="check", queue=q)
                for spec, hists in corpora]

    q1 = DeviceWorkQueue()
    keys = fill(q1)
    journal = str(tmp_path / "drain_journal.jsonl")
    # +10s per clock read, 35s window: the first item lands, then the
    # deadline check stops the drain mid-queue
    t = [0.0]

    def clock():
        t[0] += 10.0
        return t[0]

    r1 = DrainScheduler(q1, devices=["cpu"], window_s=35.0,
                        journal_path=journal, window_id="w",
                        device_dispatch=False, now=clock).drain()
    assert r1["deadline_stopped"] and 1 <= r1["drained"] < len(keys)

    q2 = DeviceWorkQueue()   # every item pending again
    fill(q2)
    r2 = DrainScheduler(q2, devices=["cpu"], window_s=600.0,
                        journal_path=journal, window_id="w", resume=True,
                        device_dispatch=False).drain()
    assert sorted(r2["resumed"]) == sorted(r1["dispatched"])
    assert not set(r2["resumed"]) & set(r2["dispatched"])
    assert sorted(r1["dispatched"] + r2["dispatched"]) == sorted(keys)
    assert len(q2) == 0


# --- fleet convergence ----------------------------------------------------

def test_fleet_bank_adopt_drain_converge(tmp_path):
    """A banks → B adopts A's segments (the legs gossip drives) → B
    drains → A adopts the done tombstones: A's backlog converges to
    zero and every lane A banked hits B's bank with the host verdict."""
    spec, hists = _corpus("register")
    qa = DeviceWorkQueue(str(tmp_path / "a"), node_id="A", seal_rows=1)
    bank_histories(spec, hists, plane="check", queue=qa)
    qb = DeviceWorkQueue(str(tmp_path / "b"), node_id="B", seal_rows=1)

    def reconcile(dst, src):
        for name in dst.missing(src.digests()):
            fp, lines = src.read_segment(name)
            dst.adopt(name, fp, lines)

    reconcile(qb, qa)
    assert len(qb) == 1
    bank = VerdictCache(max_entries=64)
    report = DrainScheduler(qb, devices=["cpu"], cache=bank, window_s=600.0,
                            device_dispatch=False).drain()
    assert report["drained"] == 1 and report["wrong_verdicts"] == 0
    reconcile(qa, qb)
    assert len(qa) == 0 and len(qb) == 0
    proofs = WingGongCPU(memo=True).check_histories(spec, hists)
    for h, p in zip(hists, proofs):
        e = bank.get(fingerprint_key(spec, h))
        assert e is not None and int(e.verdict) == int(p)


# --- the plane seams ------------------------------------------------------

def test_shrink_round_banks_undecided_frontier():
    from qsm_tpu_torch.shrink.shrinker import Shrinker

    spec, failing = _failing_histories("register")
    calls = []

    def decide(batch):
        # input decides VIOLATION; every frontier candidate is left
        # undecided — the exact shape a budget-starved device leaves
        calls.append(len(batch))
        if len(calls) == 1:
            return np.array([int(Verdict.VIOLATION)])
        return np.full(len(batch), int(Verdict.BUDGET_EXCEEDED))

    q = DeviceWorkQueue()
    set_global_devq(q)
    res = Shrinker(spec, decide).run(failing[0])
    assert res.ok and res.undecided_neighbors > 0
    snap = q.snapshot()
    assert snap["pending_by_plane"] == {"shrink": 1}
    item = q.pending_items()[0]
    assert item.model == "register" and len(item.lanes) >= 1


def test_shrink_seam_costs_nothing_without_queue():
    from qsm_tpu_torch.shrink.shrinker import Shrinker

    spec, _ = make("register", "racy")
    sh = Shrinker(spec, lambda batch: np.full(
        len(batch), int(Verdict.LINEARIZABLE)))
    assert global_devq() is None
    sh._bank_undecided([])   # the no-queue path is a no-op, not a raise


def test_monitor_flip_banks_whole_stream_recheck():
    from qsm_tpu_torch.monitor import MonitorSession
    from qsm_tpu_torch.serve.protocol import history_to_rows

    spec, flips = _failing_histories("register")
    q = DeviceWorkQueue()
    set_global_devq(q)
    s = MonitorSession("devq-flip", spec, device="cpu")
    for row in history_to_rows(flips[0]):
        s.append([row])
    assert s.close() == int(Verdict.VIOLATION) and s.flipped
    snap = q.snapshot()
    assert snap["pending_by_plane"] == {"monitor": 1}
    item = q.pending_items()[0]
    assert item.lane_keys == [fingerprint_key(spec, s.history())]


# --- the wire ops + the health SLO ----------------------------------------

def test_serve_devq_ops_and_health_utilization_slo(tmp_path):
    from qsm_tpu_torch.serve import CheckClient, CheckServer

    spec, hists = _corpus("register", n=2)
    srv = CheckServer(flush_s=0.005, max_lanes=16, device="cpu",
                      devq_dir=str(tmp_path / "devq")).start()
    try:
        with CheckClient(srv.address) as client:
            # rare windows are the premise: their absence is zero
            # samples, never a breach
            h0 = client.health()
            assert h0["ok"] and h0["status"] == "ok"
            row0 = h0["devq"]["window_utilization"]
            assert row0["samples"] == 0 and row0["status"] == "ok"

            q = DeviceWorkQueue()
            key = bank_histories(spec, hists, plane="check", queue=q)
            ack = client.devq_put([q.get(key).to_doc()])
            assert ack["ok"] and ack["banked"] == 1
            assert client.devq_put([q.get(key).to_doc()])["banked"] == 0
            dig = client.devq_digests()
            assert dig["ok"] and dig["queue"]["pending"] == 1

            proofs = WingGongCPU(memo=True).check_histories(spec, hists)
            rows = [[fingerprint_key(spec, h), int(p), None]
                    for h, p in zip(hists, proofs)]
            rep = client.devq_drain_report(
                report={"window_id": "w1", "drained": 1,
                        "window_utilization": 0.93},
                rows=rows, done=[key])
            assert rep["ok"] and rep["done"] == 1
            assert client.devq_digests()["queue"]["pending"] == 0
            # the drained verdicts now serve as cache hits
            res = client.check("register", hists)
            assert res["ok"] and all(res["cached"])

            h1 = client.health()
            row1 = h1["devq"]["window_utilization"]
            assert row1["samples"] == 1 and row1["status"] == "ok"
            assert row1["value"] == 0.93
            # read-back form: the banked report itself
            back = client.devq_drain_report()
            assert back["report"]["window_id"] == "w1"
    finally:
        srv.stop()


# --- against the JAX package, and the port's differences ------------------

def test_items_and_rows_are_the_references(tmp_path):
    """The same corpus banks under the same item fingerprint and lane
    keys in both packages, and their segment rows are the same bytes: a
    queue directory is readable by either."""
    from qsm_tpu.devq.queue import DeviceWorkQueue as JQueue
    from qsm_tpu.devq.queue import bank_histories as j_bank
    from qsm_tpu.models.registry import MODELS as J_MODELS
    from qsm_tpu.utils.corpus import build_corpus as j_build_corpus

    spec, hists = _corpus("cas")
    entry = J_MODELS["cas"]
    jspec = entry.make_spec()
    jh = j_build_corpus(
        jspec, (entry.impls["atomic"], entry.impls["racy"]), n=len(hists),
        n_pids=entry.default_pids, max_ops=entry.default_ops,
        seed_prefix="devq_cas")
    q = DeviceWorkQueue(str(tmp_path / "p"), node_id="n", seal_rows=1,
                        now=lambda: 1000.0)
    jq = JQueue(str(tmp_path / "j"), node_id="n", seal_rows=1,
                now=lambda: 1000.0)
    key = bank_histories(spec, hists, plane="check", queue=q)
    jkey = j_bank(jspec, jh, plane="check", queue=jq)
    assert key == jkey
    assert q.get(key).to_doc() == jq.get(jkey).to_doc()
    assert sorted(q.digests()) == sorted(jq.digests())
    # the reference's queue adopts the port's segments and vice versa
    jq2 = JQueue(str(tmp_path / "j2"), node_id="m")
    for name in jq2.missing(q.digests()):
        fp, lines = q.read_segment(name)
        jq2.adopt(name, fp, lines)
    assert jq2.get(key) is not None


def test_drain_verdicts_equal_the_references_drain(tmp_path):
    """The port's drain (its planned checker's plain versions) and the
    reference's host-path drain bank the same oracle verdicts under the
    same keys."""
    from qsm_tpu.devq.drain import DrainScheduler as JDrain
    from qsm_tpu.devq.queue import DeviceWorkQueue as JQueue
    from qsm_tpu.serve.cache import VerdictCache as JCache

    q, jq = DeviceWorkQueue(), JQueue()
    for plane, fam in (("check", "register"), ("shrink", "queue")):
        spec, hists = _corpus(fam, n=3)
        bank_histories(spec, hists, plane=plane, queue=q)
        from qsm_tpu.devq.queue import bank_histories as j_bank
        from qsm_tpu.models.registry import MODELS as J_MODELS
        from qsm_tpu.utils.corpus import build_corpus as j_build_corpus

        entry = J_MODELS[fam]
        jspec = entry.make_spec()
        j_bank(jspec, j_build_corpus(
            jspec, (entry.impls["atomic"], entry.impls["racy"]), n=3,
            n_pids=entry.default_pids, max_ops=entry.default_ops,
            seed_prefix=f"devq_{fam}"), plane=plane, queue=jq)
    cache, jcache = VerdictCache(max_entries=64), JCache(max_entries=64)
    rep = DrainScheduler(q, cache=cache, devices=["cpu"],
                         window_s=600.0).drain()
    jrep = JDrain(jq, cache=jcache, mesh=object(), window_s=600.0,
                  device_dispatch=False).drain()
    assert rep["wrong_verdicts"] == 0 and jrep["wrong_verdicts"] == 0
    assert sorted(rep["dispatched"]) == sorted(jrep["dispatched"])
    assert rep["banked_rows"] == jrep["banked_rows"]
    assert all(rep["per_plane"][p]["device_items"] == 1
               for p in ("check", "shrink"))
    for key in list(cache._od):
        assert jcache.get(key).verdict == cache.get(key).verdict


def test_drain_runs_on_cuda_by_default_and_refuses_a_mesh():
    """The drain's mesh is its window's device list (every card by
    default): a list naming one device twice is refused, and without a
    card the default window raises."""
    import torch

    from qsm_tpu_torch.ops.backend import BackendUnavailable

    with pytest.raises(ValueError, match="duplicate devices"):
        DrainScheduler(DeviceWorkQueue(), devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(BackendUnavailable):
            DrainScheduler(DeviceWorkQueue())


def test_drain_on_the_card_raises_a_real_device_error(monkeypatch):
    """The card's rule: on CUDA a real device error raises out of the
    drain (the reference drops the window to the host ladder); on the CPU
    the window degrades as the reference's does."""
    spec, hists = _corpus("register", n=2)

    class _Boom:
        def check_histories(self, spec, histories):
            raise RuntimeError("CUDA error: device-side assert")

    q = DeviceWorkQueue()
    bank_histories(spec, hists, plane="check", queue=q)
    cpu = DrainScheduler(q, devices=["cpu"], window_s=600.0)
    monkeypatch.setattr(cpu, "_device_backend", lambda item, s: _Boom())
    rep = cpu.drain()
    assert rep["per_plane"]["check"]["host_items"] == 1
    assert rep["wrong_verdicts"] == 0

    q2 = DeviceWorkQueue()
    bank_histories(spec, hists, plane="check", queue=q2)
    card = DrainScheduler(q2, devices=["cpu"], window_s=600.0)
    from qsm_tpu_torch.resilience.failover import degradable_errors

    card._degradable = degradable_errors(True)   # what CUDA selects
    monkeypatch.setattr(card, "_device_backend", lambda item, s: _Boom())
    with pytest.raises(RuntimeError, match="CUDA error"):
        card.drain()


def test_serve_admission_banks_an_oversize_corpus(tmp_path):
    spec, hists = _corpus("register", n=4)
    srv = CheckServer(flush_s=0.005, max_lanes=4, device="cpu",
                      devq_dir=str(tmp_path / "devq")).start()
    try:
        with CheckClient(srv.address) as client:
            res = client.check("register", hists)
        assert res["ok"]
        snap = srv.devq.snapshot()
        assert snap["pending_by_plane"] == {"check": 1}
        item = srv.devq.pending_items()[0]
        assert item.lane_keys == [fingerprint_key(spec, h) for h in hists]
    finally:
        srv.stop()
    assert global_devq() is None
