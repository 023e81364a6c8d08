"""The port's check server against the JAX package's (twins of
``tests/test_serve.py:65-517``), and the places where the port's server
differs on purpose (ROADMAP C).

Each verdict or witness case runs the same corpora through the JAX
package's ``CheckServer()`` (its host ladder; no JAX is touched) and the
port's ``CheckServer(device="cpu")``, twice: with the port's host ladder,
where the responses are the reference's field for field, and with
``engine_factory=lambda s: TorchStepper(s, device="cpu")``, the
device-engine path, whose BUDGET lanes the oracle resolves.  Verdicts and
witnesses must be bit-identical."""

from __future__ import annotations

import json
import threading
import time

import pytest
import torch

from _torch_serve_pkgs import (PORT, PORT_STEPPER, PORTS, REF,
                               batches_shape, strip)

FAMILIES = ("register", "cas", "queue", "kv")
_IDS = [p.id for p in PORTS]


def _run(pkg, fn, **server_kw):
    server_kw.setdefault("flush_s", 0.005)
    server_kw.setdefault("max_lanes", 16)
    srv = pkg.server(**server_kw).start()
    try:
        return fn(srv)
    finally:
        srv.stop()


# --- verdict/witness parity ------------------------------------------------

def _family_answers(pkg):
    def drive(srv):
        out = {}
        with pkg.CheckClient(srv.address) as client:
            for family in FAMILIES:
                spec, hists = pkg.corpus(family)
                res = client.check(family, hists)
                assert res["ok"], res
                direct = pkg.WingGongCPU(memo=True).check_histories(
                    spec, hists)
                assert res["verdicts"] == pkg.names(direct), family
                assert "LINEARIZABLE" in res["verdicts"], family
                out[family] = res
        return out

    return _run(pkg, drive)


@pytest.mark.parametrize("port", PORTS, ids=_IDS)
def test_served_verdicts_bit_identical_across_families(port):
    ref = _family_answers(REF)
    got = _family_answers(port)
    for family in FAMILIES:
        assert got[family]["verdicts"] == ref[family]["verdicts"], family
        assert got[family]["cached"] == ref[family]["cached"]
        assert (batches_shape(got[family]["batches"])
                == batches_shape(ref[family]["batches"]))
        if port is PORT:
            # the host ladder on the CPU: the reference's response, field
            # for field (the batch's cost record counts the same nodes)
            assert strip(got[family]) == strip(ref[family]), family


def _witness_answers(pkg):
    spec, hists = pkg.corpus("cas", n=6)
    oracle = pkg.WingGongCPU(memo=True)

    def drive(srv):
        with pkg.CheckClient(srv.address) as client:
            res = client.check("cas", hists, witness=True)
        assert res["ok"]
        for h, v, w in zip(hists, res["verdicts"], res["witnesses"]):
            dv, dw = oracle.check_witness(spec, h)
            assert v == pkg.VERDICT_NAMES[int(dv)]
            if v == "LINEARIZABLE":
                w = [tuple(p) for p in w]
                assert w == dw
                assert pkg.verify_witness(spec, h, w)
            else:
                assert w is None
        return res

    return _run(pkg, drive)


@pytest.mark.parametrize("port", PORTS, ids=_IDS)
def test_served_witnesses_bit_identical(port):
    ref, got = _witness_answers(REF), _witness_answers(port)
    assert got["verdicts"] == ref["verdicts"]
    assert got["witnesses"] == ref["witnesses"]


# --- caching ------------------------------------------------------------------

def _hit_replays(pkg, tmp_path):
    spec, hists = pkg.corpus("register", n=6)

    def drive(srv):
        with pkg.CheckClient(srv.address) as client:
            first = client.check("register", hists, witness=True)
            second = client.check("register", hists, witness=True)
        assert first["ok"] and second["ok"]
        assert not any(first["cached"])
        assert all(second["cached"])
        assert second["verdicts"] == first["verdicts"]
        for h, v, w in zip(hists, second["verdicts"], second["witnesses"]):
            if v == "LINEARIZABLE":
                assert pkg.verify_witness(spec, h, [tuple(p) for p in w])
        return second

    return _run(pkg, drive,
                cache_path=str(tmp_path / f"{pkg.id}_bank.jsonl"))


@pytest.mark.parametrize("port", PORTS, ids=_IDS)
def test_cache_hit_returns_banked_witness_that_replays(port, tmp_path):
    ref, got = _hit_replays(REF, tmp_path), _hit_replays(port, tmp_path)
    assert got["witnesses"] == ref["witnesses"]
    assert got["cached"] == ref["cached"]


def _upgrade(pkg):
    spec, hists = pkg.corpus("register", n=4)

    def drive(srv):
        with pkg.CheckClient(srv.address) as client:
            plain = client.check("register", hists)
            with_w = client.check("register", hists, witness=True)
        assert plain["ok"] and with_w["ok"]
        assert with_w["verdicts"] == plain["verdicts"]
        for h, v, w in zip(hists, with_w["verdicts"],
                           with_w["witnesses"]):
            if v == "LINEARIZABLE":
                assert w is not None
                assert pkg.verify_witness(spec, h, [tuple(p) for p in w])
        return with_w

    return _run(pkg, drive)


@pytest.mark.parametrize("port", PORTS, ids=_IDS)
def test_verdict_only_hit_then_witness_request_upgrades(port):
    ref, got = _upgrade(REF), _upgrade(port)
    assert got["witnesses"] == ref["witnesses"]
    assert got["cached"] == ref["cached"]


def _kill_restart(pkg, tmp_path):
    bank = str(tmp_path / f"{pkg.id}_bank.jsonl")
    spec, hists = pkg.corpus("cas", n=8)
    direct = pkg.WingGongCPU(memo=True).check_histories(spec, hists)
    srv = pkg.server(flush_s=0.005, max_lanes=16, cache_path=bank).start()
    try:
        with pkg.CheckClient(srv.address) as client:
            res = client.check("cas", hists)
            assert res["ok"] and not any(res["cached"])
    finally:
        srv.stop()
    with open(bank, "a") as f:
        f.write('{"key": "torn-mid-wr')  # a torn tail
    srv2 = pkg.server(flush_s=0.005, max_lanes=16, cache_path=bank).start()
    try:
        with pkg.CheckClient(srv2.address) as client:
            res2 = client.check("cas", hists)
        assert res2["ok"]
        assert all(res2["cached"]), res2["cached"]
        assert res2["verdicts"] == pkg.names(direct)
        assert srv2.stats()["cache"]["hits"] == len(hists)
    finally:
        srv2.stop()
    return res2["verdicts"]


def test_kill_mid_bank_then_restart_serves_persisted_cache(tmp_path):
    ref = _kill_restart(REF, tmp_path)
    for port in PORTS:
        assert _kill_restart(port, tmp_path) == ref


# --- shedding: explicit, never wrong ----------------------------------------

class _SlowEngine:
    """Delegates to the memo oracle after a fixed stall (deadline bait)."""

    name = "slow_stub"

    def __init__(self, pkg, stall_s=0.4):
        self.inner = pkg.WingGongCPU(memo=True)
        self.stall_s = stall_s

    def check_histories(self, spec, histories):
        time.sleep(self.stall_s)
        return self.inner.check_histories(spec, histories)


def _deadline_shed(pkg):
    def drive(srv):
        with pkg.CheckClient(srv.address) as client:
            spec, hists = pkg.corpus("register", n=4)
            res = client.check("register", hists, deadline_s=0.05)
            assert res["ok"] is False
            assert res["shed"] is True and res["reason"] == "deadline"
            assert "verdicts" not in res
        assert srv.stats()["admission"]["shed_deadline"] == 1
        return strip(res, drop=("admission",))

    return _run(pkg, drive, engine_factory=lambda s: _SlowEngine(pkg))


def test_deadline_exceeded_gets_shed_never_wrong():
    assert _deadline_shed(PORT) == _deadline_shed(REF)


def _bad_requests(pkg):
    def drive(srv):
        spec, hists = pkg.corpus("register", n=6)
        with pkg.CheckClient(srv.address) as client:
            errors = []
            for _ in range(3):
                res = client.check("cas", hists, spec_kwargs={"bogus": 1})
                assert res["ok"] is False and "error" in res
                errors.append(res["error"])
            assert srv.admission.snapshot()["in_flight"] == 0
            res = client.check("register", hists)
            assert res["ok"], res
            direct = pkg.WingGongCPU(memo=True).check_histories(spec,
                                                                hists)
            assert res["verdicts"] == pkg.names(direct)
        return errors, res["verdicts"]

    return _run(pkg, drive, queue_depth=8)


@pytest.mark.parametrize("port", PORTS, ids=_IDS)
def test_bad_requests_do_not_leak_admission_slots(port):
    ref_err, ref_v = _bad_requests(REF)
    got_err, got_v = _bad_requests(port)
    assert got_v == ref_v
    assert [e.split(":")[0] for e in got_err] == \
        [e.split(":")[0] for e in ref_err]


def _queue_full(pkg):
    def drive(srv):
        with pkg.CheckClient(srv.address) as client:
            spec, hists = pkg.corpus("register", n=5)
            res = client.check("register", hists)
            assert res["ok"] is False and res["shed"] is True
            assert res["reason"] == "queue full"
        assert srv.stats()["admission"]["shed_queue"] == 1
        return strip(res)

    return _run(pkg, drive, queue_depth=2)


def test_queue_full_gets_shed():
    assert _queue_full(PORT) == _queue_full(REF)


# --- the `serve` fault site --------------------------------------------------

def _raise_serve(pkg, monkeypatch):
    spec, hists = pkg.corpus("queue", n=6)
    direct = pkg.WingGongCPU(memo=True).check_histories(spec, hists)

    def drive(srv):
        monkeypatch.setenv("QSM_TPU_FAULTS", "raise:serve")
        pkg.reset_faults()
        try:
            with pkg.CheckClient(srv.address) as client:
                res = client.check("queue", hists)
        finally:
            monkeypatch.delenv("QSM_TPU_FAULTS")
            pkg.reset_faults()
        assert res["ok"]
        assert res["verdicts"] == pkg.names(direct)
        assert srv.stats()["serve_faults"] >= 1
        assert any(b.get("degraded") for b in res["batches"])
        return res

    return _run(pkg, drive)


@pytest.mark.parametrize("port", PORTS, ids=_IDS)
def test_serve_fault_raise_degrades_batch_not_server(monkeypatch, port):
    ref, got = _raise_serve(REF, monkeypatch), _raise_serve(port,
                                                            monkeypatch)
    assert got["verdicts"] == ref["verdicts"]
    assert batches_shape(got["batches"]) == batches_shape(ref["batches"])


def _hang_serve(pkg, monkeypatch):
    spec, hists = pkg.corpus("register", n=4)
    direct = pkg.WingGongCPU(memo=True).check_histories(spec, hists)

    def drive(srv):
        monkeypatch.setenv("QSM_TPU_FAULTS", "hang:serve")
        monkeypatch.setenv("QSM_TPU_FAULT_HANG_S", "5")
        pkg.reset_faults()
        t0 = time.monotonic()
        try:
            with pkg.CheckClient(srv.address) as client:
                res = client.check("register", hists)
        finally:
            monkeypatch.delenv("QSM_TPU_FAULTS")
            pkg.reset_faults()
        assert res["ok"]
        assert res["verdicts"] == pkg.names(direct)
        assert time.monotonic() - t0 < 4.0  # abandoned, not slept out
        assert srv.stats()["serve_faults"] >= 1
        return res["verdicts"]

    return _run(pkg, drive,
                policy=pkg.preset("serve").with_(timeout_s=0.2))


def test_serve_fault_hang_is_watchdogged(monkeypatch):
    assert _hang_serve(PORT, monkeypatch) == _hang_serve(REF, monkeypatch)


# --- two concurrent clients ---------------------------------------------------

def _two_clients(pkg):
    def drive(srv):
        results = {}

        def one(family):
            spec, hists = pkg.corpus(family, n=6)
            direct = pkg.WingGongCPU(memo=True).check_histories(spec,
                                                                hists)
            with pkg.CheckClient(srv.address) as client:
                res = client.check(family, hists)
            results[family] = (res, pkg.names(direct))

        threads = [threading.Thread(target=one, args=(f,))
                   for f in ("register", "cas")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert set(results) == {"register", "cas"}
        for family, (res, direct_names) in results.items():
            assert res["ok"], family
            assert res["verdicts"] == direct_names, family
        st = srv.stats()
        assert st["requests"] == 2
        assert st["batcher"]["batches"] >= 1
        for res, _ in results.values():
            for b in res["batches"]:
                assert {"batch", "lanes", "width", "occupancy",
                        "flush"} <= set(b)
        return {f: r["verdicts"] for f, (r, _) in results.items()}

    return _run(pkg, drive)


@pytest.mark.parametrize("port", PORTS, ids=_IDS)
def test_serve_smoke_two_concurrent_clients(port):
    assert _two_clients(port) == _two_clients(REF)


# --- CLI: submit + stats --serve ----------------------------------------------

def _submit_stats(pkg, tmp_path, capsys):
    spec, hists = pkg.corpus("cas", n=4)
    path = tmp_path / f"{pkg.id}_trace.json"
    path.write_text(json.dumps({"model": "cas",
                                "histories": pkg.rows(hists)}))

    def drive(srv):
        rc = pkg.main(["submit", "--addr", srv.address, "--trace",
                       str(path)])
        doc = json.loads(capsys.readouterr().out.strip())
        direct = pkg.WingGongCPU(memo=True).check_histories(spec, hists)
        assert doc["verdicts"] == pkg.names(direct)
        n_vio = sum(v == "VIOLATION" for v in doc["verdicts"])
        assert rc == (1 if n_vio else 0)
        rc2 = pkg.main(["stats", "--serve", srv.address])
        stats = json.loads(capsys.readouterr().out.strip())
        assert rc2 == 0
        assert stats["requests"] >= 1
        assert {"cache", "batcher", "admission"} <= set(stats)
        return rc, doc["verdicts"], sorted(stats)

    return _run(pkg, drive)


def test_submit_and_stats_cli_roundtrip(tmp_path, capsys):
    ref = _submit_stats(REF, tmp_path, capsys)
    got = _submit_stats(PORT, tmp_path, capsys)
    assert got[:2] == ref[:2]
    # every key of the reference's stats document is the port's too
    assert set(ref[2]) <= set(got[2])


# --- unit: batcher / cache / admission ----------------------------------------

def _full_flush(pkg):
    done = threading.Event()
    batches = []

    def dispatch(key, lanes, why):
        batches.append((key, lanes, why))
        for lane in lanes:
            lane.resolve(1, why)
        done.set()

    b = pkg.MicroBatcher(dispatch, max_lanes=4, flush_s=5.0)
    b.start()
    try:
        far = time.monotonic() + 60
        for i in range(4):
            assert b.submit("g", pkg.Lane(key=str(i), history=None,
                                          deadline=far,
                                          resolve=lambda v, w: None))
        assert done.wait(2.0), "full batch did not flush"
        key, lanes, why = batches[0]
        assert len(lanes) == 4 and why["flush"] == "full"
        assert why["occupancy"] == 1.0
        return why
    finally:
        b.stop()


def test_batcher_flushes_full_batches_immediately():
    assert _full_flush(PORT) == _full_flush(REF)


def _interval_flush(pkg):
    done = threading.Event()
    stamps = []

    def dispatch(key, lanes, why):
        stamps.append(why)
        done.set()

    b = pkg.MicroBatcher(dispatch, max_lanes=64, flush_s=0.02)
    b.start()
    try:
        b.submit("g", pkg.Lane(key="k", history=None,
                               deadline=time.monotonic() + 60,
                               resolve=lambda v, w: None))
        assert done.wait(2.0), "lone lane never flushed"
        assert stamps[0]["flush"] == "interval"
        assert stamps[0]["lanes"] == 1
        return stamps[0]
    finally:
        b.stop()


def test_batcher_interval_flush_for_lone_lane():
    assert _interval_flush(PORT) == _interval_flush(REF)


def _deadline_flush(pkg):
    done = threading.Event()
    stamps = []

    def dispatch(key, lanes, why):
        stamps.append(why)
        done.set()

    b = pkg.MicroBatcher(dispatch, max_lanes=64, flush_s=1.0)
    b.start()
    try:
        t0 = time.monotonic()
        b.submit("g", pkg.Lane(key="k", history=None,
                               deadline=time.monotonic() + 0.05,
                               resolve=lambda v, w: None))
        assert done.wait(2.0)
        assert time.monotonic() - t0 < 0.9  # did not wait the interval
        assert stamps[0]["flush"] == "deadline"
        return stamps[0]
    finally:
        b.stop()


def test_batcher_deadline_flush_preempts_interval():
    assert _deadline_flush(PORT) == _deadline_flush(REF)


def _lru_honesty(pkg, bank):
    c = pkg.VerdictCache(max_entries=2, path=bank)
    c.put("a", 1, witness=[(0, 1)])
    c.put("b", 0)
    c.put("undecided", 2)  # BUDGET_EXCEEDED never banks
    assert c.get("undecided") is None
    assert c.get("a").witness == [(0, 1)]
    c.put("c", 1)  # evicts the LRU ("b")
    assert c.get("b") is None
    assert c.get("a") is not None
    c2 = pkg.VerdictCache(max_entries=8, path=bank)
    assert c2.get("a").verdict == 1
    assert c2.get("a").witness == [(0, 1)]
    assert c2.get("c").verdict == 1
    c2.put("a", 1)
    assert c2.get("a").witness == [(0, 1)]
    return strip(c2.stats(), drop=("path",))


def test_verdict_cache_lru_persistence_and_honesty(tmp_path):
    ref = _lru_honesty(REF, str(tmp_path / "ref.jsonl"))
    got = _lru_honesty(PORT, str(tmp_path / "port.jsonl"))
    assert got == ref


def test_verdict_bank_append_log_supersede_and_witness(tmp_path):
    out = []
    for pkg in (REF, PORT):
        bank = str(tmp_path / f"{pkg.id}.jsonl")
        c = pkg.VerdictCache(max_entries=8, path=bank)
        c.put("a", 1, witness=[(0, 1)])
        c.put("a", 1)  # a verdict-only refresh keeps the witness
        c2 = pkg.VerdictCache(max_entries=8, path=bank)
        assert c2.get("a").witness == [(0, 1)]
        assert c2.stats()["bank_rows"] == 2
        assert len(c2) == 1
        with open(bank) as f:
            out.append(f.read())
    # the same bytes on disk
    assert out[0] == out[1]


def _torn_tail(pkg, bank):
    c = pkg.VerdictCache(max_entries=8, path=bank)
    c.put("a", 1)
    c.put("b", 0)
    with open(bank, "a") as f:
        f.write('{"key": "c", "verd')
    c2 = pkg.VerdictCache(max_entries=8, path=bank)
    assert c2.get("a") is not None and c2.get("b") is not None
    c2.put("d", 1)
    c3 = pkg.VerdictCache(max_entries=8, path=bank)
    assert c3.get("a").verdict == 1
    assert c3.get("b").verdict == 0
    assert c3.get("d").verdict == 1
    c3.put("e", 1)
    assert pkg.VerdictCache(max_entries=8, path=bank).get("e") is not None
    with open(bank) as f:
        body = f.read()
    with open(bank, "w") as f:
        f.write(body.rstrip("\n"))
    c4 = pkg.VerdictCache(max_entries=8, path=bank)
    assert c4.get("e") is not None
    c4.put("f", 1)
    c5 = pkg.VerdictCache(max_entries=8, path=bank)
    assert c5.get("e") is not None and c5.get("f") is not None
    return strip(c5.stats(), drop=("path",))


def test_verdict_bank_append_after_torn_tail_compacts_first(tmp_path):
    assert (_torn_tail(PORT, str(tmp_path / "p.jsonl"))
            == _torn_tail(REF, str(tmp_path / "r.jsonl")))


def _bounded(pkg, bank):
    c = pkg.VerdictCache(max_entries=4, path=bank)
    for i in range(40):
        c.put(f"k{i}", 1)
    st = c.stats()
    assert st["compactions"] >= 1
    assert st["bank_rows"] <= 2 * 40
    assert pkg.VerdictCache(max_entries=4, path=bank).get("k39") is not None
    return strip(st, drop=("path",))


def test_verdict_bank_compacts_instead_of_growing_unbounded(tmp_path):
    assert (_bounded(PORT, str(tmp_path / "p.jsonl"))
            == _bounded(REF, str(tmp_path / "r.jsonl")))


def test_verdict_cache_preserves_alien_file(tmp_path):
    for pkg in (REF, PORT):
        d = tmp_path / pkg.id
        d.mkdir()
        path = d / "not_a_bank.json"
        path.write_text('{"something": "else"}\n')
        c = pkg.VerdictCache(path=str(path))
        assert len(c) == 0
        assert (d / "not_a_bank.json.pre-resume").exists()
        c.put("k", 1)
        assert pkg.VerdictCache(path=str(path)).get("k") is not None


def test_admission_bounds_and_counters():
    snaps = []
    for pkg in (REF, PORT):
        a = pkg.AdmissionController(queue_depth=4)
        assert a.try_admit(3)
        assert not a.try_admit(2)
        assert a.try_admit(1)
        a.release(4)
        snap = a.snapshot()
        assert snap["in_flight"] == 0 and snap["shed_queue"] == 1
        assert snap["admitted_lanes"] == 4
        assert snap["completed_lanes"] == 4
        assert snap["peak_in_flight"] == 4
        assert snap["policy"] == "serve"
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_verdict_names_match_verdict_enum():
    for v in PORT.Verdict:
        assert PORT.VERDICT_NAMES[int(v)] == v.name
    assert tuple(PORT.VERDICT_NAMES) == tuple(REF.VERDICT_NAMES)


# --- the port's differences (ROADMAP C) -------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_server_runs_on_cuda_by_default_and_refuses_without_a_card():
    from qsm_tpu_torch.ops.backend import BackendUnavailable
    from qsm_tpu_torch.serve import CheckServer

    srv = CheckServer()
    with pytest.raises(BackendUnavailable):
        srv.start()
    assert CheckServer(engine="planned").on_cpu is False


def test_workers_mesh_and_fleet_arguments_are_refused(tmp_path):
    """``workers`` without the CPU, and ``workers`` with a mesh, stay
    refused; the fleet tier's arguments (``peers=``, ``lease_path=``) now
    build their agent and lease store."""
    from qsm_tpu_torch.fleet.gossip import GossipAgent
    from qsm_tpu_torch.fleet.lease import FileLeaseStore
    from qsm_tpu_torch.serve import CheckServer

    with pytest.raises(ValueError, match="device='cpu'"):
        CheckServer(workers=2)
    with pytest.raises(ValueError, match="exclusive"):
        CheckServer(device="cpu", workers=2, mesh_devices=2)
    srv = CheckServer(device="cpu", node_id="n0", peers=[["n1", "a:1"]],
                      replog_dir=str(tmp_path / "replog"), gossip_s=0.0)
    assert isinstance(srv.gossip, GossipAgent)
    assert srv.gossip.peer_ids() == ["n1"]
    assert srv.stats()["gossip"]["peers"] == ["n1"]
    lease = str(tmp_path / "lease.json")
    srv = CheckServer(device="cpu", lease_path=lease)
    assert isinstance(srv.lease_store, FileLeaseStore)
    assert srv.stats()["lease_host"] == {"path": lease, "ops": 0}


def test_fleet_ops_answer_an_error_naming_the_fleet_tier(tmp_path):
    """The fleet tier's node ops answer as the reference's: without a
    replog ``gossip.peers`` names the missing log and without a lease
    path ``lease.read`` names the missing record; with them both work
    (the ``gossip.peers`` wiring and a ``lease.read`` of a fresh
    record)."""
    def bare(srv):
        with PORT.CheckClient(srv.address) as client:
            res = client._round_trip({"op": "gossip.peers"})
            assert res["ok"] is False and "replog" in res["error"]
            res = client._round_trip({"op": "lease.read"})
            assert res["ok"] is False and "lease" in res["error"]
            assert "A7" not in res["error"]
    _run(PORT, bare)

    def wired(srv):
        with PORT.CheckClient(srv.address) as client:
            res = client._round_trip({"op": "gossip.peers",
                                      "peers": [["n1", "a:1"]],
                                      "interval_s": 0.0})
            assert res["ok"] and res["peers"] == ["n1"]
            res = client._round_trip({"op": "lease.read"})
            assert res["ok"] and res["record"] is None
            res = client._round_trip({"op": "lease.acquire",
                                      "holder": "rA", "ttl_s": 5.0})
            assert res["ok"] and res["acquired"]
            assert res["record"]["term"] == 1
        assert srv.stats()["lease_host"]["ops"] == 2
    _run(PORT, wired, node_id="n0", replog_dir=str(tmp_path / "r"),
         lease_path=str(tmp_path / "lease.json"))


class _CardEngine:
    """An engine that says it runs on CUDA (its torch device) and decides
    with the memo oracle, or raises a real, non-injected error."""

    name = "card_stub"

    def __init__(self, fail: bool):
        self.device = torch.device("cuda", 0)
        self.fail = fail
        self.calls = 0
        self.oracle = PORT.WingGongCPU(memo=True)

    def check_histories(self, spec, histories):
        self.calls += 1
        if self.fail:
            raise RuntimeError("CUDA error: an illegal memory access "
                               "was encountered")
        return self.oracle.check_histories(spec, histories)


def test_real_device_error_is_answered_not_decided_on_the_host():
    engines = []

    def factory(spec):
        engines.append(_CardEngine(fail=True))
        return engines[-1]

    def drive(srv):
        spec, hists = PORT.corpus("register", n=4)
        with PORT.CheckClient(srv.address) as client:
            res = client.check("register", hists)
            assert res["ok"] is False, res
            assert res["error"].startswith("RuntimeError: CUDA error")
            assert "verdicts" not in res
            # the server lives on: the next request answers the same way
            again = client.check("register", hists[:1])
            assert again["ok"] is False
        st = srv.stats()
        assert st["serve_faults"] == 2 and st["device_errors"] == 2
        assert st["cache"]["entries"] == 0      # nothing banked
        assert st["budget_resolved"] == 0       # no host re-decision
        assert all(e.calls >= 1 for e in engines)

    _run(PORT, drive, engine_factory=factory)


def test_injected_fault_on_a_card_engine_degrades_with_exact_verdicts(
        monkeypatch):
    spec, hists = PORT.corpus("queue", n=6)
    direct = PORT.WingGongCPU(memo=True).check_histories(spec, hists)

    def drive(srv):
        monkeypatch.setenv("QSM_TPU_FAULTS", "raise:serve@2")
        PORT.reset_faults()
        try:
            with PORT.CheckClient(srv.address) as client:
                first = client.check("queue", hists[:2])
                res = client.check("queue", hists)
        finally:
            monkeypatch.delenv("QSM_TPU_FAULTS")
            PORT.reset_faults()
        assert first["ok"] and res["ok"], res
        assert res["verdicts"] == PORT.names(direct)
        assert srv.stats()["serve_faults"] == 1
        assert srv.stats()["device_errors"] == 0
        assert any(b.get("degraded") == "InjectedFault"
                   for b in res["batches"])

    _run(PORT, drive, engine_factory=lambda s: _CardEngine(fail=False))


def test_budget_lanes_of_a_device_engine_are_resolved_by_the_oracle():
    """The port resolves every BUDGET lane of an engine that is not the
    host ladder (the reference skips them when its engine is named
    'auto'): a starved TorchStepper on the CPU answers exactly."""
    from qsm_tpu_torch.ops.stepper import TorchStepper

    spec, hists = PORT.corpus("cas", n=8, pids=4, ops=12)
    direct = PORT.WingGongCPU(memo=True).check_histories(spec, hists)

    def drive(srv):
        with PORT.CheckClient(srv.address) as client:
            res = client.check("cas", hists)
        assert res["ok"] and res["undecided"] == 0
        assert res["verdicts"] == PORT.names(direct)
        assert srv.stats()["budget_resolved"] > 0

    _run(PORT, drive, engine_factory=lambda s: TorchStepper(
        s, budget=4, mid_budget=0, rescue_budget=0, device="cpu"))


def test_concurrent_clients_session_and_shrink_equal_serial():
    """Two check clients, a monitor session (its window re-checks on its
    own TorchStepper under its own lock) and a shrink request at once:
    every answer equals the serial one."""
    from qsm_tpu_torch.monitor import SessionManager
    from qsm_tpu_torch.ops.stepper import TorchStepper

    cas_spec, cas_h = PORT.corpus("cas", n=8)
    q_spec, q_h = PORT.corpus("queue", n=8)
    reg_spec, reg_h = PORT.corpus("register", n=12, prefix="sess")
    oracle = PORT.WingGongCPU(memo=True)
    vio = next(h for h, v in zip(reg_h, oracle.check_histories(
        reg_spec, reg_h)) if int(v) == int(PORT.Verdict.VIOLATION))
    stream = next(h for h, v in zip(reg_h, oracle.check_histories(
        reg_spec, reg_h)) if int(v) == int(PORT.Verdict.LINEARIZABLE))

    def serial():
        out = {}

        def drive(srv):
            srv.monitor = SessionManager(
                bank=srv.cache,
                engine=lambda s: TorchStepper(s, device="cpu"))
            with PORT.CheckClient(srv.address) as client:
                out["cas"] = client.check("cas", cas_h)["verdicts"]
                out["queue"] = client.check("queue", q_h)["verdicts"]
                out["shrink"] = client.shrink(
                    "register", PORT.history_to_rows(vio))["history"]
                out["session"] = _session(client)
        _run(PORT_STEPPER, drive)
        return out

    def _session(client):
        from qsm_tpu_torch.serve import SessionHandle

        h = SessionHandle(client, "register")
        rows = PORT.history_to_rows(stream)
        verdicts = [h.append(rows[i:i + 2])["verdict"]
                    for i in range(0, len(rows), 2)]
        return verdicts + [h.close()["verdict"]]

    def concurrent():
        out = {}

        def drive(srv):
            srv.monitor = SessionManager(
                bank=srv.cache,
                engine=lambda s: TorchStepper(s, device="cpu"))

            def run(name, fn):
                with PORT.CheckClient(srv.address) as client:
                    out[name] = fn(client)

            jobs = {
                "cas": lambda c: c.check("cas", cas_h)["verdicts"],
                "queue": lambda c: c.check("queue", q_h)["verdicts"],
                "shrink": lambda c: c.shrink(
                    "register", PORT.history_to_rows(vio))["history"],
                "session": _session,
            }
            threads = [threading.Thread(target=run, args=kv)
                       for kv in jobs.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert srv.monitor.engines.stats()["calls"] > 0
        _run(PORT_STEPPER, drive)
        return out

    ser = serial()
    assert ser["cas"] == PORT.names(oracle.check_histories(cas_spec,
                                                           cas_h))
    # switch threads often, so that an unguarded engine would interleave
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = concurrent()
    finally:
        sys.setswitchinterval(interval)
    assert got == ser
