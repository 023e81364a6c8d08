"""The port's segmented verdict log against the JAX package's (twins of
``tests/test_fleet.py:357``, ``:416``, ``:438``, ``:471``, ``:534``,
``:574``, ``:614`` and of the segmented-bank cases of
``tests/test_cache.py:146-192``).

Each case runs through both packages' ``SegmentedLog`` /
``VerdictCache(store=)``; the segment names, fingerprints and rows they
write must be the same, so that either package reads, serves and
replicates the other's bank."""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

import qsm_tpu.fleet.replog as jreplog
import qsm_tpu.serve.cache as jcache
import qsm_tpu_torch.fleet.replog as preplog
import qsm_tpu_torch.serve.cache as pcache

PKGS = [(jreplog, jcache), (preplog, pcache)]


def _both(fn, tmp_path):
    out = []
    for i, (rl, ca) in enumerate(PKGS):
        d = tmp_path / ("ref" if i == 0 else "port")
        d.mkdir()
        out.append(fn(rl.SegmentedLog, ca.VerdictCache,
                      rl.segment_fingerprint, d))
    return out


def _disk(log_dir) -> dict:
    """Every segment's name and lines (the active tail included)."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".jsonl"):
            with open(os.path.join(log_dir, name)) as f:
                out[name] = f.read().splitlines()
    return out


def _catchup(SegmentedLog, VerdictCache, _fp, tmp):
    a = SegmentedLog(str(tmp / "a"), node_id="a", seal_rows=4)
    ca = VerdictCache(max_entries=4096, store=a)
    ca.put_many([(f"ka{i}", i % 2, None) for i in range(16)])
    b = SegmentedLog(str(tmp / "b"), node_id="b", seal_rows=4)
    cb = VerdictCache(max_entries=4096, store=b)
    stop = threading.Event()

    def live_puts():
        i = 0
        while not stop.is_set():
            cb.put_many([(f"kb{i}_{j}", 0, None) for j in range(3)])
            i += 1
            time.sleep(0.001)

    t = threading.Thread(target=live_puts)
    t.start()
    try:
        for name in b.missing(a.digests()):
            got = a.read_segment(name)
            cb.adopt_rows(b.adopt(name, got[0], got[1]))
    finally:
        stop.set()
        t.join(5.0)
    cb.flush()
    for name in a.digests():
        assert b.adopt(name, *a.read_segment(name)) == []
    on_disk = {}
    for name in b.digests():
        _f, lines = b.read_segment(name)
        for ln in lines:
            on_disk.setdefault(json.loads(ln)["key"], []).append(name)
    for key, segs in on_disk.items():
        if key.startswith("ka"):
            assert len(segs) == 1 and segs[0].startswith("seg-a-"), \
                (key, segs)
    for i in range(16):
        assert cb.get(f"ka{i}").verdict == i % 2
    cb2 = VerdictCache(max_entries=4096,
                       store=SegmentedLog(str(tmp / "b"), node_id="b",
                                          seal_rows=4))
    for i in range(16):
        assert cb2.get(f"ka{i}").verdict == i % 2
    return a.digests()


def test_replog_concurrent_catchup_banks_exactly_once(tmp_path):
    ref, got = _both(_catchup, tmp_path)
    assert got == ref   # the same sealed segments, name and fingerprint


def _torn(SegmentedLog, VerdictCache, _fp, tmp):
    log = SegmentedLog(str(tmp / "n"), node_id="n", seal_rows=100)
    c = VerdictCache(max_entries=100, store=log)
    c.put("good", 1, None)
    with open(os.path.join(str(tmp / "n"), "active.jsonl"), "a") as f:
        f.write('{"key": "torn", "verd')
    log2 = SegmentedLog(str(tmp / "n"), node_id="n", seal_rows=100)
    assert log2.truncated_tails == 1
    c2 = VerdictCache(max_entries=100, store=log2)
    assert c2.get("good").verdict == 1
    assert c2.get("torn") is None
    c2.put("after", 0, None)
    c3 = VerdictCache(max_entries=100,
                      store=SegmentedLog(str(tmp / "n"), node_id="n",
                                         seal_rows=100))
    assert c3.get("after").verdict == 0
    return _disk(str(tmp / "n"))


def test_replog_torn_tail_truncated_not_replayed(tmp_path):
    ref, got = _both(_torn, tmp_path)
    assert got == ref


def _compaction(SegmentedLog, VerdictCache, _fp, tmp):
    a = SegmentedLog(str(tmp / "a"), node_id="a", seal_rows=2)
    ca = VerdictCache(max_entries=4096, store=a)
    ca.put_many([(f"x{i}", 1, None) for i in range(4)])
    b = SegmentedLog(str(tmp / "b"), node_id="b", seal_rows=2)
    cb = VerdictCache(max_entries=4096, store=b)
    cb.put("k", 1, [(0, 5)])
    cb.put("k", 0, None)
    assert cb.get("k").witness == [(0, 5)]
    for name in b.missing(a.digests()):
        cb.adopt_rows(b.adopt(name, *a.read_segment(name)))
    cb.put_many([(f"y{i}", 0, None) for i in range(40)])
    pre = b.snapshot()
    b.compact(cb._live_lines())
    assert b.snapshot()["absorbed_segments"] >= pre["sealed_segments"]
    assert b.missing(a.digests()) == []
    cb2 = VerdictCache(max_entries=4096,
                       store=SegmentedLog(str(tmp / "b"), node_id="b",
                                          seal_rows=2))
    assert cb2.get("k").verdict == 0
    assert cb2.get("k").witness == [(0, 5)]
    for i in range(4):
        assert cb2.get(f"x{i}").verdict == 1
    return b.digests(), b.covered()


def test_replog_compaction_during_catchup_keeps_later_row_wins(tmp_path):
    ref, got = _both(_compaction, tmp_path)
    assert got == ref


def _corrupt(SegmentedLog, VerdictCache, segment_fingerprint, tmp):
    log = SegmentedLog(str(tmp / "n"), node_id="n", seal_rows=2)
    VerdictCache(max_entries=100, store=log).put_many(
        [("a", 1, None), ("b", 0, None)])
    (name,) = log.digests()
    path = os.path.join(str(tmp / "n"), name)
    with open(path, "a") as f:
        f.write('{"key": "evil", "verdict": 0}\n')
    log2 = SegmentedLog(str(tmp / "n"), node_id="n", seal_rows=2)
    assert log2.quarantined_segments == 1
    assert log2.digests() == {}
    assert os.path.exists(path + ".quarantine")
    with pytest.raises(ValueError):
        log2.adopt("seg-x-000001-000000000000.jsonl",
                   segment_fingerprint(["row"]), ["other"])
    return name


def test_replog_corrupt_segment_quarantined(tmp_path):
    ref, got = _both(_corrupt, tmp_path)
    assert got == ref


def test_node_stamps_on_plain_server(tmp_path):
    from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
    from qsm_tpu_torch.serve import CheckClient, CheckServer
    from qsm_tpu_torch.utils.corpus import build_corpus

    corpus = build_corpus(CasSpec(), (AtomicCasSUT, RacyCasSUT), n=2,
                          n_pids=4, max_ops=10, seed_base=0,
                          seed_prefix="fleet")
    srv = CheckServer(node_id="solo", device="cpu",
                      replog_dir=str(tmp_path / "replog")).start()
    try:
        with CheckClient(srv.address, timeout_s=30.0) as c:
            res = c.check("cas", corpus[:2])
            assert res["node"] == "solo"
            bad = c.check("nope", corpus[:1])
            assert bad["node"] == "solo" and not bad["ok"]
            st = c.stats()
            assert st["node"] == "solo"
            assert st["stats"]["node"] == "solo"
            assert st["stats"]["cache"]["replog"]["node"] == "solo"
            # the segment-exchange surface answers over the wire
            dig = c._round_trip({"op": "replog.digests"})
            assert dig["ok"] and "digests" in dig
    finally:
        srv.stop()


def test_cache_path_and_replog_dir_refused(tmp_path):
    from qsm_tpu_torch.serve import CheckServer

    with pytest.raises(ValueError, match="mutually exclusive"):
        CheckServer(cache_path=str(tmp_path / "bank.jsonl"),
                    replog_dir=str(tmp_path / "replog"), device="cpu")


def _mismatch(SegmentedLog, _vc, segment_fingerprint, tmp):
    log = SegmentedLog(str(tmp), node_id="b", seal_rows=2)
    lines = ['{"key": "k", "verdict": 1, "witness": null}']
    fp = segment_fingerprint(lines)
    bad_name = "seg-x-000001-aaaaaaaaaaaa.jsonl"
    assert fp[:12] != "aaaaaaaaaaaa"
    with pytest.raises(ValueError, match="name does not match"):
        log.adopt(bad_name, fp, lines)
    assert log.digests() == {}
    good = f"seg-x-000001-{fp[:12]}.jsonl"
    assert [r["key"] for r in log.adopt(good, fp, lines)] == ["k"]
    return fp


def test_replog_adopt_refuses_name_fingerprint_mismatch(tmp_path):
    ref, got = _both(_mismatch, tmp_path)
    assert got == ref


def _restart_after_seal(SegmentedLog, VerdictCache, _fp, tmp):
    log = SegmentedLog(str(tmp), node_id="n0", seal_rows=4)
    cache = VerdictCache(max_entries=64, store=log)
    for i in range(10):
        cache.put(f"k{i}", i % 2, None)
    assert log.snapshot()["sealed_segments"] == 2
    with open(os.path.join(str(tmp), "active.jsonl"), "a") as f:
        f.write('{"key": "k10", "verd')
    log2 = SegmentedLog(str(tmp), node_id="n0", seal_rows=4)
    assert log2.truncated_tails == 1
    cache2 = VerdictCache(max_entries=64, store=log2)
    assert len(cache2) == 10
    for i in range(10):
        assert cache2.get(f"k{i}").verdict == i % 2
    assert cache2.get("k10") is None
    return _disk(str(tmp))


def test_segmented_bank_restart_after_seal_and_tear(tmp_path):
    ref, got = _both(_restart_after_seal, tmp_path)
    assert got == ref


def _gated(SegmentedLog, VerdictCache, _fp, tmp):
    a = SegmentedLog(str(tmp / "a"), node_id="a", seal_rows=2)
    VerdictCache(max_entries=64, store=a).put_many(
        [("x", 1, None), ("y", 0, None)])
    (name,) = a.digests()
    fp, lines = a.read_segment(name)
    b = SegmentedLog(str(tmp / "b"), node_id="b", seal_rows=2)
    with pytest.raises(ValueError):
        b.adopt(name, fp, lines + ['{"key": "evil", "verdict": 0}'])
    assert b.digests() == {}
    rows = b.adopt(name, fp, lines)
    assert [r["key"] for r in rows] == ["x", "y"]
    assert b.adopt(name, fp, lines) == []
    assert b.missing(a.digests()) == []
    return name, fp, lines


def test_segmented_bank_adoption_is_fingerprint_gated(tmp_path):
    ref, got = _both(_gated, tmp_path)
    assert got == ref


def test_either_package_reads_the_others_bank(tmp_path):
    """A bank the reference wrote serves in the port, and back."""
    for (wrl, wca), (rrl, rca) in ((PKGS[0], PKGS[1]),
                                   (PKGS[1], PKGS[0])):
        d = str(tmp_path / wrl.__name__)
        c = wca.VerdictCache(max_entries=64, store=wrl.SegmentedLog(
            d, node_id="n", seal_rows=3))
        c.put_many([(f"k{i}", i % 2, [(0, i)] if i % 2 else None)
                    for i in range(7)])
        c.flush()
        back = rca.VerdictCache(max_entries=64, store=rrl.SegmentedLog(
            d, node_id="n", seal_rows=3))
        for i in range(7):
            e = back.get(f"k{i}")
            assert e.verdict == i % 2
            assert e.witness == ([(0, i)] if i % 2 else None)
