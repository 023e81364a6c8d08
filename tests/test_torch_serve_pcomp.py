"""The port's served per-key split against the JAX package's (twins of
``tests/test_serve_pcomp.py:44-164``).

Long decomposable histories fan out as per-key sub-lanes riding the
projected spec's micro-batches on ``CheckServer(device="cpu")``; the
verdicts must equal the JAX package's direct decomposed verdicts
(``qsm_tpu.ops.pcomp.PComp``) on its own copy of the corpus, and the
per-sub-history cache rows make a one-key change re-check exactly one
key."""

import dataclasses

from qsm_tpu.models.kv import AtomicKvSUT as JAtomicKvSUT
from qsm_tpu.models.kv import KvSpec as JKvSpec
from qsm_tpu.models.kv import StaleCacheKvSUT as JStaleCacheKvSUT
from qsm_tpu.ops.pcomp import PComp as JPComp
from qsm_tpu.utils.corpus import build_corpus as j_build_corpus
from qsm_tpu_torch.core.history import History
from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.pcomp import PComp
from qsm_tpu_torch.serve import CheckClient, CheckServer
from qsm_tpu_torch.serve.protocol import VERDICT_NAMES
from qsm_tpu_torch.utils.corpus import build_corpus

import pytest

KW = {"n_keys": 8, "n_values": 4}


def _corpus(n=6, ops=96, seed=5):
    """The port's corpus, and the JAX package's direct decomposed
    verdicts on its own copy of it (same seeds, same histories); the
    port's own ``PComp`` must agree."""
    spec = KvSpec(**KW)
    hists = build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT), n=n,
                         n_pids=16, max_ops=ops, seed_base=seed,
                         seed_prefix="serve_pc")
    jspec = JKvSpec(**KW)
    jh = j_build_corpus(jspec, (JAtomicKvSUT, JStaleCacheKvSUT), n=n,
                        n_pids=16, max_ops=ops, seed_base=seed,
                        seed_prefix="serve_pc")
    assert [h.fingerprint() for h in hists] == \
        [h.fingerprint() for h in jh]
    want = [VERDICT_NAMES[int(v)]
            for v in JPComp(jspec).check_histories(jspec, jh)]
    assert [VERDICT_NAMES[int(v)]
            for v in PComp(spec).check_histories(spec, hists)] == want
    return spec, hists, want


def _server(**kw):
    kw.setdefault("flush_s", 0.005)
    kw.setdefault("max_lanes", 64)
    return CheckServer(device="cpu", **kw).start()


@pytest.fixture()
def server(tmp_path):
    srv = _server(cache_path=str(tmp_path / "bank.jsonl"))
    yield srv
    srv.stop()


def test_served_split_matches_direct_decomposed(server):
    spec, hists, want = _corpus()
    with CheckClient(server.address, timeout_s=120) as c:
        res = c.check("kv", hists, spec_kwargs=KW, deadline_s=90)
        assert res["ok"], res
        assert res["verdicts"] == want
        st = c.stats()["stats"]
    assert st["pcomp"]["enabled"]
    assert st["pcomp"]["split"] == len(hists)
    assert st["pcomp"]["sub_lanes"] > len(hists)
    assert any(b.get("pcomp_lanes") for b in res["batches"])
    assert any(b.get("model") == "register" for b in res["batches"])


def test_whole_history_key_banks_and_serves_duplicates(server):
    spec, hists, want = _corpus(n=4)
    with CheckClient(server.address, timeout_s=120) as c:
        r1 = c.check("kv", hists, spec_kwargs=KW, deadline_s=90)
        assert r1["verdicts"] == want
        r2 = c.check("kv", hists, spec_kwargs=KW, deadline_s=90)
    assert r2["verdicts"] == want
    assert all(r2["cached"]), r2["cached"]


def test_one_key_change_rechecks_one_key(server):
    spec, hists, _ = _corpus(n=2)
    h = hists[0]
    with CheckClient(server.address, timeout_s=120) as c:
        c.check("kv", [h], spec_kwargs=KW, deadline_s=90)
        st1 = c.stats()["stats"]["pcomp"]
        ops = list(h.ops)
        for j, op in enumerate(ops):
            if op.cmd == 1:
                ops[j] = dataclasses.replace(
                    op, arg=(op.arg - op.arg % 4) + ((op.arg % 4) + 1) % 4)
                break
        res = c.check("kv", [History(ops)], spec_kwargs=KW, deadline_s=90)
        assert res["ok"]
        st2 = c.stats()["stats"]["pcomp"]
    subs = st2["sub_lanes"] - st1["sub_lanes"]
    hits = st2["sub_cache_hits"] - st1["sub_cache_hits"]
    assert subs > 1
    assert subs - hits == 1, (subs, hits)  # exactly the touched key


def test_short_histories_check_whole(server):
    spec = KvSpec(**KW)
    hists = build_corpus(spec, (AtomicKvSUT,), n=4, n_pids=2, max_ops=8,
                         seed_base=9, seed_prefix="short")
    with CheckClient(server.address, timeout_s=60) as c:
        res = c.check("kv", hists, spec_kwargs=KW, deadline_s=45)
        assert res["ok"]
        st = c.stats()["stats"]["pcomp"]
    assert st["split"] == 0


def test_no_pcomp_flag_serves_whole():
    spec, hists, want = _corpus(n=4, ops=64)
    srv = _server(max_lanes=16, pcomp=False)
    try:
        with CheckClient(srv.address, timeout_s=120) as c:
            res = c.check("kv", hists, spec_kwargs=KW, deadline_s=90)
            assert res["ok"]
            assert res["verdicts"] == want
            st = c.stats()["stats"]["pcomp"]
        assert not st["enabled"]
        assert st["split"] == 0 and st["sub_lanes"] == 0
    finally:
        srv.stop()


def test_served_witness_is_stitched_and_verifies(server):
    spec, hists, want = _corpus(n=3)
    with CheckClient(server.address, timeout_s=180) as c:
        res = c.check("kv", hists, spec_kwargs=KW, witness=True,
                      deadline_s=150)
        st = c.stats()["stats"]["pcomp"]
    assert res["ok"], res
    assert res["verdicts"] == want
    assert st["split"] >= 1
    n_ok = 0
    for h, name, w in zip(hists, res["verdicts"], res["witnesses"]):
        if name == VERDICT_NAMES[int(Verdict.LINEARIZABLE)]:
            assert w is not None
            assert verify_witness(spec, h, [tuple(p) for p in w])
            n_ok += 1
    assert n_ok, "witness sample vacuous"


def test_split_lanes_ride_the_worker_pool(tmp_path):
    spec, hists, want = _corpus(n=4)
    srv = _server(max_lanes=32, workers=2,
                  cache_path=str(tmp_path / "bank.jsonl"))
    try:
        with CheckClient(srv.address, timeout_s=180) as c:
            res = c.check("kv", hists, spec_kwargs=KW, deadline_s=150)
            assert res["ok"], res
            assert res["verdicts"] == want
            st = c.stats()["stats"]
        assert st["pcomp"]["split"] == len(hists)
        pool = st["pool"]
        assert sum(w.get("dispatches", 0)
                   for w in pool.get("workers", [])) > 0, pool
    finally:
        srv.stop()
