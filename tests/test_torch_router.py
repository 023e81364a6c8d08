"""The port's ``AutoDevice`` against the JAX package's (every case of
``tests/test_router.py``): ``_width`` equal, each history routed alike
(``routed_plain`` / ``routed_segdc``), verdicts equal to the reference
router's and to the oracle's wherever decided, per key first for a
projected spec, and ``search_stats()`` / ``resilience()`` through
``collect_resilience``.  The inner engine is ``TorchStepper(device=
"cpu")``.  Tolerance: exact."""

from __future__ import annotations

import numpy as np

from qsm_tpu import WingGongCPU as JOracle
from qsm_tpu.core.history import History as JHistory, Op as JOp
from qsm_tpu.models.cas import AtomicCasSUT, CasSpec as JCas, RacyCasSUT
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec as JQueue,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.ops import router as jrouter
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.ops import router as trouter
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.resilience.failover import collect_resilience
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

JSPEC, TSPEC = JCas(), CasSpec()


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _seq_ops(specs):
    ops, t = [], 0
    for pid, cmd, arg, resp in specs:
        ops.append(JOp(pid=pid, cmd=cmd, arg=arg, resp=resp,
                       invoke_time=t, response_time=t + 1))
        t += 2
    return ops


def _routers(jspec, tspec, **kw):
    return (jrouter.AutoDevice(jspec, **kw),
            trouter.AutoDevice(tspec, device="cpu", **kw))


def _same_routes(ja, ta, hs):
    for h, th in zip(hs, _port(hs)):
        assert ta._route_segdc(th) == ja._route_segdc(h)
        for js, ts in zip(jrouter.split_at_quiescent_cuts(h),
                          trouter.split_at_quiescent_cuts(th)):
            assert trouter._width(ts) == jrouter._width(js)


def test_router_parity_with_oracle_queue():
    spec, tspec = JQueue(), QueueSpec()
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=24, n_pids=4, max_ops=24, seed_base=77,
                          seed_prefix="router")
    ja, ta = _routers(spec, tspec, budget=2_000, mid_budget=10_000,
                      rescue_budget=100_000)
    _same_routes(ja, ta, corpus)
    got = ta.check_histories(tspec, _port(corpus))
    ref = np.asarray(ja.check_histories(spec, corpus))
    want = np.asarray(JOracle(memo=True).check_histories(spec, corpus))
    both = (got != 2) & (want != 2)
    assert both.any()
    assert ((got == want) | ~both).all()
    assert ((got == ref) | (got == 2) | (ref == 2)).all()
    assert (ta.routed_plain, ta.routed_segdc) == \
        (ja.routed_plain, ja.routed_segdc)
    assert ta.routed_plain + ta.routed_segdc == len(corpus)
    st = ta.search_stats()
    assert st.histories == len(corpus) and st.engine == ta.name
    assert collect_resilience(ta) == {"degradations": 0, "retries": 0,
                                      "fallback_engine": None}


def test_router_sends_shattered_histories_to_segdc():
    h = JHistory(_seq_ops([(0, 1, (i % 4) + 1, 0) for i in range(48)]))
    ja, ta = _routers(JSPEC, TSPEC)
    th = _port([h])[0]
    assert ta._route_segdc(th) and ja._route_segdc(h)
    v = ta.check_histories(TSPEC, [th])
    assert ta.routed_segdc == 1 and ta.routed_plain == 0
    assert v[0] == int(Verdict.LINEARIZABLE)
    assert ta.segdc.inner is ta.plain
    assert isinstance(ta.plain, TorchStepper)


def test_router_keeps_dense_histories_on_plain():
    ops = [JOp(pid=p, cmd=1, arg=1, resp=0, invoke_time=0,
               response_time=100 + p) for p in range(6)]
    h = JHistory(ops)
    ja, ta = _routers(JSPEC, TSPEC)
    assert not ta._route_segdc(_port([h])[0]) and not ja._route_segdc(h)
    ta.check_histories(TSPEC, _port([h]))
    assert ta.routed_plain == 1 and ta.routed_segdc == 0


def test_router_rejects_wide_middle_segments():
    block = [JOp(pid=p, cmd=1, arg=1, resp=0, invoke_time=1,
                 response_time=30 + p) for p in range(4)]
    block += [JOp(pid=4 + (i % 4), cmd=0, arg=0, resp=1, invoke_time=2 + i,
                  response_time=28 - i) for i in range(14)]
    tail = [JOp(pid=0, cmd=0, arg=0, resp=1, invoke_time=200 + 2 * i,
                response_time=201 + 2 * i) for i in range(4)]
    head = [JOp(pid=0, cmd=1, arg=1, resp=0, invoke_time=-10,
                response_time=-9)]
    h = JHistory(head + block + tail)
    ja, ta = _routers(JSPEC, TSPEC)
    assert len(h) > 18
    th = _port([h])[0]
    assert not ta._route_segdc(th) and not ja._route_segdc(h)
    _same_routes(ja, ta, [h])
    # the native middle enumerator raises the cap: the same in both
    assert ta._native_mid == ja._native_mid
    assert (trouter.AutoDevice.WIDTH_CAP,
            trouter.AutoDevice.NATIVE_WIDTH_CAP) == (
        jrouter.AutoDevice.WIDTH_CAP, jrouter.AutoDevice.NATIVE_WIDTH_CAP)


def test_router_decomposes_partitionable_specs():
    from qsm_tpu_torch.models.kv import KvSpec
    from qsm_tpu_torch.models.txn import TxnRegisterSpec

    auto = trouter.AutoDevice(KvSpec(n_keys=4), device="cpu")
    assert auto.pcomp is not None
    assert auto.name.startswith("auto(pcomp(auto(")
    # a refused declaration (txn's copy) routes whole histories
    txn = trouter.AutoDevice(TxnRegisterSpec(), device="cpu")
    assert txn.pcomp is None and txn.name.startswith("auto(")


def test_router_mixed_batch_verdicts_land_in_order():
    corpus = build_corpus(JSPEC, (AtomicCasSUT, RacyCasSUT), n=10,
                          n_pids=3, max_ops=12, seed_base=5,
                          seed_prefix="mix")
    corpus.insert(3, JHistory(_seq_ops(
        [(0, 1, (i % 4) + 1, 0) for i in range(48)])))
    ja, ta = _routers(JSPEC, TSPEC)
    _same_routes(ja, ta, corpus)
    got = ta.check_histories(TSPEC, _port(corpus))
    ref = np.asarray(ja.check_histories(JSPEC, corpus))
    oracle = JOracle(memo=True)
    for i, h in enumerate(corpus):
        want = oracle.check_histories(JSPEC, [h])[0]
        if got[i] != 2 and want != 2:
            assert got[i] == want, i
        if got[i] != 2 and ref[i] != 2:
            assert got[i] == ref[i], i
    assert (ta.routed_plain, ta.routed_segdc) == \
        (ja.routed_plain, ja.routed_segdc)
    assert ta.routed_segdc >= 1 and ta.routed_plain >= 1


def test_router_per_key_verdicts_equal_the_reference():
    """kv through the nested router: each key's sub-history routed by
    the projected spec's ``AutoDevice``; verdicts equal to the
    reference's router and to the per-key oracle."""
    from qsm_tpu.models import AtomicKvSUT, KvSpec as JKv, StaleCacheKvSUT
    from qsm_tpu_torch.models.kv import KvSpec
    from qsm_tpu_torch.ops.pcomp import PComp

    jspec, tspec = JKv(n_keys=4), KvSpec(n_keys=4)
    corpus = build_corpus(jspec, (AtomicKvSUT, StaleCacheKvSUT), n=16,
                          n_pids=4, max_ops=24, seed_base=9,
                          seed_prefix="routerkv")
    ja, ta = _routers(jspec, tspec)
    got = ta.check_histories(tspec, _port(corpus))
    assert np.array_equal(got, np.asarray(ja.check_histories(jspec, corpus)))
    assert np.array_equal(got, PComp(tspec).check_histories(
        tspec, _port(corpus)))
    inner = ta.pcomp.inner
    assert (inner.routed_plain, inner.routed_segdc) == \
        (ja.pcomp.inner.routed_plain, ja.pcomp.inner.routed_segdc)
    assert ta.search_stats().engine == ta.name
