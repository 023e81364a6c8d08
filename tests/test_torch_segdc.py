"""The port's ``SegDC`` against the JAX package's (every case of
``tests/test_segdc.py``; the one marked slow stays slow): quiescent cuts,
frontier threading, pending ops in the final segment, verdicts equal to
the reference's and to the oracle's, and over ``TorchStepper(device=
"cpu")``, whose ``init_states`` makes ``device_final`` detected, the same
verdicts and segment counters (``segments_split``, ``segments_total``,
``final_states_device``, ``segments_native``, ``middle_nodes``) as
``SegDC`` over ``JaxTPU``.  Also: start states outside a shadow's bounds
defer to BUDGET_EXCEEDED, never a verdict; the sweep regime's finals start
from vector states.  Tolerance: exact everywhere."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu import (WingGongCPU as JOracle, generate_program,
                     overlapping_history, run_concurrent)
from qsm_tpu.core.history import sequential_history
from qsm_tpu.models import QueueSpec as JQueue
from qsm_tpu.models.queue import AtomicQueueSUT, RacyTwoPhaseQueueSUT
from qsm_tpu.models.register import (AtomicRegisterSUT,
                                     RacyCachedRegisterSUT,
                                     RegisterSpec as JRegister)
from qsm_tpu.ops import segdc as jseg
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.sched.scheduler import FaultPlan
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.models.register import RegisterSpec
from qsm_tpu_torch.ops import segdc as tseg
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

JR, TR = JRegister(n_values=5), RegisterSpec(n_values=5)
READ, WRITE = 0, 1
SEG_COUNTERS = ("segments_split", "segments_total", "final_states_device",
                "segments_native", "middle_nodes", "histories_seen")


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _register_corpus():
    return build_corpus(JR, (lambda _s: AtomicRegisterSUT(),
                             lambda _s: RacyCachedRegisterSUT()),
                        n=48, n_pids=2, max_ops=12, seed_base=5,
                        seed_prefix="segdc")


def _device_pair(jspec, tspec):
    """``SegDC`` over ``JaxTPU`` (its host compaction patched in, so that
    its counters are defined) and over ``TorchStepper(device="cpu")`` at
    ``JaxTPU``'s plan."""
    j = jseg.SegDC(jspec, make_inner=lambda s: JaxTPU(s))
    ji = j.inner
    ji._compact_carry = ji._compact_carry_host
    plan = dict(chunk_schedule=ji.CHUNK_SCHEDULE,
                batch_buckets=ji.BATCH_BUCKETS,
                slots_for_batch={b: ji._slots_for(b)
                                 for b in ji.BATCH_BUCKETS})
    t = tseg.SegDC(tspec, make_inner=lambda s: TorchStepper(
        s, device="cpu", **plan))
    return j, t


def _assert_same_segdc(j, t, jv, tv):
    assert np.array_equal(np.asarray(jv), tv)
    for k in SEG_COUNTERS:
        assert getattr(t, k) == getattr(j, k), k
    js, ts = j.search_stats().to_dict(), t.search_stats().to_dict()
    assert {**ts, "engine": js["engine"]} == js


def test_split_at_quiescent_cuts():
    cases = [
        (sequential_history([(0, WRITE, 3, 0), (1, READ, 0, 3)]), [1, 1]),
        (overlapping_history([(0, WRITE, 3, 0, 0, 5),
                              (1, READ, 0, 3, 1, 2)]), [2]),
        (overlapping_history([(0, WRITE, 3, -1, 0, 1 << 30),
                              (1, READ, 0, 3, 5, 6),
                              (1, READ, 0, 3, 8, 9)]), [3]),
    ]
    for h, want in cases:
        got = tseg.split_at_quiescent_cuts(_port([h])[0])
        assert [len(s) for s in got] == want
        ref = jseg.split_at_quiescent_cuts(h)
        assert [[(o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
                  o.response_time) for o in s] for s in got] == \
            [[(o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
               o.response_time) for o in s] for s in ref]


def test_frontier_threads_ambiguous_segment_state():
    seg1 = [(0, WRITE, 1, 0, 0, 10), (1, WRITE, 2, 0, 1, 9)]
    for read_val, expect in ((1, Verdict.LINEARIZABLE),
                             (2, Verdict.LINEARIZABLE),
                             (3, Verdict.VIOLATION)):
        h = overlapping_history(seg1 + [(0, READ, 0, read_val, 20, 21)])
        th = _port([h])[0]
        assert len(tseg.split_at_quiescent_cuts(th)) == 2
        backend = tseg.SegDC(TR)
        got = backend.check_histories(TR, [th])[0]
        assert got == int(expect) == jseg.SegDC(JR).check_histories(
            JR, [h])[0]
        assert backend.segments_split == 1
        assert WingGongCPU().check_histories(TR, [th])[0] == int(expect)


def test_pending_op_in_final_segment():
    base = [(0, WRITE, 1, 0, 0, 1)]
    pend = [(0, WRITE, 4, -1, 10, 1 << 30)]
    for read_val, expect in ((1, Verdict.LINEARIZABLE),
                             (4, Verdict.LINEARIZABLE),
                             (2, Verdict.VIOLATION)):
        h = overlapping_history(base + pend + [(1, READ, 0, read_val,
                                                20, 21)])
        th = _port([h])[0]
        assert len(tseg.split_at_quiescent_cuts(th)) >= 2
        got = tseg.SegDC(TR).check_histories(TR, [th])[0]
        assert got == int(expect)
        _, t = _device_pair(JR, TR)
        assert t.check_histories(TR, [th])[0] == int(expect)


def test_queue48_corpus_parity_zero_undecided():
    spec, tspec = JQueue(), QueueSpec()
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=64, n_pids=8, max_ops=48, seed_base=1000,
                          seed_prefix="bench")
    ref = jseg.SegDC(spec)
    backend = tseg.SegDC(tspec)
    got = backend.check_histories(tspec, _port(corpus))
    want = ref.check_histories(spec, corpus)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, JOracle(memo=True).check_histories(spec, corpus))
    assert int((got == int(Verdict.BUDGET_EXCEEDED)).sum()) == 0
    assert (got == int(Verdict.VIOLATION)).any()
    assert (got == int(Verdict.LINEARIZABLE)).any()
    for k in ("segments_split", "segments_total", "segments_native",
              "middle_nodes"):
        assert getattr(backend, k) == getattr(ref, k), k


@pytest.mark.slow
def test_queue48_final_segments_decided_on_device_backend():
    spec, tspec = JQueue(), QueueSpec()
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=32, n_pids=8, max_ops=48, seed_base=1000,
                          seed_prefix="bench")
    j, t = _device_pair(spec, tspec)
    assert t.device_final
    jv = j.check_histories(spec, corpus)
    tv = t.check_histories(tspec, _port(corpus))
    _assert_same_segdc(j, t, jv, tv)
    want = JOracle(memo=True).check_histories(spec, corpus)
    decided = tv != int(Verdict.BUDGET_EXCEEDED)
    np.testing.assert_array_equal(tv[decided], np.asarray(want)[decided])
    assert t.segments_split > 0 and t.final_states_device > 0
    assert t.inner.device_histories > 0


def test_segdc_device_final_matches_oracle_final_on_register():
    corpus = _register_corpus()
    tc = _port(corpus)
    host = tseg.SegDC(TR)
    j, t = _device_pair(JR, TR)
    assert t.device_final and not host.device_final
    tv = t.check_histories(TR, tc)
    np.testing.assert_array_equal(host.check_histories(TR, tc), tv)
    _assert_same_segdc(j, t, j.check_histories(JR, corpus), tv)
    assert t.final_states_device > 0


def test_low_concurrency_register_corpus_parity():
    corpus = _register_corpus()
    backend = tseg.SegDC(TR)
    got = backend.check_histories(TR, _port(corpus))
    np.testing.assert_array_equal(
        got, JOracle(memo=True).check_histories(JR, corpus))
    np.testing.assert_array_equal(
        got, jseg.SegDC(JR).check_histories(JR, corpus))
    assert backend.segments_split > 0


def test_device_final_segments_with_pending_ops():
    hists = []
    for seed in range(32):
        prog = generate_program(JR, seed=seed, n_pids=2, max_ops=12)
        sut = (AtomicRegisterSUT if seed % 2 else RacyCachedRegisterSUT)()
        hists.append(run_concurrent(
            sut, prog, seed=f"sp{seed}",
            faults=FaultPlan(p_drop=0.25, p_duplicate=0.1)))
    assert any(h.n_pending for h in hists)
    th = _port(hists)
    j, t = _device_pair(JR, TR)
    tv = t.check_histories(TR, th)
    np.testing.assert_array_equal(tv, tseg.SegDC(TR).check_histories(TR, th))
    _assert_same_segdc(j, t, j.check_histories(JR, hists), tv)
    assert t.final_states_device > 0


def test_start_states_outside_the_shadow_defer():
    """A frontier state outside the element bounds of the queue's shadow
    is deferred by ``TorchStepper`` (BUDGET_EXCEEDED) rather than packed
    onto another state; ``SegDC``'s fold keeps it undecided unless
    another frontier state succeeds."""
    spec = QueueSpec()
    t = TorchStepper(spec, device="cpu")
    h = _port(build_corpus(JQueue(), (AtomicQueueSUT,), n=1, n_pids=2,
                           max_ops=6, seed_base=3, seed_prefix="x"))[0]
    bad = np.full(spec.STATE_DIM, 10 ** 6, np.int32)
    assert t.check_histories(spec, [h], init_states=[bad])[0] == \
        int(Verdict.BUDGET_EXCEEDED)
    assert t.deferred_out_of_domain == 1
    seg = tseg.SegDC(spec, make_inner=lambda s: t)
    out = np.empty(1, np.int8)
    seg._resolve_finals_device(spec, [(0, h, [tuple(bad)])], out)
    assert out[0] == int(Verdict.BUDGET_EXCEEDED)


def test_sweep_regime_finals_start_from_vector_states():
    """A KV map of 16 keys takes the sweep regime: ``SegDC`` over
    ``TorchStepper`` sends its final segments to the sweep from vector
    frontier states, and agrees with ``SegDC`` over ``JaxTPU`` (verdicts
    and counters) and with the oracle."""
    from qsm_tpu.models import AtomicKvSUT, KvSpec as JKv, StaleCacheKvSUT
    from qsm_tpu_torch.models.kv import KvSpec

    jspec, tspec = JKv(n_keys=16, n_values=4), KvSpec(n_keys=16, n_values=4)
    corpus = build_corpus(jspec, (AtomicKvSUT, StaleCacheKvSUT), n=16,
                          n_pids=2, max_ops=12, seed_base=7,
                          seed_prefix="segkv")
    j, t = _device_pair(jspec, tspec)
    assert t.inner.regime == "sweep"
    tv = t.check_histories(tspec, _port(corpus))
    _assert_same_segdc(j, t, j.check_histories(jspec, corpus), tv)
    assert t.final_states_device > 0
    np.testing.assert_array_equal(
        tv, JOracle(memo=True).check_histories(jspec, corpus))


def test_native_middles_equal_the_python_walk():
    """The SegDC half of the reference's native end-state case: ``SegDC``
    with ``CppOracle`` as inner and middle oracle gives the host
    ``SegDC``'s verdicts on the queue-48 corpus while enumerating middles
    natively, with the counters of the reference's native ``SegDC``."""
    from qsm_tpu.native import CppOracle as JCpp
    from qsm_tpu_torch.native import CppOracle, native_available

    if not native_available():
        pytest.skip("the native oracle did not build here")
    spec, tspec = JQueue(), QueueSpec()
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=48, n_pids=8, max_ops=48, seed_base=1000,
                          seed_prefix="bench")
    tc = _port(corpus)
    cpp, jcpp = CppOracle(tspec), JCpp(spec)
    host = tseg.SegDC(tspec, oracle=WingGongCPU(memo=True))
    nat = tseg.SegDC(tspec, make_inner=lambda s: cpp, oracle=cpp)
    ref = jseg.SegDC(spec, make_inner=lambda s: jcpp, oracle=jcpp)
    got = nat.check_histories(tspec, tc)
    np.testing.assert_array_equal(got, host.check_histories(tspec, tc))
    np.testing.assert_array_equal(got, ref.check_histories(spec, corpus))
    assert nat.segments_native == ref.segments_native > 0
    assert nat.middle_nodes == ref.middle_nodes
    assert not nat.device_final or nat.final_states_device == \
        ref.final_states_device


def test_frontier_start_past_segment_bound_is_exact():
    """The SegDC half of the reference's ticket case: a frontier state
    past the final segment's from-initial bound is covered by the native
    table, and the native ``SegDC`` agrees with the host one."""
    from qsm_tpu_torch.models.counter import TicketSpec
    from qsm_tpu_torch.native import CppOracle, native_available

    if not native_available():
        pytest.skip("the native oracle did not build here")
    tspec = TicketSpec(n_tickets=32)
    TAKE = 0
    ops = [(0, TAKE, 0, i, 2 * i, 2 * i + 1) for i in range(10)]
    good = overlapping_history(ops + [(1, TAKE, 0, 10, 100, 101)])
    bad = overlapping_history(ops + [(1, TAKE, 0, 3, 100, 101)])
    tgood, tbad = _port([good, bad])
    assert len(tseg.split_at_quiescent_cuts(tgood)) == 11
    cpp = CppOracle(tspec)
    host = tseg.SegDC(tspec, oracle=WingGongCPU(memo=True))
    nat = tseg.SegDC(tspec, make_inner=lambda s: cpp, oracle=cpp)
    for h, want in ((tgood, Verdict.LINEARIZABLE),
                    (tbad, Verdict.VIOLATION)):
        assert nat.check_histories(tspec, [h])[0] == \
            host.check_histories(tspec, [h])[0] == int(want)
    assert nat.segments_native > 0
