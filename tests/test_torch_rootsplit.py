"""The port's root splitting against the JAX package's (every case of
``tests/test_rootsplit.py``): children (rows and states) equal to the
reference's ``split_history`` at depths 1 and 2, all-roots-die,
deduplication, pending histories routed whole, and ``RootSplit`` verdicts
equal to the reference's through a host inner and through
``TorchStepper(device="cpu")`` (eager and escalation), with the same
``split_histories`` / ``children_checked``.  Tolerance: exact."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu import (WingGongCPU as JOracle, generate_program,
                     run_concurrent, sequential_history)
from qsm_tpu.core.history import History as JHistory, Op as JOp
from qsm_tpu.models.cas import AtomicCasSUT, CasSpec as JCas, RacyCasSUT
from qsm_tpu.models.register import READ, WRITE, RegisterSpec as JRegister
from qsm_tpu.ops import rootsplit as jrs
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.register import RegisterSpec
from qsm_tpu_torch.ops import rootsplit as trs
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

JSPEC, TSPEC = JCas(n_values=5), CasSpec(n_values=5)
JR, TR = JRegister(n_values=5), RegisterSpec(n_values=5)


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _corpus(n=40, n_pids=8, max_ops=24):
    hists = []
    for seed in range(n // 2):
        prog = generate_program(JSPEC, seed=seed, n_pids=n_pids,
                                max_ops=max_ops)
        for sut in (AtomicCasSUT(JSPEC), RacyCasSUT(JSPEC)):
            hists.append(run_concurrent(sut, prog, seed=f"rs{seed}"))
    return hists


def _kids(kids):
    return (None if kids is None
            else [(history_to_rows(h), s) for h, s in kids])


def _same_split(jspec, tspec, h, **kw):
    want = _kids(jrs.split_history(jspec, h, **kw))
    got = _kids(trs.split_history(tspec, _port([h])[0], **kw))
    assert got == want
    return got


def _stepper_like(j, **kw):
    """``TorchStepper(device="cpu")`` at ``JaxTPU``'s plan."""
    return TorchStepper(TSPEC, device="cpu", chunk_schedule=j.CHUNK_SCHEDULE,
                        batch_buckets=j.BATCH_BUCKETS,
                        slots_for_batch={b: j._slots_for(b)
                                         for b in j.BATCH_BUCKETS}, **kw)


def test_split_children_are_first_choice_partition():
    h = JHistory([JOp(0, WRITE, 3, 0, 0, 5), JOp(1, READ, 0, 0, 1, 2)])
    kids = _same_split(JR, TR, h, depth=1)
    assert kids is not None and len(kids) == 2
    assert all(len(k) == 1 for k, _ in kids)
    assert sorted(s for _, s in kids) == [(0,), (3,)]
    h2 = sequential_history([(0, WRITE, 2, 0), (0, READ, 0, 2)])
    kids2 = _same_split(JR, TR, h2, depth=1)
    assert kids2 is not None and len(kids2) == 1


def test_split_all_roots_die_is_violation():
    h = sequential_history([(0, READ, 0, 4)])
    assert _same_split(JR, TR, h, depth=1) == []
    rs = trs.RootSplit(TR, WingGongCPU(memo=True), min_ops=0, eager=True)
    assert rs.check_histories(TR, _port([h]))[0] == int(Verdict.VIOLATION)
    assert rs.split_histories == 1


def test_split_depth2_dedupes_permutations():
    h = JHistory([JOp(0, READ, 0, 0, 0, 5), JOp(1, READ, 0, 0, 1, 4)])
    kids = _same_split(JR, TR, h, depth=2)
    assert kids is not None and len(kids) == 1


def test_pending_histories_route_whole():
    h = JHistory([JOp(0, WRITE, 1, -1, 0, 1 << 30),
                  JOp(1, READ, 0, 1, 2, 3)])
    assert _same_split(JR, TR, h, depth=1) is None
    rs = trs.RootSplit(TR, WingGongCPU(memo=True), min_ops=0, eager=True)
    want = JOracle().check_histories(JR, [h])
    np.testing.assert_array_equal(rs.check_histories(TR, _port([h])), want)


@pytest.mark.parametrize("depth", [1, 2])
def test_rootsplit_parity_host_inner_eager(depth):
    hists = _corpus()
    want = JOracle(memo=True).check_histories(JSPEC, hists)
    for h in hists[:6]:
        _same_split(JSPEC, TSPEC, h, depth=depth)
    ref = jrs.RootSplit(JSPEC, JOracle(memo=True), depth=depth, min_ops=0,
                        eager=True)
    rs = trs.RootSplit(TSPEC, WingGongCPU(memo=True), depth=depth,
                       min_ops=0, eager=True)
    got = rs.check_histories(TSPEC, _port(hists))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.check_histories(JSPEC, hists))
    assert (rs.split_histories, rs.children_checked) == \
        (ref.split_histories, ref.children_checked)
    assert rs.split_histories > 0 and rs.children_checked > 0
    assert (want == int(Verdict.VIOLATION)).any()
    assert (want == int(Verdict.LINEARIZABLE)).any()


def test_rootsplit_parity_device_inner_eager():
    hists = _corpus(n=20, max_ops=20)
    want = JOracle(memo=True).check_histories(JSPEC, hists)
    j = JaxTPU(JSPEC)
    j._compact_carry = j._compact_carry_host
    ref = jrs.RootSplit(JSPEC, j, depth=1, min_ops=0, eager=True)
    rs = trs.RootSplit(TSPEC, _stepper_like(j), depth=1, min_ops=0,
                       eager=True)
    got = rs.check_histories(TSPEC, _port(hists))
    np.testing.assert_array_equal(got, ref.check_histories(JSPEC, hists))
    undecided = got == int(Verdict.BUDGET_EXCEEDED)
    np.testing.assert_array_equal(got[~undecided], want[~undecided])
    assert (~undecided).sum() >= 0.9 * len(hists)
    assert rs.split_histories > 0
    assert rs.children_checked == ref.children_checked
    assert rs.inner.lockstep_cost == j.lockstep_cost


def test_rootsplit_escalation_rescues_budget_lanes():
    hists = _corpus(n=40, max_ops=24)
    want = JOracle(memo=True).check_histories(JSPEC, hists)
    starve = dict(budget=150, mid_budget=0, rescue_budget=0)
    j = JaxTPU(JSPEC, **starve)
    plain = _stepper_like(j, **starve).check_histories(TSPEC, _port(hists))
    n_undecided_plain = int((plain == int(Verdict.BUDGET_EXCEEDED)).sum())
    assert n_undecided_plain > 0

    j._compact_carry = j._compact_carry_host
    ref = jrs.RootSplit(JSPEC, j, depth=1)
    rs = trs.RootSplit(TSPEC, _stepper_like(j, **starve), depth=1)
    got = rs.check_histories(TSPEC, _port(hists))
    np.testing.assert_array_equal(got, ref.check_histories(JSPEC, hists))
    undecided = got == int(Verdict.BUDGET_EXCEEDED)
    np.testing.assert_array_equal(got[~undecided], want[~undecided])
    assert int(undecided.sum()) < n_undecided_plain
    assert rs.split_histories == ref.split_histories > 0
    assert rs.children_checked == ref.children_checked
