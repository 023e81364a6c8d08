"""Twins of the reference's advisor regressions (``tests/test_advice_r2.py``
``:22``, ``:116``, ``:133`` and ``tests/test_advice_r3.py`` ``:25``,
``:46``, ``:56``) on the port:

* a reused ``Scheduler`` counts its deliveries from zero again;
* a CAS spec whose state bound lies defers (BUDGET_EXCEEDED) in the table
  regime, as ``JaxTPU`` does, instead of a clamped, wrong verdict; with
  its bound withheld it takes the sweep regime's generic route, which has
  no bound to trust, and decides it as ``JaxTPU``'s vmapped step does; a
  truthful bound is unaffected in both regimes;
* ``history_from_rows`` reads a row with a response but no response time
  as a pending op;
* a schedule script whose choices pass the branching factor is flagged
  as clamped, an in-range one is not."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu.core.history import sequential_history as j_sequential
from qsm_tpu.models.cas import CasSpec as JCas
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu_torch import Program, Verdict, WingGongCPU, run_concurrent
from qsm_tpu_torch import sequential_history
from qsm_tpu_torch.core.generator import ProgOp
from qsm_tpu_torch.models.cas import WRITE, CasSpec
from qsm_tpu_torch.models.register import WRITE as REG_WRITE
from qsm_tpu_torch.models.register import AtomicRegisterSUT
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.sched.runner import PENDING_T
from qsm_tpu_torch.sched.scheduler import Recv, Scheduler, Send
from qsm_tpu_torch.utils.report import history_from_rows


def test_scheduler_reuse_resets_delivery_clock():
    def ping(n):
        for _ in range(n):
            yield Send("echo", "hi")
            yield Recv()

    def echo():
        while True:
            msg = yield Recv()
            yield Send(msg.src, msg.payload)

    sched = Scheduler(seed=1)
    sched.spawn("client", ping(3))
    sched.spawn("echo", echo(), daemon=True)
    sched.run()
    first = sched.n_delivered
    assert first > 0
    sched.procs.clear()
    sched.spawn("client", ping(3))
    sched.spawn("echo", echo(), daemon=True)
    sched.run()
    assert sched.n_delivered == first


class BrokenBoundCas(CasSpec):
    """Reachable states go up to n_values - 1; the bound claims 2."""

    def scalar_state_bound(self, n_ops):
        return 2


class JBrokenBoundCas(JCas):
    def scalar_state_bound(self, n_ops):
        return 2


class UnboundedCas(CasSpec):
    """The same CAS register with no bound declared: no step table, no
    kernel model, so the sweep regime's generic route."""

    def scalar_state_bound(self, n_ops):
        return None


class JUnboundedCas(JCas):
    def scalar_state_bound(self, n_ops):
        return None


STALE = [(0, WRITE, 3, 0), (0, 0, 0, 0)]   # write(3), then read -> 0
FRESH = [(0, WRITE, 3, 0), (0, 0, 0, 3)]   # write(3), then read -> 3


@pytest.mark.parametrize("port,ref,regime,route,want", [
    (BrokenBoundCas, JBrokenBoundCas, "table", None,
     Verdict.BUDGET_EXCEEDED),
    (UnboundedCas, JUnboundedCas, "sweep", "generic", Verdict.VIOLATION)])
def test_broken_state_bound_defers_instead_of_wrong_verdict(port, ref,
                                                            regime, route,
                                                            want):
    spec, jspec = port(), ref()
    t = TorchStepper(spec, device="cpu")
    assert (t.regime, t.sweep_route) == (regime, route)
    got = t.check_histories(spec, [sequential_history(STALE)])
    jgot = np.asarray(JaxTPU(jspec).check_histories(
        jspec, [j_sequential(STALE)]))
    assert got.tolist() == jgot.tolist() == [int(want)]
    # the oracle decides it: a violation under the true spec
    assert WingGongCPU().check_histories(
        spec, [sequential_history(STALE)])[0] == int(Verdict.VIOLATION)


@pytest.mark.parametrize("port,ref,regime", [(CasSpec, JCas, "table"),
                                             (UnboundedCas, JUnboundedCas,
                                              "sweep")])
def test_correct_state_bound_unaffected(port, ref, regime):
    spec, jspec = port(), ref()
    t = TorchStepper(spec, device="cpu")
    assert t.regime == regime
    got = t.check_histories(spec, [sequential_history(FRESH)])
    jgot = np.asarray(JaxTPU(jspec).check_histories(
        jspec, [j_sequential(FRESH)]))
    assert got.tolist() == jgot.tolist() == [int(Verdict.LINEARIZABLE)]


def test_history_from_rows_null_response_time_is_pending():
    h = history_from_rows([[0, 0, 0, 2, 0, 3], [1, 1, 4, 3, 1, None]])
    assert h.ops[0].resp == 2 and h.ops[0].response_time == 3
    assert h.ops[1].resp == -1
    assert h.ops[1].response_time == PENDING_T


def test_stale_schedule_script_reports_clamp():
    prog = Program((ProgOp(0, REG_WRITE, 1), ProgOp(1, REG_WRITE, 2)),
                   n_pids=2)
    info: dict = {}
    run_concurrent(AtomicRegisterSUT(), prog, seed="s",
                   choices=[99, 99, 99], sched_info=info)
    assert info["choice_clamped"] is True


def test_in_range_schedule_script_not_flagged():
    prog = Program((ProgOp(0, REG_WRITE, 1), ProgOp(1, REG_WRITE, 2)),
                   n_pids=2)
    info: dict = {}
    run_concurrent(AtomicRegisterSUT(), prog, seed="s",
                   choices=[0] * 64, sched_info=info)
    assert info["choice_clamped"] is False
