"""Twin of the reference's golden-history oracle tests
(``tests/test_oracle.py:22-114``): the port's ``WingGongCPU`` on the same
small hand-written register histories gives the known verdicts, each
equal to the reference oracle's."""

from __future__ import annotations

import numpy as np
import pytest

import qsm_tpu as J
from qsm_tpu.models.register import RegisterSpec as JRegister
from qsm_tpu_torch import (History, Op, Verdict, WingGongCPU, check_one,
                           overlapping_history, sequential_history)
from qsm_tpu_torch.models.register import READ, WRITE, RegisterSpec

SPEC, JSPEC = RegisterSpec(n_values=5), JRegister(n_values=5)
PENDING = 10 ** 9
LIN, VIO = Verdict.LINEARIZABLE, Verdict.VIOLATION

# name -> (how the history is built, its rows, the known verdict)
GOLDEN = {
    "empty": ("ops", [], LIN),
    "sequential valid": ("seq", [(0, WRITE, 3, 0), (0, READ, 0, 3),
                                 (1, WRITE, 1, 0), (1, READ, 0, 1)], LIN),
    "sequential stale read": ("seq", [(0, WRITE, 3, 0), (1, READ, 0, 0)],
                              VIO),
    "read during write sees old": ("overlap", [(0, WRITE, 3, 0, 0, 5),
                                               (1, READ, 0, 0, 1, 2)], LIN),
    "read during write sees new": ("overlap", [(0, WRITE, 3, 0, 0, 5),
                                               (1, READ, 0, 3, 1, 2)], LIN),
    "read of a value never written": ("overlap", [(0, WRITE, 3, 0, 0, 5),
                                                  (1, READ, 0, 2, 1, 2)],
                                      VIO),
    "new-old inversion": ("overlap", [(0, WRITE, 3, 0, 0, 7),
                                      (1, READ, 0, 3, 1, 2),
                                      (1, READ, 0, 0, 3, 4)], VIO),
    "old then new": ("overlap", [(0, WRITE, 3, 0, 0, 7),
                                 (1, READ, 0, 0, 1, 2),
                                 (1, READ, 0, 3, 3, 4)], LIN),
    "real-time order respected": ("overlap", [(1, READ, 0, 3, 0, 1),
                                              (0, WRITE, 3, 0, 2, 3)], VIO),
    "pending write pruned": ("ops", [(0, WRITE, 1, -1, 0, PENDING),
                                     (1, READ, 0, 0, 2, 3)], LIN),
    "pending write took effect": ("ops", [(0, WRITE, 1, -1, 0, PENDING),
                                          (1, READ, 0, 1, 2, 3)], LIN),
    "pending write, a value never written": ("ops", [
        (0, WRITE, 1, -1, 0, PENDING), (1, READ, 0, 4, 2, 3)], VIO),
}


def _build(pkg, how, rows):
    if how == "seq":
        return pkg.sequential_history(rows)
    if how == "overlap":
        return pkg.overlapping_history(rows)
    return pkg.History([pkg.Op(*r[:4], invoke_time=r[4],
                               response_time=r[5]) for r in rows])


class _Port:
    History, Op = History, Op
    sequential_history = staticmethod(sequential_history)
    overlapping_history = staticmethod(overlapping_history)


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_history_verdicts(name):
    how, rows, want = GOLDEN[name]
    got = check_one(WingGongCPU(), SPEC, _build(_Port, how, rows))
    ref = J.check_one(J.WingGongCPU(), JSPEC, _build(J, how, rows))
    assert got == want and int(ref) == int(want), name


def test_budget_exceeded_reported():
    rows = [(0, WRITE, i % 5, 0) for i in range(10)]
    assert check_one(WingGongCPU(node_budget=3), SPEC,
                     sequential_history(rows)) == Verdict.BUDGET_EXCEEDED
    assert int(J.check_one(J.WingGongCPU(node_budget=3), JSPEC,
                           J.sequential_history(rows))) == int(
        Verdict.BUDGET_EXCEEDED)


def test_batch_api_shapes():
    hs = [sequential_history([(0, WRITE, 1, 0)]),
          sequential_history([(0, READ, 0, 4)])]
    out = WingGongCPU().check_histories(SPEC, hs)
    assert out.dtype == np.int8
    assert list(out) == [Verdict.LINEARIZABLE, Verdict.VIOLATION]
