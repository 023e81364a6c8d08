"""Twin of ``tests/test_witness.py::test_tampered_witnesses_rejected``:
the port's ``verify_witness`` refuses a reversed, wrong-response,
duplicated, short or postcondition-breaking witness, and accepts the
valid ones, exactly as the reference's does on the same histories."""

from __future__ import annotations

import pytest

from qsm_tpu.core.history import History as JHistory
from qsm_tpu.core.history import Op as JOp
from qsm_tpu.models.register import RegisterSpec as JRegister
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu_torch import History, Op, Verdict, WingGongCPU
from qsm_tpu_torch.models.register import WRITE, READ, RegisterSpec
from qsm_tpu_torch.ops.backend import verify_witness

SPEC, JSPEC = RegisterSpec(n_values=5), JRegister(n_values=5)
# write(3) completes, then a read sees 3
H = [(0, WRITE, 3, 0, 0, 1), (1, READ, 0, 3, 2, 3)]
# a read that claims 3 overlapping the write's response
H2 = [(0, WRITE, 3, 0, 0, 5), (1, READ, 0, 3, 1, 2)]


def _both(rows):
    return (History([Op(*r) for r in rows]),
            JHistory([JOp(*r[:4], invoke_time=r[4], response_time=r[5])
                      for r in rows]))


def test_the_oracles_witness_replays():
    h, jh = _both(H)
    v, w = WingGongCPU().check_witness(SPEC, h)
    assert v == Verdict.LINEARIZABLE
    assert verify_witness(SPEC, h, w) and j_verify_witness(JSPEC, jh, w)


@pytest.mark.parametrize("what,rows,witness,want", [
    ("reversed: the read before its real-time predecessor", H,
     [(1, 3), (0, 0)], False),
    ("a wrong response for a completed op", H, [(0, 1), (1, 3)], False),
    ("a duplicated op", H, [(0, 0), (0, 0)], False),
    ("a required op missing", H, [(0, 0)], False),
    ("a postcondition break: the read before the write", H2,
     [(1, 3), (0, 0)], False),
    ("the valid order of the same history", H2, [(0, 0), (1, 3)], True)])
def test_tampered_witnesses_rejected(what, rows, witness, want):
    h, jh = _both(rows)
    assert verify_witness(SPEC, h, witness) is want, what
    assert j_verify_witness(JSPEC, jh, witness) is want, what
