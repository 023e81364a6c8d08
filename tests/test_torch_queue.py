"""The port's FIFO queue against the JAX package's: ``step_torch`` equal to
``step_jax`` and ``step_py`` exhaustively over the in-bound states, the
same histories from both packages' schedulers for the same seeds, and the
golden duplicate dequeue rejected by every checker of the port."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qsm_tpu.models.queue as jq
from qsm_tpu.core.history import overlapping_history as j_overlapping_history
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle
from qsm_tpu.utils.corpus import build_corpus as j_build_corpus
from qsm_tpu_torch.core.history import overlapping_history
from qsm_tpu_torch.models import queue as tq
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.corpus import build_corpus as t_build_corpus
from qsm_tpu_torch.utils.interop import history_to_rows


def _grid(spec):
    """Every in-bound state vector × cmd × arg × resp (resps one past each
    side of the domain), as numpy columns."""
    states, cmds, args, resps = [], [], [], []
    for vec in itertools.product(*(range(b)
                                   for b in spec.state_elem_bounds())):
        for c, sig in enumerate(spec.CMDS):
            for a, r in itertools.product(range(sig.n_args),
                                          range(-1, sig.n_resps + 1)):
                states.append(vec)
                cmds.append(c)
                args.append(a)
                resps.append(r)
    return (np.asarray(states, np.int32), *(np.asarray(x, np.int32)
                                            for x in (cmds, args, resps)))


@pytest.mark.parametrize("cap,nv", [(4, 4), (3, 2)])
def test_step_torch_equals_step_jax_and_step_py(cap, nv):
    spec, jspec = tq.QueueSpec(cap, nv), jq.QueueSpec(cap, nv)
    st, cmd, arg, resp = _grid(spec)
    tn, tok = spec.step_torch(*(torch.from_numpy(x)
                                for x in (st, cmd, arg, resp)))
    assert tn.dtype == torch.int32 and tok.dtype == torch.bool
    jn, jok = jax.vmap(jspec.step_jax)(*(jnp.asarray(x)
                                         for x in (st, cmd, arg, resp)))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    for i in range(0, len(cmd), 5):
        want_s, want_ok = spec.step_py(list(st[i]), int(cmd[i]), int(arg[i]),
                                       int(resp[i]))
        assert list(tn[i].tolist()) == list(want_s)
        assert bool(tok[i]) == bool(want_ok)


@pytest.mark.parametrize("pids,ops", [(8, 48), (3, 12)])
def test_both_schedulers_give_the_same_histories(pids, ops):
    kw = dict(n=24, n_pids=pids, max_ops=ops, seed_base=1000,
              seed_prefix="bench", complete=False)
    jh = j_build_corpus(jq.QueueSpec(), (jq.AtomicQueueSUT,
                                         jq.RacyTwoPhaseQueueSUT), **kw)
    th = t_build_corpus(tq.QueueSpec(), (tq.AtomicQueueSUT,
                                         tq.RacyTwoPhaseQueueSUT), **kw)
    assert [history_to_rows(h) for h in th] == [history_to_rows(h)
                                                for h in jh]
    assert max(len(h) for h in th) > ops // 2


def test_golden_duplicate_dequeue_is_rejected():
    """ENQ(1) returns, then two overlapping DEQs both return 1: one value
    delivered twice, never linearizable."""
    rows = [(0, tq.ENQ, 1, tq.OK, 0, 1),
            (1, tq.DEQ, 0, 1, 2, 5),
            (2, tq.DEQ, 0, 1, 3, 6)]
    spec, h = tq.QueueSpec(), overlapping_history(rows)
    assert JOracle(memo=True).check_histories(
        jq.QueueSpec(), [j_overlapping_history(rows)]).tolist() == [
            int(Verdict.VIOLATION)]
    assert WingGongCPU(memo=True).check_histories(spec, [h]).tolist() == [
        int(Verdict.VIOLATION)]
    t = TorchStepper(spec, device="cpu")
    assert t.check_witness(spec, h) == (Verdict.VIOLATION, None)
    # one DEQ taking the value and the other finding the queue empty is
    # linearizable
    ok = overlapping_history(rows[:2] + [(2, tq.DEQ, 0, tq.QueueSpec().EMPTY,
                                          3, 6)])
    v, wit = t.check_witness(spec, ok)
    assert v == Verdict.LINEARIZABLE
    assert verify_witness(spec, ok, wit)
