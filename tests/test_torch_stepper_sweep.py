"""``TorchStepper(device="cpu")`` in its sweep regime against the JAX
package's ``JaxTPU`` on specs too large for a table (a KV map of 9 keys, a
queue of capacity 8): at a shared plan (chunk schedule, bucket ladder,
memo slots a bucket, the host compaction) the same verdicts and the same
round, compaction and memo counters; LINEARIZABLE witnesses replay through
both packages' ``verify_witness``.  Out-of-domain histories are decided
on the device in this regime by both packages; the memo is sized by the
key's width; a spec without a kernel model takes the generic route on
CUDA."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qsm_tpu.core.history import History as JHistory
from qsm_tpu.core.history import Op as JOp
from qsm_tpu.models.kv import AtomicKvSUT, KvSpec as JKv, StaleCacheKvSUT
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec as JQueue,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.spec import CmdSig, Spec
from qsm_tpu_torch.models.kv import KvSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.backend import verify_witness as t_verify_witness
from qsm_tpu_torch.ops.stepper import (BATCH_BUCKETS, MEMO_BYTES,
                                       TorchStepper, default_slots)
from qsm_tpu_torch.ops.stepper_kernel import key_words
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

PLAN = dict(chunk_schedule=(48, 256, 2048), batch_buckets=(8, 32, 64),
            slots_for_batch={8: 256, 32: 64, 64: 0})
BUDGETS = dict(budget=1_000, mid_budget=2_000, rescue_budget=0)
COUNTERS = ("memo_prunes", "memo_inserts", "compactions", "rounds_run",
            "lockstep_cost", "rescued", "device_histories",
            "deferred_out_of_domain")


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _corpus(model: str, n: int, pids: int, ops: int):
    if model == "kv9":
        jspec, spec = JKv(n_keys=9), KvSpec(n_keys=9)
        suts = (AtomicKvSUT, StaleCacheKvSUT)
    else:
        jspec, spec = JQueue(capacity=8), QueueSpec(capacity=8)
        suts = (AtomicQueueSUT, RacyTwoPhaseQueueSUT)
    hs = build_corpus(jspec, suts, n=n, n_pids=pids, max_ops=ops,
                      seed_base=1000, seed_prefix="bench")
    return jspec, spec, hs


def _jax_with_plan(jspec):
    j = JaxTPU(jspec, **BUDGETS)
    j.CHUNK_SCHEDULE = PLAN["chunk_schedule"]
    j.BATCH_BUCKETS = PLAN["batch_buckets"]
    j.MAX_SLOTS_FOR_BATCH = PLAN["slots_for_batch"]
    j._compact_carry = j._compact_carry_host
    return j


@pytest.mark.parametrize("model,n,pids,ops", [("kv9", 40, 8, 40),
                                              ("queue8", 40, 8, 48)])
def test_sweep_regime_equals_jax_at_a_shared_plan(model, n, pids, ops):
    jspec, spec, hs = _corpus(model, n, pids, ops)
    j = _jax_with_plan(jspec)
    jv = np.asarray(j.check_histories(jspec, hs))
    t = TorchStepper(spec, device="cpu", **BUDGETS, **PLAN)
    assert t.regime == "sweep" and j.kspec is jspec
    tv = t.check_histories(spec, _port(hs))
    assert np.array_equal(jv, tv)
    for k in COUNTERS:
        assert getattr(t, k) == getattr(j, k), k
    assert t.compactions >= 1 and t.memo_inserts > 0
    ov = WingGongCPU(memo=True).check_histories(spec, _port(hs))
    decided = tv != Verdict.BUDGET_EXCEEDED
    assert np.array_equal(tv[decided], ov[decided])
    assert set(tv.tolist()) >= {int(Verdict.LINEARIZABLE)}
    # every LINEARIZABLE witness replays in both packages
    lin = [h for h, v in zip(hs, tv) if v == Verdict.LINEARIZABLE]
    for h in lin:
        ph = _port([h])[0]
        v, wit = t.check_witness(spec, ph)
        assert v == Verdict.LINEARIZABLE
        assert t_verify_witness(spec, ph, wit)
        assert j_verify_witness(jspec, h, wit)
        assert j.check_witness(jspec, h)[1] == wit  # the same search


def test_out_of_domain_history_is_decided_on_the_device():
    """``JaxTPU`` defers out-of-domain histories only when it tabulates;
    in the sweep regime both packages decide them on the device (a GET of
    key 20 on 16 keys reads key 15, as jnp indexing clamps)."""
    jspec, spec = JKv(n_keys=16), KvSpec(n_keys=16)
    rows = [[0, 1, spec.put_arg(15, 3), 0, 0, 1],   # PUT(15, 3)
            [1, 0, 20, 3, 2, 3],                    # GET(20) -> 3
            [1, 0, 20, 2, 4, 5]]                    # GET(20) -> 2
    hs = [history_from_rows(rows[:2]), history_from_rows(rows)]
    jhs = [JHistory([JOp(*r[:4], invoke_time=r[4], response_time=r[5])
                     for r in h]) for h in (rows[:2], rows)]
    plan = dict(chunk_schedule=(64,), batch_buckets=(8,),
                slots_for_batch={8: 64})
    t = TorchStepper(spec, device="cpu", **plan)
    j = JaxTPU(jspec)
    j.CHUNK_SCHEDULE, j.BATCH_BUCKETS = (64,), (8,)
    j.MAX_SLOTS_FOR_BATCH = {8: 64}
    tv = t.check_histories(spec, hs)
    jv = np.asarray(j.check_histories(jspec, jhs))
    assert tv.tolist() == jv.tolist() == [int(Verdict.LINEARIZABLE),
                                          int(Verdict.VIOLATION)]
    assert t.deferred_out_of_domain == j.deferred_out_of_domain == 0
    assert t.device_histories == 2
    v, wit = t.check_witness(spec, hs[0])
    assert v == Verdict.LINEARIZABLE and wit == j.check_witness(jspec,
                                                                 jhs[0])[1]
    # the table regime still defers such a history (KV at 4 keys)
    small = TorchStepper(KvSpec(), device="cpu", **plan)
    assert small.regime == "table"
    assert small.check_histories(small.spec, [history_from_rows(
        [[1, 0, 20, 0, 0, 1]])]).tolist() == [int(Verdict.BUDGET_EXCEEDED)]
    assert small.deferred_out_of_domain == 1


def test_memo_is_sized_by_the_key_width():
    """A 4096-lane KV batch of 16 keys keeps its memo within MEMO_BYTES
    at every op bucket; the table regime's slots are unchanged."""
    t = TorchStepper(KvSpec(n_keys=16), device="cpu")
    assert t.slots_for_batch == {32: 65536, 256: 32768, 1024: 8192,
                                 4096: 2048}
    for n_ops in (12, 64, 128):
        slot_bytes = 4 * (key_words(n_ops, 16) + 1)
        assert 4096 * t.slots_for_batch[4096] * slot_bytes <= MEMO_BYTES
    # kv16 at 64 ops: kw = 18, 76 bytes a slot, 637,534,208 bytes
    assert 4096 * 2048 * 4 * (key_words(64, 16) + 1) == 637_534_208
    assert [default_slots(b) for b in BATCH_BUCKETS] == [65536, 65536,
                                                         32768, 8192]


def test_a_spec_without_a_kernel_model_is_refused_on_cuda(monkeypatch):
    class Wide(Spec):  # a vector state without bounds or a kernel model
        name = "wide"
        STATE_DIM = 3
        CMDS = (CmdSig("noop", 1, 1),)

        def initial_state(self):
            return np.zeros(3, np.int32)

        def step_py(self, state, cmd, arg, resp):
            return list(state), resp == 0

        def step_torch(self, state, cmd, arg, resp):
            return state.expand(*cmd.shape, 3).to(torch.int32), resp == 0

    t = TorchStepper(Wide(), device="cpu")      # the plain version: fine
    assert t.regime == "sweep"
    h = history_from_rows([[0, 0, 0, 0, 0, 1], [1, 0, 0, 1, 2, 3]])
    assert t.check_histories(t.spec, [h]).tolist() == [
        int(Verdict.VIOLATION)]
    assert t.sweep_route == "generic"
    # on CUDA it is accepted too: the generic route, as for a kind's spec
    # wider than the kernel's 28 words
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for s in (Wide(), KvSpec(n_keys=29, n_values=2)):
        card = TorchStepper(s, device="cuda")
        assert (card.regime, card.sweep_route) == ("sweep", "generic")
    assert TorchStepper(KvSpec(n_keys=16), device="cpu").sweep_route == \
        "kernel"
