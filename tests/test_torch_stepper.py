"""``TorchStepper(device="cpu")`` (the kernels' plain versions) against the
JAX package's ``JaxTPU`` on queue and CAS corpora: the same verdicts and
witnesses that replay in both packages; with ``JaxTPU``'s plan handed in
(chunk schedule, bucket ladder, memo slots per bucket) and its host
compaction patched in, the same search counters; the host contracts
(start-state deferral, pending expansion, out-of-domain deferral, the split
at ``MAX_BATCH``); the CLI; no silent CPU."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from qsm_tpu.core.history import History as JHistory
from qsm_tpu.models.cas import AtomicCasSUT, CasSpec as JCas, RacyCasSUT
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec as JQueue,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.spec import CmdSig, Spec
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.ops.backend import BackendUnavailable, Verdict
from qsm_tpu_torch.ops.backend import verify_witness as t_verify_witness
from qsm_tpu_torch.ops.stepper import TorchStepper, default_slots
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.cli import main as cli_main
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

# a plan that runs every path of the driver on a small corpus: the widest
# bucket without a memo, then compactions out of ``slots = 0``, with the
# memo growing (a re-hash) as the bucket shrinks
PLAN = dict(chunk_schedule=(48, 256, 2048), batch_buckets=(8, 32, 64),
            slots_for_batch={8: 256, 32: 64, 64: 0})
BUDGETS = dict(budget=1_000, mid_budget=2_000, rescue_budget=0)


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _corpus(model: str, n: int, pids: int, ops: int):
    if model == "queue":
        jspec, spec = JQueue(), QueueSpec()
        suts = (AtomicQueueSUT, RacyTwoPhaseQueueSUT)
    else:
        jspec, spec = JCas(), CasSpec()
        suts = (AtomicCasSUT, RacyCasSUT)
    hs = build_corpus(jspec, suts, n=n, n_pids=pids, max_ops=ops,
                      seed_base=1000, seed_prefix="bench")
    return jspec, spec, hs


def _jax_with_plan(jspec, plan):
    j = JaxTPU(jspec, **BUDGETS)
    j.CHUNK_SCHEDULE = plan["chunk_schedule"]
    j.BATCH_BUCKETS = plan["batch_buckets"]
    j.MAX_SLOTS_FOR_BATCH = plan["slots_for_batch"]
    # the host reference compaction, whose collision winner is defined
    # (the device one scatters duplicates in an unspecified order)
    j._compact_carry = j._compact_carry_host
    return j


COUNTERS = ("memo_prunes", "memo_inserts", "compactions", "rounds_run",
            "lockstep_cost", "rescued", "device_histories")


@pytest.mark.parametrize("model,n,pids,ops", [("queue", 36, 8, 48),
                                              ("cas", 48, 6, 24)])
def test_counters_and_verdicts_equal_jax_at_a_shared_plan(model, n, pids,
                                                          ops):
    jspec, spec, hs = _corpus(model, n, pids, ops)
    j = _jax_with_plan(jspec, PLAN)
    jv = np.asarray(j.check_histories(jspec, hs))
    t = TorchStepper(spec, device="cpu", **BUDGETS, **PLAN)
    tv = t.check_histories(spec, _port(hs))
    assert np.array_equal(jv, tv)
    for k in COUNTERS:
        assert getattr(t, k) == getattr(j, k), k
    assert t.compactions >= 2 and t.memo_prunes > 0


def test_counters_equal_jax_at_its_own_plan():
    """JaxTPU's class plan: buckets (8, 64, 256, ...), memo slots
    min(MAX_SLOTS_FOR_BATCH, rescue_slots), chunks (256, 2048, ...)."""
    jspec, spec, hs = _corpus("queue", 72, 6, 24)
    j = JaxTPU(jspec, **BUDGETS)
    j._compact_carry = j._compact_carry_host
    jv = np.asarray(j.check_histories(jspec, hs))
    plan = dict(chunk_schedule=j.CHUNK_SCHEDULE,
                batch_buckets=j.BATCH_BUCKETS,
                slots_for_batch={b: j._slots_for(b) for b in j.BATCH_BUCKETS})
    t = TorchStepper(spec, device="cpu", **BUDGETS, **plan)
    tv = t.check_histories(spec, _port(hs))
    assert np.array_equal(jv, tv)
    for k in COUNTERS:
        assert getattr(t, k) == getattr(j, k), k


def test_verdicts_and_witnesses_match_jax_and_the_oracle():
    jspec, spec, hs = _corpus("queue", 24, 6, 40)
    t = TorchStepper(spec, device="cpu")
    tv = t.check_histories(spec, _port(hs))
    ov = WingGongCPU(memo=True).check_histories(spec, _port(hs))
    assert np.array_equal(tv, ov)
    assert set(tv.tolist()) == {0, 1}
    j = JaxTPU(jspec)
    lin = [h for h, v in zip(hs, tv) if v == Verdict.LINEARIZABLE][:6]
    for h in lin:
        v, wit = t.check_witness(spec, _port([h])[0])
        assert v == Verdict.LINEARIZABLE
        assert t_verify_witness(spec, _port([h])[0], wit)
        assert j_verify_witness(jspec, h, wit)
        assert j.check_witness(jspec, h)[1] == wit  # the same search
    bad = [h for h, v in zip(hs, tv) if v == Verdict.VIOLATION][0]
    assert t.check_witness(spec, _port([bad])[0]) == (Verdict.VIOLATION,
                                                      None)


def test_split_at_max_batch_pads_witnesses_across_parts():
    _, spec, hs = _corpus("cas", 12, 4, 24)
    short = [h for h in _port(hs) if len(h) <= 12][:3]
    flat = _port(hs)[:5] + short
    whole = TorchStepper(spec, device="cpu")
    split = TorchStepper(spec, device="cpu")
    split.MAX_BATCH = 4
    s1, c1 = whole._run_device(flat, collect_chosen=True)
    s2, c2 = split._run_device(flat, collect_chosen=True)
    assert np.array_equal(s1, s2)
    assert c2.shape == c1.shape == (len(flat), 25)
    assert np.array_equal(c1, c2)
    assert split.device_histories == len(flat)


def test_check_from_defers_out_of_bounds_start_states():
    spec = QueueSpec()
    h = history_from_rows([[0, 1, 0, 2, 0, 1]])  # DEQ -> 2
    t = TorchStepper(spec, device="cpu")
    assert t.check_from(spec, h, [1, 2, 0, 0, 0]) == Verdict.LINEARIZABLE
    assert t.check_from(spec, h, [1, 3, 0, 0, 0]) == Verdict.VIOLATION
    assert t.deferred_out_of_domain == 0
    for bad in ([1, 4, 0, 0, 0], [5, 0, 0, 0, 0], [-1, 0, 0, 0, 0]):
        assert t.check_from(spec, h, bad) == Verdict.BUDGET_EXCEEDED
    assert t.deferred_out_of_domain == 3


def test_out_of_domain_args_are_deferred():
    spec = QueueSpec()
    t = TorchStepper(spec, device="cpu")
    bad = history_from_rows([[0, 0, 9, 0, 0, 1]])  # ENQ(9): no such value
    good = history_from_rows([[0, 0, 1, 0, 0, 1]])
    v = t.check_histories(spec, [bad, good])
    assert v.tolist() == [int(Verdict.BUDGET_EXCEEDED),
                          int(Verdict.LINEARIZABLE)]
    assert t.deferred_out_of_domain == 1
    assert t.check_witness(spec, bad) == (Verdict.BUDGET_EXCEEDED, None)


def test_pending_ops_are_expanded_like_jax():
    jspec, spec, hs = _corpus("queue", 16, 4, 24)
    hs = build_corpus(jspec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT), n=16,
                      n_pids=4, max_ops=24, seed_base=7,
                      seed_prefix="pend", complete=False)
    # a pending op: the last op of every history never responded
    pend = [JHistory(h.ops[:-1] + [dataclasses.replace(
        h.ops[-1], resp=-1, response_time=10**9)]) for h in hs]
    jv = np.asarray(JaxTPU(jspec).check_histories(jspec, pend))
    t = TorchStepper(spec, device="cpu")
    assert np.array_equal(t.check_histories(spec, _port(pend)), jv)
    assert t.device_histories > len(pend)   # expanded into variants
    assert t.check_witness(spec, _port(pend)[0])[1] is None


def test_cli_convicts_racy_and_passes_atomic_queue(capsys):
    common = ["run", "--model", "queue", "--backend", "stepper",
              "--device", "cpu", "--pids", "3", "--ops", "12"]
    assert cli_main(common + ["--impl", "racy", "--trials", "60"]) == 1
    assert "FAIL: queue/racy" in capsys.readouterr().out
    assert cli_main(common + ["--impl", "atomic", "--trials", "10"]) == 0


def test_no_silent_cpu_and_no_sweep_regime(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        TorchStepper(QueueSpec())
    with pytest.raises(BackendUnavailable):
        cli_main(["run", "--model", "queue", "--backend", "stepper",
                  "--trials", "1"])

    class Wide(Spec):  # a vector state without element bounds
        name = "wide"
        STATE_DIM = 3
        CMDS = (CmdSig("noop", 1, 1),)

    with pytest.raises(ValueError, match="table regime"):
        TorchStepper(Wide(), device="cpu")


def test_default_memo_grows_as_the_bucket_shrinks():
    t = TorchStepper(QueueSpec(), device="cpu")
    slots = [t.slots_for_batch[b] for b in t.batch_buckets]
    assert slots == sorted(slots)[::-1] and len(set(slots)) > 1
    # within the memo's memory: 24 bytes a slot at N = 128
    assert all(b * default_slots(b) * 24 <= 1 << 30
               for b in t.batch_buckets)
