"""The port's chunked driver (``qsm_tpu_torch/ops/stepper.py::
TorchStepper``) against the JAX package's ``JaxTPU``: twins of
``tests/test_kernel_driver.py``, on the kernels' plain versions.

* The double-buffered tail: at a shared plan (chunk schedule, bucket
  ladder, memo slots a bucket, the reference's host compaction) the tail
  forced on in both packages gives the same verdicts, search counters,
  speculated and wasted chunks, in both regimes; on against off, the same
  verdicts, witnesses, iterations of every lane and counters, on one
  device and on a mesh of 4 logical host devices; auto is off on the CPU;
  the host's waits are accounted.
* Compaction: the driver's ``compact_carry`` against
  ``compact_carry_plain`` and both against the reference's device and
  host compactions; survivors out of a memo-less bucket get an empty memo.
* The sweep regime's lane check, counted on the stream, raises at the
  round's status read; a failure inside the tail raises and nothing runs
  the batch again.

``test_unroll_bit_identical_to_single_step`` has no twin: the port's
kernels have no unroll knob (ROADMAP.md §C, recorded differences), and
an unroll changes no verdict and no iteration count in the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qsm_tpu.models.cas import AtomicCasSUT, CasSpec as JCas, RacyCasSUT
from qsm_tpu.models.kv import AtomicKvSUT, KvSpec as JKv, StaleCacheKvSUT
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec as JQueue,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JWingGongCPU
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.mesh import batch_sharding, make_mesh
from qsm_tpu_torch.mesh import shards as shards_module
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.kv import KvSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.ops import stepper as stepper_module
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.stepper_kernel import compact_carry_plain
from qsm_tpu_torch.resilience.faults import InjectedFault
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

# every path of the driver on a small corpus: the widest bucket without a
# memo, compactions out of ``slots = 0`` and a re-hash as the memo grows
# (each wasting a speculative chunk), and a tail of 256-iteration chunks
# from the second round on (each consumed while the bucket holds)
PLAN = dict(chunk_schedule=(48, 256), batch_buckets=(8, 32, 64),
            slots_for_batch={8: 256, 32: 64, 64: 0})
BUDGETS = dict(budget=1_000, mid_budget=2_000, rescue_budget=0)
COUNTERS = ("memo_prunes", "memo_inserts", "compactions", "rounds_run",
            "lockstep_cost", "rescued", "device_histories")
TAIL = ("speculated_chunks", "wasted_chunks")
# (model, histories, pids, ops): the table regime (queue through its
# scalarized shadow, CAS) and the sweep regime (a KV map of 9 keys)
CORPORA = [("queue", 36, 8, 48), ("cas", 48, 6, 24), ("kv9", 24, 8, 40)]
SPEC = JCas()


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _corpus(model: str, n: int, pids: int, ops: int):
    jspec, spec, suts = {
        "queue": (JQueue(), QueueSpec(), (AtomicQueueSUT,
                                          RacyTwoPhaseQueueSUT)),
        "cas": (JCas(), CasSpec(), (AtomicCasSUT, RacyCasSUT)),
        "kv9": (JKv(n_keys=9), KvSpec(n_keys=9), (AtomicKvSUT,
                                                  StaleCacheKvSUT)),
    }[model]
    hs = build_corpus(jspec, suts, n=n, n_pids=pids, max_ops=ops,
                      seed_base=1000, seed_prefix="bench")
    return jspec, spec, hs


def _drv_corpus(n=48, ops=32):
    """``tests/test_kernel_driver.py``'s corpus, in both packages."""
    hs = build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=n, n_pids=8,
                      max_ops=ops, seed_base=1000, seed_prefix="drv")
    return hs, _port(hs)


def _jax_with_plan(jspec, plan, double_buffer):
    j = JaxTPU(jspec, **BUDGETS)
    j.CHUNK_SCHEDULE = plan["chunk_schedule"]
    j.BATCH_BUCKETS = plan["batch_buckets"]
    j.MAX_SLOTS_FOR_BATCH = plan["slots_for_batch"]
    j.DOUBLE_BUFFER = double_buffer  # forced: auto is off on the CPU
    # the host reference compaction, whose collision winner is defined
    j._compact_carry = j._compact_carry_host
    return j


def _lanes(t, hs):
    """Every lane's status, ``chosen`` stack and iterations."""
    status, chosen = t._run_device(hs, collect_chosen=True)
    return status, chosen, t.last_iters.copy()


@pytest.mark.parametrize("model,n,pids,ops", CORPORA)
def test_tail_equals_jax_at_a_shared_plan(model, n, pids, ops):
    jspec, spec, hs = _corpus(model, n, pids, ops)
    j = _jax_with_plan(jspec, PLAN, True)
    jv = np.asarray(j.check_histories(jspec, hs))
    t = TorchStepper(spec, device="cpu", double_buffer=True, **BUDGETS,
                     **PLAN)
    assert t.regime == ("sweep" if model == "kv9" else "table")
    tv = t.check_histories(spec, _port(hs))
    assert np.array_equal(jv, tv)
    for k in COUNTERS + TAIL:
        assert getattr(t, k) == getattr(j, k), k
    assert t.speculated_chunks > t.wasted_chunks > 0
    assert t.compactions >= 1


@pytest.mark.parametrize("model,n,pids,ops", CORPORA)
def test_tail_on_equals_off(model, n, pids, ops):
    """The speculative chunk IS the next round's work: verdicts, every
    lane's ``chosen`` and iterations, and every search counter equal the
    run without the tail; LINEARIZABLE witnesses replay."""
    _, spec, hs = _corpus(model, n, pids, ops)
    hs = [h for h in _port(hs) if h.n_pending == 0]
    runs = {}
    for db in (False, True):
        t = TorchStepper(spec, device="cpu", double_buffer=db, **BUDGETS,
                         **PLAN)
        runs[db] = (_lanes(t, hs), t)
    (off, t_off), (on, t_on) = runs[False], runs[True]
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    for k in COUNTERS:
        assert getattr(t_on, k) == getattr(t_off, k), k
    assert t_off.speculated_chunks == t_off.wasted_chunks == 0
    consumed = t_on.speculated_chunks - t_on.wasted_chunks
    assert t_on.speculated_chunks > 0 and 0 < consumed <= t_on.rounds_run
    lin = [h for h, v in zip(hs, on[0]) if v == Verdict.LINEARIZABLE][:4]
    assert lin
    for h in lin:
        v, wit = t_on.check_witness(spec, h)
        assert v == Verdict.LINEARIZABLE and verify_witness(spec, h, wit)
        assert (v, wit) == t_off.check_witness(spec, h)


@pytest.mark.parametrize("model,n,pids,ops", CORPORA[1:])
def test_tail_on_a_host_mesh_equals_one_device(model, n, pids, ops):
    """The tail on 4 logical host devices (the ladder divides by 4, so
    the bucket sequence is the unsharded one) against one device without
    it: every lane's status, ``chosen`` and iterations, and the search
    counters."""
    _, spec, hs = _corpus(model, n, pids, ops)
    hs = [h for h in _port(hs) if h.n_pending == 0]
    runs = []
    for db, sharding in ((False, None), (True, batch_sharding(
            make_mesh(4, device="cpu")))):
        t = TorchStepper(spec, device=None if sharding else "cpu",
                         double_buffer=db, sharding=sharding, **BUDGETS,
                         **PLAN)
        runs.append((_lanes(t, hs), t))
    (want, one), (got, four) = runs
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    for k in COUNTERS:
        assert getattr(four, k) == getattr(one, k), k
    assert four.speculated_chunks > four.wasted_chunks > 0
    assert four.lanes_crossed > 0


def test_double_buffer_auto_off_on_cpu():
    spec = CasSpec()
    assert TorchStepper(spec, device="cpu")._double_buffer_on() is False
    mesh = TorchStepper(spec, sharding=batch_sharding(
        make_mesh(4, device="cpu")))
    assert mesh._double_buffer_on() is False
    assert TorchStepper(spec, device="cpu",
                        double_buffer=True)._double_buffer_on() is True
    # the auto rule reads the stepper's device: on for CUDA
    t = TorchStepper(spec, device="cpu")
    t.device = torch.device("cuda", 0)
    assert t._double_buffer_on() is True
    t.double_buffer = False
    assert t._double_buffer_on() is False


def test_host_sync_accounting_accumulates():
    _, hs = _drv_corpus(n=16)
    b = TorchStepper(CasSpec(), device="cpu", **BUDGETS)
    b.check_histories(b.spec, hs)
    assert b.host_sync_s > 0.0
    assert b.rounds_run > 0
    before = b.host_sync_s
    b.check_histories(b.spec, hs)
    assert b.host_sync_s > before


def test_device_compaction_matches_host_reference(monkeypatch):
    """The driver's ``compact_carry`` and ``compact_carry_plain`` patched
    in: identical everything; both equal the reference's device and host
    compactions in verdicts, compactions and rounds (the plan forces
    bucket shrinks and memo growth)."""
    jhs, hs = _drv_corpus()
    spec = CasSpec()
    plan = dict(chunk_schedule=JaxTPU.CHUNK_SCHEDULE,
                batch_buckets=(8, 64), slots_for_batch={8: 4096, 64: 512})

    def port():
        t = TorchStepper(spec, device="cpu", **BUDGETS, **plan)
        return t.check_histories(spec, hs), t

    wrapped, t_w = port()
    monkeypatch.setattr(stepper_module, "compact_carry", compact_carry_plain)
    plain, t_p = port()
    assert np.array_equal(wrapped, plain)
    for k in COUNTERS:
        assert getattr(t_w, k) == getattr(t_p, k), k
    assert t_w.compactions > 0, "corpus must exercise compaction"

    for host in (False, True):
        j = JaxTPU(SPEC, **BUDGETS)
        j.BATCH_BUCKETS = plan["batch_buckets"]
        j.MAX_SLOTS_FOR_BATCH = plan["slots_for_batch"]
        if host:
            j._compact_carry = j._compact_carry_host
        assert np.array_equal(np.asarray(j.check_histories(SPEC, jhs)),
                              wrapped)
        assert j.compactions == t_w.compactions
        assert j.rounds_run == t_w.rounds_run


def test_compaction_out_of_cache_off_bucket():
    """Survivors of a memo-less bucket (slots 0) compacting into a bucket
    with a memo get an empty table, nothing to re-hash; verdicts equal
    the oracle's and the reference's on the same plan."""
    jspec = JCas()
    jhs = build_corpus(jspec, (AtomicCasSUT, RacyCasSUT), n=40, n_pids=4,
                       max_ops=24, seed_base=91, seed_prefix="cacheoff")
    spec, hs = CasSpec(), _port(jhs)
    j = JaxTPU(jspec, budget=2_000)
    j.MAX_SLOTS_FOR_BATCH = dict(j.MAX_SLOTS_FOR_BATCH)
    j.MAX_SLOTS_FOR_BATCH[64] = 0
    j.CHUNK_SCHEDULE = (16, 64, 2048)
    j._compact_carry = j._compact_carry_host
    plan = dict(chunk_schedule=j.CHUNK_SCHEDULE, batch_buckets=(8, 64),
                slots_for_batch={8: j._slots_for(8), 64: 0})
    j.BATCH_BUCKETS = plan["batch_buckets"]
    t = TorchStepper(spec, device="cpu", budget=2_000, **plan)
    got = t.check_histories(spec, hs)
    want = np.asarray(JWingGongCPU(memo=True).check_histories(jspec, jhs))
    both = (got != 2) & (want != 2)
    assert both.all() and (got == want).all()
    assert t.compactions >= 1  # the 0 -> K transition really happened
    assert np.array_equal(np.asarray(j.check_histories(jspec, jhs)), got)
    for k in COUNTERS:
        assert getattr(t, k) == getattr(j, k), k


@pytest.mark.parametrize("double_buffer", [False, True])
def test_sweep_lane_check_raises_at_the_round_read(monkeypatch,
                                                   double_buffer):
    """A driver launch whose lane list leaves out a RUNNING lane launches
    (the check is counted on the stream), and the round's status read
    raises with the direct call's message before any verdict is used."""
    _, spec, hs = _corpus(*CORPORA[2])
    t = TorchStepper(spec, device="cpu", double_buffer=double_buffer,
                     **BUDGETS, **PLAN)
    real = shards_module.LaneShards.step
    calls = []

    def short_list(self, step, tables, carries, lanes, **kw):
        calls.append(len(lanes))
        if len(calls) == 2:
            lanes = lanes[1:]
        return real(self, step, tables, carries, lanes, **kw)

    monkeypatch.setattr(shards_module.LaneShards, "step", short_list)
    with pytest.raises(ValueError, match="leaves out 1 RUNNING"):
        t.check_histories(spec, _port(hs))
    # with the tail, round 2's speculative launch is enqueued before its
    # read
    assert len(calls) == (3 if double_buffer else 2)
    assert t.device_histories == 0


@pytest.mark.parametrize("where", ["snapshot", "step"])
def test_a_failure_in_the_tail_raises(monkeypatch, where):
    """A failed snapshot, or an injected fault in the speculative launch,
    raises out of the batch; nothing runs it again without the tail."""
    _, spec, hs = _corpus("cas", 48, 6, 24)
    t = TorchStepper(spec, device="cpu", double_buffer=True, **BUDGETS,
                     **PLAN)
    real = getattr(shards_module.LaneShards, where)
    calls = []

    def fail(self, *a, **kw):
        calls.append(where)
        # the settled schedule starts at round 2, whose speculative
        # launch is the third step
        if where == "snapshot" or len(calls) == 3:
            raise InjectedFault("tail", "raise")
        return real(self, *a, **kw)

    monkeypatch.setattr(shards_module.LaneShards, where, fail)
    with pytest.raises(InjectedFault):
        t.check_histories(spec, _port(hs))
    assert t.speculated_chunks == 0 and t.device_histories == 0
    assert len(calls) == (1 if where == "snapshot" else 3)


@pytest.mark.slow
def test_device_compaction_rehash_grows_cache_correctly():
    """A bucket shrink that grows the memo: after the re-hash every lane
    still decides as the oracle does."""
    jhs, hs = _drv_corpus(n=80)
    spec = CasSpec()
    t = TorchStepper(spec, device="cpu", double_buffer=True, **BUDGETS,
                     chunk_schedule=JaxTPU.CHUNK_SCHEDULE,
                     batch_buckets=(8, 64, 256),
                     slots_for_batch={8: 4096, 64: 512, 256: 64})
    v = t.check_histories(spec, hs)
    want = np.asarray(JWingGongCPU(memo=True).check_histories(SPEC, jhs))
    both = (v != 2) & (want != 2)
    assert both.any() and t.compactions > 0
    assert ((v == want) | ~both).all()


@pytest.mark.slow
def test_double_buffer_parity_and_accounting():
    """The reference's corpus and short schedule ``(64, 256)``, which
    reaches the settled tail: on against off, the same verdicts, rounds,
    iterations of every lane and witnesses; every speculative chunk is
    consumed as the next round or wasted at a compaction or the end."""
    _, hs = _drv_corpus()
    spec = CasSpec()
    sched = (64, 256)
    runs = []
    for db in (False, True):
        t = TorchStepper(spec, device="cpu", double_buffer=db,
                         chunk_schedule=sched)
        runs.append((_lanes(t, hs), t))
    (off, plain), (on, spec_on) = runs
    assert plain.speculated_chunks == 0 and plain.wasted_chunks == 0
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    assert spec_on.rounds_run == plain.rounds_run
    assert spec_on.speculated_chunks > 0
    consumed = spec_on.speculated_chunks - spec_on.wasted_chunks
    assert 0 <= consumed <= spec_on.rounds_run
