"""The sweep regime's generic route (``ops/sweep_generic.py``) against the
port's plain sweep and the JAX package's sweep-regime ``run_one``,
``JaxTPU`` and ``build_kernel`` on the same numpy inputs, on the CPU.

* ``sweep_advance_plain`` after the spec's own step (``step_planes``)
  equals one ``stepper_sweep_plain`` trip, carry for carry, on mid-search
  carries: KV, queue, stack and random vector specs with their kernel
  model withheld, at one to four taken words, memo off and on, over every
  lane and over a lane list;
* ``stepper_sweep_generic`` equals ``stepper_sweep_plain`` over whole
  chunks, with ``lanes=`` and ``missing``, and the reference's
  ``build_stepper`` / ``run_one`` (tolerance 0: all integer), resumed from
  the reference's own carry too;
* ``TorchStepper(device="cpu")`` and ``build_kernel`` on specs without a
  kernel model and on a KV map of 32 keys (wider than the sweep kernel's
  28 words) give ``JaxTPU``'s and the reference ``build_kernel``'s
  verdicts, iterations and counters, and every LINEARIZABLE witness
  replays through both packages' ``verify_witness``."""

from __future__ import annotations

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsm_tpu.core.history import encode_batch as j_encode_batch
from qsm_tpu.models.counter import RacyTicketSUT as JRacyTicket
from qsm_tpu.models.counter import TicketSpec as JTicket
from qsm_tpu.models.counter import AtomicTicketSUT as JAtomicTicket
from qsm_tpu.models.kv import AtomicKvSUT, KvSpec as JKv, StaleCacheKvSUT
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec as JQueue,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.models.stack import (AtomicStackSUT, RacyTwoPhaseStackSUT,
                                  StackSpec as JStack)
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.jax_kernel import build_kernel as j_build_kernel
from qsm_tpu.ops.jax_kernel import build_stepper
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu.utils.fuzz import RandomVectorSpec as JRandomVector
from qsm_tpu.utils.fuzz import random_history as j_random_history
from qsm_tpu_torch.core.spec import without_sweep_kernel
from qsm_tpu_torch.models.counter import TicketSpec
from qsm_tpu_torch.models.kv import KvSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.models.stack import StackSpec
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.backend import verify_witness as t_verify_witness
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.stepper_kernel import (RUNNING, STATUS, StepperCarry,
                                              build_kernel)
from qsm_tpu_torch.ops.sweep_generic import (POLL_TRIPS, step_planes,
                                             stepper_sweep_generic,
                                             sweep_advance)
from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry, stepper_sweep,
                                            stepper_sweep_plain, sweep_model,
                                            sweep_tables)
from qsm_tpu_torch.utils.fuzz import RandomVectorSpec
from qsm_tpu_torch.utils.interop import (history_from_rows, history_to_rows,
                                         stepper_carry_from_jax,
                                         stepper_carry_to_jax)

BUDGET = 552_000
CHUNK = 29
LANES = 12


KvNoKind = without_sweep_kernel(KvSpec)
QueueNoKind = without_sweep_kernel(QueueSpec)
StackNoKind = without_sweep_kernel(StackSpec)
RandomNoKind = without_sweep_kernel(RandomVectorSpec)


class UnboundedTicket(TicketSpec):
    """The ticket dispenser without its state bound: one state word, no
    step table, no kernel model (docs/EXTENDING.md's counter, as a user
    writes it first)."""

    def scalar_state_bound(self, n_ops):
        return None


class JUnboundedTicket(JTicket):
    def scalar_state_bound(self, n_ops):
        return None


RANDOM_BOUNDS = (4, 3, 5, 4, 4, 3, 4, 4, 6)

# name -> (reference spec, port spec without a kernel model, SUTs or None
# for random histories)
SPECS = {
    "kv4": (lambda: JKv(), lambda: KvNoKind(),
            (AtomicKvSUT, StaleCacheKvSUT)),
    "kv9": (lambda: JKv(n_keys=9), lambda: KvNoKind(n_keys=9),
            (AtomicKvSUT, StaleCacheKvSUT)),
    "kv32": (lambda: JKv(n_keys=32), lambda: KvSpec(n_keys=32),
             (AtomicKvSUT, StaleCacheKvSUT)),
    "queue8": (lambda: JQueue(capacity=8), lambda: QueueNoKind(capacity=8),
               (AtomicQueueSUT, RacyTwoPhaseQueueSUT)),
    "stack8": (lambda: JStack(capacity=8), lambda: StackNoKind(capacity=8),
               (AtomicStackSUT, RacyTwoPhaseStackSUT)),
    "random9": (lambda: JRandomVector(7, bounds=RANDOM_BOUNDS),
                lambda: RandomNoKind(7, bounds=RANDOM_BOUNDS), None),
    "ticket": (lambda: JUnboundedTicket(), lambda: UnboundedTicket(),
               (lambda s: JAtomicTicket(), lambda s: JRacyTicket())),
}


def _histories(name: str, n_ops: int, pids: int, n: int = LANES):
    jspec = SPECS[name][0]()
    suts = SPECS[name][2]
    if suts is None:
        rng = random.Random(f"generic:{name}")
        return jspec, [j_random_history(jspec, rng, pids, n_ops)
                       for _ in range(n)]
    return jspec, build_corpus(jspec, suts, n=n, n_pids=pids,
                               max_ops=n_ops, seed_base=41,
                               seed_prefix="generic")


def _inputs(name: str, n_ops: int, pids: int):
    jspec, hs = _histories(name, n_ops, pids)
    spec = SPECS[name][1]()
    enc = j_encode_batch(hs, jspec.initial_state())
    N = enc.ops.shape[1]
    arrays = (enc.ops[:, :, 1].astype(np.int32),
              enc.ops[:, :, 2].astype(np.int32),
              enc.ops[:, :, 3].astype(np.int32),
              enc.valid.astype(bool), enc.precedes().astype(bool))
    starts = np.tile(np.asarray(enc.init_state, np.int32), (LANES, 1))
    return jspec, spec, N, arrays, starts


def _clone(c: StepperCarry) -> StepperCarry:
    return StepperCarry(*(t.clone() for t in c))


def _same(a: StepperCarry, b: StepperCarry) -> list:
    return [k for k, x, y in zip(StepperCarry._fields, a, b)
            if not torch.equal(x, y)]


def _assert_same_as_jax(jc: dict, carry, what: str) -> None:
    got = stepper_carry_to_jax(carry)
    assert sorted(got) == sorted(jc), what
    for k in jc:
        assert np.array_equal(jc[k], got[k]), f"{k} differs {what}"


# --- sweep_advance_plain: one trip of the plain sweep ------------------------

@pytest.mark.parametrize("slots", [0, 32])
@pytest.mark.parametrize("name,n_ops,pids,trips", [
    ("kv4", 24, 8, 40), ("queue8", 24, 6, 30), ("stack8", 40, 6, 30),
    ("random9", 40, 4, 20), ("kv9", 72, 8, 12), ("random9", 100, 4, 6),
    ("kv32", 24, 8, 30), ("ticket", 12, 4, 12)])
def test_advance_plain_equals_a_plain_trip(name, n_ops, pids, trips, slots):
    jspec, spec, N, arrays, starts = _inputs(name, n_ops, pids)
    tabs = sweep_tables(*arrays, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              slots)
    seen = 0
    for _ in range(trips):
        want = _clone(carry)
        stepper_sweep_plain(spec, tabs, want, chunk=1, budget=BUDGET,
                            early_exit=False)
        running = np.flatnonzero(carry.dsi[STATUS].numpy() == RUNNING)
        for listed in (False, True):
            got = _clone(carry)
            idx = torch.from_numpy((running[::-1] if listed else
                                    np.arange(LANES)).astype(np.int32))
            il = idx.long()
            state = got.states[il, got.dsi[0, il].long()]
            row = got.row[il].long()
            nxt, ok = step_planes(spec, state, *(t[row] for t in tabs[:3]))
            assert nxt.dtype == torch.int32 and ok.dtype == torch.uint8
            sweep_advance(tabs, got, idx, nxt, ok, budget=BUDGET,
                          state_out=state)
            assert _same(got, want) == [], f"listed={listed}"
            assert torch.equal(state, got.states[il, got.dsi[0, il].long()])
        seen += running.size
        carry = want
    assert seen > 0 and int(carry.dsi[2].sum()) > 0
    # W = ceil(N / 32) taken words: 1 to 4 over the cases
    assert carry.taken.shape[0] == N


def test_advance_wrapper_refuses_what_the_kernel_does_not_take():
    _, spec, N, arrays, starts = _inputs("kv9", 24, 6)
    tabs = sweep_tables(*arrays, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              8)
    nxt = torch.zeros((LANES, N, 9), dtype=torch.int32)
    ok = torch.zeros((LANES, N), dtype=torch.uint8)
    lanes = torch.arange(LANES, dtype=torch.int32)
    out = torch.zeros((LANES, 9), dtype=torch.int32)
    run = functools.partial(sweep_advance, tabs, carry, budget=BUDGET)
    run(lanes, nxt, ok, state_out=out)
    with pytest.raises(TypeError, match="int32"):
        run(lanes, nxt.long(), ok, state_out=out)
    with pytest.raises(ValueError, match="shape"):
        run(lanes, nxt[:, :, :8], ok, state_out=out)
    with pytest.raises(ValueError, match="uint8"):
        run(lanes, nxt, ok.bool(), state_out=out)
    with pytest.raises(ValueError, match="contiguous"):
        run(lanes, nxt.transpose(0, 1).contiguous().transpose(0, 1), ok,
            state_out=out)
    with pytest.raises(ValueError, match="shape"):
        run(lanes[:3], nxt, ok, state_out=out)
    with pytest.raises(ValueError, match="shape"):
        run(lanes, nxt, ok, state_out=out[:, :8])
    with pytest.raises(TypeError, match="int32"):
        run(lanes.long(), nxt, ok, state_out=out)


# --- stepper_sweep_generic over whole chunks ---------------------------------

@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("name,n_ops,pids", [("kv9", 24, 6),
                                             ("queue8", 24, 4),
                                             ("kv32", 24, 8),
                                             ("random9", 40, 4)])
def test_generic_chunks_equal_the_plain_sweep(name, n_ops, pids, slots):
    _, spec, N, arrays, starts = _inputs(name, n_ops, pids)
    tabs = sweep_tables(*arrays, "cpu")
    m = sweep_model(spec, "cpu")
    assert m.route == "generic"
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              slots)
    for k in range(3):
        want = _clone(carry)
        stepper_sweep_plain(spec, tabs, want, chunk=CHUNK, budget=BUDGET)
        whole, listed = _clone(carry), _clone(carry)
        stepper_sweep_generic(m, tabs, whole, chunk=CHUNK, budget=BUDGET)
        assert _same(whole, want) == [], f"chunk {k + 1}"
        running = np.flatnonzero(carry.dsi[STATUS].numpy() == RUNNING)
        missing = torch.zeros(1, dtype=torch.int32)
        # through the dispatching wrapper, on a lane list in another order
        stepper_sweep(m, tabs, listed, chunk=CHUNK, budget=BUDGET,
                      lanes=running[::-1], missing=missing)
        assert _same(listed, want) == [] and int(missing) == 0
        carry = want
    assert (carry.dsi[STATUS] != RUNNING).any()


def test_generic_lane_check_counts_what_the_list_leaves_out():
    _, spec, N, arrays, starts = _inputs("kv9", 24, 6)
    tabs = sweep_tables(*arrays, "cpu")
    m = sweep_model(spec, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              16)
    running = np.flatnonzero(carry.dsi[STATUS].numpy() == RUNNING)
    assert running.size > 2
    missing = torch.zeros(1, dtype=torch.int32)
    stepper_sweep_generic(m, tabs, carry, chunk=4, budget=BUDGET,
                          lanes=running[2:], missing=missing)
    assert int(missing) == 2
    # the lanes left out did not move
    assert (carry.dsi[2, torch.from_numpy(running[:2])] == 0).all()
    with pytest.raises(ValueError, match="leaves out 2 RUNNING"):
        stepper_sweep_generic(m, tabs, carry, chunk=4, budget=BUDGET,
                              lanes=running[2:])
    with pytest.raises(ValueError, match="counts no memo probes"):
        stepper_sweep(m, tabs, carry, chunk=4, budget=BUDGET,
                      stats=torch.zeros(2, dtype=torch.int64))


def test_generic_chunk_ends_once_every_lane_decided(monkeypatch):
    """Where the chunk stops changes nothing (the trips after every lane
    decided are no-ops); the loop stops within a poll of it."""
    from qsm_tpu_torch.ops import sweep_generic

    _, spec, N, arrays, starts = _inputs("kv4", 12, 3)
    tabs = sweep_tables(*arrays, "cpu")
    m = sweep_model(spec, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              16)
    calls = []
    real = sweep_generic.advance_unchecked
    monkeypatch.setattr(sweep_generic, "advance_unchecked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    stepper_sweep_generic(m, tabs, carry, chunk=100_000, budget=BUDGET)
    assert (carry.dsi[STATUS] != RUNNING).all()
    last = int(carry.dsi[2].max())
    assert last <= len(calls) < last + POLL_TRIPS


# --- against the reference's run_one -----------------------------------------

def _jax_run(jspec, n_ops, slots, arrays, starts, chunks):
    """The reference carry after each of ``chunks`` chunks of CHUNK."""
    init_one, run_one = build_stepper(jspec, n_ops, BUDGET,
                                      cache_slots=slots)
    carry = jax.vmap(init_one)(jnp.asarray(arrays[3]), jnp.asarray(starts))
    fn = jax.jit(jax.vmap(lambda c, *a: run_one(c, *a, chunk=CHUNK)))
    out = []
    for _ in range(chunks):
        carry = fn(carry, *(jnp.asarray(a) for a in arrays))
        out.append({k: np.asarray(v) for k, v in carry.items()})
    return out


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("name,n_ops,pids", [("kv9", 40, 8),
                                             ("kv32", 24, 8),
                                             ("random9", 40, 4),
                                             ("ticket", 12, 4)])
def test_generic_route_equals_run_one(name, n_ops, pids, slots):
    jspec, spec, N, arrays, starts = _inputs(name, n_ops, pids)
    ref = _jax_run(jspec, N, slots, arrays, starts, chunks=3)
    tabs = sweep_tables(*arrays, "cpu")
    m = sweep_model(spec, "cpu")
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              slots)
    for k in range(2):
        stepper_sweep_generic(m, tabs, carry, chunk=CHUNK, budget=BUDGET)
        _assert_same_as_jax(ref[k], carry, f"after chunk {k + 1}")
    mid = stepper_carry_from_jax(ref[1], "cpu", sweep=True)
    stepper_sweep(m, tabs, mid, chunk=CHUNK, budget=BUDGET)
    _assert_same_as_jax(ref[2], mid, "resumed from the reference's carry")
    assert (ref[0]["status"] == 0).any()


# --- TorchStepper and build_kernel against JaxTPU ----------------------------

PLAN = dict(chunk_schedule=(48, 256, 2048), batch_buckets=(8, 32, 64),
            slots_for_batch={8: 256, 32: 64, 64: 0})
BUDGETS = dict(budget=1_000, mid_budget=2_000, rescue_budget=0)
COUNTERS = ("memo_prunes", "memo_inserts", "compactions", "rounds_run",
            "lockstep_cost", "rescued", "device_histories",
            "deferred_out_of_domain")


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


@pytest.mark.parametrize("name,n,pids,ops", [("kv9", 40, 8, 40),
                                             ("kv32", 24, 8, 24),
                                             ("ticket", 24, 4, 12)])
def test_torch_stepper_generic_route_equals_jaxtpu(name, n, pids, ops):
    jspec, hs = _histories(name, ops, pids, n=n)
    spec = SPECS[name][1]()
    j = JaxTPU(jspec, **BUDGETS)
    j.CHUNK_SCHEDULE = PLAN["chunk_schedule"]
    j.BATCH_BUCKETS = PLAN["batch_buckets"]
    j.MAX_SLOTS_FOR_BATCH = PLAN["slots_for_batch"]
    j._compact_carry = j._compact_carry_host
    jv = np.asarray(j.check_histories(jspec, hs))
    t = TorchStepper(spec, device="cpu", **BUDGETS, **PLAN)
    assert (t.regime, t.sweep_route) == ("sweep", "generic")
    tv = t.check_histories(spec, _port(hs))
    assert np.array_equal(jv, tv)
    for k in COUNTERS:
        assert getattr(t, k) == getattr(j, k), k
    assert int(Verdict.LINEARIZABLE) in tv.tolist()
    lin = [h for h, v in zip(hs, tv) if v == Verdict.LINEARIZABLE][:6]
    for h in lin:
        ph = _port([h])[0]
        v, wit = t.check_witness(spec, ph)
        assert v == Verdict.LINEARIZABLE
        assert t_verify_witness(spec, ph, wit)
        assert j_verify_witness(jspec, h, wit)
        assert j.check_witness(jspec, h)[1] == wit  # the same search


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("name,n_ops,pids", [("kv9", 24, 6),
                                             ("kv32", 24, 8),
                                             ("ticket", 12, 4)])
def test_check_one_generic_route_equals_reference(name, n_ops, pids, slots):
    jspec, spec, N, arrays, starts = _inputs(name, n_ops, pids)
    budget = 700
    want = jax.vmap(j_build_kernel(jspec, N, budget, cache_slots=slots))(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(starts))
    got = build_kernel(spec, N, budget, cache_slots=slots, device="cpu")(
        *arrays, starts[0])
    assert np.array_equal(np.asarray(want[0]), got[0])
    assert np.array_equal(np.asarray(want[1]), got[1])
    assert set(got[0].tolist()) - {RUNNING}


# --- a spec with its kernel model withheld -----------------------------------

def test_without_sweep_kernel_is_one_subclass_a_class():
    cls = without_sweep_kernel(KvSpec)
    assert cls is without_sweep_kernel(KvSpec) and issubclass(cls, KvSpec)
    spec = cls(n_keys=4)
    assert spec.sweep_kernel() is None
    assert KvSpec(n_keys=4).sweep_kernel() is not None
    assert sweep_model(spec, "cpu").route == "generic"
    assert sweep_model(KvSpec(n_keys=4), "cpu").route == "kernel"


def test_fuzz_parity_runs_vector_specs_without_their_kernel():
    from qsm_tpu_torch.utils.fuzz import fuzz_parity

    rep = fuzz_parity(n_specs=2, hists_per_spec=12, n_ops=6,
                      backends=("device",), device="cpu",
                      vector_bounds=(7,) * 7,
                      vector_spec=without_sweep_kernel(RandomVectorSpec))
    assert rep.ok and rep.histories == 24
    assert rep.linearizable and rep.violations
