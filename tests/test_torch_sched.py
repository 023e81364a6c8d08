"""The port's scheduler plane against the JAX package's: the twins of
``tests/test_scheduler.py``, ``tests/test_transport.py`` and
``tests/test_pool.py``.  Histories over loopback TCP are bit-identical to
the memory transport's and to the reference's, faults and all; the
worker pools give the serial results; the property layer gives the same
counterexample on every transport x executor combination.  Tolerance 0.
"""

from __future__ import annotations

import dataclasses

import pytest

from qsm_tpu.core.generator import generate_program as jgen
from qsm_tpu.models.registry import make as jmake
from qsm_tpu.sched.runner import run_concurrent as jrun
from qsm_tpu.sched.scheduler import FaultPlan as JFaultPlan
from qsm_tpu_torch import (FaultPlan, Program, ProgOp, generate_program,
                           run_concurrent)
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.register import (READ, WRITE, AtomicRegisterSUT,
                                           RacyCachedRegisterSUT,
                                           RegisterSpec,
                                           ReplicatedRegisterSUT)
from qsm_tpu_torch.models.registry import SutFactory, make
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.sched.pool import PoolExecutor
from qsm_tpu_torch.sched.scheduler import Message
from qsm_tpu_torch.sched.transport import (InMemoryTransport,
                                           TcpLoopbackTransport,
                                           make_transport)
from qsm_tpu_torch.utils.interop import history_to_rows

SPEC = RegisterSpec(n_values=5)
FAULTS = dict(p_drop=0.15, p_duplicate=0.1, p_delay=0.1)


def _reference(model, impl, seed, n_pids, max_ops, sched_seed, faults=None):
    jspec, jsut = jmake(model, impl)
    prog = jgen(jspec, seed=seed, n_pids=n_pids, max_ops=max_ops)
    return history_to_rows(jrun(jsut, prog, seed=sched_seed,
                                faults=JFaultPlan(**faults) if faults
                                else None))


def _port(model, impl, seed, n_pids, max_ops, sched_seed, faults=None,
          transport=None):
    spec, sut = make(model, impl)
    prog = generate_program(spec, seed=seed, n_pids=n_pids, max_ops=max_ops)
    return history_to_rows(run_concurrent(
        sut, prog, seed=sched_seed,
        faults=FaultPlan(**faults) if faults else None,
        transport=transport))


# ---------------------------------------------------------------------------
# the scheduler (tests/test_scheduler.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sut_cls", [AtomicRegisterSUT,
                                     RacyCachedRegisterSUT,
                                     ReplicatedRegisterSUT])
def test_same_seed_identical_history(sut_cls):
    prog = generate_program(SPEC, seed=3, n_pids=2, max_ops=10)
    a = run_concurrent(sut_cls(), prog, seed="s1")
    b = run_concurrent(sut_cls(), prog, seed="s1")
    assert history_to_rows(a) == history_to_rows(b)


def test_different_seeds_explore_interleavings():
    prog = Program((ProgOp(0, WRITE, 1), ProgOp(1, WRITE, 2),
                    ProgOp(0, READ, 0), ProgOp(1, READ, 0)), n_pids=2)
    seen = {tuple(map(tuple, history_to_rows(run_concurrent(
        ReplicatedRegisterSUT(), prog, seed=f"seed{i}")))) for i in range(40)}
    assert len(seen) > 1


def test_all_ops_complete_and_intervals_well_formed():
    prog = generate_program(SPEC, seed=11, n_pids=3, max_ops=12)
    h = run_concurrent(AtomicRegisterSUT(), prog, seed="x")
    assert len(h) == len(prog) and h.n_pending == 0
    prog = generate_program(SPEC, seed=5, n_pids=3, max_ops=12)
    h = run_concurrent(AtomicRegisterSUT(), prog, seed="y")
    assert all(o.invoke_time < o.response_time for o in h.ops)
    per_pid, expected = {}, {}
    for o in h.ops:
        per_pid.setdefault(o.pid, []).append((o.cmd, o.arg))
    for op in prog.ops:
        expected.setdefault(op.pid, []).append((op.cmd, op.arg))
    assert per_pid == expected


def test_message_drop_leaves_pending_ops():
    prog = Program((ProgOp(0, WRITE, 1), ProgOp(1, READ, 0)), n_pids=2)
    h = run_concurrent(AtomicRegisterSUT(), prog, seed="z",
                       faults=FaultPlan(p_drop=1.0))
    assert h.n_pending == len(h) == 2


def test_crash_injection_kills_client():
    prog = Program((ProgOp(0, WRITE, 1), ProgOp(0, READ, 0),
                    ProgOp(1, READ, 0)), n_pids=2)
    h = run_concurrent(AtomicRegisterSUT(), prog, seed="c",
                       faults=FaultPlan(crash_at={"client:0": 1}))
    assert any(o.is_pending for o in h.ops if o.pid == 0) or \
        len([o for o in h.ops if o.pid == 0]) < 2


@pytest.mark.parametrize("faults", [None, FAULTS,
                                    {"crash_at": {"primary": 3}}])
@pytest.mark.parametrize("model,impl", [("register", "racy"),
                                        ("cas", "racy"),
                                        ("failover", "racy"),
                                        ("queue", "atomic")])
def test_histories_equal_the_reference(model, impl, faults):
    for seed in range(3):
        assert _port(model, impl, seed, 3, 10, f"r{seed}", faults) == \
            _reference(model, impl, seed, 3, 10, f"r{seed}", faults)


def test_fault_plan_determinism_matches_the_reference():
    for kw in ({}, {"crash_at": {"a": 1}}, {"partitions": [{"a"}]},
               {"p_drop": 0.1}, {"p_duplicate": 0.1}, {"p_delay": 0.1}):
        assert FaultPlan(**kw).is_deterministic() == \
            JFaultPlan(**kw).is_deterministic()


def test_scheduler_trace_records_deliveries():
    from qsm_tpu_torch.sched.runner import prepare_run

    spec, sut = make("cas", "racy")
    prog = generate_program(spec, seed=2, n_pids=3, max_ops=8)
    sched, rec = prepare_run(sut, prog, seed="t")
    sched.run()
    assert sched.trace and len(set(sched.trace)) == len(sched.trace)
    assert sched.transport is None and not sched.owns_transport


# ---------------------------------------------------------------------------
# the transport (tests/test_transport.py)
# ---------------------------------------------------------------------------

def _cas_run(sut_cls, seed, transport=None, faults=None):
    spec = CasSpec()
    prog = generate_program(spec, seed=seed, n_pids=4, max_ops=16)
    return run_concurrent(sut_cls(spec), prog, seed=f"t{seed}",
                          faults=faults, transport=transport)


def test_tcp_history_bit_identical_to_memory_and_the_reference():
    for seed in range(12):
        impl = "atomic" if seed % 2 else "racy"
        sut = AtomicCasSUT if seed % 2 else RacyCasSUT
        mem = history_to_rows(_cas_run(sut, seed))
        tcp = history_to_rows(_cas_run(sut, seed, transport="tcp"))
        assert mem == tcp
        assert tcp == _reference("cas", impl, seed, 4, 16, f"t{seed}")


def test_tcp_with_faults_matches_memory_and_the_reference():
    for seed in range(8):
        mem = _cas_run(AtomicCasSUT, seed, faults=FaultPlan(**FAULTS))
        tcp = _cas_run(AtomicCasSUT, seed, transport="tcp",
                       faults=FaultPlan(**FAULTS))
        assert history_to_rows(mem) == history_to_rows(tcp)
        assert history_to_rows(tcp) == _reference(
            "cas", "atomic", seed, 4, 16, f"t{seed}", FAULTS)


def test_tcp_deterministic_replay():
    a = _cas_run(RacyCasSUT, 3, transport="tcp")
    b = _cas_run(RacyCasSUT, 3, transport="tcp")
    assert a.fingerprint() == b.fingerprint()


def test_tcp_frames_actually_traverse_sockets():
    spec = CasSpec()
    prog = generate_program(spec, seed=5, n_pids=4, max_ops=16)
    t = TcpLoopbackTransport()
    h = run_concurrent(RacyCasSUT(spec), prog, seed="frames", transport=t)
    assert t.frames > 0 and len(h.ops) > 0
    # a transport object passed in stays the caller's, and is reused
    assert t._conns
    h2 = run_concurrent(RacyCasSUT(spec), prog, seed="frames", transport=t)
    assert h2.fingerprint() == h.fingerprint()
    t.close()
    assert not t._conns


def test_tcp_closes_every_socket():
    t = TcpLoopbackTransport()
    for name in ("a", "b", "c"):
        t.uplink(Message(src=name, dst="x", payload=name, uid=1))
    socks = [s for pair in t._conns.values() for s in pair]
    assert len(socks) == 8 - 2  # a, b, c and x: x was only a destination
    t.close()
    assert all(s.fileno() == -1 for s in socks)
    assert t._listener.fileno() == -1


def test_tcp_run_owned_transport_is_closed(monkeypatch):
    made = []
    real = TcpLoopbackTransport.__init__

    def spy(self):
        real(self)
        made.append(self)

    monkeypatch.setattr(TcpLoopbackTransport, "__init__", spy)
    _cas_run(RacyCasSUT, 1, transport="tcp")
    assert len(made) == 1 and made[0]._listener.fileno() == -1


def test_tcp_large_payload_roundtrip_no_deadlock():
    t = TcpLoopbackTransport()
    try:
        big = b"x" * (8 << 20)
        assert t.uplink(Message(src="a", dst="b", payload=big,
                                uid=1)).payload == big
        assert t.downlink(Message(src="a", dst="b", payload=big,
                                  uid=2)).payload == big
    finally:
        t.close()


def test_property_layer_over_tcp_finds_the_same_race():
    spec = CasSpec()
    cfg = PropertyConfig(n_trials=40, n_pids=4, max_ops=16, seed=9,
                         transport="tcp")
    res = prop_concurrent(spec, RacyCasSUT(spec), cfg)
    mem = prop_concurrent(spec, RacyCasSUT(spec),
                          dataclasses.replace(cfg, transport="memory"))
    assert not res.ok and not mem.ok
    assert history_to_rows(res.counterexample.history) == \
        history_to_rows(mem.counterexample.history)
    assert res.counterexample.trial_seed == mem.counterexample.trial_seed


def test_make_transport_validates():
    assert isinstance(make_transport("memory"), InMemoryTransport)
    t = make_transport("tcp")
    assert isinstance(t, TcpLoopbackTransport)
    t.close()
    with pytest.raises(ValueError):
        make_transport("udp")


def test_verdicts_over_tcp_equal_memory():
    spec = CasSpec()
    tcp = [_cas_run(RacyCasSUT, s, transport="tcp") for s in range(8)]
    mem = [_cas_run(RacyCasSUT, s) for s in range(8)]
    w = WingGongCPU(memo=True)
    assert list(w.check_histories(spec, tcp)) == \
        list(w.check_histories(spec, mem))


# ---------------------------------------------------------------------------
# the worker pools (tests/test_pool.py): two workers at most
# ---------------------------------------------------------------------------

CFG = PropertyConfig(n_trials=24, n_pids=4, max_ops=16, seed=11)


@pytest.fixture(scope="module")
def serial_racy_result():
    spec, sut = make("cas", "racy")
    return prop_concurrent(spec, sut, CFG)


def _same_counterexample(a, b):
    assert not a.ok and not b.ok
    assert a.counterexample.trial == b.counterexample.trial
    assert a.counterexample.trial_seed == b.counterexample.trial_seed
    assert history_to_rows(a.counterexample.history) == \
        history_to_rows(b.counterexample.history)
    assert [(o.pid, o.cmd, o.arg) for o in a.counterexample.program.ops] \
        == [(o.pid, o.cmd, o.arg) for o in b.counterexample.program.ops]
    assert a.histories_checked == b.histories_checked


@pytest.mark.parametrize("transport", ["memory", "tcp"])
def test_pool_matches_serial_on_failure(serial_racy_result, transport):
    spec, sut = make("cas", "racy")
    pooled = prop_concurrent(
        spec, sut, dataclasses.replace(CFG, executor_workers=2,
                                       transport=transport),
        sut_factory=SutFactory("cas", "racy"))
    _same_counterexample(pooled, serial_racy_result)


def test_serial_pool_result_equals_the_reference(serial_racy_result):
    import qsm_tpu
    from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle

    jspec, jsut = jmake("cas", "racy")
    ref = qsm_tpu.prop_concurrent(
        jspec, jsut, qsm_tpu.PropertyConfig(n_trials=24, n_pids=4,
                                            max_ops=16, seed=11),
        oracle=JOracle(memo=True))
    _same_counterexample(serial_racy_result, ref)


def test_pool_matches_serial_on_pass_and_with_faults():
    cfg = dataclasses.replace(CFG, n_trials=12,
                              faults=FaultPlan(p_drop=0.1, p_duplicate=0.05))
    spec, sut = make("cas", "atomic")
    serial = prop_concurrent(spec, sut, cfg)
    spec2, sut2 = make("cas", "atomic")
    pooled = prop_concurrent(
        spec2, sut2, dataclasses.replace(cfg, executor_workers=2),
        sut_factory=SutFactory("cas", "atomic"))
    assert serial.ok and pooled.ok
    assert (pooled.histories_checked, pooled.distinct_histories,
            pooled.undecided) == (serial.histories_checked,
                                  serial.distinct_histories,
                                  serial.undecided)


class _ExplodingFactory:
    """Picklable, but construction fails in the worker."""

    def __call__(self):
        raise RuntimeError("boom in worker")


def test_pool_worker_init_failure_fails_fast():
    pool = PoolExecutor(_ExplodingFactory(), n_workers=1)
    pool.PROBE_TIMEOUT_S = 2.0
    try:
        with pytest.raises(RuntimeError, match="failed to initialize"):
            pool.run_many([(None, "s")], faults=None, max_steps=10)
    finally:
        pool.close()


def test_pool_ignored_without_factory():
    spec, sut = make("register", "atomic")
    res = prop_concurrent(spec, sut, dataclasses.replace(
        CFG, n_trials=5, n_pids=2, max_ops=8, executor_workers=2))
    assert res.ok


def test_pool_run_many_equals_serial_runs():
    spec, _ = make("failover", "racy")
    progs = [generate_program(spec, seed=s, n_pids=3, max_ops=8)
             for s in range(6)]
    jobs = [(p, f"j{i}") for i, p in enumerate(progs)]
    faults = FaultPlan(crash_at={"primary": 4})
    pool = PoolExecutor(SutFactory("failover", "racy"), n_workers=2)
    try:
        got = pool.run_many(jobs, faults, 100_000)
    finally:
        pool.close()
    want = [run_concurrent(make("failover", "racy")[1], p, s, faults=faults)
            for p, s in jobs]
    assert [history_to_rows(h) for h in got] == \
        [history_to_rows(h) for h in want]
    assert pool.jobs_run == len(jobs)


def test_explore_pool_matches_serial():
    from qsm_tpu_torch.sched.systematic import explore_many

    spec, _ = make("set", "racy")
    progs = [generate_program(spec, seed=s, n_pids=2, max_ops=4)
             for s in range(4)]
    factory = SutFactory("set", "racy")
    serial = explore_many(factory, progs, spec, max_schedules=5_000)
    par = explore_many(factory, progs, spec, max_schedules=5_000,
                       workers=2)
    for a, b in zip(serial, par):
        assert (a.schedules_run, a.pruned_schedules, a.distinct_histories,
                a.exhausted, a.violations, a.undecided) == (
            b.schedules_run, b.pruned_schedules, b.distinct_histories,
            b.exhausted, b.violations, b.undecided)


def test_worker_init_touches_no_kernel():
    """A worker rebuilds the SUT from registry names and never touches
    the kernels: no kernel library is built or loaded, no kernel is
    launched and CUDA is not initialised, by initialisation or by a
    run."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as p:
        seen = p.apply(_kernels_after_init, (SutFactory("cas", "racy"),))
    assert seen == {"libraries_loaded": 0, "launches": 0,
                    "cuda_initialized": False}


def _kernels_after_init(factory):
    import torch

    from qsm_tpu_torch.ops import kernels
    from qsm_tpu_torch.ops.dfs_kernel import dfs_chunk
    from qsm_tpu_torch.ops.stepper_kernel import compact_carry, stepper_chunk
    from qsm_tpu_torch.ops.sweep_kernel import stepper_sweep
    from qsm_tpu_torch.sched import pool

    pool._init_worker(factory, "memory")
    prog = generate_program(CasSpec(), seed=1, n_pids=2, max_ops=4)
    pool._run_one((prog, "s", None, 1000))
    libs = (kernels.dfs_chunk_lib, kernels.stepper_chunk_lib,
            kernels.compact_carry_lib, kernels.stepper_sweep_lib,
            kernels.threefry_draws_lib)
    return {"libraries_loaded": sum(f.cache_info().currsize for f in libs),
            "launches": sum(k.launches for k in (dfs_chunk, stepper_chunk,
                                                  compact_carry,
                                                  stepper_sweep)),
            "cuda_initialized": torch.cuda.is_initialized()}


def test_one_explore_pool_serves_many_factories():
    """A caller's ``ExplorePool`` walks the sweeps of several SUT
    factories (each call's jobs carry its factory): results equal the
    serial walks'."""
    from qsm_tpu_torch.sched.pool import ExplorePool
    from qsm_tpu_torch.sched.systematic import enumerate_many, explore_many

    pool = ExplorePool(n_workers=2)
    try:
        for model, impl in (("set", "racy"), ("register", "atomic"),
                            ("failover", "racy")):
            spec, _ = make(model, impl)
            progs = [generate_program(spec, seed=s, n_pids=2, max_ops=4)
                     for s in range(3)]
            factory = SutFactory(model, impl)
            par = enumerate_many(factory, progs, 2_000, 100_000,
                                 prune=False, pool=pool)
            ser = enumerate_many(factory, progs, 2_000, 100_000,
                                 prune=False)
            for a, b in zip(par, ser):
                assert a[1:4] == b[1:4]
                assert [history_to_rows(h) for h in a[0]] == \
                    [history_to_rows(h) for h in b[0]]
            res = explore_many(factory, progs, spec, max_schedules=2_000,
                               pool=pool)
            want = explore_many(factory, progs, spec, max_schedules=2_000)
            assert [(r.schedules_run, r.pruned_schedules,
                     r.distinct_histories, r.violations) for r in res] == \
                [(r.schedules_run, r.pruned_schedules,
                  r.distinct_histories, r.violations) for r in want]
    finally:
        pool.close()
