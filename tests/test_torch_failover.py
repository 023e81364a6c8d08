"""Monitors and the failover model family in the port, against the JAX
package's (twins of ``tests/test_failover.py``): DOWN notifications are
delivered deterministically and exempt from faults, with the reference's
delivery trace; synchronous replication survives every crash schedule,
asynchronous replication loses acknowledged writes and the checker
catches it, with the reference's counterexample; the TCP transport keeps
histories bit-identical; ``run --crash-at`` convicts."""

from __future__ import annotations

import qsm_tpu
from qsm_tpu.models.failover import AsyncReplFailoverSUT as JAsync
from qsm_tpu.models.failover import SyncReplFailoverSUT as JSync
from qsm_tpu.models.register import RegisterSpec as JRegister
from qsm_tpu_torch import (FaultPlan, Monitor, PropertyConfig, Recv,
                           Scheduler, Send, Verdict, WingGongCPU, check_one,
                           prop_concurrent)
from qsm_tpu_torch.models.failover import (AsyncReplFailoverSUT,
                                           SyncReplFailoverSUT)
from qsm_tpu_torch.models.register import RegisterSpec
from qsm_tpu_torch.utils.interop import history_to_rows

SPEC = RegisterSpec()
JSPEC = JRegister()


def _both_runs(sut, jsut, **cfg):
    """The property run in both packages; crash_at is the fault plan."""
    crash = cfg.pop("crash_at", None)
    res = prop_concurrent(SPEC, sut, PropertyConfig(
        faults=FaultPlan(crash_at=crash) if crash else None, **cfg))
    ref = qsm_tpu.prop_concurrent(JSPEC, jsut, qsm_tpu.PropertyConfig(
        faults=qsm_tpu.FaultPlan(crash_at=crash) if crash else None, **cfg))
    assert (res.ok, res.trials_run, res.histories_checked,
            res.distinct_histories) == (ref.ok, ref.trials_run,
                                        ref.histories_checked,
                                        ref.distinct_histories)
    if not res.ok:
        assert history_to_rows(res.counterexample.history) == \
            history_to_rows(ref.counterexample.history)
    return res


# --- the Monitor primitive ------------------------------------------------

def _watcher(log, monitor, recv):
    yield monitor("worker")
    msg = yield recv()
    log.append(msg.payload)


def _idle_worker(recv):
    yield recv()


def _run(pkg, seed, faults=None, worker=True, extra=()):
    """One scheduler run of the watcher in ``pkg`` (the port's names or
    the reference's): (log, trace)."""
    sched_cls, plan_cls, mon, recv = pkg
    sched = sched_cls(seed=seed, faults=plan_cls(**faults) if faults
                      else None)
    log = []
    if worker:
        sched.spawn("worker", _idle_worker(recv), daemon=True)
    for name, gen in extra:
        sched.spawn(name, gen)
    sched.spawn("watcher", _watcher(log, mon, recv))
    sched.run()
    return log, tuple(sched.trace)


PORT = (Scheduler, FaultPlan, Monitor, Recv)
REF = (qsm_tpu.Scheduler, qsm_tpu.FaultPlan, qsm_tpu.Monitor, qsm_tpu.Recv)


def test_monitor_fires_on_crash():
    got = _run(PORT, 1, dict(crash_at={"worker": 0}))
    assert got[0] == [("DOWN", "worker", "crashed")]
    assert got == _run(REF, 1, dict(crash_at={"worker": 0}))


def test_monitor_fires_on_normal_completion():
    def quick_worker():
        return
        yield  # pragma: no cover — makes this a generator

    outs = []
    for sched_cls, _, mon, recv in (PORT, REF):
        sched = sched_cls(seed=1)
        log = []
        sched.spawn("worker", quick_worker())
        sched.spawn("watcher", _watcher(log, mon, recv))
        sched.run()
        outs.append((log, tuple(sched.trace)))
    assert outs[0][0] == [("DOWN", "worker", "done")]
    assert outs[0] == outs[1]


def test_monitor_on_dead_or_unknown_target_fires_immediately():
    def watch_ghost(log, mon, recv):
        yield mon("ghost")
        msg = yield recv()
        log.append(msg.payload)

    outs = []
    for sched_cls, _, mon, recv in (PORT, REF):
        sched = sched_cls(seed=1)
        log = []
        sched.spawn("watcher", watch_ghost(log, mon, recv))
        sched.run()
        outs.append(log)
    assert outs == [[("DOWN", "ghost", "noproc")]] * 2


def test_down_notification_is_fault_exempt():
    faults = dict(p_drop=1.0, crash_at={"worker": 0}, protected={"nobody"})
    got = _run(PORT, 7, faults)
    assert got[0] == [("DOWN", "worker", "crashed")]
    assert got == _run(REF, 7, faults)


def test_monitor_determinism():
    def chatty(send, n):
        for i in range(n):
            yield send("worker", i)

    def once(pkg, send):
        return _run(pkg, 5, dict(crash_at={"worker": 2}),
                    extra=[("noise", chatty(send, 4))])

    got = once(PORT, Send)
    assert got == once(PORT, Send)
    assert got == once(REF, qsm_tpu.Send)


# --- the failover family --------------------------------------------------

def test_sync_failover_survives_crash_schedules():
    for k in (2, 4, 8):
        res = _both_runs(SyncReplFailoverSUT(), JSync(), n_trials=120,
                         n_pids=3, max_ops=10, seed=3,
                         crash_at={"primary": k})
        assert res.ok, (k, res.counterexample)


def test_sync_failover_reads_do_not_go_back_in_time():
    res = _both_runs(SyncReplFailoverSUT(), JSync(), n_trials=400,
                     n_pids=3, max_ops=10, seed=9, crash_at={"primary": 4})
    assert res.ok, res.counterexample


def test_async_failover_loses_acked_writes():
    res = _both_runs(AsyncReplFailoverSUT(), JAsync(), n_trials=120,
                     n_pids=3, max_ops=10, seed=3, crash_at={"primary": 4})
    assert not res.ok, "the lost acked write was never caught"
    cx = res.counterexample
    assert check_one(WingGongCPU(), SPEC, cx.history) == Verdict.VIOLATION


def test_failover_without_crash_behaves_like_plain_register():
    for sut, jsut in ((SyncReplFailoverSUT(), JSync()),
                      (AsyncReplFailoverSUT(), JAsync())):
        assert _both_runs(sut, jsut, n_trials=60, n_pids=3, max_ops=10,
                          seed=1).ok


def test_failover_over_tcp_bit_identical():
    from qsm_tpu_torch import generate_program, run_concurrent

    crash = FaultPlan(crash_at={"primary": 4})
    prog = generate_program(SPEC, seed=5, n_pids=3, max_ops=8)
    jprog = qsm_tpu.generate_program(JSPEC, seed=5, n_pids=3, max_ops=8)
    for impl, jimpl in ((SyncReplFailoverSUT, JSync),
                        (AsyncReplFailoverSUT, JAsync)):
        mem = run_concurrent(impl(), prog, seed="t5", faults=crash)
        tcp = run_concurrent(impl(), prog, seed="t5", faults=crash,
                             transport="tcp")
        assert mem.fingerprint() == tcp.fingerprint(), impl.__name__
        ref = qsm_tpu.run_concurrent(
            jimpl(), jprog, seed="t5",
            faults=qsm_tpu.FaultPlan(crash_at={"primary": 4}))
        assert mem.fingerprint() == ref.fingerprint(), impl.__name__


def test_failover_cli_crash_at(capsys):
    from qsm_tpu_torch.utils.cli import main

    rc = main(["run", "--model", "failover", "--impl", "racy",
               "--trials", "120", "--seed", "3",
               "--crash-at", "primary:4", "--backend", "cpu"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "FAIL: failover/racy" in out
