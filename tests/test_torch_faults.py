"""Scheduler faults under the port's property loop, against the JAX
package's (twins of ``tests/test_faults.py``): histories with dropped,
duplicated and delayed messages and crashed pids flow through generate,
execute and check; a correct system stays linearizable (pending ops are
completed or pruned), the same seeds give the reference's histories and
verdicts, and the device checker (``TorchStepper``'s plain versions)
agrees with the oracles on faulty histories."""

from __future__ import annotations

import argparse

import qsm_tpu
from qsm_tpu.models.register import AtomicRegisterSUT as JAtomicReg
from qsm_tpu.models.register import RegisterSpec as JRegister
from qsm_tpu.utils.report import faults_to_doc as j_to_doc
from qsm_tpu_torch import (FaultPlan, PropertyConfig, Recv, Send, Verdict,
                           WingGongCPU, check_one, generate_program,
                           prop_concurrent, run_concurrent)
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.register import (READ, AtomicRegisterSUT,
                                           RegisterSpec)
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.utils.interop import history_to_rows
from qsm_tpu_torch.utils.report import faults_from_doc, faults_to_doc

SPEC = RegisterSpec()
JSPEC = JRegister()


def _jplan(fp):
    """The reference's FaultPlan with the same fields."""
    return qsm_tpu.FaultPlan(
        p_drop=fp.p_drop, p_duplicate=fp.p_duplicate, p_delay=fp.p_delay,
        delay_steps=fp.delay_steps, crash_at=dict(fp.crash_at),
        partitions=[set(g) for g in fp.partitions],
        protected=set(fp.protected))


def _same_run(res, ref):
    assert (res.ok, res.trials_run, res.histories_checked, res.undecided,
            res.distinct_histories) == (ref.ok, ref.trials_run,
                                        ref.histories_checked, ref.undecided,
                                        ref.distinct_histories)
    if not res.ok:
        assert res.counterexample.trial_seed == \
            ref.counterexample.trial_seed
        assert history_to_rows(res.counterexample.history) == \
            history_to_rows(ref.counterexample.history)


def _both(port_sut, ref_sut, faults, **cfg):
    """The property run in both packages, with the reference's FaultPlan
    built from the port's."""
    res = prop_concurrent(SPEC, port_sut, PropertyConfig(faults=faults,
                                                         **cfg))
    ref = qsm_tpu.prop_concurrent(JSPEC, ref_sut, qsm_tpu.PropertyConfig(
        faults=_jplan(faults), **cfg))
    _same_run(res, ref)
    return res


def test_prop_concurrent_atomic_register_under_message_loss():
    res = _both(AtomicRegisterSUT(), JAtomicReg(),
                FaultPlan(p_drop=0.15, protected=set()),
                n_trials=60, n_pids=2, max_ops=10, seed=21)
    assert res.ok, res.counterexample
    assert res.undecided == 0


def _tagged_register(recv, send, read_cmd):
    """Duplicate-tolerant register (the reference test's): requests carry
    a per-pid sequence number, the server dedupes by (client, seq) and the
    client drops responses whose tag is not its own."""

    class TaggedRegisterSUT:
        def setup(self, sched):
            self.store = {"v": 0}
            self.seq = {}
            applied = {}

            def server():
                while True:
                    msg = yield recv()
                    kind, arg, seq = msg.payload
                    last_seq, last_resp = applied.get(msg.src, (0, None))
                    if seq <= last_seq:
                        yield send(msg.src, (seq, last_resp))
                        continue
                    if kind == "write":
                        self.store["v"] = arg
                        resp = 0
                    else:
                        resp = self.store["v"]
                    applied[msg.src] = (seq, resp)
                    yield send(msg.src, (seq, resp))

            sched.spawn("server", server(), daemon=True)

        def perform(self, pid, cmd, arg):
            seq = self.seq[pid] = self.seq.get(pid, 0) + 1
            yield send("server", ("read" if cmd == read_cmd else "write",
                                  arg, seq))
            while True:
                msg = yield recv()
                got_seq, result = msg.payload
                if got_seq == seq:
                    return result

    return TaggedRegisterSUT()


def test_duplication_breaks_untagged_protocol_and_tagging_fixes_it():
    from qsm_tpu.models.register import READ as JREAD

    cfg = dict(n_trials=60, n_pids=2, max_ops=10, seed=22)
    faults = FaultPlan(p_duplicate=0.25)
    res = _both(AtomicRegisterSUT(), JAtomicReg(), faults, **cfg)
    assert not res.ok, "response misattribution went undetected"
    res = _both(_tagged_register(Recv, Send, READ),
                _tagged_register(qsm_tpu.Recv, qsm_tpu.Send, JREAD),
                faults, **cfg)
    assert res.ok, res.counterexample


def test_prop_concurrent_with_pid_crash():
    res = _both(AtomicRegisterSUT(), JAtomicReg(),
                FaultPlan(crash_at={"client:0": 2}),
                n_trials=40, n_pids=2, max_ops=10, seed=23)
    assert res.ok, res.counterexample


def test_racy_cas_still_caught_under_faults():
    from qsm_tpu.models import CasSpec as JCas
    from qsm_tpu.models import RacyCasSUT as JRacyCas

    spec, jspec = CasSpec(), JCas()
    faults = FaultPlan(p_drop=0.05, protected=set())
    cfg = dict(n_trials=80, n_pids=8, max_ops=32, seed=5)
    res = prop_concurrent(spec, RacyCasSUT(spec),
                          PropertyConfig(faults=faults, **cfg))
    assert not res.ok
    ref = qsm_tpu.prop_concurrent(jspec, JRacyCas(jspec),
                                  qsm_tpu.PropertyConfig(
                                      faults=_jplan(faults), **cfg))
    _same_run(res, ref)


def _assert_parity(spec, jspec, hists, jhists, expect_violations):
    assert [h.fingerprint() for h in hists] == \
        [h.fingerprint() for h in jhists]
    cpu = WingGongCPU().check_histories(spec, hists)
    ref = qsm_tpu.WingGongCPU().check_histories(jspec, jhists)
    dev = TorchStepper(spec, device="cpu").check_histories(spec, hists)
    assert cpu.tolist() == ref.tolist() == dev.tolist()
    assert (cpu == Verdict.LINEARIZABLE).any()
    if expect_violations:
        assert (cpu == Verdict.VIOLATION).any()


def test_backend_parity_on_faulty_histories():
    from qsm_tpu.models import AtomicCasSUT as JAtomicCas
    from qsm_tpu.models import CasSpec as JCas
    from qsm_tpu.models import RacyCasSUT as JRacyCas

    spec, jspec = CasSpec(), JCas()
    faults = FaultPlan(p_drop=0.1, protected=set())
    hists, jhists = [], []
    for seed in range(30):
        prog = generate_program(spec, seed=seed, n_pids=4, max_ops=10)
        jprog = qsm_tpu.generate_program(jspec, seed=seed, n_pids=4,
                                         max_ops=10)
        for sut, jsut in ((AtomicCasSUT(spec), JAtomicCas(jspec)),
                          (RacyCasSUT(spec), JRacyCas(jspec))):
            hists.append(run_concurrent(sut, prog, seed=f"f{seed}",
                                        faults=faults))
            jhists.append(qsm_tpu.run_concurrent(jsut, jprog, seed=f"f{seed}",
                                                 faults=_jplan(faults)))
    assert any(h.n_pending for h in hists), "fault sample vacuous"
    _assert_parity(spec, jspec, hists, jhists, expect_violations=False)


def test_fault_plan_doc_roundtrip():
    fp = FaultPlan(p_drop=0.1, p_duplicate=0.2,
                   partitions=[{"a", "b"}], crash_at={"client:0": 3},
                   protected={"server"})
    assert faults_to_doc(fp) == j_to_doc(_jplan(fp))
    fp2 = faults_from_doc(faults_to_doc(fp))
    assert (fp2.p_drop, fp2.p_duplicate) == (0.1, 0.2)
    assert fp2.partitions == [{"a", "b"}]
    assert fp2.crash_at == {"client:0": 3}
    assert fp2.protected == {"server"}
    assert faults_from_doc(faults_to_doc(None)) is None


def test_delay_fault_determinism_and_progress():
    faults = FaultPlan(p_delay=1.0, delay_steps=4)
    prog = generate_program(SPEC, seed=3, n_pids=2, max_ops=8)
    h1 = run_concurrent(AtomicRegisterSUT(), prog, seed="d1", faults=faults)
    h2 = run_concurrent(AtomicRegisterSUT(), prog, seed="d1", faults=faults)
    assert h1.fingerprint() == h2.fingerprint()
    assert len(h1) == len(prog)
    jh = qsm_tpu.run_concurrent(
        JAtomicReg(), qsm_tpu.generate_program(JSPEC, seed=3, n_pids=2,
                                               max_ops=8),
        seed="d1", faults=_jplan(faults))
    assert h1.fingerprint() == jh.fingerprint()


def test_delay_reorders_beyond_pool_reordering():
    prog = generate_program(SPEC, seed=9, n_pids=2, max_ops=10)
    plain = {run_concurrent(AtomicRegisterSUT(), prog,
                            seed=f"s{i}").fingerprint() for i in range(20)}
    delayed = {run_concurrent(
        AtomicRegisterSUT(), prog, seed=f"s{i}",
        faults=FaultPlan(p_delay=0.5, delay_steps=6)).fingerprint()
        for i in range(20)}
    assert delayed - plain, "delay produced no new interleavings"
    jprog = qsm_tpu.generate_program(JSPEC, seed=9, n_pids=2, max_ops=10)
    assert delayed == {qsm_tpu.run_concurrent(
        JAtomicReg(), jprog, seed=f"s{i}",
        faults=qsm_tpu.FaultPlan(p_delay=0.5, delay_steps=6)).fingerprint()
        for i in range(20)}


def test_delay_induced_pending_flows_through_complete_prune():
    faults = FaultPlan(p_delay=1.0, delay_steps=8,
                       crash_at={"client:0": 1})
    prog = generate_program(SPEC, seed=4, n_pids=2, max_ops=8)
    hs = [run_concurrent(AtomicRegisterSUT(), prog, seed=f"dc{i}",
                         faults=faults) for i in range(10)]
    assert any(h.n_pending for h in hs), "no delay-induced pending op"
    for h in hs:
        assert check_one(WingGongCPU(), SPEC, h) == Verdict.LINEARIZABLE
    jprog = qsm_tpu.generate_program(JSPEC, seed=4, n_pids=2, max_ops=8)
    jhs = [qsm_tpu.run_concurrent(JAtomicReg(), jprog, seed=f"dc{i}",
                                  faults=_jplan(faults)) for i in range(10)]
    _assert_parity(SPEC, JSPEC, hs, jhs, expect_violations=False)


def test_fault_plan_delay_doc_roundtrip():
    fp = FaultPlan(p_delay=0.3, delay_steps=7)
    fp2 = faults_from_doc(faults_to_doc(fp))
    assert (fp2.p_delay, fp2.delay_steps) == (0.3, 7)
    doc = faults_to_doc(FaultPlan(p_drop=0.1))
    del doc["p_delay"], doc["delay_steps"]
    fp3 = faults_from_doc(doc)
    assert (fp3.p_delay, fp3.delay_steps) == (0.0, 3)


def test_partition_cli_flag_and_wedge_semantics(capsys):
    from qsm_tpu_torch.utils.cli import main

    rc = main(["run", "--model", "register", "--impl", "replicated",
               "--trials", "20", "--partition", "replica:1",
               "--backend", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out


def test_partition_flag_parses_to_plan():
    from qsm_tpu_torch.utils.cli import _faults_from_args

    ns = argparse.Namespace(p_drop=0.0, p_duplicate=0.0, p_delay=0.0,
                            delay_steps=3, crash_at=[],
                            partition=["a,b", "c"])
    fp = _faults_from_args(ns)
    assert fp is not None and fp.partitions == [{"a", "b"}, {"c"}]
    assert fp.is_deterministic()


def test_partition_replay_hint_round_trips(capsys):
    from qsm_tpu_torch.utils.cli import main

    rc = main(["run", "--model", "register", "--impl", "racy",
               "--trials", "60", "--partition", "bystander",
               "--backend", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1, out
    replay_line = [ln for ln in out.splitlines()
                   if ln.startswith("replay:")][0]
    assert "--partition bystander" in replay_line


def test_partition_explorable():
    from qsm_tpu.models.register import ReplicatedRegisterSUT as JRepl
    from qsm_tpu.sched.systematic import explore_program as j_explore
    from qsm_tpu_torch.models.register import ReplicatedRegisterSUT
    from qsm_tpu_torch.sched.systematic import explore_program

    prog = generate_program(SPEC, seed=2, n_pids=2, max_ops=3)
    res = explore_program(lambda: ReplicatedRegisterSUT(), prog, SPEC,
                          faults=FaultPlan(partitions=[{"replica:1"}]),
                          max_schedules=20_000)
    assert res.exhausted
    ref = j_explore(lambda: JRepl(),
                    qsm_tpu.generate_program(JSPEC, seed=2, n_pids=2,
                                             max_ops=3), JSPEC,
                    faults=qsm_tpu.FaultPlan(partitions=[{"replica:1"}]),
                    max_schedules=20_000)
    assert (res.schedules_run, res.pruned_schedules,
            res.distinct_histories, res.violations) == (
        ref.schedules_run, ref.pruned_schedules, ref.distinct_histories,
        ref.violations)
