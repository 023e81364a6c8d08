"""The port's systematic exploration (``qsm_tpu_torch/sched/systematic.py``)
against the JAX package's, the twin of ``tests/test_systematic.py``: on
the same programs and fault plans, ``explore_program`` / ``explore_many``
give equal ``schedules_run``, ``pruned_schedules``, ``distinct_histories``,
``exhausted``, ``violations`` and ``undecided``, and the same histories as
rows (with their schedule keys), in the same order; pruned and unpruned
walks give equal history sets on every family; the convicted / certified
pairs, the crash sweeps and partitions, ``shrink_explored`` and the
``explore`` / ``coverage`` / ``replay`` entry points agree.  Tolerance 0.
The port's device backends are reached only with ``device="cpu"``."""

from __future__ import annotations

import json

import numpy as np
import pytest

from qsm_tpu.core.generator import ProgOp as JProgOp
from qsm_tpu.core.generator import Program as JProgram
from qsm_tpu.core.generator import generate_program as jgen
from qsm_tpu.core.property import _default_oracle as j_default_oracle
from qsm_tpu.models.registry import make as jmake
from qsm_tpu.sched import systematic as jsys
from qsm_tpu.sched.runner import run_concurrent as jrun
from qsm_tpu.sched.scheduler import FaultPlan as JFaultPlan
from qsm_tpu.utils.cli import main as jmain
from qsm_tpu_torch.core.generator import ProgOp, Program, generate_program
from qsm_tpu_torch.core.property import _default_oracle as t_default_oracle
from qsm_tpu_torch.models.registry import SutFactory, make
from qsm_tpu_torch.models.set import ADD
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.sched import systematic as tsys
from qsm_tpu_torch.sched.runner import run_concurrent
from qsm_tpu_torch.sched.scheduler import FaultPlan
from qsm_tpu_torch.utils.cli import main
from qsm_tpu_torch.utils.interop import history_to_rows

SET_KW = {"n_keys": 2}
SET_OPS = ((0, ADD, 0), (1, ADD, 0))


def _progs(ops, n_pids):
    return (Program(tuple(ProgOp(*o) for o in ops), n_pids=n_pids),
            JProgram(tuple(JProgOp(*o) for o in ops), n_pids=n_pids))


def _pair(model, impl, spec_kw=None):
    """(port spec, port factory, reference spec, reference factory)."""
    spec, _ = make(model, impl, spec_kw)
    jspec, _ = jmake(model, impl, spec_kw)
    return (spec, lambda: make(model, impl, spec_kw)[1],
            jspec, lambda: jmake(model, impl, spec_kw)[1])


def _counts(r):
    return (r.schedules_run, r.pruned_schedules, r.distinct_histories,
            r.exhausted, r.violations, r.undecided, r.verified)


def _keyed_rows(hists):
    return [(h.seed, history_to_rows(h)) for h in hists]


def _same_result(got, want):
    assert _counts(got) == _counts(want)
    if want.violating is None:
        assert got.violating is None
    else:
        assert got.violating.seed == want.violating.seed
        assert history_to_rows(got.violating) == \
            history_to_rows(want.violating)


def test_next_prefix_enumerates_constant_tree_exactly_once():
    for mod in (tsys, jsys):
        leaves, prefix = [], []
        while prefix is not None:
            leaves.append(tuple((prefix + [0, 0])[:2]))
            prefix = mod._next_prefix(prefix, [2, 2])
        assert leaves == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_schedule_key_round_trips_like_the_reference():
    for script in ([], [0], [1, 0, 2], [3] * 9):
        key = tsys.schedule_key(script)
        assert key == jsys.schedule_key(script)
        assert tsys.parse_schedule_key(key) == script
    for other in ("3:1", "3:1#2", 7, None):
        assert tsys.parse_schedule_key(other) is None
        assert jsys.parse_schedule_key(other) is None


@pytest.mark.parametrize("choices", [[1, 0, 1], [0, 0, 0], [2, 1], [9, 9]])
def test_scripted_choices_replay_the_reference(choices):
    prog, jprog = _progs(SET_OPS, 2)
    spec, tf, jspec, jf = _pair("set", "racy", SET_KW)
    info = {}
    h = run_concurrent(tf(), prog, seed=0, choices=choices, sched_info=info)
    h2 = run_concurrent(tf(), prog, seed=99, choices=choices)
    jinfo = {}
    jh = jrun(jf(), jprog, seed=0, choices=choices, sched_info=jinfo)
    assert history_to_rows(h) == history_to_rows(h2) == history_to_rows(jh)
    assert info == jinfo


def _failover_ops():
    from qsm_tpu_torch.models.failover import READ, WRITE

    return ((0, WRITE, 1), (0, READ, 0), (1, READ, 0), (1, READ, 0))


# (model, impl, spec kwargs, program ops, pids, crash plan, max_schedules)
EXPLORE_CASES = {
    "set-racy-toctou": ("set", "racy", SET_KW, SET_OPS, 2, None, 10_000),
    "set-atomic-toctou": ("set", "atomic", SET_KW, SET_OPS, 2, None, 10_000),
    "set-truncated": ("set", "atomic", SET_KW, SET_OPS, 2, None, 2),
    "register-racy": ("register", "racy", {"n_values": 3},
                      ((0, 1, 1), (1, 0, 0), (1, 0, 0)), 2, None, 10_000),
    "register-atomic": ("register", "atomic", {"n_values": 3},
                        ((0, 1, 1), (1, 0, 0), (1, 0, 0)), 2, None, 10_000),
    "failover-sync-crash": ("failover", "atomic", None, "failover", 2,
                            {"primary": 2}, 30_000),
    "failover-async-crash": ("failover", "racy", None, "failover", 2,
                             {"primary": 2}, 30_000),
}


def _walk_and_decide(mod, default_oracle, factory, prog, spec, cap,
                     faults):
    """One walk of the tree and its verdicts, as ``explore_program``
    makes them: (histories, counts, first violating history)."""
    hs, n, exh, pruned = mod._enumerate(factory, prog, cap, 100_000,
                                        faults=faults)
    verdicts = np.asarray(default_oracle(spec).check_histories(spec, hs))
    vio, und, violating = mod._summarize(hs, verdicts)
    return hs, (n, pruned, len(hs), exh, vio, und), violating


@pytest.mark.parametrize("case", sorted(EXPLORE_CASES))
def test_explore_program_equals_the_reference(case):
    """Histories as rows and their schedule keys in walk order, the
    counts and the first violating history, both packages (one walk
    each); where the tree is small ``explore_program`` itself too.  The
    convicted crash case's violating schedule replays bit-identically
    under its plan."""
    model, impl, kw, ops, pids, crash, cap = EXPLORE_CASES[case]
    ops = _failover_ops() if ops == "failover" else ops
    prog, jprog = _progs(ops, pids)
    spec, tf, jspec, jf = _pair(model, impl, kw)
    plan = FaultPlan(crash_at=crash) if crash else None
    jplan = JFaultPlan(crash_at=crash) if crash else None
    hs, counts, violating = _walk_and_decide(tsys, t_default_oracle, tf,
                                             prog, spec, cap, plan)
    jhs, jcounts, jviolating = _walk_and_decide(
        jsys, j_default_oracle, jf, jprog, jspec, cap, jplan)
    assert _keyed_rows(hs) == _keyed_rows(jhs)
    assert counts == jcounts
    assert (violating is None) == (jviolating is None)
    if violating is not None:
        assert violating.seed == jviolating.seed
        assert history_to_rows(violating) == history_to_rows(jviolating)
    if crash is None:
        got = tsys.explore_program(tf, prog, spec, max_schedules=cap)
        _same_result(got, jsys.explore_program(jf, jprog, jspec,
                                               max_schedules=cap))
        assert _counts(got)[:6] == counts
    n, _, _, exhausted, vio, und = counts
    if case == "set-racy-toctou":
        assert vio > 0
        assert [o.resp for o in violating.ops] == [1, 1]
    if case in ("set-atomic-toctou", "register-atomic",
                "failover-sync-crash"):
        assert exhausted and vio == 0 and und == 0
    if case == "set-truncated":
        assert n == 2 and not exhausted
    if case == "failover-async-crash":
        assert exhausted and vio > 0
        h = run_concurrent(tf(), prog, seed=violating.seed, faults=plan,
                           choices=tsys.parse_schedule_key(violating.seed))
        assert h.fingerprint() == violating.fingerprint()


def test_explore_refuses_probabilistic_faults():
    prog, _ = _progs(SET_OPS, 2)
    spec, tf, _, _ = _pair("set", "atomic", SET_KW)
    with pytest.raises(ValueError, match="PROBABILISTIC"):
        tsys.explore_program(tf, prog, spec, faults=FaultPlan(p_drop=0.5))
    with pytest.raises(ValueError, match="PROBABILISTIC"):
        tsys.explore_many(tf, [prog], spec, faults=FaultPlan(p_delay=0.1))
    assert tsys.deterministic_faults(FaultPlan(crash_at={"a": 1},
                                               partitions=[{"a"}]))


@pytest.mark.parametrize("family,seed", [("register", 11), ("queue", 0)])
def test_every_family_has_a_convicted_certified_pair(family, seed):
    """The reference's pinned pairs: the racy impl convicted by exhaustive
    exploration, the atomic verified, on the same program."""
    for impl in ("racy", "atomic"):
        spec, tf, jspec, jf = _pair(family, impl)
        prog = generate_program(spec, seed=seed, n_pids=2, max_ops=5)
        jprog = jgen(jspec, seed=seed, n_pids=2, max_ops=5)
        assert [(o.pid, o.cmd, o.arg) for o in prog.ops] == \
            [(o.pid, o.cmd, o.arg) for o in jprog.ops]
        got = tsys.explore_program(tf, prog, spec, max_schedules=60_000)
        _same_result(got, jsys.explore_program(jf, jprog, jspec,
                                               max_schedules=60_000))
        if impl == "racy":
            assert got.exhausted and got.violations > 0
        else:
            assert got.verified


def _prune_cases():
    """The reference's pruning-soundness cases: (name, model, impl, spec
    kwargs, seed, pids, ops)."""
    return [("replicated-register", "register", "replicated",
             {"n_values": 3}, 3, 2, 4),
            ("racy-register", "register", "racy", {"n_values": 3}, 1, 3, 4),
            ("racy-set", "set", "racy", SET_KW, 10, 3, 5),
            ("atomic-cas", "cas", "atomic", {"n_values": 3}, 2, 2, 4),
            ("racy-ticket", "ticket", "racy", None, 4, 2, 4)]


@pytest.mark.parametrize("case", _prune_cases(), ids=lambda c: c[0])
def test_prune_preserves_history_sets_across_families(case):
    _, model, impl, kw, seed, pids, ops = case
    spec, tf, jspec, jf = _pair(model, impl, kw)
    prog = generate_program(spec, seed=seed, n_pids=pids, max_ops=ops)
    jprog = jgen(jspec, seed=seed, n_pids=pids, max_ops=ops)
    walks = {}
    for prune in (False, True):
        hs, n, exh, pruned = tsys._enumerate(tf, prog, 20_000, 100_000,
                                             prune=prune)
        jhs, jn, jexh, jpruned = jsys._enumerate(jf, jprog, 20_000,
                                                 100_000, prune=prune)
        assert exh and jexh
        assert (n, pruned) == (jn, jpruned)
        assert _keyed_rows(hs) == _keyed_rows(jhs)
        walks[prune] = ({h.fingerprint() for h in hs}, n)
    assert walks[True][0] == walks[False][0]
    assert walks[True][1] <= walks[False][1]


def test_prune_preserves_history_sets_under_crash_plan():
    from qsm_tpu_torch.models.failover import READ, WRITE

    prog, jprog = _progs(((0, WRITE, 1), (1, READ, 0)), 2)
    spec, tf, jspec, jf = _pair("failover", "racy")
    sets = []
    for prune in (False, True):
        hs, n, exh, _ = tsys._enumerate(
            tf, prog, 50_000, 100_000, prune=prune,
            faults=FaultPlan(crash_at={"primary": 2}))
        jhs, jn, jexh, _ = jsys._enumerate(
            jf, jprog, 50_000, 100_000, prune=prune,
            faults=JFaultPlan(crash_at={"primary": 2}))
        assert exh and jexh and n == jn
        assert _keyed_rows(hs) == _keyed_rows(jhs)
        sets.append({h.fingerprint() for h in hs})
    assert sets[0] == sets[1]


def test_prune_still_finds_the_violation():
    prog, _ = _progs(SET_OPS, 2)
    spec, tf, _, _ = _pair("set", "racy", SET_KW)
    pruned = tsys.explore_program(tf, prog, spec, prune=True)
    plain = tsys.explore_program(tf, prog, spec, prune=False)
    assert pruned.exhausted and pruned.violations > 0
    assert plain.violations == pruned.violations
    assert plain.distinct_histories == pruned.distinct_histories


def test_prune_exhausts_the_truncation_case():
    """set/racy, 3 pids x 5 ops, seed 5: the pruned walk exhausts it in
    under 1000 schedules, with the prune firing, as the reference's."""
    spec, tf, jspec, jf = _pair("set", "racy")
    prog = generate_program(spec, seed=5, n_pids=3, max_ops=5)
    res = tsys.explore_program(tf, prog, spec, max_schedules=1_000)
    want = jsys.explore_program(jf, jgen(jspec, seed=5, n_pids=3,
                                         max_ops=5), jspec,
                                max_schedules=1_000)
    _same_result(res, want)
    assert res.exhausted and res.schedules_run < 1_000
    assert 0 < res.pruned_schedules < res.schedules_run
    assert res.distinct_histories > 35


def test_shrink_explored_reaches_the_reference_program():
    noisy = ((0, ADD, 0), (0, 2, 1), (1, ADD, 0), (1, 2, 1))
    prog, jprog = _progs(noisy, 2)
    spec, tf, jspec, jf = _pair("set", "racy", SET_KW)
    p, res, steps = tsys.shrink_explored(tf, prog, spec)
    jp, jres, jsteps = jsys.shrink_explored(jf, jprog, jspec)
    assert steps == jsteps > 0
    assert [(o.pid, o.cmd, o.arg) for o in p.ops] == \
        [(o.pid, o.cmd, o.arg) for o in jp.ops]
    assert len(p) == 2 and all(o.cmd == ADD and o.arg == 0 for o in p.ops)
    _same_result(res, jres)


def test_shrink_explored_passing_program_untouched():
    prog, _ = _progs(SET_OPS, 2)
    spec, tf, _, _ = _pair("set", "atomic", SET_KW)
    p, res, steps = tsys.shrink_explored(tf, prog, spec)
    assert steps == 0 and res.violations == 0 and p is prog


@pytest.mark.parametrize("backend", ["oracle", "stepper"])
def test_explore_many_equals_per_program_and_the_reference(backend):
    """The union of the trees decided in one backend call: each program's
    result equals its own exploration and the reference's union; through
    the plain stepper (``device="cpu"``) the decided verdicts are the
    oracle's."""
    spec, tf, jspec, jf = _pair("set", "racy", SET_KW)
    progs = [generate_program(spec, seed=s, n_pids=2, max_ops=5)
             for s in range(6)] + [_progs(SET_OPS, 2)[0]]
    jprogs = [jgen(jspec, seed=s, n_pids=2, max_ops=5)
              for s in range(6)] + [_progs(SET_OPS, 2)[1]]
    b = TorchStepper(spec, device="cpu") if backend == "stepper" else None
    got = tsys.explore_many(tf, progs, spec, backend=b, max_schedules=500)
    want = jsys.explore_many(jf, jprogs, jspec, max_schedules=500)
    assert len(got) == len(progs)
    for prog, g, w in zip(progs, got, want):
        _same_result(g, w)
        solo = tsys.explore_program(tf, prog, spec, backend=b,
                                    max_schedules=500)
        assert _counts(solo) == _counts(g)
    assert got[-1].violations > 0


def test_enumerate_many_is_the_serial_walk():
    spec, tf, _, _ = _pair("register", "racy")
    progs = [generate_program(spec, seed=s, n_pids=2, max_ops=4)
             for s in range(3)]
    walked = tsys.enumerate_many(tf, progs, 5_000, 100_000)
    for prog, (hs, n, exh, pruned, secs) in zip(progs, walked):
        hs2, n2, exh2, pruned2 = tsys._enumerate(tf, prog, 5_000, 100_000)
        assert (n, exh, pruned) == (n2, exh2, pruned2) and secs >= 0
        assert _keyed_rows(hs) == _keyed_rows(hs2)


# ---------------------------------------------------------------------------
# The entry points: explore / coverage / replay, the port's lines equal
# to the reference's apart from ``seconds``
# ---------------------------------------------------------------------------

def _lines(capsys):
    out = [json.loads(x) for x in
           capsys.readouterr().out.strip().splitlines()]
    for d in out:
        d.pop("seconds", None)
    return out


def _both(capsys, argv, port_extra=("--device", "cpu")):
    rc = main(list(argv) + list(port_extra))
    got = _lines(capsys)
    jrc = jmain(list(argv))
    want = _lines(capsys)
    assert (rc, got) == (jrc, want)
    return rc, got


def test_explore_cli_equals_the_reference(capsys):
    rc, lines = _both(capsys, ["explore", "--model", "set", "--impl",
                               "racy", "--pids", "2", "--ops", "4",
                               "--seed", "1"])
    assert lines[0]["schedules_run"] >= 1 and rc in (0, 1)


def test_explore_many_cli_equals_the_reference(capsys):
    rc, lines = _both(capsys, ["explore", "--model", "set", "--impl",
                               "atomic", "--pids", "2", "--ops", "4",
                               "--seed", "0", "--programs", "5"])
    assert rc == 0 and len(lines) == 6
    assert lines[-1]["programs"] == 5 and lines[-1]["all_verified"] is True
    with pytest.raises(SystemExit, match="sweep"):
        main(["explore", "--model", "set", "--programs", "3", "--shrink"])


def test_crash_sweep_cli_equals_the_reference(capsys):
    rc, lines = _both(capsys, ["explore", "--model", "failover", "--impl",
                               "atomic", "--pids", "2", "--ops", "4",
                               "--seed", "9", "--crash-sweep", "primary:1-2",
                               "--max-schedules", "30000"])
    assert rc == 0 and len(lines) == 3
    assert lines[-1]["all_verified"] is True
    # the convicted point: its tree equals the reference's
    # (test_explore_program_equals_the_reference[failover-async-crash])
    rc = main(["explore", "--model", "failover", "--impl", "racy",
               "--pids", "2", "--ops", "4", "--seed", "9", "--crash-sweep",
               "primary:2-2", "--max-schedules", "30000", "--backend",
               "cpp"])
    lines = _lines(capsys)
    assert rc == 1 and lines[0]["violations"] > 0 and lines[0]["exhausted"]
    assert lines[0]["violating_schedule"].startswith("explore:")


def test_crash_sweep_cli_rejects_bad_combos():
    with pytest.raises(SystemExit, match="crash-sweep"):
        main(["explore", "--model", "failover", "--crash-sweep",
              "primary:1-3", "--crash-at", "backup:2"])
    with pytest.raises(SystemExit, match="NAME:LO-HI"):
        main(["explore", "--model", "failover", "--crash-sweep",
              "primary"])
    with pytest.raises(SystemExit, match="empty"):
        main(["explore", "--model", "failover", "--crash-sweep",
              "primary:5-3"])
    with pytest.raises(SystemExit, match="no process named"):
        main(["explore", "--model", "failover", "--crash-sweep",
              "pirmary:1-3"])
    with pytest.raises(SystemExit, match="DETERMINISTIC"):
        main(["explore", "--model", "set", "--impl", "racy",
              "--pids", "2", "--ops", "4", "--p-drop", "0.2"])


def test_crash_sweep_inconclusive_exits_2(capsys):
    rc, lines = _both(capsys, ["explore", "--model", "failover", "--impl",
                               "atomic", "--pids", "2", "--ops", "4",
                               "--seed", "9", "--crash-sweep", "primary:2-2",
                               "--max-schedules", "50"])
    assert rc == 2
    assert lines[0]["exhausted"] is False
    assert lines[-1]["all_verified"] is False


def test_crash_sweep_composes_with_partition(capsys):
    argv = ["explore", "--model", "failover", "--impl", "atomic",
            "--pids", "2", "--ops", "4", "--seed", "9",
            "--crash-sweep", "primary:1-2", "--max-schedules", "30000"]
    rc, part = _both(capsys, argv + ["--partition", "backup"],
                     port_extra=("--backend", "cpp"))
    assert rc in (0, 2)
    _, plain = _both(capsys, argv, port_extra=("--backend", "cpp"))
    assert [p["schedules_run"] for p in part[:-1]] != \
        [p["schedules_run"] for p in plain[:-1]]


def test_explore_crash_regression_replays_in_both_packages(tmp_path,
                                                          capsys):
    """explore --crash-at --save-regression in the port; the file replays
    bit-identically in both packages."""
    path = str(tmp_path / "t.json")
    assert main(["explore", "--model", "failover", "--impl", "racy",
                 "--pids", "2", "--ops", "4", "--seed", "9",
                 "--crash-at", "primary:2", "--max-schedules", "30000",
                 "--device", "cpu", "--save-regression", path]) == 1
    line = _lines(capsys)[0]
    assert line["exhausted"] and line["violations"] > 0
    for fn in (main, jmain):
        assert fn(["replay", "--regression", path]) == 1
        assert "history reproduced bit-identically: True" in \
            capsys.readouterr().out


def test_explore_shrink_and_set_regression(tmp_path, capsys):
    path = str(tmp_path / "explored.json")
    rc = main(["explore", "--model", "set", "--impl", "racy", "--pids", "3",
               "--ops", "6", "--seed", "25", "--max-schedules", "3000",
               "--backend", "cpp", "--save-regression", path])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert rc == 1 and out["violating_schedule"].startswith("explore:")
    assert main(["replay", "--regression", path]) == 1
    assert "history reproduced bit-identically: True" in \
        capsys.readouterr().out
    rc, lines = _both(capsys, ["explore", "--model", "set", "--impl",
                               "racy", "--pids", "2", "--ops", "5",
                               "--seed", "25", "--shrink"],
                      port_extra=("--backend", "cpp"))
    assert rc == 1 and lines[0]["violations"] > 0


def test_coverage_exact_cli_equals_the_reference(capsys):
    rc, lines = _both(capsys, ["coverage", "--model", "set", "--impl",
                               "racy", "--pids", "2", "--ops", "4",
                               "--runs", "30", "--exact"], port_extra=())
    out = lines[0]
    assert rc == 0 and out["exact"]["exhausted"] is True
    assert out["exact"]["distinct_histories"] >= out["distinct_histories"]
    assert 0 < out["sampled_history_coverage"] <= 1.0


def test_explore_workers_flag_needs_programs():
    with pytest.raises(SystemExit, match="workers"):
        main(["explore", "--model", "set", "--workers", "2"])


def test_explore_program_through_the_sut_factory():
    spec, _ = make("set", "racy", SET_KW)
    prog, _ = _progs(SET_OPS, 2)
    a = tsys.explore_program(SutFactory("set", "racy", SET_KW), prog, spec)
    b = tsys.explore_program(lambda: make("set", "racy", SET_KW)[1], prog,
                             spec)
    assert _counts(a) == _counts(b)
