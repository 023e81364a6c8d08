"""The port's search plane against the JAX package's (every case of
``tests/test_search.py``): selectivity tables equal for every registry
family, permutations equal, ordered verdicts and node counts equal,
ordered witnesses replaying in both packages, ``plan_search(...,
"cpu").describe()`` equal to the reference's, the port's own CUDA plan
from ``ops/stepper.py``'s defaults (``"tpu"`` refused, a mesh sized),
``TorchStepper(device="cpu")`` counters equal to ``JaxTPU``'s at the
shared CPU plan (hand, ``plan=`` kernel-only, ``ordering=True``), the
planned composition's ``SearchStats`` and the CAS-32 iters/history ratio
hand : planned equal to the reference's, and the ``stats`` CLI document.
Tolerance: exact everywhere (selectivities are compared as float64
arrays, bit for bit)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from qsm_tpu.models import AtomicCasSUT, CasSpec as JCas, RacyCasSUT
from qsm_tpu.models.registry import MODELS as J_MODELS
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle
from qsm_tpu.search import ordering_table as j_ordering_table
from qsm_tpu.search import plan_search as j_plan_search
from qsm_tpu.search import profile_corpus as j_profile_corpus
from qsm_tpu.search.planner import build_backend as j_build_backend
from qsm_tpu.utils.cli import main as j_cli_main
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.registry import MODELS as T_MODELS
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.backend import verify_witness as t_verify_witness
from qsm_tpu_torch.ops.gpu_backend import TorchGPU
from qsm_tpu_torch.ops.hybrid import HybridDevice
from qsm_tpu_torch.ops.stepper import (BATCH_BUCKETS, CHUNK_SCHEDULE,
                                       TorchStepper, default_slots)
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.search import (SearchPlan, collect_search_stats,
                                  ordering_table, permute_history,
                                  plan_search, profile_corpus)
from qsm_tpu_torch.search.planner import CPU_PLAN, CUDA_PLAN, build_backend
from qsm_tpu_torch.utils.cli import main as t_cli_main
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

JSPEC, TSPEC = JCas(), CasSpec()
COUNTERS = ("memo_prunes", "memo_inserts", "compactions", "rounds_run",
            "lockstep_cost", "rescued", "device_histories")


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _cas_corpus(n=24, n_pids=4, max_ops=16, seed_base=0):
    return build_corpus(JSPEC, (AtomicCasSUT, RacyCasSUT), n=n,
                        n_pids=n_pids, max_ops=max_ops,
                        seed_base=seed_base, seed_prefix="search")


def _decided_equal(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    both = (ref != int(Verdict.BUDGET_EXCEEDED)) & \
           (got != int(Verdict.BUDGET_EXCEEDED))
    assert not (both & (ref != got)).any()


def _host_compaction(j):
    """The reference's host compaction, whose collision winner is defined
    (its device compaction scatters duplicates in an unspecified order),
    so that its counters can be compared with the port's."""
    j._compact_carry = j._compact_carry_host
    return j


def _hand_plan_kw(j):
    """``JaxTPU``'s class plan as ``TorchStepper`` arguments."""
    return dict(chunk_schedule=j.CHUNK_SCHEDULE,
                batch_buckets=j.BATCH_BUCKETS,
                slots_for_batch={b: j._slots_for(b) for b in j.BATCH_BUCKETS})


def _family_spec(name):
    return J_MODELS[name].make_spec(), T_MODELS[name].make_spec()


def _family_corpus(name, n=8):
    entry = J_MODELS[name]
    return build_corpus(entry.make_spec(),
                        (entry.impls["atomic"], entry.impls["racy"]), n=n,
                        n_pids=min(entry.default_pids, 4),
                        max_ops=min(entry.default_ops, 16),
                        seed_prefix="ordpar")


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------

def test_cas_selectivity_ranks_constrained_ops_first():
    from qsm_tpu_torch.models.cas import CAS as CAS_OP, READ, WRITE

    table = ordering_table(TSPEC)
    assert table is not None
    assert np.array_equal(table.sel, j_ordering_table(JSPEC).sel)
    n = TSPEC.n_values
    for v in range(n):
        assert table.rank(WRITE, v, 0) == pytest.approx(1.0)
        assert table.rank(READ, 0, v) == pytest.approx(1 / n)
        arg = TSPEC.cas_arg(v, 0)
        assert table.rank(CAS_OP, arg, 1) == pytest.approx(1 / n)
        assert table.rank(CAS_OP, arg, 0) == pytest.approx((n - 1) / n)
    assert table.rank(READ, 0, 99) == 0.0


@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_selectivity_tables_equal_the_reference(name):
    jspec, tspec = _family_spec(name)
    jt, tt = j_ordering_table(jspec), ordering_table(tspec)
    assert (jt is None) == (tt is None)
    if tt is not None:
        assert tt.sel.dtype == jt.sel.dtype
        assert np.array_equal(tt.sel, jt.sel)


def test_permutations_equal_the_reference_and_keep_precedence():
    jt, tt = j_ordering_table(JSPEC), ordering_table(TSPEC)
    hs = _cas_corpus(n=6)
    for h, th in zip(hs, _port(hs)):
        p = tt.permutation(th)
        assert np.array_equal(p, jt.permutation(h))
        assert sorted(p) == list(range(len(th.ops)))
        ph = permute_history(th, p)
        ref = {(th.ops[a].invoke_time, th.ops[b].invoke_time)
               for a in range(len(th)) for b in range(len(th))
               if th.ops[a].response_time < th.ops[b].invoke_time}
        got = {(ph.ops[a].invoke_time, ph.ops[b].invoke_time)
               for a in range(len(ph)) for b in range(len(ph))
               if ph.ops[a].response_time < ph.ops[b].invoke_time}
        assert ref == got


@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_ordered_oracle_equals_the_reference(name):
    """Verdicts (ordering on and off) and ``nodes_explored`` with
    ordering on equal to the reference oracle's, family by family."""
    jspec, tspec = _family_spec(name)
    hs = _family_corpus(name)
    ths = _port(hs)
    ref = JOracle(memo=True, ordering=True)
    got = WingGongCPU(memo=True, ordering=True)
    rv = ref.check_histories(jspec, hs)
    assert list(got.check_histories(tspec, ths)) == list(rv)
    assert list(WingGongCPU(memo=True).check_histories(tspec, ths)) == \
        list(rv)
    assert got.nodes_explored == ref.nodes_explored
    assert got.search_stats().ordering and got.search_stats().histories \
        >= len(hs)


def test_ordered_witnesses_replay_in_both_packages():
    """``chosen`` indexes the permuted ops: witnesses are mapped back and
    replay against the original history in both packages, equal to the
    reference's ``JaxTPU(ordering=True)`` witness (the same search); and
    ``TorchGPU(ordering=True)``'s replay too."""
    ref = JaxTPU(JSPEC, ordering=True)
    dev = TorchStepper(TSPEC, ordering=True, device="cpu")
    gpu = TorchGPU(TSPEC, ordering=True, device="cpu")
    n_lin = 0
    hs = _cas_corpus(n=8, max_ops=12)
    for h, th in zip(hs, _port(hs)):
        v, w = dev.check_witness(TSPEC, th)
        gv, gw = gpu.check_witness(TSPEC, th)
        assert gv == v
        if v == Verdict.LINEARIZABLE and th.n_pending == 0:
            assert t_verify_witness(TSPEC, th, w)
            assert j_verify_witness(JSPEC, h, w)
            assert ref.check_witness(JSPEC, h)[1] == w
            assert t_verify_witness(TSPEC, th, gw)
            assert j_verify_witness(JSPEC, h, gw)
            n_lin += 1
    assert n_lin > 0
    assert dev.search_stats().ordering


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def _profiles(name):
    jspec, tspec = _family_spec(name)
    hs = _family_corpus(name, n=12)
    return (jspec, tspec, j_profile_corpus(hs, jspec),
            profile_corpus(_port(hs), tspec))


@pytest.mark.parametrize("name", ["cas", "queue", "kv", "multireg"])
def test_cpu_plan_describes_as_the_reference(name):
    jspec, tspec, jprof, tprof = _profiles(name)
    assert dataclasses.asdict(tprof) == dataclasses.asdict(jprof)
    jp = j_plan_search(jspec, jprof, platform="cpu")
    tp = plan_search(tspec, tprof, platform="cpu")
    assert tp.name == CPU_PLAN
    assert tp.describe() == jp.describe()
    assert tp.batch_buckets == tuple(jp.batch_buckets)
    assert tp.slots_for_batch == dict(jp.slots_for_batch)
    assert j_plan_search(jspec, None, platform="cpu").describe() == \
        plan_search(tspec, None, platform="cpu").describe()


@pytest.mark.parametrize("name", ["cas", "queue", "kv"])
def test_cuda_plan_is_the_steppers_defaults(name):
    """The port's plan for the card: ``ops/stepper.py``'s schedule,
    buckets and ``default_slots`` at the spec's key width, no unroll;
    also what ``platform=None`` means.  No TPU plan; one device unless
    ``mesh_devices`` says otherwise."""
    _, tspec, _, tprof = _profiles(name)
    p = plan_search(tspec, tprof)
    assert p == plan_search(tspec, tprof, platform="cuda")
    assert p.name == CUDA_PLAN and p.unroll is None and p.mesh_devices == 1
    assert p.chunk_schedule == CHUNK_SCHEDULE
    assert p.batch_buckets == BATCH_BUCKETS
    t = TorchStepper(tspec, device="cpu")
    assert p.slots_for_batch == t.slots_for_batch == {
        b: default_slots(b, t.kspec.STATE_DIM) for b in BATCH_BUCKETS}
    planned = TorchStepper(tspec, device="cpu", plan=p)
    assert (planned.chunk_schedule, planned.batch_buckets,
            planned.slots_for_batch) == (t.chunk_schedule,
                                         t.batch_buckets, t.slots_for_batch)
    assert planned.search_stats().plan == CUDA_PLAN
    cpu = plan_search(tspec, tprof, platform="cpu")
    assert (p.ordering, p.decompose, p.decompose_keys) == \
        (cpu.ordering, cpu.decompose, cpu.decompose_keys)
    assert any("cuda platform" in w for w in p.why)


def test_cuda_plan_first_chunk_covers_the_longest_lane():
    prof = dataclasses.replace(profile_corpus(_port(_cas_corpus(n=4))),
                               max_ops=3000)
    p = plan_search(TSPEC, prof)
    assert p.chunk_schedule[0] >= 3000
    assert p.chunk_schedule == tuple(4 * c for c in CHUNK_SCHEDULE)


def test_tpu_platform_and_meshes_are_refused():
    """No TPU plan; a mesh-sized plan is planned (``@mesh2``), and a mesh
    the machine's cards cannot hold is refused when the engine is built
    (a mesh of logical host devices needs ``device="cpu"``)."""
    import torch

    from qsm_tpu_torch.ops.backend import BackendUnavailable

    prof = profile_corpus(_port(_cas_corpus(n=4)))
    with pytest.raises(ValueError, match="tpu"):
        plan_search(TSPEC, prof, platform="tpu")
    mesh = plan_search(TSPEC, prof, mesh_devices=2)
    assert mesh.name == f"{CUDA_PLAN}@mesh2" and mesh.mesh_devices == 2
    if torch.cuda.device_count() < 2:
        with pytest.raises((ValueError, BackendUnavailable),
                           match="devices|CUDA"):
            build_backend(TSPEC, mesh)
    from qsm_tpu_torch.mesh import backend_sharding

    cpu = build_backend(TSPEC, mesh, device="cpu")
    assert backend_sharding(cpu).mesh.size == 2
    with pytest.raises(ValueError, match="plan"):
        TorchStepper(TSPEC, device="cpu", plan=plan_search(TSPEC, prof),
                     chunk_schedule=(64,))


def test_plan_search_policies():
    corpus = _port(_cas_corpus(n=8))
    profile = profile_corpus(corpus)
    assert profile.max_ops <= 16 and profile.n == 8
    cpu = plan_search(TSPEC, profile, platform="cpu")
    assert cpu.name.startswith("cpu") and cpu.ordering
    assert len(set(cpu.slots_for_batch.values())) == 1
    assert cpu.chunk_schedule[0] >= profile.max_ops
    assert any("ordering=on" in w for w in cpu.why)
    assert isinstance(cpu, SearchPlan)


# ---------------------------------------------------------------------------
# engines: verdicts and counters at a shared plan
# ---------------------------------------------------------------------------

def _shared_plans(hs):
    jp = j_plan_search(JSPEC, j_profile_corpus(hs), platform="cpu")
    tp = plan_search(TSPEC, profile_corpus(_port(hs)), platform="cpu")
    return jp, tp


@pytest.mark.parametrize("mode", ["hand", "kernel_only", "ordered"])
def test_stepper_counters_equal_jax_at_the_shared_cpu_plan(mode):
    hs = _cas_corpus(n=16, max_ops=16)
    jp, tp = _shared_plans(hs)
    if mode == "hand":
        j = _host_compaction(JaxTPU(JSPEC))
        t = TorchStepper(TSPEC, device="cpu", **_hand_plan_kw(j))
    elif mode == "kernel_only":
        j = _host_compaction(JaxTPU(JSPEC, plan=dataclasses.replace(
            jp, ordering=False, decompose=False)))
        t = TorchStepper(TSPEC, device="cpu", plan=dataclasses.replace(
            tp, ordering=False, decompose=False))
    else:
        j = _host_compaction(JaxTPU(JSPEC, ordering=True))
        t = TorchStepper(TSPEC, device="cpu", ordering=True,
                         **_hand_plan_kw(j))
    jv = np.asarray(j.check_histories(JSPEC, hs))
    assert np.array_equal(t.check_histories(TSPEC, _port(hs)), jv)
    for k in COUNTERS:
        assert getattr(t, k) == getattr(j, k), k
    js, ts = j.search_stats().to_dict(), t.search_stats().to_dict()
    assert {**ts, "engine": js["engine"]} == js


def test_engine_parity_plan_on_off():
    """Decided verdicts equal the memo oracle's with the search plane on
    and off, engine by engine, as in the reference; ``HybridDevice``
    hands its plan to its ``TorchStepper``."""
    hs = _cas_corpus(n=16, max_ops=16)
    ths = _port(hs)
    ref = WingGongCPU(memo=True).check_histories(TSPEC, ths)
    assert (np.asarray(ref) == int(Verdict.VIOLATION)).any()
    plan = plan_search(TSPEC, profile_corpus(ths), platform="cpu")
    kernel_only = dataclasses.replace(plan, ordering=False, decompose=False)
    hybrid = HybridDevice(TSPEC, plan=kernel_only, device="cpu")
    assert hybrid.device.plan is kernel_only
    engines = {
        "hand": TorchStepper(TSPEC, device="cpu"),
        "planned_kernel": TorchStepper(TSPEC, plan=kernel_only,
                                       device="cpu"),
        "ordered": TorchStepper(TSPEC, ordering=True, device="cpu"),
        "planned_full": build_backend(TSPEC, plan, device="cpu"),
        "hybrid_planned": hybrid,
        "gpu_ordered": TorchGPU(TSPEC, budget=4_000, mid_budget=0,
                                rescue_budget=0, ordering=True,
                                device="cpu"),
        "cuda_plan": build_backend(TSPEC, plan_search(
            TSPEC, profile_corpus(ths)), device="cpu"),
    }
    for name, engine in engines.items():
        _decided_equal(ref, engine.check_histories(TSPEC, ths))
        if name == "gpu_ordered":
            continue  # TorchGPU keeps no SearchStats record
        st = collect_search_stats(engine)
        assert st is not None and st.histories > 0, name
    assert hybrid.search_stats().plan == plan.name


def test_iters_per_history_regression_cas32():
    """The reference's acceptance pin on the CAS-32 bench slice: the port
    gives the same iterations per history, hand and planned, so the same
    ratio (>= 10x), and the planned composition's ``SearchStats`` equal
    the reference's, field for field (the reference's engine inside its
    ``SegDC`` patched to its host compaction)."""
    hs = build_corpus(JSPEC, (AtomicCasSUT, RacyCasSUT), n=128, n_pids=8,
                      max_ops=32, seed_base=1000, seed_prefix="bench")
    ths = _port(hs)
    memo = WingGongCPU(memo=True)
    ref = memo.check_histories(TSPEC, ths)

    j_hand = _host_compaction(JaxTPU(JSPEC))
    jv = np.asarray(j_hand.check_histories(JSPEC, hs))
    hand = TorchStepper(TSPEC, device="cpu", **_hand_plan_kw(j_hand))
    assert np.array_equal(hand.check_histories(TSPEC, ths), jv)
    _decided_equal(ref, jv)

    jp, tp = _shared_plans(hs)
    assert tp.describe() == jp.describe() and tp.decompose
    j_planned = j_build_backend(JSPEC, jp)
    _host_compaction(j_planned.inner)
    planned = build_backend(TSPEC, tp, device="cpu")
    jv = np.asarray(j_planned.check_histories(JSPEC, hs))
    assert np.array_equal(planned.check_histories(TSPEC, ths), jv)
    _decided_equal(ref, jv)
    for k in ("segments_split", "segments_total", "final_states_device",
              "segments_native", "middle_nodes"):
        assert getattr(planned, k) == getattr(j_planned, k), k

    js, ts = j_planned.search_stats(), planned.search_stats()
    assert {**ts.to_dict(), "engine": js.engine} == js.to_dict()
    ratio = hand.search_stats().iters_per_history / ts.iters_per_history
    assert ratio == (j_hand.search_stats().iters_per_history
                     / js.iters_per_history)
    assert ratio >= 10.0
    assert ts.nodes_explored > 0 and ts.segments_total > 0


# ---------------------------------------------------------------------------
# stats plumbing and the CLI
# ---------------------------------------------------------------------------

def test_collect_search_stats_unwraps_combinators():
    from qsm_tpu_torch.ops.rootsplit import RootSplit

    rs = RootSplit(TSPEC, WingGongCPU(memo=True))
    rs.check_histories(TSPEC, _port(_cas_corpus(n=2)))
    st = collect_search_stats(rs)
    assert st is not None and st.engine.startswith("rootsplit(")
    assert st.histories >= 2
    assert collect_search_stats(object()) is None


def test_property_result_carries_search_timings():
    from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
    from qsm_tpu_torch.models.cas import RacyCasSUT as TRacy

    backend = WingGongCPU(memo=True, ordering=True)
    cfg = PropertyConfig(n_trials=20, n_pids=3, max_ops=10, seed=5)
    res = prop_concurrent(TSPEC, TRacy(TSPEC), cfg, backend=backend)
    assert "search_nodes_per_history" in res.timings
    assert res.timings["search_histories"] > 0
    res2 = prop_concurrent(TSPEC, TRacy(TSPEC), cfg, backend=backend)
    assert res2.timings["search_histories"] == \
        res.timings["search_histories"]


def _doc(capsys, main, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("backend", ["cpu", "segdc", "rootsplit"])
def test_stats_cli_emits_the_reference_document(capsys, backend):
    argv = ["stats", "--model", "cas", "--backend", backend,
            "--corpus", "8"]
    ref = _doc(capsys, j_cli_main, argv)
    doc = _doc(capsys, t_cli_main, argv)
    assert doc["device"] == "host"
    for k in ("model", "backend", "histories", "undecided", "resilience",
              "profile", "plan_for_corpus"):
        assert doc[k] == ref[k], k
    want = {**ref["search_stats"], "engine": doc["search_stats"]["engine"]}
    assert doc["search_stats"] == want


def test_stats_cli_planned_runs_the_cuda_plan(capsys):
    doc = _doc(capsys, t_cli_main, ["stats", "--model", "cas", "--planned",
                                    "--device", "cpu", "--corpus", "8"])
    assert doc["backend"] == f"planned({CUDA_PLAN})"
    assert doc["plan_for_corpus"]["name"] == CUDA_PLAN
    assert doc["search_stats"]["plan"] == CUDA_PLAN
    assert doc["undecided"] == 0 and doc["device"] == "cpu"
