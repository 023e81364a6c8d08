"""The port's search-cost plane against the JAX package's, on the CPU.

The cases of ``tests/test_stats_merge.py`` run against the port's
``SearchStats`` (the additive counters, the max and min-ratio fields, the
first-wins strings, the ``count_histories`` gate, ``stats_delta``, the
full compact key set, the gated timings, the collection path).  Beside
them, exact equality throughout:

* ``search_stats()`` of each ported engine equals its counterpart's on
  one corpus (every field but the engine's name);
* ``profile_corpus``, with and without a spec, equals the reference's;
* ``compile_selectivity_table`` equals the reference's, in the tabulated
  and in the stride-sampled regime;
* a property run's ``timings`` carry the same keys in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from qsm_tpu.core.property import PropertyConfig as JConfig
from qsm_tpu.core.property import prop_concurrent as j_prop
from qsm_tpu.core.spec import compile_selectivity_table as j_selectivity
from qsm_tpu.models.registry import MODELS as J_MODELS
from qsm_tpu.native import CppOracle as JCpp
from qsm_tpu.ops.hybrid import HybridDevice as JHybrid
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.pcomp import PComp as JPComp
from qsm_tpu.ops.segdc import split_at_quiescent_cuts as j_cuts
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle
from qsm_tpu.search import stats as j_stats
from qsm_tpu.search.planner import profile_corpus as j_profile_corpus
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.core.spec import (MAX_SELECTIVITY_PROBE_STATES,
                                     compile_selectivity_table)
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.native import CppOracle
from qsm_tpu_torch.ops.hybrid import HybridDevice
from qsm_tpu_torch.ops.pcomp import PComp
from qsm_tpu_torch.ops.segdc import split_at_quiescent_cuts
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.resilience.checkpoint import (atomic_write_json,
                                                 atomic_write_text)
from qsm_tpu_torch.search import (CorpusProfile, SearchStats,
                                  collect_search_stats, profile_corpus,
                                  stats_delta)
from qsm_tpu_torch.search.stats import _COUNTER_FIELDS
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

# every additive counter absorb() folds (histories is additive too but
# gated behind count_histories)
_ADDITIVE = ("lockstep_iters", "nodes_explored", "memo_prunes",
             "memo_inserts", "compactions", "chunk_rounds", "rescued",
             "deferred", "tail_histories", "segments_split",
             "segments_total", "degradations", "retries",
             "worker_faults", "node_faults", "lease_faults",
             "pcomp_split", "pcomp_subs",
             "pcomp_recombine_ms", "shrink_rounds", "shrink_lanes",
             "shrink_memo_hits", "obs_events", "session_events",
             "frontier_advances", "flips_pushed", "prefix_hits",
             "gen_seqs", "gen_mutations", "gen_flips",
             "gen_feedback_rounds")


def _filled(base: int, cls=SearchStats):
    st = cls(engine=f"e{base}", histories=base)
    for i, f in enumerate(_ADDITIVE):
        setattr(st, f, base * 100 + i)
    st.pcomp_max_sub = base * 7
    st.shrink_ratio_pct = base * 11
    return st


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _fields(st, drop=("engine",)):
    d = dataclasses.asdict(st)
    for k in drop:
        d.pop(k)
    return d


# -- the cases of tests/test_stats_merge.py, on the port ----------------

def test_every_dataclass_counter_is_classified():
    classified = set(_ADDITIVE) | {"histories", "pcomp_max_sub",
                                   "shrink_ratio_pct"}
    numeric = {f.name for f in dataclasses.fields(SearchStats)
               if f.type == "int"}
    assert numeric == classified
    assert set(_COUNTER_FIELDS) == set(_ADDITIVE) | {"histories"}


def test_fields_and_defaults_equal_to_the_reference():
    assert [(f.name, f.type, f.default)
            for f in dataclasses.fields(SearchStats)] == \
        [(f.name, f.type, f.default)
         for f in dataclasses.fields(j_stats.SearchStats)]
    assert _COUNTER_FIELDS == j_stats._COUNTER_FIELDS


def test_absorb_additive_fields_sum():
    a, b = _filled(1), _filled(2)
    a.absorb(b)
    for i, f in enumerate(_ADDITIVE):
        assert getattr(a, f) == (100 + i) + (200 + i), f


def test_absorb_histories_gated_by_count_histories():
    a, b = _filled(1), _filled(2)
    a.absorb(b)
    assert a.histories == 1
    a2, b2 = _filled(1), _filled(2)
    a2.absorb(b2, count_histories=True)
    assert a2.histories == 3


def test_absorb_pcomp_max_sub_is_max_not_sum():
    a, b = _filled(1), _filled(2)
    a.absorb(b)
    assert a.pcomp_max_sub == 14
    c, d = _filled(3), _filled(1)
    c.absorb(d)
    assert c.pcomp_max_sub == 21


@pytest.mark.parametrize("mine,theirs,want", [
    (30, 20, 20), (20, 30, 20), (0, 40, 40), (40, 0, 40), (0, 0, 0)])
def test_absorb_shrink_ratio_min_merges_with_zero_as_absent(
        mine, theirs, want):
    a, b = SearchStats(), SearchStats()
    a.shrink_ratio_pct, b.shrink_ratio_pct = mine, theirs
    a.absorb(b)
    assert a.shrink_ratio_pct == want


def test_absorb_strings_first_wins_and_ordering_ors():
    a = SearchStats(plan="", fallback_engine="", ordering=False)
    b = SearchStats(plan="cpu-fine-v1", fallback_engine="memo",
                    ordering=True)
    a.absorb(b)
    assert a.plan == "cpu-fine-v1"
    assert a.fallback_engine == "memo"
    assert a.ordering is True
    c = SearchStats(plan="outer", fallback_engine="cpp")
    c.absorb(b)
    assert c.plan == "outer" and c.fallback_engine == "cpp"


def test_absorb_none_is_identity():
    a = _filled(1)
    before = dataclasses.asdict(a)
    assert a.absorb(None) is a
    assert dataclasses.asdict(a) == before


def test_stats_delta_subtracts_counters_keeps_max_and_ratio():
    before, after = _filled(1), _filled(3)
    d = stats_delta(after, before)
    for i, f in enumerate(_ADDITIVE):
        assert getattr(d, f) == (300 + i) - (100 + i), f
    assert d.histories == 2
    assert d.pcomp_max_sub == after.pcomp_max_sub == 21
    assert d.shrink_ratio_pct == after.shrink_ratio_pct == 33
    assert after.nodes_explored == 301


def test_stats_delta_none_handling():
    assert stats_delta(None, _filled(1)) is None
    st = _filled(2)
    assert stats_delta(st, None) is st


def test_to_compact_full_key_set_and_values():
    st = _filled(2)
    st.ordering = True
    st.plan = "p"
    st.fallback_engine = "memo"
    c = st.to_compact()
    assert sorted(c) == sorted(
        ("iph", "nph", "prunes", "rescued", "segs", "ord", "plan",
         "deg", "fb", "wf", "ndf", "lsf", "pcs", "pcn", "pcm", "shr",
         "shl", "shm", "sho", "obe", "sev", "fad", "flp", "pfh",
         "gsq", "gmu", "gfl", "gfr"))
    assert c["gsq"] == st.gen_seqs
    assert c["gmu"] == st.gen_mutations
    assert c["gfl"] == st.gen_flips
    assert c["gfr"] == st.gen_feedback_rounds
    assert c["pcm"] == st.pcomp_max_sub
    assert c["sho"] == st.shrink_ratio_pct
    assert c["obe"] == st.obs_events
    assert c["sev"] == st.session_events
    assert c["fad"] == st.frontier_advances
    assert c["flp"] == st.flips_pushed
    assert c["pfh"] == st.prefix_hits
    assert c["wf"] == st.worker_faults
    assert c["ndf"] == st.node_faults
    assert c["lsf"] == st.lease_faults
    assert c["iph"] == round(st.lockstep_iters / st.histories, 1)
    assert c["nph"] == round(st.nodes_explored / st.histories, 1)


def test_renderings_equal_to_the_reference():
    for base in (0, 1, 3):
        mine, ref = _filled(base), _filled(base, j_stats.SearchStats)
        if base == 0:
            mine.histories = ref.histories = 0
        assert mine.to_compact() == ref.to_compact()
        assert mine.to_dict() == ref.to_dict()
        assert mine.to_timings() == ref.to_timings()


def test_to_timings_gates_optional_blocks():
    clean = SearchStats(histories=4, nodes_explored=8)
    t = clean.to_timings()
    assert "pcomp_subs" not in t
    assert "shrink_rounds" not in t
    assert "obs_events" not in t
    assert "session_events" not in t
    assert "gen_seqs" not in t
    assert "resilience_degradations" not in t
    full = _filled(2)
    t2 = full.to_timings()
    assert t2["pcomp_max_sub"] == float(full.pcomp_max_sub)
    assert t2["shrink_ratio"] == round(full.shrink_ratio_pct / 100, 3)
    assert t2["obs_events"] == float(full.obs_events)
    assert t2["resilience_worker_faults"] == float(full.worker_faults)
    assert t2["session_events"] == float(full.session_events)
    assert t2["prefix_hits"] == float(full.prefix_hits)
    assert t2["flips_pushed"] == float(full.flips_pushed)
    assert t2["gen_seqs"] == float(full.gen_seqs)
    assert t2["gen_flips"] == float(full.gen_flips)


def test_absorb_round_trips_through_collect_composition():
    inner = _filled(2)

    class _Inner:
        def search_stats(self):
            return dataclasses.replace(inner)

    class _Wrapper:
        def __init__(self):
            self.inner = _Inner()

        def search_stats(self):
            st = _filled(1)
            st.absorb(self.inner.search_stats())
            return st

    st = collect_search_stats(_Wrapper())
    assert st.nodes_explored == 101 + 201
    assert st.pcomp_max_sub == 14
    assert st.shrink_ratio_pct == 11
    assert st.obs_events == (100 + _ADDITIVE.index("obs_events")) + (
        200 + _ADDITIVE.index("obs_events"))


def test_collect_probes_the_wrapper_attributes():
    class _Plain:
        pass

    class _Router:
        def __init__(self):
            self.device = WingGongCPU()

    assert collect_search_stats(_Plain()) is None
    st = collect_search_stats(_Router())
    assert st.engine == "_router(wing_gong_cpu)"


# -- the engines' records against their counterparts --------------------

def _cas_corpus(n=24, pids=4, ops=16):
    entry = J_MODELS["cas"]
    return build_corpus(entry.make_spec(),
                        (entry.impls["atomic"], entry.impls["racy"]), n=n,
                        n_pids=pids, max_ops=ops, seed_base=77,
                        seed_prefix="stats")


@pytest.mark.parametrize("memo", [False, True])
@pytest.mark.parametrize("model", ["cas", "queue", "register", "rangeset"])
def test_wing_gong_counters_equal_to_the_reference(model, memo):
    """The repaired counters: ``nodes_explored`` and
    ``histories_checked`` counted where the reference counts them."""
    entry = J_MODELS[model]
    jspec, spec = entry.make_spec(), MODELS[model].make_spec()
    hs = build_corpus(jspec, (entry.impls["atomic"], entry.impls["racy"]),
                      n=16, n_pids=3, max_ops=10, seed_base=5,
                      seed_prefix="wg")
    ref = JOracle(memo=memo, ordering=False)
    mine = WingGongCPU(memo=memo)
    np.testing.assert_array_equal(
        mine.check_histories(spec, _port(hs)), ref.check_histories(jspec, hs))
    mine.check_witness(spec, _port(hs)[0])
    ref.check_witness(jspec, hs[0])
    assert (mine.nodes_explored, mine.histories_checked) == \
        (ref.nodes_explored, ref.histories_checked)
    assert mine.nodes_explored > 0
    assert dataclasses.asdict(mine.search_stats()) == \
        dataclasses.asdict(ref.search_stats())


def test_cpp_oracle_stats_equal_to_the_reference():
    jspec, spec = J_MODELS["cas"].make_spec(), MODELS["cas"].make_spec()
    hs = _cas_corpus()
    ref, mine = JCpp(jspec), CppOracle(spec)
    np.testing.assert_array_equal(mine.check_histories(spec, _port(hs)),
                                  ref.check_histories(jspec, hs))
    assert dataclasses.asdict(mine.search_stats()) == \
        dataclasses.asdict(ref.search_stats())


def test_torch_stepper_stats_equal_to_jax_tpu():
    jspec, spec = J_MODELS["cas"].make_spec(), MODELS["cas"].make_spec()
    hs = _cas_corpus(n=24, pids=4, ops=24)
    j = JaxTPU(jspec)
    j._compact_carry = j._compact_carry_host
    jv = np.asarray(j.check_histories(jspec, hs))
    t = TorchStepper(spec, device="cpu", chunk_schedule=j.CHUNK_SCHEDULE,
                     batch_buckets=j.BATCH_BUCKETS,
                     slots_for_batch={b: j._slots_for(b)
                                      for b in j.BATCH_BUCKETS})
    np.testing.assert_array_equal(t.check_histories(spec, _port(hs)), jv)
    got, want = t.search_stats(), j.search_stats()
    assert _fields(got) == _fields(want)
    assert got.lockstep_iters > 0 and got.histories == len(hs)


def test_pcomp_stats_equal_to_the_reference():
    jspec = J_MODELS["kv"].make_spec()
    spec = MODELS["kv"].make_spec()
    entry = J_MODELS["kv"]
    hs = build_corpus(jspec, (entry.impls["atomic"], entry.impls["racy"]),
                      n=12, n_pids=6, max_ops=20, seed_base=9,
                      seed_prefix="pcs")
    ref, mine = JPComp(jspec), PComp(spec)
    np.testing.assert_array_equal(mine.check_histories(spec, _port(hs)),
                                  ref.check_histories(jspec, hs))
    mine.check_witness(spec, _port(hs)[0])
    ref.check_witness(jspec, hs[0])
    drop = ("engine", "pcomp_recombine_ms")  # a host time, not a count
    assert _fields(mine.search_stats(), drop) == \
        _fields(ref.search_stats(), drop)


@pytest.mark.parametrize("budget", [1, 2_000])
def test_hybrid_stats_equal_to_the_reference(budget):
    jspec, spec = J_MODELS["cas"].make_spec(), MODELS["cas"].make_spec()
    hs = _cas_corpus(n=24, pids=4, ops=24)
    ref = JHybrid(jspec, budget=budget)
    j = ref.device
    j._compact_carry = j._compact_carry_host
    # the device at JaxTPU's plan (buckets set the lockstep padding)
    mine = HybridDevice(spec, budget=budget, device="cpu",
                        chunk_schedule=j.CHUNK_SCHEDULE,
                        batch_buckets=j.BATCH_BUCKETS,
                        slots_for_batch={b: j._slots_for(b)
                                         for b in j.BATCH_BUCKETS})
    np.testing.assert_array_equal(mine.check_histories(spec, _port(hs)),
                                  ref.check_histories(jspec, hs))
    got, want = mine.search_stats(), ref.search_stats()
    assert got.engine == "hybrid_device" == want.engine
    assert _fields(got) == _fields(want)
    assert got.tail_histories == mine.tail_histories > 0 or budget > 1


# -- corpus statistics ---------------------------------------------------

@pytest.mark.parametrize("model", ["cas", "queue", "kv", "multireg"])
def test_profile_corpus_equal_to_the_reference(model):
    entry = J_MODELS[model]
    jspec, spec = entry.make_spec(), MODELS[model].make_spec()
    hs = build_corpus(jspec, (entry.impls["atomic"], entry.impls["racy"]),
                      n=20, n_pids=4, max_ops=16, seed_base=2,
                      seed_prefix="prof")
    for use_spec in (False, True):
        got = profile_corpus(_port(hs), spec if use_spec else None)
        want = j_profile_corpus(hs, jspec if use_spec else None)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for h in hs:
        assert [[(o.pid, o.invoke_time) for o in seg]
                for seg in split_at_quiescent_cuts(_port([h])[0])] == \
            [[(o.pid, o.invoke_time) for o in seg] for seg in j_cuts(h)]
    assert profile_corpus([]) == CorpusProfile()


def test_profile_corpus_measures_sub_histories_only_for_a_valid_projection():
    spec = MODELS["kv"].make_spec()
    entry = J_MODELS["kv"]
    hs = _port(build_corpus(entry.make_spec(),
                            (entry.impls["atomic"], entry.impls["racy"]),
                            n=8, n_pids=4, max_ops=16, seed_base=4,
                            seed_prefix="sub"))
    assert profile_corpus(hs).sub_max_ops == 0
    assert profile_corpus(hs, spec).sub_max_ops > 0
    cas = MODELS["cas"].make_spec()  # no projection: nothing measured
    assert profile_corpus(hs, cas).sub_max_ops == 0


# -- the selectivity table -----------------------------------------------

@pytest.mark.parametrize("model", ["cas", "register", "rangeset",
                                   "semaphore", "ticket"])
def test_selectivity_table_equal_to_the_reference(model):
    jspec, spec = J_MODELS[model].make_spec(), MODELS[model].make_spec()
    bound = spec.scalar_state_bound(32)
    np.testing.assert_array_equal(compile_selectivity_table(spec, bound),
                                  j_selectivity(jspec, bound))
    # past the probe cap: the stride-sampled estimate
    big = MAX_SELECTIVITY_PROBE_STATES + 37
    np.testing.assert_array_equal(
        compile_selectivity_table(spec, big, max_probe_states=16),
        j_selectivity(jspec, big, max_probe_states=16))


# -- property timings ------------------------------------------------------

@pytest.mark.parametrize("backend", ["oracle", "memo", "stepper"])
def test_property_timings_carry_the_same_keys(backend):
    model = "register"
    entry, tentry = J_MODELS[model], MODELS[model]
    jspec, spec = entry.make_spec(), tentry.make_spec()
    cfg = dict(n_trials=6, n_pids=3, max_ops=10, seed=4)
    jb = {"oracle": None, "memo": JOracle(memo=True),
          "stepper": JaxTPU(jspec)}[backend]
    tb = {"oracle": None, "memo": WingGongCPU(memo=True),
          "stepper": TorchStepper(spec, device="cpu")}[backend]
    want = j_prop(jspec, entry.impls["atomic"](jspec), JConfig(**cfg),
                  backend=jb)
    got = prop_concurrent(spec, tentry.impls["atomic"](spec),
                          PropertyConfig(**cfg), backend=tb)
    assert got.ok == want.ok
    assert sorted(got.timings) == sorted(want.timings)
    for k in ("search_histories", "search_nodes_per_history"):
        assert got.timings[k] == want.timings[k], k


# -- checkpoint writes -----------------------------------------------------

def test_atomic_writes_replace_whole_and_leave_no_temporary(tmp_path):
    p = tmp_path / "doc.json"
    atomic_write_text(str(p), "old\n")
    atomic_write_json(str(p), {"a": [1, 2]}, indent=1)
    assert p.read_text() == '{\n "a": [\n  1,\n  2\n ]\n}\n'
    assert sorted(x.name for x in tmp_path.iterdir()) == ["doc.json"]
