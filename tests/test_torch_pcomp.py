"""The port's per-key decomposition against the JAX package's: the same
projection reports (word for word), the same splits and index maps, the
same verdicts and counters with every inner backend, and the same
stitched witnesses, list for list, replaying through both packages'
``verify_witness``.  Tolerance: exact everywhere."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from qsm_tpu.analysis.fixtures import (NonTotalPartitionKvSpec,
                                       UnfaithfulProjectionKvSpec)
from qsm_tpu.core.spec import KeyProj as JKeyProj
from qsm_tpu.core.spec import projection_report as j_report
from qsm_tpu.models import (AtomicKvSUT, AtomicMultiCasSUT,
                            AtomicMultiRegisterSUT, KvSpec, MultiCasSpec,
                            MultiRegisterSpec, RacyMultiCasSUT,
                            ShardedStaleMultiRegisterSUT, StaleCacheKvSUT)
from qsm_tpu.models.registry import MODELS as J_MODELS
from qsm_tpu.ops import pcomp as jpc
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.resilience.failover import host_fallback as j_host_fallback
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.history import NO_RESP, History, Op
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.core.spec import KeyProj
from qsm_tpu_torch.core.spec import projection_report as t_report
from qsm_tpu_torch.models.kv import GET, PUT
from qsm_tpu_torch.models.kv import AtomicKvSUT as TAtomicKv
from qsm_tpu_torch.models.kv import KvSpec as TKv
from qsm_tpu_torch.models.registry import MODELS as T_MODELS
from qsm_tpu_torch.models.registry import make
from qsm_tpu_torch.ops import pcomp as tpc
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.backend import verify_witness as t_verify_witness
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU as TOracle
from qsm_tpu_torch.resilience.failover import host_fallback
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

# the JAX package's pcomp families: 2 cells concentrate conflicting ops
FAMILIES = {
    "multireg": (MultiRegisterSpec(n_cells=2, n_values=4),
                 (AtomicMultiRegisterSUT, ShardedStaleMultiRegisterSUT),
                 {"n_cells": 2, "n_values": 4}),
    "multicas": (MultiCasSpec(n_cells=2, n_values=4),
                 (AtomicMultiCasSUT, RacyMultiCasSUT),
                 {"n_cells": 2, "n_values": 4}),
    "kv": (KvSpec(n_keys=2, n_values=4), (AtomicKvSUT, StaleCacheKvSUT),
           {"n_keys": 2, "n_values": 4}),
}


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, reference spec, port spec, reference corpus, port corpus)
    of one family, built as the JAX package's pcomp tests build it."""
    spec, suts, kw = FAMILIES[request.param]
    hs = build_corpus(spec, suts, n=24, n_pids=8, max_ops=28, seed_base=0,
                      seed_prefix=f"pc_{spec.name}")
    tspec, _ = make(request.param, "atomic", kw)
    return request.param, spec, tspec, hs, _port(hs)


def _kv16_sample(n=12):
    spec = KvSpec(n_keys=16, n_values=4)
    hs = build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT), n=n, n_pids=16,
                      max_ops=64, seed_base=1000, seed_prefix="bench")
    return spec, TKv(n_keys=16, n_values=4), hs, _port(hs)


# ---------------------------------------------------------------------------
# the projection layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(J_MODELS))
def test_projection_report_equal_on_every_registry_spec(model):
    assert sorted(T_MODELS) == sorted(J_MODELS)
    want = j_report(J_MODELS[model].make_spec())
    got = t_report(T_MODELS[model].make_spec())
    assert got == want
    assert (got == []) == (model in ("kv", "multireg", "multicas"))


def _bug_specs():
    """The JAX package's seeded projection bugs and the port's
    counterparts, written here in the port's terms."""

    class TNonTotal(TKv):
        name = "non_total_partition_kv"

        def __init__(self):
            super().__init__(n_keys=4, n_values=4)
            get, put = self.CMDS
            self.CMDS = (get, dataclasses.replace(put, proj=None))

    class TUnfaithful(TKv):
        name = "unfaithful_projection_kv"

        def __init__(self):
            super().__init__(n_keys=4, n_values=4)
            get, put = self.CMDS
            self.CMDS = (get, dataclasses.replace(
                put, proj=KeyProj(pcmd=1, stride=1)))

    def bad_resp(base):
        class BadRespKv(base):
            name = "bad_resp_kv"

            def __init__(self):
                super().__init__(n_keys=2, n_values=4)
                get, put = self.CMDS
                self.CMDS = (dataclasses.replace(get, n_resps=2), put)
        return BadRespKv

    def skewed(base):
        class SkewedKv(base):
            name = "skewed_kv"

            def partition_key(self, cmd, arg):
                k = super().partition_key(cmd, arg)
                return (k + 1) % self.n_keys if k is not None else None
        return SkewedKv

    def bad_stride(base, proj_cls):
        class ZeroStrideKv(base):
            name = "zero_stride_kv"

            def __init__(self):
                super().__init__(n_keys=2, n_values=4)
                get, put = self.CMDS
                self.CMDS = (get, dataclasses.replace(
                    put, proj=proj_cls(pcmd=5, stride=0)))
        return ZeroStrideKv

    return {
        "non_total": (NonTotalPartitionKvSpec(), TNonTotal(), "not total"),
        # stride 1 makes PUT's packed arg a key past the state
        "unfaithful": (UnfaithfulProjectionKvSpec(), TUnfaithful(),
                       "IndexError"),
        "resp_domain": (bad_resp(KvSpec)(), bad_resp(TKv)(),
                        "response domain"),
        "partition_override": (skewed(KvSpec)(), skewed(TKv)(),
                               "KeyProj derives"),
        "zero_stride": (bad_stride(KvSpec, JKeyProj)(),
                        bad_stride(TKv, KeyProj)(), "stride 0 <= 0"),
    }


@pytest.mark.parametrize("case", sorted(_bug_specs()))
def test_seeded_projection_bugs_refused_with_the_same_report(case):
    jspec, tspec, words = _bug_specs()[case]
    want = j_report(jspec)
    got = t_report(tspec)
    assert got == want and got
    assert any(words in p for p in got), got
    with pytest.raises(jpc.NotDecomposableError) as je:
        jpc.PComp(jspec)
    with pytest.raises(tpc.NotDecomposableError) as te:
        tpc.PComp(tspec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("model", ["cas", "txn"])
def test_not_decomposable_error_for_cas_and_txn(model):
    jspec = J_MODELS[model].make_spec()
    tspec = T_MODELS[model].make_spec()
    with pytest.raises(jpc.NotDecomposableError) as je:
        jpc.PComp(jspec)
    with pytest.raises(tpc.NotDecomposableError) as te:
        tpc.PComp(tspec)
    assert str(te.value) == str(je.value)
    want = ("no per-key projection" if model == "cas"
            else "keys are not independent")
    assert want in str(te.value)
    # a refusal is a ValueError too, but one the CLI can single out
    assert isinstance(te.value, ValueError)


def test_report_is_cached_on_the_instance():
    spec = TKv()
    assert t_report(spec) == []
    spec.__dict__["_projection_report"] = ("cached",)
    assert t_report(spec) == ["cached"]


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

def _split_rows(split, spec, h):
    return {k: (history_to_rows(sub), idx)
            for k, (sub, idx) in split(spec, h).items()}


def test_split_equal_on_families(family):
    _, spec, tspec, hs, ths = family
    for h, th in zip(hs, ths):
        assert (_split_rows(tpc.split_history_indexed, tspec, th)
                == _split_rows(jpc.split_history_indexed, spec, h))
        assert ({k: history_to_rows(s)
                 for k, s in tpc.split_history(tspec, th).items()}
                == {k: history_to_rows(s)
                    for k, s in jpc.split_history(spec, h).items()})


def test_split_equal_on_kv16_sample_with_the_gate_functions():
    spec, tspec, hs, ths = _kv16_sample()
    n_split = 0
    for h, th in zip(hs, ths):
        got = _split_rows(tpc.split_history_indexed, tspec, th)
        assert got == _split_rows(jpc.split_history_indexed, spec, h)
        n_split += len(got) > 1
        assert tpc.longest_sub(tspec, th) == jpc.longest_sub(spec, h)
        assert tpc.history_keys(tspec, th) == jpc.history_keys(spec, h)
        assert tpc.split_gain(tspec, th) == jpc.split_gain(spec, h)
        # projected ops are register ops: READ arg 0, WRITE(v)
        for sub in tpc.split_history(tspec, th).values():
            for op in sub.ops:
                assert op.cmd in (0, 1)
                assert op.arg == 0 if op.cmd == 0 else op.arg < 4
    assert n_split == len(hs)
    for n in (0, 1, 12, 13, 128, 129):
        assert tpc.bucket_or_none(n) == jpc.bucket_or_none(n)


@pytest.mark.parametrize("model", ["kv", "multireg", "multicas"])
def test_split_and_fold_equal_at_the_registry_defaults(model):
    """The registry's default spec and size (16 pids x 64 ops), the
    corpus the card's per-key phase builds: the same splits, index maps,
    verdicts and counters as the reference's ``PComp``."""
    entry = J_MODELS[model]
    spec = entry.make_spec()
    hs = build_corpus(spec, (entry.impls["atomic"], entry.impls["racy"]),
                      n=32, n_pids=entry.default_pids,
                      max_ops=entry.default_ops, seed_base=1000,
                      seed_prefix="bench")
    assert (entry.default_pids, entry.default_ops) == (16, 64)
    tspec, _ = make(model, "atomic")
    ths = _port(hs)
    for h, th in zip(hs, ths):
        assert (_split_rows(tpc.split_history_indexed, tspec, th)
                == _split_rows(jpc.split_history_indexed, spec, h))
    ref = jpc.PComp(spec)
    want = np.asarray(ref.check_histories(spec, hs))
    pc = tpc.PComp(tspec)
    np.testing.assert_array_equal(pc.check_histories(tspec, ths), want)
    assert (want == Verdict.VIOLATION).any(), "sample vacuous: no fails"
    assert [getattr(pc, k) for k in COUNTERS] == \
        [getattr(ref, k) for k in COUNTERS]


def test_split_gain_gate():
    spec = KvSpec(n_keys=8, n_values=4)
    tspec = TKv(n_keys=8, n_values=4)
    long = build_corpus(spec, (AtomicKvSUT,), n=1, n_pids=16, max_ops=96,
                        seed_base=1, seed_prefix="g")
    short = build_corpus(spec, (AtomicKvSUT,), n=1, n_pids=2, max_ops=6,
                         seed_base=1, seed_prefix="g2")
    assert tpc.split_gain(tspec, _port(long)[0])
    assert not tpc.split_gain(tspec, _port(short)[0])


def test_non_total_split_raises():
    tspec = _bug_specs()["non_total"][1]
    h = History([Op(0, PUT, 5, 0, 0, 1)])
    for fn in (tpc.split_history, tpc.longest_sub, tpc.history_keys):
        with pytest.raises(ValueError, match="not total"):
            fn(tspec, h)


# ---------------------------------------------------------------------------
# verdicts and counters
# ---------------------------------------------------------------------------

INNERS = {
    "memo": (None, None),
    "host_fallback": (host_fallback, j_host_fallback),
    "stepper": (lambda p: TorchStepper(p, device="cpu"), None),
}
COUNTERS = ("histories_seen", "split_histories", "subs_produced",
            "max_sub_len")


@pytest.mark.parametrize("inner", sorted(INNERS))
def test_verdicts_bit_identical_to_reference_and_direct_oracle(family,
                                                               inner):
    _, spec, tspec, hs, ths = family
    t_inner, j_inner = INNERS[inner]
    ref = jpc.PComp(spec, j_inner)
    want = np.asarray(ref.check_histories(spec, hs))
    assert (want == Verdict.VIOLATION).any(), "sample vacuous: no fails"
    pc = tpc.PComp(tspec, t_inner)
    got = np.asarray(pc.check_histories(tspec, ths))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TOracle(memo=True).check_histories(tspec, ths))
    assert [getattr(pc, k) for k in COUNTERS] == \
        [getattr(ref, k) for k in COUNTERS]
    assert pc.recombine_s > 0
    assert pc.name == f"pcomp({pc.inner.name})"


def test_stepper_inner_on_kv16_sample():
    spec, tspec, hs, ths = _kv16_sample()
    pc = tpc.PComp(tspec, lambda p: TorchStepper(p, device="cpu"))
    assert pc.inner.regime == "table"
    got = pc.check_histories(tspec, ths)
    want = jpc.PComp(spec).check_histories(spec, hs)
    np.testing.assert_array_equal(got, want)
    assert (got != Verdict.BUDGET_EXCEEDED).all()
    assert pc.subs_produced > 10 * len(ths)


def test_empty_batch_and_empty_history():
    tspec = TKv()
    pc = tpc.PComp(tspec)
    assert pc.check_histories(tspec, []).shape == (0,)
    np.testing.assert_array_equal(
        pc.check_histories(tspec, [History([])]), [Verdict.LINEARIZABLE])
    assert pc.check_witness(tspec, History([])) == \
        (Verdict.LINEARIZABLE, [])


# ---------------------------------------------------------------------------
# stitched witnesses
# ---------------------------------------------------------------------------

def test_stitched_witnesses_equal_and_replay_in_both_packages(family):
    _, spec, tspec, hs, ths = family
    ref, pc = jpc.PComp(spec), tpc.PComp(tspec)
    n_ok = 0
    for h, th in zip(hs[:16], ths[:16]):
        jv, jw = ref.check_witness(spec, h)
        tv, tw = pc.check_witness(tspec, th)
        assert int(tv) == int(jv)
        assert tw == jw
        if tv == Verdict.LINEARIZABLE:
            assert t_verify_witness(tspec, th, tw)
            assert j_verify_witness(spec, h, tw)
            n_ok += 1
    assert n_ok, "witness sample vacuous"
    assert [getattr(pc, k) for k in COUNTERS] == \
        [getattr(ref, k) for k in COUNTERS]


def test_stitched_witnesses_through_the_stepper_inner():
    """Per-key witnesses from ``TorchStepper`` against those from the
    reference's ``JaxTPU``: the same search, so the same stitched
    witness."""
    spec, suts, kw = FAMILIES["kv"]
    hs = build_corpus(spec, suts, n=8, n_pids=8, max_ops=28, seed_base=0,
                      seed_prefix=f"pc_{spec.name}")
    tspec, _ = make("kv", "atomic", kw)
    ref = jpc.PComp(spec, lambda p: JaxTPU(p))
    pc = tpc.PComp(tspec, lambda p: TorchStepper(p, device="cpu"))
    n_ok = 0
    for h, th in zip(hs, _port(hs)):
        jv, jw = ref.check_witness(spec, h)
        tv, tw = pc.check_witness(tspec, th)
        assert (int(tv), tw) == (int(jv), jw)
        if tw is not None:
            assert t_verify_witness(tspec, th, tw)
            n_ok += 1
    assert n_ok


def test_stitched_witness_with_pending_ops():
    """A pending op is completed by a key's witness or pruned; the
    stitched witness replays either way, in both packages."""
    from qsm_tpu.core.history import History as JHistory
    from qsm_tpu.core.history import Op as JOp

    spec, tspec = KvSpec(n_keys=2, n_values=4), TKv(n_keys=2, n_values=4)
    big = 1 << 30
    rows = [[0, PUT, tspec.put_arg(0, 3), 0, 0, 1],
            [1, PUT, tspec.put_arg(1, 2), NO_RESP, 2, big],
            [0, GET, 0, 3, 3, 4],
            [2, GET, 1, 2, 5, 6]]
    pruned = rows[:2] + [[2, GET, 1, 0, 5, 6]]
    for rs, must_complete in ((rows, True), (pruned, False)):
        th = history_from_rows(rs)
        jh = JHistory([JOp(*r) for r in rs])
        tv, tw = tpc.PComp(tspec).check_witness(tspec, th)
        jv, jw = jpc.PComp(spec).check_witness(spec, jh)
        assert tv == Verdict.LINEARIZABLE and int(jv) == int(tv)
        assert tw == jw
        if must_complete:
            # GET(1) == 2 is explained only by the pending PUT
            assert any(j == 1 for j, _ in tw)
        assert t_verify_witness(tspec, th, tw)
        assert j_verify_witness(spec, jh, tw)


def test_stitch_is_deterministic_and_ordered():
    tspec = TKv(n_keys=2, n_values=4)
    steps = [(0, PUT, tspec.put_arg(0, 3), 0), (1, PUT, tspec.put_arg(1, 2),
                                                0),
             (0, GET, 0, 3), (1, GET, 1, 2)]
    h = History([Op(p, c, a, r, 2 * t, 2 * t + 1)
                 for t, (p, c, a, r) in enumerate(steps)])
    v, w = tpc.PComp(tspec).check_witness(tspec, h)
    assert v == Verdict.LINEARIZABLE
    # a sequential history admits exactly its own order
    assert [j for j, _ in w] == [0, 1, 2, 3]
    assert t_verify_witness(tspec, h, w)


def test_stitch_witness_refuses_a_cycle():
    h = History([Op(0, 0, 0, 0, 0, 1), Op(0, 1, 1, 0, 2, 3)])
    # op 0 precedes op 1 in real time; a corrupt chain claims the reverse
    with pytest.raises(RuntimeError, match="cycle"):
        tpc.stitch_witness(h, [[(1, 0), (0, 0)]])
    # and the reference refuses the same chains
    from qsm_tpu.core.history import History as JHistory
    from qsm_tpu.core.history import Op as JOp

    with pytest.raises(RuntimeError, match="cycle"):
        jpc.stitch_witness(JHistory([JOp(*history_to_rows(h)[i])
                                     for i in range(2)]),
                           [[(1, 0), (0, 0)]])


def test_stitch_merges_chains_by_min_index():
    h = History([Op(0, 0, 0, 0, 0, 10), Op(1, 0, 1, 0, 0, 10),
                 Op(2, 0, 0, 0, 20, 21), Op(3, 0, 1, 0, 1, 2)])
    chains = [[(0, 0), (2, 0)], [(3, 0), (1, 0)]]
    from qsm_tpu.core.history import History as JHistory
    from qsm_tpu.core.history import Op as JOp

    want = jpc.stitch_witness(
        JHistory([JOp(*r) for r in history_to_rows(h)]), chains)
    got = tpc.stitch_witness(h, chains)
    assert got == want
    # chain order, real time (3 and 1 before 2), the smallest index first
    assert [j for j, _ in got] == [0, 3, 1, 2]


# ---------------------------------------------------------------------------
# the property layer
# ---------------------------------------------------------------------------

def test_property_run_with_pcomp_backend_matches_reference():
    import qsm_tpu
    from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle

    spec, tspec = KvSpec(n_keys=4, n_values=4), TKv(n_keys=4, n_values=4)
    cfg = dict(n_trials=8, n_pids=8, max_ops=24, seed=5)
    ref = qsm_tpu.prop_concurrent(spec, AtomicKvSUT(spec),
                                  qsm_tpu.PropertyConfig(**cfg),
                                  backend=jpc.PComp(spec),
                                  oracle=JOracle())
    pc = tpc.PComp(tspec)
    got = prop_concurrent(tspec, TAtomicKv(tspec), PropertyConfig(**cfg),
                          backend=pc, oracle=TOracle())
    assert got.ok and ref.ok
    assert got.histories_checked == ref.histories_checked
    assert got.distinct_histories == ref.distinct_histories
    assert pc.subs_produced > 0
