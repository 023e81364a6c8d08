"""The port's native host oracle against the JAX package's: the library
builds (the toolchain is part of the image: a failed build fails, never
skips), and ``CppOracle`` gives the reference ``CppOracle``'s verdicts and
the port's Python oracle's on every case of the reference's native tests:
pending-op histories, budget semantics, the vector step kinds, fallback
routing, start states, end-state enumeration and invalid start states.
Tolerance: exact."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu import generate_program, run_concurrent
from qsm_tpu.models import AtomicCasSUT, CasSpec, QueueSpec, RacyCasSUT
from qsm_tpu.models.queue import AtomicQueueSUT, RacyTwoPhaseQueueSUT
from qsm_tpu.models.register import (AtomicRegisterSUT,
                                     RacyCachedRegisterSUT, RegisterSpec)
from qsm_tpu.models.registry import make as j_make
from qsm_tpu.native import CppOracle as JCpp
from qsm_tpu.sched.scheduler import FaultPlan
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.history import History
from qsm_tpu_torch.models.registry import make as t_make
from qsm_tpu_torch.native import (CppOracle, library_path,
                                  native_available, native_error,
                                  native_status)
from qsm_tpu_torch.native.oracle import NATIVE_MAX_OPS, _blockers2
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU as TOracle
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _tspec(name, **kw):
    return t_make(name, "atomic", kw or None)[0]


def _both(jspec, tspec, hs, **kw):
    """(port CppOracle, its verdicts, the reference CppOracle's, the
    port's Python oracle's) on one corpus."""
    cpp = CppOracle(tspec, **kw)
    got = cpp.check_histories(tspec, _port(hs))
    ref = JCpp(jspec, **kw)
    want = ref.check_histories(jspec, hs)
    py = TOracle(memo=kw.get("memo", True),
                 node_budget=kw.get("node_budget", 50_000_000))
    np.testing.assert_array_equal(got, want)
    assert (cpp.native_histories, cpp.fallback_histories) == \
        (ref.native_histories, ref.fallback_histories)
    return cpp, got, want, py.check_histories(tspec, _port(hs))


def test_native_lib_builds():
    assert native_available(), native_error()
    assert native_status() == "loaded"
    assert library_path().exists()


@pytest.mark.parametrize("compiler,source", [
    ("g++", "int main( {"),                       # the compiler refuses it
    ("no-such-compiler", "int f() { return 0; }"),  # no compiler at all
])
def test_a_failed_native_build_raises_and_leaves_no_file(tmp_path, compiler,
                                                         source):
    """The native library builds through the CUDA kernels' build: a
    failed build raises ``KernelBuildError`` and installs nothing, not
    even its temporary file."""
    from qsm_tpu_torch.native import GXX_FLAGS
    from qsm_tpu_torch.ops import kernels

    src = tmp_path / "broken.cpp"
    src.write_text(source)
    out = kernels.library_path("broken", src, GXX_FLAGS)
    with pytest.raises(kernels.KernelBuildError):
        kernels.build("broken", src, compiler, GXX_FLAGS, timeout=120)
    assert not out.exists()
    assert not list(out.parent.glob(f"{out.stem}.*.tmp.so"))
    assert library_path().parent.name == "qsm_tpu_torch"


def test_parity_cas_corpus():
    spec = CasSpec()
    corpus = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=96,
                          n_pids=8, max_ops=32, seed_base=1000,
                          seed_prefix="bench")
    cpp, got, _, py = _both(spec, _tspec("cas"), corpus)
    np.testing.assert_array_equal(got, py)
    assert cpp.native_histories == len(corpus)  # no silent fallback
    assert (got == int(Verdict.VIOLATION)).any()
    assert (got == int(Verdict.LINEARIZABLE)).any()
    assert cpp.nodes_explored > 0


def test_parity_register_with_pending_ops():
    """Fault-injected histories carry pending ops; the C++ search
    completes or prunes them exactly as the oracle does."""
    spec = RegisterSpec(n_values=5)
    hists = []
    for seed in range(48):
        prog = generate_program(spec, seed=seed, n_pids=2, max_ops=12)
        sut = (AtomicRegisterSUT if seed % 2 else RacyCachedRegisterSUT)()
        hists.append(run_concurrent(
            sut, prog, seed=f"n{seed}",
            faults=FaultPlan(p_drop=0.2, p_duplicate=0.1)))
    assert any(h.n_pending for h in hists), "fault corpus vacuous"
    cpp, got, _, py = _both(spec, _tspec("register", n_values=5), hists)
    np.testing.assert_array_equal(got, py)
    # out-of-domain responses go to the fallback on the table path, by
    # design; the bulk still goes native
    assert cpp.native_histories >= 0.8 * len(hists)
    assert cpp.native_histories + cpp.fallback_histories == len(hists)


@pytest.mark.parametrize("budget", [50, 500, 5_000])
def test_budget_semantics_match_oracle(budget):
    """The same candidate order and node accounting: the same verdicts,
    which histories exceed a tiny budget included."""
    spec = CasSpec()
    corpus = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=48,
                          n_pids=8, max_ops=24, seed_base=7,
                          seed_prefix="budget")
    _, got, _, py = _both(spec, _tspec("cas"), corpus, node_budget=budget,
                          memo=False)
    np.testing.assert_array_equal(got, py)
    if budget == 50:
        assert (got == int(Verdict.BUDGET_EXCEEDED)).any()


def test_queue_native_kernel_parity():
    """Queue histories run the C++ queue step (kind 1) at the registry's
    full size, 48 ops."""
    spec = QueueSpec()
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=48, n_pids=8, max_ops=48, seed_base=1000,
                          seed_prefix="bench")
    cpp, got, _, py = _both(spec, _tspec("queue"), corpus)
    np.testing.assert_array_equal(got, py)
    assert cpp.native_histories == len(corpus)
    assert (got == int(Verdict.VIOLATION)).any()
    assert (got == int(Verdict.LINEARIZABLE)).any()


def test_kv_native_kernel_parity():
    """KV histories (kind 2), whole and undecomposed, against the
    reference and the port's per-key decomposition."""
    from qsm_tpu.models import KvSpec
    from qsm_tpu.models.kv import AtomicKvSUT, StaleCacheKvSUT
    from qsm_tpu_torch.ops.pcomp import PComp

    spec = KvSpec()
    corpus = build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT), n=24,
                          n_pids=8, max_ops=32, seed_base=1000,
                          seed_prefix="bench")
    tspec = _tspec("kv")
    cpp, got, _, _ = _both(spec, tspec, corpus, node_budget=20_000_000)
    want = PComp(tspec).check_histories(tspec, _port(corpus))
    decided = got != int(Verdict.BUDGET_EXCEEDED)
    assert decided.all()
    np.testing.assert_array_equal(got, want)
    assert cpp.native_histories == len(corpus)
    assert (got == int(Verdict.VIOLATION)).any()


def test_stack_native_kernel_parity():
    """Stack histories run the C++ stack step (kind 3)."""
    from qsm_tpu.models.stack import AtomicStackSUT, RacyTwoPhaseStackSUT

    jspec = j_make("stack", "atomic")[0]
    corpus = build_corpus(jspec, (AtomicStackSUT, RacyTwoPhaseStackSUT),
                          n=32, n_pids=6, max_ops=24, seed_base=5,
                          seed_prefix="stack")
    cpp, got, _, py = _both(jspec, _tspec("stack"), corpus)
    np.testing.assert_array_equal(got, py)
    assert cpp.native_histories == len(corpus)
    assert cpp._vector_kernel == (3, 4, 4)


def test_unknown_vector_spec_routes_to_fallback():
    """A vector spec without a C++ step still gets exact verdicts from
    the Python fallback."""
    spec = QueueSpec()
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=16, n_pids=4, max_ops=16, seed_base=3,
                          seed_prefix="fb")
    tspec = _tspec("queue")
    cpp = CppOracle(tspec)
    cpp._vector_kernel = None  # as for a spec with no C++ step
    assert not cpp.can_enumerate()
    ref = JCpp(spec)
    ref._vector_kernel = None
    got = cpp.check_histories(tspec, _port(corpus))
    np.testing.assert_array_equal(got, ref.check_histories(spec, corpus))
    np.testing.assert_array_equal(
        got, TOracle(memo=True).check_histories(tspec, _port(corpus)))
    assert cpp.native_histories == 0
    assert cpp.fallback_histories == len(corpus)


@pytest.mark.parametrize("model", ["register", "cas", "queue", "kv",
                                   "set", "ticket"])
def test_can_enumerate_and_routing_match_reference(model):
    jspec = j_make(model, "atomic")[0]
    tspec = _tspec(model)
    cpp, ref = CppOracle(tspec), JCpp(jspec)
    assert cpp.can_enumerate() == ref.can_enumerate()
    assert cpp._vector_kernel == ref._vector_kernel
    assert cpp._uses_table() == ref._uses_table()


def test_check_from_init_state():
    """Searches started from explicit model states agree with the Python
    oracle's ``check_from`` and the reference's."""
    from qsm_tpu import overlapping_history as j_overlapping

    spec, tspec = RegisterSpec(n_values=5), _tspec("register", n_values=5)
    READ = 0
    jh = j_overlapping([(0, READ, 0, 3, 0, 1)])
    h = _port([jh])[0]
    cpp, ref, py = CppOracle(tspec), JCpp(spec), TOracle(memo=True)
    for s in range(5):
        state = np.asarray([s], np.int32)
        got = cpp.check_from(tspec, h, state)
        assert got == py.check_from(tspec, h, state), s
        assert int(got) == int(ref.check_from(spec, jh, state)), s


def test_end_states_matches_python_enumeration():
    """Native end-state enumeration of the middle segments of queue
    histories equals the reference's Python walk and its native one."""
    from qsm_tpu.ops.segdc import _Budget, _end_states, \
        split_at_quiescent_cuts

    spec = QueueSpec()
    tspec = _tspec("queue")
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=48, n_pids=8, max_ops=48, seed_base=1000,
                          seed_prefix="bench")
    cpp, ref = CppOracle(tspec), JCpp(spec)
    checked = 0
    for h in corpus:
        segs = split_at_quiescent_cuts(h)
        if len(segs) <= 1:
            continue
        frontier = {tuple(int(v) for v in spec.initial_state())}
        for seg in segs[:-1]:
            want = _end_states(spec, seg, frontier, _Budget(10_000_000))
            tseg = _port([History(list(seg))])[0].ops
            got = cpp.end_states(tspec, tseg, frontier)
            assert got == want, (len(seg), sorted(frontier))
            assert got == ref.end_states(spec, seg, frontier)
            checked += 1
            frontier = want
    assert checked > 0, "corpus produced no middle segments"
    assert cpp.nodes_explored > 0


def test_frontier_start_past_segment_bound_is_exact():
    """A ticket-dispenser start state beyond the from-initial state bound
    of a short segment: the table covers it (and anything still escaping
    defers), never a misread."""
    from qsm_tpu import overlapping_history as j_overlapping

    tspec = _tspec("ticket", n_tickets=32)
    TAKE = 0
    ops = [(0, TAKE, 0, i, 2 * i, 2 * i + 1) for i in range(10)]
    good = _port([j_overlapping(ops + [(1, TAKE, 0, 10, 100, 101)])])[0]
    cpp = CppOracle(tspec)
    # the last segment, TAKE -> 10, from the frontier state 10
    assert cpp.end_states(tspec, good.ops[-1:], {(10,)}) == {(11,)}
    h1 = _port([j_overlapping([(0, TAKE, 0, 20, 0, 1)])])[0]
    start = np.asarray([20], np.int32)
    assert cpp.check_from(tspec, h1, start) == \
        TOracle().check_from(tspec, h1, start) == Verdict.LINEARIZABLE
    bad = _port([j_overlapping([(0, TAKE, 0, 3, 0, 1)])])[0]
    assert cpp.check_from(tspec, bad, start) == Verdict.VIOLATION


def test_invalid_start_states_defer_never_corrupt():
    """Foreign or corrupt start states of a vector step defer
    (BUDGET_EXCEEDED) rather than overrun the state or alias memo
    keys."""
    from qsm_tpu import overlapping_history as j_overlapping

    spec, tspec = QueueSpec(), _tspec("queue")
    jh = j_overlapping([(0, 0, 1, 0, 0, 1)])  # ENQ(1) -> OK
    h = _port([jh])[0]
    cpp, ref = CppOracle(tspec), JCpp(spec)
    for bad in ([70, 0, 0, 0, 0], [-3, 0, 0, 0, 0], [1, 99, 0, 0, 0]):
        v = cpp.check_from(tspec, h, np.asarray(bad, np.int32))
        assert v == Verdict.BUDGET_EXCEEDED, bad
        assert int(ref.check_from(spec, jh, np.asarray(bad, np.int32))) \
            == int(v)
        assert cpp.end_states(tspec, h.ops, {tuple(bad)}) is None
    assert cpp.check_from(tspec, h, np.zeros(5, np.int32)) == \
        Verdict.LINEARIZABLE


@pytest.mark.parametrize("model,n_pids,max_ops,faults", [
    ("register", 2, 12, dict(p_drop=0.2)),
    ("ticket", 4, 24, None),
    ("cas", 8, 24, dict(p_duplicate=0.15)),
    ("queue", 6, 32, None),
    ("kv", 8, 32, None),
])
def test_randomized_cross_spec_parity_sweep(model, n_pids, max_ops,
                                            faults):
    """Native verdicts equal the reference's and the Python oracle's on
    runner-made corpora (faults for the scalar specs)."""
    jspec, _ = j_make(model, "atomic")
    hists = []
    for seed in range(20):
        impl = "atomic" if seed % 2 else "racy"
        _, sut = j_make(model, impl)
        prog = generate_program(jspec, seed=seed * 7 + 1, n_pids=n_pids,
                                max_ops=max_ops)
        hists.append(run_concurrent(
            sut, prog, seed=f"x{seed}",
            faults=FaultPlan(**faults) if faults else None))
    cpp, got, _, py = _both(jspec, _tspec(model), hists,
                            node_budget=10_000_000)
    decided = (got != 2) & (py != 2)
    np.testing.assert_array_equal(got[decided], py[decided])
    assert cpp.native_histories > 0, model
    assert decided.any(), model


def test_witness_is_the_python_oracle_s():
    spec = CasSpec()
    corpus = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=8, n_pids=4,
                          max_ops=12, seed_base=2, seed_prefix="w")
    tspec = _tspec("cas")
    cpp, py = CppOracle(tspec), TOracle(memo=True)
    for h in _port(corpus):
        assert cpp.check_witness(tspec, h) == py.check_witness(tspec, h)


def test_blockers_wire_format_and_cap():
    rng = np.random.default_rng(0)
    prec = rng.random((70, 70)) < 0.3
    words = _blockers2(prec)
    for j in range(70):
        for i in range(70):
            bit = (int(words[j, i >> 6]) >> (i & 63)) & 1
            assert bit == int(prec[i, j])
    with pytest.raises(AssertionError):
        _blockers2(np.zeros((NATIVE_MAX_OPS + 1,) * 2, bool))


def test_long_histories_fall_back():
    """A history past the native mask's 128 ops goes to the Python
    oracle."""
    tspec = _tspec("register")
    ops = [(0, 1, i % 5, 0, 2 * i, 2 * i + 1) for i in range(130)]
    h = history_from_rows([list(o) for o in ops])
    cpp = CppOracle(tspec)
    assert cpp.check_histories(tspec, [h])[0] == Verdict.LINEARIZABLE
    assert (cpp.native_histories, cpp.fallback_histories) == (0, 1)
