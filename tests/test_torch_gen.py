"""The port's generation plane against the JAX package's, on the CPU.

Every case of ``tests/test_gen.py`` runs against the port (determinism per
path, well-formed and linearizable-by-construction corpora, the profile
grammar, the bounded pool and flip window, the checkpoint rails).  Beside
them, tolerance 0 throughout:

* the threefry table: ``raw_draws_plain`` equals ``_raw_draws_jax`` bit
  for bit over a grid of seeds (2**31, 2**32 + 5 and -3 among them) and
  shapes up to 64 x ``_n_draws(128)``;
* ``generate_batch`` gives the reference's histories, list for list, on
  ``"py"`` and on ``"jax"`` with ``device="cpu"``; mutation sequences
  match under one ``random.Random``;
* without CUDA the device paths raise ``BackendUnavailable`` unless
  ``device="cpu"`` is passed, and ``"jax"`` never turns into ``"py"``;
* ``SteeringLoop`` round reports and pools equal the reference's on the
  memo oracle, on ``CppOracle`` and on ``TorchStepper`` against
  ``JaxTPU``.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from qsm_tpu.gen import GenProfile as JProfile
from qsm_tpu.gen import SteeringLoop as JLoop
from qsm_tpu.gen import generate_batch as j_generate_batch
from qsm_tpu.gen.core import _n_draws as j_n_draws
from qsm_tpu.gen.core import _raw_draws_jax
from qsm_tpu.models.registry import MODELS as J_MODELS
from qsm_tpu.native import CppOracle as JCpp
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle
from qsm_tpu_torch.gen import (GenProfile, SeedPool, SteeringLoop,
                               generate_batch)
from qsm_tpu_torch.gen import core as gen_core
from qsm_tpu_torch.gen.core import _n_draws
from qsm_tpu_torch.gen.steer import _FLIP_KEEP, PoolSeed
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.native import CppOracle
from qsm_tpu_torch.ops.backend import BackendUnavailable, Verdict
from qsm_tpu_torch.ops.draws_kernel import (raw_draws, raw_draws_plain,
                                            reserve_host_table,
                                            table_to_host, threefry_draws)
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.sched.runner import PENDING_T

FAMILIES = ("rangeset", "semaphore", "register")


def _fingerprint(histories):
    return tuple(tuple((o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
                        o.response_time) for o in h.ops)
                 for h in histories)


def _table(seed, lanes, draws):
    return raw_draws_plain(seed, lanes, draws).numpy().view(np.uint32)


# -- the cases of tests/test_gen.py, on the port ------------------------

def test_py_path_is_bit_deterministic():
    spec = MODELS["rangeset"].make_spec()
    profile = GenProfile(n_pids=4, n_ops=24, key_skew=1.0,
                         p_pending=0.1, p_adverse=0.05)
    a = generate_batch(spec, profile, seed=7, n=8, path="py")
    b = generate_batch(spec, profile, seed=7, n=8, path="py")
    assert _fingerprint(a) == _fingerprint(b)
    c = generate_batch(spec, profile, seed=8, n=8, path="py")
    assert _fingerprint(a) != _fingerprint(c)


def test_jax_path_is_self_deterministic():
    spec = MODELS["register"].make_spec()
    profile = GenProfile(n_pids=2, n_ops=12)
    a = generate_batch(spec, profile, seed=3, n=4, path="jax", device="cpu")
    b = generate_batch(spec, profile, seed=3, n=4, path="jax", device="cpu")
    assert _fingerprint(a) == _fingerprint(b)


def test_generated_histories_are_well_formed():
    spec = MODELS["semaphore"].make_spec()
    profile = GenProfile(n_pids=4, n_ops=24, overlap=0.8,
                         p_pending=0.2)
    for h in generate_batch(spec, profile, seed=5, n=8, path="py"):
        assert len(h.ops) <= profile.n_ops
        times = [o.invoke_time for o in h.ops]
        assert times == sorted(times)
        for o in h.ops:
            assert 0 <= o.cmd < spec.n_cmds
            assert 0 <= o.arg < spec.CMDS[o.cmd].n_args
            if o.response_time == PENDING_T:
                assert o.resp == -1
            else:
                assert 0 <= o.resp < spec.CMDS[o.cmd].n_resps


@pytest.mark.parametrize("family", ["register", "rangeset", "semaphore"])
def test_zero_adverse_corpus_is_linearizable_by_construction(family):
    spec = MODELS[family].make_spec()
    profile = GenProfile(n_pids=4, n_ops=16, p_adverse=0.0,
                         p_pending=0.0)
    for path in ("py", "jax"):
        hists = generate_batch(spec, profile, seed=11, n=8, path=path,
                               device="cpu")
        verdicts = WingGongCPU(memo=True).check_histories(spec, hists)
        assert all(int(v) == int(Verdict.LINEARIZABLE) for v in verdicts)


def test_profile_round_trips_through_dict():
    p = GenProfile(op_mix=(1.0, 0.5, 2.0), key_skew=1.5, n_pids=6,
                   n_ops=32, overlap=0.7, p_pending=0.1,
                   p_adverse=0.02)
    assert GenProfile.from_dict(p.to_dict()) == p
    assert GenProfile.from_dict({}) == GenProfile()


def test_mutate_moves_exactly_one_knob():
    p = GenProfile(op_mix=(1.0, 1.0), key_skew=1.0, n_pids=4,
                   n_ops=24, overlap=0.5, p_pending=0.1,
                   p_adverse=0.05)
    for s in range(40):
        q = p.mutate(random.Random(s))
        diffs = [k for k, v in p.to_dict().items()
                 if q.to_dict()[k] != v]
        assert len(diffs) == 1, (s, diffs)


def test_mutate_respects_domain_bounds():
    p = GenProfile()
    rng = random.Random(0)
    for _ in range(300):
        p = p.mutate(rng)
        assert 2 <= p.n_pids <= 16
        assert 4 <= p.n_ops <= 128
        assert 0.0 <= p.key_skew <= 4.0
        assert 0.0 <= p.p_pending <= 0.3
        assert 0.0 <= p.p_adverse <= 0.5
        assert 0.05 <= p.overlap <= 0.95


def test_weights_pad_floor_and_normalize():
    p = GenProfile(op_mix=(0.0, 4.0))
    w = p.weights(3)
    assert len(w) == 3
    assert abs(sum(w) - 1.0) < 1e-9
    assert all(x > 0.0 for x in w)
    assert w[1] == max(w)


def test_seed_pool_holds_its_cap_and_keeps_the_best():
    pool = SeedPool(cap=4)
    for i in range(50):
        pool.add(PoolSeed(profile=GenProfile(), seed=i, score=float(i)))
    assert len(pool) == 4
    assert pool.best().score == 49.0
    assert all(s.score >= 46.0 for s in pool._seeds)
    with pytest.raises(ValueError):
        SeedPool(cap=0)


def test_loop_counters_and_flip_tail_window():
    spec = MODELS["register"].make_spec()
    profile = GenProfile(n_pids=2, n_ops=8, p_adverse=0.9)
    loop = SteeringLoop(spec, WingGongCPU(memo=True), profile=profile,
                        batch=32, seed=1, path="py")
    reports = loop.run(4)
    assert len(reports) == 4
    assert loop.stats.gen_feedback_rounds == 4
    assert loop.stats.gen_mutations == 4
    assert loop.stats.gen_seqs == 4 * 32
    assert loop.stats.gen_flips == sum(r["flips"] for r in reports)
    assert loop.stats.gen_flips > _FLIP_KEEP
    assert len(loop.flip_histories) <= _FLIP_KEEP


def test_checkpoint_round_trip_and_spec_mismatch(tmp_path):
    spec = MODELS["rangeset"].make_spec()
    loop = SteeringLoop(spec, WingGongCPU(memo=True),
                        profile=GenProfile(n_pids=2, n_ops=8),
                        batch=4, seed=2, path="py")
    loop.run(2)
    ckpt = str(tmp_path / "steer.json")
    loop.save(ckpt)

    fresh = SteeringLoop(spec, WingGongCPU(memo=True),
                         profile=GenProfile(n_pids=2, n_ops=8),
                         batch=4, seed=2, path="py")
    assert fresh.load(ckpt)
    assert fresh.pool.to_dict() == loop.pool.to_dict()
    assert fresh.stats.gen_seqs == loop.stats.gen_seqs
    assert fresh.stats.gen_flips == loop.stats.gen_flips
    assert fresh.stats.gen_feedback_rounds == 2
    assert fresh._next_seed == loop._next_seed

    other = SteeringLoop(MODELS["register"].make_spec(),
                         WingGongCPU(memo=True), batch=4, path="py")
    with pytest.raises(ValueError, match="checkpoint is for spec"):
        other.load(ckpt)
    assert not fresh.load(str(tmp_path / "absent.json"))


# -- the threefry table against _raw_draws_jax --------------------------

@pytest.mark.parametrize("seed", [0, 7, 17, 123456, 2**31 - 1, 2**31,
                                  2**32 + 5, -3, 1_000_004])
@pytest.mark.parametrize("lanes,draws", [(1, 1), (3, 5), (33, 17),
                                         (64, 624), (5, 3120),
                                         (64, j_n_draws(128))])
def test_plain_table_equals_raw_draws_jax(seed, lanes, draws):
    got = _table(seed, lanes, draws)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, _raw_draws_jax(seed, lanes, draws))


def test_known_answers_of_the_reference_table():
    assert _table(7, 3, 5)[0].tolist() == [3725328165, 2389352394,
                                           1291398195, 1428036129,
                                           4260943734]
    assert _table(-3, 2, 3).tolist() == [
        [2585318788, 4151447820, 471961339],
        [2707064578, 2513172215, 3288622452]]
    assert _table(2**32 + 5, 2, 3).tolist() == [
        [2839113055, 3758129494, 1086722469],
        [359975681, 984463424, 482527479]]


def test_draw_counts_and_row_independence():
    assert _n_draws(24) == j_n_draws(24) == 624
    assert _n_draws(128) == 3120
    # a lane's row depends on (seed, lane) alone: a narrower table is a
    # prefix of a wider one
    wide = _table(9, 40, 100)
    np.testing.assert_array_equal(_table(9, 7, 100), wide[:7])


def test_wrapper_takes_the_plain_version_for_a_cpu_tensor():
    before = threefry_draws.launches
    out = torch.full((4, 9), 5, dtype=torch.int32)
    assert threefry_draws(out, 17) is out
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  _raw_draws_jax(17, 4, 9))
    assert threefry_draws.launches == before  # no kernel was launched
    with pytest.raises(ValueError):
        threefry_draws(torch.empty((4, 9), dtype=torch.int64), 17)
    with pytest.raises(ValueError):
        threefry_draws(torch.empty((9, 4), dtype=torch.int32).t(), 17)


# -- the table's copy to the host ---------------------------------------

def test_table_to_host_returns_a_cpu_table_as_it_is(monkeypatch):
    """On the CPU the copy function hands back the plain table itself,
    viewed as uint32, and never pins: no pinned tensor is asked for."""
    asked = []
    empty = torch.empty

    def recording_empty(*a, **kw):
        asked.append(kw.get("pin_memory", False))
        return empty(*a, **kw)

    def no_pinning(*a, **kw):
        raise AssertionError("pinned on the CPU")

    tab = raw_draws_plain(17, 4, 9)
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch.Tensor, "pin_memory", no_pinning)
    host = table_to_host(tab)
    assert host.dtype == np.uint32 and host.shape == (4, 9)
    assert np.shares_memory(host, tab.numpy())
    np.testing.assert_array_equal(host, _raw_draws_jax(17, 4, 9))
    assert not any(asked)
    with pytest.raises(ValueError):
        table_to_host(tab.to("meta"))


def test_generate_batch_copies_through_table_to_host(monkeypatch):
    """The ``"jax"`` path's table reaches the assembly through
    ``table_to_host``, once a batch."""
    from qsm_tpu_torch.ops import draws_kernel

    calls = []

    def counting(table):
        calls.append(tuple(table.shape))
        return table_to_host(table)

    monkeypatch.setattr(draws_kernel, "table_to_host", counting)
    spec = MODELS["register"].make_spec()
    generate_batch(spec, GenProfile(n_pids=3, n_ops=12), 4, 6, path="jax",
                   device="cpu")
    assert calls == [(6, _n_draws(12))]


def test_reserve_host_table_pins_nothing_on_the_cpu(monkeypatch):
    """The pinned warm-up is for CUDA tables alone: for the CPU, and for a
    loop whose tables stay on the CPU, no pinned tensor is asked for."""
    asked = []
    empty = torch.empty

    def recording_empty(*a, **kw):
        asked.append(kw.get("pin_memory", False))
        return empty(*a, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    reserve_host_table(4, 9, "cpu")
    spec = MODELS["register"].make_spec()
    for path in ("py", "jax"):
        SteeringLoop(spec, WingGongCPU(memo=True), path=path, device="cpu")
    assert not any(asked)


@pytest.mark.parametrize("path,n_ops,batch", [("jax", 8, 16),
                                              ("auto", 32, 1024),
                                              ("py", 8, 16)])
def test_steering_loop_reserves_its_first_table_once(monkeypatch, path,
                                                     n_ops, batch):
    """A loop whose tables run on CUDA pins the block of its first table's
    copy (batch x draws of its starting profile) once, when it is built,
    and not in its rounds; the ``"py"`` path reserves nothing."""
    from qsm_tpu_torch.gen import steer

    calls = []
    monkeypatch.setattr(steer, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(steer, "reserve_host_table",
                        lambda *a: calls.append(a))
    spec = MODELS["register"].make_spec()
    SteeringLoop(spec, WingGongCPU(memo=True), batch=batch, path=path,
                 profile=GenProfile(n_pids=3, n_ops=n_ops))
    want = [] if path == "py" else [(batch, _n_draws(n_ops),
                                     torch.device("cuda", 0))]
    assert calls == want


@pytest.mark.parametrize("family", FAMILIES)
def test_successive_jax_batches_equal_the_reference(family):
    """Two successive ``"jax"`` batches on the CPU each give the
    reference's histories, list for list, and the second leaves the
    first's as they were."""
    spec, jspec = MODELS[family].make_spec(), J_MODELS[family].make_spec()
    kw = dict(n_pids=4, n_ops=16, p_pending=0.1, p_adverse=0.1)
    first = generate_batch(spec, GenProfile(**kw), 21, 10, path="jax",
                           device="cpu")
    kept = _fingerprint(first)
    second = generate_batch(spec, GenProfile(**kw), 22, 10, path="jax",
                            device="cpu")
    assert _fingerprint(first) == kept
    for seed, got in ((21, first), (22, second)):
        want = j_generate_batch(jspec, JProfile(**kw), seed, 10, path="jax")
        assert _fingerprint(got) == _fingerprint(want)


# -- generate_batch against the reference ------------------------------

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("path", ["py", "jax"])
def test_generate_batch_equals_reference(family, path):
    spec, jspec = MODELS[family].make_spec(), J_MODELS[family].make_spec()
    for kw in (dict(n_pids=4, n_ops=24, key_skew=1.0, p_pending=0.1,
                    p_adverse=0.05),
               dict(op_mix=(2.0, 0.5), n_pids=8, n_ops=32, overlap=0.8,
                    p_adverse=0.2)):
        got = generate_batch(spec, GenProfile(**kw), 7, 12, path=path,
                             device="cpu")
        want = j_generate_batch(jspec, JProfile(**kw), 7, 12, path=path)
        assert _fingerprint(got) == _fingerprint(want)
        assert [(h.seed, h.program_id) for h in got] == \
            [(h.seed, h.program_id) for h in want]


def test_auto_is_the_jax_table():
    spec = MODELS["register"].make_spec()
    profile = GenProfile(n_pids=3, n_ops=12)
    a = generate_batch(spec, profile, 4, 6, path="auto", device="cpu")
    b = generate_batch(spec, profile, 4, 6, path="jax", device="cpu")
    assert _fingerprint(a) == _fingerprint(b)
    assert _fingerprint(a) != _fingerprint(
        generate_batch(spec, profile, 4, 6, path="py"))


def test_mutation_sequences_match_under_one_rng():
    p, q = GenProfile(), JProfile()
    rp, rq = random.Random("mut:5"), random.Random("mut:5")
    for _ in range(200):
        p, q = p.mutate(rp), q.mutate(rq)
        assert p.to_dict() == q.to_dict()
        assert p.weights(4) == q.weights(4)


def test_unknown_path_raises():
    spec = MODELS["register"].make_spec()
    with pytest.raises(ValueError, match="path must be"):
        generate_batch(spec, GenProfile(), 1, 2, path="numpy")
    with pytest.raises(ValueError, match="path must be"):
        SteeringLoop(spec, WingGongCPU(), path="numpy")


# -- no CUDA: the device paths raise ------------------------------------

def test_without_cuda_the_device_paths_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = MODELS["register"].make_spec()
    with pytest.raises(BackendUnavailable):
        raw_draws(1, 2, 3)
    for path in ("jax", "auto"):
        with pytest.raises(BackendUnavailable):
            generate_batch(spec, GenProfile(), 1, 2, path=path)
        with pytest.raises(BackendUnavailable):
            SteeringLoop(spec, WingGongCPU(memo=True), path=path)
    # the "py" table is host code and needs no device; device="cpu" runs
    # the plain version
    assert len(generate_batch(spec, GenProfile(), 1, 2, path="py")) == 2
    assert len(generate_batch(spec, GenProfile(), 1, 2, path="jax",
                              device="cpu")) == 2
    SteeringLoop(spec, WingGongCPU(memo=True), path="py")
    SteeringLoop(spec, WingGongCPU(memo=True), path="jax", device="cpu")


def test_device_table_never_falls_back_to_py(monkeypatch):
    """A failing device table raises out of ``generate_batch``; the
    ``"py"`` table is never consulted."""
    spec = MODELS["register"].make_spec()

    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    def py_table(*a, **kw):
        raise AssertionError("the py table was consulted")

    monkeypatch.setattr(gen_core, "_raw_draws_device", broken)
    monkeypatch.setattr(gen_core, "_raw_draws_py", py_table)
    with pytest.raises(RuntimeError, match="launch failed"):
        generate_batch(spec, GenProfile(), 1, 2, path="jax", device="cpu")


# -- the steering loop against the reference ----------------------------

def _loops_equal(spec, jspec, backend, jbackend, rounds=3, **kw):
    loop = SteeringLoop(spec, backend, **kw, device="cpu")
    jloop = JLoop(jspec, jbackend, **kw)
    assert loop.seed_profile().to_dict() == jloop.seed_profile().to_dict()
    got, want = loop.run(rounds), jloop.run(rounds)
    assert got == want
    assert loop.pool.to_dict() == jloop.pool.to_dict()
    assert loop.stats.to_compact() == jloop.stats.to_compact()
    assert [h.fingerprint() for h, _ in loop.flip_histories] == \
        [tuple((o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
                o.response_time) for o in h.ops)
         for h, _ in jloop.flip_histories]
    return got


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("path", ["py", "jax"])
def test_steering_loop_equals_reference_on_the_memo_oracle(family, path):
    reports = _loops_equal(MODELS[family].make_spec(),
                           J_MODELS[family].make_spec(),
                           WingGongCPU(memo=True), JOracle(memo=True),
                           rounds=4, batch=16, seed=17, path=path)
    assert any(r["nodes_per_hist"] > 0 for r in reports)


@pytest.mark.parametrize("family", FAMILIES)
def test_steering_loop_equals_reference_on_the_native_oracle(family):
    spec, jspec = MODELS[family].make_spec(), J_MODELS[family].make_spec()
    _loops_equal(spec, jspec, CppOracle(spec), JCpp(jspec), rounds=3,
                 profile=GenProfile(n_pids=4, n_ops=16, p_adverse=0.2),
                 batch=24, seed=5, path="auto")


def test_steering_loop_equals_reference_on_the_device_engines():
    """``TorchStepper(device="cpu")`` against ``JaxTPU`` at 2 pids x 8
    ops: the same verdicts, so the same scores and pools."""
    spec, jspec = MODELS["register"].make_spec(), \
        J_MODELS["register"].make_spec()
    jax_tpu = JaxTPU(jspec)
    t = TorchStepper(spec, device="cpu",
                     chunk_schedule=jax_tpu.CHUNK_SCHEDULE,
                     batch_buckets=jax_tpu.BATCH_BUCKETS,
                     slots_for_batch={b: jax_tpu._slots_for(b)
                                      for b in jax_tpu.BATCH_BUCKETS})
    reports = _loops_equal(spec, jspec, t, jax_tpu, rounds=3,
                           profile=GenProfile(n_pids=2, n_ops=8,
                                              p_adverse=0.3),
                           batch=8, seed=3, path="jax")
    assert sum(r["flips"] for r in reports) > 0
    assert t.search_stats().histories == \
        jax_tpu.search_stats().histories > 0


def test_loop_search_stats_absorb_the_backend():
    spec = MODELS["rangeset"].make_spec()
    oracle = WingGongCPU(memo=True)
    loop = SteeringLoop(spec, oracle, batch=8, seed=1, path="py")
    loop.run(2)
    st = loop.search_stats()
    assert st.engine == "gen"
    assert st.gen_seqs == 16 and st.gen_feedback_rounds == 2
    assert st.nodes_explored == oracle.nodes_explored > 0
