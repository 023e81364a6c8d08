"""The port's verdict cache and ``build_kernel`` against the JAX package's,
on the CPU.

``VerdictCache`` (twins of ``tests/test_serve.py:401-497``): the LRU,
persistence and honesty, superseding rows and witnesses, a torn tail
compacted first, bounded growth, an alien file preserved; a bank either
package wrote loads in the other, and ``fingerprint_key`` is the
reference's.

``build_kernel`` (twins of ``tests/test_cache.py:37-138``): the port's
``check_one`` (one fresh carry and one launch of the whole budget, here
the kernels' plain versions) against the reference's ``build_kernel``
under ``jax.jit(jax.vmap(...))``, ``(status, iters)`` equal on every
lane.  The plain stepper takes one eager PyTorch loop trip an iteration,
about a millisecond, so the memo-less side of the collapse case runs at a
budget of 10,000 (still BUDGET) instead of the reference's 500,000;
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 18 (d) run the
500,000 case on the card.  Not twinned: the segmented-bank cases
(``test_cache.py:146-192``), which need the fleet's replicated log."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu.core.history import bucket_for, encode_batch
from qsm_tpu.models import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.models.cas import CasSpec as TCas
from qsm_tpu_torch.ops.stepper_kernel import (build_kernel, hash_slot,
                                              hash_slots_np)
from qsm_tpu_torch.serve.cache import VerdictCache, fingerprint_key
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

SPEC = CasSpec()
TSPEC = TCas()
NO_MEMO_BUDGET = 10_000


# --- VerdictCache ---------------------------------------------------------

def test_verdict_cache_lru_persistence_and_honesty(tmp_path):
    bank = str(tmp_path / "bank.jsonl")
    c = VerdictCache(max_entries=2, path=bank)
    c.put("a", 1, witness=[(0, 1)])
    c.put("b", 0)
    c.put("undecided", 2)
    assert c.get("undecided") is None
    assert c.get("a").witness == [(0, 1)]
    c.put("c", 1)
    assert c.get("b") is None
    assert c.get("a") is not None

    c2 = VerdictCache(max_entries=8, path=bank)
    assert c2.get("a").verdict == 1
    assert c2.get("a").witness == [(0, 1)]
    assert c2.get("c").verdict == 1
    c2.put("a", 1)
    assert c2.get("a").witness == [(0, 1)]


def test_verdict_bank_append_log_supersede_and_witness(tmp_path):
    bank = str(tmp_path / "bank.jsonl")
    c = VerdictCache(max_entries=8, path=bank)
    c.put("a", 1, witness=[(0, 1)])
    c.put("a", 1)
    c2 = VerdictCache(max_entries=8, path=bank)
    assert c2.get("a").witness == [(0, 1)]
    assert c2.stats()["bank_rows"] == 2
    assert len(c2) == 1


def test_verdict_bank_append_after_torn_tail_compacts_first(tmp_path):
    bank = str(tmp_path / "bank.jsonl")
    c = VerdictCache(max_entries=8, path=bank)
    c.put("a", 1)
    c.put("b", 0)
    with open(bank, "a") as f:
        f.write('{"key": "c", "verd')
    c2 = VerdictCache(max_entries=8, path=bank)
    assert c2.get("a") is not None and c2.get("b") is not None
    c2.put("d", 1)
    c3 = VerdictCache(max_entries=8, path=bank)
    assert c3.get("a").verdict == 1
    assert c3.get("b").verdict == 0
    assert c3.get("d").verdict == 1
    c3.put("e", 1)
    assert VerdictCache(max_entries=8, path=bank).get("e") is not None
    with open(bank) as f:
        body = f.read()
    with open(bank, "w") as f:
        f.write(body.rstrip("\n"))
    c4 = VerdictCache(max_entries=8, path=bank)
    assert c4.get("e") is not None
    c4.put("f", 1)
    c5 = VerdictCache(max_entries=8, path=bank)
    assert c5.get("e") is not None and c5.get("f") is not None


def test_verdict_bank_compacts_instead_of_growing_unbounded(tmp_path):
    bank = str(tmp_path / "bank.jsonl")
    c = VerdictCache(max_entries=4, path=bank)
    for i in range(40):
        c.put(f"k{i}", 1)
    st = c.stats()
    assert st["compactions"] >= 1
    assert st["bank_rows"] <= 2 * 40
    c2 = VerdictCache(max_entries=4, path=bank)
    assert c2.get("k39") is not None
    # the same puts bank the same file in the reference
    from qsm_tpu.serve.cache import VerdictCache as JCache

    ref = str(tmp_path / "ref.jsonl")
    j = JCache(max_entries=4, path=ref)
    for i in range(40):
        j.put(f"k{i}", 1)
    assert open(ref).read() == open(bank).read()
    assert {k: v for k, v in j.stats().items() if k != "path"} == \
        {k: v for k, v in st.items() if k != "path"}


def test_verdict_cache_preserves_alien_file(tmp_path):
    path = tmp_path / "not_a_bank.json"
    path.write_text('{"something": "else"}\n')
    c = VerdictCache(path=str(path))
    assert len(c) == 0
    assert (tmp_path / "not_a_bank.json.pre-resume").exists()
    c.put("k", 1)
    assert VerdictCache(path=str(path)).get("k") is not None


def test_banks_cross_packages_and_keys_are_the_references(tmp_path):
    from qsm_tpu.serve.cache import VerdictCache as JCache
    from qsm_tpu.serve.cache import fingerprint_key as j_key

    corpus = build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=8, n_pids=3,
                          max_ops=8, seed_prefix="vc")
    keys = [fingerprint_key(TSPEC, history_from_rows(history_to_rows(h)))
            for h in corpus]
    assert keys == [j_key(SPEC, h) for h in corpus]
    bank = str(tmp_path / "bank.jsonl")
    j = JCache(path=bank)
    j.put(keys[0], 1, witness=[(0, 1), (1, 0)])
    j.put(keys[1], 0)
    mine = VerdictCache(path=bank)
    assert mine.get(keys[0]).witness == [(0, 1), (1, 0)]
    assert mine.get(keys[1]).verdict == 0
    mine.put(keys[2], 1)
    assert JCache(path=bank).get(keys[2]).verdict == 1


# --- build_kernel ---------------------------------------------------------

def _hard_violating_history():
    """bench-corpus history #35 (the reference's): the memo oracle needs
    about 7k nodes, the memo-less search millions of iterations."""
    corpus = build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=36, n_pids=8,
                          max_ops=32, seed_base=1000, seed_prefix="bench")
    return corpus[35]


def _planes(histories):
    n = bucket_for(max(len(h) for h in histories))
    enc = encode_batch(histories, SPEC.initial_state(), max_ops=n)
    return n, (enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
               enc.valid, enc.precedes(), enc.init_state)


def _reference(n, args, budget, slots, mode="onehot"):
    import jax

    from qsm_tpu.ops.jax_kernel import build_kernel as j_build

    single = j_build(SPEC, n, budget=budget, cache_slots=slots,
                     cache_write=mode)
    fn = jax.jit(jax.vmap(single, in_axes=(0, 0, 0, 0, 0, None)))
    s, it = fn(*args)
    return np.asarray(s), np.asarray(it)


def _port(n, args, budget, slots, mode="onehot"):
    return build_kernel(TSPEC, n, budget, cache_slots=slots,
                        cache_write=mode, device="cpu")(*args)


def test_cache_collapses_iterations_same_verdict():
    n, args = _planes([_hard_violating_history()])
    s_cache, it_cache = _port(n, args, 500_000, 4096)
    assert int(s_cache[0]) == 2       # FAILURE (a violation), decided
    assert int(it_cache[0]) < 50_000
    rs, rit = _reference(n, args, 500_000, 4096)
    np.testing.assert_array_equal(s_cache, rs)
    np.testing.assert_array_equal(it_cache, rit)
    # without the memo the budget runs out undecided
    s_plain, it_plain = _port(n, args, NO_MEMO_BUDGET, 0)
    assert int(s_plain[0]) == 3 and int(it_plain[0]) == NO_MEMO_BUDGET
    rs, rit = _reference(n, args, NO_MEMO_BUDGET, 0)
    np.testing.assert_array_equal(s_plain, rs)
    np.testing.assert_array_equal(it_plain, rit)


@pytest.mark.slow
def test_cache_verdicts_match_plain_on_easy_corpus():
    corpus = build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=24, n_pids=4,
                          max_ops=12, seed_base=7, seed_prefix="cc")
    n, args = _planes(corpus)
    s_cache, it_cache = _port(n, args, 200_000, 1024)
    s_plain, _ = _port(n, args, 200_000, 0)
    np.testing.assert_array_equal(s_cache, s_plain)
    rs, rit = _reference(n, args, 200_000, 1024)
    np.testing.assert_array_equal(s_cache, rs)
    np.testing.assert_array_equal(it_cache, rit)


def test_hash_spreads_high_bit_keys():
    import jax.numpy as jnp
    import torch

    from qsm_tpu.ops.jax_kernel import make_hash_slot

    keys = [(0x01FFFFFF, 0), (0x00FFFFFF, 0), (0x01FBFFFF, 0),
            (0x00FBFFFF, 0), (0x017BFFFF, 0), (0x007BFFFF, 0)]
    got = hash_slot(torch.tensor(keys, dtype=torch.int64), 4096).tolist()
    assert len(set(got)) == len(keys), got
    ref = make_hash_slot(key_words=2, cache_slots=4096)
    assert got == [int(ref(jnp.asarray(k, jnp.uint32))) for k in keys]


def test_numpy_hash_mirror_matches_kernel():
    import jax.numpy as jnp
    import torch

    from qsm_tpu.ops.jax_kernel import make_hash_slot

    rng = np.random.default_rng(3)
    for key_words in (2, 3, 5):
        for slots in (64, 512, 4096):
            keys = rng.integers(0, 2**32, size=(50, key_words),
                                dtype=np.uint32)
            kern = make_hash_slot(key_words, slots)
            expect = [int(kern(jnp.asarray(k))) for k in keys]
            assert hash_slots_np(keys, slots).tolist() == expect
            assert hash_slot(torch.from_numpy(keys.astype(np.int64)),
                             slots).tolist() == expect


@pytest.mark.slow
def test_chunked_driver_compaction_parity():
    """The chunked, lane-compacting driver on a corpus hard enough for
    several compactions and a memo growth: verdicts equal to the oracle's
    and to the reference's chunked driver."""
    from qsm_tpu.ops.jax_kernel import JaxTPU
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU

    corpus = build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=48, n_pids=8,
                          max_ops=32, seed_base=1000, seed_prefix="bench")
    mine = [history_from_rows(history_to_rows(h)) for h in corpus]
    backend = TorchStepper(TSPEC, budget=2000, device="cpu")
    dev = backend.check_histories(TSPEC, mine)
    cpu = WingGongCPU(memo=True).check_histories(TSPEC, mine)
    assert (dev != 2).all(), "corpus should decide fully at default budgets"
    assert (dev == cpu).all()
    assert backend.rounds_run > 1
    assert backend.compactions >= 1
    np.testing.assert_array_equal(
        dev, JaxTPU(SPEC, budget=2000).check_histories(SPEC, corpus))


def test_dus_cache_write_matches_onehot():
    corpus = build_corpus(SPEC, (AtomicCasSUT, RacyCasSUT), n=32, n_pids=8,
                          max_ops=24, seed_base=77, seed_prefix="dus")
    n, args = _planes(corpus)
    out = {mode: _port(n, args, 100_000, 512, mode)
           for mode in ("dus", "onehot")}
    np.testing.assert_array_equal(out["dus"][0], out["onehot"][0])
    np.testing.assert_array_equal(out["dus"][1], out["onehot"][1])
    for mode in ("dus", "onehot"):
        rs, rit = _reference(n, args, 100_000, 512, mode)
        np.testing.assert_array_equal(out[mode][0], rs)
        np.testing.assert_array_equal(out[mode][1], rit)


def test_build_kernel_refuses_bad_arguments():
    with pytest.raises(ValueError, match="power of two"):
        build_kernel(TSPEC, 32, 100, cache_slots=3, device="cpu")
    with pytest.raises(ValueError, match="cache_write"):
        build_kernel(TSPEC, 32, 100, cache_write="scatter", device="cpu")
    from qsm_tpu_torch.ops.backend import BackendUnavailable

    import torch

    if not torch.cuda.is_available():
        with pytest.raises(BackendUnavailable):
            build_kernel(TSPEC, 32, 100)


def test_build_kernel_sweep_regime_matches_reference():
    """A spec without a scalar state bound is stepped in the sweep regime
    (the reference's build_kernel steps its vector state itself):
    ``(status, iters)`` equal lane for lane, memo on and off."""
    import jax

    from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec,
                                      RacyTwoPhaseQueueSUT)
    from qsm_tpu.ops.jax_kernel import build_kernel as j_build
    from qsm_tpu_torch.models.queue import QueueSpec as TQueue

    spec = QueueSpec(capacity=4)
    corpus = build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=8, n_pids=3, max_ops=10, seed_prefix="bkq")
    n = bucket_for(max(len(h) for h in corpus))
    enc = encode_batch(corpus, spec.initial_state(), max_ops=n)
    args = (enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
            enc.valid, enc.precedes(), enc.init_state)
    tspec = TQueue(capacity=4)
    for slots in (0, 64):
        s, it = build_kernel(tspec, n, 5_000, cache_slots=slots,
                             device="cpu")(*args)
        fn = jax.jit(jax.vmap(j_build(spec, n, budget=5_000,
                                      cache_slots=slots),
                              in_axes=(0, 0, 0, 0, 0, None)))
        rs, rit = fn(*args)
        np.testing.assert_array_equal(s, np.asarray(rs))
        np.testing.assert_array_equal(it, np.asarray(rit))
