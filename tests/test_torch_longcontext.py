"""Past the reference's scale in the port: 96- and 128-op histories.
Twins of ``tests/test_longcontext.py``, the port's ``TorchStepper`` (the
kernels' plain versions, the double-buffered tail forced on), ``SegDC``
and ``CppOracle`` against the JAX package's ``JaxTPU``, ``SegDC``,
``CppOracle`` and memo oracle on the same corpora: the buckets, CAS at 96
and 128 ops on the device stepper (``slow``, as in the reference) and in
the native oracle's 128-bit taken mask, and the queue at 96 ops through
the segmenting combinator, on the host and over the device stepper."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu.core.history import bucket_for as j_bucket_for
from qsm_tpu.models import AtomicCasSUT, CasSpec as JCas, QueueSpec as JQueue
from qsm_tpu.models import RacyCasSUT
from qsm_tpu.models.queue import AtomicQueueSUT, RacyTwoPhaseQueueSUT
from qsm_tpu.native import CppOracle as JCppOracle
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.segdc import SegDC as JSegDC
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JWingGongCPU
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.history import bucket_for
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.native import CppOracle
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.segdc import SegDC
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _cas(n, ops, prefix):
    jspec = JCas()
    hs = build_corpus(jspec, (AtomicCasSUT, RacyCasSUT), n=n, n_pids=8,
                      max_ops=ops, seed_base=1000 if ops == 96 else 2000,
                      seed_prefix=prefix)
    return jspec, CasSpec(), hs


def _device_parity(n, ops, prefix, share):
    """The port's stepper at ``JaxTPU``'s own plan, the tail forced on in
    both: verdicts equal the reference's; decided ones equal its memo
    oracle's on at least ``share`` of the corpus, violations among
    them."""
    jspec, spec, hs = _cas(n, ops, prefix)
    j = JaxTPU(jspec)
    j.DOUBLE_BUFFER = True
    jv = np.asarray(j.check_histories(jspec, hs))
    t = TorchStepper(spec, device="cpu", double_buffer=True,
                     chunk_schedule=j.CHUNK_SCHEDULE,
                     batch_buckets=j.BATCH_BUCKETS,
                     slots_for_batch={b: j._slots_for(b)
                                      for b in j.BATCH_BUCKETS})
    got = t.check_histories(spec, _port(hs))
    assert np.array_equal(got, jv)
    want = np.asarray(JWingGongCPU(memo=True).check_histories(jspec, hs))
    decided = got != int(Verdict.BUDGET_EXCEEDED)
    np.testing.assert_array_equal(got[decided], want[decided])
    assert decided.sum() >= share * len(hs)
    assert (want == int(Verdict.VIOLATION)).any()
    assert t.speculated_chunks == j.speculated_chunks
    assert t.wasted_chunks == j.wasted_chunks


@pytest.mark.parametrize("n", [1, 32, 33, 64, 65, 96, 97, 128])
def test_buckets_extend_past_reference_scale(n):
    assert bucket_for(n) == j_bucket_for(n)
    assert bucket_for(65) == 96
    assert bucket_for(97) == 128
    for f in (bucket_for, j_bucket_for):
        with pytest.raises(ValueError):
            f(129)


@pytest.mark.slow
def test_cas_96ops_device_parity():
    _device_parity(24, 96, "long", 0.8)


@pytest.mark.slow
def test_cas_128ops_device_parity():
    """The 128-op bucket: 4 taken words in the packed predecessors."""
    _device_parity(12, 128, "long128", 0.7)


def test_cas_128ops_native_parity():
    """The top bucket: 128-op histories fill the native oracle's whole
    128-bit taken mask."""
    jspec, spec, hs = _cas(16, 128, "long128")
    assert any(len(h) > 96 for h in hs)
    want = np.asarray(JWingGongCPU(memo=True).check_histories(jspec, hs))
    cpp = CppOracle(spec)
    got = cpp.check_histories(spec, _port(hs))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, JCppOracle(jspec).check_histories(jspec, hs))
    assert cpp.native_histories == len(hs) and cpp.fallback_histories == 0
    assert (want == int(Verdict.VIOLATION)).any()


def test_queue_96ops_segdc_and_native_fallback_parity():
    jspec, spec = JQueue(), QueueSpec()
    jhs = build_corpus(jspec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                       n=24, n_pids=8, max_ops=96, seed_base=1000,
                       seed_prefix="long")
    hs = _port(jhs)
    assert any(len(h) > 64 for h in hs)
    want = np.asarray(JWingGongCPU(memo=True).check_histories(jspec, jhs))

    seg = SegDC(spec)
    got = seg.check_histories(spec, hs)
    np.testing.assert_array_equal(got, want)
    jseg = JSegDC(jspec)
    np.testing.assert_array_equal(jseg.check_histories(jspec, jhs), want)
    assert seg.segments_split == jseg.segments_split > 0

    cpp = CppOracle(spec)
    np.testing.assert_array_equal(cpp.check_histories(spec, hs), want)
    # the 128-bit taken mask decides >64-op histories natively
    assert cpp.fallback_histories == 0
    assert cpp.native_histories == len(hs)


def test_queue_96ops_segdc_over_the_device_stepper():
    """The same corpus cut by ``SegDC`` over the port's device stepper
    (its final segments checked from every reachable state as lanes),
    the tail forced on: the oracle's verdicts."""
    jspec, spec = JQueue(), QueueSpec()
    jhs = build_corpus(jspec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                       n=24, n_pids=8, max_ops=96, seed_base=1000,
                       seed_prefix="long")
    want = np.asarray(JWingGongCPU(memo=True).check_histories(jspec, jhs))
    seg = SegDC(spec, make_inner=lambda s: TorchStepper(
        s, device="cpu", double_buffer=True))
    assert seg.device_final
    np.testing.assert_array_equal(seg.check_histories(spec, _port(jhs)),
                                  want)
    assert seg.segments_split > 0 and seg.inner.rounds_run > 0
