"""The port's hybrid device and host plan against the JAX package's, on
the CPU (``TorchStepper`` runs its kernels' plain versions): verdicts
equal to the oracle's, the same lanes deferred to the tail as the
reference's ``HybridDevice`` (its ``JaxTPU`` runs the same per-lane
search), witnesses from either side, and the degrade path: on the CPU
a device error moves the batch to the tail, on the card it raises, and
a kernel that fails to build raises on either."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu.models import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu.models.queue import (AtomicQueueSUT, QueueSpec,
                                  RacyTwoPhaseQueueSUT)
from qsm_tpu.ops.hybrid import HybridDevice as JHybrid
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.core.history import overlapping_history
from qsm_tpu_torch.models.cas import CasSpec as TCas
from qsm_tpu_torch.models.queue import QueueSpec as TQueue
from qsm_tpu_torch.models.register import RegisterSpec
from qsm_tpu_torch.native import CppOracle
from qsm_tpu_torch.ops.backend import (BackendUnavailable, Verdict,
                                       verify_witness)
from qsm_tpu_torch.ops.hybrid import HybridDevice
from qsm_tpu_torch.ops.kernels import KernelBuildError
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.cli import main as cli_main
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

CPU = dict(device="cpu")


def _corpus(n=24, ops=24):
    return build_corpus(CasSpec(), (AtomicCasSUT, RacyCasSUT), n=n,
                        n_pids=4, max_ops=ops, seed_base=77,
                        seed_prefix="hybrid")


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def test_parity_with_oracle_and_tail_traffic():
    spec = TCas()
    corpus = _port(_corpus())
    want = WingGongCPU(memo=True).check_histories(spec, corpus)
    # budget 1 defers essentially every lane: the tail decides
    hb = HybridDevice(spec, budget=1, **CPU)
    got = hb.check_histories(spec, corpus)
    np.testing.assert_array_equal(got, want)
    assert hb.tail_histories > 0
    assert hb.tail_histories + hb.device_decided == len(corpus)


def test_device_decides_majority_under_real_budget():
    spec = TCas()
    corpus = _port(_corpus())
    want = WingGongCPU(memo=True).check_histories(spec, corpus)
    hb = HybridDevice(spec, budget=2_000, **CPU)
    np.testing.assert_array_equal(hb.check_histories(spec, corpus), want)
    assert hb.device_decided > 0


def test_no_budget_exceeded_leaks_with_exact_tail():
    spec = TCas()
    hb = HybridDevice(spec, budget=1, **CPU)
    got = hb.check_histories(spec, _port(_corpus()))
    assert not (got == int(Verdict.BUDGET_EXCEEDED)).any()


def test_witness_delegation_both_sides():
    spec = RegisterSpec(n_values=4)
    ok = overlapping_history([(0, 1, 3, 0, 0, 1), (1, 0, 0, 3, 2, 3)])
    for budget in (2_000, 1):  # the device side, then the tail side
        hb = HybridDevice(spec, budget=budget, **CPU)
        v, order = hb.check_witness(spec, ok)
        assert v == Verdict.LINEARIZABLE
        assert verify_witness(spec, ok, order)


@pytest.mark.parametrize("budget", [1, 50, 2_000])
def test_counters_equal_to_reference_cas(budget):
    """The same lanes deferred: the same ``tail_histories`` and
    ``device_decided`` as the reference's HybridDevice."""
    jspec, tspec = CasSpec(), TCas()
    corpus = _corpus()
    ref = JHybrid(jspec, budget=budget)
    want = ref.check_histories(jspec, corpus)
    hb = HybridDevice(tspec, budget=budget, **CPU)
    got = hb.check_histories(tspec, _port(corpus))
    np.testing.assert_array_equal(got, want)
    assert (hb.tail_histories, hb.device_decided) == \
        (ref.tail_histories, ref.device_decided)
    assert hb.resilience() == ref.resilience()


def test_counters_equal_to_reference_queue():
    jspec, tspec = QueueSpec(), TQueue()
    corpus = build_corpus(jspec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                          n=16, n_pids=4, max_ops=16, seed_base=3,
                          seed_prefix="hq")
    ref = JHybrid(jspec, budget=50)
    want = ref.check_histories(jspec, corpus)
    hb = HybridDevice(tspec, budget=50, **CPU)
    got = hb.check_histories(tspec, _port(corpus))
    np.testing.assert_array_equal(got, want)
    assert (hb.tail_histories, hb.device_decided) == \
        (ref.tail_histories, ref.device_decided)
    assert hb.tail_histories > 0 and hb.device_decided > 0
    assert isinstance(hb.tail, CppOracle)


def test_device_error_degrades_to_the_tail(monkeypatch):
    spec = TCas()
    corpus = _port(_corpus())
    want = WingGongCPU(memo=True).check_histories(spec, corpus)
    hb = HybridDevice(spec, **CPU)

    def lost(*a, **kw):
        raise BackendUnavailable("card lost")

    monkeypatch.setattr(hb.device, "check_histories", lost)
    np.testing.assert_array_equal(hb.check_histories(spec, corpus), want)
    assert hb.degraded and hb.degradations == 1
    assert hb.fallback_engine == hb.tail.name
    assert hb.last_error == "BackendUnavailable: card lost"
    assert (hb.device_decided, hb.tail_histories) == (0, len(corpus))
    # later batches go straight to the tail: no second degrade
    np.testing.assert_array_equal(hb.check_histories(spec, corpus), want)
    assert hb.degradations == 1
    r = hb.resilience()
    assert r["degradations"] == 1 and r["fallback_histories"] == \
        2 * len(corpus) and r["last_error"] == hb.last_error
    v, w = hb.check_witness(spec, corpus[0])
    assert v == want[0]


def test_witness_degrades_on_device_error(monkeypatch):
    spec = RegisterSpec(n_values=4)
    ok = overlapping_history([(0, 1, 3, 0, 0, 1), (1, 0, 0, 3, 2, 3)])
    hb = HybridDevice(spec, **CPU)

    def lost(*a, **kw):
        raise BackendUnavailable("card lost")

    monkeypatch.setattr(hb.device, "check_histories", lost)
    v, order = hb.check_witness(spec, ok)
    assert v == Verdict.LINEARIZABLE and verify_witness(spec, ok, order)
    assert hb.degradations == 1


@pytest.mark.parametrize("entry", ["check_histories", "check_witness"])
def test_device_error_on_the_card_is_not_caught(monkeypatch, entry):
    """A plan whose device is CUDA never moves work to the host on a
    device error: the error raises and nothing records a degrade."""
    import torch

    spec = TCas()
    corpus = _port(_corpus(n=2))
    hb = HybridDevice(spec, **CPU)
    monkeypatch.setattr(hb.device, "device", torch.device("cuda", 0))

    def lost(*a, **kw):
        raise BackendUnavailable("card lost")

    monkeypatch.setattr(hb.device, "check_histories", lost)
    with pytest.raises(BackendUnavailable, match="card lost"):
        if entry == "check_histories":
            hb.check_histories(spec, corpus)
        else:
            hb.check_witness(spec, corpus[0])
    assert not hb.degraded and hb.degradations == 0
    assert (hb.device_decided, hb.tail_histories) == (0, 0)
    assert hb.resilience()["fallback_engine"] is None


def test_kernel_build_error_is_not_caught(monkeypatch):
    spec = TCas()
    hb = HybridDevice(spec, **CPU)

    def broken(*a, **kw):
        raise KernelBuildError("nvcc refused the source")

    monkeypatch.setattr(hb.device, "check_histories", broken)
    with pytest.raises(KernelBuildError):
        hb.check_histories(spec, _port(_corpus(n=2)))
    assert not hb.degraded and hb.degradations == 0


def test_no_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        HybridDevice(TCas())


@pytest.mark.parametrize("backend,model,rc", [
    ("hybrid-stepper", "cas", 1),
    ("pcomp-stepper", "kv", 1),
    ("pcomp", "multireg", 1),
    ("pcomp-cpp", "kv", 1),
    ("cpp", "queue", 1),
    ("auto", "register", 1),
])
def test_cli_backends_on_cpu(backend, model, rc, capsys):
    got = cli_main(["run", "--model", model, "--impl", "racy", "--backend",
                    backend, "--device", "cpu", "--trials", "30", "--pids",
                    "3", "--ops", "10"])
    assert got == rc, capsys.readouterr().out
    assert f"FAIL: {model}/racy" in capsys.readouterr().out


def test_cli_refuses_a_spec_that_does_not_decompose(capsys):
    with pytest.raises(SystemExit, match="not per-key decomposable"):
        cli_main(["run", "--model", "cas", "--backend", "pcomp",
                  "--trials", "1"])


def test_cli_bench_names_the_device_of_a_combinator(capsys):
    rc = cli_main(["bench", "--model", "kv", "--backend", "pcomp-stepper",
                   "--device", "cpu", "--corpus", "6", "--pids", "4",
                   "--ops", "12"])
    out = capsys.readouterr().out
    assert rc == 0 and '"device": "cpu"' in out and '"undecided": 0' in out
