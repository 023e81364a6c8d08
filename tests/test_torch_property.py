"""The port's ``prop_concurrent`` against the JAX package's: the same seed
gives the same ``ok``, the same trials run, and the same shrunk
counterexample program and history, with the port's memo oracle and with
``TorchGPU(device="cpu")`` as the backend."""

from __future__ import annotations

import pytest

import qsm_tpu
from qsm_tpu.models import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.core.property import replay as t_replay
from qsm_tpu_torch.models.cas import AtomicCasSUT as TAtomic
from qsm_tpu_torch.models.cas import CasSpec as TCas
from qsm_tpu_torch.models.cas import RacyCasSUT as TRacy
from qsm_tpu_torch.ops.gpu_backend import TorchGPU
from qsm_tpu_torch.utils.interop import history_to_rows

CFG = dict(n_pids=4, max_ops=12, seed=3)


def _reference(impl, n_trials):
    spec = CasSpec()
    sut = {"racy": RacyCasSUT, "atomic": AtomicCasSUT}[impl](spec)
    return qsm_tpu.prop_concurrent(
        spec, sut, qsm_tpu.PropertyConfig(n_trials=n_trials, **CFG),
        oracle=JOracle(memo=True))


def _port(impl, n_trials, backend_name, **cfg_kw):
    spec = TCas()
    sut = {"racy": TRacy, "atomic": TAtomic}[impl](spec)
    backend = (TorchGPU(spec, device="cpu") if backend_name == "gpu"
               else None)
    return prop_concurrent(spec, sut,
                           PropertyConfig(n_trials=n_trials, **CFG,
                                          **cfg_kw),
                           backend=backend)


@pytest.mark.parametrize("backend_name", ["oracle", "gpu"])
def test_racy_cas_same_counterexample(backend_name):
    ref = _reference("racy", 100)
    got = _port("racy", 100, backend_name)
    assert not ref.ok and not got.ok
    assert got.trials_run == ref.trials_run
    rc, gc = ref.counterexample, got.counterexample
    assert gc.trial_seed == rc.trial_seed
    assert gc.shrink_steps == rc.shrink_steps
    assert [(o.pid, o.cmd, o.arg) for o in gc.program.ops] == \
        [(o.pid, o.cmd, o.arg) for o in rc.program.ops]
    assert history_to_rows(gc.history) == history_to_rows(rc.history)
    assert got.histories_checked == ref.histories_checked
    assert got.undecided == 0


@pytest.mark.parametrize("backend_name", ["oracle", "gpu"])
def test_atomic_cas_passes_like_reference(backend_name):
    ref = _reference("atomic", 25)
    got = _port("atomic", 25, backend_name)
    assert ref.ok and got.ok and bool(got)
    assert got.trials_run == ref.trials_run == 25
    assert got.distinct_histories == ref.distinct_histories


def test_trial_batch_does_not_change_the_counterexample():
    one = _port("racy", 100, "gpu")
    many = _port("racy", 100, "gpu", trial_batch=8)
    assert many.trials_run >= one.trials_run
    assert history_to_rows(many.counterexample.history) == \
        history_to_rows(one.counterexample.history)


def test_replay_reproduces_the_counterexample_history():
    res = _port("racy", 100, "oracle")
    cx = res.counterexample
    spec = TCas()
    again = t_replay(spec, TRacy(spec), cx.trial_seed,
                     PropertyConfig(n_trials=100, **CFG))
    ref = qsm_tpu.replay(CasSpec(), RacyCasSUT(CasSpec()), cx.trial_seed,
                         qsm_tpu.PropertyConfig(n_trials=100, **CFG))
    assert history_to_rows(again) == history_to_rows(ref)
