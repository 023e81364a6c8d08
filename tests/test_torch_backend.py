"""``TorchGPU(device="cpu")`` (the kernel's plain version) against the JAX
package's checkers: the same verdicts as ``PallasTPU`` (interpret),
``JaxTPU`` and the memo oracle, the same per-lane search as
``PallasTPU`` (every carry plane, ``iters`` and ``chosen`` included), and
the host contracts: honest budget, witnesses, pending expansion,
deferral, scope refusal, no silent CPU."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from qsm_tpu.core.history import History as JHistory
from qsm_tpu.models import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu.models.register import (AtomicRegisterSUT,
                                     RacyCachedRegisterSUT, RegisterSpec)
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.pallas_kernel import PallasTPU
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JOracle
from qsm_tpu.utils.corpus import build_corpus
from qsm_tpu_torch.models.cas import CasSpec as TCas
from qsm_tpu_torch.models.register import RegisterSpec as TRegister
from qsm_tpu_torch.ops import gpu_backend
from qsm_tpu_torch.ops.backend import BackendUnavailable, Verdict
from qsm_tpu_torch.ops.backend import verify_witness as t_verify_witness
from qsm_tpu_torch.ops.gpu_backend import TorchGPU
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU as TOracle
from qsm_tpu_torch.utils.cli import main as cli_main
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

TIGHT = dict(budget=4_000, mid_budget=0, rescue_budget=0)


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _pallas_run(spec, corpus):
    """PallasTPU verdicts plus the final carry of its last chunk call."""
    p = PallasTPU(spec, **TIGHT)
    build = p._chunk_kernel
    last = {}

    def capturing(n_ops, S):
        fn = build(n_ops, S)

        def run(*args):
            last["carry"] = fn(*args)
            return last["carry"]
        return run

    p._chunk_kernel = capturing
    v = np.asarray(p.check_histories(spec, corpus))
    return v, [np.asarray(x) for x in last["carry"]]


def _torch_run(tspec, corpus, monkeypatch):
    last = {}
    real = gpu_backend.dfs_chunk

    def capturing(*a, **kw):
        last["carry"] = real(*a, **kw)
        return last["carry"]

    monkeypatch.setattr(gpu_backend, "dfs_chunk", capturing)
    g = TorchGPU(tspec, device="cpu", **TIGHT)
    v = g.check_histories(tspec, _port(corpus))
    return g, v, [t.numpy() for t in last["carry"]]


@pytest.fixture(scope="module", params=["cas", "register"])
def corpus(request):
    if request.param == "cas":
        spec, tspec = CasSpec(), TCas()
        hs = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=16, n_pids=4,
                          max_ops=12, seed_base=77, seed_prefix="pal")
    else:
        spec, tspec = RegisterSpec(), TRegister()
        hs = build_corpus(spec, (lambda s: AtomicRegisterSUT(),
                                 lambda s: RacyCachedRegisterSUT()),
                          n=16, n_pids=3, max_ops=12, seed_base=21,
                          seed_prefix="reg")
    pv, pcarry = _pallas_run(spec, hs)
    return spec, tspec, hs, pv, pcarry


def test_verdicts_match_pallas_jax_and_oracle(corpus, monkeypatch):
    spec, tspec, hs, pv, _ = corpus
    _, tv, _ = _torch_run(tspec, hs, monkeypatch)
    jv = np.asarray(JaxTPU(spec, **TIGHT).check_histories(spec, hs))
    mv = np.asarray(JOracle(memo=True).check_histories(spec, hs))
    ov = TOracle(memo=True).check_histories(tspec, _port(hs))
    assert tv.tolist() == pv.tolist() == jv.tolist() == mv.tolist() \
        == ov.tolist()
    assert Verdict.VIOLATION in tv and Verdict.LINEARIZABLE in tv


def test_per_lane_search_matches_pallas(corpus, monkeypatch):
    """Same lanes, same chunk schedule: every plane of the final carry
    (taken, chosen, states, depth/status/iters, memo) is identical."""
    _, tspec, hs, _, pcarry = corpus
    g, _, tcarry = _torch_run(tspec, hs, monkeypatch)
    names = ("taken", "chosen", "states", "dsi", "ck0", "ck1", "occ")
    for name, a, b in zip(names, pcarry, tcarry):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert g.device_histories == len(hs) and g.chunk_launches >= 1
    assert g.lockstep_cost == g.chunk_launches * g.CHUNK * g.LANES


def test_budget_is_honest(corpus):
    spec, tspec, hs, _, _ = corpus
    g = TorchGPU(tspec, device="cpu", budget=3, mid_budget=0,
                 rescue_budget=0)
    g.CHUNK = 4
    tv = g.check_histories(tspec, _port(hs))
    mv = np.asarray(JOracle(memo=True).check_histories(spec, hs))
    both = (tv != 2) & (mv != 2)
    assert int(((tv != mv) & both).sum()) == 0
    assert int((tv == 2).sum()) > 0  # some lanes must hit the budget


def test_batches_split_past_max_batch(corpus):
    _, tspec, hs, pv, _ = corpus
    g = TorchGPU(tspec, device="cpu", **TIGHT)
    g.MAX_BATCH = 5
    assert g.check_histories(tspec, _port(hs)).tolist() == pv.tolist()
    assert g.device_histories == len(hs)


def test_witnesses_replay_in_both_packages(corpus):
    spec, tspec, hs, pv, _ = corpus
    g = TorchGPU(tspec, device="cpu", **TIGHT)
    seen = 0
    for h, v in zip(hs, pv):
        th = _port([h])[0]
        tv, wit = g.check_witness(tspec, th)
        assert int(tv) == int(v)
        if tv == Verdict.LINEARIZABLE:
            assert t_verify_witness(tspec, th, wit)
            assert j_verify_witness(spec, h, wit)
            seen += 1
        else:
            assert wit is None
    assert seen > 0


def test_pending_ops_route_through_expansion(corpus):
    spec, tspec, hs, _, _ = corpus
    base = max(hs, key=len)
    ops = list(base.ops)
    last = max(range(len(ops)), key=lambda i: ops[i].response_time)
    ops[last] = dataclasses.replace(ops[last], resp=-1,
                                    response_time=1 << 30)
    jh = JHistory(ops)
    th = _port([jh])[0]
    g = TorchGPU(tspec, device="cpu", **TIGHT)
    tv = g.check_histories(tspec, [th])
    assert tv.tolist() == JOracle(memo=True).check_histories(
        spec, [jh]).tolist()
    assert g.device_histories == len(spec.resp_domain(ops[last].cmd)) + 1
    # a witness is not read for a pending history
    assert g.check_witness(tspec, th)[1] is None
    # past max_expansions the history is deferred, not guessed
    small = TorchGPU(tspec, device="cpu", max_expansions=1, **TIGHT)
    assert small.check_histories(tspec, [th]).tolist() == [2]


def test_check_from_matches_oracle():
    tspec = TCas()
    hs = _port(build_corpus(CasSpec(), (AtomicCasSUT, RacyCasSUT), n=8,
                            n_pids=3, max_ops=10, seed_base=9))
    g = TorchGPU(tspec, device="cpu", **TIGHT)
    o = TOracle(memo=True)
    for h in hs:
        for s in (0, 2, 4):
            assert g.check_from(tspec, h, [s]) == o.check_from(tspec, h, [s])


def test_out_of_domain_args_are_deferred():
    tspec = TCas()
    h = history_from_rows([[0, 1, 9, 0, 1, 2], [1, 0, 0, 9, 3, 4]])
    g = TorchGPU(tspec, device="cpu")
    assert g.check_histories(tspec, [h]).tolist() == [2]
    assert g.deferred_out_of_domain == 1 and g.device_histories == 0


def test_unsupported_specs_are_refused():
    with pytest.raises(ValueError, match="state bound"):
        TorchGPU(TCas(n_values=65), device="cpu")
    with pytest.raises(ValueError, match="one per spec"):
        TorchGPU(TCas(), device="cpu").check_histories(TCas(), [])


def test_no_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        TorchGPU(TCas())
    with pytest.raises(BackendUnavailable):
        cli_main(["run", "--model", "cas", "--backend", "gpu",
                  "--trials", "1"])


def test_cli_run_and_bench_on_cpu(capsys):
    rc = cli_main(["run", "--model", "cas", "--impl", "racy", "--backend",
                   "gpu", "--device", "cpu", "--trials", "30", "--pids",
                   "4", "--ops", "12"])
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL: cas/racy" in out
    rc = cli_main(["bench", "--model", "register", "--backend", "gpu",
                   "--device", "cpu", "--corpus", "8", "--pids", "2",
                   "--ops", "8"])
    assert rc == 0 and '"undecided": 0' in capsys.readouterr().out
