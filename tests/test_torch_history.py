"""Port host layers against the JAX package: encoding, precedence,
buckets, the deterministic scheduler (row-identical corpora, also under
faults), program generation and shrinking."""

from __future__ import annotations

import numpy as np
import pytest

import qsm_tpu.core.generator as jgen
import qsm_tpu.core.history as jhist
import qsm_tpu.models.cas as jcas
import qsm_tpu.models.register as jreg
from qsm_tpu.sched.runner import run_concurrent as j_run
from qsm_tpu.sched.scheduler import FaultPlan as JFaultPlan
from qsm_tpu.utils.corpus import build_corpus as j_build_corpus
from qsm_tpu_torch.core import generator as tgen
from qsm_tpu_torch.core import history as thist
from qsm_tpu_torch.models import cas as tcas
from qsm_tpu_torch.models import register as treg
from qsm_tpu_torch.sched.runner import run_concurrent as t_run
from qsm_tpu_torch.sched.scheduler import FaultPlan as TFaultPlan
from qsm_tpu_torch.utils.corpus import build_corpus as t_build_corpus
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows

CORPORA = [
    pytest.param(jcas.CasSpec, tcas.CasSpec,
                 ("AtomicCasSUT", "RacyCasSUT"), 8, 32, id="cas-8x32"),
    pytest.param(jreg.RegisterSpec, treg.RegisterSpec,
                 ("AtomicRegisterSUT", "RacyCachedRegisterSUT",
                  "ReplicatedRegisterSUT"), 3, 12, id="register-3x12"),
]


def _suts(mod, names):
    out = []
    for n in names:
        cls = getattr(mod, n)
        out.append(cls if "Cas" in n else (lambda spec, c=cls: c()))
    return out


@pytest.mark.parametrize("jspec_cls,tspec_cls,suts,pids,ops", CORPORA)
def test_build_corpus_is_row_identical(jspec_cls, tspec_cls, suts, pids,
                                       ops):
    jmod = jcas if jspec_cls is jcas.CasSpec else jreg
    tmod = tcas if tspec_cls is tcas.CasSpec else treg
    kw = dict(n=24, n_pids=pids, max_ops=ops, seed_base=1000,
              seed_prefix="bench", complete=False)
    jc = j_build_corpus(jspec_cls(), _suts(jmod, suts), **kw)
    tc = t_build_corpus(tspec_cls(), _suts(tmod, suts), **kw)
    assert [history_to_rows(h) for h in jc] == \
        [history_to_rows(h) for h in tc]
    assert [h.seed for h in jc] == [h.seed for h in tc]


def test_faulty_schedules_are_row_identical():
    """Drops, duplicates, delays and a crash consume the scheduler's RNG
    the same way in both packages."""
    jspec, tspec = jcas.CasSpec(), tcas.CasSpec()
    plan = dict(p_drop=0.1, p_duplicate=0.05, p_delay=0.1, delay_steps=2,
                crash_at={"client:1": 5})
    for seed in range(12):
        jp = jgen.generate_program(jspec, seed=seed, n_pids=4, max_ops=16)
        tp = tgen.generate_program(tspec, seed=seed, n_pids=4, max_ops=16)
        jh = j_run(jcas.RacyCasSUT(jspec), jp, seed=f"f:{seed}",
                   faults=JFaultPlan(**plan))
        th = t_run(tcas.RacyCasSUT(tspec), tp, seed=f"f:{seed}",
                   faults=TFaultPlan(**plan))
        assert history_to_rows(jh) == history_to_rows(th)


def _pending_corpus():
    jspec = jcas.CasSpec()
    hs = j_build_corpus(jspec, (jcas.AtomicCasSUT, jcas.RacyCasSUT), n=10,
                        n_pids=4, max_ops=20, seed_base=5)
    rows = [history_to_rows(h) for h in hs]
    for k, r in enumerate(rows):
        if r and k % 3 == 0:  # cut the last response: a pending op
            last = max(range(len(r)), key=lambda i: r[i][5])
            r[last][3], r[last][5] = -1, 1 << 30
    return rows


@pytest.mark.parametrize("max_ops", [None, 24, 32])
def test_encode_batch_and_precedes_match(max_ops):
    rows = _pending_corpus()
    init = np.zeros(1, np.int32)
    je = jhist.encode_batch([jhist.History([jhist.Op(*o) for o in r])
                             for r in rows], init, max_ops=max_ops)
    te = thist.encode_batch([history_from_rows(r) for r in rows], init,
                            max_ops=max_ops)
    for f in ("ops", "interval", "valid", "pending", "init_state"):
        np.testing.assert_array_equal(getattr(je, f), getattr(te, f))
    np.testing.assert_array_equal(je.precedes(), te.precedes())
    for r in rows:
        np.testing.assert_array_equal(
            jhist.History([jhist.Op(*o) for o in r]).precedes_matrix(),
            history_from_rows(r).precedes_matrix())


def test_bucket_for_matches():
    for n in range(1, 129):
        assert thist.bucket_for(n) == jhist.bucket_for(n)
    with pytest.raises(ValueError):
        thist.bucket_for(129)


def test_history_helpers_match():
    rows = _pending_corpus()[0]
    jh = jhist.History([jhist.Op(*o) for o in rows])
    th = history_from_rows(rows)
    assert jh.fingerprint() == th.fingerprint()
    assert history_to_rows(jh.completed()) == history_to_rows(th.completed())
    assert jh.n_pending == th.n_pending
    spans = [(0, 1, 3, 0, 0, 4), (1, 0, 0, 3, 1, 2)]
    assert (history_to_rows(jhist.overlapping_history(spans))
            == history_to_rows(thist.overlapping_history(spans)))


@pytest.mark.parametrize("seed", range(6))
def test_generate_and_shrink_match(seed):
    for jspec, tspec in ((jcas.CasSpec(), tcas.CasSpec()),
                         (jreg.RegisterSpec(), treg.RegisterSpec())):
        jp = jgen.generate_program(jspec, seed=seed, n_pids=4, max_ops=24)
        tp = tgen.generate_program(tspec, seed=seed, n_pids=4, max_ops=24)
        as_rows = lambda p: [(o.pid, o.cmd, o.arg) for o in p.ops]  # noqa: E731
        assert as_rows(jp) == as_rows(tp) and jp.n_pids == tp.n_pids
        jc = jgen.dedupe(jgen.shrink_candidates(jspec, jp), 500)
        tc = tgen.dedupe(tgen.shrink_candidates(tspec, tp), 500)
        assert [as_rows(p) for p in jc] == [as_rows(p) for p in tc]
