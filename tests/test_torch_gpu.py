"""On the card only (marker ``gpu``; run with ``pytest --noconftest -m gpu
tests/test_torch_gpu.py`` on a machine with an H100): the CUDA kernel
against its plain version, bit for bit, and the checker at 256 lanes
against the memo oracle.  Without CUDA each test skips in its fixture."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.ops.backend import Verdict, verify_witness
from qsm_tpu_torch.ops.dfs_kernel import dfs_chunk, dfs_chunk_plain
from qsm_tpu_torch.ops.gpu_backend import TorchGPU, fresh_carry, lane_tables
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.corpus import build_corpus

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corpus():
    spec = CasSpec()
    return spec, build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=256,
                              n_pids=8, max_ops=32, seed_base=1000,
                              seed_prefix="bench")


@pytest.mark.parametrize("cs", [0, 64])
def test_kernel_matches_plain_version(cuda, corpus, cs):
    spec, hs = corpus
    tabs = lane_tables(spec, hs, 32, 256, cuda)
    carry = fresh_carry(tabs.nreq, np.zeros(len(hs), np.int32), 32, cs)
    for _ in range(2):
        before = dfs_chunk.launches
        got = dfs_chunk(tabs, carry, chunk=256, budget=552_000,
                        cache_slots=cs)
        torch.cuda.synchronize()
        assert dfs_chunk.launches == before + 1
        want = dfs_chunk_plain(tabs, carry, chunk=256, budget=552_000,
                               cache_slots=cs)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        carry = got


def test_checker_matches_oracle_at_256_lanes(cuda, corpus):
    spec, hs = corpus
    g = TorchGPU(spec)
    before = dfs_chunk.launches
    gv = g.check_histories(spec, hs)
    assert dfs_chunk.launches > before and g.chunk_launches > 0
    ov = WingGongCPU(memo=True).check_histories(spec, hs)
    both = (gv != 2) & (ov != 2)
    assert int(((gv != ov) & both).sum()) == 0
    lin = [h for h, v in zip(hs, gv) if v == Verdict.LINEARIZABLE][:16]
    for h in lin:
        v, wit = g.check_witness(spec, h)
        assert v == Verdict.LINEARIZABLE and verify_witness(spec, h, wit)
