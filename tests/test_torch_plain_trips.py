"""The plain versions without their early exit (``early_exit=False``, the
form ``chip_smoke.py`` captures in a CUDA graph on the card): a trip after
every lane has decided is a no-op, so a chunk run without the exit, or as
chunks of 64 trips, leaves the carry the exit leaves, plane for plane."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qsm_tpu_torch.core.history import encode_batch
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from qsm_tpu_torch.ops.dfs_kernel import RUNNING, dfs_chunk_plain
from qsm_tpu_torch.ops.gpu_backend import fresh_carry, lane_tables
from qsm_tpu_torch.ops.stepper_kernel import (fresh_stepper_carry,
                                              stepper_chunk_plain,
                                              stepper_tables)
from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry,
                                            stepper_sweep_plain,
                                            sweep_tables)
from qsm_tpu_torch.utils.corpus import build_corpus

N_OPS, LANES, CHUNK = 16, 24, 320


def _planes(spec, suts):
    hs = build_corpus(spec, suts, n=LANES, n_pids=4, max_ops=N_OPS,
                      seed_base=7, seed_prefix="trips")
    enc = encode_batch(hs, spec.initial_state(), max_ops=N_OPS)
    return hs, enc, (enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
                     enc.valid, enc.precedes())


def _cases():
    cas = CasSpec()
    hs, enc, planes = _planes(cas, (AtomicCasSUT, RacyCasSUT))
    tabs = stepper_tables(cas, *planes, "cpu")
    start = np.full(LANES, int(enc.init_state[0]), np.int32)
    yield "stepper_chunk", (
        lambda: fresh_stepper_carry(tabs.nreq, np.arange(LANES), start,
                                    LANES, N_OPS, 64),
        lambda c, **kw: stepper_chunk_plain(tabs, c, budget=10**6, **kw))
    dtabs = lane_tables(cas, hs, N_OPS, LANES, "cpu")
    yield "dfs_chunk", (
        lambda: fresh_carry(dtabs.nreq, np.zeros(LANES, np.int32), N_OPS, 64),
        lambda c, **kw: dfs_chunk_plain(dtabs, c, budget=10**6,
                                        cache_slots=64, **kw))
    kv = KvSpec(n_keys=3, n_values=3)
    _, kenc, kplanes = _planes(kv, (AtomicKvSUT, StaleCacheKvSUT))
    stabs = sweep_tables(*kplanes, "cpu")
    kstart = np.tile(np.asarray(kenc.init_state, np.int32), (LANES, 1))
    yield "stepper_sweep", (
        lambda: fresh_sweep_carry(stabs.nreq, np.arange(LANES), kstart,
                                  LANES, N_OPS, 64),
        lambda c, **kw: stepper_sweep_plain(kv, stabs, c, budget=10**6,
                                            **kw))


CASES = dict(_cases())


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_early_exit_and_64_trip_chunks_leave_the_same_carry(name):
    fresh, plain = CASES[name]
    want = plain(fresh(), chunk=CHUNK)
    got = plain(fresh(), chunk=CHUNK, early_exit=False)
    trips = fresh()
    for _ in range(CHUNK // 64):
        trips = plain(trips, chunk=64, early_exit=False)
    # every lane decided well inside the chunk: the exit was taken
    assert not bool((want.dsi[1] == RUNNING).any())
    for plane, a, b, c in zip(type(want)._fields, want, got, trips):
        assert torch.equal(a, b) and torch.equal(a, c), plane
