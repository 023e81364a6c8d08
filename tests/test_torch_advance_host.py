"""The CUDA source of ``sweep_advance`` (the sweep regime's generic route)
compiled for the host and held against ``sweep_advance_plain``, bit for
bit on every carry plane and on the next states it writes, trip after
trip, on the CPU.

``sweep_advance.cu``'s threads meet at warp ballots and a ``__syncwarp``,
so it runs under ``tests/cuda_host/cuda_warp.h`` (each block's threads as
host threads, every vote and barrier a meeting point) with its ``<<<>>>``
launch rewritten, compiled with the host C++ compiler and called through
ctypes on CPU tensors.  Each trip's step planes come from the spec's own
``step_torch`` (``sweep_generic.step_planes``), as on the card.  Specs
without a kernel model (a KV map, a queue, a random vector spec, the
unbounded ticket dispenser of one state word) and KV maps wider than the
sweep kernel's 28 words (32 and 40 keys: key and state words past one
stride of 32 threads), at one to four taken words, memo off, on and tiny,
one and several warps a block, a lane list.  Mutants of the source that
must fail: a state word left out of the memo hash, the cursor compared
with >=, the taken words left out of the key compare, a backtrack that
does not untake its op."""

from __future__ import annotations

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qsm_tpu_torch.core.history import encode_batch
from qsm_tpu_torch.core.spec import without_sweep_kernel
from qsm_tpu_torch.models.counter import (AtomicTicketSUT, RacyTicketSUT,
                                          TicketSpec)
from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                        RacyTwoPhaseQueueSUT)
from qsm_tpu_torch.ops.dfs_kernel import H100_SMS
from qsm_tpu_torch.ops.kernels import CSRC_DIR
from qsm_tpu_torch.ops.stepper_kernel import (RUNNING, STATUS, StepperCarry,
                                              n_words)
from qsm_tpu_torch.ops.sweep_generic import (AdvancePlan,
                                             advance_launch_plan,
                                             step_planes,
                                             sweep_advance_plain)
from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry, sweep_model,
                                            sweep_tables)
from qsm_tpu_torch.utils.corpus import build_corpus
from qsm_tpu_torch.utils.fuzz import RandomVectorSpec, random_history

SHIM = Path(__file__).resolve().parent / "cuda_host"
LANES = 16
TRIPS = 40
BUDGET = 552_000
_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = ("sweep_advance_kernel<<<grid, warps * WARP, 0,\n"
           "                         static_cast<cudaStream_t>(stream)>>>"
           "(a);")
_HOST_LAUNCH = "host_launch_threads(sweep_advance_kernel, grid, " \
               "warps * WARP, 0, a);"


KvNoKind = without_sweep_kernel(KvSpec)
QueueNoKind = without_sweep_kernel(QueueSpec)
RandomNoKind = without_sweep_kernel(RandomVectorSpec)


class UnboundedTicket(TicketSpec):
    def scalar_state_bound(self, n_ops):
        return None


SPECS = {
    "kv9": (lambda: KvNoKind(n_keys=9), (AtomicKvSUT, StaleCacheKvSUT)),
    "kv32": (lambda: KvSpec(n_keys=32), (AtomicKvSUT, StaleCacheKvSUT)),
    "kv40": (lambda: KvSpec(n_keys=40), (AtomicKvSUT, StaleCacheKvSUT)),
    "queue8": (lambda: QueueNoKind(capacity=8),
               (AtomicQueueSUT, RacyTwoPhaseQueueSUT)),
    "random9": (lambda: RandomNoKind(5, bounds=(4, 3, 5, 4, 4, 3, 4, 4, 6)),
                None),
    "ticket": (lambda: UnboundedTicket(), (lambda s: AtomicTicketSUT(),
                                           lambda s: RacyTicketSUT())),
}

# the mutants: (name, the text replaced, its replacement)
MUTANTS = [
    ("a state word left out of the memo hash",
     "for (int i = 0; i < D; ++i) h = mix(",
     "for (int i = 0; i < D - 1; ++i) h = mix("),
    ("the cursor compared with >=",
     "op > cur &&", "op >= cur &&"),
    ("the taken words left out of the key compare",
     "for (int q = lane; q < kw; q += WARP)\n      eq = eq",
     "for (int q = lane + W; q < kw; q += WARP)\n      eq = eq"),
    ("a backtrack that does not untake its op",
     "a.taken[prev * LB + b] = 0;", "a.taken[prev * LB + b] = 1;"),
]


def _host_lib(tmp: Path, src: str = None, tag: str = ""):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = src if src is not None else (
        CSRC_DIR / "sweep_advance.cu").read_text()
    assert src.count(_LAUNCH) == 1, "sweep_advance.cu changed its launch"
    cpp = tmp / f"sweep_advance{tag}.cpp"
    cpp.write_text(src.replace(_LAUNCH, _HOST_LAUNCH))
    lib = tmp / f"sweep_advance{tag}.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{SHIM}", "-include", "cuda_warp.h", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).sweep_advance_launch
    fn.argtypes = [_P] * 14 + [_I] * 10 + [_P]
    fn.restype = _I
    return fn


@pytest.fixture(scope="module")
def host_fn(tmp_path_factory):
    return _host_lib(tmp_path_factory.mktemp("advance_host"))


# pids a history (more pids, more overlap: backtracks and memo hits)
PIDS = {"kv40": 12}


def _inputs(name: str, n_ops: int):
    pids = PIDS.get(name, 8)
    make, suts = SPECS[name]
    spec = make()
    if suts is None:
        rng = random.Random(f"advance-host:{name}")
        hs = [random_history(spec, rng, pids, n_ops) for _ in range(LANES)]
    else:
        hs = build_corpus(spec, suts, n=LANES, n_pids=pids, max_ops=n_ops,
                          seed_base=31, seed_prefix="advance-host")
    enc = encode_batch(hs, spec.initial_state())
    tabs = sweep_tables(*(enc.ops[:, :, k] for k in (1, 2, 3)), enc.valid,
                        enc.precedes(), "cpu")
    starts = np.tile(np.asarray(enc.init_state, np.int32), (LANES, 1))
    return spec, tabs, starts


def _launch(fn, tabs, carry, lanes, nxt, ok, state, plan) -> int:
    R, N = tabs.cmd.shape
    B, D = carry.row.shape[0], carry.states.shape[2]
    return fn(tabs.prec.data_ptr(), tabs.valid.data_ptr(),
              tabs.nreq.data_ptr(), carry.row.data_ptr(), lanes.data_ptr(),
              nxt.data_ptr(), ok.data_ptr(),
              *(t.data_ptr() for t in carry[:6]), state.data_ptr(),
              B, R, N, n_words(N), D, carry.occ.shape[1], BUDGET,
              lanes.numel(), *plan, None)


def _clone(c: StepperCarry) -> StepperCarry:
    return StepperCarry(*(t.clone() for t in c))


def _diff(got: StepperCarry, want: StepperCarry):
    return [name for name, a, b in zip(StepperCarry._fields, got, want)
            if not torch.equal(a, b)]


def _run_both(fn, name, n_ops, slots, warps=0, trips=TRIPS, listed=False):
    """Both versions trip after trip from a fresh carry (lanes reading
    permuted rows); the planes that differ (empty: equal) and the final
    carry."""
    spec, tabs, starts = _inputs(name, n_ops)
    N = tabs.cmd.shape[1]
    rows = np.random.default_rng(3).permutation(LANES)
    carry = fresh_sweep_carry(tabs.nreq, rows, starts[rows], LANES, N, slots)
    for t in range(trips):
        pick = np.arange(LANES)
        if listed:
            # the running lanes in another order, beside a decided one
            st = carry.dsi[STATUS].numpy()
            pick = np.concatenate([np.flatnonzero(st == RUNNING)[::-1],
                                   np.flatnonzero(st != RUNNING)[:1]])
        lanes = torch.from_numpy(pick.astype(np.int32))
        idx = lanes.long()
        L = idx.numel()
        plan = (advance_launch_plan(L, H100_SMS) if not warps else
                AdvancePlan(warps, -(-L // warps)))
        row = carry.row[idx].long()
        state = carry.states[idx, carry.dsi[0, idx].long()]
        nxt, ok = step_planes(spec, state, *(x[row] for x in tabs[:3]))
        got, want = _clone(carry), _clone(carry)
        s_got, s_want = state.clone(), state.clone()
        assert _launch(fn, tabs, got, lanes, nxt, ok, s_got, plan) == 0
        sweep_advance_plain(tabs, want, lanes, nxt, ok, budget=BUDGET,
                            state_out=s_want)
        bad = _diff(got, want) + ([] if torch.equal(s_got, s_want)
                                  else ["state_out"])
        if bad:
            return bad, got
        # the next states written are each lane's current one
        assert torch.equal(s_got, got.states[idx, got.dsi[0, idx].long()])
        carry = got
    return [], carry


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("name,n_ops", [
    ("kv9", 24), ("kv9", 48), ("kv9", 96), ("kv32", 24), ("kv40", 40),
    ("queue8", 24), ("random9", 40), ("ticket", 12)])
def test_advance_source_matches_plain(host_fn, name, n_ops, slots):
    bad, carry = _run_both(host_fn, name, n_ops, slots)
    assert bad == [], f"{bad} differ"
    assert int(carry.dsi[2].sum()) > 0
    if slots:
        assert int((carry.occ == 1).sum()) > 0  # the memo was exercised


def test_advance_source_matches_plain_at_four_taken_words(host_fn):
    bad, carry = _run_both(host_fn, "kv9", 128, 64, trips=12)
    assert bad == [], f"{bad} differ"
    assert carry.taken.shape[0] == 128


@pytest.mark.parametrize("slots", [2, 8])
def test_advance_source_matches_plain_with_a_tiny_memo(host_fn, slots):
    """Slots overwritten all the time, and prunes."""
    bad, carry = _run_both(host_fn, "kv9", 40, slots, trips=80)
    assert bad == [], f"{bad} differ"
    assert int(carry.dsi[4].sum()) > int((carry.occ == 1).sum())


@pytest.mark.parametrize("warps", [3, 8])
def test_advance_source_matches_plain_with_warps_sharing_a_block(host_fn,
                                                                 warps):
    bad, _ = _run_both(host_fn, "kv32", 24, 64, warps=warps)
    assert bad == [], f"{bad} differ"


def test_advance_source_runs_only_the_listed_lanes(host_fn):
    bad, carry = _run_both(host_fn, "kv9", 24, 64, listed=True, trips=60)
    assert bad == [], f"{bad} differ"
    assert int((carry.dsi[STATUS] != RUNNING).sum()) > 0


def test_advance_entry_refuses_bad_arguments(host_fn):
    spec, tabs, starts = _inputs("kv9", 24)
    R, N = tabs.cmd.shape
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              64)
    nxt = torch.zeros((LANES, N, 9), dtype=torch.int32)
    ok = torch.zeros((LANES, N), dtype=torch.uint8)
    lanes = torch.arange(LANES, dtype=torch.int32)
    out = torch.zeros((LANES, 9), dtype=torch.int32)
    ptrs = [tabs.prec.data_ptr(), tabs.valid.data_ptr(),
            tabs.nreq.data_ptr(), carry.row.data_ptr(), lanes.data_ptr(),
            nxt.data_ptr(), ok.data_ptr(),
            *(t.data_ptr() for t in carry[:6]), out.data_ptr()]
    plan = list(advance_launch_plan(LANES, H100_SMS))
    good = [LANES, R, N, 1, 9, 64, BUDGET, LANES]
    assert host_fn(*ptrs, *good, *plan, None) == 0
    # the lane list and the next states are required
    for at in (4, 13):
        bad = list(ptrs)
        bad[at] = None
        assert host_fn(*bad, *good, *plan, None) == 1, at
    # (argument index, value): B, R, N, W, D, slots, budget, L
    for at, value in ((2, 129), (3, 2), (4, 0), (5, 48), (1, 0),
                      (7, LANES + 1), (7, -1)):
        bad = list(good)
        bad[at] = value
        assert host_fn(*ptrs, *bad, *plan, None) == 1, (at, value)
    for p in ((plan[0] + 1, plan[1]), (9, -(-LANES // 9)), (0, 0)):
        assert host_fn(*ptrs, *good, *p, None) == 1, p
    assert sweep_model(spec, "cpu").route == "generic"


@pytest.mark.parametrize("mutant", MUTANTS, ids=[m[0] for m in MUTANTS])
def test_mutants_of_the_source_fail(tmp_path, mutant):
    label, cuda, bad = mutant
    src = (CSRC_DIR / "sweep_advance.cu").read_text()
    assert src.count(cuda) == 1, f"the source no longer has: {cuda}"
    fn = _host_lib(tmp_path, src.replace(cuda, bad), tag="_mutant")
    caught = any(_run_both(fn, name, 24, slots, trips=60)[0]
                 for name in ("kv9", "kv32") for slots in (64, 4))
    assert caught, f"the mutant '{label}' was not caught"
