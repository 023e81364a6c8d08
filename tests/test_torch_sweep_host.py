"""The CUDA source of ``stepper_sweep`` compiled for the host and held
against ``stepper_sweep_plain``, bit for bit on every carry plane, on the
CPU; and ``compact_carry``'s source on sweep-regime carries (lane-major
state stacks, keys of W + D words) against ``compact_carry_plain``.

``stepper_sweep.cu``'s threads meet at warp votes and barriers, so it
runs under ``tests/cuda_host/cuda_warp.h`` (each block's threads as host
threads, every vote and barrier a meeting point), with its
``extern __shared__`` line and its ``<<<>>>`` launch rewritten, compiled
with the host C++ compiler and called through ctypes on CPU tensors.  The
kernel steps each model by its own code (a kind and parameters), the plain
version by ``spec.step_torch``, so the two are independent
implementations of each model: queue, stack, KV, multicas, txn and a
random vector spec, at one to four taken words, memo off and on, several
warps a block, start states and args outside the declared domains, memos
of 4 and 16 slots (slots overwritten, filter tags colliding), a carry that
enters with a populated memo (the filter built at entry), a lane list.
State widths with a hash instantiation of their own (8, 9, 16) and without
(4, 5, 12: the hash loop).  Mutants of the source that must fail: a state
word left out of the memo key, the hash loop skipping the last state word
of a width without its own instantiation, a put writing the wrong element, the queue length off by one, a copy
with src and dst swapped, thread i computing child word i + 1, a filter
tag left stale after an overwrite, a filter that misses an occupied
matching slot."""

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
from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from qsm_tpu_torch.models.multi import (AtomicMultiCasSUT, MultiCasSpec,
                                        RacyMultiCasSUT)
from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                        RacyTwoPhaseQueueSUT)
from qsm_tpu_torch.models.stack import (AtomicStackSUT, RacyTwoPhaseStackSUT,
                                        StackSpec)
from qsm_tpu_torch.models.txn import (AtomicTxnSUT, TornCopyTxnSUT,
                                      TxnRegisterSpec)
from qsm_tpu_torch.ops.dfs_kernel import H100_SMS
from qsm_tpu_torch.ops.kernels import CSRC_DIR
from qsm_tpu_torch.ops.stepper_kernel import (RUNNING, STATUS, StepperCarry,
                                              compact_carry_plain, key_words,
                                              n_words)
from qsm_tpu_torch.ops.sweep_kernel import (SweepPlan, fresh_sweep_carry,
                                            stepper_sweep_plain,
                                            sweep_launch_plan, sweep_model,
                                            sweep_tables, sweep_warp_bytes)
from qsm_tpu_torch.utils.corpus import build_corpus
from qsm_tpu_torch.utils.fuzz import RandomVectorSpec, random_history

SHIM = Path(__file__).resolve().parent / "cuda_host"
LANES = 24
CHUNK = 48
BUDGET = 552_000
_P, _I = ctypes.c_void_p, ctypes.c_int
_REWRITES = {
    "stepper_sweep": (
        ("extern __shared__ int32_t smem[];", "int32_t* smem = host_smem;"),
        ("kern<<<grid, warps * WARP, smem_bytes, "
         "static_cast<cudaStream_t>(stream)>>>(a);",
         "host_launch_threads(kern, grid, warps * WARP, smem_bytes, a);")),
    "compact_carry": (
        ("kern<<<grid, THREADS, 0, stream>>>(a);",
         "host_launch(kern, grid, THREADS, 0, a);"),),
}

# the mutants: (name, the text replaced, its replacement, the cases that
# must catch it)
MUTANTS = [
    ("state word left out of the memo key",
     "const int N = a.N, D = a.D, kw = W + D;",
     "const int N = a.N, D = a.D, kw = W + D - 1;", ("kv9",)),
    ("put writes the wrong element",
     "o.x = c == 0 ? -1 : floor_div(a, m.p1);",
     "o.x = c == 0 ? -1 : (floor_div(a, m.p1) + 1) % D;", ("kv9",)),
    ("queue length off by one",
     "return len + (full ? 0 : 1);", "return len + (full ? 0 : 2);",
     ("queue8",)),
    ("copy with src and dst swapped",
     "o.rd = c == 0 ? jidx(a, D) : (c == 1 ? 0 : jidx(src, D));\n"
     "    o.x = c == 0 ? -1 : (c == 1 ? floor_div(a, nv) : dst);",
     "o.rd = c == 0 ? jidx(a, D) : (c == 1 ? 0 : jidx(dst, D));\n"
     "    o.x = c == 0 ? -1 : (c == 1 ? floor_div(a, nv) : src);",
     ("txn8",)),
    ("thread i computes child word i + 1",
     "child = child_word<K>(a, lane, s,",
     "child = child_word<K>(a, lane + 1, s,",
     ("kv9", "queue8")),
    ("filter tag left stale after an overwrite",
     "tags[sl] = tag_of(h);\n      inserts += 1;",
     "if (tags[sl] == 0) tags[sl] = tag_of(h);\n      inserts += 1;",
     ("kv9", "queue8")),
    ("hash loop skips the last state word",
     "  for (int q = 0; q < 3; ++q)\n    if (i + q < D) h = mix(h, nx[q]);",
     "  for (int q = 0; q < 3; ++q)\n    if (i + q < D - 1) h = mix(h, nx[q]);",
     ("kv5", "queue3")),
    ("filter misses an occupied matching slot",
     "for (int w = 0; w < kw; ++w)\n",
     "for (int w = W; w < kw; ++w)\n",
     ("kv9", "queue8")),
]


def _host_lib(name: str, tmp: Path, src: str = None, tag: str = ""):
    """The host build of ``csrc/<name>.cu`` (or of the text ``src``)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = src if src is not None else (CSRC_DIR / f"{name}.cu").read_text()
    for cuda, host in _REWRITES[name]:
        assert src.count(cuda) == 1, f"{name}.cu no longer has: {cuda}"
        src = src.replace(cuda, host)
    cpp = tmp / f"{name}{tag}.cpp"
    cpp.write_text(src)
    lib = tmp / f"{name}{tag}.so"
    # -O0: the kernel's many instantiations build several times faster than
    # optimized, and a run is bound by its threads' meeting points anyway
    subprocess.run([cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-pthread",
                    f"-I{SHIM}", "-include", "cuda_warp.h", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _bind(name: str, lib):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([_P] * 16 + [_I] * 16 + [_P] if name == "stepper_sweep"
                   else [_P] * 16 + [_I] * 9 + [_P])
    fn.restype = _I
    return fn


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep_host")
    return tuple(_bind(name, _host_lib(name, tmp))
                 for name in ("stepper_sweep", "compact_carry"))


SPECS = {
    "kv9": (lambda: KvSpec(n_keys=9), (AtomicKvSUT, StaleCacheKvSUT)),
    "kv16": (lambda: KvSpec(n_keys=16), (AtomicKvSUT, StaleCacheKvSUT)),
    "queue8": (lambda: QueueSpec(capacity=8),
               (AtomicQueueSUT, RacyTwoPhaseQueueSUT)),
    "stack8": (lambda: StackSpec(capacity=8),
               (AtomicStackSUT, RacyTwoPhaseStackSUT)),
    "multicas9": (lambda: MultiCasSpec(n_cells=9),
                  (AtomicMultiCasSUT, RacyMultiCasSUT)),
    "txn8": (lambda: TxnRegisterSpec(8, 8), (AtomicTxnSUT, TornCopyTxnSUT)),
    "random9": (lambda: RandomVectorSpec(5, bounds=(4, 3, 5, 4, 4, 3, 4, 4,
                                                    6)), None),
    # state widths without an instantiation of their own: the hash loop
    "kv5": (lambda: KvSpec(n_keys=5), (AtomicKvSUT, StaleCacheKvSUT)),
    "queue3": (lambda: QueueSpec(capacity=3),
               (AtomicQueueSUT, RacyTwoPhaseQueueSUT)),
    "kv12": (lambda: KvSpec(n_keys=12), (AtomicKvSUT, StaleCacheKvSUT)),
}


def _inputs(name: str, n_ops: int, pids: int = 6, odd: bool = False):
    """(spec, tables, start states) of LANES histories; with ``odd`` some
    args and start states outside the declared domains."""
    make, suts = SPECS[name]
    spec = make()
    if suts is None:
        rng = random.Random(f"sweep-host:{name}")
        hs = [random_history(spec, rng, pids, n_ops) for _ in range(LANES)]
    else:
        hs = build_corpus(spec, suts, n=LANES, n_pids=pids, max_ops=n_ops,
                          seed_base=23, seed_prefix="sweep-host")
    enc = encode_batch(hs, spec.initial_state())
    cmd, arg, resp = (enc.ops[:, :, k].copy() for k in (1, 2, 3))
    starts = np.tile(np.asarray(enc.init_state, np.int32), (LANES, 1))
    if odd:
        g = np.random.default_rng(8)
        wild = g.random(arg.shape) < 0.1
        arg[wild] = g.integers(-40, 80, int(wild.sum()))
        starts[::4] = g.integers(-3, 12, starts[::4].shape)
    tabs = sweep_tables(cmd, arg, resp, enc.valid, enc.precedes(), "cpu")
    return spec, tabs, starts


def _plan(L: int, N: int, D: int, slots: int, warps: int = 0) -> SweepPlan:
    if not warps:
        return sweep_launch_plan(L, N, D, slots, H100_SMS)
    return SweepPlan(warps, -(-L // warps),
                     warps * sweep_warp_bytes(N, D, slots))


def _step(fn, model, tabs, carry, plan, chunk=CHUNK, lanes=None,
          stats=None) -> int:
    """One launch through the C entry; ``lanes`` an int32 tensor or None,
    ``stats`` an int64 ``[2]`` tensor or None."""
    R, N = tabs.cmd.shape
    B, D = carry.row.shape[0], carry.states.shape[2]
    return fn(*(t.data_ptr() for t in tabs), model.data.data_ptr(),
              carry.row.data_ptr(), *(t.data_ptr() for t in carry[:6]),
              None if lanes is None else lanes.data_ptr(),
              None if stats is None else stats.data_ptr(),
              B, R, N, n_words(N), D, carry.occ.shape[1], chunk, BUDGET,
              model.kind, *model.params,
              B if lanes is None else lanes.numel(),
              *(int(x) for x in plan), None)


def _clone(c: StepperCarry) -> StepperCarry:
    return StepperCarry(*(t.clone() for t in c))


def _diff(got: StepperCarry, want: StepperCarry):
    return [name for name, a, b in zip(StepperCarry._fields, got, want)
            if not torch.equal(a, b)]


def _run_both(step, name, n_ops, slots, warps=0, chunks=2, odd=False):
    """Both versions over ``chunks`` chunks from a fresh carry; the planes
    that differ (empty: equal) and the final carry."""
    spec, tabs, starts = _inputs(name, n_ops, odd=odd)
    model = sweep_model(spec, "cpu")
    N = tabs.cmd.shape[1]
    rows = np.random.default_rng(3).permutation(LANES)  # lanes != rows
    carry = fresh_sweep_carry(tabs.nreq, rows, starts[rows], LANES, N, slots)
    plan = _plan(LANES, N, spec.STATE_DIM, slots, warps)
    for k in range(chunks):
        got, want = _clone(carry), _clone(carry)
        assert _step(step, model, tabs, got, plan) == 0
        stepper_sweep_plain(spec, tabs, want, chunk=CHUNK, budget=BUDGET)
        bad = _diff(got, want)
        if bad:
            return bad, got
        carry = got
    return [], carry


@pytest.mark.parametrize("slots", [0, 64])
@pytest.mark.parametrize("name,n_ops", [
    ("kv9", 24), ("kv16", 64), ("queue8", 24), ("stack8", 48),
    ("multicas9", 48), ("txn8", 24), ("random9", 40), ("kv9", 96),
    ("kv9", 128), ("kv5", 24), ("queue3", 24), ("kv12", 40)])
def test_sweep_source_matches_plain(host_libs, name, n_ops, slots):
    step, _ = host_libs
    bad, carry = _run_both(step, name, n_ops, slots)
    assert bad == [], f"{bad} differ"
    assert int((carry.dsi[STATUS] != RUNNING).sum()) > 0
    if slots:
        assert int((carry.occ == 1).sum()) > 0  # the memo was exercised


@pytest.mark.parametrize("name", ["kv9", "queue8", "stack8", "multicas9",
                                  "txn8", "random9"])
def test_sweep_source_matches_plain_off_the_domains(host_libs, name):
    """Args and start states outside the declared domains: the kernel's
    floor division and clamped indexing are the plain version's (and
    through it the JAX package's)."""
    step, _ = host_libs
    bad, _ = _run_both(step, name, 24, 64, odd=True)
    assert bad == [], f"{bad} differ"


@pytest.mark.parametrize("warps", [3, 5])
def test_sweep_source_matches_plain_with_warps_sharing_a_block(host_libs,
                                                               warps):
    step, _ = host_libs
    bad, _ = _run_both(step, "kv9", 40, 64, warps=warps)
    assert bad == [], f"{bad} differ"


@pytest.mark.parametrize("slots", [4, 16])
@pytest.mark.parametrize("name,n_ops", [("kv9", 40), ("queue8", 24),
                                        ("txn8", 24), ("random9", 40),
                                        ("kv5", 24)])
def test_sweep_source_matches_plain_with_a_tiny_memo(host_libs, name, n_ops,
                                                     slots):
    """A memo of 4 or 16 slots a lane: slots are overwritten all the time
    and the filter's tags collide (a matching tag over another key, which
    the compare in device memory must reject)."""
    step, _ = host_libs
    spec, tabs, starts = _inputs(name, n_ops)
    model = sweep_model(spec, "cpu")
    N = tabs.cmd.shape[1]
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              slots)
    plan = _plan(LANES, N, spec.STATE_DIM, slots)
    stats = torch.zeros(2, dtype=torch.int64)
    for _ in range(3):
        got, want = _clone(carry), _clone(carry)
        assert _step(step, model, tabs, got, plan, stats=stats) == 0
        stepper_sweep_plain(spec, tabs, want, chunk=CHUNK, budget=BUDGET)
        assert _diff(got, want) == []
        carry = got
    probes, passes = (int(x) for x in stats)
    # more inserts than occupied slots: slots were overwritten
    assert int(carry.dsi[4].sum()) > int((carry.occ == 1).sum())
    assert 0 < passes < probes            # the filter skipped probes


def test_sweep_source_matches_plain_from_a_populated_memo(host_libs):
    """The carry enters with a memo that the plain version filled (and
    empty slots holding junk keys and occupancy words other than 1): the
    kernel builds its filter from it at entry and prunes where the plain
    version does."""
    step, _ = host_libs
    spec, tabs, starts = _inputs("kv9", 40)
    model = sweep_model(spec, "cpu")
    N = tabs.cmd.shape[1]
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              16)
    stepper_sweep_plain(spec, tabs, carry, chunk=3 * CHUNK, budget=BUDGET)
    g = torch.Generator().manual_seed(4)
    empty = carry.occ != 1
    carry.keys[empty] = torch.randint(-9, 9, carry.keys[empty].shape,
                                      generator=g, dtype=torch.int32)
    carry.occ[empty] = torch.randint(-3, 1, carry.occ[empty].shape,
                                     generator=g, dtype=torch.int32) * 2
    assert int((carry.occ == 1).sum()) > LANES
    running = int((carry.dsi[STATUS] == RUNNING).sum())
    assert running > 0
    got, want = _clone(carry), _clone(carry)
    assert _step(step, model, tabs, got, _plan(LANES, N, 9, 16)) == 0
    stepper_sweep_plain(spec, tabs, want, chunk=CHUNK, budget=BUDGET)
    assert _diff(got, want) == []
    # memo hits on configurations inserted before this launch
    assert int((got.dsi[3] - carry.dsi[3]).sum()) > 0


def test_sweep_source_runs_only_the_listed_lanes(host_libs):
    """A lane list (every running lane, in another order, beside some
    decided ones) gives the plain version's carry; the lanes left off it
    are not touched."""
    step, _ = host_libs
    spec, tabs, starts = _inputs("kv9", 40)
    model = sweep_model(spec, "cpu")
    N = tabs.cmd.shape[1]
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              64)
    stepper_sweep_plain(spec, tabs, carry, chunk=CHUNK, budget=BUDGET)
    status = carry.dsi[STATUS].numpy()
    run = np.flatnonzero(status == RUNNING)
    done = np.flatnonzero(status != RUNNING)
    assert len(run) > 1 and len(done) > 1
    order = np.random.default_rng(9).permutation(
        np.concatenate([run, done[:1]]))
    lanes = torch.from_numpy(order.astype(np.int32))
    got, want = _clone(carry), _clone(carry)
    plan = _plan(len(order), N, 9, 64)
    assert _step(step, model, tabs, got, plan, lanes=lanes) == 0
    stepper_sweep_plain(spec, tabs, want, chunk=CHUNK, budget=BUDGET)
    assert _diff(got, want) == []


def test_sweep_entry_refuses_bad_arguments(host_libs):
    step, _ = host_libs
    spec, tabs, starts = _inputs("kv9", 24)
    model = sweep_model(spec, "cpu")
    R, N = tabs.cmd.shape
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              64)
    ptrs = [*(t.data_ptr() for t in tabs), model.data.data_ptr(),
            carry.row.data_ptr(), *(t.data_ptr() for t in carry[:6]), None,
            None]
    plan = [int(x) for x in _plan(LANES, N, 9, 64)]
    good = [LANES, R, N, 1, 9, 64, CHUNK, BUDGET, 2, 9, 4, 0, LANES]
    assert step(*ptrs, *good, *plan, None) == 0
    # (argument index, value) pairs: B, R, N, W, D, slots, chunk, budget,
    # kind, p0, p1, p2, L
    for change in (((3, 2),),            # W does not fit N
                   ((4, 8),),            # D is not the model's key count
                   ((4, 32), (9, 32)),   # W + D past 32 words
                   ((5, 48),),           # slots not a power of two
                   ((8, 7),),            # no such kind
                   ((10, 0),),           # no values
                   ((12, LANES - 1),)):  # L != B without a lane list
        bad = list(good)
        for at, value in change:
            bad[at] = value
        assert step(*ptrs, *bad, *plan, None) == 1, change
    warps, grid, smem = plan
    for p in ((warps + 1, grid, smem), (warps, grid + 1, smem),
              (warps, grid, smem - 4), (17, -(-LANES // 17),
                                        17 * sweep_warp_bytes(N, 9, 64))):
        assert step(*ptrs, *good, *p, None) == 1, p
    # a lane list longer than the carry
    lanes = torch.arange(LANES, dtype=torch.int32)
    ptrs[14] = lanes.data_ptr()
    long_plan = [int(x) for x in _plan(LANES + 1, N, 9, 64)]
    assert step(*ptrs, *good[:12], LANES + 1, *long_plan, None) == 1


@pytest.mark.parametrize("mutant", MUTANTS, ids=[m[0] for m in MUTANTS])
def test_mutants_of_the_source_fail(tmp_path, mutant):
    label, cuda, bad, cases = mutant
    src = (CSRC_DIR / "stepper_sweep.cu").read_text()
    assert src.count(cuda) == 1, f"the source no longer has: {cuda}"
    step = _bind("stepper_sweep", _host_lib(
        "stepper_sweep", tmp_path, src.replace(cuda, bad), tag="_mutant"))
    caught = any(_run_both(step, name, 24, slots)[0]
                 for name in cases for slots in (64, 8))
    assert caught, f"the mutant '{label}' was not caught"


def _compact(fn, carry: StepperCarry, lanes: np.ndarray, bucket: int,
             slots: int, sms: int = 1) -> tuple:
    N, D = carry.taken.shape[0], carry.states.shape[2]
    kw = key_words(N, D)
    out = StepperCarry(*(torch.full(s, 12345, dtype=torch.int32) for s in (
        (N, bucket), (N + 1, bucket), (bucket, N + 1, D), (5, bucket),
        (bucket, slots, kw), (bucket, slots), (bucket,))))
    idx = torch.from_numpy(lanes.astype(np.int32))
    win = torch.full((max(len(lanes) * slots, 1),), 777, dtype=torch.int32)
    rc = fn(*(t.data_ptr() for t in carry), idx.data_ptr(),
            *(t.data_ptr() for t in out), win.data_ptr(),
            carry.row.shape[0], bucket, len(lanes), N, D, kw,
            carry.occ.shape[1], slots, sms, None)
    return rc, out


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("old_slots,slots", [(64, 64), (64, 256), (64, 8),
                                             (64, 0), (0, 64)])
def test_compact_source_matches_plain_on_sweep_carries(host_libs, old_slots,
                                                       slots, sms):
    _, comp = host_libs
    spec, tabs, starts = _inputs("kv9", 40)
    N = tabs.cmd.shape[1]
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              old_slots)
    stepper_sweep_plain(spec, tabs, carry, chunk=CHUNK, budget=BUDGET)
    lanes = np.random.default_rng(5).permutation(LANES)[:13]
    rc, got = _compact(comp, carry, lanes, 16, slots, sms)
    assert rc == 0
    want = compact_carry_plain(carry, lanes, 16, slots)
    assert _diff(got, want) == []
    assert torch.equal(got.states[:13], carry.states[torch.from_numpy(
        lanes)])
    assert int(got.states[13:].abs().sum()) == 0
    if old_slots and slots:
        assert int((got.occ == 1).sum()) > 0


def test_compact_entry_refuses_a_key_width_off_the_state(host_libs):
    _, comp = host_libs
    spec, tabs, starts = _inputs("kv9", 24)
    N = tabs.cmd.shape[1]
    carry = fresh_sweep_carry(tabs.nreq, np.arange(LANES), starts, LANES, N,
                              8)
    lanes = np.arange(8)
    rc, _ = _compact(comp, carry, lanes, 8, 8)
    assert rc == 0
    out = _compact(comp, carry, lanes, 8, 8)[1]
    idx = torch.from_numpy(lanes.astype(np.int32))
    win = torch.zeros(64, dtype=torch.int32)
    ptrs = [*(t.data_ptr() for t in carry), idx.data_ptr(),
            *(t.data_ptr() for t in out), win.data_ptr()]
    for D, kw in ((9, 9), (9, 11), (0, 10), (-1, 10)):
        assert comp(*ptrs, LANES, 8, 8, N, D, kw, 8, 8, 1, None) == 1
    assert comp(*ptrs, LANES, 8, 8, N, 9, 10, 8, 8, 1, None) == 0
