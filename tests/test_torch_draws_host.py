"""The CUDA source of ``threefry_draws`` compiled for the host and held
against ``raw_draws_plain`` and the JAX package's ``_raw_draws_jax``, bit
for bit, on the CPU.

``csrc/threefry_draws.cu`` shares nothing between threads, so running
every thread of a block one after another gives what the card gives.  The
test rewrites the source's one CUDA-only line (the ``<<<...>>>`` launch),
compiles it with the host C++ compiler against
``tests/cuda_host/cuda_runtime.h`` (its ``uint4`` and ``__funnelshift_l``
stand-ins included) and calls its C entries through ctypes on CPU
tensors.  The cases: one word, rows that are not a multiple of the
16-word unit or of 4 (4-byte stores), the main path's 816, a misaligned
table (4-byte stores on a row of 4k words), more units than the grid at
a small SM count passed in (the grid-stride loop), seeds that wrap to 32
bits, the known answers; and the host-side plan itself (store width,
grid) at the boundary shapes and past 2**31 words, without allocating
such a table.  What only the card can show (that
``nvcc`` builds it, the timing) is in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qsm_tpu.gen.core import _raw_draws_jax
from qsm_tpu_torch.ops.dfs_kernel import H100_SMS
from qsm_tpu_torch.ops.draws_kernel import (DrawsPlan, plan_of,
                                            raw_draws_plain, seed_word)
from qsm_tpu_torch.ops.kernels import CSRC_DIR

SHIM = Path(__file__).resolve().parent / "cuda_host"
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
TWO31 = 2**31


def _build(out: Path, name: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (CSRC_DIR / "threefry_draws.cu").read_text()
    cuda = "threefry_draws_kernel<V><<<blocks, threads, 0, s>>>(a);"
    host = ("host_launch(threefry_draws_kernel<V>, dim3(blocks), threads, "
            "0, a);")
    assert src.count(cuda) == 1, f"threefry_draws.cu no longer has: {cuda}"
    (out / f"{name}.cpp").write_text(src.replace(cuda, host))
    lib = out / f"{name}.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{SHIM}", "-o",
                    str(lib), str(out / f"{name}.cpp")], check=True,
                   capture_output=True, timeout=300)
    cdll = ctypes.CDLL(str(lib))
    cdll.threefry_draws_launch.argtypes = [_P, ctypes.c_uint32, _LL, _LL,
                                           ctypes.c_int, _P]
    cdll.threefry_draws_plan.argtypes = [_P, _LL, _LL, ctypes.c_int, _P]
    for fn in (cdll.threefry_draws_launch, cdll.threefry_draws_plan):
        fn.restype = ctypes.c_int
    return cdll


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("draws_host"),
                  "threefry_draws_host")


@pytest.fixture(scope="module")
def host_kernel(host_lib):
    return host_lib.threefry_draws_launch


def _run(fn, seed, lanes, draws, sms=H100_SMS, out=None) -> torch.Tensor:
    if out is None:
        out = torch.full((lanes, draws), 12345, dtype=torch.int32)
    assert fn(out.data_ptr(), seed_word(seed), lanes, draws, sms, None) == 0
    return out


def _misaligned(lanes, draws, words=1):
    """(buffer, table): a contiguous ``[lanes, draws]`` table ``words``
    words (1 to 3) past a 16-byte boundary of its buffer, so its rows
    cannot take 16-byte stores."""
    buf = torch.full((lanes * draws + 4,), 12345, dtype=torch.int32)
    out = buf[words:words + lanes * draws].view(lanes, draws)
    assert out.data_ptr() % 16 == 4 * words
    return buf, out


def _plan(lib, lanes, draws, sms=H100_SMS, ptr=0) -> DrawsPlan:
    return plan_of(lib.threefry_draws_plan, ptr, lanes, draws, sms)


@pytest.mark.parametrize("seed", [0, 17, 2**31, 2**32 + 5, -3, 1_000_004])
@pytest.mark.parametrize("lanes,draws", [(1, 1), (5, 3), (3, 5), (33, 17),
                                         (7, 31), (9, 33), (9, 257),
                                         (64, 624), (64, 816), (3, 4097),
                                         (16, 3120)])
def test_cuda_source_matches_plain_and_the_reference(host_kernel, seed,
                                                     lanes, draws):
    got = _run(host_kernel, seed, lanes, draws)
    assert torch.equal(got, raw_draws_plain(seed, lanes, draws))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _raw_draws_jax(seed, lanes, draws))


@pytest.mark.parametrize("words", [1, 2, 3])
@pytest.mark.parametrize("lanes,draws", [(3, 4), (64, 816), (5, 3120)])
def test_misaligned_table_takes_4_byte_stores(host_lib, words, lanes,
                                              draws):
    """Rows of 4k words in a table 4, 8 or 12 bytes off a 16-byte
    boundary run the 4-byte-store instantiation, and every word is still
    right; nothing before or after the table is written."""
    buf, out = _misaligned(lanes, draws, words)
    assert not _plan(host_lib, lanes, draws, ptr=out.data_ptr()).vector
    assert _plan(host_lib, lanes, draws,
                 ptr=out.data_ptr() - 4 * words).vector
    _run(host_lib.threefry_draws_launch, 11, lanes, draws, out=out)
    assert torch.equal(out, raw_draws_plain(11, lanes, draws))
    assert (buf[:words] == 12345).all()
    assert (buf[words + lanes * draws:] == 12345).all()


@pytest.mark.parametrize("seed", [5, 2**32 + 5])
@pytest.mark.parametrize("lanes,draws,sms", [(65537, 3, 1), (300, 816, 1),
                                             (41, 4097, 2), (3000, 17, 3)])
def test_grid_stride_loop_with_more_units_than_the_grid(host_lib, seed,
                                                        lanes, draws, sms):
    """At a small SM count the grid holds fewer threads than units, so
    each thread walks several units and its (lane, unit) wraps from one
    row to the next."""
    p = _plan(host_lib, lanes, draws, sms)
    assert p.passes > 1 and p.blocks <= sms
    got = _run(host_lib.threefry_draws_launch, seed, lanes, draws, sms)
    assert torch.equal(got, raw_draws_plain(seed, lanes, draws))


def test_more_lanes_than_the_block_cap(host_kernel):
    """200,000 lanes of 3 words on a card of 132 SMs: past the 65,536
    blocks of the first design's grid, and more units than the grid's
    threads, so the grid-stride loop takes a second pass."""
    got = _run(host_kernel, 5, 200_000, 3)
    assert torch.equal(got, raw_draws_plain(5, 200_000, 3))


def test_known_answers(host_kernel):
    t = _run(host_kernel, 7, 3, 5).numpy().view(np.uint32)
    assert t[0].tolist() == [3725328165, 2389352394, 1291398195,
                             1428036129, 4260943734]
    t = _run(host_kernel, 17, 4096, 3120).numpy().view(np.uint32)
    assert t[0, :4].tolist() == [2639664804, 3479077941, 2518621796,
                                 1267003793]
    assert t[4095, -4:].tolist() == [1348504043, 1475632984, 2031686271,
                                     3777973134]
    assert int(np.bitwise_xor.reduce(t.ravel())) == 3671365389
    assert int(t.astype(np.uint64).sum() % 2**32) == 4283564019


def test_empty_and_invalid_shapes(host_kernel):
    out = torch.full((2, 2), 7, dtype=torch.int32)
    assert host_kernel(out.data_ptr(), 1, 0, 2, H100_SMS, None) == 0
    assert host_kernel(out.data_ptr(), 1, 2, 0, H100_SMS, None) == 0
    assert (out == 7).all()  # nothing written
    assert host_kernel(out.data_ptr(), 1, -1, 2, H100_SMS, None) != 0
    assert host_kernel(None, 1, 2, 2, H100_SMS, None) != 0
    assert host_kernel(out.data_ptr(), 1, 2, 2, 0, None) != 0  # no SM


# -- the host-side plan --------------------------------------------------

@pytest.mark.parametrize("lanes,draws", [
    (1, TWO31 - 1), (1, TWO31), (TWO31 - 1, 1), (TWO31, 1),
    (46340, 46340), (46341, 46341), (2**29 - 1, 4), (2**29, 4),
    (65536, 32768), (1, 2**32 + 4), (2**33, 3), (2**20, 2**20)])
def test_plan_takes_tables_past_2_31_words(host_lib, lanes, draws):
    """One index width for every table: the plan of a table under, at and
    past 2**31 words (and a row past 2**32) covers its units on a full
    card, with 16-byte stores exactly for rows of 4k words; it is asked
    for the shape alone (no table is allocated)."""
    p = _plan(host_lib, lanes, draws)
    assert p.vector == (draws % 4 == 0)
    assert p.per_row == -(-draws // 16)
    assert (p.blocks * p.threads * p.passes >= lanes * p.per_row
            > p.blocks * p.threads * (p.passes - 1))


@pytest.mark.parametrize("draws,ptr,vector", [
    (816, 0, True), (624, 16, True), (3120, 256, True), (4, 0, True),
    (816, 4, False), (816, 8, False), (816, 12, False),
    (1, 0, False), (3, 0, False), (17, 0, False), (33, 0, False),
    (4097, 0, False), (818, 0, False), (2**31, 0, True)])
def test_plan_picks_the_store_width(host_lib, draws, ptr, vector):
    """16-byte stores when every row starts on a 16-byte boundary: rows
    of 4k words in an aligned table; 4-byte stores otherwise."""
    assert _plan(host_lib, 3, draws, ptr=ptr).vector == vector


def test_plan_grid_at_the_path_shapes(host_lib):
    """One block an SM at most, the same warps on every SM in every pass:
    the path's 1024 x 816 in one pass of 13 warps an SM; 4096 x 3120 in
    six full passes; 4096 x 624 in two."""
    lib = host_lib
    assert _plan(lib, 1024, 816) == DrawsPlan(True, 126, 416, 1, 51)
    assert _plan(lib, 4096, 624) == DrawsPlan(True, 132, 608, 2, 39)
    assert _plan(lib, 4096, 3120) == DrawsPlan(True, 130, 1024, 6, 195)
    assert _plan(lib, 1, 1) == DrawsPlan(False, 1, 32, 1, 1)
    assert _plan(lib, 0, 816).blocks == _plan(lib, 5, 0).blocks == 0


@pytest.mark.parametrize("sms", [1, 2, 7, 132])
def test_plan_covers_every_unit_with_no_ragged_pass(host_lib, sms):
    """Over many shapes: the grid's passes cover every unit, the last pass
    is short by less than one block, blocks never outnumber the SMs, and
    a block is whole warps within one SM's 1024 threads."""
    rng = np.random.default_rng(sms)
    shapes = [(int(a), int(b)) for a, b in zip(
        rng.integers(1, 70_000, 40), rng.integers(1, 5000, 40))]
    for lanes, draws in shapes + [(TWO31 - 1, 1), (1, TWO31)]:
        p = _plan(host_lib, lanes, draws, sms)
        units = lanes * p.per_row
        assert p.per_row == -(-draws // 16)  # 16-word units
        grid = p.blocks * p.threads
        assert 1 <= p.blocks <= sms and p.threads % 32 == 0
        assert 32 <= p.threads <= 1024
        assert grid * p.passes >= units > grid * (p.passes - 1)
        assert grid * p.passes - units < p.threads * p.passes


def test_plan_refuses_what_it_cannot_take(host_lib):
    for lanes, draws, sms in ((-1, 4, 132), (4, -1, 132), (4, 4, 0),
                              (2**62, 2**40, 132)):
        with pytest.raises(ValueError):
            _plan(host_lib, lanes, draws, sms)
