"""The CUDA source of ``threefry_draws`` compiled for the host and held
against ``raw_draws_plain`` and the JAX package's ``_raw_draws_jax``, bit
for bit, on the CPU.

``csrc/threefry_draws.cu`` shares nothing between threads, so running
every thread of a block one after another gives what the card gives.  The
test rewrites the source's one CUDA-only line (the ``<<<...>>>`` launch),
compiles it with the host C++ compiler against
``tests/cuda_host/cuda_runtime.h`` and calls its C entry through ctypes on
CPU tensors: one word, ragged rows, rows shorter than a warp, the main
path's widths, more lanes than the launch's block cap (the grid-stride
loop), seeds that wrap to 32 bits, and the known answers.  What only the
card can show (that ``nvcc`` builds it, the timing) is in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qsm_tpu.gen.core import _raw_draws_jax
from qsm_tpu_torch.ops.draws_kernel import raw_draws_plain, seed_word
from qsm_tpu_torch.ops.kernels import CSRC_DIR

SHIM = Path(__file__).resolve().parent / "cuda_host"
_P = ctypes.c_void_p


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (CSRC_DIR / "threefry_draws.cu").read_text()
    cuda = "threefry_draws_kernel<<<blocks, threads, 0, s>>>(a);"
    host = "host_launch(threefry_draws_kernel, dim3(blocks), threads, 0, a);"
    assert src.count(cuda) == 1, f"threefry_draws.cu no longer has: {cuda}"
    src = src.replace(cuda, host)
    out = tmp_path_factory.mktemp("draws_host")
    (out / "threefry_draws_host.cpp").write_text(src)
    lib = out / "threefry_draws_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{SHIM}", "-o", str(lib),
                    str(out / "threefry_draws_host.cpp")], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).threefry_draws_launch
    fn.argtypes = [_P, ctypes.c_uint32, ctypes.c_longlong,
                   ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, seed, lanes, draws) -> np.ndarray:
    out = torch.full((lanes, draws), 12345, dtype=torch.int32)
    assert fn(out.data_ptr(), seed_word(seed), lanes, draws, None) == 0
    return out


@pytest.mark.parametrize("seed", [0, 17, 2**31, 2**32 + 5, -3, 1_000_004])
@pytest.mark.parametrize("lanes,draws", [(1, 1), (3, 5), (33, 17),
                                         (7, 31), (9, 257), (64, 624),
                                         (16, 3120)])
def test_cuda_source_matches_plain_and_the_reference(host_kernel, seed,
                                                     lanes, draws):
    got = _run(host_kernel, seed, lanes, draws)
    assert torch.equal(got, raw_draws_plain(seed, lanes, draws))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _raw_draws_jax(seed, lanes, draws))


def test_more_lanes_than_the_block_cap(host_kernel):
    """65537 lanes: the grid's last block takes lanes 65535 and 65536."""
    got = _run(host_kernel, 5, 65537, 3)
    assert torch.equal(got, raw_draws_plain(5, 65537, 3))


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
    assert host_kernel(out.data_ptr(), 1, 0, 2, None) == 0
    assert host_kernel(out.data_ptr(), 1, 2, 0, None) == 0
    assert (out == 7).all()  # nothing written
    assert host_kernel(out.data_ptr(), 1, -1, 2, None) != 0
    assert host_kernel(None, 1, 2, 2, None) != 0
