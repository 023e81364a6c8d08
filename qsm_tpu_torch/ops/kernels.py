"""Build and bind the package's hand-written CUDA kernels.

Each source under ``qsm_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain ``extern "C"`` interface and
loaded with ``ctypes``.  The build happens at first use, never at import,
into ``build/qsm_tpu_torch/`` beside the package, keyed by a hash of the
source and the flags, so a changed source rebuilds and an unchanged one
loads the library already there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "qsm_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error: the launch never ran."""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str, src: Optional[Path] = None,
                 flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Where ``src`` (default ``csrc/<name>.cu``) builds to: keyed by
    source and flags."""
    src = src or CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def build(name: str, src: Optional[Path] = None,
          compiler: Optional[str] = None,
          flags: Sequence[str] = NVCC_FLAGS,
          timeout: Optional[float] = None) -> Path:
    """Compile ``src`` (default ``csrc/<name>.cu``) with ``compiler``
    (default ``nvcc``) unless its library already exists.  Several
    processes may build at once: each compiles to a file of its own and
    installs it with an atomic rename.  The compiler's report (for
    ``nvcc``, the ``-Xptxas -v`` lines: registers, shared memory, spills)
    is kept beside the library as ``<lib>.ptxas.txt``.  ``build.compiles``
    counts the compiler runs of the process (the lint's rebuild guard
    reads it)."""
    src = src or CSRC_DIR / f"{name}.cu"
    out = library_path(name, src, flags)
    if out.exists():
        return out
    # threads of one process share the temporary file's name: one build
    # of a library at a time in a process (a dispatch on a watchdog's
    # thread may race the caller's own first build)
    with _build_lock(out):
        if out.exists():
            return out
        return _compile(src, out, compiler, flags, timeout)


build.compiles = 0

_locks_guard = threading.Lock()
_locks: dict = {}


def _build_lock(out: Path) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(out, threading.Lock())


def _compile(src: Path, out: Path, compiler: Optional[str],
             flags: Sequence[str], timeout: Optional[float]) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    compiler = compiler or find_nvcc()
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"{compiler} unavailable: {e!r}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"{Path(compiler).name} failed ({r.returncode}) on {src.name}:"
            f"\n{r.stderr[-4000:]}")
    out.with_suffix(".ptxas.txt").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    with _locks_guard:
        build.compiles += 1
    return out


def ptxas_report(name: str, src: Optional[Path] = None) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``name``."""
    p = library_path(name, src).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind_device(lib: ctypes.CDLL) -> None:
    """``set_launch_device(int)``: the device of the library's own CUDA
    runtime, which the wrapper sets before each launch."""
    lib.set_launch_device.argtypes = [_I]
    lib.set_launch_device.restype = _I


def launch_device_index(dev) -> int:
    """The CUDA ordinal of torch device ``dev`` (its current device when
    it names none)."""
    import torch

    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def dfs_chunk_lib() -> ctypes.CDLL:
    """The built ``dfs_chunk`` library with its entry's signature set:
    19 device pointers, 7 ints of shape and budget, the 5 ints of the
    launch plan (``dfs_kernel.LaunchPlan``), the stream."""
    lib = ctypes.CDLL(str(build("dfs_chunk")))
    fn = lib.dfs_chunk_launch
    fn.argtypes = [_P] * 19 + [_I] * 12 + [_P]
    fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def stepper_chunk_lib() -> ctypes.CDLL:
    """The built ``stepper_chunk`` library: 13 device pointers (the six
    tables, the lane rows, the six carry planes updated in place), 9 ints
    of shape and budget, the 4 ints of the launch plan
    (``stepper_kernel.StepperPlan``), the stream; and
    ``set_launch_device``."""
    lib = ctypes.CDLL(str(build("stepper_chunk")))
    fn = lib.stepper_chunk_launch
    fn.argtypes = [_P] * 13 + [_I] * 13 + [_P]
    fn.restype = _I
    _bind_device(lib)
    return lib


@functools.lru_cache(maxsize=None)
def compact_carry_lib() -> ctypes.CDLL:
    """The built ``compact_carry`` library: 16 device pointers (the seven
    old carry planes, the surviving lanes, the seven new planes, the
    re-hash scratch), 8 ints of shape (the state width D, 0 for a
    table-regime carry, among them), the card's SM count, the stream; and
    ``set_launch_device``."""
    lib = ctypes.CDLL(str(build("compact_carry")))
    fn = lib.compact_carry_launch
    fn.argtypes = [_P] * 16 + [_I] * 9 + [_P]
    fn.restype = _I
    _bind_device(lib)
    return lib


@functools.lru_cache(maxsize=None)
def stepper_sweep_lib() -> ctypes.CDLL:
    """The built ``stepper_sweep`` library: 16 device pointers (the six
    tables, the model's data, the lane rows, the six carry planes updated
    in place, the lane list or null, the probe counters or null), 8 ints
    of shape and budget, the model's kind and 3 parameters, the count of
    lanes run, the 3 ints of the launch plan (``sweep_kernel.SweepPlan``),
    the stream; and ``set_launch_device``."""
    lib = ctypes.CDLL(str(build("stepper_sweep")))
    fn = lib.stepper_sweep_launch
    fn.argtypes = [_P] * 16 + [_I] * 16 + [_P]
    fn.restype = _I
    _bind_device(lib)
    return lib


@functools.lru_cache(maxsize=None)
def threefry_draws_lib() -> ctypes.CDLL:
    """The built ``threefry_draws`` library: its launch takes the output
    pointer, the 32-bit seed, the two 64-bit counts of lanes and draws,
    the card's SM count, the stream; its plan (``draws_kernel.
    DrawsPlan``) the output pointer, the counts, the SM count and an
    int64 array of 5 to fill."""
    lib = ctypes.CDLL(str(build("threefry_draws")))
    _LL = ctypes.c_longlong
    lib.threefry_draws_launch.argtypes = [_P, ctypes.c_uint32, _LL, _LL,
                                          _I, _P]
    lib.threefry_draws_plan.argtypes = [_P, _LL, _LL, _I, _P]
    for fn in (lib.threefry_draws_launch, lib.threefry_draws_plan):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def sweep_advance_lib() -> ctypes.CDLL:
    """The built ``sweep_advance`` library: 14 device pointers (the three
    tables it reads, the lane rows, the lane list, the step planes
    ``nxt`` and ``ok``, the six carry planes updated in place, the next
    states), 8 ints of shape and budget, the 2 ints of the
    launch plan (``sweep_generic.AdvancePlan``), the stream; and
    ``set_launch_device``."""
    lib = ctypes.CDLL(str(build("sweep_advance")))
    fn = lib.sweep_advance_launch
    fn.argtypes = [_P] * 14 + [_I] * 10 + [_P]
    fn.restype = _I
    _bind_device(lib)
    return lib


KERNEL_SOURCES = ("dfs_chunk", "stepper_chunk", "compact_carry",
                  "stepper_sweep", "threefry_draws", "sweep_advance")
# each source's loader: its ``cache_info().misses`` counts library loads
KERNEL_LIBS = (dfs_chunk_lib, stepper_chunk_lib, compact_carry_lib,
               stepper_sweep_lib, threefry_draws_lib, sweep_advance_lib)


def build_all(names=KERNEL_SOURCES) -> dict:
    """Build every named source at once, one ``nvcc`` each, all started
    together; ``{name: library path}``."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))
