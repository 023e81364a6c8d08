"""The native host oracle: build, bind, route.

``wg.cpp`` is a C++ Wing–Gong checker, the port's own copy of the JAX
package's.  It is host code (no GPU): the exact checker that decides what
the device leaves undecided, 1–2 orders of magnitude faster than the
Python oracle on the specs it covers.

It is built with ``g++ -O2 -shared -fPIC -std=c++17`` at first use, never
at import, into ``build/qsm_tpu_torch/`` beside the package (where the CUDA
kernels go), keyed by a hash of the source and the flags, and bound with
``ctypes``, through ``ops.kernels.build`` as the CUDA kernels are:
several processes may build at once (a test run's workers), each
compiles to a file of its own and installs it with an atomic rename.
Without a toolchain :func:`native_available` is False and the callers
(``resilience.failover.host_fallback``, the property layer) fall back to
the Python oracle; :func:`native_error` says why.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

from ..ops import kernels

SRC = Path(__file__).resolve().parent / "wg.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_error: Optional[str] = None


def library_path() -> Path:
    """Where the source builds to: keyed by the source and the flags."""
    return kernels.library_path("wg", SRC, GXX_FLAGS)


def native_available() -> bool:
    return get_lib() is not None


def native_status() -> str:
    """Availability without building: "loaded", "built" (the library is
    on disk, not yet loaded), "failed: ..." or "unbuilt"."""
    if _lib is not None:
        return "loaded"
    if _lib_error is not None:
        return f"failed: {_lib_error}"
    return "built" if library_path().exists() else "unbuilt"


def native_error() -> Optional[str]:
    get_lib()
    return _lib_error


def get_lib():
    """Build (once) and load the native checker; None if impossible."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        so_path = kernels.build("wg", SRC, "g++", GXX_FLAGS, timeout=120)
    except kernels.KernelBuildError as e:
        _lib_error = str(e)[-400:]
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError as e:
        _lib_error = f"dlopen failed: {e!r}"
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.wg_check_batch.restype = ctypes.c_longlong
    lib.wg_check_batch.argtypes = [
        ctypes.c_int, i64p,                 # n_hist, offsets
        i32p, i32p, i32p, u8p, u64p,        # cmd, arg, resp, pending, blockers
        ctypes.c_int, ctypes.c_int,         # kind, state_dim
        ctypes.c_int32, ctypes.c_int32,     # p0, p1
        ctypes.c_int,                       # elem_bits (0 = string keys)
        i32p, u8p,                          # trans, ok (kind 0; else None)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # S C A R
        i32p,                               # n_resps
        i32p, ctypes.c_longlong, ctypes.c_int,  # init_states, budget, memo
        i32p,                               # out_verdicts
    ]
    lib.wg_end_states.restype = ctypes.c_longlong
    lib.wg_end_states.argtypes = [
        ctypes.c_int,                       # n (segment ops)
        i32p, i32p, i32p, u64p,             # cmd, arg, resp, blockers
        ctypes.c_int, ctypes.c_int,         # kind, state_dim
        ctypes.c_int32, ctypes.c_int32,     # p0, p1
        ctypes.c_int,                       # elem_bits
        i32p, u8p,                          # trans, ok
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # S C A R
        i32p, ctypes.c_int,                 # init_states, n_inits
        ctypes.c_longlong,                  # node budget
        i32p, ctypes.c_int,                 # out_states, max_out
        ctypes.POINTER(ctypes.c_longlong),  # nodes_used (out)
    ]
    _lib = lib
    return _lib


from .oracle import NATIVE_MAX_OPS, CppOracle  # noqa: E402  (needs get_lib)

__all__ = ["CppOracle", "NATIVE_MAX_OPS", "get_lib", "library_path",
           "native_available", "native_error", "native_status"]
