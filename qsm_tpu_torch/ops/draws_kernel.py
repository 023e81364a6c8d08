"""The generation plane's raw draw table on the card: ``threefry_draws``.

The counterpart of the JAX package's ``qsm_tpu/gen/core.py::
_raw_draws_jax``: ``[n_lanes, n_draws]`` 32-bit words, lane ``i``'s row
being ``jax.random.bits(split(PRNGKey(seed), n_lanes)[i], (n_draws,),
uint32)`` under JAX's partitionable threefry, bit for bit.  With
``k = (0, seed mod 2**32)``, lane ``i``'s key is ``threefry2x32(k, (i >>
32, i mod 2**32))`` and word ``j`` of its row is ``x0 ^ x1`` for
``(x0, x1) = threefry2x32(lane key, (j >> 32, j mod 2**32))``.

:func:`threefry_draws` fills an int32 tensor (the words' bits; view the
host copy as ``np.uint32``): on a CUDA tensor it launches
``csrc/threefry_draws.cu`` (``threefry_draws.launches`` counts each
launch), on a CPU tensor it runs :func:`threefry_draws_plain`, the same
function in eager PyTorch.  A failed build or launch raises; nothing
falls back.  :func:`draws_plan` says how the kernel runs a table (store
width, grid, passes); :func:`table_to_host` is the one copy of a table
to the host, through pinned memory, and :func:`reserve_host_table` pins
its block ahead of the first copy of a size.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .backend import resolve_device
from .stepper_kernel import device_sms

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def seed_word(seed: int) -> int:
    """The key's low word: ``PRNGKey(seed)`` with 64-bit types off keeps
    ``seed mod 2**32`` (negative seeds wrap, as an int32 cast does)."""
    return int(seed) & _M32


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors holding 32-bit words
    (every add and shift is masked back to 32 bits)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def threefry_draws_plain(out: torch.Tensor, seed: int) -> torch.Tensor:
    """The plain version: fills ``out`` (int32 ``[n_lanes, n_draws]``)
    with the table of ``seed`` and returns it."""
    n_lanes, n_draws = out.shape
    dev = out.device
    i64 = torch.int64
    lane = torch.arange(n_lanes, dtype=i64, device=dev)
    zero = torch.zeros((), dtype=i64, device=dev)
    a, b = _threefry2x32(zero, zero + seed_word(seed), lane >> 32,
                         lane & _M32)
    j = torch.arange(n_draws, dtype=i64, device=dev)[None, :]
    x0, x1 = _threefry2x32(a[:, None], b[:, None], j >> 32, j & _M32)
    words = x0 ^ x1
    # int32 holds the same bits: words of 2**31 and up wrap negative
    out.copy_(torch.where(words >= 1 << 31, words - (1 << 32), words))
    return out


def _check_out(out: torch.Tensor) -> None:
    if out.dtype != torch.int32 or out.dim() != 2:
        raise ValueError(f"threefry_draws: out must be a 2-d int32 tensor, "
                         f"got {out.dtype} of {out.dim()} dims")
    if not out.is_contiguous():
        raise ValueError("threefry_draws: out is not contiguous")


class DrawsPlan(NamedTuple):
    """How ``csrc/threefry_draws.cu`` runs a table (its C entry
    ``threefry_draws_plan``): 16-byte stores or 4-byte, the grid, the
    passes of its grid-stride loop, units a row."""
    vector: bool
    blocks: int
    threads: int
    passes: int
    per_row: int


def plan_of(plan_fn, ptr: int, n_lanes: int, n_draws: int,
            sms: int) -> DrawsPlan:
    """The plan that ``plan_fn`` (a built ``threefry_draws_plan``) gives
    for a table at address ``ptr``; a shape it refuses raises."""
    buf = (ctypes.c_longlong * 5)()
    rc = plan_fn(ptr, n_lanes, n_draws, sms, buf)
    if rc != 0:
        raise ValueError(f"threefry_draws refuses {n_lanes} x {n_draws} "
                         f"on {sms} SMs (CUDA error {rc})")
    return DrawsPlan(bool(buf[0]), *buf[1:])


def draws_plan(out: torch.Tensor) -> DrawsPlan:
    """The plan of a launch into the CUDA tensor ``out``."""
    from .kernels import threefry_draws_lib

    return plan_of(threefry_draws_lib().threefry_draws_plan,
                   out.data_ptr(), *out.shape, device_sms(out.device))


def threefry_draws(out: torch.Tensor, seed: int) -> torch.Tensor:
    """The table of ``seed`` into ``out`` (int32 ``[n_lanes, n_draws]``):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor; any other device raises."""
    _check_out(out)
    dev = out.device
    if dev.type == "cpu":
        return threefry_draws_plain(out, seed)
    if dev.type != "cuda":
        raise ValueError(f"threefry_draws runs on cuda or cpu, not {dev}")
    from .kernels import KernelLaunchError, threefry_draws_lib

    n_lanes, n_draws = out.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = threefry_draws_lib().threefry_draws_launch(
            out.data_ptr(), seed_word(seed), n_lanes, n_draws,
            device_sms(dev), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"threefry_draws launch failed: CUDA error {rc}")
    threefry_draws.launches += 1
    return out


threefry_draws.launches = 0


def raw_draws(seed: int, n_lanes: int, n_draws: int,
              device=None) -> torch.Tensor:
    """The int32 table ``[n_lanes, n_draws]`` of ``seed`` on ``device``
    (CUDA unless the caller asks for the CPU; without CUDA it raises
    ``BackendUnavailable``)."""
    dev = resolve_device(device)
    out = torch.empty((n_lanes, n_draws), dtype=torch.int32, device=dev)
    return threefry_draws(out, seed)


def raw_draws_plain(seed: int, n_lanes: int, n_draws: int,
                    device="cpu") -> torch.Tensor:
    """:func:`raw_draws` by the plain version on any device."""
    out = torch.empty((n_lanes, n_draws), dtype=torch.int32,
                      device=torch.device(device))
    return threefry_draws_plain(out, seed)


def table_to_host(table: torch.Tensor) -> np.ndarray:
    """``table`` (int32 ``[n_lanes, n_draws]``) as ``np.uint32`` on the
    host, for the assembly.  A CUDA table is copied into a pinned host
    tensor (PyTorch's caching host allocator reuses freed blocks) with
    ``non_blocking=True``, and the stream is synchronised before the host
    reads it; a CPU table is returned as it is, viewed as uint32, and
    nothing is pinned.  The array belongs to the caller: it holds its
    pinned block, so no later call writes into it."""
    dev = table.device
    if dev.type == "cuda":
        host = torch.empty(table.shape, dtype=table.dtype, pin_memory=True)
        host.copy_(table, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        table = host
    elif dev.type != "cpu":
        raise ValueError(f"table_to_host takes a cuda or cpu table, not "
                         f"{dev}")
    return table.numpy().view(np.uint32)


def reserve_host_table(n_lanes: int, n_draws: int, device) -> None:
    """Pin a host block for an int32 ``[n_lanes, n_draws]`` table ahead
    of :func:`table_to_host`'s first copy of that size, and give it back
    to PyTorch's caching host allocator, which then serves the copies of
    that size from it: pinning a new block costs milliseconds, many
    copies' worth.  Nothing is pinned for a CPU ``device``."""
    if torch.device(device).type == "cuda":
        torch.empty((n_lanes, n_draws), dtype=torch.int32, pin_memory=True)
