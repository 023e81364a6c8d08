"""Linearizability-checker backend protocol.

Backends decide *batches* of histories.  Verdicts are a tri-state: a
device search runs under a bounded iteration budget and reports
BUDGET_EXCEEDED instead of guessing; the property layer resolves those
with the exact host oracle.
"""

from __future__ import annotations

import enum
from typing import Protocol, Sequence

import numpy as np

from ..core.history import History
from ..core.spec import Spec


class Verdict(enum.IntEnum):
    VIOLATION = 0
    LINEARIZABLE = 1
    BUDGET_EXCEEDED = 2


# a verdict's name in JSON documents (the CLI's lines, monitor session
# snapshots): index == Verdict value
VERDICT_NAMES = tuple(v.name for v in Verdict)


class BackendUnavailable(RuntimeError):
    """A backend lost its substrate mid-run (device gone, runtime torn
    down): the typed signal that callers may degrade on."""


class DeviceDispatchError(RuntimeError):
    """A dispatch failed on the card with an error that must not degrade
    (a real device error): the requests it served answer ``ok: false``
    with the original error's name and message, ``str(self)``."""


def device_error_types() -> tuple:
    """Every error class that means the device substrate failed, as
    opposed to a bug in the caller's arguments, which must keep crashing.
    Deliberately not a bare ``RuntimeError`` (which a bad argument to any
    torch op raises) nor ``OSError``: only typed CUDA failures count,
    beside the resilience plane's own: a watched dispatch that timed out
    and a fault the fault plane injected (``resilience/``), as in the JAX
    package.  On a CUDA device ``resilience/failover.py`` degrades on the
    last two only when the plane injected them."""
    import torch

    from ..resilience.faults import InjectedFault
    from ..resilience.policy import WatchdogTimeout

    errs = [BackendUnavailable, WatchdogTimeout, InjectedFault,
            torch.cuda.OutOfMemoryError]
    # a sticky CUDA fault (illegal address, device lost); older torch
    # builds raise a bare RuntimeError there, which stays uncaught
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        errs.append(accel)
    return tuple(errs)


def resolve_device(device=None):
    """The torch device an entry point runs on: CUDA unless the caller
    asks for another device.  Raises when CUDA was wanted and is absent:
    no silent move to the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BackendUnavailable(
            "no CUDA device; pass device='cpu' to run the plain versions")
    return dev


class LineariseBackend(Protocol):
    name: str

    def check_histories(self, spec: Spec, histories: Sequence[History]
                        ) -> np.ndarray:
        """Return int8[len(histories)] of :class:`Verdict` values."""
        ...


def check_one(backend: LineariseBackend, spec: Spec,
              history: History) -> Verdict:
    return Verdict(int(backend.check_histories(spec, [history])[0]))


def verify_witness(spec: Spec, history: History, witness) -> bool:
    """Replay a claimed linearization independently of any search.

    ``witness`` is a list of ``(op_index, resp)`` pairs in linearization
    order.  Valid iff every non-pending op appears exactly once (a pending
    op at most once; unlisted means it never took effect), real-time
    precedence is respected, listed resps match each non-pending op's own
    response, and every step's postcondition holds from the initial state.
    """
    ops = history.ops
    n = len(ops)
    prec = history.precedes_matrix()
    listed = [j for j, _ in witness]
    if len(set(listed)) != len(listed):
        return False  # an op linearized twice
    if not all(0 <= j < n for j in listed):
        return False
    required = {j for j in range(n) if not ops[j].is_pending}
    if required - set(listed):
        return False  # a completed op never linearized
    taken = [False] * n
    state = list(int(v) for v in spec.initial_state())
    for j, resp in witness:
        if ops[j].is_pending:
            if not 0 <= resp < spec.CMDS[ops[j].cmd].n_resps:
                return False  # completion outside the response domain
        elif resp != ops[j].resp:
            return False
        for i in range(n):
            if prec[i, j] and not taken[i]:
                return False  # linearized before a real-time predecessor
        state, ok = spec.step_py(state, ops[j].cmd, ops[j].arg, resp)
        state = list(state)
        if not ok:
            return False
        taken[j] = True
    return True
