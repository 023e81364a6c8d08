"""Hybrid device and host plan: the device decides the easy majority
under a tight budget, the exact host checker takes the tail.

The counterpart of the JAX package's ``qsm_tpu/ops/hybrid.py``.  A lane
that runs out of a small per-lane budget costs the batch every later
round trip of the device driver; the plan stops such lanes early and
hands them to the best host checker (the native C++ oracle when it
builds, else the memoised Python oracle).  That is what the property
layer does between its backend and its oracle, packaged as one backend
with counters.

Verdicts are the tail checker's own wherever the device did not decide,
and the device's decided verdicts are pinned against the oracle by the
kernel tests.  BUDGET_EXCEEDED survives only if the tail itself gives up
(its node budget).

Unlike the JAX package's plan, this one degrades to the tail on a device
error only when its device is the CPU; on the card the error raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.history import History
from ..core.spec import Spec
from .backend import Verdict, device_error_types


class HybridDevice:
    """Device majority under a tight budget; host tail for the rest.

    ``budget``: iterations a lane may run on the device before it defers
    to the tail (no mid or rescue budget).  ``tail``: any
    ``LineariseBackend``; default ``resilience.failover.host_fallback``.
    ``device_kw`` goes to :class:`~qsm_tpu_torch.ops.stepper.TorchStepper`
    (``device="cpu"`` runs its plain versions).

    On the CPU (``device="cpu"``: the device runs its kernels' plain
    versions) a device failure during a batch (an error of
    ``backend.device_error_types``) degrades the backend in place: the
    whole batch goes to the tail, later batches skip the device, and the
    ``degradations`` / ``fallback_engine`` counters record it.  On a CUDA
    device nothing degrades: a failed launch or a faulting kernel raises,
    so a broken kernel never hides behind the host checker's verdicts.
    A kernel that fails to build raises on either device."""

    name = "hybrid_device"

    def __init__(self, spec: Spec, budget: int = 2_000, tail=None,
                 **device_kw):
        from ..resilience.failover import host_fallback
        from .stepper import TorchStepper

        self.spec = spec
        self.device = TorchStepper(spec, budget=budget, mid_budget=0,
                                   rescue_budget=0, **device_kw)
        self.tail = tail if tail is not None else host_fallback(spec)
        self.tail_histories = 0   # histories the host tail decided
        self.device_decided = 0
        self.degraded = False     # device lost: tail only from now on
        self.degradations = 0
        self.fallback_engine = ""
        self.last_error = ""

    def _degradable(self) -> tuple:
        """The errors that degrade the plan: ``device_error_types`` when
        the device is the CPU, none on the card."""
        if self.device.device.type == "cuda":
            return ()
        return device_error_types()

    def _degrade(self, err: BaseException) -> None:
        self.degraded = True
        self.degradations += 1
        self.fallback_engine = getattr(self.tail, "name",
                                       type(self.tail).__name__)
        self.last_error = f"{type(err).__name__}: {err}"[:200]

    def check_histories(self, spec: Spec,
                        histories: Sequence[History]) -> np.ndarray:
        out = np.full(len(histories), int(Verdict.BUDGET_EXCEEDED),
                      np.int8)
        if not self.degraded:
            try:
                out = np.asarray(
                    self.device.check_histories(spec, histories),
                    dtype=np.int8)
            except self._degradable() as e:
                # every lane becomes a straggler: the exact tail decides
                # it, so only the engine changes, never the verdict
                self._degrade(e)
        und = np.nonzero(out == int(Verdict.BUDGET_EXCEEDED))[0]
        self.device_decided += len(histories) - und.size
        if und.size:
            tail_v = np.asarray(self.tail.check_histories(
                spec, [histories[i] for i in und]), dtype=np.int8)
            out[und] = tail_v
            self.tail_histories += int(und.size)
        return out

    def check_witness(self, spec: Spec, history: History):
        """The witness of whichever side decides the history."""
        if not self.degraded:
            try:
                v = Verdict(int(
                    self.device.check_histories(spec, [history])[0]))
                if v != Verdict.BUDGET_EXCEEDED:
                    return self.device.check_witness(spec, history)
            except self._degradable() as e:
                self._degrade(e)
        return self.tail.check_witness(spec, history)

    def resilience(self) -> dict:
        """The fault-handling record: degradations and who decided what."""
        return {
            "degradations": self.degradations,
            "retries": 0,
            "fallback_engine": self.fallback_engine or None,
            "device_histories": self.device_decided,
            "fallback_histories": self.tail_histories,
            **({"last_error": self.last_error} if self.last_error else {}),
        }
