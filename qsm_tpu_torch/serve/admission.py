"""Admission control — bounded load, explicit shedding.

The counterpart of the JAX package's ``qsm_tpu/serve/admission.py``,
over this package's ``resilience/policy.py`` presets.

The serving plane's failure mode under overload must be a fast, honest
``SHED`` response, never silent latency collapse (a queue that grows
without bound converts overload into unbounded tail latency and then
into wrong-looking timeouts for EVERY client).  One controller instance
gates the whole server:

* **Bounded in-flight lanes** — ``try_admit(n)`` reserves ``n`` history
  lanes against ``queue_depth`` or refuses atomically (no partial
  admission: a request is whole or shed).
* **Per-request deadline** — defaulted from the ``serve``
  :data:`~qsm_tpu_torch.resilience.policy.PRESETS` entry (ONE timeout table
  for the whole stack); a request past its deadline is answered
  ``SHED``, and its still-in-flight lanes complete into the verdict
  cache rather than being wasted.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..resilience.policy import RetryPolicy, preset


class AdmissionController:
    """Lane accounting + shed counters (one site the server and the
    ``stats`` op both read).

    ``pool_state`` (optional) is a zero-arg provider of the worker
    pool's compact health block (``serve/pool.py shed_state``).  When
    set, every SHED response carries it: "queue full" against a pool
    running 1-of-4 workers is a degradation story, not an overload
    story, and the client deciding whether to back off or fail over
    needs to tell them apart.

    ``fleet_state`` (optional) is the fleet tier's twin
    (``fleet/membership.py shed_state``): a router's SHED under
    cross-fleet backpressure carries the per-node health block — live/
    quarantined node counts and the shedding node's own id — so "the
    fleet is overloaded" and "the fleet is down to one node" read
    differently to the client and the operator.
    """

    def __init__(self, queue_depth: int = 1024,
                 policy: Optional[RetryPolicy] = None,
                 pool_state: Optional[Callable[[], dict]] = None,
                 fleet_state: Optional[Callable[[], dict]] = None):
        self.queue_depth = queue_depth
        self.policy = policy or preset("serve")
        self.pool_state = pool_state
        self.fleet_state = fleet_state
        self._lock = threading.Lock()
        self.in_flight = 0
        self.peak_in_flight = 0
        self.admitted_lanes = 0
        self.completed_lanes = 0
        self.shed_queue = 0     # requests refused at admission (full)
        self.shed_deadline = 0  # requests answered SHED past deadline

    # ------------------------------------------------------------------
    def deadline_for(self, deadline_s: Optional[float]) -> float:
        """Absolute monotonic deadline for a request; ``None`` takes the
        preset's default."""
        d = self.policy.deadline_s if deadline_s is None else deadline_s
        return time.monotonic() + max(0.0, float(d))

    def try_admit(self, n_lanes: int) -> bool:
        with self._lock:
            if self.in_flight + n_lanes > self.queue_depth:
                self.shed_queue += 1
                return False
            self.in_flight += n_lanes
            self.peak_in_flight = max(self.peak_in_flight, self.in_flight)
            self.admitted_lanes += n_lanes
            return True

    def release(self, n_lanes: int = 1) -> None:
        with self._lock:
            self.in_flight -= n_lanes
            self.completed_lanes += n_lanes

    def shed_late(self) -> None:
        """Count a deadline shed (the lanes release on completion)."""
        with self._lock:
            self.shed_deadline += 1

    def shed_doc(self, req_id, reason: str, trace: Optional[str] = None,
                 flight: Optional[str] = None) -> dict:
        """THE shed response payload (serve/protocol.py's refusal
        contract): explicit reason, plus the pool-state block when a
        worker pool serves this plane.  ``trace`` is the request's
        trace id and ``flight`` the most recent flight-recorder dump
        path (when one fired) — a shed client hands the operator
        something actionable, not a bare SHED."""
        doc = {"id": req_id, "ok": False, "shed": True, "reason": reason}
        if trace:
            doc["trace"] = trace
        if flight:
            doc["flight"] = flight
        if self.pool_state is not None:
            state = self.pool_state()
            if state:
                doc["pool"] = state
        if self.fleet_state is not None:
            state = self.fleet_state()
            if state:
                doc["fleet"] = state
        return doc

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            snap = {"queue_depth": self.queue_depth,
                    "in_flight": self.in_flight,
                    "peak_in_flight": self.peak_in_flight,
                    "admitted_lanes": self.admitted_lanes,
                    "completed_lanes": self.completed_lanes,
                    "shed_queue": self.shed_queue,
                    "shed_deadline": self.shed_deadline,
                    "policy": self.policy.name}
        if self.pool_state is not None:
            state = self.pool_state()
            if state:
                snap["pool"] = state
        if self.fleet_state is not None:
            state = self.fleet_state()
            if state:
                snap["fleet"] = state
        return snap
