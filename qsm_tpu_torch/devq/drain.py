"""The drain scheduler: spend a device window on the queue.

The counterpart of the JAX package's ``qsm_tpu/devq/drain.py``.  It
drains the banked :class:`~qsm_tpu_torch.devq.queue.DeviceWorkQueue` in
score order until the queue is empty or the window's deadline passes:

* **The window is a deadline.**  On the card there is no rare device
  window to seize: the caller gives the drain a length (``window_s``) or
  an end (``window_end``), and every loop iteration reads the time left.
* **The window's mesh.**  Batches go to the planned checker whose lane
  axis spans the window's devices
  (``mesh/dispatch.py::sharded_backend``), the mesh built from the
  device list the drain was handed (``mesh_from_devices``), never from
  a count over the machine: every CUDA card when None, logical host
  devices for ``devices=["cpu"]`` (or ``mesh.host_devices(n)``); without
  a card the constructor raises ``BackendUnavailable``.
* **The device never gets the last word.**  Every drained verdict is
  re-proved by a fresh host memo oracle (``WingGongCPU(memo=True)``)
  before it is banked; the banked verdict is the oracle's, under the
  ``fingerprint_key`` the originating plane computed at bank time
  (re-derived here, refused on mismatch).  A device/oracle disagreement
  counts in ``wrong_verdicts``.
* **The card's rule.**  The reference drops the rest of a window to the
  host ladder when a device dispatch raises.  Here that holds on the CPU
  and, on the card, for an injected fault only
  (``resilience/failover.py::degradable_errors``); a real device error
  raises out of :meth:`DrainScheduler.drain`.  An item with a history
  past the device checker's op cap (``ops/stepper_kernel.py::MAX_OPS``)
  takes the host path at once: the reference's device path raises on it
  and drops the window to the host, the port's routes it.
* **Exactly once.**  Each item is a
  :class:`~qsm_tpu_torch.resilience.checkpoint.CellJournal` cell keyed by
  its queue fingerprint: a killed drainer's successor folds completions
  from the journal and re-dispatches none of them.
* **Accounting.**  Per-plane device-vs-host ratios (the host re-proof is
  the matched host baseline) and ``window_utilization`` (the share of the
  drain's wall clock spent dispatching and proving), which the server's
  ``health`` verb reports as an objective.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .queue import PLANES, DeviceWorkQueue, WorkItem

#: Below this many seconds of window left, stop starting new items —
#: a half-dispatched batch at window close costs more than it pays.
DEFAULT_MIN_ITEM_S = 0.05

#: Simulated/default window length when the caller gives no deadline.
DEFAULT_WINDOW_S = 30.0

#: Lanes for the deterministic warmup smoke corpus (small: the point of
#: a warmup item is the compile, the lanes just prove the executable).
_WARMUP_LANES = 4
_WARMUP_SEED = 20_000_20


class DrainScheduler:
    """One window: drain the queue, bank oracle-proved verdicts, report.

    ``devices`` is the window's device list (``mesh.MeshDevice`` objects,
    torch devices or their names; every CUDA card when None); ``mesh``
    may be passed pre-built instead.  ``cache`` is the verdict
    bank (:class:`~qsm_tpu_torch.serve.cache.VerdictCache` or anything with
    its ``put_many``); None still drains and re-proves, it just cannot
    bank.  ``journal_path`` enables kill-mid-drain resume."""

    def __init__(self, queue: DeviceWorkQueue, *, cache=None,
                 devices: Optional[list] = None, mesh=None,
                 window_s: Optional[float] = None,
                 window_end: Optional[float] = None,
                 journal_path: Optional[str] = None,
                 window_id: str = "w0", resume: bool = False,
                 budget: int = 2_000,
                 min_item_s: float = DEFAULT_MIN_ITEM_S,
                 device_dispatch: bool = True,
                 now=time.monotonic):
        self.queue = queue
        self.cache = cache
        self.budget = int(budget)
        self.min_item_s = float(min_item_s)
        self.window_id = window_id
        self._now = now
        from ..mesh.topology import (batch_sharding, lane_devices,
                                     local_devices, mesh_from_devices)
        from ..resilience.failover import degradable_errors

        if mesh is None:
            if devices is None:
                devices = local_devices()
            mesh = mesh_from_devices(devices)
        self.mesh = mesh
        self.n_devices = int(mesh.size)
        self.device = lane_devices(batch_sharding(mesh))[0].device
        # the card's rule: on CUDA only an injected fault degrades the
        # window to the host ladder; on the CPU any error does, as in the
        # reference
        self._degradable = ((Exception,) if self.device.type == "cpu"
                            else degradable_errors(True))
        if window_end is None:
            window_end = float(now()) + float(window_s if window_s
                                              is not None
                                              else DEFAULT_WINDOW_S)
        self.window_end = float(window_end)
        from ..ops.stepper_kernel import MAX_OPS

        self.max_ops = MAX_OPS
        # flips False the first time the device path raises: the rest of
        # the window degrades to the host ladder instead of retrying a
        # chip the scheduler no longer owns
        self._device_ok = bool(device_dispatch)
        # ONE spec instance per (model, kwargs): the cached backends are
        # spec-BOUND (CppOracle asserts identity), so every item of the
        # same shape must hand them the same instance back
        self._specs: Dict[str, object] = {}
        self._backends: Dict[str, object] = {}   # spec_key -> device be
        self._host: Dict[str, object] = {}       # spec_key -> host ladder
        self.journal = None
        if journal_path is not None:
            from ..resilience.checkpoint import CellJournal

            self.journal = CellJournal(
                journal_path,
                {"artifact": "qsm_tpu_devq_drain",
                 "device_fallback": None, "window_id": window_id},
                resume=resume,
                match_keys=("artifact", "window_id"))

    # ------------------------------------------------------------------
    def _remaining_s(self) -> float:
        return self.window_end - float(self._now())

    @staticmethod
    def _spec_key(item: WorkItem) -> str:
        import json as _json

        return _json.dumps([item.model, item.spec_kwargs or {}],
                           sort_keys=True)

    def _spec_for(self, item: WorkItem):
        key = self._spec_key(item)
        spec = self._specs.get(key)
        if spec is None:
            from ..models.registry import make

            spec, _ = make(item.model, "atomic", item.spec_kwargs or None)
            self._specs[key] = spec
        return spec

    def _device_backend(self, item: WorkItem, spec):
        key = self._spec_key(item)
        be = self._backends.get(key)
        if be is None:
            from ..mesh.dispatch import sharded_backend

            be = sharded_backend(spec, mesh=self.mesh, budget=self.budget)
            self._backends[key] = be
        return be

    def _host_backend(self, item: WorkItem, spec):
        key = self._spec_key(item)
        be = self._host.get(key)
        if be is None:
            from ..search.planner import build_host_backend, plan_search

            be = build_host_backend(spec, plan_search(spec,
                                                      platform="cpu"))
            self._host[key] = be
        return be

    @staticmethod
    def _lanes_of(item: WorkItem, spec):
        """Reconstruct the item's histories.  Warmup items carry none;
        their smoke corpus is rebuilt deterministically (same seeds →
        same histories → same fingerprints on every node)."""
        from ..serve.protocol import rows_to_history

        if item.plane == "warmup" and not item.lanes:
            from ..models.registry import MODELS
            from ..utils.corpus import build_corpus

            entry = MODELS[item.model]
            return build_corpus(
                spec, [entry.impls["atomic"]], _WARMUP_LANES,
                n_pids=entry.default_pids, max_ops=entry.default_ops,
                seed_base=_WARMUP_SEED, seed_prefix="devq-warmup")
        return [rows_to_history(rows) for rows in item.lanes]

    # ------------------------------------------------------------------
    def drain(self) -> dict:
        """Drain until the queue or the window is exhausted; return the
        window report."""
        t0 = float(self._now())
        started = self.queue.snapshot()
        per_plane = {p: {"items": 0, "lanes": 0, "device_items": 0,
                         "host_items": 0, "device_s": 0.0,
                         "host_s": 0.0} for p in PLANES}
        dispatched: List[str] = []
        resumed: List[str] = []
        busy_s = 0.0
        wrong = key_mismatch = banked = 0
        deadline_stopped = False
        while True:
            remaining = self._remaining_s()
            if remaining <= self.min_item_s:
                deadline_stopped = len(self.queue) > 0
                break
            # re-rank every iteration: draining a plane feeds its own
            # starvation term, so the order interleaves planes instead
            # of burning the window on whichever banked the most
            items = self.queue.pending_items()
            if not items:
                break
            item = items[0]
            if self.journal is not None:
                prior = self.journal.complete(item.key)
                if prior is not None:
                    # a predecessor drained this before it was killed:
                    # fold the completion, re-dispatch NOTHING
                    self.queue.mark_done(item.key)
                    resumed.append(item.key)
                    continue
            row, item_busy = self._run_item(item, remaining)
            busy_s += item_busy
            stats = per_plane[item.plane]
            stats["items"] += 1
            stats["lanes"] += row["lanes"]
            stats[f"{row['path']}_items"] += 1
            stats["device_s"] += row["device_s"]
            stats["host_s"] += row["host_s"]
            wrong += row["wrong"]
            key_mismatch += row["key_mismatch"]
            banked += row["banked"]
            dispatched.append(item.key)
            if self.journal is not None:
                self.journal.emit(item.key, row)
            self.queue.mark_done(item.key)
        elapsed = max(1e-9, float(self._now()) - t0)
        for stats in per_plane.values():
            # host_s is the fresh-oracle re-proof of the SAME lanes: a
            # matched-budget host baseline, so the ratio is (host
            # seconds per lane) / (device seconds per lane)
            stats["device_vs_host_ratio"] = (
                round(stats["host_s"] / stats["device_s"], 6)
                if stats["device_s"] > 0 else None)
            stats["device_s"] = round(stats["device_s"], 6)
            stats["host_s"] = round(stats["host_s"], 6)
        return {
            "window_id": self.window_id,
            "devices": self.n_devices,
            "mesh_axes": list(getattr(self.mesh, "axis_names", ())),
            "device": str(self.device),
            "pending_at_open": started["pending"],
            "drained": len(dispatched),
            "dispatched": dispatched,
            "resumed": resumed,
            "deadline_stopped": deadline_stopped,
            "wrong_verdicts": wrong,
            "key_mismatches": key_mismatch,
            "banked_rows": banked,
            "per_plane": per_plane,
            "elapsed_s": round(elapsed, 3),
            "busy_s": round(busy_s, 3),
            "window_utilization": round(busy_s / elapsed, 3),
        }

    # ------------------------------------------------------------------
    def _run_item(self, item: WorkItem, remaining: float):
        """One item: device dispatch (host ladder when the window is too
        thin or the chip vanished), fresh-oracle re-proof, bank."""
        from ..ops.backend import Verdict
        from ..ops.wing_gong_cpu import WingGongCPU
        from ..serve.cache import fingerprint_key

        spec = self._spec_for(item)
        hists = self._lanes_of(item, spec)
        path, device_s = "host", 0.0
        verdicts = None
        fits = max((len(h) for h in hists), default=0) <= self.max_ops
        if self._device_ok and remaining > self.min_item_s and fits:
            t0 = float(self._now())
            try:
                be = self._device_backend(item, spec)
                verdicts = be.check_histories(spec, hists)
                path = "device"
            except self._degradable:
                # the device was lost (on the card: a fault the plane
                # injected): degrade THIS window to the host ladder and
                # keep draining; a real device error raises
                self._device_ok = False
                verdicts = None
            device_s = float(self._now()) - t0
        if verdicts is None:
            t0 = float(self._now())
            be = self._host_backend(item, spec)
            verdicts = be.check_histories(spec, hists)
            device_s = float(self._now()) - t0
            path = "host"
        # fresh memo oracle per ITEM: no state shared with the engine
        # under test, so agreement actually proves something
        t0 = float(self._now())
        oracle = WingGongCPU(memo=True)
        proofs = oracle.check_histories(spec, hists)
        host_s = float(self._now()) - t0
        undecided = int(Verdict.BUDGET_EXCEEDED)
        wrong = sum(1 for v, p in zip(verdicts, proofs)
                    if int(v) != undecided and int(v) != int(p))
        rows, key_mismatch = [], 0
        lane_keys = item.lane_keys or [None] * len(hists)
        for h, stored, proof in zip(hists, lane_keys, proofs):
            true_key = fingerprint_key(spec, h)
            if stored is not None and stored != true_key:
                # a corrupted / foreign item must not poison the bank
                # under a key some other history owns
                key_mismatch += 1
                continue
            rows.append((true_key, int(proof), None))
        if self.cache is not None and rows:
            self.cache.put_many(rows)
        return ({"plane": item.plane, "path": path, "lanes": len(hists),
                 "device_s": round(device_s, 6),
                 "host_s": round(host_s, 6),
                 "wrong": wrong, "key_mismatch": key_mismatch,
                 "banked": len(rows),
                 "verdicts": [int(p) for p in proofs]},
                device_s + host_s)
