"""Cross-request adaptive micro-batching — N clients, one dispatch.

The counterpart of the JAX package's ``qsm_tpu/serve/batcher.py``, with
its flush policy.  A device checker decides many histories in one
backend call; per-request dispatch throws that away the moment checking
becomes a service.  The batcher coalesces history
lanes arriving from concurrent connections into one padded batch per
(spec, flush window), exactly the compile-bucket discipline
``core/property.py`` uses for trial groups: the batch is padded to a
FIXED lane width with empty (instantly-SUCCESS) histories so every
dispatch hits the same compiled executable, and ops are padded to the
shared ``OP_BUCKETS`` inside the engine as always.

Flush policy (first match wins, per spec group):

* ``full``     — the group reached ``max_lanes``: dispatch now;
* ``deadline`` — the earliest request deadline in the group is within
  one flush window: dispatch early rather than shed late;
* ``target``   — concurrent-dispatch mode only (``concurrency > 1``,
  the worker-pool server): the group reached the per-worker flush
  target ``lanes_target`` AND a dispatch slot is idle.  Waiting to
  fill ``max_lanes`` while workers sit idle trades the pool's whole
  point (parallel checking) for batch occupancy; under load every
  slot is busy, ``target`` stops firing, and groups grow to ``full``
  again — the batch width adapts to pool pressure by itself;
* ``interval`` — the oldest lane has waited ``flush_s``: latency floor
  for lonely clients;
* ``close``    — server shutdown drains every group.

With ``concurrency = 1`` (no pool) dispatch runs inline on the loop
thread, exactly the single-process behavior every pre-pool artifact
measured.  With a pool, flushes ride a BOUNDED hand-off queue to
``concurrency`` dispatcher threads (full queue ⇒ the group keeps
coalescing — backpressure, never a drop, never unbounded buffering).

Every batch carries a ``why`` provenance stamp (batch id, lane count,
width, occupancy, flush reason) that rides the responses of every
request in the batch and aggregates into ``qsm-tpu stats`` — the same
self-describing-artifact discipline as the planner's ``why`` and the
resilience counters.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.history import History


@dataclasses.dataclass
class Lane:
    """One history awaiting a verdict (the unit the batcher coalesces)."""

    key: str                 # verdict-cache fingerprint key
    history: History
    deadline: float          # absolute monotonic deadline of its request
    resolve: Callable        # resolve(verdict:int, batch_stamp:dict)
    # P-compositional sub-lane: this lane is one per-key sub-history of a
    # longer request history (server split it — serve/server.py).  Rides
    # the batch `why` stamp so a micro-batch says how many of its lanes
    # came from decomposition.
    pcomp: bool = False
    # trace plane (obs): the request's trace id and the span id
    # this lane's batch events parent under — how a micro-batch lands in
    # the right place of `qsm-tpu trace <id>`'s causal tree.  Empty when
    # tracing is off (the default); the batcher itself never reads them.
    trace: str = ""
    span: str = ""


class _Group:
    __slots__ = ("lanes", "first_ts")

    def __init__(self):
        self.lanes: List[Lane] = []
        self.first_ts = time.monotonic()


class MicroBatcher:
    """Coalesce lanes per spec group.  With ``concurrency = 1`` one
    loop thread also dispatches (the historical single-process shape);
    with a worker pool, ``concurrency`` dispatcher threads run flushes
    in parallel — engine access is then serialized per spec entry by
    the SERVER (``server.py _EngineEntry.dispatch_lock``; pool workers
    own their engines outright), never assumed here."""

    def __init__(self, dispatch: Callable[[str, List[Lane], dict], None],
                 max_lanes: int = 64, flush_s: float = 0.02,
                 queue_depth: int = 4096, concurrency: int = 1,
                 lanes_target: Optional[int] = None,
                 mesh_devices: int = 1):
        self._dispatch = dispatch
        self.flush_s = flush_s
        self.concurrency = max(1, int(concurrency))
        # mesh-aware flush target (mesh/): when the engine under
        # _dispatch shards its lane axis over N devices, every flushed
        # width must divide by N or the padded batch shards raggedly —
        # so max_lanes and lanes_target round UP to mesh multiples, and
        # one dispatch fills the whole mesh instead of one device
        self.mesh_devices = max(1, int(mesh_devices))
        self.max_lanes = self._mesh_ceil(max_lanes)
        # per-worker flush target: with N dispatch slots, a burst of
        # lanes splits into N parallel batches instead of one serial
        # max_lanes batch (the pool's scaling shape); 1 slot keeps the
        # historical fill-to-max_lanes behavior
        if lanes_target is not None:
            self.lanes_target = self._mesh_ceil(lanes_target)
        elif self.concurrency > 1:
            self.lanes_target = self._mesh_ceil(
                max(1, self.max_lanes // self.concurrency))
        else:
            self.lanes_target = self.max_lanes
        # bounded by contract (QSM-SERVE-UNBOUNDED): admission gates
        # in-flight lanes above this, so a full queue means misconfig,
        # and submit() fails fast instead of growing memory
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        # flush hand-off to the dispatcher threads — bounded so pool
        # pressure backs groups up into BIGGER batches, not into memory
        self._flush_q: Optional["queue.Queue"] = (
            queue.Queue(maxsize=max(2, self.concurrency * 2))
            if self.concurrency > 1 else None)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dispatchers: List[threading.Thread] = []
        self._in_flight = 0
        self._if_lock = threading.Lock()
        self.batches = 0
        self.lanes_dispatched = 0
        self.width_dispatched = 0  # Σ padded widths (occupancy denominator)

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="qsm-serve-batcher")
        self._thread.start()
        if self._flush_q is not None:
            for i in range(self.concurrency):
                t = threading.Thread(target=self._dispatch_loop,
                                     daemon=True,
                                     name=f"qsm-serve-dispatch-{i}")
                t.start()
                self._dispatchers.append(t)

    def stop(self, drain_timeout_s: float = 10.0) -> None:
        t_end = time.monotonic() + drain_timeout_s
        self._stop.set()
        if self._thread is not None:
            self._thread.join(drain_timeout_s)
        if self._flush_q is not None:
            # one sentinel per dispatcher, AFTER the loop thread drained
            # its groups into the flush queue; puts are bounded — the
            # dispatchers are consuming, so Full only means still-busy.
            # The window gets a floor: a loop-thread join that ate the
            # whole drain budget must not starve sentinel delivery
            # (dispatchers also self-terminate — _dispatch_loop — so a
            # lost sentinel degrades to a slower exit, never a leak)
            t_sent = max(t_end, time.monotonic() + 1.0)
            for _ in self._dispatchers:
                while time.monotonic() < t_sent:
                    try:
                        self._flush_q.put(None, timeout=0.25)
                        break
                    except queue.Full:
                        continue
            for t in self._dispatchers:
                t.join(max(0.5, t_end - time.monotonic()))

    def _mesh_ceil(self, n: int) -> int:
        """Smallest multiple of ``mesh_devices`` holding ``n`` lanes."""
        m = self.mesh_devices
        return max(1, int(n)) if m == 1 else -(-max(1, int(n)) // m) * m

    def submit(self, group_key: str, lane: Lane) -> bool:
        """Enqueue one lane; False when the (bounded) queue is full —
        the caller sheds the request."""
        try:
            self._q.put((group_key, lane), block=False)
            return True
        except queue.Full:
            return False

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        groups: Dict[str, _Group] = {}
        # drain everything before exiting: lanes admitted pre-stop must
        # resolve (their requests hold admission slots)
        while not (self._stop.is_set() and self._q.empty() and not groups):
            try:
                group_key, lane = self._q.get(timeout=self.flush_s / 2
                                              if self.flush_s > 0 else 0.01)
            except queue.Empty:
                pass
            else:
                groups.setdefault(group_key, _Group()).lanes.append(lane)
            now = time.monotonic()
            for key in list(groups):
                g = groups[key]
                reason = self._flush_reason(g, now)
                if reason is None:
                    continue
                if self._flush_q is None:
                    del groups[key]
                    self._flush(key, g.lanes, reason)
                elif self._try_enqueue(key, g.lanes, reason):
                    del groups[key]
                # else: hand-off queue full — the group stays and keeps
                # coalescing (backpressure into bigger batches)
        for key, g in list(groups.items()):
            if self._flush_q is None:
                self._flush(key, g.lanes, "close")
            else:
                self._enqueue_blocking(key, g.lanes, "close")

    def _flush_reason(self, g: _Group, now: float) -> Optional[str]:
        if len(g.lanes) >= self.max_lanes:
            return "full"
        if self._stop.is_set():
            return "close"
        if g.lanes and min(l.deadline for l in g.lanes) - now <= self.flush_s:
            return "deadline"
        if (self._flush_q is not None
                and len(g.lanes) >= self.lanes_target
                and self._idle_slots() > 0):
            return "target"
        if now - g.first_ts >= self.flush_s:
            return "interval"
        return None

    def _idle_slots(self) -> int:
        with self._if_lock:
            in_flight = self._in_flight
        return self.concurrency - in_flight - self._flush_q.qsize()

    def _try_enqueue(self, key: str, lanes: List[Lane],
                     reason: str) -> bool:
        try:
            self._flush_q.put_nowait((key, lanes, reason))
            return True
        except queue.Full:
            return False

    def _enqueue_blocking(self, key: str, lanes: List[Lane],
                          reason: str, timeout_s: float = 60.0) -> None:
        """Close-path hand-off: bounded blocking (the dispatchers are
        draining); past the bound the lanes resolve BUDGET_EXCEEDED
        rather than hang their requests."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            try:
                self._flush_q.put((key, lanes, reason), timeout=0.25)
                return
            except queue.Full:
                continue
        for lane in lanes:
            try:
                lane.resolve(2, {"flush": reason, "error": "drain timeout"})
            except Exception:  # noqa: BLE001 — resolver must not re-kill
                pass

    def _dispatch_loop(self) -> None:
        while True:
            try:
                item = self._flush_q.get(timeout=0.5)
            except queue.Empty:
                # self-termination: once stop() ran and the loop thread
                # (the only producer) is gone, an empty queue is final —
                # a dispatcher must not park forever waiting for a
                # sentinel that stop()'s bounded window failed to deliver
                if (self._stop.is_set() and self._thread is not None
                        and not self._thread.is_alive()):
                    return
                continue
            if item is None:
                return
            with self._if_lock:
                self._in_flight += 1
            try:
                self._flush(*item)
            finally:
                with self._if_lock:
                    self._in_flight -= 1

    def _flush(self, group_key: str, lanes: List[Lane], reason: str) -> None:
        # width is FIXED at max_lanes so every dispatch hits the same
        # compiled executable (core/property.py's padding lesson); a
        # group can never exceed it (lanes arrive one per loop turn),
        # but never drop a lane even if that invariant breaks — and the
        # overflow fallback still pads to a mesh-divisible width
        width = max(self.max_lanes, self._mesh_ceil(len(lanes)))
        with self._if_lock:  # dispatcher threads share these counters
            self.batches += 1
            batch_id = self.batches
            self.lanes_dispatched += len(lanes)
            self.width_dispatched += width
        why = {"batch": batch_id, "lanes": len(lanes), "width": width,
               "occupancy": round(len(lanes) / width, 3), "flush": reason}
        n_pcomp = sum(1 for lane in lanes if lane.pcomp)
        if n_pcomp:
            # decomposed lanes flattened into this micro-batch — the
            # stamp keeps split traffic distinguishable from whole-lane
            # traffic in every response and `qsm-tpu stats` aggregate
            why["pcomp_lanes"] = n_pcomp
        try:
            self._dispatch(group_key, lanes, why)
        except Exception as e:  # noqa: BLE001 — the loop thread must survive
            # an undispatchable batch resolves BUDGET_EXCEEDED (honest
            # "not decided", never a guess) so its requests don't hang
            # to their deadlines and the batcher keeps serving
            for lane in lanes:
                try:
                    lane.resolve(2, {**why, "error":
                                     f"{type(e).__name__}: {e}"[:200]})
                except Exception:  # noqa: BLE001 — resolver must not re-kill
                    pass

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._if_lock:
            in_flight = self._in_flight
        return {"batches": self.batches,
                "lanes": self.lanes_dispatched,
                "mean_occupancy": round(
                    self.lanes_dispatched / self.width_dispatched, 3)
                if self.width_dispatched else 0.0,
                "max_lanes": self.max_lanes,
                "flush_s": self.flush_s,
                "concurrency": self.concurrency,
                "lanes_target": self.lanes_target,
                "mesh_devices": self.mesh_devices,
                "in_flight": in_flight}
