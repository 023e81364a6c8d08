"""The persistent device-work queue: bank device-worthy work for a drain.

The counterpart of the JAX package's ``qsm_tpu/devq/queue.py``, with its
item format and fingerprints.  Planes bank device-worthy work at their
seams:

* ``check``   — serve admission banks oversize corpora;
* ``pcomp``   — the server's per-key split banks its sub-lane groups;
* ``shrink``  — a shrink round banks its still-undecided frontier;
* ``monitor`` — a session's flip banks the whole stream's re-check;
* ``warmup``  — the planner banks a warm-up item whenever it builds a
  mesh-sized plan (as the reference does) or a plan for the card,

and the drain scheduler (:mod:`.drain`) spends a device window on the
backlog, banking every verdict under the ``serve.cache.fingerprint_key``
the originating plane will look up next.

Persistence is a second replog row domain: the queue owns its own
:class:`~qsm_tpu_torch.fleet.replog.SegmentedLog`, with two row shapes
keyed by the item fingerprint::

    {"key": K, "plane": P, "item": {…}}      # banked work
    {"key": K, "done": 1}                    # drained (tombstone)

``done`` is absorbing: whichever of the two rows a node sees first, the
item converges to done, so replication is order-free.  Without a
directory the queue lives in memory only.  The in-memory index is
capped (``cap``, lowest-score eviction).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

#: Work planes, in starvation-accounting order.  ``warmup`` is the only
#: plane whose items carry no lanes (the work is the compile itself).
PLANES = ("check", "pcomp", "shrink", "monitor", "warmup")

#: In-memory pending cap.  Disk rows are unbounded-by-design (the replog
#: seals and gossips them); the cap bounds what one window host indexes.
DEFAULT_CAP = 512

# the done-tombstone index keeps this many keys beyond the pending cap;
# older tombstones fall back to the disk rows (re-adopting one costs a
# redundant re-check, never a wrong verdict)
_DONE_FACTOR = 4


def _stable_sha(doc) -> str:
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=list).encode()
    ).hexdigest()


def item_fingerprint(plane: str, model: str, spec_kwargs: dict,
                     lane_keys: Sequence[str]) -> str:
    """The queue row identity: plane + spec identity + the exact verdict
    row keys the drain will bank.  Two nodes banking the same corpus
    derive the same key — anti-entropy dedupes instead of double-work."""
    return _stable_sha([plane, model, spec_kwargs or {}, list(lane_keys)])


@dataclass
class WorkItem:
    """One banked unit of device-worthy work.

    ``lanes`` are wire-format history rows (serve/protocol.py
    ``history_to_rows``) and ``lane_keys[i]`` is the
    ``fingerprint_key`` of lane ``i`` — computed by the ORIGINATING
    plane, so the drain banks back under identities the plane's next
    request will actually hit (drain.py re-derives and refuses on
    mismatch rather than banking under a guessed key)."""

    key: str
    plane: str
    model: str
    spec_kwargs: dict = field(default_factory=dict)
    lanes: List[list] = field(default_factory=list)
    lane_keys: List[str] = field(default_factory=list)
    bucket: int = 1            # compile-bucket size proxy (score input)
    enq_ts: float = 0.0        # bank time (staleness input)
    node: str = "n0"           # originating fleet node

    def to_doc(self) -> dict:
        return {"key": self.key, "plane": self.plane,
                "model": self.model, "spec_kwargs": self.spec_kwargs,
                "lanes": self.lanes, "lane_keys": self.lane_keys,
                "bucket": self.bucket, "enq_ts": self.enq_ts,
                "node": self.node}

    @classmethod
    def from_doc(cls, doc: dict) -> "WorkItem":
        if doc.get("plane") not in PLANES:
            raise ValueError(f"devq item plane {doc.get('plane')!r} "
                             f"not in {PLANES}")
        return cls(key=str(doc["key"]), plane=doc["plane"],
                   model=str(doc.get("model", "")),
                   spec_kwargs=dict(doc.get("spec_kwargs") or {}),
                   lanes=[list(r) for r in doc.get("lanes") or []],
                   lane_keys=[str(k) for k in doc.get("lane_keys") or []],
                   bucket=int(doc.get("bucket", 1)),
                   enq_ts=float(doc.get("enq_ts", 0.0)),
                   node=str(doc.get("node", "n0")))


class DeviceWorkQueue:
    """Fingerprint-keyed, priority-scored, capped, optionally persistent.

    ``dir`` is the devq replog directory (None = memory-only, which the
    in-process seams use under tests); ``drained_planes`` feeds the
    starvation term of :meth:`score` and is updated by the drain
    scheduler via :meth:`note_drained`.
    """

    def __init__(self, dir: Optional[str] = None, *, node_id: str = "n0",
                 cap: int = DEFAULT_CAP, seal_rows: int = 64,
                 now=time.time):
        self.node_id = node_id
        self.cap = int(cap)
        self._now = now
        self._lock = threading.RLock()
        self._pending: Dict[str, WorkItem] = {}
        self._done: "OrderedDict[str, None]" = OrderedDict()
        self._drained_planes: Dict[str, int] = {p: 0 for p in PLANES}
        self.banked = 0       # puts accepted (fresh keys)
        self.evicted = 0      # cap evictions (lowest score first)
        self.log = None
        if dir is not None:
            from ..fleet.replog import SegmentedLog

            self.log = SegmentedLog(dir, node_id=node_id,
                                    seal_rows=seal_rows)
            self._fold_rows(self.log.load(), persist=False)

    # -- banking ----------------------------------------------------------
    def put(self, item: WorkItem, persist: bool = True) -> bool:
        """Bank one item; False when its key is already pending or
        drained (idempotent — the wire op and gossip both re-deliver)."""
        with self._lock:
            if item.key in self._done or item.key in self._pending:
                return False
            if not item.enq_ts:
                item.enq_ts = float(self._now())
            self._pending[item.key] = item
            self.banked += 1
            if persist and self.log is not None:
                self.log.append([json.dumps(
                    {"key": item.key, "plane": item.plane,
                     "item": item.to_doc()}, sort_keys=True)])
            self._evict_over_cap()
            return True

    def put_doc(self, doc: dict) -> bool:
        return self.put(WorkItem.from_doc(doc))

    def mark_done(self, key: str, persist: bool = True) -> bool:
        """Absorbing tombstone: the item never re-dispatches here, and
        the row gossips so it never re-dispatches ANYWHERE."""
        with self._lock:
            item = self._pending.pop(key, None)
            fresh = key not in self._done
            self._done[key] = None
            self._trim_done()
            if item is not None:
                self._drained_planes[item.plane] = (
                    self._drained_planes.get(item.plane, 0) + 1)
            if fresh and persist and self.log is not None:
                self.log.append([json.dumps(
                    {"key": key, "done": 1}, sort_keys=True)])
            return fresh

    def note_drained(self, plane: str, n: int = 1) -> None:
        with self._lock:
            self._drained_planes[plane] = (
                self._drained_planes.get(plane, 0) + int(n))

    def _evict_over_cap(self) -> None:
        # lowest score goes first: the cap sheds the work a window would
        # drain LAST anyway.  Never evicts below cap; lint family (o)
        # pins that this comparison + pop exist (QSM-DEVQ-UNBOUNDED).
        while len(self._pending) > self.cap:
            now = float(self._now())
            worst = min(self._pending,
                        key=lambda k: self.score(self._pending[k], now))
            self._pending.pop(worst)
            self.evicted += 1

    def _trim_done(self) -> None:
        limit = self.cap * _DONE_FACTOR
        while len(self._done) > limit:
            self._done.popitem(last=False)

    # -- scoring / draining ----------------------------------------------
    def score(self, item: WorkItem, now: Optional[float] = None) -> float:
        """bucket × staleness × plane starvation (the drain order):
        big compile buckets amortize the window best, old items first
        within a bucket class, and a plane nothing has drained yet beats
        one already served this window."""
        if now is None:
            now = float(self._now())
        staleness = 1.0 + max(0.0, now - item.enq_ts) / 60.0
        starvation = 1.0 / (1.0 + self._drained_planes.get(item.plane, 0))
        return float(max(1, item.bucket)) * staleness * starvation

    def pending_items(self) -> List[WorkItem]:
        """Snapshot in drain order (score descending, key tiebreak)."""
        with self._lock:
            now = float(self._now())
            return sorted(self._pending.values(),
                          key=lambda it: (-self.score(it, now), it.key))

    def get(self, key: str) -> Optional[WorkItem]:
        with self._lock:
            return self._pending.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- anti-entropy surface ---------------------------------------------
    # Delegates to the underlying SegmentedLog; gossip treats the devq
    # log exactly like the verdict replog (digest → missing → pull →
    # adopt), then folds adopted rows into the live index here.
    def digests(self) -> Dict[str, str]:
        return self.log.digests() if self.log is not None else {}

    def missing(self, remote: Dict[str, str]) -> List[str]:
        return self.log.missing(remote) if self.log is not None else []

    def read_segment(self, name: str):
        if self.log is None:
            raise KeyError(name)
        return self.log.read_segment(name)

    def adopt(self, name: str, fingerprint: str,
              lines: Sequence[str]) -> int:
        """Adopt a remote devq segment: verify + persist via the log,
        then fold the rows into the live index (done rows ABSORB —
        arrival order across segments does not matter)."""
        if self.log is None:
            return 0
        rows = self.log.adopt(name, fingerprint, lines)
        return self._fold_rows(rows, persist=False)

    def _fold_rows(self, rows: Sequence[dict], persist: bool) -> int:
        folded = 0
        for row in rows:
            key = str(row.get("key"))
            if row.get("done"):
                if self.mark_done(key, persist=persist):
                    folded += 1
            elif isinstance(row.get("item"), dict):
                try:
                    item = WorkItem.from_doc(row["item"])
                except (KeyError, ValueError, TypeError):
                    continue  # foreign/corrupt row: skip, never wedge
                if self.put(item, persist=persist):
                    folded += 1
        return folded

    # -- accounting --------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            by_plane: Dict[str, int] = {}
            for it in self._pending.values():
                by_plane[it.plane] = by_plane.get(it.plane, 0) + 1
            return {"pending": len(self._pending),
                    "pending_by_plane": by_plane,
                    "done": len(self._done),
                    "banked": self.banked, "evicted": self.evicted,
                    "drained_by_plane": dict(self._drained_planes),
                    "cap": self.cap,
                    "persistent": self.log is not None}


# ---------------------------------------------------------------------------
# The process-global queue: how in-engine seams (planner build_backend,
# shrink rounds, monitor appends) reach a queue the serve layer owns —
# the same set_global pattern obs uses for its recorder.
_GLOBAL: Optional[DeviceWorkQueue] = None
_GLOBAL_LOCK = threading.Lock()


def set_global_devq(queue: Optional[DeviceWorkQueue]) -> None:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = queue


def global_devq() -> Optional[DeviceWorkQueue]:
    return _GLOBAL


def bank_histories(spec, histories, *, plane: str,
                   queue: Optional[DeviceWorkQueue] = None,
                   bucket: Optional[int] = None,
                   node: Optional[str] = None) -> Optional[str]:
    """Bank a (spec, histories) corpus as ONE item; the convenience every
    plane seam calls.  No-ops (None) when no queue is configured — the
    seams must cost nothing on the ordinary host path."""
    q = queue if queue is not None else global_devq()
    if q is None or not histories:
        return None
    from ..serve.cache import fingerprint_key
    from ..serve.protocol import history_to_rows

    lane_keys = [fingerprint_key(spec, h) for h in histories]
    kwargs = spec.spec_kwargs()
    key = item_fingerprint(plane, spec.name, kwargs, lane_keys)
    item = WorkItem(
        key=key, plane=plane, model=spec.name, spec_kwargs=kwargs,
        lanes=[history_to_rows(h) for h in histories],
        lane_keys=lane_keys,
        bucket=bucket if bucket is not None
        else max(len(h.ops) for h in histories),
        node=node or q.node_id)
    q.put(item)
    return key


def note_device_plan(spec, plan) -> Optional[str]:
    """Planner seam (``search/planner.py::build_backend``): a mesh-sized
    plan (``@meshN``), as in the reference, or a plan for the card
    (``cuda-h100-v1``) says the device pays, so a ``warmup`` item is
    banked, keyed by the plan's name and mesh width (no lanes; the drain
    builds the plan's checker and decides a deterministic smoke corpus
    through it)."""
    from ..search.planner import CUDA_PLAN

    q = global_devq()
    name = str(getattr(plan, "name", ""))
    if q is None or (getattr(plan, "mesh_devices", 1) <= 1
                     and name != CUDA_PLAN):
        return None
    kwargs = spec.spec_kwargs()
    key = item_fingerprint("warmup", spec.name, kwargs,
                           [plan.name, str(plan.mesh_devices)])
    q.put(WorkItem(key=key, plane="warmup", model=spec.name,
                   spec_kwargs=kwargs,
                   bucket=max(plan.batch_buckets or (1,)),
                   node=q.node_id))
    return key
