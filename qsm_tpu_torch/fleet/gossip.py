"""Peer-to-peer anti-entropy — verdict convergence without the router.

The counterpart of the JAX package's ``qsm_tpu/fleet/gossip.py``.

A router-hubbed anti-entropy is a single point of failure: the router pulled
segment digests from every node and shipped diffs owner→lacker.  That
made the ROUTER a replication single point of failure — kill it and
banked verdicts stop converging, so the rolling-restart guarantee
silently depended on router liveness.  This module moves the exchange
onto the nodes themselves: each node runs a :class:`GossipAgent` that,
once per beat, picks a small RANDOM fan-out of peers and reconciles
replogs directly over the existing ``replog.*`` wire ops:

* ``replog.digests`` — what the peer holds (and has absorbed or
  subsumed: covered either way, never re-shipped);
* ``replog.covers``  — the row-key coverage of segments this node is
  about to pull, checked against the LOCAL live set first: a segment
  whose rows are all already held (a peer's compaction of rows we
  replicated long ago) is recorded as *subsumed* and never shipped —
  the bounded catch-up;
* ``replog.pull`` / ``replog.push`` — whole-segment transfer,
  fingerprint-verified and idempotent, push gated by the peer's own
  ``replog.subsumed`` answer so the wire never carries rows the
  receiver already has.

Work per beat is bounded three ways: ``fanout`` peers, ``max_segments``
per direction per peer, and the ``gossip``
:data:`~qsm_tpu_torch.resilience.policy.PRESETS` entry's per-exchange
timeout and per-sweep deadline.  Convergence: one exchange merges two
nodes' sealed sets completely (both directions), so a fleet of N
nodes converges in O(diameter) beats — with ``fanout >= peers`` every
node pairs with every other each beat and the fleet converges in at
most 2 beats (tests/test_torch_fleet_ha.py pins the bound).  Peers that
fail an exchange are excluded for the rest of the sweep (the
``tried`` discipline the JAX package's lint family (j) gates) and retried next beat.

Wiring: :class:`~qsm_tpu_torch.serve.server.CheckServer` owns one agent when
started with ``peers=``/``gossip_s=`` (CLI ``serve --peers a,b
--gossip-s 2``), and the ``gossip.peers`` server op (re)configures the
peer set at runtime — ``python -m qsm_tpu_torch fleet`` uses it to wire spawned nodes
whose addresses are only known after their banners.  The router's own
sweep remains as a second, optional reconciliation path; with every
router dead, gossip alone keeps the fleet's banks converging
(the chip smoke's fleet phase converges two nodes with no router)."""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..resilience.policy import RetryPolicy, preset


class GossipAgent:
    """One node's peer-exchange loop (see module docstring).

    ``peers`` is a sequence of ``(peer_id, address)`` pairs (or bare
    address strings — the address then doubles as the id); the node's
    own id is filtered out so a config listing the whole fleet can be
    handed to every member verbatim."""

    def __init__(self, node_id: str, replog, cache, *,
                 peers: Optional[Sequence] = None,
                 policy: Optional[RetryPolicy] = None,
                 fanout: int = 2,
                 interval_s: float = 2.0,
                 max_segments: int = 16,
                 obs=None,
                 devq=None,
                 rng: Optional[random.Random] = None):
        self.node_id = str(node_id)
        self.replog = replog
        self.cache = cache
        # the device-work queue (qsm_tpu_torch/devq): when this node runs
        # one, every exchange reconciles its segment log too over the
        # devq.* ops — banked work AND done tombstones converge
        # fleet-wide, so any node's window drains everyone's backlog
        self.devq = devq
        self.policy = policy or preset("gossip")
        self.fanout = max(1, int(fanout))
        self.interval_s = float(interval_s)
        self.max_segments = max(1, int(max_segments))
        self._obs = obs
        # entropy-seeded by default (decorrelating peer choice across
        # the fleet is the point); tests inject a seeded rng
        self._rng = rng if rng is not None else random.Random()
        self._links: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sweeps = 0
        self.exchanges = 0           # peer exchanges completed
        self.peer_faults = 0         # peer exchanges lost
        self.segments_pulled = 0
        self.segments_pushed = 0
        self.segments_subsumed = 0   # ships skipped: rows already held
        self.rows_pulled = 0
        self.devq_pulled = 0         # devq segments adopted from peers
        self.devq_pushed = 0         # devq segments shipped to peers
        if peers:
            self.set_peers(peers)

    # -- peer set ------------------------------------------------------
    def set_peers(self, peers: Sequence) -> List[str]:
        """Replace the peer set (idempotent; self excluded).  Returns
        the resulting peer ids."""
        from .router import NodeLink

        pairs: List[Tuple[str, str]] = []
        for p in peers:
            if isinstance(p, str):
                pairs.append((p, p))
            else:
                pid, addr = p
                pairs.append((str(pid), str(addr)))
        with self._lock:
            old = self._links
            self._links = {
                pid: (old.get(pid)
                      if old.get(pid) is not None
                      and old[pid].address == addr
                      else NodeLink(pid, addr))
                for pid, addr in pairs if pid != self.node_id}
            for pid, link in old.items():
                if pid not in self._links:
                    link.close_all()
            return sorted(self._links)

    def peer_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._links)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "GossipAgent":
        """Idempotent: spawns the beat thread iff the interval is
        positive and no live thread exists — callable again after a
        ``gossip.peers`` op raises the interval on an agent that was
        created dormant (interval 0)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        if self.interval_s and self.interval_s > 0 \
                and not self._stop.is_set():
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="qsm-gossip")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
        with self._lock:
            links = list(self._links.values())
        for link in links:
            link.close_all()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 — the beat must survive
                continue

    # -- one beat ------------------------------------------------------
    def sweep(self) -> dict:
        """One reconciliation beat: exchange with ``fanout`` random
        peers, both directions, bounded per the gossip preset.  Public
        so tests and the bench drive convergence synchronously."""
        import time as _time

        from .router import NodeBusy, _LINK_FAULTS

        deadline = _time.monotonic() + (self.policy.deadline_s or 30.0)
        with self._lock:
            ids = sorted(self._links)
        if not ids:
            return {"peers": 0, "pulled": 0, "pushed": 0, "subsumed": 0}
        pick = (list(ids) if len(ids) <= self.fanout
                else self._rng.sample(ids, self.fanout))
        pulled = pushed = subsumed = rows = 0
        exchanged = faults = 0
        tried: Set[str] = set()
        for pid in pick:
            if self._stop.is_set() or _time.monotonic() >= deadline:
                break
            if pid in tried:
                continue
            tried.add(pid)
            with self._lock:
                link = self._links.get(pid)
            if link is None:
                continue
            try:
                got = self._exchange(link, deadline)
            except NodeBusy:
                continue       # backpressure: next beat
            except _LINK_FAULTS:
                faults += 1    # excluded via tried; retried next beat
                continue
            pulled += got[0]
            pushed += got[1]
            subsumed += got[2]
            rows += got[3]
            exchanged += 1
        # counters shared with stats() readers on connection threads
        with self._lock:
            self.sweeps += 1
            self.exchanges += exchanged
            self.peer_faults += faults
            self.segments_pulled += pulled
            self.segments_pushed += pushed
            self.segments_subsumed += subsumed
            self.rows_pulled += rows
        if (pulled or pushed or subsumed) and self._obs is not None \
                and self._obs.on:
            self._obs.event("fleet.gossip", node=self.node_id,
                            peers=len(tried), pulled=pulled,
                            pushed=pushed, subsumed=subsumed,
                            rows=rows)
        return {"peers": len(tried), "pulled": pulled, "pushed": pushed,
                "subsumed": subsumed, "rows": rows}

    def _exchange(self, link, deadline: float) -> Tuple[int, int, int, int]:
        """Both directions with ONE peer: pull what we lack (subsuming
        segments whose rows we already hold), push what it lacks
        (gated by its own subsumption answer)."""
        import time as _time

        def t() -> float:
            return max(0.5, min(self.policy.timeout_s or 10.0,
                                deadline - _time.monotonic()))

        resp = link.request({"op": "replog.digests"}, t())
        if not resp.get("ok"):
            return 0, 0, 0, 0
        theirs = dict(resp.get("digests") or {})
        their_cov = dict(resp.get("absorbed") or {})
        pulled = pushed = subsumed = rows = 0

        # pull leg — coverage-checked before any row line moves
        want = self.replog.missing(theirs)[:self.max_segments]
        to_pull: List[str] = []
        if want:
            cov = link.request({"op": "replog.covers",
                                "segments": want}, t())
            covers = {c.get("name"): c
                      for c in (cov.get("covers") or [])}
            for name in want:
                c = covers.get(name)
                keys = list((c or {}).get("keys") or [])
                if c is not None and keys \
                        and self.cache.holds_all(keys):
                    if self.replog.note_subsumed(
                            name, str(c.get("fingerprint", ""))):
                        subsumed += 1
                        continue
                to_pull.append(name)
        if to_pull:
            got = link.request({"op": "replog.pull",
                                "segments": to_pull}, t())
            for seg in got.get("segments") or []:
                try:
                    adopted = self.replog.adopt(
                        str(seg.get("name")),
                        str(seg.get("fingerprint")),
                        list(seg.get("lines") or []))
                except (ValueError, OSError):
                    continue  # a bad payload is skipped, never adopted
                if adopted:
                    pulled += 1
                    rows += self.cache.adopt_rows(adopted)

        # push leg — the peer's own live set decides subsumption
        mine = self.replog.digests()
        lack = [n for n in sorted(mine)
                if n not in theirs and n not in their_cov]
        for name in lack[:self.max_segments]:
            if _time.monotonic() >= deadline:
                break
            got = self.replog.read_segment(name)
            if got is None:
                continue
            fp, lines = got
            keys = self.replog.row_keys_of(lines)  # one read, reused
            sub = link.request({"op": "replog.subsumed", "name": name,
                                "fingerprint": fp, "keys": keys}, t())
            if sub.get("subsumed"):
                subsumed += 1
                continue
            ack = link.request(
                {"op": "replog.push",
                 "segments": [{"name": name, "fingerprint": fp,
                               "lines": lines}]}, t())
            pushed += int(ack.get("adopted", 0))

        # devq leg (qsm_tpu_torch/devq): same digest→pull shape over the
        # queue's own segment log, push via idempotent devq.put/
        # drain_report row payloads (item keys dedupe, done absorbs).
        if self.devq is not None:
            dq_pulled, dq_pushed = self._exchange_devq(link, t, deadline)
            with self._lock:
                self.devq_pulled += dq_pulled
                self.devq_pushed += dq_pushed
        return pulled, pushed, subsumed, rows

    def _exchange_devq(self, link, t, deadline: float) -> Tuple[int, int]:
        """Reconcile the device-work queue's segment log with one peer:
        pull devq segments we lack (fingerprint-verified adopt folds
        items/tombstones into the live queue), then push the ones the
        peer lacks via ``devq.put`` of their row payloads — put dedupes
        by item key, so the push is idempotent.  A peer that runs no
        devq answers an error; skipped, not a fault."""
        import time as _time

        resp = link.request({"op": "devq.digests"}, t())
        if not resp.get("ok"):
            return 0, 0
        theirs = dict(resp.get("digests") or {})
        pulled = pushed = 0
        want = self.devq.missing(theirs)[:self.max_segments]
        if want:
            got = link.request({"op": "devq.pull",
                                "segments": want}, t())
            for seg in got.get("segments") or []:
                try:
                    if self.devq.adopt(str(seg.get("name")),
                                       str(seg.get("fingerprint")),
                                       list(seg.get("lines") or [])):
                        pulled += 1
                except (ValueError, OSError):
                    continue
        mine = self.devq.digests()
        lack = [n for n in sorted(mine) if n not in theirs]
        for name in lack[:self.max_segments]:
            if _time.monotonic() >= deadline:
                break
            try:
                fp, lines = self.devq.read_segment(name)
            except (KeyError, TypeError):
                continue
            if lines is None:
                continue
            import json as _json

            items, done = [], []
            for line in lines:
                try:
                    row = _json.loads(line)
                except ValueError:
                    continue
                if row.get("done"):
                    done.append(str(row.get("key")))
                elif isinstance(row.get("item"), dict):
                    items.append(row["item"])
            if items:
                ack = link.request({"op": "devq.put", "items": items},
                                   t())
                pushed += int(ack.get("banked", 0) or 0)
            if done:
                link.request({"op": "devq.drain_report", "done": done},
                             t())
        return pulled, pushed

    # -- observability -------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"node": self.node_id, "peers": sorted(self._links),
                    "fanout": self.fanout,
                    "interval_s": self.interval_s,
                    "sweeps": self.sweeps, "exchanges": self.exchanges,
                    "peer_faults": self.peer_faults,
                    "segments_pulled": self.segments_pulled,
                    "segments_pushed": self.segments_pushed,
                    "segments_subsumed": self.segments_subsumed,
                    "rows_pulled": self.rows_pulled,
                    "devq_pulled": self.devq_pulled,
                    "devq_pushed": self.devq_pushed,
                    "policy": self.policy.name}
