"""Router lease — the fleet's one-active-brain contract.

The counterpart of the JAX package's ``qsm_tpu/fleet/lease.py``, with
its record (artifact name, version, ``tcp://`` scheme), so a lease file
one package writes reads the same in the other.

A fleet with exactly one router loses the tier with that router.  Running N routers against the same fleet config fixes
availability but creates the split-brain hazard — two routers both
believing they are active could answer the same traffic from diverging
health views.  This module is the arbitration: a shared *lease record*
(one JSON document) holding

* a **term** — a monotonically increasing integer, bumped by every
  takeover; an active router stamps its term on every response, and a
  router holding a stale term answers ``SHED`` with a
  ``router_superseded`` block, never a verdict;
* a **holder** — the router id that owns the current term;
* an **expiry** — wall-clock ``expires_at`` a bounded TTL ahead,
  refreshed by :meth:`Lease.renew` on the active router's sweep beat.

Safety argument (one-way per term): the active serves only while
``now < expires_at`` of its OWN last successful renew; a standby
:meth:`Lease.acquire`\\ s only after observing ``now >= expires_at``
(plus a grace) of the SAME record and bumping the term.  Both read the
same record and the same authority clock, so at most one router can
believe its term is live at any instant, and a router that lost term T
can never serve under T again — it re-enters only by winning a LATER
term through the same gated path.

The record lives behind a pluggable :class:`LeaseStore`:

* :class:`FileLeaseStore` — the single-host shape: one JSON file
  beside the replog dirs, read-modify-write races between candidates
  excluded by an ``flock``-held lock file.  The kernel owns the
  exclusion, so a candidate SIGKILLed mid-acquire releases it with
  its process — no stale-lock state exists to break (and no
  break-the-stale-lock race, where two breakers could each unlink the
  other's fresh lock and both proceed, can arise).
* :class:`TcpLeaseStore` — routers spanning hosts: every transaction
  is ONE bounded round trip of the serve protocol's ``lease.acquire``
  / ``lease.renew`` / ``lease.release`` / ``lease.read`` ops against
  a lease-hosting node (``CheckServer(lease_path=...)``), whose OWN
  FileLeaseStore runs the identical transaction under the identical
  flock — the safety argument is unchanged, the authority clock is
  the lease host's.  Any transport failure loses THIS beat (returns
  None), exactly like flock contention: callers re-consult on their
  next beat, never spin.

Fault plane (resilience/faults.py): :meth:`Lease.acquire` and
:meth:`Lease.renew` pass the ``lease`` fault site —
``QSM_TPU_FAULTS="partition:lease"`` makes the store unreachable for
the beat (a lost beat, not an error), ``raise:lease@2`` fails the
second transaction, with the full ``action:site[:p][@nth]`` grammar.

Consumed by :class:`~qsm_tpu_torch.fleet.router.FleetRouter`
(``lease_path=`` — a filesystem path or ``tcp://host:port``); the JAX
package's lint family (j) gates the promotion discipline there
(QSM-FLEET-LEASE: every promote path must consult term/expiry and stay
bounded), and this copy keeps the same paths."""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Union

from ..resilience.faults import inject

_ARTIFACT = "qsm_tpu_router_lease"
_VERSION = 1
TCP_SCHEME = "tcp://"


def lease_expired(rec: Optional[dict], grace_s: float = 0.0) -> bool:
    """True when the record's term is no longer live (plus the
    caller's grace — standbys wait it out so clock skew inside one
    authority's timestamps can never overlap two actives)."""
    if rec is None:
        return True
    return time.time() >= float(rec["expires_at"]) + max(0.0, grace_s)


class LeaseStore:
    """The storage contract behind the lease record.  All methods are
    one bounded transaction; ``None`` returns mean "you do not hold
    it" — callers re-consult on their next beat, never spin."""

    def read(self) -> Optional[dict]:
        raise NotImplementedError

    def acquire(self, holder: str, ttl_s: float,
                grace_s: float = 0.0) -> Optional[dict]:
        raise NotImplementedError

    def renew(self, holder: str, term: int,
              ttl_s: float) -> Optional[dict]:
        raise NotImplementedError

    def release(self, holder: str) -> None:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


class FileLeaseStore(LeaseStore):
    """The filesystem store: one JSON record, flock-excluded
    transactions (see module docstring)."""

    def __init__(self, path: str):
        self.path = path
        self._lock_fd = None
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    # -- reading -------------------------------------------------------
    def read(self) -> Optional[dict]:
        """The current record, or None (missing/garbled — a garbled
        lease is treated as expired: the next acquire rewrites it)."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if doc.get("artifact") != _ARTIFACT:
            return None
        if not isinstance(doc.get("term"), int) \
                or not isinstance(doc.get("expires_at"), (int, float)):
            return None
        return doc

    # -- the write transactions ----------------------------------------
    def acquire(self, holder: str, ttl_s: float,
                grace_s: float = 0.0) -> Optional[dict]:
        """Take the lease iff nobody holds a live term: no record, an
        expired record (past ``grace_s``), or our own record.  The new
        term is ``old term + 1`` (a re-acquire of our own live record
        keeps the term — that is a renew).  Returns the record now in
        force when WE hold it, else None."""
        if not self._lock():
            return None
        try:
            rec = self.read()
            if rec is not None and rec.get("holder") != holder \
                    and not lease_expired(rec, grace_s):
                return None  # a live foreign term: never contested
            old_term = int(rec["term"]) if rec is not None else 0
            if rec is not None and rec.get("holder") == holder \
                    and not lease_expired(rec):
                term = old_term        # still ours: refresh, not bump
            else:
                term = old_term + 1    # a takeover mints a NEW term
            return self._write(term, holder, ttl_s)
        finally:
            self._unlock()

    def renew(self, holder: str, term: int,
              ttl_s: float) -> Optional[dict]:
        """Refresh ``expires_at`` iff ``holder`` still holds exactly
        ``term``.  None = lost (superseded, expired-and-taken, or the
        record is gone) — the caller must stop serving under ``term``."""
        if not self._lock():
            return None
        try:
            rec = self.read()
            if rec is None or rec.get("holder") != holder \
                    or int(rec["term"]) != int(term):
                return None
            if lease_expired(rec):
                # the holder's own record expired before this renew
                # landed: the term MAY already be contested —
                # refreshing it could resurrect a stale active after a
                # standby's expiry read.  One-way: give it up;
                # re-entry is a new term.
                return None
            return self._write(int(term), holder, ttl_s)
        finally:
            self._unlock()

    def release(self, holder: str) -> None:
        """Expire ``holder``'s own record in place (clean shutdown:
        the standby need not wait out the TTL).  A TOMBSTONE, not an
        unlink — the term survives, so the successor still mints
        term+1 and the monotonic-term contract holds across clean
        handovers (merged logs must never see the same term from two
        brains).  A foreign record is left alone."""
        if not self._lock():
            return
        try:
            rec = self.read()
            if rec is not None and rec.get("holder") == holder:
                from ..resilience.checkpoint import atomic_write_json

                # backdated past any sane grace (grace <= 2*ttl, read
                # from the record itself) so the successor's very next
                # beat sees it expired
                ttl = float(rec.get("ttl_s", 1.0))
                rec = {**rec, "released": True,
                       "expires_at": round(time.time() - 2 * ttl, 4)}
                atomic_write_json(self.path, rec)
        finally:
            self._unlock()

    def describe(self) -> str:
        return self.path

    # -- plumbing ------------------------------------------------------
    def _write(self, term: int, holder: str, ttl_s: float) -> dict:
        from ..resilience.checkpoint import atomic_write_json

        ttl = max(0.2, float(ttl_s))
        rec = {"artifact": _ARTIFACT, "version": _VERSION,
               "term": int(term), "holder": str(holder),
               "ttl_s": ttl,
               "expires_at": round(time.time() + ttl, 4)}
        atomic_write_json(self.path, rec)
        return rec

    @property
    def _lock_path(self) -> str:
        return self.path + ".lock"

    def _lock(self) -> bool:
        """``flock(LOCK_EX | LOCK_NB)`` mutual exclusion around
        read-modify-write.  Held for microseconds; contention loses
        THIS beat (never blocks).  Kernel-owned: a holder SIGKILLed
        mid-transaction releases with its process, so no stale-lock
        state exists and nothing ever needs breaking (an unlink-based
        break would race — two breakers could each remove the other's
        fresh lock and both enter the critical section: exactly the
        split-brain this lock exists to exclude).  The lock file
        itself is deliberately never unlinked."""
        import fcntl

        try:
            fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR)
        except OSError:
            return False
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False  # live contention: lose this beat
        self._lock_fd = fd
        return True

    def _unlock(self) -> None:
        fd = getattr(self, "_lock_fd", None)
        if fd is None:
            return
        self._lock_fd = None
        try:
            os.close(fd)  # closing the fd releases the flock
        except OSError:
            pass


class TcpLeaseStore(LeaseStore):
    """The multi-host store: each transaction is one bounded serve-
    protocol round trip against a lease-hosting node
    (``CheckServer(lease_path=...)``), which runs the identical
    FileLeaseStore transaction under its own flock.  ANY transport
    failure — connect refused, timeout, torn response — loses this
    beat (None), the same contract a lost flock beat has; the caller's
    next beat re-consults.  No connection is pooled: a lease beat is
    rare (~TTL/3) and a fresh bounded socket per transaction means a
    half-dead pooled connection can never wedge the HA plane."""

    def __init__(self, address: str, timeout_s: float = 5.0):
        if address.startswith(TCP_SCHEME):
            address = address[len(TCP_SCHEME):]
        self.address = address
        self.timeout_s = max(0.2, float(timeout_s))

    def _ask(self, doc: dict) -> Optional[dict]:
        from ..serve.protocol import LineChannel, connect, send_doc

        try:
            sock = connect(self.address, timeout_s=self.timeout_s)
        except OSError:
            return None
        try:
            send_doc(sock, doc)
            line = LineChannel(sock).read_line(timeout_s=self.timeout_s)
        except (OSError, TimeoutError):
            return None
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if line is None:
            return None
        try:
            resp = json.loads(line)
        except ValueError:
            return None
        if not isinstance(resp, dict) or not resp.get("ok"):
            return None
        return resp

    def read(self) -> Optional[dict]:
        resp = self._ask({"op": "lease.read"})
        if resp is None:
            return None
        rec = resp.get("record")
        return rec if isinstance(rec, dict) else None

    def acquire(self, holder: str, ttl_s: float,
                grace_s: float = 0.0) -> Optional[dict]:
        resp = self._ask({"op": "lease.acquire", "holder": str(holder),
                          "ttl_s": float(ttl_s),
                          "grace_s": float(grace_s)})
        if resp is None or not resp.get("acquired"):
            return None
        return resp.get("record")

    def renew(self, holder: str, term: int,
              ttl_s: float) -> Optional[dict]:
        resp = self._ask({"op": "lease.renew", "holder": str(holder),
                          "term": int(term), "ttl_s": float(ttl_s)})
        if resp is None or not resp.get("renewed"):
            return None
        return resp.get("record")

    def release(self, holder: str) -> None:
        self._ask({"op": "lease.release", "holder": str(holder)})

    def describe(self) -> str:
        return TCP_SCHEME + self.address


def make_store(target: Union[str, LeaseStore]) -> LeaseStore:
    """``tcp://host:port`` → :class:`TcpLeaseStore`; an already-built
    store passes through; anything else is a filesystem path."""
    if isinstance(target, LeaseStore):
        return target
    target = str(target)
    if target.startswith(TCP_SCHEME):
        return TcpLeaseStore(target)
    return FileLeaseStore(target)


class Lease:
    """One router's handle on the shared lease record (see module
    docstring).  ``path`` is a filesystem path, a ``tcp://host:port``
    lease-server address, or a pre-built :class:`LeaseStore`; the
    method surface (and every term/expiry semantic) is identical over
    all of them."""

    def __init__(self, path: Union[str, LeaseStore], holder: str,
                 ttl_s: float = 3.0):
        self.store = make_store(path)
        self.holder = str(holder)
        self.ttl_s = max(0.2, float(ttl_s))

    @property
    def path(self) -> str:
        return self.store.describe()

    @property
    def _lock_path(self) -> str:
        # back-compat for the flock-contention pin (file store only)
        return self.store._lock_path

    # -- reading -------------------------------------------------------
    def read(self) -> Optional[dict]:
        return self.store.read()

    @staticmethod
    def expired(rec: Optional[dict], grace_s: float = 0.0) -> bool:
        return lease_expired(rec, grace_s)

    # -- the write transactions ----------------------------------------
    def acquire(self, grace_s: float = 0.0) -> Optional[dict]:
        if inject("lease") in ("partition", "wedge"):
            return None  # store unreachable this beat: a lost beat
        return self.store.acquire(self.holder, self.ttl_s, grace_s)

    def renew(self, term: int) -> Optional[dict]:
        if inject("lease") in ("partition", "wedge"):
            return None
        return self.store.renew(self.holder, int(term), self.ttl_s)

    def release(self) -> None:
        self.store.release(self.holder)
