"""Supervised worker pool — checking outscales one core before one machine.

The counterpart of the JAX package's ``qsm_tpu/serve/pool.py``.  Pool
workers are host processes: they run the host cpp→memo ladder and never
touch CUDA or the kernel library (the spawn hides every CUDA device from
them), so ``CheckServer(workers=N)`` needs ``device="cpu"``.  The pool
keeps the server's single admission → batcher
→ cache plane and fans dispatches out to N ``serve/worker.py``
processes, treating a worker exactly the way ``resilience/failover.py``
treats a chip:

* **Shed, don't wait.**  Every dispatch is bounded by the
  ``worker-dispatch`` :data:`~qsm_tpu_torch.resilience.policy.PRESETS` entry;
  a worker that misses the bound is presumed wedged, SIGKILLed, and
  its batch — undecided lanes only, nothing was banked — re-dispatches
  to a healthy worker, or (last resort) the caller's own in-process
  host cpp→memo ladder.  A crashed worker (pipe EOF) sheds the same
  way, just faster.
* **Respawn with bounded backoff.**  The supervisor thread respawns
  dead slots on an exponential backoff schedule with a lifetime
  attempt bound per slot — a dying worker costs a bounded number of
  spawns, never a crash loop (the QSM-POOL-RESPAWN lint pass gates the
  code-level twin of this rule).
* **Quarantine a killer spec.**  A spec whose dispatches have now
  crashed ``quarantine_after`` workers is poison, not unlucky: it is
  quarantined to the in-process ladder (``is_quarantined`` — the
  server stops routing it here) so one adversarial input class cannot
  grind the pool through its respawn budget.
* **Soft per-spec affinity.**  A spec prefers the worker at
  ``hash(spec_key) % n`` so its compile caches and memo tables stay
  warm in one process — but an idle worker always beats a busy
  preferred one, so a single hot spec still spreads across the pool
  (the bench's whole scaling story).
* **Workers stay bank-free.**  Verdicts return to the caller, which
  banks them through the cache's one ``put_many`` path; nothing a
  SIGKILL interrupts can tear the bank.

Every counter a capacity decision needs (per-worker dispatches,
faults, respawns, quarantines, per-batch ``worker_faults``) rides
:meth:`WorkerPool.snapshot` into ``stats()`` and the bench rows.
"""

from __future__ import annotations

import itertools
import json
import os
import select
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Set

from ..resilience.policy import RetryPolicy, preset
from .frames import HDR, MAX_FRAME_BYTES, encode_frame


class WorkerFault(RuntimeError):
    """A dispatch lost to a worker (crash, wedge, or protocol skew);
    the lanes are undecided and the caller re-dispatches them."""


class WorkerDead(WorkerFault):
    """Pipe EOF / broken pipe / exited process: the worker crashed."""


class WorkerTimeout(WorkerFault):
    """The worker missed its dispatch/heartbeat bound: presumed wedged
    (SIGKILLed by the shed path — abandonment is not enough, a wedged
    process still holds memory and a core)."""


class WorkerBusy(RuntimeError):
    """The per-worker serialization lock could not be acquired inside
    the bound: the worker is WORKING (on someone else's batch), not
    wedged — callers try another worker and must NOT shed this one (a
    shed here would cascade: killing a busy worker also kills the
    healthy dispatch it was serving)."""


# ---------------------------------------------------------------------------
# bounded pipe I/O (supervisor side) — every read and write carries a
# deadline, the LineChannel discipline applied to worker pipes
# ---------------------------------------------------------------------------

_POLL_S = 0.25


def _read_exact_bounded(fd: int, n: int, deadline: float,
                        label: str) -> bytes:
    buf = b""
    while len(buf) < n:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise WorkerTimeout(f"{label}: read deadline exceeded")
        r, _, _ = select.select([fd], [], [], min(_POLL_S, remaining))
        if not r:
            continue
        try:
            chunk = os.read(fd, n - len(buf))
        except (BlockingIOError, InterruptedError):
            continue
        except OSError as e:
            raise WorkerDead(f"{label}: {type(e).__name__}: {e}") from None
        if not chunk:
            raise WorkerDead(f"{label}: pipe EOF (worker exited)")
        buf += chunk
    return buf


def _write_bounded(fd: int, data: bytes, deadline: float,
                   label: str) -> None:
    view = memoryview(data)
    while view:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise WorkerTimeout(f"{label}: write deadline exceeded")
        _, w, _ = select.select([], [fd], [], min(_POLL_S, remaining))
        if not w:
            continue
        try:
            n = os.write(fd, view[:65536])
        except (BlockingIOError, InterruptedError):
            continue
        except (BrokenPipeError, OSError) as e:
            raise WorkerDead(f"{label}: {type(e).__name__}: {e}") from None
        view = view[n:]


class WorkerHandle:
    """One live worker process: pipes, serialization lock, counters.
    ``request`` is the only I/O entry — bounded both ways, serialized
    per worker (a worker is single-threaded by design)."""

    def __init__(self, wid: int, proc: subprocess.Popen):
        self.wid = wid
        self.proc = proc
        self._stdin_fd = proc.stdin.fileno()
        self._stdout_fd = proc.stdout.fileno()
        # non-blocking + select: a wedged worker that stopped draining
        # its pipe must never block the supervisor past the deadline
        os.set_blocking(self._stdin_fd, False)
        os.set_blocking(self._stdout_fd, False)
        self.lock = threading.Lock()
        self.busy = False          # a dispatch holds the lock right now
        self.dead = False          # shed: never dispatched again
        self._seq = itertools.count(1)
        self.started = time.monotonic()
        self.last_ok = self.started
        self.dispatches = 0
        self.faults = 0
        self.specs: Set[str] = set()

    def request(self, doc: dict, timeout_s: float) -> dict:
        """One bounded round-trip.  Raises :class:`WorkerFault`; the
        caller sheds this worker on any raise."""
        frame = {**doc, "seq": next(self._seq)}
        payload = encode_frame(frame)
        deadline = time.monotonic() + max(0.1, float(timeout_s))
        label = f"worker{self.wid}.{doc.get('op', '?')}"
        # the lock wait is bounded SEPARATELY from the I/O deadline:
        # waiting behind another batch means the worker is busy, not
        # wedged — timing out here must raise Busy (try elsewhere),
        # never a shed-worthy fault
        if not self.lock.acquire(
                timeout=max(0.05, deadline - time.monotonic())):
            raise WorkerBusy(f"{label}: worker mid-dispatch")
        try:
            if self.dead:
                raise WorkerDead(f"{label}: worker already shed")
            self.busy = True
            # the I/O clock starts NOW: time spent queueing behind
            # another batch was the lock's budget, not this round-trip's
            deadline = time.monotonic() + max(0.1, float(timeout_s))
            try:
                _write_bounded(self._stdin_fd, payload, deadline, label)
                while True:
                    hdr = _read_exact_bounded(self._stdout_fd, HDR.size,
                                              deadline, label)
                    (n,) = HDR.unpack(hdr)
                    if n > MAX_FRAME_BYTES:
                        raise WorkerDead(
                            f"{label}: insane frame length {n} "
                            "(protocol skew)")
                    body = _read_exact_bounded(self._stdout_fd, n,
                                               deadline, label)
                    try:
                        resp = json.loads(body)
                    except ValueError:
                        raise WorkerDead(
                            f"{label}: undecodable frame") from None
                    if resp.get("seq") == frame["seq"]:
                        self.last_ok = time.monotonic()
                        return resp
                    # a stale frame from an earlier abandoned request
                    # (should be impossible — timeouts shed the worker —
                    # but dropping it beats desyncing the stream)
            finally:
                self.busy = False
        finally:
            self.lock.release()


class _Slot:
    """One pool position: the live handle (or None while dead) plus the
    respawn backoff state that makes restarts bounded."""

    def __init__(self, index: int, backoff_s: float):
        self.index = index
        self.handle: Optional[WorkerHandle] = None
        self.base_backoff_s = backoff_s
        self.backoff_s = backoff_s
        self.next_respawn_at = 0.0
        self.respawns = 0          # lifetime spawn count beyond the first
        self.deaths = 0


class WorkerPool:
    """See module docstring.  Thread-safe: the batcher's dispatcher
    threads call :meth:`dispatch` concurrently; one supervisor thread
    owns heartbeats and respawns."""

    # a worker that survives this long has its slot backoff forgiven —
    # deaths separated by healthy service are unlucky, not a loop
    HEALTHY_RESET_S = 30.0

    def __init__(self, n_workers: int, *,
                 policy: Optional[RetryPolicy] = None,
                 quarantine_after: int = 2,
                 heartbeat_s: float = 5.0,
                 heartbeat_timeout_s: float = 5.0,
                 spawn_timeout_s: float = 60.0,
                 max_respawns: int = 8,
                 respawn_backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0,
                 obs=None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.policy = policy or preset("worker-dispatch")
        self.quarantine_after = max(1, quarantine_after)
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.max_respawns = max_respawns
        self.max_backoff_s = max_backoff_s
        self._slots = [_Slot(i, respawn_backoff_s)
                       for i in range(n_workers)]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        self.spec_crashes: Dict[str, int] = {}
        self.quarantined: Set[str] = set()
        self.dispatches = 0
        self.worker_faults = 0     # sheds + error answers, dispatch level
        self.respawns = 0
        self.quarantines = 0
        # trace plane (obs): span events for dispatch/shed/
        # respawn/quarantine feed the flight-recorder ring (a SIGKILLed
        # worker's dump shows the doomed dispatch's trace ids), and the
        # per-worker round-trip latency histogram feeds live metrics.
        # All emission guarded by obs.on — the no-obs path pays one
        # attribute read per dispatch.
        self._obs = obs
        self._m_dispatch = (obs.metrics.histogram(
            "qsm_pool_dispatch_seconds",
            "per-worker micro-batch dispatch round-trip seconds")
            if obs is not None else None)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "WorkerPool":
        for slot in self._slots:
            self._spawn(slot)
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True, name="qsm-pool-supervise")
        self._supervisor.start()
        return self

    def stop(self) -> None:
        """Deterministic teardown: polite exit frame → terminate →
        bounded wait → kill escalation → bounded reap.  Tier-1 tests
        must never leak a worker process."""
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(2.0)
        for slot in self._slots:
            with self._lock:
                handle, slot.handle = slot.handle, None
            if handle is None:
                continue
            # polite exit FIRST (request() refuses dead handles, and
            # _stop already gates new dispatches), THEN mark dead and
            # escalate — the exit frame lets the worker flush and leave
            # on its own before SIGTERM/SIGKILL ever fire
            if not handle.busy:
                try:
                    handle.request({"op": "exit"}, timeout_s=0.5)
                except (WorkerBusy, WorkerFault):
                    pass
            with self._lock:  # dead is checked/set under the pool lock
                handle.dead = True
            proc = handle.proc
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
            self._close_pipes(proc)

    @staticmethod
    def _close_pipes(proc: subprocess.Popen) -> None:
        for stream in (proc.stdin, proc.stdout):
            try:
                if stream is not None:
                    stream.close()
            except OSError:
                pass

    # -- spawn / shed / supervise --------------------------------------
    def _spawn(self, slot: _Slot) -> bool:
        import qsm_tpu_torch

        root = os.path.dirname(os.path.dirname(
            os.path.abspath(qsm_tpu_torch.__file__)))
        env = dict(os.environ)
        # workers run the host ladder only; never let one reach a card
        # (the supervisor owns any device plane) — an unconditional pin,
        # so N workers can never start CUDA contexts beside the server's
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["PYTHONPATH"] = root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "qsm_tpu_torch.serve.worker",
                 "--wid", str(slot.index)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        except OSError:
            # slot backoff state is shared with the dispatch threads'
            # _shed path — same guard discipline (QSM-RACE-UNGUARDED)
            with self._lock:
                slot.deaths += 1
                slot.next_respawn_at = time.monotonic() + slot.backoff_s
                slot.backoff_s = min(slot.backoff_s * 2,
                                     self.max_backoff_s)
            return False
        with self._lock:
            slot.handle = WorkerHandle(slot.index, proc)
        return True

    def _emit(self, name: str, trace: str = "", **attrs) -> None:
        """One obs event (no-op without an obs handle or with tracing
        off — a single attribute read either way)."""
        if self._obs is None or not self._obs.on:
            return
        self._obs.event(name, trace=trace, **attrs)

    def _shed(self, handle: WorkerHandle, spec_key: Optional[str],
              err: BaseException,
              traces: Optional[List[str]] = None) -> None:
        """A worker is lost (crash or wedge): kill it like a wedged
        chip, count it, schedule the bounded respawn, and quarantine
        the spec when it has now killed ``quarantine_after`` workers."""
        slot = self._slots[handle.wid]
        with self._lock:
            if handle.dead:
                return  # a concurrent path shed it first
            handle.dead = True
            handle.faults += 1
            self.worker_faults += 1
            slot.deaths += 1
            slot.handle = None
            now = time.monotonic()
            slot.next_respawn_at = now + slot.backoff_s
            slot.backoff_s = min(slot.backoff_s * 2, self.max_backoff_s)
            quarantined_now = False
            n_crash = 0
            if spec_key is not None:
                n_crash = self.spec_crashes.get(spec_key, 0) + 1
                self.spec_crashes[spec_key] = n_crash
                if (n_crash >= self.quarantine_after
                        and spec_key not in self.quarantined):
                    self.quarantined.add(spec_key)
                    self.quarantines += 1
                    quarantined_now = True
        # worker.shed / pool.quarantine are flight-recorder DUMP
        # triggers (obs): the dump's last events include the
        # doomed dispatch's trace ids (worker.dispatch rode the ring)
        self._emit("worker.shed", wid=handle.wid, spec=spec_key,
                   error=f"{type(err).__name__}: {err}"[:200],
                   traces=traces or [])
        if quarantined_now:
            self._emit("pool.quarantine", spec=spec_key, crashes=n_crash)
        proc = handle.proc
        try:
            # SIGKILL, not terminate: a wedged dispatch does not honor
            # signals it can catch, and a crashed one no longer cares
            proc.kill()
            proc.wait(timeout=5.0)
        except (OSError, subprocess.TimeoutExpired):
            pass
        self._close_pipes(proc)

    def _supervise(self) -> None:
        """Heartbeat + respawn loop (NOT a while-True spawn loop: every
        respawn waits out its slot's backoff and the per-slot lifetime
        bound — the discipline QSM-POOL-RESPAWN gates)."""
        while not self._stop.wait(0.25):
            now = time.monotonic()
            for slot in self._slots:
                with self._lock:
                    handle = slot.handle
                if handle is None:
                    if (slot.respawns < self.max_respawns
                            and now >= slot.next_respawn_at
                            and slot.next_respawn_at > 0.0):
                        with self._lock:
                            slot.respawns += 1
                            self.respawns += 1
                        self._emit("worker.respawn", wid=slot.index,
                                   respawns=slot.respawns)
                        self._spawn(slot)
                    continue
                if (now - handle.started >= self.HEALTHY_RESET_S
                        and slot.backoff_s != slot.base_backoff_s):
                    # backoff is also written by _shed under the lock
                    with self._lock:
                        slot.backoff_s = slot.base_backoff_s
                if handle.busy or handle.dead:
                    continue  # dispatch deadline covers busy workers
                if now - handle.last_ok < self.heartbeat_s:
                    continue
                try:
                    handle.request({"op": "ping"},
                                   timeout_s=self.heartbeat_timeout_s)
                except WorkerBusy:
                    continue  # a dispatch won the lock race: healthy
                except WorkerFault as e:
                    self._shed(handle, None, e)

    # -- dispatch ------------------------------------------------------
    def is_quarantined(self, spec_key: str) -> bool:
        return spec_key in self.quarantined

    def idle_workers(self) -> int:
        """Live, not-mid-dispatch workers (the batcher's flush-target
        signal)."""
        with self._lock:
            return sum(1 for s in self._slots
                       if s.handle is not None
                       and not s.handle.dead and not s.handle.busy)

    def live_workers(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots
                       if s.handle is not None and not s.handle.dead)

    def _pick(self, spec_key: str, tried: Set[int]
              ) -> Optional[WorkerHandle]:
        """Soft affinity: walk the ring from ``hash(spec_key) % n``,
        preferring an idle worker (warm caches win ties, a hot spec
        still spreads); any live untried worker beats none."""
        preferred = hash(spec_key) % self.n_workers
        order = [(preferred + i) % self.n_workers
                 for i in range(self.n_workers)]
        fallback = None
        with self._lock:
            for i in order:
                h = self._slots[i].handle
                if h is None or h.dead or h.wid in tried:
                    continue
                if not h.busy:
                    return h
                if fallback is None:
                    fallback = h
        return fallback

    def dispatch(self, spec_key: str, model: str, spec_kwargs: dict,
                 rows: List[list], width: int,
                 traces: Optional[List[str]] = None) -> Optional[dict]:
        """Decide one micro-batch on the pool.  Returns the worker's
        response (verdicts + per-batch search/resilience stamps, plus
        ``batch_worker_faults`` — how many workers this batch burned),
        or None when the pool cannot decide it (quarantined spec, no
        healthy worker, ladder exhausted): the caller falls back to its
        own in-process host ladder.  Lanes are all-or-nothing per
        attempt — a lost worker banked nothing, so the whole batch is
        the undecided remainder.  ``traces`` (the batch's request trace
        ids, obs) ride the worker frame's optional ``trace``
        field and every dispatch/shed event."""
        if self.is_quarantined(spec_key):
            return None
        doc = {"op": "check", "model": model, "spec_kwargs": spec_kwargs,
               "rows": rows, "width": width}
        if traces:
            doc["trace"] = traces
        deadline = (time.monotonic() + self.policy.deadline_s
                    if self.policy.deadline_s else None)
        tried: Set[int] = set()
        faults = 0
        for _attempt in range(max(1, self.policy.attempts)):
            if self._stop.is_set():
                return None
            timeout_s = self.policy.timeout_s or 30.0
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None  # ladder deadline: in-process last resort
                timeout_s = min(timeout_s, remaining)
            handle = self._pick(spec_key, tried)
            if handle is None:
                return None
            tried.add(handle.wid)
            handle.specs.add(spec_key)
            self._emit("worker.dispatch", wid=handle.wid, spec=model,
                       lanes=len(rows), traces=traces or [])
            t0 = time.monotonic()
            try:
                resp = handle.request(doc, timeout_s)
            except WorkerBusy:
                continue  # working, not wedged: never shed, try the next
            except WorkerFault as e:
                faults += 1
                self._shed(handle, spec_key, e, traces=traces)
                continue
            if resp.get("ok"):
                if self._m_dispatch is not None:
                    # bounded label values by construction: wid < n
                    self._m_dispatch.observe(time.monotonic() - t0,
                                             wid=str(handle.wid))
                with self._lock:
                    self.dispatches += 1
                handle.dispatches = int(resp.get("dispatches",
                                                 handle.dispatches + 1))
                resp["batch_worker_faults"] = faults
                return resp
            # a clean error answer: the worker is alive (it answered)
            # but this dispatch failed there (raise:worker, bad spec);
            # count the fault and try a different worker — deterministic
            # failures exhaust the ladder into the in-process path
            faults += 1
            with self._lock:
                self.worker_faults += 1
        return None

    def warm(self, model: str, spec_kwargs: Optional[dict] = None) -> int:
        """Build the spec's engine in every live worker (the server's
        ``--warm`` amortization, pool edition).  Returns workers warmed."""
        doc = {"op": "warm", "model": model,
               "spec_kwargs": spec_kwargs or {}}
        warmed = 0
        for slot in self._slots:
            with self._lock:
                handle = slot.handle
            if handle is None or handle.dead:
                continue
            try:
                # generous bound: the FIRST warm may compile the native
                # oracle (cached on disk for every later worker)
                resp = handle.request(doc, timeout_s=self.spawn_timeout_s)
                warmed += int(bool(resp.get("ok")))
            except WorkerBusy:
                continue  # it is mid-dispatch: warm enough
            except WorkerFault as e:
                self._shed(handle, None, e)
        return warmed

    # -- observability -------------------------------------------------
    def shed_state(self) -> dict:
        """The compact pool block SHED responses carry: enough for a
        client to tell 'overloaded' from 'degraded to one worker'."""
        with self._lock:
            live = sum(1 for s in self._slots
                       if s.handle is not None and not s.handle.dead)
            return {"workers": self.n_workers, "live": live,
                    "quarantined": len(self.quarantined)}

    def snapshot(self) -> dict:
        with self._lock:
            workers = []
            for slot in self._slots:
                h = slot.handle
                workers.append({
                    "wid": slot.index,
                    "alive": h is not None and not h.dead,
                    "pid": h.proc.pid if h is not None else None,
                    "dispatches": h.dispatches if h is not None else 0,
                    "faults": h.faults if h is not None else 0,
                    "deaths": slot.deaths,
                    "respawns": slot.respawns,
                    "uptime_s": round(time.monotonic() - h.started, 1)
                    if h is not None else 0.0,
                    "specs": sorted(h.specs) if h is not None else [],
                })
            return {
                "n_workers": self.n_workers,
                "live": sum(1 for w in workers if w["alive"]),
                "dispatches": self.dispatches,
                "worker_faults": self.worker_faults,
                "respawns": self.respawns,
                "quarantines": self.quarantines,
                "quarantined_specs": sorted(self.quarantined),
                "spec_crashes": dict(self.spec_crashes),
                "policy": self.policy.name,
                "workers": workers,
            }
