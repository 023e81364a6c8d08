"""One retry and deadline policy for the whole package.

The counterpart of the JAX package's ``qsm_tpu/resilience/policy.py``:

* :class:`RetryPolicy`: bounded attempts, exponential backoff with jitter
  and a wall-clock deadline over the whole ladder, as one value;
* :data:`PRESETS`: the named policies, the only place where probe and
  dispatch timing constants live.  The table is the reference's, whole:
  its bounds are semantic (how long a dispatch or a round trip may take
  before it counts as lost), not speed tuning, so they carry over.  Only
  ``dispatch`` has a consumer in this package
  (``resilience/failover.py``);
* :func:`watchdog`: a bounded in-process call.  The call runs on a
  daemon thread; on timeout the thread is abandoned and
  :class:`WatchdogTimeout` raises, so that the caller can degrade.  There
  is no cancelling a call that hangs on a device, only abandoning it;
* :class:`Watchdog`: the same bound with one long-lived worker thread for
  many calls (a guarded dispatch pays no thread start), replaced only
  when a call is abandoned.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
import weakref
from typing import Callable, Iterator, Optional, Sequence


class WatchdogTimeout(RuntimeError):
    """A watched call passed its bound and was abandoned (its thread may
    still be stuck; the caller is free to degrade)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries, backoff and a deadline as one immutable value.

    ``attempts``    tries in all (1: no retry).
    ``timeout_s``   wall-clock bound of one attempt (None: unbounded).
    ``backoff_s``   sleep before the first retry, multiplied by
                    ``backoff_factor`` for each later one.
    ``jitter_frac`` +- fraction of each sleep drawn at random.
    ``deadline_s``  wall-clock bound of the whole ladder: no retry starts
                    past it.
    """

    name: str = "custom"
    attempts: int = 1
    timeout_s: Optional[float] = 45.0
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    jitter_frac: float = 0.0
    deadline_s: Optional[float] = None

    def with_(self, **overrides) -> "RetryPolicy":
        """A derived policy; its name keeps the preset it came from."""
        if "name" not in overrides:
            overrides["name"] = f"{self.name}*"
        return dataclasses.replace(self, **overrides)

    def delays(self, rng=None) -> Iterator[float]:
        """The ``attempts - 1`` sleeps between tries."""
        d = self.backoff_s
        for _ in range(max(0, self.attempts - 1)):
            j = d * self.jitter_frac
            yield max(0.0, d + (rng.uniform(-j, j) if rng is not None and j
                                else 0.0))
            d *= self.backoff_factor

    def run(self, fn: Callable, *, retriable: Sequence[type] = (Exception,),
            should_retry: Optional[Callable] = None,
            sleep: Callable = time.sleep, rng=None):
        """``fn()`` under the policy: retried on an exception of
        ``retriable`` and on a value ``should_retry`` rejects, spaced by
        :meth:`delays`, never past ``deadline_s``.  Returns the first
        accepted value, or the last rejected one when the ladder runs
        out; raises the last exception when every attempt raised.
        ``sleep`` and ``rng`` are there for tests."""
        retriable = tuple(retriable)
        t0 = time.monotonic()
        plan: Optional[list] = None   # drawn at the first retry
        last_err: Optional[BaseException] = None
        last_val = None
        for i in range(max(1, self.attempts)):
            try:
                val = fn()
            except retriable as e:  # noqa: PERF203 — the ladder is the loop
                last_err, last_val = e, None
            else:
                if should_retry is None or not should_retry(val):
                    return val
                last_err, last_val = None, val
            if plan is None:
                if rng is None and self.jitter_frac:
                    # retry spacing is outside the determinism contract
                    # (no verdict depends on it): an entropy-seeded draw
                    # is right
                    rng = random.Random()
                plan = list(self.delays(rng))
            if i >= len(plan):
                break
            d = plan[i]
            if (self.deadline_s is not None
                    and time.monotonic() - t0 + d > self.deadline_s):
                break  # no retry starts past the deadline
            sleep(d)
        if last_err is not None:
            raise last_err
        return last_val


def watchdog(fn: Callable, timeout_s: Optional[float],
             label: str = "dispatch"):
    """``fn()`` bounded by ``timeout_s`` seconds of wall clock.

    ``None`` or ``<= 0`` runs inline.  Otherwise the call runs on a
    daemon thread; past the bound the thread is abandoned and
    :class:`WatchdogTimeout` raises.  Exceptions of ``fn`` re-raise as
    they are.  A CUDA launch made from that thread goes to the thread's
    current stream: the caller that needs its own stream sets it inside
    ``fn`` (``resilience/failover.py`` does)."""
    if not timeout_s or timeout_s <= 0:
        return fn()
    box: dict = {}

    def _run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True, name=f"watchdog:{label}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise WatchdogTimeout(
            f"{label} exceeded {timeout_s:.1f}s and was abandoned "
            "(device wedged mid-dispatch?)")
    if "error" in box:
        raise box["error"]
    return box.get("value")


# set on a Watchdog's worker thread: a watched call made from inside
# another one (the check server's dispatch reaching a FailoverBackend)
# runs inline, bounded by the outer call, instead of queueing behind it
_on_worker = threading.local()

# the stop mark a Watchdog's worker ends on when it takes it off its
# queue: put behind a stuck call when the worker is abandoned, and by
# the finalizer when its instance is collected
_STOP = None


def _serve(jobs: "queue.SimpleQueue") -> None:
    """A :class:`Watchdog`'s worker: runs the queued calls in order until
    it takes the stop mark (:data:`_STOP`)."""
    _on_worker.active = True
    while True:
        job = jobs.get()
        if job is _STOP:
            return
        fn, box, done = job
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e
        done.set()


class Watchdog:
    """:func:`watchdog` with one long-lived daemon worker for all its
    calls, started at the first bounded call.  A call past its bound
    abandons the worker (it gets the stop mark behind the stuck call, so
    it ends if the call ever returns) and raises
    :class:`WatchdogTimeout`; the next call starts a fresh worker, so a
    retry never queues behind a hung call.  The worker ends when the
    instance is collected.  Calls of one instance are serialised."""

    def __init__(self, label: str = "dispatch"):
        self.label = label
        self._jobs: Optional[queue.SimpleQueue] = None
        self._lock = threading.Lock()

    def _worker(self) -> "queue.SimpleQueue":
        if self._jobs is None:
            jobs: queue.SimpleQueue = queue.SimpleQueue()
            threading.Thread(target=_serve, args=(jobs,), daemon=True,
                             name=f"watchdog:{self.label}").start()
            # the worker holds its queue only, never the instance
            weakref.finalize(self, jobs.put, _STOP)
            self._jobs = jobs
        return self._jobs

    def __call__(self, fn: Callable, timeout_s: Optional[float]):
        """``fn()`` bounded by ``timeout_s`` seconds (``None`` or ``<= 0``
        runs inline, as does a call made on a worker thread of any
        instance: the outer call's bound holds it); exceptions of ``fn``
        re-raise as they are."""
        if not timeout_s or timeout_s <= 0 or getattr(_on_worker, "active",
                                                      False):
            return fn()
        with self._lock:
            jobs = self._worker()
            box: dict = {}
            done = threading.Event()
            jobs.put((fn, box, done))
            if not done.wait(timeout_s):
                jobs.put(_STOP)
                self._jobs = None
                raise WatchdogTimeout(
                    f"{self.label} exceeded {timeout_s:.1f}s and was "
                    "abandoned (device wedged mid-dispatch?)")
        if "error" in box:
            raise box["error"]
        return box.get("value")


# The named presets, as the JAX package defines them (module docstring).
PRESETS = {
    # one bounded probe of the default backend
    "probe": RetryPolicy(name="probe", attempts=1, timeout_s=45.0),
    # a watcher's steady probe loop (its interval spaces the probes)
    "watcher-probe": RetryPolicy(name="watcher-probe", attempts=1,
                                 timeout_s=45.0),
    # is-the-window-still-open re-probe before each seize-stage tool
    "window-reprobe": RetryPolicy(name="window-reprobe", attempts=1,
                                  timeout_s=30.0),
    # a benchmark's headline probe: a few spaced re-probes
    "bench-probe": RetryPolicy(name="bench-probe", attempts=3,
                               timeout_s=60.0, backoff_s=30.0,
                               backoff_factor=1.0),
    # a window-seize invocation: the window is open, retries come fast
    "seize-probe": RetryPolicy(name="seize-probe", attempts=5,
                               timeout_s=60.0, backoff_s=10.0,
                               backoff_factor=1.0),
    # a guarded device dispatch (resilience/failover.py): one quick retry
    # with a short jittered backoff inside a 10-minute deadline.  The
    # bound of one attempt is what catches a dispatch that hangs; 300 s a
    # slice of 1024 lanes is generous for legitimate work, and a caller
    # with slower legitimate dispatches overrides it with with_().
    "dispatch": RetryPolicy(name="dispatch", attempts=2, timeout_s=300.0,
                            backoff_s=0.5, backoff_factor=2.0,
                            jitter_frac=0.1, deadline_s=600.0),
    # a serving plane's micro-batch dispatch (timeout_s) and default
    # per-request deadline (deadline_s)
    "serve": RetryPolicy(name="serve", attempts=1, timeout_s=60.0,
                         deadline_s=30.0),
    # one micro-batch round trip to a pool worker process
    "worker-dispatch": RetryPolicy(name="worker-dispatch", attempts=3,
                                   timeout_s=30.0, deadline_s=60.0),
    # one sub-request routed to a fleet node
    "fleet-route": RetryPolicy(name="fleet-route", attempts=3,
                               timeout_s=20.0, deadline_s=45.0),
    # a fleet membership health probe (backoff_s: re-probe spacing while
    # a node is down)
    "fleet-probe": RetryPolicy(name="fleet-probe", attempts=1,
                               timeout_s=5.0, backoff_s=1.0,
                               backoff_factor=2.0),
    # one anti-entropy round trip, and one reconciliation sweep
    "anti-entropy": RetryPolicy(name="anti-entropy", attempts=1,
                                timeout_s=15.0, deadline_s=60.0),
    # one node-to-node gossip exchange, and one beat's fan-out
    "gossip": RetryPolicy(name="gossip", attempts=1, timeout_s=10.0,
                          deadline_s=20.0),
}


def preset(name: str) -> RetryPolicy:
    """The named policy, or a clean error listing what exists."""
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown RetryPolicy preset {name!r}; "
                       f"one of {sorted(PRESETS)}") from None
