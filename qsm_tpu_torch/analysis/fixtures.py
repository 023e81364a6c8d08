"""Seeded-bug fixtures — TRUE POSITIVES the port's lint gate must keep
catching (the counterpart of ``qsm_tpu/analysis/fixtures.py``, in the
port's idiom).

Each fixture plants exactly the class of defect one pass family exists
for; tests/test_torch_lint.py asserts the analyzer flags each with the
right rule_id, and that each sanctioned twin stays clean.  A lint whose
true positives rot is a green light with the bulb removed — these
fixtures are the bulb check.  Nothing here is exported through the
package ``__init__`` and nothing in the production paths imports this
module.  Apart from the two specs and the stepper, nothing here is ever
executed: the AST passes read this file.  The stubs of the idiom-neutral
families (g, i, j, k, l) are the reference's, line for line; the
families bound to an idiom (b, c, d, n) carry the port's form.
"""

from __future__ import annotations

import os
import time

import torch

from ..models.cas import CAS, READ, WRITE, CasSpec
from ..ops import kernels
from ..ops.stepper import TorchStepper


class ParityBrokenCasSpec(CasSpec):
    """Seeded bug for QSM-SPEC-PARITY: ``step_torch`` acks EVERY cas as
    successful (``resp == 1``) while ``step_py`` keeps the real
    compare — the exact divergence class where the card would bless
    histories the oracle rejects."""

    name = "parity_broken_cas"

    def step_torch(self, state, cmd, arg, resp):
        new = torch.remainder(arg, self.n_values)
        succ = state == torch.div(arg, self.n_values,
                                  rounding_mode="floor")
        ok = torch.where(cmd == READ, resp == state,
                         torch.where(cmd == WRITE, resp == 0,
                                     resp == 1))  # <-- bug
        nxt = torch.where(cmd == WRITE, arg,
                          torch.where((cmd == CAS) & succ, new, state))
        return nxt.to(torch.int32), ok


class RebuildingTorchStepper(TorchStepper):
    """Seeded bug for QSM-KERN-REBUILD: every device batch builds a
    library keyed on a per-call nonce (a ``-D`` flag, so a new library
    path each call), so every call pays the compiler — the
    silent-rebuild failure mode that costs an ``nvcc`` run per call on
    the card.  ``compiler`` / ``flags`` default to ``nvcc`` and
    ``kernels.NVCC_FLAGS``; on the CPU a stand-in compiler (``g++``
    with ``-x c++``) builds the same source.  Each built library is
    deleted at once: only the compile is the point."""

    name = "rebuilding_torch_stepper"

    NONCE_SOURCE = 'extern "C" int chunk_nonce() { return QSM_NONCE; }\n'

    def __init__(self, spec, compiler=None, flags=None, **kw):
        super().__init__(spec, **kw)
        self._compiler = compiler
        self._flags = tuple(kernels.NVCC_FLAGS if flags is None else flags)

    def _run_device(self, flat, *args, **kw):
        nonce = time.monotonic_ns()  # <-- bug: a per-call build key
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = kernels.BUILD_DIR / f"rebuild_fixture_{os.getpid()}_{nonce}.cu"
        src.write_text(self.NONCE_SOURCE)
        try:
            lib = kernels.build("rebuild_fixture", src=src,
                                compiler=self._compiler,
                                flags=self._flags + (f"-DQSM_NONCE={nonce}",))
            lib.unlink(missing_ok=True)
            lib.with_suffix(".ptxas.txt").unlink(missing_ok=True)
        finally:
            src.unlink(missing_ok=True)
        return super()._run_device(flat, *args, **kw)


class UnorderedSchedulerStub:
    """Seeded bug for the determinism passes: a delivery loop whose
    choice is fed from set iteration order (QSM-DET-SET-ITER), an
    unseeded draw from torch's global generator (QSM-DET-RANDOM, the
    port's form of the reference's module-level ``random.random()``), a
    wall-clock read (QSM-DET-TIME) and an id()-keyed sort (QSM-DET-ID).
    Never executed; tests point the sched AST pass at this file and
    assert every rule fires."""

    def __init__(self):
        self.pool = []

    def deliver_one(self):
        pending = set(self.pool)
        for inflight in pending:  # set order decides delivery
            if torch.rand(()) < 0.5:  # global-generator draw
                break
        k = int(time.time()) % max(len(self.pool), 1)  # clock-fed pick
        order = sorted(self.pool, key=id)  # address-ordered tiebreak
        return order[k]

    def deliver_seeded(self, gen):
        """The sanctioned form — must NOT be flagged: the draw names its
        generator."""
        return torch.randint(0, max(len(self.pool), 1), (), generator=gen)


class UnboundedDeviceProbeStub:
    """Seeded bug for the resilience passes: a bare
    ``torch.cuda.device_count()`` (QSM-RES-DEVICES — the port's form of
    the reference's bare ``jax.devices()``), a subprocess wait without a
    timeout (QSM-RES-SUBPROC) and a numeric timeout literal handed to a
    backend probe (QSM-RES-TIMEOUT-LITERAL) — next to a
    ``watchdog``-bounded twin the pass must NOT flag.  Never executed;
    tests point the resilience AST pass at this file and assert the
    three rules fire exactly once each."""

    def probe_unbounded(self):
        return torch.cuda.device_count()  # <-- bug: unbounded enumeration

    def wait_unbounded(self):
        import subprocess
        import sys

        return subprocess.run([sys.executable, "-c", "pass"],
                              capture_output=True)  # <-- bug: no timeout

    def probe_with_literal(self, probe_default_backend):
        return probe_default_backend(45.0)  # <-- bug: scattered constant

    def probe_bounded(self):
        """The sanctioned form — must NOT be flagged."""
        from ..resilience.policy import watchdog

        return watchdog(lambda: torch.cuda.device_count(), 45.0,
                        label="fixture")


class HostReadingLaunchLoopStub:
    """Seeded bug for QSM-KERN-HOST-XFER (the port's form of a host
    transfer inside a traced body): a launch loop that reads the status
    plane to the host with ``.item()`` every trip — next to the
    sanctioned twin, which launches its chunks back to back and reads
    once after the loop.  Never executed."""

    def chunks_with_host_read(self, tables, carry, stepper_chunk):
        for _ in range(8):
            carry = stepper_chunk(tables, carry, chunk=64, budget=512)
            if not (carry.dsi[1] == 0).any().item():  # <-- bug: a sync
                break                                 # every trip
        return carry

    def chunks_then_one_read(self, tables, carry, stepper_chunk):
        """The sanctioned form — must NOT be flagged."""
        for _ in range(8):
            carry = stepper_chunk(tables, carry, chunk=64, budget=512)
        return carry.dsi[1].cpu()


class UnreapedWorkerPoolStub:
    """Seeded bug for the pool passes (family f), REAP half: a worker
    ``Popen`` inside a class with NO bounded reap path anywhere in it
    (QSM-POOL-REAP — leaked/zombie workers accumulate for the server's
    whole lifetime).  Never executed; tests point the pool AST pass at
    this file and assert the rule fires exactly once."""

    def spawn_unreaped(self):
        import subprocess
        import sys

        return subprocess.Popen([sys.executable, "-c", "pass"])  # <-- bug


class RespawnStormPoolStub:
    """Seeded bug for the pool passes (family f), RESPAWN half: a
    while-True respawn loop with no backoff sleep (QSM-POOL-RESPAWN —
    an instantly-dying worker turns it into a spawn storm).  The reap
    is bounded, so ONLY the respawn rule fires on this class."""

    def respawn_forever(self):
        import subprocess
        import sys

        while True:                      # <-- bug: no backoff, no bound
            proc = subprocess.Popen([sys.executable, "-c", "pass"])
            proc.wait(timeout=5.0)       # reap is bounded: REAP is clean


class ReapedWorkerPoolStub:
    """The sanctioned twins the pool passes must NOT flag: spawn with a
    terminate → bounded wait → kill escalation in the same class, and a
    stop-flag-gated respawn loop with exponential-backoff sleeps (the
    serve/pool.py discipline)."""

    def __init__(self):
        import threading

        self._stop = threading.Event()

    def spawn_and_reap(self):
        import subprocess
        import sys

        proc = subprocess.Popen([sys.executable, "-c", "pass"])
        proc.terminate()
        try:
            proc.wait(timeout=2.0)       # bounded reap
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5.0)
        return proc

    def respawn_with_backoff(self):
        import subprocess
        import sys
        import time

        backoff = 0.5
        while not self._stop.is_set():   # gated, backed off: sanctioned
            proc = subprocess.Popen([sys.executable, "-c", "pass"])
            proc.wait(timeout=5.0)
            time.sleep(backoff)
            backoff = min(backoff * 2, 30.0)


class DeadlockingLockPairStub:
    """Seeded bug for the race passes (family g), ORDER half: lock_b
    taken while holding lock_a on one path and lock_a while holding
    lock_b on the other (QSM-RACE-ORDER — two threads interleaving
    these paths deadlock, which on the serving stack is a wedged
    server).  Never executed; tests point the whole-program race pass
    at this file and assert the cycle fires exactly once."""

    def __init__(self):
        import threading

        self.lock_a = threading.Lock()
        self.lock_b = threading.Lock()
        self.balance = 0

    def transfer_ab(self):
        with self.lock_a:
            with self.lock_b:
                self.balance += 1

    def refund_ba(self):
        with self.lock_b:
            with self.lock_a:            # <-- bug: AB/BA cycle
                self.balance -= 1


class OrderedLockPairStub:
    """The sanctioned twin: both paths take lock_a before lock_b — one
    global acquisition order, no cycle, must NOT be flagged."""

    def __init__(self):
        import threading

        self.lock_a = threading.Lock()
        self.lock_b = threading.Lock()
        self.balance = 0

    def transfer(self):
        with self.lock_a:
            with self.lock_b:
                self.balance += 1

    def audit(self):
        with self.lock_a:
            with self.lock_b:
                self.balance -= 1


class UnguardedCounterStub:
    """Seeded bug for the race passes (family g), UNGUARDED half: a
    shared counter written under ``_lock`` on one line and with no lock
    two lines later, from a thread-target loop (QSM-RACE-UNGUARDED —
    the torn/lost-update shape a single-module lint cannot see)."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.count = 0

    def start(self):
        import threading

        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        while not self._stop.is_set():
            with self._lock:
                self.count += 1          # guarded write: the discipline
            self.count -= 1              # <-- bug: unguarded write


class GuardedCounterStub:
    """The sanctioned twin: every post-``__init__`` write holds the one
    guard lock — must NOT be flagged."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.count = 0

    def start(self):
        import threading

        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        while not self._stop.is_set():
            with self._lock:
                self.count += 1
            with self._lock:
                self.count -= 1


class UnjoinedThreadStub:
    """Seeded bug for the race passes (family g), LIFECYCLE half: a
    thread whose target loops forever without consulting any stop flag,
    retained on an attribute in a class with no bounded ``join``
    (QSM-THREAD-LIFECYCLE — teardown can never complete)."""

    def start(self):
        import threading

        t = threading.Thread(target=self._pump, daemon=True)
        t.start()
        self._pump_thread = t            # retained, never joined

    def _pump(self):
        import time

        while True:                      # <-- bug: no stop flag/deadline
            time.sleep(0.01)


class StoppableThreadStub:
    """The sanctioned twin: stop-flag-gated target loop plus a bounded
    join on the teardown path — must NOT be flagged."""

    def __init__(self):
        import threading

        self._stop = threading.Event()
        self._thread = None

    def start(self):
        import threading

        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)       # bounded join

    def _pump(self):
        import time

        while not self._stop.is_set():
            time.sleep(0.01)


class LeakedPipeStub:
    """Seeded bug for the race passes (family g), LEAK half: a pipe
    acquired and dropped — neither end closed on any path, nothing
    handed off (QSM-RES-LEAK — a long-lived server leaks descriptors
    until accept() fails with EMFILE) — next to the try/finally twin
    the pass must NOT flag."""

    def open_unclosed(self):
        import os

        r, w = os.pipe()                 # <-- bug: never closed
        return "opened"

    def open_closed(self):
        """The sanctioned form: closed on every exit."""
        import os

        r, w = os.pipe()
        try:
            return "opened"
        finally:
            os.close(r)
            os.close(w)


class UnboundedServeAcceptStub:
    """Seeded bug for the serve passes (family e): a ``while True``
    accept loop with no deadline or shutdown check (QSM-SERVE-ACCEPT —
    a wedged peer or a stop request leaves the thread blocked forever)
    and an unbounded admission queue (QSM-SERVE-UNBOUNDED) — next to
    the two sanctioned twins the passes must NOT flag (a stop-flag-
    gated loop, and a settimeout-bounded poll over a bounded queue).
    Never executed; tests point the serve AST pass at this file and
    assert each rule fires exactly once."""

    def __init__(self):
        import threading

        self._stop = threading.Event()

    def serve_forever_unbounded(self, sock):
        import queue

        backlog = queue.Queue()        # <-- bug: unbounded admission queue
        while True:                    # <-- bug: no deadline/shutdown check
            conn, _ = sock.accept()
            backlog.put(conn)

    def serve_stop_gated(self, sock):
        """Sanctioned: the loop test IS the shutdown check."""
        import queue

        backlog = queue.Queue(maxsize=64)   # ok: bounded
        while not self._stop.is_set():
            conn, _ = sock.accept()
            backlog.put(conn, block=False)

    def serve_deadline_polled(self, sock):
        """Sanctioned: settimeout bounds every accept; the loop polls."""
        sock.settimeout(0.5)
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                if self._stop.is_set():
                    return
                continue
            conn.close()


class UnboundedFrontierStub:
    """Seeded bug for the shrink passes (family h): a while-True loop
    that grows the shrink frontier with no round or size cap
    (QSM-SHRINK-UNBOUNDED — one shrink request becomes an unbounded CPU
    burn on micro-batch lanes shared with paying traffic).  Never
    executed; tests point the shrink AST pass at this file and assert
    the rule fires exactly once."""

    def frontier_forever(self, history):
        out = []
        while True:                      # <-- bug: no cap, no break
            out.append(list(history))
        return out


class BoundedFrontierStub:
    """The sanctioned twins the shrink pass must NOT flag: a bounded
    ``for`` sweep over the ops (the frontier.py shape), and a while-True
    accumulator whose break is gated on an explicit size cap."""

    MAX_LANES = 512

    def frontier_over_ops(self, history):
        out = []
        for j in range(len(history)):    # bounded by the ops themselves
            out.append(history[:j] + history[j + 1:])
        return out

    def frontier_capped(self, history):
        out = []
        while True:
            out.append(list(history))
            if len(out) >= self.MAX_LANES:   # explicit cap: sanctioned
                break
        return out


# ---------------------------------------------------------------------------
# P-compositionality projection fixtures (QSM-SPEC-PCOMP — pass family a)
# ---------------------------------------------------------------------------

from ..core.spec import KeyProj  # noqa: E402
from ..models.kv import KvSpec  # noqa: E402


class NonTotalPartitionKvSpec(KvSpec):
    """Seeded bug for QSM-SPEC-PCOMP: the spec still advertises
    ``projected_spec`` but PUT declares no KeyProj — partition_key is
    not total, so a split would have to drop or guess where PUTs land.
    The validator must refuse (and the planner must stamp the refusal
    into its ``why`` instead of splitting)."""

    name = "non_total_partition_kv"

    def __init__(self, n_keys: int = 4, n_values: int = 4):
        super().__init__(n_keys=n_keys, n_values=n_values)
        get, put = self.CMDS
        import dataclasses

        self.CMDS = (get, dataclasses.replace(put, proj=None))  # <-- bug


class UnfaithfulProjectionKvSpec(KvSpec):
    """Seeded bug for QSM-SPEC-PCOMP: PUT's KeyProj declares stride 1 —
    the key becomes the PACKED (key*n_values+value) arg, so the split
    scatters one key's writes across many sub-histories while the
    projected WRITE arg is always 0.  The sampled faithfulness check
    must catch the disagreement with the whole spec's step."""

    name = "unfaithful_projection_kv"

    def __init__(self, n_keys: int = 4, n_values: int = 4):
        super().__init__(n_keys=n_keys, n_values=n_values)
        get, put = self.CMDS
        import dataclasses

        self.CMDS = (get, dataclasses.replace(
            put, proj=KeyProj(pcmd=1, stride=1)))  # <-- bug: wrong stride


class SanctionedProjectionKvSpec(KvSpec):
    """Sanctioned twin: a KvSpec subclass whose declarations are exactly
    the sound ones — must stay CLEAN under QSM-SPEC-PCOMP (the pass
    flags unsound declarations, not subclassing)."""

    name = "sanctioned_projection_kv"


class UnclosedSpanStub:
    """Seeded bug for QSM-OBS-SPAN: a span opened by hand (assigned,
    manually entered) instead of through a ``with`` — a raise between
    open and close orphans it and the causal tree loses the stage.
    Never executed; tests point the obs pass at this file and assert
    the rule fires here and NOT on the sanctioned twin below."""

    def __init__(self, tracer):
        self.tracer = tracer

    def work(self, trace):
        sp = self.tracer.span("work", trace)  # <-- bug: no with/return
        sp.__enter__()
        result = len(trace)  # a raise here would orphan the span
        sp.__exit__(None, None, None)
        return result


class ClosedSpanStub:
    """Sanctioned twin: the with-statement close (exception-safe) and
    the delegating-return form — must stay CLEAN under QSM-OBS-SPAN."""

    def __init__(self, tracer):
        self.tracer = tracer

    def work(self, trace):
        with self.tracer.span("work", trace) as sp:
            sp.add(ok=True)
            return len(trace)

    def make_span(self, trace):
        # the wrapper form: the CALLER's with owns the close
        return self.tracer.span("work", trace)


class UnboundedMetricStub:
    """Seeded bug for QSM-OBS-CARDINALITY: metric identity synthesized
    from per-request data — an f-string metric name keyed by a history
    fingerprint, and a concatenated label value — each distinct value
    mints a new time series (cardinality explosion).  Never executed."""

    def bump(self, registry, fingerprint):
        # <-- bug: one time series PER FINGERPRINT
        registry.counter(f"qsm_hits_{fingerprint}").inc()

    def observe(self, hist, key, dt):
        hist.observe(dt, bucket="k:" + key)  # <-- bug: unbounded label


class BoundedMetricStub:
    """Sanctioned twin: fixed metric names, bounded label values
    (a worker id cast with str()) — must stay CLEAN under
    QSM-OBS-CARDINALITY."""

    def bump(self, registry, wid):
        registry.counter("qsm_hits_total").inc(wid=str(wid))

    def observe(self, hist, wid, dt):
        hist.observe(dt, wid=str(wid))


class UnboundedRedispatchRouterStub:
    """Seeded bug for QSM-FLEET-REDISPATCH: a while-True re-dispatch
    loop — no attempt budget, no failed-node exclusion.  Every node
    down (a full partition) spins this forever instead of degrading to
    the ladder or shedding, and the ring keeps answering the same dead
    node for the same key.  Never executed."""

    def __init__(self, links):
        self.links = links

    def route(self, doc):
        while True:  # <-- bug: unbounded, never excludes the corpse
            link = self.links[0]
            try:
                return link.request(doc, 5.0)
            except Exception:  # noqa: BLE001 — the seeded shape
                continue


class NonExcludingRedispatchRouterStub:
    """Seeded bug (the second QSM-FLEET-REDISPATCH form): the attempt
    budget exists but nothing excludes the failed node — the ring
    walk hands the same corpse back every attempt, so the budget buys
    nothing.  Never executed."""

    def __init__(self, ring, links):
        self.ring = ring
        self.links = links

    def route(self, key, doc):
        for _attempt in range(3):  # bounded, but...
            target = self.ring.node_for(key, {"n0", "n1"})
            link = self.links[target]
            try:
                return link.request(doc, 5.0)
            except Exception:  # noqa: BLE001 — ...same target next time
                continue
        return None


class BoundedRedispatchRouterStub:
    """Sanctioned twin: bounded attempts + a ``tried`` exclusion set
    fed into the ring walk (the fleet/router.py shape) — must stay
    CLEAN under QSM-FLEET-REDISPATCH."""

    def __init__(self, ring, links):
        self.ring = ring
        self.links = links

    def route(self, key, doc, allowed):
        tried = set()
        target = self.ring.node_for(key, allowed)
        for _attempt in range(3):
            if target is None:
                break
            tried.add(target)
            link = self.links[target]
            try:
                return link.request(doc, 5.0)
            except Exception:  # noqa: BLE001 — excluded, try the next
                target = self.ring.node_for(key, allowed, exclude=tried)
                continue


class TermlessTakeoverRouterStub:
    """Seeded bugs for QSM-FLEET-LEASE (the router-HA promotion
    discipline, fleet/lease.py): ``promote_forever`` spins a
    while-True around lease acquisition (unbounded standby-promote
    loop — with a live active holding the lease it never stands
    down); ``promote_blind`` acquires without ever consulting the
    record's term or expiry (the split-brain grab the lease exists to
    exclude).  Never executed."""

    def __init__(self, lease):
        self.lease = lease

    def promote_forever(self):
        while True:  # <-- bug: unbounded, spins against a live active
            rec = self.lease.acquire()
            if rec is not None:
                return rec

    def promote_blind(self, healthy):
        if healthy():
            # <-- bug: no term/expiry consult before the grab
            return self.lease.acquire()
        return None


class LeasedTakeoverRouterStub:
    """Sanctioned twin: one beat-driven attempt per observation — the
    record is read, its term and expiry consulted, and acquisition
    attempted at most once per beat (the fleet/router.py ``ha_beat``
    shape) — must stay CLEAN under QSM-FLEET-LEASE."""

    def __init__(self, lease, grace_s=1.0):
        self.lease = lease
        self.grace_s = grace_s
        self.term = 0

    def beat(self, probe):
        rec = self.lease.read()
        if rec is not None and not self.lease.expired(rec,
                                                      self.grace_s):
            return None              # the incumbent's term is live
        if not probe():
            return None              # no independent view of the fleet
        got = self.lease.acquire(self.grace_s)
        if got is not None:
            self.term = got["term"]  # the term rides every response
        return got


class ColdRebalanceRouterStub:
    """Seeded bugs for QSM-FLEET-HANDOFF (the elastic-membership
    discipline): ``join_cold`` mutates the ring with no
    replog seeding — the newcomer owns key ranges whose banked verdict
    rows it does not hold, so every key routed there re-folds from
    scratch; ``leave_sticky`` retires a node without touching its
    routed sessions — each one still names the corpse as owner and
    every next verb re-dispatches into the void.  Never executed."""

    def __init__(self, membership, links, sessions):
        self.membership = membership
        self.links = links
        self.sessions = sessions

    def join_cold(self, nid, addr):
        # <-- bug: the ring moves, the rows do not
        self.membership.add_node(nid, addr)
        self.links[nid] = object()
        return True

    def leave_sticky(self, nid):
        self.links.pop(nid, None)
        # <-- bug: the retiree's sessions keep it as owner
        return self.membership.remove_node(nid)


class RebalancingRouterStub:
    """Sanctioned twin: a join seeds the newcomer with an on-the-spot
    anti-entropy sweep (gossip-driven, subsumption-bounded — nodes
    already holding the rows ship nothing) and a leave invalidates
    every routed session the retiree owned, so each journal replays
    onto the new ring owner on its next verb (live migration,
    exactly-once by seq; the fleet/router.py ``_handle_membership``
    shape) — must stay CLEAN under QSM-FLEET-HANDOFF."""

    def __init__(self, membership, sessions):
        self.membership = membership
        self.sessions = sessions

    def join(self, nid, addr):
        joined = self.membership.add_node(nid, addr)
        if joined:
            return self.anti_entropy_sweep()
        return {}

    def leave(self, nid):
        left = self.membership.remove_node(nid)
        migrated = 0
        if left:
            for sess in self.sessions.values():
                if sess.node == nid:
                    sess.node = None
                    migrated += 1
        return migrated

    def anti_entropy_sweep(self):
        return {"segments_shipped": 0}


class UnboundedSessionBufferStub:
    """Seeded bug for the monitor passes (family k): a session object
    whose event buffer grows on every append with NO cap comparison and
    NO eviction anywhere in the class (QSM-MON-UNBOUNDED — a long-lived
    production monitor accumulates it until the serving plane OOMs).
    Never executed; tests point the monitor AST pass at this file and
    assert the rule fires for exactly this class."""

    def __init__(self):
        self.events = []
        self.window = []

    def append(self, event):
        self.events.append(event)        # <-- bug: no cap, no eviction
        self.window.append(event)        # <-- bug: window never evicts

    def verdict(self):
        return 1 if self.window else 1


class BoundedSessionBufferStub:
    """The sanctioned twins the monitor pass must NOT flag: a capped
    event log (the session.py ``max_events`` shape) and a window whose
    decided prefix is EVICTED by pruning reassignment (the frontier.py
    shape) — must stay CLEAN under QSM-MON-UNBOUNDED."""

    MAX_EVENTS = 65_536

    def __init__(self):
        self.events = []
        self.window = []

    def append(self, event):
        if len(self.events) >= self.MAX_EVENTS:   # explicit cap
            raise RuntimeError("session event cap reached")
        self.events.append(event)
        self.window.append(event)

    def commit_prefix(self, cut):
        self.window = self.window[cut:]           # decided-prefix evict


class UnboundedSeedPoolStub:
    """Seeded bug for the generation passes (family m): a fuzzing
    campaign accumulator — a seed corpus AND a kept-flips log — grown
    once per round with NO cap comparison and NO eviction anywhere in
    the class (QSM-GEN-UNBOUNDED — an open-ended soak accumulates it
    until the driving host OOMs).  Never executed; tests point the gen
    AST pass at this file and assert the rule fires for exactly this
    class."""

    def __init__(self):
        self.seeds = []
        self.flips = []

    def keep(self, entry, violated):
        self.seeds.append(entry)         # <-- bug: corpus never evicts
        if violated:
            self.flips.append(entry)     # <-- bug: flip log unbounded

    def best(self):
        return max(self.seeds, default=None)


class BoundedSeedPoolStub:
    """The sanctioned twins the gen pass must NOT flag: a
    capacity-evicted corpus (the steer.py ``SeedPool.add`` shape) and a
    flip log pruned to a tail window by reassignment (the kept-flips
    shape) — must stay CLEAN under QSM-GEN-UNBOUNDED."""

    CAP = 16
    FLIP_KEEP = 64

    def __init__(self):
        self.seeds = []
        self.flips = []

    def keep(self, entry, violated):
        self.seeds.append(entry)
        self.seeds.sort()
        while len(self.seeds) > self.CAP:         # explicit cap
            self.seeds.pop()                      # worst-scored evict
        if violated:
            self.flips.append(entry)
            self.flips = self.flips[-self.FLIP_KEEP:]   # tail window


# --- family (l): protocol-conformance fixtures ---------------------------
#
# A miniature wire sub-program per rule: an egress class (``_send`` +
# ``_handle``) declaring its op vocabulary as class attrs, plus the
# caller paths that exercise it.  The extractor treats each class pair
# as its own protocol; none of these names collide with the live
# serve/protocol.py vocabulary and nothing here ever runs.


class MiswiredProtocolStub:
    """Seeded bugs for QSM-PROTO-UNHANDLED + QSM-PROTO-FIELDS: the
    class declares ``mis.ghost`` but only dispatches ``mis.ping``, and
    its ``mis.ping`` response writes ``echo`` while the client below
    reads ``echo_payload`` — the exact drift class a hand-synced
    protocol accumulates."""

    OPS = ("mis.ping", "mis.ghost")

    def _send(self, ch, doc):
        doc["node"] = "stub"
        ch.write(doc)

    def _handle(self, ch, req):
        op = req.get("op", "mis.ping")
        if op == "mis.ping":
            self._send(ch, {"id": req.get("id"), "ok": True,
                            "echo": req.get("payload")})


class MiswiredProtocolClientStub:
    """The caller half of the miswired pair: sends the undispatched
    ``mis.ghost`` (QSM-PROTO-UNHANDLED at the send site) and reads the
    never-written ``echo_payload`` key (QSM-PROTO-FIELDS)."""

    def __init__(self, link):
        self.link = link

    def ping(self, text):
        resp = self.link.request({"op": "mis.ping", "payload": text},
                                 5.0)
        return resp.get("echo_payload")      # <-- bug: never written

    def ghost(self):
        return self.link.request({"op": "mis.ghost"}, 5.0)  # <-- bug


class WiredProtocolStub:
    """Sanctioned twin: every declared op dispatched, every response
    key the client reads written by the handler — must stay CLEAN
    under QSM-PROTO-UNHANDLED and QSM-PROTO-FIELDS."""

    OPS = ("wired.ping",)

    def _send(self, ch, doc):
        doc["node"] = "stub"
        ch.write(doc)

    def _handle(self, ch, req):
        op = req.get("op", "wired.ping")
        if op == "wired.ping":
            self._send(ch, {"id": req.get("id"), "ok": True,
                            "echo": req.get("payload")})


class WiredProtocolClientStub:
    """Caller half of the clean twin: reads exactly what the handler
    writes."""

    def __init__(self, link):
        self.link = link

    def ping(self, text):
        resp = self.link.request({"op": "wired.ping",
                                  "payload": text}, 5.0)
        return resp.get("echo")


class UnstampedEgressStub:
    """Seeded bug for QSM-PROTO-EGRESS: an egress class (it has the
    one ``_send``) whose handler answers through a raw ``send_doc``
    instead — the response reaches the wire without the node stamp
    every consumer correlates on."""

    OPS = ("egress.ping",)

    def _send(self, ch, doc):
        doc["node"] = "stub"
        ch.write(doc)

    def _handle(self, ch, req):
        from ..serve.protocol import send_doc

        op = req.get("op", "egress.ping")
        if op == "egress.ping":
            doc = {"id": req.get("id"), "ok": True}
            send_doc(ch, doc)                # <-- bug: bypasses _send


class UnstampedEgressCallerStub:
    """Caller keeping ``egress.ping`` reachable (the coverage checks
    must not mask the egress bug with an unrelated finding)."""

    def __init__(self, link):
        self.link = link

    def ping(self):
        return self.link.request({"op": "egress.ping"}, 5.0)


class StampedEgressStub:
    """Sanctioned twin: same dispatch shape, response routed through
    the class's ``_send`` — must stay CLEAN under QSM-PROTO-EGRESS."""

    OPS = ("egress.pong",)

    def _send(self, ch, doc):
        doc["node"] = "stub"
        ch.write(doc)

    def _handle(self, ch, req):
        op = req.get("op", "egress.pong")
        if op == "egress.pong":
            self._send(ch, {"id": req.get("id"), "ok": True})


class StampedEgressCallerStub:
    """Caller keeping ``egress.pong`` reachable."""

    def __init__(self, link):
        self.link = link

    def pong(self):
        return self.link.request({"op": "egress.pong"}, 5.0)


class RetryProtocolServerStub:
    """The server half of the retry fixtures: dispatches a mutating
    ``retry.reset`` and a read-only ``retry.get``, declaring only the
    latter replay-safe — exactly the split QSM-PROTO-RETRY-IDEMPOTENT
    checks call paths against."""

    OPS = ("retry.reset", "retry.get")
    IDEMPOTENT_OPS = ("retry.get",)

    def _send(self, ch, doc):
        doc["node"] = "stub"
        ch.write(doc)

    def _handle(self, ch, req):
        op = req.get("op", "retry.get")
        if op == "retry.reset":
            self._send(ch, {"id": req.get("id"), "ok": True})
        elif op == "retry.get":
            self._send(ch, {"id": req.get("id"), "ok": True})


class RetriedMutationClientStub:
    """Seeded bug for QSM-PROTO-RETRY-IDEMPOTENT: re-sends the
    mutating ``retry.reset`` across attempts in an except-continue
    failover loop — a dropped ACK replays the mutation."""

    def __init__(self, link):
        self.link = link

    def reset(self):
        req = {"op": "retry.reset"}
        for _ in range(3):
            try:
                return self.link.ask(req, 5.0)  # <-- bug: retried
            except OSError:
                continue
        return None


class IdempotentRetryClientStub:
    """Sanctioned twin: the same failover loop re-sends only the
    declared-idempotent ``retry.get`` — must stay CLEAN under
    QSM-PROTO-RETRY-IDEMPOTENT."""

    def __init__(self, link):
        self.link = link

    def get(self):
        req = {"op": "retry.get"}
        for _ in range(3):
            try:
                return self.link.ask(req, 5.0)
            except OSError:
                continue
        return None


# --- family (n): mesh-dispatch fixtures ----------------------------------
#
# The port's form (analysis/mesh_passes.py): literal device slots and
# counts, and host reads in a function that places shards.  Never
# executed (the imports inside the method bodies never run); tests point
# the mesh AST pass at this file and assert each rule fires on its
# seeded stub and stays silent on the sanctioned twin.


class HardcodedMeshStub:
    """Seeded bugs for QSM-MESH-HARDCODE: a topology slot pinned by
    indexing the device enumeration, a literal card in a device
    constructor and in a device string, and literal device counts baked
    into mesh constructors — the shapes that make a sharded program run
    only on the box it was written on."""

    def pin_first_device(self, device):
        from ..mesh.topology import local_devices

        return local_devices(device)[0]      # <-- bug: slot pin

    def pin_card(self, carry):
        first = torch.device("cuda", 0)      # <-- bug: literal card
        return carry.to("cuda:1"), first     # <-- bug: literal card

    def build_fixed_mesh(self):
        from ..mesh import make_mesh

        return make_mesh(8)                  # <-- bug: literal count

    def build_fixed_card_shards(self):
        from ..mesh.topology import card_shard_mesh

        return card_shard_mesh(4)            # <-- bug: literal count


class ShapePolymorphicMeshStub:
    """The sanctioned twin: the lane-axis width and the card are
    threaded as parameters and the device enumeration is only ever
    *counted*, never indexed — must stay CLEAN under QSM-MESH-HARDCODE."""

    def __init__(self, n_devices, device):
        self.n_devices = n_devices
        self.device = device

    def build_mesh(self):
        from ..mesh import make_mesh

        return make_mesh(self.n_devices)     # threaded: sanctioned

    def build_card_shards(self):
        from ..mesh.topology import card_shard_mesh

        return card_shard_mesh(self.n_devices, self.device)

    def lane_width(self):
        from ..mesh.topology import local_devices

        return len(local_devices(self.device))   # counted: clean


class TransferringDispatchStub:
    """Seeded bugs for QSM-MESH-TRANSFER: the same function places the
    lanes on every shard AND reads a shard back to the host — the
    sharded round waits for every shard's stream there while reporting
    an N-shard mesh; and a per-shard ``.to(device)`` next to
    ``torch.cuda.synchronize``."""

    def step_then_read(self, shards, step, tables, carries, lanes):
        carries = shards.step(step, tables, carries, lanes, chunk=64,
                              budget=512, sweep=False)
        return carries[0].dsi.cpu()              # <-- bug: host read

    def place_then_sync(self, planes, devices):
        placed = [p.to(d) for p, d in zip(planes, devices)]
        torch.cuda.synchronize()                 # <-- bug: host sync
        return placed


class DeviceResidentDispatchStub:
    """The sanctioned twin: placement and the one host read live in
    DIFFERENT functions (the mesh/shards.py ``step`` / ``read_status``
    split), and an index uploaded from the host places nothing — must
    stay CLEAN under QSM-MESH-TRANSFER."""

    def step(self, shards, step, tables, carries, lanes):
        return shards.step(step, tables, carries, lanes, chunk=64,
                           budget=512, sweep=False)

    def read(self, carries):
        return [c.dsi.cpu().numpy() for c in carries]

    def chosen(self, carry, lanes, device):
        idx = torch.from_numpy(lanes).to(device)  # an upload, not a
        return carry.chosen[:, idx].T.cpu()       # placement: clean


# --- family (o): device-work-queue fixtures -------------------------------
#
# Never executed; tests point the devq AST pass at this file and assert
# each rule fires on its seeded stub and stays silent on the sanctioned
# twin (tests/test_torch_lint.py).


class UnboundedDevqStub:
    """Seeded bug for QSM-DEVQ-UNBOUNDED: a work queue every plane on
    every fleet node feeds, growing a pending map and a done log with
    NO cap comparison and NO eviction anywhere in the class — the
    family-(k) OOM pathology recurring at the fleet's shared choke
    point."""

    def __init__(self):
        self.pending = []
        self.done = []

    def put(self, item):
        self.pending.append(item)        # <-- bug: no cap, no eviction
        self.done.append(item.key)       # <-- bug: tombstones unbounded


class BoundedDevqStub:
    """The sanctioned twin the devq pass must NOT flag: pending is
    capped by lowest-score eviction (the queue.py ``_evict_over_cap``
    shape) and the done-tombstone log is pruned to a tail window —
    must stay CLEAN under QSM-DEVQ-UNBOUNDED."""

    CAP = 512

    def __init__(self):
        self.pending = []
        self.done = []

    def put(self, item):
        self.pending.append(item)
        if len(self.pending) > self.CAP:          # explicit cap
            self.pending.pop(0)                   # lowest-score evict
        self.done.append(item.key)
        self.done = self.done[-4 * self.CAP:]     # tail-window prune


class DeadlineBlindDrainStub:
    """Seeded bug for QSM-DEVQ-DRAIN: a drain loop that runs until the
    queue empties without ever consulting the window deadline — a
    snatched-away chip leaves it wedged on a device it no longer
    owns."""

    def drain_queue(self, queue):
        results = {}
        while queue.pending():                   # <-- bug: no deadline
            item = queue.pending()[0]
            results[item.key] = self.dispatch(item)
            queue.mark_done(item.key)
        return results

    def dispatch(self, item):
        return 1


class DeadlineGatedDrainStub:
    """The sanctioned twin: every iteration consults the remaining
    window time before starting an item (the drain.py
    ``DrainScheduler.drain`` shape) — must stay CLEAN under
    QSM-DEVQ-DRAIN."""

    def __init__(self, window_end):
        self.window_end = window_end

    def drain_queue(self, queue, now):
        results = {}
        while queue.pending():
            remaining = self.window_end - now()  # deadline consulted
            if remaining <= 0.0:
                break
            item = queue.pending()[0]
            results[item.key] = self.dispatch(item)
            queue.mark_done(item.key)
        return results

    def dispatch(self, item):
        return 1
