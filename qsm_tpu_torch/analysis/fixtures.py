"""Seeded-bug fixtures — TRUE POSITIVES the port's lint gate must keep
catching (the counterpart of ``qsm_tpu/analysis/fixtures.py``, in the
port's idiom, for the families the port has).

Each fixture plants exactly the class of defect one pass family exists
for; tests/test_torch_lint.py asserts the analyzer flags each with the
right rule_id, and that each sanctioned twin stays clean.  A lint whose
true positives rot is a green light with the bulb removed — these
fixtures are the bulb check.  Nothing here is exported through the
package ``__init__`` and nothing in the production paths imports this
module.  Apart from the two specs and the stepper, nothing here is ever
executed: the AST passes read this file.
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
