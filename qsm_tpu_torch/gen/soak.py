"""The chaos soak rig — ``python -m qsm_tpu_torch soak``: thousands of
open monitor sessions held through real fleet churn.

The counterpart of the JAX package's ``qsm_tpu/gen/soak.py``, with its
schedule and gate report.  Where the card needs another design: the
nodes and routers are ``python -m qsm_tpu_torch`` processes on the card
(each its own CUDA context; the nodes' planned checkers, the routers'
ladders), and ``device`` is passed through to them — ``device="cpu"``
gives host processes, nothing else does, and nothing hides the card
from a spawned process.  The closed loop's corpora are drawn on
``device`` too (the threefry table on the card by default).

The rig starts its first three nodes and the node (c) joins at once,
and then its two routers at once (the reference starts each after the
last one's banner, and the joining node at its join): a process on the
card spends most of its start waiting, and the schedule below is the
reference's.

The durable-session gate, executable: the rig spawns a 3-node
fleet (durable ``--session-dir`` substrates, segmented replogs) behind
an active/standby router pair sharing one lease store, opens ≥1000
monitor sessions through the failover client, then drives the fault
schedule the acceptance criteria name while the streams keep appending:

* (a) a **rolling restart** of all three nodes — SIGKILL, respawn on
  the same port, durable sessions restore from snapshot+journal and
  re-commit their decided prefixes from the banked rows (``prefix_hits``,
  zero engine folds);
* (b) a **SIGKILL of the active router** — the standby takes the lease
  within ~1.5x TTL and the comma-address client rides the failover;
  the closed loop (gen/fleet.py ``fuzz_fleet``) runs against the
  survivor mid-takeover, every verdict re-proved by a fresh memo oracle;
* (c) one **node leave + node join** over the elastic-membership verbs
  (``node.leave`` migrates the departed owner's live sessions,
  ``node.join`` hands the newcomer its replog by anti-entropy).

Nothing the fleet answers is trusted: every session's full event stream
is re-checked by a fresh ``WingGongCPU(memo=True)`` oracle at the end —
a decided close verdict that contradicts the oracle is a wrong verdict,
a flip the oracle refutes is an unproved flip, an oracle VIOLATION the
session never flipped is a LOST flip.  The ``health`` verb judges the
surviving fleet and the report maps it to the ``health`` subcommand's
exit codes.  All of it lands in one report dict (``gate_ok`` is the
acceptance line).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..obs.slo import HEALTH_EXIT_CODES, HEALTH_EXIT_UNREACHABLE
from ..ops.backend import Verdict
from ..ops.wing_gong_cpu import WingGongCPU
from ..serve.client import CheckClient
from ..serve.protocol import history_to_rows
from .profile import GenProfile

# retry budget for one session verb while a fault lands: routers shed
# during takeover and nodes vanish mid-restart — the rig is a client
# that does what real clients do (seq-idempotent re-send), so a verb
# only counts as LOST after the whole window passes
_RPC_TRIES = 60
_RPC_SLEEP_S = 0.25


def _start(cmd: List[str], env_extra: Optional[dict] = None
           ) -> subprocess.Popen:
    """Start one fleet process.  It inherits this one's environment
    (nothing hides the card from it); its device is on its command
    line."""
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=env)


def _spawn(cmd: List[str], banner_key: str, *,
           env_extra: Optional[dict] = None,
           timeout_s: float = 120.0) -> Tuple[subprocess.Popen, str]:
    """Start one fleet process and read its single JSON banner line;
    ``(proc, address)``."""
    return _banner(_start(cmd, env_extra), cmd, banner_key, timeout_s)


def _banner(proc: subprocess.Popen, cmd: List[str], banner_key: str,
            timeout_s: float = 120.0) -> Tuple[subprocess.Popen, str]:
    """``(proc, address)`` from a started process' banner line."""
    line = ""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.strip():
            break
    try:
        return proc, json.loads(line)[banner_key]
    except (ValueError, KeyError):
        proc.kill()
        raise RuntimeError(f"{cmd[3] if len(cmd) > 3 else cmd[0]} "
                           f"printed no {banner_key!r} banner")


def _kill(proc: Optional[subprocess.Popen], sig=signal.SIGKILL) -> None:
    if proc is None or proc.poll() is not None:
        return
    try:
        proc.send_signal(sig)
        proc.wait(timeout=10.0)
    except (OSError, subprocess.TimeoutExpired):
        proc.kill()


class _Fleet:
    """The rig's process tree: 3 durable nodes + 2 lease-sharing
    routers, each respawnable piecemeal (that IS the soak)."""

    def __init__(self, run_dir: str, *, lease_ttl_s: float,
                 max_sessions: int, faults: Optional[str],
                 device=None):
        self.run_dir = run_dir
        # passed through to every spawned process ("cpu": host nodes
        # and routers; None: the card)
        self.device_args = ([] if device is None
                            else ["--device", str(device)])
        self.lease_ttl_s = lease_ttl_s
        self.max_sessions = max_sessions
        self.faults = faults
        self.nodes: Dict[str, Tuple[subprocess.Popen, str]] = {}
        self.routers: Dict[str, Tuple[subprocess.Popen, str]] = {}
        self.spares: Dict[str, Tuple[subprocess.Popen, str]] = {}

    def spawn_nodes(self, nids, spares=()) -> List[str]:
        """Start the nodes ``nids`` and the ``spares`` at once (a CUDA
        process' start is mostly waiting on its imports and its
        context), then read their banners in order.  A spare stays out
        of the fleet (and of the routers' node list) until
        :meth:`take_spare`."""
        procs = [(nid, cmd, _start(cmd, self._node_env())) for nid, cmd
                 in ((n, self._node_cmd(n, 0)) for n in (*nids, *spares))]
        for nid, cmd, proc in procs:
            entry = _banner(proc, cmd, "serving")
            if nid in spares:
                self.spares[nid] = entry
            else:
                self.nodes[nid] = entry
        return [self.nodes[nid][1] for nid in nids]

    def take_spare(self, nid: str) -> str:
        """A spare started by :meth:`spawn_nodes`, now a fleet node."""
        self.nodes[nid] = self.spares.pop(nid)
        return self.nodes[nid][1]

    def _node_env(self) -> Optional[dict]:
        return {"QSM_TPU_FAULTS": self.faults} if self.faults else None

    def spawn_node(self, nid: str, port: int = 0) -> str:
        proc, addr = _spawn(self._node_cmd(nid, port), "serving",
                            env_extra=self._node_env())
        self.nodes[nid] = (proc, addr)
        return addr

    def _node_cmd(self, nid: str, port: int) -> List[str]:
        return [sys.executable, "-m", "qsm_tpu_torch", "serve",
               "--port", str(port), "--node-id", nid,
               "--replog-dir", os.path.join(self.run_dir, "replog", nid),
               "--session-dir", os.path.join(self.run_dir, "sess", nid),
               "--max-sessions", str(self.max_sessions),
               "--replog-seal-rows", "64", "--flush-ms", "5",
               *self.device_args]

    def spawn_routers(self, rids, lease: str) -> List[str]:
        """Start the routers ``rids`` on one lease at once; whichever
        takes the lease first is active."""
        procs = [(rid, cmd, _start(cmd)) for rid, cmd in
                 ((rid, self._router_cmd(rid, lease)) for rid in rids)]
        for rid, cmd, proc in procs:
            self.routers[rid] = _banner(proc, cmd, "fleet")
        return [self.routers[rid][1] for rid in rids]

    def _router_cmd(self, rid: str, lease: str) -> List[str]:
        addrs = ",".join(a for _, a in self.nodes.values())
        return [sys.executable, "-m", "qsm_tpu_torch", "fleet",
               "--addrs", addrs, "--port", "0", "--router-id", rid,
               "--session-journal",
               os.path.join(self.run_dir, "router_sess"),
               "--lease-store", lease,
               "--lease-ttl-s", str(self.lease_ttl_s),
               "--heartbeat-s", "0.25", "--anti-entropy-s", "0.5",
               *self.device_args]

    def restart_node(self, nid: str) -> str:
        """SIGKILL ``nid`` and respawn it on the SAME port with the
        same durable dirs — the same-host:port crash/respawn the
        rolling restart models (routers re-link without a re-address;
        sessions restore from the store)."""
        proc, addr = self.nodes[nid]
        _kill(proc)
        port = int(addr.rsplit(":", 1)[1])
        last: Optional[Exception] = None
        for _ in range(20):          # the freed port can lag a beat
            try:
                return self.spawn_node(nid, port=port)
            except RuntimeError as e:
                last = e
                time.sleep(0.5)
        raise RuntimeError(f"node {nid} respawn on :{port} failed "
                           f"({last})")

    def router_roles(self) -> Dict[str, str]:
        roles = {}
        for rid, (proc, addr) in self.routers.items():
            if proc.poll() is not None:
                continue
            try:
                with CheckClient(addr, timeout_s=5.0) as c:
                    st = c.stats().get("stats") or {}
                    roles[rid] = (st.get("lease") or {}).get(
                        "role", "?")
            except (OSError, ConnectionError, ValueError):
                roles[rid] = "unreachable"
        return roles

    def active_router(self, timeout_s: float = 30.0) -> str:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for rid, role in self.router_roles().items():
                if role == "active":
                    return rid
            time.sleep(0.2)
        raise RuntimeError(f"no active router within {timeout_s}s "
                           f"(roles: {self.router_roles()})")

    def stop(self) -> None:
        for proc, _ in list(self.routers.values()):
            _kill(proc, signal.SIGTERM)
        for proc, _ in [*self.nodes.values(), *self.spares.values()]:
            _kill(proc, signal.SIGTERM)


def _retry(fn, *args, what: str = "", ok=lambda d: d.get("ok"),
           tries: int = _RPC_TRIES, **kwargs) -> dict:
    """One session verb, ridden through the fault window: sheds,
    takeover refusals and connection loss all retry (the verbs are
    seq-idempotent by contract); only a whole exhausted window is a
    rig failure."""
    doc: dict = {}
    for i in range(tries):
        try:
            doc = fn(*args, **kwargs)
        except (OSError, ConnectionError, ValueError) as e:
            doc = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if ok(doc):
            return doc
        time.sleep(_RPC_SLEEP_S)
    raise RuntimeError(f"{what or getattr(fn, '__name__', 'rpc')} "
                       f"exhausted {tries} tries: "
                       f"{json.dumps(doc)[:300]}")


def soak_sessions(*, sessions: int = 1000, ops_per_session: int = 12,
                  model: str = "register", seed: int = 0,
                  workers: int = 8, max_sessions: int = 256,
                  lease_ttl_s: float = 1.0, fuzz_rounds: int = 2,
                  fuzz_batch: int = 8, run_dir: Optional[str] = None,
                  faults: Optional[str] = None, log=None,
                  device=None) -> dict:
    """Run the whole schedule; returns the gate report (module
    docstring).  ``sessions`` histories are generated up front and
    their ground truth fixed by a fresh memo oracle BEFORE any fleet
    process exists — the fleet can only agree or be caught.
    ``device`` is where the spawned fleet and the closed loop's draws
    run (None: the card)."""
    import tempfile

    from ..models.registry import MODELS
    from .core import generate_batch
    from .fleet import fuzz_fleet

    def say(msg: str) -> None:
        if log:
            log(msg)

    t_start = time.monotonic()
    spec = MODELS[model].make_spec()
    profile = GenProfile(n_ops=ops_per_session, n_pids=3,
                         p_adverse=0.05)
    histories = generate_batch(spec, profile, seed, sessions,
                               path="py")
    say(f"soak: {sessions} generated histories, fixing ground truth")
    truth = [int(v) for v in
             WingGongCPU(memo=True).check_histories(spec, histories)]
    rows_of = [history_to_rows(h) for h in histories]
    # three append chunks per session, one per fault phase
    chunks = [(0, 1), (1, 2), (2, 3)]

    owns_dir = run_dir is None
    run_dir = run_dir or tempfile.mkdtemp(prefix="qsm_soak_")
    fleet = _Fleet(run_dir, lease_ttl_s=lease_ttl_s,
                   max_sessions=max_sessions, faults=faults,
                   device=device)
    report: Dict = {
        "rig": "soak_sessions", "model": model, "sessions": sessions,
        "ops_per_session": ops_per_session, "seed": seed,
        "max_sessions_per_node": max_sessions, "faults": faults,
        "device": "cpu" if device is not None and str(device) == "cpu"
        else str(device or "cuda"),
        "truth_violations": sum(1 for v in truth
                                if v == int(Verdict.VIOLATION)),
    }
    flipped = [False] * sessions       # any flip the fleet pushed
    closes: List[dict] = [{}] * sessions
    local = threading.local()

    def client() -> CheckClient:
        if getattr(local, "c", None) is None:
            local.c = CheckClient(router_addrs, timeout_s=15.0)
        return local.c

    def sid(i: int) -> str:
        return f"soak-{i:05d}"

    def open_one(i: int) -> None:
        _retry(client().session_open, model, session=sid(i),
               what=f"open {sid(i)}")

    def append_chunk(i: int, lo_hi: Tuple[int, int]) -> None:
        rows = rows_of[i]
        per = max(1, len(rows) // len(chunks))
        lo, hi = lo_hi[0] * per, (lo_hi[1] * per if lo_hi[1]
                                  < len(chunks) else len(rows))
        if lo >= hi:
            return
        doc = _retry(client().session_append, sid(i), rows[lo:hi],
                     seq=lo, what=f"append {sid(i)}@{lo}")
        if doc.get("flip"):
            flipped[i] = True

    def close_one(i: int) -> None:
        doc = _retry(client().session_close, sid(i),
                     what=f"close {sid(i)}")
        if doc.get("flipped"):
            flipped[i] = True
        closes[i] = doc

    def sweep(fn, phase: str, chunk=None) -> None:
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(fn, i) if chunk is None
                    else pool.submit(fn, i, chunk)
                    for i in range(sessions)]
            for f in futs:
                f.result()
        say(f"soak: {phase} done in "
            f"{time.monotonic() - t0:.1f}s")

    try:
        # n3, the node (c) joins, starts with the others and waits
        fleet.spawn_nodes(("n0", "n1", "n2"), spares=("n3",))
        lease = os.path.join(run_dir, "lease.json")
        r0, r1 = fleet.spawn_routers(("r0", "r1"), lease)
        router_addrs = f"{r0},{r1}"
        active = fleet.active_router()
        say(f"soak: fleet up, active router {active}")

        sweep(open_one, f"open x{sessions}")
        sweep(append_chunk, "chunk 0", chunks[0])

        # -- (a) rolling restart of all three nodes ---------------------
        t0 = time.monotonic()
        for nid in ("n0", "n1", "n2"):
            fleet.restart_node(nid)
            say(f"soak: node {nid} SIGKILLed + respawned")
        report["rolling_restart_s"] = round(time.monotonic() - t0, 2)
        sweep(append_chunk, "chunk 1 (post-restart)", chunks[1])

        # -- (b) SIGKILL the active router; standby takes the lease -----
        proc, _ = fleet.routers[active]
        t0 = time.monotonic()
        _kill(proc)                       # SIGKILL, no goodbye
        say(f"soak: active router {active} SIGKILLed")
        survivor = [rid for rid in fleet.routers if rid != active][0]
        new_active = fleet.active_router(
            timeout_s=max(30.0, lease_ttl_s * 20))
        report["router_takeover_s"] = round(time.monotonic() - t0, 2)
        report["router_takeover"] = new_active == survivor
        survivor_addr = fleet.routers[survivor][1]
        say(f"soak: standby {new_active} active after "
            f"{report['router_takeover_s']}s; running closed loop")
        fuzz = fuzz_fleet(survivor_addr, [model], rounds=fuzz_rounds,
                          batch=fuzz_batch, seed=seed + 1,
                          session_every=2, deadline_s=30.0,
                          timeout_s=30.0, log=log, device=device)
        from ..ops.draws_kernel import threefry_draws

        report["fuzz"] = {
            "wrong_verdicts_total": fuzz["wrong_verdicts_total"],
            "flips_total": fuzz["flips_total"],
            "seqs_total": fuzz["seqs_total"],
            "health_status": fuzz["health_status"],
            # the closed loop's draw tables on the card (this process'
            # launches of csrc/threefry_draws.cu; 0 on the CPU)
            "draw_launches": threefry_draws.launches}

        # -- (c) one node leave + one node join -------------------------
        with CheckClient(survivor_addr, timeout_s=15.0) as admin:
            left = _retry(admin.node_leave, "n0", what="node.leave n0")
            report["node_leave"] = {
                "sessions_migrated": left.get("sessions_migrated", 0),
                "nodes": left.get("nodes")}
            n3 = fleet.take_spare("n3")
            joined = _retry(admin.node_join, "n3", n3,
                            what="node.join n3")
            report["node_join"] = {
                "handoff": joined.get("handoff"),
                "nodes": joined.get("nodes")}
        _kill(fleet.nodes.pop("n0")[0])
        say(f"soak: n0 left ({report['node_leave']}), n3 joined "
            f"({report['node_join']})")
        sweep(append_chunk, "chunk 2 (post-churn)", chunks[2])
        sweep(close_one, f"close x{sessions}")

        # -- audit: the fleet's word against a fresh oracle -------------
        undecided = int(Verdict.BUDGET_EXCEEDED)
        wrong: List[dict] = []
        lost_flips: List[int] = []
        unproved_flips: List[int] = []
        prefix_hits = advances = 0
        reprove = WingGongCPU(memo=True)   # fresh — no shared state
        for i, doc in enumerate(closes):
            got = doc.get("verdict")
            want = ("LINEARIZABLE" if truth[i]
                    == int(Verdict.LINEARIZABLE) else
                    "VIOLATION" if truth[i] == int(Verdict.VIOLATION)
                    else None)
            if want is not None and got != want:
                wrong.append({"session": sid(i), "fleet": got,
                              "oracle": want,
                              "seed": histories[i].seed})
            if flipped[i]:
                if int(reprove.check_histories(
                        spec, [histories[i]])[0]) not in (
                            int(Verdict.VIOLATION), undecided):
                    unproved_flips.append(i)
            elif truth[i] == int(Verdict.VIOLATION) \
                    and got != "VIOLATION":
                lost_flips.append(i)
            prefix_hits += int(doc.get("prefix_hits", 0))
            advances += int(doc.get("advances", 0))
        report["wrong_verdicts"] = len(wrong)
        report["wrong"] = wrong[:32]
        report["flips_total"] = sum(flipped)
        report["lost_flips"] = len(lost_flips)
        report["unproved_flips"] = len(unproved_flips)
        report["prefix_hits_total"] = prefix_hits
        report["frontier_advances_total"] = advances

        # durable-resume evidence from the nodes themselves
        restored = 0
        node_stats = {}
        for nid, (proc_n, addr) in fleet.nodes.items():
            try:
                with CheckClient(addr, timeout_s=5.0) as c:
                    s = (c.stats().get("stats") or {}).get(
                        "session") or {}
                node_stats[nid] = {
                    "restored": s.get("restored", 0),
                    "evicted": s.get("evicted", 0),
                    "prefix_hits": s.get("prefix_hits", 0)}
                restored += int(s.get("restored", 0))
            except (OSError, ConnectionError, ValueError):
                node_stats[nid] = {"unreachable": True}
        report["node_sessions"] = node_stats
        report["resume_restored_total"] = restored

        # the judge: the surviving fleet's own SLO health answer
        try:
            with CheckClient(survivor_addr, timeout_s=15.0) as c:
                health = c.health()
        except (OSError, ConnectionError, ValueError) as e:
            health = {"ok": False, "status": "unreachable",
                      "error": f"{type(e).__name__}: {e}"}
        report["health_status"] = str(health.get("status",
                                                 "unreachable"))
        report["exit_code"] = (
            HEALTH_EXIT_CODES.get(report["health_status"],
                                  HEALTH_EXIT_UNREACHABLE)
            if health.get("ok") else HEALTH_EXIT_UNREACHABLE)
        report["elapsed_s"] = round(time.monotonic() - t_start, 1)
        report["gate_ok"] = bool(
            report["wrong_verdicts"] == 0
            and report["lost_flips"] == 0
            and report["unproved_flips"] == 0
            and report["router_takeover"]
            and report["node_leave"]["nodes"] is not None
            and report["node_join"]["nodes"] is not None
            and report["resume_restored_total"] > 0
            and report["prefix_hits_total"] > 0
            and report["fuzz"]["wrong_verdicts_total"] == 0
            and report["exit_code"] == 0)
        return report
    finally:
        fleet.stop()
        if owns_dir:
            import shutil

            shutil.rmtree(run_dir, ignore_errors=True)
