"""Counterexample printing, structured logs and regression files.

A per-pid timeline printer for counterexamples, one JSON line an event,
and regression files that carry everything a failure's replay needs:
(model, impl, seed key, config, program, history).  The regression file's
format is the JAX package's, key for key, so a file saved by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import IO, Optional

from ..core.generator import ProgOp, Program
from ..core.history import History, Op
from ..core.property import Counterexample, PropertyConfig
from ..core.spec import Spec


# ---------------------------------------------------------------------------
# Counterexample pretty-printer
# ---------------------------------------------------------------------------

def _op_label(spec: Spec, op: Op) -> str:
    sig = spec.CMDS[op.cmd]
    arg = f"({op.arg})" if sig.n_args > 1 else "()"
    resp = "?" if op.is_pending else str(op.resp)
    return f"{sig.name}{arg} -> {resp}"


def format_history(spec: Spec, history: History, width: int = 60) -> str:
    """Per-pid timeline: one row per operation, bars showing the real-time
    interval — overlap between rows is exactly the concurrency the
    lineariser had to untangle."""
    if not history.ops:
        return "(empty history)"
    t_max = max(o.response_time for o in history.ops
                if not o.is_pending) if history.n_pending < len(
                    history.ops) else max(o.invoke_time for o in history.ops)
    t_max = max(t_max, 1)
    scale = max(1.0, t_max / width)
    lines = []
    for o in history.ops:
        lo = int(o.invoke_time / scale)
        hi = (int(min(o.response_time, t_max) / scale)
              if not o.is_pending else width)
        hi = max(hi, lo + 1)
        bar = " " * lo + "[" + "=" * (hi - lo - 1) + ("]" if not o.is_pending
                                                      else ">")
        lines.append(f"  pid {o.pid}  {_op_label(spec, o):24s} |{bar}")
    return "\n".join(lines)


def format_counterexample(spec: Spec, cx: Counterexample) -> str:
    head = (f"counterexample after trial {cx.trial} "
            f"(seed {cx.trial_seed!r}, {cx.shrink_steps} shrink steps, "
            f"{len(cx.program)} ops):")
    return head + "\n" + format_history(spec, cx.history)


# ---------------------------------------------------------------------------
# Structured logging — one JSON line per event
# ---------------------------------------------------------------------------

class JsonlLogger:
    """Minimal structured logger: ``log.emit("trial", trial=3, ok=True)``
    writes one self-contained JSON line."""

    def __init__(self, stream: Optional[IO] = None, path: Optional[str] = None):
        assert not (stream and path)
        self._own = open(path, "a") if path else None
        self.stream = self._own or stream

    def emit(self, event: str, **fields) -> None:
        if self.stream is None:
            return
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()

    def close(self) -> None:
        if self._own:
            self._own.close()


# ---------------------------------------------------------------------------
# Regression files — persisted failing triples
# ---------------------------------------------------------------------------

def faults_to_doc(fp) -> Optional[dict]:
    """JSON-safe FaultPlan serialization (sets become sorted lists)."""
    if fp is None:
        return None
    return {"p_drop": fp.p_drop, "p_duplicate": fp.p_duplicate,
            "p_delay": fp.p_delay, "delay_steps": fp.delay_steps,
            "partitions": [sorted(g) for g in fp.partitions],
            "crash_at": dict(fp.crash_at),
            "protected": sorted(fp.protected)}


def faults_from_doc(doc: Optional[dict]):
    from ..sched.scheduler import FaultPlan

    if doc is None:
        return None
    return FaultPlan(p_drop=doc["p_drop"], p_duplicate=doc["p_duplicate"],
                     p_delay=doc.get("p_delay", 0.0),
                     delay_steps=doc.get("delay_steps", 3),
                     partitions=[set(g) for g in doc["partitions"]],
                     crash_at=doc["crash_at"],
                     protected=set(doc["protected"]))


def save_regression(path: str, model: str, impl: str, spec: Spec,
                    cfg: PropertyConfig, cx: Counterexample) -> None:
    """Persist a failure as a self-contained replayable JSON file."""
    doc = {
        "model": model,
        "impl": impl,
        "spec": spec.name,
        "spec_kwargs": spec.spec_kwargs(),
        "config": {
            **{k: v for k, v in dataclasses.asdict(cfg).items()
               if k != "faults"},
            "faults": faults_to_doc(cfg.faults)},
        "trial": cx.trial,
        "trial_seed": cx.trial_seed,
        "shrink_steps": cx.shrink_steps,
        "program": {"n_pids": cx.program.n_pids,
                    "ops": [[o.pid, o.cmd, o.arg] for o in cx.program.ops]},
        "history": [[o.pid, o.cmd, o.arg, o.resp, o.invoke_time,
                     o.response_time] for o in cx.history.ops],
    }
    # write, then rename (resilience/checkpoint.py): a regression file is
    # the only copy of a found bug, a crash mid-write must not corrupt it
    from ..resilience.checkpoint import atomic_write_json

    atomic_write_json(path, doc, indent=1)


def history_from_rows(rows) -> History:
    """The one decoder of the ``[pid, cmd, arg, resp, invoke_time,
    response_time]`` history encoding (regression files, external trace
    files for the `check` CLI).  Normalizes pending
    markers: a null/negative resp or a response_time at/past the
    sentinel both mean pending, canonicalized to ``resp=-1,
    response_time=PENDING_T``.

    Op order is CANONICAL, not insertion-luck: rows sort under the
    deterministic total order ``(invoke_time, response_time, pid, cmd,
    arg, resp)``, so any permutation of the same rows decodes to the
    same History (same fingerprint, same cache row, same witness
    indices).  Rows already in invocation order — every in-tree writer
    — are unchanged.  Witness op indices refer to this canonical
    order.

    A completed row whose response precedes its invocation is not a
    history at all (no schedule produces one; an adapter that builds
    one mis-paired its events) — refused loudly, never silently
    reordered into something checkable."""
    from ..sched.runner import PENDING_T

    ops = []
    for i, (pid, cmd, arg, resp, inv, ret) in enumerate(rows):
        pending = resp is None or resp < 0 or ret is None or ret >= PENDING_T
        if not pending and ret < inv:
            raise ValueError(
                f"history row {i} ({[pid, cmd, arg, resp, inv, ret]}): "
                f"response_time {ret} precedes invoke_time {inv} — "
                "responses cannot precede their invocations (mis-paired "
                "events in the producer?)")
        ops.append(Op(pid=pid, cmd=cmd, arg=arg,
                      resp=-1 if pending else resp,
                      invoke_time=inv,
                      response_time=PENDING_T if pending else ret))
    ops.sort(key=lambda o: (o.invoke_time, o.response_time, o.pid,
                            o.cmd, o.arg, o.resp))
    return History(ops)


def load_regression(path: str):
    """(model, impl, trial_seed, program, history, faults, spec_kwargs)
    from a regression file; ``faults`` is the FaultPlan the failure was
    found under (replay must reuse it or the schedule diverges), and
    ``spec_kwargs`` rebuilds the exact spec the failure was captured
    against (a file without it: empty dict, the registry defaults)."""
    with open(path) as f:
        doc = json.load(f)
    prog = Program(tuple(ProgOp(p, c, a) for p, c, a in doc["program"]["ops"]),
                   n_pids=doc["program"]["n_pids"])
    hist = history_from_rows(doc["history"])
    faults = faults_from_doc(doc["config"].get("faults"))
    return (doc["model"], doc["impl"], doc["trial_seed"], prog, hist, faults,
            doc.get("spec_kwargs", {}))
