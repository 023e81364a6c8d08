"""Pool worker process — one warm engine set, bank-free, expendable.

The counterpart of the JAX package's ``qsm_tpu/serve/worker.py``.  A
worker is a host process: it never touches CUDA or the kernel library.

``serve/pool.py`` keeps the server's single admission → batcher → cache
plane and dispatches micro-batches to N of these processes.  The split
of responsibilities is the whole design:

* **The worker owns checking and nothing else.**  It builds the exact
  host cpp→memo ladder per spec — ``resilience.host_fallback`` wrapped
  in ``FailoverBackend``, the same engine the in-process server keeps
  warm — so pooled verdicts are bit-identical to the direct path by
  construction.  It never touches the verdict bank, the admission
  counters, or the socket plane: everything a crash could corrupt
  lives in the supervisor, which makes the worker *expendable* — the
  supervisor sheds a wedged or crashed worker exactly like a wedged
  chip and re-dispatches the undecided lanes.
* **The protocol is length-prefixed JSON frames over stdin/stdout**
  (``serve/frames.py``): 4-byte big-endian length + UTF-8 JSON —
  a half-written frame from a killed worker is detectable instead of
  silently mergeable.  fd 1 is claimed for the protocol before any
  engine code runs and fd 1 is repointed at stderr, so a stray
  ``print`` inside an engine can never corrupt the stream.
* **The ``worker`` fault site** (:func:`~qsm_tpu_torch.resilience.faults.
  inject`) sits at the dispatch entry: ``QSM_TPU_FAULTS=kill:worker``
  SIGKILLs this process mid-batch, ``hang:worker`` wedges it past the
  supervisor's ``worker-dispatch`` watchdog, ``raise:worker`` answers
  a clean error — the three loss modes the supervisor's
  shed/re-dispatch/quarantine ladder must survive, all CPU-testable
  (tests/test_serve_pool.py).

Ops (all carry ``seq``; responses echo it)::

    {"op": "check", "seq": 3, "model": "cas", "spec_kwargs": {},
     "rows": [[...history rows...]], "width": 64}
      -> {"seq": 3, "ok": true, "verdicts": [1, 0, ...],
          "search": {...compact...}, "resilience": {...},
          "dispatches": 7, "seconds": 0.012}
    {"op": "ping", "seq": 4}   -> {"seq": 4, "ok": true, "pong": true, ...}
    {"op": "warm", "seq": 5, "model": "cas", "spec_kwargs": {}}
    {"op": "exit", "seq": 6}   -> {"seq": 6, "ok": true, "bye": true}

Run as ``python -m qsm_tpu_torch.serve.worker --wid N`` (the pool does; the
host ladder builds no kernel; a respawn costs the interpreter and the
package import, torch included).
"""

from __future__ import annotations

import json
import os
import time
from typing import BinaryIO, Dict, Optional, Tuple

from .frames import encode_frame, read_frame


class CheckWorker:
    """One worker process' state: warm engines keyed like the server's
    (``json.dumps([model, spec_kwargs], sort_keys=True)`` — per-spec
    affinity on the supervisor side keeps this map small and hot)."""

    def __init__(self, wid: int, proto_in: BinaryIO, proto_out: BinaryIO):
        self.wid = wid
        self._in = proto_in
        self._out = proto_out
        self._engines: Dict[str, Tuple[object, object]] = {}
        self._stop = False
        self._t0 = time.monotonic()
        self.dispatches = 0

    # ------------------------------------------------------------------
    def run(self) -> int:
        while not self._stop:
            doc = read_frame(self._in)
            if doc is None:
                break  # supervisor closed the pipe: exit, never linger
            resp = self._handle(doc)
            if resp is not None:
                self._out.write(encode_frame(resp))
                self._out.flush()
        return 0

    def _handle(self, doc: dict) -> Optional[dict]:
        op, seq = doc.get("op"), doc.get("seq")
        try:
            if op == "check":
                return self._check(doc)
            if op == "ping":
                return {"seq": seq, "ok": True, "pong": True,
                        "wid": self.wid, "dispatches": self.dispatches,
                        "uptime_s": round(time.monotonic() - self._t0, 1),
                        "specs": sorted(self._engines)}
            if op == "warm":
                from ..core.history import History

                spec, engine = self._engine_for(
                    doc.get("model"), doc.get("spec_kwargs") or {})
                # a warm DISPATCH, not just a build: the first real
                # check otherwise pays spec table compilation (~100s of
                # ms) inside a request's deadline
                engine.check_histories(spec, [History([])])
                return {"seq": seq, "ok": True, "warmed": True}
            if op == "exit":
                self._stop = True
                return {"seq": seq, "ok": True, "bye": True}
            return {"seq": seq, "ok": False,
                    "error": f"unknown worker op {op!r}"}
        except Exception as e:  # noqa: BLE001 — a failing dispatch must
            # answer an error frame (the supervisor re-dispatches the
            # lanes), not kill the worker loop; a KILLED worker is the
            # other tested path and SIGKILL never reaches here
            return {"seq": seq, "ok": False,
                    "error": f"{type(e).__name__}: {e}"[:300]}

    # ------------------------------------------------------------------
    def _engine_for(self, model: str, spec_kwargs: dict):
        from ..models.registry import make
        from ..resilience.failover import FailoverBackend, host_fallback

        key = json.dumps([model, spec_kwargs or {}], sort_keys=True)
        entry = self._engines.get(key)
        if entry is None:
            # the exact engine the in-process auto server keeps warm
            # (server.py _build_engine): verdict parity by construction
            spec, _ = make(model, "atomic", spec_kwargs or None)
            engine = FailoverBackend(spec, host_fallback(spec))
            entry = self._engines[key] = (spec, engine)
        return entry

    def _check(self, doc: dict) -> dict:
        from ..core.history import History
        from ..resilience.faults import inject
        from ..resilience.failover import collect_resilience
        from ..search.stats import collect_search_stats, stats_delta
        from .protocol import rows_to_history

        t0 = time.perf_counter()
        spec, engine = self._engine_for(doc.get("model"),
                                        doc.get("spec_kwargs") or {})
        hists = [rows_to_history(rows) for rows in doc["rows"]]
        # same fixed-width padding as the in-process dispatch (empty
        # histories are instantly-SUCCESS): only real lanes ride the pipe
        width = max(int(doc.get("width", len(hists))), len(hists))
        padded = hists + [History([])] * (width - len(hists))
        st0 = collect_search_stats(engine)
        # THE worker fault site: kill:worker SIGKILLs this process here
        # (mid-batch, mid-protocol — the supervisor sees pipe EOF),
        # hang:worker wedges it, raise:worker answers a clean error
        inject("worker")
        verdicts = engine.check_histories(spec, padded)[:len(hists)]
        self.dispatches += 1
        st = stats_delta(collect_search_stats(engine), st0)
        resp = {"seq": doc.get("seq"), "ok": True,
                "verdicts": [int(v) for v in verdicts],
                "search": st.to_compact() if st is not None else None,
                "resilience": collect_resilience(engine),
                "wid": self.wid, "dispatches": self.dispatches,
                "seconds": round(time.perf_counter() - t0, 4)}
        if "trace" in doc:
            # the trace plane's optional frame field (serve/frames.py):
            # echoed so a supervisor-side frame capture is attributable;
            # workers that predate it ignore the key entirely
            resp["trace"] = doc["trace"]
        return resp


def main(argv=None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        description="qsm_tpu_torch check-pool worker (spawned by serve/pool.py)")
    ap.add_argument("--wid", type=int, default=0,
                    help="worker id (stats/affinity label)")
    args = ap.parse_args(argv)

    # claim the protocol stream BEFORE any engine code can print to it:
    # frames ride a private dup of fd 0/1, and fd 1 is repointed at
    # stderr so stray engine chatter cannot corrupt a frame
    proto_in = os.fdopen(os.dup(0), "rb")
    proto_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    # the supervisor owns lifecycle: a terminal Ctrl-C must stop the
    # SERVER (which tears the pool down deterministically), not race N
    # workers' own KeyboardInterrupts against the pipe protocol
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    return CheckWorker(args.wid, proto_in, proto_out).run()


if __name__ == "__main__":
    import sys

    sys.exit(main())
